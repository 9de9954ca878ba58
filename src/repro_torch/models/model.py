"""Model-level public API (port of ``repro/models/model.py``).

  param_defs / init_params        declarative params
  init_serving_params             params drawn in their serving dtypes
  forward_train / make_train_step training
  make_micro_step / make_apply_step  microbatched training in two steps
  prefill / decode_step           serving
  batch_defs / input_specs        TensorSpec stand-ins for a cell's inputs
  spec_zeros                      zero caches from SpecDefs
  distribute_params               params (or caches) onto a mesh

Training runs the JAX package's plain numerics: that package trains on its
jnp path, since ``jax.grad`` cannot go through its Pallas kernels, and the
port's kernel wrappers raise under grad in the same way
(``repro_torch.kernels.refuse_grad``). Gradients reach the float32 master
params through ``cast_params``. Under a ``DeviceMesh`` the params, caches
and batches are DTensors laid out by the sharding rules
(``distribute_params``);
the model code is the same, run under ``dist.sharding.use_sharding``.
``init_params``, ``init_serving_params``, ``spec_zeros`` and ``input_specs``
put their tensors on the card unless the caller passes ``device="cpu"``
(with a mesh: on the mesh's device type).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.prewarm import TensorSpec
from repro_torch.dist import sharding as shd
from repro_torch.models import params as prm
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import SpecDef, _is_spec, cache_defs
from repro_torch.models.tree import tree_map

AUX_LOSS_WEIGHT = 0.01


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def param_defs(cfg) -> dict:
    return tfm.transformer_defs(cfg)


def init_params(cfg, generator: torch.Generator, device="cuda"):
    return prm.init_params(param_defs(cfg), generator,
                           getattr(torch, cfg.param_dtype), device)


def init_serving_params(cfg, generator: torch.Generator, device="cuda"):
    """``tfm.cast_params(cfg, init_params(...))``, drawn in those dtypes
    (``ndim >= 2`` in ``compute_dtype``, vectors in float32): the peak is
    the serving bytes plus one float32 layer slice or unstacked leaf. It is
    how a model of 55-69 GB in bf16 is initialised on one 80 GB card; the
    JAX package has no such function."""
    return prm.init_params(param_defs(cfg), generator,
                           getattr(torch, cfg.compute_dtype), device,
                           vector_dtype=torch.float32)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------
def _ce_terms(cfg, params, x, labels):
    """Cross-entropy pieces for hidden states x vs labels: (nll_sum, n_tok),
    float32."""
    logits = tfm.unembed(cfg, params, x)
    # whole rows before the softmax, gathered where the backward pass sees
    # it: its grad goes back to the vocab shards (an implicit gather inside
    # log_softmax would hand the unembed's backward whole-vocab grads)
    lp = torch.log_softmax(shd.shard(logits.float(), "batch", "seq", None), dim=-1)
    mask = (labels >= 0).float()
    labels_safe = labels.clamp(min=0).long()
    # -lp[label] per position: the gather of the JAX package's
    # take_along_axis, as nll_loss (DTensor lays its backward out by the
    # batch; a gather's backward builds the global-shape zeros on every rank)
    nll = F.nll_loss(lp.flatten(0, -2), labels_safe.flatten(), reduction="none")
    return torch.sum(nll.view(labels.shape) * mask), torch.sum(mask)


def forward_train(cfg, params, batch):
    """Returns (loss, metrics). Labels are pre-shifted by the data pipeline.

    ``cfg.ce_chunk`` splits the cross entropy along the sequence, so the
    (B, T, V) float32 logits are never whole; llava's labels cover only the
    text after its patches; an MoE adds ``AUX_LOSS_WEIGHT`` times its
    load-balance loss."""
    p = tfm.cast_params(cfg, params)
    x = tfm.embed_inputs(cfg, p, batch)
    T = x.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=x.device)
    x, delta, _, aux = tfm.run_blocks(cfg, p, x, positions, "train")
    _, x = tfm.add_norm(cfg, x, delta, p["final_norm"])
    labels = batch["labels"]
    if cfg.input_kind == "tokens+patches":
        x = x[:, x.shape[1] - labels.shape[1]:, :]
    Tl = labels.shape[1]
    if cfg.ce_chunk and Tl > cfg.ce_chunk and Tl % cfg.ce_chunk == 0:
        # seq-chunked CE: never materializes the full (B,T,V) float32 logits
        c = cfg.ce_chunk
        nll = ntok = 0.0
        for i in range(Tl // c):
            s, n = _ce_terms(cfg, p, x[:, i * c:(i + 1) * c, :],
                             labels[:, i * c:(i + 1) * c])
            nll, ntok = nll + s, ntok + n
    else:
        nll, ntok = _ce_terms(cfg, p, x, labels)
    ce = nll / torch.clamp(ntok, min=1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    loss = ce + AUX_LOSS_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux, "tokens": ntok.to(torch.int32)}


def prefill(cfg, params, batch):
    """Full-sequence forward that also returns the layer caches.

    Returns (last_logits (B,V) float32, caches). Cache sequence capacity is
    the prompt length; serving pads to the generation budget
    (serving/engine.pad_cache). ``cast_params`` is free when the params are
    already cast (the serving engine casts once).
    """
    p = tfm.cast_params(cfg, params)
    x = tfm.embed_inputs(cfg, p, batch)
    T = x.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=x.device)
    mode = "prefill" if cfg.supports_decode else "train"  # encoders: no cache
    x, delta, caches, _ = tfm.run_blocks(cfg, p, x, positions, mode)
    _, x = tfm.add_norm(cfg, x, delta, p["final_norm"])
    logits = tfm.unembed(cfg, p, x[:, -1:, :])
    return logits[:, 0, :].float(), (caches or {})


def decode_step(cfg, params, token, caches, cur_index):
    """One autoregressive step.

    token: (B, 1) int; cur_index: int — the absolute position the new token
    occupies (its KV lands at ``cur_index % window`` for local layers).
    Returns (logits (B, V) float32, caches); the caches are updated in place
    and returned.
    """
    p = tfm.cast_params(cfg, params)
    x = tfm.embed_inputs(cfg, p, {"tokens": token})
    positions = torch.full((1,), int(cur_index), dtype=torch.int32,
                           device=x.device)
    x, delta, caches, _ = tfm.run_blocks(cfg, p, x, positions, "decode",
                                         caches, cur_index)
    _, x = tfm.add_norm(cfg, x, delta, p["final_norm"])
    logits = tfm.unembed(cfg, p, x)
    return logits[:, 0, :].float(), caches


# ---------------------------------------------------------------------------
# train step factories
# ---------------------------------------------------------------------------
def value_and_grad(cfg, params, batch):
    """((loss, metrics), grads): ``jax.value_and_grad`` of ``forward_train``
    with respect to ``params``. The grads are new tensors in the params'
    dtypes; the params themselves get no ``.grad`` and are not changed (the
    graph runs on detached aliases of them)."""
    leaves = []

    def alias(t):
        leaves.append(t.detach().requires_grad_())
        return leaves[-1]
    live = tree_map(alias, params)
    loss, metrics = forward_train(cfg, live, batch)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda _: next(it), params))


def _split(batch, n):
    """``batch`` as n microbatches along its leading axis."""
    parts = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(cfg, optimizer, num_microbatches: int = 1):
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    ``num_microbatches > 1`` accumulates float32 gradients over the
    microbatches in turn (memory, not throughput); the loss is their mean,
    the other metrics the last one's. The optimizer updates the params and
    its state in place and returns them."""

    def train_step(params, opt_state, batch, step):
        if num_microbatches == 1:
            (loss, metrics), grads = value_and_grad(cfg, params, batch)
        else:
            gsum = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                                  device=t.device), params)
            losses = []
            for mb in _split(batch, num_microbatches):
                (mb_loss, metrics), g = value_and_grad(cfg, params, mb)
                tree_map(lambda a, b: a.add_(b), gsum, g)
                losses.append(mb_loss)
            grads = tree_map(lambda g: g / num_microbatches, gsum)
            loss = torch.mean(torch.stack(losses))
        params, opt_state, gnorm = optimizer.update(params, opt_state, grads,
                                                    step)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step


def make_micro_step(cfg):
    """(params, grad_acc, batch_micro) -> (grad_acc', (loss, metrics)).

    grad_acc mirrors params in float32; this microbatch's grads are added
    into it in place (the JAX package donates it)."""

    def micro_step(params, grad_acc, batch):
        (loss, metrics), grads = value_and_grad(cfg, params, batch)
        tree_map(lambda a, g: a.add_(g.float()), grad_acc, grads)
        return grad_acc, (loss, metrics)

    return micro_step


def make_apply_step(cfg, optimizer, num_microbatches: int):
    """(params, opt_state, grad_acc, step) -> (params', opt_state', zeros,
    gnorm); grad_acc is zeroed in place and returned as ``zeros``."""

    def apply_step(params, opt_state, grad_acc, step):
        grads = tree_map(lambda g: g / float(num_microbatches), grad_acc)
        params, opt_state, gnorm = optimizer.update(params, opt_state, grads,
                                                    step)
        return params, opt_state, tree_map(torch.zero_, grad_acc), gnorm

    return apply_step


def grad_acc_defs(pdefs):
    return tree_map(lambda d: prm.ParamDef(d.shape, d.axes, "zeros"), pdefs,
                    is_leaf=lambda x: isinstance(x, prm.ParamDef))


# ---------------------------------------------------------------------------
# spec helpers (SpecDef / ParamDef -> TensorSpec / PartitionSpec / DTensor)
# ---------------------------------------------------------------------------
def _is_def(x):
    return isinstance(x, (SpecDef, prm.ParamDef))


def _mesh_device(mesh, device):
    """The mesh's device type where there is a mesh, else ``device``."""
    return str(prm.check_device(mesh.device_type if mesh is not None else device))


def spec_structs(defs, rules=None, mesh=None, device="cuda"):
    """``TensorSpec`` stand-ins of ``defs`` on ``device`` (the JAX
    package's ``ShapeDtypeStruct``s); with rules and a mesh each carries
    the mesh and its placements (the JAX package's ``NamedSharding``)."""
    dev = _mesh_device(mesh, device)

    def mk(d: SpecDef):
        if rules is None or mesh is None:
            return TensorSpec(tuple(d.shape), getattr(torch, d.dtype), dev)
        spec = shd.pspec_for(d.shape, d.axes, rules, mesh)
        return TensorSpec(tuple(d.shape), getattr(torch, d.dtype), dev, mesh,
                          shd.placements_for(spec, mesh))
    return tree_map(mk, defs, is_leaf=_is_spec)


def spec_pspecs(defs, rules, mesh):
    return tree_map(lambda d: shd.pspec_for(d.shape, d.axes, rules, mesh), defs,
                    is_leaf=_is_def)


def spec_zeros(defs, device="cuda", rules=None, mesh=None):
    """Zero tensors of ``defs``; with rules and a mesh, DTensors in their
    placements (a decode cache's layout: the step writes it in place)."""
    if rules is not None and mesh is not None:
        from torch.distributed.tensor import zeros
        prm.check_device(mesh.device_type)
        return tree_map(
            lambda d: zeros(d.shape, dtype=getattr(torch, d.dtype), device_mesh=mesh,
                            placements=shd.placements_for(
                                shd.pspec_for(d.shape, d.axes, rules, mesh), mesh)),
            defs, is_leaf=_is_spec)
    dev = prm.check_device(device)
    return tree_map(
        lambda d: torch.zeros(d.shape, dtype=getattr(torch, d.dtype), device=dev),
        defs, is_leaf=_is_spec)


def distribute_params(tree, defs, rules, mesh):
    """``tree`` (params, or caches or a batch: tensors matching ``defs``, a
    tree of ParamDefs or SpecDefs) as DTensors on ``mesh`` in the
    placements the rules give each leaf. Every rank must hold the same
    values: each keeps its own chunk (no collective). A DTensor leaf is
    gathered first, so this also moves a tree from one mesh to another
    (``Trainer.remesh``)."""
    from torch.distributed.tensor import distribute_tensor

    def put(d, t):
        if shd.is_dtensor(t):
            t = t.full_tensor()
        t = t.to(mesh.device_type)
        spec = shd.pspec_for(d.shape, d.axes, rules, mesh)
        return distribute_tensor(t, mesh, shd.placements_for(spec, mesh),
                                 src_data_rank=None)
    return tree_map(put, defs, tree, is_leaf=_is_def)


# ---------------------------------------------------------------------------
# batch / input specs per (arch x shape) cell
# ---------------------------------------------------------------------------
def batch_defs(cfg, shape) -> dict:
    """SpecDefs for one batch of the given ShapeSpec (train/prefill kinds)."""
    B, T = shape.global_batch, shape.seq_len
    cdt = cfg.compute_dtype
    if cfg.input_kind == "frames":
        d = {"frames": SpecDef((B, T, cfg.d_model), ("batch", "seq", None), cdt)}
        if shape.kind == "train":
            d["labels"] = SpecDef((B, T), ("batch", "seq"), "int32")
        return d
    if cfg.input_kind == "tokens+patches":
        P_ = cfg.num_patches
        Ttxt = T - P_
        d = {"tokens": SpecDef((B, Ttxt), ("batch", "seq"), "int32"),
             "patches": SpecDef((B, P_, cfg.d_model), ("batch", "seq", None), cdt)}
        if shape.kind == "train":
            d["labels"] = SpecDef((B, Ttxt), ("batch", "seq"), "int32")
        return d
    d = {"tokens": SpecDef((B, T), ("batch", "seq"), "int32")}
    if shape.kind == "train":
        d["labels"] = SpecDef((B, T), ("batch", "seq"), "int32")
    return d


def decode_input_defs(cfg, shape) -> dict:
    """SpecDefs for one decode step: token + caches at capacity seq_len."""
    B, T = shape.global_batch, shape.seq_len
    return {"token": SpecDef((B, 1), ("batch", "seq"), "int32"),
            "caches": cache_defs(cfg, B, T),
            "cur_index": SpecDef((), (), "int32")}


def input_specs(cfg, shape, rules=None, mesh=None, device="cuda") -> dict:
    """TensorSpec stand-ins for every input of the cell's step fn."""
    if shape.kind == "decode":
        return spec_structs(decode_input_defs(cfg, shape), rules, mesh, device)
    return spec_structs(batch_defs(cfg, shape), rules, mesh, device)
