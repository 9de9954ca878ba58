"""The backbone (port of ``repro/models/transformer.py``).

A model is ``embed -> [blocks cycled from cfg.block_pattern] -> norm ->
head``. Block kinds: "global"/"local" attention, "rglru" (griffin temporal
mixing, ``models/griffin.py``) and "ssd" (mamba-2, ``models/ssm.py``). Layers
are grouped into *cycles* of ``len(block_pattern)`` whose parameters are
stacked along a leading ``layers`` axis, exactly as in the JAX package;
where that package scans the stack with ``jax.lax.scan``, the port runs a
Python loop over the leading axis of the same stacked tensors. Remainder
layers (``num_layers % pattern``) run unstacked.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch import spanhook
from repro_torch.dist.sharding import fsdp_gather, shard, vocab_rows
from repro_torch.models.griffin import rglru_block, rglru_cache_specs, rglru_defs
from repro_torch.models.layers import (add_rmsnorm, attention, attn_cache_shape,
                                       attn_defs, block_cfg_for, ffn, ffn_defs,
                                       promote, rmsnorm)
from repro_torch.models.params import ParamDef, stack_defs
from repro_torch.models.ssm import ssd_block, ssd_cache_specs, ssd_defs
from repro_torch.models.tree import tree_map


# ---------------------------------------------------------------------------
# parameter structure
# ---------------------------------------------------------------------------
def block_defs(cfg, kind: str) -> dict:
    bc = block_cfg_for(cfg, kind)
    D = cfg.d_model
    if bc.kind == "ssd":
        d = {"mixer": ssd_defs(cfg)}          # ssd blocks self-norm
    elif bc.kind == "rglru":
        d = {"norm1": ParamDef((D,), ("embed",), "zeros"),
             "mixer": rglru_defs(cfg)}
    else:
        d = {"norm1": ParamDef((D,), ("embed",), "zeros"),
             "mixer": attn_defs(cfg)}
    if cfg.d_ff:
        d["norm2"] = ParamDef((D,), ("embed",), "zeros")
        d["ffn"] = ffn_defs(cfg)
    return d


def transformer_defs(cfg) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    pattern = cfg.block_pattern
    n_cyc, n_rem = divmod(cfg.num_layers, len(pattern))
    blocks: dict = {}
    if n_cyc:
        blocks["cycle"] = {
            f"p{j}": stack_defs(block_defs(cfg, k), n_cyc)
            for j, k in enumerate(pattern)}
    rem_kinds = cfg.layer_kinds()[n_cyc * len(pattern):]
    for i, k in enumerate(rem_kinds):
        blocks[f"rem{i}"] = block_defs(cfg, k)

    d: dict = {"blocks": blocks,
               "final_norm": ParamDef((D,), ("embed",), "zeros")}
    if cfg.input_kind == "frames":
        d["in_proj"] = ParamDef((D, D), ("embed", None))
        d["head"] = ParamDef((D, V), ("embed", "vocab"))
    else:
        d["embed"] = ParamDef((V, D), ("vocab", "embed"), "embed")
        if cfg.input_kind == "tokens+patches":
            d["patch_proj"] = ParamDef((D, D), ("embed", None))
        if not cfg.tie_embeddings:
            d["head"] = ParamDef((D, V), ("embed", "vocab"))
    return d


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------
def add_norm(cfg, x, h, w):
    """``(x + h, rmsnorm(x + h, w))``; ``h`` None: nothing to add."""
    w = fsdp_gather(w)
    if h is None:
        return x, rmsnorm(x, w, use_kernel=cfg.use_pallas)
    return add_rmsnorm(x, h, w, use_kernel=cfg.use_pallas)


def block_deferred(cfg, kind, p, x, positions, mode, cache=None, cur_index=None,
                   delta=None, host=None):
    """One block whose input is ``x + delta`` and whose last residual add
    is left pending. Returns (x, delta, new_cache, aux_loss): the block's
    output is ``x + delta``. ``host``: an open ``dispatch`` span, whose
    ``attention_s`` gets the host seconds of the attention call (and
    ``sync_s`` those of the plain rope's copies, ``layers.rope``; none
    with ``cfg.use_pallas``, where ``rope_qk`` copies nothing)."""
    bc = block_cfg_for(cfg, kind)
    if bc.kind == "ssd":
        x, u = add_norm(cfg, x, delta, p["mixer"]["norm"])
        h, c = ssd_block(cfg, p["mixer"], x, mode, cache, cfg.use_pallas, u=u)
    else:
        x, u = add_norm(cfg, x, delta, p["norm1"])
        if bc.kind == "attn":
            t0 = time.perf_counter() if host is not None else 0.0
            h, c = attention(cfg, bc, p["mixer"], u, positions, mode, cache,
                             cur_index, host)
            if host is not None:
                host.attrs["attention_s"] += time.perf_counter() - t0
        else:
            h, c = rglru_block(cfg, p["mixer"], u, mode, cache, cfg.use_pallas)
    aux = 0.0
    if "ffn" in p:
        x, u = add_norm(cfg, x, h, p["norm2"])
        h, aux = ffn(cfg, p["ffn"], u)
    return x, h, c, aux


def apply_block(cfg, kind, p, x, positions, mode, cache=None, cur_index=None):
    """Returns (x, new_cache, aux_loss)."""
    x, h, c, aux = block_deferred(cfg, kind, p, x, positions, mode, cache,
                                  cur_index)
    return x + h, c, aux


# ---------------------------------------------------------------------------
# the stack (loop over stacked cycles + unstacked remainder)
# ---------------------------------------------------------------------------
def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the output of a matmul without batch dims (``mm``, ``addmm``, or a
    ``bmm`` of batch 1, which is what ``torch.einsum`` makes of one) and
    recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(kind, body):
    """``body`` under non-reentrant activation checkpointing (the JAX
    package's ``jax.checkpoint`` of the scanned cycle): ``"full"`` saves
    only the cycle's inputs and recomputes the rest in the backward pass;
    ``"dots"`` also saves the outputs of matmuls without batch dims. The
    deferred residual (``delta``) is one of the inputs and outputs, so the
    region's boundary is the whole of the stream."""
    if kind == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if kind == "dots":
        return functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"remat {kind!r}: choose none, full or dots")


def run_blocks(cfg, params, x, positions, mode, caches=None, cur_index=None):
    """Returns (x, delta, new_caches, aux_total): the stack's output is
    ``x + delta``, the last block's residual add left to the final norm
    (``add_norm``).

    In train mode ``cfg.remat`` ("full" or "dots") checkpoints each
    stacked cycle (``_remat``); as in the JAX package, the unstacked
    remainder layers are not checkpointed.

    Prefill stacks the per-layer caches along the leading ``layers`` axis.
    Decode writes each layer's new KV (or conv window and recurrent state)
    into its slice of the stacked cache in place, so the returned caches
    are the ones passed in.

    While the calling thread has a ``dispatch`` span open (``spanhook``, a
    traced ``prefill``), each attention call's host seconds add to its
    ``attention_s``.
    """
    host = spanhook.current()
    if host is not None and host.kind != "dispatch":
        host = None  # a bound span other than a traced prefill's: not stamped
    pattern = cfg.block_pattern
    n_cyc = cfg.num_layers // len(pattern)
    blocks_p = params["blocks"]
    new_caches: dict = {}
    aux_total = 0.0
    delta = None

    if "cycle" in blocks_p:
        cyc_p = blocks_p["cycle"]
        cyc_c = None if caches is None else caches.get("cycle")
        per_layer = []

        def body(x, delta, p_i, c_i):
            # gathered inside the (checkpointed) body: recomputed, not saved
            p_i = tree_map(fsdp_gather, p_i)
            new_c, aux_c = {}, 0.0
            for j, kind in enumerate(pattern):
                cj = None if c_i is None else c_i[f"p{j}"]
                x, delta, cj_new, aux = block_deferred(
                    cfg, kind, p_i[f"p{j}"], x, positions, mode, cj, cur_index,
                    delta, host)
                new_c[f"p{j}"] = cj_new
                aux_c = aux_c + aux
            return x, delta, new_c, aux_c

        if mode == "train" and cfg.remat != "none":
            body = _remat(cfg.remat, body)
        # each layer's slice of the stacked params as a view from one
        # ``unbind`` a leaf: its backward stacks the slices' grads once,
        # where ``a[i]`` would put each into a zero tensor of the whole stack
        slices = []
        tree_map(lambda a: slices.append(a.unbind(0)), cyc_p)
        for i in range(n_cyc):
            it = iter(slices)
            p_i = tree_map(lambda _: next(it)[i], cyc_p)
            c_i = None if cyc_c is None else tree_map(lambda a: a[i], cyc_c)
            x, delta, new_c, aux = body(x, delta, p_i, c_i)
            aux_total = aux_total + aux
            per_layer.append(new_c)
        if mode == "prefill":
            new_caches["cycle"] = tree_map(lambda *ls: torch.stack(ls),
                                           *per_layer)
        elif mode == "decode":
            new_caches["cycle"] = cyc_c  # updated in place, slice by slice

    rem_kinds = cfg.layer_kinds()[n_cyc * len(pattern):]
    for i, kind in enumerate(rem_kinds):
        ci = None if caches is None else caches.get(f"rem{i}")
        x, delta, c_new, aux = block_deferred(
            cfg, kind, tree_map(fsdp_gather, blocks_p[f"rem{i}"]), x, positions,
            mode, ci, cur_index, delta, host)
        if mode != "train":
            new_caches[f"rem{i}"] = c_new
        aux_total = aux_total + aux
    return x, delta, (new_caches if mode != "train" else None), aux_total


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def embed_inputs(cfg, params, batch):
    """Returns x: (B, T, D) in compute dtype. ``frames`` (B, T, D) go
    through ``in_proj``; ``patches`` (B, P, D), where the config takes them
    and the batch has them, through ``patch_proj``, in front of the token
    embeddings."""
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.input_kind == "frames":
        x = torch.einsum("btd,de->bte", *promote(batch["frames"].to(cdt),
                                                 fsdp_gather(params["in_proj"])))
    elif cfg.input_kind in ("tokens", "tokens+patches"):
        x = vocab_rows(fsdp_gather(params["embed"]), batch["tokens"].long())
        if cfg.input_kind == "tokens+patches" and "patches" in batch:
            pat = torch.einsum("bpd,de->bpe", *promote(
                batch["patches"].to(cdt), fsdp_gather(params["patch_proj"])))
            x = torch.cat(promote(pat, x), dim=1)
    else:
        raise NotImplementedError(f"input_kind {cfg.input_kind!r} is not ported")
    return shard(x.to(cdt), "batch", "seq", "act_embed")


def unembed(cfg, params, x):
    """x: (B,T,D) -> logits (B,T,V) in compute dtype (+softcap)."""
    if "head" in params:
        logits = torch.einsum("btd,dv->btv", *promote(x, fsdp_gather(params["head"])))
    else:
        # a matmul against the transposed view: einsum would first copy the
        # whole (V, D) embedding into a contiguous (D, V) operand, per call
        logits = torch.matmul(*promote(x, fsdp_gather(params["embed"]).t()))
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits.float() / c)
    return shard(logits, "batch", "seq", "act_vocab")


def cast_params(cfg, params):
    """Matmul weights (ndim>=2) -> compute dtype; vectors stay float32
    (norm scales, A_log/lam/dt_bias gates are precision-sensitive). A tensor
    already in its target dtype is returned as is, so casting cast params
    costs no copy.

    As in the JAX package, the test is ``ndim``: a cycled layer's vectors
    are stacked to ``(L, D)`` and so are cast to the compute dtype too; only
    the unstacked remainder layers keep theirs in float32."""
    cdt = getattr(torch, cfg.compute_dtype)

    def cast(x):
        return x.to(cdt) if x.ndim >= 2 else x.to(torch.float32)
    return tree_map(cast, params)


# ---------------------------------------------------------------------------
# cache structure (SpecDefs mirror the forward's cache tree exactly)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SpecDef:
    shape: tuple
    axes: tuple
    dtype: str = "bfloat16"


def _is_spec(x):
    return isinstance(x, SpecDef)


def _block_cache_defs(cfg, kind, batch, seq_len):
    bc = block_cfg_for(cfg, kind)
    cdt = cfg.compute_dtype
    if bc.kind == "attn":
        sh = attn_cache_shape(cfg, bc, batch, seq_len)
        ax = ("batch", "cache_seq", "act_kv", None)
        return (SpecDef(sh, ax, cdt), SpecDef(sh, ax, cdt))
    if bc.kind == "rglru":
        s = rglru_cache_specs(cfg, batch)
        return {"conv": SpecDef(s["conv"], ("batch", None, "act_inner"), cdt),
                "h": SpecDef(s["h"], ("batch", "act_inner"), "float32")}
    s = ssd_cache_specs(cfg, batch)
    return {"conv": SpecDef(s["conv"], ("batch", None, "act_inner"), cdt),
            "state": SpecDef(s["state"], ("batch", "act_inner", None, None),
                             "float32")}


def _stack_spec(d: SpecDef, n: int) -> SpecDef:
    return SpecDef((n,) + d.shape, ("layers",) + d.axes, d.dtype)


def cache_defs(cfg, batch, seq_len) -> dict:
    pattern = cfg.block_pattern
    n_cyc, _ = divmod(cfg.num_layers, len(pattern))
    out: dict = {}
    if n_cyc:
        out["cycle"] = {
            f"p{j}": tree_map(lambda d: _stack_spec(d, n_cyc),
                              _block_cache_defs(cfg, k, batch, seq_len),
                              is_leaf=_is_spec)
            for j, k in enumerate(pattern)}
    rem_kinds = cfg.layer_kinds()[n_cyc * len(pattern):]
    for i, k in enumerate(rem_kinds):
        out[f"rem{i}"] = _block_cache_defs(cfg, k, batch, seq_len)
    return out
