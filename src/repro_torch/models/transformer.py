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

from dataclasses import dataclass

import torch

from repro_torch.dist.sharding import shard
from repro_torch.models.griffin import rglru_block, rglru_cache_specs, rglru_defs
from repro_torch.models.layers import (attention, attn_cache_shape, attn_defs,
                                       block_cfg_for, ffn, ffn_defs, promote,
                                       rmsnorm)
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
def apply_block(cfg, kind, p, x, positions, mode, cache=None, cur_index=None):
    """Returns (x, new_cache, aux_loss)."""
    bc = block_cfg_for(cfg, kind)

    def norm(t, w):
        return rmsnorm(t, w, use_kernel=cfg.use_pallas)

    if bc.kind == "attn":
        h, c = attention(cfg, bc, p["mixer"], norm(x, p["norm1"]), positions,
                         mode, cache, cur_index)
    elif bc.kind == "rglru":
        h, c = rglru_block(cfg, p["mixer"], norm(x, p["norm1"]), mode, cache,
                           cfg.use_pallas)
    else:
        h, c = ssd_block(cfg, p["mixer"], x, mode, cache, cfg.use_pallas)
    x = x + h
    aux = 0.0
    if "ffn" in p:
        f, aux = ffn(cfg, p["ffn"], norm(x, p["norm2"]))
        x = x + f
    return x, c, aux


# ---------------------------------------------------------------------------
# the stack (loop over stacked cycles + unstacked remainder)
# ---------------------------------------------------------------------------
def run_blocks(cfg, params, x, positions, mode, caches=None, cur_index=None):
    """Returns (x, new_caches, aux_total).

    Prefill stacks the per-layer caches along the leading ``layers`` axis.
    Decode writes each layer's new KV (or conv window and recurrent state)
    into its slice of the stacked cache in place, so the returned caches
    are the ones passed in.
    """
    pattern = cfg.block_pattern
    n_cyc = cfg.num_layers // len(pattern)
    blocks_p = params["blocks"]
    new_caches: dict = {}
    aux_total = 0.0

    if "cycle" in blocks_p:
        cyc_p = blocks_p["cycle"]
        cyc_c = None if caches is None else caches.get("cycle")
        per_layer = []
        for i in range(n_cyc):
            p_i = tree_map(lambda a: a[i], cyc_p)
            c_i = None if cyc_c is None else tree_map(lambda a: a[i], cyc_c)
            new_c = {}
            for j, kind in enumerate(pattern):
                cj = None if c_i is None else c_i[f"p{j}"]
                x, cj_new, aux = apply_block(cfg, kind, p_i[f"p{j}"], x,
                                             positions, mode, cj, cur_index)
                new_c[f"p{j}"] = cj_new
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
        x, c_new, aux = apply_block(cfg, kind, blocks_p[f"rem{i}"], x,
                                    positions, mode, ci, cur_index)
        if mode != "train":
            new_caches[f"rem{i}"] = c_new
        aux_total = aux_total + aux
    return x, (new_caches if mode != "train" else None), aux_total


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def embed_inputs(cfg, params, batch):
    """Returns x: (B, T, D) in compute dtype."""
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.input_kind != "tokens":
        raise NotImplementedError(f"input_kind {cfg.input_kind!r} is not ported")
    x = params["embed"][batch["tokens"].long()]
    return shard(x.to(cdt), "batch", "seq", "act_embed")


def unembed(cfg, params, x):
    """x: (B,T,D) -> logits (B,T,V) in compute dtype (+softcap)."""
    if "head" in params:
        logits = torch.einsum("btd,dv->btv", *promote(x, params["head"]))
    else:
        # a matmul against the transposed view: einsum would first copy the
        # whole (V, D) embedding into a contiguous (D, V) operand, per call
        logits = torch.matmul(*promote(x, params["embed"].t()))
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
