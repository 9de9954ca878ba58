"""Transformer building blocks (port of ``repro/models/layers.py``): RMSNorm,
RoPE, GQA attention (global / sliding-window, qk-norm, ring-buffer decode
caches), the gated MLP and capacity-based top-k MoE.

Blocks run in three modes:
  train   — full sequence, no cache
  prefill — full sequence, returns the KV cache
  decode  — T=1 step against a cache (full-length or ring buffer)

The dtype plan is the JAX package's: rmsnorm and rope in f32 and cast back,
attention scores and softmax in f32 with p cast to v's dtype before PV,
masks at -1e30. Prefill attention with ``cfg.use_pallas`` goes to the
hand-written kernel (``repro_torch.kernels.flash_attention``); decode keeps
``_sdpa``, as the JAX package does. With ``cfg.use_pallas`` rope rotates q
and k in one launch of a hand-written kernel (``repro_torch.kernels.rope``)
in every mode, where the JAX package's rope is jnp; with it every norm runs
the hand-written rmsnorm kernel (``repro_torch.kernels.rmsnorm``), where the
JAX package's ``layers.rmsnorm`` stays jnp: the same function. On that path
``add_rmsnorm`` and ``gated_rmsnorm`` take the residual add or the SiLU gate
before a norm into the same launch; the plain path composes them of eager
ops, which is what the kernel's rounding follows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import (current_sharding, mesh_shape, rows_fit,
                                       shard, shard_in_place, write_)
from repro_torch.kernels import along, local_call, shard_dim
from repro_torch.kernels.flash_attention import flash_attention, local_rule
from repro_torch.kernels.rmsnorm import add_rmsnorm as add_rmsnorm_kernel
from repro_torch.kernels.rmsnorm import gated_rmsnorm as gated_rmsnorm_kernel
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.kernels.rope import rope_plain as rope
from repro_torch.kernels.rope import rope_qk
from repro_torch.models.params import ParamDef

NEG_INF = -1e30


@dataclass(frozen=True)
class BlockCfg:
    """Static per-layer info resolved from ArchConfig.block_pattern."""
    kind: str                 # attn | rglru | ssd
    window: Optional[int]     # None -> global attention
    theta: float = 10_000.0


def block_cfg_for(cfg, kind: str) -> BlockCfg:
    if kind == "global":
        theta = cfg.rope_theta_global or cfg.rope_theta
        return BlockCfg("attn", None, theta)
    if kind == "local":
        return BlockCfg("attn", cfg.local_window, cfg.rope_theta)
    if kind == "rglru":
        return BlockCfg("rglru", None)
    if kind == "ssd":
        return BlockCfg("ssd", None)
    raise ValueError(kind)


def promote(*ts):
    """The tensors cast to their promoted dtype: JAX promotes mixed bf16/f32
    operands of a contraction to f32, where ``torch.einsum`` and ``@``
    refuse them."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


# ---------------------------------------------------------------------------
# norms (rope: ``kernels.rope``)
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-6, use_kernel=False):
    """f32 statistics, cast back to x's dtype; ``use_kernel`` (the callers
    pass ``cfg.use_pallas``) routes to the kernel's wrapper."""
    if use_kernel:
        return rmsnorm_kernel(x, w, eps)
    return rmsnorm_plain(x, w, eps)


def add_rmsnorm(x, h, w, eps=1e-6, use_kernel=False):
    """``(x + h, rmsnorm(x + h, w))``: a residual add and the norm after it;
    ``use_kernel``: one launch of the kernel."""
    if use_kernel:
        return add_rmsnorm_kernel(x, h, w, eps)
    s = x + h
    return s, rmsnorm_plain(s, w, eps)


def gated_rmsnorm(y, z, w, eps=1e-6, use_kernel=False):
    """``rmsnorm(y * silu(z), w)``; ``use_kernel``: one launch of the
    kernel."""
    if use_kernel:
        return gated_rmsnorm_kernel(y, z, w, eps)
    return rmsnorm_plain(y * F.silu(z), w, eps)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attn_defs(cfg) -> dict:
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d = {
        "wq": ParamDef((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((D, K, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((D, K, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, hd, D), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        d["q_norm"] = ParamDef((hd,), ("head_dim",), "zeros")
        d["k_norm"] = ParamDef((hd,), ("head_dim",), "zeros")
    return d


def _attn_mask(q_pos, k_pos, window, causal):
    """q_pos: (Tq,), k_pos: (Tk,) absolute positions; True = attend."""
    dq = q_pos[:, None] - k_pos[None, :]
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= dq >= 0
    if window is not None:
        m &= dq < window
    return m


def _sdpa(cfg, q, k, v, mask):
    """q:(B,T,H,hd) k/v:(B,S,K,hd) mask:(T,S) or (B,T,S)."""
    B, T, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q = q.reshape(B, T, K, G, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", q, k).float()
    scores = scores * hd ** -0.5
    if mask.ndim == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", p, v)
    return out.reshape(B, T, H, hd)


def _sdpa_chunked(cfg, q, k, v, q_pos, k_pos, window, causal, chunk):
    """Flash-style q-chunked attention: scores stay O(chunk x S).

    For sliding-window layers the K/V are sliced to the band
    [chunk_start - window + 1, chunk_end], so local attention costs
    O(T*(window+chunk)) instead of O(T*S). Each chunk runs under a
    non-reentrant ``torch.utils.checkpoint`` (the JAX package's
    ``@jax.checkpoint``): the backward pass recomputes the chunk's score
    tile instead of saving it.

    ``cfg.attn_chunk_unroll`` picks unrolled chunks or a ``lax.scan`` in the
    JAX package. Eager PyTorch has no such split: the chunks are a Python
    loop either way, so the field is accepted and has no effect here.
    """
    T, S = q.shape[1], k.shape[1]
    n = T // chunk
    assert T % chunk == 0, (T, chunk)

    banded = window is not None and S > window + chunk
    if banded:
        band = window + chunk
        # left-pad so every chunk's band slice has the size `band`; padded
        # positions get k_pos = -(window + 1) (always masked by dq < window)
        pad = band - chunk
        k = F.pad(k, (0, 0, 0, 0, pad, 0))
        v = F.pad(v, (0, 0, 0, 0, pad, 0))
        k_pos = F.pad(k_pos, (pad, 0), value=-(window + 1))

    def one(i, qi, qpos_i):
        if banded:
            ks = k[:, i * chunk:i * chunk + band]
            vs = v[:, i * chunk:i * chunk + band]
            kp = k_pos[i * chunk:i * chunk + band]
        else:
            ks, vs, kp = k, v, k_pos
        mask = _attn_mask(qpos_i, kp, window, causal)
        return _sdpa(cfg, qi, ks, vs, mask)

    outs = [checkpoint(one, i, q[:, i * chunk:(i + 1) * chunk],
                       q_pos[i * chunk:(i + 1) * chunk], use_reentrant=False)
            for i in range(n)]
    return torch.cat(outs, dim=1)


def attention(cfg, bc: BlockCfg, p, x, positions, mode, cache=None,
              cur_index=None, host=None):
    """Returns (out, new_cache). With ``cfg.use_pallas`` q and k are
    rotated in one launch (``rope_qk``); else by two ``rope`` calls, which
    get ``host``, an open ``dispatch`` span.

    prefill: cache returned is (k, v) over the full sequence, or a ring
    buffer of size `window` for local layers.
    decode:  T==1; the cache tensors are updated IN PLACE at `cur_index`
    (the JAX package returns an updated copy; writing in place saves a full
    cache copy per step, and no caller reuses the old cache).
    """
    B, T, D = x.shape
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], use_kernel=cfg.use_pallas)
        k = rmsnorm(k, p["k_norm"], use_kernel=cfg.use_pallas)
    if cfg.use_pallas:
        q, k = rope_qk(q, k, positions, bc.theta)
    else:
        q = rope(q, positions, bc.theta, host)
        k = rope(k, positions, bc.theta, host)
    q = shard(q, "batch", "attn_seq", "act_heads", None)
    k = shard(k, "batch", None, "act_kv", None)
    v = shard(v, "batch", None, "act_kv", None)

    if mode in ("train", "prefill"):
        causal = cfg.causal
        pos = positions if positions.ndim == 1 else positions[0]
        if cfg.use_pallas:
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal, window=bc.window)
        else:
            def plain(q, k, v):
                if cfg.attn_chunk_q and T > cfg.attn_chunk_q:
                    return _sdpa_chunked(cfg, q, k, v, pos, pos, bc.window, causal,
                                         cfg.attn_chunk_q)
                return _sdpa(cfg, q, k, v, _attn_mask(pos, pos, bc.window, causal))
            # DTensors: on the local shards, as the kernel's wrapper runs
            # (batch, or heads where q and kv split alike); DTensor's own
            # einsum would flatten a batch split two ways beside split heads
            # into one strided dim, whose redistribution plan it searches
            # for minutes on a 3-D mesh
            out = local_call(plain, (q, k, v), local_rule)
        new_cache = None
        if mode == "prefill":
            if bc.window is not None and T > bc.window:
                # keep only the trailing window as a ring buffer
                W = bc.window
                start = T - W
                kr, vr = k[:, start:], v[:, start:]
                # roll so that slot i = position p with p % W == i (two
                # slices: DTensor has no rule for roll in some versions)
                shift = start % W
                kr, vr = (torch.cat([c[:, W - shift:], c[:, :W - shift]], dim=1)
                          for c in (kr, vr))
                new_cache = (kr, vr)
            else:
                new_cache = (k, v)
            # the decode step's layout, which it writes in place
            new_cache = tuple(shard(c, "batch", "cache_seq", "act_kv", None)
                              for c in new_cache)
    else:  # decode
        ck, cv = cache
        S = ck.shape[1]
        cur = int(cur_index)
        ring = bc.window is not None and S == bc.window
        slot = cur % S if ring else cur
        # the JAX package's dynamic_update_slice clamps the start index
        slot = min(max(slot, 0), S - 1)
        # the cache stays where it is (a seq dim sharded over "model" is
        # written by the rank that holds the slot, into its own shard)
        ck = shard_in_place(ck, "batch", "cache_seq", "act_kv", None)
        cv = shard_in_place(cv, "batch", "cache_seq", "act_kv", None)
        write_(ck, 1, slot, k)
        write_(cv, 1, slot, v)
        idx = torch.arange(S, device=x.device)
        if ring:
            # slot i holds absolute position cur - ((cur - i) mod S)
            k_pos = cur - torch.remainder(cur - idx, S)
            valid = k_pos >= 0
        else:
            k_pos = idx
            valid = idx <= cur
        dq = cur - k_pos
        m = valid & (dq >= 0)
        if bc.window is not None:
            m &= dq < bc.window
        # the one query row whole across heads: the cache splits its seq
        # over "model", so the scores split along S (a head split beside it
        # would make DTensor interleave both in one batch dim of the bmm)
        q = shard(q, "batch", "attn_seq", None, None)
        out = _sdpa(cfg, q, ck, cv, m[None, None, :].expand(B, 1, S))
        new_cache = (ck, cv)

    out = torch.einsum("bthk,hkd->btd", out, p["wo"])
    return shard(out, "batch", "seq", "act_embed"), new_cache


def attn_cache_shape(cfg, bc: BlockCfg, batch, seq_len):
    S = seq_len if bc.window is None else min(bc.window, seq_len)
    return (batch, S, cfg.num_kv_heads, cfg.head_dim)


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------
def mlp_defs(cfg) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((D, F_), ("embed", "ff")),
        "w_up": ParamDef((D, F_), ("embed", "ff")),
        "w_down": ParamDef((F_, D), ("ff", "embed")),
    }


def mlp(cfg, p, x):
    g = torch.einsum("btd,df->btf", x, p["w_gate"])
    u = torch.einsum("btd,df->btf", x, p["w_up"])
    h = F.silu(g) * u
    h = shard(h, "batch", "seq", "act_ff")
    out = torch.einsum("btf,fd->btd", h, p["w_down"])
    return shard(out, "batch", "seq", "act_embed")


# ---------------------------------------------------------------------------
# MoE: top-k token-choice routing with BATCH-GROUP-LOCAL dispatch, capacity-
# limited, to stacked experts, gate-weighted combine. Tokens are regrouped
# (N, D) -> (G, N/G, D) with G = the mesh's batch-shard count; slots and the
# capacity are per group, so the (G, E, C, D) dispatch buffer shards over
# the batch axes with no collective. Outside a mesh G = 1.
# ---------------------------------------------------------------------------
def moe_defs(cfg) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    e_ax = None if cfg.moe_tp_ff else "expert"
    return {
        "router": ParamDef((D, E), ("embed", None)),
        "w_gate": ParamDef((E, D, F_), (e_ax, "embed", "ff")),
        "w_up": ParamDef((E, D, F_), (e_ax, "embed", "ff")),
        "w_down": ParamDef((E, F_, D), (e_ax, "ff", "embed")),
    }


def _batch_groups(n_tokens: int) -> int:
    """Batch-shard count of the ambient mesh (1 outside a mesh context, or
    where it does not divide the tokens)."""
    mesh, rules = current_sharding()
    if mesh is None or rules is None:
        return 1
    spec = rules.lookup("batch")
    if spec is None:
        return 1
    shape = mesh_shape(mesh)
    g = 1
    for a in ((spec,) if isinstance(spec, str) else tuple(spec)):
        g *= shape.get(a, 1)
    return g if n_tokens % g == 0 else 1


def moe_route(cfg, p, xg):
    """Routing of xg (G, n, D), in float32. Returns (probs (G,n,E), gate_w
    (G,n,K) renormalised over the top k, gate_i (G,n,K) expert indices in
    descending probability, pos (G,n,K) the slot each choice asks for within
    its expert, capacity C). Slots are handed out choice by choice (every
    token's first choice before any second choice), tokens in order."""
    n = xg.shape[1]
    E, K = cfg.num_experts, cfg.top_k
    logits = torch.einsum("gnd,de->gne", xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.topk(probs, K, dim=-1, sorted=True)
    gate_w = gate_w / torch.sum(gate_w, dim=-1, keepdim=True)
    # Python arithmetic, exactly the JAX package's expression
    C = max(1, int(n * K / E * cfg.capacity_factor))
    return probs, gate_w, gate_i, moe_slots(gate_i, E), C


def moe_slots(gate_i, E):
    """The slot each choice of gate_i (G, n, K) asks for within its expert:
    the exclusive count of earlier asks for the same expert over the
    (choice, token)-ordered sequence of asks."""
    G, n, K = gate_i.shape
    asks = gate_i.transpose(1, 2).reshape(G, K * n)              # choice-major
    # (G, E, K*n): the count runs along the contiguous last axis (on the
    # card a scan along a strided axis runs one thread per expert)
    oh = F.one_hot(asks, E).transpose(1, 2).contiguous()
    before = torch.cumsum(oh, dim=2) - oh
    pos = torch.gather(before, 1, asks[:, None, :])[:, 0]
    return pos.reshape(G, K, n).transpose(1, 2)                  # (G, n, K)


def _by_groups(ps):
    """Every input and the output split alike along the routing groups
    (dim 0); any other split is replicated first."""
    return along(ps, (0,) * len(ps), (0,)) if shard_dim(ps[0]) == 0 else None


def _dispatch(E, C):
    """(xg, keep, gate_i, slot) -> the (G, E, C, D) buffer: each kept choice
    of each token added into its expert's slot (a dropped choice adds
    zeros at slot C-1)."""
    def dispatch(xg, keep, gate_i, slot):
        G, n, D = xg.shape
        K = gate_i.shape[-1]
        g_idx = torch.arange(G, device=xg.device)[:, None, None].expand(G, n, K)
        upd = xg[:, :, None, :] * keep.to(xg.dtype)[..., None]    # (G, n, K, D)
        buf = xg.new_zeros((G, E, C, D))
        buf.index_put_((g_idx.reshape(-1), gate_i.reshape(-1), slot.reshape(-1)),
                       upd.reshape(-1, D), accumulate=True)
        return buf
    return dispatch


def _combine(dtype):
    """(out_buf, gate_w, keep, gate_i, slot) -> (G, n, D): the gate, rounded
    to out_buf's dtype, times the slot's output, each token's choices added
    in increasing expert order, in ``dtype``."""
    def combine(out_buf, gate_w, keep, gate_i, slot):
        G, n, K = gate_i.shape
        g_idx = torch.arange(G, device=out_buf.device)[:, None, None].expand(G, n, K)
        gate = (gate_w * keep).to(out_buf.dtype)                 # (G, n, K)
        order = torch.argsort(gate_i, dim=-1)
        ex, sl, gate = (torch.gather(t, 2, order) for t in (gate_i, slot, gate))
        contrib = (out_buf[g_idx, ex, sl] * gate[..., None]).to(dtype)  # (G,n,K,D)
        out = torch.zeros((G, n, out_buf.shape[-1]), dtype=dtype, device=out_buf.device)
        for j in range(K):
            out = out + contrib[:, :, j]
        return out
    return combine


def _experts(buf, w_gate, w_up, w_down):
    """The gated FFN of each expert e on its slots buf[:, e]."""
    g_ = torch.einsum("gecd,edf->gecf", *promote(buf, w_gate))
    u = torch.einsum("gecd,edf->gecf", *promote(buf, w_up))
    return torch.einsum("gecf,efd->gecd", *promote(F.silu(g_) * u, w_down))


def _experts_rule(ps):
    """Independent along the groups (buf's dim 0) and along the experts
    (buf's dim 1 with the weights' dim 0); a split of the ff width, whose
    down projection sums over it, is replicated first."""
    d = shard_dim(ps[0])
    if d == 0:
        return along(ps, (0, None, None, None), (0,))
    if d == 1 or all(shard_dim(q) == 0 for q in ps[1:]):
        return along(ps, (1, 0, 0, 0), (1,))
    return None


def moe(cfg, p, x):
    """x: (B,T,D) -> ((B,T,D), aux load-balance loss).

    A choice whose slot is past the capacity C is dropped: it contributes
    nothing, and its zero update goes to slot C-1 of its expert, which may
    hold a kept token, so the dispatch scatter ADDS (``index_put_`` with
    ``accumulate=True``), as the JAX package's ``.at[].add``. The combine is
    deterministic: each token's kept contributions are gathered and added
    in increasing expert order, in x's dtype: the order in which XLA's
    scatter-add of the JAX package sums them (atomics on the card would
    sum them in an order that changes from run to run)."""
    B, T, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    N = B * T
    G = _batch_groups(N)
    n = N // G
    xg = shard(x.reshape(G, n, D), "batch", None, None)
    probs, gate_w, gate_i, pos, C = moe_route(cfg, p, xg)
    keep = pos < C
    slot = pos.clamp(max=C - 1)  # a dropped choice points at slot C-1

    # dispatch, the experts and the combine, each on the local groups (and
    # experts) of DTensors: groups route independently (``_by_groups``)
    buf = local_call(_dispatch(E, C), (xg, keep, gate_i, slot), _by_groups)
    w = (p["w_gate"], p["w_up"], p["w_down"])
    out_buf = local_call(_experts, (buf,) + w, _experts_rule)
    out = local_call(_combine(x.dtype), (out_buf, gate_w, keep, gate_i, slot),
                     _by_groups)
    out = rows_fit(out, B).reshape(B, T, D)

    # switch-style load-balance aux loss
    me = torch.mean(probs, dim=(0, 1))                           # (E,)
    fe = torch.mean(F.one_hot(gate_i[..., 0], E).float(), dim=(0, 1))
    aux = torch.sum(me * fe) * E
    return shard(out, "batch", "seq", "act_embed"), aux


def ffn_defs(cfg) -> dict:
    return moe_defs(cfg) if cfg.num_experts else mlp_defs(cfg)


def ffn(cfg, p, x):
    """Returns (out, aux_loss)."""
    if cfg.num_experts:
        return moe(cfg, p, x)
    return mlp(cfg, p, x), 0.0
