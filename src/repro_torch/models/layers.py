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
``_sdpa``, as the JAX package does. With ``cfg.use_pallas`` every norm runs
the hand-written rmsnorm kernel (``repro_torch.kernels.rmsnorm``), where the
JAX package's ``layers.rmsnorm`` stays jnp: the same function.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import current_sharding, shard
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.rmsnorm import rmsnorm_plain
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
# norms / rope
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-6, use_kernel=False):
    """f32 statistics, cast back to x's dtype; ``use_kernel`` (the callers
    pass ``cfg.use_pallas``) routes to the kernel's wrapper."""
    if use_kernel:
        return rmsnorm_kernel(x, w, eps)
    return rmsnorm_plain(x, w, eps)


def rope(x, positions, theta):
    """x: (..., T, n, d) rotated pairwise; positions: (..., T)."""
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                     exponent)
    ang = positions[..., None].float() * freq  # (..., T, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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


def attention(cfg, bc: BlockCfg, p, x, positions, mode, cache=None,
              cur_index=None):
    """Returns (out, new_cache).

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
    q = rope(q, positions, bc.theta)
    k = rope(k, positions, bc.theta)
    q = shard(q, "batch", "attn_seq", "act_heads", None)
    k = shard(k, "batch", None, "act_kv", None)
    v = shard(v, "batch", None, "act_kv", None)

    if mode in ("train", "prefill"):
        causal = cfg.causal
        pos = positions if positions.ndim == 1 else positions[0]
        if cfg.use_pallas:
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal, window=bc.window)
        elif cfg.attn_chunk_q and T > cfg.attn_chunk_q:
            raise NotImplementedError(
                "q-chunked attention (attn_chunk_q) is not ported; use "
                "use_pallas=True or attn_chunk_q=0")
        else:
            mask = _attn_mask(pos, pos, bc.window, causal)
            out = _sdpa(cfg, q, k, v, mask)
        new_cache = None
        if mode == "prefill":
            if bc.window is not None and T > bc.window:
                # keep only the trailing window as a ring buffer
                W = bc.window
                start = T - W
                kr, vr = k[:, start:], v[:, start:]
                # roll so that slot i = position p with p % W == i
                shift = start % W
                kr = torch.roll(kr, shift, dims=1)
                vr = torch.roll(vr, shift, dims=1)
                new_cache = (kr, vr)
            else:
                new_cache = (k, v)
    else:  # decode
        ck, cv = cache
        S = ck.shape[1]
        cur = int(cur_index)
        ring = bc.window is not None and S == bc.window
        slot = cur % S if ring else cur
        # the JAX package's dynamic_update_slice clamps the start index
        slot = min(max(slot, 0), S - 1)
        ck[:, slot:slot + 1] = k
        cv[:, slot:slot + 1] = v
        ck = shard(ck, "batch", "cache_seq", "act_kv", None)
        cv = shard(cv, "batch", "cache_seq", "act_kv", None)
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
# MoE: top-k token-choice routing, capacity-limited dispatch to stacked
# experts, gate-weighted combine. The JAX package groups tokens by the mesh's
# batch shards (G groups, each with its own capacity); outside a mesh G = 1,
# and the port runs no mesh.
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
    """Routing groups: 1 outside a mesh; a mesh raises, as ``shard`` does."""
    mesh, rules = current_sharding()
    if mesh is None or rules is None:
        return 1
    raise NotImplementedError(
        "MoE under a device mesh: distribution is not ported yet; run "
        "single-card platforms (Platform.mesh=None)")


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
    xg = x.reshape(G, n, D)
    probs, gate_w, gate_i, pos, C = moe_route(cfg, p, xg)
    keep = pos < C
    slot = pos.clamp(max=C - 1)  # a dropped choice points at slot C-1

    # dispatch into (G, E, C, D)
    g_idx = torch.arange(G, device=x.device)[:, None, None].expand(G, n, K)
    upd = xg[:, :, None, :] * keep.to(x.dtype)[..., None]        # (G, n, K, D)
    buf = x.new_zeros((G, E, C, D))
    buf.index_put_((g_idx.reshape(-1), gate_i.reshape(-1), slot.reshape(-1)),
                   upd.reshape(-1, D), accumulate=True)

    # expert FFN on the stacked weights
    g_ = torch.einsum("gecd,edf->gecf", *promote(buf, p["w_gate"]))
    u = torch.einsum("gecd,edf->gecf", *promote(buf, p["w_up"]))
    h = F.silu(g_) * u
    out_buf = torch.einsum("gecf,efd->gecd", *promote(h, p["w_down"]))

    # combine: the gate, rounded to out_buf's dtype, times the slot's
    # output, each token's choices taken in increasing expert order
    gate = (gate_w * keep).to(out_buf.dtype)                     # (G, n, K)
    order = torch.argsort(gate_i, dim=-1)
    ex, sl, gate = (torch.gather(t, 2, order) for t in (gate_i, slot, gate))
    contrib = (out_buf[g_idx, ex, sl] * gate[..., None]).to(x.dtype)  # (G,n,K,D)
    out = torch.zeros((G, n, D), dtype=x.dtype, device=x.device)
    for j in range(K):
        out = out + contrib[:, :, j]
    out = out.reshape(B, T, D)

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
