"""Transformer building blocks (port of ``repro/models/layers.py``, dense
attention path): RMSNorm, RoPE, GQA attention (global / sliding-window,
qk-norm, ring-buffer decode caches) and the gated MLP.

Blocks run in three modes:
  train   — full sequence, no cache
  prefill — full sequence, returns the KV cache
  decode  — T=1 step against a cache (full-length or ring buffer)

The dtype plan is the JAX package's: rmsnorm and rope in f32 and cast back,
attention scores and softmax in f32 with p cast to v's dtype before PV,
masks at -1e30. Prefill attention with ``cfg.use_pallas`` goes to the
hand-written kernel (``repro_torch.kernels.flash_attention``); decode keeps
``_sdpa``, as the JAX package does. MoE is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import shard
from repro_torch.kernels.flash_attention import flash_attention
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


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


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
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
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


def ffn_defs(cfg) -> dict:
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    return mlp_defs(cfg)


def ffn(cfg, p, x):
    """Returns (out, aux_loss)."""
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    return mlp(cfg, p, x), 0.0
