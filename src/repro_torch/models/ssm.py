"""Mamba-2 block: SSD (state-space duality) chunked algorithm (port of
``repro/models/ssm.py``).

Prefill uses the chunked SSD decomposition (intra-chunk quadratic term +
inter-chunk state scan, arXiv:2405.21060 §6); decode is the O(1) recurrent
update. With ``cfg.use_pallas`` prefill's scan goes to the hand-written
kernel (``repro_torch.kernels.ssd_scan``); otherwise to ``ssd_chunked``,
the plain version beside that kernel.

The dtype plan is the JAX package's. Where JAX promotes mixed bf16/f32
operands of a contraction to f32 (a remainder layer keeps its vectors in
f32, ``transformer.cast_params``), the port casts both to the promoted type
first: ``torch.einsum`` refuses mixed dtypes. Decode writes the new conv
window and state into the cache tensors it is given (slices of the stacked
cache) and returns them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import shard
from repro_torch.kernels import along, local_call, shard_dim
# ssd_chunked(x, dt, A_log, B, C, chunk) -> (y, state): the
# chunked SSD oracle is the kernel's plain version
from repro_torch.kernels.ssd_scan import local_rule as ssd_local_rule
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan import ssd_scan_plain as ssd_chunked
from repro_torch.models.layers import gated_rmsnorm, promote, rmsnorm
from repro_torch.models.params import ParamDef


def ssd_defs(cfg) -> dict:
    D = cfg.d_model
    d_inner = cfg.d_inner
    N = cfg.ssm_state
    H = cfg.ssm_heads
    conv_ch = d_inner + 2 * N  # x, B, C all pass the causal conv
    d_in_proj = 2 * d_inner + 2 * N + H
    return {
        "norm": ParamDef((D,), ("embed",), "zeros"),
        "in_proj": ParamDef((D, d_in_proj), ("embed", "inner")),
        "conv_w": ParamDef((cfg.conv_width, conv_ch), ("conv", "inner")),
        "conv_b": ParamDef((conv_ch,), ("inner",), "zeros"),
        "A_log": ParamDef((H,), (None,), "ssd_alog"),
        "D": ParamDef((H,), (None,), "ones"),
        "dt_bias": ParamDef((H,), (None,), "dt_bias"),
        "norm_y": ParamDef((d_inner,), ("inner",), "zeros"),
        "out_proj": ParamDef((d_inner, D), ("inner", "embed")),
    }


def _conv_rule(ps):
    """The depthwise conv is independent along the batch and the channels
    (x's dims 0 and 2; w's dim 1, b's dim 0 alike), not along time."""
    d = shard_dim(ps[0])
    if d == 0:
        return along(ps, (0, None, None), (0,))
    if d == 2:
        return along(ps, (2, 1, 0), (2,))
    return None


def causal_conv(x, w, b):
    """Depthwise causal conv. x: (B,L,C), w: (cw,C). Returns (B,L,C).
    DTensors run on their local shards (``_conv_rule``)."""
    return local_call(_causal_conv, (x, w, b), _conv_rule)


def _causal_conv(x, w, b):
    cw = w.shape[0]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def conv_step(x_t, conv_cache, w, b):
    """One decode step. x_t: (B,C); conv_cache: (B,cw-1,C). Returns (y, the
    new window (B,cw-1,C))."""
    window = torch.cat(promote(conv_cache, x_t[:, None, :]), dim=1)
    wd, ww = promote(window, w)
    y = torch.einsum("bwc,wc->bc", wd, ww) + b[None, :]
    return F.silu(y), window[:, 1:, :]


def ssd_step(x_t, dt_t, A_log, B_t, C_t, state):
    """O(1) decode update.
      x_t:(B,H,P) dt_t:(B,H) B_t/C_t:(B,N) state:(B,H,P,N)
    Returns (y:(B,H,P), new_state)."""
    f32 = torch.float32
    a = -torch.exp(A_log.to(f32))
    da = torch.exp(a[None, :] * dt_t.to(f32))                       # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt_t.to(f32), B_t.to(f32),
                       x_t.to(f32))
    new = state.to(f32) * da[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new, C_t.to(f32))
    return y.to(x_t.dtype), new.to(state.dtype)


def ssd_block(cfg, p, x, mode, cache=None, use_pallas=False, u=None):
    """Full mamba2 block (norm -> in_proj -> conv -> SSD -> gated norm -> out).

    cache (decode): {"conv": (B,cw-1,conv_ch), "state": (B,H,P,N)}, written
    in place. ``u``: the input norm ``rmsnorm(x, p["norm"])`` where the
    caller has taken it (with the residual add before it, in one launch).
    Returns (out, new_cache); prefill also builds the cache.
    """
    d_inner, N, H, Pp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Bb, T, D = x.shape
    if u is None:
        u = rmsnorm(x, p["norm"], use_kernel=use_pallas)
    zxbcdt = torch.einsum("btd,de->bte", *promote(u, p["in_proj"]))
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * N:]

    if mode in ("train", "prefill"):
        raw = xBC
        xBC = causal_conv(xBC, p["conv_w"], p["conv_b"])
        xs = xBC[..., :d_inner].reshape(Bb, T, H, Pp)
        Bm = xBC[..., d_inner:d_inner + N]
        Cm = xBC[..., d_inner + N:]
        dt = F.softplus(dt + p["dt_bias"][None, None, :])
        xs = shard(xs, "batch", "seq", "act_inner", None)
        # pad T to a chunk multiple; zero-dt padding is EXACT for SSD
        # (state multiplies by exp(0)=1 and accumulates dt*B*x = 0)
        Q = min(cfg.ssm_chunk, T)
        pad = (-T) % Q
        if pad:
            xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            Bm_p = F.pad(Bm, (0, 0, 0, pad))
            Cm_p = F.pad(Cm, (0, 0, 0, pad))
        else:
            xs_p, dt_p, Bm_p, Cm_p = xs, dt, Bm, Cm
        if use_pallas:
            y, state = ssd_scan(xs_p, dt_p, p["A_log"], Bm_p, Cm_p, Q)
        else:  # DTensors: on the local shards, as the kernel's wrapper runs
            y, state = local_call(lambda *t: ssd_chunked(*t, Q),
                                  (xs_p, dt_p, p["A_log"], Bm_p, Cm_p),
                                  ssd_local_rule, 2)
        if pad:
            y = y[:, :T]
        y = y + xs * p["D"][None, None, :, None]
        new_cache = None
        if mode == "prefill":
            # conv tail for continuing decode: the PRE-conv projection
            tail = raw[:, -(cfg.conv_width - 1):, :].contiguous()
            new_cache = {"conv": tail, "state": state}
    else:  # decode, T == 1
        xBC_t = xBC[:, 0, :]
        xc, window = conv_step(xBC_t, cache["conv"], p["conv_w"], p["conv_b"])
        xs = xc[:, :d_inner].reshape(Bb, H, Pp)
        Bm = xc[:, d_inner:d_inner + N]
        Cm = xc[:, d_inner + N:]
        dt_t = F.softplus(dt[:, 0, :] + p["dt_bias"][None, :])
        y, state = ssd_step(xs, dt_t, p["A_log"], Bm, Cm, cache["state"])
        y = (y + xs * p["D"][None, :, None])[:, None]          # (B,1,H,P)
        cache["conv"].copy_(window)
        cache["state"].copy_(state)
        new_cache = cache

    y = y.reshape(Bb, T, d_inner)
    y = gated_rmsnorm(y, z, p["norm_y"], use_kernel=use_pallas)
    out = torch.einsum("bte,ed->btd", *promote(y, p["out_proj"]))
    return shard(out, "batch", "seq", "act_embed"), new_cache


def ssd_cache_specs(cfg, batch):
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": (batch, cfg.conv_width - 1, conv_ch),
        "state": (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
    }
