"""RecurrentGemma / Griffin temporal-mixing block: RG-LRU linear recurrence
(port of ``repro/models/griffin.py``).

Block layout (arXiv:2402.19427): two parallel branches off the input —
  gate branch: linear -> GeLU (tanh approximation, JAX's default)
  lru branch:  linear -> causal conv1d -> RG-LRU
merged multiplicatively, then projected back to d_model.

RG-LRU recurrence (per channel, diagonal):
  r_t = sigmoid(W_a x_t)            recurrence gate
  i_t = sigmoid(W_x x_t)            input gate
  a_t = exp(-c * softplus(Lambda) * r_t)   with c = 8
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill evaluates the recurrence with ``lru_scan`` (a log-depth doubling
scan, the kernel's plain version, where the JAX package uses
``jax.lax.associative_scan``) or, with
``cfg.use_pallas``, the hand-written kernel
(``repro_torch.kernels.rglru_scan``, which takes any T where the TPU kernel
asserts a chunk multiple). Decode is the O(1) update, written into the
cache tensors it is given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import shard
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
from repro_torch.models.layers import promote
from repro_torch.models.params import ParamDef
from repro_torch.models.ssm import causal_conv, conv_step

RG_LRU_C = 8.0


def rglru_defs(cfg) -> dict:
    D, W = cfg.d_model, (cfg.lru_width or cfg.d_model)
    return {
        "in_x": ParamDef((D, W), ("embed", "lru")),
        "in_gate": ParamDef((D, W), ("embed", "lru")),
        "conv_w": ParamDef((cfg.conv_width, W), ("conv", "lru")),
        "conv_b": ParamDef((W,), ("lru",), "zeros"),
        "w_a": ParamDef((W, W), ("lru", None)),
        "b_a": ParamDef((W,), (None,), "zeros"),
        "w_i": ParamDef((W, W), ("lru", None)),
        "b_i": ParamDef((W,), (None,), "zeros"),
        "lam": ParamDef((W,), (None,), "lru_lambda"),
        "out": ParamDef((W, D), ("lru", "embed")),
    }


def _gates(p, x):
    """x: (..., W) -> (log_a, gated_input) both (..., W), float32."""
    f32 = torch.float32
    xf = x.to(f32)
    r = torch.sigmoid(torch.einsum("...w,wv->...v", xf, p["w_a"].to(f32))
                      + p["b_a"].to(f32))
    i = torch.sigmoid(torch.einsum("...w,wv->...v", xf, p["w_i"].to(f32))
                      + p["b_i"].to(f32))
    log_a = -RG_LRU_C * F.softplus(p["lam"].to(f32)) * r
    gated = i * xf
    return log_a, gated


def lru_scan(log_a, b):
    """Linear recurrence h_t = a_t h_{t-1} + b_t from h = 0 (the plain
    version of the kernel, a log-depth scan).

    log_a, b: (B, T, W) float32. Returns (y, h_final): y (B,T,W) = all h_t;
    h_final (B,W).
    """
    return rglru_scan_plain(log_a, b)


def lru_step(log_a_t, b_t, h):
    """One decode step: (B,W) each. Returns (y, new_h)."""
    a = torch.exp(log_a_t)
    new = a * h + b_t
    return new, new


def rglru_block(cfg, p, x, mode, cache=None, use_pallas=False):
    """Temporal-mixing half of a griffin layer. x: (B,T,D) (pre-normed).

    cache (decode): {"conv": (B, cw-1, W), "h": (B, W)}, written in place.
    Returns (out (B,T,D), new_cache); prefill also builds the cache.
    """
    B, T, D = x.shape
    gate = F.gelu(torch.einsum("btd,dw->btw", *promote(x, p["in_gate"])),
                  approximate="tanh")
    xb = torch.einsum("btd,dw->btw", *promote(x, p["in_x"]))
    xb = shard(xb, "batch", "seq", "act_inner")

    if mode in ("train", "prefill"):
        xc = causal_conv(xb, p["conv_w"], p["conv_b"])
        log_a, gated = _gates(p, xc)
        beta = torch.sqrt(-torch.expm1(2.0 * log_a))    # sqrt(1 - a^2), stable
        b = beta * gated
        if use_pallas:
            y, h_last = rglru_scan(log_a, b)
        else:
            y, h_last = lru_scan(log_a, b)
        new_cache = None
        if mode == "prefill":
            tail = xb[:, -(cfg.conv_width - 1):, :]
            new_cache = {"conv": tail.to(x.dtype).contiguous(), "h": h_last}
    else:  # decode, T == 1
        xb_t = xb[:, 0, :]
        xc_t, window = conv_step(xb_t, cache["conv"], p["conv_w"], p["conv_b"])
        log_a, gated = _gates(p, xc_t)
        beta = torch.sqrt(-torch.expm1(2.0 * log_a))
        y_t, h_new = lru_step(log_a, beta * gated, cache["h"].to(torch.float32))
        y = y_t[:, None, :]
        cache["conv"].copy_(window)
        cache["h"].copy_(h_new)
        new_cache = cache

    y = y.to(x.dtype) * gate
    out = torch.einsum("btw,wd->btd", *promote(y, p["out"]))
    return shard(out, "batch", "seq", "act_embed"), new_cache


def rglru_cache_specs(cfg, batch):
    W = cfg.lru_width or cfg.d_model
    return {"conv": (batch, cfg.conv_width - 1, W), "h": (batch, W)}
