"""int8 error-feedback gradient compression (port of
``repro/optim/compress.py``).

Gradients are quantized to int8 with a symmetric per-tensor scale, and the
quantization residual is carried into the next step's gradient (ERROR
FEEDBACK), so the compression bias vanishes over steps.

The JAX package's ``cross_pod_mean`` (a ``psum`` of the int8 payloads over
the "pod" axis of a mesh) is not ported: it waits for the distribution item
of the port, which brings the process groups it would reduce over.
"""
from __future__ import annotations

import torch

from repro_torch.models.tree import tree_leaves


def quantize_int8(x):
    """x: float tensor -> (int8 values, scale). Symmetric per-tensor scale."""
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_with_feedback(grad, residual):
    """Returns (int8 payload, scale, new_residual). grad+residual is what we
    try to transmit; what we couldn't express becomes the new residual."""
    target = grad.to(torch.float32) + residual
    q, scale = quantize_int8(target)
    sent = dequantize_int8(q, scale)
    return q, scale, target - sent


def tree_compress_stats(grads):
    """Wire bytes with and without compression (reporting)."""
    leaves = tree_leaves(grads)
    raw = sum(leaf.numel() * 4 for leaf in leaves)
    compressed = sum(leaf.numel() * 1 + 4 for leaf in leaves)
    return {"raw_bytes": raw, "int8_bytes": compressed,
            "ratio": raw / max(compressed, 1)}
