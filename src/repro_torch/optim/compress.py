"""int8 error-feedback gradient compression (port of
``repro/optim/compress.py``).

Gradients are quantized to int8 with a symmetric per-tensor scale, and the
quantization residual is carried into the next step's gradient (ERROR
FEEDBACK), so the compression bias vanishes over steps.

``cross_pod_mean`` all-reduces the int8 payloads over the process group of
a mesh's "pod" dim (the JAX package's ``psum`` inside ``shard_map``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

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


def cross_pod_mean(grad, residual, mesh, axis_name: str = "pod"):
    """Error-feedback int8 mean of each pod's ``grad`` over the mesh dim
    ``axis_name``: (mean, new_residual), this rank's tensors.

    The int8 payloads are summed as int32 (exact for <= 2^23 pods) and
    dequantized with the largest pod scale: one all-reduce of 1/4 the f32
    bytes. This is the JAX package's arithmetic, and so is its caveat:
    each payload was quantized with its own pod's scale, so the mean is
    wrong wherever the pods' scales differ (ROADMAP, reference caveat 10).
    """
    q, scale, new_res = compress_with_feedback(grad, residual)
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    smax = scale.clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    return qsum.to(torch.float32) * smax / n, new_res


def tree_compress_stats(grads):
    """Wire bytes with and without compression (reporting)."""
    leaves = tree_leaves(grads)
    raw = sum(leaf.numel() * 4 for leaf in leaves)
    compressed = sum(leaf.numel() * 1 + 4 for leaf in leaves)
    return {"raw_bytes": raw, "int8_bytes": compressed,
            "ratio": raw / max(compressed, 1)}
