"""Rotary position embedding of q and k: the CUDA kernel's wrapper and its
plain PyTorch version.

The kernel, ``csrc/rope.cu``, replaces no Pallas kernel: the JAX package's
rope is plain jnp that XLA fuses into the attention sublayer. Run eagerly,
the same function is ~17 launches a tensor (the angle table built again,
the halves split, multiplied, added and joined), twice a layer, and its
copy of theta from pageable host memory waits for the stream to drain.
``rope_qk`` rotates q and k in one launch a layer that copies nothing to
the card: theta is a kernel argument.

Both versions compute, per position p and pair index i < d/2, in float32
and in this order (what eager ops on the card round, op by op):

    freq = theta ** (-i * (1 / (d/2)))     ang = p * freq
    out[i]       = x[i] * cos(ang) - x[i + d/2] * sin(ang)
    out[i + d/2] = x[i + d/2] * cos(ang) + x[i] * sin(ang)

cast once to x's dtype. q is ``(B, T, H, d)`` and k ``(B, T, K, d)``, both
float32 or both bfloat16; positions ``(T,)`` or ``(B, T)``, int32 or int64;
d even, up to 256.

``rope_qk`` takes the plain version only for CPU tensors. For CUDA tensors
it launches the kernel once, or raises on what the kernel does not take; it
never falls back. ``rope_qk.launches`` counts the kernel's launches (never
plain calls).
"""
from __future__ import annotations

import ctypes
import threading
import time

import torch

from repro_torch.kernels import along, build, on_local_shards, refuse_grad, shard_dim

MAX_D = 256  # the kernel's angle table: d/2 floats a position
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POS_DTYPES = {torch.int32: 0, torch.int64: 1}

_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def rope_plain(x, positions, theta, host=None):
    """x: (..., T, n, d) rotated pairwise; positions: (..., T). The model's
    plain path (``layers.rope``): ~17 eager launches, one of them a copy
    of ``theta`` to the card from pageable host memory, which waits for
    the stream to drain. ``host``: an open ``dispatch`` span
    (``spanhook``), whose ``sync_s`` gets the host seconds of that copy.
    With ``cfg.use_pallas`` the model calls ``rope_qk`` instead."""
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    t0 = time.perf_counter() if host is not None else 0.0
    base = torch.tensor(theta, dtype=torch.float32, device=x.device)
    if host is not None:
        host.attrs["sync_s"] += time.perf_counter() - t0
    freq = torch.pow(base, exponent)
    ang = positions[..., None].float() * freq  # (..., T, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_qk_plain(q, k, positions, theta):
    return rope_plain(q, positions, theta), rope_plain(k, positions, theta)


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("rope")
            fn = lib.rope_qk_fwd
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(q, k, positions):
    if k.device != q.device or positions.device != q.device:
        raise ValueError(f"operands on {q.device}, {k.device}, {positions.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise TypeError(f"rope_qk takes q and k both float32 or both bfloat16, "
                        f"got {q.dtype}, {k.dtype}")
    if positions.dtype not in _POS_DTYPES:
        raise TypeError(f"rope_qk takes int32 or int64 positions, got "
                        f"{positions.dtype}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"want q (B, T, H, d) and k (B, T, K, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, T, _, d = q.shape
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != d:
        raise ValueError(f"q and k differ in batch, length or head dim: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if d % 2 or d > MAX_D:
        raise ValueError(f"rope_qk takes an even head dim up to {MAX_D}, got {d}")
    if positions.shape not in ((T,), (B, T)):
        raise ValueError(f"want positions ({T},) or ({B}, {T}), got "
                         f"{tuple(positions.shape)}")
    if B * T >= 2 ** 31:
        raise ValueError("rope_qk takes fewer than 2**31 positions")


def _rule(pos_ndim):
    """Local shards (``on_local_shards``) of a batch split, or of a head
    split where q and k split their heads alike; a sequence split raises."""
    def rule(ps):
        dq, dk, dp = (shard_dim(p) for p in ps)
        if 1 in (dq, dk) or dp == pos_ndim - 1:
            raise ValueError("rope_qk runs on batch or head shards, not on a "
                             "sequence split")
        if dq == 0:
            return along(ps, (0, 0, 0 if pos_ndim == 2 else None), (0, 0))
        if dq == 2 and dk == 2:
            return along(ps, (2, 2, None), (2, 2))
        return None
    return rule


def rope_qk(q, k, positions, theta):
    """q: (B, T, H, d); k: (B, T, K, d); positions: (T,) or (B, T). Returns
    (q rotated, k rotated) in q's shape and dtype, from one launch on CUDA
    tensors. Raises where an input requires grad (``refuse_grad``). DTensor
    inputs run on their local shards (``_rule``)."""
    refuse_grad("rope_qk", q, k)
    out = on_local_shards(lambda *t: rope_qk(*t, theta), (q, k, positions),
                          _rule(positions.ndim), 2)
    if out is not None:
        return out
    if q.is_cuda:
        return _launch(q, k, positions, theta)
    if all(t.device.type == "cpu" for t in (q, k, positions)):
        return rope_qk_plain(q, k, positions, theta)
    raise ValueError(f"rope_qk runs on cuda or cpu, got {q.device}")


def _launch(q, k, positions, theta):
    """The kernel on q's device: checks, allocates, launches, counts; raises
    if the build or the launch fails."""
    _check(q, k, positions)
    q, k, positions = q.contiguous(), k.contiguous(), positions.contiguous()
    B, T, H, d = q.shape
    K = k.shape[2]
    qo, ko = torch.empty_like(q), torch.empty_like(k)
    if B * T == 0 or d == 0:
        return qo, ko
    lib = _lib or _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rope_qk_fwd(q.data_ptr(), k.data_ptr(), qo.data_ptr(), ko.data_ptr(),
                              positions.data_ptr(), B, T, H, K, d, _DTYPES[q.dtype],
                              _POS_DTYPES[positions.dtype], int(positions.ndim == 2),
                              float(theta), stream)
    if err != 0:
        raise RuntimeError(f"rope_qk kernel launch failed: CUDA error {err} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)} {q.dtype})")
    with _count_lock:
        rope_qk.launches += 1
    return qo, ko


rope_qk.launches = 0
