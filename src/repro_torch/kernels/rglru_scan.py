"""RG-LRU linear recurrence: the CUDA kernel's wrapper and its plain PyTorch
version.

Port of ``repro/kernels/rglru_scan.py::rglru_scan`` (a Pallas TPU kernel) to
a hand-written CUDA kernel for Hopper, ``csrc/rglru_scan.cu``. Per channel,
from h = 0:

    h_t = exp(log_a_t) · h_{t-1} + b_t

log_a and b are ``(B, T, W)`` float32; returns every h as y ``(B, T, W)``
and the last as h_last ``(B, W)``, both float32. Unlike the TPU kernel,
which asserts ``T % min(chunk, T) == 0``, both versions take any T; the
kernel splits time into chunks of its own choosing, so ``chunk`` and
``block_w`` are accepted for the reference's signature and ignored.

``rglru_scan_plain`` is the plain version: the recurrence as a log-depth
scan, the algorithm of the JAX package's oracle (``repro/models/griffin.py::
lru_scan``, an associative scan), which ``models/griffin.py::lru_scan``
calls. ``rglru_scan`` takes it only for CPU tensors. For CUDA tensors it
always launches the kernel, or raises on what the kernel does not take (a
dtype other than float32, mismatched shapes or devices).
``rglru_scan.launches`` counts kernel launches (never plain calls).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import shard_dim, along, build, on_local_shards, refuse_grad

_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def rglru_scan_plain(log_a, b):
    """The recurrence as a log-depth (Hillis-Steele) scan. Returns (y
    (B,T,W), h_last (B,W)).

    After the pass with offset d, (a_t, b_t) composes the steps (t - 2d, t];
    step (a1, b1) then step (a2, b2) is (a1 a2, a2 b1 + b2).
    """
    a = torch.exp(log_a)
    T = a.shape[1]
    d = 1
    while d < T:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_prev * a[:, d:]], dim=1)
        d *= 2
    return b, b[:, -1, :]


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("rglru_scan")
            fn = lib.rglru_scan_fwd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(log_a, b):
    if log_a.device != b.device:
        raise ValueError(f"log_a on {log_a.device}, b on {b.device}")
    if log_a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rglru_scan takes float32 log_a and b, got {log_a.dtype}, "
                        f"{b.dtype}")
    if log_a.ndim != 3 or log_a.shape != b.shape:
        raise ValueError(f"want log_a and b of one shape (B,T,W), got "
                         f"{tuple(log_a.shape)}, {tuple(b.shape)}")
    if log_a.numel() >= 2 ** 31:
        raise ValueError("rglru_scan takes fewer than 2**31 elements")


def _local_rule(ps):
    """Batch or channel shards: the recurrence is independent along both."""
    d = shard_dim(ps[0])
    if d == 0:
        return along(ps, (0, 0), (0, 0))
    if d == 2:
        return along(ps, (2, 2), (2, 1))
    return None


def rglru_scan(log_a, b, *, chunk=256, block_w=None):
    """log_a, b: (B,T,W) float32. Returns (y (B,T,W), h_last (B,W)).
    Raises where an input requires grad (``refuse_grad``). DTensor inputs
    run on their local shards (``on_local_shards``)."""
    refuse_grad("rglru_scan", log_a, b)
    out = on_local_shards(lambda *t: rglru_scan(*t, chunk=chunk, block_w=block_w),
                          (log_a, b), _local_rule, 2)
    if out is not None:
        return out
    if log_a.device.type == "cpu" and b.device.type == "cpu":
        return rglru_scan_plain(log_a, b)
    if log_a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu, got {log_a.device}")
    return _launch(log_a, b)


def _launch(log_a, b):
    """The kernel on log_a's device: checks, allocates, launches, counts;
    raises if the build or the launch fails."""
    _check(log_a, b)
    B, T, W = log_a.shape
    log_a, b = log_a.contiguous(), b.contiguous()
    y = torch.empty_like(b)
    h_last = torch.zeros((B, W), dtype=torch.float32, device=b.device)
    if y.numel() == 0:
        return y, h_last
    lib = _kernel_lib()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.rglru_scan_fwd(log_a.data_ptr(), b.data_ptr(), y.data_ptr(),
                                 h_last.data_ptr(), B, T, W, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err} "
                           f"(B={B}, T={T}, W={W})")
    with _count_lock:
        rglru_scan.launches += 1
    return y, h_last


rglru_scan.launches = 0
