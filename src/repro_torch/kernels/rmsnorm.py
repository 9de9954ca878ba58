"""RMSNorm: the CUDA kernel's wrapper and its plain PyTorch version.

Port of ``repro/kernels/rmsnorm.py::rmsnorm`` (a Pallas TPU kernel) to a
hand-written CUDA kernel for Hopper, ``csrc/rmsnorm.cu``. Both compute, per
row of the last axis with float32 statistics,

    x · rsqrt(mean(x²) + eps) · (1 + w)

cast once to x's dtype (``repro/kernels/ref.py::rmsnorm_ref``). x has any
leading shape; x and w are each float32 or bfloat16.

``rmsnorm_plain`` is the plain version; ``models/layers.py::rmsnorm`` calls
it on the plain path. ``rmsnorm`` takes it only for CPU tensors. For CUDA
tensors it always launches the kernel, or raises on what the kernel does not
take (another dtype, a w that is not ``(D,)``, D above 16384).
``rmsnorm.launches`` counts kernel launches (never plain calls).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

MAX_D = 16384  # 1024 threads a row, 16 elements a thread in registers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def rmsnorm_plain(x, w, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("rmsnorm")
            fn = lib.rmsnorm_fwd
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(x, w):
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm takes float32 or bfloat16 x and w, got "
                        f"{x.dtype}, {w.dtype}")
    if x.ndim == 0 or tuple(w.shape) != (x.shape[-1],):
        raise ValueError(f"want x (..., D) and w (D,), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.shape[-1] > MAX_D:
        raise ValueError(f"rmsnorm takes rows of at most {MAX_D}, got {x.shape[-1]}")
    if x.numel() // max(1, x.shape[-1]) >= 2 ** 31:
        raise ValueError("rmsnorm takes fewer than 2**31 rows")


def rmsnorm(x, w, eps=1e-6):
    """x: (..., D); w: (D,). Returns x's shape and dtype."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu, got {x.device}")
    return _launch(x, w, eps)


def _launch(x, w, eps=1e-6):
    """The kernel on x's device: checks, allocates, launches, counts; raises
    if the build or the launch fails."""
    _check(x, w)
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, D,
                              _DTYPES[x.dtype], _DTYPES[w.dtype], float(eps),
                              stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)} {x.dtype}, w {w.dtype})")
    with _count_lock:
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
