"""RMSNorm: the CUDA kernel's wrappers and their plain PyTorch versions.

Port of ``repro/kernels/rmsnorm.py::rmsnorm`` (a Pallas TPU kernel) to a
hand-written CUDA kernel for Hopper, ``csrc/rmsnorm.cu``. Both compute, per
row of the last axis with float32 statistics,

    x · rsqrt(mean(x²) + eps) · (1 + w)

cast once to x's dtype (``repro/kernels/ref.py::rmsnorm_ref``). x has any
leading shape; x and w are each float32 or bfloat16.

The kernel also takes what comes before a norm on the served path, in the
same launch:

  ``add_rmsnorm(x, h, w)``   -> ``(s, rmsnorm(s, w))`` with ``s = x + h``
      (the residual add before a block's norms and the final norm); s is
      rounded as the eager add rounds it, and the norm is taken of the
      rounded s.
  ``gated_rmsnorm(y, z, w)`` -> ``rmsnorm(y * silu(z), w)`` (mamba2's
      ``norm_y``), silu(z) rounded to z's dtype and the product to the
      promoted dtype, as eager ops round them.

Each ``*_plain`` function is the unfused composition of eager ops, which
the wrappers run for CPU tensors. For CUDA tensors each wrapper launches
the kernel once, or raises on what the kernel does not take (another
dtype, a w that is not ``(D,)``, D above 16384, operands of other shapes).
It never falls back. ``rmsnorm.launches`` counts the kernel launches of all
three (never plain calls).
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import shard_dim, along, build, on_local_shards, refuse_grad

MAX_D = 16384  # 512 threads a row, 32 elements a thread in registers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NONE, _ADD, _GATE = 0, 1, 2  # the kernel's prologues

_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def rmsnorm_plain(x, w, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


def add_rmsnorm_plain(x, h, w, eps=1e-6):
    s = x + h
    return s, rmsnorm_plain(s, w, eps)


def gated_rmsnorm_plain(y, z, w, eps=1e-6):
    return rmsnorm_plain(y * F.silu(z), w, eps)


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("rmsnorm")
            fn = lib.rmsnorm_fwd
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                           + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(x, w, h=None):
    dev = x.device
    if w.device != dev or (h is not None and h.device != dev):
        raise ValueError(f"operands on {dev}, {w.device}"
                         f"{'' if h is None else f', {h.device}'}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES or (
            h is not None and h.dtype not in _DTYPES):
        raise TypeError(f"rmsnorm takes float32 or bfloat16 operands, got "
                        f"{x.dtype}, {w.dtype}{'' if h is None else f', {h.dtype}'}")
    if x.ndim == 0 or w.ndim != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"want x (..., D) and w (D,), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if h is not None and h.shape != x.shape:
        raise ValueError(f"the prologue's operands differ in shape: "
                         f"{tuple(x.shape)}, {tuple(h.shape)}")
    if x.shape[-1] > MAX_D:
        raise ValueError(f"rmsnorm takes rows of at most {MAX_D}, got {x.shape[-1]}")
    if x.numel() // max(1, x.shape[-1]) >= 2 ** 31:
        raise ValueError("rmsnorm takes fewer than 2**31 rows")


def _rows(t):
    """(t as rows of its last dim, the row stride in elements): t itself
    where contiguous; a view where its leading dims collapse to one stride
    (a column slice of a wider projection does); else a contiguous copy."""
    D = t.shape[-1]
    if t.is_contiguous():
        return t, D
    if t.stride(-1) == 1:
        try:
            v = t.view(-1, D)
            return v, v.stride(0)
        except RuntimeError:
            pass
    return t.contiguous(), D


def _local(fn, tensors, n_out):
    """``fn`` on local row shards where x is a DTensor (``on_local_shards``):
    a shard of the last dim, whose statistics span every rank, is
    replicated first."""
    x = tensors[0]
    last = x.ndim - 1

    def rule(ps):
        d = shard_dim(ps[0])
        if d is None or d == last:
            return None
        return along(ps, (d,) * (len(ps) - 1) + (None,), (d,) * n_out)
    return on_local_shards(fn, tensors, rule, n_out)


def rmsnorm(x, w, eps=1e-6):
    """x: (..., D); w: (D,). Returns x's shape and dtype. Raises where an
    input requires grad (``refuse_grad``), as do the two below. DTensor
    inputs run on their local row shards (``_local``), in all three."""
    refuse_grad("rmsnorm", x, w)
    out = _local(lambda *t: rmsnorm(*t, eps), (x, w), 1)
    if out is not None:
        return out
    if x.is_cuda:
        return _launch(x, w, eps)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    raise ValueError(f"rmsnorm runs on cuda or cpu, got {x.device}")


def add_rmsnorm(x, h, w, eps=1e-6):
    """x, h: (..., D); w: (D,). Returns ``(x + h, rmsnorm(x + h, w))``, both
    in the dtype of ``x + h``, from one launch on CUDA tensors."""
    refuse_grad("add_rmsnorm", x, h, w)
    out = _local(lambda *t: add_rmsnorm(*t, eps), (x, h, w), 2)
    if out is not None:
        return out
    if x.is_cuda:
        return _launch(x, w, eps, h, _ADD)
    if x.device.type == "cpu" and h.device.type == "cpu" and w.device.type == "cpu":
        return add_rmsnorm_plain(x, h, w, eps)
    raise ValueError(f"add_rmsnorm runs on cuda or cpu, got {x.device}")


def gated_rmsnorm(y, z, w, eps=1e-6):
    """y, z: (..., D); w: (D,). Returns ``rmsnorm(y * silu(z), w)`` in the
    dtype of ``y * silu(z)``, from one launch on CUDA tensors."""
    refuse_grad("gated_rmsnorm", y, z, w)
    out = _local(lambda *t: gated_rmsnorm(*t, eps), (y, z, w), 1)
    if out is not None:
        return out
    if y.is_cuda:
        return _launch(y, w, eps, z, _GATE)
    if y.device.type == "cpu" and z.device.type == "cpu" and w.device.type == "cpu":
        return gated_rmsnorm_plain(y, z, w, eps)
    raise ValueError(f"gated_rmsnorm runs on cuda or cpu, got {y.device}")


def _launch(x, w, eps=1e-6, h=None, prologue=_NONE):
    """The kernel on x's device with the given prologue (h its second
    operand): checks, allocates, launches, counts; raises if the build or
    the launch fails. Returns the norm, or (s, norm) for the add."""
    _check(x, w, h)
    hd = x.dtype if h is None else h.dtype
    if hd == x.dtype and x.is_contiguous():
        y = torch.empty_like(x)
    else:  # promote(f32, bf16) is f32
        y = torch.empty_like(x, dtype=x.dtype if hd == x.dtype else torch.float32,
                             memory_format=torch.contiguous_format)
    s = torch.empty_like(y) if prologue == _ADD else None
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y if s is None else (s, y)
    xr, ldx = _rows(x)
    hr, ldh = (xr, ldx) if h is None else _rows(h)
    if not w.is_contiguous():
        w = w.contiguous()
    lib = _lib or _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_fwd(xr.data_ptr(), hr.data_ptr(), w.data_ptr(),
                              0 if s is None else s.data_ptr(), y.data_ptr(),
                              rows, D, ldx, ldh, _DTYPES[x.dtype], _DTYPES[hd],
                              _DTYPES[w.dtype], prologue, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)} {x.dtype}, w {w.dtype}, "
                           f"prologue {prologue})")
    with _count_lock:
        rmsnorm.launches += 1
    return y if s is None else (s, y)


rmsnorm.launches = 0
