"""Cold-start scan: the CUDA kernel's wrapper, its plain PyTorch version and
the log-depth parallel form.

Port of ``repro/kernels/cold_scan.py::cold_scan`` (a Pallas TPU kernel) to a
hand-written CUDA kernel for Hopper, ``csrc/cold_scan.cu``. Per row (one
(seed, placement) lane of the simulator's sweep), over the requests of one
workflow node:

    last    = -inf
    mask[k] = (t0[k] - last) > keep_warm
    last    = cold_end[k] if mask[k] else warm_end[k]

Shapes: ``t0`` (T,), ``warm_end`` / ``cold_end`` (B, T), ``keep_warm`` a
Python scalar or one value per row (B,); the mask is (B, T) bool. Two departures
from the TPU kernel: ``keep_warm`` may differ per row (the port launches
once per node over all seeds x placements, and a moved step lands on a
platform with another ``keep_warm_s``), and the comparison runs in the input
dtype (float32 or float64) where the TPU kernel casts to float32.

``cold_scan`` takes ``cold_scan_plain`` only for CPU tensors. For CUDA
tensors it always launches the kernel, or raises on what the kernel does not
take (a dtype other than float32/float64, mixed dtypes or devices,
non-contiguous input). ``cold_scan.launches`` counts kernel launches (never
plain calls).

``cold_scan_parallel`` is the torch port of the JAX package's
``cold_scan_parallel``: the same mask as a Hillis-Steele scan over GF(2)
affine maps, gated on any flip bit surviving. It is a yardstick for the
kernel, not on the simulator's path.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.float64: 1}

_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def _keep_warm_rows(keep_warm, B, like):
    """``keep_warm`` as a (B,) tensor of ``like``'s dtype and device: a
    scalar is broadcast (rounded to the dtype, as a tensor-scalar
    comparison would round it); a tensor must be (B,)."""
    if isinstance(keep_warm, torch.Tensor):
        if keep_warm.device != like.device:
            raise ValueError(f"keep_warm on {keep_warm.device}, end times on "
                             f"{like.device}")
        if keep_warm.dtype != like.dtype:
            raise TypeError(f"keep_warm is {keep_warm.dtype}, end times "
                            f"{like.dtype}")
        if tuple(keep_warm.shape) != (B,):
            raise ValueError(f"keep_warm must be a scalar or ({B},), got "
                             f"{tuple(keep_warm.shape)}")
        return keep_warm.contiguous()
    return torch.full((B,), float(keep_warm), dtype=like.dtype, device=like.device)


def cold_scan_plain(t0, warm_end, cold_end, keep_warm):
    """Plain PyTorch version: the sequential recurrence of
    ``repro/kernels/ref.py::cold_scan_ref``, a loop over T on (B,) rows."""
    B, T = warm_end.shape
    kw = _keep_warm_rows(keep_warm, B, warm_end)
    last = torch.full((B,), -math.inf, dtype=warm_end.dtype, device=warm_end.device)
    mask = torch.empty((B, T), dtype=torch.bool, device=warm_end.device)
    for k in range(T):
        m = (t0[k] - last) > kw
        last = torch.where(m, cold_end[:, k], warm_end[:, k])
        mask[:, k] = m
    return mask


def cold_scan_parallel(t0, warm_end, cold_end, keep_warm):
    """The same mask as a log-depth scan along the last axis. ``t0``,
    ``warm_end`` and ``cold_end`` broadcast against each other;
    ``keep_warm`` is a scalar or one value per row (the leading shape).

    Request k is cold whatever came before iff even the late previous end
    (cold) left a gap past keep_warm, warm whatever came before iff even the
    early one (warm) did not, and otherwise flips the previous status: each
    case is ``s = a ^ (b & s_prev)``, affine over GF(2) and so associative
    under composition. The doubling stops once no flip bit survives."""
    t0, warm_end, cold_end = torch.broadcast_tensors(t0, warm_end, cold_end)
    kw = torch.as_tensor(keep_warm, dtype=warm_end.dtype, device=warm_end.device)
    if kw.ndim:
        kw = kw[..., None]
    warm_gap = (t0[..., 1:] - warm_end[..., :-1]) > kw
    cold_gap = (t0[..., 1:] - cold_end[..., :-1]) > kw
    # request 0 measures against last = -inf: cold unless keep_warm is inf
    first = torch.broadcast_to(kw < math.inf, t0[..., :1].shape)
    a = torch.cat([first, warm_gap], dim=-1)
    b = torch.cat([torch.zeros_like(first), warm_gap & ~cold_gap], dim=-1)
    n = a.shape[-1]
    d = 1
    while d < n and bool(b.any()):
        # compose each element with the map d steps back (elements with no
        # predecessor that far compose with the identity (0, 0))
        a_s = torch.zeros_like(a)
        b_s = torch.zeros_like(b)
        a_s[..., d:] = a[..., :-d]
        b_s[..., d:] = b[..., :-d]
        a = a ^ (b & a_s)
        b = b & b_s
        d *= 2
    return a


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("cold_scan")
            fn = lib.cold_scan_fwd
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(t0, warm_end, cold_end):
    if not (t0.device == warm_end.device == cold_end.device):
        raise ValueError(f"t0, warm_end, cold_end on different devices: "
                         f"{t0.device}, {warm_end.device}, {cold_end.device}")
    if warm_end.dtype not in _DTYPES or not (
            t0.dtype == warm_end.dtype == cold_end.dtype):
        raise TypeError(f"cold_scan takes float32 or float64 inputs of one dtype, "
                        f"got {t0.dtype}, {warm_end.dtype}, {cold_end.dtype}")
    if warm_end.ndim != 2 or cold_end.shape != warm_end.shape or tuple(
            t0.shape) != (warm_end.shape[1],):
        raise ValueError(f"want t0 (T,), warm_end/cold_end (B, T); got "
                         f"{tuple(t0.shape)}, {tuple(warm_end.shape)}, "
                         f"{tuple(cold_end.shape)}")
    if not (t0.is_contiguous() and warm_end.is_contiguous()
            and cold_end.is_contiguous()):
        raise ValueError("cold_scan takes contiguous t0, warm_end, cold_end")
    if max(warm_end.shape) >= 2 ** 31:
        raise ValueError(f"cold_scan takes B, T < 2**31, got {tuple(warm_end.shape)}")


def cold_scan(t0, warm_end, cold_end, keep_warm):
    """t0: (T,); warm_end/cold_end: (B, T); keep_warm: scalar or (B,).
    Returns the (B, T) bool cold mask."""
    tensors = (t0, warm_end, cold_end)
    if all(t.device.type == "cpu" for t in tensors):
        return cold_scan_plain(t0, warm_end, cold_end, keep_warm)
    if warm_end.device.type != "cuda":
        raise ValueError(f"cold_scan runs on cuda or cpu, got {warm_end.device}")
    _check(t0, warm_end, cold_end)
    B, T = warm_end.shape
    kw = _keep_warm_rows(keep_warm, B, warm_end)
    mask = torch.empty((B, T), dtype=torch.bool, device=warm_end.device)
    if B == 0 or T == 0:
        return mask
    lib = _kernel_lib()
    with torch.cuda.device(warm_end.device):
        stream = torch.cuda.current_stream(warm_end.device).cuda_stream
        err = lib.cold_scan_fwd(
            t0.data_ptr(), warm_end.data_ptr(), cold_end.data_ptr(),
            kw.data_ptr(), mask.data_ptr(), B, T, _DTYPES[warm_end.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"cold_scan kernel launch failed: CUDA error {err} "
                           f"(B={B}, T={T}, {warm_end.dtype})")
    with _count_lock:
        cold_scan.launches += 1
    return mask


cold_scan.launches = 0
