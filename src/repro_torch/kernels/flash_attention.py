"""Flash attention: the CUDA kernel's wrapper and its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py::flash_attention`` (a Pallas TPU
kernel) to a hand-written CUDA kernel for Hopper,
``csrc/flash_attention.cu``. Both compute softmax(QKᵀ·scale + mask)·V with
positions aligned at 0, causal and/or sliding-window masks, and GQA (query
head h reads kv head h // (H/K)). Layout is the JAX package's: q
``(B, T, H, d)``, k/v ``(B, S, K, d)``, out ``(B, T, H, d)`` in q's dtype.
bfloat16 runs its products on the tensor cores (``mma.sync``, f32
accumulate); float32 keeps them in f32 on the CUDA cores.

``flash_attention`` takes the plain version only for CPU tensors. For CUDA
tensors it always launches the kernel, or raises on what the kernel does
not take (dtype other than float32/bfloat16, head_dim outside
{16, 32, 64, 128, 256}, non-contiguous or unaligned input). Unlike the TPU
kernel it takes any T and S: ragged tiles are masked inside the kernel.

``flash_attention.launches`` counts kernel launches (never plain calls).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None):
    """Plain PyTorch attention: mirrors ``repro/kernels/ref.py::
    flash_attention_ref`` (f32 scores and softmax, p cast to v's dtype
    before PV)."""
    B, T, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else d ** -0.5
    qr = q.reshape(B, T, K, G, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qr, k).float() * scale
    q_pos = torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", p, v)
    return out.reshape(B, T, H, d)


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("flash_attention")
            fn = lib.flash_attention_fwd
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(q, k, v, window):
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,T,H,d), k/v (B,S,K,d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, d = q.shape
    Bk, S, K, dk = k.shape
    if Bk != B or dk != d or K == 0 or H % K or T == 0 or S == 0:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)} (need H % K == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention loads rows 16 bytes at a time: q, k, "
                         "v must start 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B,T,H,d); k/v: (B,S,K,d), H % K == 0. Returns (B,T,H,d)."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    _check(q, k, v, window)
    B, T, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    lib = _kernel_lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, S, H, K, d, int(bool(causal)),
            -1 if window is None else int(window), float(scale),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype})")
    with _count_lock:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
