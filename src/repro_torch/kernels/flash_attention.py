"""Flash attention: the CUDA kernel's wrapper and its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py::flash_attention`` (a Pallas TPU
kernel) to a hand-written CUDA kernel for Hopper,
``csrc/flash_attention.cu``. Both compute softmax(QKᵀ·scale + mask)·V with
positions aligned at 0, causal and/or sliding-window masks, and GQA (query
head h reads kv head h // (H/K)). Layout is the JAX package's: q
``(B, T, H, d)``, k/v ``(B, S, K, d)``, out ``(B, T, H, d)`` in q's dtype.
bfloat16 runs its products on the tensor cores (``wgmma`` with TMA-fed K/V
for d in {64, 128, 256}, ``csrc/flash_attention.cu``; ``mma.sync`` for every
other multiple of 16 up to 256, ``csrc/flash_attention_mma.cu``; f32
accumulate); float32 keeps them in f32 on the CUDA cores
(``csrc/flash_attention_f32.cu``, every such d).

A block of the wgmma kernel is one q tile (64 rows of one head) against
the kv tiles it reaches, longest q tiles first. ``plan_tiles`` lists them
in the kernel's order and ``flash_attention_tiles`` is the kernel's
arithmetic in plain PyTorch (the CPU tests hold both to the reference).

``flash_attention`` takes the plain version only for CPU tensors. For CUDA
tensors it always launches the kernel, or raises on what the kernel does
not take (dtype other than float32/bfloat16, a head_dim that is not a
multiple of 16 up to 256, non-contiguous or unaligned input). Unlike the TPU
kernel it takes any T and S: ragged tiles are masked inside the kernel.

``flash_attention.launches`` counts kernel launches (never plain calls).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, refuse_grad

NEG_INF = -1e30
HEAD_DIMS = tuple(range(16, 257, 16))  # every d the kernels take
WGMMA_HEAD_DIMS = (64, 128, 256)  # bf16 head dims of the wgmma kernel
TILE = 64  # query rows per q tile, keys per kv tile
GRID_MAX = 65535  # the kernels' batch and q-tile grid axes
_DTYPES = (torch.float32, torch.bfloat16)

_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict = {}  # source name -> ctypes library


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


def kv_tiles(qt, T, S, causal, window):
    """Reachable kv tiles ``[lo, hi]`` of q tile ``qt`` (``hi < lo``: none)."""
    q0 = qt * TILE
    k_hi = min(S - 1, min(q0 + TILE, T) - 1) if causal else S - 1
    k_lo = max(0, q0 - window + 1) if window is not None else 0
    lo = k_lo // TILE
    return lo, (k_hi // TILE if k_lo <= k_hi else lo - 1)


def plan_tiles(T, S, causal, window):
    """The wgmma kernel's blocks of one head in launch order: q tiles from
    the last (most kv tiles under a causal mask) down, each as (q tile,
    first kv tile, one past its last); a q tile with no reachable key has
    none."""
    out = []
    for qt in range((T + TILE - 1) // TILE - 1, -1, -1):
        lo, hi = kv_tiles(qt, T, S, causal, window)
        out.append((qt, lo, max(lo, hi + 1)))
    return out


def flash_attention_tiles(q, k, v, *, causal=True, window=None, scale=None):
    """The wgmma kernel's arithmetic in plain PyTorch: each q tile of
    ``plan_tiles`` runs the online softmax over its kv tiles in base 2 (p
    rounded to v's dtype before PV, f32 accumulators) and writes
    acc / max(l, 1e-30). Fully masked rows give 0 here, as in the kernel
    (not the mean of V, as in ``flash_attention_plain``)."""
    B, T, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else d ** -0.5
    log2e = 1.4426950408889634
    f32 = torch.float32
    kx = k.repeat_interleave(G, dim=2)
    vx = v.repeat_interleave(G, dim=2)
    out = torch.zeros(B, T, H, d, dtype=q.dtype, device=q.device)
    for qt, kt0, kt1 in plan_tiles(T, S, causal, window):
        t = torch.arange(qt * TILE, min(qt * TILE + TILE, T), device=q.device)
        m = torch.full((B, H, len(t)), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, len(t), d, dtype=f32, device=q.device)
        for kt in range(kt0, kt1):
            s = torch.arange(kt * TILE, min(kt * TILE + TILE, S), device=q.device)
            sc = torch.einsum("bthd,bshd->bhts", q[:, t].float(),
                              kx[:, s].float()) * (scale * log2e)
            ok = torch.ones(len(t), len(s), dtype=torch.bool, device=q.device)
            if causal:
                ok &= t[:, None] >= s[None, :]
            if window is not None:
                ok &= (t[:, None] - s[None, :]) < window
            sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(sc > 0.5 * NEG_INF, torch.exp2(sc - m_new[..., None]),
                            torch.zeros_like(sc))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhts,bshd->bhtd", p.to(v.dtype).float(), vx[:, s].float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, qt * TILE:qt * TILE + len(t)] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def _kernel_lib(name):
    """The library of ``csrc/<name>.cu`` (its entry point ``<name>_fwd``):
    ``flash_attention`` (wgmma), ``flash_attention_mma`` (mma.sync) or
    ``flash_attention_f32``."""
    with _lib_lock:
        lib = _libs.get(name)
        if lib is None:
            lib = build.load(name)
            fn = getattr(lib, f"{name}_fwd")
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def kernel_source(dtype, d):
    """The source whose kernel takes q/k/v of ``dtype`` at head dim d."""
    if dtype == torch.float32:
        return "flash_attention_f32"
    return "flash_attention" if d in WGMMA_HEAD_DIMS else "flash_attention_mma"


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
        raise ValueError(f"head_dim {d} is not a multiple of 16 up to 256")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention loads rows 16 bytes at a time (TMA "
                         "boxes for bf16 d >= 64): q, k, v must start 16-byte "
                         "aligned")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if B > GRID_MAX or -(-T // TILE) > GRID_MAX:
        raise ValueError(f"flash_attention takes a batch of at most {GRID_MAX} "
                         f"and at most {GRID_MAX} q tiles of {TILE} rows, got "
                         f"B={B}, T={T}")


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B,T,H,d); k/v: (B,S,K,d), H % K == 0. Returns (B,T,H,d).
    Raises where an input requires grad (``refuse_grad``)."""
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    _check(q, k, v, window)
    B, T, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S,
            H, K, d, int(bool(causal)), -1 if window is None else int(window),
            float(scale)]
    name = kernel_source(q.dtype, d)
    fn = getattr(_kernel_lib(name), f"{name}_fwd")
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype})")
    with _count_lock:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
