"""Mamba-2 SSD chunk scan: the CUDA kernel's wrapper and its plain PyTorch
version.

Port of ``repro/kernels/ssd_scan.py::ssd_scan`` (a Pallas TPU kernel) to a
hand-written CUDA kernel for Hopper, ``csrc/ssd_scan.cu``. Shapes are the
JAX package's: x ``(B, L, H, P)``, dt ``(B, L, H)``, A_log ``(H,)``, B and C
``(B, L, N)``, ``L % min(chunk, L) == 0``; returns y ``(B, L, H, P)`` in x's
dtype and the final state ``(B, H, P, N)`` in float32. Per chunk of Q
positions, with ``cum`` the running sum of ``dt·(-exp(A_log))``:

    y_t = Σ_{s≤t} (C_t·B_s) exp(cum_t − cum_s) dt_s x_s + exp(cum_t) C_t·h
    h  <- h exp(cum_Q) + Σ_s exp(cum_Q − cum_s) dt_s B_s x_s

``ssd_scan_plain`` is the plain version: the chunked algorithm of
``repro/models/ssm.py::ssd_chunked`` (which ``models/ssm.py`` re-exports),
all in float32 and cast to x's dtype at the end.

The kernel runs in two passes: C·Bᵀ once per (batch, chunk) into a scratch
of ``cb_scratch_shape`` floats (only the 64 x 64 tiles of the causal half
are written), then the scan, which reads those tiles for every head.
``ssd_cb_plain`` and ``ssd_scan_from_cb`` are the two passes in plain
PyTorch, tile for tile, so the CPU tests can hold the decomposition to the
reference.

``ssd_scan`` takes the plain version only for CPU tensors. For CUDA tensors
it always launches the kernel, or raises on what the kernel does not take
(x, B, C of different dtypes or not float32/bfloat16, N or P not a
multiple of 16 bytes' worth of elements, unaligned rows, L not a multiple
of the chunk). dt and A_log are cast to float32 before
the launch; from bfloat16 that is exact, and the plain version computes in
float32 too. ``block_h`` is accepted for the reference's signature and
ignored. ``ssd_scan.launches`` counts wrapper calls that launched the
kernels (both passes; never plain calls).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import shard_dim, along, build, on_local_shards, refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # rows t and columns s of a C·Bᵀ tile

_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def ssd_scan_plain(x, dt, A_log, B_mat, C_mat, chunk):
    """Chunked SSD in plain PyTorch (the oracle), from a zero state.
    Returns (y, final_state)."""
    Bb, L, H, Pp = x.shape
    N = B_mat.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"L={L} is not a multiple of the chunk {Q}")
    nc = L // Q
    f32 = torch.float32

    a = -torch.exp(A_log.to(f32))                           # (H,)
    dA = a[None, None, :] * dt.to(f32)                      # (B,L,H), <= 0
    xr = x.reshape(Bb, nc, Q, H, Pp).to(f32)
    dtr = dt.reshape(Bb, nc, Q, H).to(f32)
    Br = B_mat.reshape(Bb, nc, Q, N).to(f32)
    Cr = C_mat.reshape(Bb, nc, Q, N).to(f32)
    # prefix sums accumulated in float64 and rounded once to float32 (what
    # torch's float32 cumsum does on the CPU): exp(cum_t - cum_s) turns an
    # absolute rounding error of cum (an ulp of |cum|, which reaches 1e3 and
    # more) into a relative error of the decay, so the kernel, whose scan
    # adds in another order, sums in float64 too and lands on these values
    cum = torch.cumsum(dA.reshape(Bb, nc, Q, H).double(), dim=2).to(f32)

    # intra-chunk; mask BEFORE exp (t < s differences are positive)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,Q,H) t,s
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Lmat = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                 torch.full_like(diff, -1e30)))
    CB = torch.einsum("bcqn,bcsn->bcqs", Cr, Br)
    G = CB[..., None] * Lmat * dtr[:, :, None, :, :]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", G, xr)

    # chunk states: S_c = sum_s exp(cum[-1]-cum[s]) dt_s B_s x_s
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dtr        # (B,nc,Q,H)
    S_c = torch.einsum("bcsh,bcsn,bcshp->bchpn", w_end, Br, xr)

    # inter-chunk recurrence over nc
    decay_chunk = torch.exp(cum[:, :, -1, :])               # (B,nc,H)
    h = torch.zeros((Bb, H, Pp, N), dtype=f32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * decay_chunk[:, c, :, None, None] + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                   # (B,nc,H,P,N)

    # inter-chunk contribution: C_t · (h_prev * exp(cum[t]))
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cr, h_prevs, torch.exp(cum))

    y = (y_intra + y_inter).reshape(Bb, L, H, Pp)
    return y.to(x.dtype), h


def cb_scratch_shape(Bb, L, Q):
    """(B, chunks, Qp, Qp): the C·Bᵀ scratch, Qp = Q rounded up to TILE."""
    Qp = -(-Q // TILE) * TILE
    return (Bb, L // Q, Qp, Qp)


def ssd_cb_plain(B_mat, C_mat, Q, fill=0.0):
    """Pass 1 in plain PyTorch: C_t·B_s in float32 per (batch, chunk), in the
    scratch layout. The kernel writes only the tiles of the causal half
    (s tile <= t tile); the others hold ``fill`` here."""
    Bb, L, N = B_mat.shape
    shape = cb_scratch_shape(Bb, L, Q)
    nc, Qp = shape[1], shape[2]
    cb = torch.zeros(shape, dtype=torch.float32, device=B_mat.device)
    cb[:, :, :Q, :Q] = torch.einsum(
        "bcqn,bcsn->bcqs", C_mat.reshape(Bb, nc, Q, N).float(),
        B_mat.reshape(Bb, nc, Q, N).float())
    tile = torch.arange(Qp, device=B_mat.device) // TILE
    return torch.where(tile[:, None] >= tile[None, :], cb,
                       torch.full_like(cb, fill))


def ssd_scan_from_cb(x, dt, A_log, B_mat, C_mat, cb, chunk):
    """Pass 2 in plain PyTorch, tile for tile as the kernel reads it: per
    chunk the inter-chunk term (from the second chunk on), then for each t
    tile the C·Bᵀ tiles s <= t of ``cb`` masked, decayed and scaled by dt,
    then the state update. Returns (y in x's dtype, final state f32)."""
    Bb, L, H, Pp = x.shape
    N = B_mat.shape[-1]
    Q = min(chunk, L)
    nc, nt = L // Q, -(-Q // TILE)
    f32 = torch.float32
    a = -torch.exp(A_log.to(f32))
    dtr = dt.to(f32).reshape(Bb, nc, Q, H)
    cum = torch.cumsum((a * dtr).double(), dim=2).to(f32)   # as ssd_scan_plain
    xr = x.to(f32).reshape(Bb, nc, Q, H, Pp)
    Br = B_mat.to(f32).reshape(Bb, nc, Q, N)
    Cr = C_mat.to(f32).reshape(Bb, nc, Q, N)
    h = torch.zeros((Bb, H, Pp, N), dtype=f32, device=x.device)
    y = torch.empty((Bb, nc, Q, H, Pp), dtype=f32, device=x.device)
    for c in range(nc):
        yc = torch.zeros((Bb, Q, H, Pp), dtype=f32, device=x.device)
        if c > 0:
            yc += (torch.einsum("bqn,bhpn->bqhp", Cr[:, c], h)
                   * torch.exp(cum[:, c])[..., None])
        for ti in range(nt):
            t = torch.arange(ti * TILE, min(ti * TILE + TILE, Q), device=x.device)
            for si in range(ti + 1):
                s = torch.arange(si * TILE, min(si * TILE + TILE, Q), device=x.device)
                tile = cb[:, c, t[0]:t[-1] + 1, s[0]:s[-1] + 1]     # (B, t, s)
                keep = (t[:, None] >= s[None, :])[None, :, :, None]
                diff = cum[:, c, t][:, :, None] - cum[:, c, s][:, None]
                decay = torch.exp(torch.where(keep, diff, torch.full_like(diff, -1e30)))
                G = torch.where(keep, tile[..., None] * decay * dtr[:, c, s][:, None],
                                torch.zeros_like(decay))
                yc[:, t] += torch.einsum("btsh,bshp->bthp", G, xr[:, c, s])
        w_end = torch.exp(cum[:, c, -1:] - cum[:, c]) * dtr[:, c]   # (B, Q, H)
        h = (h * torch.exp(cum[:, c, -1])[..., None, None]
             + torch.einsum("bsh,bsn,bshp->bhpn", w_end, Br[:, c], xr[:, c]))
        y[:, c] = yc
    return y.reshape(Bb, L, H, Pp).to(x.dtype), h


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("ssd_scan")
            fn = lib.ssd_scan_fwd
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(x, dt, A_log, B_mat, C_mat, Q):
    tensors = (x, dt, A_log, B_mat, C_mat)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"ssd_scan inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES or not (x.dtype == B_mat.dtype == C_mat.dtype):
        raise TypeError(f"ssd_scan takes x, B, C of one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {B_mat.dtype}, {C_mat.dtype}")
    if dt.dtype not in _DTYPES or A_log.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 dt and A_log, got "
                        f"{dt.dtype}, {A_log.dtype}")
    if x.ndim != 4:
        raise ValueError(f"want x (B,L,H,P), got {tuple(x.shape)}")
    Bb, L, H, P = x.shape
    N = B_mat.shape[-1]
    if (tuple(dt.shape) != (Bb, L, H) or tuple(A_log.shape) != (H,)
            or tuple(B_mat.shape) != (Bb, L, N) or C_mat.shape != B_mat.shape):
        raise ValueError(f"incompatible shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A_log {tuple(A_log.shape)}, B "
                         f"{tuple(B_mat.shape)}, C {tuple(C_mat.shape)}")
    per16 = 16 // x.element_size()
    if N % per16 or P % per16:
        raise ValueError(f"ssd_scan reads rows 16 bytes at a time: N={N} and "
                         f"P={P} must be multiples of {per16} in {x.dtype}")
    if Q <= 0 or L % Q:
        raise ValueError(f"L={L} is not a multiple of the chunk {Q}")
    if max(x.numel(), B_mat.numel()) >= 2 ** 31:
        raise ValueError("ssd_scan takes fewer than 2**31 elements per tensor")


def local_rule(ps):
    """Batch shards (A_log replicated), or head shards of x with dt and
    A_log split alike (B and C replicated): the scan is independent along
    both."""
    d = shard_dim(ps[0])
    if d == 0:
        return along(ps, (0, 0, None, 0, 0), (0, 0))
    if d == 2:
        return along(ps, (2, 2, 0, None, None), (2, 1))
    return None


def ssd_scan(x, dt, A_log, B_mat, C_mat, chunk, *, block_h=None):
    """x (B,L,H,P), dt (B,L,H), A_log (H,), B/C (B,L,N). Returns (y (B,L,H,P)
    in x's dtype, final_state (B,H,P,N) float32). Raises where an input
    requires grad (``refuse_grad``). DTensor inputs run on their local
    shards (``on_local_shards``)."""
    tensors = (x, dt, A_log, B_mat, C_mat)
    refuse_grad("ssd_scan", *tensors)
    out = on_local_shards(lambda *t: ssd_scan(*t, chunk, block_h=block_h),
                          tensors, local_rule, 2)
    if out is not None:
        return out
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_plain(x, dt, A_log, B_mat, C_mat, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, got {x.device}")
    return _launch(x, dt, A_log, B_mat, C_mat, min(chunk, x.shape[1]))


def _launch(x, dt, A_log, B_mat, C_mat, Q):
    """The kernel on x's device: checks, allocates, launches, counts; raises
    if the build or the launch fails."""
    _check(x, dt, A_log, B_mat, C_mat, Q)
    Bb, L, H, P = x.shape
    N = B_mat.shape[-1]
    x, B_mat, C_mat = (t.contiguous() for t in (x, B_mat, C_mat))
    if any(t.data_ptr() % 16 for t in (x, B_mat, C_mat)):
        raise ValueError("ssd_scan reads rows 16 bytes at a time: x, B, C must "
                         "start 16-byte aligned")
    dt32 = dt.to(torch.float32).contiguous()
    alog32 = A_log.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, state.zero_()
    cb = torch.empty(cb_scratch_shape(Bb, L, Q), dtype=torch.float32,
                     device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt32.data_ptr(), alog32.data_ptr(), B_mat.data_ptr(),
            C_mat.data_ptr(), cb.data_ptr(), y.data_ptr(), state.data_ptr(), Bb,
            L, H, P, N, Q, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, N={N}, chunk={Q}, {x.dtype})")
    with _count_lock:
        ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
