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

``cold_scan_words`` is the kernel's arithmetic in plain PyTorch: each
request's mask as the select ``mask[k-1] ? cold_gap[k] : warm_gap[k]``, an
affine map ``(a, b) = (warm_gap, warm_gap ^ cold_gap)`` over GF(2), composed
in lanes of 4 requests, scanned across a warp of 32 lanes, carried from tile
to tile and from chunk to chunk as ``cold_scan_plan`` splits the row.

``cold_scan_parallel`` is the torch port of the JAX package's
``cold_scan_parallel``: the same mask as a Hillis-Steele scan over GF(2)
affine maps, gated on any flip bit surviving. Its map ``b = warm_gap &
~cold_gap`` equals the recurrence only where ``cold_end >= warm_end``; the
kernel's select form makes the recurrence's own two comparisons and so
equals it for any input. It is a yardstick, not on the simulator's path.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.float64: 1}
LANES, PER_LANE = 32, 4  # a warp, and the consecutive requests a lane holds
TILE = LANES * PER_LANE  # the requests a warp takes a step
MAX_CHUNKS = 16  # warps a row, all in one block
WARPS_PER_SM = 16  # the warps a call aims to give each SM

_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
_sms: dict = {}  # device index -> SM count


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


def cold_scan_plan(B, T, sms):
    """(chunks a row, tiles a chunk) of the kernel's launch: a row's T
    requests in tiles of TILE, split into up to MAX_CHUNKS chunks (a power
    of two, never more than the tiles) while B rows leave fewer than
    WARPS_PER_SM warps an SM."""
    ntiles = max(1, -(-T // TILE))
    nch = 1
    while nch < MAX_CHUNKS and nch < ntiles and B * nch < WARPS_PER_SM * sms:
        nch *= 2
    return nch, -(-ntiles // nch)


def _compose(first, then):
    """The affine map ``first`` then ``then``, each ``(a, b)`` of bool
    tensors: ``s = a ^ (b & s_prev)``."""
    return then[0] ^ (then[1] & first[0]), then[1] & first[1]


def cold_scan_words(t0, warm_end, cold_end, keep_warm, n_chunks=1):
    """The CUDA kernel's arithmetic in plain PyTorch, over chunks of
    ``n_chunks`` a row as ``cold_scan_plan`` gives them: the (B, T) bool
    cold mask. Request k's map is ``(warm_gap, warm_gap ^ cold_gap)``, the
    gaps measured from request k-1's ends (from -inf at request 0, as the
    recurrence measures); lanes compose their 4 maps, a warp scans its 32
    lane maps in 5 doubling steps, tiles and then chunks carry the state.
    Past T every map is the identity (0, 1)."""
    B, T = warm_end.shape
    if B == 0 or T == 0:
        return torch.zeros((B, T), dtype=torch.bool, device=warm_end.device)
    kw = _keep_warm_rows(keep_warm, B, warm_end)[:, None]
    ninf = torch.full((B, 1), -math.inf, dtype=warm_end.dtype, device=warm_end.device)
    prev_w = torch.cat([ninf, warm_end[:, :-1]], dim=1)
    prev_c = torch.cat([ninf, cold_end[:, :-1]], dim=1)
    wg = (t0[None, :] - prev_w) > kw
    cg = (t0[None, :] - prev_c) > kw
    tpc = -(-max(1, -(-T // TILE)) // n_chunks)
    pad = n_chunks * tpc * TILE - T
    a = torch.nn.functional.pad(wg, (0, pad), value=False)
    b = torch.nn.functional.pad(wg ^ cg, (0, pad), value=True)
    # (B, chunk, tile, lane, request)
    a = a.view(B, n_chunks, tpc, LANES, PER_LANE)
    b = b.view(B, n_chunks, tpc, LANES, PER_LANE)
    lane = (torch.zeros_like(a[..., 0]), torch.ones_like(b[..., 0]))
    for j in range(PER_LANE):
        lane = _compose(lane, (a[..., j], b[..., j]))
    incl = lane  # the warp's inclusive scan of lane maps
    off = 1
    while off < LANES:
        prev = tuple(torch.nn.functional.pad(m[..., :-off], (off, 0), value=v)
                     for m, v in zip(incl, (False, True)))
        incl = _compose(prev, incl)
        off *= 2
    excl = tuple(torch.nn.functional.pad(m[..., :-1], (1, 0), value=v)
                 for m, v in zip(incl, (False, True)))
    tile_map = (incl[0][..., -1], incl[1][..., -1])  # (B, chunk, tile)
    chunk_map = (torch.zeros_like(tile_map[0][..., 0]),
                 torch.ones_like(tile_map[1][..., 0]))
    for t in range(tpc):
        chunk_map = _compose(chunk_map, (tile_map[0][..., t], tile_map[1][..., t]))
    # the state entering each chunk: the chunks before it folded from 0
    s = torch.zeros((B,), dtype=torch.bool, device=a.device)
    enter = []
    for c in range(n_chunks):
        enter.append(s)
        s = chunk_map[0][:, c] ^ (chunk_map[1][:, c] & s)
    s = torch.stack(enter, dim=1)  # (B, chunk)
    out = torch.empty_like(a)
    for t in range(tpc):
        st = excl[0][:, :, t] ^ (excl[1][:, :, t] & s[..., None])  # (B, chunk, lane)
        for j in range(PER_LANE):
            st = a[:, :, t, :, j] ^ (b[:, :, t, :, j] & st)
            out[:, :, t, :, j] = st
        s = tile_map[0][:, :, t] ^ (tile_map[1][:, :, t] & s)
    return out.reshape(B, -1)[:, :T].contiguous()


def _kernel_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = build.load("cold_scan")
            fn = lib.cold_scan_fwd
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _sm_count(device):
    idx = device.index if device.index is not None else torch.cuda.current_device()
    n = _sms.get(idx)
    if n is None:
        n = _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


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
    return _launch(t0, warm_end, cold_end, keep_warm)


def _launch(t0, warm_end, cold_end, keep_warm):
    """The kernel on the inputs' device: checks, allocates, launches over
    ``cold_scan_plan``'s split, counts; raises if the build or the launch
    fails."""
    _check(t0, warm_end, cold_end)
    B, T = warm_end.shape
    kw = _keep_warm_rows(keep_warm, B, warm_end)
    mask = torch.empty((B, T), dtype=torch.bool, device=warm_end.device)
    if B == 0 or T == 0:
        return mask
    nch, tpc = cold_scan_plan(B, T, _sm_count(warm_end.device))
    lib = _kernel_lib()
    with torch.cuda.device(warm_end.device):
        stream = torch.cuda.current_stream(warm_end.device).cuda_stream
        err = lib.cold_scan_fwd(
            t0.data_ptr(), warm_end.data_ptr(), cold_end.data_ptr(),
            kw.data_ptr(), mask.data_ptr(), B, T, _DTYPES[warm_end.dtype],
            nch, tpc, stream)
    if err != 0:
        raise RuntimeError(f"cold_scan kernel launch failed: CUDA error {err} "
                           f"(B={B}, T={T}, {warm_end.dtype})")
    with _count_lock:
        cold_scan.launches += 1
    return mask


cold_scan.launches = 0
