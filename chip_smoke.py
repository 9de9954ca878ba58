"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result):
  1. device   the card's name and power limit (nvidia-smi); TF32 off
  2. build    nvcc builds every CUDA kernel of the port from csrc/ into
              build/torch_kernels/ (one nvcc per source, all in parallel)
  3. kernels  each model kernel against its plain PyTorch version on the
              card, at the serving path's shapes and edge cases:
              flash_attention (qwen3's prefill shape, recurrentgemma's
              local layers within and past the window), ssd_scan (the JAX
              package's kernel-test cases in f32 and bf16, the serving
              dtypes, Q == L), rglru_scan (the kernel-test cases, T = 300,
              ragged W), rmsnorm (the kernel-test shapes, every served
              width, mixed x/w dtypes, misaligned rows); timings (CUDA
              events over 20 back-to-back calls, median of 20) beside the
              plain version, the library call (F.rms_norm for rmsnorm) or a
              yardstick (torch.cumsum for rglru_scan), and the bound
  Phases 4-7 run for qwen3-1.7b, mamba2-370m, recurrentgemma-9b and
  granite-moe-3b-a800m in turn, each at full width (random bf16 weights
  from seed 0), each model's weights freed before the next loads:
  4. serving  3 requests through the federated prefill -> decode workflow
              (Deployment over two platforms, caches shipped through the
              object store); the decode step is pre-warmed by the poke
  5. batching the same model under ServingEngine's continuous batching;
              every kernel counter is set to 0 before phase 4 and read
              after phase 5: each kernel launches once per layer of its
              block kind per prefill, and rmsnorm once per norm per forward
              pass (prefill or decode step), exactly
  6. checks   for granite, the MoE routing: (token, choice) routings that
              differ between kernel and plain path, and the choices one
              4-slot decode step drops; kernel-path against plain-path
              prefill logits, in bf16 (bound: 2e-2 of the largest logit,
              or twice the plain path's own move under an f32-rounding-
              sized perturbation of its scans' and norms' outputs,
              whichever is larger) and in float32 (1e-4), granite's plain
              path on the kernel path's experts; for
              recurrentgemma-9b a 2500-token prompt past its 2048-token
              window, then 8 decode steps through the ring buffers, kernel
              against plain path at every step; the prefetcher's
              side-stream copy to the card, bit-exact
  7. profile  torch.profiler over one warm prefill and 8 decode steps:
              device busy share, the kernels that take the device time and
              the ops that launched them; then the same warm prefill and 4
              decode steps on the host clock with the norms through the
              rmsnorm kernel and through the plain version, in turns
  8. cold_scan the simulator's kernel against its plain version on the card,
              exactly, in float32 and float64: the cases of the JAX
              package's kernel tests, keep_warm per row, gaps within an f32
              ulp, and the full-size case (B = T = 4096), timed beside the
              plain version, the parallel (log-depth) version and the bound
  9. sim      the batched simulator's torch backend at full size: the
              Fig-4 DAG over the paper's platforms, all 256 placements x 16
              seeds x 4096 requests: (a) sigma 0 equals the numpy backend
              (atol 1e-9, f64); (b) calibrated spread: per-placement medians
              and the pooled p99 within 1% of the numpy backend; (c) a cold
              regime: the card's totals equal the CPU's on a reduced sweep;
              (d) walls of first and warm calls (f32, f64), the numpy
              backend's wall, the device busy share, 4 kernel launches per
              call
 10. adapt    the recomposition scenario: a 3-step chain whose pA compute
              degrades 5x mid-run, RecompositionController gated on
              PlacementScorer(backend="torch"); the adaptive post-drift
              median beats the static one by >= 25%
Then one JSON line describing every kernel (launches counted over the main
paths: serving and batching of the four models for flash_attention,
ssd_scan, rglru_scan and rmsnorm, the simulator and the recomposition
phases for cold_scan), the card's name and power limit, and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import replace

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "needs a CUDA device")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import (Deployment, ObjectStore, Platform,  # noqa: E402
                              PlatformRegistry, Prefetcher, StepSpec,
                              TensorSpec, WorkflowSpec, DataRef)
from repro_torch.adapt import (  # noqa: E402
    PlacementScorer, RecompositionController, TelemetryHub)
from repro_torch.core import simulator as SIM  # noqa: E402
from repro_torch.core import torchsim  # noqa: E402
from repro_torch.core.shipping import PlacementCosts  # noqa: E402
from repro_torch.dag import DagSpec, DagStep, document_dag_fig4  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.cold_scan import (  # noqa: E402
    cold_scan, cold_scan_parallel, cold_scan_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402
from repro_torch.models import griffin as GRIFFIN  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.transformer import _is_spec, cache_defs, cast_params  # noqa: E402
from repro_torch.models.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.serving import Request, ServingEngine, pad_cache  # noqa: E402

DEV = torch.device("cuda:0")
HBM_BPS = 3.35e12  # H100 SXM device memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
MAX_LEN = 1024
NEW_TOKENS = 16
SERVE_PROMPTS = (512, 300, 512)  # federated requests: cold, then warm
BATCH_PROMPTS = (256, 512)  # continuous batching: prompt lengths drawn here
KERNELS = ("flash_attention", "cold_scan", "ssd_scan", "rglru_scan", "rmsnorm")
SIM_SEEDS = 16  # the full-size sweep: 16 seeds x 256 placements x 4096 requests
SIM_REQUESTS = 4096
COLD_SCAN_FULL = (4096, 4096)  # (B, T) of one node of that sweep
COLD_SCAN_TOL = 0  # the mask must equal the plain version's: |got - want| <= 0
ADAPT_REQUESTS = 1200


def log(msg=""):
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize(DEV)


def device_ms(fn, runs=20, reps=20) -> float:
    """Device time of one call (ms): ``runs`` calls queued back to back
    behind a sleep kernel, so the host's launch overhead does not leave the
    card idle between them; CUDA events around the run; median over ``reps``
    such runs, after a warm-up. Inputs stay in L2, as a prefill's fresh q/k/v
    do."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles to enqueue in
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(runs):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / runs)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases 1-2
# ---------------------------------------------------------------------------
def phase_device() -> str:
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    paths = build.build_all(list(KERNELS))
    dt = time.perf_counter() - t0
    for name, path in paths.items():
        ptxas = build.build_logs.get(name, "")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", ptxas)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", ptxas)]
        log(f"[build] {name}: {os.path.relpath(path)} "
            f"({build.build_seconds[name]:.1f} s; {len(regs)} kernels, "
            f"registers <= {max(regs, default=0)}, spill stores <= "
            f"{max(spills, default=0)} bytes)")
    log(f"[build] all kernels built in {dt:.1f} s")


# ---------------------------------------------------------------------------
# phase 3: kernel against plain version
# ---------------------------------------------------------------------------
def attention_work(B, T, S, H, K, d, dtype, causal, window):
    """(bytes, flops) the function needs: q/k/v read once, o written once;
    4·d flops per unmasked (query, key) pair per head."""
    t = torch.arange(T)[:, None]
    s = torch.arange(S)[None, :]
    m = torch.ones(T, S, dtype=torch.bool)
    if causal:
        m &= t >= s
    if window is not None:
        m &= (t - s) < window
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * (2 * B * T * H * d + 2 * B * S * K * d)
    flops = 4 * d * B * H * int(m.sum())
    return nbytes, flops


def flash_case(name, B, T, S, H, K, d, dtype, causal, window, seed, timed=False):
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn(B, T, H, d, generator=g, device=DEV).to(dtype)
    k = torch.randn(B, S, K, d, generator=g, device=DEV).to(dtype)
    v = torch.randn(B, S, K, d, generator=g, device=DEV).to(dtype)
    kw = dict(causal=causal, window=window)
    out = flash_attention(q, k, v, **kw)
    sync()
    want = flash_attention_plain(q, k, v, **kw)
    err = (out.float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    ok = bool(torch.isfinite(out).all()) and torch.allclose(
        out.float(), want.float(), atol=tol, rtol=tol)
    log(f"[kernels] flash_attention {name}: B={B} T={T} S={S} H={H} K={K} d={d} "
        f"{str(dtype)[6:]} causal={causal} window={window} max_abs_err={err:.3g} "
        f"tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention {name} disagrees with its plain "
                             f"version: max_abs_err {err} > tol {tol}")
    res = {"max_abs_err": err, "tolerance": tol}
    if timed:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        res["ms"] = device_ms(lambda: flash_attention(q, k, v, **kw))
        res["plain_ms"] = device_ms(lambda: flash_attention_plain(q, k, v, **kw))
        res["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        nbytes, flops = attention_work(B, T, S, H, K, d, dtype, causal, window)
        t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        res["bound_ms"] = max(t_bytes, t_ops)
        res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[kernels]   kernel {res['ms'] * 1e3:.1f} us | plain "
            f"{res['plain_ms'] * 1e3:.1f} us | scaled_dot_product_attention "
            f"{res['library_ms'] * 1e3:.1f} us | bound {res['bound_ms'] * 1e3:.2f} us "
            f"({res['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return res


def phase_kernels() -> dict:
    """flash_attention: (a) is the serving path's prefill shape (qwen3-1.7b,
    512-token prompt), timed; (b) its 300-token prompt; (c), (d) GQA with a
    window and MQA with T != S, in float32; (e)-(k) the other head_dims of
    both dtypes, ragged lengths and windows with and without causality;
    (l), (m) recurrentgemma-9b's local layers (MQA, d=256, window 2048)
    within the window and past it."""
    main = flash_case("(a) main path", 1, 512, 512, 16, 8, 128, torch.bfloat16,
                      True, None, seed=1, timed=True)
    cases = (("(b) ragged", 1, 300, 300, 16, 8, 128, torch.bfloat16, True, None),
             ("(c) GQA 4:1 window 96", 2, 256, 256, 8, 2, 64, torch.float32,
              True, 96),
             ("(d) MQA T!=S", 1, 128, 256, 4, 1, 128, torch.float32, True, None),
             # every head_dim of both dtypes, ragged and windowed
             ("(e) GQA 4:1 window 96", 2, 256, 256, 8, 2, 64, torch.bfloat16,
              True, 96),
             ("(f) MQA ragged window", 1, 100, 77, 4, 1, 256, torch.bfloat16,
              True, 40),
             ("(g) MHA non-causal", 1, 128, 128, 4, 4, 16, torch.bfloat16,
              False, None),
             ("(h) non-causal window", 2, 70, 70, 2, 1, 32, torch.bfloat16,
              False, 8),
             ("(i) ragged", 1, 100, 77, 4, 2, 256, torch.float32, True, 40),
             ("(j) non-causal window", 1, 64, 64, 2, 1, 16, torch.float32,
              False, 8),
             ("(k) ragged", 1, 65, 65, 4, 2, 32, torch.float32, True, None),
             # recurrentgemma-9b's local layers: MQA, d=256, window 2048,
             # within the window and past it
             ("(l) local layer", 1, 512, 512, 16, 1, 256, torch.bfloat16,
              True, 2048),
             ("(m) window binds", 1, 2500, 2500, 16, 1, 256, torch.bfloat16,
              True, 2048))
    for seed, args in enumerate(cases, start=2):
        flash_case(*args, seed=seed)
    return main


# ---------------------------------------------------------------------------
# phase 3b: the recurrent families' scans against their plain versions
# ---------------------------------------------------------------------------
def _esize(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def _close(got, want, tol):
    """(max abs error, ok): finite and within atol = rtol = tol."""
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), atol=tol, rtol=tol)
    return err, ok


def ssd_inputs(B, L, H, P, N, dtype, dt_dtype, alog_dtype, seed):
    """The JAX package's kernel-test generator on the card: x, B, C normal,
    dt = softplus(normal), A_log = log U(1, 8)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(B, L, H, P, generator=g, device=DEV).to(dtype)
    dt = F.softplus(torch.randn(B, L, H, generator=g, device=DEV)).to(dt_dtype)
    alog = torch.log(1.0 + 7.0 * torch.rand(H, generator=g, device=DEV)).to(alog_dtype)
    Bm = torch.randn(B, L, N, generator=g, device=DEV).to(dtype)
    Cm = torch.randn(B, L, N, generator=g, device=DEV).to(dtype)
    return x, dt, alog, Bm, Cm


def ssd_work(B, L, H, P, N, Q, dtype, dt_dtype):
    """(bytes, flops) the function needs: inputs read once, y and the f32
    state written once; flops at 2 per multiply-add, the fewer of two forms.
    Chunked: per chunk the causal halves of C·Bᵀ (shared by the heads) and
    of the intra-chunk product, and the state update; the inter-chunk term
    C_t·h only from the second chunk on (the first starts from zero).
    Recurrent: per step, head and state element one multiply-add for the
    update and one for y = C·h."""
    nbytes = (_esize(dtype) * (2 * B * L * H * P + 2 * B * L * N)
              + _esize(dt_dtype) * (B * L * H + H) + 4 * B * H * P * N)
    nc, tri = L // Q, Q * (Q + 1) // 2
    chunked = 2 * B * (nc * (tri * N + tri * H * P + Q * H * P * N)
                       + (nc - 1) * Q * H * P * N)
    recurrent = 4 * B * L * H * P * N
    return nbytes, min(chunked, recurrent)


def ssd_case(name, B, L, H, P, N, Q, dtype, dt_dtype, alog_dtype, tol, seed,
             timed=False):
    args = ssd_inputs(B, L, H, P, N, dtype, dt_dtype, alog_dtype, seed)
    y, st = ssd_scan(*args, Q)
    sync()
    yw, sw = ssd_scan_plain(*args, Q)
    ey, oky = _close(y, yw, tol)
    es, oks = _close(st, sw, tol)
    ok = oky and oks and y.dtype == dtype and st.dtype == torch.float32
    log(f"[ssd_scan] {name}: B={B} L={L} H={H} P={P} N={N} Q={Q} x/B/C "
        f"{str(dtype)[6:]} dt {str(dt_dtype)[6:]} A_log {str(alog_dtype)[6:]}: "
        f"max_abs_err y {ey:.3g} state {es:.3g} atol=rtol={tol:g} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"ssd_scan {name} disagrees with its plain version")
    res = {"max_abs_err": max(ey, es), "tolerance": tol}
    if timed:
        res["ms"] = device_ms(lambda: ssd_scan(*args, Q))
        res["plain_ms"] = device_ms(lambda: ssd_scan_plain(*args, Q), runs=2, reps=5)
        nbytes, flops = ssd_work(B, L, H, P, N, Q, dtype, dt_dtype)
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3  # f32 products (G, h)
        res.update(bound_ms=max(t_bytes, t_ops), library_ms=None,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops)
        log(f"[ssd_scan]   kernel {res['ms'] * 1e3:.1f} us | plain "
            f"{res['plain_ms'] * 1e3:.1f} us | bound {res['bound_ms'] * 1e3:.2f} us "
            f"({res['bound_by']}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP "
            f"at the f32 rate) | {res['bound_ms'] / res['ms'] * 100:.1f}% of the "
            f"bound | library: none")
    return res


def phase_ssd_scan() -> dict:
    """ssd_scan: the cases of the JAX package's kernel tests in f32 and bf16
    (dt in x's dtype, A_log f32), Q == L, the serving dtypes (x, dt, A_log,
    B, C all bf16: every mamba2 layer is a cycled layer, so cast_params
    casts its stacked A_log too), and the main path's shape (mamba2-370m,
    a 512-token prompt), timed. Tolerance atol = rtol: 2e-2 in bf16 (y is
    rounded to bf16 on both sides), 1e-4 in f32. Both versions sum the
    prefix sums of a·dt in f64, so they decay by the same exponents."""
    f32, bf16 = torch.float32, torch.bfloat16
    worst = 0.0
    seed = 20
    for B, L, H, P, N, Q in ((1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32),
                             (1, 96, 3, 16, 8, 32)):
        for dtype in (f32, bf16):
            tol = TOL[dtype]
            r = ssd_case("(test_kernels)", B, L, H, P, N, Q, dtype, dtype, f32,
                         tol, seed)
            worst, seed = max(worst, r["max_abs_err"]), seed + 1
    for name, args in (("(Q == L)", (1, 64, 2, 16, 8, 64, f32, f32, f32, TOL[f32])),
                       ("(serving dtypes)", (2, 128, 3, 32, 16, 32, bf16, bf16, bf16,
                                             TOL[bf16])),
                       ("(main shape, f32)", (1, 512, 32, 64, 128, 256, f32, f32,
                                              f32, TOL[f32]))):
        r = ssd_case(name, *args, seed=seed)
        worst, seed = max(worst, r["max_abs_err"]), seed + 1
    main = ssd_case("(a) main path", 1, 512, 32, 64, 128, 256, bf16, bf16, bf16,
                    TOL[bf16], seed=seed, timed=True)
    main["max_abs_err"] = max(worst, main["max_abs_err"])
    return main


def rglru_bytes(B, T, W) -> int:
    """log_a and b read once, y and h_last written once (float32)."""
    return 4 * (3 * B * T * W + B * W)


def phase_rglru_scan() -> dict:
    """rglru_scan: the cases of the JAX package's kernel tests, T = 300 (no
    chunk multiple: the TPU kernel refuses it), and the main path's shape
    (recurrentgemma-9b, a 512-token prompt), timed. Tolerance atol = rtol =
    1e-5, the JAX package's own."""
    g = torch.Generator(device=DEV).manual_seed(30)
    tol = 1e-5
    worst = 0.0
    res = {}
    for name, (B, T, W) in (("(test_kernels)", (1, 64, 32)),
                            ("(test_kernels)", (2, 128, 64)),
                            ("(test_kernels)", (1, 256, 16)),
                            ("(T = 300)", (1, 300, 4096)),
                            ("(ragged W, T = 1)", (3, 1, 100)),
                            ("(a) main path", (1, 512, 4096))):
        log_a = -F.softplus(torch.randn(B, T, W, generator=g, device=DEV))
        b = torch.randn(B, T, W, generator=g, device=DEV)
        y, h = rglru_scan(log_a, b)
        sync()
        yw, hw = rglru_scan_plain(log_a, b)
        ey, oky = _close(y, yw, tol)
        eh, okh = _close(h, hw, tol)
        ok = oky and okh
        worst = max(worst, ey, eh)
        log(f"[rglru_scan] {name}: B={B} T={T} W={W}: max_abs_err y {ey:.3g} "
            f"h_last {eh:.3g} tol {tol:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"rglru_scan {name} disagrees with its plain version")
    res["ms"] = device_ms(lambda: rglru_scan(log_a, b))
    res["plain_ms"] = device_ms(lambda: rglru_scan_plain(log_a, b), runs=2, reps=5)
    # yardstick: a library scan over the same (B, T, W) f32 tensor
    res["yardstick_ms"] = device_ms(lambda: torch.cumsum(b, dim=1))
    nbytes = rglru_bytes(B, T, W)
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 4 * B * T * W / PEAK_FLOPS[torch.float32] * 1e3  # exp, mul, add
    res.update(bound_ms=max(t_bytes, t_ops), library_ms=None, bytes=nbytes,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=worst, tolerance=tol, shape=[B, T, W])
    log(f"[rglru_scan]   kernel {res['ms'] * 1e3:.1f} us | plain (log-depth) "
        f"{res['plain_ms'] * 1e3:.1f} us | torch.cumsum (yardstick) "
        f"{res['yardstick_ms'] * 1e3:.1f} us | bound {res['bound_ms'] * 1e3:.2f} us "
        f"(bytes: {nbytes / 1e6:.1f} MB) | {res['bound_ms'] / res['ms'] * 100:.1f}% "
        f"of the bound | library: none")
    return res


# ---------------------------------------------------------------------------
# phase 3c: rmsnorm against its plain version
# ---------------------------------------------------------------------------
RMSNORM_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
EPS = 1e-6


def rmsnorm_bytes(x, w) -> int:
    """x read once, out written once, w read once."""
    return 2 * x.numel() * x.element_size() + w.numel() * w.element_size()


def rmsnorm_case(g, name, shape, dtype, w_dtype, offset=0, timed=False):
    """x normal, w = 0.1·normal (the JAX package's kernel-test generator);
    ``offset`` shifts x one element off 16-byte alignment (the scalar
    path)."""
    n = int(np.prod(shape))
    x = torch.randn(n + offset, generator=g, device=DEV).to(dtype)[offset:]
    x = x.view(shape)
    w = (0.1 * torch.randn(shape[-1], generator=g, device=DEV)).to(w_dtype)
    got = rmsnorm(x, w, EPS)
    sync()
    want = rmsnorm_plain(x, w, EPS)
    tol = RMSNORM_TOL[dtype]
    err, ok = _close(got, want, tol)
    ok = ok and got.dtype == dtype and got.shape == x.shape
    log(f"[rmsnorm] {name}: x {tuple(shape)} {str(dtype)[6:]} w {str(w_dtype)[6:]}"
        f"{' (x 16-byte misaligned)' if offset else ''}: max_abs_err {err:.3g} "
        f"atol=rtol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"rmsnorm {name} disagrees with its plain version")
    res = {"max_abs_err": err, "tolerance": tol}
    if timed:
        D = shape[-1]
        xf, w1 = x.float(), 1.0 + w.float()  # the library call's operands
        lib_err = (F.rms_norm(xf, (D,), w1, EPS).to(dtype).float()
                   - want.float()).abs().max().item()
        res["ms"] = device_ms(lambda: rmsnorm(x, w, EPS))
        res["plain_ms"] = device_ms(lambda: rmsnorm_plain(x, w, EPS))
        res["library_ms"] = device_ms(lambda: F.rms_norm(xf, (D,), w1, EPS))
        nbytes = rmsnorm_bytes(x, w)
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = 4 * x.numel() / PEAK_FLOPS[torch.float32] * 1e3  # f32 stats, scale
        res.update(bound_ms=max(t_bytes, t_ops), bytes=nbytes, shape=list(shape),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"[rmsnorm]   kernel {res['ms'] * 1e3:.2f} us | plain "
            f"{res['plain_ms'] * 1e3:.2f} us | F.rms_norm on the f32 input "
            f"{res['library_ms'] * 1e3:.2f} us (its max_abs_err vs plain, cast to "
            f"{str(dtype)[6:]}: {lib_err:.3g}) | bound {res['bound_ms'] * 1e3:.3f} us "
            f"({res['bound_by']}: {nbytes / 1e6:.2f} MB) | "
            f"{res['bound_ms'] / res['ms'] * 100:.1f}% of the bound")
    return res


def phase_rmsnorm() -> dict:
    """rmsnorm: the JAX package's kernel-test shapes in f32 and bf16 (w
    f32); the serving shapes (granite's prefill and 4-slot decode rows, the
    other models' widths, qwen3's qk-norm rows); mixed x/w dtypes; a row
    count that fills no whole block; rows off 16-byte alignment; and the
    main path's shape (granite-moe-3b-a800m, a 512-token prompt), timed.
    Tolerances as tests/test_kernels.py."""
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=DEV).manual_seed(40)
    worst = 0.0
    cases = [("(test_kernels)", s, dt, f32) for s in ((7, 64), (3, 5, 128), (1, 256))
             for dt in (f32, bf16)]
    cases += [("(granite decode, 4 slots)", (4, 1, 1536), bf16, bf16),
              ("(qwen3 qk-norm)", (1, 512, 16, 128), bf16, bf16),
              ("(qwen3 d_model)", (1, 512, 2048), bf16, bf16),
              ("(mamba2 d_model, norm_y)", (1, 512, 1024), bf16, bf16),
              ("(mamba2 norm_y)", (1, 512, 2048), bf16, bf16),
              ("(recurrentgemma remainder)", (1, 512, 4096), bf16, f32),
              ("(f32 stream, bf16 w)", (1, 300, 2048), f32, bf16),
              ("(f32, f32)", (2, 77, 4096), f32, f32),
              ("(rows fill no block)", (1001, 128), bf16, bf16),
              ("(D not a vector multiple)", (5, 100), bf16, f32),
              ("(D not a vector multiple)", (6, 99), f32, f32),
              ("(widest row)", (3, 16384), bf16, bf16)]
    for args in cases:
        worst = max(worst, rmsnorm_case(g, *args)["max_abs_err"])
    for args in (("(misaligned, warp path)", (9, 1000), bf16, bf16),
                 ("(misaligned, block path)", (3, 1536), f32, bf16)):
        worst = max(worst, rmsnorm_case(g, *args, offset=1)["max_abs_err"])
    main = rmsnorm_case(g, "(a) main path", (512, 1536), bf16, bf16, timed=True)
    main["max_abs_err"] = max(worst, main["max_abs_err"])
    return main


# ---------------------------------------------------------------------------
# phase 4: federated prefill -> decode at full width
# ---------------------------------------------------------------------------
def make_params(cfg):
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                           device=DEV)
    params = cast_params(cfg, params)  # once: serving never updates weights
    torch.cuda.empty_cache()
    sync()
    n = sum(t.numel() for t in tree_leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"[serving] {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}"
        f"{f' experts={cfg.num_experts} top_k={cfg.top_k}' if cfg.num_experts else ''}"
        f": {n / 1e9:.3f} B params, "
        f"{nbytes / 1e9:.2f} GB {cfg.compute_dtype} on {DEV} "
        f"({time.perf_counter() - t0:.1f} s)")
    return params


def greedy(logits) -> int:
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    return int(torch.argmax(logits[0]))


def phase_federated(cfg, params, prompts):
    reg = PlatformRegistry()
    reg.register(Platform("prefill-pod", "us-east", native_prefetch=True,
                          device=str(DEV)))
    reg.register(Platform("decode-pod", "us-west", native_prefetch=True,
                          device=str(DEV)))
    V = cfg.vocab_size
    with Deployment(reg) as dep:
        dep.store.network.set_link("us-east", "us-west", 0.02, 200e6)

        def prefill_fn(payload, data):
            tokens = torch.as_tensor(payload, device=DEV)[None]
            logits, caches = M.prefill(cfg, params, {"tokens": tokens})
            if tuple(logits.shape) != (1, V):
                raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
            tok = greedy(logits)
            caches = pad_cache(caches, MAX_LEN, len(payload), cfg=cfg)
            key = f"kv/{len(payload)}/{tok}"
            dep.store.put(key, tree_map(lambda t: t.cpu(), caches),
                          region="us-east")
            return {"first_tok": tok, "kv_key": key, "pos": len(payload)}

        def decode_step(token, caches, cur):
            return M.decode_step(cfg, params, token, caches, cur)

        def decode_fn(payload, data):
            host_caches, _ = dep.store.get(payload["kv_key"], "us-west")
            caches = tree_map(lambda t: t.to(DEV), host_caches)
            tok, cur = payload["first_tok"], payload["pos"]
            toks = [tok]
            for _ in range(NEW_TOKENS - 1):
                logits, caches = decode_step(
                    torch.tensor([[tok]], dtype=torch.int32, device=DEV), caches,
                    cur)
                tok = greedy(logits)
                toks.append(tok)
                cur += 1
            return toks

        dec_specs = (TensorSpec((1, 1), torch.int32, str(DEV)),
                     tree_map(lambda d: TensorSpec(d.shape, getattr(torch, d.dtype),
                                                   str(DEV)),
                              cache_defs(cfg, 1, MAX_LEN), is_leaf=_is_spec),
                     0)
        dep.deploy("prefill", prefill_fn, ["prefill-pod"])
        dep.deploy("decode", decode_fn, ["decode-pod"], abstract_args=dec_specs,
                   compile_fn=decode_step)
        wf = WorkflowSpec((StepSpec("prefill", "prefill-pod"),
                           StepSpec("decode", "decode-pod")), "serve")
        results = []
        for i, prompt in enumerate(prompts):
            r = dep.run(wf, prompt)
            toks = r.outputs
            if len(toks) != NEW_TOKENS or not all(0 <= t < V for t in toks):
                raise AssertionError(f"request {i}: bad tokens {toks}")
            tl = " | ".join(
                f"{node}: warm {t['warm_s'] * 1e3:.1f} ms fetch "
                f"{t['fetch_s'] * 1e3:.1f} ms compute {t['compute_s'] * 1e3:.1f} ms"
                for node, t in r.timeline.items())
            log(f"[serving] request {i} ({'cold' if i == 0 else 'warm'}) prompt "
                f"{len(prompt)}: total_s={r.total_s:.4f} | {tl}")
            results.append({"prompt": len(prompt), "total_s": r.total_s,
                            "timeline": {n: {k: v for k, v in t.items()
                                             if isinstance(v, float)}
                                         for n, t in r.timeline.items()}})
        rep = dep.report()
    comp = rep["compile"]
    log(f"[serving] compile cache: prewarms={comp['prewarms']} hits={comp['hits']} "
        f"misses={comp['misses']} hidden_compile_s={comp['hidden_compile_s']:.3f}; "
        f"store puts={rep['store']['puts']} gets={rep['store']['gets']} "
        f"bytes_in={rep['store']['bytes_in']}")
    if comp["prewarms"] != 1 or comp["misses"] != 0:
        raise AssertionError(f"decode was not pre-warmed by the poke: {comp}")
    return results


# ---------------------------------------------------------------------------
# phase 5: continuous batching
# ---------------------------------------------------------------------------
def phase_batching(cfg, params):
    rng = np.random.default_rng(1)
    eng = ServingEngine(cfg, params, max_batch=4, max_len=MAX_LEN, device=DEV)
    eng.prewarm(BATCH_PROMPTS[1])
    decode_s = [0.0]
    inner = eng._decode_once

    def timed_decode():
        t0 = time.perf_counter()
        inner()  # ends in a device-to-host copy of the tokens: synchronised
        decode_s[0] += time.perf_counter() - t0

    eng._decode_once = timed_decode
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32),
                    max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(rng.integers(BATCH_PROMPTS[0],
                                               BATCH_PROMPTS[1] + 1, size=8))]
    t0 = time.perf_counter()
    for r in reqs:
        r.t_submit = t0
        eng.submit(r)
    stats = eng.run()
    wall = time.perf_counter() - t0
    decode_tokens = sum(len(r.tokens) - 1 for r in reqs)
    res = {"done": stats["done"], "prefills": stats["prefills"],
           "decode_steps": stats["decode_steps"],
           "mean_ttft_s": float(np.mean(stats["ttft_s"])),
           "decode_tokens": decode_tokens, "decode_s": decode_s[0],
           "decode_tok_s": decode_tokens / decode_s[0], "wall_s": wall,
           "prompts": [len(r.prompt) for r in reqs]}
    log(f"[batching] done={res['done']} prefills={res['prefills']} "
        f"decode_steps={res['decode_steps']} mean TTFT={res['mean_ttft_s']:.4f} s "
        f"decode {decode_tokens} tokens in {res['decode_s']:.4f} s = "
        f"{res['decode_tok_s']:.1f} tok/s; wall {wall:.3f} s")
    if res["done"] != len(reqs) or any(len(r.tokens) != NEW_TOKENS for r in reqs):
        raise AssertionError(f"continuous batching did not finish: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 6: checks off the counted path
# ---------------------------------------------------------------------------
NOISE = 1e-7  # relative perturbation of a plain version's output: about one f32 ulp
NOISE_SEEDS = (5, 6, 7, 8)  # the floor is the largest move over these draws


def _perturbed_plain(seed):
    """The plain versions of every kernel that sits on a model's path
    except flash attention (the scans ``ssd_chunked`` and ``lru_scan``, and
    ``rmsnorm_plain``, which every norm of the plain path calls) with their
    outputs multiplied by 1 + NOISE * normal: a change of the size of an f32
    rounding. Returns a function that restores them."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    saved = {(mod, name): getattr(mod, name)
             for mod, name in ((SSM, "ssd_chunked"), (GRIFFIN, "lru_scan"),
                               (L, "rmsnorm_plain"))}

    def wrap(fn):
        def noisy(x, *args, **kw):
            # each computes in f32 whatever x's dtype; ask for its f32
            # output, so the noise lands before the rounding to x's dtype
            out = fn(x.float(), *args, **kw)
            y = out[0] if isinstance(out, tuple) else out
            noise = torch.randn(y.shape, generator=g, device=y.device)
            y = (y * (1 + NOISE * noise)).to(x.dtype)
            return (y, *out[1:]) if isinstance(out, tuple) else y
        return noisy
    for (mod, name), fn in saved.items():
        setattr(mod, name, wrap(fn))

    def restore():
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return restore


class recording_routes:
    """Records each MoE call's routing while active: (gate_i (n, K),
    dropped (n, K), capacity C), from the port's own ``moe_route`` on the
    layer's input."""

    def __enter__(self):
        self.calls = []
        self._moe = L.moe

        def recording(cfg, p, x):
            _, _, gate_i, pos, C = L.moe_route(cfg, p, x.reshape(1, -1, x.shape[-1]))
            self.calls.append((gate_i[0], pos[0] >= C, C))
            return self._moe(cfg, p, x)
        L.moe = recording
        return self

    def __exit__(self, *exc):
        L.moe = self._moe
        return False


class pinned_routes:
    """Replays recorded routing (a list of gate_i (n, K), one per MoE call,
    in order): each call takes the experts the recorded call chose, with
    gate weights from its own router probabilities at those experts, and
    the slots and capacity those choices give."""

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        self._route = L.moe_route
        recorded = iter(self.calls)

        def replay(cfg, p, xg):
            probs, _, _, _, C = self._route(cfg, p, xg)
            gate_i = next(recorded).view(xg.shape[0], xg.shape[1], -1)
            gate_w = torch.gather(probs, -1, gate_i)
            gate_w = gate_w / torch.sum(gate_w, dim=-1, keepdim=True)
            return probs, gate_w, gate_i, L.moe_slots(gate_i, cfg.num_experts), C
        L.moe_route = replay
        return self

    def __exit__(self, *exc):
        L.moe_route = self._route
        return False


def phase_checks(cfg, params, prompt):
    """Kernel-path against plain-path prefill logits, in the serving dtype
    and in float32 (the same bf16 weights cast up, exactly). In an MoE
    model the plain path takes the kernel path's experts (``pinned_routes``;
    phase_moe reports how many routings differ when it chooses its own): a
    last-bit difference flips a near-tie of the router, and a flipped choice
    sends a token through another expert, which no rounding tolerance can
    measure.

    bf16: the same greedy token, and logits within TOL[bf16] of the largest
    logit or, where the plain path itself moves further when its scans' and
    norms' outputs are perturbed by an f32 rounding (NOISE, the largest move
    over NOISE_SEEDS), within twice that floor: a bf16 model whose roundings
    cascade through its layers cannot agree closer with any other
    implementation. float32 has no such cascade and is held to TOL[f32]."""
    tokens = torch.as_tensor(prompt, device=DEV)[None]

    def kernel_and_plain(c, prm):
        """(kernel-path prefill, a function that runs the plain path on the
        kernel path's experts)."""
        with recording_routes() as rec:
            logits, _ = M.prefill(c, prm, {"tokens": tokens})
        routes = [gi for gi, _, _ in rec.calls]

        def plain():
            with pinned_routes(routes):
                return M.prefill(c.replace(use_pallas=False), prm,
                                 {"tokens": tokens})[0]
        return logits, plain

    k_logits, plain = kernel_and_plain(cfg, params)
    p_logits = plain()
    moves = []
    for seed in NOISE_SEEDS:
        restore = _perturbed_plain(seed)
        try:
            n_logits = plain()
        finally:
            restore()
        moves.append((n_logits - p_logits).abs().max().item())
    sync()
    diff = (k_logits - p_logits).abs().max().item()
    floor = max(moves)
    scale = p_logits.abs().max().item()
    bound = max(TOL[torch.bfloat16] * scale, 2 * floor)
    k_tok, p_tok = greedy(k_logits), greedy(p_logits)
    log(f"[checks] prefill logits kernel vs plain path (prompt {len(prompt)}"
        f"{', plain path on the kernel path experts' if cfg.num_experts else ''}): "
        f"max_abs_diff={diff:.4g} max_abs_logit={scale:.4g} "
        f"argmax {k_tok} vs {p_tok}; plain path under {NOISE:g} relative "
        f"noise in its scans and norms moves {', '.join(f'{m:.4g}' for m in moves)} "
        f"(seeds {NOISE_SEEDS}); bound {bound:.4g}")
    if k_tok != p_tok:
        raise AssertionError(f"kernel-path greedy token {k_tok} != plain "
                             f"path's {p_tok}")
    if not diff <= bound:
        raise AssertionError(f"kernel-path logits differ from the plain path: "
                             f"{diff} > max({TOL[torch.bfloat16]} * {scale}, "
                             f"2 * {floor})")

    f32 = tree_map(lambda t: t.float(), params)
    k32, plain32 = kernel_and_plain(cfg.replace(compute_dtype="float32"), f32)
    p32 = plain32()
    sync()
    del f32
    torch.cuda.empty_cache()
    diff32 = (k32 - p32).abs().max().item()
    scale32 = p32.abs().max().item()
    log(f"[checks] float32 (the same weights): max_abs_diff={diff32:.4g} "
        f"max_abs_logit={scale32:.4g} tol {TOL[torch.float32]:g} x max logit")
    if not diff32 <= TOL[torch.float32] * scale32:
        raise AssertionError(f"float32 kernel-path logits differ from the plain "
                             f"path: {diff32} > {TOL[torch.float32]} * {scale32}")

    store = ObjectStore()
    host = np.random.default_rng(2).standard_normal((4096, 4096)).astype(np.float32)
    store.put("weights/probe", host, region="us-west")
    pf = Prefetcher(store)
    try:
        futs = pf.start([DataRef("weights/probe", "us-west")], "us-west",
                        device=DEV)
        got, _, _ = pf.join(futs)
    finally:
        pf.shutdown()
    t = got["weights/probe"]
    same = t.device == DEV and torch.equal(t, torch.from_numpy(host).to(DEV))
    log(f"[checks] Prefetcher.start(device={DEV}) delivered {host.nbytes / 1e6:.1f} "
        f"MB to {t.device}: {'bit-exact' if same else 'MISMATCH'}")
    if not same:
        raise AssertionError("prefetched array differs from the stored one")


def _profiled(fn):
    """(wall s, {kernel name: device s}, [(device s, calls, op, input
    shapes)] of the ops that launched the kernels) of ``fn`` under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
    ops = sorted(((a.self_device_time_total * 1e-6, a.count, a.key, str(a.input_shapes))
                  for a in prof.key_averages(group_by_input_shape=True)
                  if a.self_device_time_total > 0), reverse=True)
    return wall, kernels, ops


def phase_profile(cfg, params, prompt):
    """Where the time goes in one warm prefill and in 8 decode steps: device
    busy share (kernel time over wall time) and the kernels that take it."""
    tokens = torch.as_tensor(prompt, device=DEV)[None]
    _, caches = M.prefill(cfg, params, {"tokens": tokens})
    caches = pad_cache(caches, MAX_LEN, len(prompt), cfg=cfg)
    tok = torch.ones((1, 1), dtype=torch.int32, device=DEV)
    M.decode_step(cfg, params, tok, caches, len(prompt))
    sync()

    def decode8():
        for i in range(8):
            M.decode_step(cfg, params, tok, caches, len(prompt) + 1 + i)

    out = {}
    for name, fn in (("prefill", lambda: M.prefill(cfg, params, {"tokens": tokens})),
                     ("decode x8", decode8)):
        wall, kernels, ops = _profiled(fn)
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
        log(f"[profile] {name} (prompt {len(prompt)}): wall {wall * 1e3:.2f} ms, "
            f"device busy {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%), "
            f"{len(kernels)} kernel names")
        if not kernels:
            log("[profile]   device time not measured: the profiler recorded no kernels")
        for kname, ks in top:
            log(f"[profile]   {100 * ks / busy if busy else 0:5.1f}% {ks * 1e3:8.3f} ms  "
                f"{kname[:90]}")
        for ds, calls, op, shapes in ops[:4]:
            log(f"[profile]   op {ds * 1e3:8.3f} ms x{calls} {op} {shapes[:100]}")
        out[name] = {"wall_s": wall, "device_busy_s": busy,
                     "top": [[k[:90], s] for k, s in top],
                     "top_ops": [[op, shapes[:100], calls, ds]
                                 for ds, calls, op, shapes in ops[:4]]}
    return out


NORM_AB_TURNS = ("kernel", "plain", "plain", "kernel") * 3
NORM_AB_DECODE = 4


def phase_norm_ab(cfg, params, prompt) -> dict:
    """The rmsnorm kernel end to end: one warm prefill and NORM_AB_DECODE
    decode steps (host clock, each ended by a synchronise) with every norm
    through the kernel and, everything else equal, through the plain
    version, in turns (kernel, plain, plain, kernel) x 3; medians."""
    tokens = torch.as_tensor(prompt, device=DEV)[None]
    _, caches = M.prefill(cfg, params, {"tokens": tokens})
    caches = pad_cache(caches, MAX_LEN, len(prompt), cfg=cfg)
    tok = torch.ones((1, 1), dtype=torch.int32, device=DEV)
    sync()

    def run():
        t0 = time.perf_counter()
        M.prefill(cfg, params, {"tokens": tokens})
        sync()
        t1 = time.perf_counter()
        for i in range(NORM_AB_DECODE):
            M.decode_step(cfg, params, tok, caches, len(prompt) + i)
        sync()
        return t1 - t0, (time.perf_counter() - t1) / NORM_AB_DECODE

    kernel = L.rmsnorm_kernel
    walls = {"kernel": [], "plain": []}
    for turn in NORM_AB_TURNS:
        L.rmsnorm_kernel = kernel if turn == "kernel" else rmsnorm_plain
        try:
            walls[turn].append(run())
        finally:
            L.rmsnorm_kernel = kernel
    res = {name: {"prefill_s": statistics.median(w[0] for w in ws),
                  "decode_step_s": statistics.median(w[1] for w in ws)}
           for name, ws in walls.items()}
    k, p = res["kernel"], res["plain"]
    log(f"[norm a/b] prompt {len(prompt)}, medians of {len(walls['kernel'])} turns "
        f"each: prefill {k['prefill_s'] * 1e3:.2f} ms with the rmsnorm kernel vs "
        f"{p['prefill_s'] * 1e3:.2f} ms with the plain norms "
        f"({(k['prefill_s'] / p['prefill_s'] - 1) * 100:+.1f}%); decode step "
        f"{k['decode_step_s'] * 1e3:.2f} vs {p['decode_step_s'] * 1e3:.2f} ms "
        f"({(k['decode_step_s'] / p['decode_step_s'] - 1) * 100:+.1f}%)")
    return res


# ---------------------------------------------------------------------------
# phase 8: cold_scan against its plain version
# ---------------------------------------------------------------------------
def cold_case(g, B, T, interarrival, keep_warm, spread=0.3):
    """The JAX package's kernel-test generator on the card (float64):
    arrival times plus warm/cold end-time hypotheses around them."""
    gaps = interarrival * (0.5 + torch.rand(T, generator=g, device=DEV,
                                            dtype=torch.float64))
    t0 = torch.cumsum(gaps, 0)
    warm = t0[None, :] + spread * torch.rand(B, T, generator=g, device=DEV,
                                             dtype=torch.float64)
    cold = warm + spread * torch.rand(B, T, generator=g, device=DEV,
                                      dtype=torch.float64)
    return t0, warm, cold, keep_warm


def cold_scan_bytes(B, T, dtype) -> int:
    """t0, warm_end, cold_end and keep_warm read once, the bool mask
    written once."""
    esize = torch.tensor([], dtype=dtype).element_size()
    return esize * (T + 2 * B * T + B) + B * T


def scan_check(name, t0, warm, cold, kw, dtype):
    args = [x.to(dtype).contiguous() for x in (t0, warm, cold)]
    kwd = kw.to(dtype) if isinstance(kw, torch.Tensor) else kw
    got = cold_scan(*args, kwd)
    sync()
    want = cold_scan_plain(*args, kwd)
    diff = (got.to(torch.int8) - want.to(torch.int8)).abs()
    bad = int(diff.sum())
    err = int(diff.max()) if diff.numel() else 0
    cold_share = float(want.float().mean())
    log(f"[cold_scan] {name} {str(dtype)[6:]}: B={warm.shape[0]} T={warm.shape[1]} "
        f"cold share {cold_share:.3f} mismatches {bad} max_abs_err {err} "
        f"{'ok' if err <= COLD_SCAN_TOL else 'FAIL'}")
    if err > COLD_SCAN_TOL:
        raise AssertionError(f"cold_scan {name} {dtype}: {bad} mask entries "
                             f"differ from the plain version")
    return args, kwd, err


def phase_cold_scan() -> dict:
    g = torch.Generator(device=DEV).manual_seed(7)
    cases = []
    for B, T in ((1, 64), (3, 257), (130, 300)):
        for ia, kw in ((1.0, 900.0), (10.0, 1.0), (1.0, 0.95), (1.0, float("inf"))):
            cases.append((f"B={B} T={T} interarrival={ia} keep_warm={kw}",
                          *cold_case(g, B, T, ia, kw)))
    t0 = 0.7 * torch.arange(97, device=DEV, dtype=torch.float64)
    warm = t0[None, :] + 0.02
    cases.append(("flip-heavy", t0, warm, warm + 0.5, 0.6))
    t0, warm, cold, _ = cold_case(g, 64, 300, 1.0, None)
    kws = torch.linspace(0.5, 1.5, 64, device=DEV, dtype=torch.float64)
    kws[::7] = float("inf")
    cases.append(("keep_warm per row", t0, warm, cold, kws))
    worst = 0
    for name, t0, warm, cold, kw in cases:
        for dtype in (torch.float32, torch.float64):
            worst = max(worst, scan_check(name, t0, warm, cold, kw, dtype)[2])
    # gaps within one f32 ulp of keep_warm: f64 must decide them in f64
    t0 = 3.0 * torch.arange(64, device=DEV, dtype=torch.float64)
    delta = torch.where(torch.rand(4, 64, generator=g, device=DEV) < 0.5, 1e-9, -1e-9)
    warm = t0[None, :] + 2.0 - delta.double()
    args, _, err = scan_check("f32-ulp gaps", t0, warm, warm + 0.5, 1.0,
                              torch.float64)
    worst = max(worst, err)
    as_f32 = cold_scan(*[x.float() for x in args], 1.0)
    want = cold_scan_plain(*args, 1.0)
    if not bool((as_f32 != want).any()):
        raise AssertionError("the f32-ulp case did not separate f32 from f64")

    B, T = COLD_SCAN_FULL
    t0, warm, cold, kw = cold_case(g, B, T, 1.0, 0.95)
    res = {"shape": [B, T], "regime": "interarrival 1.0 s, keep_warm 0.95 s"}
    for dtype in (torch.float32, torch.float64):
        args, kwd, err = scan_check("full size", t0, warm, cold, kw, dtype)
        worst = max(worst, err)
        kw_rows = torch.full((B,), kw, dtype=dtype, device=DEV)
        par = cold_scan_parallel(*args, kw_rows)
        if not torch.equal(par, cold_scan_plain(*args, kw_rows)):
            raise AssertionError("cold_scan_parallel disagrees at full size")
        ms = device_ms(lambda: cold_scan(*args, kw_rows))
        plain_ms = device_ms(lambda: cold_scan_plain(*args, kw_rows), runs=1, reps=3)
        par_ms = device_ms(lambda: cold_scan_parallel(*args, kw_rows), runs=2, reps=5)
        nbytes = cold_scan_bytes(B, T, dtype)
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = 3 * B * T / PEAK_FLOPS[torch.float32] * 1e3  # sub, compare, select
        bound = max(t_bytes, t_ops)
        key = str(dtype)[6:]
        res[key] = {"ms": ms, "plain_ms": plain_ms, "parallel_ms": par_ms,
                    "bound_ms": bound,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "max_abs_err": err,
                    "tolerance": COLD_SCAN_TOL, "library_ms": None}
        log(f"[cold_scan]   {key}: kernel {ms * 1e3:.1f} us | plain "
            f"{plain_ms * 1e3:.1f} us | cold_scan_parallel {par_ms * 1e3:.1f} us | "
            f"bound {bound * 1e3:.2f} us (bytes: {nbytes / 1e6:.1f} MB) | "
            f"{bound / ms * 100:.1f}% of the bound | library: none")
    res["max_abs_err"] = worst  # over every case, both dtypes
    return res


# ---------------------------------------------------------------------------
# phase 9: the batched simulator at full size
# ---------------------------------------------------------------------------
def fig4_placements(steps):
    """All 4^4 assignments of the Fig-4 DAG's steps to the paper's platforms."""
    plats = [p.name for p in SIM.paper_platforms()]
    return [tuple(replace(s, platform=p) for s, p in zip(steps, combo))
            for combo in itertools.product(plats, repeat=len(steps))]


def zero_sigma(steps):
    return [replace(s, compute=SIM.Dist(s.compute.median, 0.0),
                    fetch=SIM.Dist(s.fetch.median, 0.0)) for s in steps]


def zero_platforms():
    return [replace(p, cold_start=SIM.Dist(p.cold_start.median, 0.0))
            for p in SIM.paper_platforms()]


def numpy_sweep(sim, spec, placements):
    """The numpy backend over the same sweep: one experiment per
    placement (all seeds), (S, P, n)."""
    return np.stack([sim.simulate(replace(spec, steps=p), backend="numpy")
                     for p in placements], axis=1)


def timed_sweep(sim, spec, placements, dtype):
    t0 = time.perf_counter()
    out = sim.simulate_placements(spec, placements, dtype=dtype, device=DEV)
    return out, time.perf_counter() - t0


def phase_sim() -> dict:
    steps, edges = document_dag_fig4()
    res = {}
    n, seeds = SIM_REQUESTS, tuple(range(SIM_SEEDS))
    sweeps = 0

    # (a) sigma 0: no randomness survives, so the backends agree to 1e-9
    zsteps = zero_sigma(steps)
    zpl = fig4_placements(zsteps)
    sim = SIM.WorkflowSimulator(zero_platforms(), seed=0)
    spec = SIM.ExperimentSpec(zpl[0], edges=edges, n_requests=n, seeds=seeds)
    got, wall = timed_sweep(sim, spec, zpl, np.float64)
    sweeps += 1
    want = numpy_sweep(sim, replace(spec, seeds=(0,)), zpl)
    diff = float(np.abs(got - want).max())
    log(f"[sim] (a) sigma 0: {len(seeds)} seeds x {len(zpl)} placements x {n} "
        f"requests, f64 on {DEV} ({wall:.3f} s) vs numpy: max |diff| {diff:.3g}")
    if not diff <= 1e-9:
        raise AssertionError(f"sigma-0 totals differ from numpy by {diff}")
    res["a_sigma0_max_abs_diff"] = diff

    # (b) calibrated spread; (d) walls
    pl = fig4_placements(steps)
    sim = SIM.WorkflowSimulator(SIM.paper_platforms(), seed=0)
    spec = SIM.ExperimentSpec(pl[0], edges=edges, n_requests=n, seeds=seeds)
    walls = {}
    for dt in (np.float64, np.float32):
        name = np.dtype(dt).name
        if DEV.type == "cuda":
            torch.cuda.reset_peak_memory_stats(DEV)
        out, walls[f"{name}_first_s"] = timed_sweep(sim, spec, pl, dt)
        out2, walls[f"{name}_warm_s"] = timed_sweep(sim, spec, pl, dt)
        sweeps += 2
        if not np.array_equal(out, out2):
            raise AssertionError("the sweep is not deterministic")
        if out.shape != (len(seeds), len(pl), n) or not np.isfinite(out).all():
            raise AssertionError(f"bad sweep output {out.shape}")
        if dt is np.float64:
            got = out
        peak = (torch.cuda.max_memory_allocated(DEV) / 1e9
                if DEV.type == "cuda" else float("nan"))
        log(f"[sim] (d) {name}: first call {walls[f'{name}_first_s']:.3f} s, "
            f"warm call {walls[f'{name}_warm_s']:.3f} s, peak device memory "
            f"{peak:.2f} GB")
        walls[f"{name}_peak_gb"] = peak
    t_np = time.perf_counter()
    want = numpy_sweep(sim, spec, pl)
    walls["numpy_s"] = time.perf_counter() - t_np
    med_t, med_n = np.median(got, axis=(0, 2)), np.median(want, axis=(0, 2))
    rel = np.abs(med_t / med_n - 1)
    p99_t, p99_n = np.percentile(got, 99), np.percentile(want, 99)
    p99_rel = abs(p99_t / p99_n - 1)
    log(f"[sim] (b) calibrated: {len(pl)} placements, medians within "
        f"{rel.max() * 100:.3f}% of numpy (worst placement), pooled p99 "
        f"{p99_t:.4f} s vs {p99_n:.4f} s ({p99_rel * 100:.3f}%)")
    log(f"[sim] (d) numpy backend, same sweep on this host: {walls['numpy_s']:.2f} s "
        f"({walls['numpy_s'] / walls['float64_warm_s']:.1f}x the f64 warm call, "
        f"{walls['numpy_s'] / walls['float32_warm_s']:.1f}x the f32 warm call)")
    if not (rel <= 0.01).all() or p99_rel > 0.01 or len(pl) < 32:
        raise AssertionError(f"torch vs numpy beyond 1%: medians {rel.max()}, "
                             f"p99 {p99_rel}")
    res.update({"b_median_max_rel": float(rel.max()), "b_p99_rel": p99_rel,
                "walls": walls})

    # (d) device busy share of one warm call, per dtype
    for dt in (np.float64, np.float32):
        wall, kernels, _ = _profiled(
            lambda: sim.simulate_placements(spec, pl, dtype=dt, device=DEV))
        sweeps += 1
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
        name = np.dtype(dt).name
        log(f"[sim] (d) profile {name} warm call: wall {wall * 1e3:.2f} ms, device "
            f"busy {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%)")
        if not kernels:
            log("[sim]   device time not measured: the profiler recorded no kernels")
        for kname, ks in top:
            log(f"[sim]   {ks * 1e3:8.3f} ms  {kname[:90]}")
        res[f"profile_{name}"] = {"wall_s": wall, "device_busy_s": busy,
                                  "top": [[k[:90], v] for k, v in top]}

    # (c) a cold regime: the card's totals equal the CPU's (host-made draws)
    kw = 3.5
    cpl = pl[::16]
    cold_plats = [replace(p, keep_warm_s=kw) for p in SIM.paper_platforms()]
    csim = SIM.WorkflowSimulator(cold_plats, seed=0)
    cspec = SIM.ExperimentSpec(cpl[0], edges=edges, n_requests=512,
                               interarrival_s=6.0, seeds=(0, 1))
    card, _ = timed_sweep(csim, cspec, cpl, np.float64)
    sweeps += 1
    order, _, preds, succs = SIM._spec_graph(cpl[0], edges)
    host, sampled = torchsim.run_batched(
        csim, order, [{s.name: s for s in p} for p in cpl], preds, succs,
        np.arange(512) * 6.0, True, [0, 1], sample_idx=np.arange(512),
        device="cpu")
    share = float((sampled[1] > 0).mean())
    cdiff = float(np.abs(card - host).max())
    log(f"[sim] (c) cold regime (keep_warm {kw} s, interarrival 6 s): "
        f"{len(cpl)} placements x 2 seeds x 512 requests, cold share {share:.3f}; "
        f"card vs CPU f64 totals max |diff| {cdiff:.3g}")
    if not 0.1 <= share <= 0.9:
        raise AssertionError(f"cold share {share} outside 10-90%")
    if not cdiff <= 1e-9:
        raise AssertionError(f"card and CPU totals differ by {cdiff}")
    res.update({"c_cold_share": share, "c_max_abs_diff": cdiff, "sweeps": sweeps,
                "shape": [len(seeds), len(pl), n]})
    return res


# ---------------------------------------------------------------------------
# phase 10: recomposition under drift, gated on the torch scorer
# ---------------------------------------------------------------------------
ADAPT_PLATFORMS = [
    SIM.SimPlatform("client", "edge", native_prefetch=True, allows_sync=True,
                    cold_start=SIM.Dist(0.2, 0.2)),
    SIM.SimPlatform("pA", "region-a", cold_start=SIM.Dist(0.8, 0.3)),
    SIM.SimPlatform("pB", "region-b", cold_start=SIM.Dist(0.8, 0.3)),
]
ADAPT_WORK = {"pA": SIM.Dist(1.0, 0.05), "pB": SIM.Dist(1.3, 0.05)}
ADAPT_SPEC = DagSpec((DagStep("ingest", "client"), DagStep("work", "pA"),
                      DagStep("deliver", "client")),
                     (("ingest", "work"), ("work", "deliver")), "adapt-bench")


def adapt_costs() -> PlacementCosts:
    """The static cost model, calibrated before the drift."""
    compute = {("ingest", "client"): 0.04, ("deliver", "client"): 0.04,
               ("work", "pA"): 1.0, ("work", "pB"): 1.3}
    return PlacementCosts(
        fetch_s=lambda name, p, deps: 0.0,
        compute_s=lambda name, p: compute.get((name, p), 0.05),
        transfer_s=lambda a, b, size: 0.001 if a == b else 0.6,
        payload_size=1.5e6)


def adapt_stream(n, drift, scorer=None, adaptive=True, seed=11):
    """The JAX package's simulated adapt scenario (benchmarks/adapt_bench.py)
    on the port: (totals, swaps, controller wall s)."""
    hub = TelemetryHub(alpha=0.4)
    sim = SIM.WorkflowSimulator(ADAPT_PLATFORMS, seed=seed,
                                telemetry=hub if adaptive else None, drift=drift)
    ctrl = RecompositionController(
        hub, adapt_costs(), {"work": ["pA", "pB"]},
        regions={"client": "edge", "pA": "region-a", "pB": "region-b"},
        every_n=8, drift_ratio=1.4, min_samples=2, scorer=scorer)
    spec, totals, swaps, ctrl_s = ADAPT_SPEC, np.empty(n), [], 0.0
    for k in range(n):
        wp = spec.node("work").platform
        steps = [SIM.SimStep("ingest", "client", compute=SIM.Dist(0.04, 0.05)),
                 SIM.SimStep("work", wp, compute=ADAPT_WORK[wp]),
                 SIM.SimStep("deliver", "client", compute=SIM.Dist(0.04, 0.05))]
        totals[k] = sim.run_request(steps, k * 1.0, prefetch=True).total_s
        if adaptive:
            t0 = time.perf_counter()
            placement = ctrl.tick(spec)
            ctrl_s += time.perf_counter() - t0
            if placement is not None:
                spec = spec.apply_placement(placement)
                swaps.append((k, placement))
    return totals, swaps, ctrl_s


def phase_adapt() -> dict:
    n = ADAPT_REQUESTS
    drift = SIM.DriftSchedule([SIM.DriftEvent(n // 2, "pA", compute_scale=5.0)])
    static, _, _ = adapt_stream(n, drift, adaptive=False)
    scorer = PlacementScorer(quantile=0.9, backend="torch", device=DEV)
    adaptive, swaps, ctrl_s = adapt_stream(n, drift, scorer=scorer)

    def steady(t):
        return float(np.median(t[-(len(t) // 4):]))

    s_static, s_adapt = steady(static), steady(adaptive)
    recovery = 1.0 - s_adapt / s_static
    res = {"static_post_drift_s": s_static, "adaptive_post_drift_s": s_adapt,
           "recovery": recovery, "swaps": [[k, p] for k, p in swaps],
           "controller_wall_s": ctrl_s}
    log(f"[adapt] {n} requests, pA compute x5 at {n // 2}: post-drift median "
        f"static {s_static:.4f} s, adaptive {s_adapt:.4f} s (recovery "
        f"{recovery * 100:.1f}%); swaps {swaps}; controller wall {ctrl_s:.3f} s")
    if recovery < 0.25 or not swaps:
        raise AssertionError(f"recomposition missed the 25% bar: {res}")
    return res


# ---------------------------------------------------------------------------
# the serving paths of the three models
# ---------------------------------------------------------------------------
MODEL_KERNELS = {"flash_attention": flash_attention, "ssd_scan": ssd_scan,
                 "rglru_scan": rglru_scan, "rmsnorm": rmsnorm}
SERVED = ("qwen3-1.7b", "mamba2-370m", "recurrentgemma-9b", "granite-moe-3b-a800m")
WINDOW_PROMPT = 2500  # recurrentgemma-9b: past its 2048-token window
WINDOW_DECODE = 8


def launches_per_prefill(cfg) -> dict:
    """One launch per layer of the kernel's block kind; rmsnorm once per
    norm: norm1 (attention and rglru blocks), q_norm and k_norm (qk_norm),
    the ssd block's norm and norm_y, norm2 (where d_ff), the final norm. A
    decode step launches rmsnorm as often as a prefill, and nothing else."""
    kinds = cfg.layer_kinds()
    attn = sum(k in ("global", "local") for k in kinds)
    norms = (attn * (1 + 2 * bool(cfg.qk_norm)) + kinds.count("rglru")
             + 2 * kinds.count("ssd") + bool(cfg.d_ff) * len(kinds) + 1)
    return {"flash_attention": attn, "ssd_scan": kinds.count("ssd"),
            "rglru_scan": kinds.count("rglru"), "rmsnorm": norms}


def launch_counts() -> dict:
    return {n: k.launches for n, k in MODEL_KERNELS.items()}


class counting_passes:
    """Counts the model's forward passes (``M.prefill``, ``M.decode_step``)
    while active, from any thread: the federated decode step is pre-warmed
    in a background thread."""

    def __enter__(self):
        self.n = {"prefill": 0, "decode": 0}
        self._saved = (M.prefill, M.decode_step)
        self._lock = threading.Lock()

        def counted(kind, fn):
            def call(*a, **k):
                with self._lock:
                    self.n[kind] += 1
                return fn(*a, **k)
            return call
        M.prefill = counted("prefill", self._saved[0])
        M.decode_step = counted("decode", self._saved[1])
        return self

    def __exit__(self, *exc):
        M.prefill, M.decode_step = self._saved
        return False


def phase_window(cfg, params):
    """A prompt past the local layers' window: prefill's flash_attention
    masks by the window at d=256, the local caches come back as ring
    buffers, and decode writes past the ring's wrap. Kernel-path against
    plain-path logits at prefill and at every decode step (fed the same
    tokens)."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, cfg.vocab_size, size=WINDOW_PROMPT).astype(np.int32)
    tokens = torch.as_tensor(prompt, device=DEV)[None]
    max_len = WINDOW_PROMPT + WINDOW_DECODE
    paths = {}
    for name, c in (("kernel", cfg), ("plain", cfg.replace(use_pallas=False))):
        logits, caches = M.prefill(c, params, {"tokens": tokens})
        caches = pad_cache(caches, max_len, WINDOW_PROMPT, cfg=c)
        paths[name] = [c, caches, [logits]]
    ring = [t.shape[2] for t in tree_leaves(paths["kernel"][1]["cycle"]["p2"])]
    if ring != [cfg.local_window] * 2:
        raise AssertionError(f"local caches are not {cfg.local_window}-slot ring "
                             f"buffers: {ring}")
    tok = greedy(paths["kernel"][2][0])
    for i in range(WINDOW_DECODE):
        t = torch.tensor([[tok]], dtype=torch.int32, device=DEV)
        for c, caches, out in paths.values():
            out.append(M.decode_step(c, params, t, caches, WINDOW_PROMPT + i)[0])
        tok = greedy(paths["kernel"][2][-1])
    sync()
    worst = 0.0
    for i, (k, p) in enumerate(zip(paths["kernel"][2], paths["plain"][2])):
        diff = (k - p).abs().max().item()
        scale = p.abs().max().item()
        worst = max(worst, diff / scale)
        if not diff <= TOL[torch.bfloat16] * scale:
            raise AssertionError(f"window check, step {i}: kernel-path logits "
                                 f"differ from the plain path: {diff} > "
                                 f"{TOL[torch.bfloat16]} * {scale}")
    log(f"[checks] window: prompt {WINDOW_PROMPT} > window {cfg.local_window}, "
        f"ring buffers of {ring[0]} slots, prefill + {WINDOW_DECODE} decode steps "
        f"(positions {WINDOW_PROMPT}..{WINDOW_PROMPT + WINDOW_DECODE - 1}, ring "
        f"slots {WINDOW_PROMPT % cfg.local_window}..): kernel vs plain logits, "
        f"worst max_abs_diff / max_abs_logit {worst:.4g} (tol "
        f"{TOL[torch.bfloat16]:g}) ok")
    return {"prompt": WINDOW_PROMPT, "decode_steps": WINDOW_DECODE,
            "worst_rel_diff": worst}


def phase_moe(cfg, params, prompt) -> dict:
    """MoE routing, off the counted path. (a) Kernel path against plain
    path prefill: the (token, choice) routings that differ, layer by layer
    (a last-bit difference in a norm's output can flip a near-tie of the
    router; these are reported, not hidden), and the choices each path
    drops at the prompt's capacity. (b) One batched decode step of
    ServingEngine with 4 slots: 4 tokens at capacity
    C = max(1, int(4 * top_k / E * capacity_factor)), the dropped (token,
    choice) pairs per layer (the JAX package's behaviour)."""
    tokens = torch.as_tensor(prompt, device=DEV)[None]
    routes, logits = {}, {}
    for name, c in (("kernel", cfg), ("plain", cfg.replace(use_pallas=False))):
        with recording_routes() as rec:
            logits[name], _ = M.prefill(c, params, {"tokens": tokens})
        routes[name] = rec.calls
    diff = (logits["kernel"] - logits["plain"]).abs().max().item()
    argmax = {n: greedy(lg) for n, lg in logits.items()}
    flips = [int((k[0] != p[0]).sum()) for k, p in zip(routes["kernel"],
                                                      routes["plain"])]
    pairs = routes["kernel"][0][0].numel()
    drops = {n: sum(int(r[1].sum()) for r in rs) for n, rs in routes.items()}
    C_pre = routes["kernel"][0][2]
    rng = np.random.default_rng(4)
    eng = ServingEngine(cfg, params, max_batch=4, max_len=MAX_LEN, device=DEV)
    for i, n in enumerate(rng.integers(BATCH_PROMPTS[0], BATCH_PROMPTS[1] + 1,
                                       size=4)):
        eng.submit(Request(i, rng.integers(1, cfg.vocab_size, size=int(n))
                           .astype(np.int32), max_new_tokens=NEW_TOKENS))
    eng._admit()
    with recording_routes() as rec:
        eng._decode_once()
    sync()
    dec_drops = [int(r[1].sum()) for r in rec.calls]
    C_dec = rec.calls[0][2]
    res = {"prefill_tokens": len(prompt), "prefill_capacity": C_pre,
           "routing_flips_per_layer": flips, "routing_flips": sum(flips),
           "pairs_per_layer": pairs, "prefill_drops": drops,
           "decode_capacity": C_dec, "decode_drops_per_layer": dec_drops,
           "decode_drops": sum(dec_drops),
           "decode_pairs": rec.calls[0][0].numel() * len(rec.calls),
           "unpinned_max_abs_diff": diff,
           "unpinned_max_abs_logit": logits["plain"].abs().max().item(),
           "unpinned_argmax": argmax}
    log(f"[moe] prefill {len(prompt)} tokens, capacity {C_pre}: kernel vs plain "
        f"path, {sum(flips)} of {pairs * len(flips)} (token, choice) routings "
        f"differ (per layer {flips}); dropped choices kernel "
        f"{drops['kernel']}, plain {drops['plain']}; each path on its own "
        f"experts: logits max_abs_diff {diff:.4g} of max_abs_logit "
        f"{res['unpinned_max_abs_logit']:.4g}, argmax {argmax['kernel']} vs "
        f"{argmax['plain']} (reported, not gated: phase_checks pins the experts)")
    log(f"[moe] one batched decode step (4 slots, capacity {C_dec}): "
        f"{res['decode_drops']} of {res['decode_pairs']} (token, choice) pairs "
        f"dropped (per layer {dec_drops})")
    if len(flips) != cfg.num_layers or len(dec_drops) != cfg.num_layers:
        raise AssertionError(f"expected {cfg.num_layers} MoE layers, recorded "
                             f"{len(flips)} and {len(dec_drops)}")
    return res


def serve_model(arch) -> dict:
    """The serving path of one model at full width: the federated workflow
    and continuous batching with every kernel counter at 0 just before and
    read just after, then the checks and the profile off the counted path."""
    cfg = get_config(arch).replace(use_pallas=True)
    params = make_params(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_PROMPTS]
    per_prefill = launches_per_prefill(cfg)

    for k in MODEL_KERNELS.values():
        k.launches = 0
    with counting_passes() as passes:
        requests = phase_federated(cfg, params, prompts)
        fed, fed_passes = launch_counts(), dict(passes.n)
        batching = phase_batching(cfg, params)
        total = launch_counts()
    n_batched = batching["prefills"] + 1  # + the prewarm prefill
    n_pass = passes.n["prefill"] + passes.n["decode"]
    log(f"[serving] {arch} launches per prefill {per_prefill}: federated {fed} "
        f"over {len(prompts)} prefills; batching "
        f"{ {n: total[n] - fed[n] for n in total} } over {n_batched} prefills; "
        f"forward passes {passes.n} (federated {fed_passes})")
    if passes.n["prefill"] != len(prompts) + n_batched:
        raise AssertionError(f"{arch}: {passes.n['prefill']} prefills counted, "
                             f"{len(prompts) + n_batched} made")
    for n, want in per_prefill.items():
        if n == "rmsnorm":  # every forward pass, prefill or decode
            if total[n] != want * n_pass:
                raise AssertionError(f"{arch}: {total[n]} rmsnorm launches != "
                                     f"{want} per pass over {n_pass} passes")
            continue
        if fed[n] != want * len(prompts):
            raise AssertionError(f"{arch}: {fed[n]} {n} launches != {want} per "
                                 f"prefill over {len(prompts)} prefills")
        if total[n] - fed[n] != want * n_batched:
            raise AssertionError(f"{arch}: batched prefills did not each launch "
                                 f"{n} {want} times")

    moe = phase_moe(cfg, params, prompts[1]) if cfg.num_experts else None
    phase_checks(cfg, params, prompts[1])
    window = (phase_window(cfg, params) if "local" in cfg.block_pattern
              else None)
    profile = phase_profile(cfg, params, prompts[0])
    norm_ab = phase_norm_ab(cfg, params, prompts[0])
    del params
    torch.cuda.empty_cache()
    return {"arch": arch, "requests": requests, "batching": batching,
            "profile": profile, "launches": total, "passes": passes.n,
            "per_prefill": per_prefill, "window": window, "moe": moe,
            "norm_ab": norm_ab}


def main():
    smi = phase_device()
    phase_build()
    fa = phase_kernels()
    ssd = phase_ssd_scan()
    rg = phase_rglru_scan()
    cs = phase_cold_scan()

    rn = phase_rmsnorm()

    served = [serve_model(arch) for arch in SERVED]

    # the simulator's path: 4 nodes, so one cold_scan launch per node per sweep
    cold_scan.launches = 0
    sim = phase_sim()
    sim_launches = cold_scan.launches
    log(f"[sim] cold_scan launches: {sim_launches} over {sim['sweeps']} sweeps "
        f"on {DEV}")
    if sim_launches != 4 * sim["sweeps"]:
        raise AssertionError(f"{sim_launches} cold_scan launches != 4 per sweep")
    # the recomposition path: the scorer's sweeps launch the kernel
    cold_scan.launches = 0
    adapt = phase_adapt()
    adapt_launches = cold_scan.launches
    log(f"[adapt] cold_scan launches: {adapt_launches}")
    if adapt_launches == 0:
        raise AssertionError("the torch scorer never launched cold_scan")

    def model_launches(name):
        return sum(m["launches"][name] for m in served)

    cs64, cs32 = cs["float64"], cs["float32"]
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:88",
        "launches": model_launches("flash_attention"),
        "max_abs_err": fa["max_abs_err"],
        "tolerance": fa["tolerance"], "ms": fa["ms"], "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"],
    }, {
        "name": "cold_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cold_scan.cu",
        "replaces": "src/repro/kernels/cold_scan.py:83",
        "launches": sim_launches + adapt_launches, "dtype": "float64",
        "shape": cs["shape"], "max_abs_err": cs["max_abs_err"],
        "tolerance": COLD_SCAN_TOL, "ms": cs64["ms"],
        "plain_ms": cs64["plain_ms"], "parallel_ms": cs64["parallel_ms"],
        "bound_ms": cs64["bound_ms"], "bound_by": cs64["bound_by"],
        "library_ms": None,
        "float32": {k: cs32[k] for k in ("ms", "plain_ms", "parallel_ms",
                                         "bound_ms", "bound_by")},
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:71",
        "launches": model_launches("ssd_scan"), "dtype": "bfloat16",
        "shape": [1, 512, 32, 64, 128, 256], "max_abs_err": ssd["max_abs_err"],
        "tolerance": ssd["tolerance"], "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
        "library_ms": None,
    }, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:49",
        "launches": model_launches("rglru_scan"), "dtype": "float32",
        "shape": rg["shape"], "max_abs_err": rg["max_abs_err"],
        "tolerance": rg["tolerance"], "ms": rg["ms"], "plain_ms": rg["plain_ms"],
        "yardstick_ms": rg["yardstick_ms"], "bound_ms": rg["bound_ms"],
        "bound_by": rg["bound_by"], "library_ms": None,
    }, {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:24",
        "launches": model_launches("rmsnorm"), "dtype": "bfloat16",
        "shape": rn["shape"], "max_abs_err": rn["max_abs_err"],
        "tolerance": rn["tolerance"], "ms": rn["ms"], "plain_ms": rn["plain_ms"],
        "bound_ms": rn["bound_ms"], "bound_by": rn["bound_by"],
        "library_ms": rn["library_ms"],
        "library": "torch.nn.functional.rms_norm on the float32 input",
    }]
    for m in served:
        log(json.dumps({"serving": m}))
    log(json.dumps({"sim": sim, "adapt": adapt, "cold_scan": cs}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
