"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result):
  1. device   the card's name and power limit (nvidia-smi); TF32 off
  2. build    nvcc builds every CUDA kernel of the port from csrc/ into
              build/torch_kernels/ (one nvcc per source, all in parallel);
              registers and spill stores of every kernel function
  3. kernels  each model kernel against its plain PyTorch version on the
              card, at the serving path's shapes and edge cases:
              flash_attention (every served model's prefill shape, timed:
              qwen3-1.7b, granite, recurrentgemma's local layers,
              llama3.2-3b, gemma3-27b's local layers, qwen3-32b, moonshot,
              llava-next-34b's 1152 patches + 512 tokens, hubert-xlarge's
              d = 80 non-causal frames; recurrentgemma's and gemma3's local
              layers past the window; the wgmma kernel's edges: T = 1,
              T < 64, T != S, GQA 3 and 16 with ragged T, B = 2 with a
              ragged S, a window inside one kv tile, long kv walks with
              ragged T; every other head dim the Pallas kernel takes, d =
              48-240 on the mma.sync and float32 kernels), ssd_scan (the JAX
              package's kernel-test cases in f32 and bf16, the serving
              dtypes, Q == L, 4 chunks, a chunk of 96 that fills no whole
              C·Bᵀ tile), rglru_scan (the kernel-test cases, T = 300,
              ragged W), rmsnorm (the kernel-test shapes, every served
              width, mixed x/w dtypes, misaligned rows; the add and SiLU-gate
              prologues, add_rmsnorm and gated_rmsnorm, at every served
              width, mixed and misaligned, the gate's z a column slice as
              in mamba2); timings (CUDA events over 20 back-to-back calls,
              median of 20) beside the plain version, the library call
              (F.rms_norm for rmsnorm) or a yardstick (torch.cumsum for
              rglru_scan), and the bound; rmsnorm also at the decode
              shapes (1 and 4 rows of 1024, 1536, 2048, 4096 and qwen3's
              4-slot qk-norm, 64 x 128); then the widths of the models
              served since (1280-7168) at prefill and decode, and gemma3's
              and qwen3-32b's qk-norm rows
  Phases 4-7 run for the ten configs in turn (SERVED: qwen3-1.7b,
  mamba2-370m, recurrentgemma-9b, granite-moe-3b-a800m, llama3.2-3b,
  gemma3-27b, qwen3-32b, moonshot-v1-16b-a3b, llava-next-34b,
  hubert-xlarge), each at full width and depth, random weights from seed
  0 drawn in their serving dtypes (M.init_serving_params; the draw's peak
  allocation gated at the serving bytes + the largest float32 piece + 1
  GB), the card's peak allocation logged after each phase, each model's
  weights freed before the next loads:
  4. serving  3 requests through the federated prefill -> decode workflow
              (Deployment over two platforms, caches shipped through the
              object store); the decode step is pre-warmed by the poke.
              llava-next-34b's requests carry 1152 patch embeddings and
              hubert-xlarge's 512 frames as a step's data dependency in the
              store: a client ingest step pokes prefill (encode), whose
              prefetch copies them to the card, checked bit-exact; hubert,
              an encoder, runs ingest -> encode and no decode
  5. batching the same model (a decoder) under ServingEngine's continuous
              batching of token prompts;
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
              whichever is larger) at full depth and in float32 (1e-4),
              cut in depth to the first cycle of block_pattern (2 layers
              for a one-kind pattern) at full width where a float32 copy
              would not fit beside the weights, an MoE's plain path on the
              kernel path's experts; llava's prefill takes its patches,
              hubert's its frames; for recurrentgemma-9b and gemma3-27b a
              2500-token prompt past the window, then 8 decode steps
              through every local layer's ring buffer, kernel against
              plain path at every step; the prefetcher's side-stream copy
              to the card, bit-exact
  7. profile  torch.profiler over one warm prefill and (a decoder) 8
              decode steps: device busy share, device kernels per prefill
              and per decode step, the kernels that take the device time
              and the ops that launched them, the port's own kernels by
              name; then, for the first four models only, the same
              warm prefill and 4 decode steps on the host clock, in turns,
              with the norms through the rmsnorm kernel and through the
              plain version, and with the residual adds and mamba2's gate
              fused into the norm kernel's launches and composed of eager
              ops around it (with each variant's kernels per decode step)
  8. cold_scan the simulator's kernel against its plain version on the card,
              exactly, in float32 and float64: the cases of the JAX
              package's kernel tests, keep_warm per row, gaps within an f32
              ulp, cold ends before warm ends, NaN and +-inf ends, T off
              the tile and the vector width, rows split into chunks of one
              and of several tiles, and the full-size case (B = T = 4096),
              timed beside the plain version, the parallel (log-depth)
              version and the bound; after phase 10, the scorer's own
              (B, T), timed
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
 11. obs      the observability plane: (a) the Fig-4 DAG, 16 seeds x 4096
              requests on the card with Tracer(sample=64) and without, in
              turns: totals equal exactly, each trace's critical-path
              attribution sums to its total (rel 1e-9), sigma-0 traces equal
              the numpy backend's node by node (atol 1e-9), 4 cold_scan
              launches a call, warm walls; (b) after qwen3-1.7b's phases 4-7,
              on its loaded weights, the federated workflow under
              instrument() with a MetricsRegistry, a TailSampler and an
              SloTracker, untraced and traced turns of 3 requests: the
              critical path is prefill -> decode and explains total_s within
              5%, a side-stream prefetch lands its events on the bound span,
              the Chrome trace (build/chip_smoke_obs_trace.json) parses back
              with every span, exact kernel launches, total_s traced against
              untraced (reported); (c) calibrate() from (b)'s last trace and
              WhatIfProfiler on the card (torch) against numpy: the same
              ranking, predictions and deltas within 1e-9 relative; (d) phase
              10's drift scenario on the real engine behind
              AdaptiveDeployment(tracer=..., slo=...): the swap's
              recompose.decision and cutover events land in the tracer's ring
 12. jobs     on qwen3-1.7b's weights, a JobManager over the same workflow
              with decode failing 30% of attempts, 3 attempts and a hedge
              after half a decode: 4 client threads submit 8 prompts twice
              each; kept + dead-lettered == submitted, every kept job's
              tokens equal an unfaulted run's, a resubmitted completed job
              dedups, a job timed out short of one decode dead-letters with
              status "timeout"; exact kernel launches
 13. train    the training path (the JAX package's plain numerics: its
              Pallas kernels have no backward, and the port's wrappers
              raise under grad): (a) qwen3-1.7b at full width and depth,
              Trainer.run for 16 steps of 8 x 256 tokens, float32 master
              params and bf16 compute, pre-warmed through CompileCache
              (params and optimizer state unchanged across it, by word
              sums and version counters), batches pre-fetched on a side
              stream, the final checkpoint (20.6 GB) written and timed;
              every loss and grad norm finite, the last 4 steps' mean loss
              below the first 4's, no port kernel launched; the warm step,
              tokens/s, peak memory, one step under torch.profiler; (d) on
              those weights each kernel wrapper raises when an input
              requires grad, and forward_train with use_pallas=True under
              no_grad launches flash_attention and rmsnorm exactly (28,
              113) with the plain path's loss within 2e-2 relative; (b)
              one float32 make_train_step step at full width cut to 2
              layers (qwen3-1.7b, also with 2 microbatches; mamba2-370m;
              granite-moe-3b-a800m) on the card against the same step on
              the CPU: loss 1e-5 and grad norm 1e-4 relative, m and v 1e-4
              of each leaf's largest entry, the params as
              tests/test_torch_train_step.py holds them; (c) the restart
              drill at that depth in bf16: 12 straight steps against 6, a
              fresh Trainer on the same directory, 6 more (rtol 1e-5)
 14. mesh     distribution: (a) after qwen3-1.7b's phases 4-7, on its
              weights as DTensors on make_host_mesh() ((1, 1) on one card),
              the README Quickstart's topology (an edge client without a
              mesh, prefill and decode clouds bound to the mesh): the
              federated workflow and ServingEngine's batching with
              use_pallas, exact kernel launches, every request's tokens
              equal to phases 4-5's; a prefill and 8 decode steps unmeshed
              and meshed in turns (walls reported, logits at the bf16 gate);
              (b) after phase 13, Trainer(mesh=make_host_mesh()) on
              qwen3-1.7b for 4 steps, remesh onto a new host mesh (params,
              m, v, count bit-identical), 4 more, the losses equal phase
              13's first 8 (rtol 1e-5); (c) the dry-run of four cells
              (qwen3-1.7b train_4k and decode_32k, granite train_4k,
              recurrentgemma prefill_32k) on the fake 256- and 512-GPU
              meshes, in a subprocess started after the build (it shares
              the host's cores with phases 3-14), one roofline line a
              cell, the invariants of tests/test_dryrun.py
Then one JSON line describing every kernel (launches counted over the main
paths: serving and batching of the ten models, phases 11 (b) and 12,
training and 13 (d)'s forward, and phase 14's meshed serving and training
for flash_attention, ssd_scan, rglru_scan and rmsnorm, the simulator, the
recomposition and phase 11's (a, c, d) for cold_scan), the card's name and
power limit, and the last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --only kernels,ssd_scan

runs phases 1-2 and the named ones of kernels, ssd_scan, rglru_scan,
rmsnorm, cold_scan, obs, jobs, train and mesh only (a short call to bring up a
kernel or a phase), prints their results and no final line. ``--only tile_cost``
times one kv tile of the wgmma flash kernel at d = 64, 128, 256, a
diagnostic no default run makes.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import os
import re
import shutil
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
                              StreamConfig, TensorSpec, WorkflowSpec, DataRef)
from repro_torch.adapt import (  # noqa: E402
    AdaptiveDeployment, PlacementScorer, RecompositionController, TelemetryHub)
from repro_torch.core import simulator as SIM  # noqa: E402
from repro_torch.core import torchsim  # noqa: E402
from repro_torch.core.shipping import PlacementCosts  # noqa: E402
from repro_torch.dag import (DagDeployment, DagSpec, DagStep,  # noqa: E402
                             document_dag_fig4)
from repro_torch.jobs import (FaultEvent, FaultSchedule, JobManager,  # noqa: E402
                              RetryPolicy)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.cold_scan import (  # noqa: E402
    cold_scan, cold_scan_parallel, cold_scan_plain, cold_scan_plan)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    WGMMA_HEAD_DIMS, flash_attention, flash_attention_plain)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    add_rmsnorm, add_rmsnorm_plain, gated_rmsnorm, gated_rmsnorm_plain, rmsnorm,
    rmsnorm_plain)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402
from repro_torch.models import griffin as GRIFFIN  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import ParamDef  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    _is_spec, add_norm, cache_defs, cast_params, embed_inputs, run_blocks, unembed)
from repro_torch.models.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.obs import (MetricsRegistry, SloSpec, SloTracker,  # noqa: E402
                             TailSampler, Tracer, WhatIfProfiler, calibrate,
                             extract_critical_path, instrument, write_chrome_trace)
from repro_torch.serving import Request, ServingEngine, pad_cache  # noqa: E402
from repro_torch.data import SyntheticCorpus, make_train_iterator  # noqa: E402
from repro_torch.core import bind_sharding  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

DEV = torch.device("cuda:0")
HBM_BPS = 3.35e12  # H100 SXM device memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
MAX_LEN = 1024
NEW_TOKENS = 16
SERVE_PROMPTS = (512, 300, 512)  # federated requests: cold, then warm
ENCODER_FRAMES = 512  # hubert-xlarge: frames of a request (a ~10 s clip)
INIT_SLACK = 1e9  # the init peak's allowance beyond its two named parts
BATCH_PROMPTS = (256, 512)  # continuous batching: prompt lengths drawn here
KERNELS = ("flash_attention", "flash_attention_mma", "flash_attention_f32",
           "cold_scan", "ssd_scan", "rglru_scan", "rmsnorm")  # one nvcc each
SIM_SEEDS = 16  # the full-size sweep: 16 seeds x 256 placements x 4096 requests
SIM_REQUESTS = 4096
COLD_SCAN_FULL = (4096, 4096)  # (B, T) of one node of that sweep
COLD_SCAN_TOL = 0  # the mask must equal the plain version's: |got - want| <= 0
ADAPT_REQUESTS = 1200


def log(msg=""):
    print(msg, flush=True)


KEEP_GOING = False  # --only: a failed kernel case is recorded, not raised
FAILURES = []


def fail(msg):
    if not KEEP_GOING:
        raise AssertionError(msg)
    FAILURES.append(msg)
    log(f"[FAIL] {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize(DEV)


def device_ms(fn, runs=20, reps=20, sleep=100_000_000) -> float:
    """Device time of one call (ms): ``runs`` calls queued back to back
    behind a sleep kernel, so the host's launch overhead does not leave the
    card idle between them; CUDA events around the run; median over ``reps``
    such runs, after a warm-up. Inputs stay in L2, as a prefill's fresh q/k/v
    do. ``sleep``: clock cycles to enqueue in (the default ~50 ms)."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(sleep)
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


def kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel in an anonymous namespace."""
    at = 3 if mangled.startswith("_ZN") else 2
    name = ""
    while at < len(mangled) and mangled[at].isdigit():
        m = re.match(r"\d+", mangled[at:])
        n, at = int(m.group(0)), at + m.end()
        name, at = mangled[at:at + n], at + n
        if not name.startswith("_GLOBAL__N"):
            break
    if not name:
        return mangled
    rest = mangled[at:]
    if rest.startswith("I"):
        # template arguments: ints, bools, and the element types (bfloat16
        # as __nv_bfloat16, or as its bits, uint16_t "t")
        tok = re.compile(r"Li(-?\d+)E|Lb([01])E|13__nv_bfloat16|([fdt])")
        words = {"f": "float", "d": "double", "t": "bf16"}
        args, i = [], 1
        while i < len(rest) and rest[i] != "E":
            m = tok.match(rest, i)
            if not m:
                break
            i = m.end()
            args.append(m.group(1) if m.group(1) is not None else
                        ("true" if m.group(2) == "1" else "false") if m.group(2)
                        else words.get(m.group(3), "bf16"))
        name += "<" + ",".join(args) + ">"
    return name


def ptxas_kernels(log_text: str) -> dict:
    """{kernel: (registers, spill store bytes)} from ``ptxas -v`` output."""
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = kernel_name(m.group(1))
            out[cur] = [0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            out[cur][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def phase_build() -> dict:
    t0 = time.perf_counter()
    paths = build.build_all(list(KERNELS))
    dt = time.perf_counter() - t0
    res = {}
    for name, path in paths.items():
        per = ptxas_kernels(build.build_logs.get(name, ""))
        log(f"[build] {name}: {os.path.relpath(path)} "
            f"({build.build_seconds[name]:.1f} s; {len(per)} kernels, "
            f"registers <= {max((r for r, _ in per.values()), default=0)}, spill "
            f"stores <= {max((sp for _, sp in per.values()), default=0)} bytes)")
        for k, (r, sp) in sorted(per.items()):
            if name != "rmsnorm" or sp:  # rmsnorm: 80 kernels, those that spill
                log(f"[build]   {k}: {r} registers, {sp} bytes spill stores")
        if name == "rmsnorm":
            for variant, end in (("narrow", ",false>"), ("wide", ",true>")):
                regs = [r for k, (r, _) in per.items() if k.endswith(end)]
                log(f"[build]   rmsnorm_kernel, {variant} rows: {len(regs)} kernels, "
                    f"{min(regs, default=0)}-{max(regs, default=0)} registers")
        for line in build.build_logs.get(name, "").splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                log(f"[build]   {name}: {line.strip()[:300]}")
        res[name] = {k: {"registers": r, "spill_stores": sp}
                     for k, (r, sp) in per.items()}
    log(f"[build] all kernels built in {dt:.1f} s")
    return res


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
    route = ("f32 CUDA cores" if dtype == torch.float32 else
             "wgmma" if d in WGMMA_HEAD_DIMS else "mma.sync")
    log(f"[kernels] flash_attention {name}: B={B} T={T} S={S} H={H} K={K} d={d} "
        f"{str(dtype)[6:]} causal={causal} window={window} [{route}] "
        f"max_abs_err={err:.3g} tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"flash_attention {name} disagrees with its plain version: "
             f"max_abs_err {err} > tol {tol}")
    res = {"max_abs_err": err, "tolerance": tol, "shape": [B, T, S, H, K, d],
           "window": window}
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


def tile_cost(d, H, K, seed) -> dict:
    """The wgmma kernel's cost of one kv tile: non-causal, whole q tiles,
    128 blocks walking 8 and then 16 kv tiles (T = S = 512 with H heads,
    then 1024 with H/2); the difference over 8 is a tile's time, and the K
    and V bytes those 8 extra tiles of every block load, over it, the rate
    the blocks draw K/V from L2 (each of a kv head's H/K query heads and
    each q tile loads its tiles again)."""
    ms = []
    for T, h in ((512, H), (1024, H // 2)):
        g = torch.Generator(device=DEV).manual_seed(seed)
        q = torch.randn(1, T, h, d, generator=g, device=DEV).to(torch.bfloat16)
        k = torch.randn(1, T, min(K, h), d, generator=g, device=DEV).to(torch.bfloat16)
        v = torch.randn(1, T, min(K, h), d, generator=g, device=DEV).to(torch.bfloat16)
        out = flash_attention(q, k, v, causal=False)
        sync()
        want = flash_attention_plain(q, k, v, causal=False).float()
        if not torch.allclose(out.float(), want, atol=TOL[torch.bfloat16],
                              rtol=TOL[torch.bfloat16]):
            fail(f"flash_attention non-causal T={T} d={d} disagrees with its "
                 "plain version")
        ms.append(device_ms(lambda: flash_attention(q, k, v, causal=False)))
    tile_us = (ms[1] - ms[0]) / 8 * 1e3
    kv_bytes = 128 * 8 * 2 * 64 * d * 2  # 8 more K and V tiles for 128 blocks
    res = {"ms_8_tiles": ms[0], "ms_16_tiles": ms[1], "tile_us": tile_us,
           "kv_tb_per_s": kv_bytes / (tile_us * 8e-6) / 1e12}
    log(f"[kernels]   tile cost, d={d}: 128 blocks x 8 kv tiles {ms[0] * 1e3:.2f} us, "
        f"x 16 {ms[1] * 1e3:.2f} us: {tile_us:.3f} us a tile, K/V drawn at "
        f"{res['kv_tb_per_s']:.2f} TB/s")
    return res


def phase_tile_cost() -> dict:
    """A bring-up diagnostic, not run by default: the wgmma kernel's cost
    of one kv tile at d = 64, 128, 256 (``tile_cost``)."""
    return {d: tile_cost(d, H, K, seed=50 + d)
            for d, H, K in ((64, 16, 8), (128, 16, 8), (256, 16, 1))}


FLASH_SERVING = {
    # (B, T, S, H, K, d, window, causal, seed) of a 512-token prefill
    "qwen3-1.7b": (1, 512, 512, 16, 8, 128, None, True, 1),
    "granite-moe-3b-a800m": (1, 512, 512, 24, 8, 64, None, True, 14),
    "recurrentgemma-9b": (1, 512, 512, 16, 1, 256, 2048, True, 12),
    "llama3.2-3b": (1, 512, 512, 24, 8, 128, None, True, 83),
    # the local layers; at 512 tokens the 1024 window does not bind, so the
    # global layers compute the same function
    "gemma3-27b": (1, 512, 512, 32, 16, 128, 1024, True, 84),
    "qwen3-32b": (1, 512, 512, 64, 8, 128, None, True, 85),
    "moonshot-v1-16b-a3b": (1, 512, 512, 16, 16, 128, None, True, 86),
    # 1152 patches in front of the 512-token prompt
    "llava-next-34b": (1, 1664, 1664, 56, 8, 128, None, True, 87),
    # an encoder: 512 frames, non-causal, d = 80 on mma.sync
    "hubert-xlarge": (1, 512, 512, 16, 16, 80, None, False, 26),
}
FLASH_LABELS = {"qwen3-1.7b": "(a) main path", "recurrentgemma-9b": "(l) local layer",
                "granite-moe-3b-a800m": "(n) granite prefill",
                "hubert-xlarge": "(x) hubert-xlarge"}


def phase_kernels() -> dict:
    """flash_attention: every served model's prefill shape (FLASH_SERVING,
    a 512-token prompt), timed beside scaled_dot_product_attention: (a)
    qwen3-1.7b, (l) recurrentgemma-9b's local layers (MQA, d=256, window
    2048, which does not bind at 512, so the library call with is_causal is
    the same function), (n) granite-moe-3b-a800m (GQA 24/8, d=64), (x)
    hubert-xlarge (d = 80, 16/16 heads, non-causal, 512 frames), and (z)
    llama3.2-3b (24/8), gemma3-27b's local layers (32/16, window 1024),
    qwen3-32b (64/8), moonshot-v1-16b-a3b (16/16) and llava-next-34b (56/8,
    GQA 7, 1152 patches + 512 tokens); (b) qwen3's 300-token prompt; (c), (d) GQA with a
    window and MQA with T != S, in float32; (e)-(k) the other head_dims of
    both dtypes, ragged lengths and windows with and without causality;
    (m) recurrentgemma past its window; (o)-(w) the wgmma kernel's edges in
    bf16: T = 1, T < 64, T != S (causal and not), GQA 3 and 16 with ragged
    T, B = 2 with S no multiple of the kv tile, a window inside one kv
    tile, and 16 and 11 q tiles a head with ragged T (long kv walks); (y)
    every other head dim the Pallas kernel takes (a multiple of 16 up to
    256) on the mma.sync kernel and in float32; (m2) gemma3-27b's local
    layers past their window."""
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = {}
    for arch, (B, T, S, H, K, d, window, causal, seed) in FLASH_SERVING.items():
        shapes[arch] = flash_case(FLASH_LABELS.get(arch, f"(z) {arch}"), B, T, S, H,
                                  K, d, bf16, causal, window, seed=seed, timed=True)
    cases = (("(b) ragged", 1, 300, 300, 16, 8, 128, bf16, True, None, 2),
             ("(c) GQA 4:1 window 96", 2, 256, 256, 8, 2, 64, f32, True, 96, 3),
             ("(d) MQA T!=S", 1, 128, 256, 4, 1, 128, f32, True, None, 4),
             # every head_dim of both dtypes, ragged and windowed
             ("(e) GQA 4:1 window 96", 2, 256, 256, 8, 2, 64, bf16, True, 96, 5),
             ("(f) MQA ragged window", 1, 100, 77, 4, 1, 256, bf16, True, 40, 6),
             ("(g) MHA non-causal", 1, 128, 128, 4, 4, 16, bf16, False, None, 7),
             ("(h) non-causal window", 2, 70, 70, 2, 1, 32, bf16, False, 8, 8),
             ("(i) ragged", 1, 100, 77, 4, 2, 256, f32, True, 40, 9),
             ("(j) non-causal window", 1, 64, 64, 2, 1, 16, f32, False, 8, 10),
             ("(k) ragged", 1, 65, 65, 4, 2, 32, f32, True, None, 11),
             # recurrentgemma-9b's local layers past the window
             ("(m) window binds", 1, 2500, 2500, 16, 1, 256, bf16, True, 2048, 13),
             ("(m2) gemma3 window binds", 1, 2500, 2500, 32, 16, 128, bf16, True,
              1024, 27),
             # the wgmma kernel's edges
             ("(o) T = 1", 2, 1, 1, 4, 4, 64, bf16, True, None, 15),
             ("(o) T = 1, S = 300", 1, 1, 300, 8, 2, 128, bf16, False, None, 16),
             ("(p) T < 64", 1, 37, 37, 8, 8, 128, bf16, True, None, 17),
             ("(q) T != S", 1, 128, 256, 16, 8, 128, bf16, True, None, 18),
             ("(q) T != S non-causal", 1, 128, 256, 16, 8, 128, bf16, False, None, 19),
             ("(r) GQA 3 ragged T", 1, 300, 300, 24, 8, 64, bf16, True, None, 20),
             ("(s) GQA 16 ragged T", 1, 300, 300, 16, 1, 256, bf16, True, 2048, 21),
             ("(t) B = 2 ragged S", 2, 200, 200, 8, 4, 128, bf16, True, None, 22),
             ("(u) window inside a kv tile", 1, 256, 256, 8, 2, 128, bf16, True, 20,
              23),
             ("(v) long kv walks", 1, 1000, 1000, 2, 1, 128, bf16, True, None, 24),
             ("(w) long kv walks, d=64", 1, 700, 700, 6, 2, 64, bf16, True, None, 25))
    # the head dims of neither wgmma nor the served models: mma.sync in bf16
    cases += tuple((f"(y) d={d}", 1, 300, 300, 8, 2, d, bf16, True, None, 60 + d)
                   for d in (48, 80, 96, 112, 160, 192, 224))
    cases += (("(y) d=144 window", 2, 200, 200, 4, 1, 144, bf16, True, 70, 61),
              ("(y) d=176 non-causal", 1, 130, 130, 4, 4, 176, bf16, False, None, 62),
              ("(y) d=208 T != S", 1, 100, 257, 6, 3, 208, bf16, True, None, 63),
              ("(y) d=240", 1, 65, 65, 2, 1, 240, bf16, True, None, 64),
              ("(y) d=48 f32", 1, 200, 200, 4, 2, 48, f32, True, None, 65),
              ("(y) d=80 f32 non-causal", 1, 160, 160, 4, 4, 80, f32, False, None, 66),
              ("(y) d=240 f32 window", 1, 100, 100, 2, 1, 240, f32, True, 33, 67))
    worst = 0.0
    for *args, seed in cases:
        worst = max(worst, flash_case(*args, seed=seed)["max_abs_err"])
    main = dict(shapes["qwen3-1.7b"])
    main["max_abs_err"] = max([worst] + [r["max_abs_err"] for r in shapes.values()])
    main["shapes"] = shapes
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
        fail(f"ssd_scan {name} disagrees with its plain version")
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
    casts its stacked A_log too), 4 chunks at mamba2's widths (the state
    carried over three chunk boundaries), a chunk of 96 (its second C·Bᵀ
    tile is part padding), and the main path's shape (mamba2-370m, a
    512-token prompt), timed. Tolerance atol = rtol: 2e-2 in bf16 (y is
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
                                              f32, TOL[f32])),
                       ("(4 chunks)", (1, 1024, 8, 64, 128, 256, bf16, bf16, bf16,
                                       TOL[bf16])),
                       ("(Q = 96)", (2, 384, 4, 32, 16, 96, f32, f32, f32, TOL[f32])),
                       ("(Q = 96)", (2, 384, 4, 32, 16, 96, bf16, bf16, f32,
                                     TOL[bf16]))):
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


def rmsnorm_inputs(g, shape, dtype, b_dtype, w_dtype, offset=0, b_width=None):
    """x normal in ``dtype``, h (or z) normal in ``b_dtype``, w = 0.1·normal
    (the JAX package's kernel-test generator). ``offset`` shifts x and h one
    element off 16-byte alignment (the scalar path); ``b_width`` makes h a
    column slice of rows that wide, as mamba2's z is of its in_proj output."""
    n, D = int(np.prod(shape)), shape[-1]
    x = torch.randn(n + offset, generator=g, device=DEV).to(dtype)[offset:].view(shape)
    if b_width is None:
        h = torch.randn(n + offset, generator=g, device=DEV).to(b_dtype)[offset:]
        h = h.view(shape)
    else:
        h = torch.randn(n // D * b_width, generator=g, device=DEV).to(b_dtype)
        h = h.view(*shape[:-1], b_width)[..., :D]
    w = (0.1 * torch.randn(D, generator=g, device=DEV)).to(w_dtype)
    return x, h, w


def rmsnorm_bound(nbytes, n) -> tuple:
    """(bound ms, what bounds it): the bytes at the memory rate against
    about 4 f32 operations an element (statistics and scale)."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 4 * n / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


RMSNORM_CALLS = {  # prologue: (kernel, plain version)
    "none": (lambda x, h, w: rmsnorm(x, w, EPS),
             lambda x, h, w: rmsnorm_plain(x, w, EPS)),
    "add": (lambda x, h, w: add_rmsnorm(x, h, w, EPS),
            lambda x, h, w: add_rmsnorm_plain(x, h, w, EPS)),
    "gate": (lambda x, h, w: gated_rmsnorm(x, h, w, EPS),
             lambda x, h, w: gated_rmsnorm_plain(x, h, w, EPS)),
}


def rmsnorm_case(g, name, shape, dtype, w_dtype, offset=0, timed=False, kind="none",
                 b_dtype=None, b_width=None, sleep=100_000_000, reps=20):
    """One call of the norm kernel with prologue ``kind`` (none: rmsnorm;
    add: add_rmsnorm; gate: gated_rmsnorm) against its plain version. The
    add's sum s must equal the eager add's exactly; the norm is held to
    RMSNORM_TOL of its dtype. ``timed``: the kernel, the plain version and
    (no prologue) F.rms_norm on the f32 input, beside the bound."""
    x, h, w = rmsnorm_inputs(g, shape, dtype, b_dtype or dtype, w_dtype, offset,
                             b_width)
    kernel, plain = RMSNORM_CALLS[kind]
    got, want = kernel(x, h, w), None
    sync()
    want = plain(x, h, w)
    s_ok = True
    if kind == "add":
        (s_got, got), (s_want, want) = got, want
        s_ok = s_got.dtype == s_want.dtype and torch.equal(s_got, s_want)
    tol = RMSNORM_TOL[want.dtype]
    err, ok = _close(got, want, tol)
    ok = ok and s_ok and got.dtype == want.dtype and got.shape == want.shape
    log(f"[rmsnorm] {name} [{kind}]: x {tuple(shape)} {str(dtype)[6:]}"
        f"{'' if kind == 'none' else ' h' if kind == 'add' else ' z'}"
        f"{'' if kind == 'none' else ' ' + str(h.dtype)[6:]}"
        f"{f' (a column slice of {b_width})' if b_width else ''} w {str(w_dtype)[6:]}"
        f"{' (16-byte misaligned)' if offset else ''}: max_abs_err {err:.3g} "
        f"atol=rtol={tol:g}{'; s exact' if kind == 'add' and s_ok else ''}"
        f"{'; s DIFFERS' if not s_ok else ''} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"rmsnorm {name} [{kind}] disagrees with its plain version")
    res = {"max_abs_err": err, "tolerance": tol}
    if timed:
        D, n = shape[-1], x.numel()
        res["ms"] = device_ms(lambda: kernel(x, h, w), reps=reps, sleep=sleep)
        res["plain_ms"] = device_ms(lambda: plain(x, h, w), reps=reps, sleep=sleep)
        res["library_ms"] = None
        lib = ""
        if kind == "none":
            xf, w1 = x.float(), 1.0 + w.float()  # the library call's operands
            res["library_ms"] = device_ms(lambda: F.rms_norm(xf, (D,), w1, EPS),
                                          reps=reps, sleep=sleep)
            lib = f" | F.rms_norm on the f32 input {res['library_ms'] * 1e3:.2f} us"
        out_size = got.element_size()
        nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
                  + n * out_size * (2 if kind == "add" else 1)
                  + (0 if kind == "none" else n * h.element_size()))
        bound, by = rmsnorm_bound(nbytes, n)
        res.update(bound_ms=bound, bound_by=by, bytes=nbytes, shape=list(shape))
        log(f"[rmsnorm]   kernel {res['ms'] * 1e3:.2f} us | plain "
            f"{res['plain_ms'] * 1e3:.2f} us{lib} | bound {bound * 1e3:.4f} us "
            f"({by}: {nbytes / 1e6:.4f} MB) | "
            f"{bound / res['ms'] * 100:.1f}% of the bound")
    return res


RMSNORM_DECODE = ((1, 1024), (4, 1024), (1, 1536), (4, 1536), (1, 2048), (4, 2048),
                  (1, 4096), (4, 4096))  # a decode step's rows: 1 or 4 slots
_QWEN3, _MAMBA2 = get_config("qwen3-1.7b"), get_config("mamba2-370m")
QK_NORM_DECODE = (4 * _QWEN3.num_heads, _QWEN3.head_dim)  # q/k norm at 4 slots
# the widths of the models served since: a 512-token prefill's (512 frames'
# for hubert-xlarge) rows of d_model, each with and without the add
RMSNORM_SERVING = {arch: get_config(arch).d_model for arch in (
    "hubert-xlarge", "llama3.2-3b", "qwen3-32b", "gemma3-27b", "llava-next-34b")}
RMSNORM_DECODE_SERVING = tuple((rows, D) for D in (3072, 5120, 5376, 7168)
                               for rows in (1, 4))
QK_NORM_SERVING = {arch: get_config(arch).num_heads for arch in ("gemma3-27b",
                                                                  "qwen3-32b")}
MAMBA2_Z_WIDTH = (2 * _MAMBA2.d_inner + 2 * _MAMBA2.ssm_state
                  + _MAMBA2.ssm_heads)  # its in_proj output: z, x, B, C, dt


def phase_rmsnorm() -> dict:
    """rmsnorm: the JAX package's kernel-test shapes in f32 and bf16 (w
    f32); the serving shapes (granite's prefill and 4-slot decode rows, the
    other models' widths, qwen3's qk-norm rows); mixed x/w dtypes; a row
    count that fills no whole block; rows off 16-byte alignment; and the
    main path's shape (granite-moe-3b-a800m, a 512-token prompt), timed.
    The add and gate prologues at every served width, with mixed and
    misaligned operands and mamba2's z as a column slice. Timed: the
    prefill shape with each prologue, and the decode shapes (1 and 4 rows
    at each served width, with no prologue and with the add; mamba2's gate
    at 2048; qwen3's 4-slot qk-norm). Then each width served since
    (RMSNORM_SERVING: 1280-7168) at its prefill rows with no prologue and
    with the add, and the decoders' at 1 and 4 rows, timed; gemma3-27b's
    and qwen3-32b's qk-norm rows (32 and 64 heads of 128) at prefill,
    checked, and at 4 slots, timed. Tolerances as tests/test_kernels.py."""
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
              ("(widest row)", (3, 16384), bf16, bf16),
              ("(widest row, f32)", (2, 16384), f32, f32)]
    for args in cases:
        worst = max(worst, rmsnorm_case(g, *args)["max_abs_err"])
    for args in (("(misaligned, warp path)", (9, 1000), bf16, bf16),
                 ("(misaligned, block path)", (3, 1536), f32, bf16)):
        worst = max(worst, rmsnorm_case(g, *args, offset=1)["max_abs_err"])
    # the prologues: every served width, both dtypes of each operand
    fused = [(f"(width {D})", kind, (r, D), bf16, bf16, bf16, 0, None)
             for kind in ("add", "gate") for r, D in ((3, 1024), (4, 1536), (2, 2048),
                                                       (1, 4096), (1, 128))]
    fused += [("(f32 stream, bf16 h)", "add", (5, 2048), f32, bf16, bf16, 0, None),
              ("(bf16 stream, f32 h)", "add", (3, 4096), bf16, f32, f32, 0, None),
              ("(f32, f32)", "add", (2, 77, 1536), f32, f32, f32, 0, None),
              ("(bf16 y, f32 z)", "gate", (4, 2048), bf16, f32, bf16, 0, None),
              ("(f32 y, bf16 z)", "gate", (4, 2048), f32, bf16, f32, 0, None),
              ("(f32, f32)", "gate", (3, 1024), f32, f32, f32, 0, None),
              ("(mamba2 prefill, z sliced)", "gate", (1, 300, 2048), bf16, bf16, bf16,
               0,
               MAMBA2_Z_WIDTH),
              ("(z sliced, no vector stride)", "gate", (7, 2048), bf16, bf16, bf16, 0,
               2051),
              ("(misaligned)", "add", (9, 1000), bf16, bf16, bf16, 1, None),
              ("(misaligned)", "gate", (3, 1536), f32, bf16, bf16, 1, None),
              ("(D not a vector multiple)", "add", (5, 100), bf16, f32, f32, 0, None),
              ("(widest row)", "add", (2, 16384), bf16, bf16, bf16, 0, None),
              ("(widest row, f32)", "gate", (2, 16384), f32, f32, f32, 0, None),
              ("(rows fill no block)", "add", (1001, 128), bf16, bf16, bf16, 0, None)]
    for name, kind, shape, dt, b_dt, w_dt, off, width in fused:
        worst = max(worst, rmsnorm_case(g, name, shape, dt, w_dt, off, kind=kind,
                                        b_dtype=b_dt, b_width=width)["max_abs_err"])
    main = rmsnorm_case(g, "(a) main path", (512, 1536), bf16, bf16, timed=True)
    main["prologues"] = {
        "add": rmsnorm_case(g, "(a) main path", (512, 1536), bf16, bf16, timed=True,
                            kind="add"),
        "gate": rmsnorm_case(g, "(mamba2 prefill)", (512, 2048), bf16, bf16,
                             timed=True, kind="gate", b_width=MAMBA2_Z_WIDTH)}
    decode = {}
    short = dict(timed=True, sleep=20_000_000, reps=10)  # a few us a call
    for rows, D in RMSNORM_DECODE:
        for kind in ("none", "add"):
            decode[f"{kind} {rows}x{D}"] = rmsnorm_case(g, "(decode)", (rows, D), bf16,
                                                        bf16, kind=kind, **short)
    for rows in (1, 4):
        decode[f"gate {rows}x2048"] = rmsnorm_case(
            g, "(mamba2 decode)", (rows, 2048), bf16, bf16, kind="gate",
            b_width=MAMBA2_Z_WIDTH, **short)
    decode["none 64x128"] = rmsnorm_case(g, "(qwen3 qk-norm decode)", QK_NORM_DECODE,
                                         bf16, bf16, **short)
    shapes = {}
    for arch, D in RMSNORM_SERVING.items():
        shapes[arch] = {kind: rmsnorm_case(g, f"({arch} prefill)", (512, D), bf16, bf16,
                                           kind=kind, **short)
                        for kind in ("none", "add")}
    for rows, D in RMSNORM_DECODE_SERVING:
        for kind in ("none", "add"):
            decode[f"{kind} {rows}x{D}"] = rmsnorm_case(g, "(decode)", (rows, D), bf16,
                                                        bf16, kind=kind, **short)
    for arch, H in QK_NORM_SERVING.items():
        worst = max(worst, rmsnorm_case(g, f"({arch} qk-norm)", (1, 512, H, 128), bf16,
                                        bf16)["max_abs_err"])
        decode[f"none {4 * H}x128"] = rmsnorm_case(g, f"({arch} qk-norm decode)",
                                                   (4 * H, 128), bf16, bf16, **short)
    main["decode"] = decode
    main["shapes"] = shapes
    main["max_abs_err"] = max(
        [worst, main["max_abs_err"]] + [r["max_abs_err"] for r in decode.values()]
        + [r["max_abs_err"] for r in main["prologues"].values()]
        + [r["max_abs_err"] for by in shapes.values() for r in by.values()])
    return main


# ---------------------------------------------------------------------------
# phase 4: federated prefill -> decode at full width
# ---------------------------------------------------------------------------
def init_bounds(cfg) -> tuple:
    """(serving bytes, the largest float32 piece the serving init draws at
    once: one layer slice of a stacked leaf, or an unstacked leaf whole),
    counted from the parameter definitions."""
    esize = _esize(getattr(torch, cfg.compute_dtype))
    total = piece = 0
    for d in tree_leaves(M.param_defs(cfg), is_leaf=lambda x: isinstance(x, ParamDef)):
        n = math.prod(d.shape)
        total += n * (esize if len(d.shape) >= 2 else 4)
        if d.init not in ("zeros", "ones"):
            piece = max(piece, 4 * (n // d.shape[0] if d.axes[0] == "layers" else n))
    return total, piece


def make_params(cfg):
    """Random weights from seed 0, drawn in their serving dtypes
    (``M.init_serving_params``: bf16 matrices and stacked vectors, float32
    vectors). The draw's peak allocation is gated at the serving bytes plus
    the largest float32 piece plus INIT_SLACK. Returns (params, record)."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.perf_counter()
    params = M.init_serving_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                                   device=DEV)
    sync()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(DEV) - base
    want, piece = init_bounds(cfg)
    n = sum(t.numel() for t in tree_leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    bound = want + piece + INIT_SLACK
    log(f"[serving] {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}"
        f"{f' experts={cfg.num_experts} top_k={cfg.top_k}' if cfg.num_experts else ''}"
        f": {n / 1e9:.3f} B params, "
        f"{nbytes / 1e9:.2f} GB {cfg.compute_dtype} on {DEV} ({init_s:.1f} s)")
    log(f"[memory] {cfg.name} init: peak {peak / 1e9:.3f} GB over the "
        f"{base / 1e9:.3f} GB allocated before; gate {bound / 1e9:.3f} GB = "
        f"serving {want / 1e9:.3f} + largest f32 piece {piece / 1e9:.3f} + "
        f"{INIT_SLACK / 1e9:g}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(DEV) / 1e9:.3f} GB")
    if nbytes != want:
        raise AssertionError(f"{cfg.name}: {nbytes} serving bytes, the definitions "
                             f"give {want}")
    if peak > bound:
        raise AssertionError(f"{cfg.name}: init peak {peak} bytes > {bound}")
    return params, {"params": n, "bytes": nbytes, "init_s": init_s,
                    "peak_bytes": peak, "gate_bytes": bound, "f32_piece_bytes": piece}


def memory_mark(record, name):
    """Log and record the card's peak allocation since the last mark, then
    start the next phase's peak."""
    peak = torch.cuda.max_memory_allocated(DEV)
    record[name] = peak
    log(f"[memory] {name}: max_memory_allocated {peak / 1e9:.3f} GB (now "
        f"{torch.cuda.memory_allocated(DEV) / 1e9:.3f} GB)")
    torch.cuda.reset_peak_memory_stats(DEV)


def greedy(logits) -> int:
    logits = shd.full(logits)  # a DTensor's whole (a mesh's serving path)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    return int(torch.argmax(logits[0]))


SERVE_WF = WorkflowSpec((StepSpec("prefill", "prefill-pod"),
                         StepSpec("decode", "decode-pod")), "serve")


def serving_registry():
    reg = PlatformRegistry()
    reg.register(Platform("client", "us-east", kind="edge", native_prefetch=True,
                          device="cpu"))
    reg.register(Platform("prefill-pod", "us-east", native_prefetch=True,
                          device=str(DEV)))
    reg.register(Platform("decode-pod", "us-west", native_prefetch=True,
                          device=str(DEV)))
    return reg


def serve_len(cfg) -> int:
    """A federated request's cache capacity: MAX_LEN behind llava's patches."""
    return MAX_LEN + (cfg.num_patches if cfg.input_kind == "tokens+patches" else 0)


def request_data(cfg, i):
    """(DataRef, host bf16 tensor) of request i's data dependency, from a
    numpy seed: llava's (num_patches, d_model) patch embeddings, hubert's
    (ENCODER_FRAMES, d_model) frames; None for a model of tokens alone.
    The key's first part names the prefill input ("patches/0")."""
    if cfg.input_kind == "tokens+patches":
        kind, n = "patches", cfg.num_patches
    elif cfg.input_kind == "frames":
        kind, n = "frames", ENCODER_FRAMES
    else:
        return None
    x = np.random.default_rng(100 + i).standard_normal((n, cfg.d_model),
                                                        dtype=np.float32)
    return DataRef(f"{kind}/{i}", "us-east"), torch.from_numpy(x).to(torch.bfloat16)


def serve_spec(cfg, ref):
    """A request's workflow. Tokens alone: prefill -> decode (SERVE_WF).
    With a data dependency ``ref`` the client's ingest step comes first:
    its start pokes the next step, which pre-warms and pre-fetches ``ref``
    onto the card while ingest runs; then prefill -> decode (llava, the
    patches) or encode (hubert, the frames)."""
    if ref is None:
        return SERVE_WF
    ingest = StepSpec("ingest", "client")
    if not cfg.supports_decode:
        return WorkflowSpec((ingest, StepSpec("encode", "prefill-pod", (ref,))),
                            "encode")
    return WorkflowSpec((ingest, StepSpec("prefill", "prefill-pod", (ref,)),
                         StepSpec("decode", "decode-pod")), "serve")


class InFlight:
    """Counts handler calls in progress, from any thread: a timed-out or
    hedged-away attempt keeps running after its request has returned."""

    def __init__(self):
        self.n = 0
        self._cv = threading.Condition()

    def track(self, fn):
        def call(*a):
            with self._cv:
                self.n += 1
            try:
                return fn(*a)
            finally:
                with self._cv:
                    self.n -= 1
                    self._cv.notify_all()
        return call

    def wait_idle(self, timeout_s=120.0):
        with self._cv:
            if not self._cv.wait_for(lambda: self.n == 0, timeout_s):
                raise AssertionError(f"{self.n} handler calls still running "
                                     f"after {timeout_s} s")


def deploy_serving(dep, cfg, params, seen=None, kv_in_payload=False,
                   sent=None) -> InFlight:
    """Deploy the federated workflow's steps on ``dep``: prefill ships its
    caches through the object store (one key a call), decode fetches them
    per call, so two attempts of one decode (a retry, a hedge) never share
    a cache tensor, and runs NEW_TOKENS - 1 greedy steps. A model with a
    data dependency also gets the client's ingest step, which forwards the
    payload; its prefill (or hubert's encode) takes the pre-fetched tensor
    from ``data`` and keeps it in ``seen`` under its key. Every handler
    ends in a device-to-host copy (``greedy``): they return host values, so
    a traced compute span closes after the device work. With
    ``kv_in_payload`` prefill instead returns the padded caches as card
    tensors in its payload, their padding kernels possibly still queued,
    and decode computes on them as it receives them. Prefill appends each
    payload it returns to ``sent`` where given."""
    dep.store.network.set_link("us-east", "us-west", 0.02, 200e6)
    V = cfg.vocab_size
    keys = itertools.count()
    inflight = InFlight()
    seen = {} if seen is None else seen

    def data_batch(data):
        if not data:
            return {}
        (key, x), = data.items()
        seen[key] = x
        return {key.split("/")[0]: x[None]}

    def encode_fn(payload, data):
        logits, caches = M.prefill(cfg, params, data_batch(data))
        if tuple(logits.shape) != (1, V) or caches != {}:
            raise AssertionError(f"encoder logits {tuple(logits.shape)}, caches "
                                 f"{type(caches)}")
        return {"label": greedy(logits), "max_abs_logit": logits.abs().max().item()}

    def prefill_fn(payload, data):
        tokens = torch.as_tensor(payload, device=DEV)[None]
        batch = {"tokens": tokens, **data_batch(data)}
        logits, caches = M.prefill(cfg, params, batch)
        if tuple(logits.shape) != (1, V):
            raise AssertionError(f"prefill logits shape {tuple(logits.shape)}")
        tok = greedy(logits)
        pos = len(payload) + (cfg.num_patches if "patches" in batch else 0)
        caches = pad_cache(caches, serve_len(cfg), pos, cfg=cfg)
        if kv_in_payload:
            out = {"first_tok": tok, "caches": caches, "pos": pos}
        else:
            key = f"kv/{next(keys)}"
            dep.store.put(key, tree_map(lambda t: shd.full(t).cpu(), caches),
                          region="us-east")
            out = {"first_tok": tok, "kv_key": key, "pos": pos}
        if sent is not None:
            sent.append(out)
        return out

    def decode_step(token, caches, cur):
        return M.decode_step(cfg, params, token, caches, cur)

    def decode_fn(payload, data):
        if "caches" in payload:
            caches = payload["caches"]
        else:
            host_caches, _ = dep.store.get(payload["kv_key"], "us-west")
            caches = tree_map(lambda t: t.to(DEV), host_caches)
        mesh, rules = shd.current_sharding()  # the decode platform's, if any
        if mesh is not None:
            caches = M.distribute_params(caches, cache_defs(cfg, 1, serve_len(cfg)),
                                         rules, mesh)
        tok, cur = payload["first_tok"], payload["pos"]
        toks = [tok]
        for _ in range(NEW_TOKENS - 1):
            logits, caches = decode_step(
                torch.tensor([[tok]], dtype=torch.int32, device=DEV), caches, cur)
            tok = greedy(logits)
            toks.append(tok)
            cur += 1
        return toks

    if cfg.input_kind != "tokens":
        dep.deploy("ingest", inflight.track(lambda payload, data: payload), ["client"])
    if not cfg.supports_decode:
        dep.deploy("encode", inflight.track(encode_fn), ["prefill-pod"])
        return inflight
    dec_specs = (TensorSpec((1, 1), torch.int32, str(DEV)),
                 tree_map(lambda d: TensorSpec(d.shape, getattr(torch, d.dtype),
                                               str(DEV)),
                          cache_defs(cfg, 1, serve_len(cfg)), is_leaf=_is_spec),
                 0)
    dep.deploy("prefill", inflight.track(prefill_fn), ["prefill-pod"])
    dep.deploy("decode", inflight.track(decode_fn), ["decode-pod"],
               abstract_args=dec_specs, compile_fn=decode_step)
    return inflight


def check_tokens(toks, V, what):
    if len(toks) != NEW_TOKENS or not all(0 <= t < V for t in toks):
        raise AssertionError(f"{what}: bad tokens {toks}")


def check_encoded(out, V, what):
    if not (0 <= out["label"] < V and math.isfinite(out["max_abs_logit"])):
        raise AssertionError(f"{what}: bad encoder output {out}")


def phase_federated(cfg, params, prompts, registry=None):
    """The federated workflow, one request per prompt (cold, then warm), on
    ``registry`` (``serving_registry()`` where None). A
    model with a data dependency gets each request's tensor put in the
    store (us-east) and named in its spec; the tensors its steps received
    must be on the card and equal the stored ones bit for bit. hubert's
    requests are its prompts' indices: the frames are the input."""
    V = cfg.vocab_size
    seen, stored = {}, {}
    with Deployment(registry or serving_registry()) as dep:
        deploy_serving(dep, cfg, params, seen)
        results = []
        for i, prompt in enumerate(prompts):
            ref = None
            data = request_data(cfg, i)
            if data is not None:
                ref, host = data
                dep.store.put(ref.key, host, region=ref.store_region)
                stored[ref.key] = host
            spec = serve_spec(cfg, ref)
            r = dep.run(spec, prompt if cfg.supports_decode else i)
            if cfg.supports_decode:
                check_tokens(r.outputs, V, f"request {i}")
            else:
                check_encoded(r.outputs, V, f"request {i}")
            tl = " | ".join(
                f"{node}: warm {t['warm_s'] * 1e3:.1f} ms fetch "
                f"{t['fetch_s'] * 1e3:.1f} ms compute {t['compute_s'] * 1e3:.1f} ms"
                for node, t in r.timeline.items())
            what = (f"prompt {len(prompt)}" if cfg.supports_decode else "")
            if ref is not None:
                what += (f" {'+ ' if what else ''}{ref.key} "
                         f"{tuple(stored[ref.key].shape)}")
            log(f"[serving] request {i} ({'cold' if i == 0 else 'warm'}) {what}: "
                f"total_s={r.total_s:.4f} | {tl}")
            results.append({"prompt": len(prompt) if cfg.supports_decode else 0,
                            "data": ref.key if ref else None, "total_s": r.total_s,
                            "tokens": r.outputs if cfg.supports_decode else None,
                            "timeline": {n: {k: v for k, v in t.items()
                                             if isinstance(v, float)}
                                         for n, t in r.timeline.items()}})
        rep = dep.report()
    comp = rep["compile"]
    log(f"[serving] compile cache: prewarms={comp['prewarms']} hits={comp['hits']} "
        f"misses={comp['misses']} hidden_compile_s={comp['hidden_compile_s']:.3f}; "
        f"store puts={rep['store']['puts']} gets={rep['store']['gets']} "
        f"bytes_in={rep['store']['bytes_in']}")
    if cfg.supports_decode and (comp["prewarms"] != 1 or comp["misses"] != 0):
        raise AssertionError(f"decode was not pre-warmed by the poke: {comp}")
    if stored:
        same = [k for k, t in seen.items()
                if t.device == DEV and torch.equal(t, stored[k].to(DEV))]
        log(f"[serving] data dependencies: {len(same)} of {len(stored)} requests' "
            f"{', '.join(stored)} reached their step on {DEV} bit-exact "
            f"({next(iter(stored.values())).numel() * 2 / 1e6:.1f} MB each)")
        if sorted(same) != sorted(stored):
            raise AssertionError(f"data dependencies delivered {sorted(same)} of "
                                 f"{sorted(stored)} bit-exact on {DEV}")
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
           "prompts": [len(r.prompt) for r in reqs],
           "tokens": [list(r.tokens) for r in reqs]}
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


def batch_desc(batch) -> str:
    return " + ".join(f"{k} {t.shape[1]}" for k, t in batch.items())


def model_batch(cfg, prompt, i=1) -> dict:
    """A prefill's inputs on the card: the prompt's tokens, after request
    i's patches for llava; request i's frames alone for hubert."""
    batch = {}
    if cfg.input_kind != "frames":
        batch["tokens"] = torch.as_tensor(prompt, device=DEV)[None]
    data = request_data(cfg, i)
    if data is not None:
        ref, host = data
        batch = {ref.key.split("/")[0]: host.to(DEV)[None], **batch}
    return batch


F32_COPY_SHARE = 0.8  # of the card's memory: served weights + a float32 copy


def f32_copy(cfg, params) -> tuple:
    """(config, float32 params, what was cut) for the float32 gate: the
    served weights cast up exactly, at full depth where that copy fits
    beside them (F32_COPY_SHARE of the card), else cut in depth to the
    first cycle of block_pattern (2 layers for a one-kind pattern) at full
    width, with the embedding, input projections, head and final norm."""
    served = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    f32 = 4 * sum(t.numel() for t in tree_leaves(params))
    card = torch.cuda.get_device_properties(DEV).total_memory
    if served + f32 <= F32_COPY_SHARE * card:
        return cfg, tree_map(lambda t: t.float(), params), "full depth"
    n = len(cfg.block_pattern)
    depth = n if n > 1 else 2
    cut = {k: tree_map(lambda t: t.float(), v) for k, v in params.items()
           if k != "blocks"}
    cut["blocks"] = {"cycle": tree_map(lambda t: t[:depth // n].float(),
                                       params["blocks"]["cycle"])}
    return (cfg.replace(num_layers=depth), cut,
            f"cut to {depth} of {cfg.num_layers} layers at full width (a float32 "
            f"copy of all, {f32 / 1e9:.1f} GB, beside the {served / 1e9:.1f} GB "
            f"served would pass {F32_COPY_SHARE:g} of {card / 1e9:.1f} GB)")


def phase_checks(cfg, params, batch):
    """Kernel-path against plain-path prefill logits, in the serving dtype
    and in float32 (the same bf16 weights cast up, exactly; the models
    whose float32 copy would not fit beside their weights cut in depth,
    ``f32_copy``). ``batch``: the prefill's inputs on the card. In an MoE
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
    def kernel_and_plain(c, prm):
        """(kernel-path prefill, a function that runs the plain path on the
        kernel path's experts)."""
        with recording_routes() as rec:
            logits, _ = M.prefill(c, prm, batch)
        routes = [gi for gi, _, _ in rec.calls]

        def plain():
            with pinned_routes(routes):
                return M.prefill(c.replace(use_pallas=False), prm, batch)[0]
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
    if tuple(k_logits.shape) != (1, cfg.vocab_size):
        raise AssertionError(f"prefill logits shape {tuple(k_logits.shape)}")
    log(f"[checks] prefill logits kernel vs plain path ({batch_desc(batch)}"
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

    c32, f32, depth = f32_copy(cfg, params)
    k32, plain32 = kernel_and_plain(c32.replace(compute_dtype="float32"), f32)
    p32 = plain32()
    sync()
    del f32, plain32
    gc.collect()
    torch.cuda.empty_cache()
    diff32 = (k32 - p32).abs().max().item()
    scale32 = p32.abs().max().item()
    log(f"[checks] float32 (the same weights, {depth}): max_abs_diff={diff32:.4g} "
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
    return {"inputs": batch_desc(batch), "bf16_max_abs_diff": diff,
            "bf16_max_abs_logit": scale, "bf16_bound": bound, "noise_moves": moves,
            "f32_max_abs_diff": diff32, "f32_max_abs_logit": scale32,
            "f32_depth": depth}


def _profiled(fn):
    """(wall s, {kernel name: device s}, [(device s, calls, op, input
    shapes)] of the ops that launched the kernels, device kernels launched)
    of ``fn`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    kernels: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us() * 1e-6)
            low = e.name.lower()
            n_kernels += "memcpy" not in low and "memset" not in low
    ops = sorted(((a.self_device_time_total * 1e-6, a.count, a.key, str(a.input_shapes))
                  for a in prof.key_averages(group_by_input_shape=True)
                  if a.self_device_time_total > 0), reverse=True)
    return wall, kernels, ops, n_kernels


PORT_KERNEL = re.compile(r"flash_fwd|ssd_cb|ssd_scan_kernel|"
                         r"rglru_scan|rmsnorm|cold_scan")


def phase_profile(cfg, params, batch):
    """Where the time goes in one warm prefill of ``batch`` and, for a
    decoder, in 8 decode steps: device busy share (kernel time over wall
    time) and the kernels that take it."""
    _, caches = M.prefill(cfg, params, batch)
    runs = [("prefill", lambda: M.prefill(cfg, params, batch), 1)]
    if cfg.supports_decode:
        n = sum(t.shape[1] for t in batch.values())
        caches = pad_cache(caches, serve_len(cfg), n, cfg=cfg)
        tok = torch.ones((1, 1), dtype=torch.int32, device=DEV)
        M.decode_step(cfg, params, tok, caches, n)

        def decode8():
            for i in range(8):
                M.decode_step(cfg, params, tok, caches, n + 1 + i)
        runs.append(("decode x8", decode8, 8))
    sync()

    out = {}
    for name, fn, passes in runs:
        wall, kernels, ops, n_kernels = _profiled(fn)
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
        log(f"[profile] {name} ({batch_desc(batch)}): wall {wall * 1e3:.2f} ms, "
            f"device busy {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%), "
            f"{len(kernels)} kernel names, {n_kernels / passes:g} device kernels "
            f"a {'prefill' if passes == 1 else 'decode step'}")
        if not kernels:
            log("[profile]   device time not measured: the profiler recorded no "
                "kernels")
        for kname, ks in top:
            share = 100 * ks / busy if busy else 0
            log(f"[profile]   {share:5.1f}% {ks * 1e3:8.3f} ms  "
                f"{kname[:90]}")
        for ds, calls, op, shapes in ops[:4]:
            log(f"[profile]   op {ds * 1e3:8.3f} ms x{calls} {op} {shapes[:100]}")
        port = {kname: ks for kname, ks in kernels.items() if PORT_KERNEL.search(kname)}
        for kname, ks in sorted(port.items(), key=lambda kv: -kv[1]):
            log(f"[profile]   port kernel {ks * 1e3:8.3f} ms "
                f"({100 * ks / busy if busy else 0:.1f}%) {kname[:90]}")
        out[name] = {"wall_s": wall, "device_busy_s": busy,
                     "kernels_per_pass": n_kernels / passes,
                     "port_kernels": {k[:90]: v for k, v in port.items()},
                     "top": [[k[:90], s] for k, s in top],
                     "top_ops": [[op, shapes[:100], calls, ds]
                                 for ds, calls, op, shapes in ops[:4]]}
    return out


NORM_AB_TURNS = ("kernel", "plain", "plain", "kernel") * 2


def ab_turn(cfg, params, tokens, caches, tok, n):
    """One turn of an in-process A/B: (prefill wall, decode-step wall) of a
    warm prefill and NORM_AB_DECODE decode steps from position n, each ended
    by a synchronise, after a garbage collection."""
    def run():
        gc.collect()
        t0 = time.perf_counter()
        M.prefill(cfg, params, {"tokens": tokens})
        sync()
        t1 = time.perf_counter()
        for i in range(NORM_AB_DECODE):
            M.decode_step(cfg, params, tok, caches, n + i)
        sync()
        return t1 - t0, (time.perf_counter() - t1) / NORM_AB_DECODE
    return run


def ab_summary(walls) -> dict:
    """Medians and minima of each variant's turns, and the turns."""
    return {name: {"prefill_s": statistics.median(w[0] for w in ws),
                   "decode_step_s": statistics.median(w[1] for w in ws),
                   "prefill_min_s": min(w[0] for w in ws),
                   "decode_step_min_s": min(w[1] for w in ws),
                   "turns": [list(w) for w in ws]}
            for name, ws in walls.items()}
NORM_AB_DECODE = 4


def phase_norm_ab(cfg, params, prompt) -> dict:
    """The rmsnorm kernel end to end: one warm prefill and NORM_AB_DECODE
    decode steps (host clock, each ended by a synchronise) with every norm
    through the kernel (with its prologues) and, everything else equal,
    through the plain versions, in turns (kernel, plain, plain, kernel) x 2
    (ab_turn); medians and minima."""
    tokens = torch.as_tensor(prompt, device=DEV)[None]
    _, caches = M.prefill(cfg, params, {"tokens": tokens})
    caches = pad_cache(caches, MAX_LEN, len(prompt), cfg=cfg)
    tok = torch.ones((1, 1), dtype=torch.int32, device=DEV)
    sync()

    run = ab_turn(cfg, params, tokens, caches, tok, len(prompt))
    names = ("rmsnorm_kernel", "add_rmsnorm_kernel", "gated_rmsnorm_kernel")
    kernels = [getattr(L, n) for n in names]
    plain = (rmsnorm_plain, add_rmsnorm_plain, gated_rmsnorm_plain)
    walls = {"kernel": [], "plain": []}
    for turn in NORM_AB_TURNS:
        for n, fn in zip(names, kernels if turn == "kernel" else plain):
            setattr(L, n, fn)
        try:
            walls[turn].append(run())
        finally:
            for n, fn in zip(names, kernels):
                setattr(L, n, fn)
    res = ab_summary(walls)
    k, p = res["kernel"], res["plain"]
    log(f"[norm a/b] prompt {len(prompt)}, medians of {len(walls['kernel'])} turns "
        f"each: prefill {k['prefill_s'] * 1e3:.2f} ms with the rmsnorm kernel vs "
        f"{p['prefill_s'] * 1e3:.2f} ms with the plain norms "
        f"({(k['prefill_s'] / p['prefill_s'] - 1) * 100:+.1f}%); decode step "
        f"{k['decode_step_s'] * 1e3:.2f} vs {p['decode_step_s'] * 1e3:.2f} ms "
        f"({(k['decode_step_s'] / p['decode_step_s'] - 1) * 100:+.1f}%); minima "
        f"{k['prefill_min_s'] * 1e3:.2f} vs {p['prefill_min_s'] * 1e3:.2f} ms, "
        f"{k['decode_step_min_s'] * 1e3:.2f} vs {p['decode_step_min_s'] * 1e3:.2f} ms")
    return res


def _unfused_add(x, h, w, eps=1e-6):
    s = x + h
    return s, L.rmsnorm_kernel(s, w, eps)


def _unfused_gate(y, z, w, eps=1e-6):
    return L.rmsnorm_kernel(y * F.silu(z), w, eps)


class unfused_prologues:
    """While active, the kernel path's residual adds and mamba2's gate are
    eager ops around a no-prologue norm launch (what the kernel path was
    before the norm kernel took them), everything else equal."""

    def __enter__(self):
        self._saved = (L.add_rmsnorm_kernel, L.gated_rmsnorm_kernel)
        L.add_rmsnorm_kernel, L.gated_rmsnorm_kernel = _unfused_add, _unfused_gate
        return self

    def __exit__(self, *exc):
        L.add_rmsnorm_kernel, L.gated_rmsnorm_kernel = self._saved
        return False


PROLOGUE_AB_TURNS = ("fused", "unfused", "unfused", "fused") * 2


def phase_prologue_ab(cfg, params, prompt) -> dict:
    """The norm kernel's prologues end to end: one warm prefill and
    NORM_AB_DECODE decode steps (host clock, each ended by a synchronise)
    with the residual adds and mamba2's gate fused into the norm launches
    and, everything else equal, as eager ops around them (unfused_prologues),
    in turns (fused, unfused, unfused, fused) x 2 (ab_turn); medians and
    minima. Then each
    variant's device kernels a decode step, from the profiler."""
    tokens = torch.as_tensor(prompt, device=DEV)[None]
    _, caches = M.prefill(cfg, params, {"tokens": tokens})
    caches = pad_cache(caches, MAX_LEN, len(prompt), cfg=cfg)
    tok = torch.ones((1, 1), dtype=torch.int32, device=DEV)
    sync()

    run = ab_turn(cfg, params, tokens, caches, tok, len(prompt))

    def decode_kernels():
        return _profiled(
            lambda: M.decode_step(cfg, params, tok, caches, len(prompt)))[3]

    walls = {"fused": [], "unfused": []}
    for turn in PROLOGUE_AB_TURNS:
        if turn == "fused":
            walls[turn].append(run())
        else:
            with unfused_prologues():
                walls[turn].append(run())
    res = ab_summary(walls)
    res["fused"]["decode_kernels"] = decode_kernels()
    with unfused_prologues():
        res["unfused"]["decode_kernels"] = decode_kernels()
    f, u = res["fused"], res["unfused"]
    log(f"[prologue a/b] prompt {len(prompt)}, medians of {len(walls['fused'])} turns "
        f"each: prefill {f['prefill_s'] * 1e3:.2f} ms with the prologues fused vs "
        f"{u['prefill_s'] * 1e3:.2f} ms unfused "
        f"({(f['prefill_s'] / u['prefill_s'] - 1) * 100:+.1f}%); decode step "
        f"{f['decode_step_s'] * 1e3:.2f} vs {u['decode_step_s'] * 1e3:.2f} ms "
        f"({(f['decode_step_s'] / u['decode_step_s'] - 1) * 100:+.1f}%); minima "
        f"{f['prefill_min_s'] * 1e3:.2f} vs {u['prefill_min_s'] * 1e3:.2f} ms, "
        f"{f['decode_step_min_s'] * 1e3:.2f} vs "
        f"{u['decode_step_min_s'] * 1e3:.2f} ms; device "
        f"kernels a decode step {f['decode_kernels']} vs {u['decode_kernels']}")
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
    B, T = warm.shape
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    nch, tpc = cold_scan_plan(B, T, sms)
    log(f"[cold_scan] {name} {str(dtype)[6:]}: B={B} T={T} ({nch} chunks of {tpc} "
        f"tiles a row) cold share {cold_share:.3f} mismatches {bad} max_abs_err {err} "
        f"{'ok' if err <= COLD_SCAN_TOL else 'FAIL'}")
    if err > COLD_SCAN_TOL:
        fail(f"cold_scan {name} {dtype}: {bad} mask entries differ from the plain "
             f"version")
    return args, kwd, err


def odd_ends(g, B, T):
    """Ends the simulator does not make but the contract covers: cold ends
    before warm ends on half the rows, NaN and +-inf ends, an infinite and
    a NaN arrival time; keep_warm straddling the gaps, inf on one row."""
    t0, warm, cold, _ = cold_case(g, B, T, 1.0, None)
    early = torch.rand(B, 1, generator=g, device=DEV) < 0.5
    cold = torch.where(early, warm - 0.3 * torch.rand(B, T, generator=g, device=DEV,
                                                      dtype=torch.float64), cold)
    for ends, vals in ((warm, (float("nan"), float("inf"), -float("inf"))),
                       (cold, (float("nan"), float("inf"), -float("inf")))):
        for v in vals:
            ends[torch.rand(B, T, generator=g, device=DEV) < 0.01] = v
    t0 = t0.clone()
    t0[T // 3] = float("inf")
    t0[T // 2] = float("nan")
    kw = torch.linspace(0.5, 1.2, B, device=DEV, dtype=torch.float64)
    kw[-1] = float("inf")
    return t0, warm, cold, kw


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
    # rows split into chunks (one tile and several), T off the tile and off
    # the vector width (the scalar path), T = 1
    for B, T in ((2, 4096), (8, 5000), (200, 1000), (1000, 2000), (3, 4097), (5, 1)):
        cases.append((f"chunks B={B} T={T}", *cold_case(g, B, T, 1.0, 0.95)))
    for B, T in ((6, 300), (3, 4097), (64, 1024)):
        cases.append((f"cold before warm, NaN and inf ends B={B} T={T}",
                      *odd_ends(g, B, T)))
    # every request from 2 on a flip, request 1 cold whatever came before:
    # tiles and chunks carry state 1 into flip-only maps
    for B, T in ((2, 4097), (300, 1000), (3000, 1024)):
        t0 = 0.7 * torch.arange(T, device=DEV, dtype=torch.float64)
        warm = (t0[None, :] + 0.02 + 0.01 * torch.rand(B, 1, generator=g, device=DEV,
                                                       dtype=torch.float64))
        warm[:, 0] = -1.0
        cold = warm + 0.5
        cold[:, 0] = -1.0
        cases.append((f"flip-only carries B={B} T={T}", t0, warm, cold, 0.6))
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
        wall, kernels, _, _ = _profiled(
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


def adapt_costs(scale=1.0) -> PlacementCosts:
    """The static cost model, calibrated before the drift (``scale``:
    seconds a cost unit)."""
    compute = {("ingest", "client"): 0.04, ("deliver", "client"): 0.04,
               ("work", "pA"): 1.0, ("work", "pB"): 1.3}
    return PlacementCosts(
        fetch_s=lambda name, p, deps: 0.0,
        compute_s=lambda name, p: scale * compute.get((name, p), 0.05),
        transfer_s=lambda a, b, size: scale * (0.001 if a == b else 0.6),
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


def phase_adapt() -> tuple:
    """(result, the arguments of the scorer's last cold_scan call)."""
    n = ADAPT_REQUESTS
    drift = SIM.DriftSchedule([SIM.DriftEvent(n // 2, "pA", compute_scale=5.0)])
    static, _, _ = adapt_stream(n, drift, adaptive=False)
    scorer = PlacementScorer(quantile=0.9, backend="torch", device=DEV)
    calls = []
    scan = torchsim.cold_scan

    def recorded(*args):
        calls[:] = [args]
        return scan(*args)
    torchsim.cold_scan = recorded
    try:
        adaptive, swaps, ctrl_s = adapt_stream(n, drift, scorer=scorer)
    finally:
        torchsim.cold_scan = scan

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
    return res, calls[0] if calls else None


def phase_scorer_scan(args) -> dict:
    """cold_scan at the scorer's own (B, T): its last call's arguments in
    the recomposition phase, exact against the plain version, timed."""
    if args is None:
        raise AssertionError("the torch scorer made no cold_scan call")
    t0, warm, cold, kw = args
    B, T = warm.shape
    got = cold_scan(*args)
    sync()
    if not torch.equal(got, cold_scan_plain(*args)):
        raise AssertionError(f"cold_scan at the scorer's shape ({B}, {T}) differs "
                             f"from the plain version")
    ms = device_ms(lambda: cold_scan(*args), sleep=20_000_000)
    plain_ms = device_ms(lambda: cold_scan_plain(*args), runs=2, reps=5)
    nbytes = cold_scan_bytes(B, T, warm.dtype)
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 3 * B * T / PEAK_FLOPS[torch.float32] * 1e3
    res = {"shape": [B, T], "dtype": str(warm.dtype)[6:], "ms": ms,
           "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
           "max_abs_err": 0, "library_ms": None}
    log(f"[cold_scan] the scorer's shape B={B} T={T} {res['dtype']} (exact): kernel "
        f"{ms * 1e3:.2f} us | plain {plain_ms * 1e3:.1f} us | bound "
        f"{res['bound_ms'] * 1e3:.4f} us (bytes: {nbytes / 1e3:.1f} KB)")
    return res


# ---------------------------------------------------------------------------
# phase 11: the observability plane (obs) on the card
# ---------------------------------------------------------------------------
OBS_SAMPLE = 64  # traced requests of the sweep's first seed
OBS_SWEEP_TURNS = ("untraced", "traced", "traced", "untraced") * 3
OBS_SERVE_TURNS = ("untraced", "traced", "traced", "untraced")
OBS_ATOL = 1e-9  # torch against numpy traces at sigma 0, float64
OBS_REL = 1e-9  # an attribution against its trace's total
OBS_PATH_REL = 0.05  # the walked path against the request's total_s
OBS_SLO_S = 1.0  # the served request's total_s objective (warm: ~0.5 s)
OBS_ADAPT_REQUESTS = 48  # the controller's requests; pA slows 5x at half
OBS_ADAPT_SCALE = 0.02  # phase 10's cost units as handler seconds
TRACE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "chip_smoke_obs_trace.json")
_NODE_ATTRS = ("poke_t", "prepare_t0", "prepare_t1", "cold_s", "fetch_s",
               "compute_t0", "compute_s")


def trace_gap(got, want) -> float:
    """Largest |difference| between two lists of traces of the same
    requests, over every node span's start and end, numeric attrs and
    per-edge payload and transfer times; raises where their structure
    differs."""
    ks = [[t.root.attrs["request_k"] for t in ts] for ts in (got, want)]
    if ks[0] != ks[1]:
        raise AssertionError(f"sampled requests differ: {ks}")
    gap = 0.0
    for tg, tw in zip(got, want):
        g, w = tg.node_spans(), tw.node_spans()
        if set(g) != set(w):
            raise AssertionError(f"node sets differ: {sorted(g)} vs {sorted(w)}")
        for n, sw in w.items():
            sg = g[n]
            pairs = [(sg.t_start, sw.t_start), (sg.t_end, sw.t_end)]
            pairs += [(sg.attrs[k], sw.attrs[k]) for k in _NODE_ATTRS]
            for k in ("payload_t", "transfer_s"):
                if set(sg.attrs[k]) != set(sw.attrs[k]):
                    raise AssertionError(f"{n}: {k} edges differ")
                pairs += [(sg.attrs[k][u], sw.attrs[k][u]) for u in sw.attrs[k]]
            for a, b in pairs:
                if (a is None) != (b is None):
                    raise AssertionError(f"{n}: {a} against {b}")
                if a is not None:
                    gap = max(gap, abs(a - b))
    return gap


def check_attribution(trace, total_s, rel, what):
    """The critical path of ``trace``: its buckets sum to its walked
    interval (rel 1e-9), and that interval is ``total_s`` within ``rel``."""
    cp = extract_critical_path(trace)
    att = sum(cp.attribution.values())
    if not abs(att - cp.total_s) <= OBS_REL * cp.total_s:
        raise AssertionError(f"{what}: attribution {att} != path {cp.total_s}")
    if not abs(cp.total_s - total_s) <= rel * total_s:
        raise AssertionError(f"{what}: path {cp.total_s} != total {total_s} "
                             f"within {rel}")
    return cp


def phase_obs_sweep() -> dict:
    """(a) The Fig-4 DAG on one placement, 16 seeds x 4096 requests, on the
    card: traced (Tracer(sample=64)) and untraced calls in turns. Every
    traced call's totals equal the untraced ones exactly; each trace's
    attribution sums to its total; at sigma 0 the sampled traces equal the
    numpy backend's node by node; every call launches cold_scan once a
    node."""
    steps, edges = document_dag_fig4()
    n, seeds = SIM_REQUESTS, tuple(range(SIM_SEEDS))
    launches = []

    def call(sim, spec):
        before = cold_scan.launches
        t0 = time.perf_counter()
        out = sim.simulate(spec, device=DEV)
        wall = time.perf_counter() - t0
        launches.append(cold_scan.launches - before)
        return out, wall

    sim = SIM.WorkflowSimulator(SIM.paper_platforms(), seed=0)
    spec = SIM.ExperimentSpec(steps, edges=edges, n_requests=n, seeds=seeds)
    base, _ = call(sim, spec)  # the first call: its costs stay out of the walls
    walls = {"untraced": [], "traced": []}
    n_traces = 0
    for turn in OBS_SWEEP_TURNS:
        tracer = Tracer(sample=OBS_SAMPLE) if turn == "traced" else None
        out, wall = call(sim, replace(spec, tracer=tracer))
        walls[turn].append(wall)
        if not np.array_equal(out, base):
            raise AssertionError(f"a {turn} sweep's totals differ from the first "
                                 f"call's: tracing is not draw-neutral")
        if tracer is None:
            continue
        traces = tracer.traces()
        if len(traces) != OBS_SAMPLE:
            raise AssertionError(f"{len(traces)} traces, not {OBS_SAMPLE}")
        for t in traces:
            k = t.root.attrs["request_k"]
            if t.root.attrs["backend"] != "torch" or t.root.attrs["seed"] != 0:
                raise AssertionError(f"trace attrs {t.root.attrs}")
            if not abs(t.total_s - out[0, k]) <= OBS_REL * out[0, k]:
                raise AssertionError(f"request {k}: trace total {t.total_s} != "
                                     f"sweep total {out[0, k]}")
            check_attribution(t, t.total_s, OBS_REL, f"sweep request {k}")
        n_traces += len(traces)
    if base.shape != (len(seeds), n) or not np.isfinite(base).all():
        raise AssertionError(f"bad sweep output {base.shape}")

    # sigma 0: the torch traces against the numpy backend's, node by node
    zsteps = zero_sigma(steps)
    tt, tn = Tracer(sample=OBS_SAMPLE), Tracer(sample=OBS_SAMPLE)
    call(SIM.WorkflowSimulator(zero_platforms(), seed=0),
         SIM.ExperimentSpec(zsteps, edges=edges, n_requests=n, seeds=seeds,
                            tracer=tt))
    SIM.WorkflowSimulator(zero_platforms(), seed=0).simulate(
        SIM.ExperimentSpec(zsteps, edges=edges, n_requests=n, seeds=(0,),
                           tracer=tn), backend="numpy")
    gap = trace_gap(tt.traces(), tn.traces())
    if not gap <= OBS_ATOL:
        raise AssertionError(f"sigma-0 torch traces differ from numpy by {gap}")
    if any(k != len(steps) for k in launches):
        raise AssertionError(f"cold_scan launches a call {launches}, not "
                             f"{len(steps)}")
    med = {k: statistics.median(v) for k, v in walls.items()}
    res = {"shape": [len(seeds), n], "sample": OBS_SAMPLE, "traces": n_traces,
           "walls_s": walls, "median_untraced_s": med["untraced"],
           "median_traced_s": med["traced"], "sigma0_max_abs_diff": gap,
           "calls": len(launches), "launches": sum(launches)}
    log(f"[obs] (a) traced sweep: {len(seeds)} seeds x {n} requests, Fig-4 DAG, "
        f"{OBS_SAMPLE} traces a call; totals equal untraced over "
        f"{len(OBS_SWEEP_TURNS)} turns; attributions sum to totals (rel "
        f"{OBS_REL:g}); sigma 0 vs numpy traces max |diff| {gap:.3g}; warm walls "
        f"median untraced {med['untraced'] * 1e3:.2f} ms, traced "
        f"{med['traced'] * 1e3:.2f} ms; cold_scan {sum(launches)} launches "
        f"over {len(launches)} calls")
    return res


def untrace(dep):
    dep.tracer = dep.cache.tracer = dep.prefetcher.tracer = dep.store.tracer = None


def serving_launch_gate(cfg, passes, what) -> dict:
    """The kernels launched since the counts were set to 0: each exactly as
    often as the counted prefills and forward passes make it."""
    per_prefill, got = launches_per_prefill(cfg), launch_counts()
    n_pass = passes["prefill"] + passes["decode"]
    for name, want in per_prefill.items():
        n = want * (n_pass if name == "rmsnorm" else passes["prefill"])
        if got[name] != n:
            raise AssertionError(f"{what}: {got[name]} {name} launches != {n} "
                                 f"(forward passes {passes})")
    if not got["flash_attention"] or not got["rmsnorm"]:
        raise AssertionError(f"{what}: the kernels were not launched: {got}")
    return got


def phase_obs_serving(cfg, params, prompts) -> tuple:
    """(b) The federated prefill -> decode workflow under ``instrument``,
    with a MetricsRegistry, a TailSampler and an SloTracker: untraced and
    traced turns of the same requests in one process. Each traced request's
    critical path is prefill then decode, its attribution sums to it, and
    it explains ``total_s`` within 5%; the Chrome trace parses back with
    every span. Returns (result, the last trace)."""
    V = cfg.vocab_size
    spec = SloSpec("serve-total", objective_s=OBS_SLO_S, target=0.9,
                   fast_window_s=60.0, slow_window_s=600.0, min_count=4)
    sampler = TailSampler(window_s=600.0, head_every=1, slo=spec, min_count=4)
    tracer = Tracer(max_traces=64, metrics=MetricsRegistry(), sampler=sampler)
    slo = SloTracker(spec, tracer=tracer)
    totals, paths = {"untraced": [], "traced": []}, []
    for k in MODEL_KERNELS.values():
        k.launches = 0
    with counting_passes() as passes, Deployment(serving_registry()) as dep:
        deploy_serving(dep, cfg, params)
        check_tokens(dep.run(SERVE_WF, prompts[0]).outputs, V, "cold request")
        for turn in OBS_SERVE_TURNS:
            if turn == "traced":
                instrument(dep, tracer)
            else:
                untrace(dep)
            for i, prompt in enumerate(prompts):
                r = dep.run(SERVE_WF, prompt)
                check_tokens(r.outputs, V, f"{turn} request {i}")
                totals[turn].append(r.total_s)
                if turn == "untraced":
                    continue
                slo.record(r.total_s, now=time.perf_counter())
                trace = tracer.last()
                if trace is None or trace.trace_id != r.request_id:
                    raise AssertionError(f"request {r.request_id} left no trace")
                cp = check_attribution(trace, r.total_s, OBS_PATH_REL,
                                       f"served request {i}")
                if cp.nodes != ["prefill", "decode"]:
                    raise AssertionError(f"critical path {cp.nodes}")
                paths.append({"prompt": len(prompt), "total_s": r.total_s,
                              "path_s": cp.total_s, "attribution": cp.attribution})
            for key in dep.store.keys("kv/"):
                dep.store.delete(key)
        # the side-stream prefetch: its pool thread lands the fetch events on
        # the span bound where the fetch started
        instrument(dep, tracer)
        probe = torch.arange(1 << 16, dtype=torch.float32)
        dep.store.put("obs/probe", probe, region="us-east")
        span = tracer.begin(name="probe").span("poke:probe", "poke",
                                               attrs={"node": "probe"})
        with tracer.bind(span):
            futs = dep.prefetcher.start([DataRef("obs/probe", "us-east")],
                                        "us-west", device=DEV)
        data, _, _ = dep.prefetcher.join(futs)
        sync()
        if not torch.equal(data["obs/probe"].cpu(), probe):
            raise AssertionError("the side-stream prefetch changed the tensor")
        if [e[1] for e in span.events] != ["prefetch.start", "prefetch.done"]:
            raise AssertionError(f"prefetch events on the bound span: {span.events}")
        report = dep.report()
        untrace(dep)
    launches = serving_launch_gate(cfg, passes.n, "obs serving")
    traces = tracer.traces()
    os.makedirs(os.path.dirname(TRACE_PATH), exist_ok=True)
    write_chrome_trace(TRACE_PATH, traces, tracer=tracer)
    with open(TRACE_PATH) as f:
        doc = json.load(f)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    n_spans = sum(len(t.spans) for t in traces)
    if len(traces) != len(paths) or len(xs) != n_spans:
        raise AssertionError(f"chrome trace: {len(xs)} complete events for "
                             f"{n_spans} spans of {len(traces)} traces")
    med = {k: statistics.median(v) for k, v in totals.items()}
    att = {b: statistics.median(p["attribution"][b] for p in paths)
           for b in paths[0]["attribution"]}
    res = {"turns": list(OBS_SERVE_TURNS), "total_s": totals,
           "median_untraced_s": med["untraced"], "median_traced_s": med["traced"],
           "overhead": med["traced"] / med["untraced"] - 1, "paths": paths,
           "median_attribution_s": att, "chrome_trace": os.path.relpath(TRACE_PATH),
           "chrome_events": len(doc["traceEvents"]), "spans": n_spans,
           "metrics_request_s": report["metrics"]["request_s/all"],
           "sampler": report["trace_sampler"], "slo": slo.snapshot(),
           "launches": launches, "passes": dict(passes.n)}
    log(f"[obs] (b) traced serving {cfg.name}: {len(paths)} traced and "
        f"{len(totals['untraced'])} untraced requests in turns; critical path "
        f"prefill -> decode explains total_s within {OBS_PATH_REL:g}; median "
        f"total_s untraced {med['untraced']:.4f} s, traced {med['traced']:.4f} s "
        f"({res['overhead'] * 100:+.2f}%); median attribution "
        + ", ".join(f"{b} {v * 1e3:.2f} ms" for b, v in att.items() if v)
        + f"; chrome trace {res['chrome_trace']}: {len(doc['traceEvents'])} "
        f"events, {n_spans} spans; launches {launches} over {passes.n}")
    return res, traces[-1]


def phase_obs_profiler(trace) -> dict:
    """(c) calibrate from a served trace, then rank every virtual
    intervention on the card (torch) and on the host (numpy), 16 seeds x
    4096 requests: the same order, predictions and deltas within 1e-9
    relative (+1e-12 s for the deltas, which are 0 for a hidden
    intervention), and the torch ranking launches cold_scan once a node a
    sweep."""
    world = calibrate(trace)
    kw = {"n_requests": SIM_REQUESTS, "seeds": tuple(range(SIM_SEEDS))}
    before = cold_scan.launches
    t0 = time.perf_counter()
    got = WhatIfProfiler(world, backend="torch", device=DEV, **kw).rank()
    torch_s = time.perf_counter() - t0
    launches = cold_scan.launches - before
    t0 = time.perf_counter()
    want = WhatIfProfiler(world, backend="numpy", **kw).rank()
    numpy_s = time.perf_counter() - t0
    if [(i.kind, i.target) for i in got] != [(i.kind, i.target) for i in want]:
        raise AssertionError(f"rankings differ: {[i.label for i in got]} vs "
                             f"{[i.label for i in want]}")
    worst = 0.0
    for g, w in zip(got, want):
        worst = max(worst, abs(g.predicted_s - w.predicted_s) / abs(w.predicted_s))
        if not (abs(g.predicted_s - w.predicted_s) <= OBS_REL * abs(w.predicted_s)
                and abs(g.delta_s - w.delta_s) <= OBS_REL * abs(w.delta_s) + 1e-12):
            raise AssertionError(f"{g.label} against {w.label}")
    if launches != len(world.steps) * (len(got) + 1):
        raise AssertionError(f"{launches} cold_scan launches for {len(got) + 1} "
                             f"sweeps of {len(world.steps)} nodes")
    res = {"ranking": [i.label for i in got], "interventions": len(got),
           "max_rel_diff": worst, "torch_s": torch_s, "numpy_s": numpy_s,
           "launches": launches}
    log(f"[obs] (c) what-if profiler on the served trace: {len(got)} "
        f"interventions, {SIM_SEEDS} seeds x {SIM_REQUESTS} requests; torch "
        f"ranking == numpy (max rel diff {worst:.3g}); walls torch {torch_s:.3f} "
        f"s, numpy {numpy_s:.3f} s; cold_scan {launches} launches; top: "
        + "; ".join(res["ranking"][:3]))
    return res


def phase_obs_controller() -> dict:
    """(d) Phase 10's drift scenario on the real engine: the 3-step chain
    behind AdaptiveDeployment(tracer=..., slo=...), gated on the torch
    scorer, pA's handler 5x slower from half-way. The swap to pB and its
    decisions land in the tracer's ring; every request leaves a trace."""
    reg = PlatformRegistry()
    reg.register(Platform("client", "edge", kind="edge", native_prefetch=True,
                          device=str(DEV)))
    reg.register(Platform("pA", "region-a", kind="cloud", device=str(DEV)))
    reg.register(Platform("pB", "region-b", kind="cloud", device=str(DEV)))
    for region in ("region-a", "region-b"):  # the store's wire time: the costs'
        reg.network.set_link("edge", region, 2 * 0.6 * OBS_ADAPT_SCALE, 1e12)
    slow = {"pA": 1.0, "pB": 1.0}

    def work_on(plat):
        def work(p, d):
            time.sleep(ADAPT_WORK[plat].median * OBS_ADAPT_SCALE * slow[plat])
            return p * 2
        return work

    tracer = Tracer(max_traces=OBS_ADAPT_REQUESTS)
    slo = SloTracker(SloSpec("adapt-total", objective_s=0.05, target=0.9,
                             fast_window_s=5.0, slow_window_s=20.0, min_count=4))
    scorer = PlacementScorer(quantile=0.9, backend="torch", device=DEV)
    before = cold_scan.launches
    with DagDeployment(reg) as dep:
        dep.deploy("ingest", lambda p, d: p, ["client"])
        dep.deploy("deliver", lambda p, d: p, ["client"])
        for plat in ("pA", "pB"):
            dep.deploy("work", work_on(plat), [plat])
        adapt = AdaptiveDeployment(
            dep, ADAPT_SPEC, {"work": ["pA", "pB"]}, adapt_costs(OBS_ADAPT_SCALE),
            every_n=8, drift_ratio=1.4, min_samples=2, scorer=scorer,
            tracer=tracer, slo=slo)
        swaps = []
        for k in range(OBS_ADAPT_REQUESTS):
            if k == OBS_ADAPT_REQUESTS // 2:
                slow["pA"] = 5.0
            if adapt.run(k).outputs != 2 * k:
                raise AssertionError(f"request {k}: wrong output")
            swaps += [{"request": k, "trigger": s["trigger"], **s["moved"]}
                      for s in list(adapt.swaps)[len(swaps):]]
        report = adapt.report()
    launches = cold_scan.launches - before
    names = [e[1] for e in tracer.events]
    res = {"requests": OBS_ADAPT_REQUESTS, "swaps": swaps,
           "decisions": names.count("recompose.decision"),
           "cutovers": names.count("recompose.cutover"),
           "traces": len(tracer.traces()), "slo": slo.snapshot(),
           "controller": report["adapt"]["controller"], "launches": launches}
    log(f"[obs] (d) AdaptiveDeployment(tracer, slo), pA 5x from request "
        f"{OBS_ADAPT_REQUESTS // 2}: swaps {swaps}; tracer ring "
        f"{res['decisions']} recompose.decision, {res['cutovers']} cutover; "
        f"{res['traces']} request traces; slo alerts {slo.alerts}; cold_scan "
        f"{launches} launches")
    if not res["decisions"] or not res["cutovers"] or not swaps:
        raise AssertionError(f"no recomposition in the tracer ring: {res}")
    if swaps[-1]["work"] != ("pA", "pB") or res["traces"] != OBS_ADAPT_REQUESTS:
        raise AssertionError(f"controller phase: {res}")
    if launches == 0:
        raise AssertionError("the torch scorer never launched cold_scan")
    return res


# ---------------------------------------------------------------------------
# phase 12: durable jobs over the served workflow
# ---------------------------------------------------------------------------
JOB_PROMPTS = 8
JOB_THREADS = 4  # each submits 4 prompts: every prompt twice in all
JOB_FAULTS_SEED = 0  # fails decode's attempts 0-2 of request 0, 0-1 of 5 and 6
JOB_JOIN_S = 600.0


def phase_jobs(cfg, params) -> dict:
    """A JobManager over the served workflow (on the DAG engine, whose
    results carry a status) with decode-pod failing 30% of attempts, 3
    attempts a request and a hedge after half a decode: 4 client threads
    submit 8 distinct prompts twice each. The ledger balances, every kept
    job's tokens are an unfaulted run's, a resubmitted completed job
    dedups, and a job whose timeout is short of one decode dead-letters
    with status "timeout"."""
    V = cfg.vocab_size
    rng = np.random.default_rng(12)
    lengths = np.linspace(BATCH_PROMPTS[0], BATCH_PROMPTS[1], JOB_PROMPTS + 1)
    prompts = [rng.integers(1, V, size=int(n)).astype(np.int32) for n in lengths]
    spec = DagSpec.from_chain(SERVE_WF)
    for k in MODEL_KERNELS.values():
        k.launches = 0
    with counting_passes() as passes:
        with DagDeployment(serving_registry()) as clean:
            idle = deploy_serving(clean, cfg, params)
            want, decode_s = [], []
            for i, p in enumerate(prompts[:JOB_PROMPTS]):
                r = clean.run(spec, p)
                check_tokens(r.outputs, V, f"unfaulted request {i}")
                want.append(r.outputs)
                decode_s.append(r.timeline["decode"]["compute_s"])
            short = 0.5 * min(decode_s)
            tracer = instrument(clean, Tracer())
            late = JobManager(clean, timeout_s=short).submit(prompts[-1], spec=spec)
            idle.wait_idle()
            status = tracer.last().root.attrs.get("status")
            if (late.status != "dead_lettered" or "TimeoutError" not in late.error
                    or status != "timeout" or clean.stats["timeouts"] != 1):
                raise AssertionError(f"timeout job: {late.status} {late.error} "
                                     f"trace status {status}")
        hedge = 0.5 * statistics.median(decode_s)
        tracer = Tracer(max_traces=64)
        with DagDeployment(
                serving_registry(), tracer=tracer,
                faults=FaultSchedule([FaultEvent("decode-pod", p_error=0.3)],
                                     seed=JOB_FAULTS_SEED),
                retry=RetryPolicy(max_attempts=3, hedge_after_s=hedge)) as dep:
            idle = deploy_serving(dep, cfg, params)
            jm = JobManager(dep, timeout_s=300.0)
            got, errs = [], []

            def client(i):
                try:
                    for j in range(2 * i, 2 * i + 4):
                        j %= JOB_PROMPTS
                        got.append((j, jm.submit(prompts[j], spec=spec)))
                except Exception as exc:  # raised by the main thread below
                    errs.append(exc)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(JOB_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(JOB_JOIN_S)
            if errs or any(t.is_alive() for t in threads):
                raise AssertionError(f"job clients failed or hung: {errs}")
            idle.wait_idle()
            stats = dict(jm.stats)
            kept = {job.job_id: (j, job) for j, job in got
                    if job.status == "completed"}
            retried = 0
            for j, job in kept.values():
                if job.result.outputs != want[j]:
                    raise AssertionError(f"prompt {j}: tokens {job.result.outputs} "
                                         f"!= unfaulted {want[j]}")
                retried += job.result.timeline["decode"]["attempts"] > 1
            j0, job0 = next(iter(kept.values()))
            again = jm.submit(prompts[j0], spec=spec)
            if (again is not job0 or jm.stats["deduped"] != stats["deduped"] + 1
                    or jm.stats["executed"] != stats["executed"]):
                raise AssertionError(f"resubmitted job {j0} did not dedup: {jm.stats}")
            engine = dep.report()["engine"]
            letters = [e for e in tracer.events if e[1] == "job.dead_letter"]
        launches = serving_launch_gate(cfg, passes.n, "jobs")
    submitted = JOB_THREADS * 4
    res = {"submitted": stats["submitted"], "kept": stats["kept"],
           "dead_lettered": stats["dead_lettered"], "deduped": stats["deduped"],
           "executed": stats["executed"], "kept_retried": retried,
           "dead_letters": [d.error[:80] for d in jm.dead_letters],
           "engine": {k: engine[k] for k in ("retries", "attempt_errors", "hedges",
                                             "hedge_wins", "hedge_cancelled")},
           "hedge_after_s": hedge, "timeout_s": short, "timeout_job": late.error[:80],
           "launches": launches, "passes": dict(passes.n)}
    log(f"[jobs] {submitted} submissions of {JOB_PROMPTS} prompts from "
        f"{JOB_THREADS} threads, decode-pod p_error 0.3, 3 attempts, hedge after "
        f"{hedge:.3f} s: kept {stats['kept']} + dead-lettered "
        f"{stats['dead_lettered']} = submitted {stats['submitted']}; executed "
        f"{stats['executed']}, deduped {stats['deduped']}; {retried} kept jobs "
        f"retried; engine {res['engine']}; every kept job's tokens == unfaulted; "
        f"resubmitted job deduped; the {short:.3f} s timeout job dead-lettered "
        f"({late.error[:40]}...); launches {launches} over {passes.n}")
    if (stats["kept"] + stats["dead_lettered"] != stats["submitted"]
            or stats["submitted"] != submitted):
        raise AssertionError(f"the job ledger does not balance: {stats}")
    if not (stats["dead_lettered"] and retried and engine["retries"]
            and engine["hedges"]) or len(letters) != len(jm.dead_letters):
        raise AssertionError(f"faults, retries or hedges did not all happen: {res}")
    return res


# ---------------------------------------------------------------------------
# the serving paths of the served models
# ---------------------------------------------------------------------------
MODEL_KERNELS = {"flash_attention": flash_attention, "ssd_scan": ssd_scan,
                 "rglru_scan": rglru_scan, "rmsnorm": rmsnorm}
SERVED = ("qwen3-1.7b", "mamba2-370m", "recurrentgemma-9b", "granite-moe-3b-a800m",
          "llama3.2-3b", "gemma3-27b", "qwen3-32b", "moonshot-v1-16b-a3b",
          "llava-next-34b", "hubert-xlarge")
AB_ARCHS = SERVED[:4]  # the norm A/B phases: these four only (the time limit)
WINDOW_PROMPT = 2500  # past recurrentgemma-9b's 2048 and gemma3-27b's 1024 windows
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


def local_cache_slots(cfg, caches) -> dict:
    """{cache: [slots of its k and v]} of every local layer's cache: the
    stacked cycle/p{j} ((L, B, S, K, hd)) and the remainder rem{i} ((B, S,
    K, hd))."""
    pattern = cfg.block_pattern
    n_cyc = cfg.num_layers // len(pattern)
    out = {}
    for j, kind in enumerate(pattern):
        if kind == "local" and n_cyc:
            out[f"cycle/p{j}"] = [t.shape[2] for t in caches["cycle"][f"p{j}"]]
    for i, kind in enumerate(cfg.layer_kinds()[n_cyc * len(pattern):]):
        if kind == "local":
            out[f"rem{i}"] = [t.shape[1] for t in caches[f"rem{i}"]]
    return out


def phase_window(cfg, params):
    """A prompt past the local layers' window: prefill's flash_attention
    masks by the window (recurrentgemma-9b: 2048 at d = 256; gemma3-27b:
    1024 at d = 128), every local layer's cache comes back as a ring buffer
    of the window, and decode writes past the ring's wrap. Kernel-path
    against plain-path logits at prefill and at every decode step (fed the
    same tokens)."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, cfg.vocab_size, size=WINDOW_PROMPT).astype(np.int32)
    tokens = torch.as_tensor(prompt, device=DEV)[None]
    max_len = WINDOW_PROMPT + WINDOW_DECODE
    paths = {}
    for name, c in (("kernel", cfg), ("plain", cfg.replace(use_pallas=False))):
        logits, caches = M.prefill(c, params, {"tokens": tokens})
        caches = pad_cache(caches, max_len, WINDOW_PROMPT, cfg=c)
        paths[name] = [c, caches, [logits]]
    slots = local_cache_slots(cfg, paths["kernel"][1])
    ring = [n for pair in slots.values() for n in pair]
    if not slots or ring != [cfg.local_window] * len(ring):
        raise AssertionError(f"local caches are not {cfg.local_window}-slot ring "
                             f"buffers: {slots}")
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
        f"ring buffers of {ring[0]} slots in {', '.join(slots)}, prefill + "
        f"{WINDOW_DECODE} decode steps "
        f"(positions {WINDOW_PROMPT}..{WINDOW_PROMPT + WINDOW_DECODE - 1}, ring "
        f"slots {WINDOW_PROMPT % cfg.local_window}..): kernel vs plain logits, "
        f"worst max_abs_diff / max_abs_logit {worst:.4g} (tol "
        f"{TOL[torch.bfloat16]:g}) ok")
    return {"prompt": WINDOW_PROMPT, "decode_steps": WINDOW_DECODE,
            "ring_caches": list(slots), "worst_rel_diff": worst}


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


def serve_prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
            for n in SERVE_PROMPTS]


OBS_ARCH = "qwen3-1.7b"  # phases 11 (b, c) and 12 run on its loaded weights


def serve_obs_jobs(cfg, params, prompts) -> dict:
    """Phases 11 (b, c) and 12 on one loaded model, each with the kernel
    counts set to 0 just before it and read just after."""
    obs, trace = phase_obs_serving(cfg, params, prompts)
    return {"obs": obs, "profiler": phase_obs_profiler(trace),
            "jobs": phase_jobs(cfg, params)}


def check_launches(arch, per_prefill, fed, total, passes, fed_passes, n_prompts,
                   n_batched):
    """Exact kernel launches over the federated requests (``fed``) and then
    the batching (``total``): one per layer of a kernel's block kind per
    prefill, rmsnorm once per norm per forward pass."""
    n_pass = passes["prefill"] + passes["decode"]
    log(f"[serving] {arch} launches per prefill {per_prefill}: federated {fed} "
        f"over {n_prompts} prefills; batching "
        f"{ {n: total[n] - fed[n] for n in total} } over {n_batched} prefills; "
        f"forward passes {passes} (federated {fed_passes})")
    if passes["prefill"] != n_prompts + n_batched:
        raise AssertionError(f"{arch}: {passes['prefill']} prefills counted, "
                             f"{n_prompts + n_batched} made")
    for n, want in per_prefill.items():
        if n == "rmsnorm":  # every forward pass, prefill or decode
            if total[n] != want * n_pass:
                raise AssertionError(f"{arch}: {total[n]} rmsnorm launches != "
                                     f"{want} per pass over {n_pass} passes")
            continue
        if fed[n] != want * n_prompts:
            raise AssertionError(f"{arch}: {fed[n]} {n} launches != {want} per "
                                 f"prefill over {n_prompts} prefills")
        if total[n] - fed[n] != want * n_batched:
            raise AssertionError(f"{arch}: batched prefills did not each launch "
                                 f"{n} {want} times")


def serve_model(arch) -> dict:
    """The serving path of one model at full width and depth: the federated
    workflow and (for a decoder) continuous batching with every kernel
    counter at 0 just before and read just after, then the checks and the
    profile off the counted path; for the first four models the norm A/B
    phases, and for qwen3-1.7b the traced serving, the profiler and the
    jobs phases on the same weights. The card's peak allocation is logged
    after init and after each phase; the model's wall from its first draw
    to its weights freed."""
    t_model = time.perf_counter()
    cfg = get_config(arch).replace(use_pallas=True)
    params, init = make_params(cfg)
    memory = {"init": init["peak_bytes"]}
    torch.cuda.reset_peak_memory_stats(DEV)
    prompts = serve_prompts(cfg)
    per_prefill = launches_per_prefill(cfg)

    for k in MODEL_KERNELS.values():
        k.launches = 0
    with counting_passes() as passes:
        requests = phase_federated(cfg, params, prompts)
        fed, fed_passes = launch_counts(), dict(passes.n)
        memory_mark(memory, "federated")
        batching = phase_batching(cfg, params) if cfg.supports_decode else None
        total = launch_counts()
    n_batched = batching["prefills"] + 1 if batching else 0  # + the prewarm prefill
    if batching:
        memory_mark(memory, "batching")
    check_launches(arch, per_prefill, fed, total, passes.n, fed_passes,
                   len(prompts), n_batched)

    moe = None
    if cfg.num_experts:
        moe = phase_moe(cfg, params, prompts[1])
        memory_mark(memory, "moe")
    checks = phase_checks(cfg, params, model_batch(cfg, prompts[1]))
    memory_mark(memory, "checks")
    window = None
    if "local" in cfg.block_pattern:
        window = phase_window(cfg, params)
        memory_mark(memory, "window")
    profile = phase_profile(cfg, params, model_batch(cfg, prompts[0], 0))
    memory_mark(memory, "profile")
    norm_ab = prologue_ab = None
    if arch in AB_ARCHS:
        norm_ab = phase_norm_ab(cfg, params, prompts[0])
        prologue_ab = phase_prologue_ab(cfg, params, prompts[0])
    extra = serve_obs_jobs(cfg, params, prompts) if arch == OBS_ARCH else {}
    if arch == MESH_ARCH:
        extra["mesh"] = phase_mesh_serving(cfg, params, prompts, requests, batching)
        memory_mark(memory, "mesh")
    if arch == STREAM_ARCH:
        extra["stream"] = phase_stream(cfg, params, prompts, requests)
        memory_mark(memory, "stream")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_model
    log(f"[serving] {arch}: every phase passed in {wall:.1f} s; peaks (GB) "
        + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in memory.items()))
    return {"arch": arch, "wall_s": wall, "init": init, "memory_peak_bytes": memory,
            "requests": requests, "batching": batching, "checks": checks,
            "profile": profile, "launches": total, "passes": passes.n,
            "per_prefill": per_prefill, "window": window, "moe": moe,
            "norm_ab": norm_ab, "prologue_ab": prologue_ab, **extra}


def phase_obs_only() -> dict:
    """``--only obs``: phase 11 alone, qwen3-1.7b loaded for (b) and (c)."""
    res = {"sweep": phase_obs_sweep()}
    cfg = get_config(OBS_ARCH).replace(use_pallas=True)
    params, _ = make_params(cfg)
    res["serving"], trace = phase_obs_serving(cfg, params, serve_prompts(cfg))
    res["profiler"] = phase_obs_profiler(trace)
    del params
    torch.cuda.empty_cache()
    res["controller"] = phase_obs_controller()
    return res


def phase_jobs_only() -> dict:
    """``--only jobs``: phase 12 alone, on qwen3-1.7b."""
    cfg = get_config(OBS_ARCH).replace(use_pallas=True)
    params, _ = make_params(cfg)
    res = phase_jobs(cfg, params)
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_STEPS = 16
TRAIN_BATCH = (8, 256)  # the reference TrainerConfig's global batch and seq_len
# the reference AdamWConfig's peak_lr with tests/test_trainer.py's warmup: the
# loss falls within 16 steps (at that test's 3e-3 its mean fell too, after a
# jump to over 3x the first step's loss: PERF.md §6)
TRAIN_ADAMW = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
TRAIN_F32_ARCHS = ("qwen3-1.7b", "mamba2-370m", "granite-moe-3b-a800m")
TRAIN_F32_BATCH = (2, 64)
TRAIN_RESTART = (12, 6)  # straight steps; steps before the restart
TRAIN_RTOL = 1e-5  # the restart's losses (tests/test_trainer.py)
# (d): the kernel path's loss against the plain path's, relative (PR 19's
# chip run measured 4.1e-5 at full depth); its hidden states and the tail's
# logits are held elementwise at the serving checks' bf16 gate
TRAIN_KERNEL_LOSS_RTOL = 1e-3
TRAIN_LOGITS_TAIL = 32  # positions of every row whose logits are compared
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ckpt")


def state_checksum(tree) -> list:
    """Per leaf: the sum and a position-weighted sum of its 32-bit words
    (int64, on the card, 2**24 words at a time). A change of any one word
    changes the first; the leaf's in-place version counter goes beside it."""
    out = []
    for t in tree_leaves(tree):
        w = t.detach().reshape(-1).view(torch.int32)
        total = weighted = 0
        for i in range(0, w.numel(), 1 << 24):
            c = w[i:i + (1 << 24)].long()
            pos = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
            total += int(c.sum())
            weighted += int((c * pos).sum())
        out.append((total, weighted, t._version))
    return out


def state_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def cut_depth(cfg):
    """Full width, one cycle of block_pattern (2 layers for a one-kind
    pattern)."""
    n = len(cfg.block_pattern)
    return cfg.replace(num_layers=n if n > 1 else 2)


def train_full() -> dict:
    """(a) qwen3-1.7b at full width and depth: Trainer.run for 16 steps,
    prewarmed, float32 master params and bf16 compute, no async save
    inside the 16 steps and the blocking final one timed; then one more
    step under the profiler and the kernels under grad (d) on its
    weights."""
    cfg = get_config(TRAIN_ARCH)
    if (cfg.use_pallas or cfg.param_dtype != "float32"
            or cfg.compute_dtype != "bfloat16"):
        raise AssertionError(f"{TRAIN_ARCH} does not train on the jnp path in "
                             f"float32/bf16: {cfg.use_pallas}, {cfg.param_dtype}, "
                             f"{cfg.compute_dtype}")
    B, T = TRAIN_BATCH
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    free = shutil.disk_usage(os.path.dirname(CKPT_DIR)).free
    tc = TrainerConfig(seq_len=T, global_batch=B, total_steps=TRAIN_STEPS,
                       checkpoint_every=TRAIN_STEPS + 1, checkpoint_dir=CKPT_DIR,
                       adamw=TRAIN_ADAMW)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.perf_counter()
    tr = Trainer(cfg, tc, device=DEV).init_state()
    sync()
    init_s = time.perf_counter() - t0
    params_b, opt_b = state_bytes(tr.params), state_bytes(tr.opt_state)
    n_params = sum(t.numel() for t in tree_leaves(tr.params))
    log(f"[train] {TRAIN_ARCH}: {cfg.num_layers} layers d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} "
        f"vocab={cfg.vocab_size}: {n_params / 1e9:.3f} B params, float32 master "
        f"{params_b / 1e9:.2f} GB + m/v {opt_b / 1e9:.2f} GB on {DEV} "
        f"({init_s:.1f} s); "
        f"disk free by the checkpoint dir {free / 1e9:.1f} GB")

    example = SyntheticCorpus(cfg.vocab_size, T, tc.seed).batch(0, B)
    state = {"params": tr.params, "opt": tr.opt_state}
    before = state_checksum(state)
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.perf_counter()
    tr.prewarm(example)
    sync()
    prewarm_s = time.perf_counter() - t0
    if state_checksum(state) != before:
        raise AssertionError("prewarm changed the params or the optimizer state")
    if tr.cache.stats["prewarms"] != 1:
        raise AssertionError(f"prewarm went around the compile cache: {tr.cache.stats}")
    prewarm_peak = torch.cuda.max_memory_allocated(DEV)
    log(f"[train] prewarm {prewarm_s:.2f} s through CompileCache; params and m/v "
        f"unchanged ({len(before)} leaves, word sums and version counters); peak "
        f"{prewarm_peak / 1e9:.2f} GB")

    for k in MODEL_KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.perf_counter()
    metrics = tr.run(TRAIN_STEPS)
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(DEV)
    if any(launches.values()):
        raise AssertionError(f"training launched port kernels: {launches}")
    losses = [m["loss"] for m in metrics]
    gnorms = [m["grad_norm"] for m in metrics]
    dts = [m["dt"] for m in metrics]
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"non-finite loss or grad norm: {losses}, {gnorms}")
    # Adam's first update makes the loss jump, which lifts the first 4's
    # mean: the last 4 must also be below the loss before any update
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    if not (last < first and last < losses[0]):
        raise AssertionError(f"the loss did not fall: step 0 {losses[0]}, first 4 "
                             f"{first}, last 4 {last}")
    step_s = statistics.median(dts)
    ck = tr.ckpt
    ckpt_bytes = ck.nbytes(tr.step)
    reckoned = params_b + opt_b + params_b  # + the float32 grads
    log(f"[train] {TRAIN_STEPS} steps of {B} x {T}: losses "
        + " ".join(f"{x:.3f}" for x in losses) + f"; grad norms {gnorms[0]:.3g} .. "
        f"{gnorms[-1]:.3g}; last 4's mean {last:.4f} below the first 4's {first:.4f} "
        f"and step 0's {losses[0]:.4f}")
    log(f"[train] warm step wall median {step_s * 1e3:.2f} ms "
        f"(min {min(dts) * 1e3:.2f}, "
        f"max {max(dts) * 1e3:.2f}), {B * T / step_s:.0f} tokens/s; run() "
        f"{run_s:.2f} s with the final save; peak max_memory_allocated "
        f"{peak / 1e9:.2f} GB beside params + m/v + grads {reckoned / 1e9:.2f} GB; "
        f"port kernel launches {launches}")
    log(f"[train] final checkpoint step {tr.step}: {ckpt_bytes / 1e9:.2f} GB on disk, "
        f"snapshot {ck.stats['blocked_s']:.2f} s, write {ck.stats['save_s']:.2f} s")

    batch = next(make_train_iterator(cfg, T, B, start_step=tr.step, seed=tc.seed,
                                     device=DEV))
    wall, kernels, ops, n_kernels = _profiled(
        lambda: tr._step_fn(tr.params, tr.opt_state, batch, tr.step))
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    log(f"[train] profiled step: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%), {n_kernels} device kernels")
    for kname, ks in top:
        log(f"[train]   {100 * ks / busy if busy else 0:5.1f}% {ks * 1e3:8.3f} ms  "
            f"{kname[:90]}")
    guard = train_kernels_forward(cfg, tr.params, batch)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    del tr, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": TRAIN_ARCH, "steps": TRAIN_STEPS, "batch": [B, T],
            "adamw": vars(TRAIN_ADAMW), "params": n_params, "init_s": init_s,
            "losses": losses, "grad_norms": gnorms, "step_s": dts,
            "step_median_s": step_s, "tokens_per_s": B * T / step_s,
            "prewarm_s": prewarm_s, "prewarm_peak_bytes": prewarm_peak,
            "peak_bytes": peak, "params_bytes": params_b, "opt_bytes": opt_b,
            "reckoned_bytes": reckoned, "ckpt_bytes": ckpt_bytes,
            "ckpt_snapshot_s": ck.stats["blocked_s"],
            "ckpt_write_s": ck.stats["save_s"],
            "launches": launches, "profile": {
                "wall_s": wall, "device_busy_s": busy, "device_kernels": n_kernels,
                "top": [[k[:90], v] for k, v in top],
                "top_ops": [[op, sh[:100], calls, ds]
                            for ds, calls, op, sh in ops[:4]]},
            "forward_kernels": guard}


def train_outputs(cfg, params, batch) -> tuple:
    """forward_train's final hidden states (B, T, D) and the float32 logits
    of the last TRAIN_LOGITS_TAIL positions of every row."""
    p = cast_params(cfg, params)
    x = embed_inputs(cfg, p, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, delta, _, _ = run_blocks(cfg, p, x, positions, "train")
    _, x = add_norm(cfg, x, delta, p["final_norm"])
    return x, unembed(cfg, p, x[:, -TRAIN_LOGITS_TAIL:, :]).float()


def _bf16_gate(what, got, want, moves) -> dict:
    """The serving checks' bf16 gate, elementwise: within TOL[bf16] of the
    largest magnitude, or twice the plain path's own move under NOISE."""
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    floor = max(moves)
    bound = max(TOL[torch.bfloat16] * scale, 2 * floor)
    log(f"[train]   {what} {tuple(got.shape)}: max_abs_diff={diff:.4g} max_abs "
        f"{scale:.4g}; plain path under noise moves "
        f"{', '.join(f'{m:.4g}' for m in moves)}; bound {bound:.4g}")
    if not (bool(torch.isfinite(got).all()) and diff <= bound):
        raise AssertionError(f"kernel-path {what} differ from the plain path: "
                             f"{diff} > {bound}")
    return {"max_abs_diff": diff, "max_abs": scale, "noise_moves": moves,
            "bound": bound}


def train_kernels_forward(cfg, params, batch) -> dict:
    """(d) Each kernel wrapper raises when an input requires grad; under
    no_grad, forward_train with use_pallas=True launches flash_attention
    once per layer and rmsnorm once per norm, its loss is the plain path's
    within TRAIN_KERNEL_LOSS_RTOL, and its final hidden states and the
    tail's logits are the plain path's within the serving checks' bf16
    gate."""
    g = torch.Generator(device=DEV).manual_seed(0)
    x = torch.randn(1, 64, 2, 128, generator=g, device=DEV, dtype=torch.bfloat16)
    w = torch.randn(128, generator=g, device=DEV)
    la = -torch.rand(1, 64, 128, generator=g, device=DEV)
    dt = torch.rand(1, 64, 2, generator=g, device=DEV)
    bm = torch.randn(1, 64, 128, generator=g, device=DEV, dtype=torch.bfloat16)
    calls = {"flash_attention": lambda t: flash_attention(t, x, x),
             "rmsnorm": lambda t: rmsnorm(t, w),
             "add_rmsnorm": lambda t: add_rmsnorm(t, x, w),
             "gated_rmsnorm": lambda t: gated_rmsnorm(x, t, w),
             "ssd_scan": lambda t: ssd_scan(t, dt, torch.zeros(2, device=DEV), bm, bm,
                                            64),
             "rglru_scan": lambda t: rglru_scan(la, t)}
    args = {"rglru_scan": la.clone()}
    refused = []
    for name, call in calls.items():
        arg = args.get(name, x).clone().requires_grad_()
        try:
            call(arg)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            refused.append(name)
        else:
            raise AssertionError(f"{name} did not refuse an input that requires grad")
    with torch.no_grad():  # the same calls run
        for name, call in calls.items():
            call(args.get(name, x).clone().requires_grad_())
    sync()
    want = launches_per_prefill(cfg)
    for k in MODEL_KERNELS.values():
        k.launches = 0
    with torch.no_grad():
        loss_k, _ = M.forward_train(cfg.replace(use_pallas=True), params, batch)
        counts = launch_counts()
        loss_p, _ = M.forward_train(cfg, params, batch)
        h_k, z_k = train_outputs(cfg.replace(use_pallas=True), params, batch)
        h_p, z_p = train_outputs(cfg, params, batch)
        moves_h, moves_z = [], []
        for seed in NOISE_SEEDS:
            restore = _perturbed_plain(seed)
            try:
                h_n, z_n = train_outputs(cfg, params, batch)
            finally:
                restore()
            moves_h.append((h_n.float() - h_p.float()).abs().max().item())
            moves_z.append((z_n - z_p).abs().max().item())
            del h_n, z_n
    sync()
    lk, lp = float(loss_k), float(loss_p)
    rel = abs(lk - lp) / abs(lp)
    log(f"[train] kernels under grad: {', '.join(refused)} raise on {DEV} and run "
        f"under no_grad; forward_train(use_pallas=True) under no_grad launches "
        f"{counts} (want {want}); loss {lk:.5f} vs plain path {lp:.5f}: {rel:.3g} "
        f"relative (tol {TRAIN_KERNEL_LOSS_RTOL:g})")
    if counts != want:
        raise AssertionError(f"forward_train launched {counts}, want {want}")
    if not rel <= TRAIN_KERNEL_LOSS_RTOL:
        raise AssertionError(f"kernel-path loss {lk} differs from the plain path's "
                             f"{lp} by {rel} relative > {TRAIN_KERNEL_LOSS_RTOL}")
    hidden = _bf16_gate("final hidden states", h_k, h_p, moves_h)
    logits = _bf16_gate(f"logits of the last {TRAIN_LOGITS_TAIL} positions", z_k,
                        z_p, moves_z)
    return {"refused": refused, "launches": counts, "loss_kernel": lk,
            "loss_plain": lp, "loss_rel_diff": rel,
            "loss_rtol": TRAIN_KERNEL_LOSS_RTOL, "hidden": hidden, "logits": logits}


def _assert_first_update(name, got, want, m_ref, p0, lr):
    """The params after Adam's first step (see tests/test_torch_train_step.py):
    entries with a resolved gradient within 1e-3 x lr; every entry within lr
    (1 + wd |p|). Returns the largest difference."""
    c = TRAIN_ADAMW
    worst = 0.0
    leaves = zip(tree_leaves(got), tree_leaves(want), tree_leaves(m_ref), p0,
                 strict=True)
    for a, b, m, p in leaves:
        a, b, g = a.cpu(), b.cpu(), m.cpu().abs()
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        resolved = (g >= 1e-3 * g.max()) & (g >= 1e3 * c.eps * (1 - c.b1))
        if resolved.any() and float(diff[resolved].max()) > 1e-3 * lr:
            raise AssertionError(f"{name}: a param with a resolved gradient moved "
                                 f"{float(diff[resolved].max())} from the CPU's")
        wd = c.weight_decay if p.ndim >= 2 else 0.0
        if not bool((diff <= lr * (1 + wd * p.abs()) * (1 + 1e-5)).all()):
            raise AssertionError(f"{name}: a param moved more than lr from the CPU's")
    return worst


def train_f32_check() -> dict:
    """(b) One make_train_step step in float32 at cut depth and full width
    on the card against the same step of the port on the CPU (which the
    CPU tests hold to the JAX package): loss within 1e-5 relative, grad
    norm within 1e-4 relative, m and v within 1e-4 of each leaf's largest
    entry, the params as the CPU tests hold them. TF32 is off (phase 1)."""
    out = {}
    B, T = TRAIN_F32_BATCH
    lr = float(cosine_schedule(0, peak_lr=TRAIN_ADAMW.peak_lr,
                               warmup_steps=TRAIN_ADAMW.warmup_steps,
                               total_steps=TRAIN_ADAMW.total_steps))
    cases = [(a, 1) for a in TRAIN_F32_ARCHS] + [(TRAIN_F32_ARCHS[0], 2)]
    for arch, nmb in cases:
        cfg = cut_depth(get_config(arch)).replace(param_dtype="float32",
                                                  compute_dtype="float32")
        cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        gpu = tree_map(lambda t: t.to(DEV, copy=True), cpu)
        p0 = [t.clone() for t in tree_leaves(cpu)]
        batch = SyntheticCorpus(cfg.vocab_size, T, 0).batch(0, B)
        opt = AdamW(TRAIN_ADAMW)
        step = M.make_train_step(cfg, opt, nmb)
        t0 = time.perf_counter()
        cpu, cst, cm = step(cpu, opt.init(cpu),
                            {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gpu, gst, gm = step(gpu, opt.init(gpu),
                            {k: torch.from_numpy(v).to(DEV)
                             for k, v in batch.items()}, 0)
        sync()
        gpu_s = time.perf_counter() - t0
        loss_rel = abs(float(gm["loss"]) - float(cm["loss"])) / abs(float(cm["loss"]))
        gn_rel = (abs(float(gm["grad_norm"]) - float(cm["grad_norm"]))
                  / float(cm["grad_norm"]))
        mv = 0.0
        for a, b in zip(tree_leaves([gst["m"], gst["v"]]),
                        tree_leaves([cst["m"], cst["v"]]), strict=True):
            scale = float(b.abs().max())
            mv = max(mv, float((a.cpu() - b).abs().max()) / scale if scale else 0.0)
        name = f"{arch}{' x2 microbatches' if nmb > 1 else ''}"
        p_worst = _assert_first_update(name, gpu, cpu, cst["m"], p0, lr)
        log(f"[train] f32 {name} ({cfg.num_layers} layers, full width, B={B} T={T}): "
            f"loss {float(gm['loss']):.6f} vs CPU {float(cm['loss']):.6f} (rel "
            f"{loss_rel:.2e}, tol 1e-5), grad norm rel {gn_rel:.2e} (tol 1e-4), m/v "
            f"{mv:.2e} of the leaf max (tol 1e-4), params max diff {p_worst:.3g} (lr "
            f"{lr:g}); card {gpu_s:.2f} s, CPU {cpu_s:.2f} s")
        if not (loss_rel <= 1e-5 and gn_rel <= 1e-4 and mv <= 1e-4):
            raise AssertionError(f"{name}: the card's float32 step differs from "
                                 "the CPU's")
        out[name] = {"layers": cfg.num_layers, "loss": float(gm["loss"]),
                     "loss_cpu": float(cm["loss"]), "loss_rel": loss_rel,
                     "grad_norm_rel": gn_rel, "moments_rel": mv,
                     "params_max_diff": p_worst,
                     "card_s": gpu_s, "cpu_s": cpu_s}
        del cpu, gpu, cst, gst
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_restart() -> dict:
    """(c) The restart drill at cut depth in the config's dtypes: 12 straight
    steps equal 6 steps, a fresh Trainer on the same directory, then 6 more;
    losses at rtol 1e-5."""
    cfg = cut_depth(get_config(TRAIN_ARCH))
    straight, first = TRAIN_RESTART
    B, T = TRAIN_BATCH

    def trainer(d, every):
        return Trainer(cfg, TrainerConfig(seq_len=T, global_batch=B,
                                          checkpoint_every=every,
                                          checkpoint_dir=os.path.join(CKPT_DIR, d),
                                          adamw=TRAIN_ADAMW), device=DEV)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    # the straight run saves only at its end; the interrupted one saves
    # asynchronously every 5 steps and at its end (step 6), the resumed one
    # asynchronously at 10 and at its end
    ref = [m["loss"] for m in trainer("a", straight + 1).run(straight)]
    trainer("b", first - 1).run(first)
    t3 = trainer("b", first - 1)
    got = [m["loss"] for m in t3.run(straight - first)]
    wall = time.perf_counter() - t0
    if t3.step != straight:
        raise AssertionError(f"the restarted trainer ended at step {t3.step}")
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, ref[first:]))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    log(f"[train] restart drill ({cfg.num_layers} layers, {cfg.compute_dtype}, "
        f"{B} x {T}): "
        f"{straight} straight vs {first} + restart + {straight - first}: largest "
        f"relative loss difference {worst:.3g} (tol {TRAIN_RTOL:g}), {wall:.1f} s")
    if not worst <= TRAIN_RTOL:
        raise AssertionError(f"the restart drill's losses differ by {worst}")
    del t3
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "losses": ref, "resumed": got,
            "max_rel_diff": worst, "wall_s": wall}


def phase_train() -> dict:
    """Phase 13: (a) and (d) on qwen3-1.7b at full width and depth, (b) the
    float32 cut-depth check, (c) the restart drill."""
    res, walls = {}, {}
    for name, fn in (("full", train_full), ("f32", train_f32_check),
                     ("restart", train_restart)):
        t0 = time.perf_counter()
        res[name] = fn()
        walls[name] = time.perf_counter() - t0
    res["wall_s"] = sum(walls.values())
    res["walls_s"] = walls
    log(f"[train] phase 13 passed in {res['wall_s']:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    return res


# ---------------------------------------------------------------------------
# phase 14: distribution
# ---------------------------------------------------------------------------
MESH_ARCH = "qwen3-1.7b"
MESH_AB_TURNS = ("plain", "mesh", "mesh", "plain")
MESH_AB_DECODE = 8
MESH_TRAIN_STEPS = (4, 4)  # before the re-mesh, after it
MESH_CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             "chip_smoke_mesh_ckpt")
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "decode_32k"),
                ("granite-moe-3b-a800m", "train_4k"),
                ("recurrentgemma-9b", "prefill_32k"))
DRYRUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "chip_smoke_dryrun")
DRYRUN_TIMEOUT_S = 900
ROOFLINE_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "experiments", "baselines",
                                 "roofline_baselines_torch.json")


def mesh_registry(mesh):
    """The README Quickstart's topology over the card: the edge client
    without a mesh, the prefill and decode clouds bound to ``mesh`` with
    their workloads' rules."""
    reg = PlatformRegistry()
    reg.register(bind_sharding(Platform("client", "us-east", kind="edge",
                                        native_prefetch=True, device="cpu"), mesh=mesh))
    reg.register(bind_sharding(Platform("prefill-pod", "us-east", native_prefetch=True,
                                        device=str(DEV)), mesh=mesh,
                               workload="prefill"))
    reg.register(bind_sharding(Platform("decode-pod", "us-west", native_prefetch=True,
                                        device=str(DEV)), mesh=mesh, workload="decode"))
    if reg.get("client").mesh is not None or any(
            reg.get(n).mesh is not mesh for n in ("prefill-pod", "decode-pod")):
        raise AssertionError("bind_sharding did not bind the Quickstart's topology")
    return reg


def mesh_ab(cfg, params, dparams, mesh, prompt) -> dict:
    """A warm prefill and MESH_AB_DECODE greedy decode steps, unmeshed and
    meshed (DTensor params, under the rules' context) in turns on the host
    clock: the walls, the meshed logits' largest difference from the
    unmeshed ones and the tokens of both."""
    tokens = torch.as_tensor(prompt, device=DEV)[None]
    ctx = {"plain": (shd.use_sharding(None, None), shd.use_sharding(None, None)),
           "mesh": (shd.use_sharding(mesh, shd.rules_for("prefill")),
                    shd.use_sharding(mesh, shd.rules_for("decode")))}
    walls = {k: {"prefill": [], "decode": []} for k in ctx}
    seqs, toks = {}, {}
    for i, turn in enumerate(("plain", "mesh") + MESH_AB_TURNS):  # 2 warm-up turns
        p = params if turn == "plain" else dparams
        sync()
        t0 = time.perf_counter()
        with ctx[turn][0]:
            lg, caches = M.prefill(cfg, p, {"tokens": tokens})
            caches = pad_cache(caches, MAX_LEN, len(prompt), cfg=cfg)
        seq, tok = [shd.full(lg)], [greedy(lg)]
        t1 = time.perf_counter()
        if turn == "mesh" and not shd.is_dtensor(lg):
            raise AssertionError("the meshed prefill's logits are not a DTensor")
        with ctx[turn][1]:
            for j in range(MESH_AB_DECODE):
                lg, caches = M.decode_step(
                    cfg, p, torch.tensor([[tok[-1]]], dtype=torch.int32, device=DEV),
                    caches, len(prompt) + j)
                seq.append(shd.full(lg))
                tok.append(greedy(lg))
        t2 = time.perf_counter()
        if i >= 2:
            walls[turn]["prefill"].append(t1 - t0)
            walls[turn]["decode"].append((t2 - t1) / MESH_AB_DECODE)
        seqs[turn], toks[turn] = seq, tok
    diff = max((a - b).abs().max().item() for a, b in zip(seqs["plain"], seqs["mesh"]))
    scale = max(a.abs().max().item() for a in seqs["plain"])
    med = {k: {w: statistics.median(v) for w, v in d.items()} for k, d in walls.items()}
    return {"tokens": toks, "max_abs_diff": diff, "max_abs_logit": scale,
            "walls_s": walls, "median_s": med,
            "ratio": {w: med["mesh"][w] / med["plain"][w]
                      for w in ("prefill", "decode")}}


def phase_mesh_serving(cfg, params, prompts, requests, batching) -> dict:
    """Phase 14 (a): qwen3-1.7b (use_pallas) served through the Quickstart's
    topology over a host mesh of the card, (1, 1): the federated workflow
    and the continuous batching with DTensor params, each kernel counter
    at 0 just before and read just after (exact launches, as phases 4-5);
    the greedy tokens of every request equal phases 4-5's; then the
    unmeshed and meshed prefill and decode in turns (walls reported; the
    logits gated at the serving bf16 gate)."""
    t_phase = time.perf_counter()
    mesh = make_host_mesh(device="cuda")
    if shd.mesh_shape(mesh) != {"data": 1, "model": 1}:
        raise AssertionError(f"host mesh {shd.mesh_shape(mesh)} on one card")
    dparams = M.distribute_params(params, M.param_defs(cfg), shd.rules_for("prefill"),
                                  mesh)
    per_prefill = launches_per_prefill(cfg)
    for k in MODEL_KERNELS.values():
        k.launches = 0
    with counting_passes() as passes:
        fed_requests = phase_federated(cfg, dparams, prompts, mesh_registry(mesh))
        fed, fed_passes = launch_counts(), dict(passes.n)
        with shd.use_sharding(mesh, shd.rules_for("decode")):
            bat = phase_batching(cfg, dparams)
        total = launch_counts()
    check_launches(f"{cfg.name} meshed", per_prefill, fed, total, passes.n, fed_passes,
                   len(prompts), bat["prefills"] + 1)
    got = [r["tokens"] for r in fed_requests]
    want = [r["tokens"] for r in requests]
    if got != want or bat["tokens"] != batching["tokens"]:
        raise AssertionError(f"meshed tokens differ from phases 4-5's: federated "
                             f"{got} vs {want}; batching {bat['tokens']} vs "
                             f"{batching['tokens']}")
    ab = mesh_ab(cfg, params, dparams, mesh, prompts[0])
    if ab["tokens"]["mesh"] != ab["tokens"]["plain"]:
        raise AssertionError(f"meshed greedy tokens {ab['tokens']['mesh']} != "
                             f"unmeshed {ab['tokens']['plain']}")
    tol = TOL[torch.bfloat16] * ab["max_abs_logit"]
    if not ab["max_abs_diff"] <= tol:
        raise AssertionError(f"meshed logits differ by {ab['max_abs_diff']} > {tol}")
    del dparams
    res = {"mesh": shd.mesh_shape(mesh), "requests": fed_requests, "batching": bat,
           "launches": total, "passes": passes.n, "per_prefill": per_prefill, "ab": ab,
           "wall_s": time.perf_counter() - t_phase}
    log(f"[mesh] (a) {cfg.name} on host mesh {res['mesh']}: {len(prompts)} federated "
        f"requests and {bat['done']} batched, tokens equal phases 4-5's; launches "
        f"{total} over passes {passes.n}; prefill + {MESH_AB_DECODE} decode steps in "
        f"turns: logits max_abs_diff {ab['max_abs_diff']:.4g} (gate {tol:.4g}), tokens "
        f"equal; prefill wall {ab['median_s']['mesh']['prefill'] * 1e3:.2f} vs "
        f"{ab['median_s']['plain']['prefill'] * 1e3:.2f} ms "
        f"(x{ab['ratio']['prefill']:.3f}), "
        f"decode step {ab['median_s']['mesh']['decode'] * 1e3:.2f} vs "
        f"{ab['median_s']['plain']['decode'] * 1e3:.2f} ms "
        f"(x{ab['ratio']['decode']:.3f}); "
        f"{res['wall_s']:.1f} s")
    return res


def word_sums(tree) -> list:
    """``state_checksum`` of each leaf's whole (a DTensor gathered), without
    the version counters."""
    return [c[:2] for c in state_checksum(tree_map(shd.full, tree))]


def phase_mesh_train(losses13) -> dict:
    """Phase 14 (b): Trainer(mesh=make_host_mesh()) on qwen3-1.7b at full
    width and depth, phase 13's seed, batch and optimizer: 4 steps, remesh
    onto a freshly built host mesh, 4 more. The params, m, v and count are
    bit-identical across the re-mesh; the 8 losses equal phase 13's first 8
    (rtol 1e-5); no port kernel launches (the plain path, as phase 13)."""
    cfg = get_config(TRAIN_ARCH)
    B, T = TRAIN_BATCH
    shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
    tc = TrainerConfig(seq_len=T, global_batch=B, total_steps=sum(MESH_TRAIN_STEPS),
                       checkpoint_every=sum(MESH_TRAIN_STEPS) + 1,
                       checkpoint_dir=MESH_CKPT_DIR, adamw=TRAIN_ADAMW)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    t_phase = time.perf_counter()
    tr = Trainer(cfg, tc, mesh=make_host_mesh(device="cuda"))
    for k in MODEL_KERNELS.values():
        k.launches = 0
    tr.run(MESH_TRAIN_STEPS[0])
    state = {"params": tr.params, "opt": tr.opt_state}
    before, count = word_sums(state), int(tr.opt_state["count"])
    t0 = time.perf_counter()
    tr.remesh(make_host_mesh(device="cuda"))
    sync()
    remesh_s = time.perf_counter() - t0
    after = word_sums({"params": tr.params, "opt": tr.opt_state})
    if after != before or int(tr.opt_state["count"]) != count:
        raise AssertionError("remesh changed the params, m, v or count")
    if not all(shd.is_dtensor(t) for t in tree_leaves(tr.params)):
        raise AssertionError("the meshed trainer's params are not DTensors")
    tr.run(MESH_TRAIN_STEPS[1])
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"meshed training launched port kernels: {launches}")
    losses = [m["loss"] for m in tr.metrics_log]
    dts = [m["dt"] for m in tr.metrics_log]
    want = losses13[:len(losses)]
    if not np.allclose(losses, want, rtol=TRAIN_RTOL, atol=0):
        raise AssertionError(f"meshed losses {losses} differ from phase 13's {want}")
    peak = torch.cuda.max_memory_allocated(DEV)
    ck = tr.ckpt.stats
    del tr, state
    shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    res = {"arch": TRAIN_ARCH, "steps": list(MESH_TRAIN_STEPS), "losses": losses,
           "phase13_losses": want, "max_rel_diff": max(
               abs(a - b) / abs(b) for a, b in zip(losses, want)),
           "step_s": dts, "step_median_s": statistics.median(dts), "remesh_s": remesh_s,
           "peak_bytes": peak, "ckpt_snapshot_s": ck["blocked_s"],
           "ckpt_write_s": ck["save_s"], "launches": launches, "wall_s": wall}
    log(f"[mesh] (b) Trainer on the host mesh: {MESH_TRAIN_STEPS[0]} steps, remesh "
        f"({remesh_s:.2f} s; params, m, v and count bit-identical), "
        f"{MESH_TRAIN_STEPS[1]} more: losses " + " ".join(f"{x:.3f}" for x in losses)
        + f" equal phase 13's first {len(losses)} (largest rel diff "
        f"{res['max_rel_diff']:.3g}, rtol {TRAIN_RTOL:g}); step wall median "
        f"{res['step_median_s'] * 1e3:.2f} ms (phase 13's (a): see [train]); peak "
        f"{peak / 1e9:.2f} GB; two final checkpoints, snapshot "
        f"{ck['blocked_s']:.2f} s, "
        f"write {ck['save_s']:.2f} s; {wall:.1f} s")
    return res


def start_dryrun():
    """Phase 14 (c), started: the dry-run of DRYRUN_CELLS on both H100 meshes
    in a subprocess (its fake process group cannot share a process with the
    card's NCCL group), on the host's cores while the card runs the other
    phases. Its tensors are meta tensors, so its meshes take the CPU device
    type and the card is hidden from it: a CUDA context of its own would
    take memory that llava-next-34b's checks need."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
         ",".join(f"{a}:{s}" for a, s in DRYRUN_CELLS), "--both-meshes",
         "--device", "cpu", "--out-dir", DRYRUN_DIR],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def phase_dryrun(proc) -> dict:
    """Phase 14 (c), collected: every cell's roofline line, and the
    invariants of tests/test_dryrun.py on each JSON (256 or 512 devices)."""
    t0 = time.perf_counter()
    try:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    waited = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.startswith(("[dryrun]", "dry-run"))]
    for ln in lines:
        log(f"[mesh] (c) {ln}")
    if proc.returncode != 0:
        raise AssertionError(f"the dry-run failed (exit {proc.returncode}):\n"
                             + out[-3000:])
    cells = {}
    for name in sorted(os.listdir(DRYRUN_DIR)):
        with open(os.path.join(DRYRUN_DIR, name)) as f:
            d = json.load(f)
        r = d["roofline"]
        if not (r["bottleneck"] in ("compute", "memory", "collective")
                and d["flops_per_dev_step"] > 0
                and r["step_s_lower_bound"] >= max(r["compute_s"], 1e-12) - 1e-12
                and d["n_devices"] in (256, 512)):
            raise AssertionError(f"dry-run cell {name} breaks the invariants: {d}")
        cells[name[:-5]] = {k: d[k] for k in (
            "mesh", "n_devices", "n_micro", "compile_s", "flops_per_dev_step",
            "bytes_per_dev_step", "scan_correction_flops_dev", "peak_temp_bytes",
            "useful_flops_ratio", "analytic_flops_dev", "collectives", "roofline")}
    if len(cells) != 2 * len(DRYRUN_CELLS):
        raise AssertionError(f"{len(cells)} dry-run cells written, "
                             f"{2 * len(DRYRUN_CELLS)} run")
    walls = [c["compile_s"] for c in cells.values()]
    log(f"[mesh] (c) {len(cells)} cells on the 256- and 512-GPU fake meshes, "
        "invariants "
        f"held; wall per cell {min(walls):.1f}-{max(walls):.1f} s (sum "
        f"{sum(walls):.1f} s; waited {waited:.1f} s at the end)")
    return {"cells": cells, "wall_per_cell_s": walls, "waited_s": waited,
            "roofline": phase_roofline()}


FAULT5_CELL = "recurrentgemma-9b|prefill_32k|multipod_2x32x8|"


def phase_roofline() -> dict:
    """Phase 14 (c), reported: launch/roofline.py over the dry-run's cells
    (the analytic memory term, the bottleneck chosen again, the flags), the
    table and the bottlenecks' split, the baseline as measured here, and
    ``--check`` against experiments/baselines/roofline_baselines_torch.json
    (rtol 5%). The multi-pod prefill_32k cell must be flagged as
    replicating its batch (fault 5)."""
    import contextlib
    import io
    from repro_torch.launch import roofline as RF
    rows = RF.load(DRYRUN_DIR)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        RF.report(rows)
        rc = RF.check(rows, ROOFLINE_BASELINE)
    for ln in out.getvalue().splitlines():
        log(f"[mesh] (c) roofline {ln}")
    measured = {RF.cell_key(r): RF.summarize(r) for r in rows}
    log("[mesh] (c) roofline baseline as measured: "
        + json.dumps(measured, sort_keys=True))
    flags = {RF.cell_key(r): r["flags"] for r in rows if r["flags"]}
    if "replicated-batch" not in flags.get(FAULT5_CELL, []):
        raise AssertionError(f"{FAULT5_CELL} is not flagged as replicated: {flags}")
    if rc != 0:
        raise AssertionError("the roofline --check against the committed "
                             "baseline failed (the lines above)")
    return {"split": RF.split(rows), "split_counted": RF.split(
        rows, "bottleneck_counted"), "flags": flags, "cells": measured}


def phase_mesh_only() -> dict:
    """``--only mesh``: phase 14 alone, with its own references: qwen3-1.7b
    served unmeshed (phases 4-5) then meshed, 8 unmeshed training steps
    then the meshed run, the dry-run."""
    proc = start_dryrun()
    try:
        cfg = get_config(MESH_ARCH).replace(use_pallas=True)
        params, _ = make_params(cfg)
        prompts = serve_prompts(cfg)
        requests = phase_federated(cfg, params, prompts)
        batching = phase_batching(cfg, params)
        serving = phase_mesh_serving(cfg, params, prompts, requests, batching)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        B, T = TRAIN_BATCH
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        ref = Trainer(get_config(TRAIN_ARCH), TrainerConfig(
            seq_len=T, global_batch=B, total_steps=8, checkpoint_every=9,
            checkpoint_dir=CKPT_DIR, adamw=TRAIN_ADAMW), device=DEV)
        losses = [m["loss"] for m in ref.run(sum(MESH_TRAIN_STEPS))]
        del ref
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        train = phase_mesh_train(losses)
        return {"serving": serving, "train": train, "dryrun": phase_dryrun(proc)}
    finally:
        if proc.poll() is None:
            proc.kill()


# ---------------------------------------------------------------------------
# phase 15: streamed federated serving
# ---------------------------------------------------------------------------
STREAM_ARCH = "qwen3-1.7b"
STREAM_CHUNKS = 8
STREAM_STAGING = "us-central"  # setting (a)'s staging payload_region
STREAM_P2P_BYTES = 1e6  # setting (b): payload edges up to 1 MB go peer to peer
STREAM_P2P_KV_BYTES = 1e9  # setting (c): the 117 MB cache in the payload, P2P
STREAM_PREFETCH_BYTES = 64 * 2**20  # (d): a float32 data dependency of 64 MiB
WRAPPER_CALLS = 200
WRAPPER_BAR_S = 1e-3  # paper §4.1, tests/test_choreography.py


def stream_registry():
    """``serving_registry()`` with a decode pod that takes no direct calls
    (a public cloud, ``allows_sync=False``): the prefill -> decode payload
    edge then crosses the data plane (streamed through the store or peer to
    peer), where the stock topology hands it over in place."""
    reg = serving_registry()
    reg.register(replace(reg.get("decode-pod"), allows_sync=False))
    return reg


def edge_modeled_s(dep, payload, p2p) -> tuple:
    """The bytes of ``payload``, the one prefill returned, and the (first
    byte, whole) modeled seconds of the prefill -> decode edge carrying it,
    as the engine prices it: peer to peer, one hop on the network model;
    streamed, a chunked put to the payload region and a chunked get from
    it, each hop's chunks from the store's ``_chunk_dts``."""
    from repro_torch.core.store import _sizeof
    nbytes = _sizeof(payload)
    src = dep.registry.get("prefill-pod").region
    dst = dep.registry.get("decode-pod").region
    if p2p:
        dt = dep.registry.network.transfer_s(src, dst, nbytes)
        return nbytes, dt, dt
    hops = [dep.store._chunk_dts(a, b, nbytes, dep.stream.chunks)
            for a, b in ((src, dep.payload_region), (dep.payload_region, dst))]
    return nbytes, sum(h[0] for h in hops), sum(sum(h) for h in hops)


def stream_setting(cfg, params, prompts, want, name, stream, payload_region,
                   kv_in_payload=False):
    """The federated workflow (phase 4's prompts and handlers) on
    ``stream_registry()`` with ``stream`` and ``payload_region``; with
    ``kv_in_payload`` the caches ride in the payload as card tensors. Each
    request's tokens equal ``want``'s; each request's decode stream_wait_s,
    the payload edge's modeled first byte and whole, the store's modeled
    seconds (the KV cache's put and get where it goes through the store,
    and the edge where it crosses the store) and the wall."""
    rows, sent = [], []
    with Deployment(stream_registry(), stream=stream,
                    payload_region=payload_region) as dep:
        deploy_serving(dep, cfg, params, kv_in_payload=kv_in_payload, sent=sent)
        net = dep.store.network
        for a, b in (("us-east", STREAM_STAGING), (STREAM_STAGING, "us-west")):
            net.set_link(a, b, 0.02, 200e6)
        for i, prompt in enumerate(prompts):
            s0 = dep.store.stats_snapshot()
            e0 = dict(dep.stats)
            r = dep.run(SERVE_WF, prompt)
            s1 = dep.store.stats_snapshot()
            check_tokens(r.outputs, cfg.vocab_size, f"{name} request {i}")
            if r.outputs != want[i]:
                raise AssertionError(f"{name} request {i}: tokens {r.outputs} != "
                                     f"phase 4's {want[i]}")
            p2p = dep.stats["p2p_edges"] - e0["p2p_edges"]
            nbytes, first, whole = edge_modeled_s(dep, sent[-1], p2p)
            row = {"prompt": len(prompt), "tokens": r.outputs, "wall_s": r.total_s,
                   "payload_bytes": nbytes,
                   "stream_wait_s": r.timeline["decode"]["stream_wait_s"],
                   "first_byte_s": first, "edge_modeled_s": whole,
                   "store_modeled_s": (s1["modeled_put_s"] - s0["modeled_put_s"]
                                       + s1["modeled_get_s"] - s0["modeled_get_s"])}
            rows.append(row)
            log(f"[stream] {name} request {i} ({'cold' if i == 0 else 'warm'}) "
                f"prompt {len(prompt)}: wall {r.total_s:.4f} s, stream_wait "
                f"{row['stream_wait_s'] * 1e3:.3f} ms, payload {nbytes} B, edge "
                f"modeled first byte "
                f"{first * 1e3:.3f} ms / whole {whole * 1e3:.3f} ms, store "
                f"modeled {row['store_modeled_s']:.4f} s, tokens equal phase 4's")
        rep = dep.report()
        wrappers = {f"{n}@{p}": fn.wrapper.overhead_s / fn.wrapper.calls
                    for (n, p), fn in dep._functions.items() if fn.wrapper.calls}
    eng = rep["engine"]
    return {"requests": rows, "engine": {k: eng[k] for k in (
        "buffered_edges", "streamed_edges", "p2p_edges", "pokes")},
        "compile": rep["compile"], "wrapper_overhead_s": wrappers}


def stream_prefetch() -> dict:
    """(d): a 64 MiB float32 tensor in the store (us-east), pre-fetched to
    the card in us-west through ``Prefetcher(stream=StreamConfig(chunks=8))``:
    the chunked fetch, then the pinned side-stream copy and its event. It
    lands on the card bit for bit, counted as streamed."""
    n = STREAM_PREFETCH_BYTES // 4
    host = torch.from_numpy(np.random.default_rng(21).standard_normal(
        n, dtype=np.float32))
    store = ObjectStore()
    store.network.set_link("us-east", "us-west", 0.02, 200e6)
    store.put("blob/0", host, region="us-east")
    pf = Prefetcher(store, stream=StreamConfig(chunks=STREAM_CHUNKS))
    try:
        sync()
        t0 = time.perf_counter()
        out, exposed, modeled = pf.join(
            pf.start([DataRef("blob/0", "us-east")], "us-west", device=DEV))
        joined = time.perf_counter() - t0
        sync()
        wall = time.perf_counter() - t0
    finally:
        pf.shutdown()
    got = out["blob/0"]
    stats = pf.stats_snapshot()
    same = got.device == DEV and torch.equal(got.view(torch.int32).cpu(),
                                             host.view(torch.int32))
    if not same or stats["streamed"] != 1:
        raise AssertionError(f"streamed prefetch: on {got.device}, bit-exact "
                             f"{same}, stats {stats}")
    res = {"bytes": host.numel() * 4, "wall_s": wall, "joined_s": joined,
           "exposed_s": exposed,
           "modeled_s": modeled, "first_byte_s": stats["first_byte_s"],
           "streamed": stats["streamed"]}
    log(f"[stream] (d) {res['bytes'] / 2**20:.0f} MiB streamed prefetch in "
        f"{STREAM_CHUNKS} chunks onto {DEV}: bit-exact; wall {wall:.4f} s (joined "
        f"after {joined:.4f} s, the join's exposed wait {exposed:.4f} s), "
        f"modeled {modeled:.4f} s (first byte {res['first_byte_s']:.4f} s)")
    return res


def wrapper_overhead() -> tuple:
    """The platform wrapper's own seconds a call (``overhead_s``, as the
    JAX package measures it: the work before the step, without entering
    the contexts) and the whole call's wall (the ``torch.cuda.device``
    context's entry and exit included), on a CUDA platform and on a CPU
    one, WRAPPER_CALLS calls of a no-op each, both held to WRAPPER_BAR_S."""
    from repro_torch.core.platform import PlatformWrapper
    own, call = {}, {}
    for dev in (str(DEV), "cpu"):
        w = PlatformWrapper(Platform("p", "us-east", device=dev), lambda p, d: p)
        t0 = time.perf_counter()
        for _ in range(WRAPPER_CALLS):
            w(1, {})
        call[dev] = (time.perf_counter() - t0) / WRAPPER_CALLS
        own[dev] = w.overhead_s / w.calls
        if not (own[dev] < WRAPPER_BAR_S and call[dev] < WRAPPER_BAR_S):
            raise AssertionError(f"wrapper overhead {own[dev]} s, call {call[dev]} "
                                 f"s a call on {dev}")
    return own, call


def phase_stream(cfg, params, prompts, requests) -> dict:
    """Phase 15: qwen3-1.7b (use_pallas) served through the federated
    workflow with the streaming data plane, on phase 4's weights and
    prompts, every kernel counter at 0 just before and read just after:
    (a) StreamConfig(chunks=8) with a staging payload_region, so the
    prefill -> decode payload edge streams (the decode fires on its first
    chunk); (b) a p2p threshold that sends that edge peer to peer; (c) the
    caches in that payload as card tensors, sent peer to peer and computed
    on by decode as received (the engine's claim that the device's default
    stream orders them across the platform threads). Every request's tokens
    equal phase 4's; streamed_edges > 0 in (a), p2p_edges > 0 in (b) and
    (c); exact launches (flash_attention per prefill, rmsnorm per norm per
    pass). Then (d) the 64 MiB streamed prefetch onto the card and the
    wrapper's overhead on a CUDA and a CPU platform."""
    t_phase = time.perf_counter()
    want = [r["tokens"] for r in requests]
    per_prefill = launches_per_prefill(cfg)
    for k in MODEL_KERNELS.values():
        k.launches = 0
    with counting_passes() as passes:
        a = stream_setting(cfg, params, prompts, want, "(a) streamed",
                           StreamConfig(chunks=STREAM_CHUNKS), STREAM_STAGING)
        b = stream_setting(cfg, params, prompts, want, "(b) p2p",
                           StreamConfig(chunks=STREAM_CHUNKS,
                                        p2p_threshold_bytes=STREAM_P2P_BYTES), None)
        c = stream_setting(cfg, params, prompts, want, "(c) p2p, caches on the card",
                           StreamConfig(chunks=STREAM_CHUNKS,
                                        p2p_threshold_bytes=STREAM_P2P_KV_BYTES),
                           None, kv_in_payload=True)
        launches = launch_counts()
    check_launches(f"{cfg.name} streamed", per_prefill, launches, launches, passes.n,
                   dict(passes.n), 3 * len(prompts), 0)
    if not a["engine"]["streamed_edges"] > 0 or a["engine"]["p2p_edges"]:
        raise AssertionError(f"(a) did not stream its payload edges: {a['engine']}")
    for name, x in (("(b)", b), ("(c)", c)):
        if not x["engine"]["p2p_edges"] > 0 or x["engine"]["streamed_edges"]:
            raise AssertionError(f"{name} did not send its payload edges P2P: "
                                 f"{x['engine']}")
    if not (c["requests"][0]["payload_bytes"]
            > 1000 * b["requests"][0]["payload_bytes"]):
        raise AssertionError("(c)'s payload did not carry the caches: "
                             f"{c['requests'][0]} against {b['requests'][0]}")
    for s in (a, b, c):
        if s["compile"]["prewarms"] != 1 or s["compile"]["misses"] != 0:
            raise AssertionError(f"decode was not pre-warmed by the poke: "
                                 f"{s['compile']}")
    res = {"streamed": a, "p2p": b, "p2p_kv": c, "prefetch": stream_prefetch(),
           "launches": launches,
           "passes": passes.n, "per_prefill": per_prefill}
    res["wrapper_overhead_s"], res["wrapper_call_s"] = wrapper_overhead()
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"[stream] {cfg.name}: (a) streamed_edges {a['engine']['streamed_edges']}, "
        f"(b) p2p_edges {b['engine']['p2p_edges']}, (c) p2p_edges with the caches "
        f"on the card {c['engine']['p2p_edges']}, every request's tokens equal "
        f"phase 4's; launches {launches} over passes {passes.n}; wrapper overhead "
        + ", ".join(f"{d} {v * 1e6:.2f} us (the whole call "
                    f"{res['wrapper_call_s'][d] * 1e6:.2f} us)"
                    for d, v in res["wrapper_overhead_s"].items())
        + f" a call; {res['wall_s']:.1f} s")
    return res


def phase_stream_only() -> dict:
    """``--only stream``: phase 4's federated requests of qwen3-1.7b (the
    unstreamed tokens), then phase 15 on the same weights."""
    cfg = get_config(STREAM_ARCH).replace(use_pallas=True)
    params, _ = make_params(cfg)
    prompts = serve_prompts(cfg)
    res = phase_stream(cfg, params, prompts, phase_federated(cfg, params, prompts))
    del params
    torch.cuda.empty_cache()
    return res


ONLY_PHASES = {"kernels": lambda: phase_kernels(), "ssd_scan": lambda: phase_ssd_scan(),
               "rglru_scan": lambda: phase_rglru_scan(),
               "rmsnorm": lambda: phase_rmsnorm(),
               "cold_scan": lambda: phase_cold_scan(),
               "tile_cost": lambda: phase_tile_cost(), "obs": phase_obs_only,
               "jobs": phase_jobs_only, "train": lambda: phase_train(),
               "mesh": phase_mesh_only, "stream": phase_stream_only}


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        names = sys.argv[2].split(",")
        unknown = [n for n in names if n not in ONLY_PHASES]
        if unknown:
            sys.exit(f"chip_smoke: unknown phases {unknown}; choose from "
                     f"{sorted(ONLY_PHASES)}")
        global KEEP_GOING
        KEEP_GOING = True
        phase_device()
        phase_build()
        for n in names:
            log(json.dumps({n: ONLY_PHASES[n]()}, default=str))
        if FAILURES:
            sys.exit(f"chip_smoke: {len(FAILURES)} cases failed")
        return
    if len(sys.argv) > 1:
        sys.exit(f"chip_smoke: usage: {sys.argv[0]} [--only PHASE,...]")
    t_run = time.perf_counter()
    walls = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t0
        return out

    smi = phase_device()
    ptxas = timed("build", phase_build)
    dryrun_proc = start_dryrun()  # phase 14 (c), on the host's cores meanwhile
    try:
        main_phases(smi, ptxas, dryrun_proc, t_run, walls, timed)
    finally:
        if dryrun_proc.poll() is None:
            dryrun_proc.kill()
            dryrun_proc.communicate()


def main_phases(smi, ptxas, dryrun_proc, t_run, walls, timed):
    """Phases 3-14 and the result lines of a full run."""
    fa = timed("kernels", phase_kernels)
    ssd = timed("ssd_scan", phase_ssd_scan)
    rg = timed("rglru_scan", phase_rglru_scan)
    cs = timed("cold_scan", phase_cold_scan)
    rn = timed("rmsnorm", phase_rmsnorm)
    served = timed("serving", lambda: [serve_model(arch) for arch in SERVED])
    t_rest = time.perf_counter()

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
    adapt, scorer_args = phase_adapt()
    adapt_launches = cold_scan.launches
    log(f"[adapt] cold_scan launches: {adapt_launches}")
    if adapt_launches == 0:
        raise AssertionError("the torch scorer never launched cold_scan")
    cs["scorer"] = phase_scorer_scan(scorer_args)
    # the observability plane's simulator paths: each call and phase counts
    # its own cold_scan launches
    obs_sweep = phase_obs_sweep()
    obs_controller = phase_obs_controller()
    obs_served = next(m for m in served if m["arch"] == OBS_ARCH)
    walls["sim, adapt, obs"] = time.perf_counter() - t_rest
    train = timed("train", phase_train)
    mesh_train = timed("mesh (b)", lambda: phase_mesh_train(train["full"]["losses"]))
    dryrun = timed("mesh (c) wait", lambda: phase_dryrun(dryrun_proc))
    mesh_served = next(m for m in served if m["arch"] == MESH_ARCH)["mesh"]
    stream_served = next(m for m in served if m["arch"] == STREAM_ARCH)["stream"]

    def model_launches(name):
        return sum(m["launches"][name] for m in served)

    def served_launches(name) -> dict:
        """Launches by main path: serving and batching of the served models,
        the traced serving (11 b) and the jobs phase (12) of qwen3-1.7b,
        training (13 a: none, the jnp path), the no_grad forward_train
        of 13 (d), phase 14's meshed serving (a) and training (b), and
        phase 15's streamed serving."""
        return {"serving": model_launches(name),
                "obs": obs_served["obs"]["launches"][name],
                "jobs": obs_served["jobs"]["launches"][name],
                "train": train["full"]["launches"][name],
                "train_forward_no_grad":
                    train["full"]["forward_kernels"]["launches"][name],
                "mesh_serving": mesh_served["launches"][name],
                "stream": stream_served["launches"][name],
                "mesh_train": mesh_train["launches"][name]}

    cold_paths = {"sim": sim_launches, "adapt": adapt_launches,
                  "obs_sweep": obs_sweep["launches"],
                  "obs_profiler": obs_served["profiler"]["launches"],
                  "obs_controller": obs_controller["launches"]}

    cs64, cs32 = cs["float64"], cs["float32"]
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "sources": ["src/repro_torch/kernels/csrc/flash_attention.cu",
                    "src/repro_torch/kernels/csrc/flash_attention_mma.cu",
                    "src/repro_torch/kernels/csrc/flash_attention_f32.cu"],
        "replaces": "src/repro/kernels/flash_attention.py:88",
        "launches": sum(served_launches("flash_attention").values()),
        "launches_by_path": served_launches("flash_attention"),
        "max_abs_err": fa["max_abs_err"],
        "tolerance": fa["tolerance"], "ms": fa["ms"], "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "shapes": {arch: {k: r[k] for k in (
            "shape", "window", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")}
            for arch, r in fa["shapes"].items()},
        "launches_by_model": {m["arch"]: m["launches"]["flash_attention"]
                              for m in served if m["launches"]["flash_attention"]},
        "ptxas": {**ptxas["flash_attention"], **ptxas["flash_attention_mma"],
                  **ptxas["flash_attention_f32"]},
    }, {
        "name": "cold_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cold_scan.cu",
        "replaces": "src/repro/kernels/cold_scan.py:83",
        "launches": sum(cold_paths.values()), "launches_by_path": cold_paths,
        "dtype": "float64",
        "shape": cs["shape"], "max_abs_err": cs["max_abs_err"],
        "tolerance": COLD_SCAN_TOL, "ms": cs64["ms"],
        "plain_ms": cs64["plain_ms"], "parallel_ms": cs64["parallel_ms"],
        "bound_ms": cs64["bound_ms"], "bound_by": cs64["bound_by"],
        "library_ms": None,
        "float32": {k: cs32[k] for k in ("ms", "plain_ms", "parallel_ms",
                                         "bound_ms", "bound_by")},
        "scorer": cs["scorer"],
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:71",
        "launches": sum(served_launches("ssd_scan").values()),
        "launches_by_path": served_launches("ssd_scan"), "dtype": "bfloat16",
        "shape": [1, 512, 32, 64, 128, 256], "max_abs_err": ssd["max_abs_err"],
        "tolerance": ssd["tolerance"], "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
        "library_ms": None, "device_kernels": ["ssd_cb_bf16", "ssd_scan_kernel<bf16>"],
        "ptxas": ptxas["ssd_scan"],
    }, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:49",
        "launches": sum(served_launches("rglru_scan").values()),
        "launches_by_path": served_launches("rglru_scan"), "dtype": "float32",
        "shape": rg["shape"], "max_abs_err": rg["max_abs_err"],
        "tolerance": rg["tolerance"], "ms": rg["ms"], "plain_ms": rg["plain_ms"],
        "yardstick_ms": rg["yardstick_ms"], "bound_ms": rg["bound_ms"],
        "bound_by": rg["bound_by"], "library_ms": None,
    }, {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:24",
        "launches": sum(served_launches("rmsnorm").values()),
        "launches_by_path": served_launches("rmsnorm"),
        "launches_by_model": {m["arch"]: m["launches"]["rmsnorm"] for m in served},
        "dtype": "bfloat16",
        "shape": rn["shape"], "max_abs_err": rn["max_abs_err"],
        "tolerance": rn["tolerance"], "ms": rn["ms"], "plain_ms": rn["plain_ms"],
        "bound_ms": rn["bound_ms"], "bound_by": rn["bound_by"],
        "library_ms": rn["library_ms"],
        "library": "torch.nn.functional.rms_norm on the float32 input",
        "prologues": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "shape")}
                      for k, r in rn["prologues"].items()},
        "decode": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}
                   for k, r in rn["decode"].items()},
        "shapes": {arch: {k: {f: r[f] for f in ("shape", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}
                          for k, r in by.items()}
                   for arch, by in rn["shapes"].items()},
    }]
    for m in served:
        log(json.dumps({"serving": {k: v for k, v in m.items()
                                    if k not in ("obs", "profiler", "jobs", "mesh",
                                                 "stream")}}))
    log(json.dumps({"stream": stream_served}, default=str))
    log(json.dumps({"mesh": {"serving": mesh_served, "train": mesh_train,
                             "dryrun": dryrun}}, default=str))
    log(json.dumps({"sim": sim, "adapt": adapt, "cold_scan": cs}))
    log(json.dumps({"obs": {"sweep": obs_sweep, "serving": obs_served["obs"],
                            "profiler": obs_served["profiler"],
                            "controller": obs_controller},
                    "jobs": obs_served["jobs"]}, default=str))
    log(json.dumps({"train": train}, default=str))
    log(f"[wall] every phase passed in {time.perf_counter() - t_run:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + "; served "
        + ", ".join(f"{m['arch']} {m['wall_s']:.1f} s" for m in served))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
