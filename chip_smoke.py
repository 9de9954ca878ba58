"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result):
  1. device   the card's name and power limit (nvidia-smi); TF32 off
  2. build    nvcc builds every CUDA kernel of the port from csrc/ into
              build/torch_kernels/ (one nvcc per source, all in parallel)
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the serving path's shapes and a few edge cases; timings
              (CUDA events over 20 back-to-back calls, median of 20) beside
              the plain version, the library call and the bound
  4. serving  qwen3-1.7b at full width (random weights from a seed, bf16):
              3 requests through the federated prefill -> decode workflow
              (Deployment over two platforms, KV cache shipped through the
              object store); the decode step is pre-warmed by the poke
  5. batching the same model under ServingEngine's continuous batching
  6. checks   kernel-path against plain-path prefill logits; the
              prefetcher's side-stream copy to the card, bit-exact
  7. profile  torch.profiler over one warm prefill and 8 decode steps:
              device busy share, the kernels that take the device time and
              the ops that launched them
Then one JSON line describing every kernel (launches counted over phases
4-5, the main path), the card's name and power limit, and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
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
BATCH_PROMPTS = (256, 512)  # continuous batching: prompt lengths drawn here


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
    paths = build.build_all(["flash_attention"])
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
    both dtypes, ragged lengths and windows with and without causality."""
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
             ("(k) ragged", 1, 65, 65, 4, 2, 32, torch.float32, True, None))
    for seed, args in enumerate(cases, start=2):
        flash_case(*args, seed=seed)
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
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}: {n / 1e9:.3f} B params, "
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
def phase_checks(cfg, params, prompt):
    tokens = torch.as_tensor(prompt, device=DEV)[None]
    k_logits, _ = M.prefill(cfg, params, {"tokens": tokens})
    p_logits, _ = M.prefill(cfg.replace(use_pallas=False), params, {"tokens": tokens})
    sync()
    diff = (k_logits - p_logits).abs().max().item()
    scale = p_logits.abs().max().item()
    log(f"[checks] prefill logits kernel vs plain path (prompt {len(prompt)}): "
        f"max_abs_diff={diff:.4g} max_abs_logit={scale:.4g} "
        f"argmax {greedy(k_logits)} vs {greedy(p_logits)}")
    if not diff <= TOL[torch.bfloat16] * scale:
        raise AssertionError(f"kernel-path logits differ from the plain path: "
                             f"{diff} > {TOL[torch.bfloat16]} * {scale}")

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


def main():
    smi = phase_device()
    phase_build()
    fa = phase_kernels()

    cfg = get_config("qwen3-1.7b").replace(use_pallas=True)
    params = make_params(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (512, 300, 512)]

    # the main path: every launch counter at 0 just before, read just after
    flash_attention.launches = 0
    requests = phase_federated(cfg, params, prompts)
    fed_launches = flash_attention.launches
    batching = phase_batching(cfg, params)
    launches = flash_attention.launches
    per_prefill = cfg.num_layers
    log(f"[serving] flash_attention launches: {fed_launches} over "
        f"{len(prompts)} federated prefills, {launches - fed_launches} over "
        f"{batching['prefills']} batched prefills + 1 prewarm prefill")
    if fed_launches != per_prefill * len(prompts):
        raise AssertionError(f"{fed_launches} launches != {per_prefill} per prefill")
    if launches - fed_launches != per_prefill * (batching["prefills"] + 1):
        raise AssertionError("batched prefills did not each launch the kernel "
                             f"{per_prefill} times")

    phase_checks(cfg, params, prompts[1])
    profile = phase_profile(cfg, params, prompts[0])

    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:88",
        "launches": launches, "max_abs_err": fa["max_abs_err"],
        "tolerance": fa["tolerance"], "ms": fa["ms"], "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"],
    }]
    log(json.dumps({"serving": {"requests": requests, "batching": batching,
                                "profile": profile}}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
