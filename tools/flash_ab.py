"""Flash attention's host cost and prefill walls, one checkout against another.

    python3 tools/flash_ab.py ROOT_A ROOT_B [--turns ABBA]

ROOT_A and ROOT_B are checkouts of this repo (for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists,
and the working tree ``.``). Each runs in its own process, in the turns
A, B, B, A (or ``--turns``), with ``ROOT/src`` first on the path, so each builds and loads
its own CUDA kernels (into ``ROOT/build/torch_kernels``). A turn measures,
on the card:

- the flash_attention wrapper at the three served prefill shapes (qwen3,
  granite, recurrentgemma; 512 tokens, bf16, causal): host time per call
  (host clock over 500 calls queued without a synchronise, which the card
  keeps up with) and device time per call (CUDA events);
- one ``cuTensorMapEncodeTiled`` call (libcuda through ctypes, the
  arguments the wgmma kernel encodes for q) and one
  ``cuTensorMapReplaceAddress`` call on its result, each timed over 20000
  calls;
- warm prefill walls (host clock, each ended by a synchronise, median of
  15 after 3 warm-ups) of qwen3-1.7b at 512 and 300 tokens and
  granite-moe-3b-a800m at 512, at full width with random bf16 weights from
  seed 0, three ways in turn: as served; with the host time inside the
  model's flash_attention calls summed (``flash_host_ms``); and with those
  calls replaced by ``torch.empty_like(q)`` (``no_flash``), which is the
  wall without flash attention's host or device cost.

Prints one JSON line per turn and a summary of medians per checkout. Needs
one card; ``--device cpu`` rehearses a turn at the smoke configs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

TURNS = "ABBA"
SHAPES = {  # (T, H, K, d, window) of a 512-token prefill, B = 1
    "qwen3-1.7b": (512, 16, 8, 128, None),
    "granite-moe-3b-a800m": (512, 24, 8, 64, None),
    "recurrentgemma-9b": (512, 16, 1, 256, 2048),
}
PREFILLS = (("qwen3-1.7b", 512), ("qwen3-1.7b", 300), ("granite-moe-3b-a800m", 512))
HOST_CALLS = 500
ENCODES = 20000


def encode_us(q) -> tuple:
    """Host times (us) of one cuTensorMapEncodeTiled call on q (B, T, H, d)
    bf16, viewed as (d, H, T, B) with (64, 1, 64, 1) boxes in the 128-byte
    swizzle, as the wgmma kernel encodes it, and of one
    cuTensorMapReplaceAddress call on that map."""
    cuda = ctypes.CDLL("libcuda.so.1")
    fn = cuda.cuTensorMapEncodeTiled
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, u32, ctypes.c_void_p,
                   ctypes.POINTER(u64), ctypes.POINTER(u64), ctypes.POINTER(u32),
                   ctypes.POINTER(u32), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    B, T, H, d = q.shape
    dims = (u64 * 4)(d, H, T, B)
    strides = (u64 * 3)(d * 2, H * d * 2, T * H * d * 2)
    box = (u32 * 4)(64, 1, 64, 1)
    elem = (u32 * 4)(1, 1, 1, 1)
    buf = ctypes.create_string_buffer(128 + 64)
    addr = (ctypes.addressof(buf) + 63) // 64 * 64  # CUtensorMap is 64-byte aligned
    # CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9, INTERLEAVE_NONE = 0,
    # SWIZZLE_128B = 3, L2_PROMOTION_L2_128B = 2, FLOAT_OOB_FILL_NONE = 0
    args = (addr, 9, 4, q.data_ptr(), dims, strides, box, elem, 0, 3, 2, 0)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"cuTensorMapEncodeTiled returned {err}")
    t0 = time.perf_counter()
    for _ in range(ENCODES):
        fn(*args)
    encode = (time.perf_counter() - t0) / ENCODES * 1e6
    replace = cuda.cuTensorMapReplaceAddress
    replace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    replace.restype = ctypes.c_int
    if replace(addr, q.data_ptr()) != 0:
        raise RuntimeError("cuTensorMapReplaceAddress failed")
    t0 = time.perf_counter()
    for _ in range(ENCODES):
        replace(addr, q.data_ptr())
    return encode, (time.perf_counter() - t0) / ENCODES * 1e6


def worker(root: str, device: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.transformer import cast_params

    src = os.path.join(os.path.abspath(root), "src")
    if not os.path.abspath(repro_torch.__file__).startswith(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {root}'s")
    dev = torch.device(device)
    cpu = dev.type == "cpu"

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    out = {"root": root, "wrapper": {}}
    for arch, (T, H, K, d, window) in SHAPES.items():
        T = 64 if cpu else T
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(1, T, h, d, generator=g, device=dev).to(torch.bfloat16)
                   for h in (H, K, K))

        def call():
            return FA.flash_attention(q, k, v, causal=True, window=window)

        call()
        sync()
        calls = 5 if cpu else HOST_CALLS
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        host_us = (time.perf_counter() - t0) / calls * 1e6
        sync()
        res = {"host_us": host_us}
        if not cpu:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(100_000_000)  # queue the calls behind ~50 ms
            a.record()
            for _ in range(100):
                call()
            b.record()
            b.synchronize()
            res["device_us"] = a.elapsed_time(b) / 100 * 1e3
            if arch == "qwen3-1.7b":
                out["encode_us"], out["replace_us"] = encode_us(q)
        out["wrapper"][arch] = res

    out["prefill_ms"], out["flash_host_ms"], out["no_flash_prefill_ms"] = {}, {}, {}
    kernel = L.flash_attention
    inside = [0.0]

    def timed(*a, **kw):
        t0 = time.perf_counter()
        r = kernel(*a, **kw)
        inside[0] += time.perf_counter() - t0
        return r

    def empty(q, *a, **kw):
        return torch.empty_like(q)

    for arch in dict(PREFILLS):
        cfg = get_config(arch).replace(use_pallas=True)
        if cpu:
            from repro_torch.configs.registry import smoke_config
            cfg = smoke_config(arch).replace(use_pallas=True)
        params = cast_params(cfg, M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
        rng = np.random.default_rng(0)
        for a, n in PREFILLS:
            if a != arch:
                continue
            n = min(n, 32) if cpu else n
            tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=n)
                                     .astype(np.int32), device=dev)[None]
            key = f"{arch}@{n}"
            for name, fn in (("prefill_ms", kernel), ("flash_host_ms", timed),
                             ("no_flash_prefill_ms", empty)):
                L.flash_attention = fn
                walls, hosts = [], []
                try:
                    for i in range(3 + (2 if cpu else 15)):
                        sync()
                        inside[0] = 0.0
                        t0 = time.perf_counter()
                        M.prefill(cfg, params, {"tokens": tokens})
                        sync()
                        if i >= 3:
                            walls.append((time.perf_counter() - t0) * 1e3)
                            hosts.append(inside[0] * 1e3)
                finally:
                    L.flash_attention = kernel
                out[name][key] = statistics.median(hosts if fn is timed else walls)
        del params
        if not cpu:
            torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="ROOT_A ROOT_B (or ROOT with --worker)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--turns", default=TURNS, help="order of the turns, e.g. ABBAABBA")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.roots[0], args.device)), flush=True)
        return
    if len(args.roots) != 2 or set(args.turns) != {"A", "B"}:
        ap.error("give two checkouts, and turns of A and B")
    roots = {"A": args.roots[0], "B": args.roots[1]}
    extra = ["--device", args.device]
    runs = {"A": [], "B": []}
    for turn in args.turns:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               roots[turn], *extra], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"turn {turn} ({roots[turn]}) failed:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": turn, **res}), flush=True)
        runs[turn].append(res)
    for name, rs in runs.items():
        summary = {"root": roots[name]}
        for arch in SHAPES:
            for key in rs[0]["wrapper"][arch]:
                summary[f"{arch} wrapper {key}"] = statistics.median(
                    r["wrapper"][arch][key] for r in rs)
        for key in ("encode_us", "replace_us"):
            if key in rs[0]:
                summary[key] = statistics.median(r[key] for r in rs)
        for metric in ("prefill_ms", "flash_host_ms", "no_flash_prefill_ms"):
            for key in rs[0][metric]:
                summary[f"{metric} {key}"] = statistics.median(r[metric][key] for r in rs)
        print(json.dumps({"summary": name, **summary}), flush=True)


if __name__ == "__main__":
    main()
