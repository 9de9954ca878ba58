"""The rmsnorm wrapper's device and host time, one checkout against another.

    python3 tools/norm_ab.py ROOT_A ROOT_B [--turns ABBA]

ROOT_A and ROOT_B are checkouts of this repo (for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists,
and the working tree ``.``). Each runs in its own process, in the turns
A, B, B, A (or ``--turns``), with ``ROOT/src`` first on the path, so each
builds and loads its own kernels (into ``ROOT/build/torch_kernels``). A turn
measures ``rmsnorm(x, w)`` (no prologue: what every checkout has), bf16 x
and w, at granite's prefill shape (512 x 1536), a decode step's rows (1
and 4 at each served width) and qwen3's 4-slot qk-norm (64 x 128):

- device time per call: 100 calls queued behind a ~10 ms sleep kernel,
  CUDA events around them, median of 10 such runs;
- host time per call: the host clock over 500 calls without a synchronise;
- the launch floor: an empty kernel (``torch.cuda._sleep(0)``), timed as
  the device time.

Prints one JSON line per turn and the medians per checkout. Needs one card;
``--device cpu`` rehearses a turn (host times of the plain versions only).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TURNS = "ABBA"
SHAPES = ((512, 1536), (1, 1024), (4, 1024), (1, 1536), (4, 1536), (1, 2048),
          (4, 2048), (1, 4096), (4, 4096), (64, 128))
HOST_CALLS = 500


def worker(root: str, device: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch

    import repro_torch
    from repro_torch.kernels.rmsnorm import rmsnorm

    src = os.path.join(os.path.abspath(root), "src")
    if not os.path.abspath(repro_torch.__file__).startswith(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {root}'s")
    dev = torch.device(device)
    cpu = dev.type == "cpu"

    def device_us(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            torch.cuda._sleep(20_000_000)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(100):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 100 * 1e3)
        return statistics.median(times)

    out = {"root": root, "shapes": {}}
    if not cpu:
        out["floor_us"] = device_us(lambda: torch.cuda._sleep(0))
    g = torch.Generator(device=dev).manual_seed(0)
    for rows, D in SHAPES:
        x = torch.randn(rows, D, generator=g, device=dev).to(torch.bfloat16)
        w = (0.1 * torch.randn(D, generator=g, device=dev)).to(torch.bfloat16)

        def call():
            return rmsnorm(x, w)

        call()
        calls = 5 if cpu else HOST_CALLS
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        res = {"host_us": (time.perf_counter() - t0) / calls * 1e6}
        if not cpu:
            torch.cuda.synchronize()
            res["device_us"] = device_us(call)
        out["shapes"][f"{rows}x{D}"] = res
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
    runs = {"A": [], "B": []}
    for turn in args.turns:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               roots[turn], "--device", args.device],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"turn {turn} ({roots[turn]}) failed:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": turn, **res}), flush=True)
        runs[turn].append(res)
    for name, rs in runs.items():
        summary = {"root": roots[name]}
        if "floor_us" in rs[0]:
            summary["floor_us"] = statistics.median(r["floor_us"] for r in rs)
        for shape in rs[0]["shapes"]:
            for key in rs[0]["shapes"][shape]:
                summary[f"{shape} {key}"] = statistics.median(
                    r["shapes"][shape][key] for r in rs)
        print(json.dumps({"summary": name, **summary}), flush=True)


if __name__ == "__main__":
    main()
