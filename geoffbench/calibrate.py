"""The readings that ``correct``'s limits are set from, on the card at the
cell's own size: for each seed, a short window of the cell's traffic
through the program and its sample judged against the float32 reference
(the program's reading), and on the first ``--control`` seeds the fp8
control put in the program's place on the same inputs (the control's
reading). One process, one weight buffer refilled per seed.

    python3 geoffbench/calibrate.py --workload <name> --seeds 11,12,... \
        --seconds 8 --control 3 [--out chiprun_out/calibrate.jsonl]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from geoffbench.cell import Cell

    cell = Cell(args.workload, "cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    out = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        cell.setup(seed)
        win = cell.window(cell.schedule(seed, args.seconds), seed, args.seconds)
        cell.shutdown()
        t1 = time.perf_counter()
        _, _, numbers, ctrl, picked = cell.judge(win, seed, {}, control=i < args.control)
        line = {"workload": args.workload, "seed": seed, "program": numbers,
                "control": ctrl, "sample_tokens": picked,
                "requests": len(win.records), "run_s": t1 - t0,
                "judge_s": time.perf_counter() - t1,
                "device": torch.cuda.get_device_name(0)}
        out.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in out:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
