"""Find an open cell's knee on the card, once, when the cell is defined:
windows of the cell's traffic at fixed offered rates, in one process on
one set of weights. The highest rate without a growing backlog (latency
that climbs from the window's first third to its last, and a drain past
its close) is the knee; the cell's mix then fixes its rate at about four
fifths of it. A closed cell runs its windows as they are (``--rates``
ignored), to read its throughput and memory.

    python3 geoffbench/sweep.py --workload <name> --seed <n> --seconds <s> \
        --rates 2,3,4 [--trace-rate 3] [--out chiprun_out/sweep.jsonl]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def summary(win, rate) -> dict:
    from geoffbench import stats, trace
    done = [r for r in win.records if r.ok]
    lat = [r.latency for r in done]
    third = max(1, len(done) // 3)
    by_due = sorted(done, key=lambda r: r.due)
    end = win.t0 + win.seconds
    out = {"rate": rate, "requests": len(win.records), "failed": len(win.records) - len(done),
           "p50_s": stats.quantile(lat, 0.5) if lat else None,
           "p90_s": stats.quantile(lat, 0.9) if lat else None,
           "p99_s": stats.quantile(lat, 0.99) if lat else None,
           "first_third_mean_s": statistics.mean(r.latency for r in by_due[:third]) if lat else None,
           "last_third_mean_s": statistics.mean(r.latency for r in by_due[-third:]) if lat else None,
           "drain_s": max(r.done for r in done) - end if done else None,
           "tokens_per_s": sum(r.req.tokens for r in done if r.done <= end) / win.seconds,
           "late_s": win.late_s,
           "mean_in_flight": (sum(r.done - r.sent for r in done)
                              / (max(r.done for r in done) - win.t0)) if done else None}
    t = win.trace
    if t is not None:
        busy = trace.busy_s(t.events, t.lo_ns, t.hi_ns)
        inside = [e for e in t.events if t.lo_ns - 10**9 <= e[1] <= t.hi_ns + 10**9]
        out.update(busy_s=busy, window_s=t.window_s, events=len(t.events),
                   events_inside=len(inside),
                   first_event_after_start_ms=(min(e[1] for e in t.events) - t.lo_ns) / 1e6
                   if t.events else None,
                   top=trace.top_ops(t.events, 5))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--windows", type=int, default=1, help="closed cells: windows to run")
    ap.add_argument("--trace-rate", type=float, default=None)
    ap.add_argument("--clients", type=int, default=None,
                    help="closed cells: clients (and warm-up concurrency) to try")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from geoffbench.cell import Cell

    cell = Cell(args.workload, "cuda")
    if args.clients:
        cell.mix = dict(cell.mix, clients=args.clients,
                        warmup=dict(cell.mix["warmup"], concurrency=args.clients))
    cell.setup(args.seed)
    head = {"workload": args.workload, "clients": cell.mix.get("clients"),
            "setup_s": time.perf_counter() - T0,
            "memory_after_warmup_bytes": torch.cuda.max_memory_allocated(),
            "device": torch.cuda.get_device_name(0)}
    lines = [head]
    print(json.dumps(head), flush=True)
    rates = ([float(x) for x in args.rates.split(",") if x]
             if cell.mix["loop"] == "open" else [None] * args.windows)
    for k, rate in enumerate(rates):
        sched = cell.schedule(args.seed + k, args.seconds, rate)
        trace = (rate if rate is not None else -1.0) == args.trace_rate
        win = cell.window(sched, args.seed + k, args.seconds, trace=trace)
        s = summary(win, rate)
        s["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        lines.append(s)
        print(json.dumps(s), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    cell.shutdown()


if __name__ == "__main__":
    main()
