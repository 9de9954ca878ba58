"""GeoFF's benchmark command: one run of one cell on the card.

    python3 geoffbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Sets up the cell (weights from the seed on
the card, the deployment, the warm-up of the cell's shapes), measures the
window, waits for every request sent in it, then checks a seeded sample
of the answers against the plain reference. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; ``checks``, the
numbers compared with their limits, comes last. Exits non-zero without a
result when there is no CUDA card, or when JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_age_s() -> float:
    """Seconds since this process started (from /proc), 0 where unknown."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import json  # noqa: E402
from dataclasses import dataclass  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level names


@dataclass
class Run:
    """What the metric readers see."""
    arch: dict
    model: object  # the configuration's model module (``spec.model``)
    mix: dict
    win: object
    setup_s: float


def loaded_forbidden() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def measure(cell, seed: int, seconds: float, trace: bool, t_start: float,
            limits: dict, bench: dict) -> tuple:
    """Set-up, window, metrics and check of one run: (result, check lines)."""
    import torch
    from geoffbench import spec
    from geoffbench import trace as tr_mod

    cell.setup(seed)
    sched = cell.schedule(seed, seconds)
    win = cell.window(sched, seed, seconds, trace=trace)
    cuda = cell.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    run = Run(cell.arch, cell.model, cell.mix, win, win.t0 - t_start)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(bench, cell.name, kind):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(cell.device) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    t = win.trace
    if t is not None:
        device["busy_s"] = tr_mod.busy_s(t.events, t.lo_ns, t.hi_ns)
        device["window_s"] = t.window_s
        spans = [(t.host_ns(r.sent), t.host_ns(r.out["span"][0]),
                  t.host_ns(r.out["span"][1]), t.host_ns(r.out["span"][2]),
                  t.host_ns(r.done)) for r in win.records if r.ok]
        breakdown = {"device_ops": tr_mod.top_ops(t.events),
                     "idle_gaps": tr_mod.gaps_by_host(
                         tr_mod.idle_gaps(t.events, t.lo_ns, t.hi_ns), spans)}
        win.trace = None  # read: free the events before the reference
    # the program's state goes before the reference runs: the deployment,
    # its executors and store; the weights are the benchmark's and stay
    cell.shutdown()
    t_ref = time.perf_counter()
    ok, checks, numbers, _, picked = cell.judge(win, seed, limits)
    result = {"correct": bool(ok), "attempted": len(win.records),
              "failed": numbers["failed"], "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["notes"] = {"requests": len(win.records), "generator_late_s": win.late_s,
                       "sample_tokens": picked,
                       "reference_s": time.perf_counter() - t_ref}
    result["checks"] = checks
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths (the
    # port's own kernels build under build/torch_kernels)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)

    import torch
    from geoffbench import spec
    from geoffbench.cell import Cell

    bench = spec.load_benchmark()
    entry = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"geoffbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    limits = spec.limits(args.workload)
    cell = Cell(args.workload, "cuda")
    result, lines = measure(cell, args.seed, args.seconds, bool(args.trace),
                            T_START, limits, bench)
    bad = loaded_forbidden()
    if bad:
        print(f"geoffbench: the process loaded {bad}; the benchmark runs the "
              "PyTorch port alone", file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
