"""The port's own host spans over a cell's window, and a tool that reads
them on the card.

With the port's tracer attached to a cell's deployment (``attach``), every
request leaves a trace (``repro_torch.obs``). The engine's node and
transfer spans carry ``queued_s``, the task's wait in its platform's
executor. A traced ``prefill`` leaves a ``dispatch:prefill`` span under
the ``classify`` step's ``compute`` span, with ``cpu_s``, ``attention_s``
and ``sync_s``, the part of ``attention_s`` spent in rope's synchronising
copies (``repro_torch.spanhook``, ``models.layers.rope``). Each reader
below reduces a window's traces to one number, or None where they hold
nothing to read. All times are ``time.perf_counter`` seconds, the clock
the device trace's ``host_ns`` maps.

    python3 geoffbench/hostspans.py --workload <name> --seed <n> \
        --seconds 51 [--pairs 2] [--out <file.jsonl>]

sets the cell up once on the card and runs traced windows of the seed's
traffic (the device trace on) with and without the port's tracer in
turns (with, without, without, with, ...: ``--pairs`` of each), then one
window with the tracer and a single client: each window's throughput,
the device's idle share and the four readings, one JSON line each.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def attach(dep, max_traces: int):
    """A port tracer on ``dep`` whose ring holds ``max_traces`` requests."""
    from repro_torch.obs import Tracer, instrument
    return instrument(dep, Tracer(max_traces=max_traces))


def detach(dep) -> list:
    """Take ``attach``'s tracer off ``dep``; its finished traces."""
    tracer = dep.tracer
    dep.tracer = dep.cache.tracer = dep.prefetcher.tracer = dep.store.tracer = None
    return tracer.traces() if tracer is not None else []


def _done(traces) -> list:
    return [t for t in traces if "error" not in t.root.attrs]


def _dispatches(trace) -> list:
    return [s for s in trace.spans if s.kind == "dispatch" and s.t_end is not None]


def _mean_ms(vals):
    return 1e3 * statistics.fmean(vals) if vals else None


def queue_ms(traces):
    """Mean over finished requests of Σ ``queued_s`` over the request's
    node and transfer spans (its critical path; pokes left out), in ms."""
    return _mean_ms([sum(s.attrs.get("queued_s", 0.0) for s in t.spans
                         if s.kind in ("node", "transfer")) for t in _done(traces)])


def dispatch_ms(traces):
    """Mean over finished requests of their ``dispatch:prefill`` span's
    wall time, in ms."""
    return _mean_ms([sum(s.duration_s for s in ds) for t in _done(traces)
                     if (ds := _dispatches(t))])


def dispatch_cpu_pct(traces):
    """Σ ``cpu_s`` over Σ wall of every dispatch span, x100: below 100 the
    dispatching thread waited off the CPU (the interpreter lock, a
    blocking call)."""
    ds = [s for t in traces for s in _dispatches(t)]
    wall = sum(s.duration_s for s in ds)
    return 100.0 * sum(s.attrs["cpu_s"] for s in ds) / wall if wall > 0 else None


def _attr_ms(traces, key):
    return _mean_ms([sum(s.attrs[key] for s in ds) for t in _done(traces)
                     if (ds := _dispatches(t))])


def attention_dispatch_ms(traces):
    """Mean over finished requests of their dispatch's ``attention_s``:
    host seconds inside the attention sublayers' calls, in ms."""
    return _attr_ms(traces, "attention_s")


def rope_sync_ms(traces):
    """Mean over finished requests of their dispatch's ``sync_s``: host
    seconds inside rope's copies to the card, each of which waits for the
    stream to drain, in ms. The rest of ``attention_s`` is dispatch."""
    return _attr_ms(traces, "sync_s")


READINGS = {"engine.queue_ms": queue_ms, "prefill.dispatch_ms": dispatch_ms,
            "prefill.dispatch_cpu_pct": dispatch_cpu_pct,
            "prefill.attention_dispatch_ms": attention_dispatch_ms,
            "prefill.rope_sync_ms": rope_sync_ms}


def traced_window(cell, sched, seed, seconds, tracer: bool) -> dict:
    """One window with the device trace on, and the port's tracer on
    ``cell``'s deployment over it where ``tracer``: its readings."""
    from geoffbench import readers
    if tracer:
        attach(cell.dep, len(sched))
    try:
        win = cell.window(sched, seed, seconds, trace=True)
    finally:
        traces = detach(cell.dep) if tracer else []
    run = SimpleNamespace(win=win)
    out = {"tracer": tracer, "clients": cell.mix["clients"],
           "requests": len(win.records), "failed": sum(not r.ok for r in win.records),
           "tokens_per_s": readers.tokens_per_s(run),
           "device_idle_pct": readers.device_idle_pct(run)}
    if tracer:
        out.update({k: f(traces) for k, f in READINGS.items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from geoffbench.cell import Cell

    if not torch.cuda.is_available():
        print("geoffbench: hostspans needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload, "cuda")
    cell.setup(args.seed)
    order = [True, False, False, True] * args.pairs
    lines = []
    for i, tracer in enumerate(order[:2 * args.pairs] + [True]):
        if i == 2 * args.pairs:
            cell.mix = dict(cell.mix, clients=1)
        sched = cell.schedule(args.seed, args.seconds)
        line = dict(traced_window(cell, sched, args.seed, args.seconds, tracer),
                    workload=args.workload, seed=args.seed,
                    device=torch.cuda.get_device_name(0))
        lines.append(line)
        print(json.dumps(line), flush=True)
    cell.shutdown()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
