"""What the metric files under ``metrics/`` read. Each takes the finished
run (``run.Run``) and returns a number, or None where the run holds
nothing to read (no trace, no matching kernel, no finished request)."""
from __future__ import annotations

from geoffbench import counts, spec, trace


def _done(run) -> list:
    return [r for r in run.win.records if r.ok]


def tokens_per_s(run):
    """Prompt positions (patches and text) of the requests whose label was
    back inside the window, over the window's length."""
    end = run.win.t0 + run.win.seconds
    return sum(r.req.tokens for r in _done(run) if r.done <= end) / run.win.seconds


def setup_s(run):
    """Process start to the window's start."""
    return run.setup_s


def engine_overhead_ms(run):
    """Mean over requests of the chain's ``total_s`` less its steps' warm,
    fetch and compute seconds (``StepResult.timeline``): what the engine
    itself adds (executor hand-offs, pokes, payload routing)."""
    vals = [r.total_s - sum(s["warm_s"] + s["fetch_s"] + s["compute_s"]
                            for s in r.timeline.values())
            for r in _done(run)]
    return 1e3 * sum(vals) / len(vals) if vals else None


def prefetch_exposed_ms(run):
    """The prefetcher's exposed wait over the window (``exposed_s`` of
    ``Prefetcher.stats_snapshot()``), per finished request."""
    n = len(_done(run))
    return 1e3 * run.win.prefetch["exposed_s"] / n if n else None


def _traced(run):
    tr = run.win.trace
    return tr if tr is not None and tr.events else None


def prefill_mfu_pct(run):
    """Model operations of the window's prefills (the model module's
    ``prefill_flops``) over the device's busy seconds at the bf16 peak."""
    tr = _traced(run)
    if tr is None:
        return None
    busy = trace.busy_s(tr.events, tr.lo_ns, tr.hi_ns)
    flops = sum(run.model.prefill_flops(run.arch, r.req.text_len, r.req.patches)
                for r in _done(run))
    return 100.0 * flops / (busy * counts.PEAK_BF16_FLOPS) if busy > 0 else None


def roofline_pct(run, group: str):
    """Σ over the window's prefills of the least device time of one kernel
    group's work (the model module's ``bounds``) over Σ of the device time
    of the kernels that implement it (``metrics/patterns/<group>``)."""
    tr = _traced(run)
    if tr is None:
        return None
    pats = spec.patterns(group)
    t = sum(e - s for name, s, e in tr.events if any(p.search(name) for p in pats))
    if t <= 0:
        return None
    bound = sum(run.model.bounds(run.arch, r.req.text_len, r.req.patches)[group]
                for r in _done(run))
    return 100.0 * bound / (t * 1e-9)


def device_idle_pct(run):
    """Share of the traced window with no operation running on the card."""
    tr = _traced(run)
    if tr is None:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr.events, tr.lo_ns, tr.hi_ns) / tr.window_s)
