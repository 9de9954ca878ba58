"""Chrome/Perfetto trace-event JSON export.

Serializes finished traces into the Trace Event Format that
``chrome://tracing`` and https://ui.perfetto.dev open directly: complete
events (``"ph": "X"``) per span, instant events (``"ph": "i"``) per span
event and per tracer control-plane event (recomposition swap decisions),
and metadata events naming the rows. Rows are laid out one process per
trace and one thread per platform, so a fan-out's branches render as
parallel tracks and the payload hand-offs read left to right — the same
picture as GeoFF's Fig. 4 timeline, but for a live request.

Timestamps are microseconds relative to the earliest span start across the
exported traces; both engine (perf_counter) and simulator (sim-clock)
traces export cleanly since only differences matter.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional


def _us(t: float, t_base: float) -> float:
    return (t - t_base) * 1e6


def to_chrome_trace(traces: Iterable, tracer=None) -> dict:
    """Build the Trace Event Format dict for ``traces`` (plus the tracer's
    control-plane events when given). Feed to ``json.dump`` or use
    ``write_chrome_trace``."""
    traces = [t for t in traces if t is not None]
    if not traces:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t_base = min(tr.root.t_start for tr in traces)

    events = []
    named_threads = set()
    for pid, tr in enumerate(traces, start=1):
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"request {tr.trace_id}"},
            }
        )
        with tr._lock:
            spans = list(tr.spans)
        tids: dict = {}
        for s in spans:
            platform = s.attrs.get("platform") or s.kind
            tid = tids.setdefault(platform, len(tids) + 1)
            if (pid, tid) not in named_threads:
                named_threads.add((pid, tid))
                events.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": tid,
                        "args": {"name": platform},
                    }
                )
            t_end = s.t_end if s.t_end is not None else s.t_start
            events.append(
                {
                    "name": s.name,
                    "cat": s.kind,
                    "ph": "X",
                    "ts": _us(s.t_start, t_base),
                    "dur": max(_us(t_end, t_base) - _us(s.t_start, t_base), 0.0),
                    "pid": pid,
                    "tid": tid,
                    "args": {k: _jsonable(v) for k, v in s.attrs.items()},
                }
            )
            for t, name, attrs in list(s.events):
                events.append(
                    {
                        "name": name,
                        "cat": "event",
                        "ph": "i",
                        "s": "t",
                        "ts": _us(t, t_base),
                        "pid": pid,
                        "tid": tid,
                        "args": {k: _jsonable(v) for k, v in attrs.items()},
                    }
                )

    if tracer is not None:
        for t, name, attrs in list(tracer.events):
            events.append(
                {
                    "name": name,
                    "cat": "control",
                    "ph": "i",
                    "s": "g",
                    "ts": _us(t, t_base),
                    "pid": 0,
                    "tid": 0,
                    "args": {k: _jsonable(v) for k, v in attrs.items()},
                }
            )

    events.sort(key=lambda e: e.get("ts", -1.0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, traces: Iterable, tracer=None) -> str:
    """Serialize to ``path``; returns the path for chaining/logging."""
    doc = to_chrome_trace(traces, tracer=tracer)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=str)
    return str(path)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)
