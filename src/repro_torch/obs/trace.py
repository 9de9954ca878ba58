"""Per-request tracing: spans, events, and the deployment-wide ``Tracer``.

The engine and simulator both measure every phase GeoFF cares about —
poke, pre-warm (compile), pre-fetch, compute, payload transfer — but until
now only aggregates survived (EWMAs, counters). A ``Trace`` keeps the
per-request structure: one root span per request, child spans per node and
phase, all stamped with the request's ``trace_id``, which the engine
propagates through the whole poke/payload cascade (a fan-out's branches,
running on different platform executors, record into the same trace).

Schema — the contract ``obs.critical_path`` consumes, produced identically
by the real engine (``dag/engine.py``) and all three simulator backends:

  root span          kind="request"; covers the whole request.
  node span          kind="node", one per DAG node, with ``attrs``:
                       node, platform, preds        identity + topology
                       poke_t                       absolute poke time
                                                    (None: never poked)
                       prepare_t0, prepare_t1       warm+fetch window
                       cold_s, fetch_s, compute_s   exposed phase seconds
                       compute_t0                   handler start
                       payload_t {pred: t}          per-edge payload arrival
                       transfer_s {pred: s}         per-edge transfer cost
  phase spans        kind="warm"|"fetch"|"compute" children of the node
                     span; kind="poke"/"transfer" parented to the root —
                     presentation detail for the Perfetto export, not load
                     bearing for extraction.
  span events        point-in-time observations appended by the duck-typed
                     hooks in ``CompileCache`` / ``Prefetcher`` /
                     ``ObjectStore`` (same pattern as the telemetry
                     taps): components carry a ``tracer`` attribute and
                     call ``tracer.event(...)``, which lands on whatever
                     span the calling thread currently has bound via
                     ``tracer.bind(span)`` — background pre-fetch jobs
                     capture the poke span at submit time.

Times are ``time.perf_counter()`` seconds (engine) or simulation-clock
seconds (simulator); everything downstream works on differences, so the
two clocks never mix within a trace. All structures are thread-safe at the
granularity the engine needs (append-only under the trace lock).

The tracer is deliberately cheap to leave attached: recording holds a lock
only to append, finished traces live in a bounded ring, and every producer
guards with ``if tracer is not None`` so the untraced path is untouched —
the same zero-overhead-when-off discipline as the telemetry hooks, with
the same draw-neutrality guarantee in the simulator (pinned by test).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry

_ids = itertools.count(1)


class Span:
    """One timed operation inside a trace. Mutable until ``end`` stamps
    ``t_end``; ``events`` collects (t, name, attrs) points."""

    __slots__ = (
        "span_id",
        "trace_id",
        "parent_id",
        "name",
        "kind",
        "t_start",
        "t_end",
        "attrs",
        "events",
    )

    def __init__(self, span_id, trace_id, parent_id, name, kind, t_start, attrs):
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.attrs = attrs if attrs is not None else {}
        self.events: list = []

    @property
    def duration_s(self) -> float:
        return (self.t_end if self.t_end is not None else self.t_start) - self.t_start

    def add_event(self, name: str, attrs=None, t: Optional[float] = None):
        self.events.append((time.perf_counter() if t is None else t, name, attrs or {}))

    def end(self, t: Optional[float] = None):
        self.t_end = time.perf_counter() if t is None else t


class Trace:
    """One request's spans. ``root`` is created by ``Tracer.begin``; nodes
    and phases hang off it. Append-only under ``_lock``."""

    def __init__(self, trace_id: str, root: Span):
        self.trace_id = trace_id
        self.root = root
        self.spans: list = [root]
        self._lock = threading.Lock()

    def span(
        self,
        name: str,
        kind: str,
        parent: Optional[Span] = None,
        t_start: Optional[float] = None,
        attrs=None,
    ) -> Span:
        parent = parent if parent is not None else self.root
        s = Span(
            next(_ids),
            self.trace_id,
            parent.span_id,
            name,
            kind,
            time.perf_counter() if t_start is None else t_start,
            attrs,
        )
        with self._lock:
            self.spans.append(s)
        return s

    def node_spans(self) -> dict:
        """{node_name: span} for every kind="node" span (the extraction
        surface)."""
        with self._lock:
            return {s.attrs["node"]: s for s in self.spans if s.kind == "node"}

    @property
    def total_s(self) -> float:
        return self.root.duration_s


class Tracer:
    """Deployment-wide trace collector + thread-local span binding.

    ``begin``/``finish`` bracket one request; finished traces land in a
    bounded ring (``traces()``/``last()``). ``bind(span)`` installs the
    span as the calling thread's event target so instrumented components
    (``tracer.event``) attach observations without threading a span handle
    through every signature. ``record_event`` collects trace-less control
    events (the recomposition controller's swap decisions). Span
    durations are folded into ``metrics`` histograms at ``finish`` — one
    tracer gives both per-request traces and p50/p95/p99.

    ``sample`` bounds how many per-request traces the BATCHED simulator
    backends (numpy / torch) emit per experiment: k evenly spaced requests,
    chosen deterministically (never from the experiment's rng — tracing
    stays draw-neutral).

    ``sampler`` (an ``obs.sampler.TailSampler``) makes ring retention
    *tail-based*: ``finish`` asks it whether this request's span tree is
    worth keeping (slow / SLO-violating / head-sampled) and drops the tree
    otherwise. Metrics fold regardless of the verdict, so aggregates stay
    unbiased; kept traces carry ``attrs["sampled"]`` with the reason.
    """

    def __init__(
        self,
        max_traces: int = 256,
        sample: int = 8,
        metrics: Optional[MetricsRegistry] = None,
        max_events: int = 4096,
        sampler=None,
    ):
        self.sample = sample
        self.sampler = sampler
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.events = deque(maxlen=max_events)  # control-plane events
        self._traces = deque(maxlen=max_traces)
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- trace lifecycle -------------------------------------------------------
    def begin(
        self,
        name: str = "request",
        trace_id: Optional[str] = None,
        t0: Optional[float] = None,
        attrs=None,
    ) -> Trace:
        trace_id = trace_id if trace_id is not None else f"t{next(_ids):08x}"
        root = Span(
            next(_ids),
            trace_id,
            None,
            name,
            "request",
            time.perf_counter() if t0 is None else t0,
            attrs,
        )
        return Trace(trace_id, root)

    def finish(self, trace: Trace, t_end: Optional[float] = None) -> Trace:
        if trace.root.t_end is None:
            trace.root.end(t_end)
        keep = True
        if self.sampler is not None:
            keep, reason = self.sampler.decide(trace.total_s, now=trace.root.t_end)
            if keep:
                trace.root.attrs["sampled"] = reason
        if keep:
            with self._lock:
                self._traces.append(trace)
        m = self.metrics
        if m is not None:
            with trace._lock:
                spans = list(trace.spans)
            for s in spans:
                if s.t_end is None:
                    continue
                # per-request ids must NOT become series names (unbounded
                # cardinality): roots aggregate under their kind
                label = "all" if s.kind == "request" else (
                    s.attrs.get("node") or s.name
                )
                # windows keyed on the span's own clock (perf_counter for
                # the engine, sim seconds for the backends — never mixed
                # within one tracer)
                m.observe(f"{s.kind}_s/{label}", s.duration_s, now=s.t_end)
        return trace

    def traces(self) -> list:
        with self._lock:
            return list(self._traces)

    def last(self) -> Optional[Trace]:
        with self._lock:
            return self._traces[-1] if self._traces else None

    def clear(self):
        with self._lock:
            self._traces.clear()

    # -- thread-local span binding (component hooks) ---------------------------
    def bind(self, span: Optional[Span]):
        """Context manager: install ``span`` as this thread's event target
        (None rebinds to nothing — used by pool jobs that captured no
        span)."""
        return _Bound(self._tls, span)

    def current_span(self) -> Optional[Span]:
        return getattr(self._tls, "span", None)

    def event(self, name: str, attrs=None):
        """Attach a point event to the calling thread's bound span; no-op
        when nothing is bound (a component used outside a traced
        request)."""
        span = self.current_span()
        if span is not None:
            span.add_event(name, attrs)

    # -- control-plane events (no active request) ------------------------------
    def record_event(self, name: str, attrs=None, t: Optional[float] = None):
        self.events.append((time.perf_counter() if t is None else t, name, attrs or {}))


class _Bound:
    __slots__ = ("_tls", "_span", "_prev")

    def __init__(self, tls, span):
        self._tls = tls
        self._span = span

    def __enter__(self):
        self._prev = getattr(self._tls, "span", None)
        self._tls.span = self._span
        return self._span

    def __exit__(self, *exc):
        self._tls.span = self._prev
        return False


def instrument(deployment, tracer: Optional[Tracer] = None) -> Tracer:
    """Wire a tracer into an existing (Dag)Deployment's components — the
    tracing twin of ``repro_torch.adapt.telemetry.attach``. The engine, compile
    cache, prefetcher, and object store each carry a duck-typed ``tracer``
    attribute (None by default: zero overhead); this sets all four and
    returns the tracer."""
    tracer = tracer if tracer is not None else Tracer()
    deployment.tracer = tracer
    deployment.cache.tracer = tracer
    deployment.prefetcher.tracer = tracer
    deployment.store.tracer = tracer
    return tracer
