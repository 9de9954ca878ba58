"""Critical-path extraction + latency attribution from a finished trace.

This is the runtime dual of the simulator's recurrence: where the forward
pass computes ``start[v] = max(prepare[v], max_u(end[u] + transfer))``, the
backward walk here asks, at every instant of a finished request, *which
constraint was binding* — and tiles the whole ``[t0, sink_end]`` interval
with segments labelled by GeoFF's cost taxonomy:

  compute      a handler was running on the path
  transfer     a payload was in flight on the binding edge
  fetch        the node was waiting on data download (exposed, post-poke)
  cold         the node was waiting on a cold start / compile
  stream_wait  residual streamed chunks were draining: the node already
               held the first chunk (engine: wait between prepare and the
               handler; sim: the pipelined tail after compute)
  poke_slack   everything before the binding chain's first poke-gated
               prepare window (poke message fan-out, scheduling slack,
               and any unattributed gap between phases)

Because the segments tile the interval exactly (gaps become slack), the
bucket sums equal ``sink_end - t0`` by construction — a tolerance on the
root span's duration only absorbs the epsilon between the root span and the
latest sink, never bookkeeping drift.

The walk consumes only the node-span attrs contract documented in
``obs.trace`` — so the same extractor serves the real engine and all three
simulator backends, which is precisely what lets an engine trace and a
simulated one be diffed per bucket.

Node-gating logic, per node ``v`` with cursor at its compute start:

  * compute segment ``[compute_t0, compute_t0 + compute_s]``; any gap from
    the previous segment is slack.
  * the binding constraint for ``compute_t0`` is whichever is later:
    ``prepare_t1`` (warm+fetch window end) or the latest payload arrival.
  * prepare-bound → attribute ``fetch`` ``[prepare_t1 - fetch_s,
    prepare_t1]`` then ``cold`` ``[prepare_t0, prepare_t0 + cold_s]``;
    then, if the prepare window opened at the poke (``prepare_t0 ≈
    poke_t``) the chain terminates in poke slack ``[t0, cursor]``; else the
    prepare window itself was payload-gated (engine semantics: warm/fetch
    exposed at fire time) and the walk continues through the predecessors.
  * payload-bound → ``transfer`` ``[arrival - transfer_s[u*], arrival]``
    on the argmax-arrival edge ``u*``, then recurse into ``u*``.
  * a source with no poke and no preds terminates in slack ``[t0, cursor]``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

BUCKETS = ("cold", "fetch", "compute", "transfer", "stream_wait", "poke_slack")

# prepare_t0 within this of poke_t counts as poke-gated (engine clocks are
# perf_counter with scheduling noise; sim clocks are exact).
_POKE_TOL = 5e-3


@dataclass
class Segment:
    """One contiguous attributed interval on the critical path."""

    t0: float
    t1: float
    bucket: str
    node: Optional[str] = None
    edge: Optional[Tuple[str, str]] = None

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


@dataclass
class CriticalPath:
    """The binding chain of a finished request, latest-sink-first walk
    re-sorted into time order. ``attribution`` sums segment durations per
    bucket; ``total_s`` is the walked interval ``sink_end - t0`` (== sum of
    all buckets, by construction)."""

    trace_id: str
    nodes: List[str]  # path nodes, source-to-sink order
    segments: List[Segment] = field(default_factory=list)

    @property
    def total_s(self) -> float:
        if not self.segments:
            return 0.0
        return self.segments[-1].t1 - self.segments[0].t0

    @property
    def attribution(self) -> dict:
        out = {b: 0.0 for b in BUCKETS}
        for s in self.segments:
            out[s.bucket] += s.duration_s
        return out

    def format(self) -> str:
        attr = self.attribution
        total = self.total_s or 1.0
        lines = [
            f"critical path [{self.trace_id}]: {' -> '.join(self.nodes)}",
            f"  total {total:.4f}s",
        ]
        for b in BUCKETS:
            lines.append(f"  {b:<12}{attr[b]:>9.4f}s  {100.0 * attr[b] / total:5.1f}%")
        return "\n".join(lines)


def _node_attrs(span) -> dict:
    return span.attrs


def extract_critical_path(trace, tol: float = _POKE_TOL) -> CriticalPath:
    """Walk a finished trace backward from its latest-ending sink, emitting
    segments that tile ``[t0, sink_end]``. Raises ``ValueError`` on a trace
    with no node spans or an unfinished node on the binding chain."""
    nodes = trace.node_spans()
    if not nodes:
        raise ValueError(f"trace {trace.trace_id} has no node spans")
    t0 = trace.root.t_start

    # latest-ending node is the binding sink, whatever the DAG calls it
    sink = max(nodes.values(), key=lambda s: s.t_end if s.t_end is not None else t0)
    if sink.t_end is None:
        raise ValueError(f"trace {trace.trace_id}: sink span unfinished")

    segments: List[Segment] = []
    path_nodes: List[str] = []
    cursor = sink.t_end

    def emit(seg_t0: float, seg_t1: float, bucket: str, node=None, edge=None):
        nonlocal cursor
        seg_t0 = max(seg_t0, t0)
        seg_t1 = min(seg_t1, cursor)
        if seg_t1 < cursor:  # gap between phases → slack
            segments.append(Segment(seg_t1, cursor, "poke_slack", node=node))
        if seg_t1 > seg_t0:
            segments.append(Segment(seg_t0, seg_t1, bucket, node=node, edge=edge))
        cursor = min(cursor, seg_t0)

    span = sink
    visited = set()
    while True:
        a = _node_attrs(span)
        name = a["node"]
        if name in visited:  # defensive: malformed trace must not loop
            break
        visited.add(name)
        path_nodes.append(name)

        compute_t0 = a.get("compute_t0", span.t_start)
        compute_s = a.get("compute_s", 0.0)
        # the node's own on-path intervals: compute, plus the streamed-tail
        # wait when present. The wait sits AFTER compute in the simulator
        # (the closed-form pipelined tail) and BEFORE it on the engine
        # (drain-then-run), so emit latest-ending first — emit() clips to
        # the cursor either way, keeping the tiling exact.
        ivals = [(compute_t0, compute_t0 + compute_s, "compute")]
        sw0, sw1 = a.get("stream_wait_t0"), a.get("stream_wait_t1")
        if sw0 is not None and sw1 is not None and sw1 > sw0:
            ivals.append((sw0, sw1, "stream_wait"))
        for iv0, iv1, bucket in sorted(ivals, key=lambda iv: -iv[1]):
            emit(iv0, iv1, bucket, node=name)

        prepare_t1 = a.get("prepare_t1")
        payload_t = a.get("payload_t") or {}
        last_arrival = max(payload_t.values()) if payload_t else None

        prepare_bound = prepare_t1 is not None and (
            last_arrival is None or prepare_t1 >= last_arrival - tol
        )
        if prepare_bound:
            fetch_s = a.get("fetch_s", 0.0)
            emit(prepare_t1 - fetch_s, prepare_t1, "fetch", node=name)
            prepare_t0 = a.get("prepare_t0", prepare_t1 - fetch_s)
            cold_s = a.get("cold_s", 0.0)
            emit(prepare_t0, prepare_t0 + cold_s, "cold", node=name)
            poke_t = a.get("poke_t")
            if poke_t is not None and abs(prepare_t0 - poke_t) <= max(tol, _POKE_TOL):
                # prepare opened at the poke: everything earlier is the
                # poke fan-out — terminal.
                if cursor > t0:
                    segments.append(Segment(t0, cursor, "poke_slack", node=name))
                    cursor = t0
                break
            # prepare opened at fire time (engine baseline semantics):
            # the window itself was gated by the payload — fall through.
            if last_arrival is None:
                if cursor > t0:
                    segments.append(Segment(t0, cursor, "poke_slack", node=name))
                    cursor = t0
                break

        if not payload_t:  # no prepare window and no arrivals: bare source
            if cursor > t0:
                segments.append(Segment(t0, cursor, "poke_slack", node=name))
                cursor = t0
            break

        # payload-bound (or prepare window gated by payload): charge the
        # binding edge's transfer and continue into that predecessor.
        u_star = max(payload_t, key=payload_t.get)
        arrival = payload_t[u_star]
        transfer = (a.get("transfer_s") or {}).get(u_star, 0.0)
        emit(arrival - transfer, arrival, "transfer", node=name, edge=(u_star, name))
        nxt = nodes.get(u_star)
        if nxt is None or nxt.t_end is None:
            if cursor > t0:
                segments.append(Segment(t0, cursor, "poke_slack", node=name))
                cursor = t0
            break
        span = nxt

    if cursor > t0:  # safety: always tile down to t0
        segments.append(Segment(t0, cursor, "poke_slack"))

    segments.sort(key=lambda s: s.t0)
    path_nodes.reverse()
    return CriticalPath(trace.trace_id, path_nodes, segments)
