"""Function shipping + automated placement (paper §4.3, §5.3).

GeoFF can move a function to the platform where its data lives instead of
moving the data ("shipping functions to data"). The paper does this manually
(§4.3) and lists automation as future work (§5.3) — implemented here for
general DAG workflows:

``dag_cost`` is the modeled end-to-end (critical-path) cost of a placed
DAG under the pre-fetch overlap model; on a chain it telescopes to
``chain_cost`` exactly.

``place_dag`` minimizes ``dag_cost`` EXACTLY: a dynamic program over the
series-parallel decomposition of the graph (series/parallel reductions
carry Pareto tables of (path-cost, prepare-window) per terminal placement),
with an exhaustive fallback for small graphs that are not two-terminal
series-parallel, and the greedy topological scorer (``place_dag_greedy``,
the pre-DP baseline) only for graphs too large to enumerate.

``place_chain`` delegates to ``place_dag`` — a chain is series-parallel, so
the old chain DP's optimality (O(steps x platforms^2)) is preserved while
the duplicated scoring logic is gone.

The TPU-pod analogue: a serving step whose KV cache / checkpoint shards live
on pod A is shipped to pod A rather than streaming the state over DCN —
serving/disagg.py uses the same optimizer with state residency as data_deps.
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.graph import graph_views
from repro_torch.core.workflow import StepSpec, WorkflowSpec

# exhaustive-search budget: max candidate assignments scored before place_dag
# falls back to the greedy (only reachable for large non-series-parallel
# graphs; chains and diamonds always take the exact series-parallel DP)
_EXHAUSTIVE_LIMIT = 20_000


@dataclass(frozen=True)
class PlacementCosts:
    """Cost model callbacks — wired to NetworkModel/ObjectLatency (sim) or
    measured EWMA stats (runtime, core/timing.py).

    ``transfer_fl`` (optional) splits an edge into latency + bandwidth
    terms: ``(platform_a, platform_b, size_bytes) -> (first_byte_s,
    last_byte_s)``. When set, the cost recurrence and the placement DP
    price pipelined edges — a successor starts on the first byte, and the
    last byte only bounds the tail ``compute / chunks``. When None, both
    components are ``transfer_s`` and every cost is exactly the
    whole-object model's."""

    fetch_s: Callable  # (step_name, platform, data_deps) -> seconds
    compute_s: Callable  # (step_name, platform) -> seconds
    transfer_s: Callable  # (platform_a, platform_b, size_bytes) -> seconds
    payload_size: float = 1.5e6
    transfer_fl: Optional[Callable] = None  # (a, b, size) -> (first, last)
    chunks: int = 1  # wire chunks per edge (the streaming data plane)


def exposed_fetch(fetch_s: float, window_s: float, prefetch: bool) -> float:
    """Fetch time visible on the critical path given an overlap window."""
    if not prefetch:
        return fetch_s
    return max(0.0, fetch_s - window_s)


def _edge_fl(costs: PlacementCosts, a, b) -> tuple:
    """(first_byte_s, last_byte_s) of one placed edge — collapsing to the
    whole-object transfer twice when no split model is attached."""
    if costs.transfer_fl is not None:
        return costs.transfer_fl(a, b, costs.payload_size)
    t = costs.transfer_s(a, b, costs.payload_size)
    return t, t


def _inv_chunks(costs: PlacementCosts) -> float:
    return 1.0 / max(1, costs.chunks)


def _topo(nodes, edges):
    """Predecessor lists + deterministic topological order (ties broken by
    ``nodes`` insertion order)."""
    pred, _, order = graph_views(nodes, edges)
    return pred, order


def _dag_cost_views(nodes, pred, order, placement, costs, prefetch):
    """The critical-path recurrence over precomputed graph views (hoisted
    out of ``dag_cost`` so the exhaustive search sorts the graph once)."""
    inv = _inv_chunks(costs)
    finish = {}
    total = 0.0
    for v in order:
        p = placement[v]
        s = nodes[v]
        f = costs.fetch_s(v, p, s.data_deps)
        c = costs.compute_s(v, p)
        ready = 0.0  # first-byte join: gates prepare + start
        ready_last = 0.0  # last-byte join: bounds the compute tail
        window = 0.0
        for u in pred[v]:
            first, last = _edge_fl(costs, placement[u], p)
            ready = max(ready, finish[u] + first)
            ready_last = max(ready_last, finish[u] + last)
            window = max(window, costs.compute_s(u, placement[u]) + first)
        finish[v] = ready + exposed_fetch(f, window, prefetch) + c
        if pred[v]:
            # per-chunk pipeline tail (never binds when first == last and
            # chunks == 1: ready_last + c <= finish[v])
            finish[v] = max(finish[v], ready_last + c * inv)
        total = max(total, finish[v])
    return total


def dag_cost(nodes, edges, placement, costs: PlacementCosts, prefetch=True) -> float:
    """Modeled end-to-end cost of a placed DAG: the critical-path recurrence

        ready[v]  = max over preds u of finish[u] + first_byte(p_u, p_v)
        window[v] = max over preds u of compute_u + first_byte(p_u, p_v)
        finish[v] = max(ready[v] + exposed_fetch(fetch_v, window[v])
                                 + compute_v,
                        ready_last[v] + compute_v / chunks)

    where ``ready_last`` joins last bytes. Without ``transfer_fl`` both
    byte marks are ``transfer_s`` and the tail never binds, so this is
    exactly the whole-object recurrence. The window is the guaranteed
    poke-to-payload overlap for ``v``'s pre-fetch (the cascade makes the
    true window larger, so this is the same conservative criterion the
    chain DP used). ``chain_cost`` is this recurrence on the degenerate
    chain graph."""
    pred, order = _topo(nodes, edges)
    return _dag_cost_views(nodes, pred, order, placement, costs, prefetch)


# ---------------------------------------------------------------------------
# exact placement: series-parallel DP with exhaustive fallback
# ---------------------------------------------------------------------------
# A table maps (source_platform, sink_platform) -> Pareto list of
# (D, W, R, placement): D = max over s->t paths of FIRST-byte transfers +
# INTERNAL node costs (terminal node costs excluded; internal windows are
# fully determined inside the subgraph), W = max over t's in-edges of
# compute_u + first-byte transfer (t's prepare window contribution), R =
# the same path max as D but joining LAST bytes into t (it bounds t's
# compute tail under streaming; R == D whenever transfer_fl is unset),
# placement = internal node assignments. The final cost is increasing in D
# and R and nonincreasing in W, so an entry is dominated iff another has
# D' <= D, R' <= R and W' >= W.


def _pareto(entries):
    # dominance sweep: after sorting by (D, R, -W), an entry can only be
    # dominated by an already-kept one (later entries never have both a
    # smaller-or-equal D and R without sorting earlier)
    entries.sort(key=lambda e: (e[0], e[2], -e[1]))
    kept = []
    for d, w, r, pl in entries:
        if any(kd <= d and kr <= r and kw >= w for kd, kw, kr, _ in kept):
            continue
        kept.append((d, w, r, pl))
    return kept


def _node_cost(n, p, window, nodes, costs, prefetch):
    f = costs.fetch_s(n, p, nodes[n].data_deps)
    return exposed_fetch(f, window, prefetch) + costs.compute_s(n, p)


def _base_table(u, v, cand, costs):
    t = {}
    for pu in cand[u]:
        cu = costs.compute_s(u, pu)
        for pv in cand[v]:
            first, last = _edge_fl(costs, pu, pv)
            t[(pu, pv)] = [(first, cu + first, last, {})]
    return t


def _series(t1, t2, m, nodes, costs, prefetch):
    """Compose in-table ``t1`` (u->m) and out-table ``t2`` (m->w) over the
    eliminated internal node ``m``; m's finish — the max of the prepared
    start plus compute (window from t1's W) and the last-byte tail — joins
    both path terms. With R == D and chunks == 1 the tail never binds and
    this is the classic 2-component fold."""
    inv = _inv_chunks(costs)
    out = defaultdict(list)
    by_pm = defaultdict(list)
    for (pm, pw), entries in t2.items():
        by_pm[pm].append((pw, entries))
    for (pu, pm), e1 in t1.items():
        for pw, e2 in by_pm.get(pm, ()):
            for d1, w1, r1, pl1 in e1:
                cm = _node_cost(m, pm, w1, nodes, costs, prefetch)
                fin = max(d1 + cm, r1 + costs.compute_s(m, pm) * inv)
                for d2, w2, r2, pl2 in e2:
                    out[(pu, pw)].append(
                        (fin + d2, w2, fin + r2, {**pl1, **pl2, m: pm})
                    )
    return {k: _pareto(v) for k, v in out.items()}


def _parallel(t1, t2):
    """Merge two tables between the same terminals: paths (both byte
    marks) and window contributions all combine by max (branches are
    disjoint, and D/R are offsets from the same source finish)."""
    out = {}
    for key in t1.keys() & t2.keys():
        entries = [
            (max(d1, d2), max(w1, w2), max(r1, r2), {**pl1, **pl2})
            for d1, w1, r1, pl1 in t1[key]
            for d2, w2, r2, pl2 in t2[key]
        ]
        out[key] = _pareto(entries)
    return out


def _sp_reduce(edges, tables, source, sink, nodes, costs, prefetch):
    """Run series/parallel reductions to a single (source, sink) edge.
    Returns its DP table, or None when the graph is not two-terminal
    series-parallel."""
    elist = [[a, b, t] for (a, b), t in zip(edges, tables)]
    while len(elist) > 1:
        # parallel reduction: merge duplicate (u, v) edges
        merged = {}
        order = []
        changed = False
        for e in elist:
            key = (e[0], e[1])
            if key in merged:
                merged[key][2] = _parallel(merged[key][2], e[2])
                changed = True
            else:
                merged[key] = e
                order.append(key)
        elist = [merged[k] for k in order]
        # series reduction: one internal node with in-degree = out-degree = 1
        indeg = defaultdict(list)
        outdeg = defaultdict(list)
        for e in elist:
            outdeg[e[0]].append(e)
            indeg[e[1]].append(e)
        reduced = False
        for m in list(indeg):
            if m in (source, sink):
                continue
            if len(indeg[m]) == 1 and len(outdeg[m]) == 1:
                e1, e2 = indeg[m][0], outdeg[m][0]
                new = [
                    e1[0],
                    e2[1],
                    _series(e1[2], e2[2], m, nodes, costs, prefetch),
                ]
                elist = [e for e in elist if e is not e1 and e is not e2]
                elist.append(new)
                reduced = True
                break
        if not (reduced or changed):
            return None  # stuck: not two-terminal series-parallel
    e = elist[0]
    if e[0] == source and e[1] == sink:
        return e[2]
    return None


def place_dag_greedy(
    nodes, edges, candidates, costs: PlacementCosts, prefetch: bool = True
) -> dict:
    """Greedy topological placement — the pre-DP baseline, kept for
    benchmarking (``benchmarks/placement_bench.py``) and as the fallback
    for graphs too large to solve exactly. Scores each node myopically:
    incoming transfers + exposed fetch + compute, predecessors fixed."""
    pred, order = _topo(nodes, edges)
    placement: dict = {}
    for u in order:
        s = nodes[u]
        options = candidates.get(u, [s.platform])

        def score(p):
            f = costs.fetch_s(u, p, s.data_deps)
            c = costs.compute_s(u, p)
            tin = sum(
                costs.transfer_s(placement[q], p, costs.payload_size)
                for q in pred[u]
                if q in placement
            )
            window = max(
                (costs.compute_s(q, placement[q]) for q in pred[u] if q in placement),
                default=0.0,
            )
            return tin + exposed_fetch(f, window, prefetch) + c

        placement[u] = min(options, key=score)
    return placement


def place_dag(
    nodes, edges, candidates, costs: PlacementCosts, prefetch: bool = True
) -> dict:
    """Exact placement minimizing ``dag_cost``.

    nodes: {name: StepSpec}; edges: [(src, dst)]. Returns {name: platform}.
    Two-terminal series-parallel graphs (chains, diamonds, nested fan-outs)
    solve by the reduction DP; small non-SP graphs enumerate; only large
    non-SP graphs fall back to the greedy."""
    cand = {n: list(candidates.get(n, [nodes[n].platform])) for n in nodes}
    touched = {a for a, _ in edges} | {b for _, b in edges}
    # isolated nodes are their own critical path: place independently
    placement = {
        n: min(
            cand[n],
            key=lambda p, n=n: _node_cost(n, p, 0.0, nodes, costs, prefetch),
        )
        for n in nodes
        if n not in touched
    }
    if not touched:
        return placement
    graph_nodes = {n: nodes[n] for n in nodes if n in touched}
    pred, order = _topo(graph_nodes, edges)
    sources = [n for n in order if not pred[n]]
    sinks = [n for n in order if all(n != a for a, _ in edges)]
    if len(sources) == 1 and len(sinks) == 1:
        s, t = sources[0], sinks[0]
        tables = [_base_table(a, b, cand, costs) for a, b in edges]
        table = _sp_reduce(list(edges), tables, s, t, graph_nodes, costs, prefetch)
        if table is not None:
            inv = _inv_chunks(costs)
            best = None
            for (ps, pt), entries in table.items():
                head = _node_cost(s, ps, 0.0, graph_nodes, costs, prefetch)
                for d, w, r, pl in entries:
                    fin_t = max(
                        d + _node_cost(t, pt, w, graph_nodes, costs, prefetch),
                        r + costs.compute_s(t, pt) * inv,
                    )
                    total = head + fin_t
                    if best is None or total < best[0]:
                        best = (total, {**pl, s: ps, t: pt})
            placement.update(best[1])
            return placement
    # exhaustive fallback for small non-series-parallel graphs
    names = list(graph_nodes)
    combos = 1
    for n in names:
        combos *= len(cand[n])
    if combos <= _EXHAUSTIVE_LIMIT:
        best = None
        for assignment in itertools.product(*(cand[n] for n in names)):
            pl = dict(zip(names, assignment))
            c = _dag_cost_views(graph_nodes, pred, order, pl, costs, prefetch)
            if best is None or c < best[0]:
                best = (c, pl)
        placement.update(best[1])
        return placement
    placement.update(place_dag_greedy(graph_nodes, edges, candidates, costs, prefetch))
    return placement


def _chain_graph(spec: WorkflowSpec):
    """The degenerate chain graph, keyed positionally (a chain may invoke
    the same function twice), with the cost callbacks remapped from step
    index back to step name."""
    steps = spec.steps
    ids = list(range(len(steps)))
    nodes = {i: steps[i] for i in ids}
    edges = [(i, i + 1) for i in ids[:-1]]

    def by_name(costs: PlacementCosts) -> PlacementCosts:
        return PlacementCosts(
            fetch_s=lambda i, p, deps: costs.fetch_s(steps[i].name, p, deps),
            compute_s=lambda i, p: costs.compute_s(steps[i].name, p),
            transfer_s=costs.transfer_s,
            payload_size=costs.payload_size,
            transfer_fl=costs.transfer_fl,
            chunks=costs.chunks,
        )

    return nodes, edges, by_name


def place_chain(
    spec: WorkflowSpec, candidates: dict, costs: PlacementCosts, prefetch: bool = True
) -> WorkflowSpec:
    """candidates: {step_name: [platform, ...]} — returns the re-routed spec.
    Delegates to the exact DAG DP on the degenerate chain graph."""
    steps = spec.steps
    nodes, edges, by_name = _chain_graph(spec)
    cand = {i: candidates.get(steps[i].name, [steps[i].platform]) for i in nodes}
    placement = place_dag(nodes, edges, cand, by_name(costs), prefetch)
    new_steps = tuple(
        StepSpec(s.name, placement[i], s.data_deps, s.prefetch, s.sync, s.params)
        for i, s in enumerate(steps)
    )
    return WorkflowSpec(new_steps, spec.workflow_id)


def chain_cost(
    spec: WorkflowSpec, costs: PlacementCosts, prefetch: bool = True
) -> float:
    """Expected serial cost of a fixed route (for reporting / tests): the
    ``dag_cost`` recurrence on the degenerate chain graph — one scoring
    model for every workflow shape."""
    nodes, edges, by_name = _chain_graph(spec)
    placement = {i: s.platform for i, s in nodes.items()}
    return dag_cost(nodes, edges, placement, by_name(costs), prefetch)
