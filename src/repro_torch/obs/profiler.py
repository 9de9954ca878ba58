"""What-if causal profiling: rank interventions by predicted tail impact.

A flame graph says where time WENT; it cannot say what fixing a component
would BUY — off-critical-path work attributes seconds that, removed,
change nothing, and a shared bottleneck can matter more than its share
suggests. Causal profiling (Coz, Curtsinger & Berger, SOSP'15) answers
the right question by *virtual speedups*: perturb one component, measure
the end-to-end delta. We get the perturbation for free — ``obs`` traces
calibrate the workflow simulator to what production actually observed,
so a virtual speedup is just an edited ``ExperimentSpec`` replayed on the
batched torch backend (on the card by default) or a named host backend.

Pipeline:

  ``calibrate(trace)``     observed trace -> :class:`CalibratedWorkflow`
                           (platform cold starts, per-step compute/fetch
                           medians, per-edge transfer table, estimated
                           poke latency — all pinned, sigma 0 by default
                           so replays are exact, not sampled)
  ``WhatIfProfiler``       applies one intervention per run — 2x compute
                           per step, 2x fetch / enable pre-fetch per
                           fetching step, 2x transfer per edge (what
                           streaming or co-placement buys), cold-start
                           elimination per platform (pre-warming) — and
                           ranks by predicted p95 delta: "pre-fetch
                           ocr/weights: -31% p95", "stream edge
                           virus->e_mail: -12% p95".

The per-edge transfer pins ride the simulator's ``transfer_table`` hook,
honored by all three backends. The ranked list is advice in the paper's
own vocabulary: pre-fetch, pre-warm, move/stream the edge.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.simulator import Dist, ExperimentSpec, SimPlatform, SimStep
from repro_torch.core.simulator import WorkflowSimulator


# -- trace -> model -------------------------------------------------------------
def full_fetch_s(trace) -> dict:
    """Full (pre-overlap) fetch seconds per (node, key), from component
    span events. A node span's ``fetch_s`` is only the RESIDUAL the
    request waited; ``prefetch.done`` / ``fetch.cold`` events carry the
    modeled duration, and land on poke/fetch spans that name their node."""
    out: dict = {}
    for span in trace.spans:
        node = span.attrs.get("node") if span.attrs else None
        for _t, name, attrs in span.events:
            if name in ("prefetch.done", "fetch.cold") and "modeled_s" in attrs:
                k = (node, attrs.get("key"))
                out[k] = max(out.get(k, 0.0), float(attrs["modeled_s"]))
    return out


def estimate_msg_s(trace, default: float = 0.005) -> float:
    """Poke message latency from observed poke times: median of
    ``(poke_t - t0) / depth`` over nodes with poke depth >= 1."""
    nodes = trace.node_spans()
    preds = {n: set(s.attrs.get("preds") or ()) for n, s in nodes.items()}
    depth, frontier, d = {}, {n for n, p in preds.items() if not p}, 0
    while frontier:
        for n in frontier:
            depth[n] = d
        frontier = {n for n in preds if n not in depth and preds[n] <= set(depth)}
        d += 1
    ests = [
        (nodes[n].attrs["poke_t"] - trace.root.t_start) / depth[n]
        for n in nodes
        if depth.get(n, 0) >= 1 and nodes[n].attrs.get("poke_t") is not None
    ]
    return float(np.median(ests)) if ests else default


@dataclass(frozen=True)
class CalibratedWorkflow:
    """A simulator-ready model pinned to one observed trace: the input of
    the what-if profiler."""

    platforms: tuple
    steps: tuple
    edges: Optional[tuple]
    transfer_table: dict = field(default_factory=dict)
    msg_latency_s: float = 0.005
    prefetch: bool = True

    def simulator(self, seed: int = 0, **kw) -> WorkflowSimulator:
        return WorkflowSimulator(
            list(self.platforms),
            msg_latency_s=self.msg_latency_s,
            transfer_table=dict(self.transfer_table),
            seed=seed,
            **kw,
        )

    def spec(self, **kw) -> ExperimentSpec:
        kw.setdefault("prefetch", self.prefetch)
        return ExperimentSpec(self.steps, edges=self.edges, **kw)


def calibrate(trace, regions=None, sigma: float = 0.0) -> CalibratedWorkflow:
    """Build a :class:`CalibratedWorkflow` from one observed trace (real
    engine or simulator — both emit the same span schema).

    Per platform: cold start pinned to the worst observed ``cold_s`` (the
    draw the trace actually paid); region looked up in ``regions`` (name
    -> region, defaults to the platform name — with every observed edge
    pinned in the transfer table, regions only matter for edges the trace
    never exercised). Per step: compute pinned to ``compute_s``; fetch
    pinned to the max of the summed per-key modeled fetches and the
    residual ``fetch_s`` (the prefetcher may have hidden most of it);
    ``prefetch`` mirrors whether the node was actually poked. Per edge:
    ``transfer_s`` attrs become the transfer table. ``sigma`` widens every
    pinned value into a lognormal for stochastic replay; the default 0
    keeps replays exact."""
    nodes = trace.node_spans()
    if not nodes:
        raise ValueError("trace has no node spans to calibrate from")
    regions = regions or {}
    fetch_by = full_fetch_s(trace)

    order = sorted(nodes)  # deterministic; the simulator re-topo-sorts
    plat_names = sorted({s.attrs["platform"] for s in nodes.values()})
    platforms = []
    for pname in plat_names:
        colds = [
            s.attrs.get("cold_s") or 0.0
            for s in nodes.values()
            if s.attrs["platform"] == pname
        ]
        platforms.append(
            SimPlatform(
                pname,
                regions.get(pname, pname),
                cold_start=Dist(max(colds, default=0.0), sigma),
            )
        )

    steps, edges, table = [], [], {}
    for name in order:
        span = nodes[name]
        a = span.attrs
        keyed = sum(v for (node, _k), v in fetch_by.items() if node == name)
        fetch = max(keyed, a.get("fetch_s") or 0.0)
        poked = a.get("poke_t") is not None
        steps.append(
            SimStep(
                name,
                a["platform"],
                compute=Dist(a.get("compute_s") or 0.0, sigma),
                fetch=Dist(fetch, sigma),
                prefetch=poked or not (a.get("preds") or ()),
            )
        )
        for pred in a.get("preds") or ():
            edges.append((pred, name))
            tr = (a.get("transfer_s") or {}).get(pred)
            if tr is not None:
                table[(pred, name)] = float(tr)

    return CalibratedWorkflow(
        platforms=tuple(platforms),
        steps=tuple(steps),
        edges=tuple(edges) if edges else None,
        transfer_table=table,
        msg_latency_s=estimate_msg_s(trace),
        prefetch=any(s.attrs.get("poke_t") is not None for s in nodes.values()),
    )


# -- virtual speedups -----------------------------------------------------------
@dataclass(frozen=True)
class Intervention:
    """One virtual change and its predicted end-to-end effect."""

    kind: str  # "compute" | "fetch" | "prefetch" | "transfer" | "warm"
    target: str  # step name, "src->dst" edge, or platform name
    speedup: float
    baseline_s: float
    predicted_s: float
    quantile: float

    @property
    def delta_s(self) -> float:
        return self.predicted_s - self.baseline_s

    @property
    def delta_pct(self) -> float:
        return 100.0 * self.delta_s / self.baseline_s if self.baseline_s else 0.0

    @property
    def label(self) -> str:
        q = f"p{int(round(self.quantile * 100))}"
        what = {
            "compute": f"{self.speedup:g}x compute {self.target}",
            "fetch": f"{self.speedup:g}x fetch {self.target}",
            "prefetch": f"pre-fetch deps of {self.target}",
            "transfer": f"stream edge {self.target}",
            "warm": f"keep {self.target} warm",
        }[self.kind]
        return f"{what}: {self.delta_pct:+.1f}% {q}"


def _scaled(dist: Dist, speedup: float) -> Dist:
    return Dist(dist.median / speedup, dist.sigma)


class WhatIfProfiler:
    """Rank virtual interventions on a :class:`CalibratedWorkflow` by
    predicted tail-quantile delta (most negative — biggest win — first).

    Every candidate run replays the same request stream on ``backend``
    (the batched torch backend on ``device`` by default, the card unless
    the caller passes ``device="cpu"``; ``"numpy"`` or ``"scalar"`` run on
    the host when named) with exactly one thing changed; with the
    calibrated model's sigma 0 the replays are deterministic, so deltas are
    exact model predictions, not noisy estimates. Candidates cover the paper's
    intervention vocabulary: faster/pre-fetched data deps, pre-warmed
    platforms, faster (streamed / co-placed) edges, and plain compute
    optimization as the control."""

    def __init__(
        self,
        world: CalibratedWorkflow,
        n_requests: int = 200,
        interarrival_s: float = 1.0,
        quantile: float = 0.95,
        seeds: Optional[tuple] = None,
        backend: str = "torch",
        device="cuda",
    ):
        self.world = world
        self.n_requests = n_requests
        self.interarrival_s = interarrival_s
        self.quantile = quantile
        self.seeds = seeds
        self.backend = backend
        self.device = device

    def _quantile_of(self, steps=None, transfer_table=None, platforms=None) -> float:
        w = self.world
        sim = WorkflowSimulator(
            list(platforms if platforms is not None else w.platforms),
            msg_latency_s=w.msg_latency_s,
            transfer_table=dict(
                transfer_table if transfer_table is not None else w.transfer_table
            ),
            seed=0,
        )
        spec = ExperimentSpec(
            steps if steps is not None else w.steps,
            edges=w.edges,
            n_requests=self.n_requests,
            interarrival_s=self.interarrival_s,
            prefetch=w.prefetch,
            seeds=self.seeds,
        )
        totals = sim.simulate(spec, backend=self.backend, device=self.device)
        return float(np.quantile(np.asarray(totals).ravel(), self.quantile))

    def baseline(self) -> float:
        if not hasattr(self, "_baseline"):
            self._baseline = self._quantile_of()
        return self._baseline

    def _candidates(self, speedup: float):
        w = self.world
        steps = list(w.steps)
        for i, s in enumerate(steps):
            if s.compute.median > 0:
                edit = steps[:i] + [
                    dataclasses.replace(s, compute=_scaled(s.compute, speedup))
                ] + steps[i + 1 :]
                yield ("compute", s.name, {"steps": edit})
            if s.fetch.median > 0:
                edit = steps[:i] + [
                    dataclasses.replace(s, fetch=_scaled(s.fetch, speedup))
                ] + steps[i + 1 :]
                yield ("fetch", s.name, {"steps": edit})
                if not s.prefetch:
                    edit = steps[:i] + [
                        dataclasses.replace(s, prefetch=True)
                    ] + steps[i + 1 :]
                    yield ("prefetch", s.name, {"steps": edit})
        for (u, v), tr in sorted(w.transfer_table.items()):
            table = dict(w.transfer_table)
            table[(u, v)] = tr / speedup
            yield ("transfer", f"{u}->{v}", {"transfer_table": table})
        for i, p in enumerate(w.platforms):
            if p.cold_start.median > 0:
                plats = list(w.platforms)
                plats[i] = dataclasses.replace(p, cold_start=Dist(0.0, 0.0))
                yield ("warm", p.name, {"platforms": plats})

    def rank(self, speedup: float = 2.0, top: Optional[int] = None) -> list:
        base = self.baseline()
        out = []
        for kind, target, kw in self._candidates(speedup):
            q = self._quantile_of(**kw)
            out.append(
                Intervention(
                    kind=kind,
                    target=target,
                    speedup=speedup,
                    baseline_s=base,
                    predicted_s=q,
                    quantile=self.quantile,
                )
            )
        out.sort(key=lambda iv: (iv.predicted_s, iv.kind, iv.target))
        return out if top is None else out[:top]


def profile_trace(trace, regions=None, speedup: float = 2.0, top: int = 3, **kw):
    """One-call surface: calibrate from a trace and return the top ranked
    interventions (``kw`` goes to :class:`WhatIfProfiler`: ``backend``,
    ``device``, ``n_requests``, ...)."""
    world = calibrate(trace, regions=regions)
    return WhatIfProfiler(world, **kw).rank(speedup=speedup, top=top)
