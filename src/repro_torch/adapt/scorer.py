"""Batched candidate-placement scoring: distributions, not point costs.

``dag_cost`` scores a placement with one number per cost cell — fine for
the DP's search, but a swap decision deserves better: two placements with
the same expected cost can have very different tails, and the tail is what
an SLO pays for. The vectorized simulator makes the better comparison
cheap: ``PlacementScorer`` lifts a ``PlacementCosts`` (typically
``observed_costs`` over live telemetry) into a calibrated
``WorkflowSimulator`` whose transfer model IS the cost model's, then runs
one batched experiment per candidate placement — hundreds of simulated
requests per candidate in well under a millisecond — and compares the
placements at a quantile (p95 by default).

Wired into ``RecompositionController(scorer=...)``, this turns the swap
gate from "the DP's point cost improved" into "the simulated latency
distribution improved where it matters". Candidates share the seed, so the
comparison uses common random numbers: the quantile gap between two
placements is driven by the placements, not by sampling noise.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from repro_torch.core.shipping import PlacementCosts
from repro_torch.core.simulator import (
    Dist,
    ExperimentSpec,
    SimPlatform,
    SimStep,
    WorkflowSimulator,
)


class _CostSimulator(WorkflowSimulator):
    """A ``WorkflowSimulator`` whose inter-step transfer times come from a
    ``PlacementCosts`` callback instead of the built-in object-store model
    (platform names double as regions here, matching the cost model's
    vocabulary)."""

    def __init__(self, costs: PlacementCosts, platforms, **kwargs):
        super().__init__(platforms, **kwargs)
        self._costs = costs

    def _transfer_s(self, src: SimPlatform, dst: SimPlatform) -> float:
        return self._costs.transfer_s(src.name, dst.name, self._costs.payload_size)


class PlacementScorer:
    """Scores placements by simulated end-to-end latency distributions.

    ``sigma`` is the multiplicative spread given to every cost-derived
    median (the cost model carries no dispersion of its own); ``quantile``
    is where placements are compared — 0.5 reproduces a median ranking,
    the 0.95 default penalizes placements that only win on average.

    ``backend`` picks the simulator backend: ``"torch"`` (default) scores
    the WHOLE candidate set in one sweep on ``device``
    (``simulate_placements``, f32; the card by default, raising without
    one, ``device="cpu"`` for the host) — same CRN property, and the
    per-candidate cost stops growing with the set size. ``"numpy"`` (or
    ``"scalar"``) runs one host experiment per candidate and ignores
    ``device``.
    ``seeds`` replicates the experiment (tail quantiles get
    ``len(seeds) * n_requests`` samples); None keeps the single ``seed``
    stream.
    """

    def __init__(
        self,
        n_requests: int = 256,
        seed: int = 0,
        quantile: float = 0.95,
        sigma: float = 0.12,
        interarrival_s: float = 1.0,
        msg_latency_s: float = 0.045,
        backend: str = "torch",
        seeds=None,
        device="cuda",
    ):
        self.n_requests = n_requests
        self.seed = seed
        self.quantile = quantile
        self.sigma = sigma
        self.interarrival_s = interarrival_s
        self.msg_latency_s = msg_latency_s
        self.backend = backend
        self.seeds = tuple(seeds) if seeds is not None else None
        self.device = device

    # -- building the simulated world from a cost model ------------------------
    def _platforms(self, placements) -> list:
        names = sorted({p for pl in placements for p in pl.values()})
        # cold starts are priced into compute by observed_costs
        # (cold_penalty_s), so the scorer's platforms never go cold here
        return [
            SimPlatform(name, name, cold_start=Dist(0.0), keep_warm_s=float("inf"))
            for name in names
        ]

    def _steps(self, nodes, order, placement, costs: PlacementCosts) -> list:
        steps = []
        for name in order:
            platform = placement[name]
            deps = getattr(nodes[name], "data_deps", ())
            steps.append(
                SimStep(
                    name,
                    platform,
                    compute=Dist(costs.compute_s(name, platform), self.sigma),
                    fetch=Dist(costs.fetch_s(name, platform, deps), self.sigma),
                )
            )
        return steps

    # -- scoring ---------------------------------------------------------------
    def distributions(
        self, nodes, edges, placements, costs: PlacementCosts, prefetch: bool = True
    ) -> np.ndarray:
        """The whole candidate set under common random numbers: a
        ``(len(placements), len(seeds or [seed]) * n_requests)`` matrix of
        simulated totals, one row per placement. ``nodes`` is
        ``{name: step}`` (anything with optional ``data_deps``), ``edges``
        the DAG edge list. On ``backend="torch"`` all rows come from ONE
        sweep; on ``"numpy"``/``"scalar"`` each row is its own
        experiment on the same seeds (bit-identical draws either way
        within a backend — the CRN guarantee)."""
        order = list(nodes)
        platforms = self._platforms(placements)
        step_sets = [self._steps(nodes, order, p, costs) for p in placements]
        sim = _CostSimulator(
            costs,
            platforms,
            msg_latency_s=self.msg_latency_s,
            payload_size_bytes=costs.payload_size,
            seed=self.seed,
        )
        spec = ExperimentSpec(
            step_sets[0],
            edges=tuple(edges),
            n_requests=self.n_requests,
            interarrival_s=self.interarrival_s,
            prefetch=prefetch,
            seeds=self.seeds if self.seeds is not None else (self.seed,),
        )
        if self.backend == "torch":
            totals = sim.simulate_placements(
                spec, step_sets, dtype=np.float32, device=self.device
            )
        else:
            totals = np.stack(
                [
                    sim.simulate(replace(spec, steps=ss), backend=self.backend)
                    for ss in step_sets
                ],
                axis=1,
            )
        # (S, P, n) -> (P, S * n): rows are placements, columns samples
        return np.ascontiguousarray(np.swapaxes(totals, 0, 1)).reshape(
            len(placements), -1
        )

    def quantiles(
        self, nodes, edges, placements, costs: PlacementCosts, prefetch: bool = True
    ) -> list:
        """The comparison statistic per placement (same order as given)."""
        dists = self.distributions(nodes, edges, placements, costs, prefetch)
        return [float(np.quantile(row, self.quantile)) for row in dists]

    def score(
        self, nodes, edges, placement, costs: PlacementCosts, prefetch: bool = True
    ) -> dict:
        """Summary statistics for one placement's simulated distribution."""
        row = self.distributions(nodes, edges, [placement], costs, prefetch)[0]
        return {
            "median_s": float(np.median(row)),
            "p95_s": float(np.quantile(row, 0.95)),
            "p99_s": float(np.quantile(row, 0.99)),
            "mean_s": float(row.mean()),
            "quantile_s": float(np.quantile(row, self.quantile)),
        }
