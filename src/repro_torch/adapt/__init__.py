"""repro_torch.adapt — online telemetry and ad-hoc workflow recomposition.

A copy of the JAX package's ``repro.adapt`` with its imports re-pointed;
the scorer's batched backend is ``"torch"`` (``core/torchsim.py``), and
``AdaptiveDeployment(tracer=...)`` raises until ``obs`` is ported.

GeoFF routes are per-request data, so recomposition never needed a
redeploy; this package closes the loop that makes recomposition *online*:

  telemetry   TelemetryHub — thread-safe EWMAs of observed compute,
              fetch, transfer, and cold-start behavior, fed by duck-typed
              hooks in the engine, compile cache, prefetcher, object
              store, and the unified simulator
  costs       observed_costs(hub, fallback) — a shipping.PlacementCosts
              view over the hub that falls back to the modeled costs for
              unobserved cells, keeping place_dag total
  controller  RecompositionController (re-run the exact placement DP
              every N requests or on cost drift, with cooldown +
              minimum-improvement hysteresis) + AdaptiveDeployment
              (versioned RouteTable hot-swap over a DagDeployment;
              in-flight requests finish on their captured routes, moved
              steps are pre-warmed before cutover)
  scorer      PlacementScorer — batched candidate scoring through the
              vectorized simulator: placements are compared on simulated
              latency distributions (common random numbers, quantile
              gate), not point costs

The JAX package's benchmarks/adapt_bench.py degrades one platform 5x mid-run and shows the
adaptive deployment recovering most of the lost end-to-end latency.
"""

from repro_torch.adapt.telemetry import TelemetryHub, attach  # noqa: F401
from repro_torch.adapt.costs import observed_costs, regions_of  # noqa: F401
from repro_torch.adapt.controller import (  # noqa: F401
    AdaptiveDeployment,
    RecompositionController,
    RouteTable,
)
from repro_torch.adapt.scorer import PlacementScorer  # noqa: F401
