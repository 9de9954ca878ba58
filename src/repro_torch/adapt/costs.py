"""Observed placement costs: materialize ``shipping.PlacementCosts`` from
live telemetry (the "measured EWMA stats (runtime)" mode that
``PlacementCosts``' docstring promised and nothing ever wired).

``observed_costs(hub, fallback, regions)`` returns a ``PlacementCosts``
whose callbacks consult the ``TelemetryHub`` first and fall back to the
modeled ``fallback`` costs for any cell with too few observations — so
``place_dag`` stays total: before traffic flows the estimator IS the model,
and as observations accumulate the measured cells take over one by one.
A candidate platform a step has never run on keeps its modeled compute
cost; the link it has never crossed keeps its modeled transfer cost. That
asymmetry is what makes online recomposition safe: degradation is measured
where it happens, alternatives are scored by the calibrated model.

``regions`` maps platform name -> region because the hub observes fetches
and transfers at region granularity (where the object store lives) while
``PlacementCosts`` callbacks speak platform names.
"""

from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.shipping import PlacementCosts

from repro_torch.adapt.telemetry import TelemetryHub


def regions_of(registry) -> dict:
    """{platform_name: region} from a PlatformRegistry."""
    return {name: registry.get(name).region for name in registry.names()}


def observed_costs(
    hub: TelemetryHub,
    fallback: PlacementCosts,
    regions: Optional[dict] = None,
    min_samples: int = 2,
    cold_starts: bool = True,
    chunks: Optional[int] = None,
    errors: bool = True,
    outages=None,
) -> PlacementCosts:
    """A ``PlacementCosts`` that prefers measurements over the model.

    - ``compute_s(step, p)``: the (step, p) EWMA once it has
      ``min_samples`` observations, else ``fallback.compute_s``. With
      ``cold_starts`` on (the default), the hub's cold/warm counts are
      folded in as an expected warm-up term, ``cold_rate x observed cold
      EWMA`` (``TelemetryHub.cold_penalty_s``) — a platform that keeps
      missing its warm pool pays for it in placement instead of winning on
      compute alone. Cells with no cold observations add nothing, so the
      estimator stays total.
    - ``fetch_s(step, p, deps)``: the sum of per-(key, region-of-p) fetch
      EWMAs when EVERY dep has been observed in that region, else
      ``fallback.fetch_s`` for the whole dep set (a half-measured set
      would mix scales).
    - ``transfer_s(a, b, size)``: the (region(a), region(b)) observed
      per-transfer EWMA — deliberately NOT rescaled to ``size`` (see
      ``TelemetryHub.transfer_s``: the observations are the workflow's own
      traffic, and linear rescaling explodes latency-dominated links) —
      else ``fallback.transfer_s``.
    - ``transfer_fl(a, b, size)`` (only when ``chunks`` resolves > 1):
      first/last-byte seconds for a pipelined edge, priced from the hub's
      latency+bandwidth fit (``TelemetryHub.transfer_fit``) — first byte
      pays latency + one chunk of bandwidth, last byte latency + the whole
      object — falling back to ``fallback.transfer_fl`` then to the
      degenerate ``(t, t)`` whole-transfer pair.

    ``chunks`` defaults to ``fallback.chunks``; when the resolved value is
    <= 1 no ``transfer_fl`` is attached, so existing callers get exactly
    the costs they always did.

    ``regions`` defaults to the identity (platform name IS the region),
    which is what the simulator benches use.

    Durability hooks (PR 10): with ``errors`` on, a flaky-but-alive cell
    pays the hub's expected-retry tax (``TelemetryHub.error_penalty_s`` —
    the error-rate twin of the cold penalty); a cell in ``outages`` (a set
    of (step, platform) pairs the controller currently considers dead)
    prices ``math.inf``, so ``place_dag`` cannot route through it at all.
    """
    regions = regions or {}
    outages = outages if outages is not None else frozenset()

    def region(platform: str) -> str:
        return regions.get(platform, platform)

    def compute_s(step, platform):
        if (step, platform) in outages:
            return math.inf
        obs = hub.compute_s(step, platform, min_samples)
        base = obs if obs is not None else fallback.compute_s(step, platform)
        if cold_starts:
            penalty = hub.cold_penalty_s(step, platform)
            if penalty:
                base += penalty
        if errors:
            penalty = hub.error_penalty_s(step, platform)
            if penalty:
                base += penalty
        return base

    def fetch_s(step, platform, deps):
        if not deps:
            return fallback.fetch_s(step, platform, deps)
        r = region(platform)
        total = 0.0
        for d in deps:
            key = getattr(d, "key", d)
            obs = hub.fetch_s(key, r, min_samples)
            if obs is None:
                return fallback.fetch_s(step, platform, deps)
            total += obs
        return total

    def transfer_s(a, b, size_bytes):
        obs = hub.transfer_s(region(a), region(b), size_bytes, min_samples)
        return obs if obs is not None else fallback.transfer_s(a, b, size_bytes)

    n_chunks = chunks if chunks is not None else fallback.chunks

    def transfer_fl(a, b, size_bytes):
        fit = hub.transfer_fit(region(a), region(b), max(min_samples, 4))
        if fit is not None:
            lat, per_byte = fit
            first = lat + (size_bytes / n_chunks) * per_byte
            last = lat + size_bytes * per_byte
            return first, last
        if fallback.transfer_fl is not None:
            return fallback.transfer_fl(a, b, size_bytes)
        t = transfer_s(a, b, size_bytes)
        return t, t

    return PlacementCosts(
        fetch_s=fetch_s,
        compute_s=compute_s,
        transfer_s=transfer_s,
        payload_size=fallback.payload_size,
        transfer_fl=transfer_fl if n_chunks > 1 else None,
        chunks=n_chunks,
    )
