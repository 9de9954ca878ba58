"""Online telemetry: the measured-EWMA side of ``shipping.PlacementCosts``.

GeoFF's headline claim is ad-hoc recomposition, but a placement can only be
*re*-composed against live conditions if something measures them. The
``TelemetryHub`` is that something: a thread-safe registry of EWMA
observations, fed by small duck-typed hooks in the runtime —

  dag/engine.py      per-(step, platform) handler compute seconds
  core/prewarm.py    cold-start / warm-hit counts and compile seconds
                     per (step, platform)
  core/prefetch.py   per-(key, region) fetch seconds
  core/store.py      per-(src_region, dst_region) transfer seconds + bytes

— and by the unified simulator (``WorkflowSimulator(telemetry=...)``), so
simulated experiments exercise the same observe → estimate → re-place loop
the real engine runs. The hub never *pushes* anything: ``adapt.costs.
observed_costs`` pulls a ``PlacementCosts`` view from it on demand, falling
back to modeled costs for cells with too few samples (Kulkarni et al. 2025
show public-cloud latencies drift by integer factors over hours — the EWMA
tracks that drift; the fallback keeps ``place_dag`` total before any
traffic has flowed).

Producers call ``record_*``; they hold the hub lock only long enough to
update one EWMA, so instrumentation stays off the critical path.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.timing import EWMA

# per-pair (bytes, seconds) sample window for the latency+bandwidth fit:
# big enough to span the byte spread chunked + whole transfers produce,
# small enough that the fit tracks drift
_FIT_WINDOW = 64


class TelemetryHub:
    """Thread-safe EWMA store for every observation class the placement
    cost model consumes. All ``record_*`` methods are safe to call from any
    executor thread; ``snapshot`` returns a plain-dict copy for reports."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        self._lock = threading.Lock()
        self._compute: dict = {}  # (step, platform) -> EWMA seconds
        self._fetch: dict = {}  # (key, region) -> EWMA seconds
        self._transfer_s: dict = {}  # (src_region, dst_region) -> EWMA s
        self._transfer_b: dict = {}  # (src_region, dst_region) -> EWMA bytes
        self._cold: dict = {}  # (step, platform) -> cold-start count
        self._warm: dict = {}  # (step, platform) -> warm-hit count
        self._cold_s: dict = {}  # (step, platform) -> EWMA cold seconds
        self._transfer_pts: dict = {}  # pair -> deque[(bytes, seconds)]
        self._edge_b: dict = {}  # (src_step, dst_step) -> EWMA payload bytes
        self._err: dict = {}  # (step, platform) -> EWMA error indicator
        self._err_n: dict = {}  # (step, platform) -> total error count

    def _ewma(self, table: dict, key) -> EWMA:
        # callers hold self._lock
        e = table.get(key)
        if e is None:
            e = table[key] = EWMA(self.alpha)
        return e

    # -- producers (instrumentation hooks call these) --------------------------
    def record_compute(self, step: str, platform: str, seconds: float):
        with self._lock:
            self._ewma(self._compute, (step, platform)).update(seconds)
            # a completed handler is a success observation for the error
            # rate — without it the EWMA would never decay after recovery
            self._ewma(self._err, (step, platform)).update(0.0)

    def record_error(self, step: str, platform: str, n: int = 1):
        """Count ``n`` failed attempts on (step, platform): bumps the error
        count and feeds 1.0-valued observations into the error-rate EWMA
        (successes feed 0.0 via ``record_compute``, so the EWMA converges
        on the live failure fraction and decays when the platform heals)."""
        if n <= 0:
            return
        with self._lock:
            key = (step, platform)
            self._err_n[key] = self._err_n.get(key, 0) + int(n)
            self._ewma(self._err, key).update_many(1.0, int(n))

    def record_fetch(self, key: str, region: str, seconds: float):
        with self._lock:
            self._ewma(self._fetch, (key, region)).update(seconds)

    def record_transfer(
        self, src_region: str, dst_region: str, size_bytes: float, seconds: float
    ):
        pair = (src_region, dst_region)
        with self._lock:
            self._ewma(self._transfer_s, pair).update(seconds)
            self._ewma(self._transfer_b, pair).update(float(size_bytes))
            pts = self._transfer_pts.get(pair)
            if pts is None:
                pts = self._transfer_pts[pair] = deque(maxlen=_FIT_WINDOW)
            pts.append((float(size_bytes), float(seconds)))

    def record_edge_bytes(self, src_step: str, dst_step: str, nbytes: float):
        """Observed payload bytes on a DAG edge (EWMA). The engine's direct
        P2P path consults this to decide, per edge, whether the payload is
        small enough to skip the store round-trip."""
        with self._lock:
            self._ewma(self._edge_b, (src_step, dst_step)).update(float(nbytes))

    def record_cold_start(
        self, step: str, platform: str, seconds: Optional[float] = None
    ):
        """Count a cold start; when the producer knows how long the warm-up
        took (compile seconds on the engine, the sampled cold draw in the
        simulator) it passes ``seconds`` so placement can price cold starts
        (``cold_penalty_s``), not just count them."""
        with self._lock:
            key = (step, platform)
            self._cold[key] = self._cold.get(key, 0) + 1
            if seconds is not None:
                self._ewma(self._cold_s, key).update(seconds)

    def record_warm_hit(self, step: str, platform: str):
        with self._lock:
            key = (step, platform)
            self._warm[key] = self._warm.get(key, 0) + 1

    # -- batch producers (the vectorized simulator reports aggregates) ---------
    def record_compute_batch(self, step: str, platform: str, seconds):
        seconds = np.asarray(seconds)
        if seconds.size == 0:
            return
        with self._lock:
            self._ewma(self._compute, (step, platform)).update_many(
                float(seconds.mean()), seconds.size
            )
            self._ewma(self._err, (step, platform)).update_many(0.0, seconds.size)

    def record_error_batch(self, step: str, platform: str, n_err: int):
        """Vectorized-simulator twin of ``record_error``."""
        self.record_error(step, platform, n_err)

    def record_fetch_batch(self, key: str, region: str, seconds):
        seconds = np.asarray(seconds)
        if seconds.size == 0:
            return
        with self._lock:
            self._ewma(self._fetch, (key, region)).update_many(
                float(seconds.mean()), seconds.size
            )

    def record_transfer_batch(
        self, src_region: str, dst_region: str, size_bytes: float, seconds
    ):
        seconds = np.asarray(seconds)
        if seconds.size == 0:
            return
        pair = (src_region, dst_region)
        with self._lock:
            self._ewma(self._transfer_s, pair).update_many(
                float(seconds.mean()), seconds.size
            )
            self._ewma(self._transfer_b, pair).update_many(
                float(size_bytes), seconds.size
            )
            pts = self._transfer_pts.get(pair)
            if pts is None:
                pts = self._transfer_pts[pair] = deque(maxlen=_FIT_WINDOW)
            pts.append((float(size_bytes), float(seconds.mean())))

    def record_cold_start_batch(
        self, step: str, platform: str, n_cold: int, n_warm: int, cold_seconds=()
    ):
        cold_seconds = np.asarray(cold_seconds)
        with self._lock:
            key = (step, platform)
            if n_cold:
                self._cold[key] = self._cold.get(key, 0) + n_cold
            if n_warm:
                self._warm[key] = self._warm.get(key, 0) + n_warm
            if cold_seconds.size:
                self._ewma(self._cold_s, key).update_many(
                    float(cold_seconds.mean()), cold_seconds.size
                )

    # -- consumers (the cost estimator pulls these) ----------------------------
    def compute_s(self, step: str, platform: str, min_samples: int = 1):
        """Observed compute EWMA, or None below ``min_samples``."""
        with self._lock:
            e = self._compute.get((step, platform))
            return e.value if e is not None and e.n >= min_samples else None

    def fetch_s(self, key: str, region: str, min_samples: int = 1):
        with self._lock:
            e = self._fetch.get((key, region))
            return e.value if e is not None and e.n >= min_samples else None

    def transfer_s(
        self, src_region: str, dst_region: str, size_bytes: float, min_samples: int = 1
    ):
        """Observed per-transfer seconds on the pair's link (EWMA), or None
        when unobserved. Deliberately NOT rescaled to ``size_bytes``: the
        observations ARE the workflow's own payload/fetch traffic, so the
        EWMA already has the units placement scoring wants — seconds per
        transfer this workflow performs on this link. (Linear rescaling
        explodes on latency-dominated links where a 64-byte payload costs
        almost what a 1 MB one does; the observed bytes EWMA is kept for
        reporting.) ``size_bytes`` stays in the signature so the estimator
        is call-compatible with ``PlacementCosts.transfer_s``."""
        pair = (src_region, dst_region)
        with self._lock:
            es = self._transfer_s.get(pair)
            return es.value if es is not None and es.n >= min_samples else None

    def transfer_fit(
        self, src_region: str, dst_region: str, min_samples: int = 4
    ) -> Optional[tuple]:
        """Latency + bandwidth decomposition of the pair's link, fit from
        the recorded (bytes, seconds) points: returns ``(latency_s,
        per_byte_s)`` with both terms clamped >= 0, or None when fewer than
        ``min_samples`` points exist or the points carry no byte spread (a
        degree-1 fit needs at least two distinct sizes). Chunked transfers
        feed chunk-sized points alongside whole-object ones, which is what
        gives the fit its spread — the same telemetry that prices whole
        transfers prices pipelined first/last bytes."""
        with self._lock:
            pts = self._transfer_pts.get((src_region, dst_region))
            if pts is None or len(pts) < min_samples:
                return None
            xs = np.array([p[0] for p in pts])
            ys = np.array([p[1] for p in pts])
        if float(xs.max() - xs.min()) <= 0.0:
            return None
        per_byte, lat = np.polyfit(xs, ys, 1)
        return max(0.0, float(lat)), max(0.0, float(per_byte))

    def edge_bytes(self, src_step: str, dst_step: str, min_samples: int = 1):
        """Observed payload-bytes EWMA for a DAG edge, or None below
        ``min_samples``."""
        with self._lock:
            e = self._edge_b.get((src_step, dst_step))
            return e.value if e is not None and e.n >= min_samples else None

    def cold_start_rate(self, step: str, platform: str):
        """cold / (cold + warm) — None before any observation."""
        with self._lock:
            key = (step, platform)
            cold, warm = self._cold.get(key, 0), self._warm.get(key, 0)
            return cold / (cold + warm) if cold + warm else None

    def cold_penalty_s(self, step: str, platform: str):
        """Expected per-request cold-start seconds on (step, platform):
        ``cold_rate x observed cold EWMA``. None when the rate is unknown
        (no invocations seen) or cold starts happened but none carried a
        duration; 0.0 when every observed invocation was warm."""
        with self._lock:
            key = (step, platform)
            cold, warm = self._cold.get(key, 0), self._warm.get(key, 0)
            if cold + warm == 0:
                return None
            if cold == 0:
                return 0.0
            e = self._cold_s.get(key)
            if e is None or e.n == 0:
                return None
            return (cold / (cold + warm)) * e.value

    def error_rate(self, step: str, platform: str):
        """EWMA failure fraction for (step, platform) — None before any
        attempt (success or failure) has been observed."""
        with self._lock:
            e = self._err.get((step, platform))
            return e.value if e is not None and e.n else None

    def error_count(self, step: str, platform: str) -> int:
        with self._lock:
            return self._err_n.get((step, platform), 0)

    def error_counts(self) -> dict:
        """{(step, platform): total errors} copy — the controller diffs
        consecutive snapshots of this to detect *fresh* failures."""
        with self._lock:
            return dict(self._err_n)

    def error_penalty_s(self, step: str, platform: str):
        """Expected extra seconds per request a flaky-but-alive cell costs:
        with failure rate ``r`` and geometric retries, the expected number
        of extra attempts is ``r / (1 - r)``, each re-paying the compute
        EWMA. None when no attempts were observed or errors happened but
        compute is unmeasured; 0.0 when every attempt succeeded. ``r`` is
        clamped to 0.9 so a near-dead platform prices large-but-finite —
        *infinite* cost is the outage trigger's job, not the penalty's."""
        with self._lock:
            e = self._err.get((step, platform))
            if e is None or e.n == 0:
                return None
            r = e.value
            if r <= 0.0:
                return 0.0
            c = self._compute.get((step, platform))
            if c is None or c.n == 0:
                return None
            r = min(r, 0.9)
            return (r / (1.0 - r)) * c.value

    def reset_errors(self, step: str, platform: str):
        """Forget the error-rate EWMA for a cell (counts are kept for the
        audit trail). The controller calls this when an outage mark expires
        so fail-back gets an optimistic probe instead of being pinned down
        by stale failure history."""
        with self._lock:
            self._err.pop((step, platform), None)

    # -- reporting -------------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-dict copy of every table (the ``report()`` surface)."""
        with self._lock:
            return {
                "compute_s": {
                    f"{s}@{p}": e.value for (s, p), e in self._compute.items()
                },
                "fetch_s": {f"{k}@{r}": e.value for (k, r), e in self._fetch.items()},
                "transfer_s": {
                    f"{a}->{b}": e.value for (a, b), e in self._transfer_s.items()
                },
                "transfer_bytes": {
                    f"{a}->{b}": e.value for (a, b), e in self._transfer_b.items()
                },
                "edge_bytes": {
                    f"{a}->{b}": e.value for (a, b), e in self._edge_b.items()
                },
                "cold_starts": {f"{s}@{p}": n for (s, p), n in self._cold.items()},
                "warm_hits": {f"{s}@{p}": n for (s, p), n in self._warm.items()},
                "cold_s": {f"{s}@{p}": e.value for (s, p), e in self._cold_s.items()},
                "errors": {f"{s}@{p}": n for (s, p), n in self._err_n.items()},
                "error_rate": {
                    f"{s}@{p}": e.value for (s, p), e in self._err.items() if e.n
                },
            }


def attach(deployment, hub: Optional[TelemetryHub] = None) -> TelemetryHub:
    """Wire a hub into an existing (Dag)Deployment's components.

    The engine, cache, prefetcher, and store each carry a ``telemetry``
    attribute (None by default — zero overhead when unused); this sets all
    four in one place so a deployment constructed without telemetry can be
    instrumented after the fact. Returns the hub."""
    hub = hub or TelemetryHub()
    deployment.telemetry = hub
    deployment.cache.telemetry = hub
    deployment.prefetcher.telemetry = hub
    deployment.store.telemetry = hub
    return hub
