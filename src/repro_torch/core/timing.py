"""Optimized pre-fetch timing (paper §5.5 — future work, implemented here).

GeoFF pokes the successor as soon as the current step is invoked. That
minimizes workflow duration but maximizes double-billing: if prefetch+warm
finish long before the payload arrives, the successor's instance sits idle
(billed). The paper suggests learning the timing from monitoring data.

``PokeTimingController`` keeps its estimates at two granularities:

  - per STEP: EWMAs of the handler's compute duration and its warm+fetch
    (prepare) duration — properties of the function on its platform;
  - per EDGE ``(pred -> succ)``: the observed slack, i.e. payload arrival
    minus prepare completion. A fan-in node has several in-edges whose
    upstream dwell times differ, so one blended per-step number would delay
    every predecessor's poke by the same amount; keying slack per edge lets
    each predecessor learn its own gap.

The poke along edge ``(pred, succ)`` is delayed by the edge's
``EWMA(slack) - margin`` once slack observations exist (falling back to the
per-step estimate ``est_compute(pred) - est_prepare(succ) - margin``), so
preparation finishes just as that predecessor's payload arrives. ``margin``
trades duration risk against double-billing; both costs are accumulated per
edge and surfaced via ``report()`` so the trade-off is measurable
(benchmarks/timing_bench.py).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


class EWMA:
    def __init__(self, alpha: float = 0.25, init: float = 0.0):
        self.alpha = alpha
        self.value = init
        self.n = 0

    def update(self, x: float) -> float:
        self.value = (
            x if self.n == 0 else (1 - self.alpha) * self.value + self.alpha * x
        )
        self.n += 1
        return self.value

    def update_many(self, mean: float, count: int) -> float:
        """Fold a batch of ``count`` observations with the given ``mean``
        in one step (the vectorized simulator reports aggregates, not n
        singles): the estimate moves toward the batch mean with the weight
        ``count`` sequential updates would have carried in total,
        ``1 - (1 - alpha) ** count``."""
        if count <= 0:
            return self.value
        if self.n == 0:
            self.value = mean
        else:
            w = 1.0 - (1.0 - self.alpha) ** count
            self.value = (1 - w) * self.value + w * mean
        self.n += count
        return self.value


@dataclass
class StepTimings:
    compute: EWMA = field(default_factory=EWMA)
    prepare: EWMA = field(default_factory=EWMA)  # warm + prefetch duration


@dataclass
class EdgeTimings:
    slack: EWMA = field(default_factory=EWMA)  # payload_arrival - prepare_done
    double_billed: float = 0.0  # accumulated idle seconds on this edge
    exposed_wait: float = 0.0  # accumulated late seconds on this edge


class PokeTimingController:
    """mode='eager'  — paper-faithful: poke at invocation (delay 0).
    mode='learned' — §5.5: delay the poke to minimize double-billing."""

    def __init__(
        self, mode: str = "eager", margin_s: float = 0.05, alpha: float = 0.25
    ):
        assert mode in ("eager", "learned")
        self.mode = mode
        self.margin_s = margin_s
        self.alpha = alpha
        self._steps: dict = {}  # step_name -> StepTimings
        self._edges: dict = {}  # (pred_name, succ_name) -> EdgeTimings
        self._lock = threading.Lock()

    def _step(self, step_name: str) -> StepTimings:
        with self._lock:
            if step_name not in self._steps:
                # every EWMA must see the configured alpha
                self._steps[step_name] = StepTimings(
                    EWMA(self.alpha),
                    EWMA(self.alpha),
                )
            return self._steps[step_name]

    def _edge(self, pred_name: str, succ_name: str) -> EdgeTimings:
        key = (pred_name, succ_name)
        with self._lock:
            if key not in self._edges:
                self._edges[key] = EdgeTimings(EWMA(self.alpha))
            return self._edges[key]

    def poke_delay(self, pred_name: str, succ_name: str) -> float:
        if self.mode == "eager":
            return 0.0
        edge = self._edge(pred_name, succ_name)
        if edge.slack.n > 0:
            # best estimator: this edge's observed idle gap (payload arrival
            # minus prepare completion), which accounts for cascaded pokes
            # and the specific predecessor's dwell
            return max(0.0, edge.slack.value - self.margin_s)
        pred = self._step(pred_name)
        succ = self._step(succ_name)
        if pred.compute.n == 0 or succ.prepare.n == 0:
            return 0.0  # no data yet -> eager
        return max(0.0, pred.compute.value - succ.prepare.value - self.margin_s)

    def record_compute(self, step_name: str, seconds: float):
        self._step(step_name).compute.update(seconds)

    def record_prepare(self, step_name: str, seconds: float):
        self._step(step_name).prepare.update(seconds)

    def record_slack(self, pred_name: str, succ_name: str, prepared_early_s: float):
        """+ = instance idle (double-billed); - = payload waited. Recorded
        relative to the UNDELAYED poke (callers add the applied delay back),
        so the EWMA converges to the true gap and the learned delay tracks
        it instead of chasing its own feedback."""
        e = self._edge(pred_name, succ_name)
        e.slack.update(prepared_early_s)
        if prepared_early_s >= 0:
            e.double_billed += prepared_early_s
        else:
            e.exposed_wait += -prepared_early_s

    def report(self) -> dict:
        with self._lock:
            steps = {
                k: {"compute_s": v.compute.value, "prepare_s": v.prepare.value}
                for k, v in self._steps.items()
            }
            edges = {
                f"{a}->{b}": {
                    "slack_s": e.slack.value,
                    "double_billed_s": e.double_billed,
                    "exposed_wait_s": e.exposed_wait,
                }
                for (a, b), e in self._edges.items()
            }
            return {"steps": steps, "edges": edges}
