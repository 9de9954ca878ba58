"""Tail-based trace sampling: keep the traces worth debugging.

The Tracer's ring buffer is bounded (512 traces), but indiscriminate: a
burst of healthy requests evicts the one slow trace you needed. Tail
sampling inverts the retention policy — decide AFTER the request ends,
when its latency is known, and keep full span trees only for requests
that are (a) slow against the *windowed* p95 (sampling must adapt when
the baseline shifts — after a cutover, "slow" means slow *now*), (b) SLO
violations, or (c) a deterministic 1-in-N head-sampled baseline so the
healthy shape stays observable. Everything else keeps its aggregate
contribution — the metrics fold in ``Tracer.finish`` happens regardless
of the retention verdict, so histograms stay unbiased — and drops the
span tree.

``TailSampler`` is consulted by ``Tracer.finish`` when installed
(``Tracer(sampler=...)``); ``seen/kept/evicted`` counters (exact:
``kept + evicted == seen``) surface through ``DagDeployment.report()``
under ``trace_sampler``. The latency threshold is computed from the
window *before* folding the deciding request in, so one request never
raises the bar it is judged against.
"""

from __future__ import annotations

import threading
from typing import Optional

from .metrics import WindowedHistogram


class TailSampler:
    """Retention policy over finished traces, bounded-memory by design.

    ``decide(total_s, now)`` returns ``(keep, reason)`` with reason one of
    ``"slow"`` (at or above the windowed ``quantile`` threshold, scaled by
    ``margin``), ``"slo"`` (above the attached :class:`SloSpec` objective),
    or ``"head"`` (deterministic 1-in-``head_every`` baseline). The slow
    test arms only once the window holds ``min_count`` observations — a
    cold window keeps head samples, not everything.

    State is one :class:`WindowedHistogram` plus six counters; the clock
    contract is the caller's, same as the rest of ``repro_torch.obs``.
    """

    def __init__(
        self,
        window_s: float = 300.0,
        epochs: int = 10,
        quantile: float = 0.95,
        margin: float = 1.0,
        head_every: int = 64,
        slo=None,
        min_count: int = 32,
    ):
        if not (0.0 < quantile < 1.0):
            raise ValueError("quantile must be in (0, 1)")
        self.quantile = quantile
        self.margin = margin
        self.head_every = head_every
        self.slo = slo  # an SloSpec (or anything with .objective_s), optional
        self.min_count = min_count
        self._lock = threading.Lock()
        self._hist = WindowedHistogram(window_s, epochs)
        self.stats = {
            "seen": 0,
            "kept": 0,
            "evicted": 0,
            "kept_slow": 0,
            "kept_slo": 0,
            "kept_head": 0,
        }

    def threshold(self, now: Optional[float] = None) -> float:
        """The current slow-trace latency bar (0.0 while the window is
        still below ``min_count``)."""
        with self._lock:
            w = self._hist.window(now)
            if w.count < self.min_count:
                return 0.0
            return self.margin * w.quantile(self.quantile)

    def decide(self, total_s: float, now: float) -> tuple:
        """Judge one finished request and fold it into the window."""
        with self._lock:
            self.stats["seen"] += 1
            head = (
                self.head_every > 0
                and (self.stats["seen"] - 1) % self.head_every == 0
            )
            w = self._hist.window(now)
            slow = (
                w.count >= self.min_count
                and total_s >= self.margin * w.quantile(self.quantile)
            )
            # Threshold was computed on the PRIOR window; fold afterwards so
            # a request never raises the bar it is judged against.
            self._hist.observe(total_s, now)
            violating = self.slo is not None and total_s > self.slo.objective_s
            if slow:
                reason = "slow"
            elif violating:
                reason = "slo"
            elif head:
                reason = "head"
            else:
                self.stats["evicted"] += 1
                return (False, None)
            self.stats["kept"] += 1
            self.stats[f"kept_{reason}"] += 1
            return (True, reason)

    def snapshot(self, now: Optional[float] = None) -> dict:
        thr = self.threshold(now)
        with self._lock:
            out = dict(self.stats)
        out["threshold_s"] = thr
        return out
