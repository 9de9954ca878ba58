"""SLOs and multi-window burn-rate alerting over the obs telemetry.

A latency SLO is a statement like "95% of document-workflow requests
finish under 3 s". The 5% allowance is the *error budget*; the *burn
rate* is how fast observed violations consume it: ``burn = bad_fraction /
error_budget``, so burn 1.0 spends the budget exactly on schedule and
burn 10 exhausts it ten times too fast. Alerting on the burn rate over
TWO windows at once — a short one and a long one — is the standard SRE
construction: the long window proves the breach is sustained (no paging
on one slow request), the short window proves it is *still happening*
(the alert clears as soon as the system recovers, without waiting for
the long window to drain).

``SloTracker`` implements exactly that on the epoch-ring machinery from
``metrics``: per-window exact good/bad counters (not histograms — a
burn rate needs counts, not quantiles), edge-triggered transitions, and
``slo.burn`` / ``slo.ok`` events recorded through ``tracer.record_event``
— the same control-plane ring that carries ``recompose.decision``, so an
exported event log shows cause (burn) and effect (the ``trigger="slo"``
re-placement decision) side by side. ``RecompositionController`` watches
``alerts`` and forces a scored re-placement once per breach episode.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SloSpec:
    """A per-workflow latency objective plus its alerting policy.

    ``target`` is the fraction of requests that must finish under
    ``objective_s`` (0.95 → 5% error budget). ``burn_threshold`` is the
    burn rate BOTH windows must exceed to alert; with the classic page
    thresholds (14.4 over 5m/1h) an all-bad outage pages in minutes while
    burn-1.0 noise never does. ``min_count`` keeps a near-empty fast
    window from alerting off two unlucky requests.
    """

    name: str
    objective_s: float
    target: float = 0.95
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_threshold: float = 6.0
    min_count: int = 8

    def __post_init__(self):
        if not (0.0 < self.target < 1.0):
            raise ValueError("target must be in (0, 1)")
        if self.objective_s <= 0:
            raise ValueError("objective_s must be positive")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast window must not exceed the slow window")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target


class _WindowCounter:
    """Exact good/bad counts over a trailing window — the epoch ring from
    ``WindowedHistogram``, reduced to two ints per epoch."""

    __slots__ = ("epochs", "epoch_s", "_bad", "_n", "_ids", "_cur")

    def __init__(self, window_s: float, epochs: int = 12):
        self.epochs = int(epochs)
        self.epoch_s = float(window_s) / self.epochs
        self._bad = [0] * self.epochs
        self._n = [0] * self.epochs
        self._ids = [None] * self.epochs
        self._cur: Optional[int] = None

    def observe(self, bad: bool, now: float):
        e = int(math.floor(now / self.epoch_s))
        if self._cur is None or e > self._cur:
            steps = (
                self.epochs if self._cur is None else min(e - self._cur, self.epochs)
            )
            for eid in range(e - steps + 1, e + 1):
                slot = eid % self.epochs
                self._bad[slot] = 0
                self._n[slot] = 0
                self._ids[slot] = eid
            self._cur = e
        slot = self._cur % self.epochs  # late observations absorb into current
        self._n[slot] += 1
        if bad:
            self._bad[slot] += 1

    def counts(self, now: Optional[float] = None) -> tuple:
        """(bad, total) over the live window ending at ``now``."""
        if self._cur is None:
            return (0, 0)
        e = self._cur if now is None else int(math.floor(now / self.epoch_s))
        lo = e - self.epochs
        bad = n = 0
        for slot, eid in enumerate(self._ids):
            if eid is not None and lo < eid <= e:
                bad += self._bad[slot]
                n += self._n[slot]
        return (bad, n)


class SloTracker:
    """Multi-window burn-rate evaluation of one :class:`SloSpec`.

    Feed every request's end-to-end latency through ``record(latency_s,
    now)``; the tracker maintains fast- and slow-window violation counts
    and evaluates the alert condition on each observation. Transitions
    are edge-triggered: entering the burning state bumps ``alerts`` ONCE
    per breach episode and emits one ``slo.burn`` event (with both burn
    rates in the attrs); recovery emits ``slo.ok``. Consumers that act on
    breaches — ``RecompositionController`` — latch on the ``alerts``
    counter rather than the level, so a sustained breach triggers one
    re-placement, not one per request.

    The clock is the caller's (engine ``perf_counter`` or sim seconds),
    same contract as ``WindowedHistogram``. Thread-safe; events are
    emitted outside the lock.
    """

    def __init__(self, spec: SloSpec, tracer=None, epochs: int = 12):
        self.spec = spec
        self.tracer = tracer
        self._lock = threading.Lock()
        self._fast = _WindowCounter(spec.fast_window_s, epochs)
        self._slow = _WindowCounter(spec.slow_window_s, epochs)
        self.burning = False
        self.alerts = 0
        self.stats = {"observed": 0, "violations": 0, "alerts": 0, "recoveries": 0}

    def _rates_locked(self, now: Optional[float]) -> tuple:
        """((fast_burn, fast_n), (slow_burn, slow_n)) at ``now``."""
        budget = self.spec.error_budget
        out = []
        for win in (self._fast, self._slow):
            bad, n = win.counts(now)
            frac = bad / n if n else 0.0
            out.append((frac / budget, n))
        return tuple(out)

    def record(self, latency_s: float, now: float) -> bool:
        """Observe one request; returns the (possibly new) burning state."""
        bad = latency_s > self.spec.objective_s
        event = None
        with self._lock:
            self.stats["observed"] += 1
            if bad:
                self.stats["violations"] += 1
            self._fast.observe(bad, now)
            self._slow.observe(bad, now)
            (fast_burn, fast_n), (slow_burn, _) = self._rates_locked(now)
            breach = (
                fast_n >= self.spec.min_count
                and fast_burn >= self.spec.burn_threshold
                and slow_burn >= self.spec.burn_threshold
            )
            if breach and not self.burning:
                self.burning = True
                self.alerts += 1
                self.stats["alerts"] += 1
                event = "slo.burn"
            elif not breach and self.burning:
                self.burning = False
                self.stats["recoveries"] += 1
                event = "slo.ok"
            burning = self.burning
        if event is not None and self.tracer is not None:
            self.tracer.record_event(
                event,
                {
                    "slo": self.spec.name,
                    "objective_s": self.spec.objective_s,
                    "target": self.spec.target,
                    "fast_burn": round(fast_burn, 3),
                    "slow_burn": round(slow_burn, 3),
                    "threshold": self.spec.burn_threshold,
                    "now": now,
                },
            )
        return burning

    def burn_rates(self, now: Optional[float] = None) -> tuple:
        """(fast_burn, slow_burn) at ``now`` (default: last observation)."""
        with self._lock:
            (fast_burn, _), (slow_burn, _) = self._rates_locked(now)
        return (fast_burn, slow_burn)

    def snapshot(self, now: Optional[float] = None) -> dict:
        with self._lock:
            (fast_burn, fast_n), (slow_burn, slow_n) = self._rates_locked(now)
            return {
                "slo": self.spec.name,
                "objective_s": self.spec.objective_s,
                "target": self.spec.target,
                "burning": self.burning,
                "fast_burn": fast_burn,
                "slow_burn": slow_burn,
                "fast_n": fast_n,
                "slow_n": slow_n,
                **self.stats,
            }
