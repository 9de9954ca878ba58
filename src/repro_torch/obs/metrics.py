"""Bounded log-bucketed latency histograms (the tail side of telemetry).

``repro_torch.adapt.TelemetryHub`` keeps EWMAs — the right shape for placement
cost cells, and the wrong shape for "why was request #4812 slow?": an EWMA
cannot say p99. The FaaS measurement literature (Characterizing FaaS
Workflows on Public Clouds, PAPERS.md) attributes tail latency per
percentile, so ``repro_torch.obs`` keeps full distributions — as histograms with
geometrically spaced buckets, which cost a fixed few hundred ints per
series no matter how many observations land (a long-lived deployment must
never grow per-request state).

``LogHistogram`` covers 1 microsecond to ~1 hour in 160 buckets at 15%
relative width: quantiles interpolate inside the winning bucket, so a
reported p99 is within one bucket width (~15%) of the true order
statistic — tight enough to rank and alert on, bounded enough to keep
forever. ``WindowedHistogram`` adds the time axis an SLO needs: a ring of
per-epoch sub-histograms rotated in O(1), merged on demand into "the
distribution over the last N seconds" — so p95 can mean *now*, not
since-birth. ``MetricsRegistry`` is the named collection the engine,
simulator and tracer feed; ``DagDeployment.report()`` merges its snapshot
next to the counter/EWMA surfaces.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional


class LogHistogram:
    """Fixed-size histogram with geometrically spaced bucket edges.

    Bucket ``i`` (0-based) covers ``[min_value * base**i,
    min_value * base**(i+1))``; one underflow and one overflow bucket
    bracket the range, so ``observe`` never fails and memory never grows.
    """

    __slots__ = ("base", "min_value", "n_buckets", "counts", "count", "sum", "max")

    def __init__(
        self, base: float = 1.15, min_value: float = 1e-6, n_buckets: int = 160
    ):
        self.base = base
        self.min_value = min_value
        self.n_buckets = n_buckets
        self.counts = [0] * (n_buckets + 2)  # [underflow, buckets..., overflow]
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def _bucket(self, x: float) -> int:
        if x < self.min_value:
            return 0
        i = int(math.log(x / self.min_value) / math.log(self.base))
        return min(i, self.n_buckets) + 1

    def observe(self, x: float):
        x = float(x)
        self.counts[self._bucket(x)] += 1
        self.count += 1
        self.sum += x
        if x > self.max:
            self.max = x

    def reset(self):
        """Zero in place (epoch recycling — no reallocation on rotate)."""
        for i in range(len(self.counts)):
            self.counts[i] = 0
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def copy(self) -> "LogHistogram":
        """Cheap structural copy: lets ``MetricsRegistry.snapshot`` copy
        bucket counts under its lock and run the quantile rank walks
        OUTSIDE it (a reporter must never block the observe hot path)."""
        h = LogHistogram(self.base, self.min_value, self.n_buckets)
        h.counts = list(self.counts)
        h.count = self.count
        h.sum = self.sum
        h.max = self.max
        return h

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into self (same bucketing required). Maxes merge
        too, so a windowed histogram assembled from per-epoch pieces
        carries the max of the LIVE epochs only — an evicted epoch's
        stale all-time max can never clamp a windowed p99."""
        if (
            other.base != self.base
            or other.min_value != self.min_value
            or other.n_buckets != self.n_buckets
        ):
            raise ValueError("merge requires identical bucket geometry")
        counts = self.counts
        for i, c in enumerate(other.counts):
            if c:
                counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.max > self.max:
            self.max = other.max
        return self

    def _edge(self, i: int) -> float:
        """Lower edge of bucket slot ``i`` (slot 0 is the underflow)."""
        if i <= 0:
            return 0.0
        return self.min_value * self.base ** (i - 1)

    def quantile(self, q: float) -> float:
        """The q-quantile by rank walk + geometric interpolation inside the
        winning bucket — exact to one bucket width (~``base - 1`` relative).
        0.0 before any observation."""
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c > rank:
                frac = (rank - seen + 0.5) / c
                lo = self._edge(i)
                hi = self._edge(i + 1) if i <= self.n_buckets else self.max
                if lo <= 0.0:
                    return min(hi, self.max)
                return min(lo * (hi / lo) ** min(max(frac, 0.0), 1.0), self.max)
            seen += c
        return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum_s": self.sum,
            "mean_s": self.sum / self.count if self.count else 0.0,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "p99_s": self.quantile(0.99),
            "max_s": self.max,
        }


class WindowedHistogram:
    """A ``LogHistogram`` with a time axis: quantiles over the trailing
    ``window_s`` seconds, not since birth.

    Implementation: a ring of ``epochs`` sub-histograms, each covering
    ``window_s / epochs`` seconds of the caller's clock. ``observe`` lands
    in the epoch containing ``now``; advancing past an epoch boundary
    rotates the ring in O(epochs)-bounded work (recycle the slots that
    fell out — no per-observation scan, no reallocation). ``window()``
    merges the live epochs into one histogram, so windowed quantiles cost
    the same rank walk as lifetime ones, and each epoch carries its OWN
    max (a stale all-time max from an evicted epoch cannot bias the
    windowed p99 — the bug the since-birth ``max`` clamp would introduce).

    The clock is whatever the producer passes as ``now`` — engine
    ``perf_counter`` seconds or simulation-clock seconds; one histogram
    must be fed by one clock. ``total`` keeps the since-birth histogram
    beside the ring. Not thread-safe on its own: ``MetricsRegistry``
    serializes access.
    """

    __slots__ = ("window_s", "epochs", "epoch_s", "total", "_ring", "_ids", "_cur")

    def __init__(self, window_s: float = 300.0, epochs: int = 10, **hist_kw):
        if window_s <= 0 or epochs <= 0:
            raise ValueError("window_s and epochs must be positive")
        self.window_s = float(window_s)
        self.epochs = int(epochs)
        self.epoch_s = self.window_s / self.epochs
        self.total = LogHistogram(**hist_kw)
        self._ring = [LogHistogram(**hist_kw) for _ in range(self.epochs)]
        self._ids = [None] * self.epochs  # absolute epoch id held per slot
        self._cur: Optional[int] = None  # latest epoch id seen

    def _epoch(self, now: float) -> int:
        return int(math.floor(now / self.epoch_s))

    def _rotate(self, e: int):
        """Advance the ring to epoch ``e``, recycling every slot that fell
        out of the window — at most ``epochs`` slots, however far the
        clock jumped (O(1) amortized per observation)."""
        if self._cur is not None and e <= self._cur:
            return  # same epoch, or a slightly-late observation: absorb
        steps = self.epochs if self._cur is None else min(e - self._cur, self.epochs)
        for eid in range(e - steps + 1, e + 1):
            slot = eid % self.epochs
            self._ring[slot].reset()
            self._ids[slot] = eid
        self._cur = e

    def observe(self, x: float, now: float):
        self._rotate(self._epoch(now))
        self._ring[self._cur % self.epochs].observe(x)
        self.total.observe(x)

    def window(self, now: Optional[float] = None) -> LogHistogram:
        """The merged histogram over epochs in the trailing window ending
        at ``now`` (default: the last observation's epoch). Read-only —
        never rotates, so probing a future ``now`` just sees epochs age
        out."""
        h = self.total
        out = LogHistogram(h.base, h.min_value, h.n_buckets)
        if self._cur is None:
            return out
        e = self._cur if now is None else self._epoch(now)
        lo = e - self.epochs  # live ids are (e - epochs, e]
        for slot, eid in enumerate(self._ids):
            if eid is not None and lo < eid <= e and self._ring[slot].count:
                out.merge(self._ring[slot])
        return out

    def copy(self) -> "WindowedHistogram":
        h = self.total
        c = WindowedHistogram.__new__(WindowedHistogram)
        c.window_s = self.window_s
        c.epochs = self.epochs
        c.epoch_s = self.epoch_s
        c.total = self.total.copy()
        c._ring = [hh.copy() for hh in self._ring]
        c._ids = list(self._ids)
        c._cur = self._cur
        del h
        return c

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Since-birth fields (the histogram contract) plus the windowed tail:
        ``w_count`` / ``w_p50_s`` / ``w_p95_s`` / ``w_p99_s`` / ``w_max_s``
        over the trailing ``window_s`` seconds."""
        out = self.total.snapshot()
        w = self.window(now)
        out.update(
            {
                "window_s": self.window_s,
                "w_count": w.count,
                "w_p50_s": w.quantile(0.50),
                "w_p95_s": w.quantile(0.95),
                "w_p99_s": w.quantile(0.99),
                "w_max_s": w.max,
            }
        )
        return out


class MetricsRegistry:
    """Thread-safe named histogram collection, bounded in series count.

    Producers call ``observe(name, seconds, now=...)``; the name
    vocabulary is ``<signal>/<where>`` (e.g. ``compute_s/ocr@gcf``,
    ``transfer_s/eu->us``). Beyond ``max_series`` distinct names, new
    series are dropped and counted in ``dropped_series`` — a runaway label
    cardinality must degrade reporting, never memory.

    Every series is a ``WindowedHistogram``: since-birth quantiles stay
    (``quantiles``), and ``window_quantiles`` / the ``w_*`` snapshot
    fields answer "p95 over the last ``window_s`` seconds". ``now``
    defaults to ``time.monotonic()``; the tracer passes each span's end
    time so a registry fed from simulation traces windows on the sim
    clock.

    ``snapshot`` copies bucket counts under the lock and computes every
    quantile OUTSIDE it — with 512 series x 160 buckets the rank walks
    are the expensive part, and a reporter must never stall a hot-path
    ``observe`` behind them.
    """

    def __init__(
        self, max_series: int = 512, window_s: float = 300.0, epochs: int = 10
    ):
        self.max_series = max_series
        self.window_s = window_s
        self.epochs = epochs
        self._lock = threading.Lock()
        self._hists: dict = {}
        self.dropped_series = 0

    def observe(self, name: str, value: float, now: Optional[float] = None):
        if now is None:
            now = time.monotonic()
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                if len(self._hists) >= self.max_series:
                    self.dropped_series += 1
                    return
                h = self._hists[name] = WindowedHistogram(self.window_s, self.epochs)
            h.observe(value, now)

    def _copy(self, name: str) -> Optional[WindowedHistogram]:
        with self._lock:
            h = self._hists.get(name)
            return None if h is None else h.copy()

    def quantiles(self, name: str) -> tuple:
        """Since-birth (p50, p95, p99) for one series — zeros when
        unobserved. Rank walks run on a copy, outside the lock."""
        h = self._copy(name)
        if h is None:
            return (0.0, 0.0, 0.0)
        t = h.total
        return (t.quantile(0.50), t.quantile(0.95), t.quantile(0.99))

    def window_quantiles(self, name: str, now: Optional[float] = None) -> tuple:
        """(p50, p95, p99) over the trailing window — zeros when
        unobserved (or when every epoch aged out)."""
        h = self._copy(name)
        if h is None:
            return (0.0, 0.0, 0.0)
        w = h.window(now)
        return (w.quantile(0.50), w.quantile(0.95), w.quantile(0.99))

    def top(
        self, n: int = 5, key: str = "w_p99_s", now: Optional[float] = None
    ) -> list:
        """The ``n`` hottest series by one snapshot field (windowed p99 by
        default) — the ops-report surface. Returns (name, snapshot)
        pairs, hottest first."""
        snap = self.snapshot(now)
        rows = [(name, s) for name, s in snap.items() if not name.startswith("__")]
        rows.sort(key=lambda kv: kv[1].get(key, 0.0), reverse=True)
        return rows[:n]

    def snapshot(self, now: Optional[float] = None) -> dict:
        with self._lock:  # copy counts only; quantile math happens below
            copies = sorted((name, h.copy()) for name, h in self._hists.items())
            dropped = self.dropped_series
        out = {name: h.snapshot(now) for name, h in copies}
        if dropped:
            out["__dropped_series__"] = dropped
        return out
