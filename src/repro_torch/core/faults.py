"""Fault model shared by the simulator and the real engine (durable jobs).

Nothing in this repro could fail until now — every engine call succeeded
and every simulator draw completed. This module makes failures first-class
on BOTH sides of the sim/real split, from one schedule:

  ``FaultEvent``     per-(step, platform) transient error probability over
                     a request-index window — invocation errors, 429
                     throttling, the flaky-but-alive platform
  ``OutageEvent``    a platform (or a whole region) hard-down over a
                     request-index window — every attempt fails until the
                     window closes, the regional-failover scenario
  ``FaultSchedule``  the container, sitting next to ``DriftSchedule`` in
                     the simulator's surface; the engine's
                     ``FaultInjector`` raises from the same schedule
  ``RetryPolicy``    per-step retry budget: exponential backoff with
                     seeded jitter, plus the optional hedge knob the
                     engine's straggler duplication reads
  ``InjectedFault``  what the engine raises for an injected failure

Determinism contract: fault outcomes are a PURE FUNCTION of
``(schedule seed, step, platform, request index, attempt index)`` — a
counter-based splitmix64 hash, never the experiment rng. That buys three
properties at once: the scalar, numpy and jax simulator backends price the
identical fault plane bit-for-bit (the plane is precomputed host-side and
fed to the compiled sweep like the drift masks); an empty schedule draws
nothing, so disabled faults are bit-for-bit the fault-free run; and the
real engine's injector agrees with the simulator about WHICH request
fails, not just how many.

Pricing model (``FaultSchedule.plane``): attempt ``a`` of a node fails
when the platform is in an outage window or the attempt's hash uniform
falls under the composed transient probability. Each failed attempt with a
remaining budget pays its backoff delay (transient invocation errors
surface fast — throttling, 4xx — so the backoff IS the retry cost); a
node whose every attempt fails marks the request FAILED (the simulators
report ``inf`` for it, the engine dead-letters the job). Failed requests
are still priced as-if-completed inside the recurrence so the cold-start
bookkeeping stays identical across backends — only the reported total and
the telemetry change.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np

_MASK64 = 0xFFFFFFFFFFFFFFFF
_GOLD = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
# distinct hash streams per consumer (failure draw vs backoff jitter)
_STREAM_FAIL = 0x51AB
_STREAM_JITTER = 0x7E57


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized over uint64 arrays)."""
    x = (x ^ (x >> np.uint64(30))) * _MIX1
    x = (x ^ (x >> np.uint64(27))) * _MIX2
    return x ^ (x >> np.uint64(31))


def hash_u01(seed: int, salt: int, attempt: int, stream: int, ks) -> np.ndarray:
    """Deterministic uniforms in [0, 1) from a counter-based hash — one
    value per request index in ``ks``. Order-independent and rng-free, so
    every backend (and the real engine) evaluates the same outcome for the
    same (seed, node, request, attempt) without consuming anyone's draw
    stream."""
    # uint64 wraparound is the point of splitmix64 — silence the scalar
    # overflow warning numpy raises on intentionally-modular multiplies
    with np.errstate(over="ignore"):
        x = np.asarray(ks, dtype=np.uint64) + _GOLD
        x = _mix64(x * _GOLD + np.uint64(seed & _MASK64))
        x = _mix64(x ^ np.uint64(salt & _MASK64))
        x = _mix64(x + np.uint64(((attempt << 16) ^ stream) & _MASK64) * _GOLD)
        return (x >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def _node_salt(step: str, platform: str) -> int:
    """Stable 64-bit salt for a (step, platform) cell — shared by the
    simulator backends and the engine injector."""
    digest = hashlib.sha256(f"{step}@{platform}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


@dataclass(frozen=True)
class RetryPolicy:
    """Per-step retry budget with exponential backoff + seeded jitter.

    Attempt ``a`` (0-based) that fails with a next attempt remaining waits
    ``backoff_base_s * backoff_multiplier**a * (1 + jitter * u)`` where
    ``u`` is the deterministic hash uniform for (step, platform, request,
    attempt) — seeded jitter, not wall-clock randomness, so simulated and
    real retries de-synchronize identically and reproducibly.

    ``hedge_after_s`` is read by the ENGINE only: when an attempt has not
    returned after that many seconds, a duplicate is launched and the
    first finisher wins (the loser is cancelled and counted). The
    simulator prices retries/outages but not hedges (stragglers there are
    just draws)."""

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_multiplier: float = 2.0
    jitter: float = 0.5
    hedge_after_s: Optional[float] = None
    seed: int = 0

    def backoff_s(
        self, attempt: int, step: str = "", platform: str = "", request_k: int = 0
    ) -> float:
        u = float(
            hash_u01(
                self.seed,
                _node_salt(step, platform),
                attempt,
                _STREAM_JITTER,
                np.asarray([request_k]),
            )[0]
        )
        return (
            self.backoff_base_s
            * self.backoff_multiplier**attempt
            * (1.0 + self.jitter * u)
        )

    def backoff_arrays(
        self, attempt: int, step: str, platform: str, ks: np.ndarray
    ) -> np.ndarray:
        """``backoff_s`` over a whole request axis (the vectorized plane)."""
        u = hash_u01(self.seed, _node_salt(step, platform), attempt, _STREAM_JITTER, ks)
        return (
            self.backoff_base_s
            * self.backoff_multiplier**attempt
            * (1.0 + self.jitter * u)
        )


@dataclass(frozen=True)
class FaultEvent:
    """Transient per-attempt error probability on a platform (optionally
    one step of it) over the request-index window ``[from_request,
    to_request)`` (``to_request=None``: open-ended). Probabilities of
    overlapping events compose as independent failure sources."""

    platform: str
    p_error: float
    step: str = ""  # "" = every step on the platform
    from_request: int = 0
    to_request: Optional[int] = None


@dataclass(frozen=True)
class OutageEvent:
    """Hard platform (or whole-region) outage over ``[from_request,
    to_request)`` (``to_request=None``: open-ended): every attempt on a
    matching cell fails regardless of retry budget — the scenario the
    outage trigger must route around."""

    from_request: int
    to_request: Optional[int]
    platform: str = ""
    region: str = ""  # set instead of platform for a regional failover

    def __post_init__(self):
        if not self.platform and not self.region:
            raise ValueError("OutageEvent needs a platform or a region")


class FaultPlane(NamedTuple):
    """Per-(node, request-axis) fault pricing: seconds of retry backoff
    added to the node's end time, how many attempts failed, and whether
    the whole budget was exhausted (the request dead-letters)."""

    extra_s: np.ndarray  # (n,) float
    n_failures: np.ndarray  # (n,) int
    failed: np.ndarray  # (n,) bool


class FaultSchedule:
    """Fault injection for the simulator AND the engine: a list of
    ``FaultEvent`` / ``OutageEvent`` (mixed freely), keyed by request
    index like ``DriftSchedule``.

    With no events attached the schedule is falsy and every consumer
    short-circuits — bit-for-bit the fault-free behavior (outcomes come
    from a counter hash, never the experiment rng, so even an ACTIVE
    schedule leaves the latency draw stream untouched)."""

    def __init__(self, events=(), seed: int = 0):
        self.events = tuple(events)
        self.seed = seed
        self.faults = tuple(e for e in self.events if isinstance(e, FaultEvent))
        self.outages = tuple(e for e in self.events if isinstance(e, OutageEvent))
        unknown = [
            e for e in self.events if not isinstance(e, (FaultEvent, OutageEvent))
        ]
        if unknown:
            raise TypeError(f"not FaultEvent/OutageEvent: {unknown!r}")
        self._salts: dict = {}

    def __bool__(self) -> bool:
        return bool(self.events)

    def _salt(self, step: str, platform: str) -> int:
        key = (step, platform)
        s = self._salts.get(key)
        if s is None:
            s = self._salts[key] = _node_salt(step, platform)
        return s

    # -- per-(cell, request-axis) composition ---------------------------------
    def p_error_arrays(self, ks: np.ndarray, step: str, platform: str) -> np.ndarray:
        """Composed per-attempt transient error probability over the
        request axis: overlapping events fail independently, so
        ``p = 1 - prod(1 - p_i)`` over the events covering each index."""
        ks = np.asarray(ks)
        ok = np.ones(ks.shape, dtype=np.float64)
        for e in self.faults:
            if e.platform != platform or (e.step and e.step != step):
                continue
            m = ks >= e.from_request
            if e.to_request is not None:
                m &= ks < e.to_request
            ok = np.where(m, ok * (1.0 - e.p_error), ok)
        return 1.0 - ok

    def outage_arrays(
        self, ks: np.ndarray, platform: str, region: str = ""
    ) -> np.ndarray:
        """Boolean outage mask over the request axis for one platform (a
        region-scoped event downs every platform in the region)."""
        ks = np.asarray(ks)
        out = np.zeros(ks.shape, dtype=bool)
        for e in self.outages:
            hit = (e.platform and e.platform == platform) or (
                e.region and region and e.region == region
            )
            if not hit:
                continue
            m = ks >= e.from_request
            if e.to_request is not None:
                m &= ks < e.to_request
            out |= m
        return out

    def plane(
        self,
        step: str,
        platform: str,
        ks,
        retry: Optional[RetryPolicy] = None,
        region: str = "",
    ) -> FaultPlane:
        """The fault plane for one (step, platform) node over a request
        axis — the ONLY pricing routine, shared verbatim by the scalar
        loop (1-element axis), the numpy pass, and the jax backend's
        host-side build, so all three agree bit-for-bit.

        Attempt ``a`` fails when the cell is in an outage window or its
        hash uniform falls under the composed transient probability; the
        failure streak stops at the first success. Each failed attempt
        with budget remaining adds its seeded backoff to ``extra_s``;
        exhausting the budget sets ``failed``."""
        ks = np.atleast_1d(np.asarray(ks, dtype=np.int64))
        n = len(ks)
        max_attempts = retry.max_attempts if retry is not None else 1
        if not self.events:
            return FaultPlane(
                np.zeros(n), np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool)
            )
        p = self.p_error_arrays(ks, step, platform)
        out = self.outage_arrays(ks, platform, region)
        salt = self._salt(step, platform)
        streak = np.ones(n, dtype=bool)  # attempts so far ALL failed
        n_fail = np.zeros(n, dtype=np.int64)
        extra = np.zeros(n)
        for a in range(max_attempts):
            u = hash_u01(self.seed, salt, a, _STREAM_FAIL, ks)
            fail_a = (out | (u < p)) & streak
            n_fail += fail_a
            if retry is not None and a < max_attempts - 1:
                backoff = retry.backoff_arrays(a, step, platform, ks)
                extra = np.where(fail_a, extra + backoff, extra)
            streak = fail_a
        return FaultPlane(extra, n_fail, streak)

    # -- the engine-side single-attempt check ---------------------------------
    def attempt_outcome(
        self, step: str, platform: str, request_k: int, attempt: int, region: str = ""
    ) -> Optional[str]:
        """Does attempt ``attempt`` of (step, platform) at request
        ``request_k`` fail? Returns ``"outage"`` / ``"transient"`` / None —
        the engine's ``FaultInjector`` raises on non-None. Evaluates the
        exact hash the simulator's plane uses, so sim and engine disagree
        about nothing."""
        if not self.events:
            return None
        ks = np.asarray([request_k], dtype=np.int64)
        if bool(self.outage_arrays(ks, platform, region)[0]):
            return "outage"
        p = float(self.p_error_arrays(ks, step, platform)[0])
        if p <= 0.0:
            return None
        u = float(hash_u01(self.seed, self._salt(step, platform), attempt,
                           _STREAM_FAIL, ks)[0])
        return "transient" if u < p else None


class InjectedFault(RuntimeError):
    """An injected failure (transient error or platform outage) raised by
    the engine's ``FaultInjector`` inside ``_run_node``."""

    def __init__(self, kind: str, step: str, platform: str, request_k: int,
                 attempt: int):
        self.kind = kind
        self.step = step
        self.platform = platform
        self.request_k = request_k
        self.attempt = attempt
        super().__init__(
            f"injected {kind} fault: {step}@{platform} request={request_k} "
            f"attempt={attempt}"
        )


def availability(totals: np.ndarray) -> float:
    """Fraction of requests that completed (finite totals) — failed
    requests are reported as ``inf`` by every simulator backend."""
    totals = np.asarray(totals)
    if totals.size == 0:
        return 1.0
    return float(np.isfinite(totals).mean())


def _chain_failed(plane_failed_by_node) -> np.ndarray:
    """Request failed iff ANY node exhausted its budget (every node in a
    DAG is an ancestor of some sink, so one dead node kills the request)."""
    failed = None
    for f in plane_failed_by_node:
        failed = f if failed is None else (failed | f)
    return failed if failed is not None else np.zeros(0, dtype=bool)


INF = math.inf
