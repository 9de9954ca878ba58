"""Online workflow recomposition: re-run the exact placement DP against
measured costs and hot-swap routes while requests are in flight.

This is the paper's ad-hoc recomposition claim made *online*. Because a
``DagSpec`` is immutable per-request data (not a deployment artifact),
re-placing a workflow is just publishing a new spec version — no redeploy,
no handler restart, and in-flight requests keep executing the spec they
captured at entry. Three pieces:

  ``RouteTable``             versioned holder of the active spec. ``swap``
                             publishes a new version atomically; readers
                             grab ``(version, spec)`` in one lock hop.
  ``RecompositionController`` the policy: every ``every_n`` completed
                             requests — or as soon as the observed cost of
                             the ACTIVE placement drifts past
                             ``drift_ratio`` x its cost when placed — pull
                             ``observed_costs`` from the telemetry hub and
                             re-run ``place_dag`` (the same exact DP static
                             placement uses; DFlow-style: invocation
                             decisions track observed state).
  ``AdaptiveDeployment``     wraps a ``DagDeployment``: wires the telemetry
                             hooks, runs every request on the current route
                             version, ticks the controller, and on a
                             placement change pre-warms the moved steps'
                             compile caches on their NEW platforms before
                             cutover — the swap lands warm.

The controller is engine-agnostic: it speaks ``DagSpec`` and placement
dicts, so the simulator benches (``benchmarks/adapt_bench.py``) drive the
identical decide loop against simulated telemetry.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from repro_torch.core.shipping import PlacementCosts, dag_cost, place_dag
from repro_torch.dag.spec import DagSpec

from repro_torch.adapt.costs import observed_costs, regions_of
from repro_torch.adapt.telemetry import TelemetryHub, attach


class RouteTable:
    """Versioned route publication. Requests capture ``(version, spec)``
    once at entry; ``swap`` never mutates a published spec (DagSpec is
    frozen), so in-flight requests finish on the routes they started with
    and the swap is atomic for new arrivals."""

    def __init__(self, spec: DagSpec, history_len: int = 64):
        self._lock = threading.Lock()
        self._version = 0
        self._spec = spec
        # recent published (version, spec) pairs — bounded: a long-lived
        # deployment swapping for days must not retain every old spec
        self.history = deque([(0, spec)], maxlen=history_len)

    def current(self) -> tuple:
        with self._lock:
            return self._version, self._spec

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    @property
    def spec(self) -> DagSpec:
        with self._lock:
            return self._spec

    def swap(self, new_spec: DagSpec) -> int:
        with self._lock:
            self._version += 1
            self._spec = new_spec
            self.history.append((self._version, new_spec))
            return self._version


class RecompositionController:
    """Decides WHEN to re-place and WHAT the new placement is.

    ``tick(spec)`` is called once per completed request with the currently
    active spec; it returns a placement dict ``{step: platform}`` when the
    DP found a strictly different placement, else None. Cheap per-tick work
    is one ``dag_cost`` evaluation (linear in the graph); the DP itself
    runs only on the every-N boundary or on a drift trigger.

    Hysteresis (both default off, so the bare controller is the PR-4 one):
    ``cooldown_requests`` suppresses every recompute for that many ticks
    after a swap, and ``min_improvement`` demands the proposed placement
    beat the active one by that fraction before swapping — together they
    stop an alternating drift from thrashing the route table. The
    improvement is judged on ``dag_cost`` point estimates, or — when a
    ``scorer`` (``adapt.scorer.PlacementScorer``) is given — on simulated
    latency *distributions* of both placements under the observed costs,
    compared at the scorer's quantile (a placement that only wins on the
    mean but loses the tail does not get swapped in).

    SLO trigger: with an ``obs.SloTracker`` wired (``slo=``), a burn-rate
    alert forces a recompute on the next tick — the user-facing objective
    can demand a re-placement even when mean costs have not drifted (tail
    degradation is invisible to the drift ratio). Latched on the
    tracker's ``alerts`` counter: one forced recompute per breach
    episode, not one per burning request, and the latch survives a
    cooldown window (the episode is handled when the recompute actually
    runs). Decision events carry ``trigger="slo"`` and the SLO name.

    Outage trigger (PR 10): the controller diffs the hub's error counts
    each tick; a cell with fresh failures whose error-rate EWMA is at or
    above ``outage_threshold`` is marked dead for ``outage_ttl`` ticks —
    while marked, ``observed_costs`` prices it ``inf`` so ``place_dag``
    must route around it, and if the ACTIVE placement sits on a dead cell
    a recompute fires immediately with ``trigger="outage"``. When a mark
    expires the controller forgets the cell's error history
    (``hub.reset_errors``) and forces one more recompute: an optimistic
    probe that fails back if the platform recovered — and re-marks within
    a few requests if it has not (fresh errors re-trip the threshold).
    Trigger precedence: slo > outage > drift > boundary. Detection and
    recovery land in the tracer ring as ``outage.detected`` /
    ``outage.cleared`` instants, next to ``recompose.decision``.
    """

    def __init__(
        self,
        hub: TelemetryHub,
        fallback: PlacementCosts,
        candidates: dict,
        regions: Optional[dict] = None,
        every_n: int = 16,
        drift_ratio: float = 1.5,
        min_samples: int = 2,
        prefetch: bool = True,
        cooldown_requests: int = 0,
        min_improvement: float = 0.0,
        scorer=None,
        tracer=None,
        slo=None,
        outage_threshold: float = 0.5,
        outage_ttl: int = 24,
    ):
        self.hub = hub
        self.fallback = fallback
        self.candidates = dict(candidates)
        self.regions = regions
        self.every_n = every_n
        self.drift_ratio = drift_ratio
        self.min_samples = min_samples
        self.prefetch = prefetch
        self.cooldown_requests = cooldown_requests
        self.min_improvement = min_improvement
        self.scorer = scorer
        self.outage_threshold = outage_threshold
        self.outage_ttl = outage_ttl
        self.slo = slo  # duck-typed obs.SloTracker (alerts counter + spec)
        # duck-typed obs.Tracer: every recompute decision (trigger, old/new
        # placement, predicted vs. current cost, outcome) lands in its
        # control-plane event ring — adapt behavior becomes auditable
        self.tracer = tracer
        self._lock = threading.Lock()
        self._n = 0
        self._cooldown_until = 0  # tick count before which recomputes pause
        self._placed_cost: Optional[float] = None  # active placement's cost
        #   under the observations that selected it (the drift reference)
        self._slo_handled = 0  # alerts count at the last slo-forced recompute
        self._outage_marks: dict = {}  # (step, platform) -> expiry tick
        self._err_seen: dict = {}  # (step, platform) -> error count last tick
        self.last_trigger: Optional[str] = None  # what caused the last swap
        self.stats = {
            "ticks": 0,
            "drift_triggers": 0,
            "slo_triggers": 0,
            "outage_triggers": 0,
            "recomputes": 0,
            "swaps": 0,
            "cooldown_skips": 0,
            "improvement_vetoes": 0,
        }

    def costs(self, outages=None) -> PlacementCosts:
        return observed_costs(
            self.hub, self.fallback, self.regions, self.min_samples, outages=outages
        )

    def outages(self) -> set:
        """The (step, platform) cells currently marked dead."""
        with self._lock:
            return set(self._outage_marks)

    def _update_outages(self, n: int) -> tuple:
        """Advance the outage state machine one tick. Returns ``(live,
        cleared)``: the set of cells currently marked dead, and whether any
        mark expired this tick (which forces a fail-back probe recompute).
        """
        counts = self.hub.error_counts()
        detected, cleared = [], []
        with self._lock:
            for cell, total in counts.items():
                fresh = total - self._err_seen.get(cell, 0)
                self._err_seen[cell] = total
                if fresh <= 0:
                    continue
                rate = self.hub.error_rate(*cell)
                if rate is not None and rate >= self.outage_threshold:
                    if cell not in self._outage_marks:
                        detected.append((cell, rate))
                    # fresh failures extend a live mark: the TTL counts
                    # from the LAST observed failure, not the first
                    self._outage_marks[cell] = n + self.outage_ttl
            for cell, until in list(self._outage_marks.items()):
                if until <= n:
                    del self._outage_marks[cell]
                    cleared.append(cell)
            live = set(self._outage_marks)
        for cell in cleared:
            # optimistic probe: drop the cell's failure history so the
            # recompute below can price it normally again; a still-dead
            # platform re-marks within a few requests
            self.hub.reset_errors(*cell)
        if self.tracer is not None:
            for (step, platform), rate in detected:
                self.tracer.record_event(
                    "outage.detected",
                    {
                        "step": step,
                        "platform": platform,
                        "error_rate": rate,
                        "tick": n,
                        "until_tick": n + self.outage_ttl,
                    },
                )
            for step, platform in cleared:
                self.tracer.record_event(
                    "outage.cleared", {"step": step, "platform": platform, "tick": n}
                )
        return live, bool(cleared)

    def tick(self, spec: DagSpec) -> Optional[dict]:
        with self._lock:
            self._n += 1
            n = self._n
            self.stats["ticks"] += 1
            placed_cost = self._placed_cost
            if n < self._cooldown_until:
                self.stats["cooldown_skips"] += 1
                return None
        nodes = {s.name: s for s in spec.steps}
        edges = list(spec.edges)
        placement = {s.name: s.platform for s in spec.steps}
        # a burn-rate alert since the last slo-forced recompute? (checked
        # after the cooldown gate, so the latch survives a cooldown and
        # fires on the first eligible tick)
        slo_fired = self.slo is not None and self.slo.alerts > self._slo_handled
        # outage state machine: dead cells price inf below; an active
        # placement sitting on one (or a mark expiring — the fail-back
        # probe) forces a recompute right now
        live_outages, outage_cleared = self._update_outages(n)
        outage_fired = outage_cleared or any(
            cell in live_outages for cell in placement.items()
        )
        costs = self.costs(outages=live_outages)
        current_cost = None
        drifted = False
        if placed_cost is not None:
            current_cost = dag_cost(nodes, edges, placement, costs, self.prefetch)
            drifted = current_cost > self.drift_ratio * placed_cost
        if (
            not slo_fired
            and not outage_fired
            and not drifted
            and n % self.every_n != 0
        ):
            return None
        with self._lock:
            if slo_fired:
                self.stats["slo_triggers"] += 1
                self._slo_handled = self.slo.alerts
            elif outage_fired:
                self.stats["outage_triggers"] += 1
            elif drifted:
                self.stats["drift_triggers"] += 1
            self.stats["recomputes"] += 1
        trigger = (
            "slo"
            if slo_fired
            else ("outage" if outage_fired else ("drift" if drifted else "boundary"))
        )
        new_placement = place_dag(nodes, edges, self.candidates, costs, self.prefetch)
        new_cost = dag_cost(nodes, edges, new_placement, costs, self.prefetch)
        if new_placement == placement:
            with self._lock:
                self._placed_cost = new_cost
            self._record(
                trigger, n, "no_change", placement, None, new_cost, current_cost
            )
            return None
        if current_cost is None:
            current_cost = dag_cost(nodes, edges, placement, costs, self.prefetch)
        if not self._improves(
            nodes, edges, new_placement, placement, new_cost, current_cost, costs
        ):
            # not worth the churn: keep the active placement, refresh the
            # drift reference so the same near-tie doesn't retrigger
            with self._lock:
                self.stats["improvement_vetoes"] += 1
                self._placed_cost = current_cost
            self._record(
                trigger, n, "veto", placement, new_placement, new_cost, current_cost
            )
            return None
        with self._lock:
            self._placed_cost = new_cost
            self.stats["swaps"] += 1
            self._cooldown_until = n + self.cooldown_requests
            self.last_trigger = trigger
        self._record(
            trigger, n, "swap", placement, new_placement, new_cost, current_cost
        )
        return new_placement

    def _record(
        self, trigger, n, outcome, placement, new_placement, new_cost, current_cost
    ):
        """Mirror one recompute decision into the tracer's event ring."""
        if self.tracer is None:
            return
        attrs = {
            "trigger": trigger,
            "tick": n,
            "outcome": outcome,
            "placement": dict(placement),
            "new_placement": dict(new_placement) if new_placement else None,
            "predicted_cost_s": new_cost,
            "current_cost_s": current_cost,
        }
        if trigger == "slo" and self.slo is not None:
            attrs["slo"] = self.slo.spec.name
        self.tracer.record_event("recompose.decision", attrs)

    def _improves(
        self, nodes, edges, new_placement, placement, new_cost, current_cost, costs
    ) -> bool:
        """Is ``new_placement`` enough better than the active one to swap?
        Point costs by default; simulated distributions when a scorer is
        wired (both placements under the same observed costs and common
        random numbers, compared at the scorer's quantile)."""
        if self.scorer is not None:
            q_new, q_cur = self.scorer.quantiles(
                nodes, edges, [new_placement, placement], costs, self.prefetch
            )
            return q_new < (1.0 - self.min_improvement) * q_cur
        return new_cost < (1.0 - self.min_improvement) * current_cost


class AdaptiveDeployment:
    """A ``DagDeployment`` that re-places itself against live telemetry.

    Wraps an existing deployment and ONE workflow spec (the workflow being
    served): every ``run(payload)`` executes on the current route version;
    after each request the controller ticks, and a placement change is cut
    over via ``RouteTable.swap`` — validated against the deployment's
    platform set, moved steps pre-warmed on their new platforms first.

    ``candidates`` maps step name -> list of platforms the step MAY move
    to; every candidate must actually have the step's function deployed
    (checked eagerly, so a recomposition can never route onto a platform
    that would 404).
    """

    def __init__(
        self,
        deployment,
        spec: DagSpec,
        candidates: dict,
        fallback_costs: PlacementCosts,
        hub: Optional[TelemetryHub] = None,
        every_n: int = 16,
        drift_ratio: float = 1.5,
        min_samples: int = 2,
        prewarm: bool = True,
        cooldown_requests: int = 0,
        min_improvement: float = 0.0,
        scorer=None,
        tracer=None,
        slo=None,
        outage_threshold: float = 0.5,
        outage_ttl: int = 24,
    ):
        self.deployment = deployment
        self.hub = attach(deployment, hub)
        self.tracer = tracer
        if tracer is not None:
            # same duck-typed hook pattern as telemetry.attach: request
            # traces come from the wrapped deployment, decision events from
            # the controller below
            from repro_torch.obs import instrument

            instrument(deployment, tracer)
        # duck-typed obs.SloTracker: fed every request's end-to-end latency
        # (wall clock, same clock the engine's spans use) so burn-rate
        # breaches can force a re-placement through the controller
        self.slo = slo
        if slo is not None and tracer is not None and slo.tracer is None:
            slo.tracer = tracer  # slo.burn lands in the same event ring
        self.prewarm = prewarm
        for step in spec.steps:  # fail fast: candidates must be deployed
            for platform in candidates.get(step.name, ()):
                fn = step.resolved_fn()
                if (fn, platform) not in deployment._functions:
                    raise ValueError(
                        f"candidate platform {platform!r} for step "
                        f"{step.name!r} has no deployment of {fn!r}"
                    )
        self.controller = RecompositionController(
            self.hub,
            fallback_costs,
            candidates,
            regions=regions_of(deployment.registry),
            every_n=every_n,
            drift_ratio=drift_ratio,
            min_samples=min_samples,
            cooldown_requests=cooldown_requests,
            min_improvement=min_improvement,
            scorer=scorer,
            tracer=tracer,
            slo=slo,
            outage_threshold=outage_threshold,
            outage_ttl=outage_ttl,
        )
        self.routes = RouteTable(spec)
        self._cut_lock = threading.Lock()
        self.swaps = deque(maxlen=256)  # bounded audit log of cutovers

    # -- client ----------------------------------------------------------------
    def run(self, payload, timeout_s: Optional[float] = 120.0):
        version, spec = self.routes.current()
        try:
            result = self.deployment.run(spec, payload, timeout_s)
        except BaseException:
            # a request that DIES is exactly when the outage trigger must
            # still get its tick: the engine already fed record_error, so
            # let the controller fail over before the error propagates —
            # otherwise a platform that kills every request could never be
            # routed around
            placement = self.controller.tick(self.routes.spec)
            if placement is not None:
                self._cutover(placement, trigger=self.controller.last_trigger)
            raise
        if self.slo is not None:
            self.slo.record(result.total_s, now=time.perf_counter())
        placement = self.controller.tick(self.routes.spec)
        if placement is not None:
            self._cutover(placement, trigger=self.controller.last_trigger)
        return result

    # -- cutover ---------------------------------------------------------------
    def _cutover(self, placement: dict, trigger: Optional[str] = None) -> int:
        """Publish a new route version: validate, pre-warm, swap."""
        with self._cut_lock:
            _, spec = self.routes.current()
            new_spec = spec.apply_placement(
                placement, platforms=self.deployment.registry.names()
            )
            moved = {
                s.name: (spec.node(s.name).platform, s.platform)
                for s in new_spec.steps
                if s.platform != spec.node(s.name).platform
            }
            if not moved:
                return self.routes.version
            if self.prewarm:
                for name, (_, platform) in moved.items():
                    step = new_spec.node(name)
                    fn = self.deployment._resolve(step.resolved_fn(), platform)
                    if fn.compile_fn is not None and fn.abstract_args is not None:
                        self.deployment.cache.warm(
                            fn.name, platform, fn.compile_fn, fn.abstract_args
                        )
            version = self.routes.swap(new_spec)
            # which SLO fired is part of the audit record: a cutover forced
            # by an objective breach must be attributable to that objective
            slo_name = (
                self.slo.spec.name
                if trigger == "slo" and self.slo is not None
                else None
            )
            self.swaps.append(
                {
                    "version": version,
                    "moved": moved,
                    "at": time.time(),
                    "trigger": trigger,
                    "slo": slo_name,
                }
            )
            if self.tracer is not None:
                self.tracer.record_event(
                    "recompose.cutover",
                    {
                        "version": version,
                        "moved": moved,
                        "trigger": trigger,
                        "slo": slo_name,
                    },
                )
            return version

    # -- reporting / lifecycle -------------------------------------------------
    def report(self) -> dict:
        out = self.deployment.report()
        out["adapt"] = {
            "route_version": self.routes.version,
            "swaps": list(self.swaps),
            "controller": dict(self.controller.stats),
        }
        if self.slo is not None:
            out["adapt"]["slo"] = self.slo.snapshot()
        return out

    def shutdown(self):
        self.deployment.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
