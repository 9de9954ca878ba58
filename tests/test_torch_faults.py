"""Fault injection across the port's sim/real split: draw-neutrality pins,
pricing agreement across the scalar, numpy and torch backends, retry and
backoff closed forms, telemetry error accounting, outage-aware costs, and
the controller's fail-over/fail-back state machine with its events in the
port's tracer. These are the cases of ``tests/test_faults.py``,
re-pointed: its jax-backend cases become torch cases on ``device="cpu"``,
and the torch backend's fault masks and prices are also held to the JAX
package's numpy backend."""
import math

import numpy as np
import pytest

import repro.core.faults as jfaults
import repro.core.simulator as J
import repro_torch.core.faults as tfaults
from repro_torch.adapt import RecompositionController, TelemetryHub, observed_costs
from repro_torch.core import simulator as S
from repro_torch.core.faults import (
    FaultEvent,
    FaultSchedule,
    OutageEvent,
    RetryPolicy,
    availability,
    hash_u01,
)
from repro_torch.core.shipping import PlacementCosts
from repro_torch.obs import Tracer

BACKENDS = ("scalar", "numpy", "torch")
CPU = "cpu"


def _fallback_costs(compute=None):
    compute = compute or {}
    return PlacementCosts(
        fetch_s=lambda name, p, deps: 0.25 * len(deps),
        compute_s=lambda name, p: compute.get((name, p), 0.1),
        transfer_s=lambda a, b, size: 0.0 if a == b else 0.5,
        payload_size=1.5e6,
    )


def _schedule(F=tfaults):
    return F.FaultSchedule(
        [
            F.FaultEvent("gcf", p_error=0.3, from_request=5, to_request=30),
            F.OutageEvent(from_request=10, to_request=20, platform="lambda-us-east-1"),
        ],
        seed=7,
    )


def _run(M, spec, backend, plats=None, seed=3):
    sim = M.WorkflowSimulator(plats or M.paper_platforms(), seed=seed)
    if backend == "torch":
        return np.asarray(sim.simulate(spec, backend="torch", device=CPU))
    return np.asarray(sim.simulate(spec, backend=backend))


# ---------------------------------------------------------------------------
# draw-neutrality: disabled faults are bit-for-bit the old behavior
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_schedule_is_draw_neutral(backend):
    steps = S.document_workflow_fig4()
    base = _run(S, S.ExperimentSpec(steps, n_requests=48), backend)
    neutral = _run(
        S,
        S.ExperimentSpec(steps, n_requests=48, faults=FaultSchedule(()), retry=None),
        backend,
    )
    assert np.array_equal(base, neutral)


@pytest.mark.parametrize("backend", BACKENDS)
def test_active_schedule_leaves_finite_pricing_untouched(backend):
    """Failed requests are priced as-if-completed and masked to inf AFTER
    the recurrence — so every finite total is bit-identical to the
    fault-free run (the fault plane with retry=None adds zero seconds)."""
    steps = S.document_workflow_fig4()
    base = _run(S, S.ExperimentSpec(steps, n_requests=48), backend)
    faulted = _run(
        S,
        S.ExperimentSpec(steps, n_requests=48, faults=_schedule(), retry=None),
        backend,
    )
    fin = np.isfinite(faulted)
    assert not fin.all()  # the outage window really failed someone
    assert np.array_equal(faulted[fin], base[fin])


def test_fault_masks_agree_across_backends():
    """Which requests die is a pure hash decision — every backend must
    agree exactly, the JAX package's numpy backend too, and the hard-outage
    window must kill its whole span."""
    steps = S.document_workflow_fig4()
    rp = RetryPolicy(max_attempts=3, backoff_base_s=0.05)
    outs = {
        b: _run(S, S.ExperimentSpec(steps, n_requests=48, faults=_schedule(),
                                    retry=rp), b)
        for b in BACKENDS
    }
    outs["reference"] = _run(J, J.ExperimentSpec(
        J.document_workflow_fig4(), n_requests=48, faults=_schedule(jfaults),
        retry=jfaults.RetryPolicy(max_attempts=3, backoff_base_s=0.05)), "numpy")
    ref = np.isinf(outs["scalar"])
    for b in ("numpy", "torch", "reference"):
        assert np.array_equal(ref, np.isinf(outs[b])), b
    assert ref[10:20].all()  # outage window: retries cannot save these
    assert not ref[:5].any()  # before any event fires


def _zero(M):
    steps = [
        M.SimStep(
            s.name,
            s.platform,
            compute=M.Dist(s.compute.median, 0.0),
            fetch=M.Dist(s.fetch.median, 0.0),
            prefetch=s.prefetch,
        )
        for s in M.document_workflow_fig4()
    ]
    plats = [
        M.SimPlatform(
            p.name,
            p.region,
            p.native_prefetch,
            p.allows_sync,
            M.Dist(p.cold_start.median, 0.0),
            p.keep_warm_s,
        )
        for p in M.paper_platforms()
    ]
    return steps, plats


def test_fault_pricing_agrees_across_backends_when_deterministic():
    """With every spread zeroed the backends run identical arithmetic, so
    fault-extended latencies (retry backoff included) must agree to float
    tolerance — the shared host-side plane is the single pricing source,
    and the JAX package's numpy backend prices the same."""
    steps, plats = _zero(S)
    rp = RetryPolicy(max_attempts=3, backoff_base_s=0.05)
    outs = {
        b: _run(S, S.ExperimentSpec(steps, n_requests=48, faults=_schedule(),
                                    retry=rp), b, plats)
        for b in BACKENDS
    }
    jsteps, jplats = _zero(J)
    outs["reference"] = _run(J, J.ExperimentSpec(
        jsteps, n_requests=48, faults=_schedule(jfaults),
        retry=jfaults.RetryPolicy(max_attempts=3, backoff_base_s=0.05)),
        "numpy", jplats)
    ref = np.isinf(outs["scalar"])
    fin = ~ref
    assert fin.any() and ref.any()
    for b in ("numpy", "torch", "reference"):
        assert np.array_equal(ref, np.isinf(outs[b])), b
        np.testing.assert_allclose(outs[b][fin], outs["scalar"][fin], rtol=1e-9)


def test_retry_extends_latency_by_the_seeded_backoff():
    """A request inside the outage window fails attempt after attempt;
    each non-final failure adds exactly RetryPolicy.backoff_s to the
    node's end time. Closed-form check against the plane."""
    fs = FaultSchedule([OutageEvent(0, 10, platform="p")], seed=3)
    rp = RetryPolicy(max_attempts=4, backoff_base_s=0.1, backoff_multiplier=2.0)
    plane = fs.plane("f", "p", np.arange(12), retry=rp)
    want = sum(rp.backoff_s(a, "f", "p", 4) for a in range(3))
    assert plane.extra_s[4] == pytest.approx(want)
    assert plane.n_failures[4] == 4 and bool(plane.failed[4])
    # outside the window: clean
    assert plane.extra_s[11] == 0.0 and not plane.failed[11]


def test_transient_retry_can_succeed_mid_streak():
    """With p<1 and a budget, some requests fail attempt 0 but succeed on
    a retry: n_failures>0, failed=False, extra_s>0."""
    fs = FaultSchedule([FaultEvent("p", p_error=0.5)], seed=11)
    rp = RetryPolicy(max_attempts=4, backoff_base_s=0.01)
    plane = fs.plane("f", "p", np.arange(400), retry=rp)
    saved = (plane.n_failures > 0) & ~plane.failed
    assert saved.any()
    assert (plane.extra_s[saved] > 0).all()
    # and the budget still loses sometimes at p=0.5^4
    assert plane.failed.mean() == pytest.approx(0.5**4, abs=0.05)


def test_outage_region_scoped_and_open_ended():
    fs = FaultSchedule([OutageEvent(3, None, region="eu")], seed=0)
    ks = np.arange(8)
    assert not fs.outage_arrays(ks, "p", region="us").any()
    eu = fs.outage_arrays(ks, "p", region="eu")
    assert not eu[:3].any() and eu[3:].all()


def test_hash_is_stable_and_attempt_outcome_matches_plane():
    """The engine's single-request check and the simulator's vector plane
    evaluate the same hash: a request the plane says failed attempt 0 must
    make attempt_outcome return non-None, and vice versa."""
    fs = FaultSchedule([FaultEvent("p", p_error=0.4)], seed=5)
    ks = np.arange(64)
    plane = fs.plane("f", "p", ks, retry=None)
    for k in range(64):
        kind = fs.attempt_outcome("f", "p", k, 0)
        assert (kind is not None) == bool(plane.n_failures[k]), k
    # determinism pin for the counter hash itself
    u = hash_u01(5, 123, 0, 0x51AB, np.arange(4))
    assert np.array_equal(u, hash_u01(5, 123, 0, 0x51AB, np.arange(4)))
    assert np.array_equal(u, jfaults.hash_u01(5, 123, 0, 0x51AB, np.arange(4)))
    assert ((0.0 <= u) & (u < 1.0)).all()


def test_availability_helper():
    assert availability(np.array([1.0, math.inf, 2.0, math.inf])) == 0.5
    assert availability(np.array([])) == 1.0


# ---------------------------------------------------------------------------
# telemetry error accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ("scalar", "numpy"))
def test_simulated_faults_feed_error_telemetry(backend):
    hub = TelemetryHub()
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=3, telemetry=hub)
    sim.simulate(
        S.ExperimentSpec(
            S.document_workflow_fig4(),
            n_requests=48,
            faults=_schedule(),
            retry=RetryPolicy(max_attempts=3, backoff_base_s=0.01),
        ),
        backend=backend,
    )
    snap = hub.snapshot()
    # the outage window (requests 10..20, 3 attempts each) left counts on
    # the lambda cells; the rate EWMA has decayed through the healthy tail
    # but must still be present and positive
    dead = [c for c in snap["errors"] if "lambda-us-east-1" in c]
    assert dead and all(snap["errors"][c] >= 10 for c in dead)
    assert all(snap["error_rate"][c] > 0 for c in dead)


def test_telemetry_is_unchanged_when_faults_off():
    def run(faults, retry):
        hub = TelemetryHub()
        sim = S.WorkflowSimulator(S.paper_platforms(), seed=3, telemetry=hub)
        sim.simulate(
            S.ExperimentSpec(
                S.document_workflow_fig4(), n_requests=24, faults=faults, retry=retry
            ),
            backend="numpy",
        )
        return hub.snapshot()

    a = run(None, None)
    b = run(FaultSchedule(()), None)
    assert a == b
    with pytest.raises(ValueError, match="telemetry"):  # the torch backend refuses
        S.WorkflowSimulator(S.paper_platforms(), seed=3,
                            telemetry=TelemetryHub()).simulate(
            S.ExperimentSpec(S.document_workflow_fig4(), n_requests=4), device=CPU)


def test_hub_error_rate_and_penalty_shape():
    hub = TelemetryHub(alpha=0.5)
    assert hub.error_rate("f", "p") is None
    assert hub.error_penalty_s("f", "p") is None  # no attempts at all
    hub.record_compute("f", "p", 2.0)  # one success
    assert hub.error_penalty_s("f", "p") == 0.0  # attempts seen, no errors
    hub.record_error("f", "p")
    r = hub.error_rate("f", "p")
    assert 0.0 < r < 1.0
    # expected extra attempts r/(1-r), each paying the compute EWMA
    assert hub.error_penalty_s("f", "p") == pytest.approx(r / (1 - r) * 2.0)
    assert hub.error_count("f", "p") == 1
    assert hub.error_counts() == {("f", "p"): 1}
    hub.reset_errors("f", "p")
    assert hub.error_rate("f", "p") is None  # history forgotten
    assert hub.error_count("f", "p") == 1  # audit count kept


def test_observed_costs_outage_is_infinite_and_flaky_is_penalized():
    hub = TelemetryHub(alpha=1.0)
    for _ in range(3):
        hub.record_compute("f", "p", 1.0)
    hub.record_error("f", "p", 1)
    costs = observed_costs(hub, _fallback_costs(), outages={("f", "q")})
    assert costs.compute_s("f", "q") == math.inf
    # flaky-but-alive: base EWMA (1.0) + error penalty > clean cell
    assert costs.compute_s("f", "p") > 1.0
    clean = observed_costs(hub, _fallback_costs(), errors=False)
    assert clean.compute_s("f", "p") == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# controller: outage trigger, fail-over, fail-back
# ---------------------------------------------------------------------------
def _controller(hub, tracer=None, **kw):
    from repro_torch.dag import DagSpec, DagStep  # local: spec-only, no engine

    spec = DagSpec(
        steps=(DagStep("f", "p"), DagStep("g", "r")), edges=(("f", "g"),)
    )
    ctl = RecompositionController(
        hub,
        # home platform p is strictly cheaper than the failover q — the
        # asymmetry that makes fail-back observable (p was placed for a
        # reason; a tie would leave the DP parked on q)
        _fallback_costs({("f", "q"): 0.2}),
        {"f": ["p", "q"]},
        every_n=10**9,  # boundary never fires: outage logic only
        tracer=tracer,
        **kw,
    )
    return ctl, spec


def test_controller_outage_failover_and_failback():
    hub = TelemetryHub(alpha=1.0)
    tracer = Tracer()
    ctl, spec = _controller(hub, tracer, outage_threshold=0.5, outage_ttl=3)
    # healthy ticks: nothing happens
    hub.record_compute("f", "p", 0.1)
    assert ctl.tick(spec) is None
    # platform p dies: errors flood in
    for _ in range(4):
        hub.record_error("f", "p")
    placement = ctl.tick(spec)
    assert placement is not None and placement["f"] == "q"
    assert ctl.stats["outage_triggers"] == 1
    assert ctl.last_trigger == "outage"
    assert ("f", "p") in ctl.outages()
    names = [e[1] for e in tracer.events]
    assert "outage.detected" in names
    decisions = [e for e in tracer.events if e[1] == "recompose.decision"]
    assert decisions and decisions[-1][2]["trigger"] == "outage"
    # swap applied: the active spec moved to q
    spec2 = spec.apply_placement(placement)
    # ttl ticks with no fresh errors -> mark expires, fail-back probe
    got = None
    for _ in range(5):
        got = ctl.tick(spec2)
        if got is not None:
            break
    assert got is not None and got["f"] == "p"  # failed back (p is cheap)
    assert ("f", "p") not in ctl.outages()
    assert hub.error_rate("f", "p") is None  # optimistic reset
    assert "outage.cleared" in [e[1] for e in tracer.events]


def test_controller_still_dead_platform_remarks_after_probe():
    hub = TelemetryHub(alpha=1.0)
    ctl, spec = _controller(hub, outage_threshold=0.5, outage_ttl=2)
    for _ in range(4):
        hub.record_error("f", "p")
    placement = ctl.tick(spec)
    assert placement["f"] == "q"
    spec2 = spec.apply_placement(placement)
    for _ in range(4):  # expire the mark (fail-back probe fires)
        if ctl.tick(spec2) is not None:
            break
    # the probe routed back onto p, which is still dead: fresh errors
    for _ in range(4):
        hub.record_error("f", "p")
    placement = ctl.tick(spec)
    assert placement is not None and placement["f"] == "q"
    assert ctl.stats["outage_triggers"] >= 2


def test_trigger_precedence_slo_beats_outage():
    class FakeSlo:
        alerts = 1

        class spec:
            name = "p99"

    hub = TelemetryHub(alpha=1.0)
    tracer = Tracer()
    ctl, spec = _controller(hub, tracer, outage_threshold=0.5, outage_ttl=3)
    ctl.slo = FakeSlo()
    for _ in range(4):
        hub.record_error("f", "p")
    ctl.tick(spec)
    decisions = [e for e in tracer.events if e[1] == "recompose.decision"]
    assert decisions[-1][2]["trigger"] == "slo"  # slo > outage
    assert ctl.stats["slo_triggers"] == 1 and ctl.stats["outage_triggers"] == 0
