"""The port's ``obs`` on the port's REAL dataflow engine: end-to-end request
traces, critical-path attribution against the wall clock, concurrent-request
trace isolation through an ``AdaptiveDeployment(tracer=...)``, and
recomposition decisions and cutovers landing in the tracer's event ring.
These are the cases of ``tests/test_obs_system.py``, re-pointed at
``repro_torch``; where a case has a structural answer (node sets, path
order, event names) the JAX package's engine is run beside it and must give
the same one. Every platform runs on the CPU."""
import threading
import time

import pytest
import torch

import repro.core as jcore
import repro.adapt as jadapt
import repro.core.shipping as jship
import repro.dag as jdag
import repro.obs as RO
import repro_torch.adapt as tadapt
import repro_torch.core.shipping as tship
import repro_torch.obs as TO
from repro_torch.adapt import AdaptiveDeployment
from repro_torch.core import DataRef, Platform, PlatformRegistry
from repro_torch.core.prefetch import Prefetcher
from repro_torch.core.prewarm import TensorSpec
from repro_torch.core.shipping import PlacementCosts
from repro_torch.core.store import ObjectStore
from repro_torch.dag import DagDeployment, DagSpec, DagStep
from repro_torch.obs import MetricsRegistry, Tracer, extract_critical_path, instrument

CPU = "cpu"
JOIN_S = 30.0  # every client thread joins within this, so nothing can hang
# the diamond's handler sleeps, 4x the JAX package's test: the sink-to-client
# hand-off costs a thread wake-up, a few ms when test workers share the CPU,
# and the wall-clock bar below is 5% of the request
SLEEP = 4


def make_registry(C=None):
    if C is None:
        reg = PlatformRegistry()
        reg.register(Platform("edge", "eu", kind="edge", native_prefetch=True,
                              device=CPU))
        reg.register(Platform("pA", "us", kind="cloud", device=CPU))
        reg.register(Platform("pB", "us", kind="cloud", device=CPU))
        return reg
    reg = C.PlatformRegistry()
    reg.register(C.Platform("edge", "eu", kind="edge", native_prefetch=True))
    reg.register(C.Platform("pA", "us", kind="cloud"))
    reg.register(C.Platform("pB", "us", kind="cloud"))
    return reg


def diamond_spec(prefetch=True, D=None):
    Spec, Step = (DagSpec, DagStep) if D is None else (D.DagSpec, D.DagStep)
    Ref = DataRef if D is None else jcore.DataRef
    return Spec(
        (
            Step("src", "edge", prefetch=prefetch),
            Step("left", "pA", data_deps=(Ref("d/left", "us"),), prefetch=prefetch),
            Step("right", "pB", prefetch=prefetch),
            Step("sink", "pA", prefetch=prefetch),
        ),
        (("src", "left"), ("src", "right"), ("left", "sink"), ("right", "sink")),
        "diamond",
    )


def sleepy(dt):
    def handler(payload, data):
        time.sleep(dt)
        return payload

    return handler


def join_handler(payload, data):
    time.sleep(0.01 * SLEEP)
    return sum(payload.values())


def _deploy_diamond(dep, reference=False):
    dep.store.enforce_latency = True
    dep.store.network.set_link("eu", "us", 0.005, 100e6)
    dep.store.put("d/left", b"x" * 1000, region="us")
    dep.deploy("src", sleepy(0.01 * SLEEP), ["edge"])
    dep.deploy(
        "left",
        sleepy(0.03 * SLEEP),
        ["pA"],
        abstract_args=((4,),) if reference else (TensorSpec((4,), torch.float32, CPU),),
        compile_fn=lambda *a: time.sleep(0.002),
    )
    dep.deploy("right", sleepy(0.02 * SLEEP), ["pB"])
    dep.deploy("sink", join_handler, ["pA", "pB"])
    return dep


@pytest.fixture()
def traced_dag():
    tracer = Tracer(metrics=MetricsRegistry())
    dep = _deploy_diamond(DagDeployment(make_registry(), tracer=tracer))
    yield dep, tracer
    dep.shutdown()


def test_engine_trace_attribution_matches_wall_clock(traced_dag):
    dep, tracer = traced_dag
    dep.run(diamond_spec(), 1)  # warm
    tracer.clear()
    r = dep.run(diamond_spec(), 1)
    trace = tracer.last()
    assert trace is not None and trace.trace_id == trace.root.trace_id
    nodes = trace.node_spans()
    assert set(nodes) == {"src", "left", "right", "sink"}
    cp = extract_critical_path(trace)
    att = cp.attribution
    # acceptance bar: path + attribution explain end-to-end latency
    assert sum(att.values()) == pytest.approx(cp.total_s, rel=1e-9)
    assert cp.total_s == pytest.approx(r.total_s, rel=0.05)
    assert cp.nodes[0] == "src" and cp.nodes[-1] == "sink"
    assert att["compute"] > 0.03 * SLEEP  # at least src+branch+sink sleeps
    # the JAX package's engine and tracer on the same diamond: same spans
    ref_tracer = RO.Tracer()
    with _deploy_diamond(jdag.DagDeployment(make_registry(jcore), tracer=ref_tracer),
                         reference=True) as ref:
        ref.run(diamond_spec(D=jdag), 1)
        ref.run(diamond_spec(D=jdag), 1)
    ref_trace = ref_tracer.last()
    assert set(ref_trace.node_spans()) == set(nodes)
    assert sorted(s.kind for s in ref_trace.spans) == sorted(s.kind for s in trace.spans)
    ref_cp = RO.extract_critical_path(ref_trace)
    assert (ref_cp.nodes[0], ref_cp.nodes[-1]) == (cp.nodes[0], cp.nodes[-1])


def test_engine_component_events_attach_to_spans(traced_dag):
    dep, tracer = traced_dag
    dep.run(diamond_spec(), 1)
    names = {
        name
        for trace in tracer.traces()
        for span in trace.spans
        for _t, name, _a in span.events
    }
    # prefetch fired off the poke, payloads buffered through the store
    assert any(n.startswith("prefetch.") or n.startswith("fetch.") for n in names)
    assert "store.put" in names and "store.get" in names
    assert any(n.startswith("compile.") for n in names)
    # the pool-thread prefetch landed on the span of the node it serves
    left = [s for s in tracer.last().spans if s.attrs.get("node") == "left"
            and any(e[1] == "prefetch.done" for e in s.events)]
    assert left and left[0].kind == "poke"


def test_prefetch_pool_events_land_on_the_bound_span():
    """``Prefetcher.start`` captures the caller's bound span and rebinds it
    on the pool thread that runs the fetch and the device copy, so the
    ``prefetch.done`` event lands on that span, not on whatever the pool
    thread last had bound; a span bound on another thread meanwhile gets
    nothing."""
    store = ObjectStore()
    store.put("w", torch.arange(6.0), region="us")
    pf = Prefetcher(store)
    tracer = pf.tracer = Tracer()
    t = tracer.begin(t0=0.0)
    poke, other = t.span("poke:x", "poke", attrs={"node": "x"}), t.span("o", "poke")
    try:
        with tracer.bind(poke):
            futs = pf.start([DataRef("w", "us")], "us", device=CPU)
        with tracer.bind(other):
            data, _, _ = pf.join(futs)
    finally:
        pf.shutdown()
    assert torch.equal(data["w"], torch.arange(6.0))
    assert [e[1] for e in poke.events] == ["prefetch.start", "prefetch.done"]
    assert poke.events[1][2]["key"] == "w" and other.events == []


def test_engine_metrics_merged_into_report(traced_dag):
    dep, tracer = traced_dag
    dep.run(diamond_spec(), 1)
    metrics = dep.report()["metrics"]
    assert any(k.startswith("node_s/") for k in metrics)
    assert any(k.startswith("compute_s/") for k in metrics)
    # requests aggregate under ONE series, not one per request id
    assert metrics["request_s/all"]["count"] == 1
    assert not any(tracer.last().trace_id in k for k in metrics)


def test_timeline_payload_wait_and_transfer(traced_dag):
    dep, _ = traced_dag
    r = dep.run(diamond_spec(), 1)
    sink = r.timeline["sink"]
    assert set(sink["payload_wait_s"]) == {"left", "right"}
    assert all(v >= 0 for v in sink["payload_wait_s"].values())
    assert set(sink["transfer_s"]) <= {"left", "right"}
    assert all(v >= 0 for v in sink["transfer_s"].values())


# ---------------------------------------------------------------------------
# concurrent-request trace isolation
# ---------------------------------------------------------------------------
def fallback_costs():
    return PlacementCosts(
        fetch_s=lambda name, p, deps: 0.02 * len(deps),
        compute_s=lambda name, p: 0.02,
        transfer_s=lambda a, b, size: 0.0 if a == b else 0.01,
        payload_size=1000,
    )


def test_concurrent_requests_trace_isolation(traced_dag):
    dep, tracer = traced_dag
    adapt = AdaptiveDeployment(
        dep,
        diamond_spec(),
        {"sink": ["pA", "pB"]},
        fallback_costs(),
        every_n=4,
        tracer=tracer,
    )
    adapt.run(1)  # warm
    tracer.clear()
    n_threads, errs = 6, []

    def one():
        try:
            adapt.run(2)
        except BaseException as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=one) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"
    assert not errs
    traces = tracer.traces()
    assert len(traces) == n_threads
    assert len({t.trace_id for t in traces}) == n_threads
    for trace in traces:
        ids = {s.span_id for s in trace.spans} | {trace.root.span_id}
        for span in trace.spans:
            # purity: every span belongs to exactly this request ...
            assert span.trace_id == trace.trace_id
            # ... and parentage stays inside the trace (acyclic by ids)
            if span is not trace.root:
                assert span.parent_id in ids and span.parent_id != span.span_id
        assert set(trace.node_spans()) == {"src", "left", "right", "sink"}
        cp = extract_critical_path(trace)
        assert sum(cp.attribution.values()) == pytest.approx(cp.total_s, rel=1e-9)
        # under thread contention the walk must still explain most of the
        # request: generous bound, this is an isolation test not a timer
        assert cp.total_s == pytest.approx(trace.total_s, rel=0.35)


# ---------------------------------------------------------------------------
# recomposition decisions in the tracer event ring
# ---------------------------------------------------------------------------
def chain_spec(work_platform="pA", D=None):
    Spec, Step = (DagSpec, DagStep) if D is None else (D.DagSpec, D.DagStep)
    return Spec(
        (
            Step("ingest", "edge"),
            Step("work", work_platform),
            Step("deliver", "edge"),
        ),
        (("ingest", "work"), ("work", "deliver")),
        "t",
    )


def _decisions(adapt_pkg, ship_pkg, O, D=None):
    hub = adapt_pkg.TelemetryHub(alpha=1.0)
    tracer = O.Tracer()
    fb = ship_pkg.PlacementCosts(
        fetch_s=lambda name, p, deps: 0.0,
        compute_s=lambda name, p: {("work", "pA"): 0.1, ("work", "pB"): 0.2}.get(
            (name, p), 0.1
        ),
        transfer_s=lambda a, b, size: 0.0,
        payload_size=1000,
    )
    ctrl = adapt_pkg.RecompositionController(
        hub, fb, {"work": ["pA", "pB"]}, every_n=1, min_samples=1, tracer=tracer
    )
    first = ctrl.tick(chain_spec("pA", D))
    hub.record_compute("work", "pA", 5.0)  # degrade pA -> swap
    placement = ctrl.tick(chain_spec("pA", D))
    return first, placement, [a for _t, n, a in tracer.events
                              if n == "recompose.decision"]


def test_controller_logs_decisions_to_tracer():
    first, placement, decisions = _decisions(tadapt, tship, TO)
    assert first is None  # optimal: no_change
    assert placement["work"] == "pB"
    assert [d["outcome"] for d in decisions] == ["no_change", "swap"]
    swap = decisions[-1]
    assert swap["trigger"] in ("boundary", "drift")
    assert swap["new_placement"]["work"] == "pB"
    assert swap["predicted_cost_s"] < swap["current_cost_s"]
    ref = _decisions(jadapt, jship, RO, D=jdag)
    assert (first, placement) == ref[:2]
    assert [{k: d[k] for k in ("outcome", "trigger", "new_placement")}
            for d in decisions] == [
        {k: d[k] for k in ("outcome", "trigger", "new_placement")} for d in ref[2]]


def test_adaptive_deployment_records_cutover_events(traced_dag):
    dep, tracer = traced_dag
    # bias costs so the DP moves sink to pB on the first boundary
    fb = PlacementCosts(
        fetch_s=lambda name, p, deps: 0.0,
        compute_s=lambda name, p: 0.5 if (name, p) == ("sink", "pA") else 0.01,
        transfer_s=lambda a, b, size: 0.0,
        payload_size=1000,
    )
    adapt = AdaptiveDeployment(
        dep, diamond_spec(), {"sink": ["pA", "pB"]}, fb, every_n=2, tracer=tracer
    )
    for _ in range(4):
        adapt.run(1)
    assert adapt.routes.version >= 1
    names = [n for _t, n, _a in tracer.events]
    assert "recompose.decision" in names and "recompose.cutover" in names
    cut = [a for _t, n, a in tracer.events if n == "recompose.cutover"][0]
    assert cut["moved"]["sink"] == ("pA", "pB")
    # request traces kept flowing through the instrumented deployment
    assert len(tracer.traces()) >= 4


def test_instrument_wires_components():
    dep = DagDeployment(make_registry())
    tracer = instrument(dep)
    assert isinstance(tracer, Tracer)
    assert dep.tracer is tracer
    assert dep.cache.tracer is tracer
    assert dep.prefetcher.tracer is tracer
    assert dep.store.tracer is tracer
    mine = Tracer()
    assert instrument(dep, mine) is mine and dep.store.tracer is mine
    dep.shutdown()
