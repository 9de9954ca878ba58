"""The port's ``adapt`` package: ``PlacementScorer(backend="torch")``
against the JAX package's numpy-backend scorer, the recomposition controller
gated on it, and ``AdaptiveDeployment`` over the port's own dataflow engine
(whose duck-typed telemetry hooks feed the hub), recovering from drift as in
``tests/test_adapt.py``'s real-engine cases. Everything runs on the CPU."""
import threading
import time

import numpy as np
import pytest
import torch

import repro.adapt as jadapt
import repro.core.shipping as jship
from repro_torch.adapt import (AdaptiveDeployment, PlacementScorer,
                               RecompositionController, TelemetryHub, attach)
from repro_torch.core import DataRef, Platform, PlatformRegistry
from repro_torch.core.prewarm import TensorSpec
from repro_torch.core.shipping import PlacementCosts
from repro_torch.dag import DagDeployment, DagSpec, DagStep
from repro_torch.kernels.cold_scan import cold_scan
from repro_torch.obs import Tracer

CPU = "cpu"


def fallback_costs(compute=None, transfer_cross=0.5, ship=None):
    compute = compute or {}
    return (ship.PlacementCosts if ship else PlacementCosts)(
        fetch_s=lambda name, p, deps: 0.25 * len(deps),
        compute_s=lambda name, p: compute.get((name, p), 0.1),
        transfer_s=lambda a, b, size: 0.0 if a == b else transfer_cross,
        payload_size=1.5e6,
    )


def chain_spec(work_platform="pA"):
    return DagSpec(
        (DagStep("ingest", "edge"), DagStep("work", work_platform),
         DagStep("deliver", "edge")),
        (("ingest", "work"), ("work", "deliver")),
        "t",
    )


PLACEMENTS = [
    {"ingest": "edge", "work": "pA", "deliver": "edge"},
    {"ingest": "edge", "work": "pB", "deliver": "edge"},
    {"ingest": "pA", "work": "pB", "deliver": "edge"},
    {"ingest": "edge", "work": "pA", "deliver": "pB"},
]


# ---------------------------------------------------------------------------
# the scorer's torch backend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quantile", [0.5, 0.9, 0.95])
def test_torch_scorer_quantiles_within_1pct_of_numpy(quantile):
    """One torch sweep over the candidate set (f32) against the JAX
    package's scorer running one numpy experiment per candidate. Different
    draws, same distributions: 5 seeds x 4000 requests per placement put
    the standard error of the p95 gap near 0.25%, so 1% is about 4 of them."""
    compute = {("work", "pA"): 1.0, ("work", "pB"): 0.3}
    nodes = {s.name: s for s in chain_spec().steps}
    edges = list(chain_spec().edges)
    kw = dict(n_requests=4000, quantile=quantile, seeds=range(5))
    want = jadapt.PlacementScorer(backend="numpy", **kw).quantiles(
        nodes, edges, PLACEMENTS,
        fallback_costs(compute, 0.05, ship=jship))
    cold_scan.launches = 0
    got = PlacementScorer(backend="torch", device=CPU, **kw).quantiles(
        nodes, edges, PLACEMENTS, fallback_costs(compute, 0.05))
    assert cold_scan.launches == 0  # the CPU sweep runs the plain version
    assert got == pytest.approx(want, rel=0.01)
    assert np.argsort(got).tolist() == np.argsort(want).tolist()


def test_torch_scorer_shape_determinism_and_score():
    nodes = {s.name: s for s in chain_spec().steps}
    edges = list(chain_spec().edges)
    fb = fallback_costs({("work", "pA"): 1.0, ("work", "pB"): 0.3}, 0.05)
    scorer = PlacementScorer(n_requests=64, seed=9, backend="torch", device=CPU)
    a = scorer.distributions(nodes, edges, PLACEMENTS[:2], fb)
    assert a.shape == (2, 64) and a.dtype == np.float32
    assert np.array_equal(a, scorer.distributions(nodes, edges, PLACEMENTS[:2], fb))
    q_a, q_b = scorer.quantiles(nodes, edges, PLACEMENTS[:2], fb)
    assert q_b < q_a
    stats = scorer.score(nodes, edges, PLACEMENTS[0], fb)
    assert stats["median_s"] <= stats["p95_s"] <= stats["p99_s"]


def test_torch_scorer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes = {s.name: s for s in chain_spec().steps}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PlacementScorer(backend="torch").quantiles(
            nodes, list(chain_spec().edges), PLACEMENTS[:2], fallback_costs())


def test_scorer_with_no_arguments_runs_on_the_card(monkeypatch):
    """The default backend is the torch sweep on the card: with no CUDA it
    raises, and launches nothing, instead of scoring on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scorer = PlacementScorer()
    assert (scorer.backend, scorer.device) == ("torch", "cuda")
    nodes = {s.name: s for s in chain_spec().steps}
    cold_scan.launches = 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scorer.quantiles(nodes, list(chain_spec().edges), PLACEMENTS[:2],
                         fallback_costs())
    assert cold_scan.launches == 0


def test_controller_with_torch_scorer_swaps_on_distribution_win():
    hub = TelemetryHub(alpha=1.0)
    fb = fallback_costs({("work", "pA"): 0.1, ("work", "pB"): 0.2}, 0.05)
    ctrl = RecompositionController(
        hub, fb, {"work": ["pA", "pB"]}, every_n=1, min_samples=1,
        scorer=PlacementScorer(n_requests=128, backend="torch", device=CPU))
    for _ in range(2):
        hub.record_compute("work", "pA", 4.0)  # pA degrades hard
    placement = ctrl.tick(chain_spec("pA"))
    assert placement is not None and placement["work"] == "pB"


def test_controller_with_torch_scorer_vetoes_distribution_tie():
    hub = TelemetryHub(alpha=1.0)
    fb = fallback_costs({("work", "pA"): 0.21, ("work", "pB"): 0.2}, 0.05)
    ctrl = RecompositionController(
        hub, fb, {"work": ["pA", "pB"]}, every_n=1, min_samples=1,
        scorer=PlacementScorer(n_requests=128, sigma=0.4, backend="torch",
                               device=CPU),
        min_improvement=0.2)
    assert ctrl.tick(chain_spec("pA")) is None
    assert ctrl.stats["improvement_vetoes"] == 1


# ---------------------------------------------------------------------------
# AdaptiveDeployment on the port's engine
# ---------------------------------------------------------------------------
def make_registry():
    reg = PlatformRegistry()
    reg.register(Platform("edge", "edge", kind="edge", native_prefetch=True,
                          device=CPU))
    reg.register(Platform("pA", "region-a", kind="cloud", device=CPU))
    reg.register(Platform("pB", "region-b", kind="cloud", device=CPU))
    return reg


def platform_of_current_thread():
    name = threading.current_thread().name
    return name.split("plat-")[1].rsplit("_", 1)[0] if "plat-" in name else name


def deploy_chain(engine, ran_on, work=None):
    def passthrough(p, d):
        return p

    def default_work(p, d):
        ran_on.append(platform_of_current_thread())
        return p * 2

    engine.deploy("ingest", passthrough, ["edge"])
    engine.deploy("work", work or default_work, ["pA", "pB"])
    engine.deploy("deliver", passthrough, ["edge"])
    return engine


def test_adaptive_deployment_rejects_undeployed_candidates():
    with deploy_chain(DagDeployment(make_registry()), []) as engine:
        with pytest.raises(ValueError, match="'pC'"):
            AdaptiveDeployment(engine, chain_spec(), {"work": ["pA", "pC"]},
                               fallback_costs())


def test_adaptive_deployment_tracer_is_not_ported():
    """A tracer given to ``AdaptiveDeployment`` is instrumented into the
    wrapped deployment's engine, compile cache, prefetcher and store, as
    ``repro.obs.instrument`` does in the JAX package (the name dates from
    before ``obs`` was ported, when this raised); requests then leave
    traces with every node."""
    tracer = Tracer()
    with deploy_chain(DagDeployment(make_registry()), []) as engine:
        adapt = AdaptiveDeployment(engine, chain_spec(), {"work": ["pA", "pB"]},
                                   fallback_costs(), tracer=tracer)
        assert adapt.tracer is tracer and adapt.controller.tracer is tracer
        for part in (engine, engine.cache, engine.prefetcher, engine.store):
            assert part.tracer is tracer
        assert adapt.run(3).outputs == 6
    assert set(tracer.last().node_spans()) == {"ingest", "work", "deliver"}


@pytest.mark.parametrize("scored", [False, True])
def test_adaptive_deployment_swaps_and_serves(scored):
    """Degrade pA mid-stream: the engine's telemetry hooks show the drift,
    the controller swaps the route to pB (with the torch scorer's gate when
    ``scored``), and every request returns the right answer."""
    ran_on = []
    slow = {"scale": 1.0}

    def work(p, d):
        plat = platform_of_current_thread()
        ran_on.append(plat)
        time.sleep(0.02 * slow["scale"] if plat == "pA" else 0.03)
        return p * 2

    fb = fallback_costs({("work", "pA"): 0.02, ("work", "pB"): 0.03}, 0.05)
    scorer = (PlacementScorer(n_requests=128, quantile=0.9, backend="torch",
                              device=CPU) if scored else None)
    with deploy_chain(DagDeployment(make_registry()), ran_on, work) as engine:
        adapt = AdaptiveDeployment(engine, chain_spec(), {"work": ["pA", "pB"]},
                                   fb, every_n=4, drift_ratio=1.5, min_samples=2,
                                   scorer=scorer)
        outs = [adapt.run(k).outputs for k in range(6)]
        slow["scale"] = 20.0
        outs += [adapt.run(k).outputs for k in range(6, 16)]
        assert outs == [k * 2 for k in range(16)]  # nothing dropped, ever
        assert adapt.routes.version >= 1
        assert adapt.swaps[0]["moved"]["work"] == ("pA", "pB")
        assert ran_on[0] == "pA" and ran_on[-1] == "pB"
        report = adapt.report()
        assert report["adapt"]["route_version"] == adapt.routes.version
        assert report["adapt"]["controller"]["swaps"] >= 1
        assert "work@pA" in report["telemetry"]["compute_s"]


def test_in_flight_request_survives_cutover():
    """A request that entered on route v0 finishes on v0's platform while
    the table swaps to v1 underneath it."""
    ran_on = []
    started, release = threading.Event(), threading.Event()

    def work(p, d):
        ran_on.append(platform_of_current_thread())
        started.set()
        assert release.wait(5.0)
        return p * 2

    with deploy_chain(DagDeployment(make_registry()), ran_on, work) as engine:
        adapt = AdaptiveDeployment(engine, chain_spec(), {"work": ["pA", "pB"]},
                                   fallback_costs())
        results = []
        t = threading.Thread(target=lambda: results.append(adapt.run(21)))
        t.start()
        assert started.wait(5.0)
        assert adapt._cutover({"work": "pB"}) == 1  # hot-swap mid-flight
        release.set()
        t.join(5.0)
        assert results and results[0].outputs == 42
        assert ran_on == ["pA"]  # the in-flight request kept its route
        assert adapt.run(5).outputs == 10
        assert ran_on[-1] == "pB"  # new arrivals take the new route


def test_cutover_prewarms_moved_step():
    """The moved step's cold start runs on the NEW platform before the
    swap is published (the cutover lands warm)."""
    abstract = (TensorSpec((4,), torch.float32, CPU),)
    with DagDeployment(make_registry()) as engine:
        engine.deploy("ingest", lambda p, d: p, ["edge"])
        engine.deploy("work", lambda p, d: p * 2, ["pA", "pB"],
                      abstract_args=abstract, compile_fn=lambda x: x * 2)
        engine.deploy("deliver", lambda p, d: p, ["edge"])
        adapt = AdaptiveDeployment(engine, chain_spec(), {"work": ["pA", "pB"]},
                                   fallback_costs())
        adapt.run(1)
        assert not engine.cache.is_warm("work", "pB", abstract)
        adapt._cutover({"work": "pB"})
        deadline = time.time() + 5.0
        while not engine.cache.is_warm("work", "pB", abstract):
            assert time.time() < deadline, "prewarm never landed"
            time.sleep(0.01)
        assert adapt.routes.spec.node("work").platform == "pB"


def test_cutover_validates_against_deployment_platform_set():
    with deploy_chain(DagDeployment(make_registry()), []) as engine:
        adapt = AdaptiveDeployment(engine, chain_spec(), {"work": ["pA", "pB"]},
                                   fallback_costs())
        with pytest.raises(ValueError, match="unknown platform"):
            adapt._cutover({"work": "nowhere"})


def test_engine_telemetry_hooks_feed_the_hub():
    """The hooks the port's engine kept duck-typed (compute, fetch,
    transfer) land in the hub once ``attach`` wires it."""
    with deploy_chain(DagDeployment(make_registry()), []) as engine:
        hub = attach(engine)
        engine.store.put("k", np.ones(8), region="region-a")
        spec = DagSpec(
            (DagStep("ingest", "edge"),
             DagStep("work", "pA", data_deps=(DataRef("k", "region-a"),)),
             DagStep("deliver", "edge")),
            (("ingest", "work"), ("work", "deliver")))
        for k in range(3):
            engine.run(spec, k)
        report = engine.report()
    assert hub.compute_s("work", "pA") is not None
    tel = report["telemetry"]
    assert "work@pA" in tel["compute_s"]
    assert "k@region-a" in tel["fetch_s"]
    assert any("region-a" in k for k in tel["transfer_s"])
