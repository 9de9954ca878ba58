"""The port's choreography middleware, chain facade and federated system
against the JAX package's: the reference's ``tests/test_choreography.py``,
the engine cases of ``tests/test_unified_core.py`` (the chain facade is
the dataflow engine) and ``tests/test_system.py`` re-pointed. Each test
runs the same handlers and inputs (numpy, from seeds) through both
packages' ``Deployment`` (the port's platforms on ``device="cpu"``) and
compares outputs, timelines' keys and counters; the timing bars (prefetch
hides latency, the wrapper's < 1 ms) are the reference's, held on both.

The system cases run the smoke qwen3-1.7b: the reference's params
(``init_params``, key 0) carried into the port with ``params_from_jax``."""
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dag as jdag
import repro_torch.core as tcore
import repro_torch.dag as tdag
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import model as JM
from repro_torch.configs.registry import smoke_config
from repro_torch.core.prewarm import TensorSpec
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax

PKGS = {
    "jax": SimpleNamespace(core=jcore, dag=jdag, plat={}),
    "torch": SimpleNamespace(core=tcore, dag=tdag, plat={"device": "cpu"}),
}
TIMELINE_KEYS = {"warm_s", "fetch_s", "compute_s", "payload_wait_s", "transfer_s"}


def both(fn):
    return {name: fn(pkg) for name, pkg in PKGS.items()}


def make_registry(pkg):
    c = pkg.core
    reg = c.PlatformRegistry()
    reg.register(c.Platform("edge-eu", "eu", kind="edge", native_prefetch=True,
                            **pkg.plat))
    reg.register(c.Platform("cloud-us", "us", kind="cloud", **pkg.plat))
    return reg


def make_dep(pkg, enforce=True):
    dep = pkg.core.Deployment(make_registry(pkg))
    dep.store.enforce_latency = enforce
    dep.store.network.set_link("eu", "us", 0.05, 5e6)
    return dep


def slow_handler(duration):
    def h(payload, data):
        time.sleep(duration)
        return payload
    return h


def consume_handler(payload, data):
    # touches its prefetched dependency
    assert "dep" in data
    return float(np.sum(data["dep"])) + (payload or 0.0)


def prefetch_specs(pkg):
    c = pkg.core
    deps = (c.DataRef("dep", "eu"),)
    on = c.WorkflowSpec((c.StepSpec("a", "edge-eu"),
                         c.StepSpec("b", "cloud-us", data_deps=deps)))
    off = c.WorkflowSpec((c.StepSpec("a", "edge-eu", prefetch=False),
                          c.StepSpec("b", "cloud-us", data_deps=deps, prefetch=False)))
    return on, off


# -- tests/test_choreography.py, re-pointed --------------------------------------
def test_prefetch_hides_data_latency():
    """Data lives far from step b: with pre-fetching the fetch overlaps step
    a's compute, without it the fetch is serial (the reference's bar)."""
    def run(pkg):
        dep = make_dep(pkg)
        dep.store.put("dep", np.ones(int(2e6 // 8)), region="eu")  # 2 MB in eu
        dep.deploy("a", slow_handler(0.5), ["edge-eu"])
        dep.deploy("b", consume_handler, ["cloud-us"])
        wf_pf, wf_np = prefetch_specs(pkg)
        dep.run(wf_pf, 1.0)  # warm both paths once
        dep.run(wf_np, 1.0)
        t_pf = min(dep.run(wf_pf, 1.0).total_s for _ in range(2))
        t_np = min(dep.run(wf_np, 1.0).total_s for _ in range(2))
        stats = {k: dep.prefetcher.stats[k] for k in ("prefetched", "cold_fetches")}
        dep.shutdown()
        return t_pf, t_np, stats

    got = both(run)
    # fetch ~0.43 s (2 MB at 5 MB/s + rtt); step a runs 0.5 s: hidden
    for name, (t_pf, t_np, _) in got.items():
        assert t_pf < t_np - 0.2, (name, t_pf, t_np)
    assert got["torch"][2] == got["jax"][2] == {"prefetched": 3, "cold_fetches": 3}


def test_results_identical_with_and_without_prefetch():
    dep_value = np.random.default_rng(0).normal(size=100)

    def run(pkg):
        with make_dep(pkg, enforce=False) as dep:
            dep.store.put("dep", dep_value, region="eu")
            dep.deploy("a", lambda p, d: p * 2, ["edge-eu"])
            dep.deploy("b", consume_handler, ["cloud-us"])
            wf_pf, wf_np = prefetch_specs(pkg)
            return dep.run(wf_pf, 3.0).outputs, dep.run(wf_np, 3.0).outputs

    got = both(run)
    for name, (r1, r2) in got.items():
        assert r1 == pytest.approx(r2), name
    assert got["torch"] == got["jax"]


def test_prewarm_hides_compile():
    """With a compile_fn registered the poke pre-compiles (a prewarm, never
    a cold miss), partly hidden behind step a's 0.3 s; the second request
    is fully warm. The port's compile is one call of ``stepfn`` on zeros of
    its ``TensorSpec``, the reference's a jit."""
    x = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)

    def jstep(v):
        return jnp.tanh(v @ v.T).sum()

    def tstep(v):
        return torch.tanh(v @ v.T).sum()

    cases = {"jax": (jstep, (jax.ShapeDtypeStruct((64, 64), jnp.float32),),
                     lambda p, d: float(jstep(jnp.asarray(p)))),
             "torch": (tstep, (TensorSpec((64, 64), torch.float32, "cpu"),),
                       lambda p, d: float(tstep(torch.as_tensor(p))))}

    def run(name):
        pkg = PKGS[name]
        c = pkg.core
        step, abstract, handler = cases[name]
        with make_dep(pkg, enforce=False) as dep:
            dep.deploy("a", slow_handler(0.3), ["edge-eu"])
            dep.deploy("b", handler, ["cloud-us"], abstract_args=abstract,
                       compile_fn=step)
            wf = c.WorkflowSpec((c.StepSpec("a", "edge-eu"),
                                 c.StepSpec("b", "cloud-us")))
            r1 = dep.run(wf, x)
            stats = dict(dep.cache.stats)
            r2 = dep.run(wf, x)
        return r1, r2, stats

    got = {name: run(name) for name in PKGS}
    for name, (r1, r2, st) in got.items():
        assert st["prewarms"] >= 1 and st["misses"] == 0, name
        assert st["hidden_compile_s"] > 0, name
        assert r1.timeline["b"]["warm_s"] < st["hidden_compile_s"] + 0.3, name
        assert r2.timeline["b"]["warm_s"] < 0.05, name
    assert got["torch"][0].outputs == pytest.approx(got["jax"][0].outputs, rel=1e-5)


def test_wrapper_overhead_below_1ms():
    """Paper §4.1: the platform wrapper adds < 1 ms a call, in both packages,
    on a CPU platform (``chip_smoke.py`` phase 15 times the port's on a
    CUDA platform)."""
    from repro.core.platform import PlatformWrapper as JWrapper
    from repro_torch.core import platform as tplatform
    wrappers = {"jax": JWrapper(jcore.Platform("edge-eu", "eu"), lambda p, d: p,
                                "noop"),
                "torch": tplatform.PlatformWrapper(
                    tplatform.Platform("edge-eu", "eu", device="cpu"),
                    lambda p, d: p, "noop")}
    for name, w in wrappers.items():
        for _ in range(200):
            assert w(1, {}) == 1
        assert w.calls == 200
        assert w.overhead_s / w.calls < 1e-3, (name, w.overhead_s / w.calls)


@pytest.mark.parametrize("device,entered", [("cpu", []), ("cuda", ["cuda"]),
                                            ("cuda:0", ["cuda:0"])])
def test_wrapper_enters_the_platform_device(device, entered, monkeypatch):
    """The port's wrapper runs the step inside ``torch.cuda.device`` of a
    CUDA platform, and inside no device context on a CPU one."""
    from repro_torch.core import platform as tplatform
    log = []

    class Recorder:
        def __init__(self, dev):
            self.dev = str(dev)

        def __enter__(self):
            log.append(self.dev)

        def __exit__(self, *a):
            log.append("exit")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device", Recorder)
    w = tplatform.PlatformWrapper(tplatform.Platform("edge-eu", "eu", device=device),
                                  lambda p, d: log.append("step") or p, "noop")
    assert w(1, {}) == 1
    assert log == (entered + ["step", "exit"] if entered else ["step"])


def test_adhoc_recomposition_no_redeploy():
    """The same deployment serves a rerouted spec without redeploying."""
    def run(pkg):
        c = pkg.core
        with make_dep(pkg, enforce=False) as dep:
            dep.deploy("a", lambda p, d: p + 1, ["edge-eu", "cloud-us"])
            dep.deploy("b", lambda p, d: p * 10, ["edge-eu", "cloud-us"])
            wf = c.WorkflowSpec((c.StepSpec("a", "edge-eu"),
                                 c.StepSpec("b", "cloud-us")))
            r1 = dep.run(wf, 1)
            r2 = dep.run(wf.reroute("b", "edge-eu"), 1)
            return r1.outputs, r2.outputs, sorted(r2.timeline), len(dep._functions)

    got = both(run)
    assert got["torch"] == got["jax"] == (20, 20, ["a", "b"], 4)


def test_missing_deployment_raises():
    def run(pkg):
        c = pkg.core
        with make_dep(pkg, enforce=False) as dep:
            dep.deploy("a", lambda p, d: p, ["edge-eu"])
            with pytest.raises(KeyError) as e:
                dep.run(c.WorkflowSpec((c.StepSpec("a", "cloud-us"),)), 0)
            return str(e.value)

    got = both(run)
    assert got["torch"] == got["jax"]


# -- tests/test_unified_core.py (engine cases), re-pointed ------------------------
W = np.random.default_rng(3).normal(size=32)


def deploy_handlers(dep):
    dep.deploy("a", lambda p, d: p + 1, ["edge-eu"])
    dep.deploy("b", lambda p, d: float(np.sum(d["w"])) * p, ["cloud-us"])
    dep.deploy("c", lambda p, d: p * 10, ["cloud-us"])
    dep.store.put("w", W, region="eu")
    return dep


def chain_spec(pkg):
    c = pkg.core
    return c.WorkflowSpec((c.StepSpec("a", "edge-eu"),
                           c.StepSpec("b", "cloud-us",
                                      data_deps=(c.DataRef("w", "eu"),)),
                           c.StepSpec("c", "cloud-us")), "parity")


def test_chain_facade_is_the_dataflow_engine():
    """``Deployment`` is a ``DagDeployment`` in both packages: the chain
    stack carries no poke/payload loop of its own."""
    import repro.core.choreographer as jchore
    import repro_torch.core.choreographer as tchore
    from repro.dag.engine import DagDeployment as JEngine
    from repro_torch.dag.engine import DagDeployment as TEngine
    for Dep, Engine, chore in ((jcore.Deployment, JEngine, jchore),
                               (tcore.Deployment, TEngine, tchore)):
        assert issubclass(Dep, Engine)
        assert Dep.deploy is Engine.deploy and Dep.shutdown is Engine.shutdown
        assert "_run_node" not in Dep.__dict__
        assert not hasattr(chore, "Middleware")
    assert set(tcore.Deployment.__dict__) == set(jcore.Deployment.__dict__)


def test_chain_api_matches_explicit_from_chain_run():
    """Equal outputs and timeline keys through both APIs and packages."""
    def run(pkg):
        with deploy_handlers(pkg.core.Deployment(make_registry(pkg))) as chain:
            r_chain = chain.run(chain_spec(pkg), 2.0)
        with deploy_handlers(pkg.dag.DagDeployment(make_registry(pkg))) as dag:
            r_dag = dag.run(pkg.dag.DagSpec.from_chain(chain_spec(pkg)), 2.0)
        return r_chain, r_dag

    got = both(run)
    for name, (r_chain, r_dag) in got.items():
        assert r_chain.outputs == pytest.approx(r_dag.outputs), name
        assert set(r_chain.timeline) == set(r_dag.timeline) == {"a", "b", "c"}
        for step in r_chain.timeline:
            assert set(r_chain.timeline[step]) == TIMELINE_KEYS
            assert set(r_dag.timeline[step]) == TIMELINE_KEYS
    assert got["torch"][0].outputs == got["jax"][0].outputs
    assert got["torch"][1].outputs == got["jax"][1].outputs


def test_chain_facade_records_per_edge_slack():
    """A poked chain hop with data deps shows as an (a -> b) edge in the
    timing report, with slack, in both packages."""
    def run(pkg):
        with deploy_handlers(pkg.core.Deployment(make_registry(pkg))) as dep:
            dep.deploy("a", lambda p, d: time.sleep(0.15) or p + 1, ["edge-eu"])
            for _ in range(3):  # the poke lands before b fires: a dwells
                dep.run(chain_spec(pkg), 1.0)
            return dep.timing.report()["edges"]

    got = both(run)
    for name, edges in got.items():
        assert "a->b" in edges, name
        assert edges["a->b"]["slack_s"] != 0.0, name
    assert set(got["torch"]) == set(got["jax"])
    assert set(got["torch"]["a->b"]) == set(got["jax"]["a->b"])


def test_deployment_context_manager_idempotent_shutdown():
    def run(pkg):
        c = pkg.core
        dep = c.Deployment(make_registry(pkg))
        with dep as d:
            assert d is dep
            d.deploy("a", lambda p, d_: p, ["edge-eu"])
            out = d.run(c.WorkflowSpec((c.StepSpec("a", "edge-eu"),)), 7).outputs
        dep.shutdown()  # a second shutdown after __exit__ is a no-op
        return out, dep._shut

    got = both(run)
    assert got["torch"] == got["jax"] == (7, True)


def test_engine_cascade_consults_per_edge_delay():
    """The poke cascade consults the learned delay for every edge it
    crosses, in both packages."""
    def run(pkg):
        calls = []
        with deploy_handlers(pkg.core.Deployment(make_registry(pkg))) as dep:
            dep.timing.poke_delay = lambda p, s: calls.append((p, s)) or 0.0
            dep.run(chain_spec(pkg), 1.0)
        return {("a", "b"), ("b", "c")} <= set(calls)

    assert both(run) == {"jax": True, "torch": True}


def test_chain_invoking_same_function_twice_still_runs():
    """Repeated names lift to unique ``f@i`` nodes whose ``fn`` points back
    at the deployed function."""
    def run(pkg):
        c = pkg.core
        with c.Deployment(make_registry(pkg)) as dep:
            dep.deploy("inc", lambda p, d: p + 1, ["edge-eu", "cloud-us"])
            dep.deploy("dbl", lambda p, d: p * 2, ["cloud-us"])
            wf = c.WorkflowSpec((c.StepSpec("inc", "edge-eu"),
                                 c.StepSpec("dbl", "cloud-us"),
                                 c.StepSpec("inc", "cloud-us")))
            r = dep.run(wf, 1)
        return r.outputs, sorted(r.timeline)

    got = both(run)
    assert got["torch"] == got["jax"] == (5, ["dbl", "inc@0", "inc@2"])


# -- tests/test_system.py, re-pointed -----------------------------------------------
@pytest.fixture(scope="module")
def system():
    """Both packages' federated 3-step workflow (preprocess on the edge,
    the smoke qwen3-1.7b's prefill on a cloud pod, postprocess with a
    pre-fetched table) on the same params and table."""
    jcfg, cfg = jax_smoke_config("qwen3-1.7b"), smoke_config("qwen3-1.7b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    vocab = cfg.vocab_size
    table = np.random.default_rng(0).normal(size=(vocab,)).astype(np.float32)
    forwards = {
        "jax": lambda toks: np.asarray(JM.prefill(
            jcfg, jparams, {"tokens": jnp.asarray(toks)[None]})[0][0]),
        "torch": lambda toks: M.prefill(
            cfg, params, {"tokens": torch.as_tensor(toks)[None]})[0][0].numpy()}
    deps = {}
    for name, pkg in PKGS.items():
        c = pkg.core
        reg = c.PlatformRegistry()
        reg.register(c.Platform("edge", "eu", kind="edge", native_prefetch=True,
                                **pkg.plat))
        reg.register(c.Platform("pod-a", "us", kind="cloud", **pkg.plat))
        reg.register(c.Platform("pod-b", "us", kind="cloud", **pkg.plat))
        dep = c.Deployment(reg)
        dep.store.network.set_link("eu", "us", 0.02, 100e6)
        dep.store.put("norm/table", table, region="us")
        forward = forwards[name]

        def preprocess(payload, data):
            return (np.asarray(payload) % (vocab - 1) + 1).astype(np.int32)

        def postprocess(payload, data):
            return int(np.argmax(payload + 0.01 * np.asarray(data["norm/table"])))

        dep.deploy("preprocess", preprocess, ["edge"])
        dep.deploy("forward", lambda p, d, f=forward: f(p), ["pod-a", "pod-b"])
        dep.deploy("postprocess", postprocess, ["pod-a", "pod-b", "edge"])
        deps[name] = dep
    yield SimpleNamespace(deps=deps, forwards=forwards, table=table, vocab=vocab)
    for dep in deps.values():
        dep.shutdown()


def spec(pkg, fw_platform="pod-a", post_platform="pod-a"):
    c = pkg.core
    return c.WorkflowSpec((
        c.StepSpec("preprocess", "edge"),
        c.StepSpec("forward", fw_platform),
        c.StepSpec("postprocess", post_platform,
                   data_deps=(c.DataRef("norm/table", "us"),))), "e2e")


def test_end_to_end_result_matches_local(system):
    x = np.arange(12)
    toks = (x % (system.vocab - 1) + 1).astype(np.int32)
    for name, pkg in PKGS.items():
        out = system.deps[name].run(spec(pkg), x).outputs
        want = int(np.argmax(system.forwards[name](toks) + 0.01 * system.table))
        assert out == want, name
    logits = {n: f(toks) for n, f in system.forwards.items()}
    np.testing.assert_allclose(logits["torch"], logits["jax"], rtol=1e-4, atol=1e-4)
    outs = {n: system.deps[n].run(spec(p), x).outputs for n, p in PKGS.items()}
    assert outs["torch"] == outs["jax"]


def test_per_request_rerouting(system):
    for name, pkg in PKGS.items():
        dep = system.deps[name]
        a = dep.run(spec(pkg, "pod-a", "pod-a"), np.arange(8)).outputs
        b = dep.run(spec(pkg, "pod-b", "edge"), np.arange(8)).outputs
        assert a == b, name  # same function, other platforms, same result


def test_timelines_cover_all_steps(system):
    for name, pkg in PKGS.items():
        r = system.deps[name].run(spec(pkg), np.arange(8))
        assert set(r.timeline) == {"preprocess", "forward", "postprocess"}, name
        for t in r.timeline.values():
            assert set(t) == TIMELINE_KEYS, name


def test_prefetch_stats_accumulate(system):
    for name, pkg in PKGS.items():
        dep = system.deps[name]
        before = dep.prefetcher.stats["prefetched"]
        dep.run(spec(pkg), np.arange(8))
        assert dep.prefetcher.stats["prefetched"] > before, name
