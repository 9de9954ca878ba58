"""The port's dataflow engine (``repro_torch.dag.DagDeployment``) against the
JAX package's: the reference's ``tests/test_dag_engine.py`` re-pointed. Each
test builds the same topology with the same numpy-only handlers in both
packages (the port's platforms on ``device="cpu"``), runs the same inputs
and compares outputs, timelines' keys and the ``report()`` counters key for
key; where the reference holds a property (branches overlap, the DAG beats
the chain, prewarm hides the compile) the port holds the same one, with the
reference's bars.

Caveat 3 (ROADMAP.md): a handler of microseconds can deliver its payload
before its successor's poke in either engine. The cases that compare
prefetch counters wait on the poke counters (``poke_waiting``) instead of
sleeping."""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dag as jdag
import repro_torch.core as tcore
import repro_torch.dag as tdag
from repro_torch.core.prewarm import TensorSpec

PKGS = {
    "jax": SimpleNamespace(core=jcore, dag=jdag, plat={}),
    "torch": SimpleNamespace(core=tcore, dag=tdag, plat={"device": "cpu"}),
}
# the report() counters that do not depend on the host clock
STORE_KEYS = ("puts", "gets", "misses", "bytes_in", "bytes_out", "bytes_by_pair")


def both(fn):
    """``fn(pkg)`` for each package: {"jax": ..., "torch": ...}."""
    return {name: fn(pkg) for name, pkg in PKGS.items()}


def make_registry(pkg):
    c = pkg.core
    reg = c.PlatformRegistry()
    reg.register(c.Platform("edge-eu", "eu", kind="edge", native_prefetch=True,
                            **pkg.plat))
    reg.register(c.Platform("cloud-us", "us", kind="cloud", **pkg.plat))
    return reg


def make_dep(pkg, enforce=True, **kw):
    dep = pkg.dag.DagDeployment(make_registry(pkg), **kw)
    dep.store.enforce_latency = enforce
    dep.store.network.set_link("eu", "us", 0.04, 8e6)
    return dep


def counters(dep) -> dict:
    """The engine's counters and the store's byte and call counts."""
    rep = dep.report()
    return {"engine": rep["engine"],
            "store": {k: rep["store"][k] for k in STORE_KEYS}}


def sleep_handler(duration, factor=1):
    def h(payload, data):
        time.sleep(duration)
        return payload * factor

    return h


def poke_waiting(dep, want, factor=1):
    """A head handler that returns once every node of ``want`` has been
    poked for this request (caveat 3), then scales its payload."""
    calls = []

    def h(payload, data):
        calls.append(None)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            pokes = dep.report()["engine"]["pokes"]
            if all(pokes.get(v, 0) >= len(calls) for v in want):
                break
            time.sleep(0.001)
        return payload * factor

    return h


def diamond(pkg, branch_s=0.15, deps=()):
    D = pkg.dag
    return D.DagSpec(
        (D.DagStep("head", "edge-eu"),
         D.DagStep("left", "cloud-us", deps),
         D.DagStep("right", "cloud-us", deps),
         D.DagStep("join", "cloud-us")),
        (("head", "left"), ("head", "right"), ("left", "join"), ("right", "join")),
        "diamond")


def deploy_diamond(pkg, dep, branch_s=0.15):
    dep.deploy("head", sleep_handler(0.02), ["edge-eu"])
    dep.deploy("left", sleep_handler(branch_s, 2), ["cloud-us"])
    dep.deploy("right", sleep_handler(branch_s, 3), ["cloud-us"])
    dep.deploy("join", lambda p, d: (p["left"], p["right"]), ["cloud-us"])
    return diamond(pkg, branch_s)


def test_diamond_executes_with_fan_in_join():
    def run(pkg):
        with make_dep(pkg, enforce=False) as dep:
            r = dep.run(deploy_diamond(pkg, dep), 1)
            return r.outputs, sorted(r.timeline), counters(dep)

    got = both(run)
    assert got["torch"] == got["jax"]
    outs, nodes, c = got["torch"]
    assert outs == (2, 3)
    assert nodes == ["head", "join", "left", "right"]
    assert c["engine"]["joins"] == 1


def test_pokes_cascade_along_both_branches():
    """One run pokes left, right and the join, each exactly once (the
    join is reachable by two paths, deduplicated)."""
    def run(pkg):
        with make_dep(pkg, enforce=False) as dep:
            dep.run(deploy_diamond(pkg, dep), 1)
            return dep.stats["pokes"]

    got = both(run)
    assert got["torch"] == got["jax"] == {"left": 1, "right": 1, "join": 1}


def test_branches_run_in_parallel():
    """Two 0.15 s branches finish in about the max, not the sum."""
    def run(pkg):
        with make_dep(pkg, enforce=False) as dep:
            spec = deploy_diamond(pkg, dep, branch_s=0.15)
            dep.run(spec, 1)  # warm pools
            return min(dep.run(spec, 1).total_s for _ in range(3))

    got = both(run)
    for name, t_dag in got.items():
        assert t_dag < 0.15 * 2, (name, t_dag)  # the sum would be >= 0.3


def test_dag_beats_chain_serialization_real_engine():
    """Prefetch-on DAG median < the chain serialization median of the same
    steps on the real middlewares (enforced latencies), in both packages."""
    def run(pkg):
        c = pkg.core
        deps = (c.DataRef("ref", "eu"),)

        def seed(dep):
            dep.store.put("ref", np.ones(int(4e5 // 8)), region="eu")
            return dep

        dag = seed(make_dep(pkg))
        deploy_diamond(pkg, dag, branch_s=0.12)
        spec = diamond(pkg, deps=deps)
        dag.run(spec, 1)
        t_dag = float(np.median([dag.run(spec, 1).total_s for _ in range(3)]))
        dag_counts = counters(dag)
        dag.shutdown()

        chain = seed(c.Deployment(make_registry(pkg)))
        chain.store.enforce_latency = True
        chain.store.network.set_link("eu", "us", 0.04, 8e6)
        chain.deploy("head", sleep_handler(0.02), ["edge-eu"])
        chain.deploy("left", sleep_handler(0.12, 2), ["cloud-us"])
        chain.deploy("right", sleep_handler(0.12, 3), ["cloud-us"])
        chain.deploy("join", lambda p, d: p, ["cloud-us"])
        cspec = c.WorkflowSpec((
            c.StepSpec("head", "edge-eu"),
            c.StepSpec("left", "cloud-us", data_deps=deps),
            c.StepSpec("right", "cloud-us", data_deps=deps),
            c.StepSpec("join", "cloud-us")), "diamond-chain")
        out = chain.run(cspec, 1).outputs
        t_chain = float(np.median([chain.run(cspec, 1).total_s for _ in range(3)]))
        chain.shutdown()
        return t_dag, t_chain, out, dag_counts["engine"]

    got = both(run)
    for name, (t_dag, t_chain, _, _) in got.items():
        assert t_dag < t_chain, (name, t_dag, t_chain)
    assert got["torch"][2:] == got["jax"][2:]


def test_fan_in_payload_buffers_do_not_leak():
    """Every __payload__ store key is deleted after its GET, in the DAG
    engine and the chain facade."""
    def run(pkg):
        c = pkg.core
        with make_dep(pkg, enforce=False) as dep:
            spec = deploy_diamond(pkg, dep)
            for _ in range(3):
                dep.run(spec, 1)
            dag = (counters(dep), dep.store.keys("__payload__"))
        with c.Deployment(make_registry(pkg)) as chain:
            chain.deploy("a", lambda p, d: p, ["edge-eu"])
            chain.deploy("b", lambda p, d: p, ["cloud-us"])
            wf = c.WorkflowSpec((c.StepSpec("a", "edge-eu"),
                                 c.StepSpec("b", "cloud-us")))
            for _ in range(3):
                chain.run(wf, 1)
            return dag, (counters(chain), chain.store.keys("__payload__"))

    got = both(run)
    assert got["torch"] == got["jax"]
    (dag, dag_keys), (chain, chain_keys) = got["torch"]
    assert dag["engine"]["buffered_edges"] > 0 and dag_keys == []
    assert chain["store"]["puts"] >= 3 and chain_keys == []


def test_results_identical_with_and_without_prefetch():
    rng = np.random.default_rng(0)
    w = rng.normal(size=64)

    def run(pkg):
        D = pkg.dag
        with make_dep(pkg, enforce=False) as dep:
            dep.store.put("w", w, region="eu")
            dep.deploy("head", poke_waiting(dep, ["left", "right", "join"]),
                       ["edge-eu"])
            dep.deploy("left", lambda p, d: float(np.sum(d["w"])) * p, ["cloud-us"])
            dep.deploy("right", lambda p, d: p * 10, ["cloud-us"])
            dep.deploy("join", lambda p, d: p["left"] + p["right"], ["cloud-us"])

            def spec(prefetch):
                return D.DagSpec(
                    (D.DagStep("head", "edge-eu", prefetch=prefetch),
                     D.DagStep("left", "cloud-us",
                               data_deps=(pkg.core.DataRef("w", "eu"),),
                               prefetch=prefetch),
                     D.DagStep("right", "cloud-us", prefetch=prefetch),
                     D.DagStep("join", "cloud-us", prefetch=prefetch)),
                    (("head", "left"), ("head", "right"), ("left", "join"),
                     ("right", "join")))

            on = dep.run(spec(True), 2.0).outputs
            pf = dict(dep.prefetcher.stats)
            off = dep.run(spec(False), 2.0).outputs
            return on, off, {k: dep.prefetcher.stats[k] - pf[k]
                             for k in ("prefetched", "cold_fetches")}, pf

    got = both(run)
    for name, (on, off, _, _) in got.items():
        assert on == pytest.approx(off), name
    assert got["torch"][0] == got["jax"][0] and got["torch"][1] == got["jax"][1]
    # with prefetch the data came through the poke; without, a cold fetch
    for name, (_, _, delta, pf) in got.items():
        assert (pf["prefetched"], pf["cold_fetches"]) == (1, 0), name
        assert delta == {"prefetched": 0, "cold_fetches": 1}, name


def test_multi_source_multi_sink():
    def run(pkg):
        D = pkg.dag
        with make_dep(pkg, enforce=False) as dep:
            dep.deploy("src_a", lambda p, d: p + 1, ["edge-eu"])
            dep.deploy("src_b", lambda p, d: p + 2, ["edge-eu"])
            dep.deploy("mid", lambda p, d: p["src_a"] * p["src_b"], ["cloud-us"])
            dep.deploy("sink_x", lambda p, d: ("x", p), ["cloud-us"])
            dep.deploy("sink_y", lambda p, d: ("y", p), ["edge-eu"])
            spec = D.DagSpec(
                (D.DagStep("src_a", "edge-eu"), D.DagStep("src_b", "edge-eu"),
                 D.DagStep("mid", "cloud-us"), D.DagStep("sink_x", "cloud-us"),
                 D.DagStep("sink_y", "edge-eu")),
                (("src_a", "mid"), ("src_b", "mid"), ("mid", "sink_x"),
                 ("mid", "sink_y")))
            return dep.run(spec, 10).outputs, counters(dep)

    got = both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == {"sink_x": ("x", 132), "sink_y": ("y", 132)}


def test_chain_lifted_to_dag_matches_chain_engine():
    """from_chain specs run on the DAG engine with the chain's results."""
    def run(pkg):
        c = pkg.core
        wf = c.WorkflowSpec((c.StepSpec("a", "edge-eu"), c.StepSpec("b", "cloud-us")))
        with c.Deployment(make_registry(pkg)) as chain:
            chain.deploy("a", lambda p, d: p + 1, ["edge-eu"])
            chain.deploy("b", lambda p, d: p * 10, ["cloud-us"])
            expected = chain.run(wf, 1).outputs
        with make_dep(pkg, enforce=False) as dag:
            dag.deploy("a", lambda p, d: p + 1, ["edge-eu"])
            dag.deploy("b", lambda p, d: p * 10, ["cloud-us"])
            lifted = dag.run(pkg.dag.DagSpec.from_chain(wf), 1).outputs
        return expected, lifted

    got = both(run)
    assert got["torch"] == got["jax"] == (20, 20)


def test_handler_error_propagates():
    def run(pkg):
        D = pkg.dag
        with make_dep(pkg, enforce=False) as dep:
            dep.deploy("a", lambda p, d: p, ["edge-eu"])
            dep.deploy("boom", lambda p, d: 1 / 0, ["cloud-us"])
            spec = D.DagSpec((D.DagStep("a", "edge-eu"), D.DagStep("boom", "cloud-us")),
                             (("a", "boom"),))
            with pytest.raises(ZeroDivisionError):
                dep.run(spec, 1)
            return dep.store.keys("__payload__"), dep.stats["attempt_errors"]

    got = both(run)
    assert got["torch"] == got["jax"] == ([], 1)


def test_missing_deployment_raises():
    def run(pkg):
        D = pkg.dag
        with make_dep(pkg, enforce=False) as dep:
            dep.deploy("a", lambda p, d: p, ["edge-eu"])
            with pytest.raises(KeyError) as e:
                dep.run(D.DagSpec((D.DagStep("a", "cloud-us"),), ()), 0)
            return str(e.value)

    got = both(run)
    assert got["torch"] == got["jax"]
    assert "'a' is not deployed on 'cloud-us'" in got["torch"]


def test_prewarm_hides_compile_in_dag():
    """A poked branch node compiles in the background (never a cold miss).
    The reference jits ``stepfn`` from a ShapeDtypeStruct; the port's
    ``CompileCache`` calls it once on zeros of a ``TensorSpec``."""
    import jax
    import jax.numpy as jnp

    def jstep(x):
        return jnp.tanh(x @ x.T).sum()

    def tstep(x):
        return torch.tanh(x @ x.T).sum()

    x = np.random.default_rng(0).normal(size=(32, 32)).astype(np.float32)
    cases = {
        "jax": (jstep, (jax.ShapeDtypeStruct((32, 32), jnp.float32),),
                lambda p, d: float(jstep(jnp.asarray(p)))),
        "torch": (tstep, (TensorSpec((32, 32), torch.float32, "cpu"),),
                  lambda p, d: float(tstep(torch.as_tensor(p)))),
    }

    def run(pkg):
        D = pkg.dag
        step, abstract, handler = cases["torch" if pkg is PKGS["torch"] else "jax"]
        with make_dep(pkg, enforce=False) as dep:
            dep.deploy("head", sleep_handler(0.25), ["edge-eu"])
            dep.deploy("b", handler, ["cloud-us"], abstract_args=abstract,
                       compile_fn=step)
            spec = D.DagSpec((D.DagStep("head", "edge-eu"), D.DagStep("b", "cloud-us")),
                             (("head", "b"),))
            out = dep.run(spec, x).outputs
            return out, dep.cache.stats["prewarms"], dep.cache.stats["misses"]

    got = both(run)
    for name, (_, prewarms, misses) in got.items():
        assert prewarms >= 1 and misses == 0, name
    assert got["torch"][0] == pytest.approx(got["jax"][0], rel=1e-5)
