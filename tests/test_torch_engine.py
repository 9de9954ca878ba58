"""The port's dataflow engine against the JAX package's: the same
numpy-only handlers and specs run on both packages' ``DagDeployment`` and
give equal outputs and equal ``report()`` counters. Also the cold start
(``CompileCache`` with ``compile_fn``), ``signature_of`` and the
prefetcher's device copy."""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dag as jdag
import repro_torch.core as tcore
import repro_torch.dag as tdag
from repro.core.prewarm import signature_of as jax_signature_of
from repro_torch.core.prewarm import TensorSpec, signature_of

PKGS = {
    "jax": SimpleNamespace(core=jcore, dag=jdag, plat={}),
    "torch": SimpleNamespace(core=tcore, dag=tdag, plat={"device": "cpu"}),
}
TABLE = np.arange(64 * 8, dtype=np.float32).reshape(64, 8) / 100.0


def _deployment(pkg):
    c = pkg.core
    reg = c.PlatformRegistry()
    reg.register(c.Platform("edge-eu", "eu", kind="edge", native_prefetch=True,
                            **pkg.plat))
    reg.register(c.Platform("cloud-us", "us", kind="cloud", **pkg.plat))
    dep = pkg.dag.DagDeployment(reg)
    dep.store.network.set_link("eu", "us", 0.04, 8e6)
    dep.store.put("emb/table", TABLE, region="us")
    return dep


def _handlers(dep):
    dep.deploy("head", lambda p, d: np.asarray(p, np.float32) + 1.0, ["edge-eu"])
    dep.deploy("left", lambda p, d: p * 2.0, ["cloud-us"])
    dep.deploy("right", lambda p, d: p @ np.asarray(d["emb/table"])[: p.shape[-1]],
               ["cloud-us"])
    dep.deploy("join", lambda p, d: np.concatenate([p["left"], p["right"]]),
               ["cloud-us"])
    dep.deploy("tail", lambda p, d: float(np.sum(p)), ["cloud-us"])


def _spec(pkg, kind, prefetch):
    D = pkg.dag
    dd = (pkg.core.DataRef("emb/table", "us"),)
    if kind == "chain":
        steps = (D.DagStep("head", "edge-eu"),
                 D.DagStep("right", "cloud-us", data_deps=dd, prefetch=prefetch),
                 D.DagStep("tail", "cloud-us", prefetch=prefetch))
        edges = (("head", "right"), ("right", "tail"))
    else:
        steps = (D.DagStep("head", "edge-eu"),
                 D.DagStep("left", "cloud-us", prefetch=prefetch),
                 D.DagStep("right", "cloud-us", data_deps=dd, prefetch=prefetch),
                 D.DagStep("join", "cloud-us", prefetch=prefetch))
        edges = (("head", "left"), ("head", "right"), ("left", "join"),
                 ("right", "join"))
    return D.DagSpec(steps, edges, kind)


def _run(pkg, kind, prefetch, n=2):
    with _deployment(pkg) as dep:
        _handlers(dep)
        spec = _spec(pkg, kind, prefetch)
        payload = np.arange(8, dtype=np.float32)
        outs = [dep.run(spec, payload).outputs for _ in range(n)]
        rep = dep.report()
    counters = {
        "pokes": rep["engine"]["pokes"],
        "joins": rep["engine"]["joins"],
        "buffered_edges": rep["engine"]["buffered_edges"],
        "store_puts": rep["store"]["puts"],
        "store_gets": rep["store"]["gets"],
        "prefetched": rep["prefetch"]["prefetched"],
        "cold_fetches": rep["prefetch"]["cold_fetches"],
    }
    return outs, counters


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("kind", ["chain", "diamond"])
def test_engine_outputs_and_counters_equal_jax(kind, prefetch):
    j_outs, j_counts = _run(PKGS["jax"], kind, prefetch)
    t_outs, t_counts = _run(PKGS["torch"], kind, prefetch)
    assert t_counts == j_counts
    for a, b in zip(t_outs, j_outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if prefetch:
        assert t_counts["prefetched"] == 2 and t_counts["cold_fetches"] == 0
    else:
        assert t_counts["prefetched"] == 0 and t_counts["cold_fetches"] == 2


def test_chain_facade_equal_jax():
    outs = {}
    for name, pkg in PKGS.items():
        c = pkg.core
        with c.Deployment(_deployment(pkg).registry) as dep:
            dep.store.put("emb/table", TABLE, region="us")
            _handlers(dep)
            wf = c.WorkflowSpec((
                c.StepSpec("head", "edge-eu"),
                c.StepSpec("right", "cloud-us",
                           data_deps=(c.DataRef("emb/table", "us"),)),
                c.StepSpec("tail", "cloud-us")))
            r = dep.run(wf, np.ones(8, np.float32))
            outs[name] = (r.outputs, sorted(r.timeline))
    assert outs["torch"] == outs["jax"]


def test_warm_run_beats_cold_with_compile_fn():
    """The first request pays the cold start (one call of compile_fn on
    zero tensors of the abstract shapes); the second finds it cached."""
    calls = []

    def compile_fn(x):
        calls.append(tuple(x.shape))
        time.sleep(0.3)
        return x * 2

    with _deployment(PKGS["torch"]) as dep:
        dep.deploy("head", lambda p, d: p + 1, ["edge-eu"],
                   abstract_args=(TensorSpec((4, 8), torch.float32, "cpu"),),
                   compile_fn=compile_fn)
        dep.deploy("tail", lambda p, d: float(p.sum()), ["cloud-us"])
        spec = tdag.DagSpec((tdag.DagStep("head", "edge-eu"),
                             tdag.DagStep("tail", "cloud-us")),
                            (("head", "tail"),))
        cold = dep.run(spec, torch.ones(8))
        warm = dep.run(spec, torch.ones(8))
        stats = dep.report()["compile"]
    assert calls == [(4, 8)]
    assert cold.timeline["head"]["warm_s"] >= 0.3
    assert warm.timeline["head"]["warm_s"] < 0.1
    assert warm.total_s < cold.total_s
    assert stats["misses"] == 1 and stats["hits"] == 1


def test_signature_of_agrees_with_jax():
    args = ({"k": (np.zeros((2, 3), np.float32), np.zeros(4, np.int32)),
             "a": np.ones((5,), np.float32)}, [np.zeros((1, 1), np.float32)])
    sig = signature_of(args)
    assert sig[1] == jax_signature_of(args)[1]
    # the same structure built from tensors or TensorSpecs: one key
    t_args = ({"k": (torch.zeros(2, 3), torch.zeros(4, dtype=torch.int32)),
               "a": torch.ones(5)}, [torch.zeros(1, 1)])
    s_args = ({"k": (TensorSpec((2, 3), torch.float32, "cpu"),
                     TensorSpec((4,), torch.int32, "cpu")),
               "a": TensorSpec((5,), torch.float32, "cpu")},
              [TensorSpec((1, 1), torch.float32, "cpu")])
    assert signature_of(t_args) == signature_of(s_args)
    # structure and shape changes give other keys, as in JAX
    moved = ({"k": [np.zeros((2, 3), np.float32), np.zeros(4, np.int32)],
              "a": np.ones((5,), np.float32)}, [np.zeros((1, 1), np.float32)])
    assert signature_of(moved) != sig
    assert jax_signature_of(moved) != jax_signature_of(args)
    assert signature_of(({"a": np.ones((6,), np.float32)},)) != signature_of(
        ({"a": np.ones((5,), np.float32)},))


def test_prefetcher_cpu_device_hands_over_without_copy():
    store = tcore.ObjectStore()
    store.put("w", TABLE, region="us")
    pf = tcore.Prefetcher(store)
    try:
        futs = pf.start([tcore.DataRef("w", "us")], "us", device="cpu")
        out, _, _ = pf.join(futs)
        got, _ = pf.fetch_blocking([tcore.DataRef("w", "us")], "us", device="cpu")
    finally:
        pf.shutdown()
    for t in (out["w"], got["w"]):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), TABLE)
    assert np.shares_memory(out["w"].numpy(), TABLE)

