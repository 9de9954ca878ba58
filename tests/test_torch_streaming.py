"""The port's streaming data plane on the engine and the prefetcher against
the JAX package's: the engine cases of the reference's
``tests/test_streaming.py`` (:358-485) re-pointed. The same chain, payloads
and ``StreamConfig`` run through both packages' ``DagDeployment`` and
``Prefetcher`` (the port's platforms on ``device="cpu"``): equal outputs,
equal ``streamed_edges`` / ``p2p_edges`` / ``buffered_edges``, equal
prefetch ``streamed`` and modeled ``first_byte_s``, equal learned edge
bytes, and the stream_wait bucket tiling each engine's trace. Plus the
port's own: a streamed prefetch onto a device goes through the same copy
(``_to_device``) as a whole-object one."""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dag as jdag
import repro_torch.core as tcore
import repro_torch.dag as tdag
from repro.adapt.telemetry import TelemetryHub as JTelemetryHub
from repro.obs import Tracer as JTracer
from repro.obs import extract_critical_path as jextract
from repro_torch.adapt.telemetry import TelemetryHub
from repro_torch.core import prefetch as tprefetch
from repro_torch.obs import Tracer, extract_critical_path

PKGS = {
    "jax": SimpleNamespace(core=jcore, dag=jdag, plat={}, hub=JTelemetryHub,
                           tracer=JTracer, critical_path=jextract),
    "torch": SimpleNamespace(core=tcore, dag=tdag, plat={"device": "cpu"},
                             hub=TelemetryHub, tracer=Tracer,
                             critical_path=extract_critical_path),
}
PAYLOAD = np.random.default_rng(7).normal(size=250_000)  # 2 MB of float64


def both(fn):
    return {name: fn(pkg) for name, pkg in PKGS.items()}


# -- prefetcher: chunked fetches ---------------------------------------------------
def test_prefetcher_streams_when_configured():
    blob = np.random.default_rng(1).normal(size=64)

    def run(pkg):
        c = pkg.core
        store = c.ObjectStore(c.NetworkModel())
        store.put("blob", blob, "us")
        pf = c.Prefetcher(store, stream=c.StreamConfig(chunks=4))
        try:
            out, _, modeled = pf.join(pf.start([c.DataRef("blob", "us", 512)], "eu"))
            return np.asarray(out["blob"]), modeled, pf.stats_snapshot()
        finally:
            pf.shutdown()

    got = both(run)
    for name, (out, modeled, stats) in got.items():
        assert np.array_equal(out, blob), name
        assert stats["streamed"] == 1, name
        assert 0.0 < stats["first_byte_s"] < modeled, name
    (_, tm, ts), (_, jm, js) = got["torch"], got["jax"]
    assert tm == jm
    assert {k: ts[k] for k in ("streamed", "first_byte_s", "prefetched",
                               "cold_fetches")} == {
        k: js[k] for k in ("streamed", "first_byte_s", "prefetched", "cold_fetches")}


@pytest.mark.parametrize("chunks", [1, 8])
def test_streamed_prefetch_onto_a_device_takes_the_device_copy(chunks, monkeypatch):
    """The streamed branch of ``Prefetcher.start`` copies to the device only
    after its last chunk, through ``_to_device`` (on a CUDA device the
    pinned side-stream copy and its event), as the whole-object branch does;
    ``join`` hands the event to ``_join_on_current_stream``."""
    seen = []
    to_device, join = tprefetch._to_device, tprefetch._join_on_current_stream

    def spy_copy(value, device, side, lock):
        seen.append(("copy", type(value).__name__, str(device)))
        return to_device(value, device, side, lock)

    def spy_join(value, event):
        seen.append(("join", type(value).__name__, event))
        return join(value, event)

    monkeypatch.setattr(tprefetch, "_to_device", spy_copy)
    monkeypatch.setattr(tprefetch, "_join_on_current_stream", spy_join)
    blob = np.random.default_rng(2).normal(size=(256, 64)).astype(np.float32)
    store = tcore.ObjectStore()
    store.put("blob", blob, "us")
    pf = tcore.Prefetcher(store, stream=tcore.StreamConfig(chunks=chunks))
    try:
        out, _, _ = pf.join(pf.start([tcore.DataRef("blob", "us")], "eu",
                                     device="cpu"))
    finally:
        pf.shutdown()
    assert seen == [("copy", "ndarray", "cpu"), ("join", "Tensor", None)]
    assert isinstance(out["blob"], torch.Tensor)
    np.testing.assert_array_equal(out["blob"].numpy(), blob)
    assert pf.stats["streamed"] == (1 if chunks > 1 else 0)


# -- engine: cut-through streamed edges + direct P2P payloads ----------------------
def engine(pkg, stream=None, payload_region=None, telemetry=None, tracer=None):
    c = pkg.core
    reg = c.PlatformRegistry()
    reg.register(c.Platform("edge-eu", "eu", kind="edge", native_prefetch=True,
                            **pkg.plat))
    reg.register(c.Platform("cloud-us", "us", kind="cloud", **pkg.plat))
    dep = pkg.dag.DagDeployment(reg, stream=stream, payload_region=payload_region,
                                telemetry=telemetry, tracer=tracer)
    dep.store.enforce_latency = True
    for a, b in (("eu", "us"), ("eu", "mid"), ("mid", "us")):
        dep.store.network.set_link(a, b, 0.01, 2e8)
    return dep


def chain3(pkg):
    D = pkg.dag
    return D.DagSpec((D.DagStep("a", "edge-eu"), D.DagStep("b", "cloud-us"),
                      D.DagStep("c", "cloud-us")), (("a", "b"), ("b", "c")), "chain3")


def handler(s):
    def h(payload, data):
        time.sleep(s)
        return payload

    return h


def deploy_chain(dep):
    dep.deploy("a", handler(0.005), ["edge-eu"])
    dep.deploy("b", handler(0.03), ["cloud-us"])
    dep.deploy("c", handler(0.005), ["cloud-us"])
    return dep


def engine_counts(dep) -> dict:
    rep = dep.report()
    store = {k: rep["store"][k] for k in ("puts", "gets", "bytes_in", "bytes_out",
                                          "bytes_by_pair")}
    return {"engine": rep["engine"], "store": store,
            "modeled_s": (rep["store"]["modeled_put_s"], rep["store"]["modeled_get_s"])}


def test_engine_streamed_edges_preserve_results():
    def run(pkg):
        with deploy_chain(engine(pkg, payload_region="mid")) as dep:
            want = dep.run(chain3(pkg), PAYLOAD).outputs
            plain = engine_counts(dep)
        stream = pkg.core.StreamConfig(chunks=4)
        with deploy_chain(engine(pkg, stream=stream, payload_region="mid")) as dep:
            r = dep.run(chain3(pkg), PAYLOAD)
            return (want, r.outputs, plain, engine_counts(dep), r.timeline["b"],
                    dep.store.keys("__payload__"))

    got = both(run)
    for name, (want, out, plain, streamed, tl, left) in got.items():
        assert np.array_equal(out, want) and np.array_equal(out, PAYLOAD), name
        assert plain["engine"]["buffered_edges"] == 2, name
        assert plain["engine"]["streamed_edges"] == 0, name
        assert streamed["engine"]["streamed_edges"] == 2, name
        assert streamed["engine"]["buffered_edges"] == 0, name
        assert tl["stream_wait_s"] >= 0.0, name
        assert not left, name  # payload buffers never leak
    (_, _, tp, ts, ttl, _), (_, _, jp, js, jtl, _) = got["torch"], got["jax"]
    assert tp == jp and ts == js
    assert set(ttl) == set(jtl)


def test_engine_p2p_path_skips_store_and_learns_edge_bytes():
    pay = np.arange(1000, dtype=np.float64)  # 8 KB: under the threshold

    def run(pkg):
        hub = pkg.hub()
        stream = pkg.core.StreamConfig(chunks=4, p2p_threshold_bytes=1e6)
        with deploy_chain(engine(pkg, stream=stream, telemetry=hub)) as dep:
            r = dep.run(chain3(pkg), pay)
            counts = engine_counts(dep)
        return r.outputs, counts, hub.edge_bytes("a", "b"), hub.edge_bytes("b", "c")

    got = both(run)
    for name, (out, counts, ab, bc) in got.items():
        assert np.array_equal(out, pay), name
        assert counts["engine"]["p2p_edges"] == 2, name
        assert counts["engine"]["streamed_edges"] == 0, name
        assert counts["engine"]["buffered_edges"] == 0, name
        assert counts["store"]["puts"] == counts["store"]["gets"] == 0, name
        assert ab == pytest.approx(pay.nbytes) and bc == pytest.approx(pay.nbytes)
    assert got["torch"][1:] == got["jax"][1:]


def test_engine_stream_off_keeps_legacy_stats_shape():
    def run(pkg):
        with deploy_chain(engine(pkg)) as dep:
            r = dep.run(chain3(pkg), 1)
            return r.outputs, sorted(r.timeline["b"]), dep.report()["engine"]

    got = both(run)
    assert got["torch"] == got["jax"]
    out, keys, eng = got["torch"]
    assert out == 1 and "stream_wait_s" not in keys
    assert eng["streamed_edges"] == 0 and eng["p2p_edges"] == 0


def test_engine_streamed_data_deps_count_first_bytes_as_the_reference():
    """A streamed engine pre-fetches a step's data dependency chunk by chunk:
    the prefetcher's ``streamed`` and modeled ``first_byte_s`` equal the
    reference's for the same spec."""
    blob = np.random.default_rng(3).normal(size=125_000)  # 1 MB

    def run(pkg):
        c, D = pkg.core, pkg.dag
        stream = c.StreamConfig(chunks=8)
        with deploy_chain(engine(pkg, stream=stream, payload_region="mid")) as dep:
            dep.store.put("w", blob, region="eu")
            dep.deploy("b", lambda p, d: p + float(np.sum(d["w"])), ["cloud-us"])
            spec = D.DagSpec((D.DagStep("a", "edge-eu"),
                              D.DagStep("b", "cloud-us", (c.DataRef("w", "eu"),)),
                              D.DagStep("c", "cloud-us")), (("a", "b"), ("b", "c")))
            out = dep.run(spec, 1.0).outputs
            st = dep.prefetcher.stats_snapshot()
            return out, engine_counts(dep), st["streamed"], st["first_byte_s"]

    got = both(run)
    assert got["torch"] == got["jax"]
    out, counts, streamed, first = got["torch"]
    assert out == pytest.approx(1.0 + blob.sum())
    assert streamed == 1 and first > 0.0
    assert counts["engine"]["streamed_edges"] == 2


# -- critical path: the stream_wait bucket tiles exactly -------------------------
def _assert_tiles(cp):
    segs = sorted(cp.segments, key=lambda s: s.t0)
    for s0, s1 in zip(segs, segs[1:]):
        assert s1.t0 == pytest.approx(s0.t1, abs=1e-9)
    att = cp.attribution
    assert sum(att.values()) == pytest.approx(cp.total_s, rel=1e-9)
    return att


def test_stream_wait_bucket_tiles_engine_trace():
    def run(pkg):
        tracer = pkg.tracer()
        stream = pkg.core.StreamConfig(chunks=4)
        dep = deploy_chain(engine(pkg, stream=stream, payload_region="mid",
                                  tracer=tracer))
        with dep:
            dep.run(chain3(pkg), PAYLOAD)
        (trace,) = tracer.traces()
        return _assert_tiles(pkg.critical_path(trace)), sorted(
            s.kind for s in trace.spans)

    got = both(run)
    for name, (att, _) in got.items():
        assert att["stream_wait"] >= 0.0, name
        assert att["compute"] > 0.0, name
    assert set(got["torch"][0]) == set(got["jax"][0])
    assert got["torch"][1] == got["jax"][1]
