"""Host spans inside the port: the engine's executor queue waits
(``queued_s`` on node and transfer spans), the ``spanhook`` binding of a
step's ``compute`` span, and ``prefill``'s ``dispatch`` span with its CPU
seconds, attention share and rope's synchronising copies. Every platform
runs on the CPU."""
import threading
import time

import pytest
import torch

import repro.core as jcore
import repro.dag as jdag
from repro_torch import spanhook
from repro_torch.configs.registry import smoke_config
from repro_torch.core import Platform, PlatformRegistry
from repro_torch.core.faults import RetryPolicy
from repro_torch.dag import DagDeployment, DagSpec, DagStep
from repro_torch.models import model as M
from repro_torch.models.tree import tree_leaves
from repro_torch.obs import Tracer
from repro_torch.serving.engine import pad_cache

JOIN_S = 30.0
WORKERS = 8  # a platform's executor threads (core/platform.py)


def _registry(C=None):
    if C is None:
        reg = PlatformRegistry()
        for name in ("edge", "pA", "pB"):
            reg.register(Platform(name, "eu" if name == "edge" else "us",
                                  native_prefetch=name == "edge", device="cpu"))
        return reg
    reg = C.PlatformRegistry()
    for name in ("edge", "pA", "pB"):
        reg.register(C.Platform(name, "eu" if name == "edge" else "us",
                                native_prefetch=name == "edge"))
    return reg


def _chain(D=None):
    Spec, Step = (DagSpec, DagStep) if D is None else (D.DagSpec, D.DagStep)
    return Spec((Step("a", "edge"), Step("b", "pA"), Step("c", "pB")),
                (("a", "b"), ("b", "c")))


def _deploy_chain(dep, handler=None):
    for name, plat in (("a", "edge"), ("b", "pA"), ("c", "pB")):
        dep.deploy(name, handler or (lambda payload, data: payload + 1), [plat])
    return dep


def test_every_node_and_transfer_span_carries_its_queue_wait():
    tracer = Tracer()
    with _deploy_chain(DagDeployment(_registry(), tracer=tracer)) as dep:
        assert dep.run(_chain(), 1).outputs == 4
    spans = tracer.last().spans
    kinds = [s.kind for s in spans]
    assert kinds.count("node") == 3 and kinds.count("transfer") == 2
    queued = [s for s in spans if s.kind in ("node", "transfer")]
    assert all(s.attrs["queued_s"] >= 0.0 for s in queued)
    assert all("queued_s" not in s.attrs for s in spans
               if s.kind in ("request", "poke", "warm", "fetch", "compute"))


def test_a_busy_executor_shows_in_the_nodes_queue_wait():
    """All of the source platform's workers sleep 50 ms when the request
    arrives: its first node waits for one of them."""
    tracer = Tracer()
    with _deploy_chain(DagDeployment(_registry(), tracer=tracer)) as dep:
        dep.run(_chain(), 1)  # warm
        started = threading.Barrier(WORKERS + 1)

        def busy():
            started.wait(JOIN_S)
            time.sleep(0.05)

        for _ in range(WORKERS):
            dep.registry.executor("edge").submit(busy)
        started.wait(JOIN_S)
        dep.run(_chain(), 1)
    nodes = tracer.last().node_spans()
    assert nodes["a"].attrs["queued_s"] >= 0.04
    assert nodes["b"].attrs["queued_s"] < nodes["a"].attrs["queued_s"]


def test_untraced_timeline_keys_equal_the_reference_engines():
    with _deploy_chain(DagDeployment(_registry())) as dep:
        got = dep.run(_chain(), 1)
    with _deploy_chain(jdag.DagDeployment(_registry(jcore))) as ref:
        want = ref.run(_chain(jdag), 1)
    assert got.outputs == want.outputs == 4
    assert {n: sorted(t) for n, t in got.timeline.items()} == {
        n: sorted(t) for n, t in want.timeline.items()}


def test_the_hook_opens_a_child_of_the_bound_compute_span():
    seen = {}

    def probe(payload, data):
        span = spanhook.begin("probe", "probe")
        seen[payload] = (spanhook.current(), span)
        if span is not None:
            spanhook.end(span)
        seen[payload, "after"] = spanhook.current()
        return payload + 1

    tracer = Tracer()
    with _deploy_chain(DagDeployment(_registry(), tracer=tracer), probe) as dep:
        dep.run(_chain(), 1)
    trace = tracer.last()
    by_id = {s.span_id: s for s in trace.spans}
    for step, payload in (("a", 1), ("b", 2), ("c", 3)):
        inner, span = seen[payload]
        assert inner is span and span.trace_id == trace.trace_id
        assert span.t_end is not None and span.attrs["cpu_s"] >= 0.0
        compute = by_id[span.parent_id]
        assert compute.kind == "compute" and compute.attrs["node"] == step
        assert seen[payload, "after"] is compute
        assert compute.t_start <= span.t_start <= span.t_end <= compute.t_end
    # outside a request, and with no tracer, nothing is bound
    assert spanhook.current() is None and spanhook.begin("x", "probe") is None
    seen.clear()
    with _deploy_chain(DagDeployment(_registry()), probe) as dep:
        dep.run(_chain(), 1)
    assert seen[1] == (None, None)


def test_a_hedged_attempt_runs_under_the_compute_span():
    """The hedge pool's threads, which run both the primary attempt and
    its hedge, bind the span captured when the attempt was submitted, as
    pre-fetch jobs bind their poke span."""
    seen = []

    def slow(payload, data):
        seen.append((threading.current_thread().name, spanhook.current()))
        time.sleep(0.2)
        return payload + 1

    tracer = Tracer()
    dep = DagDeployment(_registry(), tracer=tracer,
                        retry=RetryPolicy(hedge_after_s=0.05))
    with _deploy_chain(dep, slow):
        dep.run(DagSpec((DagStep("b", "pA"),), ()), 1)
        assert dep.stats["hedges"] == 1
    compute = [s for s in tracer.last().spans if s.kind == "compute"]
    assert seen and len(compute) == 1
    assert all("hedge" in name and span is compute[0] for name, span in seen)


# ---------------------------------------------------------------------------
# prefill's dispatch span
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_qwen3():
    cfg = smoke_config("qwen3-1.7b").replace(compute_dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(1, cfg.vocab_size, (1, 24),
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, {"tokens": tokens}


def _dispatches(trace):
    return [s for s in trace.spans if s.kind == "dispatch"]


def test_prefill_under_a_bound_span_makes_one_dispatch_child(small_qwen3):
    cfg, params, batch = small_qwen3
    with torch.no_grad():
        want, want_caches = M.prefill(cfg, params, batch)
        trace = Tracer().begin()
        with spanhook.bind(trace, trace.root):
            got, caches = M.prefill(cfg, params, batch)
            assert spanhook.current() is trace.root
    (d,) = _dispatches(trace)
    assert (d.name, d.parent_id) == ("dispatch:prefill", trace.root.span_id)
    assert 0.0 < d.attrs["attention_s"] < d.duration_s
    # rope's two copies a layer lie inside the attention call
    assert 0.0 < d.attrs["sync_s"] < d.attrs["attention_s"]
    assert 0.0 <= d.attrs["cpu_s"] <= d.duration_s + 0.005
    # tracing changes no number
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(caches), tree_leaves(want_caches)))


def test_prefill_and_decode_with_nothing_bound_or_no_dispatch_record_nothing(
        small_qwen3):
    cfg, params, batch = small_qwen3
    trace = Tracer().begin()
    with torch.no_grad():
        M.prefill(cfg, params, batch)  # nothing bound
        assert trace.spans == [trace.root] and spanhook.current() is None
        _, caches = M.prefill(cfg, params, batch)
        T = batch["tokens"].shape[1]
        caches = pad_cache(caches, T + 1, T, cfg)
        with spanhook.bind(trace, trace.root):
            M.decode_step(cfg, params, batch["tokens"][:, :1], caches, T)
    assert trace.spans == [trace.root] and "attention_s" not in trace.root.attrs


def test_a_failed_prefill_ends_its_span_and_restores_the_bound_one(small_qwen3):
    cfg, params, _ = small_qwen3
    trace = Tracer().begin()
    with spanhook.bind(trace, trace.root):
        with pytest.raises(KeyError):
            M.prefill(cfg, params, {})
        assert spanhook.current() is trace.root
    (d,) = _dispatches(trace)
    assert d.t_end is not None and d.attrs["cpu_s"] >= 0.0
