"""The port's ``obs`` against the JAX package's: histograms, the tracer's
span tree and ring, critical-path extraction, the Perfetto export, and the
simulator's trace emission on its three backends (scalar, numpy, torch),
including draw neutrality — tracing must never consume or reorder a single
draw. These are the cases of ``tests/test_obs.py``, re-pointed: the
reference's jax-backend cases become torch cases on ``device="cpu"``, held
against the reference's numpy backend (its jax backend does not import
here). The copied modules (``metrics``, ``trace``, ``critical_path``,
``perfetto``, ``sampler``, ``slo``) are pinned equal to their originals on
the same inputs."""
import json
from dataclasses import replace

import numpy as np
import pytest

import repro.core.simulator as J
import repro.obs as RO
import repro_torch.core.simulator as S
import repro_torch.obs as TO
from repro_torch.kernels.cold_scan import cold_scan
from repro_torch.obs import (
    BUCKETS,
    LogHistogram,
    MetricsRegistry,
    Tracer,
    extract_critical_path,
    to_chrome_trace,
)

CPU = "cpu"
ATOL = 1e-9  # sigma-0 gap budget of the torch backend against numpy
DOC_EDGES = (("check", "virus"), ("check", "ocr"), ("virus", "e_mail"),
             ("ocr", "e_mail"))


# ---------------------------------------------------------------------------
# LogHistogram / MetricsRegistry
# ---------------------------------------------------------------------------
def test_histogram_quantiles_within_bucket_error():
    h, ref = LogHistogram(), RO.LogHistogram()
    rng = np.random.default_rng(0)
    xs = rng.lognormal(mean=-2.0, sigma=0.8, size=4000)
    for x in xs:
        h.observe(float(x))
        ref.observe(float(x))
    for q in (0.5, 0.95, 0.99):
        exact = float(np.quantile(xs, q))
        got = h.quantile(q)
        # log-bucketed: relative error bounded by one bucket width (15%)
        assert abs(got - exact) / exact < 0.16, (q, got, exact)
    snap = h.snapshot()
    assert snap["count"] == 4000
    assert snap["sum_s"] == pytest.approx(float(xs.sum()), rel=1e-9)
    assert snap["p99_s"] <= snap["max_s"] == pytest.approx(float(xs.max()))
    assert snap == ref.snapshot() and h.counts == ref.counts


def test_histogram_empty_and_tiny_values():
    h = LogHistogram()
    assert h.quantile(0.5) == 0.0
    h.observe(0.0)  # underflow slot, not a crash
    h.observe(1e-9)
    assert h.snapshot()["count"] == 2


def test_registry_caps_series_and_reports_drops():
    reg, ref = MetricsRegistry(max_series=4), RO.MetricsRegistry(max_series=4)
    for i in range(8):
        reg.observe(f"s/{i}", 0.1)
        ref.observe(f"s/{i}", 0.1)
    snap = reg.snapshot()
    assert snap["__dropped_series__"] == 4
    assert len([k for k in snap if not k.startswith("__")]) == 4
    p50, p95, p99 = reg.quantiles("s/0")
    assert p50 > 0 and p50 <= p95 <= p99
    assert snap == ref.snapshot()


# ---------------------------------------------------------------------------
# Tracer structure
# ---------------------------------------------------------------------------
def test_tracer_span_tree_and_events():
    tr = Tracer(metrics=MetricsRegistry())
    t = tr.begin(name="req", t0=0.0)
    node = t.span("node:a", kind="node", t_start=0.0, attrs={"node": "a"})
    assert tr.current_span() is None
    tr.event("ignored", {})  # unbound: silent no-op
    with tr.bind(node):
        assert tr.current_span() is node
        tr.event("prefetch.done", {"key": "k"})
    assert tr.current_span() is None
    node.end(0.5)
    tr.finish(t, t_end=0.5)
    assert tr.last() is t
    assert t.root.trace_id == node.trace_id
    assert node.parent_id == t.root.span_id
    assert [name for _t, name, _a in node.events] == ["prefetch.done"]
    # finish fed the span durations into the metrics registry
    assert tr.metrics.quantiles("node_s/a")[0] > 0
    tr.record_event("recompose.decision", {"outcome": "swap"})
    assert tr.events[-1][1] == "recompose.decision"


def test_tracer_ring_is_bounded():
    tr = Tracer(max_traces=4)
    for k in range(10):
        tr.finish(tr.begin(name=f"r{k}", t0=0.0), t_end=1.0)
    assert len(tr.traces()) == 4
    assert tr.last().root.name == "r9"


# ---------------------------------------------------------------------------
# critical path: hand-built exact cases, in both packages
# ---------------------------------------------------------------------------
def _node(trace, name, **attrs):
    base = {
        "node": name,
        "platform": "p",
        "preds": tuple(attrs.get("payload_t") or ()),
        "poke_t": None,
        "prepare_t0": None,
        "prepare_t1": None,
        "cold_s": 0.0,
        "fetch_s": 0.0,
        "compute_s": 0.0,
        "compute_t0": None,
        "payload_t": {},
        "transfer_s": {},
    }
    base.update(attrs)
    s = trace.span(
        f"node:{name}", kind="node", t_start=base.get("t_start", 0.0), attrs=base
    )
    s.end(base["t_end"])
    return s


def _two_node_chain(O):
    tr = O.Tracer()
    t = tr.begin(name="req", trace_id="chain", t0=0.0)
    _node(
        t, "a", poke_t=0.0, prepare_t0=0.0, prepare_t1=0.3, cold_s=0.1,
        fetch_s=0.2, compute_t0=0.3, compute_s=0.2, t_start=0.0, t_end=0.5,
    )
    _node(
        t, "b", poke_t=0.0, prepare_t0=0.0, prepare_t1=0.25, cold_s=0.05,
        fetch_s=0.2, compute_t0=0.7, compute_s=0.3,
        payload_t={"a": 0.7}, transfer_s={"a": 0.2}, t_start=0.0, t_end=1.0,
    )
    tr.finish(t, t_end=1.0)
    return t


def _segments(cp):
    return [(s.t0, s.t1, s.bucket, s.node, s.edge) for s in cp.segments]


def test_critical_path_exact_two_node_chain():
    t = _two_node_chain(TO)
    cp = extract_critical_path(t)
    assert cp.nodes == ["a", "b"]
    att = cp.attribution
    assert att["compute"] == pytest.approx(0.5)
    assert att["transfer"] == pytest.approx(0.2)
    assert att["fetch"] == pytest.approx(0.2)
    assert att["cold"] == pytest.approx(0.1)
    assert att["poke_slack"] == pytest.approx(0.0, abs=1e-12)
    assert sum(att.values()) == pytest.approx(cp.total_s) == pytest.approx(1.0)
    # segments tile [t0, sink_end] without gaps or overlaps
    segs = sorted(cp.segments, key=lambda s: s.t0)
    for s0, s1 in zip(segs, segs[1:]):
        assert s1.t0 == pytest.approx(s0.t1, abs=1e-12)
    ref = RO.extract_critical_path(_two_node_chain(RO))
    assert _segments(cp) == _segments(ref) and cp.format() == ref.format()


def test_critical_path_prepare_bound_terminates_in_poke_slack():
    """A node whose prepare window gates the start and began at its poke
    time attributes the pre-poke idle to poke_slack and stops walking."""
    cps = []
    for O in (TO, RO):
        tr = O.Tracer()
        t = tr.begin(name="req", t0=0.0)
        _node(
            t, "x", poke_t=0.2, prepare_t0=0.2, prepare_t1=0.8, cold_s=0.4,
            fetch_s=0.2, compute_t0=0.8, compute_s=0.2, t_start=0.2, t_end=1.0,
        )
        tr.finish(t, t_end=1.0)
        cps.append(O.extract_critical_path(t))
    att = cps[0].attribution
    assert att["compute"] == pytest.approx(0.2)
    assert att["cold"] == pytest.approx(0.4)
    assert att["fetch"] == pytest.approx(0.2)
    assert att["poke_slack"] == pytest.approx(0.2)  # t0 -> poke_t idle
    assert _segments(cps[0]) == _segments(cps[1])


# ---------------------------------------------------------------------------
# simulator trace emission, all three backends
# ---------------------------------------------------------------------------
def _spec(M=S, n=6, seeds=None, tracer=None, edges="dag", steps=None):
    return M.ExperimentSpec(
        steps if steps is not None else M.document_workflow_fig4(),
        edges=DOC_EDGES if edges == "dag" else None,
        n_requests=n, seeds=seeds, tracer=tracer,
    )


def _simulate(sim, spec, backend):
    return sim.simulate(spec, backend=backend, device=CPU)


def _assert_trace_consistent(trace, rel=1e-6):
    cp = extract_critical_path(trace)
    assert cp.nodes, "empty critical path"
    assert sum(cp.attribution.values()) == pytest.approx(cp.total_s, rel=1e-9)
    assert cp.total_s == pytest.approx(trace.total_s, rel=rel)


def test_scalar_traces_sum_to_total():
    tracer = Tracer(sample=4)
    simulator = S.WorkflowSimulator(S.paper_platforms(), seed=3)
    totals = _simulate(simulator, _spec(n=10, tracer=tracer), "scalar")
    traces = tracer.traces()
    assert 1 <= len(traces) <= 4
    for trace in traces:
        assert trace.root.attrs["backend"] == "scalar"
        _assert_trace_consistent(trace)
    ks = [t.root.attrs["request_k"] for t in traces]
    assert any(
        trace.total_s == pytest.approx(totals[k], rel=1e-12)
        for k, trace in zip(ks, traces)
    )


def test_numpy_traces_sum_to_total():
    tracer = Tracer(sample=4)
    simulator = S.WorkflowSimulator(S.paper_platforms(), seed=3)
    totals = _simulate(simulator, _spec(n=12, tracer=tracer), "numpy")
    traces = tracer.traces()
    assert 1 <= len(traces) <= 4
    for trace in traces:
        assert trace.root.attrs["backend"] == "numpy"
        k = trace.root.attrs["request_k"]
        assert trace.total_s == pytest.approx(totals[k], rel=1e-9)
        _assert_trace_consistent(trace)


def test_torch_traces_sum_to_total():
    tracer = Tracer(sample=3)
    simulator = S.WorkflowSimulator(S.paper_platforms(), seed=3)
    cold_scan.launches = 0
    totals = _simulate(simulator, _spec(n=10, seeds=(0,), tracer=tracer), "torch")
    traces = tracer.traces()
    assert 1 <= len(traces) <= 3
    for trace in traces:
        assert trace.root.attrs["backend"] == "torch"
        assert trace.root.attrs["seed"] == 0
        k = trace.root.attrs["request_k"]
        assert trace.total_s == pytest.approx(totals[0, k], rel=1e-12)
        _assert_trace_consistent(trace, rel=1e-9)
    assert cold_scan.launches == 0  # CPU tensors: the plain version, no launch


def _node_view(trace):
    """{node: (t_start, t_end, attrs)} with the numeric attrs only."""
    keys = ("poke_t", "prepare_t0", "prepare_t1", "cold_s", "fetch_s",
            "compute_t0", "compute_s", "stream_wait_t0", "stream_wait_t1")
    out = {}
    for name, s in trace.node_spans().items():
        a = s.attrs
        out[name] = (s.t_start, s.t_end, {k: a.get(k) for k in keys},
                     a["payload_t"], a["transfer_s"], a["platform"],
                     list(a["preds"]))
    return out


def _assert_same_traces(got, want):
    assert [t.root.attrs["request_k"] for t in got] == [
        t.root.attrs["request_k"] for t in want]
    for tg, tw in zip(got, want):
        g, w = _node_view(tg), _node_view(tw)
        assert set(g) == set(w)
        for node in w:
            (gs, ge, ga, gp, gt, gplat, gpred) = g[node]
            (ws, we, wa, wp, wt, wplat, wpred) = w[node]
            assert (gplat, gpred) == (wplat, wpred)
            np.testing.assert_allclose([gs, ge], [ws, we], rtol=0, atol=ATOL)
            for k, v in wa.items():
                if v is None:
                    assert ga[k] is None, (node, k)
                else:
                    assert ga[k] == pytest.approx(v, rel=0, abs=ATOL), (node, k)
            for mine, ref in ((gp, wp), (gt, wt)):
                assert set(mine) == set(ref)
                for u in ref:
                    assert mine[u] == pytest.approx(ref[u], rel=0, abs=ATOL)
        assert tg.total_s == pytest.approx(tw.total_s, rel=0, abs=ATOL)


def _zero_sigma(M, steps):
    return [replace(s, compute=M.Dist(s.compute.median, 0.0),
                    fetch=M.Dist(s.fetch.median, 0.0)) for s in steps]


def _zero_platforms(M, keep_warm=None):
    return [replace(p, cold_start=M.Dist(p.cold_start.median, 0.0),
                    **({} if keep_warm is None else {"keep_warm_s": keep_warm}))
            for p in M.paper_platforms()]


@pytest.mark.parametrize("case", ["dag", "chain", "cold", "stream", "drift",
                                  "no_prefetch"])
def test_torch_traces_equal_reference_numpy_at_sigma0(case):
    """At sigma 0 no randomness survives: every sampled torch trace equals
    the JAX package's numpy-backend trace of the same request, node span by
    node span (times and every attr, atol 1e-9 in float64)."""
    traces = {}
    for M, backend in ((J, "numpy"), (S, "torch")):
        kw = {}
        if case == "stream":
            kw["stream"] = M.StreamConfig(chunks=4)
        if case == "drift":
            kw["drift"] = M.DriftSchedule([M.DriftEvent(20, "gcf", compute_scale=3.0,
                                                        transfer_scale=2.0)])
        sim = M.WorkflowSimulator(
            _zero_platforms(M, keep_warm=3.5 if case == "cold" else None), seed=0,
            **kw)
        steps = _zero_sigma(M, M.document_workflow_fig4())
        tracer = (RO if M is J else TO).Tracer(sample=7)
        spec = M.ExperimentSpec(
            steps, edges=None if case == "chain" else DOC_EDGES, n_requests=48,
            interarrival_s=6.0 if case == "cold" else 1.0,
            prefetch=case != "no_prefetch", seeds=(0,), tracer=tracer)
        if backend == "numpy":
            sim.simulate(spec, backend="numpy")
        else:
            sim.simulate(spec, backend="torch", device=CPU)
        traces[backend] = tracer.traces()
    assert len(traces["torch"]) == 7
    _assert_same_traces(traces["torch"], traces["numpy"])
    if case == "cold":
        assert any(s.attrs["cold_s"] > 0 for t in traces["torch"]
                   for s in t.node_spans().values())


@pytest.mark.parametrize("backend", ["scalar", "numpy", "torch"])
def test_tracing_is_draw_neutral(backend):
    """The load-bearing guarantee: attaching a tracer must not consume,
    reorder, or perturb a single draw — totals are bit-for-bit identical
    with tracing on and off."""
    seeds = (0, 1) if backend == "torch" else None
    off = _simulate(S.WorkflowSimulator(S.paper_platforms(), seed=7),
                    _spec(n=16, seeds=seeds), backend)
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=7)
    on = _simulate(sim, _spec(n=16, seeds=seeds, tracer=Tracer()), backend)
    assert off.dtype == on.dtype
    assert np.array_equal(off, on), "tracing perturbed the draws"
    assert sim.tracer is None  # spec override restored after simulate


@pytest.mark.parametrize("backend", ["scalar", "torch"])
def test_chain_spec_traces_too(backend):
    tracer = Tracer(sample=2)
    simulator = S.WorkflowSimulator(S.paper_platforms(), seed=0)
    _simulate(simulator, _spec(n=4, tracer=tracer, edges=None), backend)
    assert tracer.traces()
    for trace in tracer.traces():
        _assert_trace_consistent(trace)


# ---------------------------------------------------------------------------
# Perfetto export
# ---------------------------------------------------------------------------
def test_chrome_trace_is_valid_and_complete():
    tracer = Tracer(sample=2)
    simulator = S.WorkflowSimulator(S.paper_platforms(), seed=1)
    _simulate(simulator, _spec(n=4, seeds=(0,), tracer=tracer), "torch")
    tracer.record_event("recompose.decision", {"outcome": "swap"})
    doc = to_chrome_trace(tracer.traces(), tracer=tracer)
    text = json.dumps(doc)  # must be serializable as-is
    doc2 = json.loads(text)
    events = doc2["traceEvents"]
    assert events and doc2["displayTimeUnit"] == "ms"
    assert {e["ph"] for e in events} <= {"X", "i", "M"}
    xs = [e for e in events if e["ph"] == "X"]
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in xs)
    assert any(e["name"] == "recompose.decision" for e in events)
    # one process per trace, metadata names present
    pids = {e["pid"] for e in xs}
    assert len(pids) == len(tracer.traces())
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in events)
    # the torch backend's attrs are Python numbers: nothing fell back to str
    for t in tracer.traces():
        for s in t.node_spans().values():
            nums = [s.attrs[k] for k in ("poke_t", "prepare_t0", "prepare_t1",
                                         "cold_s", "fetch_s", "compute_t0",
                                         "compute_s")]
            nums += list(s.attrs["payload_t"].values())
            nums += list(s.attrs["transfer_s"].values())
            assert all(v is None or type(v) is float for v in nums), s.attrs


def test_buckets_constant_matches_attribution_keys():
    assert set(BUCKETS) == {
        "cold",
        "fetch",
        "compute",
        "transfer",
        "stream_wait",
        "poke_slack",
    }


# ---------------------------------------------------------------------------
# the copied modules, pinned to their originals on the same inputs
# ---------------------------------------------------------------------------
def _metrics_run(O):
    rng = np.random.default_rng(11)
    reg = O.MetricsRegistry(window_s=10.0, epochs=5, max_series=3)
    wh = O.WindowedHistogram(window_s=4.0, epochs=4)
    a, b = O.LogHistogram(), O.LogHistogram()
    for k, x in enumerate(rng.lognormal(-2.0, 1.0, 300)):
        reg.observe(f"s/{k % 5}", float(x), now=k * 0.1)
        wh.observe(float(x), now=k * 0.07)
        (a if k % 2 else b).observe(float(x))
    a.merge(b)
    return (reg.snapshot(now=29.9), reg.window_quantiles("s/1", now=29.9),
            reg.top(2, key="w_p99_s", now=29.9), wh.snapshot(),
            wh.window(now=25.0).quantile(0.9), a.snapshot(), a.counts)


def _trace_run(O):
    tr = O.Tracer(max_traces=3, metrics=O.MetricsRegistry(), sample=5)
    for k in range(5):
        t = tr.begin(name=f"r{k}", trace_id=f"id{k}", t0=float(k))
        n = t.span("a", "node", t_start=float(k), attrs={"node": "a"})
        with tr.bind(n):
            tr.event("store.get", {"key": k})
        n.end(k + 0.5)
        tr.finish(t, t_end=k + 1.0 + 0.1 * k)
    traces = tr.traces()
    return ([(t.trace_id, t.total_s, [(s.name, s.kind, s.t_start, s.t_end,
                                       [e[1:] for e in s.events])
                                      for s in t.spans]) for t in traces],
            tr.metrics.snapshot(now=6.0))


def _perfetto_run(O):
    t = _two_node_chain(O)
    tr = O.Tracer()
    tr.record_event("recompose.decision", {"outcome": "swap", "moved": ("a", "b")},
                    t=0.5)
    t.root.attrs["arr"] = np.arange(3)  # a non-JSON type goes through str()
    return O.to_chrome_trace([t], tracer=tr)


def _sampler_run(O):
    spec = O.SloSpec("p95", objective_s=0.05, target=0.9, fast_window_s=8.0,
                     slow_window_s=24.0, burn_threshold=2.0, min_count=4)
    sampler = O.TailSampler(window_s=50.0, epochs=5, head_every=7, slo=spec,
                            min_count=8)
    rng = np.random.default_rng(4)
    out = [sampler.decide(float(v), now=float(k))
           for k, v in enumerate(rng.lognormal(-3.5, 0.9, 200))]
    return out, sampler.snapshot(now=199.0), sampler.threshold(now=199.0)


def _slo_run(O):
    tracer = O.Tracer()
    slo = O.SloTracker(O.SloSpec("p95", objective_s=1.0, target=0.9,
                                 fast_window_s=8.0, slow_window_s=24.0,
                                 burn_threshold=4.0, min_count=4), tracer=tracer)
    fired = [slo.record(v, now=float(k))
             for k, v in enumerate([0.5] * 20 + [5.0] * 20 + [0.5] * 30)]
    return fired, slo.snapshot(now=70.0), [e[1:] for e in tracer.events]


@pytest.mark.parametrize("run", [_metrics_run, _trace_run, _perfetto_run,
                                 _sampler_run, _slo_run],
                         ids=["metrics", "trace", "perfetto", "sampler", "slo"])
def test_copied_module_equals_reference(run):
    assert run(TO) == run(RO)


def test_obs_surface_equals_reference():
    assert TO.__all__ == RO.__all__
    for name in TO.__all__:
        obj = getattr(TO, name)
        if callable(obj):
            assert obj.__module__.startswith("repro_torch.obs."), name
    assert TO.BUCKETS == RO.BUCKETS
