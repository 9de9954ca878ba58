"""The port's ``obs`` level 2: windowed histograms (epoch-ring rotation and
eviction), SLO burn-rate alerting, tail-based trace sampling (exact
counters under threads), the ``transfer_table`` calibration hook on the
three simulator backends (scalar, numpy, torch), and the what-if causal
profiler, plus the controller's ``slo`` trigger. These are the cases of
``tests/test_slo.py``, re-pointed: the reference's jax-backend cases become
torch cases on ``device="cpu"``, and the profiler's torch ranking is held
to the JAX package's numpy ranking at sigma 0 (same order, deltas within
1e-9 relative)."""
import threading
from dataclasses import replace

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.simulator as J
import repro.obs as RO
import repro_torch.core.simulator as sm
import repro_torch.obs as TO
from repro_torch.adapt import RecompositionController, TelemetryHub
from repro_torch.core.shipping import PlacementCosts
from repro_torch.core import torchsim
from repro_torch.dag import DagSpec, DagStep
from repro_torch.obs import (
    LogHistogram,
    MetricsRegistry,
    SloSpec,
    SloTracker,
    TailSampler,
    Tracer,
    WhatIfProfiler,
    WindowedHistogram,
    calibrate,
    profile_trace,
)

CPU = "cpu"
JOIN_S = 30.0  # every worker thread joins within this, so nothing can hang
DOC_EDGES = (
    ("check", "virus"),
    ("check", "ocr"),
    ("virus", "e_mail"),
    ("ocr", "e_mail"),
)


def _doc_spec(n=8, seeds=None, tracer=None, M=sm):
    return M.ExperimentSpec(
        M.document_workflow_fig4(),
        edges=DOC_EDGES,
        n_requests=n,
        seeds=seeds,
        tracer=tracer,
    )


def _join(threads):
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a worker thread hung"


# ---------------------------------------------------------------------------
# LogHistogram.merge
# ---------------------------------------------------------------------------
def test_histogram_merge_matches_combined_stream():
    rng = np.random.default_rng(1)
    xs = rng.lognormal(-2.0, 0.8, 1000)
    ys = rng.lognormal(-1.0, 0.5, 1000)
    a, b, both = LogHistogram(), LogHistogram(), LogHistogram()
    for x in xs:
        a.observe(float(x))
        both.observe(float(x))
    for y in ys:
        b.observe(float(y))
        both.observe(float(y))
    a.merge(b)
    assert a.counts == both.counts
    assert a.count == both.count == 2000
    assert a.sum == pytest.approx(both.sum)
    assert a.max == both.max
    for q in (0.5, 0.95, 0.99):
        assert a.quantile(q) == both.quantile(q)


def test_histogram_merge_rejects_mismatched_geometry():
    with pytest.raises(ValueError):
        LogHistogram().merge(LogHistogram(n_buckets=80))


# ---------------------------------------------------------------------------
# WindowedHistogram: the property the whole level-2 plane rests on
# ---------------------------------------------------------------------------
@settings(max_examples=60)
@given(
    values=st.lists(st.floats(1e-3, 10.0), min_size=1, max_size=40),
    gaps=st.lists(st.floats(0.0, 3.0), min_size=40, max_size=40),
    epochs=st.integers(1, 8),
)
def test_windowed_quantiles_track_exact_order_statistic(values, gaps, epochs):
    """Under arbitrary rotation/eviction, the windowed quantile must match
    the exact order statistic of the still-live observations to within one
    bucket width (~15% relative), and the live COUNT and MAX exactly; the
    reference's histogram on the same stream gives the same window."""
    wh = WindowedHistogram(window_s=float(epochs), epochs=epochs)  # 1 s/epoch
    ref = RO.WindowedHistogram(window_s=float(epochs), epochs=epochs)
    now, times = 0.0, []
    for v, g in zip(values, gaps):
        now += g
        times.append(now)
        wh.observe(v, now=now)
        ref.observe(v, now=now)
    e_last = int(np.floor(now / wh.epoch_s))
    live = sorted(
        v
        for v, t in zip(values, times)
        if int(np.floor(t / wh.epoch_s)) > e_last - epochs
    )
    w = wh.window()
    assert w.count == len(live)
    assert w.max == max(live)
    for q in (0.5, 0.95, 0.99):
        exact = live[int(np.floor(q * (len(live) - 1)))]
        assert abs(w.quantile(q) - exact) / exact < 0.16, (q, w.quantile(q))
    assert wh.total.count == len(values)  # since-birth never evicts
    assert wh.snapshot() == ref.snapshot()


def test_windowed_eviction_drops_stale_max():
    """Regression for the lifetime-max clamp: a 100 s outlier that aged out
    of the window must not cap (or inflate) the windowed p99."""
    wh = WindowedHistogram(window_s=10.0, epochs=5)
    wh.observe(100.0, now=0.0)
    for k in range(50):
        wh.observe(0.01, now=20.0 + k * 0.1)
    w = wh.window()
    assert w.max < 1.0
    assert w.quantile(0.99) < 1.0
    snap = wh.snapshot()
    assert snap["max_s"] == 100.0  # since-birth keeps the outlier
    assert snap["w_max_s"] < 1.0
    assert snap["w_count"] == 50


def test_window_probe_is_read_only_and_ages_out():
    wh = WindowedHistogram(window_s=4.0, epochs=4)
    for k in range(8):
        wh.observe(1.0, now=float(k))
    assert wh.window(now=7.0).count == 4
    assert wh.window(now=100.0).count == 0  # probing the future: all aged out
    assert wh.window(now=7.0).count == 4  # ...and the probe mutated nothing
    assert wh.total.count == 8


def test_rotation_survives_large_clock_jump():
    wh = WindowedHistogram(window_s=4.0, epochs=4)
    wh.observe(1.0, now=0.0)
    wh.observe(2.0, now=1e9)  # recycle work is bounded by the ring size
    w = wh.window()
    assert w.count == 1 and w.max == 2.0


# ---------------------------------------------------------------------------
# MetricsRegistry: windowed surfaces + snapshot under contention
# ---------------------------------------------------------------------------
def test_registry_window_quantiles_and_top():
    reg = MetricsRegistry(window_s=10.0, epochs=5)
    for k in range(20):
        reg.observe("fast/x", 0.01, now=float(k))
        reg.observe("slow/y", 1.0, now=float(k))
    # while everything is live, windowed and since-birth p95 agree
    assert reg.window_quantiles("slow/y", now=19.0)[1] == pytest.approx(
        reg.quantiles("slow/y")[1]
    )
    assert reg.top(1, key="w_p99_s", now=19.0)[0][0] == "slow/y"
    # far future: the window empties, since-birth stays
    assert reg.window_quantiles("slow/y", now=1e6) == (0.0, 0.0, 0.0)
    assert reg.quantiles("slow/y")[0] > 0
    assert reg.snapshot(now=19.0)["fast/x"]["w_count"] == 10


def test_registry_snapshot_concurrent_with_observes():
    """snapshot copies counts under the lock and does quantile math outside
    it — under a writer hammering observe, every snapshot must still be a
    coherent (monotone-count) copy, and nothing may raise."""
    reg = MetricsRegistry()
    reg.observe("s/a", 0.01, now=0.0)
    stop = threading.Event()

    def hammer():
        k = 1
        while not stop.is_set():
            reg.observe("s/a", 0.01, now=float(k % 7))
            k += 1

    t = threading.Thread(target=hammer)
    t.start()
    try:
        counts = [reg.snapshot()["s/a"]["count"] for _ in range(100)]
    finally:
        stop.set()
        _join([t])
    assert counts == sorted(counts)


# ---------------------------------------------------------------------------
# SloSpec / SloTracker
# ---------------------------------------------------------------------------
def test_slo_spec_validates():
    with pytest.raises(ValueError):
        SloSpec("s", objective_s=0.0)
    with pytest.raises(ValueError):
        SloSpec("s", objective_s=1.0, target=1.0)
    with pytest.raises(ValueError):
        SloSpec("s", objective_s=1.0, fast_window_s=10.0, slow_window_s=5.0)
    assert SloSpec("s", objective_s=1.0, target=0.9).error_budget == pytest.approx(0.1)


def test_slo_burn_alert_is_edge_triggered_and_recovers():
    spec = SloSpec(
        "p95",
        objective_s=1.0,
        target=0.9,
        fast_window_s=8.0,
        slow_window_s=24.0,
        burn_threshold=4.0,
        min_count=4,
    )
    tracer = Tracer()
    slo = SloTracker(spec, tracer=tracer)
    now = 0.0
    for _ in range(20):  # healthy: never burns
        assert not slo.record(0.5, now=now)
        now += 1.0
    assert slo.alerts == 0
    burn_at = None
    for k in range(20):  # sustained violation
        if slo.record(5.0, now=now) and burn_at is None:
            burn_at = k
        now += 1.0
    assert burn_at is not None and burn_at + 1 >= spec.min_count
    assert slo.burning and slo.alerts == 1  # one alert per episode
    burns = [e for e in tracer.events if e[1] == "slo.burn"]
    assert len(burns) == 1
    attrs = burns[0][2]
    assert attrs["slo"] == "p95"
    assert attrs["fast_burn"] >= spec.burn_threshold
    for _ in range(30):  # recovery clears the alert without a new episode
        slo.record(0.5, now=now)
        now += 1.0
    assert not slo.burning and slo.alerts == 1
    assert slo.stats["recoveries"] == 1
    assert any(e[1] == "slo.ok" for e in tracer.events)
    snap = slo.snapshot(now=now)
    assert snap["burning"] is False and snap["alerts"] == 1
    assert snap["violations"] == 20 and snap["observed"] == 70


def test_slo_min_count_suppresses_thin_window_alerts():
    slo = SloTracker(
        SloSpec(
            "s",
            objective_s=0.1,
            target=0.9,
            fast_window_s=10.0,
            slow_window_s=10.0,
            burn_threshold=1.0,
            min_count=4,
        )
    )
    for k in range(3):  # burn rate 10x, but the window is too thin to page
        assert not slo.record(5.0, now=float(k))
    assert slo.alerts == 0
    assert slo.record(5.0, now=3.0)
    assert slo.alerts == 1


# ---------------------------------------------------------------------------
# TailSampler
# ---------------------------------------------------------------------------
def test_sampler_reasons_and_threshold_arming():
    s = TailSampler(
        window_s=100.0,
        epochs=10,
        head_every=4,
        slo=SloSpec("s", objective_s=1.0, target=0.9),
        min_count=8,
    )
    assert s.threshold() == 0.0  # cold window: slow test not armed
    assert s.decide(0.01, now=0.0) == (True, "head")  # 1-in-N baseline
    assert s.decide(2.0, now=1.0) == (True, "slo")  # violation while cold
    for k in range(8):
        s.decide(0.01, now=2.0 + k)  # arm the slow test
    assert s.threshold(now=9.0) > 0.0
    assert s.decide(5.0, now=10.0) == (True, "slow")  # slow outranks slo
    assert s.decide(0.001, now=11.0) == (False, None)
    assert s.stats["kept"] + s.stats["evicted"] == s.stats["seen"]


def test_sampler_counters_exact_under_threads():
    """Thread isolation: four writers race decide(); the counters must come
    out exact (kept + evicted == seen) and exactly the slow 2% retained —
    no lost updates, no fast request misjudged against a torn threshold."""
    s = TailSampler(
        window_s=1e9,
        epochs=4,
        quantile=0.95,
        margin=2.0,
        head_every=0,
        min_count=16,
    )
    rng = np.random.default_rng(5)
    for k, v in enumerate(rng.uniform(0.01, 0.02, 64)):  # arm single-threaded
        assert s.decide(float(v), now=float(k)) == (False, None)
    per_thread, slow_every = 200, 50  # 2% slow: far below the p95 bar
    results = [[] for _ in range(4)]

    def worker(i):
        r = np.random.default_rng(100 + i)
        for k in range(per_thread):
            v = 5.0 if k % slow_every == 0 else float(r.uniform(0.01, 0.02))
            results[i].append(s.decide(v, now=float(64 + k)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    _join(threads)
    n_slow = 4 * (per_thread // slow_every)
    total = 64 + 4 * per_thread
    assert s.stats["seen"] == total
    assert s.stats["kept"] + s.stats["evicted"] == total
    assert s.stats["kept"] == s.stats["kept_slow"] == n_slow
    flat = [d for rs in results for d in rs]
    assert sum(1 for keep, _ in flat if keep) == n_slow
    assert all(reason == "slow" for keep, reason in flat if keep)


def test_tracer_tail_sampling_keeps_slow_folds_all():
    sampler = TailSampler(window_s=1e6, epochs=4, margin=2.0, head_every=0, min_count=8)
    tr = Tracer(metrics=MetricsRegistry(), sampler=sampler)
    rng = np.random.default_rng(2)
    for k in range(20):
        healthy = float(rng.uniform(0.01, 0.02))
        tr.finish(tr.begin(name=f"r{k}", t0=0.0), t_end=healthy)
    assert tr.traces() == []  # all healthy: no span tree retained
    t = tr.begin(name="slow", t0=0.0)
    tr.finish(t, t_end=5.0)
    assert tr.last() is t
    assert t.root.attrs["sampled"] == "slow"
    # aggregates stay unbiased: every request folded, kept or not
    assert tr.metrics.snapshot(now=5.0)["request_s/all"]["count"] == 21
    assert sampler.stats["seen"] == 21
    assert sampler.stats["kept"] == sampler.stats["kept_slow"] == 1


# ---------------------------------------------------------------------------
# simulator: transfer_table hook + draw neutrality of the full stack
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["scalar", "numpy", "torch"])
def test_transfer_table_overrides_edges_on_every_backend(backend):
    seeds = (0,) if backend == "torch" else None

    def run(table):
        simulator = sm.WorkflowSimulator(
            sm.paper_platforms(), seed=7, transfer_table=table
        )
        return np.asarray(
            simulator.simulate(_doc_spec(n=8, seeds=seeds), backend=backend,
                               device=CPU)
        )

    base = run(None)
    assert np.array_equal(base, run({}))  # empty table: bit-for-bit neutral
    slow = run({("check", "ocr"): 50.0})  # pinned edge lands on the path
    assert np.all(slow >= base + 40.0)
    fast = run({e: 0.0 for e in DOC_EDGES})  # free edges only ever help
    assert np.all(fast <= base + 1e-9)


@pytest.mark.parametrize("backend", ["scalar", "numpy", "torch"])
def test_level2_stack_is_draw_neutral(backend):
    """Windowed metrics + tail sampler attached must not consume, reorder,
    or perturb a single draw on any backend."""
    seeds = (0, 1) if backend == "torch" else None
    off = sm.WorkflowSimulator(sm.paper_platforms(), seed=7).simulate(
        _doc_spec(n=16, seeds=seeds), backend=backend, device=CPU
    )
    tracer = Tracer(
        metrics=MetricsRegistry(window_s=60.0),
        sampler=TailSampler(window_s=60.0, head_every=2, min_count=4),
    )
    simulator = sm.WorkflowSimulator(sm.paper_platforms(), seed=7)
    on = simulator.simulate(
        _doc_spec(n=16, seeds=seeds, tracer=tracer), backend=backend, device=CPU
    )
    assert np.array_equal(off, on), "sampling/windowing perturbed the draws"
    assert tracer.metrics.snapshot()  # the stack actually saw the run


# ---------------------------------------------------------------------------
# calibration + what-if profiler
# ---------------------------------------------------------------------------
def test_calibrate_replays_the_observed_trace():
    tracer = Tracer()
    simulator = sm.WorkflowSimulator(sm.paper_platforms(), seed=3)
    simulator.simulate(_doc_spec(n=1, tracer=tracer), backend="scalar")
    trace = tracer.last()
    world = calibrate(trace)
    replay = Tracer()
    world.simulator(seed=0).simulate(
        world.spec(n_requests=1, tracer=replay), backend="scalar"
    )
    assert replay.last().total_s == pytest.approx(trace.total_s, rel=0.05)
    # the torch backend replays the same world (its own draws, sigma 0)
    torch_replay = Tracer(sample=1)
    world.simulator(seed=0).simulate(
        world.spec(n_requests=1, seeds=(0,), tracer=torch_replay), device=CPU
    )
    assert torch_replay.last().total_s == pytest.approx(replay.last().total_s,
                                                        rel=1e-9)


def _fetch_world(M, O):
    return O.CalibratedWorkflow(
        platforms=(M.SimPlatform("p", "r", cold_start=M.Dist(0.0, 0.0)),),
        steps=(
            M.SimStep("a", "p", compute=M.Dist(0.3, 0.0)),
            M.SimStep(
                "b",
                "p",
                compute=M.Dist(0.3, 0.0),
                fetch=M.Dist(2.0, 0.0),
                prefetch=False,
            ),
        ),
        edges=(("a", "b"),),
        transfer_table={("a", "b"): 0.05},
        msg_latency_s=0.0,
        prefetch=False,
    )


def _assert_same_ranking(got, want):
    assert [(iv.kind, iv.target) for iv in got] == [(iv.kind, iv.target)
                                                    for iv in want]
    for g, w in zip(got, want):
        assert g.baseline_s == pytest.approx(w.baseline_s, rel=1e-9)
        assert g.predicted_s == pytest.approx(w.predicted_s, rel=1e-9)
        assert g.delta_s == pytest.approx(w.delta_s, rel=1e-9, abs=1e-12)
        assert g.label == w.label


def test_profiler_fetch_speedup_beats_compute_on_fetch_dominated_flow():
    """The causal-profiling regression: on a fetch-dominated workflow a
    virtual 2x fetch speedup must predict a strictly larger p95 win than
    the same speedup applied to compute — on the torch backend, ranked as
    the JAX package's numpy backend ranks it."""
    world = _fetch_world(sm, TO)
    ranked = WhatIfProfiler(world, n_requests=40, device=CPU).rank(speedup=2.0)
    by = {(iv.kind, iv.target): iv for iv in ranked}
    fetch, compute = by[("fetch", "b")], by[("compute", "b")]
    assert fetch.delta_s == pytest.approx(-1.0, rel=0.01)  # 2 s serial fetch
    assert compute.delta_s == pytest.approx(-0.15, rel=0.01)
    assert fetch.delta_s < compute.delta_s < 0
    assert ranked[0] is fetch  # the fetch fix tops the ranking
    assert "fetch b" in fetch.label and fetch.delta_pct < 0
    ref = RO.WhatIfProfiler(_fetch_world(J, RO), n_requests=40).rank(speedup=2.0)
    _assert_same_ranking(ranked, ref)


@pytest.mark.parametrize("prefetch", [True, False])
def test_profiler_torch_ranking_equals_reference_numpy(prefetch):
    """Calibrate from one Fig-4 request traced by the scalar backend (the
    same trace in both packages), then rank every intervention: the port's
    torch backend on the CPU and its numpy backend against the JAX
    package's numpy backend, at sigma 0 — same order, deltas within 1e-9
    relative; the torch ranking's sweeps run the cold scan."""
    traces = {}
    for M, O in ((sm, TO), (J, RO)):
        tracer = O.Tracer()
        sim = M.WorkflowSimulator(M.paper_platforms(), seed=3)
        steps = [s if prefetch or s.name != "ocr" else replace(s, prefetch=False)
                 for s in M.document_workflow_fig4()]
        sim.simulate(M.ExperimentSpec(steps, edges=DOC_EDGES, n_requests=1,
                                      tracer=tracer), backend="scalar")
        traces[M] = tracer.last()
    calls = []
    saved = torchsim.cold_scan

    def recorded(*args):
        calls.append(args[1].shape)
        return saved(*args)

    torchsim.cold_scan = recorded
    try:
        got = WhatIfProfiler(calibrate(traces[sm]), n_requests=64,
                             device=CPU).rank()
    finally:
        torchsim.cold_scan = saved
    host = WhatIfProfiler(calibrate(traces[sm]), n_requests=64,
                          backend="numpy").rank()
    want = RO.WhatIfProfiler(RO.calibrate(traces[J]), n_requests=64).rank()
    assert len(want) >= 6
    _assert_same_ranking(got, want)
    _assert_same_ranking(host, want)
    assert len(calls) == 4 * (len(want) + 1)  # 4 nodes per sweep, + baseline
    top = profile_trace(traces[sm], top=3, n_requests=64, device=CPU)
    _assert_same_ranking(top, want[:3])


# ---------------------------------------------------------------------------
# controller: the slo trigger
# ---------------------------------------------------------------------------
def _costs(compute=None):
    compute = compute or {}
    return PlacementCosts(
        fetch_s=lambda name, p, deps: 0.25 * len(deps),
        compute_s=lambda name, p: compute.get((name, p), 0.1),
        transfer_s=lambda a, b, size: 0.0 if a == b else 0.5,
        payload_size=1.5e6,
    )


def _chain(work="pA"):
    return DagSpec(
        (
            DagStep("ingest", "edge"),
            DagStep("work", work),
            DagStep("deliver", "edge"),
        ),
        (("ingest", "work"), ("work", "deliver")),
        "t",
    )


def test_controller_slo_trigger_fires_once_per_episode():
    hub = TelemetryHub(alpha=1.0)
    tracer = Tracer()
    slo = SloTracker(
        SloSpec(
            "p95",
            objective_s=0.1,
            target=0.9,
            fast_window_s=10.0,
            slow_window_s=10.0,
            burn_threshold=1.0,
            min_count=4,
        ),
        tracer=tracer,
    )
    ctrl = RecompositionController(
        hub,
        _costs(compute={("work", "pA"): 0.1, ("work", "pB"): 0.2}),
        {"work": ["pA", "pB"]},
        every_n=10**9,  # cost triggers off: only the SLO can force a recompute
        drift_ratio=10**9,
        min_samples=1,
        tracer=tracer,
        slo=slo,
    )
    spec = _chain("pA")
    for k in range(6):  # healthy: never recomputes
        slo.record(0.05, now=float(k))
        assert ctrl.tick(spec) is None
    assert ctrl.stats["recomputes"] == 0
    # pA degrades: the SLO burns, and observed costs make pB the winner
    hub.record_compute("work", "pA", 5.0)
    for k in range(6, 12):
        slo.record(5.0, now=float(k))
    assert slo.alerts == 1
    placement = ctrl.tick(spec)
    assert placement is not None and placement["work"] == "pB"
    assert ctrl.stats["slo_triggers"] == 1 and ctrl.last_trigger == "slo"
    decision = [e for e in tracer.events if e[1] == "recompose.decision"][-1]
    assert decision[2]["trigger"] == "slo" and decision[2]["slo"] == "p95"
    # latched: still burning, but the episode was handled — no re-recompute
    spec = spec.apply_placement(placement)
    slo.record(5.0, now=12.0)
    assert ctrl.tick(spec) is None
    assert ctrl.stats["recomputes"] == 1
