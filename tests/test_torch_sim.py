"""The port's torch simulator backend against the JAX package's numpy
backend: agreement to 1e-9 in float64 wherever randomness cancels (sigma 0
on chains, DAGs, mixed prefetch flags, cold regimes, drift, streaming and
faults), statistical agreement where it does not (medians and p99 within
1%), the CRN property across a batched placement set, its own frozen draw
reference, and the guard rails. These are the gates of
``tests/test_jaxsim.py``, re-pointed: the reference's jax backend is the
counterpart, and it mirrors the numpy backend operation for operation. All
sweeps here run with ``device="cpu"``."""
import math
from dataclasses import replace

import numpy as np
import pytest

import repro.core.simulator as J
import repro.dag.sim as jdsim
import repro_torch.core.simulator as S
import repro_torch.dag.sim as tdsim
from repro_torch.obs import Tracer
from repro_torch.core import torchsim
from repro_torch.kernels.cold_scan import cold_scan

ATOL = 1e-9  # sigma-0 gap budget: reassociated float ops, not different math
CPU = "cpu"


def _zero_sigma(M, steps):
    return [replace(s, compute=M.Dist(s.compute.median, 0.0),
                    fetch=M.Dist(s.fetch.median, 0.0)) for s in steps]


def _zero_platforms(M, keep_warm=None):
    return [replace(p, cold_start=M.Dist(p.cold_start.median, 0.0),
                    **({} if keep_warm is None else {"keep_warm_s": keep_warm}))
            for p in M.paper_platforms()]


def _both(recipe):
    """numpy totals of the JAX package, torch totals of the port, for the
    same experiment built in each package."""
    jsim, jspec = recipe(J)
    tsim, tspec = recipe(S)
    return (jsim.simulate(jspec, backend="numpy"),
            tsim.simulate(tspec, backend="torch", device=CPU))


# ---------------------------------------------------------------------------
# sigma 0: identical arithmetic, so the backends agree to float noise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("workflow", ["fig4", "fig6", "fig8"])
def test_sigma0_chain_matches_numpy(workflow, prefetch):
    def recipe(M):
        steps = {"fig4": M.document_workflow_fig4,
                 "fig6": lambda: M.shipping_workflow_fig6("lambda-eu-central-1"),
                 "fig8": M.native_prefetch_workflow_fig8}[workflow]()
        return (M.WorkflowSimulator(_zero_platforms(M), seed=0),
                M.ExperimentSpec(_zero_sigma(M, steps), n_requests=50,
                                 prefetch=prefetch, seeds=(0,)))

    a, b = _both(recipe)
    assert b.shape == a.shape == (1, 50)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


@pytest.mark.parametrize("prefetch", [True, False])
def test_sigma0_dag_matches_numpy(prefetch):
    def recipe(M):
        raw, edges = (jdsim if M is J else tdsim).document_dag_fig4()
        return (M.WorkflowSimulator(_zero_platforms(M), seed=0),
                M.ExperimentSpec(_zero_sigma(M, raw), edges=edges, n_requests=40,
                                 prefetch=prefetch, seeds=(0,)))

    a, b = _both(recipe)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


def test_sigma0_mixed_prefetch_flags_dag():
    """A node with prefetch=False inside a prefetch-on experiment: poked
    reachability must flow around it identically on both backends."""
    def recipe(M):
        steps = [
            M.SimStep("a", "tinyfaas-edge", compute=M.Dist(0.2, 0.0)),
            M.SimStep("b", "gcf", compute=M.Dist(0.3, 0.0), fetch=M.Dist(0.4, 0.0)),
            M.SimStep("c", "lambda-us-east-1", compute=M.Dist(0.5, 0.0),
                      fetch=M.Dist(0.6, 0.0), prefetch=False),
            M.SimStep("d", "lambda-eu-central-1", compute=M.Dist(0.25, 0.0),
                      fetch=M.Dist(0.9, 0.0)),
        ]
        edges = [("a", "b"), ("a", "c"), ("b", "d"), ("c", "d")]
        return (M.WorkflowSimulator(_zero_platforms(M), seed=0),
                M.ExperimentSpec(steps, edges=edges, n_requests=60, seeds=(0,)))

    a, b = _both(recipe)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sigma0_cold_regime_matches_numpy(dtype):
    """Arrival gaps straddle keep_warm: the sequential cold recurrence is
    live, so the cold scan decides the totals."""
    def recipe(M):
        return (M.WorkflowSimulator(_zero_platforms(M, keep_warm=2.5), seed=0),
                M.ExperimentSpec(_zero_sigma(M, M.document_workflow_fig4()),
                                 n_requests=80, interarrival_s=3.0, seeds=(0,)))

    jsim, jspec = recipe(J)
    tsim, tspec = recipe(S)
    a = jsim.simulate(jspec, backend="numpy")
    b = tsim.simulate_placements(tspec, [tspec.steps], dtype=dtype, device=CPU)[:, 0]
    assert b.dtype == dtype
    # float32: arrival times reach 240 s, where one f32 ulp is 1.5e-5 s
    np.testing.assert_allclose(b, a, atol=ATOL if dtype == np.float64 else 1e-4,
                               rtol=0)
    assert 0 < np.mean(a > np.median(a)) < 1  # cold and warm requests both


def test_sigma0_drift_matches_numpy():
    def recipe(M):
        drift = M.DriftSchedule([
            M.DriftEvent(at_request=10, platform="gcf", compute_scale=3.0,
                         transfer_scale=2.0, fetch_scale=1.5),
            M.DriftEvent(at_request=25, platform="lambda-us-east-1",
                         transfer_scale=4.0),
        ])
        return (M.WorkflowSimulator(_zero_platforms(M), seed=0, drift=drift),
                M.ExperimentSpec(_zero_sigma(M, M.document_workflow_fig4()),
                                 n_requests=40, seeds=(0,)))

    a, b = _both(recipe)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


@pytest.mark.parametrize("chunks", [1, 8])
def test_sigma0_streaming_matches_numpy(chunks):
    def recipe(M):
        return (M.WorkflowSimulator(_zero_platforms(M), seed=3,
                                    stream=M.StreamConfig(chunks=chunks)),
                M.ExperimentSpec(_zero_sigma(M, M.document_workflow_fig4()),
                                 n_requests=20, seeds=(0,)))

    a, b = _both(recipe)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)


def test_sigma0_faults_match_numpy():
    """The shared hash-based fault plane: the same requests die, and the
    retry-extended latencies of the rest agree."""
    def recipe(M):
        sched = M.FaultSchedule([
            M.FaultEvent("gcf", p_error=0.3, from_request=5, to_request=30),
            M.OutageEvent(from_request=10, to_request=20,
                          platform="lambda-us-east-1"),
        ], seed=7)
        return (M.WorkflowSimulator(_zero_platforms(M), seed=3),
                M.ExperimentSpec(_zero_sigma(M, M.document_workflow_fig4()),
                                 n_requests=48, seeds=(0,), faults=sched,
                                 retry=M.RetryPolicy(max_attempts=3,
                                                     backoff_base_s=0.05)))

    a, b = _both(recipe)
    dead = np.isinf(a)
    assert dead.any() and (~dead).any()
    assert np.array_equal(np.isinf(b), dead)
    np.testing.assert_allclose(b[~dead], a[~dead], atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# "off" equals its degenerate settings bit for bit
# ---------------------------------------------------------------------------
def _fig4(n=20, seed=3, **spec_kw):
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=seed)
    return np.asarray(sim.simulate(
        S.ExperimentSpec(S.document_workflow_fig4(), n_requests=n, **spec_kw),
        backend="torch", device=CPU))


def test_single_chunk_stream_is_bit_for_bit_off():
    off = _fig4(seeds=(3, 4))
    on = _fig4(seeds=(3, 4), stream=S.StreamConfig(chunks=1))
    assert np.array_equal(off, on)


def test_empty_fault_schedule_is_bit_for_bit_off():
    off = _fig4(n=48)
    on = _fig4(n=48, faults=S.FaultSchedule(()), retry=None)
    assert np.array_equal(off, on)


# ---------------------------------------------------------------------------
# frozen reference: the torch draw contract
# ---------------------------------------------------------------------------
# Per seed: torch.Generator().manual_seed(seed) draws the cold, fetch and
# compute (n_nodes, n_requests) normal blocks in that order, node-major in
# topo order, in float64 rounded to float32; factors exp(sigma * z) with the
# product in float32 and the exponential in float64. The tables are made on
# the host, so these numbers hold on the CPU and on the card. Regenerating
# them requires an intentional, documented change to that contract (or to
# the recurrence itself).
FROZEN_TORCH_FIG4 = [
    3.520311076045037,
    2.458920524120331,
    2.4928639328479765,
    2.192564869523048,
]


def test_frozen_reference_torch_backend():
    out = _fig4(n=4, seeds=(3,))
    assert out[0].tolist() == pytest.approx(FROZEN_TORCH_FIG4, abs=1e-9)
    again = _fig4(n=4, seeds=(3,), stream=S.StreamConfig(chunks=1))
    assert np.array_equal(out, again)


# ---------------------------------------------------------------------------
# statistical equivalence with spread on
# ---------------------------------------------------------------------------
def test_median_and_p99_agree_within_1pct():
    """Different rngs, same distributions: pooled (3 pinned seeds x 4000
    requests) medians and p99s within 1% — deterministic, not flaky."""
    def recipe(M):
        return (M.WorkflowSimulator(M.paper_platforms(), seed=0),
                M.ExperimentSpec(M.document_workflow_fig4(), n_requests=4000,
                                 seeds=(0, 1, 2)))

    a, b = _both(recipe)
    assert b.shape == (3, 4000)
    assert np.median(b) == pytest.approx(np.median(a), rel=0.01)
    assert np.percentile(b, 99) == pytest.approx(np.percentile(a, 99), rel=0.01)


# ---------------------------------------------------------------------------
# the placement axis: CRN across a batched candidate set
# ---------------------------------------------------------------------------
def test_batched_placements_share_draws_crn():
    """The same placement listed twice yields bit-identical rows, and a
    solo sweep of a placement equals its row in the batch: the tables are
    made per seed on the host, so batching changes no number."""
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=0)
    fig4 = S.document_workflow_fig4()
    placements = [fig4, _zero_sigma(S, fig4), fig4]
    spec = S.ExperimentSpec(fig4, n_requests=100, seeds=(5, 6))
    both = sim.simulate_placements(spec, placements, device=CPU)
    assert both.shape == (2, 3, 100)
    assert np.array_equal(both[:, 0, :], both[:, 2, :])  # CRN, bit-exact
    assert not np.array_equal(both[:, 0, :], both[:, 1, :])
    for j, steps in enumerate(placements[:2]):
        solo = sim.simulate_placements(replace(spec, steps=tuple(steps)), [steps],
                                       device=CPU)
        np.testing.assert_allclose(both[:, j, :], solo[:, 0, :], rtol=1e-12)


def test_moved_step_changes_keep_warm_per_row():
    """Placements that put a step on platforms with different keep_warm_s
    share one cold-scan launch per node; each row still equals the numpy
    backend run of its own placement (sigma 0, cold regime)."""
    def plats(M):
        return [replace(p, cold_start=M.Dist(p.cold_start.median, 0.0),
                        keep_warm_s=kw)
                for p, kw in zip(M.paper_platforms(), (900.0, 2.5, 3.5, 0.5))]

    def placements(M):
        base = _zero_sigma(M, M.document_workflow_fig4())
        return [base] + [[replace(s, platform=p) if s.name == "ocr" else s
                          for s in base]
                         for p in ("gcf", "lambda-eu-central-1", "tinyfaas-edge")]

    tsim = S.WorkflowSimulator(plats(S), seed=0)
    spec = S.ExperimentSpec(placements(S)[0], n_requests=60, interarrival_s=3.0,
                            seeds=(0, 1))
    got = tsim.simulate_placements(spec, placements(S), device=CPU)
    jsim = J.WorkflowSimulator(plats(J), seed=0)
    for j, steps in enumerate(placements(J)):
        want = jsim.simulate(J.ExperimentSpec(steps, n_requests=60,
                                              interarrival_s=3.0, seeds=(0,)),
                             backend="numpy")
        np.testing.assert_allclose(got[:, j], np.repeat(want, 2, axis=0),
                                   atol=ATOL, rtol=0)
    assert len({tuple(np.round(r, 9)) for r in got[0]}) == 4


def test_batched_sweep_is_deterministic():
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=0)
    fig4 = S.document_workflow_fig4()
    spec = S.ExperimentSpec(fig4, n_requests=64, seeds=(1, 2))
    a = sim.simulate_placements(spec, [fig4, _zero_sigma(S, fig4)], device=CPU)
    b = sim.simulate_placements(spec, [fig4, _zero_sigma(S, fig4)], device=CPU)
    assert np.array_equal(a, b)


def test_simulate_placements_default_seed_and_f32():
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=11)
    steps = S.document_workflow_fig4()
    spec = S.ExperimentSpec(steps, n_requests=64)
    out = sim.simulate_placements(spec, [steps], device=CPU)
    assert out.shape == (1, 1, 64)  # seeds=None -> the construction seed
    named = sim.simulate_placements(replace(spec, seeds=(11,)), [steps], device=CPU)
    assert np.array_equal(out, named)
    lo = sim.simulate_placements(spec, [steps], dtype=np.float32, device=CPU)
    assert lo.dtype == np.float32
    assert np.median(lo) == pytest.approx(np.median(out), rel=1e-4)


def test_sample_idx_columns_match_totals():
    """The sampled per-node values rebuild the totals: the sink's end at a
    sampled request minus its arrival is that request's total."""
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=2)
    steps = S.document_workflow_fig4()
    order, smap, preds, succs = S._spec_graph(steps, None)
    t0s = np.arange(30) * 1.0
    idx = np.array([0, 7, 29])
    totals, sampled = torchsim.run_batched(
        sim, order, [smap, smap], preds, succs, t0s, True, [4, 5],
        sample_idx=idx, device=CPU)
    payload, cold, fetch, compute, end = sampled
    assert end.shape == (2, 2, len(order), 3)
    np.testing.assert_allclose(end[:, :, -1, :] - t0s[idx], totals[:, :, idx],
                               rtol=0, atol=1e-12)
    assert (compute > 0).all() and (cold >= 0).all() and (fetch >= 0).all()
    np.testing.assert_allclose(payload[:, :, 0, :], np.broadcast_to(
        t0s[idx] + sim.msg / 2, payload[:, :, 0, :].shape))
    assert (cold[..., 0] > 0).any() and (cold[..., 1:] == 0).all()  # request 0 cold
    plain = torchsim.run_batched(sim, order, [smap, smap], preds, succs, t0s, True,
                                 [4, 5], device=CPU)
    assert np.array_equal(plain, totals)


def test_torch_tracer_raises_until_obs_is_ported():
    """The torch backend with a tracer (the name dates from before ``obs``
    was ported, when this raised): a tracer on the spec and one on the
    simulator each give the untraced totals bit for bit and ``sample``
    traces of the first seed, equal to each other; the simulator's own
    tracer is left in place and the spec's is not kept."""
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=3)
    spec = S.ExperimentSpec(S.document_workflow_fig4(), n_requests=10, seeds=(0, 1))
    off = sim.simulate(spec, backend="torch", device=CPU)
    on_spec = Tracer(sample=3)
    got = sim.simulate(replace(spec, tracer=on_spec), backend="torch", device=CPU)
    assert np.array_equal(got, off) and sim.tracer is None
    sim.tracer = on_sim = Tracer(sample=3)
    assert np.array_equal(sim.simulate(spec, backend="torch", device=CPU), off)
    assert sim.tracer is on_sim
    for tracer in (on_spec, on_sim):
        traces = tracer.traces()
        assert [t.root.attrs["request_k"] for t in traces] == [0, 4, 9]
        assert all(t.root.attrs["backend"] == "torch" for t in traces)
        for t in traces:
            assert set(t.node_spans()) == {"check", "virus", "ocr", "e_mail"}
            assert t.total_s == pytest.approx(off[0, t.root.attrs["request_k"]],
                                              rel=1e-12)
    assert [[(n, s.t_start, s.t_end) for n, s in sorted(t.node_spans().items())]
            for t in on_spec.traces()] == [
        [(n, s.t_start, s.t_end) for n, s in sorted(t.node_spans().items())]
        for t in on_sim.traces()]


# ---------------------------------------------------------------------------
# guard rails
# ---------------------------------------------------------------------------
def test_default_device_raises_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=0)
    spec = S.ExperimentSpec(S.document_workflow_fig4(), n_requests=4)
    cold_scan.launches = 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.simulate(spec)  # the torch backend is the default
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.simulate(spec, backend="torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.simulate_placements(spec, [spec.steps])
    assert cold_scan.launches == 0


def test_unknown_backend_and_device_raise():
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=0)
    spec = S.ExperimentSpec(S.document_workflow_fig4(), n_requests=4)
    with pytest.raises(ValueError, match="unknown backend"):
        sim.simulate(spec, backend="jax")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sim.simulate(spec, backend="torch", device="meta")


def test_simulate_placements_requires_placements():
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=0)
    spec = S.ExperimentSpec(S.document_workflow_fig4(), n_requests=4)
    with pytest.raises(ValueError, match="non-empty"):
        sim.simulate_placements(spec, [], device=CPU)


def test_torch_rejects_timing_controller():
    from repro_torch.core.timing import PokeTimingController

    sim = S.WorkflowSimulator(S.paper_platforms(), seed=0,
                              timing=PokeTimingController())
    with pytest.raises(ValueError, match="timing"):
        sim.simulate(S.ExperimentSpec(S.document_workflow_fig4(), n_requests=4),
                     backend="torch", device=CPU)


def test_torch_rejects_telemetry():
    from repro_torch.adapt import TelemetryHub

    sim = S.WorkflowSimulator(S.paper_platforms(), seed=0, telemetry=TelemetryHub())
    with pytest.raises(ValueError, match="telemetry"):
        sim.simulate(S.ExperimentSpec(S.document_workflow_fig4(), n_requests=4),
                     backend="torch", device=CPU)


def test_torch_rejects_duplicate_name_platform_nodes():
    steps = [S.SimStep("f", "gcf", compute=S.Dist(0.1)),
             S.SimStep("f", "gcf", compute=S.Dist(0.1))]
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=0)
    with pytest.raises(ValueError, match="unique"):
        sim.simulate(S.ExperimentSpec(steps, n_requests=4), backend="torch",
                     device=CPU)


def test_torch_zero_requests_and_infinite_keep_warm():
    sim = S.WorkflowSimulator(S.paper_platforms(), seed=0)
    out = sim.simulate(S.ExperimentSpec(S.document_workflow_fig4(), n_requests=0),
                       backend="torch", device=CPU)
    assert out.shape == (0,)

    def recipe(M):
        plats = [M.SimPlatform("p", "r", native_prefetch=True,
                               cold_start=M.Dist(0.5, 0.0), keep_warm_s=math.inf)]
        steps = [M.SimStep("a", "p", compute=M.Dist(0.2, 0.0))]
        return (M.WorkflowSimulator(plats, seed=0),
                M.ExperimentSpec(steps, n_requests=8, seeds=(0,)))

    a, b = _both(recipe)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=0)
