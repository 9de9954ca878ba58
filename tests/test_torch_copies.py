"""Behaviour pins for the modules the port copies from the JAX package:
placement (``place_chain`` / ``place_dag`` / ``dag_cost``), the fault
model, the timing controller, workflow specs and the architecture configs
give identical results in both packages."""
import dataclasses
import random

import numpy as np
import pytest

import repro.configs.registry as jreg
import repro.core.faults as jfaults
import repro.core.shipping as jship
import repro.core.timing as jtiming
import repro.core.workflow as jwf
import repro_torch.configs.registry as treg
import repro_torch.core.faults as tfaults
import repro_torch.core.shipping as tship
import repro_torch.core.timing as ttiming
import repro_torch.core.workflow as twf

PLATFORMS = ["p0", "p1", "p2"]


def _random_dag(rng: random.Random, n: int):
    names = [f"s{i}" for i in range(n)]
    edges = []
    for j in range(1, n):
        preds = rng.sample(names[:j], k=rng.randint(1, min(2, j)))
        edges += [(p, names[j]) for p in preds]
    return names, edges


def _costs(ship, rng: random.Random):
    fetch = {(n, p): rng.uniform(0, 2) for n in range(10) for p in PLATFORMS}
    comp = {(n, p): rng.uniform(0.1, 1) for n in range(10) for p in PLATFORMS}
    xfer = {(a, b): 0.0 if a == b else rng.uniform(0, 1)
            for a in PLATFORMS for b in PLATFORMS}

    def idx(name):
        return int(str(name).lstrip("s"))

    return ship.PlacementCosts(
        fetch_s=lambda n, p, d: fetch[(idx(n), p)] if d else 0.0,
        compute_s=lambda n, p: comp[(idx(n), p)],
        transfer_s=lambda a, b, s: xfer[(a, b)],
    )


def _nodes(wf, names, rng: random.Random):
    return {n: wf.StepSpec(n, "p0", data_deps=(wf.DataRef(f"d/{n}"),)
                           if rng.random() < 0.5 else ())
            for n in names}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("prefetch", [True, False])
def test_place_dag_and_dag_cost_equal(seed, prefetch):
    results = []
    for ship, wf in ((jship, jwf), (tship, twf)):
        rng = random.Random(seed)
        names, edges = _random_dag(rng, 5 + seed % 3)
        nodes = _nodes(wf, names, rng)
        costs = _costs(ship, rng)
        cand = {n: PLATFORMS for n in names}
        placement = ship.place_dag(nodes, edges, cand, costs, prefetch)
        greedy = ship.place_dag_greedy(nodes, edges, cand, costs, prefetch)
        results.append((placement, greedy,
                        ship.dag_cost(nodes, edges, placement, costs, prefetch),
                        ship.dag_cost(nodes, edges, greedy, costs, prefetch)))
    assert results[0] == results[1]


@pytest.mark.parametrize("seed", range(3))
def test_place_chain_and_chain_cost_equal(seed):
    results = []
    for ship, wf in ((jship, jwf), (tship, twf)):
        rng = random.Random(seed)
        steps = tuple(wf.StepSpec(f"s{i}", "p0") for i in range(4))
        spec = wf.WorkflowSpec(steps, "chain")
        costs = _costs(ship, rng)
        placed = ship.place_chain(spec, {s.name: PLATFORMS for s in steps}, costs)
        results.append(([s.platform for s in placed.steps],
                        ship.chain_cost(placed, costs)))
    assert results[0] == results[1]


def _schedule(f, seed):
    return f.FaultSchedule(
        (f.FaultEvent("p0", 0.3), f.FaultEvent("p1", 0.6, step="b", from_request=5),
         f.OutageEvent(10, 14, platform="p2"), f.OutageEvent(20, None, region="eu")),
        seed=seed)


@pytest.mark.parametrize("seed", [0, 7])
def test_fault_schedule_outcomes_equal(seed):
    ks = np.arange(40)
    for step, plat, region in (("a", "p0", "us"), ("b", "p1", "us"),
                               ("a", "p2", "us"), ("c", "p3", "eu")):
        planes = [_schedule(f, seed).plane(step, plat, ks,
                                           f.RetryPolicy(max_attempts=3, seed=seed),
                                           region=region)
                  for f in (jfaults, tfaults)]
        for a, b in zip(*planes):
            np.testing.assert_array_equal(a, b)
        outs = [[_schedule(f, seed).attempt_outcome(step, plat, k, att, region)
                 for k in range(40) for att in range(3)] for f in (jfaults, tfaults)]
        assert outs[0] == outs[1]
    assert (jfaults.RetryPolicy(seed=seed).backoff_s(1, "a", "p0", 3)
            == tfaults.RetryPolicy(seed=seed).backoff_s(1, "a", "p0", 3))


def test_poke_timing_controller_equal():
    reports = []
    for t in (jtiming, ttiming):
        c = t.PokeTimingController("learned")
        for i in range(20):
            c.record_compute("a", 0.1 + 0.01 * i)
            c.record_prepare("b", 0.05)
            c.record_slack("a", "b", 0.2 - 0.005 * i)
        reports.append((c.poke_delay("a", "b"), c.report()))
    assert reports[0] == reports[1]


def test_workflow_json_round_trip_equal():
    for wf in (jwf, twf):
        spec = wf.WorkflowSpec((wf.StepSpec("a", "p0", (wf.DataRef("k", "us", 10),)),
                                wf.StepSpec("b", "p1", prefetch=False)), "w")
        assert wf.WorkflowSpec.from_json(spec.to_json()) == spec
    j = jwf.WorkflowSpec((jwf.StepSpec("a", "p0"),), "w").to_json()
    t = twf.WorkflowSpec((twf.StepSpec("a", "p0"),), "w").to_json()
    assert j == t


@pytest.mark.parametrize("make", ["get_config", "smoke_config"])
def test_arch_config_fields_equal(make):
    j = getattr(jreg, make)("qwen3-1.7b")
    t = getattr(treg, make)("qwen3-1.7b")
    jf, tf = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jf.pop("source") == "hf:Qwen/Qwen3-8B; hf"
    assert tf.pop("source") == "hf:Qwen/Qwen3-1.7B; hf"
    assert tf == jf
    assert t.layer_kinds() == j.layer_kinds()
    assert (t.q_dim, t.kv_dim) == (j.q_dim, j.kv_dim)


@pytest.mark.parametrize("make", ["get_config", "smoke_config"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_arch_config_fields_equal(arch, make):
    """The recurrent configs are verbatim copies, source string included."""
    j = getattr(jreg, make)(arch)
    t = getattr(treg, make)(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.layer_kinds() == j.layer_kinds()
    assert (t.d_inner, t.ssm_heads) == (j.d_inner, j.ssm_heads)


@pytest.mark.parametrize("make", ["get_config", "smoke_config"])
def test_granite_config_fields_equal_but_source(make):
    """The reference's granite names the 1b-a400m model as its source; its
    dimensions are granite-3.0-3b-a800m's, which the port's copy names."""
    j = getattr(jreg, make)("granite-moe-3b-a800m")
    t = getattr(treg, make)("granite-moe-3b-a800m")
    jf, tf = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jf.pop("source") == "hf:ibm-granite/granite-3.0-1b-a400m-base; hf"
    assert tf.pop("source") == "hf:ibm-granite/granite-3.0-3b-a800m-base; hf"
    assert tf == jf
    assert t.layer_kinds() == j.layer_kinds()
    assert t.active_param_count() == j.active_param_count()


@pytest.mark.parametrize("make", ["get_config", "smoke_config"])
def test_moonshot_config_fields_equal(make):
    """A verbatim copy, source string included."""
    j = getattr(jreg, make)("moonshot-v1-16b-a3b")
    t = getattr(treg, make)("moonshot-v1-16b-a3b")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.active_param_count() == j.active_param_count()


# the reference's source string, the port's: each names the checkpoint
# whose widths the config carries (hubert-xlarge's paper stands)
SOURCES = {
    "llama3.2-3b": ("hf:meta-llama/Llama-3.2-1B; unverified",
                    "hf:meta-llama/Llama-3.2-3B; unverified"),
    "gemma3-27b": ("hf:google/gemma-3-1b-pt; unverified",
                   "hf:google/gemma-3-27b-pt; unverified"),
    "qwen3-32b": ("hf:Qwen/Qwen3-8B; hf", "hf:Qwen/Qwen3-32B; hf"),
    "hubert-xlarge": ("arXiv:2106.07447; unverified",
                      "arXiv:2106.07447; unverified"),
    "llava-next-34b": ("hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
                       "hf:llava-hf/llava-v1.6-34b-hf; unverified"),
}


@pytest.mark.parametrize("make", ["get_config", "smoke_config"])
@pytest.mark.parametrize("arch", list(SOURCES))
def test_served_config_fields_equal_but_source(arch, make):
    """Every field equal to the reference's, ``source`` excepted: four of
    the reference's name another checkpoint than the one whose widths they
    carry, and the port's copies name that one."""
    j = getattr(jreg, make)(arch)
    t = getattr(treg, make)(arch)
    jf, tf = dataclasses.asdict(j), dataclasses.asdict(t)
    assert (jf.pop("source"), tf.pop("source")) == SOURCES[arch]
    assert tf == jf
    assert t.layer_kinds() == j.layer_kinds()
    assert (t.q_dim, t.kv_dim) == (j.q_dim, j.kv_dim)
    assert t.param_count() == j.param_count()


def test_registry_lists_only_ported_configs():
    """The port lists the reference's ten archs, in its order."""
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert len(treg.ARCH_IDS) == 10
    for arch in treg.ARCH_IDS:
        assert treg._MODULES[arch] == jreg._MODULES[arch].replace(
            "repro.", "repro_torch.", 1)
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# the simulator (scalar and numpy backends), dag.sim and adapt
# ---------------------------------------------------------------------------
import repro.adapt as jadapt  # noqa: E402
import repro.core.simulator as jsim  # noqa: E402
import repro.dag.sim as jdsim  # noqa: E402
import repro.dag.spec as jspec  # noqa: E402
import repro_torch.adapt as tadapt  # noqa: E402
import repro_torch.core.simulator as tsim  # noqa: E402
import repro_torch.dag.sim as tdsim  # noqa: E402
import repro_torch.dag.spec as tspec  # noqa: E402

SIM_PKGS = {"jax": (jsim, jdsim, jfaults), "torch": (tsim, tdsim, tfaults)}


def _sim_case(pkg, case):
    S, D, F = SIM_PKGS[pkg]
    plats, sim_kw, spec_kw = S.paper_platforms(), {}, {}
    steps, edges = S.document_workflow_fig4(), None
    if case == "dag_fig4":
        steps, edges = D.document_dag_fig4()
    elif case == "diamond":
        steps = [S.SimStep("a", "tinyfaas-edge", compute=S.Dist(0.2)),
                 S.SimStep("b", "gcf", compute=S.Dist(0.3), fetch=S.Dist(0.4)),
                 S.SimStep("c", "lambda-us-east-1", compute=S.Dist(0.5),
                           fetch=S.Dist(0.6), prefetch=False),
                 S.SimStep("d", "lambda-eu-central-1", compute=S.Dist(0.25),
                           fetch=S.Dist(0.9))]
        edges = [("a", "b"), ("a", "c"), ("b", "d"), ("c", "d")]
    elif case == "drift":
        sim_kw["drift"] = S.DriftSchedule([
            S.DriftEvent(10, "gcf", compute_scale=3.0, transfer_scale=2.0,
                         fetch_scale=1.5),
            S.DriftEvent(25, "lambda-us-east-1", transfer_scale=4.0)])
    elif case == "stream8":
        spec_kw["stream"] = S.StreamConfig(chunks=8)
    elif case == "faults":
        spec_kw["faults"] = F.FaultSchedule([
            F.FaultEvent("gcf", p_error=0.3, from_request=5, to_request=30),
            F.OutageEvent(from_request=10, to_request=20,
                          platform="lambda-us-east-1")], seed=7)
        spec_kw["retry"] = F.RetryPolicy(max_attempts=3, backoff_base_s=0.05)
    elif case == "cold":
        plats = [dataclasses.replace(p, keep_warm_s=2.5) for p in plats]
        spec_kw["interarrival_s"] = 3.0
    sim = S.WorkflowSimulator(plats, seed=3, **sim_kw)
    return sim, S.ExperimentSpec(steps, edges=edges, n_requests=48, **spec_kw)


@pytest.mark.parametrize("backend", ["scalar", "numpy"])
@pytest.mark.parametrize("case", ["chain_fig4", "dag_fig4", "diamond", "drift",
                                  "stream8", "faults", "cold"])
def test_simulator_backends_equal(case, backend):
    outs = []
    for pkg in ("jax", "torch"):
        sim, spec = _sim_case(pkg, case)
        one = sim.simulate(spec, backend=backend)
        many = sim.simulate(dataclasses.replace(spec, seeds=(0, 5)), backend=backend)
        outs.append((one, many))
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])


def test_simulator_request_traces_and_legacy_wrappers_equal():
    res = []
    for S, D in ((jsim, jdsim), (tsim, tdsim)):
        sim = S.WorkflowSimulator(S.paper_platforms(), seed=1)
        steps, edges = D.document_dag_fig4()
        chain = sim.run_request(S.document_workflow_fig4(), 0.0, prefetch=True)
        dag = sim.run_dag_request(steps, edges, 1.0, prefetch=False)
        res.append((dataclasses.astuple(chain), dag.total_s, dag.end,
                    sim.run_experiment(S.shipping_workflow_fig6("lambda-us-east-1"),
                                       n_requests=20).tolist(),
                    sim.run_experiment_many(S.native_prefetch_workflow_fig8(),
                                            seeds=(1, 2), n_requests=10).tolist(),
                    [dataclasses.asdict(s) for s in D.serialize_chain(steps, edges)]))
        assert D.DagWorkflowSimulator is S.WorkflowSimulator
    assert res[0] == res[1]


def test_dag_sim_shapes_equal():
    (js, je), (ts, te) = jdsim.document_dag_fig4(), tdsim.document_dag_fig4()
    assert [dataclasses.asdict(s) for s in js] == [dataclasses.asdict(s) for s in ts]
    assert je == te


def _adapt_stream(pkg, n, drift_at):
    """The simulated scenario of ``benchmarks/adapt_bench.py``: a 3-step
    chain, pA's compute degraded 5x at ``drift_at``, a controller fed by
    the simulator's telemetry ticking after every request."""
    S, A, spec_mod = ((jsim, jadapt, jspec) if pkg == "jax"
                      else (tsim, tadapt, tspec))
    ship = jship if pkg == "jax" else tship
    plats = [S.SimPlatform("client", "edge", native_prefetch=True,
                           cold_start=S.Dist(0.2, 0.2)),
             S.SimPlatform("pA", "region-a", cold_start=S.Dist(0.8, 0.3)),
             S.SimPlatform("pB", "region-b", cold_start=S.Dist(0.8, 0.3))]
    work = {"pA": S.Dist(1.0, 0.05), "pB": S.Dist(1.3, 0.05)}
    compute = {("ingest", "client"): 0.04, ("deliver", "client"): 0.04,
               ("work", "pA"): 1.0, ("work", "pB"): 1.3}
    costs = ship.PlacementCosts(
        fetch_s=lambda name, p, deps: 0.0,
        compute_s=lambda name, p: compute.get((name, p), 0.05),
        transfer_s=lambda a, b, size: 0.001 if a == b else 0.6,
        payload_size=1.5e6)
    hub = A.TelemetryHub(alpha=0.4)
    sim = S.WorkflowSimulator(plats, seed=11, telemetry=hub, drift=S.DriftSchedule(
        [S.DriftEvent(drift_at, "pA", compute_scale=5.0)]))
    ctrl = A.RecompositionController(
        hub, costs, {"work": ["pA", "pB"]},
        regions={"client": "edge", "pA": "region-a", "pB": "region-b"},
        every_n=8, drift_ratio=1.4, min_samples=2)
    spec = spec_mod.DagSpec((spec_mod.DagStep("ingest", "client"),
                             spec_mod.DagStep("work", "pA"),
                             spec_mod.DagStep("deliver", "client")),
                            (("ingest", "work"), ("work", "deliver")), "adapt")
    totals, swaps, observed = [], [], []
    for k in range(n):
        wp = spec.node("work").platform
        steps = [S.SimStep("ingest", "client", compute=S.Dist(0.04, 0.05)),
                 S.SimStep("work", wp, compute=work[wp]),
                 S.SimStep("deliver", "client", compute=S.Dist(0.04, 0.05))]
        totals.append(sim.run_request(steps, k * 1.0, prefetch=True).total_s)
        placement = ctrl.tick(spec)
        if placement is not None:
            spec = spec.apply_placement(placement)
            swaps.append((k, placement))
        if k % 16 == 0:
            oc = A.observed_costs(hub, costs)
            observed.append((oc.compute_s("work", "pA"), oc.compute_s("work", "pB"),
                             oc.transfer_s("client", "pA", 1.5e6)))
    return totals, swaps, dict(ctrl.stats), hub.snapshot(), observed


def test_adapt_telemetry_costs_and_controller_decisions_equal():
    j = _adapt_stream("jax", 120, 60)
    t = _adapt_stream("torch", 120, 60)
    assert j[1], "the drifted stream never recomposed"
    assert j == t


# -- launch/analytic.py: CellModel on every live cell at both H100 meshes ------
def _live_cells():
    from repro.configs.base import applicable_shapes
    return [(a, s.name) for a in jreg.ARCH_IDS
            for s in applicable_shapes(jreg.get_config(a))]


@pytest.mark.parametrize("arch,shape", _live_cells())
def test_cell_model_equal_on_h100_meshes(arch, shape):
    """The copy of ``repro/launch/analytic.py`` gives the reference's numbers
    for the cell on the single-pod (32 x 8) and multi-pod (2 x 32 x 8)
    meshes, at the dry-run's micro-batch plan, each on its own dry-run's
    cell defaults (equal but for the fields the port has no use for)."""
    import dataclasses
    from repro.configs.base import SHAPES as JSHAPES
    from repro.launch.analytic import CellModel as JCellModel
    from repro.launch.dryrun import cell_defaults as jdefaults
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.analytic import CellModel
    from repro_torch.launch.dryrun import cell_defaults, micro_batch_plan
    from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD

    class FakeMesh:
        def __init__(self, shape):
            self.shape = shape

    for sizes, names in (SINGLE_POD, MULTI_POD):
        ms = dict(zip(names, sizes))
        s = SHAPES[shape]
        micro = micro_batch_plan(s, FakeMesh(ms))[0] if s.kind == "train" else 0
        cfg = cell_defaults(treg.get_config(arch), s)
        jcfg = jdefaults(jreg.get_config(arch), JSHAPES[shape])
        differ = {k for k, v in dataclasses.asdict(cfg).items()
                  if getattr(jcfg, k) != v}
        assert differ <= {"scan_layers", "use_pallas", "source"}, differ
        got = CellModel(cfg, s, ms, micro)
        want = JCellModel(jcfg, JSHAPES[shape], ms, micro)
        for f in ("corrections_dev", "bytes_corrections_dev",
                  "model_flops_analytic_dev"):
            assert getattr(got, f)() == getattr(want, f)(), (f, sizes)
        assert got.hbm_bytes_dev(4) == want.hbm_bytes_dev(4)
        assert got.attn_layer_flops_dev() == want.attn_layer_flops_dev()
