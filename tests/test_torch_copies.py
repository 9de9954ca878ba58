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


def test_registry_lists_only_ported_configs():
    assert treg.ARCH_IDS == ("qwen3-1.7b",)
    with pytest.raises(KeyError):
        treg.get_config("mamba2-370m")
