"""The port's ``jobs``: idempotent submission, the engine's retry, hedge and
dead-letter semantics, the timeout path (cancelled cascade, cleaned
buffers), and the chaos property test — random fault schedules and retry
budgets over chain, diamond and braid graphs must never hang, never
mis-count, and never return a wrong result. These are the cases of
``tests/test_jobs.py`` on the port's engine (every platform on the CPU),
plus the ``job_id`` pin: the same spec and payload give the same id in
both packages, tensor payloads included, and a payload's identity is its
``repr`` — which numpy and torch cut short past 1000 elements, so two
large payloads that differ only in the middle share an id in both."""
import random
import threading
import time

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.dag: its import order)
import repro.dag as jdag
import repro.jobs as rjobs
from repro_torch.core import Platform, PlatformRegistry
from repro_torch.core.faults import (
    FaultEvent,
    FaultSchedule,
    InjectedFault,
    OutageEvent,
    RetryPolicy,
)
from repro_torch.dag import DagDeployment, DagSpec, DagStep
from repro_torch.jobs import DeadLetter, Job, JobManager, job_id
from repro_torch.obs import Tracer

PLATFORMS = ("pA", "pB")
CPU = "cpu"
JOIN_S = 60.0  # every client thread joins within this, so nothing can hang


def _registry(sync=True):
    reg = PlatformRegistry()
    for name in PLATFORMS:
        reg.register(
            Platform(
                name=name, region=name, allows_sync=sync, native_prefetch=sync,
                device=CPU,
            )
        )
    return reg


def _handler(payload, data):
    if isinstance(payload, dict):
        return sum(payload.values())
    return payload + 1


GRAPHS = {
    "chain": (("s1", "s2", "s3"), (("s1", "s2"), ("s2", "s3"))),
    "diamond": (
        ("a", "b", "c", "d"),
        (("a", "b"), ("a", "c"), ("b", "d"), ("c", "d")),
    ),
    "braid": (
        ("a", "b", "c", "d", "e"),
        (("a", "b"), ("a", "c"), ("b", "c"), ("b", "d"), ("c", "d"), ("d", "e")),
    ),
}


def _spec(graph: str, rng=None, D=None) -> DagSpec:
    Spec, Step = (DagSpec, DagStep) if D is None else (D.DagSpec, D.DagStep)
    nodes, edges = GRAPHS[graph]
    rng = rng or random.Random(0)
    steps = tuple(Step(n, rng.choice(PLATFORMS)) for n in nodes)
    return Spec(steps=steps, edges=edges)


def _expected(spec: DagSpec, payload):
    """Reference evaluation of the DAG under ``_handler`` (steps are in
    topo order by construction)."""
    val = {}
    for step in spec.steps:
        preds = spec.predecessors(step.name)
        if not preds:
            arg = payload
        elif len(preds) == 1:
            arg = val[preds[0]]
        else:
            arg = {p: val[p] for p in preds}
        val[step.name] = _handler(arg, {})
    sinks = spec.sinks()
    return val[sinks[0]] if len(sinks) == 1 else {s: val[s] for s in sinks}


def _deploy(spec, **kw):
    dep = DagDeployment(registry=_registry(), **kw)
    for name in {s.name for s in spec.steps}:
        dep.deploy(name, _handler, list(PLATFORMS))
    return dep


def _join(threads):
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


# ---------------------------------------------------------------------------
# idempotent job ids
# ---------------------------------------------------------------------------
def test_completed_job_dedups_to_recorded_result():
    spec = _spec("chain")
    calls = []

    def counting(payload, data):
        calls.append(1)
        return _handler(payload, data)

    dep = DagDeployment(registry=_registry())
    for name in ("s1", "s2", "s3"):
        dep.deploy(name, counting, list(PLATFORMS))
    with dep:
        jm = JobManager(dep)
        j1 = jm.submit(5, spec=spec)
        n = len(calls)
        j2 = jm.submit(5, spec=spec)
        assert j2 is j1 and len(calls) == n  # no re-execution
        assert j1.result.outputs == _expected(spec, 5)
        assert jm.stats == {
            "submitted": 2,
            "kept": 2,
            "dead_lettered": 0,
            "deduped": 1,
            "executed": 1,
        }


def test_job_identity_is_placement_independent():
    spec_a = _spec("chain")
    other = "pB" if spec_a.node("s2").platform == "pA" else "pA"
    moved = spec_a.apply_placement({"s2": other})
    assert job_id(spec_a, 1) == job_id(moved, 1)
    assert job_id(spec_a, 1) != job_id(spec_a, 2)  # payload participates
    assert job_id(spec_a, 1) != job_id(_spec("diamond"), 1)  # shape too


@pytest.mark.parametrize("payload", [
    1, "doc", {"a": 1, "b": [2, 3]}, np.arange(12, dtype=np.int32),
    torch.arange(12, dtype=torch.int32), torch.zeros(2, 3),
], ids=["int", "str", "dict", "numpy", "tensor_int", "tensor_f32"])
def test_job_id_equals_reference_and_pins_repr_truncation(payload):
    """The same workflow and payload give the same id in both packages (a
    CPU tensor's ``repr`` is framework-neutral text), distinct payloads
    give distinct ids, and a large payload is identified by its cut-short
    ``repr``: numpy and torch print only the head and tail past 1000
    elements, so two 2000-element payloads that differ only at element
    1000 collide — in both packages alike."""
    for graph in GRAPHS:
        assert job_id(_spec(graph), payload) == rjobs.job_id(_spec(graph, D=jdag),
                                                             payload)
    if isinstance(payload, (np.ndarray, torch.Tensor)):
        other = payload.clone() if isinstance(payload, torch.Tensor) else payload.copy()
        other[(0,) * other.ndim] += 1
        assert job_id(_spec("chain"), other) != job_id(_spec("chain"), payload)
    big = (np.zeros(2000), torch.zeros(2000))
    for a in big:
        b = a.clone() if isinstance(a, torch.Tensor) else a.copy()
        b[1000] = 1.0
        for pkg, spec in ((job_id, _spec("chain")),
                          (rjobs.job_id, _spec("chain", D=jdag))):
            assert pkg(spec, a) == pkg(spec, b)  # the reference's semantics


def test_dead_lettered_job_reexecutes_on_resubmit():
    spec = _spec("chain")
    dead = FaultSchedule([OutageEvent(0, None, platform="pA")], seed=1)
    tracer = Tracer()
    with _deploy(
        spec,
        faults=dead,
        retry=RetryPolicy(max_attempts=2, backoff_base_s=0.001),
        tracer=tracer,
    ) as dep:
        jm = JobManager(dep)
        j1 = jm.submit(3, spec=spec)
        assert j1.status == "dead_lettered" and "InjectedFault" in j1.error
        j2 = jm.submit(3, spec=spec)
        assert j2 is not j1  # a dead letter is a record, not a tombstone
        assert len(jm.dead_letters) == 2
        assert all(isinstance(d, DeadLetter) for d in jm.dead_letters)
        assert jm.stats["kept"] + jm.stats["dead_lettered"] == jm.stats["submitted"]
        events = [e for e in tracer.events if e[1] == "job.dead_letter"]
        assert len(events) == 2 and events[0][2]["job_id"] == j1.job_id


# ---------------------------------------------------------------------------
# engine retry / hedge / timeout
# ---------------------------------------------------------------------------
def test_engine_retry_recovers_and_emits_span_events():
    from repro_torch.core.faults import _STREAM_FAIL, _node_salt, hash_u01

    spec = _spec("chain", random.Random(3))
    step0 = spec.steps[0]
    # pick a seed + probability that deterministically fail attempt 0 and
    # pass attempt 1 for request 0 (the hash is the contract, so we can)
    salt = _node_salt(step0.name, step0.platform)
    seed = p = None
    for s in range(100):
        u0 = float(hash_u01(s, salt, 0, _STREAM_FAIL, [0])[0])
        u1 = float(hash_u01(s, salt, 1, _STREAM_FAIL, [0])[0])
        if u0 < u1:
            seed, p = s, (u0 + u1) / 2
            break
    fs = FaultSchedule(
        [FaultEvent(step0.platform, p_error=p, step=step0.name, to_request=1)],
        seed=seed,
    )
    tracer = Tracer()
    with _deploy(
        spec,
        faults=fs,
        retry=RetryPolicy(max_attempts=3, backoff_base_s=0.001),
        tracer=tracer,
    ) as dep:
        r = dep.run(spec, 10)
        assert r.status == "ok" and r.outputs == _expected(spec, 10)
        assert r.timeline[step0.name]["attempts"] == 2
        assert dep.stats["retries"] == 1 and dep.stats["attempt_errors"] == 1
        trace = tracer.last()
        evs = [e for s in trace.spans for e in s.events if e[1] == "retry"]
        assert len(evs) == 1
        assert evs[0][2]["injected"] and evs[0][2]["backoff_s"] > 0
        # telemetry learned the failed attempt
        assert dep.report()["engine"]["retries"] == 1


def test_engine_budget_exhaustion_raises_injected_fault():
    spec = _spec("chain")
    fs = FaultSchedule([OutageEvent(0, None, platform="pA")], seed=0)
    with _deploy(
        spec, faults=fs, retry=RetryPolicy(max_attempts=2, backoff_base_s=0.001)
    ) as dep:
        with pytest.raises(InjectedFault):
            dep.run(spec, 1)


def test_engine_hedging_first_finisher_wins():
    """The primary stalls and the hedge wins; the two attempts ran at the
    same time, each on its own copy of a tensor fetched per call (as the
    served decode step fetches its caches), so the stalled attempt's
    in-place writes never reach the winner's result."""
    spec = DagSpec(steps=(DagStep("s1", "pA"),), edges=())
    lock = threading.Lock()
    calls = {"n": 0}
    shared = torch.zeros(4)

    def straggler(payload, data):
        with lock:
            calls["n"] += 1
            k = calls["n"]
        cache = shared.clone()  # this attempt's own copy
        if k == 1:
            time.sleep(0.8)  # the primary stalls; the hedge must win
            cache.fill_(-1.0)
        cache += payload
        return float(cache.sum()) + 1

    dep = DagDeployment(
        registry=_registry(), retry=RetryPolicy(hedge_after_s=0.05)
    )
    dep.deploy("s1", straggler, list(PLATFORMS))
    with dep:
        t0 = time.perf_counter()
        r = dep.run(spec, 1)
        took = time.perf_counter() - t0
        assert r.outputs == 5.0 and took < 0.6
        assert dep.stats["hedges"] == 1 and dep.stats["hedge_wins"] == 1
        assert torch.equal(shared, torch.zeros(4))


def test_timeout_returns_structured_record_and_cleans_buffers():
    spec = DagSpec(
        steps=(DagStep("s1", "pA"), DagStep("s2", "pB")), edges=(("s1", "s2"),)
    )
    release = threading.Event()

    def slow(payload, data):
        release.wait(5.0)
        return payload

    dep = DagDeployment(registry=_registry(sync=False))
    dep.deploy("s1", slow, list(PLATFORMS))
    dep.deploy("s2", slow, list(PLATFORMS))
    with dep:
        r = dep.run(spec, 1, timeout_s=0.2)
        assert r.status == "timeout" and "TimeoutError" in r.error
        assert r.outputs is None
        assert dep.stats["timeouts"] == 1
        release.set()
        time.sleep(0.3)  # let the cancelled cascade unwind
        assert dep.store.keys("__payload__/") == []
        # the deployment still serves fresh requests afterwards
        r2 = dep.run(spec, 1, timeout_s=10.0)
        assert r2.status == "ok" and r2.outputs == 1


def test_timed_out_job_dead_letters():
    spec = DagSpec(steps=(DagStep("s1", "pA"),), edges=())
    release = threading.Event()

    def slow(payload, data):
        release.wait(5.0)
        return payload

    tracer = Tracer()
    dep = DagDeployment(registry=_registry(), tracer=tracer)
    dep.deploy("s1", slow, list(PLATFORMS))
    with dep:
        jm = JobManager(dep, timeout_s=0.2)
        j = jm.submit(1, spec=spec)
        release.set()
        assert j.status == "dead_lettered" and "Timeout" in j.error
        assert jm.dead_letters[0].request_id is not None
        assert tracer.last().root.attrs["status"] == "timeout"
        assert [e[1] for e in tracer.events] == ["job.dead_letter"]


# ---------------------------------------------------------------------------
# chaos property test
# ---------------------------------------------------------------------------
def _random_schedule(rng: random.Random) -> FaultSchedule:
    events = []
    for _ in range(rng.randint(1, 3)):
        events.append(
            FaultEvent(
                rng.choice(PLATFORMS),
                p_error=rng.uniform(0.05, 0.5),
                from_request=rng.randint(0, 4),
                to_request=rng.randint(8, 24),
            )
        )
    if rng.random() < 0.7:
        start = rng.randint(2, 10)
        events.append(
            OutageEvent(
                start, start + rng.randint(2, 6), platform=rng.choice(PLATFORMS)
            )
        )
    return FaultSchedule(events, seed=rng.randint(0, 2**31))


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_chaos_jobs_complete_correctly_or_dead_letter(graph, seed):
    rng = random.Random(1000 * seed + sum(map(ord, graph)) % 997)
    spec = _spec(graph, rng)
    schedule = _random_schedule(rng)
    retry = RetryPolicy(
        max_attempts=rng.randint(1, 4), backoff_base_s=0.001, seed=seed
    )
    with _deploy(spec, faults=schedule, retry=retry) as dep:
        jm = JobManager(dep, timeout_s=20.0)
        jobs = [jm.submit(k, spec=spec) for k in range(12)]
        for k, job in enumerate(jobs):
            assert job.status in ("completed", "dead_lettered")
            assert job.done.is_set()  # bounded join: every submit resolved
            if job.status == "completed":
                assert job.result.outputs == _expected(spec, k)
            else:
                assert job.error is not None
        s = jm.stats
        assert s["kept"] + s["dead_lettered"] == s["submitted"] == 12
        assert len(jm.dead_letters) == sum(
            1 for j in jobs if j.status == "dead_lettered"
        )


def test_chaos_ledger_exact_under_multithreaded_clients():
    """8 client threads hammer overlapping payloads through a faulty
    deployment: the ledger must balance exactly and every job must reach a
    final state — no hangs, no double counts."""
    rng = random.Random(42)
    spec = _spec("diamond", rng)
    schedule = FaultSchedule(
        [
            FaultEvent("pA", p_error=0.3, to_request=200),
            OutageEvent(10, 18, platform="pB"),
        ],
        seed=9,
    )
    with _deploy(
        spec,
        faults=schedule,
        retry=RetryPolicy(max_attempts=3, backoff_base_s=0.001),
    ) as dep:
        jm = JobManager(dep, timeout_s=20.0)
        results: list = []

        def client(tid):
            got = []
            for k in range(12):
                got.append(jm.submit(k % 6, spec=spec))
            results.append(got)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        _join(threads)
        s = jm.stats
        assert s["submitted"] == 8 * 12
        assert s["kept"] + s["dead_lettered"] == s["submitted"]
        for got in results:
            for job in got:
                assert job.done.is_set()
                assert job.status in ("completed", "dead_lettered")
        # completed jobs returned the correct value for their payload
        for job in {j.job_id: j for g in results for j in g}.values():
            if job.status == "completed":
                out = job.result.outputs
                assert out in {_expected(spec, k) for k in range(6)}


def test_job_dataclass_shapes():
    j = Job(job_id="abc")
    assert j.status == "running" and not j.done.is_set()
    d = DeadLetter("abc", "boom", at=0.0)
    assert d.request_id is None
