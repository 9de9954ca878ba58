"""The port's host spans over a cell's window (``hostspans``): the shared
clock they and the device trace are read on, and a traced window of the
committed cell at the smoke size on the CPU."""
import importlib.util
import math
import statistics
import time
from pathlib import Path

import pytest
import torch

from geoffbench import hostspans
from geoffbench import trace as T


def _shared():
    """This directory's ``conftest.py`` by its path: a plain ``import
    conftest`` can find another directory's."""
    path = Path(__file__).with_name("conftest.py")
    spec = importlib.util.spec_from_file_location("geoffbench_tests_conftest", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHARED = _shared()
SEED = 2**31 + 2626
SECONDS = 1.5


class FakeTrace(T.DeviceTrace):
    """The device trace's clock, with one made-up operation (no card here)."""

    def start(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.lo_ns = time.perf_counter_ns() + self.offset_ns

    def stop(self):
        self.hi_ns = time.perf_counter_ns() + self.offset_ns
        self.events = [("op", self.lo_ns, (self.lo_ns + self.hi_ns) // 2)]


def test_a_host_span_lands_on_the_profilers_clock(monkeypatch):
    """A ``perf_counter`` span mapped by ``DeviceTrace.host_ns`` lies within
    1 ms of a ``record_function`` range around the same interval: idle gaps
    on the device are named by host spans through this mapping. The median
    of five ranges is judged, so that one preempted stamp on a busy host
    does not decide it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    monkeypatch.setattr("torch.profiler.profile", lambda activities: profile(
        activities=[ProfilerActivity.CPU, *activities]))
    tr = T.DeviceTrace()
    tr.start()
    try:
        with record_function("warm"):
            pass
        stamps = []
        for i in range(5):
            a = time.perf_counter()
            with record_function(f"host_span_{i}"):
                torch.ones(64).sum()
                time.sleep(0.01)
            stamps.append((a, time.perf_counter()))
    finally:
        tr.prof.stop()
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in tr.prof.profiler.kineto_results.events()
              if e.name().startswith("host_span_")}
    assert len(ranges) == 5
    off = []
    for i, (a, b) in enumerate(stamps):
        s, e = ranges[f"host_span_{i}"]
        off.append(max(abs(tr.host_ns(a) - s), abs(tr.host_ns(b) - e)))
    assert statistics.median(off) < 1_000_000, off


@pytest.fixture(scope="module")
def windows(checkout):
    """The committed cell at the smoke size, in the tests' checkout: a
    window with the port's tracer attached by hand, then the tool's traced
    windows with and without it, on the device trace's clock."""
    from geoffbench import spec
    mp = pytest.MonkeyPatch()
    mp.setattr(spec, "ROOT", checkout)
    mp.setattr(spec, "HERE", checkout / "geoffbench")
    mp.setattr("geoffbench.cell.DeviceTrace", FakeTrace)
    try:
        cell, _ = SHARED.small_cell(SHARED.COMMITTED)
        cell.setup(SEED)
        sched = cell.schedule(SEED, SECONDS)
        hostspans.attach(cell.dep, len(sched))
        win = cell.window(sched, SEED, SECONDS)
        traces = hostspans.detach(cell.dep)
        traced = hostspans.traced_window(cell, sched, SEED, SECONDS, tracer=True)
        untraced = hostspans.traced_window(cell, sched, SEED, SECONDS, tracer=False)
        tracer_after = cell.dep.tracer
        cell.shutdown()
    finally:
        mp.undo()
    return win, traces, traced, untraced, tracer_after


def test_every_request_leaves_its_spans(windows):
    win, traces, _, _, _ = windows
    done = [r for r in win.records if r.ok]
    assert done and len(traces) == len(win.records) == len(done)
    for t in traces:
        kinds = [s.kind for s in t.spans]
        assert kinds.count("node") == 2 and kinds.count("transfer") == 1
        assert all(s.attrs["queued_s"] >= 0.0 for s in t.spans
                   if s.kind in ("node", "transfer"))
        (compute,) = [s for s in t.spans if s.kind == "compute"
                      and s.attrs["node"] == "classify"]
        (d,) = [s for s in t.spans if s.kind == "dispatch"]
        assert d.name == "dispatch:prefill" and d.parent_id == compute.span_id
        assert compute.t_start <= d.t_start <= d.t_end <= compute.t_end
        assert 0.0 < d.attrs["attention_s"] <= d.duration_s
        assert d.attrs["sync_s"] == 0.0  # the cell's rope (rope_qk) copies nothing
        assert 0.0 <= d.attrs["cpu_s"] <= d.duration_s + 0.005


def test_a_traced_window_gives_every_reading(windows):
    _, traces, traced, _, _ = windows
    for out in ({k: f(traces) for k, f in hostspans.READINGS.items()}, traced):
        vals = [out[k] for k in hostspans.READINGS]
        assert all(isinstance(v, float) and math.isfinite(v) for v in vals), out
        assert out["engine.queue_ms"] >= 0.0
        assert 0.0 < out["prefill.attention_dispatch_ms"] <= out["prefill.dispatch_ms"]
        assert out["prefill.rope_sync_ms"] == 0.0
        assert 0.0 < out["prefill.dispatch_cpu_pct"] <= 100.5
    assert traced["tracer"] and traced["failed"] == 0
    assert traced["tokens_per_s"] > 0 and 0.0 < traced["device_idle_pct"] < 100.0


def test_an_untraced_window_attaches_no_tracer(windows):
    _, _, _, untraced, tracer_after = windows
    assert tracer_after is None
    assert not untraced["tracer"] and untraced["failed"] == 0
    assert not set(hostspans.READINGS) & set(untraced)
    assert all(f([]) is None for f in hostspans.READINGS.values())
