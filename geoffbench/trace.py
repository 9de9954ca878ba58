"""The device trace of a window (``torch.profiler``, CUDA activity only)
and its reductions: busy time, idle gaps and what the host was doing in
each, and the device operations that took the most time.

Device operations come back as (name, start_ns, end_ns) in the domain of
``time.time_ns`` (the profiler's clock); host stamps are
``time.perf_counter`` seconds, moved into that domain by the offset taken
when the trace starts."""
from __future__ import annotations

import time
from collections import defaultdict


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.events: list = []
        self.lo_ns = self.hi_ns = 0
        self.offset_ns = 0  # time_ns - perf_counter_ns

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.lo_ns = time.perf_counter_ns() + self.offset_ns

    def stop(self):
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self.hi_ns = time.perf_counter_ns() + self.offset_ns
        self.prof.stop()
        evs = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                evs.append((e.name(), s, s + e.duration_ns()))
        self.events = evs
        self.prof = None

    def host_ns(self, t_perf: float) -> int:
        return int(t_perf * 1e9) + self.offset_ns

    @property
    def window_s(self) -> float:
        return (self.hi_ns - self.lo_ns) * 1e-9


def merged(events: list, lo: int, hi: int) -> list:
    """The union of the operations' intervals, clipped to [lo, hi]."""
    iv = sorted((max(s, lo), min(e, hi)) for _, s, e in events if e > lo and s < hi)
    out: list = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_s(events: list, lo: int, hi: int) -> float:
    return sum(e - s for s, e in merged(events, lo, hi)) * 1e-9


def idle_gaps(events: list, lo: int, hi: int) -> list:
    """(start, end) of every stretch in [lo, hi] with no operation running."""
    out, t = [], lo
    for s, e in merged(events, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def top_ops(events: list, n: int = 10) -> list:
    """[[name, seconds]] of the n operations (by name) that took most time."""
    tot: dict = defaultdict(int)
    for name, s, e in events:
        tot[name] += e - s
    return [[k[:64], v * 1e-9] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


# host phases of a request, most telling first: a gap is named by the
# first phase in this order that some request was in at the gap's middle
PHASES = ("prefill_dispatch", "engine_outside_handler", "handler_waiting_device")


def gaps_by_host(gaps: list, spans: list, n: int = 10) -> list:
    """[[what the host was doing, idle seconds]] over ``gaps``, the n
    largest. ``spans``: per request (sent, handler_start, dispatched,
    handler_end, done) in the trace's ns domain; a request is in
    ``prefill_dispatch`` from handler_start until the prefill returned to
    the host, ``handler_waiting_device`` until its handler returned, and
    ``engine_outside_handler`` for the rest of sent..done (ingest, poke,
    fetch, executor queue, the result's return)."""
    marks = []
    for sent, h0, disp, h1, done in spans:
        for a, b, ph in ((sent, h0, 2), (h0, disp, 1), (disp, h1, 3), (h1, done, 2)):
            if b > a:
                marks.append((a, ph, 1))
                marks.append((b, ph, -1))
    marks.sort()
    count = {1: 0, 2: 0, 3: 0}
    tot: dict = defaultdict(float)
    num: dict = defaultdict(int)
    i = 0
    for s, e in sorted(gaps):
        mid = (s + e) // 2
        while i < len(marks) and marks[i][0] <= mid:
            count[marks[i][1]] += marks[i][2]
            i += 1
        what = next((PHASES[p - 1] for p in (1, 2, 3) if count[p] > 0),
                    "no_request_in_flight")
        tot[what] += (e - s) * 1e-9
        num[what] += 1
    return [[f"{k} ({num[k]} gaps)", v] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
