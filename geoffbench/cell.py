"""One cell: the GeoFF workflow deployed on the port, its set-up, the
measured window and the check of what the window served.

Each request is one chain through ``repro_torch.core.Deployment.run`` on a
client thread of its own: ``ingest`` on an edge platform in the document
region (host only: it checks the request and names its document key),
then ``classify`` on the GPU platform, whose one data dependency is the
request's own object in the store, homed in the document region. The
ingest step's start pokes ``classify``, and the port's ``Prefetcher``
fetches the object over the modeled link (latency enforced) into pinned
memory and onto the card on its side stream. ``classify`` runs
``repro_torch.models.model.prefill`` and returns the label (the argmax of
the last position's logits) with those logits as float32 on the host.
"""
from __future__ import annotations

import gc
import re
import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch

from geoffbench import check, spec, traffic, weights
from geoffbench.trace import DeviceTrace

DOC_REGION = "doc-region"
GPU_REGION = "gpu-region"
REQUEST_TIMEOUT_S = 120.0
DRAIN_S = 60.0  # how long past the window's close a due answer is waited for


@dataclass
class Record:
    """One request as the client saw it (perf_counter seconds)."""
    req: traffic.Request
    due: float
    sent: float = 0.0
    done: float = 0.0
    out: Optional[dict] = None
    timeline: Optional[dict] = None
    total_s: float = 0.0
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.out is not None

    @property
    def latency(self) -> float:
        return self.done - self.due


@dataclass
class Window:
    """What a measured window left for the metrics and the check."""
    records: list
    t0: float
    seconds: float
    prefetch: dict          # Prefetcher stats accumulated over the window
    trace: Optional[DeviceTrace]
    late_s: float           # how far the generator ran behind, at worst


class Cell:
    def __init__(self, workload_name: str, device="cuda",
                 arch: Optional[dict] = None, mix: Optional[dict] = None):
        bench = spec.load_benchmark()
        self.name = workload_name
        self.entry = spec.workload(bench, workload_name)
        self.conf = spec.config(bench, self.entry["config"])
        self.model = spec.model(self.conf)
        self.arch = dict(self.conf["port"] if arch is None else arch)
        self.mix = spec.traffic(self.entry["traffic"]) if mix is None else mix
        self.eps = float(self.conf["port_norm_eps"])
        self.device = torch.device(device)
        self.patches = (self.arch["num_patches"] if self.mix["object"] == "patches"
                        else 0)
        self.params = None
        self.dep = None
        self._payloads: dict = {}  # request index -> (payload, object bytes)

    # -- set-up ---------------------------------------------------------------
    def setup(self, seed: int):
        """Weights from the seed, the deployment, and the warm-up of the
        shapes the mix sends (its longest length at the warm-up's
        concurrency, then its median)."""
        from repro_torch.configs.base import ArchConfig
        from repro_torch.models import model as M
        from repro_torch.models.tree import tree_map_with_path

        a = dict(self.arch)
        a["block_pattern"] = tuple(a["block_pattern"])
        self.cfg = ArchConfig(**a)
        layout = self.model.layout(self.arch)
        self.params = weights.make(layout, seed, self.device, into=self.params)
        want = {}
        tree_map_with_path(
            lambda p, d: want.__setitem__("/".join(re.findall(r"\['([^']*)'\]", p)),
                                          tuple(d.shape)),
            M.param_defs(self.cfg), is_leaf=lambda x: hasattr(x, "axes"))
        got = {p: tuple(e[0]) for p, e in layout.items()}
        if want != got:
            raise RuntimeError(f"the program's parameters {want} are not the "
                               f"benchmark's layout {got}")
        if self.dep is None:
            self._deploy()
        warm = traffic.warmup_requests(self.mix, self.patches)
        self._put(warm, seed)
        self._run_concurrently(warm[:-1])
        self._run_concurrently(warm[-1:])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _deploy(self):
        from repro_torch.core import (Deployment, ObjectStore, Platform,
                                      PlatformRegistry)
        from repro_torch.models import model as M

        reg = PlatformRegistry()
        reg.register(Platform("edge", DOC_REGION, kind="edge", native_prefetch=True,
                              device="cpu"))
        reg.register(Platform("gpu", GPU_REGION, native_prefetch=True,
                              device=str(self.device)))
        link = self.mix["link"]
        reg.network.set_link(DOC_REGION, GPU_REGION, link["rtt_s"],
                             link["bandwidth_Bps"])
        self.store = ObjectStore(reg.network, enforce_latency=True)
        self.dep = Deployment(reg, store=self.store)
        cfg, dev, patches = self.cfg, self.device, self.patches

        def ingest(payload, data):
            if not isinstance(payload, dict) or not {"id", "key"} <= set(payload):
                raise ValueError(f"malformed request {payload!r}")
            return payload

        def classify(payload, data):
            h0 = time.perf_counter()
            x = data[payload["key"]]
            if patches:
                q = payload["question"]
                if dev.type == "cuda":
                    q = q.pin_memory().to(dev, non_blocking=True)
                batch = {"tokens": q[None], "patches": torch.as_tensor(x, device=dev)[None]}
            else:
                batch = {"tokens": torch.as_tensor(x, device=dev)[None]}
            with torch.no_grad():
                logits, _ = M.prefill(cfg, self.params, batch)
            disp = time.perf_counter()
            row = logits[0]
            label = int(torch.argmax(row))
            host = row.float().cpu()
            return {"id": payload["id"], "label": label, "logits": host,
                    "span": (h0, disp, time.perf_counter())}

        self.dep.deploy("ingest", ingest, ["edge"])
        self.dep.deploy("classify", classify, ["gpu"])

    def shutdown(self):
        if self.dep is not None:
            self.dep.shutdown()
            self.dep = None
            self.store = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- requests -------------------------------------------------------------
    def _key(self, req, seed):
        return f"doc/{seed}/{req.index}"

    def _object(self, req, seed):
        if self.patches:
            return traffic.page_patches(seed, req, self.arch["d_model"], self.device).cpu()
        return traffic.text_tokens(seed, req, self.arch["vocab_size"])

    def _put(self, reqs, seed):
        """Each request's object into the store, homed in the document
        region, ahead of the window."""
        for r in reqs:
            obj = self._object(r, seed)
            key = self._key(r, seed)
            self.store.put(key, obj, DOC_REGION)
            q = (traffic.text_tokens(seed, r, self.arch["vocab_size"])
                 if self.patches else None)
            self._payloads[r.index] = ({"id": r.index, "key": key, "question": q},
                                       obj.nbytes)

    def _client(self, rec: Record):
        from repro_torch.core import DataRef, StepSpec, WorkflowSpec
        payload, nbytes = self._payloads[rec.req.index]
        wf = WorkflowSpec((StepSpec("ingest", "edge"),
                           StepSpec("classify", "gpu",
                                    (DataRef(payload["key"], DOC_REGION, nbytes),))),
                          "classify")
        rec.sent = time.perf_counter()
        try:
            res = self.dep.run(wf, payload, timeout_s=REQUEST_TIMEOUT_S)
            rec.out, rec.timeline, rec.total_s = res.outputs, res.timeline, res.total_s
            if res.outputs is None:
                rec.error = "no answer"
        except Exception as exc:  # a failed request is counted, not fatal
            rec.error = repr(exc)
        rec.done = time.perf_counter()

    def _run_concurrently(self, reqs):
        recs = [Record(r, 0.0) for r in reqs]
        ths = [threading.Thread(target=self._client, args=(rec,)) for rec in recs]
        for t in ths:
            t.start()
        for t in ths:
            t.join(REQUEST_TIMEOUT_S + 10)
        bad = [r.error for r in recs if not r.ok]
        if bad:
            raise RuntimeError(f"warm-up requests failed: {bad}")

    # -- the window -----------------------------------------------------------
    def schedule(self, seed: int, seconds: float, rate=None) -> list:
        return traffic.schedule(self.mix, seed, seconds, self.patches, rate)

    def window(self, sched: list, seed: int, seconds: float,
               trace: bool = False) -> Window:
        """Objects in the store first (outside the window), then ``seconds``
        of load, then every request sent in it waited for."""
        self._put(sched, seed)
        pf0 = self.dep.prefetcher.stats_snapshot()
        tr = DeviceTrace() if trace else None
        if tr is not None:
            tr.start()
        if self.mix["loop"] == "open":
            recs, t0, late, threads = self._open(sched, seconds)
        else:
            recs, t0, late, threads = self._closed(sched, seconds)
        deadline = t0 + seconds + DRAIN_S
        for t in threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        for r in recs:
            if r.done == 0.0 and r.error is None:
                r.error = "no answer within the drain"
        if tr is not None:
            tr.stop()
        pf1 = self.dep.prefetcher.stats_snapshot()
        prefetch = {k: pf1[k] - pf0[k] for k in pf1}
        for r in sched:
            self.store.delete(self._key(r, seed))
        return Window(recs, t0, seconds, prefetch, tr, late)

    def _open(self, sched, seconds):
        recs = [Record(r, 0.0) for r in sched]
        threads = []
        t0 = time.perf_counter()
        late = 0.0
        for rec in recs:
            rec.due = t0 + rec.req.due_s
            d = rec.due - time.perf_counter()
            if d > 0:
                time.sleep(d)
            late = max(late, time.perf_counter() - rec.due)
            th = threading.Thread(target=self._client, args=(rec,))
            th.start()
            threads.append(th)
        d = t0 + seconds - time.perf_counter()
        if d > 0:
            time.sleep(d)
        return recs, t0, late, threads

    def _closed(self, sched, seconds):
        lock = threading.Lock()
        backlog = iter(sched)
        recs: list = []
        t0 = time.perf_counter()
        stop = t0 + seconds

        def client():
            while True:
                with lock:
                    req = next(backlog, None) if time.perf_counter() < stop else None
                    if req is None:
                        return
                    rec = Record(req, time.perf_counter())
                    recs.append(rec)
                self._client(rec)

        threads = [threading.Thread(target=client) for _ in range(self.mix["clients"])]
        for t in threads:
            t.start()
        d = stop - time.perf_counter()
        if d > 0:
            time.sleep(d)
        return recs, t0, 0.0, threads

    # -- the check ------------------------------------------------------------
    def inputs(self, reqs, seed) -> list:
        """The sampled requests' inputs, made again from the seed."""
        out = []
        for r in reqs:
            if self.patches:
                out.append({"tokens": traffic.text_tokens(seed, r, self.arch["vocab_size"]),
                            "patches": traffic.page_patches(seed, r, self.arch["d_model"],
                                                            self.device)})
            else:
                out.append({"tokens": traffic.text_tokens(seed, r, self.arch["vocab_size"])})
        return out

    def judge(self, win: Window, seed: int, limits: dict, control: bool = False):
        """(correct, checks, numbers, control numbers or None, the sample's
        prompt lengths) of the window. Every answer is checked for its
        request's id; a seeded sample of the finished requests, with the
        longest, against the reference. ``control``: also the fp8
        reference in the program's place, on the same inputs."""
        recs = win.records
        failed = sum(not r.ok for r in recs)
        mine = [r.ok and isinstance(r.out, dict) and r.out.get("id") == r.req.index
                for r in recs]
        misrouted = sum(r.ok and not m for r, m in zip(recs, mine))
        done = [r for r, m in zip(recs, mine) if m]
        picked = check.sample([r.req for r in done], self.mix["check"]["sample"], seed)
        by_index = {r.req.index: r for r in done}
        inputs = self.inputs(picked, seed)
        ref = self.model.last_logits(self.arch, self.params, inputs, "float32", self.eps)
        served = [by_index[r.index].out for r in picked]
        numbers = {"failed": failed, "misrouted": misrouted}
        numbers.update(check.compared([o["label"] for o in served],
                                      [o["logits"] for o in served], ref))
        ok, checks = check.verdict(numbers, limits)
        ctrl = None
        if control:
            low = self.model.last_logits(self.arch, self.params, inputs, "fp8", self.eps)
            ctrl = check.compared([int(torch.argmax(x)) for x in low], low, ref)
        return ok, checks, numbers, ctrl, [r.tokens for r in picked]

