"""Dataflow executor for DAG workflows — THE execution core of this repo.

Chain workflows (``repro.core.choreographer.Deployment``) are a thin facade
over this engine: a chain is the degenerate DAG, lifted per request via
``DagSpec.from_chain``. There is exactly one implementation of the GeoFF
two-phase protocol, generalized to a DAG over the shared pieces
(CompileCache, Prefetcher, ObjectStore, PokeTimingController, per-platform
executors):

  - pokes cascade along EDGES: poking a node immediately pokes all of its
    successors, so a fan-out warms and pre-fetches every branch at once
    (poking is deduplicated per request — a diamond's join is poked once);
  - each node FIRES the moment its last predecessor payload lands
    (dataflow firing rule). Per-predecessor payloads are buffered — through
    the object store on platforms that disallow direct function-to-function
    traffic (one ``__payload__`` key per edge, deleted after the GET so
    fan-in buffers never leak) and in memory on sync platforms;
  - independent branches run concurrently on their platforms' executors:
    the latency win over the chain serialization is real wall-clock
    parallelism plus the usual pre-fetch overlap;
  - poke timing is learned PER EDGE: payload arrival is timestamped per
    predecessor, so a fan-in node feeds a distinct slack observation to the
    ``PokeTimingController`` for each in-edge (§5.5, generalized).

Handlers keep the chain signature ``handler(payload, data)``. A fan-in node
receives ``{pred_name: payload}``; source nodes receive the client payload;
everything else receives its single predecessor's output unwrapped — so
functions written for chains deploy onto DAGs without change.

A step's data dependencies land on its platform's CUDA device, where it
has one (``Platform.device``): the prefetch copies them there on a side
stream during the poke window. On a CPU platform they arrive as the store
holds them, as in the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
import uuid
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.faults import FaultSchedule, InjectedFault, RetryPolicy
from repro_torch.core.platform import Platform, PlatformRegistry, PlatformWrapper
from repro_torch.core.prefetch import Prefetcher
from repro_torch.core.prewarm import CompileCache
from repro_torch.core.store import ObjectStore, StreamConfig, _sizeof
from repro_torch.core.timing import PokeTimingController
from repro_torch.dag.spec import DagSpec


def _data_device(platform: Platform):
    """Where a step's data dependencies go: the platform's CUDA device, or
    None (as stored) on a CPU platform."""
    dev = torch.device(platform.device)
    return dev if dev.type == "cuda" else None


@dataclass
class DeployedFn:
    """One (handler, wrapper, middleware) package on one platform (§3.1)."""

    name: str
    platform: Platform
    wrapper: PlatformWrapper
    handler: Callable  # handler(payload, data: dict) -> out
    abstract_args: Optional[object] = None  # for pre-warm (compile) keys
    compile_fn: Optional[Callable] = None  # jit-able step body (optional)


@dataclass
class DagResult:
    request_id: str
    outputs: object  # sink output; {sink_name: output} when several sinks
    timeline: dict  # node -> {phase: seconds}
    total_s: float
    # "ok" | "timeout" — a timed-out request returns a structured record
    # (cascade cancelled, edge buffers cleaned) instead of a bare raise
    status: str = "ok"
    error: Optional[str] = None


class FaultInjector:
    """Engine-side twin of the simulator's fault plane: evaluates the same
    counter-hash (``FaultSchedule.attempt_outcome``) inside ``_run_node``
    and raises ``InjectedFault`` where the simulator would have priced a
    failed attempt — so a schedule replayed on the real engine fails the
    exact (step, platform, request, attempt) cells the sim predicted."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule

    def check(
        self, step: str, platform: str, region: str, request_k: int, attempt: int
    ):
        kind = self.schedule.attempt_outcome(
            step, platform, request_k, attempt, region=region
        )
        if kind is not None:
            raise InjectedFault(kind, step, platform, request_k, attempt)


class _RunState:
    """All per-request mutable state (one instance per ``run``)."""

    def __init__(self, spec: DagSpec, payload):
        self.spec = spec
        self.payload = payload
        self.rid = uuid.uuid4().hex[:12]
        self.lock = threading.Lock()
        self.poke_seen: set = set()  # nodes whose poke already ran (dedup)
        self.poked: dict = {}  # node -> (warm_fut, fetch_futs, t0, delay)
        self.buffers: dict = {n.name: {} for n in spec.steps}  # fan-in joins
        self.arrivals: dict = {n.name: {} for n in spec.steps}  # edge stamps
        # streaming: predecessors whose FIRST chunk has landed (fires the
        # node early) and the event set when the FULL payload set is in
        self.first_seen: dict = {n.name: set() for n in spec.steps}
        self.payload_done: dict = {n.name: threading.Event() for n in spec.steps}
        self.fired: set = set()
        self.timeline: dict = {}
        self.outputs: dict = {}
        self.pending_sinks = set(spec.sinks())
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.t0 = 0.0  # request clock zero (perf_counter, set by run)
        self.req_index = 0  # deployment-wide request counter (fault keying)
        self.trace = None  # obs.Trace when the deployment has a tracer
        self.poke_t: dict = {}  # node -> absolute poke time
        self.transfer_s: dict = {n.name: {} for n in spec.steps}  # dst->{src: s}

    def fail(self, exc: BaseException):
        with self.lock:
            if self.error is None:
                self.error = exc
        self.done.set()


class DagDeployment:
    """Deployer + client entry point for DAG workflows.

    Same deployment surface as the chain ``Deployment`` — one
    platform-independent handler deployed to N platforms — but ``run``
    takes a ``DagSpec`` and drives the dataflow schedule. Usable as a
    context manager; ``shutdown`` is idempotent, so thread pools never
    leak across runs even when both paths trigger.
    """

    def __init__(
        self,
        registry: Optional[PlatformRegistry] = None,
        store: Optional[ObjectStore] = None,
        timing_mode: str = "eager",
        telemetry=None,
        tracer=None,
        stream: Optional[StreamConfig] = None,
        payload_region: Optional[str] = None,
        faults=None,
        retry: Optional[RetryPolicy] = None,
    ):
        self.registry = registry or PlatformRegistry()
        self.store = store or ObjectStore(self.registry.network)
        self.cache = CompileCache()
        # chunked data plane: None keeps every path exactly as before;
        # chunks > 1 pipelines payload edges (successor fires on the first
        # chunk) and chunked-fetches data deps
        self.stream = stream
        # where buffered payloads are homed: None = the destination's own
        # region (the store GET is then intra-region); a staging region
        # makes both hops pay wire time — the setting under which the
        # streamed cut-through and the P2P bypass earn their keep
        self.payload_region = payload_region
        self.prefetcher = Prefetcher(self.store, stream=stream)
        self.timing = PokeTimingController(timing_mode)
        # durability: an injected-fault schedule (accepts a raw
        # FaultSchedule or a FaultInjector) and the per-step retry budget
        if faults is not None and not isinstance(faults, FaultInjector):
            faults = FaultInjector(faults)
        self.faults: Optional[FaultInjector] = faults
        self.retry = retry
        self._req_count = 0  # monotone request index (fault/backoff keying)
        # hedged duplicates run on per-platform side pools, NOT the
        # platform executors — a hedge must never occupy the slot its
        # primary needs (the thread name keeps the "plat-<name>" prefix so
        # handlers keyed off it behave identically on either lane)
        self._hedge_pools: dict = {}
        self._functions: dict = {}  # (name, platform) -> DeployedFn
        self._stats_lock = threading.Lock()
        self._shut = False
        self.stats = {
            "pokes": {},
            "joins": 0,
            "buffered_edges": 0,
            "streamed_edges": 0,  # edges moved chunk-by-chunk (cut-through)
            "p2p_edges": 0,  # edges that skipped the store entirely
            "retries": 0,  # re-attempts after a failed handler call
            "attempt_errors": 0,  # failed attempts (injected or real)
            "timeouts": 0,  # requests returned with status="timeout"
            "hedges": 0,  # duplicate executions launched for stragglers
            "hedge_wins": 0,  # hedges that beat their primary
            "hedge_cancelled": 0,  # losers cancelled before starting
        }
        # duck-typed TelemetryHub (repro.adapt): propagated to every piece
        # so one hub sees compute + warm/cold + fetch + transfer events
        self.telemetry = telemetry
        if telemetry is not None:
            self.cache.telemetry = telemetry
            self.prefetcher.telemetry = telemetry
            self.store.telemetry = telemetry
        # duck-typed obs.Tracer: same propagation, per-request span trees
        self.tracer = tracer
        if tracer is not None:
            self.cache.tracer = tracer
            self.prefetcher.tracer = tracer
            self.store.tracer = tracer

    # -- deployer --------------------------------------------------------------
    def deploy(
        self,
        name: str,
        handler: Callable,
        platforms,
        abstract_args=None,
        compile_fn=None,
    ):
        for pname in platforms:
            plat = self.registry.get(pname)
            wrapper = PlatformWrapper(plat, handler, name)
            warm_fn = compile_fn
            if compile_fn is not None and plat.mesh is not None:
                # pre-warm the program the step runs: under the platform's
                # mesh and rules (the cache's pool threads have none bound)
                warm_fn = PlatformWrapper(plat, compile_fn, name)
            self._functions[(name, pname)] = DeployedFn(
                name, plat, wrapper, handler, abstract_args, warm_fn
            )
        return self

    def _resolve(self, name: str, platform: str) -> DeployedFn:
        try:
            return self._functions[(name, platform)]
        except KeyError:
            raise KeyError(
                f"function {name!r} is not deployed on {platform!r}; "
                f"deployed: {sorted(self._functions)}"
            ) from None

    def _resolve_step(self, step) -> DeployedFn:
        """Resolve a spec node to its deployed function: ``step.fn`` names
        the function when the node name is disambiguated (a chain invoking
        the same function twice lifts to ``f@i`` nodes with ``fn='f'``)."""
        return self._resolve(getattr(step, "fn", "") or step.name, step.platform)

    # -- client ----------------------------------------------------------------
    def run(
        self, spec: DagSpec, payload, timeout_s: Optional[float] = 120.0
    ) -> DagResult:
        """Invoke the DAG: deliver the client payload to every source node
        and wait for all sinks (``timeout_s=None`` waits indefinitely).
        Raises whatever a node's handler raised. A TIMEOUT does not raise:
        it cancels the in-flight cascade (every phase entry checks
        ``state.error``), deletes any buffered ``__payload__`` edge keys,
        and returns a structured ``DagResult(status="timeout")`` — the
        caller gets a failed-request record, not a stranded request."""
        for s in spec.steps:  # fail fast on missing deployments
            self._resolve_step(s)
        state = _RunState(spec, payload)
        with self._stats_lock:
            state.req_index = self._req_count
            self._req_count += 1
        t0 = time.perf_counter()
        state.t0 = t0
        if self.tracer is not None:
            # trace_id == request_id: one root span per request, carried by
            # the state object through the whole poke/payload cascade
            state.trace = self.tracer.begin(
                name=f"request:{state.rid}", trace_id=state.rid, t0=t0
            )
        for source in spec.sources():
            self._deliver(state, None, source, payload)
        if not state.done.wait(timeout_s):
            # cancel the cascade: fail() sets the error every phase checks
            # at entry, so nothing new fires and pollers unwind
            state.fail(
                TimeoutError(
                    f"request {state.rid} timed out after {timeout_s}s; "
                    f"fired={sorted(state.fired)}"
                )
            )
            with self._stats_lock:
                self.stats["timeouts"] += 1
            self._cleanup_request(state)
            t_end = time.perf_counter()
            if state.trace is not None:
                state.trace.root.attrs["status"] = "timeout"
                state.trace.root.attrs["error"] = repr(state.error)
                self.tracer.finish(state.trace, t_end=t_end)
            return DagResult(
                state.rid,
                None,
                dict(state.timeline),
                t_end - t0,
                status="timeout",
                error=repr(state.error),
            )
        if state.error is not None:
            self._cleanup_request(state)
            if state.trace is not None:
                state.trace.root.attrs["error"] = repr(state.error)
                self.tracer.finish(state.trace)
            raise state.error
        outs = state.outputs
        outputs = outs[next(iter(outs))] if len(outs) == 1 else dict(outs)
        t_end = time.perf_counter()
        if state.trace is not None:
            self.tracer.finish(state.trace, t_end=t_end)
        return DagResult(state.rid, outputs, dict(state.timeline), t_end - t0)

    def _cleanup_request(self, state: _RunState):
        """Delete every edge buffer a failed/timed-out request left in the
        object store (``__payload__/<rid>/...`` keys are otherwise only
        deleted by the GET side that never ran)."""
        prefix = f"__payload__/{state.rid}/"
        for key in self.store.keys(prefix):
            self.store.delete(key)

    def report(self) -> dict:
        """ONE merged runtime-stats surface (locked snapshots throughout):
        engine counters, compile cache, prefetcher, object store, and the
        per-step/per-edge timing report — plus the telemetry snapshot when
        a hub is attached. This is also the surface ``repro.adapt`` taps."""
        with self._stats_lock:
            engine = {
                "pokes": dict(self.stats["pokes"]),
                "joins": self.stats["joins"],
                "buffered_edges": self.stats["buffered_edges"],
                "streamed_edges": self.stats["streamed_edges"],
                "p2p_edges": self.stats["p2p_edges"],
                "retries": self.stats["retries"],
                "attempt_errors": self.stats["attempt_errors"],
                "timeouts": self.stats["timeouts"],
                "hedges": self.stats["hedges"],
                "hedge_wins": self.stats["hedge_wins"],
                "hedge_cancelled": self.stats["hedge_cancelled"],
            }
        out = {
            "engine": engine,
            "compile": self.cache.stats_snapshot(),
            "prefetch": self.prefetcher.stats_snapshot(),
            "store": self.store.stats_snapshot(),
            "timing": self.timing.report(),
        }
        if self.telemetry is not None:
            out["telemetry"] = self.telemetry.snapshot()
        metrics = getattr(self.tracer, "metrics", None)
        if metrics is not None:
            out["metrics"] = metrics.snapshot()
        sampler = getattr(self.tracer, "sampler", None)
        if sampler is not None:
            # tail-sampling accounting: kept/evicted/seen (exact) and the
            # current slow-trace threshold — retention must be auditable
            out["trace_sampler"] = sampler.snapshot()
        return out

    def shutdown(self):
        if self._shut:
            return
        self._shut = True
        self.registry.shutdown()
        self.cache.shutdown()
        self.prefetcher.shutdown()
        with self._stats_lock:
            pools = list(self._hedge_pools.values())
            self._hedge_pools.clear()
        for pool in pools:
            pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- phase 1: poke (cascades along edges) ----------------------------------
    def _poke(self, state: _RunState, node: str, delay_applied: float = 0.0):
        if state.error is not None:  # request cancelled (timeout/failure)
            return
        try:
            with state.lock:
                if node in state.poke_seen or node in state.fired:
                    return
                state.poke_seen.add(node)
            t0 = time.perf_counter()
            step = state.spec.node(node)
            fn = self._resolve_step(step)
            with state.lock:
                state.poke_t[node] = t0
            poke_span = None
            if state.trace is not None:
                poke_span = state.trace.span(
                    f"poke:{node}",
                    "poke",
                    t_start=t0,
                    attrs={
                        "node": node,
                        "platform": step.platform,
                        "delay_applied_s": delay_applied,
                    },
                )
            ctx = (
                self.tracer.bind(poke_span)
                if self.tracer is not None and poke_span is not None
                else nullcontext()
            )
            with ctx:
                warm_fut = None
                if fn.compile_fn is not None and fn.abstract_args is not None:
                    warm_fut = self.cache.warm(
                        fn.name, fn.platform.name, fn.compile_fn, fn.abstract_args
                    )
                fetch_futs = {}
                if step.data_deps:
                    fetch_futs = self.prefetcher.start(
                        step.data_deps, fn.platform.region,
                        device=_data_device(fn.platform),
                    )
            if poke_span is not None:
                poke_span.end()
            with state.lock:
                state.poked[node] = (warm_fut, fetch_futs, t0, delay_applied)
            with self._stats_lock:
                self.stats["pokes"][node] = self.stats["pokes"].get(node, 0) + 1
            # cascade: a fan-out pokes ALL successors at once, each edge
            # shifted by its learned delay (eager mode: 0) — matching the
            # simulator's poke[v] = min over u of poke[u] + msg + delay(u,v)
            for succ in state.spec.successors(node):
                if not state.spec.node(succ).prefetch:
                    continue
                delay = self.timing.poke_delay(step.name, succ)

                def cascade(succ=succ, delay=delay):
                    if delay > 0:
                        time.sleep(delay)
                    self._poke(state, succ, delay_applied=delay)

                self.registry.executor(step.platform).submit(cascade)
        except BaseException as exc:  # surface poke-path bugs to the client
            state.fail(exc)

    # -- phase 2: payload (dataflow firing) ------------------------------------
    def _deliver(self, state: _RunState, pred: Optional[str], node: str, value):
        """Record one predecessor payload; fire when the LAST one lands.

        Streamed edges fire earlier — ``_deliver_first`` marks the edge on
        its first chunk — so by the time the full payload gets here the
        node is usually already preparing; this then just completes the
        buffer and releases ``payload_done``."""
        if state.error is not None:
            return
        n_preds = len(state.spec.predecessors(node))
        with state.lock:
            if pred is not None:
                state.buffers[node][pred] = value
                state.arrivals[node][pred] = time.perf_counter()
                state.first_seen[node].add(pred)
            full = len(state.buffers[node]) == n_preds
            fire = len(state.first_seen[node]) == n_preds and node not in state.fired
            if fire:
                state.fired.add(node)
        if full:
            state.payload_done[node].set()
        if fire:
            step = state.spec.node(node)
            self.registry.executor(step.platform).submit(self._fire, state, node)

    def _deliver_first(self, state: _RunState, pred: str, node: str):
        """A streamed edge's FIRST chunk landed: fire the node as soon as
        every in-edge has shown its first chunk, overlapping the node's
        prepare (warm + fetch) with the residual chunks still in flight."""
        if state.error is not None:
            return
        with state.lock:
            state.first_seen[node].add(pred)
            fire = (
                len(state.first_seen[node]) == len(state.spec.predecessors(node))
                and node not in state.fired
            )
            if fire:
                state.fired.add(node)
        if fire:
            step = state.spec.node(node)
            self.registry.executor(step.platform).submit(self._fire, state, node)

    def _fire(self, state: _RunState, node: str):
        if state.error is not None:
            return
        try:
            self._run_node(state, node)
        except BaseException as exc:
            state.fail(exc)

    def _transfer(self, state: _RunState, src: str, dst: str, value):
        """Move one edge payload, then deliver it to the join buffer."""
        if state.error is not None:
            return
        try:
            dst_plat = self.registry.get(state.spec.node(dst).platform)
            src_plat = self.registry.get(state.spec.node(src).platform)
            t0 = time.perf_counter()
            span = None
            if state.trace is not None:
                span = state.trace.span(
                    f"transfer:{src}->{dst}",
                    "transfer",
                    t_start=t0,
                    attrs={"src": src, "dst": dst, "platform": dst_plat.name},
                )
            ctx = (
                self.tracer.bind(span)
                if self.tracer is not None and span is not None
                else nullcontext()
            )
            with ctx:
                if not (dst_plat.allows_sync and dst_plat.native_prefetch):
                    nbytes = _sizeof(value)
                    home = self.payload_region or dst_plat.region
                    if self._p2p_eligible(src, dst, nbytes):
                        # direct P2P path: one src->dst hop, no store. The
                        # payload is handed over by reference, and a CUDA
                        # tensor in it needs no event: both platform
                        # threads launch on the device's default stream (a
                        # thread's current stream is the default one unless
                        # a handler sets its own), so the successor's
                        # kernels queue behind the ones that wrote it. A
                        # handler that computes on a stream of its own
                        # synchronises it before it returns. chip_smoke.py
                        # phase 15 (c) sends a served model's caches so, on
                        # the card, and holds decode's tokens to phase 4's.
                        p2p_dt = self.registry.network.transfer_s(
                            src_plat.region, dst_plat.region, nbytes
                        )
                        if self.store.enforce_latency:
                            time.sleep(p2p_dt)
                        if self.telemetry is not None:
                            self.telemetry.record_transfer(
                                src_plat.region, dst_plat.region, nbytes, p2p_dt
                            )
                        with self._stats_lock:
                            self.stats["p2p_edges"] += 1
                    elif self.stream is not None and self.stream.chunks > 1:
                        value = self._transfer_streamed(
                            state, src, dst, value, src_plat, dst_plat, home
                        )
                    else:
                        # public-cloud path: buffer through the object
                        # store, one key per edge; delete after the GET
                        # (no fan-in leak)
                        key = f"__payload__/{state.rid}/{src}->{dst}"
                        self.store.put(key, value, home, from_region=src_plat.region)
                        value, _ = self.store.get(key, dst_plat.region)
                        self.store.delete(key)
                        with self._stats_lock:
                            self.stats["buffered_edges"] += 1
                    if self.telemetry is not None:
                        self.telemetry.record_edge_bytes(src, dst, nbytes)
            dt = time.perf_counter() - t0
            if span is not None:
                span.end()
            with state.lock:
                state.transfer_s[dst][src] = dt
            self._deliver(state, src, dst, value)
        except BaseException as exc:
            state.fail(exc)

    def _p2p_eligible(self, src: str, dst: str, nbytes: int) -> bool:
        """Direct payload path decision: learned per edge from the
        TelemetryHub byte EWMA (so a normally-small edge with one outlier
        payload keeps its fast path), falling back to the live payload's
        actual size before any observation exists."""
        stream = self.stream
        if stream is None or stream.p2p_threshold_bytes <= 0:
            return False
        est = None
        if self.telemetry is not None:
            est = self.telemetry.edge_bytes(src, dst)
        size = est if est is not None else nbytes
        return size <= stream.p2p_threshold_bytes

    def _transfer_streamed(
        self, state: _RunState, src: str, dst: str, value, src_plat, dst_plat, home
    ):
        """Cut-through edge transfer: the payload moves as ``chunks`` wire
        pieces, PUT chunks pacing on the SOURCE platform's executor while
        this (destination-executor) thread drives the matching GET chunks
        one semaphore release behind — so the destination holds chunk i
        after it crossed BOTH hops, and the node fires on chunk 0 while
        the rest pipeline (``_deliver_first``)."""
        chunks = self.stream.chunks
        key = f"__payload__/{state.rid}/{src}->{dst}"
        sem = threading.Semaphore(0)
        errs: list = []
        put_iter = self.store.put_stream(
            key, value, home, from_region=src_plat.region, chunks=chunks
        )

        def producer():
            try:
                for _ in put_iter:
                    sem.release()
            except BaseException as exc:
                errs.append(exc)
                for _ in range(chunks):
                    sem.release()

        self.registry.executor(src_plat.name).submit(producer)
        get_iter = self.store.get_stream(key, dst_plat.region, chunks=chunks)
        out = None
        for i in range(chunks):
            # wait for wire chunk i to clear the first hop; poll so a
            # failed producer (or failed request) can't strand this thread
            while not sem.acquire(timeout=0.1):
                if errs:
                    raise errs[0]
                if state.error is not None:
                    raise state.error
            if errs:
                raise errs[0]
            v, _ = next(get_iter)
            if i == 0:
                self._deliver_first(state, src, dst)
            if v is not None:
                out = v
        self.store.delete(key)
        with self._stats_lock:
            self.stats["streamed_edges"] += 1
        return out

    def _invoke(self, state: _RunState, node, step, fn, payload, data, node_span):
        """Run the node's handler under the retry budget.

        Injected faults are checked BEFORE the handler (the fault model
        fails attempts, not half-executed handlers); real handler errors
        consume attempts the same way. Each retry waits out the policy's
        seeded backoff — the same ``RetryPolicy.backoff_s`` hash the
        simulator prices — and lands as a ``retry`` event on the node span.
        Exhausting the budget re-raises the last error; returns ``(out,
        attempts_used)``."""
        policy = self.retry
        max_attempts = policy.max_attempts if policy is not None else 1
        platform = fn.platform.name
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    self.faults.check(
                        step.name, platform, fn.platform.region,
                        state.req_index, attempt,
                    )
                return self._call_handler(fn, payload, data), attempt + 1
            except BaseException as exc:
                if state.error is not None:
                    raise  # request already cancelled: don't burn budget
                with self._stats_lock:
                    self.stats["attempt_errors"] += 1
                if self.telemetry is not None:
                    self.telemetry.record_error(step.name, platform)
                attempt += 1
                if attempt >= max_attempts:
                    raise
                backoff = policy.backoff_s(
                    attempt - 1, step.name, platform, state.req_index
                )
                with self._stats_lock:
                    self.stats["retries"] += 1
                if node_span is not None:
                    node_span.add_event(
                        "retry",
                        {
                            "attempt": attempt,
                            "node": node,
                            "platform": platform,
                            "error": repr(exc),
                            "backoff_s": backoff,
                            "injected": isinstance(exc, InjectedFault),
                        },
                    )
                if backoff > 0:
                    time.sleep(backoff)

    def _hedge_pool(self, platform: str) -> concurrent.futures.ThreadPoolExecutor:
        with self._stats_lock:
            pool = self._hedge_pools.get(platform)
            if pool is None:
                pool = self._hedge_pools[platform] = (
                    concurrent.futures.ThreadPoolExecutor(
                        max_workers=8,
                        thread_name_prefix=f"plat-{platform}-hedge",
                    )
                )
            return pool

    def _call_handler(self, fn, payload, data):
        """One handler attempt, hedged when the policy asks for it: if the
        primary has not returned after ``hedge_after_s`` a duplicate is
        launched on the platform's side pool; the first finisher wins and
        the loser is cancelled (counted either way). Without a hedge
        deadline this is exactly the old direct call."""
        policy = self.retry
        hedge_after = policy.hedge_after_s if policy is not None else None
        if hedge_after is None:
            return fn.wrapper(payload, data)
        pool = self._hedge_pool(fn.platform.name)
        primary = pool.submit(fn.wrapper, payload, data)
        try:
            return primary.result(timeout=hedge_after)
        except concurrent.futures.TimeoutError:
            pass
        with self._stats_lock:
            self.stats["hedges"] += 1
        backup = pool.submit(fn.wrapper, payload, data)
        done, _ = concurrent.futures.wait(
            {primary, backup}, return_when=concurrent.futures.FIRST_COMPLETED
        )
        winner = primary if primary in done else backup
        loser = backup if winner is primary else primary
        if loser.cancel():
            with self._stats_lock:
                self.stats["hedge_cancelled"] += 1
        if winner is backup:
            with self._stats_lock:
                self.stats["hedge_wins"] += 1
        return winner.result()

    def _run_node(self, state: _RunState, node: str):
        spec = state.spec
        step = spec.node(node)
        fn = self._resolve_step(step)
        preds = spec.predecessors(node)
        timeline = {}
        t_fire = time.perf_counter()
        node_span = None
        if state.trace is not None:
            with state.lock:
                poke_t = state.poke_t.get(node)
            node_span = state.trace.span(
                node,
                "node",
                t_start=t_fire,
                attrs={
                    "node": node,
                    "platform": step.platform,
                    "preds": list(preds),
                    "poke_t": poke_t,
                },
            )

        # poke successors NOW (as early as possible; the learned controller
        # may delay, per edge). The cascade usually got there first — _poke
        # dedups.
        for succ in spec.successors(node):
            if not spec.node(succ).prefetch:
                continue
            delay = self.timing.poke_delay(step.name, succ)

            def do_poke(succ=succ, delay=delay):
                if delay > 0:
                    time.sleep(delay)
                self._poke(state, succ, delay_applied=delay)

            self.registry.executor(step.platform).submit(do_poke)

        # cold start (compile) — hidden iff this node was poked. The warm
        # and fetch windows here are the EXPOSED waits: the background work
        # started at the poke, so joining it measures exactly what the
        # critical path saw.
        prepare_t0 = time.perf_counter()
        t0 = prepare_t0
        with state.lock:
            poked = state.poked.pop(node, None)
        warm_span = None
        if node_span is not None:
            warm_span = state.trace.span(
                f"warm:{node}",
                "warm",
                parent=node_span,
                t_start=t0,
                attrs={"node": node, "platform": step.platform},
            )
        ctx = (
            self.tracer.bind(warm_span)
            if self.tracer is not None and warm_span is not None
            else nullcontext()
        )
        with ctx:
            if fn.compile_fn is not None and fn.abstract_args is not None:
                self.cache.get(
                    fn.name, fn.platform.name, fn.compile_fn, fn.abstract_args
                )
        timeline["warm_s"] = time.perf_counter() - t0
        if warm_span is not None:
            warm_span.end()

        # data deps: join prefetch futures, or fetch cold
        t0 = time.perf_counter()
        fetch_span = None
        if node_span is not None:
            fetch_span = state.trace.span(
                f"fetch:{node}",
                "fetch",
                parent=node_span,
                t_start=t0,
                attrs={"node": node, "platform": step.platform},
            )
        ctx = (
            self.tracer.bind(fetch_span)
            if self.tracer is not None and fetch_span is not None
            else nullcontext()
        )
        with ctx:
            if poked is not None and poked[1]:
                data, exposed, modeled = self.prefetcher.join(poked[1])
                # per-edge slack: each predecessor's payload arrival stamp vs
                # this node's prepare, shifted back by the applied poke delay
                # so the controller sees the gap relative to the undelayed
                # poke
                now = time.perf_counter()
                with state.lock:
                    arrivals = dict(state.arrivals.get(node, {}))
                for u in preds:
                    self.timing.record_slack(
                        u,
                        node,
                        (arrivals.get(u, now) - poked[2]) - modeled + poked[3],
                    )
            elif step.data_deps:
                data, _ = self.prefetcher.fetch_blocking(
                    step.data_deps, fn.platform.region,
                    device=_data_device(fn.platform),
                )
            else:
                data = {}
        prepare_t1 = time.perf_counter()
        timeline["fetch_s"] = prepare_t1 - t0
        if fetch_span is not None:
            fetch_span.end(prepare_t1)
        self.timing.record_prepare(step.name, timeline["warm_s"] + timeline["fetch_s"])

        # streamed edges fire this node on FIRST chunks, so the prepare
        # above overlapped the residual chunks; whatever tail is still in
        # flight is waited out here and surfaced as its own bucket
        t_wait0 = t_wait1 = None
        if self.stream is not None:
            t_wait0 = time.perf_counter()
            while not state.payload_done[node].wait(0.05):
                if state.error is not None:
                    return
            t_wait1 = time.perf_counter()
            timeline["stream_wait_s"] = t_wait1 - t_wait0

        # assemble the input: client payload / unwrapped single pred /
        # fan-in dict keyed by predecessor name
        with state.lock:
            buf = state.buffers.pop(node, {})
            payload_t = state.arrivals.pop(node, {})
            edge_transfer = dict(state.transfer_s.get(node, {}))
            poke_ref = state.poke_t.get(node)
        # per-edge poke-to-payload wait: how long after this node's poke
        # (request start when never poked) each predecessor payload landed
        wait_ref = poke_ref if poke_ref is not None else state.t0
        timeline["payload_wait_s"] = {
            u: payload_t[u] - wait_ref for u in preds if u in payload_t
        }
        timeline["transfer_s"] = edge_transfer
        if not preds:
            payload = state.payload
        elif len(preds) == 1:
            payload = buf[preds[0]]
        else:
            payload = {p: buf[p] for p in preds}
            with self._stats_lock:
                self.stats["joins"] += 1

        # handler
        t0 = time.perf_counter()
        compute_span = None
        if node_span is not None:
            compute_span = state.trace.span(
                f"compute:{node}",
                "compute",
                parent=node_span,
                t_start=t0,
                attrs={"node": node, "platform": step.platform},
            )
        out, attempts = self._invoke(state, node, step, fn, payload, data, node_span)
        t1 = time.perf_counter()
        dt = t1 - t0
        timeline["compute_s"] = dt
        if self.retry is not None or self.faults is not None:
            timeline["attempts"] = attempts
        if compute_span is not None:
            compute_span.end(t1)
        if node_span is not None:
            node_span.attrs.update(
                {
                    "prepare_t0": prepare_t0,
                    "prepare_t1": prepare_t1,
                    "cold_s": timeline["warm_s"],
                    "fetch_s": timeline["fetch_s"],
                    "compute_t0": t0,
                    "compute_s": dt,
                    "payload_t": dict(payload_t),
                    "transfer_s": dict(edge_transfer),
                }
            )
            if t_wait0 is not None:
                node_span.attrs["stream_wait_t0"] = t_wait0
                node_span.attrs["stream_wait_t1"] = t_wait1
            node_span.end(t1)
        self.timing.record_compute(step.name, dt)
        if self.telemetry is not None:
            self.telemetry.record_compute(step.name, fn.platform.name, dt)
        with state.lock:
            state.timeline[node] = timeline

        # hand off along every out-edge (concurrently: each transfer runs
        # on the DESTINATION platform's executor so branches stay parallel)
        succs = spec.successors(node)
        if not succs:
            with state.lock:
                state.outputs[node] = out
                state.pending_sinks.discard(node)
                finished = not state.pending_sinks
            if finished:
                state.done.set()
            return
        for succ in succs:
            self.registry.executor(spec.node(succ).platform).submit(
                self._transfer, state, node, succ, out
            )
