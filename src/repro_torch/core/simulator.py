"""Unified discrete-event simulator for the paper's experiments (§4.2–§4.4).

Public-cloud latencies cannot be measured in this container, so the three
paper experiments are reproduced here: per-component latency distributions
(cold start, object GET/PUT by size, inter-region RTT, compute) are
calibrated so the BASELINE medians match the paper's; the pre-fetching /
shipping deltas then EMERGE from the same two-phase protocol the real
middleware executes (poke cascade -> prepare || predecessor compute ->
payload -> handler). Nothing about the improvement is hard-coded.

ONE recurrence serves chains and DAGs (mirroring the runtime, where the
chain deployer is a facade over the dataflow engine). Per request, with
``u`` ranging over the predecessors of node ``v``:

    poke[v]    = min over u of poke[u] + msg_latency + delay(u->v)
                 (cascade; sources are poked at t0; delay(u->v) is the
                 per-edge learned poke delay, 0 when no controller is set)
    prepare[v] = poke[v] + cold_v + fetch_v              (prefetch on)
    payload[v] = max over u of end[u] + transfer(u -> v) (fan-in join)
    start[v]   = max(payload[v], prepare[v])             (prefetch on)
               = payload[v] + cold_v + fetch_v           (baseline)
    end[v]     = start[v] + compute_v
    total      = max over sinks of end[sink] - t0

With a ``StreamConfig`` attached (the streaming data plane), each edge's
transfer splits into a (first_byte, last_byte) pair: ``payload[v]`` —
and therefore ``start[v]`` — gates on first bytes, while the last bytes
bound the compute tail:

    end[v] = max(start[v] + compute_v,
                 payload_last[v] + compute_v / chunks)

which is the closed form of the per-chunk pipeline (chunk i usable only
after it arrives AND the previous chunk is processed, with the join's
chunk arrivals evenly spaced between first and last byte) — the chunk
inner loop is algebra, not a Python loop, so it vectorizes for free. At
``chunks=1`` first == last and the recurrence is bit-for-bit the one
above.

``run_request`` executes this on the degenerate chain graph — positionally,
so the sampled trace is draw-for-draw what the pre-unification chain
simulator produced. ``run_dag_request`` executes it on an explicit edge
list.

Experiments are described by an ``ExperimentSpec`` (steps, edges,
request stream, seeds, drift, telemetry) and executed by ONE entry point,
``WorkflowSimulator.simulate(spec, backend=...)``, with three backends:

``backend="scalar"``   the per-request loop above — the reference
                       semantics, and the only backend that supports
                       ``timing=`` (per-request poke-delay feedback).
``backend="numpy"``    the request axis vectorized: every per-request
                       scalar becomes a ``(n_requests,)`` numpy array and
                       the graph is walked once, node-major in topo
                       order. The only genuinely sequential piece — the
                       cold-start ``_last_use`` recurrence — collapses to
                       a tight per-(step, platform) scan over the few
                       requests that can possibly be cold (see
                       ``_cold_scan``). Its draw-order contract (per node
                       in topo order: ``n`` cold draws, then ``n`` fetch,
                       then ``n`` compute) is pinned by frozen-reference
                       tests and agrees with the scalar path
                       statistically (medians/p99 within 1%,
                       ``tests/test_vecsim.py``).
``backend="torch"``    the default: the whole (seeds x placements x
                       requests) sweep in one call
                       (``repro_torch.core.torchsim``, the port of the
                       JAX package's ``core/jaxsim.py``): a Python
                       loop over topo order on (seeds, placements,
                       requests) tensors, the cold scan one launch per
                       node of the ``kernels/cold_scan`` CUDA kernel on a
                       card (its plain version on the CPU). Equal to
                       ``numpy`` at sigma=0 (atol 1e-9); its own
                       (torch.Generator) draw contract with spread, within
                       1% on medians/p99 (``tests/test_torch_sim.py``).
                       Runs on ``device="cuda"`` unless the caller passes
                       ``device="cpu"``; with a tracer, sampled requests
                       of the first seed come back as ``obs`` traces,
                       rebuilt on the host from the sweep's sampled
                       arrays (draw-neutral: the totals are the untraced
                       call's, bit for bit). ``simulate_placements`` exposes
                       the placement axis — ``PlacementScorer`` scores an
                       entire candidate set in one call.

``run_experiment`` / ``run_dag_experiment`` / ``run_experiment_many`` are
thin wrappers over ``simulate`` (the legacy ``vectorized=`` flag is a
deprecation shim that maps True/False to ``backend="numpy"``/"scalar").

Double-billing per node (prefetch on) is start - prepare clipped at 0
— the instance is up and idle (paper §5.5); pass a ``PokeTimingController``
as ``timing=`` to shrink it: each edge's poke is delayed by the learned
slack, and the controller is fed per-edge slack observations (relative to
the undelayed poke) plus per-step compute/prepare EWMAs.

Two optional taps serve ``repro.adapt``: ``telemetry=`` feeds a
``TelemetryHub`` the same observation classes the real engine records
(per-(step, platform) compute, per-(key, region) fetch, per-region-pair
transfer, cold/warm counts), and ``drift=`` attaches a ``DriftSchedule``
that rescales a platform's compute/transfer/fetch draws from request k on
(mid-run condition changes). Both are draw-neutral: scaling happens after
sampling, so with them disabled the trace is bit-for-bit the undrifted one.
"""

from __future__ import annotations

import bisect
import math
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.faults import (  # noqa: F401  (re-export: fault injection
    FaultEvent,  # lives next to DriftSchedule on the simulator's surface,
    FaultSchedule,  # and the engine's FaultInjector raises from the same
    OutageEvent,  # schedule — one fault model on both sides of sim/real)
    RetryPolicy,
)
from repro_torch.core.graph import graph_views
from repro_torch.core.store import StreamConfig  # noqa: F401  (re-export: the
#   streaming data plane config is part of the simulator's surface too)


# ---------------------------------------------------------------------------
# latency model pieces
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Dist:
    """Lognormal around a median with multiplicative spread sigma."""

    median: float
    sigma: float = 0.12

    def sample(self, rng: np.random.Generator) -> float:
        if self.median <= 0:
            return 0.0
        return float(self.median * math.exp(rng.normal(0.0, self.sigma)))

    def sample_many(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """``n`` draws in one rng call (the vectorized path). Mirrors
        ``sample``: a degenerate distribution consumes no randomness."""
        if self.median <= 0:
            return np.zeros(n)
        return self.median * np.exp(rng.normal(0.0, self.sigma, n))


@dataclass(frozen=True)
class SimPlatform:
    name: str
    region: str
    native_prefetch: bool = False
    allows_sync: bool = True
    cold_start: Dist = Dist(0.8, 0.3)
    keep_warm_s: float = 900.0


@dataclass(frozen=True)
class SimStep:
    name: str
    platform: str
    compute: Dist
    fetch: Dist = Dist(0.0)  # external data download at the step's region
    prefetch: bool = True
    fetch_key: str = ""  # telemetry key for fetch draws ("" -> step name);
    #   set it to the DataRef key of the matching DagSpec step so simulated
    #   fetch observations are reachable by adapt.costs.observed_costs
    #   (which looks fetches up per dep key, like the real prefetcher)


@dataclass
class RequestTrace:
    total_s: float
    start: list
    end: list
    prepare: list
    payload: list
    double_billed_s: float
    exposed_fetch_s: float


@dataclass
class DagTrace:
    total_s: float
    start: dict
    end: dict
    prepare: dict
    payload: dict
    double_billed_s: float
    exposed_fetch_s: float


@dataclass(frozen=True)
class DriftEvent:
    """From request ``at_request`` on, rescale one platform's draws.

    Models the integer-factor latency drift public clouds exhibit over
    hours (Kulkarni et al., 2025): compute draws on the platform are
    multiplied by ``compute_scale``, transfers touching the platform by
    ``transfer_scale``, external-data fetches at the platform by
    ``fetch_scale``. Scales compose multiplicatively across events."""

    at_request: int
    platform: str
    compute_scale: float = 1.0
    transfer_scale: float = 1.0
    fetch_scale: float = 1.0


class DriftSchedule:
    """Mid-run drift injection for the simulator: a list of ``DriftEvent``.

    The simulator consults ``scales(k, platform)`` with its running request
    index; with no schedule attached (or no event in range) the draw stream
    is bit-for-bit what the un-drifted simulator produces (scaling happens
    AFTER sampling, so rng consumption never changes — the frozen-reference
    tests in tests/test_unified_core.py pin this)."""

    def __init__(self, events=()):
        self.events = tuple(events)
        # scales(k, p) is piecewise constant in k: it only changes when k
        # crosses one of p's event boundaries, so memoize per (platform,
        # segment) — O(1) amortized, cache bounded by events + 1 segments
        # per platform (it used to be O(events) per call, and the scalar
        # simulator calls it per node AND per edge endpoint per request)
        self._thresholds: dict = {}  # platform -> sorted at_request list
        self._segments: dict = {}  # (platform, segment) -> (c, t, f)

    def scales(self, request_k: int, platform: str) -> tuple:
        """(compute_scale, transfer_scale, fetch_scale) at request_k."""
        th = self._thresholds.get(platform)
        if th is None:
            th = self._thresholds[platform] = sorted(
                {e.at_request for e in self.events if e.platform == platform}
            )
        key = (platform, bisect.bisect_right(th, request_k))
        hit = self._segments.get(key)
        if hit is None:
            c = t = f = 1.0
            for e in self.events:
                if e.platform == platform and request_k >= e.at_request:
                    c *= e.compute_scale
                    t *= e.transfer_scale
                    f *= e.fetch_scale
            hit = self._segments[key] = (c, t, f)
        return hit

    def scale_arrays(self, request_ks: np.ndarray, platform: str) -> tuple:
        """``scales`` over a whole request axis at once: three
        ``(n_requests,)`` arrays (compute, transfer, fetch) built from
        boolean masks over the event boundaries (the vectorized path)."""
        n = len(request_ks)
        c, t, f = np.ones(n), np.ones(n), np.ones(n)
        for e in self.events:
            if e.platform != platform:
                continue
            m = request_ks >= e.at_request
            c[m] *= e.compute_scale
            t[m] *= e.transfer_scale
            f[m] *= e.fetch_scale
        return c, t, f


class ObjectLatency:
    """Object-store GET/PUT between regions: fixed per-op overhead + size/bw.
    Captures the paper's §4.4 observation that even a 256 KB cross-provider
    S3 GET costs ~0.8 s (TLS + cross-region + S3 service latency).

    ``p2p_overhead_*`` price the direct peer-to-peer payload path (one
    function streaming to another over a socket, no store round-trip): the
    per-op overhead drops to connection setup, the bandwidth terms stay."""

    def __init__(
        self,
        overhead_same=0.03,
        overhead_cross=0.35,
        bw_same=50e6,
        bw_cross=8e6,
        p2p_overhead_same=0.004,
        p2p_overhead_cross=0.12,
    ):
        self.overhead_same = overhead_same
        self.overhead_cross = overhead_cross
        self.bw_same = bw_same
        self.bw_cross = bw_cross
        self.p2p_overhead_same = p2p_overhead_same
        self.p2p_overhead_cross = p2p_overhead_cross

    def op_s(self, src_region, dst_region, size_bytes):
        same = src_region == dst_region
        oh = self.overhead_same if same else self.overhead_cross
        bw = self.bw_same if same else self.bw_cross
        return oh + size_bytes / bw

    def stream_pair_s(self, src_region, dst_region, size_bytes, chunks: int):
        """(first_byte_s, last_byte_s) of a chunked store round-trip
        (PUT src->dst + GET within dst). The first byte pays both hops'
        per-op overheads on one chunk; the residual chunks then pipeline
        through the bottleneck hop, so last = first + (chunks-1) * chunk /
        min(bw). At ``chunks=1`` both components are exactly the
        whole-object round-trip (same expression, same bits)."""
        if chunks <= 1:
            whole = self.op_s(src_region, dst_region, size_bytes) + self.op_s(
                dst_region, dst_region, size_bytes
            )
            return whole, whole
        chunk = size_bytes / chunks
        first = self.op_s(src_region, dst_region, chunk) + self.op_s(
            dst_region, dst_region, chunk
        )
        bw_hop1 = self.bw_same if src_region == dst_region else self.bw_cross
        last = first + (chunks - 1) * chunk / min(bw_hop1, self.bw_same)
        return first, last

    def p2p_pair_s(self, src_region, dst_region, size_bytes, chunks: int):
        """(first_byte_s, last_byte_s) of the direct peer-to-peer path:
        one hop, connection-setup overhead instead of two store ops."""
        same = src_region == dst_region
        oh = self.p2p_overhead_same if same else self.p2p_overhead_cross
        bw = self.bw_same if same else self.bw_cross
        if chunks <= 1:
            whole = oh + size_bytes / bw
            return whole, whole
        chunk = size_bytes / chunks
        first = oh + chunk / bw
        return first, first + (chunks - 1) * chunk / bw


def _graph(steps, edges):
    """Predecessors, successors, and a deterministic topo order (ties broken
    by ``steps`` order) for an edge-list DAG over named steps."""
    return graph_views([s.name for s in steps], edges)


def serialize_chain(steps, edges):
    """The chain serialization of a DAG: its steps in topological order,
    executed as a linear workflow (the baseline a DAG schedule beats)."""
    _, _, order = _graph(steps, edges)
    by_name = {s.name: s for s in steps}
    return [by_name[n] for n in order]


@dataclass(frozen=True)
class ExperimentSpec:
    """Everything that defines one workflow experiment, independent of how
    it is executed. ``steps`` is the placed workflow (a sequence of
    ``SimStep``); ``edges`` is None for a linear chain or a list of
    ``(src_name, dst_name)`` pairs for a DAG. The request stream is
    ``n_requests`` arrivals spaced ``interarrival_s`` apart. ``seeds`` is
    None for a single run on the simulator's own rng stream, or a sequence
    of seeds for a replicated sweep (one fresh stream per seed — rows of
    the result). ``drift`` / ``telemetry`` / ``tracer`` / ``stream``
    override the simulator's attached ``DriftSchedule`` /
    ``TelemetryHub`` / ``obs.Tracer`` / ``StreamConfig`` for this
    experiment only (None inherits); so do ``faults`` / ``retry`` for the
    attached ``FaultSchedule`` / ``RetryPolicy``. Execute with
    ``WorkflowSimulator.simulate(spec, backend=...)``."""

    steps: tuple
    edges: Optional[tuple] = None
    n_requests: int = 1800
    interarrival_s: float = 1.0
    prefetch: bool = True
    seeds: Optional[tuple] = None
    drift: Optional[DriftSchedule] = None
    telemetry: object = None
    tracer: object = None
    stream: Optional[StreamConfig] = None  # chunked data plane (None = off)
    faults: Optional[FaultSchedule] = None  # fault injection (None = off)
    retry: Optional[RetryPolicy] = None  # retry budget (None = one attempt)

    def __post_init__(self):
        object.__setattr__(self, "steps", tuple(self.steps))
        if self.edges is not None:
            object.__setattr__(self, "edges", tuple(self.edges))
        if self.seeds is not None:
            object.__setattr__(self, "seeds", tuple(self.seeds))


def _spec_graph(steps, edges):
    """The one chain-vs-DAG dispatch: node ids, step map and adjacency for
    either workflow shape. Chains are keyed positionally (duplicate step
    names allowed), DAGs by step name (the edge vocabulary)."""
    if edges is None:
        ids = list(range(len(steps)))
        smap = dict(enumerate(steps))
        preds = {i: ([] if i == 0 else [i - 1]) for i in ids}
        succs = {i: ([i + 1] if i + 1 < len(steps) else []) for i in ids}
        return ids, smap, preds, succs
    smap = {s.name: s for s in steps}
    preds, succs, order = _graph(steps, edges)
    return order, smap, preds, succs


_BACKENDS = ("scalar", "numpy", "torch")

# sentinel: distinguishes "caller did not pass vectorized=" from any value
_VECTORIZED_UNSET = object()


class WorkflowSimulator:
    """One simulator for chains and DAGs: same platforms, latencies,
    cold-start bookkeeping and rng, so results are directly comparable."""

    def __init__(
        self,
        platforms,
        msg_latency_s: float = 0.045,
        object_latency: Optional[ObjectLatency] = None,
        payload_size_bytes: float = 1.5e6,
        seed: int = 0,
        timing=None,
        telemetry=None,
        drift: Optional[DriftSchedule] = None,
        stream: Optional[StreamConfig] = None,
        transfer_table: Optional[dict] = None,
        faults: Optional[FaultSchedule] = None,
        retry: Optional[RetryPolicy] = None,
    ):
        self.platforms = {p.name: p for p in platforms}
        self.msg = msg_latency_s
        self.obj = object_latency or ObjectLatency()
        self.payload_size = payload_size_bytes
        self.seed = seed  # kept for backends that sample per-seed (torch)
        self.rng = np.random.default_rng(seed)
        self.timing = timing  # optional PokeTimingController (per-edge)
        self.telemetry = telemetry  # optional TelemetryHub (repro.adapt)
        self.drift = drift  # optional DriftSchedule (mid-run injection)
        self.stream = stream  # optional StreamConfig (chunked data plane)
        self.faults = faults  # optional FaultSchedule (injected failures)
        self.retry = retry  # optional RetryPolicy (prices retry backoffs)
        # optional {(src_step_name, dst_step_name): seconds} override of the
        # platform transfer model per edge — the calibration entry point
        # (obs.profiler / scripts/trace_diff pin observed per-edge costs)
        self.transfer_table = transfer_table
        self.tracer = None  # optional obs.Tracer (per-request span trees)
        self._req_k = 0  # running request index (feeds the drift schedule)
        self._last_use: dict = {}

    # -- transfer of the inter-step payload ------------------------------------
    def _transfer_s(self, src: SimPlatform, dst: SimPlatform) -> float:
        if dst.native_prefetch and dst.allows_sync and src.region == dst.region:
            return self.msg * 0.1  # direct local call (tinyFaaS)
        # public-cloud path: buffer via object store (PUT at src + GET at dst)
        return self.obj.op_s(src.region, dst.region, self.payload_size) + self.obj.op_s(
            dst.region, dst.region, self.payload_size
        )

    def _transfer_fl(self, src: SimPlatform, dst: SimPlatform) -> tuple:
        """(first_byte_s, last_byte_s) for one edge under the attached
        ``StreamConfig`` (callers check ``self.stream is not None``).
        Direct local calls and whole-object edges (chunks=1, no P2P hit)
        delegate to ``_transfer_s`` — preserving both bit-for-bit equality
        and any scorer subclass override of the whole-object model."""
        stream = self.stream
        local = dst.native_prefetch and dst.allows_sync and src.region == dst.region
        if (
            not local
            and stream.p2p_threshold_bytes > 0
            and self.payload_size <= stream.p2p_threshold_bytes
        ):
            return self.obj.p2p_pair_s(
                src.region, dst.region, self.payload_size, stream.chunks
            )
        if local or stream.chunks <= 1:
            t = self._transfer_s(src, dst)
            return t, t
        return self.obj.stream_pair_s(
            src.region, dst.region, self.payload_size, stream.chunks
        )

    def _cold(self, step: SimStep, t: float) -> float:
        plat = self.platforms[step.platform]
        key = (step.name, step.platform)
        last = self._last_use.get(key, -math.inf)
        cold = (t - last) > plat.keep_warm_s
        return plat.cold_start.sample(self.rng) if cold else 0.0

    # -- drift injection (mid-run condition changes) ---------------------------
    def _scales(self, platform: str) -> tuple:
        if self.drift is None:
            return (1.0, 1.0, 1.0)
        return self.drift.scales(self._req_k, platform)

    def _pair_transfer_fl(self, src_step: SimStep, dst_step: SimStep) -> tuple:
        """Base (first_byte, last_byte) transfer for one edge, BEFORE drift
        — the single resolution point every backend routes through. A
        ``transfer_table`` hit (keyed by step names) overrides the platform
        model with an observed per-edge cost, treated as unsplittable: this
        is how trace-calibrated simulators (``obs.profiler``,
        ``scripts/trace_diff``) pin measured transfers onto the model.
        Without a table the platform model applies unchanged (bit-for-bit:
        whole-object when no ``StreamConfig`` is attached, first/last split
        otherwise)."""
        if self.transfer_table is not None:
            hit = self.transfer_table.get((src_step.name, dst_step.name))
            if hit is not None:
                return hit, hit
        src = self.platforms[src_step.platform]
        dst = self.platforms[dst_step.platform]
        if self.stream is None:
            t = self._transfer_s(src, dst)
            return t, t
        return self._transfer_fl(src, dst)

    def _edge_transfer_s(self, src_step: SimStep, dst_step: SimStep) -> float:
        """Payload transfer for one edge (whole-object view), with drift
        applied: a degraded platform slows every link it terminates (max of
        the two endpoint scales — rescaling AFTER the model keeps rng
        consumption fixed)."""
        if self.transfer_table is not None:
            tr = self.transfer_table.get((src_step.name, dst_step.name))
        else:
            tr = None
        if tr is None:
            tr = self._transfer_s(
                self.platforms[src_step.platform], self.platforms[dst_step.platform]
            )
        if self.drift is not None:
            tr *= max(
                self._scales(src_step.platform)[1],
                self._scales(dst_step.platform)[1],
            )
        return tr

    def _edge_transfer_fl(self, src_step: SimStep, dst_step: SimStep) -> tuple:
        """``_edge_transfer_s`` split into (first_byte, last_byte): the
        payload join gates on the first component, the compute tail on the
        last. With no ``StreamConfig`` both components are the whole-object
        transfer (the exact value ``_edge_transfer_s`` returns)."""
        first, last = self._pair_transfer_fl(src_step, dst_step)
        if self.drift is not None:
            sc = max(
                self._scales(src_step.platform)[1],
                self._scales(dst_step.platform)[1],
            )
            first *= sc
            last *= sc
        return first, last

    # -- the one dataflow recurrence -------------------------------------------
    def _run_graph(
        self, order, steps, preds, succs, t0: float, prefetch: bool, trace: bool = True
    ):
        """``order``: topo-sorted node ids; ``steps``: {id: SimStep};
        ``preds``/``succs``: {id: [ids]}. Ids are arbitrary hashables so the
        chain path can key positionally (duplicate step names allowed).

        When a ``tracer`` is attached (and ``trace`` is True — the stream
        path samples), the request is also emitted as an ``obs`` trace in
        the same span schema the real engine produces. Trace assembly reads
        the recurrence variables AFTER the loop and consumes no randomness,
        so tracing on/off never changes the draw stream (pinned by test)."""
        poke = {v: math.inf for v in order}
        poke0 = {v: math.inf for v in order}  # the undelayed (eager) cascade
        if prefetch:
            for v in order:
                if not preds[v]:
                    poke[v] = poke0[v] = t0
                elif steps[v].prefetch:
                    poke0[v] = min(poke0[u] for u in preds[v]) + self.msg
                    best = math.inf
                    for u in preds[v]:
                        d = 0.0
                        if self.timing is not None:
                            d = self.timing.poke_delay(steps[u].name, steps[v].name)
                        best = min(best, poke[u] + self.msg + d)
                    poke[v] = best

        prepare = {v: 0.0 for v in order}
        payload, start, end = {}, {}, {}
        double_billed = 0.0
        exposed_fetch = 0.0
        tracing = trace and self.tracer is not None
        draws: dict = {}  # v -> (cold, fetch, compute, edge_tr) when tracing
        faults_on = self.faults is not None and bool(self.faults)
        failed = dict.fromkeys(order, False)  # node dead or upstream dead
        fault_rec: dict = {}  # v -> (n_failures, dead) when faults active
        for v in order:
            step = steps[v]
            cold = self._cold(step, t0)
            fetch = step.fetch.sample(self.rng)
            compute = step.compute.sample(self.rng)
            if self.drift is not None:
                csc, _, fsc = self._scales(step.platform)
                compute *= csc
                fetch *= fsc
            # one transfer evaluation per edge per request, shared by the
            # payload join, the telemetry tap, and the timing feedback
            # (deterministic given the endpoints, so reuse is exact);
            # streaming splits it into a (first_byte, last_byte) pair —
            # identical components when no StreamConfig is attached
            edge_fl = {u: self._edge_transfer_fl(steps[u], step) for u in preds[v]}
            if tracing:
                draws[v] = (cold, fetch, compute, edge_fl)
            if not preds[v]:
                payload[v] = payload_last_v = t0 + self.msg / 2
            else:
                payload[v] = max(end[u] + edge_fl[u][0] for u in preds[v])
                payload_last_v = max(end[u] + edge_fl[u][1] for u in preds[v])
            if prefetch and poke[v] < math.inf:
                prepare[v] = poke[v] + cold + fetch
                start[v] = max(payload[v], prepare[v])
                double_billed += max(0.0, start[v] - prepare[v])
                exposed_fetch += max(0.0, prepare[v] - payload[v])
            else:
                start[v] = payload[v] + cold + fetch
                exposed_fetch += fetch
            end[v] = start[v] + compute
            if self.stream is not None and preds[v]:
                # per-chunk pipeline, closed form: the last chunk needs its
                # arrival plus one chunk's compute; never binds at chunks=1
                # (payload_last == payload <= start, so tail <= end). The
                # reciprocal multiply matches the numpy/torch backends' ops.
                tail = payload_last_v + compute * (1.0 / self.stream.chunks)
                if tail > end[v]:
                    end[v] = tail
            fault_up = fault_dead = False
            fault_nf = 0
            if faults_on:
                # fault pricing is a pure hash of (seed, node, request,
                # attempt) — no rng consumed, so the draw stream above is
                # bit-for-bit the fault-free one. Failed attempts delay the
                # node by their backoffs (applied after the streaming tail,
                # before _last_use, so the cold recurrence prices the
                # as-if-completed timeline on every backend identically);
                # an exhausted budget marks the request failed instead of
                # poisoning the recurrence with inf.
                fp = self.faults.plane(
                    step.name,
                    step.platform,
                    self._req_k,
                    self.retry,
                    region=self.platforms[step.platform].region,
                )
                end[v] += float(fp.extra_s[0])
                fault_nf = int(fp.n_failures[0])
                fault_dead = bool(fp.failed[0])
                fault_up = any(failed[u] for u in preds[v])
                failed[v] = fault_up or fault_dead
                if tracing:
                    fault_rec[v] = (fault_nf, fault_dead)
            self._last_use[(step.name, step.platform)] = end[v]
            if self.telemetry is not None and not fault_up:
                # an upstream-dead node never ran: no observations at all.
                # A node that ran records one error per failed attempt; its
                # success-side observations only land when it completed.
                region = self.platforms[step.platform].region
                if fault_nf:
                    self.telemetry.record_error(step.name, step.platform, fault_nf)
                if not fault_dead:
                    self.telemetry.record_compute(step.name, step.platform, compute)
                    if step.fetch.median > 0:
                        # the step's aggregate external fetch at its
                        # platform's region, keyed by fetch_key (default:
                        # the step name)
                        self.telemetry.record_fetch(
                            step.fetch_key or step.name, region, fetch
                        )
                    for u in preds[v]:
                        self.telemetry.record_transfer(
                            self.platforms[steps[u].platform].region,
                            region,
                            self.payload_size,
                            edge_fl[u][1],  # last byte: the whole transfer
                        )
                    if cold > 0:
                        self.telemetry.record_cold_start(
                            step.name, step.platform, cold
                        )
                    else:
                        self.telemetry.record_warm_hit(step.name, step.platform)
            if self.timing is not None and prefetch:
                self.timing.record_prepare(step.name, cold + fetch)
                self.timing.record_compute(step.name, end[v] - start[v])
                if preds[v] and poke[v] < math.inf:
                    # slack relative to the UNDELAYED cascade (poke0): the
                    # observation must not depend on the applied delays, or
                    # the EWMA chases its own feedback (on a fan-in, the
                    # delay embedded in prepare[v] is the argmin edge's,
                    # not each recorded edge's)
                    prepare0 = poke0[v] + cold + fetch
                    for u in preds[v]:
                        arrival = end[u] + edge_fl[u][1]
                        self.timing.record_slack(
                            steps[u].name, steps[v].name, arrival - prepare0
                        )
        total = max(end[v] for v in order if not succs[v]) - t0
        if tracing:
            self._emit_trace(
                order, steps, preds, t0, prefetch, poke, prepare, payload,
                start, end, draws, total, fault_rec=fault_rec,
            )
        if faults_on and any(failed.values()):
            # a dead node makes some sink unreachable: the request never
            # completes (availability accounting reads these as inf)
            total = math.inf
        return prepare, payload, start, end, total, double_billed, exposed_fetch

    def _emit_trace(
        self, order, steps, preds, t0, prefetch, poke, prepare, payload,
        start, end, draws, total, fault_rec=None,
    ):
        """Assemble one finished request into the obs span schema (sim
        clock). Chains may invoke the same step twice — positional ids get
        ``name@id`` labels then, so node names stay unique per trace.

        ``fault_rec`` ({v: (n_failures, dead)}, fault injection active):
        every failed attempt becomes a ``retry`` span event on the node
        span — the same schema the real engine emits — and an exhausted
        budget marks the span (and the root) ``failed``."""
        names = [steps[v].name for v in order]
        dup = len(set(names)) != len(names)

        def label(v):
            return f"{steps[v].name}@{v}" if dup else steps[v].name

        tr = self.tracer
        trace = tr.begin(
            name="sim-request",
            t0=t0,
            attrs={"backend": "scalar", "request_k": self._req_k},
        )
        for v in order:
            step = steps[v]
            cold, fetch, compute, edge_fl = draws[v]
            poked = prefetch and poke[v] < math.inf
            p0 = poke[v] if poked else payload[v]
            p1 = prepare[v] if poked else (payload[v] + cold + fetch)
            payload_t = {label(u): end[u] + edge_fl[u][0] for u in preds[v]}
            transfer_s = {label(u): edge_fl[u][0] for u in preds[v]}
            attrs = {
                "node": label(v),
                "platform": step.platform,
                "preds": [label(u) for u in preds[v]],
                "poke_t": poke[v] if poked else None,
                "prepare_t0": p0,
                "prepare_t1": p1,
                "cold_s": cold,
                "fetch_s": fetch,
                "compute_t0": start[v],
                "compute_s": compute,
                "payload_t": payload_t,
                "transfer_s": transfer_s,
            }
            if self.stream is not None:
                # exposed last-byte time: the compute tail past start+compute
                attrs["stream_wait_t0"] = start[v] + compute
                attrs["stream_wait_t1"] = end[v]
            node_span = trace.span(
                label(v),
                "node",
                t_start=min(p0, payload[v]),
                attrs=attrs,
            )
            if fault_rec and v in fault_rec:
                nf, dead = fault_rec[v]
                for a in range(nf):
                    node_span.add_event(
                        "retry",
                        {
                            "attempt": a + 1,
                            "node": label(v),
                            "platform": step.platform,
                            "injected": True,
                        },
                        t=start[v],
                    )
                if dead:
                    node_span.attrs["failed"] = True
                    trace.root.attrs["failed"] = True
            node_span.end(end[v])
            phases = [
                ("warm", p0, p0 + cold),
                ("fetch", p0 + cold, p1),
                ("compute", start[v], start[v] + compute),
            ]
            if self.stream is not None and end[v] > start[v] + compute:
                phases.append(("stream_wait", start[v] + compute, end[v]))
            for phase, a, b in phases:
                ps = trace.span(
                    f"{phase}:{label(v)}",
                    phase,
                    parent=node_span,
                    t_start=a,
                    attrs={"node": label(v), "platform": step.platform},
                )
                ps.end(b)
            for u in preds[v]:
                ts = trace.span(
                    f"transfer:{label(u)}->{label(v)}",
                    "transfer",
                    t_start=end[u],
                    attrs={"src": label(u), "dst": label(v), "platform": step.platform},
                )
                ts.end(end[u] + edge_fl[u][0])
        tr.finish(trace, t_end=t0 + total)

    # -- the batched fast path (request axis vectorized) -----------------------
    def _cold_scan(
        self,
        t0s: np.ndarray,
        warm_end: np.ndarray,
        cold_end: np.ndarray,
        keep_warm_s: float,
    ) -> np.ndarray:
        """Boolean cold mask for one (step, platform) node: the ``_last_use``
        recurrence, request-major. ``warm_end``/``cold_end`` are the node's
        end times under the warm / cold hypothesis (``cold_end >= warm_end``
        since the cold draw is nonnegative).

        A request k can only be cold if even the EARLIEST possible previous
        end — the warm one — left a gap past ``keep_warm_s``; everything
        else is warm by construction. So the scan walks just those
        candidates (for the paper's 1 req/s streams that is request 0 and
        nothing else), resolving each against the actual previous end
        (cold or warm per the mask built so far). Exact, and O(candidates)
        instead of O(n_requests)."""
        n = len(t0s)
        mask = np.zeros(n, dtype=bool)
        if n == 0:
            return mask
        # request 0 measures against _last_use = -inf (fresh experiment)
        mask[0] = math.inf > keep_warm_s
        cand = np.nonzero(t0s[1:] - warm_end[:-1] > keep_warm_s)[0] + 1
        for k in cand:
            last = cold_end[k - 1] if mask[k - 1] else warm_end[k - 1]
            mask[k] = (t0s[k] - last) > keep_warm_s
        return mask

    def _run_graph_vectorized(
        self, order, steps, preds, succs, t0s: np.ndarray, prefetch: bool
    ) -> np.ndarray:
        """``_run_graph`` with the request axis vectorized: one pass over
        the nodes in topo order, every recurrence variable a ``(n,)`` array.
        Returns the per-request totals.

        Draw-order contract (pinned by tests/test_vecsim.py): per node in
        topo order, ``n`` cold-start draws, then ``n`` fetch draws, then
        ``n`` compute draws — so the stream differs from the scalar path's
        request-major interleaving but every marginal distribution is
        identical (cold draws are masked by the ``_cold_scan`` result
        instead of being conditionally consumed). Telemetry is fed one
        aggregate observation batch per node/edge rather than n singles.

        Not supported here (use the scalar path): ``timing=`` (the learned
        poke delay is per-request feedback, inherently sequential) and
        graphs where one (name, platform) pair spans several nodes (its
        cold recurrence couples nodes across requests)."""
        if self.timing is not None:
            raise ValueError(
                "vectorized experiments do not support timing=: the poke "
                "controller learns from per-request feedback; use the "
                "scalar backend (backend='scalar')"
            )
        keys = [(steps[v].name, steps[v].platform) for v in order]
        if len(set(keys)) != len(keys):
            raise ValueError(
                "vectorized experiments need a unique (name, platform) per "
                "node — a duplicated pair couples the cold-start recurrence "
                "across nodes; use the scalar backend (backend='scalar')"
            )
        n = len(t0s)
        if n == 0:
            self._req_k = 0
            return np.empty(0)
        request_ks = np.arange(n)
        scale_cache: dict = {}

        def scales_for(platform: str) -> tuple:
            arrs = scale_cache.get(platform)
            if arrs is None:
                arrs = scale_cache[platform] = self.drift.scale_arrays(
                    request_ks, platform
                )
            return arrs

        inf = np.full(n, math.inf)
        tel = self.telemetry
        tracing = self.tracer is not None
        rec: dict = {}  # v -> per-request arrays, retained only when tracing
        poke: dict = {}
        end: dict = {}
        total = np.full(n, -math.inf)
        faults_on = self.faults is not None and bool(self.faults)
        failed_by_node: dict = {}  # v -> (n,) bool, own-dead OR upstream-dead
        failed_any = np.zeros(n, dtype=bool)
        fault_rec: dict = {}  # v -> (n_failures, node_failed) when tracing
        for v in order:
            step = steps[v]
            plat = self.platforms[step.platform]
            cold_draw = plat.cold_start.sample_many(self.rng, n)
            fetch = step.fetch.sample_many(self.rng, n)
            compute = step.compute.sample_many(self.rng, n)
            if self.drift is not None:
                csc, _, fsc = scales_for(step.platform)
                compute = compute * csc
                fetch = fetch * fsc
            fp = None
            node_ok = None  # rows whose success-side telemetry should land
            if faults_on:
                # the fault plane is hash-based (no rng) — draws above are
                # bit-for-bit the fault-free stream; see _run_graph
                fp = self.faults.plane(
                    step.name, step.platform, request_ks, self.retry,
                    region=plat.region,
                )
                up = np.zeros(n, dtype=bool)
                for u in preds[v]:
                    up |= failed_by_node[u]
                node_failed = up | fp.failed
                failed_by_node[v] = node_failed
                failed_any |= fp.failed
                node_ok = ~node_failed
                if tel is not None:
                    # one error per failed attempt of every node that RAN
                    # (upstream-dead nodes never launched their attempts)
                    n_err = int(fp.n_failures[~up].sum())
                    if n_err:
                        tel.record_error_batch(step.name, step.platform, n_err)
                if tracing:
                    fault_rec[v] = (fp.n_failures, node_failed)
            # poke cascade (min over in-edges; structural, uniform over k)
            if not prefetch:
                poke_v = inf
            elif not preds[v]:
                poke_v = t0s
            elif step.prefetch:
                poke_v = np.minimum.reduce([poke[u] for u in preds[v]]) + self.msg
            else:
                poke_v = inf
            poke[v] = poke_v
            # payload join (max over in-edges of upstream end + transfer);
            # streaming gates it on first bytes and tracks last bytes too
            stream_on = self.stream is not None
            edge_tr: dict = {}
            payload_last = None
            if not preds[v]:
                payload = t0s + self.msg / 2
                if stream_on:
                    payload_last = payload
            else:
                arrivals = []
                arrivals_last = []
                for u in preds[v]:
                    first, last = self._pair_transfer_fl(steps[u], step)
                    if self.drift is not None:
                        sc = np.maximum(
                            scales_for(steps[u].platform)[1],
                            scales_for(step.platform)[1],
                        )
                        first = first * sc
                        last = last * sc if stream_on else first
                    arrivals.append(end[u] + first)
                    if stream_on:
                        arrivals_last.append(end[u] + last)
                    if tracing:
                        edge_tr[u] = np.broadcast_to(np.asarray(first, float), (n,))
                    if tel is not None:
                        last_rows = np.broadcast_to(last, (n,))
                        if node_ok is not None:
                            last_rows = last_rows[node_ok]
                        tel.record_transfer_batch(
                            self.platforms[steps[u].platform].region,
                            plat.region,
                            self.payload_size,
                            last_rows,
                        )
                payload = np.maximum.reduce(arrivals)
                if stream_on:
                    payload_last = np.maximum.reduce(arrivals_last)
            # start/end under both cold hypotheses, then the cold scan
            if prefetch and not math.isinf(poke_v[0]):
                warm_start = np.maximum(payload, poke_v + fetch)
                cold_start = np.maximum(payload, poke_v + cold_draw + fetch)
            else:
                warm_start = payload + fetch
                cold_start = warm_start + cold_draw
            warm_end = warm_start + compute
            cold_end = cold_start + compute
            if stream_on and preds[v]:
                # per-chunk pipeline tail (closed form; see _run_graph) —
                # applied to both hypotheses, so cold_end >= warm_end holds
                tail = payload_last + compute * (1.0 / self.stream.chunks)
                warm_end = np.maximum(warm_end, tail)
                cold_end = np.maximum(cold_end, tail)
            if fp is not None:
                # retry backoffs delay the node under BOTH hypotheses (the
                # offset preserves cold_end >= warm_end), after the
                # streaming tail and before the cold scan — matching the
                # scalar path's end[v] += extra ordering exactly
                warm_end = warm_end + fp.extra_s
                cold_end = cold_end + fp.extra_s
            mask = self._cold_scan(t0s, warm_end, cold_end, plat.keep_warm_s)
            end_v = np.where(mask, cold_end, warm_end)
            end[v] = end_v
            if tracing:
                rec[v] = (
                    poke_v, payload, mask, cold_draw, fetch, compute, edge_tr,
                    payload_last,
                )
            self._last_use[(step.name, step.platform)] = float(end_v[-1])
            if tel is not None:
                ok = node_ok if node_ok is not None else slice(None)
                tel.record_compute_batch(step.name, step.platform, compute[ok])
                if step.fetch.median > 0:
                    tel.record_fetch_batch(
                        step.fetch_key or step.name, plat.region, fetch[ok]
                    )
                ok_mask = mask if node_ok is None else (mask & node_ok)
                n_cold = int(ok_mask.sum())
                n_seen = n if node_ok is None else int(node_ok.sum())
                tel.record_cold_start_batch(
                    step.name,
                    step.platform,
                    n_cold,
                    n_seen - n_cold,
                    cold_draw[ok_mask],
                )
            if not succs[v]:
                total = np.maximum(total, end_v)
        if tracing:
            self._emit_traces_vectorized(
                order, steps, preds, prefetch, t0s, rec, end,
                fault_rec=fault_rec if faults_on else None,
            )
        self._req_k = n
        totals = total - t0s
        if faults_on and failed_any.any():
            # dead requests are priced as-if-completed inside the
            # recurrence (cold bookkeeping stays backend-identical) but
            # REPORTED as never finishing
            totals = np.where(failed_any, math.inf, totals)
        return totals

    def _emit_traces_vectorized(
        self, order, steps, preds, prefetch, t0s, rec, end, fault_rec=None
    ):
        """Sampled per-request traces from the retained vectorized arrays:
        ``tracer.sample`` evenly spaced requests become ``obs`` traces in
        the same schema as the scalar path — pure array indexing after the
        fact, so the draw stream is untouched. ``fault_rec`` ({v:
        (n_failures, node_failed) arrays}) adds the scalar path's ``retry``
        span events / ``failed`` marks to the sampled requests."""
        names = [steps[v].name for v in order]
        dup = len(set(names)) != len(names)

        def label(v):
            return f"{steps[v].name}@{v}" if dup else steps[v].name

        tr = self.tracer
        for k in self._trace_sample_idx(len(t0s)).tolist():
            t0 = float(t0s[k])
            trace = tr.begin(
                name="sim-request",
                t0=t0,
                attrs={"backend": "numpy", "request_k": k},
            )
            t_sink = t0
            for v in order:
                step = steps[v]
                (
                    poke_v, payload, mask, cold_draw, fetch, compute, edge_tr,
                    payload_last,
                ) = rec[v]
                poked = prefetch and not math.isinf(float(poke_v[k]))
                cold = float(cold_draw[k]) if mask[k] else 0.0
                fetch_k = float(fetch[k])
                compute_k = float(compute[k])
                end_k = float(end[v][k])
                pay_k = float(payload[k])
                p0 = float(poke_v[k]) if poked else pay_k
                p1 = p0 + cold + fetch_k
                if payload_last is None:
                    start_k = end_k - compute_k
                else:
                    # end may carry a streaming tail past start + compute,
                    # so recompute start from the gating quantities
                    start_k = max(pay_k, p1) if poked else p1
                payload_t = {
                    label(u): float(end[u][k]) + float(edge_tr[u][k])
                    for u in preds[v]
                }
                transfer_s = {label(u): float(edge_tr[u][k]) for u in preds[v]}
                attrs = {
                    "node": label(v),
                    "platform": step.platform,
                    "preds": [label(u) for u in preds[v]],
                    "poke_t": p0 if poked else None,
                    "prepare_t0": p0,
                    "prepare_t1": p1,
                    "cold_s": cold,
                    "fetch_s": fetch_k,
                    "compute_t0": start_k,
                    "compute_s": compute_k,
                    "payload_t": payload_t,
                    "transfer_s": transfer_s,
                }
                if payload_last is not None:
                    attrs["stream_wait_t0"] = start_k + compute_k
                    attrs["stream_wait_t1"] = end_k
                node_span = trace.span(
                    label(v),
                    "node",
                    t_start=min(p0, pay_k),
                    attrs=attrs,
                )
                if fault_rec is not None and v in fault_rec:
                    nf_a, dead_a = fault_rec[v]
                    for a in range(int(nf_a[k])):
                        node_span.add_event(
                            "retry",
                            {
                                "attempt": a + 1,
                                "node": label(v),
                                "platform": step.platform,
                                "injected": True,
                            },
                            t=start_k,
                        )
                    if bool(dead_a[k]):
                        node_span.attrs["failed"] = True
                        trace.root.attrs["failed"] = True
                node_span.end(end_k)
                t_sink = max(t_sink, end_k)
            tr.finish(trace, t_end=t_sink)

    # -- one chain request (degenerate DAG, positional keys) -------------------
    def run_request(self, steps, t0: float, prefetch: bool) -> RequestTrace:
        ids = list(range(len(steps)))
        smap = dict(enumerate(steps))
        preds = {i: ([] if i == 0 else [i - 1]) for i in ids}
        succs = {i: ([i + 1] if i + 1 < len(steps) else []) for i in ids}
        prepare, payload, start, end, total, db, ef = self._run_graph(
            ids, smap, preds, succs, t0, prefetch
        )
        self._req_k += 1
        return RequestTrace(
            total,
            [start[i] for i in ids],
            [end[i] for i in ids],
            [prepare[i] for i in ids],
            [payload[i] for i in ids],
            db,
            ef,
        )

    # -- one DAG request (explicit edge list, name keys) -----------------------
    def run_dag_request(self, steps, edges, t0: float, prefetch: bool) -> DagTrace:
        smap = {s.name: s for s in steps}
        preds, succs, order = _graph(steps, edges)
        prepare, payload, start, end, total, db, ef = self._run_graph(
            order, smap, preds, succs, t0, prefetch
        )
        self._req_k += 1
        return DagTrace(total, start, end, prepare, payload, db, ef)

    # -- the one experiment entry point -----------------------------------------
    def simulate(
        self, spec: ExperimentSpec, backend: str = "torch", device="cuda"
    ) -> np.ndarray:
        """Run one experiment described by ``spec`` on the chosen backend
        (``"scalar"``, ``"numpy"`` or ``"torch"`` — see the module docstring
        for the matrix). Returns per-request totals: shape
        ``(n_requests,)`` when ``spec.seeds`` is None, else
        ``(len(seeds), n_requests)`` with one fresh rng stream per seed
        (the simulator's own rng is restored afterwards), so
        ``np.median(out, axis=1)`` gives the per-seed medians error bars
        are built from.

        ``backend="scalar"`` is the per-request reference loop (the only
        one that supports ``timing=``); ``"numpy"`` vectorizes the request
        axis; ``"torch"`` runs the whole sweep on ``device`` (its draws
        come from ``torch.Generator``, so it matches the others
        statistically, and to 1e-9 at sigma=0; with ``spec.seeds=None`` it
        runs the simulator's construction seed rather than continuing the
        numpy stream). The torch backend is the default: it runs on
        ``device``, the card unless the caller passes ``device="cpu"``, and
        raises without one; the host backends are named to be used and
        ignore ``device``. With a tracer (``spec.tracer`` or the
        simulator's), the torch backend rebuilds ``tracer.sample`` evenly
        spaced requests of the first seed as ``obs`` traces."""
        if backend == "torch":
            tracer = spec.tracer if spec.tracer is not None else self.tracer
            totals = self.simulate_placements(
                spec, [spec.steps], device=device, _tracer=tracer
            )[:, 0, :]
            return totals if spec.seeds is not None else totals[0]
        if backend not in _BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}: expected one of {_BACKENDS}"
            )
        saved_drift, saved_tel = self.drift, self.telemetry
        saved_tracer, saved_stream = self.tracer, self.stream
        saved_faults, saved_retry = self.faults, self.retry
        if spec.drift is not None:
            self.drift = spec.drift
        if spec.telemetry is not None:
            self.telemetry = spec.telemetry
        if spec.tracer is not None:
            self.tracer = spec.tracer
        if spec.stream is not None:
            self.stream = spec.stream
        if spec.faults is not None:
            self.faults = spec.faults
        if spec.retry is not None:
            self.retry = spec.retry
        try:
            order, smap, preds, succs = _spec_graph(spec.steps, spec.edges)
            t0s = np.arange(spec.n_requests) * spec.interarrival_s
            if spec.seeds is None:
                return self._run_stream(
                    order, smap, preds, succs, t0s, spec.prefetch, backend
                )
            out = np.empty((len(spec.seeds), spec.n_requests))
            saved_rng = self.rng
            try:
                for i, seed in enumerate(spec.seeds):
                    self.rng = np.random.default_rng(seed)
                    out[i] = self._run_stream(
                        order, smap, preds, succs, t0s, spec.prefetch, backend
                    )
            finally:
                self.rng = saved_rng
            return out
        finally:
            self.drift, self.telemetry = saved_drift, saved_tel
            self.tracer, self.stream = saved_tracer, saved_stream
            self.faults, self.retry = saved_faults, saved_retry

    def _trace_sample_idx(self, n: int) -> np.ndarray:
        """Which request indices of an n-request stream get a trace:
        ``tracer.sample`` evenly spaced requests, chosen deterministically
        (never from the experiment rng — sampling stays draw-neutral)."""
        k = getattr(self.tracer, "sample", 8) or 0
        if n == 0 or k <= 0:
            return np.empty(0, dtype=int)
        return np.unique(np.linspace(0, n - 1, min(k, n)).round().astype(int))

    def _run_stream(self, order, smap, preds, succs, t0s, prefetch, backend):
        """One request stream on the current rng: the scalar loop or the
        vectorized pass, from a fresh experiment (cold containers, drift
        indexed from request 0)."""
        self._last_use = {}
        self._req_k = 0
        if backend == "numpy":
            return self._run_graph_vectorized(order, smap, preds, succs, t0s, prefetch)
        sampled = (
            frozenset(self._trace_sample_idx(len(t0s)).tolist())
            if self.tracer is not None
            else frozenset()
        )
        out = np.empty(len(t0s))
        for k, t0 in enumerate(t0s):
            out[k] = self._run_graph(
                order, smap, preds, succs, float(t0), prefetch, trace=k in sampled
            )[4]
            self._req_k += 1
        return out

    def simulate_placements(
        self, spec: ExperimentSpec, placements, dtype=np.float64, device="cuda",
        _tracer=None,
    ) -> np.ndarray:
        """Score a whole candidate placement set under common random
        numbers in ONE torch sweep on ``device``: ``placements`` is a
        sequence of step-sequences, each shaped like ``spec.steps`` (same
        length for a chain, same step names for a DAG — only the platform
        assignments and per-step distributions differ). Returns totals of
        shape ``(n_seeds, n_placements, n_requests)``; seeds default to the
        simulator's construction seed. Every placement sees the same
        per-seed draws, so differences between rows are placement effects,
        not sampling noise (the scorer's CRN property). ``dtype=np.float32``
        halves memory traffic for big sweeps at ~1e-7 relative cost.

        ``device`` defaults to the card ("cuda") and raises without one;
        pass ``device="cpu"`` to run the sweep on the host.

        ``_tracer`` is the private hand-off from ``simulate(backend="torch",
        tracer=...)``: sampled per-request ``obs`` traces are rebuilt
        host-side for the FIRST seed and FIRST placement (the spec's own
        steps when called through ``simulate``). Public placement-scoring
        callers never pass it, so the scorer path stays pure."""
        from repro_torch.core import torchsim  # deferred: torch pays init cost

        telemetry = spec.telemetry if spec.telemetry is not None else self.telemetry
        if telemetry is not None:
            raise ValueError(
                "backend='torch' does not support telemetry=: observations "
                "are per-request side effects; use backend='numpy'"
            )
        placements = [tuple(p) for p in placements]
        if not placements:
            raise ValueError("placements must be non-empty")
        order, _, preds, succs = _spec_graph(placements[0], spec.edges)
        if spec.edges is None:
            step_sets = [dict(enumerate(p)) for p in placements]
        else:
            step_sets = [{s.name: s for s in p} for p in placements]
        seeds = spec.seeds if spec.seeds is not None else (self.seed,)
        drift = spec.drift if spec.drift is not None else self.drift
        stream = spec.stream if spec.stream is not None else self.stream
        faults = spec.faults if spec.faults is not None else self.faults
        retry = spec.retry if spec.retry is not None else self.retry
        t0s = np.arange(spec.n_requests) * spec.interarrival_s
        if _tracer is None:
            return torchsim.run_batched(
                self, order, step_sets, preds, succs, t0s, spec.prefetch,
                list(seeds), drift=drift, dtype=dtype, stream=stream,
                faults=faults, retry=retry, device=device,
            )
        sample_idx = np.unique(
            np.linspace(
                0,
                max(spec.n_requests - 1, 0),
                min(getattr(_tracer, "sample", 8) or 0, spec.n_requests),
            )
            .round()
            .astype(int)
        )
        # the sampled arrays come back to the host in one copy each
        totals, sampled = torchsim.run_batched(
            self, order, step_sets, preds, succs, t0s, spec.prefetch,
            list(seeds), drift=drift, dtype=dtype, sample_idx=sample_idx,
            stream=stream, faults=faults, retry=retry, device=device,
        )
        self._emit_traces_torch(
            order,
            step_sets[0],
            preds,
            spec.prefetch,
            t0s,
            sample_idx,
            tuple(a[0, 0] for a in sampled),  # first seed, first placement
            drift,
            _tracer,
            seed=seeds[0],
            stream=stream,
        )
        return totals

    def _emit_traces_torch(
        self, order, steps, preds, prefetch, t0s, sample_idx, sampled,
        drift, tracer, seed, stream=None,
    ):
        """Rebuild ``obs`` traces from the torch sweep's sampled arrays
        (payload / effective cold / fetch / compute / end, each (V, k) host
        numpy). The draw-free pieces are recomputed host-side: the poke
        cascade is ``t0 + depth * msg`` (static hop depths) and the
        transfer model is deterministic given the endpoints (+ drift
        scales at the sampled request index) — the exact arrays
        ``torchsim._build`` feeds the device."""
        from repro_torch.core import torchsim

        payload_a, cold_a, fetch_a, compute_a, end_a = sampled
        saved_stream = self.stream
        self.stream = stream  # _transfer_fl reads it (restored in finally)
        try:
            self._emit_traces_torch_inner(
                torchsim, order, steps, preds, prefetch, t0s, sample_idx,
                payload_a, cold_a, fetch_a, compute_a, end_a, drift, tracer,
                seed, stream,
            )
        finally:
            self.stream = saved_stream

    def _emit_traces_torch_inner(
        self, torchsim, order, steps, preds, prefetch, t0s, sample_idx,
        payload_a, cold_a, fetch_a, compute_a, end_a, drift, tracer, seed,
        stream,
    ):
        depth = torchsim._poke_depths(order, steps, preds)
        idx = {v: i for i, v in enumerate(order)}
        names = [steps[v].name for v in order]
        dup = len(set(names)) != len(names)

        def label(v):
            return f"{steps[v].name}@{v}" if dup else steps[v].name

        for j, k in enumerate(np.asarray(sample_idx).tolist()):
            t0 = float(t0s[k])
            trace = tracer.begin(
                name="sim-request",
                t0=t0,
                attrs={"backend": "torch", "request_k": int(k), "seed": int(seed)},
            )
            t_sink = t0
            for i, v in enumerate(order):
                step = steps[v]
                poked = prefetch and math.isfinite(depth[i])
                poke_t = float(t0 + depth[i] * self.msg) if poked else None
                cold = float(cold_a[i, j])
                fetch = float(fetch_a[i, j])
                compute = float(compute_a[i, j])
                end_k = float(end_a[i, j])
                pay_k = float(payload_a[i, j])
                p0 = poke_t if poked else pay_k
                p1 = p0 + cold + fetch
                if stream is None:
                    start_k = end_k - compute
                else:
                    # end may carry a streaming tail past start + compute
                    start_k = max(pay_k, p1) if poked else p1
                payload_t, transfer_s = {}, {}
                for u in preds[v]:
                    tr = self._pair_transfer_fl(steps[u], step)[0]
                    if drift is not None:
                        tr *= max(
                            drift.scales(k, steps[u].platform)[1],
                            drift.scales(k, step.platform)[1],
                        )
                    tr = float(tr)  # attrs hold Python numbers only
                    payload_t[label(u)] = float(end_a[idx[u], j]) + tr
                    transfer_s[label(u)] = tr
                attrs = {
                    "node": label(v),
                    "platform": step.platform,
                    "preds": [label(u) for u in preds[v]],
                    "poke_t": poke_t,
                    "prepare_t0": p0,
                    "prepare_t1": p1,
                    "cold_s": cold,
                    "fetch_s": fetch,
                    "compute_t0": start_k,
                    "compute_s": compute,
                    "payload_t": payload_t,
                    "transfer_s": transfer_s,
                }
                if stream is not None:
                    attrs["stream_wait_t0"] = start_k + compute
                    attrs["stream_wait_t1"] = end_k
                node_span = trace.span(
                    label(v),
                    "node",
                    t_start=min(p0, pay_k),
                    attrs=attrs,
                )
                node_span.end(end_k)
                t_sink = max(t_sink, end_k)
            tracer.finish(trace, t_end=t_sink)

    # -- legacy wrappers (paper: 1 req/s for 30 min) ----------------------------
    def _shim_backend(self, vectorized, backend, default):
        if vectorized is not _VECTORIZED_UNSET:
            warnings.warn(
                "vectorized= is deprecated; pass backend='numpy' "
                "(vectorized=True) or backend='scalar' (vectorized=False)",
                DeprecationWarning,
                stacklevel=3,
            )
            if backend is not None:
                raise TypeError(
                    "pass either backend= or the deprecated vectorized=, "
                    "not both"
                )
            return "numpy" if vectorized else "scalar"
        return backend if backend is not None else default

    def run_experiment(
        self,
        steps,
        n_requests: int = 1800,
        interarrival_s: float = 1.0,
        prefetch: bool = True,
        vectorized=_VECTORIZED_UNSET,
        *,
        backend: Optional[str] = None,
    ) -> np.ndarray:
        backend = self._shim_backend(vectorized, backend, "scalar")
        return self.simulate(
            ExperimentSpec(
                steps,
                n_requests=n_requests,
                interarrival_s=interarrival_s,
                prefetch=prefetch,
            ),
            backend=backend,
        )

    def run_dag_experiment(
        self,
        steps,
        edges,
        n_requests: int = 1800,
        interarrival_s: float = 1.0,
        prefetch: bool = True,
        vectorized=_VECTORIZED_UNSET,
        *,
        backend: Optional[str] = None,
    ) -> np.ndarray:
        backend = self._shim_backend(vectorized, backend, "scalar")
        return self.simulate(
            ExperimentSpec(
                steps,
                edges=edges,
                n_requests=n_requests,
                interarrival_s=interarrival_s,
                prefetch=prefetch,
            ),
            backend=backend,
        )

    def run_experiment_many(
        self,
        steps,
        seeds,
        n_requests: int = 1800,
        interarrival_s: float = 1.0,
        prefetch: bool = True,
        edges=None,
        vectorized=_VECTORIZED_UNSET,
        *,
        backend: Optional[str] = None,
    ) -> np.ndarray:
        """Seed sweep, ``(len(seeds), n_requests)`` — see ``simulate``."""
        backend = self._shim_backend(vectorized, backend, "numpy")
        return self.simulate(
            ExperimentSpec(
                steps,
                edges=edges,
                n_requests=n_requests,
                interarrival_s=interarrival_s,
                prefetch=prefetch,
                seeds=tuple(seeds),
            ),
            backend=backend,
        )


def median(xs) -> float:
    return float(np.median(np.asarray(xs)))


# ---------------------------------------------------------------------------
# calibrated setups for the three paper experiments
# ---------------------------------------------------------------------------
def paper_platforms():
    return [
        SimPlatform(
            "tinyfaas-edge",
            "europe-west10",
            native_prefetch=True,
            allows_sync=True,
            cold_start=Dist(0.35, 0.3),
        ),
        SimPlatform("gcf", "europe-west10", cold_start=Dist(2.2, 0.4)),
        SimPlatform("lambda-us-east-1", "us-east-1", cold_start=Dist(1.1, 0.4)),
        SimPlatform("lambda-eu-central-1", "eu-central-1", cold_start=Dist(1.1, 0.4)),
    ]


def document_workflow_fig4():
    """§4.2: check (edge) -> virus (GCF) -> ocr (Lambda us) -> e_mail
    (Lambda us); all but the first step download data. Calibrated so the
    BASELINE median lands at the paper's 4.65 s."""
    return [
        SimStep("check", "tinyfaas-edge", compute=Dist(0.22)),
        SimStep("virus", "gcf", compute=Dist(0.30), fetch=Dist(0.32)),
        SimStep("ocr", "lambda-us-east-1", compute=Dist(0.45), fetch=Dist(1.45)),
        SimStep("e_mail", "lambda-us-east-1", compute=Dist(0.20), fetch=Dist(0.85)),
    ]


def shipping_workflow_fig6(ocr_platform: str):
    """§4.3: check+virus on the edge node, e_mail in us-east-1; only OCR
    fetches (large scanned documents; the data lives in us-east-1).
    ocr_platform is 'lambda-eu-central-1' (far) or 'lambda-us-east-1'
    (close). Both variants pre-fetch."""
    fetch = Dist(3.6) if ocr_platform == "lambda-eu-central-1" else Dist(0.9)
    return [
        SimStep("check", "tinyfaas-edge", compute=Dist(0.25)),
        SimStep("virus", "tinyfaas-edge", compute=Dist(0.40)),
        SimStep("ocr", ocr_platform, compute=Dist(5.85), fetch=fetch),
        SimStep("e_mail", "lambda-us-east-1", compute=Dist(0.35)),
    ]


def native_prefetch_workflow_fig8():
    """§4.4: two functions on the same edge node; A computes 5 s, B fetches
    256 KB from cross-provider object storage."""
    return [
        SimStep("func_a", "tinyfaas-edge", compute=Dist(5.0, 0.02)),
        SimStep("func_b", "tinyfaas-edge", compute=Dist(0.06), fetch=Dist(0.78)),
    ]
