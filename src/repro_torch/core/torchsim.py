"""Torch backend for the unified workflow simulator (``backend="torch"``).

Port of the JAX package's ``core/jaxsim.py``. One call sweeps (seeds x
placements x requests): every ``Dist`` draw is pre-sampled, and the
node-major poke/payload/prepare/start/end recurrence runs as a Python loop
over the topo order on ``(S, P, n)`` tensors that hold all seeds and
placements at once (where jaxsim scans one lane under a double ``vmap``).

The model is EXACTLY the numpy-vectorized path's
(``WorkflowSimulator._run_graph_vectorized``), arithmetic mirrored
operation for operation as jaxsim mirrors it, so at sigma=0 — where no
randomness survives — it agrees with the numpy backend to 1e-9 in float64.
With spread it has its own draw contract: per seed, a ``torch.Generator``
seeded with the seed draws three ``(n_nodes, n_requests)`` standard-normal
blocks (cold, then fetch, then compute), node-major in topo order, in
float64 rounded to float32. The lognormal factors ``exp(sigma * z)`` are
tabulated once per (seed, distinct sigma): the product in float32, the
exponential in float64 rounded to float32, so the table does not depend on
a vectorized float32 ``exp``. Normals and tables are made on the host and
copied to the device, so a sweep on the CPU and one on the card get the
same inputs; the recurrence then only adds, multiplies, takes maxima and
selects, and the two give the same totals. Every placement shares the
seed's tables (common random numbers): candidate comparisons are driven by
the placements, not sampling noise. Marginals are the numpy backends'
lognormals — medians/p99 agree within 1% (``tests/test_torch_sim.py``).

The poke cascade is draw-free and uniform over requests (``t0 + depth *
msg``, a static hop depth per node and placement, computed on the host).
The cold-start recurrence — the one sequential piece — is
``kernels/cold_scan.py``: one launch per node over all ``S * P`` rows, with
``keep_warm`` per row, the CUDA kernel on a card and its plain version on
the CPU.

Not supported here (use the scalar / numpy backends): ``timing=``
(per-request feedback), ``telemetry=`` (per-request side effects), and
graphs reusing one (name, platform) pair across nodes (couples the cold
recurrence across nodes). Drift IS supported: ``DriftSchedule`` scale
arrays are precomputed per platform on the host and applied after
sampling, exactly like the numpy path.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.cold_scan import cold_scan


class _Graph(NamedTuple):
    """Structure shared by every placement: topology + drift scale arrays
    (host numpy)."""

    pred_idx: np.ndarray  # (V, maxP) int32 rows into topo order (0-padded)
    pred_mask: np.ndarray  # (V, maxP) bool — which slots are real edges
    is_source: np.ndarray  # (V,) bool
    is_sink: np.ndarray  # (V,) bool
    compute_scale: np.ndarray  # (n_platforms, n) drift masks (ones w/o drift)
    transfer_scale: np.ndarray  # (n_platforms, n)
    fetch_scale: np.ndarray  # (n_platforms, n)


class _Sigmas(NamedTuple):
    """Distinct sigma values across the placement set, one list per draw
    stream; ``_Placement.*_sig`` rows index into the matching factor table."""

    cold: np.ndarray  # (Uc,)
    fetch: np.ndarray  # (Uf,)
    compute: np.ndarray  # (Ux,)


class _Placement(NamedTuple):
    """Per-placement numerics, stacked with a leading placement axis."""

    cold_median: np.ndarray  # (P, V)
    cold_sig: np.ndarray  # (P, V) int32 rows into the cold factor table
    keep_warm: np.ndarray  # (P, V) may be +inf
    fetch_median: np.ndarray  # (P, V)
    fetch_sig: np.ndarray  # (P, V)
    compute_median: np.ndarray  # (P, V)
    compute_sig: np.ndarray  # (P, V)
    poke_depth: np.ndarray  # (P, V) hops from a source via poke-enabled
    #   nodes (0.0 at sources, +inf where the cascade never reaches)
    transfer: np.ndarray  # (P, V, maxP) per-edge payload FIRST-byte transfer
    #   (== the whole-object transfer when streaming is off)
    transfer_last: np.ndarray  # (P, V, maxP) per-edge LAST-byte transfer
    #   (only read by the recurrence when use_stream; == transfer otherwise)
    plat_idx: np.ndarray  # (P, V) int32 rows into the drift scale arrays
    fault_extra: np.ndarray  # (P, V, n) per-(node, request) retry-backoff
    #   seconds from the host-precomputed fault plane ((P, V, 1) zeros and
    #   never read when use_faults is off)


def _poke_depths(order, steps, preds):
    """Hop count of each node's poke through poke-enabled nodes (the whole
    cascade is ``t0 + depth * msg``: draw-free and uniform over requests,
    so it folds to one static constant per node). Sources are poked at t0
    (depth 0); a node with ``prefetch=False`` — or reachable only through
    one — is never poked (+inf)."""
    depth = {}
    for v in order:
        if not preds[v]:
            depth[v] = 0.0
        elif steps[v].prefetch:
            depth[v] = min(depth[u] for u in preds[v]) + 1.0
        else:
            depth[v] = math.inf
    return np.array([depth[v] for v in order])


def _build(
    sim, order, step_sets, preds, succs, t0s, drift, dtype, stream=None,
    faults=None, retry=None,
):
    """Host-side array construction (numpy). The transfer model is
    evaluated through ``sim._transfer_s`` — or ``sim._transfer_fl`` when a
    StreamConfig is given — so subclasses that override the whole-object
    model (e.g. the scorer's cost-model simulator) feed this backend
    unchanged.

    With a ``FaultSchedule``, each placement also gets its (V, n)
    retry-backoff plane (``_Placement.fault_extra``, a scan input like the
    drift masks) and a (n,) request-failed mask; the planes come from the
    same hash-based ``FaultSchedule.plane`` the scalar and numpy backends
    price, so all three agree bit-for-bit. Returns ``(placed, sigmas,
    graph, fault_failed)`` with ``fault_failed`` a (P, n) bool array (all
    False when no schedule is active)."""
    f64 = dtype
    V = len(order)
    n = len(t0s)
    max_p = max([1] + [len(preds[v]) for v in order])
    idx_of = {v: i for i, v in enumerate(order)}
    pred_idx = np.zeros((V, max_p), np.int32)
    pred_mask = np.zeros((V, max_p), bool)
    for i, v in enumerate(order):
        for j, u in enumerate(preds[v]):
            pred_idx[i, j] = idx_of[u]
            pred_mask[i, j] = True
    is_source = np.array([not preds[v] for v in order])
    is_sink = np.array([not succs[v] for v in order])

    plat_names = list(sim.platforms)
    plat_row = {name: i for i, name in enumerate(plat_names)}
    scales = np.ones((3, len(plat_names), n), f64)
    if drift is not None:
        ks = np.arange(n)
        for name in plat_names:
            scales[:, plat_row[name], :] = drift.scale_arrays(ks, name)

    faults_on = faults is not None and bool(faults)
    request_ks = np.arange(n)

    def placement_arrays(steps):
        row = {
            "cold_median": np.empty(V, f64),
            "cold_sigma": np.empty(V, f64),
            "keep_warm": np.empty(V, f64),
            "fetch_median": np.empty(V, f64),
            "fetch_sigma": np.empty(V, f64),
            "compute_median": np.empty(V, f64),
            "compute_sigma": np.empty(V, f64),
            "poke_depth": _poke_depths(order, steps, preds).astype(f64),
            "transfer": np.zeros((V, max_p), f64),
            "transfer_last": np.zeros((V, max_p), f64),
            "plat_idx": np.zeros(V, np.int32),
            "fault_extra": np.zeros((V, n if faults_on else 1), f64),
            "fault_failed": np.zeros(n, bool),
        }
        for i, v in enumerate(order):
            step = steps[v]
            plat = sim.platforms[step.platform]
            if faults_on:
                fp = faults.plane(
                    step.name, step.platform, request_ks, retry,
                    region=plat.region,
                )
                row["fault_extra"][i] = fp.extra_s
                row["fault_failed"] |= fp.failed
            row["cold_median"][i] = plat.cold_start.median
            row["cold_sigma"][i] = plat.cold_start.sigma
            row["keep_warm"][i] = plat.keep_warm_s
            row["fetch_median"][i] = step.fetch.median
            row["fetch_sigma"][i] = step.fetch.sigma
            row["compute_median"][i] = step.compute.median
            row["compute_sigma"][i] = step.compute.sigma
            row["plat_idx"][i] = plat_row[step.platform]
            for j, u in enumerate(preds[v]):
                # routes through the table-aware per-edge resolver, so a
                # calibrated transfer_table is honored on this backend too
                first, last = sim._pair_transfer_fl(steps[u], step)
                row["transfer"][i, j] = first
                row["transfer_last"][i, j] = last
        return row

    # _transfer_fl reads sim.stream; pin it to THIS call's config for the
    # duration of the host-side build (spec-level overrides), then restore
    saved_stream = sim.stream
    sim.stream = stream
    try:
        all_rows = [placement_arrays(steps) for steps in step_sets]
    finally:
        sim.stream = saved_stream

    def dedup_sigmas(name):
        """Distinct sigma values across ALL placements for one stream +
        per-placement (V,) index rows into them. A degenerate dist
        (median <= 0) contributes nothing to the draw, so its sigma is
        remapped to the first entry rather than widening the table."""
        stack = np.stack([r[name + "_sigma"] for r in all_rows])
        med = np.stack([r[name + "_median"] for r in all_rows])
        stack = np.where(med > 0, stack, stack.flat[0])
        uniq, inv = np.unique(stack, return_inverse=True)
        return uniq, inv.reshape(stack.shape).astype(np.int32)

    cold_u, cold_i = dedup_sigmas("cold")
    fetch_u, fetch_i = dedup_sigmas("fetch")
    comp_u, comp_i = dedup_sigmas("compute")
    # leaves stay host-side numpy; _sweep copies what it reads to the device
    sigmas = _Sigmas(cold_u, fetch_u, comp_u)
    placed = _Placement(
        cold_median=np.stack([r["cold_median"] for r in all_rows]),
        cold_sig=cold_i,
        keep_warm=np.stack([r["keep_warm"] for r in all_rows]),
        fetch_median=np.stack([r["fetch_median"] for r in all_rows]),
        fetch_sig=fetch_i,
        compute_median=np.stack([r["compute_median"] for r in all_rows]),
        compute_sig=comp_i,
        poke_depth=np.stack([r["poke_depth"] for r in all_rows]),
        transfer=np.stack([r["transfer"] for r in all_rows]),
        transfer_last=np.stack([r["transfer_last"] for r in all_rows]),
        plat_idx=np.stack([r["plat_idx"] for r in all_rows]),
        fault_extra=np.stack([r["fault_extra"] for r in all_rows]),
    )
    fault_failed = np.stack([r["fault_failed"] for r in all_rows])
    graph = _Graph(
        pred_idx,
        pred_mask,
        is_source,
        is_sink,
        compute_scale=scales[0],
        transfer_scale=scales[1],
        fetch_scale=scales[2],
    )
    return placed, sigmas, graph, fault_failed




_TORCH_DTYPES = {np.float64: torch.float64, np.float32: torch.float32}


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"backend='torch' wants device {str(device)!r} but CUDA is not "
            "available; pass device='cpu' to run the sweep on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"backend='torch' runs on cuda or cpu, got {dev}")
    return dev


def _draw_tables(seeds, sigmas, V, n, dtype):
    """The draw contract, on the host: per seed, one ``torch.Generator``
    seeded with the seed draws the cold, fetch and compute normal blocks
    ((V, n) each, in that order); each stream's factor table is
    ``exp(sigma_u * z)`` for its distinct sigmas, (U, V, n). Returns three
    (S, U, V, n) tensors of ``dtype`` (float32 values)."""
    out = ([], [], [])
    for s in seeds:
        gen = torch.Generator().manual_seed(s & 0xFFFFFFFFFFFFFFFF)
        for tables, sig in zip(out, sigmas):
            z = torch.randn((V, n), generator=gen, dtype=torch.float64).float()
            sig32 = torch.as_tensor(np.asarray(sig, np.float32))
            prod = sig32[:, None, None] * z  # float32, as jaxsim
            tables.append(torch.exp(prod.double()).float().to(dtype))
    return tuple(torch.stack(t) for t in out)


def _sweep(
    placed, tables, graph, t0s, msg, inv_chunks, sample_idx, *, prefetch,
    use_drift, use_stream, use_faults, device,
):
    """(S, P, n) totals on ``device``: the recurrence of
    ``_run_graph_vectorized`` as a loop over topo order, every variable an
    (S, P, n) tensor (or a broadcastable slice of one). With ``sample_idx``,
    also the sampled per-node values (payload, effective cold, fetch,
    compute, end), each (S, P, V, k)."""
    f_cold, f_fetch, f_compute = (t.to(device) for t in tables)
    S = f_cold.shape[0]
    P, V = placed.cold_median.shape
    n = t0s.shape[0]
    np_dtype = t0s.dtype.type
    dtype = _TORCH_DTYPES[np_dtype]

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    t0 = dev(t0s)
    sig = {
        "cold": dev(placed.cold_sig, torch.long),
        "fetch": dev(placed.fetch_sig, torch.long),
        "compute": dev(placed.compute_sig, torch.long),
    }
    med = {
        "cold": dev(placed.cold_median),
        "fetch": dev(placed.fetch_median),
        "compute": dev(placed.compute_median),
    }
    kw_rows = dev(placed.keep_warm)  # (P, V)
    if use_drift:
        c_scale = dev(graph.compute_scale)
        t_scale = dev(graph.transfer_scale)
        f_scale = dev(graph.fetch_scale)
        plat_idx = dev(placed.plat_idx, torch.long)
    if use_faults:
        fault_extra = dev(placed.fault_extra)
    # host-side scalars in the sweep's dtype (exactly representable, so a
    # tensor op with them rounds nothing)
    half_msg = float(np_dtype(msg) / np_dtype(2))
    with np.errstate(invalid="ignore"):
        poke_off = placed.poke_depth.astype(np_dtype) * np_dtype(msg)  # (P, V)
    poked_all = np.isfinite(placed.poke_depth)

    def draws(table, name, i):
        # each placement's factor row by its sigma index: (S, P, n) — a
        # gather over the (S, U, V, n) table, where jaxsim unrolls a where
        # chain over U
        factor = table[:, sig[name][:, i], i]
        return med[name][:, i, None] * factor

    end_all = [None] * V
    total = None
    sampled = [[] for _ in range(5)] if sample_idx is not None else None
    idx = dev(sample_idx, torch.long) if sample_idx is not None else None
    for i in range(V):
        cold_v = draws(f_cold, "cold", i)
        fetch_v = draws(f_fetch, "fetch", i)
        compute_v = draws(f_compute, "compute", i)
        if use_drift:
            # drift rescales AFTER sampling (the draw-neutral contract)
            compute_v = compute_v * c_scale[plat_idx[:, i]]
            fetch_v = fetch_v * f_scale[plat_idx[:, i]]
            tr_dst = t_scale[plat_idx[:, i]]  # (P, n)
        # payload join (max over in-edges of upstream end + transfer);
        # with streaming the join gates on FIRST bytes and the last bytes
        # bound the compute tail below
        if graph.is_source[i]:
            payload = t0 + half_msg
            payload_last = payload
        else:
            payload = payload_last = None
            for j in np.nonzero(graph.pred_mask[i])[0]:
                u = int(graph.pred_idx[i, j])
                tr = dev(placed.transfer[:, i, j])[:, None]  # (P, 1)
                if use_stream:
                    tr_last = dev(placed.transfer_last[:, i, j])[:, None]
                if use_drift:
                    # a degraded platform slows every link it terminates
                    tr_sc = torch.maximum(t_scale[plat_idx[:, u]], tr_dst)
                    tr = tr * tr_sc
                    if use_stream:
                        tr_last = tr_last * tr_sc
                arrival = end_all[u] + tr
                payload = (arrival if payload is None
                           else torch.maximum(payload, arrival))
                if use_stream:
                    arrival = end_all[u] + tr_last
                    payload_last = (
                        arrival if payload_last is None
                        else torch.maximum(payload_last, arrival)
                    )
        # start/end under both cold hypotheses, then the cold scan
        poked = poked_all[:, i]
        if prefetch and poked.any():
            poke_v = t0 + dev(poke_off[:, i])[:, None]  # (P, n)
            warm_start = torch.maximum(payload, poke_v + fetch_v)
            cold_start = torch.maximum(payload, poke_v + cold_v + fetch_v)
            if not poked.all():
                p_mask = dev(poked, torch.bool)[:, None]
                warm_start = torch.where(p_mask, warm_start, payload + fetch_v)
                cold_start = torch.where(
                    p_mask, cold_start, payload + fetch_v + cold_v
                )
        else:
            warm_start = payload + fetch_v
            cold_start = warm_start + cold_v
        warm_end = warm_start + compute_v
        cold_end = cold_start + compute_v
        if use_stream and not graph.is_source[i]:
            # per-chunk pipeline tail (closed form, matching the numpy path)
            tail = payload_last + compute_v * inv_chunks
            warm_end = torch.maximum(warm_end, tail)
            cold_end = torch.maximum(cold_end, tail)
        if use_faults:
            # retry backoffs delay the node under both hypotheses, after the
            # streaming tail and before the cold scan (the numpy ordering)
            warm_end = warm_end + fault_extra[:, i]
            cold_end = cold_end + fault_extra[:, i]
        warm_end = warm_end.expand(S, P, n).reshape(S * P, n)
        cold_end = cold_end.expand(S, P, n).reshape(S * P, n)
        kw = kw_rows[:, i].expand(S, P).reshape(S * P)
        mask = cold_scan(t0, warm_end, cold_end, kw)
        end_v = torch.where(mask, cold_end, warm_end).reshape(S, P, n)
        end_all[i] = end_v
        if graph.is_sink[i]:
            total = end_v if total is None else torch.maximum(total, end_v)
        if sampled is not None:
            mask = mask.reshape(S, P, n)
            cold_eff = torch.where(mask, cold_v, torch.zeros_like(cold_v))
            for acc, val in zip(
                sampled, (payload, cold_eff, fetch_v, compute_v, end_v)
            ):
                acc.append(val.expand(S, P, n)[..., idx])
        del warm_end, cold_end, mask  # free before the next node's draws
    totals = total - t0
    if sampled is None:
        return totals
    return totals, tuple(torch.stack(a, dim=2) for a in sampled)


def run_batched(sim, order, step_sets, preds, succs, t0s, prefetch, seeds,
                drift=None, dtype=np.float64, sample_idx=None, stream=None,
                faults=None, retry=None, device="cuda"):
    """The torch backend's one entry point: simulate every (seed, placement)
    pair of one workflow graph in a single sweep on ``device``.

    ``sim`` is the host ``WorkflowSimulator`` (platforms, msg latency,
    transfer model); ``step_sets`` is a list of ``{node_id: SimStep}``
    placements sharing (order, preds, succs); ``seeds`` the integer seed
    axis; ``drift`` overrides ``sim.drift`` when given. Returns a
    ``(len(seeds), len(step_sets), len(t0s))`` ``dtype`` numpy array of
    per-request totals.

    ``device``: "cuda" (default) raises without a card; "cpu" runs the
    sweep on the host, with the cold scan's plain version.

    ``dtype``: float64 (default) reproduces the numpy backend to 1e-9 at
    sigma=0 (the equivalence gates run on it); float32 halves the memory
    traffic of the sweep and is statistically indistinguishable, so bulk
    candidate scoring uses it.

    ``sample_idx``: optional (k,) request indices. When given, the return
    value becomes ``(totals, sampled)`` where ``sampled`` is a 5-tuple of
    ``(seeds, placements, V, k)`` numpy arrays (payload, effective cold,
    fetch, compute, end at the sampled requests) for host-side ``obs``
    trace reconstruction. The totals are computed by the identical
    arithmetic either way.

    ``stream``: optional ``StreamConfig``. Splits every edge into a
    (first_byte, last_byte) transfer pair host-side and — when chunks > 1
    — adds the per-chunk pipeline tail to the recurrence. ``chunks=1``
    keeps the whole-object recurrence, so totals stay bit-for-bit.

    ``faults`` / ``retry``: optional ``FaultSchedule`` / ``RetryPolicy``.
    The hash-based fault plane is precomputed host-side per placement and
    added to both end-time hypotheses before the cold scan; exhausted retry
    budgets turn the affected requests' totals into ``inf`` after the sweep
    (the recurrence itself stays finite). The fault outcomes are shared
    with the scalar/numpy backends bit-for-bit.
    """
    device = _device(device)
    if drift is None:
        drift = sim.drift
    if sim.timing is not None:
        raise ValueError(
            "backend='torch' does not support timing=: the poke controller "
            "learns from per-request feedback; use backend='scalar'"
        )
    for steps in step_sets:
        keys = [(steps[v].name, steps[v].platform) for v in order]
        if len(set(keys)) != len(keys):
            raise ValueError(
                "backend='torch' needs a unique (name, platform) per node — "
                "a duplicated pair couples the cold-start recurrence "
                "across nodes; use backend='scalar'"
            )
    seeds = [int(s) for s in seeds]
    n = len(t0s)
    if n == 0 or not step_sets or not seeds:
        empty = np.empty((len(seeds), len(step_sets), n))
        if sample_idx is not None:
            V = len(order)
            z = np.empty((len(seeds), len(step_sets), V, 0))
            return empty, (z, z, z, z, z)
        return empty
    dtype = np.dtype(dtype).type
    # the recurrence only changes when first != last bytes is possible;
    # chunks=1 (even with P2P rerouting the transfer VALUES) keeps the
    # whole-object recurrence — first == last there, so the tail never binds
    use_stream = stream is not None and stream.chunks > 1
    use_faults = faults is not None and bool(faults)
    placed, sigmas, graph, fault_failed = _build(
        sim, order, step_sets, preds, succs, t0s, drift, dtype,
        stream=stream, faults=faults, retry=retry,
    )
    tables = _draw_tables(seeds, sigmas, len(order), n, _TORCH_DTYPES[dtype])
    out = _sweep(
        placed,
        tables,
        graph,
        np.asarray(t0s, dtype),
        sim.msg,
        float(dtype(1.0 / stream.chunks)) if use_stream else 1.0,
        np.asarray(sample_idx, np.int64) if sample_idx is not None else None,
        prefetch=bool(prefetch),
        use_drift=drift is not None,
        use_stream=use_stream,
        use_faults=use_faults,
        device=device,
    )

    def mark_failed(totals):
        # dead requests are priced as-if-completed inside the sweep (the
        # cold recurrence must stay finite and backend-identical) but
        # reported as never finishing — the numpy backend's post-step
        totals = totals.cpu().numpy()
        if use_faults and fault_failed.any():
            return np.where(fault_failed[None, :, :], np.inf, totals)
        return totals

    if sample_idx is not None:
        totals, sampled = out
        return mark_failed(totals), tuple(a.cpu().numpy() for a in sampled)
    return mark_failed(out)
