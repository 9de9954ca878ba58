"""Data pre-fetching (GeoFF §3.3).

A step's external data dependencies don't depend on its predecessor's
output, so the middleware fetches them while the predecessor is still
computing: ``Prefetcher.start`` returns futures (object-store GET + a copy
onto the step's device), and ``join`` blocks only on whatever hasn't
arrived when the payload shows up — in the ideal case, nothing (the paper's
Figure 2, workflow B).

Port of ``repro/core/prefetch.py``, where the copy is ``jax.device_put``.
Here an array bound for a CUDA device goes through a pinned host tensor
and ``.to(device, non_blocking=True)`` on a side CUDA stream, with an event
recorded after the copy. ``join`` makes the CALLER's current stream wait on
that event (the consuming platform thread, not the pool thread that issued
the copy) and ``record_stream``s the tensor onto it, so the allocator never
reuses its memory early. For ``device="cpu"`` the array is handed over as a
tensor without a copy.

``DoubleBuffer`` reuses the same machinery for the training data pipeline:
batch k+1 is fetched/transferred while step k computes.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional

import torch

from repro_torch.core.store import ObjectStore, StreamConfig
from repro_torch.core.workflow import DataRef


def _to_device(value, device, side_streams: dict, lock):
    """(tensor on ``device``, CUDA event or None). A CUDA copy runs
    asynchronously on a per-device side stream."""
    dev = torch.device(device)
    t = torch.as_tensor(value)
    if dev.type != "cuda":
        return t.to(dev), None
    with lock:
        side = side_streams.get(dev)
        if side is None:
            side = side_streams[dev] = torch.cuda.Stream(device=dev)
    host = t if t.is_pinned() else t.pin_memory()
    with torch.cuda.stream(side):
        out = host.to(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(side)
    return out, event


def _join_on_current_stream(value, event):
    """Order the caller's current stream after the side-stream copy."""
    if event is not None:
        cur = torch.cuda.current_stream(value.device)
        cur.wait_event(event)
        value.record_stream(cur)
    return value


class Prefetcher:
    def __init__(
        self,
        store: ObjectStore,
        max_workers: int = 8,
        stream: Optional[StreamConfig] = None,
    ):
        self.store = store
        self.stream = stream  # chunked fetches when set with chunks > 1
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="prefetch"
        )
        self.stats = {
            "prefetched": 0,
            "cold_fetches": 0,
            "hidden_s": 0.0,
            "exposed_s": 0.0,
            "streamed": 0,  # fetches that went through get_stream
            "first_byte_s": 0.0,  # summed modeled time-to-first-chunk
        }
        self._lock = threading.Lock()
        self._side_streams: dict = {}  # device -> side CUDA stream
        self.telemetry = None  # duck-typed TelemetryHub (repro.adapt)
        self.tracer = None  # duck-typed obs.Tracer (span events)

    def stats_snapshot(self) -> dict:
        """Copy of ``stats`` under the lock (joins land on pool threads)."""
        with self._lock:
            return dict(self.stats)

    def start(self, deps: Iterable[DataRef], to_region: str, device=None) -> dict:
        """Kick off async fetches. Returns {key: Future[(value, modeled_s,
        copy_event)]}; ``join`` unpacks them."""
        tr = self.tracer
        # capture the caller's bound span (the poke span): the job runs on
        # a pool thread, so rebind there to attach fetch events to it
        span = tr.current_span() if tr is not None else None
        futs = {}
        for ref in deps:
            if tr is not None:
                tr.event("prefetch.start", {"key": ref.key, "to_region": to_region})

            def job(r=ref):
                stream = self.stream
                if stream is not None and stream.chunks > 1:
                    # chunked fetch: the generator paces per wire chunk
                    # (sleeping when the store enforces latency), so the
                    # fetch overlaps whatever else runs on this pool —
                    # same total seconds, earlier first byte
                    value, dt, first = None, 0.0, None
                    for v, cdt in self.store.get_stream(
                        r.key, to_region, chunks=stream.chunks
                    ):
                        dt += cdt
                        if first is None:
                            first = dt
                        if v is not None:
                            value = v
                    with self._lock:
                        self.stats["streamed"] += 1
                        self.stats["first_byte_s"] += first or 0.0
                else:
                    value, dt = self.store.get(r.key, to_region)
                event = None
                if device is not None and hasattr(value, "shape"):
                    value, event = _to_device(
                        value, device, self._side_streams, self._lock
                    )
                if self.telemetry is not None:
                    self.telemetry.record_fetch(r.key, to_region, dt)
                if tr is not None and span is not None:
                    with tr.bind(span):
                        tr.event(
                            "prefetch.done",
                            {"key": r.key, "to_region": to_region, "modeled_s": dt},
                        )
                return value, dt, event

            futs[ref.key] = self._pool.submit(job)
        return futs

    def join(self, futs: dict) -> tuple:
        """Wait for all fetches. Returns ({key: value}, exposed_wait_s,
        modeled_transfer_s) — exposed_wait is what the critical path saw."""
        t0 = time.perf_counter()
        out, modeled = {}, 0.0
        for k, f in futs.items():
            v, dt, event = f.result()
            out[k] = _join_on_current_stream(v, event)
            modeled += dt
        exposed = time.perf_counter() - t0
        with self._lock:
            self.stats["prefetched"] += len(futs)
            self.stats["exposed_s"] += exposed
            self.stats["hidden_s"] += max(0.0, modeled - exposed)
        return out, exposed, modeled

    def fetch_blocking(
        self, deps: Iterable[DataRef], to_region: str, device=None
    ) -> tuple:
        """The baseline (no pre-fetch) path: sequential download."""
        tr = self.tracer
        out, total = {}, 0.0
        for ref in deps:
            value, dt = self.store.get(ref.key, to_region)
            if device is not None and hasattr(value, "shape"):
                value = torch.as_tensor(value).to(device)
            if self.telemetry is not None:
                self.telemetry.record_fetch(ref.key, to_region, dt)
            if tr is not None:
                tr.event(
                    "fetch.cold",
                    {"key": ref.key, "to_region": to_region, "modeled_s": dt},
                )
            out[ref.key] = value
            total += dt
        with self._lock:
            self.stats["cold_fetches"] += len(out)
        return out, total

    def shutdown(self):
        self._pool.shutdown(wait=False, cancel_futures=True)


class DoubleBuffer:
    """Prefetch iterator: always keeps `depth` items in flight.

    The produce fn runs on a background thread (host->device transfer,
    decompression, ...) so consumption overlaps production — the data
    pipeline's version of GeoFF pre-fetching.
    """

    def __init__(
        self, it: Iterable, depth: int = 2, transform: Optional[Callable] = None
    ):
        self._it = iter(it)
        self._transform = transform
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="databuf")
        self._queue = []
        self._depth = depth
        for _ in range(depth):
            self._enqueue()

    def _produce(self):
        item = next(self._it)
        return self._transform(item) if self._transform else item

    def _enqueue(self):
        self._queue.append(self._pool.submit(self._produce))

    def __iter__(self):
        return self

    def __next__(self):
        if not self._queue:
            raise StopIteration
        fut = self._queue.pop(0)
        try:
            item = fut.result()
        except StopIteration:
            self._pool.shutdown(wait=False)
            raise
        self._enqueue()
        return item
