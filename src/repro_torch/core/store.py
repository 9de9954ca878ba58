"""Region-homed object store (the S3 stand-in) + the streaming data plane.

Stores REAL bytes/arrays in memory, keyed by (key) with a home region.
Transfer latency is modeled from the NetworkModel (size-based), and can be
optionally *enforced* (sleep) so real-JAX overlap experiments see true
wall-clock effects, or just *accounted* (returned) for the simulator.

GeoFF uses the store in two roles (paper §4.1):
  - external data dependencies that steps pre-fetch, and
  - the inter-step payload buffer for public-cloud platforms that don't
    allow direct function-to-function traffic (non-native pre-fetching).

The streaming data plane (``StreamConfig``) chunks both roles: a
``put_stream``/``get_stream`` pair moves an object as ``chunks`` wire
pieces — only the first piece pays the link's fixed latency, the rest
pipeline at its bandwidth — so a consumer interleaving the two (the
dataflow engine's cut-through transfer) sees the first byte after one
chunk per hop instead of the whole object per hop. Accounting stays
whole-object: one logical put/get, ``size`` bytes on the region pair
(never ``chunks x size``), modeled seconds summing exactly to the
unchunked transfer.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.platform import NetworkModel


@dataclass(frozen=True)
class StreamConfig:
    """Streaming data plane configuration (chunked, pipelined transfers).

    ``chunks`` is the wire granularity: an object of B bytes moves as
    ``chunks`` pieces of B/chunks, so a consumer can act on the first
    piece while the rest pipeline behind it. ``chunks=1`` is whole-object
    semantics — every path that accepts a StreamConfig is bit-for-bit
    identical to streaming disabled then.

    ``p2p_threshold_bytes`` enables the direct peer-to-peer payload path:
    edges whose payload size (learned per edge from TelemetryHub byte
    EWMAs, falling back to the live payload's size) is at or below the
    threshold skip the object-store round-trip entirely. 0 disables.
    """

    chunks: int = 4
    p2p_threshold_bytes: float = 0.0

    def __post_init__(self):
        if self.chunks < 1:
            raise ValueError(f"StreamConfig.chunks must be >= 1, got {self.chunks}")


@dataclass
class StoredObject:
    value: object
    size_bytes: int
    region: str


def _sizeof(value) -> int:
    if hasattr(value, "nbytes"):
        return int(value.nbytes)
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    if isinstance(value, str):
        return len(value.encode())
    if isinstance(value, dict):
        return sum(_sizeof(v) for v in value.values()) or 64
    if isinstance(value, (list, tuple)):
        return sum(_sizeof(v) for v in value) or 64
    return 64


class ObjectStore:
    def __init__(
        self, network: Optional[NetworkModel] = None, enforce_latency: bool = False
    ):
        self.network = network or NetworkModel()
        self.enforce_latency = enforce_latency
        self._objects: dict = {}
        self._lock = threading.Lock()
        self.telemetry = None  # duck-typed TelemetryHub (repro.adapt)
        self.tracer = None  # duck-typed obs.Tracer (span events)
        self.stats = {
            "puts": 0,
            "gets": 0,  # successful GETs (hits; a missing key raises)
            "misses": 0,
            "bytes_in": 0,
            "bytes_out": 0,
            "modeled_get_s": 0.0,
            "modeled_put_s": 0.0,
            # bytes moved per region pair ("src->dst"), both directions;
            # chunked transfers account their object ONCE (no double count)
            "bytes_by_pair": {},
        }

    def stats_snapshot(self) -> dict:
        """Copy of ``stats`` under the store lock."""
        with self._lock:
            out = dict(self.stats)
            out["bytes_by_pair"] = dict(self.stats["bytes_by_pair"])
            return out

    def _account_pair(self, src_region: str, dst_region: str, size: int):
        # callers hold self._lock
        pair = f"{src_region}->{dst_region}"
        by_pair = self.stats["bytes_by_pair"]
        by_pair[pair] = by_pair.get(pair, 0) + size

    def _chunk_dts(self, src_region: str, dst_region: str, size: int, chunks: int):
        """Per-chunk modeled seconds for one hop: the first chunk carries
        the link's fixed (latency) term, every chunk carries size/chunks of
        the bandwidth term — summing exactly to the unchunked transfer."""
        whole = self.network.transfer_s(src_region, dst_region, size)
        base = self.network.transfer_s(src_region, dst_region, 0)
        per_bw = (whole - base) / chunks
        return [per_bw + (base if i == 0 else 0.0) for i in range(chunks)]

    # -- api -------------------------------------------------------------------
    def put(self, key: str, value, region: str, from_region: str = "") -> float:
        size = _sizeof(value)
        src = from_region or region
        dt = self.network.transfer_s(src, region, size)
        with self._lock:
            self._objects[key] = StoredObject(value, size, region)
            self.stats["puts"] += 1
            self.stats["bytes_in"] += size
            self.stats["modeled_put_s"] += dt
            self._account_pair(src, region, size)
        if self.enforce_latency:
            time.sleep(dt)
        if self.telemetry is not None:
            self.telemetry.record_transfer(src, region, size, dt)
        if self.tracer is not None:
            self.tracer.event(
                "store.put",
                {"key": key, "region": region, "size_bytes": size, "modeled_s": dt},
            )
        return dt

    def _resolve_for_get(self, key: str, to_region: str) -> StoredObject:
        """Hit accounting + the named KeyError contract, under the lock."""
        with self._lock:
            obj = self._objects.get(key)
            if obj is None:
                self.stats["misses"] += 1
                prefix = key.rsplit("/", 1)[0] + "/" if "/" in key else key[:4]
                near = sorted(k for k in self._objects if k.startswith(prefix))[:8]
                hint = (
                    f"; keys under {prefix!r}: {near}"
                    if near
                    else f"; store holds {len(self._objects)} keys "
                    f"(sample: {sorted(self._objects)[:5]})"
                )
                raise KeyError(
                    f"object {key!r} not in store (GET from region "
                    f"{to_region!r}){hint}"
                )
            self.stats["gets"] += 1
            self.stats["bytes_out"] += obj.size_bytes
            self._account_pair(obj.region, to_region, obj.size_bytes)
        return obj

    def get(self, key: str, to_region: str) -> tuple:
        """Returns (value, modeled_transfer_seconds).

        A missing key raises a KeyError that names the key, the requesting
        region, and the keys living under the same prefix — payload-buffer
        keys (``__payload__/{rid}/{edge}``) are one-shot, so a stale or
        mistyped buffer key is otherwise undebuggable."""
        obj = self._resolve_for_get(key, to_region)
        dt = self.network.transfer_s(obj.region, to_region, obj.size_bytes)
        with self._lock:
            self.stats["modeled_get_s"] += dt
        if self.enforce_latency:
            time.sleep(dt)
        if self.telemetry is not None:
            self.telemetry.record_transfer(obj.region, to_region, obj.size_bytes, dt)
        if self.tracer is not None:
            self.tracer.event(
                "store.get",
                {
                    "key": key,
                    "from_region": obj.region,
                    "to_region": to_region,
                    "size_bytes": obj.size_bytes,
                    "modeled_s": dt,
                },
            )
        return obj.value, dt

    # -- streaming api (the chunked data plane) --------------------------------
    def put_stream(self, key: str, value, region: str, from_region: str = "", chunks=4):
        """Chunked PUT: stores the object, then returns a generator yielding
        each wire chunk's modeled seconds in order (sleeping them when
        ``enforce_latency`` — so a consumer driving the generator paces at
        chunk granularity). The stored content is atomic (chunks model the
        wire, not the value): an interleaved ``get_stream`` on the same key
        can cut through after the first chunk. Accounting matches ``put``
        exactly — one logical put, ``size`` bytes once on the pair, modeled
        seconds summing to the unchunked transfer — with one transfer
        telemetry record per chunk (chunk-sized, so link fits see byte
        spread)."""
        size = _sizeof(value)
        src = from_region or region
        chunks = max(1, int(chunks))
        dts = self._chunk_dts(src, region, size, chunks)
        with self._lock:
            self._objects[key] = StoredObject(value, size, region)
            self.stats["puts"] += 1
            self.stats["bytes_in"] += size
            self.stats["modeled_put_s"] += sum(dts)
            self._account_pair(src, region, size)
        if self.tracer is not None:
            self.tracer.event(
                "store.put_stream",
                {
                    "key": key,
                    "region": region,
                    "size_bytes": size,
                    "chunks": chunks,
                    "modeled_s": sum(dts),
                },
            )

        def chunk_iter():
            for dt in dts:
                if self.enforce_latency:
                    time.sleep(dt)
                if self.telemetry is not None:
                    self.telemetry.record_transfer(src, region, size / chunks, dt)
                yield dt

        return chunk_iter()

    def get_stream(self, key: str, to_region: str, chunks=4):
        """Chunked GET: resolves the object up front (same accounting and
        KeyError contract as ``get``), then returns a generator yielding
        ``(value_or_None, chunk_seconds)`` per wire chunk — the value
        arrives with the LAST chunk, mirroring a real ranged download.
        Each step sleeps its chunk when ``enforce_latency``."""
        obj = self._resolve_for_get(key, to_region)
        chunks = max(1, int(chunks))
        dts = self._chunk_dts(obj.region, to_region, obj.size_bytes, chunks)
        with self._lock:
            self.stats["modeled_get_s"] += sum(dts)
        if self.tracer is not None:
            self.tracer.event(
                "store.get_stream",
                {
                    "key": key,
                    "from_region": obj.region,
                    "to_region": to_region,
                    "size_bytes": obj.size_bytes,
                    "chunks": chunks,
                    "modeled_s": sum(dts),
                },
            )

        def chunk_iter():
            for i, dt in enumerate(dts):
                if self.enforce_latency:
                    time.sleep(dt)
                if self.telemetry is not None:
                    self.telemetry.record_transfer(
                        obj.region, to_region, obj.size_bytes / chunks, dt
                    )
                yield (obj.value if i == chunks - 1 else None), dt

        return chunk_iter()

    def head(self, key: str) -> Optional[StoredObject]:
        with self._lock:
            return self._objects.get(key)

    def region_of(self, key: str) -> Optional[str]:
        o = self.head(key)
        return o.region if o else None

    def delete(self, key: str):
        with self._lock:
            self._objects.pop(key, None)

    def keys(self, prefix: str = "") -> list:
        with self._lock:
            return [k for k in self._objects if k.startswith(prefix)]

    def __contains__(self, key: str):
        with self._lock:
            return key in self._objects
