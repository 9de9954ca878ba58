"""Function pre-warming: the compile cache (GeoFF cold starts, §3.3).

Port of ``repro/core/prewarm.py``. There, the cold start is an AOT
``jax.jit(...).lower().compile()``. PyTorch runs eagerly and has no AOT
compile, so the port's cold start is what a first call on the card really
pays: loading (or building) the kernel libraries, creating the cuBLAS handle
for the calling thread, growing the caching allocator. ``_compile`` pays it
by calling the step once on zero tensors of the abstract shapes, on the
device the abstract arguments name, synchronising, and caching the step.
The poke from the predecessor triggers that in a background thread, taking
the cold start off the critical path exactly as GeoFF pre-warms function
instances.

Keys are (step name, platform, abstract input signature), so re-routing a
step to a different platform warms per platform and subsequent calls are
warm.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and device of an argument, without its data: the port's
    ``jax.ShapeDtypeStruct``. The device defaults to the card. A DTensor's
    spec also carries its ``DeviceMesh`` and placements (the port's
    ``NamedSharding``); its stand-in is then a DTensor."""

    shape: tuple
    dtype: torch.dtype = torch.float32
    device: str = "cuda"
    mesh: object = None
    placements: tuple = None


def _flatten(tree, leaves: list) -> str:
    """Structure string of a dict/list/tuple tree; leaves appended in order
    (dict keys sorted, as ``jax.tree_util`` flattens them)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        inner = ",".join(f"{k!r}:{_flatten(tree[k], leaves)}" for k in keys)
        return "{" + inner + "}"
    if isinstance(tree, (list, tuple)):
        inner = ",".join(_flatten(x, leaves) for x in tree)
        return ("[" if isinstance(tree, list) else "(") + inner + (
            "]" if isinstance(tree, list) else ")")
    if tree is None:
        return "None"
    leaves.append(tree)
    return "*"


def signature_of(args_pytree) -> tuple:
    leaves: list = []
    structure = _flatten(args_pytree, leaves)
    return (
        structure,
        tuple(
            (
                tuple(getattr(leaf, "shape", ())),
                str(getattr(leaf, "dtype", type(leaf).__name__)),
            )
            for leaf in leaves
        ),
    )


def _example(tree):
    """Zero-filled stand-ins for every tensor-like leaf: TensorSpecs and
    tensors become zero tensors on their device; numpy arrays become zero
    arrays; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: _example(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_example(x) for x in tree)
    if isinstance(tree, TensorSpec):
        if tree.mesh is not None:
            from torch.distributed.tensor import zeros
            return zeros(tree.shape, dtype=tree.dtype, device_mesh=tree.mesh,
                         placements=tree.placements)
        return torch.zeros(tree.shape, dtype=tree.dtype, device=tree.device)
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, np.ndarray):
        return np.zeros_like(tree)
    return tree


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif isinstance(tree, torch.Tensor) and tree.is_cuda:
        out.add(tree.device)
    return out


class CompileCache:
    """Warm-up cache with background pre-warming."""

    def __init__(self, max_workers: int = 4):
        self._cache: dict = {}
        self._inflight: dict = {}
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="prewarm"
        )
        self.stats = {
            "hits": 0,
            "misses": 0,
            "prewarms": 0,
            "compile_s": 0.0,
            "hidden_compile_s": 0.0,
        }
        self.telemetry = None  # duck-typed TelemetryHub (repro.adapt)
        self.tracer = None  # duck-typed obs.Tracer (span events)

    def stats_snapshot(self) -> dict:
        """Copy of ``stats`` under the cache lock (safe to read while
        compiles land on other threads)."""
        with self._lock:
            return dict(self.stats)

    def _key(self, name: str, platform: str, args) -> tuple:
        return (name, platform, signature_of(args))

    def _compile(self, fn: Callable, args, donate=()):
        """One call of ``fn`` on zero stand-ins of ``args``, synchronised:
        the eager cold start. ``donate`` is accepted for the JAX package's
        call shape and has no effect."""
        t0 = time.perf_counter()
        example = _example(tuple(args))
        fn(*example)
        for dev in _cuda_devices(example, set()):
            torch.cuda.synchronize(dev)
        return fn, time.perf_counter() - t0

    def warm(
        self, name: str, platform: str, fn: Callable, abstract_args, donate=()
    ) -> Future:
        """Start compiling in the background (the poke path). Idempotent."""
        key = self._key(name, platform, abstract_args)
        tr = self.tracer
        # capture the caller's bound span (the poke span) so the compile
        # completion event lands on it even though the job runs on a pool
        # thread
        span = tr.current_span() if tr is not None else None
        with self._lock:
            if key in self._cache:
                if tr is not None:
                    tr.event("prewarm.already_warm", {"fn": name, "platform": platform})
                f = Future()
                f.set_result(self._cache[key])
                return f
            if key in self._inflight:
                return self._inflight[key]
            if tr is not None:
                tr.event("prewarm.start", {"fn": name, "platform": platform})

            def job():
                compiled, dt = self._compile(fn, abstract_args, donate)
                with self._lock:
                    self._cache[key] = compiled
                    self._inflight.pop(key, None)
                    self.stats["prewarms"] += 1
                    self.stats["hidden_compile_s"] += dt
                if tr is not None and span is not None:
                    with tr.bind(span):
                        tr.event(
                            "prewarm.done",
                            {"fn": name, "platform": platform, "compile_s": dt},
                        )
                return compiled

            fut = self._pool.submit(job)
            self._inflight[key] = fut
            return fut

    def get(self, name: str, platform: str, fn: Callable, args, donate=()) -> object:
        """Blocking fetch (the payload path): hit, join in-flight, or
        compile cold (a cold start — counted in stats)."""
        key = self._key(name, platform, args)
        tel = self.telemetry
        tr = self.tracer
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self.stats["hits"] += 1
            fut = self._inflight.get(key)
        if hit is not None:
            if tel is not None:
                tel.record_warm_hit(name, platform)
            if tr is not None:
                tr.event("compile.hit", {"fn": name, "platform": platform})
            return hit
        if fut is not None:
            compiled = fut.result()
            with self._lock:
                self.stats["hits"] += 1
            if tel is not None:
                tel.record_warm_hit(name, platform)
            if tr is not None:
                tr.event("compile.joined_inflight", {"fn": name, "platform": platform})
            return compiled
        compiled, dt = self._compile(fn, args, donate)
        with self._lock:
            self._cache[key] = compiled
            self.stats["misses"] += 1
            self.stats["compile_s"] += dt
        if tel is not None:
            # the compile wall time is the cold-start cost placement wants
            tel.record_cold_start(name, platform, dt)
        if tr is not None:
            tr.event(
                "compile.cold", {"fn": name, "platform": platform, "compile_s": dt}
            )
        return compiled

    def is_warm(self, name: str, platform: str, args) -> bool:
        with self._lock:
            return self._key(name, platform, args) in self._cache

    def shutdown(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
