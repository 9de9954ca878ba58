"""Async checkpointing with atomic manifests and restart (port of
``repro/checkpoint/manager.py``, same layout and manifest).

Layout:  <dir>/step_<N>/
           manifest.json     {step, leaves: [{key, file, shape, dtype}], done}
           <leaf>.npy        one file per tree leaf

Keys are ``jax.tree_util.keystr`` paths (``['params']['embed']``), so a
checkpoint written by either package restores in the other.

  - ATOMIC: leaves are written to step_<N>.tmp/, the manifest is written
    last, then the directory is renamed; ``latest_step`` only returns dirs
    with a manifest.
  - ASYNC: ``save(..., blocking=False)`` copies every leaf to host memory
    before it returns, then writes on a background thread. The copy has to
    finish first: the port's optimizer updates the live tensors in place,
    so a copy still running on the thread would record a later step.
  - RESTORE: leaves are loaded, shape-checked against the target tree and
    put on ``device`` (by default each target leaf's own device).

A bfloat16 leaf is written as the JAX package writes one: its raw 16-bit
words, which ``np.load`` reads back as ``|V2``. ``restore`` turns such a
leaf (from either package) back into bfloat16 bit for bit; the JAX
package's restore hands back the ``|V2`` array, as it does for its own.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.models.tree import tree_map, tree_map_with_path


def _flatten(tree):
    """[(keystr, leaf)] of ``tree``."""
    out = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def _sanitize(keystr: str) -> str:
    return keystr.replace("/", "_").replace("'", "").replace("[", "(") \
        .replace("]", ")")


def _snapshot(x):
    """A host numpy copy of a leaf that shares no memory with it."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(x, copy=True)


def _tensor(arr, dtype: str, device):
    if dtype == "bfloat16" and arr.dtype.kind == "V":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    t = torch.from_numpy(arr)
    return t.to(device, getattr(torch, dtype)) if dtype == "bfloat16" else t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._inflight = None
        self.stats = {"saves": 0, "restores": 0, "save_s": 0.0,
                      "blocked_s": 0.0}

    # -- save --------------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False):
        """Snapshot ``tree`` to host memory, then write it (on the worker
        thread unless ``blocking``). Returns the snapshot's seconds."""
        # at most one async save in flight, and at most one host snapshot
        self.wait()
        t0 = time.perf_counter()
        host = _flatten(tree_map(_snapshot, tree))
        snap_s = time.perf_counter() - t0

        def write():
            t2 = time.perf_counter()
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": [], "done": True}
            for key, leaf in host:
                fname = _sanitize(key) + ".npy"
                np.save(os.path.join(tmp, fname), leaf)
                dtype = "bfloat16" if leaf.dtype.kind == "V" else str(leaf.dtype)
                manifest["leaves"].append(
                    {"key": key, "file": fname, "shape": list(leaf.shape),
                     "dtype": dtype})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self.stats["saves"] += 1
            self.stats["save_s"] += time.perf_counter() - t2
            self._gc()

        if blocking:
            write()
        else:
            self._inflight = self._pool.submit(write)
        self.stats["blocked_s"] += snap_s
        return snap_s

    def wait(self):
        if self._inflight is not None:
            t0 = time.perf_counter()
            self._inflight.result()
            self.stats["blocked_s"] += time.perf_counter() - t0
            self._inflight = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, name,
                                                "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, device=None):
        """Restore into the structure of ``target_tree`` (shapes checked) as
        tensors on ``device``, or on each target leaf's device if None (the
        CPU for a leaf that is not a tensor)."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}

        def load(key, leaf):
            meta = by_key[key]
            arr = np.load(os.path.join(d, meta["file"]))
            assert tuple(arr.shape) == tuple(np.shape(leaf)), \
                (key, arr.shape, np.shape(leaf))
            dev = device if device is not None else getattr(leaf, "device", "cpu")
            return _tensor(arr, meta["dtype"], dev)
        out = tree_map_with_path(load, target_tree)
        self.stats["restores"] += 1
        return out

    def nbytes(self, step: int) -> int:
        """Bytes of step ``step``'s leaves on disk."""
        d = os.path.join(self.dir, f"step_{step}")
        return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d)
                   if n.endswith(".npy"))
