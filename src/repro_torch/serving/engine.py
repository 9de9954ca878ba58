"""Serving engine: continuous batching + GeoFF prefill/decode disaggregation
(port of ``repro/serving/engine.py``).

A request's lifecycle is a two-step GeoFF workflow:

    prefill (platform A)  ->  decode (platform B)

The prefill "function" builds the KV cache; the decode "function" consumes
it. While a prefill runs, the decode platform is POKED — its step pre-warms
and its weights are already resident. The KV cache ships to the decode pod
rather than the decode step to the prefill pod.

Continuous batching: decode runs a fixed-slot batch; finished sequences free
their slot and the scheduler immediately admits the next prefilled request.
The slot-batched cache is a tree of stacked tensors with a slot (batch)
axis. Where the JAX package builds an updated copy of it, the port writes
slot insertion and each decode step's KV in place: that saves a full cache
copy per step, and nothing reuses the old cache.

Weights are cast to the compute dtype once, when the engine is built;
serving never updates them.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.prewarm import CompileCache
from repro_torch.dist.sharding import full, new_zeros, write_
from repro_torch.models import model as M
from repro_torch.models.params import check_device
from repro_torch.models.transformer import _is_spec, cache_defs, cast_params
from repro_torch.models.tree import tree_map


def _axis_trees(cfg):
    """Trees (matching the cache structure) of the batch axis index, the
    cache_seq axis index (or -1) and the logical axes of every cache leaf,
    derived from the SpecDefs — the single source of cache-layout truth."""
    defs = cache_defs(cfg, 1, 8)
    baxis = tree_map(lambda d: d.axes.index("batch"), defs, is_leaf=_is_spec)
    saxis = tree_map(
        lambda d: d.axes.index("cache_seq") if "cache_seq" in d.axes else -1,
        defs, is_leaf=_is_spec)
    axes = tree_map(lambda d: d.axes, defs, is_leaf=_is_spec)
    return baxis, saxis, axes


def pad_cache(caches, target_len: int, cur_len: int, cfg=None, saxis=None,
              axes=None):
    """Pad prefill caches (capacity == prompt len) to the generation budget.

    Attention caches grow along their cache_seq axis with zeros; ring
    buffers already at their window size pass through. A DTensor cache is
    padded into a DTensor laid out by the ambient rules for its logical
    ``axes`` (from ``cfg`` where not given), its values written into the
    owning shards (``dist.sharding.write_``).
    """
    if target_len == cur_len:
        return caches
    if saxis is None or axes is None:
        _, saxis, axes = _axis_trees(cfg)

    def pad(leaf, ax, names):
        if ax < 0 or leaf.shape[ax] != cur_len:
            return leaf           # recurrent state / ring buffer
        shape = list(leaf.shape)
        shape[ax] = target_len
        out = new_zeros(leaf, shape, names)
        write_(out, ax, 0, leaf)
        return out

    return tree_map(pad, caches, saxis, axes)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (T,) int32
    max_new_tokens: int = 16
    t_submit: float = field(default_factory=time.perf_counter)
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    tokens: list = field(default_factory=list)


class ServingEngine:
    """One engine per platform (GeoFF choreographs between them). Run under
    ``dist.sharding.use_sharding`` with params on a mesh
    (``models.model.distribute_params``), its caches are DTensors laid out
    by the rules, written in place into the owning shards."""

    def __init__(self, cfg, params, max_batch: int = 4,
                 max_len: int = 512, cache: Optional[CompileCache] = None,
                 device="cuda"):
        self.cfg = cfg.replace(scan_layers=True)
        self.device = check_device(device)
        self.params = tree_map(lambda t: t.to(self.device),
                               cast_params(self.cfg, params))
        self.max_batch = max_batch
        self.max_len = max_len
        self.queue: deque = deque()
        self.active: dict = {}            # slot -> Request
        self.cache = cache or CompileCache()
        self.stats = {"prefills": 0, "decode_steps": 0, "ttft_s": [],
                      "done": 0}

        self._prefill = lambda p, b: M.prefill(self.cfg, p, b)
        self._decode = lambda p, t, c, i: M.decode_step(self.cfg, p, t, c, i)
        self._baxis, self._saxis, self._axes = _axis_trees(self.cfg)
        # slot-batched decode state
        self.slot_caches = None
        self.slot_tokens = torch.zeros((max_batch, 1), dtype=torch.int32,
                                       device=self.device)
        self.slot_pos = np.zeros(max_batch, np.int64)  # per-slot next index
        self.free_slots = list(range(max_batch))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- pre-warm (GeoFF poke) -----------------------------------------------------
    def prewarm(self, prompt_len: int):
        """Run prefill+decode once ahead of traffic (cold start off path):
        kernel library load, cuBLAS handle, allocator growth."""
        B = self.max_batch
        dummy = {"tokens": torch.zeros((1, prompt_len), dtype=torch.int32,
                                       device=self.device)}
        self._prefill(self.params, dummy)
        caches = M.spec_zeros(cache_defs(self.cfg, B, self.max_len), self.device)
        self._decode(self.params, self.slot_tokens, caches, 0)
        self._sync()

    # -- admission -------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        while self.queue and self.free_slots:
            req = self.queue.popleft()
            slot = self.free_slots.pop(0)
            T = len(req.prompt)
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                     device=self.device)[None, :]
            logits, caches = self._prefill(self.params, {"tokens": tokens})
            self.stats["prefills"] += 1
            tok = int(torch.argmax(full(logits)[0]))
            req.tokens.append(tok)
            req.t_first_token = time.perf_counter()
            self.stats["ttft_s"].append(req.t_first_token - req.t_submit)
            caches = pad_cache(caches, self.max_len, T, saxis=self._saxis,
                               axes=self._axes)
            if self.slot_caches is None:
                # materialize the slot-batched cache tree lazily
                self.slot_caches = tree_map(
                    lambda leaf, ax, names: new_zeros(
                        leaf, leaf.shape[:ax] + (self.max_batch,)
                        + leaf.shape[ax + 1:], names),
                    caches, self._baxis, self._axes)
            # slot insertion, in place (into the owning shard of a DTensor)
            tree_map(lambda sc, c, ax: write_(sc, ax, slot, c),
                     self.slot_caches, caches, self._baxis)
            self.slot_tokens[slot, 0] = tok
            self.slot_pos[slot] = T
            self.active[slot] = req

    # -- decode ----------------------------------------------------------------------
    def _decode_once(self):
        if not self.active:
            return
        # one position index per step: use the max (sequences are
        # right-aligned enough for the demo; production uses per-slot
        # positions)
        cur = int(max(self.slot_pos[s] for s in self.active))
        cur = min(cur, self.max_len - 1)
        logits, self.slot_caches = self._decode(
            self.params, self.slot_tokens, self.slot_caches, cur)
        self.stats["decode_steps"] += 1
        toks = torch.argmax(full(logits), -1).cpu().numpy()
        finished = []
        for slot, req in list(self.active.items()):
            tok = int(toks[slot])
            req.tokens.append(tok)
            self.slot_pos[slot] += 1
            if (len(req.tokens) >= req.max_new_tokens
                    or self.slot_pos[slot] >= self.max_len - 1):
                req.t_done = time.perf_counter()
                finished.append(slot)
        for slot in finished:
            self.active.pop(slot)
            self.free_slots.append(slot)
            self.stats["done"] += 1
        self.slot_tokens = torch.as_tensor(
            toks.reshape(-1, 1).astype(np.int32), device=self.device)

    # -- main loop ---------------------------------------------------------------------
    def run(self, max_steps: int = 1000):
        """Continuous batching: admit whenever slots free up, decode the
        active batch, repeat until drained."""
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self._admit()
            self._decode_once()
            steps += 1
        return self.stats
