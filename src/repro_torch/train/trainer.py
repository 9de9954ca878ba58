"""Fault-tolerant training loop, choreographed GeoFF-style (port of
``repro/train/trainer.py``).

The loop is a repeating 3-step workflow:
    data_fetch  ->  train_step  ->  (periodic) checkpoint
with GeoFF's overlap rules applied to each edge:
  - batch k+1 is PRE-FETCHED (DoubleBuffer, side-stream copy to the card)
    while step k computes,
  - train_step is PRE-WARMED through CompileCache before step 0,
  - checkpoints are ASYNC (snapshot to host, then a background write).

Fault tolerance:
  - checkpoint/restart: ``run()`` resumes from the newest complete manifest
    (the data stream is step-addressable, so the token sequence is exact),
  - straggler mitigation: per-step wall times feed an EWMA; a step slower
    than ``straggler_factor`` x the EWMA is recorded and fires
    ``on_straggler``.

Elastic re-mesh (``remesh``) and a mesh argument wait for the distribution
item of the port and raise.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.prewarm import CompileCache, TensorSpec
from repro_torch.core.timing import EWMA
from repro_torch.data.pipeline import make_train_iterator
from repro_torch.models import model as M
from repro_torch.models.params import check_device
from repro_torch.optim import AdamW, AdamWConfig

_NO_MESH = ("meshes and re-meshing wait for the distribution item of the port "
            "(ROADMAP queue 1); the trainer runs on one device")


@dataclass
class TrainerConfig:
    seq_len: int = 256
    global_batch: int = 8
    total_steps: int = 50
    checkpoint_every: int = 20
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    straggler_factor: float = 3.0
    seed: int = 0
    adamw: AdamWConfig = field(default_factory=AdamWConfig)


class Trainer:
    def __init__(self, cfg, tcfg: TrainerConfig, mesh=None, rules=None,
                 device="cuda"):
        if mesh is not None or rules is not None:
            raise NotImplementedError(_NO_MESH)
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = check_device(device)
        self.opt = AdamW(tcfg.adamw)
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir)
        self.cache = CompileCache()
        self.step_time = EWMA(0.3)
        self.stragglers: list = []
        self.on_straggler: Optional[Callable] = None
        self.metrics_log: list = []

        self.params = None
        self.opt_state = None
        self.step = 0
        self._step_fn = None

    # -- state -------------------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        self.params = M.init_params(self.cfg, gen, self.device)
        self.opt_state = self.opt.init(self.params)
        return self

    # -- train step (pre-warmed) ---------------------------------------------------
    def _build_step(self):
        self._step_fn = M.make_train_step(self.cfg, self.opt)
        return self._step_fn

    def prewarm(self, example_batch):
        """GeoFF pre-warming before the loop, through ``CompileCache``: one
        forward and backward pass on zeros of ``example_batch``'s shapes over
        the live params, its grads dropped. The params and optimizer state
        are left bit for bit as they were, and no second copy of them is
        made (the cache's stand-ins are of the batch only). The optimizer's
        update is not warmed: it would write the live state. Called before
        any state exists, it first draws the state and restores the newest
        checkpoint, as ``run`` would, so a later ``run`` resumes. Returns
        once warm."""
        if self.params is None:
            self.init_state()
            self.maybe_restore()
        step_fn = self._step_fn or self._build_step()
        abstract = {k: TensorSpec(tuple(np.shape(v)), torch.as_tensor(v).dtype,
                                  str(self.device))
                    for k, v in example_batch.items()}

        def warm(batch):
            M.value_and_grad(self.cfg, self.params, batch)
            return step_fn

        self.cache.warm("train_step", "trainer", warm, (abstract,)).result()

    # -- fault tolerance -----------------------------------------------------------
    def maybe_restore(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        tree = {"params": self.params, "opt": self.opt_state}
        restored = self.ckpt.restore(latest, tree, self.device)
        self.params, self.opt_state = restored["params"], restored["opt"]
        self.step = latest
        return True

    def remesh(self, new_mesh, new_rules=None):
        raise NotImplementedError(_NO_MESH)

    # -- the loop --------------------------------------------------------------------
    def run(self, steps: Optional[int] = None, inject_straggler_at=None):
        steps = steps or self.tcfg.total_steps
        if self.params is None:
            self.init_state()
            self.maybe_restore()
        it = make_train_iterator(self.cfg, self.tcfg.seq_len,
                                 self.tcfg.global_batch, start_step=self.step,
                                 seed=self.tcfg.seed, device=self.device)
        self._build_step()
        end = self.step + steps
        while self.step < end:
            batch = next(it)
            t0 = time.perf_counter()
            if inject_straggler_at is not None and \
                    self.step == inject_straggler_at:
                time.sleep(max(0.2, 10 * (self.step_time.value or 0.02)))
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch, self.step)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            if (self.step_time.n > 3
                    and dt > self.tcfg.straggler_factor
                    * self.step_time.value):
                self.stragglers.append((self.step, dt, self.step_time.value))
                if self.on_straggler:
                    self.on_straggler(self.step, dt)
            else:
                self.step_time.update(dt)
            self.metrics_log.append(
                {"step": self.step, "loss": loss,
                 "grad_norm": float(metrics["grad_norm"]), "dt": dt})
            self.step += 1
            if self.step % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(self.step, {"params": self.params,
                                           "opt": self.opt_state})
        self.ckpt.save(self.step, {"params": self.params,
                                   "opt": self.opt_state}, blocking=True)
        return self.metrics_log
