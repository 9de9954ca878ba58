"""AdamW with warmup+cosine schedule and global-norm clipping (port of
``repro/optim/adamw.py``).

State is {m, v, count}; m/v mirror the parameter tree in float32, so the
optimizer adds exactly 2x float32 parameter bytes. The schedule, the clip
scale and the bias corrections are float32 tensors, as in the JAX package.

Unlike the JAX package, whose update returns new arrays, ``update`` writes
the new params, m and v into the tensors it is given (under ``no_grad``):
at qwen3-1.7b a functional update would hold a second 20.6 GB of params
and moments. It returns ``(params, state, gnorm)`` all the same, with
``state["count"]`` a new tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.params import ParamDef
from repro_torch.models.tree import tree_leaves, tree_map


def cosine_schedule(step, *, peak_lr, warmup_steps, total_steps,
                    final_frac=0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``final_frac`` of
    it at ``total_steps``; a float32 tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * (step + 1.0) / max(1, warmup_steps)
    t = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps),
                    0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                     (1.0 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamW:
    def __init__(self, cfg: AdamWConfig = AdamWConfig()):
        self.cfg = cfg

    # -- state ---------------------------------------------------------------
    def init(self, params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else "cpu"

        def zeros(p):  # a DTensor's moments take its placements
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def state_defs(self, pdefs):
        """ParamDef tree for the opt state (the stand-ins of a dry run)."""
        def f32():
            return tree_map(lambda d: ParamDef(d.shape, d.axes, "zeros"), pdefs,
                            is_leaf=lambda x: isinstance(x, ParamDef))
        return {"m": f32(), "v": f32(), "count": ParamDef((), (), "zeros")}

    # -- update ----------------------------------------------------------------
    @torch.no_grad()
    def update(self, params, state, grads, step):
        """One step: params, m and v are updated in place and returned, with
        the new count and the global grad norm (float32) before clipping."""
        c = self.cfg
        count = state["count"] + 1
        dev = count.device
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        scale = torch.clamp(c.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = cosine_schedule(torch.as_tensor(step, device=dev),
                             peak_lr=c.peak_lr, warmup_steps=c.warmup_steps,
                             total_steps=c.total_steps)
        bc1 = 1.0 - c.b1 ** count.float()
        bc2 = 1.0 - c.b2 ** count.float()

        def upd(p, g, m, v):
            g = g.float() * scale
            m.mul_(c.b1).add_(g, alpha=1 - c.b1)
            v.mul_(c.b2).addcmul_(g, g, value=1 - c.b2)
            denom = torch.div(v, bc2).sqrt_().add_(c.eps)
            step_ = torch.div(m, bc1).div_(denom)
            del denom
            if p.ndim >= 2:  # decoupled wd on matrices only
                step_.add_(p.float(), alpha=c.weight_decay)
            step_.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(step_)
            else:
                p.copy_(p.float().sub_(step_))
            return p

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, {"m": state["m"], "v": state["v"], "count": count}, gnorm
