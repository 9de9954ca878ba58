"""Declarative parameter definitions (port of ``repro/models/params.py``).

A model is described once as a tree of ``ParamDef`` (shape + logical axes +
init); materialized params are derived from that single source.

``init_params`` draws the same distributions as the JAX package, each leaf
from its own ``torch.Generator`` on the target device, seeded from the base
seed and the sha256 of the leaf's path string (the JAX package folds the
same hash into its PRNG key). The numbers differ from JAX's: the two
generators are different streams. A stacked leaf is drawn one layer slice
at a time, so its numbers are not those of one draw of the whole leaf.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models.tree import tree_leaves, tree_map, tree_map_with_path


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple               # logical axis names, len == len(shape)
    init: str = "normal"      # normal | zeros | ones | embed
                              # | lru_lambda | ssd_alog | dt_bias
    scale: Optional[float] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _is_def(x):
    return isinstance(x, ParamDef)


def check_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and there is
    none (entry points never carry on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


def _path_generator(seed: int, path: str, device) -> torch.Generator:
    h = int.from_bytes(hashlib.sha256(path.encode()).digest()[:4], "big")
    g = torch.Generator(device=device)
    g.manual_seed((seed * 0x9E3779B97F4A7C15 + h) % (1 << 63))
    return g


def _uniform(shape, g, device, lo, hi):
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    return u * (hi - lo) + lo


def _scale(d: ParamDef) -> float:
    if d.scale is not None:
        return d.scale
    # fan-in variance scaling; the stacked "layers" axis is NOT a fan-in dim
    # (with it, a 2-cycle model would initialize every weight ~1/sqrt(2) too
    # small)
    eff = d.shape[1:] if (d.axes and d.axes[0] == "layers") else d.shape
    fan_in = eff[0] if len(eff) >= 1 else 1
    return 1.0 if d.init == "embed" else 1.0 / math.sqrt(max(1, fan_in))


def _draw(d: ParamDef, shape, g, device):
    """``d``'s init at ``shape`` (all of ``d.shape`` or one layer slice of
    it), float32, scaled in place."""
    if d.init == "dt_bias":
        # mamba2 dt bias: softplus^-1 of dt in [1e-3, 1e-1]
        u = _uniform(shape, g, device, math.log(1e-3), math.log(1e-1))
        dt = torch.exp(u)
        return dt + torch.log(-torch.expm1(-dt))
    if d.init == "ssd_alog":
        return torch.log(_uniform(shape, g, device, 1.0, 16.0))
    if d.init == "lru_lambda":
        # RG-LRU Lambda: sigmoid(L)^c in [0.9, 0.999] at c=8
        r = _uniform(shape, g, device, 0.9, 0.999)
        a = r ** (1.0 / 8.0)
        return torch.log(a / (1 - a))
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return x.mul_(_scale(d))


def _materialize(d: ParamDef, g, dtype, device):
    """``d`` on ``device`` in ``dtype``. A leaf with a leading ``layers``
    axis is drawn one layer slice at a time (float32, scaled in place, cast
    into its slot of the ``dtype`` tensor), every other leaf whole, so the
    float32 draw never holds more than one slice or one unstacked leaf."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if not d.axes or d.axes[0] != "layers":
        return _draw(d, d.shape, g, device).to(dtype)
    out = torch.empty(d.shape, dtype=dtype, device=device)
    for i in range(d.shape[0]):
        out[i].copy_(_draw(d, d.shape[1:], g, device))
    return out


def init_params(defs, generator: torch.Generator, dtype=torch.float32,
                device="cuda", vector_dtype=None):
    """Materialize ``defs`` on ``device``: a leaf with ``ndim >= 2`` in
    ``dtype``, any other in ``vector_dtype`` (``dtype`` if None). The base
    seed is ``generator.initial_seed()``. The values do not depend on the
    dtypes: a float32 draw cast."""
    dev = check_device(device)
    seed = generator.initial_seed()
    vector_dtype = dtype if vector_dtype is None else vector_dtype

    def leaf(path, d):
        return _materialize(d, _path_generator(seed, path, dev),
                            dtype if len(d.shape) >= 2 else vector_dtype, dev)
    return tree_map_with_path(leaf, defs, is_leaf=_is_def)


def param_count(defs) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs, is_leaf=_is_def))


def stack_defs(defs, n: int):
    """Stack a block's defs along a leading `layers` axis."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes, d.init, d.scale),
        defs, is_leaf=_is_def)
