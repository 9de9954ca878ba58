"""Carry parameters and KV caches across from the JAX package.

The JAX package's trees arrive as numpy arrays, as
``jax.tree_util.tree_map(np.asarray, tree)`` gives them. The port keeps the
same nested keys and layouts (stacked ``wq`` ``(L, D, H, hd)``, ``wo``
``(L, H, hd, D)``, caches ``{"cycle": {"p0": (k, v)}}`` with k
``(L, B, S, K, hd)``), so conversion is a copy of each leaf onto the
device, checked against the port's own definitions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import param_defs
from repro_torch.models.params import ParamDef, check_device
from repro_torch.models.transformer import _is_spec, cache_defs
from repro_torch.models.tree import tree_leaves, tree_map


def _tensor(a, device) -> torch.Tensor:
    """A copy (JAX's exported arrays are read-only, and decode writes caches
    in place)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no numpy twin in torch
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _same_structure(a, b, is_leaf) -> bool:
    def sig(t):
        if is_leaf is not None and is_leaf(t):
            return "*"
        if isinstance(t, dict):
            return {k: sig(t[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return [sig(x) for x in t]
        return "*"
    return sig(a) == sig(b)


def params_from_jax(np_tree, cfg, device="cuda"):
    """The JAX package's params (numpy leaves) as the port's params."""
    dev = check_device(device)
    defs = param_defs(cfg)
    is_def = lambda x: isinstance(x, ParamDef)  # noqa: E731
    if not _same_structure(defs, np_tree, is_def):
        raise ValueError(f"parameter tree does not match {cfg.name}'s definitions")

    def conv(d, a):
        t = _tensor(a, dev)
        if tuple(t.shape) != tuple(d.shape):
            raise ValueError(f"parameter shape {tuple(t.shape)} != {d.shape}")
        return t
    return tree_map(conv, defs, np_tree, is_leaf=is_def)


def caches_from_jax(np_tree, cfg, device="cuda"):
    """The JAX package's KV caches (numpy leaves, tuples kept) as the port's.

    Batch and sequence capacity are read from the arrays and checked against
    ``cache_defs`` at those sizes."""
    dev = check_device(device)
    leaves = tree_leaves(np_tree)
    if not leaves:
        return {}
    # (L, B, S, K, hd); ring buffers hold min(window, S), so S is the max
    batch = np.shape(leaves[0])[1]
    seq = max(np.shape(a)[2] for a in leaves)
    defs = cache_defs(cfg, batch, seq)
    if not _same_structure(defs, np_tree, _is_spec):
        raise ValueError(f"cache tree does not match {cfg.name}'s cache layout")

    def conv(d, a):
        t = _tensor(a, dev)
        if tuple(t.shape) != tuple(d.shape):
            raise ValueError(f"cache shape {tuple(t.shape)} != {d.shape}")
        return t
    return tree_map(conv, defs, np_tree, is_leaf=_is_spec)
