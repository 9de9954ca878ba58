"""Carry parameters and KV caches across from the JAX package.

The JAX package's trees arrive as numpy arrays, as
``jax.tree_util.tree_map(np.asarray, tree)`` gives them. The port keeps the
same nested keys and layouts (stacked ``wq`` ``(L, D, H, hd)``, ``wo``
``(L, H, hd, D)``, caches ``{"cycle": {"p0": (k, v)}}`` with k
``(L, B, S, K, hd)``, recurrent caches ``{"conv": ..., "state"/"h": ...}``),
so conversion is a copy of each leaf onto the
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
    """The JAX package's caches (numpy leaves, tuples kept) as the port's.

    Batch size and sequence capacity S are read from the arrays along the
    axes that ``cache_defs`` names ``"batch"`` and ``"cache_seq"`` (recurrent
    leaves have no ``cache_seq``; S is the largest ``cache_seq``); every leaf
    is then checked against ``cache_defs`` at those sizes. A global layer
    holds S slots; a local layer holds its ring buffer of min(window, S), or
    S where a prompt no longer than the window was padded to S."""
    dev = check_device(device)
    if not tree_leaves(np_tree):
        return {}
    axes = cache_defs(cfg, 1, 1)
    if not _same_structure(axes, np_tree, _is_spec):
        raise ValueError(f"cache tree does not match {cfg.name}'s cache layout")
    pairs = []  # (logical axes, array shape) of every leaf
    tree_map(lambda d, a: pairs.append((d.axes, np.shape(a))), axes, np_tree,
             is_leaf=_is_spec)
    batch = pairs[0][1][pairs[0][0].index("batch")]
    seq = max((shape[ax.index("cache_seq")] for ax, shape in pairs
               if "cache_seq" in ax), default=1)
    defs = cache_defs(cfg, batch, seq)

    def conv(d, a):
        t = _tensor(a, dev)
        allowed = {tuple(d.shape)}
        if "cache_seq" in d.axes:
            padded = list(d.shape)
            padded[d.axes.index("cache_seq")] = seq
            allowed.add(tuple(padded))
        if tuple(t.shape) not in allowed:
            raise ValueError(f"cache shape {tuple(t.shape)} != {d.shape}")
        return t
    return tree_map(conv, defs, np_tree, is_leaf=_is_spec)
