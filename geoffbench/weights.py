"""Random weights from ``--seed``, made on the device by one generator, a
leaf a call, in the types they are served in. Both the program and the
reference read these tensors; neither makes its own.

The tree is the one the configuration's model module lays out
(``models/<name>.py``: ``layout``), in its drawing order. Norm scales are
drawn around 0 and act as ``1 + w``, the port's convention for a norm
weight.
"""
from __future__ import annotations

import math

import torch

from geoffbench.traffic import derive

NORM_STD = 0.1


def _dtype(entry: tuple) -> torch.dtype:
    """A layout entry's type: its own, else bf16 for two or more dims and
    float32 for a vector."""
    if len(entry) > 2:
        return entry[2]
    return torch.bfloat16 if len(entry[0]) >= 2 else torch.float32


def make(layout: dict, seed: int, device, into: dict | None = None) -> dict:
    """The weights of ``layout`` ({path: (shape, std[, dtype])}) as a nested
    dict (the port's param tree). ``into``: a tree made before, filled
    again in place for another seed."""
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    tree: dict = {} if into is None else into
    for path, entry in layout.items():
        shape, std = entry[:2]
        *parents, name = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        t = node.get(name)
        if t is None:
            t = node[name] = torch.empty(shape, dtype=_dtype(entry), device=device)
        t.normal_(0.0, std, generator=g)
    return tree


def nbytes(layout: dict) -> int:
    return sum(math.prod(e[0]) * _dtype(e).itemsize for e in layout.values())
