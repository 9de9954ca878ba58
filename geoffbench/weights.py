"""Random weights from ``--seed``, made on the device by one generator, a
leaf a call, in the types they are served in (bf16 matrices and stacked
vectors, float32 for the one unstacked vector). Both the program and the
reference read these tensors; neither makes its own.

The tree is the dense decoder's, laid out as the port's ``param_defs``
lays it out (layers stacked along a leading axis). Norm scales are drawn
around 0 and act as ``1 + w``, the port's convention for a norm weight.
"""
from __future__ import annotations

import math

import torch

from geoffbench.traffic import derive

NORM_STD = 0.1


def layout(arch: dict) -> dict:
    """{path: (shape, std)} of every weight, in drawing order. Matrices are
    scaled by their fan-in; the embedding has unit rows."""
    L, D = arch["num_layers"], arch["d_model"]
    H, K, hd = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    F, V = arch["d_ff"], arch["vocab_size"]
    p = "blocks/cycle/p0/"
    out = {
        "embed": ((V, D), 1.0),
        "head": ((D, V), D ** -0.5),
        "final_norm": ((D,), NORM_STD),
        p + "norm1": ((L, D), NORM_STD),
        p + "norm2": ((L, D), NORM_STD),
        p + "mixer/wq": ((L, D, H, hd), D ** -0.5),
        p + "mixer/wk": ((L, D, K, hd), D ** -0.5),
        p + "mixer/wv": ((L, D, K, hd), D ** -0.5),
        p + "mixer/wo": ((L, H, hd, D), (H * hd) ** -0.5),
        p + "ffn/w_gate": ((L, D, F), D ** -0.5),
        p + "ffn/w_up": ((L, D, F), D ** -0.5),
        p + "ffn/w_down": ((L, F, D), F ** -0.5),
    }
    if arch["qk_norm"]:
        out[p + "mixer/q_norm"] = ((L, hd), NORM_STD)
        out[p + "mixer/k_norm"] = ((L, hd), NORM_STD)
    if arch["input_kind"] == "tokens+patches":
        out["patch_proj"] = ((D, D), D ** -0.5)
    return out


def make(arch: dict, seed: int, device, into: dict | None = None) -> dict:
    """The weights as a nested dict (the port's param tree). ``into``: a
    tree made before, filled again in place for another seed."""
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    tree: dict = {} if into is None else into
    for path, (shape, std) in layout(arch).items():
        *parents, name = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        t = node.get(name)
        if t is None:
            dtype = torch.bfloat16 if len(shape) >= 2 else torch.float32
            t = node[name] = torch.empty(shape, dtype=dtype, device=device)
        t.normal_(0.0, std, generator=g)
    return tree


def nbytes(arch: dict) -> int:
    return sum(math.prod(s) * (2 if len(s) >= 2 else 4)
               for s, _ in layout(arch).values())
