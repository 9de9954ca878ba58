"""Model-level public API, serving half (port of ``repro/models/model.py``).

  param_defs / init_params        declarative params
  init_serving_params             params drawn in their serving dtypes
  prefill / decode_step           serving
  spec_zeros                      zero caches from SpecDefs

Training (``forward_train`` and the step factories) is not ported yet.
``init_params``, ``init_serving_params`` and ``spec_zeros`` put their
tensors on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

from repro_torch.models import params as prm
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import _is_spec
from repro_torch.models.tree import tree_map


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def param_defs(cfg) -> dict:
    return tfm.transformer_defs(cfg)


def init_params(cfg, generator: torch.Generator, device="cuda"):
    return prm.init_params(param_defs(cfg), generator,
                           getattr(torch, cfg.param_dtype), device)


def init_serving_params(cfg, generator: torch.Generator, device="cuda"):
    """``tfm.cast_params(cfg, init_params(...))``, drawn in those dtypes
    (``ndim >= 2`` in ``compute_dtype``, vectors in float32): the peak is
    the serving bytes plus one float32 layer slice or unstacked leaf. It is
    how a model of 55-69 GB in bf16 is initialised on one 80 GB card; the
    JAX package has no such function."""
    return prm.init_params(param_defs(cfg), generator,
                           getattr(torch, cfg.compute_dtype), device,
                           vector_dtype=torch.float32)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------
def prefill(cfg, params, batch):
    """Full-sequence forward that also returns the layer caches.

    Returns (last_logits (B,V) float32, caches). Cache sequence capacity is
    the prompt length; serving pads to the generation budget
    (serving/engine.pad_cache). ``cast_params`` is free when the params are
    already cast (the serving engine casts once).
    """
    p = tfm.cast_params(cfg, params)
    x = tfm.embed_inputs(cfg, p, batch)
    T = x.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=x.device)
    mode = "prefill" if cfg.supports_decode else "train"  # encoders: no cache
    x, delta, caches, _ = tfm.run_blocks(cfg, p, x, positions, mode)
    _, x = tfm.add_norm(cfg, x, delta, p["final_norm"])
    logits = tfm.unembed(cfg, p, x[:, -1:, :])
    return logits[:, 0, :].float(), (caches or {})


def decode_step(cfg, params, token, caches, cur_index):
    """One autoregressive step.

    token: (B, 1) int; cur_index: int — the absolute position the new token
    occupies (its KV lands at ``cur_index % window`` for local layers).
    Returns (logits (B, V) float32, caches); the caches are updated in place
    and returned.
    """
    p = tfm.cast_params(cfg, params)
    x = tfm.embed_inputs(cfg, p, {"tokens": token})
    positions = torch.full((1,), int(cur_index), dtype=torch.int32,
                           device=x.device)
    x, delta, caches, _ = tfm.run_blocks(cfg, p, x, positions, "decode",
                                         caches, cur_index)
    _, x = tfm.add_norm(cfg, x, delta, p["final_norm"])
    logits = tfm.unembed(cfg, p, x)
    return logits[:, 0, :].float(), caches


# ---------------------------------------------------------------------------
# spec helpers
# ---------------------------------------------------------------------------
def spec_zeros(defs, device="cuda"):
    dev = prm.check_device(device)
    return tree_map(
        lambda d: torch.zeros(d.shape, dtype=getattr(torch, d.dtype), device=dev),
        defs, is_leaf=_is_spec)
