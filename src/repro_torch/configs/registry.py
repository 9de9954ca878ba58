"""Architecture registry: ``--arch <id>`` -> ArchConfig.

Lists the configs the PyTorch port can run today (the JAX package's
``repro/configs/registry.py`` lists all ten). ``smoke_config`` is the same
REDUCED same-family config as there: small layers/width, tiny embedding
tables, for CPU tests.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, SHAPES, ALL_SHAPES,  # noqa: F401
                                      applicable_shapes)

_MODULES = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def smoke_config(arch: str) -> ArchConfig:
    """Reduced same-family config: fits a CPU forward/train step in <~1 s."""
    cfg = get_config(arch)
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=max(2, 2 * len(cfg.block_pattern)) if len(cfg.block_pattern) > 1
        else 2,
        d_model=64,
        vocab_size=256,
        param_dtype="float32",
        compute_dtype="float32",
        scan_layers=cfg.scan_layers,
    )
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2) or 1, head_dim=16)
    if cfg.d_ff:
        kw.update(d_ff=128)
    if cfg.num_experts:
        kw.update(num_experts=4, top_k=2, d_ff=32)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.lru_width:
        kw.update(lru_width=64)
    if cfg.local_window:
        kw.update(local_window=min(cfg.local_window, 32))
    if cfg.num_patches:
        kw.update(num_patches=8)
    return cfg.replace(**kw)
