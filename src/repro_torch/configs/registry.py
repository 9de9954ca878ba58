"""Architecture registry: ``--arch <id>`` -> ArchConfig.

Lists the JAX package's ten configs, in its order. ``smoke_config`` is the
same REDUCED same-family config as there: small layers/width, tiny embedding
tables, for CPU tests.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, SHAPES, ALL_SHAPES,  # noqa: F401
                                      applicable_shapes)

_MODULES = {
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
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
