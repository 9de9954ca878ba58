"""Architecture configuration dataclasses.

Every assigned architecture is expressed as a frozen, hashable ``ArchConfig``
so it can be used as a cache key by the pre-warming middleware
(core/prewarm.py). A copy of ``repro/configs/base.py``; only
``param_count`` walks the port's own parameter tree.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    # -- identity -----------------------------------------------------------
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""  # provenance note from the assignment table

    # -- transformer trunk ---------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # gemma3 uses a different theta on global layers
    tie_embeddings: bool = True

    # -- per-layer block pattern, cycled over num_layers ----------------------
    # entries: "global" | "local" (sliding window) | "rglru" | "ssd"
    block_pattern: tuple = ("global",)
    local_window: int = 4096

    # -- MoE ------------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # -- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # -- RG-LRU (griffin / recurrentgemma) ------------------------------------
    lru_width: int = 0

    # -- task shape -----------------------------------------------------------
    causal: bool = True          # False for encoder-only (hubert)
    supports_decode: bool = True  # False for encoder-only
    sub_quadratic: bool = False   # True -> runs the long_500k shape
    input_kind: str = "tokens"    # tokens | frames (audio stub)
                                  # | tokens+patches (vlm stub)
    num_patches: int = 0          # vlm: patch-embedding stub length within the sequence

    # -- numerics / execution -------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    seq_shard_attn: bool = False  # sequence-parallel attention (perf lever)
    seq_shard_resid: bool = False  # Megatron-SP: residual stream seq-sharded
                                   # over `model` (halves the TP all-reduces
                                   # into RS+AG and shards norms/embeds)
    moe_local_scatter: bool = False  # pin MoE dispatch scatter model-local,
                                     # then slice to EP (avoids GSPMD
                                     # all-reducing the dispatch buffer)
    moe_tp_ff: bool = False  # shard expert FFN on d_ff over `model` instead
                             # of EP: every dispatch/combine scatter+gather
                             # becomes model-LOCAL (only a token-sized
                             # partial-sum all-reduce crosses ranks)
    attn_chunk_q: int = 0         # 0 = full-score attention; >0 = flash-style
                                  # q-chunked attention (memory O(chunk*S))
    attn_chunk_unroll: bool = True  # python-unrolled chunks (exact HLO flop
                                    # accounting) vs lax.scan (small HLO)
    ce_chunk: int = 0             # 0 = full logits; >0 = seq-chunked CE loss
    remat: str = "none"           # none | full | dots
    scan_layers: bool = True
    use_pallas: bool = False      # Pallas kernels (interpret on CPU); jnp path default
    logits_softcap: float = 0.0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # -- derived -------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """Mamba-2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> tuple:
        """The concrete per-layer block kinds, pattern cycled to num_layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline term)."""
        from repro_torch.models.model import param_defs
        from repro_torch.models.params import param_count
        return param_count(param_defs(self))

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        total = self.param_count()
        if self.num_experts and self.top_k:
            # expert FFN params: 3 matrices per expert (gate/up/down)
            per_expert = 3 * self.d_model * self.d_ff
            inactive = (self.num_experts - self.top_k) * per_expert * self.num_layers
            return total - inactive
        return total


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ArchConfig) -> tuple:
    """The shape cells that are well-defined for this architecture.

    Skips (recorded in DESIGN.md §Arch-applicability):
      - decode shapes for encoder-only archs (no autoregressive step)
      - long_500k for pure full-attention archs (needs sub-quadratic attention)
    """
    out = []
    for s in ALL_SHAPES:
        if s.kind == "decode" and not cfg.supports_decode:
            continue
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(s)
    return tuple(out)
