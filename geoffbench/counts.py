"""Operations and bytes the work needs, from the shapes of the calls the
requests make, and the card's published peaks. A count is what the
algorithm needs for these inputs: each multiply-add is 2 operations, a
causal mask counts only the pairs it keeps, and each input byte is read
once and each output byte written once, whatever a kernel reads again.
A model's own totals (``prefill_flops``, ``bounds``) are in its module
under ``models/``, built from these."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def causal_pairs(t: int) -> int:
    """(query, key) pairs a causal mask keeps over t positions."""
    return t * (t + 1) // 2


def attention_flops(t: int, heads: int, head_dim: int, v_dim: int | None = None) -> int:
    """QKᵀ (``head_dim`` deep) and PV (``v_dim`` wide, ``head_dim`` where
    not given) of one causal attention call over t positions."""
    v_dim = head_dim if v_dim is None else v_dim
    return 2 * heads * (head_dim + v_dim) * causal_pairs(t)


def attention_bytes(t: int, heads: int, kv_heads: int, head_dim: int,
                    v_dim: int | None = None) -> int:
    """q, k, v read and the output written once, bf16."""
    v_dim = head_dim if v_dim is None else v_dim
    return BF16_BYTES * t * (heads + kv_heads) * (head_dim + v_dim)


def attention_bound_s(t: int, heads: int, kv_heads: int, head_dim: int,
                      v_dim: int | None = None) -> float:
    """The least time one call could take: the larger of its operations at
    the bf16 peak and its bytes at the HBM peak."""
    return max(attention_flops(t, heads, head_dim, v_dim) / PEAK_BF16_FLOPS,
               attention_bytes(t, heads, kv_heads, head_dim, v_dim) / PEAK_HBM_BYTES_PER_S)
