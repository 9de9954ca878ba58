"""Operations and bytes the work needs, from the shapes of the calls the
requests make, and the card's published peaks. A count is what the
algorithm needs for these inputs: each multiply-add is 2 operations, a
causal mask counts only the pairs it keeps, and each input byte is read
once and each output byte written once, whatever a kernel reads again."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def causal_pairs(t: int) -> int:
    """(query, key) pairs a causal mask keeps over t positions."""
    return t * (t + 1) // 2


def attention_flops(t: int, heads: int, head_dim: int) -> int:
    """QKᵀ and PV of one causal attention call over t positions."""
    return 2 * 2 * heads * head_dim * causal_pairs(t)


def attention_bytes(t: int, heads: int, kv_heads: int, head_dim: int) -> int:
    """q, k, v read and the output written once, bf16."""
    return BF16_BYTES * head_dim * t * (2 * heads + 2 * kv_heads)


def attention_bound_s(t: int, heads: int, kv_heads: int, head_dim: int) -> float:
    """The least time one call could take: the larger of its operations at
    the bf16 peak and its bytes at the HBM peak."""
    return max(attention_flops(t, heads, head_dim) / PEAK_BF16_FLOPS,
               attention_bytes(t, heads, kv_heads, head_dim) / PEAK_HBM_BYTES_PER_S)


def prefill_flops(arch: dict, text_len: int, patches: int = 0) -> int:
    """Model operations of one prefill of ``patches + text_len`` positions
    through a dense GQA decoder (``arch``: a configuration's ``port``
    group): the q/k/v/o projections, causal attention and the gated MLP of
    every layer, the patch projection, and the head at the last position
    (the only logits a prefill computes). Norms, rope and the embedding
    gather are elementwise and left out."""
    t = text_len + patches
    d, hd, f = arch["d_model"], arch["head_dim"], arch["d_ff"]
    h, k = arch["num_heads"], arch["num_kv_heads"]
    layer = (2 * t * d * (h + 2 * k) * hd       # q, k, v
             + 2 * t * h * hd * d               # o
             + 2 * 3 * t * d * f                # gate, up, down
             + attention_flops(t, h, hd))
    return (arch["num_layers"] * layer + 2 * patches * d * d
            + 2 * d * arch["vocab_size"])
