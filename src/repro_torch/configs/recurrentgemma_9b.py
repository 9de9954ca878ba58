"""recurrentgemma-9b — hybrid RG-LRU + local attention (griffin),
1 attn : 2 recurrent.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000
[arXiv:2402.19427; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427; unverified",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    rope_theta=10_000.0,
    tie_embeddings=True,
    # griffin pattern: (recurrent, recurrent, local-attn) cycled
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    lru_width=4096,
    conv_width=4,
    sub_quadratic=True,  # bounded window + O(1) recurrent state -> runs long_500k
)
