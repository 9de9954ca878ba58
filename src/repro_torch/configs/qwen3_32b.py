"""qwen3-32b — dense decoder LM with qk_norm + GQA.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936
[hf:Qwen/Qwen3-32B; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    source="hf:Qwen/Qwen3-32B; hf",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    block_pattern=("global",),
    sub_quadratic=False,
)
