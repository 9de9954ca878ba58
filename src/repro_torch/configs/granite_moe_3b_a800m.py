"""granite-moe-3b-a800m — MoE decoder LM, 40 experts top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512(expert) vocab=49155, MoE 40e top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-3b-a800m-base; hf",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    tie_embeddings=True,
    block_pattern=("global",),
    num_experts=40,
    top_k=8,
    sub_quadratic=False,
)
