"""moonshot-v1-16b-a3b — MoE decoder LM (kimi/moonlight family), 64 experts top-6.

48L d_model=2048 16H (MHA kv=16) d_ff=1408(expert) vocab=163840, MoE 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    rope_theta=50_000.0,
    tie_embeddings=False,
    block_pattern=("global",),
    num_experts=64,
    top_k=6,
    sub_quadratic=False,
)
