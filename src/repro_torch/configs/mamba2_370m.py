"""mamba2-370m — attention-free SSM using SSD (state-space duality).

48L d_model=1024 (attn-free) vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    source="arXiv:2405.21060; unverified",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    block_pattern=("ssd",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_width=4,
    sub_quadratic=True,  # O(1) decode state -> runs long_500k
)
