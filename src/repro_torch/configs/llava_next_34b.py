"""llava-next-34b — VLM: Yi-34B-class decoder backbone with anyres patch tiling.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-34b-hf; unverified]

The vision tower + anyres tiling projector is a STUB: the caller
provides precomputed patch embeddings (batch, num_patches, d_model) that are
prepended to the token embeddings (the standard llava-next layout).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-34b-hf; unverified",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    block_pattern=("global",),
    sub_quadratic=False,
    input_kind="tokens+patches",
    num_patches=1152,  # anyres: 1 base tile + 1 grid tile stub at 576 patches each
)
