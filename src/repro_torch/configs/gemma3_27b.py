"""gemma3-27b — dense decoder LM, 5:1 local:global attention, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3-27b-pt; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    source="hf:google/gemma-3-27b-pt; unverified",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    qk_norm=True,
    rope_theta=10_000.0,          # local layers
    rope_theta_global=1_000_000.0,  # global layers
    tie_embeddings=True,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    local_window=1024,
    # Global layers remain full attention -> not sub-quadratic; skip long_500k.
    sub_quadratic=False,
)
