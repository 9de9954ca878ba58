"""hubert-xlarge — audio encoder-only transformer (w2v2-family backbone).

48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504
[arXiv:2106.07447; unverified]

The modality frontend (CNN feature extractor) is a STUB: the caller
provides precomputed frame embeddings of shape (batch, frames, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    source="arXiv:2106.07447; unverified",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    tie_embeddings=False,
    block_pattern=("global",),
    causal=False,
    supports_decode=False,
    sub_quadratic=False,
    input_kind="frames",
)
