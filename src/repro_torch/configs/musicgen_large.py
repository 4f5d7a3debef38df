"""MusicGen-large backbone: decoder-only over EnCodec tokens.

Modality frontend (EnCodec) is a STUB per the assignment: input_specs()
provides precomputed frame embeddings (B, S, D). [arXiv:2306.05284]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    ffn_variant="gelu", embed_inputs=False,
    source="arXiv:2306.05284",
)
