"""Chameleon-34B backbone: early-fusion VLM over VQ image tokens.

qk_norm enabled (required for Chameleon training stability per the paper).
Patch/VQ frontend is a STUB: input_specs() provides precomputed embeddings.
[arXiv:2405.09818; unverified tier]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536, head_dim=128,
    qk_norm=True, ffn_variant="swiglu", embed_inputs=False,
    source="arXiv:2405.09818",
)
