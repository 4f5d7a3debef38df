"""Qwen1.5-0.5B: dense, MHA (GQA kv=16), QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151936, head_dim=64,
    qkv_bias=True, rope_theta=1e6, ffn_variant="swiglu",
    tie_embeddings=True,  # Qwen1.5-0.5B ties input/output embeddings
    source="hf:Qwen/Qwen1.5-0.5B",
)
