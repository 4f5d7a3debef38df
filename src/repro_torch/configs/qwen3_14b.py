"""Qwen3-14B: dense, GQA kv=8, qk_norm. [hf:Qwen/Qwen3-14B family]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6, ffn_variant="swiglu",
    source="hf:Qwen/Qwen3-8B (14B scaling)",
)
