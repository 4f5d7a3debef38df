"""Granite-MoE 3B-a800m: 40 experts top-8, GQA kv=8. [hf:ibm-granite]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    n_experts=40, top_k=8, ffn_variant="swiglu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (3b scaling)",
)
