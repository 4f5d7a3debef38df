"""StableLM-3B: dense, MHA (kv=32). [hf:stabilityai/stablelm-2 family]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab_size=50304, head_dim=80,
    qkv_bias=False, rope_theta=1e4, ffn_variant="swiglu",
    source="hf:stabilityai/stablelm-2-1_6b (3B scaling; unverified tier)",
)
