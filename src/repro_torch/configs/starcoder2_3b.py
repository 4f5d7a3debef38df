"""StarCoder2-3B: dense, GQA kv=2, RoPE, GELU MLP. [arXiv:2402.19173]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab_size=49152, head_dim=128,
    qkv_bias=True, rope_theta=1e5, ffn_variant="gelu",
    source="arXiv:2402.19173",
)
