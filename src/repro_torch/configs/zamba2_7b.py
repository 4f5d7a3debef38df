"""Zamba2-7B: Mamba2 backbone + shared attention block. [arXiv:2411.15242]

81 layer slots; every 6th slot applies the SHARED attention+FFN block
(weights reused across applications), the rest are Mamba2 (ssm_state=64).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_state=64, attn_period=6, expand=2,
    sub_quadratic=True,
    source="arXiv:2411.15242 (unverified tier)",
)
