"""Architecture configuration and registry of the LM stack.

The counterpart of ``repro.configs.base``: ``ArchConfig`` (the published
numbers of one architecture), ``reduced()`` (the same family at CPU size),
the analytic ``param_count`` / ``active_param_count`` and ``get_config``.
The registry maps every name the reference knows (ten LMs and the paper's
two SNN configurations) to its module here.  The dry-run material
(``ShapeSpec``, ``SHAPES``, ``input_specs``, ``supports``,
``skip_reason``) waits for ROADMAP A12.3.
"""
from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ArchConfig", "get_config", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # Attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0

    # MoE (d_ff is the per-expert hidden size)
    n_experts: int = 0
    top_k: int = 0

    # SSM / RWKV / hybrid
    ssm_state: int = 0             # Mamba2 N (zamba2) / rwkv head size
    attn_period: int = 0           # zamba2: shared attn block every N slots
    expand: int = 2                # mamba2 d_inner = expand * d_model

    # Modality frontend stub: inputs are precomputed embeddings, not ids.
    embed_inputs: bool = True

    sub_quadratic: bool = False

    ffn_variant: str = "swiglu"    # "swiglu" (3 mats) | "gelu" (2 mats)
    rmsnorm_eps: float = 1e-5
    tie_embeddings: bool = False

    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocabulary padded to a multiple of 128; the pad logits are
        masked to -1e30, so sampling sees exactly the true vocabulary."""
        return -(-self.vocab_size // 128) * 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU tests (the reference's numbers)."""
        n_layers = 7 if self.family == "hybrid" else 2
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=(max(1, min(self.n_kv_heads, 2))
                        if self.n_kv_heads < self.n_heads else 4),
            head_dim=16,
            d_ff=128 if not self.n_experts else 32,
            vocab_size=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            attn_period=min(self.attn_period, 3) if self.attn_period else 0,
        )

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6
            return emb + self.n_layers * _rwkv6_layer_params(self)
        if self.family == "hybrid":  # zamba2
            _, n_mamba = _zamba2_counts(self)
            attn = _attn_params(self) + 2 * d * ff + d * ff  # shared block + mlp
            return emb + n_mamba * _mamba2_layer_params(self) + attn
        attn = _attn_params(self)
        ffn_mats = 3 if self.ffn_variant == "swiglu" else 2
        if self.n_experts:
            ffn = self.n_experts * ffn_mats * d * ff + d * self.n_experts
        else:
            ffn = ffn_mats * d * ff
        return emb + self.n_layers * (attn + ffn)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: the top_k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        ffn_mats = 3 if self.ffn_variant == "swiglu" else 2
        all_experts = self.n_layers * self.n_experts * ffn_mats * d * ff
        active = self.n_layers * self.top_k * ffn_mats * d * ff
        return self.param_count() - all_experts + active


def _attn_params(cfg: ArchConfig) -> int:
    d, hd = cfg.d_model, cfg.head_dim_
    return d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d


def _rwkv6_layer_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    # time-mix: r,k,v,g,w projections + output; channel-mix: 2 mats (d x ff)
    return 5 * d * d + d * d + 2 * d * cfg.d_ff


def _mamba2_layer_params(cfg: ArchConfig) -> int:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = di // 64
    return d * (2 * di + 2 * n + nh) + di * d  # in_proj(z,x,B,C,dt) + out_proj


def _zamba2_counts(cfg: ArchConfig):
    p = cfg.attn_period or 6
    n_attn_slots = cfg.n_layers // p
    return n_attn_slots, cfg.n_layers - n_attn_slots


_REGISTRY = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-14b": "qwen3_14b",
    "stablelm-3b": "stablelm_3b",
    "rwkv6-7b": "rwkv6_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "musicgen-large": "musicgen_large",
    "chameleon-34b": "chameleon_34b",
    "zamba2-7b": "zamba2_7b",
    # the paper's own workloads (SNN; not LM shapes)
    "spidr-gesture": "spidr_gesture",
    "spidr-optflow": "spidr_optflow",
}


def list_archs(lm_only: bool = True) -> list:
    names = list(_REGISTRY)
    return [n for n in names if not n.startswith("spidr-")] if lm_only else names


def get_config(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}").CONFIG
