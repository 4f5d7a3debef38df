"""Architecture configuration and registry of the LM stack.

The counterpart of ``repro.configs.base``: ``ArchConfig`` (the published
numbers of one architecture), ``reduced()`` (the same family at CPU size)
and ``get_config``.  The registry names every architecture the reference
knows; only ``rwkv6-7b`` (the ``ssm`` family) and the paper's two SNN
configurations are ported, and any other name raises
``NotImplementedError`` naming ROADMAP A12.  The dry-run material
(``ShapeSpec``, ``SHAPES``, ``input_specs``) is not ported.
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

    # MoE
    n_experts: int = 0
    top_k: int = 0

    # SSM / RWKV / hybrid
    ssm_state: int = 0
    attn_period: int = 0

    sub_quadratic: bool = False
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


# Every architecture of the reference; None marks one not ported yet.
_REGISTRY = {
    "qwen1.5-0.5b": None,
    "starcoder2-3b": None,
    "qwen3-14b": None,
    "stablelm-3b": None,
    "rwkv6-7b": "rwkv6_7b",
    "granite-moe-3b-a800m": None,
    "moonshot-v1-16b-a3b": None,
    "musicgen-large": None,
    "chameleon-34b": None,
    "zamba2-7b": None,
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
    module = _REGISTRY[name]
    if module is None:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet — see ROADMAP.md "
            "A12 (LM stack); the ported LM is 'rwkv6-7b'")
    return importlib.import_module(f"repro_torch.configs.{module}").CONFIG
