"""Shared model components: the RMS norm and the initializers.

RoPE and the loss wait for the attention families and the LM train step
(ROADMAP A12).  The initializers draw from a ``torch.Generator`` and make their
tensors on its device, so the numbers differ from ``jax.random``'s; parity
tests carry the reference's own parameters across with
``repro_torch.convert.lm_params_from_jax``.
"""
from __future__ import annotations

import torch

__all__ = ["dense_init", "embed_init", "rmsnorm"]


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last axis, computed in float32, returned in ``x``'s dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * weight).to(dtype)


def dense_init(generator: torch.Generator, shape) -> torch.Tensor:
    """Normal float32 ``(..., fan_in, fan_out)`` weights with std
    ``1/sqrt(fan_in)``; leading axes stack layers."""
    std = 1.0 / shape[-2] ** 0.5
    return torch.randn(shape, generator=generator, device=generator.device) * std


def embed_init(generator: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return torch.randn((vocab, d), generator=generator, device=generator.device) * 0.02
