"""Shared model components: the RMS norm, RoPE, the initializers and the
next-token loss.

The initializers draw from a ``torch.Generator`` and make their tensors on
its device, so the numbers differ from ``jax.random``'s; parity tests carry
the reference's own parameters across with
``repro_torch.convert.lm_params_from_jax``.
"""
from __future__ import annotations

import torch

__all__ = ["apply_rope", "cross_entropy_loss", "dense_init", "embed_init",
           "rmsnorm", "rope_freqs"]


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last axis, computed in float32, returned in ``x``'s dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * weight).to(dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Made on ``device``: a host tensor copied to the card would be a
    pageable copy, which waits for the device on every call."""
    pos = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (pos / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integers.

    Rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` (not the
    rotate-half layout), with float32 angles; returns ``x``'s dtype.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE; logits (B, S, V), labels (B, S) integers."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return nll.mean()


def dense_init(generator: torch.Generator, shape) -> torch.Tensor:
    """Normal float32 ``(..., fan_in, fan_out)`` weights with std
    ``1/sqrt(fan_in)``; leading axes stack layers."""
    std = 1.0 / shape[-2] ** 0.5
    return torch.randn(shape, generator=generator, device=generator.device) * std


def embed_init(generator: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return torch.randn((vocab, d), generator=generator, device=generator.device) * 0.02
