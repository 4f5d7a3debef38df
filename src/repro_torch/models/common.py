"""Shared model components: the RMS norm, RoPE, the initializers and the
next-token loss.

The initializers draw from a ``torch.Generator`` and make their tensors on
its device, so the numbers differ from ``jax.random``'s; parity tests carry
the reference's own parameters across with
``repro_torch.convert.lm_params_from_jax``.
"""
from __future__ import annotations

import torch

from .. import sharding

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
    """Mean next-token CE; logits (B, S, V), labels (B, S) integers.

    While a mesh is armed (the dry run) it runs on each rank's block of
    the logits (:func:`_cross_entropy_sharded`): DTensor's rules for the
    gather below give a replicated gradient of the global logits' size,
    and ``loss_parallel`` covers a backward only inside its context.
    """
    if sharding.armed():
        return _cross_entropy_sharded(logits, labels)
    return _cross_entropy(logits, labels)


def _cross_entropy(logits, labels):
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return nll.mean()


class _SumReplicated(torch.autograd.Function):
    """An all-reduce sum over a mesh axis whose result every rank then uses
    the same way: the gradient passes through unchanged (Megatron's reduce
    from a tensor-parallel region)."""

    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _cross_entropy_sharded(logits, labels):
    """The mean CE over an armed mesh, on each rank's block of the logits
    (``sharding.map_local``): the mean of its tokens over the number of
    token blocks, summed over the ranks (``Partial``).  With the
    vocabulary sharded, the max, the sum of exponentials and the label's
    logit are reduced over its shards (Megatron's vocabulary-parallel
    cross entropy)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard

    logits = sharding.as_dtensor(logits)
    mesh = logits.device_mesh
    logits = logits.redistribute(mesh, [  # pending sums done
        Replicate() if isinstance(p, Partial) else p for p in logits.placements])
    spec = sharding.spec_of(logits)
    last = logits.dim() - 1
    groups = [(mesh, i) for i, p in enumerate(logits.placements)
              if isinstance(p, Shard) and p.dim == last]
    v_axes = [mesh.mesh_dim_names[i] for _, i in groups]
    blocks = 1
    for n, p in zip(mesh.shape, logits.placements):
        blocks *= n if isinstance(p, Shard) and p.dim != last else 1

    def local(lg, lb):
        if not groups:
            return _cross_entropy(lg, lb) / blocks
        lg = lg.to(torch.float32)
        v_loc = lg.shape[-1]
        off = sharding.axes_index(v_axes) * v_loc
        m = lg.detach().amax(dim=-1, keepdim=True)
        for g in groups:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", g))
        s = torch.exp(lg - m).sum(dim=-1)
        lb = lb.long()
        mine = (lb >= off) & (lb < off + v_loc)
        t = torch.gather(lg, -1, (lb - off).clamp(0, v_loc - 1)[..., None])[..., 0]
        t = t * mine
        for g in groups:
            s, t = _SumReplicated.apply(s, g), _SumReplicated.apply(t, g)
        return (torch.log(s) + m[..., 0] - t).mean() / blocks

    out = tuple(Partial() if isinstance(p, Shard) and p.dim != last else Replicate()
                for p in logits.placements)
    return sharding.map_local(local, (logits, labels),
                              (logits.placements, sharding.placements(spec[:-1], mesh)),
                              (out,))


def dense_init(generator: torch.Generator, shape) -> torch.Tensor:
    """Normal float32 ``(..., fan_in, fan_out)`` weights with std
    ``1/sqrt(fan_in)``; leading axes stack layers."""
    std = 1.0 / shape[-2] ** 0.5
    return torch.randn(shape, generator=generator, device=generator.device) * std


def embed_init(generator: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return torch.randn((vocab, d), generator=generator, device=generator.device) * 0.02
