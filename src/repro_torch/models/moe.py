"""Mixture-of-Experts with top-k token-choice routing (granite, moonshot).

The counterpart of the single-device path of ``repro.models.moe``; the
reference's ``shard_map`` paths (expert- and token-parallel over a mesh)
wait for ROADMAP A12.3.  Per layer, on the flattened tokens (T, D):

  * the router in float32: softmax over all E experts, the top k by a
    stable descending sort (``jax.lax.top_k`` puts the lower index first
    on a tie; ``torch.topk`` promises no order), weights renormalised over
    the chosen k;
  * capacity ``int(max(1, round(T * k / E * 1.25)))`` slots per expert
    (Python's ``round``); token-major priority: choice j of token t takes
    the next free slot of its expert, counted over (t, j) in order, and a
    choice past the capacity is dropped (the reference's scatter
    ``mode="drop"``; here a discard row past the buffer);
  * every expert runs on its ``capacity`` slots (a bmm over experts; empty
    slots are zeros), the outputs gathered back (a dropped choice gives
    0) and summed per token in ``x``'s dtype, one choice after another;
  * aux: the load-balance loss, the router z-loss and the drop fraction.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import dense_init

__all__ = ["MoEParams", "init_moe", "moe_forward"]

#: The leaves used in float32 whatever ``x.dtype``.
FLOAT32_LEAVES = ("w_router",)


class MoEParams(NamedTuple):
    w_router: torch.Tensor  # (D, E)
    w_gate: torch.Tensor    # (E, D, F)
    w_up: torch.Tensor      # (E, D, F)
    w_down: torch.Tensor    # (E, F, D)


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int) -> MoEParams:
    dev = generator.device

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=dev) * std

    return MoEParams(
        w_router=dense_init(generator, (d_model, n_experts)),
        w_gate=normal((n_experts, d_model, d_ff), 1.0 / d_model ** 0.5),
        w_up=normal((n_experts, d_model, d_ff), 1.0 / d_model ** 0.5),
        w_down=normal((n_experts, d_ff, d_model), 1.0 / d_ff ** 0.5),
    )


def capacity(t: int, top_k: int, n_experts: int, capacity_factor: float = 1.25) -> int:
    """Slots per expert for ``t`` tokens (the reference's expression)."""
    return int(max(1, round(t * top_k / n_experts * capacity_factor)))


def _local_moe(x, w_router, w_gate, w_up, w_down, top_k: int,
               capacity_factor: float):
    """MoE on tokens x (T, D). Returns (out, lb_loss, z_loss, drop, keep)."""
    t, d = x.shape
    e = w_gate.shape[0]
    f32 = torch.float32

    logits = x.to(f32) @ w_router.to(f32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = top_w[:, :top_k], top_ids[:, :top_k]            # (T, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)

    cap = capacity(t, top_k, e, capacity_factor)
    flat_ids = top_ids.reshape(-1)                                   # (T*k,)
    onehot = F.one_hot(flat_ids, e)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)   # (T*k,)
    keep = pos < cap
    slot = torch.where(keep, flat_ids * cap + pos, torch.full_like(pos, e * cap))

    token_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
    buf = x.new_zeros((e * cap + 1, d))        # the last row takes the drops
    buf[slot] = x[token_idx]
    buf = buf[:e * cap].reshape(e, cap, d)

    dt = x.dtype
    h = F.silu(torch.bmm(buf, w_gate.to(dt))) * torch.bmm(buf, w_up.to(dt))
    out_buf = torch.bmm(h, w_down.to(dt)).reshape(-1, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])
    gathered = out_buf[slot]                                         # (T*k, D)
    w = (top_w.reshape(-1) * keep).to(dt)
    terms = (gathered * w[:, None]).reshape(t, top_k, d)
    out = terms[:, 0]
    for j in range(1, top_k):
        out = out + terms[:, j]

    frac = F.one_hot(top_ids, e).to(f32).mean(dim=(0, 1))
    lb_loss = e * (frac * probs.mean(dim=0)).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    drop = 1.0 - keep.to(f32).mean()
    return out, lb_loss, z_loss, drop, keep


def moe_forward(p: MoEParams, x, top_k: int, capacity_factor: float = 1.25):
    """x: (B, S, D). Returns (out, aux)."""
    b, s, d = x.shape
    out, lb, zl, drop, _ = _local_moe(x.reshape(-1, d), p.w_router, p.w_gate,
                                      p.w_up, p.w_down, top_k, capacity_factor)
    return out.reshape(b, s, d), {"load_balance_loss": lb, "router_z_loss": zl,
                                  "drop_fraction": drop}
