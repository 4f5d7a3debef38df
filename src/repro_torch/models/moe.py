"""Mixture-of-Experts with top-k token-choice routing (granite, moonshot).

The counterpart of ``repro.models.moe``.  Per layer, on the flattened
tokens (T, D):

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

While a mesh is armed (the dry run), the layer runs on each rank's local
token block (``torch.distributed.tensor.experimental.local_map``, the
reference's ``shard_map``), so capacity is per local block, as in the
reference, and a sharded result differs from the single-device one:

  * EP path (the expert count divisible by the 'model' axis, moonshot's
    64 on 16): tokens sharded over the data axes and replicated over
    'model'; rank ``m`` of 'model' holds experts ``[m * e_loc, (m + 1) *
    e_loc)`` and computes them for its tokens against the router's scores
    over all E; its output is a partial sum, one sum all-reduce over
    'model' away from the layer's (DTensor's ``Partial``).
  * Replicated-experts path (granite's 40 on 16, or dp_only): the expert
    weights are gathered whole and the tokens split over 'model' along
    the sequence when it divides; no combine collective.

The three aux scalars are means over every rank: each rank's value over
the mesh size, summed (``Partial``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import flags, sharding
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
               capacity_factor: float, e0: int = 0):
    """MoE on tokens x (T, D), the experts ``[e0, e0 + e_loc)`` of the
    router's E held in ``w_gate``/``w_up``/``w_down``.  Returns (out,
    lb_loss, z_loss, drop, keep)."""
    t, d = x.shape
    e = w_router.shape[1]
    e_loc = w_gate.shape[0]
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
    local_ids = flat_ids - e0
    in_slice = (local_ids >= 0) & (local_ids < e_loc)
    keep = (pos < cap) & in_slice
    slot = torch.where(keep, local_ids * cap + pos, torch.full_like(pos, e_loc * cap))

    token_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
    buf = x.new_zeros((e_loc * cap + 1, d))    # the last row takes the drops
    buf[slot] = x[token_idx]
    buf = buf[:e_loc * cap].reshape(e_loc, cap, d)

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
    drop = 1.0 - (pos < cap).to(f32).mean()
    return out, lb_loss, z_loss, drop, keep


def moe_forward(p: MoEParams, x, top_k: int, capacity_factor: float = 1.25):
    """x: (B, S, D). Returns (out, aux)."""
    b, s, d = x.shape
    if sharding.armed():
        return _moe_sharded(p, x, top_k, capacity_factor)
    out, lb, zl, drop, _ = _local_moe(x.reshape(-1, d), p.w_router, p.w_gate,
                                      p.w_up, p.w_down, top_k, capacity_factor)
    return out.reshape(b, s, d), {"load_balance_loss": lb, "router_z_loss": zl,
                                  "drop_fraction": drop}


def _moe_sharded(p: MoEParams, x, top_k: int, capacity_factor: float):
    """The reference's ``shard_map`` paths over the armed mesh (module
    docstring): one ``local_map`` per path (``sharding.map_local``)."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = sharding.armed_mesh()
    b, s, d = x.shape
    e = p.w_router.shape[1]
    sizes = sharding.axis_sizes(mesh)
    dp = sharding.data_axes()
    # dp_only folds the model axis into data parallelism: inside this layer
    # there is no separate model axis to use for EP or token splitting.
    model_size = 1 if flags.flag("dp_only") else sizes["model"]
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    b_spec = dp if (dp and b % n_dp == 0) else None
    n_ranks = mesh.size()
    ep = model_size > 1 and e % model_size == 0

    def aux(lb, zl, drop):  # each rank's share of the mean over every rank
        return lb / n_ranks, zl / n_ranks, drop / n_ranks

    if ep:
        def fn(xl, wr, wg, wu, wd):
            e0 = mesh.get_local_rank("model") * wg.shape[0]
            out, lb, zl, drop, _ = _local_moe(xl.reshape(-1, d), wr, wg, wu, wd,
                                              top_k, capacity_factor, e0)
            return (out.reshape(xl.shape), *aux(lb, zl, drop))

        x_spec = (b_spec, None, None)
        w_spec = ("model", None, None)
        out_pl = list(sharding.placements(x_spec, mesh))
        out_pl[mesh.mesh_dim_names.index("model")] = Partial()
    else:
        s_spec = "model" if (model_size > 1 and s % model_size == 0) else None

        def fn(xl, wr, wg, wu, wd):
            out, lb, zl, drop, _ = _local_moe(xl.reshape(-1, d), wr, wg, wu, wd,
                                              top_k, capacity_factor)
            return (out.reshape(xl.shape), *aux(lb, zl, drop))

        x_spec = (b_spec, s_spec, None)
        w_spec = (None, None, None)
        out_pl = list(sharding.placements(x_spec, mesh))
    scalar = (Partial(),) * mesh.ndim
    rep = (Replicate(),) * mesh.ndim
    w_pl = sharding.placements(w_spec, mesh)
    out, lb, zl, drop = sharding.map_local(
        fn, (x, p.w_router, p.w_gate, p.w_up, p.w_down),
        (sharding.placements(x_spec, mesh), rep, w_pl, w_pl, w_pl),
        (tuple(out_pl), scalar, scalar, scalar))
    return out, {"load_balance_loss": lb, "router_z_loss": zl, "drop_fraction": drop}
