"""The model: parameters, forward, and the train, prefill and decode steps.

The counterpart of ``repro.models.model``, every family:

  * ``make_train_step(cfg)``: forward + next-token CE (+ the MoE aux
    losses) + backward + global-norm clip + AdamW, in place;
  * ``make_prefill_step(cfg)``: full-sequence forward; returns the last
    token's logits and the populated decode cache;
  * ``make_decode_step(cfg)``: one token against the cache.

Each takes ``{"tokens": (B, S) ids}`` or, as the reference does for the
stub frontends of chameleon and musicgen (``embed_inputs=False``),
``{"embeds": (B, S, D)}``; the train step also ``{"labels": (B, S)}``.

:func:`_compute_params` is the reference's mixed-precision lever: under
the ``bf16_params`` flag (``repro_torch.flags``, set by the dry run's
variants) every float32 leaf of rank >= 2 is cast to a bfloat16 compute
copy at the start of a step, so sharded weights are gathered in bfloat16
and their gradients come back through the cast to the float32 masters;
with the flag off, as serving and training run, it is the identity.
Instead of casting each weight to bfloat16 on every call as the
reference does, :func:`serving_params` makes the casts once (the same
elementwise rounding), so a step reads half the bytes.
:func:`init_serving_params` draws the same numbers as
``serving_params(init_params(...))`` but casts each leaf as soon as it is
drawn, layer by layer: chameleon-34b's float32 masters (137 GB) would not
fit on one 80 GB card, its bfloat16 copy (69 GB) does.

The dry run (``launch/dryrun.py``) builds a cell's trees with no data:
:func:`abstract_params`, :func:`abstract_opt_state` and
:func:`abstract_decode_cache` give meta tensors of the reference's shapes
and dtypes.  The activations are pinned at the reference's three sites
(``sharding.constrain``, the identity unless a mesh is armed).
"""
from __future__ import annotations

import torch

from .. import flags, sharding
from ..checkpoint.checkpoint import tree_flatten, tree_unflatten
from ..configs.base import ArchConfig
from ..optim import optimizer
from ..sharding import constrain
from . import attention, ffn, mamba2, moe, rwkv6
from .common import cross_entropy_loss, dense_init, embed_init, rmsnorm
from .transformer import (
    _map_tree,
    decode_blocks,
    forward_blocks,
    init_blocks,
    init_decode_state,
)

__all__ = ["COMPUTE_DTYPE", "MOE_AUX_WEIGHT", "MOE_Z_WEIGHT", "abstract_decode_cache",
           "abstract_opt_state", "abstract_params", "forward",
           "init_opt_state", "init_params", "init_serving_params", "loss_and_grads",
           "make_decode_step",
           "make_prefill_step", "make_train_step", "serving_params"]

COMPUTE_DTYPE = torch.bfloat16
MOE_AUX_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-3

# Per parameter group, the leaves the reference uses in float32 whatever
# the compute dtype; every other group leaf is used in the compute dtype.
_FLOAT32_LEAVES = {
    attention.AttentionParams: attention.FLOAT32_LEAVES,
    ffn.FFNParams: ffn.FLOAT32_LEAVES,
    moe.MoEParams: moe.FLOAT32_LEAVES,
    mamba2.Mamba2Params: mamba2.FLOAT32_LEAVES,
    rwkv6.RWKV6Params: rwkv6.FLOAT32_LEAVES,
}


def _serving_cast(group, field, t):
    """A block leaf as served: float32 for the norms (a dict's leaves) and
    each group's float32 leaves, bfloat16 for the rest."""
    if group is None or field in _FLOAT32_LEAVES[group]:
        return t.to(torch.float32)
    return t.to(COMPUTE_DTYPE)


def _init(generator, cfg, cast=None, head_cast=None) -> dict:
    head_cast = head_cast or (lambda t: t)
    params = {
        "embed": head_cast(embed_init(generator, cfg.padded_vocab, cfg.d_model)),
        "blocks": init_blocks(generator, cfg, cast),
        "final_norm": torch.ones((cfg.d_model,), device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = head_cast(dense_init(generator, (cfg.d_model, cfg.padded_vocab)))
    return params


def init_params(generator: torch.Generator, cfg: ArchConfig) -> dict:
    """float32 parameters (the reference's masters) on the generator's device."""
    return _init(generator, cfg)


def init_serving_params(generator: torch.Generator, cfg: ArchConfig) -> dict:
    """``serving_params(init_params(generator, cfg))`` without the float32
    masters: each leaf is cast as soon as it is drawn (layer by layer for
    the attention, MoE and hybrid families), so the card holds one layer's
    float32 draws at a time beside the serving copy."""
    return _init(generator, cfg, cast=_serving_cast,
                 head_cast=lambda t: t.to(COMPUTE_DTYPE))


def _meta(t):
    return None if t is None else torch.empty(t.shape, dtype=t.dtype, device="meta")


def abstract_params(cfg: ArchConfig) -> dict:
    """The tree of :func:`init_params` as meta tensors (shapes and dtypes,
    no data): the draws run under a ``FakeTensorMode``, so nothing of the
    model's size is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = init_params(torch.Generator(), cfg)
    return _map_tree(lambda g, f, t: _meta(t), params)


def abstract_opt_state(params_abstract: dict) -> dict:
    """AdamW's ``{"mu", "nu"}`` for ``params_abstract``, as meta tensors."""
    return {"mu": _map_tree(lambda g, f, t: _meta(t), params_abstract),
            "nu": _map_tree(lambda g, f, t: _meta(t), params_abstract)}


def abstract_decode_cache(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """The decode cache of ``batch`` slots and ``seq_len`` rows, as meta tensors."""
    return init_decode_state(cfg, batch, seq_len, device="meta")


def _compute_params(params):
    """Mixed precision: bfloat16 compute copies of the float32 masters
    (every float32 leaf of rank >= 2) under the ``bf16_params`` flag, the
    identity without it.

    The cast is elementwise on the sharded leaves, so every FSDP
    all-gather downstream moves bfloat16 and the parameter cotangents
    come back through it as float32 for the optimizer.  The masters and
    the optimizer state stay float32.
    """
    if not flags.flag("bf16_params"):
        return params

    def cast(g, f, p):
        if p is None or p.dtype != torch.float32 or p.dim() < 2:
            return p
        return p.to(torch.bfloat16)

    return _map_tree(cast, params)


def serving_params(params: dict) -> dict:
    """Each leaf cast once to the dtype the forward uses it in.

    bfloat16 for the embedding (gathered, then cast, in the reference), the
    head and every block leaf used in ``x.dtype`` (projections, biases,
    experts, the conv); float32 for the norms and the leaves the reference
    always takes in float32 (``q_norm``/``k_norm``, the MoE router,
    Mamba2's ``a_log``, ``dt_bias``, ``d_skip`` and ``norm_w``, RWKV6's
    decay LoRA, base decay and bonus).
    """
    out = {
        "embed": params["embed"].to(COMPUTE_DTYPE),
        "blocks": _map_tree(_serving_cast, params["blocks"]),
        "final_norm": params["final_norm"].to(torch.float32),
    }
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"].to(COMPUTE_DTYPE)
    return out


class _HeadMatmul(torch.autograd.Function):
    """``h (M, D) @ head (D, V)`` of bfloat16 operands into float32
    (``torch.mm``'s ``out_dtype``, which has no derivative of its own).

    Backward: the float32 cotangent is rounded to the operands' bfloat16,
    as the TPU's matrix unit takes a float32 operand at default precision,
    and both products again sum in float32 before their result is rounded
    to the operand's dtype.
    """

    @staticmethod
    def forward(ctx, h, head):
        ctx.save_for_backward(h, head)
        return torch.mm(h, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, head = ctx.saved_tensors
        g = g.to(h.dtype)
        dh = dhead = None
        if ctx.needs_input_grad[0]:
            dh = torch.mm(g, head.T, out_dtype=torch.float32).to(h.dtype)
        if ctx.needs_input_grad[1]:
            dhead = torch.mm(h.T, g, out_dtype=torch.float32).to(head.dtype)
        return dh, dhead


def _logits(h, head):
    """bfloat16 ``h @ head`` with float32 output."""
    if h.is_cuda and h.dtype != torch.float32:
        lead = h.shape[:-1]
        return _HeadMatmul.apply(h.reshape(-1, h.shape[-1]), head).reshape(*lead, -1)
    return torch.matmul(h.to(torch.float32), head.to(torch.float32))


def _head_logits(params, cfg, h):
    """bfloat16 ``h @ head`` with float32 output (the reference's
    ``preferred_element_type``): the products of bfloat16 values are exact
    in float32 and summed in float32, so the logits are not rounded to
    bfloat16, which would flip greedy argmax on near ties.  While a mesh is
    armed the product runs on each rank's block (``sharding.local_call``:
    DTensor has no rule for a matrix product with a float32 output)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    head = sharding.gather_params(head).to(COMPUTE_DTYPE)
    h = h.to(COMPUTE_DTYPE)
    specs = ()
    if sharding.armed():
        hs = sharding.resolve(h.shape, "dp", None, None)
        ws = sharding.resolve(head.shape, None, "model")
        specs = ((hs, ws), (hs[:-1] + ws[-1:],))
    logits = sharding.local_call(_logits, (h, head), *specs)
    if cfg.padded_vocab != cfg.vocab_size:  # mask pad columns
        valid = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab_size
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    return logits


def _embed(params, tokens):
    """The rows of the embedding for ``tokens``.  While a mesh is armed the
    table is gathered whole and each rank looks its own tokens up
    (``sharding.local_call``): DTensor's rules neither look rows up in a
    vocabulary-sharded table for both the forward and the backward, nor
    (in torch 2.11) index with ids sharded over two mesh axes."""
    table = params["embed"]
    if sharding.armed():  # each rank looks its tokens up in the whole table
        ts = sharding.spec_of(tokens)
        return sharding.local_call(lambda t, tok: t[tok].to(COMPUTE_DTYPE),
                                   (table, tokens), ((None, None), ts), (ts + (None,),))
    return table[tokens].to(COMPUTE_DTYPE)


def _inputs(params, tokens=None, embeds=None):
    """The first residual stream: the embedding of ``tokens``, or
    ``embeds`` (the stub frontends' precomputed embeddings)."""
    if embeds is None:
        return _embed(params, tokens)
    return embeds.to(COMPUTE_DTYPE)


def forward(params: dict, cfg: ArchConfig, tokens=None, embeds=None,
            return_cache: bool = False, use_kernel: bool | None = None,
            remat: bool = False):
    """Returns (logits (B, S, V) float32, aux, cache)."""
    # The embedding gather loses the batch sharding: re-pin it.
    h = constrain(_inputs(params, tokens, embeds), "dp", None, None)
    h, aux, cache = forward_blocks(params["blocks"], h, cfg, return_cache=return_cache,
                                   use_kernel=use_kernel, remat=remat)
    h = constrain(h, "dp", None, None)  # the sequence whole again (SP)
    h = rmsnorm(h, params["final_norm"].to(torch.float32), cfg.rmsnorm_eps)
    return constrain(_head_logits(params, cfg, h), "dp", None, "model"), aux, cache


def make_prefill_step(cfg: ArchConfig, use_kernel: bool | None = None):
    """``prefill_step(params, batch) -> (last-token logits (B, V), cache)``.

    The final norm and the head run on the last position only: each row
    is independent, and the reference keeps only that row.  ``use_kernel``
    picks the ssm family's wkv route (None: the kernel on CUDA tensors).
    """
    def prefill_step(params, batch):
        params = _compute_params(params)
        h = constrain(_inputs(params, batch.get("tokens"), batch.get("embeds")),
                      "dp", None, None)
        h, _, cache = forward_blocks(params["blocks"], h, cfg, return_cache=True,
                                     use_kernel=use_kernel)
        h = constrain(h, "dp", None, None)  # the sequence whole again (SP)
        h = rmsnorm(h[:, -1:], params["final_norm"].to(torch.float32),
                    cfg.rmsnorm_eps)
        logits = constrain(_head_logits(params, cfg, h), "dp", None, "model")
        return logits[:, 0, :], cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, return_aux: bool = False):
    """``decode_step(params, cache, batch) -> (logits (B, V), new_cache)``;
    with ``return_aux`` also the MoE layers' mean ``drop_fraction``."""
    def decode_step(params, cache, batch):
        params = _compute_params(params)
        h = constrain(_inputs(params, batch.get("tokens"), batch.get("embeds")),
                      "dp", None, None)
        h, new_cache, aux = decode_blocks(params["blocks"], h, cache, cfg)
        h = rmsnorm(h, params["final_norm"].to(torch.float32), cfg.rmsnorm_eps)
        logits = _head_logits(params, cfg, h)[:, 0, :]
        return (logits, new_cache, aux) if return_aux else (logits, new_cache)

    return decode_step


# ---------------------------------------------------------------------------
# Train step (fwd + bwd + AdamW, grad-clipped)
# ---------------------------------------------------------------------------
def init_opt_state(params: dict) -> dict:
    """AdamW's zero moments ``{"mu", "nu"}``, each with the tree of ``params``."""
    def zeros(g, f, t):
        return torch.zeros_like(t)

    return {"mu": _map_tree(zeros, params), "nu": _map_tree(zeros, params)}


def _loss(cfg, params, batch, remat, use_kernel):
    """(total loss, {"ce_loss", aux...}) of one batch, as the reference's
    ``loss_fn``."""
    params = _compute_params(params)
    logits, aux, _ = forward(params, cfg, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), remat=remat,
                             use_kernel=use_kernel)
    # next-token prediction: shift by one
    loss = cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:])
    total = loss
    if aux:
        total = (total + MOE_AUX_WEIGHT * aux.get("load_balance_loss", 0.0)
                 + MOE_Z_WEIGHT * aux.get("router_z_loss", 0.0))
    return total, {"ce_loss": loss, **aux}


def _grads(cfg, params, leaves, batch, remat, use_kernel):
    """(total loss, metrics, float32 gradients aligned with ``leaves``, the
    params' leaves in ``tree_flatten``'s order; None where a leaf is None).
    A leaf the loss does not reach gets zeros, as ``jax.grad`` gives."""
    live = [None if t is None else t.detach().requires_grad_() for t in leaves]
    with torch.enable_grad():
        total, metrics = _loss(cfg, tree_unflatten(params, live), batch, remat,
                               use_kernel)
        got = iter(torch.autograd.grad(total, [t for t in live if t is not None],
                                       allow_unused=True))
    grads = []
    for t in live:
        g = None if t is None else next(got)
        grads.append(torch.zeros_like(t) if t is not None and g is None else g)
    return total.detach(), {k: _metric(v, total) for k, v in metrics.items()}, grads


def _metric(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device).detach()


def loss_and_grads(cfg: ArchConfig, params: dict, batch: dict, remat: bool = True,
                   use_kernel: bool | None = None):
    """``(total loss, metrics, grads)`` of one batch: the train step's loss
    and float32 gradients (a tree like ``params``) before the clip."""
    loss, metrics, grads = _grads(cfg, params, tree_flatten(params), batch, remat,
                                  use_kernel)
    return loss, metrics, tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, lr: float = 3e-4, grad_clip: float = 1.0,
                    weight_decay: float = 0.1, remat: bool = True,
                    accum_steps: int = 1):
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    metrics)``, term by term the reference's.

    The forward runs in ``COMPUTE_DTYPE`` over the float32 masters (through
    :func:`_compute_params`, the identity unless ``bf16_params`` is set);
    the loss is ``cross_entropy_loss(logits[:, :-1], labels[:, 1:])`` plus,
    for the attention families, ``MOE_AUX_WEIGHT`` x the load-balance
    loss and ``MOE_Z_WEIGHT`` x the router z-loss (both 0 for dense
    models).  Gradients are float32 (:func:`loss_and_grads`);
    ``accum_steps > 1`` splits the leading batch axis into microbatches
    and averages their summed gradients.  Then ``clip_by_global_norm`` and
    AdamW, both written into ``params`` and ``opt_state`` in place
    (``optimizer.adamw_inplace``), leaf by leaf in the checkpoint's order:
    the returned trees are the ones passed in, and the step holds no
    second copy of them.  ``step`` is a host int.

    Metrics (0-d float32 tensors): ``loss``, ``grad_norm`` (before the
    clip), ``ce_loss`` and, for the attention families,
    ``load_balance_loss`` and ``router_z_loss``; with ``accum_steps > 1``
    ``loss``, ``grad_norm`` and ``ce_loss`` (the mean total loss), as in
    the reference.  rwkv6's wkv runs on B7 for CUDA tensors, under
    autograd.
    """
    def train_step(params, opt_state, step, batch):
        leaves = tree_flatten(params)
        if accum_steps == 1:
            loss, metrics, grads = _grads(cfg, params, leaves, batch, remat, None)
        else:
            mb = batch["labels"].shape[0] // accum_steps
            grads, loss = None, 0.0
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, _, g = _grads(cfg, params, leaves, micro, remat, None)
                grads = g if grads is None else [
                    None if a is None else a.add_(b) for a, b in zip(grads, g)]
                loss = loss + l
                del g
            for g in grads:
                if g is not None:
                    g.div_(accum_steps)
            loss = loss / accum_steps
            metrics = {"ce_loss": loss}
        gnorm = optimizer.global_norm(grads)
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        for g in grads:
            if g is not None:
                g.mul_(scale)
        optimizer.adamw_inplace(leaves, grads, tree_flatten(opt_state["mu"]),
                                tree_flatten(opt_state["nu"]), step, lr,
                                weight_decay=weight_decay)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return train_step
