"""The model: parameters, forward, and the prefill and decode steps.

The counterpart of ``repro.models.model`` for serving, every family:

  * ``make_prefill_step(cfg)``: full-sequence forward; returns the last
    token's logits and the populated decode cache;
  * ``make_decode_step(cfg)``: one token against the cache.

Each takes ``{"tokens": (B, S) ids}`` or, as the reference does for the
stub frontends of chameleon and musicgen (``embed_inputs=False``),
``{"embeds": (B, S, D)}``.  The train step waits for ROADMAP A12.2.

The reference's ``_compute_params`` is the identity with every flag off,
as serving runs; instead of casting each weight to bfloat16 on every call
as the reference does, :func:`serving_params` makes the casts once (the
same elementwise rounding), so a step reads half the bytes.
:func:`init_serving_params` draws the same numbers as
``serving_params(init_params(...))`` but casts each leaf as soon as it is
drawn, layer by layer: chameleon-34b's float32 masters (137 GB) would not
fit on one 80 GB card, its bfloat16 copy (69 GB) does.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import attention, ffn, mamba2, moe, rwkv6
from .common import dense_init, embed_init, rmsnorm
from .transformer import _map_tree, decode_blocks, forward_blocks, init_blocks

__all__ = ["COMPUTE_DTYPE", "forward", "init_params", "init_serving_params",
           "make_decode_step", "make_prefill_step", "serving_params"]

COMPUTE_DTYPE = torch.bfloat16

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


def _head_logits(params, cfg, h):
    """bfloat16 ``h @ head`` with float32 output (the reference's
    ``preferred_element_type``): the products of bfloat16 values are exact
    in float32 and summed in float32, so the logits are not rounded to
    bfloat16, which would flip greedy argmax on near ties."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    head = head.to(COMPUTE_DTYPE)
    h = h.to(COMPUTE_DTYPE)
    if h.is_cuda and h.dtype != torch.float32:
        lead = h.shape[:-1]
        logits = torch.mm(h.reshape(-1, h.shape[-1]), head,
                          out_dtype=torch.float32).reshape(*lead, -1)
    else:
        logits = torch.matmul(h.to(torch.float32), head.to(torch.float32))
    if cfg.padded_vocab != cfg.vocab_size:  # mask pad columns
        valid = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab_size
        logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    return logits


def _embed(params, tokens):
    return params["embed"][tokens].to(COMPUTE_DTYPE)


def _inputs(params, tokens=None, embeds=None):
    """The first residual stream: the embedding of ``tokens``, or
    ``embeds`` (the stub frontends' precomputed embeddings)."""
    if embeds is None:
        return _embed(params, tokens)
    return embeds.to(COMPUTE_DTYPE)


def forward(params: dict, cfg: ArchConfig, tokens=None, embeds=None,
            return_cache: bool = False, use_kernel: bool | None = None):
    """Returns (logits (B, S, V) float32, aux, cache)."""
    h = _inputs(params, tokens, embeds)
    h, aux, cache = forward_blocks(params["blocks"], h, cfg,
                                   return_cache=return_cache, use_kernel=use_kernel)
    h = rmsnorm(h, params["final_norm"].to(torch.float32), cfg.rmsnorm_eps)
    return _head_logits(params, cfg, h), aux, cache


def make_prefill_step(cfg: ArchConfig, use_kernel: bool | None = None):
    """``prefill_step(params, batch) -> (last-token logits (B, V), cache)``.

    The final norm and the head run on the last position only: each row
    is independent, and the reference keeps only that row.  ``use_kernel``
    picks the ssm family's wkv route (None: the kernel on CUDA tensors).
    """
    def prefill_step(params, batch):
        h = _inputs(params, batch.get("tokens"), batch.get("embeds"))
        h, _, cache = forward_blocks(params["blocks"], h, cfg, return_cache=True,
                                     use_kernel=use_kernel)
        h = rmsnorm(h[:, -1:], params["final_norm"].to(torch.float32),
                    cfg.rmsnorm_eps)
        return _head_logits(params, cfg, h)[:, 0, :], cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, return_aux: bool = False):
    """``decode_step(params, cache, batch) -> (logits (B, V), new_cache)``;
    with ``return_aux`` also the MoE layers' mean ``drop_fraction``."""
    def decode_step(params, cache, batch):
        h = _inputs(params, batch.get("tokens"), batch.get("embeds"))
        h, new_cache, aux = decode_blocks(params["blocks"], h, cache, cfg)
        h = rmsnorm(h, params["final_norm"].to(torch.float32), cfg.rmsnorm_eps)
        logits = _head_logits(params, cfg, h)[:, 0, :]
        return (logits, new_cache, aux) if return_aux else (logits, new_cache)

    return decode_step
