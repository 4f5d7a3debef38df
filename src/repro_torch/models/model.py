"""The model: parameters, forward, and the prefill and decode steps.

The counterpart of ``repro.models.model`` for serving:

  * ``make_prefill_step(cfg)``: full-sequence forward; returns the last
    token's logits and the populated decode cache;
  * ``make_decode_step(cfg)``: one token against the cache.

The train step waits for ROADMAP A12.  The reference's
``_compute_params`` is the identity with every flag off, as serving runs;
instead of casting each weight to bfloat16 on every call as the reference
does, :func:`serving_params` makes the casts once (the same elementwise
rounding), so a decode step reads 15 GB of weights at full width, not 30.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .common import dense_init, embed_init, rmsnorm
from .rwkv6 import FLOAT32_LEAVES, RWKV6Params
from .transformer import decode_blocks, forward_blocks, init_blocks

__all__ = ["COMPUTE_DTYPE", "forward", "init_params", "make_decode_step",
           "make_prefill_step", "serving_params"]

COMPUTE_DTYPE = torch.bfloat16


def init_params(generator: torch.Generator, cfg: ArchConfig) -> dict:
    """float32 parameters (the reference's masters) on the generator's device."""
    params = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model),
        "blocks": init_blocks(generator, cfg),
        "final_norm": torch.ones((cfg.d_model,), device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.padded_vocab))
    return params


def serving_params(params: dict) -> dict:
    """Each leaf cast once to the dtype the forward uses it in.

    bfloat16 for the embedding (gathered, then cast, in the reference), the
    head and every RWKV6 leaf used in ``x.dtype``; float32 for the norms and
    the leaves the reference always takes in float32 (the decay LoRA, the
    base decay and the bonus).
    """
    bf16, f32 = COMPUTE_DTYPE, torch.float32
    blocks = params["blocks"]["layers"]
    rwkv = blocks["rwkv"]
    out = {
        "embed": params["embed"].to(bf16),
        "blocks": {"layers": {
            "ln1": blocks["ln1"].to(f32), "ln2": blocks["ln2"].to(f32),
            "rwkv": RWKV6Params(**{
                name: t.to(f32 if name in FLOAT32_LEAVES else bf16)
                for name, t in rwkv._asdict().items()})}},
        "final_norm": params["final_norm"].to(f32),
    }
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"].to(bf16)
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


def forward(params: dict, cfg: ArchConfig, tokens, return_cache: bool = False,
            use_kernel: bool | None = None):
    """Returns (logits (B, S, V) float32, aux, cache)."""
    h = _embed(params, tokens)
    h, aux, cache = forward_blocks(params["blocks"], h, cfg,
                                   return_cache=return_cache, use_kernel=use_kernel)
    h = rmsnorm(h, params["final_norm"].to(torch.float32), cfg.rmsnorm_eps)
    return _head_logits(params, cfg, h), aux, cache


def make_prefill_step(cfg: ArchConfig, use_kernel: bool | None = None):
    """``prefill_step(params, batch) -> (last-token logits (B, V), cache)``.

    The final norm and the head run on the last position only: each row
    is independent, and the reference keeps only that row.  ``use_kernel``
    picks the wkv route (None: the kernel on CUDA tensors).
    """
    def prefill_step(params, batch):
        h = _embed(params, batch["tokens"])
        h, _, cache = forward_blocks(params["blocks"], h, cfg, return_cache=True,
                                     use_kernel=use_kernel)
        h = rmsnorm(h[:, -1:], params["final_norm"].to(torch.float32),
                    cfg.rmsnorm_eps)
        return _head_logits(params, cfg, h)[:, 0, :], cache

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``decode_step(params, cache, batch) -> (logits (B, V), new_cache)``."""
    def decode_step(params, cache, batch):
        h = _embed(params, batch["tokens"])
        h, new_cache = decode_blocks(params["blocks"], h, cache, cfg)
        h = rmsnorm(h, params["final_norm"].to(torch.float32), cfg.rmsnorm_eps)
        return _head_logits(params, cfg, h)[:, 0, :], new_cache

    return decode_step
