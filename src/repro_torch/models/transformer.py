"""The layer stack of the ``ssm`` family (RWKV6): init, prefill, decode.

The counterpart of the ``ssm`` branches of ``repro.models.transformer``.
Parameters keep the reference's layer-stacked layout, ``(L, ...)`` per
leaf; where the reference scans over layers, this module loops over them
in Python, indexing each leaf (a view).  The sharding constraints and
remat names of the reference are no-ops on one device and are left out.
Every other family raises ``NotImplementedError`` naming ROADMAP A12.
"""
from __future__ import annotations

import torch

from .common import rmsnorm
from .rwkv6 import (
    HEAD_SIZE,
    RWKV6Params,
    init_rwkv6_layer,
    rwkv6_channel_mix,
    rwkv6_channel_mix_decode,
    rwkv6_time_mix,
    rwkv6_time_mix_decode,
)

__all__ = ["decode_blocks", "forward_blocks", "init_blocks", "init_decode_state",
           "layer"]


def _only_ssm(cfg) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch "
            "yet — see ROADMAP.md A12 (LM stack); the ported family is 'ssm' "
            "(rwkv6-7b)")


def init_blocks(generator: torch.Generator, cfg) -> dict:
    _only_ssm(cfg)
    ones = torch.ones((cfg.n_layers, cfg.d_model), device=generator.device)
    return {"layers": {"ln1": ones, "ln2": ones.clone(),
                       "rwkv": init_rwkv6_layer(generator, cfg, cfg.n_layers)}}


def layer(blocks: dict, i: int) -> dict:
    """Layer ``i`` of the stacked parameters (views, no copies)."""
    stacked = blocks["layers"]
    return {"ln1": stacked["ln1"][i], "ln2": stacked["ln2"][i],
            "rwkv": RWKV6Params(*(t[i] for t in stacked["rwkv"]))}


def _rwkv_block(lp, h, state, cfg, use_kernel=None):
    x_tm, x_cm, s0 = state
    tm_in = rmsnorm(h, lp["ln1"].to(torch.float32), cfg.rmsnorm_eps)
    y, x_tm_new, s_f = rwkv6_time_mix(lp["rwkv"], tm_in, x_tm, s0, cfg,
                                      use_kernel=use_kernel)
    h = h + y
    cm_in = rmsnorm(h, lp["ln2"].to(torch.float32), cfg.rmsnorm_eps)
    y2, x_cm_new = rwkv6_channel_mix(lp["rwkv"], cm_in, x_cm)
    return h + y2, (x_tm_new, x_cm_new, s_f)


def forward_blocks(blocks: dict, h: torch.Tensor, cfg, return_cache: bool = False,
                   use_kernel: bool | None = None):
    """Run all layers on h (B, S, D) from a zero state.

    Returns (h, aux, cache_or_None); the cache holds the layer-stacked
    decode state ``x_tm``, ``x_cm`` (h's dtype) and ``s`` (float32).
    """
    _only_ssm(cfg)
    b, _, d = h.shape
    nh, n = d // HEAD_SIZE, HEAD_SIZE
    x0 = h.new_zeros((b, d))
    s0 = torch.zeros((b, nh, n, n), dtype=torch.float32, device=h.device)
    states = []
    for i in range(cfg.n_layers):
        h, st = _rwkv_block(layer(blocks, i), h, (x0, x0, s0), cfg, use_kernel)
        states.append(st)
    cache = None
    if return_cache:
        cache = {key: torch.stack([st[j] for st in states])
                 for j, key in enumerate(("x_tm", "x_cm", "s"))}
    return h, {}, cache


def init_decode_state(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                      device=None) -> dict:
    """Zero decode cache for ``batch`` slots (``seq_len`` is not used by the
    ssm family: its state does not grow with the context)."""
    _only_ssm(cfg)
    d, L = cfg.d_model, cfg.n_layers
    nh, n = d // HEAD_SIZE, HEAD_SIZE
    return {
        "x_tm": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "x_cm": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "s": torch.zeros((L, batch, nh, n, n), dtype=torch.float32, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_blocks(blocks: dict, h: torch.Tensor, cache: dict, cfg):
    """One-token step. h: (B, 1, D). Returns (h, new_cache)."""
    _only_ssm(cfg)
    x_tm_all, x_cm_all, s_all = [], [], []
    for i in range(cfg.n_layers):
        lp = layer(blocks, i)
        x_tm, x_cm = cache["x_tm"][i], cache["x_cm"][i]
        tm_in = rmsnorm(h, lp["ln1"].to(torch.float32), cfg.rmsnorm_eps)
        y, x_tm_n, s_n = rwkv6_time_mix_decode(lp["rwkv"], tm_in,
                                               x_tm.to(tm_in.dtype),
                                               cache["s"][i], cfg)
        h = h + y.to(h.dtype)
        cm_in = rmsnorm(h, lp["ln2"].to(torch.float32), cfg.rmsnorm_eps)
        y2, x_cm_n = rwkv6_channel_mix_decode(lp["rwkv"], cm_in, x_cm.to(cm_in.dtype))
        h = h + y2.to(h.dtype)
        x_tm_all.append(x_tm_n.to(x_tm.dtype))
        x_cm_all.append(x_cm_n.to(x_cm.dtype))
        s_all.append(s_n)
    return h, {"x_tm": torch.stack(x_tm_all), "x_cm": torch.stack(x_cm_all),
               "s": torch.stack(s_all), "len": cache["len"] + 1}
