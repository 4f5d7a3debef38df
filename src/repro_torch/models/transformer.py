"""Block composition over layer-stacked parameters, for every family.

The counterpart of ``repro.models.transformer``:

  dense / audio / vlm : pre-norm attention + FFN (SwiGLU or GELU)
  moe                 : pre-norm attention + top-k MoE FFN
  ssm (rwkv6)         : time-mix + channel-mix with carried wkv state
  hybrid (zamba2)     : Mamba2 backbone; one SHARED attention+FFN block
                        after every ``attn_period - 1`` Mamba2 layers
                        (weight reuse), keeping its K/V per application

Parameters keep the reference's layer-stacked layout, ``(L, ...)`` per leaf
(the hybrid's groups ``(G, per_group, ...)``); where the reference scans
over layers, this module loops over them in Python.  The full-sequence
forward unbinds each stacked leaf once (views whose gradient is one
``stack``; indexing layer by layer would give every layer a full-size
zero gradient to sum).  With ``remat`` it runs each layer body, and each
application of the hybrid's shared block, under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` around its
scanned bodies): only layer boundaries are kept for the backward, which
recomputes the rest.  The sharding constraints and remat names of the
reference are no-ops on one device and are left out.

``init_blocks(generator, cfg, cast)`` draws the attention, MoE and hybrid
families layer by layer and passes every drawn leaf through
``cast(group, field, tensor)`` at once, so a bfloat16 serving copy never
needs the float32 masters of the whole model (``model.init_serving_params``);
the ssm family draws each stacked leaf at once, as before.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .attention import AttentionParams, attention_forward, decode_attention, init_attention
from .common import rmsnorm
from .ffn import FFNParams, ffn_forward, init_ffn
from .mamba2 import (
    CONV_K,
    HEAD_P,
    Mamba2Params,
    init_mamba2_layer,
    mamba2_decode_step,
    mamba2_forward,
)
from .moe import MoEParams, init_moe, moe_forward
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
           "layer", "zamba2_layout"]

ATTN_FAMILIES = ("dense", "audio", "vlm", "moe")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def zamba2_layout(cfg):
    """(n_groups, per_group, tail) of the hybrid's layer slots."""
    p = cfg.attn_period or 6
    n_groups = cfg.n_layers // p
    return n_groups, p - 1, cfg.n_layers - n_groups * p


def _map_tree(fn, tree, group=None, field=None):
    """``fn(group, field, leaf)`` over a tree of dicts and NamedTuples
    (``group``: the NamedTuple's type, or None for a dict's leaf)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, None, k) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, v, type(tree), f)
                            for f, v in zip(tree._fields, tree)))
    return fn(group, field, tree)


def _leaf_pairs(a, b):
    if a is None:
        return
    if isinstance(a, dict):
        for k in a:
            yield from _leaf_pairs(a[k], b[k])
    elif hasattr(a, "_fields"):
        for x, y in zip(a, b):
            yield from _leaf_pairs(x, y)
    else:
        yield a, b


def _stacked(n: int, draw, cast=None):
    """``n`` draws of the tree ``draw()``, stacked on a new leading axis;
    each drawn leaf passes through ``cast`` before it is stored."""
    out = None
    for i in range(n):
        tree = draw()
        if cast is not None:
            tree = _map_tree(cast, tree)
        if out is None:
            out = _map_tree(lambda g, f, t: t.new_empty((n, *t.shape)), tree)
        for dst, src in _leaf_pairs(out, tree):
            dst[i] = src
    return out


def _attn_layer(generator, cfg, mlp: str):
    d = cfg.d_model
    dev = generator.device
    out = {"ln1": torch.ones((d,), device=dev),
           "attn": init_attention(generator, cfg),
           "ln2": torch.ones((d,), device=dev)}
    if mlp == "moe":
        out["moe"] = init_moe(generator, d, cfg.d_ff, cfg.n_experts)
    else:
        out["ffn"] = init_ffn(generator, d, cfg.d_ff, cfg.ffn_variant)
    return out


def _mamba_layer(generator, cfg):
    return {"ln": torch.ones((cfg.d_model,), device=generator.device),
            "mamba": init_mamba2_layer(generator, cfg)}


def init_blocks(generator: torch.Generator, cfg, cast=None) -> dict:
    """The layer-stacked block parameters (float32 unless ``cast`` says
    otherwise), on the generator's device."""
    fam = cfg.family
    if fam in ATTN_FAMILIES:
        mlp = "moe" if fam == "moe" else "ffn"
        return {"layers": _stacked(cfg.n_layers,
                                   lambda: _attn_layer(generator, cfg, mlp), cast)}
    if fam == "ssm":
        ones = torch.ones((cfg.n_layers, cfg.d_model), device=generator.device)
        blocks = {"layers": {"ln1": ones, "ln2": ones.clone(),
                             "rwkv": init_rwkv6_layer(generator, cfg, cfg.n_layers)}}
        return blocks if cast is None else _map_tree(cast, blocks)
    if fam == "hybrid":
        n_groups, per_group, tail = zamba2_layout(cfg)
        groups = _stacked(n_groups * per_group, lambda: _mamba_layer(generator, cfg), cast)
        groups = _map_tree(lambda g, f, t: t.reshape(n_groups, per_group, *t.shape[1:]),
                           groups)
        tail_layers = (_stacked(tail, lambda: _mamba_layer(generator, cfg), cast)
                       if tail else None)
        shared = _attn_layer(generator, cfg, "ffn")
        if cast is not None:
            shared = _map_tree(cast, shared)
        return {"groups": groups, "tail": tail_layers, "shared": shared}
    raise ValueError(f"unknown family {fam}")


def _index(tree, i):
    return _map_tree(lambda g, f, t: t[i], tree)


def _unstack(tree) -> list:
    """The trees of ``tree[i]`` for every i of the leading axis, as views
    from one ``unbind`` per leaf."""
    parts = _map_tree(lambda g, f, t: t.unbind(0), tree)
    n = len(next(_leaf_pairs(parts, parts))[0])
    return [_map_tree(lambda g, f, p: p[i], parts) for i in range(n)]


def _run(remat: bool, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def layer(blocks: dict, i: int) -> dict:
    """Layer ``i`` of the stacked parameters (views, no copies); for the
    hybrid, group ``i``'s stacked Mamba2 layers."""
    if "layers" in blocks:
        return _index(blocks["layers"], i)
    return _index(blocks["groups"], i)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------
def _attn_block(lp, h, cfg, return_cache=False):
    a_in = rmsnorm(h, lp["ln1"].to(torch.float32), cfg.rmsnorm_eps)
    if return_cache:
        attn_out, kv = attention_forward(lp["attn"], a_in, cfg, return_cache=True)
    else:
        attn_out, kv = attention_forward(lp["attn"], a_in, cfg), None
    h = h + attn_out
    f_in = rmsnorm(h, lp["ln2"].to(torch.float32), cfg.rmsnorm_eps)
    if "moe" in lp:
        out, aux = moe_forward(lp["moe"], f_in, cfg.top_k)
    else:
        out, aux = ffn_forward(lp["ffn"], f_in), {}
    return h + out, aux, kv


def _rwkv_block(lp, h, state, cfg, use_kernel=None):
    x_tm, x_cm, s0 = state
    tm_in = rmsnorm(h, lp["ln1"].to(torch.float32), cfg.rmsnorm_eps)
    y, x_tm_new, s_f = rwkv6_time_mix(lp["rwkv"], tm_in, x_tm, s0, cfg,
                                      use_kernel=use_kernel)
    h = h + y
    cm_in = rmsnorm(h, lp["ln2"].to(torch.float32), cfg.rmsnorm_eps)
    y2, x_cm_new = rwkv6_channel_mix(lp["rwkv"], cm_in, x_cm)
    return h + y2, (x_tm_new, x_cm_new, s_f)




def _mamba_block(lp, h, state, cfg):
    m_in = rmsnorm(h, lp["ln"].to(torch.float32), cfg.rmsnorm_eps)
    out, state_new = mamba2_forward(lp["mamba"], m_in, state, cfg)
    return h + out, state_new


def _mamba_stack(layers, h, cfg, remat=False):
    """Stacked Mamba2 layers from a zero state; returns (h, (conv states
    (n, B, K-1, C), ssm states (n, B, H, N, P)))."""
    b = h.shape[0]
    nh = cfg.d_inner // HEAD_P
    s0 = torch.zeros((b, nh, cfg.ssm_state, HEAD_P), dtype=torch.float32, device=h.device)
    conv, ssm = [], []
    for lp in _unstack(layers):
        h, (c, s) = _run(remat, _mamba_block, lp, h, (None, s0), cfg)
        conv.append(c)
        ssm.append(s)
    return h, (torch.stack(conv), torch.stack(ssm))


def forward_blocks(blocks: dict, h: torch.Tensor, cfg, return_cache: bool = False,
                   use_kernel: bool | None = None, remat: bool = False):
    """Run all layers on h (B, S, D) from a zero state.

    Returns (h, aux, cache_or_None).  The attention families' cache holds
    the layer-stacked ``k``/``v`` (L, B, Hkv, S, hd) in h's dtype and their
    aux the MoE losses averaged over layers; the ssm family's holds
    ``x_tm``, ``x_cm`` (h's dtype) and ``s`` (float32); the hybrid's
    ``group_conv``/``group_ssm`` (G, per_group, B, ...), ``tail_conv``/
    ``tail_ssm`` (tail, B, ...; None without a tail) and the shared
    block's ``k``/``v`` per group (G, B, Hkv, S, hd).  ``use_kernel``
    picks the ssm family's wkv route (None: the kernel on CUDA tensors);
    ``remat`` checkpoints each layer body (training).
    """
    fam = cfg.family
    if fam in ATTN_FAMILIES:
        lb = zl = 0.0
        kvs = []
        for lp in _unstack(blocks["layers"]):
            h, aux, kv = _run(remat, _attn_block, lp, h, cfg, return_cache)
            lb = lb + aux.get("load_balance_loss", 0.0)
            zl = zl + aux.get("router_z_loss", 0.0)
            kvs.append(kv)
        aux = {"load_balance_loss": lb / cfg.n_layers,
               "router_z_loss": zl / cfg.n_layers}
        cache = None
        if return_cache:
            cache = {"k": torch.stack([kv[0] for kv in kvs]),
                     "v": torch.stack([kv[1] for kv in kvs])}
        return h, aux, cache

    if fam == "ssm":
        b, _, d = h.shape
        nh, n = d // HEAD_SIZE, HEAD_SIZE
        x0 = h.new_zeros((b, d))
        s0 = torch.zeros((b, nh, n, n), dtype=torch.float32, device=h.device)
        states = []
        for lp in _unstack(blocks["layers"]):
            h, st = _run(remat, _rwkv_block, lp, h, (x0, x0, s0), cfg, use_kernel)
            states.append(st)
        cache = None
        if return_cache:
            cache = {key: torch.stack([st[j] for st in states])
                     for j, key in enumerate(("x_tm", "x_cm", "s"))}
        return h, {}, cache

    if fam == "hybrid":
        n_groups, per_group, tail = zamba2_layout(cfg)
        g_conv, g_ssm, ks, vs = [], [], [], []
        for group in (_unstack(blocks["groups"]) if n_groups else ()):
            h, (c, s) = _mamba_stack(group, h, cfg, remat)
            h, _, kv = _run(remat, _attn_block, blocks["shared"], h, cfg, return_cache)
            g_conv.append(c)
            g_ssm.append(s)
            if return_cache:
                ks.append(kv[0])
                vs.append(kv[1])
        tail_states = None
        if blocks["tail"] is not None:
            h, tail_states = _mamba_stack(blocks["tail"], h, cfg, remat)
        cache = None
        if return_cache:
            cache = {
                "group_conv": torch.stack(g_conv), "group_ssm": torch.stack(g_ssm),
                "tail_conv": tail_states[0] if tail_states else None,
                "tail_ssm": tail_states[1] if tail_states else None,
                "k": torch.stack(ks) if ks else None,
                "v": torch.stack(vs) if vs else None,
            }
        return h, {}, cache

    raise ValueError(f"unknown family {fam}")


# ---------------------------------------------------------------------------
# Decode (one token against carried state)
# ---------------------------------------------------------------------------
def init_decode_state(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
                      device=None) -> dict:
    """Zero decode cache for ``batch`` slots and a context of ``seq_len``
    (the ssm family's state does not grow with the context)."""
    d, hd, hkv, L = cfg.d_model, cfg.head_dim_, cfg.n_kv_heads, cfg.n_layers
    fam = cfg.family

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if fam in ATTN_FAMILIES:
        return {"k": zeros((L, batch, hkv, seq_len, hd)),
                "v": zeros((L, batch, hkv, seq_len, hd)),
                "len": zeros((), torch.int32)}
    if fam == "ssm":
        nh, n = d // HEAD_SIZE, HEAD_SIZE
        return {"x_tm": zeros((L, batch, d)), "x_cm": zeros((L, batch, d)),
                "s": zeros((L, batch, nh, n, n), torch.float32),
                "len": zeros((), torch.int32)}
    if fam == "hybrid":
        n_groups, per_group, tail = zamba2_layout(cfg)
        di, nst, nh = cfg.d_inner, cfg.ssm_state, cfg.d_inner // HEAD_P
        conv_ch = di + 2 * nst
        out = {
            "group_conv": zeros((n_groups, per_group, batch, CONV_K - 1, conv_ch)),
            "group_ssm": zeros((n_groups, per_group, batch, nh, nst, HEAD_P),
                               torch.float32),
            "k": zeros((n_groups, batch, hkv, seq_len, hd)),
            "v": zeros((n_groups, batch, hkv, seq_len, hd)),
            "len": zeros((), torch.int32),
        }
        if tail:
            out["tail_conv"] = zeros((tail, batch, CONV_K - 1, conv_ch))
            out["tail_ssm"] = zeros((tail, batch, nh, nst, HEAD_P), torch.float32)
        return out
    raise ValueError(f"unknown family {fam}")


def _attn_block_decode(lp, h, k_cache, v_cache, cache_len, cfg):
    a_in = rmsnorm(h, lp["ln1"].to(torch.float32), cfg.rmsnorm_eps)
    attn_out, k_new, v_new = decode_attention(lp["attn"], a_in, k_cache, v_cache,
                                              cache_len, cfg)
    h = h + attn_out
    f_in = rmsnorm(h, lp["ln2"].to(torch.float32), cfg.rmsnorm_eps)
    if "moe" in lp:
        out, aux = moe_forward(lp["moe"], f_in, cfg.top_k)
    else:
        out, aux = ffn_forward(lp["ffn"], f_in), {}
    return h + out, k_new, v_new, aux


def _mamba_decode(layers, n: int, h, conv, ssm, cfg):
    conv_all, ssm_all = [], []
    for j in range(n):
        lp = _index(layers, j)
        m_in = rmsnorm(h, lp["ln"].to(torch.float32), cfg.rmsnorm_eps)
        out, (conv_n, ssm_n) = mamba2_decode_step(lp["mamba"], m_in, (conv[j], ssm[j]), cfg)
        h = h + out.to(h.dtype)
        conv_all.append(conv_n.to(conv.dtype))
        ssm_all.append(ssm_n)
    return h, torch.stack(conv_all), torch.stack(ssm_all)


def decode_blocks(blocks: dict, h: torch.Tensor, cache: dict, cfg):
    """One-token step. h: (B, 1, D). Returns (h, new_cache, aux): aux holds
    the MoE layers' mean ``drop_fraction`` (empty for the other families),
    which the reference's decode computes and drops."""
    fam = cfg.family
    cache_len = cache["len"]
    aux = {}

    if fam in ATTN_FAMILIES:
        k_all, v_all, drops = [], [], []
        for i in range(cfg.n_layers):
            h, k_n, v_n, a = _attn_block_decode(layer(blocks, i), h, cache["k"][i],
                                                cache["v"][i], cache_len, cfg)
            k_all.append(k_n)
            v_all.append(v_n)
            if "drop_fraction" in a:
                drops.append(a["drop_fraction"])
        if drops:
            aux["drop_fraction"] = torch.stack(drops).mean()
        new_cache = {"k": torch.stack(k_all), "v": torch.stack(v_all),
                     "len": cache_len + 1}

    elif fam == "ssm":
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
            y2, x_cm_n = rwkv6_channel_mix_decode(lp["rwkv"], cm_in,
                                                  x_cm.to(cm_in.dtype))
            h = h + y2.to(h.dtype)
            x_tm_all.append(x_tm_n.to(x_tm.dtype))
            x_cm_all.append(x_cm_n.to(x_cm.dtype))
            s_all.append(s_n)
        new_cache = {"x_tm": torch.stack(x_tm_all), "x_cm": torch.stack(x_cm_all),
                     "s": torch.stack(s_all), "len": cache_len + 1}

    elif fam == "hybrid":
        n_groups, per_group, tail = zamba2_layout(cfg)
        g_conv, g_ssm, k_all, v_all = [], [], [], []
        for gi in range(n_groups):
            h, conv_n, ssm_n = _mamba_decode(layer(blocks, gi), per_group, h,
                                             cache["group_conv"][gi],
                                             cache["group_ssm"][gi], cfg)
            h, k_n, v_n, _ = _attn_block_decode(blocks["shared"], h, cache["k"][gi],
                                                cache["v"][gi], cache_len, cfg)
            g_conv.append(conv_n)
            g_ssm.append(ssm_n)
            k_all.append(k_n)
            v_all.append(v_n)
        new_cache = {"group_conv": torch.stack(g_conv), "group_ssm": torch.stack(g_ssm),
                     "k": torch.stack(k_all), "v": torch.stack(v_all),
                     "len": cache_len + 1}
        if blocks["tail"] is not None:
            h, t_conv, t_ssm = _mamba_decode(blocks["tail"], tail, h, cache["tail_conv"],
                                             cache["tail_ssm"], cfg)
            new_cache["tail_conv"] = t_conv
            new_cache["tail_ssm"] = t_ssm
    else:
        raise ValueError(f"unknown family {fam}")
    return h, new_cache, aux
