"""GQA attention: chunked online-softmax prefill and cached decode.

The counterpart of ``repro.models.attention``, with its arithmetic:

  * the query scaled in ``x``'s dtype, then taken to float32;
  * the keys and values attended chunk by chunk (the reference's
    ``lax.scan``, a Python loop here) with a running max, denominator and
    float32 accumulator; the chunk is ``min(kv_chunk, S)`` halved until it
    divides S, and masked scores are ``NEG_INF``;
  * the probabilities cast to the values' dtype (bfloat16 as served)
    before the PV product, whose products are exact in float32 and summed
    in float32 (the reference's ``preferred_element_type``);
  * in decode, the whole softmax in float32 over the cache, and one scalar
    ``cache_len`` for the batch as the position, the write index (clamped
    to the cache, as ``dynamic_update_slice`` clamps) and the mask bound.

GQA is computed without repeating the KV heads: queries are reshaped to
(B, H_kv, group, S, D).  ``qk_norm`` (qwen3, chameleon) is a per-head RMS
norm of q and k before RoPE.  ``scaled_dot_product_attention`` is not used:
it rounds in another order.

The projected q, k and v are pinned heads-over-'model' (``sharding.constrain``,
the identity unless a mesh is armed), as in the reference.  While a mesh
is armed (the dry run) the attention core runs on each rank's block
(``sharding.local_call``): in prefill a (batch, head) block, the q heads
split over 'model' when they divide and the k/v heads with them, or, when
only the q heads divide (the GQA fallback), each rank taking the k/v
heads of its q heads from the whole set; in decode the cache's own
layout, with the softmax's max and sums and the PV product reduced over
the axes that split the cache's sequence (sequence parallelism, or a
'model' axis moved there from k/v heads it does not divide).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import sharding
from ..sharding import constrain
from .common import apply_rope, dense_init, rmsnorm

__all__ = ["AttentionParams", "attention_forward", "decode_attention",
           "init_attention"]

NEG_INF = -1e30

#: The leaves used in float32 whatever ``x.dtype``.
FLOAT32_LEAVES = ("q_norm", "k_norm")


class AttentionParams(NamedTuple):
    wq: torch.Tensor            # (D, Hq*hd)
    wk: torch.Tensor            # (D, Hkv*hd)
    wv: torch.Tensor            # (D, Hkv*hd)
    wo: torch.Tensor            # (Hq*hd, D)
    bq: Optional[torch.Tensor]
    bk: Optional[torch.Tensor]
    bv: Optional[torch.Tensor]
    q_norm: Optional[torch.Tensor]  # (hd,) qk_norm scales
    k_norm: Optional[torch.Tensor]


def init_attention(generator: torch.Generator, cfg) -> AttentionParams:
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dev = generator.device

    def zeros(n):
        return torch.zeros((n,), device=dev) if cfg.qkv_bias else None

    def ones():
        return torch.ones((hd,), device=dev) if cfg.qk_norm else None

    return AttentionParams(
        wq=dense_init(generator, (d, hq * hd)),
        wk=dense_init(generator, (d, hkv * hd)),
        wv=dense_init(generator, (d, hkv * hd)),
        wo=dense_init(generator, (hq * hd, d)),
        bq=zeros(hq * hd), bk=zeros(hkv * hd), bv=zeros(hkv * hd),
        q_norm=ones(), k_norm=ones(),
    )


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with float32 products and sums, whatever the inputs' dtype
    (bfloat16 products are exact in float32)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def _project_qkv(p: AttentionParams, x, cfg, positions):
    b, s, _ = x.shape
    hd, hq, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if p.bq is not None:
        q, k, v = q + p.bq.to(dt), k + p.bk.to(dt), v + p.bv.to(dt)
    if sharding.armed():  # the flat dim sharded as its heads will be
        q, k, v = (constrain(t, *sharding.resolve((b, s, nh, hd), "dp", None, "model")[:3])
                   for t, nh in ((q, hq), (k, hkv), (v, hkv)))
    q = constrain(q.reshape(b, s, hq, hd), "dp", None, "model", None)
    k = constrain(k.reshape(b, s, hkv, hd), "dp", None, "model", None)
    v = constrain(v.reshape(b, s, hkv, hd), "dp", None, "model", None)
    if p.q_norm is not None:
        q = rmsnorm(q, p.q_norm.to(torch.float32), cfg.rmsnorm_eps)
        k = rmsnorm(k, p.k_norm.to(torch.float32), cfg.rmsnorm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _flash_inner(q, k, v, q_pos0: int, kv_chunk: int, causal: bool):
    """Online softmax over KV chunks.

    q: (B, Hkv, G, Sq, D) float32, scaled; k/v: (B, Hkv, Skv, D).
    Returns (B, Hkv, G, Sq, D) float32.
    """
    b, hkv, g, sq, d = q.shape
    skv = k.shape[2]
    q_idx = q_pos0 + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=q.device)
    for idx in range(skv // kv_chunk):
        k_blk = k[:, :, idx * kv_chunk:(idx + 1) * kv_chunk]
        v_blk = v[:, :, idx * kv_chunk:(idx + 1) * kv_chunk]
        s = torch.matmul(q, k_blk.to(q.dtype)[:, :, None].transpose(-1, -2))
        if causal:
            kv_idx = idx * kv_chunk + torch.arange(kv_chunk, device=q.device)
            mask = q_idx[:, None] >= kv_idx[None, :]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        pr = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + pr.sum(dim=-1)
        acc = acc * alpha[..., None] + _dot_f32(pr.to(v_blk.dtype), v_blk[:, :, None])
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _attend(q, k, v, chunk: int, q_head0=None, group: int = 1):
    """Causal attention of q (B, S, Hq, D) over k/v (B, S, Hkv, D) ->
    (B, S, Hq*D) in q's dtype.  With ``q_head0`` the q heads are
    ``q_head0 + [0, Hq)`` of a model whose k/v heads serve ``group`` q
    heads each, and k/v hold every head: each q head takes its own."""
    b, s, hq, hd = q.shape
    if q_head0 is not None:
        idx = (q_head0 + torch.arange(hq, device=q.device)) // group
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    hkv = k.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    qg = (q * scale).to(torch.float32)
    qg = qg.reshape(b, s, hkv, g, hd).permute(0, 2, 3, 1, 4)  # (B,Hkv,G,S,D)
    out = _flash_inner(qg, k.transpose(1, 2), v.transpose(1, 2), 0, chunk, causal=True)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq * hd).to(q.dtype)


def attention_forward(p: AttentionParams, x, cfg, positions=None,
                      kv_chunk: int = 1024, return_cache: bool = False):
    """Causal self-attention over a full sequence x (B, S, D).

    With ``return_cache`` also returns (k, v), each (B, Hkv, S, hd) in
    ``x``'s dtype: the decode cache's layout.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    chunk = min(kv_chunk, s)
    while s % chunk:
        chunk //= 2
    if sharding.armed():
        qs = sharding.resolve(q.shape, "dp", None, "model", None)
        ks = sharding.resolve(k.shape, "dp", None, "model", None)
        q_head0 = None
        if qs[2] is not None and ks[2] is None:  # the GQA fallback
            q_head0 = sharding.axes_index(("model",)) * (hq // sharding.axis_sizes(
                sharding.armed_mesh())["model"])
        out = sharding.local_call(
            lambda q, k, v: _attend(q, k, v, chunk, q_head0, hq // hkv),
            (q, k, v), (qs, ks, ks), ((qs[0], None, qs[2]),))
    else:
        out = _attend(q, k, v, chunk)
    out = out @ p.wo.to(x.dtype)
    if return_cache:
        return out, (k.transpose(1, 2), v.transpose(1, 2))
    return out


def _decode_sharded(q, k_new, v_new, cache_k, cache_v, cache_len, cfg):
    """``decode_attention``'s core on each rank's block of the cache, in the
    cache's own layout (module docstring).  Returns (out (B, 1, Hq*hd),
    new_k, new_v)."""
    from torch.distributed import _functional_collectives as funcol

    mesh = sharding.armed_mesh()
    cs = sharding.spec_of(cache_k)                     # (B, Hkv, S, hd)
    s_axes = () if cs[2] is None else (cs[2] if isinstance(cs[2], tuple) else (cs[2],))
    s_total = cache_k.shape[2]
    names = mesh.mesh_dim_names
    hd = cfg.head_dim_

    def reduce(t, op):
        for a in s_axes:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, names.index(a))))
        return t

    def fn(q, kn, vn, ck, cv, cache_len):
        b, _, hq, _ = q.shape
        hkv, s_l = ck.shape[1], ck.shape[2]
        g = hq // hkv
        pos = sharding.axes_index(s_axes) * s_l + torch.arange(s_l, device=q.device)
        hit = (pos == cache_len.clamp(0, s_total - 1))[None, None, :, None]
        ck = torch.where(hit, kn.transpose(1, 2).to(ck.dtype), ck)
        cv = torch.where(hit, vn.transpose(1, 2).to(cv.dtype), cv)
        qg = (q * hd ** -0.5).to(torch.float32).reshape(b, 1, hkv, g, hd)
        qg = qg.permute(0, 2, 3, 1, 4)  # (B,Hkv,G,1,D)
        sc = torch.matmul(qg, ck.to(torch.float32)[:, :, None].transpose(-1, -2))
        sc = torch.where(pos <= cache_len, sc, torch.full_like(sc, NEG_INF))
        m = reduce(sc.amax(dim=-1, keepdim=True), "max")
        e = torch.exp(sc - m)
        den = reduce(e.sum(dim=-1, keepdim=True), "sum")
        out = reduce(torch.matmul(e, cv.to(torch.float32)[:, :, None]), "sum") / den
        out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, hq * hd).to(q.dtype)
        return out, ck, cv

    qs = (cs[0], None, cs[1], None)
    return sharding.local_call(
        fn, (q, k_new, v_new, cache_k, cache_v, cache_len),
        (qs, qs, qs, cs, cs, ()), ((cs[0], None, cs[1]), cs, cs))


def decode_attention(p: AttentionParams, x, cache_k, cache_v, cache_len, cfg):
    """One token x (B, 1, D) against a KV cache (B, Hkv, S_cache, hd) with
    ``cache_len`` (a scalar tensor) valid rows; returns (out, new_k, new_v).

    The caches given are not written: the new ones are copies with the
    token's K/V at row ``cache_len`` (clamped to the last row).
    """
    b = x.shape[0]
    hd, hq, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    g = hq // hkv
    cache_len = torch.as_tensor(cache_len, device=x.device)
    positions = cache_len.reshape(1, 1).expand(b, 1)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    if sharding.armed():
        out, cache_k, cache_v = _decode_sharded(q, k_new, v_new, cache_k, cache_v,
                                                cache_len, cfg)
        return out @ p.wo.to(x.dtype), cache_k, cache_v

    s_cache = cache_k.shape[2]
    row = cache_len.clamp(0, s_cache - 1).reshape(1).long()
    cache_k = cache_k.index_copy(2, row, k_new.transpose(1, 2).to(cache_k.dtype))
    cache_v = cache_v.index_copy(2, row, v_new.transpose(1, 2).to(cache_v.dtype))

    scale = hd ** -0.5
    qg = (q * scale).to(torch.float32).reshape(b, 1, hkv, g, hd)
    qg = qg.permute(0, 2, 3, 1, 4)  # (B,Hkv,G,1,D)
    s = torch.matmul(qg, cache_k.to(torch.float32)[:, :, None].transpose(-1, -2))
    valid = torch.arange(s_cache, device=x.device) <= cache_len
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.matmul(w, cache_v.to(torch.float32)[:, :, None])
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, hq * hd).to(x.dtype)
    out = out @ p.wo.to(x.dtype)
    return out, cache_k, cache_v
