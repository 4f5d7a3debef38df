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
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
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
    hd, hq, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    g = hq // hkv

    scale = hd ** -0.5
    qg = (q * scale).to(torch.float32)
    qg = qg.reshape(b, s, hkv, g, hd).permute(0, 2, 3, 1, 4)  # (B,Hkv,G,S,D)
    kk = k.transpose(1, 2)  # (B,Hkv,S,D)
    vv = v.transpose(1, 2)

    chunk = min(kv_chunk, s)
    while s % chunk:
        chunk //= 2
    out = _flash_inner(qg, kk, vv, 0, chunk, causal=True)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, hq * hd).to(x.dtype)
    out = out @ p.wo.to(x.dtype)
    if return_cache:
        return out, (kk, vv)
    return out


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
