"""Plain PyTorch versions of the CUDA kernels: the correctness ground truth.

Each function computes exactly what its kernel computes, with ordinary
tensor operations.  The CPU tests hold them against the JAX package's
Pallas kernels and oracles; ``chip_smoke.py`` holds the CUDA kernels
against them on the card.  The kernel wrappers use them only for tensors
that lie on the CPU.

There is no int32 matrix product on CUDA in PyTorch, so the integer
``S @ W`` is taken in float64 and cast back.  That is exact: spikes are 0/1 and weights fit
in int8, so every partial sum is an integer of magnitude at most
K * 128, far below 2**53 (and, for the fan-ins here, K <= 288, below 2**24).  The float versions
multiply in float32, as the reference does; on the card that product must
run in full fp32 (``torch.backends.cuda.matmul.allow_tf32`` False, its
default), which the callers that compare against a kernel make sure of.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "DEFAULT_BLOCK",
    "FLOAT_TOL",
    "compare_float_step",
    "fused_lif_gemm_int_ref",
    "fused_lif_gemm_int_tblk_ref",
    "fused_lif_gemm_ref",
    "lif_step_int_ref",
    "lif_step_ref",
    "pack_int4",
    "quant_matmul_ref",
    "spike_gemm_ref",
    "spike_tile_bitmap",
    "unpack_int4",
    "wkv_chunk_ref",
    "wkv_sequence_factored",
    "wkv_sequence_ref",
]

DEFAULT_BLOCK = (128, 128, 128)  # (bm, bn, bk), the reference's default

#: Float tolerance of a kernel against its plain version: Vmem within
#: ``atol = rtol = 1e-5``; a spike may differ only where the pre-reset Vmem
#: lies within ``1e-5`` of the threshold (fp32 sums in another order).
FLOAT_TOL = 1e-5


def spike_gemm_ref(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """int32 ``spikes @ weights`` over the last axis of ``spikes``."""
    acc = torch.matmul(spikes.to(torch.float64), weights.to(torch.float64))
    return acc.to(torch.int32)


def lif_step_ref(v, current, threshold=1.0, leak=1.0, soft_reset=False):
    """The float neuron step: multiplicative leak (when ``leak != 1``),
    integrate, fire, hard reset ``v*(1-s)`` or soft reset ``v - s*thr``."""
    if leak != 1.0:
        v = v * leak
    v = v + current
    s = (v >= threshold).to(v.dtype)
    v_next = v - s * threshold if soft_reset else v * (1.0 - s)
    return v_next, s


def fused_lif_gemm_ref(spikes, weights, v, threshold=1.0, leak=1.0,
                       soft_reset=False):
    """Float layer-timestep: float32 ``spikes @ weights``, then the step."""
    acc = torch.matmul(spikes.to(torch.float32), weights.to(torch.float32))
    return lif_step_ref(v.to(torch.float32), acc, threshold, leak, soft_reset)


def lif_step_int_ref(v, partial, threshold, leak_shift=0, soft_reset=False,
                     vmem_bits=7):
    """The neuron epilogue: leak (shift > 0 only), saturating add, fire,
    hard reset ``v*(1-s)`` (unclipped) or soft reset (clipped)."""
    v_min, v_max = -(1 << (vmem_bits - 1)), (1 << (vmem_bits - 1)) - 1
    v = v.to(torch.int32)
    if leak_shift > 0:
        v = v - (v >> leak_shift)
    v = torch.clamp(v + partial.to(torch.int32), v_min, v_max)
    s = (v >= threshold).to(torch.int32)
    if soft_reset:
        v_next = torch.clamp(v - s * threshold, v_min, v_max)
    else:
        v_next = v * (1 - s)
    return v_next, s


def _threshold(threshold, n: int, device) -> object:
    """An int stays an int; a tensor becomes an ``(N,)`` int32 vector."""
    if isinstance(threshold, (int, np.integer)):
        return int(threshold)
    t = torch.as_tensor(threshold, dtype=torch.int32, device=device)
    return t.expand(n) if t.ndim == 0 else t


def fused_lif_gemm_int_ref(spikes, weights, v, threshold, leak_shift=0,
                           soft_reset=False, vmem_bits=7):
    """One layer-timestep: wide GEMM, one saturation, neuron step.

    ``spikes`` (M, K) {0,1}, ``weights`` (K, N) int8, ``v`` (M, N) int32,
    ``threshold`` an int or ``(N,)`` ints.  Returns ``(v', s)`` int32.
    """
    v_min, v_max = -(1 << (vmem_bits - 1)), (1 << (vmem_bits - 1)) - 1
    thr = _threshold(threshold, weights.shape[1], v.device)
    partial = torch.clamp(spike_gemm_ref(spikes, weights), v_min, v_max)
    return lif_step_int_ref(v, partial, thr, leak_shift, soft_reset, vmem_bits)


def fused_lif_gemm_int_tblk_ref(spikes, weights, v, threshold, leak_shift=0,
                                soft_reset=False, vmem_bits=7):
    """T timesteps of :func:`fused_lif_gemm_int_ref`, sequentially over t.

    ``spikes`` (T, M, K); returns the ``(T, M, N)`` Vmem trajectory and
    spikes (``v_traj[-1]`` is the carry into the next slab).
    """
    v_out, s_out = [], []
    for t in range(spikes.shape[0]):
        v, s = fused_lif_gemm_int_ref(spikes[t], weights, v, threshold,
                                      leak_shift, soft_reset, vmem_bits)
        v_out.append(v)
        s_out.append(s)
    return torch.stack(v_out), torch.stack(s_out)


def spike_tile_bitmap(spikes: torch.Tensor, block: tuple = DEFAULT_BLOCK):
    """Per-tile spike bitmap ``(T, ceil(M/bm), ceil(K/bk))`` int32.

    Entry ``[t, i, kk]`` is 1 iff the ``(bm, bk)`` spike tile at grid cell
    ``(i, kk)`` of timestep ``t`` holds a spike, after zero-padding to block
    multiples.  A 2-D ``(M, K)`` input is one timestep and gives a 2-D map.
    ``block`` is ``(bm, bn, bk)``; ``bn`` is unused.
    """
    bm, _, bk = block
    squeeze = spikes.ndim == 2
    if squeeze:
        spikes = spikes[None]
    t, m, k = spikes.shape
    s = F.pad(spikes != 0, (0, -k % bk, 0, -m % bm))
    tiles = s.reshape(t, s.shape[1] // bm, bm, s.shape[2] // bk, bk)
    out = tiles.any(dim=4).any(dim=2).to(torch.int32)
    return out[0] if squeeze else out


def compare_float_step(v_got, s_got, v_want, s_want, v_pre, threshold,
                       tol: float = FLOAT_TOL) -> dict:
    """Hold a float neuron step ``(v', s)`` against the plain one.

    ``v_pre`` is the plain pre-reset Vmem (``v*leak + I``).  Spikes must be
    equal except where ``|v_pre - threshold| <= tol``; every such flip is
    counted.  Vmem must agree within ``atol = rtol = tol`` where the spikes
    agree (a flipped spike resets one side only).  Returns ``ok``, the
    counts and the largest absolute Vmem error over agreeing spots.
    """
    s_got, s_want = s_got.to(torch.float32), s_want.to(torch.float32)
    flip = s_got != s_want
    near = (v_pre.to(torch.float32) - threshold).abs() <= tol
    same = ~flip
    err = (v_got - v_want).abs()
    v_ok = bool((err[same] <= tol + tol * v_want.abs()[same]).all())
    return {"ok": v_ok and not bool((flip & ~near).any()),
            "max_abs_err": float(err[same].max()) if bool(same.any()) else 0.0,
            "spikes_flipped": int(flip.sum()),
            "flipped_off_threshold": int((flip & ~near).sum()),
            "near_threshold": int(near.sum())}


# ---------------------------------------------------------------------------
# The LM stack's kernels: quant_matmul (B6) and the RWKV6 wkv (B7)
# ---------------------------------------------------------------------------
def pack_int4(w_int: torch.Tensor) -> torch.Tensor:
    """(K, N) ints in [-8, 7] -> (K//2, N) uint8, even K rows in the low nibble."""
    if w_int.shape[0] % 2:
        raise ValueError(f"K must be even to pack int4, got {w_int.shape[0]}")
    w = w_int.to(torch.int32)
    return ((w[0::2] & 0xF) | ((w[1::2] & 0xF) << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` -> (K, N) int8, sign-extended."""
    p = packed.to(torch.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    k2, n = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(k2 * 2, n).to(torch.int8)


def quant_matmul_ref(x, w_q, scale, bits=8):
    """float32 ``(x @ dequant(w_q)) * scale``: ``x`` (M, K), ``w_q`` (K, N)
    int8 or (K/2, N) packed uint8 (``bits=4``), ``scale`` (N,).  On the card
    the float32 product must not run in TF32 (``allow_tf32`` False)."""
    w = unpack_int4(w_q) if bits == 4 else w_q
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)) * scale.to(torch.float32)


def wkv_sequence_ref(r, k, v, lw, u, s0, chunk: int = 32):
    """RWKV6 wkv over a sequence, chunked: r/k/v/lw (B, S, H, N) float32
    with S a multiple of ``chunk``, u (H, N) (or anything broadcastable to
    (B, H, N)), s0 (B, H, N, N) -> (y (B, S, H, N), s_final (B, H, N, N)).
    Every exponent is <= 0: the pairwise decay is exp(lw_excl_i - lw_incl_j)
    for j < i, never a product of two exponentials.  The model's plain path
    (``models.rwkv6._wkv_chunked``) is this function."""
    b, s, h, n = r.shape
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    nc = s // chunk

    def by_chunk(x):  # (B,S,H,N) -> (nc, B, H, C, N)
        return x.reshape(b, nc, chunk, h, n).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(by_chunk, (r, k, v, lw))
    u4 = torch.broadcast_to(u, (b, h, n))[:, :, None, :]     # (B,H,1,N)
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)[:, :, None]
    state, ys = s0, []
    for rb, kb, vb, lwb in zip(rc, kc, vc, lwc):              # (B,H,C,N)
        lw_incl = torch.cumsum(lwb, dim=2)
        lw_excl = lw_incl - lwb
        y = torch.matmul(rb * torch.exp(lw_excl), state)     # inter-chunk
        expo = lw_excl[:, :, :, None, :] - lw_incl[:, :, None, :, :]
        ratio = torch.exp(torch.where(strict, expo, float("-inf")))  # (B,H,C,C,N)
        a = (rb[:, :, :, None, :] * kb[:, :, None, :, :] * ratio).sum(-1)
        y = y + torch.matmul(a, vb)                          # intra-chunk
        y = y + (rb * u4 * kb).sum(-1, keepdim=True) * vb    # diagonal bonus
        last = lw_incl[:, :, -1:, :]                         # (B,H,1,N)
        k_scaled = kb * torch.exp(last - lw_incl)
        state = state * torch.exp(last).transpose(2, 3) + torch.matmul(
            k_scaled.transpose(2, 3), vb)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, h, n)
    return y, state


def wkv_chunk_ref(r, k, v, lw, u, s0):
    """One chunk for every (batch, head) row, the TPU kernel's signature:
    r/k/v/lw (BH, C, N), u (BH, 1, N), s0 (BH, N, N) -> (y, s1)."""
    bh, c, n = r.shape
    y, s1 = wkv_sequence_ref(*(t.reshape(bh, c, 1, n) for t in (r, k, v, lw)),
                             u.reshape(bh, 1, n), s0.reshape(bh, 1, n, n), c)
    return y.reshape(bh, c, n), s1.reshape(bh, n, n)


def wkv_sequence_factored(r, k, v, lw, u, s0, chunk: int = 32, cluster: int = 1,
                          per_block: int = 1):
    """:func:`wkv_sequence_ref` computed as the CUDA kernel computes it, in
    plain PyTorch: the tests hold it against the JAX kernel where the
    kernel itself cannot run.

    Every chunk's intra-chunk terms at once: the decay matrix A factored
    over sub-chunks of 8 tokens (for i after sub-chunk a, whose last
    lw_incl is R_a: e^{lw_excl_i - lw_incl_j} = e^{lw_excl_i - R_a}
    e^{R_a - lw_incl_j}, both exponents <= 0; pairs inside one sub-chunk
    keep the pairwise exponential), k' = k e^{lw_incl_C - lw_incl}, and
    dS = k'^T v.  Then, as the kernel's cluster of ``cluster``
    blocks of ``per_block`` chunks does, window by window: each block
    composes its chunks into (T, D), the state entering each block is the
    window's start state composed with its predecessors' (T, D) in order,
    and y adds r' D S_in.
    """
    b, s, h, n = r.shape
    nc, sub = s // chunk, min(8, chunk)
    nsub = chunk // sub

    def by_chunk(x):  # (B,S,H,N) -> (B,H,nc,C,N)
        return x.reshape(b, nc, chunk, h, n).permute(0, 3, 1, 2, 4)

    rc, kc, vc, lwc = map(by_chunk, (r, k, v, lw))
    lwi = torch.cumsum(lwc, dim=3)
    lwe = lwi - lwc
    ends = lwi[..., sub - 1::sub, :]                          # R_a: (B,H,nc,nsub,N)
    last = lwi[..., -1:, :]
    rp = rc * torch.exp(lwe)
    q = kc * torch.exp(ends.repeat_interleave(sub, dim=3) - lwi)
    kp = kc * torch.exp(last - lwi)
    d = torch.exp(last)                                       # (B,H,nc,1,N)

    i = torch.arange(chunk, device=r.device)
    same = (i[:, None] // sub == i[None, :] // sub) & (i[None, :] < i[:, None])
    expo = lwe[..., :, None, :] - lwi[..., None, :, :]
    pair = torch.exp(torch.where(same[:, :, None], expo, float("-inf")))
    a = ((rc[..., :, None, :] * kc[..., None, :, :]) * pair).sum(-1)
    for sa in range(nsub - 1):
        rows, cols = slice((sa + 1) * sub, chunk), slice(sa * sub, (sa + 1) * sub)
        p = rc[..., rows, :] * torch.exp(lwe[..., rows, :] - ends[..., sa:sa + 1, :])
        a[..., rows, cols] = p @ q[..., cols, :].transpose(-1, -2)
    u4 = torch.broadcast_to(u, (b, h, n))[:, :, None, None, :]
    a = a + torch.diag_embed((rc * u4 * kc).sum(-1))          # the bonus on A's diagonal
    y_intra = a @ vc
    ds = kp.transpose(-1, -2) @ vc                            # (B,H,nc,N,N)

    y = torch.empty_like(rc)
    state = s0
    per_window = cluster * per_block
    for w0 in range(0, nc, per_window):
        parts = []
        for blk in range(cluster):
            first = w0 + blk * per_block
            t_blk = torch.zeros_like(s0)
            d_blk = torch.ones_like(d[:, :, 0])
            owned = []
            for c in range(first, min(first + per_block, nc)):
                yc = y_intra[:, :, c]
                if c > first:
                    yc = yc + rp[:, :, c] @ t_blk
                owned.append((c, yc, rp[:, :, c] * d_blk))
                t_blk = d[:, :, c].transpose(-1, -2) * t_blk + ds[:, :, c]
                d_blk = d_blk * d[:, :, c]
            parts.append((owned, t_blk, d_blk))
        for owned, t_blk, d_blk in parts:
            for c, yc, rpp in owned:
                y[:, :, c] = yc + rpp @ state
            state = d_blk.transpose(-1, -2) * state + t_blk
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, n), state
