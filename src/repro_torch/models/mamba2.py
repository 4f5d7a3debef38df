"""Mamba2 (SSD) blocks: the zamba2-7b backbone.

The counterpart of ``repro.models.mamba2``.  Per head (head dim P = 64,
state N = ``cfg.ssm_state``), with a scalar decay per head and step:

    h_t = a_t h_{t-1} + dt_t * B_t x_t^T          h: (N, P)
    y_t = C_t^T h_t + D * x_t

a_t = exp(-dt_t * exp(A_log)), dt_t = softplus(dt_raw + bias).  Prefill
runs the chunked form (chunks of 64, a Python loop over them where the
reference scans); decode runs the plain recurrence.  A depthwise causal
conv (kernel 4) over (x, B, C) precedes the SSM; its state is the last 3
rows of the unpadded sequence.

The prefill pads the sequence to a multiple of 64 with zero x, B, C, dt
and log-decay, which leaves the carried state exactly as it was (unlike
RWKV6's padding, ROADMAP C3).  Dtypes follow the reference: projections
and the conv in ``x.dtype`` (bfloat16 as served), dt and the SSD in
float32, y cast to ``x.dtype`` before the gated RMS norm and ``silu(z)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import dense_init, rmsnorm

__all__ = ["CONV_K", "HEAD_P", "Mamba2Params", "init_mamba2_layer",
           "init_mamba2_state", "mamba2_decode_step", "mamba2_forward"]

HEAD_P = 64     # head dim
CONV_K = 4      # depthwise conv kernel

#: The leaves used in float32 whatever ``x.dtype``.
FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip", "norm_w")


class Mamba2Params(NamedTuple):
    w_in: torch.Tensor       # (D, 2*Di + 2*N + H) -> z, x, B, C, dt
    conv_w: torch.Tensor     # (K, Di + 2*N) depthwise
    conv_b: torch.Tensor     # (Di + 2*N,)
    a_log: torch.Tensor      # (H,)
    dt_bias: torch.Tensor    # (H,)
    d_skip: torch.Tensor     # (H,)
    norm_w: torch.Tensor     # (Di,) gated RMSNorm
    w_out: torch.Tensor      # (Di, D)


def _dims(cfg):
    di = cfg.d_inner
    return di, cfg.ssm_state, di // HEAD_P


def init_mamba2_layer(generator: torch.Generator, cfg) -> Mamba2Params:
    d = cfg.d_model
    di, n, h = _dims(cfg)
    dev = generator.device
    return Mamba2Params(
        w_in=dense_init(generator, (d, 2 * di + 2 * n + h)),
        conv_w=torch.randn((CONV_K, di + 2 * n), generator=generator, device=dev) * 0.2,
        conv_b=torch.zeros((di + 2 * n,), device=dev),
        a_log=torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        dt_bias=torch.full((h,), -2.0, device=dev),
        d_skip=torch.ones((h,), device=dev),
        norm_w=torch.ones((di,), device=dev),
        w_out=dense_init(generator, (di, d)),
    )


def _split_in(proj, cfg):
    di, n, _ = _dims(cfg)
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv along time. xbc: (B, S, C); conv_state
    (B, K-1, C) or None (zeros). Returns (silu(conv + b), new_state)."""
    k = conv_w.shape[0]
    dt = xbc.dtype
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    else:
        pad = conv_state.to(dt)
    full = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = 0
    for i in range(k):
        out = out + full[:, i:i + s, :] * conv_w[i].to(dt)
    new_state = full[:, -(k - 1):, :]
    return F.silu(out + conv_b.to(dt)), new_state


def _ssd_chunked(xh, bb, cc, dt, la, s0, chunk: int):
    """xh: (B,S,H,P); bb/cc: (B,S,N); dt: (B,S,H); la: (B,S,H) log-decay;
    s0: (B,H,N,P); all float32, S a multiple of ``chunk``.
    Returns (y (B,S,H,P), s_final)."""
    s = xh.shape[1]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    s_prev, ys = s0, []
    for c0 in range(0, s, chunk):
        xb = xh[:, c0:c0 + chunk].transpose(1, 2)                 # (B,H,C,P)
        bbk, ccb = bb[:, c0:c0 + chunk], cc[:, c0:c0 + chunk]     # (B,C,N)
        dtb = dt[:, c0:c0 + chunk].transpose(1, 2)                # (B,H,C)
        la_incl = torch.cumsum(la[:, c0:c0 + chunk].transpose(1, 2), dim=-1)
        g = ccb @ bbk.transpose(1, 2)                             # (B,C,C)
        diff = la_incl[:, :, :, None] - la_incl[:, :, None, :]
        ratio = torch.exp(torch.where(tri, diff, torch.full_like(diff, -torch.inf)))
        m = g[:, None] * ratio * dtb[:, :, None, :]               # (B,H,C,C)
        y_intra = m @ xb
        y_inter = torch.exp(la_incl)[..., None] * (ccb[:, None] @ s_prev)
        la_last = la_incl[:, :, -1]                               # (B,H)
        k_scaled = torch.exp(la_last[:, :, None] - la_incl) * dtb  # (B,H,C)
        s_prev = (s_prev * torch.exp(la_last)[..., None, None]
                  + bbk.transpose(1, 2)[:, None] @ (k_scaled[..., None] * xb))
        ys.append((y_intra + y_inter).transpose(1, 2))            # (B,C,H,P)
    return torch.cat(ys, dim=1), s_prev


def mamba2_forward(p: Mamba2Params, x, state, cfg, chunk: int = 64):
    """Full-sequence Mamba2 block. x: (B,S,D) (pre-normed by the caller);
    state = (conv_state (B,K-1,Di+2N) or None, ssm_state (B,H,N,P))."""
    b, s, _ = x.shape
    di, n, h = _dims(cfg)
    conv_state, s0 = state
    dt_ = x.dtype
    f32 = torch.float32

    proj = x @ p.w_in.to(dt_)
    z, xbc, dt_raw = _split_in(proj, cfg)
    xbc, conv_state_new = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    xh = xbc[..., :di].reshape(b, s, h, HEAD_P)
    bb = xbc[..., di:di + n]
    cc = xbc[..., di + n:]

    dt = _softplus(dt_raw.to(f32) + p.dt_bias.to(f32))            # (B,S,H)
    la = -dt * torch.exp(p.a_log.to(f32))[None, None, :]         # log a_t < 0

    pad = -s % chunk
    xs = (xh, bb, cc, dt, la)
    if pad:
        xs = tuple(F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in xs)
    xh_p, bb_p, cc_p, dt_p, la_p = xs
    y, s_f = _ssd_chunked(xh_p.to(f32), bb_p.to(f32), cc_p.to(f32), dt_p, la_p,
                          s0.to(f32), min(chunk, xh_p.shape[1]))
    y = y[:, :s] + p.d_skip.to(f32)[None, None, :, None] * xh.to(f32)
    y = y.reshape(b, s, di).to(dt_)
    y = rmsnorm(y, p.norm_w.to(f32), cfg.rmsnorm_eps) * F.silu(z)
    return y @ p.w_out.to(dt_), (conv_state_new, s_f)


def mamba2_decode_step(p: Mamba2Params, x, state, cfg):
    """Single-token recurrence. x: (B, 1, D)."""
    b = x.shape[0]
    di, n, h = _dims(cfg)
    conv_state, s0 = state
    dt_ = x.dtype
    f32 = torch.float32

    proj = x @ p.w_in.to(dt_)
    z, xbc, dt_raw = _split_in(proj, cfg)
    xbc, conv_state_new = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    xf = xbc[:, 0, :di].reshape(b, h, HEAD_P).to(f32)
    bf = xbc[:, 0, di:di + n].to(f32)
    cf = xbc[:, 0, di + n:].to(f32)

    dt = _softplus(dt_raw[:, 0].to(f32) + p.dt_bias.to(f32))          # (B,H)
    a = torch.exp(-dt * torch.exp(p.a_log.to(f32))[None, :])          # (B,H)
    s_new = (s0 * a[..., None, None]
             + dt[:, :, None, None] * bf[:, None, :, None] * xf[:, :, None, :])
    y = (cf[:, None, None, :] @ s_new)[:, :, 0]                       # (B,H,P)
    y = y + p.d_skip.to(f32)[None, :, None] * xf
    y = y.reshape(b, 1, di).to(dt_)
    y = rmsnorm(y, p.norm_w.to(f32), cfg.rmsnorm_eps) * F.silu(z)
    return y @ p.w_out.to(dt_), (conv_state_new, s_new)


def init_mamba2_state(batch: int, cfg, dtype=torch.float32, device=None):
    di, n, h = _dims(cfg)
    return (torch.zeros((batch, CONV_K - 1, di + 2 * n), dtype=dtype, device=device),
            torch.zeros((batch, h, n, HEAD_P), dtype=torch.float32, device=device))
