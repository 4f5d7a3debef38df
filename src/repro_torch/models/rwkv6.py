"""RWKV6 "Finch": attention-free time-mix with data-dependent decay.

The counterpart of ``repro.models.rwkv6``.  Per head (head size N = 64),
with a data-dependent per-channel decay ``w_t`` in (0,1)^N and bonus ``u``:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Prefill uses the chunked parallel form: on the card the hand-written CUDA
kernel B7 (``kernels/wkv_chunk.py``, one launch per layer for the whole
sequence), elsewhere its plain PyTorch version (``kernels.ref``), which is
also ``_wkv_chunked`` here: there is one plain wkv, not two.  Under
autograd the kernel route runs B7 in :class:`_WkvSequenceTrain`, whose
backward differentiates the plain version.  Decode is the plain recurrence
and needs no kernel.

Dtypes follow the reference: the token shift (ddlerp), projections,
channel-mix and ``ln_x`` run in ``x.dtype`` (bfloat16 when serving), the
decay (``_decay_log``) and the wkv state in float32, and the per-head
group norm sees the float32 wkv output.  Every weight is cast to the dtype
it is used in at the point of use, as the reference does; casting them
once beforehand (``model.serving_params``) makes those casts no-ops.

While a mesh is armed (the dry run), r, k, v and the state are pinned
heads-over-'model' at the reference's sites, and the chunk loop runs on
each rank's (batch, head) block (``sharding.local_call``): the
reference pins the carried state to that layout at every chunk, so the
loop needs no collective.  The wkv then takes the plain route, since B7's
launch takes neither a fake tensor nor a DTensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import sharding
from ..kernels import ref as kref
from ..kernels.wkv_chunk import wkv_sequence
from .common import dense_init, rmsnorm

__all__ = [
    "HEAD_SIZE",
    "RWKV6Params",
    "init_rwkv6_layer",
    "init_rwkv6_state",
    "rwkv6_channel_mix",
    "rwkv6_channel_mix_decode",
    "rwkv6_time_mix",
    "rwkv6_time_mix_decode",
]

TM_RANK = 32
TD_RANK = 64
HEAD_SIZE = 64
PAD_LOG_DECAY = -0.1  # log-decay of the padding tokens of a ragged prefill


class RWKV6Params(NamedTuple):
    # time-mix ddlerp
    mu_x: torch.Tensor      # (D,)
    tm_w1: torch.Tensor     # (D, 5*TM_RANK)
    tm_w2: torch.Tensor     # (5, TM_RANK, D)
    mu_rkvwg: torch.Tensor  # (5, D)
    # projections
    wr: torch.Tensor        # (D, D)
    wk: torch.Tensor
    wv: torch.Tensor
    wg: torch.Tensor
    wo: torch.Tensor
    # decay
    td_w1: torch.Tensor     # (D, TD_RANK)
    td_w2: torch.Tensor     # (TD_RANK, D)
    time_decay: torch.Tensor  # (D,)
    bonus_u: torch.Tensor     # (D,)
    ln_x: torch.Tensor        # (D,) per-head groupnorm scale
    # channel-mix
    cm_mu_k: torch.Tensor   # (D,)
    cm_mu_r: torch.Tensor   # (D,)
    cm_wk: torch.Tensor     # (D, F)
    cm_wv: torch.Tensor     # (F, D)
    cm_wr: torch.Tensor     # (D, D)


#: The leaves the reference always uses in float32, whatever ``x.dtype``.
FLOAT32_LEAVES = ("td_w1", "td_w2", "time_decay", "bonus_u")


def init_rwkv6_layer(generator: torch.Generator, cfg, n_layers: int | None = None
                     ) -> RWKV6Params:
    """The reference's init; with ``n_layers`` every leaf gets a leading
    layer axis, drawn at once (no per-layer copies to stack)."""
    d, f = cfg.d_model, cfg.d_ff
    lead = () if n_layers is None else (n_layers,)
    dev = generator.device

    def full(shape, value):
        return torch.full(lead + shape, value, device=dev)

    def normal(shape, std):
        return torch.randn(lead + shape, generator=generator, device=dev) * std

    def dense(shape):
        return dense_init(generator, lead + shape)

    return RWKV6Params(
        mu_x=full((d,), 0.5),
        tm_w1=dense((d, 5 * TM_RANK)),
        tm_w2=normal((5, TM_RANK, d), 0.01),
        mu_rkvwg=full((5, d), 0.5),
        wr=dense((d, d)),
        wk=dense((d, d)),
        wv=dense((d, d)),
        wg=dense((d, d)),
        wo=dense((d, d)),
        td_w1=dense((d, TD_RANK)),
        td_w2=normal((TD_RANK, d), 0.01),
        time_decay=full((d,), -2.0),
        bonus_u=normal((d,), 0.1),
        ln_x=full((d,), 1.0),
        cm_mu_k=full((d,), 0.5),
        cm_mu_r=full((d,), 0.5),
        cm_wk=dense((d, f)),
        cm_wv=dense((f, d)),
        cm_wr=dense((d, d)),
    )


def _ddlerp(p: RWKV6Params, x, x_prev):
    """Finch data-dependent token shift -> [xr, xk, xv, xw, xg]."""
    dt = x.dtype
    sx = x_prev - x
    xxx = x + sx * p.mu_x.to(dt)
    lora = torch.tanh(xxx @ p.tm_w1.to(dt))
    if sharding.armed():  # the 5 x rank dim whole before it is split
        lora = sharding.constrain(lora, "dp", *([None] * (lora.dim() - 1)))
    lora = lora.reshape(*lora.shape[:-1], 5, TM_RANK)
    mix = torch.einsum("...nr,nrd->...nd", lora, p.tm_w2.to(dt))
    streams = x[..., None, :] + sx[..., None, :] * (p.mu_rkvwg.to(dt) + mix)
    return [streams[..., i, :] for i in range(5)]


def _decay_log(p: RWKV6Params, xw):
    """log(w_t) = -exp(time_decay + lora(xw)), in float32; always < 0."""
    f32 = torch.float32
    ww = torch.tanh(xw.to(f32)) @ p.td_w1.to(f32)
    ww = ww @ p.td_w2.to(f32)
    return -torch.exp(p.time_decay.to(f32) + ww)


def _wkv_chunked(r, k, v, lw, u, s0, chunk: int):
    """Chunked wkv over a full sequence, plain PyTorch.

    r/k/v/lw: (B, S, H, N) float32; u: (H, N); s0: (B, H, N, N).
    Returns (y (B, S, H, N), s_final (B, H, N, N)).
    """
    return kref.wkv_sequence_ref(r, k, v, lw, u, s0, chunk)


def _wkv_backward(chunk, inputs, needs, grads):
    """Gradients of the plain wkv (``kernels.ref``) at ``inputs`` for the
    ones ``needs`` marks, given the output cotangents ``grads`` (None where
    an output got none)."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
        outs = kref.wkv_sequence_ref(*xs, chunk)
        outs, grads = zip(*[(o, g) for o, g in zip(outs, grads) if g is not None])
        got = iter(torch.autograd.grad(outs, [x for x in xs if x.requires_grad], grads))
    return [next(got) if n else None for n in needs]


class _WkvSequenceTrain(torch.autograd.Function):
    """The wkv on B7 (``wkv_sequence``) with a gradient.

    Forward: the kernel, unchanged (on CPU tensors its plain version).
    Backward: the plain ``wkv_sequence_ref`` recomputed on the saved inputs
    and differentiated by autograd; no kernel launches.  The reference has
    no backward kernel and its Pallas kernel cannot be differentiated
    (ROADMAP C14), so the backward is plain by design, as B3's
    (``core.layers._FusedLifGemmTrain``).
    """

    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0, chunk: int):
        ctx.save_for_backward(r, k, v, lw, u, s0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return wkv_sequence(r, k, v, lw, u, s0, chunk=chunk)

    @staticmethod
    def backward(ctx, g_y, g_s):
        grads = _wkv_backward(ctx.chunk, ctx.saved_tensors, ctx.needs_input_grad[:6],
                              (g_y, g_s))
        return (*grads, None)


def _wkv_kernel_path(r, k, v, lw, u, s0, chunk: int):
    """The wkv through the CUDA kernel B7 (its plain version on the CPU);
    under :class:`_WkvSequenceTrain` when autograd needs its gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, lw, u, s0)):
        return _WkvSequenceTrain.apply(r, k, v, lw, u, s0, chunk)
    return wkv_sequence(r, k, v, lw, u, s0, chunk=chunk)


def _time_mix_inputs(p: RWKV6Params, x, x_prev):
    """Token shift and projections of a full sequence x (B, S, D):
    (r, k, v, lw) as (B, S, H, N) -- r, k, v in x.dtype, lw float32 -- and
    the gate g (B, S, D)."""
    b, s, d = x.shape
    h, n = d // HEAD_SIZE, HEAD_SIZE
    xs = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    xr, xk, xv, xw, xg = _ddlerp(p, x, xs)
    dt = x.dtype
    r = sharding.constrain((xr @ p.wr.to(dt)).reshape(b, s, h, n), "dp", None, "model", None)
    k = sharding.constrain((xk @ p.wk.to(dt)).reshape(b, s, h, n), "dp", None, "model", None)
    v = sharding.constrain((xv @ p.wv.to(dt)).reshape(b, s, h, n), "dp", None, "model", None)
    g = F.silu(xg @ p.wg.to(dt))
    lw = _decay_log(p, xw).reshape(b, s, h, n)
    return r, k, v, lw, g


def _pad_to_chunk(r, k, v, lw, chunk: int):
    """Right-pad the sequence axis to a multiple of ``chunk``: r = k = v = 0
    and log-decay ``PAD_LOG_DECAY``, as the reference does.  The final
    state of the padded sequence is what the prefill returns, so a ragged
    prompt leaves it decayed by exp(-0.1 * pad)."""
    pad = -r.shape[1] % chunk
    if pad:
        spec = (0, 0, 0, 0, 0, pad)
        r, k, v = (F.pad(t, spec) for t in (r, k, v))
        lw = F.pad(lw, spec, value=PAD_LOG_DECAY)
    return r, k, v, lw


def _time_mix_output(p: RWKV6Params, y, g, dt):
    """Per-head group norm of the float32 wkv output y (B, S, H, N), the
    ``ln_x`` scale, the gate and the output projection."""
    b, s, h, n = y.shape
    y = rmsnorm(y, y.new_ones(n), 64e-5).reshape(b, s, h * n)
    y = (y.to(dt) * p.ln_x.to(dt)) * g
    return y @ p.wo.to(dt)


def rwkv6_time_mix(p: RWKV6Params, x, x_prev, s0, cfg, chunk: int = 32,
                   use_kernel: bool | None = None):
    """Full-sequence time-mix. x: (B,S,D). Returns (y, x_last, s_final).

    ``use_kernel`` selects the wkv kernel path (``kernels/wkv_chunk.py``);
    the default ``None`` means "the tensors are on CUDA and no mesh is
    armed", the counterpart of the reference's "on a TPU".  On CPU tensors
    the kernel path runs the kernel's plain version.
    """
    s = x.shape[1]
    r, k, v, lw, g = _time_mix_inputs(p, x, x_prev)
    h, n = r.shape[2], r.shape[3]
    f32 = torch.float32
    u = sharding.constrain(p.bonus_u.to(f32), None).reshape(h, n)
    s0 = sharding.constrain(s0.to(f32), "dp", "model", None, None)
    if use_kernel is None:
        use_kernel = x.is_cuda and not sharding.armed()
    wkv_fn = _wkv_kernel_path if use_kernel else _wkv_chunked

    def wkv(r, k, v, lw, u, s0):
        r, k, v, lw = _pad_to_chunk(r.to(f32), k.to(f32), v.to(f32), lw, chunk)
        y, s_f = wkv_fn(r, k, v, lw, u, s0, min(chunk, r.shape[1]))
        return y[:, :s], s_f

    specs = ()
    if sharding.armed():  # (B, S, H, N) blocks of (batch, head)
        sp = sharding.resolve(r.shape, "dp", None, "model", None)
        st = (sp[0], sp[2], None, None)
        specs = ((sp, sp, sp, sp, (sp[2], None), st), (sp, st))
    y, s_f = sharding.local_call(wkv, (r, k, v, lw, u, s0), *specs)
    out = _time_mix_output(p, y, g, x.dtype)
    return out, x[:, -1, :], s_f


def rwkv6_channel_mix(p: RWKV6Params, x, x_prev):
    """Finch channel-mix (squared-relu FFN with token shift)."""
    xs = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    sx = xs - x
    dt = x.dtype
    xk = x + sx * p.cm_mu_k.to(dt)
    xr = x + sx * p.cm_mu_r.to(dt)
    k = torch.square(torch.relu(xk @ p.cm_wk.to(dt)))
    kv = k @ p.cm_wv.to(dt)
    r = torch.sigmoid(xr @ p.cm_wr.to(dt))
    return r * kv, x[:, -1, :]


def rwkv6_channel_mix_decode(p: RWKV6Params, x, x_prev):
    """Single-token channel mix. x: (B, 1, D); x_prev: (B, D)."""
    out, _ = rwkv6_channel_mix(p, x, x_prev)
    return out, x[:, -1, :]


def rwkv6_time_mix_decode(p: RWKV6Params, x, x_prev, s0, cfg):
    """Single-token time-mix via the plain recurrence. x: (B, 1, D).

    Returns (out, x_last, s_new), the contract of rwkv6_time_mix.
    """
    b, _, d = x.shape
    h, n = d // HEAD_SIZE, HEAD_SIZE
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev[:, None, :])
    dt = x.dtype
    f32 = torch.float32
    r = (xr @ p.wr.to(dt)).reshape(b, h, n).to(f32)
    k = (xk @ p.wk.to(dt)).reshape(b, h, n).to(f32)
    v = (xv @ p.wv.to(dt)).reshape(b, h, n).to(f32)
    g = F.silu(xg @ p.wg.to(dt)).reshape(b, 1, d)
    w = torch.exp(_decay_log(p, xw)).reshape(b, h, n)
    u = sharding.constrain(p.bonus_u.to(f32), None).reshape(h, n)

    def step(r, k, v, w, u, s0):
        kv = k[..., :, None] * v[..., None, :]                  # (B,H,N,N)
        y = torch.einsum("bhn,bhnm->bhm", r, s0 + u[None, :, :, None] * kv)
        return y, s0 * w[..., None] + kv

    specs = ()
    if sharding.armed():  # each rank's (batch, head) block of the state
        st = sharding.resolve(s0.shape, "dp", "model", None, None)
        bh = st[:3]
        specs = ((bh, bh, bh, bh, (st[1], None), st), (bh, st))
    y, s_new = sharding.local_call(step, (r, k, v, w, u, s0), *specs)
    y = rmsnorm(y.reshape(b, 1, h, n), y.new_ones(n), 64e-5).reshape(b, 1, d)
    y = (y.to(dt) * p.ln_x.to(dt)) * g
    return y @ p.wo.to(dt), x[:, -1, :], s_new


def init_rwkv6_state(batch: int, d_model: int, dtype=torch.float32, device=None):
    h, n = d_model // HEAD_SIZE, HEAD_SIZE
    return (
        torch.zeros((batch, d_model), dtype=dtype, device=device),
        torch.zeros((batch, d_model), dtype=dtype, device=device),
        torch.zeros((batch, h, n, n), dtype=torch.float32, device=device),
    )
