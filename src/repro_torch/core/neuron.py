"""Neuron models (paper C8, Sec II-A).

IF and LIF neurons with hard (``V <- 0``) or soft (``V <- V - theta``)
reset, in two modes:

  * integer mode — bit-exact with the digital neuron macro: Vmem is a
    (2W-1)-bit signed integer, the leak is an arithmetic right shift, the
    threshold compare and conditional-write reset mirror the Store stage;
  * float mode — surrogate-gradient training: multiplicative leak, and
    the spike is ``spike_surrogate``, a Heaviside whose gradient is the
    reference's triangle;
  * deploy-exact QAT (``neuron_step_qat``) — float, differentiable, and
    the exact scaled image of the integer step under a power-of-two scale.

The QAT step's clips use ``_clip``, whose gradient at a bound is 0.5, as
``jnp.clip``'s (``lax.max``/``lax.min`` split ties): ``torch.clamp`` gives
1 there, and QAT values land on the bounds often, because they lie on the
``scale * integer`` grid.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from .quant import QuantSpec, saturate

__all__ = [
    "NeuronConfig",
    "if_step",
    "lif_step",
    "neuron_step",
    "neuron_step_int",
    "neuron_step_qat",
    "spike_surrogate",
]


@dataclasses.dataclass(frozen=True)
class NeuronConfig:
    model: Literal["if", "lif"] = "if"
    reset: Literal["hard", "soft"] = "hard"
    threshold: float = 1.0
    # LIF leak: float mode multiplies by ``leak``; integer mode right-shifts
    # by ``leak_shift`` (V <- V - (V >> leak_shift)), the digital LIF.
    leak: float = 0.9
    leak_shift: int = 3
    surrogate_width: float = 1.0

    def __post_init__(self):
        if self.model not in ("if", "lif"):
            raise ValueError(f"neuron model must be 'if' or 'lif', got {self.model!r}")
        if self.reset not in ("hard", "soft"):
            raise ValueError(f"reset must be 'hard' or 'soft', got {self.reset!r}")


# --------------------------------------------------------------------------
# Surrogate-gradient spike function (triangle / piecewise-linear surrogate).
# --------------------------------------------------------------------------
class _SpikeSurrogate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, threshold, width):
        ctx.save_for_backward(v, threshold)
        ctx.width = width
        return (v >= threshold).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        v, threshold = ctx.saved_tensors
        x = (v - threshold) / ctx.width
        dv = g * (torch.clamp_min(1.0 - x.abs(), 0.0) / ctx.width)
        # A per-channel threshold broadcasts against v: reduce the cotangent
        # back to its shape (sum over the broadcast axes).
        extra = tuple(range(dv.ndim - threshold.ndim))
        dthr = -(dv.sum(dim=extra) if extra else dv)
        return dv, dthr, None


def spike_surrogate(v: torch.Tensor, threshold, width: float = 1.0) -> torch.Tensor:
    """Heaviside ``v >= threshold`` in ``v``'s dtype; gradient the triangle
    ``max(0, 1 - |x|) / width`` with ``x = (v - threshold) / width``.

    ``threshold`` is a number, a 0-d tensor or a per-channel tensor
    broadcast against ``v`` on its trailing axes; its gradient is reduced
    to its shape.
    """
    threshold = torch.as_tensor(threshold, dtype=v.dtype, device=v.device)
    return _SpikeSurrogate.apply(v, threshold, width)


class _FloorSte(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.floor(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _floor_ste(x: torch.Tensor) -> torch.Tensor:
    """``floor(x)`` with a pass-through gradient: the digital leak shift
    ``V <- V - (V >> k)`` on the scaled grid contributes ``1 - 2**-k``."""
    return _FloorSte.apply(x)


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient: 1 inside, 0.5 at a bound
    (``maximum``/``minimum`` split a tie, as ``lax.max``/``lax.min`` do),
    0 outside."""
    return torch.minimum(torch.maximum(x, lo), hi)


# --------------------------------------------------------------------------
# Float-mode dynamics (training path).
# --------------------------------------------------------------------------
def neuron_step(v: torch.Tensor, current: torch.Tensor, cfg: NeuronConfig):
    """One float timestep of the neuron macro; returns ``(v_next, spikes)``.

    Order as in the macro: (leak), partial->full Vmem accumulation,
    threshold compare, conditional-write reset.  The spike is
    ``spike_surrogate`` with the threshold taken in ``v``'s dtype, as the
    reference does.
    """
    if cfg.model == "lif":
        v = v * cfg.leak
    v = v + current
    s = spike_surrogate(v, cfg.threshold, cfg.surrogate_width)
    if cfg.reset == "hard":
        v_next = v * (1.0 - s)
    else:
        v_next = v - s * cfg.threshold
    return v_next, s


def if_step(v, current, cfg: NeuronConfig | None = None):
    return neuron_step(v, current, cfg or NeuronConfig(model="if"))


def lif_step(v, current, cfg: NeuronConfig | None = None):
    return neuron_step(v, current, cfg or NeuronConfig(model="lif"))


def neuron_step_int(v: torch.Tensor, partial_vmem: torch.Tensor,
                    cfg: NeuronConfig, spec: QuantSpec, threshold_int):
    """Bit-exact neuron macro step; returns ``(v_next, spikes)`` int32.

    ``threshold_int`` is an int or a tensor broadcast against ``v`` (a
    ``(N,)`` per-channel vector on the last axis).  The macro adds the
    partial (saturating), optionally leaks by a shift, compares against the
    integer threshold and resets in the Store stage.
    """
    v = v.to(torch.int32)
    if cfg.model == "lif":
        # Digital leak: V <- V - (V >> k); torch's >> on int32 is an
        # arithmetic shift, so it floors for negative Vmem.
        v = v - (v >> cfg.leak_shift)
    v = saturate(v + partial_vmem.to(torch.int32), spec)
    s = (v >= threshold_int).to(torch.int32)
    if cfg.reset == "hard":
        v_next = v * (1 - s)
    else:
        v_next = saturate(v - s * threshold_int, spec)
    return v_next, s


# --------------------------------------------------------------------------
# Deploy-exact QAT dynamics: float forward, surrogate gradients, the exact
# scaled image of ``neuron_step_int`` under a power-of-two ``scale``.
# --------------------------------------------------------------------------
def neuron_step_qat(v: torch.Tensor, current: torch.Tensor, cfg: NeuronConfig,
                    spec: QuantSpec, scale: torch.Tensor,
                    threshold_scaled: torch.Tensor):
    """One deploy-exact QAT timestep: ``(v_next, spikes)``.

    ``v`` and ``current`` are floats of the form ``scale * <integer>``
    (``current`` already saturated to the scaled Vmem range by the layer);
    ``scale`` is the layer's power-of-two weight scale and
    ``threshold_scaled = scale * thr_int`` the requantized threshold, both
    without gradient.  Every operation computes ``scale *`` (the integer
    datapath's operation) exactly, so the spike train is bit-identical to
    ``neuron_step_int`` on the folded integers, while gradients flow
    through the triangle surrogate, the clips and the STE floor of the leak.

    The leak applies only when ``leak_shift > 0`` (shift 0 means no leak,
    as in the engine and the kernels).
    """
    scale = scale.detach()
    threshold_scaled = threshold_scaled.detach()
    lo, hi = scale * spec.v_min, scale * spec.v_max
    if cfg.model == "lif" and cfg.leak_shift > 0:
        # V <- V - (V >> k): the arithmetic shift floors, here on the grid.
        v = v - scale * _floor_ste(v / scale * (2.0 ** -cfg.leak_shift))
    v = _clip(v + current, lo, hi)
    s = spike_surrogate(v, threshold_scaled, cfg.surrogate_width)
    if cfg.reset == "hard":
        v_next = v * (1.0 - s)
    else:
        v_next = _clip(v - s * threshold_scaled, lo, hi)
    return v_next, s
