"""Neuron models (paper C8, Sec II-A).

IF and LIF neurons with hard (``V <- 0``) or soft (``V <- V - theta``)
reset, in two modes:

  * integer mode — bit-exact with the digital neuron macro: Vmem is a
    (2W-1)-bit signed integer, the leak is an arithmetic right shift, the
    threshold compare and conditional-write reset mirror the Store stage;
  * float mode — the training-mode forward: multiplicative leak, and the
    spike is the forward of the reference's surrogate-gradient Heaviside
    (``spike_surrogate``).  The surrogate gradient and the deploy-exact
    QAT step come with the training slice (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from .quant import QuantSpec, saturate

__all__ = ["NeuronConfig", "if_step", "lif_step", "neuron_step", "neuron_step_int"]


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


def neuron_step(v: torch.Tensor, current: torch.Tensor, cfg: NeuronConfig):
    """One float timestep of the neuron macro; returns ``(v_next, spikes)``.

    Order as in the macro: (leak), partial->full Vmem accumulation,
    threshold compare, conditional-write reset.  The spike is the forward
    of the reference's ``spike_surrogate``, with the threshold taken in
    ``v``'s dtype, as the reference does.
    """
    if cfg.model == "lif":
        v = v * cfg.leak
    v = v + current
    s = (v >= torch.tensor(cfg.threshold, dtype=v.dtype)).to(v.dtype)
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
