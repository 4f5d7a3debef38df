"""Neuron models (paper C8, Sec II-A), integer mode.

IF and LIF neurons with hard (``V <- 0``) or soft (``V <- V - theta``)
reset.  Integer mode is bit-exact with the digital neuron macro: Vmem is a
(2W-1)-bit signed integer, the leak is an arithmetic right shift, the
threshold compare and conditional-write reset mirror the Store stage.
The float/QAT dynamics wait for the training slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from .quant import QuantSpec, saturate

__all__ = ["NeuronConfig", "neuron_step_int"]


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
