"""Reconfigurable weight/Vmem bit precision (paper C2, Sec II-A).

SpiDR supports three weight/Vmem precision pairs — 4/7, 6/11 and 8/15 bit —
under the invariant ``B_Vmem = 2 * B_weight - 1``.  Weights are signed
two's-complement integers; membrane potentials are signed integers twice
as wide minus one bit.  Integer arithmetic in torch is bit-exact with the
digital datapath, and with ``repro.core.quant``.

The QAT / straight-through parts of the reference module belong to the
training slice of the port and are not here yet.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "PRECISION_PAIRS",
    "QuantSpec",
    "SUPPORTED_PRECISIONS",
    "dequantize",
    "quantize",
    "sat_add",
    "saturate",
]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Weight/Vmem precision pair. ``vmem_bits = 2*weight_bits - 1``."""

    weight_bits: int

    def __post_init__(self):
        if self.weight_bits not in (4, 6, 8):
            raise ValueError(
                f"SpiDR supports 4/6/8-bit weights, got {self.weight_bits}")

    @property
    def vmem_bits(self) -> int:
        return 2 * self.weight_bits - 1

    @property
    def w_min(self) -> int:
        return -(1 << (self.weight_bits - 1))

    @property
    def w_max(self) -> int:
        return (1 << (self.weight_bits - 1)) - 1

    @property
    def v_min(self) -> int:
        return -(1 << (self.vmem_bits - 1))

    @property
    def v_max(self) -> int:
        return (1 << (self.vmem_bits - 1)) - 1


SUPPORTED_PRECISIONS = tuple(QuantSpec(b) for b in (4, 6, 8))

# The silicon's supported (B_weight, B_vmem) pairs: the single source of
# truth for precision validation in this package (``spidr.DeployTarget``).
PRECISION_PAIRS = tuple(
    (s.weight_bits, s.vmem_bits) for s in SUPPORTED_PRECISIONS)


def _scale_for(w: torch.Tensor, spec: QuantSpec, axis=None) -> torch.Tensor:
    w = w.to(torch.float32)
    if axis is None:
        amax = w.abs().amax()
    else:
        amax = w.abs().amax(dim=axis, keepdim=True)
    # All-zero tensors/channels get scale 1/w_max instead of dividing by 0.
    amax = torch.where(amax == 0, torch.ones_like(amax), amax)
    return amax / spec.w_max


def quantize(w: torch.Tensor, spec: QuantSpec, axis=None):
    """Symmetric quantization of float weights to signed ints.

    Returns ``(q, scale)``: ``q`` int8, ``scale`` float32 and
    ``w ≈ q * scale``.  The division and the round-half-to-even are done
    in float32, as the reference does, so ``q`` matches it bit for bit.
    """
    scale = _scale_for(w, spec, axis)
    q = torch.clamp(torch.round(w.to(torch.float32) / scale),
                    spec.w_min, spec.w_max)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def saturate(v: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Clamp to the Vmem representable range (column adder saturation)."""
    return torch.clamp(v, spec.v_min, spec.v_max)


def sat_add(v: torch.Tensor, w: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """One weight->Vmem accumulation at Vmem precision (saturating)."""
    return saturate(v.to(torch.int32) + w.to(torch.int32), spec)
