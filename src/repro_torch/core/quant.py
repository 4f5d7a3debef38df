"""Reconfigurable weight/Vmem bit precision (paper C2, Sec II-A).

SpiDR supports three weight/Vmem precision pairs — 4/7, 6/11 and 8/15 bit —
under the invariant ``B_Vmem = 2 * B_weight - 1``.  Weights are signed
two's-complement integers; membrane potentials are signed integers twice
as wide minus one bit.  Integer arithmetic in torch is bit-exact with the
digital datapath, and with ``repro.core.quant``.

QAT: ``ste_quantize`` (per tensor, the training-mode weights) and
``ste_quantize_po2_scaled``/``ste_quantize_po2`` (per-channel power-of-two
scales, the deploy-exact weights) fake-quantize in the forward and pass
the gradient straight through, as the reference's ``custom_vjp``s.  The
power-of-two quantizers ``po2_scale``/``po2_quantize`` and
``requantize_threshold`` are also the exporter's (``snn.export``), so the
integers it emits are by definition the ones training saw.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "PRECISION_PAIRS",
    "QuantSpec",
    "SUPPORTED_PRECISIONS",
    "dequantize",
    "po2_quantize",
    "po2_scale",
    "quantize",
    "requantize_threshold",
    "sat_add",
    "saturate",
    "ste_quantize",
    "ste_quantize_po2",
    "ste_quantize_po2_scaled",
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

    @property
    def neurons_per_row(self) -> int:
        """The 48-column SRAM array packs 48/W_b weights per row (Eq. 1)."""
        return 48 // self.weight_bits


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


# --------------------------------------------------------------------------
# Deploy-exact quantization: power-of-two per-channel scales.
#
# With a power-of-two scale every product and sum of the training graph is
# ``scale * <integer>``, held exactly in float32, so saturation bounds,
# thresholds and the leak shift commute with the scaling.  Every division
# below is tensor by tensor in float32, as the reference's: a CUDA division
# by a Python scalar multiplies by its reciprocal, which rounds otherwise.
# --------------------------------------------------------------------------
def po2_scale(w: torch.Tensor, spec: QuantSpec, axis=None) -> torch.Tensor:
    """Smallest power-of-two scale whose grid covers ``|w|`` per channel.

    Computed as the reference's ``exp2(ceil(log2(amax / w_max)))`` lowers
    on XLA: ``log2(x) = log(x) / log(2)`` and ``exp2(k) = exp(ln2 * k)``, in
    float32 (an all-zero channel gets scale 1).  That is not always the
    exact power of two (ROADMAP C6): a ratio of exactly ``2**-15`` is
    stepped up to ``2**-14``, and ``exp(ln2 * k)`` is off a power of two
    below ``k = -15`` and above ``k = 12``.  The port keeps the reference's
    answer; on the CPU torch's float32 ``log`` and ``exp`` give the same
    exponent for every ratio within 64 ulps of ``2**k``, ``-26 <= k <= 34``,
    and the same scale for ``-125 <= k <= 31``.

    The ``log`` and ``exp`` always run on the CPU (only the per-channel
    ``amax`` is computed where ``w`` lies): CUDA's float32 ``exp`` can miss
    the power of two by an ulp, and then a QAT forward on the card would
    quantize on another grid than the exporter, which runs on the host.
    The result is returned on ``w``'s device.
    """
    w = torch.as_tensor(w).to(torch.float32)
    amax = w.abs().amax() if axis is None else w.abs().amax(dim=axis, keepdim=True)
    amax_host = amax.cpu()
    w_max = torch.full_like(amax_host, float(spec.w_max))
    ratio = torch.where(amax_host == 0, w_max, amax_host) / w_max
    k = torch.ceil(torch.log(ratio) / torch.log(torch.full_like(ratio, 2.0)))
    return torch.exp(torch.full_like(k, math.log(2.0)) * k).to(amax.device)


def po2_quantize(w: torch.Tensor, spec: QuantSpec, axis=None):
    """Symmetric quantization onto a power-of-two grid.

    Returns ``(q, scale)``: ``q`` int8 and ``scale`` a float32 power of two
    (per channel when ``axis`` selects the reduction axis, kept as a size-1
    axis there).
    """
    w = torch.as_tensor(w).to(torch.float32)
    scale = po2_scale(w, spec, axis)
    q = torch.clamp(torch.round(w / scale), spec.w_min, spec.w_max)
    return q.to(torch.int8), scale


def requantize_threshold(threshold, scale: torch.Tensor, spec: QuantSpec):
    """Fold a float firing threshold onto a layer's integer Vmem grid.

    Returns ``(thr_int, thr_scaled)`` with ``thr_scaled = thr_int * scale``
    exactly (power-of-two ``scale``).  ``thr_int`` is clipped to
    ``[v_min, v_max + 1]``: above ``v_max`` the saturated Vmem never reaches
    it (the neuron never fires), below ``v_min`` it always fires.
    """
    scale = torch.as_tensor(scale).to(torch.float32)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=scale.device)
    t = torch.clamp(torch.round(thr / scale), spec.v_min, spec.v_max + 1)
    return t.to(torch.int32), t * scale


# --------------------------------------------------------------------------
# QAT: straight-through estimators.  Forward = fake-quantized weights,
# backward = identity into ``w``.
# --------------------------------------------------------------------------
class _SteQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, weight_bits):
        return dequantize(*quantize(w, QuantSpec(weight_bits)))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SteQuantizePo2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, weight_bits, axis):
        q, scale = po2_quantize(w, QuantSpec(weight_bits), axis)
        ctx.mark_non_differentiable(scale)
        return dequantize(q, scale), scale

    @staticmethod
    def backward(ctx, g, _g_scale):
        return g, None, None


def ste_quantize(w: torch.Tensor, weight_bits: int) -> torch.Tensor:
    """Per-tensor fake-quant ``dequantize(*quantize(w))``; identity gradient."""
    return _SteQuantize.apply(w, weight_bits)


def ste_quantize_po2_scaled(w: torch.Tensor, weight_bits: int, axis=0):
    """Deploy-exact fake-quant: per-channel power-of-two scales, STE grad.

    Returns ``(q * scale, scale)``: the exact float image of the integers
    the exporter emits, and the scale it used (the saturation bounds and
    the threshold requantization need it).  The gradient into ``w`` is the
    identity; the scale output carries none.
    """
    return _SteQuantizePo2.apply(w, weight_bits, axis)


def ste_quantize_po2(w: torch.Tensor, weight_bits: int, axis=0) -> torch.Tensor:
    """``ste_quantize_po2_scaled`` without the scale output."""
    return ste_quantize_po2_scaled(w, weight_bits, axis)[0]
