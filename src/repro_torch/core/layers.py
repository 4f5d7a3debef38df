"""Functional spiking layers (paper C5 + C1: input loader + macro compute).

The input loader performs im2col in hardware, zero padding and stride
included, so a spiking convolution becomes a spike-matrix x weight-matrix
product:

    spikes (B, H, W, C) --im2col--> (B, P, kh*kw*C)   fan-in order (kh, kw, c)
    weights (kh*kw*C, K)           HWIO-flattened, the same fan-in order
    Vmem, spikes = neuron step of (Vmem, cols @ W)

Two execution contracts of the reference, both differentiable end to end:

  * ``mode="train"`` — float weights fake-quantized per tensor
    (``ste_quantize``), float Vmem, the float neuron step with the
    surrogate spike.  On CUDA tensors one layer-timestep is one launch of
    the fused float kernel (B3, ``kernels.fused_lif_gemm.fused_lif_gemm``)
    under ``_FusedLifGemmTrain``, whose backward is plain PyTorch; on CPU
    tensors, or when a ``matmul`` is injected (the reference's hook for a
    spike-GEMM kernel), it is the plain composition ``matmul`` +
    ``neuron_step``.
  * ``mode="qat"`` — deploy-exact QAT: per-channel power-of-two fake
    quant, the product in ``_exact_matmul``, scaled saturation and the
    digital leak shift, so the forward spike train is bit-identical to the
    exported integer engine (``snn.export``).  It runs on no kernel: the
    fused float kernel's sums are not exact.

``mode="int"`` is not ported: the integer datapath is the engine
(``engine/inference.py``), and the reference's integer layers cannot be
reached through its ``run_snn`` (ROADMAP C2).

Activations stay NHWC, as in the reference, so tests compare like with
like.  (``torch.nn.functional.unfold`` on NCHW would order the fan-in
``(c, kh, kw)``; the patches here come from ``Tensor.unfold`` on the
padded NHWC plane and are permuted to ``(kh, kw, c)``.)  ``maxpool2d``
sends its gradient to the first maximum of each window in row-major
order, as the reference's ``reduce_window`` does: spikes are 0/1, so ties
are the rule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..kernels.fused_lif_gemm import fused_lif_gemm
from .neuron import NeuronConfig, _clip, neuron_step, neuron_step_qat
from .quant import QuantSpec, requantize_threshold, ste_quantize, ste_quantize_po2_scaled

__all__ = [
    "SpikingConvParams",
    "SpikingDenseParams",
    "im2col",
    "init_conv",
    "init_dense",
    "maxpool2d",
    "spiking_conv",
    "spiking_dense",
]


@dataclasses.dataclass(frozen=True)
class SpikingConvParams:
    kh: int
    kw: int
    stride: int = 1
    padding: int = 1
    neuron: NeuronConfig = dataclasses.field(default_factory=NeuronConfig)


@dataclasses.dataclass(frozen=True)
class SpikingDenseParams:
    neuron: NeuronConfig = dataclasses.field(default_factory=NeuronConfig)


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """(B, H, W, C) -> (B, H_out*W_out, kh*kw*C) patches, dtype kept.

    Feature order is ``(kh, kw, c)`` to match HWIO weights.  The engine
    passes int8 spike planes, so the patch matrix is one byte per entry.
    """
    b, h, w, c = x.shape
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    h_out = (h + 2 * padding - kh) // stride + 1
    w_out = (w + 2 * padding - kw) // stride + 1
    # (B, H_out, W_out, C, kh, kw) view -> (B, H_out, W_out, kh, kw, C).
    patches = x.unfold(1, kh, stride).unfold(2, kw, stride)
    patches = patches.permute(0, 1, 2, 4, 5, 3)
    return patches.reshape(b, h_out * w_out, kh * kw * c)


def _maxpool_forward(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    patches = x.unfold(1, window, stride).unfold(2, window, stride)
    return patches.amax(dim=(-2, -1))


class _MaxPoolFirst(torch.autograd.Function):
    """Max-pool whose gradient goes to the first maximum of each window."""

    @staticmethod
    def forward(ctx, x, window, stride):
        ctx.save_for_backward(x)
        ctx.window, ctx.stride = window, stride
        return _maxpool_forward(x, window, stride)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        k, st = ctx.window, ctx.stride
        b, h, w, c = x.shape
        patches = x.unfold(1, k, st).unfold(2, k, st)  # (B, Ho, Wo, C, k, k)
        ho, wo = patches.shape[1], patches.shape[2]
        # argmax returns the first maximal index: row-major in the window.
        first = patches.reshape(b, ho, wo, c, k * k).argmax(dim=-1)
        rows = torch.arange(ho, device=x.device).view(1, ho, 1, 1) * st + first // k
        cols = torch.arange(wo, device=x.device).view(1, 1, wo, 1) * st + first % k
        index = (rows * w + cols).reshape(b, ho * wo, c)
        dx = torch.zeros((b, h * w, c), dtype=g.dtype, device=g.device)
        dx.scatter_add_(1, index, g.reshape(b, ho * wo, c))
        return dx.reshape(b, h, w, c), None, None


def maxpool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """NHWC max-pool over VALID windows (the reference's ``reduce_window``).

    Any dtype (the engine pools int8 planes).  The gradient goes to the
    first maximum of each window in row-major order, as ``reduce_window``'s
    does; ``unfold`` + ``amax`` alone would split it among tied maxima.
    """
    if x.requires_grad:
        return _MaxPoolFirst.apply(x, window, stride)
    return _maxpool_forward(x, window, stride)


def init_conv(generator: torch.Generator, kh: int, kw: int, c_in: int,
              c_out: int, gain: float = 3.0) -> torch.Tensor:
    """Uniform ``±gain/sqrt(kh*kw*c_in)`` float32 ``(kh*kw*c_in, c_out)``
    weights, on the generator's device (SNNs need hotter init than ANNs to
    fire at event-camera sparsity)."""
    return init_dense(generator, kh * kw * c_in, c_out, gain)


def init_dense(generator: torch.Generator, n_in: int, n_out: int,
               gain: float = 3.0) -> torch.Tensor:
    """Uniform ``±gain/sqrt(n_in)`` float32 ``(n_in, n_out)`` weights."""
    scale = gain / math.sqrt(n_in)
    u = torch.rand((n_in, n_out), generator=generator, device=generator.device,
                   dtype=torch.float32)
    return u * (2 * scale) - scale


def _check_mode(mode: str) -> None:
    if mode not in ("train", "qat"):
        raise NotImplementedError(
            f"mode={mode!r} is not ported: the integer datapath is the engine "
            "(engine.build_engine), and the reference's run_snn cannot reach "
            "its integer layers (ROADMAP C2)")


def _f64_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` computed in float64 and rounded once to float32.

    No global precision switch reaches a float64 product: neither
    ``torch.backends.cuda.matmul.allow_tf32`` nor
    ``torch.set_float32_matmul_precision``.
    """
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.float32)


class _ExactMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _f64_matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return _f64_matmul(g, b.T), _f64_matmul(a.T, g)


def _exact_matmul(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(rows, F) x (F, K)`` for the deploy-exact QAT path, exact.

    The contract needs every partial sum held exactly as ``scale *
    <integer>``: with 0/1 spikes and ``|q| <= 127`` the integer stays below
    ``K * 127 < 2**24`` for any fan-in the nets have, so a full-fp32 sum in
    any order is exact (the reference pins ``Precision.HIGHEST``).  TF32
    keeps 10 mantissa bits and is not, so the product is taken in float64
    (exact, rounded once to the same float32) whatever the global TF32
    switch says; its backward too.
    """
    return _ExactMatmul.apply(spikes.to(torch.float32), w)


class _FusedLifGemmTrain(torch.autograd.Function):
    """The float layer-timestep on B3 (``fused_lif_gemm``), with a gradient.

    Forward: the CUDA kernel, unchanged (it raises if it cannot launch).
    Backward, plain PyTorch, as the reference's autodiff of ``einsum`` +
    ``neuron_step``: recompute the pre-reset Vmem ``leak * v + cols @ wq``
    (the product in float64, no TF32), apply the triangle surrogate at the
    kernel's spikes, and with ``dv_pre = g_v (1 - s) + (g_s - g_v v_pre)
    surr`` (hard reset) or ``g_v + (g_s - g_v thr) surr`` (soft) return
    ``dcols = dv_pre wq^T``, ``dwq = cols^T dv_pre`` and ``dv = leak dv_pre``.
    """

    @staticmethod
    def forward(ctx, cols, wq, vmem, neuron: NeuronConfig):
        leak = neuron.leak if neuron.model == "lif" else 1.0
        v, s = fused_lif_gemm(cols, wq, vmem, threshold=neuron.threshold,
                              leak=leak, soft_reset=neuron.reset == "soft")
        ctx.save_for_backward(cols, wq, vmem, s)
        ctx.neuron, ctx.leak = neuron, leak
        return v, s

    @staticmethod
    def backward(ctx, g_v, g_s):
        cols, wq, vmem, s = ctx.saved_tensors
        n, leak = ctx.neuron, ctx.leak
        thr = torch.tensor(n.threshold, dtype=torch.float32, device=vmem.device)
        v_pre = vmem * leak + _f64_matmul(cols, wq)
        x = (v_pre - thr) / n.surrogate_width
        surr = torch.clamp_min(1.0 - x.abs(), 0.0) / n.surrogate_width
        if n.reset == "soft":
            dv_pre = g_v + (g_s - g_v * thr) * surr
        else:
            dv_pre = g_v * (1.0 - s) + (g_s - g_v * v_pre) * surr
        return (_f64_matmul(dv_pre, wq.T), _f64_matmul(cols.T, dv_pre),
                dv_pre * leak, None)


def _layer_step(cols, wq, vmem, neuron: NeuronConfig, matmul: Optional[Callable]):
    """``(rows, F)`` spikes, ``(F, K)`` weights, ``(rows, K)`` Vmem -> (v', s)."""
    if matmul is None and vmem.is_cuda:
        return _FusedLifGemmTrain.apply(cols, wq, vmem, neuron)
    current = (matmul or torch.matmul)(cols, wq)
    return neuron_step(vmem, current, neuron)


def _qat_update(current, scale, vmem, neuron: NeuronConfig, spec: QuantSpec):
    """The deploy-exact QAT tail shared by conv and dense: saturate the
    scaled current (the column adder's partial), requantize the threshold
    onto the layer's power-of-two grid, and step the neuron.  ``scale`` is
    the fake-quant's own per-channel scale, shape ``(1, K)``."""
    scale = scale.detach()[0]  # (K,)
    _, thr_scaled = requantize_threshold(neuron.threshold, scale, spec)
    current = _clip(current, scale * spec.v_min, scale * spec.v_max)
    return neuron_step_qat(vmem, current, neuron, spec, scale, thr_scaled)


def spiking_conv(
    spikes: torch.Tensor,   # (B, H, W, C) binary float
    w: torch.Tensor,        # (kh*kw*C, K) float
    vmem: torch.Tensor,     # (B, H_out, W_out, K) float carry
    p: SpikingConvParams,
    spec: QuantSpec,
    mode: str = "train",
    matmul: Optional[Callable] = None,
):
    """One timestep of a spiking conv layer; returns ``(vmem', spikes)``."""
    _check_mode(mode)
    b, h_out, w_out, k = vmem.shape
    cols = im2col(spikes.to(torch.float32), p.kh, p.kw, p.stride, p.padding)
    cols = cols.reshape(b * h_out * w_out, -1)
    if mode == "qat":
        wq, scale = ste_quantize_po2_scaled(w, spec.weight_bits, 0)
        current = (matmul or _exact_matmul)(cols, wq).reshape(vmem.shape)
        return _qat_update(current, scale, vmem, p.neuron, spec)
    wq = ste_quantize(w, spec.weight_bits)
    v, s = _layer_step(cols, wq, vmem.reshape(-1, k), p.neuron, matmul)
    return v.reshape(vmem.shape), s.reshape(vmem.shape)


def spiking_dense(
    spikes: torch.Tensor,   # (B, N_in) binary float
    w: torch.Tensor,        # (N_in, N_out) float
    vmem: torch.Tensor,     # (B, N_out) float carry
    p: SpikingDenseParams,
    spec: QuantSpec,
    mode: str = "train",
    matmul: Optional[Callable] = None,
):
    """One timestep of a spiking FC layer; returns ``(vmem', spikes)``."""
    _check_mode(mode)
    spikes = spikes.to(torch.float32).contiguous()
    if mode == "qat":
        wq, scale = ste_quantize_po2_scaled(w, spec.weight_bits, 0)
        return _qat_update((matmul or _exact_matmul)(spikes, wq), scale, vmem,
                           p.neuron, spec)
    wq = ste_quantize(w, spec.weight_bits)
    return _layer_step(spikes, wq, vmem, p.neuron, matmul)
