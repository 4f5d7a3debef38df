"""Functional spiking layers (paper C5 + C1: input loader + macro compute).

The input loader performs im2col in hardware, zero padding and stride
included, so a spiking convolution becomes a spike-matrix x weight-matrix
product:

    spikes (B, H, W, C) --im2col--> (B, P, kh*kw*C)   fan-in order (kh, kw, c)
    weights (kh*kw*C, K)           HWIO-flattened, the same fan-in order
    Vmem, spikes = neuron step of (Vmem, cols @ W)

``spiking_conv`` / ``spiking_dense`` are the training-mode (``mode="train"``)
layers of the reference: float weights fake-quantized per tensor
(``ste_quantize``), float Vmem, the float neuron step.  On CUDA tensors
one layer-timestep is one launch of the fused float kernel
(``kernels.fused_lif_gemm.fused_lif_gemm``); on CPU tensors, or when a
``matmul`` is injected (the reference's hook for a spike-GEMM kernel), it
is the plain composition ``matmul`` + ``neuron_step``.  The integer layers
live in the engine (``engine/inference.py``); ``mode="qat"`` comes with
training (ROADMAP A10).

Activations stay NHWC, as in the reference, so tests compare like with
like.  (``torch.nn.functional.unfold`` on NCHW would order the fan-in
``(c, kh, kw)``; the patches here come from ``Tensor.unfold`` on the
padded NHWC plane and are permuted to ``(kh, kw, c)``.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..kernels.fused_lif_gemm import fused_lif_gemm
from .neuron import NeuronConfig, neuron_step
from .quant import QuantSpec, ste_quantize

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


def maxpool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """NHWC max-pool over VALID windows (the reference's ``reduce_window``)."""
    patches = x.unfold(1, window, stride).unfold(2, window, stride)
    return patches.amax(dim=(-2, -1))


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


def _require_train(mode: str) -> None:
    if mode != "train":
        raise NotImplementedError(
            f"mode={mode!r} is not ported: 'qat' comes with training (ROADMAP "
            "A10); the integer datapath is the engine (engine.build_engine)")


def _layer_step(cols, wq, vmem, neuron: NeuronConfig, matmul: Optional[Callable]):
    """``(rows, F)`` spikes, ``(F, K)`` weights, ``(rows, K)`` Vmem -> (v', s)."""
    if matmul is None and vmem.is_cuda:
        return fused_lif_gemm(
            cols, wq, vmem, threshold=neuron.threshold,
            leak=neuron.leak if neuron.model == "lif" else 1.0,
            soft_reset=neuron.reset == "soft")
    current = (matmul or torch.matmul)(cols, wq)
    return neuron_step(vmem, current, neuron)


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
    _require_train(mode)
    b, h_out, w_out, k = vmem.shape
    cols = im2col(spikes.to(torch.float32), p.kh, p.kw, p.stride, p.padding)
    wq = ste_quantize(w, spec.weight_bits)
    v, s = _layer_step(cols.reshape(b * h_out * w_out, -1), wq,
                       vmem.reshape(-1, k), p.neuron, matmul)
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
    _require_train(mode)
    wq = ste_quantize(w, spec.weight_bits)
    return _layer_step(spikes.to(torch.float32).contiguous(), wq, vmem,
                       p.neuron, matmul)
