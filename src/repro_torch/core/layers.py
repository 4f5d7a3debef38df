"""Functional spiking-layer pieces (paper C5: the input loader).

The input loader performs im2col in hardware, zero padding and stride
included, so a spiking convolution becomes a spike-matrix x weight-matrix
product:

    spikes (B, H, W, C) --im2col--> (B, P, kh*kw*C)   fan-in order (kh, kw, c)
    weights (kh*kw*C, K)           HWIO-flattened, the same fan-in order

Activations stay NHWC, as in the reference, so tests compare like with
like.  (``torch.nn.functional.unfold`` on NCHW would order the fan-in
``(c, kh, kw)``; the patches here come from ``Tensor.unfold`` on the
padded NHWC plane and are permuted to ``(kh, kw, c)``.)
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .neuron import NeuronConfig

__all__ = ["SpikingConvParams", "SpikingDenseParams", "im2col", "maxpool2d"]


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
