"""The paper's two evaluation networks (Table II) as torch specs.

  Optical flow estimation : input 288x384x2, 10 timesteps,
      Conv(2,32) + 6x Conv(32,32) + Conv(32,2)      (3x3, stride 1, pad 1)
  Gesture recognition     : input 64x64x2, 20 timesteps,
      Conv(2,16) + 4x Conv(16,16) + FC(64,11),
      2x2 stride-2 maxpool after every two intermediate conv layers,
      adaptive 2x2 pool before the FC so N_in = 16ch * 2 * 2 = 64.

Kernel sizes are not given in the paper; 3x3/stride-1/pad-1 is assumed,
as in ``repro.core.network``.  Parameters are a list with one float32
``(fan_in, c_out)`` tensor per weight layer and ``None`` per pool layer,
the same structure as the reference's parameter list.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .layers import SpikingConvParams, SpikingDenseParams
from .neuron import NeuronConfig

__all__ = [
    "SNNLayer",
    "SNNSpec",
    "gesture_net",
    "init_params",
    "init_state_shapes",
    "optical_flow_net",
]


@dataclasses.dataclass(frozen=True)
class SNNLayer:
    kind: str          # "conv" | "fc" | "pool" | "adaptive_pool"
    c_in: int = 0
    c_out: int = 0
    conv: SpikingConvParams | None = None
    fc: SpikingDenseParams | None = None
    target_hw: int = 0  # adaptive pool target


@dataclasses.dataclass(frozen=True)
class SNNSpec:
    name: str
    input_hw: tuple
    in_channels: int
    timesteps: int
    layers: tuple
    readout: str  # "rate" (classification) or "vmem" (regression/flow)


def _conv(c_in, c_out, neuron=None):
    return SNNLayer("conv", c_in, c_out,
                    conv=SpikingConvParams(3, 3, 1, 1, neuron or NeuronConfig()))


def gesture_net(neuron: NeuronConfig | None = None) -> SNNSpec:
    n = neuron or NeuronConfig(
        model="lif", reset="hard", threshold=0.5, leak=0.95, surrogate_width=2.0)
    return SNNSpec(
        name="gesture",
        input_hw=(64, 64),
        in_channels=2,
        timesteps=20,
        layers=(
            _conv(2, 16, n),
            _conv(16, 16, n),
            _conv(16, 16, n),
            SNNLayer("pool"),
            _conv(16, 16, n),
            _conv(16, 16, n),
            SNNLayer("pool"),
            SNNLayer("adaptive_pool", target_hw=2),
            SNNLayer("fc", 64, 11, fc=SpikingDenseParams(n)),
        ),
        readout="rate",
    )


def optical_flow_net(neuron: NeuronConfig | None = None) -> SNNSpec:
    n = neuron or NeuronConfig(
        model="if", reset="soft", threshold=0.5, surrogate_width=2.0)
    layers = [_conv(2, 32, n)]
    layers += [_conv(32, 32, n) for _ in range(6)]
    layers += [_conv(32, 2, n)]
    return SNNSpec(
        name="optical_flow",
        input_hw=(288, 384),
        in_channels=2,
        timesteps=10,
        layers=tuple(layers),
        readout="vmem",
    )


_INIT_GAIN = 3.0  # SNNs need hotter init than ANNs to fire at DVS sparsity


def init_params(generator: torch.Generator, spec: SNNSpec) -> list:
    """Uniform ``±3/sqrt(fan_in)`` float32 weights, one per weight layer.

    The reference's He-style init with an SNN gain, drawn from a
    ``torch.Generator`` (so the numbers differ from ``jax.random``'s; a
    parity test carries the reference's own parameters across with
    ``repro_torch.convert.params_from_jax``).  Tensors are made on the
    generator's device.
    """
    params = []
    for l in spec.layers:
        if l.kind == "conv":
            fan_in = l.conv.kh * l.conv.kw * l.c_in
        elif l.kind == "fc":
            fan_in = l.c_in
        else:
            params.append(None)
            continue
        scale = _INIT_GAIN / math.sqrt(fan_in)
        u = torch.rand((fan_in, l.c_out), generator=generator,
                       device=generator.device, dtype=torch.float32)
        params.append(u * (2 * scale) - scale)
    return params


def init_state_shapes(spec: SNNSpec, batch: int) -> list:
    """Vmem carry shape of every layer (``None`` for pools).

    The reference's ``_init_state`` shape walk: ``(B, H, W, C_out)`` per
    conv layer, ``(B, C_out)`` per fc layer.
    """
    h, w = spec.input_hw
    shapes = []
    for l in spec.layers:
        if l.kind == "conv":
            p = l.conv
            h = (h + 2 * p.padding - p.kh) // p.stride + 1
            w = (w + 2 * p.padding - p.kw) // p.stride + 1
            shapes.append((batch, h, w, l.c_out))
        elif l.kind == "fc":
            shapes.append((batch, l.c_out))
        elif l.kind == "pool":
            h, w = h // 2, w // 2
            shapes.append(None)
        elif l.kind == "adaptive_pool":
            h = w = l.target_hw
            shapes.append(None)
        else:
            raise ValueError(f"unknown layer kind {l.kind!r}")
    return shapes
