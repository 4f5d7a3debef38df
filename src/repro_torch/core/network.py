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

``run_snn`` runs the reference's two training contracts, both
differentiable: ``mode="train"`` (per-tensor fake-quant, float Vmem: on
the card every weight layer-timestep is one launch of the fused float
kernel, on the CPU the plain composition) and ``mode="qat"`` (the
deploy-exact forward, whose spike trains equal the exported integer
engine's bit for bit).  The integer datapath is the engine
(``engine/inference.py``).  The reference's ``run_snn(mode="int")`` cannot
run (its ``_forward_t`` never passes the ``w_scale`` that ``spiking_conv``
asserts, ROADMAP C2), so it is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .layers import (
    SpikingConvParams,
    SpikingDenseParams,
    init_conv,
    init_dense,
    maxpool2d,
    spiking_conv,
    spiking_dense,
)
from .modes import LayerShape
from .neuron import NeuronConfig
from .quant import QuantSpec

__all__ = [
    "SNNLayer",
    "SNNSpec",
    "gesture_net",
    "init_params",
    "init_state_shapes",
    "optical_flow_net",
    "run_snn",
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

    def layer_shapes(self) -> list:
        """Accelerator-view shapes per weight layer (for modes/energy)."""
        h, w = self.input_hw
        out = []
        for l in self.layers:
            if l.kind == "conv":
                p = l.conv
                h_out = (h + 2 * p.padding - p.kh) // p.stride + 1
                w_out = (w + 2 * p.padding - p.kw) // p.stride + 1
                out.append(LayerShape.conv(p.kh, p.kw, l.c_in, l.c_out, h_out, w_out))
                h, w = h_out, w_out
            elif l.kind == "fc":
                out.append(LayerShape.fc(l.c_in, l.c_out))
            elif l.kind == "pool":
                h, w = h // 2, w // 2
            elif l.kind == "adaptive_pool":
                h = w = l.target_hw
        return out


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


def init_params(generator: torch.Generator, spec: SNNSpec) -> list:
    """Uniform ``±3/sqrt(fan_in)`` float32 weights, one per weight layer.

    The reference's He-style init with an SNN gain (``init_conv`` /
    ``init_dense``), drawn from a ``torch.Generator`` (so the numbers
    differ from ``jax.random``'s; a parity test carries the reference's
    own parameters across with ``repro_torch.convert.params_from_jax``).
    Tensors are made on the generator's device.
    """
    params = []
    for l in spec.layers:
        if l.kind == "conv":
            params.append(init_conv(generator, l.conv.kh, l.conv.kw, l.c_in, l.c_out))
        elif l.kind == "fc":
            params.append(init_dense(generator, l.c_in, l.c_out))
        else:
            params.append(None)
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


def _init_state(spec: SNNSpec, batch: int, device) -> list:
    """Float32 zero Vmem carries for every stateful layer (None for pools)."""
    return [None if shape is None
            else torch.zeros(shape, dtype=torch.float32, device=device)
            for shape in init_state_shapes(spec, batch)]


def _forward_t(params, state, x_t, spec: SNNSpec, qspec: QuantSpec,
               mode: str, record_spikes: bool = False,
               matmul: Optional[Callable] = None):
    """One timestep through all layers: ``(state', (v, s), spike_counts)``."""
    act = x_t
    new_state, spike_counts, out = [], [], None
    for i, l in enumerate(spec.layers):
        if l.kind == "conv":
            v, s = spiking_conv(act, params[i], state[i], l.conv, qspec, mode,
                                matmul)
        elif l.kind == "fc":
            v, s = spiking_dense(act.reshape(act.shape[0], -1), params[i],
                                 state[i], l.fc, qspec, mode, matmul)
        else:
            k = 2 if l.kind == "pool" else act.shape[1] // l.target_hw
            act = maxpool2d(act, window=k, stride=k)
            new_state.append(None)
            continue
        new_state.append(v)
        if record_spikes:
            spike_counts.append(s.sum())
        act, out = s, (v, s)
    return new_state, out, spike_counts


def run_snn(params, inputs: torch.Tensor, spec: SNNSpec, qspec: QuantSpec,
            mode: str = "train", record_spikes: bool = False,
            matmul: Optional[Callable] = None):
    """Run all timesteps of ``inputs`` (``(T, B, H, W, C)`` binary frames).

    ``mode`` is ``"train"`` (float QAT, per-tensor STE) or ``"qat"``
    (deploy-exact QAT).  Returns ``(readout, counts)``: the readout is
    ``(B, n_classes)`` summed output spikes ("rate") or the last layer's
    ``(B, H, W, C)`` Vmem ("vmem"), float32; ``counts`` is
    ``(T, n_weight_layers)`` float32 output spikes per layer under
    ``record_spikes``, else ``(T, 1)`` zeros, as in the reference.  Runs where ``inputs`` lies; the parameters must
    lie there too.  ``matmul`` replaces the fused kernel by
    ``matmul`` + ``neuron_step`` on any device (the plain path), or, under
    ``"qat"``, the exact product.
    """
    if mode not in ("train", "qat"):
        raise NotImplementedError(
            f"run_snn(mode={mode!r}) is not ported: the reference's 'int' mode "
            "cannot run (its _forward_t never passes w_scale, ROADMAP C2); the "
            "integer datapath is the engine (spidr.compile)")
    inputs = torch.as_tensor(inputs)
    batch, dev = inputs.shape[1], inputs.device
    state = _init_state(spec, batch, dev)
    n_out = spec.layers[-1].c_out
    if spec.readout == "rate":
        acc = torch.zeros((batch, n_out), dtype=torch.float32, device=dev)
    else:
        h, w = spec.input_hw
        acc = torch.zeros((batch, h, w, n_out), dtype=torch.float32, device=dev)
    counts = []
    for x_t in inputs.to(torch.float32):
        state, (v, s), c = _forward_t(params, state, x_t, spec, qspec, mode,
                                      record_spikes, matmul)
        acc = acc + s if spec.readout == "rate" else v
        counts.append(torch.stack(c) if record_spikes
                      else torch.zeros((1,), device=dev))
    return acc, torch.stack(counts)
