"""Inputs made from the seed on the device: float weights and DVS event clips.

Frozen copies of the port's generators (``core.layers.init_dense`` here,
``repro_torch.snn.data``'s under ``events/``), so a later change to the
program's copies cannot change what the benchmark feeds it:

* weights: uniform ``+-gain/sqrt(fan_in)`` float32 ``(fan_in, c_out)`` per
  weight layer, ``None`` per layer without weights, all drawn in one call;
  each layer's kind (``layers/<kind>.py``) gives its shape;
* clips: the configuration's event generator, ``events/<events>.py``.

Clips are ``(T, N, H, W, 2)`` int8 {0, 1}; the draws come from a
``torch.Generator`` on the clips' device, in a few large calls.
"""
from __future__ import annotations

import math

import torch

from . import found, seeds


def make_weights(config: dict, seed: int, device) -> list:
    """One float32 ``(fan_in, c_out)`` tensor per weight layer, None per other layer."""
    g = torch.Generator(device=device).manual_seed(seeds.sub_seed(seed, seeds.WEIGHTS))
    shapes = [found.module("layers", l["kind"]).weight_shape(l) for l in config["layers"]]
    total = sum(a * b for a, b in filter(None, shapes))
    u = torch.rand((total,), generator=g, device=device, dtype=torch.float32)
    gain = float(config["weight_init"]["gain"])
    params, off = [], 0
    for shape in shapes:
        if shape is None:
            params.append(None)
            continue
        n = shape[0] * shape[1]
        scale = gain / math.sqrt(shape[0])
        params.append((u[off:off + n].reshape(shape) * (2 * scale) - scale).contiguous())
        off += n
    return params


def make_clips(config: dict, traffic: dict, n: int, timesteps: int, seed: int,
               device) -> torch.Tensor:
    """``n`` distinct seeded clips of ``timesteps`` frames: ``(T, n, H, W, 2)`` int8."""
    g = torch.Generator(device=device).manual_seed(seeds.sub_seed(seed, seeds.POOL))
    hw = tuple(config["input_hw"])
    return found.module("events", config["events"]).clips(g, n, timesteps, hw, traffic)
