"""Inputs made from the seed on the device: float weights and DVS event clips.

Frozen copies of the port's generators (``repro_torch.snn.data`` and
``core.layers.init_dense``), so a later change to the program's copies
cannot change what the benchmark feeds it.  The semantics are theirs:

* weights: uniform ``+-gain/sqrt(fan_in)`` float32 ``(fan_in, c_out)`` per
  weight layer, ``None`` per pool layer, all drawn in one call;
* gesture clips: an edge sweeping across the frame at a class-coded angle
  and speed, ON/OFF polarity channels, plus sparse per-pixel noise;
* flow clips: a random binary texture translating at a constant velocity,
  events where the texture changes between timesteps.

Clips are ``(T, N, H, W, 2)`` int8 {0, 1}; the draws come from a
``torch.Generator`` on the clips' device, in a few large calls.
"""
from __future__ import annotations

import math

import torch

from . import seeds

N_GESTURE_CLASSES = 11


def fan_in(layer: dict) -> int:
    if layer["kind"] == "conv":
        return layer["kernel"] * layer["kernel"] * layer["c_in"]
    return layer["c_in"]


def make_weights(config: dict, seed: int, device) -> list:
    """One float32 ``(fan_in, c_out)`` tensor per weight layer, None per pool."""
    g = torch.Generator(device=device).manual_seed(seeds.sub_seed(seed, seeds.WEIGHTS))
    shapes = [(fan_in(l), l["c_out"]) if l["kind"] in ("conv", "fc") else None
              for l in config["layers"]]
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


def _gesture(g: torch.Generator, n: int, t: int, hw: tuple, noise: float):
    dev = g.device
    h, w = hw
    labels = torch.randint(0, N_GESTURE_CLASSES, (n,), generator=g, device=dev)
    phases = torch.rand((n,), generator=g, device=dev) * 20.0
    noise_on = torch.rand((t, n, h, w), generator=g, device=dev) < noise
    noise_off = torch.rand((t, n, h, w), generator=g, device=dev) < noise
    angles = (2.0 * math.pi) * labels.to(torch.float32) / N_GESTURE_CLASSES
    speeds = 1.5 + 0.5 * (labels % 3).to(torch.float32)
    c = torch.cos(angles)[:, None, None]
    s = torch.sin(angles)[:, None, None]
    yy, xx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    frames = []
    for i in range(t):
        pos = ((i * speeds + phases) % (h + w))[:, None, None]
        dist = c * xx + s * yy - pos
        band = dist.abs() < 1.5
        on = (band & (dist >= 0)) | noise_on[i]
        off = (band & (dist < 0)) | noise_off[i]
        frames.append(torch.stack([on, off], dim=-1))
    return torch.stack(frames).to(torch.int8)


def _flow(g: torch.Generator, n: int, t: int, hw: tuple, density: float):
    dev = g.device
    tex = (torch.rand((n,) + tuple(hw), generator=g, device=dev) < density).to(torch.int8)
    vel = torch.rand((n, 2), generator=g, device=dev) * 4.0 - 2.0
    # One host read of every shift (dx, dy) per timestep, not one per roll.
    steps = torch.arange(-1, t, device=dev, dtype=torch.float32)
    shifts = torch.round(vel[None] * steps[:, None, None]).to(torch.int64).tolist()
    frames = []
    for i in range(t):
        cur = torch.stack([torch.roll(img, (dy, dx), dims=(0, 1))
                           for img, (dx, dy) in zip(tex, shifts[i + 1])])
        prev = torch.stack([torch.roll(img, (dy, dx), dims=(0, 1))
                            for img, (dx, dy) in zip(tex, shifts[i])])
        frames.append(torch.stack([(cur > prev), (prev > cur)], dim=-1))
    return torch.stack(frames).to(torch.int8)


def make_clips(config: dict, traffic: dict, n: int, timesteps: int, seed: int,
               device) -> torch.Tensor:
    """``n`` distinct seeded clips of ``timesteps`` frames: ``(T, n, H, W, 2)`` int8."""
    g = torch.Generator(device=device).manual_seed(seeds.sub_seed(seed, seeds.POOL))
    hw = tuple(config["input_hw"])
    kind = config["events"]
    if kind == "gesture":
        return _gesture(g, n, timesteps, hw, float(traffic["gesture_noise"]))
    if kind == "flow":
        return _flow(g, n, timesteps, hw, float(traffic["flow_density"]))
    raise ValueError(f"unknown event generator {kind!r}")
