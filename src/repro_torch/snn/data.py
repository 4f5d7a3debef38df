"""Synthetic DVS event streams (stand-ins for IBM DVS Gestures / DSEC-flow).

The same generators as ``repro.snn.data``, with the random draws kept
apart from the deterministic rendering:

  * gesture-like streams: a bright oriented edge sweeping across the frame
    at a class-coded angle and speed, ON/OFF polarity channels, plus
    sparse per-pixel noise events;
  * flow-like streams: a random binary texture translating at a constant
    per-sample velocity (the ground-truth flow); events fire where the
    texture changes between timesteps.

``*_draws`` take every random number from a ``torch.Generator``;
``render_*`` turn draws into events with no randomness at all, so a test
can feed the JAX package's own draws into the renderer here and compare.
(``torch.Generator`` and ``jax.random`` give different numbers for the
same seed.)
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import resolve_device

__all__ = [
    "GestureDraws",
    "N_GESTURE_CLASSES",
    "flow_draws",
    "gesture_draws",
    "make_flow_batch",
    "make_gesture_batch",
    "render_flow",
    "render_gesture",
]

N_GESTURE_CLASSES = 11  # IBM DVS gestures has 11 classes


@dataclasses.dataclass
class GestureDraws:
    labels: torch.Tensor     # (B,) int64 class per stream
    phases: torch.Tensor     # (B,) float32 in [0, 20)
    noise_on: torch.Tensor   # (T, B, H, W) bool noise events, ON channel
    noise_off: torch.Tensor  # (T, B, H, W) bool noise events, OFF channel


def gesture_draws(generator: torch.Generator, batch: int, timesteps: int,
                  hw: tuple, noise: float = 0.002) -> GestureDraws:
    """Every random number a gesture batch needs, from ``generator``."""
    dev = generator.device
    h, w = hw
    labels = torch.randint(0, N_GESTURE_CLASSES, (batch,), generator=generator,
                           device=dev)
    phases = torch.rand((batch,), generator=generator, device=dev) * 20.0
    shape = (timesteps, batch, h, w)
    noise_on = torch.rand(shape, generator=generator, device=dev) < noise
    noise_off = torch.rand(shape, generator=generator, device=dev) < noise
    return GestureDraws(labels, phases, noise_on, noise_off)


def render_gesture(d: GestureDraws) -> torch.Tensor:
    """Draws -> ``(T, B, H, W, 2)`` float32 {0,1} events (no randomness).

    Class k sweeps an edge at angle ``2*pi*k/11`` with speed
    ``1.5 + 0.5*(k % 3)``; an event fires within 1.5 pixels of the line.
    """
    t_steps, b, h, w = d.noise_on.shape
    dev = d.noise_on.device
    labels = d.labels.to(dev)
    angles = (2.0 * math.pi) * labels.to(torch.float32) / N_GESTURE_CLASSES
    speeds = 1.5 + 0.5 * (labels % 3).to(torch.float32)
    c = torch.cos(angles)[:, None, None]
    s = torch.sin(angles)[:, None, None]
    yy, xx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    phases = d.phases.to(dev, torch.float32)
    frames = []
    for t in range(t_steps):
        pos = ((t * speeds + phases) % (h + w))[:, None, None]
        dist = c * xx + s * yy - pos                     # (B, H, W)
        band = dist.abs() < 1.5
        on = (band & (dist >= 0)) | d.noise_on[t]
        off = (band & (dist < 0)) | d.noise_off[t]
        frames.append(torch.stack([on, off], dim=-1))
    return torch.stack(frames).to(torch.float32)


def make_gesture_batch(generator: torch.Generator, batch: int = 16,
                       timesteps: int = 20, hw: tuple = (64, 64), device=None):
    """``(events (T, B, H, W, 2) float32, labels (B,))`` on ``device``."""
    dev = resolve_device(device)
    d = gesture_draws(generator, batch, timesteps, hw)
    d = GestureDraws(*(x.to(dev) for x in dataclasses.astuple(d)))
    return render_gesture(d), d.labels


def flow_draws(generator: torch.Generator, batch: int, hw: tuple,
               density: float = 0.05):
    """``(texture (B, H, W) float32 {0,1}, velocity (B, 2) float32)``."""
    dev = generator.device
    tex = (torch.rand((batch,) + tuple(hw), generator=generator, device=dev)
           < density).to(torch.float32)
    vel = torch.rand((batch, 2), generator=generator, device=dev) * 4.0 - 2.0
    return tex, vel


def render_flow(tex: torch.Tensor, vel: torch.Tensor,
                timesteps: int) -> torch.Tensor:
    """Texture + velocity -> ``(T, B, H, W, 2)`` float32 events.

    At timestep t the texture is rolled by ``round(vel * t)`` pixels (x
    along W, y along H); ON events where it appears, OFF where it leaves.
    """
    frames = []
    for t in range(timesteps):
        cur_shift = torch.round(vel * t).to(torch.int64).tolist()
        prev_shift = torch.round(vel * (t - 1)).to(torch.int64).tolist()
        cur = torch.stack([torch.roll(img, (dy, dx), dims=(0, 1))
                           for img, (dx, dy) in zip(tex, cur_shift)])
        prev = torch.stack([torch.roll(img, (dy, dx), dims=(0, 1))
                            for img, (dx, dy) in zip(tex, prev_shift)])
        on = torch.clamp(cur - prev, 0, 1)
        off = torch.clamp(prev - cur, 0, 1)
        frames.append(torch.stack([on, off], dim=-1))
    return torch.stack(frames)


def make_flow_batch(generator: torch.Generator, batch: int = 4,
                    timesteps: int = 10, hw: tuple = (288, 384),
                    density: float = 0.05, device=None):
    """``(events (T, B, H, W, 2) float32, flow (B, H, W, 2))`` on ``device``."""
    dev = resolve_device(device)
    tex, vel = flow_draws(generator, batch, hw, density)
    tex, vel = tex.to(dev), vel.to(dev)
    h, w = hw
    flow = vel[:, None, None, :].expand(batch, h, w, 2)
    return render_flow(tex, vel, timesteps), flow
