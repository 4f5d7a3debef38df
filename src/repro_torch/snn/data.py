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

Live feeds: ``make_*_chunk(seed, t0, ...)`` synthesize timesteps
``[t0, t0 + chunk_T)`` of the stream an integer ``seed`` defines, and
``iter_event_chunks`` walks one stream chunk by chunk.  A chunk equals the
same timesteps of the whole stream made from the same seed, for any
``t0``: the renderers take an absolute-time offset, the per-stream draws
come from ``seed`` alone, and the gesture noise of timestep ``t`` from a
generator seeded by ``(seed, t)`` (the reference folds ``t`` into its key
the same way).  A flow chunk of ``seed`` is also the same slice of
``make_flow_batch(torch.Generator().manual_seed(seed), ...)``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import resolve_device

__all__ = [
    "GestureDraws",
    "N_GESTURE_CLASSES",
    "flow_draws",
    "gesture_draws",
    "gesture_stream_draws",
    "iter_event_chunks",
    "make_flow_batch",
    "make_flow_chunk",
    "make_gesture_batch",
    "make_gesture_chunk",
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


def _timestep_generator(seed: int, t: int) -> torch.Generator:
    """The generator of timestep ``t``'s noise: a function of (seed, t)."""
    state = np.random.SeedSequence([int(seed), int(t)]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def gesture_stream_draws(seed: int, batch: int, t0: int, chunk_T: int,
                         hw: tuple, noise: float = 0.002) -> GestureDraws:
    """The draws of timesteps ``[t0, t0 + chunk_T)`` of the stream ``seed``.

    Labels and phases come from a generator seeded with ``seed``; each
    timestep's noise from :func:`_timestep_generator`, so the draws of any
    timestep are the same whichever chunk asks for them.
    """
    g = torch.Generator().manual_seed(int(seed))
    labels = torch.randint(0, N_GESTURE_CLASSES, (batch,), generator=g)
    phases = torch.rand((batch,), generator=g) * 20.0
    shape = (batch,) + tuple(hw)
    on, off = [], []
    for t in range(t0, t0 + chunk_T):
        g_t = _timestep_generator(seed, t)
        on.append(torch.rand(shape, generator=g_t) < noise)
        off.append(torch.rand(shape, generator=g_t) < noise)
    return GestureDraws(labels, phases, torch.stack(on), torch.stack(off))


def render_gesture(d: GestureDraws, t0: int = 0) -> torch.Tensor:
    """Draws -> ``(T, B, H, W, 2)`` float32 {0,1} events (no randomness).

    Class k sweeps an edge at angle ``2*pi*k/11`` with speed
    ``1.5 + 0.5*(k % 3)``; an event fires within 1.5 pixels of the line.
    Frame ``i`` is absolute timestep ``t0 + i`` (its noise is ``d``'s
    ``i``-th plane).
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
    for i in range(t_steps):
        pos = (((t0 + i) * speeds + phases) % (h + w))[:, None, None]
        dist = c * xx + s * yy - pos                     # (B, H, W)
        band = dist.abs() < 1.5
        on = (band & (dist >= 0)) | d.noise_on[i]
        off = (band & (dist < 0)) | d.noise_off[i]
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
                timesteps: int, t0: int = 0) -> torch.Tensor:
    """Texture + velocity -> ``(T, B, H, W, 2)`` float32 events.

    At timestep t the texture is rolled by ``round(vel * t)`` pixels (x
    along W, y along H); ON events where it appears, OFF where it leaves.
    Frame ``i`` is absolute timestep ``t0 + i``.
    """
    frames = []
    for t in range(t0, t0 + timesteps):
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


def make_gesture_chunk(seed: int, t0: int, batch: int = 16, chunk_T: int = 4,
                       hw: tuple = (64, 64), device=None):
    """Timesteps ``[t0, t0 + chunk_T)`` of the gesture stream ``seed``
    defines: ``(events (chunk_T, B, H, W, 2) float32, labels (B,))``.

    Equal to the same timesteps of ``make_gesture_chunk(seed, 0, ...,
    chunk_T=T)`` for any ``t0``: a sensor feed can be synthesized chunk by
    chunk without ever materializing the whole stream.
    """
    dev = resolve_device(device)
    d = gesture_stream_draws(seed, batch, t0, chunk_T, hw)
    d = GestureDraws(*(x.to(dev) for x in dataclasses.astuple(d)))
    return render_gesture(d, t0), d.labels


def make_flow_chunk(seed: int, t0: int, batch: int = 4, chunk_T: int = 4,
                    hw: tuple = (288, 384), density: float = 0.05,
                    device=None):
    """Timesteps ``[t0, t0 + chunk_T)`` of the flow stream ``seed`` defines:
    ``(events (chunk_T, B, H, W, 2) float32, flow (B, H, W, 2))``, equal to
    ``make_flow_batch(torch.Generator().manual_seed(seed), ...)``'s."""
    dev = resolve_device(device)
    tex, vel = flow_draws(torch.Generator().manual_seed(int(seed)), batch, hw,
                          density)
    tex, vel = tex.to(dev), vel.to(dev)
    h, w = hw
    flow = vel[:, None, None, :].expand(batch, h, w, 2)
    return render_flow(tex, vel, chunk_T, t0), flow


def iter_event_chunks(seed: int, total_T: int, chunk_T: int, batch: int = 1,
                      hw: tuple = (64, 64), kind: str = "gesture", device=None):
    """Generator over consecutive ``(t, B, H, W, 2)`` chunks of one stream.

    Yields ``ceil(total_T / chunk_T)`` chunks whose concatenation equals
    the whole stream of ``seed``; the final chunk is shorter when
    ``chunk_T`` does not divide ``total_T``.  The shape of a live sensor
    feed: the consumer (``engine.run_chunk`` or a session slot) sees events
    only as they arrive.
    """
    if kind not in ("gesture", "flow"):
        raise ValueError(f"kind must be 'gesture' or 'flow', got {kind!r}")
    make = make_gesture_chunk if kind == "gesture" else make_flow_chunk
    for t0 in range(0, total_T, chunk_T):
        ev, _ = make(seed, t0, batch=batch, chunk_T=min(chunk_T, total_T - t0),
                     hw=hw, device=device)
        yield ev
