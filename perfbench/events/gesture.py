"""gesture: DVS gesture clips.  An edge sweeps across the frame at a
class-coded angle and speed, on ON/OFF polarity channels, plus sparse
per-pixel noise at the mix's ``gesture_noise`` rate.

A frozen copy of the port's generator (``repro_torch.snn.data``), so a later
change to the program's copy cannot change what the benchmark feeds it.
"""
from __future__ import annotations

import math

import torch

N_GESTURE_CLASSES = 11


def clips(g: torch.Generator, n: int, t: int, hw: tuple, traffic: dict) -> torch.Tensor:
    """``(t, n, H, W, 2)`` int8 {0, 1}."""
    return _gesture(g, n, t, hw, float(traffic["gesture_noise"]))


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
