"""flow: optical-flow clips.  A random binary texture of the mix's
``flow_density`` translates at a constant velocity; events are where the
texture changes between timesteps.

A frozen copy of the port's generator (``repro_torch.snn.data``), so a later
change to the program's copy cannot change what the benchmark feeds it.
"""
from __future__ import annotations

import torch


def clips(g: torch.Generator, n: int, t: int, hw: tuple, traffic: dict) -> torch.Tensor:
    """``(t, n, H, W, 2)`` int8 {0, 1}."""
    return _flow(g, n, t, hw, float(traffic["flow_density"]))


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
