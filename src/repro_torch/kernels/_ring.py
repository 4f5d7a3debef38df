"""Shared-memory layout and launch plans of the tensor-core ring kernels.

B1 (``fused_lif_gemm_int``), B2 (``fused_lif_gemm_int_tblk``) and B4
(``spike_gemm``) run on one design (``csrc/tc_ring.cuh``): a persistent
grid of 128-thread blocks walks 64-row M tiles, each block keeps its weight
slab of up to 32 channels in shared memory, and each tile's spikes arrive
by bulk copy in a ring of stages.  This module mirrors the kernels' shared
memory sizes (``TcLayout``) and picks the grid and the number of stages.
The plans are pure: the CPU tests check them, and ``chip_smoke.py`` checks
the sizes against the kernels' own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

SMEM_LIMIT = 227 * 1024    # opt-in shared memory per block on sm_90
SMEM_PER_SM = 228 * 1024   # shared memory per SM, of which 1 KB per block
BM = 64                    # rows per M tile
NB = 32                    # channels per slab (grid.y)
KSTEP = 32                 # fan-in bytes per mma.sync (m16n8k32)
BARRIER_BYTES = 128


class Plan(NamedTuple):
    """How a B1, B2 or B4 call launches: ``route`` "ring" (the tensor-core
    ring, ``grid_x`` blocks per slab, ``stages`` stages) or "tile" (the
    first design's tile loop, for a fan-in the ring cannot hold)."""
    route: str
    grid_x: int
    stages: int


def round_up(x: int, a: int) -> int:
    return -(-x // a) * a


def weight_bytes(k: int) -> int:
    """The weight slab: 32 channel rows of K padded to 32, +16 bytes."""
    return round_up(NB * (round_up(k, KSTEP) + 16), 128)


def spike_bytes(k: int, slack: int) -> int:
    """One stage's 64 x K spike tile plus ``slack`` bytes."""
    return round_up(BM * k + slack, 128)


def tile_bytes(n: int) -> int:
    """A 64 x N int32 Vmem tile when one slab covers N, else 0."""
    return round_up(BM * n * 4, 128) if n <= NB else 0


def ring_grid(m: int, k: int, n: int, fixed: int, stage: int, max_stages: int,
              sms: int):
    """``(grid_x, stages)`` for a kernel of ``fixed + stages * stage`` bytes
    of shared memory, or None when two stages do not fit in one block.

    Of 4, 2 or 1 blocks per SM, each with as many stages (2 to
    ``max_stages``) as its share of shared memory holds, the choice with
    the most tiles in flight per SM (blocks x (stages - 1)); ``grid_x``
    blocks per slab of 32 channels walk the 64-row M tiles.
    """
    best = None
    for per_sm in (4, 2, 1):
        budget = min(SMEM_LIMIT, SMEM_PER_SM // per_sm - 1024)
        stages = min(max_stages, (budget - fixed) // stage)
        if stages >= 2 and (best is None or per_sm * (stages - 1) > best[0]):
            best = (per_sm * (stages - 1), per_sm, stages)
    if best is None:
        return None
    _, per_sm, stages = best
    tiles = -(-m // BM)
    return max(1, min(tiles, sms * per_sm // -(-n // NB))), stages


def aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it when its data does not start on 16 bytes (the
    ring's bulk copies need that)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()
