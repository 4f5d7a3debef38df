"""Zero-skipping vs AER cost model + sparsity accounting (paper C3, Fig 3-5).

SpiDR stores input spikes *raw* (1 bit/position) in the IFmem/IFspad and
skips zeros with the S2A detector, instead of using address-event
representation (AER).  AER encodes each event as an address tuple
(~log2(positions) bits + framing), which only wins at very high sparsity:
Fig 4's example layer breaks even at ~94.7 % — i.e. AER address words of
~19 bits for the optical-flow input layer (288x384x2 positions + polarity).

This module provides the storage/bandwidth cost model behind Fig 4 and the
sparsity statistics of Fig 5, plus the tile-level zero-skip accounting of
the spike-GEMM kernels (a tile is skipped iff ALL its spikes are zero — the
granularity at which a matrix unit can skip work).  Host-side numpy, the
same code as ``repro.core.zero_skip``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "aer_bits",
    "raw_bits",
    "aer_overhead",
    "aer_breakeven_sparsity",
    "sparsity",
    "tile_skip_fraction",
    "SparsityProfile",
]


def raw_bits(n_positions: int) -> int:
    """Raw (uncompressed) spike-map cost: 1 bit per position."""
    return int(n_positions)


def address_bits(n_positions: int, framing_bits: int = 1) -> int:
    """Bits per AER event: position address + framing/polarity bits."""
    return math.ceil(math.log2(max(n_positions, 2))) + framing_bits


def aer_bits(n_positions: int, n_events: int, framing_bits: int = 1) -> int:
    return n_events * address_bits(n_positions, framing_bits)


def aer_overhead(n_positions: int, sparsity_: float, framing_bits: int = 1) -> float:
    """AER cost / raw cost at a given input sparsity (Fig 4's y-axis)."""
    n_events = round(n_positions * (1.0 - sparsity_))
    return aer_bits(n_positions, n_events, framing_bits) / raw_bits(n_positions)


def aer_breakeven_sparsity(n_positions: int, framing_bits: int = 1) -> float:
    """Sparsity above which AER beats raw storage: 1 - 1/addr_bits."""
    return 1.0 - 1.0 / address_bits(n_positions, framing_bits)


def sparsity(x) -> float:
    """Fraction of zeros."""
    x = np.asarray(x)
    return float(np.mean(x == 0))


def tile_skip_fraction(spike_map: np.ndarray, tile: tuple[int, int]) -> float:
    """Fraction of (tile[0] x tile[1]) tiles that are all-zero.

    This is the work fraction a tile-skipping spike GEMM (``spike_gemm``'s
    skip modes) leaves out — the tile-granular analogue of the S2A's
    per-event skip.
    """
    r, c = spike_map.shape
    tr, tc = tile
    pr, pc = -r % tr, -c % tc
    padded = np.pad(spike_map, ((0, pr), (0, pc)))
    R, C = padded.shape
    tiles = padded.reshape(R // tr, tr, C // tc, tc).sum(axis=(1, 3))
    return float(np.mean(tiles == 0))


@dataclasses.dataclass
class SparsityProfile:
    """Per-layer input sparsity across timesteps (Fig 5)."""

    layer_names: list
    per_timestep: np.ndarray  # (layers, timesteps) sparsity values

    def summary(self):
        return {
            name: (float(row.min()), float(row.mean()), float(row.max()))
            for name, row in zip(self.layer_names, self.per_timestep)
        }
