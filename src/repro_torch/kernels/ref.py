"""Plain PyTorch versions of the CUDA kernels: the correctness ground truth.

Each function computes exactly what its kernel computes, with ordinary
tensor operations.  The CPU tests hold them against the JAX package's
Pallas kernels and oracles; ``chip_smoke.py`` holds the CUDA kernels
against them on the card.  The kernel wrappers use them only for tensors
that lie on the CPU.

There is no int32 matrix product on CUDA in PyTorch, so ``S @ W`` is taken
in float64 and cast back.  That is exact: spikes are 0/1 and weights fit
in int8, so every partial sum is an integer of magnitude at most
K * 128, far below 2**53 (and, for the fan-ins here, K <= 288, below 2**24).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "DEFAULT_BLOCK",
    "fused_lif_gemm_int_ref",
    "fused_lif_gemm_int_tblk_ref",
    "lif_step_int_ref",
    "spike_gemm_ref",
    "spike_tile_bitmap",
]

DEFAULT_BLOCK = (128, 128, 128)  # (bm, bn, bk), the reference's default


def spike_gemm_ref(spikes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """int32 ``spikes @ weights`` over the last axis of ``spikes``."""
    acc = torch.matmul(spikes.to(torch.float64), weights.to(torch.float64))
    return acc.to(torch.int32)


def lif_step_int_ref(v, partial, threshold, leak_shift=0, soft_reset=False,
                     vmem_bits=7):
    """The neuron epilogue: leak (shift > 0 only), saturating add, fire,
    hard reset ``v*(1-s)`` (unclipped) or soft reset (clipped)."""
    v_min, v_max = -(1 << (vmem_bits - 1)), (1 << (vmem_bits - 1)) - 1
    v = v.to(torch.int32)
    if leak_shift > 0:
        v = v - (v >> leak_shift)
    v = torch.clamp(v + partial.to(torch.int32), v_min, v_max)
    s = (v >= threshold).to(torch.int32)
    if soft_reset:
        v_next = torch.clamp(v - s * threshold, v_min, v_max)
    else:
        v_next = v * (1 - s)
    return v_next, s


def _threshold(threshold, n: int, device) -> object:
    """An int stays an int; a tensor becomes an ``(N,)`` int32 vector."""
    if isinstance(threshold, (int, np.integer)):
        return int(threshold)
    t = torch.as_tensor(threshold, dtype=torch.int32, device=device)
    return t.expand(n) if t.ndim == 0 else t


def fused_lif_gemm_int_ref(spikes, weights, v, threshold, leak_shift=0,
                           soft_reset=False, vmem_bits=7):
    """One layer-timestep: wide GEMM, one saturation, neuron step.

    ``spikes`` (M, K) {0,1}, ``weights`` (K, N) int8, ``v`` (M, N) int32,
    ``threshold`` an int or ``(N,)`` ints.  Returns ``(v', s)`` int32.
    """
    v_min, v_max = -(1 << (vmem_bits - 1)), (1 << (vmem_bits - 1)) - 1
    thr = _threshold(threshold, weights.shape[1], v.device)
    partial = torch.clamp(spike_gemm_ref(spikes, weights), v_min, v_max)
    return lif_step_int_ref(v, partial, thr, leak_shift, soft_reset, vmem_bits)


def fused_lif_gemm_int_tblk_ref(spikes, weights, v, threshold, leak_shift=0,
                                soft_reset=False, vmem_bits=7):
    """T timesteps of :func:`fused_lif_gemm_int_ref`, sequentially over t.

    ``spikes`` (T, M, K); returns the ``(T, M, N)`` Vmem trajectory and
    spikes (``v_traj[-1]`` is the carry into the next slab).
    """
    v_out, s_out = [], []
    for t in range(spikes.shape[0]):
        v, s = fused_lif_gemm_int_ref(spikes[t], weights, v, threshold,
                                      leak_shift, soft_reset, vmem_bits)
        v_out.append(v)
        s_out.append(s)
    return torch.stack(v_out), torch.stack(s_out)


def spike_tile_bitmap(spikes: torch.Tensor, block: tuple = DEFAULT_BLOCK):
    """Per-tile spike bitmap ``(T, ceil(M/bm), ceil(K/bk))`` int32.

    Entry ``[t, i, kk]`` is 1 iff the ``(bm, bk)`` spike tile at grid cell
    ``(i, kk)`` of timestep ``t`` holds a spike, after zero-padding to block
    multiples.  A 2-D ``(M, K)`` input is one timestep and gives a 2-D map.
    ``block`` is ``(bm, bn, bk)``; ``bn`` is unused.
    """
    bm, _, bk = block
    squeeze = spikes.ndim == 2
    if squeeze:
        spikes = spikes[None]
    t, m, k = spikes.shape
    s = F.pad(spikes != 0, (0, -k % bk, 0, -m % bm))
    tiles = s.reshape(t, s.shape[1] // bm, bm, s.shape[2] // bk, bk)
    out = tiles.any(dim=4).any(dim=2).to(torch.int32)
    return out[0] if squeeze else out
