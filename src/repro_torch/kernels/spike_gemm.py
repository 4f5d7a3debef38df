"""Spike-driven GEMM with tile-level zero-skipping: wrapper of a Hopper kernel.

The compute macro's weight->Vmem accumulation (paper C1 + C3) as a
binary-activation integer GEMM, ``partial[m, n] = sum_k S[m, k] W[k, n]``
(int32, not saturated), in ``csrc/spike_gemm.cu``.  It replaces the
Pallas ``spike_gemm``; its three skip settings, all bit-identical:

    skip_empty=False                    dense: every tile is multiplied
    skip_empty=True, skip_mode="reduce" on the ring, as dense; in the tile
                                        loop each staged tile is voted on
                                        (``__syncthreads_or``)
    skip_empty=True, skip_mode="bitmap" a per-tile int32 bitmap, made here by
                                        ``spike_tile_bitmap`` at
                                        :data:`CUDA_TILE`, tells the kernel
                                        which tiles to load at all

:func:`plan` picks the route by shape before launching: the tensor-core
ring of ``csrc/tc_ring.cuh`` (a persistent grid, the weight slab resident,
64-row spike tiles bulk-copied into up to 8 stages) wherever two of its
stages fit in a block's shared memory, else the first design's tile loop,
which takes any fan-in.  For CPU tensors the wrapper returns the plain
version (``spike_gemm_ref``); for CUDA tensors it launches the kernel or
raises.  ``block`` is accepted for signature parity and is not used: the
CUDA tiles are fixed.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _ring
from ._build import bind, check, count_launch, kernel_device, raise_on, sm_count
from .ref import DEFAULT_BLOCK, spike_gemm_ref, spike_tile_bitmap

__all__ = ["CUDA_TILE", "SKIP_MODES", "plan", "ring_smem", "spike_gemm"]

SKIP_MODES = ("reduce", "bitmap")

#: (bm, bn, bk) of the bitmap: the ring's 64-row M tile, its 32-channel
#: slab and one mma's 32 fan-in bytes.  The ring skips a 64-row tile whose
#: flags are all zero; the tile loop a (64, 64) tile whose two flags are.
CUDA_TILE = (_ring.BM, _ring.NB, _ring.KSTEP)

_MAX_STAGES, _SLACK = 8, 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # s, w, bitmap, out, M, K, N, skip_mode, route, grid_x, stages, stream
    "spidr_spike_gemm": [_P] * 4 + [_I] * 7 + [_P],
    "spidr_spike_gemm_smem": [_I] * 3,
}
_MODE = {False: 0, "reduce": 1, "bitmap": 2}


def ring_smem(k: int, n: int, stages: int) -> int:
    """Shared memory of the ring kernel: barriers, the weight slab, then
    ``stages`` spike tiles."""
    return (_ring.BARRIER_BYTES + _ring.weight_bytes(k)
            + stages * _ring.spike_bytes(k, _SLACK))


@functools.lru_cache(maxsize=256)  # per launch, from a handful of layer shapes
def plan(m: int, k: int, n: int, sms: int) -> _ring.Plan:
    """The route of ``(m, k) x (k, n)`` on ``sms`` SMs: the ring
    (``_ring.ring_grid``, 2 to 8 stages) wherever two stages fit, else the
    tile loop, one block per (64, 32) output tile."""
    ring = _ring.ring_grid(m, k, n, ring_smem(k, n, 0), _ring.spike_bytes(k, _SLACK),
                           _MAX_STAGES, sms)
    if ring is None:
        return _ring.Plan("tile", -(-m // _ring.BM), 0)
    return _ring.Plan("ring", *ring)


def spike_gemm(
    spikes: torch.Tensor,   # (M, K) in {0,1}, any integer or bool dtype
    weights: torch.Tensor,  # (K, N) int8
    block: tuple = DEFAULT_BLOCK,
    skip_empty: bool = True,
    skip_mode: str = "reduce",
) -> torch.Tensor:
    """Vmem partials ``spikes @ weights``, ``(M, N)`` int32."""
    if skip_mode not in SKIP_MODES:
        raise ValueError(f"skip_mode {skip_mode!r} unsupported — use one of {SKIP_MODES}")
    if spikes.ndim != 2 or weights.ndim != 2 or spikes.shape[1] != weights.shape[0]:
        raise ValueError(f"spike_gemm takes (M, K) x (K, N), got "
                         f"{tuple(spikes.shape)} x {tuple(weights.shape)}")
    dev = kernel_device("spike_gemm", spikes, weights)
    if dev is None:
        return spike_gemm_ref(spikes, weights)
    if spikes.is_floating_point() or spikes.is_complex():
        raise TypeError(f"spikes must be an integer or bool tensor, got {spikes.dtype}")
    spikes = spikes.to(torch.int8)  # the reference casts spikes to int8 too
    m, k = spikes.shape
    n = weights.shape[1]
    check("spikes", spikes, torch.int8, (m, k), dev)
    check("weights", weights, torch.int8, (k, n), dev)
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if k == 0:
        raise ValueError("spike_gemm needs a fan-in K > 0")
    if m == 0 or n == 0:
        return out
    route = plan(m, k, n, sm_count(dev))
    spikes = _ring.aligned16(spikes)
    mode = _MODE[skip_mode if skip_empty else False]
    bitmap = spike_tile_bitmap(spikes, CUDA_TILE) if mode == 2 else None
    with torch.cuda.device(dev):
        err = bind("spike_gemm", _SIGNATURES)["spidr_spike_gemm"](
            spikes.data_ptr(), weights.data_ptr(),
            None if bitmap is None else bitmap.data_ptr(), out.data_ptr(),
            m, k, n, mode, int(route.route == "ring"), route.grid_x, route.stages,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "spike_gemm")
    count_launch("spike_gemm")
    return out
