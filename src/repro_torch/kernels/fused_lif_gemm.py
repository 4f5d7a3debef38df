"""Fused spike-GEMM + neuron update: wrappers of the Hopper CUDA kernels.

SpiDR's inner loop interleaves the compute macro (weight->Vmem
accumulation) and the neuron macro (leak/threshold/reset) on resident
state.  Here both phases run in one CUDA kernel (``csrc/fused_lif_gemm.cu``):
the accumulation of ``S @ W`` and the neuron epilogue stay in registers,
and Vmem and spikes are written once.

    fused_lif_gemm_int       one layer-timestep        (replaces the Pallas
                                                        ``fused_lif_gemm_int``)
    fused_lif_gemm_int_tblk  T timesteps per weight     (replaces
                             pass, Vmem carried in      ``fused_lif_gemm_int_tblk``)
                             registers across t
    fused_lif_gemm           the float step of the      (replaces
                             training-mode forward      ``fused_lif_gemm``)

A wrapper takes the plain PyTorch version (``kernels/ref.py``) only for
tensors on the CPU.  For CUDA tensors it launches the kernel or raises:
there is no fallback.  Each launch adds one to the package's launch
counter (``kernels.LAUNCHES``), so a run can show that its main path went
through the kernels.

``block`` is accepted for signature parity with the reference and is not
used: the CUDA tiles are fixed.  ``fused_lif_gemm_int`` and
``fused_lif_gemm_int_tblk`` run on the int8 tensor cores over a persistent
grid with a ring of bulk-copied spike tiles (``csrc/tc_ring.cuh``), sized
by :func:`tc_plan` and :func:`tblk_plan`; a scalar threshold reaches both
as a kernel argument.  On the ring ``skip_empty`` is accepted and has no
effect (the result is the same either way).  A fan-in too large for the
ring's two stages takes the first design's tile loop (B1 at T = 1), which
skips empty spike tiles by a block-wide vote and walks a fan-in beyond its
shared memory in chunks; the plans pick the route by shape, so no fan-in
is refused and the tblk wrapper needs no bitmap prologue.  The float
kernel skips by the same vote.
"""
from __future__ import annotations

import ctypes
import functools
import numbers

import numpy as np
import torch

from . import _ring
from ._build import (LAUNCHES, bind, check, count_launch, kernel_device, raise_on,
                     sm_count)
from .ref import (
    DEFAULT_BLOCK,
    fused_lif_gemm_int_ref,
    fused_lif_gemm_int_tblk_ref,
    fused_lif_gemm_ref,
)

__all__ = [
    "DEFAULT_BLOCK",
    "LAUNCHES",
    "fused_lif_gemm",
    "fused_lif_gemm_int",
    "fused_lif_gemm_int_tblk",
    "f32_plan",
    "f32_smem",
    "tblk_plan",
    "tblk_smem",
    "tc_plan",
    "tc_smem",
    "tile_chunk",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # s, w, v, thr, thr_scalar, v_out, s_out, M, K, N, leak, soft, vmin, vmax,
    # grid_x, stages, stream
    "spidr_fused_lif_gemm_int": [_P] * 4 + [_I] + [_P] * 2 + [_I] * 9 + [_P],
    "spidr_fused_lif_gemm_int_smem": [_I] * 3,
    # s, w, v, thr, thr_scalar, v_out, s_out, T, M, K, N, leak, soft, vmin,
    # vmax, skip, route, grid_x, stages, stream
    "spidr_fused_lif_gemm_int_tblk": [_P] * 4 + [_I] + [_P] * 2 + [_I] * 12 + [_P],
    "spidr_fused_lif_gemm_int_tblk_smem": [_I] * 3,
    "spidr_fused_lif_gemm_int_tblk_tile_smem": [_I],
    # s, w, v, v_out, s_out, M, K, N, thr, leak, soft, skip, route, grid_x,
    # stages, stream
    "spidr_fused_lif_gemm_f32": [_P] * 5 + [_I] * 3 + [_F, _F] + [_I] * 5 + [_P],
    "spidr_fused_lif_gemm_f32_smem": [_I] * 3,
}
# B1's ring (csrc/fused_lif_gemm.cu lif_gemm_tc_kernel): 2 to 4 stages,
# each the tile's spikes (32 bytes of slack) and, when one slab covers N,
# its Vmem.  B2's (lif_gemm_tblk_tc_kernel): 2 to 8 stages of spikes only
# (48 bytes of slack: a plane may start off 16 bytes), beside one Vmem
# buffer.  The tile loop (fused_lif_gemm_int_tblk_kernel) holds a
# (K padded to 64, 32) weight slice beside a 4 KB spike tile, or, past
# _TILE_K_MAX fan-in rows, one chunk of that many rows at a time.
_TC_MAX_STAGES, _TC_SLACK = 4, 32
_TBLK_MAX_STAGES, _TBLK_SLACK = 8, 48
_TILE_STATIC = 4096
_TILE_K_MAX = ((_ring.SMEM_LIMIT - _TILE_STATIC) // (_ring.NB * 4) - 4) * 4 // 64 * 64
# B3's ring (lif_gemm_f32_tc_kernel): 2 to 4 stages, each the tile's fp32
# spikes (32 bytes of slack) and, when one slab covers N, its fp32 Vmem,
# beside the fp32 weight slab: W itself when N <= 16 (K padded to 8 rows of
# N floats), else 32 channel rows of K padded to 32 plus 4 floats.
_F32_MAX_STAGES, _F32_SLACK = 4, 32
_F32_RED = 4 * 32 * 16 * 4  # the upper warps' partial sums, before the epilogue


def tc_smem(k: int, n: int, stages: int) -> int:
    """Shared memory of B1's kernel: barriers, the weight slab, then
    ``stages`` x (spike tile and, when one slab covers N, the Vmem tile)."""
    return (_ring.BARRIER_BYTES + _ring.weight_bytes(k)
            + stages * (_ring.spike_bytes(k, _TC_SLACK) + _ring.tile_bytes(n)))


@functools.lru_cache(maxsize=256)  # per launch, from a handful of layer shapes
def tc_plan(m: int, k: int, n: int, sms: int) -> _ring.Plan:
    """B1's route for ``(m, k) x (k, n)`` on ``sms`` SMs: the ring
    (``_ring.ring_grid``, 2 to 4 stages) wherever two of its stages fit
    beside the weight slab, else B2's tile loop at T = 1 (one block per M
    tile), which takes any fan-in."""
    fixed = _ring.BARRIER_BYTES + _ring.weight_bytes(k)
    stage = _ring.spike_bytes(k, _TC_SLACK) + _ring.tile_bytes(n)
    ring = _ring.ring_grid(m, k, n, fixed, stage, _TC_MAX_STAGES, sms)
    if ring is not None:
        return _ring.Plan("ring", *ring)
    return _ring.Plan("tile", -(-m // _ring.BM), 0)


def tblk_smem(k: int, n: int, stages: int) -> int:
    """Shared memory of B2's ring kernel: barriers, the weight slab, the
    Vmem buffer (one slab covers N), then ``stages`` spike tiles."""
    return (_ring.BARRIER_BYTES + _ring.weight_bytes(k) + _ring.tile_bytes(n)
            + stages * _ring.spike_bytes(k, _TBLK_SLACK))


def tile_chunk(k: int) -> int:
    """Fan-in rows of the tile loop's weight slice: all of K padded to 64,
    or ``_TILE_K_MAX`` (7,104) when K is larger (the fan-in is walked in
    chunks)."""
    return min(_ring.round_up(k, 64), _TILE_K_MAX)


def tblk_tile_smem(k: int) -> int:
    """Shared memory of the tile loop: the (``tile_chunk(k)``, 32) weight
    slice as words, 4 + rows/4 per channel, beside the 4 KB spike tile."""
    return _ring.NB * (tile_chunk(k) // 4 + 4) * 4 + _TILE_STATIC


@functools.lru_cache(maxsize=256)
def tblk_plan(m: int, k: int, n: int, sms: int) -> _ring.Plan:
    """B2's route for ``(T, m, k) x (k, n)`` on ``sms`` SMs.

    The ring (``_ring.ring_grid``, 2 to 8 stages) wherever two of its
    stages fit beside the weight slab and the Vmem buffer; the tile loop
    (one block per M tile, any fan-in) for a larger one.  T does not
    enter: the ring holds one spike tile per stage whatever T is.
    """
    fixed = _ring.BARRIER_BYTES + _ring.weight_bytes(k) + _ring.tile_bytes(n)
    ring = _ring.ring_grid(m, k, n, fixed, _ring.spike_bytes(k, _TBLK_SLACK),
                           _TBLK_MAX_STAGES, sms)
    if ring is not None:
        return _ring.Plan("ring", *ring)
    return _ring.Plan("tile", -(-m // _ring.BM), 0)


def f32_smem(k: int, n: int, stages: int) -> int:
    """Shared memory of B3's ring kernel: barriers, the fp32 weight slab,
    8 KB for the partial sums of the fan-in's upper half, then ``stages``
    x (fp32 spike tile and, when one slab covers N, the fp32 Vmem tile)."""
    if n <= 16:  # W itself, K padded to 8 rows of N
        w = _ring.round_up(_ring.round_up(k, 8) * n * 4, 128)
    else:        # n-major, 32 rows of K padded to 32 plus 4
        w = _ring.round_up(_ring.NB * (_ring.round_up(k, 32) + 4) * 4, 128)
    stage = _ring.spike_bytes(4 * k, _F32_SLACK) + _ring.tile_bytes(n)
    return _ring.BARRIER_BYTES + w + _F32_RED + stages * stage


@functools.lru_cache(maxsize=256)
def f32_plan(m: int, k: int, n: int, sms: int) -> _ring.Plan:
    """B3's route for ``(m, k) x (k, n)`` on ``sms`` SMs: the ring
    (``_ring.ring_grid``, 2 to 4 stages) wherever two of its stages fit
    beside the fp32 weight slab (K up to 320 at N = 32), else the first
    design's tile loop (one block per 64 x 32 output tile), any fan-in."""
    fixed = f32_smem(k, n, 0)
    ring = _ring.ring_grid(m, k, n, fixed, f32_smem(k, n, 1) - fixed,
                           _F32_MAX_STAGES, sms)
    if ring is not None:
        return _ring.Plan("ring", *ring)
    return _ring.Plan("tile", -(-m // _ring.BM), 0)


def _fn(name: str):
    """The bound C function ``name`` (building the library at first use)."""
    return bind("fused_lif_gemm", _SIGNATURES)[name]


def _threshold_args(threshold, n: int, device) -> tuple:
    """``(thr, thr_scalar)``: an int is a kernel argument (no fill); a
    tensor becomes a contiguous ``(N,)`` int32 vector on the device."""
    if isinstance(threshold, (int, np.integer)):
        return None, int(threshold)
    return _threshold_tensor(threshold, n, device), 0


def _threshold_tensor(threshold, n: int, device) -> torch.Tensor:
    if not isinstance(threshold, torch.Tensor):
        raise TypeError(f"threshold must be an int or a tensor, got {type(threshold)}")
    if threshold.ndim == 0:
        threshold = threshold.expand(n)
    threshold = threshold.contiguous()
    check("threshold", threshold, torch.int32, (n,), device)
    return threshold


def _vmem_range(vmem_bits: int):
    return -(1 << (vmem_bits - 1)), (1 << (vmem_bits - 1)) - 1


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def fused_lif_gemm_int(
    spikes: torch.Tensor,   # (M, K) int8 in {0,1}
    weights: torch.Tensor,  # (K, N) int8
    v: torch.Tensor,        # (M, N) int32 holding (2W-1)-bit values
    threshold,              # int, or (N,) int32 per-channel thresholds
    leak_shift: int = 0,
    soft_reset: bool = False,
    vmem_bits: int = 7,
    block: tuple = DEFAULT_BLOCK,
    skip_empty: bool = True,
):
    """Fused integer timestep ``(v', s)``, both ``(M, N)`` int32.

    Equals ``neuron_step_int(v, saturate(spikes @ weights))`` with the
    kernels' leak convention (a shift of 0 means no leak).
    """
    dev = kernel_device("fused_lif_gemm_int", spikes, weights, v)
    if dev is None:
        return fused_lif_gemm_int_ref(spikes, weights, v, threshold, leak_shift,
                                      soft_reset, vmem_bits)
    m, k = spikes.shape
    n = weights.shape[1]
    check("spikes", spikes, torch.int8, (m, k), dev)
    check("weights", weights, torch.int8, (k, n), dev)
    check("v", v, torch.int32, (m, n), dev)
    thr, thr_scalar = _threshold_args(threshold, n, dev)
    v_out = torch.empty((m, n), dtype=torch.int32, device=dev)
    s_out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if k == 0:
        raise ValueError("fused_lif_gemm_int needs a fan-in K > 0")
    if m == 0 or n == 0:
        return v_out, s_out
    plan = tc_plan(m, k, n, sm_count(dev))
    v_min, v_max = _vmem_range(vmem_bits)
    with torch.cuda.device(dev):
        if plan.route == "ring":
            spikes, v = _ring.aligned16(spikes), _ring.aligned16(v)
            err = _fn("spidr_fused_lif_gemm_int")(
                spikes.data_ptr(), weights.data_ptr(), v.data_ptr(),
                None if thr is None else thr.data_ptr(), thr_scalar, v_out.data_ptr(),
                s_out.data_ptr(), m, k, n, int(leak_shift), int(bool(soft_reset)),
                v_min, v_max, plan.grid_x, plan.stages, _stream(dev))
        else:  # B2's tile loop at T = 1: (m, k) and (m, n) are its (1, m, .)
            err = _fn("spidr_fused_lif_gemm_int_tblk")(
                spikes.data_ptr(), weights.data_ptr(), v.data_ptr(),
                None if thr is None else thr.data_ptr(), thr_scalar, v_out.data_ptr(),
                s_out.data_ptr(), 1, m, k, n, int(leak_shift), int(bool(soft_reset)),
                v_min, v_max, int(bool(skip_empty)), 0, 0, 0, _stream(dev))
    raise_on(err, "fused_lif_gemm_int")
    count_launch("fused_lif_gemm_int")
    return v_out, s_out


def fused_lif_gemm_int_tblk(
    spikes: torch.Tensor,   # (T, M, K) int8 in {0,1}
    weights: torch.Tensor,  # (K, N) int8
    v: torch.Tensor,        # (M, N) int32 Vmem entering timestep 0
    threshold,              # int, or (N,) int32 per-channel thresholds
    leak_shift: int = 0,
    soft_reset: bool = False,
    vmem_bits: int = 7,
    block: tuple = DEFAULT_BLOCK,
    skip_empty: bool = True,
):
    """Vmem-stationary fused timestep slab: T timesteps per weight pass.

    Bit-exact with :func:`fused_lif_gemm_int` applied sequentially over t.
    Returns ``(v_traj, s)``, both ``(T, M, N)`` int32: the Vmem after each
    timestep (``v_traj[-1]`` is the carry) and the spikes.
    """
    dev = kernel_device("fused_lif_gemm_int_tblk", spikes, weights, v)
    if dev is None:
        return fused_lif_gemm_int_tblk_ref(spikes, weights, v, threshold,
                                           leak_shift, soft_reset, vmem_bits)
    t, m, k = spikes.shape
    n = weights.shape[1]
    check("spikes", spikes, torch.int8, (t, m, k), dev)
    check("weights", weights, torch.int8, (k, n), dev)
    check("v", v, torch.int32, (m, n), dev)
    thr, thr_scalar = _threshold_args(threshold, n, dev)
    v_out = torch.empty((t, m, n), dtype=torch.int32, device=dev)
    s_out = torch.empty((t, m, n), dtype=torch.int32, device=dev)
    if k == 0:
        raise ValueError("fused_lif_gemm_int_tblk needs a fan-in K > 0")
    if t == 0 or m == 0 or n == 0:
        return v_out, s_out
    plan = tblk_plan(m, k, n, sm_count(dev))
    spikes, v = _ring.aligned16(spikes), _ring.aligned16(v)
    v_min, v_max = _vmem_range(vmem_bits)
    with torch.cuda.device(dev):
        err = _fn("spidr_fused_lif_gemm_int_tblk")(
            spikes.data_ptr(), weights.data_ptr(), v.data_ptr(),
            None if thr is None else thr.data_ptr(), thr_scalar, v_out.data_ptr(),
            s_out.data_ptr(), t, m, k, n, int(leak_shift), int(bool(soft_reset)),
            v_min, v_max, int(bool(skip_empty)), int(plan.route == "ring"),
            plan.grid_x, plan.stages, _stream(dev))
    raise_on(err, "fused_lif_gemm_int_tblk")
    count_launch("fused_lif_gemm_int_tblk")
    return v_out, s_out


def fused_lif_gemm(
    spikes: torch.Tensor,   # (M, K) in {0,1}, any dtype (cast to float32)
    weights: torch.Tensor,  # (K, N) float32
    v: torch.Tensor,        # (M, N) float32 carried Vmem
    threshold: float = 1.0,
    leak: float = 1.0,
    soft_reset: bool = False,
    block: tuple = DEFAULT_BLOCK,
    skip_empty: bool = True,
):
    """Fused float timestep ``(v', s) = lif(v, spikes @ weights)``, float32.

    The kernel sums the fan-in in fp32 in another order than cuBLAS or
    XLA, so Vmem agrees with the plain version within ``1e-5`` (absolute
    and relative), and a spike may differ only where the pre-reset Vmem
    lies within ``1e-5`` of the threshold.
    """
    dev = kernel_device("fused_lif_gemm", spikes, weights, v)
    if dev is None:
        return fused_lif_gemm_ref(spikes, weights, v, threshold, leak, soft_reset)
    if not isinstance(threshold, numbers.Real) or not isinstance(leak, numbers.Real):
        raise TypeError("fused_lif_gemm takes a scalar threshold and leak")
    spikes = spikes.to(torch.float32)  # the reference casts spikes too
    m, k = spikes.shape
    n = weights.shape[1]
    check("spikes", spikes, torch.float32, (m, k), dev)
    check("weights", weights, torch.float32, (k, n), dev)
    check("v", v, torch.float32, (m, n), dev)
    v_out = torch.empty((m, n), dtype=torch.float32, device=dev)
    s_out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if k == 0:
        raise ValueError("fused_lif_gemm needs a fan-in K > 0")
    if m == 0 or n == 0:
        return v_out, s_out
    plan = f32_plan(m, k, n, sm_count(dev))
    if plan.route == "ring":  # bulk copies need 16-byte aligned sources
        spikes, weights, v = (_ring.aligned16(x) for x in (spikes, weights, v))
    with torch.cuda.device(dev):
        err = _fn("spidr_fused_lif_gemm_f32")(
            spikes.data_ptr(), weights.data_ptr(), v.data_ptr(), v_out.data_ptr(),
            s_out.data_ptr(), m, k, n, float(threshold), float(leak),
            int(bool(soft_reset)), int(bool(skip_empty)), int(plan.route == "ring"),
            plan.grid_x, plan.stages, _stream(dev))
    raise_on(err, "fused_lif_gemm")
    count_launch("fused_lif_gemm")
    return v_out, s_out
