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
used: the CUDA tiles are fixed.  ``fused_lif_gemm_int`` runs on the int8
tensor cores over a persistent grid sized by :func:`tc_plan`; it accepts
``skip_empty`` and ignores it (the result is the same either way).  The
other two kernels skip empty spike tiles by a block-wide vote inside the
kernel, so the tblk wrapper needs no bitmap prologue.
"""
from __future__ import annotations

import ctypes
import functools
import numbers

import numpy as np
import torch

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
    "tc_plan",
    "tc_smem",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # s, w, v, thr, thr_scalar, v_out, s_out, M, K, N, leak, soft, vmin, vmax,
    # grid_x, stages, stream
    "spidr_fused_lif_gemm_int": [_P] * 4 + [_I] + [_P] * 2 + [_I] * 9 + [_P],
    "spidr_fused_lif_gemm_int_smem": [_I] * 3,
    # s, w, v, thr, v_out, s_out, T, M, K, N, leak, soft, vmin, vmax, skip, stream
    "spidr_fused_lif_gemm_int_tblk": [_P] * 6 + [_I] * 9 + [_P],
    "spidr_fused_lif_gemm_int_tblk_smem": [_I],
    # s, w, v, v_out, s_out, M, K, N, thr, leak, soft, skip, stream
    "spidr_fused_lif_gemm_f32": [_P] * 5 + [_I] * 3 + [_F, _F, _I, _I, _P],
}
_SMEM_LIMIT = 227 * 1024  # opt-in shared memory per block on sm_90
_SMEM_PER_SM = 228 * 1024  # shared memory per SM, of which 1 KB per block
# B1's kernel (csrc/fused_lif_gemm.cu lif_gemm_tc_kernel): 64-row M tiles,
# slabs of 32 channels, a ring of 2 to 4 stages.
_TC_BM, _TC_NB, _TC_MAX_STAGES = 64, 32, 4


def _round_up(x: int, a: int) -> int:
    return -(-x // a) * a


def tc_smem(k: int, n: int, stages: int) -> int:
    """Shared memory of B1's kernel, laid out as ``TcLayout`` in the CUDA
    source: barriers, the weight slab, then ``stages`` x (spike tile and,
    when one slab covers N, the Vmem tile)."""
    w_bytes = _round_up(_TC_NB * (_round_up(k, 32) + 16), 128)
    stage = _round_up(_TC_BM * k + 32, 128)
    if n <= _TC_NB:
        stage += _round_up(_TC_BM * n * 4, 128)
    return 128 + w_bytes + stages * stage


@functools.lru_cache(maxsize=256)  # per launch, from a handful of layer shapes
def tc_plan(m: int, k: int, n: int, sms: int) -> tuple:
    """``(grid_x, stages)`` of B1 for ``(m, k) x (k, n)`` on ``sms`` SMs.

    Of 4, 2 or 1 blocks per SM, each with as many ring stages (2 to 4) as
    its share of shared memory holds, the choice with the most tiles in
    flight per SM (blocks x (stages - 1)); ``grid_x`` blocks per slab of 32
    channels walk the 64-row M tiles.  A fan-in too large for 2 stages on
    one block raises.
    """
    best = None
    for per_sm in (4, 2, 1):
        budget = min(_SMEM_LIMIT, _SMEM_PER_SM // per_sm - 1024)
        stages = _TC_MAX_STAGES
        while stages >= 2 and tc_smem(k, n, stages) > budget:
            stages -= 1
        if stages >= 2 and (best is None or per_sm * (stages - 1) > best[0]):
            best = (per_sm * (stages - 1), per_sm, stages)
    if best is None:
        raise ValueError(f"fused_lif_gemm_int: fan-in K={k} needs "
                         f"{tc_smem(k, n, 2)} bytes of shared memory for two "
                         f"stages, more than a Hopper block's {_SMEM_LIMIT}")
    _, per_sm, stages = best
    tiles = -(-m // _TC_BM)
    return max(1, min(tiles, sms * per_sm // -(-n // _TC_NB))), stages


def _fn(name: str):
    """The bound C function ``name`` (building the library at first use)."""
    return bind("fused_lif_gemm", _SIGNATURES)[name]


def _threshold_vector(threshold, n: int, device) -> torch.Tensor:
    """Scalar or ``(N,)`` threshold -> contiguous ``(N,)`` int32 on device."""
    if isinstance(threshold, (int, np.integer)):
        return torch.full((n,), int(threshold), dtype=torch.int32, device=device)
    return _threshold_tensor(threshold, n, device)


def _threshold_tensor(threshold, n: int, device) -> torch.Tensor:
    if not isinstance(threshold, torch.Tensor):
        raise TypeError(f"threshold must be an int or a tensor, got {type(threshold)}")
    if threshold.ndim == 0:
        threshold = threshold.expand(n)
    threshold = threshold.contiguous()
    check("threshold", threshold, torch.int32, (n,), device)
    return threshold


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it when its data does not start on 16 bytes (the
    bulk copies of B1 need that)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


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
    if isinstance(threshold, (int, np.integer)):  # a kernel argument: no fill
        thr, thr_scalar = None, int(threshold)
    else:
        thr, thr_scalar = _threshold_tensor(threshold, n, dev), 0
    v_out = torch.empty((m, n), dtype=torch.int32, device=dev)
    s_out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if k == 0:
        raise ValueError("fused_lif_gemm_int needs a fan-in K > 0")
    if m == 0 or n == 0:
        return v_out, s_out
    grid_x, stages = tc_plan(m, k, n, sm_count(dev))
    spikes, v = _aligned16(spikes), _aligned16(v)
    v_min, v_max = _vmem_range(vmem_bits)
    with torch.cuda.device(dev):
        err = _fn("spidr_fused_lif_gemm_int")(
            spikes.data_ptr(), weights.data_ptr(), v.data_ptr(),
            None if thr is None else thr.data_ptr(), thr_scalar, v_out.data_ptr(),
            s_out.data_ptr(), m, k, n, int(leak_shift), int(bool(soft_reset)),
            v_min, v_max, grid_x, stages, _stream(dev))
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
    thr = _threshold_vector(threshold, n, dev)
    v_out = torch.empty((t, m, n), dtype=torch.int32, device=dev)
    s_out = torch.empty((t, m, n), dtype=torch.int32, device=dev)
    if k == 0:
        raise ValueError("fused_lif_gemm_int_tblk needs a fan-in K > 0")
    if t == 0 or m == 0 or n == 0:
        return v_out, s_out
    # The kernel keeps the block's (K, 32) weight slice in shared memory
    # beside a 4 KB spike tile; Hopper gives a block at most 227 KB.
    smem = _fn("spidr_fused_lif_gemm_int_tblk_smem")(k) + 4096
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"fused_lif_gemm_int_tblk: fan-in K={k} needs {smem} bytes of "
            f"shared memory, more than a Hopper block's {_SMEM_LIMIT}")
    v_min, v_max = _vmem_range(vmem_bits)
    with torch.cuda.device(dev):
        err = _fn("spidr_fused_lif_gemm_int_tblk")(
            spikes.data_ptr(), weights.data_ptr(), v.data_ptr(), thr.data_ptr(),
            v_out.data_ptr(), s_out.data_ptr(), t, m, k, n, int(leak_shift),
            int(bool(soft_reset)), v_min, v_max, int(bool(skip_empty)), _stream(dev))
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
    with torch.cuda.device(dev):
        err = _fn("spidr_fused_lif_gemm_f32")(
            spikes.data_ptr(), weights.data_ptr(), v.data_ptr(), v_out.data_ptr(),
            s_out.data_ptr(), m, k, n, float(threshold), float(leak),
            int(bool(soft_reset)), int(bool(skip_empty)), _stream(dev))
    raise_on(err, "fused_lif_gemm")
    count_launch("fused_lif_gemm")
    return v_out, s_out
