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
used: the CUDA tiles are fixed (64 rows x 32 channels x 64 int8 / 32 fp32
fan-in).  Tile skipping happens inside the kernels (a block-wide vote on
each staged spike tile), so the tblk wrapper needs no bitmap prologue.
"""
from __future__ import annotations

import ctypes
import numbers

import numpy as np
import torch

from ._build import LAUNCHES, bind, check, count_launch, kernel_device, raise_on
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
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # s, w, v, thr, v_out, s_out, M, K, N, leak, soft, vmin, vmax, skip, stream
    "spidr_fused_lif_gemm_int": [_P] * 6 + [_I] * 8 + [_P],
    # s, w, v, thr, v_out, s_out, T, M, K, N, leak, soft, vmin, vmax, skip, stream
    "spidr_fused_lif_gemm_int_tblk": [_P] * 6 + [_I] * 9 + [_P],
    "spidr_fused_lif_gemm_int_tblk_smem": [_I],
    # s, w, v, v_out, s_out, M, K, N, thr, leak, soft, skip, stream
    "spidr_fused_lif_gemm_f32": [_P] * 5 + [_I] * 3 + [_F, _F, _I, _I, _P],
}
_SMEM_LIMIT = 227 * 1024  # opt-in shared memory per block on sm_90


def _fn(name: str):
    """The bound C function ``name`` (building the library at first use)."""
    return bind("fused_lif_gemm", _SIGNATURES)[name]


def _threshold_vector(threshold, n: int, device) -> torch.Tensor:
    """Scalar or ``(N,)`` threshold -> contiguous ``(N,)`` int32 on device."""
    if isinstance(threshold, (int, np.integer)):
        return torch.full((n,), int(threshold), dtype=torch.int32, device=device)
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
    thr = _threshold_vector(threshold, n, dev)
    v_out = torch.empty((m, n), dtype=torch.int32, device=dev)
    s_out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if k == 0:
        raise ValueError("fused_lif_gemm_int needs a fan-in K > 0")
    if m == 0 or n == 0:
        return v_out, s_out
    v_min, v_max = _vmem_range(vmem_bits)
    with torch.cuda.device(dev):
        err = _fn("spidr_fused_lif_gemm_int")(
            spikes.data_ptr(), weights.data_ptr(), v.data_ptr(), thr.data_ptr(),
            v_out.data_ptr(), s_out.data_ptr(), m, k, n, int(leak_shift),
            int(bool(soft_reset)), v_min, v_max, int(bool(skip_empty)), _stream(dev))
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
