"""Fused spike-GEMM + neuron update: wrappers of the Hopper CUDA kernels.

SpiDR's inner loop interleaves the compute macro (weight->Vmem
accumulation) and the neuron macro (leak/threshold/reset) on resident
state.  Here both phases run in one CUDA kernel (``csrc/fused_lif_gemm.cu``):
the int32 accumulation of ``S @ W`` and the neuron epilogue stay in
registers, and Vmem and spikes are written once.

    fused_lif_gemm_int       one layer-timestep        (replaces the Pallas
                                                        ``fused_lif_gemm_int``)
    fused_lif_gemm_int_tblk  T timesteps per weight     (replaces
                             pass, Vmem carried in      ``fused_lif_gemm_int_tblk``)
                             registers across t

A wrapper takes the plain PyTorch version (``kernels/ref.py``) only for
tensors on the CPU.  For CUDA tensors it launches the kernel or raises:
there is no fallback.  Each launch adds one to :data:`LAUNCHES`, so a run
can show that its main path went through the kernels.

``block`` is accepted for signature parity with the reference and is not
used: the CUDA tile is fixed (64 rows x 32 channels x 64 fan-in).  Tile
skipping happens inside the kernel (a block-wide vote on each staged
spike tile), so the tblk wrapper needs no bitmap prologue.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .ref import (
    DEFAULT_BLOCK,
    fused_lif_gemm_int_ref,
    fused_lif_gemm_int_tblk_ref,
)

__all__ = [
    "DEFAULT_BLOCK",
    "LAUNCHES",
    "fused_lif_gemm_int",
    "fused_lif_gemm_int_tblk",
    "reset_launches",
]

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"fused_lif_gemm_int": 0, "fused_lif_gemm_int_tblk": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # s, w, v, thr, v_out, s_out, M, K, N, leak, soft, vmin, vmax, skip, stream
    "spidr_fused_lif_gemm_int": [_P] * 6 + [_I] * 8 + [_P],
    # s, w, v, thr, v_out, s_out, T, M, K, N, leak, soft, vmin, vmax, skip, stream
    "spidr_fused_lif_gemm_int_tblk": [_P] * 6 + [_I] * 9 + [_P],
    "spidr_fused_lif_gemm_int_tblk_smem": [_I],
}
_FNS: dict = {}
_SMEM_LIMIT = 227 * 1024  # opt-in shared memory per block on sm_90


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn(name: str):
    """The bound C function ``name`` (building the library at first use)."""
    fn = _FNS.get(name)
    if fn is None:
        lib = _build.load("fused_lif_gemm")
        for sym, argtypes in _SIGNATURES.items():
            f = getattr(lib, sym)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _FNS[sym] = f
        fn = _FNS[name]
    return fn


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _threshold_vector(threshold, n: int, device) -> torch.Tensor:
    """Scalar or ``(N,)`` threshold -> contiguous ``(N,)`` int32 on device."""
    if isinstance(threshold, (int, np.integer)):
        return torch.full((n,), int(threshold), dtype=torch.int32, device=device)
    if not isinstance(threshold, torch.Tensor):
        raise TypeError(f"threshold must be an int or a tensor, got {type(threshold)}")
    if threshold.ndim == 0:
        threshold = threshold.expand(n)
    threshold = threshold.contiguous()
    _check("threshold", threshold, torch.int32, (n,), device)
    return threshold


def _vmem_range(vmem_bits: int):
    return -(1 << (vmem_bits - 1)), (1 << (vmem_bits - 1)) - 1


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


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
    if _on_cpu(spikes, weights, v):
        return fused_lif_gemm_int_ref(spikes, weights, v, threshold, leak_shift,
                                      soft_reset, vmem_bits)
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"fused_lif_gemm_int runs on CPU or CUDA tensors, got {dev}")
    m, k = spikes.shape
    n = weights.shape[1]
    _check("spikes", spikes, torch.int8, (m, k), dev)
    _check("weights", weights, torch.int8, (k, n), dev)
    _check("v", v, torch.int32, (m, n), dev)
    thr = _threshold_vector(threshold, n, dev)
    v_out = torch.empty((m, n), dtype=torch.int32, device=dev)
    s_out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if k == 0:
        raise ValueError("fused_lif_gemm_int needs a fan-in K > 0")
    if m == 0 or n == 0:
        return v_out, s_out
    v_min, v_max = _vmem_range(vmem_bits)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn("spidr_fused_lif_gemm_int")(
            spikes.data_ptr(), weights.data_ptr(), v.data_ptr(), thr.data_ptr(),
            v_out.data_ptr(), s_out.data_ptr(), m, k, n, int(leak_shift),
            int(bool(soft_reset)), v_min, v_max, int(bool(skip_empty)), stream)
    _raise_on(err, "fused_lif_gemm_int")
    LAUNCHES["fused_lif_gemm_int"] += 1
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
    if _on_cpu(spikes, weights, v):
        return fused_lif_gemm_int_tblk_ref(spikes, weights, v, threshold,
                                           leak_shift, soft_reset, vmem_bits)
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"fused_lif_gemm_int_tblk runs on CPU or CUDA tensors, got {dev}")
    t, m, k = spikes.shape
    n = weights.shape[1]
    _check("spikes", spikes, torch.int8, (t, m, k), dev)
    _check("weights", weights, torch.int8, (k, n), dev)
    _check("v", v, torch.int32, (m, n), dev)
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn("spidr_fused_lif_gemm_int_tblk")(
            spikes.data_ptr(), weights.data_ptr(), v.data_ptr(), thr.data_ptr(),
            v_out.data_ptr(), s_out.data_ptr(), t, m, k, n, int(leak_shift),
            int(bool(soft_reset)), v_min, v_max, int(bool(skip_empty)), stream)
    _raise_on(err, "fused_lif_gemm_int_tblk")
    LAUNCHES["fused_lif_gemm_int_tblk"] += 1
    return v_out, s_out
