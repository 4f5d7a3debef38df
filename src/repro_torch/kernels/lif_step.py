"""Fused neuron-macro update (paper C8 / Eq. 3): wrappers of a Hopper kernel.

The neuron macro's per-timestep program — partial->full Vmem accumulation,
optional leak, threshold compare and the conditional-write reset — as one
elementwise pass with two outputs ``(v', s)`` (``csrc/lif_step.cu``),
replacing the Pallas ``lif_step_fused`` and ``lif_step_fused_int``:

    lif_step_fused      float32: multiplicative leak when ``leak != 1``
    lif_step_fused_int  int32, bit-exact with ``neuron_step_int``: shift
                        leak when ``leak_shift > 0``, saturation to the
                        ``vmem_bits`` range

Any shape: the kernel walks the flattened tensor, with no padding.  For
CPU tensors a wrapper returns the plain version (``kernels/ref.py``); for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from ._build import bind, check, count_launch, kernel_device, raise_on
from .ref import lif_step_int_ref, lif_step_ref

__all__ = ["lif_step_fused", "lif_step_fused_int"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
_SIGNATURES = {
    # v, current, v_out, s_out, n, thr, leak, soft, stream
    "spidr_lif_step_f32": [_P] * 4 + [_L, _F, _F, _I, _P],
    # v, partial, v_out, s_out, n, thr, leak_shift, soft, vmin, vmax, stream
    "spidr_lif_step_int": [_P] * 4 + [_L] + [_I] * 5 + [_P],
}


def _launch(sym: str, what: str, dev, v, i, dtype, *args):
    check("v", v, dtype, v.shape, dev)
    check("input", i, dtype, v.shape, dev)
    v_out, s_out = torch.empty_like(v), torch.empty_like(v)
    if v.numel() == 0:
        return v_out, s_out
    with torch.cuda.device(dev):
        err = bind("lif_step", _SIGNATURES)[sym](
            v.data_ptr(), i.data_ptr(), v_out.data_ptr(), s_out.data_ptr(),
            v.numel(), *args, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, what)
    count_launch(what)
    return v_out, s_out


def lif_step_fused(v: torch.Tensor, current: torch.Tensor, threshold: float = 1.0,
                   leak: float = 1.0, soft_reset: bool = False):
    """Float neuron step ``(v', s)``; ``leak=1.0`` is IF, ``leak<1`` LIF."""
    dev = kernel_device("lif_step_fused", v, current)
    if dev is None:
        return lif_step_ref(v, current, threshold, leak, soft_reset)
    if not isinstance(threshold, numbers.Real) or not isinstance(leak, numbers.Real):
        raise TypeError("lif_step_fused takes a scalar threshold and leak")
    return _launch("spidr_lif_step_f32", "lif_step_fused", dev, v, current,
                   torch.float32, float(threshold), float(leak), int(bool(soft_reset)))


def lif_step_fused_int(v: torch.Tensor, partial: torch.Tensor, threshold: int,
                       leak_shift: int = 0, soft_reset: bool = False,
                       vmem_bits: int = 7):
    """Integer neuron step ``(v', s)``, int32, bit-exact with ``neuron_step_int``."""
    dev = kernel_device("lif_step_fused_int", v, partial)
    if dev is None:
        return lif_step_int_ref(v, partial, threshold, leak_shift, soft_reset,
                                vmem_bits)
    if not isinstance(threshold, numbers.Integral):
        raise TypeError(f"lif_step_fused_int takes an int threshold, got {type(threshold)}")
    v_min, v_max = -(1 << (vmem_bits - 1)), (1 << (vmem_bits - 1)) - 1
    return _launch("spidr_lif_step_int", "lif_step_fused_int", dev, v, partial,
                   torch.int32, int(threshold), int(leak_shift),
                   int(bool(soft_reset)), v_min, v_max)
