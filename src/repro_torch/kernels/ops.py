"""Public entry points for the kernels.

The counterparts of ``repro.kernels.ops``: ``spike_gemm_op``,
``lif_step_op`` and ``lif_step_int_op`` (the unfused SNN kernels),
``quant_matmul_op`` with ``pack_int4``/``unpack_int4``, and
``wkv_sequence_op``.  There is no ``on_tpu``: the device of the tensors
chooses the route.  CPU tensors take the plain PyTorch versions, CUDA
tensors the hand-written kernels, and anything else raises.
"""
from __future__ import annotations

import torch

from .lif_step import lif_step_fused, lif_step_fused_int
from .quant_matmul import DEFAULT_BLOCK as QMM_BLOCK
from .quant_matmul import pack_int4, quant_matmul, unpack_int4
from .ref import DEFAULT_BLOCK
from .spike_gemm import spike_gemm
from .wkv_chunk import wkv_sequence

__all__ = ["lif_step_int_op", "lif_step_op", "pack_int4", "quant_matmul_op",
           "spike_gemm_op", "unpack_int4", "wkv_sequence_op"]


def spike_gemm_op(spikes, weights, block=DEFAULT_BLOCK, skip_empty=True):
    """int32 Vmem partials ``spikes @ weights`` (zero-skipping on the card)."""
    return spike_gemm(spikes, weights, block=block, skip_empty=skip_empty)


def lif_step_op(v, current, threshold=1.0, leak=1.0, soft_reset=False):
    """Float neuron step ``(v', s)``."""
    return lif_step_fused(v, current, threshold=threshold, leak=leak,
                          soft_reset=soft_reset)


def lif_step_int_op(v, partial, threshold, leak_shift=0, soft_reset=False,
                    vmem_bits=7):
    """Integer neuron step ``(v', s)``; ``v`` and ``partial`` are taken as int32."""
    return lif_step_fused_int(v.to(torch.int32), partial.to(torch.int32),
                              threshold, leak_shift=leak_shift,
                              soft_reset=soft_reset, vmem_bits=vmem_bits)


def quant_matmul_op(x, w_q, scale, bits=8, block=QMM_BLOCK):
    """float32 ``(x @ dequant(w_q)) * scale`` (int8 or packed int4 weights)."""
    return quant_matmul(x, w_q, scale, bits=bits, block=block)


def wkv_sequence_op(r, k, v, lw, u, s0, chunk=32):
    """RWKV6 wkv over a sequence.  Its plain version is also the model's
    plain path (``models.rwkv6._wkv_chunked``)."""
    return wkv_sequence(r, k, v, lw, u, s0, chunk=chunk)
