"""Public entry points for the unfused SNN kernels.

The counterparts of ``repro.kernels.ops``'s ``spike_gemm_op``,
``lif_step_op`` and ``lif_step_int_op``.  There is no ``on_tpu``: the
device of the tensors chooses the route.  CPU tensors take the plain
PyTorch versions, CUDA tensors the hand-written kernels, and anything else
raises.  ``quant_matmul_op`` and ``wkv_sequence_op`` belong to the LM
stack's kernels, not ported yet (ROADMAP B6, B7).
"""
from __future__ import annotations

import torch

from .lif_step import lif_step_fused, lif_step_fused_int
from .ref import DEFAULT_BLOCK
from .spike_gemm import spike_gemm

__all__ = ["lif_step_int_op", "lif_step_op", "spike_gemm_op"]


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
