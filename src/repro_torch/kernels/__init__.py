"""Hand-written Hopper kernels and their plain PyTorch versions.

  fused_lif_gemm  spike-GEMM + neuron update in one CUDA kernel: integer,
                  per timestep or per slab of timesteps, and float
                  (``csrc/fused_lif_gemm.cu``)
  spike_gemm      the unfused int8 spike-GEMM with tile zero-skipping
                  (``csrc/spike_gemm.cu``)
  lif_step        the unfused elementwise neuron step, float and integer
                  (``csrc/lif_step.cu``)
  quant_matmul    float x times int8 or packed int4 weights, dequantized in
                  the kernel, per-channel scale (``csrc/quant_matmul.cu``)
  wkv_chunk       the RWKV6 chunked wkv over a whole sequence, one launch
                  per layer (``csrc/wkv_chunk.cu``)
  ops             the public op wrappers
  ref             the plain PyTorch version of each kernel

Kernel sources build at first use (``_build.py``) with ``nvcc`` into the
ignored ``_build/`` directory; importing this package builds nothing.
:data:`LAUNCHES` counts every kernel launch of the package by entry point.
The functions ``fused_lif_gemm``, ``spike_gemm``, ``quant_matmul`` and
``wkv_chunk`` are not re-exported here: those names are the submodules.
"""
from ._build import LAUNCHES, reset_launches
from .fused_lif_gemm import DEFAULT_BLOCK, fused_lif_gemm_int, fused_lif_gemm_int_tblk
from .lif_step import lif_step_fused, lif_step_fused_int
from .ops import (lif_step_int_op, lif_step_op, quant_matmul_op, spike_gemm_op,
                  wkv_sequence_op)
from .ref import spike_tile_bitmap
