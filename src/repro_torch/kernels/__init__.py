"""Hand-written Hopper kernels and their plain PyTorch versions.

  fused_lif_gemm  spike-GEMM + neuron update in one CUDA kernel, per
                  timestep or per slab of timesteps (``csrc/fused_lif_gemm.cu``)
  ref             the plain PyTorch version of each kernel

Kernel sources build at first use (``_build.py``) with ``nvcc`` into the
ignored ``_build/`` directory; importing this package builds nothing.
"""
from .fused_lif_gemm import (
    DEFAULT_BLOCK,
    LAUNCHES,
    fused_lif_gemm_int,
    fused_lif_gemm_int_tblk,
    reset_launches,
)
from .ref import spike_tile_bitmap
