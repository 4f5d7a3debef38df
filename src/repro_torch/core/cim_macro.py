"""Compute / neuron macro functional model (paper C1, Sec II-A, Fig 7-9).

The compute macro is a 160x48 10T SRAM array: the top 128 rows store
synaptic weights, the remaining 32 rows store partial membrane potentials.
Column peripherals implement a 3-stage Read / Compute / Store pipeline that
adds one weight row into one Vmem row per cycle.

Geometry and mapping (Fig 9):
  * Each IFspad row Y (0..127) corresponds to weight row Y.
  * Each IFspad column X (0..15) corresponds to the Vmem row *pair*
    (2X, 2X+1): Vmem precision is 2W-1 bits, so one logical Vmem vector
    occupies two staggered physical rows — the even row holds the Vmems of
    even-numbered weights, the odd row those of odd-numbered weights.
  * A spike at (Y, X) therefore triggers TWO row operations:
      even cycle:  Vmem[2X]   += even-numbered weights of row Y
      odd  cycle:  Vmem[2X+1] += odd-numbered weights of row Y

Because the design is digital, the functional result of processing a whole
IFspad is exactly

    Vmem[x, n] = saturate( sum_y spikes[y, x] * W[y, n] )

for every output neuron n packed in the columns (48/W_b of them).  The
*order* of saturating adds matters only when intermediate sums leave the
(2W-1)-bit range; ``accumulate_sequential`` reproduces the per-op
saturation order of the silicon, ``accumulate`` is the vectorized wide-sum
variant of the fast path.  On CUDA tensors ``accumulate`` runs the
spike-GEMM kernel (``kernels/spike_gemm.py`` -> ``csrc/spike_gemm.cu``,
int8 weights into int32 sums) and saturates once; on CPU tensors the
wrapper takes the kernel's plain version.

Cycle accounting (used by pipeline.py / energy.py):
  * 2 cycles per spike (even+odd), 3-stage pipeline => throughput 1 row
    op/cycle once full, +2 fill/drain cycles per burst.
  * Neuron macro: fixed 66 cycles (Eq. 3) = 2*32 partial->full Vmem
    accumulation + threshold compare sweeps + 2 pipeline cycles.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.spike_gemm import spike_gemm
from .quant import QuantSpec, saturate

__all__ = [
    "MacroConfig",
    "CM_WEIGHT_ROWS",
    "CM_VMEM_ROWS",
    "CM_COLS",
    "IFSPAD_ROWS",
    "IFSPAD_COLS",
    "NEURON_MACRO_CYCLES",
    "accumulate",
    "accumulate_sequential",
    "macro_cycles",
    "pack_weight_rows",
]

# Fixed silicon geometry (Sec II-A).
CM_WEIGHT_ROWS = 128   # weight rows per compute macro
CM_VMEM_ROWS = 32      # physical Vmem rows (16 logical pairs)
CM_COLS = 48           # bit columns
IFSPAD_ROWS = 128      # IFspad rows  == weight rows
IFSPAD_COLS = 16       # IFspad cols  == logical Vmem pairs
NEURON_MACRO_CYCLES = 2 * CM_VMEM_ROWS + 2  # Eq. (3): 66


@dataclasses.dataclass(frozen=True)
class MacroConfig:
    spec: QuantSpec
    weight_rows: int = CM_WEIGHT_ROWS
    vmem_pairs: int = IFSPAD_COLS
    cols: int = CM_COLS

    @property
    def neurons(self) -> int:
        """Output neurons whose partial Vmems live in ONE Vmem row pair."""
        return self.cols // self.spec.weight_bits

    @property
    def max_output_neurons(self) -> int:
        """Eq. (1): (48/W_b) * 16 output neurons per macro (conv mode)."""
        return self.neurons * self.vmem_pairs


def pack_weight_rows(w: torch.Tensor, cfg: MacroConfig) -> torch.Tensor:
    """Validate/clip a (fan_in_chunk, neurons) int weight block for a macro.

    The silicon stores weights as W_b-bit fields along the 48 columns; the
    functional model just keeps them as int8 with range checking.
    """
    w = torch.as_tensor(w)
    if w.ndim != 2:
        raise ValueError(f"a weight block is (fan_in, neurons), got shape "
                         f"{tuple(w.shape)}")
    fan_in, neurons = w.shape
    if fan_in > cfg.weight_rows:
        raise ValueError(f"fan-in chunk {fan_in} exceeds {cfg.weight_rows} rows")
    if neurons > cfg.neurons:
        raise ValueError(
            f"{neurons} neurons exceed {cfg.neurons} = 48/{cfg.spec.weight_bits}"
        )
    return torch.clamp(w, cfg.spec.w_min, cfg.spec.w_max).to(torch.int8)


def _as_int8(weights: torch.Tensor) -> torch.Tensor:
    """The weight block as the kernel's int8; values outside int8 raise
    (a cast would wrap them)."""
    if weights.dtype == torch.int8:
        return weights
    if weights.is_floating_point() or weights.is_complex():
        raise TypeError(f"weights must be an integer tensor, got {weights.dtype}")
    if weights.numel() and (int(weights.min()) < -128 or int(weights.max()) > 127):
        raise ValueError(
            f"weights span [{int(weights.min())}, {int(weights.max())}], outside "
            "int8 — the spike GEMM takes int8 weights (pack_weight_rows clips "
            "them to the precision's range)")
    return weights.to(torch.int8)


def accumulate(
    spikes: torch.Tensor,   # (rows, pairs) in {0,1}
    weights: torch.Tensor,  # (rows, neurons) int, within int8
    vmem: torch.Tensor,     # (pairs, neurons) int32, the partial Vmems
    spec: QuantSpec,
) -> torch.Tensor:
    """Vectorized weight->Vmem accumulation of one full IFspad.

    Wide int32 sums then one saturation — the fast-path semantics.  The
    sums are the spike GEMM ``spikes.T @ weights`` (``kernels.spike_gemm``:
    the CUDA kernel on the card, its plain version on the CPU).
    """
    acc = spike_gemm(spikes.T.to(torch.int8).contiguous(),
                     _as_int8(weights).contiguous())
    return saturate(vmem.to(torch.int32) + acc, spec)


def accumulate_sequential(
    spikes: np.ndarray, weights: np.ndarray, vmem: np.ndarray, spec: QuantSpec
) -> np.ndarray:
    """Per-op saturating accumulation in silicon order (numpy reference).

    Processes spikes row-major (the S2A scans the IFspad row by row), with
    the even cycle then the odd cycle per spike, saturating after every
    row-add exactly like the column adder chain.
    """
    v = vmem.astype(np.int64).copy()
    rows, pairs = spikes.shape
    n = weights.shape[1]
    even = np.arange(n) % 2 == 0
    for y in range(rows):
        for x in range(pairs):
            if spikes[y, x]:
                # even cycle
                v[x, even] = np.clip(
                    v[x, even] + weights[y, even], spec.v_min, spec.v_max
                )
                # odd cycle
                v[x, ~even] = np.clip(
                    v[x, ~even] + weights[y, ~even], spec.v_min, spec.v_max
                )
    return v.astype(np.int32)


def macro_cycles(nnz: int, pipeline_fill: int = 2) -> int:
    """Compute-macro cycles to drain an IFspad with ``nnz`` spikes.

    2 row ops per spike (even+odd), 1 op/cycle steady state, plus fill/
    drain of the 3-stage R/C/S peripheral pipeline.
    """
    if nnz == 0:
        return 0
    return 2 * int(nnz) + pipeline_fill
