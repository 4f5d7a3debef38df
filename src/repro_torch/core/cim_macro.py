"""Compute / neuron macro geometry and cycle count (paper C1, Sec II-A).

The compute macro is a 160x48 10T SRAM array: the top 128 rows store
synaptic weights, the remaining 32 rows store partial membrane potentials.
A spike at IFspad position (Y, X) adds weight row Y into the Vmem row pair
(2X, 2X+1): two row operations, one per cycle once the 3-stage
Read/Compute/Store pipeline is full.  The neuron macro runs a fixed
66-cycle program per timestep (Eq. 3).

The constants and ``macro_cycles`` of ``repro.core.cim_macro``, which the
chip models (``modes``, ``pipeline``, ``engine.cost``) need; the
bit-serial functional model (``accumulate*``, ``pack_weight_rows``) is
not ported yet.
"""
from __future__ import annotations

__all__ = [
    "CM_COLS",
    "CM_VMEM_ROWS",
    "CM_WEIGHT_ROWS",
    "IFSPAD_COLS",
    "IFSPAD_ROWS",
    "NEURON_MACRO_CYCLES",
    "macro_cycles",
]

# Fixed silicon geometry (Sec II-A).
CM_WEIGHT_ROWS = 128   # weight rows per compute macro
CM_VMEM_ROWS = 32      # physical Vmem rows (16 logical pairs)
CM_COLS = 48           # bit columns
IFSPAD_ROWS = 128      # IFspad rows  == weight rows
IFSPAD_COLS = 16       # IFspad cols  == logical Vmem pairs
NEURON_MACRO_CYCLES = 2 * CM_VMEM_ROWS + 2  # Eq. (3): 66


def macro_cycles(nnz: int, pipeline_fill: int = 2) -> int:
    """Compute-macro cycles to drain an IFspad with ``nnz`` spikes.

    2 row ops per spike (even+odd), 1 op/cycle steady state, plus fill/
    drain of the 3-stage R/C/S peripheral pipeline.
    """
    if nnz == 0:
        return 0
    return 2 * int(nnz) + pipeline_fill
