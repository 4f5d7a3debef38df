"""The control fails the check; the program at the stated precision passes it.

The control is the reference one precision step below the stated one (Vmem
6 bits for the stated 7, the same 4-bit weights) put in the program's
place, read over a window's answers at a small size on the CPU.  On the
card, ``perfbench/control.py`` reads it at each cell's own size.
"""
import pytest
import torch

from perfbench import control
from perfbench.tests._cells import small

CELLS = ["flow-run", "gesture-run", "gesture-serve", "flow-serve"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_check(workload, seed):
    config, mix = small(workload)
    correct, table = control.readings(workload, seed, calls=20, seconds=1.0,
                                      device=torch.device("cpu"), config=config, traffic=mix)
    assert correct is False, table
    assert any(table[k]["value"] > 0 for k in ("readout_mismatch", "count_mismatch",
                                                "spikes_mismatch") if k in table), table


@pytest.mark.parametrize("workload", CELLS)
def test_stated_precision_in_the_controls_place_passes(workload):
    """The same path at the stated precision reads 0: the control's failure is
    its precision, not the way it is read."""
    config, mix = small(workload)
    correct, table = control.readings(workload, 1, calls=20, seconds=1.0,
                                      device=torch.device("cpu"), config=config, traffic=mix,
                                      vmem_bits=config["deploy"]["vmem_bits"])
    assert correct is True and all(v["value"] == 0 for v in table.values()), table
