"""closed_run: the work of a closed-loop run, and how its answers are judged.

The work: a pool of ``pool`` seeded samples of the configuration's
timesteps on the device, and ``pool`` batches of ``batch`` distinct pool
indices that the calls cycle through.  Each call's readout (rate counts
``(B, classes)`` or Vmem ``(B, H, W, C)``) and its per-timestep, per-layer
output and input spike counts are compared with the reference's for the
samples of its batch (samples never interact inside the network).  Each
number has the limit 0: the deployment states integer arithmetic, so any
difference is a wrong answer.  Imports nothing of the program.
"""
from __future__ import annotations

import torch

from perfbench.harness import check, inputs
from perfbench.harness import traffic as traffic_mod

LIMITS = {"readout_mismatch": 0, "count_mismatch": 0}


def work(config: dict, mix: dict, seed: int, seconds: float, device) -> dict:
    """``pool`` ``(T, pool, H, W, 2)`` on ``device`` and ``batches``."""
    return {"pool": inputs.make_clips(config, mix, mix["pool"], config["timesteps"], seed,
                                      device),
            "batches": traffic_mod.batches(mix, seed)}


def reference(config: dict, mix: dict, params: list, work: dict, vmem_bits: int,
              device) -> dict:
    """The reference over the whole pool, with the readout after the last timestep."""
    return check.run_reference(config, params, work["pool"], vmem_bits,
                               config["deploy"]["weight_bits"])


def compare(calls: list, work: dict, ref: dict) -> dict:
    """``calls``: ``(batch index, readout, spike counts (T, L), input counts (T, L))``."""
    batches = work["batches"]
    last = max(ref["readouts"])
    want_readout = ref["readouts"][last]
    readout_bad = count_bad = 0
    for j, readout, spikes, inputs in calls:
        idx = list(batches[j])
        want = want_readout[idx]
        got = torch.as_tensor(readout).cpu()
        readout_bad += want.numel() if got.shape != want.shape else int((got != want).sum())
        for got_c, key in ((spikes, "out_counts"), (inputs, "in_counts")):
            want_c = ref[key][:, :, idx].sum(dim=2)
            got_c = torch.as_tensor(got_c).cpu().to(torch.int64)
            count_bad += (want_c.numel() if got_c.shape != want_c.shape
                          else int((got_c != want_c).sum()))
    return {"readout_mismatch": readout_bad, "count_mismatch": count_bad}


def control_answers(ctl: dict, work: dict, calls: int) -> list:
    """The answers of ``calls`` calls with the control reference ``ctl`` in the
    program's place, in the window's order."""
    batches = work["batches"]
    last = max(ctl["readouts"])
    answers = []
    for i in range(calls):
        j = i % len(batches)
        idx = list(batches[j])
        answers.append((j, ctl["readouts"][last][idx],
                        ctl["out_counts"][:, :, idx].sum(dim=2),
                        ctl["in_counts"][:, :, idx].sum(dim=2)))
    return answers
