"""open_serve: the work of an open-loop serve run, and how its answers are judged.

The work: ``pool`` seeded clips of the mix's longest length, kept on the
host as ``(N, T, H, W, 2)`` arrays that streams are cut from, and the
arrival schedule of the window.  Each finished stream's readout and its
all-layer spike total are compared with the reference's run of the same
clip cut to the same length; a stream admitted but never finished counts
too.  Each number has the limit 0: the deployment states integer
arithmetic, so any difference is a wrong answer.  Imports nothing of the
program.
"""
from __future__ import annotations

import torch

from perfbench.harness import check, inputs
from perfbench.harness import traffic as traffic_mod

LIMITS = {"readout_mismatch": 0, "spikes_mismatch": 0, "unfinished": 0}


def work(config: dict, mix: dict, seed: int, seconds: float, device) -> dict:
    """``clips_host`` ``(N, T, H, W, 2)`` and ``schedule`` over ``seconds``."""
    clips = inputs.make_clips(config, mix, mix["pool"], max(mix["lengths"]), seed, device)
    clips_host = clips.transpose(0, 1).contiguous().cpu().numpy()
    del clips
    return {"clips_host": clips_host, "schedule": traffic_mod.schedule(mix, seed, seconds)}


def reference(config: dict, mix: dict, params: list, work: dict, vmem_bits: int,
              device) -> dict:
    """The reference over the clips, with readouts at every length of the mix."""
    at = sorted({l - 1 for l in mix["lengths"]})
    clips = torch.from_numpy(work["clips_host"]).to(device).transpose(0, 1)
    return check.run_reference(config, params, clips, vmem_bits,
                               config["deploy"]["weight_bits"], at)


def compare(streams: list, work: dict, ref: dict) -> dict:
    """``streams``: ``(clip, length, readout or None, spikes or None)``; None
    where the stream never finished."""
    cum_spikes = ref["out_counts"].sum(dim=1).cumsum(dim=0)   # (T, N)
    readout_bad = spikes_bad = unfinished = 0
    for clip, length, readout, spikes in streams:
        if readout is None:
            unfinished += 1
            continue
        want = ref["readouts"][length - 1][clip]
        got = torch.as_tensor(readout).cpu()
        readout_bad += want.numel() if got.shape != want.shape else int((got != want).sum())
        spikes_bad += int(int(spikes) != int(cum_spikes[length - 1, clip]))
    return {"readout_mismatch": readout_bad, "spikes_mismatch": spikes_bad,
            "unfinished": unfinished}


def control_answers(ctl: dict, work: dict, calls: int) -> list:
    """The answers of every stream of the schedule with the control reference
    ``ctl`` in the program's place."""
    spikes = ctl["out_counts"].sum(dim=1).cumsum(dim=0)
    return [(clip, length, ctl["readouts"][length - 1][clip], int(spikes[length - 1, clip]))
            for _, clip, length in work["schedule"]]
