"""How ``correct`` is decided: the timed path's outputs against the reference.

The reference (``perfbench/reference/<name>.py``) runs once the window has
closed, the peak memory has been read and the program's state is freed,
over the whole pool of samples or clips in blocks that fit.  Every answer
the window produced is then compared, exactly:

closed_run  each call's readout (rate counts ``(B, classes)`` or Vmem
            ``(B, H, W, C)``) and its per-timestep, per-layer output and
            input spike counts, against the reference's for the samples of
            its batch (samples never interact inside the network).
open_serve  each finished stream's readout and its all-layer spike total
            against the reference's run of the same clip cut to the same
            length; a stream admitted but never finished counts too.

Each number compared has the limit 0: the deployment states integer
arithmetic, so any difference is a wrong answer.
"""
from __future__ import annotations

import importlib

import torch

REFERENCE_PACKAGE = "perfbench.reference"
LIMITS = {"readout_mismatch": 0, "count_mismatch": 0, "spikes_mismatch": 0,
          "unfinished": 0}
BLOCK_BYTES = 1 << 29


def reference(config: dict):
    return importlib.import_module(f"{REFERENCE_PACKAGE}.{config['reference']}")


def _block(config: dict, n: int) -> int:
    """Samples per reference block: the widest spike matrix under BLOCK_BYTES."""
    h, w = config["input_hw"]
    widest = 1
    for l in config["layers"]:
        if l["kind"] == "conv":
            widest = max(widest, l["kernel"] ** 2 * l["c_in"] * h * w)
        elif l["kind"] == "pool":
            h, w = h // l["window"], w // l["window"]
        elif l["kind"] == "adaptive_pool":
            h = w = l["target_hw"]
    return max(1, min(n, 64, BLOCK_BYTES // (4 * widest)))


def run_reference(config: dict, params: list, clips: torch.Tensor, vmem_bits: int,
                  weight_bits: int, readout_at=None) -> dict:
    """The reference over ``clips`` ``(T, N, H, W, C)``, in blocks of samples.

    Returns the block outputs of ``reference.run`` joined along the sample
    axis, with the readouts moved to the host.
    """
    ref = reference(config)
    layers = ref.prepare(config, params, weight_bits)
    n = clips.shape[1]
    step = _block(config, n)
    parts = []
    for lo in range(0, n, step):
        out = ref.run(config, layers, clips[:, lo:lo + step], vmem_bits, readout_at)
        parts.append({"out_counts": out["out_counts"].cpu(), "in_counts": out["in_counts"].cpu(),
                      "cols_nnz": out["cols_nnz"].cpu(),
                      "readouts": {t: r.cpu() for t, r in out["readouts"].items()}})
    return {"out_counts": torch.cat([p["out_counts"] for p in parts], dim=2),
            "in_counts": torch.cat([p["in_counts"] for p in parts], dim=2),
            "cols_nnz": torch.cat([p["cols_nnz"] for p in parts], dim=2),
            "readouts": {t: torch.cat([p["readouts"][t] for p in parts])
                         for t in parts[0]["readouts"]}}


def closed_run(calls: list, batches: list, ref: dict) -> dict:
    """``calls``: ``(batch index, readout, spike counts (T, L), input counts (T, L))``."""
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


def open_serve(streams: list, ref: dict) -> dict:
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


def verdict(numbers: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``."""
    table = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    return all(v <= LIMITS[k] for k, v in numbers.items()), table
