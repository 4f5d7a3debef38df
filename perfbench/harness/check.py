"""How ``correct`` is decided: the timed path's outputs against the reference.

The reference (``reference/<name>.py``, named by the configuration) runs
once the window has closed, the peak memory has been read and the
program's state is freed, over the whole pool of samples or clips in
blocks that fit.  Every answer the window produced is then compared by the
comparison of the mix's kind (``checks/<kind>.py``), which holds each
number it compares to a limit of its own.  Imports nothing of the program.
"""
from __future__ import annotations

import torch

from . import found, roofline

BLOCK_BYTES = 1 << 29


def reference(config: dict):
    return found.module("reference", config["reference"])


def _block(config: dict, n: int) -> int:
    """Samples per reference block: the widest spike matrix under BLOCK_BYTES."""
    widest = max([1] + [m * k for _, m, k, _ in roofline.layer_gemms(config)])
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


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``."""
    table = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return all(v <= limits[k] for k, v in numbers.items()), table
