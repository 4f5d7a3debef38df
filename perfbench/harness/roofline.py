"""The yardstick's peaks and the operations and bytes a kernel needs.

Frozen here, not read from the program.  Peaks are NVIDIA's data sheet
for one H100 SXM at its 700 W limit (dense rates).  A bound is the least
time the work could take: the larger of its bytes over HBM's rate and its
operations over the peak for their type, each input byte counted read
once and each output byte written once, and the operations what these
inputs need (2 per spike per output channel), not the most they could.
The arithmetic is ``chip_smoke.py``'s ``_roofline`` / ``_bound``, with the
threshold vector counted only where the deployment has one.
"""
from __future__ import annotations

from . import found

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def bound_s(nbytes: float, int8_ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, int8_ops / INT8_OPS_PER_S)


def lif_gemm_bytes(m: int, k: int, n: int, t: int = 1, per_channel_thr: bool = False) -> int:
    """B1 (``t = 1``) or a B2 slab of ``t`` timesteps: int8 spikes ``(t, m, k)``
    and weights ``(k, n)`` in, int32 Vmem ``(m, n)`` in, int32 Vmem and
    spikes ``(t, m, n)`` out (and an int32 ``(n,)`` threshold vector)."""
    return t * m * k + k * n + (4 * n if per_channel_thr else 0) + 4 * m * n + 2 * 4 * t * m * n


def lif_gemm_ops(nnz: int, n: int) -> int:
    """Integer operations a spike matrix with ``nnz`` spikes needs against
    ``n`` output channels: a multiply and an add per spike per channel."""
    return 2 * nnz * n


def layer_gemms(config: dict) -> list:
    """``(kind, positions per sample, fan-in, c_out)`` of each weight layer,
    walking the frame through each layer's kind (``layers/<kind>.py``)."""
    hw = tuple(config["input_hw"])
    out = []
    for l in config["layers"]:
        kind = found.module("layers", l["kind"])
        g = kind.gemm(l, hw)
        if g is not None:
            out.append((l["kind"], *g))
        hw = kind.out_hw(l, hw)
    return out


def dense_ops_per_sample(config: dict, timesteps: int) -> int:
    """Dense int8 operations of one sample over ``timesteps``: 2 M K N per
    weight layer per timestep, whatever implements it."""
    return timesteps * sum(2 * m * k * n for _, m, k, n in layer_gemms(config))
