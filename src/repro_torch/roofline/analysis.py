"""The SNN half of the reference's roofline analysis, with the H100's peaks.

:class:`PerfModel` prices the fused Vmem-stationary T_blk kernel per weight
layer: bytes moved under the tiling and MACs at a given tile sparsity,
bound = max(compute, memory), summed over an ``SNNSpec``.  It is the
reference's (``repro.roofline.analysis``) line for line: with the same
``peaks`` it returns the reference's numbers exactly.  Only the default
peaks differ, :data:`HW_PEAK` holding the H100 SXM data sheet's figures
under the reference's keys:

  ``ops_int8``       1979e12  int8 tensor-core ops/s (dense)
  ``flops_bf16``      989e12  bf16 tensor-core flop/s (dense)
  ``hbm_gbps``       3.35e12  HBM3 bytes/s
  ``hbm_gib``          80     HBM capacity, GiB
  ``ici_link_gbps``    50e9   NVLink 4 bytes/s per link (both directions)
  ``ici_links``        18     NVLink 4 links per card (900 GB/s in all)

``CompiledSNN.roofline`` prices a deployment through it.  The HLO half of
the reference's module (``parse_hlo``, ``analyze_compiled``) is ROADMAP
A12's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["HW_PEAK", "LayerBound", "PerfModel"]

HW_PEAK = {
    "flops_bf16": 989e12,    # per card, dense
    "ops_int8": 1979e12,     # int8 tensor-core ops/s, dense
    "hbm_gbps": 3.35e12,     # bytes/s
    "ici_link_gbps": 50e9,   # bytes/s per NVLink 4 link
    "ici_links": 18,         # NVLink 4 links per card
    "hbm_gib": 80.0,         # HBM3 capacity
}


# ---------------------------------------------------------------------------
# SNN kernel performance model: analytic wall-time bounds for the fused
# Vmem-stationary T_blk kernel (kernels.fused_lif_gemm_int_tblk).
#
# A thin, explicit wrapper in the style of DaCe's RooflineModel: peaks in,
# (bytes-moved, MACs-at-sparsity) per layer, bound = max(compute, memory).
# The bound is an ideal-hardware floor: a benchmark divides a measured
# time by it, which normalizes shape, sparsity and tiling out of the wall
# clock.
# ---------------------------------------------------------------------------
def _ceil_to(x: int, b: int) -> int:
    return -(-x // b) * b


@dataclasses.dataclass(frozen=True)
class LayerBound:
    """Roofline bound for one weight layer over a whole event chunk."""

    rows: int                # GEMM M (batch x output positions)
    fan_in: int              # GEMM K
    channels: int            # GEMM N
    timesteps: int
    t_block: int
    macs: float              # MACs actually issued (after tile skipping)
    bytes_moved: float       # HBM bytes under the T_blk tiling
    compute_s: float
    memory_s: float

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s)

    @property
    def bottleneck(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"


class PerfModel:
    """Analytic roofline for the fused SNN hot path.

    ``peaks`` defaults to :data:`HW_PEAK`; pass overrides to model other
    parts (``{"ops_int8": ..., "hbm_gbps": ...}``).  All methods are pure
    and deterministic — the same (shape, precision, tiling, sparsity)
    always prices to the same bound, which is what lets benchmarks commit
    measured/bound ratios as a regression baseline.
    """

    def __init__(self, peaks: Optional[dict] = None):
        self.peaks = dict(HW_PEAK)
        if peaks:
            self.peaks.update(peaks)

    def layer_bound(
        self,
        rows: int,
        fan_in: int,
        channels: int,
        *,
        timesteps: int,
        t_block: int = 1,
        nonzero_tile_frac: float = 1.0,
        block: tuple = (128, 128, 128),
    ) -> LayerBound:
        """Bound one layer's chunk under the T_blk tiling.

        ``nonzero_tile_frac`` is the fraction of (bm x bk) spike tiles
        that carry at least one spike (measure it with
        ``kernels.spike_tile_bitmap``); it scales the MAC term — the
        block-sparsity lever — while the byte terms keep the dense spike
        stream (the bitmap is read either way; weight traffic is decided
        by tiling, not sparsity).

        Byte model of ``fused_lif_gemm_int_tblk`` per chunk:
          * weights: the (K_p x N_p) int8 matrix streams once per m-tile
            per kernel call — ``gm * K_p * N_p * ceil(T / T_blk)``; this
            is the term the Vmem-stationary tiling divides by T_blk;
          * spikes: each (T_blk, bm, bk) int8 stack is read once per
            n-tile — ``T * R_p * K_p * gn``;
          * Vmem carry: the (bm, bn) int32 tile reads once per (i, j)
            per call;
          * outputs: the (T, M, N) int32 trajectory + spike stacks write
            once each.
        """
        bm, bn, bk = block
        t_block = max(1, min(t_block, timesteps))
        r_p, k_p, n_p = _ceil_to(rows, bm), _ceil_to(fan_in, bk), \
            _ceil_to(channels, bn)
        gm, gn = r_p // bm, n_p // bn
        n_calls = -(-timesteps // t_block)

        w_bytes = float(gm * k_p * n_p) * n_calls
        s_bytes = float(timesteps * r_p * k_p) * gn
        v_bytes = 4.0 * r_p * n_p * n_calls
        out_bytes = 2.0 * 4.0 * timesteps * r_p * n_p
        bytes_moved = w_bytes + s_bytes + v_bytes + out_bytes

        macs = float(rows) * fan_in * channels * timesteps \
            * max(0.0, min(1.0, nonzero_tile_frac))
        compute_s = 2.0 * macs / self.peaks["ops_int8"]
        memory_s = bytes_moved / self.peaks["hbm_gbps"]
        return LayerBound(
            rows=rows, fan_in=fan_in, channels=channels,
            timesteps=timesteps, t_block=t_block,
            macs=macs, bytes_moved=bytes_moved,
            compute_s=compute_s, memory_s=memory_s,
        )

    def network_bound(
        self,
        spec,
        *,
        batch: int = 1,
        timesteps: Optional[int] = None,
        t_block: int = 1,
        block: tuple = (128, 128, 128),
        nonzero_tile_fracs=None,
        layer_kcfgs=None,
    ) -> dict:
        """Aggregate per-layer bounds over an ``SNNSpec``.

        ``nonzero_tile_fracs`` is a per-weight-layer list (default: dense,
        1.0); ``layer_kcfgs`` optionally overrides (bm, bn, bk, t_blk) per
        weight layer — pass ``EngineLayer.kcfg`` values to price an
        autotuned engine.  Returns per-layer :class:`LayerBound` rows plus
        total bytes/MACs and the summed wall-time bound in seconds and
        microseconds.
        """
        shapes = spec.layer_shapes()
        timesteps = spec.timesteps if timesteps is None else timesteps
        if nonzero_tile_fracs is None:
            nonzero_tile_fracs = [1.0] * len(shapes)
        if layer_kcfgs is None:
            layer_kcfgs = [None] * len(shapes)
        layers = []
        for sh, frac, kcfg in zip(shapes, nonzero_tile_fracs, layer_kcfgs):
            rows = batch * sh.out_positions if sh.kind == "conv" else batch
            blk, tb = block, t_block
            if kcfg is not None:
                blk, tb = tuple(kcfg[:3]), kcfg[3]
            layers.append(self.layer_bound(
                rows, sh.fan_in, sh.out_channels,
                timesteps=timesteps, t_block=tb,
                nonzero_tile_frac=frac, block=blk,
            ))
        bound_s = sum(lb.bound_s for lb in layers)
        return {
            "layers": layers,
            "bytes_moved": sum(lb.bytes_moved for lb in layers),
            "macs": sum(lb.macs for lb in layers),
            "compute_s": sum(lb.compute_s for lb in layers),
            "memory_s": sum(lb.memory_s for lb in layers),
            "bound_s": bound_s,
            "bound_us": bound_s * 1e6,
        }
