"""Per-layer selector (stage 3 of 4): mode, precision, stationarity.

For every placed layer (or channel slice of a split layer) the selector
enumerates the discrete execution choices SpiDR exposes and keeps the
cheapest under the repo's calibrated cycle/energy models:

* **operating mode** — Mode 1 (three 3-CM pipelines) vs Mode 2 (one 9-CM
  chain).  Fig 12's rule picks by fan-in, but both modes are *feasible*
  for any fan-in once sequential fan-in tiling is allowed; the selector
  scores both and usually rediscovers Fig 12 (Mode 1's 3x parallel output
  channels win whenever the fan-in fits), which is itself a useful check.

* **precision** — a :class:`QuantSpec` from ``allowed_specs``.  Lower
  precision packs more channels per Vmem row pair (48/W_b), trading
  channel tiles against accuracy.  Executable schedules pin this to the
  engine's own qspec (bit-exactness!); passing several specs is for
  design-space analysis (the Fig 16/17 axis).

* **stationarity** — weight-stationary (weights resident, partial Vmems
  swapped per pass; SpiDR's native regime) vs Vmem/output-stationary
  (Vmem resident per position tile, weights re-streamed), per Chauvaux et
  al.'s layer-wise weight/output-stationarity result.  The traffic model:
  a weight load writes ``rows_per_macro x active-macros`` SRAM rows; a
  Vmem swap moves the 2x32 staggered partial rows.  Convs (large position
  reuse) keep weights resident; FC layers (no reuse) tie on traffic and
  break toward Vmem-stationary.
"""
from __future__ import annotations

import dataclasses

from ..core.cim_macro import NEURON_MACRO_CYCLES
from ..core.energy import chunk_energy_total_nj
from ..core.modes import CoreConfig, LayerMapping, LayerShape, map_layer
from ..core.pipeline import RESET_CYCLES, TRANSFER_CYCLES
from ..core.quant import QuantSpec
from .ir import LayerNode

__all__ = ["LayerPlan", "select_layer"]

# SRAM traffic constants for the stationarity trade (cycles).
VMEM_SWAP_CYCLES = 2 * 32       # drain + refill the 32 staggered row pairs


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """The selector's verdict for one placed layer (or slice)."""

    mode: int                   # 1 | 2
    spec: QuantSpec             # chosen precision
    stationarity: str           # "weight" | "vmem"
    mapping: LayerMapping       # tiling at (mode, spec) for the placed shape
    est_cycles_per_ts: float    # compute + per-pass overhead, per timestep
    est_traffic_cycles: float   # stationarity-dependent reload traffic
    est_energy_nj_per_ts: float


def _weight_load_cycles(mapping: LayerMapping) -> int:
    """Cycles to (re)write one pass's weight rows across the active macros."""
    active = mapping.pipelines * mapping.macros_per_pipeline
    return mapping.rows_per_macro * active


def _traffic(mapping: LayerMapping, stationarity: str) -> float:
    """Total reload traffic (cycles) for a full sweep of the layer's tiles."""
    w_load = _weight_load_cycles(mapping)
    w_tiles = mapping.channel_tiles * mapping.fan_in_tiles
    if stationarity == "weight":
        # Weights written once per weight tile; partial Vmems swapped out and
        # back in on every pass (each position tile revisits the weights).
        return w_load * w_tiles + VMEM_SWAP_CYCLES * mapping.total_passes
    # Vmem-stationary: a position tile's Vmem stays resident while every
    # weight tile streams through; Vmem moves only once per weight tile.
    return w_load * mapping.total_passes + VMEM_SWAP_CYCLES * w_tiles


def select_layer(
    node: LayerNode,
    placed_shape: LayerShape,
    allowed_specs: tuple,
    assumed_density: float = 0.1,
    force_mode: int | None = None,
    force_stationarity: str | None = None,
) -> LayerPlan:
    """Pick (mode, precision, stationarity) minimizing modeled cycles.

    ``placed_shape`` is the shape actually landing on one core — the full
    layer, or a channel slice of it.  Primary score is cycles (compute +
    per-pass pipeline overhead + reload traffic); ties break on modeled
    energy, then on the Fig 12 default mode.  ``force_mode`` /
    ``force_stationarity`` pin that dimension of the search to one value
    (the deployment API's reconfigurability overrides) — the selector then
    only optimizes over the remaining free dimensions.
    """
    sparsity = 1.0 - assumed_density
    fig12_mode = map_layer(placed_shape, CoreConfig(allowed_specs[0])).mode
    modes = (force_mode,) if force_mode is not None else (1, 2)
    stationarities = ((force_stationarity,) if force_stationarity is not None
                      else ("weight", "vmem"))
    best = None
    for spec in allowed_specs:
        core = CoreConfig(spec)
        for mode in modes:
            mapping = map_layer(placed_shape, core, force_mode=mode)
            compute = 2.0 * assumed_density * node.in_positions \
                * mapping.channel_tiles
            overhead = mapping.total_passes * (RESET_CYCLES + TRANSFER_CYCLES) \
                + NEURON_MACRO_CYCLES
            energy = mapping.total_passes * chunk_energy_total_nj(sparsity)
            for stationarity in stationarities:
                traffic = _traffic(mapping, stationarity)
                plan = LayerPlan(
                    mode=mode,
                    spec=spec,
                    stationarity=stationarity,
                    mapping=mapping,
                    est_cycles_per_ts=compute + overhead,
                    est_traffic_cycles=traffic,
                    est_energy_nj_per_ts=energy,
                )
                key = (
                    compute + overhead + traffic,
                    energy,
                    mode != fig12_mode,
                    # FC layers have no weight reuse across positions:
                    # remaining ties break toward keeping the output (Vmem)
                    # resident; convs break toward weight-stationary.
                    (stationarity == "vmem") if node.kind != "fc"
                    else (stationarity == "weight"),
                )
                if best is None or key < best[0]:
                    best = (key, plan)
    return best[1]
