"""Cycle / energy accounting for an engine run (threads C7 + C9 models).

Converts the per-timestep per-layer spike statistics an ``EngineOutput``
records into chip-level cost using the calibrated models:

  * ``core.pipeline.simulate_pipeline`` — the async-handshake discrete-event
    model gives the makespan in cycles (and the speedup vs a rigid
    synchronous pipeline, the paper's Fig 13 motivation).
  * ``core.energy`` — the Table I / Fig 14 calibrated chunk-energy model
    gives energy per inference at the run's measured sparsity.

The mapping from spikes to compute-macro cycles follows Sec II-E/II-F:
each input spike of a weight layer triggers 2 row operations (even+odd
Vmem rows) per weight-stationary channel tile; rows are balanced across
the 9 compute macros, so per-macro cycles are the layer total divided by
the macros in the layer's pipeline configuration.

Host-side numpy, the same code as ``repro.engine.cost``'s single-core
model, so every number equals the reference's.  The multi-core
attribution (``estimate_multicore_cost``) comes with the compiler
(ROADMAP A5).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.energy import HW, chunk_energy_total_nj, gops, power_mw
from ..core.modes import CoreConfig, map_layer
from ..core.network import SNNSpec
from ..core.pipeline import PipelineConfig, PipelineState, simulate_pipeline
from ..core.quant import QuantSpec

__all__ = ["EngineCost", "estimate_cost"]


@dataclasses.dataclass
class EngineCost:
    makespan_cycles: int        # async-handshake makespan for the whole stream
    sync_makespan_cycles: int   # rigid synchronous worst-case alternative
    async_speedup: float
    latency_ms: float           # makespan at the operating frequency
    energy_uj: float            # calibrated chunk-energy model
    avg_power_mw: float
    mean_sparsity: float        # measured input sparsity across layers/steps
    gops_equivalent: float      # dense-equivalent throughput at that sparsity
    pipeline_state: PipelineState | None = None  # resume point for streaming


def estimate_cost(
    spec: SNNSpec,
    qspec: QuantSpec,
    input_counts: np.ndarray,   # (T, n_weight_layers) input spikes per layer
    hw: HW = HW(),
    n_cm: int = 9,
    pipeline_state: PipelineState | None = None,
) -> EngineCost:
    """Chip cost of one engine run from its recorded spike statistics.

    For a stream priced chunk by chunk, pass the previous chunk's
    ``cost.pipeline_state`` as ``pipeline_state``: the async-handshake
    clocks resume, so ``makespan_cycles`` is the *cumulative* makespan
    since the stream began and is bit-identical to pricing the whole
    stream in one call, for any chunking.  (Energy is additive across
    chunks either way.)
    """
    counts = np.asarray(input_counts, dtype=np.float64)
    T, n_layers = counts.shape
    shapes = spec.layer_shapes()
    assert len(shapes) == n_layers, (len(shapes), n_layers)
    core = CoreConfig(qspec)
    mappings = [map_layer(s, core) for s in shapes]

    # Row ops per layer-timestep: 2 per spike per sequential channel tile,
    # balanced over the macros active in that layer's pipeline config.
    compute_cycles = np.zeros((T, n_cm), dtype=np.int64)
    for li, m in enumerate(mappings):
        active = m.pipelines * m.macros_per_pipeline
        per_macro = 2.0 * counts[:, li] * m.channel_tiles / active
        compute_cycles[:, :active] += np.ceil(per_macro)[:, None].astype(np.int64)

    res = simulate_pipeline(compute_cycles, PipelineConfig(n_cm=n_cm),
                            state=pipeline_state)

    # Sparsity across all layer inputs (position-weighted).
    positions = np.array(
        [s.fan_in * s.out_positions for s in shapes], dtype=np.float64
    )
    density = counts.sum() / (positions.sum() * T)
    sparsity = float(np.clip(1.0 - density, 0.0, 1.0))

    passes = sum(m.total_passes for m in mappings)
    energy_uj = passes * T * chunk_energy_total_nj(sparsity, hw) / 1e3

    return EngineCost(
        makespan_cycles=res.makespan,
        sync_makespan_cycles=res.sync_makespan,
        async_speedup=res.speedup_vs_sync,
        latency_ms=res.makespan / hw.freq_hz * 1e3,
        energy_uj=float(energy_uj),
        avg_power_mw=power_mw(hw),
        mean_sparsity=sparsity,
        gops_equivalent=gops(sparsity, qspec.weight_bits, hw.freq_hz),
        pipeline_state=res.state,
    )
