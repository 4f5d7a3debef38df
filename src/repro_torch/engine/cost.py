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

``estimate_multicore_cost`` extends the same row-op model to a compiled
``repro_torch.compiler`` CoreSchedule: one async-handshake simulation per
core over the layers placed on it, AER spike-routing charged on the
receiving core (``core.pipeline.ROUTE_CYCLES_PER_SPIKE``), routed traffic
priced at the calibrated data-movement energy, and a load-imbalance
metric (max/mean per-core busy cycles).  Per-core cycle sums equal the
single-core total plus exactly the modeled overheads (routing +
split-layer duplication + rounding).

Host-side numpy, the same code and the same order of float operations as
``repro.engine.cost``, so every number (cycles, energies, imbalance)
equals the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..compiler.schedule import CoreSchedule
from ..core.energy import (
    HW, chunk_energy_breakdown_nj, chunk_energy_total_nj, cycles_per_chunk,
    gops, power_mw,
)
from ..core.modes import CoreConfig, map_layer
from ..core.network import SNNSpec
from ..core.pipeline import (
    PipelineConfig, PipelineState, route_cycles, simulate_pipeline,
)
from ..core.quant import QuantSpec

__all__ = ["EngineCost", "MulticoreCost", "estimate_cost",
           "estimate_multicore_cost"]


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


# ---------------------------------------------------------------------------
# Multi-core attribution: price a compiled CoreSchedule per core.
# ---------------------------------------------------------------------------

# Energy to push one spike one hop across the inter-core AER fabric, derived
# from the calibrated model's data-movement share: movement energy per cycle
# at the reference point, times the fabric's cycles per routed spike.
_MOVE_NJ_PER_CYCLE = (
    chunk_energy_breakdown_nj(0.95)["data_movement"] / cycles_per_chunk(0.95)
)


@dataclasses.dataclass
class MulticoreCost:
    """Per-core cost of one engine run under a compiled multi-core plan.

    ``compute_cycles`` / ``routing_cycles`` are the raw per-core sums of the
    spike-driven row-op model and the AER receive model; ``per_core`` holds
    the full async-handshake :class:`EngineCost` of each core's pipeline.
    The attribution invariant (tested):

        sum(compute_cycles) == single_core_compute_cycles + duplication

    i.e. splitting work across cores conserves total row-op cycles exactly,
    except for the *modeled* overheads — channel-split layers re-scan the
    routed input spikes on every core holding a slice (``duplication``),
    and every routed spike pays the fabric cost (``routing_cycles``).
    """

    per_core: list                       # of EngineCost, len n_cores
    makespan_cycles: int                 # max over cores (plan latency)
    compute_cycles: np.ndarray           # (C,) summed row-op cycles
    routing_cycles: np.ndarray           # (C,) AER receive cycles
    single_core_compute_cycles: int      # same row-op model, one core
    duplication_cycles: int              # split-layer re-scan overhead
    load_imbalance: float                # max/mean per-core busy (>= 1.0)
    energy_uj: float                     # compute + routing energy
    routing_energy_uj: float
    mean_sparsity: float
    pipeline_states: list                # per-core resume points (streaming)
    # Optional per-(layer, core) busy-cycle breakdown for the Chrome-trace
    # exporter (repro_torch.obs.timeline): list of {layer, name, core, cycles}
    # records where ``cycles[t]`` is exactly what that layer contributed to
    # this core's ``compute`` matrix at timestep t.  None unless the run
    # was priced with ``collect_timeline=True``.
    timeline: list | None = None

    @property
    def busy_cycles(self) -> np.ndarray:
        return self.compute_cycles + self.routing_cycles


def _slice_channel_tiles(width: int, parallel_channels: int) -> int:
    return max(1, math.ceil(width / parallel_channels))


def estimate_multicore_cost(
    spec: SNNSpec,
    schedule: CoreSchedule,
    input_counts: np.ndarray,   # (T, n_weight_layers) input spikes per layer
    hw: HW = HW(),
    n_cm: int = 9,
    pipeline_states: list | None = None,
    collect_timeline: bool = False,
) -> MulticoreCost:
    """Price one multi-core engine run, attributing cycles/energy per core.

    The spike statistics are the *same* ones the single-core model consumes
    (``EngineOutput.input_counts`` — the engine's outputs are bit-exact
    either way); what changes is where the row ops land.  Each core runs
    its own async-handshake pipeline simulation over the layers placed on
    it; routed spikes are charged at the fabric rate on the receiving core
    and priced at the calibrated data-movement energy.

    For streams priced chunk by chunk, thread ``pipeline_states`` (the
    previous chunk's ``cost.pipeline_states``) exactly like the single-core
    ``estimate_cost`` — per-core makespans stay chunking-invariant.

    ``collect_timeline=True`` additionally records the per-(layer, core)
    busy cycles of every timestep — exactly the values accumulated into
    the ``compute`` matrix, so the Chrome-trace exporter in
    ``repro_torch.obs.timeline`` conserves ``busy_cycles`` cycle for cycle.
    """
    counts = np.asarray(input_counts, dtype=np.float64)
    T, n_layers = counts.shape
    assert len(schedule.layers) == n_layers, (len(schedule.layers), n_layers)
    C = schedule.n_cores
    rcps = schedule.grid.route_cycles_per_spike

    compute = np.zeros((C, T, n_cm), dtype=np.int64)
    routing = np.zeros(C, dtype=np.int64)
    routed_spikes = 0.0
    single_total = 0
    passes_per_core = np.zeros(C, dtype=np.float64)
    # (layer index, core) -> per-timestep busy cycles, filled only when the
    # caller asked for the Chrome-trace breakdown.
    lane_cycles: dict = {}

    for li, ls in enumerate(schedule.layers):
        m = ls.plan.mapping
        active = m.pipelines * m.macros_per_pipeline
        full_ct = _slice_channel_tiles(ls.out_channels, m.parallel_channels)
        single_total += int(np.ceil(2.0 * counts[:, li] * full_ct).sum())
        for s in ls.slices:
            ct = _slice_channel_tiles(s.width, m.parallel_channels)
            per_macro = 2.0 * counts[:, li] * ct / active
            per_macro_cycles = np.ceil(per_macro).astype(np.int64)
            compute[s.core, :, :active] += per_macro_cycles[:, None]
            passes_per_core[s.core] += (
                ct * m.position_tiles * m.fan_in_tiles)
            if collect_timeline:
                # Total contribution to this core's compute matrix per
                # timestep: the per-macro ceil lands on ``active`` macros.
                key = (li, int(s.core))
                lane = lane_cycles.setdefault(
                    key, np.zeros(T, dtype=np.int64))
                lane += per_macro_cycles * active
        # Routing truth lives on the schedule (LayerSchedule.route_fractions,
        # computed once at compile time): charge each consumer core for the
        # share of the input plane it receives over the fabric.
        for c, frac in enumerate(ls.route_fractions):
            if frac > 0.0:
                recv = counts[:, li].sum() * frac
                routing[c] += route_cycles(recv, rcps)
                routed_spikes += recv

    states = pipeline_states or [None] * C
    per_core, new_states = [], []
    compute_sums = np.zeros(C, dtype=np.int64)
    for c in range(C):
        res = simulate_pipeline(compute[c], PipelineConfig(n_cm=n_cm),
                                state=states[c])
        compute_sums[c] = int(compute[c].sum())
        new_states.append(res.state)
        per_core.append(EngineCost(
            makespan_cycles=res.makespan,
            sync_makespan_cycles=res.sync_makespan,
            async_speedup=res.speedup_vs_sync,
            latency_ms=res.makespan / hw.freq_hz * 1e3,
            energy_uj=0.0,           # filled below (per-core passes share)
            avg_power_mw=power_mw(hw),
            mean_sparsity=0.0,
            gops_equivalent=0.0,
            pipeline_state=res.state,
        ))

    # Sparsity across all layer inputs, identical to the single-core model.
    shapes = spec.layer_shapes()
    positions = np.array(
        [s.fan_in * s.out_positions for s in shapes], dtype=np.float64)
    density = counts.sum() / (positions.sum() * T)
    sparsity = float(np.clip(1.0 - density, 0.0, 1.0))

    e_chunk = chunk_energy_total_nj(sparsity, hw)
    routing_energy_uj = routed_spikes * rcps * _MOVE_NJ_PER_CYCLE / 1e3
    energy_uj = float(passes_per_core.sum() * T * e_chunk / 1e3
                      + routing_energy_uj)
    for c in range(C):
        per_core[c].energy_uj = float(passes_per_core[c] * T * e_chunk / 1e3)
        per_core[c].mean_sparsity = sparsity

    busy = compute_sums + routing
    # An all-idle chunk (no spikes anywhere) is perfectly balanced: keep
    # the >= 1.0 invariant rather than reporting a meaningless 0.
    imbalance = float(busy.max() / busy.mean()) if busy.sum() else 1.0
    makespans = np.array([pc.makespan_cycles for pc in per_core])
    timeline = None
    if collect_timeline:
        timeline = [
            {
                "layer": li,
                "name": f"L{schedule.layers[li].node}:"
                        f"{schedule.layers[li].kind}",
                "core": core,
                "cycles": [int(v) for v in lane],
            }
            for (li, core), lane in sorted(lane_cycles.items())
        ]
    return MulticoreCost(
        per_core=per_core,
        makespan_cycles=int((makespans + routing).max()),
        compute_cycles=compute_sums,
        routing_cycles=routing,
        single_core_compute_cycles=int(single_total),
        duplication_cycles=int(compute_sums.sum() - single_total),
        load_imbalance=imbalance,
        energy_uj=energy_uj,
        routing_energy_uj=float(routing_energy_uj),
        mean_sparsity=sparsity,
        pipeline_states=new_states,
        timeline=timeline,
    )
