"""Port parity, the multi-core compiler and the chip models around it:
repro_torch.compiler, engine.cost.estimate_multicore_cost, obs.timeline,
core.s2a and core.zero_skip against the JAX package's.

Everything here is host-side Python and numpy in both packages, and every
field is compared with ``==`` (tolerance 0): schedules, per-layer plans and
their float estimates, multi-core costs (ints and floats), timelines, S2A
counts and zero-skip statistics.  Spike counts are drawn from a seeded
numpy generator.
"""
import dataclasses
import json

import numpy as np
import pytest

from _torch_parity import jax_ref  # noqa: F401
from repro_torch.compiler import (CoreGrid, build_graph, compile_network,
                                  partition_graph)
from repro_torch.core import network, s2a, zero_skip
from repro_torch.core.quant import SUPPORTED_PRECISIONS, QuantSpec
from repro_torch.engine import cost
from repro_torch.obs import timeline

NETS = ("gesture_net", "optical_flow_net")
BITS = (4, 6, 8)


def _nets(jax_ref, name):
    return getattr(network, name)(), getattr(jax_ref.network, name)()


def _plan_fields(plan) -> dict:
    return {"mode": plan.mode, "weight_bits": plan.spec.weight_bits,
            "stationarity": plan.stationarity,
            "mapping": dataclasses.asdict(plan.mapping),
            "est_cycles_per_ts": plan.est_cycles_per_ts,
            "est_traffic_cycles": plan.est_traffic_cycles,
            "est_energy_nj_per_ts": plan.est_energy_nj_per_ts}


def _schedule_fields(s) -> dict:
    return {
        "name": s.name, "n_cores": s.n_cores,
        "grid": (s.grid.n_cores, s.grid.route_cycles_per_spike),
        "qspec": s.qspec.weight_bits, "n_split_layers": s.n_split_layers,
        "cores_used": s.cores_used, "describe": s.describe(),
        "layers": [{
            "node": ls.node, "kind": ls.kind, "out_channels": ls.out_channels,
            "slices": [(c.core, c.lo, c.hi, c.width) for c in ls.slices],
            "plan": _plan_fields(ls.plan), "split": ls.split,
            "route_fractions": ls.route_fractions,
            "route_factor": ls.route_factor,
            "consumer_cores": ls.consumer_cores,
            "slice_of": [None if ls.slice_of(c) is None
                         else (ls.slice_of(c).lo, ls.slice_of(c).hi)
                         for c in range(s.n_cores)],
        } for ls in s.layers],
    }


def _assert_same_schedule(mine, theirs):
    assert _schedule_fields(mine) == _schedule_fields(theirs)


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n_cores", [1, 2, 3, 4])
def test_compile_network_matches_reference(jax_ref, name, bits, n_cores):
    spec, spec_j = _nets(jax_ref, name)
    mine = compile_network(spec, n_cores=n_cores, qspec=QuantSpec(bits))
    theirs = jax_ref.compiler.compile_network(
        spec_j, n_cores=n_cores, qspec=jax_ref.quant.QuantSpec(bits))
    _assert_same_schedule(mine, theirs)
    # Frozen and hashable: two compiles of one plan compare equal.
    assert mine == compile_network(spec, n_cores=n_cores, qspec=QuantSpec(bits))
    assert hash(mine) == hash(compile_network(spec, n_cores=n_cores,
                                              qspec=QuantSpec(bits)))


def test_flow_8bit_plan_splits_seven_layers_over_two_cores():
    plan = compile_network(network.optical_flow_net(), n_cores=4, qspec=QuantSpec(8))
    assert plan.n_split_layers == 7
    for ls in plan.layers[:7]:
        assert [(s.core, s.lo, s.hi) for s in ls.slices] == [(0, 0, 16), (1, 16, 32)]
    assert not plan.layers[7].split


VARIANTS = [
    {"force_mode": 1}, {"force_mode": 2},
    {"force_stationarity": "weight"}, {"force_stationarity": "vmem"},
    {"assumed_sparsity": 0.5}, {"assumed_sparsity": 0.99},
    {"force_mode": 2, "force_stationarity": "vmem", "assumed_sparsity": 0.7},
    {"allowed_specs": "all"},
]


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: "-".join(
    f"{k}={v[k]}" for k in sorted(v)))
def test_compile_network_overrides_match_reference(jax_ref, name, variant):
    spec, spec_j = _nets(jax_ref, name)
    kw, kw_j = dict(variant), dict(variant)
    if variant.get("allowed_specs") == "all":
        kw["allowed_specs"] = SUPPORTED_PRECISIONS
        kw_j["allowed_specs"] = jax_ref.quant.SUPPORTED_PRECISIONS
    mine = compile_network(spec, n_cores=4, qspec=QuantSpec(6), **kw)
    theirs = jax_ref.compiler.compile_network(
        spec_j, n_cores=4, qspec=jax_ref.quant.QuantSpec(6), **kw_j)
    _assert_same_schedule(mine, theirs)


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("n_cores", [1, 4])
def test_graph_and_partition_match_reference(jax_ref, name, n_cores):
    spec, spec_j = _nets(jax_ref, name)
    graph, graph_j = build_graph(spec), jax_ref.compiler.build_graph(spec_j)
    assert graph.name == graph_j.name
    assert [dataclasses.asdict(n) for n in graph.nodes] == \
        [dataclasses.asdict(n) for n in graph_j.nodes]
    assert [None if graph.producer_of(n) is None else graph.producer_of(n).idx
            for n in graph.nodes] == \
        [None if graph_j.producer_of(n) is None else graph_j.producer_of(n).idx
         for n in graph_j.nodes]
    for density in (0.02, 0.1, 0.5):
        parts = partition_graph(graph, CoreGrid(n_cores), QuantSpec(8), density)
        parts_j = jax_ref.compiler.partition_graph(
            graph_j, jax_ref.compiler.CoreGrid(n_cores),
            jax_ref.quant.QuantSpec(8), density)
        assert [(p.node, p.split, p.cores, [dataclasses.astuple(s) for s in p.slices])
                for p in parts] == \
            [(p.node, p.split, p.cores, [dataclasses.astuple(s) for s in p.slices])
             for p in parts_j]


def _counts(spec, t, seed):
    rng = np.random.default_rng([seed, t])
    n = len(spec.layer_shapes())
    return rng.integers(0, 40_000, (t, n)).astype(np.float64)


def _cost_fields(c) -> dict:
    return {
        "per_core": [dataclasses.asdict(dataclasses.replace(pc, pipeline_state=None))
                     for pc in c.per_core],
        "makespan_cycles": c.makespan_cycles,
        "compute_cycles": c.compute_cycles.tolist(),
        "routing_cycles": c.routing_cycles.tolist(),
        "busy_cycles": c.busy_cycles.tolist(),
        "single_core_compute_cycles": c.single_core_compute_cycles,
        "duplication_cycles": c.duplication_cycles,
        "load_imbalance": c.load_imbalance, "energy_uj": c.energy_uj,
        "routing_energy_uj": c.routing_energy_uj,
        "mean_sparsity": c.mean_sparsity,
        "pipeline_states": [{k: np.asarray(v).tolist() for k, v in s.to_dict().items()}
                            for s in c.pipeline_states],
        "timeline": c.timeline,
    }


def _schedules(jax_ref, name, bits, n_cores):
    spec, spec_j = _nets(jax_ref, name)
    return (spec, compile_network(spec, n_cores=n_cores, qspec=QuantSpec(bits)),
            spec_j, jax_ref.compiler.compile_network(
                spec_j, n_cores=n_cores, qspec=jax_ref.quant.QuantSpec(bits)))


def test_move_energy_constant_matches_reference(jax_ref):
    assert cost._MOVE_NJ_PER_CYCLE == jax_ref.cost._MOVE_NJ_PER_CYCLE


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n_cores", [2, 3, 4])
def test_multicore_cost_matches_reference(jax_ref, name, bits, n_cores):
    spec, sched, spec_j, sched_j = _schedules(jax_ref, name, bits, n_cores)
    counts = _counts(spec, 5, bits * 10 + n_cores)
    mine = cost.estimate_multicore_cost(spec, sched, counts, collect_timeline=True)
    theirs = jax_ref.cost.estimate_multicore_cost(spec_j, sched_j, counts,
                                                  collect_timeline=True)
    assert _cost_fields(mine) == _cost_fields(theirs)
    assert mine.load_imbalance >= 1.0
    assert int(mine.compute_cycles.sum()) == \
        mine.single_core_compute_cycles + mine.duplication_cycles


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("n_cores", [2, 4])
def test_multicore_cost_chunked_matches_reference(jax_ref, name, n_cores):
    """Chunk by chunk, threading ``pipeline_states``: every chunk's cost
    equals the reference's, and the last makespans equal one whole call."""
    spec, sched, spec_j, sched_j = _schedules(jax_ref, name, 8, n_cores)
    counts = _counts(spec, 7, n_cores)
    states = states_j = None
    for lo, hi in ((0, 2), (2, 3), (3, 7)):
        mine = cost.estimate_multicore_cost(spec, sched, counts[lo:hi],
                                            pipeline_states=states)
        theirs = jax_ref.cost.estimate_multicore_cost(
            spec_j, sched_j, counts[lo:hi], pipeline_states=states_j)
        assert _cost_fields(mine) == _cost_fields(theirs)
        states, states_j = mine.pipeline_states, theirs.pipeline_states
    whole = cost.estimate_multicore_cost(spec, sched, counts)
    assert [pc.makespan_cycles for pc in mine.per_core] == \
        [pc.makespan_cycles for pc in whole.per_core]


def test_multicore_cost_all_idle_is_balanced(jax_ref):
    spec, sched, spec_j, sched_j = _schedules(jax_ref, "optical_flow_net", 8, 4)
    zeros = np.zeros((3, len(sched.layers)))
    mine = cost.estimate_multicore_cost(spec, sched, zeros)
    assert mine.load_imbalance == 1.0
    assert _cost_fields(mine) == _cost_fields(
        jax_ref.cost.estimate_multicore_cost(spec_j, sched_j, zeros))


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("n_cores", [2, 4])
def test_timeline_matches_reference(jax_ref, name, n_cores, tmp_path):
    spec, sched, spec_j, sched_j = _schedules(jax_ref, name, 8, n_cores)
    counts = _counts(spec, 4, 7)
    mine = cost.estimate_multicore_cost(spec, sched, counts, collect_timeline=True)
    theirs = jax_ref.cost.estimate_multicore_cost(spec_j, sched_j, counts,
                                                  collect_timeline=True)
    events = timeline.multicore_timeline(mine, label="s", pid=3, ts_offset=10.0)
    assert events == jax_ref.timeline.multicore_timeline(theirs, label="s", pid=3,
                                                         ts_offset=10.0)
    totals = timeline.busy_cycle_totals(events)
    assert [totals.get(c, 0.0) for c in range(n_cores)] == \
        mine.busy_cycles.astype(float).tolist()
    timeline.export_timeline(mine, tmp_path / "a.json", label="s")
    jax_ref.timeline.export_timeline(theirs, tmp_path / "b.json", label="s")
    assert json.loads((tmp_path / "a.json").read_text()) == \
        json.loads((tmp_path / "b.json").read_text())
    with pytest.raises(ValueError, match="collect_timeline"):
        timeline.multicore_timeline(cost.estimate_multicore_cost(spec, sched, counts))


def _spike_map(seed, shape, density):
    return (np.random.default_rng(seed).random(shape) < density).astype(np.int8)


@pytest.mark.parametrize("density", [0.0, 0.02, 0.1, 0.5])
@pytest.mark.parametrize("fifo_depth", [1, 4, 16])
def test_simulate_s2a_matches_reference(jax_ref, density, fifo_depth):
    spikes = _spike_map(int(density * 100) + fifo_depth, (48, 40), density)
    got = s2a.simulate_s2a(spikes, s2a.S2AConfig(fifo_depth))
    want = jax_ref.s2a.simulate_s2a(spikes, jax_ref.s2a.S2AConfig(fifo_depth))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mean_run_length == want.mean_run_length


@pytest.mark.parametrize("batch", [1, 2, 15, 16, 64])
def test_switch_count_batched_matches_reference(jax_ref, batch):
    for n in (0, 1, 7, 100, 12_345):
        assert s2a.switch_count_batched(n, batch) == \
            jax_ref.s2a.switch_count_batched(n, batch)


@pytest.mark.parametrize("positions", [2, 1000, 288 * 384 * 2])
def test_aer_cost_model_matches_reference(jax_ref, positions):
    z, zj = zero_skip, jax_ref.zero_skip
    assert z.raw_bits(positions) == zj.raw_bits(positions)
    for framing in (0, 1, 3):
        assert z.address_bits(positions, framing) == zj.address_bits(positions, framing)
        assert z.aer_breakeven_sparsity(positions, framing) == \
            zj.aer_breakeven_sparsity(positions, framing)
        for sp in (0.0, 0.5, 0.947, 0.99, 1.0):
            assert z.aer_overhead(positions, sp, framing) == \
                zj.aer_overhead(positions, sp, framing)
        assert z.aer_bits(positions, 17, framing) == zj.aer_bits(positions, 17, framing)


@pytest.mark.parametrize("tile", [(1, 1), (8, 8), (16, 32), (128, 16)])
def test_tile_skip_and_sparsity_match_reference(jax_ref, tile):
    for density in (0.0, 0.01, 0.2):
        spikes = _spike_map(tile[0] + tile[1], (100, 70), density)
        assert zero_skip.tile_skip_fraction(spikes, tile) == \
            jax_ref.zero_skip.tile_skip_fraction(spikes, tile)
        assert zero_skip.sparsity(spikes) == jax_ref.zero_skip.sparsity(spikes)


def test_sparsity_profile_matches_reference(jax_ref):
    per_t = np.random.default_rng(5).random((3, 6))
    names = ["conv1", "conv2", "fc"]
    assert zero_skip.SparsityProfile(names, per_t).summary() == \
        jax_ref.zero_skip.SparsityProfile(names, per_t).summary()
