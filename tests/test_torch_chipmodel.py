"""Port parity, chip models: cim_macro, modes, energy, pipeline, engine.cost
and CompiledSNN.cost, against repro.core / repro.engine.cost.

These are host-side numpy in both packages; every number is compared
exactly (tolerance 0).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import jax_ref  # noqa: F401
from repro_torch import spidr
from repro_torch.configs import spidr_gesture
from repro_torch.convert import params_from_jax
from repro_torch.core import cim_macro, energy, modes, network, pipeline, quant
from repro_torch.engine import cost


def test_cim_macro_constants(jax_ref):
    theirs = jax_ref.cim_macro
    for name in ("CM_WEIGHT_ROWS", "CM_VMEM_ROWS", "CM_COLS", "IFSPAD_ROWS",
                 "IFSPAD_COLS", "NEURON_MACRO_CYCLES"):
        assert getattr(cim_macro, name) == getattr(theirs, name), name
    for nnz in (0, 1, 17, 2048):
        assert cim_macro.macro_cycles(nnz) == theirs.macro_cycles(nnz)


@pytest.mark.parametrize("name", ["gesture_net", "optical_flow_net"])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_map_layer_table2(jax_ref, name, bits):
    mine = getattr(network, name)()
    theirs = getattr(jax_ref.network, name)()
    core = modes.CoreConfig(quant.QuantSpec(bits))
    core_j = jax_ref.modes.CoreConfig(jax_ref.quant.QuantSpec(bits))
    for s, sj in zip(mine.layer_shapes(), theirs.layer_shapes(), strict=True):
        for force in (None, 1, 2):
            got = modes.map_layer(s, core, force_mode=force)
            want = jax_ref.modes.map_layer(sj, core_j, force_mode=force)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.total_passes == want.total_passes


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_mode_capacity_helpers(jax_ref, bits):
    assert modes.max_output_neurons_conv_mode1(quant.QuantSpec(bits)) == \
        jax_ref.modes.max_output_neurons_conv_mode1(jax_ref.quant.QuantSpec(bits))
    assert modes.max_input_neurons_fc_mode2() == jax_ref.modes.max_input_neurons_fc_mode2()
    with pytest.raises(ValueError, match="compiler.compile_network"):
        modes.map_layer(modes.LayerShape.fc(64, 11),
                        modes.CoreConfig(quant.QuantSpec(bits), n_cores=2))


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.8, 0.95, 0.99])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_energy_model(jax_ref, sparsity, bits):
    e, ej = energy, jax_ref.energy
    for hw, hwj in ((e.HW(), ej.HW()), (e.HW(150e6, 1.0), ej.HW(150e6, 1.0))):
        assert e.power_mw(hw) == ej.power_mw(hwj)
        assert e.gops(sparsity, bits, hw.freq_hz) == ej.gops(sparsity, bits, hwj.freq_hz)
        assert e.tops_per_watt(sparsity, bits, hw) == ej.tops_per_watt(sparsity, bits, hwj)
        assert e.chunk_energy_breakdown_nj(sparsity, hw) == \
            ej.chunk_energy_breakdown_nj(sparsity, hwj)
        assert e.chunk_energy_total_nj(sparsity, hw) == \
            ej.chunk_energy_total_nj(sparsity, hwj)
    assert e.cycles_per_chunk(sparsity) == ej.cycles_per_chunk(sparsity)
    assert e.energy_per_op_batched(bits) == ej.energy_per_op_batched(bits)


def test_table1_grid(jax_ref):
    assert energy.table1_grid() == jax_ref.energy.table1_grid()
    assert energy.TABLE1_PAPER == jax_ref.energy.TABLE1_PAPER


def _pipeline_equal(got, want):
    assert got.makespan == want.makespan
    assert got.sync_makespan == want.sync_makespan
    assert got.nu_busy == want.nu_busy
    np.testing.assert_array_equal(got.cm_busy, want.cm_busy)
    np.testing.assert_array_equal(got.per_timestep_finish, want.per_timestep_finish)
    for k, v in got.state.to_dict().items():
        np.testing.assert_array_equal(v, want.state.to_dict()[k])


@pytest.mark.parametrize("n_cm", [3, 9])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_pipeline(jax_ref, n_cm, seed):
    rng = np.random.default_rng([seed, n_cm])
    cycles = rng.integers(0, 400, (7, n_cm))
    cycles[rng.random(cycles.shape) < 0.3] = 0
    cfg = pipeline.PipelineConfig(n_cm=n_cm)
    cfg_j = jax_ref.pipeline.PipelineConfig(n_cm=n_cm)
    whole = pipeline.simulate_pipeline(cycles, cfg)
    _pipeline_equal(whole, jax_ref.pipeline.simulate_pipeline(cycles, cfg_j))
    # Resumed chunk by chunk from the previous chunk's state (and from the
    # explicit zero state): the same clocks as the reference, and as one call.
    for cut in (1, 3, 6):
        first = pipeline.simulate_pipeline(cycles[:cut], cfg,
                                           state=pipeline.PipelineState.zero(n_cm))
        first_j = jax_ref.pipeline.simulate_pipeline(cycles[:cut], cfg_j)
        _pipeline_equal(first, first_j)
        rest = pipeline.simulate_pipeline(cycles[cut:], cfg, state=first.state)
        rest_j = jax_ref.pipeline.simulate_pipeline(cycles[cut:], cfg_j,
                                                    state=first_j.state)
        _pipeline_equal(rest, rest_j)
        assert rest.makespan == whole.makespan
        back = pipeline.PipelineState.from_dict(first.state.to_dict())
        assert pipeline.simulate_pipeline(cycles[cut:], cfg, state=back).makespan == \
            whole.makespan
    assert pipeline.route_cycles(12.5) == jax_ref.pipeline.route_cycles(12.5)


def _cost_equal(got, want):
    for f in dataclasses.fields(got):
        if f.name != "pipeline_state":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for k, v in got.pipeline_state.to_dict().items():
        np.testing.assert_array_equal(v, want.pipeline_state.to_dict()[k])


def _gesture_run(jax_ref, bits=4):
    """A reduced gesture network through the port's engine: real counts."""
    spec = spidr_gesture.reduced(hw=(16, 16), timesteps=4)
    spec_j = jax_ref.spidr_gesture.reduced(hw=(16, 16), timesteps=4)
    params = [None if p is None else np.asarray(p) for p in
              jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(0), spec_j)]
    rng = np.random.default_rng(11)
    events = (rng.random((4, 2, 16, 16, 2)) < 0.2).astype(np.float32)
    compiled = spidr.compile(spec, params_from_jax(params, "cpu"),
                             spidr.DeployTarget(weight_bits=bits, backend="fused"),
                             device="cpu")
    return spec, spec_j, params, compiled, compiled.run(events)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_estimate_cost_on_real_counts(jax_ref, bits):
    spec, spec_j, _, _, out = _gesture_run(jax_ref, bits)
    counts = out.input_counts.numpy()
    assert counts.shape == (4, 6) and counts.sum() > 0
    q, qj = quant.QuantSpec(bits), jax_ref.quant.QuantSpec(bits)
    _cost_equal(cost.estimate_cost(spec, q, counts),
                jax_ref.cost.estimate_cost(spec_j, qj, counts))
    # Priced in two chunks with the pipeline state carried: the same numbers.
    first = cost.estimate_cost(spec, q, counts[:2])
    rest = cost.estimate_cost(spec, q, counts[2:], pipeline_state=first.pipeline_state)
    rest_j = jax_ref.cost.estimate_cost(
        spec_j, qj, counts[2:],
        pipeline_state=jax_ref.cost.estimate_cost(spec_j, qj, counts[:2]).pipeline_state)
    _cost_equal(rest, rest_j)


def test_compiled_cost_matches_reference(jax_ref):
    spec, spec_j, params, compiled, out = _gesture_run(jax_ref)
    theirs = jax_ref.spidr.compile(
        spec_j, [None if p is None else jax_ref.jnp.asarray(p) for p in params],
        jax_ref.spidr.DeployTarget(weight_bits=4, backend="jnp"))
    per_stream = out.input_counts.numpy() / 2
    _cost_equal(compiled.cost(input_counts=per_stream),
                theirs.cost(input_counts=per_stream))
    _cost_equal(compiled.cost(out), theirs.cost(input_counts=out.input_counts.numpy()))
    _cost_equal(compiled.cost(input_counts=out.input_counts),
                compiled.cost(input_counts=out.input_counts.numpy()))
    with pytest.raises(ValueError, match="spike statistics"):
        compiled.cost()
    assert isinstance(out.input_counts, torch.Tensor)
