"""Port parity, multi-core execution: compile_engine, the multi-core layer
update, batch_mode and the spidr facade on a plan, against repro.engine.

The reference runs a plan as a lockstep ``vmap`` over per-core channel
slices; the port reassembles the slices and launches once per layer
(``engine/inference.py``'s docstring).  Either way the integers must be
the same: every run is compared exactly (tolerance 0) with the port's
single-core engine and with the reference's multi-core engine
(``backend="jnp"``): readout, per-layer spike and input counts, and the
state between chunks.  Sizes are reduced (16x16, T=3) so the CPU runs in
seconds; the 8-bit optical-flow plan splits seven of its eight layers
across two cores.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, cuda_device, jax_ref  # noqa: F401
from repro_torch import kernels, spidr
from repro_torch.compiler import compile_network
from repro_torch.configs import spidr_gesture, spidr_optflow
from repro_torch.convert import params_from_jax
from repro_torch.core.network import init_params
from repro_torch.core.quant import QuantSpec
from repro_torch.engine import inference as E
from repro_torch.engine.cost import MulticoreCost
from repro_torch.launch import optical_flow, serve
from repro_torch.snn.data import make_flow_batch

HW, T = (16, 16), 3
NETS = ("gesture", "flow")


def _specs(jax_ref, net):
    if net == "gesture":
        return (spidr_gesture.reduced(hw=HW, timesteps=T),
                jax_ref.spidr_gesture.reduced(hw=HW, timesteps=T))
    return (spidr_optflow.reduced(hw=HW, timesteps=T),
            jax_ref.spidr_optflow.reduced(hw=HW, timesteps=T))


def _events(net, batch=2, seed=0):
    rng = np.random.default_rng([seed, batch, len(net)])
    return (rng.random((T, batch) + HW + (2,)) < 0.25).astype(np.float32)


_CACHE: dict = {}


def _params(jax_ref, net):
    if ("params", net) not in _CACHE:
        _, spec_j = _specs(jax_ref, net)
        _CACHE[("params", net)] = [
            None if p is None else np.asarray(p)
            for p in jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(0), spec_j)]
    return _CACHE[("params", net)]


def _engines(jax_ref, net, bits, n_cores, backend="fused", t_block=1):
    """(port plan, port single core, reference plan) on the same params."""
    spec, spec_j = _specs(jax_ref, net)
    params = _params(jax_ref, net)
    base = E.build_engine(spec, params_from_jax(params, "cpu"),
                          E.EngineConfig(QuantSpec(bits), backend=backend,
                                         t_block=t_block), device="cpu")
    plan = E.compile_engine(base, compile_network(spec, n_cores=n_cores,
                                                  qspec=QuantSpec(bits)))
    q_j = jax_ref.quant.QuantSpec(bits)
    base_j = jax_ref.engine.build_engine(
        spec_j, [None if p is None else jax_ref.jnp.asarray(p) for p in params],
        jax_ref.engine.EngineConfig(q_j, backend="jnp"))
    plan_j = jax_ref.engine.compile_engine(
        base_j, jax_ref.compiler.compile_network(spec_j, n_cores=n_cores, qspec=q_j))
    return plan, base, plan_j


def _jax_run(jax_ref, net, bits, n_cores):
    key = ("run", net, bits, n_cores)
    if key not in _CACHE:
        *_, plan_j = _engines(jax_ref, net, bits, n_cores)
        out = jax_ref.engine.run_engine(plan_j, jax_ref.jnp.asarray(_events(net)))
        _CACHE[key] = tuple(np.asarray(x) for x in (
            out.readout, out.spike_counts, out.input_counts))
    return _CACHE[key]


def _joined(cores, core_slices):
    """The active per-core slices, unpadded, concatenated in ``lo`` order."""
    active = sorted((lo, hi, c) for c, (lo, hi) in enumerate(core_slices) if hi > lo)
    return torch.cat([cores[c, :, :hi - lo] for lo, hi, c in active], dim=1)


def _assert_out(out, want):
    for got, w in zip((out.readout, out.spike_counts, out.input_counts), want):
        assert got.dtype == torch.int32
        assert_same(got, w)


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("n_cores", [2, 3, 4])
def test_compile_engine_matches_reference(jax_ref, net, bits, n_cores):
    plan, base, plan_j = _engines(jax_ref, net, bits, n_cores)
    assert plan.device_parallel is False and base.schedule is None
    assert plan.schedule.describe() == plan_j.schedule.describe()
    for el, el_j, el0 in zip(plan.layers, plan_j.layers, base.layers, strict=True):
        if el.kind not in ("conv", "fc"):
            assert el.w_cores is None and el_j.w_cores is None
            continue
        assert el.w_cores.dtype == torch.int8
        assert_same(el.w_cores, el_j.w_cores)
        assert el.core_slices == el_j.core_slices
        assert el.thr_cores is None and el_j.thr_cores is None
        # The active slices in lo order are the single-core layer again, so
        # the plan's layers run on the single-core operands.
        assert_same(_joined(el.w_cores, el.core_slices), el0.w_q)
        assert_same(el.w_q, el0.w_q)
        assert el.thr_int == el0.thr_int


def _exported_engines(jax_ref, net, n_cores, backend="fused", t_block=1):
    """The reference's export of its params, deployed in both packages."""
    from repro_torch.snn import export

    spec, spec_j = _specs(jax_ref, net)
    params = _params(jax_ref, net)
    ex_j = jax_ref.export.export_network(
        [None if p is None else jax_ref.jnp.asarray(p) for p in params], spec_j,
        jax_ref.quant.QuantSpec(8))
    ex = export.ExportedNetwork(ex_j.name, 8, tuple(
        None if l is None else export.ExportedLayer(l.w_q, l.scale, l.thr_int)
        for l in ex_j.layers))
    mine = export.deploy(ex, spec, E.EngineConfig(QuantSpec(8), backend=backend,
                                                  t_block=t_block),
                         n_cores=n_cores, device="cpu")
    theirs = jax_ref.export.deploy(ex_j, spec_j, n_cores=n_cores)
    return mine, theirs


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("n_cores", [2, 4])
def test_compile_engine_per_channel_matches_reference(jax_ref, net, n_cores):
    mine, theirs = _exported_engines(jax_ref, net, n_cores)
    padded = 0
    for el, el_j in zip(mine.layers, theirs.layers, strict=True):
        if el.kind not in ("conv", "fc"):
            continue
        assert_same(el.w_cores, el_j.w_cores)
        assert_same(el.thr_cores, el_j.thr_cores)
        assert el.core_slices == el_j.core_slices
        assert_same(_joined(el.w_cores, el.core_slices), el.w_q)
        assert_same(_joined(el.thr_cores[:, None], el.core_slices)[0], el.thr_int)
        padded += int((el.thr_cores == QuantSpec(8).v_max + 1).sum())
    assert padded > 0, "some per-core threshold slice must carry padding"
    ev = _events(net)
    out = E.run_engine(mine, ev)
    want = jax_ref.engine.run_engine(theirs, jax_ref.jnp.asarray(ev))
    _assert_out(out, [np.asarray(x) for x in (want.readout, want.spike_counts,
                                              want.input_counts)])


CASES = [("flow", 8), ("flow", 4), ("gesture", 4), ("gesture", 8)]


@pytest.mark.parametrize("net,bits", CASES)
@pytest.mark.parametrize("backend,t_block", [("torch", 1), ("fused", 1), ("fused", 3)])
def test_multicore_run_matches_reference_and_one_core(jax_ref, net, bits, backend,
                                                      t_block):
    plan, base, _ = _engines(jax_ref, net, bits, 4, backend, t_block)
    want = _jax_run(jax_ref, net, bits, 4)
    assert int(want[1].sum()) > 0, "the test stream must make spikes"
    out = E.run_engine(plan, _events(net))
    _assert_out(out, want)
    _assert_out(E.run_engine(base, _events(net)), want)


@pytest.mark.parametrize("net,bits", CASES)
def test_multicore_run_reference_matches(jax_ref, net, bits):
    plan, _, _ = _engines(jax_ref, net, bits, 4)
    _assert_out(E.run_reference(plan, _events(net)), _jax_run(jax_ref, net, bits, 4))


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("t_block", [1, 3])
def test_multicore_chunk_state_matches_reference(jax_ref, net, t_block):
    """Chunks of 1 and 2 timesteps: the state between chunks is equal."""
    plan, _, plan_j = _engines(jax_ref, net, 8, 4, "fused", t_block)
    ev = _events(net)
    state = E.init_state(plan, 2)
    state_j = jax_ref.engine.init_state(plan_j, 2)
    for lo, hi in ((0, 1), (1, 3)):
        state, out = E.run_chunk(plan, state, ev[lo:hi])
        state_j, out_j = jax_ref.engine.run_chunk(plan_j, state_j,
                                                  jax_ref.jnp.asarray(ev[lo:hi]))
        for v, v_j in zip(state.vmem, state_j.vmem, strict=True):
            if v is None:
                assert v_j is None
            else:
                assert_same(v, v_j)
        for a, b in ((state.readout_acc, state_j.readout_acc),
                     (state.out_counts, state_j.out_counts),
                     (state.in_counts, state_j.in_counts),
                     (out.slot_spike_counts, out_j.slot_spike_counts),
                     (out.slot_input_counts, out_j.slot_input_counts)):
            assert_same(a, b)


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("n_cores", [1, 4])
@pytest.mark.parametrize("t_block", [1, 3])
def test_batch_mode_vmap_equals_fold(jax_ref, net, n_cores, t_block):
    plan, base, _ = _engines(jax_ref, net, 8, max(n_cores, 2), "fused", t_block)
    engine = plan if n_cores > 1 else base
    ev = _events(net, batch=3)
    fold = E.run_engine(engine, ev, batch_mode="fold")
    vmap = E.run_engine(engine, ev, batch_mode="vmap")
    for a, b in ((fold.readout, vmap.readout), (fold.spike_counts, vmap.spike_counts),
                 (fold.input_counts, vmap.input_counts)):
        assert a.dtype == b.dtype == torch.int32
        assert_same(a, b)


@pytest.mark.parametrize("net", NETS)
def test_batch_mode_vmap_matches_reference(jax_ref, net):
    plan, _, plan_j = _engines(jax_ref, net, 8, 4)
    ev = _events(net, batch=3)
    want = jax_ref.engine.run_engine(plan_j, jax_ref.jnp.asarray(ev), batch_mode="vmap")
    _assert_out(E.run_engine(plan, ev, batch_mode="vmap"),
                [np.asarray(x) for x in (want.readout, want.spike_counts,
                                         want.input_counts)])
    with pytest.raises(ValueError, match="batch_mode"):
        E.run_engine(plan, ev, batch_mode="pmap")


def test_compile_engine_rejects_non_contiguous_slices(jax_ref):
    _, base, _ = _engines(jax_ref, "flow", 8, 4)
    sched = compile_network(base.spec, n_cores=4, qspec=QuantSpec(8))
    ls = sched.layers[0]
    lo, hi = ls.slices
    gap = dataclasses.replace(hi, lo=hi.lo + 1)  # channel 16 belongs to no core
    bad = dataclasses.replace(sched, layers=(dataclasses.replace(
        ls, slices=(lo, gap)),) + sched.layers[1:])
    with pytest.raises(ValueError, match="contiguous"):
        E.compile_engine(base, bad)


def test_device_parallel_raises_as_the_reference(jax_ref, monkeypatch):
    spec, spec_j = _specs(jax_ref, "flow")
    params = _params(jax_ref, "flow")
    with pytest.raises(AssertionError, match="device_parallel needs 4 devices"):
        jax_ref.spidr.compile(spec_j, params, jax_ref.spidr.DeployTarget(
            n_cores=4, device_parallel=True), check="off")
    target = spidr.DeployTarget(n_cores=4, device_parallel=True)
    with pytest.raises(ValueError, match="device_parallel needs 4 devices"):
        spidr.compile(spec, params_from_jax(params, "cpu"), target, device="cpu")
    # With four devices (here four CPU stand-ins) the cores spread over
    # them and the plan runs bit-exact with one core.
    monkeypatch.setattr(E, "_core_devices", lambda: [torch.device("cpu")] * 4)
    plan = spidr.compile(spec, params_from_jax(params, "cpu"), target, device="cpu")
    assert plan.engine.device_parallel and plan.verify(_events("flow")).exact


@pytest.mark.parametrize("net", NETS)
def test_facade_plan_verifies_and_prices_as_the_reference(jax_ref, net, tmp_path):
    spec, spec_j = _specs(jax_ref, net)
    params = _params(jax_ref, net)
    compiled = spidr.compile(spec, params_from_jax(params, "cpu"),
                             spidr.DeployTarget(weight_bits=8, n_cores=4), device="cpu")
    compiled_j = jax_ref.spidr.compile(spec_j, params, jax_ref.spidr.DeployTarget(
        weight_bits=8, n_cores=4), check="off")
    assert compiled.n_cores == 4 and compiled.schedule == compiled.engine.schedule
    ev = _events(net)
    report = compiled.verify(ev)
    assert report.exact and report.reference_exact
    assert report.single_core_exact is True and report.roundtrip is None
    out = compiled.run(ev)
    out_j = compiled_j.run(jax_ref.jnp.asarray(ev))
    mine, theirs = compiled.cost(out), compiled_j.cost(out_j)
    assert isinstance(mine, MulticoreCost)
    for field in ("makespan_cycles", "single_core_compute_cycles", "duplication_cycles",
                  "load_imbalance", "energy_uj", "routing_energy_uj", "mean_sparsity"):
        assert getattr(mine, field) == getattr(theirs, field), field
    assert_same(mine.compute_cycles, theirs.compute_cycles)
    assert_same(mine.routing_cycles, theirs.routing_cycles)
    events = compiled.pipeline_trace(out, path=tmp_path / "trace.json")
    assert events == compiled_j.pipeline_trace(out_j)
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]


def test_pipeline_trace_needs_a_plan():
    spec = spidr_gesture.reduced(hw=(8, 8), timesteps=1)
    compiled = spidr.compile(spec, init_params(torch.Generator().manual_seed(0), spec),
                             device="cpu")
    assert compiled.schedule is None and compiled.n_cores == 1
    with pytest.raises(ValueError, match="single-core"):
        compiled.pipeline_trace(input_counts=np.zeros((1, 6)))


def test_optical_flow_walk_runs_on_cpu():
    out = optical_flow.run("cpu", hw=(16, 16), timesteps=2, batch=2,
                           t_blocks=(1, 2), log=lambda _: None)
    assert out["ok"] and out["float_forward"]["finite"]
    assert len(out["deployments"]) == 12
    rows = {(r["deployment"], r["weight_bits"], r["n_cores"], r["t_block"]): r
            for r in out["deployments"]}
    assert rows[("per-tensor", 8, 4, 1)]["split_layers"] == 7
    assert rows[("per-tensor", 4, 4, 2)]["split_layers"] == 0
    assert all(r["bit_exact_vs_1core"] and r["bit_exact_vs_torch"]
               for r in out["deployments"])
    assert [m["mode"] for m in out["mapping"]] == [1] * 8


def test_optical_flow_walk_cli_prints_one_json_line(capsys):
    rc = optical_flow.main(["--device", "cpu", "--hw", "8", "16", "--timesteps", "2"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["hw"] == [8, 16]


def test_serve_cli_compiles_onto_cores():
    worker = {n: serve.serve_snn(serve.parse_args(
        ["--snn", "gesture", "--device", "cpu", "--requests", "2", "--capacity", "2",
         "--n-cores", str(n)])) for n in (1, 4)}
    for a, b in zip(worker[1].done, worker[4].done, strict=True):
        assert (a.readout == b.readout).all()


# ---------------------------------------------------------------------------
# On the card: full width, both integer kernels, launches counted.
# ---------------------------------------------------------------------------
def _flow_full(dev):
    spec = spidr_optflow.CONFIG
    params = init_params(torch.Generator().manual_seed(0), spec)
    events, _ = make_flow_batch(torch.Generator().manual_seed(1), batch=2,
                                timesteps=spec.timesteps, hw=spec.input_hw, device=dev)
    return spec, params, events


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("t_block", [1, 5])
def test_multicore_on_card_matches_torch_backend(cuda_device, bits, t_block):
    spec, params, events = _flow_full(cuda_device)
    want = spidr.compile(spec, params, spidr.DeployTarget(
        weight_bits=bits, backend="torch"), device=cuda_device).run(events)
    got = spidr.compile(spec, params, spidr.DeployTarget(
        weight_bits=bits, n_cores=4, t_block=t_block), device=cuda_device).run(events)
    for a, b in ((got.readout, want.readout), (got.spike_counts, want.spike_counts),
                 (got.input_counts, want.input_counts)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("t_block", [1, 5])
def test_multicore_launches_equal_one_core(cuda_device, bits, t_block):
    spec, params, events = _flow_full(cuda_device)
    counts = {}
    for n_cores in (1, 4):
        compiled = spidr.compile(spec, params, spidr.DeployTarget(
            weight_bits=bits, n_cores=n_cores, t_block=t_block), device=cuda_device)
        kernels.reset_launches()
        compiled.run(events)
        torch.cuda.synchronize(cuda_device)
        counts[n_cores] = dict(kernels.LAUNCHES)
    assert counts[1] == counts[4]
    name = "fused_lif_gemm_int" if t_block == 1 else "fused_lif_gemm_int_tblk"
    assert counts[4][name] > 0
