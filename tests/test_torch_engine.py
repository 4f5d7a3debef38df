"""Port parity, engine: repro_torch.engine against repro.engine.

The JAX package's float parameters are carried across with
``convert.params_from_jax``; both engines quantize them, and every integer
result is compared exactly (tolerance 0): weights, thresholds, readouts,
per-layer spike and input counts.  Sizes are reduced (gesture 16x16 T=4,
optical flow 8x16 T=3) so the CPU runs in seconds.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, cuda_device, jax_ref  # noqa: F401
from repro_torch.compiler import compile_network
from repro_torch.configs import spidr_gesture, spidr_optflow
from repro_torch.convert import params_from_jax
from repro_torch.core.quant import QuantSpec
from repro_torch.engine import inference as E

NETS = {"gesture": ((16, 16), 4), "flow": ((8, 16), 3)}
BITS = (4, 6, 8)


def _specs(jax_ref, net):
    hw, t = NETS[net]
    if net == "gesture":
        return (spidr_gesture.reduced(hw=hw, timesteps=t),
                jax_ref.spidr_gesture.reduced(hw=hw, timesteps=t))
    return (spidr_optflow.reduced(hw=hw, timesteps=t),
            jax_ref.spidr_optflow.reduced(hw=hw, timesteps=t))


def _events(net, batch=2, seed=0, density=0.25):
    hw, t = NETS[net]
    rng = np.random.default_rng([seed, batch, hw[0]])
    return (rng.random((t, batch) + hw + (2,)) < density).astype(np.float32)


_CACHE: dict = {}  # (what, net[, bits]) -> reference results, per process


def _jax_params(jax_ref, net):
    """Float params from the reference's own initializer, as numpy."""
    key = ("params", net)
    if key not in _CACHE:
        _, spec_j = _specs(jax_ref, net)
        _CACHE[key] = [None if p is None else np.asarray(p) for p in
                       jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(0),
                                                   spec_j)]
    return _CACHE[key]


def _engines(jax_ref, net, bits, backend="fused", t_block=1, jax_backend="jnp"):
    spec, spec_j = _specs(jax_ref, net)
    params = _jax_params(jax_ref, net)
    mine = E.build_engine(spec, params_from_jax(params, "cpu"),
                          E.EngineConfig(QuantSpec(bits), backend=backend,
                                         t_block=t_block), device="cpu")
    theirs = jax_ref.engine.build_engine(
        spec_j, [None if p is None else jax_ref.jnp.asarray(p) for p in params],
        jax_ref.engine.EngineConfig(jax_ref.quant.QuantSpec(bits),
                                    backend=jax_backend, interpret=True))
    return mine, theirs


def _jax_run(jax_ref, net, bits):
    """The reference engine's whole-stream output (jnp backend), cached."""
    key = ("run", net, bits)
    if key not in _CACHE:
        _, theirs = _engines(jax_ref, net, bits)
        out = jax_ref.engine.run_engine(theirs, jax_ref.jnp.asarray(_events(net)))
        _CACHE[key] = tuple(np.asarray(x) for x in (
            out.readout, out.spike_counts, out.input_counts))
    return _CACHE[key]


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("bits", BITS)
def test_build_engine_reproduces_jax_quantization(jax_ref, net, bits):
    mine, theirs = _engines(jax_ref, net, bits)
    assert [el.kind for el in mine.layers] == [el.kind for el in theirs.layers]
    for a, b in zip(mine.layers, theirs.layers):
        if a.kind in ("conv", "fc"):
            assert a.w_q.dtype == torch.int8
            assert_same(a.w_q, b.w_q)
            assert a.w_scale == b.w_scale
            assert a.thr_int == b.thr_int and isinstance(a.thr_int, int)
            assert (a.kh, a.kw, a.stride, a.padding) == \
                (b.kh, b.kw, b.stride, b.padding)
        else:
            assert a.target_hw == b.target_hw


def _assert_output(out, want):
    readout, spikes, inputs = want
    assert out.readout.dtype == torch.int32
    assert_same(out.readout, readout)
    assert_same(out.spike_counts, spikes)
    assert_same(out.input_counts, inputs)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("backend,t_block", [("torch", 1), ("fused", 1),
                                             ("fused", 2), ("fused", 3)])
def test_run_engine_matches_jax(jax_ref, net, bits, backend, t_block):
    mine, _ = _engines(jax_ref, net, bits, backend=backend, t_block=t_block)
    want = _jax_run(jax_ref, net, bits)
    assert int(want[1].sum()) > 0, "the test stream must make spikes"
    _assert_output(E.run_engine(mine, _events(net)), want)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("bits", BITS)
def test_run_reference_matches_jax(jax_ref, net, bits):
    mine, _ = _engines(jax_ref, net, bits)
    _assert_output(E.run_reference(mine, _events(net)), _jax_run(jax_ref, net, bits))


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("chunk", [1, 3, "T"])
@pytest.mark.parametrize("t_block", [1, 2, 3])
@pytest.mark.parametrize("bits", BITS)
def test_run_chunk_matches_whole_stream_jax(jax_ref, net, chunk, t_block, bits):
    mine, _ = _engines(jax_ref, net, bits, t_block=t_block)
    events = _events(net)
    total = events.shape[0]
    chunk = total if chunk == "T" else chunk
    state = E.init_state(mine, events.shape[1])
    spikes, inputs, readouts = [], [], []
    for t0 in range(0, total, chunk):
        state, out = E.run_chunk(mine, state, events[t0:t0 + chunk],
                                 collect_readouts=True)
        spikes.append(out.spike_counts)
        inputs.append(out.input_counts)
        readouts.append(out.readouts)
        assert_same(out.readout, state.readout_acc)
        assert_same(out.slot_spike_counts.sum(dim=2), out.spike_counts)
    readout, want_spikes, want_inputs = _jax_run(jax_ref, net, bits)
    assert_same(state.readout_acc, readout)
    assert_same(torch.cat(spikes), want_spikes)
    assert_same(torch.cat(inputs), want_inputs)
    assert_same(torch.cat(readouts)[-1], readout)
    assert_same(state.out_counts.sum(dim=1), want_spikes.sum(axis=0))
    assert_same(state.in_counts.sum(dim=1), want_inputs.sum(axis=0))


@pytest.mark.parametrize("net", sorted(NETS))
def test_chunk_state_matches_jax_chunk_state(jax_ref, net):
    """Per-slot state after a partial stream: Vmem carries, counters."""
    mine, theirs = _engines(jax_ref, net, 6, t_block=2)
    events = _events(net)[:2]
    s_mine, o_mine = E.run_chunk(mine, E.init_state(mine, 2), events)
    s_j, o_j = jax_ref.engine.run_chunk(
        theirs, jax_ref.engine.init_state(theirs, 2), jax_ref.jnp.asarray(events))
    for a, b in zip(s_mine.vmem, s_j.vmem):
        assert (a is None) == (b is None)
        if a is not None:
            assert_same(a, b)
    for f in ("readout_acc", "out_counts", "in_counts"):
        assert_same(getattr(s_mine, f), getattr(s_j, f))
    for f in ("slot_spike_counts", "slot_input_counts"):
        assert_same(getattr(o_mine, f), getattr(o_j, f))


def test_fused_backend_matches_jax_pallas_interpret(jax_ref):
    """One case against the reference's fused (Pallas, interpret) path."""
    mine, theirs = _engines(jax_ref, "gesture", 4, jax_backend="fused")
    events = _events("gesture")[:2]
    out = E.run_engine(mine, events)
    want = jax_ref.engine.run_engine(theirs, jax_ref.jnp.asarray(events))
    _assert_output(out, (want.readout, want.spike_counts, want.input_counts))


@pytest.mark.parametrize("net", sorted(NETS))
def test_reset_slot_matches_jax(jax_ref, net):
    mine, theirs = _engines(jax_ref, net, 4)
    events = _events(net, batch=3)
    s_mine, _ = E.run_chunk(mine, E.init_state(mine, 3), events)
    s_j, _ = jax_ref.engine.run_chunk(
        theirs, jax_ref.engine.init_state(theirs, 3), jax_ref.jnp.asarray(events))
    r_mine, r_j = E.reset_slot(s_mine, 1), jax_ref.engine.reset_slot(s_j, 1)
    for a, b in zip(r_mine.vmem, r_j.vmem):
        if a is not None:
            assert_same(a, b)
            assert int(a[1].abs().sum()) == 0
    for f in ("readout_acc", "out_counts", "in_counts"):
        assert_same(getattr(r_mine, f), getattr(r_j, f))
    # The input state is untouched (reset_slot returns a new state).
    assert int(s_mine.out_counts[:, 1].sum()) == int(np.asarray(s_j.out_counts)[:, 1].sum())


def test_engine_config_validation():
    with pytest.raises(ValueError, match="backend"):
        E.EngineConfig(QuantSpec(4), backend="jnp")
    with pytest.raises(ValueError, match="t_block"):
        E.EngineConfig(QuantSpec(4), t_block=0)
    spec = spidr_gesture.reduced(hw=(8, 8), timesteps=1)
    params = params_from_jax([None if l.kind not in ("conv", "fc") else
                              np.ones((9 * l.c_in if l.kind == "conv" else l.c_in,
                                       l.c_out), np.float32) for l in spec.layers], "cpu")
    engine = E.build_engine(spec, params, E.EngineConfig(QuantSpec(4)), device="cpu")
    with pytest.raises(ValueError, match="precision"):
        E.compile_engine(engine, compile_network(spec, n_cores=2, qspec=QuantSpec(8)))
    plan = E.compile_engine(engine, compile_network(spec, n_cores=2, qspec=QuantSpec(4)))
    with pytest.raises(ValueError, match="already carries a schedule"):
        E.compile_engine(plan, plan.schedule)


@pytest.mark.gpu
@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("t_block", [1, 3])
def test_fused_on_card_matches_cpu(cuda_device, net, t_block):
    """On the card the fused backend (CUDA kernels) equals the CPU run."""
    spec = (spidr_gesture.reduced(hw=(16, 16), timesteps=4) if net == "gesture"
            else spidr_optflow.reduced(hw=(8, 16), timesteps=3))
    from repro_torch.core.network import init_params

    params = init_params(torch.Generator().manual_seed(0), spec)
    cfg = E.EngineConfig(QuantSpec(4), backend="fused", t_block=t_block)
    cpu = E.run_engine(E.build_engine(spec, params, cfg, device="cpu"), _events(net))
    gpu = E.run_engine(E.build_engine(spec, params, cfg, device=cuda_device),
                       _events(net))
    for a, b in zip(dataclasses.astuple(gpu), dataclasses.astuple(cpu)):
        assert_same(a, b)


def _wide_fan_in_net(k):
    """chip_smoke.py's network of fan-in ``k`` (a 1x1 conv at 8x8 into an
    FC layer): past B1's ring from K = 1,345, past the tile loop's
    resident weight slice at 7,105."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._wide_fan_in_net(k)


@pytest.mark.gpu
@pytest.mark.parametrize("k,t_block", [(1345, 1), (7105, 1), (7105, 4)])
def test_wide_fan_in_on_card_matches_torch_backend(cuda_device, k, t_block):
    """No fan-in is refused on the card: the fused engine (B1 or B2 on the
    tile loop, K-chunked at 7,105) equals backend="torch" bit for bit."""
    from repro_torch import spidr
    from repro_torch.core.network import init_params
    from repro_torch.kernels import LAUNCHES, fused_lif_gemm as fk

    spec = _wide_fan_in_net(k)
    assert fk.tc_plan(128, k, 32, 132).route == "tile"
    params = init_params(torch.Generator().manual_seed(0), spec)
    ev = (torch.rand((4, 2, 8, 8, k), generator=torch.Generator().manual_seed(1))
          < 0.1).to(torch.float32).to(cuda_device)
    want = spidr.compile(spec, params, spidr.DeployTarget(weight_bits=8, backend="torch"),
                         device=cuda_device).run(ev)
    name = "fused_lif_gemm_int" if t_block == 1 else "fused_lif_gemm_int_tblk"
    before = LAUNCHES[name]
    got = spidr.compile(spec, params, spidr.DeployTarget(
        weight_bits=8, backend="fused", t_block=t_block), device=cuda_device).run(ev)
    torch.cuda.synchronize()
    assert LAUNCHES[name] > before
    assert int(want.spike_counts.sum()) > 0
    for a, b in ((got.readout, want.readout), (got.spike_counts, want.spike_counts),
                 (got.input_counts, want.input_counts)):
        assert_same(a, b)


@pytest.mark.parametrize("k", [1345, 7105])
def test_wide_fan_in_net_runs_on_cpu(k):
    """The wide fan-in network compiles and runs on the CPU, fused equal to
    torch, with spikes in both layers (the card's test compares the same)."""
    from repro_torch import spidr
    from repro_torch.core.network import init_params
    from repro_torch.kernels import fused_lif_gemm as fk

    spec = _wide_fan_in_net(k)
    assert spec.layer_shapes()[0].fan_in == k
    assert fk.tc_plan(128, k, 32, 132).route == "tile"
    params = init_params(torch.Generator().manual_seed(0), spec)
    ev = (torch.rand((4, 2, 8, 8, k), generator=torch.Generator().manual_seed(1))
          < 0.1).to(torch.float32)
    want = spidr.compile(spec, params, spidr.DeployTarget(weight_bits=8, backend="torch"),
                         device="cpu").run(ev)
    got = spidr.compile(spec, params, spidr.DeployTarget(weight_bits=8, backend="fused",
                                                         t_block=4), device="cpu").run(ev)
    assert bool((want.spike_counts.sum(dim=0) > 0).all())
    for a, b in ((got.readout, want.readout), (got.spike_counts, want.spike_counts)):
        assert_same(a, b)
