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


# ---------------------------------------------------------------------------
# CompiledSNN.run's CUDA graphs (engine/graphs.py): the dispatch rule and the
# cache on the CPU, with a stand-in for the capture; the graphs on the card.
# ---------------------------------------------------------------------------
def _small_compiled(backend="fused", device="cpu", **target):
    from repro_torch import spidr
    from repro_torch.core.network import init_params

    spec = spidr_gesture.reduced(hw=(16, 16), timesteps=3)
    params = init_params(torch.Generator().manual_seed(0), spec)
    return spidr.compile(spec, params, spidr.DeployTarget(backend=backend, **target),
                         device=device)


def _on_fake_card(compiled):
    """The same deployment with its engine labelled as on ``cuda:0``: what
    the dispatch rule reads, built without a card."""
    from repro_torch.spidr.compiled import CompiledSNN

    engine = dataclasses.replace(compiled.engine, device=torch.device("cuda", 0))
    return CompiledSNN(compiled.spec, compiled.target, engine)


@pytest.mark.parametrize("case,engaged", [
    ("cpu", False), ("card", True), ("card_torch", False), ("card_reference", False),
    ("card_device_parallel", False)])
def test_run_graph_engages_only_on_card_fused_one_device(monkeypatch, case, engaged):
    """The graph path engages where the engine is on a CUDA device, on the
    fused backend, with no layer spread over devices; never on the CPU."""
    from repro_torch.engine import graphs

    if case == "cpu":
        compiled = _small_compiled()
        assert not graphs.graphable(compiled.engine)
        ev = torch.from_numpy(_events("gesture", batch=2)[:3])
        assert compiled._graphs is None
        out = compiled.run(ev)
        assert_same(out.readout, E.run_engine(compiled.engine, ev).readout)
        return
    if case == "card_device_parallel":
        monkeypatch.setattr(E, "_core_devices", lambda: [torch.device("cpu")] * 2)
        compiled = _small_compiled(n_cores=2, device_parallel=True)
        assert any(el.core_devs for el in compiled.engine.layers)
    else:
        backend = {"card": "fused", "card_torch": "torch",
                   "card_reference": "reference"}[case]
        compiled = _small_compiled(backend)
    card = _on_fake_card(compiled)
    assert graphs.graphable(card.engine) is engaged
    assert (card._graphs is not None) is engaged


class _StandInGraph:
    """What ``RunGraphs`` needs of a captured graph, run eagerly on the CPU."""

    def __init__(self, engine, launches):
        self.engine, self.launches = engine, launches

    def replay(self, events):
        return E.run_engine(self.engine, events)


def _stand_in_capture(engine, events):
    """Records the launches a capture would (three B1 entries) into a
    stand-in graph."""
    import gc

    from repro_torch.kernels._build import count_launch, recording_launches

    assert not gc.isenabled(), "capture runs with the cycle collector paused"
    with recording_launches() as launches:
        for _ in range(3):
            count_launch("fused_lif_gemm_int")
    return _StandInGraph(engine, dict(launches))


@pytest.fixture
def fresh_registry():
    from repro_torch import obs

    obs.set_default_registry(obs.MetricsRegistry(enabled=True))
    yield obs.default_registry()
    obs.set_default_registry(obs.MetricsRegistry(enabled=False))


def test_run_graphs_key_capture_on_second_call_and_count(fresh_registry):
    """Keyed by shape, dtype and device; a shape runs eagerly on its first
    call, is captured and replayed on its second, replayed after; counters
    on the cache and in the registry; every call equal to the eager run."""
    from repro_torch.engine import graphs
    from repro_torch.kernels import LAUNCHES

    engine = _small_compiled().engine
    cache = graphs.RunGraphs(engine, capture=_stand_in_capture)
    a = torch.from_numpy(_events("gesture", batch=1)[:3])
    a2 = torch.from_numpy(_events("gesture", batch=1, seed=5)[:3])
    b = torch.from_numpy(_events("gesture", batch=2)[:3])
    c = a.to(torch.int8)                      # same shape, another dtype
    key = lambda x: (tuple(x.shape), x.dtype, engine.device)  # noqa: E731

    before = LAUNCHES["fused_lif_gemm_int"]
    for ev in (a, b, c, a2, a, a2):
        assert_same(cache.run(ev).readout, E.run_engine(engine, ev).readout)
    assert (cache.eager, cache.captures, cache.replays) == (3, 1, 3)
    assert list(cache._graphs) == [key(a)] and cache._seen == {key(b), key(c)}
    # The CPU launches no kernel; each replay adds the three the stand-in
    # capture recorded, the capture itself none.
    assert LAUNCHES["fused_lif_gemm_int"] - before == 3 * 3
    cache.run(c)
    assert (cache.captures, list(cache._graphs)) == (2, [key(a), key(c)])
    counters = fresh_registry.to_dict()
    assert counters["spidr_run_graph_captures_total"][0]["value"] == 2
    assert counters["spidr_run_graph_replays_total"][0]["value"] == 4


def test_run_graphs_past_the_bound_run_eagerly(monkeypatch):
    """Cycling through more shapes than the bound never captures on every
    call: the first ``MAX_GRAPHS`` shapes to repeat are captured once and
    kept; every other shape runs eagerly, however often it comes back."""
    from repro_torch.engine import graphs

    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    engine = _small_compiled().engine
    cache = graphs.RunGraphs(engine, capture=_stand_in_capture)
    shapes = [torch.from_numpy(_events("gesture", batch=n)[:3]) for n in (1, 2, 3)]
    for _ in range(4):
        for ev in shapes:
            assert_same(cache.run(ev).readout, E.run_engine(engine, ev).readout)
    assert (cache.captures, cache.replays, cache.eager) == (2, 6, 6)
    assert [k[0][1] for k in cache._graphs] == [1, 2] and not cache._seen
    monkeypatch.setattr(graphs, "_MAX_SEEN", 2)
    cache = graphs.RunGraphs(engine, capture=_stand_in_capture)
    for ev in shapes:                          # the third seen resets the memory
        cache.run(ev)
    assert len(cache._seen) == 1 and cache.eager == 3


def test_run_graphs_hold_no_reference_cycle():
    """A deployment's graphs go with its last reference, never later inside
    the cycle collector (a graph freed there during another capture would
    invalidate it); the collector is back on after a capture."""
    import gc
    import weakref

    from repro_torch.engine.graphs import RunGraphs

    card = _on_fake_card(_small_compiled())
    cache = RunGraphs(_small_compiled().engine, capture=_stand_in_capture)
    for _ in range(2):
        cache.run(torch.from_numpy(_events("gesture", batch=1)[:3]))
    assert cache.captures == 1 and gc.isenabled()
    refs = [weakref.ref(card), weakref.ref(card._graphs), weakref.ref(cache)]
    gc.disable()
    try:
        del card, cache
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()


def test_run_graphs_counters_off_by_default():
    from repro_torch import obs
    from repro_torch.engine.graphs import RunGraphs

    obs.set_default_registry(obs.MetricsRegistry(enabled=False))
    cache = RunGraphs(_small_compiled().engine, capture=_stand_in_capture)
    ev = torch.from_numpy(_events("gesture", batch=1)[:3])
    for _ in range(3):
        cache.run(ev)
    assert (cache.eager, cache.captures, cache.replays) == (1, 1, 2)
    assert "spidr_run_graph_replays_total" not in obs.default_registry().to_prometheus()


def test_recording_launches_is_per_thread():
    """A capture's launches are recorded for its own thread only: another
    thread's launches meanwhile reach the counter, and nesting raises."""
    import threading

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels._build import add_launches, count_launch, recording_launches

    before = LAUNCHES["spike_gemm"]
    with recording_launches() as rec:
        count_launch("spike_gemm")
        t = threading.Thread(target=count_launch, args=("spike_gemm",))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with pytest.raises(RuntimeError, match="nest"):
            with recording_launches():
                pass
    assert rec == {"spike_gemm": 1}
    assert LAUNCHES["spike_gemm"] - before == 1
    add_launches(rec)
    assert LAUNCHES["spike_gemm"] - before == 2
    count_launch("spike_gemm")
    assert LAUNCHES["spike_gemm"] - before == 3


def _card_deployment(net, cuda_device, t_block=1):
    from repro_torch import spidr
    from repro_torch.configs import spidr_gesture as g, spidr_optflow as f
    from repro_torch.core.network import init_params

    spec = g.CONFIG if net == "gesture" else f.CONFIG
    params = init_params(torch.Generator().manual_seed(3), spec)
    return spidr.compile(spec, params, spidr.DeployTarget(t_block=t_block),
                         device=cuda_device)


# gesture-run's and flow-run's batches.
_CARD_SHAPES = {"gesture": (20, 4, 64, 64, 2), "flow": (10, 2, 288, 384, 2)}


def _card_events(shape, seed, device, density=0.08):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand(shape, generator=g, device=device) < density).to(torch.float32)


def _host(out):
    return tuple(t.cpu() for t in (out.readout, out.spike_counts, out.input_counts))


@pytest.mark.gpu
@pytest.mark.parametrize("net,t_block", [("gesture", 1), ("flow", 1), ("gesture", 5)])
def test_run_graph_on_card_equals_eager(cuda_device, net, t_block):
    """Over calls with other inputs (eager, then capture and replays) every
    result equals the eager run bit for bit, and the first replay the plain
    PyTorch reference; an earlier call's tensors survive later calls; the
    launch counter moves per call exactly as the eager path's."""
    from repro_torch.kernels import LAUNCHES

    compiled = _card_deployment(net, cuda_device, t_block)
    assert compiled._graphs is not None
    shape = _CARD_SHAPES[net]
    n_weight = sum(el.kind in ("conv", "fc") for el in compiled.engine.layers)
    kept = []
    for i in range(5):
        ev = _card_events(shape, 100 + i, cuda_device)
        before = dict(LAUNCHES)
        want = E.run_engine(compiled.engine, ev)
        torch.cuda.synchronize()
        eager = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        before = dict(LAUNCHES)
        got = compiled.run(ev)
        torch.cuda.synchronize()
        assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == eager
        name = "fused_lif_gemm_int" if t_block == 1 else "fused_lif_gemm_int_tblk"
        assert eager[name] == n_weight * -(-shape[0] // t_block)
        for a, b in zip(_host(got), _host(want)):
            assert_same(a, b)
        if i == 1:                             # the capture's replay
            for a, b in zip(_host(got), _host(E.run_reference(compiled.engine, ev))):
                assert_same(a, b)
        kept.append((got, _host(want)))
    assert int(kept[0][1][1].sum()) > 0
    for got, want in kept:                     # nothing overwrote an earlier result
        for a, b in zip(_host(got), want):
            assert_same(a, b)
    cache = compiled._graphs
    assert (cache.eager, cache.captures, cache.replays) == (1, 1, 4)


@pytest.mark.gpu
def test_run_graph_on_card_captures_on_second_call_up_to_the_bound(cuda_device):
    """Each new shape runs eagerly, is captured and replayed on its second
    call and replayed on its third; past ``MAX_GRAPHS`` shapes a new one runs eagerly
    on every call; host events replay the device events' graph.  Replays
    equal the eager run and the plain PyTorch reference."""
    from repro_torch.engine.graphs import MAX_GRAPHS

    compiled = _card_deployment("gesture", cuda_device)
    cache = compiled._graphs
    for b in range(1, MAX_GRAPHS + 2):
        for seed in (1, 2, 3):
            ev = _card_events((4, b, 64, 64, 2), seed, cuda_device)
            got = _host(compiled.run(ev))
            for a, w in zip(got, _host(E.run_engine(compiled.engine, ev))):
                assert_same(a, w)
            if seed == 2:
                for a, w in zip(got, _host(E.run_reference(compiled.engine, ev))):
                    assert_same(a, w)
    assert (cache.eager, cache.captures, cache.replays) == (MAX_GRAPHS + 3,
                                                            MAX_GRAPHS, 2 * MAX_GRAPHS)
    assert [k[0][1] for k in cache._graphs] == list(range(1, MAX_GRAPHS + 1))
    ev = _card_events((4, 1, 64, 64, 2), 4, cuda_device)
    host = compiled.run(ev.cpu())                          # host events: same graph
    assert (cache.captures, cache.replays) == (MAX_GRAPHS, 2 * MAX_GRAPHS + 1)
    for a, w in zip(_host(host), _host(E.run_engine(compiled.engine, ev))):
        assert_same(a, w)


@pytest.mark.gpu
def test_run_graph_on_card_two_threads(cuda_device):
    """Two threads, each on its own CUDA stream, call ``run`` on one
    deployment and each gets its own inputs' answers."""
    import threading

    compiled = _card_deployment("gesture", cuda_device)
    shape = _CARD_SHAPES["gesture"]
    inputs = {w: [_card_events(shape, 10 * w + i, cuda_device) for i in range(6)]
              for w in range(2)}
    want = {w: [_host(E.run_engine(compiled.engine, ev)) for ev in evs]
            for w, evs in inputs.items()}
    for _ in range(2):                                     # eager, then the capture
        compiled.run(inputs[0][0])
    assert compiled._graphs.captures == 1
    got, errors = {}, []

    def work(w):
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
                outs = [compiled.run(ev) for ev in inputs[w] for _ in range(3)]
                got[w] = [_host(o) for o in outs]
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(w,)) for w in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    for w in range(2):
        for i, outs in enumerate(got[w][j:j + 3] for j in range(0, 18, 3)):
            for out in outs:
                for a, b in zip(out, want[w][i]):
                    assert_same(a, b)
