"""The autotuner and the roofline model against the JAX package:
``kernels.autotune`` (cache keys, the ``t_block`` candidates, the JSON
cache both ways), per-layer ``EngineLayer.kcfg`` in the engine (bit-exact
with the reference's engine under chunking, 1 and 4 cores),
``DeployTarget(autotune=True)``, ``roofline.PerfModel`` (equal to the
reference's bounds at the same peaks; the H100's by default) and
``CompiledSNN.roofline``."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, jax_ref  # noqa: F401
from repro_torch import obs, spidr
from repro_torch.compiler import compile_network
from repro_torch.configs import spidr_gesture
from repro_torch.convert import params_from_jax
from repro_torch.core.network import gesture_net, optical_flow_net
from repro_torch.core.quant import QuantSpec
from repro_torch.engine import inference as E
from repro_torch.kernels import autotune
from repro_torch.kernels._ring import BM, KSTEP, NB
from repro_torch.roofline import HW_PEAK, PerfModel

HW, T = (16, 16), 6
# One per weight layer of the reduced gesture net (6 weight layers).
KCFGS = ((128, 128, 128, 1), (128, 128, 128, 4), (128, 128, 128, 2),
         (128, 128, 128, 3), (128, 128, 128, 1), (128, 128, 128, 4))


@pytest.fixture
def fresh_cache():
    """Each test starts and ends with empty winner caches (both packages)."""
    autotune.clear_cache()
    yield autotune
    autotune.clear_cache()


def _gesture(jax_ref):
    spec = spidr_gesture.reduced(hw=HW, timesteps=T)
    spec_j = jax_ref.spidr_gesture.reduced(hw=HW, timesteps=T)
    params = [None if p is None else np.asarray(p) for p in
              jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(2), spec_j)]
    return spec, spec_j, params


def _events(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((T, batch) + HW + (2,)) < 0.2).astype(np.float32)


@pytest.mark.parametrize("args", [(4096, 18, 16, 4, 7), (1, 64, 11, 8, 15),
                                  (110592, 288, 32, 6, 11)])
def test_cache_key_equals_the_references(jax_ref, args):
    assert autotune.cache_key(*args) == jax_ref.autotune.cache_key(*args)


@pytest.mark.parametrize("net", ["gesture", "flow"])
def test_t_block_candidates_equal_the_references(jax_ref, net):
    spec = gesture_net() if net == "gesture" else optical_flow_net()
    timesteps = min(spec.timesteps, 8)
    for sh in spec.layer_shapes():
        rows = sh.out_positions if sh.kind == "conv" else 1
        ref = jax_ref.autotune._default_candidates(rows, sh.fan_in,
                                                   sh.out_channels, timesteps)
        port = autotune._default_candidates(timesteps)
        assert sorted(c.t_block for c in port) == sorted({c.t_block for c in ref})
        assert all(c.block == autotune.DEFAULT_BLOCK for c in port)


def test_cache_json_loads_in_either_package(jax_ref, fresh_cache, tmp_path):
    ref_at = jax_ref.autotune
    ref_at.clear_cache()
    try:
        # The reference writes, the port reads.
        ref_at._MEMORY_CACHE["r64_f144_c16_w4_v7"] = ref_at.KernelConfig(32, 128, 32, 2)
        ref_at._MEMORY_CACHE["r1_f64_c11_w4_v7"] = ref_at.KernelConfig(t_block=4)
        ref_at.save_cache(tmp_path / "ref.json")
        loaded = autotune.load_cache(tmp_path / "ref.json")
        assert loaded == {"r64_f144_c16_w4_v7": autotune.KernelConfig(32, 128, 32, 2),
                          "r1_f64_c11_w4_v7": autotune.KernelConfig(t_block=4)}
        hit = autotune.autotune_layer(64, 144, 16, 4, 7, device="cpu")
        assert hit.kcfg == (32, 128, 32, 2) and autotune.sweep_timings() == {}
        autotune.save_cache(tmp_path / "port.json")
        assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
        # The port races and writes, the reference reads.
        autotune.clear_cache()
        won = autotune.autotune_layer(16, 18, 8, 4, 7, timesteps=3, device="cpu",
                                      cache_path=tmp_path / "tuned.json")
        assert set(autotune.sweep_timings()["r16_f18_c8_w4_v7"]) == {1, 2, 3}
        ref_at.clear_cache()
        got = ref_at.load_cache(tmp_path / "tuned.json")
        assert {k: v.kcfg for k, v in got.items()} == {"r16_f18_c8_w4_v7": won.kcfg}
        assert json.loads((tmp_path / "tuned.json").read_text()) == {
            "r16_f18_c8_w4_v7": list(won.kcfg)}
    finally:
        ref_at.clear_cache()


def _with_kcfgs(engine, kcfgs):
    it = iter(kcfgs)
    layers = tuple(el if el.kind not in ("conv", "fc")
                   else dataclasses.replace(el, kcfg=next(it)) for el in engine.layers)
    return dataclasses.replace(engine, layers=layers)


@pytest.mark.parametrize("n_cores", [1, 4])
def test_forced_kcfgs_run_bit_exact_with_the_references_engine(jax_ref, n_cores):
    spec, spec_j, params = _gesture(jax_ref)
    RE, jnp = jax_ref.engine, jax_ref.jnp
    ref = RE.build_engine(spec_j, [None if p is None else jnp.asarray(p) for p in params],
                          RE.EngineConfig(jax_ref.quant.QuantSpec(4), backend="fused",
                                          interpret=True))
    port = E.build_engine(spec, params_from_jax(params, "cpu"),
                          E.EngineConfig(QuantSpec(4), backend="fused"), device="cpu")
    ref, port = _with_kcfgs(ref, KCFGS), _with_kcfgs(port, KCFGS)
    if n_cores > 1:
        ref = RE.compile_engine(ref, jax_ref.compiler.compile_network(
            spec_j, n_cores=n_cores, qspec=jax_ref.quant.QuantSpec(4)))
        port = E.compile_engine(port, compile_network(spec, n_cores=n_cores,
                                                      qspec=QuantSpec(4)))
        assert [el.kcfg for el in port.layers if el.kind in ("conv", "fc")] == list(KCFGS)
    assert E._tblk_active(port) and RE._tblk_active(ref)
    ev = _events()
    st, st_j = E.init_state(port, 2), RE.init_state(ref, 2)
    for lo, hi in ((0, 2), (2, 5), (5, 6)):
        st, out = E.run_chunk(port, st, ev[lo:hi])
        st_j, out_j = RE.run_chunk(ref, st_j, jnp.asarray(ev[lo:hi]))
        assert_same(out.readout, out_j.readout)
        assert_same(out.spike_counts, out_j.spike_counts)
        assert_same(out.input_counts, out_j.input_counts)
    for v, v_j in zip(st.vmem, st_j.vmem):
        if v is not None:
            assert_same(v, v_j)
    # And the same integers without any kcfg, in one chunk.
    plain = dataclasses.replace(port, layers=tuple(
        dataclasses.replace(el, kcfg=None) for el in port.layers))
    assert not E._tblk_active(plain)
    assert_same(E.run_engine(plain, ev).readout, out.readout)


def test_tblk_active_follows_a_layers_kcfg(jax_ref):
    spec, spec_j, params = _gesture(jax_ref)
    RE, jnp = jax_ref.engine, jax_ref.jnp
    pj = [None if p is None else jnp.asarray(p) for p in params]
    tp = params_from_jax(params, "cpu")
    for backend, backend_j in (("fused", "fused"), ("torch", "jnp")):
        port = E.build_engine(spec, tp, E.EngineConfig(QuantSpec(4), backend=backend),
                              device="cpu")
        ref = RE.build_engine(spec_j, pj, RE.EngineConfig(
            jax_ref.quant.QuantSpec(4), backend=backend_j, interpret=True))
        for kcfgs in ([None] * 6, [(128, 128, 128, 1)] * 6,
                      [None] * 5 + [(128, 128, 128, 4)], [(32, 32, 32, 2)] + [None] * 5):
            got = E._tblk_active(_with_kcfgs(port, kcfgs))
            assert got == RE._tblk_active(_with_kcfgs(ref, kcfgs))
            assert got == (backend == "fused" and any(
                k is not None and k[3] > 1 for k in kcfgs))


@pytest.mark.parametrize("net", ["gesture", "flow"])
@pytest.mark.parametrize("tuned", [False, True])
def test_perf_model_equals_the_references_at_the_same_peaks(jax_ref, net, tuned):
    spec = gesture_net() if net == "gesture" else optical_flow_net()
    spec_j = (jax_ref.network.gesture_net() if net == "gesture"
              else jax_ref.network.optical_flow_net())
    n = len(spec.layer_shapes())
    kw = dict(batch=4, t_block=2, block=(64, 32, 32))
    if tuned:
        kw.update(layer_kcfgs=[None if i % 3 == 0 else (64, 32, 32, 1 + i % 4)
                               for i in range(n)],
                  nonzero_tile_fracs=[0.1 + 0.1 * i for i in range(n)], timesteps=5)
    got = PerfModel(peaks=jax_ref.roofline.HW_PEAK).network_bound(spec, **kw)
    want = jax_ref.roofline.PerfModel().network_bound(spec_j, **kw)
    assert [dataclasses.asdict(lb) for lb in got["layers"]] == \
        [dataclasses.asdict(lb) for lb in want["layers"]]
    assert {k: v for k, v in got.items() if k != "layers"} == \
        {k: v for k, v in want.items() if k != "layers"}
    lb = PerfModel().layer_bound(1000, 288, 32, timesteps=4)
    lb_j = jax_ref.roofline.PerfModel(peaks=HW_PEAK).layer_bound(1000, 288, 32, timesteps=4)
    assert dataclasses.asdict(lb) == dataclasses.asdict(lb_j)
    assert lb.bottleneck == lb_j.bottleneck


def test_default_peaks_are_the_h100s():
    assert HW_PEAK == {"flops_bf16": 989e12, "ops_int8": 1979e12, "hbm_gbps": 3.35e12,
                       "ici_link_gbps": 50e9, "ici_links": 18, "hbm_gib": 80.0}
    assert PerfModel().peaks == HW_PEAK
    assert PerfModel(peaks={"hbm_gbps": 1.0}).peaks["ops_int8"] == 1979e12


def test_autotune_needs_the_fused_backend_as_the_reference(jax_ref):
    with pytest.raises(ValueError, match="autotune"):
        spidr.DeployTarget(autotune=True, backend="torch")
    with pytest.raises(ValueError, match="autotune"):
        spidr.DeployTarget(autotune=True, backend="reference")
    with pytest.raises(ValueError, match="autotune"):
        jax_ref.spidr.DeployTarget(autotune=True, backend="jnp")
    assert spidr.DeployTarget(autotune=True).autotune


def test_autotuned_deployment_is_bit_exact_and_priced(jax_ref, fresh_cache, tmp_path,
                                                      monkeypatch):
    spec, _, params = _gesture(jax_ref)
    tp = params_from_jax(params, "cpu")
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "cache.json"))
    prev_reg, prev_tr = obs.default_registry(), obs.default_tracer()
    obs.set_default_registry(obs.MetricsRegistry(enabled=True))
    obs.set_default_tracer(obs.Tracer(enabled=True))
    try:
        tuned = spidr.compile(spec, tp, spidr.DeployTarget(autotune=True, chunk_T=4),
                              device="cpu")
        d = obs.default_registry().to_dict()
        spans = [e["name"] for e in obs.default_tracer().events if e.get("ph") == "X"]
    finally:
        obs.set_default_registry(prev_reg)
        obs.set_default_tracer(prev_tr)
    kcfgs = [el.kcfg for el in tuned.engine.layers if el.kind in ("conv", "fc")]
    assert len(kcfgs) == 6 and all(k[:3] == autotune.DEFAULT_BLOCK for k in kcfgs)
    assert all(k[3] in (1, 2, 4, 6) for k in kcfgs)
    assert d["spidr_autotune_layers_total"][0]["value"] == 6
    assert len(d["spidr_autotune_kcfg_info"]) == 6
    assert spans.count("autotune") == 1 and spans.count("autotune.layer") == 6
    keys = set(json.loads((tmp_path / "cache.json").read_text()))
    assert keys == set(autotune.sweep_timings()) and len(keys) == 4
    ev = _events(3, seed=5)
    plain = spidr.compile(spec, tp, spidr.DeployTarget(backend="torch"), device="cpu")
    untuned = spidr.compile(spec, tp, spidr.DeployTarget(), device="cpu")
    out = tuned.run(ev)
    for other in (plain, untuned):
        o = other.run(ev)
        assert_same(out.readout, o.readout)
        assert_same(out.spike_counts, o.spike_counts)
    assert tuned.verify(ev).exact
    # Streaming on the autotuned engine: each slot equals its whole stream.
    with tuned.open_stream(capacity=3) as sess:
        slots = [sess.open() for _ in range(3)]
        for lo in range(0, T, 4):
            ups = sess.step({s: ev[lo:lo + 4, i] for i, s in enumerate(slots)})
        for i, s in enumerate(slots):
            assert_same(ups[s].readout, out.readout[i])
    # A reloaded cache races nothing and picks the same configs.
    autotune.clear_cache()
    again = spidr.compile(spec, tp, spidr.DeployTarget(autotune=True), device="cpu")
    assert autotune.sweep_timings() == {}
    assert [el.kcfg for el in again.engine.layers if el.kind in ("conv", "fc")] == kcfgs
    # A 4-core plan keeps the autotuned configs.
    plan = spidr.compile(spec, tp, spidr.DeployTarget(autotune=True, n_cores=4),
                         device="cpu")
    assert [el.kcfg for el in plan.engine.layers if el.kind in ("conv", "fc")] == kcfgs
    assert_same(plan.run(ev).readout, out.readout)


def test_compiled_roofline_prices_the_ring_tile(jax_ref, fresh_cache):
    spec, spec_j, params = _gesture(jax_ref)
    tp = params_from_jax(params, "cpu")
    tile = (BM, NB, KSTEP)
    c = spidr.compile(spec, tp, spidr.DeployTarget(t_block=2), device="cpu")
    got = c.roofline(batch=4)
    want = jax_ref.roofline.PerfModel(peaks=HW_PEAK).network_bound(
        spec_j, batch=4, t_block=2, block=tile, layer_kcfgs=[None] * 6)
    assert got["bound_us"] == want["bound_us"] > 0
    assert [lb.t_block for lb in got["layers"]] == [2] * 6
    # An autotuned layer is priced at its own t_block, on the ring's tile.
    c2 = spidr.compile(spec, tp, spidr.DeployTarget(), device="cpu")
    c2._base_engine = _with_kcfgs(c2._base_engine, KCFGS)
    got2 = c2.roofline(batch=1, timesteps=4)
    want2 = PerfModel().network_bound(spec, batch=1, timesteps=4, block=tile,
                                      layer_kcfgs=[tile + (k[3],) for k in KCFGS])
    assert got2["bound_us"] == want2["bound_us"]
    assert [lb.t_block for lb in got2["layers"]] == [min(k[3], 4) for k in KCFGS]


def test_autotuned_snapshot_restores_with_its_kcfgs(jax_ref, fresh_cache, tmp_path):
    spec, _, params = _gesture(jax_ref)
    tuned = spidr.compile(spec, params_from_jax(params, "cpu"),
                          spidr.DeployTarget(autotune=True), device="cpu")
    sess = tuned.open_stream(capacity=2, chunk_T=2)
    slot = sess.open()
    ev = _events(1)
    sess.step({slot: ev[:2, 0]})
    tuned.snapshot(tmp_path, step=1)
    back = spidr.restore(tmp_path, device="cpu")
    assert [el.kcfg for el in back.engine.layers] == [el.kcfg for el in tuned.engine.layers]
    up_a = sess.step({slot: ev[2:4, 0]})[slot]
    up_b = back.sessions[0].step({slot: ev[2:4, 0]})[slot]
    assert_same(up_a.readout, up_b.readout)
    assert (up_a.cycles, up_a.energy_uj) == (up_b.cycles, up_b.energy_uj)
    assert torch.equal(tuned.run(ev).readout, back.run(ev).readout)
