"""Port parity, streaming: repro_torch.engine.streaming sessions, the
StreamSession facade, StreamWorker serving, the chunked data generators
and the obs telemetry, against repro.engine.streaming / repro.obs.

Every stream served through a port session must give, tick by tick, the
same ``SlotUpdate`` as the reference's manager on the same chunks: the
readout, the chunk's and the cumulative spikes, cycles, energy, per-core
cycles and load imbalance, compared exactly (tolerance 0).  The reference
runs on ``backend="jnp"`` (the same integers as its Pallas kernels); the
port on ``"fused"`` (the kernels' plain versions on the CPU), on the slab
path (``t_block=2``) and on ``"torch"``.  Sizes are reduced (16x16 or
24x32, T <= 6, capacity <= 3) so the CPU runs in seconds.
"""
import json
import logging

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, cuda_device, jax_ref  # noqa: F401
from repro_torch import obs, spidr
from repro_torch.configs import spidr_gesture, spidr_optflow
from repro_torch.convert import params_from_jax
from repro_torch.core.quant import QuantSpec
from repro_torch.engine import (EngineConfig, StreamSessionManager, build_engine,
                                estimate_cost, run_engine)
from repro_torch.serving import StreamRequest, StreamWorker
from repro_torch.snn import data

HW, T = (16, 16), 6
_CACHE: dict = {}


def _specs(jax_ref, net, hw=HW, t=T):
    mod, mod_j = ((spidr_gesture, jax_ref.spidr_gesture) if net == "gesture"
                  else (spidr_optflow, jax_ref.spidr_optflow))
    return mod.reduced(hw=hw, timesteps=t), mod_j.reduced(hw=hw, timesteps=t)


def _params(jax_ref, spec_j):
    key = (spec_j.name, spec_j.input_hw, spec_j.timesteps)
    if key not in _CACHE:
        _CACHE[key] = [None if p is None else np.asarray(p) for p in
                       jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(0),
                                                   spec_j)]
    return _CACHE[key]


def _pair(jax_ref, net="gesture", n_cores=1, backend="fused", t_block=1,
          hw=HW, t=T, capacity=2, chunk_T=2):
    """The same network and integers deployed by both packages."""
    spec, spec_j = _specs(jax_ref, net, hw, t)
    params = _params(jax_ref, spec_j)
    port = spidr.compile(spec, params_from_jax(params, "cpu"), spidr.DeployTarget(
        weight_bits=4, n_cores=n_cores, backend=backend, t_block=t_block,
        chunk_T=chunk_T, stream_capacity=capacity), device="cpu")
    ref = jax_ref.spidr.compile(
        spec_j, [None if p is None else jax_ref.jnp.asarray(p) for p in params],
        jax_ref.spidr.DeployTarget(weight_bits=4, n_cores=n_cores, backend="jnp",
                                   chunk_T=chunk_T, stream_capacity=capacity),
        check="off")
    return port, ref


def _streams(lens, hw=HW, seed=0, density=0.15):
    rng = np.random.default_rng(seed)
    return [(rng.random((t,) + tuple(hw) + (2,)) < density).astype(np.float32)
            for t in lens]


def _key(up):
    return (up.slot, up.timesteps, np.asarray(up.readout).tolist(),
            np.asarray(up.readout).dtype.str, up.chunk_spikes, up.spikes,
            up.cycles, up.energy_uj,
            None if up.per_core_cycles is None
            else np.asarray(up.per_core_cycles).tolist(), up.load_imbalance)


def _drive(session, streams, chunk_T):
    """Serve ``streams`` FIFO through ``session`` (either package's): open
    free slots, deliver every live stream's next chunk, close finished
    ones.  Returns each tick's ``{slot: _key(update)}``."""
    waiting, live, cursor, log = list(range(len(streams))), {}, {}, []
    while waiting or live:
        while waiting:
            slot = session.open()
            if slot is None:
                break
            live[slot], cursor[slot] = waiting.pop(0), 0
        chunks = {s: streams[r][cursor[s]:cursor[s] + chunk_T]
                  for s, r in live.items()}
        log.append({s: _key(u) for s, u in session.step(chunks).items()})
        for s in list(live):
            cursor[s] += chunks[s].shape[0]
            if cursor[s] >= streams[live[s]].shape[0]:
                session.close(s)
                del live[s]
    return log


# ---------------------------------------------------------------------------
# SlotUpdate parity with the reference manager, tick by tick.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_cores", [1, 4])
@pytest.mark.parametrize("chunk_T", [1, 3])
def test_slot_updates_equal_reference(jax_ref, n_cores, chunk_T):
    port, ref = _pair(jax_ref, n_cores=n_cores, capacity=2, chunk_T=chunk_T)
    streams = _streams([6, 4, 5])   # more streams than slots, short chunks
    got = _drive(port.open_stream(), streams, chunk_T)
    want = _drive(ref.open_stream(), streams, chunk_T)
    assert got == want
    assert len(got) >= 3 and any(k[6] > 0 for tick in got for k in tick.values())


@pytest.mark.parametrize("backend,t_block", [("fused", 2), ("torch", 1)])
def test_slot_updates_equal_reference_slab_path_and_torch(jax_ref, backend, t_block):
    """``t_block=2`` runs every tick through ``_run_chunk_tiled`` (B2 on the
    card); ``"torch"`` through the plain integer GEMM."""
    for chunk_T in (3, 4):
        port, ref = _pair(jax_ref, backend=backend, t_block=t_block,
                          capacity=3, chunk_T=chunk_T)
        streams = _streams([6, 5, 2, 6], seed=1)
        assert _drive(port.open_stream(), streams, chunk_T) \
            == _drive(ref.open_stream(), streams, chunk_T)


def test_vmem_readout_updates_equal_reference(jax_ref):
    """The optical-flow net: a Vmem readout (24x32) carried across ticks."""
    port, ref = _pair(jax_ref, net="flow", hw=(24, 32), t=4, capacity=2,
                      chunk_T=2)
    streams = _streams([4, 3, 4], hw=(24, 32), seed=2)
    got = _drive(port.open_stream(), streams, 2)
    assert got == _drive(ref.open_stream(), streams, 2)
    assert np.asarray(got[0][0][2]).shape == (24, 32, 2)


def test_metrics_text_equals_reference(jax_ref):
    """The same ticks recorded into private registries give the same
    Prometheus text and JSON dict (chunking-invariant counters, sparsity
    and tile histograms, per-slot gauges) on a 4-core plan."""
    port, ref = _pair(jax_ref, n_cores=4, capacity=2, chunk_T=2)
    reg, reg_j = obs.MetricsRegistry(), jax_ref.obs_metrics.MetricsRegistry()
    streams = _streams([6, 3, 4], seed=3)
    _drive(port.open_stream(metrics=reg, tracer=False), streams, 2)
    _drive(ref.open_stream(metrics=reg_j, tracer=False), streams, 2)
    assert reg.to_prometheus() == reg_j.to_prometheus()
    assert reg.to_dict() == reg_j.to_dict()
    assert "spidr_session_ticks_total" in reg.to_prometheus()


def test_metrics_totals_are_chunking_invariant(jax_ref):
    port, _ = _pair(jax_ref)
    streams = _streams([6, 6], seed=4)
    totals = []
    for chunk_T in (1, 2, 3):
        reg = obs.MetricsRegistry()
        _drive(port.open_stream(capacity=2, chunk_T=chunk_T, metrics=reg,
                                tracer=False), streams, chunk_T)
        d = reg.to_dict()
        totals.append({name: d[name][0]["value"] for name in (
            "spidr_stream_timesteps_total", "spidr_stream_input_spikes_total",
            "spidr_stream_output_spikes_total", "spidr_stream_cycles_total")})
    assert totals[0] == totals[1] == totals[2]
    assert totals[0]["spidr_stream_timesteps_total"] == 12


def test_telemetry_off_by_default_and_bit_exact(jax_ref):
    port, _ = _pair(jax_ref)
    assert not obs.metrics_enabled() and not obs.tracing_enabled()
    streams = _streams([6, 4], seed=5)
    plain = _drive(port.open_stream(), streams, 2)
    reg, tracer = obs.MetricsRegistry(), obs.Tracer()
    traced = _drive(port.open_stream(metrics=reg, tracer=tracer), streams, 2)
    assert plain == traced
    spans = [e for e in tracer.to_chrome()["traceEvents"] if e.get("ph") == "X"]
    assert [e["name"] for e in spans] == ["run_chunk"] * len(traced)
    assert spans[0]["args"] == {"tick": 0, "slots": 2}


# ---------------------------------------------------------------------------
# The session's own contract, against whole-stream runs.
# ---------------------------------------------------------------------------
def _engine(jax_ref, t=T, backend="fused", t_block=1):
    spec, spec_j = _specs(jax_ref, "gesture", HW, t)
    cfg = EngineConfig(QuantSpec(4), backend=backend, t_block=t_block)
    return build_engine(spec, params_from_jax(_params(jax_ref, spec_j), "cpu"),
                        cfg, device="cpu")


def _whole(eng, streams):
    return run_engine(eng, np.stack(streams, axis=1))


def test_slot_retirement_and_reuse_preserve_unrelated_slots(jax_ref):
    eng = _engine(jax_ref)
    ev = _streams([6, 6, 6], seed=8)
    whole = _whole(eng, ev).readout.numpy()
    mgr = StreamSessionManager(eng, capacity=2, chunk_T=2)
    sa, sb = mgr.open(), mgr.open()
    mgr.step({sa: ev[0][0:2], sb: ev[1][0:2]})
    mgr.close(sa)                   # stream 0 aborts; stream 2 reuses its slot
    sc = mgr.open()
    assert sc == sa
    up = mgr.step({sc: ev[2][0:2], sb: ev[1][2:4]})
    assert up[sc].timesteps == 2 and up[sb].timesteps == 4
    last = mgr.step({sc: ev[2][2:4], sb: ev[1][4:6]})
    assert_same(last[sb].readout, whole[1])
    mgr.close(sb)
    final = mgr.step({sc: ev[2][4:6]})
    assert_same(final[sc].readout, whole[2])


def test_idle_slots_cost_zero(jax_ref):
    eng = _engine(jax_ref)
    ev = _streams([6], seed=9, density=0.2)[0]
    mgr = StreamSessionManager(eng, capacity=4, chunk_T=2)
    s0 = mgr.open()
    for t0 in range(0, 6, 2):
        up = mgr.step({s0: ev[t0:t0 + 2]})
    assert up[s0].energy_uj > 0 and up[s0].cycles > 0
    idle = [i for i in range(4) if i != s0]
    assert all(mgr.slot_energy_uj[i] == 0 and mgr.slot_cycles[i] == 0 for i in idle)
    in_counts, out_counts = mgr.state.in_counts.numpy(), mgr.state.out_counts.numpy()
    assert (in_counts[:, idle] == 0).all() and (out_counts[:, idle] == 0).all()
    assert (in_counts[:, s0] > 0).any()
    for v in mgr.state.vmem:
        if v is not None:
            assert not v[idle].any()


def test_short_final_chunk_reads_out_the_true_end(jax_ref):
    eng = _engine(jax_ref, t=5)
    ev = _streams([5], seed=10)
    whole = _whole(eng, ev)
    mgr = StreamSessionManager(eng, capacity=2, chunk_T=3)
    s0 = mgr.open()
    mgr.step({s0: ev[0][0:3]})
    last = mgr.step({s0: ev[0][3:5]})       # 2 of 3 timesteps valid
    assert last[s0].timesteps == 5
    assert_same(last[s0].readout, whole.readout[0])
    assert last[s0].spikes == int(whole.spike_counts.sum())


def test_cumulative_cycles_are_chunking_invariant(jax_ref):
    eng = _engine(jax_ref)
    ev = _streams([6], seed=12)
    whole = _whole(eng, ev)
    want = estimate_cost(eng.spec, QuantSpec(4), whole.input_counts.numpy())
    for chunk_T in (1, 2, 3, 6):
        mgr = StreamSessionManager(eng, capacity=2, chunk_T=chunk_T)
        s0 = mgr.open()
        for t0 in range(0, 6, chunk_T):
            up = mgr.step({s0: ev[0][t0:t0 + chunk_T]})
        assert up[s0].cycles == want.makespan_cycles
        assert up[s0].energy_uj == pytest.approx(want.energy_uj, rel=1e-12)


def test_open_returns_none_when_full(jax_ref):
    mgr = StreamSessionManager(_engine(jax_ref), capacity=2, chunk_T=1)
    assert mgr.open() == 0 and mgr.open() == 1
    assert mgr.open() is None and mgr.occupancy == 2


def test_contract_violations_raise_before_touching_state(jax_ref):
    mgr = StreamSessionManager(_engine(jax_ref), capacity=3, chunk_T=2)
    ev = _streams([6], seed=11)[0]
    s0, s1 = mgr.open(), mgr.open()     # slot 2 stays free

    def frozen():
        d = mgr.state_dict()
        return [np.asarray(v).tobytes() for v in
                [x for x in d["engine_state"]["vmem"] if x is not None]
                + [d["table"]["timesteps"], d["table"]["ended"]]]

    before = frozen()
    with pytest.raises(ValueError, match="delivered no chunk"):
        mgr.step({s0: ev[0:2]})
    with pytest.raises(ValueError, match="timesteps"):
        mgr.step({s0: ev[0:3], s1: ev[0:2]})          # longer than chunk_T
    with pytest.raises(ValueError, match="frames"):
        mgr.step({s0: ev[0:2, :8], s1: ev[0:2]})
    with pytest.raises(ValueError, match="not active"):
        mgr.step({s0: ev[0:2], s1: ev[0:2], 2: ev[0:2]})
    assert frozen() == before and mgr.ticks == 0
    mgr.close(s1)
    mgr.step({s0: ev[0:2]})
    mgr.step({s0: ev[2:3]})                 # a short chunk ends the stream
    with pytest.raises(ValueError, match="short"):
        mgr.step({s0: ev[3:5]})
    with pytest.raises(ValueError, match="not active"):
        mgr.close(s1)
    mgr.close(s0)
    assert mgr.occupancy == 0


def test_session_device_other_than_the_engines_names_a9(jax_ref):
    with pytest.raises(ValueError, match="open_stream.*A9"):
        StreamSessionManager(_engine(jax_ref), capacity=2, chunk_T=2,
                             device="meta")
    assert StreamSessionManager(_engine(jax_ref), 2, 2, device="cpu").device.type == "cpu"


def test_stream_session_lifecycle_and_iter_chunks(jax_ref):
    port, _ = _pair(jax_ref, capacity=2, chunk_T=4)
    ev = _streams([6], seed=13)[0]
    whole = port.run(ev[:, None])
    with port.open_stream() as session:
        ups = list(session.iter_chunks(ev))
        assert [u.timesteps for u in ups] == [4, 6]
        assert_same(ups[-1].readout, whole.readout[0])
        assert session.occupancy == 0
        s = session.open()
        session.close(s)
        session.close(s)                    # idempotent
    assert session.closed and port.sessions[-1] is session
    session.close()
    with pytest.raises(RuntimeError, match="closed"):
        session.open()
    with pytest.raises(ValueError, match="capacity"):
        port.open_stream(capacity=0)


# ---------------------------------------------------------------------------
# StreamWorker: serving more streams than slots.
# ---------------------------------------------------------------------------
def test_stream_worker_matches_reference_worker(jax_ref):
    port, ref = _pair(jax_ref, n_cores=4, capacity=2, chunk_T=2)
    streams = _streams([6, 5, 6, 3, 4], seed=14)
    worker = StreamWorker(port, capacity=2, chunk_T=2)
    worker_j = jax_ref.serving.StreamWorker(ref, capacity=2, chunk_T=2)
    for rid, ev in enumerate(streams):
        worker.submit(StreamRequest(rid=rid, events=ev))
        worker_j.submit(jax_ref.serving.StreamRequest(rid=rid, events=ev))
    while worker.step():
        pass
    while worker_j.step():
        pass
    assert worker.ticks == worker_j.ticks
    assert [r.rid for r in worker.done] == [r.rid for r in worker_j.done]
    whole = port.run(np.stack([np.pad(e, [(0, 6 - len(e))] + [(0, 0)] * 3)
                               for e in streams], axis=1))
    for a, b in zip(worker.done, worker_j.done):
        assert_same(a.readout, b.readout)
        assert (a.cycles, a.energy_uj, a.cursor) == (b.cycles, b.energy_uj, b.cursor)
        assert a.first_reply_at is not None and a.done_at >= a.first_reply_at
        if len(streams[a.rid]) == 6:
            assert_same(a.readout, whole.readout[a.rid])
    assert not worker.slots and worker.sessions.occupancy == 0
    worker.shutdown()
    worker.shutdown()
    with pytest.raises(RuntimeError):
        worker.submit(StreamRequest(rid=9, events=streams[0]))


# ---------------------------------------------------------------------------
# Chunked data generators.
# ---------------------------------------------------------------------------
def test_gesture_chunks_concat_to_the_whole_stream():
    whole, labels = data.make_gesture_chunk(2, 0, batch=2, chunk_T=7, hw=HW,
                                            device="cpu")
    cat = torch.cat(list(data.iter_event_chunks(2, 7, 3, batch=2, hw=HW,
                                                device="cpu")))
    assert_same(cat, whole)
    for t0 in range(0, 6):
        part, lbl = data.make_gesture_chunk(2, t0, batch=2, chunk_T=2, hw=HW,
                                            device="cpu")
        assert_same(part, whole[t0:t0 + 2])
        assert_same(lbl, labels)
    assert whole.sum() > 0


def test_flow_chunks_equal_the_batch_of_the_same_seed():
    whole, flow = data.make_flow_batch(torch.Generator().manual_seed(3), batch=2,
                                       timesteps=5, hw=HW, device="cpu")
    cat = torch.cat(list(data.iter_event_chunks(3, 5, 2, batch=2, hw=HW,
                                                kind="flow", device="cpu")))
    assert_same(cat, whole)
    part, flow_c = data.make_flow_chunk(3, 3, batch=2, chunk_T=2, hw=HW,
                                        device="cpu")
    assert_same(part, whole[3:5])
    assert_same(flow_c, flow)
    with pytest.raises(ValueError, match="kind"):
        next(data.iter_event_chunks(3, 5, 2, kind="audio", device="cpu"))


def test_existing_batch_generators_keep_their_output():
    """``make_gesture_batch(generator, ...)`` draws as before the chunk path."""
    g = torch.Generator().manual_seed(0)
    ev, _ = data.make_gesture_batch(g, batch=3, timesteps=4, hw=HW, device="cpu")
    d = data.gesture_draws(torch.Generator().manual_seed(0), 3, 4, HW)
    assert_same(ev, data.render_gesture(d))
    assert_same(ev[2:], data.render_gesture(
        data.GestureDraws(d.labels, d.phases, d.noise_on[2:], d.noise_off[2:]), 2))


@pytest.mark.parametrize("t0", [0, 3, 7])
def test_flow_chunk_renderer_equals_reference_chunk(jax_ref, t0):
    key = jax_ref.jax.random.PRNGKey(5)
    tex, vel = jax_ref.data._flow_stream_params(key, 2, (16, 24), 0.05)
    want, _ = jax_ref.data.make_flow_chunk(key, t0, batch=2, chunk_T=3,
                                           hw=(16, 24))
    got = data.render_flow(torch.from_numpy(np.array(tex)),
                           torch.from_numpy(np.array(vel)), 3, t0)
    assert_same(got, want)


@pytest.mark.parametrize("t0", [0, 4, 9])
def test_gesture_chunk_renderer_given_reference_draws(jax_ref, t0):
    """The reference's own per-timestep draws at absolute timesteps
    ``[t0, t0 + 3)``, rendered at offset ``t0``.  As in
    ``test_torch_serving.py``'s whole-batch renderer test, float32 cos/sin
    differ in the last ulp between the frameworks and may flip a pixel that
    lies exactly on the band edge: at most 1e-3 of them."""
    jax = jax_ref.jax
    key, batch, hw = jax.random.PRNGKey(11), 2, (16, 16)
    labels, _, _, phases, k_noise = jax_ref.data._gesture_stream_params(key, batch)
    on, off = [], []
    for t in range(t0, t0 + 3):
        pairs = [jax.random.split(k) for k in
                 jax.random.split(jax.random.fold_in(k_noise, t), batch)]
        on.append([np.asarray(jax.random.bernoulli(k1, 0.002, hw)) for k1, _ in pairs])
        off.append([np.asarray(jax.random.bernoulli(k2, 0.002, hw)) for _, k2 in pairs])
    draws = data.GestureDraws(
        labels=torch.from_numpy(np.array(labels, np.int64)),
        phases=torch.from_numpy(np.array(phases)),
        noise_on=torch.from_numpy(np.array(on)),
        noise_off=torch.from_numpy(np.array(off)))
    got = data.render_gesture(draws, t0).numpy()
    want = np.asarray(jax_ref.data.make_gesture_chunk(key, t0, batch=batch,
                                                      chunk_T=3, hw=hw)[0])
    assert got.shape == want.shape
    assert (got != want).mean() <= 1e-3
    assert want.sum() > 0


def test_chunked_feed_through_a_session_is_bit_exact(jax_ref):
    eng = _engine(jax_ref)
    whole, _ = data.make_gesture_chunk(4, 0, batch=1, chunk_T=6, hw=HW, device="cpu")
    want = run_engine(eng, whole)
    mgr = StreamSessionManager(eng, capacity=2, chunk_T=2)
    s0 = mgr.open()
    for chunk in data.iter_event_chunks(4, 6, 2, batch=1, hw=HW, device="cpu"):
        last = mgr.step({s0: chunk[:, 0].numpy()})
    assert_same(last[s0].readout, want.readout[0])


# ---------------------------------------------------------------------------
# obs: the registry, tracer and logs equal the reference's.
# ---------------------------------------------------------------------------
def _record(reg):
    reg.counter("c_total", "a counter").inc(3)
    reg.counter("c_total", "a counter", labels={"slot": 1}).inc(0.5)
    reg.gauge("g", "a gauge").set(7)
    reg.gauge("g", "a gauge").dec(2)
    h = reg.histogram("h_seconds", "a histogram", edges=obs.metrics.LATENCY_BUCKETS_S)
    for v in (0.0001, 0.003, 0.3, 20.0, float("nan")):
        h.observe(v)
    reg.histogram("frac", labels={"a": "x"}).observe(0.5)


def test_registry_exports_equal_reference(jax_ref, tmp_path):
    reg, reg_j = obs.MetricsRegistry(), jax_ref.obs_metrics.MetricsRegistry()
    _record(reg)
    _record(reg_j)
    assert reg.to_prometheus() == reg_j.to_prometheus()
    assert reg.to_dict() == reg_j.to_dict()
    assert obs.metrics.FRACTION_BUCKETS == jax_ref.obs_metrics.FRACTION_BUCKETS
    assert obs.metrics.LATENCY_BUCKETS_S == jax_ref.obs_metrics.LATENCY_BUCKETS_S
    reg.write(tmp_path / "m.json")
    assert json.loads((tmp_path / "m.json").read_text()) == reg.to_dict()
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c_total")
    with pytest.raises(ValueError, match="ascending"):
        obs.metrics.Histogram((1.0, 0.5))


def test_disabled_registry_and_tracer_are_falsy_and_record_nothing(tmp_path):
    assert not obs.MetricsRegistry(False) and obs.MetricsRegistry()
    tracer = obs.Tracer(enabled=False)
    with tracer.span("x"):
        pass
    tracer.instant("y")
    assert not tracer and tracer.events == []
    live = obs.Tracer(max_events=2)
    for i in range(3):
        with live.span("s", i=i):
            pass
    assert live.dropped_events == 1
    live.export(tmp_path / "t.json")
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    ts = [e["ts"] for e in events if e["ph"] == "X"]
    assert ts == sorted(ts) and events[0]["ph"] == "M"


def test_json_logs_carry_the_request_id():
    import io

    stream = io.StringIO()
    logger = obs.logging_setup(json_mode=True, logger=logging.getLogger("t_json"),
                               stream=stream)
    obs.logging_setup(json_mode=True, logger=logger, stream=stream)  # idempotent
    assert len(logger.handlers) == 1
    with obs.request_context(7):
        logger.info("stream done")
    rec = json.loads(stream.getvalue().strip())
    assert rec["request_id"] == "7" and rec["message"] == "stream done"
