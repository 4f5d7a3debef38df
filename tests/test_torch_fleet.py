"""The serving fleet against the JAX package: ``spidr.serve``, ``ServeConfig``,
the session scheduler, live migration, crash re-placement, shedding, the
threaded mode, the ``spidr_fleet_*`` counters, the CLI's ``--replicas`` and
``compile_engine(device_parallel=True)``.

Each scenario runs the same arrival order through the port's fleet and the
reference's (``backend="torch"`` against ``"jnp"``, at
``spidr_gesture.reduced(hw=(16, 16), timesteps=6)``) and compares the
``(replica, slot)`` placement history, the shed count and every handle's
readout, cycles and energy, exactly.  The ``gpu`` tests place replicas on
CUDA streams and cards.
"""
import dataclasses
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, cuda_device, jax_ref  # noqa: F401
from repro_torch import obs, spidr
from repro_torch.configs import spidr_gesture, spidr_optflow
from repro_torch.convert import params_from_jax
from repro_torch.engine import inference as E
from repro_torch.launch import serve as launch_serve
from repro_torch.serving import (FleetOverloaded, ServeConfig, SessionScheduler,
                                 StreamRequest, StreamWorker)

HW, T = (16, 16), 6


_PARAMS: list = []


def _params_np(jax_ref) -> list:
    """Gesture params from the reference's initializer (seed 0), as numpy."""
    if not _PARAMS:
        spec_j = jax_ref.spidr_gesture.reduced(hw=HW, timesteps=T)
        _PARAMS.extend(None if p is None else np.asarray(p) for p in
                       jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(0),
                                                   spec_j))
    return list(_PARAMS)


def _pair(jax_ref, chunk_T=3, capacity=2, backend="torch"):
    """The same deployment in both packages: (port, reference)."""
    params = _params_np(jax_ref)
    spec = spidr_gesture.reduced(hw=HW, timesteps=T)
    spec_j = jax_ref.spidr_gesture.reduced(hw=HW, timesteps=T)
    port = spidr.compile(spec, params_from_jax(params, "cpu"), spidr.DeployTarget(
        weight_bits=4, backend=backend, chunk_T=chunk_T,
        stream_capacity=capacity), device="cpu")
    ref = jax_ref.spidr.compile(
        spec_j, [None if p is None else jax_ref.jnp.asarray(p) for p in params],
        jax_ref.spidr.DeployTarget(weight_bits=4, backend="jnp", chunk_T=chunk_T,
                                   stream_capacity=capacity), check="off")
    return port, ref


def _streams(n, t=T, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.random((t,) + HW + (2,)) < 0.1).astype(np.float32)
            for _ in range(n)]


def _whole(port, evs):
    return port.run(np.stack(evs, axis=1)).readout.numpy()


def _result(h) -> tuple:
    return (np.asarray(h.readout).tolist(), h.cycles, h.energy_uj, h.timesteps)


def _scenario(mod, compiled, evs, cfg: dict, hook=None, max_queue_resubmit=True):
    """Submit ``evs`` in order (shed ones re-submitted after a drain), tick
    the fleet, call ``hook(fleet, handles)`` after the first tick; return
    the placement history, shed count, results and the fleet."""
    fleet = mod.serve(compiled, mod.ServeConfig(**cfg))
    handles, shed = {}, []
    for i, e in enumerate(evs):
        try:
            handles[i] = fleet.submit(e, rid=i)
        except Exception as err:   # FleetOverloaded of either package
            assert type(err).__name__ == "FleetOverloaded"
            shed.append(i)
    fleet.step()
    if hook is not None:
        hook(fleet, handles)
    fleet.drain()
    if max_queue_resubmit:
        for i in shed:
            handles[i] = fleet.submit(evs[i], rid=i)
        fleet.drain()
    out = {"placements": {r: list(h.placements) for r, h in handles.items()},
           "shed": fleet.shed, "shed_rids": shed,
           "results": {r: _result(h) for r, h in handles.items()},
           "status": {r: h.status for r, h in handles.items()},
           "migrations": fleet.migrations, "crashes": fleet.crashes}
    fleet.shutdown()
    return out, fleet


def _both(jax_ref, cfg, evs, hook=None, backend="torch"):
    port, ref = _pair(jax_ref, backend=backend)
    got, _ = _scenario(spidr, port, evs, cfg, hook)
    want, _ = _scenario(jax_ref.spidr, ref, evs, cfg, hook)
    return got, want, port


# ---------------------------------------------------------------------------
# ServeConfig validation: the reference's errors, word for word.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [
    dict(n_replicas=0),
    dict(max_queue=0),
    dict(placement="random"),
    dict(mode="async"),
    dict(batch=True, migrate_every=2),
    dict(capacity=-1),
    dict(chunk_T=0),
    dict(devices=42),
])
def test_invalid_serve_config_raises_the_references_message(jax_ref, kwargs):
    with pytest.raises(ValueError) as got:
        ServeConfig(**kwargs)
    with pytest.raises(ValueError) as want:
        jax_ref.serving.ServeConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_replica_and_device_list_mismatches_raise_as_the_reference(jax_ref):
    port, ref = _pair(jax_ref)
    for mod, c in ((spidr, port), (jax_ref.spidr, ref)):
        with pytest.raises(ValueError, match="n_replicas"):
            mod.serve([c, c], mod.ServeConfig(n_replicas=3))
        with pytest.raises(ValueError):
            mod.serve([], mod.ServeConfig())
        with pytest.raises(ValueError, match="device"):
            mod.serve(c, mod.ServeConfig(n_replicas=2, devices=[None]))
    # An explicit replica list must be the same deployment, byte for byte.
    other = spidr.compile(port.spec, params_from_jax(
        [None if p is None else p + 0.05 for p in _params_np(jax_ref)], "cpu"),
        port.target, device="cpu")
    with pytest.raises(ValueError, match="byte-identical"):
        spidr.serve([port, other])
    fleet = spidr.serve([port, port])
    assert fleet.n_replicas == 2
    fleet.shutdown()


def test_device_resolution(jax_ref):
    port, _ = _pair(jax_ref)
    f = spidr.serve(port, n_replicas=2, devices="auto")
    # "auto" spreads only onto cards; a CPU deployment stays where it is.
    assert [w.device.type for w in f.workers] == ["cpu", "cpu"]
    f.shutdown()
    f = spidr.serve(port, n_replicas=2, devices=["cpu", torch.device("cpu")])
    assert all(w.sessions.device.type == "cpu" for w in f.workers)
    f.shutdown()
    # A batch fleet ignores devices, as the reference's does.
    f = spidr.serve(port, n_replicas=2, batch=True, devices=["cpu"] * 2)
    assert f.n_replicas == 2
    f.shutdown()
    assert port.engine_on("cpu") is port.engine and port.engine_on() is port.engine


# ---------------------------------------------------------------------------
# Deterministic placement, results and shedding against the reference.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("placement", ["least-loaded", "round-robin"])
def test_placements_and_results_match_the_reference(jax_ref, placement):
    evs = _streams(7)
    cfg = dict(n_replicas=2, capacity=2, chunk_T=3, placement=placement,
               max_queue=6)
    got, want, port = _both(jax_ref, cfg, evs)
    assert got["placements"] == want["placements"]
    assert got["shed"] == want["shed"] == 1 and got["shed_rids"] == [6]
    assert got["results"] == want["results"]
    whole = _whole(port, evs)
    for rid, (readout, *_rest) in got["results"].items():
        assert_same(np.asarray(readout), whole[rid])
    again, _ = _scenario(spidr, port, evs, cfg)
    assert again["placements"] == got["placements"]


def test_fused_backend_fleet_equals_the_torch_backend(jax_ref):
    evs = _streams(5, seed=4)
    cfg = dict(n_replicas=2, capacity=2, chunk_T=4)
    port_f, _ = _pair(jax_ref, chunk_T=4, backend="fused")
    port_t, _ = _pair(jax_ref, chunk_T=4, backend="torch")
    got, _ = _scenario(spidr, port_f, evs, cfg)
    want, _ = _scenario(spidr, port_t, evs, cfg)
    assert got == want


def test_overloaded_submit_sheds_explicitly(jax_ref):
    port, _ = _pair(jax_ref)
    fleet = spidr.serve(port, ServeConfig(n_replicas=1, capacity=1, chunk_T=3,
                                          max_queue=2))
    evs = _streams(4)
    fleet.submit(evs[0], rid=0)
    fleet.submit(evs[1], rid=1)
    with pytest.raises(FleetOverloaded, match="queue is full") as e:
        fleet.submit(evs[2], rid=2)
    assert (e.value.queue_depth, e.value.max_queue) == (2, 2)
    assert fleet.shed == 1 and set(fleet.handles) == {0, 1}
    fleet.drain()
    h = fleet.submit(evs[2], rid=2)
    fleet.drain()
    assert h.done
    assert_same(h.readout, _whole(port, evs)[2])
    fleet.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        fleet.submit(evs[3])


def test_scheduler_counts_and_queue_bound():
    sched = SessionScheduler([], max_queue=1)
    req = StreamRequest(rid=0, events=np.zeros((3,) + HW + (2,), np.float32))

    class H:
        rid, request, status = 0, req, "queued"

    sched.admit(H())
    with pytest.raises(FleetOverloaded):
        sched.admit(H())
    assert (sched.submitted, sched.shed, sched.queue_depth) == (1, 1, 1)


# ---------------------------------------------------------------------------
# Live migration.
# ---------------------------------------------------------------------------
def _migrate_first_running(fleet, handles):
    moved = next(h for h in handles.values() if h.status == "running")
    dst = fleet.migrate(moved.rid)
    assert moved.replica == dst and moved.migrations == 1


def test_mid_stream_migration_is_bit_exact(jax_ref):
    evs = _streams(3)
    cfg = dict(n_replicas=2, capacity=2, chunk_T=3)
    got, want, port = _both(jax_ref, cfg, evs, hook=_migrate_first_running)
    assert got == want and got["migrations"] == 1
    single, _ = _scenario(spidr, port, evs, dict(n_replicas=1, capacity=2,
                                                 chunk_T=3))
    # Bit-exact with a never-migrated run (and the whole-stream run).
    assert got["results"] == single["results"]
    for rid, (readout, *_rest) in got["results"].items():
        assert_same(np.asarray(readout), _whole(port, evs)[rid])


def test_migrate_every_rebalances_bit_exact(jax_ref):
    evs = _streams(4, t=9, seed=7)
    cfg = dict(n_replicas=2, capacity=3, chunk_T=3, migrate_every=1)

    def pile_onto_replica_0(fleet, handles):
        # Least-loaded placement spread the streams; move them all onto
        # replica 0, so the rebalance has 2+ slots of imbalance to undo.
        for h in list(handles.values()):
            if h.status == "running" and h.replica == 1 and \
                    fleet.workers[0].free_capacity() > 0:
                fleet.migrate(h.rid, to=0)

    got, want, port = _both(jax_ref, cfg, evs, hook=pile_onto_replica_0)
    # One migration by hand, the rest by the rebalance every tick.
    assert got == want and got["migrations"] >= 2
    for rid, (readout, *_rest) in got["results"].items():
        assert_same(np.asarray(readout), _whole(port, evs)[rid])


def test_migration_errors(jax_ref):
    port, _ = _pair(jax_ref)
    fleet = spidr.serve(port, ServeConfig(n_replicas=2, capacity=2, chunk_T=3))
    with pytest.raises(ValueError, match="no stream"):
        fleet.migrate()
    with pytest.raises(ValueError, match="not running"):
        fleet.migrate(99)
    fleet.shutdown()
    fleet = spidr.serve(port, ServeConfig(n_replicas=2, capacity=2, batch=True))
    with pytest.raises(RuntimeError, match="batch"):
        fleet.migrate()
    fleet.shutdown()


# ---------------------------------------------------------------------------
# Replica crash -> deterministic re-placement.
# ---------------------------------------------------------------------------
def test_killed_replicas_streams_replay_bit_exact(jax_ref):
    evs = _streams(6)
    cfg = dict(n_replicas=2, capacity=2, chunk_T=3)
    requeued = {}

    def kill_0(fleet, handles):
        hs = fleet.kill_replica(0)
        assert hs and all(h.status == "queued" for h in hs)
        assert fleet.kill_replica(0) == []          # idempotent
        requeued.setdefault(type(fleet).__module__, [h.rid for h in hs])

    got, want, port = _both(jax_ref, cfg, evs, hook=kill_0)
    assert got == want and got["crashes"] == 1
    assert requeued["repro_torch.serving.fleet"] == requeued["repro.serving.fleet"]
    whole = _whole(port, evs)
    for rid, placements in got["placements"].items():
        assert placements[-1][0] == 1    # nothing lands on the dead replica
        assert_same(np.asarray(got["results"][rid][0]), whole[rid])


def test_all_replicas_dead_fails_loudly(jax_ref):
    port, _ = _pair(jax_ref)
    fleet = spidr.serve(port, ServeConfig(n_replicas=1, capacity=2, chunk_T=3))
    fleet.submit(_streams(1)[0], rid=0)
    fleet.kill_replica(0)
    assert fleet.kill_replica(0) == []
    with pytest.raises(RuntimeError, match="dead"):
        fleet.drain()
    fleet.shutdown()


# ---------------------------------------------------------------------------
# Progress streaming, lifecycle, threaded mode.
# ---------------------------------------------------------------------------
def test_stream_progress_matches_the_reference(jax_ref):
    port, ref = _pair(jax_ref)
    ev = _streams(1)[0]
    ups = {}
    for name, mod, c in (("port", spidr, port), ("ref", jax_ref.spidr, ref)):
        fleet = mod.serve(c, mod.ServeConfig(capacity=2, chunk_T=3))
        h = fleet.submit(ev, rid=0)
        ups[name] = [(u.rid, u.status, u.timesteps, np.asarray(u.readout).tolist(),
                      u.cycles, u.energy_uj, u.replica) for u in fleet.stream(h)]
        fleet.shutdown()
    assert ups["port"] == ups["ref"]
    assert [u[2] for u in ups["port"]] == [3, 6] and ups["port"][-1][1] == "done"
    assert_same(np.asarray(ups["port"][-1][3]), _whole(port, [ev])[0])


def test_lifecycle_edges(jax_ref):
    port, _ = _pair(jax_ref)
    with spidr.serve(port, ServeConfig(capacity=2, chunk_T=3)) as fleet:
        fleet.submit(_streams(1)[0], rid=7)
        with pytest.raises(ValueError, match="already submitted"):
            fleet.submit(_streams(1)[0], rid=7)
        fleet.drain()
        assert "replica 0: live" in fleet.describe()
    assert fleet.closed
    fleet.shutdown()   # idempotent


def test_threaded_fleet_drains_bit_exact(jax_ref):
    port, _ = _pair(jax_ref)
    evs = _streams(6)
    fleet = spidr.serve(port, ServeConfig(n_replicas=2, capacity=2, chunk_T=3,
                                          mode="threaded"))
    hs = [fleet.submit(e, rid=i) for i, e in enumerate(evs)]
    fleet.drain(timeout=120)
    whole = _whole(port, evs)
    for h in hs:
        assert h.done
        assert_same(h.readout, whole[h.rid])
    with pytest.raises(RuntimeError, match="threaded"):
        fleet.step()
    with pytest.raises(RuntimeError, match="sync"):
        fleet.migrate()
    fleet.shutdown()
    assert not any(t.is_alive() for t in fleet._threads)
    # On the CPU there is no CUDA stream to give a replica.
    assert fleet.replica_streams == {}


def test_launch_counter_loses_no_count_under_threads(monkeypatch):
    """Replica threads count their launches at once: with a short switch
    interval and more threads than cores, no increment may be lost."""
    from repro_torch.kernels import _build

    class Yielding(dict):
        """Gives the interpreter lock away between the read and the write
        of ``+= 1``, where another thread's launch would interleave."""

        def __getitem__(self, key):
            time.sleep(0)
            return super().__getitem__(key)

    monkeypatch.setattr(_build, "LAUNCHES", Yielding.fromkeys(_build.LAUNCHES, 0))
    n_threads, per_thread = 4 * (os.cpu_count() or 1), 200
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch("fused_lif_gemm_int") for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert _build.LAUNCHES["fused_lif_gemm_int"] == n_threads * per_thread


# ---------------------------------------------------------------------------
# Telemetry: the spidr_fleet_* counters equal the reference's.
# ---------------------------------------------------------------------------
def _counters(d: dict) -> dict:
    out = {}
    for name, entries in d.items():
        if not (name.startswith("spidr_fleet_") or name.startswith("spidr_serve_")):
            continue
        for e in entries:
            key = (name, tuple(sorted(e["labels"].items())))
            out[key] = e["count"] if "count" in e else e["value"]
    return out


def test_fleet_counters_equal_the_references(jax_ref):
    evs = _streams(5)
    cfg = dict(n_replicas=2, capacity=3, chunk_T=3, max_queue=4)

    def hook(fleet, handles):
        _migrate_first_running(fleet, handles)
        fleet.kill_replica(1)

    port, ref = _pair(jax_ref)
    dumps = {}
    for name, o, mod, c in (("port", obs.metrics, spidr, port),
                            ("ref", jax_ref.obs_metrics, jax_ref.spidr, ref)):
        prev = o.default_registry()
        o.set_default_registry(o.MetricsRegistry(enabled=True))
        try:
            _scenario(mod, c, evs, cfg, hook)
            dumps[name] = o.default_registry().to_dict()
        finally:
            o.set_default_registry(prev)
    got, want = _counters(dumps["port"]), _counters(dumps["ref"])
    assert got == want
    names = {k[0] for k in got}
    for name in ("spidr_fleet_submitted_total", "spidr_fleet_placed_total",
                 "spidr_fleet_shed_total", "spidr_fleet_completed_total",
                 "spidr_fleet_migrations_total", "spidr_fleet_replica_crashes_total",
                 "spidr_fleet_replaced_streams_total", "spidr_fleet_tick_seconds",
                 "spidr_fleet_stream_latency_seconds", "spidr_serve_admissions_total"):
        assert name in names, name


def test_fleet_migrate_span(jax_ref):
    port, _ = _pair(jax_ref)
    prev = obs.default_tracer()
    obs.set_default_tracer(obs.Tracer(enabled=True))
    try:
        _scenario(spidr, port, _streams(3), dict(n_replicas=2, capacity=2, chunk_T=3),
                  _migrate_first_running)
        spans = [e for e in obs.default_tracer().events if e.get("ph") == "X"]
    finally:
        obs.set_default_tracer(prev)
    mig = [e for e in spans if e["name"] == "fleet.migrate"]
    assert len(mig) == 1 and mig[0]["cat"] == "fleet"
    assert {"rid", "src", "dst"} <= set(mig[0]["args"])


# ---------------------------------------------------------------------------
# The CLI's --replicas and the deprecated names.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("streaming", [False, True])
def test_cli_replicas_serve_on_cpu(streaming):
    # Full width (the CLI's only size): two streams, one slot per replica.
    argv = ["--snn", "gesture", "--device", "cpu", "--requests", "2",
            "--capacity", "1"] + (["--streaming", "--chunk-T", "10"] if streaming else [])
    one = launch_serve.serve_snn(launch_serve.parse_args(argv))
    two = launch_serve.serve_snn(launch_serve.parse_args(argv + ["--replicas", "2"]))
    assert one.n_replicas == 1 and two.n_replicas == 2 and two.closed
    assert all(len(w.done) > 0 for w in two.workers)
    by_rid = {r.rid: r for r in one.done}
    assert sorted(by_rid) == sorted(r.rid for r in two.done) == list(range(2))
    for r in two.done:
        assert_same(r.readout, by_rid[r.rid].readout)
        if streaming:
            assert (r.cycles, r.energy_uj) == (by_rid[r.rid].cycles,
                                               by_rid[r.rid].energy_uj)


def test_deprecated_server_names_warn_but_serve(jax_ref):
    port, _ = _pair(jax_ref)
    ev = _streams(1)[0]
    assert launch_serve.SNNRequest is StreamRequest
    with pytest.warns(DeprecationWarning, match="StreamingSNNServer"):
        srv = launch_serve.StreamingSNNServer(port, capacity=2, chunk_T=3)
    assert isinstance(srv, StreamWorker)
    srv.submit(StreamRequest(rid=0, events=ev))
    while srv.step():
        pass
    assert_same(srv.done[0].readout, _whole(port, [ev])[0])
    with pytest.warns(DeprecationWarning, match="SNNServer"):
        batch = launch_serve.SNNServer(port, capacity=2)
    batch.submit(StreamRequest(rid=0, events=ev))
    while batch.step():
        pass
    assert len(batch.done) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        fleet = spidr.serve(port, ServeConfig(capacity=2, chunk_T=3))
        fleet.submit(ev, rid=0)
        fleet.drain()
        fleet.shutdown()


# ---------------------------------------------------------------------------
# compile_engine(device_parallel=True): one device per core.
# ---------------------------------------------------------------------------
_SHARD_MAP = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import spidr_optflow
from repro.core.quant import QuantSpec
from repro.engine import EngineConfig, build_engine, compile_engine, run_engine
from repro.compiler import compile_network
assert len(jax.devices()) == 4
data = np.load(sys.argv[1])
spec = spidr_optflow.reduced(hw=(16, 16), timesteps=3)
params = [jnp.asarray(data[f"p{i}"]) if f"p{i}" in data.files else None
          for i in range(len(spec.layers))]
eng = build_engine(spec, params, EngineConfig(QuantSpec(8), backend="jnp"))
meng = compile_engine(eng, compile_network(spec, n_cores=4, qspec=QuantSpec(8)))
assert meng.device_parallel
out = run_engine(meng, jnp.asarray(data["events"]))
np.savez(sys.argv[2], readout=np.asarray(out.readout),
         spike_counts=np.asarray(out.spike_counts),
         input_counts=np.asarray(out.input_counts))
"""


def test_device_parallel_bit_exact_with_one_core_and_the_references_shard_map(
        jax_ref, monkeypatch, tmp_path):
    spec = spidr_optflow.reduced(hw=(16, 16), timesteps=3)
    spec_j = jax_ref.spidr_optflow.reduced(hw=(16, 16), timesteps=3)
    params = [None if p is None else np.asarray(p) for p in
              jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(5), spec_j)]
    rng = np.random.default_rng(3)
    events = (rng.random((3, 2, 16, 16, 2)) < 0.25).astype(np.float32)
    np.savez(tmp_path / "in.npz", events=events,
             **{f"p{i}": p for i, p in enumerate(params) if p is not None})
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"))
    proc = subprocess.Popen([sys.executable, "-c", _SHARD_MAP, str(tmp_path / "in.npz"),
                             str(tmp_path / "out.npz")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    monkeypatch.setattr(E, "_core_devices", lambda: [torch.device("cpu")] * 4)
    tp = params_from_jax(params, "cpu")
    got = {}
    for backend in ("fused", "torch"):
        for t_block in (1, 2):
            target = spidr.DeployTarget(weight_bits=8, n_cores=4, backend=backend,
                                        t_block=t_block)
            plan = spidr.compile(spec, tp, target, device="cpu")  # None: auto
            assert plan.engine.device_parallel
            split = [el for el in plan.engine.layers if len(el.core_devs) > 1]
            assert split, "the 8-bit flow plan splits layers across cores"
            one = spidr.compile(spec, tp, dataclasses.replace(target, n_cores=1),
                                device="cpu")
            a, b = plan.run(events), one.run(events)
            for f in ("readout", "spike_counts", "input_counts"):
                assert_same(getattr(a, f), getattr(b, f))
            got[(backend, t_block)] = a
    # Fewer devices than cores still raises, as the reference asserts.
    monkeypatch.setattr(E, "_core_devices", lambda: [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="device_parallel needs 4 devices, host has 2"):
        spidr.compile(spec, tp, spidr.DeployTarget(n_cores=4, device_parallel=True),
                      device="cpu")
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    with np.load(tmp_path / "out.npz") as want:
        for out in got.values():
            for f in ("readout", "spike_counts", "input_counts"):
                assert_same(getattr(out, f), want[f])


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
def _full_gesture(dev, n=6):
    from repro_torch.core.network import init_params
    from repro_torch.snn.data import make_gesture_batch

    spec = spidr_gesture.CONFIG
    params = init_params(torch.Generator().manual_seed(0), spec)
    ev, _ = make_gesture_batch(torch.Generator().manual_seed(1), batch=n,
                               timesteps=spec.timesteps, hw=spec.input_hw, device="cpu")
    return spec, params, ev.numpy()


@pytest.mark.gpu
def test_threaded_fleet_ticks_each_replica_on_its_own_stream(cuda_device):
    spec, params, ev = _full_gesture(cuda_device)
    compiled = spidr.compile(spec, params, spidr.DeployTarget(chunk_T=4, t_block=4),
                             device=cuda_device)
    want = compiled.run(torch.from_numpy(ev)).readout.cpu().numpy()
    fleet = spidr.serve(compiled, n_replicas=2, capacity=2, chunk_T=4, mode="threaded")
    hs = [fleet.submit(ev[:, i], rid=i) for i in range(ev.shape[1])]
    fleet.drain(timeout=300)
    fleet.shutdown()
    for h in hs:
        assert_same(h.readout, want[h.rid])
    default = torch.cuda.default_stream(cuda_device).cuda_stream
    s0, s1 = fleet.tick_streams[0], fleet.tick_streams[1]
    assert s0 == {fleet.replica_streams[0].cuda_stream}
    assert s1 == {fleet.replica_streams[1].cuda_stream}
    assert default not in s0 | s1 and not s0 & s1


@pytest.mark.gpu
def test_kernels_launch_on_a_second_card_after_the_first(cuda_device):
    """The shared-memory opt-in is kept per device: B1, B2 and B4 above 48 KB
    launch on cuda:1 after cuda:0, bit-exact with their plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_lif_gemm import (fused_lif_gemm_int,
                                                    fused_lif_gemm_int_tblk)
    from repro_torch.kernels.ops import spike_gemm_op

    g = torch.Generator().manual_seed(0)
    m, k, n, t = 4096, 1024, 32, 3   # a 32 KB weight slab: the ring above 48 KB
    s = (torch.rand((t, m, k), generator=g) < 0.1).to(torch.int8)
    w = torch.randint(-8, 8, (k, n), generator=g, dtype=torch.int8)
    v = torch.randint(-60, 60, (m, n), generator=g, dtype=torch.int32)
    want1 = ref.fused_lif_gemm_int_ref(s[0], w, v, 40, 2, False, 7)
    want2 = ref.fused_lif_gemm_int_tblk_ref(s, w, v, 40, 2, False, 7)
    want4 = ref.spike_gemm_ref(s[0], w)
    for i in (0, 1):
        dev = torch.device("cuda", i)
        sd, wd, vd = s.to(dev), w.to(dev), v.to(dev)
        for got, want in ((fused_lif_gemm_int(sd[0], wd, vd, 40, 2, False, 7), want1),
                          (fused_lif_gemm_int_tblk(sd, wd, vd, 40, 2, False, 7), want2)):
            assert_same(got[0], want[0])
            assert_same(got[1], want[1])
        assert_same(spike_gemm_op(sd[0], wd), want4)


@pytest.mark.gpu
@pytest.mark.parametrize("t_block", [1, 5])
def test_device_parallel_cores_run_the_kernels_on_their_devices(cuda_device, monkeypatch,
                                                                t_block):
    """Full-width flow, 8-bit, 4 cores, each core's channel slice on
    ``cuda:c % device_count`` (distinct cards when the host has four, else
    shared ones): bit-exact with one core and ``backend="torch"``, with the
    B1/B2 launches of every active core slice."""
    from repro_torch import kernels
    from repro_torch.core.network import init_params
    from repro_torch.snn.data import make_flow_batch

    n_dev = torch.cuda.device_count()
    monkeypatch.setattr(E, "_core_devices",
                        lambda: [torch.device("cuda", c % n_dev) for c in range(4)])
    spec = spidr_optflow.CONFIG
    params = init_params(torch.Generator().manual_seed(0), spec)
    events, _ = make_flow_batch(torch.Generator().manual_seed(1), batch=2,
                                timesteps=spec.timesteps, hw=spec.input_hw,
                                device=cuda_device)
    plan = spidr.compile(spec, params, spidr.DeployTarget(
        weight_bits=8, n_cores=4, t_block=t_block, device_parallel=True), device=cuda_device)
    slices = sum(len(el.core_devs) for el in plan.engine.layers)
    assert plan.engine.device_parallel and slices > 8   # 8-bit flow splits layers
    kernels.reset_launches()
    got = plan.run(events)
    launches = dict(kernels.LAUNCHES)
    want = spidr.compile(spec, params, spidr.DeployTarget(weight_bits=8, backend="torch"),
                         device=cuda_device).run(events)
    for f in ("readout", "spike_counts", "input_counts"):
        assert_same(getattr(got, f), getattr(want, f))
    steps = spec.timesteps if t_block == 1 else -(-spec.timesteps // t_block)
    kernel = "fused_lif_gemm_int" if t_block == 1 else "fused_lif_gemm_int_tblk"
    assert launches[kernel] == slices * steps
