"""Port parity, durable streams: session state_dict/load_state_dict,
export_slot/import_slot, CompiledSNN.snapshot -> spidr.restore (across the
two packages, both ways), the StreamWorker's rewind-and-replay and the
upgrade drill, and runtime.fault_tolerance case for case, against
repro.engine.streaming / repro.spidr / repro.runtime.

Tolerance 0 everywhere: a restored or migrated stream must continue with
byte-identical spikes, readouts, cycles and energy, and the checkpoint
leaves of the same session state are byte-identical between the packages.
Sizes are reduced (16x16, T=6, capacity <= 3).
"""
import functools
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, cuda_device, jax_ref  # noqa: F401
from repro_torch import spidr
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import spidr_gesture, spidr_optflow
from repro_torch.convert import params_from_jax
from repro_torch.core.network import init_params
from repro_torch.engine.streaming import SESSION_SCHEMA_VERSION
from repro_torch.runtime.fault_tolerance import (RestartableFailure, StepWatchdog,
                                                 StragglerDetector, retrying)
from repro_torch.serving import StreamRequest, StreamWorker
from repro_torch.snn.export import export_network

ROOT = pathlib.Path(__file__).resolve().parents[1]
HW, T = (16, 16), 6


def _spec(task: str):
    mod = spidr_gesture if task == "gesture" else spidr_optflow
    return mod.reduced(hw=HW, timesteps=T)


@functools.lru_cache(maxsize=None)
def _params(task: str, seed: int = 0):
    return init_params(torch.Generator().manual_seed(seed), _spec(task))


def _compiled(task="gesture", backend="torch", n_cores=1, seed=0, chunk_T=2,
              capacity=3):
    target = spidr.DeployTarget(weight_bits=4, backend=backend, n_cores=n_cores,
                                chunk_T=chunk_T, stream_capacity=capacity)
    return spidr.compile(_spec(task), _params(task, seed), target, device="cpu")


def _chunk(rng, t):
    return (rng.random((t,) + HW + (2,)) < 0.1).astype(np.float32)


def _update_key(up):
    return (up.timesteps, np.asarray(up.readout).tolist(), up.chunk_spikes,
            up.spikes, up.cycles, up.energy_uj,
            None if up.per_core_cycles is None
            else np.asarray(up.per_core_cycles).tolist(), up.load_imbalance)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# The serialized-session schema, pinned to the reference's.
# ---------------------------------------------------------------------------
def _ref_pair(jax_ref, task="gesture", n_cores=1, capacity=2, chunk_T=2):
    """The same integers deployed by both packages (the port's params come
    from the reference's, so per-tensor scales agree)."""
    spec_j = (jax_ref.spidr_gesture if task == "gesture"
              else jax_ref.spidr_optflow).reduced(hw=HW, timesteps=T)
    params = [None if p is None else np.asarray(p) for p in
              jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(0), spec_j)]
    port = spidr.compile(_spec(task), params_from_jax(params, "cpu"),
                         spidr.DeployTarget(weight_bits=4, backend="torch",
                                            n_cores=n_cores, chunk_T=chunk_T,
                                            stream_capacity=capacity),
                         device="cpu")
    ref = jax_ref.spidr.compile(
        spec_j, [None if p is None else jax_ref.jnp.asarray(p) for p in params],
        jax_ref.spidr.DeployTarget(weight_bits=4, backend="jnp", n_cores=n_cores,
                                   chunk_T=chunk_T, stream_capacity=capacity),
        check="off")
    return port, ref


@pytest.mark.parametrize("n_cores", [1, 4])
def test_state_dict_equals_the_references(jax_ref, n_cores):
    """Same keys, dtypes, shapes and values after the same ticks."""
    assert SESSION_SCHEMA_VERSION == jax_ref.streaming.SESSION_SCHEMA_VERSION == 1
    port, ref = _ref_pair(jax_ref, n_cores=n_cores)
    sess, sess_j = port.open_stream(), ref.open_stream()
    rng = np.random.default_rng(0)
    for s in (sess, sess_j):
        s.open()
    for _ in range(2):
        c = _chunk(rng, 2)
        sess.step({0: c})
        sess_j.step({0: c})
    d, d_j = sess.state_dict(), sess_j.state_dict()
    assert sorted(d) == sorted(d_j) == ["clocks", "engine_state", "schema", "table"]
    assert sorted(d["engine_state"]) == sorted(d_j["engine_state"])
    assert sorted(d["table"]) == sorted(d_j["table"])
    assert sorted(d["clocks"][0][0]) == sorted(d_j["clocks"][0][0])
    assert len(d["clocks"]) == 2 and all(len(c) == n_cores for c in d["clocks"])
    a, b = _leaves(d), _leaves(d_j)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None:
            assert y is None
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert (x.dtype, x.shape) == (y.dtype, y.shape)
        assert x.tobytes() == y.tobytes()


def test_snapshot_leaves_are_byte_identical_to_the_references(jax_ref, tmp_path):
    port, ref = _ref_pair(jax_ref, n_cores=4)
    rng = np.random.default_rng(1)
    sess, sess_j = port.open_stream(), ref.open_stream()
    for s in (sess, sess_j):
        s.open()
        s.open()
    for _ in range(2):
        chunks = {0: _chunk(rng, 2), 1: _chunk(rng, 2)}
        sess.step(chunks)
        sess_j.step(chunks)
    port.snapshot(tmp_path / "port", step=3, sessions=[sess])
    ref.snapshot(str(tmp_path / "ref"), step=3, sessions=[sess_j])
    mine, theirs = tmp_path / "port" / "step_000000003", tmp_path / "ref" / "step_000000003"
    names = sorted(p.name for p in theirs.glob("*.npy"))
    assert names == sorted(p.name for p in mine.glob("*.npy")) and names
    for name in names:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name
    meta, meta_j = (json.loads((d / "meta.json").read_text()) for d in (mine, theirs))
    assert meta["manifest"] == meta_j["manifest"]
    info, info_j = meta["spidr_session_snapshot"], meta_j["spidr_session_snapshot"]
    assert info == info_j   # the target in the reference's vocabulary


def test_state_dict_never_aliases_live_state():
    sess = _compiled(backend="fused").open_stream(2, 2)
    s0 = sess.open()
    sess.step({s0: _chunk(np.random.default_rng(0), 2)})
    frozen = sess.state_dict()
    for leaf in _leaves(frozen):
        if isinstance(leaf, np.ndarray) and leaf.ndim:
            leaf.fill(-1)
    clean = sess.state_dict()
    assert int(clean["table"]["timesteps"][s0]) == 2
    assert (clean["engine_state"]["readout_acc"] >= 0).all()
    assert not np.array_equal(clean["table"]["timesteps"], frozen["table"]["timesteps"])


@pytest.mark.parametrize("t_block", [1, 2])
def test_state_dict_is_immutable_evidence_of_its_tick(t_block):
    """On the CPU ``.numpy()`` would alias the live tensors; neither a later
    tick nor a close may change an earlier snapshot, nor a loaded one."""
    compiled = spidr.compile(_spec("gesture"), _params("gesture"), spidr.DeployTarget(
        backend="fused", t_block=t_block), device="cpu")
    sess = compiled.open_stream(2, 2)
    s0 = sess.open()
    rng = np.random.default_rng(1)
    up = sess.step({s0: _chunk(rng, 2)})[s0]
    readout = up.readout.copy()
    at_tick_1 = sess.state_dict()
    bytes_1 = [np.asarray(x).tobytes() for x in _leaves(at_tick_1) if x is not None]
    sess.step({s0: _chunk(rng, 2)})
    sess.close(s0)
    assert_same(up.readout, readout)
    twin = compiled.open_stream(2, 2)
    twin.load_state_dict(at_tick_1)
    twin.close(s0)                  # zeroes the loaded slot in place
    twin.open()
    twin.step({s0: _chunk(rng, 2)})
    twin.import_slot(sess.export_slot(sess.open()), slot=1)
    twin.close(1)
    assert [np.asarray(x).tobytes() for x in _leaves(at_tick_1)
            if x is not None] == bytes_1


def test_roundtrip_through_a_fresh_session_is_bit_exact():
    compiled = _compiled(backend="fused")
    sess = compiled.open_stream(3, 2)
    s0, s1 = sess.open(), sess.open()
    rng = np.random.default_rng(2)
    for _ in range(2):
        sess.step({s0: _chunk(rng, 2), s1: _chunk(rng, 2)})
    snap = sess.state_dict()
    later = [{s0: _chunk(rng, 2), s1: _chunk(rng, 2)}]
    ref = [sess.step(c) for c in later]
    twin = compiled.open_stream(3, 2)
    twin.load_state_dict(snap)
    assert twin.active == (True, True, False)
    got = [twin.step(c) for c in later]
    for r, g in zip(ref, got):
        for slot in r:
            assert _update_key(r[slot]) == _update_key(g[slot])


def test_slot_update_spikes_is_cumulative():
    sess = _compiled().open_stream(2, 2)
    s0 = sess.open()
    rng = np.random.default_rng(3)
    total = 0
    for _ in range(3):
        up = sess.step({s0: _chunk(rng, 2)})[s0]
        total += up.chunk_spikes
        assert up.spikes == total


@pytest.mark.parametrize("what", ["schema", "capacity", "clock layout", "Vmem shapes"])
def test_mismatched_state_dict_is_refused(what):
    compiled = _compiled()
    snap = compiled.open_stream(2, 2).state_dict()
    target = compiled.open_stream(2, 2)
    if what == "schema":
        snap["schema"] = np.int64(SESSION_SCHEMA_VERSION + 1)
    elif what == "capacity":
        target = compiled.open_stream(3, 2)
    elif what == "clock layout":
        snap["clocks"] = [c + c for c in snap["clocks"]]   # pretend 2 cores
    else:
        target = _compiled("optical-flow").open_stream(2, 2)
    before = target.state_dict()
    with pytest.raises(ValueError, match=what):
        target.load_state_dict(snap)
    after = target.state_dict()
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(before), _leaves(after))
               if a is not None)


# ---------------------------------------------------------------------------
# Live migration of one stream.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_cores", [1, 4])
def test_export_import_migration_continues_bit_exactly(n_cores):
    compiled = _compiled(backend="fused", n_cores=n_cores)
    a, b = compiled.open_stream(2, 2), compiled.open_stream(3, 2)
    s0, s1 = a.open(), a.open()
    busy = b.open()
    rng = np.random.default_rng(4)
    a.step({s0: _chunk(rng, 2), s1: _chunk(rng, 2)})
    b.step({busy: _chunk(rng, 2)})
    payload = a.export_slot(s1)
    dest = b.import_slot(payload)
    assert dest == 1 and b.active == (True, True, False)
    for _ in range(2):
        c = _chunk(rng, 2)
        ra = a.step({s0: _chunk(rng, 2), s1: c})
        rb = b.step({busy: _chunk(rng, 2), dest: c})
        assert _update_key(ra[s1]) == _update_key(rb[dest])


def test_migration_refusals():
    compiled = _compiled()
    a = compiled.open_stream(2, 2)
    s0 = a.open()
    with pytest.raises(ValueError, match="not active"):
        a.export_slot(1)
    payload = a.export_slot(s0)
    full = compiled.open_stream(1, 2)
    full.open()
    with pytest.raises(ValueError, match="no free slot"):
        full.import_slot(payload)
    with pytest.raises(ValueError, match="already holds"):
        a.import_slot(payload, slot=s0)
    with pytest.raises(ValueError, match="core"):
        _compiled(n_cores=4).open_stream(2, 2).import_slot(payload)
    with pytest.raises(ValueError, match="Vmem shapes"):
        _compiled("optical-flow").open_stream(2, 2).import_slot(payload)
    newer = dict(payload, schema=np.int64(SESSION_SCHEMA_VERSION + 1))
    with pytest.raises(ValueError, match="schema"):
        compiled.open_stream(2, 2).import_slot(newer)


# ---------------------------------------------------------------------------
# Snapshot -> restore, within the port and across the two packages.
# ---------------------------------------------------------------------------
MATRIX = [("gesture", "torch", 1), ("gesture", "fused", 1), ("gesture", "torch", 4),
          ("optical-flow", "torch", 1), ("optical-flow", "fused", 4)]


@pytest.mark.parametrize("task,backend,n_cores", MATRIX)
def test_migrated_stream_is_bit_identical(tmp_path, task, backend, n_cores):
    compiled = _compiled(task, backend, n_cores)
    sess = compiled.open_stream(3, 2)
    s0, s1 = sess.open(), sess.open()
    rng = np.random.default_rng(7)
    for _ in range(2):
        sess.step({s0: _chunk(rng, 2), s1: _chunk(rng, 2)})
    compiled.snapshot(tmp_path, step=2, sessions=[sess], extra={"tick": 2})
    later = [{s0: _chunk(rng, 2), s1: _chunk(rng, 2)},
             {s0: _chunk(rng, 2), s1: _chunk(rng, 1)}]
    ref = [sess.step(c) for c in later]
    restored = spidr.restore(tmp_path, device="cpu")
    assert restored is not compiled and restored.target == compiled.target
    twin = restored.sessions[0]
    assert twin.active == (True, True, False)
    got = [twin.step(c) for c in later]
    for r, g in zip(ref, got):
        assert sorted(r) == sorted(g)
        for slot in r:
            assert _update_key(r[slot]) == _update_key(g[slot])
    sess.close(s1)
    twin.close(s1)
    n0, n1 = sess.open(), twin.open()
    assert n0 == n1
    tick = {s0: _chunk(rng, 2), n0: _chunk(rng, 2)}
    r, g = sess.step(tick), twin.step(tick)
    for slot in r:
        assert _update_key(r[slot]) == _update_key(g[slot])


def test_restored_engine_is_byte_identical(tmp_path):
    """Per-tensor provenance: the snapshot's integers rebuild the engine,
    they are not quantized again."""
    for compiled in (_compiled(n_cores=4), spidr.compile(
            export_network(_params("gesture"), _spec("gesture"),
                           spidr.DeployTarget().qspec),
            _spec("gesture"), spidr.DeployTarget(), device="cpu")):
        compiled.snapshot(tmp_path / str(id(compiled)), sessions=[])
        restored = spidr.restore(tmp_path / str(id(compiled)), device="cpu")
        assert (restored.exported is None) == (compiled.exported is None)
        for a, b in zip(compiled._base_engine.layers, restored._base_engine.layers):
            assert a.kind == b.kind
            if a.kind in ("conv", "fc"):
                assert_same(a.w_q, b.w_q)
                assert np.asarray(a.w_scale).tobytes() == np.asarray(b.w_scale).tobytes()
                assert_same(torch.as_tensor(a.thr_int), torch.as_tensor(b.thr_int))
        assert restored.schedule is None or \
            restored.schedule.describe() == compiled.schedule.describe()


def test_snapshot_restore_of_an_exported_network(tmp_path):
    spec = _spec("gesture")
    exported = export_network(_params("gesture"), spec, spidr.DeployTarget().qspec)
    compiled = spidr.compile(exported, spec, spidr.DeployTarget(
        chunk_T=2, stream_capacity=2), device="cpu")
    sess = compiled.open_stream()
    s0 = sess.open()
    rng = np.random.default_rng(11)
    sess.step({s0: _chunk(rng, 2)})
    compiled.snapshot(tmp_path, sessions=[sess])
    restored = spidr.restore(tmp_path, device="cpu")
    assert restored.exported is not None
    later = {s0: _chunk(rng, 2)}
    assert _update_key(sess.step(later)[s0]) \
        == _update_key(restored.sessions[0].step(later)[s0])


def test_restore_onto_a_prepared_replica(tmp_path):
    compiled = _compiled()
    sess = compiled.open_stream(2, 2)
    s0 = sess.open()
    rng = np.random.default_rng(13)
    sess.step({s0: _chunk(rng, 2)})
    compiled.snapshot(tmp_path, sessions=[sess])
    replica = _compiled()
    before = len(replica.sessions)
    assert spidr.restore(tmp_path, compiled=replica) is replica
    assert len(replica.sessions) == before + 1
    later = {s0: _chunk(rng, 2)}
    assert _update_key(sess.step(later)[s0]) \
        == _update_key(replica.sessions[-1].step(later)[s0])


@pytest.mark.parametrize("what", ["DeployTarget", "identical"])
def test_replica_with_another_target_or_weights_is_refused(tmp_path, what):
    _compiled().snapshot(tmp_path, sessions=[])
    other = _compiled(backend="fused") if what == "DeployTarget" else _compiled(seed=1)
    with pytest.raises(ValueError, match=what):
        spidr.restore(tmp_path, compiled=other)


def test_non_snapshot_and_missing_snapshots_are_refused(tmp_path):
    Checkpointer(str(tmp_path / "ckpt")).save(0, {"w": np.zeros(3)})
    with pytest.raises(ValueError, match="not a spidr session snapshot"):
        spidr.restore(tmp_path / "ckpt", device="cpu")
    with pytest.raises(ValueError):
        spidr.read_snapshot_meta(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError):
        spidr.restore(tmp_path / "nothing", device="cpu")


def test_snapshot_meta_round_trips_bookkeeping(tmp_path):
    extra = {"cursors": {"0": 4}, "note": "pre-upgrade"}
    _compiled().snapshot(tmp_path, step=9, sessions=[], extra=extra)
    info = spidr.read_snapshot_meta(tmp_path)
    assert info["step"] == 9 and info["extra"] == extra
    assert info["spec"]["input_hw"] == list(HW)
    assert info["target"]["n_cores"] == 1
    assert info["target"]["backend"] == "jnp" and info["target"]["interpret"] is None


def test_target_from_either_vocabulary():
    from repro_torch.spidr.compiled import _target_from_info, _target_info

    for target in (spidr.DeployTarget(backend="torch", n_cores=4, t_block=3),
                   spidr.DeployTarget(backend="fused", weight_bits=8),
                   spidr.DeployTarget(backend="reference")):
        assert _target_from_info(json.loads(json.dumps(_target_info(target)))) == target
    ref_form = dict(_target_info(spidr.DeployTarget()), interpret=True, backend="jnp")
    assert _target_from_info(ref_form) == spidr.DeployTarget(backend="torch")
    with pytest.raises(ValueError, match="DeployTarget"):
        _target_from_info(dict(ref_form, clock_mhz=50))


@pytest.mark.parametrize("task,n_cores", [("gesture", 1), ("gesture", 4),
                                          ("optical-flow", 1)])
def test_reference_snapshot_resumes_in_the_port(jax_ref, tmp_path, task, n_cores):
    port, ref = _ref_pair(jax_ref, task, n_cores, capacity=2)
    sess_j = ref.open_stream()
    s0, s1 = sess_j.open(), sess_j.open()
    rng = np.random.default_rng(17)
    sess_j.step({s0: _chunk(rng, 2), s1: _chunk(rng, 2)})
    ref.snapshot(str(tmp_path), sessions=[sess_j])
    later = [{s0: _chunk(rng, 2), s1: _chunk(rng, 2)}, {s0: _chunk(rng, 1),
                                                         s1: _chunk(rng, 2)}]
    want = [sess_j.step(c) for c in later]
    restored = spidr.restore(tmp_path, device="cpu")
    assert restored.target == port.target       # "jnp" read as "torch"
    got = [restored.sessions[0].step(c) for c in later]
    for w, g in zip(want, got):
        for slot in w:
            assert _update_key(w[slot]) == _update_key(g[slot])


@pytest.mark.parametrize("task,n_cores", [("gesture", 1), ("gesture", 4),
                                          ("optical-flow", 1)])
def test_port_snapshot_resumes_in_the_reference(jax_ref, tmp_path, task, n_cores):
    port, ref = _ref_pair(jax_ref, task, n_cores, capacity=2)
    sess = port.open_stream()
    s0, s1 = sess.open(), sess.open()
    rng = np.random.default_rng(19)
    sess.step({s0: _chunk(rng, 2), s1: _chunk(rng, 2)})
    port.snapshot(tmp_path, sessions=[sess])
    later = [{s0: _chunk(rng, 2), s1: _chunk(rng, 2)}, {s0: _chunk(rng, 2),
                                                         s1: _chunk(rng, 1)}]
    want = [sess.step(c) for c in later]
    restored = jax_ref.spidr.restore(str(tmp_path))
    assert restored.target == ref.target
    got = [restored.sessions[0].step(c) for c in later]
    for w, g in zip(want, got):
        for slot in w:
            assert _update_key(w[slot]) == _update_key(g[slot])


def test_reference_worker_snapshot_resumes_in_the_port_worker(jax_ref, tmp_path):
    port, ref = _ref_pair(jax_ref, capacity=2)
    rng = np.random.default_rng(23)
    events = [_chunk(rng, t) for t in (6, 4, 5)]

    def reqs(request_cls):
        return {rid: request_cls(rid=rid, events=ev) for rid, ev in enumerate(events)}

    w_j = jax_ref.serving.StreamWorker(ref, 2, 2, snapshot_dir=str(tmp_path),
                                       snapshot_every=1)
    for _, r in sorted(reqs(jax_ref.serving.StreamRequest).items()):
        w_j.submit(r)
    for _ in range(3):
        w_j.step()
    while w_j.step():
        pass
    srv = StreamWorker.restore(tmp_path, reqs(StreamRequest), device="cpu", step=3)
    assert srv.ticks == 3
    while srv.step():
        pass
    got = {r.rid: (np.asarray(r.readout).tolist(), r.cycles, r.energy_uj)
           for r in srv.done}
    assert got == {r.rid: (np.asarray(r.readout).tolist(), r.cycles, r.energy_uj)
                   for r in w_j.done}


# ---------------------------------------------------------------------------
# Invariance: any snapshot tick, any chunking, any interleaving.
# ---------------------------------------------------------------------------
def _serve(compiled, lens, seed, chunk_T, snapshot_tick=None, tmp=None):
    def requests():
        rng = np.random.default_rng(seed)
        return {rid: StreamRequest(rid=rid, events=(
            rng.random((t,) + HW + (2,)) < 0.1).astype(np.float32))
            for rid, t in enumerate(lens)}

    server = StreamWorker(compiled, capacity=2, chunk_T=chunk_T,
                          snapshot_dir=tmp if snapshot_tick is not None else None,
                          snapshot_every=1 if snapshot_tick is not None else 0)
    for _, req in sorted(requests().items()):
        server.submit(req)
    while server.step():
        if snapshot_tick is not None and server.ticks >= snapshot_tick:
            server = StreamWorker.restore(tmp, requests(), compiled=compiled)
            snapshot_tick = None
    return {r.rid: (np.asarray(r.readout).tolist(), r.cycles, r.energy_uj, r.spikes)
            for r in server.done}


def test_every_snapshot_tick_restores_identically(tmp_path):
    lens = [6, 4, 5, 6]
    compiled = _compiled(chunk_T=2, capacity=2)
    ref = _serve(compiled, lens, seed=23, chunk_T=2)
    for k in range(1, 7):
        got = _serve(compiled, lens, seed=23, chunk_T=2, snapshot_tick=k,
                     tmp=str(tmp_path / f"t{k}"))
        assert got == ref, f"diverged when killed after tick {k}"


def test_chunking_invariance_survives_migration(tmp_path):
    lens = [6, 5, 4]
    results = {}
    for chunk_T in (1, 2, 3):
        results[chunk_T] = _serve(_compiled(chunk_T=chunk_T, capacity=2), lens,
                                  seed=29, chunk_T=chunk_T, snapshot_tick=2,
                                  tmp=str(tmp_path / f"c{chunk_T}"))
    for chunk_T in (2, 3):
        assert sorted(results[chunk_T]) == sorted(results[1])
        for rid, (readout, cycles, energy, spikes) in results[1].items():
            r2, c2, e2, s2 = results[chunk_T][rid]
            assert (r2, c2, s2) == (readout, cycles, spikes)
            # Energy is a float sum in chunk order: equal to rounding only
            # across different chunkings (exact within one, above).
            assert e2 == pytest.approx(energy, rel=1e-12)


def test_multicore_interleaving_restores_identically(tmp_path):
    lens = [6, 3, 5, 4]
    compiled = _compiled(backend="fused", n_cores=4, chunk_T=2, capacity=2)
    assert _serve(compiled, lens, seed=31, chunk_T=2, snapshot_tick=3,
                  tmp=str(tmp_path / "mc")) == _serve(compiled, lens, seed=31,
                                                      chunk_T=2)


# ---------------------------------------------------------------------------
# The durable worker: watchdog, rewind-and-replay, restart budget.
# ---------------------------------------------------------------------------
def _requests(seed=37, lens=(6, 4, 5, 6)):
    rng = np.random.default_rng(seed)
    return {rid: StreamRequest(rid=rid, events=(
        rng.random((t,) + HW + (2,)) < 0.1).astype(np.float32))
        for rid, t in enumerate(lens)}


def _run(server, reqs):
    for rid in sorted(reqs):
        server.submit(reqs[rid])
    while server.step():
        pass
    return {r.rid: (np.asarray(r.readout).tolist(), r.cycles, r.energy_uj, r.spikes)
            for r in server.done}


@pytest.mark.parametrize("t_block", [1, 2])
def test_poisoned_tick_rewinds_and_replays_bit_exactly(t_block):
    compiled = spidr.compile(_spec("gesture"), _params("gesture"), spidr.DeployTarget(
        backend="fused", t_block=t_block), device="cpu")
    ref = _run(StreamWorker(compiled, 2, 2), _requests())
    srv = StreamWorker(compiled, 2, 2, fail_at_tick=3)
    assert _run(srv, _requests()) == ref
    assert srv.restarts == 1


def test_hung_tick_trips_the_watchdog_then_recovers():
    compiled = _compiled(capacity=2)
    ref = _run(StreamWorker(compiled, 2, 2), _requests())
    # The deadline sits far above a normal tick of this CPU-sized net, even
    # on a host loaded by parallel test workers; the hung tick lasts until
    # the watchdog has fired, however late its timer thread runs.
    srv = StreamWorker(compiled, 2, 2, watchdog_s=2.0)
    real_step = srv.sessions.step
    hung = {"n": 0}

    def slow_once(chunks):
        out = real_step(chunks)
        if hung["n"] == 0:
            hung["n"] += 1
            t0 = time.monotonic()
            while not srv._watchdog.timed_out and time.monotonic() - t0 < 60:
                time.sleep(0.01)   # blow the deadline exactly once
        return out

    srv.sessions.step = slow_once
    got = _run(srv, _requests())
    srv.sessions.step = real_step
    assert srv.restarts == 1 and got == ref


def test_restart_budget_exhausts_into_failure():
    srv = StreamWorker(_compiled(capacity=2), 2, 2, max_restarts=2)

    def always_poisoned(tick):
        raise RestartableFailure("wedged hardware")

    srv.mid_tick_hook = always_poisoned
    for _, req in sorted(_requests().items()):
        srv.submit(req)
    with pytest.raises(RestartableFailure, match="wedged"):
        srv.step()
    assert srv.restarts == 3   # 1 try + max_restarts replays


def test_worker_metrics_count_rewinds_and_snapshots(tmp_path):
    from repro_torch import obs

    reg = obs.set_default_registry(obs.MetricsRegistry())
    try:
        srv = StreamWorker(_compiled(capacity=2), 2, 2, fail_at_tick=2,
                           watchdog_s=5.0, snapshot_dir=str(tmp_path),
                           snapshot_every=2)
        _run(srv, _requests())
        d = reg.to_dict()
        assert d["spidr_serve_rewinds_total"][0]["value"] == 1
        assert d["spidr_serve_admissions_total"][0]["value"] == 4
        assert d["spidr_serve_snapshot_seconds"][0]["count"] == srv.ticks // 2
        assert d["spidr_snapshot_seconds"][0]["count"] == srv.ticks // 2
        assert d["spidr_serve_tick_seconds"][0]["count"] == srv.ticks
    finally:
        obs.set_default_registry(obs.MetricsRegistry(enabled=False))


def test_upgrade_drill_sigkill_on_the_cpu(tmp_path):
    """The drill's kill matrix, one configuration: a child serving with a
    snapshot every tick SIGKILLs itself mid-tick; a second child restores
    and serves to the end; every stream byte-identical."""
    out = tmp_path / "drill.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "upgrade_drill_torch.py"), "--smoke",
         "--device", "cpu", "--task", "gesture", "--n-cores", "4", "--backend",
         "fused", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    report = json.loads(out.read_text())
    (cfg,) = report["configs"]
    assert report["ok"] and cfg["serve_returncode"] == -9
    assert 2 <= cfg["die_at_tick"] <= cfg["ticks"]
    assert cfg["resumed_at_tick"] == cfg["die_at_tick"] - 1
    assert cfg["streams"] == 4 and not cfg["lost_streams"]
    assert cfg["kill_trace"]["final_spans"][-1]["name"] == "run_chunk"


# ---------------------------------------------------------------------------
# runtime.fault_tolerance, case for case with tests/test_fault_tolerance.py.
# ---------------------------------------------------------------------------
class TestStepWatchdog:
    def test_fast_step_never_fires(self):
        wd = StepWatchdog(deadline_s=5.0)
        wd.arm()
        wd.disarm()
        wd.check()
        assert not wd.timed_out and wd.timeouts == 0

    def test_expired_deadline_fires_and_check_raises(self):
        wd = StepWatchdog(deadline_s=0.01)
        wd.arm()
        time.sleep(0.1)
        wd.disarm()
        assert wd.timed_out and wd.timeouts == 1
        with pytest.raises(RestartableFailure, match="deadline"):
            wd.check()

    def test_on_timeout_callback_fires(self):
        fired = []
        wd = StepWatchdog(deadline_s=0.01, on_timeout=lambda: fired.append(1))
        wd.arm()
        time.sleep(0.1)
        wd.disarm()
        assert fired == [1]

    def test_rearm_clears_timed_out(self):
        wd = StepWatchdog(deadline_s=0.01)
        wd.arm()
        time.sleep(0.1)
        assert wd.timed_out
        wd.arm()
        wd.disarm()
        wd.check()
        assert wd.timeouts == 1

    def test_disarm_without_arm_is_a_noop(self):
        StepWatchdog(deadline_s=1.0).disarm()


class TestStragglerDetector:
    def test_no_flags_before_min_steps(self):
        det = StragglerDetector(window=16, z_thresh=1.0, min_steps=8)
        for _ in range(7):
            assert not det.record(1.0)
        assert not det.record(1000.0)
        assert det.flagged == 0

    def test_outlier_is_flagged_after_warmup(self):
        det = StragglerDetector(window=32, z_thresh=3.0, min_steps=4)
        for _ in range(8):
            det.record(1.0)
        assert det.record(100.0)
        assert det.flagged == 1
        assert not det.record(1.0)

    def test_window_evicts_old_samples(self):
        det = StragglerDetector(window=4, z_thresh=3.0, min_steps=2)
        for _ in range(10):
            det.record(100.0)
        assert not det.record(100.0)
        assert len(det.times) == 4

    def test_stats_reflect_recorded_times(self):
        det = StragglerDetector(window=8, min_steps=2)
        for s in (1.0, 2.0, 3.0):
            det.record(s)
        st = det.stats()
        assert st.mean_s == pytest.approx(2.0)
        assert st.last_s == 3.0 and st.flagged == 0


class TestRetrying:
    def test_success_passes_through(self):
        step = retrying(lambda x: x + 1, lambda x: None)
        assert step(1) == 2 and step.state["restarts"] == 0

    def test_restartable_failure_restores_and_replays(self):
        calls = {"step": 0, "restore": 0}

        def step():
            calls["step"] += 1
            if calls["step"] < 3:
                raise RestartableFailure("poisoned")
            return "ok"

        def restore():
            calls["restore"] += 1

        wrapped = retrying(step, restore, max_restarts=5)
        assert wrapped() == "ok"
        assert calls == {"step": 3, "restore": 2}
        assert wrapped.state["restarts"] == 2

    def test_restart_budget_is_enforced(self):
        def always_fails():
            raise RestartableFailure("wedged")

        wrapped = retrying(always_fails, lambda: None, max_restarts=3)
        with pytest.raises(RestartableFailure, match="wedged"):
            wrapped()
        assert wrapped.state["restarts"] == 4

    def test_budget_spans_calls(self):
        flaky = {"n": 0}

        def step():
            flaky["n"] += 1
            if flaky["n"] % 2 == 1:
                raise RestartableFailure("every other call")
            return flaky["n"]

        wrapped = retrying(step, lambda: None, max_restarts=2)
        assert wrapped() == 2
        assert wrapped() == 4
        with pytest.raises(RestartableFailure):
            wrapped()

    def test_non_restartable_exceptions_propagate(self):
        def step():
            raise ValueError("not restartable")

        restores = []
        wrapped = retrying(step, lambda: restores.append(1))
        with pytest.raises(ValueError):
            wrapped()
        assert restores == []

    def test_restore_fn_may_replace_args(self):
        def step(state):
            if state["poisoned"]:
                raise RestartableFailure("bad state")
            return state["value"]

        wrapped = retrying(step, lambda state: ({"poisoned": False, "value": 42},),
                           max_restarts=1)
        assert wrapped({"poisoned": True, "value": 0}) == 42

    def test_restore_fn_returning_none_keeps_args(self):
        seen = []

        def step(state):
            seen.append(state)
            if len(seen) == 1:
                raise RestartableFailure("once")
            return "done"

        wrapped = retrying(step, lambda state: state.clear(), max_restarts=1)
        marker = {"k": 1}
        assert wrapped(marker) == "done"
        assert seen[0] is marker and seen[1] is marker

    def test_on_restart_hook_and_watchdog_counter(self, jax_ref):
        hits = []
        wrapped = retrying(lambda: (_ for _ in ()).throw(RestartableFailure("x")),
                           lambda: None, max_restarts=1,
                           on_restart=lambda: hits.append(1))
        with pytest.raises(RestartableFailure):
            wrapped()
        assert hits == [1]
        from repro_torch import obs

        reg = obs.MetricsRegistry()
        wd = StepWatchdog(0.01, counter=reg.counter("timeouts_total"))
        wd.arm()
        time.sleep(0.1)
        wd.disarm()
        assert reg.to_dict()["timeouts_total"][0]["value"] == 1
        from repro_torch.runtime import fault_tolerance

        assert set(jax_ref.fault_tolerance.__all__) < set(fault_tolerance.__all__)


# ---------------------------------------------------------------------------
# On the card: full-width streams against backend="torch".
# ---------------------------------------------------------------------------
def _full_width_worker(dev, net, backend, t_block, chunk_T, capacity, events,
                       **kw):
    mod = spidr_gesture if net == "gesture" else spidr_optflow
    params = init_params(torch.Generator().manual_seed(0), mod.CONFIG)
    compiled = spidr.compile(mod.CONFIG, params, spidr.DeployTarget(
        backend=backend, t_block=t_block), device=dev)
    worker = StreamWorker(compiled, capacity=capacity, chunk_T=chunk_T, **kw)
    for rid in range(events.shape[1]):
        worker.submit(StreamRequest(rid=rid, events=events[:, rid]))
    return worker


@pytest.mark.gpu
@pytest.mark.parametrize("t_block,chunk_T", [(1, 2), (4, 4), (2, 5)])
def test_full_width_gesture_streams_on_card_equal_torch(cuda_device, t_block, chunk_T):
    from repro_torch.snn.data import make_gesture_chunk

    events = make_gesture_chunk(7, 0, batch=6, chunk_T=20, device="cpu")[0].numpy()
    out = {}
    for backend in ("fused", "torch"):
        worker = _full_width_worker(cuda_device, "gesture", backend, t_block,
                                    chunk_T, 4, events, fail_at_tick=3)
        while worker.step():
            pass
        assert worker.restarts == 1
        out[backend] = {r.rid: (r.readout.tobytes(), r.spikes, r.cycles, r.energy_uj)
                        for r in worker.done}
    assert out["fused"] == out["torch"] and len(out["fused"]) == 6


@pytest.mark.gpu
@pytest.mark.parametrize("t_block", [1, 5])
def test_full_width_flow_snapshot_restores_on_card(cuda_device, tmp_path, t_block):
    from repro_torch.snn.data import make_flow_chunk

    events = make_flow_chunk(7, 0, batch=3, chunk_T=10, device="cpu")[0].numpy()
    ref = _full_width_worker(cuda_device, "optical-flow", "torch", t_block, 5, 2,
                             events)
    while ref.step():
        pass
    worker = _full_width_worker(cuda_device, "optical-flow", "fused", t_block, 5, 2,
                                events, snapshot_dir=str(tmp_path), snapshot_every=1)
    worker.step()
    resumed = StreamWorker.restore(tmp_path, {rid: StreamRequest(
        rid=rid, events=events[:, rid]) for rid in range(3)})
    assert resumed.compiled.device.type == "cuda" and resumed.ticks == 1
    while resumed.step():
        pass
    got = {r.rid: (r.readout.tobytes(), r.spikes, r.cycles, r.energy_uj)
           for r in resumed.done}
    assert got == {r.rid: (r.readout.tobytes(), r.spikes, r.cycles, r.energy_uj)
                   for r in ref.done}
