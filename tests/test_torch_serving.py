"""Port parity, facade and serving: repro_torch.spidr / serving / snn.data
against the JAX package, plus the port's package rules (no JAX imports,
no silent CPU fallback, unported flags rejected by name) and the serve
CLI's streaming and telemetry flags."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, jax_ref  # noqa: F401  (fixture)
from repro_torch import resolve_device, spidr
from repro_torch.configs import spidr_gesture, spidr_optflow
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.serving import BatchWorker, StreamRequest
from repro_torch.snn import data

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _gesture(jax_ref, hw=(16, 16), t=4):
    spec = spidr_gesture.reduced(hw=hw, timesteps=t)
    spec_j = jax_ref.spidr_gesture.reduced(hw=hw, timesteps=t)
    params = [None if p is None else np.asarray(p) for p in
              jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(3), spec_j)]
    return spec, spec_j, params


@pytest.mark.parametrize("backend", ["fused", "torch", "reference"])
@pytest.mark.parametrize("t_block", [1, 2])
def test_compile_run_verify(jax_ref, backend, t_block):
    spec, spec_j, params = _gesture(jax_ref)
    target = spidr.DeployTarget(weight_bits=6, backend=backend, t_block=t_block)
    compiled = spidr.compile(spec, params_from_jax(params, "cpu"), target,
                             device="cpu")
    rng = np.random.default_rng(0)
    events = (rng.random((4, 2, 16, 16, 2)) < 0.2).astype(np.float32)
    out = compiled.run(events)
    want = jax_ref.spidr.compile(
        spec_j, [None if p is None else jax_ref.jnp.asarray(p) for p in params],
        jax_ref.spidr.DeployTarget(weight_bits=6, backend="jnp"),
        check="off").run(events)
    assert_same(out.readout, want.readout)
    assert_same(out.spike_counts, want.spike_counts)
    report = compiled.verify(events)
    assert report.exact
    assert compiled.verify().exact  # synthetic default batch


def test_batch_worker_matches_jax(jax_ref):
    spec, spec_j, params = _gesture(jax_ref)
    rng = np.random.default_rng(1)
    streams = (rng.random((5, 4, 16, 16, 2)) < 0.2).astype(np.float32)
    compiled = spidr.compile(spec, params_from_jax(params, "cpu"),
                             spidr.DeployTarget(backend="fused", t_block=2),
                             device="cpu")
    worker = BatchWorker(compiled, capacity=2)
    compiled_j = jax_ref.spidr.compile(
        spec_j, [None if p is None else jax_ref.jnp.asarray(p) for p in params],
        jax_ref.spidr.DeployTarget(backend="jnp"), check="off")
    worker_j = jax_ref.serving.BatchWorker(compiled_j, capacity=2)
    for rid, ev in enumerate(streams):
        worker.submit(StreamRequest(rid=rid, events=ev))
        worker_j.submit(jax_ref.serving.StreamRequest(rid=rid, events=ev))
    while worker.step():
        pass
    while worker_j.step():
        pass
    assert worker.batches == worker_j.batches == 3
    assert [r.rid for r in worker.done] == [r.rid for r in worker_j.done]
    for a, b in zip(worker.done, worker_j.done):
        assert_same(a.readout, b.readout)
    assert_same(worker.total_input_counts, worker_j.total_input_counts)
    worker.shutdown()
    with pytest.raises(RuntimeError):
        worker.submit(StreamRequest(rid=9, events=streams[0]))


@pytest.mark.parametrize("hw,t,batch", [((16, 24), 5, 3), ((288, 384), 3, 1)])
def test_flow_renderer_bit_exact_given_jax_draws(jax_ref, hw, t, batch):
    key = jax_ref.jax.random.PRNGKey(7)
    tex, vel = jax_ref.data._flow_stream_params(key, batch, hw, 0.05)
    want, flow = jax_ref.data.make_flow_batch(key, batch=batch, timesteps=t, hw=hw)
    got = data.render_flow(torch.from_numpy(np.array(tex)),
                           torch.from_numpy(np.array(vel)), t)
    assert got.dtype == torch.float32
    assert_same(got, want)


@pytest.mark.parametrize("hw,t,batch", [((16, 16), 6, 4), ((64, 64), 20, 2)])
def test_gesture_renderer_given_jax_draws(jax_ref, hw, t, batch):
    """float32 cos/sin differ in the last ulp between the frameworks, which
    flips pixels exactly on the band edge: at most 1e-3 of them may differ."""
    jax = jax_ref.jax
    key = jax.random.PRNGKey(11)
    labels, _, _, phases, k_noise = jax_ref.data._gesture_stream_params(key, batch)
    on, off = [], []
    for step in range(t):
        keys = jax.random.split(jax.random.fold_in(k_noise, step), batch)
        pairs = [jax.random.split(k) for k in keys]
        on.append([np.asarray(jax.random.bernoulli(k1, 0.002, hw)) for k1, _ in pairs])
        off.append([np.asarray(jax.random.bernoulli(k2, 0.002, hw)) for _, k2 in pairs])
    draws = data.GestureDraws(
        labels=torch.from_numpy(np.array(labels, np.int64)),
        phases=torch.from_numpy(np.array(phases)),
        noise_on=torch.from_numpy(np.array(on)),
        noise_off=torch.from_numpy(np.array(off)))
    got = data.render_gesture(draws).numpy()
    want, _ = jax_ref.data.make_gesture_batch(key, batch=batch, timesteps=t, hw=hw)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert (got != want).mean() <= 1e-3
    assert want.sum() > 0


def test_data_generators_on_cpu():
    g = torch.Generator().manual_seed(0)
    ev, labels = data.make_gesture_batch(g, batch=3, timesteps=4, hw=(16, 16),
                                         device="cpu")
    assert ev.shape == (4, 3, 16, 16, 2) and labels.shape == (3,)
    assert set(np.unique(ev.numpy())) <= {0.0, 1.0} and ev.sum() > 0
    ev, flow = data.make_flow_batch(g, batch=2, timesteps=3, hw=(8, 12),
                                    device="cpu")
    assert ev.shape == (3, 2, 8, 12, 2) and flow.shape == (2, 8, 12, 2)


def test_no_card_means_raise_not_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = spidr_optflow.reduced(hw=(8, 8), timesteps=2)
    from repro_torch.core.network import init_params

    params = init_params(torch.Generator().manual_seed(0), spec)
    with pytest.raises(RuntimeError, match="cuda"):
        spidr.compile(spec, params)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert spidr.compile(spec, params, device="cpu").device.type == "cpu"


def test_deploy_target_validation():
    with pytest.raises(ValueError, match=r"\(4, 7\).*\(6, 11\)"):
        spidr.DeployTarget(weight_bits=5, vmem_bits=9)
    with pytest.raises(ValueError, match="backend"):
        spidr.DeployTarget(backend="jnp")
    assert spidr.DeployTarget(n_cores=4).multicore
    with pytest.raises(ValueError, match="force_mode"):
        spidr.DeployTarget(n_cores=4, force_mode=3)
    assert spidr.DeployTarget(autotune=True).autotune
    with pytest.raises(ValueError, match="autotune"):
        spidr.DeployTarget(autotune=True, backend="torch")
    with pytest.raises(ValueError, match="t_block"):
        spidr.DeployTarget(t_block=0)
    assert spidr.DeployTarget(weight_bits=8).vmem_bits == 15


@pytest.mark.parametrize("argv,item", [
    (["--snn", "gesture", "--jnp"], "--torch"),
    (["--arch", "gpt-5"], "unknown LM arch"),
    ([], "--arch"),
])
def test_cli_rejects_unported_flags_by_name(capsys, argv, item):
    with pytest.raises(SystemExit) as e:
        serve.parse_args(argv)
    assert e.value.code != 0
    assert item in capsys.readouterr().err


@pytest.fixture
def fresh_obs():
    """The CLI's telemetry flags enable the process-wide registry and
    tracer; each test gets fresh disabled ones and leaves them so."""
    from repro_torch import obs

    obs.set_default_registry(obs.MetricsRegistry(enabled=False))
    obs.set_default_tracer(obs.Tracer(enabled=False))
    yield obs
    obs.set_default_registry(obs.MetricsRegistry(enabled=False))
    obs.set_default_tracer(obs.Tracer(enabled=False))


_CLI = ["--snn", "gesture", "--device", "cpu", "--requests", "3", "--capacity", "2"]


@pytest.mark.parametrize("flag", ["--streaming", "--chunk-T", "--trace-out",
                                  "--metrics-out"])
def test_cli_streaming_and_telemetry_flags_serve_on_cpu(fresh_obs, tmp_path, flag):
    """Each flag the port used to reject now serves and has its effect:
    streams served through a StreamWorker (equal to the whole-stream
    batches), chunks of ``--chunk-T`` timesteps, a Chrome trace with the
    serving spans and, on a 4-core plan, each stream's pipeline timeline,
    a metrics dump."""
    extra = {"--streaming": ["--streaming"],
             "--chunk-T": ["--streaming", "--chunk-T", "5"],
             "--trace-out": ["--streaming", "--n-cores", "4",
                             "--trace-out", str(tmp_path / "t.json")],
             "--metrics-out": ["--metrics-out", str(tmp_path / "m.json")]}[flag]
    worker = serve.serve_snn(serve.parse_args(_CLI + extra)).workers[0]
    assert len(worker.done) == 3
    assert all(r.readout.shape == (11,) for r in worker.done)
    if flag == "--metrics-out":
        dump = json.loads((tmp_path / "m.json").read_text())
        assert dump["spidr_serve_batches_total"][0]["value"] == worker.batches == 2
        return
    batch = serve.serve_snn(serve.parse_args(_CLI)).workers[0]
    for a, b in zip(sorted(worker.done, key=lambda r: r.rid), batch.done):
        assert_same(a.readout, b.readout)
        assert a.cycles > 0 and a.energy_uj > 0 and a.cursor == 20
    assert worker.closed and worker.restarts == 0
    if flag == "--chunk-T":
        assert worker.chunk_T == 5 and worker.ticks == 8   # 2 streams, then 1
    elif flag == "--streaming":
        assert worker.chunk_T == 2 and worker.ticks == 20
    else:
        events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
        names = [e["name"] for e in events if e.get("ph") == "X"]
        # One serve.tick per step(), the last one finding no work left.
        assert names.count("serve.tick") == worker.ticks + 1
        assert names.count("run_chunk") == worker.ticks
        # Beside this process's spans, one process row per stream's timeline.
        assert {e["pid"] for e in events} - {os.getpid()} == {100, 101, 102}


def test_cli_serves_on_cpu():
    worker = serve.serve_snn(serve.parse_args(
        ["--snn", "gesture", "--device", "cpu", "--requests", "3",
         "--capacity", "2", "--t-block", "2"])).workers[0]
    assert len(worker.done) == 3 and worker.batches == 2
    assert all(r.readout.shape == (11,) for r in worker.done)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "upgrade_drill_torch.py"]
    assert len(files) > 10
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    # Importing the subpackages (and what they import at run time) in a
    # fresh interpreter loads neither package.
    code = ("import sys; import repro_torch.compiler, repro_torch.checkpoint, "
            "repro_torch.obs, repro_torch.snn.export, repro_torch.spidr, "
            "repro_torch.launch.optical_flow, repro_torch.launch.serve, "
            "repro_torch.engine.streaming, repro_torch.serving, "
            "repro_torch.runtime; "
            f"sys.path.insert(0, {str(ROOT / 'tools')!r}); import upgrade_drill_torch; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout

