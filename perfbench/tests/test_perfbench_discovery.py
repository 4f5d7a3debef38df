"""Every part of a cell is a file found by name: a configuration, a traffic
mix and a metric, and a loop, a layer kind, an event generator and a
reference."""
import json
import shutil
import time

from perfbench.harness import cell, found, port, setup_env
from perfbench.harness import traffic as traffic_mod
from perfbench.tests import _cells

FOLDERS = ("configs", "traffic", "metrics", "loops", "checks", "layers", "events", "reference")

METRIC = '''"""calls_seen.run: calls the window made (a test's reader)."""


def read(ctx):
    return float(len(ctx.record.calls)) if ctx.kind == "closed_run" else None
'''

LAYER = '''"""conv_pool: a conv followed by its 2x2 pool, written as one layer (a test's kind)."""
from perfbench.harness import found

conv, pool = found.module("layers", "conv"), found.module("layers", "pool")


def weight_shape(layer):
    return conv.weight_shape(layer)


def out_hw(layer, hw):
    return pool.out_hw(layer, conv.out_hw(layer, hw))


def gemm(layer, hw):
    return conv.gemm(layer, hw)


def program(layer, neuron, weight):
    return conv.program(layer, neuron, weight) + pool.program(layer, neuron, None)
'''

REFERENCE = '''"""snn_conv_pool: snn_int, each conv_pool layer a conv and a pool (a test's reference)."""
from perfbench.harness import found

snn_int = found.module("reference", "snn_int")


def prepare(config, params, weight_bits):
    layers, weights = [], []
    for l, w in zip(config["layers"], params):
        if l["kind"] == "conv_pool":
            layers += [dict(l, kind="conv"), {"kind": "pool", "window": l["window"]}]
            weights += [w, None]
        else:
            layers.append(l)
            weights.append(w)
    return snn_int.prepare(dict(config, layers=layers), weights, weight_bits)


def run(config, layers, clips, vmem_bits, readout_at=None):
    return snn_int.run(config, layers, clips, vmem_bits, readout_at)
'''

EVENTS = '''"""sparkle: independent events on both polarities at the mix's flow_density
(a test's generator)."""
import torch


def clips(g, n, t, hw, traffic):
    u = torch.rand((t, n, *hw, 2), generator=g, device=g.device)
    return (u < traffic["flow_density"]).to(torch.int8)
'''

LOOP = '''"""closed_pairs: closed_run with its calls timed in pairs (a test's loop)."""
import time

from perfbench.harness import found

base = found.module("loops", "closed_run")
setup, free, answers, end_to_end = base.setup, base.free, base.answers, base.end_to_end


def window(ctx, seconds, span):
    calls, batches = [], ctx.batch_dev
    start = time.monotonic()
    t1 = start
    while t1 < start + seconds:
        t0 = time.monotonic()
        pair = []
        for _ in range(2):
            j = (len(calls) + len(pair)) % len(batches)
            with span("compiled.run"):
                out = ctx.compiled.run(batches[j])
            pair.append((j, out.readout.cpu(), out.spike_counts.cpu(), out.input_counts.cpu()))
        t1 = time.monotonic()
        calls += [(j, t0, t1, *answer) for j, *answer in pair]
    return base.ClosedRecord(start, t1, calls)
'''

CHECK = '''"""closed_pairs: judged as closed_run (a test's check)."""
from perfbench.harness import found

base = found.module("checks", "closed_run")
LIMITS, work, reference, compare, control_answers = (
    base.LIMITS, base.work, base.reference, base.compare, base.control_answers)
'''

SPIKES = '''"""spikes_seen.pairs: output spikes the reference counted over the pool (a test's reader)."""


def read(ctx):
    return float(ctx.ref["out_counts"].sum()) if ctx.kind == "closed_pairs" else None
'''


def _checkout(tmp_path, monkeypatch):
    """A copy of the benchmark's folders that ``cell`` and ``found`` read."""
    root = tmp_path / "checkout"
    (root / "perfbench").mkdir(parents=True)
    shutil.copy(setup_env.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in FOLDERS:
        shutil.copytree(setup_env.ROOT / "perfbench" / sub, root / "perfbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(cell, "ROOT", root)
    monkeypatch.setattr(found, "BENCH", root / "perfbench")
    monkeypatch.setattr(traffic_mod, "TRAFFIC_DIR", root / "perfbench" / "traffic")
    return root / "perfbench"


def _add_cell(bench, config, traffic, workload, metric, source):
    bench["configs"].append({"name": config, "source": "a test",
                             "file": f"perfbench/configs/{config}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": workload, "config": config, "traffic": traffic,
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("samples_per_s", "run_ms_p95"):
            m["workloads"].append(workload)
    bench["per_layer"].append({"name": metric, "unit": "1", "better": "higher",
                               "source": source, "layer": "a test",
                               "moves": "samples_per_s", "workloads": [workload]})


def test_new_files_dropped_into_their_folders_are_found(tmp_path, monkeypatch):
    """A cell of a new configuration, under a new mix, reporting a new metric,
    runs by adding files and entries only."""
    bench_dir = _checkout(tmp_path, monkeypatch)
    config, mix = _cells.small("gesture-run")
    config["name"] = "gesture_wide_frames"
    (bench_dir / "configs" / "gesture_wide_frames.json").write_text(json.dumps(config))
    mix["batch"], mix["pool"] = 3, 5
    (bench_dir / "traffic" / "closed_b3.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "calls_seen.run.py").write_text(METRIC)
    bench = cell.load_benchmark()
    _add_cell(bench, "gesture_wide_frames", "closed_b3", "gesture-b3", "calls_seen.run",
              "program_counter")

    result, _ = cell.run_cell("gesture-b3", 17, 0.5, True, t_proc=time.monotonic(),
                              device="cpu", bench=bench, log=lambda m: None)
    assert result["correct"]
    assert result["metrics"]["calls_seen.run"]["value"] == result["attempted"] > 0
    assert "samples_per_s" not in result["metrics"]          # a traced run
    plain, _ = cell.run_cell("gesture-b3", 17, 0.5, False, t_proc=time.monotonic(),
                             device="cpu", bench=bench, log=lambda m: None)
    assert set(plain["metrics"]) == {"samples_per_s", "run_ms_p95", "setup_s"}


def test_new_loop_layer_kind_and_events_need_no_harness_change(tmp_path, monkeypatch):
    """A loop kind (calls timed in pairs), a layer kind (a conv and its pool as
    one layer, which the program runs as two) with a reference that knows it,
    and an event generator, each added as a file: a whole cell runs on the
    CPU and is correct, and nothing under ``harness/`` names them."""
    harness = setup_env.ROOT / "perfbench" / "harness"
    sources = {p.name: p.read_text() for p in harness.glob("*.py")}
    bench_dir = _checkout(tmp_path, monkeypatch)
    for folder, name, text in (("layers", "conv_pool", LAYER), ("events", "sparkle", EVENTS),
                               ("reference", "snn_conv_pool", REFERENCE),
                               ("loops", "closed_pairs", LOOP), ("checks", "closed_pairs", CHECK),
                               ("metrics", "spikes_seen.pairs", SPIKES)):
        assert not any(name in text for text in sources.values()), name
        (bench_dir / folder / f"{name}.py").write_text(text)
    config, mix = _cells.small("gesture-run")
    layers = config["layers"]
    assert [l["kind"] for l in layers[2:4]] == ["conv", "pool"]
    config["layers"] = layers[:2] + [dict(layers[2], kind="conv_pool", window=2)] + layers[4:]
    config.update(name="gesture_pooled", events="sparkle", reference="snn_conv_pool")
    (bench_dir / "configs" / "gesture_pooled.json").write_text(json.dumps(config))
    mix.update(kind="closed_pairs", batch=2, pool=4)
    (bench_dir / "traffic" / "pairs_b2.json").write_text(json.dumps(mix))
    bench = cell.load_benchmark()
    _add_cell(bench, "gesture_pooled", "pairs_b2", "gesture-pairs", "spikes_seen.pairs",
              "device_trace")

    spec, weights = port.program(config, [None] * len(config["layers"]))
    assert [l.kind for l in spec.layers] == [l["kind"] for l in layers]
    traced, table = cell.run_cell("gesture-pairs", 23, 0.5, True, t_proc=time.monotonic(),
                                  device="cpu", bench=bench, log=lambda m: None)
    assert traced["correct"], table
    assert traced["attempted"] > 0 and traced["attempted"] % 2 == 0
    assert traced["metrics"]["spikes_seen.pairs"]["value"] > 0   # the check compared spikes
    plain, table = cell.run_cell("gesture-pairs", 23, 0.5, False, t_proc=time.monotonic(),
                                 device="cpu", bench=bench, log=lambda m: None)
    assert plain["correct"], table
    assert set(plain["metrics"]) == {"samples_per_s", "run_ms_p95", "setup_s"}
    assert {p.name: p.read_text() for p in harness.glob("*.py")} == sources
