"""The command's contract: no result without a card or without the program;
and, on the card, the reference against the program at the timed sizes."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench.harness import found, inputs, port, setup_env, traffic

ROOT = setup_env.ROOT


def _run(cwd, *args):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("there is a card: the run would measure it")
    r = _run(ROOT, "--workload", "gesture-run", "--seed", "3", "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout == "", (r.returncode, r.stdout, r.stderr)


def test_no_result_with_only_the_benchmarks_files(tmp_path):
    """A directory holding BENCHMARK.json and perfbench/ alone: no program to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, "--workload", "flow-run", "--seed", "3", "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout == "", (r.returncode, r.stdout, r.stderr)


def test_benchmark_json_names_files_that_exist():
    """Every name a cell resolves has its file: configuration, mix, the mix's
    loop and check, each layer kind, the event generator, the reference, each
    per-layer metric."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"]
        for layer in config["layers"]:
            assert found.module("layers", layer["kind"]).program
        assert found.module("events", config["events"]).clips
        assert found.module("reference", config["reference"]).run
    for w in bench["workloads"]:
        kind = traffic.load(w["traffic"])["kind"]
        assert found.module("loops", kind).window and found.module("checks", kind).compare
    for m in bench["per_layer"]:
        assert found.module("metrics", m["name"]).read, m["name"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["flow-run", "gesture-run"])
def test_program_equals_reference_at_the_timed_size(cuda_device, workload):
    """One timed batch through the deployed program against the reference, exactly."""
    from perfbench.harness import cell

    c = cell.resolve(cell.load_benchmark(), workload)
    config, mix = c["config"], c["traffic"]
    judge = found.module("checks", mix["kind"])
    params = inputs.make_weights(config, 77, cuda_device)
    work = judge.work(config, mix, 77, 1.0, cuda_device)
    idx = list(work["batches"][0])
    out = port.deploy(config, params, cuda_device).run(work["pool"][:, idx].contiguous())
    ref = judge.reference(config, mix, params, work, 7, cuda_device)
    nums = judge.compare([(0, out.readout.cpu(), out.spike_counts.cpu(),
                           out.input_counts.cpu())], work, ref)
    assert nums == {"readout_mismatch": 0, "count_mismatch": 0}
