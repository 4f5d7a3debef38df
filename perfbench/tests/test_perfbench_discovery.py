"""A configuration, a traffic mix and a metric are files found by name."""
import json
import shutil

from perfbench.harness import cell, setup_env
from perfbench.harness import traffic as traffic_mod
from perfbench.tests import _cells

METRIC = '''"""calls_seen.run: calls the window made (a test's reader)."""


def read(ctx):
    return float(len(ctx.record.calls)) if ctx.kind == "closed_run" else None
'''


def test_new_files_dropped_into_their_folders_are_found(tmp_path, monkeypatch):
    """A cell of a new configuration, under a new mix, reporting a new metric,
    runs by adding files and entries only."""
    root = tmp_path / "checkout"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(setup_env.ROOT / "perfbench" / sub, root / "perfbench" / sub)
    config, mix = _cells.small("gesture-run")
    config["name"] = "gesture_wide_frames"
    (root / "perfbench" / "configs" / "gesture_wide_frames.json").write_text(json.dumps(config))
    mix["batch"], mix["pool"] = 3, 5
    (root / "perfbench" / "traffic" / "closed_b3.json").write_text(json.dumps(mix))
    (root / "perfbench" / "metrics" / "calls_seen.run.py").write_text(METRIC)
    bench = cell.load_benchmark()
    bench["configs"].append({"name": "gesture_wide_frames", "source": "a test",
                             "file": "perfbench/configs/gesture_wide_frames.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "gesture-b3", "config": "gesture_wide_frames",
                               "traffic": "closed_b3", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("samples_per_s", "run_ms_p95"):
            m["workloads"].append("gesture-b3")
    bench["per_layer"].append({"name": "calls_seen.run", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "a test",
                               "moves": "samples_per_s", "workloads": ["gesture-b3"]})
    monkeypatch.setattr(cell, "ROOT", root)
    monkeypatch.setattr(cell, "METRICS_DIR", root / "perfbench" / "metrics")
    monkeypatch.setattr(traffic_mod, "TRAFFIC_DIR", root / "perfbench" / "traffic")
    import time

    result, _ = cell.run_cell("gesture-b3", 17, 0.5, True, t_proc=time.monotonic(),
                              device="cpu", bench=bench, log=lambda m: None)
    assert result["correct"]
    assert result["metrics"]["calls_seen.run"]["value"] == result["attempted"] > 0
    assert "samples_per_s" not in result["metrics"]          # a traced run
    plain, _ = cell.run_cell("gesture-b3", 17, 0.5, False, t_proc=time.monotonic(),
                             device="cpu", bench=bench, log=lambda m: None)
    assert set(plain["metrics"]) == {"samples_per_s", "run_ms_p95", "setup_s"}
