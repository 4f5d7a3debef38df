"""One run of one cell: set up, measure the window, check, report.

Everything a cell needs is found by name: the workload in
``BENCHMARK.json``, its configuration file, its traffic file
(``perfbench/traffic/<traffic>.json``), the reference the configuration
names (``perfbench/reference/<name>.py``) and one reader per per-layer
metric (``perfbench/metrics/<metric>.py``).  Adding a cell, a
configuration, a mix or a metric adds files and entries; nothing here
changes.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
import types

import torch

from . import check, drivers, inputs, port, stats
from . import trace as tracing
from . import traffic as traffic_mod
from .setup_env import ROOT, forbidden_modules

METRICS_DIR = ROOT / "perfbench" / "metrics"


class CellError(RuntimeError):
    """A run that cannot report: no card, a forbidden module, a bad cell."""


def load_benchmark(path=None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def resolve(bench: dict, workload: str) -> dict:
    """The workload entry with its configuration, traffic and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(have: {', '.join(sorted(cells))})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "cell": cell,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": traffic_mod.load(cell["traffic"]),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def reader(name: str):
    """The per-layer metric ``name``'s reader: ``perfbench/metrics/<name>.py``'s ``read``."""
    path = METRICS_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    if spec is None or not path.exists():
        raise CellError(f"no reader for per-layer metric {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _device(require_chips: int, device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise CellError("torch.cuda.is_available() is False: the benchmark measures the card")
    if torch.cuda.device_count() < require_chips:
        raise CellError(f"the cell asks for {require_chips} card(s), the host has "
                        f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup_serve(config: dict, mix: dict, params: list, seed: int, dev):
    """A serve cell's deployment, warmed up on the tick's one shape by a fleet
    that is then gone, and its clips as host arrays ``(N, T, H, W, C)``."""
    clips = inputs.make_clips(config, mix, mix["pool"], max(mix["lengths"]), seed, dev)
    clips_host = clips.transpose(0, 1).contiguous().cpu().numpy()
    del clips
    compiled = port.deploy(config, params, dev)
    warm = port.serve(compiled, mix)
    for i in range(mix["capacity"]):
        warm.submit(clips_host[i % mix["pool"], :min(mix["lengths"])])
    warm.drain()
    warm.shutdown()
    return compiled, clips_host


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t_proc: float,
             device=None, bench=None, config=None, traffic=None, log=None) -> tuple:
    """One run.  Returns ``(result line dict, check table)``.

    A traced run (``trace``) measures the first ``trace.TRACE_SECONDS`` of
    the window at most, the same work at the same rate, under the profiler.

    ``device``, ``config`` and ``traffic`` override the card and the files
    (the CPU tests drive a whole run at small sizes through them).
    """
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    c = resolve(bench or load_benchmark(), workload)
    config = config or c["config"]
    mix = traffic or c["traffic"]
    dev = _device(int(c["cell"]["chips"]), device)
    kind = mix["kind"]
    params = inputs.make_weights(config, seed, dev)
    recorded = tracing.Spans() if trace else None
    span = tracing.annotate(recorded)
    ctx = types.SimpleNamespace(kind=kind, config=config, traffic=mix, trace=None,
                                port_kernels=port.kernel_names())

    if kind == "closed_run":
        pool = inputs.make_clips(config, mix, mix["pool"], config["timesteps"], seed, dev)
        batches = traffic_mod.batches(mix, seed)
        batch_dev = [pool[:, list(idx)].contiguous() for idx in batches]
        compiled = port.deploy(config, params, dev)
        for b in batch_dev[:2]:                    # the one shape the window uses
            compiled.run(b).readout.cpu()
        fleet = clips_host = schedule = None
    elif kind == "open_serve":
        compiled, clips_host = setup_serve(config, mix, params, seed, dev)
        schedule = traffic_mod.schedule(mix, seed, seconds)
        fleet = port.serve(compiled, mix)
    else:
        raise CellError(f"unknown traffic kind {kind!r}")
    _sync(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = port.launches()
    prof = tracing.profiler() if trace else None
    if prof is not None:
        # The profiler's start takes seconds: it is set-up, outside the window.
        prof.__enter__()
        seconds = min(seconds, tracing.TRACE_SECONDS)
        schedule = None if schedule is None else traffic_mod.schedule(mix, seed, seconds)
        recorded.start()
    setup_s = time.monotonic() - t_proc
    if kind == "closed_run":
        rec = drivers.closed_run(compiled.run, batch_dev, seconds, span)
    else:
        rec = drivers.open_serve(fleet, clips_host, schedule, seconds, span, port.overloaded())
    _sync(dev)
    if prof is not None:
        recorded.stop()
        prof.__exit__(None, None, None)
    ctx.launches = port.launches() - launches0

    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    if prof is not None:
        t_red = time.monotonic()
        ctx.trace = tracing.reduce(prof, recorded)
        log(f"trace reduced in {time.monotonic() - t_red:.1f} s")
        del prof

    # The program's state goes before the reference runs.
    if fleet is not None:
        fleet.shutdown()
    del fleet, compiled
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    d = config["deploy"]
    t_ref = time.monotonic()
    if kind == "closed_run":
        ref = check.run_reference(config, params, pool, d["vmem_bits"], d["weight_bits"])
        numbers = check.closed_run([(j, r, s, i) for j, _, _, r, s, i in rec.calls], batches, ref)
        attempted, failed = len(rec.calls), 0
    else:
        at = sorted({l - 1 for l in mix["lengths"]})
        clips = torch.from_numpy(clips_host).to(dev).transpose(0, 1)
        ref = check.run_reference(config, params, clips, d["vmem_bits"], d["weight_bits"], at)
        del clips
        streams = [(clip, length, None if h is None or not h.done else h.readout,
                    None if h is None or not h.done else h.request.spikes)
                   for _, clip, length, h in rec.offered if h is not None]
        numbers = check.open_serve(streams, ref)
        attempted = len(rec.offered)
        failed = sum(1 for *_, h in rec.offered if h is None or not h.done)
    log(f"reference in {time.monotonic() - t_ref:.1f} s")
    correct, table = check.verdict(numbers)

    ctx.ref, ctx.batches, ctx.record = ref, (batches if kind == "closed_run" else None), rec
    if trace:
        metrics = {}
        for m in c["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = _end_to_end(kind, rec, mix, c["end_to_end"], setup_s)
    # Last, after the fleet's shutdown, the reference and the readers have
    # loaded what they load: nothing of JAX may be in the process that reports.
    found = forbidden_modules()
    if found:
        raise CellError(f"forbidden modules loaded by the time the result was made: {found}")
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(c["cell"]["chips"]), "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_breakdown(),
                               "idle_gaps": ctx.trace.gap_breakdown()}
    result["check"] = table
    return result, table


def _end_to_end(kind: str, rec, mix: dict, wanted: list, setup_s: float) -> dict:
    """The end-to-end metrics.  A serve cell's tail is over every stream
    offered: one shed, or admitted and never finished, counts as infinitely
    late, so shedding cannot shorten it; a tail that lands on one cannot be
    reported."""
    values = {"setup_s": setup_s}
    if kind == "closed_run":
        lat = [t1 - t0 for _, t0, t1, *_ in rec.calls]
        values["samples_per_s"] = len(rec.calls) * mix["batch"] / (rec.end - rec.start)
        values["run_ms_p95"] = stats.percentile(lat, 95) * 1e3
    else:
        lat = [h.request.done_at - (rec.start + due) if h is not None and h.done else math.inf
               for due, _, _, h in rec.offered]
        done = [(length, h.request.done_at) for _, _, length, h in rec.offered
                if h is not None and h.done]
        if lat:
            values["stream_ms_p95"] = stats.percentile(lat, 95) * 1e3
        if done:
            span = max(t for _, t in done) - (rec.start + rec.offered[0][0])
            values["streams_per_s"] = len(done) / span
            values["stream_steps_per_s"] = sum(length for length, _ in done) / span
    out = {}
    for m in wanted:
        if m["name"] in values:
            if not math.isfinite(values[m["name"]]):
                raise CellError(f"{m['name']} is unbounded: more than 5 % of the offered "
                                "streams were shed or never finished")
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out
