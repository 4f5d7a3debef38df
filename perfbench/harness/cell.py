"""One run of one cell: set up, measure the window, check, report.

Everything a cell needs is found by name (``found.py``): the workload in
``BENCHMARK.json``, its configuration file, its traffic file
(``traffic/<traffic>.json``), the loop and the check of the mix's kind
(``loops/<kind>.py``, ``checks/<kind>.py``), the configuration's layer
kinds, event generator and reference, and one reader per per-layer metric
(``metrics/<metric>.py``).  Adding a cell, a configuration, a mix, a loop,
a layer kind, an event generator or a metric adds files and entries;
nothing here changes.
"""
from __future__ import annotations

import gc
import json
import math
import sys
import time
import types

import torch

from . import check, found, inputs, port
from . import trace as tracing
from . import traffic as traffic_mod
from .found import CellError
from .setup_env import ROOT, forbidden_modules


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
    """The per-layer metric ``name``'s reader: ``metrics/<name>.py``'s ``read``."""
    return found.module("metrics", name).read


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
    loop, judge = found.module("loops", mix["kind"]), found.module("checks", mix["kind"])
    if trace:
        seconds = min(seconds, tracing.TRACE_SECONDS)
    params = inputs.make_weights(config, seed, dev)
    work = judge.work(config, mix, seed, seconds, dev)
    if dev.type == "cuda":
        # The generators' scratch goes back to the card, so that the reserved
        # peak read below is what the program holds, not the inputs' cache.
        torch.cuda.empty_cache()
    recorded = tracing.Spans() if trace else None
    span = tracing.annotate(recorded)
    ctx = types.SimpleNamespace(kind=mix["kind"], config=config, traffic=mix, trace=None,
                                port_kernels=port.kernel_names(), **work)
    loop.setup(ctx, params, dev)
    _sync(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = port.launches()
    prof = tracing.profiler() if trace else None
    if prof is not None:
        # The profiler's start takes seconds: it is set-up, outside the window.
        prof.__enter__()
        recorded.start()
    setup_s = time.monotonic() - t_proc
    ctx.record = loop.window(ctx, seconds, span)
    _sync(dev)
    if prof is not None:
        recorded.stop()
        prof.__exit__(None, None, None)
    ctx.launches = port.launches() - launches0

    # Reserved, not allocated: a CUDA graph's intermediates live in its private
    # pool, which the allocated bytes leave out.
    memory_peak = int(torch.cuda.max_memory_reserved(dev)) if dev.type == "cuda" else 0
    if prof is not None:
        t_red = time.monotonic()
        ctx.trace = tracing.reduce(prof, recorded)
        log(f"trace reduced in {time.monotonic() - t_red:.1f} s")
        del prof

    # The program's state goes before the reference runs.
    loop.free(ctx)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.monotonic()
    ctx.ref = judge.reference(config, mix, params, work, config["deploy"]["vmem_bits"], dev)
    answers, attempted, failed = loop.answers(ctx)
    numbers = judge.compare(answers, work, ctx.ref)
    log(f"reference in {time.monotonic() - t_ref:.1f} s")
    correct, table = check.verdict(numbers, judge.LIMITS)

    if trace:
        metrics = {}
        for m in c["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = _end_to_end(loop, ctx.record, mix, c["end_to_end"], setup_s)
    # Last, after the fleet's shutdown, the reference and the readers have
    # loaded what they load: nothing of JAX may be in the process that reports.
    loaded = forbidden_modules()
    if loaded:
        raise CellError(f"forbidden modules loaded by the time the result was made: {loaded}")
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


def _end_to_end(loop, rec, mix: dict, wanted: list, setup_s: float) -> dict:
    """The end-to-end metrics: ``setup_s`` and what the loop reads off its
    record.  A tail that lands on work shed or never finished is unbounded
    and cannot be reported."""
    values = {"setup_s": setup_s, **loop.end_to_end(rec, mix)}
    out = {}
    for m in wanted:
        if m["name"] in values:
            if not math.isfinite(values[m["name"]]):
                raise CellError(f"{m['name']} is unbounded: more than 5 % of the offered "
                                "work was shed or never finished")
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out
