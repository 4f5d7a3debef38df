"""closed_run: one caller in a closed loop on ``CompiledSNN.run``.

Set-up deploys the configuration and warms up the window's one shape on
two of its batches.  The window calls ``run`` back to back, each call
ending with its readout (and its per-layer counts, a few hundred bytes) on
the host; the batches are used in turn.  Times on the host's monotonic
clock, and marks the calls into the program with the benchmark's spans,
which cost nothing unless the run is traced.
"""
from __future__ import annotations

import dataclasses
import time

from perfbench.harness import port, stats


@dataclasses.dataclass
class ClosedRecord:
    start: float                  # window start (monotonic s)
    end: float                    # end of the last call
    calls: list                   # (batch index, t0, t1, readout, spike counts, input
                                  # counts), all on the host


def setup(ctx, params: list, dev) -> None:
    """The deployment, warmed up; the batches on the device."""
    ctx.batch_dev = [ctx.pool[:, list(idx)].contiguous() for idx in ctx.batches]
    ctx.compiled = port.deploy(ctx.config, params, dev)
    for b in ctx.batch_dev[:2]:                    # the one shape the window uses
        ctx.compiled.run(b).readout.cpu()


def window(ctx, seconds: float, span) -> ClosedRecord:
    """Call ``run(batch)`` back to back for ``seconds``, each call ending with
    its readout (and its per-layer counts) on the host; the batches are used
    in turn."""
    run, batches = ctx.compiled.run, ctx.batch_dev
    calls = []
    start = time.monotonic()
    stop = start + seconds
    t1 = start
    while t1 < stop:
        j = len(calls) % len(batches)
        t0 = time.monotonic()
        with span("compiled.run"):
            out = run(batches[j])
        with span("readout.to_host"):
            readout = out.readout.cpu()
            counts = out.spike_counts.cpu(), out.input_counts.cpu()
        t1 = time.monotonic()
        calls.append((j, t0, t1, readout, *counts))
    return ClosedRecord(start, t1, calls)


def free(ctx) -> None:
    ctx.compiled = None


def answers(ctx) -> tuple:
    """``(answers for checks/closed_run.py, attempted, failed)``."""
    calls = ctx.record.calls
    return [(j, r, s, i) for j, _, _, r, s, i in calls], len(calls), 0


def end_to_end(rec: ClosedRecord, mix: dict) -> dict:
    """Samples over the window, and the tail of every call."""
    lat = [t1 - t0 for _, t0, t1, *_ in rec.calls]
    return {"samples_per_s": len(rec.calls) * mix["batch"] / (rec.end - rec.start),
            "run_ms_p95": stats.percentile(lat, 95) * 1e3}
