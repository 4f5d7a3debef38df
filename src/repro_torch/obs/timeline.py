"""Render the multi-core async-pipeline cost model as a Chrome trace.

``engine/cost.py::estimate_multicore_cost(..., collect_timeline=True)``
records, per (layer, core), the spike-driven row-op cycles of every
timestep exactly as they land in the per-core ``compute`` matrix.  This
module turns those records into Chrome-trace complete events so the
paper's handshaking pipeline and load-imbalance metric become visually
inspectable: one track per core, back-to-back busy intervals per layer
per timestep, one AER-routing interval, and an idle tail up to the plan
makespan.

The invariant (tested in ``tests/test_torch_compiler.py``): per core, the
summed duration of ``busy`` + ``routing`` events equals
``MulticoreCost.busy_cycles`` — cycle for cycle, no sampling, no
rounding.  The same code as ``repro.obs.timeline``'s, so the events are
equal to the reference's.

Timestamps/durations are *cycles* exported in the trace's microsecond
field, so Perfetto's "1 ms" reads as 1k cycles.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

__all__ = [
    "multicore_timeline",
    "busy_cycle_totals",
    "export_timeline",
    "write_chrome_trace",
]


def multicore_timeline(cost, label: str = "stream", pid: int = 1,
                       ts_offset: float = 0.0) -> List[dict]:
    """Chrome-trace events for one priced run (``collect_timeline=True``).

    ``cost`` is a :class:`repro_torch.engine.cost.MulticoreCost` whose
    ``timeline`` field was populated.  One ``tid`` per core; ``pid``
    separates streams when merging several runs into one trace.
    """
    if getattr(cost, "timeline", None) is None:
        raise ValueError(
            "MulticoreCost.timeline is empty — price the run with "
            "estimate_multicore_cost(..., collect_timeline=True)"
        )
    # Group records per core, preserving layer order within each timestep.
    per_core: Dict[int, List[dict]] = {}
    n_t = 0
    for rec in cost.timeline:
        per_core.setdefault(int(rec["core"]), []).append(rec)
        n_t = max(n_t, len(rec["cycles"]))

    events: List[dict] = []
    cores = sorted(set(per_core) | set(range(len(cost.compute_cycles))))
    for core in cores:
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": core,
            "args": {"name": f"{label} core{core}"},
        })
        cursor = float(ts_offset)
        for t in range(n_t):
            for rec in per_core.get(core, ()):
                dur = float(rec["cycles"][t]) if t < len(rec["cycles"]) else 0.0
                if dur <= 0.0:
                    continue
                events.append({
                    "name": rec["name"], "cat": "busy", "ph": "X",
                    "ts": cursor, "dur": dur, "pid": pid, "tid": core,
                    "args": {"layer": rec["layer"], "t": t,
                             "stream": label},
                })
                cursor += dur
        route = float(cost.routing_cycles[core])
        if route > 0.0:
            events.append({
                "name": "AER routing", "cat": "routing", "ph": "X",
                "ts": cursor, "dur": route, "pid": pid, "tid": core,
                "args": {"stream": label},
            })
            cursor += route
        idle = float(ts_offset) + float(cost.makespan_cycles) - cursor
        if idle > 0.0:
            events.append({
                "name": "idle", "cat": "idle", "ph": "X",
                "ts": cursor, "dur": idle, "pid": pid, "tid": core,
                "args": {"stream": label},
            })
    return events


def busy_cycle_totals(events: List[dict]) -> Dict[int, float]:
    """Summed busy+routing duration per core tid (the conservation check)."""
    totals: Dict[int, float] = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("busy", "routing"):
            tid = int(ev["tid"])
            totals[tid] = totals.get(tid, 0.0) + float(ev["dur"])
    return totals


def write_chrome_trace(events: List[dict], path) -> pathlib.Path:
    """Write raw events in the standard Chrome-trace envelope."""
    path = pathlib.Path(path)
    events = sorted(events, key=lambda e: e.get("ts", 0.0))
    path.write_text(json.dumps(
        {"traceEvents": events, "displayTimeUnit": "ms"}))
    return path


def export_timeline(cost, path, label: str = "stream",
                    pid: int = 1) -> Optional[pathlib.Path]:
    """One-call export: timeline events for ``cost`` -> Chrome-trace file."""
    return write_chrome_trace(multicore_timeline(cost, label, pid), path)
