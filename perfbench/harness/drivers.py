"""The two loops that offer a mix's work to the program inside the window.

Both time on the host's monotonic clock (the clock the program stamps a
stream's ``done_at`` with) and mark their calls into the program with the
benchmark's spans, which cost nothing unless the run is traced.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class ClosedRecord:
    start: float                  # window start (monotonic s)
    end: float                    # end of the last call
    calls: list                   # (batch index, t0, t1, readout, spike counts, input
                                  # counts), all on the host


def closed_run(run, batches: list, seconds: float, span) -> ClosedRecord:
    """Call ``run(batch)`` back to back for ``seconds``, each call ending with
    its readout (and its per-layer counts, a few hundred bytes) on the host;
    the batches are used in turn."""
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


@dataclasses.dataclass
class ServeRecord:
    start: float                  # window start (monotonic s); dues are offsets from it
    end: float                    # window end: arrivals stop
    offered: list                 # (due offset, clip, length, handle or None if shed)
    ticks: list                   # host seconds of each Fleet.step inside the window
    depths: list                  # queue depth after each window tick
    late: list                    # submit time minus due time, per offered stream
    drained: bool                 # every admitted stream finished within the drain time


def open_serve(fleet, clips_host, schedule: list, seconds: float, span, overloaded,
               drain_s: float = 120.0) -> ServeRecord:
    """Offer ``schedule``'s streams at their due times for ``seconds``, ticking
    the fleet whenever it holds work; then stop arrivals and drain.

    Every stream of the schedule is offered, also one whose due time a tick
    overran at the window's end (it is offered late, and its lateness
    counts), so every run offers the same work.  The drain waits up to
    ``drain_s`` for the backlog a mix above the fleet's capacity builds.
    """
    offered, ticks, depths, late, pending = [], [], [], [], []
    start = time.monotonic()
    stop = start + seconds
    i = 0
    while True:
        now = time.monotonic()
        if now >= stop and i == len(schedule):
            break
        while i < len(schedule) and start + schedule[i][0] <= now:
            due, clip, length = schedule[i]
            with span("fleet.submit"):
                try:
                    h = fleet.submit(clips_host[clip, :length])
                except overloaded:
                    h = None
            late.append(time.monotonic() - (start + due))
            offered.append((due, clip, length, h))
            if h is not None:
                pending.append(h)
            i += 1
        if pending:
            t0 = time.monotonic()
            with span("fleet.step"):
                fleet.step()
            ticks.append(time.monotonic() - t0)
            depths.append(fleet.queue_depth)
            pending = [h for h in pending if not h.done]
        else:
            nxt = start + schedule[i][0] if i < len(schedule) else stop
            with span("bench.wait"):
                time.sleep(max(0.0, min(nxt, stop) - time.monotonic()))
    end = time.monotonic()
    deadline = end + drain_s
    while pending and time.monotonic() < deadline:
        fleet.step()
        pending = [h for h in pending if not h.done]
    return ServeRecord(start, end, offered, ticks, depths, late, not pending)
