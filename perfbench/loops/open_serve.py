"""open_serve: independent cameras in an open loop on a ``spidr.serve`` fleet.

Set-up deploys the configuration, warms up the tick's one shape with a
fleet that is then gone, starts the window's fleet, and freezes what it
made out of the cycle collector's reach: the window keeps a record of every
stream it offers, and as those pile up the collector's full passes, which
would scan every object of torch, the program and the set-up each time,
stall ticks for 100-200 ms, most in the window's last seconds.  The window
offers the schedule's streams at their due times, ticking the fleet
whenever it holds work, then stops arrivals and drains.  Times on the
host's monotonic clock (the clock the program stamps a stream's
``done_at`` with), and marks the calls into the program with the
benchmark's spans, which cost nothing unless the run is traced.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

from perfbench.harness import port, stats


@dataclasses.dataclass
class ServeRecord:
    start: float                  # window start (monotonic s); dues are offsets from it
    end: float                    # window end: arrivals stop
    offered: list                 # (due offset, clip, length, handle or None if shed)
    ticks: list                   # host seconds of each Fleet.step inside the window
    depths: list                  # queue depth after each window tick
    late: list                    # submit time minus due time, per offered stream
    drained: bool                 # every admitted stream finished within the drain time


def setup_serve(config: dict, mix: dict, params: list, clips_host, dev):
    """The deployment, warmed up on the tick's one shape by a fleet that is then gone."""
    compiled = port.deploy(config, params, dev)
    warm = port.serve(compiled, mix)
    for i in range(mix["capacity"]):
        warm.submit(clips_host[i % mix["pool"], :min(mix["lengths"])])
    warm.drain()
    warm.shutdown()
    return compiled


def setup(ctx, params: list, dev) -> None:
    ctx.compiled = setup_serve(ctx.config, ctx.traffic, params, ctx.clips_host, dev)
    ctx.fleet = port.serve(ctx.compiled, ctx.traffic)
    gc.collect()
    gc.freeze()


def window(ctx, seconds: float, span) -> ServeRecord:
    return drive(ctx.fleet, ctx.clips_host, ctx.schedule, seconds, span, port.overloaded())


def drive(fleet, clips_host, schedule: list, seconds: float, span, overloaded,
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


def free(ctx) -> None:
    gc.unfreeze()                 # so that the collector can free the program's state
    ctx.fleet.shutdown()
    ctx.fleet = ctx.compiled = None


def answers(ctx) -> tuple:
    """``(answers for checks/open_serve.py, attempted, failed)``: a stream shed
    or never finished is failed."""
    offered = ctx.record.offered
    streams = [(clip, length, None if h is None or not h.done else h.readout,
                None if h is None or not h.done else h.request.spikes)
               for _, clip, length, h in offered if h is not None]
    failed = sum(1 for *_, h in offered if h is None or not h.done)
    return streams, len(offered), failed


def end_to_end(rec: ServeRecord, mix: dict) -> dict:
    """A serve cell's tail is over every stream offered: one shed, or admitted
    and never finished, counts as infinitely late, so shedding cannot shorten
    it.  Rates are over the span from the first due time to the last
    completion."""
    lat = [h.request.done_at - (rec.start + due) if h is not None and h.done else math.inf
           for due, _, _, h in rec.offered]
    done = [(length, h.request.done_at) for _, _, length, h in rec.offered
            if h is not None and h.done]
    values = {}
    if lat:
        values["stream_ms_p95"] = stats.percentile(lat, 95) * 1e3
    if done:
        span = max(t for _, t in done) - (rec.start + rec.offered[0][0])
        values["streams_per_s"] = len(done) / span
        values["stream_steps_per_s"] = sum(length for length, _ in done) / span
    return values
