"""fleet_tick_ms.serve: median host milliseconds of one Fleet.step inside the
window (place, every replica's StreamWorker.step with its rewind mark,
collect), by the benchmark's own clock around each call; serve cells
held to streams_per_s."""
from perfbench.metrics._shared import fleet_tick_ms


def read(ctx):
    return fleet_tick_ms(ctx)
