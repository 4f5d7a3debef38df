"""fleet_tick_ms.capacity: as fleet_tick_ms.serve, in serve cells offered
more than the fleet can take and judged on the stream steps it finishes."""
from perfbench.metrics._shared import fleet_tick_ms


def read(ctx):
    return fleet_tick_ms(ctx)
