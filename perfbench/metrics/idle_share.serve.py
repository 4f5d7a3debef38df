"""idle_share.serve: share of the traced window in which no kernel, copy or
set ran on the device, serve cells held to streams_per_s (%)."""
from perfbench.metrics._shared import idle_share_pct


def read(ctx):
    return idle_share_pct(ctx) if ctx.kind == "open_serve" else None
