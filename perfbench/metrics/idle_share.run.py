"""idle_share.run: share of the traced window in which no kernel, copy or
set ran on the device, closed-loop CompiledSNN.run cells (%)."""
from perfbench.metrics._shared import idle_share_pct


def read(ctx):
    return idle_share_pct(ctx) if ctx.kind == "closed_run" else None
