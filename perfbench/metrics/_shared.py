"""Helpers the per-layer readers share (not a metric: no reader loads it by name)."""
from __future__ import annotations

import re
import statistics


def idle_share_pct(ctx):
    """Share of the traced window with no device operation running, in %."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def port_matcher(ctx, sources=None, names=None):
    """A predicate on a device operation's name: one of the program's kernels
    (of ``sources``' CUDA files, or named in ``names``)."""
    wanted = [k for src, ks in ctx.port_kernels.items()
              if sources is None or src in sources for k in ks]
    if names is not None:
        wanted = [k for k in wanted if k in names]
    if not wanted:
        return None
    pattern = re.compile(r"\b(?:" + "|".join(map(re.escape, wanted)) + r")\b")
    return lambda name: pattern.search(name) is not None


def samples_in_window(ctx) -> int:
    """Samples the whole window finished."""
    return len(ctx.record.calls) * ctx.traffic["batch"]


def fleet_tick_ms(ctx):
    """Median host ms of one ``Fleet.step`` inside the window, by the harness's clock."""
    if ctx.kind != "open_serve" or not ctx.record.ticks:
        return None
    return statistics.median(ctx.record.ticks) * 1e3
