"""Observability: the multi-core pipeline timeline as a Chrome trace.

Only ``timeline`` is ported so far; the metrics registry, span tracer and
logs of ``repro.obs`` come with serving's telemetry (ROADMAP A9).
"""
from .timeline import (busy_cycle_totals, export_timeline, multicore_timeline,
                       write_chrome_trace)

__all__ = ["busy_cycle_totals", "export_timeline", "multicore_timeline",
           "write_chrome_trace"]
