"""Serving telemetry: metrics, span tracing, pipeline timelines, logs.

The reference's ``repro.obs``, ported whole (pure Python, no device code):

* :mod:`repro_torch.obs.metrics` — in-process counters/gauges/histograms
  with Prometheus-text and JSON export; the process-wide default registry
  is **disabled by default** and costs one truthiness check per site when
  off.
* :mod:`repro_torch.obs.trace` — context-manager span tracer emitting
  Chrome-trace/Perfetto JSON (per-tick ``serve.tick``/``run_chunk``,
  ``snapshot.save``/``snapshot.restore``).
* :mod:`repro_torch.obs.timeline` — renders the simulated per-core async
  pipeline clocks of ``estimate_multicore_cost`` in the same format.
* :mod:`repro_torch.obs.logs` — structured logging with a per-stream
  request id on every record.

Quick start::

    from repro_torch import obs
    obs.enable_metrics(); obs.enable_tracing()
    ...  # compile / serve as usual
    print(obs.default_registry().to_prometheus())
    obs.default_tracer().export("trace.json")
"""
from . import logs, metrics, timeline, trace  # noqa: F401
from .logs import logging_setup, request_context
from .metrics import (
    MetricsRegistry, default_registry, disable_metrics, enable_metrics,
    metrics_enabled, set_default_registry,
)
from .timeline import (busy_cycle_totals, export_timeline, multicore_timeline,
                       write_chrome_trace)
from .trace import (
    Tracer, default_tracer, disable_tracing, enable_tracing,
    set_default_tracer, tracing_enabled,
)

__all__ = [
    "logs", "metrics", "timeline", "trace",
    "logging_setup", "request_context",
    "MetricsRegistry", "default_registry", "set_default_registry",
    "enable_metrics", "disable_metrics", "metrics_enabled",
    "Tracer", "default_tracer", "set_default_tracer",
    "enable_tracing", "disable_tracing", "tracing_enabled",
    "multicore_timeline", "busy_cycle_totals", "export_timeline",
    "write_chrome_trace",
]
