"""Metrics registry: counters, gauges, and fixed-bucket histograms.

The same code as ``repro.obs.metrics``, so the Prometheus text and the JSON
dict equal the reference's for the same sequence of records.  Design
constraints:

* **Near-zero overhead when disabled.**  A disabled :class:`MetricsRegistry`
  is falsy, so every instrumentation site is written as

      if metrics:
          metrics.counter("spidr_stream_ticks_total").inc()

  and the disabled cost is a single truthiness check.

* **Chunking-invariant totals.**  Counters only ever accumulate *deltas*
  (spikes, timesteps, cycle increments), so the totals after a stream are
  identical for any ``chunk_T`` split — tested in
  ``tests/test_torch_streaming.py``.

* **Stable bucket edges.**  Histogram edges are pinned module constants
  (:data:`FRACTION_BUCKETS`, :data:`LATENCY_BUCKETS_S`); dashboards may
  depend on them, so changing an edge is a breaking change and is caught
  by the pinned-edge test.

The registry is deliberately not a Prometheus client: it is an in-process
aggregator whose state is exported on demand as Prometheus text exposition
format (``to_prometheus``) or JSON (``to_dict``).  There is no background
thread and no sockets; ``launch/serve.py --metrics-out`` dumps to a file.
"""
from __future__ import annotations

import json
import math
import pathlib
import threading
from typing import Dict, Iterable, Mapping, Optional, Tuple

__all__ = [
    "FRACTION_BUCKETS",
    "LATENCY_BUCKETS_S",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "set_default_registry",
    "enable_metrics",
    "disable_metrics",
    "metrics_enabled",
]

# Pinned bucket edges.  FRACTION_BUCKETS covers [0, 1] quantities (spike
# sparsity, nonzero-tile fraction, occupancy); LATENCY_BUCKETS_S covers
# wall-clock seconds (serve tick latency, snapshot duration).  Tests pin
# these tuples exactly — see test_histogram_bucket_edges_stable.
FRACTION_BUCKETS: Tuple[float, ...] = (
    0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99, 1.0,
)
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

LabelPairs = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Mapping[str, object]]) -> LabelPairs:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_labels(pairs: LabelPairs, extra: str = "") -> str:
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    if extra:
        body = f"{body},{extra}" if body else extra
    return "{" + body + "}" if body else ""


class Counter:
    """Monotonically increasing float counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        self.value += amount


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Fixed-bucket histogram with Prometheus cumulative-bucket semantics.

    ``edges`` are the inclusive upper bounds of the finite buckets; an
    implicit ``+Inf`` bucket catches the overflow.  Edges are pinned at
    construction and never change afterwards.
    """

    __slots__ = ("edges", "bucket_counts", "total", "count")

    def __init__(self, edges: Iterable[float]) -> None:
        edges = tuple(float(e) for e in edges)
        if not edges or list(edges) != sorted(edges):
            raise ValueError(f"histogram edges must be ascending, got {edges}")
        self.edges = edges
        self.bucket_counts = [0] * (len(edges) + 1)  # +1 for +Inf
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        if math.isnan(value):
            return
        lo, hi = 0, len(self.edges)
        while lo < hi:  # first edge >= value (bisect_left on upper bounds)
            mid = (lo + hi) // 2
            if self.edges[mid] < value:
                lo = mid + 1
            else:
                hi = mid
        self.bucket_counts[lo] += 1
        self.total += value
        self.count += 1

    def cumulative(self) -> list:
        """Cumulative counts per bucket, Prometheus-style (ends at count)."""
        out, acc = [], 0
        for c in self.bucket_counts:
            acc += c
            out.append(acc)
        return out


class MetricsRegistry:
    """Named metric store.  Truthiness == enabled.

    Instrumentation sites hold a reference to a registry and guard every
    record with ``if metrics:``; a disabled registry therefore costs one
    ``__bool__`` call per site.  Metric objects are created lazily on
    first use and keyed by ``(name, sorted(labels))``.
    """

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        # name -> (kind, help)
        self._families: Dict[str, Tuple[str, str]] = {}
        # (name, label_pairs) -> metric object
        self._metrics: Dict[Tuple[str, LabelPairs], object] = {}

    def __bool__(self) -> bool:
        return self.enabled

    # -- metric accessors ------------------------------------------------
    def _get(self, kind: str, name: str, help: str,
             labels: Optional[Mapping[str, object]], factory):
        known = self._families.get(name)
        if known is not None and known[0] != kind:
            # Checked on the lock-free fast path too: a name collision must
            # never hand a Counter to a site that asked for a Gauge.
            raise ValueError(
                f"metric {name!r} already registered as {known[0]}, "
                f"cannot re-register as {kind}"
            )
        key = (name, _label_key(labels))
        metric = self._metrics.get(key)
        if metric is not None:
            return metric
        with self._lock:
            metric = self._metrics.get(key)
            if metric is None:
                known = self._families.get(name)
                if known is not None and known[0] != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {known[0]}, "
                        f"cannot re-register as {kind}"
                    )
                self._families.setdefault(name, (kind, help))
                metric = factory()
                self._metrics[key] = metric
        return metric

    def counter(self, name: str, help: str = "",
                labels: Optional[Mapping[str, object]] = None) -> Counter:
        return self._get("counter", name, help, labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Mapping[str, object]] = None) -> Gauge:
        return self._get("gauge", name, help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Mapping[str, object]] = None,
                  edges: Iterable[float] = FRACTION_BUCKETS) -> Histogram:
        return self._get("histogram", name, help, labels,
                         lambda: Histogram(edges))

    # -- export ----------------------------------------------------------
    def _sorted_items(self):
        return sorted(self._metrics.items(), key=lambda kv: kv[0])

    def to_prometheus(self) -> str:
        """Render as Prometheus text exposition format (version 0.0.4)."""
        lines, seen = [], set()
        for (name, pairs), metric in self._sorted_items():
            kind, help = self._families[name]
            if name not in seen:
                seen.add(name)
                if help:
                    lines.append(f"# HELP {name} {help}")
                lines.append(f"# TYPE {name} {kind}")
            if isinstance(metric, Histogram):
                cum = metric.cumulative()
                for edge, acc in zip(metric.edges, cum):
                    le = _format_labels(pairs, f'le="{edge:g}"')
                    lines.append(f"{name}_bucket{le} {acc}")
                le = _format_labels(pairs, 'le="+Inf"')
                lines.append(f"{name}_bucket{le} {cum[-1]}")
                lbl = _format_labels(pairs)
                lines.append(f"{name}_sum{lbl} {metric.total:g}")
                lines.append(f"{name}_count{lbl} {metric.count}")
            else:
                lines.append(f"{name}{_format_labels(pairs)} {metric.value:g}")
        return "\n".join(lines) + "\n" if lines else ""

    def to_dict(self) -> dict:
        """JSON-friendly dump: {name: [{labels, ...payload}]}."""
        out: Dict[str, list] = {}
        for (name, pairs), metric in self._sorted_items():
            kind, _help = self._families[name]
            entry: dict = {"labels": dict(pairs), "kind": kind}
            if isinstance(metric, Histogram):
                entry["buckets"] = {
                    "edges": list(metric.edges),
                    "counts": list(metric.bucket_counts),
                }
                entry["sum"] = metric.total
                entry["count"] = metric.count
            else:
                entry["value"] = metric.value
            out.setdefault(name, []).append(entry)
        return out

    def write(self, path) -> pathlib.Path:
        """Write a dump to ``path``: ``.json`` -> JSON, else Prometheus text."""
        path = pathlib.Path(path)
        if path.suffix == ".json":
            path.write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True))
        else:
            path.write_text(self.to_prometheus())
        return path

    def clear(self) -> None:
        with self._lock:
            self._families.clear()
            self._metrics.clear()


# -- process-wide default registry ---------------------------------------
# Disabled by default: importing repro_torch must not make the engine pay for
# telemetry.  ``enable_metrics()`` flips the same object that every already
# constructed StreamSessionManager holds, so enabling is retroactive.
_default = MetricsRegistry(enabled=False)


def default_registry() -> MetricsRegistry:
    return _default


def set_default_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _default
    _default = registry
    return _default


def enable_metrics() -> MetricsRegistry:
    _default.enabled = True
    return _default


def disable_metrics() -> MetricsRegistry:
    _default.enabled = False
    return _default


def metrics_enabled() -> bool:
    return _default.enabled
