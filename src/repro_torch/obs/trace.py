"""Span tracer emitting Chrome-trace / Perfetto JSON.

The same code as ``repro.obs.trace``.

A :class:`Tracer` records complete-duration events (``ph: "X"``) from
``with tracer.span("name", key=value):`` blocks and instant events from
``tracer.instant(...)``.  ``export(path)`` writes the standard trace-event
envelope ``{"traceEvents": [...]}`` which loads directly in
https://ui.perfetto.dev or ``chrome://tracing``.

Conventions:

* timestamps are microseconds from the tracer's construction, taken from
  ``time.perf_counter_ns`` (monotonic); ``export`` sorts events by ``ts``
  so the emitted stream is non-decreasing even with nested spans (a parent
  span is *recorded* after its children finish but *starts* before them);
* ``pid`` is the OS pid, ``tid`` is a stable small integer per Python
  thread (thread names are emitted as ``thread_name`` metadata);
* a disabled tracer hands back a shared no-op context manager, so the
  disabled cost of a span site is one truthiness check plus one attribute
  call.

The tracer is intentionally unbounded: it is meant for bounded runs
(compile, a serve session, an upgrade drill), not always-on production
capture.  ``max_events`` provides a safety valve — past it, new events are
dropped and ``dropped_events`` counts them.
"""
from __future__ import annotations

import json
import os
import pathlib
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = [
    "Tracer",
    "default_tracer",
    "set_default_tracer",
    "enable_tracing",
    "disable_tracing",
    "tracing_enabled",
]


class _NullSpan:
    """Shared no-op context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    def __init__(self, enabled: bool = True, max_events: int = 1_000_000):
        self.enabled = bool(enabled)
        self.max_events = int(max_events)
        self.dropped_events = 0
        self.events: List[dict] = []
        self._lock = threading.Lock()
        self._t0_ns = time.perf_counter_ns()
        self._tids: Dict[int, int] = {}

    def __bool__(self) -> bool:
        return self.enabled

    # -- internals -------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0_ns) / 1000.0

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _emit(self, event: dict) -> None:
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped_events += 1
                return
            self.events.append(event)

    # -- recording -------------------------------------------------------
    @contextmanager
    def _span(self, name: str, cat: str, args: dict):
        t0 = self._now_us()
        try:
            yield self
        finally:
            t1 = self._now_us()
            ev = {
                "name": name,
                "cat": cat,
                "ph": "X",
                "ts": t0,
                "dur": max(t1 - t0, 0.0),
                "pid": os.getpid(),
                "tid": self._tid(),
            }
            if args:
                ev["args"] = args
            self._emit(ev)

    def span(self, name: str, cat: str = "spidr", **args):
        """Context manager recording a complete (``ph: "X"``) event."""
        if not self.enabled:
            return _NULL_SPAN
        return self._span(name, cat, args)

    def instant(self, name: str, cat: str = "spidr", **args) -> None:
        """Record an instant (``ph: "i"``) event at the current time."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",
            "ts": self._now_us(),
            "pid": os.getpid(),
            "tid": self._tid(),
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    # -- export ----------------------------------------------------------
    def to_chrome(self, extra_events: Optional[List[dict]] = None) -> dict:
        """Build the Chrome-trace envelope (events sorted by ``ts``)."""
        with self._lock:
            events = list(self.events)
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": os.getpid(),
                "tid": tid,
                "args": {"name": f"py-thread-{tid}" if tid else "main"},
            }
            for tid in sorted(self._tids.values())
        ]
        if extra_events:
            events = events + list(extra_events)
        events.sort(key=lambda e: e.get("ts", 0.0))
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
        }

    def export(self, path, extra_events: Optional[List[dict]] = None
               ) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(json.dumps(self.to_chrome(extra_events)))
        return path

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.dropped_events = 0


# -- process-wide default tracer (disabled by default) --------------------
_default = Tracer(enabled=False)


def default_tracer() -> Tracer:
    return _default


def set_default_tracer(tracer: Tracer) -> Tracer:
    global _default
    _default = tracer
    return _default


def enable_tracing() -> Tracer:
    _default.enabled = True
    return _default


def disable_tracing() -> Tracer:
    _default.enabled = False
    return _default


def tracing_enabled() -> bool:
    return _default.enabled
