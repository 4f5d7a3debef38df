"""Fault tolerance & straggler mitigation: watchdog, rewind-and-replay.

The same code as ``repro.runtime.fault_tolerance``.  The streaming worker
(``serving.worker.StreamWorker``) arms a :class:`StepWatchdog` around every
tick and runs each tick through :func:`retrying`.  Components:

  * ``StepWatchdog`` — a deadline timer armed per step; if a step exceeds
    ``deadline_s`` (hung collective, dead host) the registered callback
    fires (default: raise in the main thread via a flag the loop checks).
    At 1000+ nodes a hung all-reduce is the common failure mode; the
    watchdog converts it from a silent stall into a restartable failure.

  * ``StragglerDetector`` — ring buffer of per-step wall times; flags
    steps > mean + z*std.  On a real pod this feeds the scheduler
    (drop/replace the slow host); here it logs and counts, and the
    TrainingLoop exposes the stats.

  * ``retrying`` — wraps the step fn; on failure restores the latest
    checkpoint and replays (the data pipeline is a pure function of step,
    so replay is deterministic).  ``max_restarts`` bounds crash loops.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["StepWatchdog", "StragglerDetector", "StragglerStats",
           "RestartableFailure", "retrying"]


class RestartableFailure(RuntimeError):
    """A failure the loop should handle by restore-and-replay."""


class StepWatchdog:
    def __init__(self, deadline_s: float, on_timeout: Optional[Callable] = None,
                 counter=None):
        """``counter``: optional ``repro_torch.obs`` Counter (or any object with
        ``inc()``) bumped on every firing — lets a serving loop export
        watchdog timeouts without this module importing telemetry."""
        self.deadline_s = deadline_s
        self.on_timeout = on_timeout
        self.counter = counter
        self._timer: Optional[threading.Timer] = None
        self.timed_out = False
        self.timeouts = 0

    def _fire(self):
        self.timed_out = True
        self.timeouts += 1
        if self.counter is not None:
            self.counter.inc()
        if self.on_timeout:
            self.on_timeout()

    def arm(self):
        self.disarm()
        self.timed_out = False
        self._timer = threading.Timer(self.deadline_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def check(self):
        if self.timed_out:
            raise RestartableFailure(
                f"step exceeded watchdog deadline {self.deadline_s}s"
            )


@dataclasses.dataclass
class StragglerStats:
    flagged: int
    mean_s: float
    p95_s: float
    last_s: float


class StragglerDetector:
    def __init__(self, window: int = 64, z_thresh: float = 3.0, min_steps: int = 8):
        self.times = collections.deque(maxlen=window)
        self.z_thresh = z_thresh
        self.min_steps = min_steps
        self.flagged = 0

    def record(self, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.times) >= self.min_steps:
            arr = np.asarray(self.times)
            mu, sd = arr.mean(), arr.std() + 1e-9
            if seconds > mu + self.z_thresh * sd:
                is_straggler = True
                self.flagged += 1
        self.times.append(seconds)
        return is_straggler

    def stats(self) -> StragglerStats:
        arr = np.asarray(self.times) if self.times else np.zeros(1)
        return StragglerStats(
            flagged=self.flagged,
            mean_s=float(arr.mean()),
            p95_s=float(np.percentile(arr, 95)),
            last_s=float(arr[-1]),
        )


def retrying(step_fn, restore_fn, max_restarts: int = 3,
             on_restart: Optional[Callable] = None):
    """Wrap step_fn; on RestartableFailure restore state and retry.

    ``restore_fn`` is called with the failing call's arguments; if it
    returns a tuple, that replaces the positional args for the retry —
    a ``None`` return keeps them (stateful restore: the serving loop's
    restore_fn rewinds internal session state and retries the same tick).
    Any other exception type passes straight through: only failures
    explicitly marked restartable are retried.  ``wrapped.state``
    exposes the cumulative restart count.  ``on_restart`` (no args) is
    invoked after each successful restore — telemetry hook for counting
    rewinds without coupling this module to ``repro_torch.obs``.
    """
    state = {"restarts": 0}

    def wrapped(*args, **kwargs):
        while True:
            try:
                return step_fn(*args, **kwargs)
            except RestartableFailure:
                state["restarts"] += 1
                if state["restarts"] > max_restarts:
                    raise
                new_args = restore_fn(*args, **kwargs)
                if new_args is not None:
                    args = tuple(new_args)
                if on_restart is not None:
                    on_restart()

    wrapped.state = state
    return wrapped
