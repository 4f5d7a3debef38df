"""The traced run: the device's timeline from ``torch.profiler``, the host's
from the benchmark's own spans, reduced once.

A traced run's window is ``TRACE_SECONDS`` at most (stopping the profiler
and reading its events take about eight seconds for each second traced of
a busy cell, so a whole window would not fit a run's time); the profiler
starts before the window, since its start takes seconds.  It records the
device only (kernels, copies, sets, and the CUDA
runtime calls that issue them): recording every host operation as well
costs a few microseconds each and would slow a host-bound cell by a third,
so the host's side comes from the benchmark's own spans instead, taken on
the wall clock the profiler stamps its events with.  The spans mark the
traced window (``bench.window``), the calls into the program (``compiled.run``,
``readout.to_host``, ``fleet.submit``, ``fleet.step``) and the harness's
own waiting (``bench.wait``).  From them this module works out:

* ``busy_s``: the union of device-operation intervals inside the window;
* ``window_s``: the window span's length;
* the device operations that took most time, by name;
* the longest idle gaps inside the window, each labelled by the innermost
  benchmark span and the CUDA runtime call under way at its middle.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

CUDA = torch.autograd.DeviceType.CUDA
TRACE_SECONDS = 10.0
SPANS = ("bench.window", "bench.wait", "compiled.run", "readout.to_host",
         "fleet.submit", "fleet.step")
NAME_CHARS = 160


class Spans:
    """The benchmark's host spans on the wall clock (ns), kept in memory
    between :meth:`start` and :meth:`stop` (the traced window)."""

    def __init__(self):
        self.by_name = {name: [] for name in SPANS}
        self.active = False

    def start(self) -> None:
        self.active, self._t0 = True, time.time_ns()

    def stop(self) -> None:
        if self.active:
            self.by_name["bench.window"].append((self._t0, time.time_ns()))
            self.active = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.active:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            self.by_name[name].append((start, time.time_ns()))


def annotate(spans):
    """``spans`` under a trace, else a no-op context."""
    if spans is not None:
        return spans
    return lambda name: contextlib.nullcontext()


def profiler():
    """The device's activity; the host's where there is no card (a CPU test)."""
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[act.CUDA if torch.cuda.is_available() else act.CPU],
        record_shapes=False, with_stack=False, profile_memory=False)


@dataclasses.dataclass
class Trace:
    window: tuple                 # (start ns, end ns) of bench.window
    device_ops: list              # (start ns, end ns, name), in start order, cut to the window
    profiled: list                # every device operation the profiler saw, in start order
    spans: dict                   # span name -> [(start ns, end ns)] in start order
    busy_s: float
    gaps: list                    # (length ns, start ns, end ns), longest first
    labels: list                  # a label per gap

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def device_breakdown(self, n: int = 10) -> list:
        total = {}
        for s, e, name in self.device_ops:
            total[name] = total.get(name, 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def gap_breakdown(self, n: int = 10) -> list:
        return [[label, g[0] / 1e9] for g, label in zip(self.gaps[:n], self.labels[:n])]


def _events(prof):
    kr = getattr(prof.profiler, "kineto_results", None)
    if kr is None:
        raise RuntimeError("the profiler kept no kineto results")
    return kr.events()


def reduce(prof, recorded: Spans, n_gaps: int = 10) -> Trace:
    events = _events(prof)
    spans = {name: sorted(iv) for name, iv in recorded.by_name.items()}
    profiled = sorted((e.start_ns(), e.end_ns(), e.name()[:NAME_CHARS]) for e in events
                      if e.device_type() == CUDA)
    if not spans["bench.window"]:
        raise RuntimeError("the trace holds no bench.window span")
    w0, w1 = spans["bench.window"][0]
    device = [(max(s, w0), min(e, w1), n) for s, e, n in profiled if e > w0 and s < w1]
    busy, gaps, cur_s, cur_e = 0, [], None, w0
    for s, e, _ in device:
        if s > cur_e:
            gaps.append((s - cur_e, cur_e, s))
            if cur_s is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_s = s if cur_s is None else cur_s
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((w1 - cur_e, cur_e, w1))
    gaps.sort(reverse=True)
    top = gaps[:n_gaps]
    mids = [(g[1] + g[2]) // 2 for g in top]
    ops = _runtime_calls_at(events, mids)
    labels = [_label(t, spans, ops.get(t)) for t in mids]
    return Trace((w0, w1), device, profiled, spans, busy / 1e9, gaps, labels)


def _runtime_calls_at(events, times: list) -> dict:
    """``{t: name}`` of the innermost host-side event (a CUDA runtime call)
    under way at each ``t``."""
    order = sorted(times)
    best = {}
    for e in events:
        if e.device_type() == CUDA:
            continue
        s, end = e.start_ns(), e.end_ns()
        i = bisect.bisect_left(order, s)
        while i < len(order) and order[i] <= end:
            t = order[i]
            if t not in best or end - s < best[t][0]:
                best[t] = (end - s, e.name()[:NAME_CHARS])
            i += 1
    return {t: name for t, (_, name) in best.items()}


def _innermost(intervals, t):
    best = None
    for s, e in intervals:
        if s > t:
            break
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e)
    return best


def _label(t: int, spans: dict, op) -> str:
    span, width = "harness", None
    for name, iv in spans.items():
        if name == "bench.window":
            continue
        hit = _innermost(iv, t)
        if hit is not None and (width is None or hit[1] - hit[0] < width):
            span, width = name, hit[1] - hit[0]
    return span if op is None else f"{span}:{op}"
