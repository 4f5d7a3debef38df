"""Whole-stream ``run_engine`` replayed as one CUDA graph per input shape.

A whole-stream call is ``init_state`` plus one ``run_chunk``: per timestep
and layer the nonzero counts, ``im2col``'s pad and copy, a B1 (or B2)
launch, the spike counts, the int8 cast and the pools, some 600-1,100
launches of small kernels a call.  Issued from Python, each costs more
host time than device time, so the card idles most of the call.

:class:`RunGraphs` captures that dispatch once per input shape as a
``torch.cuda.CUDAGraph`` and replays it on later calls.  The graph covers
everything from the event cast to the readout: every ``im2col``, kernel
launch, pool, count reduction and cast, with the same kernels, plans and
order as the eager path, so its integers are the eager path's bit for
bit.  What still runs eagerly around a replay: the copy of the events
into the graph's static input (one host-to-device copy for host events,
one device copy otherwise) and the clones of the three outputs.

* The graph pays only where a shape repeats.  The first call of a shape
  runs the eager path as before, which builds the kernels, opts them in to
  their shared memory and warms the allocator.  Its second call captures
  the graph on a side stream and replays it; so does every later call.
  Capture runs nothing, so :data:`kernels.LAUNCHES` does not count it;
  each replay adds the launches the capture recorded, and the counter
  advances per call as the eager path's does.
* A replay writes the graph's static outputs, so each call returns fresh
  clones: a result the caller holds is never overwritten by a later call.
* Replays and captures of one deployment hold a lock, and each replaying
  stream first waits on an event recorded after the previous replay's
  clones, so a replay from another thread or stream neither overwrites
  the input a running replay reads nor the outputs a clone has yet to
  copy.  An eager call holds the lock only to count itself.
* A graph that Python's cycle collector frees resets itself, which
  invalidates any capture then under way in the thread.  Capture runs with
  the collector paused, and nothing here holds a reference cycle, so a
  deployment's graphs go when its last reference does.
* At most :data:`MAX_GRAPHS` shapes are captured per deployment (a graph
  of the full-size optical-flow batch holds ~0.8 GB of intermediates) and
  kept for its life; once they are held, every other shape runs eagerly.
  A caller that cycles through many shapes so pays at most
  :data:`MAX_GRAPHS` captures, and otherwise the eager path's cost.

:func:`graphable` says when a deployment takes this path: its engine lies
on a CUDA device, runs the fused backend, and has no layer spread over
devices (``core_devs``).  The CPU, the plain backends and multi-device
plans stay eager.
"""
from __future__ import annotations

import gc
import threading

import torch

from ..kernels._build import add_launches, recording_launches
from ..obs import metrics as obs_metrics
from .inference import EngineOutput, SNNEngine, run_engine

__all__ = ["MAX_GRAPHS", "RunGraphs", "graphable"]

#: Input shapes one deployment captures; any further shape runs eagerly.
MAX_GRAPHS = 4
#: Shapes remembered as seen once, awaiting a second call, before a reset.
_MAX_SEEN = 64


def graphable(engine: SNNEngine) -> bool:
    """Does ``engine``'s whole-stream run replay as a CUDA graph?"""
    return (engine.device.type == "cuda" and engine.cfg.backend == "fused"
            and not any(el.core_devs for el in engine.layers))


class _Graph:
    """One captured shape: the graph, its static input and outputs, the
    launches it makes, and the event its last call's clones end with."""

    def __init__(self, graph, static_in, static_out, launches, done):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches
        self.done = done

    def replay(self, events: torch.Tensor) -> EngineOutput:
        with torch.cuda.device(self.static_in.device):
            stream = torch.cuda.current_stream()
            stream.wait_event(self.done)
            self.static_in.copy_(events)
            self.graph.replay()
            out = EngineOutput(*(t.clone() for t in self.static_out))
            self.done.record(stream)
        return out


def _capture(engine: SNNEngine, events: torch.Tensor, side) -> _Graph:
    """Capture ``run_engine`` on ``side`` at ``events``' shape and dtype.

    The shape has run eagerly before, which built the kernels, opted them
    in to their shared memory and warmed the allocator; capture runs
    nothing, so the caller replays the graph for this call's result.
    """
    static_in = torch.empty(events.shape, dtype=events.dtype, device=engine.device)
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with recording_launches() as launches:
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            out = run_engine(engine, static_in)
    done = torch.cuda.Event()
    done.record(side)
    static_out = (out.readout, out.spike_counts, out.input_counts)
    return _Graph(graph, static_in, static_out, dict(launches), done)


class RunGraphs:
    """One deployment's graphs, keyed by the events' shape, dtype and the
    device they run on: a shape is captured on its second call while fewer
    than :data:`MAX_GRAPHS` are held, and replayed from then on.

    ``eager`` and ``replays`` count the calls of each kind, ``captures``
    the graphs (the registry's ``spidr_run_graph_*_total`` counters, when
    metrics are on, count captures and replays process-wide).
    ``capture(engine, events)`` returns a graph with ``replay(events)`` and
    ``launches``; the default captures on the card, and the CPU tests pass
    a stand-in.
    """

    def __init__(self, engine: SNNEngine, capture=None):
        self.engine = engine
        self._capture = capture   # None: on the card (no bound method: no cycle)
        self._graphs: dict = {}
        self._seen: set = set()   # keys called once, not captured
        self._lock = threading.Lock()
        self._side = None
        self.captures = self.replays = self.eager = 0

    def _capture_cuda(self, events: torch.Tensor) -> _Graph:
        with torch.cuda.device(self.engine.device):
            if self._side is None:
                self._side = torch.cuda.Stream()
            return _capture(self.engine, events, self._side)

    def run(self, events: torch.Tensor) -> EngineOutput:
        """``run_engine(engine, events)``, from the shape's graph if it has one."""
        key = (tuple(events.shape), events.dtype, self.engine.device)
        reg = obs_metrics.default_registry()
        with self._lock:
            graph = self._graphs.get(key)
            if graph is None and key in self._seen and len(self._graphs) < MAX_GRAPHS:
                self._seen.discard(key)
                if len(self._graphs) + 1 == MAX_GRAPHS:
                    self._seen.clear()       # no shape is captured after this one
                collecting = gc.isenabled()
                gc.disable()
                try:
                    graph = (self._capture_cuda(events) if self._capture is None
                             else self._capture(self.engine, events))
                finally:
                    if collecting:
                        gc.enable()
                self._graphs[key] = graph
                self.captures += 1
                if reg:
                    reg.counter("spidr_run_graph_captures_total",
                                "CUDA graphs captured by CompiledSNN.run").inc()
            if graph is not None:
                out = graph.replay(events)
                add_launches(graph.launches)
                self.replays += 1
                if reg:
                    reg.counter("spidr_run_graph_replays_total",
                                "CompiledSNN.run calls replayed from a CUDA graph").inc()
                return out
            if len(self._graphs) < MAX_GRAPHS:
                if len(self._seen) >= _MAX_SEEN:
                    self._seen.clear()
                self._seen.add(key)
            self.eager += 1
        return run_engine(self.engine, events)
