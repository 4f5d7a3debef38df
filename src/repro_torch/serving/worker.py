"""Serving workers: one deployment, one queue, one tick loop.

The two SNN serving modes, on one shared submit/queue/result base:

  * :class:`BatchWorker` — whole-stream batched inference: waiting
    requests are packed into a fixed ``(T, capacity, H, W, C)`` batch and
    one ``CompiledSNN.run`` serves them all;
  * :class:`StreamWorker` — stateful continuous batching over persistent
    Vmem: a bank of ``capacity`` session slots, each holding one live
    stream's neuron state, advanced ``chunk_T`` timesteps per tick in one
    fixed-shape ``run_chunk``, with watchdog + rewind-and-replay fault
    tolerance and snapshot/restore durability.

The counterparts of ``repro.serving.worker``'s, telemetry included (the
process-wide ``repro_torch.obs`` registry and tracer, off by default).
Both expose the scheduler's view of a worker (``busy``, ``free_capacity``,
``inflight``) and the ``device`` they run on, which the fleet
(``spidr.serve``, :mod:`repro_torch.serving.fleet`) drives them through.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..obs.logs import request_context
from ..runtime.fault_tolerance import RestartableFailure, StepWatchdog, retrying

__all__ = ["BatchWorker", "StreamRequest", "StreamWorker"]

log = logging.getLogger("repro_torch.serving")


@dataclasses.dataclass
class StreamRequest:
    """One DVS event stream moving through the serving tier."""

    rid: int
    events: np.ndarray                     # (T, H, W, C) binary event frames
    readout: Optional[np.ndarray] = None   # filled on completion
    submitted_at: float = 0.0
    done_at: Optional[float] = None
    # Streaming-path extras: progress + cumulative chip cost for this stream.
    cursor: int = 0                        # timesteps delivered so far
    first_reply_at: Optional[float] = None
    cycles: int = 0
    energy_uj: float = 0.0
    spikes: int = 0                        # cumulative output spikes, all layers
    # Concatenated per-chunk input-spike counts (T_so_far, n_layers), only
    # when the worker collects chunk counts for the per-stream pipeline
    # timeline (``--trace-out`` on a multi-core plan).
    input_counts: Optional[np.ndarray] = None


class _WorkerBase:
    """Shared submit/queue/result plumbing of both serving modes.

    Lifecycle: :meth:`submit` after :meth:`shutdown` raises
    ``RuntimeError``; :meth:`shutdown` itself is idempotent.
    """

    def __init__(self, compiled):
        self.compiled = compiled
        self.waiting: list = []
        self.done: list = []
        self._closed = False
        self._metrics = obs.default_registry()

    @property
    def closed(self) -> bool:
        return self._closed

    def submit(self, req: StreamRequest) -> None:
        if self._closed:
            raise RuntimeError("worker is shut down — submit() after "
                               "shutdown() is an error")
        if not req.submitted_at:
            req.submitted_at = time.monotonic()
        self.waiting.append(req)

    def shutdown(self) -> None:
        """Stop accepting work (idempotent); results stay on ``done``."""
        self._closed = True

    def _require_live(self) -> None:
        if self._closed:
            raise RuntimeError(
                "worker is shut down — step() after shutdown() is an error")

    # Scheduler interface --------------------------------------------------
    @property
    def busy(self) -> bool:
        """True while the worker holds unfinished work."""
        return bool(self.waiting)

    def free_capacity(self) -> int:
        """Streams the scheduler may place here before the next tick."""
        raise NotImplementedError

    def inflight(self) -> list:
        """Every accepted-but-unfinished request (crash re-placement)."""
        return list(self.waiting)


class BatchWorker(_WorkerBase):
    """Fixed-capacity batched SNN inference worker.

    Waiting requests are packed into a fixed (T, capacity, H, W, C) batch —
    idle slots carry zero events, which the zero-skipping kernels make
    nearly free — and one ``CompiledSNN.run`` serves the whole batch.
    """

    def __init__(self, compiled, capacity: int = 4):
        super().__init__(compiled)
        self.capacity = capacity
        # Per-timestep, per-layer spike statistics summed over every batch.
        self.total_input_counts = None
        self.total_spike_counts = None
        self.batches = 0

    @property
    def device(self) -> torch.device:
        return self.compiled.device

    def free_capacity(self) -> int:
        return max(0, self.capacity - len(self.waiting))

    def step(self) -> bool:
        """Serve up to ``capacity`` waiting requests in one batch."""
        self._require_live()
        if not self.waiting:
            return False
        t0 = time.monotonic()
        batch = self.waiting[: self.capacity]
        self.waiting = self.waiting[self.capacity:]
        first = np.asarray(batch[0].events)
        ev = np.zeros((first.shape[0], self.capacity) + first.shape[1:], np.float32)
        for i, req in enumerate(batch):
            ev[:, i] = req.events
        out = self.compiled.run(torch.from_numpy(ev))
        readout = out.readout.cpu().numpy()
        now = time.monotonic()
        for i, req in enumerate(batch):
            req.readout = readout[i]
            req.done_at = now
            self.done.append(req)
        counts_in = out.input_counts.cpu().numpy()
        counts_out = out.spike_counts.cpu().numpy()
        if self.total_input_counts is None:
            self.total_input_counts, self.total_spike_counts = counts_in, counts_out
        else:
            self.total_input_counts = self.total_input_counts + counts_in
            self.total_spike_counts = self.total_spike_counts + counts_out
        self.batches += 1
        if self._metrics:
            reg = self._metrics
            reg.counter("spidr_serve_batches_total",
                        "Whole-stream batches served").inc()
            reg.histogram("spidr_serve_batch_seconds",
                          "Whole-stream batch wall latency",
                          edges=obs.metrics.LATENCY_BUCKETS_S
                          ).observe(time.monotonic() - t0)
            reg.gauge("spidr_serve_queue_depth",
                      "Requests waiting for a slot").set(len(self.waiting))
        return True


class StreamWorker(_WorkerBase):
    """Stateful continuous-batching worker over persistent Vmem sessions.

    A fixed bank of ``capacity`` slots, each holding one live stream's
    neuron state inside a ``CompiledSNN.open_stream()`` session; every
    ``step()`` delivers each live stream's next ``chunk_T`` event frames
    and advances all slots in one fixed-shape ``run_chunk`` on the card.
    Finished streams retire and free their slot for the next waiter.

    Durability (``runtime.fault_tolerance`` + ``CompiledSNN.snapshot``):

      * ``watchdog_s`` arms a :class:`StepWatchdog` around every session
        step — a hung tick becomes a :class:`RestartableFailure`;
      * every tick runs through ``retrying``: a poisoned tick rewinds the
        session (and all request cursors) to the last completed tick and
        replays, up to ``max_restarts`` times.  The rewind point is a full
        ``state_dict`` (a host copy of every slot's state) taken before
        every tick;
      * ``snapshot_dir``/``snapshot_every`` persist the full serving state
        (weights, session slots, stream-id/cursor table, finished results)
        every N ticks; :meth:`restore` resumes it in a fresh process,
        bit-exactly (``tools/upgrade_drill_torch.py`` SIGKILLs a serving
        process mid-tick and checks that no stream loses state).

    ``device`` places the session on another device than the deployment's:
    the worker then runs the deployment's engine copied to that device
    (``CompiledSNN.open_stream(device=...)``), as a fleet replica does.
    """

    def __init__(self, compiled, capacity: int = 4, chunk_T: int = 2, *,
                 watchdog_s: Optional[float] = None, max_restarts: int = 3,
                 snapshot_dir: Optional[str] = None, snapshot_every: int = 0,
                 fail_at_tick: Optional[int] = None, _session=None,
                 collect_chunk_counts: bool = False, device=None):
        super().__init__(compiled)
        self.sessions = (_session if _session is not None
                         else compiled.open_stream(
                             capacity=capacity, chunk_T=chunk_T,
                             collect_chunk_counts=collect_chunk_counts,
                             device=device))
        self.chunk_T = self.sessions.chunk_T
        self.slots: dict = {}          # slot -> StreamRequest
        self.ticks = 0
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self._tracer = obs.default_tracer()
        # Fault injection for tests and drills: raise RestartableFailure
        # once, mid-tick (after the session stepped, before bookkeeping) —
        # the worst case the rewind has to undo.  ``mid_tick_hook`` is the
        # general form (the upgrade drill SIGKILLs the process from it).
        self.fail_at_tick = fail_at_tick
        self.mid_tick_hook = None
        self._watchdog = (StepWatchdog(
            watchdog_s,
            counter=self._metrics.counter(
                "spidr_serve_watchdog_timeouts_total",
                "Watchdog deadline firings") if self._metrics else None)
            if watchdog_s is not None else None)
        self._rewind_point = None
        self._step = retrying(self._tick, self._rewind,
                              max_restarts=max_restarts,
                              on_restart=self._count_rewind)
        self._mark()

    def _count_rewind(self) -> None:
        if self._metrics:
            self._metrics.counter(
                "spidr_serve_rewinds_total",
                "Rewind-and-replay recoveries").inc()

    @property
    def restarts(self) -> int:
        """Rewind-and-replay count since the worker started."""
        return self._step.state["restarts"]

    @property
    def device(self) -> torch.device:
        """The device the worker's session (and engine copy) lives on."""
        return self.sessions.device

    @property
    def busy(self) -> bool:
        return bool(self.slots or self.waiting)

    def free_capacity(self) -> int:
        return max(0, self.sessions.capacity - self.sessions.occupancy
                   - len(self.waiting))

    def inflight(self) -> list:
        return list(self.slots.values()) + list(self.waiting)

    def shutdown(self) -> None:
        """Stop accepting work and retire the session (idempotent)."""
        super().shutdown()
        self.sessions.close()

    def _admit(self) -> None:
        while self.waiting:
            slot = self.sessions.open()
            if slot is None:
                # Admission deferred: every waiter stays queued this tick.
                if self._metrics:
                    self._metrics.counter(
                        "spidr_serve_rejections_total",
                        "Ticks on which waiting streams found no free slot"
                    ).inc()
                return
            req = self.waiting.pop(0)
            self.slots[slot] = req
            if self._metrics:
                self._metrics.counter(
                    "spidr_serve_admissions_total",
                    "Streams admitted into a session slot").inc()
            with request_context(req.rid):
                log.debug("admitted stream %d into slot %d", req.rid, slot)

    # -- fault tolerance: rewind-and-replay --------------------------------
    def _mark(self) -> None:
        """Record the last-completed-tick state the next rewind returns to.

        The session part is a host ``state_dict`` (never aliases live
        tensors); the request part saves each request's mutable progress
        fields, so the same objects callers hold are rolled back.
        """
        reqs = list(self.slots.values()) + self.waiting + self.done
        self._rewind_point = {
            "session": self.sessions.state_dict(),
            "slots": dict(self.slots),
            "waiting": list(self.waiting),
            "done": list(self.done),
            "ticks": self.ticks,
            "reqs": [(r, r.cursor, r.readout, r.cycles, r.energy_uj,
                      r.spikes, r.first_reply_at, r.done_at, r.input_counts)
                     for r in reqs],
        }

    def _rewind(self, *args, **kwargs) -> None:
        cp = self._rewind_point
        self.sessions.load_state_dict(cp["session"])
        self.slots = dict(cp["slots"])
        self.waiting = list(cp["waiting"])
        self.done = list(cp["done"])
        self.ticks = cp["ticks"]
        for r, cur, ro, cyc, uj, sp, fr, da, ic in cp["reqs"]:
            r.cursor, r.readout, r.cycles, r.energy_uj = cur, ro, cyc, uj
            r.spikes, r.first_reply_at, r.done_at, r.input_counts = sp, fr, da, ic
        log.info("rewound to tick %d and replaying", self.ticks)

    def _tick(self) -> bool:
        self._admit()
        if not self.slots:
            return False
        chunks = {slot: req.events[req.cursor:req.cursor + self.chunk_T]
                  for slot, req in self.slots.items()}
        if self._watchdog is not None:
            self._watchdog.arm()
        try:
            updates = self.sessions.step(chunks)
        finally:
            if self._watchdog is not None:
                self._watchdog.disarm()
        if self._watchdog is not None:
            self._watchdog.check()
        if self.mid_tick_hook is not None:
            self.mid_tick_hook(self.ticks + 1)
        if self.fail_at_tick is not None and self.ticks + 1 >= self.fail_at_tick:
            self.fail_at_tick = None
            raise RestartableFailure(
                f"injected fault at tick {self.ticks + 1}")
        now = time.monotonic()
        for slot, up in updates.items():
            req = self.slots[slot]
            req.cursor += chunks[slot].shape[0]
            # Incremental reply: cumulative readout + chip cost so far.
            req.readout = up.readout
            req.cycles, req.energy_uj = up.cycles, up.energy_uj
            req.spikes = up.spikes
            if up.input_counts is not None:
                req.input_counts = (
                    up.input_counts if req.input_counts is None
                    else np.concatenate([req.input_counts, up.input_counts]))
            if req.first_reply_at is None:
                req.first_reply_at = now
            if req.cursor >= req.events.shape[0]:
                req.done_at = now
                self.done.append(req)
                self.sessions.close(slot)   # free the slot: continuous batching
                del self.slots[slot]
                with request_context(req.rid):
                    log.info(
                        "stream %d done: %d timesteps, %d cycles, %.2f uJ",
                        req.rid, req.cursor, req.cycles, req.energy_uj)
        self.ticks += 1
        return True

    def step(self) -> bool:
        self._require_live()
        # Mark now, not after: requests submitted since the last tick are
        # part of the state a mid-tick failure must rewind to.
        self._mark()
        t0 = time.monotonic()
        if self._tracer:
            with self._tracer.span("serve.tick", cat="serve",
                                   tick=self.ticks):
                alive = self._step()
        else:
            alive = self._step()
        if self._metrics and alive:
            reg = self._metrics
            reg.histogram("spidr_serve_tick_seconds",
                          "Streaming tick wall latency",
                          edges=obs.metrics.LATENCY_BUCKETS_S
                          ).observe(time.monotonic() - t0)
            reg.gauge("spidr_serve_queue_depth",
                      "Requests waiting for a slot").set(len(self.waiting))
        if alive and self.snapshot_dir and self.snapshot_every \
                and self.ticks % self.snapshot_every == 0:
            self.save_snapshot()
        return alive

    # -- durability: process-level snapshot/restore ------------------------
    @staticmethod
    def _result_json(req: StreamRequest) -> dict:
        return {"rid": int(req.rid), "cursor": int(req.cursor),
                "readout": (None if req.readout is None
                            else np.asarray(req.readout).tolist()),
                "cycles": int(req.cycles),
                "energy_uj": float(req.energy_uj),
                "spikes": int(req.spikes)}

    def save_snapshot(self) -> None:
        """Persist the complete serving state (atomic, checksummed).

        One ``CompiledSNN.snapshot`` step at ``step=self.ticks``: weights +
        the live session, plus the worker's bookkeeping (stream-id <-> slot
        map, per-stream cursors, finished results) as JSON ``extra``.
        Replay after :meth:`restore` is implicit: chunks are re-derived
        from the restored cursors.
        """
        if not self.snapshot_dir:
            raise ValueError("construct the worker with snapshot_dir= to "
                             "save snapshots")
        t0 = time.monotonic()
        extra = {"server": {
            "ticks": int(self.ticks),
            "slots": {str(slot): int(req.rid)
                      for slot, req in self.slots.items()},
            "cursors": {str(req.rid): int(req.cursor)
                        for req in list(self.slots.values()) + self.waiting},
            "waiting": [int(req.rid) for req in self.waiting],
            "done": [self._result_json(req) for req in self.done],
        }}
        self.compiled.snapshot(self.snapshot_dir, step=self.ticks,
                               sessions=[self.sessions], extra=extra)
        if self._metrics:
            self._metrics.histogram(
                "spidr_serve_snapshot_seconds",
                "save_snapshot wall duration (server bookkeeping + "
                "checkpoint write)",
                edges=obs.metrics.LATENCY_BUCKETS_S
            ).observe(time.monotonic() - t0)

    @classmethod
    def restore(cls, path, requests_by_rid: dict, compiled=None, *,
                watchdog_s: Optional[float] = None, max_restarts: int = 3,
                snapshot_every: int = 0, step: Optional[int] = None,
                device=None) -> "StreamWorker":
        """Resume a worker from its latest :meth:`save_snapshot`.

        ``requests_by_rid`` maps stream id -> :class:`StreamRequest`
        carrying the stream's (deterministically regenerated) events;
        in-flight requests resume at their snapshotted cursor, finished
        results are reloaded from the snapshot.  The restored worker then
        serves every stream bit-identically to one that was never killed.
        ``device=None`` rebuilds the deployment on the card (ignored when
        ``compiled`` is given: its device is used).
        """
        from .. import spidr

        info = spidr.read_snapshot_meta(path, step)
        compiled = spidr.restore(path, compiled=compiled, step=info["step"],
                                 device=device)
        session = compiled.sessions[-1]
        srv = cls(compiled, capacity=session.capacity,
                  chunk_T=session.chunk_T, watchdog_s=watchdog_s,
                  max_restarts=max_restarts, snapshot_dir=str(path),
                  snapshot_every=snapshot_every, _session=session)
        state = info["extra"]["server"]
        srv.ticks = int(state["ticks"])
        cursors = {int(k): int(v) for k, v in state["cursors"].items()}
        for slot, rid in state["slots"].items():
            req = requests_by_rid[int(rid)]
            req.cursor = cursors[int(rid)]
            srv.slots[int(slot)] = req
        srv.waiting = [requests_by_rid[int(rid)] for rid in state["waiting"]]
        for req in srv.waiting:
            req.cursor = cursors[int(req.rid)]
        for d in state["done"]:
            req = requests_by_rid.get(int(d["rid"])) or StreamRequest(
                rid=int(d["rid"]), events=np.zeros((0,), np.float32))
            req.cursor = int(d["cursor"])
            req.readout = (None if d["readout"] is None
                           else np.asarray(d["readout"], np.int32))
            req.cycles = int(d["cycles"])
            req.energy_uj = float(d["energy_uj"])
            req.spikes = int(d.get("spikes", 0))  # the reference omits it
            srv.done.append(req)
        srv._mark()
        return srv
