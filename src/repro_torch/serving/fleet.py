"""``spidr.serve``: an async serving fleet over replicated deployments.

The reference's ``repro.serving.fleet`` on the card.  SpiDR keeps
heterogeneous compute units pipelined on-chip through asynchronous
handshaking; this module mirrors that one level up.  A :class:`Fleet`
continuously batches open event streams onto N replicated ``CompiledSNN``
engines: each replica is a :class:`~repro_torch.serving.worker.StreamWorker`
(a bank of persistent-Vmem session slots advanced by one fixed-shape
``run_chunk`` per tick: B1 or B2 on the card), a
:class:`~repro_torch.serving.scheduler.SessionScheduler` admits and places
streams deterministically, and live streams migrate between replicas
through the per-slot snapshot path (``StreamSession.export_slot`` /
``import_slot``) — a migrated stream emits spikes, readouts and
cumulative cycle/energy attribution byte-identical to one that never
moved (tested).

Placement on devices.  A replica runs on its deployment's device unless
``ServeConfig.devices`` names another: its session then runs the
deployment's engine copied to that device once
(``CompiledSNN.engine_on``), where the reference commits the session's
state with ``jax.device_put``.

Two drive modes:

  * ``mode="sync"`` — the caller owns the clock: ``Fleet.step()`` places
    queued streams and ticks every replica once; ``drain()`` loops to
    completion.  Fully deterministic — the mode tests, benchmarks and the
    migration-exactness gate run in.
  * ``mode="threaded"`` — one loop thread per replica ticks continuously
    (the ``ctypes`` kernel launches and PyTorch's ops release the GIL, so
    replicas overlap on host cores); ``submit``/``drain``/``shutdown`` are
    thread-safe.  On the card each replica thread ticks on a CUDA stream
    of its own (``torch.cuda.stream``), so the B1/B2 wrappers, which
    launch on the current stream, put replicas on separate streams.  The
    stream first waits for the default stream (the weights and the
    session's zeroed state were made there) and the session's tensors are
    recorded on it (``StreamSession.record_stream``); everything a tick
    makes it makes on the replica's stream, and every tick ends in
    synchronous copies to the host.

Telemetry: every queue transition, tick and migration lands in the
``repro_torch.obs`` metrics registry (``spidr_fleet_*``) and tracer, so
the fleet is observable end to end with the rest of the stack.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import obs
from .config import ServeConfig
from .scheduler import SessionScheduler
from .worker import BatchWorker, StreamRequest, StreamWorker

__all__ = ["Fleet", "StreamHandle", "StreamProgress", "serve"]


@dataclasses.dataclass(frozen=True)
class StreamProgress:
    """One status/log-streaming update from :meth:`Fleet.stream`."""

    rid: int
    status: str
    timesteps: int
    readout: Optional[np.ndarray]
    cycles: int
    energy_uj: float
    replica: Optional[int]


@dataclasses.dataclass
class StreamHandle:
    """The caller's view of one submitted stream (k8s-style status object).

    ``status`` walks ``queued -> placed -> running -> done`` (``"shed"``
    only appears on the handle carried by a :class:`FleetOverloaded`
    reply).  ``placements`` records every ``(replica, slot)`` the stream
    ran in — length > 1 means it was live-migrated.  Result fields proxy
    the underlying request, so a handle is also the stream's incremental
    reply while it runs.
    """

    rid: int
    request: StreamRequest
    status: str = "queued"
    replica: Optional[int] = None
    slot: Optional[int] = None
    placements: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.status == "done"

    @property
    def migrations(self) -> int:
        return max(0, len(self.placements) - 1)

    @property
    def timesteps(self) -> int:
        return int(self.request.cursor)

    @property
    def readout(self):
        return self.request.readout

    @property
    def cycles(self) -> int:
        return int(self.request.cycles)

    @property
    def energy_uj(self) -> float:
        return float(self.request.energy_uj)

    def progress(self) -> StreamProgress:
        return StreamProgress(
            rid=self.rid, status=self.status, timesteps=self.timesteps,
            readout=self.readout, cycles=self.cycles,
            energy_uj=self.energy_uj, replica=self.replica)


class Fleet:
    """N replicated engines, one scheduler, one lifecycle.

    Build with :func:`serve` (the public entry point), not directly.
    ``submit`` admits a stream (or sheds with :class:`FleetOverloaded`),
    ``stream`` yields its incremental progress, ``drain`` serves to
    completion, ``shutdown`` retires the fleet — after which ``submit``
    raises ``RuntimeError``.  The fleet is a context manager
    (``with spidr.serve(...) as fleet:``) that shuts down on exit.
    """

    def __init__(self, replicas, config: ServeConfig):
        self.config = config
        self.replicas = list(replicas)
        self._lock = threading.RLock()
        self._closed = False
        self._stop = threading.Event()
        self._threads: list = []
        self._handles: dict = {}       # rid -> StreamHandle
        self._next_rid = 0
        self.ticks = 0
        self.migrations = 0
        self.crashes = 0
        self._metrics = obs.default_registry()
        self._tracer = obs.default_tracer()
        first = self.replicas[0]
        self.capacity = (config.capacity if config.capacity is not None
                         else first.target.stream_capacity)
        self.chunk_T = (config.chunk_T if config.chunk_T is not None
                        else first.target.chunk_T)
        devices = self._resolve_devices()
        self.workers = []
        for i, compiled in enumerate(self.replicas):
            if config.batch:
                self.workers.append(BatchWorker(compiled, self.capacity))
            else:
                snap = (os.path.join(config.snapshot_dir, f"replica{i}")
                        if config.snapshot_dir else None)
                self.workers.append(StreamWorker(
                    compiled, self.capacity, self.chunk_T,
                    watchdog_s=config.watchdog_s,
                    max_restarts=config.max_restarts,
                    snapshot_dir=snap,
                    snapshot_every=config.snapshot_every,
                    collect_chunk_counts=config.collect_chunk_counts,
                    device=devices[i]))
        self.scheduler = SessionScheduler(
            self.workers, max_queue=config.max_queue,
            policy=config.placement, metrics=self._metrics)
        self._done_seen = [0] * len(self.workers)
        # Threaded mode on the card: each replica's CUDA stream, and the
        # streams its ticks ran on (``torch.cuda.current_stream`` handles).
        self.replica_streams: dict = {}
        self.tick_streams: dict = {}
        if config.mode == "threaded":
            self._start_threads()

    def _resolve_devices(self) -> list:
        cfg = self.config
        n = len(self.replicas)
        if cfg.devices is None or cfg.batch:
            return [None] * n
        if cfg.devices == "auto":
            # One card per replica when the deployment is on the card and
            # the host has one for each; a partial spread would co-locate
            # some replicas asymmetrically.
            on_card = self.replicas[0].device.type == "cuda"
            n_dev = torch.cuda.device_count() if on_card else 0
            return ([torch.device("cuda", i) for i in range(n)]
                    if n_dev >= n else [None] * n)
        devs = list(cfg.devices)
        if len(devs) != n:
            raise ValueError(
                f"ServeConfig.devices lists {len(devs)} device(s) for "
                f"{n} replica(s) — pass one device per replica, 'auto', "
                "or None")
        return devs

    # -- introspection -----------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.workers)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def queue_depth(self) -> int:
        return self.scheduler.queue_depth

    @property
    def shed(self) -> int:
        """Streams rejected at admission since the fleet started."""
        return self.scheduler.shed

    @property
    def handles(self) -> dict:
        """Every admitted stream's handle, by rid (shed streams excluded)."""
        return dict(self._handles)

    @property
    def done(self) -> list:
        """Every finished request across all replicas, in completion order."""
        reqs = [r for w in self.workers for r in w.done]
        return sorted(reqs, key=lambda r: (r.done_at or 0.0, r.rid))

    def describe(self) -> str:
        """One status line per replica (occupancy, queue, liveness)."""
        lines = [f"fleet: {self.n_replicas} replica(s), "
                 f"{self.scheduler.queue_depth} queued, "
                 f"{self.scheduler.shed} shed, "
                 f"{self.migrations} migration(s)"]
        for i, w in enumerate(self.workers):
            alive = "live" if self.scheduler.alive[i] else "DEAD"
            if isinstance(w, StreamWorker):
                occ = f"{w.sessions.occupancy}/{w.sessions.capacity} slots"
            else:
                occ = f"{len(w.waiting)} waiting"
            lines.append(f"  replica {i}: {alive}, {occ}, "
                         f"{len(w.done)} done")
        return "\n".join(lines)

    # -- submission --------------------------------------------------------
    def submit(self, events, rid: Optional[int] = None) -> StreamHandle:
        """Admit one event stream; returns its :class:`StreamHandle`.

        ``events`` is ``(T, H, W, C)`` binary frames; ``rid`` defaults to
        an auto-incremented id.  Raises :class:`FleetOverloaded` when the
        admission queue is full (explicit load shedding — the stream was
        not accepted) and ``RuntimeError`` after :meth:`shutdown`.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "fleet is shut down — submit() after shutdown() is an "
                    "error; spidr.serve a new fleet")
            if rid is None:
                rid = self._next_rid
            if rid in self._handles:
                raise ValueError(
                    f"stream id {rid} was already submitted — rids are "
                    "unique per fleet")
            self._next_rid = max(self._next_rid, rid) + 1
            req = StreamRequest(rid=rid, events=np.asarray(events))
            req.submitted_at = time.monotonic()
            handle = StreamHandle(rid=rid, request=req)
            self.scheduler.admit(handle)   # may raise FleetOverloaded
            self._handles[rid] = handle
            if self._metrics:
                self._metrics.counter(
                    "spidr_fleet_submitted_total",
                    "Streams admitted into the fleet queue").inc()
                self._metrics.gauge(
                    "spidr_fleet_queue_depth",
                    "Streams waiting for a replica slot"
                ).set(self.scheduler.queue_depth)
            return handle

    # -- the sync clock ----------------------------------------------------
    def step(self) -> bool:
        """One fleet tick: place queued streams, tick every live replica.

        Sync mode only (threaded fleets tick themselves).  Returns True
        while any stream is queued or in flight.
        """
        if self.config.mode != "sync":
            raise RuntimeError(
                "step() drives a sync-mode fleet; a threaded fleet ticks "
                "itself — submit streams and drain() or poll handles")
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet is shut down")
            t0 = time.monotonic()
            self.scheduler.place()
            progressed = False
            for i, w in enumerate(self.workers):
                if not self.scheduler.alive[i]:
                    continue
                if w.step():
                    progressed = True
                self._track_placements(i)
                self._collect(i)
            self.ticks += 1
            cfg = self.config
            if cfg.migrate_every and not cfg.batch \
                    and self.ticks % cfg.migrate_every == 0:
                self._rebalance()
            if self._metrics:
                self._metrics.histogram(
                    "spidr_fleet_tick_seconds",
                    "Fleet tick wall latency",
                    edges=obs.metrics.LATENCY_BUCKETS_S
                ).observe(time.monotonic() - t0)
                self._metrics.gauge(
                    "spidr_fleet_queue_depth",
                    "Streams waiting for a replica slot"
                ).set(self.scheduler.queue_depth)
            if self.scheduler.queue and not progressed \
                    and self.scheduler.n_alive == 0:
                raise RuntimeError(
                    "every replica is dead with streams still queued — "
                    "the fleet cannot make progress")
            return progressed or bool(self.scheduler.queue)

    def _track_placements(self, i: int) -> None:
        """Fold replica ``i``'s slot table into the handles' status/history."""
        w = self.workers[i]
        if not isinstance(w, StreamWorker):
            return
        for slot, req in w.slots.items():
            h = self._handles.get(req.rid)
            if h is None:
                continue
            cur = (i, slot)
            if not h.placements or h.placements[-1] != cur:
                h.placements.append(cur)
            h.replica, h.slot = i, slot
            h.status = "running"

    def _collect(self, i: int) -> None:
        """Resolve replica ``i``'s newly finished requests onto handles."""
        w = self.workers[i]
        new = w.done[self._done_seen[i]:]
        self._done_seen[i] = len(w.done)
        for req in new:
            h = self._handles.get(req.rid)
            if h is None:
                continue
            h.status = "done"
            h.slot = None
            if self._metrics:
                self._metrics.counter(
                    "spidr_fleet_completed_total",
                    "Streams served to completion").inc()
                if req.done_at and req.submitted_at:
                    self._metrics.histogram(
                        "spidr_fleet_stream_latency_seconds",
                        "Submit-to-completion latency per stream",
                        edges=obs.metrics.LATENCY_BUCKETS_S
                    ).observe(req.done_at - req.submitted_at)

    # -- live migration ----------------------------------------------------
    def migrate(self, rid: Optional[int] = None,
                to: Optional[int] = None) -> int:
        """Live-migrate one running stream to another replica.

        Exports the stream's slot state (resident Vmem, accounting,
        handshake clocks) from its current replica and imports it into a
        free slot on the target — the stream's remaining chunks then run
        there, bit-identical to a never-migrated run.  ``rid`` defaults to
        the first running stream on the most-loaded replica; ``to``
        defaults to the least-loaded other replica with a free slot.
        Returns the target replica index.  Sync mode only.
        """
        if self.config.mode != "sync":
            raise RuntimeError(
                "live migration is a sync-scheduler operation — threaded "
                "fleets rebalance at admission instead")
        if self.config.batch:
            raise RuntimeError(
                "batch fleets hold no resident stream state — there is "
                "nothing to migrate")
        with self._lock:
            src, slot, req = self._find_stream(rid)
            if to is None:
                to = self._pick_migration_target(src)
                if to is None:
                    raise RuntimeError(
                        "no other live replica has a free session slot to "
                        "migrate into")
            if to == src:
                raise ValueError(
                    f"stream {req.rid} already runs on replica {to}")
            if not self.scheduler.alive[to]:
                raise ValueError(f"target replica {to} is dead")
            w_src, w_dst = self.workers[src], self.workers[to]

            def _move():
                payload = w_src.sessions.export_slot(slot)
                w_src.sessions.close(slot)
                del w_src.slots[slot]
                new_slot = w_dst.sessions.import_slot(payload)
                w_dst.slots[new_slot] = req
                return new_slot

            if self._tracer:
                with self._tracer.span("fleet.migrate", cat="fleet",
                                       rid=req.rid, src=src, dst=to):
                    new_slot = _move()
            else:
                new_slot = _move()
            h = self._handles.get(req.rid)
            if h is not None:
                h.placements.append((to, new_slot))
                h.replica, h.slot = to, new_slot
            self.migrations += 1
            if self._metrics:
                self._metrics.counter(
                    "spidr_fleet_migrations_total",
                    "Streams live-migrated between replicas").inc()
            return to

    def _find_stream(self, rid: Optional[int]):
        """Locate a running stream: (replica, slot, request)."""
        if rid is not None:
            for i, w in enumerate(self.workers):
                if not self.scheduler.alive[i]:
                    continue
                for slot, req in w.slots.items():
                    if req.rid == rid:
                        return i, slot, req
            raise ValueError(
                f"stream {rid} is not running in any replica slot — only "
                "placed, still-live streams can migrate")
        # Default pick: lowest slot on the most-loaded live replica.
        candidates = [i for i in range(len(self.workers))
                      if self.scheduler.alive[i] and self.workers[i].slots]
        if not candidates:
            raise ValueError("no stream is currently running in the fleet")
        src = max(candidates, key=lambda i: (len(self.workers[i].slots), -i))
        slot = min(self.workers[src].slots)
        return src, slot, self.workers[src].slots[slot]

    def _pick_migration_target(self, src: int) -> Optional[int]:
        best = None
        for i, w in enumerate(self.workers):
            if i == src or not self.scheduler.alive[i]:
                continue
            free = w.sessions.capacity - w.sessions.occupancy
            if free > 0 and (best is None or free > best[1]):
                best = (i, free)
        return None if best is None else best[0]

    def _rebalance(self) -> None:
        """Migrate one stream from the most- to the least-loaded replica
        when their slot occupancy differs by 2+ (``migrate_every``)."""
        live = [i for i in range(len(self.workers))
                if self.scheduler.alive[i]]
        if len(live) < 2:
            return
        loads = {i: len(self.workers[i].slots) for i in live}
        src = max(live, key=lambda i: (loads[i], -i))
        dst = min(live, key=lambda i: (loads[i], i))
        if loads[src] - loads[dst] < 2 or not self.workers[src].slots:
            return
        slot = min(self.workers[src].slots)
        self.migrate(self.workers[src].slots[slot].rid, to=dst)

    # -- replica failure ---------------------------------------------------
    def kill_replica(self, replica: int) -> list:
        """Mark a replica dead and re-place its in-flight streams.

        The crashed replica's resident state is gone by definition, so its
        streams re-enter the admission queue *at the front* (original
        order) with progress reset — deterministic replay from timestep 0
        on whichever replica the scheduler re-places them on produces the
        same final results (tested).  Returns the re-queued handles.
        """
        with self._lock:
            if not self.scheduler.alive[replica]:
                return []
            self.scheduler.mark_dead(replica)
            w = self.workers[replica]
            lost = w.inflight()
            requeued = []
            for req in lost:
                req.cursor = 0
                req.readout = None
                req.cycles = 0
                req.energy_uj = 0.0
                req.input_counts = None
                req.first_reply_at = None
                h = self._handles.get(req.rid)
                if h is not None:
                    h.status = "queued"
                    h.replica = h.slot = None
                    requeued.append(h)
            self.scheduler.requeue_front(requeued)
            self.crashes += 1
            if self._metrics:
                self._metrics.counter(
                    "spidr_fleet_replica_crashes_total",
                    "Replica failures handled by re-placement").inc()
                self._metrics.counter(
                    "spidr_fleet_replaced_streams_total",
                    "Streams re-queued after a replica crash"
                ).inc(len(requeued))
            return requeued

    # -- status streaming --------------------------------------------------
    def stream(self, handle):
        """Yield a stream's incremental progress until it completes.

        ``handle`` is a :class:`StreamHandle` (or a rid).  In sync mode
        each iteration ticks the fleet; in threaded mode it polls.  Yields
        a :class:`StreamProgress` after every chunk the stream consumes,
        ending with the ``"done"`` update.
        """
        if not isinstance(handle, StreamHandle):
            handle = self._handles[int(handle)]
        last = -1
        while True:
            if handle.status in ("done", "failed"):
                break
            if self.config.mode == "sync":
                self.step()
            else:
                time.sleep(0.002)
            if handle.request.cursor != last:
                last = handle.request.cursor
                yield handle.progress()
        if handle.request.cursor != last:
            yield handle.progress()

    # -- completion / teardown ---------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> dict:
        """Serve every admitted stream to completion; returns the handles.

        Sync mode loops :meth:`step`; threaded mode waits for the replica
        loops (``timeout`` seconds at most, raising ``TimeoutError``).
        """
        if self.config.mode == "sync":
            while self.step():
                pass
        else:
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
            while True:
                with self._lock:
                    pending = any(h.status not in ("done", "failed")
                                  for h in self._handles.values())
                if not pending:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"fleet did not drain within {timeout}s "
                        f"({self.describe()})")
                time.sleep(0.005)
        return dict(self._handles)

    def shutdown(self) -> None:
        """Retire the fleet (idempotent): stop replica loops, close every
        session, reject further submits with ``RuntimeError``."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)
        for w in self.workers:
            w.shutdown()

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- threaded mode -----------------------------------------------------
    def _start_threads(self) -> None:
        for i in range(len(self.workers)):
            dev = self.workers[i].device
            if dev.type == "cuda":
                stream = torch.cuda.Stream(device=dev)
                # The weights and the session's state were made on the
                # default stream: the replica's stream waits for them, and
                # the allocator learns the state is in use on it.
                stream.wait_stream(torch.cuda.default_stream(dev))
                if isinstance(self.workers[i], StreamWorker):
                    self.workers[i].sessions.record_stream(stream)
                # Fleet state: written under the lock like every other
                # mutation (the replica threads read it).
                with self._lock:
                    self.replica_streams[i] = stream
                    self.tick_streams[i] = set()
            t = threading.Thread(target=self._replica_loop, args=(i,),
                                 name=f"spidr-replica-{i}", daemon=True)
            self._threads.append(t)
            t.start()

    def _replica_loop(self, i: int) -> None:
        w = self.workers[i]
        stream = self.replica_streams.get(i)
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            while not self._stop.is_set():
                with self._lock:
                    if not self.scheduler.alive[i]:
                        break
                    self.scheduler.place(only={i})
                # The kernel launches release the GIL — replicas overlap.
                progressed = w.step()
                if stream is not None:
                    self.tick_streams[i].add(
                        torch.cuda.current_stream(stream.device).cuda_stream)
                with self._lock:
                    self._track_placements(i)
                    self._collect(i)
                    self.ticks += 1
                if not progressed:
                    time.sleep(0.002)
            if stream is not None:
                stream.synchronize()


def serve(compiled, config: Optional[ServeConfig] = None,
          **overrides) -> Fleet:
    """Deploy a serving fleet over one or more compiled replicas.

    The one public serving entry point (``spidr.serve``)::

        fleet = spidr.serve(compiled, n_replicas=2, capacity=4)
        handle = fleet.submit(events)          # (T, H, W, C) frames
        fleet.drain()                          # or: for up in fleet.stream(handle)
        print(handle.readout, handle.cycles)
        fleet.shutdown()

    ``compiled`` is a single :class:`~repro_torch.spidr.CompiledSNN` — replicated
    ``config.n_replicas`` times over shared weights — or an explicit
    replica list (e.g. separately prepared deployments), which must agree
    on target and spec and carry byte-identical weights.  Keyword
    overrides build/extend the :class:`ServeConfig`.
    """
    if config is None:
        config = ServeConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    if isinstance(compiled, (list, tuple)):
        replicas = list(compiled)
        if not replicas:
            raise ValueError("serve() needs at least one replica")
        if config.n_replicas == 1 and len(replicas) > 1:
            config = dataclasses.replace(config, n_replicas=len(replicas))
        elif config.n_replicas != len(replicas):
            raise ValueError(
                f"ServeConfig.n_replicas={config.n_replicas} but "
                f"{len(replicas)} replicas were passed — drop n_replicas "
                "or make them agree")
        _validate_replicas(replicas)
    else:
        replicas = [compiled] * config.n_replicas
    return Fleet(replicas, config)


def _validate_replicas(replicas) -> None:
    """Explicit replica lists must be interchangeable deployments: same
    target, same spec geometry, byte-identical weights — the precondition
    for bit-exact cross-replica migration."""
    first = replicas[0]
    ref_arrays = None
    for i, r in enumerate(replicas[1:], start=1):
        if r is first:
            continue
        if r.target != first.target:
            raise ValueError(
                f"replica {i} is compiled for {r.target}, replica 0 for "
                f"{first.target} — fleet replicas must share one "
                "DeployTarget")
        if r.spec.name != first.spec.name \
                or r.spec.input_hw != first.spec.input_hw \
                or r.spec.timesteps != first.spec.timesteps:
            raise ValueError(
                f"replica {i} serves spec {r.spec.name!r} "
                f"{r.spec.input_hw}x{r.spec.timesteps}, replica 0 "
                f"{first.spec.name!r} {first.spec.input_hw}x"
                f"{first.spec.timesteps} — fleet replicas must share one "
                "network")
        if ref_arrays is None:
            ref_arrays = first._layer_arrays()
        for li, (a, b) in enumerate(zip(ref_arrays, r._layer_arrays())):
            same = (a is None) == (b is None) and (
                a is None or (np.array_equal(a["w_q"], b["w_q"])
                              and np.array_equal(a["w_scale"], b["w_scale"])
                              and np.array_equal(a["thr_int"],
                                                 b["thr_int"])))
            if not same:
                raise ValueError(
                    f"replica {i} weight layer {li} is not byte-identical "
                    "to replica 0's — a fleet's replicas must be the same "
                    "deployment (compile from the same artifact)")
