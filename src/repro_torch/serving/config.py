"""Declarative fleet configuration for ``spidr.serve``.

:class:`ServeConfig` is to the serving tier what
:class:`~repro_torch.spidr.DeployTarget` is to compilation: one frozen record
declaring the fleet's shape (replica count, per-replica session geometry),
its scheduling policy (placement, admission bound, rebalancing cadence)
and its operational knobs (watchdog, snapshots, device placement) —
validated eagerly with actionable errors instead of failing mid-serve.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["FleetOverloaded", "PLACEMENT_POLICIES", "SERVE_MODES",
           "ServeConfig"]

PLACEMENT_POLICIES = ("least-loaded", "round-robin")
SERVE_MODES = ("sync", "threaded")


class FleetOverloaded(RuntimeError):
    """Explicit load-shedding reply: the fleet's admission queue is full.

    Raised by ``Fleet.submit`` when ``ServeConfig.max_queue`` streams are
    already waiting for a slot.  The stream was *not* admitted — re-submit
    later (after ``drain``/completions free capacity) or serve with a
    larger ``max_queue``/more replicas.  ``queue_depth``/``max_queue``
    carry the rejection context for the caller's backpressure logic.
    """

    def __init__(self, queue_depth: int, max_queue: int):
        self.queue_depth = queue_depth
        self.max_queue = max_queue
        super().__init__(
            f"fleet admission queue is full ({queue_depth} streams waiting, "
            f"max_queue={max_queue}) — the stream was shed; re-submit after "
            "capacity frees up, or serve with a larger max_queue or more "
            "replicas")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """How ``spidr.serve`` shapes and schedules a fleet.

    ``n_replicas``     engine replicas ticking concurrently (ignored when
                       an explicit replica list is passed to ``serve``).
    ``capacity``       persistent-Vmem slots per replica (default: the
                       deployment's ``target.stream_capacity``).
    ``chunk_T``        timesteps per streaming tick (default: the
                       deployment's ``target.chunk_T``).
    ``max_queue``      admission bound: streams waiting for a slot beyond
                       this are shed with :class:`FleetOverloaded`.
    ``placement``      ``"least-loaded"`` (most free slots, ties to the
                       lowest replica index — deterministic) or
                       ``"round-robin"``.
    ``mode``           ``"sync"`` — the caller ticks the fleet
                       (``Fleet.step``/``drain``), fully deterministic —
                       or ``"threaded"`` — one loop thread per replica
                       ticks continuously, each on a CUDA stream of its
                       own (the kernel launches release the GIL, so
                       replicas overlap).
    ``batch``          serve whole streams per tick (the former
                       ``SNNServer`` path) instead of persistent-Vmem
                       streaming chunks.
    ``migrate_every``  sync mode: every N fleet ticks, rebalance one
                       stream from the most- to the least-loaded replica
                       via live migration (0 = never).
    ``watchdog_s`` / ``max_restarts`` / ``snapshot_dir`` /
    ``snapshot_every``  per-replica fault tolerance, as on the streaming
                       worker (snapshots land under
                       ``snapshot_dir/replica<i>``).
    ``devices``        ``None`` (the deployment's device), ``"auto"``
                       (one CUDA device per replica when the deployment is
                       on the card and the host has one for every
                       replica), or an explicit per-replica sequence of
                       ``torch.device`` / device strings (``None`` entries
                       keep the deployment's device).
    """

    n_replicas: int = 1
    capacity: Optional[int] = None
    chunk_T: Optional[int] = None
    max_queue: int = 64
    placement: str = "least-loaded"
    mode: str = "sync"
    batch: bool = False
    migrate_every: int = 0
    watchdog_s: Optional[float] = None
    max_restarts: int = 3
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 0
    collect_chunk_counts: bool = False
    devices: object = None

    def __post_init__(self):
        def positive(name, v):
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"ServeConfig.{name} must be a positive int, got {v!r}")

        positive("n_replicas", self.n_replicas)
        if self.capacity is not None:
            positive("capacity", self.capacity)
        if self.chunk_T is not None:
            positive("chunk_T", self.chunk_T)
        if not isinstance(self.max_queue, int) or self.max_queue < 1:
            raise ValueError(
                f"ServeConfig.max_queue must be a positive int (the "
                f"admission bound), got {self.max_queue!r}")
        if self.placement not in PLACEMENT_POLICIES:
            raise ValueError(
                f"ServeConfig.placement must be one of "
                f"{PLACEMENT_POLICIES}, got {self.placement!r}")
        if self.mode not in SERVE_MODES:
            raise ValueError(
                f"ServeConfig.mode must be one of {SERVE_MODES}, got "
                f"{self.mode!r}")
        if self.migrate_every < 0:
            raise ValueError(
                f"ServeConfig.migrate_every must be >= 0 (ticks between "
                f"rebalance checks; 0 disables), got {self.migrate_every!r}")
        if self.batch and self.migrate_every:
            raise ValueError(
                "ServeConfig.batch fleets hold no resident state — there "
                "is nothing to migrate; drop migrate_every or serve "
                "streaming (batch=False)")
        if self.devices is not None and self.devices != "auto" \
                and not isinstance(self.devices, (list, tuple)):
            raise ValueError(
                "ServeConfig.devices must be None, 'auto', or an explicit "
                f"per-replica device sequence, got {self.devices!r}")
