"""Session scheduling for the fleet: admit -> place -> (re)balance.

The k8s-scheduler shape, one level down: a stream's *spec* (its request)
enters a bounded admission queue, the scheduler binds it to a replica
(*placement*), and the fleet streams its status/progress afterwards.
Everything here is deterministic in (arrival order, completion order):

  * admission is FIFO with a hard bound — the queue never exceeds
    ``max_queue``; beyond it the submit is shed with an explicit
    :class:`~repro_torch.serving.config.FleetOverloaded` reply, never silently
    dropped;
  * placement is head-of-line only (no queue jumping): the next stream
    goes to the least-loaded live replica (most free slots, ties to the
    lowest index) or round-robin, and inside a replica to the session's
    first free slot — two fleets fed the same arrival order place every
    stream identically (tested);
  * a crashed replica's in-flight streams re-enter the queue *at the
    front* in their original order (``requeue_front``), so re-placement
    preserves arrival priority.
"""
from __future__ import annotations

import collections
from typing import Optional

from .. import obs
from .config import FleetOverloaded

__all__ = ["SessionScheduler"]


class SessionScheduler:
    """Admission control + deterministic placement over fleet replicas."""

    def __init__(self, workers, *, max_queue: int = 64,
                 policy: str = "least-loaded", metrics=None):
        self.workers = list(workers)
        self.alive = [True] * len(self.workers)
        self.max_queue = max_queue
        self.policy = policy
        self.queue: collections.deque = collections.deque()  # StreamHandles
        self.submitted = 0
        self.shed = 0
        self.placed = 0
        self._rr = 0  # round-robin cursor
        self._metrics = (obs.default_registry() if metrics is None
                         else metrics)

    # -- admission ---------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def admit(self, handle) -> None:
        """FIFO admission with a hard bound; sheds with an explicit reply.

        Raises :class:`FleetOverloaded` when ``max_queue`` streams already
        wait — the stream is *not* enqueued and the handle is marked
        ``"shed"`` so the caller's reply carries the verdict.
        """
        if len(self.queue) >= self.max_queue:
            self.shed += 1
            handle.status = "shed"
            if self._metrics:
                self._metrics.counter(
                    "spidr_fleet_shed_total",
                    "Streams shed at admission (queue full)").inc()
            raise FleetOverloaded(len(self.queue), self.max_queue)
        self.submitted += 1
        self.queue.append(handle)

    def requeue_front(self, handles) -> None:
        """Put a crashed replica's streams back at the head of the queue,
        preserving their original relative order."""
        self.queue.extendleft(reversed(list(handles)))

    # -- placement ---------------------------------------------------------
    def _pick(self, exclude=(), only=None) -> Optional[int]:
        """The replica the next stream binds to, or None when all are full.

        ``least-loaded``: most free slots, ties broken by lowest replica
        index.  ``round-robin``: the next live replica with room, cycling.
        """
        candidates = [i for i in range(len(self.workers))
                      if self.alive[i] and i not in exclude
                      and (only is None or i in only)
                      and self.workers[i].free_capacity() > 0]
        if not candidates:
            return None
        if self.policy == "round-robin":
            ordered = sorted(candidates,
                             key=lambda i: (i - self._rr) % len(self.workers))
            choice = ordered[0]
            self._rr = (choice + 1) % len(self.workers)
            return choice
        return max(candidates,
                   key=lambda i: (self.workers[i].free_capacity(), -i))

    def place(self, only=None) -> list:
        """Bind queued streams to replicas, FIFO, until capacity runs out.

        Head-of-line only: when the next stream in arrival order cannot be
        placed, nothing behind it is — the property that makes placement a
        pure function of arrival order.  Returns ``[(handle, replica)]``.
        """
        placements = []
        while self.queue:
            i = self._pick(only=only)
            if i is None:
                break
            handle = self.queue.popleft()
            self.workers[i].submit(handle.request)
            handle.status = "placed"
            handle.replica = i
            self.placed += 1
            placements.append((handle, i))
        if placements and self._metrics:
            self._metrics.counter(
                "spidr_fleet_placed_total",
                "Streams bound to a replica").inc(len(placements))
        return placements

    # -- liveness ----------------------------------------------------------
    def mark_dead(self, replica: int) -> None:
        self.alive[replica] = False

    @property
    def n_alive(self) -> int:
        return sum(self.alive)
