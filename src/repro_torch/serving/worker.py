"""Whole-stream batched serving worker: one engine, one queue, one step.

:class:`BatchWorker` packs waiting requests into a fixed
``(T, capacity, H, W, C)`` batch — idle slots carry zero events, which
the zero-skipping kernels make nearly free — and one ``CompiledSNN.run``
serves them all.  The counterpart of ``repro.serving.worker.BatchWorker``
without its telemetry (``repro.obs`` is ported with the fleet, ROADMAP
A9); the streaming worker waits for the streaming slice (ROADMAP A7).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["BatchWorker", "StreamRequest"]


@dataclasses.dataclass
class StreamRequest:
    """One DVS event stream moving through the serving tier."""

    rid: int
    events: np.ndarray                     # (T, H, W, C) binary event frames
    readout: Optional[np.ndarray] = None   # filled on completion
    submitted_at: float = 0.0
    done_at: Optional[float] = None


class BatchWorker:
    """Fixed-capacity batched SNN inference worker.

    Lifecycle: :meth:`submit` after :meth:`shutdown` raises
    ``RuntimeError``; :meth:`shutdown` itself is idempotent.
    """

    def __init__(self, compiled, capacity: int = 4):
        self.compiled = compiled
        self.capacity = capacity
        self.waiting: list = []
        self.done: list = []
        # Per-timestep, per-layer spike statistics summed over every batch.
        self.total_input_counts = None
        self.total_spike_counts = None
        self.batches = 0
        self._closed = False

    def submit(self, req: StreamRequest) -> None:
        if self._closed:
            raise RuntimeError("worker is shut down — submit() after shutdown() "
                               "is an error")
        if not req.submitted_at:
            req.submitted_at = time.monotonic()
        self.waiting.append(req)

    def shutdown(self) -> None:
        """Stop accepting work (idempotent); results stay on ``done``."""
        self._closed = True

    def step(self) -> bool:
        """Serve up to ``capacity`` waiting requests in one batch."""
        if self._closed:
            raise RuntimeError("worker is shut down — step() after shutdown() "
                               "is an error")
        if not self.waiting:
            return False
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
        return True
