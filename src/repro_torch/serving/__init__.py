"""The serving tier: whole-stream batches and persistent-Vmem streams.

  * :class:`BatchWorker` — fixed-capacity whole-stream batches, one
    ``CompiledSNN.run`` per batch;
  * :class:`StreamWorker` — continuous batching over persistent-Vmem
    session slots, with watchdog, rewind-and-replay and snapshot/restore;
  * :class:`StreamRequest` — one event stream moving through either.

The fleet of replicated workers (``spidr.serve``, ``ServeConfig``, the
session scheduler) is ROADMAP A9.
"""
from .worker import BatchWorker, StreamRequest, StreamWorker

__all__ = ["BatchWorker", "StreamRequest", "StreamWorker"]
