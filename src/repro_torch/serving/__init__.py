"""The serving tier: replicated engines, session scheduling, live migration.

Public entry point: ``spidr.serve(compiled_or_replicas, ServeConfig) ->
Fleet`` (re-exported on the ``repro_torch.spidr`` facade).  The pieces:

  * :class:`ServeConfig` — declarative fleet shape + scheduling policy;
  * :class:`Fleet` — N replicated deployments behind
    ``submit``/``stream``/``drain``/``shutdown``, each replica on its own
    device and, in threaded mode, on its own CUDA stream;
  * :class:`SessionScheduler` — bounded FIFO admission, deterministic
    placement, crash re-placement;
  * :class:`StreamWorker`/:class:`BatchWorker` — the per-replica tick
    loops: persistent-Vmem streams with watchdog, rewind-and-replay and
    snapshots, or fixed-capacity whole-stream batches;
  * :class:`FleetOverloaded` — the explicit load-shedding reply.
"""
from .config import FleetOverloaded, ServeConfig
from .fleet import Fleet, StreamHandle, StreamProgress, serve
from .scheduler import SessionScheduler
from .worker import BatchWorker, StreamRequest, StreamWorker

__all__ = [
    "BatchWorker",
    "Fleet",
    "FleetOverloaded",
    "ServeConfig",
    "SessionScheduler",
    "StreamHandle",
    "StreamProgress",
    "StreamRequest",
    "StreamWorker",
    "serve",
]
