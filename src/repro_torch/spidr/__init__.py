"""Deployment facade: one ``DeployTarget`` -> ``CompiledSNN``.

    from repro_torch import spidr

    target = spidr.DeployTarget(weight_bits=4, backend="fused", t_block=4)
    compiled = spidr.compile(spec, params, target)   # device=None: the card
    out = compiled.run(events)                       # (T, B, H, W, C)
    report = compiled.verify(events)                 # exact vs the reference

    plan = spidr.compile(spec, params, spidr.DeployTarget(n_cores=4))
    cost = plan.cost(plan.run(events))               # per-core MulticoreCost
    compiled = spidr.compile(exported, spec, target) # snn.export integers
    compiled.save(path); compiled = spidr.load(path)

    with compiled.open_stream(capacity=4, chunk_T=2) as session:
        slot = session.open()
        update = session.step({slot: events[0:2, 0]})[slot]  # SlotUpdate
        compiled.snapshot(path)                   # weights + live sessions
    resumed = spidr.restore(path)                 # in a fresh process too

    fleet = spidr.serve(compiled, n_replicas=2)   # replicas, scheduling,
    handle = fleet.submit(events[:, 0])           #  shedding, live migration
    fleet.drain(); fleet.shutdown()

    tuned = spidr.compile(spec, params, spidr.DeployTarget(autotune=True))
    tuned.roofline(batch=4)["bound_us"]           # the H100 bound of a chunk
"""
from ..serving import Fleet, FleetOverloaded, ServeConfig, StreamHandle, serve
from .compiled import (CompiledSNN, SlotUpdate, StreamSession, VerifyReport,
                       compile, load, read_snapshot_meta, restore)
from .target import BACKENDS, PRECISION_PAIRS, DeployTarget

__all__ = [
    "BACKENDS",
    "CompiledSNN",
    "DeployTarget",
    "Fleet",
    "FleetOverloaded",
    "PRECISION_PAIRS",
    "ServeConfig",
    "SlotUpdate",
    "StreamHandle",
    "StreamSession",
    "VerifyReport",
    "compile",
    "load",
    "read_snapshot_meta",
    "restore",
    "serve",
]
