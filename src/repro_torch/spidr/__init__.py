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
"""
from .compiled import CompiledSNN, VerifyReport, compile, load
from .target import BACKENDS, PRECISION_PAIRS, DeployTarget

__all__ = [
    "BACKENDS",
    "CompiledSNN",
    "DeployTarget",
    "PRECISION_PAIRS",
    "VerifyReport",
    "compile",
    "load",
]
