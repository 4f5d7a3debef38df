"""``spidr.compile(spec, params, target) -> CompiledSNN``: the facade.

One entry point from a network to a deployed SpiDR instance on the card:
``compile`` quantizes float parameters with per-tensor scales into the
integer engine (``engine.build_engine``) and returns a
:class:`CompiledSNN` with

  ``run(events)``     whole-tensor inference over ``(T, B, H, W, C)``
  ``verify(events)``  the engine against the python-loop reference, exact

Streams, save/load, cost models, snapshots and exported (trained)
networks belong to later slices of the port (ROADMAP A6, A7, A5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import resolve_device
from ..core.network import SNNSpec
from ..engine.inference import (
    EngineConfig,
    EngineOutput,
    SNNEngine,
    build_engine,
    run_engine,
    run_reference,
)
from .target import DeployTarget

__all__ = ["CompiledSNN", "VerifyReport", "compile"]


def _engine_config(target: DeployTarget) -> EngineConfig:
    """Lower a :class:`DeployTarget` onto the engine's execution config."""
    return EngineConfig(
        target.qspec,
        # "reference" runs the torch datapath through the python-loop oracle.
        backend="fused" if target.backend == "fused" else "torch",
        skip_empty=target.skip_empty,
        block=tuple(target.block),
        t_block=target.t_block,
    )


@dataclasses.dataclass(frozen=True)
class VerifyReport:
    """Result of :meth:`CompiledSNN.verify`.

    ``exact``: the engine's readout and per-layer spike counts equal the
    python-loop integer reference on the same integers.
    """

    exact: bool

    def __bool__(self) -> bool:
        return self.exact


class CompiledSNN:
    """A deployed SpiDR network: the engine behind one lifecycle."""

    def __init__(self, spec: SNNSpec, target: DeployTarget, engine: SNNEngine):
        self.spec = spec
        self.target = target
        self.engine = engine

    @property
    def device(self) -> torch.device:
        return self.engine.device

    def __repr__(self) -> str:
        return (f"CompiledSNN({self.spec.name!r}, "
                f"{self.target.weight_bits}/{self.target.vmem_bits}-bit, "
                f"backend={self.target.backend!r}, device={self.device})")

    def run(self, events) -> EngineOutput:
        """Run a whole ``(T, B, H, W, C)`` binary event stream.

        ``events`` may be a tensor on any device or a numpy array; it is
        moved to the deployment's device.
        """
        events = torch.as_tensor(events, device=self.device)
        if events.ndim != 5:
            raise ValueError(
                f"expected events of shape (T, B, H, W, C); got "
                f"{tuple(events.shape)} — a single stream needs a batch axis "
                "(events[:, None])")
        if self.target.backend == "reference":
            return run_reference(self.engine, events)
        return run_engine(self.engine, events)

    def verify(self, events=None, batch: int = 2, seed: int = 0) -> VerifyReport:
        """Check the deployment against the python-loop reference, exactly.

        ``events`` defaults to a synthetic DVS batch for the spec's head
        (gesture for a rate readout, flow otherwise), drawn from ``seed``.
        """
        if events is None:
            from ..snn.data import make_flow_batch, make_gesture_batch

            make = (make_gesture_batch if self.spec.readout == "rate"
                    else make_flow_batch)
            events, _ = make(torch.Generator().manual_seed(seed), batch=batch,
                             timesteps=self.spec.timesteps,
                             hw=self.spec.input_hw, device=self.device)
        out = self.run(events)
        ref = run_reference(self.engine, events)
        exact = bool(torch.equal(out.readout, ref.readout)
                     and torch.equal(out.spike_counts, ref.spike_counts))
        return VerifyReport(exact=exact)


def compile(spec: SNNSpec, params, target: Optional[DeployTarget] = None,
            device=None) -> CompiledSNN:
    """Deploy ``spec`` with float ``params`` onto ``target``.

    ``params`` is one float ``(fan_in, c_out)`` tensor or array per weight
    layer and None per pool layer (``core.network.init_params``, or the
    JAX package's via ``convert.params_from_jax``); they are quantized with
    per-tensor scales.  ``target`` defaults to ``DeployTarget()`` (4/7-bit,
    fused CUDA kernels).  ``device=None`` means the card and raises when
    there is none; pass ``device="cpu"`` for the plain PyTorch kernels.
    """
    if not isinstance(spec, SNNSpec):
        raise TypeError(
            f"compile() takes an SNNSpec, got {type(spec).__name__} — exported "
            "(trained) networks are not ported yet (ROADMAP A6)")
    if params is None:
        raise ValueError("compiling an SNNSpec needs its float params: "
                         "compile(spec, params, target)")
    target = target or DeployTarget()
    engine = build_engine(spec, params, _engine_config(target),
                          device=resolve_device(device))
    return CompiledSNN(spec=spec, target=target, engine=engine)
