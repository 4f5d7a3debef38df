"""``spidr.compile(network, params, target) -> CompiledSNN``: the facade.

One entry point from a network to a deployed SpiDR instance on the card.
Two input forms, one per quantization provenance, as the reference's:

  * ``compile(spec, float_params, target)`` quantizes with per-tensor
    scales into the integer engine (``engine.build_engine``);
  * ``compile(exported, spec, target)`` deploys an
    :class:`~repro_torch.snn.export.ExportedNetwork` (per-channel
    power-of-two scales and per-channel integer thresholds,
    ``snn.export.deploy``).

``target.n_cores > 1`` additionally routes through
``compiler.compile_network`` + ``engine.compile_engine``; the plan is
bit-exact with single-core execution.  A :class:`CompiledSNN` offers

  ``run(events)``            whole-tensor inference over ``(T, B, H, W, C)``
  ``cost(result)``           the run priced on the calibrated chip models
                             (``MulticoreCost`` on a multi-core plan)
  ``pipeline_trace(result)`` the plan's per-core pipeline as a Chrome trace
  ``save(path)``             the exported integer artifact, which
                             ``spidr.load`` (this package's or the
                             reference's) rebuilds
  ``verify(events)``         the engine against the python-loop reference
                             and a plan against the single-core engine

Streams and snapshots (ROADMAP A7), the static-analysis report (A11),
the roofline (A8), metrics (A9) and the QAT round trip of ``verify``
(A10) belong to later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint.checkpoint import Checkpointer
from ..compiler import compile_network
from ..core.network import SNNSpec, gesture_net, optical_flow_net
from ..engine.cost import estimate_cost, estimate_multicore_cost
from ..engine.inference import (
    EngineConfig,
    EngineOutput,
    SNNEngine,
    build_engine,
    compile_engine,
    run_engine,
    run_reference,
)
from ..obs import timeline as obs_timeline
from ..snn.export import (
    ExportedNetwork,
    deploy,
    load_exported,
    read_export_meta,
    save_exported,
)
from .target import DeployTarget

__all__ = ["CompiledSNN", "VerifyReport", "compile", "load"]


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

    ``reference_exact``    the engine's readout and per-layer spike counts
                           equal the python-loop integer reference on the
                           same integers.
    ``single_core_exact``  a compiled multi-core plan equals the
                           single-core engine (None on one core).
    ``roundtrip``          the QAT training-graph parity of an exported
                           network: None until ROADMAP A10 ports it.
    """

    exact: bool
    reference_exact: bool
    single_core_exact: Optional[bool] = None
    roundtrip: Optional[object] = None

    def __bool__(self) -> bool:
        return self.exact


class CompiledSNN:
    """A deployed SpiDR network: engine + schedule behind one lifecycle.

    ``engine`` executes the target (multi-core when ``n_cores > 1``);
    ``_base_engine`` is the same integers on one core, the oracle that
    :meth:`verify` holds a plan to.
    """

    def __init__(self, spec: SNNSpec, target: DeployTarget, engine: SNNEngine,
                 base_engine: Optional[SNNEngine] = None,
                 exported: Optional[ExportedNetwork] = None, params=None):
        self.spec = spec
        self.target = target
        self.engine = engine
        self.exported = exported
        self.params = params
        self._base_engine = engine if base_engine is None else base_engine

    @property
    def device(self) -> torch.device:
        return self.engine.device

    @property
    def schedule(self):
        """The compiler's :class:`CoreSchedule` (None on one core)."""
        return self.engine.schedule

    @property
    def n_cores(self) -> int:
        return self.target.n_cores

    def __repr__(self) -> str:
        return (f"CompiledSNN({self.spec.name!r}, "
                f"{self.target.weight_bits}/{self.target.vmem_bits}-bit, "
                f"{self.target.n_cores} core(s), "
                f"backend={self.target.backend!r}, "
                f"{'exported' if self.exported is not None else 'per-tensor'}"
                f" weights, device={self.device})")

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

    def cost(self, result=None, input_counts=None):
        """Price a run on the calibrated chip models.

        Pass the :class:`~repro_torch.engine.EngineOutput` from :meth:`run`
        (or any object with per-timestep ``input_counts``), or a raw
        ``(T, n_weight_layers)`` tensor or array via ``input_counts``.
        Returns an ``EngineCost`` on one core and a ``MulticoreCost`` (per-
        core attribution, routing overhead) on a compiled plan.  The models
        are host-side numpy: the counts are copied to the host.
        """
        counts = self._counts_of(result, input_counts)
        if self.schedule is not None:
            return estimate_multicore_cost(self.spec, self.schedule, counts)
        return estimate_cost(self.spec, self.target.qspec, counts)

    @staticmethod
    def _counts_of(result, input_counts) -> np.ndarray:
        if input_counts is None:
            if result is None or getattr(result, "input_counts", None) is None:
                raise ValueError(
                    "cost() needs spike statistics: pass the EngineOutput "
                    "from run(), or a raw (T, n_weight_layers) array via "
                    "input_counts=")
            input_counts = result.input_counts
        if isinstance(input_counts, torch.Tensor):
            input_counts = input_counts.cpu().numpy()
        return np.asarray(input_counts)

    def pipeline_trace(self, result=None, input_counts=None, path=None,
                       label: str = "run", pid: int = 1) -> list:
        """Chrome-trace pipeline timeline of a run on the compiled plan.

        Prices the run through ``estimate_multicore_cost(...,
        collect_timeline=True)`` and renders the per-core busy, AER-routing
        and idle intervals (summed busy + routing durations equal
        ``MulticoreCost.busy_cycles`` exactly).  Returns the events;
        ``path`` also writes a Perfetto-loadable JSON file.  Multi-core
        targets only.
        """
        if self.schedule is None:
            raise ValueError(
                "pipeline_trace() renders the multi-core pipeline clocks — "
                "this deployment is single-core (target.n_cores == 1)")
        counts = self._counts_of(result, input_counts)
        cost = estimate_multicore_cost(self.spec, self.schedule, counts,
                                       collect_timeline=True)
        events = obs_timeline.multicore_timeline(cost, label=label, pid=pid)
        if path is not None:
            obs_timeline.write_chrome_trace(events, path)
        return events

    def save(self, path, step: int = 0) -> None:
        """Persist the deployment's integer artifact under ``path``.

        Writes the ``snn.export`` checkpoint (atomic, validated on reload)
        in the reference's layout; ``spidr.load(path)`` of either package
        rebuilds the deployment from it, bit-exactly.
        """
        if self.exported is None:
            raise ValueError(
                "this CompiledSNN was compiled from float params with "
                "per-tensor scales, which the export checkpoint format "
                "does not represent — export first (snn.export."
                "export_network, then compile(exported, spec, target)) to "
                "make save()/load() available")
        save_exported(Checkpointer(str(path)), step, self.exported, spec=self.spec)

    def verify(self, events=None, params=None, batch: int = 2,
               seed: int = 0) -> VerifyReport:
        """Check the deployment exactly (equal, not close).

        The engine against the python-loop reference on the same integers,
        and a multi-core plan against the single-core engine.  ``events``
        defaults to a synthetic DVS batch for the spec's head (gesture for a
        rate readout, flow otherwise), drawn from ``seed``.  ``params`` is
        accepted for the reference's signature; the QAT round trip it feeds
        is ROADMAP A10, so ``roundtrip`` stays None.
        """
        if events is None:
            from ..snn.data import make_flow_batch, make_gesture_batch

            make = (make_gesture_batch if self.spec.readout == "rate"
                    else make_flow_batch)
            events, _ = make(torch.Generator().manual_seed(seed), batch=batch,
                             timesteps=self.spec.timesteps,
                             hw=self.spec.input_hw, device=self.device)
        out = self.run(events)

        def same(a, b) -> bool:
            return bool(torch.equal(a.readout, b.readout)
                        and torch.equal(a.spike_counts, b.spike_counts))

        reference_exact = same(out, run_reference(self._base_engine, events))
        single_core_exact = None
        if self.schedule is not None:
            single_core_exact = same(out, run_engine(self._base_engine, events))
        exact = reference_exact and single_core_exact is not False
        return VerifyReport(exact=exact, reference_exact=reference_exact,
                            single_core_exact=single_core_exact)


def _apply_schedule(base: SNNEngine, spec: SNNSpec, target: DeployTarget,
                    cfg: EngineConfig) -> SNNEngine:
    """Bake the target's multi-core plan into ``base`` (identity on 1 core).

    Deterministic in (spec, target): the compiler has no randomness, so a
    freshly compiled replica gets the same plan.
    """
    if target.n_cores <= 1:
        return base
    schedule = compile_network(
        spec, n_cores=target.n_cores, qspec=cfg.qspec,
        assumed_sparsity=target.assumed_sparsity,
        force_mode=target.force_mode,
        force_stationarity=target.stationarity)
    return compile_engine(base, schedule, device_parallel=target.device_parallel)


def compile(network, params=None, target: Optional[DeployTarget] = None, *,
            spec: Optional[SNNSpec] = None, device=None) -> CompiledSNN:
    """Deploy a network onto a :class:`DeployTarget`.

      ``compile(spec, float_params, target)``
          quantize ``float_params`` (one float ``(fan_in, c_out)`` tensor or
          array per weight layer, None per pool) with per-tensor scales;

      ``compile(exported, spec, target)``
          deploy an :class:`~repro_torch.snn.export.ExportedNetwork`; keep
          float params beside it with
          ``compile(exported, float_params, target, spec=spec)``.

    ``target`` defaults to ``DeployTarget()`` (4/7-bit, one core, fused CUDA
    kernels).  ``device=None`` means the card and raises when there is
    none; pass ``device="cpu"`` for the plain PyTorch kernels.
    """
    target = target or DeployTarget()
    dev = resolve_device(device)
    cfg = _engine_config(target)
    if isinstance(network, ExportedNetwork):
        if spec is None and isinstance(params, SNNSpec):
            spec, params = params, None
        if spec is None:
            raise ValueError(
                "deploying an ExportedNetwork needs its SNNSpec: "
                "compile(exported, spec, target) or "
                "compile(exported, float_params, target, spec=spec)")
        if target.weight_bits != network.weight_bits:
            raise ValueError(
                f"target executes {target.weight_bits}-bit weights but the "
                f"network was exported at {network.weight_bits}-bit — "
                f"re-export, or deploy with DeployTarget(weight_bits="
                f"{network.weight_bits})")
        base = deploy(network, spec, cfg, n_cores=1, device=dev)
        exported = network
    elif isinstance(network, SNNSpec):
        spec = network
        if params is None:
            raise ValueError(
                "compiling an SNNSpec needs its float params: "
                "compile(spec, params, target) — params from "
                "core.network.init_params; an exported integer artifact "
                "deploys via compile(exported, spec, target) instead")
        base = build_engine(spec, params, cfg, device=dev)
        exported = None
    else:
        raise TypeError(
            f"compile() takes an SNNSpec or an ExportedNetwork, got "
            f"{type(network).__name__} — build a spec with "
            "core.network.gesture_net/optical_flow_net (or a config's "
            "reduced()), or an exported network with snn.export")
    engine = _apply_schedule(base, spec, target, cfg)
    return CompiledSNN(spec=spec, target=target, engine=engine,
                       base_engine=base, exported=exported, params=params)


def _spec_for(name) -> SNNSpec:
    """A checkpoint's network name -> the paper's network spec."""
    if name in ("gesture", "spidr-gesture"):
        return gesture_net()
    if name in ("optical-flow", "optical_flow", "flow", "spidr-optical-flow"):
        return optical_flow_net()
    raise ValueError(f"unknown SNN task {name!r}")


def load(path, spec: Optional[SNNSpec] = None,
         target: Optional[DeployTarget] = None, step: Optional[int] = None,
         device=None) -> CompiledSNN:
    """Rebuild a deployment from a :meth:`CompiledSNN.save` checkpoint.

    Reads the ``snn.export`` artifact under ``path`` (written by this
    package or the reference), validates it and deploys it onto
    ``target``.  ``spec`` defaults to the paper network named in the
    checkpoint's metadata, at the event geometry (``input_hw``/
    ``timesteps``) recorded there.  ``target`` defaults to the exported
    precision on one core.
    """
    ckpt = Checkpointer(str(path))
    if step is None:
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint steps under {ckpt.directory} — was the "
                "deployment saved with CompiledSNN.save (or "
                "snn.export.save_exported)?")
    if spec is None:
        info = read_export_meta(ckpt, step)
        name = info.get("name")
        try:
            spec = _spec_for(name)
        except ValueError:
            raise ValueError(
                f"checkpoint step {step} names network {name!r}, which is "
                "not one of the paper's specs — pass the SNNSpec it was "
                "exported with: load(path, spec=...)") from None
        if "input_hw" in info:
            spec = dataclasses.replace(
                spec, input_hw=tuple(info["input_hw"]),
                timesteps=int(info.get("timesteps", spec.timesteps)))
    exported = load_exported(ckpt, spec, step)
    if target is None:
        target = DeployTarget(weight_bits=exported.weight_bits)
    return compile(exported, spec, target, device=device)
