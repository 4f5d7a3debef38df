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
  ``open_stream()``          a persistent-Vmem streaming session
                             (:class:`StreamSession`)
  ``cost(result)``           the run priced on the calibrated chip models
                             (``MulticoreCost`` on a multi-core plan)
  ``metrics()``              the process-wide telemetry registry's export
  ``pipeline_trace(result)`` the plan's per-core pipeline as a Chrome trace
  ``save(path)``             the exported integer artifact, which
                             ``spidr.load`` (this package's or the
                             reference's) rebuilds
  ``snapshot(path)``         the integer weights plus every open session's
                             slots, table and clocks, which
                             ``spidr.restore`` resumes bit-exactly in a
                             fresh process (this package's or the
                             reference's: either reads the other's)
  ``verify(events, params)`` the engine against the python-loop reference,
                             a plan against the single-core engine and,
                             with float params, the exported integers
                             against the QAT training graph
  ``roofline(batch)``        the analytic bound of a chunk on the H100
                             (``roofline.PerfModel``), per weight layer
  ``engine_on(device)``      the engine copied to another device, once per
                             device (a fleet replica's)

``DeployTarget(autotune=True)`` measures each weight layer's ``t_block`` on
the deployment's device (``kernels.autotune``) and bakes the winner into
the engine as ``EngineLayer.kcfg``; every candidate is bit-exact.

``compile(..., check="strict"|"warn"|"off")`` gates the build on the
deploy-time static analysis (``repro_torch.analysis``: overflow
certificate + schedule verification), as the reference's does, and
``CompiledSNN.report()`` returns it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint.checkpoint import Checkpointer
from ..compiler import compile_network
from ..core.network import SNNSpec, gesture_net, init_state_shapes, optical_flow_net
from ..core.pipeline import PipelineState
from ..engine.cost import estimate_cost, estimate_multicore_cost
from ..engine.inference import (
    EngineConfig,
    EngineLayer,
    EngineOutput,
    SNNEngine,
    build_engine,
    compile_engine,
    engine_to,
    run_engine,
    run_reference,
)
from ..engine.streaming import (
    SESSION_SCHEMA_VERSION,
    SlotUpdate,
    StreamSessionManager,
    _same_device,
)
from ..obs import metrics as obs_metrics
from ..obs import timeline as obs_timeline
from ..obs import trace as obs_trace
from ..snn.export import (
    ExportedLayer,
    ExportedNetwork,
    RoundTrip,
    deploy,
    load_exported,
    read_export_meta,
    save_exported,
    verify_roundtrip,
)
from .target import DeployTarget, _require_positive_int

if TYPE_CHECKING:  # pragma: no cover
    from ..analysis import AnalysisReport

__all__ = ["CompiledSNN", "SlotUpdate", "StreamSession", "VerifyReport",
           "compile", "load", "read_snapshot_meta", "restore"]

#: ``spidr.compile(..., check=...)`` modes for the static-analysis gate.
CHECK_MODES = ("strict", "warn", "off")

# Live-session snapshot artifact: one Checkpointer step whose metadata
# carries this key (the reference's), distinct from the ``snn.export``
# weight artifact of ``CompiledSNN.save``.
_SNAPSHOT_META_KEY = "spidr_session_snapshot"
SNAPSHOT_VERSION = 1


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


def _autotune_engine(base: SNNEngine, spec: SNNSpec, target: DeployTarget,
                     cfg: EngineConfig) -> SNNEngine:
    """Bake measured per-layer kernel configs into ``base``.

    Consults :func:`repro_torch.kernels.autotune.autotune_layer` per weight
    layer (cached by shape+precision, optionally persisted via
    ``$SPIDR_AUTOTUNE_CACHE``), racing the candidates on ``base``'s device
    (B2 at the layer's shape on the card), and attaches the winner as
    ``EngineLayer.kcfg``.  Every candidate is bit-exact, so tuning changes
    wall time only, never results.
    """
    from ..kernels.autotune import autotune_layer

    tracer = obs_trace.default_tracer()
    reg = obs_metrics.default_registry()
    t_sweep = time.perf_counter()
    shapes = iter(spec.layer_shapes())
    new_layers = []
    with tracer.span("autotune", cat="compile", network=spec.name):
        for li, el in enumerate(base.layers):
            if el.kind not in ("conv", "fc"):
                new_layers.append(el)
                continue
            sh = next(shapes)
            rows = sh.out_positions if el.kind == "conv" else 1
            with tracer.span("autotune.layer", cat="compile", layer=li,
                             kind=el.kind, rows=rows,
                             channels=sh.out_channels):
                winner = autotune_layer(
                    rows, sh.fan_in, sh.out_channels,
                    target.weight_bits, target.vmem_bits,
                    timesteps=min(spec.timesteps, 8),
                    sparsity=target.assumed_sparsity,
                    skip_empty=cfg.skip_empty, device=base.device)
            if reg:
                # Info-gauge: the chosen KernelConfig rides in the labels
                # (value is a constant 1, Prometheus "info" idiom).
                bm, bn, bk, tb = winner.kcfg
                reg.gauge(
                    "spidr_autotune_kcfg_info",
                    "Chosen per-layer kernel config (info gauge)",
                    labels={"network": spec.name, "layer": li,
                            "kind": el.kind, "block_m": bm, "block_n": bn,
                            "block_k": bk, "t_block": tb}).set(1.0)
            new_layers.append(dataclasses.replace(el, kcfg=winner.kcfg))
    if reg:
        reg.counter(
            "spidr_autotune_seconds_total",
            "Wall seconds spent in autotune sweeps").inc(
                time.perf_counter() - t_sweep)
        reg.counter(
            "spidr_autotune_layers_total",
            "Weight layers autotuned").inc(
                sum(1 for el in base.layers if el.kind in ("conv", "fc")))
    return dataclasses.replace(base, layers=tuple(new_layers))


@dataclasses.dataclass(frozen=True)
class VerifyReport:
    """Result of :meth:`CompiledSNN.verify`.

    ``reference_exact``    the engine's readout and per-layer spike counts
                           equal the python-loop integer reference on the
                           same integers.
    ``single_core_exact``  a compiled multi-core plan equals the
                           single-core engine (None on one core).
    ``roundtrip``          the QAT training graph against the deployed
                           integers (``snn.export.RoundTrip``): None unless
                           the deployment is exported and has float params.
    """

    exact: bool
    reference_exact: bool
    single_core_exact: Optional[bool] = None
    roundtrip: Optional[RoundTrip] = None

    def __bool__(self) -> bool:
        return self.exact


class StreamSession:
    """Session handle over a bank of persistent-Vmem stream slots.

    Wraps an ``engine.streaming.StreamSessionManager``: ``capacity`` slots
    multiplexed into one fixed-shape ``run_chunk`` per tick, on the
    deployment's device.  The delivery contract is the manager's (every
    open slot delivers a chunk every tick; a short chunk ends its stream);
    violations raise with the manager's diagnostics.

    Lifecycle: the session is a context manager; :meth:`close` is
    idempotent (closing a closed slot, or the whole session twice, is a
    no-op), while :meth:`open`/:meth:`step` on a closed session raise
    ``RuntimeError``.
    """

    def __init__(self, engine: SNNEngine, capacity: int, chunk_T: int,
                 collect_chunk_counts: bool = False, metrics=None,
                 tracer=None, device=None):
        self._manager = StreamSessionManager(
            engine, capacity=capacity, chunk_T=chunk_T, metrics=metrics,
            tracer=tracer, collect_chunk_counts=collect_chunk_counts,
            device=device)
        self._closed = False

    @property
    def capacity(self) -> int:
        return self._manager.capacity

    @property
    def chunk_T(self) -> int:
        return self._manager.chunk_T

    @property
    def occupancy(self) -> int:
        return self._manager.occupancy

    @property
    def device(self) -> torch.device:
        """The device the session's state and engine live on."""
        return self._manager.device

    @property
    def active(self) -> tuple:
        """Per-slot open flags (index = slot id)."""
        return tuple(self._manager.active)

    def state_dict(self) -> dict:
        """The session's full durable state as fresh host numpy arrays (see
        ``StreamSessionManager.state_dict``)."""
        return self._manager.state_dict()

    def load_state_dict(self, d: dict) -> None:
        """Restore the session to a :meth:`state_dict` snapshot bit-exactly
        (the session must have matching capacity/engine geometry)."""
        self._manager.load_state_dict(d)

    def record_stream(self, stream) -> None:
        """Mark the session's resident CUDA tensors as in use on ``stream``
        (a fleet replica's), so the caching allocator does not hand their
        memory to another stream while ``stream`` may still read them."""
        st = self._manager.state
        for t in (*st.vmem, st.readout_acc, st.out_counts, st.in_counts):
            if t is not None and t.is_cuda:
                t.record_stream(stream)

    @property
    def closed(self) -> bool:
        """True once the whole session was retired via no-arg :meth:`close`
        (or by leaving its ``with`` block)."""
        return self._closed

    def _require_open(self, what: str) -> None:
        if self._closed:
            raise RuntimeError(
                f"cannot {what} on a closed StreamSession — open a new "
                "session with CompiledSNN.open_stream()")

    def open(self) -> Optional[int]:
        """Allocate a slot for a new stream; None if the session is full."""
        self._require_open("open a stream")
        return self._manager.open()

    def step(self, chunks: dict) -> dict:
        """Advance every open slot by one chunk: ``{slot: (t, H, W, C)}``
        events in, ``{slot: SlotUpdate}`` incremental replies out."""
        self._require_open("step")
        return self._manager.step(chunks)

    def close(self, slot: Optional[int] = None) -> None:
        """Retire one stream slot, or with no argument the whole session.

        Idempotent: closing a slot that is not open, or an already closed
        session, is a no-op.  A no-arg close retires every open slot and
        marks the session closed.
        """
        if slot is None:
            for s, active in enumerate(self._manager.active):
                if active:
                    self._manager.close(s)
            self._closed = True
            return
        if self._closed or not self._manager.active[slot]:
            return
        self._manager.close(slot)

    def export_slot(self, slot: int) -> dict:
        """One live stream's durable state as fresh host arrays — feed to
        another session's :meth:`import_slot` to migrate it bit-exactly."""
        self._require_open("export a slot")
        return self._manager.export_slot(slot)

    def import_slot(self, payload: dict, slot: Optional[int] = None) -> int:
        """Install a migrated stream's :meth:`export_slot` payload into a
        free slot (first free by default); returns the destination slot."""
        self._require_open("import a slot")
        return self._manager.import_slot(payload, slot)

    def iter_chunks(self, events, slot: Optional[int] = None):
        """Serve one whole ``(T, H, W, C)`` stream through this session,
        ``chunk_T`` timesteps per tick, yielding each :class:`SlotUpdate`.

        With no ``slot`` the helper opens one (``RuntimeError`` when the
        session is full) and closes it when the stream ends, also on an
        early ``break`` or error.  Other live slots must keep delivering
        through their own ``step`` calls.
        """
        self._require_open("iterate a stream")
        events = np.asarray(events)
        own = slot is None
        if own:
            slot = self._manager.open()
            if slot is None:
                raise RuntimeError(
                    f"session is full ({self.capacity} slots live) — "
                    "close a stream or open a larger session")
        try:
            for lo in range(0, events.shape[0], self.chunk_T):
                yield self._manager.step(
                    {slot: events[lo:lo + self.chunk_T]})[slot]
        finally:
            if own and not self._closed and self._manager.active[slot]:
                self._manager.close(slot)

    def __enter__(self) -> "StreamSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


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
        self._sessions: list = []   # every StreamSession opened here
        self._device_engines: dict = {}   # device -> engine copied there
        self._analysis: Optional["AnalysisReport"] = None

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

    def report(self) -> "AnalysisReport":
        """The deployment's static-analysis report (``repro_torch.analysis``).

        Overflow certificates plus schedule verification for *this*
        network at *this* precision and core count.  Populated by
        :func:`compile` unless it ran with ``check="off"``; computed
        lazily here otherwise — so the certificate is always available,
        the ``check`` mode only decides whether findings gate the build.
        """
        if self._analysis is None:
            from .. import analysis

            self._analysis = analysis.analyze_deployment(
                self.spec, self.target.qspec, self.schedule)
        return self._analysis

    def engine_on(self, device=None) -> SNNEngine:
        """The deployment's engine on ``device``: :attr:`engine` itself for
        None or its own device, else a copy of its weights and thresholds
        made there on first use and cached (one per device).  A fleet
        replica placed on another card runs such a copy."""
        if device is None:
            return self.engine
        dev = torch.device(device)
        if _same_device(dev, self.device):
            return self.engine
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = str(dev)
        if key not in self._device_engines:
            self._device_engines[key] = engine_to(self.engine, dev)
        return self._device_engines[key]

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

    # -- streaming ---------------------------------------------------------
    def open_stream(self, capacity: Optional[int] = None,
                    chunk_T: Optional[int] = None,
                    collect_chunk_counts: bool = False, metrics=None,
                    tracer=None, device=None) -> StreamSession:
        """Open a persistent-Vmem streaming session on the deployment's device.

        ``capacity`` / ``chunk_T`` default to the target's
        ``stream_capacity`` / ``chunk_T``.  A stream served through the
        session is bit-identical to a whole-stream :meth:`run` on that
        stream alone, whatever shares the batch.  (A ``"reference"`` target
        streams through the plain torch datapath: same integers.)

        ``collect_chunk_counts=True`` makes every ``SlotUpdate`` carry its
        chunk's per-layer input-spike counts (for per-stream pipeline
        timelines).  ``metrics`` / ``tracer``: None uses the process-wide
        ``repro_torch.obs`` defaults (off unless enabled), a private
        registry/tracer isolates, False pins telemetry off.  ``device``:
        None for the deployment's device; another device runs the session
        on :meth:`engine_on`'s copy of the engine there (a fleet replica),
        bit-identical to the deployment's own device.
        """
        capacity = self.target.stream_capacity if capacity is None \
            else capacity
        chunk_T = self.target.chunk_T if chunk_T is None else chunk_T
        _require_positive_int("capacity", capacity,
                              hint="concurrent persistent-Vmem stream slots")
        _require_positive_int("chunk_T", chunk_T,
                              hint="timesteps delivered per streaming tick")
        session = StreamSession(self.engine_on(device), capacity=capacity,
                                chunk_T=chunk_T, metrics=metrics,
                                tracer=tracer,
                                collect_chunk_counts=collect_chunk_counts)
        self._sessions.append(session)
        return session

    @property
    def sessions(self) -> tuple:
        """Every :class:`StreamSession` opened on this deployment, in
        :meth:`open_stream` order — the set :meth:`snapshot` serializes."""
        return tuple(self._sessions)

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

    def metrics(self, fmt: str = "prometheus"):
        """Export the process-wide metrics registry (``repro_torch.obs``):
        ``"prometheus"`` text or the ``"json"`` dict.  Empty unless metrics
        were enabled before the instrumented paths ran."""
        reg = obs_metrics.default_registry()
        if fmt in ("prometheus", "prom", "text"):
            return reg.to_prometheus()
        if fmt == "json":
            return reg.to_dict()
        raise ValueError(
            f"unknown metrics format {fmt!r} — use 'prometheus' or 'json'")

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

    # -- performance model -------------------------------------------------
    def roofline(self, batch: int = 1, timesteps: Optional[int] = None,
                 nonzero_tile_fracs=None) -> dict:
        """Predicted wall-time bound for one chunk on this deployment.

        Prices the compiled engine's tiling (each layer's autotuned
        ``t_blk`` when it has one, else the target's ``t_block``) through
        :class:`repro_torch.roofline.PerfModel` at the H100's peaks:
        bytes moved + MACs at sparsity per weight layer, ``bound_us`` the
        summed max(compute, memory) bound.  The tile priced is the CUDA
        ring's ``(64, 32, 32)`` (``kernels._ring``), where the reference
        prices the MXU block; the byte model reads the weights once per
        64-row tile, while the ring keeps a block's weight slab resident,
        so the bound is conservative on weights.  ``nonzero_tile_fracs``
        is a per-weight-layer list of nonzero spike-tile fractions
        (``kernels.spike_tile_bitmap``); the default prices dense spikes.
        """
        from ..kernels._ring import BM, KSTEP, NB
        from ..roofline.analysis import PerfModel

        tile = (BM, NB, KSTEP)
        kcfgs = [None if el.kcfg is None else tile + (el.kcfg[3],)
                 for el in self._base_engine.layers if el.kind in ("conv", "fc")]
        return PerfModel().network_bound(
            self.spec, batch=batch, timesteps=timesteps,
            t_block=self._base_engine.cfg.t_block, block=tile,
            nonzero_tile_fracs=nonzero_tile_fracs, layer_kcfgs=kcfgs)

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

    def _layer_arrays(self) -> list:
        """The deployment's integer weights as plain numpy, one
        ``{"w_q", "w_scale", "thr_int"}`` per weight layer (None per pool).

        ``w_scale`` is widened to float64, so both provenances serialize
        losslessly (a per-tensor python float, a per-channel float32).
        """
        out = []
        for el in self._base_engine.layers:
            if el.kind not in ("conv", "fc"):
                out.append(None)
                continue
            thr = el.thr_int
            out.append({
                "w_q": el.w_q.cpu().numpy().astype(np.int8, copy=True),
                "w_scale": np.asarray(el.w_scale, np.float64),
                "thr_int": (thr.cpu().numpy().astype(np.int32, copy=True)
                            if isinstance(thr, torch.Tensor)
                            else np.asarray(thr, np.int32)),
            })
        return out

    def snapshot(self, path, step: int = 0, sessions=None,
                 extra: Optional[dict] = None) -> None:
        """Persist the complete live serving state under ``path``.

        One atomic, checksummed checkpoint step holding the deployment's
        integer weights plus every given session's durable state (slot
        Vmems, session table, handshake clocks), in the reference's layout:
        ``spidr.restore`` of either package resumes every stream
        bit-exactly.  The target is written in the reference's vocabulary
        (plain backend ``"jnp"``, ``interpret`` None).  ``sessions``
        defaults to every session opened via :meth:`open_stream`;
        ``extra`` is JSON-serializable caller bookkeeping, returned by
        :func:`read_snapshot_meta`.
        """
        sessions = self.sessions if sessions is None else tuple(sessions)
        t0 = time.perf_counter()
        with obs_trace.default_tracer().span(
                "snapshot.save", cat="durability", path=str(path),
                sessions=len(sessions)):
            info = {
                "version": SNAPSHOT_VERSION,
                "session_schema": SESSION_SCHEMA_VERSION,
                "provenance": ("exported" if self.exported is not None
                               else "per_tensor"),
                "target": _target_info(self.target),
                "spec": _spec_info(self.spec),
                "sessions": [{"capacity": s.capacity, "chunk_T": s.chunk_T}
                             for s in sessions],
                "extra": extra or {},
            }
            tree = {"layers": self._layer_arrays(),
                    "sessions": [s.state_dict() for s in sessions]}
            Checkpointer(str(path)).save(
                step, tree, extra_meta={_SNAPSHOT_META_KEY: info})
        reg = obs_metrics.default_registry()
        if reg:
            reg.histogram(
                "spidr_snapshot_seconds",
                "CompiledSNN.snapshot wall duration",
                edges=obs_metrics.LATENCY_BUCKETS_S,
            ).observe(time.perf_counter() - t0)

    def verify(self, events=None, params=None, batch: int = 2,
               seed: int = 0) -> VerifyReport:
        """Check the deployment exactly (equal, not close).

        The engine against the python-loop reference on the same integers,
        a multi-core plan against the single-core engine, and, when float
        params are at hand (``params`` here, or kept by :func:`compile`) for
        an exported network, the deployed integers against the QAT training
        graph (``snn.export.verify_roundtrip``); ``exact`` requires all.
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
        events = torch.as_tensor(events, device=self.device)
        out = self.run(events)

        def same(a, b) -> bool:
            return bool(torch.equal(a.readout, b.readout)
                        and torch.equal(a.spike_counts, b.spike_counts))

        reference_exact = same(out, run_reference(self._base_engine, events))
        single_core_exact = None
        if self.schedule is not None:
            single_core_exact = same(out, run_engine(self._base_engine, events))
        roundtrip = None
        params = params if params is not None else self.params
        if self.exported is not None and params is not None:
            roundtrip = verify_roundtrip(params, self.spec, self.engine, events,
                                         self.exported, engine_out=out)
        exact = (reference_exact and single_core_exact is not False
                 and (roundtrip is None or roundtrip.exact))
        return VerifyReport(exact=exact, reference_exact=reference_exact,
                            single_core_exact=single_core_exact,
                            roundtrip=roundtrip)


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
            spec: Optional[SNNSpec] = None, device=None,
            check: str = "warn") -> CompiledSNN:
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

    ``check`` gates the build on deploy-time static analysis
    (``repro_torch.analysis``: overflow certification + schedule
    verification).  ``"strict"`` raises
    :class:`~repro_torch.analysis.AnalysisError` on any error-level
    finding, ``"warn"`` (the default) emits a ``RuntimeWarning``, ``"off"``
    skips the analysis at compile time (``CompiledSNN.report()`` still
    computes it on demand).
    """
    if check not in CHECK_MODES:
        raise ValueError(
            f"check must be one of {CHECK_MODES}, got {check!r}")
    compiled = _compile(network, params, target, spec, device)
    if check != "off":
        report = compiled.report()
        if report.errors:
            if check == "strict":
                from ..analysis import AnalysisError

                raise AnalysisError(report)
            warnings.warn(
                f"static analysis found {len(report.errors)} violation(s) "
                f"in {report.subject} — see CompiledSNN.report() "
                "(compile with check='strict' to fail the build)",
                RuntimeWarning, stacklevel=2)
    return compiled


def _compile(network, params, target: Optional[DeployTarget],
             spec: Optional[SNNSpec], device) -> CompiledSNN:
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
    if target.autotune and cfg.backend == "fused":
        base = _autotune_engine(base, spec, target, cfg)
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


# ---------------------------------------------------------------------------
# Live-session snapshots: CompiledSNN.snapshot -> spidr.restore
# ---------------------------------------------------------------------------
# The two packages name the plain integer backend differently.
_BACKEND_TO_REFERENCE = {"torch": "jnp"}
_BACKEND_FROM_REFERENCE = {"jnp": "torch"}


def _target_info(target: DeployTarget) -> dict:
    """The target's JSON form in the reference's vocabulary: its field
    order, ``interpret`` (None: the reference picks) and ``"jnp"`` for the
    plain backend, so ``repro.spidr.restore`` reads a port snapshot."""
    info = {}
    for key, value in dataclasses.asdict(target).items():
        if key == "backend":
            value = _BACKEND_TO_REFERENCE.get(value, value)
        elif key == "block":
            value = list(value)
        info[key] = value
        if key == "stream_capacity":
            info["interpret"] = None
    return info


def _spec_info(spec: SNNSpec) -> dict:
    """The spec geometry a snapshot pins (and restore re-validates)."""
    return {"name": spec.name, "input_hw": list(spec.input_hw),
            "in_channels": int(spec.in_channels),
            "timesteps": int(spec.timesteps), "readout": spec.readout,
            "n_layers": len(spec.layers)}


def _target_from_info(d: dict) -> DeployTarget:
    """Rebuild a snapshot's :class:`DeployTarget` from its JSON form,
    written by either package (the reference's ``interpret`` field, which
    only steers Pallas, is dropped; ``"jnp"`` is the plain backend)."""
    kw = {k: v for k, v in d.items() if k != "interpret"}
    kw["backend"] = _BACKEND_FROM_REFERENCE.get(kw.get("backend"),
                                                kw.get("backend"))
    kw["block"] = tuple(kw["block"])
    try:
        return DeployTarget(**kw)
    except TypeError as e:
        raise ValueError(
            f"the snapshot's DeployTarget does not match this build's "
            f"fields: {e} — re-snapshot with this version") from e


def _layer_arrays_template(spec: SNNSpec, per_channel: bool) -> list:
    """Structure template of the snapshot's weight tree, from the spec
    alone; ``per_channel`` (exported networks) carries (K,) scale and
    threshold vectors, a per-tensor deployment scalars."""
    like = []
    for layer in spec.layers:
        if layer.kind == "conv":
            f, k = layer.conv.kh * layer.conv.kw * layer.c_in, layer.c_out
        elif layer.kind == "fc":
            f, k = layer.c_in, layer.c_out
        else:
            like.append(None)
            continue
        sshape = (k,) if per_channel else ()
        like.append({"w_q": np.zeros((f, k), np.int8),
                     "w_scale": np.zeros(sshape, np.float64),
                     "thr_int": np.zeros(sshape, np.int32)})
    return like


def _session_state_template(spec: SNNSpec, capacity: int,
                            n_cores: int) -> dict:
    """Structure template matching ``StreamSessionManager.state_dict``,
    built without an engine (the weights are in the same checkpoint)."""
    vmem = [None if shape is None else np.zeros(shape, np.int32)
            for shape in init_state_shapes(spec, capacity)]
    if spec.readout == "rate":
        acc = np.zeros((capacity, spec.layers[-1].c_out), np.int32)
    else:
        acc = np.zeros(next(v for v in reversed(vmem)
                            if v is not None).shape, np.int32)
    n_l = sum(1 for layer in spec.layers if layer.kind in ("conv", "fc"))
    return {
        "schema": np.int64(SESSION_SCHEMA_VERSION),
        "engine_state": {
            "vmem": vmem,
            "readout_acc": acc,
            "out_counts": np.zeros((n_l, capacity), np.int32),
            "in_counts": np.zeros((n_l, capacity), np.int32),
        },
        "table": {
            "active": np.zeros(capacity, np.bool_),
            "ended": np.zeros(capacity, np.bool_),
            "timesteps": np.zeros(capacity, np.int64),
            "spikes": np.zeros(capacity, np.int64),
            "cycles": np.zeros(capacity, np.int64),
            "energy_uj": np.zeros(capacity, np.float64),
            "route_cycles": np.zeros((capacity, n_cores), np.int64),
            "core_cycles": np.zeros((capacity, n_cores), np.int64),
            "imbalance": np.ones(capacity, np.float64),
            "ticks": np.int64(0),
        },
        "clocks": [[PipelineState.zero().to_dict()
                    for _ in range(n_cores)] for _ in range(capacity)],
    }


def _compile_from_arrays(spec: SNNSpec, target: DeployTarget,
                         cfg: EngineConfig, arrays: list,
                         per_channel: bool, name: str,
                         device: torch.device) -> CompiledSNN:
    """Rebuild a deployment from a snapshot's integers (``w_q``, float64
    ``w_scale``, ``thr_int``), through the build chain the original took
    (``deploy`` for exported networks, ``build_engine``'s layers for
    per-tensor ones) and never by quantizing again: the restored engine is
    byte-identical to the one snapshotted."""
    if per_channel:
        ex_layers = tuple(
            None if d is None else ExportedLayer(
                w_q=np.asarray(d["w_q"], np.int8),
                scale=np.asarray(d["w_scale"], np.float32),
                thr_int=np.asarray(d["thr_int"], np.int32))
            for d in arrays)
        exported = ExportedNetwork(name=name, weight_bits=target.weight_bits,
                                   layers=ex_layers)
        base = deploy(exported, spec, cfg, n_cores=1, device=device)
    else:
        exported = None
        layers = []
        for layer, d in zip(spec.layers, arrays):
            if layer.kind in ("conv", "fc"):
                geometry = {}
                if layer.kind == "conv":
                    c = layer.conv
                    geometry = dict(kh=c.kh, kw=c.kw, stride=c.stride,
                                    padding=c.padding)
                neuron = (layer.conv.neuron if layer.kind == "conv"
                          else layer.fc.neuron)
                layers.append(EngineLayer(
                    kind=layer.kind, neuron=neuron,
                    w_q=torch.tensor(np.asarray(d["w_q"], np.int8),
                                     device=device),
                    w_scale=float(d["w_scale"]),
                    thr_int=int(d["thr_int"]), **geometry))
            elif layer.kind == "pool":
                layers.append(EngineLayer(kind="pool"))
            else:
                layers.append(EngineLayer(kind="adaptive_pool",
                                          target_hw=layer.target_hw))
        base = SNNEngine(spec=spec, cfg=cfg, layers=tuple(layers),
                         device=device)
    if target.autotune and cfg.backend == "fused":
        base = _autotune_engine(base, spec, target, cfg)
    engine = _apply_schedule(base, spec, target, cfg)
    return CompiledSNN(spec=spec, target=target, engine=engine,
                       base_engine=base, exported=exported)


def read_snapshot_meta(path, step: Optional[int] = None) -> dict:
    """A :meth:`CompiledSNN.snapshot` artifact's metadata, nothing loaded:
    format version, target, spec geometry, session geometries, the
    caller's ``extra`` and the resolved ``step``.  ``FileNotFoundError``
    when no step exists, ``ValueError`` when the checkpoint is not a
    session snapshot."""
    ckpt = Checkpointer(str(path))
    if step is None:
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no snapshot steps under {ckpt.directory} — was "
                "CompiledSNN.snapshot called?")
    with open(os.path.join(ckpt.directory,
                           f"step_{step:09d}", "meta.json")) as f:
        meta = json.load(f)
    info = meta.get(_SNAPSHOT_META_KEY)
    if info is None:
        raise ValueError(
            f"checkpoint step {step} under {ckpt.directory} is not a spidr "
            f"session snapshot (no {_SNAPSHOT_META_KEY!r} metadata) — "
            "weight artifacts from CompiledSNN.save load via spidr.load; "
            "snapshots come from CompiledSNN.snapshot")
    return dict(info, step=int(step))


def restore(path, spec: Optional[SNNSpec] = None,
            compiled: Optional[CompiledSNN] = None,
            step: Optional[int] = None, device=None) -> CompiledSNN:
    """Resume a serving deployment from a :meth:`CompiledSNN.snapshot`
    (written by this package or the reference).

    Validates the checkpoint (crc32 per leaf, format and schema versions),
    rebuilds the deployment from its integer weights onto the snapshot's
    :class:`DeployTarget`, reopens every serialized session and reloads
    its slots, table and clocks: every resumed stream then emits spikes,
    readouts and cumulative cycle/energy attribution byte-identical to the
    uninterrupted run.  ``device=None`` means the card (``"cpu"`` for the
    plain PyTorch kernels).

    ``spec`` is only needed for networks that are not one of the paper's.
    Pass ``compiled`` to resume onto a prepared replica (on its device):
    it must have the identical target and byte-identical weights, or
    ``ValueError``.
    """
    with obs_trace.default_tracer().span("snapshot.restore",
                                         cat="durability", path=str(path)):
        return _restore(path, spec, compiled, step, device)


def _restore(path, spec: Optional[SNNSpec], compiled: Optional[CompiledSNN],
             step: Optional[int], device) -> CompiledSNN:
    info = read_snapshot_meta(path, step)
    step = info["step"]
    target = _target_from_info(info["target"])
    per_channel = info["provenance"] == "exported"
    sinfo = dict(info["spec"])
    if compiled is not None:
        spec = compiled.spec
    if spec is None:
        try:
            spec = _spec_for(sinfo["name"])
        except ValueError:
            raise ValueError(
                f"snapshot names network {sinfo['name']!r}, which is not "
                "one of the paper's specs — pass the SNNSpec it was "
                "compiled with: restore(path, spec=...)") from None
        spec = dataclasses.replace(spec, input_hw=tuple(sinfo["input_hw"]),
                                   timesteps=int(sinfo["timesteps"]))
    if _spec_info(spec) != sinfo:
        raise ValueError(
            f"spec geometry {_spec_info(spec)} does not match the "
            f"snapshot's {sinfo} — restore onto the network the snapshot "
            "was taken on")
    like = {"layers": _layer_arrays_template(spec, per_channel),
            "sessions": [_session_state_template(spec, s["capacity"],
                                                 target.n_cores)
                         for s in info["sessions"]]}
    tree = Checkpointer(str(path)).restore(step, like)
    if compiled is not None:
        if compiled.target != target:
            raise ValueError(
                f"snapshot was taken on {target}, but the prepared replica "
                f"is compiled for {compiled.target} — migration is only "
                "bit-exact onto the identical DeployTarget")
        for i, (a, b) in enumerate(zip(compiled._layer_arrays(),
                                       tree["layers"])):
            same = (a is None) == (b is None) and (
                a is None or all(np.array_equal(a[k], b[k])
                                 for k in ("w_q", "w_scale", "thr_int")))
            if not same:
                raise ValueError(
                    f"weight layer {i} of the prepared replica is not "
                    "byte-identical to the snapshot's — a session snapshot "
                    "only resumes on the deployment it was taken from")
    else:
        compiled = _compile_from_arrays(
            spec, target, _engine_config(target), tree["layers"],
            per_channel, sinfo["name"], resolve_device(device))
    for geo, sess_state in zip(info["sessions"], tree["sessions"]):
        session = compiled.open_stream(geo["capacity"], geo["chunk_T"])
        session.load_state_dict(sess_state)
    return compiled
