"""Streaming stateful serving: persistent-Vmem sessions over one batched step.

SpiDR's defining behavior is that a layer's membrane potentials never leave
the CIM macro between timesteps — events handshake in asynchronously and
accumulate into *resident* state.  A :class:`StreamSessionManager` keeps an
:class:`~repro_torch.engine.inference.EngineState` on the engine's device
whose batch axis is a bank of ``capacity`` *slots*, each slot holding the
persistent Vmem of one live event stream, and multiplexes every live
stream's next chunk of timesteps into **one fixed-shape batched
``run_chunk``** per tick: ``(chunk_T, capacity, H, W, C)`` events, always.
Every tick therefore launches the same kernels at the same shapes — B1
(``fused_lif_gemm_int``) once per weight layer per timestep at
``t_block=1``, B2 (``fused_lif_gemm_int_tblk``) once per weight layer per
slab at ``t_block>1`` — and makes one host-to-device copy (the events) and
three device-to-host copies (the per-timestep readouts and the per-slot
output and input spike counts).

Slot lifecycle (continuous batching over neuron state instead of KV cache):

  open()   -> allocate a free slot (already all-zero: see ``close``)
  step()   -> pack each live stream's chunk into (chunk_T, capacity, H, W, C)
              — slots without a stream contribute all-zero event planes,
              which the kernels' tile-level zero-skip eliminates — then
              advance every slot in one ``run_chunk``
  close()  -> retire the slot: zero its state so it is inert until reuse

Per-slot accounting rides on the engine's per-sample spike counters: each
tick, every *active* slot's ``(chunk_T, n_layers)`` input-spike counts are
priced with ``engine/cost.py`` (async-pipeline cycles + calibrated energy)
and accumulated on the slot.  Inactive slots are never charged.

Exactness contract: batch slots never interact inside the engine (GEMM
rows are independent, pooling is per sample), so a stream served through
the manager — whatever the chunk size, whatever else shares the batch,
however often slots around it are retired and reused — produces spikes and
readouts bit-identical to a whole-stream ``run_engine`` call on that stream
alone, and every ``SlotUpdate`` equals the reference's
(``repro.engine.streaming``) on the same chunks.  A multi-core plan rides
through unchanged; only the pricing switches to ``estimate_multicore_cost``
(one resumable clock set per core per slot, additive routing cycles), and
each ``SlotUpdate`` carries the stream's per-core cycles and imbalance.

Durability: :meth:`StreamSessionManager.state_dict` is the session as fresh
host numpy arrays in the reference's dtypes and layout (so the checkpoint
leaves of the two packages are byte-identical);
:meth:`~StreamSessionManager.load_state_dict` and
:meth:`~StreamSessionManager.import_slot` copy a snapshot *into* the
session's own tensors, never aliasing the caller's arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core.pipeline import PipelineState
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .cost import estimate_cost, estimate_multicore_cost
from .inference import SNNEngine, init_state, run_chunk

__all__ = ["SESSION_SCHEMA_VERSION", "SlotUpdate", "StreamSessionManager"]

# Serialized-session schema version (see ``StreamSessionManager.state_dict``),
# the reference's.  ``load_state_dict`` refuses newer schemas.
SESSION_SCHEMA_VERSION = 1


@dataclasses.dataclass
class SlotUpdate:
    """Incremental reply for one stream after one session tick."""

    slot: int
    timesteps: int               # cumulative timesteps consumed by the stream
    readout: np.ndarray          # cumulative readout at ``timesteps``
    chunk_spikes: int            # output spikes this chunk (all layers)
    cycles: int                  # cumulative async-pipeline makespan cycles
    energy_uj: float             # cumulative calibrated energy
    spikes: int = 0              # cumulative output spikes (all layers)
    # Multi-core plans only: the stream's cumulative per-core cycles and the
    # current load imbalance (max/mean busy).  None/0 on one core.
    per_core_cycles: Optional[np.ndarray] = None
    load_imbalance: float = 0.0
    # This chunk's (t, n_layers) input-spike counts, only when the manager
    # was built with ``collect_chunk_counts=True`` (``--trace-out`` re-prices
    # finished streams with ``collect_timeline=True``).
    input_counts: Optional[np.ndarray] = None


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name the same card when the current one is 0."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == \
        (b.index if b.index is not None else current)


def _host(t: torch.Tensor) -> np.ndarray:
    """A fresh host copy (on the CPU ``.numpy()`` alone would alias)."""
    return t.detach().to("cpu", copy=True).numpy()


class StreamSessionManager:
    """Multiplex up to ``capacity`` live event streams onto one engine.

    ``step(chunks)`` takes ``{slot: events}`` with ``events`` of shape
    ``(t, H, W, C)``, ``t <= chunk_T`` (a shorter *final* chunk is
    zero-padded and the readout is taken at the true last timestep), and
    returns ``{slot: SlotUpdate}``.

    The bit-exactness contract is enforced: every open slot must deliver a
    chunk on every tick (an idle open slot would advance its Vmem through
    zero-input timesteps the whole-stream run never saw), and a slot that
    delivered a short chunk has ended its stream and must be ``close()``d
    before the next tick.  Violations raise ``ValueError`` before any
    state is touched.

    The session lives on its engine's device.  ``device`` is accepted for
    the reference's signature: None or the engine's device.  A session on
    another device runs an engine copied there:
    ``CompiledSNN.open_stream(device=...)`` makes (and caches) that copy, as
    the fleet's replicas do.
    """

    def __init__(self, engine: SNNEngine, capacity: int = 4,
                 chunk_T: int = 2, *, metrics=None, tracer=None,
                 collect_chunk_counts: bool = False, device=None):
        if capacity < 1 or chunk_T < 1:
            raise ValueError(f"capacity and chunk_T must be >= 1, got "
                             f"{capacity} and {chunk_T}")
        if device is not None and not _same_device(torch.device(device),
                                                   engine.device):
            raise ValueError(
                f"a session lives on its engine's device ({engine.device}), "
                f"not on {device} — open it through "
                "CompiledSNN.open_stream(device=...), which runs the "
                "deployment's engine copied to that device (the serving "
                "fleet's replica placement, ROADMAP A9)")
        self.engine = engine
        self.capacity = capacity
        self.chunk_T = chunk_T
        self.device = engine.device
        spec = engine.spec
        self._frame_shape = tuple(spec.input_hw) + (spec.in_channels,)
        # Telemetry (repro_torch.obs).  None binds the process-wide defaults
        # (disabled unless obs.enable_metrics()/enable_tracing() is called;
        # enabling is retroactive since the objects are shared); False pins
        # telemetry off for this session.  Every record site is one
        # truthiness check when off.
        self._metrics = (obs_metrics.default_registry() if metrics is None
                         else (metrics or obs_metrics.MetricsRegistry(False)))
        self._tracer = (obs_trace.default_tracer() if tracer is None
                        else (tracer or obs_trace.Tracer(enabled=False)))
        self._collect_chunk_counts = bool(collect_chunk_counts)
        self._m = None  # metric handles, bound on the first enabled tick
        # Position-weighted input-plane size per timestep: the sparsity
        # denominator, the cost model's definition.
        self._positions_per_t = float(
            sum(s.fan_in * s.out_positions for s in spec.layer_shapes()))
        self.state = init_state(engine, capacity)
        self.active = [False] * capacity
        self.ended = [False] * capacity   # delivered a short (final) chunk
        # Per-slot cumulative accounting (host side, O(capacity)).
        self.slot_timesteps = np.zeros(capacity, np.int64)
        self.slot_spikes = np.zeros(capacity, np.int64)
        self.slot_cycles = np.zeros(capacity, np.int64)
        self.slot_energy_uj = np.zeros(capacity, np.float64)
        # Resumable async-handshake clocks per slot (chunking-invariant
        # cycle accounting); a list per slot on a multi-core plan, plus the
        # cumulative per-core routing cycles.
        self._pipe_state = [None] * capacity
        self._schedule = engine.schedule
        n_cores = engine.schedule.n_cores if engine.schedule else 1
        self._slot_route_cycles = np.zeros((capacity, n_cores), np.int64)
        self.slot_core_cycles = np.zeros((capacity, n_cores), np.int64)
        self.slot_imbalance = np.ones(capacity, np.float64)
        self.ticks = 0

    # -- lifecycle ---------------------------------------------------------
    def open(self) -> Optional[int]:
        """Allocate a slot for a new stream; None if the session is full.

        An inactive slot is already all-zero (``init_state`` zeroed every
        slot and ``close()`` re-zeroes on retirement): admission is free.
        """
        for i in range(self.capacity):
            if not self.active[i]:
                self.active[i] = True
                self.ended[i] = False
                self.slot_timesteps[i] = 0
                self.slot_spikes[i] = 0
                self.slot_cycles[i] = 0
                self.slot_energy_uj[i] = 0.0
                self._pipe_state[i] = None
                self._slot_route_cycles[i] = 0
                self.slot_core_cycles[i] = 0
                self.slot_imbalance[i] = 1.0
                return i
        return None

    def close(self, slot: int) -> None:
        """Retire a stream: zero the slot so it is inert until reused."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.active[slot] = False
        self.ended[slot] = False
        st = self.state
        for v in st.vmem:
            if v is not None:
                v[slot] = 0
        st.readout_acc[slot] = 0
        st.out_counts[:, slot] = 0
        st.in_counts[:, slot] = 0

    @property
    def occupancy(self) -> int:
        return sum(self.active)

    # -- telemetry ---------------------------------------------------------
    def _metric_handles(self):
        """Bind (and cache) the session's metric objects on first use."""
        if self._m is None:
            reg = self._metrics
            self._m = {
                "ticks": reg.counter(
                    "spidr_session_ticks_total", "Session step() calls"),
                "timesteps": reg.counter(
                    "spidr_stream_timesteps_total",
                    "Timesteps consumed across all streams"),
                "in_spikes": reg.counter(
                    "spidr_stream_input_spikes_total",
                    "Layer-input spikes across all streams"),
                "out_spikes": reg.counter(
                    "spidr_stream_output_spikes_total",
                    "Layer-output spikes across all streams"),
                "cycles": reg.counter(
                    "spidr_stream_cycles_total",
                    "Async-pipeline makespan cycle increments"),
                "energy": reg.counter(
                    "spidr_stream_energy_uj_total",
                    "Calibrated energy across all streams (uJ)"),
                "occupancy": reg.gauge(
                    "spidr_session_occupancy",
                    "Open slots at the last tick"),
                "sparsity": reg.histogram(
                    "spidr_chunk_sparsity",
                    "Per-slot per-chunk input sparsity",
                    edges=obs_metrics.FRACTION_BUCKETS),
                "tile_frac": reg.histogram(
                    "spidr_chunk_nonzero_tile_frac",
                    "Per-slot per-chunk nonzero event-tile fraction "
                    "(zero-skip opportunity)",
                    edges=obs_metrics.FRACTION_BUCKETS),
                "slot_cycles": [reg.gauge(
                    "spidr_slot_cycles",
                    "Cumulative makespan cycles of the stream in each slot",
                    labels={"slot": i}) for i in range(self.capacity)],
                "slot_energy": [reg.gauge(
                    "spidr_slot_energy_uj",
                    "Cumulative energy of the stream in each slot (uJ)",
                    labels={"slot": i}) for i in range(self.capacity)],
                "slot_imbalance": [reg.gauge(
                    "spidr_slot_load_imbalance",
                    "Per-slot multi-core load imbalance (max/mean busy)",
                    labels={"slot": i}) for i in range(self.capacity)],
            }
        return self._m

    def _nonzero_tile_frac(self, chunk: np.ndarray) -> float:
        """Fraction of ``block_k``-wide event tiles holding any spike, along
        the flattened (H*W*C) axis: the host-side view of how much of the
        input plane the zero-skipping kernels get to skip."""
        t = chunk.shape[0]
        flat = chunk.reshape(t, -1)
        bk = int(self.engine.cfg.block[2])
        k = flat.shape[1]
        n_tiles = -(-k // bk)
        pad = n_tiles * bk - k
        if pad:
            flat = np.pad(flat, ((0, 0), (0, pad)))
        nz = (flat.reshape(t, n_tiles, bk) != 0).any(axis=2)
        return float(nz.sum() / nz.size)

    # -- the batched tick --------------------------------------------------
    def _pack(self, chunks: Dict[int, np.ndarray]):
        """Check the delivery contract and pack the tick's event tensor.

        Raises before any state is touched; returns the host int8 events
        ``(chunk_T, capacity, H, W, C)``, ``{slot: valid timesteps}`` and
        the slots whose stream this chunk ends.
        """
        missing = [i for i in range(self.capacity)
                   if self.active[i] and i not in chunks]
        if missing:
            raise ValueError(
                f"open slots {missing} delivered no chunk this tick; an idle "
                "open slot would advance its Vmem through zero-input "
                "timesteps and diverge from the whole-stream result — "
                "deliver every tick or close() the slot")
        ev = np.zeros((self.chunk_T, self.capacity) + self._frame_shape,
                      np.int8)
        valid, ending = {}, []
        for slot, chunk in chunks.items():
            if not self.active[slot]:
                raise ValueError(f"slot {slot} is not active")
            if self.ended[slot]:
                raise ValueError(
                    f"slot {slot} already delivered a short (final) chunk; "
                    "close() it before the next tick")
            chunk = np.asarray(chunk)
            if chunk.shape[1:] != self._frame_shape:
                raise ValueError(
                    f"slot {slot}: chunk frames {chunk.shape[1:]} are not "
                    f"the network's {self._frame_shape}")
            t = chunk.shape[0]
            if not 1 <= t <= self.chunk_T:
                raise ValueError(
                    f"slot {slot}: a chunk holds 1..{self.chunk_T} "
                    f"timesteps, got {t}")
            if t < self.chunk_T:
                ending.append(slot)
            ev[:t, slot] = chunk
            valid[slot] = t
        return ev, valid, ending

    def _run(self, ev: np.ndarray):
        """One ``run_chunk`` on the device: one copy in, three copies out."""
        events = torch.from_numpy(ev).to(self.device)
        self.state, out = run_chunk(self.engine, self.state, events,
                                    collect_counts=True, collect_readouts=True)
        # Copies: on the CPU the slab path's readouts share storage with the
        # new state, which ``close`` and the next tick overwrite in place.
        return (_host(out.readouts),            # (chunk_T, capacity, ...)
                _host(out.slot_spike_counts),   # (chunk_T, L, capacity)
                _host(out.slot_input_counts))

    def step(self, chunks: Dict[int, np.ndarray]) -> Dict[int, SlotUpdate]:
        """Advance every slot by ``chunk_T`` timesteps in one fused call."""
        ev, valid, ending = self._pack(chunks)
        for slot in ending:
            self.ended[slot] = True

        # Telemetry pre-capture: counters only ever accumulate deltas, so
        # totals are chunking-invariant.
        telemetry = bool(self._metrics)
        if telemetry:
            prev_cycles = self.slot_cycles.copy()
            prev_energy = self.slot_energy_uj.copy()

        if self._tracer:
            with self._tracer.span("run_chunk", cat="session",
                                   tick=self.ticks, slots=len(valid)):
                readouts, slot_out, slot_in = self._run(ev)
                # The copies above wait for the device; synchronize too, so
                # the span closes on an idle device.
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        else:
            readouts, slot_out, slot_in = self._run(ev)
        self.ticks += 1

        updates = {}
        for slot, t in valid.items():
            # Price only this stream's own spikes: its per-slot input counts
            # over the chunk's valid timesteps.  Idle slots are never charged.
            counts = slot_in[:t, :, slot]
            per_core_cycles, imbalance = None, 0.0
            if self._schedule is not None:
                cost = estimate_multicore_cost(
                    self.engine.spec, self._schedule, counts,
                    pipeline_states=self._pipe_state[slot])
                self._pipe_state[slot] = cost.pipeline_states
                # Per-core clocks resume across chunks; routing cycles are
                # additive: cumulative attribution stays chunking-invariant.
                self._slot_route_cycles[slot] += cost.routing_cycles
                makespans = np.array(
                    [pc.makespan_cycles for pc in cost.per_core], np.int64)
                per_core_cycles = makespans + self._slot_route_cycles[slot]
                self.slot_core_cycles[slot] = per_core_cycles
                self.slot_cycles[slot] = int(per_core_cycles.max())
                self.slot_imbalance[slot] = imbalance = cost.load_imbalance
                self.slot_energy_uj[slot] += float(cost.energy_uj)
            else:
                cost = estimate_cost(self.engine.spec, self.engine.cfg.qspec,
                                     counts,
                                     pipeline_state=self._pipe_state[slot])
                self._pipe_state[slot] = cost.pipeline_state
                # Resumed clocks: the makespan is cumulative since the
                # stream began, equal to a whole-stream estimate.
                self.slot_cycles[slot] = int(cost.makespan_cycles)
                self.slot_energy_uj[slot] += float(cost.energy_uj)
            chunk_spikes = int(slot_out[:t, :, slot].sum())
            self.slot_timesteps[slot] += t
            self.slot_spikes[slot] += chunk_spikes
            updates[slot] = SlotUpdate(
                slot=slot,
                timesteps=int(self.slot_timesteps[slot]),
                # At the stream's true last timestep: zero-padded tail steps
                # never leak into a short final chunk's readout.
                readout=readouts[t - 1, slot],
                chunk_spikes=chunk_spikes,
                cycles=int(self.slot_cycles[slot]),
                energy_uj=float(self.slot_energy_uj[slot]),
                spikes=int(self.slot_spikes[slot]),
                per_core_cycles=per_core_cycles,
                load_imbalance=imbalance,
                input_counts=(counts.copy()
                              if self._collect_chunk_counts else None),
            )
        if telemetry:
            self._record_tick(chunks, valid, slot_in, updates,
                              prev_cycles, prev_energy)
        return updates

    def _record_tick(self, chunks, valid, slot_in, updates,
                     prev_cycles, prev_energy) -> None:
        """Fold one tick into the metrics registry (enabled path only)."""
        m = self._metric_handles()
        m["ticks"].inc()
        m["occupancy"].set(self.occupancy)
        for slot, t in valid.items():
            up = updates[slot]
            in_spikes = float(slot_in[:t, :, slot].sum())
            m["timesteps"].inc(t)
            m["in_spikes"].inc(in_spikes)
            m["out_spikes"].inc(up.chunk_spikes)
            # The makespan is monotone per stream; the per-tick increment
            # keeps the counter chunking-invariant.
            m["cycles"].inc(float(self.slot_cycles[slot] - prev_cycles[slot]))
            m["energy"].inc(
                float(self.slot_energy_uj[slot] - prev_energy[slot]))
            density = in_spikes / (self._positions_per_t * t)
            m["sparsity"].observe(float(np.clip(1.0 - density, 0.0, 1.0)))
            m["tile_frac"].observe(
                self._nonzero_tile_frac(np.asarray(chunks[slot])))
            m["slot_cycles"][slot].set(float(self.slot_cycles[slot]))
            m["slot_energy"][slot].set(float(self.slot_energy_uj[slot]))
            if self._schedule is not None:
                m["slot_imbalance"][slot].set(float(self.slot_imbalance[slot]))

    # -- durability: serializable session state ----------------------------
    @property
    def n_cores(self) -> int:
        return self._schedule.n_cores if self._schedule is not None else 1

    def _pipe_dicts(self, slot: int) -> list:
        """Per-core clock dicts for one slot, ``None`` as zeros.

        A never-stepped slot's ``None`` clock is bit-equivalent to
        :meth:`PipelineState.zero`, so every slot serializes to the same
        structure (the fixed-structure checkpoint format needs that).
        """
        ps = self._pipe_state[slot]
        if ps is None:
            per_core = [PipelineState.zero() for _ in range(self.n_cores)]
        elif isinstance(ps, list):
            per_core = ps
        else:
            per_core = [ps]
        return [p.to_dict() for p in per_core]

    def state_dict(self) -> dict:
        """The session's full durable state as fresh host numpy arrays.

        Every live slot's integer engine state (int32), the session table
        (open/ended flags, cumulative per-slot accounting: bool, int64,
        float64) and the resumable handshake clocks (int64), in the
        reference's layout and dtypes.  Nothing aliases the manager's live
        tensors, so ``state_dict`` at tick k stays evidence of tick k
        however the session advances.  Round-tripping through
        :meth:`load_state_dict` is bit-exact.
        """
        st = self.state
        return {
            "schema": np.int64(SESSION_SCHEMA_VERSION),
            "engine_state": {
                "vmem": [None if v is None else _host(v) for v in st.vmem],
                "readout_acc": _host(st.readout_acc),
                "out_counts": _host(st.out_counts),
                "in_counts": _host(st.in_counts),
            },
            "table": {
                "active": np.asarray(self.active, np.bool_),
                "ended": np.asarray(self.ended, np.bool_),
                "timesteps": self.slot_timesteps.copy(),
                "spikes": self.slot_spikes.copy(),
                "cycles": self.slot_cycles.copy(),
                "energy_uj": self.slot_energy_uj.copy(),
                "route_cycles": self._slot_route_cycles.copy(),
                "core_cycles": self.slot_core_cycles.copy(),
                "imbalance": self.slot_imbalance.copy(),
                "ticks": np.int64(self.ticks),
            },
            "clocks": [self._pipe_dicts(s) for s in range(self.capacity)],
        }

    def _check_schema(self, d: dict, what: str) -> None:
        schema = int(d["schema"])
        if schema > SESSION_SCHEMA_VERSION:
            raise ValueError(
                f"{what} schema {schema} is newer than this build's "
                f"{SESSION_SCHEMA_VERSION} — upgrade the code or re-snapshot")

    def load_state_dict(self, d: dict) -> None:
        """Restore the session to a :meth:`state_dict` snapshot, bit-exactly.

        The manager must be over the same engine geometry (capacity, core
        count, layer shapes); a mismatched snapshot raises ``ValueError``
        before any state is touched.  The snapshot's arrays are copied into
        the session's own tensors: a later ``step`` never changes ``d``.
        """
        self._check_schema(d, "session snapshot")
        es, table, clocks = d["engine_state"], d["table"], d["clocks"]
        if len(table["active"]) != self.capacity:
            raise ValueError(
                f"snapshot holds {len(table['active'])} slots but this "
                f"session has capacity {self.capacity} — restore onto a "
                "session opened with the snapshot's geometry")
        if len(clocks) != self.capacity \
                or any(len(c) != self.n_cores for c in clocks):
            raise ValueError(
                f"snapshot clock layout {len(clocks)}x"
                f"{len(clocks[0]) if clocks else 0} does not match this "
                f"session's {self.capacity}x{self.n_cores} (capacity x "
                "cores) — was it taken on a different compiled plan?")
        st = self.state
        pairs = [(cur, new) for cur, new in zip(st.vmem, es["vmem"])]
        if len(es["vmem"]) != len(st.vmem) or any(
                (cur is None) != (new is None)
                or (cur is not None and tuple(cur.shape) != np.shape(new))
                for cur, new in pairs):
            raise ValueError(
                "snapshot Vmem shapes do not match this engine's layers — "
                "restore onto the same network/spec")
        pairs += [(st.readout_acc, es["readout_acc"]),
                  (st.out_counts, es["out_counts"]),
                  (st.in_counts, es["in_counts"])]
        if any(cur is not None and tuple(cur.shape) != np.shape(new)
               for cur, new in pairs):
            raise ValueError(
                "snapshot readout/count shapes do not match this session — "
                "restore onto the same network/spec and capacity")
        for cur, new in pairs:
            if cur is not None:
                cur.copy_(torch.as_tensor(np.asarray(new)))
        self.active = [bool(a) for a in np.asarray(table["active"])]
        self.ended = [bool(e) for e in np.asarray(table["ended"])]
        self.slot_timesteps = np.array(table["timesteps"], np.int64)
        self.slot_spikes = np.array(table["spikes"], np.int64)
        self.slot_cycles = np.array(table["cycles"], np.int64)
        self.slot_energy_uj = np.array(table["energy_uj"], np.float64)
        self._slot_route_cycles = np.array(table["route_cycles"], np.int64)
        self.slot_core_cycles = np.array(table["core_cycles"], np.int64)
        self.slot_imbalance = np.array(table["imbalance"], np.float64)
        self.ticks = int(table["ticks"])
        pipe = []
        for per_core in clocks:
            states = [PipelineState.from_dict(p) for p in per_core]
            pipe.append(states if self._schedule is not None else states[0])
        self._pipe_state = pipe

    # -- live migration: one slot's durable state --------------------------
    def export_slot(self, slot: int) -> dict:
        """One live stream's complete durable state as fresh host arrays.

        The per-slot slice of :meth:`state_dict`.  :meth:`import_slot` of
        the payload on another session over the same engine geometry
        continues the stream bit-exactly.
        """
        if not self.active[slot]:
            raise ValueError(
                f"slot {slot} is not active — only a live stream's state "
                "can be exported for migration")
        st = self.state
        return {
            "schema": np.int64(SESSION_SCHEMA_VERSION),
            "vmem": [None if v is None else _host(v[slot]) for v in st.vmem],
            "readout_acc": _host(st.readout_acc[slot]),
            "out_counts": _host(st.out_counts[:, slot]),
            "in_counts": _host(st.in_counts[:, slot]),
            "table": {
                "ended": bool(self.ended[slot]),
                "timesteps": int(self.slot_timesteps[slot]),
                "spikes": int(self.slot_spikes[slot]),
                "cycles": int(self.slot_cycles[slot]),
                "energy_uj": float(self.slot_energy_uj[slot]),
                "route_cycles": self._slot_route_cycles[slot].copy(),
                "core_cycles": self.slot_core_cycles[slot].copy(),
                "imbalance": float(self.slot_imbalance[slot]),
            },
            "clocks": self._pipe_dicts(slot),
        }

    def import_slot(self, payload: dict, slot: Optional[int] = None) -> int:
        """Install an :meth:`export_slot` payload into a free slot.

        ``slot`` picks the destination (must be free); the default is the
        first free slot, like :meth:`open`.  Mismatched geometry raises
        ``ValueError`` before any state is touched.  The payload is copied
        into the session's tensors.  Returns the destination slot, now
        active and continuing the stream bit-exactly.
        """
        self._check_schema(payload, "slot payload")
        if slot is None:
            slot = next((i for i in range(self.capacity)
                         if not self.active[i]), None)
            if slot is None:
                raise ValueError(
                    "no free slot to import into — close a stream or "
                    "migrate to a session with free capacity")
        elif self.active[slot]:
            raise ValueError(
                f"slot {slot} already holds a live stream — import into a "
                "free slot")
        if len(payload["clocks"]) != self.n_cores:
            raise ValueError(
                f"slot payload carries {len(payload['clocks'])} core "
                f"clock(s) but this session runs {self.n_cores} — was it "
                "exported from a different compiled plan?")
        st = self.state
        pairs = list(zip(st.vmem, payload["vmem"]))
        if len(payload["vmem"]) != len(st.vmem) or any(
                (cur is None) != (new is None)
                or (cur is not None and tuple(cur.shape[1:]) != np.shape(new))
                for cur, new in pairs):
            raise ValueError(
                "slot payload Vmem shapes do not match this engine's "
                "layers — migrate between replicas of the same network/spec")
        dst = [(None if cur is None else cur[slot], new) for cur, new in pairs]
        dst += [(st.readout_acc[slot], payload["readout_acc"]),
                (st.out_counts[:, slot], payload["out_counts"]),
                (st.in_counts[:, slot], payload["in_counts"])]
        if any(cur is not None and tuple(cur.shape) != np.shape(new)
               for cur, new in dst):
            raise ValueError(
                "slot payload readout/count shapes do not match this "
                "session — migrate between replicas of the same network")
        for cur, new in dst:
            if cur is not None:
                cur.copy_(torch.as_tensor(np.asarray(new)))
        table = payload["table"]
        self.active[slot] = True
        self.ended[slot] = bool(table["ended"])
        self.slot_timesteps[slot] = int(table["timesteps"])
        self.slot_spikes[slot] = int(table["spikes"])
        self.slot_cycles[slot] = int(table["cycles"])
        self.slot_energy_uj[slot] = float(table["energy_uj"])
        self._slot_route_cycles[slot] = np.asarray(table["route_cycles"],
                                                   np.int64)
        self.slot_core_cycles[slot] = np.asarray(table["core_cycles"],
                                                 np.int64)
        self.slot_imbalance[slot] = float(table["imbalance"])
        states = [PipelineState.from_dict(p) for p in payload["clocks"]]
        self._pipe_state[slot] = (states if self._schedule is not None
                                  else states[0])
        return slot
