"""Timestep pipelining with asynchronous handshaking (paper C7, Sec II-F, Fig 13).

Compute units have data-dependent execution times (spike-count dependent);
neuron units are fixed at 66 cycles (Eq. 3).  A rigid synchronous pipeline
would have to assume worst-case sparsity; SpiDR instead uses asynchronous
handshaking so each unit starts as soon as its operands arrive and stalls
only on true data dependences.

This is a discrete-event simulator of that handshake for a chain of
``n_cm`` compute macros feeding one neuron macro (Mode 2), or three
independent 3-CM chains (Mode 1).  Per timestep t and macro i:

  ready[i][t]   = finish of CM i's compute for t
  CM i's compute for t may start when:
    - CM i has finished its own compute for t-1           (resource)
    - CM i-1 has delivered its partial Vmem for t         (data, chained)
  The delivery costs ``transfer_cycles`` on BOTH sides (the SRAM port is
  busy), matching the Wait/Transfer slots of Fig 13.

Outputs: per-timestep latency, makespan, utilization per unit, and the
synchronous-worst-case makespan for comparison (the paper's motivation).

The same numpy code as ``repro.core.pipeline``, so makespans are
identical.

Streaming: the handshake's only cross-timestep coupling is when each unit
becomes free (``cm_free``/``recv_ready``/``nu_free``).  ``simulate_pipeline``
optionally takes and returns that :class:`PipelineState`, so a stream
processed chunk by chunk — resuming each call from the previous chunk's
final state — yields *exactly* the whole-stream makespan, independent of
how the timesteps are chunked (the streaming session manager relies on
this for chunking-invariant cumulative cycle accounting).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .cim_macro import NEURON_MACRO_CYCLES

__all__ = ["PipelineConfig", "PipelineResult", "PipelineState",
           "ROUTE_CYCLES_PER_SPIKE", "route_cycles", "simulate_pipeline"]

# Per-timestep fixed costs (cycles), derived from Table I:
# reset of partial Vmems + partial-Vmem transfer between units.
RESET_CYCLES = 32          # reset 32 partial Vmem rows
TRANSFER_CYCLES = 64       # move 32 Vmem rows between adjacent macros
PIPE_FILL = 2

# Multi-core extension (Sec II-E): output spikes crossing a core boundary
# travel as AER packets on the inter-core fabric.  Send + receive each take
# one cycle at the core's S2A-style front end — the same 2-cycles-per-spike
# figure as the intra-core sparsity scan (C3/C4), which is what makes the
# spike-routing overhead model consistent with the rest of the cycle model.
ROUTE_CYCLES_PER_SPIKE = 2


def route_cycles(n_spikes: float,
                 cycles_per_spike: int = ROUTE_CYCLES_PER_SPIKE) -> int:
    """Cycles to move ``n_spikes`` AER events across the inter-core fabric."""
    return int(np.ceil(float(n_spikes) * cycles_per_spike))


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_cm: int = 9                 # chained compute macros (mode 2) or 3 (mode 1)
    neuron_cycles: int = NEURON_MACRO_CYCLES
    transfer_cycles: int = TRANSFER_CYCLES
    reset_cycles: int = RESET_CYCLES


@dataclasses.dataclass
class PipelineState:
    """Resumable handshake state (absolute cycles since the stream began).

    Carries everything a chunk-by-chunk simulation needs for *all* of
    :class:`PipelineResult`'s quantities — makespan, busy counters and the
    synchronous-worst-case alternative — to be cumulative since the stream
    began and bit-identical to one whole-stream call, for any chunking.
    """

    cm_free: np.ndarray      # (n_cm,) when each compute macro is next free
    recv_ready: np.ndarray   # (n_cm,) when upstream partials arrive
    nu_free: int             # when the neuron macro is next free
    cm_busy: np.ndarray      # (n_cm,) cumulative busy cycles per macro
    nu_busy: int             # cumulative neuron-macro busy cycles
    total_T: int             # timesteps simulated since the stream began
    worst_compute: int       # max per-timestep CM cycles seen so far

    def to_dict(self) -> dict:
        """Deterministic, alias-free serializable view of the clocks.

        Every value is a fresh int64 numpy array (0-d for scalars): the
        dict can be written through the checkpoint layer and never shares
        storage with the live simulation state.
        """
        return {
            "cm_free": np.asarray(self.cm_free, np.int64).copy(),
            "recv_ready": np.asarray(self.recv_ready, np.int64).copy(),
            "nu_free": np.int64(self.nu_free),
            "cm_busy": np.asarray(self.cm_busy, np.int64).copy(),
            "nu_busy": np.int64(self.nu_busy),
            "total_T": np.int64(self.total_T),
            "worst_compute": np.int64(self.worst_compute),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineState":
        """Rebuild a resume point from :meth:`to_dict` output."""
        return cls(
            cm_free=np.asarray(d["cm_free"], np.int64).copy(),
            recv_ready=np.asarray(d["recv_ready"], np.int64).copy(),
            nu_free=int(d["nu_free"]),
            cm_busy=np.asarray(d["cm_busy"], np.int64).copy(),
            nu_busy=int(d["nu_busy"]),
            total_T=int(d["total_T"]),
            worst_compute=int(d["worst_compute"]),
        )

    @classmethod
    def zero(cls, n_cm: int = 9) -> "PipelineState":
        """The stream-start state: identical to passing ``state=None``.

        ``simulate_pipeline`` initializes all clocks/counters to zero when
        no state is given, so resuming from ``zero()`` is bit-identical to
        a fresh simulation — snapshots use it to give never-stepped slots
        a fixed serialized shape instead of a structure-changing ``None``.
        """
        return cls(cm_free=np.zeros(n_cm, np.int64),
                   recv_ready=np.zeros(n_cm, np.int64), nu_free=0,
                   cm_busy=np.zeros(n_cm, np.int64), nu_busy=0,
                   total_T=0, worst_compute=0)


@dataclasses.dataclass
class PipelineResult:
    makespan: int                  # total cycles for all timesteps
    sync_makespan: int             # rigid worst-case-synchronous pipeline
    cm_busy: np.ndarray            # (n_cm,) busy cycles per compute macro
    nu_busy: int
    per_timestep_finish: np.ndarray
    state: PipelineState | None = None   # final state (resume point)
    # When resumed from a prior state, every field above (and the derived
    # speedup/utilization properties) is cumulative since the stream began,
    # except per_timestep_finish which covers only this call's timesteps.

    @property
    def speedup_vs_sync(self) -> float:
        return self.sync_makespan / max(self.makespan, 1)

    @property
    def cm_utilization(self) -> np.ndarray:
        return self.cm_busy / max(self.makespan, 1)


def simulate_pipeline(
    compute_cycles: np.ndarray,  # (timesteps, n_cm) data-dependent CM cycles
    cfg: PipelineConfig | None = None,
    state: PipelineState | None = None,
) -> PipelineResult:
    """Simulate Fig 13's handshake for ``timesteps`` over a CM chain + NU.

    Pass the previous call's ``result.state`` as ``state`` to resume the
    clocks mid-stream: simulating a stream chunk by chunk this way produces
    bit-identical makespans to one whole-stream call, for any chunking.
    """
    cfg = cfg or PipelineConfig()
    T, n_cm = compute_cycles.shape
    assert n_cm == cfg.n_cm, (n_cm, cfg.n_cm)

    # finish[i] = time CM i finished its current timestep's compute+send.
    if state is None:
        cm_free = np.zeros(n_cm, dtype=np.int64)   # when the unit is next free
        recv_ready = np.zeros(n_cm, dtype=np.int64)  # upstream-arrival clocks
        nu_free = 0
        cm_busy = np.zeros(n_cm, dtype=np.int64)
        nu_busy = 0
        prior_T, prior_worst = 0, 0
    else:
        assert state.cm_free.shape == (n_cm,), state.cm_free.shape
        cm_free = state.cm_free.astype(np.int64).copy()
        recv_ready = state.recv_ready.astype(np.int64).copy()
        nu_free = int(state.nu_free)
        cm_busy = state.cm_busy.astype(np.int64).copy()
        nu_busy = int(state.nu_busy)
        prior_T, prior_worst = int(state.total_T), int(state.worst_compute)
    finish_t = np.zeros(T, dtype=np.int64)

    for t in range(T):
        upstream_done = 0
        for i in range(n_cm):
            # Start: unit free AND (for chained macros) upstream partials here.
            start = max(cm_free[i], recv_ready[i])
            work = cfg.reset_cycles + int(compute_cycles[t, i]) + PIPE_FILL
            end_compute = start + work
            # Handshake: transfer occupies both sender (i) and receiver (i+1).
            send_start = max(end_compute, upstream_done)
            end_send = send_start + cfg.transfer_cycles
            cm_busy[i] += work + cfg.transfer_cycles
            cm_free[i] = end_send
            if i + 1 < n_cm:
                recv_ready[i + 1] = end_send
            upstream_done = end_send
        # Neuron macro consumes the chain's final partials.
        nu_start = max(nu_free, upstream_done)
        nu_end = nu_start + cfg.neuron_cycles
        nu_busy += cfg.neuron_cycles
        nu_free = nu_end
        finish_t[t] = nu_end

    # Rigid synchronous alternative: every stage takes the worst case of the
    # whole run (so far, when resumed); stages advance in lockstep (the
    # design the paper avoids).
    worst_compute = max(int(compute_cycles.max()), prior_worst)
    total_T = prior_T + T
    stage = worst_compute + cfg.reset_cycles + PIPE_FILL + cfg.transfer_cycles
    sync_makespan = (n_cm + total_T - 1) * stage + cfg.neuron_cycles * total_T

    return PipelineResult(
        makespan=int(finish_t[-1]),
        sync_makespan=int(sync_makespan),
        cm_busy=cm_busy,
        nu_busy=int(nu_busy),
        per_timestep_finish=finish_t,
        state=PipelineState(cm_free=cm_free, recv_ready=recv_ready,
                            nu_free=int(nu_free), cm_busy=cm_busy.copy(),
                            nu_busy=int(nu_busy), total_T=total_T,
                            worst_compute=worst_compute),
    )
