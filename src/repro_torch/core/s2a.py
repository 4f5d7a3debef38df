"""Spike-to-address converter model (paper C3/C4, Sec II-B/C, Fig 10-11).

The S2A scans the IFspad with a trailing-zero spike detector, pushes
(Y, X) tuples into an even/odd *ping-pong FIFO* pair, and the SRAM
controller drains one FIFO at a time — switching the column peripherals
between even and odd configurations only when the active FIFO empties (or
the other fills).  Consecutive same-parity operations amortize the
peripheral reconfiguration energy (Fig 10: batching 15 ops cuts energy/op
by 1.5x; depth 16 chosen because deeper FIFOs give diminishing returns).

This module is the *cycle/energy accounting* model: given a spike map it
replays the exact controller policy and reports

  * row operations issued (2 per spike: one even + one odd),
  * peripheral switches incurred,
  * average consecutive-run length (the "batch" of Fig 10),
  * compute-macro cycles.

It is deliberately plain Python/numpy — it models control flow that is
sequential in silicon, and runs on the host, never on the card.  The same
code as ``repro.core.s2a``, so every count equals the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["S2AConfig", "S2AStats", "simulate_s2a", "switch_count_batched"]


@dataclasses.dataclass(frozen=True)
class S2AConfig:
    fifo_depth: int = 16  # per-parity FIFO depth (Sec II-C)


@dataclasses.dataclass
class S2AStats:
    spikes: int
    row_ops: int            # even + odd operations issued
    switches: int           # peripheral reconfigurations
    runs: int               # consecutive same-parity bursts
    cycles: int             # compute-macro cycles (1 op/cycle + fill)

    @property
    def mean_run_length(self) -> float:
        return self.row_ops / max(self.runs, 1)


def simulate_s2a(spike_map: np.ndarray, cfg: S2AConfig | None = None) -> S2AStats:
    """Replay the ping-pong controller over a (rows, cols) 0/1 spike map.

    Policy (Sec II-C): the detector fills the EVEN fifo; after an even tuple
    is processed it is re-queued into the ODD fifo.  The controller keeps
    draining the current-parity fifo and switches parity only when it is
    empty or the opposite fifo is full.
    """
    cfg = cfg or S2AConfig()
    ys, xs = np.nonzero(spike_map)
    order = np.lexsort((xs, ys))  # detector scans row-major
    tuples = list(zip(ys[order].tolist(), xs[order].tolist()))

    n = len(tuples)
    if n == 0:
        return S2AStats(0, 0, 0, 0, 0)

    even_fifo: list[tuple[int, int]] = []
    odd_fifo: list[tuple[int, int]] = []
    pending = iter(tuples)
    exhausted = False

    def refill():
        nonlocal exhausted
        while not exhausted and len(even_fifo) < cfg.fifo_depth:
            try:
                even_fifo.append(next(pending))
            except StopIteration:
                exhausted = True

    refill()
    parity = 0  # 0 = even, 1 = odd
    ops = switches = runs = 0
    runs = 1
    while even_fifo or odd_fifo or not exhausted:
        refill()
        active, other = (even_fifo, odd_fifo) if parity == 0 else (odd_fifo, even_fifo)
        if active and (parity == 1 or len(odd_fifo) < cfg.fifo_depth):
            t = active.pop(0)
            ops += 1
            if parity == 0:
                odd_fifo.append(t)  # ping-pong requeue
        else:
            # switch parity: active empty, or odd fifo full (even side).
            if other or not exhausted:
                parity ^= 1
                switches += 1
                runs += 1
            else:
                break
    cycles = ops + 2 if ops else 0  # +2 R/C/S pipeline fill (Eq. 3 analogue)
    return S2AStats(spikes=n, row_ops=ops, switches=switches, runs=runs, cycles=cycles)


def switch_count_batched(n_spikes: int, batch: int) -> int:
    """Closed-form switches when ops are batched ``batch`` per parity.

    Baseline (batch=1) alternates every op: 2*n - 1 switches for 2*n ops.
    Batching b consecutive same-parity ops gives ceil(2*n / b) - 1.
    """
    if n_spikes == 0:
        return 0
    total_ops = 2 * n_spikes
    return int(np.ceil(total_ops / batch)) - 1
