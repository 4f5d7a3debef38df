"""Kernel autotuner: pick each weight layer's ``t_block`` by measuring it.

The reference's ``repro.kernels.autotune``, on the card.  The fused
Vmem-stationary kernel B2 (``fused_lif_gemm_int_tblk``) walks a chunk in
slabs of ``t_block`` timesteps; which slab depth is fastest depends on the
layer's GEMM shape.  Rather than a heuristic, the tuner races each
candidate on synthetic spikes at a representative sparsity (the
reference's, drawn with numpy from ``seed``) and keeps the fastest: on a
CUDA device timed with CUDA events after a warm-up, on the CPU the plain
path with the host clock.

Candidates.  The reference sweeps MXU blocks as well as ``t_block``; on
the card the tensor-core ring fixes its tile (64-row M tiles, 32-channel
slabs, ``kernels/_ring.py``) and the block is accepted for parity only, so
the port sweeps the reference's ``t_block`` set ``{1, 2, min(4, T), T}``
with the block fields held at :data:`DEFAULT_BLOCK`.  Every candidate is
bit-exact: a bad pick costs time, never correctness.

Winners are cached keyed by ``(rows, fan_in, channels, W_b, V_b)``
(:func:`cache_key`, the reference's string), in memory and optionally in
a JSON file (``SPIDR_AUTOTUNE_CACHE`` or an explicit path) in the
reference's format ``{key: [block_m, block_n, block_k, t_block]}``: a
cache written by either package loads in the other.
``spidr.compile(..., DeployTarget(autotune=True))`` consults this module
per weight layer and bakes the winner into the engine as
``EngineLayer.kcfg``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from .fused_lif_gemm import DEFAULT_BLOCK, fused_lif_gemm_int_tblk

__all__ = [
    "CACHE_ENV",
    "KernelConfig",
    "autotune_layer",
    "cache_key",
    "clear_cache",
    "load_cache",
    "save_cache",
    "sweep_timings",
]

CACHE_ENV = "SPIDR_AUTOTUNE_CACHE"

# Process-wide winner cache: key -> KernelConfig.
_MEMORY_CACHE: dict = {}
# Every sweep raced in this process: key -> {t_block: median seconds}.
_TIMINGS: dict = {}


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point of the tuning space: GEMM block + timestep tile."""

    block_m: int = DEFAULT_BLOCK[0]
    block_n: int = DEFAULT_BLOCK[1]
    block_k: int = DEFAULT_BLOCK[2]
    t_block: int = 1

    @property
    def block(self) -> tuple:
        return (self.block_m, self.block_n, self.block_k)

    @property
    def kcfg(self) -> tuple:
        """The ``EngineLayer.kcfg`` tuple form."""
        return (self.block_m, self.block_n, self.block_k, self.t_block)


def cache_key(rows: int, fan_in: int, channels: int,
              weight_bits: int, vmem_bits: int) -> str:
    """Shape+precision signature a tuned config is valid for."""
    return f"r{rows}_f{fan_in}_c{channels}_w{weight_bits}_v{vmem_bits}"


def clear_cache() -> None:
    """Forget every winner (and every sweep's timings) of this process."""
    _MEMORY_CACHE.clear()
    _TIMINGS.clear()


def sweep_timings() -> dict:
    """``{key: {t_block: median seconds}}`` of every sweep raced since the
    last :func:`clear_cache` (a cache hit races nothing)."""
    return {k: dict(v) for k, v in _TIMINGS.items()}


def load_cache(path) -> dict:
    """Load a JSON winner cache into the in-memory cache (merging)."""
    data = json.loads(pathlib.Path(path).read_text())
    loaded = {k: KernelConfig(*v) for k, v in data.items()}
    _MEMORY_CACHE.update(loaded)
    return loaded


def save_cache(path) -> None:
    """Persist the in-memory winner cache as JSON."""
    data = {k: list(v.kcfg) for k, v in sorted(_MEMORY_CACHE.items())}
    pathlib.Path(path).write_text(json.dumps(data, indent=2) + "\n")


def _default_candidates(timesteps: int) -> list:
    """The reference's ``t_block`` axis, 1 (the per-timestep schedule) up
    to the full sample depth, at the default block."""
    tbs = sorted({1, 2, min(4, timesteps), timesteps})
    return [KernelConfig(*DEFAULT_BLOCK, tb) for tb in tbs if tb >= 1]


def _run(cand: KernelConfig, spikes, weights, v0, threshold, vmem_bits: int,
         skip_empty: bool):
    """One chunk under ``cand``'s slab schedule: the final Vmem and the last
    slab's spikes."""
    v, s = v0, None
    for t0 in range(0, spikes.shape[0], cand.t_block):
        v_traj, s = fused_lif_gemm_int_tblk(
            spikes[t0:t0 + cand.t_block], weights, v, threshold=threshold,
            vmem_bits=vmem_bits, block=cand.block, skip_empty=skip_empty)
        v = v_traj[-1]
    return v, s


def _time_candidate(cand: KernelConfig, spikes, weights, v0, threshold,
                    vmem_bits: int, skip_empty: bool, repeats: int) -> float:
    """Median seconds of one chunk under ``cand``'s schedule, after a
    warm-up run: CUDA events on the card, the host clock on the CPU."""
    run = lambda: _run(cand, spikes, weights, v0, threshold,  # noqa: E731
                       vmem_bits, skip_empty)
    dev = spikes.device
    run()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        stream = torch.cuda.current_stream(dev)
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            run()
            end.record(stream)
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def autotune_layer(
    rows: int,
    fan_in: int,
    channels: int,
    weight_bits: int,
    vmem_bits: int,
    *,
    timesteps: int = 8,
    sparsity: float = 0.9,
    skip_empty: bool = True,
    candidates: Optional[list] = None,
    cache_path=None,
    repeats: int = 1,
    seed: int = 0,
    device=None,
) -> KernelConfig:
    """Measure and cache the fastest kernel config for one layer shape.

    ``rows``/``fan_in``/``channels`` are the layer's GEMM dimensions
    (M/K/N); ``timesteps`` and ``sparsity`` shape the synthetic sample the
    candidates race on, on ``device`` (None: the card).  Returns the
    cached winner when the shape+precision key was tuned before (in this
    process, or in the JSON cache at ``cache_path`` /
    ``$SPIDR_AUTOTUNE_CACHE``).  Each raced candidate's median seconds
    are kept for :func:`sweep_timings`.
    """
    key = cache_key(rows, fan_in, channels, weight_bits, vmem_bits)
    if key in _MEMORY_CACHE:
        return _MEMORY_CACHE[key]
    if cache_path is None:
        cache_path = os.environ.get(CACHE_ENV)
    if cache_path and pathlib.Path(cache_path).exists():
        load_cache(cache_path)
        if key in _MEMORY_CACHE:
            return _MEMORY_CACHE[key]

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    spikes = torch.from_numpy(
        (rng.random((timesteps, rows, fan_in)) > sparsity).astype(np.int8)).to(dev)
    w_max = (1 << (weight_bits - 1)) - 1
    weights = torch.from_numpy(rng.integers(
        -w_max - 1, w_max + 1, (fan_in, channels)).astype(np.int8)).to(dev)
    v0 = torch.zeros((rows, channels), dtype=torch.int32, device=dev)
    threshold = max(1, (1 << (vmem_bits - 2)))

    if candidates is None:
        candidates = _default_candidates(timesteps)
    best, best_t = None, float("inf")
    timings = _TIMINGS.setdefault(key, {})
    for cand in candidates:
        dt = _time_candidate(cand, spikes, weights, v0, threshold,
                             vmem_bits, skip_empty, repeats)
        timings[cand.t_block] = dt
        if dt < best_t:
            best, best_t = cand, dt
    _MEMORY_CACHE[key] = best
    if cache_path:
        save_cache(cache_path)
    return best
