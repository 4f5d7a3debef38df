"""Batched, multi-timestep SNN inference engine (the fused timestep loop).

The path from a DVS event tensor to output spike counts that the chip
takes, in PyTorch:

  events (T, B, H, W, C) --loop over T--> per-timestep layer sweep:
      conv : im2col (input loader)  -> (B*P, F) int8 spike matrix
             fused_lif_gemm_int     -> Vmem' and output spikes
      fc   : flatten -> fused_lif_gemm_int
      pool : maxpool on the spike plane (binary in, binary out)
  readout: summed output spikes ("rate") or last-layer Vmem ("vmem")

Backends:
  * ``"fused"`` — the hand-written CUDA kernels (``kernels/fused_lif_gemm``);
    on CPU tensors their plain PyTorch versions.
  * ``"torch"`` — ``saturate`` + ``neuron_step_int`` on a plain integer
    GEMM: the counterpart of the reference's ``"jnp"`` oracle.

``t_block > 1`` (fused backend) runs each chunk layer-outer: every weight
layer consumes the whole chunk as ``(T, rows, F)`` spike stacks in
``t_block``-sized slabs through ``fused_lif_gemm_int_tblk``, which reads
each weight slice once per slab and carries Vmem across the slab's
timesteps.  Bit-exact with the per-timestep loop for any ``t_block``.

The state is first-class: ``init_state`` + ``run_chunk`` over any
partition of a stream into chunks gives the same final state and readout
as one whole-stream call.  ``run_engine`` is ``init_state`` + one
``run_chunk`` with the batch folded into the GEMM rows.

Spike planes are int8 between layers (the reference keeps float32 0/1
planes; the values are the same).  All accumulators and counters are
int32, as in the reference.  ``build_engine`` quantizes with per-tensor
scales (scalar thresholds); exported networks (``snn.export.deploy``)
carry per-channel scales and ``(K,)`` integer thresholds, which the
kernels take as a vector.  An autotuned layer (``EngineLayer.kcfg``, the
reference's ``(block_m, block_n, block_k, t_blk)`` from
``kernels.autotune`` via ``DeployTarget(autotune=True)``) walks its chunk
in its own ``t_blk`` slabs; one such layer with ``t_blk > 1`` routes the
engine's chunks layer-outer even at ``cfg.t_block == 1``, as the
reference's selector does.  The block fields are accepted for parity: the
CUDA tile is fixed.

Multi-core plans.  ``compile_engine(engine, schedule)`` bakes a
``repro_torch.compiler`` :class:`CoreSchedule` into the engine as the
reference does: each weight layer gets its per-core channel slices of
``w_q`` stacked and zero-padded to the widest (``w_cores``), each core's
``(lo, hi)`` (``core_slices``), and, for per-channel thresholds, the
threshold slices padded with ``v_max + 1`` (``thr_cores``).  They stay on
the host: they describe the placement, and nothing at run time reads them.
The reference then runs a lockstep ``vmap`` over the active cores'
``(F, Kc)`` slices and concatenates their outputs in ``lo`` order.  The
port does not launch once per core.  ``compile_engine`` checks that every
layer's active slices are contiguous and cover ``[0, K)`` (and raises if
not; ``partition_graph`` always cuts them so), which makes the slices in
``lo`` order, without their padding, ``w_q`` and ``thr_int`` again.  As
every output channel of the integer GEMM + neuron step is independent of
the others, the single-core layer update on ``w_q``/``thr_int`` computes
exactly what the reference's stacked per-core calls compute: a plan makes
the same launches as one core, and padded channels never reach a kernel.
On one card a plan changes where the chip's row operations land (the cost
model, ``engine.cost.estimate_multicore_cost``), not the arithmetic.

``device_parallel=True`` is the reference's ``shard_map`` over a ``cores``
mesh, one CUDA device per core (core ``c`` on :func:`_core_devices`'s
``c``-th device): each active core's channel slice of ``w_q``/``thr_int``
(without its padding) is copied to its device once, at compile time
(``EngineLayer.core_devs``); at run time every weight layer copies its
spike matrix (or slab) and the core's Vmem slice there, runs B1/B2 on the
slice, and gathers the outputs back to the engine's device in ``lo``
order.  Bit-exact with one device, as the channels are independent.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..compiler.schedule import CoreSchedule
from ..core.layers import im2col, maxpool2d
from ..core.network import SNNSpec, init_state_shapes
from ..core.neuron import NeuronConfig, neuron_step_int
from ..core.quant import QuantSpec, quantize, saturate
from ..kernels.fused_lif_gemm import (
    DEFAULT_BLOCK,
    fused_lif_gemm_int,
    fused_lif_gemm_int_tblk,
)
from ..kernels.ref import spike_gemm_ref

__all__ = [
    "BACKENDS",
    "ChunkOutput",
    "EngineConfig",
    "EngineLayer",
    "EngineOutput",
    "EngineState",
    "SNNEngine",
    "build_engine",
    "compile_engine",
    "engine_to",
    "init_state",
    "reset_slot",
    "run_chunk",
    "run_engine",
    "run_reference",
]

BACKENDS = ("fused", "torch")
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """How to execute the fused timestep loop."""

    qspec: QuantSpec
    backend: str = "fused"        # "fused" (CUDA kernels) | "torch" (oracle)
    skip_empty: bool = True       # tile-level zero-skipping in the kernels
    block: tuple = DEFAULT_BLOCK  # accepted for parity; the CUDA tile is fixed
    # > 1 routes fused-backend chunks through the layer-outer T_blk path.
    t_block: int = 1

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend {self.backend!r} unsupported — use one of {BACKENDS}")
        if not isinstance(self.t_block, int) or self.t_block < 1:
            raise ValueError(f"t_block must be an integer >= 1, got {self.t_block!r}")


@dataclasses.dataclass(frozen=True)
class EngineLayer:
    """One layer compiled for the integer datapath."""

    kind: str                                # "conv" | "fc" | "pool" | "adaptive_pool"
    neuron: Optional[NeuronConfig] = None
    w_q: Optional[torch.Tensor] = None       # (F, K) int8 on the engine's device
    w_scale: object = None                   # w ~= w_q * scale: a float
                                             # (per-tensor) or a (K,) float32
                                             # array (per-channel, exported)
    thr_int: object = 0                      # integer threshold at this scale:
                                             # int, or (K,) int32 on the device
    kh: int = 0
    kw: int = 0
    stride: int = 1
    padding: int = 0
    target_hw: int = 0                       # adaptive pool target
    # Multi-core placement (set by ``compile_engine`` from a CoreSchedule),
    # as the reference's, on the host: the per-core channel slices of
    # ``w_q`` stacked and zero-padded to the widest slice, and each core's
    # (lo, hi) channel range ((0, 0) = idle core).
    w_cores: Optional[torch.Tensor] = None   # (n_cores, F, Kc) int8
    core_slices: tuple = ()                  # per-core (lo, hi), len n_cores
    # Per-core slices of a per-channel ``thr_int`` (padding v_max + 1, never
    # fires); None when ``thr_int`` is a scalar.
    thr_cores: Optional[torch.Tensor] = None  # (n_cores, Kc) int32
    # Autotuned kernel config override (block_m, block_n, block_k, t_blk),
    # the reference's form; None falls back to ``cfg.block``/``cfg.t_block``.
    kcfg: Optional[tuple] = None
    # device_parallel plans: one (lo, hi, device, w (F, hi - lo) int8, thr)
    # per active core in ``lo`` order, the slice resident on its device.
    core_devs: tuple = ()


@dataclasses.dataclass(frozen=True)
class SNNEngine:
    spec: SNNSpec
    cfg: EngineConfig
    layers: tuple  # of EngineLayer
    device: torch.device
    # Multi-core plan (None = single-core); ``compile_engine`` sets both.
    schedule: Optional[CoreSchedule] = None
    device_parallel: bool = False


@dataclasses.dataclass
class EngineOutput:
    readout: torch.Tensor       # (B, classes) int32 rate counts or (B,H,W,C) Vmem
    spike_counts: torch.Tensor  # (T, n_weight_layers) output spikes per layer
    input_counts: torch.Tensor  # (T, n_weight_layers) input spikes per layer


@dataclasses.dataclass
class EngineState:
    """Persistent neuron state between chunks of one batch of streams.

    ``vmem``        per-layer int32 Vmem carries (None for pool layers),
                    ``(B, H, W, C)`` / ``(B, N)``.
    ``readout_acc`` cumulative readout: summed output spikes ("rate") or
                    the last weight layer's Vmem ("vmem").
    ``out_counts``  ``(n_weight_layers, B)`` cumulative output spikes.
    ``in_counts``   ``(n_weight_layers, B)`` cumulative input spikes.
    """

    vmem: tuple
    readout_acc: torch.Tensor
    out_counts: torch.Tensor
    in_counts: torch.Tensor


@dataclasses.dataclass
class ChunkOutput:
    """What one ``run_chunk`` call reports beside the new state.

    ``readout`` is the cumulative readout after the chunk.  The count
    fields are per-timestep stacks for this chunk — ``(chunk_T, L)``
    batch-summed and ``(chunk_T, L, B)`` per sample — or None under
    ``collect_counts=False``.  ``readouts`` is the per-timestep cumulative
    readout ``(chunk_T, B, ...)``, only under ``collect_readouts=True``.
    """

    readout: torch.Tensor
    spike_counts: Optional[torch.Tensor] = None
    input_counts: Optional[torch.Tensor] = None
    slot_spike_counts: Optional[torch.Tensor] = None
    slot_input_counts: Optional[torch.Tensor] = None
    readouts: Optional[torch.Tensor] = None


def build_engine(spec: SNNSpec, params, cfg: EngineConfig,
                 device=None) -> SNNEngine:
    """Quantize float params into the integer engine (per-tensor scales).

    ``params`` is one float ``(fan_in, c_out)`` tensor (or array) per weight
    layer and None per pool layer.  Quantization runs where the parameters
    lie; the integer weights then move to ``device`` (None = the card).
    """
    dev = resolve_device(device)
    layers = []
    for layer, p in zip(spec.layers, params):
        if layer.kind in ("conv", "fc"):
            neuron = layer.conv.neuron if layer.kind == "conv" else layer.fc.neuron
            w_q, scale = quantize(torch.as_tensor(p), cfg.qspec)
            scale_f = float(scale)
            geometry = {}
            if layer.kind == "conv":
                c = layer.conv
                geometry = dict(kh=c.kh, kw=c.kw, stride=c.stride, padding=c.padding)
            layers.append(EngineLayer(
                kind=layer.kind, neuron=neuron,
                w_q=w_q.to(dev).contiguous(), w_scale=scale_f,
                # Python's round: half-to-even in float64, as the reference.
                thr_int=int(round(neuron.threshold / scale_f)),
                **geometry))
        elif layer.kind == "pool":
            layers.append(EngineLayer(kind="pool"))
        elif layer.kind == "adaptive_pool":
            layers.append(EngineLayer(kind="adaptive_pool",
                                      target_hw=layer.target_hw))
        else:
            raise ValueError(f"unknown layer kind {layer.kind!r}")
    return SNNEngine(spec=spec, cfg=cfg, layers=tuple(layers), device=dev)


def compile_engine(engine: SNNEngine, schedule: CoreSchedule,
                   device_parallel: Optional[bool] = None) -> SNNEngine:
    """Bake a compiler :class:`CoreSchedule` into an executable engine.

    Builds every weight layer's ``w_cores``/``core_slices``/``thr_cores``
    exactly as the reference's ``_compile_engine`` does, and checks that
    the active slices are contiguous over ``[0, K)``: that check is what
    makes the plan compute what one core computes, so the layers keep
    running on ``w_q``/``thr_int`` (module docstring).  Bit-exact with the
    single-core engine under any chunking.

    ``device_parallel=True`` places core ``c``'s channel slice on the
    ``c``-th device of :func:`_core_devices` (the CUDA devices) and runs
    each layer's cores there (module docstring); ``ValueError`` when the
    host has fewer than ``n_cores`` devices, as the reference asserts.
    ``None`` auto-selects as the reference does: across devices when the
    host has ``n_cores`` of the engine's device type, on the engine's one
    device otherwise.  False keeps the plan on one device.
    """
    if engine.schedule is not None:
        raise ValueError("engine already carries a schedule")
    qspec = engine.cfg.qspec
    for ls in schedule.layers:
        if ls.plan.spec != qspec:
            raise ValueError(
                f"schedule selected {ls.plan.spec} for layer {ls.node} but "
                f"the engine executes {qspec}; precision-exploring schedules "
                "(allowed_specs) are for cost analysis, not execution")
    n_cores = schedule.n_cores
    devices = _core_devices()
    if device_parallel is None:
        device_parallel = (1 < n_cores <= len(devices)
                           and devices[0].type == engine.device.type)
    if device_parallel and n_cores > len(devices):
        raise ValueError(f"device_parallel needs {n_cores} devices, "
                         f"host has {len(devices)}")
    by_node = {ls.node: ls for ls in schedule.layers}
    new_layers = []
    for idx, el in enumerate(engine.layers):
        if el.kind not in ("conv", "fc"):
            new_layers.append(el)
            continue
        el = _place_layer(el, by_node[idx], n_cores, qspec)
        if device_parallel and n_cores > 1:
            el = _spread_layer(el, devices)
        new_layers.append(el)
    return dataclasses.replace(engine, layers=tuple(new_layers),
                               schedule=schedule,
                               device_parallel=bool(device_parallel))


def _core_devices() -> list:
    """The devices a ``device_parallel`` plan's cores run on, core ``c`` on
    the ``c``-th: the host's CUDA devices in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _spread_layer(el: EngineLayer, devices: list) -> EngineLayer:
    """Copy each active core's channel slice (no padding) to its device."""
    per_channel = isinstance(el.thr_int, torch.Tensor) and el.thr_int.ndim > 0
    active = sorted((c for c, (lo, hi) in enumerate(el.core_slices) if hi > lo),
                    key=lambda c: el.core_slices[c][0])
    core_devs = []
    for c in active:
        lo, hi = el.core_slices[c]
        dev = devices[c]
        thr = el.thr_int[lo:hi].contiguous().to(dev) if per_channel else el.thr_int
        core_devs.append((lo, hi, dev, el.w_q[:, lo:hi].contiguous().to(dev), thr))
    return dataclasses.replace(el, core_devs=tuple(core_devs))


def engine_to(engine: SNNEngine, device) -> SNNEngine:
    """``engine`` with its weights and per-channel thresholds copied to
    ``device`` (a fleet replica's device).  The host-side plan fields and a
    ``device_parallel`` plan's per-core copies stay where they are."""
    dev = torch.device(device)

    def move(x):
        return x.to(dev).contiguous() if isinstance(x, torch.Tensor) else x

    layers = tuple(el if el.w_q is None else dataclasses.replace(
        el, w_q=move(el.w_q), thr_int=move(el.thr_int)) for el in engine.layers)
    return dataclasses.replace(engine, layers=layers, device=dev)


def _place_layer(el: EngineLayer, ls, n_cores: int,
                 qspec: QuantSpec) -> EngineLayer:
    """One weight layer's per-core slices (the reference's construction),
    after checking that they tile ``[0, K)`` in ``lo`` order."""
    f, k = el.w_q.shape
    if k != ls.out_channels:
        raise ValueError(f"layer {ls.node}: the engine has {k} output "
                         f"channels, the schedule {ls.out_channels}")
    order = sorted(ls.slices, key=lambda s: s.lo)
    edges = [0] + [s.hi for s in order]
    if [s.lo for s in order] != edges[:-1] or edges[-1] != k \
            or any(s.hi <= s.lo for s in order):
        raise ValueError(
            f"layer {ls.node}: channel slices "
            f"{[(s.core, s.lo, s.hi) for s in order]} are not contiguous "
            f"over [0, {k}) — the single-core update would not equal the "
            "per-core computation")
    kc = max(s.width for s in ls.slices)
    w_np = el.w_q.cpu().numpy()
    w_cores = np.zeros((n_cores, f, kc), np.int8)
    core_slices = [(0, 0)] * n_cores
    per_channel = isinstance(el.thr_int, torch.Tensor) and el.thr_int.ndim > 0
    thr_np = el.thr_int.cpu().numpy() if per_channel else None
    thr_cores = (np.full((n_cores, kc), qspec.v_max + 1, np.int32)
                 if per_channel else None)
    for s in ls.slices:
        w_cores[s.core, :, :s.width] = w_np[:, s.lo:s.hi]
        core_slices[s.core] = (s.lo, s.hi)
        if per_channel:
            thr_cores[s.core, :s.width] = thr_np[s.lo:s.hi]
    return dataclasses.replace(
        el, w_cores=torch.from_numpy(w_cores), core_slices=tuple(core_slices),
        thr_cores=None if thr_cores is None else torch.from_numpy(thr_cores))


# ---------------------------------------------------------------------------
# One fused layer-timestep, and a slab of timesteps.
# ---------------------------------------------------------------------------
def _kernel_args(el: EngineLayer, cfg: EngineConfig, thr, block=None) -> dict:
    n = el.neuron
    return dict(threshold=thr,
                leak_shift=n.leak_shift if n.model == "lif" else 0,
                soft_reset=(n.reset == "soft"),
                vmem_bits=cfg.qspec.vmem_bits,
                block=cfg.block if block is None else block,
                skip_empty=cfg.skip_empty)


def _on_cores(el: EngineLayer, s: torch.Tensor, v2: torch.Tensor, update):
    """A ``device_parallel`` layer: each core's slice on its own device.

    ``update(s, w, thr, v)`` runs one core's ``(F, Kc)`` slice against the
    spikes (copied to the core's device) and the core's ``(rows, Kc)``
    Vmem slice; its ``(..., Kc)`` outputs come back to ``v2``'s device and
    are concatenated in ``lo`` order, which restores the channel layout.
    """
    home = v2.device
    v_parts, s_parts = [], []
    for lo, hi, dev, w, thr in el.core_devs:
        # One copy either way: across devices ``to`` lays the slice out
        # densely; on the same device it aliases and ``contiguous`` copies.
        v_c, s_c = update(s.to(dev), w, thr, v2[..., lo:hi].to(dev).contiguous())
        v_parts.append(v_c.to(home))
        s_parts.append(s_c.to(home))
    return torch.cat(v_parts, dim=-1), torch.cat(s_parts, dim=-1)


def _core_update(el: EngineLayer, s2: torch.Tensor, w: torch.Tensor, thr,
                 v2: torch.Tensor, cfg: EngineConfig):
    """(rows, F) spikes x (F, K) weights + (rows, K) Vmem -> (v', s)."""
    if cfg.backend == "fused":
        return fused_lif_gemm_int(s2, w, v2, **_kernel_args(el, cfg, thr))
    partial = saturate(spike_gemm_ref(s2, w), cfg.qspec)
    n = el.neuron
    # leak_shift=0 means "no leak" (the kernels' convention); neuron_step_int
    # would compute v - (v >> 0) = 0, so route that case through IF dynamics.
    if n.model == "lif" and n.leak_shift == 0:
        n = dataclasses.replace(n, model="if")
    return neuron_step_int(v2, partial, n, cfg.qspec, thr)


def _layer_update(el: EngineLayer, s2: torch.Tensor, v2: torch.Tensor,
                  cfg: EngineConfig):
    """One layer-timestep, on the engine's device or on the plan's cores."""
    if el.core_devs:
        return _on_cores(el, s2, v2, lambda s, w, thr, v: _core_update(
            el, s, w, thr, v, cfg))
    return _core_update(el, s2, el.w_q, el.thr_int, v2, cfg)


def _layer_kcfg(el: EngineLayer, cfg: EngineConfig):
    """(gemm block, t_blk) for one layer: autotuned override or config."""
    if el.kcfg is not None:
        bm, bn, bk, tb = el.kcfg
        return (bm, bn, bk), tb
    return cfg.block, cfg.t_block


def _layer_update_tblk(el: EngineLayer, s_stack: torch.Tensor,
                       v2: torch.Tensor, cfg: EngineConfig):
    """Walk a (T, rows, F) spike stack through one layer in T_blk slabs
    (the layer's autotuned ``t_blk`` when it has one).

    The remainder slab is simply shorter; the Vmem carry threads through
    the slabs, so the result is bit-exact under any slab geometry.
    """
    block, tb = _layer_kcfg(el, cfg)

    def slab(s, w, thr, v):
        return fused_lif_gemm_int_tblk(s, w, v, **_kernel_args(el, cfg, thr, block))

    v_parts, s_parts = [], []
    for t0 in range(0, s_stack.shape[0], tb):
        s_slab = s_stack[t0:t0 + tb]
        if el.core_devs:
            v_traj, s = _on_cores(el, s_slab, v2, slab)
        else:
            v_traj, s = slab(s_slab, el.w_q, el.thr_int, v2)
        v_parts.append(v_traj)
        s_parts.append(s)
        v2 = v_traj[-1]
    if len(v_parts) == 1:
        return v_parts[0], s_parts[0]
    return torch.cat(v_parts), torch.cat(s_parts)


def _tblk_active(engine: SNNEngine) -> bool:
    """Route chunks through the layer-outer tiled path?  On the fused
    backend when ``cfg.t_block > 1`` or an autotuned layer's ``t_blk`` is."""
    if engine.cfg.backend != "fused":
        return False
    if engine.cfg.t_block > 1:
        return True
    return any(el.kcfg is not None and el.kcfg[3] > 1
               for el in engine.layers if el.kind in ("conv", "fc"))


def _pool_stack(act: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """maxpool2d over a (T, B, H, W, C) stack via T*B folding."""
    t, b = act.shape[:2]
    out = maxpool2d(act.reshape((t * b,) + act.shape[2:]), window, stride)
    return out.reshape((t, b) + out.shape[1:])


def _forward_t(engine: SNNEngine, state, x_t: torch.Tensor):
    """One timestep through every layer.

    ``x_t`` is a ``(B, H, W, C)`` int8 spike plane.  Returns
    ``(state', (v, s), counts_out, counts_in)`` with per-sample counts of
    shape ``(n_weight_layers, B)``.
    """
    cfg = engine.cfg
    act = x_t
    new_state, counts_out, counts_in, out = [], [], [], None
    for el, v in zip(engine.layers, state):
        if el.kind == "conv":
            counts_in.append((act != 0).sum(dim=(1, 2, 3), dtype=_I32))
            cols = im2col(act, el.kh, el.kw, el.stride, el.padding)  # (B,P,F)
            rows, k = cols.shape[0] * cols.shape[1], el.w_q.shape[1]
            v_next, s = _layer_update(el, cols.reshape(rows, -1),
                                      v.reshape(rows, k), cfg)
            v_next, s = v_next.reshape(v.shape), s.reshape(v.shape)
            new_state.append(v_next)
            counts_out.append(s.sum(dim=(1, 2, 3), dtype=_I32))
            act, out = s.to(torch.int8), (v_next, s)
        elif el.kind == "fc":
            flat = act.reshape(act.shape[0], -1).contiguous()
            counts_in.append((flat != 0).sum(dim=1, dtype=_I32))
            v_next, s = _layer_update(el, flat, v, cfg)
            new_state.append(v_next)
            counts_out.append(s.sum(dim=1, dtype=_I32))
            act, out = s.to(torch.int8), (v_next, s)
        elif el.kind == "pool":
            act = maxpool2d(act)
            new_state.append(None)
        elif el.kind == "adaptive_pool":
            kk = act.shape[1] // el.target_hw
            act = maxpool2d(act, window=kk, stride=kk)
            new_state.append(None)
    return new_state, out, torch.stack(counts_out), torch.stack(counts_in)


def _run_chunk_tiled(engine: SNNEngine, state: EngineState,
                     events: torch.Tensor, collect_counts: bool,
                     collect_readouts: bool):
    """Layer-outer twin of the per-timestep loop: same state, same outputs.

    Materializes ``(chunk_T, ...)`` activation stacks per layer, so memory
    is O(chunk_T); keep ``chunk_T`` a small multiple of ``t_block`` for
    long streams.
    """
    cfg = engine.cfg
    t, b = events.shape[:2]
    act = events
    new_vmem, counts_out, counts_in = [], [], []
    last = None  # (v_traj, s_stack) of the last weight layer
    for el, v in zip(engine.layers, state.vmem):
        if el.kind == "conv":
            counts_in.append((act != 0).sum(dim=(2, 3, 4), dtype=_I32))
            cols = im2col(act.reshape((t * b,) + act.shape[2:]),
                          el.kh, el.kw, el.stride, el.padding)
            p, k = cols.shape[1], el.w_q.shape[1]
            v_traj, s = _layer_update_tblk(el, cols.reshape(t, b * p, -1),
                                           v.reshape(b * p, k), cfg)
            v_traj, s = v_traj.reshape((t,) + v.shape), s.reshape((t,) + v.shape)
            new_vmem.append(v_traj[-1])
            counts_out.append(s.sum(dim=(2, 3, 4), dtype=_I32))
            act, last = s.to(torch.int8), (v_traj, s)
        elif el.kind == "fc":
            flat = act.reshape(t, b, -1).contiguous()
            counts_in.append((flat != 0).sum(dim=2, dtype=_I32))
            v_traj, s = _layer_update_tblk(el, flat, v, cfg)
            new_vmem.append(v_traj[-1])
            counts_out.append(s.sum(dim=2, dtype=_I32))
            act, last = s.to(torch.int8), (v_traj, s)
        elif el.kind == "pool":
            act = _pool_stack(act, 2, 2)
            new_vmem.append(None)
        elif el.kind == "adaptive_pool":
            kk = act.shape[2] // el.target_hw
            act = _pool_stack(act, kk, kk)
            new_vmem.append(None)
    v_traj, s_last = last
    if engine.spec.readout == "rate":
        accs = state.readout_acc[None] + torch.cumsum(s_last, dim=0, dtype=_I32)
    else:
        accs = v_traj
    slot_out = torch.stack(counts_out, dim=1)   # (chunk_T, L, B)
    slot_in = torch.stack(counts_in, dim=1)
    new_state = EngineState(
        vmem=tuple(new_vmem),
        readout_acc=accs[-1],
        out_counts=state.out_counts + slot_out.sum(dim=0, dtype=_I32),
        in_counts=state.in_counts + slot_in.sum(dim=0, dtype=_I32),
    )
    return new_state, ChunkOutput(
        readout=accs[-1],
        spike_counts=slot_out.sum(dim=2, dtype=_I32) if collect_counts else None,
        input_counts=slot_in.sum(dim=2, dtype=_I32) if collect_counts else None,
        slot_spike_counts=slot_out if collect_counts else None,
        slot_input_counts=slot_in if collect_counts else None,
        readouts=accs if collect_readouts else None,
    )


def _n_weight_layers(engine: SNNEngine) -> int:
    return sum(1 for el in engine.layers if el.kind in ("conv", "fc"))


def _init_vmem(engine: SNNEngine, batch: int) -> list:
    return [None if shape is None
            else torch.zeros(shape, dtype=_I32, device=engine.device)
            for shape in init_state_shapes(engine.spec, batch)]


def init_state(engine: SNNEngine, batch: int) -> EngineState:
    """Fresh (all-zero) persistent state for ``batch`` concurrent streams."""
    spec = engine.spec
    vmem = _init_vmem(engine, batch)
    if spec.readout == "rate":
        acc0 = torch.zeros((batch, spec.layers[-1].c_out), dtype=_I32,
                           device=engine.device)
    else:
        # Vmem readout: the last weight layer's Vmem shape.
        acc0 = torch.zeros_like(next(s for s in reversed(vmem) if s is not None))
    n_l = _n_weight_layers(engine)
    return EngineState(
        vmem=tuple(vmem),
        readout_acc=acc0,
        out_counts=torch.zeros((n_l, batch), dtype=_I32, device=engine.device),
        in_counts=torch.zeros((n_l, batch), dtype=_I32, device=engine.device),
    )


def reset_slot(state: EngineState, slot: int) -> EngineState:
    """Zero one batch slot's state, leaving every other slot untouched.

    Slot retirement for continuous batching.  Returns a new state; the
    given one is not modified.
    """
    def zeroed(x, index):
        x = x.clone()
        x[index] = 0
        return x

    return EngineState(
        vmem=tuple(None if v is None else zeroed(v, slot) for v in state.vmem),
        readout_acc=zeroed(state.readout_acc, slot),
        out_counts=zeroed(state.out_counts, (slice(None), slot)),
        in_counts=zeroed(state.in_counts, (slice(None), slot)),
    )


def _as_spikes(engine: SNNEngine, events) -> torch.Tensor:
    """Binary events (any dtype, tensor or array) -> int8 on the device."""
    events = torch.as_tensor(events, device=engine.device)
    if events.ndim != 5:
        raise ValueError(
            f"expected events of shape (T, B, H, W, C), got {tuple(events.shape)}")
    return events.to(torch.int8)


def run_chunk(engine: SNNEngine, state: EngineState, events,
              collect_counts: bool = True, collect_readouts: bool = False):
    """Advance ``state`` by one chunk of timesteps; returns ``(state', out)``.

    Bit-exact under any chunking.  Accumulators are O(1) in the stream
    length; the per-timestep stacks in :class:`ChunkOutput` are
    O(chunk_T) and can be switched off with ``collect_counts=False``.
    """
    events = _as_spikes(engine, events)
    if _tblk_active(engine):
        return _run_chunk_tiled(engine, state, events, collect_counts,
                                collect_readouts)
    rate = engine.spec.readout == "rate"
    vmem, acc = list(state.vmem), state.readout_acc
    oc, ic = state.out_counts, state.in_counts
    c_outs, c_ins, accs = [], [], []
    for t in range(events.shape[0]):
        vmem, (v, s), c_out, c_in = _forward_t(engine, vmem, events[t])
        acc = acc + s if rate else v
        oc, ic = oc + c_out, ic + c_in
        if collect_counts:
            c_outs.append(c_out)
            c_ins.append(c_in)
        if collect_readouts:
            accs.append(acc)
    new_state = EngineState(vmem=tuple(vmem), readout_acc=acc,
                            out_counts=oc, in_counts=ic)
    slot_out = slot_in = sum_out = sum_in = None
    if collect_counts:
        slot_out, slot_in = torch.stack(c_outs), torch.stack(c_ins)  # (T, L, B)
        sum_out = slot_out.sum(dim=2, dtype=_I32)                   # (T, L)
        sum_in = slot_in.sum(dim=2, dtype=_I32)
    return new_state, ChunkOutput(
        readout=acc,
        spike_counts=sum_out,
        input_counts=sum_in,
        slot_spike_counts=slot_out,
        slot_input_counts=slot_in,
        readouts=torch.stack(accs) if collect_readouts else None,
    )


def _run_folded(engine: SNNEngine, events: torch.Tensor) -> EngineOutput:
    _, out = run_chunk(engine, init_state(engine, events.shape[1]), events)
    return EngineOutput(readout=out.readout, spike_counts=out.spike_counts,
                        input_counts=out.input_counts)


def run_engine(engine: SNNEngine, events, batch_mode: str = "fold") -> EngineOutput:
    """Run a whole ``(T, B, H, W, C)`` binary event stream through the engine.

    ``batch_mode="fold"`` folds the batch into the GEMM rows (one
    weight-stationary pass per layer-timestep); ``"vmap"`` runs each sample
    on its own (B = 1) through the same kernels, as the reference's
    ``jax.vmap`` over a single-sample engine computes it.  Identical
    results.  Either is ``init_state`` + one whole-stream ``run_chunk``.
    """
    events = _as_spikes(engine, events)
    if batch_mode == "fold":
        return _run_folded(engine, events)
    if batch_mode == "vmap":
        outs = [_run_folded(engine, events[:, i:i + 1].contiguous())
                for i in range(events.shape[1])]
        return EngineOutput(
            readout=torch.cat([o.readout for o in outs]),
            spike_counts=torch.stack([o.spike_counts for o in outs]).sum(0, dtype=_I32),
            input_counts=torch.stack([o.input_counts for o in outs]).sum(0, dtype=_I32))
    raise ValueError(f"unknown batch_mode {batch_mode!r}")


def run_reference(engine: SNNEngine, events) -> EngineOutput:
    """Python-loop integer reference over the same quantized parameters,
    always on the ``"torch"`` backend: the ground truth for the engine."""
    ref_engine = dataclasses.replace(
        engine, cfg=dataclasses.replace(engine.cfg, backend="torch"))
    events = _as_spikes(ref_engine, events)
    state = _init_vmem(ref_engine, events.shape[1])
    acc = None
    all_out, all_in = [], []
    for t in range(events.shape[0]):
        state, (v, s), c_out, c_in = _forward_t(ref_engine, state, events[t])
        if engine.spec.readout == "rate":
            acc = s if acc is None else acc + s
        else:
            acc = v
        all_out.append(c_out.sum(dim=1, dtype=_I32))
        all_in.append(c_in.sum(dim=1, dtype=_I32))
    return EngineOutput(readout=acc, spike_counts=torch.stack(all_out),
                        input_counts=torch.stack(all_in))
