"""The SNN half of the reference's roofline analysis, with the H100's peaks.

:class:`PerfModel` prices the fused Vmem-stationary T_blk kernel per weight
layer: bytes moved under the tiling and MACs at a given tile sparsity,
bound = max(compute, memory), summed over an ``SNNSpec``.  It is the
reference's (``repro.roofline.analysis``) line for line: with the same
``peaks`` it returns the reference's numbers exactly.  Only the default
peaks differ, :data:`HW_PEAK` holding the H100 SXM data sheet's figures
under the reference's keys:

  ``ops_int8``       1979e12  int8 tensor-core ops/s (dense)
  ``flops_bf16``      989e12  bf16 tensor-core flop/s (dense)
  ``hbm_gbps``       3.35e12  HBM3 bytes/s
  ``hbm_gib``          80     HBM capacity, GiB
  ``ici_link_gbps``    50e9   NVLink 4 bytes/s per link (both directions)
  ``ici_links``        18     NVLink 4 links per card (900 GB/s in all)

``CompiledSNN.roofline`` prices a deployment through it.

The LM half is the dry run's roofline (``launch/dryrun.py``), three terms
per (arch x shape x mesh) cell, all per device:

  compute term    = dot FLOPs (local) / ``flops_bf16``          [s]
  memory term     = HBM bytes (local) / ``hbm_gbps``             [s]
  collective term = wire bytes (local) / (links * link rate)     [s]

The reference reads dot FLOPs and collectives out of the post-SPMD HLO
(``parse_hlo``).  Here :func:`count_step` runs the step under a dispatch
mode (:class:`StepCounter`) over DTensors on a fake process group:

  * a mode sees a DTensor op at its *global* shapes, never its local op,
    so the FLOPs of a DTensor op (``torch.utils.flop_counter``'s
    formulas: mm, bmm, addmm, baddbmm, ...) are divided by the product of
    the mesh dims on which its output is ``Shard`` or ``Partial`` -- what
    each device computes, replicated work included, as the post-SPMD HLO
    counts it; an op on plain tensors (inside ``local_map``) is local and
    counted as it is;
  * collectives are the functional collectives DTensor issues (seen by a
    second mode pushed for the duration of each DTensor op, and by the
    first for explicit redistributions): all-reduce counts 2x its local
    result bytes, every other collective 1x, the reference's convention.
    The reference halves its float32 dot-adjacent collectives under
    ``bf16_params`` (its CPU backend upcasts bfloat16 dots before
    partitioning); DTensor moves the real dtype, so nothing is halved;
  * live local bytes: every storage a step allocates on this rank (op
    results, collective buffers) is held by a weak reference until freed;
    the peak is the dry run's ``temp_size_in_bytes``, an estimate (no
    allocator rounding, no fragmentation, no workspace of a library call).

The memory term is the reference's analytic traffic model
(:func:`_memory_bytes`), copied as it is; :func:`analyze_compiled` is the
reference's formula and record keys at these peaks.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["HW_PEAK", "LayerBound", "PerfModel", "StepCounter", "analyze_compiled",
           "count_step"]

HW_PEAK = {
    "flops_bf16": 989e12,    # per card, dense
    "ops_int8": 1979e12,     # int8 tensor-core ops/s, dense
    "hbm_gbps": 3.35e12,     # bytes/s
    "ici_link_gbps": 50e9,   # bytes/s per NVLink 4 link
    "ici_links": 18,         # NVLink 4 links per card
    "hbm_gib": 80.0,         # HBM3 capacity
}


# ---------------------------------------------------------------------------
# SNN kernel performance model: analytic wall-time bounds for the fused
# Vmem-stationary T_blk kernel (kernels.fused_lif_gemm_int_tblk).
#
# A thin, explicit wrapper in the style of DaCe's RooflineModel: peaks in,
# (bytes-moved, MACs-at-sparsity) per layer, bound = max(compute, memory).
# The bound is an ideal-hardware floor: a benchmark divides a measured
# time by it, which normalizes shape, sparsity and tiling out of the wall
# clock.
# ---------------------------------------------------------------------------
def _ceil_to(x: int, b: int) -> int:
    return -(-x // b) * b


@dataclasses.dataclass(frozen=True)
class LayerBound:
    """Roofline bound for one weight layer over a whole event chunk."""

    rows: int                # GEMM M (batch x output positions)
    fan_in: int              # GEMM K
    channels: int            # GEMM N
    timesteps: int
    t_block: int
    macs: float              # MACs actually issued (after tile skipping)
    bytes_moved: float       # HBM bytes under the T_blk tiling
    compute_s: float
    memory_s: float

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s)

    @property
    def bottleneck(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"


class PerfModel:
    """Analytic roofline for the fused SNN hot path.

    ``peaks`` defaults to :data:`HW_PEAK`; pass overrides to model other
    parts (``{"ops_int8": ..., "hbm_gbps": ...}``).  All methods are pure
    and deterministic — the same (shape, precision, tiling, sparsity)
    always prices to the same bound, which is what lets benchmarks commit
    measured/bound ratios as a regression baseline.
    """

    def __init__(self, peaks: Optional[dict] = None):
        self.peaks = dict(HW_PEAK)
        if peaks:
            self.peaks.update(peaks)

    def layer_bound(
        self,
        rows: int,
        fan_in: int,
        channels: int,
        *,
        timesteps: int,
        t_block: int = 1,
        nonzero_tile_frac: float = 1.0,
        block: tuple = (128, 128, 128),
    ) -> LayerBound:
        """Bound one layer's chunk under the T_blk tiling.

        ``nonzero_tile_frac`` is the fraction of (bm x bk) spike tiles
        that carry at least one spike (measure it with
        ``kernels.spike_tile_bitmap``); it scales the MAC term — the
        block-sparsity lever — while the byte terms keep the dense spike
        stream (the bitmap is read either way; weight traffic is decided
        by tiling, not sparsity).

        Byte model of ``fused_lif_gemm_int_tblk`` per chunk:
          * weights: the (K_p x N_p) int8 matrix streams once per m-tile
            per kernel call — ``gm * K_p * N_p * ceil(T / T_blk)``; this
            is the term the Vmem-stationary tiling divides by T_blk;
          * spikes: each (T_blk, bm, bk) int8 stack is read once per
            n-tile — ``T * R_p * K_p * gn``;
          * Vmem carry: the (bm, bn) int32 tile reads once per (i, j)
            per call;
          * outputs: the (T, M, N) int32 trajectory + spike stacks write
            once each.
        """
        bm, bn, bk = block
        t_block = max(1, min(t_block, timesteps))
        r_p, k_p, n_p = _ceil_to(rows, bm), _ceil_to(fan_in, bk), \
            _ceil_to(channels, bn)
        gm, gn = r_p // bm, n_p // bn
        n_calls = -(-timesteps // t_block)

        w_bytes = float(gm * k_p * n_p) * n_calls
        s_bytes = float(timesteps * r_p * k_p) * gn
        v_bytes = 4.0 * r_p * n_p * n_calls
        out_bytes = 2.0 * 4.0 * timesteps * r_p * n_p
        bytes_moved = w_bytes + s_bytes + v_bytes + out_bytes

        macs = float(rows) * fan_in * channels * timesteps \
            * max(0.0, min(1.0, nonzero_tile_frac))
        compute_s = 2.0 * macs / self.peaks["ops_int8"]
        memory_s = bytes_moved / self.peaks["hbm_gbps"]
        return LayerBound(
            rows=rows, fan_in=fan_in, channels=channels,
            timesteps=timesteps, t_block=t_block,
            macs=macs, bytes_moved=bytes_moved,
            compute_s=compute_s, memory_s=memory_s,
        )

    def network_bound(
        self,
        spec,
        *,
        batch: int = 1,
        timesteps: Optional[int] = None,
        t_block: int = 1,
        block: tuple = (128, 128, 128),
        nonzero_tile_fracs=None,
        layer_kcfgs=None,
    ) -> dict:
        """Aggregate per-layer bounds over an ``SNNSpec``.

        ``nonzero_tile_fracs`` is a per-weight-layer list (default: dense,
        1.0); ``layer_kcfgs`` optionally overrides (bm, bn, bk, t_blk) per
        weight layer — pass ``EngineLayer.kcfg`` values to price an
        autotuned engine.  Returns per-layer :class:`LayerBound` rows plus
        total bytes/MACs and the summed wall-time bound in seconds and
        microseconds.
        """
        shapes = spec.layer_shapes()
        timesteps = spec.timesteps if timesteps is None else timesteps
        if nonzero_tile_fracs is None:
            nonzero_tile_fracs = [1.0] * len(shapes)
        if layer_kcfgs is None:
            layer_kcfgs = [None] * len(shapes)
        layers = []
        for sh, frac, kcfg in zip(shapes, nonzero_tile_fracs, layer_kcfgs):
            rows = batch * sh.out_positions if sh.kind == "conv" else batch
            blk, tb = block, t_block
            if kcfg is not None:
                blk, tb = tuple(kcfg[:3]), kcfg[3]
            layers.append(self.layer_bound(
                rows, sh.fan_in, sh.out_channels,
                timesteps=timesteps, t_block=tb,
                nonzero_tile_frac=frac, block=blk,
            ))
        bound_s = sum(lb.bound_s for lb in layers)
        return {
            "layers": layers,
            "bytes_moved": sum(lb.bytes_moved for lb in layers),
            "macs": sum(lb.macs for lb in layers),
            "compute_s": sum(lb.compute_s for lb in layers),
            "memory_s": sum(lb.memory_s for lb in layers),
            "bound_s": bound_s,
            "bound_us": bound_s * 1e6,
        }


# ---------------------------------------------------------------------------
# The dry run's roofline (module docstring): per-device dot FLOPs,
# collective bytes and live bytes of one step over DTensors.
# ---------------------------------------------------------------------------
COLLECTIVES = {  # functional collective -> (HLO kind, wire multiplier)
    "all_reduce": ("all-reduce", 2.0),
    "all_reduce_coalesced": ("all-reduce", 2.0),
    "all_gather_into_tensor": ("all-gather", 1.0),
    "all_gather_into_tensor_coalesced": ("all-gather", 1.0),
    "reduce_scatter_tensor": ("reduce-scatter", 1.0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 1.0),
    "all_to_all_single": ("all-to-all", 1.0),
    "broadcast": ("collective-permute", 1.0),
}


def _leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from _leaves(o)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _type_str(t) -> str:
    dt = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.int32: "s32", torch.int64: "s64", torch.bool: "pred",
          torch.int8: "s8"}.get(t.dtype, str(t.dtype))
    return f"{dt}[{','.join(str(d) for d in t.shape)}]"


class _Collectives(TorchDispatchMode):
    """Pushed for the duration of one DTensor op: lets DTensor desugar the
    op into local ops and records the collectives among them."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.counter._collective(func, out)
        return out


class StepCounter(TorchDispatchMode):
    """Per-device dot FLOPs, collective bytes, bytes accessed and the peak
    of live local bytes of everything run under it (module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.dot_flops = 0.0
        self.bytes_accessed = 0.0
        self.dots: list = []
        self.colls: list = []
        self.live: dict = {}
        self.cur = 0
        self.peak = 0
        self.n_ops = 0
        self._inner = _Collectives(self)

    # -- live bytes --------------------------------------------------------
    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.cur += n
        self.peak = max(self.peak, self.cur)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.cur -= self.live.pop(key, 0)

    # -- counts ------------------------------------------------------------
    def _collective(self, func, out):
        name = func._overloadpacket.__name__
        if name not in COLLECTIVES:
            return
        kind, mult = COLLECTIVES[name]
        for t in _leaves(out):
            b = _nbytes(t) * mult
            self.colls.append({"comp": str(func), "kind": kind, "out": _type_str(t),
                               "bytes": b, "mult": 1.0, "op_name": name})
            self._track(t)

    def _dot(self, func, args, kwargs, out, divisor: int):
        fn = self.flop_registry.get(func._overloadpacket)
        if fn is None:
            return
        f = fn(*args, **kwargs, out_val=out) / divisor
        self.dot_flops += f
        self.dots.append({"comp": str(func),
                          "out": _type_str(self._local(next(_leaves(out)))), "flops": f})

    @staticmethod
    def _local(t):
        return getattr(t, "_local_tensor", t)

    def _accessed(self, func, args, out):
        if func.is_view:
            return
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        for a in args:
            if isinstance(a, (list, tuple)):
                ins += [x for x in a if isinstance(x, torch.Tensor)]
        self.bytes_accessed += sum(_nbytes(self._local(t)) for t in ins)
        self.bytes_accessed += sum(_nbytes(self._local(t)) for t in _leaves(out))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Partial, Shard

        kwargs = kwargs or {}
        self.n_ops += 1
        if any(issubclass(t, DTensor) for t in types):
            with self._inner:
                out = func(*args, **kwargs)
            first = next(_leaves(out), None)
            if isinstance(first, DTensor):
                divisor = math.prod(
                    n for n, pl in zip(first.device_mesh.shape, first.placements)
                    if isinstance(pl, (Shard, Partial)))
                self._dot(func, args, kwargs, out, divisor)
                for t in _leaves(out):
                    if isinstance(t, DTensor):
                        self._track(t._local_tensor)
            self._accessed(func, args, out)
            return out
        out = func(*args, **kwargs)
        self._dot(func, args, kwargs, out, 1)
        self._collective(func, out)
        for t in _leaves(out):
            self._track(t)
        self._accessed(func, args, out)
        return out

    def summary(self) -> dict:
        """``parse_hlo``'s keys, plus ``bytes_accessed``, ``peak_bytes``
        and ``n_ops``."""
        by_kind: dict = {}
        total = 0.0
        for c in self.colls:
            by_kind[c["kind"]] = by_kind.get(c["kind"], 0.0) + c["bytes"]
            total += c["bytes"]
        dots = sorted(self.dots, key=lambda d: -d["flops"])
        colls = sorted(self.colls, key=lambda c: -c["bytes"])
        return {
            "dot_flops": self.dot_flops,
            "collective_bytes": total,
            "collective_by_kind": by_kind,
            "top_dots": dots[:8],
            "top_collectives": colls[:10],
            "all_collectives": colls,
            "bytes_accessed": self.bytes_accessed,
            "peak_bytes": self.peak,
            "n_ops": self.n_ops,
        }


def count_step(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), counts)``: the step run under a
    :class:`StepCounter`; ``counts`` has ``parse_hlo``'s keys
    (``dot_flops``, ``collective_bytes``, ``collective_by_kind``,
    ``top_dots``, ``top_collectives``, ``all_collectives``), all per
    device, and ``bytes_accessed``, ``peak_bytes`` (the peak of the live
    local bytes allocated during the step) and ``n_ops``."""
    counter = StepCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.summary()


def _memory_bytes(cfg, shape, n_chips: int, model_axis: int) -> float:
    """The reference's analytic per-device HBM traffic of one step."""
    n_params = cfg.param_count()
    d = cfg.d_model
    b_local = max(shape.global_batch // max(n_chips // model_axis, 1), 1)
    if shape.kind == "train":
        # fp32 params sharded over all chips (FSDP x TP): fwd read + bwd read
        # + grad write + AdamW (read p,mu,nu + write p,mu,nu) = 9 passes.
        param_traffic = 9.0 * 4.0 * n_params / n_chips
        # activation boundaries: save + reload per layer (remat recomputes
        # interior): 2 passes of (B_local, S, D) bf16 per layer.
        act = 4.0 * b_local * shape.seq_len * d * 2.0 * cfg.n_layers
        return param_traffic + act
    if shape.kind == "prefill":
        param_traffic = 4.0 * n_params / n_chips
        act = 2.0 * b_local * shape.seq_len * d * 2.0 * cfg.n_layers
        # KV cache write
        kv = 2.0 * b_local * shape.seq_len * cfg.n_kv_heads * cfg.head_dim_ * 2.0 \
            * cfg.n_layers / model_axis
        return param_traffic + act + kv
    # decode: full param read + full cache read per token.
    param_traffic = 4.0 * n_params / n_chips
    if cfg.family == "ssm":
        state = cfg.n_layers * b_local * (d // 64) * 64 * 64 * 4.0 * 2.0
        return param_traffic + state
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // (cfg.attn_period or 6)
        n_mamba = cfg.n_layers - n_attn
        state = n_mamba * b_local * (cfg.d_inner // 64) * cfg.ssm_state * 64 * 4.0 * 2.0
        kv = 2.0 * b_local * shape.seq_len * cfg.n_kv_heads * cfg.head_dim_ * 2.0 \
            * n_attn / model_axis
        return param_traffic + state + kv
    kv = 2.0 * b_local * shape.seq_len * cfg.n_kv_heads * cfg.head_dim_ * 2.0 \
        * cfg.n_layers / model_axis
    return param_traffic + kv


def analyze_compiled(parsed: dict, cfg, shape, mesh_devices: int, model_axis: int) -> dict:
    """The reference's roofline record from :func:`count_step`'s counts
    (in place of its compiled executable), at :data:`HW_PEAK`.  No
    ``bf16_wire`` correction: DTensor moves the real dtype."""
    peak = HW_PEAK
    compute_s = parsed["dot_flops"] / peak["flops_bf16"]
    mem_bytes = _memory_bytes(cfg, shape, mesh_devices, model_axis)
    memory_s = mem_bytes / peak["hbm_gbps"]
    coll_s = parsed["collective_bytes"] / (peak["ici_links"] * peak["ici_link_gbps"])

    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)

    # MODEL_FLOPS: 6*N*D with N = (active) params, D = tokens processed.
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = cfg.active_param_count()
    model_flops_global = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    model_flops_local = model_flops_global / mesh_devices
    hlo = parsed["dot_flops"]
    useful = model_flops_local / hlo if hlo else 0.0

    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "bottleneck": bottleneck,
        "dot_flops_local": parsed["dot_flops"],
        "collective_bytes_local": parsed["collective_bytes"],
        "collective_by_kind": {k: round(v) for k, v in parsed["collective_by_kind"].items()},
        "memory_bytes_local": mem_bytes,
        "model_flops_local": model_flops_local,
        "useful_flops_ratio": useful,
        "step_time_lower_bound_s": max(terms.values()),
        "roofline_fraction": useful * (compute_s / max(terms.values())) if hlo else 0.0,
        "top_dots": parsed["top_dots"][:5],
        "top_collectives": parsed["top_collectives"][:8],
    }
