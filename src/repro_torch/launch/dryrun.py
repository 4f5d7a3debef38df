"""Multi-pod dry run: trace every (arch x shape x mesh) cell on placeholder ranks.

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell's step on 256 or 512 placeholder host devices and reads
XLA's memory analysis and the post-SPMD HLO.  Here a cell's step runs as
rank 0 of a *fake* process group of 256 (pod1, 16x16) or 512 (pod2,
2x16x16) ranks (``launch/mesh.py``), on ``DTensor``s of fake tensors
(``FakeTensorMode``): the parameters, optimizer state, batch and cache are
placed by the validated specs of ``repro_torch.sharding``, the activation
constraints are armed as in the reference's ``run_cell``, and the step --
forward, backward and AdamW for train -- is traced under
``roofline.analysis.count_step``.  Nothing is compiled and nothing of the
model's size is allocated.

Per cell one JSON record with the reference's keys, ``trace_s`` in place
of ``lower_s`` and ``compile_s``:

  * ``memory_analysis``: ``argument_size_in_bytes`` (this rank's bytes of
    the inputs, exact), ``output_size_in_bytes`` (its bytes of the
    outputs) and ``temp_size_in_bytes`` (the peak of the live local bytes
    the step allocates beyond the arguments, collective buffers included:
    an estimate, see ``roofline.analysis``);
  * ``cost_analysis``: the counted dot FLOPs and bytes accessed;
  * ``roofline``: ``analyze_compiled`` at the H100's peaks.

``--variant auto`` picks one variant per cell (:func:`resolve_auto`).

Tensors made inside a step meet DTensors.  The step runs under
``implicit_replication``, so that they are taken as replicated (every
rank makes them whole), at two places:

  * ``models.common.apply_rope``: the cos/sin tables of the positions
    (an ``arange`` in prefill), in the forward and in the backward;
  * ``models.model._head_logits``: a padded vocabulary's mask
    (``arange(V) < vocab``).

``sharding.constrain``, ``sharding.local_call`` and
``sharding.map_local`` take a plain tensor as replicated too, and
``sharding.zeros`` makes the zero initial states of the ssm and hybrid
families block by block.  A layer's weights are gathered FSDP-style at
their use (``sharding.gather_params``).  The ops with no DTensor sharding
rule, or whose rule fails or replicates at the global size (ROADMAP C16),
run inside ``local_map`` around the smallest function that holds them:
the embedding lookup and the head product (``models.model``), the cross
entropy (``models.common``), the attention core of prefill and decode
(``models.attention``), the MoE layer (``models.moe``), the wkv chunk
loop and the decode recurrence (``models.rwkv6``), the SSD chunk loop and
the decode recurrence (``models.mamba2``).  rwkv6 takes the plain wkv
route: B7's launch takes neither a fake tensor nor a DTensor.

On the card, :func:`run_local` runs rank 0's local program for real: the
same DTensor step on CUDA tensors under the fake process group, whose
collectives return buffers of the right shape and leave the data alone,
so its memory and local compute are real and its values are not.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
        --variant auto [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from .. import flags as perf_flags
from .. import sharding as S
from ..configs.base import SHAPES, get_config, input_specs, list_archs
from ..models import model as M
from ..roofline.analysis import analyze_compiled, count_step
from .mesh import make_production_mesh

__all__ = ["RESULT_DIR", "build_lowerable", "main", "resolve_auto", "run_cell",
           "run_local"]

RESULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                          "dryrun_torch")


def _cell_id(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"


def _prefill_cache_abstract(cfg, batch: int, seq_len: int) -> dict:
    """The prefill's cache: the decode cache's keys and shapes without the
    ``len`` counter (and a hybrid's absent tail as None)."""
    cache = M.abstract_decode_cache(cfg, batch, seq_len)
    cache.pop("len")
    if cfg.family == "hybrid":
        cache.setdefault("tail_conv", None)
        cache.setdefault("tail_ssm", None)
    return cache


def build_lowerable(arch: str, shape_name: str, multi_pod: bool, device: str = "cuda"):
    """Returns (fn, args_abstract, in_specs, out_specs, meta): the cell's
    step, its inputs as meta tensors, and the validated specs of its
    inputs and outputs (None for a non-tensor argument)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not cfg.supports(shape):
        raise ValueError(f"skip: {cfg.skip_reason(shape)}")
    return build_step(cfg, shape, make_production_mesh(multi_pod, device), multi_pod)


def build_step(cfg, shape, mesh, multi_pod: bool):
    """:func:`build_lowerable` for any config, shape and mesh (the tests
    trace reduced configs on small meshes)."""
    params_abs = M.abstract_params(cfg)
    if perf_flags.flag("serve_bf16_weights") and shape.kind != "train":
        # Serving from a bf16 checkpoint: no fp32 masters at inference.
        params_abs = S.tree_map_with_path(
            lambda path, a: torch.empty(a.shape, dtype=torch.bfloat16, device="meta")
            if a.dtype == torch.float32 and a.dim() >= 2 else a, params_abs)
    p_specs = S.validate_tree(S.param_specs(params_abs), params_abs, mesh)
    batch_abs = input_specs(cfg, shape)
    b_specs = S.validate_tree(S.batch_specs(batch_abs, multi_pod), batch_abs, mesh)

    if shape.kind == "train":
        opt_abs = M.abstract_opt_state(params_abs)
        o_specs = {"mu": p_specs, "nu": p_specs}
        fn = M.make_train_step(cfg)
        args = (params_abs, opt_abs, 1, batch_abs)
        in_sh = (p_specs, o_specs, None, b_specs)
        out_sh = (p_specs, o_specs, None)
        meta = {"kind": "train"}
    elif shape.kind == "prefill":
        fn = M.make_prefill_step(cfg, use_kernel=False)
        args = (params_abs, batch_abs)
        in_sh = (p_specs, b_specs)
        cache_abs = _prefill_cache_abstract(cfg, shape.global_batch, shape.seq_len)
        c_specs = S.validate_tree(
            S.decode_cache_specs(cache_abs, multi_pod, shape.global_batch),
            cache_abs, mesh,
        )
        l_spec = S.validate_spec(
            S.logits_spec(multi_pod, shape.global_batch),
            (shape.global_batch, cfg.padded_vocab), mesh,
        )
        out_sh = (l_spec, c_specs)
        meta = {"kind": "prefill"}
    else:  # decode
        cache_abs = M.abstract_decode_cache(cfg, shape.global_batch, shape.seq_len)
        c_specs = S.validate_tree(
            S.decode_cache_specs(cache_abs, multi_pod, shape.global_batch),
            cache_abs, mesh,
        )
        fn = M.make_decode_step(cfg)
        args = (params_abs, cache_abs, batch_abs)
        in_sh = (p_specs, c_specs, b_specs)
        l_spec = S.validate_spec(
            S.logits_spec(multi_pod, shape.global_batch),
            (shape.global_batch, cfg.padded_vocab), mesh,
        )
        out_sh = (l_spec, c_specs)
        meta = {"kind": "decode"}
    meta.update(
        {
            "arch": cfg.name, "shape": shape.name, "multi_pod": multi_pod,
            "params": cfg.param_count(), "active_params": cfg.active_param_count(),
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        }
    )
    return fn, args, in_sh, out_sh, meta


def resolve_auto(shape, multi_pod: bool) -> str:
    """The reference's per-cell policy:

      train/prefill, batch divisible by ALL mesh axes -> dp_only_bf16
      train otherwise -> bf16_seqpar (TP kept; sequence parallelism is
        the memory lever for batch-nondivisible train cells)
      prefill otherwise -> bf16
      decode -> serve_opt (TP-only bf16 weights: no per-token parameter
        all-gathers)
    """
    n_devices = 512 if multi_pod else 256
    if shape.kind == "decode":
        return "serve_opt"
    if shape.global_batch % n_devices == 0:
        return "dp_only_bf16"
    if shape.kind == "train":
        return "bf16_seqpar"
    return "bf16"


# ---------------------------------------------------------------------------
# Placing a cell's inputs
# ---------------------------------------------------------------------------
def _place(abstract, spec, mesh, device, make):
    """A DTensor of ``abstract``'s global shape and dtype laid out by
    ``spec``, whose local block is ``make(local_shape, dtype, device)``."""
    from torch.distributed.tensor import DTensor, Shard

    pl = S.placements(spec, mesh)
    local = list(abstract.shape)
    for p, n in zip(pl, mesh.shape):
        if isinstance(p, Shard):
            local[p.dim] //= n
    glob = torch.empty(abstract.shape, device="meta")
    return DTensor.from_local(make(local, abstract.dtype, device), mesh, pl,
                              run_check=False, shape=abstract.shape, stride=glob.stride())


def _place_args(args, in_sh, mesh, device, make) -> tuple:
    """The step's arguments as DTensors laid out by their specs (a
    non-tensor argument, whose spec is None, as it is)."""
    return tuple(a if s is None else S.map_specs(
        lambda sp, t: _place(t, sp, mesh, device, make), s, a) for a, s in zip(args, in_sh))


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def _local_bytes(tree) -> int:
    """This rank's bytes of the tensors of ``tree`` (each storage once)."""
    seen, total = set(), 0

    def visit(t):
        nonlocal total
        if isinstance(t, torch.Tensor):
            t = getattr(t, "_local_tensor", t)
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
        elif isinstance(t, dict):
            for v in t.values():
                visit(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                visit(v)

    visit(tree)
    return total


def _redistribute_out(out, specs, mesh):
    """The step's outputs laid out by ``specs`` (the reference's
    ``out_shardings``); None specs and non-DTensors are left as they are."""
    from torch.distributed.tensor import DTensor

    if isinstance(out, DTensor):
        return out.redistribute(mesh, S.placements(specs, mesh)) if specs is not None else out
    if isinstance(out, dict):
        return {k: _redistribute_out(v, specs[k] if specs is not None else None, mesh)
                for k, v in out.items()}
    if isinstance(out, (list, tuple)) and not hasattr(out, "_fields"):
        return type(out)(_redistribute_out(v, s, mesh) for v, s in
                         zip(out, specs if specs is not None else [None] * len(out)))
    return out


def _trace(fn, args, in_sh, out_sh, meta, mesh, device, make=_empty):
    """Place the inputs and run the step under ``count_step``; returns
    (outputs, counts, argument bytes)."""
    from torch.distributed.tensor.experimental import implicit_replication

    placed = _place_args(args, in_sh, mesh, device, make)
    arg_bytes = _local_bytes(placed)

    def step(*a):
        out = fn(*a)
        return _redistribute_out(out, out_sh, mesh)

    with implicit_replication(), torch.set_grad_enabled(meta["kind"] == "train"):
        out, counts = count_step(step, *placed)
    return out, counts, arg_bytes


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             with_roofline: bool = True, force: bool = False,
             variant: str = "base", device: str = "cuda") -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    requested = variant
    if variant == "auto":
        variant = resolve_auto(SHAPES[shape_name], multi_pod)
    perf_flags.set_variant(variant)
    cell = _cell_id(arch, shape_name, multi_pod)
    if requested != "base":
        cell = f"{cell}__{requested}"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, cell + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    record = {"cell": cell, "arch": arch, "shape": shape_name,
              "multi_pod": multi_pod, "status": "unknown"}
    if not cfg.supports(shape):
        record.update(status="skipped", reason=cfg.skip_reason(shape))
        _write(out_path, record)
        return record

    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod, device)
        # Arm activation sharding constraints (batch dim unshardable when 1).
        S.set_activation_mesh(mesh, multi_pod=multi_pod,
                              batch_sharded=shape.global_batch > 1)
        fn, args, in_sh, out_sh, meta = build_lowerable(arch, shape_name, multi_pod,
                                                        device)
        with FakeTensorMode():
            out, counts, arg_bytes = _trace(fn, args, in_sh, out_sh, meta, mesh, device)
            out_bytes = _local_bytes(out)
        t_trace = time.time() - t0
        record.update(
            status="ok",
            resolved_variant=variant,
            meta=meta,
            trace_s=round(t_trace, 1),
            memory_analysis={
                "argument_size_in_bytes": int(arg_bytes),
                "output_size_in_bytes": int(out_bytes),
                "temp_size_in_bytes": int(counts["peak_bytes"]),
            },
            cost_analysis={
                "flops": float(counts["dot_flops"]),
                "bytes_accessed": float(counts["bytes_accessed"]),
            },
        )
        if with_roofline:
            record["roofline"] = analyze_compiled(
                counts, cfg, shape, mesh_devices=mesh.size(),
                model_axis=S.axis_sizes(mesh).get("model", 1),
            )
    except Exception as e:  # record failures -- they are bugs to fix
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    finally:
        S.set_activation_mesh(None)
    record["wall_s"] = round(time.time() - t0, 1)
    _write(out_path, record)
    return record


def run_local(arch: str, shape_name: str, multi_pod: bool = False,
              variant: str = "auto", seed: int = 0) -> dict:
    """Rank 0's local program of a cell, run for real on the card.

    The cell's DTensor step on CUDA tensors under the fake process group:
    each of rank 0's blocks is drawn from ``seed`` (normal floats scaled by
    0.02, token ids below the vocabulary, a zero cache length), and the
    collectives return buffers without moving data, so memory and local
    compute are real and values are not.  The step runs ``repeats`` times
    on fresh inputs.  Returns ``peak_bytes`` (the card's
    ``max_memory_allocated`` during the last step, inputs included, beyond
    what was allocated before it), ``args_bytes`` (the inputs' bytes),
    ``device_ms`` (CUDA-event time of the last step) and the variant.
    """
    from torch.distributed.tensor.experimental import implicit_replication

    if variant == "auto":
        variant = resolve_auto(SHAPES[shape_name], multi_pod)
    perf_flags.set_variant(variant)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(local, dtype, device):
        if dtype.is_floating_point:
            return (torch.randn(local, generator=gen, device=device) * 0.02).to(dtype)
        hi = cfg.vocab_size if len(local) == 2 else 1  # token ids; the cache length
        return torch.randint(0, hi, local, generator=gen, device=device, dtype=dtype)

    mesh = make_production_mesh(multi_pod, "cuda")
    S.set_activation_mesh(mesh, multi_pod=multi_pod, batch_sharded=shape.global_batch > 1)
    try:
        fn, args, in_sh, out_sh, meta = build_lowerable(arch, shape_name, multi_pod, "cuda")
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            placed = _place_args(args, in_sh, mesh, "cuda", make)
            args_bytes = torch.cuda.memory_allocated() - base
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with implicit_replication(), torch.set_grad_enabled(meta["kind"] == "train"):
                start.record()
                out = _redistribute_out(fn(*placed), out_sh, mesh)
                end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            peak = torch.cuda.max_memory_allocated() - base
            del out, placed
        return {"peak_bytes": int(peak), "args_bytes": int(args_bytes), "device_ms": ms,
                "variant": variant}
    finally:
        S.set_activation_mesh(None)


def _write(path, record):
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser(description="SpiDR-framework multi-pod dry run (DTensor)")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--out", default=RESULT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--variant", default="base", choices=list(perf_flags.VARIANTS))
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors and the mesh (no card is used)")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.out,
                               with_roofline=not args.no_roofline,
                               force=args.force, variant=args.variant,
                               device=args.device)
                tag = rec["status"]
                n_ok += tag == "ok"
                n_skip += tag == "skipped"
                n_err += tag == "error"
                extra = ""
                if tag == "ok":
                    mem = rec["memory_analysis"]
                    extra = (
                        f" args={mem['argument_size_in_bytes']/2**30:.2f}GiB"
                        f" temp={mem['temp_size_in_bytes']/2**30:.2f}GiB"
                        f" trace={rec.get('trace_s', 0):.0f}s"
                    )
                elif tag == "error":
                    extra = " " + rec.get("error", "")[:120]
                print(f"[{tag:7s}] {rec['cell']}{extra}", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
