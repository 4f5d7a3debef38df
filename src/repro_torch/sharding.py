"""Partition specs: FSDP x TP x EP (+ SP for long-context decode).

The counterpart of ``repro.sharding``, spec for spec.  A spec is a plain
tuple with one entry per tensor dim: ``None`` (not sharded), a mesh axis
name, or a tuple of two or more axis names (the dim split over several
axes, major first), entry for entry the reference's ``PartitionSpec``,
which normalises a one-name tuple to the name and an empty one to None
(:func:`pspec`).

Mesh axes (``launch/mesh.py``):
  single-pod : ('data', 'model') = (16, 16)
  multi-pod  : ('pod', 'data', 'model') = (2, 16, 16)

Policy:
  * params/optimizer state: FSDP over 'data' + TP over 'model';
    replicated over 'pod' (hierarchical DP);
  * batch: sharded over ('pod', 'data') ['data' when single-pod];
  * MoE experts: expert axis over 'model' (EP);
  * decode KV caches: batch over dp axes, kv-heads over 'model';
    long_500k (batch=1): sequence over 'data' (SP) instead.

Specs are assigned by leaf *path name* (dict keys and NamedTuple field
names), then left-padded with None to the leaf's rank (covers layer
stacking (L, ...) and zamba2's (G, P, ...)).

:func:`placements` turns a spec into ``DTensor`` placements on a
``DeviceMesh``: ``Shard(d)`` on each mesh dim named at tensor dim ``d``,
``Replicate()`` on the others.  A dim split over two axes, such as
``("data", "model")`` in dp_only, is sharded by DTensor in mesh-dim order
(data first, then model within each data block), which is the
reference's layout (the first axis named is the major one); a tuple that
names axes out of mesh order is refused.

:func:`constrain` pins an activation's sharding while a mesh is armed
(:func:`set_activation_mesh`, the dry run only): a
``DTensor.redistribute`` to the spec's placements.  With no mesh armed it
returns its argument, so every single-device path is unchanged.
"""
from __future__ import annotations

from typing import Any

from . import flags

__all__ = [
    "armed",
    "armed_mesh",
    "as_dtensor",
    "axes_index",
    "axis_divides",
    "batch_specs",
    "constrain",
    "data_axes",
    "decode_cache_specs",
    "dp_axes",
    "gather_params",
    "local_call",
    "logits_spec",
    "map_local",
    "map_specs",
    "opt_specs",
    "param_specs",
    "placements",
    "resolve",
    "set_activation_mesh",
    "pspec",
    "spec_of",
    "tree_map_with_path",
    "validate_spec",
    "validate_tree",
    "zeros",
]

Pytree = Any

# ---------------------------------------------------------------------------
# Activation sharding constraints.  ``set_activation_mesh`` arms them (the
# dry run only: every other path leaves them off and ``constrain`` is the
# identity).
# ---------------------------------------------------------------------------
_ACT = {"mesh": None, "dp": ("data",)}


def pspec(*entries) -> tuple:
    """A spec, normalised as ``PartitionSpec`` normalises its entries."""
    def norm(e):
        if isinstance(e, tuple):
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(norm(e) for e in entries)


def set_activation_mesh(mesh, multi_pod: bool = False, batch_sharded: bool = True):
    _ACT["mesh"] = mesh
    _ACT["dp"] = dp_axes(multi_pod) if batch_sharded else None


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of a mapping, returned as is)."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim named at tensor dim ``d``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax} names mesh axes out of mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def spec_of(x) -> tuple:
    """The spec of a DTensor's placements (the inverse of :func:`placements`)."""
    from torch.distributed.tensor import Shard

    dims = [[] for _ in range(x.dim())]
    for name, pl in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    return tuple(None if not d else d[0] if len(d) == 1 else tuple(d) for d in dims)


def axes_index(axes) -> int:
    """This rank's linear index over the mesh axes ``axes`` (major first)
    of the armed mesh: the block a dim sharded over them holds here."""
    mesh = _ACT["mesh"]
    sizes = axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def armed() -> bool:
    """True while a mesh is armed (the dry run)."""
    return _ACT["mesh"] is not None


def armed_mesh():
    """The armed mesh (None when none is)."""
    return _ACT["mesh"]


def data_axes() -> tuple:
    """The mesh axes the armed batch is sharded over ('dp'; () when the
    batch is not sharded)."""
    return _ACT["dp"] or ()


def resolve(shape, *dims) -> tuple:
    """The spec ``constrain`` pins for a tensor of ``shape``: 'dp' becomes
    the data axes, 'model' is dropped under dp_only, a tuple is flattened,
    and an entry whose axes do not divide its dim is dropped."""
    sizes = axis_sizes(_ACT["mesh"])
    spec = []
    dp_only = flags.flag("dp_only")
    for i, d in enumerate(dims):
        if d == "dp":
            d = _ACT["dp"]
        elif dp_only and d == "model":
            d = None  # model axis is data-parallel in dp_only mode
        elif isinstance(d, tuple):  # e.g. ("dp", "model") -- flatten dp
            flat = []
            for a in d:
                if a == "dp":
                    flat.extend(_ACT["dp"] or ())
                elif a is not None:
                    flat.append(a)
            d = tuple(flat) or None
        if d is not None:
            axes = d if isinstance(d, tuple) else (d,)
            size = 1
            for a in axes:
                size *= sizes[a]
            if shape[i] % size != 0:
                d = None
        spec.append(d)
    return tuple(spec)


def as_dtensor(x):
    """``x`` as a DTensor on the armed mesh: a plain tensor, made inside
    the step by every rank whole, is taken as replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    mesh = _ACT["mesh"]
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def zeros(shape, *dims, dtype=None, device=None):
    """``torch.zeros(shape)``; while a mesh is armed, the DTensor of those
    zeros pinned by ``dims`` (as :func:`constrain`), made block by block,
    never at its global size."""
    import torch

    mesh = _ACT["mesh"]
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor, Shard

    pl = placements(resolve(shape, *dims), mesh)
    local = list(shape)
    for p, n in zip(pl, mesh.shape):
        if isinstance(p, Shard):
            local[p.dim] //= n
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), mesh, pl,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def constrain(x, *dims):
    """Pin x's sharding. dims entries: 'dp' | axis name | None | a tuple.

    Axes that do not evenly divide the corresponding dim are dropped
    (e.g. 8 KV heads on a 16-way model axis -> replicated KV, the
    standard Megatron GQA fallback).  A plain tensor (made inside the
    step) is taken as replicated first (:func:`as_dtensor`).
    """
    mesh = _ACT["mesh"]
    if mesh is None or x is None:
        return x
    return as_dtensor(x).redistribute(mesh, placements(resolve(x.shape, *dims), mesh))


def gather_params(tree):
    """A layer's parameters at their use, FSDP-style: every DTensor leaf
    gathered along the mesh axes that shard it for data parallelism (all
    but 'model'; all of them under dp_only), its tensor-parallel 'model'
    sharding kept; the identity with no mesh armed.  Called inside a layer
    (and its checkpoint), so one layer's gathered weights are live at a
    time and the backward reduce-scatters their gradients -- the layout
    XLA gives the reference's FSDP x TP specs."""
    mesh = _ACT["mesh"]
    if mesh is None:
        return tree
    from torch.distributed.tensor import DTensor, Replicate, Shard

    keep = () if flags.flag("dp_only") else ("model",)
    names = mesh.mesh_dim_names

    def gather(path, t):
        if not isinstance(t, DTensor):
            return t
        pl = [Replicate() if isinstance(p, Shard) and n not in keep else p
              for n, p in zip(names, t.placements)]
        return t if tuple(pl) == tuple(t.placements) else t.redistribute(mesh, pl)

    return tree_map_with_path(gather, tree)


def _grad_placements(in_pl, out_pl) -> tuple:
    """The gradient placements of a ``local_map``'s inputs: on a mesh dim
    where some output is sharded or partial, each rank's local gradient of
    an input replicated there is a partial sum (``Partial``); where every
    output is replicated the computation is too, and so is the gradient."""
    from torch.distributed.tensor import Partial, Replicate

    varies = [any(not isinstance(o[m], Replicate) for o in out_pl)
              for m in range(len(out_pl[0]))]
    return tuple(None if p is None else tuple(
        Partial() if v and isinstance(q, Replicate) else q for q, v in zip(p, varies))
        for p in in_pl)


def map_local(fn, args, in_pl, out_pl):
    """``fn(*args)`` on each rank's local blocks (``local_map``): each
    tensor argument redistributed to its placements (None: a non-tensor
    argument), each output read with its placements, and the inputs'
    gradients placed by :func:`_grad_placements`."""
    from torch.distributed.tensor.experimental import local_map

    args = [a if p is None else as_dtensor(a) for a, p in zip(args, in_pl)]
    return local_map(fn, out_placements=tuple(out_pl), in_placements=tuple(in_pl),
                     in_grad_placements=_grad_placements(in_pl, out_pl),
                     device_mesh=_ACT["mesh"], redistribute_inputs=True)(*args)


def local_call(fn, args, in_specs=(), out_specs=()):
    """``fn(*args)`` on each rank's local blocks while a mesh is armed
    (:func:`map_local`): each tensor argument is redistributed to its spec
    (None: a non-tensor argument) and each output is read as laid out by
    its spec; with no mesh armed, ``fn(*args)``."""
    mesh = _ACT["mesh"]
    if mesh is None:
        return fn(*args)
    return map_local(fn, args,
                     [None if s is None else placements(s, mesh) for s in in_specs],
                     [placements(s, mesh) for s in out_specs])


def axis_divides(n: int, *axes) -> bool:
    """True if n is divisible by the (armed) mesh axes' total size."""
    mesh = _ACT["mesh"]
    if mesh is None:
        return True
    sizes = axis_sizes(mesh)
    size = 1
    for a in axes:
        for ax in (_ACT["dp"] or ()) if a == "dp" else (a,):
            size *= sizes[ax]
    return n % size == 0


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    n = 1
    for a in axis if isinstance(axis, tuple) else (axis,):
        n *= sizes[a]
    return n


def validate_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop/relocate axes so every sharded dim divides evenly.

    A non-dividing axis is moved to the first OTHER unsharded dim that it
    divides (e.g. MoE expert dim 40 on a 16-way axis -> shard the expert
    d_ff instead: EP degrades to per-expert TP); if none exists the axis is
    dropped (that dim replicates).
    """
    if mesh is None:
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, ax in enumerate(dims):
        if ax is None:
            continue
        if shape[i] % _axis_size(mesh, ax) != 0:
            dims[i] = None
            order = list(range(i + 1, len(shape))) + list(range(0, i))
            for j in order:
                if dims[j] is None and shape[j] % _axis_size(mesh, ax) == 0 and shape[j] > 1:
                    dims[j] = ax
                    break
    return pspec(*dims)


# ---------------------------------------------------------------------------
# Trees: dicts, NamedTuples and None leaves, as in ``models``.
# ---------------------------------------------------------------------------
def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the tensors of ``tree``; ``path`` holds the
    dict keys and NamedTuple field names down to the leaf.  None stays None
    (an empty subtree, as in ``jax.tree_util``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    return fn(path, tree)


def map_specs(fn, specs: Pytree, tree: Pytree) -> Pytree:
    """``fn(spec, leaf)`` over a tree of specs (tuples; None where the
    tree has no leaf) and the tree they describe."""
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], tree[k]) for k in specs}
    if hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, x, y) for x, y in zip(specs, tree)))
    return fn(specs, tree)


def validate_tree(specs: Pytree, abstract: Pytree, mesh) -> Pytree:
    return map_specs(lambda s, a: validate_spec(s, tuple(a.shape), mesh)
                     if a is not None else s, specs, abstract)


def dp_axes(multi_pod: bool):
    if flags.flag("dp_only"):
        # no TP: the model axis joins data parallelism
        return ("pod", "data", "model") if multi_pod else ("data", "model")
    return ("pod", "data") if multi_pod else ("data",)


# trailing-dims spec per leaf name; padded left with None to leaf rank.
_TRAILING = {
    # top level
    "embed": ("model", "data"),
    "lm_head": ("data", "model"),
    "final_norm": (None,),
    # norms / small vectors
    "ln1": (None,), "ln2": (None,), "ln": (None,),
    "norm_w": (None,), "ln_x": (None,),
    "q_norm": (None,), "k_norm": (None,),
    # attention
    "wq": ("data", "model"), "wk": ("data", "model"), "wv": ("data", "model"),
    "wo": ("model", "data"),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    # dense ffn
    "w_gate": ("data", "model"), "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    # moe (E, D, F) / (E, F, D): experts over model (EP), D over data
    "w_router": ("data", None),
    "moe.w_gate": ("model", "data", None),
    "moe.w_up": ("model", "data", None),
    "moe.w_down": ("model", None, "data"),
    # rwkv6
    "wr": ("data", "model"), "wg": ("data", "model"),
    "cm_wk": ("data", "model"), "cm_wv": ("model", "data"),
    "cm_wr": ("data", "model"),
    "tm_w1": (None, None), "tm_w2": (None, None, None),
    "td_w1": (None, None), "td_w2": (None, None),
    "mu_x": (None,), "mu_rkvwg": (None, None),
    "time_decay": (None,), "bonus_u": (None,),
    "cm_mu_k": (None,), "cm_mu_r": (None,),
    # mamba2
    "w_in": ("data", "model"), "w_out": ("model", "data"),
    "conv_w": (None, "model"), "conv_b": ("model",),
    "a_log": (None,), "dt_bias": (None,), "d_skip": (None,),
}


def _leaf_spec(path: tuple, leaf) -> tuple:
    names = [str(n) for n in path]
    joined = ".".join(names)
    key = names[-1] if names else ""
    trailing = None
    if ("moe" in joined or "w_router" in joined) and f"moe.{key}" in _TRAILING:
        trailing = _TRAILING[f"moe.{key}"]
    elif key in _TRAILING:
        trailing = _TRAILING[key]
    if trailing is None:
        return ()  # replicate by default
    rank = leaf.dim()
    pad = rank - len(trailing)
    if pad < 0:  # leaf smaller than rule (e.g. unstacked shared block)
        trailing = trailing[-rank:] if rank else ()
        pad = 0
    return (None,) * pad + tuple(trailing)


def _leaf_spec_dp_only(path, leaf) -> tuple:
    """Pure FSDP: shard dim -2 of every >=2D weight over (data, model)."""
    rank = leaf.dim()
    if rank < 2:
        return ()
    spec = [None] * rank
    spec[rank - 2] = ("data", "model")
    return tuple(spec)


def _drop_data(spec: tuple) -> tuple:
    """serve_tp: params live TP-only (no FSDP axis) -- decode must not
    all-gather params over 'data' on every token."""
    return tuple(None if d == "data" else d for d in spec)


def param_specs(params_abstract: Pytree) -> Pytree:
    if flags.flag("dp_only"):
        return tree_map_with_path(_leaf_spec_dp_only, params_abstract)
    tree = tree_map_with_path(_leaf_spec, params_abstract)
    if flags.flag("serve_tp"):
        tree = tree_map_with_path(lambda p, s: _drop_data(s), tree)
    return tree


def opt_specs(opt_abstract: Pytree) -> Pytree:
    """Optimizer moments mirror parameter sharding (ZeRO)."""
    return tree_map_with_path(
        lambda path, leaf: _leaf_spec(path[2:] if len(path) > 2 else path, leaf),
        opt_abstract,
    )


def batch_specs(batch_abstract: dict, multi_pod: bool) -> dict:
    dp = dp_axes(multi_pod)
    out = {}
    for k, v in batch_abstract.items():
        b = v.shape[0] if v.dim() else 0
        bspec = dp if b > 1 else None
        out[k] = pspec(bspec, *((None,) * (v.dim() - 1)))
    return out


def decode_cache_specs(cache_abstract: dict, multi_pod: bool, batch: int) -> dict:
    """KV/state cache shardings; SP over sequence when batch == 1."""
    dp = dp_axes(multi_pod)
    bspec = dp if batch > 1 else None
    seq_spec = None if batch > 1 else "data"  # SP for long-context decode
    # dp_only folds 'model' into the data axes -- don't shard heads on it too
    model = None if flags.flag("dp_only") else "model"
    specs = {}
    for k in cache_abstract:
        if k == "len":
            specs[k] = pspec()
        elif k in ("k", "v"):
            # (L_or_G, B, Hkv, S, hd)
            specs[k] = pspec(None, bspec, model, seq_spec, None)
        elif k in ("x_tm", "x_cm"):
            specs[k] = pspec(None, bspec, model)
        elif k == "s":
            specs[k] = pspec(None, bspec, model, None, None)
        elif k == "group_conv":
            specs[k] = pspec(None, None, bspec, None, model)
        elif k == "group_ssm":
            specs[k] = pspec(None, None, bspec, model, None, None)
        elif k == "tail_conv":
            specs[k] = pspec(None, bspec, None, model)
        elif k == "tail_ssm":
            specs[k] = pspec(None, bspec, model, None, None)
        else:
            specs[k] = pspec()
    return specs


def logits_spec(multi_pod: bool, batch: int) -> tuple:
    dp = dp_axes(multi_pod)
    model = None if flags.flag("dp_only") else "model"
    return pspec(dp if batch > 1 else None, model)
