"""Parity of the port's dry-run material with the JAX reference (A12.3).

``repro_torch.flags``, the shape cells of ``configs.base``, the abstract
trees of ``models.model``, every spec of ``repro_torch.sharding`` and the
roofline's analytic terms against ``repro``'s, exactly.  A spec is a
tuple here and a ``PartitionSpec`` (a tuple) there; meshes are the
reference's axis sizes (``validate_spec`` reads nothing else of a mesh).
None of these tests starts a process group.
"""
from __future__ import annotations

import importlib
import os
import types

import numpy as np
import pytest
import torch

from _torch_parity import jax_ref  # noqa: F401
from repro_torch import flags, sharding
from repro_torch.configs.base import SHAPES, get_config, input_specs, list_archs
from repro_torch.launch import dryrun
from repro_torch.models import model as M
from repro_torch.roofline import analysis as roofline

try:  # property tests need the dev extra
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover
    from _hypothesis_stub import given, settings, st

ARCHS = list_archs()
VARIANTS = list(flags.VARIANTS)
POD1 = {"data": 16, "model": 16}
POD2 = {"pod": 2, "data": 16, "model": 16}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


@pytest.fixture(scope="module")
def ref(jax_ref):
    """The reference's flags, sharding and dry-run modules.  Importing its
    dry run sets ``XLA_FLAGS`` for 512 host devices; the variable is put
    back at once, so no later JAX backend in this process sees it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        dr = importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return types.SimpleNamespace(
        flags=importlib.import_module("repro.flags"),
        sharding=importlib.import_module("repro.sharding"), dryrun=dr,
        configs=jax_ref.lm_configs, model=jax_ref.lm_model, roofline=jax_ref.roofline,
        jax=jax_ref.jax)


@pytest.fixture(autouse=True)
def _base_flags(ref):
    yield
    flags.set_variant("base")
    ref.flags.set_variant("base")


def _mesh_ref(sizes):
    return types.SimpleNamespace(shape=dict(sizes))


def _port_leaves(tree) -> dict:
    out = {}
    sharding.tree_map_with_path(lambda p, t: out.__setitem__(".".join(p), t), tree)
    return out


def _ref_leaves(ref, tree, is_spec=False) -> dict:
    jax = ref.jax
    kw = {"is_leaf": lambda x: isinstance(x, jax.sharding.PartitionSpec)} if is_spec else {}
    leaves = jax.tree_util.tree_flatten_with_path(tree, **kw)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): leaf
            for path, leaf in leaves}


_PAIRS: dict = {}


def _abstract_pair(ref, arch):
    """(port, reference) abstract parameters of the full config, once per arch."""
    if arch not in _PAIRS:
        _PAIRS[arch] = (M.abstract_params(get_config(arch)),
                        ref.model.abstract_params(ref.configs.get_config(arch)))
    return _PAIRS[arch]


def _same_shapes(port: dict, jref: dict):
    assert port.keys() == jref.keys()
    for k in port:
        assert tuple(port[k].shape) == tuple(jref[k].shape), k
        assert port[k].dtype == DTYPES[str(jref[k].dtype)], k


# ---------------------------------------------------------------------------
# flags, shapes, inputs
# ---------------------------------------------------------------------------
def test_flags_and_variants_equal(ref):
    assert flags.FLAGS == ref.flags.FLAGS
    assert flags.VARIANTS == ref.flags.VARIANTS
    for v in VARIANTS:
        flags.set_variant(v)
        ref.flags.set_variant(v)
        assert flags.FLAGS == ref.flags.FLAGS
        assert all(flags.flag(k) == ref.flags.flag(k) for k in flags.FLAGS)


def test_shapes_equal(ref):
    assert list(SHAPES) == list(ref.configs.SHAPES)
    for name, s in SHAPES.items():
        r = ref.configs.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            r.name, r.seq_len, r.global_batch, r.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_supports_skip_reason_and_input_specs(ref, arch):
    cfg, cfg_r = get_config(arch), ref.configs.get_config(arch)
    for name, shape in SHAPES.items():
        r = ref.configs.SHAPES[name]
        assert cfg.supports(shape) == cfg_r.supports(r)
        assert cfg.skip_reason(shape) == cfg_r.skip_reason(r)
        _same_shapes(input_specs(cfg, shape), ref.configs.input_specs(cfg_r, r))


# ---------------------------------------------------------------------------
# abstract trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_equal(ref, arch):
    port, jref = _abstract_pair(ref, arch)
    _same_shapes(_port_leaves(port), _ref_leaves(ref, jref))
    assert all(t.device.type == "meta" for t in _port_leaves(port).values())
    _same_shapes(_port_leaves(M.abstract_opt_state(port)),
                 _ref_leaves(ref, ref.model.abstract_opt_state(jref)))
    cfg, cfg_r = get_config(arch), ref.configs.get_config(arch)
    for name in ("decode_32k", "long_500k"):
        s = SHAPES[name]
        _same_shapes(_port_leaves(M.abstract_decode_cache(cfg, s.global_batch, s.seq_len)),
                     _ref_leaves(ref, ref.model.abstract_decode_cache(
                         cfg_r, s.global_batch, s.seq_len)))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_validated_equal(ref, arch, variant):
    port, jref = _abstract_pair(ref, arch)
    flags.set_variant(variant)
    ref.flags.set_variant(variant)
    for sizes in (POD1, POD2):
        got = _port_leaves(sharding.validate_tree(sharding.param_specs(port), port, sizes))
        want = _ref_leaves(ref, ref.sharding.validate_tree(
            ref.sharding.param_specs(jref), jref, _mesh_ref(sizes)), is_spec=True)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == tuple(want[k]), (k, sizes)
        # unvalidated too
        got = _port_leaves(sharding.param_specs(port))
        want = _ref_leaves(ref, ref.sharding.param_specs(jref), is_spec=True)
        assert {k: v for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("variant", VARIANTS)
def test_opt_batch_cache_logits_specs_and_dp_axes_equal(ref, variant):
    flags.set_variant(variant)
    ref.flags.set_variant(variant)
    for arch in ARCHS:
        port, jref = _abstract_pair(ref, arch)
        got = _port_leaves(sharding.opt_specs(M.abstract_opt_state(port)))
        want = _ref_leaves(ref, ref.sharding.opt_specs(ref.model.abstract_opt_state(jref)),
                           is_spec=True)
        assert got == {k: tuple(v) for k, v in want.items()}
        cfg, cfg_r = get_config(arch), ref.configs.get_config(arch)
        for multi_pod in (False, True):
            assert sharding.dp_axes(multi_pod) == ref.sharding.dp_axes(multi_pod)
            for name, s in SHAPES.items():
                r = ref.configs.SHAPES[name]
                got = sharding.batch_specs(input_specs(cfg, s), multi_pod)
                want = ref.sharding.batch_specs(ref.configs.input_specs(cfg_r, r), multi_pod)
                assert got == {k: tuple(v) for k, v in want.items()}
                assert sharding.logits_spec(multi_pod, s.global_batch) == tuple(
                    ref.sharding.logits_spec(multi_pod, r.global_batch))
                if s.kind == "decode":
                    c = M.abstract_decode_cache(cfg, s.global_batch, s.seq_len)
                    c_r = ref.model.abstract_decode_cache(cfg_r, r.global_batch, r.seq_len)
                    got = sharding.decode_cache_specs(c, multi_pod, s.global_batch)
                    want = ref.sharding.decode_cache_specs(c_r, multi_pod, r.global_batch)
                    assert got == {k: tuple(v) for k, v in want.items()}
                    sizes = POD2 if multi_pod else POD1
                    got = sharding.validate_tree(got, c, sizes)
                    want = ref.sharding.validate_tree(want, c_r, _mesh_ref(sizes))
                    assert got == {k: tuple(v) for k, v in want.items()}


_AXES = st.sampled_from([None, "data", "model", "pod", ("data", "model"),
                         ("pod", "data"), ("pod", "data", "model")])


@settings(max_examples=300, deadline=None)
@given(spec=st.lists(_AXES, min_size=0, max_size=5),
       shape=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 24, 40, 64, 100, 256]),
                      min_size=1, max_size=5),
       sizes=st.tuples(st.sampled_from([1, 2, 4]), st.sampled_from([1, 2, 4, 16]),
                       st.sampled_from([1, 2, 8, 16])))
def test_validate_spec_matches_reference(ref, spec, shape, sizes):
    spec = spec[:len(shape)]
    mesh = {"pod": sizes[0], "data": sizes[1], "model": sizes[2]}
    P = ref.jax.sharding.PartitionSpec
    got = sharding.validate_spec(tuple(spec), tuple(shape), mesh)
    want = ref.sharding.validate_spec(P(*spec), tuple(shape), _mesh_ref(mesh))
    assert got == tuple(want)
    assert sharding.validate_spec(tuple(spec), tuple(shape), None) == tuple(spec)


def test_placements_follow_the_references_major_to_minor_layout():
    """("data", "model") on one dim: DTensor shards it by data first, then
    by model inside each data block -- the reference's major-first order;
    an out-of-order tuple is refused."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sharding.placements((None, ("data", "model")), mesh) == (
        Replicate(), Shard(1), Shard(1))
    assert sharding.placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError):
        sharding.placements((("model", "data"),), mesh)


# ---------------------------------------------------------------------------
# dry-run policy and analytic roofline terms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_auto_and_memory_bytes_equal(ref, arch):
    cfg, cfg_r = get_config(arch), ref.configs.get_config(arch)
    for name, s in SHAPES.items():
        r = ref.configs.SHAPES[name]
        for multi_pod in (False, True):
            assert dryrun.resolve_auto(s, multi_pod) == ref.dryrun.resolve_auto(r, multi_pod)
            n = 512 if multi_pod else 256
            for model_axis in (1, 16):
                assert roofline._memory_bytes(cfg, s, n, model_axis) == \
                    ref.roofline._memory_bytes(cfg_r, r, n, model_axis)


def test_analyze_compiled_keys_and_terms_equal(ref):
    """The same counts give the reference's record: its keys, and equal
    model FLOPs, memory bytes and useful-FLOPs ratio (the peaks differ)."""
    cfg, cfg_r = get_config("qwen3-14b"), ref.configs.get_config("qwen3-14b")
    s, r = SHAPES["train_4k"], ref.configs.SHAPES["train_4k"]
    parsed = {"dot_flops": 1e15, "collective_bytes": 2e9,
              "collective_by_kind": {"all-gather": 2e9}, "top_dots": [],
              "top_collectives": [], "all_collectives": []}
    got = roofline.analyze_compiled(parsed, cfg, s, 256, 16)
    compiled = types.SimpleNamespace(as_text=lambda: "")
    want = ref.roofline.analyze_compiled(compiled, cfg_r, r, 256, 16)
    assert got.keys() == want.keys()
    for k in ("memory_bytes_local", "model_flops_local"):
        assert got[k] == want[k]
    assert got["useful_flops_ratio"] == want["model_flops_local"] / 1e15
    assert got["compute_s"] == 1e15 / roofline.HW_PEAK["flops_bf16"]


# ---------------------------------------------------------------------------
# every existing path is unchanged
# ---------------------------------------------------------------------------
def test_constrain_is_the_identity_with_no_mesh_armed():
    assert not sharding.armed()
    x = torch.randn(4, 8, 16)
    for dims in (("dp", None, None), ("dp", "model", None), (None, None, "model")):
        assert sharding.constrain(x, *dims) is x
    assert sharding.constrain(None, "dp") is None
    assert sharding.local_call(lambda a, b: (a, b), (x, 3)) == (x, 3)


def test_compute_params_is_the_identity_without_bf16_params():
    p = {"w": torch.randn(3, 4), "b": torch.randn(4)}
    assert M._compute_params(p) is p
    flags.set_variant("bf16")
    got = M._compute_params(p)
    assert got["w"].dtype == torch.bfloat16 and got["b"] is p["b"]
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  p["w"].to(torch.bfloat16).float().numpy())
