"""Port parity, the LM families (dense, audio, vlm, moe, hybrid), against
repro.models.

Every architecture runs at its ``reduced()`` config on the reference's own
weights, carried across with ``convert.lm_params_from_jax``:

  * every function fed float32 inputs at FP32_TOL: the reference then
    runs in float32, and the two differ by float32 roundings summed in
    another order;
  * the whole model in float32 (both packages' COMPUTE_DTYPE patched) at
    rtol = atol = 1e-4: prefill logits, every cache leaf, a decode walk;
  * as served (bfloat16), teacher-forced: logits within BF16_REL of the
    largest logit, the reference's own bar (tests/test_models_archs.py);
  * the Server against the reference's Server (dense, moe, vlm, audio),
    and zamba2's against the reference's prefill and decode steps composed
    per request (the reference's Server loses the grouped Mamba2 states,
    ROADMAP C12): the same tokens, except at the first differing token of
    a request where the reference's own top-2 logit gap is within
    BF16_REL of its largest logit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import jax_ref, np_of  # noqa: F401
from repro_torch.configs.base import get_config, list_archs
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import ffn as FF
from repro_torch.models import mamba2 as MB
from repro_torch.models import model as M
from repro_torch.models import moe as ME
from repro_torch.models import transformer as T
from repro_torch.models.common import apply_rope, cross_entropy_loss

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL = 0.05

FAMILY_ARCHS = ["qwen1.5-0.5b", "starcoder2-3b", "qwen3-14b", "stablelm-3b",
                "granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "musicgen-large",
                "chameleon-34b", "zamba2-7b"]
CFG_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "head_dim", "qkv_bias", "qk_norm", "rope_theta", "n_experts",
              "top_k", "ssm_state", "attn_period", "expand", "embed_inputs",
              "sub_quadratic", "ffn_variant", "rmsnorm_eps", "tie_embeddings", "source")


@pytest.fixture(scope="module")
def models(jax_ref):
    """arch -> (reference cfg, reference params, port cfg, port params) at
    the reduced config, the same weights in both packages."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jax = jax_ref.jax
            cfg_j = jax_ref.lm_configs.get_config(arch).reduced()
            params_j = jax_ref.lm_model.init_params(jax.random.PRNGKey(0), cfg_j)
            params_t = lm_params_from_jax(jax.tree.map(np.asarray, params_j), "cpu")
            cache[arch] = (cfg_j, params_j, get_config(arch).reduced(), params_t)
        return cache[arch]

    return get


def _hold(got, want, tol=FP32_TOL):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), **tol)


def _both(jax_ref, *arrays):
    return ([jax_ref.jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.asarray(a)) for a in arrays])


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _layer_j(jax_ref, tree, i):
    return jax_ref.jax.tree.map(lambda x: x[i], tree)


@pytest.fixture
def fp32(monkeypatch, jax_ref):
    """Both packages computing in float32."""
    monkeypatch.setattr(jax_ref.lm_model, "COMPUTE_DTYPE", jax_ref.jnp.float32)
    monkeypatch.setattr(M, "COMPUTE_DTYPE", torch.float32)


# ---------------------------------------------------------------------------
# Configs and parameter layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list_archs(lm_only=False))
def test_config_fields_and_counts(jax_ref, name):
    cj, ct = jax_ref.lm_configs.get_config(name), get_config(name)
    if name.startswith("spidr-"):  # the paper's SNN specs: ported earlier
        assert cj.name == ct.name
        return
    for c_j, c_t in ((cj, ct), (cj.reduced(), ct.reduced())):
        for f in CFG_FIELDS:
            assert getattr(c_j, f) == getattr(c_t, f), (name, f)
        for f in ("head_dim_", "padded_vocab", "d_inner"):
            assert getattr(c_j, f) == getattr(c_t, f), (name, f)
        assert c_j.param_count() == c_t.param_count()
        assert c_j.active_param_count() == c_t.active_param_count()


def test_registry_lists_the_reference_archs(jax_ref):
    assert list_archs() == jax_ref.lm_configs.list_archs()
    assert list_archs(False) == jax_ref.lm_configs.list_archs(False)
    with pytest.raises(KeyError):
        get_config("gpt-5")


def _layout(tree):
    """The tree's structure: container types, field names, leaf shapes and
    ``None`` leaves."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return (type(tree).__name__, tuple((f, _layout(v)) for f, v in zip(tree._fields, tree)))
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_init_layout_matches_reference(jax_ref, models, arch):
    cfg_j, params_j, cfg, params_t = models(arch)
    mine = M.init_params(torch.Generator().manual_seed(0), cfg)
    assert _layout(mine) == _layout(params_j)
    assert _layout(params_t) == _layout(params_j)
    for leaf in T._leaf_pairs(mine, mine):
        assert leaf[0].dtype == torch.float32


@pytest.mark.parametrize("arch", FAMILY_ARCHS + ["rwkv6-7b"])
def test_init_serving_params_equals_cast_masters(arch):
    cfg = get_config(arch).reduced()
    want = M.serving_params(M.init_params(torch.Generator().manual_seed(3), cfg))
    got = M.init_serving_params(torch.Generator().manual_seed(3), cfg)
    assert _layout(got) == _layout(want)
    pairs = list(T._leaf_pairs(got, want)) + [(got["embed"], want["embed"])]
    for a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_serving_params_dtypes(models):
    sp = M.serving_params(models("zamba2-7b")[3])
    mamba = sp["blocks"]["groups"]["mamba"]
    for name, t in mamba._asdict().items():
        want = torch.float32 if name in MB.FLOAT32_LEAVES else torch.bfloat16
        assert t.dtype == want, name
    assert sp["blocks"]["groups"]["ln"].dtype == torch.float32
    attn = M.serving_params(models("qwen3-14b")[3])["blocks"]["layers"]["attn"]
    assert attn.q_norm.dtype == attn.k_norm.dtype == torch.float32
    assert attn.wq.dtype == torch.bfloat16 and attn.bq is None
    moe = M.serving_params(models("granite-moe-3b-a800m")[3])["blocks"]["layers"]["moe"]
    assert moe.w_router.dtype == torch.float32 and moe.w_gate.dtype == torch.bfloat16


def test_every_family_inits_and_runs():
    """Every registry LM resolves, inits and runs a prefill and a decode
    step on the CPU."""
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        params = M.init_serving_params(torch.Generator().manual_seed(0), cfg)
        logits, cache = M.make_prefill_step(cfg)(
            params, {"tokens": torch.zeros((1, 5), dtype=torch.long)})
        assert tuple(logits.shape) == (1, cfg.padded_vocab)
        state = T.init_decode_state(cfg, 1, 8)
        lg, state = M.make_decode_step(cfg)(params, state,
                                            {"tokens": torch.zeros((1, 1), dtype=torch.long)})
        assert bool(torch.isfinite(lg).all()) and int(state["len"]) == 1, arch


def test_lm_params_from_jax_keeps_none_leaves(models):
    params_t = models("zamba2-7b")[3]
    assert params_t["blocks"]["tail"] is not None
    attn = params_t["blocks"]["shared"]["attn"]
    assert isinstance(attn, A.AttentionParams) and attn.bq is None and attn.q_norm is None
    ffn = models("starcoder2-3b")[3]["blocks"]["layers"]["ffn"]
    assert isinstance(ffn, FF.FFNParams) and ffn.w_gate is None
    assert models("starcoder2-3b")[3]["blocks"]["layers"]["attn"].bq is not None
    tree = {"blocks": {"groups": {}, "tail": None, "shared": {}}}
    assert lm_params_from_jax(tree, "cpu")["blocks"]["tail"] is None


# ---------------------------------------------------------------------------
# Function-level, float32 inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd,theta", [(16, 1e4), (80, 1e6)])
def test_apply_rope(jax_ref, hd, theta):
    x = _rand(0, 2, 12, 3, hd)
    pos = np.arange(12, dtype=np.int32)[None] + 5
    (xj, pj), (xt, pt) = _both(jax_ref, x, pos)
    _hold(apply_rope(xt, pt, theta), jax_ref.lm_common.apply_rope(xj, pj, theta))
    xb = xt.to(torch.bfloat16)
    assert apply_rope(xb, pt, theta).dtype == torch.bfloat16


def test_qk_norm_projection(jax_ref, models):
    cfg_j, params_j, cfg, params_t = models("qwen3-14b")
    lj = _layer_j(jax_ref, params_j["blocks"]["layers"]["attn"], 1)
    lt = T.layer(params_t["blocks"], 1)["attn"]
    assert lt.q_norm is not None
    # non-trivial norm scales, so the scales' placement shows
    lj = lj._replace(q_norm=lj.q_norm * 1.5, k_norm=lj.k_norm * 0.5)
    lt = lt._replace(q_norm=lt.q_norm * 1.5, k_norm=lt.k_norm * 0.5)
    x = _rand(1, 2, 9, 64)
    pos = np.arange(9, dtype=np.int32)[None]
    (xj, pj), (xt, pt) = _both(jax_ref, x, pos)
    for a, b in zip(A._project_qkv(lt, xt, cfg, pt),
                    jax_ref.lm_attention._project_qkv(lj, xj, cfg_j, pj)):
        _hold(a, b)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-14b"])
@pytest.mark.parametrize("s,kv_chunk", [(16, 1024), (17, 1024), (100, 1024), (100, 32)])
def test_attention_forward(jax_ref, models, arch, s, kv_chunk):
    cfg_j, params_j, cfg, params_t = models(arch)
    lj = _layer_j(jax_ref, params_j["blocks"]["layers"]["attn"], 0)
    lt = T.layer(params_t["blocks"], 0)["attn"]
    if lt.bq is not None:  # non-zero biases, so they show
        rng = np.random.default_rng(2)
        bq, bk, bv = (rng.normal(size=t.shape).astype(np.float32) for t in (lt.bq, lt.bk, lt.bv))
        lj = lj._replace(bq=jax_ref.jnp.asarray(bq), bk=jax_ref.jnp.asarray(bk),
                         bv=jax_ref.jnp.asarray(bv))
        lt = lt._replace(bq=torch.from_numpy(bq), bk=torch.from_numpy(bk), bv=torch.from_numpy(bv))
    (xj,), (xt,) = _both(jax_ref, _rand(s, 2, s, 64))
    got = A.attention_forward(lt, xt, cfg, kv_chunk=kv_chunk, return_cache=True)
    want = jax_ref.lm_attention.attention_forward(lj, xj, cfg_j, kv_chunk=kv_chunk,
                                                  return_cache=True)
    _hold(got[0], want[0])
    _hold(got[1][0], want[1][0])
    _hold(got[1][1], want[1][1])


@pytest.mark.parametrize("cache_len", [0, 5, 11, 14])
def test_decode_attention(jax_ref, models, cache_len):
    """One token against a 12-row cache with ``cache_len`` valid rows; 14
    is past the cache, where the write index clamps to the last row."""
    cfg_j, params_j, cfg, params_t = models("qwen3-14b")
    lj = _layer_j(jax_ref, params_j["blocks"]["layers"]["attn"], 0)
    lt = T.layer(params_t["blocks"], 0)["attn"]
    x = _rand(3, 2, 1, 64)
    ck, cv = _rand(4, 2, cfg.n_kv_heads, 12, 16), _rand(5, 2, cfg.n_kv_heads, 12, 16)
    (xj, kj, vj), (xt, kt, vt) = _both(jax_ref, x, ck, cv)
    got = A.decode_attention(lt, xt, kt, vt, torch.tensor(cache_len, dtype=torch.int32), cfg)
    want = jax_ref.lm_attention.decode_attention(
        lj, xj, kj, vj, jax_ref.jnp.asarray(cache_len, jax_ref.jnp.int32), cfg_j)
    for a, b in zip(got, want):
        _hold(a, b)
    assert torch.equal(kt, torch.from_numpy(ck))  # the given cache is not written


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "starcoder2-3b"], ids=["swiglu", "gelu"])
def test_ffn_forward(jax_ref, models, arch):
    cfg_j, params_j, cfg, params_t = models(arch)
    lj = _layer_j(jax_ref, params_j["blocks"]["layers"]["ffn"], 1)
    lt = T.layer(params_t["blocks"], 1)["ffn"]
    (xj,), (xt,) = _both(jax_ref, _rand(6, 2, 7, 64))
    _hold(FF.ffn_forward(lt, xt), jax_ref.lm_ffn.ffn_forward(lj, xj))


def _ref_keep(jax_ref, x, w_router, top_k, capacity_factor):
    """The reference's keep mask (``moe.py`` lines 75-90) on its router."""
    jax, jnp = jax_ref.jax, jax_ref.jnp
    t = x.shape[0]
    e = w_router.shape[1]
    probs = jax.nn.softmax(x.astype(jnp.float32) @ w_router.astype(jnp.float32), axis=-1)
    _, top_ids = jax.lax.top_k(probs, top_k)
    cap = int(max(1, round(t * top_k / e * capacity_factor)))
    onehot = jax.nn.one_hot(top_ids.reshape(-1), e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    return np.asarray(pos < cap)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 0.25])
def test_moe_forward(jax_ref, models, capacity_factor):
    """Small capacities force drops: the same choices kept, the same
    outputs and aux."""
    cfg_j, params_j, cfg, params_t = models("granite-moe-3b-a800m")
    lj = _layer_j(jax_ref, params_j["blocks"]["layers"]["moe"], 0)
    lt = T.layer(params_t["blocks"], 0)["moe"]
    x = _rand(7, 2, 13, 64)
    (xj,), (xt,) = _both(jax_ref, x)
    out_t, aux_t = ME.moe_forward(lt, xt, cfg.top_k, capacity_factor)
    out_j, aux_j = jax_ref.lm_moe.moe_forward(lj, xj, cfg_j.top_k, capacity_factor)
    _hold(out_t, out_j)
    for k in ("load_balance_loss", "router_z_loss", "drop_fraction"):
        _hold(aux_t[k], aux_j[k])
    keep = ME._local_moe(xt.reshape(-1, 64), *lt, cfg.top_k, capacity_factor)[-1]
    want = _ref_keep(jax_ref, xj.reshape(-1, 64), lj.w_router, cfg_j.top_k, capacity_factor)
    np.testing.assert_array_equal(keep.numpy(), want)
    if capacity_factor < 1:
        assert float(aux_t["drop_fraction"]) > 0


def test_moe_top_k_tie_takes_lower_index(jax_ref):
    """A router tie: jax.lax.top_k keeps the lower expert first, so must
    the port (a stable descending sort)."""
    e, d, f = 4, 8, 4
    w_router = np.zeros((d, e), np.float32)  # every expert ties
    rng = np.random.default_rng(0)
    experts = [rng.normal(size=s).astype(np.float32) for s in ((e, d, f), (e, d, f), (e, f, d))]
    x = rng.normal(size=(1, 3, d)).astype(np.float32)
    pj = jax_ref.lm_moe.MoEParams(*(jax_ref.jnp.asarray(a) for a in [w_router] + experts))
    pt = ME.MoEParams(*(torch.from_numpy(a) for a in [w_router] + experts))
    out_t, _ = ME.moe_forward(pt, torch.from_numpy(x), 2)
    out_j, _ = jax_ref.lm_moe.moe_forward(pj, jax_ref.jnp.asarray(x), 2)
    _hold(out_t, out_j)


def test_moe_capacity_rounds_half_to_even():
    assert ME.capacity(4, 6, 64) == 1          # 0.46875 -> 0 -> 1
    assert ME.capacity(64, 6, 64) == 8         # 7.5 -> 8
    assert ME.capacity(4, 2, 8, 1.0) == 1      # 1.0
    assert ME.capacity(10, 2, 8) == 3          # 3.125 -> 3
    assert ME.capacity(4, 1, 1, 0.625) == 2    # 2.5 -> 2 (ties to even)


def _mamba(jax_ref, models, i=0):
    cfg_j, params_j, cfg, params_t = models("zamba2-7b")
    lj = jax_ref.jax.tree.map(lambda x: x[0, i], params_j["blocks"]["groups"]["mamba"])
    lt = T._index(T.layer(params_t["blocks"], 0)["mamba"], i)
    # dt_bias and d_skip away from their init constants, so a slip shows
    rng = np.random.default_rng(9)
    db = rng.normal(size=lt.dt_bias.shape).astype(np.float32)
    ds = rng.normal(size=lt.d_skip.shape).astype(np.float32)
    lj = lj._replace(dt_bias=jax_ref.jnp.asarray(db), d_skip=jax_ref.jnp.asarray(ds))
    lt = lt._replace(dt_bias=torch.from_numpy(db), d_skip=torch.from_numpy(ds))
    return cfg_j, lj, cfg, lt


def _mamba_state(seed, b, cfg):
    nh = cfg.d_inner // MB.HEAD_P
    return (_rand(seed, b, MB.CONV_K - 1, cfg.d_inner + 2 * cfg.ssm_state),
            _rand(seed + 1, b, nh, cfg.ssm_state, MB.HEAD_P, scale=0.1))


def test_causal_conv_with_state(jax_ref, models):
    cfg_j, lj, cfg, lt = _mamba(jax_ref, models)
    c = cfg.d_inner + 2 * cfg.ssm_state
    x = _rand(10, 2, 6, c)
    st = _rand(11, 2, MB.CONV_K - 1, c)
    (xj, sj), (xt, stt) = _both(jax_ref, x, st)
    conv_w = torch.from_numpy(np.array(lj.conv_w))
    conv_b = torch.from_numpy(_rand(12, c))
    for state_j, state_t in ((None, None), (sj, stt)):
        got = MB._causal_conv(xt, conv_w, conv_b, state_t)
        want = jax_ref.lm_mamba2._causal_conv(xj, lj.conv_w, jax_ref.jnp.asarray(conv_b.numpy()),
                                              state_j)
        _hold(got[0], want[0])
        _hold(got[1], want[1])
    # a 2-token sequence: the new state still holds the last 3 rows
    got = MB._causal_conv(xt[:, :2], conv_w, conv_b, stt)[1]
    _hold(got, torch.cat([stt[:, 2:], xt[:, :2]], dim=1))


@pytest.mark.parametrize("s", [16, 64, 100])
def test_mamba2_forward(jax_ref, models, s):
    cfg_j, lj, cfg, lt = _mamba(jax_ref, models)
    x = _rand(13, 2, s, 64)
    conv, ssm = _mamba_state(14, 2, cfg)
    (xj, cj, sj), (xt, ct, st) = _both(jax_ref, x, conv, ssm)
    got = MB.mamba2_forward(lt, xt, (ct, st), cfg)
    want = jax_ref.lm_mamba2.mamba2_forward(lj, xj, (cj, sj), cfg_j)
    _hold(got[0], want[0])
    _hold(got[1][0], want[1][0])
    _hold(got[1][1], want[1][1])


def test_mamba2_padding_leaves_state_exact(jax_ref, models):
    """A 16-token prefill is padded to one chunk of 64 with zero dt and
    zero log-decay: its final state equals the unpadded chunk's, in both
    packages (unlike RWKV6's padding, ROADMAP C3)."""
    cfg_j, lj, cfg, lt = _mamba(jax_ref, models)
    x = _rand(15, 2, 16, 64)
    conv, ssm = _mamba_state(16, 2, cfg)
    (xj, cj, sj), (xt, ct, st) = _both(jax_ref, x, conv, ssm)
    _, (_, s_pad) = MB.mamba2_forward(lt, xt, (ct, st), cfg)
    _, (_, s_j) = jax_ref.lm_mamba2.mamba2_forward(lj, xj, (cj, sj), cfg_j)
    _hold(s_pad, s_j)
    _, (_, s_16) = MB.mamba2_forward(lt, xt, (ct, st), cfg, chunk=16)  # no padding
    _hold(s_pad, s_16, dict(rtol=1e-6, atol=1e-6))


def test_mamba2_decode_step(jax_ref, models):
    cfg_j, lj, cfg, lt = _mamba(jax_ref, models, 1)
    x = _rand(17, 3, 1, 64)
    conv, ssm = _mamba_state(18, 3, cfg)
    (xj, cj, sj), (xt, ct, st) = _both(jax_ref, x, conv, ssm)
    got = MB.mamba2_decode_step(lt, xt, (ct, st), cfg)
    want = jax_ref.lm_mamba2.mamba2_decode_step(lj, xj, (cj, sj), cfg_j)
    _hold(got[0], want[0])
    _hold(got[1][0], want[1][0])
    _hold(got[1][1], want[1][1])
    zero = MB.init_mamba2_state(3, cfg)
    zj = jax_ref.lm_mamba2.init_mamba2_state(3, cfg_j)
    assert [tuple(t.shape) for t in zero] == [tuple(t.shape) for t in zj]


def test_cross_entropy_loss(jax_ref):
    logits = _rand(19, 2, 5, 32, scale=3.0)
    labels = np.random.default_rng(20).integers(0, 32, (2, 5)).astype(np.int32)
    (lj, yj), (lt, yt) = _both(jax_ref, logits, labels)
    _hold(cross_entropy_loss(lt, yt), jax_ref.lm_common.cross_entropy_loss(lj, yj))


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------
def _ctx_cache(jax_ref, cfg_j, cfg, c_j, c_t, b, ctx, dtypes):
    """Decode caches of context ``ctx`` holding the prefill caches."""
    jnp = jax_ref.jnp
    cache_j = jax_ref.transformer.init_decode_state(cfg_j, b, ctx, dtype=dtypes[0])
    cache_t = T.init_decode_state(cfg, b, ctx, dtype=dtypes[1])
    s = None
    for key in cache_t:
        if key == "len":
            continue
        if key in ("k", "v"):
            s = c_t[key].shape[3]
            cache_j[key] = cache_j[key].at[:, :, :, :s].set(c_j[key].astype(dtypes[0]))
            cache_t[key][:, :, :, :s] = c_t[key].to(dtypes[1])
        else:
            cache_j[key] = c_j[key].astype(cache_j[key].dtype)
            cache_t[key] = c_t[key].to(cache_t[key].dtype)
    cache_j["len"] = jnp.asarray(s, jnp.int32)
    cache_t["len"] = torch.tensor(s, dtype=torch.int32)
    return cache_j, cache_t


def _walk(jax_ref, models, arch, params_t, batch, steps, dtypes, seed=0):
    """Prefill on ``batch`` and ``steps`` teacher-forced decode steps in
    both packages; yields (reference, port) logits and caches."""
    cfg_j, params_j, cfg, _ = models(arch)
    jnp = jax_ref.jnp
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: (torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v))
          for k, v in batch.items()}
    lg_j, c_j = jax_ref.lm_model.make_prefill_step(cfg_j)(params_j, bj)
    lg_t, c_t = M.make_prefill_step(cfg)(params_t, bt)
    yield (lg_j, c_j), (lg_t, c_t)
    b = next(iter(batch.values())).shape[0]
    cache_j, cache_t = _ctx_cache(jax_ref, cfg_j, cfg, c_j, c_t, b, 40, dtypes)
    dec_j, dec_t = jax_ref.lm_model.make_decode_step(cfg_j), M.make_decode_step(cfg)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        if "tokens" in batch:
            nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
            sj, st = {"tokens": jnp.asarray(nxt)}, {"tokens": torch.from_numpy(nxt).long()}
        else:
            nxt = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
            sj, st = {"embeds": jnp.asarray(nxt)}, {"embeds": torch.from_numpy(nxt)}
        lg_j, cache_j = dec_j(params_j, cache_j, sj)
        lg_t, cache_t = dec_t(params_t, cache_t, st)
        yield (lg_j, cache_j), (lg_t, cache_t)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_model_fp32_matches_reference(jax_ref, models, fp32, arch):
    """float32 compute in both packages: prefill logits, every cache leaf
    and a decode walk within 1e-4."""
    f32 = (jax_ref.jnp.float32, torch.float32)
    for (lg_j, c_j), (lg_t, c_t) in _walk(jax_ref, models, arch, models(arch)[3],
                                          {"tokens": _tokens(21, 2, 19)}, 3, f32):
        assert lg_t.dtype == torch.float32
        _hold(lg_t, lg_j, MODEL_TOL)
        assert sorted(c_t) == sorted(c_j)
        for key, v in c_j.items():
            if v is None:
                assert c_t[key] is None, key
            else:
                _hold(c_t[key], v, MODEL_TOL)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_fp32_and_aux(jax_ref, models, fp32, arch):
    cfg_j, params_j, cfg, params_t = models(arch)
    toks = _tokens(22, 2, 24)
    lg_j, aux_j, _ = jax_ref.lm_model.forward(params_j, cfg_j, tokens=jax_ref.jnp.asarray(toks))
    lg_t, aux_t, _ = M.forward(params_t, cfg, tokens=torch.from_numpy(toks).long())
    _hold(lg_t, lg_j, MODEL_TOL)
    assert sorted(aux_t) == sorted(aux_j)
    for k in aux_j:
        _hold(torch.as_tensor(aux_t[k]), aux_j[k], MODEL_TOL)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_model_bf16_matches_reference(jax_ref, models, arch):
    """As served (bfloat16 compute, the serving copies), teacher-forced:
    logits within BF16_REL of the largest logit."""
    bf16 = (jax_ref.jnp.bfloat16, torch.bfloat16)
    params_t = M.serving_params(models(arch)[3])
    for (lg_j, _), (lg_t, _) in _walk(jax_ref, models, arch, params_t,
                                      {"tokens": _tokens(23, 2, 16)}, 4, bf16):
        assert lg_t.dtype == torch.float32
        a, b = np_of(lg_j), np_of(lg_t)
        assert np.abs(a - b).max() <= BF16_REL * np.abs(a).max()


@pytest.mark.parametrize("arch", ["chameleon-34b", "musicgen-large"])
def test_embeds_inputs(jax_ref, models, fp32, arch):
    """The stub frontends' precomputed embeddings instead of token ids."""
    assert not get_config(arch).embed_inputs
    f32 = (jax_ref.jnp.float32, torch.float32)
    emb = _rand(24, 2, 11, 64)
    for (lg_j, _), (lg_t, _) in _walk(jax_ref, models, arch, models(arch)[3],
                                      {"embeds": emb}, 2, f32):
        _hold(lg_t, lg_j, MODEL_TOL)
    cfg_j, params_j, cfg, params_t = models(arch)
    lg_j, _, _ = jax_ref.lm_model.forward(params_j, cfg_j, embeds=jax_ref.jnp.asarray(emb))
    lg_t, _, _ = M.forward(params_t, cfg, embeds=torch.from_numpy(emb))
    _hold(lg_t, lg_j, MODEL_TOL)


def test_prefill_decode_consistency(models):
    """The port's own decode of token s+1 after a prefill of s == the last
    logits of a prefill of s+1 (the reference's test, dense attention)."""
    cfg, params = models("qwen1.5-0.5b")[2], models("qwen1.5-0.5b")[3]
    toks = torch.from_numpy(_tokens(25, 2, 17)).long()
    last, _ = M.make_prefill_step(cfg)(params, {"tokens": toks})
    _, cache = M.make_prefill_step(cfg)(params, {"tokens": toks[:, :16]})
    state = T.init_decode_state(cfg, 2, 17)
    state["k"][:, :, :, :16] = cache["k"]
    state["v"][:, :, :, :16] = cache["v"]
    state["len"] = torch.tensor(16, dtype=torch.int32)
    dl, _ = M.make_decode_step(cfg)(params, state, {"tokens": toks[:, 16:]})
    assert float((dl - last).abs().max()) <= BF16_REL * float(last.abs().max())


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def _record_reference(server):
    """Wrap the reference Server's steps to keep each request's logits
    rows in order (the prefills run in submission order)."""
    rows, order = {}, []
    prefill, decode = server.prefill, server.decode_step

    def rec_prefill(params, batch):
        logits, cache = prefill(params, batch)
        rows.setdefault(order.pop(0), []).append(np.asarray(logits[0], np.float32))
        return logits, cache

    def rec_decode(params, cache, batch):
        active = [(i, r.rid) for i, r in enumerate(server.slots) if r is not None]
        logits, cache = decode(params, cache, batch)
        for i, rid in active:
            rows[rid].append(np.asarray(logits[i], np.float32))
        return logits, cache

    server.prefill, server.decode_step = rec_prefill, rec_decode
    return rows, order


def _serve(server, requests):
    for req in requests:
        server.submit(req)
    while server.step():
        pass
    return {r.rid: list(r.generated) for r in server.done}


def _assert_tokens_equal_or_tie(got, want, rows):
    """Equal tokens, except from a request's first differing token on,
    where the reference's own top-2 gap there must be a near tie."""
    assert sorted(got) == sorted(want)
    for rid, toks in want.items():
        assert len(got[rid]) == len(toks)
        diff = [i for i, (a, b) in enumerate(zip(got[rid], toks)) if a != b]
        if diff:
            row = np.sort(rows[rid][diff[0]])
            assert row[-1] - row[-2] <= BF16_REL * np.abs(row).max(), (rid, diff[0])


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve_both(jax_ref, models, arch, prompts, capacity, max_new, ctx=64):
    cfg_j, params_j, cfg, params_t = models(arch)
    js = jax_ref.lm_serve
    got = _serve(serve.Server(cfg, M.serving_params(params_t), capacity=capacity, ctx_len=ctx),
                 [serve.Request(rid=i, prompt=p, max_new=max_new)
                  for i, p in enumerate(prompts)])
    ref = js.Server(cfg_j, params_j, capacity=capacity, ctx_len=ctx)
    rows, order = _record_reference(ref)
    order.extend(range(len(prompts)))
    want = _serve(ref, [js.Request(rid=i, prompt=p, max_new=max_new)
                        for i, p in enumerate(prompts)])
    return got, want, rows


@pytest.mark.parametrize("lens", [(8, 8, 8, 8), (8, 12, 8, 40)], ids=["equal", "ragged"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m", "chameleon-34b",
                                  "musicgen-large"])
def test_server_matches_reference(jax_ref, models, arch, lens):
    """4 requests through 2 slots (slot reuse), equal or ragged prompts:
    the reference's Server's tokens, with the one ``len`` per batch of
    both (ROADMAP C13)."""
    got, want, rows = _serve_both(jax_ref, models, arch, _prompts(26, lens), 2, 5)
    _assert_tokens_equal_or_tie(got, want, rows)


def test_batch_mate_changes_tokens_in_both_packages(jax_ref, models):
    """ROADMAP C13: an 8-token request decodes other tokens beside a
    12-token one than alone (and the same beside another 8-token one),
    in both packages alike."""
    a, b = _prompts(27, (8, 12))
    c = _prompts(28, (8,))[0]
    alone = _serve_both(jax_ref, models, "qwen1.5-0.5b", [a], 2, 6)
    paired = _serve_both(jax_ref, models, "qwen1.5-0.5b", [a, b], 2, 6)
    lockstep = _serve_both(jax_ref, models, "qwen1.5-0.5b", [a, c], 2, 6)
    for got, want, rows in (alone, paired, lockstep):
        _assert_tokens_equal_or_tie(got, want, rows)
    for side in (0, 1):  # the port's tokens, then the reference's
        assert alone[side][0] == [154, 92, 38, 113, 120, 23]
        assert paired[side][0] == [154, 92, 92, 92, 113, 80]
        assert lockstep[side][0] == alone[side][0]  # equal lengths: lockstep


@pytest.fixture(scope="module")
def zamba2_steps(jax_ref, models):
    """The reference's prefill and decode steps of reduced zamba2, jitted
    once for the module."""
    cfg_j = models("zamba2-7b")[0]
    return (jax_ref.jax.jit(jax_ref.lm_model.make_prefill_step(cfg_j)),
            jax_ref.jax.jit(jax_ref.lm_model.make_decode_step(cfg_j)))


def _composed_reference(jax_ref, models, steps, prompt, max_new, ctx):
    """The reference's prefill and decode steps for one request alone,
    every state leaf carried: its greedy tokens and logits rows."""
    cfg_j, params_j, _, _ = models("zamba2-7b")
    jnp = jax_ref.jnp
    prefill, decode = steps
    logits, c1 = prefill(params_j, {"tokens": jnp.asarray(prompt[None])})
    cache = jax_ref.transformer.init_decode_state(cfg_j, 1, ctx)
    for key, v in c1.items():
        if v is None:
            continue
        if key in ("k", "v"):
            cache[key] = cache[key].at[:, :, :, :len(prompt)].set(v.astype(cache[key].dtype))
        else:
            cache[key] = v.astype(cache[key].dtype)
    cache["len"] = jnp.asarray(len(prompt), jnp.int32)
    rows = [np.asarray(logits[0], np.float32)]
    toks = [int(np.argmax(rows[-1]))]
    while len(toks) < max_new:
        logits, cache = decode(params_j, cache, {"tokens": jnp.asarray([[toks[-1]]], jnp.int32)})
        rows.append(np.asarray(logits[0], np.float32))
        toks.append(int(np.argmax(rows[-1])))
    return toks, rows


@pytest.mark.parametrize("capacity", [1, 2, 4])
def test_zamba2_server_matches_composed_reference(jax_ref, models, zamba2_steps, capacity):
    """zamba2's served tokens against the reference's steps composed per
    request (equal prompt lengths, so the slots decode in lockstep and the
    batch's one ``len`` is each slot's own)."""
    cfg, params_t = models("zamba2-7b")[2], models("zamba2-7b")[3]
    prompts = _prompts(28, (10, 10, 10, 10))
    got = _serve(serve.Server(cfg, M.serving_params(params_t), capacity=capacity, ctx_len=32),
                 [serve.Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)])
    want, rows = {}, {}
    for i, p in enumerate(prompts):
        want[i], rows[i] = _composed_reference(jax_ref, models, zamba2_steps, p, 5, 32)
    _assert_tokens_equal_or_tie(got, want, rows)


def test_reference_server_loses_zamba2_group_state(jax_ref, models):
    """ROADMAP C12: after admission, the reference's slot keeps a zero
    ``group_ssm`` (its copy assumes the batch on axis 1); the port's
    holds the prefill's state.  At capacity 2 = per_group the reference's
    admission crashes."""
    cfg_j, params_j, cfg, params_t = models("zamba2-7b")
    prompt = _prompts(29, (10,))[0]
    js = jax_ref.lm_serve
    ref = js.Server(cfg_j, params_j, capacity=4, ctx_len=32)
    ref.submit(js.Request(rid=0, prompt=prompt, max_new=3))
    ref._admit()
    assert not np.asarray(ref.cache["group_ssm"]).any()
    assert np.asarray(ref.cache["tail_ssm"]).any()
    mine = serve.Server(cfg, M.serving_params(params_t), capacity=4, ctx_len=32)
    mine.submit(serve.Request(rid=0, prompt=prompt, max_new=3))
    mine._admit()
    assert bool(mine.cache["group_ssm"][:, :, 0].abs().gt(0).any())
    assert not bool(mine.cache["group_ssm"][:, :, 1:].any())
    _, c1 = M.make_prefill_step(cfg)(M.serving_params(params_t),
                                     {"tokens": torch.from_numpy(prompt[None]).long()})
    assert torch.equal(mine.cache["group_ssm"][:, :, 0], c1["group_ssm"][:, :, 0])
    assert torch.equal(mine.cache["group_conv"][:, :, 0], c1["group_conv"][:, :, 0])
    crash = js.Server(cfg_j, params_j, capacity=2, ctx_len=32)
    crash.submit(js.Request(rid=0, prompt=prompt, max_new=3))
    with pytest.raises(ValueError, match="broadcast"):
        crash._admit()


def test_server_records_moe_drop_fractions(models):
    cfg, params_t = models("moonshot-v1-16b-a3b")[2], models("moonshot-v1-16b-a3b")[3]
    server = serve.Server(cfg, M.serving_params(params_t), capacity=4, ctx_len=32)
    _serve(server, [serve.Request(rid=i, prompt=p, max_new=4)
                    for i, p in enumerate(_prompts(30, (6, 6, 6, 6)))])
    assert len(server.drop_fractions) == server.decode_steps == 3
    assert all(0.0 <= f < 1.0 for f in server.drop_fractions)
    dense = serve.Server(*models("qwen1.5-0.5b")[2:], capacity=2, ctx_len=32)
    _serve(dense, [serve.Request(rid=0, prompt=_prompts(31, (5,))[0], max_new=3)])
    assert dense.drop_fractions == []


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_cli_reduced_on_cpu(arch):
    args = serve.parse_args(["--arch", arch, "--reduced", "--device", "cpu",
                             "--requests", "3", "--capacity", "2",
                             "--prompt-len", "8", "--max-new", "3"])
    server = serve.serve_lm(args)
    assert len(server.done) == 3 and server.prefills == 3
    vocab = get_config(arch).reduced().vocab_size
    assert all(len(r.generated) == 3 and all(0 <= t < vocab for t in r.generated)
               for r in server.done)


def test_serve_cli_runs_a_family_as_module(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "zamba2-7b",
         "--reduced", "--device", "cpu", "--requests", "2", "--capacity", "2",
         "--prompt-len", "4", "--max-new", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "served 2 requests (zamba2-7b" in proc.stderr


def test_serve_cli_rejects_unknown_arch(capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "spidr-gesture"])
    assert "unknown LM arch" in capsys.readouterr().err
