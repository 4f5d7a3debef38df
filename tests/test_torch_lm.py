"""Port parity, the LM serving path (RWKV6), against repro.models.

At the reduced config (2 layers, d_model 64, one wkv head of 64, d_ff 128,
vocab 256), on identical weights carried across with
``convert.lm_params_from_jax``:

  * every rwkv6 function fed float32 inputs: the reference then runs the
    whole algorithm in float32, so the tolerance is tight (FP32_TOL, a few
    float32 roundings summed in another order);
  * the whole model in float32 (both packages' COMPUTE_DTYPE patched), as
    tight;
  * the whole model as served, in bfloat16, teacher-forced so both see the
    same tokens: bfloat16 rounds at other places in XLA-CPU (which fuses
    elementwise ops and keeps float32 between them) and in torch (which
    rounds after every op), and those differences grow through the layers,
    so the logits are held to BF16_REL of the largest logit, the
    reference's own bar for bfloat16 comparisons of this model
    (tests/test_models_archs.py, chunked vs recurrent);
  * the Server against the reference's Server: the same tokens, except
    where the reference's top-2 logit gap is within that tolerance.
"""
import numpy as np
import pytest
import torch

from _torch_parity import jax_ref, np_of  # noqa: F401
from repro_torch.configs.base import ArchConfig, get_config, list_archs
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import rwkv6 as R
from repro_torch.models import transformer as T
from repro_torch.models.common import rmsnorm

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 0.05


@pytest.fixture(scope="module")
def lm(jax_ref):
    """Reduced rwkv6 config and parameters in both packages (same weights)."""
    jax = jax_ref.jax
    cfg_j = jax_ref.lm_configs.get_config("rwkv6-7b").reduced()
    params_j = jax_ref.lm_model.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = lm_params_from_jax(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, params_j, get_config("rwkv6-7b").reduced(), params_t


def _layer(jax_ref, lm, i=0):
    cfg_j, params_j, cfg, params_t = lm
    lj = jax_ref.jax.tree.map(lambda x: x[i], params_j["blocks"]["layers"]["rwkv"])
    return lj, T.layer(params_t["blocks"], i)["rwkv"]


def _inputs(seed, b=2, s=20, d=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    x_prev = rng.normal(size=(b, d)).astype(np.float32)
    s0 = (rng.normal(size=(b, d // 64, 64, 64)) * 0.1).astype(np.float32)
    return x, x_prev, s0


def _hold(got, want, tol=FP32_TOL):
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), **tol)


def _both(jax_ref, *arrays):
    return ([jax_ref.jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def test_config_registry():
    cfg = get_config("rwkv6-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (32, 4096, 14336, 65536)
    assert cfg.head_dim_ == 64 and cfg.padded_vocab == 65536
    assert isinstance(cfg.reduced(), ArchConfig) and cfg.reduced().n_layers == 2
    assert "zamba2-7b" in list_archs() and "spidr-gesture" in list_archs(False)
    for name in list_archs():  # every registry LM resolves
        assert isinstance(get_config(name), ArchConfig) and get_config(name).name == name
    with pytest.raises(KeyError):
        get_config("gpt-5")
    assert get_config("spidr-gesture").name


def test_every_family_inits():
    for family, extra in (("dense", {}), ("audio", {"ffn_variant": "gelu"}),
                          ("vlm", {"qk_norm": True}),
                          ("moe", {"n_experts": 4, "top_k": 2, "d_ff": 32}),
                          ("hybrid", {"n_layers": 7, "attn_period": 3, "ssm_state": 16})):
        kw = dict(name="x", family=family, n_layers=1, d_model=64, n_heads=4,
                  n_kv_heads=4, d_ff=128, vocab_size=256)
        kw.update(extra)
        cfg = ArchConfig(**kw)
        params = M.init_params(torch.Generator().manual_seed(0), cfg)
        assert params["embed"].shape == (256, 64) and params["blocks"], family


def test_config_matches_reference(jax_ref):
    for name in ("rwkv6-7b",):
        cj, ct = jax_ref.lm_configs.get_config(name), get_config(name)
        for c_j, c_t in ((cj, ct), (cj.reduced(), ct.reduced())):
            for f in ("n_layers", "d_model", "n_heads", "d_ff", "vocab_size",
                      "head_dim_", "padded_vocab", "rmsnorm_eps", "family"):
                assert getattr(c_j, f) == getattr(c_t, f), f


def test_init_params_match_reference_layout(jax_ref, lm):
    cfg_j, params_j, cfg, params_t = lm
    mine = M.init_params(torch.Generator().manual_seed(0), cfg)
    shapes_j = jax_ref.jax.tree.map(lambda x: tuple(x.shape), params_j)
    shapes_t = {"embed": tuple(mine["embed"].shape),
                "final_norm": tuple(mine["final_norm"].shape),
                "lm_head": tuple(mine["lm_head"].shape)}
    for k, v in shapes_t.items():
        assert shapes_j[k] == v, k
    layers_j = shapes_j["blocks"]["layers"]
    layers_t = mine["blocks"]["layers"]
    assert layers_j["ln1"] == tuple(layers_t["ln1"].shape)
    for name, shp in layers_j["rwkv"]._asdict().items():
        t = getattr(layers_t["rwkv"], name)
        assert shp == tuple(t.shape), name
        assert t.dtype == torch.float32
    # converted params keep the reference's values
    _hold(params_t["blocks"]["layers"]["rwkv"].wr, params_j["blocks"]["layers"]["rwkv"].wr,
          dict(rtol=0, atol=0))


def test_serving_params_dtypes(lm):
    sp = M.serving_params(lm[3])
    assert sp["embed"].dtype == sp["lm_head"].dtype == torch.bfloat16
    assert sp["final_norm"].dtype == sp["blocks"]["layers"]["ln1"].dtype == torch.float32
    for name, t in sp["blocks"]["layers"]["rwkv"]._asdict().items():
        want = torch.float32 if name in R.FLOAT32_LEAVES else torch.bfloat16
        assert t.dtype == want, name


def test_rmsnorm_matches_reference(jax_ref):
    x = np.random.default_rng(0).normal(size=(3, 5, 64)).astype(np.float32)
    w = np.linspace(0.5, 1.5, 64).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = rmsnorm(xb, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    _hold(rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
          jax_ref.lm_common.rmsnorm(jax_ref.jnp.asarray(x), jax_ref.jnp.asarray(w)))


def test_ddlerp_and_decay_log(jax_ref, lm):
    lj, lt = _layer(jax_ref, lm)
    x, x_prev, _ = _inputs(1)
    xs = np.concatenate([x_prev[:, None], x[:, :-1]], axis=1)
    (xj, xsj), (xt, xst) = _both(jax_ref, x, xs)
    for a, b in zip(R._ddlerp(lt, xt, xst), jax_ref.rwkv6._ddlerp(lj, xj, xsj)):
        _hold(a, b)
    _hold(R._decay_log(lt, xt), jax_ref.rwkv6._decay_log(lj, xj))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-route"])
@pytest.mark.parametrize("s", [20, 32, 70])
def test_time_mix_fp32(jax_ref, lm, s, use_kernel):
    cfg_j, _, cfg, _ = lm
    lj, lt = _layer(jax_ref, lm, 1)
    (xj, pj, sj), (xt, pt, st) = _both(jax_ref, *_inputs(s, s=s))
    before = dict(LAUNCHES)
    got = R.rwkv6_time_mix(lt, xt, pt, st, cfg, use_kernel=use_kernel)
    assert LAUNCHES == before  # CPU tensors: the kernel route is the plain version
    for a, b in zip(got, jax_ref.rwkv6.rwkv6_time_mix(lj, xj, pj, sj, cfg_j)):
        _hold(a, b)


def test_channel_mix_fp32(jax_ref, lm):
    lj, lt = _layer(jax_ref, lm)
    x, x_prev, _ = _inputs(3)
    (xj, pj), (xt, pt) = _both(jax_ref, x, x_prev)
    for a, b in zip(R.rwkv6_channel_mix(lt, xt, pt),
                    jax_ref.rwkv6.rwkv6_channel_mix(lj, xj, pj)):
        _hold(a, b)
    x1j, x1t = xj[:, :1], xt[:, :1]
    for a, b in zip(R.rwkv6_channel_mix_decode(lt, x1t, pt),
                    jax_ref.rwkv6.rwkv6_channel_mix_decode(lj, x1j, pj)):
        _hold(a, b)


def test_time_mix_decode_fp32(jax_ref, lm):
    cfg_j, _, cfg, _ = lm
    lj, lt = _layer(jax_ref, lm)
    x, x_prev, s0 = _inputs(4, s=1)
    (xj, pj, sj), (xt, pt, st) = _both(jax_ref, x, x_prev, s0)
    for a, b in zip(R.rwkv6_time_mix_decode(lt, xt, pt, st, cfg),
                    jax_ref.rwkv6.rwkv6_time_mix_decode(lj, xj, pj, sj, cfg_j)):
        _hold(a, b)


def test_padded_prefill_state_decays(jax_ref, lm):
    """A 16-token prompt is padded to one chunk of 32 with log-decay -0.1:
    the returned state is the 16-token state times exp(-1.6), in both
    packages (ROADMAP C3, a finding about the reference)."""
    cfg_j, _, cfg, _ = lm
    lj, lt = _layer(jax_ref, lm)
    (xj, pj, sj), (xt, pt, st) = _both(jax_ref, *_inputs(5, s=16))
    _, _, s_pad = R.rwkv6_time_mix(lt, xt, pt, st, cfg)
    _, _, s_j = jax_ref.rwkv6.rwkv6_time_mix(lj, xj, pj, sj, cfg_j)
    _hold(s_pad, s_j)
    r, k, v, lw, _ = R._time_mix_inputs(lt, xt, pt)
    u = lt.bonus_u.reshape(1, 64)
    _, s_16 = R._wkv_chunked(r, k, v, lw, u, st, 16)  # no padding
    _hold(s_pad, s_16 * np.exp(np.float32(-1.6)), dict(rtol=1e-5, atol=1e-6))


def _patch_compute_dtype(monkeypatch, jax_ref, dtype_j, dtype_t):
    monkeypatch.setattr(jax_ref.lm_model, "COMPUTE_DTYPE", dtype_j)
    monkeypatch.setattr(M, "COMPUTE_DTYPE", dtype_t)


def _decode_walk(jax_ref, lm, params_t, tokens, steps, dtypes):
    """Prefill on ``tokens`` and ``steps`` teacher-forced decode steps in
    both packages, with decode caches of ``dtypes`` (reference, port);
    yields the (reference, port) logits of each step."""
    cfg_j, params_j, cfg, _ = lm
    jnp = jax_ref.jnp
    lg_j, c_j = jax_ref.lm_model.make_prefill_step(cfg_j)(params_j, {"tokens": jnp.asarray(tokens)})
    lg_t, c_t = M.make_prefill_step(cfg)(params_t, {"tokens": torch.from_numpy(tokens).long()})
    yield lg_j, lg_t
    b = tokens.shape[0]
    cache_j = jax_ref.transformer.init_decode_state(cfg_j, b, 64, dtype=dtypes[0])
    cache_t = T.init_decode_state(cfg, b, 64, dtype=dtypes[1])
    for key in ("x_tm", "x_cm", "s"):
        cache_j[key] = c_j[key].astype(cache_j[key].dtype)
        cache_t[key] = c_t[key].to(cache_t[key].dtype)
    dec_j = jax_ref.lm_model.make_decode_step(cfg_j)
    dec_t = M.make_decode_step(cfg)
    rng = np.random.default_rng(steps)
    for _ in range(steps):
        nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        lg_j, cache_j = dec_j(params_j, cache_j, {"tokens": jnp.asarray(nxt)})
        lg_t, cache_t = dec_t(params_t, cache_t, {"tokens": torch.from_numpy(nxt).long()})
        yield lg_j, lg_t


def test_model_fp32_matches_reference(jax_ref, lm, monkeypatch):
    """The whole model with float32 compute in both packages: tight."""
    f32 = (jax_ref.jnp.float32, torch.float32)
    _patch_compute_dtype(monkeypatch, jax_ref, *f32)
    tokens = np.random.default_rng(6).integers(0, 256, (2, 24)).astype(np.int32)
    for lg_j, lg_t in _decode_walk(jax_ref, lm, lm[3], tokens, 3, f32):
        assert lg_t.dtype == torch.float32
        _hold(lg_t, lg_j, dict(rtol=1e-4, atol=1e-4))


@pytest.mark.parametrize("serving", [False, True], ids=["fp32-masters", "serving-params"])
def test_model_bf16_matches_reference(jax_ref, lm, serving):
    """As served (bfloat16 compute), teacher-forced: logits within
    BF16_REL of the largest logit."""
    params_t = M.serving_params(lm[3]) if serving else lm[3]
    tokens = np.random.default_rng(7).integers(0, 256, (2, 16)).astype(np.int32)
    bf16 = (jax_ref.jnp.bfloat16, torch.bfloat16)
    for lg_j, lg_t in _decode_walk(jax_ref, lm, params_t, tokens, 4, bf16):
        assert lg_t.dtype == torch.float32 and tuple(lg_t.shape) == (2, 256)
        a, b = np_of(lg_j), np_of(lg_t)
        assert np.abs(a - b).max() <= BF16_REL * np.abs(a).max()


def test_chunked_vs_recurrent_equivalence(lm):
    """The port's own chunked prefill == its token-by-token recurrence."""
    cfg, params = lm[2], lm[3]
    b, s = 2, 16
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (b, s)).astype(np.int64))
    logits_full, _, _ = M.forward(params, cfg, tokens=tokens)
    decode = M.make_decode_step(cfg)
    cache = T.init_decode_state(cfg, b, s, dtype=torch.float32)
    outs = []
    for t in range(s):
        lg, cache = decode(params, cache, {"tokens": tokens[:, t:t + 1]})
        outs.append(lg)
    a, bb = np_of(logits_full), np_of(torch.stack(outs, dim=1))
    assert np.abs(a - bb).max() / (np.abs(a).max() + 1e-9) < BF16_REL
    assert int(cache["len"]) == s


def _serve(server, requests):
    for req in requests:
        server.submit(req)
    while server.step():
        pass
    return {r.rid: list(r.generated) for r in server.done}


def test_server_matches_reference(jax_ref, lm):
    """Continuous batching (4 requests through 2 slots, slot reuse): the
    same tokens as the reference's Server, except where the reference's
    own top-2 logit gap is within the tolerance."""
    cfg_j, params_j, cfg, params_t = lm
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (8, 12, 8, 40)]
    js = jax_ref.lm_serve
    got = _serve(serve.Server(cfg, M.serving_params(params_t), capacity=2, ctx_len=64),
                 [serve.Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)])
    want = _serve(js.Server(cfg_j, params_j, capacity=2, ctx_len=64),
                  [js.Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)])
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    forward = jax_ref.lm_model.forward
    for rid, toks in want.items():
        assert len(got[rid]) == len(toks) == 5
        diff = [i for i, (a, b) in enumerate(zip(got[rid], toks)) if a != b]
        if diff:  # a near tie at the first differing token, by the reference's logits
            i = diff[0]
            seq = np.concatenate([prompts[rid], np.asarray(toks[:i], np.int32)])
            logits, _, _ = forward(params_j, cfg_j, tokens=jax_ref.jnp.asarray(seq[None]))
            last = np.sort(np.asarray(logits[0, -1]))
            assert last[-1] - last[-2] <= BF16_REL * np.abs(last).max(), (rid, i)


def test_server_counts_and_slot_reuse(lm):
    cfg, params = lm[2], M.serving_params(lm[3])
    server = serve.Server(cfg, params, capacity=2, ctx_len=16)
    rng = np.random.default_rng(9)
    reqs = [serve.Request(rid=i, prompt=rng.integers(0, 256, 6).astype(np.int32),
                          max_new=n) for i, n in enumerate((3, 20, 2))]
    done = _serve(server, reqs)
    assert server.prefills == 3
    assert len(done[0]) == 3 and len(done[2]) == 2
    assert len(done[1]) == 16 - 1 - 6 + 1  # retired by the context capacity
    assert server.slots == [None, None] and not server.waiting


def test_serve_cli_reduced_on_cpu():
    args = serve.parse_args(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                             "--requests", "3", "--capacity", "2",
                             "--prompt-len", "8", "--max-new", "3"])
    server = serve.serve_lm(args)
    assert len(server.done) == 3 and server.prefills == 3
    assert all(len(r.generated) == 3 for r in server.done)


def test_serve_cli_runs_as_module(tmp_path):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "rwkv6-7b",
         "--reduced", "--device", "cpu", "--requests", "2", "--capacity", "2",
         "--prompt-len", "4", "--max-new", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "served 2 requests" in proc.stderr


def test_lm_params_from_jax_rejects_unknown_groups():
    from collections import namedtuple

    Other = namedtuple("Other", ["a"])
    with pytest.raises(TypeError, match="Other"):
        lm_params_from_jax({"x": Other(np.zeros(2))}, "cpu")
