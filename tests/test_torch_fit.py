"""Port parity, training: repro_torch.optim.optimizer, snn.train
(``train_step`` from a carried state, ``fit``, ``precision_sweep``), the
train CLIs, and train->deploy across the two packages.

Tolerances: the optimizers, schedules and norms within ``rtol = 1e-5``
(float32 against the reference's float32, the port's host schedules in
float64); one ``train_step`` from the same state on the same batch: the
loss, accuracy or AEE and grad norm within ``rtol = 1e-5``, params, ``mu``
and ``nu`` within ``rtol = 1e-4`` and ``atol = 1e-6 * max|x|`` (the
gradients' float32 sums in another order).  Every deployment comparison
is exact.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, cuda_device, jax_ref, np_of  # noqa: F401
from repro_torch import spidr
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import spidr_gesture, spidr_optflow
from repro_torch.convert import train_state_from_jax
from repro_torch.core import layers, neuron, quant
from repro_torch.launch import train as train_cli
from repro_torch.launch import train_gesture
from repro_torch.optim import optimizer as opt
from repro_torch.snn import export, train

NETS = {"gesture": ((16, 16), 4), "flow": ((8, 16), 3)}


def assert_close(got, want, rtol=1e-4) -> None:
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * max(scale, 1e-30))


def _specs(jax_ref, net):
    hw, t = NETS[net]
    mod, mod_j = ((spidr_gesture, jax_ref.spidr_gesture) if net == "gesture"
                  else (spidr_optflow, jax_ref.spidr_optflow))
    return mod.reduced(hw=hw, timesteps=t), mod_j.reduced(hw=hw, timesteps=t)


def _batch(net, rng, batch=4):
    hw, t = NETS[net]
    ev = (rng.random((t, batch) + hw + (2,)) < 0.25).astype(np.float32)
    if net == "gesture":
        return ev, rng.integers(0, 11, batch)
    return ev, rng.normal(size=(batch,) + hw + (2,)).astype(np.float32)


# ---------------------------------------------------------------------------
# Optimizers, schedules, norms
# ---------------------------------------------------------------------------
def _tree(rng):
    return [rng.normal(size=(6, 4)).astype(np.float32), None,
            rng.normal(size=(3,)).astype(np.float32)]


def _as(tree, fn):
    return [None if x is None else fn(x) for x in tree]


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(lr=1e-2, weight_decay=1e-2)),
    ("adamw", dict(lr=1e-2, schedule=True)),
    ("sgd", dict(lr=1e-2)),
    ("sgd", dict(lr=1e-2, nesterov=True)),
    ("lion", dict(lr=1e-3, weight_decay=0.1)),
])
def test_optimizers_match_reference(jax_ref, name, kw):
    rng = np.random.default_rng(len(name) + len(kw))
    params = _tree(rng)
    kw = dict(kw)
    if kw.pop("schedule", False):
        kw["lr_schedule"] = "warmup"
    jkw, tkw = dict(kw), dict(kw)
    if "lr_schedule" in kw:
        jkw["lr_schedule"] = jax_ref.optimizer.linear_warmup_cosine(1e-2, 2, 5)
        tkw["lr_schedule"] = opt.linear_warmup_cosine(1e-2, 2, 5)
    upd_j, st_j = getattr(jax_ref.optimizer, name)(
        params=_as(params, jax_ref.jnp.asarray), **jkw)
    upd_t, st_t = getattr(opt, name)(params=_as(params, torch.from_numpy), **tkw)
    p_j, p_t = _as(params, jax_ref.jnp.asarray), _as(params, torch.from_numpy)
    for step in range(4):
        g = _tree(rng)
        u_j, st_j = upd_j(_as(g, jax_ref.jnp.asarray), st_j, p_j, step)
        u_t, st_t = upd_t(_as(g, torch.from_numpy), st_t, p_t, step)
        p_j = jax_ref.optimizer.apply_updates(p_j, u_j)
        p_t = opt.apply_updates(p_t, u_t)
        for a, b in zip(p_t, p_j):
            assert (a is None) == (b is None)
            if a is not None:
                assert_close(a, b, rtol=1e-5)
    flat = (lambda s: s) if name != "adamw" else (lambda s: s["mu"] + s["nu"])
    for a, b in zip(flat(st_t), flat(st_j)):
        if a is not None:
            assert_close(a, b, rtol=1e-5)


@pytest.mark.parametrize("sched,args", [
    ("cosine_schedule", (1e-3, 10)), ("cosine_schedule", (2e-3, 7, 0.3)),
    ("linear_warmup_cosine", (1e-3, 3, 12)), ("linear_warmup_cosine", (1e-3, 0, 5)),
    ("linear_warmup_cosine", (5e-4, 10, 10, 0.2)),
])
def test_schedules_match_reference(jax_ref, sched, args):
    mine, theirs = getattr(opt, sched)(*args), getattr(jax_ref.optimizer, sched)(*args)
    for step in range(0, 15):
        for s in (step, step + 1.0):  # adamw evaluates at step + 1
            np.testing.assert_allclose(mine(s), float(theirs(jax_ref.jnp.float32(s))),
                                       rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 100.0])
def test_clip_by_global_norm_matches_reference(jax_ref, max_norm):
    g = _tree(np.random.default_rng(int(max_norm * 10)))
    got, norm = opt.clip_by_global_norm(_as(g, torch.from_numpy), max_norm)
    want, norm_j = jax_ref.optimizer.clip_by_global_norm(_as(g, jax_ref.jnp.asarray),
                                                         max_norm)
    assert_close(norm, norm_j, rtol=1e-6)
    assert_close(opt.global_norm(_as(g, torch.from_numpy)),
                 jax_ref.optimizer.global_norm(_as(g, jax_ref.jnp.asarray)), rtol=1e-6)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert_close(a, b, rtol=1e-6)


def test_train_config_fields_match_reference(jax_ref):
    mine = [(f.name, f.default) for f in dataclasses.fields(train.TrainConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jax_ref.train.TrainConfig)]
    assert mine == theirs
    with pytest.raises(ValueError, match="mode"):
        train.TrainConfig(mode="int")


# ---------------------------------------------------------------------------
# One train_step from the same carried state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("mode", ["qat", "train"])
def test_train_step_from_a_carried_state(jax_ref, net, mode):
    spec, spec_j = _specs(jax_ref, net)
    rng = np.random.default_rng([len(net), len(mode)])
    kw = dict(mode=mode, lr=2e-3, warmup=2, steps=10)
    cfg, cfg_j = train.TrainConfig(**kw), jax_ref.train.TrainConfig(**kw)
    jnp = jax_ref.jnp
    state_j = jax_ref.train.init_train_state(jax_ref.jax.random.PRNGKey(0), spec_j, cfg_j)
    state_j, _ = jax_ref.train.train_step(
        state_j, tuple(jnp.asarray(x) for x in _batch(net, rng)), spec_j, cfg_j)
    state = train_state_from_jax(state_j, "cpu")
    assert state.step == 1
    batch = _batch(net, rng)
    new_j, m_j = jax_ref.train.train_step(state_j, tuple(jnp.asarray(x) for x in batch),
                                          spec_j, cfg_j)
    new, m = train.train_step(state, tuple(torch.from_numpy(x) for x in batch), spec, cfg)
    assert new.step == new_j.step == 2
    assert sorted(m) == sorted(m_j)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5)
    for mine, theirs in ((new.params, new_j.params),
                         (new.opt_state["mu"], new_j.opt_state["mu"]),
                         (new.opt_state["nu"], new_j.opt_state["nu"])):
        for a, b in zip(mine, theirs):
            assert (a is None) == (b is None)
            if a is not None:
                assert_close(a, b)


def test_loss_drops_on_a_fixed_batch():
    """Overfitting one batch, as the reference's ``test_snn_system``."""
    spec = spidr_gesture.reduced(hw=(16, 16), timesteps=5)
    cfg = train.TrainConfig(weight_bits=4, lr=2e-3)
    state = train.init_train_state(torch.Generator().manual_seed(0), spec, cfg)
    batch = train.make_batch_fn(spec, cfg, batch=4, device="cpu")(
        torch.Generator().manual_seed(1))
    losses = []
    for _ in range(12):
        state, m = train.train_step(state, batch, spec, cfg)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# fit, checkpoints, precision_sweep
# ---------------------------------------------------------------------------
_FIT = dict(weight_bits=4, lr=2e-3, steps=4, warmup=1, batch=2, hw=(16, 16),
            timesteps=3, eval_batch=4, eval_batches=1)


def test_fit_is_deterministic_per_seed():
    spec = spidr_gesture.CONFIG
    runs = [train.fit(spec, train.TrainConfig(seed=s, **_FIT), log_every=0, device="cpu")
            for s in (0, 0, 1)]
    (a, ha), (b, hb), (c, hc) = runs
    assert ha["loss"] == hb["loss"] and ha["final"] == hb["final"]
    for x, y in zip(a.params, b.params):
        assert (x is None and y is None) or torch.equal(x, y)
    assert ha["loss"] != hc["loss"]
    assert a.step == 4 and ha["metric"] == "accuracy" and len(ha["loss"]) == 4


def test_fit_checkpoints_restore_in_the_reference(jax_ref, tmp_path):
    spec = spidr_optflow.CONFIG
    cfg = train.TrainConfig(ckpt_every=2, eval_every=2, **_FIT)
    state, hist = train.fit(spec, cfg, ckpt=Checkpointer(tmp_path), log_every=1,
                            device="cpu")
    assert [s for s, _ in hist["evals"]] == [2, 4] and hist["metric"] == "aee"
    ck_j = jax_ref.checkpoint.Checkpointer(str(tmp_path))
    assert ck_j.latest_step() == 4
    like = [None if p is None else np.zeros(p.shape, np.float32) for p in state.params]
    restored = ck_j.restore(4, like)
    for p, r in zip(state.params, restored):
        assert (p is None) == (r is None)
        if p is not None:
            assert_same(p, r)
    assert len(ck_j.restore(2, like)) == len(like)


def test_precision_sweep_exports_round_trip_exactly():
    cfg = train.TrainConfig(**{**_FIT, "steps": 2})
    out = train.precision_sweep("gesture", bits=(4, 6, 8), cfg=cfg,
                                generator=torch.Generator().manual_seed(3), device="cpu")
    assert sorted(out) == [4, 6, 8]
    spec = train.effective_spec(train.spec_for("gesture"), cfg)
    ev, _ = train.make_batch_fn(spec, cfg, batch=2, device="cpu")(
        torch.Generator().manual_seed(9))
    for b, r in out.items():
        assert r["exported"].weight_bits == b and r["metric"] == r["history"]["final"]
        assert all(np.isfinite(r["history"]["loss"]))
        engine = export.deploy(r["exported"], spec, device="cpu")
        rt = export.verify_roundtrip(r["state"].params, spec, engine, ev, r["exported"])
        assert rt.exact, (b, rt)


# ---------------------------------------------------------------------------
# The CLIs and the two packages' artifacts
# ---------------------------------------------------------------------------
def test_train_cli_export_runs_bit_exact_in_the_reference(jax_ref, tmp_path, capsys):
    assert train_cli.main(["--snn", "gesture", "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--n-cores", "4",
                           "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["n_cores"] for r in out["roundtrips"]] == [1, 4]
    assert all(r["exact"] for r in out["roundtrips"])
    assert out["hw"] == [32, 32] and out["timesteps"] == 5 and out["launches"] == {}
    export_dir = tmp_path / "exported"
    mine = spidr.load(export_dir, device="cpu")
    theirs = jax_ref.spidr.load(str(export_dir))
    assert theirs.spec.input_hw == (32, 32)
    ev = (np.random.default_rng(7).random((5, 2, 32, 32, 2)) < 0.1).astype(np.float32)
    a, b = mine.run(torch.from_numpy(ev)), theirs.run(jax_ref.jnp.asarray(ev))
    assert_same(a.readout, b.readout)
    assert_same(a.spike_counts, b.spike_counts)
    # the reference proves the port-trained params' round trip too
    params = Checkpointer(tmp_path).restore(2, [
        None if ex is None else np.zeros(ex.w_q.shape, np.float32)
        for ex in mine.exported.layers])
    assert jax_ref.spidr.load(str(export_dir)).verify(
        jax_ref.jnp.asarray(ev), params=params).roundtrip.exact


def test_reference_trained_net_deploys_bit_exact_in_the_port(jax_ref, tmp_path):
    spec_j = jax_ref.train.effective_spec(
        jax_ref.train.spec_for("optical-flow"),
        jax_ref.train.TrainConfig(hw=(8, 16), timesteps=3))
    cfg_j = jax_ref.train.TrainConfig(weight_bits=6, steps=2, warmup=0, batch=2,
                                      hw=(8, 16), timesteps=3, eval_batch=2,
                                      eval_batches=1)
    state_j, _ = jax_ref.train.fit(spec_j, cfg_j, log_every=0)
    ex_j = jax_ref.export.export_network(state_j.params, spec_j,
                                         jax_ref.quant.QuantSpec(6))
    jax_ref.spidr.compile(ex_j, spec_j, jax_ref.spidr.DeployTarget(weight_bits=6)).save(
        str(tmp_path))
    ev = (np.random.default_rng(8).random((3, 2, 8, 16, 2)) < 0.2).astype(np.float32)
    for n_cores in (1, 4):
        mine = spidr.load(tmp_path, target=spidr.DeployTarget(weight_bits=6,
                                                              n_cores=n_cores),
                          device="cpu")
        report = mine.verify(torch.from_numpy(ev),
                             params=[None if p is None else np.asarray(p)
                                     for p in state_j.params])
        assert report.exact and report.roundtrip.exact, (n_cores, report)
        want = jax_ref.spidr.load(str(tmp_path)).run(jax_ref.jnp.asarray(ev))
        got = mine.run(torch.from_numpy(ev))
        assert_same(got.readout, want.readout)
        assert_same(got.spike_counts, want.spike_counts)


def test_train_gesture_smoke(tmp_path, capsys):
    assert train_gesture.main(["--smoke", "--device", "cpu", "--ckpt", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert "round trip exact=True" in text and "for 5 steps on cpu" in text


def test_entry_points_raise_without_a_card(tmp_path):
    """``device=None`` means the card: without one, nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = spidr_gesture.reduced(hw=(16, 16), timesteps=2)
    with pytest.raises(RuntimeError, match="cuda"):
        train.fit(spec, train.TrainConfig(**_FIT))
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--snn", "gesture", "--reduced", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        train_gesture.main(["--smoke", "--ckpt", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "1",
                        "--ckpt-dir", str(tmp_path / "lm")])


# ---------------------------------------------------------------------------
# On the card: B3 under autograd, and the QAT step with TF32 on
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("nrn", ["lif_hard", "if_soft"])
def test_b3_autograd_matches_the_plain_composition_on_card(cuda_device, nrn):
    """One gesture-conv layer-timestep (M = 4 * 64 * 64, K = 144, N = 16):
    B3's forward and hand-written backward against autograd of the plain
    ``matmul`` + ``neuron_step`` on the card, full fp32.  A spike may flip
    only within 1e-5 of the threshold; the cotangents are zeroed there."""
    from repro_torch.kernels import LAUNCHES

    model, reset = nrn.split("_")
    n = neuron.NeuronConfig(model=model, reset=reset, threshold=0.5, leak=0.95,
                            surrogate_width=2.0)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    m, k, nn = 4 * 64 * 64, 144, 16
    cols = (torch.rand((m, k), generator=g, device=cuda_device) < 0.2).float()
    wq = quant.ste_quantize(torch.randn((k, nn), generator=g, device=cuda_device) * 0.3, 4)
    v = torch.randn((m, nn), generator=g, device=cuda_device) * 0.5
    gv, gs = torch.randn((2, m, nn), generator=g, device=cuda_device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = LAUNCHES["fused_lif_gemm"]
        outs = []
        for fn in (lambda c, w, vv: layers._FusedLifGemmTrain.apply(c, w, vv, n),
                   lambda c, w, vv: neuron.neuron_step(vv, c @ w, n)):
            leaves = [x.clone().requires_grad_(True) for x in (cols, wq, v)]
            outs.append((leaves, fn(*leaves)))
        assert LAUNCHES["fused_lif_gemm"] == before + 1
        (_, (vk, sk)), (_, (vp, sp)) = outs
        leak = n.leak if model == "lif" else 1.0
        v_pre = v * leak + cols @ wq
        flipped = sk != sp
        assert bool(((v_pre - n.threshold).abs()[flipped] <= 1e-5).all())
        keep = (~flipped).float()
        for leaves, (vv, ss) in outs:
            torch.autograd.backward([vv, ss], [gv * keep, gs * keep])
        for got, want in zip(outs[0][0], outs[1][0]):
            err = float((got.grad - want.grad).abs().max())
            assert err <= 1e-4 * float(want.grad.abs().max()), err
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
