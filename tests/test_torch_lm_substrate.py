"""Port parity, the LM training substrate (ROADMAP A12.2): the token
pipeline, gradient compression, the fault-tolerant training loop, a
reference checkpoint resumed in the port, the train CLI for every arch,
the demo; and two more train-step checks against the reference (the bf16
loss, ``accum_steps=2``), here so that each of the two LM-training files
runs in about a minute.

  * ``synth_tokens`` and the bfloat16 ``embeds`` are the reference's bytes
    for every ``(seed, step)`` tried; the compression functions give the
    reference's q, scale, residual and top-k mask exactly;
  * a ``TrainingLoop`` that fails mid-run (after a step has already
    updated the parameters in place) restores and replays to the same
    final parameters, bit for bit, as a run that never failed;
  * a checkpoint written by the reference's ``TrainingLoop`` resumes in the
    port's and trains on to the reference's parameters within
    ``tests/test_grad_accum.py``'s bounds.
"""
import json
import shutil

import numpy as np
import pytest
import torch

from _torch_parity import jax_ref  # noqa: F401
from repro_torch.checkpoint.checkpoint import Checkpointer, tree_flatten
from repro_torch.configs.base import get_config, list_archs
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import TokenPipeline, synth_tokens
from repro_torch.launch import lm_pretrain_demo
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.optim import compression as C
from repro_torch.runtime import LoopConfig, RestartableFailure, TrainingLoop
from test_torch_lm_train import (LR, _batch, _hold_params, _ref_loss,  # noqa: F401
                                 _torch_batch, fp32, models)

ARCHS = list_archs()


# ---------------------------------------------------------------------------
# The token pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (123, 4096)])
def test_synth_tokens_are_the_references_bytes(jax_ref, seed, step):
    for batch, seq, vocab in ((4, 33, 50), (8, 128, 151936)):
        want = jax_ref.lm_pipeline.synth_tokens(seed, step, batch, seq, vocab)
        got = synth_tokens(seed, step, batch, seq, vocab)
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("step", [0, 5, 99])
def test_pipeline_batches_are_the_references(jax_ref, step):
    """Tokens and labels; the stub-frontend ``embeds`` in bfloat16 rounded
    to nearest even as ``ml_dtypes`` does (compared as raw 16-bit words)."""
    for embeds_dim in (0, 48):
        ref = jax_ref.lm_pipeline.TokenPipeline(3, 20, 97, seed=2, embeds_dim=embeds_dim)
        mine = TokenPipeline(3, 20, 97, seed=2, embeds_dim=embeds_dim, device="cpu")
        want, got = ref.batch_at(step), mine.batch_at(step)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            if k == "embeds":
                assert got[k].dtype == torch.bfloat16
                assert got[k].view(torch.int16).numpy().tobytes() == \
                    w.view(np.int16).tobytes()
            else:
                assert got[k].dtype == torch.int32
                assert got[k].numpy().tobytes() == w.tobytes()


def test_pipeline_prefetch_yields_batch_at_in_order():
    pipe = TokenPipeline(2, 16, 31, seed=5, prefetch=2, device="cpu")
    it = iter(pipe)
    try:
        for step in range(4):
            got = next(it)
            assert torch.equal(got["tokens"], pipe.batch_at(step)["tokens"])
    finally:
        pipe.close()
    assert not pipe._worker.is_alive()


def test_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TokenPipeline(2, 16, 31)


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------
def _grad_tree(seed):
    g = np.random.default_rng(seed)
    scale = 10.0 ** g.uniform(-4, 2)
    return {"a": (g.standard_normal((7, 33)) * scale).astype(np.float32),
            "b": [None, (g.standard_normal(129) * scale).astype(np.float32)],
            "z": np.zeros((3, 4), np.float32)}


def _to_torch(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("seed", range(4))
def test_compression_matches_reference(jax_ref, seed):
    jnp, ref = jax_ref.jnp, jax_ref.compression
    tree = _grad_tree(seed)
    for x in (tree["a"], tree["b"][1], tree["z"]):
        qj, sj = ref.int8_compress(jnp.asarray(x))
        qt, st = C.int8_compress(torch.from_numpy(x))
        assert qt.dtype == torch.int8
        assert np.array_equal(qt.numpy(), np.asarray(qj))
        assert st.numpy().tobytes() == np.asarray(sj).tobytes()
        assert np.array_equal(C.int8_decompress(qt, st).numpy(),
                              np.asarray(ref.int8_decompress(qj, sj)))
        for frac in (0.01, 0.1, 0.5):
            kj, mj = ref.topk_compress(jnp.asarray(x), frac)
            kt, mt = C.topk_compress(torch.from_numpy(x), frac)
            assert np.array_equal(mt.numpy(), np.asarray(mj))
            assert np.array_equal(kt.numpy(), np.asarray(kj))


@pytest.mark.parametrize("seed", range(2))
def test_error_feedback_allreduce_matches_reference(jax_ref, seed):
    """Two steps of EF int8 over one member: the reference's ``psum`` over
    an axis of size 1 (a ``vmap`` axis), run op by op, gives the port's
    sums and carried residuals exactly.  (Under ``jit`` XLA fuses the
    residual ``(g + e) - q * scale`` into one multiply-add, which rounds
    once where the written expression rounds twice.)"""
    jax, jnp, ref = jax_ref.jax, jax_ref.jnp, jax_ref.compression

    def ef_j(g, e):
        lead = jax.tree.map(lambda x: x[None], (g, e))
        out = jax.vmap(lambda a, b: ref.ef_int8_allreduce(a, b, "pod"),
                       axis_name="pod")(*lead)
        return jax.tree.map(lambda x: x[0], out)

    e_j = ref.init_error_state(jax.tree.map(jnp.asarray, _grad_tree(seed)))
    e_t = C.init_error_state(_to_torch(_grad_tree(seed)))
    assert e_t["b"][0] is None and torch.equal(e_t["z"], torch.zeros(3, 4))
    for step in range(2):
        g = _grad_tree(seed * 10 + step)
        out_j, e_j = ef_j(jax.tree.map(jnp.asarray, g), e_j)
        out_t, e_t = C.ef_int8_allreduce(_to_torch(g), e_t)
        for got, want in ((out_t, out_j), (e_t, e_j)):
            leaves = tree_flatten(got)
            assert leaves[1] is None          # b[0]: the None leaf stays None
            for a, w in zip([x for x in leaves if x is not None], jax.tree.leaves(want)):
                assert a.numpy().tobytes() == np.asarray(w).tobytes()


# ---------------------------------------------------------------------------
# The training loop and checkpoints
# ---------------------------------------------------------------------------
def _qwen():
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    return cfg, params, M.init_opt_state(params)


def _run_loop(tmp, steps, fail_at=None, every=2):
    cfg, params, opt = _qwen()
    pipe = TokenPipeline(2, 16, cfg.vocab_size, seed=0, device="cpu")
    step_fn = M.make_train_step(cfg, lr=LR)
    failed = []

    def flaky(p, o, step, batch):
        out = step_fn(p, o, step, batch)       # the parameters move in place ...
        if step == fail_at and not failed:
            failed.append(step)
            raise RestartableFailure(f"injected at step {step}")   # ... then it fails
        return out

    loop = TrainingLoop(flaky, pipe.batch_at, Checkpointer(tmp),
                        LoopConfig(total_steps=steps, checkpoint_every=every))
    params, opt, history = loop.run(params, opt)
    return params, opt, history, loop


def test_loop_restores_and_replays_bit_exact(tmp_path):
    clean = _run_loop(tmp_path / "clean", 5)
    flaky = _run_loop(tmp_path / "flaky", 5, fail_at=3)
    assert clean[3].restarts == 0 and flaky[3].restarts == 1
    # steps 0-2, then step 3 fails, step 2's checkpoint is restored: 2, 3, 4
    assert len(flaky[2]) == 6 and flaky[2][:3] == clean[2][:3]
    assert flaky[2][3:] == clean[2][2:]
    for tree_a, tree_b in ((clean[0], flaky[0]), (clean[1], flaky[1])):
        for a, b in zip(tree_flatten(tree_a), tree_flatten(tree_b)):
            assert (a is None and b is None) or torch.equal(a, b)
    assert Checkpointer(tmp_path / "flaky").latest_step() == 5


def test_loop_gives_up_without_a_checkpoint(tmp_path):
    with pytest.raises(RestartableFailure):
        _run_loop(tmp_path, 3, fail_at=0, every=100)


def test_reference_checkpoint_resumes_in_the_port(jax_ref, models, fp32, tmp_path):
    """The reference trains 2 steps under its TrainingLoop (a checkpoint at
    step 2); the port's loop resumes that directory and trains steps 2-3;
    the reference's own loop, resumed from a copy, does the same."""
    jax = jax_ref.jax
    cfg_j, params_j, cfg, _ = models("qwen1.5-0.5b")
    ref_loop = jax_ref.lm_loop
    pipe_j = jax_ref.lm_pipeline.TokenPipeline(2, 16, cfg_j.vocab_size, seed=0)
    step_j = jax.jit(jax_ref.lm_model.make_train_step(cfg_j, lr=LR))

    def run_ref(directory, steps):
        loop = ref_loop.TrainingLoop(
            lambda p, o, s, b: step_j(p, o, s, b), pipe_j.batch_at,
            jax_ref.checkpoint.Checkpointer(str(directory)),
            ref_loop.LoopConfig(total_steps=steps, checkpoint_every=2))
        return loop.run(params_j, jax_ref.lm_model.init_opt_state(params_j))

    run_ref(tmp_path / "run", 2)
    shutil.copytree(tmp_path / "run", tmp_path / "ref")
    want_p, want_o, want_h = run_ref(tmp_path / "ref", 4)

    params = M.init_params(torch.Generator().manual_seed(7), cfg)   # overwritten
    opt = M.init_opt_state(params)
    loop = TrainingLoop(M.make_train_step(cfg, lr=LR),
                        TokenPipeline(2, 16, cfg.vocab_size, seed=0, device="cpu").batch_at,
                        Checkpointer(tmp_path / "run"),
                        LoopConfig(total_steps=4, checkpoint_every=2))
    params, opt, history = loop.run(params, opt)
    assert len(history) == len(want_h) == 2
    np.testing.assert_allclose(history, want_h, rtol=1e-5)
    _hold_params(params, want_p, jax_ref)
    _hold_params(opt["mu"], want_o["mu"], jax_ref)
    # The port's own checkpoint of step 4 holds the reference's tree.
    restored = Checkpointer(tmp_path / "run").restore(4, (params, opt))
    assert len(tree_flatten(restored)) == len(jax.tree.leaves(
        (want_p, want_o), is_leaf=lambda x: x is None))


def test_checkpoint_roundtrips_the_lm_tree(tmp_path):
    """NamedTuple groups and ``None`` leaves survive save / restore."""
    cfg = get_config("zamba2-7b").reduced()
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    ck = Checkpointer(tmp_path)
    ck.save(1, params)
    back = ck.restore(1, params)
    assert type(back["blocks"]["shared"]["attn"]) is type(params["blocks"]["shared"]["attn"])
    for a, b in zip(tree_flatten(params), tree_flatten(back)):
        assert (a is None and b is None) or np.array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# The bf16 loss and microbatching against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_reference(jax_ref, models, arch):
    """As trained (bfloat16 compute): the loss within 1e-2 relative (bf16
    rounds at other places in XLA and PyTorch)."""
    jnp = jax_ref.jnp
    cfg_j, params_j, cfg, params_np = models(arch)
    b = _batch(cfg)
    want = float(jax_ref.jax.jit(_ref_loss(jax_ref, cfg_j, {
        k: jnp.asarray(v) for k, v in b.items()}))(params_j))
    got, _, _ = M.loss_and_grads(cfg, lm_params_from_jax(params_np, "cpu"),
                                 _torch_batch(b))
    assert abs(float(got) - want) <= 1e-2 * abs(want)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m", "zamba2-7b"])
def test_grad_accumulation_matches_reference(jax_ref, models, fp32, arch):
    """``accum_steps=2`` against the reference's: the metrics it keeps
    (loss, grad_norm, ce_loss) and the updated parameters."""
    jax, jnp = jax_ref.jax, jax_ref.jnp
    cfg_j, params_j, cfg, params_np = models(arch)
    b = _batch(cfg, batch=4)
    step_j = jax.jit(jax_ref.lm_model.make_train_step(cfg_j, lr=LR, accum_steps=2))
    new_j, _, metrics_j = step_j(params_j, jax_ref.lm_model.init_opt_state(params_j), 0,
                                 {k: jnp.asarray(v) for k, v in b.items()})
    params = lm_params_from_jax(params_np, "cpu")
    new, _, metrics = M.make_train_step(cfg, lr=LR, accum_steps=2)(
        params, M.init_opt_state(params), 0, _torch_batch(b))
    assert sorted(metrics) == sorted(metrics_j) == ["ce_loss", "grad_norm", "loss"]
    for k in ("loss", "ce_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(metrics_j[k]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(metrics_j["grad_norm"]),
                               rtol=1e-4)
    _hold_params(new, new_j, jax_ref)


# ---------------------------------------------------------------------------
# The CLI and the demo
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_every_arch_on_cpu(arch, tmp_path, capsys):
    assert train_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                           "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["arch"] == arch and out["steps"] == 3 and len(out["history"]) == 3
    assert all(np.isfinite(out["history"])) and out["restarts"] == 0
    assert out["launches"] == {}          # the plain versions on the CPU
    assert Checkpointer(tmp_path).latest_step() == 3


def test_train_cli_default_batch_and_seq(tmp_path, capsys):
    """The reference's CLI defaults: batch 8, 128 tokens."""
    assert train_cli.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
                           "--steps", "3", "--ckpt-dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert (out["batch"], out["seq"], len(out["history"])) == (8, 128, 3)


def test_train_cli_rejects_an_unknown_arch(capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "gpt-5", "--device", "cpu"])
    assert "qwen1.5-0.5b" in capsys.readouterr().err


def test_demo_smoke_trains_and_resumes(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("SPIDR_SMOKE", "1")
    assert lm_pretrain_demo.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    assert "over 12 steps" in capsys.readouterr().out
    assert Checkpointer(tmp_path).latest_step() == 12
    # Run again with a larger budget: it resumes at step 12.
    assert lm_pretrain_demo.main(["--device", "cpu", "--ckpt-dir", str(tmp_path),
                                  "--steps", "30"]) == 0
    assert "over 18 steps" in capsys.readouterr().out
