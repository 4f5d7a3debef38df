"""Port parity, LM training (ROADMAP A12.2): the train step against
repro.models.model.make_train_step, B7 under autograd, and the grad guard.

Every architecture runs at its ``reduced()`` config on the reference's own
weights (``convert.lm_params_from_jax``), both packages computing in
float32 (``COMPUTE_DTYPE`` patched), one batch of 2 x 16 tokens from numpy:

  * loss, ``ce_loss`` and the aux losses within 1e-5 relative; the
    gradient norm too, or within twice the reference's own change when
    every parameter moves by 1e-7 relative (float32 rounding), whichever
    is larger: reduced rwkv6-7b's norm moves 2.4e-5 under such a change,
    so another summation order alone parts the two packages by that much;
  * each gradient leaf against ``jax.grad`` of the reference's loss
    (``forward`` + ``cross_entropy_loss`` + the MoE aux weights) within
    1e-4 of the leaf's largest |gradient|;
  * the updated parameters within ``tests/test_grad_accum.py``'s bounds
    (rtol 2e-2, atol 2.5e-3): Adam's ``m / sqrt(v)`` turns tiny gradient
    differences into O(lr) update differences.

Also: remat on/off bit-equal, the in-place AdamW bit-equal to the functional
``adamw``, ``_WkvSequenceTrain`` on CPU tensors bit-equal to autograd of
the plain wkv, and the guard that stops a CUDA kernel's outputs from being
silently detached.  The ``gpu`` cases run on the card.  The bf16 loss and
``accum_steps=2`` are held in ``test_torch_lm_substrate.py``.
"""
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, jax_ref, np_of  # noqa: F401
from repro_torch.checkpoint.checkpoint import tree_flatten
from repro_torch.configs.base import get_config, list_archs
from repro_torch.convert import lm_params_from_jax, lm_train_state_from_jax
from repro_torch.kernels import _build
from repro_torch.kernels.ref import wkv_sequence_ref
from repro_torch.models import model as M
from repro_torch.models import rwkv6 as R
from repro_torch.optim import optimizer

ARCHS = list_archs()
BATCH, SEQ = 2, 16
LR = 1e-3
METRIC_RTOL = 1e-5
GRAD_REL = 1e-4
PARAM_TOL = dict(rtol=2e-2, atol=2.5e-3)   # tests/test_grad_accum.py's bounds


@pytest.fixture(scope="module")
def models(jax_ref):
    """arch -> (reference cfg, reference params, port cfg, numpy params)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jax = jax_ref.jax
            cfg_j = jax_ref.lm_configs.get_config(arch).reduced()
            params_j = jax_ref.lm_model.init_params(jax.random.PRNGKey(0), cfg_j)
            cache[arch] = (cfg_j, params_j, get_config(arch).reduced(),
                           jax.tree.map(np.asarray, params_j))
        return cache[arch]

    return get


@pytest.fixture
def fp32(monkeypatch, jax_ref):
    """Both packages computing in float32."""
    monkeypatch.setattr(jax_ref.lm_model, "COMPUTE_DTYPE", jax_ref.jnp.float32)
    monkeypatch.setattr(M, "COMPUTE_DTYPE", torch.float32)


def _batch(cfg, seed=1, batch=BATCH, seq=SEQ):
    """numpy labels (and tokens, or float32 stub embeddings)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out = {"labels": labels}
    if cfg.embed_inputs:
        out["tokens"] = labels
    else:
        out["embeds"] = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _ref_loss(jax_ref, cfg_j, batch_j):
    """The reference's train loss, built from its forward and CE."""
    jm = jax_ref.lm_model

    def loss(params):
        logits, aux, _ = jm.forward(params, cfg_j, tokens=batch_j.get("tokens"),
                                    embeds=batch_j.get("embeds"), remat=True)
        total = jax_ref.lm_common.cross_entropy_loss(logits[:, :-1],
                                                     batch_j["labels"][:, 1:])
        if aux:
            total = (total + jm.MOE_AUX_WEIGHT * aux.get("load_balance_loss", 0.0)
                     + jm.MOE_Z_WEIGHT * aux.get("router_z_loss", 0.0))
        return total

    return loss


def _live(tree):
    return [x for x in tree_flatten(tree) if x is not None]


def _global_norm(jax_ref, grads) -> float:
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                             for g in jax_ref.jax.tree.leaves(grads))))


def _hold_params(got_tree, want_tree, jax_ref):
    want = jax_ref.jax.tree.leaves(want_tree)
    got = _live(got_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_of(g), np.asarray(w), **PARAM_TOL)


# ---------------------------------------------------------------------------
# One train step of every arch against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(jax_ref, models, fp32, arch):
    jax, jnp = jax_ref.jax, jax_ref.jnp
    cfg_j, params_j, cfg, params_np = models(arch)
    b = _batch(cfg)
    batch_j = {k: jnp.asarray(v) for k, v in b.items()}

    grad_fn = jax.jit(jax.grad(_ref_loss(jax_ref, cfg_j, batch_j)))
    grads_j = grad_fn(params_j)
    key = jax.random.PRNGKey(3)
    nudged = jax.tree.map(lambda x: x * (1 + 1e-7 * jax.random.normal(key, x.shape)),
                          params_j)
    sensitivity = abs(_global_norm(jax_ref, grad_fn(nudged))
                      - _global_norm(jax_ref, grads_j))
    step_j = jax.jit(jax_ref.lm_model.make_train_step(cfg_j, lr=LR))
    new_j, _, metrics_j = step_j(params_j, jax_ref.lm_model.init_opt_state(params_j),
                                 0, batch_j)

    params = lm_params_from_jax(params_np, "cpu")
    _, _, grads = M.loss_and_grads(cfg, params, _torch_batch(b))
    for g, w in zip(_live(grads), jax.tree.leaves(grads_j)):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        assert np.abs(np_of(g) - w).max() <= GRAD_REL * np.abs(w).max(), arch

    new, _, metrics = M.make_train_step(cfg, lr=LR)(
        params, M.init_opt_state(params), 0, _torch_batch(b))
    assert new is params                           # updated in place
    assert sorted(metrics) == sorted(metrics_j)
    for k, v in metrics_j.items():
        want, got = float(v), float(metrics[k])
        tol = METRIC_RTOL * abs(want)
        if k == "grad_norm":
            tol = max(tol, 2 * sensitivity)
        assert abs(got - want) <= tol + 1e-12, (arch, k, got, want)
    _hold_params(new, new_j, jax_ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_gradient_bit(arch):
    """Activation checkpointing changes memory only: the same loss and
    gradients, bit for bit."""
    cfg = get_config(arch).reduced()
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    batch = _torch_batch(_batch(cfg))
    l1, m1, g1 = M.loss_and_grads(cfg, params, batch, remat=True)
    l0, m0, g0 = M.loss_and_grads(cfg, params, batch, remat=False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(m1[k], m0[k]) for k in m0)
    for a, b in zip(tree_flatten(g1), tree_flatten(g0)):
        assert (a is None and b is None) or torch.equal(a, b)


def test_inplace_adamw_equals_the_functional_adamw():
    """``adamw_inplace`` over an LM tree equals ``adamw`` + ``apply_updates``
    bit for bit, moments included, over three steps."""
    cfg = get_config("zamba2-7b").reduced()     # dicts, NamedTuples, a None tail
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    leaves = tree_flatten(params)
    assert any(x is None for x in leaves)
    g = torch.Generator().manual_seed(1)
    update, state = optimizer.adamw(lr=LR, weight_decay=0.1, params=leaves)
    ref = leaves
    mine = [None if p is None else p.clone() for p in leaves]
    mu, nu = [[None if p is None else torch.zeros_like(p) for p in leaves] for _ in "mn"]
    for step in range(3):
        grads = [None if p is None else torch.randn(p.shape, generator=g) for p in leaves]
        updates, state = update(grads, state, ref, step)
        ref = optimizer.apply_updates(ref, updates)
        optimizer.adamw_inplace(mine, grads, mu, nu, step, LR, weight_decay=0.1)
    for got, want in ((mine, ref), (mu, state["mu"]), (nu, state["nu"])):
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)


def test_opt_state_and_train_state_from_reference(jax_ref, models):
    cfg_j, params_j, cfg, params_np = models("rwkv6-7b")
    opt_np = jax_ref.jax.tree.map(np.asarray, jax_ref.lm_model.init_opt_state(params_j))
    params, opt = lm_train_state_from_jax(params_np, opt_np, "cpu")
    mine = M.init_opt_state(params)
    assert sorted(opt) == sorted(mine) == ["mu", "nu"]
    for k in ("mu", "nu"):
        for a, b in zip(tree_flatten(opt[k]), tree_flatten(mine[k])):
            assert torch.equal(a, b)
        assert len(tree_flatten(opt[k])) == len(tree_flatten(params))


# ---------------------------------------------------------------------------
# B7 under autograd, and the guard
# ---------------------------------------------------------------------------
def _wkv_inputs(b, s, h, n, seed=0, device="cpu"):
    g = np.random.default_rng(seed)
    r, k, v = (torch.tensor(g.standard_normal((b, s, h, n)) * 0.5, dtype=torch.float32,
                            device=device) for _ in range(3))
    lw = -torch.exp(torch.tensor(g.standard_normal((b, s, h, n)) - 2.0,
                                 dtype=torch.float32, device=device))
    u = torch.tensor(g.standard_normal((h, n)) * 0.1, dtype=torch.float32, device=device)
    s0 = torch.tensor(g.standard_normal((b, h, n, n)) * 0.1, dtype=torch.float32,
                      device=device)
    gy = torch.tensor(g.standard_normal((b, s, h, n)), dtype=torch.float32, device=device)
    gs = torch.tensor(g.standard_normal((b, h, n, n)), dtype=torch.float32, device=device)
    return [r, k, v, lw, u, s0], gy, gs


def _wkv_grads(fn, xs, gy, gs, chunk, with_state=True):
    xs = [x.detach().clone().requires_grad_() for x in xs]
    y, s = fn(*xs, chunk)
    loss = (y * gy).sum() + ((s * gs).sum() if with_state else 0.0)
    loss.backward()
    return y.detach(), s.detach(), [x.grad for x in xs]


@pytest.mark.parametrize("chunk,with_state", [(8, True), (16, False), (32, True)])
def test_wkv_function_equals_plain_autograd_on_cpu(chunk, with_state):
    """On CPU tensors ``_WkvSequenceTrain``'s forward is the plain wkv; its
    backward (the plain wkv recomputed and differentiated) gives autograd's
    gradients bit for bit, with or without a cotangent on the state."""
    xs, gy, gs = _wkv_inputs(2, 64, 2, 16)
    want = _wkv_grads(wkv_sequence_ref, xs, gy, gs, chunk, with_state)
    got = _wkv_grads(R._WkvSequenceTrain.apply, xs, gy, gs, chunk, with_state)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


def test_time_mix_takes_the_function_only_under_grad(monkeypatch):
    """The kernel route enters ``_WkvSequenceTrain`` when autograd needs the
    wkv's gradient, and the plain ``wkv_sequence`` call otherwise (serving
    is unchanged)."""
    calls = []
    real = R._WkvSequenceTrain.apply
    monkeypatch.setattr(R._WkvSequenceTrain, "apply",
                        lambda *a: calls.append(1) or real(*a))
    cfg = get_config("rwkv6-7b").reduced()
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    batch = _torch_batch(_batch(cfg))
    with torch.no_grad():
        M.forward(params, cfg, tokens=batch["tokens"], use_kernel=True)
    assert calls == []
    M.loss_and_grads(cfg, params, batch, use_kernel=True)
    assert len(calls) == 2 * cfg.n_layers     # forward and the remat recompute
    # The kernel route's gradients equal the plain route's on the CPU.
    _, _, g_kernel = M.loss_and_grads(cfg, params, batch, use_kernel=True)
    _, _, g_plain = M.loss_and_grads(cfg, params, batch, use_kernel=False)
    for a, b in zip(tree_flatten(g_kernel), tree_flatten(g_plain)):
        assert (a is None and b is None) or torch.equal(a, b)


def test_grad_guard_names_the_kernel():
    x = torch.ones(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="fused_lif_gemm_int.*requires grad"):
        _build.no_detach("fused_lif_gemm_int", torch.ones(4), x)
    with torch.no_grad():
        _build.no_detach("fused_lif_gemm_int", x)
    _build.no_detach("fused_lif_gemm_int", torch.ones(4))
    # CPU tensors take the plain, differentiable version: no refusal.
    assert _build.kernel_device("wkv_sequence", x) is None


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("chunk,n", [(c, n) for c in (8, 16, 32, 64) for n in (8, 16, 32, 64)])
def test_wkv_function_on_card_matches_plain_autograd(cuda_device, b, chunk, n):
    """B7 in ``_WkvSequenceTrain`` on the card against autograd of the plain
    wkv on the card: y and the state at B7's tolerance, the gradients (the
    same plain backward, at B7's forward inputs) within 1e-4 of each
    leaf's largest."""
    from repro_torch.kernels import LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    xs, gy, gs = _wkv_inputs(b, 4 * chunk, 2, n, device=cuda_device)
    want = _wkv_grads(wkv_sequence_ref, xs, gy, gs, chunk)
    before = LAUNCHES["wkv_sequence"]
    got = _wkv_grads(R._WkvSequenceTrain.apply, xs, gy, gs, chunk)
    assert LAUNCHES["wkv_sequence"] == before + 1        # the backward launches none
    for a, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-5)
    for a, w in zip(got[2], want[2]):
        assert (a - w).abs().max() <= GRAD_REL * w.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fused_lif_gemm_int", "fused_lif_gemm"])
def test_grad_guard_raises_on_card(cuda_device, kernel):
    """B1 (its common entry checks before the operand types) and B3 called
    under grad with an input that requires it, outside an autograd
    ``Function``, raise naming the kernel; nothing launches."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import fused_lif_gemm as F

    dev = cuda_device
    spikes = torch.zeros((64, 32), dtype=torch.int8 if kernel.endswith("int")
                         else torch.float32, device=dev)
    w = torch.zeros((32, 16), dtype=spikes.dtype, device=dev)
    v = torch.zeros((64, 16), dtype=torch.float32, device=dev, requires_grad=True)
    before = dict(LAUNCHES)
    with pytest.raises(RuntimeError, match=kernel + ".*requires grad"):
        if kernel == "fused_lif_gemm":
            F.fused_lif_gemm(spikes, w, v)
        else:
            F.fused_lif_gemm_int(spikes, w, v, 1)
    assert LAUNCHES == before
    with torch.no_grad():   # the same call without grad passes the guard
        if kernel == "fused_lif_gemm":
            F.fused_lif_gemm(spikes, w, v)


@pytest.mark.gpu
def test_bf16_head_product_has_a_gradient_on_card(cuda_device):
    """The bfloat16 head product (float32 out, ``torch.mm``'s ``out_dtype``,
    which has no derivative) under ``_HeadMatmul``: its gradients against
    float64 autograd of the same bfloat16 values, within bfloat16's
    rounding of the results (the cotangent rounds to bfloat16 first)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    h = torch.randn((256, 128), generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randn((128, 1000), generator=g, device=cuda_device).to(torch.bfloat16)
    gy = torch.randn((256, 1000), generator=g, device=cuda_device)
    a, b = h.clone().requires_grad_(), w.clone().requires_grad_()
    y = M._HeadMatmul.apply(a, b)
    assert y.dtype == torch.float32
    (y * gy).sum().backward()
    a64, b64 = h.double().requires_grad_(), w.double().requires_grad_()
    y64 = a64 @ b64
    (y64 * gy.double()).sum().backward()
    # float32 sums of 128 exact products: within 1e-6 of the largest output
    assert (y.double() - y64).abs().max() <= 1e-6 * y64.abs().max()
    for got, want in ((a.grad, a64.grad), (b.grad, b64.grad)):
        assert got.dtype == torch.bfloat16
        assert ((got.double() - want).abs() <= 2 ** -7 * want.abs().max()).all()
