"""Port parity, deploy-exact QAT: the STE quantizers, the surrogate spike,
the STE floor, ``neuron_step_qat``, the QAT layers, the first-maximum
max-pool, ``run_snn(mode="qat")`` and its gradients, the B3 autograd
wrapper's backward, and the train->deploy round trip, against repro.

Tolerances: every forward of the QAT path is compared exactly (tolerance
0).  Gradients match ``jax.grad`` / ``jax.vjp`` within ``rtol = 1e-4`` and
``atol = 1e-6 * max|g|`` (float32 sums in another order; the port's exact
product runs in float64).  The tie cases are pinned: a clip exactly at
``scale * v_max`` / ``scale * v_min`` takes half the gradient (trap 1),
a max-pool window sends its gradient to its first maximum (trap 2), and
the reference's flow loss has a NaN gradient at zero distance where the
port's is 0 (trap 3, ROADMAP C8).
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, cuda_device, jax_ref, np_of  # noqa: F401
from repro_torch import spidr
from repro_torch.configs import spidr_gesture, spidr_optflow
from repro_torch.convert import params_from_jax
from repro_torch.core import layers, network, neuron, quant
from repro_torch.core.quant import QuantSpec
from repro_torch.snn import export, train

RTOL = 1e-4
NETS = {"gesture": ((16, 16), 4), "flow": ((8, 16), 3)}


def assert_grad_close(got, want) -> None:
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * max(scale, 1e-30))


def _specs(jax_ref, net, hw=None, t=None):
    hw0, t0 = NETS[net]
    hw, t = hw or hw0, t or t0
    mod, mod_j = ((spidr_gesture, jax_ref.spidr_gesture) if net == "gesture"
                  else (spidr_optflow, jax_ref.spidr_optflow))
    return mod.reduced(hw=hw, timesteps=t), mod_j.reduced(hw=hw, timesteps=t)


def _params_np(jax_ref, spec_j, seed=0):
    return [None if p is None else np.asarray(p)
            for p in jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(seed), spec_j)]


def _events(spec, batch=2, seed=0, density=0.25):
    rng = np.random.default_rng([seed, batch])
    shape = (spec.timesteps, batch) + tuple(spec.input_hw) + (2,)
    return (rng.random(shape) < density).astype(np.float32)


def _leaf(x):
    return torch.tensor(x, requires_grad=True)


def _vjp(jax_ref, fn, primals, cotangents):
    """jax.vjp of ``fn`` at numpy ``primals`` against numpy ``cotangents``."""
    jnp = jax_ref.jnp
    out, pull = jax_ref.jax.vjp(fn, *[jnp.asarray(p) for p in primals])
    ct = jax_ref.jax.tree.map(jnp.asarray, cotangents)
    return out, pull(ct)


# ---------------------------------------------------------------------------
# STE quantizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("axis", [0, None])
def test_ste_quantize_po2_scaled_forward_and_gradient(jax_ref, bits, axis):
    rng = np.random.default_rng([bits, axis is None])
    w = rng.normal(scale=0.3, size=(144, 16)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel: scale 1
    g = rng.normal(size=w.shape).astype(np.float32)
    wt = _leaf(w)
    wq, scale = quant.ste_quantize_po2_scaled(wt, bits, axis)
    assert not scale.requires_grad
    (wq_j, scale_j), (gw,) = _vjp(
        jax_ref, lambda x: jax_ref.quant.ste_quantize_po2_scaled(x, bits, axis),
        [w], (g, np.zeros(np.shape(scale), np.float32)))
    assert_same(wq, wq_j)
    assert_same(scale, scale_j)
    wq.backward(torch.from_numpy(g))
    assert_same(wt.grad, gw)
    assert_same(quant.ste_quantize_po2(torch.from_numpy(w), bits, axis),
                jax_ref.quant.ste_quantize_po2(jax_ref.jnp.asarray(w), bits, axis))


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_ste_quantize_gradient_is_the_identity(jax_ref, bits):
    rng = np.random.default_rng(bits)
    w = rng.normal(scale=0.3, size=(18, 16)).astype(np.float32)
    g = rng.normal(size=w.shape).astype(np.float32)
    wt = _leaf(w)
    out = quant.ste_quantize(wt, bits)
    out_j, (gw,) = _vjp(jax_ref, lambda x: jax_ref.quant.ste_quantize(x, bits), [w], g)
    assert_same(out, out_j)
    out.backward(torch.from_numpy(g))
    assert_same(wt.grad, gw)


# ---------------------------------------------------------------------------
# The surrogate spike and the STE floor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("width", [1.0, 2.0, 0.5])
def test_spike_surrogate_gradient(jax_ref, per_channel, width):
    rng = np.random.default_rng([per_channel, int(width * 10)])
    thr = (rng.uniform(0.2, 0.8, 12).astype(np.float32) if per_channel
           else np.float32(0.5))
    v = rng.normal(scale=1.5, size=(3, 5, 12)).astype(np.float32)
    v[0, 0] = thr  # exactly at the threshold: fires, full slope
    v[0, 1] = thr + width  # the triangle's feet: slope 0
    v[0, 2] = thr - width
    g = rng.normal(size=v.shape).astype(np.float32)
    vt, tt = _leaf(v), _leaf(thr)
    s = neuron.spike_surrogate(vt, tt, width)
    s_j, (dv, dthr) = _vjp(
        jax_ref, lambda a, b: jax_ref.neuron.spike_surrogate(a, b, width), [v, thr], g)
    assert_same(s, s_j)
    s.backward(torch.from_numpy(g))
    assert_grad_close(vt.grad, dv)
    assert_grad_close(tt.grad, dthr)
    assert tt.grad.shape == tt.shape


def test_floor_ste(jax_ref):
    x = np.array([-2.5, -1.0, -0.25, 0.0, 0.75, 3.0], np.float32)
    g = np.arange(1, 7, dtype=np.float32)
    xt = _leaf(x)
    out = neuron._floor_ste(xt)
    out_j, (dx,) = _vjp(jax_ref, jax_ref.neuron._floor_ste, [x], g)
    assert_same(out, out_j)
    out.backward(torch.from_numpy(g))
    assert_same(xt.grad, dx)


# ---------------------------------------------------------------------------
# The deploy-exact neuron step
# ---------------------------------------------------------------------------
def _qat_inputs(bits, seed, n=12):
    """Vmem and current on a per-channel power-of-two grid, many of their
    sums exactly at ``scale * v_max`` or ``scale * v_min`` (trap 1)."""
    spec = QuantSpec(bits)
    rng = np.random.default_rng([bits, seed])
    scale = (2.0 ** rng.integers(-6, -1, n)).astype(np.float32)
    v_int = rng.integers(spec.v_min, spec.v_max + 1, (4, 6, n))
    c_int = rng.integers(spec.v_min, spec.v_max + 1, (4, 6, n))
    c_int[0] = spec.v_max - v_int[0]        # v + current == v_max
    c_int[1] = spec.v_min - v_int[1]        # v + current == v_min
    thr_int = rng.integers(1, spec.v_max // 2, n)
    return (spec, scale, (v_int * scale).astype(np.float32),
            np.clip(c_int * scale, spec.v_min * scale, spec.v_max * scale).astype(np.float32),
            (thr_int * scale).astype(np.float32))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("model,leak_shift", [("if", 3), ("lif", 3), ("lif", 0)])
@pytest.mark.parametrize("reset", ["hard", "soft"])
def test_neuron_step_qat_exact_and_gradient(jax_ref, bits, model, leak_shift, reset):
    spec, scale, v, cur, thr = _qat_inputs(bits, len(model) + leak_shift)
    kw = dict(model=model, reset=reset, leak_shift=leak_shift, surrogate_width=2.0,
              threshold=0.5)
    rng = np.random.default_rng(bits)
    gv, gs = (rng.normal(size=v.shape).astype(np.float32) for _ in range(2))
    vt, ct = _leaf(v), _leaf(cur)
    v_next, s = neuron.neuron_step_qat(vt, ct, neuron.NeuronConfig(**kw), spec,
                                       torch.from_numpy(scale), torch.from_numpy(thr))
    (vj, sj), (dv, dc) = _vjp(
        jax_ref, lambda a, b: jax_ref.neuron.neuron_step_qat(
            a, b, jax_ref.neuron.NeuronConfig(**kw), jax_ref.quant.QuantSpec(bits),
            jax_ref.jnp.asarray(scale), jax_ref.jnp.asarray(thr)),
        [v, cur], (gv, gs))
    assert_same(v_next, vj)
    assert_same(s, sj)
    torch.autograd.backward([v_next, s], [torch.from_numpy(gv), torch.from_numpy(gs)])
    assert_grad_close(vt.grad, dv)
    assert_grad_close(ct.grad, dc)


def test_qat_clip_gives_half_the_gradient_at_its_bounds(jax_ref):
    """Trap 1: ``jnp.clip`` splits a tie at a bound (gradient 0.5), where
    ``torch.clamp`` gives 1; v + current lands on ``scale * v_max`` and
    ``scale * v_min`` here, and the hard-reset IF step passes g_v through."""
    spec = QuantSpec(4)
    scale = np.float32(0.25)
    v = np.array([1.0, -1.0, 0.5, 0.0], np.float32)
    cur = np.array([spec.v_max * scale - 1.0, spec.v_min * scale + 1.0, 0.25, 20.0],
                   np.float32)
    cfg = dict(model="if", reset="soft", threshold=100.0)  # never fires
    thr = np.full(4, 100.0, np.float32)
    vt = _leaf(v)
    v_next, _ = neuron.neuron_step_qat(vt, torch.from_numpy(cur),
                                       neuron.NeuronConfig(**cfg), spec,
                                       torch.full((4,), 0.25), torch.from_numpy(thr))
    v_next.sum().backward()
    want = jax_ref.jax.grad(lambda a: jax_ref.neuron.neuron_step_qat(
        a, jax_ref.jnp.asarray(cur), jax_ref.neuron.NeuronConfig(**cfg),
        jax_ref.quant.QuantSpec(4), jax_ref.jnp.full((4,), 0.25),
        jax_ref.jnp.asarray(thr))[0].sum())(jax_ref.jnp.asarray(v))
    # at v_max, at v_min (each clip halves it; soft reset clips twice), inside
    # (1), above v_max (0)
    assert_same(vt.grad, want)
    assert vt.grad.tolist() == [0.25, 0.25, 1.0, 0.0]


# ---------------------------------------------------------------------------
# The max-pool's tie rule
# ---------------------------------------------------------------------------
def test_maxpool_gradient_goes_to_the_first_maximum(jax_ref):
    """Trap 2: the window [[0, 1], [1, 1]] sends its gradient to (0, 1)."""
    x = np.array([[0, 1], [1, 1]], np.float32).reshape(1, 2, 2, 1)
    xt = _leaf(x)
    layers.maxpool2d(xt).sum().backward()
    want = jax_ref.jax.grad(lambda a: jax_ref.layers.maxpool2d(a).sum())(
        jax_ref.jnp.asarray(x))
    assert_same(xt.grad, want)
    assert xt.grad.reshape(2, 2).tolist() == [[0.0, 1.0], [0.0, 0.0]]


@pytest.mark.parametrize("window", [2, 8])
@pytest.mark.parametrize("kind", ["all_ones", "partly_tied", "spikes"])
def test_maxpool_forward_and_gradient(jax_ref, window, kind):
    rng = np.random.default_rng([window, len(kind)])
    shape = (2, 2 * window, 3 * window, 5)
    if kind == "all_ones":
        x = np.ones(shape, np.float32)
    elif kind == "partly_tied":
        x = rng.integers(0, 3, shape).astype(np.float32)
    else:
        x = (rng.random(shape) < 0.2).astype(np.float32)
    g = rng.normal(size=(2, 2, 3, 5)).astype(np.float32)
    xt = _leaf(x)
    out = layers.maxpool2d(xt, window, window)
    out_j, (dx,) = _vjp(jax_ref, lambda a: jax_ref.layers.maxpool2d(a, window, window),
                        [x], g)
    assert_same(out, out_j)
    out.backward(torch.from_numpy(g))
    assert_same(xt.grad, dx)
    # The forward without gradient is the same values, int8 planes included.
    assert_same(layers.maxpool2d(torch.from_numpy(x), window, window), out_j)
    assert_same(layers.maxpool2d(torch.from_numpy(x).to(torch.int8), window, window),
                np.asarray(out_j).astype(np.int8))


# ---------------------------------------------------------------------------
# The QAT layers
# ---------------------------------------------------------------------------
def _layer_case(bits, seed, dense):
    rng = np.random.default_rng([bits, seed, dense])
    if dense:
        x = (rng.random((3, 64)) < 0.3).astype(np.float32)
        w = rng.normal(scale=0.4, size=(64, 11)).astype(np.float32)
        v = np.zeros((3, 11), np.float32)
    else:
        x = (rng.random((2, 6, 7, 4)) < 0.3).astype(np.float32)
        w = rng.normal(scale=0.4, size=(36, 8)).astype(np.float32)
        v = np.zeros((2, 6, 7, 8), np.float32)
    return x, w, v


@pytest.mark.parametrize("mode", ["qat", "train"])
@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("fn", ["spiking_conv", "spiking_dense"])
@pytest.mark.parametrize("nrn", ["lif_hard", "if_soft"])
def test_layers_exact_forward_and_gradient(jax_ref, mode, bits, fn, nrn):
    """Two timesteps (the second from the first's Vmem) of one layer: the
    outputs, and the gradients into the weights, the input spikes and the
    Vmem carry against ``jax.vjp``."""
    dense = fn == "spiking_dense"
    x, w, v0 = _layer_case(bits, len(nrn), dense)
    model, reset = nrn.split("_")
    kw = dict(model=model, reset=reset, threshold=0.5, leak=0.95, surrogate_width=2.0)
    rng = np.random.default_rng(bits)
    gv, gs = (rng.normal(size=v0.shape).astype(np.float32) for _ in range(2))

    def run(L, nc, q, xx, ww, vv):
        n = nc.NeuronConfig(**kw)
        p = L.SpikingDenseParams(n) if dense else L.SpikingConvParams(3, 3, 1, 1, n)
        step = getattr(L, fn)
        v1, _ = step(xx, ww, vv, p, q.QuantSpec(bits), mode)
        return step(xx, ww, v1, p, q.QuantSpec(bits), mode)

    xt, wt, vt = _leaf(x), _leaf(w), _leaf(v0 + 0.0)
    v2, s2 = run(layers, neuron, quant, xt, wt, vt)
    (vj, sj), grads = _vjp(
        jax_ref, lambda a, b, c: run(jax_ref.layers, jax_ref.neuron, jax_ref.quant, a, b, c),
        [x, w, v0], (gv, gs))
    if mode == "qat":
        assert_same(v2, vj)
    else:
        np.testing.assert_allclose(v2.detach().numpy(), np.asarray(vj), rtol=1e-5, atol=1e-5)
    assert_same(s2, sj)
    torch.autograd.backward([v2, s2], [torch.from_numpy(gv), torch.from_numpy(gs)])
    for got, want in zip((xt.grad, wt.grad, vt.grad), grads):
        assert_grad_close(got, want)


def test_int_mode_still_raises():
    p = layers.SpikingDenseParams()
    with pytest.raises(NotImplementedError, match="C2"):
        layers.spiking_dense(torch.zeros((1, 4)), torch.zeros((4, 2)),
                             torch.zeros((1, 2)), p, QuantSpec(4), mode="int")


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_exact_matmul_ignores_the_float32_precision_switch(precision):
    """0/1 spikes times ``scale * q``: every sum exact, whatever the
    global float32 matmul precision says."""
    rng = np.random.default_rng(0)
    a = (rng.random((300, 288)) < 0.5).astype(np.float32)
    b = (rng.integers(-127, 128, (288, 32)) * 2.0 ** -9).astype(np.float32)
    want = (a.astype(np.int64) @ (b * 2 ** 9).astype(np.int64)) * 2.0 ** -9
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(precision)
        got = layers._exact_matmul(torch.from_numpy(a), torch.from_numpy(b))
    finally:
        torch.set_float32_matmul_precision(old)
    assert got.dtype == torch.float32
    assert_same(got, want.astype(np.float32))


# ---------------------------------------------------------------------------
# B3's autograd wrapper: its backward against the plain composition's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["if", "lif"])
@pytest.mark.parametrize("reset", ["hard", "soft"])
def test_b3_autograd_backward_equals_the_plain_composition(model, reset):
    """On CPU tensors the wrapper's forward is B3's plain version, so the
    hand-written backward is held against autograd of ``matmul`` +
    ``neuron_step`` on the same inputs."""
    g = torch.Generator().manual_seed(len(model) + len(reset))
    n = neuron.NeuronConfig(model=model, reset=reset, threshold=0.5, leak=0.9,
                            surrogate_width=2.0)
    cols = (torch.rand((257, 144), generator=g) < 0.3).to(torch.float32)
    wq = quant.ste_quantize(torch.randn((144, 16), generator=g) * 0.2, 4)
    v = torch.randn((257, 16), generator=g) * 0.5
    gv, gs = torch.randn((2, 257, 16), generator=g)
    grads = []
    for fn in (lambda c, w, vv: layers._FusedLifGemmTrain.apply(c, w, vv, n),
               lambda c, w, vv: neuron.neuron_step(vv, c @ w, n)):
        leaves = [x.clone().requires_grad_(True) for x in (cols, wq, v)]
        v_next, s = fn(*leaves)
        torch.autograd.backward([v_next, s], [gv, gs])
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# run_snn: the QAT forward exactly, and gradients of both modes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_run_snn_qat_equals_reference_exactly(jax_ref, net, bits):
    spec, spec_j = _specs(jax_ref, net)
    params = _params_np(jax_ref, spec_j, bits)
    ev = _events(spec, seed=bits)
    out, counts = network.run_snn(params_from_jax(params, "cpu"), torch.from_numpy(ev),
                                  spec, QuantSpec(bits), mode="qat", record_spikes=True)
    out_j, counts_j = jax_ref.network.run_snn(
        [None if p is None else jax_ref.jnp.asarray(p) for p in params],
        jax_ref.jnp.asarray(ev), spec_j, jax_ref.quant.QuantSpec(bits), mode="qat",
        record_spikes=True)
    assert_same(out, out_j)
    assert_same(counts, counts_j)
    assert float(counts.sum()) > 0


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("mode", ["qat", "train"])
def test_run_snn_gradients_match_jax_grad(jax_ref, net, mode):
    spec, spec_j = _specs(jax_ref, net)
    params = _params_np(jax_ref, spec_j, 1)
    ev = _events(spec, seed=1)
    jnp = jax_ref.jnp

    def weigh(out, lib):
        wts = lib.arange(out.size if lib is jnp else out.numel()) % 7 - 3.0
        return (out * wts.reshape(out.shape)).sum()

    def loss_j(p):
        out, _ = jax_ref.network.run_snn(p, jnp.asarray(ev), spec_j,
                                         jax_ref.quant.QuantSpec(4), mode=mode)
        return weigh(out, jnp)

    grads_j = jax_ref.jax.grad(loss_j)([None if p is None else jnp.asarray(p)
                                        for p in params])
    pt = [None if p is None else _leaf(p) for p in params]
    out, _ = network.run_snn(pt, torch.from_numpy(ev), spec, QuantSpec(4), mode=mode)
    weigh(out, torch).backward()
    for got, want in zip(pt, grads_j):
        if got is not None:
            assert float(np.abs(np.asarray(want)).max()) > 0
            assert_grad_close(got.grad, want)


def test_flow_loss_gradient_at_zero_distance(jax_ref):
    """Trap 3 (ROADMAP C8): the reference's AEE uses ``jnp.linalg.norm``,
    whose gradient at a zero vector is NaN; the port's is 0.  With the
    target set to the network's own QAT readout every distance is 0."""
    spec, spec_j = _specs(jax_ref, "flow")
    params = _params_np(jax_ref, spec_j, 2)
    ev = _events(spec, seed=2)
    jnp = jax_ref.jnp
    pj = [None if p is None else jnp.asarray(p) for p in params]
    target, _ = jax_ref.network.run_snn(pj, jnp.asarray(ev), spec_j,
                                        jax_ref.quant.QuantSpec(4), mode="qat")
    cfg_j = jax_ref.train.TrainConfig()
    grads_j = jax_ref.jax.grad(lambda p: jax_ref.train._loss_fn(
        p, (jnp.asarray(ev), target), spec_j, cfg_j)[0])(pj)
    assert all(bool(np.isnan(np.asarray(g)).any()) for g in grads_j if g is not None)
    pt = [None if p is None else _leaf(p) for p in params]
    loss, _ = train._loss_fn(pt, (torch.from_numpy(ev), torch.from_numpy(np.array(target))),
                             spec, train.TrainConfig())
    assert loss.item() == 0.0
    loss.backward()
    for p in pt:
        if p is not None:
            assert torch.equal(p.grad, torch.zeros_like(p))


# ---------------------------------------------------------------------------
# The round trip: QAT graph against the deployed engine, 1 and 4 cores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_gesture_roundtrip_1_and_4_cores(jax_ref, bits):
    spec, spec_j = _specs(jax_ref, "gesture")
    params = _params_np(jax_ref, spec_j, bits)
    ev = _events(spec, seed=bits, density=0.1)
    exported = export.export_network(params, spec, QuantSpec(bits))
    for n_cores in (1, 4):
        engine = export.deploy(exported, spec, n_cores=n_cores, device="cpu")
        rt = export.verify_roundtrip(params, spec, engine, ev, exported)
        assert rt.exact and rt.readout_mismatch == 0.0 and rt.spike_mismatch == 0, \
            (bits, n_cores, rt)
        compiled = spidr.compile(exported, params, spidr.DeployTarget(
            weight_bits=bits, n_cores=n_cores), spec=spec, device="cpu")
        report = compiled.verify(ev)
        assert report.exact and report.roundtrip == rt
        assert (report.single_core_exact is None) == (n_cores == 1)


@pytest.mark.parametrize("bits", [4, 8])
def test_flow_roundtrip_matches_the_references_verdict(jax_ref, bits):
    spec, spec_j = _specs(jax_ref, "flow")
    params = _params_np(jax_ref, spec_j, 3)
    ev = _events(spec, seed=3, density=0.15)
    exported = export.export_network(params, spec, QuantSpec(bits))
    rt = export.verify_roundtrip(params, spec,
                                 export.deploy(exported, spec, device="cpu"), ev)
    ex_j = jax_ref.export.export_network(params, spec_j, jax_ref.quant.QuantSpec(bits))
    rt_j = jax_ref.export.verify_roundtrip(params, spec_j,
                                           jax_ref.export.deploy(ex_j, spec_j),
                                           jax_ref.jnp.asarray(ev), ex_j)
    assert rt.exact and rt_j.exact
    assert (rt.readout_mismatch, rt.spike_mismatch) == \
        (rt_j.readout_mismatch, rt_j.spike_mismatch)


def test_roundtrip_detects_params_that_were_not_deployed(jax_ref):
    """Float params other than the exported ones: not exact, as the
    reference reports for the same pair."""
    spec, spec_j = _specs(jax_ref, "gesture")
    params, other = _params_np(jax_ref, spec_j, 5), _params_np(jax_ref, spec_j, 6)
    ev = _events(spec, seed=5, density=0.1)
    exported = export.export_network(params, spec, QuantSpec(4))
    compiled = spidr.compile(exported, spec, spidr.DeployTarget(), device="cpu")
    assert compiled.verify(ev).roundtrip is None  # no float params kept
    report = compiled.verify(ev, params=other)
    assert not report.exact and report.reference_exact
    ex_j = jax_ref.export.export_network(params, spec_j, jax_ref.quant.QuantSpec(4))
    rt_j = jax_ref.export.verify_roundtrip(other, spec_j,
                                           jax_ref.export.deploy(ex_j, spec_j),
                                           jax_ref.jnp.asarray(ev), ex_j)
    assert not rt_j.exact
    assert (report.roundtrip.readout_mismatch, report.roundtrip.spike_mismatch) == \
        (rt_j.readout_mismatch, rt_j.spike_mismatch)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("net", ["gesture", "flow"])
def test_qat_forward_on_card_ignores_tf32(cuda_device, net):
    """The QAT forward on the card with TF32 switched on equals the CPU's
    bit for bit, and round-trips exactly through the deployed kernels."""
    mod = spidr_gesture if net == "gesture" else spidr_optflow
    spec = mod.reduced(hw=(32, 32), timesteps=4)
    params = network.init_params(torch.Generator().manual_seed(0), spec)
    ev = torch.from_numpy(_events(spec, seed=4, density=0.2))
    want = network.run_snn(params, ev, spec, QuantSpec(4), mode="qat", record_spikes=True)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        pc = [None if p is None else p.to(cuda_device) for p in params]
        got = network.run_snn(pc, ev.to(cuda_device), spec, QuantSpec(4), mode="qat",
                              record_spikes=True)
        exported = export.export_network(params, spec, QuantSpec(4))
        rt = export.verify_roundtrip(params, spec,
                                     export.deploy(exported, spec, device=cuda_device),
                                     ev.to(cuda_device), exported)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert rt.exact, rt


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
def test_po2_scale_on_card_equals_the_hosts(cuda_device, bits):
    """The exporter quantizes on the host; a QAT forward on the card must
    find the same power-of-two grid for the same weights."""
    g = torch.Generator().manual_seed(bits)
    w = torch.randn((288, 64), generator=g) * torch.logspace(-6, 3, 64)
    for axis in (0, None):
        got = quant.po2_scale(w.to(cuda_device), QuantSpec(bits), axis)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), quant.po2_scale(w, QuantSpec(bits), axis))
