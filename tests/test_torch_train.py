"""Port parity, the float (training-mode) forward: ste_quantize, the float
neuron step, spiking_conv / spiking_dense and run_snn(mode="train"),
against repro.core.

Tolerance: float Vmem and readouts within ``atol = rtol = 1e-5`` (fp32
sums in another order); spikes and spike counts exactly.  The reference's
parameters are carried across with ``convert.params_from_jax``.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, jax_ref  # noqa: F401
from repro_torch.configs import spidr_gesture, spidr_optflow
from repro_torch.convert import params_from_jax
from repro_torch.core import layers, network, neuron, quant
from repro_torch.kernels import LAUNCHES, ref

TOL = ref.FLOAT_TOL


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("kind", ["normal", "zeros", "halves"])
def test_ste_quantize_forward(jax_ref, bits, kind):
    rng = np.random.default_rng(bits)
    if kind == "normal":
        w = rng.normal(scale=0.3, size=(144, 16)).astype(np.float32)
    elif kind == "zeros":
        w = np.zeros((18, 16), np.float32)
    else:
        w = (rng.integers(-14, 15, (18, 16)) / 2.0).astype(np.float32)
        w[0, :] = 7.0
    got = quant.ste_quantize(torch.from_numpy(w), bits)
    want = jax_ref.quant.ste_quantize(jax_ref.jnp.asarray(w), bits)
    assert got.dtype == torch.float32
    assert_same(got, want)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_neurons_per_row(jax_ref, bits):
    assert quant.QuantSpec(bits).neurons_per_row == \
        jax_ref.quant.QuantSpec(bits).neurons_per_row


@pytest.mark.parametrize("model", ["if", "lif"])
@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_neuron_step_float(jax_ref, model, reset, threshold):
    rng = np.random.default_rng([len(model), len(reset), int(threshold * 10)])
    v = rng.normal(size=(33, 12)).astype(np.float32)
    i = rng.normal(size=(33, 12)).astype(np.float32)
    kw = dict(model=model, reset=reset, threshold=threshold, leak=0.95)
    vn, s = neuron.neuron_step(torch.from_numpy(v), torch.from_numpy(i),
                               neuron.NeuronConfig(**kw))
    vj, sj = jax_ref.neuron.neuron_step(jax_ref.jnp.asarray(v), jax_ref.jnp.asarray(i),
                                        jax_ref.neuron.NeuronConfig(**kw))
    np.testing.assert_allclose(vn.numpy(), np.asarray(vj), rtol=1e-6, atol=1e-6)
    assert_same(s, sj)


@pytest.mark.parametrize("which", ["if_step", "lif_step"])
def test_if_and_lif_step_defaults(jax_ref, which):
    rng = np.random.default_rng(len(which))
    v = rng.normal(size=(20,)).astype(np.float32)
    i = rng.normal(size=(20,)).astype(np.float32)
    vn, s = getattr(neuron, which)(torch.from_numpy(v), torch.from_numpy(i))
    vj, sj = getattr(jax_ref.neuron, which)(jax_ref.jnp.asarray(v), jax_ref.jnp.asarray(i))
    np.testing.assert_allclose(vn.numpy(), np.asarray(vj), rtol=1e-6, atol=1e-6)
    assert_same(s, sj)


def _conv_case(seed, c_in, c_out, hw, density=0.3, batch=2):
    rng = np.random.default_rng(seed)
    x = (rng.random((batch,) + hw + (c_in,)) < density).astype(np.float32)
    w = rng.uniform(-0.8, 0.8, (9 * c_in, c_out)).astype(np.float32)
    v = rng.normal(scale=0.3, size=(batch,) + hw + (c_out,)).astype(np.float32)
    return x, w, v


@pytest.mark.parametrize("c_in,c_out,hw", [(2, 16, (9, 7)), (16, 16, (8, 8)),
                                           (32, 2, (6, 10))])
@pytest.mark.parametrize("model,reset", [("lif", "hard"), ("if", "soft")])
@pytest.mark.parametrize("bits", [4, 8])
def test_spiking_conv_train(jax_ref, c_in, c_out, hw, model, reset, bits):
    x, w, v = _conv_case(c_in + c_out, c_in, c_out, hw)
    kw = dict(model=model, reset=reset, threshold=0.5, leak=0.95)
    p = layers.SpikingConvParams(3, 3, 1, 1, neuron.NeuronConfig(**kw))
    pj = jax_ref.layers.SpikingConvParams(3, 3, 1, 1, jax_ref.neuron.NeuronConfig(**kw))
    before = dict(LAUNCHES)
    vn, s = layers.spiking_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(v), p, quant.QuantSpec(bits))
    assert LAUNCHES == before  # the CPU runs the plain composition
    jnp = jax_ref.jnp
    vj, sj = jax_ref.layers.spiking_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(v),
                                         pj, jax_ref.quant.QuantSpec(bits), mode="train")
    np.testing.assert_allclose(vn.numpy(), np.asarray(vj), rtol=TOL, atol=TOL)
    assert_same(s, sj)


@pytest.mark.parametrize("model,reset", [("lif", "hard"), ("if", "soft")])
def test_spiking_dense_train(jax_ref, model, reset):
    rng = np.random.default_rng(len(model))
    x = (rng.random((4, 64)) < 0.3).astype(np.float32)
    w = rng.uniform(-0.4, 0.4, (64, 11)).astype(np.float32)
    v = rng.normal(scale=0.3, size=(4, 11)).astype(np.float32)
    kw = dict(model=model, reset=reset, threshold=0.5, leak=0.95)
    vn, s = layers.spiking_dense(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(v),
                                 layers.SpikingDenseParams(neuron.NeuronConfig(**kw)),
                                 quant.QuantSpec(4))
    jnp = jax_ref.jnp
    vj, sj = jax_ref.layers.spiking_dense(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(v),
        jax_ref.layers.SpikingDenseParams(jax_ref.neuron.NeuronConfig(**kw)),
        jax_ref.quant.QuantSpec(4), mode="train")
    np.testing.assert_allclose(vn.numpy(), np.asarray(vj), rtol=TOL, atol=TOL)
    assert_same(s, sj)


def test_injected_matmul_is_used(jax_ref):
    """The reference's ``matmul`` hook: the layer runs matmul + neuron_step."""
    x, w, v = _conv_case(3, 2, 16, (8, 8))
    calls = []

    def mm(a, b):
        calls.append(a.shape)
        return a @ b

    p = layers.SpikingConvParams(3, 3, 1, 1, neuron.NeuronConfig(model="lif"))
    got = layers.spiking_conv(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(v), p, quant.QuantSpec(4), matmul=mm)
    want = layers.spiking_conv(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(v), p, quant.QuantSpec(4))
    assert calls == [(2 * 64, 18)]
    for a, b in zip(got, want):
        assert_same(a, b)


@pytest.mark.parametrize("fn", ["spiking_conv", "spiking_dense", "run_snn"])
def test_unported_modes_raise(fn):
    spec = spidr_gesture.reduced(hw=(16, 16), timesteps=1)
    with pytest.raises(NotImplementedError, match="not ported"):
        if fn == "run_snn":
            network.run_snn([], torch.zeros((1, 1, 16, 16, 2)), spec,
                            quant.QuantSpec(4), mode="int")
        elif fn == "spiking_conv":
            layers.spiking_conv(torch.zeros((1, 4, 4, 2)), torch.zeros((18, 2)),
                                torch.zeros((1, 4, 4, 2)),
                                layers.SpikingConvParams(3, 3), quant.QuantSpec(4),
                                mode="int")
        else:
            layers.spiking_dense(torch.zeros((1, 4)), torch.zeros((4, 2)),
                                 torch.zeros((1, 2)), layers.SpikingDenseParams(),
                                 quant.QuantSpec(4), mode="int")


@pytest.mark.parametrize("name", ["gesture_net", "optical_flow_net"])
@pytest.mark.parametrize("hw", [None, (32, 48)])
def test_layer_shapes(jax_ref, name, hw):
    import dataclasses

    mine = getattr(network, name)()
    theirs = getattr(jax_ref.network, name)()
    if hw is not None:
        mine = dataclasses.replace(mine, input_hw=hw)
        theirs = dataclasses.replace(theirs, input_hw=hw)
    assert [dataclasses.asdict(s) for s in mine.layer_shapes()] == \
        [dataclasses.asdict(s) for s in theirs.layer_shapes()]


def test_init_layers_match_init_params():
    """init_params is init_conv / init_dense over the spec, same draws."""
    spec = network.gesture_net()
    params = network.init_params(torch.Generator().manual_seed(7), spec)
    g = torch.Generator().manual_seed(7)
    for layer, p in zip(spec.layers, params):
        if layer.kind == "conv":
            assert_same(p, layers.init_conv(g, 3, 3, layer.c_in, layer.c_out))
        elif layer.kind == "fc":
            assert_same(p, layers.init_dense(g, layer.c_in, layer.c_out))
        else:
            assert p is None


NETS = {"gesture": ((16, 16), 4), "flow": ((8, 16), 3)}


def _specs(jax_ref, net):
    hw, t = NETS[net]
    mod, mod_j = ((spidr_gesture, jax_ref.spidr_gesture) if net == "gesture"
                  else (spidr_optflow, jax_ref.spidr_optflow))
    return mod.reduced(hw=hw, timesteps=t), mod_j.reduced(hw=hw, timesteps=t)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("record", [True, False])
def test_run_snn_train_matches_jax(jax_ref, net, bits, record):
    spec, spec_j = _specs(jax_ref, net)
    params_j = jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(0), spec_j)
    params_np = [None if p is None else np.asarray(p) for p in params_j]
    hw, t = NETS[net]
    rng = np.random.default_rng([bits, len(net)])
    events = (rng.random((t, 2) + hw + (2,)) < 0.25).astype(np.float32)
    readout, counts = network.run_snn(params_from_jax(params_np, "cpu"),
                                      torch.from_numpy(events), spec,
                                      quant.QuantSpec(bits), record_spikes=record)
    ro_j, counts_j = jax_ref.network.run_snn(params_j, jax_ref.jnp.asarray(events),
                                             spec_j, jax_ref.quant.QuantSpec(bits),
                                             mode="train", record_spikes=record)
    assert readout.dtype == torch.float32 and counts.dtype == torch.float32
    np.testing.assert_allclose(readout.numpy(), np.asarray(ro_j), rtol=TOL, atol=TOL)
    # Spike counts equal: a flip could only come from a pre-reset Vmem within
    # 1e-5 of the threshold, and none happens on these inputs.
    assert_same(counts, counts_j)
    if record:
        assert float(counts.sum()) > 0  # the network fires
