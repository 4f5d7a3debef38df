"""Port parity, core numerics: repro_torch.core against repro.core.

Every integer result is compared exactly (tolerance 0)."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, jax_ref  # noqa: F401  (fixture)
from repro_torch.core import layers, network, neuron, quant

BITS = (4, 6, 8)


@pytest.mark.parametrize("bits", BITS)
def test_quantspec_ranges(jax_ref, bits):
    mine, theirs = quant.QuantSpec(bits), jax_ref.quant.QuantSpec(bits)
    for attr in ("vmem_bits", "w_min", "w_max", "v_min", "v_max"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr


def test_precision_pairs(jax_ref):
    assert quant.PRECISION_PAIRS == jax_ref.quant.PRECISION_PAIRS
    assert [s.weight_bits for s in quant.SUPPORTED_PRECISIONS] == \
        [s.weight_bits for s in jax_ref.quant.SUPPORTED_PRECISIONS]
    with pytest.raises(ValueError):
        quant.QuantSpec(5)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("axis", [None, 0])
@pytest.mark.parametrize("kind", ["normal", "zeros", "halves"])
def test_quantize(jax_ref, bits, axis, kind):
    rng = np.random.default_rng(bits)
    if kind == "normal":
        w = rng.normal(scale=0.3, size=(18, 16)).astype(np.float32)
    elif kind == "zeros":
        w = np.zeros((18, 16), np.float32)
    else:  # values landing on .5 after scaling exercise half-to-even rounding
        w = (rng.integers(-14, 15, (18, 16)) / 2.0).astype(np.float32)
        w[0, :] = 7.0
    q, s = quant.quantize(torch.from_numpy(w), quant.QuantSpec(bits), axis=axis)
    qj, sj = jax_ref.quant.quantize(jax_ref.jnp.asarray(w),
                                    jax_ref.quant.QuantSpec(bits), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert_same(q, qj)
    assert_same(s, sj)
    assert_same(quant.dequantize(q, s),
                jax_ref.quant.dequantize(qj, sj))


@pytest.mark.parametrize("bits", BITS)
def test_saturate_and_sat_add(jax_ref, bits):
    rng = np.random.default_rng(bits + 10)
    v = rng.integers(-40000, 40000, (64,)).astype(np.int32)
    w = rng.integers(-128, 128, (64,)).astype(np.int8)
    spec, specj = quant.QuantSpec(bits), jax_ref.quant.QuantSpec(bits)
    assert_same(quant.saturate(torch.from_numpy(v), spec),
                jax_ref.quant.saturate(jax_ref.jnp.asarray(v), specj))
    assert_same(quant.sat_add(torch.from_numpy(v), torch.from_numpy(w), spec),
                jax_ref.quant.sat_add(jax_ref.jnp.asarray(v),
                                      jax_ref.jnp.asarray(w), specj))


@pytest.mark.parametrize("model", ["if", "lif"])
@pytest.mark.parametrize("reset", ["hard", "soft"])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("per_channel", [False, True])
def test_neuron_step_int(jax_ref, model, reset, bits, per_channel):
    spec = quant.QuantSpec(bits)
    rng = np.random.default_rng([len(model), len(reset), bits, per_channel])
    v = rng.integers(spec.v_min, spec.v_max + 1, (33, 12)).astype(np.int32)
    partial = rng.integers(spec.v_min, spec.v_max + 1, (33, 12)).astype(np.int32)
    if per_channel:
        thr = rng.integers(1, max(2, spec.v_max // 2), (12,)).astype(np.int32)
        thr_t, thr_j = torch.from_numpy(thr), jax_ref.jnp.asarray(thr)
    else:
        thr_t = thr_j = max(1, spec.v_max // 3)
    kw = dict(model=model, reset=reset, threshold=0.5, leak_shift=2)
    vn, s = neuron.neuron_step_int(torch.from_numpy(v), torch.from_numpy(partial),
                                   neuron.NeuronConfig(**kw), spec, thr_t)
    vj, sj = jax_ref.neuron.neuron_step_int(
        jax_ref.jnp.asarray(v), jax_ref.jnp.asarray(partial),
        jax_ref.neuron.NeuronConfig(**kw), jax_ref.quant.QuantSpec(bits), thr_j)
    assert vn.dtype == torch.int32 and s.dtype == torch.int32
    assert_same(vn, vj)
    assert_same(s, sj)


@pytest.mark.parametrize("kh,kw,stride,padding,hw,c",
                         [(3, 3, 1, 1, (9, 7), 2), (2, 2, 2, 0, (8, 6), 3),
                          (3, 3, 2, 1, (7, 8), 4)])
def test_im2col(jax_ref, kh, kw, stride, padding, hw, c):
    rng = np.random.default_rng(kh * 10 + stride)
    x = (rng.random((2,) + hw + (c,)) < 0.3).astype(np.float32)
    got = layers.im2col(torch.from_numpy(x), kh, kw, stride, padding)
    want = jax_ref.layers.im2col(jax_ref.jnp.asarray(x), kh, kw, stride, padding)
    assert_same(got, want)
    # The engine feeds int8 planes: same values, one byte each.
    got8 = layers.im2col(torch.from_numpy(x).to(torch.int8), kh, kw, stride,
                         padding)
    assert got8.dtype == torch.int8
    assert_same(got8.to(torch.float32), want)


@pytest.mark.parametrize("window,stride,hw", [(2, 2, (8, 6)), (2, 2, (7, 9)),
                                              (4, 4, (8, 8)), (3, 3, (6, 9))])
def test_maxpool2d(jax_ref, window, stride, hw):
    rng = np.random.default_rng(window + hw[0])
    x = (rng.random((2,) + hw + (5,)) < 0.3).astype(np.float32)
    got = layers.maxpool2d(torch.from_numpy(x), window, stride)
    want = jax_ref.layers.maxpool2d(jax_ref.jnp.asarray(x), window, stride)
    assert_same(got, want)
    assert_same(layers.maxpool2d(torch.from_numpy(x).to(torch.int8), window,
                                 stride).to(torch.float32), want)


@pytest.mark.parametrize("name", ["gesture_net", "optical_flow_net"])
def test_network_specs_and_state_shapes(jax_ref, name):
    mine = getattr(network, name)()
    theirs = getattr(jax_ref.network, name)()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for batch in (1, 2):
        want = [None if s is None else tuple(s.shape)
                for s in jax_ref.network._init_state(theirs, batch)]
        assert network.init_state_shapes(mine, batch) == want


@pytest.mark.parametrize("name", ["gesture_net", "optical_flow_net"])
def test_init_params_structure(jax_ref, name):
    spec = getattr(network, name)()
    params = network.init_params(torch.Generator().manual_seed(0), spec)
    want = jax_ref.network.init_params(jax_ref.jax.random.PRNGKey(0),
                                       getattr(jax_ref.network, name)())
    assert len(params) == len(want)
    for p, q in zip(params, want):
        assert (p is None) == (q is None)
        if p is not None:
            assert tuple(p.shape) == tuple(q.shape) and p.dtype == torch.float32
            bound = 3.0 / np.sqrt(p.shape[0])
            assert float(p.abs().max()) <= bound
