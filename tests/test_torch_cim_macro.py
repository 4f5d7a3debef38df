"""The compute macro's functional model (``repro_torch.core.cim_macro``)
against the JAX package's (``repro.core.cim_macro``).

``MacroConfig`` and the geometry constants must be the reference's;
``pack_weight_rows`` clips and rejects as the reference does (the same
errors); ``accumulate`` (wide int32 sums through the spike GEMM, one
saturation) equals the reference's ``jnp`` version and, wherever no
intermediate sum leaves the Vmem range, ``accumulate_sequential`` (the
silicon's per-row-op saturation order); both stay in ``[v_min, v_max]``.
The ``gpu`` case runs ``accumulate`` on CUDA tensors, through B4.
"""
import numpy as np
import pytest
import torch

try:
    from hypothesis import assume, given, settings, strategies as st
except ImportError:  # dev extra absent: property tests skip, rest run
    from _hypothesis_stub import given, settings, st
    assume = None

from _torch_parity import assert_same, cuda_device, jax_ref  # noqa: F401
from repro_torch.core import cim_macro as C
from repro_torch.core.quant import QuantSpec

BITS = [4, 6, 8]


def _block(bits, seed, density=0.05, lo=-2, hi=3, full=False):
    """Seeded (spikes (128, 16) int8, weights (128, 48/W_b) int8, v0)."""
    spec = QuantSpec(bits)
    rng = np.random.default_rng(seed)
    spikes = (rng.random((C.IFSPAD_ROWS, C.IFSPAD_COLS)) < density).astype(np.int8)
    if full:
        lo, hi = spec.w_min, spec.w_max + 1
    w = rng.integers(lo, hi, (C.IFSPAD_ROWS, spec.neurons_per_row)).astype(np.int8)
    v0 = np.zeros((C.IFSPAD_COLS, spec.neurons_per_row), np.int32)
    return spikes, w, v0


def _ref_accumulate(jax_ref, spikes, w, v0, bits):
    jnp = jax_ref.jnp
    return np.asarray(jax_ref.cim_macro.accumulate(
        jnp.array(spikes), jnp.array(w), jnp.array(v0), jax_ref.quant.QuantSpec(bits)))


def _accumulate(spikes, w, v0, bits, device="cpu"):
    return C.accumulate(torch.from_numpy(spikes).to(device), torch.from_numpy(w).to(device),
                        torch.from_numpy(v0).to(device), QuantSpec(bits))


@pytest.mark.parametrize("name", ["CM_WEIGHT_ROWS", "CM_VMEM_ROWS", "CM_COLS",
                                  "IFSPAD_ROWS", "IFSPAD_COLS", "NEURON_MACRO_CYCLES"])
def test_geometry_constants_equal(jax_ref, name):
    assert getattr(C, name) == getattr(jax_ref.cim_macro, name)
    assert C.NEURON_MACRO_CYCLES == 66  # Eq. (3): 2*32 + 2


@pytest.mark.parametrize("bits,want", [(4, 192), (6, 128), (8, 96)])
def test_macro_config_equal(jax_ref, bits, want):
    got = C.MacroConfig(QuantSpec(bits))
    ref = jax_ref.cim_macro.MacroConfig(jax_ref.quant.QuantSpec(bits))
    assert (got.neurons, got.max_output_neurons) == (ref.neurons, ref.max_output_neurons)
    assert got.max_output_neurons == want  # Eq. (1): (48/W_b) * 16


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("extra_row,extra_col", [(1, 0), (0, 1)])
def test_pack_weight_rows_rejects_as_reference(jax_ref, bits, extra_row, extra_col):
    shape = (C.IFSPAD_ROWS + extra_row, 48 // bits + extra_col)
    with pytest.raises(ValueError) as got:
        C.pack_weight_rows(torch.zeros(shape), C.MacroConfig(QuantSpec(bits)))
    with pytest.raises(ValueError) as want:
        jax_ref.cim_macro.pack_weight_rows(
            jax_ref.jnp.zeros(shape),
            jax_ref.cim_macro.MacroConfig(jax_ref.quant.QuantSpec(bits)))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bits", BITS)
def test_pack_weight_rows_clips_as_reference(jax_ref, bits):
    rng = np.random.default_rng(bits)
    w = rng.integers(-200, 200, (C.IFSPAD_ROWS, 48 // bits)).astype(np.int32)
    got = C.pack_weight_rows(torch.from_numpy(w), C.MacroConfig(QuantSpec(bits)))
    want = jax_ref.cim_macro.pack_weight_rows(
        jax_ref.jnp.array(w), jax_ref.cim_macro.MacroConfig(jax_ref.quant.QuantSpec(bits)))
    assert got.dtype == torch.int8
    assert_same(got, np.asarray(want))


@pytest.mark.parametrize("bits", BITS)
def test_accumulate_matches_reference_and_sequential(jax_ref, bits):
    """No intermediate saturation: vectorized == silicon order == reference."""
    spikes, w, v0 = _block(bits, seed=bits)
    got = _accumulate(spikes, w, v0, bits)
    assert_same(got, _ref_accumulate(jax_ref, spikes, w, v0, bits))
    assert_same(got, C.accumulate_sequential(spikes, w, v0, QuantSpec(bits)))


@pytest.mark.parametrize("bits", BITS)
def test_accumulate_sequential_equals_reference(jax_ref, bits):
    spikes, w, v0 = _block(bits, seed=7, density=0.5, full=True)  # saturates
    got = C.accumulate_sequential(spikes, w, v0, QuantSpec(bits))
    want = jax_ref.cim_macro.accumulate_sequential(spikes, w, v0,
                                                   jax_ref.quant.QuantSpec(bits))
    assert_same(got, want)


@pytest.mark.parametrize("bits", BITS)
def test_saturation_stays_in_range(jax_ref, bits):
    spec = QuantSpec(bits)
    spikes, w, v0 = _block(bits, seed=7, density=0.5, full=True)  # dense -> overflow
    got = _accumulate(spikes, w, v0, bits)
    assert_same(got, _ref_accumulate(jax_ref, spikes, w, v0, bits))
    for out in (got.numpy(), C.accumulate_sequential(spikes, w, v0, spec)):
        assert out.min() >= spec.v_min and out.max() <= spec.v_max


def test_weights_outside_int8_raise():
    spikes, w, v0 = _block(8, seed=0)
    wide = torch.from_numpy(w).to(torch.int32)
    wide[0, 0] = 200
    with pytest.raises(ValueError, match="outside int8"):
        C.accumulate(torch.from_numpy(spikes), wide, torch.from_numpy(v0), QuantSpec(8))
    with pytest.raises(TypeError, match="integer tensor"):
        C.accumulate(torch.from_numpy(spikes), wide.float(), torch.from_numpy(v0),
                     QuantSpec(8))


@given(st.sampled_from(BITS), st.floats(min_value=0.0, max_value=0.2),
       st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_no_overflow_agreement_property(bits, density, seed):
    """Where no intermediate sum can leave the Vmem range (each column's
    sum of |w| over the spiking rows is within it), the vectorized sum
    equals the silicon-order one."""
    spec = QuantSpec(bits)
    spikes, w, v0 = _block(bits, seed, density=density)
    reach = spikes.astype(np.int64).T @ np.abs(w.astype(np.int64))
    assume(reach.max(initial=0) <= spec.v_max)
    assert_same(_accumulate(spikes, w, v0, bits),
                C.accumulate_sequential(spikes, w, v0, spec))


@given(st.sampled_from(BITS), st.floats(min_value=0.0, max_value=1.0),
       st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_in_range_property(bits, density, seed):
    spec = QuantSpec(bits)
    spikes, w, _ = _block(bits, seed, density=density, full=True)
    rng = np.random.default_rng(seed + 1)
    v0 = rng.integers(spec.v_min, spec.v_max + 1, (C.IFSPAD_COLS, spec.neurons_per_row),
                      dtype=np.int64).astype(np.int32)
    for out in (_accumulate(spikes, w, v0, bits).numpy(),
                C.accumulate_sequential(spikes, w, v0, spec)):
        assert out.min() >= spec.v_min and out.max() <= spec.v_max


@given(st.floats(min_value=0.0, max_value=0.3), st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_zero_vmem_when_no_spikes_property(density, seed):
    spikes, w, v0 = _block(4, seed, density=density)
    out = _accumulate(spikes, w, v0, 4).numpy()
    # Columns with zero spikes anywhere contribute nothing.
    empty_cols = spikes.sum(axis=0) == 0
    assert (out[empty_cols] == 0).all()


@pytest.mark.parametrize("nnz", [0, 1, 10, 2048])
def test_macro_cycles_equal(jax_ref, nnz):
    assert C.macro_cycles(nnz) == jax_ref.cim_macro.macro_cycles(nnz)
    assert C.macro_cycles(10) == 22  # 2 ops/spike + fill


@pytest.mark.gpu
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("regime", ["no_overflow", "saturating"])
def test_accumulate_on_the_card(cuda_device, bits, regime):
    """On CUDA tensors ``accumulate`` launches B4 (M = 16, K = 128, N = 48/W_b)
    and equals the CPU's result; without saturation, the silicon order's."""
    from repro_torch import kernels

    spec = QuantSpec(bits)
    if regime == "no_overflow":
        spikes, w, v0 = _block(bits, seed=bits)
    else:
        spikes, w, v0 = _block(bits, seed=bits, density=0.5, full=True)
    before = kernels.LAUNCHES["spike_gemm"]
    got = _accumulate(spikes, w, v0, bits, device=cuda_device)
    torch.cuda.synchronize(cuda_device)
    assert kernels.LAUNCHES["spike_gemm"] == before + 1
    assert got.is_cuda and got.dtype == torch.int32
    assert_same(got, _accumulate(spikes, w, v0, bits))
    out = got.cpu().numpy()
    assert out.min() >= spec.v_min and out.max() <= spec.v_max
    if regime == "no_overflow":
        assert_same(got, C.accumulate_sequential(spikes, w, v0, spec))
