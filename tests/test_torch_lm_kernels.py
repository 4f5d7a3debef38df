"""Port parity, the LM stack's kernels: the RWKV6 wkv (B7) and
quant_matmul (B6), against repro.kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX Pallas kernels in interpret mode and the reference's jnp
oracle (``_wkv_chunked``), with the reference's own tolerances: wkv at
rtol 2e-4, atol 2e-5 (tests/test_wkv_kernel.py), quant_matmul at rtol =
atol = 1e-4 (tests/test_kernels.py).  The int4 packing is exact.  The CUDA
kernels run only on the card: the ``gpu`` tests hold them against the
plain versions there and skip here.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, cuda_device, jax_ref, np_of  # noqa: F401
from repro_torch.core.quant import QuantSpec, quantize
from repro_torch.kernels import LAUNCHES, ops, ref
from repro_torch.kernels import quant_matmul as qk
from repro_torch.kernels import wkv_chunk as wk

WKV_TOL = dict(rtol=2e-4, atol=2e-5)
QMM_TOL = dict(rtol=1e-4, atol=1e-4)
INT8_SHAPES = [(16, 64, 32), (64, 200, 96), (130, 514, 258)]
INT4_SHAPES = [(16, 64, 32), (32, 256, 128)]


def _rand(seed, b=2, s=64, h=3, n=16):
    """The reference's wkv test inputs (tests/test_wkv_kernel.py), as numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, n)).astype(np.float32) for _ in range(3))
    lw = -rng.uniform(0.01, 1.0, (b, s, h, n)).astype(np.float32)
    u = rng.normal(size=(h, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, n, n)).astype(np.float32) * np.float32(0.1)
    return r, k, v, lw, u, s0


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np_of(got), np_of(want), **tol)


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_wkv_plain_matches_jax_kernel_and_oracle(jax_ref, chunk, seed):
    arrays = _rand(seed)
    before = dict(LAUNCHES)
    y, s = wk.wkv_sequence(*_torch(*arrays), chunk=chunk)
    assert LAUNCHES == before  # CPU tensors take the plain version
    jnp = jax_ref.jnp
    ja = [jnp.asarray(a) for a in arrays]
    y_k, s_k = jax_ref.wkv_chunk.wkv_sequence(*ja, chunk=chunk, interpret=True)
    y_j, s_j = jax_ref.rwkv6._wkv_chunked(*ja, chunk)
    for want_y, want_s in ((y_k, s_k), (y_j, s_j)):
        _close(y, want_y, WKV_TOL)
        _close(s, want_s, WKV_TOL)


def test_wkv_plain_matches_recurrence():
    """The plain chunked form == the per-token recurrence in float64."""
    r, k, v, lw, u, s0 = _rand(7, b=1, s=32, h=2, n=8)
    y, s_f = wk.wkv_sequence(*_torch(r, k, v, lw, u, s0), chunk=8)
    S = s0.astype(np.float64)[0]
    rn, kn, vn = (t.astype(np.float64)[0] for t in (r, k, v))
    w = np.exp(lw.astype(np.float64))[0]
    un = u.astype(np.float64)
    ys = np.zeros((32, 2, 8))
    for t in range(32):
        for hh in range(2):
            kv = np.outer(kn[t, hh], vn[t, hh])
            ys[t, hh] = rn[t, hh] @ (S[hh] + un[hh][:, None] * kv)
            S[hh] = S[hh] * w[t, hh][:, None] + kv
    np.testing.assert_allclose(np_of(y)[0], ys, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np_of(s_f)[0], S, rtol=1e-4, atol=1e-5)


def _chunk_rows(seed, bh=6, c=16, n=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(bh, c, n)).astype(np.float32) for _ in range(3))
    lw = -rng.uniform(0.01, 1.0, (bh, c, n)).astype(np.float32)
    u = rng.normal(size=(bh, 1, n)).astype(np.float32)
    s0 = rng.normal(size=(bh, n, n)).astype(np.float32)
    return r, k, v, lw, u, s0


def test_wkv_chunk_single_chunk_matches_jax(jax_ref):
    arrays = _chunk_rows(3)
    y, s1 = wk.wkv_chunk(*_torch(*arrays))
    assert tuple(y.shape) == (6, 16, 8) and tuple(s1.shape) == (6, 8, 8)
    y_k, s_k = jax_ref.wkv_chunk.wkv_chunk(*(jax_ref.jnp.asarray(a) for a in arrays),
                                           interpret=True)
    _close(y, y_k, WKV_TOL)
    _close(s1, s_k, WKV_TOL)


def test_wkv_rejects_ragged_sequence():
    with pytest.raises(ValueError, match="multiple of chunk"):
        wk.wkv_sequence(*_torch(*_rand(0, s=20)), chunk=8)


def test_wkv_op_is_the_wrapper():
    args = _torch(*_rand(2))
    for a, b in zip(ops.wkv_sequence_op(*args, chunk=16),
                    wk.wkv_sequence(*args, chunk=16)):
        assert_same(a, b)


def _qmm_inputs(m, k, n, bits):
    rng = np.random.default_rng([m, k, n, bits])
    x = rng.normal(size=(m, k)).astype(np.float32)
    lo = -8 if bits == 4 else -127
    w = rng.integers(lo, -lo if bits == 4 else 128, (k, n)).astype(np.int8)
    sc = (rng.random(n) * 0.01 + 1e-4).astype(np.float32)
    return x, w, sc


@pytest.mark.parametrize("mkn", INT8_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_quant_matmul_int8_matches_jax(jax_ref, mkn):
    x, w, sc = _qmm_inputs(*mkn, 8)
    before = dict(LAUNCHES)
    got = qk.quant_matmul(*_torch(x, w, sc), bits=8)
    assert LAUNCHES == before
    jnp = jax_ref.jnp
    want = jax_ref.quant_matmul.quant_matmul(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(sc), bits=8, interpret=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == mkn[::2]
    _close(got, want, QMM_TOL)


@pytest.mark.parametrize("mkn", INT4_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_quant_matmul_int4_matches_jax(jax_ref, mkn):
    x, w, sc = _qmm_inputs(*mkn, 4)
    packed = ref.pack_int4(torch.from_numpy(w))
    got = qk.quant_matmul(torch.from_numpy(x), packed, torch.from_numpy(sc), bits=4)
    jnp = jax_ref.jnp
    jq = jax_ref.quant_matmul
    want = jq.quant_matmul(jnp.asarray(x), jq.pack_int4(jnp.asarray(w)),
                           jnp.asarray(sc), bits=4, interpret=True)
    _close(got, want, QMM_TOL)


@pytest.mark.parametrize("kn", [(64, 32), (2, 5), (258, 129)])
def test_pack_int4_bytes_match_jax(jax_ref, kn):
    w = np.random.default_rng(kn[0]).integers(-8, 8, kn).astype(np.int8)
    packed = qk.pack_int4(torch.from_numpy(w))
    jq = jax_ref.quant_matmul
    want = jq.pack_int4(jax_ref.jnp.asarray(w))
    assert packed.dtype == torch.uint8
    assert_same(packed, want)
    assert_same(qk.unpack_int4(packed), jq.unpack_int4(want))
    assert_same(qk.unpack_int4(packed), w)


def test_pack_int4_rejects_odd_k():
    with pytest.raises(ValueError, match="even"):
        qk.pack_int4(torch.zeros((3, 4), dtype=torch.int8))


def test_quant_matmul_rejects_mismatched_shapes():
    x, w, sc = _torch(*_qmm_inputs(4, 64, 8, 8))
    with pytest.raises(ValueError, match="bits"):
        qk.quant_matmul(x, w, sc, bits=6)
    with pytest.raises(ValueError, match="do not fit"):
        qk.quant_matmul(x, w, sc, bits=4)


@pytest.mark.parametrize("m", [1, 3, 4, 5, 8, 9, 16, 17, 512])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kn", [(4096, 14336), (514, 1000), (96, 258)],
                         ids=lambda s: "x".join(map(str, s)))
def test_quant_matmul_plan(m, bits, kn):
    """The regime: the decode kernel up to DECODE_MAX_M rows of x, with a
    row tile covering them and K split into at most 8 ranges (one cluster)
    of whole load groups, as many as one wave holds; the tiled kernel
    above."""
    k, n = kn
    mt, rpb = qk.plan(m, k, n, bits, sms=132)
    if m > qk.DECODE_MAX_M:
        assert (mt, rpb) == qk.TILED
        return
    assert mt in (4, 8, 16) and m <= mt and (mt == 4 or mt // 2 < m)
    cpt = 64 // mt
    rows = k // (2 if bits == 4 else 1)
    splits = -(-rows // rpb)
    assert rpb % (64 // cpt) == 0                # whole load groups
    assert splits * rpb >= rows > (splits - 1) * rpb
    col_blocks = -(-n // (32 * cpt))
    assert 1 <= splits <= 8 and (splits == 1 or col_blocks * splits <= 2 * 132)


def test_quant_matmul_plan_main_shape():
    """The served channel-mix at M = 4: 28 column blocks of 512 x 8 K
    ranges, 224 blocks in one wave of 2 per SM on 132 SMs."""
    assert qk.plan(4, 4096, 14336, 8, sms=132) == (4, 512)
    assert qk.plan(4, 4096, 14336, 4, sms=132) == (4, 256)


def test_quant_matmul_op_and_quant_envelope():
    """The op equals the wrapper, and a per-channel quantized product stays
    within quantization noise of the float one (the reference's check)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(8, 128)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32) * 0.1)
    for bits in (8, 4):
        q, sc = quantize(w, QuantSpec(bits), axis=0)
        wq = q if bits == 8 else ops.pack_int4(q)
        out = ops.quant_matmul_op(x, wq, sc.reshape(-1), bits=bits)
        assert_same(out, qk.quant_matmul(x, wq, sc.reshape(-1), bits=bits))
        rel = float((out - x @ w).abs().max() / (x @ w).abs().max())
        assert rel < (0.02 if bits == 8 else 0.15), (bits, rel)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version on the same
# device.  At N = 64 the CPU's float32 plain wkv sums in yet another order
# and lies up to 1.3x the tolerance from a float64 evaluation by itself.
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 64, 3, 16, 8), (2, 64, 3, 16, 32),
                                   (1, 64, 64, 64, 32), (4, 32, 64, 64, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_wkv_sequence_matches_plain(cuda_device, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, n, chunk = shape
    args = [t.to(cuda_device) for t in _torch(*_rand(b + s, b, s, h, n))]
    want = ref.wkv_sequence_ref(*args, chunk)
    before = LAUNCHES["wkv_sequence"]
    got = wk.wkv_sequence(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["wkv_sequence"] == before + 1
    for g, w_ in zip(got, want):
        assert g.is_cuda
        _close(g, w_, WKV_TOL)


@pytest.mark.gpu
def test_cuda_wkv_chunk_matches_plain(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [t.to(cuda_device) for t in _torch(*_chunk_rows(4, bh=8, c=32, n=64))]
    want = ref.wkv_chunk_ref(*args)
    got = wk.wkv_chunk(*args)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        _close(g, w_, WKV_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("bits,mkn", [(8, s) for s in INT8_SHAPES + [(4, 512, 1024)]]
                         + [(4, s) for s in INT4_SHAPES + [(4, 512, 1024)]],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_cuda_quant_matmul_matches_plain(cuda_device, bits, mkn):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, sc = (t.to(cuda_device) for t in _torch(*_qmm_inputs(*mkn, bits)))
    wq = w if bits == 8 else ref.pack_int4(w)
    want = ref.quant_matmul_ref(x, wq, sc, bits)
    before = LAUNCHES[f"quant_matmul_int{bits}"]
    got = qk.quant_matmul(x, wq, sc, bits=bits)
    torch.cuda.synchronize()
    assert LAUNCHES[f"quant_matmul_int{bits}"] == before + 1
    _close(got, want, QMM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 8, 16, 17])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kn", [(514, 1000), (96, 258)], ids=lambda s: "x".join(map(str, s)))
def test_cuda_quant_matmul_regimes_match_plain(cuda_device, m, bits, kn):
    """Both regimes on each side of the cut-over, ragged K and N: the
    decode kernel (m <= 16) and the tiled one (every m) within tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, sc = (t.to(cuda_device) for t in _torch(*_qmm_inputs(m, *kn, bits)))
    wq = w if bits == 8 else ref.pack_int4(w)
    want = ref.quant_matmul_ref(x, wq, sc, bits)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    regimes = [qk.TILED] + ([qk.plan(m, *kn, bits, sms)] if m <= qk.DECODE_MAX_M else [])
    for regime in regimes:
        got = qk.launch(x, wq, sc, bits, regime)
        torch.cuda.synchronize()
        _close(got, want, QMM_TOL)
