"""Port parity, unfused kernels: spike_gemm (B4), lif_step (B5), the float
fused_lif_gemm (B3) and the ops wrappers, against repro.kernels.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX Pallas kernels in interpret mode: exactly for the integer
kernels, within the stated float tolerance for the float ones.  The CUDA
kernels run only on the card: the ``gpu`` tests hold them against the
plain versions there and skip here.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, cuda_device, jax_ref  # noqa: F401
from repro_torch.kernels import LAUNCHES, _ring, ops, ref
from repro_torch.kernels import fused_lif_gemm as fk
from repro_torch.kernels import lif_step as lk
from repro_torch.kernels import spike_gemm as sk

# The shapes of the reference's own spike_gemm tests (tests/test_kernels.py),
# ragged M, K and N included.
GEMM_SHAPES = [(32, 64, 16), (128, 128, 128), (100, 300, 50), (257, 511, 129),
               (16, 1024, 12)]
SKIPS = [(True, "reduce"), (True, "bitmap"), (False, "reduce")]


def _gemm_inputs(m, k, n, density):
    rng = np.random.default_rng([m, k, n, int(density * 100)])
    s = (rng.random((m, k)) < density).astype(np.int8)
    w = rng.integers(-8, 8, (k, n)).astype(np.int8)
    return s, w


@pytest.mark.parametrize("skip", SKIPS, ids=["reduce", "bitmap", "dense"])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.5])
@pytest.mark.parametrize("mkn", GEMM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_spike_gemm_matches_jax(jax_ref, mkn, density, skip):
    skip_empty, mode = skip
    s, w = _gemm_inputs(*mkn, density)
    before = dict(LAUNCHES)
    got = sk.spike_gemm(torch.from_numpy(s), torch.from_numpy(w),
                        skip_empty=skip_empty, skip_mode=mode)
    assert LAUNCHES == before  # CPU tensors take the plain version
    jnp = jax_ref.jnp
    want = jax_ref.spike_gemm.spike_gemm(jnp.asarray(s), jnp.asarray(w),
                                         interpret=True, skip_empty=skip_empty,
                                         skip_mode=mode)
    assert got.dtype == torch.int32
    assert_same(got, want)


@pytest.mark.parametrize("skip", SKIPS, ids=["reduce", "bitmap", "dense"])
@pytest.mark.parametrize("density", [0.0, 0.05])
def test_spike_gemm_wide_fan_in_matches_jax(jax_ref, density, skip):
    """A fan-in beyond the ring's reach (the tile-loop route on the card)."""
    skip_empty, mode = skip
    s, w = _gemm_inputs(40, 1500, 12, density)
    assert sk.plan(40, 1500, 12, 132).route == "tile"
    got = sk.spike_gemm(torch.from_numpy(s), torch.from_numpy(w),
                        skip_empty=skip_empty, skip_mode=mode)
    jnp = jax_ref.jnp
    want = jax_ref.spike_gemm.spike_gemm(jnp.asarray(s), jnp.asarray(w),
                                         interpret=True, skip_empty=skip_empty,
                                         skip_mode=mode)
    assert_same(got, want)


# B4's plan: the main paths' shapes, ragged ones, both sides of the ring.
B4_PLAN_SHAPES = [(221184, 288, 32), (221184, 288, 2), (16384, 144, 16),
                  (16384, 18, 16), (4, 64, 11), (257, 70, 33), (100, 1441, 32),
                  (100, 1442, 32), (4096, 2000, 32), (1, 5, 100)]


@pytest.mark.parametrize("mkn", B4_PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sms", [132, 114, 16, 8])
def test_spike_gemm_plan_geometry(mkn, sms):
    """On the ring: a persistent grid no larger than the tiles or the card,
    2-8 stages, shared memory within a block's share; else the tile loop,
    one block per M tile."""
    m, k, n = mkn
    plan = sk.plan(m, k, n, sms)
    slabs, tiles = -(-n // 32), -(-m // 64)
    if plan.route == "tile":
        assert sk.ring_smem(k, n, 2) > 227 * 1024
        assert plan.grid_x == tiles
        return
    assert 1 <= plan.grid_x <= tiles and 2 <= plan.stages <= 8
    assert plan.grid_x * slabs <= max(slabs, 4 * sms)
    smem = sk.ring_smem(k, n, plan.stages)
    per_sm = -(-plan.grid_x * slabs // sms)
    assert smem <= 227 * 1024 and per_sm * (smem + 1024) <= 228 * 1024


def test_spike_gemm_plan_main_shapes():
    """Flow middle: 2 blocks per SM, 5 stages of 64 x 288 spikes (18,560
    bytes each) beside the 9,728-byte weight slab; gesture conv: 4 blocks
    per SM, one tile each."""
    assert sk.plan(221184, 288, 32, 132) == ("ring", 264, 5)
    assert sk.ring_smem(288, 32, 5) == 128 + 9728 + 5 * 18560
    assert sk.plan(221184, 288, 2, 132) == ("ring", 264, 5)
    assert sk.plan(16384, 144, 16, 132) == ("ring", 256, 5)
    assert sk.plan(16384, 18, 16, 132) == ("ring", 256, 8)
    assert sk.plan(4096, 2000, 32, 132).route == "tile"


@pytest.mark.parametrize("mkn", B4_PLAN_SHAPES[:7], ids=lambda s: "x".join(map(str, s)))
def test_spike_gemm_plan_takes_the_stages_that_fit(mkn):
    """The ring's stages are as many as a block's share of an SM (at 4, 2
    or 1 blocks per SM) leaves room for, up to 8: one more would not fit."""
    m, k, n = mkn
    plan = sk.plan(m, k, n, 132)
    assert plan.route == "ring"
    shares = [min(227 * 1024, 228 * 1024 // per_sm - 1024) for per_sm in (4, 2, 1)]
    assert any(sk.ring_smem(k, n, plan.stages) <= share and
               (plan.stages == 8 or sk.ring_smem(k, n, plan.stages + 1) > share)
               for share in shares)


@pytest.mark.parametrize("n", [1, 2, 8, 16, 24, 32, 33, 64, 70, 100, 128, 129])
def test_spike_gemm_route_changes_where_two_stages_stop_fitting(n):
    """The ring up to the last fan-in whose two stages fit, the tile loop
    from the next one on, whatever M and the card."""
    k_max = max(k for k in range(1, 3000) if sk.ring_smem(k, n, 2) <= 227 * 1024)
    for m, sms in ((100, 132), (221184, 8)):
        assert sk.plan(m, k_max, n, sms).route == "ring"
        assert sk.plan(m, k_max + 1, n, sms).route == "tile"


def test_cuda_tile_is_the_rings_tile():
    """The bitmap is made at the ring's tile: 64 rows (its M tile), 32
    channels (its slab), 32 fan-in bytes (one mma), one flag per (64, 32)."""
    assert sk.CUDA_TILE == (_ring.BM, _ring.NB, _ring.KSTEP) == (64, 32, 32)
    s = torch.zeros((130, 70), dtype=torch.int8)
    s[64, 33] = 1
    bitmap = ref.spike_tile_bitmap(s, sk.CUDA_TILE)
    assert tuple(bitmap.shape) == (3, 3)
    assert bitmap.tolist() == [[0, 0, 0], [0, 1, 0], [0, 0, 0]]


def test_spike_gemm_rejects_unknown_skip_mode():
    s, w = _gemm_inputs(8, 8, 4, 0.5)
    with pytest.raises(ValueError, match="skip_mode"):
        sk.spike_gemm(torch.from_numpy(s), torch.from_numpy(w), skip_mode="tile")


@pytest.mark.parametrize("leak,soft", [(1.0, False), (0.9, True), (0.8, False)])
@pytest.mark.parametrize("shape", [(7,), (33, 65), (3, 17, 29)])
def test_lif_step_fused_matches_jax(jax_ref, shape, leak, soft):
    rng = np.random.default_rng([len(shape), int(leak * 10)])
    v = rng.normal(size=shape).astype(np.float32)
    i = rng.normal(size=shape).astype(np.float32)
    vo, so = lk.lif_step_fused(torch.from_numpy(v), torch.from_numpy(i),
                               threshold=0.5, leak=leak, soft_reset=soft)
    jnp = jax_ref.jnp
    vj, sj = jax_ref.lif_step.lif_step_fused(jnp.asarray(v), jnp.asarray(i),
                                             threshold=0.5, leak=leak,
                                             soft_reset=soft, interpret=True)
    assert vo.dtype == torch.float32 and so.dtype == torch.float32
    np.testing.assert_allclose(vo.numpy(), np.asarray(vj), rtol=1e-6, atol=1e-6)
    assert_same(so, sj)


@pytest.mark.parametrize("bits", [7, 11, 15])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("soft", [False, True])
def test_lif_step_fused_int_matches_jax(jax_ref, bits, shift, soft):
    rng = np.random.default_rng([bits, shift, soft])
    hi = (1 << (bits - 1)) - 1
    v = rng.integers(-hi - 1, hi + 1, (50, 33)).astype(np.int32)
    p = rng.integers(-hi, hi, (50, 33)).astype(np.int32)
    thr = hi // 3
    vo, so = lk.lif_step_fused_int(torch.from_numpy(v), torch.from_numpy(p), thr,
                                   leak_shift=shift, soft_reset=soft, vmem_bits=bits)
    jnp = jax_ref.jnp
    vj, sj = jax_ref.lif_step.lif_step_fused_int(
        jnp.asarray(v), jnp.asarray(p), thr, leak_shift=shift, soft_reset=soft,
        vmem_bits=bits, interpret=True)
    assert vo.dtype == torch.int32 and so.dtype == torch.int32
    assert_same(vo, vj)
    assert_same(so, sj)


@pytest.mark.parametrize("leak,soft", [(1.0, False), (0.9, True)])
@pytest.mark.parametrize("skip_empty", [True, False])
def test_fused_lif_gemm_float_matches_jax(jax_ref, leak, soft, skip_empty):
    """At the reference's own test shape (65, 130, 40), tests/test_engine.py."""
    rng = np.random.default_rng(1)
    s = (rng.random((65, 130)) < 0.1).astype(np.float32)
    w = rng.normal(size=(130, 40)).astype(np.float32)
    v = rng.normal(size=(65, 40)).astype(np.float32)
    vo, so = fk.fused_lif_gemm(torch.from_numpy(s), torch.from_numpy(w),
                               torch.from_numpy(v), threshold=0.5, leak=leak,
                               soft_reset=soft, skip_empty=skip_empty)
    jnp = jax_ref.jnp
    vj, sj = jax_ref.kernels.fused_lif_gemm(
        jnp.asarray(s), jnp.asarray(w), jnp.asarray(v), threshold=0.5, leak=leak,
        soft_reset=soft, interpret=True, skip_empty=skip_empty)
    v_pre = (v * np.float32(leak) if leak != 1.0 else v) + s @ w
    res = ref.compare_float_step(vo, so, torch.from_numpy(np.array(vj)),
                                 torch.from_numpy(np.array(sj)),
                                 torch.from_numpy(v_pre), 0.5)
    print("near-threshold spike flips:", res["spikes_flipped"])
    assert res["ok"], res
    np.testing.assert_allclose(vo.numpy(), np.asarray(vj), rtol=ref.FLOAT_TOL,
                               atol=ref.FLOAT_TOL)


def test_compare_float_step_rule():
    """The tolerance rule: a flip is allowed only within 1e-5 of threshold."""
    v_want = torch.tensor([0.2, 0.0, 0.3])
    s_want = torch.tensor([0.0, 1.0, 0.0])
    v_pre = torch.tensor([0.2, 0.500004, 0.3])
    ok = ref.compare_float_step(torch.tensor([0.2, 0.500004, 0.3]),
                                torch.tensor([0.0, 0.0, 0.0]), v_want, s_want,
                                v_pre, 0.5)
    assert ok["ok"] and ok["spikes_flipped"] == 1
    v_pre_far = torch.tensor([0.2, 0.6, 0.3])
    bad = ref.compare_float_step(v_want, torch.tensor([0.0, 0.0, 0.0]), v_want,
                                 s_want, v_pre_far, 0.5)
    assert not bad["ok"] and bad["flipped_off_threshold"] == 1
    off = ref.compare_float_step(v_want + 1e-3, s_want, v_want, s_want, v_pre, 0.5)
    assert not off["ok"]


def test_ops_route_cpu_tensors_to_plain_versions(jax_ref):
    s, w = _gemm_inputs(70, 18, 16, 0.2)
    s_t, w_t = torch.from_numpy(s), torch.from_numpy(w)
    before = dict(LAUNCHES)
    partial = ops.spike_gemm_op(s_t, w_t)
    assert_same(partial, ref.spike_gemm_ref(s_t, w_t))
    jnp = jax_ref.jnp
    assert_same(partial, jax_ref.ref.spike_gemm_ref(jnp.asarray(s), jnp.asarray(w)))
    rng = np.random.default_rng(5)
    v = rng.integers(-64, 64, (70, 16)).astype(np.int16)  # cast to int32 by the op
    vi, si = ops.lif_step_int_op(torch.from_numpy(v), partial, 9, leak_shift=3)
    vij, sij = jax_ref.ref.lif_step_int_ref(jnp.asarray(v.astype(np.int32)),
                                            jnp.asarray(np.asarray(partial)), 9, 3)
    assert_same(vi, vij)
    assert_same(si, sij)
    vf = rng.normal(size=(70, 16)).astype(np.float32)
    cur = rng.normal(size=(70, 16)).astype(np.float32)
    vo, so = ops.lif_step_op(torch.from_numpy(vf), torch.from_numpy(cur), 0.5, 0.9, True)
    vj, sj = jax_ref.ref.lif_step_ref(jnp.asarray(vf), jnp.asarray(cur), 0.5, 0.9, True)
    np.testing.assert_allclose(vo.numpy(), np.asarray(vj), rtol=1e-6, atol=1e-6)
    assert_same(so, sj)
    assert LAUNCHES == before


def test_ops_never_fall_back():
    """Neither CPU nor CUDA: the wrappers raise instead of computing."""
    meta = dict(device="meta")
    s = torch.zeros((4, 8), dtype=torch.int8, **meta)
    w = torch.zeros((8, 2), dtype=torch.int8, **meta)
    vi = torch.zeros((4, 2), dtype=torch.int32, **meta)
    vf = torch.zeros((4, 2), dtype=torch.float32, **meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.spike_gemm_op(s, w)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.lif_step_int_op(vi, vi, 3)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.lif_step_op(vf, vf)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fused_lif_gemm(s.to(torch.float32), w.to(torch.float32), vf)


def test_launch_counter_is_shared():
    """One dict for the whole package, with every CUDA entry point."""
    assert fk.LAUNCHES is LAUNCHES
    assert set(LAUNCHES) == {"fused_lif_gemm_int", "fused_lif_gemm_int_tblk",
                             "fused_lif_gemm", "spike_gemm", "lif_step_fused",
                             "lif_step_fused_int", "quant_matmul_int8",
                             "quant_matmul_int4", "wkv_sequence"}


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions (skip here).
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("mkn", GEMM_SHAPES + [(16384, 18, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_spike_gemm_matches_plain(cuda_device, mkn):
    for density in (0.0, 0.05, 0.5):
        s, w = (torch.from_numpy(x) for x in _gemm_inputs(*mkn, density))
        want = ref.spike_gemm_ref(s, w)
        for skip_empty, mode in SKIPS:
            got = sk.spike_gemm(s.to(cuda_device), w.to(cuda_device),
                                skip_empty=skip_empty, skip_mode=mode)
            torch.cuda.synchronize()
            assert got.is_cuda
            assert_same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(7,), (33, 65), (3, 17, 29), (16384, 16)])
def test_cuda_lif_step_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(len(shape))
    v = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    i = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    for leak, soft in ((1.0, False), (0.9, True)):
        want = ref.lif_step_ref(v, i, 0.5, leak, soft)
        got = lk.lif_step_fused(v.to(cuda_device), i.to(cuda_device), 0.5, leak, soft)
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            assert_same(g, w_)
    vi = torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int32))
    pi = torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int32))
    for shift, soft in ((0, False), (3, True)):
        want = ref.lif_step_int_ref(vi, pi, 9, shift, soft, 7)
        got = lk.lif_step_fused_int(vi.to(cuda_device), pi.to(cuda_device), 9,
                                    shift, soft, 7)
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            assert_same(g, w_)


# B3's plan: the quickstart's four shapes, flow, ragged ones, and fan-ins
# on both sides of the ring's reach.
B3_PLAN_SHAPES = [(16384, 18, 16), (16384, 144, 16), (4096, 144, 16), (4, 64, 11),
                  (221184, 288, 32), (221184, 288, 2), (4097, 145, 33), (65, 130, 40),
                  (100, 320, 32), (100, 321, 32), (4096, 2000, 32)]


@pytest.mark.parametrize("mkn", B3_PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sms", [132, 8])
def test_fused_lif_gemm_float_plan_geometry(mkn, sms):
    """On the ring: a persistent grid no larger than the tiles or the card,
    2-4 stages, shared memory within a block's share; the tile loop, one
    block per M tile, exactly where two stages do not fit."""
    m, k, n = mkn
    plan = fk.f32_plan(m, k, n, sms)
    slabs, tiles = -(-n // 32), -(-m // 64)
    if plan.route == "tile":
        assert fk.f32_smem(k, n, 2) > 227 * 1024 and plan.grid_x == tiles
        return
    assert plan.route == "ring" and fk.f32_smem(k, n, 2) <= 227 * 1024
    assert 1 <= plan.grid_x <= tiles and 2 <= plan.stages <= 4
    assert plan.grid_x * slabs <= max(slabs, 4 * sms)
    smem = fk.f32_smem(k, n, plan.stages)
    per_sm = -(-plan.grid_x * slabs // sms)
    assert smem <= 227 * 1024 and per_sm * (smem + 1024) <= 228 * 1024


def test_fused_lif_gemm_float_plan_main_shapes():
    """Gesture conv: one block per SM with 4 stages of 64 x 144 fp32 spikes
    (36,864 bytes + 32 of slack) and 64 x 16 Vmem beside the 144 x 16
    weight slab (9,216 bytes) and 8 KB of partial sums; flow-middle: 2
    stages of 64 x 288 floats + 64 x 32."""
    assert fk.f32_plan(16384, 144, 16, 132) == ("ring", 132, 4)
    assert fk.f32_smem(144, 16, 4) == 128 + 9216 + 8192 + 4 * (36992 + 4096)
    assert fk.f32_plan(221184, 288, 32, 132) == ("ring", 132, 2)
    assert fk.f32_plan(4, 64, 11, 132)[:2] == ("ring", 1)


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", [(65, 130, 40), (16384, 144, 16), (100, 18, 33),
                                 (16384, 18, 16), (4096, 144, 16), (4, 64, 11),
                                 (4097, 36, 11), (70, 321, 32), (130, 2000, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_fused_lif_gemm_float_matches_plain(cuda_device, mkn):
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = mkn
    rng = np.random.default_rng(m)
    s = torch.from_numpy((rng.random((m, k)) < 0.1).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(cuda_device)
    v = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(cuda_device)
    before = fk.LAUNCHES["fused_lif_gemm"]
    for leak, soft in ((1.0, False), (0.9, True)):
        vw, sw = ref.fused_lif_gemm_ref(s, w, v, 0.5, leak, soft)
        vg, sg = fk.fused_lif_gemm(s, w, v, 0.5, leak, soft)
        torch.cuda.synchronize()
        v_pre = (v * leak if leak != 1.0 else v) + s @ w
        res = ref.compare_float_step(vg, sg, vw, sw, v_pre, 0.5)
        assert res["ok"], res
    assert fk.LAUNCHES["fused_lif_gemm"] == before + 2


# B4 on the card: ragged M, odd K, N from one n8 tile to three slabs, fan-ins
# on both sides of the ring's reach (1,441 is its last).
B4_GPU_SHAPES = [(333, 145, 2), (200, 18, 16), (129, 288, 32), (65, 77, 33),
                 (97, 64, 70), (70, 1441, 32), (70, 1442, 32), (16384, 144, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", B4_GPU_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_spike_gemm_routes_match_plain(cuda_device, mkn):
    """B4 on either route, in every skip mode, on random and on clustered
    spikes (empty 64-row tiles)."""
    m, k, n = mkn
    assert sk.plan(m, k, n, 132).route == ("ring" if k <= 1441 else "tile")
    s, w = (torch.from_numpy(x) for x in _gemm_inputs(m, k, n, 0.1))
    clustered = s.clone()
    clustered[: min(m, 64)] = 0
    clustered[m // 2:] = 0
    for spikes in (s, clustered):
        want = ref.spike_gemm_ref(spikes, w)
        for skip_empty, mode in SKIPS:
            got = sk.spike_gemm(spikes.to(cuda_device), w.to(cuda_device),
                                skip_empty=skip_empty, skip_mode=mode)
            torch.cuda.synchronize()
            assert got.is_cuda
            assert_same(got, want)


@pytest.mark.gpu
def test_cuda_spike_gemm_view_and_launches(cuda_device):
    """Spikes that start off 16-byte alignment give the same result, and
    each call launches the kernel once whatever its mode."""
    s, w = (torch.from_numpy(x) for x in _gemm_inputs(333, 144, 16, 0.1))
    want = ref.spike_gemm_ref(s, w)
    flat = torch.zeros(s.numel() + 1, dtype=torch.int8, device=cuda_device)
    view = flat[1:].view(s.shape)
    view.copy_(s.to(cuda_device))
    assert view.data_ptr() % 16 != 0
    before = LAUNCHES["spike_gemm"]
    for skip_empty, mode in SKIPS:
        assert_same(sk.spike_gemm(view, w.to(cuda_device), skip_empty=skip_empty,
                                  skip_mode=mode), want)
    assert LAUNCHES["spike_gemm"] == before + len(SKIPS)
