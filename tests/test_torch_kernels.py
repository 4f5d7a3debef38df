"""Port parity, kernels: repro_torch.kernels against repro.kernels.

On the CPU the wrappers run their plain PyTorch versions; those are held
exactly (tolerance 0) against the JAX Pallas kernels in interpret mode and
against the JAX oracles.  The CUDA kernels themselves run only on the card:
the ``gpu`` tests hold them against the plain versions there and skip here.
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, cuda_device, jax_ref  # noqa: F401
from repro_torch.kernels import _ring
from repro_torch.kernels import fused_lif_gemm as fk
from repro_torch.kernels import ref

# (m, k, n, density, vmem_bits, leak_shift, soft, per_channel, skip_empty)
CASES = [
    (37, 18, 16, 0.3, 7, 3, False, False, True),
    (100, 144, 11, 0.05, 11, 0, True, True, True),
    (257, 70, 33, 0.5, 15, 2, True, False, False),
    (64, 64, 32, 0.2, 7, 1, False, True, False),
    (45, 288, 2, 0.1, 11, 3, True, True, True),
    (33, 40, 5, 0.0, 7, 2, False, False, True),   # all-zero spikes
    (300, 288, 2, 0.1, 7, 0, True, False, True),  # the flow net's last layer
    (200, 18, 16, 0.2, 7, 3, False, True, False), # the gesture net's first
]


def _inputs(m, k, n, density, vmem_bits, per_channel, t=None, seed=0):
    rng = np.random.default_rng([m, k, n, seed])
    v_max = (1 << (vmem_bits - 1)) - 1
    w_max = (1 << ((vmem_bits + 1) // 2 - 1)) - 1
    shape = (m, k) if t is None else (t, m, k)
    s = (rng.random(shape) < density).astype(np.int8)
    w = rng.integers(-w_max - 1, w_max + 1, (k, n)).astype(np.int8)
    v = rng.integers(-v_max - 1, v_max + 1, (m, n)).astype(np.int32)
    if per_channel:
        thr = rng.integers(1, max(2, v_max // 4), (n,)).astype(np.int32)
    else:
        thr = int(max(1, v_max // 8))
    return s, w, v, thr


def _thr(thr, framework, jnp=None):
    if isinstance(thr, int):
        return thr
    return torch.from_numpy(thr) if framework == "torch" else jnp.asarray(thr)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:3])))
def test_fused_lif_gemm_int_matches_jax(jax_ref, case):
    m, k, n, density, bits, leak, soft, per_channel, skip = case
    s, w, v, thr = _inputs(m, k, n, density, bits, per_channel)
    kw = dict(leak_shift=leak, soft_reset=soft, vmem_bits=bits)
    before = dict(fk.LAUNCHES)
    got = fk.fused_lif_gemm_int(torch.from_numpy(s), torch.from_numpy(w),
                                torch.from_numpy(v), _thr(thr, "torch"),
                                skip_empty=skip, **kw)
    assert fk.LAUNCHES == before  # CPU tensors take the plain version
    jnp = jax_ref.jnp
    want = jax_ref.kernels.fused_lif_gemm_int(
        jnp.asarray(s), jnp.asarray(w), jnp.asarray(v), _thr(thr, "jax", jnp),
        interpret=True, skip_empty=skip, block=(32, 128, 32), **kw)
    oracle = jax_ref.ref.fused_lif_gemm_int_ref(
        jnp.asarray(s), jnp.asarray(w), jnp.asarray(v), _thr(thr, "jax", jnp),
        leak, soft, bits)
    for g, wj, o in zip(got, want, oracle):
        assert g.dtype == torch.int32
        assert_same(g, wj)
        assert_same(g, o)


@pytest.mark.parametrize("case", CASES[:4], ids=lambda c: "x".join(map(str, c[:3])))
@pytest.mark.parametrize("t", [1, 3])
def test_fused_lif_gemm_int_tblk_matches_jax(jax_ref, case, t):
    m, k, n, density, bits, leak, soft, per_channel, skip = case
    s, w, v, thr = _inputs(m, k, n, density, bits, per_channel, t=t)
    kw = dict(leak_shift=leak, soft_reset=soft, vmem_bits=bits)
    vt, st = fk.fused_lif_gemm_int_tblk(torch.from_numpy(s), torch.from_numpy(w),
                                        torch.from_numpy(v), _thr(thr, "torch"),
                                        skip_empty=skip, **kw)
    assert vt.shape == (t, m, n) and st.shape == (t, m, n)
    jnp = jax_ref.jnp
    vj, sj = jax_ref.kernels.fused_lif_gemm_int_tblk(
        jnp.asarray(s), jnp.asarray(w), jnp.asarray(v), _thr(thr, "jax", jnp),
        interpret=True, skip_empty=skip, block=(32, 128, 32), **kw)
    assert_same(vt, vj)
    assert_same(st, sj)
    # ...and equal to the single-step kernel applied sequentially over t.
    vv = torch.from_numpy(v)
    for i in range(t):
        vv, ss = fk.fused_lif_gemm_int(torch.from_numpy(s[i]), torch.from_numpy(w),
                                       vv, _thr(thr, "torch"), **kw)
        assert_same(vv, vt[i])
        assert_same(ss, st[i])


# (m, k, n, t, block): T = 5, N = 2 and 33, and a fan-in beyond the ring's
# reach (the tile-loop route on the card), each against the Pallas kernel.
TBLK_EDGES = [(45, 288, 2, 5, (32, 128, 32)), (70, 70, 33, 5, (32, 128, 32)),
              (40, 1500, 8, 5, (32, 128, 512)), (20, 1500, 33, 2, (32, 128, 512))]


@pytest.mark.parametrize("case", TBLK_EDGES, ids=lambda c: "x".join(map(str, c[:4])))
@pytest.mark.parametrize("per_channel", [False, True])
def test_fused_lif_gemm_int_tblk_edges_match_jax(jax_ref, case, per_channel):
    m, k, n, t, block = case
    s, w, v, thr = _inputs(m, k, n, 0.2, 7, per_channel, t=t, seed=5)
    kw = dict(leak_shift=2, soft_reset=per_channel, vmem_bits=7)
    vt, st = fk.fused_lif_gemm_int_tblk(torch.from_numpy(s), torch.from_numpy(w),
                                        torch.from_numpy(v), _thr(thr, "torch"), **kw)
    jnp = jax_ref.jnp
    vj, sj = jax_ref.kernels.fused_lif_gemm_int_tblk(
        jnp.asarray(s), jnp.asarray(w), jnp.asarray(v), _thr(thr, "jax", jnp),
        interpret=True, block=block, **kw)
    assert_same(vt, vj)
    assert_same(st, sj)


@pytest.mark.parametrize("shape,block", [((3, 100, 70), (32, 8, 16)),
                                         ((2, 64, 64), (64, 8, 32)),
                                         ((1, 5, 300), (128, 128, 128)),
                                         ((40, 20), (16, 8, 8))])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3])
def test_spike_tile_bitmap_matches_jax(jax_ref, shape, block, density):
    rng = np.random.default_rng(len(shape) + shape[-1])
    s = (rng.random(shape) < density).astype(np.int8)
    got = ref.spike_tile_bitmap(torch.from_numpy(s), block)
    want = jax_ref.kernels.spike_tile_bitmap(jax_ref.jnp.asarray(s), block)
    assert got.dtype == torch.int32
    assert_same(got, want)


# (m, k, n): the main paths' B1 shapes and ragged ones.
PLAN_SHAPES = [(221184, 288, 32), (221184, 288, 2), (16384, 144, 16),
               (16384, 18, 16), (4096, 144, 16), (4, 64, 11), (257, 70, 33),
               (37, 1300, 32), (1, 5, 100)]


@pytest.mark.parametrize("mkn", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sms", [132, 8])
def test_tc_plan_geometry(mkn, sms):
    """B1's launch geometry: a persistent grid no larger than the tiles or
    the card, 2-4 ring stages, and shared memory within a block's share."""
    m, k, n = mkn
    route, grid_x, stages = fk.tc_plan(m, k, n, sms)
    assert route == "ring"
    slabs, tiles = -(-n // 32), -(-m // 64)
    assert 1 <= grid_x <= tiles and 2 <= stages <= 4
    assert grid_x * slabs <= max(slabs, 4 * sms)
    smem = fk.tc_smem(k, n, stages)
    per_sm = -(-grid_x * slabs // sms)  # the grid's blocks all fit at once
    assert smem <= 227 * 1024 and per_sm * (smem + 1024) <= 228 * 1024


def test_tc_plan_main_shapes():
    """The flow middle layer: 2 blocks per SM, 3 stages of 64 x 288 spikes
    and 64 x 32 Vmem (26,752 bytes each) beside the 9,728-byte weight slab."""
    assert fk.tc_plan(221184, 288, 32, 132) == ("ring", 264, 3)
    assert fk.tc_smem(288, 32, 3) == 128 + 9728 + 3 * (18560 + 8192)
    # A slab of channels past 32 reads Vmem from device memory: no Vmem stage.
    assert fk.tc_smem(288, 33, 2) == 128 + 9728 + 2 * 18560


def test_tc_plan_routes_large_fan_in_to_the_tile_loop():
    """A fan-in whose two ring stages do not fit takes B2's tile loop at
    T = 1, one block per M tile, whatever the card."""
    assert fk.tc_smem(1500, 32, 2) > 227 * 1024
    assert fk.tc_plan(1000, 1500, 32, 132) == ("tile", 16, 0)


# B2's plan: the main paths' shapes, ragged ones, and fan-ins on both sides
# of the ring's reach.
TBLK_PLAN_SHAPES = PLAN_SHAPES + [(4096, 2000, 32), (4096, 288, 33),
                                  (70, 1393, 32), (70, 1394, 32), (64, 6000, 70)]


@pytest.mark.parametrize("mkn", TBLK_PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sms", [132, 8])
def test_tblk_plan_geometry(mkn, sms):
    """B2's launch geometry: on the ring, a persistent grid no larger than
    the tiles or the card, 2-8 stages, shared memory within a block's share;
    on the tile loop, one block per M tile and the slice within a block."""
    m, k, n = mkn
    plan = fk.tblk_plan(m, k, n, sms)
    slabs, tiles = -(-n // 32), -(-m // 64)
    if plan.route == "tile":
        assert fk.tblk_smem(k, n, 2) > 227 * 1024  # the ring does not fit
        assert plan.grid_x == tiles and fk.tblk_tile_smem(k) <= 227 * 1024
        return
    assert plan.route == "ring"
    assert 1 <= plan.grid_x <= tiles and 2 <= plan.stages <= 8
    assert plan.grid_x * slabs <= max(slabs, 4 * sms)
    smem = fk.tblk_smem(k, n, plan.stages)
    per_sm = -(-plan.grid_x * slabs // sms)
    assert smem <= 227 * 1024 and per_sm * (smem + 1024) <= 228 * 1024


def test_tblk_plan_main_shapes():
    """Flow middle: 2 blocks per SM, 5 stages of 64 x 288 spikes (48 bytes
    of slack: 18,560 each) beside the 9,728-byte weight slab and one 8 KB
    Vmem buffer; T does not enter the plan."""
    assert fk.tblk_plan(221184, 288, 32, 132) == ("ring", 264, 5)
    assert fk.tblk_smem(288, 32, 5) == 128 + 9728 + 8192 + 5 * 18560
    assert fk.tblk_plan(16384, 144, 16, 132) == ("ring", 256, 5)
    assert fk.tblk_plan(221184, 288, 2, 132)[:3] == ("ring", 264, 5)
    # Two slabs: Vmem comes from device memory, no Vmem buffer.
    assert fk.tblk_smem(288, 33, 2) == 128 + 9728 + 2 * 18560
    assert fk.tblk_tile_smem(2000) == 32 * (2048 // 4 + 4) * 4 + 4096


@pytest.mark.parametrize("n", [2, 16, 32, 33])
def test_tblk_plan_route_changes_where_two_stages_stop_fitting(n):
    """The ring up to the last fan-in whose two stages fit, the tile loop
    from the next one on, whatever M and the card."""
    k_max = max(k for k in range(1, 3000) if fk.tblk_smem(k, n, 2) <= 227 * 1024)
    assert fk.tblk_smem(k_max + 1, n, 2) > 227 * 1024
    for m, sms in ((100, 132), (221184, 8)):
        assert fk.tblk_plan(m, k_max, n, sms).route == "ring"
        assert fk.tblk_plan(m, k_max + 1, n, sms).route == "tile"


def test_tblk_plan_takes_any_fan_in_on_the_tile_loop():
    """No fan-in is refused: the tile loop holds the whole weight slice up
    to K = 7,104 and walks a larger fan-in in chunks of 7,104 rows, its
    shared memory within a block's share either way."""
    k_top = max(k for k in range(64, 8001, 64) if fk.tile_chunk(k) == k)
    assert k_top == 7104 == fk._TILE_K_MAX
    assert fk.tblk_plan(64, k_top, 32, 132).route == "tile"
    assert fk.tblk_plan(64, 8000, 32, 132) == ("tile", 1, 0)
    assert fk.tile_chunk(8000) == 7104 and fk.tblk_tile_smem(8000) <= 227 * 1024


# Fan-ins past each limit: B1's ring (K = 1,345 at N = 32), the tile loop's
# resident slice (K = 7,105), and beyond.
WIDE_FAN_INS = [1345, 1500, 7105, 8000]


@pytest.mark.parametrize("k", WIDE_FAN_INS)
@pytest.mark.parametrize("n", [11, 32, 33])
def test_plans_route_wide_fan_ins_to_the_tile_loop(k, n):
    """Both integer plans send a fan-in whose two ring stages do not fit to
    the tile loop (at N = 32 every fan-in here), which keeps the whole
    slice up to 7,104 rows and chunks it above."""
    for m in (4, 1000, 221184):
        for plan, two_stages in ((fk.tc_plan(m, k, n, 132), fk.tc_smem(k, n, 2)),
                                 (fk.tblk_plan(m, k, n, 132), fk.tblk_smem(k, n, 2))):
            if two_stages > 227 * 1024:
                assert plan == ("tile", -(-m // 64), 0)
            else:
                assert plan.route == "ring"
        assert fk.tc_plan(m, k, 32, 132).route == "tile"
    assert fk.tile_chunk(k) == (7104 if k > 7104 else _ring.round_up(k, 64))
    assert fk.tblk_tile_smem(k) <= 227 * 1024


def test_ring_grid_is_the_shared_search():
    """B1, B2 and B4 size their rings with one search (``_ring.ring_grid``):
    B1's plan equals it with B1's own stage."""
    k, n = 288, 32
    fixed = 128 + _ring.weight_bytes(k)
    stage = _ring.spike_bytes(k, 32) + _ring.tile_bytes(n)
    assert fk.tc_plan(221184, k, n, 132)[1:] == _ring.ring_grid(221184, k, n, fixed, stage, 4, 132)
    assert _ring.ring_grid(10, 5000, 32, fixed, 200000, 8, 132) is None


def test_kernel_times_tool_needs_a_card():
    """tools/torch_kernel_times.py measures the card only: without one it
    exits 2 and prints no result."""
    import pathlib
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("there is a card: the tool would time it")
    tool = pathlib.Path(__file__).resolve().parents[1] / "tools" / "torch_kernel_times.py"
    r = subprocess.run([sys.executable, str(tool)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 2 and r.stdout == "", (r.returncode, r.stdout, r.stderr)


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither CPU nor CUDA raises."""
    s = torch.zeros((4, 8), dtype=torch.int8, device="meta")
    w = torch.zeros((8, 2), dtype=torch.int8, device="meta")
    v = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fused_lif_gemm_int(s, w, v, 3)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fk.fused_lif_gemm_int_tblk(s[None], w, v, 3)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions (skip here).
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:3])))
def test_cuda_kernels_match_plain(cuda_device, case):
    m, k, n, density, bits, leak, soft, per_channel, skip = case
    kw = dict(leak_shift=leak, soft_reset=soft, vmem_bits=bits)
    for t in (None, 3):
        s, w, v, thr = _inputs(m, k, n, density, bits, per_channel, t=t)
        args = [torch.from_numpy(x) for x in (s, w, v)]
        thr_t = _thr(thr, "torch")
        plain = (ref.fused_lif_gemm_int_ref if t is None
                 else ref.fused_lif_gemm_int_tblk_ref)(*args, thr_t, **kw)
        kernel = fk.fused_lif_gemm_int if t is None else fk.fused_lif_gemm_int_tblk
        thr_d = thr_t if isinstance(thr_t, int) else thr_t.to(cuda_device)
        got = kernel(*[x.to(cuda_device) for x in args], thr_d,
                     skip_empty=skip, **kw)
        torch.cuda.synchronize()
        for g, p in zip(got, plain):
            assert g.is_cuda
            assert_same(g, p)


@pytest.mark.gpu
def test_cuda_fused_int_thresholds_views_and_launches(cuda_device):
    """B1 on the card: a scalar threshold equals the same value per channel,
    a spike matrix that starts off 16-byte alignment gives the same result,
    and each call launches the kernel once."""
    s, w, v, _ = _inputs(333, 144, 16, 0.1, 7, False)
    s_d, w_d, v_d = (torch.from_numpy(x).to(cuda_device) for x in (s, w, v))
    kw = dict(leak_shift=3, soft_reset=False, vmem_bits=7)
    want = ref.fused_lif_gemm_int_ref(*(torch.from_numpy(x) for x in (s, w, v)), 5, **kw)
    before = fk.LAUNCHES["fused_lif_gemm_int"]
    scalar = fk.fused_lif_gemm_int(s_d, w_d, v_d, 5, **kw)
    vector = fk.fused_lif_gemm_int(s_d, w_d, v_d, torch.full(
        (16,), 5, dtype=torch.int32, device=cuda_device), **kw)
    flat = torch.zeros(s.size + 1, dtype=torch.int8, device=cuda_device)
    shifted = flat[1:].view(s.shape)
    shifted.copy_(s_d)
    assert shifted.data_ptr() % 16 != 0
    view = fk.fused_lif_gemm_int(shifted, w_d, v_d, 5, **kw)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_lif_gemm_int"] == before + 3
    for got in (scalar, vector, view):
        for g, p in zip(got, want):
            assert_same(g, p)


# B2 on the card: ragged M, odd K, N from one n8 tile to three slabs, fan-ins
# on both sides of the ring's reach at N = 32 (1,393 is its last), and the
# tile loop where its shared memory crosses 48 KB (K 1,345-1,472, where it
# needs the opt-in).
TBLK_GPU_SHAPES = [(333, 145, 2), (200, 18, 16), (129, 288, 32), (65, 77, 33),
                   (97, 64, 70), (70, 1393, 32), (70, 1394, 32), (130, 1500, 16),
                   (64, 2000, 33)]


@pytest.mark.gpu
@pytest.mark.parametrize("mkn", TBLK_GPU_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_tblk_matches_plain(cuda_device, mkn):
    """B2 on either route against its plain version: T in {1, 3, 5}, scalar
    and per-channel thresholds, hard and soft reset, skip_empty on and off."""
    m, k, n = mkn
    ring = fk.tblk_smem(k, n, 2) <= 227 * 1024
    assert fk.tblk_plan(m, k, n, 132).route == ("ring" if ring else "tile")
    for t in (1, 3, 5):
        for per_channel, soft, leak in ((False, False, 3), (True, True, 0)):
            s, w, v, thr = _inputs(m, k, n, 0.15, 7, per_channel, t=t, seed=t)
            args = [torch.from_numpy(x) for x in (s, w, v)]
            thr_t = _thr(thr, "torch")
            kw = dict(leak_shift=leak, soft_reset=soft, vmem_bits=7)
            plain = ref.fused_lif_gemm_int_tblk_ref(*args, thr_t, **kw)
            thr_d = thr_t if isinstance(thr_t, int) else thr_t.to(cuda_device)
            for skip in (True, False):
                got = fk.fused_lif_gemm_int_tblk(*[x.to(cuda_device) for x in args],
                                                 thr_d, skip_empty=skip, **kw)
                torch.cuda.synchronize()
                for g, p in zip(got, plain):
                    assert g.is_cuda
                    assert_same(g, p)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [144, 1500], ids=["ring", "tile"])
def test_cuda_tblk_thresholds_views_and_launches(cuda_device, k):
    """B2 on the card: a scalar threshold equals the same value per channel,
    spikes and Vmem that start off 16-byte alignment give the same result,
    and each call launches the kernel once."""
    s, w, v, _ = _inputs(333, k, 16, 0.1, 7, False, t=3)
    s_d, w_d, v_d = (torch.from_numpy(x).to(cuda_device) for x in (s, w, v))
    kw = dict(leak_shift=3, soft_reset=False, vmem_bits=7)
    want = ref.fused_lif_gemm_int_tblk_ref(*(torch.from_numpy(x) for x in (s, w, v)),
                                           5, **kw)
    before = fk.LAUNCHES["fused_lif_gemm_int_tblk"]
    scalar = fk.fused_lif_gemm_int_tblk(s_d, w_d, v_d, 5, **kw)
    vector = fk.fused_lif_gemm_int_tblk(s_d, w_d, v_d, torch.full(
        (16,), 5, dtype=torch.int32, device=cuda_device), **kw)
    flat = torch.zeros(s.size + 1, dtype=torch.int8, device=cuda_device)
    s_view = flat[1:].view(s.shape)
    s_view.copy_(s_d)
    vflat = torch.zeros(v.size + 1, dtype=torch.int32, device=cuda_device)
    v_view = vflat[1:].view(v.shape)
    v_view.copy_(v_d)
    assert s_view.data_ptr() % 16 != 0 and v_view.data_ptr() % 16 != 0
    view = fk.fused_lif_gemm_int_tblk(s_view, w_d, v_view, 5, **kw)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_lif_gemm_int_tblk"] == before + 3
    for got in (scalar, vector, view):
        for g, p in zip(got, want):
            assert_same(g, p)


@pytest.mark.gpu
@pytest.mark.parametrize("k", WIDE_FAN_INS)
def test_cuda_wide_fan_in_matches_plain(cuda_device, k):
    """B1 and B2 past the ring: the tile loop at T = 1 (B1) and T = 3, its
    fan-in chunked past 7,104, against the plain versions; skip_empty on
    and off, scalar and per-channel thresholds, each call one launch."""
    for t in (None, 3):
        for per_channel, soft, leak in ((False, False, 3), (True, True, 0)):
            s, w, v, thr = _inputs(130, k, 32, 0.2, 15, per_channel, t=t, seed=k)
            args = [torch.from_numpy(x) for x in (s, w, v)]
            thr_t = _thr(thr, "torch")
            kw = dict(leak_shift=leak, soft_reset=soft, vmem_bits=15)
            name = "fused_lif_gemm_int" if t is None else "fused_lif_gemm_int_tblk"
            plain = (ref.fused_lif_gemm_int_ref if t is None
                     else ref.fused_lif_gemm_int_tblk_ref)(*args, thr_t, **kw)
            thr_d = thr_t if isinstance(thr_t, int) else thr_t.to(cuda_device)
            for skip in (True, False):
                before = fk.LAUNCHES[name]
                got = getattr(fk, name)(*[x.to(cuda_device) for x in args], thr_d,
                                        skip_empty=skip, **kw)
                torch.cuda.synchronize()
                assert fk.LAUNCHES[name] == before + 1
                for g, p in zip(got, plain):
                    assert g.is_cuda
                    assert_same(g, p)
