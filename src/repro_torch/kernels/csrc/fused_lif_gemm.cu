// Fused spike-GEMM + neuron update for Hopper (sm_90a).
//
// Four kernels, each replacing one Pallas TPU kernel of the JAX package:
//
//   lif_gemm_tc_kernel              replaces repro/kernels/fused_lif_gemm.py
//                                   fused_lif_gemm_int (_fused_int_body via
//                                   _fused_kernel_int / _fused_kernel_int_vec)
//   lif_gemm_tblk_tc_kernel         replaces fused_lif_gemm_int_tblk
//   fused_lif_gemm_int_tblk_kernel  (_tblk_int_body via _tblk_kernel_scalar /
//                                   _tblk_kernel_vec, bitmap prologue fused in):
//                                   the ring kernel, and the tile loop for a
//                                   fan-in whose ring does not fit
//   lif_gemm_f32_tc_kernel          replaces fused_lif_gemm (float,
//   fused_lif_gemm_f32_kernel       _fused_kernel_f32): the ring kernel, and
//                                   the tile loop for a fan-in whose ring does
//                                   not fit; see their own note below
//
// What the integer kernels compute, for each output (m, n) and timestep:
//   acc      = sum_k S[m,k] * W[k,n]                  (int32, exact)
//   partial  = clip(acc, v_min, v_max)                (clipped once, before the add)
//   v        = v - (v >> leak_shift)  if leak_shift > 0   (arithmetic shift)
//   v        = clip(v + partial, v_min, v_max)
//   s        = v >= thr[n]
//   v'       = soft ? clip(v - s*thr[n], v_min, v_max) : v*(1-s)   (hard: unclipped)
//
// What bounds them on this card: bytes.  Spikes are one byte per (m, k);
// Vmem in and Vmem/spikes out are four bytes per (m, n).  The optical-flow
// middle layer at B=2 (M = 221184, K = 288, N = 32) moves 149 MB (0.044 ms
// at 3.35 TB/s) for 4 GOP of products per timestep.
//
// B1, one timestep (lif_gemm_tc_kernel).  At that shape a __dp4a +
// shared-load instruction stream on the CUDA cores alone takes about as
// long as the bytes, so nothing would be left to hide the loads behind,
// and a block that loads, then multiplies, keeps little in flight.  So it
// runs on the tensor-core ring of tc_ring.cuh:
//   * a persistent grid (1 to 4 blocks of 4 warps per SM, as shared memory
//     allows) walks 64-row M tiles, each block's weight slab resident in
//     shared memory; a fan-in whose two ring stages do not fit beside it
//     (K above ~1,350 at N = 32; the networks' K is at most 288) takes B2's
//     tile loop below at T = 1 (the wrapper's plan, tc_plan, picks it);
//   * a stage holds a tile's spikes (64 x K bytes) and, when one slab
//     covers N, its Vmem (64 x N int32), both brought by 1-D bulk copies;
//     tiles i+1 .. i+stages-1 are in flight while tile i is multiplied;
//   * the neuron program runs on the accumulator fragment; v' and s are
//     written once, 8-byte stores filling whole 32-byte sectors.  A scalar
//     threshold is a kernel argument (no (N,) fill per launch);
//   * skip_empty has no effect: tensor-core products of an empty tile cost
//     less than the vote that would skip them, and the bytes are read anyway.
//
// B2, T timesteps per weight pass (lif_gemm_tblk_tc_kernel), is B1 with a
// loop over t and Vmem held in registers:
//   * the same persistent grid and resident weight slab, loaded once per
//     block for all tiles and all t (the chip's Vmem-stationary reuse);
//   * the T spike tiles (tile, t) of a block stream through the ring as
//     successive stages, so copies stay in flight across the t boundary and
//     across the tile boundary.  A stage holds spikes only;
//   * a tile's (64, N) Vmem is loaded once, by bulk copy into its own
//     buffer (one slab covers N) or by plain loads (N > 32), into the
//     accumulator-fragment layout in registers, and carried across t; the
//     next tile's Vmem copy starts as soon as this one is in registers;
//   * for each t: mma.sync over K, the neuron program on the fragment,
//     v_traj[t] and s[t] written once.  A scalar threshold is an argument;
//   * plane t of the spike stack starts at t*M*K bytes, which need not be
//     16-byte aligned: its copy starts at the 16-byte boundary below and
//     the warps read the stage from that offset (at most 15 bytes), and it
//     ends on the next 16-byte boundary (bytes of the next tile, into the
//     stage's slack) except at the end of the stack; hence 48 bytes of
//     slack past 64 x K;
//   * skip_empty has no effect, as in B1.
// A fan-in whose two ring stages do not fit takes the tile loop below
// (fused_lif_gemm_int_tblk_kernel, the first design): the block's (K, 32)
// weight slice in shared memory, (64, 64) spike tiles staged by the block
// and skipped when a block-wide vote (__syncthreads_or) finds them empty
// (skip_empty), __dp4a on CUDA cores, Vmem carried in registers.  Up to
// K = TILE_K_MAX (7,104) the slice stays resident for all T; beyond it the
// block walks the fan-in in chunks of TILE_K_MAX rows, reloading each
// chunk's slice per timestep, and carries the int32 sum in registers to
// the epilogue, which saturates the whole sum once (bit-exact at any K).
// The wrappers' plans (tc_plan, tblk_plan) pick the route by shape before
// launching; B1 takes it at T = 1.
#include "spike_tile.cuh"
#include "tc_ring.cuh"

namespace {

struct Epilogue {
  int leak_shift;
  int soft_reset;
  int v_min;
  int v_max;
};

// The neuron program on one output: returns v', writes the spike.
__device__ __forceinline__ int neuron(int acc, int v, int thr,
                                      const Epilogue& e, int& s) {
  const int partial = clampi(acc, e.v_min, e.v_max);
  if (e.leak_shift > 0) v = v - (v >> e.leak_shift);
  v = clampi(v + partial, e.v_min, e.v_max);
  s = v >= thr ? 1 : 0;
  if (e.soft_reset) return clampi(v - s * thr, e.v_min, e.v_max);
  return s ? 0 : v;
}

constexpr int TC_MAX_STAGES = 4;    // B1's ring
constexpr int TBLK_MAX_STAGES = 8;  // B2's ring (spikes-only stages)
constexpr int B1_SLACK = 32;        // stage bytes past 64 x K (see tc_ring.cuh)
constexpr int B2_SLACK = 48;        // ... plus a plane's misalignment

// B1's shared memory: barriers, the weight slab, then `stages` stages of
// the tile's spikes and (one slab covers N) Vmem.  The wrapper mirrors it
// (kernels/_ring.py).
inline int tc_smem(int K, int N, int stages) {
  const TcLayout lay(K, N, B1_SLACK);
  return TC_BARRIER_BYTES + lay.w_bytes + stages * (lay.s_bytes + lay.v_bytes);
}

// B2's: barriers (the stages' full barriers, then the Vmem barrier at byte
// 64), the weight slab, the Vmem buffer (one slab covers N), the stages.
inline int tblk_smem(int K, int N, int stages) {
  const TcLayout lay(K, N, B2_SLACK);
  return TC_BARRIER_BYTES + lay.w_bytes + lay.v_bytes + stages * lay.s_bytes;
}

// The thresholds of this thread's columns n0 + 8j + 2tig + c.
template <int NT>
__device__ __forceinline__ void load_thresholds(const int32_t* __restrict__ THR,
                                                int thr_scalar, int N, int n0,
                                                int (&thr)[NT][2]) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + j * 8 + tig * 2 + c;
      thr[j][c] = THR == nullptr ? thr_scalar : (n < N ? THR[n] : 0);
    }
}

// ---------------------------------------------------------------------------
// B1: one integer layer-timestep on the int8 tensor cores (see the header).
// Its body keeps its own issue, weight-slab and k loops, as written before
// tc_ring.cuh existed, and uses the header's primitives only: built from
// the header's shared loops (tile_mma, load_weight_slab, issue_spans) it
// compiled to other code and ran 4-5 % slower at gesture-first (PERF.md).
// ---------------------------------------------------------------------------
// Thread 0: start the bulk copies of tile `tile` into stage `st`.  The
// tile's spikes and Vmem are contiguous in device memory; a tail of under
// 16 bytes (a ragged last tile) is copied by plain loads, which the
// barriers between this call and the stage's use publish.
__device__ __forceinline__ void issue_tile(const int8_t* S, const int32_t* V,
                                           int M, int K, int N, bool vpre,
                                           int tile, uint8_t* st, int s_bytes,
                                           uint64_t* bar) {
  const int64_t m0 = int64_t(tile) * TC_BM;
  const uint32_t rows = uint32_t(min(int64_t(TC_BM), M - m0));
  const uint32_t sb = rows * K, sbulk = sb & ~15u;
  const uint32_t vb = vpre ? rows * N * 4 : 0u, vbulk = vb & ~15u;
  const uint8_t* sg = reinterpret_cast<const uint8_t*>(S + m0 * K);
  const uint8_t* vg = reinterpret_cast<const uint8_t*>(V + m0 * N);
  mbar_expect_tx(bar, sbulk + vbulk);
  if (sbulk) bulk_g2s(st, sg, sbulk, bar);
  if (vbulk) bulk_g2s(st + s_bytes, vg, vbulk, bar);
  for (uint32_t b = sbulk; b < sb; ++b) st[b] = sg[b];
  for (uint32_t b = vbulk; b < vb; ++b) st[s_bytes + b] = vg[b];
}

// Block (x, y) walks M tiles x, x + gridDim.x, ... for channels
// [32y, 32y + 32).  NT n8 tiles cover the slab; LDSM: K % 16 == 0.
template <int NT, bool LDSM>
__global__ void __launch_bounds__(TC_THREADS)
lif_gemm_tc_kernel(const int8_t* __restrict__ S, const int8_t* __restrict__ W,
                   const int32_t* __restrict__ V, const int32_t* __restrict__ THR,
                   int thr_scalar, int32_t* __restrict__ V_OUT,
                   int32_t* __restrict__ S_OUT, int M, int K, int N, Epilogue e,
                   int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const TcLayout lay(K, N, B1_SLACK);
  const int stage_bytes = lay.s_bytes + lay.v_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint8_t* wsm = smem + TC_BARRIER_BYTES;
  uint8_t* ring = wsm + lay.w_bytes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.y * TC_NB, nb = min(TC_NB, N - n0);
  const bool vpre = N <= TC_NB;
  const int k_pad = round_up(K, 32);
  const int tiles = (M + TC_BM - 1) / TC_BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int s = 0; s < stages; ++s) {
      const int tile = blockIdx.x + s * gridDim.x;
      if (tile < tiles)
        issue_tile(S, V, M, K, N, vpre, tile, ring + s * stage_bytes,
                   lay.s_bytes, &full[s]);
    }
  }
  // The weight slab, while the first tiles are in flight: wsm[n * w_stride
  // + k] = W[k, n0 + n], zero past K and past the slab's channels.
  constexpr int NP = NT * 8;
  const int wtotal = k_pad * NP;
  for (int base = threadIdx.x; base < wtotal; base += TC_THREADS * 8) {
    int8_t val[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + u * TC_THREADS, k = idx / NP, n = idx % NP;
      val[u] = (idx < wtotal && k < K && n < nb) ? W[int64_t(k) * N + n0 + n]
                                                  : int8_t(0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + u * TC_THREADS;
      if (idx < wtotal) wsm[(idx % NP) * lay.w_stride + idx / NP] = uint8_t(val[u]);
    }
  }
  // The thresholds of this thread's columns n0 + 8j + 2tig + c.
  int thr[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + j * 8 + tig * 2 + c;
      thr[j][c] = THR == nullptr ? thr_scalar : (n < N ? THR[n] : 0);
    }
  __syncthreads();

  const int r0 = warp * 16;  // this warp's rows of every tile
  for (int it = 0, tile = blockIdx.x; tile < tiles; ++it, tile += gridDim.x) {
    const int s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    const uint8_t* st = ring + s * stage_bytes;

    int acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0;
    for (int k0 = 0; k0 < k_pad; k0 += 32) {
      uint32_t a[4];
      if constexpr (LDSM) {
        ldmatrix_x4(a, st + (r0 + (lane & 15)) * K + k0 + (lane >> 4) * 16);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint8_t* p =
              st + (r0 + g + (q & 1) * 8) * K + k0 + (q >> 1) * 16 + tig * 4;
          a[q] = uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
                 uint32_t(p[3]) << 24;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint8_t* wp = wsm + (j * 8 + g) * lay.w_stride + k0 + tig * 4;
        mma_s8(acc[j], a, *reinterpret_cast<const uint32_t*>(wp),
               *reinterpret_cast<const uint32_t*>(wp + 16));
      }
    }

    // The neuron program on the fragment: rows g and g + 8 of the warp's
    // 16, columns 8j + 2tig and 8j + 2tig + 1.
    const int64_t m0 = int64_t(tile) * TC_BM;
    const int32_t* vs = reinterpret_cast<const int32_t*>(st + lay.s_bytes);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      const int64_t m = m0 + r;
      if (m >= M) continue;
      const int32_t* vrow = vpre ? vs + r * N : V + m * N;
      int32_t* vo = V_OUT + m * N;
      int32_t* so = S_OUT + m * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + j * 8 + tig * 2;
        if (n >= N) continue;
        if ((N & 1) == 0) {  // n + 1 < N, and 8-byte aligned
          const int2 v2 = *reinterpret_cast<const int2*>(vrow + n);
          int s0, s1;
          const int v0 = neuron(acc[j][2 * h], v2.x, thr[j][0], e, s0);
          const int v1 = neuron(acc[j][2 * h + 1], v2.y, thr[j][1], e, s1);
          *reinterpret_cast<int2*>(vo + n) = make_int2(v0, v1);
          *reinterpret_cast<int2*>(so + n) = make_int2(s0, s1);
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (n + c < N) {
              int sp;
              vo[n + c] = neuron(acc[j][2 * h + c], vrow[n + c], thr[j][c], e, sp);
              so[n + c] = sp;
            }
        }
      }
    }

    __syncthreads();  // every warp is done with stage s
    if (threadIdx.x == 0) {
      const int next = tile + stages * gridDim.x;
      if (next < tiles) {
        fence_proxy_async();
        issue_tile(S, V, M, K, N, vpre, next, ring + s * stage_bytes,
                   lay.s_bytes, &full[s]);
      }
    }
  }
}

using TcKernel = void (*)(const int8_t*, const int8_t*, const int32_t*,
                          const int32_t*, int, int32_t*, int32_t*, int, int, int,
                          Epilogue, int);

template <int NT>
TcKernel tc_kernel(bool ldsm) {
  return ldsm ? lif_gemm_tc_kernel<NT, true> : lif_gemm_tc_kernel<NT, false>;
}

// ---------------------------------------------------------------------------
// B2 on the tensor-core ring (see the header).
// ---------------------------------------------------------------------------
// Thread 0: start item q of this block, the spike tile of M tile
// blockIdx.x + (q / T) * gridDim.x at timestep q % T, into stage q % stages
// (nothing past the last tile).  The copy starts at the 16-byte boundary at
// or below the tile's first byte; tblk_head gives the offset.
__device__ __forceinline__ const uint8_t* tblk_tile(const int8_t* S, int M,
                                                    int K, int tile, int t) {
  return reinterpret_cast<const uint8_t*>(S) + int64_t(t) * M * K +
         int64_t(tile) * TC_BM * K;
}

__device__ __forceinline__ uint32_t tblk_head(const uint8_t* p) {
  return uint32_t(reinterpret_cast<uintptr_t>(p) & 15);
}

__device__ __forceinline__ void tblk_issue(const int8_t* S, int T, int M, int K,
                                           int tiles, int q, int stages,
                                           uint8_t* ring, int s_bytes,
                                           uint64_t* full) {
  const int i = q / T, t = q - i * T;
  const int tile = blockIdx.x + i * gridDim.x;
  if (tile >= tiles) return;
  const uint8_t* src = tblk_tile(S, M, K, tile, t);
  const uint32_t head = tblk_head(src);
  uint32_t bytes = head + tile_rows(M, tile) * K;
  const uint32_t up = (bytes + 15) & ~15u;  // past the tile, within the stack
  if (src - head + up <= tblk_tile(S, M, K, 0, T)) bytes = up;
  const int s = q % stages;
  issue_spans(&full[s], Span{ring + s * s_bytes, src - head, bytes},
              Span{nullptr, nullptr, 0u});
}

template <int NT, bool LDSM>
__global__ void __launch_bounds__(TC_THREADS)
lif_gemm_tblk_tc_kernel(const int8_t* __restrict__ S,
                        const int8_t* __restrict__ W,
                        const int32_t* __restrict__ V,
                        const int32_t* __restrict__ THR, int thr_scalar,
                        int32_t* __restrict__ V_OUT,
                        int32_t* __restrict__ S_OUT, int T, int M, int K, int N,
                        Epilogue e, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const TcLayout lay(K, N, B2_SLACK);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* vbar = reinterpret_cast<uint64_t*>(smem + 64);
  uint8_t* wsm = smem + TC_BARRIER_BYTES;
  uint8_t* vsm = wsm + lay.w_bytes;
  uint8_t* ring = vsm + lay.v_bytes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.y * TC_NB;
  const bool vpre = N <= TC_NB;
  const int tiles = (M + TC_BM - 1) / TC_BM;
  const int64_t plane_v = int64_t(M) * N;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_init(vbar, 1);
    mbar_init_fence();
    const int tile = blockIdx.x;
    if (vpre && tile < tiles)
      issue_spans(vbar, Span{vsm, reinterpret_cast<const uint8_t*>(
                                     V + int64_t(tile) * TC_BM * N),
                             tile_rows(M, tile) * N * 4},
                  Span{nullptr, nullptr, 0u});
    for (int q = 0; q < stages; ++q)
      tblk_issue(S, T, M, K, tiles, q, stages, ring, lay.s_bytes, full);
  }
  load_weight_slab<NT>(W, K, N, n0, wsm, lay.w_stride);
  int thr[NT][2];
  load_thresholds<NT>(THR, thr_scalar, N, n0, thr);
  __syncthreads();

  const int r0 = warp * 16;
  int q = 0;  // the block's item: (its i-th tile, t) is item i*T + t
  for (int i = 0, tile = blockIdx.x; tile < tiles; ++i, tile += gridDim.x) {
    const int64_t m0 = int64_t(tile) * TC_BM;
    // This tile's Vmem, in the accumulator-fragment layout.
    int vr[NT][4];
    if (vpre) mbar_wait(vbar, i & 1);
    const int32_t* vsrc = vpre ? reinterpret_cast<const int32_t*>(vsm) : V + m0 * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      const bool row = m0 + r < M;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + j * 8 + tig * 2;
        if (row && (N & 1) == 0 && n < N) {
          const int2 v2 = *reinterpret_cast<const int2*>(vsrc + r * N + n);
          vr[j][2 * h] = v2.x;
          vr[j][2 * h + 1] = v2.y;
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            vr[j][2 * h + c] = (row && n + c < N) ? vsrc[r * N + n + c] : 0;
        }
      }
    }

    for (int t = 0; t < T; ++t, ++q) {
      const int s = q % stages;
      mbar_wait(&full[s], (q / stages) & 1);
      const uint8_t* src = tblk_tile(S, M, K, tile, t);
      int acc[NT][4];
      tile_mma<NT, LDSM>(ring + s * lay.s_bytes + tblk_head(src), K, wsm,
                         lay.w_stride, acc);

      __syncthreads();  // every warp is done with stage s (and, t = 0, vsm)
      if (threadIdx.x == 0) {
        fence_proxy_async();
        tblk_issue(S, T, M, K, tiles, q + stages, stages, ring, lay.s_bytes, full);
        const int next = tile + gridDim.x;
        if (t == 0 && vpre && next < tiles)
          issue_spans(vbar, Span{vsm, reinterpret_cast<const uint8_t*>(
                                         V + int64_t(next) * TC_BM * N),
                                 tile_rows(M, next) * N * 4},
                      Span{nullptr, nullptr, 0u});
      }

      // The neuron program on the fragment, Vmem carried in vr.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t m = m0 + r0 + g + 8 * h;
        if (m >= M) continue;
        int32_t* vo = V_OUT + t * plane_v + m * N;
        int32_t* so = S_OUT + t * plane_v + m * N;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = n0 + j * 8 + tig * 2;
          if (n >= N) continue;
          int sp[2];
#pragma unroll
          for (int c = 0; c < 2; ++c)
            vr[j][2 * h + c] =
                neuron(acc[j][2 * h + c], vr[j][2 * h + c], thr[j][c], e, sp[c]);
          if ((N & 1) == 0) {  // n + 1 < N, and 8-byte aligned
            *reinterpret_cast<int2*>(vo + n) =
                make_int2(vr[j][2 * h], vr[j][2 * h + 1]);
            *reinterpret_cast<int2*>(so + n) = make_int2(sp[0], sp[1]);
          } else {
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (n + c < N) {
                vo[n + c] = vr[j][2 * h + c];
                so[n + c] = sp[c];
              }
          }
        }
      }
    }
  }
}

using TblkKernel = void (*)(const int8_t*, const int8_t*, const int32_t*,
                            const int32_t*, int, int32_t*, int32_t*, int, int,
                            int, int, Epilogue, int);

template <int NT>
TblkKernel tblk_kernel(bool ldsm) {
  return ldsm ? lif_gemm_tblk_tc_kernel<NT, true>
              : lif_gemm_tblk_tc_kernel<NT, false>;
}

// The tile loop's weight slice: all of K (padded to BK) where it fits in a
// block's shared memory beside the static spike tile, else chunks of
// TILE_K_MAX fan-in rows.
constexpr int TILE_K_MAX = ((TC_SMEM_MAX - BM * BK) / (BN * 4) - 4) * 4 / BK * BK;

inline int tile_chunk(int K) { return min(round_up(K, BK), TILE_K_MAX); }

// B2's tile loop for a fan-in beyond the ring, and B1's at T = 1 (see the
// header).  THR null: the scalar thr_scalar.
__global__ void __launch_bounds__(THREADS)
fused_lif_gemm_int_tblk_kernel(const int8_t* __restrict__ S,
                               const int8_t* __restrict__ W,
                               const int32_t* __restrict__ V,
                               const int32_t* __restrict__ THR, int thr_scalar,
                               int32_t* __restrict__ V_OUT,
                               int32_t* __restrict__ S_OUT, int T, int M,
                               int K, int N, int k_chunk, Epilogue e,
                               int skip_empty, int vec) {
  // The block's (k_chunk, BN) weight slice: loaded once for all T when it
  // holds all of K, else one chunk of the fan-in at a time.
  extern __shared__ __align__(16) int32_t w_all[];
  __shared__ __align__(16) int8_t s_tile[BM * BK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t m0 = int64_t(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int w_stride = k_chunk / 4 + 4;
  const int k_pad = round_up(K, BK);
  const bool resident = k_chunk >= k_pad;
  const int n = n0 + lane;
  int8_t* w_bytes = reinterpret_cast<int8_t*>(w_all);

  if (resident) load_weights(W, K, N, 0, k_pad, n0, w_bytes, w_stride);

  // Vmem tile in registers, carried across timesteps.
  int v[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int64_t m = m0 + warp + i * WARPS;
    v[i] = (m < M && n < N) ? V[m * N + n] : 0;
  }
  const int thr = n < N ? (THR == nullptr ? thr_scalar : THR[n]) : 0;
  __syncthreads();  // w_all complete

  const int64_t plane_s = int64_t(M) * K, plane_v = int64_t(M) * N;
  for (int t = 0; t < T; ++t) {
    const int8_t* St = S + t * plane_s;
    int acc[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) acc[i] = 0;
    for (int kc = 0; kc < K; kc += k_chunk) {
      // A chunk's slice: the previous chunk's last barrier has passed, and
      // the vote below is the barrier that publishes it.
      if (!resident)
        load_weights(W, K, N, kc, min(k_chunk, k_pad - kc), n0, w_bytes, w_stride);
      for (int k0 = kc; k0 < min(K, kc + k_chunk); k0 += BK) {
        const int any = load_spike_tile(St, M, K, m0, k0, s_tile, vec);
        if (__syncthreads_or(any) || !skip_empty)
          mac_tile(s_tile, w_all + (k0 - kc) / 4, w_stride, acc);
        __syncthreads();
      }
    }
    if (n < N) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int64_t m = m0 + warp + i * WARPS;
        if (m < M) {
          const int64_t idx = t * plane_v + m * N + n;
          int s;
          v[i] = neuron(acc[i], v[i], thr, e, s);
          V_OUT[idx] = v[i];
          S_OUT[idx] = s;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B3: the float fused step.
//
// Replaces repro/kernels/fused_lif_gemm.py fused_lif_gemm (_fused_kernel_f32):
//   acc = S @ W (fp32);  v = leak != 1 ? v * leak : v;  v = v + acc;
//   s = v >= thr;  v' = soft ? v - s * thr : v * (1 - s).
// Spikes arrive as the float32 im2col matrix of the training-mode forward.
//
// What bounds it on this card: bytes.  Float spikes are four bytes per
// (m, k): at the gesture conv shape (16384, 144, 16) they are 9.4 MB of the
// 12.6 MB moved (3.8 us at 3.35 TB/s), at flow-middle 255 MB.
//
// The ring kernel (lif_gemm_f32_tc_kernel) is B1's design in fp32:
//   * a persistent grid of 8-warp blocks walks 64-row M tiles; each block
//     keeps its (K, <= 32) fp32 weight slab in shared memory, in W's own
//     layout when N <= 16 (one bulk copy, issued ahead of the first
//     tile's; see F32Layout);
//   * a tile's spikes (64 x K x 4 bytes, one contiguous range) and, when
//     one slab covers N, its Vmem (64 x N x 4 bytes) arrive by 1-D bulk
//     copies into a ring of 2 to 4 stages (tc_ring.cuh's mbarriers), so up
//     to stages - 1 later tiles are in flight while one is multiplied.  A
//     block's second tile is requested only once its first has landed:
//     requested together, every block's first tiles would land together,
//     at the end of the whole transfer;
//   * products on the tensor cores, mma.sync m16n8k8 TF32: a warp owns 16
//     rows of the tile over half of the fan-in, and NT n8 tiles cover the
//     slab (N = 16: two, no lane on padding); the two halves meet in shared
//     memory before the epilogue.  0/1 spikes are exact in TF32; each
//     weight is split into w_hi = tf32(w) and w_lo = tf32(w - w_hi), and
//     both products are summed in fp32 (w - w_hi - w_lo is below
//     2^-22 |w|);
//   * the epilogue on the accumulator fragment, with the same roundings as
//     the plain version; v' and s written once, 8-byte stores;
//   * skip_empty has no effect, as in B1.
// A fan-in whose two ring stages do not fit (K above 320 at N = 32) takes
// the tile loop below (fused_lif_gemm_f32_kernel, the first design), picked
// by the wrapper's plan (f32_plan).
//
// The tile loop: at flow-middle the spike matrix is ~12 flop per byte if
// every product were taken, below the ~20 flop per byte where the CUDA
// cores' fp32 rate (67 TFLOP/s) would become the limit.  So the design
// reads each spike once, as B1 does: a
// block owns a (BM, BN) output tile, stages (BM, FBK) spike tiles and
// (FBK, BN) weight tiles in shared memory, and keeps ROWS fp32
// accumulators per thread in registers.  Spike rows are read as float4
// broadcasts (one shared load serves four fan-in terms for the whole
// warp); weights one float per lane, conflict-free.
//
// Keeping HBM busy: the next tile is fetched into registers (16-byte loads
// when K % 4 == 0) before the current one is multiplied, so its loads are
// in flight during the FMAs; and the registers are capped so that
// F32_MIN_BLOCKS blocks share an SM.  (Loading, waiting and multiplying in
// turn, one block per SM, ran at ~5x the byte bound.)
//
// Numerics: ordinary fp32 FMA in ascending k (no TF32, no tensor cores);
// with 0/1 spikes each FMA is one rounded add of a weight.  The summation
// order differs from cuBLAS and XLA, hence the float tolerance.  The
// epilogue uses __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never contracts
// into an FMA, so it rounds exactly where the plain version rounds.
// Empty (BM, FBK) spike tiles are skipped by the block-wide vote of B1.
// ---------------------------------------------------------------------------
constexpr int FBK = 32;                           // fan-in floats per staged tile
constexpr int F_PER_THREAD = BM * FBK / THREADS;  // spike floats staged per thread
constexpr int W_PER_THREAD = FBK * BN / THREADS;  // weights staged per thread
constexpr int F32_MIN_BLOCKS = 2;                 // register cap: blocks per SM

// Fetch the (BM, FBK) spike tile and the (FBK, BN) weight tile at k0 into
// registers, zero outside the matrices.  vec (K % 4 == 0, S 16-byte
// aligned): float4 j of a thread is float4 number threadIdx.x + j*THREADS
// of the row-major tile, so a warp reads 4 rows x 128 contiguous bytes;
// otherwise float j is float number threadIdx.x + j*THREADS.
__device__ __forceinline__ void fetch_f32(const float* __restrict__ S,
                                          const float* __restrict__ W, int M,
                                          int K, int N, int64_t m0, int n0,
                                          int k0, int vec,
                                          float (&s)[F_PER_THREAD],
                                          float (&w)[W_PER_THREAD]) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < F_PER_THREAD / 4; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      const int64_t m = m0 + idx / (FBK / 4);
      const int k = k0 + (idx % (FBK / 4)) * 4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m < M && k < K) x = *reinterpret_cast<const float4*>(S + m * K + k);
      s[4 * j] = x.x;
      s[4 * j + 1] = x.y;
      s[4 * j + 2] = x.z;
      s[4 * j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < F_PER_THREAD; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      const int64_t m = m0 + idx / FBK;
      const int k = k0 + idx % FBK;
      s[j] = (m < M && k < K) ? S[m * K + k] : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < W_PER_THREAD; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    const int gk = k0 + idx / BN, gn = n0 + idx % BN;
    w[j] = (gk < K && gn < N) ? W[int64_t(gk) * N + gn] : 0.0f;
  }
}

// Store fetched registers into the shared tiles, with fetch_f32's index
// maps.  Returns whether this thread holds any non-zero spike.
__device__ __forceinline__ int stage_f32(const float (&s)[F_PER_THREAD],
                                         const float (&w)[W_PER_THREAD],
                                         float* s_tile, float* w_tile,
                                         int vec) {
  int any = 0;
#pragma unroll
  for (int j = 0; j < F_PER_THREAD; ++j) any |= (s[j] != 0.0f);
  if (vec) {
#pragma unroll
    for (int j = 0; j < F_PER_THREAD / 4; ++j)
      reinterpret_cast<float4*>(s_tile)[threadIdx.x + j * THREADS] =
          make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < F_PER_THREAD; ++j) s_tile[threadIdx.x + j * THREADS] = s[j];
  }
#pragma unroll
  for (int j = 0; j < W_PER_THREAD; ++j) w_tile[threadIdx.x + j * THREADS] = w[j];
  return any;
}

__global__ void __launch_bounds__(THREADS, F32_MIN_BLOCKS)
fused_lif_gemm_f32_kernel(const float* __restrict__ S,
                          const float* __restrict__ W,
                          const float* __restrict__ V,
                          float* __restrict__ V_OUT,
                          float* __restrict__ S_OUT, int M, int K, int N,
                          float thr, float leak, int soft_reset,
                          int skip_empty, int vec) {
  __shared__ __align__(16) float s_tile[BM * FBK];
  __shared__ __align__(16) float w_tile[FBK * BN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t m0 = int64_t(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.0f;

  float s_next[F_PER_THREAD], w_next[W_PER_THREAD];
  fetch_f32(S, W, M, K, N, m0, n0, 0, vec, s_next, w_next);
  for (int k0 = 0; k0 < K; k0 += FBK) {
    const int any = stage_f32(s_next, w_next, s_tile, w_tile, vec);
    // Block-wide vote, also the barrier that publishes both tiles.
    const int live = __syncthreads_or(any) || !skip_empty;
    // The next tile's loads are in flight while this one is multiplied.
    if (k0 + FBK < K)
      fetch_f32(S, W, M, K, N, m0, n0, k0 + FBK, vec, s_next, w_next);
    if (live) {
#pragma unroll
      for (int q = 0; q < FBK / 4; ++q) {
        const float w0 = w_tile[(4 * q + 0) * BN + lane];
        const float w1 = w_tile[(4 * q + 1) * BN + lane];
        const float w2 = w_tile[(4 * q + 2) * BN + lane];
        const float w3 = w_tile[(4 * q + 3) * BN + lane];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float4 s4 = reinterpret_cast<const float4*>(
              s_tile + (warp + i * WARPS) * FBK)[q];
          acc[i] = fmaf(s4.x, w0, acc[i]);
          acc[i] = fmaf(s4.y, w1, acc[i]);
          acc[i] = fmaf(s4.z, w2, acc[i]);
          acc[i] = fmaf(s4.w, w3, acc[i]);
        }
      }
    }
    __syncthreads();  // the next stage overwrites s_tile / w_tile
  }

  const int n = n0 + lane;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int64_t m = m0 + warp + i * WARPS;
    if (m < M) {
      const int64_t idx = m * N + n;
      float v = V[idx];
      if (leak != 1.0f) v = __fmul_rn(v, leak);
      v = __fadd_rn(v, acc[i]);
      const float s = v >= thr ? 1.0f : 0.0f;
      V_OUT[idx] = soft_reset ? __fsub_rn(v, __fmul_rn(s, thr))
                              : __fmul_rn(v, __fsub_rn(1.0f, s));
      S_OUT[idx] = s;
    }
  }
}

// The ring kernel's shared memory: the fp32 weight slab, one stage's spike
// tile (64 x K floats plus 32 bytes
// that ldmatrix reads past row 63 and discards) and Vmem tile (one slab
// covers N).  The slab, for N <= 16 (NT <= 2), is W itself, K padded to 8
// rows of N floats, brought by one bulk copy; for wider N it is n-major,
// 32 rows of K padded to 32 plus 4 floats (B-fragment loads of 8 rows x 4
// lanes hit 32 banks), loaded by the threads.  The wrapper mirrors it
// (kernels/fused_lif_gemm.py).  (Rows
// padded against ldmatrix's bank conflicts took one bulk copy per row, and
// issuing 64 of them stalled the issuing warp by microseconds.)
// `wcopy` is N <= 16; the kernel passes it as a constant (its NT <= 2), so
// that no field costs a run-time select.
struct F32Layout {
  int w_stride, w_bytes, s_bytes, v_bytes;
  __host__ __device__ F32Layout(int K, int N, bool wcopy)
      : w_stride(wcopy ? N : round_up(K, 32) + 4),
        w_bytes(round_up((wcopy ? round_up(K, 8) : TC_NB) * w_stride * 4, 128)),
        s_bytes(round_up(TC_BM * K * 4 + 32, 128)),
        v_bytes(N <= TC_NB ? round_up(TC_BM * N * 4, 128) : 0) {}
};

constexpr int F32_MAX_STAGES = 4;
constexpr int F32_THREADS = 256;
constexpr int F32_RED_BYTES = 4 * 32 * 16 * 4;  // the upper warps' sums (NT <= 4)

inline int f32_smem(int K, int N, int stages) {
  const F32Layout lay(K, N, N <= 16);
  return TC_BARRIER_BYTES + lay.w_bytes + F32_RED_BYTES +
         stages * (lay.s_bytes + lay.v_bytes);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// c += A (16x8 tf32, row) x B (8x8 tf32, col), fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float neuron_f32(float acc, float v, float thr,
                                            float leak, int soft_reset, float& s) {
  if (leak != 1.0f) v = __fmul_rn(v, leak);
  v = __fadd_rn(v, acc);
  s = v >= thr ? 1.0f : 0.0f;
  return soft_reset ? __fsub_rn(v, __fmul_rn(s, thr)) : __fmul_rn(v, __fsub_rn(1.0f, s));
}

// Block (x, y) walks M tiles x, x + gridDim.x, ... for channels
// [32y, 32y + 32).  NT n8 tiles cover the slab; LDSM: K % 4 == 0 (16-byte
// spike rows: ldmatrix reads the A fragments).  Eight warps: warp w takes
// rows 16 (w % 4) of the tile over half of the fan-in (w / 4); the upper
// half's sums reach the lower warps through shared memory, which run the
// epilogue.
template <int NT, bool LDSM>
__global__ void __launch_bounds__(F32_THREADS)
lif_gemm_f32_tc_kernel(const float* __restrict__ S, const float* __restrict__ W,
                       const float* __restrict__ V, float* __restrict__ V_OUT,
                       float* __restrict__ S_OUT, int M, int K, int N, float thr,
                       float leak, int soft_reset, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr bool WCOPY = NT <= 2;  // N <= 16: the slab is W itself
  const F32Layout lay(K, N, WCOPY);
  const int stage_bytes = lay.s_bytes + lay.v_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* wsm = reinterpret_cast<float*>(smem + TC_BARRIER_BYTES);
  float* red = reinterpret_cast<float*>(smem + TC_BARRIER_BYTES + lay.w_bytes);
  uint8_t* ring = smem + TC_BARRIER_BYTES + lay.w_bytes + F32_RED_BYTES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * TC_NB, nb = min(TC_NB, N - n0);
  const bool vpre = N <= TC_NB;
  const int k_pad = round_up(K, 8), k_half = k_pad / 16 * 8;
  const int k_lo = warp < 4 ? 0 : k_half, k_hi = warp < 4 ? k_half : k_pad;
  const int tiles = (M + TC_BM - 1) / TC_BM;
  // Thread 0: start the copies of tile `tile` into stage `s`.
  auto issue = [&](int tile, int s) {
    const int64_t m0 = int64_t(tile) * TC_BM;
    const uint32_t rows = tile_rows(M, tile);
    uint8_t* st = ring + s * stage_bytes;
    issue_spans(&full[s],
                Span{st, reinterpret_cast<const uint8_t*>(S + m0 * K), rows * K * 4},
                Span{st + lay.s_bytes, reinterpret_cast<const uint8_t*>(V + m0 * N),
                     vpre ? rows * N * 4 : 0u});
  };
  // The weight slab.  N <= 16: wsm[k * N + n] = W[k, n], thread 0 copies W
  // in bulk (counted on wbar) ahead of tile 0, the threads zero rows K to
  // K padded to 8.  Wider N: wsm[n * w_stride + k] = W[k, n0 + n], zero
  // past K and past the slab's channels, eight loads in flight per thread.
  uint64_t* wbar = full + F32_MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_init(wbar, 1);
    mbar_init_fence();
    if (WCOPY)
      issue_spans(wbar, Span{reinterpret_cast<uint8_t*>(wsm),
                             reinterpret_cast<const uint8_t*>(W), uint32_t(K * N * 4)},
                  Span{nullptr, nullptr, 0u});
  }
  if constexpr (WCOPY) {
    for (int i = K * N + threadIdx.x; i < k_pad * N; i += F32_THREADS) wsm[i] = 0.f;
  } else {
    constexpr int NP = NT * 8;
    const int wtotal = lay.w_stride * NP;
    for (int base = threadIdx.x; base < wtotal; base += F32_THREADS * 8) {
      float val[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * F32_THREADS, k = idx / NP, n = idx % NP;
        val[u] = (idx < wtotal && k < K && n < nb) ? W[int64_t(k) * N + n0 + n] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * F32_THREADS;
        if (idx < wtotal) wsm[(idx % NP) * lay.w_stride + idx / NP] = val[u];
      }
    }
  }
  __syncthreads();  // the barriers, the zeros, the loaded slab

  // The block's tile q goes to stage q % stages: tile 0 first, tile 1 once
  // tile 0 has landed, then each stage refilled as it frees.
  int issued = 0;
  auto top_up = [&](int last) {
    for (; issued <= last; ++issued) {
      const int next = blockIdx.x + issued * gridDim.x;
      if (next >= tiles) break;
      if (threadIdx.x == 0) {
        fence_proxy_async();
        issue(next, issued % stages);
      }
    }
  };
  top_up(0);
  if (WCOPY) mbar_wait(wbar, 0);

  const int r0 = (warp & 3) * 16;
  for (int it = 0, tile = blockIdx.x; tile < tiles; ++it, tile += gridDim.x) {
    const int s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    if (it == 0) top_up(1);
    const uint8_t* st = ring + s * stage_bytes;
    const float* sf = reinterpret_cast<const float*>(st);

    // Two accumulators per n8 tile: the w_hi products and the w_lo ones,
    // two independent chains of mma.sync.
    float acc[NT][4], lo[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = lo[j][i] = 0.f;
    for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
      // 0/1 spikes: their fp32 bits are exact TF32.  Columns past K read
      // zero (the stage past the last row holds stale or unset bytes).
      uint32_t a[4];
      if constexpr (LDSM) {  // K % 4 == 0: columns k0+4.. lie past K or not at all
        ldmatrix_x4(a, sf + (r0 + (lane & 15)) * K + k0 + (lane >> 4) * 4);
        if (k0 + 4 >= K) a[2] = a[3] = 0u;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + t + (q >> 1) * 4;
          a[q] = k < K ? __float_as_uint(sf[(r0 + g + (q & 1) * 8) * K + k]) : 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float w0, w1;
        if constexpr (WCOPY) {  // W itself: N columns, zero past them
          const bool live = j * 8 + g < N;
          w0 = live ? wsm[(k0 + t) * N + j * 8 + g] : 0.f;
          w1 = live ? wsm[(k0 + t + 4) * N + j * 8 + g] : 0.f;
        } else {
          const float* wp = wsm + (j * 8 + g) * lay.w_stride + k0 + t;
          w0 = wp[0];
          w1 = wp[4];
        }
        uint32_t h0, l0, h1, l1;
        split_tf32(w0, h0, l0);
        split_tf32(w1, h1, l1);
        mma_tf32(lo[j], a, l0, l1);
        mma_tf32(acc[j], a, h0, h1);
      }
    }
    float* rw = red + ((warp & 3) * 32 + lane) * (4 * NT);
    if (warp >= 4) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) rw[4 * j + i] = acc[j][i] + lo[j][i];
    }
    __syncthreads();  // the upper half's sums are in `red`

    // The neuron program on the fragment: rows g and g + 8 of the warp's
    // 16, columns 8j + 2t and 8j + 2t + 1.
    if (warp < 4) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = (acc[j][i] + lo[j][i]) + rw[4 * j + i];
      const int64_t m0 = int64_t(tile) * TC_BM;
      const float* vs = reinterpret_cast<const float*>(st + lay.s_bytes);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        const int64_t m = m0 + r;
        if (m >= M) continue;
        const float* vrow = vpre ? vs + r * N : V + m * N;
        float* vo = V_OUT + m * N;
        float* so = S_OUT + m * N;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = n0 + j * 8 + t * 2;
          if (n >= N) continue;
          if ((N & 1) == 0) {  // n + 1 < N, and 8-byte aligned
            const float2 v2 = *reinterpret_cast<const float2*>(vrow + n);
            float s0, s1;
            const float v0 = neuron_f32(acc[j][2 * h], v2.x, thr, leak, soft_reset, s0);
            const float v1 = neuron_f32(acc[j][2 * h + 1], v2.y, thr, leak, soft_reset, s1);
            *reinterpret_cast<float2*>(vo + n) = make_float2(v0, v1);
            *reinterpret_cast<float2*>(so + n) = make_float2(s0, s1);
          } else {
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (n + c < N) {
                float sp;
                vo[n + c] = neuron_f32(acc[j][2 * h + c], vrow[n + c], thr, leak,
                                       soft_reset, sp);
                so[n + c] = sp;
              }
          }
        }
      }
    }

    __syncthreads();  // every warp is done with stage s and `red`
    top_up(it + stages);
  }
}

using F32Kernel = void (*)(const float*, const float*, const float*, float*,
                           float*, int, int, int, float, float, int, int);

template <int NT>
F32Kernel f32_kernel(bool ldsm) {
  return ldsm ? lif_gemm_f32_tc_kernel<NT, true> : lif_gemm_f32_tc_kernel<NT, false>;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes).  Each launcher returns cudaGetLastError()
// right after the launch, so a refused launch reaches the wrapper as an error.
// ---------------------------------------------------------------------------
// Dynamic shared memory B1 needs for fan-in K, N channels and `stages`
// ring stages (the wrapper's plan mirrors it and checks it against this).
extern "C" int spidr_fused_lif_gemm_int_smem(int K, int N, int stages) {
  return tc_smem(K, N, stages);
}

// thr: (N,) int32, or null for the scalar thr_scalar.  grid_x blocks walk
// the M tiles (the wrapper sizes it to the card); s and v 16-byte aligned.
extern "C" int spidr_fused_lif_gemm_int(const void* s, const void* w,
                                        const void* v, const void* thr,
                                        int thr_scalar, void* v_out,
                                        void* s_out, int M, int K, int N,
                                        int leak_shift, int soft_reset,
                                        int v_min, int v_max, int grid_x,
                                        int stages, void* stream) {
  const int smem = tc_smem(K, N, stages);
  if (M <= 0 || K <= 0 || N <= 0 || grid_x <= 0 || stages < 2 ||
      stages > TC_MAX_STAGES || smem > TC_SMEM_MAX ||
      (reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return int(cudaErrorInvalidValue);
  const int nt = N >= TC_NB ? 4 : (N + 7) / 8;
  const bool ldsm = K % 16 == 0;
  const TcKernel kernels[4] = {tc_kernel<1>(ldsm), tc_kernel<2>(ldsm),
                               tc_kernel<3>(ldsm), tc_kernel<4>(ldsm)};
  const TcKernel kern = kernels[nt - 1];
  static bool smem_set[8] = {};  // above 48 KB only after opting in
  const cudaError_t err = allow_smem(kern, smem_set[2 * (nt - 1) + ldsm]);
  if (err != cudaSuccess) return int(err);
  const Epilogue e{leak_shift, soft_reset, v_min, v_max};
  kern<<<dim3(grid_x, (N + TC_NB - 1) / TC_NB), TC_THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(thr),
      thr_scalar, static_cast<int32_t*>(v_out), static_cast<int32_t*>(s_out), M,
      K, N, e, stages);
  return int(cudaGetLastError());
}

// Dynamic shared memory of B2's ring kernel for fan-in K, N channels and
// `stages` stages, and of its tile loop for fan-in K (the weight slice of
// tile_chunk(K) rows; the kernel adds a 4 KB static spike tile).  The
// wrappers' plans mirror both.
extern "C" int spidr_fused_lif_gemm_int_tblk_smem(int K, int N, int stages) {
  return tblk_smem(K, N, stages);
}

extern "C" int spidr_fused_lif_gemm_int_tblk_tile_smem(int K) {
  return BN * (tile_chunk(K) / 4 + 4) * int(sizeof(int32_t));
}

// route 1: the ring kernel on grid_x blocks per slab with `stages` stages
// (s and v 16-byte aligned); route 0: the tile loop, any fan-in (grid_x,
// stages unused; B1 beyond its ring launches it with T = 1).  thr: (N,)
// int32, or null for the scalar thr_scalar.
extern "C" int spidr_fused_lif_gemm_int_tblk(const void* s, const void* w,
                                             const void* v, const void* thr,
                                             int thr_scalar, void* v_out,
                                             void* s_out, int T, int M, int K,
                                             int N, int leak_shift,
                                             int soft_reset, int v_min,
                                             int v_max, int skip_empty,
                                             int route, int grid_x, int stages,
                                             void* stream) {
  if (T <= 0 || M <= 0 || K <= 0 || N <= 0 || route < 0 || route > 1)
    return int(cudaErrorInvalidValue);
  const Epilogue e{leak_shift, soft_reset, v_min, v_max};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const int smem = tblk_smem(K, N, stages);
    if (grid_x <= 0 || stages < 2 || stages > TBLK_MAX_STAGES ||
        smem > TC_SMEM_MAX ||
        (reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
      return int(cudaErrorInvalidValue);
    const int nt = N >= TC_NB ? 4 : (N + 7) / 8;
    const bool ldsm = K % 16 == 0;
    const TblkKernel kernels[4] = {tblk_kernel<1>(ldsm), tblk_kernel<2>(ldsm),
                                   tblk_kernel<3>(ldsm), tblk_kernel<4>(ldsm)};
    const TblkKernel kern = kernels[nt - 1];
    static bool smem_set[8] = {};
    const cudaError_t err = allow_smem(kern, smem_set[2 * (nt - 1) + ldsm]);
    if (err != cudaSuccess) return int(err);
    kern<<<dim3(grid_x, (N + TC_NB - 1) / TC_NB), TC_THREADS, smem, st>>>(
        static_cast<const int8_t*>(s), static_cast<const int8_t*>(w),
        static_cast<const int32_t*>(v), static_cast<const int32_t*>(thr),
        thr_scalar, static_cast<int32_t*>(v_out), static_cast<int32_t*>(s_out),
        T, M, K, N, e, stages);
    return int(cudaGetLastError());
  }
  const int smem = spidr_fused_lif_gemm_int_tblk_tile_smem(K);
  // Static and dynamic shared memory together above 48 KB need the opt-in.
  if (smem + BM * BK > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_lif_gemm_int_tblk_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  const int vec = spikes_vectorizable(s, K);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fused_lif_gemm_int_tblk_kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const int8_t*>(s), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(thr),
      thr_scalar, static_cast<int32_t*>(v_out), static_cast<int32_t*>(s_out), T,
      M, K, N, tile_chunk(K), e, skip_empty, vec);
  return int(cudaGetLastError());
}

// Dynamic shared memory of B3's ring kernel for fan-in K, N channels and
// `stages` stages (the wrapper's plan mirrors it).
extern "C" int spidr_fused_lif_gemm_f32_smem(int K, int N, int stages) {
  return f32_smem(K, N, stages);
}

// route 1: the ring kernel on grid_x blocks per slab with `stages` stages
// (s and v 16-byte aligned; skip_empty has no effect); route 0: the tile
// loop (grid_x, stages unused).
extern "C" int spidr_fused_lif_gemm_f32(const void* s, const void* w,
                                        const void* v, void* v_out,
                                        void* s_out, int M, int K, int N,
                                        float thr, float leak, int soft_reset,
                                        int skip_empty, int route, int grid_x,
                                        int stages, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || route < 0 || route > 1)
    return int(cudaErrorInvalidValue);
  if (route == 1) {
    const int smem = f32_smem(K, N, stages);
    if (grid_x <= 0 || stages < 2 || stages > F32_MAX_STAGES || smem > TC_SMEM_MAX ||
        (reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
      return int(cudaErrorInvalidValue);
    const int nt = N >= TC_NB ? 4 : (N + 7) / 8;
    const bool ldsm = K % 4 == 0;
    const F32Kernel kernels[4] = {f32_kernel<1>(ldsm), f32_kernel<2>(ldsm),
                                  f32_kernel<3>(ldsm), f32_kernel<4>(ldsm)};
    const F32Kernel kern = kernels[nt - 1];
    static bool smem_set[8] = {};
    const cudaError_t err = allow_smem(kern, smem_set[2 * (nt - 1) + ldsm]);
    if (err != cudaSuccess) return int(err);
    kern<<<dim3(grid_x, (N + TC_NB - 1) / TC_NB), F32_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(s), static_cast<const float*>(w),
        static_cast<const float*>(v), static_cast<float*>(v_out),
        static_cast<float*>(s_out), M, K, N, thr, leak, soft_reset, stages);
    return int(cudaGetLastError());
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fused_lif_gemm_f32_kernel<<<grid, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(w),
      static_cast<const float*>(v), static_cast<float*>(v_out),
      static_cast<float*>(s_out), M, K, N, thr, leak, soft_reset, skip_empty,
      (K % 4 == 0) && (reinterpret_cast<uintptr_t>(s) % 16 == 0));
  return int(cudaGetLastError());
}
