// Fused spike-GEMM + neuron update for Hopper (sm_90a).
//
// Three kernels, each replacing one Pallas TPU kernel of the JAX package:
//
//   lif_gemm_tc_kernel              replaces repro/kernels/fused_lif_gemm.py
//                                   fused_lif_gemm_int (_fused_int_body via
//                                   _fused_kernel_int / _fused_kernel_int_vec)
//   fused_lif_gemm_int_tblk_kernel  replaces fused_lif_gemm_int_tblk
//                                   (_tblk_int_body via _tblk_kernel_scalar /
//                                   _tblk_kernel_vec, bitmap prologue fused in)
//   fused_lif_gemm_f32_kernel       replaces fused_lif_gemm (float,
//                                   _fused_kernel_f32); see its own note below
//
// What the two integer kernels compute, for each output (m, n) and timestep:
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
// at 3.35 TB/s) for 4 GOP of products.
//
// B1, one timestep (lif_gemm_tc_kernel).  At that shape a __dp4a +
// shared-load instruction stream on the CUDA cores alone takes about as
// long as the bytes, so nothing would be left to hide the loads behind,
// and a block that loads, then multiplies, keeps little in flight.  So:
//   * Products on the int8 tensor cores (mma.sync m16n8k32, s8 x s8 ->
//     s32, exact): a warp owns 16 rows, N is covered by n8 tiles (N = 2 is
//     one tile, N = 16 two), so no lanes are spent on absent channels.
//   * A persistent grid (1 to 4 blocks of 4 warps per SM, as shared memory
//     allows) walks 64-row M tiles.  Each block loads its (K, <= 32) weight
//     slab once, transposed and zero-padded to a multiple of 32 in K, into
//     shared memory.  A fan-in whose two ring stages do not fit beside it
//     (K above ~1,350 at N = 32; the networks' K is at most 288) is refused
//     by the wrapper.
//   * A tile's spikes (64 x K bytes) and Vmem (64 x N int32) are each one
//     contiguous range of device memory: one thread moves them with 1-D
//     bulk copies (TMA, cp.async.bulk) into a ring of 2-4 shared-memory
//     stages whose full barriers (mbarrier, transaction counts) tell the
//     warps when a tile has landed.  Tiles i+1 .. i+stages-1 are in flight
//     while tile i is multiplied.
//   * The A fragments come straight from the packed rows (ldmatrix when K %
//     16 == 0, byte loads otherwise); k past K reads the next row's bytes,
//     which meet zero weights.
//   * The neuron program runs on the accumulator fragment; v' and s are
//     written once, 8-byte stores filling whole 32-byte sectors.  A scalar
//     threshold is a kernel argument (no (N,) fill per launch).
//   * skip_empty has no effect: tensor-core products of an empty tile cost
//     less than the vote that would skip them, and the bytes are read anyway.
//
// B2, T_blk (fused_lif_gemm_int_tblk_kernel), differs from the TPU design:
//   * The Pallas grid revisits its output block across the k axis, which
//     is sequential only on a TPU.  Here one block owns a (BM, BN) output
//     tile and loops over K itself; blocks run in any order.
//   * Empty (BM, BK) spike tiles are skipped by a block-wide vote
//     (__syncthreads_or) instead of a reduction or a host-side bitmap.
//   * It does not hold T*bm*bn accumulators: it loads the block's whole
//     (K, BN) weight slice into shared memory once, then walks t in order,
//     carrying the Vmem tile in registers across timesteps (the chip's
//     Vmem-stationary reuse).  __dp4a on CUDA cores; the threshold is an
//     (N,) operand (the wrapper broadcasts a scalar).
//   * Ragged M, K and N edges are masked in-kernel; nothing is padded in
//     device memory.
// Its tile loop (staging, __dp4a) is spike_tile.cuh, shared with
// spike_gemm.cu.
#include "spike_tile.cuh"

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

// ---------------------------------------------------------------------------
// B1: one integer layer-timestep on the int8 tensor cores (see the header).
// ---------------------------------------------------------------------------
constexpr int TC_BM = 64;           // rows per M tile: 4 warps x 16
constexpr int TC_THREADS = 128;
constexpr int TC_NB = 32;           // channels per block; grid.y walks slabs
constexpr int TC_MAX_STAGES = 4;
constexpr int TC_SMEM_MAX = 227 * 1024;

__host__ __device__ inline int round_up(int x, int a) { return (x + a - 1) / a * a; }

// Shared memory of lif_gemm_tc_kernel, in bytes from its base: the stages'
// full barriers in [0, 128); the weight slab, n-major, TC_NB rows of
// w_stride bytes (K padded to 32, +16 so the B-fragment loads of 8 rows x 4
// lanes hit 32 banks); then `stages` stages, each the tile's spikes (64 x K
// bytes, +32 for the last chunk's overrun) and, when the block's slab is
// all of N, its Vmem (64 x N int32).  The wrapper mirrors this (tc_smem).
struct TcLayout {
  int w_stride, w_bytes, s_bytes, stage_bytes;
  __host__ __device__ TcLayout(int K, int N)
      : w_stride(round_up(K, 32) + 16),
        w_bytes(round_up(TC_NB * w_stride, 128)),
        s_bytes(round_up(TC_BM * K + 32, 128)),
        stage_bytes(s_bytes + (N <= TC_NB ? round_up(TC_BM * N * 4, 128) : 0)) {}
  __host__ __device__ int total(int stages) const {
    return 128 + w_bytes + stages * stage_bytes;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

// Arrive once and expect `bytes` from bulk copies before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p)));
}

// c += A (16x32 s8, row) x B (32x8 s8, col), int32 and exact.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
  const TcLayout lay(K, N);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint8_t* wsm = smem + 128;
  uint8_t* ring = wsm + lay.w_bytes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.y * TC_NB, nb = min(TC_NB, N - n0);
  const bool vpre = N <= TC_NB;
  const int k_pad = round_up(K, 32);
  const int tiles = (M + TC_BM - 1) / TC_BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < stages; ++s) {
      const int tile = blockIdx.x + s * gridDim.x;
      if (tile < tiles)
        issue_tile(S, V, M, K, N, vpre, tile, ring + s * lay.stage_bytes,
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
    const uint8_t* st = ring + s * lay.stage_bytes;

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
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue_tile(S, V, M, K, N, vpre, next, ring + s * lay.stage_bytes,
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

__global__ void __launch_bounds__(THREADS)
fused_lif_gemm_int_tblk_kernel(const int8_t* __restrict__ S,
                               const int8_t* __restrict__ W,
                               const int32_t* __restrict__ V,
                               const int32_t* __restrict__ THR,
                               int32_t* __restrict__ V_OUT,
                               int32_t* __restrict__ S_OUT, int T, int M,
                               int K, int N, int k_pad, Epilogue e,
                               int skip_empty, int vec) {
  // The block's whole (k_pad, BN) weight slice, loaded once for all T.
  extern __shared__ __align__(16) int32_t w_all[];
  __shared__ __align__(16) int8_t s_tile[BM * BK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t m0 = int64_t(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int w_stride = k_pad / 4 + 4;
  const int n = n0 + lane;

  load_weights(W, K, N, 0, k_pad, n0, reinterpret_cast<int8_t*>(w_all),
               w_stride);

  // Vmem tile in registers, carried across timesteps.
  int v[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int64_t m = m0 + warp + i * WARPS;
    v[i] = (m < M && n < N) ? V[m * N + n] : 0;
  }
  const int thr = n < N ? THR[n] : 0;
  __syncthreads();  // w_all complete

  const int64_t plane_s = int64_t(M) * K, plane_v = int64_t(M) * N;
  for (int t = 0; t < T; ++t) {
    const int8_t* St = S + t * plane_s;
    int acc[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) acc[i] = 0;
    for (int k0 = 0; k0 < K; k0 += BK) {
      const int any = load_spike_tile(St, M, K, m0, k0, s_tile, vec);
      if (__syncthreads_or(any) || !skip_empty)
        mac_tile(s_tile, w_all + k0 / 4, w_stride, acc);
      __syncthreads();
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
// (m, k): at the optical-flow middle shape the spike matrix alone is 255 MB
// against ~4 GFLOP if every product were taken, ~12 flop per byte, below
// the ~20 flop per byte where the CUDA cores' fp32 rate (67 TFLOP/s) would
// become the limit.  So the design reads each spike once, as B1 does: a
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

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes).  Each launcher returns cudaGetLastError()
// right after the launch, so a refused launch reaches the wrapper as an error.
// ---------------------------------------------------------------------------
// Dynamic shared memory B1 needs for fan-in K, N channels and `stages`
// ring stages (the wrapper's plan mirrors it and checks it against this).
extern "C" int spidr_fused_lif_gemm_int_smem(int K, int N, int stages) {
  return TcLayout(K, N).total(stages);
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
  const int smem = TcLayout(K, N).total(stages);
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
  bool& set = smem_set[2 * (nt - 1) + ldsm];
  if (!set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_MAX);
    if (err != cudaSuccess) return int(err);
    set = true;
  }
  const Epilogue e{leak_shift, soft_reset, v_min, v_max};
  kern<<<dim3(grid_x, (N + TC_NB - 1) / TC_NB), TC_THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(thr),
      thr_scalar, static_cast<int32_t*>(v_out), static_cast<int32_t*>(s_out), M,
      K, N, e, stages);
  return int(cudaGetLastError());
}

// Dynamic shared memory the T_blk kernel needs for fan-in K (the weight
// slice); the wrapper checks it against the card's limit before launching.
extern "C" int spidr_fused_lif_gemm_int_tblk_smem(int K) {
  const int k_pad = (K + BK - 1) / BK * BK;
  return BN * (k_pad / 4 + 4) * int(sizeof(int32_t));
}

extern "C" int spidr_fused_lif_gemm_int_tblk(const void* s, const void* w,
                                             const void* v, const void* thr,
                                             void* v_out, void* s_out, int T,
                                             int M, int K, int N,
                                             int leak_shift, int soft_reset,
                                             int v_min, int v_max,
                                             int skip_empty, void* stream) {
  if (T <= 0 || M <= 0 || K <= 0 || N <= 0) return int(cudaErrorInvalidValue);
  const Epilogue e{leak_shift, soft_reset, v_min, v_max};
  const int k_pad = (K + BK - 1) / BK * BK;
  const int smem = spidr_fused_lif_gemm_int_tblk_smem(K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_lif_gemm_int_tblk_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  const int vec = spikes_vectorizable(s, K);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fused_lif_gemm_int_tblk_kernel<<<grid, THREADS, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(thr),
      static_cast<int32_t*>(v_out), static_cast<int32_t*>(s_out), T, M, K, N,
      k_pad, e, skip_empty, vec);
  return int(cudaGetLastError());
}

extern "C" int spidr_fused_lif_gemm_f32(const void* s, const void* w,
                                        const void* v, void* v_out,
                                        void* s_out, int M, int K, int N,
                                        float thr, float leak, int soft_reset,
                                        int skip_empty, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return int(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fused_lif_gemm_f32_kernel<<<grid, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(w),
      static_cast<const float*>(v), static_cast<float*>(v_out),
      static_cast<float*>(s_out), M, K, N, thr, leak, soft_reset, skip_empty,
      (K % 4 == 0) && (reinterpret_cast<uintptr_t>(s) % 16 == 0));
  return int(cudaGetLastError());
}
