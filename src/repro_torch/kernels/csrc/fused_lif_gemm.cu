// Fused spike-GEMM + neuron update for Hopper (sm_90a).
//
// Three kernels, each replacing one Pallas TPU kernel of the JAX package:
//
//   fused_lif_gemm_int_kernel       replaces repro/kernels/fused_lif_gemm.py
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
// The threshold is always an (N,) int32 operand; the wrapper broadcasts a
// scalar, so one kernel serves the scalar and the per-channel variants.
//
// What bounds the integer kernels on this card: bytes.  Spikes are one
// byte per (m, k); Vmem in and Vmem/spikes out are four bytes per (m, n).
// At the networks' widths (K <= 288, N <= 32) an optical-flow middle
// layer at B=2 moves
// about 150 MB for about 4 GOP, some 30 ops per byte, far below the ~590
// int8 ops per byte where Hopper's tensor cores would become the limit.
// So the design reads every spike byte once, keeps the weights in shared
// memory, accumulates and runs the neuron program in registers, and writes
// v' and s once.  __dp4a on CUDA cores is enough for that arithmetic
// intensity; wgmma/TMA are later work.
//
// Differences from the TPU design:
//   * The Pallas grid revisits its output block across the k axis, which
//     is sequential only on a TPU.  Here one block owns a (BM, BN) output
//     tile and loops over K itself; blocks run in any order.
//   * Empty (BM, BK) spike tiles are skipped by a block-wide vote
//     (__syncthreads_or) instead of a reduction or a host-side bitmap.
//   * The T_blk kernel does not hold T*bm*bn accumulators: it loads the
//     block's whole (K, BN) weight slice into shared memory once, then walks
//     t in order, carrying the Vmem tile in registers across timesteps
//     (the chip's Vmem-stationary reuse).
//   * Ragged M, K and N edges are masked in-kernel; nothing is padded in
//     device memory.
// The tile loop itself (staging, __dp4a) is spike_tile.cuh, shared with
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

__global__ void __launch_bounds__(THREADS)
fused_lif_gemm_int_kernel(const int8_t* __restrict__ S,
                          const int8_t* __restrict__ W,
                          const int32_t* __restrict__ V,
                          const int32_t* __restrict__ THR,
                          int32_t* __restrict__ V_OUT,
                          int32_t* __restrict__ S_OUT, int M, int K, int N,
                          Epilogue e, int skip_empty, int vec) {
  __shared__ __align__(16) int8_t s_tile[BM * BK];
  __shared__ __align__(16) int32_t w_tile[BN * TILE_W_STRIDE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t m0 = int64_t(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  int acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int any = load_spike_tile(S, M, K, m0, k0, s_tile, vec);
    // Block-wide vote (also the barrier that publishes s_tile).
    if (__syncthreads_or(any) || !skip_empty) {
      load_weights(W, K, N, k0, BK, n0, reinterpret_cast<int8_t*>(w_tile),
                   TILE_W_STRIDE);
      __syncthreads();
      mac_tile(s_tile, w_tile, TILE_W_STRIDE, acc);
    }
    __syncthreads();  // the next tile overwrites s_tile / w_tile
  }

  const int n = n0 + lane;
  if (n >= N) return;
  const int thr = THR[n];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int64_t m = m0 + warp + i * WARPS;
    if (m < M) {
      const int64_t idx = m * N + n;
      int s;
      V_OUT[idx] = neuron(acc[i], V[idx], thr, e, s);
      S_OUT[idx] = s;
    }
  }
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
extern "C" int spidr_fused_lif_gemm_int(const void* s, const void* w,
                                        const void* v, const void* thr,
                                        void* v_out, void* s_out, int M, int K,
                                        int N, int leak_shift, int soft_reset,
                                        int v_min, int v_max, int skip_empty,
                                        void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return int(cudaErrorInvalidValue);
  const Epilogue e{leak_shift, soft_reset, v_min, v_max};
  const int vec = spikes_vectorizable(s, K);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fused_lif_gemm_int_kernel<<<grid, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(thr),
      static_cast<int32_t*>(v_out), static_cast<int32_t*>(s_out), M, K, N, e,
      skip_empty, vec);
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
