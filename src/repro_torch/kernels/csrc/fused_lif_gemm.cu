// Fused integer spike-GEMM + neuron update for Hopper (sm_90a).
//
// Two kernels, each replacing one Pallas TPU kernel of the JAX package:
//
//   fused_lif_gemm_int_kernel       replaces repro/kernels/fused_lif_gemm.py
//                                   fused_lif_gemm_int (_fused_int_body via
//                                   _fused_kernel_int / _fused_kernel_int_vec)
//   fused_lif_gemm_int_tblk_kernel  replaces fused_lif_gemm_int_tblk
//                                   (_tblk_int_body via _tblk_kernel_scalar /
//                                   _tblk_kernel_vec, bitmap prologue fused in)
//
// What they compute, for each output (m, n) and timestep:
//   acc      = sum_k S[m,k] * W[k,n]                  (int32, exact)
//   partial  = clip(acc, v_min, v_max)                (clipped once, before the add)
//   v        = v - (v >> leak_shift)  if leak_shift > 0   (arithmetic shift)
//   v        = clip(v + partial, v_min, v_max)
//   s        = v >= thr[n]
//   v'       = soft ? clip(v - s*thr[n], v_min, v_max) : v*(1-s)   (hard: unclipped)
// The threshold is always an (N,) int32 operand; the wrapper broadcasts a
// scalar, so one kernel serves the scalar and the per-channel variants.
//
// What bounds them on this card: bytes.  Spikes are one byte per (m, k);
// Vmem in and Vmem/spikes out are four bytes per (m, n).  At the networks'
// widths (K <= 288, N <= 32) an optical-flow middle layer at B=2 moves
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                    // output rows per block
constexpr int BN = 32;                    // output channels per block: one per lane
constexpr int BK = 64;                    // fan-in bytes per staged spike tile
constexpr int THREADS = 256;              // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = BM / WARPS;          // rows per thread (row = warp + i*WARPS)
constexpr int TILE_W_STRIDE = BK / 4 + 4; // words per channel row of a weight tile;
                                          // the +4 keeps 16-byte loads conflict-free

struct Epilogue {
  int leak_shift;
  int soft_reset;
  int v_min;
  int v_max;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Stage the (BM, BK) spike tile at (m0, k0) into shared memory, zero
// outside (M, K).  Returns whether this thread loaded any spike.
__device__ __forceinline__ int load_spike_tile(const int8_t* __restrict__ S,
                                               int M, int K, int64_t m0, int k0,
                                               int8_t* tile, int vec) {
  int any = 0;
  if (vec) {
    // K % 16 == 0 and S 16-byte aligned: one 16-byte load per thread.
    const int row = threadIdx.x >> 2, col = (threadIdx.x & 3) * 16;
    const int64_t m = m0 + row;
    const int k = k0 + col;
    int4 val = make_int4(0, 0, 0, 0);
    if (m < M && k < K) val = *reinterpret_cast<const int4*>(S + m * K + k);
    *reinterpret_cast<int4*>(tile + row * BK + col) = val;
    any = (val.x | val.y | val.z | val.w) != 0;
  } else {
#pragma unroll
    for (int j = 0; j < BM * BK / THREADS; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      const int row = idx / BK, col = idx % BK;
      const int64_t m = m0 + row;
      const int k = k0 + col;
      const int8_t b = (m < M && k < K) ? S[m * K + k] : int8_t(0);
      tile[idx] = b;
      any |= b;
    }
  }
  return any != 0;
}

// Stage W[k0:k0+rows, n0:n0+BN] transposed: channel n's fan-in bytes are
// contiguous at wb[n * stride_words * 4 + k], packed four to a word for
// __dp4a.  Entries outside (K, N) are zero.
__device__ __forceinline__ void load_weights(const int8_t* __restrict__ W,
                                             int K, int N, int k0, int rows,
                                             int n0, int8_t* wb,
                                             int stride_words) {
  for (int idx = threadIdx.x; idx < rows * BN; idx += THREADS) {
    const int k = idx / BN, n = idx % BN;
    const int gk = k0 + k, gn = n0 + n;
    wb[n * stride_words * 4 + k] =
        (gk < K && gn < N) ? W[int64_t(gk) * N + gn] : int8_t(0);
  }
}

// acc[i] += S_tile[warp + i*WARPS, :] . W_tile[:, lane] over BK fan-in.
// w points at this tile's first word in channel row 0.
__device__ __forceinline__ void mac_tile(const int8_t* tile,
                                         const int32_t* w, int stride_words,
                                         int acc[ROWS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int4* wrow = reinterpret_cast<const int4*>(w + lane * stride_words);
#pragma unroll
  for (int q = 0; q < BK / 16; ++q) {
    const int4 w4 = wrow[q];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int4 s4 =
          reinterpret_cast<const int4*>(tile + (warp + i * WARPS) * BK)[q];
      acc[i] = __dp4a(s4.x, w4.x, acc[i]);
      acc[i] = __dp4a(s4.y, w4.y, acc[i]);
      acc[i] = __dp4a(s4.z, w4.z, acc[i]);
      acc[i] = __dp4a(s4.w, w4.w, acc[i]);
    }
  }
}

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
  const int vec = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(s) % 16 == 0);
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
  const int vec = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(s) % 16 == 0);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  fused_lif_gemm_int_tblk_kernel<<<grid, THREADS, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(thr),
      static_cast<int32_t*>(v_out), static_cast<int32_t*>(s_out), T, M, K, N,
      k_pad, e, skip_empty, vec);
  return int(cudaGetLastError());
}
