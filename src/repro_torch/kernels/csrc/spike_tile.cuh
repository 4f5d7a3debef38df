// The int8 spike-GEMM tile loop shared by fused_lif_gemm.cu (B1, B2) and
// spike_gemm.cu (B4).
//
// One 256-thread block owns a (BM, BN) = (64, 32) output tile: lane n of
// every warp holds channel n0 + n, and warp w holds rows w, w + 8, ...,
// w + 56 (ROWS = 8 accumulators per thread).  The block walks the fan-in
// in (BM, BK) = (64, 64) spike tiles staged in shared memory; the weights
// are staged transposed, four int8 to a word, so one __dp4a adds four
// fan-in terms.  Ragged M, K and N edges are zero-filled while staging;
// nothing is padded in device memory.
#pragma once

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

// 16-byte loads of S are legal when every row starts 16-byte aligned.
inline int spikes_vectorizable(const void* s, int K) {
  return (K % 16 == 0) && (reinterpret_cast<uintptr_t>(s) % 16 == 0);
}

}  // namespace
