// Spike-driven GEMM with tile-level zero-skipping for Hopper (sm_90a).
//
// Replaces repro/kernels/spike_gemm.py spike_gemm, all three of its Pallas
// bodies: _spike_gemm_kernel (skip decided by an in-kernel reduction over
// the loaded tile), _spike_gemm_bitmap_kernel (skip read from a per-tile
// bitmap operand) and _dense_kernel (no skip).  It computes the compute
// macro's partial Vmems
//
//   out[m, n] = sum_k S[m, k] * W[k, n]     S in {0,1} int8, W int8, out int32
//
// with no saturation: the caller saturates (the unfused layer step is
// lif_step_fused_int(v, saturate(spike_gemm(S, W)))).
//
// What bounds it on this card: bytes.  One byte per spike in, four bytes
// per output out; at the networks' widths (K <= 288, N <= 32) that is far
// below the int8 ops per byte where the tensor cores would matter.  So the
// kernel is B1's tile loop (spike_tile.cuh: 64x32 output tile per block,
// 64-byte fan-in tiles, __dp4a) with an int32 store in place of the neuron
// epilogue: every spike byte is read once, every output written once.
//
// skip_mode, all bit-identical:
//   0 dense   every tile is multiplied;
//   1 reduce  each staged spike tile is voted on with __syncthreads_or, and
//             an empty one issues no weight load and no __dp4a;
//   2 bitmap  the block reads one int32 flag per (BM, BK) tile from a
//             bitmap made by the wrapper (spike_tile_bitmap at the CUDA
//             tile, bm=64, bk=64) and an empty tile is not even loaded.
#include "spike_tile.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
spike_gemm_kernel(const int8_t* __restrict__ S, const int8_t* __restrict__ W,
                  const int32_t* __restrict__ BITMAP,
                  int32_t* __restrict__ OUT, int M, int K, int N,
                  int skip_mode, int vec) {
  __shared__ __align__(16) int8_t s_tile[BM * BK];
  __shared__ __align__(16) int32_t w_tile[BN * TILE_W_STRIDE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t m0 = int64_t(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int gk = (K + BK - 1) / BK;

  int acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // The flag is the same for the whole block: a uniform branch.
    if (skip_mode == 2 && BITMAP[int64_t(blockIdx.x) * gk + k0 / BK] == 0)
      continue;
    const int any = load_spike_tile(S, M, K, m0, k0, s_tile, vec);
    if (__syncthreads_or(any) || skip_mode != 1) {
      load_weights(W, K, N, k0, BK, n0, reinterpret_cast<int8_t*>(w_tile),
                   TILE_W_STRIDE);
      __syncthreads();
      mac_tile(s_tile, w_tile, TILE_W_STRIDE, acc);
    }
    __syncthreads();  // the next tile overwrites s_tile / w_tile
  }

  const int n = n0 + lane;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int64_t m = m0 + warp + i * WARPS;
    if (m < M) OUT[m * N + n] = acc[i];
  }
}

}  // namespace

// C interface (loaded with ctypes); returns cudaGetLastError() after the
// launch.  bitmap may be null unless skip_mode == 2, where it holds
// ceil(M/64) x ceil(K/64) int32 flags, row-major.
extern "C" int spidr_spike_gemm(const void* s, const void* w,
                                const void* bitmap, void* out, int M, int K,
                                int N, int skip_mode, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || skip_mode < 0 || skip_mode > 2 ||
      (skip_mode == 2 && bitmap == nullptr))
    return int(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  spike_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(s), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bitmap), static_cast<int32_t*>(out), M, K,
      N, skip_mode, spikes_vectorizable(s, K));
  return int(cudaGetLastError());
}

