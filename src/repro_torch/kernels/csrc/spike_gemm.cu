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
// below the int8 ops per byte where the tensor cores would matter.  At the
// optical-flow middle layer (221184, 288, 32) that is 92 MB, 0.0275 ms at
// 3.35 TB/s.
//
// spike_gemm_tc_kernel is B1 without Vmem and without the neuron program,
// on the tensor-core ring of tc_ring.cuh: a persistent grid of 64-row M
// tiles, the block's weight slab resident in shared memory, each tile's
// 64 x K spikes streamed by one bulk copy into a ring of up to 8 stages
// (a stage holds spikes only), mma.sync m16n8k32 products, and the int32
// accumulator written unsaturated by 8-byte fragment stores.  The wrapper's
// plan picks the grid and the stages.
//
// skip_mode, all bit-identical:
//   0 dense   every tile is multiplied;
//   1 reduce  on the ring, the same as dense: a vote over a staged tile
//             needs its bytes in shared memory anyway, and its tensor-core
//             products cost less than the vote, so every tile is
//             multiplied (as B1 does).  In the tile loop below, each staged
//             (64, 64) tile is voted on with __syncthreads_or and an empty
//             one issues no weight load and no __dp4a;
//   2 bitmap  one int32 flag per (64, 32) spike tile -- the ring's M tile by
//             one mma's fan-in, made by the wrapper with spike_tile_bitmap
//             at CUDA_TILE (64, 32, 32) -- is read before the tile is
//             loaded.  On the ring, a 64-row tile whose flags are all zero
//             is neither copied nor multiplied, and its output rows are
//             written as zeros; the tile loop skips a (64, 64) tile whose
//             two flags are zero.
//
// A fan-in whose two ring stages do not fit in a block's shared memory
// (K above ~1,400 at N = 32) takes spike_gemm_kernel, the first design:
// one 256-thread block per (64, 32) output tile, (64, 64) spike tiles
// staged by the block, __dp4a on the CUDA cores (spike_tile.cuh).  The plan
// routes by shape before launching, so every fan-in is taken.
#include "spike_tile.cuh"
#include "tc_ring.cuh"

namespace {

constexpr int RING_MAX_STAGES = 8;  // full barriers at [0, 64), live words at [64, 96)
constexpr int RING_SLACK = 32;

// Shared memory of the ring kernel: barriers and per-stage live words, the
// weight slab, the stages.  Mirrored by the wrapper.
inline int ring_smem(int K, int N, int stages) {
  const TcLayout lay(K, N, RING_SLACK);
  return TC_BARRIER_BYTES + lay.w_bytes + stages * lay.s_bytes;
}

// Warp 0 (all lanes): start the block's j-th tile (blockIdx.x + j *
// gridDim.x) into its stage.  With a bitmap, warp 0 holds the liveness of 32
// of the block's tiles at a time as a ballot (one load round trip per 32
// tiles); a dead tile gets no copy, and the stage's phase completes on the
// arrival alone.  live[stage] tells the consumers which it was.
__device__ __forceinline__ void ring_issue(const int8_t* S, const int32_t* BITMAP,
                                           int M, int K, int tiles, int j,
                                           int stages, uint8_t* ring, int s_bytes,
                                           uint64_t* full, int* live,
                                           uint32_t& mask) {
  const int lane = threadIdx.x & 31;
  if (BITMAP != nullptr && (j & 31) == 0) {
    const int tile = blockIdx.x + (j + lane) * gridDim.x;
    const int kb = (K + 31) / 32;
    int any = 0;
    if (tile < tiles)
      for (int f = 0; f < kb; ++f) any |= BITMAP[int64_t(tile) * kb + f];
    mask = __ballot_sync(0xffffffffu, any != 0);
  }
  if (lane != 0) return;
  const int tile = blockIdx.x + j * gridDim.x;
  const int s = j % stages;
  const bool on = BITMAP == nullptr || ((mask >> (j & 31)) & 1);
  live[s] = on;
  const int64_t m0 = int64_t(tile) * TC_BM;
  issue_spans(&full[s],
              Span{ring + s * s_bytes, reinterpret_cast<const uint8_t*>(S + m0 * K),
                   on ? tile_rows(M, tile) * K : 0u},
              Span{nullptr, nullptr, 0u});
}

// Block (x, y) walks M tiles x, x + gridDim.x, ... for channels
// [32y, 32y + 32).  NT n8 tiles cover the slab; LDSM: K % 16 == 0.
template <int NT, bool LDSM>
__global__ void __launch_bounds__(TC_THREADS)
spike_gemm_tc_kernel(const int8_t* __restrict__ S, const int8_t* __restrict__ W,
                     const int32_t* __restrict__ BITMAP,
                     int32_t* __restrict__ OUT, int M, int K, int N, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  const TcLayout lay(K, N, RING_SLACK);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* live = reinterpret_cast<int*>(smem + 64);
  uint8_t* wsm = smem + TC_BARRIER_BYTES;
  uint8_t* ring = wsm + lay.w_bytes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.y * TC_NB;
  const int tiles = (M + TC_BM - 1) / TC_BM;
  uint32_t mask = 0;  // warp 0's liveness ballot

  if (warp == 0) {
    if (lane == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
      mbar_init_fence();
    }
    __syncwarp();
    for (int j = 0; j < stages && blockIdx.x + j * gridDim.x < tiles; ++j)
      ring_issue(S, BITMAP, M, K, tiles, j, stages, ring, lay.s_bytes, full,
                 live, mask);
  }
  load_weight_slab<NT>(W, K, N, n0, wsm, lay.w_stride);
  __syncthreads();

  const int r0 = warp * 16;
  for (int it = 0, tile = blockIdx.x; tile < tiles; ++it, tile += gridDim.x) {
    const int s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    int acc[NT][4];
    if (live[s]) {
      tile_mma<NT, LDSM>(ring + s * lay.s_bytes, K, wsm, lay.w_stride, acc);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0;
    }
    __syncthreads();  // every warp is done with stage s
    if (warp == 0 && tile + stages * gridDim.x < tiles) {
      if (lane == 0) fence_proxy_async();
      ring_issue(S, BITMAP, M, K, tiles, it + stages, stages, ring, lay.s_bytes,
                 full, live, mask);
    }

    const int64_t m0 = int64_t(tile) * TC_BM;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + r0 + g + 8 * h;
      if (m >= M) continue;
      int32_t* o = OUT + m * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + j * 8 + tig * 2;
        if (n >= N) continue;
        if ((N & 1) == 0) {  // n + 1 < N, and 8-byte aligned
          *reinterpret_cast<int2*>(o + n) = make_int2(acc[j][2 * h], acc[j][2 * h + 1]);
        } else {
          o[n] = acc[j][2 * h];
          if (n + 1 < N) o[n + 1] = acc[j][2 * h + 1];
        }
      }
    }
  }
}

using RingKernel = void (*)(const int8_t*, const int8_t*, const int32_t*,
                            int32_t*, int, int, int, int);

template <int NT>
RingKernel ring_kernel(bool ldsm) {
  return ldsm ? spike_gemm_tc_kernel<NT, true> : spike_gemm_tc_kernel<NT, false>;
}

// The tile loop for a fan-in beyond the ring (see the header).
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
  const int kb = (K + 31) / 32;  // bitmap flags per row of tiles
  const int32_t* flags = BITMAP + int64_t(blockIdx.x) * kb;

  int acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // The flags are the same for the whole block: a uniform branch.
    const int f = k0 / 32;
    if (skip_mode == 2 && (flags[f] | (f + 1 < kb ? flags[f + 1] : 0)) == 0)
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
// launch.
// Dynamic shared memory of the ring kernel (the wrapper's plan mirrors it).
extern "C" int spidr_spike_gemm_smem(int K, int N, int stages) {
  return ring_smem(K, N, stages);
}

// route 1: the ring kernel on grid_x blocks per slab with `stages` stages,
// s 16-byte aligned; route 0: the tile loop (grid_x, stages unused).  bitmap may be null unless
// skip_mode == 2, where it holds ceil(M/64) x ceil(K/32) int32 flags,
// row-major (spike_tile_bitmap at CUDA_TILE).
extern "C" int spidr_spike_gemm(const void* s, const void* w,
                                const void* bitmap, void* out, int M, int K,
                                int N, int skip_mode, int route, int grid_x,
                                int stages, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || skip_mode < 0 || skip_mode > 2 ||
      route < 0 || route > 1 || (skip_mode == 2 && bitmap == nullptr))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* flags = skip_mode == 2 ? static_cast<const int32_t*>(bitmap)
                                        : nullptr;
  if (route == 1) {
    const int smem = ring_smem(K, N, stages);
    if (grid_x <= 0 || stages < 2 || stages > RING_MAX_STAGES ||
        smem > TC_SMEM_MAX || reinterpret_cast<uintptr_t>(s) % 16 != 0)
      return int(cudaErrorInvalidValue);
    const int nt = N >= TC_NB ? 4 : (N + 7) / 8;
    const bool ldsm = K % 16 == 0;
    const RingKernel kernels[4] = {ring_kernel<1>(ldsm), ring_kernel<2>(ldsm),
                                   ring_kernel<3>(ldsm), ring_kernel<4>(ldsm)};
    const RingKernel kern = kernels[nt - 1];
    static SmemOptIn smem_set[8];
    const cudaError_t err = allow_smem(kern, smem_set[2 * (nt - 1) + ldsm]);
    if (err != cudaSuccess) return int(err);
    kern<<<dim3(grid_x, (N + TC_NB - 1) / TC_NB), TC_THREADS, smem, st>>>(
        static_cast<const int8_t*>(s), static_cast<const int8_t*>(w), flags,
        static_cast<int32_t*>(out), M, K, N, stages);
    return int(cudaGetLastError());
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  spike_gemm_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(s), static_cast<const int8_t*>(w), flags,
      static_cast<int32_t*>(out), M, K, N, skip_mode, spikes_vectorizable(s, K));
  return int(cudaGetLastError());
}
