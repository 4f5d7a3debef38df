// The int8 tensor-core ring shared by fused_lif_gemm.cu (B1, B2) and
// spike_gemm.cu (B4).
//
// A persistent grid of 128-thread blocks (4 warps) walks 64-row M tiles of
// an (M, K) int8 spike matrix; grid.y walks slabs of 32 output channels.
// Each block keeps its (K, <= 32) weight slab in shared memory, transposed
// and zero-padded to a multiple of 32 in K, for its whole life.  A tile's
// spikes (64 x K bytes) are one contiguous range of device memory, so one
// thread moves them with a 1-D bulk copy (TMA, cp.async.bulk) into a ring
// of shared-memory stages whose full barriers (mbarrier, transaction
// counts) tell the warps when a tile has landed.  Products run on the int8
// tensor cores (mma.sync m16n8k32, s8 x s8 -> s32, exact): a warp owns 16
// rows of the tile and NT n8 tiles cover the slab, so N = 2 costs one n8
// tile and no lanes sit on absent channels.
//
// The A fragments come straight from the packed rows (ldmatrix when
// K % 16 == 0, byte loads otherwise); k past K reads the next row's bytes,
// which meet zero weights, so a stage needs 32 bytes of slack past 64 x K.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC_BM = 64;           // rows per M tile: 4 warps x 16
constexpr int TC_THREADS = 128;
constexpr int TC_NB = 32;           // channels per block; grid.y walks slabs
constexpr int TC_SMEM_MAX = 227 * 1024;
constexpr int TC_BARRIER_BYTES = 128;  // full barriers (and per-stage words)

__host__ __device__ inline int round_up(int x, int a) { return (x + a - 1) / a * a; }

// Sizes of the parts of a ring kernel's shared memory: the weight slab,
// n-major, TC_NB rows of w_stride bytes (K padded to 32, +16 so the
// B-fragment loads of 8 rows x 4 lanes hit 32 banks); one stage's spike
// tile (64 x K bytes plus `s_slack`); and one 64 x N int32 tile of Vmem
// when one slab covers N (0 otherwise).  Each kernel lays them out
// after TC_BARRIER_BYTES of barriers; the wrappers mirror the sizes
// (kernels/_ring.py).
struct TcLayout {
  int w_stride, w_bytes, s_bytes, v_bytes;
  __host__ __device__ TcLayout(int K, int N, int s_slack)
      : w_stride(round_up(K, 32) + 16),
        w_bytes(round_up(TC_NB * w_stride, 128)),
        s_bytes(round_up(TC_BM * K + s_slack, 128)),
        v_bytes(N <= TC_NB ? round_up(TC_BM * N * 4, 128) : 0) {}
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
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

// Order this thread's generic-proxy shared-memory accesses before later
// bulk copies (async proxy) that touch the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

// A contiguous range of device memory bound for shared memory; src is
// 16-byte aligned.  bytes == 0: nothing.
struct Span {
  uint8_t* dst;
  const uint8_t* src;
  uint32_t bytes;
};

// Thread 0: copy each span's tail of under 16 bytes (the end of a tensor
// that is not a multiple of 16 bytes) by plain loads, arrive on `bar`
// expecting the bulk part of both spans, and start their bulk copies.  The
// arrival (a release) publishes the tails to the warps that wait on the
// phase; with no bytes at all the arrival alone completes it.
__device__ __forceinline__ void issue_spans(uint64_t* bar, Span a, Span b) {
  const uint32_t abulk = a.bytes & ~15u, bbulk = b.bytes & ~15u;
  for (uint32_t i = abulk; i < a.bytes; ++i) a.dst[i] = a.src[i];
  for (uint32_t i = bbulk; i < b.bytes; ++i) b.dst[i] = b.src[i];
  mbar_expect_tx(bar, abulk + bbulk);
  if (abulk) bulk_g2s(a.dst, a.src, abulk, bar);
  if (bbulk) bulk_g2s(b.dst, b.src, bbulk, bar);
}

// Rows of M tile `tile` (64, or fewer for the ragged last one).
__device__ __forceinline__ uint32_t tile_rows(int M, int tile) {
  return uint32_t(min(int64_t(TC_BM), M - int64_t(tile) * TC_BM));
}

// The block's weight slab: wsm[n * w_stride + k] = W[k, n0 + n], zero past K
// and past the slab's channels.  Eight independent loads per thread are in
// flight before their stores.
template <int NT>
__device__ __forceinline__ void load_weight_slab(const int8_t* __restrict__ W,
                                                 int K, int N, int n0,
                                                 uint8_t* wsm, int w_stride) {
  constexpr int NP = NT * 8;
  const int nb = min(TC_NB, N - n0);
  const int wtotal = round_up(K, 32) * NP;
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
      if (idx < wtotal) wsm[(idx % NP) * w_stride + idx / NP] = uint8_t(val[u]);
    }
  }
}

// acc = the warp's 16 rows of the spike tile at `st` (64 rows of K bytes)
// times the weight slab, over K padded to 32.  Fragment layout: acc[j][2h+c]
// is row warp*16 + g + 8h, column 8j + 2tig + c (g = lane / 4, tig = lane % 4).
template <int NT, bool LDSM>
__device__ __forceinline__ void tile_mma(const uint8_t* st, int K,
                                         const uint8_t* wsm, int w_stride,
                                         int (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, tig = lane & 3;
  const int k_pad = round_up(K, 32);
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
      const uint8_t* wp = wsm + (j * 8 + g) * w_stride + k0 + tig * 4;
      mma_s8(acc[j], a, *reinterpret_cast<const uint32_t*>(wp),
             *reinterpret_cast<const uint32_t*>(wp + 16));
    }
  }
}

// Launch-time plumbing: a kernel above 48 KB of dynamic shared memory needs
// the attribute once per instantiation.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kern, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_MAX);
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace
