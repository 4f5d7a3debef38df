// Low-precision-weight matmul with in-kernel dequantization, for Hopper
// (sm_90a).
//
// Replaces repro/kernels/quant_matmul.py quant_matmul (the pallas_call at
// :123), both of its Pallas bodies: _qmm_kernel_int8 and _qmm_kernel_int4.
// It computes
//
//   out[m, n] = (sum_k x[m, k] * w[k, n]) * scale[n]      fp32
//
// with x (M, K) fp32 and w either int8 (K, N) or int4 packed two to a byte
// along K, (K/2, N) uint8, even K rows in the low nibble (sign-extended).
// The products are fp32 FMAs on the CUDA cores, as the TPU kernel computes
// in f32: TF32 or bf16 tensor cores would change the numbers.  Weights
// become floats only in registers, exactly (0x4B0000xx is 2^23 + xx as a
// float: one byte permute and one subtraction per weight).  The scale is
// applied once, in the epilogue.  Every sum is taken in a fixed order, so a
// result is the same from run to run.
//
// Two kernels, one per regime; the wrapper (kernels/quant_matmul.py,
// plan()) picks one from the shape:
//
// Decode, M <= 16 (qmm_decode_kernel).  Bound by the weight bytes (int8:
// K*N, int4: K*N/2; 59 / 29 MB at the rwkv6-7b channel-mix shape against
// 64 KB of x).  The kernel's one job is to keep HBM busy reading the
// weights once, which under load takes ~100 KB in flight per SM; a tile of
// 64 output rows, 60 of them empty, would spend its shared memory and
// barriers on nothing.  So:
//   * Lanes run along N with 16-, 8- or 4-byte copies (coalesced); each
//     thread holds an MT x CPT = 64 fp32 accumulator (MT = 4, 8 or 16 rows
//     of x, CPT = 16, 8 or 4 columns), so a block covers 32*CPT columns.
//   * Each warp streams its own load groups (64 weight bytes per thread,
//     and the group's x, k-major) through a 4-stage cp.async ring in
//     shared memory: 3 groups in flight per thread, 96 KB per SM, no
//     registers spent on them and no block barrier in the loop.
//   * Weights become floats in registers only; x is read as broadcast
//     float4s, shared by the lane's columns.
//   * The 8 warps of a block split its k range; their partials are added
//     in shared memory in warp order.  When the column blocks are too few
//     to fill the card, K is also split across up to 8 blocks that form a
//     thread-block cluster: each adds the blocks' sums for a slice of the
//     outputs in rank order through distributed shared memory.  No second
//     pass, no atomics.
// At M = 4 the kernel issues ~6 instructions per weight (4 FMAs, a byte
// permute and a subtraction), so int4, with half the bytes of int8 for
// the same weights, is bound by issue rather than by bytes.
//
// Tiled, M > 16 (qmm_tiled_kernel).  Bound by the fp32 FMAs (2*M*K*N at
// 67 TFLOP/s: 0.90 ms at M = 512).  A block of 256 threads owns a 128x128
// output tile, each thread an 8x8 register tile; k steps of 16 are staged
// in double-buffered shared memory (x transposed to k-major, the weights
// dequantized once on their way in), so a thread does 16 FMAs per 16-byte
// shared load, and the next step's x and packed weights are loaded into
// registers while the current step is multiplied: one barrier per step.
// One such block keeps an SM's FMA pipes busy, so at M = 512 the 448 tiles
// take 4 tile-times on 132 SMs where the work is 3.39.  The grid is one
// block per tile all the same: a persistent grid that evens the work out
// needs registers this tile does not have (its tiles ran ~15 % slower).
//
// Ragged M, N and K are masked in both kernels (no padding copies).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "smem_optin.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;

// Byte b of u, whose bytes each hold a signed int8 XOR 0x80, as a float.
__device__ __forceinline__ float dq8(uint32_t u, int b) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | b)) - 8388736.0f;
}

// Byte b of u, whose bytes each hold a signed nibble XOR 8, as a float.
__device__ __forceinline__ float dq4(uint32_t u, int b) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | b)) - 8388616.0f;
}

// ---------------------------------------------------------------------------
// Decode regime.
// ---------------------------------------------------------------------------
constexpr int ACC = 64;          // accumulators per thread: MT x CPT
constexpr int GROUP_BYTES = 64;  // weight bytes per thread per load group
constexpr int STAGES = 4;        // ring stages per warp: 3 groups in flight
constexpr int RED_STRIDE = 33;   // padded lane stride of the warp partials
constexpr int MAX_CLUSTER = 8;   // K ranges per column block (portable cluster)

template <bool INT4, int MT>
struct Decode {
  static constexpr int CPT = ACC / MT;          // columns per thread
  static constexpr int U = GROUP_BYTES / CPT;   // weight rows per group
  static constexpr int KPR = INT4 ? 2 : 1;      // k per weight row
  static constexpr int BN = 32 * CPT;           // columns per block
  static constexpr int XG = U * KPR * MT;       // x floats per group
  // A warp's stage: the group's x (k-major, MT floats per k), then its
  // weights, row u's 32 x CPT bytes contiguous.
  static constexpr int STAGE = XG * 4 + U * 32 * CPT;
  static constexpr int RING = WARPS * STAGES * STAGE;
  static constexpr int RED = WARPS * ACC * RED_STRIDE * 4;  // aliases the ring
  static constexpr int PART = MT * BN * 4;                  // the block's sum
  static constexpr int SMEM = (RING > RED ? RING : RED) + PART;
};

template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src),
                 "n"(B) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int CPT>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&w)[CPT / 4]) {
  if constexpr (CPT == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else if constexpr (CPT == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    w[0] = q.x; w[1] = q.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// Start the copies of load group (weight rows r .. r+U-1) into a warp's
// ring stage: x for its k (zero past M and past the block's range, which
// ends at weight row r1), and this lane's CPT columns at n of each row
// (zero past r1 and N).  Without vec (ragged N, misaligned W) the weight
// bytes are loaded and stored here.
template <bool INT4, int MT>
__device__ __forceinline__ void issue_group(const float* __restrict__ X,
                                            const uint8_t* __restrict__ W,
                                            int M, int N, int K, int r, int r1,
                                            int n, bool vec, uint8_t* stage) {
  using D = Decode<INT4, MT>;
  constexpr int CPT = D::CPT, U = D::U, KPR = D::KPR;
  const int lane = threadIdx.x & 31;
  float* xs = reinterpret_cast<float*>(stage);
  const int k0 = r * D::KPR, kend = min(K, r1 * KPR);
#pragma unroll
  for (int e0 = 0; e0 < D::XG; e0 += 32) {
    const int e = e0 + lane, m = e / (U * KPR), kk = e % (U * KPR);
    if (e < D::XG) {
      if (m < M && k0 + kk < kend)
        cp_async<4>(xs + kk * MT + m, X + int64_t(m) * K + k0 + kk);
      else
        xs[kk * MT + m] = 0.f;
    }
  }
  uint8_t* ws = stage + D::XG * 4;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int row = r + u;
    const uint8_t* p = W + int64_t(row) * N + n;
    uint8_t* dst = ws + (u * 32 + lane) * CPT;
    if (vec && row < r1) {
      cp_async<CPT>(dst, p);
    } else {
      uint32_t wd[CPT / 4];
#pragma unroll
      for (int q = 0; q < CPT / 4; ++q) {
        wd[q] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (row < r1 && n + 4 * q + b < N) wd[q] |= uint32_t(p[4 * q + b]) << (8 * b);
      }
      if constexpr (CPT == 16)
        *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      else if constexpr (CPT == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(wd[0], wd[1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = wd[0];
    }
  }
}

// Block (x, y): columns [x*BN, (x+1)*BN), weight rows (packed rows for
// int4) [y*rpb, (y+1)*rpb).  Warp w streams load groups w, w + 8, ... of U
// rows through its own ring; the blocks of one column block form a
// cluster along y and add their partials in rank order.
template <bool INT4, int MT>
__global__ void __launch_bounds__(THREADS, 2)
qmm_decode_kernel(const float* __restrict__ X, const uint8_t* __restrict__ W,
                  const float* __restrict__ SCALE, float* __restrict__ OUT, int M,
                  int N, int K, int rpb, int wvec) {
  using D = Decode<INT4, MT>;
  constexpr int CPT = D::CPT, U = D::U, KPR = D::KPR, BN = D::BN;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem) + warp * STAGES * D::STAGE;
  const int r0 = blockIdx.y * rpb, r1 = min(K / KPR, r0 + rpb);
  const int n = blockIdx.x * BN + lane * CPT;
  const int ngroups = (r1 - r0 + U - 1) / U;
  const bool vec = wvec && n < N;  // wvec: N % CPT == 0, W 16-byte aligned

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    const int g = warp + i * WARPS;
    if (g < ngroups)
      issue_group<INT4, MT>(X, W, M, N, K, r0 + g * U, r1, n, vec, ring + i * D::STAGE);
    cp_async_commit();
  }

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[m][j] = 0.f;

  for (int i = 0;; ++i) {
    const int g = warp + i * WARPS;
    if (g >= ngroups) break;
    __syncwarp();  // every lane is done with the stage refilled next
    const int ahead = g + (STAGES - 1) * WARPS;
    if (ahead < ngroups)
      issue_group<INT4, MT>(X, W, M, N, K, r0 + ahead * U, r1, n, vec,
                            ring + ((i + STAGES - 1) % STAGES) * D::STAGE);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // group g has landed ...
    __syncwarp();                 // ... for every lane
    const uint8_t* stage = ring + (i % STAGES) * D::STAGE;
    const float* xs = reinterpret_cast<const float*>(stage);
    const uint8_t* ws = stage + D::XG * 4;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint32_t wv[CPT / 4];
      load_words<CPT>(ws + (u * 32 + lane) * CPT, wv);
      float xa[KPR][MT];
#pragma unroll
      for (int h = 0; h < KPR; ++h)
#pragma unroll
        for (int m4 = 0; m4 < MT / 4; ++m4) {
          const float4 f = reinterpret_cast<const float4*>(xs + (u * KPR + h) * MT)[m4];
          xa[h][4 * m4] = f.x; xa[h][4 * m4 + 1] = f.y;
          xa[h][4 * m4 + 2] = f.z; xa[h][4 * m4 + 3] = f.w;
        }
#pragma unroll
      for (int q = 0; q < CPT / 4; ++q) {
        if constexpr (!INT4) {
          const uint32_t wu = wv[q] ^ 0x80808080u;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float wf = dq8(wu, b);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][4 * q + b] = fmaf(xa[0][m], wf, acc[m][4 * q + b]);
          }
        } else {
          const uint32_t wu = wv[q] ^ 0x88888888u;
          const uint32_t lo = wu & 0x0F0F0F0Fu, hi = (wu >> 4) & 0x0F0F0F0Fu;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float wl = dq4(lo, b), wh = dq4(hi, b);  // k even, k odd
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              acc[m][4 * q + b] = fmaf(xa[0][m], wl, acc[m][4 * q + b]);
              acc[m][4 * q + b] = fmaf(xa[1][m], wh, acc[m][4 * q + b]);
            }
          }
        }
      }
    }
  }

  // The warps' partials, added in warp order into the block's sum part[m *
  // BN + c]; then each block of the cluster finishes a slice of the
  // outputs, adding the blocks' sums in rank order.
  cp_async_wait<0>();
  __syncthreads();  // the rings are no longer read
  float* red = smem;
  float* part = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(smem) +
                                         (D::RING > D::RED ? D::RING : D::RED));
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      red[(warp * ACC + m * CPT + j) * RED_STRIDE + lane] = acc[m][j];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MT * BN / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS, c = idx % BN;
    const int slot = (idx / BN) * CPT + c % CPT, src = c / CPT;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[(w * ACC + slot) * RED_STRIDE + src];
    part[idx] = sum;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's sum is complete
  const int ranks = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int slice = (MT * BN + ranks - 1) / ranks;
  for (int idx = rank * slice + threadIdx.x; idx < min(MT * BN, (rank + 1) * slice);
       idx += THREADS) {
    float sum = 0.f;
    for (int q = 0; q < ranks; ++q) sum += cluster.map_shared_rank(part, q)[idx];
    const int m = idx / BN, col = blockIdx.x * BN + idx % BN;
    if (m < M && col < N) OUT[int64_t(m) * N + col] = sum * SCALE[col];
  }
  cluster.sync();  // no block leaves while another reads its sum
}

// ---------------------------------------------------------------------------
// Tiled regime.
// ---------------------------------------------------------------------------
constexpr int TBM = 128, TBN = 128, TBK = 16;
constexpr int AS = TBM + 4;  // k-major x tile row stride (floats)

struct Staged {
  float4 x[2];     // x rows f/4, k (f%4)*4..+3 for f = tid, tid + 256
  uint32_t w[2];   // int8: 8 bytes of row tid/16; int4: 4 bytes (w[0]) of
                   // packed row tid/32
};

template <bool INT4>
__device__ __forceinline__ void load_step(const float* __restrict__ X,
                                          const uint8_t* __restrict__ W,
                                          int M, int N, int K, int m0, int n0,
                                          int k0, int xvec, int wvec,
                                          Staged& st) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f = threadIdx.x + j * THREADS;
    const int m = m0 + (f >> 2), k = k0 + (f & 3) * 4;
    const float* p = X + int64_t(m) * K + k;
    if (xvec && m < M && k < K) {  // K % 4 == 0: all four in range
      st.x[j] = *reinterpret_cast<const float4*>(p);
    } else {
      st.x[j].x = (m < M && k < K) ? p[0] : 0.f;
      st.x[j].y = (m < M && k + 1 < K) ? p[1] : 0.f;
      st.x[j].z = (m < M && k + 2 < K) ? p[2] : 0.f;
      st.x[j].w = (m < M && k + 3 < K) ? p[3] : 0.f;
    }
  }
  if (!INT4) {
    const int k = k0 + (threadIdx.x >> 4), n = n0 + (threadIdx.x & 15) * 8;
    const uint8_t* p = W + int64_t(k) * N + n;
    if (wvec && k < K && n + 8 <= N) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      st.w[0] = q.x;
      st.w[1] = q.y;
    } else {
      st.w[0] = st.w[1] = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (k < K && n + e < N) st.w[e >> 2] |= uint32_t(p[e]) << (8 * (e & 3));
    }
  } else {
    const int kp = k0 / 2 + (threadIdx.x >> 5), n = n0 + (threadIdx.x & 31) * 4;
    const uint8_t* p = W + int64_t(kp) * N + n;
    if (wvec && kp < K / 2 && n + 4 <= N) {
      st.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      st.w[0] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kp < K / 2 && n + e < N) st.w[0] |= uint32_t(p[e]) << (8 * e);
    }
  }
}

// Registers -> shared memory: x transposed, weights dequantized.
template <bool INT4>
__device__ __forceinline__ void store_step(const Staged& st, float (*as)[AS],
                                           float (*bs)[TBN]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int f = threadIdx.x + j * THREADS;
    const int row = f >> 2, kq = (f & 3) * 4;
    as[kq][row] = st.x[j].x;
    as[kq + 1][row] = st.x[j].y;
    as[kq + 2][row] = st.x[j].z;
    as[kq + 3][row] = st.x[j].w;
  }
  if (!INT4) {
    const int k = threadIdx.x >> 4, c = (threadIdx.x & 15) * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t u = st.w[h] ^ 0x80808080u;
      *reinterpret_cast<float4*>(&bs[k][c + 4 * h]) =
          make_float4(dq8(u, 0), dq8(u, 1), dq8(u, 2), dq8(u, 3));
    }
  } else {
    const int kp = threadIdx.x >> 5, c = (threadIdx.x & 31) * 4;
    const uint32_t u = st.w[0] ^ 0x88888888u;
    const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
    *reinterpret_cast<float4*>(&bs[2 * kp][c]) =
        make_float4(dq4(lo, 0), dq4(lo, 1), dq4(lo, 2), dq4(lo, 3));
    *reinterpret_cast<float4*>(&bs[2 * kp + 1][c]) =
        make_float4(dq4(hi, 0), dq4(hi, 1), dq4(hi, 2), dq4(hi, 3));
  }
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}.
template <bool INT4>
__global__ void __launch_bounds__(THREADS, 2)
qmm_tiled_kernel(const float* __restrict__ X, const uint8_t* __restrict__ W,
                 const float* __restrict__ SCALE, float* __restrict__ OUT, int M,
                 int N, int K, int xvec, int wvec, int ovec) {
  __shared__ __align__(16) float as[2][TBK][AS];
  __shared__ __align__(16) float bs[2][TBK][TBN];
  const int n0 = blockIdx.x * TBN, m0 = blockIdx.y * TBM;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  Staged st;
  load_step<INT4>(X, W, M, N, K, m0, n0, 0, xvec, wvec, st);
  store_step<INT4>(st, as[0], bs[0]);
  __syncthreads();

  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += TBK, buf ^= 1) {
    const bool more = k0 + TBK < K;
    if (more)  // the next step, in flight during this step's FMAs
      load_step<INT4>(X, W, M, N, K, m0, n0, k0 + TBK, xvec, wvec, st);
#pragma unroll
    for (int kk = 0; kk < TBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store_step<INT4>(st, as[buf ^ 1], bs[buf ^ 1]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + tx * 4;
      float* o = OUT + int64_t(m) * N + n;
      if (ovec && n + 4 <= N) {
        const float4 sc = *reinterpret_cast<const float4*>(SCALE + n);
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * h] * sc.x, acc[i][4 * h + 1] * sc.y,
                        acc[i][4 * h + 2] * sc.z, acc[i][4 * h + 3] * sc.w);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) o[e] = acc[i][4 * h + e] * SCALE[n + e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------
template <bool INT4, int MT>
int launch_decode(const void* x, const void* w, const void* scale, void* out,
                  int M, int N, int K, int rpb, cudaStream_t st) {
  using D = Decode<INT4, MT>;
  const int rows = K / D::KPR;
  if (M > MT || rpb <= 0 || rpb % D::U != 0) return int(cudaErrorInvalidValue);
  const int splits = (rows + rpb - 1) / rpb;
  if (splits > MAX_CLUSTER) return int(cudaErrorInvalidValue);
  static SmemOptIn smem_set;  // above 48 KB only after opting in, per device
  const cudaError_t opt_err =
      opt_in_smem(qmm_decode_kernel<INT4, MT>, D::SMEM, smem_set);
  if (opt_err != cudaSuccess) return int(opt_err);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + D::BN - 1) / D::BN, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = D::SMEM;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const int wvec = (N % D::CPT == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, qmm_decode_kernel<INT4, MT>, static_cast<const float*>(x),
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<float*>(out), M, N, K, rpb, wvec);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool INT4>
int launch(const void* x, const void* w, const void* scale, void* out, int M,
           int N, int K, int mt, int rpb, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (INT4 && K % 2 != 0))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 4: return launch_decode<INT4, 4>(x, w, scale, out, M, N, K, rpb, st);
    case 8: return launch_decode<INT4, 8>(x, w, scale, out, M, N, K, rpb, st);
    case 16: return launch_decode<INT4, 16>(x, w, scale, out, M, N, K, rpb, st);
    case 0: break;
    default: return int(cudaErrorInvalidValue);
  }
  const int xvec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int wvec = (N % (INT4 ? 4 : 8) == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % (INT4 ? 4 : 8) == 0);
  // float4 epilogue: N % 4 == 0, scale and out 16-byte aligned.
  const int ovec = (N % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(scale) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  const dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  qmm_tiled_kernel<INT4><<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), M, N, K, xvec,
      wvec, ovec);
  return int(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes); each returns the first error of the
// launch.  x (M, K) fp32, scale (N,) fp32, out (M, N) fp32, all row-major;
// w (K, N) int8, or (K/2, N) uint8 nibble-packed.  mt = 4, 8 or 16 (>= M)
// runs the decode kernel over weight rows (packed rows for int4) in blocks
// of rpb (at most 8 blocks); mt = 0 the tiled kernel (rpb unused).
extern "C" int spidr_quant_matmul_int8(const void* x, const void* w,
                                       const void* scale, void* out, int M,
                                       int N, int K, int mt, int rpb,
                                       void* stream) {
  return launch<false>(x, w, scale, out, M, N, K, mt, rpb, stream);
}

extern "C" int spidr_quant_matmul_int4(const void* x, const void* w,
                                       const void* scale, void* out, int M,
                                       int N, int K, int mt, int rpb,
                                       void* stream) {
  return launch<true>(x, w, scale, out, M, N, K, mt, rpb, stream);
}
