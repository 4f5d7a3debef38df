// Low-precision-weight matmul with in-kernel dequantization, for Hopper
// (sm_90a).
//
// Replaces repro/kernels/quant_matmul.py quant_matmul, both of its Pallas
// bodies: _qmm_kernel_int8 and _qmm_kernel_int4.  It computes
//
//   out[m, n] = (sum_k x[m, k] * w[k, n]) * scale[n]      fp32
//
// with x (M, K) fp32 and w either int8 (K, N) or int4 packed two to a byte
// along K, (K/2, N) uint8, even K rows in the low nibble (sign-extended).
// The products are fp32 FMAs on the CUDA cores, as the TPU kernel computes
// in f32: TF32 or bf16 tensor cores would change the numbers.  The scale is
// applied once, in the epilogue (the Pallas kernel scales each 256-row k
// partial; both agree within the reference's rtol = atol = 1e-4).
//
// What bounds it on this card: at a decode batch (M = 4) the weight bytes
// (int8: K*N, int4: K*N/2); at a prefill (M = 512) the fp32 FMAs, 2*M*K*N
// operations at 67 TFLOP/s.
//
// Design: a block owns a 64x64 output tile and loops over K in 64-deep
// tiles.  When the output tiles are too few to keep the card's memory busy
// (a decode batch: M = 4 gives 224 tiles), the wrapper splits K into
// ksplit ranges, one block per (tile, range), each writing an unscaled
// fp32 partial; a second kernel adds the partials in range order and
// scales (deterministic, no atomics).  Each thread holds a 4x4
// accumulator; x (transposed, k-major) and the dequantized weight tile sit
// in shared memory as fp32 and are read as float4s.  The next tile's x and
// packed weights are loaded into registers while the current tile is
// multiplied, so the loads overlap the FMAs; the weights cross memory at 8
// or 4 bits and become floats only in shared memory.  Ragged M, N and K
// are masked in the kernel (no padding copies); a thread whose rows all lie
// past M skips the FMAs.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 256;
constexpr int XS = BM + 4;  // shared row strides, padded, 16-byte aligned
constexpr int WS = BN + 4;

struct Staged {
  float x[16];     // 16 consecutive k of one x row
  uint8_t w[16];   // int8: 16 columns of one row; int4: 8 columns of one
                   // packed row (two k each)
};

// x tile rows m0..m0+63, k0..k0+63: thread t loads row t/4, k (t%4)*16..+15;
// k at or past kend reads as 0.
__device__ __forceinline__ void load_x(const float* __restrict__ X, int M,
                                       int K, int kend, int m0, int k0,
                                       int xvec, Staged& st) {
  const int row = threadIdx.x >> 2, kq = (threadIdx.x & 3) * 16;
  const int m = m0 + row, k = k0 + kq;
  const float* p = X + int64_t(m) * K + k;
  if (m < M && xvec && k + 16 <= kend) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 f = reinterpret_cast<const float4*>(p)[e];
      st.x[4 * e] = f.x;
      st.x[4 * e + 1] = f.y;
      st.x[4 * e + 2] = f.z;
      st.x[4 * e + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) st.x[e] = (m < M && k + e < kend) ? p[e] : 0.f;
  }
}

template <bool INT4>
__device__ __forceinline__ void load_w(const uint8_t* __restrict__ W, int kend,
                                       int N, int k0, int n0, int wvec,
                                       Staged& st) {
  if (!INT4) {  // row t/4 of the (BK, BN) tile, columns (t%4)*16..+15
    const int row = threadIdx.x >> 2, col = (threadIdx.x & 3) * 16;
    const int k = k0 + row, n = n0 + col;
    const uint8_t* p = W + int64_t(k) * N + n;
    if (k < kend && wvec && n + 16 <= N) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 16; ++e) st.w[e] = uint8_t(words[e >> 2] >> (8 * (e & 3)));
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) st.w[e] = (k < kend && n + e < N) ? p[e] : 0;
    }
  } else {  // packed row t/8 of the (BK/2, BN) tile, columns (t%8)*8..+7
    const int prow = threadIdx.x >> 3, col = (threadIdx.x & 7) * 8;
    const int kp = k0 / 2 + prow, n = n0 + col;
    const uint8_t* p = W + int64_t(kp) * N + n;
    if (kp < kend / 2 && wvec && n + 8 <= N) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      const uint32_t words[2] = {q.x, q.y};
#pragma unroll
      for (int e = 0; e < 8; ++e) st.w[e] = uint8_t(words[e >> 2] >> (8 * (e & 3)));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) st.w[e] = (kp < kend / 2 && n + e < N) ? p[e] : 0;
    }
  }
}

// Registers -> shared memory: x transposed (k-major), weights dequantized.
template <bool INT4>
__device__ __forceinline__ void store_tile(const Staged& st, float* xs,
                                           float* ws) {
  {
    const int row = threadIdx.x >> 2, kq = (threadIdx.x & 3) * 16;
#pragma unroll
    for (int e = 0; e < 16; ++e) xs[(kq + e) * XS + row] = st.x[e];
  }
  if (!INT4) {
    const int row = threadIdx.x >> 2, col = (threadIdx.x & 3) * 16;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      ws[row * WS + col + e] = float(int8_t(st.w[e]));
  } else {
    const int prow = threadIdx.x >> 3, col = (threadIdx.x & 7) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t b = st.w[e];
      // Sign-extend each nibble (arithmetic shift of the nibble moved to
      // the top): even k in the low nibble, odd k in the high one.
      ws[(2 * prow) * WS + col + e] = float(int32_t(b << 28) >> 28);
      ws[(2 * prow + 1) * WS + col + e] = float(int32_t(b << 24) >> 28);
    }
  }
}

// Block (x, y, z): output tile (y, x) over k in [z * kchunk, (z+1) * kchunk).
// With PART null the result is scaled into OUT; else the unscaled partial
// goes to PART[z] (M x N).
template <bool INT4>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const float* __restrict__ X, const uint8_t* __restrict__ W,
           const float* __restrict__ SCALE, float* __restrict__ OUT,
           float* __restrict__ PART, int M, int N, int K, int kchunk,
           int xvec, int wvec) {
  __shared__ __align__(16) float xs[BK * XS];
  __shared__ __align__(16) float ws[BK * WS];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const bool active = m0 + ty * 4 < M;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  Staged st;
  load_x(X, M, K, kend, m0, kbeg, xvec, st);
  load_w<INT4>(W, kend, N, kbeg, n0, wvec, st);
  store_tile<INT4>(st, xs, ws);
  __syncthreads();

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    const bool more = k0 + BK < kend;
    if (more) {  // the next tile, in flight during this tile's FMAs
      load_x(X, M, K, kend, m0, k0 + BK, xvec, st);
      load_w<INT4>(W, kend, N, k0 + BK, n0, wvec, st);
    }
    if (active) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk * XS + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[kk * WS + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
    if (more) {
      store_tile<INT4>(st, xs, ws);
      __syncthreads();
    }
  }

  float* dst = PART ? PART + int64_t(blockIdx.z) * M * N : OUT;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) dst[int64_t(m) * N + n] = PART ? acc[i][j] : acc[i][j] * SCALE[n];
    }
  }
}

// out[m, n] = (sum over the k ranges, in order, of the partials) * scale[n].
__global__ void __launch_bounds__(THREADS)
qmm_reduce_kernel(const float* __restrict__ PART, const float* __restrict__ SCALE,
                  float* __restrict__ OUT, int64_t MN, int N, int ksplit) {
  for (int64_t i = blockIdx.x * int64_t(THREADS) + threadIdx.x; i < MN;
       i += int64_t(gridDim.x) * THREADS) {
    float acc = 0.f;
    for (int z = 0; z < ksplit; ++z) acc += PART[z * MN + i];
    OUT[i] = acc * SCALE[i % N];
  }
}

template <bool INT4>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* part, int M, int N, int K, int ksplit, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (INT4 && K % 2 != 0) || ksplit <= 0 ||
      (ksplit > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);
  // k ranges in whole tiles; fewer ranges than asked when K is short.
  const int tiles = (K + BK - 1) / BK;
  const int kchunk = ((tiles + ksplit - 1) / ksplit) * BK;
  const int zs = (K + kchunk - 1) / kchunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int xvec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int wvec = (N % (INT4 ? 8 : 16) == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, zs);
  qmm_kernel<INT4><<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out),
      zs > 1 ? static_cast<float*>(part) : nullptr, M, N, K, kchunk, xvec, wvec);
  if (zs > 1) {
    const int64_t mn = int64_t(M) * N;
    const int blocks = int(std::min<int64_t>((mn + THREADS - 1) / THREADS, 4096));
    qmm_reduce_kernel<<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(part), static_cast<const float*>(scale),
        static_cast<float*>(out), mn, N, zs);
  }
  return int(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes); each returns cudaGetLastError() after
// the launches.  x (M, K) fp32, scale (N,) fp32, out (M, N) fp32, all
// row-major; w (K, N) int8, or (K/2, N) uint8 nibble-packed.  ksplit > 1
// splits K into that many ranges (at most one per 64-row tile) and needs
// part, an fp32 workspace of ksplit * M * N floats.
extern "C" int spidr_quant_matmul_int8(const void* x, const void* w,
                                       const void* scale, void* out,
                                       void* part, int M, int N, int K,
                                       int ksplit, void* stream) {
  return launch<false>(x, w, scale, out, part, M, N, K, ksplit, stream);
}

extern "C" int spidr_quant_matmul_int4(const void* x, const void* w,
                                       const void* scale, void* out,
                                       void* part, int M, int N, int K,
                                       int ksplit, void* stream) {
  return launch<true>(x, w, scale, out, part, M, N, K, ksplit, stream);
}
