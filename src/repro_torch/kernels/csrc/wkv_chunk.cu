// RWKV6 chunked wkv over a whole sequence, for Hopper (sm_90a).
//
// Replaces repro/kernels/wkv_chunk.py wkv_chunk (_wkv_kernel, one chunk per
// (batch, head) program) and the host-side lax.scan of wkv_sequence that
// launches it once per chunk.  Per head (head size N), for each chunk of C
// tokens, with lw the log-decay (< 0), lw_incl its running sum inside the
// chunk and lw_excl = lw_incl - lw:
//
//   y_i  = (r_i e^{lw_excl_i}) S                             inter-chunk
//        + sum_{j<i} (sum_n r_in k_jn e^{lw_excl_in - lw_incl_jn}) v_j
//        + (sum_n r_in u_n k_in) v_i                         diagonal bonus
//   S'   = e^{lw_incl_C} S + (k e^{lw_incl_C - lw_incl})^T v
//
// Every exponent is <= 0, exactly as in the reference; the pairwise decay is
// never factored into e^{lw_excl_i} e^{-lw_incl_j}, which overflows for long
// chunks.  fp32 throughout, built without fast math.
//
// What bounds it on this card: at a prefill of 512 tokens (C=32, N=64) the
// bytes (r, k, v, lw and y once, S0 and S1 once: ~44 MB at B=1, H=64) and the
// fp32 work (~0.75 MFLOP per chunk-head) each take ~13 us.  In instructions
// the C(C-1)/2 * N exponentials of the decay matrix A dominate (~32 K per
// chunk-head, each a multi-instruction expf), and a chunk is a chain of
// dependent steps (cumsum, A, y, S), so latency has to be hidden by warps and
// unrolled loops, not by more blocks.
//
// Design:
//  * One block owns one (b, h) and a slice of the value columns, and loops
//    over all chunks inside the kernel, carrying its slice of S (N x N/nsplit
//    fp32) in shared memory: one launch per layer per prefill, where the
//    reference launches once per chunk.
//  * Columns m of y and S' depend only on column m of v and S, so the
//    wrapper splits the N value columns into nsplit slices when B*H blocks
//    would leave SMs idle (B=1, H=64: 2 slices, 128 blocks on 132 SMs).  Each
//    slice recomputes A, the price of filling the card.
//  * C and N are template parameters, so every inner loop is unrolled and
//    every index is a shift; 512 threads (16 warps) hide the latency.  Each
//    dot product keeps four interleaved partial sums, added pairwise: four
//    independent chains, and rounding close to a tree reduction's.
//  * The next chunk's r, k, lw and v are loaded into registers while the
//    current chunk is computed.  Inputs are read in the model's (B, S, H, N)
//    layout and y is written in it: no host-side transposes.
//  * A: lane j of a warp owns A_ij for one row i, looping over n; a warp
//    takes the rows i and C-1-i together (i and C-1-i valid j's, C-1 in
//    all), so no lane idles on the triangle, and the last lane computes the
//    two rows' diagonal bonus.  Rows are padded to N+1 floats, so lanes that
//    read different rows at one n hit different banks.  A_ii holds the bonus
//    coefficient, so the intra term and the bonus are one sum over j <= i.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int PARTS = 4;  // interleaved partial sums per dot product

// (p0 + p1) + (p2 + p3): four interleaved partial sums, added pairwise, keep
// the rounding of a 64-term dot product near a tree reduction's and give
// the scheduler four independent chains.
__device__ __forceinline__ float sum_parts(const float (&p)[PARTS]) {
  return (p[0] + p[1]) + (p[2] + p[3]);
}

template <int C, int N>
__global__ void __launch_bounds__(THREADS)
wkv_kernel(const float* __restrict__ R, const float* __restrict__ K,
           const float* __restrict__ V, const float* __restrict__ LW,
           const float* __restrict__ U, const float* __restrict__ S0,
           float* __restrict__ Y, float* __restrict__ S1, int S, int H,
           int u_bstride, int nsplit) {
  constexpr int NP = N + 1;                              // padded row stride
  constexpr int PER = (C * N + THREADS - 1) / THREADS;  // tile elements per thread
  extern __shared__ float smem[];
  const int MS = N / nsplit;
  float* rs = smem;              // C x NP  r, then r e^{lw_excl}
  float* ks = rs + C * NP;       // C x NP  k, then k e^{lw_incl_C - lw_incl}
  float* lwi = ks + C * NP;      // C x NP  lw_incl
  float* lwe = lwi + C * NP;     // C x NP  lw, then lw_excl
  float* vs = lwe + C * NP;      // C x MS  this block's value columns
  float* as = vs + C * MS;       // C x (C+1)  A (j < i) and the bonus (j == i)
  float* ss = as + C * (C + 1);  // N x MS  this block's slice of the state
  float* us = ss + N * MS;       // N

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * MS, h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = int64_t(b) * H + h;
  const int64_t tok = int64_t(H) * N;  // stride between consecutive tokens

  for (int n = tid; n < N; n += THREADS)
    us[n] = U[int64_t(b) * u_bstride + int64_t(h) * N + n];
  for (int idx = tid; idx < N * MS; idx += THREADS)
    ss[idx] = S0[(bh * N + idx / MS) * N + m0 + idx % MS];

  // Registers holding the next chunk while this one is computed.
  float pr[PER], pk[PER], pl[PER], pv[PER];
  auto fetch = [&](int c0) {
    const int64_t base = (int64_t(b) * S + c0) * tok + int64_t(h) * N;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = tid + e * THREADS;
      if (idx < C * N) {
        const int64_t g = base + (idx / N) * tok + idx % N;
        pr[e] = R[g];
        pk[e] = K[g];
        pl[e] = LW[g];
      }
      if (idx < C * MS) pv[e] = V[base + (idx / MS) * tok + m0 + idx % MS];
    }
  };
  fetch(0);

  for (int c0 = 0; c0 < S; c0 += C) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = tid + e * THREADS;
      if (idx < C * N) {
        const int o = (idx / N) * NP + idx % N;
        rs[o] = pr[e];
        ks[o] = pk[e];
        lwe[o] = pl[e];
      }
      if (idx < C * MS) vs[idx] = pv[e];
    }
    __syncthreads();
    if (c0 + C < S) fetch(c0 + C);

    // lw_incl = cumsum(lw) down the chunk, lw_excl = lw_incl - lw.
    if (tid < N) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float x = lwe[i * NP + tid];
        acc += x;
        lwi[i * NP + tid] = acc;
        lwe[i * NP + tid] = acc - x;
      }
    }
    __syncthreads();

    // A_ij = sum_n r_in k_jn e^{lw_excl_in - lw_incl_jn} for j < i, and the
    // bonus A_ii = sum_n r_in u_n k_in: rows i1 and i2 = C-1-i1 per warp.
    for (int i1 = warp; i1 < C / 2; i1 += WARPS) {
      const int i2 = C - 1 - i1;
      for (int t = lane; t < C; t += 32) {
        if (t < C - 1) {
          const int i = t < i1 ? i1 : i2;
          const int j = t < i1 ? t : t - i1;
          float acc[PARTS] = {};
#pragma unroll
          for (int n = 0; n < N; ++n)
            acc[n % PARTS] += rs[i * NP + n] * ks[j * NP + n] *
                              expf(lwe[i * NP + n] - lwi[j * NP + n]);
          as[i * (C + 1) + j] = sum_parts(acc);
        } else {
          float d1[PARTS] = {}, d2[PARTS] = {};
#pragma unroll
          for (int n = 0; n < N; ++n) {
            d1[n % PARTS] += rs[i1 * NP + n] * us[n] * ks[i1 * NP + n];
            d2[n % PARTS] += rs[i2 * NP + n] * us[n] * ks[i2 * NP + n];
          }
          as[i1 * (C + 1) + i1] = sum_parts(d1);
          as[i2 * (C + 1) + i2] = sum_parts(d2);
        }
      }
    }
    __syncthreads();

    // r <- r e^{lw_excl}; k <- k e^{lw_incl_C - lw_incl}.
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = tid + e * THREADS;
      if (idx < C * N) {
        const int n = idx % N, o = (idx / N) * NP + n;
        rs[o] *= expf(lwe[o]);
        ks[o] *= expf(lwi[(C - 1) * NP + n] - lwi[o]);
      }
    }
    __syncthreads();

    // y = r e^{lw_excl} S + sum_{j <= i} A_ij v_j, this block's columns.
    const int64_t base = (int64_t(b) * S + c0) * tok + int64_t(h) * N;
    for (int idx = tid; idx < C * MS; idx += THREADS) {
      const int i = idx / MS, mm = idx % MS;
      float inter[PARTS] = {}, intra[PARTS] = {};
#pragma unroll
      for (int n = 0; n < N; ++n)
        inter[n % PARTS] += rs[i * NP + n] * ss[n * MS + mm];
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (j <= i) intra[j % PARTS] += as[i * (C + 1) + j] * vs[j * MS + mm];
      Y[base + i * tok + m0 + mm] = sum_parts(inter) + sum_parts(intra);
    }
    __syncthreads();  // y has read S

    // S <- e^{lw_incl_C} S + (k e^{lw_incl_C - lw_incl})^T v.
    for (int idx = tid; idx < N * MS; idx += THREADS) {
      const int n = idx / MS, mm = idx % MS;
      float acc[PARTS] = {};
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[c % PARTS] += ks[c * NP + n] * vs[c * MS + mm];
      ss[idx] = ss[idx] * expf(lwi[(C - 1) * NP + n]) + sum_parts(acc);
    }
    __syncthreads();  // the next chunk overwrites the tiles
  }

  for (int idx = tid; idx < N * MS; idx += THREADS)
    S1[(bh * N + idx / MS) * N + m0 + idx % MS] = ss[idx];
}

template <int C, int N>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* y, void* s1, int B, int S,
           int H, int u_bstride, int nsplit, cudaStream_t stream) {
  const int ms = N / nsplit;
  const size_t smem =
      sizeof(float) * (size_t(4) * C * (N + 1) + size_t(C) * ms +
                       size_t(C) * (C + 1) + size_t(N) * ms + N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<C, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid(nsplit, H, B);
  wkv_kernel<C, N><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s1), S, H, u_bstride, nsplit);
  return int(cudaGetLastError());
}

template <int C>
int launch_n(int N, const void* r, const void* k, const void* v,
             const void* lw, const void* u, const void* s0, void* y, void* s1,
             int B, int S, int H, int u_bstride, int nsplit,
             cudaStream_t stream) {
  switch (N) {
    case 8: return launch<C, 8>(r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, nsplit, stream);
    case 16: return launch<C, 16>(r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, nsplit, stream);
    case 32: return launch<C, 32>(r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, nsplit, stream);
    case 64: return launch<C, 64>(r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, nsplit, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface (loaded with ctypes); returns cudaGetLastError() after the
// launch.  r, k, v, lw, y: (B, S, H, N) fp32; s0, s1: (B, H, N, N) fp32; u
// holds N floats per head at u + b * u_bstride + h * N (u_bstride = 0 for
// a (H, N) bonus shared over the batch).  C and N are each one of 8, 16, 32
// and 64; S is a multiple of C; N is a multiple of nsplit.
extern "C" int spidr_wkv_sequence(const void* r, const void* k, const void* v,
                                  const void* lw, const void* u,
                                  const void* s0, void* y, void* s1, int B,
                                  int S, int H, int N, int C, int u_bstride,
                                  int nsplit, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || C <= 0 || S % C != 0 || nsplit <= 0 ||
      N % nsplit != 0 || u_bstride < 0 || B > 65535 || H > 65535)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return launch_n<8>(N, r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, nsplit, st);
    case 16: return launch_n<16>(N, r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, nsplit, st);
    case 32: return launch_n<32>(N, r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, nsplit, st);
    case 64: return launch_n<64>(N, r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, nsplit, st);
    default: return int(cudaErrorInvalidValue);
  }
}
