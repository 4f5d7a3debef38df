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
//   S'   = d S + k'^T v,   d = e^{lw_incl_C},   k' = k e^{lw_incl_C - lw_incl}
//
// Every exponent is <= 0, as in the reference: the pairwise decay is never
// factored through a point that makes an exponent positive (such as
// e^{lw_excl_i} e^{-lw_incl_j}, which overflows for steep decays).  fp32
// accuracy throughout, built without fast math.
//
// What bounds it on this card: at a prefill of 512 tokens (C=32, N=64) the
// bytes (r, k, v, lw and y once, S0 and S1 once: ~44 MB at B=1, H=64) take
// ~13 us, the fp32 work (~0.75 MFLOP per chunk-head) about as long.  The
// first design walked the chunks of a head in turn, six dependent phases per
// chunk, 13.3 us each (PERF.md): a latency chain, not a throughput limit.
//
// Design: only the N x N state chain S_c = d_c S_{c-1} + dS_c is serial, at
// one FMA per element per chunk; everything else is parallel over chunks.
//  * A thread-block cluster of G blocks (G <= 8) owns one (b, h); block r of
//    the cluster owns chunks [r L, r L + L) of each window of G L chunks
//    (L <= 2).  For each of its chunks a block computes the decay matrix A,
//    y's intra-chunk part and bonus, dS = k'^T v and d, and composes its
//    chunks into T = sum_c (prod_{p>c} d_p) dS_c and D = prod d_c: five
//    barrier-separated phases per chunk (loads; the lw running sum; the
//    elementwise decays; A; the products).
//  * Blocks publish T and D in shared memory; after one cluster barrier each
//    block reads its predecessors' (T, D) through distributed shared memory
//    and composes the state entering its chunks, S_in = D_q ... S_start +
//    ... (in rank order, so every block computes the same sums), then adds
//    y's inter-chunk part r'' S_in.  A second barrier keeps every block's
//    shared memory alive until all have read it.  A longer sequence runs in
//    windows, the state carried from one to the next.  One launch per
//    layer; the wrapper's plan sizes the cluster so that the grid fills the
//    card once (rwkv6-7b at B=1: 2 blocks per head, 128 blocks), since a
//    block's fixed costs are paid once per window.
//  * A is computed once per chunk, by one block, with fewer exponentials:
//    the chunk is split into sub-chunks of SUB = 8 tokens.  For i in
//    sub-chunk b and j in an earlier sub-chunk a, with R_a = lw_incl at the
//    end of sub-chunk a, e^{lw_excl_i - lw_incl_j} = e^{lw_excl_i - R_a}
//    e^{R_a - lw_incl_j}: both factors <= 1, so the cross-sub-chunk blocks of
//    A are small products (one exponential per (i, a, n) and per (j, n));
//    only pairs inside one sub-chunk keep the pairwise exponential
//    (C=32, N=64: ~16 K exponentials per chunk-head, ~72 K before), each
//    exp2 of a product (decay() below), and the work is cut into units
//    that fill whole warps.
//  * The products (A v, r' T, k'^T v, r'' S_in) run on the tensor cores:
//    mma.sync m16n8k8 TF32 with each fp32 operand split into hi + lo TF32
//    parts and three products summed in fp32 (3xTF32), fp32-level accuracy.
//    Each warp keeps T's tiles in registers across the block's chunks; y's
//    intra-chunk part goes to y and comes back for the inter-chunk part
//    (each thread reads back only what it wrote).
//  * Inputs are read in the model's (B, S, H, N) layout and y is written in
//    it: no host-side transposes.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 8;          // tokens per sub-chunk of the factored A
constexpr int LMAX = 2;         // chunks per block per window
constexpr int MAX_CLUSTER = 8;  // blocks per (b, h): a portable cluster

// Shared memory of one block, in floats; the wrapper mirrors it
// (kernels/wkv_chunk.py smem_bytes).  Row strides: N + 4 for arrays read as
// mma A operands (fragment rows g, columns t: banks 4g + t) and by the decay
// matrix's lane groups; N + 8 for B operands (rows t, columns g: 8t + g).
template <int C, int N>
struct Layout {
  static constexpr int NA = N + 4, NBS = N + 8, CA = C + 4;
  static constexpr int R = 0;                  // r                   C x NA
  static constexpr int RP = R + C * NA;        // r e^{lw_excl}       C x NA
  static constexpr int K = RP + C * NA;        // k                   C x NA
  static constexpr int LWE = K + C * NA;       // lw_excl             C x NA
  static constexpr int LWI = LWE + C * NA;     // lw_incl             C x NA
  static constexpr int Q = LWI + C * NA;       // k e^{R_a - lw_incl} C x NBS
  static constexpr int KP = Q + C * NBS;       // k'                  C x NBS
  static constexpr int V = KP + C * NBS;       // v                   C x NBS
  static constexpr int A = V + C * NBS;        // decay matrix        C x CA
  static constexpr int T = A + C * CA;         // T, then S_in        N x NBS
  static constexpr int VEC = T + N * NBS;      // u, d, D             N each
  static constexpr int RPP = VEC + 3 * N;      // r'' per own chunk   C x NA
  static constexpr int floats(int per_block) { return RPP + per_block * C * NA; }
};

// TF32 hi and lo parts of x: x = hi + lo + O(2^-22 |x|).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (one m16n8 tile at rows r0, columns c0) += X[rows, 0:KD] Y[0:KD, c0:c0+8]
// in 3xTF32, the two small products on a second accumulator (two chains
// of dependent mma.sync instead of one).  X(row, k) is xp[row * xs + k], or xp[k * xs + row] when XT;
// rows at or past `rows` read zero.  Fragment: acc[2h + c] is row r0 + g + 8h,
// column c0 + 2t + c (g = lane / 4, t = lane % 4).
template <int KD, bool XT>
__device__ __forceinline__ void tile_mma(float (&acc)[4], const float* xp, int xs,
                                         int r0, int rows, const float* yp, int ys,
                                         int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool ok0 = r0 + g < rows, ok1 = r0 + g + 8 < rows;
  float small[4] = {};
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += 8) {
    float x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + g + 8 * (q & 1), k = k0 + t + 4 * (q >> 1);
      x[q] = ((q & 1) ? ok1 : ok0) ? (XT ? xp[k * xs + row] : xp[row * xs + k]) : 0.f;
    }
    uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(x[q], ah[q], al[q]);
    split_tf32(yp[(k0 + t) * ys + c0 + g], bh0, bl0);
    split_tf32(yp[(k0 + t + 4) * ys + c0 + g], bh1, bl1);
    mma_tf32(small, al, bh0, bh1);
    mma_tf32(small, ah, bl0, bl1);
    mma_tf32(acc, ah, bh0, bh1);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += small[q];
}

// The tile `j` of warp `warp` in a (rows x N) output of m16n8 tiles: its
// origin, or false past the last tile.
template <int ROWS, int N>
__device__ __forceinline__ bool tile_at(int j, int& r0, int& c0) {
  constexpr int COLS = N / 8, TILES = (ROWS + 15) / 16 * COLS;
  const int tt = (threadIdx.x >> 5) + j * WARPS;
  r0 = tt / COLS * 16;
  c0 = tt % COLS * 8;
  return tt < TILES;
}

// e^x for x <= 0 as exp2(x log2 e): the product's rounding moves the
// exponent by at most |x| 2^-24 log2 e, a relative error below 1e-6 for
// |x| <= 10; where |x| is larger the term is below e^-10 of its factors and
// its error below 1e-6 of them.  Well inside the 2e-4 of the tolerance, and
// a handful of instructions where expf takes ~20.
__device__ __forceinline__ float decay(float x) {
  return exp2f(__fmul_rn(x, 1.4426950408889634f));
}

// The decay matrix of one chunk: A[i][j] for j < i, the bonus A[i][i]
// (zero above the diagonal is written in an earlier phase).  Three kinds of
// work units, each split over NPART lanes along n (n = part + NPART e) and
// summed by shuffles, laid out so that each kind fills whole warps where
// the shape allows:
//   O  row i against the SUB columns of an earlier sub-chunk a:
//      sum_n e^{lw_excl_in - R_an} r_in Q_jn (one exponential per n);
//   P  one pair j < i inside a sub-chunk: the pairwise exponential;
//   B  the bonus of row i: sum_n r_in u_n k_in.
template <int C, int N>
__device__ __forceinline__ void decay_matrix(const float* rs, const float* ks,
                                             const float* lwe, const float* lwi,
                                             const float* qs, const float* us,
                                             float* as) {
  using L = Layout<C, N>;
  constexpr int NA = L::NA, NBS = L::NBS, CA = L::CA, NSUB = C / SUB;
  constexpr int NPART = N >= 16 ? N / 16 : 1, NPER = N / NPART;
  constexpr int PAIRS = SUB * (SUB - 1) / 2;
  constexpr int UO = SUB * NSUB * (NSUB - 1) / 2 * NPART;
  constexpr int UP = NSUB * PAIRS * NPART;
  constexpr int TOTAL = UO + UP + C * NPART;
  const int lane = threadIdx.x & 31;
  for (int base = (threadIdx.x >> 5) * 32; base < TOTAL; base += THREADS) {
    const int idx = base + lane, part = idx % NPART;
    float o[SUB] = {};
    int i = 0, j0 = 0, kind = 0;  // 0: O, 1: P (column j0), 2: B
    if (idx < UO) {  // O units run sub-chunk by sub-chunk: rows [SUB (a+1), C)
      int a = 0, rem = idx / NPART;
      while (rem >= C - SUB * (a + 1)) {
        rem -= C - SUB * (a + 1);
        ++a;
      }
      i = SUB * (a + 1) + rem;
      j0 = SUB * a;
      const float* ra = lwi + (j0 + SUB - 1) * NA;
#pragma unroll
      for (int e = 0; e < NPER; ++e) {
        const int n = part + NPART * e;
        const float p = rs[i * NA + n] * decay(lwe[i * NA + n] - ra[n]);
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) o[jj] += p * qs[(j0 + jj) * NBS + n];
      }
    } else if (idx < UO + UP) {
      const int u = (idx - UO) / NPART, a = u / PAIRS;
      int ii = 1, pr = u % PAIRS;  // pairs (ii, jj < ii) of the sub-chunk
      while (pr >= ii) {
        pr -= ii;
        ++ii;
      }
      i = SUB * a + ii;
      j0 = SUB * a + pr;
      kind = 1;
#pragma unroll
      for (int e = 0; e < NPER; ++e) {
        const int n = part + NPART * e;
        o[e % SUB] += rs[i * NA + n] * ks[j0 * NA + n] * decay(lwe[i * NA + n] - lwi[j0 * NA + n]);
      }
    } else if (idx < TOTAL) {
      i = (idx - UO - UP) / NPART;
      kind = 2;
#pragma unroll
      for (int e = 0; e < NPER; ++e) {
        const int n = part + NPART * e;
        o[e % SUB] += rs[i * NA + n] * us[n] * ks[i * NA + n];
      }
    }
    if (kind != 0) {  // P and B: SUB interleaved partial sums, added pairwise
#pragma unroll
      for (int w = SUB / 2; w > 0; w >>= 1)
#pragma unroll
        for (int jj = 0; jj < w; ++jj) o[jj] += o[jj + w];
    }
#pragma unroll
    for (int off = 1; off < NPART; off <<= 1)
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) o[jj] += __shfl_xor_sync(~0u, o[jj], off);
    if (idx < TOTAL && part == 0) {
      if (kind == 0) {
#pragma unroll
        for (int jj = 0; jj < SUB; ++jj) as[i * CA + j0 + jj] = o[jj];
      } else {
        as[i * CA + (kind == 1 ? j0 : i)] = o[0];
      }
    }
  }
}

// Store a warp's y tile (fragment layout, rows r0.., columns c0..) to rows
// of y at row stride `tok`, rows past C left out.
template <int C>
__device__ __forceinline__ void store_rows(float* y, int64_t tok, int r0, int c0,
                                           const float (&x)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = r0 + g + 8 * hh;
    if (i < C)
      *reinterpret_cast<float2*>(y + i * tok + c0 + 2 * t) =
          make_float2(x[2 * hh], x[2 * hh + 1]);
  }
}

// Store a warp's state tiles (fragment layout) into ts (row stride NBS).
template <int N, int ST>
__device__ __forceinline__ void store_state(float* ts, const float (&x)[ST][4]) {
  constexpr int NBS = N + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < ST; ++j) {
    int r0, c0;
    if (!tile_at<N, N>(j, r0, c0)) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = r0 + g + 8 * hh;
      if (n < N)
        *reinterpret_cast<float2*>(ts + n * NBS + c0 + 2 * t) =
            make_float2(x[j][2 * hh], x[j][2 * hh + 1]);
    }
  }
}

template <int C, int N>
__global__ void __launch_bounds__(THREADS, 1)
wkv_kernel(const float* __restrict__ R, const float* __restrict__ K,
           const float* __restrict__ V, const float* __restrict__ LW,
           const float* __restrict__ U, const float* __restrict__ S0,
           float* __restrict__ Y, float* __restrict__ S1, int S, int H,
           int u_bstride, int per_block) {
  using L = Layout<C, N>;
  constexpr int NA = L::NA, NBS = L::NBS, CA = L::CA;
  constexpr int YT = ((C + 15) / 16 * (N / 8) + WARPS - 1) / WARPS;  // y tiles per warp
  constexpr int ST = ((N + 15) / 16 * (N / 8) + WARPS - 1) / WARPS;  // state tiles per warp
  extern __shared__ __align__(16) float smem[];
  float* rs = smem + L::R;
  float* rps = smem + L::RP;
  float* ks = smem + L::K;
  float* lwe = smem + L::LWE;
  float* lwi = smem + L::LWI;
  float* qs = smem + L::Q;
  float* kps = smem + L::KP;
  float* vs = smem + L::V;
  float* as = smem + L::A;
  float* ts = smem + L::T;
  float* us = smem + L::VEC;
  float* dv = us + N;    // d = e^{lw_incl_C} of the current chunk
  float* dcum = dv + N;  // D: the decays of the block's chunks so far
  float* rpp = smem + L::RPP;

  cg::cluster_group cluster = cg::this_cluster();
  const int G = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = int64_t(b) * H + h, tok = int64_t(H) * N;
  const int nc = S / C, per_window = G * per_block;
  const int windows = (nc + per_window - 1) / per_window;

  for (int n = tid; n < N; n += THREADS)
    us[n] = U[int64_t(b) * u_bstride + int64_t(h) * N + n];
  // The state entering the window, in the fragment layout of the warp's
  // state tiles; after the last window, the state after the sequence.
  float sst[ST][4];
#pragma unroll
  for (int j = 0; j < ST; ++j) {
    int r0, c0;
    const bool ok = tile_at<N, N>(j, r0, c0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = r0 + g + 8 * hh;
      float2 x = make_float2(0.f, 0.f);
      if (ok && n < N)
        x = *reinterpret_cast<const float2*>(S0 + (bh * N + n) * N + c0 + 2 * t);
      sst[j][2 * hh] = x.x;
      sst[j][2 * hh + 1] = x.y;
    }
  }

  for (int win = 0; win < windows; ++win) {
    const int first = win * per_window + rank * per_block;
    const int own = max(0, min(per_block, nc - first));
    float tfr[ST][4] = {};       // T of the block's chunks so far
    for (int n = tid; n < N; n += THREADS) dcum[n] = 1.f;

#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
      if (l >= own) continue;  // uniform in the block; l stays a constant
      const int64_t base = (int64_t(b) * S + int64_t(first + l) * C) * tok + int64_t(h) * N;
      // 1. The previous chunk's T to ts and D <- D d; r, k, v and lw by
      //    16-byte loads; then lw summed down the chunk in order by the
      //    column's thread (lw_excl = lw_incl - lw, as the reference
      //    computes it).
      if (l > 0) {
        store_state<N, ST>(ts, tfr);
        for (int n = tid; n < N; n += THREADS) dcum[n] *= dv[n];
      }
      for (int idx = tid; idx < C * N / 4; idx += THREADS) {
        const int i = idx / (N / 4), n = idx % (N / 4) * 4;
        const int64_t gi = base + i * tok + n;
        *reinterpret_cast<float4*>(rs + i * NA + n) = *reinterpret_cast<const float4*>(R + gi);
        *reinterpret_cast<float4*>(ks + i * NA + n) = *reinterpret_cast<const float4*>(K + gi);
        *reinterpret_cast<float4*>(vs + i * NBS + n) = *reinterpret_cast<const float4*>(V + gi);
        *reinterpret_cast<float4*>(lwi + i * NA + n) = *reinterpret_cast<const float4*>(LW + gi);
      }
      __syncthreads();
      if (tid < N) {
        float acc = 0.f;
#pragma unroll
        for (int i0 = 0; i0 < C; i0 += 8) {
          float x[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] = lwi[(i0 + i) * NA + tid];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc += x[i];
            lwi[(i0 + i) * NA + tid] = acc;
            lwe[(i0 + i) * NA + tid] = acc - x[i];
          }
        }
      }
      __syncthreads();
      // 2. r' = r e^{lw_excl}; Q = k e^{R_a - lw_incl} (a: the row's
      //    sub-chunk); k' = k e^{lw_incl_C - lw_incl}; d; zero above A's
      //    diagonal.
      for (int idx = tid; idx < C * N; idx += THREADS) {
        const int i = idx / N, n = idx % N;
        const float li = lwi[i * NA + n], kv = ks[i * NA + n];
        rps[i * NA + n] = rs[i * NA + n] * decay(lwe[i * NA + n]);
        qs[i * NBS + n] = kv * decay(lwi[(i / SUB * SUB + SUB - 1) * NA + n] - li);
        kps[i * NBS + n] = kv * decay(lwi[(C - 1) * NA + n] - li);
      }
      for (int n = tid; n < N; n += THREADS) dv[n] = decay(lwi[(C - 1) * NA + n]);
      for (int idx = tid; idx < C * C; idx += THREADS)
        if (idx % C > idx / C) as[idx / C * CA + idx % C] = 0.f;
      __syncthreads();
      // 3. The decay matrix.
      decay_matrix<C, N>(rs, ks, lwe, lwi, qs, us, as);
      __syncthreads();
      // 4. r'' = r' D; y = A v (+ r' T of the block's earlier chunks);
      //    T <- d T + k'^T v (in registers until the next chunk or the
      //    exchange).
      float* rl = rpp + l * C * NA;
      for (int idx = tid; idx < C * N; idx += THREADS) {
        const int i = idx / N, n = idx % N;
        rl[i * NA + n] = rps[i * NA + n] * dcum[n];
      }
#pragma unroll
      for (int j = 0; j < YT; ++j) {  // y so far to Y; r'' S_in is added later
        int r0, c0;
        if (!tile_at<C, N>(j, r0, c0)) continue;
        float yt[4] = {};
        tile_mma<C, false>(yt, as, CA, r0, C, vs, NBS, c0);
        if (l > 0) tile_mma<N, false>(yt, rps, NA, r0, C, ts, NBS, c0);
        store_rows<C>(Y + base, tok, r0, c0, yt);
      }
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        int r0, c0;
        if (!tile_at<N, N>(j, r0, c0)) continue;
        float ds[4] = {};
        tile_mma<C, true>(ds, kps, NBS, r0, N, vs, NBS, c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = r0 + g + 8 * (e >> 1);
          if (n < N) tfr[j][e] = dv[n] * tfr[j][e] + ds[e];
        }
      }
      __syncthreads();
    }
    // Publish (T, D): zero and one for a block with no chunk here.
    store_state<N, ST>(ts, tfr);
    if (own > 0)
      for (int n = tid; n < N; n += THREADS) dcum[n] *= dv[n];

    // The exchange.  S_in = the window's start state composed, in rank
    // order, with every earlier block's (T, D); the state after the window
    // (every block when another window follows, the last block always).
    cluster.sync();
    const int upto = (win + 1 < windows || rank == G - 1) ? G : rank;
    float sin_[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      int r0, c0;
      const bool ok = tile_at<N, N>(j, r0, c0);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = r0 + g + 8 * hh;
        float2 tv[MAX_CLUSTER];
        float dq[MAX_CLUSTER];
#pragma unroll
        for (int q = 0; q < MAX_CLUSTER; ++q)  // every load first, then the chain
          if (ok && n < N && q < upto) {
            tv[q] = *reinterpret_cast<const float2*>(cluster.map_shared_rank(ts, q) +
                                                     n * NBS + c0 + 2 * t);
            dq[q] = cluster.map_shared_rank(dcum, q)[n];
          }
        float s0 = sst[j][2 * hh], s1 = sst[j][2 * hh + 1];
#pragma unroll
        for (int q = 0; q < MAX_CLUSTER; ++q) {
          if (q == rank) {
            sin_[j][2 * hh] = s0;
            sin_[j][2 * hh + 1] = s1;
          }
          if (ok && n < N && q < upto) {
            s0 = dq[q] * s0 + tv[q].x;
            s1 = dq[q] * s1 + tv[q].y;
          }
        }
        sst[j][2 * hh] = s0;
        sst[j][2 * hh + 1] = s1;
      }
    }
    cluster.sync();  // no block overwrites or leaves while another reads it

    // y += r'' S_in for each own chunk.
    store_state<N, ST>(ts, sin_);
    __syncthreads();
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
      if (l >= own) continue;
      const int64_t base = (int64_t(b) * S + int64_t(first + l) * C) * tok + int64_t(h) * N;
#pragma unroll
      for (int j = 0; j < YT; ++j) {
        int r0, c0;
        if (!tile_at<C, N>(j, r0, c0)) continue;
        float yt[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {  // this thread's own stores of phase 4
          const int i = r0 + g + 8 * hh;
          const float2 x = i < C ? *reinterpret_cast<const float2*>(Y + base + i * tok + c0 + 2 * t)
                                 : make_float2(0.f, 0.f);
          yt[2 * hh] = x.x;
          yt[2 * hh + 1] = x.y;
        }
        tile_mma<N, false>(yt, rpp + l * C * NA, NA, r0, C, ts, NBS, c0);
        store_rows<C>(Y + base, tok, r0, c0, yt);
      }
    }
    __syncthreads();  // ts, rpp and dcum are reused by the next window
  }

  if (rank == G - 1) {
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      int r0, c0;
      if (!tile_at<N, N>(j, r0, c0)) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = r0 + g + 8 * hh;
        if (n < N)
          *reinterpret_cast<float2*>(S1 + (bh * N + n) * N + c0 + 2 * t) =
              make_float2(sst[j][2 * hh], sst[j][2 * hh + 1]);
      }
    }
  }
}

template <int C, int N>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* y, void* s1, int B, int S,
           int H, int u_bstride, int cluster, int per_block, cudaStream_t stream) {
  const int smem = Layout<C, N>::floats(per_block) * int(sizeof(float));
  static bool smem_set = false;  // above 48 KB only after opting in
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<C, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<C, N>::floats(LMAX) * int(sizeof(float)));
    if (err != cudaSuccess) return int(err);
    smem_set = true;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, wkv_kernel<C, N>, static_cast<const float*>(r),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(lw), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(y),
      static_cast<float*>(s1), S, H, u_bstride, per_block);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

template <int C>
int launch_n(int N, const void* r, const void* k, const void* v,
             const void* lw, const void* u, const void* s0, void* y, void* s1,
             int B, int S, int H, int u_bstride, int cluster, int per_block,
             cudaStream_t st) {
  switch (N) {
    case 8: return launch<C, 8>(r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, cluster, per_block, st);
    case 16: return launch<C, 16>(r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, cluster, per_block, st);
    case 32: return launch<C, 32>(r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, cluster, per_block, st);
    case 64: return launch<C, 64>(r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, cluster, per_block, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <int C>
int smem_n(int N, int per_block) {
  switch (N) {
    case 8: return Layout<C, 8>::floats(per_block) * int(sizeof(float));
    case 16: return Layout<C, 16>::floats(per_block) * int(sizeof(float));
    case 32: return Layout<C, 32>::floats(per_block) * int(sizeof(float));
    case 64: return Layout<C, 64>::floats(per_block) * int(sizeof(float));
    default: return -1;
  }
}

}  // namespace

// Dynamic shared memory of the kernel for chunk C, head size N and
// `per_block` chunks per block (the wrapper's plan mirrors it), or -1.
extern "C" int spidr_wkv_smem(int C, int N, int per_block) {
  switch (C) {
    case 8: return smem_n<8>(N, per_block);
    case 16: return smem_n<16>(N, per_block);
    case 32: return smem_n<32>(N, per_block);
    case 64: return smem_n<64>(N, per_block);
    default: return -1;
  }
}

// C interface (loaded with ctypes); returns cudaGetLastError() after the
// launch.  r, k, v, lw, y: (B, S, H, N) fp32, 16-byte aligned; s0, s1:
// (B, H, N, N) fp32; u holds N floats per head at u + b * u_bstride + h * N
// (u_bstride = 0 for a (H, N) bonus shared over the batch).  C and N are
// each one of 8, 16, 32 and 64; S is a multiple of C.  `cluster` blocks (1
// to 8) share each (b, h), each owning `per_block` (1 or 2) chunks per
// window (the wrapper's plan).
extern "C" int spidr_wkv_sequence(const void* r, const void* k, const void* v,
                                  const void* lw, const void* u,
                                  const void* s0, void* y, void* s1, int B,
                                  int S, int H, int N, int C, int u_bstride,
                                  int cluster, int per_block, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || C <= 0 || S % C != 0 || u_bstride < 0 ||
      B > 65535 || H > 65535 || cluster < 1 || cluster > MAX_CLUSTER ||
      per_block < 1 || per_block > LMAX ||
      (reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(lw) |
       reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(s0) | reinterpret_cast<uintptr_t>(s1)) % 16 != 0)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8: return launch_n<8>(N, r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, cluster, per_block, st);
    case 16: return launch_n<16>(N, r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, cluster, per_block, st);
    case 32: return launch_n<32>(N, r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, cluster, per_block, st);
    case 64: return launch_n<64>(N, r, k, v, lw, u, s0, y, s1, B, S, H, u_bstride, cluster, per_block, st);
    default: return int(cudaErrorInvalidValue);
  }
}
