// Fused neuron-macro update for Hopper (sm_90a): one elementwise pass with
// two outputs.
//
// Replaces repro/kernels/lif_step.py (_tiled_call for lif_step_fused,
// _lif_kernel_f32, and for lif_step_fused_int, _lif_kernel_int):
//
//   float: v = leak != 1 ? v * leak : v;  v = v + I;  s = v >= thr;
//          v' = soft ? v - s * thr : v * (1 - s)
//   int:   v = shift > 0 ? v - (v >> shift) : v;  v = clip(v + P, lo, hi);
//          s = v >= thr;  v' = soft ? clip(v - s * thr, lo, hi) : v * (1 - s)
//
// What bounds it on this card: bytes (8 read and 8 written per element,
// a handful of operations).  So it is a grid-stride loop over the
// flattened tensor with 16-byte loads and stores where the pointers allow,
// and no padding: the TPU version pads to 256x256 tiles, which costs
// device memory and copies here.  Threshold, leak and reset are kernel
// arguments, not baked into the build.
//
// Numerics: the float step uses __fmul_rn/__fadd_rn/__fsub_rn, which nvcc
// never contracts into an FMA, so each operation rounds where PyTorch's
// and XLA's elementwise operations round.  The integer step is exact: >>
// on int32 is an arithmetic shift (as in jnp and torch), and the adds wrap
// modulo 2^32 as theirs do (computed in unsigned to stay defined in C++).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // enough resident blocks to fill the SMs

struct FloatStep {
  float thr, leak;
  int soft;
  __device__ __forceinline__ void operator()(float v, float i, float& v_out,
                                             float& s_out) const {
    if (leak != 1.0f) v = __fmul_rn(v, leak);
    v = __fadd_rn(v, i);
    const float s = v >= thr ? 1.0f : 0.0f;
    v_out = soft ? __fsub_rn(v, __fmul_rn(s, thr))
                 : __fmul_rn(v, __fsub_rn(1.0f, s));
    s_out = s;
  }
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return int(unsigned(a) + unsigned(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return int(unsigned(a) - unsigned(b));
}

struct IntStep {
  int thr, shift, soft, lo, hi;
  __device__ __forceinline__ void operator()(int v, int p, int& v_out,
                                             int& s_out) const {
    if (shift > 0) v = wrap_sub(v, v >> shift);
    v = min(max(wrap_add(v, p), lo), hi);
    const int s = v >= thr ? 1 : 0;
    v_out = soft ? min(max(wrap_sub(v, s * thr), lo), hi) : v * (1 - s);
    s_out = s;
  }
};

// T is float or int (4 bytes); V4 its 16-byte vector type.
template <typename T, typename V4, typename Step>
__global__ void __launch_bounds__(THREADS)
lif_step_kernel(const T* __restrict__ V, const T* __restrict__ I,
                T* __restrict__ V_OUT, T* __restrict__ S_OUT, int64_t n,
                int vec, Step step) {
  const int64_t stride = int64_t(gridDim.x) * THREADS;
  int64_t start = int64_t(blockIdx.x) * THREADS + threadIdx.x;
  int64_t tail = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t j = start; j < n4; j += stride) {
      const V4 v = reinterpret_cast<const V4*>(V)[j];
      const V4 i = reinterpret_cast<const V4*>(I)[j];
      V4 vo, so;
      step(v.x, i.x, vo.x, so.x);
      step(v.y, i.y, vo.y, so.y);
      step(v.z, i.z, vo.z, so.z);
      step(v.w, i.w, vo.w, so.w);
      reinterpret_cast<V4*>(V_OUT)[j] = vo;
      reinterpret_cast<V4*>(S_OUT)[j] = so;
    }
    tail = n4 * 4;
  }
  for (int64_t j = tail + start; j < n; j += stride)
    step(V[j], I[j], V_OUT[j], S_OUT[j]);
}

template <typename T, typename V4, typename Step>
int launch(const void* v, const void* i, void* v_out, void* s_out,
           int64_t n, Step step, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(i) |
      reinterpret_cast<uintptr_t>(v_out) | reinterpret_cast<uintptr_t>(s_out);
  const int vec = bits % 16 == 0;
  const int64_t work = vec ? (n + 3) / 4 : n;
  const int64_t want = (work + THREADS - 1) / THREADS;
  const int blocks = int(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  lif_step_kernel<T, V4, Step>
      <<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(v), static_cast<const T*>(i),
          static_cast<T*>(v_out), static_cast<T*>(s_out), n, vec, step);
  return int(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes); each returns cudaGetLastError() after
// the launch.  n is the element count of the flattened tensors.
extern "C" int spidr_lif_step_f32(const void* v, const void* current,
                                  void* v_out, void* s_out, int64_t n,
                                  float thr, float leak, int soft_reset,
                                  void* stream) {
  return launch<float, float4>(v, current, v_out, s_out, n,
                               FloatStep{thr, leak, soft_reset}, stream);
}

extern "C" int spidr_lif_step_int(const void* v, const void* partial,
                                  void* v_out, void* s_out, int64_t n,
                                  int thr, int leak_shift, int soft_reset,
                                  int v_min, int v_max, void* stream) {
  return launch<int, int4>(v, partial, v_out, s_out, n,
                           IntStep{thr, leak_shift, soft_reset, v_min, v_max},
                           stream);
}
