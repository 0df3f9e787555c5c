// Fused softmax cross-entropy for Hopper (sm_90a): per row, loss = logsumexp(x) - x[label].
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_xent_kernel (via _xent_fwd_call), registry
// name "softmax_cross_entropy".
//
// What it computes: for each of the n rows of logits [n, V] (float32 or bfloat16) and its
// int32 or int64 label, in one pass over the row: the fp32 max m and sum of exp(x - m),
// lse = m + log(sum), the label's logit read by its index, and loss = lse - picked; it
// writes loss and lse in fp32 (lse is what the backward needs). A label in [-V, -1] wraps
// once and any other label outside [0, V) picks NaN, so its loss is NaN: the meaning of
// the JAX package's stock body (jnp.take_along_axis), which the port's plain version
// has too. lse is NaN where the row holds a NaN or +inf, or only -inf, as the plain
// max-subtract-exp gives it.
//
// What bounds it on the H100: memory. It reads every logit once and does ~10 fp32
// instructions per logit (an expf): at BERT-base's gathered MLM head, 5120 rows of 30528
// bf16 logits are 312.6 MB, a bound of 93 us at 3.35 TB/s, where the expf work alone is
// ~50 us on the SMs' fp32 lanes; in fp32 the bound is 187 us.
//
// What the design does about it: one block of 256 threads per row, reading the row in
// 16-byte vectors (8 bf16 or 4 fp32) where V and the base pointer allow it (the wrapper
// decides), else element by element (V = 2073). Each thread keeps an online (max, sum):
// per vector it takes the vector's max, rescales its sum once if the max grew, and adds
// the vector's exps. The block merges the 256 pairs by warp shuffles and shared memory.
// One thread reads the label's logit and writes the row's loss and lse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// (m, s) and (m2, s2) -> the pair of their union; a max of -inf carries an empty sum
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  s = (m == -INFINITY ? 0.0f : s * expf(m - mm)) + (m2 == -INFINITY ? 0.0f : s2 * expf(m2 - mm));
  m = mm;
}

template <typename T, typename L, int VEC>
__global__ void __launch_bounds__(kThreads)
xent_kernel(const T* __restrict__ logits, const L* __restrict__ labels, float* __restrict__ loss,
            float* __restrict__ lse, int64_t v) {
  const int64_t row = blockIdx.x;
  const T* x = logits + row * v;
  const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(x);
  const int64_t nvec = v / VEC;
  float m = -INFINITY, s = 0.0f;
  bool bad = false;  // a NaN or +inf in the row
  for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
    const Pack<T, VEC> p = xv[i];
    float f[VEC];
    float vm = -INFINITY;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      f[e] = to_f32(p.v[e]);
      bad |= !(f[e] < INFINITY);  // NaN or +inf
      vm = fmaxf(vm, f[e]);
    }
    if (vm > m) {
      s = (m == -INFINITY) ? 0.0f : s * expf(m - vm);
      m = vm;
    }
    if (m != -INFINITY) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += expf(f[e] - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float sm[kWarps], ss[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  const int any_bad = __syncthreads_or(bad ? 1 : 0);
  if (threadIdx.x == 0) {
    m = sm[0];
    s = ss[0];
    for (int w = 1; w < kWarps; ++w) merge(m, s, sm[w], ss[w]);
    const float row_lse = (any_bad || m == -INFINITY) ? NAN : m + logf(s);
    int64_t lab = static_cast<int64_t>(labels[row]);
    float picked = NAN;
    if (lab >= -v && lab < v) {
      if (lab < 0) lab += v;
      picked = to_f32(x[lab]);
    }
    loss[row] = row_lse - picked;
    lse[row] = row_lse;
  }
}

template <typename T, typename L>
int launch(const void* logits, const void* labels, float* loss, float* lse, int64_t n, int64_t v,
           int vec, cudaStream_t stream) {
  const unsigned g = static_cast<unsigned>(n);
  const T* x = static_cast<const T*>(logits);
  const L* lab = static_cast<const L*>(labels);
  switch (vec) {
    case 8:
      xent_kernel<T, L, 8><<<g, kThreads, 0, stream>>>(x, lab, loss, lse, v);
      break;
    case 4:
      xent_kernel<T, L, 4><<<g, kThreads, 0, stream>>>(x, lab, loss, lse, v);
      break;
    case 2:
      xent_kernel<T, L, 2><<<g, kThreads, 0, stream>>>(x, lab, loss, lse, v);
      break;
    case 1:
      xent_kernel<T, L, 1><<<g, kThreads, 0, stream>>>(x, lab, loss, lse, v);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits: [n, v] on the device, float32 (dtype 0) or bfloat16 (1); labels: n int32 or int64;
// loss, lse: n float32 each. vec (8, 4, 2 or 1) logits per load: v and the logits' base
// pointer in units of vec elements must allow it, and vec times the element size is at
// most 16 (the wrapper decides). Returns the cudaError_t of the launch (0 = accepted).
extern "C" int pt_softmax_xent(const void* logits, const void* labels, int labels_are_64,
                               void* loss, void* lse, int64_t n, int64_t v, int dtype, int vec,
                               void* stream) {
  if (n == 0) return 0;
  if (n < 0 || n > 0x7fffffff || v <= 0 || vec <= 0 || v % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    return labels_are_64 ? launch<float, int64_t>(logits, labels, lo, ls, n, v, vec, s)
                         : launch<float, int32_t>(logits, labels, lo, ls, n, v, vec, s);
  if (dtype == 1)
    return labels_are_64
               ? launch<__nv_bfloat16, int64_t>(logits, labels, lo, ls, n, v, vec, s)
               : launch<__nv_bfloat16, int32_t>(logits, labels, lo, ls, n, v, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
