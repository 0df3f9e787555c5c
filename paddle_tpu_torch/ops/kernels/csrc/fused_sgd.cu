// Multi-tensor SGD and momentum updates for Hopper (sm_90a): one launch over a whole
// parameter list.
//
// Replaces: paddle_tpu/ops/pallas/optimizer.py:_sgd_kernel and _momentum_kernel (via
// fused_sgd_pallas / fused_momentum_pallas and _ew_call), registry names "fused_sgd" and
// "fused_momentum".
//
// What it computes, for every fp32 tensor of the list, in place:
//   SGD:       p = p - lr * g
//   momentum:  v = mu * v + g,  then  p = p - lr * v,  or with nesterov
//              p = p - lr * (g + mu * v)
// with lr read from device memory (the caller's pointer table carries it), so neither a
// step nor a change of rate needs a sync. Every product and sum is rounded on its own (no
// fused multiply-add), in the order of the plain version, so the two agree bit for bit.
//
// What bounds it on the H100: memory. SGD reads p and g and writes p: 12 bytes per element
// for 2 operations; momentum reads p, g, v and writes p, v: 20 bytes for 4-5 operations.
// word2vec's five tensors (596 K elements) move 7.2 MB under SGD, a bound of ~2 us: one
// launch per tensor, as the static path makes, is bound by the launch, not by the bytes.
//
// What the design does about it: the harness of fused_adam.cu. The host passes a table of
// {p, g, [v,] n} per tensor, the prefix sum of each tensor's count of 16K-element chunks and
// lr; each block takes one chunk, finds its tensor by binary search in the prefix sum and
// streams the chunk with 16-byte loads and stores where all its pointers are 16-byte aligned
// (a scalar loop takes the tail and unaligned tensors). Each element crosses device memory
// once each way, and a list of any length is one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 16384;  // elements per block; a multiple of 4

// The last tensor whose first chunk is at or before this one (tensors with no elements
// own no chunk and are passed over).
__device__ __forceinline__ int find_tensor(const int64_t* chunk_start, int n_tensors,
                                           int64_t chunk) {
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (chunk_start[mid] <= chunk) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void sgd(float& p, float g, float lr) {
  p = __fsub_rn(p, __fmul_rn(lr, g));
}

template <bool NESTEROV>
__device__ __forceinline__ void momentum(float& p, float g, float& v, float lr, float mu) {
  v = __fadd_rn(__fmul_rn(mu, v), g);
  if (NESTEROV)
    p = __fsub_rn(p, __fmul_rn(lr, __fadd_rn(g, __fmul_rn(mu, v))));
  else
    p = __fsub_rn(p, __fmul_rn(lr, v));
}

__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(const int64_t* __restrict__ table, const int64_t* __restrict__ chunk_start,
                 int n_tensors, const float* __restrict__ lr_ptr) {
  const int64_t chunk = blockIdx.x;
  const int t = find_tensor(chunk_start, n_tensors, chunk);
  const int64_t* e = table + 3 * t;
  float* p = reinterpret_cast<float*>(e[0]);
  const float* g = reinterpret_cast<const float*>(e[1]);
  const int64_t n = e[2];
  const int64_t begin = (chunk - chunk_start[t]) * kChunk;
  const int64_t end = n < begin + kChunk ? n : begin + kChunk;
  const float lr = *lr_ptr;

  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g)) & 15) == 0;
  int64_t tail = begin;
  if (aligned) {
    const int64_t n4 = (end - begin) / 4;
    float4* p4 = reinterpret_cast<float4*>(p + begin);
    const float4* g4 = reinterpret_cast<const float4*>(g + begin);
    for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
      float4 pv = p4[i];
      const float4 gv = g4[i];
      sgd(pv.x, gv.x, lr);
      sgd(pv.y, gv.y, lr);
      sgd(pv.z, gv.z, lr);
      sgd(pv.w, gv.w, lr);
      p4[i] = pv;
    }
    tail = begin + 4 * n4;
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) {
    float pv = p[i];
    sgd(pv, g[i], lr);
    p[i] = pv;
  }
}

template <bool NESTEROV>
__global__ void __launch_bounds__(kThreads)
fused_momentum_kernel(const int64_t* __restrict__ table, const int64_t* __restrict__ chunk_start,
                      int n_tensors, const float* __restrict__ lr_ptr, float mu) {
  const int64_t chunk = blockIdx.x;
  const int t = find_tensor(chunk_start, n_tensors, chunk);
  const int64_t* e = table + 4 * t;
  float* p = reinterpret_cast<float*>(e[0]);
  const float* g = reinterpret_cast<const float*>(e[1]);
  float* v = reinterpret_cast<float*>(e[2]);
  const int64_t n = e[3];
  const int64_t begin = (chunk - chunk_start[t]) * kChunk;
  const int64_t end = n < begin + kChunk ? n : begin + kChunk;
  const float lr = *lr_ptr;

  const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  int64_t tail = begin;
  if (aligned) {
    const int64_t n4 = (end - begin) / 4;
    float4* p4 = reinterpret_cast<float4*>(p + begin);
    const float4* g4 = reinterpret_cast<const float4*>(g + begin);
    float4* v4 = reinterpret_cast<float4*>(v + begin);
    for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
      float4 pv = p4[i], vv = v4[i];
      const float4 gv = g4[i];
      momentum<NESTEROV>(pv.x, gv.x, vv.x, lr, mu);
      momentum<NESTEROV>(pv.y, gv.y, vv.y, lr, mu);
      momentum<NESTEROV>(pv.z, gv.z, vv.z, lr, mu);
      momentum<NESTEROV>(pv.w, gv.w, vv.w, lr, mu);
      p4[i] = pv;
      v4[i] = vv;
    }
    tail = begin + 4 * n4;
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) {
    float pv = p[i], vv = v[i];
    momentum<NESTEROV>(pv, g[i], vv, lr, mu);
    p[i] = pv;
    v[i] = vv;
  }
}

int check_args(int n_tensors, int64_t n_chunks) {
  if (n_tensors <= 0 || n_chunks < 0 || n_chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// table: int64 [n_tensors, 3] on the device, rows {p, g, n} (fp32 pointers, element count);
// chunk_start: int64 [n_tensors + 1] on the device, the prefix sum of ceil(n / 16384) with
// chunk_start[n_tensors] = n_chunks; lr: one fp32 on the device. Returns the cudaError_t of
// the launch (0 = accepted).
extern "C" int pt_fused_sgd(const void* table, const void* chunk_start, int n_tensors,
                            int64_t n_chunks, const void* lr, void* stream) {
  if (n_chunks == 0) return 0;
  if (int err = check_args(n_tensors, n_chunks)) return err;
  fused_sgd_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), static_cast<const int64_t*>(chunk_start), n_tensors,
      static_cast<const float*>(lr));
  return static_cast<int>(cudaGetLastError());
}

// As pt_fused_sgd, with rows {p, g, v, n} (v the velocity, updated in place), the momentum
// mu and nesterov (0 or 1).
extern "C" int pt_fused_momentum(const void* table, const void* chunk_start, int n_tensors,
                                 int64_t n_chunks, const void* lr, float mu, int nesterov,
                                 void* stream) {
  if (n_chunks == 0) return 0;
  if (int err = check_args(n_tensors, n_chunks)) return err;
  const unsigned blocks = static_cast<unsigned>(n_chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* tb = static_cast<const int64_t*>(table);
  const int64_t* cs = static_cast<const int64_t*>(chunk_start);
  const float* lrp = static_cast<const float*>(lr);
  if (nesterov)
    fused_momentum_kernel<true><<<blocks, kThreads, 0, s>>>(tb, cs, n_tensors, lrp, mu);
  else
    fused_momentum_kernel<false><<<blocks, kThreads, 0, s>>>(tb, cs, n_tensors, lrp, mu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
