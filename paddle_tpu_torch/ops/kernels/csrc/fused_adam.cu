// Multi-tensor Adam update for Hopper (sm_90a): one launch over a whole
// parameter list.
//
// Replaces: paddle_tpu/ops/pallas/optimizer.py:_adam_kernel (via
// fused_adam_pallas and _ew_call), registry name "fused_adam".
//
// What it computes: for every fp32 tensor i of the list, in place,
//   m1 = b1 * m1 + (1 - b1) * g
//   m2 = b2 * m2 + (1 - b2) * (g * g)
//   p  = p - (lr * bc) * m1 / (sqrt(m2) + eps),  bc = sqrt(1 - b2^t) / (1 - b1^t)
// with t the optimizer's step counter and lr the learning rate, both read
// from device memory (the caller has already incremented t; lr is a
// schedule's value at t, or a constant the caller's table carries), so a
// step needs no device-to-host sync. eps
// sits on sqrt(m2) before the bias correction, as in the TPU kernel; the
// scalar work is fp32 as fused_adam_pallas does it. Every product and sum is
// rounded on its own (no fused multiply-add), in the order of the plain
// version, so the two differ only where powf does.
//
// What bounds it on the H100: memory. It reads p, g, m1, m2 and writes p, m1,
// m2: 28 bytes per element for ~12 operations. BERT-base's 109.5 M
// parameters move 3.07 GB per step, a bound of ~0.92 ms at 3.35 TB/s.
//
// What the design does about it: each element crosses device memory once
// each way, and the whole list is one launch (BERT has 154 tensors, most of
// them small: one launch each would be launch-bound). The host passes a table
// of {p, g, m1, m2, n} per tensor and the prefix sum of each tensor's count of
// 16K-element chunks; each block takes one chunk, finds its tensor by binary
// search in the prefix sum, and streams the chunk with 16-byte loads and
// stores where all four pointers are 16-byte aligned (a scalar loop takes the
// tail and unaligned tensors).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 16384;  // elements per block; a multiple of 4

struct Scalars {
  float b1, omb1, b2, omb2, eps, lr_bc;
};

__device__ __forceinline__ void adam(float& p, float g, float& m1, float& m2, const Scalars& c) {
  m1 = __fadd_rn(__fmul_rn(c.b1, m1), __fmul_rn(c.omb1, g));
  m2 = __fadd_rn(__fmul_rn(c.b2, m2), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(c.lr_bc, m1), __fadd_rn(__fsqrt_rn(m2), c.eps)));
}

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const int64_t* __restrict__ table, const int64_t* __restrict__ chunk_start,
                  int n_tensors, const int* __restrict__ step, const float* __restrict__ lr_ptr,
                  float b1, float omb1, float b2, float omb2, float eps) {
  const int64_t chunk = blockIdx.x;
  // the last tensor whose first chunk is at or before this one (tensors
  // with no elements own no chunk and are passed over)
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (chunk_start[mid] <= chunk) lo = mid;
    else hi = mid - 1;
  }
  const int64_t* e = table + 5 * lo;
  float* p = reinterpret_cast<float*>(e[0]);
  const float* g = reinterpret_cast<const float*>(e[1]);
  float* m1 = reinterpret_cast<float*>(e[2]);
  float* m2 = reinterpret_cast<float*>(e[3]);
  const int64_t n = e[4];
  const int64_t begin = (chunk - chunk_start[lo]) * kChunk;
  const int64_t end = n < begin + kChunk ? n : begin + kChunk;

  const float t = static_cast<float>(*step);
  const float bc = __fdiv_rn(__fsqrt_rn(__fsub_rn(1.f, powf(b2, t))),
                             __fsub_rn(1.f, powf(b1, t)));
  const Scalars c{b1, omb1, b2, omb2, eps, __fmul_rn(*lr_ptr, bc)};

  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(m1) | reinterpret_cast<uintptr_t>(m2)) & 15) == 0;
  int64_t tail = begin;
  if (aligned) {
    const int64_t n4 = (end - begin) / 4;
    float4* p4 = reinterpret_cast<float4*>(p + begin);
    const float4* g4 = reinterpret_cast<const float4*>(g + begin);
    float4* a4 = reinterpret_cast<float4*>(m1 + begin);
    float4* b4 = reinterpret_cast<float4*>(m2 + begin);
    for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
      float4 pv = p4[i], mv = a4[i], vv = b4[i];
      const float4 gv = g4[i];
      adam(pv.x, gv.x, mv.x, vv.x, c);
      adam(pv.y, gv.y, mv.y, vv.y, c);
      adam(pv.z, gv.z, mv.z, vv.z, c);
      adam(pv.w, gv.w, mv.w, vv.w, c);
      p4[i] = pv;
      a4[i] = mv;
      b4[i] = vv;
    }
    tail = begin + 4 * n4;
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) {
    float pv = p[i], mv = m1[i], vv = m2[i];
    adam(pv, g[i], mv, vv, c);
    p[i] = pv;
    m1[i] = mv;
    m2[i] = vv;
  }
}

}  // namespace

// table: int64 [n_tensors, 5] on the device, rows {p, g, m1, m2, n} (fp32
// pointers, element count); chunk_start: int64 [n_tensors + 1] on the device,
// the prefix sum of ceil(n / 16384) with chunk_start[n_tensors] = n_chunks;
// step: int32 on the device; lr: one fp32 on the device. omb1 and omb2 are 1 - b1 and
// 1 - b2 as the caller rounds them. Returns the cudaError_t of the launch (0 = accepted).
extern "C" int pt_fused_adam(const void* table, const void* chunk_start, int n_tensors,
                             int64_t n_chunks, const void* step, const void* lr, float b1,
                             float omb1, float b2, float omb2, float eps, void* stream) {
  if (n_chunks == 0) return 0;
  if (n_tensors <= 0 || n_chunks < 0 || n_chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  fused_adam_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), static_cast<const int64_t*>(chunk_start), n_tensors,
      static_cast<const int*>(step), static_cast<const float*>(lr), b1, omb1, b2, omb2, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
