// Flash-attention forward for Hopper (sm_90a): a first, plain SIMT version.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_flash_fwd_kernel (via
// _flash_fwd and the padding wrapper _flash_attention_pallas), registry name
// "flash_attention" (forward).
//
// What it computes: for q, k, v [B, H, S, D] (fp32 or bf16, any strides over
// B, H and S, unit stride over D), an optional additive key bias [B, S] fp32
// and an optional causal mask,
//   o   = softmax(q k^T * scale + bias (+ causal mask)) v   in q's dtype
//   lse = logsumexp of the same scores                       fp32 [B, H, S]
// with the online-softmax recurrence of the TPU kernel: a running max m
// (starting at -1e30, the mask value), a running sum l floored at 1e-30
// at the end, and lse = m + log(l). Keys past S are masked in the kernel, so
// no padded copies are made; the result equals the TPU wrapper's, which pads
// S to 128 with a -1e30 key bias.
//
// What bounds it on the H100: operations. 4 * B * H * S^2 * D of them
// (2 * for q k^T, 2 * for p v) on ~(4 * S * D) elements per (batch, head);
// at [2, 12, 2048, 64] bf16 that is ~25.8 GFLOP, a bound of ~26 us on the
// tensor cores at 989 TFLOP/s.
//
// What the design does about it (first version: right and simple, not
// fast): it runs in fp32 on the SIMT cores (67 TFLOP/s peak), not on the
// tensor cores, so it sits far above that bound. One 64-thread block per
// (batch, head, 64-row q tile); one thread per query row keeps its scaled q
// row, its output accumulator and its softmax state in registers. K and V
// are staged through shared memory 32 keys at a time as fp32; every thread
// of a warp reads the same key, so shared-memory reads are broadcasts, and
// they are 16 bytes wide, so each one feeds 4 FMAs. The [S, S] scores never
// exist in memory. Under the causal mask a block stops at the last key tile
// its rows can see. mma.sync / wgmma, TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per block = threads per block
constexpr int kBK = 32;  // keys per shared-memory tile
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs;
};

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
                 int H, int S, Strides st, float scale, int causal) {
  __shared__ __align__(16) float ks[kBK * D];
  __shared__ __align__(16) float vs[kBK * D];
  __shared__ float bs[kBK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int qi = q0 + tid;
  const bool row_ok = qi < S;

  // rows past S compute on row S-1 and store nothing
  const T* qp = q + b * st.qb + hh * st.qh + static_cast<int64_t>(row_ok ? qi : S - 1) * st.qs;
  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = to_f(qp[d]) * scale;
    acc[d] = 0.f;
  }
  float m = kMaskValue;
  float l = 0.f;

  const T* kbase = k + b * st.kb + hh * st.kh;
  const T* vbase = v + b * st.vb + hh * st.vh;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<int64_t>(b) * S;
  const int kend = causal ? min(S, q0 + kBQ) : S;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < kBK * D; idx += kBQ) {
      const int r = idx / D;
      const int c = idx % D;
      const int kk = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kk < S) {
        kv = to_f(kbase[static_cast<int64_t>(kk) * st.ks + c]);
        vv = to_f(vbase[static_cast<int64_t>(kk) * st.vs + c]);
      }
      ks[idx] = kv;
      vs[idx] = vv;
    }
    if (tid < kBK) {
      const int kk = k0 + tid;
      bs[tid] = (brow != nullptr && kk < S) ? brow[kk] : 0.f;
    }
    __syncthreads();

    float s[kBK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kv = kr[d4];
        dot = fmaf(qr[4 * d4], kv.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
      }
      const int kk = k0 + j;
      float sj = dot + bs[j];
      if (kk >= S || (causal && kk > qi)) sj = kMaskValue;
      s[j] = sj;
      m_new = fmaxf(m_new, sj);
    }
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
      const float p = s[j];
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float l_safe = fmaxf(l, 1e-30f);
    const int64_t row = static_cast<int64_t>(bh) * S + qi;
    T* orow = o + row * D;
#pragma unroll
    for (int d = 0; d < D; ++d) from_f(orow + d, acc[d] / l_safe);
    lse[row] = m + logf(l_safe);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* o,
                   void* lse, int B, int H, int S, int D, const Strides& st, float scale,
                   int causal, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  const dim3 block(kBQ);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const float* bp = static_cast<const float*>(bias);
  T* op = static_cast<T*>(o);
  float* lp = static_cast<float*>(lse);
  switch (D) {
    case 16:
      flash_fwd_kernel<T, 16><<<grid, block, 0, stream>>>(qp, kp, vp, bp, op, lp, H, S, st,
                                                          scale, causal);
      break;
    case 32:
      flash_fwd_kernel<T, 32><<<grid, block, 0, stream>>>(qp, kp, vp, bp, op, lp, H, S, st,
                                                          scale, causal);
      break;
    case 64:
      flash_fwd_kernel<T, 64><<<grid, block, 0, stream>>>(qp, kp, vp, bp, op, lp, H, S, st,
                                                          scale, causal);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D in {16, 32, 64}; q/k/v strides in
// elements over (B, H, S), unit stride over D; bias [B, S] fp32 contiguous
// or null; o [B, H, S, D] and lse [B, H, S] contiguous. B * H <= 65535.
// Returns the cudaError_t of the launch (0 = accepted).
extern "C" int pt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* bias, void* o, void* lse, int B, int H, int S,
                                      int D, int64_t qb, int64_t qh, int64_t qs, int64_t kb,
                                      int64_t kh, int64_t ks, int64_t vb, int64_t vh,
                                      int64_t vs, float scale, int causal, int dtype,
                                      void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (B < 0 || H < 0 || S < 0 || static_cast<int64_t>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, bias, o, lse, B, H, S, D, st, scale, causal, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, bias, o, lse, B, H, S, D, st, scale, causal, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
