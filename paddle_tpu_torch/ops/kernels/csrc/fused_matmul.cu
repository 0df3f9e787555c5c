// Fused matmul + bias + activation for Hopper (sm_90a): out = act(x @ w + bias).
//
// Replaces: paddle_tpu/ops/pallas/matmul.py:_fmm_kernel with dequant=False (via _fmm_call),
// registry name "fused_matmul". The static graph's fuse_matmul_bias_act pass folds
// layers.fc's mul + elementwise_add + act into one fused_matmul op, whose compute lands here.
//
// What it computes: x [M, K] (fp32 or bf16, row-major) times w [K, N] (fp32 or bf16,
// row-major), summed in fp32, plus an fp32 bias [N] when given, then relu, sigmoid, tanh or
// nothing, written as fp32 [M, N]. Like the TPU kernel, the epilogue runs on the fp32 sum;
// gelu and the cast to the caller's dtype stay outside (the wrapper). No TF32: fp32 inputs
// stay fp32 products.
//
// What bounds it on the H100: operations. word2vec's [100,256]x[256,2073] is 106 MFLOP over
// 2.3 MB (bound 1.6 us in fp32 SIMT at 67 TFLOP/s); BERT's FFN [4096,768]x[768,3072] is
// 19.3 GFLOP (0.29 ms in fp32 SIMT, 0.02 ms on the bf16 tensor cores).
//
// What the design does about it: a first, simple version on the SIMT cores. Each block of
// 256 threads owns a 64x64 output tile and walks K in steps of 16: it stages a 64x16 slice
// of x (transposed, as fp32) and a 16x64 slice of w (as fp32) in shared memory, and each
// thread accumulates a 4x4 sub-tile in registers with fused multiply-adds, reading x as
// warp broadcasts and w at consecutive addresses. Edge tiles are masked on load (zeros) and
// on store, so no shape needs padding (word2vec's N = 2073 is a multiple of no tile). The
// bias and activation run on the registers before the one store. Tensor cores (wgmma) come
// in a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == kRelu) return v < 0.f ? 0.f : v;  // NaN stays NaN, as jnp.maximum(v, 0)
  if (ACT == kSigmoid) return 1.f / (1.f + expf(-v));
  if (ACT == kTanh) return tanhf(v);
  return v;
}

template <typename TX, typename TW, int ACT>
__global__ void __launch_bounds__(kThreads)
fused_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, int64_t M,
                    int64_t N, int64_t K) {
  __shared__ float xs[kBK][kBM + 1];  // x slice, transposed: xs[k][m]
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = tid + r * kThreads;
      // x: 64 rows x 16 columns, 16 neighbouring threads on one row
      const int xm = idx / kBK, xk = idx % kBK;
      const int64_t gm = m0 + xm, gk = k0 + xk;
      xs[xk][xm] = (gm < M && gk < K) ? to_f32(x[gm * K + gk]) : 0.f;
      // w: 16 rows x 64 columns, 64 neighbouring threads on one row
      const int wk = idx / kBN, wn = idx % kBN;
      const int64_t hk = k0 + wk, hn = n0 + wn;
      ws[wk][wn] = (hk < K && hn < N) ? to_f32(w[hk * N + hn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[gn];
      out[gm * N + gn] = activate<ACT>(v);
    }
  }
}

template <typename TX, typename TW>
int launch_act(const void* x, const void* w, const float* bias, float* out, int64_t M, int64_t N,
               int64_t K, int act, cudaStream_t s) {
  const int64_t gy = (M + kBM - 1) / kBM, gx = (N + kBN - 1) / kBN;
  if (gy > 65535 || gx > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  switch (act) {
    case kNone:
      fused_matmul_kernel<TX, TW, kNone><<<grid, kThreads, 0, s>>>(xp, wp, bias, out, M, N, K);
      break;
    case kRelu:
      fused_matmul_kernel<TX, TW, kRelu><<<grid, kThreads, 0, s>>>(xp, wp, bias, out, M, N, K);
      break;
    case kSigmoid:
      fused_matmul_kernel<TX, TW, kSigmoid><<<grid, kThreads, 0, s>>>(xp, wp, bias, out, M, N,
                                                                      K);
      break;
    case kTanh:
      fused_matmul_kernel<TX, TW, kTanh><<<grid, kThreads, 0, s>>>(xp, wp, bias, out, M, N, K);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [M, K] row-major, dtype code x_bf16 (0 fp32, 1 bf16); w: [K, N] row-major, w_bf16
// likewise; bias: fp32 [N] or null; out: fp32 [M, N]. act: 0 none, 1 relu, 2 sigmoid,
// 3 tanh. Returns the cudaError_t of the launch (0 = accepted).
extern "C" int pt_fused_matmul(const void* x, int x_bf16, const void* w, int w_bf16,
                               const void* bias, void* out, int64_t M, int64_t N, int64_t K,
                               int act, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (!x_bf16 && !w_bf16) return launch_act<float, float>(x, w, b, o, M, N, K, act, s);
  if (!x_bf16 && w_bf16) return launch_act<float, __nv_bfloat16>(x, w, b, o, M, N, K, act, s);
  if (x_bf16 && !w_bf16) return launch_act<__nv_bfloat16, float>(x, w, b, o, M, N, K, act, s);
  return launch_act<__nv_bfloat16, __nv_bfloat16>(x, w, b, o, M, N, K, act, s);
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
