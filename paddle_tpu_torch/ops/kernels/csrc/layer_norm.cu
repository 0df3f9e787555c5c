// Row LayerNorm forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_ln_fwd_kernel (via _ln_fwd),
// registry name "fused_layer_norm".
//
// What it computes: for each row of x [n_rows, h] (fp32 or bf16),
//   mu   = mean(x)                       (fp32)
//   rstd = rsqrt(mean((x - mu)^2) + eps) (fp32, two-pass centred variance,
//                                         the same math as the TPU kernel)
//   y    = (x - mu) * rstd * gamma + beta, stored in x's dtype
// with gamma/beta fp32 [h]; mu and rstd [n_rows] are written when their
// pointers are not null.
//
// What bounds it on the H100: memory. It does ~8 operations per element and
// moves 2 * sizeof(x) bytes per element, far below the ~295 operations per
// byte where the card turns compute-bound. At [4096, 768] bf16 it moves
// ~12.6 MB, a bound of ~3.8 us at 3.35 TB/s.
//
// What the design does about it: each element is read from device memory
// once and written once. One warp owns one row and keeps it in registers
// (16-byte vector loads, 8 bf16 or 4 fp32 per lane per load), so the second
// (variance) and third (affine) passes read registers, not memory. Both
// reductions are warp shuffles; no shared memory, no block barrier. Four
// rows per 128-thread block; a row past the end exits with its whole warp,
// which masks the ragged tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* in) {
  uint4 v;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mu_out, float* __restrict__ rstd_out,
                      int64_t n_rows, int h, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x % kWarp;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;  // the whole warp leaves together
  const T* xr = x + row * h;
  T* yr = y + row * h;

  float v[NV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * kWarp + lane) * VEC;
    if (c < h) {
      load_vec(xr + c, v[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) sum += v[i][j];
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] = 0.f;
    }
  }
  const float mean = warp_sum(sum) / h;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * kWarp + lane) * VEC;
    if (c < h) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[i][j] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / h + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * kWarp + lane) * VEC;
    if (c < h) {
      float g[VEC], b[VEC], out[VEC];
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        load_vec(gamma + c + j, g + j);
        load_vec(beta + c + j, b + j);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = (v[i][j] - mean) * rstd * g[j] + b[j];
      store_vec(yr + c, out);
    }
  }
  if (lane == 0) {
    if (mu_out != nullptr) mu_out[row] = mean;
    if (rstd_out != nullptr) rstd_out[row] = rstd;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, void* mu,
                   void* rstd, int64_t n_rows, int h, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = (h + kWarp * VEC - 1) / (kWarp * VEC);
  const dim3 grid(static_cast<unsigned>((n_rows + kRowsPerBlock - 1) / kRowsPerBlock));
  const dim3 block(kWarp * kRowsPerBlock);
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mu);
  float* rp = static_cast<float*>(rstd);
#define PT_LN_CASE(N)                                                                     \
  case N:                                                                                 \
    layer_norm_fwd_kernel<T, N><<<grid, block, 0, stream>>>(xp, gp, bp, yp, mp, rp, n_rows, \
                                                            h, eps);                      \
    break;
  // one instantiation per 16-byte vectors per lane: h <= 32 * 8 * (16 / sizeof(T))
  switch (nv) {
    PT_LN_CASE(1)
    PT_LN_CASE(2)
    PT_LN_CASE(3)
    PT_LN_CASE(4)
    PT_LN_CASE(5)
    PT_LN_CASE(6)
    PT_LN_CASE(7)
    PT_LN_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_LN_CASE
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. h must be a multiple of 16 / sizeof(x)
// and at most 32 * 8 * (16 / sizeof(x)); every pointer 16-byte aligned.
// Returns the cudaError_t of the launch (0 = accepted).
extern "C" int pt_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                 void* mu, void* rstd, int64_t n_rows, int h, float eps,
                                 int dtype, void* stream) {
  if (n_rows == 0) return 0;
  if (h <= 0 || n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    if (h % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    err = launch<float>(x, gamma, beta, y, mu, rstd, n_rows, h, eps, s);
  } else if (dtype == 1) {
    if (h % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    err = launch<__nv_bfloat16>(x, gamma, beta, y, mu, rstd, n_rows, h, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
