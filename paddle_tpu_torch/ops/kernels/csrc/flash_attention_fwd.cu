// Flash-attention forward for Hopper (sm_90a).
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
// (starting at -1e30, the mask value; causally masked scores are replaced by
// it), a running sum l floored at 1e-30 at the end, and lse = m + log(l).
// Keys past S are masked in the kernel (their p is 0), so no padded copies
// are made; the result equals the TPU wrapper's, which pads S to 128 with a
// -1e30 key bias.
//
// What bounds it on the H100: operations. 4 * B * H * S^2 * D of them
// (2 * for q k^T, 2 * for p v) on ~(4 * S * D) elements per (batch, head);
// at [2, 12, 2048, 64] bf16 that is ~25.8 GFLOP, a bound of ~26 us on the
// tensor cores at 989 TFLOP/s.
//
// What the design does about it. bf16 inputs take the tensor cores
// (flash_fwd_wgmma_kernel): one block of three warpgroups per (batch, head,
// 128 query rows). Warpgroup 2 is the producer: one of its warps loads Q once
// and then K and V tiles of 128 keys by TMA (one box per 8 columns, so the
// tiles land in wgmma's no-swizzle core-matrix layout; rows past S read as
// zeros) into a ring of two shared-memory stages, with full/empty mbarriers,
// and stages the tile's key bias beside them. Warpgroups 0 and 1 each own 64
// query rows: S = Q K^T by wgmma m64n128k16 (bf16 in, fp32 accumulate, Q and
// K K-major from shared memory), then in registers the scale, bias, causal and
// S-edge masks and the online softmax (row max and sum across the four lanes
// that share a row, by shuffles), then O += P V by wgmma m64n{D}k16 with P
// from registers and V from shared memory as an MN-major operand (the
// transpose bit). P keeps fp32 accuracy: it is split into P_hi = bf16(P) and
// P_lo = bf16(P - P_hi) and both products go into the same fp32 accumulator,
// so P's relative error is ~2^-17 (the TPU kernel multiplies fp32 p by v).
// The split costs 1.5x the tensor work of a kernel with bf16 P. The epilogue
// writes o / l in bf16 and lse from registers. Under the causal mask a block
// stops at the last key tile its rows can see. The TMA loads need 16-byte
// aligned bases and row strides; the wrapper makes contiguous copies of views
// that are not (the fused QKV projection's head views are).
//
// fp32 inputs keep the first, plain SIMT version (flash_fwd_kernel): no main
// path runs attention in fp32, and whether TF32 would do is open. One 64-thread
// block per (batch, head, 64-row q tile); one thread per query row keeps its
// scaled q row, its output accumulator and its softmax state in registers; K
// and V are staged through shared memory 32 keys at a time as fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block = threads per block
constexpr int kBK = 32;  // keys per shared-memory tile
constexpr float kMaskValue = -1e30f;

struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs;
};

// ---------------------------------------------------------------- fp32: SIMT
template <int D>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse,
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
  const float* qp = q + b * st.qb + hh * st.qh + static_cast<int64_t>(row_ok ? qi : S - 1) * st.qs;
  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = qp[d] * scale;
    acc[d] = 0.f;
  }
  float m = kMaskValue;
  float l = 0.f;

  const float* kbase = k + b * st.kb + hh * st.kh;
  const float* vbase = v + b * st.vb + hh * st.vh;
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
        kv = kbase[static_cast<int64_t>(kk) * st.ks + c];
        vv = vbase[static_cast<int64_t>(kk) * st.vs + c];
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
    float* orow = o + row * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / l_safe;
    lse[row] = m + logf(l_safe);
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* bias, void* o,
                       void* lse, int B, int H, int S, int D, const Strides& st, float scale,
                       int causal, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  const dim3 block(kBQ);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(o);
  float* lp = static_cast<float*>(lse);
  switch (D) {
    case 16:
      flash_fwd_kernel<16><<<grid, block, 0, stream>>>(qp, kp, vp, bp, op, lp, H, S, st, scale,
                                                       causal);
      break;
    case 32:
      flash_fwd_kernel<32><<<grid, block, 0, stream>>>(qp, kp, vp, bp, op, lp, H, S, st, scale,
                                                       causal);
      break;
    case 64:
      flash_fwd_kernel<64><<<grid, block, 0, stream>>>(qp, kp, vp, bp, op, lp, H, S, st, scale,
                                                       causal);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ------------------------------------------------------- bf16: tensor cores
constexpr int kTcRows = 128;    // query rows per block: two consumer warpgroups x 64
constexpr int kTcKeys = 128;    // keys per K/V tile
constexpr int kTcStages = 2;    // K/V tiles in flight
constexpr int kTcThreads = 384; // warpgroups 0, 1: consumers; 2: producer

template <int D>
struct FwdSmem {
  __nv_bfloat16 q[kTcRows * D];              // D/8 slices of [128 rows][8]
  __nv_bfloat16 k[kTcStages][kTcKeys * D];   // D/8 slices of [128 keys][8]
  __nv_bfloat16 v[kTcStages][kTcKeys * D];
  float bias[kTcStages][kTcKeys];
  uint64_t full[kTcStages];
  uint64_t empty[kTcStages];
  uint64_t qbar;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int S,
                       float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const int q0 = blockIdx.x * kTcRows;
  const int kend = causal ? min(S, q0 + kTcRows) : S;
  const int ntiles = (kend + kTcKeys - 1) / kTcKeys;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      tc::mbar_init(&sm.full[s], 32);  // the producer warp's lanes
      tc::mbar_init(&sm.empty[s], 8);  // one lane of each consumer warp
    }
    tc::mbar_init(&sm.qbar, 1);
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one warp issues the loads, the others only give up registers
    tc::setmaxnreg_dec<40>();
    if (warp == 0) {
      if (lane == 0) {
        tc::mbar_arrive_expect_tx(&sm.qbar, kTcRows * D * 2);
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          tc::tma_load_4d(sm.q + c * kTcRows * 8, &tq, &sm.qbar, 8 * c, q0, hh, b);
      }
      const float* brow = bias == nullptr ? nullptr : bias + static_cast<int64_t>(b) * S;
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kTcStages;
        tc::mbar_wait(&sm.empty[s], ((t / kTcStages) & 1) ^ 1);
        const int k0 = t * kTcKeys;
#pragma unroll
        for (int i = 0; i < kTcKeys / 32; ++i) {
          const int j = lane + 32 * i;
          sm.bias[s][j] = (brow != nullptr && k0 + j < S) ? brow[k0 + j] : 0.f;
        }
        if (lane == 0) {
          tc::mbar_arrive_expect_tx(&sm.full[s], 2 * kTcKeys * D * 2);
#pragma unroll
          for (int c = 0; c < D / 8; ++c) {
            tc::tma_load_4d(sm.k[s] + c * kTcKeys * 8, &tk, &sm.full[s], 8 * c, k0, hh, b);
            tc::tma_load_4d(sm.v[s] + c * kTcKeys * 8, &tv, &sm.full[s], 8 * c, k0, hh, b);
          }
        } else {
          tc::mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    tc::setmaxnreg_inc<232>();
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int row_a = q0 + 64 * wg + 16 * warp + g;  // elements 4j+0,1; row_a + 8: 4j+2,3
    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m[2] = {kMaskValue, kMaskValue};
    float l[2] = {0.f, 0.f};  // this lane's part of the row sums
    const float kLog2e = 1.4426950408889634f;
    const uint32_t qaddr = tc::smem_u32(sm.q) + 64 * wg * 16;
    tc::mbar_wait(&sm.qbar, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kTcStages;
      tc::mbar_wait(&sm.full[s], (t / kTcStages) & 1);
      const uint32_t kaddr = tc::smem_u32(sm.k[s]);
      const uint32_t vaddr = tc::smem_u32(sm.v[s]);

      // S = Q K^T: k16 steps over D; Q slices 128 rows apart, K slices 128 keys
      float sacc[kTcKeys / 2];
#pragma unroll
      for (int i = 0; i < kTcKeys / 2; ++i) sacc[i] = 0.f;
      tc::wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint64_t da = tc::make_desc(qaddr + kd * 2 * kTcRows * 16, kTcRows * 16, 128);
        const uint64_t db = tc::make_desc(kaddr + kd * 2 * kTcKeys * 16, kTcKeys * 16, 128);
        tc::wgmma_ss(sacc, da, db, kd > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(sacc);

      // scale, bias and masks; the new row maxima
      const int k0 = t * kTcKeys;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kTcKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const int kk = k0 + col;
          const int r = e >> 1;
          float sv = sacc[4 * j + e] * scale + sm.bias[s][col];
          if (kk >= S) {
            sv = __int_as_float(0xff800000u);  // -inf: p = 0
          } else if (causal && kk > row_a + 8 * r) {
            sv = kMaskValue;
          }
          sacc[4 * j + e] = sv;
          mx[r] = fmaxf(mx[r], sv);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
        l[r] *= alpha[r];
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];

      // P = exp(s - m), split into bf16 hi and lo A fragments
      uint32_t phi[kTcKeys / 16][4], plo[kTcKeys / 16][4];
#pragma unroll
      for (int i = 0; i < kTcKeys / 2; ++i) {
        const float p = exp2f((sacc[i] - m[(i >> 1) & 1]) * kLog2e);
        sacc[i] = p;
        l[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int c = 0; c < kTcKeys / 16; ++c)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          tc::split_bf16(sacc[8 * c + 2 * x], sacc[8 * c + 2 * x + 1], phi[c][x], plo[c][x]);

      // O += P V: k16 steps over the tile's keys; V read MN-major
      tc::wgmma_fence();
#pragma unroll
      for (int c = 0; c < kTcKeys / 16; ++c) {
        const uint64_t dv = tc::make_desc(vaddr + c * 16 * 16, 128, kTcKeys * 16);
        tc::wgmma_rs(oacc, phi[c], dv);
        tc::wgmma_rs(oacc, plo[c], dv);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(oacc);
      tc::fence_regs(phi);
      tc::fence_regs(plo);
      if (lane == 0) tc::mbar_arrive(&sm.empty[s]);
    }

    // epilogue: o = acc / l in bf16, lse = m + log(l)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row >= S) continue;
      const float l_safe = fmaxf(l[r], 1e-30f);
      const float inv = 1.f / l_safe;
      const int64_t base = (static_cast<int64_t>(bh) * S + row);
      __nv_bfloat16* orow = o + base * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
      }
      if (t4 == 0) lse[base] = m[r] + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* bias, void* o,
                         void* lse, int B, int H, int S, const Strides& st, float scale,
                         int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tc_host::encode_heads(&tq, q, B, H, S, D, st.qb, st.qh, st.qs, kTcRows) ||
      !tc_host::encode_heads(&tk, k, B, H, S, D, st.kb, st.kh, st.ks, kTcKeys) ||
      !tc_host::encode_heads(&tv, v, B, H, S, D, st.vb, st.vh, st.vs, kTcKeys))
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(FwdSmem<D>));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTcRows - 1) / kTcRows, B * H);
  flash_fwd_wgmma_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, S, scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* bias, void* o,
                        void* lse, int B, int H, int S, int D, const Strides& st, float scale,
                        int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_wgmma<16>(q, k, v, bias, o, lse, B, H, S, st, scale, causal, stream);
    case 32:
      return launch_wgmma<32>(q, k, v, bias, o, lse, B, H, S, st, scale, causal, stream);
    case 64:
      return launch_wgmma<64>(q, k, v, bias, o, lse, B, H, S, st, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D in {16, 32, 64}; q/k/v strides in
// elements over (B, H, S), unit stride over D; bias [B, S] fp32 contiguous
// or null; o [B, H, S, D] and lse [B, H, S] contiguous. B * H <= 65535.
// bf16 (TMA): base pointers and the strides over B, H and S in multiples of
// 16 bytes. Returns the cudaError_t of the launch (0 = accepted).
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
    err = launch_f32(q, k, v, bias, o, lse, B, H, S, D, st, scale, causal, s);
  } else if (dtype == 1) {
    err = launch_bf16(q, k, v, bias, o, lse, B, H, S, D, st, scale, causal, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
