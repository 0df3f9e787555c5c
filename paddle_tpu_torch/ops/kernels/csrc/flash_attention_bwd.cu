// Flash-attention backward for Hopper (sm_90a): the two recompute kernels.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:_flash_bwd_dkdv_kernel (registry
// name "flash_attention_bwd_dkdv") and :_flash_bwd_dq_kernel (registry name
// "flash_attention_bwd_dq"), the two Pallas kernels of _flash_attention_bwd.
//
// What they compute: for q, k, v, dO [B, H, S, D] (fp32 or bf16, any strides
// over B, H and S, unit stride over D), the forward's lse [B, H, S], delta =
// sum_D dO * O [B, H, S] (both fp32), an optional additive key bias [B, S]
// fp32 and an optional causal mask, with s = q k^T * scale + bias (causal:
// -1e30 above the diagonal), p = exp(s - lse) and dz = p * (dO v^T - delta):
//   dkdv: dK = dz^T (q * scale), dV = p^T dO   in k's / v's dtype
//         dbh = sum over queries of dz        fp32 [B, H, S] (per-head bias grad)
//   dq:   dQ = (dz k) * scale                 in q's dtype
// Keys past S are never read and queries past S never contribute, so no
// padded copies are made; the results equal the TPU wrapper's, which pads S
// to 128 with a -1e30 key bias and zero dO rows.
//
// What bounds it on the H100: operations. Per (query, key) pair dK/dV does
// four D-long dot products or updates (q.k, dO.v, dV += p dO, dK += dz q) and
// dQ three (q.k, dO.v, dQ += dz k): at [8, 12, 2048, 64] bf16 that is ~206
// and ~155 GFLOP, bounds of ~0.21 ms and ~0.16 ms on the tensor cores at
// 989 TFLOP/s.
//
// Both run on the tensor cores in bf16 (flash_bwd_dkdv_wgmma_kernel and
// flash_bwd_dq_wgmma_kernel), with one shape. A block has three warpgroups;
// warpgroup 2 is the producer: one of its warps loads the block's own rows
// once and then streams tiles of the other side's rows by TMA (one box per
// 8 columns, wgmma's no-swizzle core-matrix layout; rows past S read as
// zeros) into a ring of two shared-memory stages with full/empty mbarriers,
// staging each tile's per-row values beside them. Warpgroups 0 and 1 each
// own 64 of the block's rows and compute two products by wgmma m64n64k16
// (bf16 in, fp32 accumulate, all operands K-major), so that the 64 x 64
// probabilities and their gradient sit in registers in the accumulator
// layout, which is the A-fragment layout of the next products (wgmma
// m64n{D}k16 with the streamed tile read as an MN-major operand, the
// transpose bit). P and dS keep fp32 accuracy: each is split into bf16 hi
// and lo parts (hi = bf16(x), lo = bf16(x - hi)) whose two products go into
// one fp32 accumulator (~2^-17 relative), at 1.5x (dK/dV) or 2x (dQ, whose
// only register operand is dS) the tensor work of bf16 operands. The scale
// applies in the epilogue.
//   dK/dV: one block per (batch, head, 128 keys); the producer loads K and V
//   once and streams 64-query tiles of Q and dO with their lse and delta.
//   The consumers compute the transposed products S^T = K Q^T and
//   dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q. The key bias is per
//   row, lse and delta per column, and dbh is a row sum kept in registers
//   across the query loop. Under the causal mask a block starts at the
//   first query tile that sees its keys.
//   dQ: the mirror image, one block per (batch, head, 128 queries); the
//   producer loads Q and dO once and streams 64-key tiles of K and V with
//   their key bias. The consumers compute S = Q K^T and dP = dO V^T, keep
//   lse and delta per row in registers, and take dQ += dS K. Under the
//   causal mask a block stops at the last key tile its queries can see.
// The TMA loads need 16-byte aligned bases and row strides; the wrapper
// makes contiguous copies of views that are not. Per 64 x 64 tile pair a
// dK/dV warpgroup issues six products of D-deep or 64-deep bf16 work (two,
// then two split pairs) and a dQ warpgroup four (two, then one split pair),
// so dQ's tensor work is 2/3 of dK/dV's.
//
// fp32 (both kernels) keeps the first, plain SIMT versions: fp32 runs on no
// main path. One 128-thread block per (batch, head, 64-row tile) of the rows
// it owns: keys for dK/dV, queries for dQ. Two threads own each row, each
// one half of its D columns, so a thread keeps only half rows in registers
// (dK/dV: k, v, dK, dV = 2 * D floats; dQ: q, dO, dQ = 1.5 * D) and stays
// clear of the 255-register limit; the pair joins its two half dot products
// with one shuffle. The streamed rows (q and dO for dK/dV, k and v for dQ)
// are staged 64 at a time in shared memory as fp32; every thread of a warp
// reads the same row there, and the two halves of a pair own alternate
// 16-byte chunks, so the reads are broadcasts without bank conflicts. The
// [S, S] scores never exist in memory. Under the causal mask dK/dV starts
// at the first query tile that can see its keys and dQ stops at the last key
// tile its queries can see.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

constexpr int kRows = 64;             // rows a block owns
constexpr int kThreads = 2 * kRows;   // two threads per row
constexpr int kTile = 64;             // streamed rows per shared-memory tile
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }

struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// A thread owns the 4-wide chunks c = 2 * t + half (t < D / 8) of a row:
// element 4 * c + e sits at index 4 * t + e of its half row.
template <typename T, int D>
__device__ __forceinline__ void load_half(const T* row, int half, float scale, float* out) {
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const int c = 2 * t + half;
#pragma unroll
    for (int e = 0; e < 4; ++e) out[4 * t + e] = to_f(row[4 * c + e]) * scale;
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_half(T* row, int half, float scale, const float* in) {
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const int c = 2 * t + half;
#pragma unroll
    for (int e = 0; e < 4; ++e) from_f(row + 4 * c + e, in[4 * t + e] * scale);
  }
}

// this thread's half of dot(smem row, the full row whose half is r)
template <int D>
__device__ __forceinline__ float half_dot(const float* srow, int half, const float* r) {
  const float4* p = reinterpret_cast<const float4*>(srow);
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const float4 x = p[2 * t + half];
    acc = fmaf(r[4 * t], x.x, acc);
    acc = fmaf(r[4 * t + 1], x.y, acc);
    acc = fmaf(r[4 * t + 2], x.z, acc);
    acc = fmaf(r[4 * t + 3], x.w, acc);
  }
  return acc;
}

// acc (this thread's half) += a * smem row
template <int D>
__device__ __forceinline__ void half_axpy(const float* srow, int half, float a, float* acc) {
  const float4* p = reinterpret_cast<const float4*>(srow);
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const float4 x = p[2 * t + half];
    acc[4 * t] = fmaf(a, x.x, acc[4 * t]);
    acc[4 * t + 1] = fmaf(a, x.y, acc[4 * t + 1]);
    acc[4 * t + 2] = fmaf(a, x.z, acc[4 * t + 2]);
    acc[4 * t + 3] = fmaf(a, x.w, acc[4 * t + 3]);
  }
}

// both threads of a pair sit in one warp (lanes 2r, 2r + 1)
__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

// One block per (batch * head, 64-key tile); loops over query tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ bias, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dbh, int H,
                      int S, Strides st, float scale, int causal) {
  __shared__ __align__(16) float qs_t[kTile * D];  // q * scale
  __shared__ __align__(16) float do_t[kTile * D];
  __shared__ float lse_t[kTile];
  __shared__ float dl_t[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const int k0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int kj = k0 + (tid >> 1);
  const bool row_ok = kj < S;
  // keys past S compute on key S-1 and store nothing
  const int64_t kr = row_ok ? kj : S - 1;

  float kreg[D / 2], vreg[D / 2], dka[D / 2], dva[D / 2];
  load_half<T, D>(k + b * st.kb + hh * st.kh + kr * st.ks, half, 1.f, kreg);
  load_half<T, D>(v + b * st.vb + hh * st.vh + kr * st.vs, half, 1.f, vreg);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float db = 0.f;
  const float bj = bias == nullptr ? 0.f : bias[static_cast<int64_t>(b) * S + kr];

  const T* qbase = q + b * st.qb + hh * st.qh;
  const T* obase = dout + b * st.ob + hh * st.oh;
  const int64_t rows = static_cast<int64_t>(bh) * S;
  // causal: queries before k0 see none of this block's keys
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += kTile) {
    const int nq = min(kTile, S - q0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < nq * D; idx += kThreads) {
      const int64_t qi = q0 + idx / D;
      const int c = idx % D;
      qs_t[idx] = to_f(qbase[qi * st.qs + c]) * scale;
      do_t[idx] = to_f(obase[qi * st.os + c]);
    }
    for (int r = tid; r < nq; r += kThreads) {
      lse_t[r] = lse[rows + q0 + r];
      dl_t[r] = delta[rows + q0 + r];
    }
    __syncthreads();
    for (int i = 0; i < nq; ++i) {
      float s = pair_sum(half_dot<D>(qs_t + i * D, half, kreg)) + bj;
      if (causal && kj > q0 + i) s = kMaskValue;
      const float p = expf(s - lse_t[i]);
      const float dp = pair_sum(half_dot<D>(do_t + i * D, half, vreg));
      const float dz = p * (dp - dl_t[i]);
      half_axpy<D>(do_t + i * D, half, p, dva);
      half_axpy<D>(qs_t + i * D, half, dz, dka);
      db += dz;
    }
  }
  if (row_ok) {
    const int64_t row = (rows + kj) * D;
    store_half<T, D>(dk + row, half, 1.f, dka);
    store_half<T, D>(dv + row, half, 1.f, dva);
    if (half == 0) dbh[rows + kj] = db;
  }
}

// One block per (batch * head, 64-query tile); loops over key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int S, Strides st, float scale, int causal) {
  __shared__ __align__(16) float k_t[kTile * D];
  __shared__ __align__(16) float v_t[kTile * D];
  __shared__ float b_t[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int qi = q0 + (tid >> 1);
  const bool row_ok = qi < S;
  // queries past S compute on query S-1 and store nothing
  const int64_t qr = row_ok ? qi : S - 1;

  float qreg[D / 2], oreg[D / 2], acc[D / 2];
  load_half<T, D>(q + b * st.qb + hh * st.qh + qr * st.qs, half, scale, qreg);
  load_half<T, D>(dout + b * st.ob + hh * st.oh + qr * st.os, half, 1.f, oreg);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const int64_t rows = static_cast<int64_t>(bh) * S;
  const float l = lse[rows + qr];
  const float dl = delta[rows + qr];

  const T* kbase = k + b * st.kb + hh * st.kh;
  const T* vbase = v + b * st.vb + hh * st.vh;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<int64_t>(b) * S;
  // causal: no query of this block sees a key past its last row
  const int kend = causal ? min(S, q0 + kRows) : S;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    const int nk = min(kTile, kend - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < nk * D; idx += kThreads) {
      const int64_t kk = k0 + idx / D;
      const int c = idx % D;
      k_t[idx] = to_f(kbase[kk * st.ks + c]);
      v_t[idx] = to_f(vbase[kk * st.vs + c]);
    }
    for (int r = tid; r < nk; r += kThreads) b_t[r] = brow == nullptr ? 0.f : brow[k0 + r];
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float s = pair_sum(half_dot<D>(k_t + j * D, half, qreg)) + b_t[j];
      if (causal && k0 + j > qi) s = kMaskValue;
      const float p = expf(s - l);
      const float dp = pair_sum(half_dot<D>(v_t + j * D, half, oreg));
      half_axpy<D>(k_t + j * D, half, p * (dp - dl), acc);
    }
  }
  if (row_ok) store_half<T, D>(dq + (rows + qi) * D, half, scale, acc);
}

template <typename T, int D>
void launch_dkdv(dim3 grid, const void* q, const void* k, const void* v, const void* bias,
                 const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                 void* dbh, int H, int S, const Strides& st, float scale, int causal,
                 cudaStream_t stream) {
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(dbh), H, S, st, scale, causal);
}

template <typename T, int D>
void launch_dq(dim3 grid, const void* q, const void* k, const void* v, const void* bias,
               const void* dout, const void* lse, const void* delta, void* dq, int H, int S,
               const Strides& st, float scale, int causal, cudaStream_t stream) {
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq), H,
      S, st, scale, causal);
}

// ------------------------------------------------- bf16 dK/dV: tensor cores
constexpr int kTcKeys = 128;     // keys per block: two consumer warpgroups x 64
constexpr int kTcQ = 64;         // queries per streamed tile
constexpr int kTcStages = 2;     // Q/dO tiles in flight
constexpr int kTcThreads = 384;  // warpgroups 0, 1: consumers; 2: producer

template <int D>
struct DkdvSmem {
  __nv_bfloat16 k[kTcKeys * D];             // D/8 slices of [128 keys][8]
  __nv_bfloat16 v[kTcKeys * D];
  __nv_bfloat16 q[kTcStages][kTcQ * D];     // D/8 slices of [64 queries][8]
  __nv_bfloat16 dout[kTcStages][kTcQ * D];
  float lse[kTcStages][kTcQ];
  float delta[kTcStages][kTcQ];
  uint64_t full[kTcStages];
  uint64_t empty[kTcStages];
  uint64_t kvbar;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ bias, const float* __restrict__ lse,
                            const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, float* __restrict__ dbh, int H,
                            int S, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DkdvSmem<D>& sm = *reinterpret_cast<DkdvSmem<D>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const int k0 = blockIdx.x * kTcKeys;
  // causal: queries before k0 see none of this block's keys
  const int t0 = causal ? k0 / kTcQ : 0;
  const int ntiles = (S + kTcQ - 1) / kTcQ - t0;
  const int64_t rows = static_cast<int64_t>(bh) * S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      tc::mbar_init(&sm.full[s], 32);  // the producer warp's lanes
      tc::mbar_init(&sm.empty[s], 8);  // one lane of each consumer warp
    }
    tc::mbar_init(&sm.kvbar, 1);
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: K and V once, then Q, dO, lse and delta tiles
    tc::setmaxnreg_dec<40>();
    if (warp == 0) {
      if (lane == 0) {
        tc::mbar_arrive_expect_tx(&sm.kvbar, 2 * kTcKeys * D * 2);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          tc::tma_load_4d(sm.k + c * kTcKeys * 8, &tk, &sm.kvbar, 8 * c, k0, hh, b);
          tc::tma_load_4d(sm.v + c * kTcKeys * 8, &tv, &sm.kvbar, 8 * c, k0, hh, b);
        }
      }
      for (int u = 0; u < ntiles; ++u) {
        const int s = u % kTcStages;
        tc::mbar_wait(&sm.empty[s], ((u / kTcStages) & 1) ^ 1);
        const int q0 = (t0 + u) * kTcQ;
#pragma unroll
        for (int i = 0; i < kTcQ / 32; ++i) {
          const int j = lane + 32 * i;
          const bool ok = q0 + j < S;
          sm.lse[s][j] = ok ? lse[rows + q0 + j] : 0.f;
          sm.delta[s][j] = ok ? delta[rows + q0 + j] : 0.f;
        }
        if (lane == 0) {
          tc::mbar_arrive_expect_tx(&sm.full[s], 2 * kTcQ * D * 2);
#pragma unroll
          for (int c = 0; c < D / 8; ++c) {
            tc::tma_load_4d(sm.q[s] + c * kTcQ * 8, &tq, &sm.full[s], 8 * c, q0, hh, b);
            tc::tma_load_4d(sm.dout[s] + c * kTcQ * 8, &tdo, &sm.full[s], 8 * c, q0, hh, b);
          }
        } else {
          tc::mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63, as rows of
    // the transposed products S^T = K Q^T and dP^T = V dO^T
    tc::setmaxnreg_inc<232>();
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int key_a = k0 + 64 * wg + 16 * warp + g;  // elements 4j+0,1; key_a + 8: 4j+2,3
    float bk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = key_a + 8 * r;
      bk[r] = (bias != nullptr && kj < S) ? bias[static_cast<int64_t>(b) * S + kj] : 0.f;
    }
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    float db[2] = {0.f, 0.f};
    const float kLog2e = 1.4426950408889634f;
    const uint32_t kaddr = tc::smem_u32(sm.k) + 64 * wg * 16;
    const uint32_t vaddr = tc::smem_u32(sm.v) + 64 * wg * 16;
    tc::mbar_wait(&sm.kvbar, 0);

    for (int u = 0; u < ntiles; ++u) {
      const int s = u % kTcStages;
      tc::mbar_wait(&sm.full[s], (u / kTcStages) & 1);
      const uint32_t qaddr = tc::smem_u32(sm.q[s]);
      const uint32_t oaddr = tc::smem_u32(sm.dout[s]);

      // S^T = K Q^T and dP^T = V dO^T: k16 steps over D, both operands K-major
      float st[kTcQ / 2], dpt[kTcQ / 2];
#pragma unroll
      for (int i = 0; i < kTcQ / 2; ++i) st[i] = dpt[i] = 0.f;
      tc::wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint64_t dkk = tc::make_desc(kaddr + kd * 2 * kTcKeys * 16, kTcKeys * 16, 128);
        const uint64_t dq = tc::make_desc(qaddr + kd * 2 * kTcQ * 16, kTcQ * 16, 128);
        tc::wgmma_ss(st, dkk, dq, kd > 0);
      }
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint64_t dvv = tc::make_desc(vaddr + kd * 2 * kTcKeys * 16, kTcKeys * 16, 128);
        const uint64_t ddo = tc::make_desc(oaddr + kd * 2 * kTcQ * 16, kTcQ * 16, 128);
        tc::wgmma_ss(dpt, dvv, ddo, kd > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(st);
      tc::fence_regs(dpt);

      // P^T = exp(s - lse) and dS^T = P^T * (dP^T - delta): the key bias per
      // row, lse and delta per column
      const int q0 = (t0 + u) * kTcQ;
#pragma unroll
      for (int j = 0; j < kTcQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const int qi = q0 + col;
          const int r = e >> 1;
          float sv = st[4 * j + e] * scale + bk[r];
          if (causal && key_a + 8 * r > qi) sv = kMaskValue;
          const float p = qi < S ? exp2f((sv - sm.lse[s][col]) * kLog2e) : 0.f;
          const float ds = p * (dpt[4 * j + e] - sm.delta[s][col]);
          st[4 * j + e] = p;
          dpt[4 * j + e] = ds;
          db[r] += ds;
        }
      }
      uint32_t phi[kTcQ / 16][4], plo[kTcQ / 16][4], shi[kTcQ / 16][4], slo[kTcQ / 16][4];
#pragma unroll
      for (int c = 0; c < kTcQ / 16; ++c)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          tc::split_bf16(st[8 * c + 2 * x], st[8 * c + 2 * x + 1], phi[c][x], plo[c][x]);
          tc::split_bf16(dpt[8 * c + 2 * x], dpt[8 * c + 2 * x + 1], shi[c][x], slo[c][x]);
        }

      // dV += P^T dO and dK += dS^T Q: k16 steps over the tile's queries;
      // dO and Q read MN-major
      tc::wgmma_fence();
#pragma unroll
      for (int c = 0; c < kTcQ / 16; ++c) {
        const uint64_t ddo = tc::make_desc(oaddr + c * 16 * 16, 128, kTcQ * 16);
        tc::wgmma_rs(dva, phi[c], ddo);
        tc::wgmma_rs(dva, plo[c], ddo);
      }
#pragma unroll
      for (int c = 0; c < kTcQ / 16; ++c) {
        const uint64_t dq = tc::make_desc(qaddr + c * 16 * 16, 128, kTcQ * 16);
        tc::wgmma_rs(dka, shi[c], dq);
        tc::wgmma_rs(dka, slo[c], dq);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(dva);
      tc::fence_regs(dka);
      tc::fence_regs(phi);
      tc::fence_regs(plo);
      tc::fence_regs(shi);
      tc::fence_regs(slo);
      if (lane == 0) tc::mbar_arrive(&sm.empty[s]);
    }

    // epilogue: dK = (dS^T Q) * scale and dV in bf16, dbh = the row sums
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
      db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = key_a + 8 * r;
      if (kj >= S) continue;
      const int64_t row = rows + kj;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int64_t at = row * D + 8 * j + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
            dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
      if (t4 == 0) dbh[row] = db[r];
    }
  }
}

template <int D>
cudaError_t launch_dkdv_wgmma(const void* q, const void* k, const void* v, const void* bias,
                              const void* dout, const void* lse, const void* delta, void* dk,
                              void* dv, void* dbh, int B, int H, int S, const Strides& st,
                              float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!tc_host::encode_heads(&tq, q, B, H, S, D, st.qb, st.qh, st.qs, kTcQ) ||
      !tc_host::encode_heads(&tk, k, B, H, S, D, st.kb, st.kh, st.ks, kTcKeys) ||
      !tc_host::encode_heads(&tv, v, B, H, S, D, st.vb, st.vh, st.vs, kTcKeys) ||
      !tc_host::encode_heads(&tdo, dout, B, H, S, D, st.ob, st.oh, st.os, kTcQ))
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(DkdvSmem<D>));
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTcKeys - 1) / kTcKeys, B * H);
  flash_bwd_dkdv_wgmma_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(dbh), H, S, scale, causal);
  return cudaGetLastError();
}

// --------------------------------------------------- bf16 dQ: tensor cores
constexpr int kTcQRows = 128;    // queries per block: two consumer warpgroups x 64
constexpr int kTcK = 64;         // keys per streamed tile

template <int D>
struct DqSmem {
  __nv_bfloat16 q[kTcQRows * D];            // D/8 slices of [128 queries][8]
  __nv_bfloat16 dout[kTcQRows * D];
  __nv_bfloat16 k[kTcStages][kTcK * D];     // D/8 slices of [64 keys][8]
  __nv_bfloat16 v[kTcStages][kTcK * D];
  float bias[kTcStages][kTcK];
  uint64_t full[kTcStages];
  uint64_t empty[kTcStages];
  uint64_t qbar;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ bias, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                          int H, int S, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_raw);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hh = bh % H;
  const int q0 = blockIdx.x * kTcQRows;
  // causal: no query of this block sees a key past its last row
  const int kend = causal ? min(S, q0 + kTcQRows) : S;
  const int ntiles = (kend + kTcK - 1) / kTcK;
  const int64_t rows = static_cast<int64_t>(bh) * S;
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
    // ---- producer: Q and dO once, then K, V and key-bias tiles
    tc::setmaxnreg_dec<40>();
    if (warp == 0) {
      if (lane == 0) {
        tc::mbar_arrive_expect_tx(&sm.qbar, 2 * kTcQRows * D * 2);
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          tc::tma_load_4d(sm.q + c * kTcQRows * 8, &tq, &sm.qbar, 8 * c, q0, hh, b);
          tc::tma_load_4d(sm.dout + c * kTcQRows * 8, &tdo, &sm.qbar, 8 * c, q0, hh, b);
        }
      }
      for (int u = 0; u < ntiles; ++u) {
        const int s = u % kTcStages;
        tc::mbar_wait(&sm.empty[s], ((u / kTcStages) & 1) ^ 1);
        const int k0 = u * kTcK;
#pragma unroll
        for (int i = 0; i < kTcK / 32; ++i) {
          const int j = lane + 32 * i;
          sm.bias[s][j] = (bias != nullptr && k0 + j < S)
                              ? bias[static_cast<int64_t>(b) * S + k0 + j]
                              : 0.f;
        }
        if (lane == 0) {
          tc::mbar_arrive_expect_tx(&sm.full[s], 2 * kTcK * D * 2);
#pragma unroll
          for (int c = 0; c < D / 8; ++c) {
            tc::tma_load_4d(sm.k[s] + c * kTcK * 8, &tk, &sm.full[s], 8 * c, k0, hh, b);
            tc::tma_load_4d(sm.v[s] + c * kTcK * 8, &tv, &sm.full[s], 8 * c, k0, hh, b);
          }
        } else {
          tc::mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns queries q0 + 64 wg .. + 63, as rows
    // of S = Q K^T and dP = dO V^T
    tc::setmaxnreg_inc<232>();
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int q_a = q0 + 64 * wg + 16 * warp + g;  // elements 4j+0,1; q_a + 8: 4j+2,3
    float lr[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q_a + 8 * r;
      lr[r] = qi < S ? lse[rows + qi] : 0.f;
      dl[r] = qi < S ? delta[rows + qi] : 0.f;
    }
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    const float kLog2e = 1.4426950408889634f;
    const uint32_t qaddr = tc::smem_u32(sm.q) + 64 * wg * 16;
    const uint32_t oaddr = tc::smem_u32(sm.dout) + 64 * wg * 16;
    tc::mbar_wait(&sm.qbar, 0);

    for (int u = 0; u < ntiles; ++u) {
      const int s = u % kTcStages;
      tc::mbar_wait(&sm.full[s], (u / kTcStages) & 1);
      const uint32_t kaddr = tc::smem_u32(sm.k[s]);
      const uint32_t vaddr = tc::smem_u32(sm.v[s]);

      // S = Q K^T and dP = dO V^T: k16 steps over D, both operands K-major
      float sc[kTcK / 2], dp[kTcK / 2];
#pragma unroll
      for (int i = 0; i < kTcK / 2; ++i) sc[i] = dp[i] = 0.f;
      tc::wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint64_t da = tc::make_desc(qaddr + kd * 2 * kTcQRows * 16, kTcQRows * 16, 128);
        const uint64_t db = tc::make_desc(kaddr + kd * 2 * kTcK * 16, kTcK * 16, 128);
        tc::wgmma_ss(sc, da, db, kd > 0);
      }
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint64_t da = tc::make_desc(oaddr + kd * 2 * kTcQRows * 16, kTcQRows * 16, 128);
        const uint64_t db = tc::make_desc(vaddr + kd * 2 * kTcK * 16, kTcK * 16, 128);
        tc::wgmma_ss(dp, da, db, kd > 0);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(sc);
      tc::fence_regs(dp);

      // P = exp(s - lse) and dS = P * (dP - delta): the key bias per column,
      // lse and delta per row
      const int k0 = u * kTcK;
#pragma unroll
      for (int j = 0; j < kTcK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const int kj = k0 + col;
          const int r = e >> 1;
          float sv = sc[4 * j + e] * scale + sm.bias[s][col];
          if (causal && kj > q_a + 8 * r) sv = kMaskValue;
          const float p = kj < S ? exp2f((sv - lr[r]) * kLog2e) : 0.f;
          dp[4 * j + e] = p * (dp[4 * j + e] - dl[r]);
        }
      }
      uint32_t shi[kTcK / 16][4], slo[kTcK / 16][4];
#pragma unroll
      for (int c = 0; c < kTcK / 16; ++c)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          tc::split_bf16(dp[8 * c + 2 * x], dp[8 * c + 2 * x + 1], shi[c][x], slo[c][x]);

      // dQ += dS K: k16 steps over the tile's keys; K read MN-major
      tc::wgmma_fence();
#pragma unroll
      for (int c = 0; c < kTcK / 16; ++c) {
        const uint64_t dk = tc::make_desc(kaddr + c * 16 * 16, 128, kTcK * 16);
        tc::wgmma_rs(dqa, shi[c], dk);
        tc::wgmma_rs(dqa, slo[c], dk);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(dqa);
      tc::fence_regs(shi);
      tc::fence_regs(slo);
      if (lane == 0) tc::mbar_arrive(&sm.empty[s]);
    }

    // epilogue: dQ = (dS K) * scale in bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q_a + 8 * r;
      if (qi >= S) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int64_t at = (rows + qi) * D + 8 * j + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(dq + at) = __floats2bfloat162_rn(
            dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
      }
    }
  }
}

template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* bias,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            int B, int H, int S, const Strides& st, float scale, int causal,
                            cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!tc_host::encode_heads(&tq, q, B, H, S, D, st.qb, st.qh, st.qs, kTcQRows) ||
      !tc_host::encode_heads(&tk, k, B, H, S, D, st.kb, st.kh, st.ks, kTcK) ||
      !tc_host::encode_heads(&tv, v, B, H, S, D, st.vb, st.vh, st.vs, kTcK) ||
      !tc_host::encode_heads(&tdo, dout, B, H, S, D, st.ob, st.oh, st.os, kTcQRows))
    return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(DqSmem<D>));
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTcQRows - 1) / kTcQRows, B * H);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H, S, scale, causal);
  return cudaGetLastError();
}

// -1: arguments the kernels do not take; 0: nothing to do; 1: launch
int check_args(int B, int H, int S, int D, int dtype) {
  if (B < 0 || H < 0 || S < 0 || static_cast<int64_t>(B) * H > 65535) return -1;
  if (D != 16 && D != 32 && D != 64) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  return (B == 0 || H == 0 || S == 0) ? 0 : 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D in {16, 32, 64}; q/k/v/dO strides in
// elements over (B, H, S), unit stride over D; bias [B, S] fp32 contiguous or
// null; lse, delta, dbh [B, H, S] fp32 and dk, dv [B, H, S, D] contiguous.
// B * H <= 65535. bf16 (TMA): base pointers and the strides over B, H and S
// in multiples of 16 bytes. Returns the cudaError_t of the launch (0 =
// accepted).
extern "C" int pt_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* bias, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* dbh, int B, int H, int S,
    int D, int64_t qb, int64_t qh, int64_t qs, int64_t kb, int64_t kh, int64_t ks, int64_t vb,
    int64_t vh, int64_t vs, int64_t ob, int64_t oh, int64_t os, float scale, int causal,
    int dtype, void* stream) {
  const int ok = check_args(B, H, S, D, dtype);
  if (ok <= 0) return ok == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
#define PT_DKDV(DD)                                                                          \
  launch_dkdv_wgmma<DD>(q, k, v, bias, dout, lse, delta, dk, dv, dbh, B, H, S, st, scale, \
                        causal, s)
    const cudaError_t err = D == 16 ? PT_DKDV(16) : D == 32 ? PT_DKDV(32) : PT_DKDV(64);
#undef PT_DKDV
    return static_cast<int>(err);
  }
  const dim3 grid((S + kRows - 1) / kRows, B * H);
#define PT_DKDV(DD) \
  launch_dkdv<float, DD>(grid, q, k, v, bias, dout, lse, delta, dk, dv, dbh, H, S, st, scale, causal, s)
  if (D == 16) PT_DKDV(16);
  else if (D == 32) PT_DKDV(32);
  else PT_DKDV(64);
#undef PT_DKDV
  return static_cast<int>(cudaGetLastError());
}

// The same layout as pt_flash_attention_bwd_dkdv; dq [B, H, S, D] contiguous.
extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int S, int D, int64_t qb,
    int64_t qh, int64_t qs, int64_t kb, int64_t kh, int64_t ks, int64_t vb, int64_t vh,
    int64_t vs, int64_t ob, int64_t oh, int64_t os, float scale, int causal, int dtype,
    void* stream) {
  const int ok = check_args(B, H, S, D, dtype);
  if (ok <= 0) return ok == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
#define PT_DQ(DD) \
  launch_dq_wgmma<DD>(q, k, v, bias, dout, lse, delta, dq, B, H, S, st, scale, causal, s)
    const cudaError_t err = D == 16 ? PT_DQ(16) : D == 32 ? PT_DQ(32) : PT_DQ(64);
#undef PT_DQ
    return static_cast<int>(err);
  }
  const dim3 grid((S + kRows - 1) / kRows, B * H);
#define PT_DQ(DD) \
  launch_dq<float, DD>(grid, q, k, v, bias, dout, lse, delta, dq, H, S, st, scale, causal, s)
  if (D == 16) PT_DQ(16);
  else if (D == 32) PT_DQ(32);
  else PT_DQ(64);
#undef PT_DQ
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
