// Fused matmul + bias + activation for Hopper (sm_90a): out = act(x @ w + bias), and its
// weight-only int8 form out = act(x @ (w_int8 * scale / 127) + bias).
//
// Replaces: paddle_tpu/ops/pallas/matmul.py:_fmm_kernel (via _fmm_call), registry names
// "fused_matmul" (dequant=False) and "fused_matmul_int8" (dequant=True, the dequant at
// :80-82). The static graph's fuse_matmul_bias_act pass folds layers.fc's mul + elementwise_add
// + act into one fused_matmul op, whose compute lands here; a program rewritten by the
// weight-only PTQ pass (apply_weight_quant, the int8 serving path) carries quant="int8" on that
// op and lands in the int8 entry.
//
// What it computes: x [M, K] (fp32 or bf16, row-major) times w [K, N] (fp32, bf16 or int8,
// row-major), summed in fp32, plus an fp32 bias [N] when given, then relu, sigmoid, tanh or
// nothing, written as fp32 [M, N]. Like the TPU kernel, the epilogue runs on the fp32 sum;
// gelu and the cast to the caller's dtype stay outside (the wrapper). With an int8 w, each
// column's sum is multiplied by scale[n] / 127 in the epilogue, before the bias: the scale is
// per output column, so applying it once to the sum equals applying it to every weight up to
// rounding (one multiply per output, not per multiply-add), and the fp32 weight never exists
// in device memory.
//
// What bounds it on the H100: operations, where the product is fp32-accurate. The least
// time the card takes for one: fp32 x fp32 takes three TF32 passes (165 TFLOP/s). A bf16
// operand, or an int8 weight (|q| <= 127), is exact in bf16 and an fp32 one splits exactly
// into three bf16 pieces, so with one such side the bf16 tensor cores take three passes
// (989 / 3 = 330 TFLOP/s) for fp32 x and one (989) for bf16 x. BERT's FFN
// [4096,768]x[768,3072] (19.3 GFLOP) is bound at 117 us in fp32 and at 59 us with an int8
// w; word2vec's [100,256]x[256,2073] (106 MFLOP, 3.1 MB moved) at 0.91 us by bytes, and
// [8192,256]x[256,2073] at 52.7 us. The served micro-batches ([1|8,256]x[256,256], 1 MFLOP
// over 0.3 MB) are bound by latency: what counts there is the number of dependent steps.
//
// What the design does about it (fused_matmul_wgmma_kernel, every entry): the products run
// on the tensor cores in TF32 (wgmma m64nNk8), with the accuracy of fp32. Each fp32 operand
// is split into hi = tf32(v) and lo = tf32(v - hi) (rounded to nearest: wgmma would
// truncate), and each k8 step takes a_hi b_hi + a_hi b_lo + a_lo b_hi into one fp32
// accumulator; the missing a_lo b_lo and the rounding of lo are ~2^-22 of each product, the
// error of an fp32 sum. A bf16 operand is exact in TF32 and has no lo part, and so is an
// int8 weight (|q| <= 127): fp32 x bf16 and fp32 x int8 take two passes, bf16 x bf16 and
// bf16 x int8 one (at 495, where the bound's bf16 passes run at 989). An int8 weight is read
// as bytes (rows of 10 or 2,073 bytes need no padded copy), converted to fp32 where it is
// split, and its scale multiplies each column's fp32 sum in the epilogue, before the bias.
// A value that is inf or NaN keeps it in hi (pass one
// gives inf * w what the fp32 product gives) and has lo = 0; the cross passes read a copy of
// hi with such values zeroed ("hif"), since inf * a lo of 0 would be NaN and inf * a lo of
// the other sign would cancel pass one's inf. TF32 wgmma reads only K-major operands from
// shared memory, so the kernel computes out^T = w^T x^T ("swap AB"): the weight's N runs
// along wgmma's 64 rows and the batch M along wgmma's n (8 to 128), so word2vec's M = 100 at
// N = 2073 and the served M of 1 to 8 waste nothing on the 64-row side.
//   Neither operand goes through TMA: word2vec's w rows are 8,292 bytes and the ragged case's
// x rows 280, aligned to no 16 bytes, and a padded copy of a weight that training changes
// every step would cost more than the product. A block has two consumer warpgroups and a
// producer warpgroup. The consumers load w's A fragments straight from device memory into
// registers (the TF32 A-from-registers form of wgmma), two 16-deep k-slices ahead, and split
// them there; neighbouring lanes read neighbouring columns of w. The producer's four warps
// take x's 16-deep slices in turn: each loads its slice (16-byte loads where x's rows are
// aligned, else 4-byte ones, masked at the edges), splits it and stores hi, hif and lo in
// wgmma's core-matrix layout (one 16-byte store per 4 values, neighbouring lanes on
// neighbouring rows: no bank conflicts) into a ring of six stages, with full/empty mbarriers
// between producer and consumers. The split values reach wgmma through a proxy fence, which
// waits for every load its thread has in flight; a warp of the producer fences only its own
// slice, so four slices stay in flight while the consumers' loads never meet a fence. A
// consumer waits for the products of a k8 step only two steps later, so the tensor cores see
// the next group before the last one drains. Where 128-row slabs of x give half the card's
// SMs a block, the two consumers own 64 rows of w^T each and share the slab (128 x 128
// tiles); with narrower slabs they share 64 rows and take alternate k-slices, halving the
// chain of dependent steps, and add their sums in a fixed order at the end. The bias and the
// activation run on the fp32 accumulators before the one store. NaN behaviour follows
// activate<> below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tc.cuh"

namespace {

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3 };

constexpr float kQuantBins = 127.f;  // int8 per-channel abs-max: w = q * scale / 127

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == kRelu) return v < 0.f ? 0.f : v;  // NaN stays NaN, as jnp.maximum(v, 0)
  if (ACT == kSigmoid) return 1.f / (1.f + expf(-v));
  if (ACT == kTanh) return tanhf(v);
  return v;
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return activate<kRelu>(v);
    case kSigmoid: return activate<kSigmoid>(v);
    case kTanh: return activate<kTanh>(v);
    default: return v;
  }
}

// ------------------------------------------------------------ tensor cores
constexpr int kTcBK = 16;       // k per slice: two TF32 k8 steps
constexpr int kTcStages = 6;    // shared-memory stages of split x slices
constexpr int kTcAhead = 2;     // slices of w a consumer thread has in flight
constexpr int kTcProducers = 4; // producer warps, one slice each at a time

// The largest finite TF32 value: hi of a finite value that rounds past it.
constexpr uint32_t kMaxTf32Bits = 0x7f7fe000u;

// v as TF32 hi, hi with inf and NaN zeroed (hif) and lo = tf32(v - hi) (0
// where v is not finite, or where the operand has no lo part).
template <bool LO>
__device__ __forceinline__ void split_tf32(float v, float& hi, float& hif, float& lo) {
  hi = tc::round_tf32(v);
  const bool finite = fabsf(v) <= 3.402823466e38f;
  if (finite && !(fabsf(hi) <= 3.402823466e38f))  // rounded past the largest TF32
    hi = copysignf(__uint_as_float(kMaxTf32Bits), v);
  hif = finite ? hi : 0.f;
  lo = (LO && finite) ? tc::round_tf32(v - hi) : 0.f;
}

// A block has two consumer warpgroups and a producer warpgroup. With 128
// rows of x (BN = 128) the consumers own 64 rows of w^T each and read every
// slice; with fewer, they share 64 rows of w^T and take alternate k-slices,
// adding their sums at the end (in a fixed order). x [BN rows][16] of a slice
// lies in shared memory as kTcBK / 4 slices of [BN][4] fp32 per copy; hi,
// then hif where w has a lo part, then lo where x has one. w's fragments live
// in the consumers' registers.
template <int BN, bool LO_A, bool LO_B>
struct FmmTile {
  static constexpr int kThreads = 384;
  static constexpr int kRowGroups = BN == 128 ? 2 : 1;  // 64-row groups of w^T a block
  static constexpr int kKSplit = 2 / kRowGroups;        // consumers sharing a row group
  static constexpr int kCopiesA = 1 + LO_B + LO_A;  // w: hi, hif, lo
  static constexpr int kHifCopyA = 1, kLoCopyA = 1 + LO_B;
  static constexpr int kCopiesB = 1 + LO_A + LO_B;  // x: hi, hif, lo
  static constexpr int kHifCopyB = 1, kLoCopyB = 1 + LO_A;
  static constexpr int kCopyFloats = BN * kTcBK;
  static constexpr int kStageFloats = kCopiesB * kCopyFloats;
  static constexpr int kTasks = BN * (kTcBK / 4) / 32;  // 4-value chunks a producer lane
  // chunks loaded before the first is split: all of them, but for bf16 x,
  // whose scalar loads would not fit the producer's registers, half
  static constexpr int kTaskGroup = LO_B || kTasks < 16 ? kTasks : kTasks / 2;
  static constexpr int kSmemBytes = kTcStages * (kStageFloats * 4 + 16);
};

// Stores one 4-value chunk of x, split, at row r of column slice c.
template <bool LO, bool HIF>
__device__ __forceinline__ void store_chunk(float* base, int copy_floats, int hif_copy,
                                            int lo_copy, int rows, int r, int c,
                                            const float (&v)[4]) {
  float4 hi, hif, lo;
  split_tf32<LO>(v[0], hi.x, hif.x, lo.x);
  split_tf32<LO>(v[1], hi.y, hif.y, lo.y);
  split_tf32<LO>(v[2], hi.z, hif.z, lo.z);
  split_tf32<LO>(v[3], hi.w, hif.w, lo.w);
  const int at = (c * rows + r) * 4;
  *reinterpret_cast<float4*>(base + at) = hi;
  if constexpr (HIF) *reinterpret_cast<float4*>(base + hif_copy * copy_floats + at) = hif;
  if constexpr (LO) *reinterpret_cast<float4*>(base + lo_copy * copy_floats + at) = lo;
}

// Four elements of row m, columns k .. k + 3, of x [M, K] as loaded, zeros
// past M and K: fp32 bits; bf16 pairs in r[0] and r[1] when vec, else one
// bf16 in the low half of each r[j]. vec: rows are 16-byte (fp32) or 8-byte
// (bf16) aligned and K % 4 == 0. The conversion to fp32 (unpack_x4) waits for
// the load, so it runs only once every load of the slice is in flight.
__device__ __forceinline__ void load_x4(const float* x, int64_t m, int64_t k, int64_t M,
                                        int64_t K, bool vec, uint32_t (&r)[4]) {
  if (vec) {
    uint4 t = make_uint4(0u, 0u, 0u, 0u);
    if (m < M && k < K) t = __ldg(reinterpret_cast<const uint4*>(x + m * K + k));
    r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r[j] = 0u;
    if (m < M && k + j < K) r[j] = __float_as_uint(__ldg(x + m * K + k + j));
  }
}

__device__ __forceinline__ void load_x4(const __nv_bfloat16* x, int64_t m, int64_t k,
                                        int64_t M, int64_t K, bool vec, uint32_t (&r)[4]) {
  if (vec) {
    uint2 t = make_uint2(0u, 0u);
    if (m < M && k < K) t = __ldg(reinterpret_cast<const uint2*>(x + m * K + k));
    r[0] = t.x, r[1] = t.y, r[2] = r[3] = 0u;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r[j] = 0u;
    if (m < M && k + j < K) r[j] = __bfloat16_as_ushort(x[m * K + k + j]);
  }
}

template <typename TX>
__device__ __forceinline__ void unpack_x4(const uint32_t (&r)[4], bool vec, float (&v)[4]) {
  if constexpr (std::is_same<TX, float>::value) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __uint_as_float(r[j]);
  } else if (vec) {
    v[0] = __uint_as_float(r[0] << 16), v[1] = __uint_as_float(r[0] & 0xffff0000u);
    v[2] = __uint_as_float(r[1] << 16), v[3] = __uint_as_float(r[1] & 0xffff0000u);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __uint_as_float(r[j] << 16);
  }
}

// One element of w as loaded (fp32 bits, bf16 bits in the low half, or an
// int8's byte zero-extended: a load that widens nothing after it), and as
// fp32: the conversion waits for the load, so it runs only at the split.
__device__ __forceinline__ uint32_t load_bits(const float* p) { return __float_as_uint(__ldg(p)); }
__device__ __forceinline__ uint32_t load_bits(const __nv_bfloat16* p) {
  return __bfloat16_as_ushort(*p);
}
__device__ __forceinline__ uint32_t load_bits(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned char*>(p));
}
template <typename TW>
__device__ __forceinline__ float bits_to_f32(uint32_t b) {
  if constexpr (std::is_same<TW, float>::value) return __uint_as_float(b);
  if constexpr (std::is_same<TW, int8_t>::value)
    return static_cast<float>(static_cast<int8_t>(b & 0xffu));  // exact: |q| <= 127
  return __uint_as_float(b << 16);
}

// The two consumer warpgroups alone (the producer warpgroup may have exited).
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One block per (64 or 128 output columns, BN output rows): out^T = w^T x^T.
// An int8 w (TW = int8_t) takes scale [N]; the others take none.
template <typename TX, typename TW, int BN>
__global__ void __launch_bounds__(384, 1)
fused_matmul_wgmma_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          float* __restrict__ out, int64_t M, int64_t N, int64_t K, int act,
                          int x_vec) {
  constexpr bool kLoA = std::is_same<TW, float>::value;
  constexpr bool kDequant = std::is_same<TW, int8_t>::value;
  constexpr bool kLoB = std::is_same<TX, float>::value;
  using T = FmmTile<BN, kLoA, kLoB>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sb = reinterpret_cast<float*>(smem_raw);  // [stage][copy][chunk][row][4]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + kTcStages * T::kStageFloats * 4);
  uint64_t* empty = full + kTcStages;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * 64 * T::kRowGroups;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int nslices = static_cast<int>((K + kTcBK - 1) / kTcBK);

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      tc::mbar_init(&full[s], 32);         // the producing warp's lanes
      tc::mbar_init(&empty[s], 4 * T::kRowGroups);  // one lane of each warp reading it
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: warp p splits x's slices p, p + 4, ... into the ring; a
    // warp's fence waits only for its own slice's loads, and four warps keep
    // four slices in flight
    tc::setmaxnreg_dec<120>();
    const bool vec = x_vec != 0;
    const int r_lo = lane & 7, c = (lane >> 3) & 3;  // row r_lo + 8 i, column slice c
    for (int sl = warp; sl < nslices; sl += kTcProducers) {
      const int st = sl % kTcStages;
      tc::mbar_wait(&empty[st], ((sl / kTcStages) & 1) ^ 1);
      const int64_t k = static_cast<int64_t>(sl) * kTcBK + 4 * c;
      float* base = sb + st * T::kStageFloats;
#pragma unroll
      for (int h = 0; h < T::kTasks; h += T::kTaskGroup) {
        uint32_t raw[T::kTaskGroup][4];
#pragma unroll
        for (int i = 0; i < T::kTaskGroup; ++i)
          load_x4(x, m0 + r_lo + 8 * (h + i), k, M, K, vec, raw[i]);
#pragma unroll
        for (int i = 0; i < T::kTaskGroup; ++i) {
          float v[4];
          unpack_x4<TX>(raw[i], vec, v);
          store_chunk<kLoB, kLoA>(base, T::kCopyFloats, T::kHifCopyB, T::kLoCopyB, BN,
                                  r_lo + 8 * (h + i), c, v);
        }
      }
      tc::fence_proxy_async();
      tc::mbar_arrive(&full[st]);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows n0 + 64 rg .. + 63 of w^T and
  // the slices kpart, kpart + kKSplit, ...; it loads its A fragments itself,
  // kTcAhead of its slices ahead, into registers
  tc::setmaxnreg_inc<192>();
  const int rg = T::kRowGroups == 2 ? wg : 0;
  const int kpart = T::kKSplit == 2 ? wg : 0;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t na = n0 + 64 * rg + 16 * warp + g;  // fragment rows na and na + 8
  uint32_t raw[kTcAhead][kTcBK / 8][4];
  auto load_a = [&](int sl, uint32_t (&r)[kTcBK / 8][4]) {
#pragma unroll
    for (int kk = 0; kk < kTcBK / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t n = na + 8 * (e & 1);
        const int64_t k = static_cast<int64_t>(sl) * kTcBK + 8 * kk + t4 + 4 * (e >> 1);
        r[kk][e] = 0u;
        if (n < N && k < K) r[kk][e] = load_bits(w + k * N + n);
      }
  };
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kTcAhead; ++j)
    if (kpart + j * T::kKSplit < nslices) load_a(kpart + j * T::kKSplit, raw[j]);
  const uint32_t b0 = tc::smem_u32(sb);
  // A fragments of the two k8 steps of a slice; each is split while the
  // products of the step before it run, and overwritten only once the
  // products that read it are done
  uint32_t af[kTcBK / 8][T::kCopiesA][4] = {};
  // one k-slice: per k8 step, wait for the products two steps back, split
  // w's values (loaded kTcAhead of this warpgroup's slices ago) and issue the
  // passes with x's slice from the ring; then load w's slice kTcAhead on
  auto step = [&](int sl, uint32_t (&r)[kTcBK / 8][4]) {
    const int st = sl % kTcStages;
    tc::mbar_wait(&full[st], (sl / kTcStages) & 1);
    const uint32_t b = b0 + st * T::kStageFloats * 4;
#pragma unroll
    for (int kk = 0; kk < kTcBK / 8; ++kk) {
      tc::wgmma_wait<1>();  // the products that read af[kk] are done
      tc::fence_regs(af[kk]);
      // both k8 steps of this warpgroup's previous slice are done: its
      // stage is free
      if (kk == kTcBK / 8 - 1 && sl >= T::kKSplit && lane == 0)
        tc::mbar_arrive(&empty[(sl - T::kKSplit) % kTcStages]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float hi, hif, lo;
        split_tf32<kLoA>(bits_to_f32<TW>(r[kk][e]), hi, hif, lo);
        af[kk][0][e] = __float_as_uint(hi);
        if constexpr (kLoB) af[kk][T::kHifCopyA][e] = __float_as_uint(hif);
        if constexpr (kLoA) af[kk][T::kLoCopyA][e] = __float_as_uint(lo);
      }
      auto db = [&](int copy) {
        return tc::make_desc(b + copy * T::kCopyFloats * 4 + kk * 2 * BN * 16, BN * 16, 128);
      };
      tc::wgmma_fence();
      tc::wgmma_tf32(acc, af[kk][0], db(0));                                       // hi hi
      if constexpr (kLoB) tc::wgmma_tf32(acc, af[kk][T::kHifCopyA], db(T::kLoCopyB));  // hif lo
      if constexpr (kLoA) tc::wgmma_tf32(acc, af[kk][T::kLoCopyA], db(T::kHifCopyB));  // lo hif
      tc::wgmma_commit();
    }
    const int next = sl + kTcAhead * T::kKSplit;
    if (next < nslices) load_a(next, r);
  };
  for (int sl = kpart; sl < nslices; sl += kTcAhead * T::kKSplit) {
#pragma unroll
    for (int j = 0; j < kTcAhead; ++j)
      if (sl + j * T::kKSplit < nslices) step(sl + j * T::kKSplit, raw[j]);
  }
  tc::wgmma_wait_all();
  tc::fence_regs(acc);
  if constexpr (T::kKSplit == 2) {
    // warpgroup 1's sums join warpgroup 0's through the ring's memory, free
    // once both are done with their products
    float* red = sb + (tid & 127);
    consumer_barrier();
    if (kpart == 1) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) red[i * 128] = acc[i];
    }
    consumer_barrier();
    if (kpart == 1) return;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += red[i * 128];
  }

  // epilogue: accumulator row 16 warp + g (+ 8) is output column n, column
  // 8 j + 2 t4 (+ 1) is output row m; an int8 w's column scale, then the bias
  // and the activation
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t n = na + 8 * r;
    if (n >= N) continue;
    const float bn = bias != nullptr ? bias[n] : 0.f;
    const float sn = kDequant ? scale[n] / kQuantBins : 1.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t m = m0 + 8 * j + 2 * t4 + e;
        float v = acc[4 * j + 2 * r + e];
        if constexpr (kDequant) v *= sn;
        if (m < M) out[m * N + n] = activate(v + bn, act);
      }
  }
}

template <typename TX, typename TW, int BN>
int launch_tc(const void* x, const void* w, const float* scale, const float* bias, float* out,
              int64_t M, int64_t N, int64_t K, int act, int x_vec, cudaStream_t s) {
  using T = FmmTile<BN, std::is_same<TW, float>::value, std::is_same<TX, float>::value>;
  constexpr int kCols = 64 * T::kRowGroups;
  const int64_t gx = (N + kCols - 1) / kCols, gy = (M + BN - 1) / BN;
  if (gy > 65535 || gx > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_matmul_wgmma_kernel<TX, TW, BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  kernel<<<grid, T::kThreads, T::kSmemBytes, s>>>(static_cast<const TX*>(x),
                                                   static_cast<const TW*>(w), scale, bias, out,
                                                   M, N, K, act, x_vec);
  return static_cast<int>(cudaGetLastError());
}

// The tile for this shape: up to 32 rows of x, the narrowest wgmma n that
// holds them; above that, 128 x 128 tiles (two consumer warpgroups) where
// they give at least half the card's 132 SMs a block, else 64 x 32 tiles, or
// 64 x 64 where those would take more than two waves.
template <typename TX, typename TW>
int launch_fp(const void* x, const void* w, const float* scale, const float* bias, float* out,
              int64_t M, int64_t N, int64_t K, int act, cudaStream_t s) {
  if (act < kNone || act > kTanh) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = std::is_same<TX, float>::value ? 16 : 8;
  const int x_vec = (reinterpret_cast<uintptr_t>(x) % align == 0 && K % 4 == 0) ? 1 : 0;
  if (M <= 8) return launch_tc<TX, TW, 8>(x, w, scale, bias, out, M, N, K, act, x_vec, s);
  if (M <= 16) return launch_tc<TX, TW, 16>(x, w, scale, bias, out, M, N, K, act, x_vec, s);
  if (M <= 32) return launch_tc<TX, TW, 32>(x, w, scale, bias, out, M, N, K, act, x_vec, s);
  if (((N + 127) / 128) * ((M + 127) / 128) >= 66)
    return launch_tc<TX, TW, 128>(x, w, scale, bias, out, M, N, K, act, x_vec, s);
  if (((N + 63) / 64) * ((M + 31) / 32) <= 2 * 132)
    return launch_tc<TX, TW, 32>(x, w, scale, bias, out, M, N, K, act, x_vec, s);
  return launch_tc<TX, TW, 64>(x, w, scale, bias, out, M, N, K, act, x_vec, s);
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
  if (!x_bf16 && !w_bf16) return launch_fp<float, float>(x, w, nullptr, b, o, M, N, K, act, s);
  if (!x_bf16 && w_bf16)
    return launch_fp<float, __nv_bfloat16>(x, w, nullptr, b, o, M, N, K, act, s);
  if (x_bf16 && !w_bf16)
    return launch_fp<__nv_bfloat16, float>(x, w, nullptr, b, o, M, N, K, act, s);
  return launch_fp<__nv_bfloat16, __nv_bfloat16>(x, w, nullptr, b, o, M, N, K, act, s);
}

// The weight-only int8 form: x as above; w: int8 [K, N] row-major; scale: fp32 [N], the
// per-column abs-max of the fp32 weight; bias: fp32 [N] or null; out: fp32 [M, N] =
// act(x @ w * scale / 127 + bias). Returns the cudaError_t of the launch (0 = accepted).
extern "C" int pt_fused_matmul_int8(const void* x, int x_bf16, const void* w, const void* scale,
                                    const void* bias, void* out, int64_t M, int64_t N, int64_t K,
                                    int act, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K < 0 || scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (!x_bf16) return launch_fp<float, int8_t>(x, w, sc, b, o, M, N, K, act, s);
  return launch_fp<__nv_bfloat16, int8_t>(x, w, sc, b, o, M, N, K, act, s);
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
