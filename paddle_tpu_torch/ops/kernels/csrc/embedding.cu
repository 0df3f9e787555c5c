// Embedding row gather and scatter-add for Hopper (sm_90a): rows = table[ids], and
// out = dst with updates[j] added into row ids[j].
//
// Replaces: paddle_tpu/ops/pallas/embedding.py:_gather_kernel (via _gather_call),
// registry name "embedding_gather", and paddle_tpu/ops/pallas/embedding.py:_scatter_kernel
// (via _scatter_call), registry name "embedding_scatter_add".
//
// What the gather computes: out[i, :] = table[id_i, :] for the n ids, where an id in
// [-h, h) selects its row (a negative id wraps once, to id + h, as jnp.take does) and any
// other id gives a row of NaN (jnp.take's fill value for a float table). Ids are int32 or
// int64 and are read on the card, so the host never syncs on them.
//
// What the scatter-add computes: out[r, :] = dst[r, :] plus the fp32 sum of updates[j, :]
// over the j whose id is r (an id in [-h, -1] wraps once, any other id outside [0, h) adds
// nothing: the stock .at[].add), rounded once to dst's dtype, in the fixed two-level order
// set out below. No atomics: the same bits on every launch, whatever the grid.
//
// What bounds it on the H100: memory. The gather reads n ids and n rows and writes n
// rows: 4 gathers of 100 rows of 32 fp32 (word2vec) move 26 KB, which no kernel can make
// long; 64x512 rows of 768 bf16 (BERT-base's word table) move 101 MB, a bound of ~30 us at
// 3.35 TB/s. The scatter-add is out of place: it reads dst and the n update rows and
// writes every row of out: 288 MB for BERT-base's fp32 word gradient (32768 ids into
// [30528, 768]), a bound of 86 us; 138 MB at the CTR point ([65536, 256], 4096 ids), 41 us.
//
// What the gather's design does about it: one warp per output row, so a row's bytes are
// read and written by 32 neighbouring threads at neighbouring addresses. The row is copied
// in 16-byte words where the row's bytes and both base pointers allow it (the wrapper
// decides), else in 4- or 2-byte words. The id is read once per warp (a broadcast).
//
// The scatter-add's summation order. The ids become keys (the wrapped row, or h for a
// dropped id) in a stable sort, so each row's ids form one run of the sorted positions, in
// ascending j, and dropped ids sort last. The sort is CUB's stable device-wide radix sort
// of only the bits that a key up to h needs (17 for 65536 rows, where a sort of the whole
// int32 takes 32), of the keys scatter_keys_kernel writes, in the wrapper's scratch.
// The sorted positions are cut into chunks of kChunk (256). Level 1: each piece of a
// run that lies in one chunk is summed in fp32 in ascending position, starting from 0.
// Level 2: a row's piece sums are added in ascending chunk order, starting from 0; then dst
// is added once and the sum rounded to dst's dtype. Every add is a plain fp32 add (there
// is no multiply to contract). A row whose run lies in one chunk gets dst + its one piece
// (0 + s is s): the bits of the ascending-j sum that the CPU's index_add_ gives. A longer
// run differs from that by fp32 rounding. The plain PyTorch emulation of this order, which
// the checks hold the kernel to bit for bit, is _scatter_add_two_level in embedding.py.
//
// What the scatter-add's design does about the bound: every row of out is written once,
// and no table over all h rows is cleared or written. scatter_sum_kernel's first blocks take
// a (chunk, 32 columns) each: they stage the chunk's update rows in shared memory as fp32
// (in 16-byte loads, all in flight at once, where d is a multiple of 32 and the tensors are
// 16-byte aligned; else a lane per column), mark the pieces from the sorted keys (a ballot
// per warp), sum each piece, and write a piece that is a whole row straight to out (dst
// read and out written once). A piece of a run that crosses a chunk's edge goes to fp32
// partials instead: two rows of d per chunk (the piece that runs on into the next chunk,
// and the one that ends a run begun before), scratch sized from n / kChunk. Rows that no id
// names are copied from dst to out, 64 KB of rows a block, in 16-byte words where the row
// and both pointers allow, by scatter_sum_kernel's other blocks, which find their rows' keys
// by a block-wide search (256 keys tested a round) and flag the named rows from them. scatter_join_kernel
// then adds each crossing run's partials in chunk order, one block per (chunk where such a
// run ends, 256 columns), staging the partials in shared memory so that their loads are in
// flight before the serial adds. A long run (BERT's token-type table takes 32768 ids into 2
// rows; a merged row set pads its tail into row 0) spreads over its chunks' blocks and
// joins n / 256 partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 rows per block

template <typename V>
__device__ __forceinline__ V fill(uint32_t w);

template <>
__device__ __forceinline__ uint4 fill<uint4>(uint32_t w) {
  return make_uint4(w, w, w, w);
}
template <>
__device__ __forceinline__ uint32_t fill<uint32_t>(uint32_t w) {
  return w;
}
template <>
__device__ __forceinline__ uint16_t fill<uint16_t>(uint32_t w) {
  return static_cast<uint16_t>(w);
}

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const V* __restrict__ table, const I* __restrict__ ids, V* __restrict__ out,
              int64_t n, int64_t h, int64_t row_words, uint32_t nan_word) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  int64_t id = static_cast<int64_t>(ids[row]);
  const bool valid = id >= -h && id < h;
  if (id < 0) id += h;
  V* dst = out + row * row_words;
  if (valid) {
    const V* src = table + id * row_words;
    for (int64_t c = lane; c < row_words; c += 32) dst[c] = src[c];
  } else {
    const V nan_v = fill<V>(nan_word);
    for (int64_t c = lane; c < row_words; c += 32) dst[c] = nan_v;
  }
}

template <typename V>
int launch(const void* table, const void* ids, int ids_are_64, void* out, int64_t n, int64_t h,
           int64_t row_bytes, uint32_t nan_word, cudaStream_t stream) {
  const int64_t blocks = (n * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t words = row_bytes / static_cast<int64_t>(sizeof(V));
  if (ids_are_64)
    gather_kernel<V, int64_t><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const V*>(table), static_cast<const int64_t*>(ids), static_cast<V*>(out), n,
        h, words, nan_word);
  else
    gather_kernel<V, int32_t><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const V*>(table), static_cast<const int32_t*>(ids), static_cast<V*>(out), n,
        h, words, nan_word);
  return static_cast<int>(cudaGetLastError());
}


// ---- scatter-add -------------------------------------------------------------------------

// An element as loaded (fp32 bits, or bf16 bits in the low half), and as fp32: a
// conversion waits for its load, so the loads of a batch are issued first
__device__ __forceinline__ uint32_t load_bits(const float* p) { return __float_as_uint(*p); }
__device__ __forceinline__ uint32_t load_bits(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}
template <typename T>
__device__ __forceinline__ float bits_to_f32(uint32_t b);
template <>
__device__ __forceinline__ float bits_to_f32<float>(uint32_t b) {
  return __uint_as_float(b);
}
template <>
__device__ __forceinline__ float bits_to_f32<__nv_bfloat16>(uint32_t b) {
  return __uint_as_float(b << 16);
}

// 16 bytes of T (4 fp32 or 8 bf16) as fp32, and back
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& q, float* f) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (sizeof(T) == 4) {
      f[e] = __uint_as_float(w[e]);
    } else {
      f[2 * e] = __uint_as_float(w[e] << 16);
      f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (sizeof(T) == 4) {
      w[e] = __float_as_uint(f[e]);
    } else {
      w[e] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * e]))) |
             (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * e + 1])))
              << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Sorted positions per chunk, the unit of the summation order (the wrapper sizes the
// partials from the same number: _CHUNK in embedding.py)
constexpr int kChunk = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 32;                     // columns of a chunk one block sums
constexpr int kBatch = 8;                         // loads a thread has in flight
constexpr int kCopyBytes = 65536;                 // bytes of dst a copy block moves
constexpr int kMaxCopyRows = 4096;                // rows a copy block takes at most
constexpr int kJoinCols = kThreads;               // columns of a join block
constexpr int kJoinFloats = kChunk * kTileCols;   // partials a join block stages at once
static_assert(kChunk == kThreads, "one thread marks each sorted position of a chunk");
static_assert(kMaxCopyRows <= kChunk * kTileCols * 4, "the named-row flags fit the stage");

// keys[j] = the row id j adds into (a negative id in [-h, -1] wraps once), or h where the
// id is outside [-h, h) and adds nothing; h sorts after every row
template <typename I>
__device__ __forceinline__ int32_t scatter_key(const I* __restrict__ ids, int64_t j, int64_t h) {
  int64_t id = static_cast<int64_t>(ids[j]);
  const bool valid = id >= -h && id < h;
  if (id < 0) id += h;
  return static_cast<int32_t>(valid ? id : h);
}

// The bits that every key up to h (a dropped id's) needs
__host__ __device__ __forceinline__ int key_bits(int64_t h) {
  int bits = 1;
  while ((int64_t{1} << bits) <= h) ++bits;
  return bits;
}

// keys[j] and order[j] = j, the input of the device-wide sort
template <typename I>
__global__ void __launch_bounds__(kThreads)
scatter_keys_kernel(const I* __restrict__ ids, uint32_t* __restrict__ keys,
                    uint32_t* __restrict__ order, int64_t n, int64_t h) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  keys[j] = static_cast<uint32_t>(scatter_key(ids, j, h));
  order[j] = static_cast<uint32_t>(j);
}

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a < b ? b : a; }

// The first of the n positions whose key is not below v (the keys ascend), found by the
// whole block: each round tests kThreads evenly spaced keys of [lo, hi] at once and keeps
// the span between the last one below v and the next, so n = 2^15 takes two rounds of
// loads where a binary search takes 15 dependent ones
__device__ __forceinline__ int64_t block_first_not_below(const int32_t* __restrict__ keys,
                                                         int64_t n, int64_t v) {
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t step = (hi - lo + kThreads - 1) / kThreads;
    const int64_t pos = lo + threadIdx.x * step;
    const int below = __syncthreads_count(pos < hi && keys[pos] < v);
    if (below == 0) break;  // keys[lo] is not below v
    lo += (below - 1) * step + 1;  // just past the last sample below v
    hi = lmin(hi, lo - 1 + step);  // the next sample, if any, is not below v
  }
  return lo;
}

// Copies the rows [0, rows) of src to o in words of W (words a row), but the named ones;
// element i = row * words + word, stepped by kThreads without a division
template <typename W>
__device__ __forceinline__ void copy_unnamed(const unsigned char* named,
                                             const W* __restrict__ src, W* __restrict__ o,
                                             int rows, int words) {
  const int tid = threadIdx.x;
  const int total = rows * words;
  const int step_r = kThreads / words, step_w = kThreads - step_r * words;
  int r = tid / words, w = tid - r * words;
  for (int base = tid; base < total; base += kBatch * kThreads) {
    W v[kBatch];
    int rr[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      rr[u] = r;
      if (i < total && !named[r]) v[u] = src[i];
      r += step_r;
      w += step_w;
      if (w >= words) w -= words, ++r;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < total && !named[rr[u]]) o[i] = v[u];
    }
  }
}

struct alignas(16) SumSmem {
  float stage[kChunk * kTileCols];  // the chunk's update rows, fp32: [position][column]
  int32_t perm[kChunk];             // the chunk's update row of each position
  int32_t key[kChunk];
  int32_t start[kChunk + 1];        // each piece's first position, then the valid length
  int32_t count[2 * kWarps];        // pieces and valid positions per warp
};

// Level 1 for (chunk, tile): the pieces of the chunk's sorted positions, summed over the
// tile's columns; in the sums lane = column and warp w takes pieces w, w + 8, ... A piece
// that is a whole row is written to out; a piece that runs on into the next chunk goes to
// part[chunk][1], one that ends a run begun before to part[chunk][0]. With VEC (d a
// multiple of 32, 16-byte aligned tensors) the update rows, dst and out move in 16-byte
// accesses, a few positions or pieces per warp access, so one round of loads stages the
// whole tile; else lane = column there too.
template <typename TD, typename TU, bool VEC>
__device__ __forceinline__ void sum_chunk(SumSmem& sm, const TD* __restrict__ dst,
                                          const TU* __restrict__ upd,
                                          const int32_t* __restrict__ keys,
                                          const int32_t* __restrict__ perm,
                                          float* __restrict__ part, TD* __restrict__ out,
                                          int64_t n, int64_t h, int64_t d, int64_t chunk,
                                          int tile) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c0 = chunk * kChunk;
  const int len = static_cast<int>(lmin(kChunk, n - c0));
  const int64_t col = static_cast<int64_t>(tile) * kTileCols + lane;
  const bool col_ok = col < d;
  // a piece starts at a valid position whose key differs from the one before; dropped
  // keys (h) sort last, so the valid positions are the first vlen
  const int32_t key = tid < len ? keys[c0 + tid] : static_cast<int32_t>(h);
  const bool valid = key < h;
  // the keys either side of the chunk, loaded with its own
  const int32_t prev = c0 > 0 ? keys[c0 - 1] : -1;
  const int32_t next = c0 + len < n ? keys[c0 + len] : -1;
  sm.key[tid] = key;
  if (valid) sm.perm[tid] = perm[c0 + tid];
  __syncthreads();
  const bool starts = valid && (tid == 0 || sm.key[tid - 1] != key);
  const unsigned sb = __ballot_sync(0xffffffffu, starts);
  const unsigned vb = __ballot_sync(0xffffffffu, valid);
  if (lane == 0) {
    sm.count[warp] = __popc(sb);
    sm.count[kWarps + warp] = __popc(vb);
  }
  __syncthreads();
  int before = 0, pieces = 0, vlen = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? sm.count[w] : 0;
    pieces += sm.count[w];
    vlen += sm.count[kWarps + w];
  }
  if (pieces == 0) return;  // every id of the chunk dropped (uniform across the block)
  if (starts) sm.start[before + __popc(sb & ((1u << lane) - 1u))] = tid;
  if (tid == 0) sm.start[pieces] = vlen;

  // stage the valid positions' update rows (this tile's columns) as fp32
  if constexpr (VEC) {
    constexpr int kN = 16 / sizeof(TU), kLanes = kTileCols / kN, kPer = 32 / kLanes;
    const int c = (lane % kLanes) * kN;
    for (int p0 = warp * kPer + lane / kLanes; p0 < vlen; p0 += kBatch * kWarps * kPer) {
      uint4 raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = p0 + u * kWarps * kPer;
        if (p < vlen)
          raw[u] = *reinterpret_cast<const uint4*>(upd + int64_t{sm.perm[p]} * d + col -
                                                   lane + c);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = p0 + u * kWarps * kPer;
        if (p < vlen) {
          float f[kN];
          unpack16<TU>(raw[u], f);
#pragma unroll
          for (int e = 0; e < kN; e += 4)
            *reinterpret_cast<float4*>(&sm.stage[p * kTileCols + c + e]) =
                make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
        }
      }
    }
  } else {
    for (int p0 = warp; p0 < vlen; p0 += kBatch * kWarps) {
      uint32_t raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = p0 + u * kWarps;
        raw[u] = 0u;
        if (p < vlen && col_ok) raw[u] = load_bits(upd + int64_t{sm.perm[p]} * d + col);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = p0 + u * kWarps;
        if (p < vlen) sm.stage[p * kTileCols + lane] = bits_to_f32<TU>(raw[u]);
      }
    }
  }
  __syncthreads();

  // level 1: each piece summed in ascending position from 0, written over its first row
  for (int s = warp; s < pieces; s += kWarps) {
    const int p0 = sm.start[s], p1 = sm.start[s + 1];
    float acc = 0.f;
#pragma unroll 8
    for (int p = p0; p < p1; ++p) acc += sm.stage[p * kTileCols + lane];
    sm.stage[p0 * kTileCols + lane] = acc;
  }
  __syncthreads();

  // a whole row: out = dst + sum (0 + sum is sum); else the partials
  if constexpr (VEC) {
    constexpr int kN = 16 / sizeof(TD), kLanes = kTileCols / kN, kPer = 32 / kLanes;
    const int c = (lane % kLanes) * kN;
    const int64_t cc = col - lane + c;  // this lane's first column
    for (int s0 = warp * kPer + lane / kLanes; s0 < pieces; s0 += kBatch * kWarps * kPer) {
      uint4 old[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = s0 + u * kWarps * kPer;
        if (s < pieces) {
          const int p0 = sm.start[s], p1 = sm.start[s + 1];
          const int32_t k = sm.key[p0];
          if (!(p0 == 0 && prev == k) && !(p1 == len && next == k))
            old[u] = *reinterpret_cast<const uint4*>(dst + k * d + cc);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = s0 + u * kWarps * kPer;
        if (s < pieces) {
          const int p0 = sm.start[s], p1 = sm.start[s + 1];
          const int32_t k = sm.key[p0];
          float acc[kN];
#pragma unroll
          for (int e = 0; e < kN; ++e) acc[e] = sm.stage[p0 * kTileCols + c + e];
          const bool runs_on = p1 == len && next == k;
          if (runs_on || (p0 == 0 && prev == k)) {
            float* pp = part + (chunk * 2 + (runs_on ? 1 : 0)) * d + cc;
#pragma unroll
            for (int e = 0; e < kN; e += 4)
              *reinterpret_cast<float4*>(pp + e) =
                  make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
          } else {
            float f[kN];
            unpack16<TD>(old[u], f);
#pragma unroll
            for (int e = 0; e < kN; ++e) f[e] += acc[e];
            *reinterpret_cast<uint4*>(out + k * d + cc) = pack16<TD>(f);
          }
        }
      }
    }
    return;
  }
  if (!col_ok) return;
  for (int s0 = warp; s0 < pieces; s0 += kBatch * kWarps) {
    uint32_t old[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = s0 + u * kWarps;
      old[u] = 0u;
      if (s < pieces) {
        const int p0 = sm.start[s], p1 = sm.start[s + 1];
        const int32_t k = sm.key[p0];
        if (!(p0 == 0 && prev == k) && !(p1 == len && next == k))
          old[u] = load_bits(dst + k * d + col);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = s0 + u * kWarps;
      if (s < pieces) {
        const int p0 = sm.start[s], p1 = sm.start[s + 1];
        const int32_t k = sm.key[p0];
        const float acc = sm.stage[p0 * kTileCols + lane];
        const bool runs_on = p1 == len && next == k;
        if (runs_on || (p0 == 0 && prev == k))
          part[(chunk * 2 + (runs_on ? 1 : 0)) * d + col] = acc;
        else
          out[k * d + col] = from_f32<TD>(bits_to_f32<TD>(old[u]) + acc);
      }
    }
  }
}

// The rows [r0, r0 + rows) of dst that no id names, copied to out in words of W: the
// named ones are flagged from the sorted keys that fall in the range
template <typename W>
__device__ __forceinline__ void copy_rows(SumSmem& sm, const W* __restrict__ dst,
                                          W* __restrict__ out, const int32_t* __restrict__ keys,
                                          int64_t n, int64_t h, int words, int64_t r0,
                                          int rows) {
  const int tid = threadIdx.x;
  rows = static_cast<int>(lmin(h, r0 + rows) - r0);
  unsigned char* named = reinterpret_cast<unsigned char*>(sm.stage);
  for (int r = tid; r < rows; r += kThreads) named[r] = 0;
  const int64_t lo = block_first_not_below(keys, n, r0);
  const int64_t hi = block_first_not_below(keys, n, r0 + rows);
  for (int64_t q = lo + tid; q < hi; q += kThreads) named[keys[q] - r0] = 1;
  __syncthreads();
  copy_unnamed<W>(named, dst + r0 * words, out + r0 * words, rows, words);
}

// Blocks [0, sum_blocks) sum (chunk, tile) = (b / tiles, b % tiles); the rest copy
// copy_rows rows of dst each, in words of W
template <typename TD, typename TU, typename W, bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
scatter_sum_kernel(const TD* __restrict__ dst, const TU* __restrict__ upd,
                   const int32_t* __restrict__ keys, const int32_t* __restrict__ perm,
                   float* __restrict__ part, TD* __restrict__ out, int64_t n, int64_t h,
                   int64_t d, int tiles, int64_t sum_blocks, int copy_rows_per_block,
                   int words) {
  __shared__ SumSmem sm;
  const int64_t b = blockIdx.x;
  if (b < sum_blocks)
    sum_chunk<TD, TU, VEC>(sm, dst, upd, keys, perm, part, out, n, h, d, b / tiles,
                           static_cast<int>(b % tiles));
  else
    copy_rows<W>(sm, reinterpret_cast<const W*>(dst), reinterpret_cast<W*>(out), keys, n, h,
                 words, (b - sum_blocks) * copy_rows_per_block, copy_rows_per_block);
}

// Level 2, one block per (chunk, kJoinCols columns): where a run that began in an earlier
// chunk ends in this one, its row of out is dst + (0 + the run's partials in ascending
// chunk order). The run's first chunk is the least whose last key is not below the run's
// (every earlier chunk's last key tested at once); the partials are staged in shared
// memory, kJoinFloats at a time, their loads all in flight before the serial adds.
template <typename TD>
__global__ void __launch_bounds__(kThreads)
scatter_join_kernel(const TD* __restrict__ dst, const int32_t* __restrict__ keys,
                    const float* __restrict__ part, TD* __restrict__ out, int64_t n, int64_t h,
                    int64_t d) {
  __shared__ __align__(16) float buf[kJoinFloats];
  __shared__ int first_chunk;
  const int chunk = blockIdx.x;
  const int64_t c0 = static_cast<int64_t>(chunk) * kChunk;
  if (chunk == 0) return;
  const int32_t key = keys[c0];
  if (key >= h || keys[c0 - 1] != key) return;
  if (c0 + kChunk < n && keys[c0 + kChunk] == key) return;  // a later chunk ends the run
  const int tid = threadIdx.x;
  if (tid == 0) first_chunk = chunk;
  __syncthreads();
  for (int q = tid; q < chunk; q += kThreads)
    if (keys[static_cast<int64_t>(q) * kChunk + kChunk - 1] >= key) atomicMin(&first_chunk, q);
  __syncthreads();
  const int64_t first = first_chunk;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kJoinCols;
  const int cols = static_cast<int>(lmin(kJoinCols, d - col0));
  // the partials: [first .. chunk - 1][1] (pieces that run on), then [chunk][0]
  const int64_t parts = chunk - first + 1;
  const int per_round = kJoinFloats / cols;
  // four columns an access where the partials' rows allow (d a multiple of 4)
  const int g = d % 4 == 0 ? 4 : 1, gcols = cols / g;
  float acc = 0.f;
  for (int64_t q0 = 0; q0 < parts; q0 += per_round) {
    const int m = static_cast<int>(lmin(per_round, parts - q0));
    const int total = m * gcols;
    // access i = q * gcols + c, stepped by kThreads without a division
    const int step_q = kThreads / gcols, step_c = kThreads - step_q * gcols;
    int q = tid / gcols, c = tid - q * gcols;
    __syncthreads();  // the previous round's adds are done with buf
    for (int base = tid; base < total; base += kBatch * kThreads) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        if (i < total) {
          const int64_t k = first + q0 + q;
          const float* src = part + (k * 2 + (k < chunk ? 1 : 0)) * d + col0 + c * g;
          v[u] = g == 4 ? *reinterpret_cast<const float4*>(src) : make_float4(*src, 0, 0, 0);
        }
        q += step_q;
        c += step_c;
        if (c >= gcols) c -= gcols, ++q;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        if (i < total) {
          if (g == 4)
            *reinterpret_cast<float4*>(&buf[i * 4]) = v[u];
          else
            buf[i] = v[u].x;
        }
      }
    }
    __syncthreads();
    if (tid < cols) {
#pragma unroll 8
      for (int qq = 0; qq < m; ++qq) acc += buf[qq * cols + tid];
    }
  }
  if (tid < cols) {
    const int64_t at = key * d + col0 + tid;
    out[at] = from_f32<TD>(bits_to_f32<TD>(load_bits(dst + at)) + acc);
  }
}

template <typename TD, typename TU, typename W, bool VEC>
int launch_scatter_add(const void* dst, const void* upd, const int32_t* keys,
                       const int32_t* perm, float* part, void* out, int64_t n, int64_t h,
                       int64_t d, cudaStream_t stream) {
  const int64_t row_bytes = d * static_cast<int64_t>(sizeof(TD));
  const int64_t words = row_bytes / static_cast<int64_t>(sizeof(W));
  const int64_t tiles = (d + kTileCols - 1) / kTileCols;
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int64_t sum_blocks = chunks * tiles;
  const int rows = static_cast<int>(
      lmax(1, lmin(kMaxCopyRows, kCopyBytes / row_bytes)));
  const int64_t copy_blocks = (h + rows - 1) / rows;
  const int64_t join_y = (d + kJoinCols - 1) / kJoinCols;
  if (words > 0x7fffffff || tiles > 0x7fffffff || sum_blocks + copy_blocks > 0x7fffffff ||
      join_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const TD* dp = static_cast<const TD*>(dst);
  TD* op = static_cast<TD*>(out);
  scatter_sum_kernel<TD, TU, W, VEC>
      <<<static_cast<unsigned>(sum_blocks + copy_blocks), kThreads, 0, stream>>>(
          dp, static_cast<const TU*>(upd), keys, perm, part, op, n, h, d,
          static_cast<int>(tiles), sum_blocks, rows, static_cast<int>(words));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks < 2) return static_cast<int>(err);  // no run crosses a chunk
  scatter_join_kernel<TD><<<dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(join_y)),
                            kThreads, 0, stream>>>(dp, keys, part, op, n, h, d);
  return static_cast<int>(cudaGetLastError());
}

// The device-wide sort's scratch for n keys of `bits` bits: its own, after the keys and
// their order (n uint32 each), 256-byte aligned
int64_t device_sort_bytes(int64_t n, int bits) {
  size_t bytes = 0;
  cub::DeviceRadixSort::SortPairs(nullptr, bytes, static_cast<const uint32_t*>(nullptr),
                                  static_cast<uint32_t*>(nullptr),
                                  static_cast<const uint32_t*>(nullptr),
                                  static_cast<uint32_t*>(nullptr), static_cast<int>(n), 0, bits);
  return ((8 * n + 255) / 256) * 256 + static_cast<int64_t>(bytes);
}

template <typename I>
int launch_sort(const void* ids, void* sorted_keys, void* perm, void* scratch,
                int64_t scratch_bytes, int64_t n, int64_t h, cudaStream_t s) {
  const int bits = key_bits(h);
  if (scratch_bytes < device_sort_bytes(n, bits)) return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* keys = static_cast<uint32_t*>(scratch);
  uint32_t* order = keys + n;
  void* temp = static_cast<char*>(scratch) + ((8 * n + 255) / 256) * 256;
  size_t temp_bytes = static_cast<size_t>(scratch_bytes - ((8 * n + 255) / 256) * 256);
  scatter_keys_kernel<I><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                           s>>>(static_cast<const I*>(ids), keys, order, n, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cub::DeviceRadixSort::SortPairs(temp, temp_bytes, keys,
                                        static_cast<uint32_t*>(sorted_keys), order,
                                        static_cast<uint32_t*>(perm), static_cast<int>(n), 0,
                                        bits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The copy in 16-byte words where the row's bytes and both pointers allow, else in
// elements; level 1 in 16-byte accesses where d is a multiple of 32 and every tensor's
// base is 16-byte aligned
template <typename TD, typename TU>
int scatter_add_widths(const void* dst, const void* upd, const int32_t* keys,
                       const int32_t* perm, float* part, void* out, int64_t n, int64_t h,
                       int64_t d, cudaStream_t s) {
  using E = typename std::conditional<sizeof(TD) == 4, uint32_t, uint16_t>::type;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(out);
  const bool wide = (d * static_cast<int64_t>(sizeof(TD))) % 16 == 0 && ptrs % 16 == 0;
  const bool vec = d % kTileCols == 0 && (ptrs | reinterpret_cast<uintptr_t>(upd)) % 16 == 0;
  if (wide && vec)
    return launch_scatter_add<TD, TU, uint4, true>(dst, upd, keys, perm, part, out, n, h, d, s);
  if (wide)
    return launch_scatter_add<TD, TU, uint4, false>(dst, upd, keys, perm, part, out, n, h, d,
                                                    s);
  return launch_scatter_add<TD, TU, E, false>(dst, upd, keys, perm, part, out, n, h, d, s);
}

}  // namespace

// table: [h, row_bytes] on the device; ids: n int32 or int64 ids on the device; out:
// [n, row_bytes]. word_bytes (16, 4 or 2) is the copy width: row_bytes and both base
// pointers must be multiples of it. nan_word is the fill of an invalid row, the NaN of
// the element type repeated over 32 bits (for 2-byte words, the low 16 bits are used).
// Returns the cudaError_t of the launch (0 = accepted).
extern "C" int pt_embedding_gather(const void* table, const void* ids, int ids_are_64, void* out,
                                   int64_t n, int64_t h, int64_t row_bytes, int word_bytes,
                                   uint32_t nan_word, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || h <= 0 || row_bytes <= 0 || row_bytes % word_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 16:
      return launch<uint4>(table, ids, ids_are_64, out, n, h, row_bytes, nan_word, s);
    case 4:
      return launch<uint32_t>(table, ids, ids_are_64, out, n, h, row_bytes, nan_word, s);
    case 2:
      return launch<uint16_t>(table, ids, ids_are_64, out, n, h, row_bytes, nan_word, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Step 1 of the scatter-add: the scratch bytes that the sort of n ids into h rows needs.
extern "C" int64_t pt_embedding_scatter_sort_bytes(int64_t n, int64_t h) {
  return device_sort_bytes(n, key_bits(h));
}

// Step 1: the keys of the n int32 or int64 ids in ascending order (sorted_keys, int32) and
// the stable order that sorts them (perm, int32: ascending j within a key):
// scatter_keys_kernel, then the device-wide radix sort (CUB's, stable) over the keys' bits,
// in scratch of the bytes that pt_embedding_scatter_sort_bytes gives. Returns the
// cudaError_t of the first launch that failed (0 = all accepted).
extern "C" int pt_embedding_scatter_sort(const void* ids, int ids_are_64, void* sorted_keys,
                                         void* perm, void* scratch, int64_t scratch_bytes,
                                         int64_t n, int64_t h, void* stream) {
  if (n <= 0 || n > 0x7fffffff || h <= 0 || h >= 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_are_64)
    return launch_sort<int64_t>(ids, sorted_keys, perm, scratch, scratch_bytes, n, h, s);
  return launch_sort<int32_t>(ids, sorted_keys, perm, scratch, scratch_bytes, n, h, s);
}

// Step 2: out [h, d] = dst [h, d] + the rows of upd [n, d] summed by key in the two-level
// order, every row of out written once. sorted_keys and perm (int32) are step 1's;
// partials is fp32 scratch of ceil(n / kChunk) x 2 x d. dst and out are float32 (dst_dtype
// 0) or bfloat16 (1), upd likewise (upd_dtype); the access widths follow from d and the
// pointers. Returns the cudaError_t of the first launch that failed (0 = all accepted).
extern "C" int pt_embedding_scatter_add(const void* dst, const void* upd, const void* sorted_keys,
                                        const void* perm, void* partials, void* out, int64_t n,
                                        int64_t h, int64_t d, int dst_dtype, int upd_dtype,
                                        void* stream) {
  if (n < 0 || n > 0x7fffffff || h <= 0 || h >= 0x7fffffff || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(sorted_keys);
  const int32_t* p = static_cast<const int32_t*>(perm);
  float* part = static_cast<float*>(partials);
  if (dst_dtype == 0 && upd_dtype == 0)
    return scatter_add_widths<float, float>(dst, upd, k, p, part, out, n, h, d, s);
  if (dst_dtype == 0 && upd_dtype == 1)
    return scatter_add_widths<float, __nv_bfloat16>(dst, upd, k, p, part, out, n, h, d, s);
  if (dst_dtype == 1 && upd_dtype == 0)
    return scatter_add_widths<__nv_bfloat16, float>(dst, upd, k, p, part, out, n, h, d, s);
  if (dst_dtype == 1 && upd_dtype == 1)
    return scatter_add_widths<__nv_bfloat16, __nv_bfloat16>(dst, upd, k, p, part, out, n, h,
                                                           d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
