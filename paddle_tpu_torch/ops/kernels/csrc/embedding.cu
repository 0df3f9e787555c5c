// Embedding row gather and scatter-add for Hopper (sm_90a): rows = table[ids], and
// out = dst with updates[j] added into row ids[j].
//
// Replaces: paddle_tpu/ops/pallas/embedding.py:_gather_kernel (via _gather_call),
// registry name "embedding_gather", and paddle_tpu/ops/pallas/embedding.py:_scatter_kernel
// (via _scatter_call), registry name "embedding_scatter_add".
//
// What the gather computes: out[i, :] = table[id_i, :] for the n ids, where an id in
// [-h, h) selects its row (a negative id wraps once, to id + h, as jnp.take does) and any
// other id gives a row of NaN (jnp.take's fill value for a float table). This is the
// meaning of the JAX package's stock body, which the port gives its plain version too.
// Ids are int32 or int64 and are read on the card, so the host never syncs on them.
//
// What the scatter-add computes: out[r, :] = dst[r, :] + sum of updates[j, :] over the j
// whose id is r, with the same id meaning: an id in [-h, -1] wraps once, any other id
// outside [0, h) adds nothing (the stock .at[].add). Each row's sum is taken in fp32 in
// ascending j, starting from 0, and added to dst once, then rounded to dst's dtype
// (_scatter_kernel sums the one-hot product in fp32 and adds dst once). No atomics: the
// result is the same bits on every run, and the same bits as the plain version on the
// CPU, whose index_add_ adds in ascending j too.
//
// What bounds it on the H100: memory. The gather reads n ids and n rows and writes n
// rows: 4 gathers of 100 rows of 32 fp32 (word2vec) move 26 KB, which no kernel can make
// long; 64x512 rows of 768 bf16 (BERT-base's word table) move 101 MB, a bound of ~30 us at
// 3.35 TB/s. The scatter-add is out of place: it reads dst and the n update rows and
// writes every row of out: 288 MB for BERT-base's fp32 word gradient (32768 ids into
// [30528, 768]), a bound of 86 us.
//
// What the gather's design does about it: one warp per output row, so a row's bytes are
// read and written by 32 neighbouring threads at neighbouring addresses. The row is copied
// in 16-byte words where the row's bytes and both base pointers allow it (the wrapper
// decides), else in 4- or 2-byte words. The id is read once per warp (a broadcast).
//
// What the scatter-add's design does about it: the ids are turned into keys (the wrapped
// row, or h for a dropped id) by scatter_keys_kernel, and the wrapper sorts them with a
// stable sort, so each row's ids form one run of the sorted keys, in ascending j.
// scatter_mark_kernel records each run's [start, end) in a per-row table that starts
// empty. scatter_add_kernel then gives one thread to each (row, vector of columns) of out:
// it walks its row's run (the loop's bounds are known, so the loads of the permutation
// and of the update rows are issued ahead of the adds), adds dst and writes the vector
// once. Neighbouring threads read neighbouring columns of dst, of an update row and of
// out. A run longer than 64 ids (BERT's token-type table gets 32768 ids into 2 rows; a
// merged row set pads its tail into row 0) would leave a thread with a long chain of
// dependent loads, so such rows are listed and summed by scatter_add_long_kernel: one
// block per 32 columns of the row, whose 8 warps stage 256 update rows at a time in
// shared memory (the next chunk's loads in flight) while one warp adds them in ascending
// j. The
// sum stays one serial chain per column, so such a row is still far from the bound; a
// two-stage segmented sum would fix that at the price of another summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// N elements of T, loaded and stored as one aligned vector
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// keys[j] = the row id j adds into (a negative id in [-h, -1] wraps once), or h where the
// id is outside [-h, h) and adds nothing; h sorts after every row
template <typename I>
__global__ void __launch_bounds__(kThreads)
scatter_keys_kernel(const I* __restrict__ ids, int32_t* __restrict__ keys, int64_t n, int64_t h) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  int64_t id = static_cast<int64_t>(ids[j]);
  const bool valid = id >= -h && id < h;
  if (id < 0) id += h;
  keys[j] = static_cast<int32_t>(valid ? id : h);
}

// runs[r] = [start, end) of row r's keys in the sorted keys; rows without ids keep the
// empty run [0, 0) that the caller's memset left
__global__ void __launch_bounds__(kThreads)
scatter_mark_kernel(const int32_t* __restrict__ keys, int2* __restrict__ runs, int64_t n,
                    int32_t h) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= n) return;
  const int32_t key = keys[k];
  if (key >= h) return;
  if (k == 0 || keys[k - 1] != key) runs[key].x = static_cast<int>(k);
  if (k == n - 1 || keys[k + 1] != key) runs[key].y = static_cast<int>(k + 1);
}

// A row whose run is longer than this is summed by scatter_add_long_kernel (the wrapper
// sizes long_rows from the same number: _LONG_RUN in embedding.py)
constexpr int kLongRun = 64;
constexpr int kLongCols = 32;                  // columns of out per long-run block
constexpr int kChunk = 256;                    // update rows staged per step
constexpr int kRowsPerWarp = kChunk / (kThreads / 32);

// one thread per (row, vector of VEC columns) of out; a row with a run longer than
// kLongRun is left to scatter_add_long_kernel, and its first thread appends it to
// long_rows (long_rows[0] counts them; their order does not matter)
template <typename TD, typename TU, int VEC>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const TD* __restrict__ dst, const TU* __restrict__ upd,
                   const int64_t* __restrict__ perm, const int2* __restrict__ runs,
                   TD* __restrict__ out, int32_t* __restrict__ long_rows, int64_t h,
                   int64_t vecs_per_row) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= h * vecs_per_row) return;
  const int64_t row = i / vecs_per_row;
  const int64_t col = i - row * vecs_per_row;
  const int2 run = runs[row];
  if (run.y - run.x > kLongRun) {
    if (col == 0) long_rows[1 + atomicAdd(long_rows, 1)] = static_cast<int32_t>(row);
    return;
  }
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  const Pack<TU, VEC>* u = reinterpret_cast<const Pack<TU, VEC>*>(upd) + col;
#pragma unroll 4
  for (int k = run.x; k < run.y; ++k) {
    const Pack<TU, VEC> p = u[perm[k] * vecs_per_row];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += to_f32(p.v[e]);
  }
  const Pack<TD, VEC> d = reinterpret_cast<const Pack<TD, VEC>*>(dst)[i];
  Pack<TD, VEC> o;
#pragma unroll
  for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<TD>(to_f32(d.v[e]) + acc[e]);
  reinterpret_cast<Pack<TD, VEC>*>(out)[i] = o;
}

// One block per (long row, tile of kLongCols columns): each of the block's 8 warps stages
// 32 of every kChunk update rows of the tile in shared memory (lane i reads the
// permutation of the warp's i-th row, a shuffle hands it to the others, then each lane
// loads its column of the 32 rows at once), loading the next chunk into registers while
// warp 0 adds the current one, one lane per column, in ascending j. Grid x covers the most
// long rows n ids can make; blocks past long_rows[0] return.
template <typename TD, typename TU>
__global__ void __launch_bounds__(kThreads)
scatter_add_long_kernel(const TD* __restrict__ dst, const TU* __restrict__ upd,
                        const int64_t* __restrict__ perm, const int2* __restrict__ runs,
                        const int32_t* __restrict__ long_rows, TD* __restrict__ out,
                        int64_t d) {
  static_assert(kRowsPerWarp == 32, "a lane reads the permutation of one row of its warp");
  if (static_cast<int>(blockIdx.x) >= long_rows[0]) return;
  const int64_t row = long_rows[1 + blockIdx.x];
  const int2 run = runs[row];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t c = static_cast<int64_t>(blockIdx.y) * kLongCols + lane;
  const bool col_ok = c < d;
  __shared__ float tile[kChunk][kLongCols];
  float pre[kRowsPerWarp];
  auto load = [&](int base) {
    const int first = base + warp * kRowsPerWarp;
    const long long mine = first + lane < run.y ? perm[first + lane] : 0;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const long long j = __shfl_sync(0xffffffffu, mine, r);
      pre[r] = (first + r < run.y && col_ok) ? to_f32(upd[j * d + c]) : 0.0f;
    }
  };
  float acc = 0.0f;
  load(run.x);
  for (int base = run.x; base < run.y; base += kChunk) {
    __syncthreads();  // warp 0 is done with the previous chunk
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) tile[warp * kRowsPerWarp + r][lane] = pre[r];
    __syncthreads();
    if (base + kChunk < run.y) load(base + kChunk);
    if (warp == 0) {
      // 16 shared-memory loads issued ahead of their 16 dependent adds
      const int cnt = min(kChunk, run.y - base);
      int r = 0;
      for (; r + 16 <= cnt; r += 16) {
        float v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = tile[r + i][lane];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc += v[i];
      }
      for (; r < cnt; ++r) acc += tile[r][lane];
    }
  }
  if (warp == 0 && col_ok)
    out[row * d + c] = from_f32<TD>(to_f32(dst[row * d + c]) + acc);
}

template <typename TD, typename TU>
int launch_scatter_add(const void* dst, const void* upd, const int64_t* perm, const int2* runs,
                       int32_t* long_rows, void* out, int64_t n, int64_t h, int64_t d, int vec,
                       cudaStream_t stream) {
  const int64_t vecs_per_row = d / vec;
  const int64_t blocks = (h * vecs_per_row + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(blocks);
  const TD* dp = static_cast<const TD*>(dst);
  const TU* up = static_cast<const TU*>(upd);
  TD* op = static_cast<TD*>(out);
  switch (vec) {
    case 8:
      scatter_add_kernel<TD, TU, 8><<<g, kThreads, 0, stream>>>(dp, up, perm, runs, op,
                                                                 long_rows, h, vecs_per_row);
      break;
    case 4:
      scatter_add_kernel<TD, TU, 4><<<g, kThreads, 0, stream>>>(dp, up, perm, runs, op,
                                                                 long_rows, h, vecs_per_row);
      break;
    case 2:
      scatter_add_kernel<TD, TU, 2><<<g, kThreads, 0, stream>>>(dp, up, perm, runs, op,
                                                                 long_rows, h, vecs_per_row);
      break;
    case 1:
      scatter_add_kernel<TD, TU, 1><<<g, kThreads, 0, stream>>>(dp, up, perm, runs, op,
                                                                 long_rows, h, vecs_per_row);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t max_long = n / (kLongRun + 1);
  if (max_long > 0) {
    const dim3 lg(static_cast<unsigned>(max_long),
                  static_cast<unsigned>((d + kLongCols - 1) / kLongCols));
    scatter_add_long_kernel<TD, TU><<<lg, kThreads, 0, stream>>>(dp, up, perm, runs, long_rows,
                                                                 op, d);
  }
  return static_cast<int>(cudaGetLastError());
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

// Step 1 of the scatter-add: keys[j] (int32) for the n int32 or int64 ids, as
// scatter_keys_kernel says. The wrapper then sorts the keys with a stable sort.
// Returns the cudaError_t of the launch (0 = accepted).
extern "C" int pt_embedding_scatter_keys(const void* ids, int ids_are_64, void* keys, int64_t n,
                                         int64_t h, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || n > 0x7fffffff || h <= 0 || h >= 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (ids_are_64)
    scatter_keys_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int64_t*>(ids), static_cast<int32_t*>(keys), n, h);
  else
    scatter_keys_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(ids), static_cast<int32_t*>(keys), n, h);
  return static_cast<int>(cudaGetLastError());
}

// Step 2: out [h, d] = dst [h, d] + the rows of upd [n, d] summed by key. sorted_keys and
// perm (int64) are the stable sort of step 1's keys; runs is scratch of h int2 (8 bytes a
// row), long_rows scratch of 1 + n / (kLongRun + 1) int32. dst and out are float32
// (dst_dtype 0) or bfloat16 (1), upd likewise (upd_dtype); vec (8, 4, 2 or 1) columns per
// thread: d, and the base pointers in units of vec elements of their type, must allow it
// (the wrapper decides). Returns the cudaError_t of the first launch that failed (0 = all
// accepted).
extern "C" int pt_embedding_scatter_add(const void* dst, const void* upd, const void* sorted_keys,
                                        const void* perm, void* runs, void* long_rows, void* out,
                                        int64_t n, int64_t h, int64_t d, int dst_dtype,
                                        int upd_dtype, int vec, void* stream) {
  if (n < 0 || n > 0x7fffffff || h <= 0 || h >= 0x7fffffff || d <= 0 || vec <= 0 || d % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(runs, 0, static_cast<size_t>(h) * sizeof(int2), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(long_rows, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    scatter_mark_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const int32_t*>(sorted_keys),
                                                    static_cast<int2*>(runs), n,
                                                    static_cast<int32_t>(h));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t* p = static_cast<const int64_t*>(perm);
  const int2* r = static_cast<const int2*>(runs);
  int32_t* lr = static_cast<int32_t*>(long_rows);
  if (dst_dtype == 0 && upd_dtype == 0)
    return launch_scatter_add<float, float>(dst, upd, p, r, lr, out, n, h, d, vec, s);
  if (dst_dtype == 0 && upd_dtype == 1)
    return launch_scatter_add<float, __nv_bfloat16>(dst, upd, p, r, lr, out, n, h, d, vec, s);
  if (dst_dtype == 1 && upd_dtype == 0)
    return launch_scatter_add<__nv_bfloat16, float>(dst, upd, p, r, lr, out, n, h, d, vec, s);
  if (dst_dtype == 1 && upd_dtype == 1)
    return launch_scatter_add<__nv_bfloat16, __nv_bfloat16>(dst, upd, p, r, lr, out, n, h, d,
                                                            vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
