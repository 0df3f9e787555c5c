// Embedding row gather for Hopper (sm_90a): rows = table[ids].
//
// Replaces: paddle_tpu/ops/pallas/embedding.py:_gather_kernel (via _gather_call),
// registry name "embedding_gather".
//
// What it computes: out[i, :] = table[id_i, :] for the n ids, where an id in [-h, h)
// selects its row (a negative id wraps once, to id + h, as jnp.take does) and any other
// id gives a row of NaN (jnp.take's fill value for a float table). This is the meaning
// of the JAX package's stock body, which the port gives its plain version too. Ids are
// int32 or int64 and are read on the card, so the host never syncs on them.
//
// What bounds it on the H100: memory. It reads n ids and n rows and writes n rows, with
// no arithmetic: 4 gathers of 100 rows of 32 fp32 (word2vec) move 26 KB, which no
// kernel can make long; 64x512 rows of 768 bf16 (BERT-base's word table) move 101 MB,
// a bound of ~30 us at 3.35 TB/s.
//
// What the design does about it: one warp per output row, so a row's bytes are read and
// written by 32 neighbouring threads at neighbouring addresses. The row is copied in
// 16-byte words where the row's bytes and both base pointers allow it (the wrapper
// decides), else in 4- or 2-byte words. The id is read once per warp (a broadcast).

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

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
