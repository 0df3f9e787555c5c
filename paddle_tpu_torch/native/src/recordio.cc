// RecordIO: chunked, CRC32-checked, optionally deflate-compressed record
// file format + reader/writer (TPU-native rebuild of
// paddle/fluid/recordio/{header,chunk,writer,scanner}.cc — same
// capability, fresh layout).
//
// File layout:
//   repeated CHUNK:
//     magic  u32 LE  (0x50544331 "PTC1")
//     flags  u32 LE  (bit0: deflate-compressed payload)
//     n_rec  u32 LE
//     raw_len u32 LE (uncompressed payload bytes)
//     comp_len u32 LE (stored payload bytes)
//     crc32  u32 LE  (of the stored payload)
//     payload: n_rec x (u32 LE length) | record bytes...
#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "enforce.h"

namespace {

constexpr uint32_t kMagic = 0x50544331u;
constexpr uint32_t kFlagCompress = 1u;

struct Writer {
  FILE* f = nullptr;
  bool compress = false;
  size_t max_chunk_records = 1000;
  size_t max_chunk_bytes = 1 << 20;
  std::vector<std::string> pending;
  size_t pending_bytes = 0;
};

struct Scanner {
  FILE* f = nullptr;
  std::vector<std::string> chunk;   // decoded records of current chunk
  size_t pos = 0;                   // next record within chunk
};

bool write_u32(FILE* f, uint32_t v) {
  unsigned char b[4] = {static_cast<unsigned char>(v & 0xff),
                        static_cast<unsigned char>((v >> 8) & 0xff),
                        static_cast<unsigned char>((v >> 16) & 0xff),
                        static_cast<unsigned char>((v >> 24) & 0xff)};
  return fwrite(b, 1, 4, f) == 4;
}

bool read_u32(FILE* f, uint32_t* v) {
  unsigned char b[4];
  if (fread(b, 1, 4, f) != 4) return false;
  *v = static_cast<uint32_t>(b[0]) | (static_cast<uint32_t>(b[1]) << 8) |
       (static_cast<uint32_t>(b[2]) << 16) |
       (static_cast<uint32_t>(b[3]) << 24);
  return true;
}

int flush_chunk(Writer* w) {
  if (w->pending.empty()) return 0;
  std::string payload;
  payload.reserve(w->pending_bytes + 4 * w->pending.size());
  for (const auto& r : w->pending) {
    uint32_t n = static_cast<uint32_t>(r.size());
    char lb[4] = {static_cast<char>(n & 0xff),
                  static_cast<char>((n >> 8) & 0xff),
                  static_cast<char>((n >> 16) & 0xff),
                  static_cast<char>((n >> 24) & 0xff)};
    payload.append(lb, 4);
    payload.append(r);
  }
  std::string stored = payload;
  uint32_t flags = 0;
  if (w->compress) {
    uLongf cap = compressBound(payload.size());
    std::string comp(cap, '\0');
    if (compress2(reinterpret_cast<Bytef*>(&comp[0]), &cap,
                  reinterpret_cast<const Bytef*>(payload.data()),
                  payload.size(), Z_DEFAULT_COMPRESSION) == Z_OK &&
        cap < payload.size()) {
      comp.resize(cap);
      stored.swap(comp);
      flags |= kFlagCompress;
    }
  }
  uint32_t crc = crc32(0L, reinterpret_cast<const Bytef*>(stored.data()),
                       stored.size());
  PT_ENFORCE_RC(write_u32(w->f, kMagic), -1, "recordio: write failed");
  PT_ENFORCE_RC(write_u32(w->f, flags), -1, "recordio: write failed");
  PT_ENFORCE_RC(
      write_u32(w->f, static_cast<uint32_t>(w->pending.size())), -1,
      "recordio: write failed");
  PT_ENFORCE_RC(write_u32(w->f, static_cast<uint32_t>(payload.size())), -1,
                "recordio: write failed");
  PT_ENFORCE_RC(write_u32(w->f, static_cast<uint32_t>(stored.size())), -1,
                "recordio: write failed");
  PT_ENFORCE_RC(write_u32(w->f, crc), -1, "recordio: write failed");
  PT_ENFORCE_RC(fwrite(stored.data(), 1, stored.size(), w->f) ==
                    stored.size(), -1, "recordio: write failed");
  w->pending.clear();
  w->pending_bytes = 0;
  return 0;
}

// returns 1 on chunk read, 0 on clean EOF, -1 on error
int read_chunk(Scanner* s) {
  uint32_t magic;
  if (!read_u32(s->f, &magic)) return 0;  // EOF
  PT_ENFORCE_RC(magic == kMagic, -1,
                "recordio: bad chunk magic 0x%08x", magic);
  uint32_t flags, n_rec, raw_len, comp_len, crc;
  PT_ENFORCE_RC(read_u32(s->f, &flags) && read_u32(s->f, &n_rec) &&
                    read_u32(s->f, &raw_len) && read_u32(s->f, &comp_len) &&
                    read_u32(s->f, &crc), -1,
                "recordio: truncated chunk header");
  // header fields are not covered by the CRC: bound them before
  // allocating so a corrupt length can't bad_alloc across the C ABI
  constexpr uint32_t kMaxChunk = 1u << 30;  // 1 GiB sanity cap
  PT_ENFORCE_RC(comp_len <= kMaxChunk && raw_len <= kMaxChunk &&
                    n_rec <= kMaxChunk / 4,
                -1, "recordio: implausible chunk header (n_rec=%u raw=%u "
                "comp=%u)", n_rec, raw_len, comp_len);
  std::string stored(comp_len, '\0');
  PT_ENFORCE_RC(fread(&stored[0], 1, comp_len, s->f) == comp_len, -1,
                "recordio: truncated chunk payload");
  uint32_t got = crc32(0L, reinterpret_cast<const Bytef*>(stored.data()),
                       stored.size());
  PT_ENFORCE_RC(got == crc, -1,
                "recordio: CRC mismatch (stored 0x%08x, computed 0x%08x)",
                crc, got);
  std::string payload;
  if (flags & kFlagCompress) {
    payload.resize(raw_len);
    uLongf dlen = raw_len;
    PT_ENFORCE_RC(uncompress(reinterpret_cast<Bytef*>(&payload[0]), &dlen,
                             reinterpret_cast<const Bytef*>(stored.data()),
                             stored.size()) == Z_OK && dlen == raw_len,
                  -1, "recordio: decompress failed");
  } else {
    payload.swap(stored);
  }
  s->chunk.clear();
  s->pos = 0;
  size_t off = 0;
  for (uint32_t i = 0; i < n_rec; ++i) {
    PT_ENFORCE_RC(off + 4 <= payload.size(), -1,
                  "recordio: corrupt record table");
    uint32_t n = static_cast<uint32_t>(
                     static_cast<unsigned char>(payload[off])) |
                 (static_cast<uint32_t>(
                      static_cast<unsigned char>(payload[off + 1])) << 8) |
                 (static_cast<uint32_t>(
                      static_cast<unsigned char>(payload[off + 2])) << 16) |
                 (static_cast<uint32_t>(
                      static_cast<unsigned char>(payload[off + 3])) << 24);
    off += 4;
    PT_ENFORCE_RC(off + n <= payload.size(), -1,
                  "recordio: record overruns chunk");
    s->chunk.emplace_back(payload.substr(off, n));
    off += n;
  }
  return 1;
}

}  // namespace

extern "C" {

const char* pt_last_error() { return pt::g_last_error.c_str(); }

void* pt_recordio_writer_open(const char* path, int compress,
                              int max_chunk_records, long max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  PT_ENFORCE(f != nullptr, "recordio: cannot open %s for write", path);
  auto* w = new Writer();
  w->f = f;
  w->compress = compress != 0;
  if (max_chunk_records > 0) w->max_chunk_records = max_chunk_records;
  if (max_chunk_bytes > 0) w->max_chunk_bytes = max_chunk_bytes;
  return w;
}

int pt_recordio_write(void* wp, const char* data, long len) {
  auto* w = static_cast<Writer*>(wp);
  w->pending.emplace_back(data, static_cast<size_t>(len));
  w->pending_bytes += len;
  if (w->pending.size() >= w->max_chunk_records ||
      w->pending_bytes >= w->max_chunk_bytes) {
    return flush_chunk(w);
  }
  return 0;
}

int pt_recordio_writer_close(void* wp) {
  auto* w = static_cast<Writer*>(wp);
  int rc = flush_chunk(w);
  if (fclose(w->f) != 0 && rc == 0) {
    pt::set_error("recordio: fclose failed (buffered data lost)");
    rc = -1;
  }
  delete w;
  return rc;
}

void* pt_recordio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  PT_ENFORCE(f != nullptr, "recordio: cannot open %s for read", path);
  auto* s = new Scanner();
  s->f = f;
  return s;
}

// Returns pointer to record bytes valid until next call; sets *len.
// len = -1: EOF. len = -2: error (see pt_last_error).
const char* pt_recordio_next(void* sp, long* len) {
  auto* s = static_cast<Scanner*>(sp);
  while (s->pos >= s->chunk.size()) {
    int rc = read_chunk(s);
    if (rc == 0) {
      *len = -1;
      return nullptr;
    }
    if (rc < 0) {
      *len = -2;
      return nullptr;
    }
  }
  const std::string& r = s->chunk[s->pos++];
  *len = static_cast<long>(r.size());
  return r.data();
}

void pt_recordio_scanner_close(void* sp) {
  auto* s = static_cast<Scanner*>(sp);
  fclose(s->f);
  delete s;
}

}  // extern "C"
