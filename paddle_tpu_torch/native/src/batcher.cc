// Threaded parse+batch pipeline — the DataFeed stage in C++.
//
// Reference capability: the MultiSlotDataFeed worker pipeline
// (ref: paddle/fluid/framework/data_feed.cc MultiSlotDataFeed::
// ReadThread + PutToFeedVec — per-thread file reading, C++ line
// parsing and batch tensor assembly feeding the trainers). The r3
// pipeline did threaded READING in C++ (data_pipeline.cc) but parsed
// and batched per line from Python, paying one ctypes call per line;
// this stage finishes the job: parse workers pop raw lines from the
// loader queue, parse MultiSlot in C++ (strings.cc's parser), and the
// consumer stages whole zero-padded batches — one Python call per
// BATCH, with parsing parallel to both reading and consumption.
//
// ABI (ctypes, see native/__init__.py NativeBatcher):
//   pt_batcher_create(files, nfiles, read_threads, parse_threads,
//                     queue_cap, shuffle_buf, seed, epochs, mode,
//                     is_int[nslots], nslots, batch_size, drop_last)
//   pt_batcher_next(h, &rows, maxlens[nslots]) -> 1 staged / 0 end /
//                     -1 error (pt_batcher_error)
//   pt_batcher_fill(h, slot, dst)  // float32 or int64 [rows, maxlen]
//   pt_batcher_close(h)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "enforce.h"

extern "C" {
void* pt_loader_create(const char** files, int nfiles, int nthreads,
                       long queue_cap, long shuffle_buf, long seed,
                       int epochs, int mode);
const char* pt_loader_next(void* lp, long* len);
const char* pt_loader_error(void* lp);
void pt_loader_stop(void* lp);
void pt_loader_close(void* lp);
long pt_parse_multislot(const char* line, long line_len, long n_slots,
                        const signed char* is_int, double* fout,
                        long long* iout, long cap, long* sizes);
const char* pt_last_error();
}

namespace {

struct Sample {
  // per-slot values, one vector per slot (floats or ints by slot kind)
  std::vector<std::vector<float>> f;
  std::vector<std::vector<int64_t>> i;
  std::vector<long> sizes;
};

class SampleQueue {
 public:
  explicit SampleQueue(size_t cap) : cap_(cap) {}

  bool Push(Sample&& s) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_push_.wait(lk, [&] { return closed_ || q_.size() < cap_; });
    if (closed_) return false;
    q_.emplace_back(std::move(s));
    cv_pop_.notify_one();
    return true;
  }

  bool Pop(Sample* out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_pop_.wait(lk, [&] { return closed_ || !q_.empty(); });
    if (q_.empty()) return false;   // closed and drained
    *out = std::move(q_.front());
    q_.pop_front();
    cv_push_.notify_one();
    return true;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    cv_push_.notify_all();
    cv_pop_.notify_all();
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_push_, cv_pop_;
  std::deque<Sample> q_;
  size_t cap_;
  bool closed_ = false;
};

struct Batcher {
  void* loader = nullptr;
  SampleQueue queue;
  std::vector<std::thread> parsers;
  std::vector<signed char> is_int;
  long nslots;
  long batch_size;
  bool drop_last;
  std::atomic<int> live{0};
  std::mutex err_mu;
  std::string error;
  // staged batch (consumer-side, single consumer)
  std::vector<Sample> staged;
  std::vector<long> maxlens;

  explicit Batcher(size_t cap) : queue(cap) {}

  void SetError(const std::string& m) {
    std::lock_guard<std::mutex> lk(err_mu);
    if (error.empty()) error = m;
  }

  bool HasError() {
    std::lock_guard<std::mutex> lk(err_mu);
    return !error.empty();
  }
};

void parser_main(Batcher* B) {
  std::vector<double> fbuf(1 << 12);
  std::vector<long long> ibuf(1 << 12);
  std::vector<long> sizes(B->nslots);
  for (;;) {
    long len = 0;
    const char* line = pt_loader_next(B->loader, &len);
    if (line == nullptr) {
      if (len == -2) B->SetError(pt_loader_error(B->loader));
      break;
    }
    // skip blank / whitespace-only lines like the Python fallback's
    // `if ln.strip()` filter
    bool blank = true;
    for (long c = 0; c < len; ++c) {
      if (line[c] != ' ' && line[c] != '\t' && line[c] != '\r' &&
          line[c] != '\n') {
        blank = false;
        break;
      }
    }
    if (blank) continue;
    // size the value buffers from the line itself (a line of L bytes
    // holds < L/2 + slots tokens) — the Python parse path sizes its
    // cap the same way, so no line the fallback accepts can overflow
    long need = len / 2 + B->nslots + 8;
    if (static_cast<long>(fbuf.size()) < need) {
      fbuf.resize(need);
      ibuf.resize(need);
    }
    long total = pt_parse_multislot(line, len, B->nslots,
                                    B->is_int.data(), fbuf.data(),
                                    ibuf.data(),
                                    static_cast<long>(fbuf.size()),
                                    sizes.data());
    if (total < 0) {
      B->SetError(pt_last_error());
      break;
    }
    Sample s;
    s.sizes.assign(sizes.begin(), sizes.end());
    s.f.resize(B->nslots);
    s.i.resize(B->nslots);
    // pt_parse_multislot writes BOTH buffers at one GLOBAL offset
    // (fout[total+i]/iout[total+i] share the accumulated `total`
    // across all slots) — unpack with the same single offset, exactly
    // like the Python wrapper (native/__init__.py parse_multislot)
    long off = 0;
    for (long k = 0; k < B->nslots; ++k) {
      if (B->is_int[k]) {
        s.i[k].assign(ibuf.begin() + off,
                      ibuf.begin() + off + sizes[k]);
      } else {
        s.f[k].assign(fbuf.begin() + off,
                      fbuf.begin() + off + sizes[k]);
      }
      off += sizes[k];
    }
    if (!B->queue.Push(std::move(s))) break;
  }
  if (--B->live == 0) B->queue.Close();
}

}  // namespace

extern "C" {

void* pt_batcher_create(const char** files, int nfiles,
                        int read_threads, int parse_threads,
                        long queue_cap, long shuffle_buf, long seed,
                        int epochs, int mode,
                        const signed char* is_int, int nslots,
                        long batch_size, int drop_last) {
  if (nfiles <= 0 || nslots <= 0 || batch_size <= 0) {
    pt::set_error(
        "batcher: need nfiles > 0, nslots > 0, batch_size > 0");
    return nullptr;
  }
  void* loader = pt_loader_create(files, nfiles,
                                  read_threads > 0 ? read_threads : 1,
                                  queue_cap > 0 ? queue_cap : 1024,
                                  shuffle_buf, seed, epochs, mode);
  if (loader == nullptr) return nullptr;
  auto* B = new Batcher(queue_cap > 0 ? queue_cap : 1024);
  B->loader = loader;
  B->is_int.assign(is_int, is_int + nslots);
  B->nslots = nslots;
  B->batch_size = batch_size;
  B->drop_last = drop_last != 0;
  int np = parse_threads > 0 ? parse_threads : 1;
  B->live = np;
  for (int t = 0; t < np; ++t) B->parsers.emplace_back(parser_main, B);
  return B;
}

// Stage the next batch. rows <- actual batch rows; maxlens[nslots] <-
// per-slot padded lengths. Returns 1 when staged, 0 at end-of-stream,
// -1 when a worker failed (pt_batcher_error).
long pt_batcher_next(void* h, long* rows, long* maxlens) {
  auto* B = static_cast<Batcher*>(h);
  B->staged.clear();
  B->staged.reserve(B->batch_size);
  Sample s;
  while (static_cast<long>(B->staged.size()) < B->batch_size &&
         B->queue.Pop(&s)) {
    B->staged.emplace_back(std::move(s));
  }
  if (B->HasError()) return -1;
  if (B->staged.empty()) return 0;
  if (B->drop_last &&
      static_cast<long>(B->staged.size()) < B->batch_size) {
    return 0;
  }
  // width floor 0, matching the Python _pad_batch (an all-empty slot
  // batches to shape [B, 0] on both paths)
  B->maxlens.assign(B->nslots, 0);
  for (const auto& smp : B->staged) {
    for (long k = 0; k < B->nslots; ++k) {
      if (smp.sizes[k] > B->maxlens[k]) B->maxlens[k] = smp.sizes[k];
    }
  }
  *rows = static_cast<long>(B->staged.size());
  std::memcpy(maxlens, B->maxlens.data(),
              B->nslots * sizeof(long));
  return 1;
}

// Copy the staged batch's slot into dst as zero-padded
// [rows, maxlen] float32 (float slots) or int64 (int slots).
int pt_batcher_fill(void* h, int slot, void* dst) {
  auto* B = static_cast<Batcher*>(h);
  if (slot < 0 || slot >= B->nslots || B->staged.empty()) return -1;
  long ml = B->maxlens[slot];
  if (B->is_int[slot]) {
    auto* out = static_cast<int64_t*>(dst);
    std::memset(out, 0, B->staged.size() * ml * sizeof(int64_t));
    for (size_t r = 0; r < B->staged.size(); ++r) {
      const auto& v = B->staged[r].i[slot];
      std::memcpy(out + r * ml, v.data(), v.size() * sizeof(int64_t));
    }
  } else {
    auto* out = static_cast<float*>(dst);
    std::memset(out, 0, B->staged.size() * ml * sizeof(float));
    for (size_t r = 0; r < B->staged.size(); ++r) {
      const auto& v = B->staged[r].f[slot];
      std::memcpy(out + r * ml, v.data(), v.size() * sizeof(float));
    }
  }
  return 0;
}

const char* pt_batcher_error(void* h) {
  auto* B = static_cast<Batcher*>(h);
  std::lock_guard<std::mutex> lk(B->err_mu);
  return B->error.c_str();
}

void pt_batcher_close(void* h) {
  auto* B = static_cast<Batcher*>(h);
  B->queue.Close();
  // order matters: wake parsers blocked in pt_loader_next (stop), join
  // them, and only THEN destroy the loader — a parser mid-call must
  // never touch a deleted Loader
  pt_loader_stop(B->loader);
  for (auto& t : B->parsers) t.join();
  pt_loader_close(B->loader);
  delete B;
}

}  // extern "C"
