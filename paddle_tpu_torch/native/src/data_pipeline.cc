// Deterministic sharded host data pipeline: per-file reader shards ->
// per-shard ordered queues -> round-robin merge.
//
// TPU-native rebuild of the reference's DataFeed/Dataset machinery
// (ref: framework/data_feed.h:62 DataFeed, data_feed.h:205
// InMemoryDataFeed, operators/reader/lod_tensor_blocking_queue.h,
// operators/reader/buffered_reader.cc), made DETERMINISTIC under the
// sharded-cursor contract (ISSUE 10):
//
//   * shard = file. Shard i's per-epoch record sequence is a pure
//     function of (file bytes, seed, i, epoch): file order, optionally
//     decorrelated by a per-shard reservoir of `shuffle_buffer`
//     records driven by a splitmix64 RNG re-derived per (seed, shard,
//     epoch). The RNG is spelled out below and implemented identically
//     by the pure-Python oracle (dataio.dataloader._ShardRng) — bit-
//     identical streams are the contract, not an accident.
//   * worker threads own fixed shard SETS (shard i belongs to worker
//     i % nthreads) and multiplex them fairly; nthreads is a pure
//     throughput knob that can NEVER change record order.
//   * the consumer merges shards round-robin with an epoch barrier:
//     one record per live shard per cycle, a shard that finished the
//     current epoch parks until every shard has, then the global
//     epoch advances. The merged order is therefore deterministic and
//     equal to the Python reader's.
//   * the cursor is consumer-side: a vector of per-file byte offsets
//     (+ per-shard emitted counts, i.e. the shuffle-buffer snapshot —
//     the reservoir is replayable from (seed, shard, epoch, count)),
//     the global epoch, the round-robin position and the consumed
//     total, updated as records are HANDED TO the caller — worker
//     read-ahead parked in queues is never counted. pt_loader_state /
//     pt_loader_restore move it across process restarts.
#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "enforce.h"

extern "C" {
void* pt_recordio_scanner_open(const char* path);
const char* pt_recordio_next(void* sp, long* len);
void pt_recordio_scanner_close(void* sp);
}

namespace {

// splitmix64 over an FNV-1a-mixed (seed, shard, epoch) key — chosen
// because both halves are ~10 lines in any language; the Python oracle
// implements the exact same arithmetic (dataloader._ShardRng).
struct ShardRng {
  uint64_t s = 0;

  void Seed(uint64_t seed, uint64_t shard, uint64_t epoch) {
    uint64_t h = 0xcbf29ce484222325ULL;
    const uint64_t vals[3] = {seed, shard, epoch};
    for (uint64_t v : vals) h = (h ^ v) * 0x100000001b3ULL;
    s = h ? h : 0x9E3779B97F4A7C15ULL;
  }

  uint64_t Next() {
    s += 0x9E3779B97F4A7C15ULL;
    uint64_t z = s;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }

  uint64_t Below(uint64_t n) { return Next() % n; }

  void Shuffle(std::vector<std::string>* buf) {  // Fisher-Yates
    for (size_t i = buf->size(); i > 1; --i) {
      size_t j = static_cast<size_t>(Below(i));
      std::swap((*buf)[i - 1], (*buf)[j]);
    }
  }
};

enum EntryKind { K_REC = 0, K_END = 1, K_DONE = 2 };

struct Entry {
  int kind = K_REC;
  std::string rec;
  long offset = 0;   // shard read offset after the record's source
  long emitted = 0;  // shard epoch_records after this record
};

// Bounded per-shard queue: producer TryPush (never blocks — the worker
// multiplexes several shards and must not park on one full queue while
// the consumer waits on a sibling), consumer Pop blocks.
class ShardQueue {
 public:
  explicit ShardQueue(size_t cap) : cap_(cap) {}

  bool TryPush(Entry&& e) {
    bool was_empty;
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (closed_ || q_.size() >= cap_) return closed_ ? true : false;
      was_empty = q_.empty();
      q_.emplace_back(std::move(e));
    }
    // a consumer can only be parked in Pop when it saw the queue
    // empty — notifying on every push would pay a futex wake per
    // record on the hot path for nothing
    if (was_empty) not_empty_.notify_one();
    return true;
  }

  // Move up to n entries into out (>= 1: blocks until something is
  // available). One lock amortizes over the whole run — the consumer
  // merge stashes runs per shard and pays ~no locking per record.
  // false => closed AND drained (teardown / error)
  bool PopRun(std::deque<Entry>* out, size_t n) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || closed_; });
    if (q_.empty()) return false;
    if (n > q_.size()) n = q_.size();
    for (size_t k = 0; k < n; ++k) {
      out->emplace_back(std::move(q_.front()));
      q_.pop_front();
    }
    return true;
  }

  void Close() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      closed_ = true;
    }
    not_empty_.notify_all();
  }

  size_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

 private:
  std::mutex mu_;
  std::condition_variable not_empty_;
  std::deque<Entry> q_;
  size_t cap_;
  bool closed_ = false;
};

enum ShardPhase { P_READ, P_DRAIN, P_END, P_DONE_PUSH, P_DONE };

struct Shard {
  int idx = 0;
  std::string path;
  std::unique_ptr<ShardQueue> q;

  // producer state (owned by exactly one worker thread)
  long epoch = 0;
  long read_off = 0;   // bytes consumed into records (ordinal: recordio)
  long emitted = 0;    // records emitted (post-reservoir) this epoch
  long resume_skip = 0;  // shuffle replay: swallow this many emissions
  long seek_to = -1;     // no-shuffle resume: fseek before reading
  int phase = P_READ;
  FILE* f = nullptr;
  void* rio = nullptr;
  bool file_eof = false;
  std::string carry;  // partial text line across read chunks
  std::deque<std::pair<std::string, long>> recs;  // parsed, +end offset
  std::vector<std::string> resv;  // reservoir
  size_t drain_pos = 0;
  ShardRng rng;
  Entry pending;
  bool has_pending = false;

  void CloseFile() {
    if (f) {
      fclose(f);
      f = nullptr;
    }
    if (rio) {
      pt_recordio_scanner_close(rio);
      rio = nullptr;
    }
  }
};

struct Loader {
  std::vector<Shard> shards;
  std::vector<std::thread> workers;
  int nthreads = 1;
  int epochs = 1;   // -1 = cycle forever
  int mode = 0;     // 0 = text lines, 1 = recordio
  size_t shuffle_buf = 0;
  uint64_t seed = 0;

  std::atomic<bool> stop{false};
  std::atomic<bool> started{false};
  std::atomic<bool> errored{false};  // lock-free mirror of !error.empty()
  std::mutex start_mu;
  std::mutex err_mu;
  std::string error;

  // consumer-side merge state + cursor (one logical consumer; the
  // mutex makes concurrent callers safe — they interleave pops of ONE
  // deterministic stream)
  std::mutex merge_mu;
  struct ShardCursor {
    long offset = 0;
    long emitted = 0;
    bool eof = false;   // finished the CURRENT epoch (parked)
    bool done = false;  // finished every epoch
  };
  std::vector<ShardCursor> sc;
  // per-shard consumer-side run buffers (filled by PopRun): entries
  // here are read-ahead exactly like queued ones — the cursor only
  // moves when the merge emits
  std::vector<std::deque<Entry>> stash;
  long cur_epoch = 0;
  long rr = 0;
  long consumed = 0;
  std::string spill;  // bulk-read record that outgrew the caller buffer
  bool has_spill = false;

  void SetError(const std::string& msg) {
    {
      std::lock_guard<std::mutex> lk(err_mu);
      if (error.empty()) error = msg;
    }
    errored.store(true);
    stop.store(true);
    for (auto& s : shards) s.q->Close();
  }

  bool HasError() { return errored.load(std::memory_order_acquire); }
};

// ---- producer side --------------------------------------------------------

void StagePending(Shard& s, std::string&& rec, long off) {
  s.emitted++;
  if (s.resume_skip > 0) {  // replaying an already-consumed prefix
    s.resume_skip--;
    return;
  }
  s.pending.kind = K_REC;
  s.pending.rec = std::move(rec);
  s.pending.offset = off;
  s.pending.emitted = s.emitted;
  s.has_pending = true;
}

// Move the shard to the next epoch (or to DONE). Never emits END —
// callers push it first when the consumer expects one.
void BeginNextEpoch(Loader* L, Shard& s) {
  s.epoch++;
  s.CloseFile();
  s.read_off = 0;
  s.emitted = 0;
  s.resume_skip = 0;
  s.seek_to = -1;
  s.file_eof = false;
  s.carry.clear();
  s.recs.clear();
  s.resv.clear();
  s.drain_pos = 0;
  if (L->epochs >= 0 && s.epoch >= L->epochs) {
    s.pending = Entry{K_DONE, std::string(), 0, 0};
    s.has_pending = true;
    s.phase = P_DONE_PUSH;
  } else {
    s.rng.Seed(L->seed, static_cast<uint64_t>(s.idx),
               static_cast<uint64_t>(s.epoch));
    s.phase = P_READ;
  }
}

// Parse more records out of the file into s.recs. Returns false on
// I/O error (loader error set).
bool ReadMore(Loader* L, Shard& s) {
  if (L->mode == 1) {  // recordio (offsets are record ordinals)
    if (!s.rio) {
      s.rio = pt_recordio_scanner_open(s.path.c_str());
      if (!s.rio) {
        L->SetError(pt::g_last_error);
        return false;
      }
      // ordinal seek: replay/skip records up to seek_to
      for (long k = 0; k < s.seek_to; ++k) {
        long len = 0;
        if (pt_recordio_next(s.rio, &len) == nullptr) break;
      }
      s.seek_to = -1;
    }
    for (int k = 0; k < 64; ++k) {
      long len = 0;
      const char* p = pt_recordio_next(s.rio, &len);
      if (p == nullptr) {
        if (len == -2) {  // CRC/corruption: stop, surface it
          L->SetError(pt::g_last_error);
          return false;
        }
        s.file_eof = true;
        pt_recordio_scanner_close(s.rio);
        s.rio = nullptr;
        return true;
      }
      s.read_off++;
      s.recs.emplace_back(std::string(p, len), s.read_off);
    }
    return true;
  }
  if (!s.f) {
    s.f = fopen(s.path.c_str(), "rb");
    if (!s.f) {
      L->SetError("loader: cannot open " + s.path);
      return false;
    }
    if (s.seek_to > 0) fseek(s.f, s.seek_to, SEEK_SET);
    s.seek_to = -1;
  }
  // bulk reads + memchr line split (a byte-at-a-time fgetc loop would
  // serialize on the stdio lock and defeat the native reader)
  char cbuf[1 << 16];
  size_t n = fread(cbuf, 1, sizeof(cbuf), s.f);
  if (n == 0) {
    if (ferror(s.f)) {
      L->SetError("loader: read error on " + s.path);
      return false;
    }
    fclose(s.f);
    s.f = nullptr;
    if (!s.carry.empty()) {  // final line without trailing newline
      long end = s.read_off + static_cast<long>(s.carry.size());
      s.recs.emplace_back(std::move(s.carry), end);
      s.carry.clear();
      s.read_off = end;
    }
    s.file_eof = true;
    return true;
  }
  const char* p = cbuf;
  const char* end = cbuf + n;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (nl == nullptr) {
      s.carry.append(p, end - p);
      break;
    }
    long rend = s.read_off + static_cast<long>(s.carry.size()) +
                static_cast<long>(nl - p) + 1;
    if (s.carry.empty()) {
      s.recs.emplace_back(std::string(p, nl - p), rend);
    } else {
      s.carry.append(p, nl - p);
      s.recs.emplace_back(std::move(s.carry), rend);
      s.carry.clear();
    }
    s.read_off = rend;
    p = nl + 1;
  }
  return true;
}

// One record through the reservoir -> maybe a pending entry.
void EmitStep(Loader* L, Shard& s) {
  std::string rec = std::move(s.recs.front().first);
  long off = s.recs.front().second;
  s.recs.pop_front();
  if (L->shuffle_buf == 0) {
    StagePending(s, std::move(rec), off);
    return;
  }
  if (s.resv.size() < L->shuffle_buf) {
    s.resv.emplace_back(std::move(rec));
    return;
  }
  size_t j = static_cast<size_t>(s.rng.Below(s.resv.size()));
  std::string out = std::move(s.resv[j]);
  s.resv[j] = std::move(rec);
  StagePending(s, std::move(out), off);
}

// Advance one shard by a bounded burst. Returns whether progress was
// made (a blocked pending on a full queue is the only non-progress).
bool AdvanceShard(Loader* L, Shard& s) {
  bool prog = false;
  for (int burst = 0; burst < 64; ++burst) {
    if (L->stop.load(std::memory_order_relaxed)) return prog;
    if (s.has_pending) {
      Entry e = std::move(s.pending);
      int kind = e.kind;
      if (!s.q->TryPush(std::move(e))) {
        s.pending = std::move(e);  // NOLINT: moved-from only on success
        return prog;
      }
      s.has_pending = false;
      prog = true;
      if (kind == K_END) {
        BeginNextEpoch(L, s);
        continue;
      }
      if (kind == K_DONE) {
        s.phase = P_DONE;
        return prog;
      }
      continue;
    }
    switch (s.phase) {
      case P_READ:
        if (!s.recs.empty()) {
          EmitStep(L, s);
          prog = true;
        } else if (!s.file_eof) {
          if (!ReadMore(L, s)) return prog;
          prog = true;
        } else {  // epoch's input exhausted: drain the reservoir
          s.rng.Shuffle(&s.resv);
          s.drain_pos = 0;
          s.phase = P_DRAIN;
          prog = true;
        }
        break;
      case P_DRAIN:
        if (s.drain_pos < s.resv.size()) {
          StagePending(s, std::move(s.resv[s.drain_pos]), s.read_off);
          s.drain_pos++;
          prog = true;
        } else {
          s.resv.clear();
          s.pending = Entry{K_END, std::string(), 0, 0};
          s.has_pending = true;
          s.phase = P_END;  // epoch advance happens after END lands
          prog = true;
        }
        break;
      case P_END:      // waiting for END to push (handled above)
      case P_DONE_PUSH:  // waiting for DONE to push
      case P_DONE:
        return prog;
    }
  }
  return prog;
}

void worker_main(Loader* L, int tid) {
  std::vector<Shard*> mine;
  for (size_t i = tid; i < L->shards.size();
       i += static_cast<size_t>(L->nthreads))
    mine.push_back(&L->shards[i]);
  while (!L->stop.load(std::memory_order_relaxed)) {
    bool prog = false;
    bool all_done = true;
    for (Shard* s : mine) {
      if (s->phase == P_DONE) continue;
      all_done = false;
      if (AdvanceShard(L, *s)) prog = true;
    }
    if (all_done) return;
    if (!prog) {
      // every owned queue is full: back off until the consumer pops.
      // A plain sleep, not a timed condvar wait — gcc-10's
      // condition_variable::wait_for relock path is invisible to this
      // toolchain's TSAN (false double-lock). 50us keeps refill
      // latency well under the consumer's drain time for the default
      // queue depth while costing ~nothing when saturated
      std::this_thread::sleep_for(std::chrono::microseconds(50));
    }
  }
}

// ---- consumer side --------------------------------------------------------

void EnsureStarted(Loader* L) {
  if (L->started.load(std::memory_order_acquire)) return;
  std::lock_guard<std::mutex> lk(L->start_mu);
  if (L->started.load(std::memory_order_relaxed)) return;
  for (int t = 0; t < L->nthreads; ++t)
    L->workers.emplace_back(worker_main, L, t);
  L->started.store(true, std::memory_order_release);
}

// Deterministic round-robin merge with an epoch barrier. Caller holds
// merge_mu. Returns 1 record, 0 EOS, -2 worker error.
int MergeNext(Loader* L, std::string* out) {
  EnsureStarted(L);
  const long S = static_cast<long>(L->shards.size());
  for (;;) {
    if (L->HasError()) return -2;
    for (long k = 0; k < S; ++k) {
      long i = (L->rr + k) % S;
      auto& c = L->sc[i];
      if (c.done || c.eof) continue;
      auto& st = L->stash[i];
      if (st.empty()) {
        if (!L->shards[i].q->PopRun(&st, 32))
          return L->HasError() ? -2 : 0;  // closed: error or teardown
      }
      Entry& e = st.front();
      if (e.kind == K_DONE) {
        c.done = true;
        st.pop_front();
        continue;
      }
      if (e.kind == K_END) {
        c.eof = true;  // parked until every shard ends this epoch
        st.pop_front();
        continue;
      }
      c.offset = e.offset;
      c.emitted = e.emitted;
      L->consumed++;
      L->rr = (i + 1) % S;
      *out = std::move(e.rec);
      st.pop_front();
      return 1;
    }
    // a full pass emitted nothing: every shard is parked or done
    bool all_done = true;
    for (auto& c : L->sc) all_done = all_done && c.done;
    if (all_done) return 0;
    L->cur_epoch++;  // epoch barrier: unpark everyone
    L->rr = 0;
    for (auto& c : L->sc) {
      if (c.done) continue;
      c.eof = false;
      c.offset = 0;
      c.emitted = 0;
    }
  }
}

}  // namespace

extern "C" {

void* pt_loader_create(const char** files, int nfiles, int nthreads,
                       long queue_cap, long shuffle_buf, long seed,
                       int epochs, int mode) {
  PT_ENFORCE(nfiles > 0, "loader: empty file list");
  auto* L = new Loader();
  L->nthreads = nthreads > 0 ? nthreads : 1;
  if (L->nthreads > nfiles) L->nthreads = nfiles;
  L->epochs = epochs;
  L->mode = mode;
  L->shuffle_buf = shuffle_buf > 0 ? static_cast<size_t>(shuffle_buf) : 0;
  L->seed = static_cast<uint64_t>(seed);
  long total_cap = queue_cap > 0 ? queue_cap : 4096;
  // the floor serves two masters: >= 4 slots make strict round robin
  // deadlock-free (both sides bound per-shard depth divergence by 2),
  // and >= 64 keep the consumer drain time well above the workers'
  // backoff-sleep refill latency
  size_t per_shard = static_cast<size_t>(
      std::max<long>(64, total_cap / nfiles));
  L->shards.resize(nfiles);
  for (int i = 0; i < nfiles; ++i) {
    Shard& s = L->shards[i];
    s.idx = i;
    s.path = files[i];
    s.q.reset(new ShardQueue(per_shard));
    s.rng.Seed(L->seed, static_cast<uint64_t>(i), 0);
    if (L->epochs == 0) {  // zero epochs: nothing to read
      s.pending = Entry{K_DONE, std::string(), 0, 0};
      s.has_pending = true;
      s.phase = P_DONE_PUSH;
    }
  }
  L->sc.resize(nfiles);
  L->stash.resize(nfiles);
  return L;
}

// Restore the sharded cursor BEFORE the first record is read. Arrays
// are per-shard (length = nfiles): byte offsets (record ordinals for
// recordio), per-epoch emitted counts, finished-current-epoch flags.
// Returns 0, or -1 (error in pt_last_error) if reading already began.
int pt_loader_restore(void* lp, const long* offsets, const long* emitted,
                      const unsigned char* eof, int nshards,
                      long cur_epoch, long rr, long consumed) {
  auto* L = static_cast<Loader*>(lp);
  if (L->started.load() ||
      nshards != static_cast<int>(L->shards.size())) {
    pt::set_error(L->started.load()
                      ? "loader: restore after reading began"
                      : "loader: cursor has %d shard(s), loader has %zu",
                  nshards, L->shards.size());
    return -1;
  }
  std::lock_guard<std::mutex> lk(L->merge_mu);
  L->cur_epoch = cur_epoch;
  L->rr = rr;
  L->consumed = consumed;
  bool past_end = L->epochs >= 0 && cur_epoch >= L->epochs;
  for (size_t i = 0; i < L->shards.size(); ++i) {
    Shard& s = L->shards[i];
    auto& c = L->sc[i];
    c.offset = offsets[i];
    c.emitted = emitted[i];
    c.eof = eof[i] != 0;
    s.epoch = cur_epoch;
    if (past_end) {  // exhausted-stream cursor: re-reads nothing
      s.pending = Entry{K_DONE, std::string(), 0, 0};
      s.has_pending = true;
      s.phase = P_DONE_PUSH;
      continue;
    }
    s.rng.Seed(L->seed, static_cast<uint64_t>(i),
               static_cast<uint64_t>(cur_epoch));
    if (c.eof) {
      // this shard already finished the current epoch: the consumer
      // starts it parked (the END marker was consumed before the
      // cursor was cut), so the producer skips straight to the next
      // epoch WITHOUT re-emitting END
      BeginNextEpoch(L, s);  // s.epoch == cur_epoch -> cur_epoch + 1
    } else if (emitted[i] == 0 && offsets[i] == 0) {
      s.phase = P_READ;  // fresh epoch start
    } else if (L->shuffle_buf == 0) {
      // seekable: jump straight to the byte offset / record ordinal
      s.seek_to = offsets[i];
      s.read_off = offsets[i];
      s.emitted = emitted[i];
      s.phase = P_READ;
    } else {
      // reservoir history is a function of (seed, shard, epoch, count):
      // replay the epoch from the top, swallowing `emitted` outputs
      s.resume_skip = emitted[i];
      s.phase = P_READ;
    }
  }
  return 0;
}

// Snapshot the consumer-side cursor: reflects exactly the records
// already handed out via pt_loader_next/pt_loader_read.
void pt_loader_state(void* lp, long* offsets, long* emitted,
                     unsigned char* eof, long* cur_epoch, long* rr,
                     long* consumed) {
  auto* L = static_cast<Loader*>(lp);
  std::lock_guard<std::mutex> lk(L->merge_mu);
  for (size_t i = 0; i < L->sc.size(); ++i) {
    offsets[i] = L->sc[i].offset;
    emitted[i] = L->sc[i].emitted;
    eof[i] = L->sc[i].eof ? 1 : 0;
  }
  *cur_epoch = L->cur_epoch;
  *rr = L->rr;
  *consumed = L->consumed;
}

// Returns pointer valid until the next pt_loader_next call FROM THE
// SAME THREAD (thread_local buffer). *len = -1 on end-of-stream; -2 if
// a worker failed (pt_loader_error).
const char* pt_loader_next(void* lp, long* len) {
  auto* L = static_cast<Loader*>(lp);
  thread_local std::string last;
  int rc;
  {
    std::lock_guard<std::mutex> lk(L->merge_mu);
    if (L->has_spill) {
      last = std::move(L->spill);
      L->has_spill = false;
      rc = 1;
    } else {
      rc = MergeNext(L, &last);
    }
  }
  if (rc == 1) {
    *len = static_cast<long>(last.size());
    return last.data();
  }
  *len = rc == -2 ? -2 : -1;
  return nullptr;
}

// Bulk read: up to max_records records concatenated into buf (lens[i]
// = each record's size). With sep != 0 every record is followed by a
// '\n' byte — legal only for mode "lines", whose records can never
// contain one, and it lets Python split the whole block with ONE
// bytes.split() instead of a per-record slicing loop. Returns the
// record count (0 = end of stream), -2 on worker error, or -3 when
// the FIRST record does not fit in cap (lens[0] = needed bytes; the
// record is retained for the retry).
long pt_loader_read(void* lp, long max_records, char* buf, long cap,
                    long* lens, int sep) {
  auto* L = static_cast<Loader*>(lp);
  std::lock_guard<std::mutex> lk(L->merge_mu);
  long cnt = 0;
  long used = 0;
  long pad = sep ? 1 : 0;
  std::string rec;
  while (cnt < max_records) {
    if (L->has_spill) {
      rec = std::move(L->spill);
      L->has_spill = false;
    } else {
      int rc = MergeNext(L, &rec);
      if (rc == -2) return cnt > 0 ? cnt : -2;
      if (rc == 0) break;
    }
    long n = static_cast<long>(rec.size());
    if (used + n + pad > cap) {  // keep the record for the next call
      L->spill = std::move(rec);
      L->has_spill = true;
      if (cnt == 0) {
        lens[0] = n + pad;
        return -3;
      }
      break;
    }
    memcpy(buf + used, rec.data(), static_cast<size_t>(n));
    used += n;
    if (sep) buf[used++] = '\n';
    lens[cnt++] = n;
  }
  return cnt;
}

const char* pt_loader_error(void* lp) {
  auto* L = static_cast<Loader*>(lp);
  std::lock_guard<std::mutex> lk(L->err_mu);
  return L->error.c_str();
}

long pt_loader_queue_size(void* lp) {
  auto* L = static_cast<Loader*>(lp);
  size_t n = 0;
  for (auto& s : L->shards) n += s.q->Size();
  return static_cast<long>(n);
}

// Close the queues WITHOUT destroying the loader: wakes every blocked
// producer and consumer. Consumers layered on top (batcher.cc) call
// this, join their own threads, then pt_loader_close — the Loader must
// outlive every thread still inside pt_loader_next.
void pt_loader_stop(void* lp) {
  auto* L = static_cast<Loader*>(lp);
  L->stop.store(true);
  for (auto& s : L->shards) s.q->Close();
}

void pt_loader_close(void* lp) {
  auto* L = static_cast<Loader*>(lp);
  pt_loader_stop(lp);
  for (auto& t : L->workers) t.join();
  for (auto& s : L->shards) s.CloseFile();
  delete L;
}

}  // extern "C"
