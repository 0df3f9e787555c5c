// Native string utilities — the paddle/fluid/string analog (SURVEY §2.1
// "string utils" row: Piece, printf-style Format, pretty_log, Split;
// ref: string/{piece,printf,pretty_log,string_helper}) — plus the hot
// consumer they exist for: the MultiSlot sample-line parser
// (ref: framework/data_feed.cc MultiSlotDataFeed parsing), exposed over
// the C ABI so the Python dataio path can parse at C speed.

#include <cctype>
#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "enforce.h"

namespace pt {
namespace strings {

// Non-owning view (ref: string/piece.h). C++17 string_view exists; this
// thin alias keeps the reference surface name and the helpers together.
struct Piece {
  const char* data = nullptr;
  size_t len = 0;
  Piece() = default;
  Piece(const char* d, size_t l) : data(d), len(l) {}
  std::string str() const { return std::string(data, len); }
};

inline Piece TrimSpaces(Piece p) {
  while (p.len && std::isspace(static_cast<unsigned char>(p.data[0]))) {
    ++p.data;
    --p.len;
  }
  while (p.len &&
         std::isspace(static_cast<unsigned char>(p.data[p.len - 1]))) {
    --p.len;
  }
  return p;
}

// ref: string/split.h / string_helper.h split_string
std::vector<Piece> Split(const char* s, size_t n, char sep) {
  std::vector<Piece> out;
  size_t start = 0;
  for (size_t i = 0; i <= n; ++i) {
    if (i == n || s[i] == sep) {
      if (i > start) out.emplace_back(s + start, i - start);
      start = i + 1;
    }
  }
  return out;
}

// ref: string/printf.h (tinyformat's job, vsnprintf is enough here)
std::string Format(const char* fmt, ...) {
  char buf[2048];
  va_list ap;
  va_start(ap, fmt);
  int n = vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  return std::string(buf, n < 0 ? 0 : static_cast<size_t>(n));
}

// ref: string/pretty_log.h — tagged banner to stderr
void PrettyLog(const char* tag, const char* msg) {
  std::fprintf(stderr, "--- [%s] %s\n", tag, msg);
}

}  // namespace strings
}  // namespace pt

extern "C" {

// Parse one MultiSlot sample line: per slot "<n> v1 ... vn",
// space-separated (ref: framework/data_feed.cc CheckFile / Deserialize).
// is_int[s] selects the slot's parse: integer slots go through strtoll
// into iout[] (exact for full int64 range — doubles corrupt ids above
// 2^53), float slots through strtod into fout[]; both buffers are
// indexed by the same running offset, sizes[s] receives slot s's count.
// Returns total values, or -1 with pt_last_error set (truncated line /
// bad number / capacity).
long pt_parse_multislot(const char* line, long line_len, long n_slots,
                        const signed char* is_int, double* fout,
                        long long* iout, long cap, long* sizes) {
  const char* p = line;
  const char* end = line + line_len;
  long total = 0;
  auto skip_ws = [&]() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                       *p == '\r')) {
      ++p;
    }
  };
  auto at_token_end = [&](const char* q) {
    return q == end || *q == ' ' || *q == '\t' || *q == '\n' ||
           *q == '\r';
  };
  for (long s = 0; s < n_slots; ++s) {
    skip_ws();
    if (p >= end) {
      pt::set_error("multislot line truncated at slot %ld", s);
      return -1;
    }
    char* q = nullptr;
    long n = std::strtol(p, &q, 10);
    // the count must be a whole token: '2.5' would otherwise parse as
    // count 2 and feed '.5' into the first value (the Python fallback
    // raises on int('2.5'))
    if (q == p || n < 0 || !at_token_end(q)) {
      pt::set_error("multislot: bad count at slot %ld", s);
      return -1;
    }
    p = q;
    if (total + n > cap) {
      pt::set_error("multislot: capacity %ld exceeded", cap);
      return -1;
    }
    const bool want_int = is_int && is_int[s];
    for (long i = 0; i < n; ++i) {
      skip_ws();
      if (p >= end) {
        pt::set_error(
            "multislot line truncated inside slot %ld: declared %ld "
            "values, found %ld", s, n, i);
        return -1;
      }
      q = nullptr;
      if (want_int) {
        long long v = std::strtoll(p, &q, 10);
        // '3.7' in an int slot: strtoll stops at '.', the fallback
        // parser raises there too — reject instead of truncating
        if (q == p || !at_token_end(q)) {
          pt::set_error("multislot: bad value in slot %ld", s);
          return -1;
        }
        iout[total + i] = v;
      } else {
        double v = std::strtod(p, &q);
        if (q == p || !at_token_end(q)) {
          pt::set_error("multislot: bad value in slot %ld", s);
          return -1;
        }
        fout[total + i] = v;
      }
      p = q;
    }
    sizes[s] = n;
    total += n;
  }
  return total;
}

// Split helper over the C ABI: writes byte offsets of each token's
// (start, end) into offs as pairs; returns token count (capped at
// max_tokens) — lets Python split without per-token object churn.
long pt_split(const char* s, long n, char sep, long* offs,
              long max_tokens) {
  auto pieces = pt::strings::Split(s, static_cast<size_t>(n), sep);
  long count = 0;
  for (const auto& pc : pieces) {
    if (count >= max_tokens) break;
    offs[2 * count] = pc.data - s;
    offs[2 * count + 1] = (pc.data - s) + static_cast<long>(pc.len);
    ++count;
  }
  return count;
}

void pt_pretty_log(const char* tag, const char* msg) {
  pt::strings::PrettyLog(tag, msg);
}

}  // extern "C"
