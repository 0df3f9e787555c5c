// Error handling for the native runtime — the PADDLE_ENFORCE analog
// (ref: platform/enforce.h:239-354). C ABI boundary: native functions
// return error codes / null and stash a thread-local message the Python
// side fetches via pt_last_error().
#pragma once

#include <cstdarg>
#include <cstdio>
#include <string>

namespace pt {

inline thread_local std::string g_last_error;

inline void set_error(const char* fmt, ...) {
  char buf[1024];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof(buf), fmt, ap);
  va_end(ap);
  g_last_error = buf;
}

#define PT_ENFORCE(cond, ...)        \
  do {                               \
    if (!(cond)) {                   \
      ::pt::set_error(__VA_ARGS__);  \
      return nullptr;                \
    }                                \
  } while (0)

#define PT_ENFORCE_RC(cond, rc, ...) \
  do {                               \
    if (!(cond)) {                   \
      ::pt::set_error(__VA_ARGS__);  \
      return (rc);                   \
    }                                \
  } while (0)

}  // namespace pt

extern "C" const char* pt_last_error();
