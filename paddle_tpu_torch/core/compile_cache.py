"""Persistent build cache for warm restarts: the port of
``paddle_tpu/core/compile_cache.py``.

The JAX package points jax's on-disk XLA compilation cache at a directory
so that a restarted process reads its executables instead of compiling
them again. The port compiles no XLA executables. What a restarted
process of the port would build again is its native libraries:

- the CUDA kernel libraries, one per ``csrc/<name>.cu``, that
  ``ops/kernels/_build.py`` builds with nvcc (tens of seconds for a
  fresh process on the card's machine);
- the data path's C++ library that ``native/__init__.py`` builds with g++.

Each library's file name carries a fingerprint of its sources and flags,
so a library found under its name is the one the sources would build.
``enable(dirname)`` points both build directories at ``dirname`` (by
default each lives inside the package, under ``paddle_tpu_torch/_build``),
so a restarted process finds what the previous one built.

Activation, in priority order:

- ``PADDLE_TPU_CACHE_DIR`` in the environment, read when
  ``paddle_tpu_torch.core`` is imported (any ``import paddle_tpu_torch``);
  a launcher sets it for its workers so that restarted ranks inherit it;
- an explicit ``enable(dirname)`` call.

``stats()`` counts, since the process started (or ``reset_stats``), each
library looked up on disk as a request, one found under its fingerprint
as a hit and one built as a miss; the registry mirrors them under the
JAX names (``compile_cache_hits_total``, ``compile_cache_misses_total``,
``compile_cache_requests_total``), and ``profiler.compilation_cache_stats``
and ``profiler.summary`` read them. A restarted process with hits and no
misses built nothing.
"""

import os
import threading

from paddle_tpu_torch.monitor.registry import counter as _counter

__all__ = ["enable", "disable", "is_enabled", "cache_dir", "stats",
           "reset_stats", "enable_from_env", "build_dir", "record",
           "ENV_VAR"]

ENV_VAR = "PADDLE_TPU_CACHE_DIR"

_lock = threading.Lock()
_state = {"dir": None}
_counters = {"hits": 0, "misses": 0, "requests": 0}

_m_counters = {
    "hits": _counter("compile_cache_hits_total",
                     "Native libraries (CUDA kernels, the data path's "
                     "C++) found built under their fingerprint"),
    "misses": _counter("compile_cache_misses_total",
                       "Native libraries that were not found and were "
                       "built (nvcc or g++)"),
    "requests": _counter("compile_cache_requests_total",
                         "Native library lookups on disk"),
}


def _loaded_before():
    """Whether a kernel library or the native library is loaded in this
    process already (it stays loaded from where it was built)."""
    from paddle_tpu_torch import native
    from paddle_tpu_torch.ops.kernels import _build
    return bool(_build._libs) or native._lib is not None


def enable(dirname):
    """Build and look up the kernel and native libraries in ``dirname``
    (made if missing). Returns its absolute path."""
    if _loaded_before():
        # once per process, not per enable(): retry loops and tests
        # re-point the cache freely and must not spam the log
        from paddle_tpu_torch.core.enforce import warn_once
        warn_once(
            "compile_cache_mid_process",
            "compilation cache enabled mid-process: libraries loaded "
            "before enable() were not cached (they stay loaded from where "
            "they were built; later builds go to the cache)")
    dirname = os.path.abspath(dirname)
    os.makedirs(dirname, exist_ok=True)
    with _lock:
        _state["dir"] = dirname
    return dirname


def disable():
    with _lock:
        _state["dir"] = None


def is_enabled():
    return _state["dir"] is not None


def cache_dir():
    return _state["dir"]


def build_dir(default):
    """Where a library is looked up and built: the cache directory when
    enabled, else ``default`` (the build module's own directory)."""
    d = _state["dir"]
    return default if d is None else d


def record(hit):
    """Count one library lookup: found (``hit``) or built."""
    key = "hits" if hit else "misses"
    with _lock:
        _counters[key] += 1
        _counters["requests"] += 1
    _m_counters[key].inc()
    _m_counters["requests"].inc()


def stats():
    """{'hits', 'misses', 'requests'} since process start (or the last
    ``reset_stats``)."""
    with _lock:
        return dict(_counters)


def reset_stats():
    with _lock:
        for k in _counters:
            _counters[k] = 0


def enable_from_env():
    """Called when ``paddle_tpu_torch.core`` is imported: enable iff the
    environment asks. Returns the cache directory or None."""
    d = os.environ.get(ENV_VAR)
    if d:
        return enable(d)
    return None
