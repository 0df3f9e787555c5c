"""Core helpers of the port (own copies; nothing is imported from paddle_tpu)."""

# fluid.core.EOFException is the reader protocol's loop terminator; users
# catch it as core.EOFException
from paddle_tpu_torch.core.enforce import EnforceNotMet, EOFException  # noqa: F401,E402

# the persistent build cache: PADDLE_TPU_CACHE_DIR in the environment (a
# launcher sets it for its workers) turns it on at import, before any
# kernel or native library is built. Never fatal: a bad directory
# (read-only volume, typo) degrades to a cold start with a warning.
from paddle_tpu_torch.core import compile_cache  # noqa: E402

try:
    compile_cache.enable_from_env()
except Exception as _e:  # pragma: no cover - env-dependent
    import warnings as _warnings
    _warnings.warn(f"PADDLE_TPU_CACHE_DIR ignored "
                   f"(compilation cache disabled): {_e}")
