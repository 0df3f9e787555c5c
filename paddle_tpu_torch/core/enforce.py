"""Error-checking helpers: the port's own copy of paddle_tpu.core.enforce.

Analog of PADDLE_ENFORCE* / PADDLE_THROW (ref:
paddle/fluid/platform/enforce.h:67,239-354). Python exceptions already carry
tracebacks, so this layer only adds the uniform exception type and the
predicates used throughout the port.
"""


class EnforceNotMet(RuntimeError):
    """Raised when a framework invariant is violated."""


class EOFException(Exception):
    """End of a started reader's data (ref: fluid.core.EOFException, the
    non-iterable reader protocol's loop terminator)."""


def enforce(cond, msg="", *fmt_args):
    if not cond:
        raise EnforceNotMet(msg % fmt_args if fmt_args else str(msg))


def enforce_eq(a, b, msg=""):
    if a != b:
        raise EnforceNotMet(f"Expected {a!r} == {b!r}. {msg}")


def enforce_ne(a, b, msg=""):
    if a == b:
        raise EnforceNotMet(f"Expected {a!r} != {b!r}. {msg}")


def enforce_gt(a, b, msg=""):
    if not a > b:
        raise EnforceNotMet(f"Expected {a!r} > {b!r}. {msg}")


def enforce_ge(a, b, msg=""):
    if not a >= b:
        raise EnforceNotMet(f"Expected {a!r} >= {b!r}. {msg}")


def enforce_lt(a, b, msg=""):
    if not a < b:
        raise EnforceNotMet(f"Expected {a!r} < {b!r}. {msg}")


def enforce_le(a, b, msg=""):
    if not a <= b:
        raise EnforceNotMet(f"Expected {a!r} <= {b!r}. {msg}")


def not_none(x, name="value"):
    if x is None:
        raise EnforceNotMet(f"{name} must not be None")
    return x


import threading as _threading

_warned_keys = set()
_warn_lock = _threading.Lock()


def warn_once(key, message, category=UserWarning, stacklevel=3):
    """Emit ``message`` at most once per process per ``key`` (our own set,
    not the warnings registry, so it survives
    ``warnings.simplefilter("always")``). Returns True iff it fired."""
    import warnings
    with _warn_lock:
        if key in _warned_keys:
            return False
        _warned_keys.add(key)
    warnings.warn(message, category, stacklevel=stacklevel)
    return True
