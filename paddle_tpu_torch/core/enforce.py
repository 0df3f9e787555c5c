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
