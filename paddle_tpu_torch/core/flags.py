"""Framework flags: the port's own copy of ``paddle_tpu/core/flags.py``.

A typed registry seeded from ``FLAGS_<name>`` environment variables and
changed at run time by :func:`set_flags` (the ``fluid.set_flags`` surface).
The port defines the flags its static path reads: ``apply_ir_passes`` and
``executor_fast_path`` (in ``static/executor.py``). ``check_nan_inf`` is not
ported: turning it on raises :class:`EnforceNotMet`.
"""

import os
import threading

from paddle_tpu_torch.core.enforce import EnforceNotMet

__all__ = ["define_flag", "get_flag", "set_flags", "flags"]

_lock = threading.Lock()
_REGISTRY = {}

#: flags of the JAX package whose machinery the port does not have yet
_NOT_PORTED = {
    "check_nan_inf": "the in-graph numerics sentinels (monitor/numerics.py) "
                     "are ROADMAP queue 1 item 10",
}


class _Flag:
    __slots__ = ("name", "value", "type", "help")

    def __init__(self, name, default, help=""):
        self.name = name
        self.type = type(default)
        self.help = help
        env = os.environ.get("FLAGS_" + name)
        self.value = self._parse(env) if env is not None else default

    def _parse(self, s):
        if self.type is bool:
            return s.lower() in ("1", "true", "yes", "on")
        return self.type(s)


def define_flag(name, default, help=""):
    with _lock:
        if name not in _REGISTRY:
            _REGISTRY[name] = _Flag(name, default, help)
    return _REGISTRY[name]


def get_flag(name):
    return _REGISTRY[name].value


def set_flags(flags_dict):
    """``{'FLAGS_x': v}`` or ``{'x': v}``; an unknown name defines a flag."""
    for k, v in flags_dict.items():
        name = k[len("FLAGS_"):] if k.startswith("FLAGS_") else k
        if name in _NOT_PORTED and v:
            raise EnforceNotMet(f"FLAGS_{name} is not ported yet: "
                                f"{_NOT_PORTED[name]}")
        if name not in _REGISTRY:
            define_flag(name, v)
        else:
            _REGISTRY[name].value = _REGISTRY[name].type(v)


class _FlagsView:
    """Attribute access to the flags: ``flags.apply_ir_passes``."""

    def __getattr__(self, name):
        try:
            return get_flag(name)
        except KeyError:
            raise AttributeError(name) from None


flags = _FlagsView()
