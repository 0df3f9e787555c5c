"""Framework flags: the port's own copy of ``paddle_tpu/core/flags.py``.

A typed registry seeded from ``FLAGS_<name>`` environment variables and
changed at run time by :func:`set_flags` (the ``fluid.set_flags`` surface).
The port defines the flags its static path reads: ``check_nan_inf`` (here:
the numerics sentinels and localizer of ``monitor/numerics.py``, wired
through the static Executor), and ``apply_ir_passes``,
``executor_fast_path``, ``monitor_cost`` and ``pass_cost_evidence`` (in
``static/executor.py``).
"""

import os
import threading

__all__ = ["define_flag", "get_flag", "set_flags", "flags"]

_lock = threading.Lock()
_REGISTRY = {}

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


define_flag("check_nan_inf", False,
            "Check every float tensor a step writes for nan/inf on the "
            "device (one flag per segment, read once a step); a trip "
            "replays the step op by op from its pre-step snapshot and "
            "raises NonFiniteError naming the first non-finite tensor "
            "and op (monitor/numerics.py)")
