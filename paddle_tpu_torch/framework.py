"""Framework helpers: the port of ``paddle_tpu/framework.py``'s
``unique_name`` and ``ParamAttr``.

``unique_name`` advances its counters exactly as the JAX package's does
(``fc_w``, ``fc_w_1``, ...), so one script names its parameters alike in both
packages and weights carry across by name.
"""

import contextlib

__all__ = ["unique_name", "ParamAttr"]


class _UniqueNameGenerator:
    """python/paddle/fluid/unique_name.py parity."""

    def __init__(self):
        self.ids = {}

    def __call__(self, prefix):
        n = self.ids.get(prefix, 0)
        self.ids[prefix] = n + 1
        return f"{prefix}_{n}" if n else prefix


class _UniqueNameModule:
    def __init__(self):
        self._gen = _UniqueNameGenerator()

    def generate(self, prefix):
        return self._gen(prefix)

    @contextlib.contextmanager
    def guard(self):
        old = self._gen
        self._gen = _UniqueNameGenerator()
        try:
            yield
        finally:
            self._gen = old


unique_name = _UniqueNameModule()


class ParamAttr:
    """python/paddle/fluid/param_attr.py parity."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return None
        # an initializer instance
        return ParamAttr(initializer=arg)
