"""Parameter initializers: the port of ``paddle_tpu/initializer.py``'s
``Constant``, ``Uniform``, ``Normal``, ``Xavier`` and ``MSRA``.

An initializer is a callable ``(generator, shape, dtype) -> tensor`` that
draws on the CPU from an explicit ``torch.Generator`` (the startup program's,
seeded from ``program.random_seed``), so a seed gives the same weights on
every device. The draws are not the JAX package's (``jax.random`` and torch
generators differ): parity runs carry the JAX weights across instead
(``Scope.from_numpy``).
"""

import math

import torch

from paddle_tpu_torch.core.dtypes import convert_dtype

__all__ = ["Initializer", "Constant", "ConstantInitializer", "Uniform",
           "UniformInitializer", "Normal", "NormalInitializer", "Xavier",
           "XavierInitializer", "MSRA", "MSRAInitializer"]


def _fans(shape):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[2:])
    # fluid convention: [in, out] for 2-D, [out, in, ...] for conv
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


def _generator(gen, seed):
    return torch.Generator().manual_seed(seed) if seed else gen


class Initializer:
    def __call__(self, gen, shape, dtype=torch.float32):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, gen, shape, dtype=torch.float32):
        return torch.full(tuple(shape), self.value,
                          dtype=convert_dtype(dtype))


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, gen, shape, dtype=torch.float32):
        u = torch.rand(tuple(shape), generator=_generator(gen, self.seed))
        return (self.low + (self.high - self.low) * u).to(
            convert_dtype(dtype))


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, gen, shape, dtype=torch.float32):
        z = torch.randn(tuple(shape), generator=_generator(gen, self.seed))
        return (self.loc + self.scale * z).to(convert_dtype(dtype))


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, gen, shape, dtype=torch.float32):
        fi, fo = _fans(tuple(shape))
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed)(
                gen, shape, dtype)
        return NormalInitializer(0.0, math.sqrt(2.0 / (fi + fo)),
                                 self.seed)(gen, shape, dtype)


class MSRAInitializer(Initializer):
    """He initialization from the fan-in: uniform in +-sqrt(6/fan_in), or
    normal with std sqrt(2/fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, gen, shape, dtype=torch.float32):
        fi, _ = _fans(tuple(shape))
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return UniformInitializer(-limit, limit, self.seed)(
                gen, shape, dtype)
        return NormalInitializer(0.0, math.sqrt(2.0 / fi), self.seed)(
            gen, shape, dtype)


# fluid-style aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
