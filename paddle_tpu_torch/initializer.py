"""Parameter initializers: the port of ``paddle_tpu/initializer.py``, every
public name (``Constant``, ``Uniform``, ``Normal``, ``TruncatedNormal``,
``Xavier``, ``MSRA``, ``Bilinear``, ``NumpyArrayInitializer``,
``force_init_on_cpu`` and ``init_on_cpu``).

An initializer is a callable ``(generator, shape, dtype) -> tensor`` that
draws on the CPU from an explicit ``torch.Generator`` (the startup program's,
seeded from ``program.random_seed``), so a seed gives the same weights on
every device. The draws are not the JAX package's (``jax.random`` and torch
generators differ): parity runs carry the JAX weights across instead
(``Scope.from_numpy``). ``TruncatedNormal`` keeps its draws within two
standard deviations of ``loc``, as ``jax.random.truncated_normal(-2, 2)``
does; ``Bilinear`` and ``NumpyArrayInitializer`` draw nothing and give the
JAX package's values.
"""

import math

import numpy as np
import torch

from paddle_tpu_torch.core.dtypes import convert_dtype

__all__ = ["Initializer", "Constant", "ConstantInitializer", "Uniform",
           "UniformInitializer", "Normal", "NormalInitializer",
           "TruncatedNormal", "TruncatedNormalInitializer", "Xavier",
           "XavierInitializer", "MSRA", "MSRAInitializer", "Bilinear",
           "BilinearInitializer", "NumpyArrayInitializer",
           "force_init_on_cpu", "init_on_cpu"]


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


class TruncatedNormalInitializer(Initializer):
    """``loc + scale * z`` with z a standard normal truncated to [-2, 2]."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, gen, shape, dtype=torch.float32):
        z = torch.nn.init.trunc_normal_(
            torch.empty(tuple(shape)), 0.0, 1.0, -2.0, 2.0,
            generator=_generator(gen, self.seed))
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


class BilinearInitializer(Initializer):
    """The bilinear upsampling filter of a transposed convolution's 4-D
    weight (initializer.py Bilinear), as the JAX package writes it: the
    k x k filter on the diagonal (in, in) pairs when the two channel dims
    are equal, else at out-channel 0."""

    def __call__(self, gen, shape, dtype=torch.float32):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs 4-D weight")
        f = np.zeros(shape, np.float32)
        k = shape[3]
        factor = (k + 1) // 2
        center = factor - 1.0 if k % 2 == 1 else factor - 0.5
        og = np.ogrid[:k, :k]
        filt = (1 - abs(og[0] - center) / factor) * \
               (1 - abs(og[1] - center) / factor)
        f[range(shape[0]), range(shape[1]) if shape[1] == shape[0] else 0] \
            = filt
        return torch.as_tensor(f).to(convert_dtype(dtype))


class NumpyArrayInitializer(Initializer):
    """The given array, cast and reshaped."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, gen, shape, dtype=torch.float32):
        return torch.as_tensor(self.value).to(
            convert_dtype(dtype)).reshape(tuple(shape))


# fluid-style aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


# force_init_on_cpu / init_on_cpu (ref python/paddle/fluid/initializer.py):
# the port's initializers always draw on the CPU (the startup program's
# generator), so the flag is kept for the API and read by nothing here
_force_init_on_cpu_ = False


def force_init_on_cpu():
    return _force_init_on_cpu_


class _InitOnCPU:
    def __enter__(self):
        global _force_init_on_cpu_
        self._prev = _force_init_on_cpu_
        _force_init_on_cpu_ = True

    def __exit__(self, *a):
        global _force_init_on_cpu_
        _force_init_on_cpu_ = self._prev


def init_on_cpu():
    """Context manager: the flag of :func:`force_init_on_cpu` set inside."""
    return _InitOnCPU()
