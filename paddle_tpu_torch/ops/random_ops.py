"""Random-generation ops: the port of ``paddle_tpu/ops/random_ops.py``.

Parity targets: gaussian_random_op.cc, uniform_random_op.cc,
truncated_gaussian_random_op.cc, random_crop_op.cc, sampling_id_op.cc,
the ``*_batch_size_like`` variants, randint and shuffle_batch.

Each op takes ``rng=`` (a ``torch.Generator``) and ``device=``. The rng
beats the seed, as the JAX ``_key(seed, rng)`` returns the key it is given:
in a Program the Executor hands each op its generator and the op's ``seed``
attr is ignored. Without an rng, the seed rules of ``core/random.py``
apply. The ops that make a tensor from nothing go where ``device`` says:
None is the card, except while a Program is being built (a CPU constant,
as ``ops/tensor_ops.py``'s creation ops); the others draw on their input's
device. The draws are torch's: shapes, dtypes, ranges, distributions and
determinism carry over from the JAX package, values do not.
"""

import math

import torch

from paddle_tpu_torch.core import random as ptrandom
from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.ops.tensor_ops import _device

__all__ = [
    "gaussian_random", "uniform_random", "truncated_gaussian_random",
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "randint", "sampling_id", "random_crop", "shuffle_batch",
]


def _place(rng, device):
    """The device of a tensor made from nothing: the rng's, else
    ``device`` as the creation ops resolve it."""
    return rng.device if rng is not None else _device(device)


def _key(seed, rng, device):
    """The generator of one call: ``rng`` when given, else the seed's (none
    on ``meta`` tensors, which only shape inference draws on)."""
    if rng is not None:
        return rng
    if device.type == "meta":
        return None
    return ptrandom.generator_for(seed, device)


def _float_draw(fn, shape, dtype, device, gen):
    """``fn`` drawn in fp32 at least (``erfinv`` and the uniform's affine
    map keep their fp32 accuracy), then cast to ``dtype``."""
    work = torch.float64 if dtype == torch.float64 else torch.float32
    return fn(tuple(shape), work, device, gen).to(dtype)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    rng=None, name=None, device=None):
    dt, dev = convert_dtype(dtype), _place(rng, device)
    z = torch.randn(tuple(shape), generator=_key(seed, rng, dev), dtype=dt,
                    device=dev)
    return mean + std * z


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   rng=None, name=None, device=None):
    dt, dev = convert_dtype(dtype), _place(rng, device)

    def draw(shape, work, device, gen):
        u = torch.rand(shape, generator=gen, dtype=work, device=device)
        return min + (max - min) * u
    return _float_draw(draw, shape, dt, dev, _key(seed, rng, dev))


def truncated_gaussian_random(shape, mean=0.0, std=1.0, seed=0,
                              dtype="float32", rng=None, name=None,
                              device=None):
    """A standard normal truncated to [-2, 2] by the inverse CDF (the
    ``jax.random.truncated_normal`` method), then ``mean + std * z``."""
    dt, dev = convert_dtype(dtype), _place(rng, device)
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))

    def draw(shape, work, device, gen):
        u = torch.rand(shape, generator=gen, dtype=work, device=device)
        z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
        return torch.clamp(z, -2.0, 2.0)
    return mean + std * _float_draw(draw, shape, dt, dev,
                                    _key(seed, rng, dev))


def _like(input, shape, input_dim_idx, output_dim_idx):
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return shape


def uniform_random_batch_size_like(input, shape, input_dim_idx=0,
                                   output_dim_idx=0, min=-1.0, max=1.0,
                                   seed=0, dtype="float32", rng=None,
                                   name=None, device=None):
    """Drawn on ``input``'s device unless ``rng`` or ``device`` says
    otherwise."""
    return uniform_random(
        _like(input, shape, input_dim_idx, output_dim_idx), dtype, min, max,
        seed, rng, device=device if device is not None else input.device)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32", rng=None,
                                    name=None, device=None):
    return gaussian_random(
        _like(input, shape, input_dim_idx, output_dim_idx), mean, std, seed,
        dtype, rng, device=device if device is not None else input.device)


def randint(low, high=None, shape=(1,), dtype="int64", seed=0, rng=None,
            device=None):
    """Uniform integers in [low, high), or [0, low) when ``high`` is None.
    "int64" gives int64 (the JAX package, with x64 off, gives int32), as
    the port's other integer results the JAX package asks as int64."""
    if high is None:
        low, high = 0, low
    dev = _place(rng, device)
    return torch.randint(int(low), int(high), tuple(shape),
                         generator=_key(seed, rng, dev),
                         dtype=convert_dtype(dtype), device=dev)


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64", rng=None,
                name=None):
    """sampling_id_op.cc parity: one category per row of the probability
    matrix ``x``, drawn from ``log(max(x, 1e-20))`` by the Gumbel maximum
    (the ``jax.random.categorical`` method). ``min`` and ``max`` are unused,
    as in the JAX op."""
    logits = torch.log(torch.clamp(x, min=1e-20))
    u = torch.rand(logits.shape, generator=_key(seed, rng, x.device),
                   dtype=torch.float32, device=x.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(
        convert_dtype(dtype))


def random_crop(x, shape, seed=0, rng=None, name=None):
    """random_crop_op.cc parity: one window of ``shape`` over the trailing
    dims, for the whole batch; each start uniform in [0, dim - size]. The
    starts stay on the device (an index per dim, no host read)."""
    gen = _key(seed, rng, x.device)
    nd, tail = x.dim(), len(shape)
    out = x
    for i, s in enumerate(shape):
        axis = nd - tail + i
        hi = x.shape[axis] - s + 1
        start = torch.randint(0, hi, (1,), generator=gen, device=x.device)
        idx = start + torch.arange(s, device=x.device)
        out = torch.index_select(out, axis, idx)
    return out


def shuffle_batch(x, seed=0, rng=None, name=None):
    """The rows of ``x`` in a random permutation."""
    perm = torch.randperm(x.shape[0], generator=_key(seed, rng, x.device),
                          device=x.device)
    return x[perm]
