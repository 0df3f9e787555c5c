"""Probability distributions: the port of ``paddle_tpu/distributions.py``
(the reference's layers/distributions.py: Distribution, Uniform :113,
Normal :246; with Categorical and MultivariateNormalDiag).

``log_prob``, ``entropy`` and ``kl_divergence`` are the JAX package's
formulas in fp32. ``sample(shape, seed, rng)`` draws with ``rng`` (a
``torch.Generator`` on the distribution's device) or, without one, with the
port's seed rules (``core/random.py``: a seed that is not 0 gives the same
draws on every call, seed 0 the global counter's next generator). The
draws are torch's, not threefry's: shape, dtype, distribution and
determinism carry over from the JAX package, never the values.

The parameters are fp32 tensors: tensors keep their device; numbers go to
``device``, or to the device of a tensor argument, or to the card.
"""

import math

import torch

from paddle_tpu_torch.core import random as _random

__all__ = ["Distribution", "Uniform", "Normal", "Categorical",
           "MultivariateNormalDiag"]


def _params(device, *xs):
    """``xs`` as fp32 tensors on one device (see the module docstring)."""
    if device is None:
        dev = next((x.device for x in xs if isinstance(x, torch.Tensor)),
                   None)
        if dev is None:
            from paddle_tpu_torch import default_device
            dev = default_device()
    else:
        dev = torch.device(device)
    return [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in xs]


def _gen(seed, rng, device):
    return rng if rng is not None else _random.generator_for(seed, device)


def _shape(shape, *ts):
    return tuple(shape) + tuple(torch.broadcast_shapes(*(t.shape
                                                          for t in ts)))


class Distribution:
    def sample(self, shape, seed=0, rng=None):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError

    def _value(self, value, ref):
        return torch.as_tensor(value, dtype=torch.float32, device=ref.device)


class Uniform(Distribution):
    """U(low, high), broadcasting as the reference (distributions.py:113)."""

    def __init__(self, low, high, device=None):
        self.low, self.high = _params(device, low, high)

    def sample(self, shape, seed=0, rng=None):
        dev = self.low.device
        u = torch.rand(_shape(shape, self.low, self.high),
                       generator=_gen(seed, rng, dev), device=dev)
        return self.low + u * (self.high - self.low)

    def log_prob(self, value):
        value = self._value(value, self.low)
        lb = (value >= self.low).to(torch.float32)
        ub = (value < self.high).to(torch.float32)
        return torch.log(lb * ub) - torch.log(self.high - self.low)

    def entropy(self):
        return torch.log(self.high - self.low)


class Normal(Distribution):
    """N(loc, scale) (distributions.py:246)."""

    def __init__(self, loc, scale, device=None):
        self.loc, self.scale = _params(device, loc, scale)

    def sample(self, shape, seed=0, rng=None):
        dev = self.loc.device
        z = torch.randn(_shape(shape, self.loc, self.scale),
                        generator=_gen(seed, rng, dev), device=dev)
        return self.loc + self.scale * z

    def log_prob(self, value):
        value = self._value(value, self.loc)
        var = self.scale * self.scale
        return (-((value - self.loc) ** 2) / (2.0 * var)
                - torch.log(self.scale) - 0.5 * math.log(2.0 * math.pi))

    def entropy(self):
        return 0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(self.scale)

    def kl_divergence(self, other):
        """The reference's formula (distributions.py:383)."""
        assert isinstance(other, Normal)
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


class Categorical(Distribution):
    """Categorical over the last axis of ``logits``; ``sample`` takes the
    Gumbel-max draw (``jax.random.categorical``'s method)."""

    def __init__(self, logits, device=None):
        (self.logits,) = _params(device, logits)
        self._logp = torch.log_softmax(self.logits, dim=-1)

    def sample(self, shape, seed=0, rng=None):
        dev = self.logits.device
        out = tuple(shape) + tuple(self.logits.shape[:-1])
        u = torch.rand(out + (self.logits.shape[-1],),
                       generator=_gen(seed, rng, dev), device=dev)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        return torch.argmax(self.logits - torch.log(-torch.log(u)), dim=-1)

    def log_prob(self, value):
        value = torch.as_tensor(value, device=self.logits.device).long()
        logp = self._logp.expand(value.shape + self._logp.shape[-1:])
        return torch.gather(logp, -1, value[..., None])[..., 0]

    def entropy(self):
        p = torch.exp(self._logp)
        return -torch.sum(p * self._logp, dim=-1)

    def kl_divergence(self, other):
        assert isinstance(other, Categorical)
        p = torch.exp(self._logp)
        return torch.sum(p * (self._logp - other._logp), dim=-1)


class MultivariateNormalDiag(Distribution):
    """N(loc, diag(scale^2)): the diagonal-covariance multivariate
    normal."""

    def __init__(self, loc, scale, device=None):
        self.loc, self.scale = _params(device, loc, scale)

    @property
    def _dim(self):
        return self.loc.shape[-1]

    def sample(self, shape, seed=0, rng=None):
        dev = self.loc.device
        z = torch.randn(_shape(shape, self.loc, self.scale),
                        generator=_gen(seed, rng, dev), device=dev)
        return self.loc + self.scale * z

    def log_prob(self, value):
        z = (self._value(value, self.loc) - self.loc) / self.scale
        return (-0.5 * torch.sum(z * z, dim=-1)
                - torch.sum(torch.log(self.scale), dim=-1)
                - 0.5 * self._dim * math.log(2.0 * math.pi))

    def entropy(self):
        return (0.5 * self._dim * (1.0 + math.log(2.0 * math.pi))
                + torch.sum(torch.log(self.scale), dim=-1))

    def kl_divergence(self, other):
        assert isinstance(other, MultivariateNormalDiag)
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return 0.5 * torch.sum(var_ratio + t1 - 1.0 - torch.log(var_ratio),
                               dim=-1)
