"""Activation ops: the port of ``paddle_tpu/ops/activation.py``, every
public function.

Parity target: operators/activation_op.cc (sigmoid, logsigmoid, relu,
gelu, tanh, tanh_shrink, softplus, softsign, brelu, leaky_relu, soft_relu,
elu, relu6, stanh, hard_sigmoid, swish, thresholded_relu, hard_shrink...)
plus softmax_op.cc, maxout_op.cc, prelu_op.cc, selu_op.cc, each with the
JAX function's arithmetic (``softplus`` is ``logaddexp(x, 0)``, as
``jax.nn.softplus``, with no linear threshold).
"""

import torch
import torch.nn.functional as F

__all__ = [
    "relu", "relu6", "leaky_relu", "prelu", "elu", "selu", "gelu",
    "sigmoid", "logsigmoid", "hard_sigmoid", "tanh", "tanh_shrink",
    "softplus", "softsign", "softshrink", "hard_shrink", "brelu",
    "soft_relu", "stanh", "swish", "hard_swish", "thresholded_relu",
    "maxout", "softmax", "log_softmax", "mish",
]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def relu(x, name=None):
    return torch.relu(_t(x))


def relu6(x, threshold=6.0, name=None):
    return torch.clamp(_t(x), 0, threshold)


def leaky_relu(x, alpha=0.02, name=None):
    x = _t(x)
    return torch.where(x > 0, x, alpha * x)


def prelu(x, weight, mode="all", name=None):
    """prelu_op.cc parity; mode all|channel|element."""
    x, w = _t(x), _t(weight)
    if mode == "channel" and w.dim() == 1:
        w = w.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x > 0, x, w * x)


def elu(x, alpha=1.0, name=None):
    x = _t(x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    x = _t(x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def gelu(x, approximate=False, name=None):
    """Exact erf gelu by default, as ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(_t(x), approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    return torch.sigmoid(_t(x))


def logsigmoid(x, name=None):
    return F.logsigmoid(_t(x))


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return torch.clamp(slope * _t(x) + offset, 0.0, 1.0)


def tanh(x, name=None):
    return torch.tanh(_t(x))


def tanh_shrink(x, name=None):
    x = _t(x)
    return x - torch.tanh(x)


def softplus(x, name=None):
    x = _t(x)
    return torch.logaddexp(x, _zero(x))


def softsign(x, name=None):
    x = _t(x)
    return x / (1 + torch.abs(x))


def softshrink(x, alpha=0.5, name=None):
    x = _t(x)
    return torch.where(x > alpha, x - alpha,
                       torch.where(x < -alpha, x + alpha, _zero(x)))


def hard_shrink(x, threshold=0.5, name=None):
    x = _t(x)
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return torch.clamp(_t(x), t_min, t_max)


def soft_relu(x, threshold=40.0, name=None):
    return torch.log1p(torch.exp(torch.clamp(_t(x), -threshold, threshold)))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * _t(x))


def swish(x, beta=1.0, name=None):
    x = _t(x)
    return x * torch.sigmoid(beta * x)


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    x = _t(x)
    return x * torch.clamp(x + offset, 0, threshold) / scale


def thresholded_relu(x, threshold=1.0, name=None):
    x = _t(x)
    return torch.where(x > threshold, x, _zero(x))


def mish(x, name=None):
    x = _t(x)
    return x * torch.tanh(softplus(x))


def maxout(x, groups, axis=1, name=None):
    """maxout_op.cc parity: the channel axis split into groups, the max
    over each group."""
    x = _t(x)
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return torch.amax(x.reshape(shape), dim=axis + 1)


def softmax(x, axis=-1, name=None):
    return torch.softmax(_t(x), dim=axis)


def log_softmax(x, axis=-1, name=None):
    return torch.log_softmax(_t(x), dim=axis)
