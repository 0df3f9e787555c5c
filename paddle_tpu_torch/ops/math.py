"""Elementwise and linear-algebra math ops: the port of
``paddle_tpu/ops/math.py``, every public function.

Parity targets: operators/elementwise/* (broadcast machinery ref:
operators/elementwise/elementwise_op_function.h), matmul_op.cc, mul_op.cc,
scale_op.cc, sum_op.cc, cumsum_op.cc, clip_op.cc, clip_by_norm_op.cc,
cast_op.cc, isfinite_op.cc, increment_op.cc and the logical and compare ops
of operators/controlflow.

The reference's elementwise ops take an ``axis`` attr that aligns a
lower-rank y against x's dims starting at ``axis`` (-1: trailing). Output
dtypes follow the JAX functions: a float op on integers (``exp``,
``elementwise_div``, ``reciprocal``) gives float32, an integer sum stays
integer.
"""

import math

import torch

from paddle_tpu_torch.core.dtypes import convert_dtype

__all__ = [
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_min", "elementwise_max",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
    "matmul", "mul", "bmm", "dot", "scale", "sums", "cumsum",
    "clip", "clip_by_norm", "cast", "increment", "isfinite",
    "abs", "ceil", "floor", "round", "exp", "log", "sqrt", "rsqrt",
    "square", "reciprocal", "sign", "cos", "sin", "atan", "acos",
    "asin", "pow",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "minus",
]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _pair(x, y):
    """Two operands as tensors. A Python scalar becomes a 0-d CPU tensor,
    which torch lets meet a tensor on any device and which, like JAX's weak
    types, does not widen a tensor of its own kind."""
    return _t(x), _t(y)


def _align(x, y, axis=-1):
    """The reference broadcast rule: y's dims line up from x's ``axis``."""
    x, y = _pair(x, y)
    if x.dim() == y.dim() or y.dim() == 0:
        return x, y
    if axis == -1:
        axis = x.dim() - y.dim()
    shape = [1] * x.dim()
    shape[axis: axis + y.dim()] = y.shape
    return x, y.reshape(shape)


def _float(x):
    """An integer or bool tensor as float32 (JAX promotes them so for the
    inexact unary functions)."""
    x = _t(x)
    return x if x.is_floating_point() else x.to(torch.float32)


def _binary(fn, doc):
    def op(x, y, axis=-1, name=None):
        x, y = _align(x, y, axis)
        return fn(x, y)
    op.__doc__ = doc
    return op


elementwise_add = _binary(torch.add, "x + y (elementwise_add_op.cc).")
elementwise_sub = _binary(torch.sub, "x - y (elementwise_sub_op.cc).")
elementwise_mul = _binary(torch.mul, "x * y (elementwise_mul_op.cc).")
elementwise_div = _binary(torch.true_divide,
                          "x / y, true division (elementwise_div_op.cc).")
elementwise_min = _binary(torch.minimum, "min(x, y) (elementwise_min_op.cc).")
elementwise_max = _binary(torch.maximum, "max(x, y) (elementwise_max_op.cc).")
elementwise_pow = _binary(torch.pow, "x ** y (elementwise_pow_op.cc).")
elementwise_mod = _binary(torch.remainder,
                          "x mod y with y's sign (elementwise_mod_op.cc).")
elementwise_floordiv = _binary(torch.floor_divide,
                               "floor(x / y) (elementwise_floordiv_op.cc).")


def minus(x, y):
    return torch.sub(*_pair(x, y))


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    """matmul_op.cc parity: batched matmul with optional transposes; 1-D
    operands get the reference's vector promotion."""
    x, y = _t(x), _t(y)
    squeeze_l = squeeze_r = False
    if x.dim() == 1:
        x, squeeze_l = x[None, :], True
    if y.dim() == 1:
        y, squeeze_r = y[:, None], True
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * alpha
    if squeeze_l:
        out = out[..., 0, :]
    if squeeze_r:
        out = out[..., 0]
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """mul_op.cc parity: flatten x to 2-D at ``x_num_col_dims``, y at
    ``y_num_col_dims``, then a 2-D matmul."""
    xs = x.reshape(math.prod(x.shape[:x_num_col_dims]), -1)
    ys = y.reshape(math.prod(y.shape[:y_num_col_dims]), -1)
    out = torch.matmul(xs, ys)
    return out.reshape(*x.shape[:x_num_col_dims], ys.shape[-1])


def bmm(x, y):
    return torch.matmul(x, y)


def dot(x, y):
    return torch.sum(x * y, dim=-1, keepdim=True)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    """scale_op.cc parity: ``x * scale + bias``, or ``(x + bias) * scale``
    with ``bias_after_scale=False``."""
    x = _t(x)
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def sums(inputs, name=None):
    """sum_op.cc parity: a list of tensors added left to right."""
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out


def cumsum(x, axis=None, exclusive=False, reverse=False, name=None):
    """cumsum_op.cc parity; an integer input keeps its dtype."""
    x = _t(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if exclusive:
        out = out - x
    if reverse:
        out = torch.flip(out, (axis,))
    return out


def clip(x, min, max, name=None):
    return torch.clamp(_t(x), min, max)


def clip_by_norm(x, max_norm, name=None):
    """clip_by_norm_op.cc parity: x * max_norm / max(norm, max_norm)."""
    x = _t(x)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return x * (max_norm / torch.clamp(norm, min=max_norm))


def cast(x, dtype):
    return _t(x).to(convert_dtype(dtype))


def increment(x, value=1.0, name=None):
    return _t(x) + value


def isfinite(x, name=None):
    """isfinite_op.cc parity: one bool, every element finite."""
    return torch.all(torch.isfinite(_t(x)))


# -- simple unary (activation_op.cc registers several of these too) --------
def abs(x, name=None): return torch.abs(_t(x))                    # noqa: E704
def _rounding(fn):
    """An integer input is already whole: it comes back as it is, in its
    dtype, as from ``jnp.ceil``."""
    def op(x, name=None):
        x = _t(x)
        return fn(x) if x.is_floating_point() else x.clone()
    return op


ceil = _rounding(torch.ceil)
floor = _rounding(torch.floor)
round = _rounding(torch.round)
def exp(x, name=None): return torch.exp(_float(x))                # noqa: E704
def log(x, name=None): return torch.log(_float(x))                # noqa: E704
def sqrt(x, name=None): return torch.sqrt(_float(x))              # noqa: E704
def rsqrt(x, name=None): return torch.rsqrt(_float(x))            # noqa: E704
def square(x, name=None): return torch.square(_t(x))              # noqa: E704
def reciprocal(x, name=None): return 1.0 / _float(x)              # noqa: E704
def sign(x, name=None): return torch.sign(_t(x))                  # noqa: E704
def cos(x, name=None): return torch.cos(_float(x))                # noqa: E704
def sin(x, name=None): return torch.sin(_float(x))                # noqa: E704
def atan(x, name=None): return torch.atan(_float(x))              # noqa: E704
def acos(x, name=None): return torch.acos(_float(x))              # noqa: E704
def asin(x, name=None): return torch.asin(_float(x))              # noqa: E704


def pow(x, factor=1.0, name=None):
    return torch.pow(_t(x), factor)


# -- logical / compare (operators/controlflow/{logical,compare}_op.cc) -----
def logical_and(x, y, name=None): return torch.logical_and(*_pair(x, y))  # noqa: E704
def logical_or(x, y, name=None): return torch.logical_or(*_pair(x, y))  # noqa: E704
def logical_xor(x, y, name=None): return torch.logical_xor(*_pair(x, y))  # noqa: E704
def logical_not(x, name=None): return torch.logical_not(_t(x))    # noqa: E704


def _compare(fn):
    def op(x, y, name=None):
        return fn(*_pair(x, y))
    return op


equal = _compare(torch.eq)
not_equal = _compare(torch.ne)
less_than = _compare(torch.lt)
less_equal = _compare(torch.le)
greater_than = _compare(torch.gt)
greater_equal = _compare(torch.ge)
