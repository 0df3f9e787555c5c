"""Elementwise and linear-algebra ops of the static path: the port of
``paddle_tpu/ops/math.py``'s ``elementwise_add``, ``matmul`` and ``mul``.

The reference's elementwise ops take an ``axis`` attr that aligns a
lower-rank y against x's dims starting at ``axis`` (-1: trailing).
"""

import math

import torch

__all__ = ["elementwise_add", "matmul", "mul"]


def _align(x, y, axis=-1):
    """The reference broadcast rule: y's dims line up from x's ``axis``."""
    if x.dim() == y.dim() or y.dim() == 0:
        return x, y
    if axis == -1:
        axis = x.dim() - y.dim()
    shape = [1] * x.dim()
    shape[axis: axis + y.dim()] = y.shape
    return x, y.reshape(shape)


def elementwise_add(x, y, axis=-1, name=None):
    x, y = _align(x, y, axis)
    return x + y


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    """matmul_op.cc parity: batched matmul with optional transposes; 1-D
    operands get the reference's vector promotion."""
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
