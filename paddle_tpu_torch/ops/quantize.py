"""The quantization op family: the port of ``paddle_tpu/ops/quantize.py``
(operators/fake_quantize_op.cc, fake_dequantize_op.cc, quantize_op.cc,
dequantize_op.cc), with the JAX names, signatures, defaults and output
dtypes.

- The fake-quant ops round through a straight-through estimator
  (:class:`_SteRound`: ``torch.round``, half to even as ``jnp.round``, with
  an identity gradient), so quantization-aware training differentiates
  through them. The abs-max scale is not detached: its gradient reaches the
  largest ``|x|`` (split evenly between ties, as JAX's reduce-max splits
  it), and ``jnp.maximum``/``jnp.abs``/``jnp.clip``'s kinks are those of
  ``ops/math.py`` (``_maximum``, ``_abs``, ``_clip``).
- The arithmetic keeps the JAX order, ``x / s * bins`` then ``* s / bins``,
  and its rounding is that of the JAX package's programs, which run under
  ``jax.jit``: a division by a tensor (the abs-max scale) is a true
  division, and a division by a number known when the program is traced
  (``bins``, a Python scale) is a multiplication by its fp32 reciprocal,
  as XLA compiles ``x / c`` (its algebraic simplifier). Eager JAX divides
  by the number instead, which differs by an ulp in a few percent of the
  elements.
- The stateful forms are functional, state in and state out; a Python
  float state stays a Python float, as in JAX.
- ``quantized_mul`` and ``quantized_conv2d`` (the frozen program's integer
  ops) quantize the activation on the fly with :func:`quantize_linear`,
  then accumulate the integer products exactly: an fp64 product or
  convolution of the integer values (cuBLAS/cuDNN on the card), exact
  while ``|acc| < 2**53``, which int8 products reach only past K = 2**39.
  The result is rounded to fp32 as the int32 accumulator would be and
  scaled by ``f32(x_scale) * f32(w_scale) / (x_bins * w_bins)`` in fp32.

A float64 input is taken as float32, as the JAX package (x64 off) takes it.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.math import _abs, _clip, _maximum
from paddle_tpu_torch.ops.nn import _conv_pads, _pair

__all__ = [
    "fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
    "fake_channel_wise_quantize_abs_max",
    "fake_channel_wise_quantize_dequantize_abs_max",
    "fake_quantize_range_abs_max",
    "fake_quantize_moving_average_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "moving_average_abs_max_scale",
    "fake_dequantize_max_abs", "fake_channel_wise_dequantize_max_abs",
    "quantize_linear", "dequantize_linear",
    "quantized_mul", "quantized_conv2d",
]


def _bin_cnt(bit_length):
    return (1 << (bit_length - 1)) - 1


class _SteRound(torch.autograd.Function):
    """round(x), half to even, with the straight-through gradient."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _ste_round(x):
    return _SteRound.apply(x)


def _t(x):
    """A tensor; float64 becomes float32 (``jnp.asarray`` with x64 off)."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return x.float() if x.dtype == torch.float64 else x


def _div(a, b):
    """a / b as ``jax.jit`` computes it: by a tensor, a true division; by a
    number, a product with its fp32 reciprocal (1.0f / b)."""
    if isinstance(b, torch.Tensor):
        return a / b
    return a * float(np.float32(1.0) / np.float32(b))


def _floor(v):
    """``jnp.maximum(v, 1e-12)``: a tensor's kinks, or a Python max."""
    if isinstance(v, torch.Tensor):
        return _maximum(v, 1e-12)
    return max(v, 1e-12)


def _absmax(x, axes=None):
    """max |x| over all elements, or over ``axes`` (none: |x| itself)."""
    a = _abs(x)
    if axes is None:
        return a.amax()
    return a.amax(dim=axes) if axes else a


def _channel_shape(x, quant_axis):
    axes = tuple(i for i in range(x.dim()) if i != quant_axis)
    shape = [1] * x.dim()
    shape[quant_axis] = -1
    return axes, shape


def fake_quantize_abs_max(x, bit_length=8):
    """scale = max|x|; out = round(x / scale * bin_cnt), a float tensor of
    integers. Returns (out, scale)."""
    x = _t(x)
    bins = _bin_cnt(bit_length)
    scale = _absmax(x)
    s = _floor(scale)
    return _ste_round(x / s * bins), scale


def fake_quantize_dequantize_abs_max(x, bit_length=8):
    """The QAT op: the quantize-dequantize round trip with the STE.
    Returns (out, scale)."""
    x = _t(x)
    bins = _bin_cnt(bit_length)
    scale = _absmax(x)
    s = _floor(scale)
    return _div(_ste_round(x / s * bins) * s, bins), scale


def fake_channel_wise_quantize_abs_max(x, bit_length=8, quant_axis=0):
    """Per-channel abs-max quantization. Returns (out, scales[channels])."""
    x = _t(x)
    bins = _bin_cnt(bit_length)
    axes, shape = _channel_shape(x, quant_axis)
    scale = _absmax(x, axes)
    s = _floor(scale).reshape(shape)
    return _ste_round(x / s * bins), scale


def fake_channel_wise_quantize_dequantize_abs_max(x, bit_length=8,
                                                  quant_axis=0):
    """Per-channel quant-dequant round trip with the STE. Returns
    (out, scales)."""
    x = _t(x)
    bins = _bin_cnt(bit_length)
    axes, shape = _channel_shape(x, quant_axis)
    scale = _absmax(x, axes)
    s = _floor(scale).reshape(shape)
    return _div(_ste_round(x / s * bins) * s, bins), scale


def _as_like(v, x):
    """A state value as a tensor of x's dtype on x's device."""
    if isinstance(v, torch.Tensor):
        return v.to(x.device)
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def fake_quantize_range_abs_max(x, in_scale, iteration, window_size=10000,
                                bit_length=8, is_test=False):
    """The windowed running max scale: reset to the batch's max |x| at a
    window boundary (``iteration % window_size == 0``), else the max of
    ``in_scale`` and it. Returns (out, out_scale)."""
    x = _t(x)
    bins = _bin_cnt(bit_length)
    cur = _absmax(x)
    if is_test:
        scale = in_scale
    else:
        in_scale = _as_like(in_scale, x)
        at_boundary = (iteration % window_size) == 0
        if not isinstance(at_boundary, torch.Tensor):
            at_boundary = torch.tensor(bool(at_boundary), device=x.device)
        scale = torch.where(at_boundary.to(x.device), cur,
                            torch.maximum(in_scale, cur))
    s = _floor(scale)
    return _ste_round(_div(_clip(x, -s, s), s) * bins), scale


def moving_average_abs_max_scale(x, accum, state, moving_rate=0.9):
    """The EMA abs-max scale tracker. Returns (scale, accum', state')."""
    cur = _absmax(_t(x))
    accum = accum * moving_rate + cur * (1.0 - moving_rate)
    state = state * moving_rate + (1.0 - moving_rate)
    return _div(accum, _floor(state)), accum, state


def _ema_scale(x, accum, state, moving_rate, is_test):
    if is_test:
        return _div(_as_like(accum, x), _floor(state)), accum, state
    return moving_average_abs_max_scale(x, accum, state, moving_rate)


def fake_quantize_moving_average_abs_max(x, accum, state, moving_rate=0.9,
                                         bit_length=8, is_test=False):
    """EMA-scaled quantization. Returns (out, scale, accum', state')."""
    x = _t(x)
    bins = _bin_cnt(bit_length)
    scale, accum, state = _ema_scale(x, accum, state, moving_rate, is_test)
    s = _floor(scale)
    return (_ste_round(_div(_clip(x, -s, s), s) * bins), scale, accum,
            state)


def fake_quantize_dequantize_moving_average_abs_max(
        x, accum, state, moving_rate=0.9, bit_length=8, is_test=False):
    """The QAT activation op with an EMA scale: quant-dequant round trip.
    Returns (out, scale, accum', state')."""
    x = _t(x)
    bins = _bin_cnt(bit_length)
    scale, accum, state = _ema_scale(x, accum, state, moving_rate, is_test)
    s = _floor(scale)
    out = _div(_ste_round(_div(_clip(x, -s, s), s) * bins) * s, bins)
    return out, scale, accum, state


def fake_dequantize_max_abs(x, scale, max_range):
    """out = x * scale / max_range (fake_dequantize_op.cc)."""
    return _div(_t(x).float() * scale, max_range)


def fake_channel_wise_dequantize_max_abs(x, scales, quant_bits=(8,),
                                         quant_axis=0):
    """Per-channel dequantize; ``scales`` as the reference's two-scale form
    (weight scales [, activation scale])."""
    x = _t(x).float()
    wscale = _as_like(scales[0], x).float()
    _, shape = _channel_shape(x, quant_axis)
    out = _div(x * wscale.reshape(shape), _bin_cnt(quant_bits[0]))
    if len(scales) > 1 and scales[1] is not None:
        out = _div(out * scales[1], _bin_cnt(quant_bits[1]))
    return out


def _storage_dtype(bit_length):
    if bit_length <= 8:
        return torch.int8
    if bit_length <= 16:
        return torch.int16
    return torch.int32


def quantize_linear(x, scale, bit_length=8):
    """The real integer cast (inference): round and clip to
    [-bins - 1, bins] at the given scale (operators/quantize_op.cc); the
    storage width follows bit_length (int8, int16, int32)."""
    x = _t(x)
    bins = _bin_cnt(bit_length)
    q = torch.round(_div(x, _floor(scale)) * bins)
    return q.clamp(-bins - 1, bins).to(_storage_dtype(bit_length))


def dequantize_linear(q, scale, bit_length=8):
    """int to float at the given scale (operators/dequantize_op.cc)."""
    return _div(_t(q).float() * scale, _bin_cnt(bit_length))


def _scale_factor(x_scale, w_scale, x_bins, w_bins, device):
    """f32(x_scale) * f32(w_scale) / (x_bins * w_bins), in fp32: a Python
    float when both scales are numbers, else a tensor on ``device``."""
    if isinstance(x_scale, torch.Tensor) or isinstance(w_scale,
                                                       torch.Tensor):
        xs, ws = (torch.as_tensor(v).to(device, torch.float32)
                  for v in (x_scale, w_scale))
        return _div(xs * ws, x_bins * w_bins)
    return float(np.float32(np.float32(x_scale) * np.float32(w_scale))
                 / np.float32(x_bins * w_bins))


def quantized_mul(x, w_q, x_scale, w_scale, x_num_col_dims=1,
                  bit_length=8, w_bit_length=None):
    """The frozen ``mul``: x quantized on the fly at ``x_scale``, times the
    integer weight, accumulated exactly, then scaled back to fp32."""
    x_bins = _bin_cnt(bit_length)
    w_bins = _bin_cnt(bit_length if w_bit_length is None else w_bit_length)
    x = _t(x)
    w_q = _t(w_q).to(x.device)
    xs = x.reshape(math.prod(x.shape[:x_num_col_dims]), -1)
    q_x = quantize_linear(xs, x_scale, bit_length=bit_length)
    # exact integer sums in fp64, rounded to fp32 as an int32 sum would be
    acc = q_x.double() @ w_q.double()
    out = acc.float() * _scale_factor(x_scale, w_scale, x_bins, w_bins,
                                      x.device)
    return out.reshape(tuple(x.shape[:x_num_col_dims]) + (out.shape[-1],))


def quantized_conv2d(x, w_q, x_scale, w_scale, stride=1, padding=0,
                     dilation=1, groups=1, data_format="NCHW",
                     bit_length=8, w_bit_length=None):
    """The frozen conv2d: OIHW integer weights, ``groups``, the JAX padding
    (an int, per-dim ints, "SAME" or "VALID"); exact accumulation."""
    x_bins = _bin_cnt(bit_length)
    w_bins = _bin_cnt(bit_length if w_bit_length is None else w_bit_length)
    x = _t(x)
    w_q = _t(w_q).to(x.device)
    q_x = quantize_linear(x, x_scale, bit_length=bit_length).double()
    nhwc = data_format == "NHWC"
    if nhwc:
        q_x = q_x.permute(0, 3, 1, 2)
    st, dil = _pair(stride), _pair(dilation)
    q_x, pad = _conv_pads(q_x, w_q, padding, st, dil, "quantized_conv2d")
    acc = F.conv2d(q_x, w_q.double(), None, st, pad, dil, groups)
    if nhwc:
        acc = acc.permute(0, 2, 3, 1)
    return acc.float() * _scale_factor(x_scale, w_scale, x_bins, w_bins,
                                       x.device)
