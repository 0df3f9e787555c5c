"""Structural ops of the static path: the port of ``paddle_tpu/ops/nn.py``'s
``conv2d``, ``pool2d``, ``batch_norm``, ``dropout`` and ``embedding``, and of
its interpolation family (``interpolate``, ``resize_nearest``,
``resize_bilinear``, ``image_resize``, ``image_resize_short``).

``embedding`` routes the gather to the ``embedding_gather`` kernel (a CUDA
tensor launches it or raises; a CPU tensor takes its plain body);
``embedding_reference`` is the same function over the plain body alone, for
shape inference on meta tensors, which never reach the kernel registry.

Convolution, pooling, batch norm and dropout reach no Pallas kernel in the
JAX package (lax convolutions, ``reduce_window`` and jnp), and here no
kernel of the port: they are cuDNN's and PyTorch's through ``torch.nn.
functional``. Where PyTorch's semantics differ from the JAX op's, the
difference is made explicit: XLA's SAME padding (odd pixel after), pooling
padded with -inf (or 0) and counted as the JAX op counts, batch norm's
running stats ``m*old + (1-m)*batch`` with the biased two-pass variance.

The interpolation ops follow ``jax.image.resize``, as the JAX ``interpolate``
does (ops/nn.py:459-481), not Fluid's interp ops nor ``F.interpolate``'s
defaults: nearest takes source pixel ``floor((i + 0.5) * in / out)``
(half-pixel centres, in fp32), and bilinear without ``align_corners`` is
``scale_and_translate``'s triangle kernel, widened by ``in / out`` when it
down-samples (antialiased), its weights normalised per output pixel; both
are written out here as a gather and as one weight matrix per resized axis.
Bilinear with ``align_corners`` is the JAX function's explicit gather over
``jnp.linspace`` coordinates, computed as that ``linspace`` computes them.
"""

import contextlib

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.kernels import embedding as _gather

__all__ = ["conv2d", "pool2d", "batch_norm", "dropout", "embedding",
           "embedding_reference", "interpolate", "resize_nearest",
           "resize_bilinear", "image_resize", "image_resize_short"]


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


@contextlib.contextmanager
def no_tf32():
    """fp32 convolutions and matrix products in fp32 (cuDNN's and cuBLAS's
    TF32 off), set back as they were after: the card then computes what
    the CPU does."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _same_pad(size, k, stride, dilation=1):
    """XLA's SAME padding of one spatial dim: (before, after), the odd
    pixel after."""
    eff = (k - 1) * dilation + 1
    total = max((-(-size // stride) - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def conv2d(x, weight, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """conv_op.cc parity: an OIHW ``weight`` (out, in/groups, kh, kw) over
    NCHW or NHWC ``x``; ``padding`` an int, a per-dim pair, "SAME" (XLA's:
    the odd pixel after, with stride and dilation) or "VALID". A bf16 x
    gives fp32 out (``preferred_element_type``), from the fp32 products."""
    nhwc = data_format == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    if x.dtype == torch.bfloat16:
        x, weight = x.float(), weight.float()
    st, dil = _pair(stride), _pair(dilation)
    kh, kw = weight.shape[2], weight.shape[3]
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = ((0, 0), (0, 0))
        elif padding.upper() == "SAME":
            pads = (_same_pad(x.shape[2], kh, st[0], dil[0]),
                    _same_pad(x.shape[3], kw, st[1], dil[1]))
        else:
            raise ValueError(f"conv2d: padding must be SAME, VALID or ints, "
                             f"got {padding!r}")
    else:
        pads = tuple((int(p), int(p)) for p in _pair(padding))
    if all(a == b for a, b in pads):
        pad = (pads[0][0], pads[1][0])
    else:
        x = F.pad(x, (*pads[1], *pads[0]))
        pad = 0
    out = F.conv2d(x, weight.to(x.dtype), None, st, pad, dil, groups)
    return out.permute(0, 2, 3, 1) if nhwc else out


def pool2d(x, pool_size=2, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, ceil_mode=False, exclusive=True,
           data_format="NCHW", name=None):
    """pool_op.cc parity as the JAX op computes it: ``ceil_mode`` pads
    stride-1 more at the high end; max pools over -inf padding; avg sums
    the window and divides by its real elements (``exclusive``) or by k*k;
    ``global_pooling`` keeps the dims. The padding is explicit, so any
    padding (up to k-1) and any ceil-mode window is taken."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"pool2d: data_format must be NCHW|NHWC, "
                         f"got {data_format!r}")
    sp = (2, 3) if data_format == "NCHW" else (1, 2)
    if global_pooling:
        if pool_type == "max":
            return torch.amax(x, dim=sp, keepdim=True)
        return torch.mean(x, dim=sp, keepdim=True)
    nhwc = data_format == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    ks, st, pd = _pair(pool_size), _pair(pool_stride), _pair(pool_padding)
    pads = (pd[1], pd[1] + (st[1] - 1 if ceil_mode else 0),
            pd[0], pd[0] + (st[0] - 1 if ceil_mode else 0))
    if pool_type == "max":
        low = (-float("inf") if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        out = F.max_pool2d(F.pad(x, pads, value=low), ks, st)
    else:
        s = F.avg_pool2d(F.pad(x, pads), ks, st, divisor_override=1)
        if exclusive:
            ones = torch.ones((1, 1, x.shape[2], x.shape[3]), dtype=x.dtype,
                              device=x.device)
            cnt = F.avg_pool2d(F.pad(ones, pads), ks, st, divisor_override=1)
            out = s / cnt
        else:
            out = s / (ks[0] * ks[1])
    return out.permute(0, 2, 3, 1) if nhwc else out


def batch_norm(x, scale, bias, mean, variance, epsilon=1e-5, momentum=0.9,
               is_test=False, data_layout="NCHW", use_global_stats=False,
               name=None):
    """batch_norm_op.cc parity, as the JAX op: ``(out, mean_out,
    variance_out, saved_mean, saved_variance)``. Training normalises by the
    batch's mean and biased two-pass variance, and the running stats are
    ``momentum * old + (1 - momentum) * batch`` (not ``F.batch_norm``'s
    ``(1 - m) * old + m * batch`` with the unbiased variance). ``is_test``
    or ``use_global_stats`` normalise by the running stats and return them
    unchanged."""
    axis = 1 if data_layout == "NCHW" else x.dim() - 1
    red = tuple(i for i in range(x.dim()) if i != axis)
    bshape = [1] * x.dim()
    bshape[axis] = x.shape[axis]

    def norm(m, v):
        return (x - m.reshape(bshape)) * (
            scale.reshape(bshape) * torch.rsqrt(v.reshape(bshape) + epsilon)
        ) + bias.reshape(bshape)

    if is_test or use_global_stats:
        return norm(mean, variance), mean, variance, mean, variance
    m = torch.mean(x, dim=red)
    v = torch.mean(torch.square(x - m.reshape(bshape)), dim=red)
    mean_out = momentum * mean + (1 - momentum) * m
    var_out = momentum * variance + (1 - momentum) * v
    return norm(m, v), mean_out, var_out, m, v


def dropout(x, dropout_prob=0.5, is_test=False, seed=None,
            dropout_implementation="downgrade_in_infer", rng=None,
            name=None):
    """dropout_op.cc parity, both implementations: ``downgrade_in_infer``
    (zero at training, scale by 1-p at inference) and ``upscale_in_train``
    (x/(1-p) at training, x at inference). ``rng`` is a ``torch.Generator``
    on x's device; without one, ``seed`` makes one, and with neither the
    device's default generator draws. ``dropout_prob == 0`` returns x
    itself. The masks are torch's draws, not the JAX package's threefry
    bits: keep share, values and gradient are what carry over."""
    if dropout_prob == 0.0:
        return x
    if is_test:
        if dropout_implementation == "downgrade_in_infer":
            return x * (1.0 - dropout_prob)
        return x
    if rng is None and seed:
        rng = torch.Generator(device=x.device).manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=rng, device=x.device) \
        < 1.0 - dropout_prob
    if dropout_implementation == "upscale_in_train":
        return torch.where(keep, x / (1.0 - dropout_prob), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def _embedding(gather, ids, weight, padding_idx):
    squeeze = ids.dim() > 0 and ids.shape[-1] == 1
    if squeeze:
        ids = ids[..., 0]
    out = gather(weight, ids)
    if padding_idx is not None:
        if padding_idx < 0:  # fluid convention: -1 is the last row
            padding_idx = weight.shape[0] + padding_idx
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out


def embedding(ids, weight, padding_idx=None, name=None):
    """lookup_table_op.cc parity: rows of ``weight`` at ``ids`` (a trailing
    axis of 1 is squeezed first), zero rows at ``padding_idx``."""
    return _embedding(_gather.embedding_gather, ids, weight, padding_idx)


def embedding_reference(ids, weight, padding_idx=None, name=None):
    """:func:`embedding` over the plain gather body."""
    return _embedding(_gather._embedding_gather_reference, ids, weight,
                      padding_idx)


def _nearest_index(m, n, device):
    """``jax.image.resize``'s nearest source index of each of ``n`` outputs
    over ``m`` inputs: floor((i + 0.5) * m / n) in fp32."""
    return torch.floor((torch.arange(n, dtype=torch.float32, device=device)
                        + 0.5) * m / n).long()


def _triangle_weights(m, n, device):
    """``jax.image``'s ``compute_weight_mat`` for the triangle kernel with
    antialiasing, scale n/m and no translation: [m, n] in fp32."""
    inv = _f32(1.0 / (n / m))
    kscale = max(inv, 1.0)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        m, dtype=torch.float32, device=device)[:, None]) / kscale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(torch.finfo(
        torch.float32).eps), w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _f32(v):
    """A Python float rounded to fp32 (a JAX weak-typed scalar in an fp32
    computation)."""
    return float(torch.tensor(v, dtype=torch.float32))


def _linspace(stop, num, device):
    """``jnp.linspace(0, stop, num)`` in fp32 as JAX computes it:
    ``stop * (i / (num - 1))`` and the end point itself."""
    if num == 1:
        return torch.zeros(1, device=device)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) \
        / (num - 1)
    return torch.cat([0.0 * (1 - step) + float(stop) * step,
                      torch.full((1,), float(stop), device=device)])


def interpolate(x, out_shape=None, scale=None, resample="BILINEAR",
                align_corners=True, data_format="NCHW", name=None):
    """interpolate_op.cc parity as the JAX op computes it (nearest or
    bilinear over NCHW; see the module docstring)."""
    n, c, h, w = x.shape
    if out_shape is None:
        out_shape = (int(h * scale), int(w * scale))
    oh, ow = (int(v) for v in out_shape)
    if resample.upper() == "NEAREST":
        if oh != h:
            x = x[:, :, _nearest_index(h, oh, x.device)]
        if ow != w:
            x = x[:, :, :, _nearest_index(w, ow, x.device)]
        return x
    if not align_corners:
        if oh != h:
            x = torch.einsum("nchw,hH->ncHw", x,
                             _triangle_weights(h, oh, x.device).to(x.dtype))
        if ow != w:
            x = torch.einsum("nchw,wW->nchW", x,
                             _triangle_weights(w, ow, x.device).to(x.dtype))
        return x
    ys = _linspace(h - 1, oh, x.device)
    xs = _linspace(w - 1, ow, x.device)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0)[None, None, :, None]
    wx = (xs - x0)[None, None, None, :]

    def g(yi, xi):
        return x[:, :, yi][:, :, :, xi]
    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def resize_nearest(x, out_shape=None, scale=None, align_corners=True,
                   name=None):
    return interpolate(x, out_shape, scale, "NEAREST", align_corners)


def resize_bilinear(x, out_shape=None, scale=None, align_corners=True,
                    name=None):
    return interpolate(x, out_shape, scale, "BILINEAR", align_corners)


def image_resize(x, out_shape=None, scale=None, resample="BILINEAR",
                 align_corners=True, name=None):
    """fluid.layers.image_resize parity: the user-facing dispatcher over
    interpolate_op.cc."""
    if resample.upper() not in ("BILINEAR", "NEAREST"):
        raise ValueError(
            f"image_resize: resample must be BILINEAR or NEAREST, "
            f"got {resample}")
    return interpolate(x, out_shape, scale, resample.upper(), align_corners)


def image_resize_short(x, out_short_len, resample="BILINEAR", name=None):
    """fluid.layers.image_resize_short parity: resize so the short edge
    becomes out_short_len, keeping the aspect ratio."""
    n, c, h, w = x.shape
    short = min(h, w)
    oh = int(round(h * out_short_len / short))
    ow = int(round(w * out_short_len / short))
    return image_resize(x, (oh, ow), None, resample)
