"""Structural ops: the port of ``paddle_tpu/ops/nn.py``, every public
function (convolutions and their transposes, pooling, the norms, dropout,
embedding, one-hot, padding, the interpolation family, pixel and channel
shuffles, ``unfold``, ``fc_act``).

``embedding`` routes the gather to the ``embedding_gather`` kernel (a CUDA
tensor launches it or raises; a CPU tensor takes its plain body);
``embedding_reference`` is the same function over the plain body alone, for
shape inference on meta tensors, which never reach the kernel registry.

Convolution, pooling, the norms and dropout reach no Pallas kernel in the
JAX package (lax convolutions, ``reduce_window`` and jnp), and here no
kernel of the port: they are cuDNN's and PyTorch's through ``torch.nn.
functional``. Where PyTorch's semantics differ from the JAX op's, the
difference is made explicit: XLA's SAME padding (odd pixel after), pooling
padded with -inf (or 0) and counted as the JAX op counts (``pool3d``'s
average divides by the whole window, padding included), batch norm's
running stats ``m*old + (1-m)*batch`` with the biased two-pass variance,
which ``layer_norm``, ``group_norm`` and ``instance_norm`` take too
(``jnp.var``: the mean of the squared deviations from the mean). The
transposed convolutions take IOHW (IODHW) weights, as
``F.conv_transpose2d`` does and the JAX op's gradient-of-conv form reads
them, with no output padding. Adaptive max pooling reduces with ``amax``,
which splits the gradient evenly among tied maxima as ``jnp.max`` does
(``F.adaptive_max_pool2d`` gives it to one element); its average over
windows that do not divide the input is the JAX op's mask product in fp32
with TF32 off. ``lrn`` does not divide ``alpha`` by ``n`` (nor does the JAX
op), ``space_to_depth`` orders the channels (bh, bw, c), and ``one_hot``
gives a zero row for an id outside [0, depth), as ``jax.nn.one_hot`` does.

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

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops import activation as _act
from paddle_tpu_torch.ops.kernels import embedding as _gather

__all__ = [
    "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "depthwise_conv2d", "pool2d", "pool3d", "adaptive_pool2d",
    "adaptive_pool3d", "batch_norm", "layer_norm", "group_norm",
    "instance_norm", "data_norm", "sync_batch_norm", "dropout", "embedding",
    "embedding_reference", "one_hot", "label_smooth", "lrn", "pad", "pad2d",
    "pad_constant_like", "interpolate", "resize_nearest", "resize_bilinear",
    "image_resize", "image_resize_short", "pixel_shuffle", "affine_channel",
    "unfold", "space_to_depth", "shuffle_channel", "fc_act",
]


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
    x, pad = _conv_pads(x, weight, padding, st, dil, "conv2d")
    out = F.conv2d(x, weight.to(x.dtype), None, st, pad, dil, groups)
    return out.permute(0, 2, 3, 1) if nhwc else out


def _conv_pads(x, weight, padding, st, dil, op):
    """``x`` and the ``padding`` argument of a forward convolution over x's
    trailing spatial dims: an int or per-dim ints (symmetric), "VALID", or
    "SAME" (XLA's, the odd pixel after: padded explicitly)."""
    nd = weight.dim() - 2
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = ((0, 0),) * nd
        elif padding.upper() == "SAME":
            pads = tuple(_same_pad(x.shape[2 + i], weight.shape[2 + i],
                                   st[i], dil[i]) for i in range(nd))
        else:
            raise ValueError(f"{op}: padding must be SAME, VALID or ints, "
                             f"got {padding!r}")
    else:
        pads = tuple((int(p), int(p)) for p in _pair(padding, nd))
    if all(a == b for a, b in pads):
        return x, tuple(p[0] for p in pads)
    return F.pad(x, [v for p in reversed(pads) for v in p]), 0


def depthwise_conv2d(x, weight, stride=1, padding=0, dilation=1,
                     data_format="NCHW", name=None):
    """conv2d with one group per input channel."""
    c = x.shape[1] if data_format == "NCHW" else x.shape[-1]
    return conv2d(x, weight, stride, padding, dilation, groups=c,
                  data_format=data_format)


def conv3d(x, weight, stride=1, padding=0, dilation=1, groups=1, name=None):
    """conv_op.cc 3-D parity: an OIDHW ``weight`` over NCDHW ``x``."""
    st, dil = _pair(stride, 3), _pair(dilation, 3)
    x, pad = _conv_pads(x, weight, padding, st, dil, "conv3d")
    return F.conv3d(x, weight.to(x.dtype), None, st, pad, dil, groups)


def conv2d_transpose(x, weight, stride=1, padding=0, dilation=1, groups=1,
                     data_format="NCHW", name=None):
    """conv_transpose_op.cc parity: an IOHW ``weight`` (in, out/groups, kh,
    kw); out = (in - 1) * stride - 2 * padding + dilation * (k - 1) + 1,
    as the JAX op's input-dilated convolution gives it."""
    nhwc = data_format == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    out = F.conv_transpose2d(x, weight.to(x.dtype), None, _pair(stride),
                             _pair(padding), 0, groups, _pair(dilation))
    return out.permute(0, 2, 3, 1) if nhwc else out


def conv3d_transpose(x, weight, stride=1, padding=0, dilation=1, groups=1,
                     name=None):
    """conv_transpose_op.cc 3-D parity: an IODHW ``weight`` over NCDHW
    ``x``, as :func:`conv2d_transpose`."""
    return F.conv_transpose3d(x, weight.to(x.dtype), None, _pair(stride, 3),
                              _pair(padding, 3), 0, groups,
                              _pair(dilation, 3))


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


def pool3d(x, pool_size=2, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, name=None):
    """3-D pooling over NCDHW as the JAX op computes it: max over -inf
    padding; average as the window's sum over the whole window (k0*k1*k2,
    padding included); ``global_pooling`` keeps the dims."""
    if global_pooling:
        fn = torch.amax if pool_type == "max" else torch.mean
        return fn(x, dim=(2, 3, 4), keepdim=True)
    ks, st = _pair(pool_size, 3), _pair(pool_stride, 3)
    pads = [p for v in reversed(_pair(pool_padding, 3)) for p in (v, v)]
    if pool_type == "max":
        return F.max_pool3d(F.pad(x, pads, value=-float("inf")), ks, st)
    s = F.avg_pool3d(F.pad(x, pads), ks, st, divisor_override=1)
    return s / (ks[0] * ks[1] * ks[2])


def _adaptive_mask(size, out, device):
    """pool_op.h's adaptive windows as an [out, size] fp32 0/1 mask: cell i
    covers [floor(i * size / out), ceil((i + 1) * size / out))."""
    idx = np.arange(size)
    starts = np.floor(np.arange(out) * size / out).astype(int)
    ends = np.ceil((np.arange(out) + 1) * size / out).astype(int)
    m = (idx[None, :] >= starts[:, None]) & (idx[None, :] < ends[:, None])
    return torch.as_tensor(m, dtype=torch.float32, device=device)


def _adaptive(x, outs, pool_type):
    """Adaptive pooling of x's trailing len(outs) dims to ``outs``: a
    reshape reduced by ``amax``/``mean`` where each output divides its
    input, else one axis at a time over the windows' masks (max: ``amax``
    of the masked values; average: the mask product in fp32 with TF32 off,
    over the window's count, cast back)."""
    sp = x.shape[2:]
    if all(s % o == 0 for s, o in zip(sp, outs)):
        shape = list(x.shape[:2])
        for s, o in zip(sp, outs):
            shape += [o, s // o]
        dims = tuple(3 + 2 * i for i in range(len(outs)))
        y = x.reshape(shape)
        return (torch.amax(y, dim=dims) if pool_type == "max"
                else torch.mean(y, dim=dims))
    for i, out in enumerate(outs):
        ax = 2 + i
        m = _adaptive_mask(x.shape[ax], out, x.device)
        xm = torch.movedim(x, ax, -1)
        if pool_type == "max":
            low = (torch.finfo(x.dtype).min if x.is_floating_point()
                   else torch.iinfo(x.dtype).min)
            r = torch.amax(torch.where(m.bool(), xm[..., None, :],
                                       torch.tensor(low, dtype=x.dtype,
                                                    device=x.device)),
                           dim=-1)
        else:
            with no_tf32():
                r = ((xm.float() @ m.T) / m.sum(-1)).to(x.dtype)
        x = torch.movedim(r, -1, ax)
    return x


def adaptive_pool2d(x, pool_size, pool_type="avg", name=None):
    """Adaptive pooling (pool_op.cc adaptive=True) of NCHW ``x`` to any
    output size, over pool_op.h's per-cell windows."""
    return _adaptive(x, _pair(pool_size), pool_type)


def adaptive_pool3d(x, pool_size, pool_type="avg", name=None):
    """Adaptive 3-D pooling of NCDHW ``x``, as :func:`adaptive_pool2d`."""
    return _adaptive(x, _pair(pool_size, 3), pool_type)


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


def sync_batch_norm(x, scale, bias, mean, variance, epsilon=1e-5,
                    momentum=0.9, is_test=False, data_layout="NCHW",
                    axis_name=None, name=None):
    """sync_batch_norm_op parity on one replica: with ``axis_name=None`` or
    ``is_test`` it is :func:`batch_norm`, as in the JAX op. Statistics
    across replicas are ROADMAP queue 1 item 9."""
    if is_test or axis_name is None:
        return batch_norm(x, scale, bias, mean, variance, epsilon, momentum,
                          is_test=is_test, data_layout=data_layout)
    raise EnforceNotMet(
        f"sync_batch_norm(axis_name={axis_name!r}): batch statistics across "
        "replicas are not ported yet (ROADMAP queue 1 item 9)")


def _normalize(x, red, epsilon):
    """(x - mean) * rsqrt(var + epsilon) over ``red``, the variance the
    mean of the squared deviations (``jnp.var``'s two passes)."""
    m = torch.mean(x, dim=red, keepdim=True)
    v = torch.mean(torch.square(x - m), dim=red, keepdim=True)
    return (x - m) * torch.rsqrt(v + epsilon)


def layer_norm(x, scale=None, bias=None, begin_norm_axis=1, epsilon=1e-5,
               name=None):
    """layer_norm_op.cc parity: normalize over dims [begin_norm_axis:)."""
    out = _normalize(x, tuple(range(begin_norm_axis, x.dim())), epsilon)
    norm_shape = x.shape[begin_norm_axis:]
    if scale is not None:
        out = out * scale.reshape(norm_shape)
    if bias is not None:
        out = out + bias.reshape(norm_shape)
    return out


def group_norm(x, scale=None, bias=None, groups=32, epsilon=1e-5,
               data_layout="NCHW", name=None):
    """group_norm_op.cc parity (NCHW)."""
    n, c = x.shape[0], x.shape[1]
    xs = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    out = _normalize(xs, tuple(range(2, xs.dim())), epsilon).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    if scale is not None:
        out = out * scale.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    return out


def instance_norm(x, scale=None, bias=None, epsilon=1e-5, name=None):
    """instance_norm_op.cc parity: group_norm with one group per channel."""
    return group_norm(x, scale, bias, groups=x.shape[1], epsilon=epsilon)


def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4,
              name=None):
    """data_norm_op.cc parity: normalize by accumulated batch statistics."""
    means = batch_sum / batch_size
    scales = torch.sqrt(batch_size / (batch_square_sum - batch_size
                                      * torch.square(means) + epsilon))
    return (x - means) * scales


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


def one_hot(x, depth, dtype=torch.float32, name=None):
    """``jax.nn.one_hot`` over ids (a trailing axis of 1 squeezed first): an
    id outside [0, depth), negative ones too, gives a row of zeros."""
    x = torch.as_tensor(x)
    if x.dim() and x.shape[-1] == 1:
        x = x[..., 0]
    hot = x[..., None] == torch.arange(depth, device=x.device)
    return hot.to(convert_dtype(dtype))


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    k = label.shape[-1]
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / k


def lrn(x, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """lrn_op.cc parity as the JAX op computes it (NCHW): x / (k + alpha *
    sum of the n neighbouring channels' squares) ** beta, ``alpha`` not
    divided by n (``F.local_response_norm`` divides it), the sum taken in
    channel order."""
    sq = torch.square(x)
    half = n // 2
    pad = F.pad(sq, (0, 0, 0, 0, half, half))
    acc = 0
    for i in range(n):
        acc = acc + pad[:, i:i + x.shape[1]]
    return x / torch.pow(k + alpha * acc, beta)


def pad(x, paddings, pad_value=0.0, name=None):
    """pad_op.cc parity: flat [before0, after0, before1, after1, ...]."""
    flat = [int(paddings[2 * i + j]) for i in reversed(range(x.dim()))
            for j in (0, 1)]
    return F.pad(x, flat, value=pad_value)


def pad2d(x, paddings, mode="constant", pad_value=0.0, data_format="NCHW",
          name=None):
    """pad2d_op.cc parity: [top, bottom, left, right] over H and W, mode
    "constant", "reflect" (numpy's: the edge not repeated) or "edge"
    (``replicate``)."""
    t, b, l, r = (int(v) for v in paddings)
    tmode = {"constant": "constant", "reflect": "reflect",
             "edge": "replicate"}[mode]
    nhwc = data_format != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    if tmode == "constant":
        out = F.pad(x, (l, r, t, b), value=pad_value)
    else:
        out = F.pad(x, (l, r, t, b), mode=tmode)
    return out.permute(0, 2, 3, 1) if nhwc else out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """y padded at the end of each dim to x's shape with ``pad_value``."""
    flat = [v for i in reversed(range(y.dim()))
            for v in (0, int(x.shape[i]) - int(y.shape[i]))]
    return F.pad(y, flat, value=pad_value)


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


def pixel_shuffle(x, upscale_factor, name=None):
    """pixel_shuffle_op.cc parity (NCHW)."""
    n, c, h, w = x.shape
    r = upscale_factor
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (r * r), h * r, w * r)


def affine_channel(x, scale, bias, data_layout="NCHW", name=None):
    bshape = ((1, -1) + (1,) * (x.dim() - 2) if data_layout == "NCHW"
              else (-1,))
    return x * scale.reshape(bshape) + bias.reshape(bshape)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """unfold_op.cc (im2col) parity: [N, C, H, W] to [N, C*kh*kw, L], the
    channels ordered (c, kh, kw)."""
    return F.unfold(x, _pair(kernel_sizes), _pair(dilations),
                    _pair(paddings), _pair(strides))


def space_to_depth(x, blocksize, name=None):
    """space_to_depth_op.cc parity as the JAX op orders the channels:
    (bh, bw, c), not ``pixel_unshuffle``'s (c, bh, bw)."""
    n, c, h, w = x.shape
    b = blocksize
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


def shuffle_channel(x, group, name=None):
    n, c, h, w = x.shape
    x = x.reshape(n, group, c // group, h, w)
    return x.transpose(1, 2).reshape(n, c, h, w)


def fc_act(x, act):
    """Apply a named activation (the reference's ``act`` attr pattern)."""
    if act is None:
        return x
    return getattr(_act, act)(x)
