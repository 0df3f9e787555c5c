"""Structural ops of the static path: the port of ``paddle_tpu/ops/nn.py``'s
``conv2d``, ``pool2d``, ``batch_norm``, ``dropout`` and ``embedding``.

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
"""

import contextlib

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.kernels import embedding as _gather

__all__ = ["conv2d", "pool2d", "batch_norm", "dropout", "embedding",
           "embedding_reference"]


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
