"""Reduction ops: the port of ``paddle_tpu/ops/reduce.py``, every public
function.

Parity targets: operators/reduce_ops/ (reduce_sum/mean/max/min/prod/all/
any), mean_op.cc, squared_l2_norm_op.cc, l1_norm_op.cc, norm_op.cc,
mean_iou_op.cc. ``dim`` is None (every dim), an int or a list; the mean of
integers is float32, as ``jnp.mean`` gives it.
"""

import torch

from paddle_tpu_torch.ops.math import _abs

__all__ = [
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
    "reduce_all", "reduce_any", "mean", "squared_l2_norm", "l1_norm",
    "l2_normalize", "norm", "mean_iou",
]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _dims(x, dim):
    if dim is None:
        return tuple(range(x.dim()))
    return (dim,) if isinstance(dim, int) else tuple(dim)


def _prod(x, dim, keepdim):
    for d in sorted((d % x.dim() for d in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(fn, prep=None):
    def op(input, dim=None, keep_dim=False, name=None):
        x = _t(input)
        if prep is not None:
            x = prep(x)
        dims = _dims(x, dim)
        if not dims:                      # a 0-d input: nothing to reduce
            return fn(x.reshape(1), (0,), False)
        return fn(x, dims, keep_dim)
    return op


reduce_sum = _reduce(lambda x, d, k: torch.sum(x, dim=d, keepdim=k))
reduce_mean = _reduce(
    lambda x, d, k: torch.mean(x, dim=d, keepdim=k),
    prep=lambda x: x if x.is_floating_point() else x.to(torch.float32))
reduce_max = _reduce(lambda x, d, k: torch.amax(x, dim=d, keepdim=k))
reduce_min = _reduce(lambda x, d, k: torch.amin(x, dim=d, keepdim=k))
reduce_prod = _reduce(_prod)
reduce_all = _reduce(lambda x, d, k: torch.all(x.to(torch.bool), dim=d,
                                               keepdim=k))
reduce_any = _reduce(lambda x, d, k: torch.any(x.to(torch.bool), dim=d,
                                               keepdim=k))


def mean(x, name=None):
    """mean_op.cc parity: the scalar mean of all elements."""
    x = _t(x)
    return (x if x.is_floating_point() else x.to(torch.float32)).mean()


def squared_l2_norm(x, name=None):
    return torch.sum(torch.square(_t(x)))


def l1_norm(x, name=None):
    return torch.sum(_abs(_t(x)))


def l2_normalize(x, axis=-1, epsilon=1e-12, name=None):
    x = _t(x)
    n = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    return x / torch.clamp(n, min=epsilon)


def norm(x, axis=-1, epsilon=1e-10, name=None):
    """norm_op.cc parity: x over its L2 norm along ``axis`` (the op's
    Out)."""
    x = _t(x)
    return x / torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True)
                          + epsilon)


def mean_iou(input, label, num_classes):
    """mean_iou_op.cc parity: (miou, out_wrong, out_correct)."""
    pred = _t(input).reshape(-1).long()
    lab = _t(label).reshape(-1).long()
    cm = torch.bincount(lab * num_classes + pred,
                        minlength=num_classes * num_classes
                        ).reshape(num_classes, num_classes)
    diag = torch.diagonal(cm)
    inter = diag.to(torch.float32)
    union = (cm.sum(0) + cm.sum(1)).to(torch.float32) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp(union, min=1.0),
                      torch.zeros_like(inter))
    miou = iou.sum() / torch.clamp(valid.to(torch.float32).sum(), min=1.0)
    return miou, cm.sum(1) - diag, diag
