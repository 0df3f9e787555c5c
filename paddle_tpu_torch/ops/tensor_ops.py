"""Tensor ops of the static path: the port of ``paddle_tpu/ops/
tensor_ops.py``'s ``concat`` and ``reshape``."""

import torch

__all__ = ["concat", "reshape"]


def concat(input, axis=0, name=None):
    return torch.cat(list(input), dim=axis)


def reshape(x, shape, inplace=False, name=None):
    """reshape_op.cc parity including the 0-entry rule: a 0 in ``shape``
    copies the input's dim at that position (-1 infers as usual)."""
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return torch.reshape(x, shape)
