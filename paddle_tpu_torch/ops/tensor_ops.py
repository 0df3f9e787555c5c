"""Tensor ops of the static path: the port of ``paddle_tpu/ops/
tensor_ops.py``'s ``concat``, ``reshape`` and ``split``."""

import torch

__all__ = ["concat", "reshape", "split"]


def concat(input, axis=0, name=None):
    return torch.cat(list(input), dim=axis)


def reshape(x, shape, inplace=False, name=None):
    """reshape_op.cc parity including the 0-entry rule: a 0 in ``shape``
    copies the input's dim at that position (-1 infers as usual)."""
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return torch.reshape(x, shape)


def split(input, num_or_sections, dim=-1, name=None):
    """split_op.cc as the JAX op computes it: an int splits into that many
    equal parts (a size it does not divide raises); a list splits at the
    running sums of all its entries but the last, so the last part takes
    the rest. Returns a list."""
    if isinstance(num_or_sections, int):
        n = input.shape[dim]
        if n % num_or_sections:
            raise ValueError(f"split: dim {dim} of size {n} does not divide "
                             f"into {num_or_sections} equal parts")
        return list(torch.split(input, n // num_or_sections, dim=dim))
    cuts, at = [], 0
    for s in num_or_sections[:-1]:
        at += int(s)
        cuts.append(at)
    return list(torch.tensor_split(input, cuts, dim=dim))
