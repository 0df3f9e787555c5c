"""Losses of the static path: the port of ``paddle_tpu/ops/loss.py``'s
``cross_entropy`` (on probabilities, loss.py:31-45) and
``square_error_cost``."""

import torch

__all__ = ["cross_entropy", "square_error_cost"]


def _squeeze_label(label):
    if label.dim() and label.shape[-1] == 1:
        return label[..., 0]
    return label


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
    """cross_entropy_op.cc parity: ``input`` is a probability distribution
    (after softmax); returns [..., 1]."""
    eps = 1e-12
    if soft_label:
        return -torch.sum(label * torch.log(input + eps), dim=-1,
                          keepdim=True)
    lab = _squeeze_label(label)
    picked = torch.gather(input, -1, lab[..., None].long())
    loss = -torch.log(picked + eps)
    if ignore_index >= 0:
        loss = loss.masked_fill(lab[..., None] == ignore_index, 0.0)
    return loss


def square_error_cost(input, label, name=None):
    return torch.square(input - label)
