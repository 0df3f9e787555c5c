"""Activations of the static path: the port of ``paddle_tpu/ops/
activation.py``'s ``relu``, ``sigmoid``, ``tanh``, ``gelu`` and
``softmax``."""

import torch

__all__ = ["relu", "sigmoid", "tanh", "gelu", "softmax"]


def relu(x, name=None):
    return torch.relu(x)


def gelu(x, approximate=False, name=None):
    """Exact erf gelu by default, as ``jax.nn.gelu(approximate=False)``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def softmax(x, axis=-1, name=None):
    return torch.softmax(x, dim=axis)
