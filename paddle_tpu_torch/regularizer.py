"""Weight regularizers: the port of ``paddle_tpu/regularizer.py``.

A regularizer is ``(param, grad) -> grad``, applied before the clip and the
update. The class names are the JAX package's, so a program document that
holds one (``paddle_tpu.regularizer:L2DecayRegularizer``) loads in the port.
"""

import torch

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer"]


class L2DecayRegularizer:
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def __call__(self, param, grad):
        return grad + self.coeff * param


class L1DecayRegularizer:
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def __call__(self, param, grad):
        return grad + self.coeff * torch.sign(param)


L2Decay = L2DecayRegularizer
L1Decay = L1DecayRegularizer
