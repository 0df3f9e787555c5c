"""fluid.dygraph namespace: the port of ``paddle_tpu/dygraph/__init__.py``
(the reference's dygraph/ base.py guard/enabled/to_variable, nn.py's layer
classes, checkpoint.py save/load_persistables, learning_rate_scheduler.py's
decay classes, parallel.py prepare_context/DataParallel).

Eager execution is the default, so ``guard()`` only suspends the building
of a static program for its scope.

A ``LearningRateDecay`` passed to an optimizer as ``learning_rate=`` is
called with the optimizer's step counter (a 0-d tensor on the card) and
returns a 0-d fp32 tensor on the card, so the fused update kernels read the
rate from device memory with no host read. ``step()`` moves the object's
own host counter, for use on its own.
"""

import contextlib
import os

from paddle_tpu_torch.framework import grad, no_grad, to_variable  # noqa: F401
from paddle_tpu_torch.layers import learning_rate_scheduler as _sched
from paddle_tpu_torch.nn import layers as nn  # noqa: F401
from paddle_tpu_torch.nn.layers import (  # noqa: F401
    FC, NCE, BatchNorm, BilinearTensorProduct, Conv2D, Conv2DTranspose,
    Conv3D, Conv3DTranspose, Embedding, GroupNorm, GRUUnit, LayerNorm,
    Linear, Pool2D, PRelu, RowConv, SpectralNorm, TreeConv,
)
from paddle_tpu_torch.nn.module import Layer  # noqa: F401
from paddle_tpu_torch.parallel.env import (  # noqa: F401
    DataParallel, ParallelEnv, prepare_context,
)
from paddle_tpu_torch.static.program import in_static_mode

__all__ = [
    "enabled", "guard", "to_variable", "no_grad", "grad", "Layer",
    "save_persistables", "load_persistables", "prepare_context",
    "DataParallel",
    "Linear", "Conv2D", "Conv3D", "Pool2D", "FC", "BatchNorm",
    "Embedding", "GRUUnit", "LayerNorm", "NCE", "PRelu",
    "BilinearTensorProduct", "Conv2DTranspose", "Conv3DTranspose",
    "GroupNorm", "SpectralNorm", "TreeConv", "RowConv",
    "NoamDecay", "PiecewiseDecay", "NaturalExpDecay", "ExponentialDecay",
    "InverseTimeDecay", "PolynomialDecay", "CosineDecay",
]


def enabled():
    """dygraph.enabled parity: True when no static program is being
    built (eager is the default)."""
    return not in_static_mode()


@contextlib.contextmanager
def guard(place=None):
    """dygraph.guard parity: static-program mode is off inside, and as it
    was after."""
    from paddle_tpu_torch.static import program as _prog
    was_static = in_static_mode()
    if was_static:
        _prog.disable_static()
    try:
        yield
    finally:
        if was_static:
            _prog.enable_static()


def save_persistables(model_dict, dirname="save_dir", optimizers=None):
    """dygraph/checkpoint.py save_persistables parity: a Layer's
    ``state_dict()`` (or a params tree) to ``dirname/model.pdparams``, and
    ``optimizers`` to ``dirname/optimizers.pdparams``."""
    from paddle_tpu_torch import io as _io
    if hasattr(model_dict, "state_dict"):
        model_dict = model_dict.state_dict()
    os.makedirs(dirname, exist_ok=True)
    _io.save_dygraph(model_dict, os.path.join(dirname, "model"))
    if optimizers is not None:
        _io.save_dygraph(optimizers, os.path.join(dirname, "optimizers"))


def load_persistables(dirname="save_dir", device=None):
    """dygraph/checkpoint.py load_persistables parity: ``(params,
    optimizers or None)``, on ``device`` (the card when None)."""
    from paddle_tpu_torch import io as _io
    params, _ = _io.load_dygraph(os.path.join(dirname, "model"),
                                 device=device)
    opt = None
    if os.path.exists(os.path.join(dirname, "optimizers.pdparams")):
        opt, _ = _io.load_dygraph(os.path.join(dirname, "optimizers"),
                                  device=device)
    return params, opt


class LearningRateDecay:
    """dygraph/learning_rate_scheduler.py LearningRateDecay parity: a host
    step counter over a ``layers.learning_rate_scheduler`` schedule. Called
    with a step (the optimizer's counter tensor), it is the schedule at
    that step, on the step's device; called with none, at its own
    counter (a CPU tensor)."""

    def __init__(self, schedule, begin=0, step_size=1):
        self._schedule = schedule
        self.step_num = begin
        self.step_size = step_size

    def __call__(self, step=None):
        return self._schedule(self.step_num if step is None else step)

    def step(self):
        """Advance the counter by ``step_size`` and return the rate there
        (the reference advances it once per ``minimize``)."""
        self.step_num += self.step_size
        return self._schedule(self.step_num)


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1,
                 learning_rate=1.0):
        super().__init__(_sched.noam_decay(d_model, warmup_steps,
                                           learning_rate), begin, step)


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1):
        super().__init__(_sched.piecewise_decay(boundaries, values),
                         begin, step)


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(_sched.natural_exp_decay(
            learning_rate, decay_steps, decay_rate, staircase), begin, step)


class ExponentialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(_sched.exponential_decay(
            learning_rate, decay_steps, decay_rate, staircase), begin, step)


class InverseTimeDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(_sched.inverse_time_decay(
            learning_rate, decay_steps, decay_rate, staircase), begin, step)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=1e-4,
                 power=1.0, cycle=False, begin=0, step=1):
        super().__init__(_sched.polynomial_decay(
            learning_rate, decay_steps, end_learning_rate, power, cycle),
            begin, step)


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1):
        super().__init__(_sched.cosine_decay(
            learning_rate, step_each_epoch, epochs), begin, step)
