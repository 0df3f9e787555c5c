"""fluid.backward parity: the static autodiff entry points of
``static/backward.py``."""

from paddle_tpu_torch.static.backward import (  # noqa: F401
    GRAD_SUFFIX, append_backward, calc_gradient, gradients,
)

__all__ = ["append_backward", "gradients", "calc_gradient", "GRAD_SUFFIX"]
