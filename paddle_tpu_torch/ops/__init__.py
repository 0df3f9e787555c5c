"""Operators of the port. ``ops.kernels`` holds the hand-written CUDA kernels.

The ported op modules are star-exported here, as the JAX package's
``paddle_tpu.ops`` star-imports its own, so reference code's
``ops.huber_loss`` or ``ops.merge_selected_rows`` resolves. The kernels
stay under ``ops.kernels``. ``misc`` exports ``sum`` (operators/sum_op.cc)
and ``aliases`` exports ``range`` (operators/range_op.cc), which shadow the
builtins here, as in the JAX package's ``ops``: nothing below the star
imports uses the builtins."""

from paddle_tpu_torch.ops.activation import *  # noqa: F401,F403
from paddle_tpu_torch.ops.aliases import *  # noqa: F401,F403
from paddle_tpu_torch.ops.control_flow import *  # noqa: F401,F403
from paddle_tpu_torch.ops.crf import *  # noqa: F401,F403
from paddle_tpu_torch.ops.ctc import *  # noqa: F401,F403
from paddle_tpu_torch.ops.detection import *  # noqa: F401,F403
from paddle_tpu_torch.ops.loss import *  # noqa: F401,F403
from paddle_tpu_torch.ops.math import *  # noqa: F401,F403
from paddle_tpu_torch.ops.metric_ops import *  # noqa: F401,F403
from paddle_tpu_torch.ops.misc import *  # noqa: F401,F403
from paddle_tpu_torch.ops.nn import *  # noqa: F401,F403
from paddle_tpu_torch.ops.quantize import *  # noqa: F401,F403
from paddle_tpu_torch.ops.random_ops import *  # noqa: F401,F403
from paddle_tpu_torch.ops.reduce import *  # noqa: F401,F403
from paddle_tpu_torch.ops.rnn import *  # noqa: F401,F403
from paddle_tpu_torch.ops.selected_rows import *  # noqa: F401,F403
from paddle_tpu_torch.ops.sequence import *  # noqa: F401,F403
from paddle_tpu_torch.ops.tensor_array import *  # noqa: F401,F403
from paddle_tpu_torch.ops.tensor_ops import *  # noqa: F401,F403
from paddle_tpu_torch.ops import (  # noqa: F401
    activation, aliases, control_flow, crf, ctc, detection, loss, math,
    metric_ops, misc, nn, quantize, random_ops, reduce, rnn, selected_rows,
    sequence, tensor_array, tensor_ops,
)

__all__ = (activation.__all__ + aliases.__all__ + control_flow.__all__
           + crf.__all__
           + ctc.__all__ + detection.__all__ + loss.__all__ + math.__all__
           + metric_ops.__all__ + misc.__all__ + nn.__all__
           + quantize.__all__ + random_ops.__all__ + reduce.__all__ + rnn.__all__
           + selected_rows.__all__ + sequence.__all__ + tensor_array.__all__
           + tensor_ops.__all__)
