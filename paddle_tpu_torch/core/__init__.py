"""Core helpers of the port (own copies; nothing is imported from paddle_tpu)."""

# fluid.core.EOFException is the reader protocol's loop terminator; users
# catch it as core.EOFException
from paddle_tpu_torch.core.enforce import EnforceNotMet, EOFException  # noqa: F401,E402
