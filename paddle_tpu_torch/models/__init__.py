"""Models of the port."""

from paddle_tpu_torch.models import bert  # noqa: F401

__all__ = ["bert"]
