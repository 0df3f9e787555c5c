"""Models of the port."""

from paddle_tpu_torch.models import (  # noqa: F401
    bert, deepfm, resnet, se_resnext, transformer, vgg,
)

__all__ = ["bert", "deepfm", "resnet", "se_resnext", "transformer", "vgg"]
