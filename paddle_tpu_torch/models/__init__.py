"""Models of the port."""

from paddle_tpu_torch.models import bert, resnet, se_resnext, vgg  # noqa: F401

__all__ = ["bert", "resnet", "se_resnext", "vgg"]
