"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package of its own beside ``paddle_tpu``: it imports ``torch`` and never
``jax`` nor anything of ``paddle_tpu``. Every Pallas kernel of the JAX
package on a ported path becomes a hand-written CUDA kernel for ``sm_90a``
under ``ops/kernels/`` (built with ``nvcc`` on first use), with a plain
PyTorch version beside it that CPU tensors take.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); on a machine without a card, asking for the default
device raises :class:`NoCudaDeviceError` rather than falling back.
"""

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet

__version__ = "0.1.0"

__all__ = ["__version__", "NoCudaDeviceError", "default_device",
           "resolve_device"]


class NoCudaDeviceError(EnforceNotMet):
    """The default device was asked for, and this machine has no CUDA
    card (or this PyTorch build has no CUDA)."""


def default_device():
    """``torch.device("cuda")``, or :class:`NoCudaDeviceError` naming the
    missing card. There is no CPU fallback: pass ``device="cpu"`` to run
    on the CPU."""
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device: paddle_tpu_torch runs on an NVIDIA GPU by "
            f"default (torch {torch.__version__}, CUDA build "
            f"{torch.version.cuda}, torch.cuda.is_available() is False). "
            "Pass device='cpu' to run on the CPU.")
    return torch.device("cuda")


def resolve_device(device=None):
    """``device`` as a ``torch.device``; None means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)
