"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package of its own beside ``paddle_tpu``: it imports ``torch`` and never
``jax`` nor anything of ``paddle_tpu``. Every Pallas kernel of the JAX
package on a ported path becomes a hand-written CUDA kernel for ``sm_90a``
under ``ops/kernels/`` (built with ``nvcc`` on first use), with a plain
PyTorch version beside it that CPU tensors take.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, or ``CPUPlace()`` for an Executor); on a machine without
a card, asking for the default device raises :class:`NoCudaDeviceError`
rather than falling back.

The package root carries the Fluid surface of the static path (``Program``,
``program_guard``, ``data``, ``layers``, ``optimizer``, ``Executor``, ...),
so a fluid script runs with ``import paddle_tpu_torch as pt``, and the
module context of the eager path (``nn``) with the ragged-batch helpers
(``create_lod_tensor``).
"""

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet, enforce, enforce_eq

__version__ = "0.1.0"

__all__ = ["__version__", "NoCudaDeviceError", "default_device",
           "resolve_device", "layers", "optimizer", "initializer", "static",
           "io", "regularizer", "clip", "nets", "nn", "lod_tensor",
           "create_lod_tensor", "create_random_int_lodtensor",
           "Program", "program_guard", "default_main_program",
           "default_startup_program", "enable_static", "disable_static",
           "data", "Executor", "Scope", "global_scope", "scope_guard",
           "CPUPlace", "CUDAPlace", "ParamAttr", "unique_name",
           "CompiledProgram", "BuildStrategy", "get_flag", "set_flags",
           "append_backward", "backward", "dataio", "reader", "DataFeeder",
           "batch", "Variable", "enforce", "enforce_eq", "inference",
           "distributed", "monitor"]


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


# the Fluid surface (after the definitions above, which its modules import)
from paddle_tpu_torch import initializer, layers, optimizer, static  # noqa: E402,F401,I001
from paddle_tpu_torch import clip, regularizer  # noqa: E402,F401
from paddle_tpu_torch import io, lod_tensor, nets, nn  # noqa: E402,F401
from paddle_tpu_torch import backward, dataio, reader  # noqa: E402,F401
from paddle_tpu_torch.dataio.feeder import DataFeeder  # noqa: E402
from paddle_tpu_torch.io import batch  # noqa: E402
from paddle_tpu_torch.core.flags import get_flag, set_flags  # noqa: E402
from paddle_tpu_torch.core.place import CPUPlace, CUDAPlace  # noqa: E402
from paddle_tpu_torch.framework import ParamAttr, unique_name  # noqa: E402
from paddle_tpu_torch.lod_tensor import (  # noqa: E402
    create_lod_tensor, create_random_int_lodtensor,
)
from paddle_tpu_torch.static import (  # noqa: E402
    BuildStrategy, CompiledProgram, Executor, Program, Scope, Variable,
    append_backward, data, default_main_program, default_startup_program,
    disable_static, enable_static, global_scope, program_guard, scope_guard,
)
# bound on the root as the JAX package's imports bind them
from paddle_tpu_torch import distributed, inference, monitor  # noqa: E402,F401
