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
eager (dygraph) surface: the module context and its Layer classes
(``nn``), ``dygraph``, ``grad``, ``no_grad``, ``to_variable``,
``WeightNormParamAttr``, ``amp``, ``metrics``, ``distributions`` and
``parallel``'s process environment, with the ragged-batch helpers
(``create_lod_tensor``), the observability surface (``monitor``,
``profiler``) and the data path (``dataio``, ``incubate.data_generator``,
``recordio_writer``; ``static.AsyncExecutor``). The dtype constants (``float32`` ... ``uint8``,
``bool_``) are torch dtypes; the place helpers are ``core/place.py``'s;
``flags`` reads the flags by attribute; ``in_dygraph_mode()`` is True
outside static mode.
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
           "distributed", "monitor", "contrib", "float32", "float64",
           "float16", "bfloat16", "int8", "int16", "int32", "int64", "bool_",
           "uint8", "Place", "CUDAPinnedPlace", "TPUPlace", "default_place",
           "is_compiled_with_tpu", "is_compiled_with_cuda", "device_count",
           "set_device", "get_device", "cpu_places", "cuda_places",
           "cuda_pinned_places", "tpu_places", "flags", "ExecutionStrategy",
           "in_dygraph_mode", "grad", "no_grad", "to_variable",
           "WeightNormParamAttr", "dygraph", "amp", "metrics",
           "distributions", "parallel", "profiler", "incubate",
           "recordio_writer"]

float32, float64, float16, bfloat16 = (torch.float32, torch.float64,
                                       torch.float16, torch.bfloat16)
int8, int16, int32, int64 = torch.int8, torch.int16, torch.int32, torch.int64
bool_, uint8 = torch.bool, torch.uint8


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
from paddle_tpu_torch.core.flags import flags, get_flag, set_flags  # noqa: E402,I001
from paddle_tpu_torch.core.place import (  # noqa: E402
    CPUPlace, CUDAPinnedPlace, CUDAPlace, Place, TPUPlace, cpu_places,
    cuda_pinned_places, cuda_places, default_place, device_count,
    get_device, is_compiled_with_cuda, is_compiled_with_tpu, set_device,
    tpu_places,
)
from paddle_tpu_torch.framework import (  # noqa: E402
    ParamAttr, WeightNormParamAttr, grad, no_grad, to_variable, unique_name,
)
from paddle_tpu_torch.lod_tensor import (  # noqa: E402
    create_lod_tensor, create_random_int_lodtensor,
)
from paddle_tpu_torch.static import (  # noqa: E402
    BuildStrategy, CompiledProgram, ExecutionStrategy, Executor, Program,
    Scope, Variable, in_static_mode,
    append_backward, data, default_main_program, default_startup_program,
    disable_static, enable_static, global_scope, program_guard, scope_guard,
)
# bound on the root as the JAX package's imports bind them
from paddle_tpu_torch import distributed, inference, monitor  # noqa: E402,F401
from paddle_tpu_torch import contrib  # noqa: E402,F401
from paddle_tpu_torch import amp, distributions, metrics  # noqa: E402,F401
from paddle_tpu_torch import dygraph, parallel  # noqa: E402,F401
from paddle_tpu_torch import profiler  # noqa: E402,F401
from paddle_tpu_torch import incubate, recordio_writer  # noqa: E402,F401
from paddle_tpu_torch.dataio import dataset  # noqa: E402,F401


def in_dygraph_mode():
    """fluid.in_dygraph_mode parity: True when no static program is being
    built (eager is the default)."""
    return not in_static_mode()
