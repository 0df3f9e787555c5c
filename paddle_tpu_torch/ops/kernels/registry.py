"""Kernel registry: one home for kernel bodies, selection and launch counts.

The port of ``paddle_tpu/ops/pallas/registry.py``. Each registered kernel
has a plain PyTorch **reference** body and a hand-written CUDA **kernel**
body with one signature. Selection follows the device of the inputs and
nothing else:

- tensors on the CPU take the reference body;
- tensors on a CUDA device take the kernel body, which launches the kernel
  or raises.

There is no flag, environment variable or override that puts the reference
body on a CUDA tensor, and no fallback after a failed build or launch.
:func:`get_body` hands out either body for A/B harnesses (``chip_smoke.py``
compares the two on the card that way).

Each kernel carries an integer launch counter. The kernel body bumps it
through :meth:`Kernel.count_launch` once per launch that CUDA accepted,
so a run can show that its main path went through the kernel.
"""

import contextlib
import threading

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet

__all__ = [
    "Kernel", "register_kernel", "get_kernel", "list_kernels", "get_body",
    "selected_body", "dispatch", "launch_counts", "reset_launch_counts",
    "meta_shapes",
]

_REGISTRY = {}
_lock = threading.Lock()


class Kernel:
    """One registered kernel: a plain PyTorch reference body, a CUDA
    kernel body with the same signature, the kernel's source in the repo,
    the TPU kernel it replaces (file:line) and its launch count."""

    __slots__ = ("name", "reference", "kernel", "source", "replaces",
                 "launches")

    def __init__(self, name, reference, kernel, source, replaces):
        self.name = name
        self.reference = reference
        self.kernel = kernel
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def count_launch(self):
        with _lock:
            self.launches += 1

    def __repr__(self):
        return f"Kernel({self.name!r}, launches={self.launches})"


def register_kernel(name, reference, kernel, source, replaces):
    """Register (or re-register) a kernel; the last registration wins."""
    k = Kernel(name, reference, kernel, source, replaces)
    with _lock:
        _REGISTRY[name] = k
    return k


def get_kernel(name):
    return _REGISTRY[name]


def list_kernels():
    return sorted(_REGISTRY)


def get_body(name, which):
    """Raw body access for A/B harnesses: ``which`` is 'reference' or
    'kernel'."""
    k = _REGISTRY[name]
    if which == "reference":
        return k.reference
    if which == "kernel":
        return k.kernel
    raise EnforceNotMet(
        f"unknown body {which!r} for kernel {name!r}: 'reference' or 'kernel'")


def selected_body(name, device):
    """Which body a dispatch of ``name`` on ``device`` runs: 'reference'
    for the CPU, 'kernel' for CUDA; 'reference' for the ``meta`` device
    only inside :func:`meta_shapes`. Any other device raises."""
    _REGISTRY[name]  # unknown names raise KeyError like get_kernel
    device = torch.device(device)
    if device.type == "cpu" or (device.type == "meta"
                                and getattr(_probe, "on", False)):
        return "reference"
    if device.type == "cuda":
        return "kernel"
    raise EnforceNotMet(
        f"kernel {name!r} has no body for device {device}: the port runs "
        "on 'cuda' (hand-written kernels) or 'cpu' (plain PyTorch)")


_probe = threading.local()


@contextlib.contextmanager
def meta_shapes():
    """Within this block (on this thread), a dispatch on ``meta`` tensors
    runs the plain body, which computes shapes and no values: the port's
    ``jax.eval_shape`` of a whole served function (the serving
    fetch-contract check). Outside it, meta raises as any foreign device
    does."""
    prev = getattr(_probe, "on", False)
    _probe.on = True
    try:
        yield
    finally:
        _probe.on = prev


def dispatch(name, x, *args, **kwargs):
    """Run the body selected by the device of the first tensor ``x``."""
    body = selected_body(name, x.device)
    return get_body(name, body)(x, *args, **kwargs)


def launch_counts():
    """{kernel name: launches so far}."""
    with _lock:
        return {n: k.launches for n, k in sorted(_REGISTRY.items())}


def reset_launch_counts():
    with _lock:
        for k in _REGISTRY.values():
            k.launches = 0
