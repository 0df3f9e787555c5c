"""Places: the port of ``paddle_tpu/core/place.py``.

A place names a device: :class:`CPUPlace` the host, ``CUDAPlace(i)`` card
``i``, :class:`CUDAPinnedPlace` pinned host memory (a CPU place). Where the
JAX package's CUDAPlace is its TPU place, the port's is a CUDA device.
``place_device(None)`` is the card (``resolve_device``), or
``NoCudaDeviceError`` on a machine without one: nothing falls back to the
CPU unless the caller asks for ``CPUPlace()``. The helpers of the JAX
package's root: ``default_place`` and ``get_device`` are the card (or
``NoCudaDeviceError``) unless ``set_device`` chose another place;
``is_compiled_with_tpu`` is False, and ``TPUPlace`` and ``tpu_places``
raise, pointing to ``CUDAPlace`` and ``cuda_places``.
"""

import os

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "place_device", "default_place", "is_compiled_with_tpu",
           "is_compiled_with_cuda", "device_count", "set_device",
           "get_device", "cpu_places", "cuda_places", "cuda_pinned_places",
           "tpu_places"]


class Place:
    """Base device tag."""

    device_type = None

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def device(self):
        return torch.device(self.device_type, self.device_id)


class CPUPlace(Place):
    device_type = "cpu"

    def device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "cuda"


class CUDAPinnedPlace(CPUPlace):
    """Pinned host staging memory: a CPU place."""


class TPUPlace(Place):
    """The JAX package's accelerator place: the port runs on CUDA cards."""

    def __init__(self, device_id=0):
        raise EnforceNotMet(
            "TPUPlace: paddle_tpu_torch runs on NVIDIA GPUs; use "
            f"CUDAPlace({device_id})")


def tpu_places(device_ids=None):
    """Raises: the port has no TPU places (use cuda_places)."""
    raise EnforceNotMet("tpu_places: paddle_tpu_torch runs on NVIDIA GPUs; "
                        "use cuda_places")


def is_compiled_with_tpu():
    return False


def is_compiled_with_cuda():
    """Whether this PyTorch build has CUDA (``torch.version.cuda`` set)."""
    return torch.version.cuda is not None


def device_count():
    """The CUDA cards visible to this process."""
    return torch.cuda.device_count()


def default_place():
    """``CUDAPlace(0)``, or ``NoCudaDeviceError`` without a card."""
    from paddle_tpu_torch import default_device
    default_device()
    return CUDAPlace(0)


_current = {"place": None}


def set_device(device):
    """'gpu', 'cuda', 'cpu', 'gpu:1' (paddle.set_device); returns the
    place that ``get_device`` gives from now on."""
    name, _, idx = device.partition(":")
    if name == "cpu":
        place = CPUPlace(int(idx or 0))
    elif name in ("gpu", "cuda"):
        place = CUDAPlace(int(idx or 0))
    else:
        raise EnforceNotMet(f"set_device({device!r}): the port's devices "
                            "are 'cpu' and 'gpu' (CUDA)")
    _current["place"] = place
    return place


def get_device():
    return _current["place"] or default_place()


def cpu_places(device_count=None):
    """fluid.cpu_places: one CPUPlace per requested device (default
    ``CPU_NUM``, else 1)."""
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace(i) for i in range(n)]


def cuda_places(device_ids=None):
    """fluid.cuda_places: one CUDAPlace per card (default: every visible
    one)."""
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in device_ids]


def cuda_pinned_places(device_count=None):
    """fluid.cuda_pinned_places: pinned host staging places."""
    n = device_count or max(torch.cuda.device_count(), 1)
    return [CUDAPinnedPlace(i) for i in range(n)]


def place_device(place=None):
    """The torch device of ``place``: a Place, a torch device or its name,
    or None for the default device (the card, or NoCudaDeviceError)."""
    if isinstance(place, Place):
        return place.device()
    from paddle_tpu_torch import resolve_device
    return resolve_device(place)
