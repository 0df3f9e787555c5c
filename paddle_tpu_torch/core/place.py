"""Places: the port of ``paddle_tpu/core/place.py``.

A place names a device: :class:`CPUPlace` the host, ``CUDAPlace(i)`` card
``i``. Where the JAX package's CUDAPlace is its TPU place, the port's is a
CUDA device. ``place_device(None)`` is the card (``resolve_device``), or
``NoCudaDeviceError`` on a machine without one: nothing falls back to the
CPU unless the caller asks for ``CPUPlace()``.
"""

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "place_device"]


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


def place_device(place=None):
    """The torch device of ``place``: a Place, a torch device or its name,
    or None for the default device (the card, or NoCudaDeviceError)."""
    if isinstance(place, Place):
        return place.device()
    from paddle_tpu_torch import resolve_device
    return resolve_device(place)
