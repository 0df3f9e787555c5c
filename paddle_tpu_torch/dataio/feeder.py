"""DataFeeder: samples to batched tensors; the port of
``paddle_tpu/dataio/feeder.py``.

Parity: python/paddle/fluid/data_feeder.py (DataFeeder.feed) and
paddle.batch. A list of sample tuples becomes named dense tensors (a
ragged field a RaggedBatch) on the feeder's place: the card unless the
caller passes ``CPUPlace()``.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.lod import RaggedBatch
from paddle_tpu_torch.core.place import place_device

__all__ = ["DataFeeder", "batch_reader"]


def batch_reader(reader, batch_size, drop_last=True):
    """paddle.batch parity."""
    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched


def feed_names_of(feed_list):
    """The names of a feed_list of Variables or strings."""
    return [f if isinstance(f, str) else f.name for f in feed_list]


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_names = feed_names_of(feed_list)
        self.feed_vars = [f for f in feed_list if not isinstance(f, str)]
        self.device = place_device(place)

    def feed(self, iterable):
        """``iterable``: sample tuples aligned with the feed list. Returns
        {name: tensor or RaggedBatch} on the feeder's device (float64
        fields as float32)."""
        cols = list(zip(*iterable))
        out = {}
        for name, col in zip(self.feed_names, cols):
            first = np.asarray(col[0])
            if any(np.asarray(c).shape != first.shape for c in col):
                out[name] = RaggedBatch.from_list(list(col),
                                                  device=self.device)
                continue
            arr = np.stack([np.asarray(c) for c in col])
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            out[name] = torch.from_numpy(arr).to(self.device)
        return out
