"""PyReader: batches staged by a worker thread; the port of
``paddle_tpu/dataio/pyreader.py:23-78``.

Parity: python/paddle/fluid/reader.py PyReader:46 over
LoDTensorBlockingQueue (operators/reader/lod_tensor_blocking_queue.h) and
buffered_reader.cc's prefetch. A worker thread converts each batch to CPU
tensors while the step runs, pinned when the batches are for the card
(``places`` None, the default) so the Executor copies them without
blocking; the thread never touches the card's memory. Closing the
iterator (``break``, an exception, ``StaticPyReader.reset``) stops and
joins the worker.
"""

import queue
import threading

import numpy as np
import torch

from paddle_tpu_torch.core.place import place_device

__all__ = ["PyReader"]

_END = object()
#: the default queue depth (the JAX package's reader_queue_capacity flag)
_CAPACITY = 64


def stage(batch, pin):
    """A feed dict's arrays and CPU tensors as CPU tensors, pinned with
    ``pin``; other values (a RaggedBatch) pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, np.generic, list, int, float)):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if pin and isinstance(v, torch.Tensor) and v.device.type == "cpu":
            v = v.pin_memory()
        out[k] = v
    return out


def staging_pinned(places):
    """Whether batches for ``places`` (None: the card, or
    ``NoCudaDeviceError`` without one) are staged in pinned memory."""
    if isinstance(places, (list, tuple)):
        places = places[0] if places else None
    return place_device(places).type == "cuda"


class PyReader:
    def __init__(self, feed_list=None, capacity=None, iterable=True,
                 return_list=False):
        self.capacity = capacity or _CAPACITY
        self.feed_list = feed_list
        self._reader = None
        self._feeder = None
        self._pin = None

    def decorate_sample_list_generator(self, reader, places=None):
        from paddle_tpu_torch.core.place import CPUPlace
        from paddle_tpu_torch.dataio.feeder import DataFeeder
        self._pin = staging_pinned(places)
        self._feeder = DataFeeder(self.feed_list or [], place=CPUPlace())
        self._reader = reader

    def decorate_batch_generator(self, reader, places=None):
        self._pin = staging_pinned(places)
        self._reader = reader
        self._feeder = None

    def __iter__(self):
        q = queue.Queue(maxsize=self.capacity)
        stop = threading.Event()
        pin = self._pin

        def put(item):
            # a bounded wait, so a stopped consumer never leaves the worker
            # blocked on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in self._reader():
                    if stop.is_set():
                        return
                    if self._feeder is not None:
                        batch = self._feeder.feed(batch)
                    if not put(stage(batch, pin)):
                        return
                put(_END)
            except BaseException as e:   # surface reader errors to the
                put(e)                   # consumer, never as a clean end

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is _END:
                    return
                if isinstance(b, BaseException):
                    raise b
                yield b
        finally:
            # the consumer left (end, break, exception, close): stop the
            # worker, wait for it, and drop the batches it staged
            stop.set()
            t.join()
            while not q.empty():
                q.get_nowait()
