"""PyReader and DataLoader: batches staged by a worker thread; the port of
``paddle_tpu/dataio/pyreader.py``.

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

__all__ = ["PyReader", "DataLoader"]

_END = object()
#: the default queue depth (the JAX package's reader_queue_capacity flag)
_CAPACITY = 64


def _stage_one(v, pin):
    if isinstance(v, (np.ndarray, np.generic, list, int, float)):
        v = torch.from_numpy(np.ascontiguousarray(v))
    if pin and isinstance(v, torch.Tensor) and v.device.type == "cpu":
        v = v.pin_memory()
    return v


def stage(batch, pin):
    """A feed dict's (or a tuple or list batch's) arrays and CPU tensors as
    CPU tensors, pinned with ``pin``; other values (a RaggedBatch) pass
    through."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_stage_one(v, pin) for v in batch)
    return {k: _stage_one(v, pin) for k, v in batch.items()}


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


class DataLoader:
    """fluid.io.DataLoader parity (reader.py's successor to PyReader):
    made by ``from_generator`` or ``from_dataset``, fed by
    ``set_sample_generator`` / ``set_sample_list_generator`` /
    ``set_batch_generator``, iterated for feed batches staged by the
    PyReader's worker (``places`` as PyReader takes them: None is the
    card, pinned host tensors the Executor copies without blocking)."""

    def __init__(self, feed_list=None, capacity=None, iterable=True,
                 return_list=False, use_double_buffer=True):
        if not iterable:
            raise NotImplementedError(
                "DataLoader(iterable=False) (start()/reset() protocol) is "
                "not supported — iterate the loader directly; the executor "
                "has no program-embedded reader ops to drive")
        self._inner = PyReader(feed_list=feed_list, capacity=capacity,
                               iterable=iterable, return_list=return_list)
        self.feed_list = feed_list
        self.return_list = return_list
        self._iter_fn = None

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_generator(feed_list=None, capacity=64, use_double_buffer=True,
                       iterable=True, return_list=False,
                       use_multiprocess=False):
        return DataLoader(feed_list=feed_list, capacity=capacity,
                          iterable=iterable, return_list=return_list,
                          use_double_buffer=use_double_buffer)

    @staticmethod
    def from_dataset(dataset, places=None, drop_last=True):
        """Iterate a fluid dataset (InMemory/Queue) as feed dicts of numpy
        arrays."""
        import copy
        loader = DataLoader()

        def _iter():
            # a shallow copy: the loader's drop_last never changes the
            # caller's dataset
            ds = copy.copy(dataset)
            ds.drop_last = drop_last
            return iter(ds)

        loader._iter_fn = _iter
        return loader

    # -- feeding -----------------------------------------------------------
    def _need_feed_list(self, api):
        if self._iter_fn is not None:
            raise RuntimeError(
                f"{api} on a from_dataset DataLoader: the dataset already "
                f"supplies batches; build one via from_generator instead")
        if self.feed_list is None:
            raise ValueError(
                f"{api} needs the DataLoader built with feed_list= "
                f"(sample tuples are matched to feed names)")

    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        self._need_feed_list("set_sample_generator")
        from paddle_tpu_torch.dataio.feeder import batch_reader
        self._inner.decorate_sample_list_generator(
            batch_reader(reader, batch_size, drop_last=drop_last), places)
        return self

    def set_sample_list_generator(self, reader, places=None):
        self._need_feed_list("set_sample_list_generator")
        self._inner.decorate_sample_list_generator(reader, places)
        return self

    def set_batch_generator(self, reader, places=None):
        if self._iter_fn is not None:
            raise RuntimeError(
                "set_batch_generator on a from_dataset DataLoader: the "
                "dataset already supplies batches; build one via "
                "from_generator instead")
        self._inner.decorate_batch_generator(reader, places)
        return self

    def __iter__(self):
        if self._iter_fn is not None:
            return self._iter_fn()
        it = iter(self._inner)
        if not self.return_list:
            return it
        if self.feed_list is not None:
            from paddle_tpu_torch.dataio.feeder import feed_names_of
            names = feed_names_of(self.feed_list)
            return ([b[n] for n in names] if isinstance(b, dict) else b
                    for b in it)
        # return_list without a feed_list (set_batch_generator): a dict
        # batch flattens in sorted-key order, the JAX package's order
        return ([b[n] for n in sorted(b)] if isinstance(b, dict) else b
                for b in it)
