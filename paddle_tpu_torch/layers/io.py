"""fluid.layers.io: the port of ``paddle_tpu/layers/io.py``.

Parity: python/paddle/fluid/layers/io.py (data, py_reader,
create_py_reader_by_data, double_buffer, batch, shuffle, read_file, load,
open_files, random_data_generator, Preprocessor) over the reference's
reader ops (operators/reader/create_py_reader_op.cc, double_buffer,
shuffle/batch readers; the Preprocessor sub-block).

A reader is a host-side object that yields feed dicts; with double
buffering (the default) a worker thread (``dataio.PyReader``) stages each
batch as CPU tensors, pinned when the batches are for the card, and the
Executor copies them to its device (buffered_reader.cc's role). Two
protocols, as the reference has:

- iterable: ``for feed in reader: exe.run(main, feed=feed)``;
- start/reset: ``reader.start()``, then ``exe.run(main)`` with no feed (the
  Executor pulls the next batch from every started reader attached to the
  program) until ``core.EOFException``; then ``reader.reset()``, which
  closes the iterator and so stops and joins the worker.

``open_files`` reads RecordIO files through the port's native scanner
(``paddle_tpu_torch.native``), ``load`` appends the ``load_combine`` host
op that the Executor runs.
"""

import contextlib

import numpy as np

from paddle_tpu_torch.core.dtypes import convert_dtype, dtype_name
from paddle_tpu_torch.core.enforce import EnforceNotMet, EOFException
from paddle_tpu_torch.framework import unique_name
from paddle_tpu_torch.static.program import (
    Program, data, default_main_program, program_guard,
)

__all__ = [
    "data", "py_reader", "create_py_reader_by_data", "read_file",
    "double_buffer", "batch", "shuffle", "load", "open_files",
    "random_data_generator", "Preprocessor",
]


class _ReaderProtocol:
    """start()/reset() over ``iter(self)``, and the EOF of the non-iterable
    mode."""

    _started = False
    _it = None

    def start(self):
        self.reset()     # close an abandoned iterator (and its worker)
        self._it = iter(self)
        self._started = True

    def reset(self):
        # closing the generator runs the staging loop's finally block,
        # which stops and joins the worker thread
        if self._it is not None and hasattr(self._it, "close"):
            self._it.close()
        self._it = None
        self._started = False

    def _next_feed(self):
        try:
            return next(self._it)
        except StopIteration:
            self._started = False
            raise EOFException(
                "py_reader exhausted — call reader.reset()") from None


class StaticPyReader(_ReaderProtocol):
    """The object ``layers.py_reader`` returns: the program's data vars and
    a host-side source; yields feed dicts."""

    def __init__(self, vars_, capacity, use_double_buffer=True,
                 program=None):
        self.vars = list(vars_)
        self.capacity = capacity
        self.use_double_buffer = use_double_buffer
        self._source = None          # callable -> iterator of feed dicts
        self._places = None
        (program or default_main_program())._py_readers.append(self)

    # -- decoration (fluid PyReader surface) ------------------------------
    def decorate_paddle_reader(self, reader, places=None):
        """``reader`` yields BATCHES as lists of sample tuples (the fluid
        idiom: decorate_paddle_reader(paddle.batch(...)))."""
        names = [v.name for v in self.vars]

        def src():
            from paddle_tpu_torch.core.place import CPUPlace
            from paddle_tpu_torch.dataio.feeder import DataFeeder
            feeder = DataFeeder(names, place=CPUPlace())
            for samples in reader():
                yield feeder.feed(samples)
        self._source, self._places = src, places
        return self

    decorate_sample_list_generator = decorate_paddle_reader

    def decorate_tensor_provider(self, reader, places=None):
        """``reader`` yields tuples of batched arrays. ``places`` None
        stages them for the card."""
        names = [v.name for v in self.vars]

        def src():
            for arrays in reader():
                if not isinstance(arrays, (tuple, list)):
                    arrays = (arrays,)
                yield {n: np.asarray(a) for n, a in zip(names, arrays)}
        self._source, self._places = src, places
        return self

    decorate_batch_generator = decorate_tensor_provider

    def __iter__(self):
        if self._source is None:
            raise EnforceNotMet(
                "py_reader has no data source: call "
                "decorate_paddle_reader / decorate_tensor_provider first")
        if not self.use_double_buffer:
            return iter(self._source())
        from paddle_tpu_torch.dataio.pyreader import PyReader
        r = PyReader(capacity=self.capacity)
        r.decorate_batch_generator(self._source, self._places)
        return iter(r)


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """fluid.layers.py_reader parity: one data var per (shape, dtype), the
    shapes kept verbatim (fluid passes them batch-full); returns the reader
    (``read_file`` gives its vars)."""
    base = name or unique_name.generate("py_reader")
    vars_ = [data(f"{base}_{i}", list(shp), dtype=convert_dtype(dt),
                  append_batch_size=False)
             for i, (shp, dt) in enumerate(zip(shapes, dtypes))]
    return StaticPyReader(vars_, capacity, use_double_buffer)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """fluid.layers.create_py_reader_by_data parity: a py_reader over
    existing data vars."""
    return StaticPyReader(feed_list, capacity, use_double_buffer)


def read_file(reader):
    """fluid.layers.read_file parity: the vars a reader feeds."""
    vars_ = reader.vars
    return vars_[0] if len(vars_) == 1 else list(vars_)


def double_buffer(reader, place=None, name=None):
    """fluid.layers.double_buffer parity: the staging worker thread is the
    double buffer; this turns it on (or buffers a plain reader
    callable)."""
    if isinstance(reader, StaticPyReader):
        reader.use_double_buffer = True
        return reader
    from paddle_tpu_torch import reader as _rdr
    return _rdr.buffered(reader, 2)


class _TransformedReader(_ReaderProtocol):
    """A link of a reader-op chain (batch/shuffle over a py_reader): the
    StaticPyReader surface (``vars``, iteration, start()/reset()) over a
    transformed feed stream, as the reference chains create_batch_reader /
    create_shuffle_reader ops over an underlying reader."""

    def __init__(self, underlying, transform):
        self.underlying = underlying
        self._transform = transform
        default_main_program()._py_readers.append(self)

    @property
    def vars(self):
        return self.underlying.vars

    def __iter__(self):
        return self._transform(iter(self.underlying))


def _stack(feeds):
    return {k: np.stack([np.asarray(f[k]) for f in feeds]) for k in feeds[0]}


def batch(reader, batch_size):
    """fluid.layers.batch parity (create_batch_reader): over a reader
    object, each var's per-record arrays stacked on a batch axis; over a
    plain sample reader callable, a callable yielding lists of sample
    tuples (decorate_paddle_reader's format)."""
    if hasattr(reader, "vars"):
        def transform(feeds):
            buf = []
            for feed in feeds:
                buf.append(feed)
                if len(buf) == batch_size:
                    yield _stack(buf)
                    buf = []
            if buf:
                yield _stack(buf)
        return _TransformedReader(reader, transform)

    def batched():
        buf = []
        for sample in reader():
            buf.append(sample if isinstance(sample, tuple) else (sample,))
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf:
            yield buf
    return batched


def shuffle(reader, buffer_size, seed=None):
    """fluid.layers.shuffle parity (create_shuffle_reader): a buffered
    shuffle over a reader object (numpy's RandomState(seed or 0), the JAX
    package's order) or a plain reader callable (``reader.shuffle``)."""
    if hasattr(reader, "vars"):
        rng = np.random.RandomState(0 if seed is None else seed)

        def transform(feeds):
            buf = []
            for feed in feeds:
                buf.append(feed)
                if len(buf) >= buffer_size:
                    rng.shuffle(buf)
                    while buf:
                        yield buf.pop()
            rng.shuffle(buf)
            while buf:
                yield buf.pop()
        return _TransformedReader(reader, transform)
    from paddle_tpu_torch import reader as _rdr
    return _rdr.shuffle(reader, buffer_size, seed=seed)


def load(out, file_path, load_as_fp16=None):
    """fluid.layers.load parity (load_op.cc): appends a ``load_combine``
    op (``static.io.append_load_op``) writing ``file_path``'s value into
    var ``out`` when the program runs."""
    from paddle_tpu_torch.static.io import append_load_op
    return append_load_op(default_main_program(), [out], file_path)


def open_files(filenames, shapes, dtypes, thread_num=None,
               buffer_size=None, pass_num=1, is_test=None, name=None):
    """fluid.layers.open_files parity (open_files_op): a py_reader fed
    from RecordIO files through the port's native scanner. Each record is
    an ``np.savez`` archive of arrays ``f0..fN`` for the N slots, the
    records ``recordio_writer`` writes in either package."""
    import io as _io
    rdr = py_reader(buffer_size or 64, shapes, dtypes, name=name)

    def source():
        from paddle_tpu_torch import native
        for _ in range(pass_num):
            for path in filenames:
                with native.RecordIOScanner(path) as scan:
                    for rec in scan:
                        with np.load(_io.BytesIO(rec)) as z:
                            yield tuple(z[f"f{i}"]
                                        for i in range(len(shapes)))
    rdr.decorate_tensor_provider(source)
    return rdr


def random_data_generator(low, high, shapes, lod_levels=None,
                          for_parallel=True, seed=None):
    """fluid.layers.random_data_generator parity: a py_reader of uniform
    floats in [low, high) of the given shapes, from numpy's
    RandomState(seed or 0)."""
    rdr = py_reader(8, shapes, ["float32"] * len(shapes))
    rng = np.random.RandomState(0 if seed is None else seed)

    def source():
        while True:
            yield tuple(rng.uniform(low, high, size=s).astype(np.float32)
                        for s in shapes)
    rdr.decorate_tensor_provider(source)
    return rdr


class Preprocessor:
    """fluid.layers.Preprocessor parity: a per-batch transform written as
    a sub-program, run by an Executor on ``place`` (the card by default)
    over each batch before it is fed::

        p = Preprocessor(reader)
        with p.block():
            x, y = p.inputs()
            p.outputs(x / 255., y)
        out_vars = layers.read_file(p)
        for feed in p: exe.run(main, feed=feed)
    """

    def __init__(self, reader, name=None, place=None):
        self.underlying = reader
        self.sub_program = Program()
        self._in_vars = None
        self._out_vars = None
        self.vars = None             # main-program output vars
        self.place = place

    def block(self):
        @contextlib.contextmanager
        def guard():
            with program_guard(self.sub_program, Program()):
                yield
            self._finalize()
        return guard()

    def inputs(self):
        self._in_vars = [
            data(f"_pp_in_{i}", list(v.shape), dtype=dtype_name(v.dtype),
                 append_batch_size=False)
            for i, v in enumerate(self.underlying.vars)]
        return list(self._in_vars)

    def outputs(self, *outs):
        self._out_vars = list(outs)

    def _finalize(self):
        if not self._out_vars:
            raise EnforceNotMet("Preprocessor.block set no outputs()")
        self.vars = [
            data(f"_pp_out_{i}", list(v.shape), dtype=dtype_name(v.dtype),
                 append_batch_size=False)
            for i, v in enumerate(self._out_vars)]

    def __iter__(self):
        from paddle_tpu_torch.static.executor import Executor
        exe = Executor(self.place)
        in_names = [v.name for v in self._in_vars]
        out_names = [v.name for v in self._out_vars]
        new_names = [v.name for v in self.vars]
        for feed in self.underlying:
            vals = list(feed.values()) if isinstance(feed, dict) else feed
            outs = exe.run(self.sub_program,
                           feed=dict(zip(in_names, vals)),
                           fetch_list=out_names, return_numpy=False)
            yield dict(zip(new_names, outs))
