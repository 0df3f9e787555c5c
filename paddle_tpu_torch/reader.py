"""Reader decorators: composable Python data pipelines; the port's copy of
``paddle_tpu/reader.py`` (which imports no JAX: the port keeps its own).

Parity: python/paddle/reader/decorator.py (map_readers, shuffle:82,
chain, compose, buffered:196, firstn, xmap_readers:267,
multiprocess_reader:360) and fluid.io.cache. A reader is a zero-arg
callable returning an iterator; decorators wrap readers, with the
reference's contract, so user data code ports directly. Samples stay host
data (numpy, Python values): a batch reaches the card through a
``py_reader``'s staging or an Executor feed.
"""

import itertools
import queue
import random as pyrandom
import threading

__all__ = [
    "map_readers", "shuffle", "chain", "compose", "buffered", "firstn",
    "xmap_readers", "cache", "multiprocess_reader",
    "ComposeNotAligned", "PipeReader", "Fake", "bucketed_batch",
]


class ComposeNotAligned(ValueError):
    """compose() inputs ended at different lengths with
    check_alignment=True (ref: python/paddle/reader/decorator.py)."""


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size, seed=None):
    """Buffered shuffle. ``seed`` gives a private, reproducible RNG so
    workers can decorrelate deterministically; default keeps the
    reference's behavior (process-global random module,
    python/paddle/reader/decorator.py shuffle)."""
    rng = pyrandom.Random(seed) if seed is not None else pyrandom

    def shuffled():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rng.shuffle(buf)
            yield from buf
    return shuffled


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()
    return reader


def compose(*readers, check_alignment=True):
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        _end = object()           # sentinel: None is a legal sample value
        if not check_alignment:
            for outputs in itertools.zip_longest(*rs, fillvalue=_end):
                yield sum((make_tuple(o) for o in outputs
                           if o is not _end), ())
            return
        for outputs in itertools.zip_longest(*rs, fillvalue=_end):
            if any(o is _end for o in outputs):
                raise ComposeNotAligned(
                    "readers have different lengths")
            yield sum((make_tuple(o) for o in outputs), ())
    return reader


def buffered(reader, size):
    """Background-thread prefetch (decorator.py:196)."""
    class _End:
        pass

    def buffered_reader():
        q = queue.Queue(maxsize=size)

        def worker():
            try:
                for d in reader():
                    q.put(d)
            finally:
                q.put(_End)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e
    return buffered_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                break
            yield item
    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size,
                 order=False):
    """Parallel map over a reader with worker threads (decorator.py:267)."""
    end = object()

    def xreader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feeder():
            for i, d in enumerate(reader()):
                in_q.put((i, d))
            for _ in range(process_num):
                in_q.put(end)

        results = {}
        lock = threading.Lock()

        def worker():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, d = item
                out_q.put((i, mapper(d)))

        threading.Thread(target=feeder, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=worker, daemon=True).start()

        finished = 0
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            if not order:
                yield item[1]
            else:
                with lock:
                    results[item[0]] = item[1]
                while next_idx in results:
                    yield results.pop(next_idx)
                    next_idx += 1
        if order:
            while next_idx in results:
                yield results.pop(next_idx)
                next_idx += 1
    return xreader


def cache(reader):
    all_data = []
    cached = [False]

    def cache_reader():
        if not cached[0]:
            for d in reader():
                all_data.append(d)
                yield d
            cached[0] = True
        else:
            yield from all_data
    return cache_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Thread-based equivalent (TPU hosts favor threads feeding the
    device; the reference forks processes to dodge the GIL for python
    decoding — heavy decode belongs in the native pipeline instead)."""
    return chain(*readers) if len(readers) == 1 else _interleave(readers)


def _interleave(readers):
    def reader():
        its = [r() for r in readers]
        while its:
            nxt = []
            for it in its:
                try:
                    yield next(it)
                    nxt.append(it)
                except StopIteration:
                    pass
            its = nxt
    return reader


class PipeReader:
    """Stream records from a shell command's stdout (the reference reads
    HDFS cat pipes this way; ref python/paddle/reader/decorator.py
    PipeReader)."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        if not isinstance(command, str):
            raise TypeError("command must be a string")
        if file_type not in ("plain", "gzip"):
            raise TypeError(f"file_type must be plain or gzip, "
                            f"got {file_type!r}")
        self.command = command
        self.bufsize = bufsize
        self.file_type = file_type

    def get_line(self, cut_lines=True, line_break="\n"):
        import subprocess
        proc = subprocess.Popen(self.command, shell=True,
                                stdout=subprocess.PIPE)
        try:
            if self.file_type == "gzip":
                import zlib

                def new_decomp():
                    return zlib.decompressobj(32 + zlib.MAX_WBITS)
                decomp = new_decomp()

                def inflate(chunk):
                    # `hadoop fs -cat dir/*.gz` concatenates gzip
                    # MEMBERS: restart a decompressor on each member's
                    # trailing bytes or all shards after the first are
                    # silently dropped
                    nonlocal decomp
                    out = b""
                    while chunk:
                        out += decomp.decompress(chunk)
                        if not decomp.eof:
                            break
                        chunk = decomp.unused_data
                        decomp = new_decomp()
                    return out
            remained = b""
            while True:
                buf = proc.stdout.read(self.bufsize)
                if not buf:
                    break
                if self.file_type == "gzip":
                    buf = inflate(buf)
                if not cut_lines:
                    yield buf
                    continue
                buf = remained + buf
                lines = buf.split(line_break.encode())
                remained = lines.pop()
                for ln in lines:
                    yield ln.decode("utf-8", "replace")
            if cut_lines and remained:
                yield remained.decode("utf-8", "replace")
        finally:
            proc.stdout.close()
            rc = proc.wait()
            if rc != 0:
                raise RuntimeError(
                    f"PipeReader command failed (exit {rc}): "
                    f"{self.command}")


class Fake:
    """Caches the first batch of the decorated reader and replays it
    forever — the reference's IO-free benchmarking reader (ref
    decorator.py Fake)."""

    def __init__(self):
        self.data = None

    def __call__(self, reader, length):
        def fake_reader():
            if self.data is None:
                _empty = object()
                first = next(reader(), _empty)   # PEP 479: no bare next
                if first is _empty:
                    raise ValueError(
                        "Fake: decorated reader yielded no samples")
                self.data = first
            for _ in range(length):
                yield self.data
        return fake_reader


def bucketed_batch(reader, bucket_boundaries, batch_size, pad_value=0,
                   length_fn=None, drop_last=False, ragged_fields=None):
    """Bucketing-by-length — the TPU-native mitigation for LoD's
    "no padding" efficiency claim (SURVEY §7 hard part; core/lod.py
    points here). Samples are grouped into buckets by sequence length
    and every batch is padded to its BUCKET BOUNDARY, not the batch
    max, so under jit the shape set stays small and quantized:
    one shape per bucket, plus — for lengths beyond the last
    boundary — one shape per multiple of the last boundary actually
    observed, plus (when drop_last=False) the tail batches' ragged
    leading dims. With drop_last=True and lengths within the
    boundaries the count is exactly len(bucket_boundaries).

    reader: yields sample tuples of arrays. ragged_fields names the
    field indices to pad; when None the classification is inferred
    from the FIRST assembled batch (a field whose leading dim tracks
    the length in every sample) and then held fixed for the whole
    stream, so shapes never flip mid-epoch — pass ragged_fields
    explicitly when a fixed-size field's size could coincide with all
    lengths of the first batch.
    length_fn: sample -> int (default: len of the first field).

    Yields (fields..., lengths) — each padded field [B, boundary, ...],
    lengths [B] int32 (RaggedBatch(field, lengths) reassembles LoD
    semantics downstream).
    """
    import numpy as np
    bounds = sorted(int(b) for b in bucket_boundaries)
    if not bounds:
        raise ValueError("bucket_boundaries must be non-empty")
    lf = length_fn or (lambda s: len(s[0]))
    ragged_set = set(ragged_fields) if ragged_fields is not None else None

    def classify(buf):
        # sticky auto-classification from the first assembled batch:
        # a field is length-like if it tracks the length in EVERY
        # sample; held fixed afterwards so shapes never flip mid-epoch
        nonlocal ragged_set
        ragged_set = set()
        for i in range(len(buf[0][1])):
            fields = [np.asarray(s[i]) for _, s in buf]
            if all(f.ndim >= 1 and f.shape[0] == l
                   for f, (l, _) in zip(fields, buf)):
                ragged_set.add(i)

    def pad_batch(buf, boundary):
        n_fields = len(buf[0][1])
        lengths = np.array([l for l, _ in buf], np.int32)
        if ragged_set is None:
            classify(buf)
        out = []
        for i in range(n_fields):
            fields = [np.asarray(s[i]) for _, s in buf]
            if i in ragged_set:
                tail = fields[0].shape[1:]
                arr = np.full((len(buf), boundary) + tail, pad_value,
                              fields[0].dtype)
                for j, (l, _) in enumerate(buf):
                    arr[j, :l] = fields[j][:boundary]
                out.append(arr)
            else:
                out.append(np.stack(fields))
        out.append(lengths)
        return tuple(out)

    def overflow_boundary(buf):
        m = max(l for l, _ in buf)
        q = bounds[-1]
        return ((m + q - 1) // q) * q            # quantized shape set

    def bucketed():
        buckets = {}                     # boundary -> [(len, sample)]
        overflow = []
        for sample in reader():
            if not isinstance(sample, tuple):
                sample = (sample,)
            n = int(lf(sample))
            b = next((bd for bd in bounds if n <= bd), None)
            if b is None:
                overflow.append((n, sample))
                if len(overflow) == batch_size:
                    yield pad_batch(overflow, overflow_boundary(overflow))
                    overflow = []
                continue
            buf = buckets.setdefault(b, [])
            buf.append((n, sample))
            if len(buf) == batch_size:
                yield pad_batch(buf, b)
                buckets[b] = []
        if not drop_last:
            for b, buf in sorted(buckets.items()):
                if buf:
                    yield pad_batch(buf, b)
            if overflow:
                yield pad_batch(overflow, overflow_boundary(overflow))
    return bucketed
