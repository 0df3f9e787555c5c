"""The data path's native (C++) runtime: RecordIO, the threaded sharded
reader and the MultiSlot batcher; the port of the data-path half of
``paddle_tpu/native/__init__.py`` (lines 28-258, 270-500, 542-582,
745-800).

The sources under ``native/src`` are this package's own copies of the
JAX package's ``recordio.cc``, ``data_pipeline.cc``, ``strings.cc``,
``batcher.cc`` and ``enforce.h``: the same record format, record order,
cursor arithmetic and error texts, so a file or a cursor written by one
package reads in the other. They are built on first use with ``g++
-std=c++17 -O2 -pthread -fPIC -shared ... -lz`` into
``paddle_tpu_torch/_build/libpt_native_<fingerprint>.so``, or into the
directory of ``core.compile_cache`` when it is enabled (the fingerprint
covers the sources and the platform; concurrent build processes each write a tmp
file of their own and ``os.replace`` it; a library found counts as a cache
hit, one built as a miss) and bound with
ctypes. ``available()`` says whether the library built; the callers that
have a pure-Python path take it only when asked to (``native=None`` or
False), and ``native=True`` raises.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_SOURCES = ["recordio.cc", "data_pipeline.cc", "strings.cc", "batcher.cc"]
_lock = threading.Lock()
_lib = None
_build_error = None

__all__ = ["available", "get_lib", "RecordIOWriter", "RecordIOScanner",
           "NativeLoader", "NativeBatcher", "parse_multislot"]


def _src_fingerprint():
    h = hashlib.sha256()
    # the platform too: one checkout shared by two hosts of another ABI
    # must not load the other's library
    h.update(f"{os.uname().sysname}-{platform.machine()}".encode())
    for s in _SOURCES + ["enforce.h"]:
        with open(os.path.join(_SRC_DIR, s), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(srcs, out):
    """g++ into a tmp file of this process, then ``os.replace``: builders
    in several processes never interleave their writes; the compiler's
    diagnostics go into the raised error."""
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-std=c++17", "-O2", "-pthread", "-fPIC", "-shared",
           *srcs, "-lz", "-o", tmp]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({r.returncode}) for {os.path.basename(out)}:\n"
            f"{r.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


def _build():
    from paddle_tpu_torch.core import compile_cache
    d = compile_cache.build_dir(_BUILD_DIR)
    os.makedirs(d, exist_ok=True)
    so = os.path.join(d, f"libpt_native_{_src_fingerprint()}.so")
    if os.path.exists(so):
        compile_cache.record(hit=True)
    else:
        _compile([os.path.join(_SRC_DIR, s) for s in _SOURCES], so)
        compile_cache.record(hit=False)
    return so


def _bind(lib):
    c_char_p, c_void_p, c_int, c_long = (ctypes.c_char_p, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_long)
    c_long_p = ctypes.POINTER(c_long)
    c_ubyte_p = ctypes.POINTER(ctypes.c_ubyte)
    lib.pt_last_error.restype = c_char_p
    lib.pt_last_error.argtypes = []
    lib.pt_recordio_writer_open.restype = c_void_p
    lib.pt_recordio_writer_open.argtypes = [c_char_p, c_int, c_int, c_long]
    lib.pt_recordio_write.restype = c_int
    lib.pt_recordio_write.argtypes = [c_void_p, c_char_p, c_long]
    lib.pt_recordio_writer_close.restype = c_int
    lib.pt_recordio_writer_close.argtypes = [c_void_p]
    lib.pt_recordio_scanner_open.restype = c_void_p
    lib.pt_recordio_scanner_open.argtypes = [c_char_p]
    lib.pt_recordio_next.restype = c_void_p     # copied with string_at
    lib.pt_recordio_next.argtypes = [c_void_p, c_long_p]
    lib.pt_recordio_scanner_close.restype = None
    lib.pt_recordio_scanner_close.argtypes = [c_void_p]
    lib.pt_loader_create.restype = c_void_p
    lib.pt_loader_create.argtypes = [ctypes.POINTER(c_char_p), c_int, c_int,
                                     c_long, c_long, c_long, c_int, c_int]
    lib.pt_loader_next.restype = c_void_p
    lib.pt_loader_next.argtypes = [c_void_p, c_long_p]
    lib.pt_loader_restore.restype = c_int
    lib.pt_loader_restore.argtypes = [c_void_p, c_long_p, c_long_p,
                                      c_ubyte_p, c_int, c_long, c_long,
                                      c_long]
    lib.pt_loader_state.restype = None
    lib.pt_loader_state.argtypes = [c_void_p, c_long_p, c_long_p, c_ubyte_p,
                                    c_long_p, c_long_p, c_long_p]
    lib.pt_loader_read.restype = c_long
    lib.pt_loader_read.argtypes = [c_void_p, c_long, c_void_p, c_long,
                                   c_long_p, c_int]
    lib.pt_loader_queue_size.restype = c_long
    lib.pt_loader_queue_size.argtypes = [c_void_p]
    lib.pt_loader_error.restype = c_char_p
    lib.pt_loader_error.argtypes = [c_void_p]
    lib.pt_loader_close.restype = None
    lib.pt_loader_close.argtypes = [c_void_p]
    lib.pt_parse_multislot.restype = c_long
    lib.pt_parse_multislot.argtypes = [
        c_char_p, c_long, c_long, ctypes.POINTER(ctypes.c_byte),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_longlong),
        c_long, c_long_p]
    lib.pt_batcher_create.restype = c_void_p
    lib.pt_batcher_create.argtypes = [
        ctypes.POINTER(c_char_p), c_int, c_int, c_int, c_long, c_long,
        c_long, c_int, c_int, ctypes.POINTER(ctypes.c_byte), c_int,
        c_long, c_int]
    lib.pt_batcher_next.restype = c_long
    lib.pt_batcher_next.argtypes = [c_void_p, c_long_p, c_long_p]
    lib.pt_batcher_fill.restype = c_int
    lib.pt_batcher_fill.argtypes = [c_void_p, c_int, c_void_p]
    lib.pt_batcher_error.restype = c_char_p
    lib.pt_batcher_error.argtypes = [c_void_p]
    lib.pt_batcher_close.restype = None
    lib.pt_batcher_close.argtypes = [c_void_p]
    return lib


def get_lib():
    """Build (once) and return the native library, or raise
    ``RuntimeError`` naming what failed."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise _build_error
        try:
            _lib = _bind(ctypes.CDLL(_build()))
        except OSError:
            # a library left by another host of another ABI: rebuild once
            try:
                so = _build()
                os.remove(so)
                _lib = _bind(ctypes.CDLL(_build()))
            except Exception as e:
                _build_error = RuntimeError(f"native build failed: {e}")
                raise _build_error from e
        except Exception as e:      # no toolchain, or the build failed
            _build_error = RuntimeError(f"native build failed: {e}")
            raise _build_error from e
        return _lib


def available():
    try:
        get_lib()
        return True
    except RuntimeError:
        return False


def _last_error(lib):
    return lib.pt_last_error().decode("utf-8", "replace")


class RecordIOWriter:
    """Chunked, CRC32-checked record file writer (ref capability:
    paddle/fluid/recordio/writer.cc; python recordio_writer.py);
    ``compress`` deflates each chunk with zlib."""

    def __init__(self, path, compress=False, max_chunk_records=1000,
                 max_chunk_bytes=1 << 20):
        self._lib = get_lib()
        self._h = self._lib.pt_recordio_writer_open(
            os.fsencode(path), 1 if compress else 0, max_chunk_records,
            max_chunk_bytes)
        if not self._h:
            raise IOError(_last_error(self._lib))

    def write(self, record: bytes):
        if self._h is None:
            raise ValueError("writer closed")
        if self._lib.pt_recordio_write(self._h, record, len(record)) != 0:
            raise IOError(_last_error(self._lib))

    def close(self):
        if self._h is not None:
            rc = self._lib.pt_recordio_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError(_last_error(self._lib))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordIOScanner:
    """Iterates the records of a RecordIO file; a CRC failure raises
    ``IOError``."""

    def __init__(self, path):
        self._lib = get_lib()
        self._h = self._lib.pt_recordio_scanner_open(os.fsencode(path))
        if not self._h:
            raise IOError(_last_error(self._lib))

    def __iter__(self):
        return self

    def __next__(self):
        n = ctypes.c_long()
        p = self._lib.pt_recordio_next(self._h, ctypes.byref(n))
        if n.value == -1:
            raise StopIteration
        if n.value == -2:
            raise IOError(_last_error(self._lib))
        return ctypes.string_at(p, n.value)

    def close(self):
        if self._h is not None:
            self._lib.pt_recordio_scanner_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class NativeLoader:
    """Threaded sharded file reader: per-file shards -> per-shard ordered
    queues -> deterministic round-robin merge.

    mode "lines" streams newline-delimited text records, "recordio"
    RecordIO records; ``epochs=-1`` cycles forever. The record order is
    bit-identical to the pure-Python oracle
    (``dataio.dataloader._PyRecordReader``): ``nthreads`` is a pure
    throughput knob. ``state()`` is the sharded cursor (state version 2)
    after the records handed out so far, read-ahead excluded;
    ``start_state=`` resumes exactly there. ``read_records(n)`` pulls up
    to n records in one ctypes crossing, the batch path of
    ``FileDataLoader``.
    """

    def __init__(self, files, nthreads=2, queue_capacity=4096,
                 shuffle_buffer=0, seed=0, epochs=1, mode="lines",
                 start_state=None):
        self._lib = get_lib()
        self._mode = mode
        self.files = [os.fspath(f) for f in files]
        self.seed = seed
        self.shuffle_buffer = shuffle_buffer
        self.epochs = epochs

        # the stream's identity in state(), as the oracle writes it; a
        # missing file raises IOError when read, not here
        def fp(f):
            try:
                return [os.path.basename(f), os.path.getsize(f)]
            except OSError:
                return [os.path.basename(f), -1]
        self._files_fp = [fp(f) for f in self.files]
        enc = [os.fsencode(f) for f in self.files]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        self._h = self._lib.pt_loader_create(
            arr, len(enc), nthreads, queue_capacity, shuffle_buffer, seed,
            epochs, {"lines": 0, "recordio": 1}[mode])
        if not self._h:
            raise IOError(_last_error(self._lib))
        self._nshards = len(enc)
        self._buf = ctypes.create_string_buffer(1 << 20)
        self._lens = (ctypes.c_long * 4096)()
        # state() scratch, made once: a snapshot rides every delivered
        # batch on the stateful path
        n = self._nshards
        self._st = ((ctypes.c_long * n)(), (ctypes.c_long * n)(),
                    (ctypes.c_ubyte * n)(), ctypes.c_long(),
                    ctypes.c_long(), ctypes.c_long())
        if start_state is not None:
            self._restore(start_state)

    def _restore(self, state):
        if not isinstance(state, dict) or state.get("version") != 2 or \
                len(state.get("shards", ())) != self._nshards:
            raise ValueError(
                f"NativeLoader needs a version-2 sharded cursor with "
                f"{self._nshards} shard(s), got "
                f"{str(state)[:80]!r} — FileDataLoader.set_state "
                f"migrates/validates cursors before they reach here")
        shards = state["shards"]
        offs = (ctypes.c_long * self._nshards)(
            *(int(s["offset"]) for s in shards))
        emitted = (ctypes.c_long * self._nshards)(
            *(int(s["epoch_records"]) for s in shards))
        eof = (ctypes.c_ubyte * self._nshards)(
            *(1 if s.get("eof") else 0 for s in shards))
        rc = self._lib.pt_loader_restore(
            self._h, offs, emitted, eof, self._nshards,
            int(state["epoch"]), int(state.get("rr", 0)),
            int(state["records_consumed"]))
        if rc != 0:
            raise IOError(_last_error(self._lib))

    def state(self):
        """The sharded cursor after the last record handed out: the dict
        the Python oracle gives, so the two readers' cursors are
        interchangeable."""
        n = self._nshards
        offs, emitted, eof, epoch, rr, consumed = self._st
        self._lib.pt_loader_state(self._h, offs, emitted, eof,
                                  ctypes.byref(epoch), ctypes.byref(rr),
                                  ctypes.byref(consumed))
        return {
            "version": 2,
            "epoch": int(epoch.value),
            "rr": int(rr.value),
            "shards": [{"offset": int(offs[i]),
                        "epoch_records": int(emitted[i]),
                        "eof": bool(eof[i])} for i in range(n)],
            "records_consumed": int(consumed.value),
            "seed": self.seed,
            "shuffle_buffer": self.shuffle_buffer,
            "nfiles": n,
            "files": [list(fp) for fp in self._files_fp],
        }

    def read_records(self, n):
        """Up to ``n`` records (fewer only at the end of the stream), one
        ctypes call per up to 4096. In mode 'lines' the C side separates
        the block with newlines (a line record holds none), so one
        ``bytes.split`` cuts it."""
        sep = 1 if self._mode == "lines" else 0
        out = []
        while len(out) < n:
            take = min(n - len(out), len(self._lens))
            nr = self._lib.pt_loader_read(self._h, take, self._buf,
                                          len(self._buf), self._lens, sep)
            if nr == -2:
                raise IOError(self._lib.pt_loader_error(self._h).decode(
                    "utf-8", "replace"))
            if nr == -3:    # the first record outgrew the buffer
                self._buf = ctypes.create_string_buffer(
                    max(int(self._lens[0]) + 1, 2 * len(self._buf)))
                continue
            if nr == 0:
                break
            lens = self._lens[:nr]
            if sep:
                raw = ctypes.string_at(self._buf, sum(lens) + nr)
                out += raw.split(b"\n")[:nr]
            else:
                raw = ctypes.string_at(self._buf, sum(lens))
                off = 0
                for ln in lens:
                    out.append(raw[off:off + ln])
                    off += ln
        return out

    def __iter__(self):
        return self

    def __next__(self):
        n = ctypes.c_long()
        p = self._lib.pt_loader_next(self._h, ctypes.byref(n))
        if n.value == -2:
            raise IOError(self._lib.pt_loader_error(self._h).decode(
                "utf-8", "replace"))
        if n.value < 0:
            raise StopIteration
        return ctypes.string_at(p, n.value)

    def queue_size(self):
        return self._lib.pt_loader_queue_size(self._h)

    def close(self):
        if self._h is not None:
            self._lib.pt_loader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def parse_multislot(line, slots, cap=None):
    """One MultiSlot sample line ('<n> v1 .. vn' per slot) parsed in C.
    ``slots`` is a slot count (all float) or a sequence of dtype strings
    ('int64'/'int32' slots parse exactly with strtoll, never through a
    double). Returns numpy arrays (int64 for int slots, float64
    otherwise); a malformed line raises ``ValueError`` with the Python
    parser's diagnostics."""
    import numpy as np
    lib = get_lib()
    data = line.encode() if isinstance(line, str) else bytes(line)
    dtypes = ["float32"] * slots if isinstance(slots, int) else list(slots)
    n_slots = len(dtypes)
    is_int = np.asarray([1 if d in ("int64", "int32") else 0
                         for d in dtypes], np.int8)
    if cap is None:
        # every value takes at least 2 bytes ("v "): a well-formed line
        # never reaches this bound
        cap = max(16, len(data) // 2 + 8)
    fout = np.empty(cap, np.float64)
    iout = np.empty(cap, np.int64)
    sizes = np.zeros(n_slots, np.int64)
    total = lib.pt_parse_multislot(
        data, len(data), n_slots,
        is_int.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)),
        fout.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        iout.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), cap,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    if total < 0:
        raise ValueError(_last_error(lib))
    res, off = [], 0
    for n, d in zip(sizes, dtypes):
        buf = iout if d in ("int64", "int32") else fout
        res.append(buf[off:off + n].copy())
        off += int(n)
    return res


class NativeBatcher:
    """Threaded read -> C++ MultiSlot parse -> zero-padded batch assembly
    (the MultiSlotDataFeed worker pipeline, data_feed.cc ReadThread +
    PutToFeedVec). Yields {name: numpy array} batches, one ctypes round
    trip per batch plus one fill per slot."""

    def __init__(self, files, slots, batch_size, read_threads=1,
                 parse_threads=2, queue_capacity=4096, shuffle_buffer=0,
                 seed=0, epochs=1, mode="lines", drop_last=True):
        self._lib = get_lib()
        self._h = None
        self.slots = list(slots)             # [(name, dtype string)]
        self._is_int = [1 if dt in ("int64", "int32") else 0
                        for _n, dt in self.slots]
        enc = [os.fsencode(f) for f in files]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        flags = (ctypes.c_byte * len(self._is_int))(*self._is_int)
        self._h = self._lib.pt_batcher_create(
            arr, len(enc), read_threads, parse_threads, queue_capacity,
            shuffle_buffer, seed, epochs,
            {"lines": 0, "recordio": 1}[mode], flags,
            len(self.slots), batch_size, 1 if drop_last else 0)
        if not self._h:
            raise IOError(_last_error(self._lib))

    def __iter__(self):
        return self

    def __next__(self):
        import numpy as np
        if self._h is None:
            raise StopIteration
        rows = ctypes.c_long()
        maxlens = (ctypes.c_long * len(self.slots))()
        rc = self._lib.pt_batcher_next(self._h, ctypes.byref(rows), maxlens)
        if rc == -1:
            raise IOError(self._lib.pt_batcher_error(self._h).decode(
                "utf-8", "replace"))
        if rc == 0:
            raise StopIteration
        batch = {}
        for k, (name, _dt) in enumerate(self.slots):
            dtype = np.int64 if self._is_int[k] else np.float32
            out = np.empty((rows.value, maxlens[k]), dtype)
            self._lib.pt_batcher_fill(self._h, k,
                                      out.ctypes.data_as(ctypes.c_void_p))
            batch[name] = out
        return batch

    def close(self):
        if self._h is not None:
            self._lib.pt_batcher_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):          # joins the threads and frees the C++ side
        try:
            self.close()
        except Exception:
            pass
