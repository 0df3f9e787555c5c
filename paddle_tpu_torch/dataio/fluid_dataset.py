"""fluid.dataset parity: DatasetFactory / InMemoryDataset / QueueDataset;
the port of ``paddle_tpu/dataio/fluid_dataset.py`` (the same batches,
shuffles, hash partition and exception types).

Parity targets: python/paddle/fluid/dataset.py (DatasetFactory,
InMemoryDataset.load_into_memory/local_shuffle/global_shuffle,
QueueDataset), the C++ Dataset/DataFeed pair (framework/data_set.h:40,
data_feed.h:62, MultiSlotDataFeed parsing) and the §3.4
train_from_dataset call stack.

File reading/shuffling runs in the native C++ pipeline
(``paddle_tpu_torch.native``, data_pipeline.cc — the reference's DataFeed
thread pool); parsed samples batch into dense padded numpy arrays (LoD →
padding) and feed the same program the feed/fetch path runs — the
per-thread hogwild loop (hogwild_worker.cc) collapses into batched
device steps (``Executor.train_from_dataset``).
global_shuffle redistributes samples ACROSS trainer processes over the
wire protocol when the fleet has trainer endpoints (the
Dataset::GlobalShuffle trainer-to-trainer exchange,
dataio/sample_exchange.py), and hash-partitions locally otherwise.
"""

import logging

import numpy as np

from paddle_tpu_torch.core.dtypes import dtype_name
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.dataio.dataloader import _py_record_iter
from paddle_tpu_torch import native as _native

__all__ = ["DatasetFactory", "InMemoryDataset", "QueueDataset"]


def _parse_multislot(line, slots):
    """MultiSlotDataFeed line format (data_feed.cc CheckFile): for each
    slot, '<n> v1 ... vn' space-separated; dtype from the slot's var.
    Parses through the native C parser when the toolchain is up
    (native/src/strings.cc pt_parse_multislot — the reference parses in
    C++ too); pure-Python fallback below keeps identical semantics."""
    if _native.available():
        try:
            arrs = _native.parse_multislot(line, [dt for _n, dt in slots])
        except ValueError as e:
            # same exception type as the fallback's enforce() so callers
            # can catch malformed lines identically on both paths
            enforce(False, str(e))
        return [a if dt in ("int64", "int32") else a.astype(np.float32)
                for a, (_n, dt) in zip(arrs, slots)]
    toks = line.split()
    out = []
    i = 0
    for name, dtype in slots:
        enforce(i < len(toks), f"multislot line truncated at slot {name}")
        try:
            n = int(toks[i])
        except ValueError:
            n = -1
        enforce(n >= 0, f"multislot: bad count at slot {name}")
        i += 1
        vals = toks[i:i + n]
        enforce(len(vals) == n,
                f"multislot line truncated inside slot {name}: "
                f"declared {n} values, found {len(vals)}")
        i += n
        # same exception type (EnforceNotMet) as the native path for bad
        # values, so callers can catch malformed lines identically
        try:
            if dtype in ("int64", "int32"):
                out.append(np.asarray([int(v) for v in vals], np.int64))
            else:
                out.append(np.asarray([float(v) for v in vals],
                                      np.float32))
        except ValueError:
            enforce(False, f"multislot: bad value in slot {name}")
    return out


def _pad_batch(samples, slots):
    """Batch per-sample ragged slot arrays into dense padded [B, L] (or
    [B, L] float) — the LoD→padding translation (SURVEY §7)."""
    batch = {}
    for si, (name, dtype) in enumerate(slots):
        arrs = [s[si] for s in samples]
        maxlen = max(a.size for a in arrs)
        if all(a.size == maxlen for a in arrs):
            batch[name] = np.stack(arrs)
        else:
            out = np.zeros((len(arrs), maxlen), arrs[0].dtype)
            for r, a in enumerate(arrs):
                out[r, :a.size] = a
            batch[name] = out
    return batch


class _DatasetBase:
    def __init__(self):
        self.filelist = []
        self.batch_size = 1
        self.thread_num = 1
        self.slots = []               # [(var_name, dtype_str)]
        self._parse_fn = None
        self.drop_last = True

    # -- fluid.dataset configuration surface --------------------------------
    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self.thread_num = int(thread_num)

    def set_use_var(self, var_list):
        slots = []
        for v in var_list:
            if isinstance(v, tuple):          # (name, dtype) pairs
                slots.append((v[0], str(v[1])))
            elif isinstance(v, str):
                slots.append((v, "float32"))
            else:                             # Variable
                slots.append(
                    (v.name, dtype_name(getattr(v, "dtype", "float32"))))
        self.slots = slots

    def set_pipe_command(self, cmd):
        """The reference pipes lines through a shell command
        (data_feed.py pipe_command); here a Python callable
        line -> list[np.ndarray] plays that role. Strings are accepted
        and ignored (parsing falls back to MultiSlot)."""
        if callable(cmd):
            self._parse_fn = cmd

    def _parse(self, line):
        if isinstance(line, bytes):
            line = line.decode("utf-8", "replace")
        if self._parse_fn is not None:
            return self._parse_fn(line)
        return _parse_multislot(line, self.slots)

    def _iter_lines(self):
        """Stream raw lines from the filelist: native threaded reader when
        built (closed even on early consumer exit), else the shared
        pure-python fallback from dataloader.py."""
        enforce(bool(self.filelist), "set_filelist first")
        if _native.available():
            loader = _native.NativeLoader(self.filelist,
                                          nthreads=self.thread_num)
            try:
                yield from loader
            finally:
                loader.close()
        else:
            yield from _py_record_iter(self.filelist, epochs=1, mode="lines")

    def _native_batcher(self, batch_size, drop_last):
        """Configured NativeBatcher for this dataset, or None when the
        C++ path is ineligible (custom pipe command / no slots / no
        toolchain). Shared by the streaming iterator and
        load_into_memory so their tuning cannot drift."""
        if not (self._parse_fn is None and self.slots
                and _native.available()):
            return None
        enforce(bool(self.filelist), "set_filelist first")
        return _native.NativeBatcher(
            self.filelist, self.slots, batch_size,
            read_threads=max(self.thread_num // 2, 1),
            parse_threads=self.thread_num, drop_last=drop_last)

    def _native_batches(self, batcher):
        """Iterate a NativeBatcher with the module's exception-parity
        contract: malformed lines raise EnforceNotMet (as the Python
        parse path does), teardown always runs. One wrapper for every
        native consumer so the parity behavior cannot drift."""
        try:
            yield from batcher
        except IOError as e:
            enforce(False, str(e))
        finally:
            batcher.close()

    def _batches_from(self, sample_iter):
        buf = []
        for s in sample_iter:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield _pad_batch(buf, self.slots)
                buf = []
        if buf and not self.drop_last:
            yield _pad_batch(buf, self.slots)


class InMemoryDataset(_DatasetBase):
    """load_into_memory → shuffle → iterate (fluid.dataset.InMemoryDataset).

    Loading streams through the native threaded reader when available.
    """

    def __init__(self):
        super().__init__()
        self._samples = []
        self._trainer_id = 0
        self._trainer_num = 1

    def load_into_memory(self):
        # per-sample parse through the C++ pipeline when possible
        # (batcher with batch_size=1: threaded read + parse, one
        # ctypes call per sample instead of per line + python parse)
        batcher = self._native_batcher(batch_size=1, drop_last=False)
        if batcher is not None:
            names = [n for n, _ in self.slots]
            self._samples = [tuple(b[n][0] for n in names)
                             for b in self._native_batches(batcher)]
            return
        self._samples = [self._parse(ln) for ln in self._iter_lines()
                         if ln.strip()]

    def local_shuffle(self, seed=0):
        np.random.RandomState(seed).shuffle(self._samples)

    def global_shuffle(self, fleet=None, thread_num=None, seed=0,
                       timeout=120.0):
        """Redistribute samples across trainers by content hash, then
        shuffle locally (Dataset::GlobalShuffle data_set.h:82-92).

        With a fleet whose trainers have real endpoints
        (PADDLE_TRAINER_ENDPOINTS, the launcher's contract), samples
        are EXCHANGED over the wire protocol — each trainer ships every
        sample it loaded to the hash-owning trainer and collects its
        own (the reference's trainer-to-trainer SendRequest path in
        data_set.cc GlobalShuffle). Without endpoints (single process /
        pre-partitioned filelists) it falls back to hash-partitioning
        the locally loaded lines, which matches the reference's
        OUTCOME when every trainer loaded the full dataset. The hash
        keys on sample content, not load position — trainers may load
        different filelist partitions, and all of them must agree on
        ownership."""
        endpoints = []
        if fleet is not None:
            self._trainer_id = fleet.worker_index()
            self._trainer_num = fleet.worker_num()
            eps = fleet.worker_endpoints()
            if len(eps) == self._trainer_num and self._trainer_num > 1:
                endpoints = eps
            elif eps and self._trainer_num > 1:
                logging.getLogger(__name__).warning(
                    "global_shuffle: %d trainer endpoints for %d "
                    "workers — falling back to local hash "
                    "partitioning, which DROPS non-owned samples "
                    "(correct only when every trainer loaded the full "
                    "dataset)", len(eps), self._trainer_num)
        if endpoints:
            from paddle_tpu_torch.dataio.sample_exchange import (
                exchange_samples, resolve_exchange_endpoints,
                sample_hash)
            # collective mode's trainer endpoints double as the
            # process group's rendezvous — bind the launcher's
            # dedicated exchange ports instead when wired
            self._samples = exchange_samples(
                self._samples, resolve_exchange_endpoints(endpoints),
                self._trainer_id, timeout=timeout)
            # overlap detection: with DISJOINT per-trainer filelists
            # (the exchange contract, like the reference's split
            # filelists) the post-exchange set has ~no duplicates; a
            # full-filelist-on-every-trainer load arrives n_trainers
            # times over. Only a LARGE duplicate fraction (>1/3) is
            # treated as that misuse and deduplicated with a warning —
            # small duplicate counts are legitimate repeated corpus
            # lines and are kept.
            seen, uniq = set(), []
            for s in self._samples:
                h = sample_hash(s)
                if h not in seen:
                    seen.add(h)
                    uniq.append(s)
            dups = len(self._samples) - len(uniq)
            if dups > len(self._samples) / 3:
                logging.getLogger(__name__).warning(
                    "global_shuffle: dropped %d duplicate samples "
                    "after the exchange (of %d) — trainers appear to "
                    "have loaded overlapping filelists; give each "
                    "trainer a disjoint shard (dataset.common.split / "
                    "cluster_files_reader)", dups, len(self._samples))
                self._samples = uniq
        elif self._trainer_num > 1:
            from paddle_tpu_torch.dataio.sample_exchange import sample_hash
            self._samples = [
                s for s in self._samples
                if sample_hash(s) % self._trainer_num
                == self._trainer_id]
        self.local_shuffle(seed)

    def release_memory(self):
        self._samples = []

    def get_memory_data_size(self):
        return len(self._samples)

    def __iter__(self):
        return self._batches_from(iter(self._samples))


class QueueDataset(_DatasetBase):
    """Streaming dataset: no load phase, files stream through the native
    queue (fluid.dataset.QueueDataset; global_shuffle unsupported there
    too — dataset.py raises)."""

    def local_shuffle(self, seed=0):
        raise RuntimeError("QueueDataset does not support local_shuffle "
                           "(stream mode); use InMemoryDataset")

    def global_shuffle(self, *a, **k):
        raise RuntimeError("QueueDataset does not support global_shuffle; "
                           "use InMemoryDataset")

    def __iter__(self):
        # full C++ pipeline when possible: threaded read + MultiSlot
        # parse + zero-padded batch assembly in native code (the
        # MultiSlotDataFeed worker path, data_feed.cc), one Python call
        # per batch; custom pipe commands keep the Python path
        batcher = self._native_batcher(self.batch_size, self.drop_last)
        if batcher is not None:
            yield from self._native_batches(batcher)
            return
        yield from self._batches_from(
            self._parse(ln) for ln in self._iter_lines() if ln.strip())


class DatasetFactory:
    """fluid.DatasetFactory parity."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")
