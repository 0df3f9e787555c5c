"""High-throughput file DataLoader: native threaded readers -> parse ->
batch -> async device prefetch; the port of ``paddle_tpu/dataio/
dataloader.py`` (the record order, the cursors and their checks, the
metrics and the errors are the JAX package's, so a cursor saved by one
package resumes in the other).

The end-to-end role of the reference's Dataset + DataFeed + buffered
reader chain (ref: framework/data_set.h:40, framework/data_feed.h:62,
operators/reader/buffered_reader.cc — threaded file reading, queueing,
and async device transfer double-buffering). Record ingest + shuffle +
queueing run in C++ (``paddle_tpu_torch.native``); parsing/batching run
in a Python worker thread (records are user-format); the device stage
(``Executor.feed_stage``'s, on a side CUDA stream of the worker) copies
batch N+1 to the card while step N runs.

Falls back to a pure-Python file reader when the native toolchain is
unavailable (same iterator contract).

The sharded-cursor contract (record order)
------------------------------------------
Both readers — the multi-threaded native loader and the single-threaded
Python oracle — produce ONE deterministic record order, a pure function
of (files, seed, shuffle_buffer, epochs) and independent of thread
count:

* shard = file. Within a shard, records flow in file byte order,
  optionally decorrelated by a per-shard reservoir of
  ``shuffle_buffer`` records driven by a splitmix64 RNG re-derived per
  ``(seed, shard, epoch)`` (``_ShardRng`` — implemented identically in
  C++).
* the merged stream interleaves shards round-robin (one record per
  live shard per cycle) with an epoch barrier: a shard that finished
  the current epoch parks until every shard has, then the global epoch
  advances and the round-robin resets to shard 0.

``nthreads`` is therefore a pure throughput knob: the native loader's
worker threads own fixed shard sets and feed per-shard ordered queues;
the consumer-side merge is where the deterministic order (and the
cursor) lives. ``_PyRecordReader`` is the conformance oracle — the
native loader must produce bit-identical streams and cursors
(tests/test_torch_dataio.py holds both against the JAX package's).

Exactly-once resume (``stateful=True``): the cursor (state version 2)
is a vector of per-file byte offsets + per-shard emitted counts (the
shuffle-buffer snapshot — a reservoir is replayable from
``(seed, shard, epoch, count)``) plus the global epoch, round-robin
position and consumed total, exposed as ``state()`` / ``set_state()``.
A state snapshot rides with every batch through the prefetch queue and
is committed only when the *consumer* receives that batch, so
read-ahead the process never consumed is not counted; saving
``state()`` in a checkpoint (``auto_checkpoint(data_state=loader)``)
and resuming yields bit-identical batches to an uninterrupted run.
Iterators are cursors into ONE stream: a second ``__iter__`` continues
after the last delivered batch rather than replaying from the restored
snapshot (re-consuming records would break exactly-once silently).
Stateful mode keeps NATIVE throughput when the library is present —
the deterministic merge made the multi-threaded loader resumable;
version-1 cursors (the pre-sharded sequential order) migrate where the
two orders provably coincide (epoch boundaries, or single-file
unshuffled streams) and refuse loudly otherwise.

Data-parallel slicing and topology-elastic resume (``world_size=`` /
``rank=``): every rank runs the SAME deterministic job-level stream
(same files, seed, shuffle) in global batches of ``batch_size`` and
keeps its contiguous row slice of each batch. Because the job-level
record order is a pure function of the data — not of the rank count or
the reader implementation — the per-step global batch is identical at
any world size, the per-rank cursors are positions in one shared
stream, and a restart at a different rank count resumes exactly:
``merge_rank_states`` folds the saved per-rank cursors into one
job-level frontier (refusing loudly if they diverge), and
``set_state`` on the new topology's loaders re-partitions it — no
record dropped, none double-consumed. With a shuffle buffer the
underlying reader resumes by per-shard replay-and-skip (reservoir
history can't be seeked); the rescale logs that, and the delivered
sequence stays bit-identical.
"""

import logging
import os
import time
import weakref

import numpy as np

from paddle_tpu_torch.monitor.registry import counter as _counter
from paddle_tpu_torch.monitor.registry import gauge as _gauge

__all__ = ["FileDataLoader", "merge_rank_states"]

_log = logging.getLogger("paddle_tpu_torch.dataio")

_m_batches = _counter("dataio_batches_total",
                      "Batches parsed and stacked by FileDataLoader")
_m_records = _counter("data_records_consumed_total",
                      "Records consumed by the training process via "
                      "FileDataLoader (counted at batch delivery, not "
                      "read-ahead)")
_m_native_stateful = _counter(
    "dataio_native_stateful_total",
    "Stateful/data-parallel FileDataLoader streams served by the "
    "deterministic NATIVE loader (vs the Python fallback)")
_m_shard_depth = _gauge(
    "dataio_shard_queue_depth",
    "Records buffered across the native loader's per-shard queues "
    "(read-ahead the merge has not consumed yet)")
_m_h2d_ms = _counter(
    "dataio_h2d_overlap_ms",
    "Milliseconds of host->device feed transfer done in the prefetch "
    "worker thread, i.e. overlapped with the compiled step instead of "
    "paid on its critical path")

STATE_VERSION = 2

_U64 = (1 << 64) - 1


class _ShardRng:
    """splitmix64 over an FNV-1a-mixed (seed, shard, epoch) key — the
    shuffle RNG of the sharded-cursor contract. Deliberately spelled
    out (not ``random.Random``) so the C++ loader implements the exact
    same arithmetic and the two streams are bit-identical."""

    def __init__(self, seed, shard, epoch):
        h = 0xcbf29ce484222325
        for v in (seed, shard, epoch):
            h = ((h ^ (v & _U64)) * 0x100000001b3) & _U64
        self._s = h or 0x9E3779B97F4A7C15

    def next(self):
        self._s = (self._s + 0x9E3779B97F4A7C15) & _U64
        z = self._s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
        return z ^ (z >> 31)

    def below(self, n):
        return self.next() % n

    def shuffle(self, buf):                 # Fisher-Yates
        for i in range(len(buf) - 1, 0, -1):
            j = self.below(i + 1)
            buf[i], buf[j] = buf[j], buf[i]


def _migrate_v1_state(state):
    """Version-1 cursor (the earlier sequential Python reader) ->
    version-2 sharded cursor, where the two record orders provably
    coincide; ``ValueError`` otherwise.

    v1 order was file-sequential (all of file 0, then file 1, ...);
    v2 interleaves per-file shards round-robin. The consumed PREFIX of
    the two streams is the same set only at an epoch boundary (whole
    epochs are the same multiset, and resume only needs the future
    sequence) — or trivially for a single unshuffled file, where both
    orders are plain file order and the byte offset carries over
    (a single SHUFFLED file still refuses: v1 derived its reservoir
    from ``random.Random``, v2 from ``_ShardRng``, so the mid-epoch
    reservoir contents differ)."""
    nfiles = int(state.get("nfiles", 0))
    shards = [{"offset": 0, "epoch_records": 0, "eof": False}
              for _ in range(nfiles)]
    base = {
        "version": STATE_VERSION,
        "epoch": int(state["epoch"]),
        "rr": 0,
        "shards": shards,
        "records_consumed": int(state["records_consumed"]),
        "seed": state.get("seed"),
        "shuffle_buffer": state.get("shuffle_buffer"),
        "nfiles": nfiles,
    }
    if state.get("files") is not None:
        base["files"] = [list(fp) for fp in state["files"]]
    at_epoch_boundary = (int(state.get("epoch_records", 0)) == 0
                         and int(state.get("file_index", 0)) == 0
                         and int(state.get("offset", 0)) == 0)
    if at_epoch_boundary:
        return base
    if nfiles == 1 and not state.get("shuffle_buffer"):
        shards[0]["offset"] = int(state["offset"])
        shards[0]["epoch_records"] = int(state["epoch_records"])
        return base
    raise ValueError(
        f"version-1 data cursor at epoch {state.get('epoch')} + "
        f"{state.get('epoch_records')} record(s) cannot migrate to the "
        f"sharded (version-2) record order mid-epoch: the sequential "
        f"and interleaved streams only coincide at epoch boundaries "
        f"(or for a single unshuffled file) — resume that checkpoint "
        f"on the release that wrote it, or restart the epoch")


class _PyRecordReader:
    """Deterministic, resumable record reader — the single-threaded
    conformance ORACLE for the native loader's sharded-cursor contract
    (see the module docstring for the order definition).

    Iteration order is a pure function of (files, seed,
    shuffle_buffer): shard = file, per-shard reservoir RNG re-derived
    from ``(seed, shard, epoch)``, round-robin merge with an epoch
    barrier. ``state()`` returns the cursor after the last record
    yielded; constructing with ``start_state=`` resumes exactly there —
    per shard by seeking (no shuffle: byte offset) or by replaying the
    epoch's already-emitted records without yielding them (shuffle: the
    reservoir's content is history-dependent, so the skip replay is
    what makes resume bit-identical)."""

    def __init__(self, files, epochs, mode="lines", shuffle_buffer=0,
                 seed=0, start_state=None):
        if mode != "lines":
            raise RuntimeError(
                f"the pure-Python reader only supports mode='lines' "
                f"(got {mode!r}); RecordIO needs the native library")
        self.files = list(files)
        self.epochs = epochs
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        # identity of the stream the cursor addresses: a swapped or
        # rewritten file of the same count would make the saved
        # offset/skip-replay land on different records with no error
        self._files_fp = [[os.path.basename(f), os.path.getsize(f)]
                          for f in self.files]
        self._epoch = 0
        self._rr = 0                # next shard in the round robin
        self._consumed = 0          # records yielded since epoch 0
        self._shards = [{"offset": 0, "epoch_records": 0, "eof": False}
                        for _ in self.files]
        if start_state is not None:
            self.set_state(start_state)

    # -- cursor ------------------------------------------------------------
    def state(self):
        return {
            "version": STATE_VERSION,
            "epoch": self._epoch,
            "rr": self._rr,
            "shards": [dict(s) for s in self._shards],
            "records_consumed": self._consumed,
            "seed": self.seed,
            "shuffle_buffer": self.shuffle_buffer,
            "nfiles": len(self.files),
            "files": [list(fp) for fp in self._files_fp],
        }

    def set_state(self, state):
        if not isinstance(state, dict) or \
                state.get("version") not in (1, STATE_VERSION):
            raise ValueError(
                f"unsupported reader state {state!r:.80} (want a dict "
                f"with version={STATE_VERSION})")
        if state.get("version") == 1:
            state = _migrate_v1_state(state)
        for knob in ("seed", "shuffle_buffer"):
            if state.get(knob) != getattr(self, knob):
                raise ValueError(
                    f"reader state was captured with {knob}="
                    f"{state.get(knob)!r} but this reader has {knob}="
                    f"{getattr(self, knob)!r} — resuming would change "
                    f"the record sequence")
        if state.get("nfiles") != len(self.files):
            raise ValueError(
                f"reader state was captured over {state.get('nfiles')} "
                f"file(s) but this reader has {len(self.files)} — the "
                f"saved cursor does not address this file list")
        want_fp = [list(fp) for fp in self._files_fp]
        got_fp = state.get("files")
        if got_fp is not None and got_fp != want_fp:
            changed = [w[0] for w, g in zip(want_fp, got_fp) if w != g]
            raise ValueError(
                f"reader state was captured over different file "
                f"contents (changed: {changed[:3]}) — a swapped or "
                f"rewritten file would silently shift the record "
                f"sequence the cursor addresses")
        shards = state.get("shards")
        if not isinstance(shards, list) or len(shards) != len(self.files):
            raise ValueError(
                f"reader state carries {len(shards or [])} shard "
                f"cursor(s) for {len(self.files)} file(s)")
        self._epoch = int(state["epoch"])
        self._rr = int(state.get("rr", 0))
        self._consumed = int(state["records_consumed"])
        self._shards = [{"offset": int(s["offset"]),
                         "epoch_records": int(s["epoch_records"]),
                         "eof": bool(s.get("eof"))} for s in shards]

    # -- per-shard streams -------------------------------------------------
    def _shard_stream(self, i, epoch, start_offset=0, skip=0):
        """(record, end_offset, emitted_after) for shard i, one epoch.
        ``skip`` replays (without yielding) the first ``skip`` emitted
        records — the shuffle-resume path; with no shuffle the caller
        seeks via ``start_offset`` instead and ``skip`` just offsets
        the emitted counter."""
        B = self.shuffle_buffer
        if B <= 0:
            off = start_offset
            emitted = skip
            with open(self.files[i], "rb") as fh:
                if off:
                    fh.seek(off)
                for line in fh:
                    off += len(line)
                    emitted += 1
                    yield line.rstrip(b"\n"), off, emitted
            return
        rng = _ShardRng(self.seed, i, epoch)
        buf = []
        emitted = 0
        off = 0
        with open(self.files[i], "rb") as fh:
            for line in fh:
                off += len(line)
                rec = line.rstrip(b"\n")
                if len(buf) < B:
                    buf.append(rec)
                    continue
                j = rng.below(len(buf))
                out, buf[j] = buf[j], rec
                emitted += 1
                if emitted > skip:
                    yield out, off, emitted
        rng.shuffle(buf)            # epoch-end reservoir drain
        for out in buf:
            emitted += 1
            if emitted > skip:
                yield out, off, emitted

    def _open_streams(self, fresh):
        streams = []
        for i, sh in enumerate(self._shards):
            if not fresh and sh["eof"]:
                streams.append(iter(()))    # finished current epoch
            elif not fresh and self.shuffle_buffer > 0:
                streams.append(self._shard_stream(
                    i, self._epoch, skip=sh["epoch_records"]))
            elif not fresh:
                streams.append(self._shard_stream(
                    i, self._epoch, start_offset=sh["offset"],
                    skip=sh["epoch_records"]))
            else:
                streams.append(self._shard_stream(i, self._epoch))
        return streams

    # -- deterministic merge -----------------------------------------------
    def __iter__(self):
        S = len(self.files)
        streams = self._open_streams(fresh=False)
        while self.epochs < 0 or self._epoch < self.epochs:
            # round-robin over live shards until every shard ends the
            # epoch (the barrier), then advance the global epoch
            while True:
                emitted = False
                for k in range(S):
                    i = (self._rr + k) % S
                    sh = self._shards[i]
                    if sh["eof"]:
                        continue
                    try:
                        rec, off, em = next(streams[i])
                    except StopIteration:
                        sh["eof"] = True
                        continue
                    sh["offset"], sh["epoch_records"] = off, em
                    self._consumed += 1
                    self._rr = (i + 1) % S
                    yield rec
                    emitted = True
                    break
                if not emitted:
                    break
            self._epoch += 1
            self._rr = 0
            for sh in self._shards:
                sh["offset"] = 0
                sh["epoch_records"] = 0
                sh["eof"] = False
            if self.epochs >= 0 and self._epoch >= self.epochs:
                return
            streams = self._open_streams(fresh=True)


def _py_record_iter(files, epochs, mode, shuffle_buffer=0, seed=0):
    """Fallback reader: same contract as NativeLoader incl. the
    shuffle buffer (single-threaded). Kept as the module's plain-
    iterator face; ``_PyRecordReader`` is the stateful object."""
    return iter(_PyRecordReader(files, epochs, mode,
                                shuffle_buffer=shuffle_buffer,
                                seed=seed))


def merge_rank_states(states):
    """Fold per-rank ``FileDataLoader.state()`` snapshots (taken at
    the same step) into ONE job-level frontier for topology-elastic
    resume.

    Data-parallel ranks are row-slices of one deterministic job-level
    stream, so their cursors MUST agree on every stream field — the
    merge validates that and strips the per-rank identity (``dp`` rank)
    rather than inventing a new position. Raises ``ValueError`` naming
    the diverging fields when they don't: per-rank streams that were
    not slices of one job-level stream have no exact re-partitioning,
    and guessing one would silently drop or double-consume records
    (``io_checkpoint`` turns that into a ``CheckpointTopologyError``).
    The frontier is a valid ``set_state()`` input for a loader at ANY
    world size with the same files/seed/shuffle/global batch."""
    if not states:
        raise ValueError("no rank states to merge")
    stripped, dps = [], []
    for i, s in enumerate(states):
        if not isinstance(s, dict):
            raise ValueError(f"rank {i} data state is not a dict "
                             f"({type(s).__name__})")
        s = dict(s)
        dps.append(s.pop("dp", None))
        stripped.append(s)
    base = stripped[0]
    for i, s in enumerate(stripped[1:], 1):
        if s != base:
            diff = sorted(k for k in set(base) | set(s)
                          if base.get(k) != s.get(k))
            raise ValueError(
                f"rank 0 and rank {i} data cursors diverge on "
                f"{diff} — the per-rank streams were not slices of "
                f"one job-level stream")
    d0 = dps[0]
    for i, d in enumerate(dps[1:], 1):
        for knob in ("world_size", "global_batch"):
            if (d or {}).get(knob) != (d0 or {}).get(knob):
                raise ValueError(
                    f"rank 0 and rank {i} disagree on dp {knob} "
                    f"({(d0 or {}).get(knob)!r} vs "
                    f"{(d or {}).get(knob)!r})")
    frontier = dict(base)
    if d0 is not None:
        # keep the WRITING topology (minus the per-rank identity): the
        # restoring loader uses it to validate the global batch and to
        # log the world-size change
        frontier["dp"] = {"world_size": d0.get("world_size"),
                          "global_batch": d0.get("global_batch")}
    return frontier


class FileDataLoader:
    """Iterate device-ready batches parsed from files.

    parse_fn(record: bytes) -> tuple/np.ndarray sample;
    samples are stacked per-field into numpy batches. ``device_put``
    controls the prefetch worker's device stage: True (default) puts
    each batch on the card one step ahead of consumption
    (``NoCudaDeviceError`` without one); a CALLABLE places the batch
    itself — pass ``Executor.feed_stage(program, feed_names)`` to put
    batch N+1 on the executor's device in its feeds' dtypes, the copy
    overlapping the step for batch N (device-side double buffering; the
    ``dataio_h2d_overlap_ms`` counter measures the transfer time moved
    off the critical path); the staged batch reaches the consumer's
    stream at delivery (``StagedFeed.hand_over``); a stage that fails
    raises in the consumer. False disables the stage. ``prefetch``
    bounds the read-ahead queue; ``prefetch <= 0`` means UNBOUNDED
    read-ahead (the worker may buffer the whole dataset — only use
    when that fits in host memory).

    ``stateful=True`` enables ``state()``/``set_state()`` for
    exactly-once resume (see the module docstring); the deterministic
    sharded-cursor contract keeps the NATIVE loader's throughput on
    this path (the Python reader is the fallback and the conformance
    oracle). Incompatible with mode='recordio' (the oracle has no
    RecordIO scanner, so a cursor could never be verified).

    ``native=`` pins the reader implementation: None (default) uses
    the native library when available, False forces the Python oracle
    (also via env ``PT_DATAIO_FORCE_PY=1`` — the bench A/B and
    conformance harness knob), True requires native and raises when
    the toolchain is missing.

    ``world_size=W, rank=r`` turns on data-parallel slicing:
    ``batch_size`` becomes the GLOBAL batch, every rank reads the same
    deterministic job-level stream, and rank r keeps rows
    ``[r*B/W, (r+1)*B/W)`` of each global batch. Because the stream is
    rank-count-independent, a checkpointed cursor rescales exactly
    onto a different world size (see ``merge_rank_states``). Requires
    ``batch_size % world_size == 0`` and ``drop_last=True``.
    """

    def __init__(self, files, parse_fn, batch_size, nthreads=2,
                 shuffle_buffer=0, seed=0, epochs=1, mode="lines",
                 drop_last=True, device_put=True, prefetch=2,
                 stateful=False, world_size=None, rank=None,
                 native=None):
        self.files = list(files)
        self.parse_fn = parse_fn
        self.batch_size = batch_size
        self.nthreads = nthreads
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.epochs = epochs
        self.mode = mode
        self.drop_last = drop_last
        self.device_put = device_put
        self.prefetch = prefetch
        self.stateful = stateful
        self.native = native
        self.world_size = int(world_size) if world_size is not None \
            else None
        self.rank = int(rank) if rank is not None else None
        if self.world_size is not None:
            if self.world_size < 1:
                raise ValueError(f"world_size must be >= 1, got "
                                 f"{world_size!r}")
            if self.rank is None or not 0 <= self.rank < self.world_size:
                raise ValueError(
                    f"rank must be in [0, world_size={self.world_size}),"
                    f" got {rank!r}")
            if batch_size % self.world_size:
                raise ValueError(
                    f"batch_size={batch_size} is the GLOBAL batch and "
                    f"must divide evenly across world_size="
                    f"{self.world_size} — a ragged split would give "
                    f"ranks different record counts per step and break "
                    f"cursor rescaling")
            if not drop_last:
                raise ValueError(
                    "world_size slicing requires drop_last=True: a "
                    "ragged final global batch cannot be sliced into "
                    "equal per-rank shares")
        elif self.rank is not None:
            raise ValueError("rank= given without world_size=")
        if stateful and mode == "recordio":
            raise RuntimeError(
                "stateful=True is incompatible with mode='recordio': "
                "the Python oracle has no RecordIO scanner, so a "
                "resume cursor could never be conformance-checked — "
                "use mode='lines' or a non-stateful loader")
        if self.world_size is not None and mode == "recordio":
            raise RuntimeError(
                "world_size slicing is incompatible with "
                "mode='recordio': hosts without the native library "
                "have no RecordIO scanner, so the job-level stream "
                "could not be reproduced everywhere — use mode='lines'")
        self._pending_state = None      # applied at next __iter__
        self._delivered_state = None    # after the last consumed batch
        self._live_iter = None          # stateful: weakref to the one
        # live iterator. WEAK on purpose: a strong ref would close the
        # (loader -> generator -> loader-closure) cycle, deferring an
        # abandoned iterator's finalization — and its prefetch
        # worker's shutdown — from refcount-immediate to whenever the
        # cyclic GC next runs

    # -- resume cursor -----------------------------------------------------
    def _dp_block(self):
        return {"world_size": self.world_size, "rank": self.rank,
                "global_batch": self.batch_size}

    def state(self):
        """The cursor after the last batch the CONSUMER received (not
        the worker's read-ahead). Save it with a checkpoint; a new
        loader ``set_state()``-ed with it continues the exact record
        sequence. Before any batch is delivered this returns the
        pending (restored) state, or the start-of-stream cursor.
        Under data-parallel slicing the cursor carries a ``dp`` block
        (world_size/rank/global_batch) describing THIS topology — the
        merge/rescale machinery reads it."""
        if not self.stateful:
            raise RuntimeError(
                "state() on a non-stateful FileDataLoader — construct "
                "with stateful=True (exactly-once resume needs the "
                "deterministic reader)")
        if self._delivered_state is not None:
            s = self._delivered_state
        elif self._pending_state is not None:
            s = self._pending_state
        else:
            s = _PyRecordReader(self.files, self.epochs, self.mode,
                                self.shuffle_buffer, self.seed).state()
        if self.world_size is not None:
            s = dict(s, dp=self._dp_block())
        return s

    def set_state(self, state):
        """Resume from a ``state()`` snapshot: takes effect on the next
        ``__iter__`` (create iterators AFTER calling this). Without a
        fresh ``set_state``, each subsequent iterator CONTINUES from
        the last delivered batch — the loader is a stream with a
        cursor, so re-iterating never replays consumed records (an
        exhausted finite stream yields nothing).

        The snapshot may come from a DIFFERENT topology (another
        world_size/rank, or a ``merge_rank_states`` frontier): the
        cursor addresses the shared job-level stream, so it applies
        directly — only the global batch size must match (record→step
        boundaries would shift otherwise). A world-size change is
        logged, including the replay-and-skip cost when a shuffle
        buffer makes the epoch prefix non-seekable. Version-1 cursors
        (pre-sharded-contract checkpoints) migrate where the record
        orders coincide — see ``_migrate_v1_state``."""
        if not self.stateful:
            raise RuntimeError(
                "set_state() on a non-stateful FileDataLoader — "
                "construct with stateful=True")
        state = dict(state)
        dp = state.pop("dp", None)
        if dp is not None:
            gb = dp.get("global_batch")
            if gb is not None and gb != self.batch_size:
                raise ValueError(
                    f"data cursor was captured with global batch "
                    f"{gb} but this loader's is {self.batch_size} — "
                    f"re-partitioning across a changed batch size "
                    f"would shift every step boundary")
        if self.world_size is not None:
            # a cursor without a dp block (saved by a plain stateful
            # loader) carries no global-batch record to compare — but
            # alignment is provable from the position itself: delivery
            # commits whole batches, so a sound resume point must land
            # on a boundary of THIS loader's global batch (dp slicing
            # enforces drop_last, so partial deliveries can't occur)
            rc = int(state.get("records_consumed", 0))
            if rc % self.batch_size:
                raise ValueError(
                    f"data cursor at {rc} consumed record(s) does not "
                    f"land on a global-batch boundary of "
                    f"{self.batch_size} — it was saved by a loader "
                    f"with a different batch size, and resuming would "
                    f"shift every step boundary")
        old_w = (dp.get("world_size") or 1) if dp is not None else 1
        new_w = self.world_size or 1
        if old_w != new_w:
            replay = ""
            epoch_recs = sum(
                int(s.get("epoch_records", 0))
                for s in state.get("shards", [])
            ) if state.get("version") == STATE_VERSION else \
                int(state.get("epoch_records", 0))
            if self.shuffle_buffer and epoch_recs:
                # the reader can't seek into a reservoir-shuffled
                # epoch: resume replays the already-consumed prefix
                # without yielding it — exact, not free
                replay = (f" (shuffled stream: resume replays-and-"
                          f"skips {epoch_recs} "
                          f"record(s) of the current epoch)")
            _log.warning(
                "rescaling data cursor from world_size=%d to "
                "world_size=%d at %d consumed record(s)%s",
                old_w, new_w,
                state.get("records_consumed", 0), replay)
        # validate eagerly (a bad cursor should fail at restore time,
        # not steps later inside the prefetch worker) — the validator
        # also NORMALIZES the snapshot (version-1 migration), so the
        # stored pending state is always a v2 sharded cursor the
        # native loader can restore directly
        validator = _PyRecordReader(self.files, self.epochs, self.mode,
                                    self.shuffle_buffer, self.seed,
                                    start_state=state)
        # a still-live iterator delivering after this call would stomp
        # the snapshot with its own cursor — supersede it now
        self._close_live_iter()
        self._pending_state = validator.state()
        self._delivered_state = None

    def _close_live_iter(self):
        ref, self._live_iter = self._live_iter, None
        it = ref() if ref is not None else None
        if it is not None:
            it.close()

    # -- reading -----------------------------------------------------------
    def _use_native(self):
        """Resolve the reader implementation for THIS stream."""
        if self.native is False or \
                os.environ.get("PT_DATAIO_FORCE_PY") == "1":
            return False
        from paddle_tpu_torch import native
        ok = native.available()
        if self.native is True and not ok:
            raise RuntimeError(
                "FileDataLoader(native=True) but the native library is "
                "unavailable (no C++ toolchain / build failed)")
        return ok

    def _records(self):
        if self.mode not in ("lines", "recordio"):
            raise ValueError(f"mode must be 'lines' or 'recordio', "
                             f"got {self.mode!r}")
        use_native = self._use_native()
        if self.stateful:
            # a later iterator continues from the last DELIVERED batch
            # (falling back to the restored snapshot before anything
            # was delivered): re-seeding from _pending_state would
            # silently replay already-consumed records on the second
            # __iter__ — the exactly-once violation, not a rewind
            start = self._delivered_state \
                if self._delivered_state is not None \
                else self._pending_state
            if use_native:
                # deterministic merge == the Python oracle's order, so
                # exactly-once resume keeps native throughput
                from paddle_tpu_torch import native
                _m_native_stateful.inc()
                return native.NativeLoader(
                    self.files, nthreads=self.nthreads,
                    shuffle_buffer=self.shuffle_buffer, seed=self.seed,
                    epochs=self.epochs, mode=self.mode,
                    start_state=start)
            return _PyRecordReader(self.files, self.epochs, self.mode,
                                   self.shuffle_buffer, self.seed,
                                   start_state=start)
        if self.world_size is not None:
            # dp slicing's core invariant — every rank reads the SAME
            # deterministic job-level stream — holds for BOTH readers
            # under the sharded-cursor contract: ranks slice
            # identically-ordered global batches whichever
            # implementation serves them
            if use_native:
                from paddle_tpu_torch import native
                _m_native_stateful.inc()
                return native.NativeLoader(
                    self.files, nthreads=self.nthreads,
                    shuffle_buffer=self.shuffle_buffer, seed=self.seed,
                    epochs=self.epochs, mode=self.mode)
            return _py_record_iter(self.files, self.epochs, self.mode,
                                   self.shuffle_buffer, self.seed)
        if self.mode == "recordio" and not use_native:
            raise RuntimeError(
                "mode='recordio' needs the native library (no pure-Python "
                "RecordIO scanner); the native build failed or no C++ "
                "toolchain is present")
        if use_native:
            from paddle_tpu_torch import native
            return native.NativeLoader(
                self.files, nthreads=self.nthreads,
                shuffle_buffer=self.shuffle_buffer, seed=self.seed,
                epochs=self.epochs, mode=self.mode)
        # no toolchain: single-threaded Python reader, same contract
        return _py_record_iter(self.files, self.epochs, self.mode,
                               self.shuffle_buffer, self.seed)

    def _slice_rows(self, batch):
        """This rank's contiguous row share of a global batch."""
        b = self.batch_size // self.world_size
        sl = slice(self.rank * b, (self.rank + 1) * b)
        if isinstance(batch, tuple):
            return tuple(f[sl] for f in batch)
        return batch[sl]

    def _batches(self):
        """(batch, n_records, cursor-after-those-records) triples; the
        cursor is None for non-stateful readers. Under data-parallel
        slicing the yielded batch is this rank's rows and n_records
        counts them (the cursor still tracks the GLOBAL stream — it is
        the job-level position every rank shares)."""
        records = self._records()
        snap = records.state if (self.stateful
                                 and hasattr(records, "state")) \
            else (lambda: None)

        def emit(samples):
            _m_batches.inc()
            batch = self._stack(samples)
            if self.world_size is not None:
                return (self._slice_rows(batch),
                        len(samples) // self.world_size, snap())
            return batch, len(samples), snap()

        try:
            pull = getattr(records, "read_records", None)
            if pull is not None:
                # native loader: ONE ctypes crossing per batch (the
                # bulk read), with the cursor snapshot landing exactly
                # on the batch boundary the bulk pull stops at
                depth = getattr(records, "queue_size", None)
                while True:
                    recs = pull(self.batch_size)
                    if depth is not None:
                        _m_shard_depth.set(depth())
                    if not recs:
                        break
                    if len(recs) == self.batch_size:
                        yield emit([self.parse_fn(r) for r in recs])
                        continue
                    if not self.drop_last:
                        yield emit([self.parse_fn(r) for r in recs])
                    break
                return
            buf = []
            for rec in records:
                buf.append(self.parse_fn(rec))
                if len(buf) == self.batch_size:
                    yield emit(buf)
                    buf = []
            if buf and not self.drop_last:
                yield emit(buf)
        finally:
            if hasattr(records, "close"):
                records.close()

    @staticmethod
    def _stack(samples):
        # np.asarray, not np.stack: identical output for equal-shape
        # samples (still an error for ragged ones), but without
        # stack's per-sample expand_dims+concatenate machinery —
        # ~30x cheaper for scalar samples, ~2x for small vectors,
        # which used to dominate the whole ingest pipeline
        if isinstance(samples[0], (tuple, list)):
            return tuple(np.asarray([s[i] for s in samples])
                         for i in range(len(samples[0])))
        return np.asarray(samples)

    def __iter__(self):
        """Async prefetch pipeline: a worker thread parses/batches/
        device-puts ahead of the consumer (buffered_reader.cc's
        double-buffering). The thread/queue machinery is the shared
        background_prefetch helper (static.executor): a parse_fn
        exception re-raises HERE with the worker's traceback intact —
        carrying the failing batch's ordinal for postmortems — and
        abandoning the iterator early (break / close) shuts the worker
        down. The state cursor riding with each batch commits only
        here, at delivery — read-ahead batches the consumer never
        pulled are not "consumed" and resume re-reads them."""
        from paddle_tpu_torch.core.place import place_device
        from paddle_tpu_torch.static.executor import (
            _DeviceStage, background_prefetch, hand_over,
        )

        # stateful: ONE live cursor. Superseding (closing) any previous
        # iterator before the new reader seeds from _delivered_state
        # makes the one-stream contract enforced, not advisory — two
        # concurrently-live iterators would double-deliver records and
        # let the older one regress the committed cursor
        if self.stateful:
            self._close_live_iter()

        if callable(self.device_put):
            put = self.device_put       # the executor's feed_stage
        elif self.device_put:
            put = _DeviceStage(place_device(None))
        else:
            put = None

        def stage(item):
            batch, n, cursor = item
            if put is None:
                return batch, n, cursor
            t0 = time.perf_counter()
            staged = put(batch)
            # transfer time spent HERE runs in the worker thread,
            # overlapped with the consumer's compiled step
            _m_h2d_ms.inc((time.perf_counter() - t0) * 1e3)
            return staged, n, cursor

        inner = background_prefetch(self._batches(), stage,
                                    self.prefetch)

        def deliver():
            try:
                for batch, n, cursor in inner:
                    _m_records.inc(n)
                    if cursor is not None:
                        self._delivered_state = cursor
                    yield hand_over(batch)
            finally:
                inner.close()   # deterministic worker shutdown when
                                # the consumer abandons THIS wrapper
                # NOTE: deliver() must not reference its own generator
                # (e.g. to clear _live_iter) — the closure cell would
                # be a self-cycle keeping an abandoned iterator, and
                # its prefetch worker, alive until a cyclic GC pass.
                # A stale _live_iter weakref is harmless: re-closing a
                # finished generator is a no-op.

        gen = deliver()
        if self.stateful:
            self._live_iter = weakref.ref(gen)
        return gen
