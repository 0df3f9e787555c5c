"""Multi-replica dispatch: the execution half of the serving subsystem.
The port of ``paddle_tpu/serving/replica.py``.

Each :class:`Replica` owns a device, a device-resident copy of the frozen
program's params and a thread draining the shared batch queue. Where the JAX
package compiles one XLA executable per (device, bucket) at warm boot, the
port puts the params on each device once and runs every bucket of the ladder
once on zeros (:class:`ReplicaPool` construction), which builds the kernels
and warms cuBLAS before the server accepts a request. A batch then runs the
program's ops eagerly (``inference._build_pure_fn``), as ``Executor.run``
does; each replica thread runs under ``torch.inference_mode()``, entered in
that thread (grad mode is thread-local). Feeds arrive as numpy arrays and
are copied onto the device at dispatch; outputs come back as numpy arrays.

Replicas are fed from ONE shared batch queue: a slow replica takes fewer
batches, it cannot convoy the others. Replicas that share a device share
one param copy.

**Resilience**: every replica heartbeats per dispatch (``busy_since``,
``current``) and a supervisor thread in :class:`ReplicaPool` watches them. A
replica wedged mid-dispatch past ``replica_stall_ms``, or whose thread died,
is **quarantined**: its in-flight batch's riders are failed with a typed
:class:`~.resilience.ReplicaLostError`, and the slot is **respawned**
against the already-resident params after a capped exponential backoff.
``max_consecutive_stalls`` losses with no successful batch in between retire
the slot. If every slot retires, the supervisor keeps draining the batch
queue and failing riders so no request ever hangs.

**Two pools** coexist during a hot swap (``swap.py``): a pool has a
``role``, ``"live"`` or ``"standby"``, and only the live one publishes the
pool gauges; ``promote``/``demote`` hand them over at cutover and
``release`` drops a drained pool's device params. Each pool attributes its
residency in the memory ledger (``monitor/memory.py``) under its own tag,
and ``projected_bytes`` is what the swap's admission projects: on the card,
the params plus the largest transient peak a bucket's warm-up run measured
(the JAX package reads XLA's compile-time estimate there; the port
measures). Replica threads and a standby's warm-up share the device's
default stream, so a standby warming beside the live pool queues its copies
and kernels behind the live batches instead of racing them.
"""

import itertools
import queue
import threading
import time

import torch

from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.monitor import memory as _memory
from paddle_tpu_torch.monitor.registry import counter, gauge, histogram
from paddle_tpu_torch.serving.resilience import ReplicaLostError, _log

__all__ = ["Replica", "ReplicaPool"]

_m_replicas = gauge(
    "serving_replicas",
    "Replica workers serving the shared batch queue (supervisor-owned "
    "truth: a dead or quarantined replica leaves this gauge, a "
    "respawned one re-enters)")
_m_exec_ms = histogram(
    "serving_batch_execute_ms",
    "Wall ms a replica spent executing one micro-batch (host-to-device "
    "feeds + the program's ops + the host fetch)")
_m_state = gauge(
    "serving_replica_state",
    "Replica count by lifecycle state: up (draining the batch queue), "
    "quarantined (lost mid-dispatch, awaiting respawn backoff), "
    "retired (permanently removed after max_consecutive_stalls)",
    labels=("state",))
_m_respawns = counter(
    "serving_replica_respawns_total",
    "Replica worker threads respawned by the pool supervisor after a "
    "stall or thread death (against the already-resident params)")
_m_param_bytes = gauge(
    "serving_param_bytes",
    "Device-resident model-parameter bytes per replica device of the "
    "LIVE pool (weight-quantized serving shrinks this ~4x for int8, 2x "
    "for bf16)")

#: batch-queue sentinel, one per live replica at shutdown
_STOP = object()

#: monotonic pool tags scoping memory-ledger entities: two pools coexist
#: during a hot swap, so the role alone cannot name residency
_POOL_SEQ = itertools.count()

#: replica lifecycle states (the serving_replica_state vocabulary)
_UP, _QUARANTINED, _RETIRED = "up", "quarantined", "retired"


def zero_pool_gauges():
    """Zero every pool gauge: a closed server has nothing up, nothing
    awaiting respawn, nothing newly retired."""
    _m_replicas.set(0)
    _m_param_bytes.set(0)
    for s in (_UP, _QUARANTINED, _RETIRED):
        _m_state.set(0, state=s)


def _nbytes(t):
    return t.numel() * t.element_size()


class Replica:
    """One worker: a device, resident params, the served function and the
    ladder it was warmed on, and a thread draining the shared batch
    queue."""

    def __init__(self, index, device, fn, params, ladder, feed_names,
                 batch_queue, pool=None):
        self.index = index
        self.device = device
        self._fn = fn
        self._params = params
        self._ladder = tuple(ladder)
        self._feed_names = tuple(feed_names)
        self._q = batch_queue
        #: owning pool (None when built alone): a batch failed HERE counts
        #: against THIS pool, which the hot-swap watchdog reads
        self._pool = pool
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"serving-replica-{index}")
        self.batches_run = 0
        #: perf_counter at the current batch's pickup, None while idle — a
        #: non-None value older than replica_stall_ms is a wedged dispatch
        self.busy_since = None
        #: the in-flight micro-batch, so the supervisor can fail its
        #: riders if this thread is lost
        self.current = None
        #: set by the supervisor at quarantine: the thread stops taking
        #: work the moment it can observe the flag
        self._abandoned = False
        #: distinguishes a clean _STOP exit from a death
        self._exited_clean = False

    def start(self):
        self._thread.start()
        return self

    def join(self, timeout=None):
        self._thread.join(timeout)

    def is_alive(self):
        return self._thread.is_alive()

    def _loop(self):
        # grad mode is thread-local: every batch of this thread runs
        # without autograd
        with torch.inference_mode():
            self._drain()

    def _drain(self):
        while True:
            mb = self._q.get()
            if self._abandoned:
                # quarantined while blocked in get(): this slot
                # belongs to the respawn now — hand back WHATEVER was
                # grabbed and bow out. The _abandoned check must come
                # before the sentinel check: at close() sentinels are
                # enqueued one per LIVE replica, and an abandoned
                # thread consuming one would leave a live replica
                # blocked in get() forever (close joins it forever)
                self._q.put(mb)
                break
            if mb is _STOP:
                self._exited_clean = True
                break
            t0 = time.perf_counter()
            # heartbeat-per-dispatch: current BEFORE busy_since here,
            # current cleared first in _idle — the supervisor's
            # unlocked read pair (batch, then stamp, both non-None +
            # stale) is sound under those write orders
            self.current = mb
            self.busy_since = t0
            # trace stamps only (dispatch_wait ends / execute starts
            # here; fakes enqueued by tests may lack the slots): the
            # per-request spans assemble from these at tail-sampling
            # keep time, so the serving hot path pays attribute
            # stores, never span construction
            stamped = hasattr(mb, "t_pick")
            if stamped:
                mb.t_pick = t0
                mb.tid_replica = threading.get_ident()
                mb.replica = self.index
            # dispatch-wait deadline stage: riders that expired while
            # the batch sat in the queue get their typed error here,
            # and a batch with NO live rider never consumes a dispatch
            if hasattr(mb, "expire_riders") and \
                    mb.expire_riders(now=t0) == 0:
                self._idle()
                if self._abandoned:
                    break
                continue
            try:
                outs = self.run_batch(mb.bucket, mb.feeds)
            except Exception as e:
                # deliver the failure to the batch's requests and keep
                # serving: one poisoned batch must not kill the replica
                self._note_failure()
                mb.fail(e)
                self._idle()
                if self._abandoned:
                    break
                continue
            if stamped:
                mb.t_exec = time.perf_counter()
            if self._pool is not None and hasattr(mb, "model_version"):
                mb.model_version = self._pool.model_version
            try:
                mb.complete(outs)
            except Exception as e:
                # complete() itself failed (e.g. the program returned
                # a wrong leading dim): sweep the undelivered requests
                # with the error (first-wins delivery) and keep serving
                self._note_failure()
                mb.fail(e)
                self._idle()
                if self._abandoned:
                    break
                continue
            self.batches_run += 1
            self._idle()
            _m_exec_ms.observe((time.perf_counter() - t0) * 1e3)
            if self._abandoned:
                break

    def _idle(self):
        self.current = None
        self.busy_since = None

    def _note_failure(self):
        if self._pool is not None:
            self._pool._note_batch_failures()

    def run_batch(self, bucket, feeds):
        """Run one padded batch dict for ``bucket`` on this replica's
        device; returns host arrays in fetch order."""
        enforce(bucket in self._ladder,
                f"replica {self.index} was not warmed for bucket {bucket} "
                f"(ladder {self._ladder})")
        try:
            fd = tuple(torch.from_numpy(feeds[n]).to(self.device)
                       for n in self._feed_names)
            return [o.cpu().numpy() for o in self._fn(self._params, fd)]
        except Exception as e:
            if _memory.is_oom_error(e):
                # a typed postmortem instead of the allocator's traceback;
                # it flows through _drain's failure handling to mb.fail
                _memory.handle_oom(e, f"serving.replica/bucket{bucket}")
            raise


class ReplicaPool:
    """N replicas over ``devices`` (round-robin; default: the card), all
    draining one shared bounded batch queue. Construction IS the warm boot:
    the params go to each device once and every bucket runs once on zeros
    before this returns; ``warm_shapes`` keeps each bucket's output shapes.

    ``pure_fn`` is ``fn(params_tuple, feeds_tuple) -> outputs_tuple`` from
    ``inference._build_pure_fn``; ``params`` the state tensors in its order;
    ``sample_specs`` {feed name: (sample_shape, numpy dtype)} fixing every
    non-batch dim.

    Resilience knobs: ``replica_stall_ms`` — a dispatch running longer than
    this is a wedge (quarantine + respawn); ``max_consecutive_stalls`` —
    losses with no successful batch in between before the slot retires;
    ``respawn_backoff_ms`` — base of the capped (5 s) exponential respawn
    backoff; ``supervise=False`` runs no supervisor thread.

    ``role`` makes two pools coexist for the hot swap: only the ``"live"``
    pool publishes the ``serving_replicas`` / ``serving_replica_state`` /
    ``serving_param_bytes`` gauges; a ``"standby"`` pool warm-boots and
    drains its own queue silently (its supervisor still heals it), and
    ``promote()`` / ``demote()`` hand gauge ownership over at cutover. A
    demoted pool's ``close()`` never zeroes the gauges the new live pool
    owns."""

    def __init__(self, pure_fn, params, feed_names, sample_specs,
                 ladder, n_replicas=1, devices=None, queue_depth=None,
                 replica_stall_ms=30_000.0, max_consecutive_stalls=3,
                 respawn_backoff_ms=100.0, supervise=True, role="live"):
        from paddle_tpu_torch import default_device

        enforce(n_replicas >= 1, f"n_replicas < 1 ({n_replicas})")
        enforce(replica_stall_ms > 0,
                f"replica_stall_ms must be positive, got "
                f"{replica_stall_ms!r}")
        enforce(max_consecutive_stalls >= 1,
                f"max_consecutive_stalls must be >= 1, got "
                f"{max_consecutive_stalls!r}")
        enforce(respawn_backoff_ms >= 0,
                f"respawn_backoff_ms must be >= 0, got "
                f"{respawn_backoff_ms!r}")
        enforce(role in ("live", "standby"),
                f"role must be 'live' or 'standby', got {role!r}")
        self.role = role
        #: the manifest model_version this pool serves (``_boot_pool``
        #: sets it); stamped on every batch it completes
        self.model_version = None
        self._fn = pure_fn
        self._feed_names = tuple(feed_names)
        self.ladder = tuple(ladder)
        devices = [torch.device(d) for d in (
            devices if devices is not None else [default_device()])]
        enforce(devices, "no devices given for serving")
        if queue_depth is None:
            # deep enough that the batcher never stalls behind an idle
            # replica, shallow enough that batches don't age in queue
            queue_depth = max(2 * n_replicas, 2)
        self.batch_queue = queue.Queue(maxsize=queue_depth)
        #: bytes of ONE device's resident param copy: int8/bf16 quantized
        #: bundles land here ~4x/2x smaller than fp32
        self._param_bytes = int(sum(_nbytes(p) for p in params))
        self._by_device = {}        # device -> resident params
        self.warm_shapes = {}       # bucket -> output shapes
        #: bucket -> the largest transient bytes (feeds, activations,
        #: outputs) its warm-up run allocated over the resident params, as
        #: measured on the first card; empty on the CPU
        self._bucket_peak = {}
        self._pool_tag = f"pool{next(_POOL_SEQ)}"
        self._ledger_entities = ()
        with torch.inference_mode():
            for dev in {devices[i % len(devices)]: None
                        for i in range(n_replicas)}:
                resident = tuple(p.to(dev) for p in params)
                for bucket in self.ladder:
                    measure = dev.type == "cuda" and \
                        bucket not in self._bucket_peak
                    if measure:
                        torch.cuda.synchronize(dev)
                        torch.cuda.reset_peak_memory_stats(dev)
                        before = torch.cuda.memory_allocated(dev)
                    zeros = tuple(
                        torch.zeros((bucket,) + tuple(shape),
                                    dtype=convert_dtype(dtype), device=dev)
                        for shape, dtype in
                        (sample_specs[n] for n in self._feed_names))
                    outs = pure_fn(resident, zeros)
                    self.warm_shapes[bucket] = [tuple(o.shape)
                                                for o in outs]
                    if measure:
                        torch.cuda.synchronize(dev)
                        self._bucket_peak[bucket] = int(
                            torch.cuda.max_memory_allocated(dev) - before)
                    del zeros, outs
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                self._by_device[dev] = resident
        self._ledger_publish()
        self._stopped = False
        #: True only after a TRUE close finished its final sweep — the
        #: dispatch() post-put sweep keys on it (see dispatch)
        self._closed_done = False
        #: batches this pool delivered as typed FAILURES (execution or
        #: complete errors, supervisor-failed in-flight batches, dead-pool
        #: and close sweeps): the hot-swap watchdog's per-pool attribution;
        #: deadline expiries are load symptoms and do not count
        self.batch_failures = 0
        self._fail_lock = threading.Lock()
        self._stall_s = replica_stall_ms / 1e3
        self._max_stalls = int(max_consecutive_stalls)
        self._backoff_s = respawn_backoff_ms / 1e3
        self._lock = threading.Lock()
        self._slot_device = [devices[i % len(devices)]
                             for i in range(n_replicas)]
        self._states = [_UP] * n_replicas
        self._stall_counts = [0] * n_replicas
        self._respawn_due = {}          # slot -> monotonic due time
        self._live_at_close = []
        self._stops_pending = 0
        self._drained_dead_pool = False
        self.replicas = [
            Replica(i, self._slot_device[i], pure_fn,
                    self._by_device[self._slot_device[i]], self.ladder,
                    self._feed_names, self.batch_queue, pool=self)
            for i in range(n_replicas)]
        for r in self.replicas:
            r.start()
        self._publish_states()
        self._sup_stop = threading.Event()
        self._supervisor = None
        if supervise:
            self._supervisor = threading.Thread(
                target=self._supervise, daemon=True,
                name="serving-supervisor")
            self._supervisor.start()

    # -- supervision -------------------------------------------------------
    def _publish_states(self):
        if self.role != "live":
            # a standby pool coexists with the live one during a hot swap:
            # publishing its counts would overwrite the live pool's truth
            return
        counts = {_UP: 0, _QUARANTINED: 0, _RETIRED: 0}
        for s in self._states:
            counts[s] += 1
        for s, c in counts.items():
            _m_state.set(c, state=s)
        # the supervisor owns gauge truth: serving_replicas is the
        # count actually draining the queue, not the count booted
        _m_replicas.set(counts[_UP])
        _m_param_bytes.set(self._param_bytes)

    def projected_bytes(self):
        """Per-device bytes this pool needs to co-reside, the number the
        hot swap's admission projects before booting a standby: the params
        plus the largest transient peak a bucket's warm-up run allocated
        over them on the card (``torch.cuda.reset_peak_memory_stats`` and
        ``max_memory_allocated`` around the run). A measurement, where the
        JAX package takes XLA's compile-time estimate; a warm-up beside a
        serving pool on the same card counts that pool's transients too, so
        the projection errs high. On the CPU, the param bytes alone."""
        return int(self._param_bytes
                   + max(self._bucket_peak.values(), default=0))

    def _ledger_publish(self):
        """Attribute this pool's residency in the memory ledger: params
        (summed across the pool's devices) and each bucket's measured
        peak, under the pool's own tag (two pools coexist during a swap).
        Never fatal: telemetry must not fail a boot or a cutover."""
        try:
            self._ledger_drop()
            ndev = max(1, len(self._by_device))
            pre = f"serving/{self._pool_tag}:{self.role}"
            entities = {f"{pre}/params": self._param_bytes * ndev}
            for bucket, peak in self._bucket_peak.items():
                entities[f"{pre}/bucket{bucket}"] = peak
            for e, b in entities.items():
                _memory.ledger_set(e, b)
            self._ledger_entities = tuple(entities)
        except Exception:
            pass

    def _ledger_drop(self):
        try:
            for e in getattr(self, "_ledger_entities", ()):
                _memory.ledger_remove(e)
            self._ledger_entities = ()
        except Exception:
            pass

    def promote(self):
        """Standby -> live at hot-swap cutover: take gauge ownership and
        publish this pool's states (under the pool lock, see ``demote``)."""
        with self._lock:
            self.role = "live"
            self._publish_states()
            self._ledger_publish()

    def demote(self):
        """Live -> draining out at cutover (or rollback of a freshly
        promoted standby): stop publishing gauges while the replicas drain
        the batches already dispatched here. Under the pool lock, so a
        supervisor mid-``_publish_states`` finishes before the role flips
        and cannot land its publish after the new owner's."""
        with self._lock:
            self.role = "standby"
            # the residency is real until release(): re-attribute it
            self._ledger_publish()

    def release(self):
        """Drop the device-resident params after a TRUE close: the hot
        swap's two-pool window ends here. Empties the caching allocator's
        free blocks so the card's reserve shrinks with the allocation. A
        released pool cannot respawn; call only once close() returned
        True."""
        self._ledger_drop()
        cards = [d for d in self._by_device if d.type == "cuda"]
        self._by_device.clear()
        for r in self.replicas:
            r._params = ()
        if cards:
            for d in cards:
                torch.cuda.synchronize(d)
            torch.cuda.empty_cache()

    def _note_batch_failures(self, n=1):
        with self._fail_lock:
            self.batch_failures += n

    def _supervise(self):
        """Detect wedged/dead replicas, quarantine, respawn (capped
        exponential backoff), retire after repeated stalls — and while
        the pool has NO live replica, drain the batch queue and fail
        riders so an accepted request can never hang on a dead pool."""
        poll = max(min(0.05, self._stall_s / 4.0), 0.005)
        while not self._sup_stop.wait(poll):
            now = time.perf_counter()
            mono = time.monotonic()
            to_fail = []            # (micro-batch, error) outside lock
            with self._lock:
                if self._stopped:
                    break
                for i, r in enumerate(self.replicas):
                    st = self._states[i]
                    if st == _QUARANTINED:
                        if mono >= self._respawn_due.get(i,
                                                         float("inf")):
                            self._respawn_locked(i)
                        continue
                    if st != _UP:
                        continue
                    if r.batches_run > 0 and self._stall_counts[i]:
                        # a batch has completed since the last loss:
                        # the stall streak is broken, the slot earned
                        # its consecutive-count back
                        self._stall_counts[i] = 0
                    if not r.is_alive() and not r._exited_clean:
                        to_fail.append(self._lose_locked(
                            i, r, "thread died by uncaught exception"))
                    elif r.busy_since is not None and \
                            now - r.busy_since > self._stall_s:
                        # re-validate before acting: the replica holds
                        # no pool lock, so between the check above and
                        # here it may have FINISHED the judged dispatch
                        # (and even picked a fresh batch). _loop's
                        # write orders (current before busy_since on
                        # pickup; current cleared before busy_since on
                        # idle) make this read pair sound: a fresh or
                        # ended dispatch shows a young/None busy_since
                        # or a None batch, and quarantining then would
                        # fail a HEALTHY batch's riders with spurious
                        # ReplicaLostError
                        mb = r.current
                        t2 = r.busy_since
                        if mb is not None and t2 is not None and \
                                now - t2 > self._stall_s:
                            to_fail.append(self._lose_locked(
                                i, r,
                                f"wedged mid-dispatch (> "
                                f"{self._stall_s * 1e3:.0f}ms)",
                                mb=mb))
                dead_pool = all(s == _RETIRED for s in self._states)
            for mb, exc in to_fail:
                if mb is not None and hasattr(mb, "fail"):
                    self._note_batch_failures()
                    mb.fail(exc)
            if dead_pool:
                self._drain_dead_pool()

    def _lose_locked(self, i, r, cause, mb=None):
        """Quarantine slot ``i`` (or retire it after max consecutive
        stalls); returns (in-flight batch, error) for the caller to
        fail OUTSIDE the pool lock. ``mb`` pins the judged batch for
        the stall path (re-validated by the caller); the dead-thread
        path reads whatever the corpse last held."""
        r._abandoned = True
        if mb is None:
            mb = r.current
        self._stall_counts[i] += 1
        cons = self._stall_counts[i]
        retire = cons >= self._max_stalls
        self._states[i] = _RETIRED if retire else _QUARANTINED
        if retire:
            up = sum(1 for s in self._states if s == _UP)
            _log(f"replica {i} {cause}; PERMANENTLY RETIRED after "
                 f"{cons} consecutive losses with no completed batch "
                 f"— pool shrinks to {up} live replica(s)"
                 + ("" if up else
                    " (ZERO live replicas: queued batches will be "
                    "failed, not hung — restart the server)"))
        else:
            backoff = min(self._backoff_s * (2 ** (cons - 1)), 5.0)
            self._respawn_due[i] = time.monotonic() + backoff
            _log(f"replica {i} {cause}; quarantined "
                 f"(consecutive losses: {cons}/{self._max_stalls}), "
                 f"failing its in-flight batch, respawn in "
                 f"{backoff * 1e3:.0f}ms")
        self._publish_states()
        exc = ReplicaLostError(
            f"serving replica {i} {cause}; its in-flight micro-batch "
            f"was failed by the pool supervisor and the replica was "
            f"{'retired' if retire else 'quarantined for respawn'} — "
            f"the request is safe to retry")
        return mb, exc

    def _respawn_locked(self, i):
        self._respawn_due.pop(i, None)
        dev = self._slot_device[i]
        nr = Replica(i, dev, self._fn, self._by_device[dev], self.ladder,
                     self._feed_names, self.batch_queue, pool=self)
        self.replicas[i] = nr
        self._states[i] = _UP
        nr.start()
        _m_respawns.inc()
        self._publish_states()
        _log(f"replica {i} respawned against the warm resident params")

    def _fail_queued(self, why):
        """Drain the batch queue non-blocking, failing every rider
        with a typed ReplicaLostError — the shared no-hang backstop
        for a dead pool and for shutdown."""
        while True:
            try:
                mb = self.batch_queue.get_nowait()
            except queue.Empty:
                return
            if mb is not _STOP and hasattr(mb, "fail"):
                self._note_batch_failures()
                mb.fail(ReplicaLostError(why))

    def _drain_dead_pool(self):
        """Every slot retired: nothing will ever drain the batch
        queue, so the supervisor does — failing riders typed instead
        of letting accepted requests hang forever."""
        if not self._drained_dead_pool:
            self._drained_dead_pool = True
            _log("serving pool has ZERO live replicas; the supervisor "
                 "is draining the batch queue and failing riders")
        self._fail_queued(
            "serving pool has no live replicas (every slot "
            "permanently retired); the batch was failed without "
            "dispatch — restart the server")

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, micro_batch):
        """The scheduler's dispatch target: blocking put, so a saturated
        pool backpressures the batcher (and through it the bounded
        request queue) instead of queueing unboundedly. A batch put after
        the pool truly stopped is failed typed right here (first-wins
        delivery makes a double sweep harmless); the in-close window is
        covered by close()'s own final sweep, which runs after
        ``_closed_done`` is set."""
        self.batch_queue.put(micro_batch)
        if self._closed_done:
            self._fail_queued(
                "serving pool was already closed when this batch was "
                "dispatched; the batch was failed without dispatch — the "
                "request is safe to retry")

    def resident_param_bytes(self):
        """Bytes of one device-resident param copy (every replica device
        holds one): the sum of the resident tensors' bytes."""
        return self._param_bytes

    def _judge_losses_at_close(self):
        """The supervisor is stopped for the whole close phase, so the
        drain carries its own loss handling ("no accepted request ever
        hangs" includes shutdown): a replica wedged past the stall
        threshold is failed+abandoned (never waited on), and one whose
        thread died mid-drain has its in-flight batch failed. Returns
        the replicas still draining."""
        now = time.perf_counter()
        remaining = []
        for r in self._live_at_close:
            if r._abandoned:
                continue
            if not r.is_alive():
                if not r._exited_clean and r.current is not None \
                        and hasattr(r.current, "fail"):
                    self._note_batch_failures()
                    r.current.fail(ReplicaLostError(
                        f"serving replica {r.index} thread died "
                        f"during shutdown with this batch in flight; "
                        f"the batch was failed — the request is safe "
                        f"to retry"))
                continue
            mb, t = r.current, r.busy_since
            if mb is not None and t is not None \
                    and now - t > self._stall_s:
                r._abandoned = True
                if hasattr(mb, "fail"):
                    self._note_batch_failures()
                    mb.fail(ReplicaLostError(
                        f"serving replica {r.index} wedged "
                        f"mid-dispatch during shutdown; its in-flight "
                        f"batch was failed — the request is safe to "
                        f"retry"))
                continue
            remaining.append(r)
        return remaining

    def close(self, timeout=None):
        """Stop every live replica after the in-queue batches drain.
        Returns True when every live replica has exited; with a
        ``timeout``, False means some replica is still finishing (its
        batches will complete — call again). The gauge only zeroes on
        a TRUE stop. Idempotent — sentinels are budgeted once, for the
        replicas LIVE at first close. The drain is a poll loop, not a
        bare join: the supervisor is already stopped, so close itself
        must keep judging losses (a replica that wedges past
        ``replica_stall_ms`` or dies MID-DRAIN gets its riders failed
        and stops gating the close), and sentinels are enqueued
        non-blocking as capacity appears — a blocking put on a queue
        whose only consumers are lost would ignore ``timeout``
        forever."""
        if not self._stopped:
            self._sup_stop.set()
            with self._lock:
                self._stopped = True
                self._live_at_close = [
                    r for i, r in enumerate(self.replicas)
                    if self._states[i] == _UP]
                self._stops_pending = len(self._live_at_close)
            if self._supervisor is not None:
                self._supervisor.join(5)
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            remaining = self._judge_losses_at_close()
            while self._stops_pending > 0:
                try:
                    self.batch_queue.put_nowait(_STOP)
                except queue.Full:
                    break
                self._stops_pending -= 1
            if not remaining:
                # no consumer left to need a sentinel: drained (or
                # every drainer lost — the sweep below covers both)
                self._stops_pending = 0
                break
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.005)
        # true stop: nothing will ever drain the queue again. Set the
        # flag BEFORE the final sweep so a dispatch racing this close
        # either lands before the sweep (swept here) or sees the flag
        # and sweeps itself — either way its riders get a typed error,
        # never silence.
        self._closed_done = True
        self._ledger_drop()
        self._fail_queued(
            "serving pool closed with this batch undispatched (no "
            "live replica remained to run it)")
        if self.role == "live":
            # gauge truth on the way out: a closed pool has nothing up,
            # nothing awaiting respawn, nothing newly retired. A DEMOTED
            # pool draining out after a cutover skips this: the promoted
            # pool owns the gauges now
            zero_pool_gauges()
        return True
