"""Continuous micro-batching scheduler: the queueing half of the serving
subsystem. The port's copy of ``paddle_tpu/serving/scheduler.py`` (numpy and
stdlib only): the feeds stay numpy arrays until a replica puts them on its
device.

Concurrent requests are coalesced into padded-bucket micro-batches over a
power-of-two bucket ladder: a request of 3 rows rides the 4-bucket, the pad
rows are zeros, and the waste is accounted (``serving_padded_waste_total``)
rather than hidden. The ladder exists because each replica warms every
bucket's shapes at boot (kernels built, cuBLAS warmed) before it serves, so
no request meets a first-use cost.

Scheduling contract, in order of priority:

1. **A lone request is never starved.** The batcher waits at most
   ``max_wait_ms`` past the FIRST request of a forming batch; when the
   deadline fires the batch dispatches at whatever fill it reached.
2. **A full batch never waits.** As soon as the forming batch reaches
   the top bucket it dispatches immediately; a request that would
   overflow the bucket carries over to start the next batch.
3. **Backpressure is typed.** The request queue is bounded
   (``max_queue``); ``submit`` on a full queue raises
   :class:`QueueFullError` (counted ``outcome="rejected"``) instead of
   stretching the tail latency of every queued request behind it.
4. **Shutdown drains.** ``close()`` stops admission, then processes
   every already-accepted request before the batcher exits — an
   accepted request always gets a result or an error, never silence.

The scheduler is executor-agnostic: it hands formed
:class:`MicroBatch` objects to a ``dispatch`` callable (the server
wires this to the shared replica batch queue; tests wire a fake) and
the batch completes via ``MicroBatch.complete``/``fail`` from whatever
thread ran it. That keeps this module import-light (numpy + stdlib) and
unit-testable without a device.

Distributed tracing (``monitor.trace``, docs/OBSERVABILITY.md): each
request can carry a span tree ``request -> queue_wait -> batch_form ->
dispatch_wait -> execute -> deliver``. The HOT PATH only stamps
per-batch timestamps (``MicroBatch._TRACE_STAMPS``); the tail-sampling
screen runs once per batch at delivery, and only kept traces
materialize spans retroactively — so tracing costs the request path a
handful of attribute stores and compares, not span construction.
"""

import queue
import threading
import time

import numpy as np

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.monitor import trace as _trace
from paddle_tpu_torch.monitor.registry import counter, gauge, histogram
from paddle_tpu_torch.serving.resilience import (
    DeadlineExceededError, OverloadedError,
)

__all__ = [
    "QueueFullError", "ServerClosedError", "ServerDrainingError",
    "PendingResult", "MicroBatch", "MicroBatchScheduler",
    "bucket_ladder", "pick_bucket",
]


class QueueFullError(RuntimeError):
    """``submit`` refused: the bounded request queue is full. The
    caller should shed load or retry after backoff — queueing deeper
    would only move the failure into every request's tail latency."""


class ServerClosedError(RuntimeError):
    """``submit`` refused: the server is shutting down (or never
    started). Already-accepted requests still drain to completion."""


class ServerDrainingError(ServerClosedError):
    """``submit`` refused: the server is DRAINING (``begin_drain()``)
    — a deliberate, bounded wind-down ahead of a restart or deploy,
    not the terminal close. Subclassing :class:`ServerClosedError`
    keeps existing closed-handlers working unchanged, while callers
    that can route traffic (the HTTP front door, a multi-server
    client) read ``retryable`` and retry AGAINST ANOTHER SERVER after
    backoff: this one's already-accepted requests still complete, but
    it will not take new work again."""

    retryable = True


_m_requests = counter(
    "serving_requests_total",
    "Serving requests by outcome: ok (result delivered), rejected "
    "(typed backpressure at submit), error (replica/scheduler failure "
    "delivered as an exception), deadline (request deadline exceeded "
    "at admission/batch-formation/dispatch-wait/delivery), shed "
    "(refused by the adaptive brownout controller)",
    labels=("outcome",))
_m_latency = histogram(
    "serving_request_latency_ms",
    "End-to-end serving request latency in wall ms: submit accept -> "
    "result ready (queue wait + batching wait + execute); p50/p99 "
    "derive from the buckets")
_m_queue_depth = gauge(
    "serving_queue_depth",
    "Requests currently waiting in the serving request queue "
    "(admitted, not yet batched)")
_m_fill = histogram(
    "serving_batch_fill_ratio",
    "Real rows / bucket size per dispatched micro-batch (1.0 = no "
    "padding; persistently low = lower the bucket ladder or raise "
    "max_wait_ms)",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_m_padded = counter(
    "serving_padded_waste_total",
    "Pad rows dispatched to round micro-batches up to their bucket "
    "(compute spent on zeros)")
_m_batches = counter(
    "serving_batches_total",
    "Micro-batches dispatched to the replica pool")


def bucket_ladder(max_batch):
    """The power-of-two bucket ladder ``(1, 2, 4, ..., max_batch)``.
    ``max_batch`` must itself be a power of two — every ladder rung is
    a warmed shape, and a non-power top rung would make the
    ladder's coverage/waste story shape-dependent."""
    enforce(isinstance(max_batch, int) and max_batch >= 1,
            f"max_batch must be a positive int, got {max_batch!r}")
    enforce(max_batch & (max_batch - 1) == 0,
            f"max_batch must be a power of two (one warmed shape per "
            f"ladder rung), got {max_batch}")
    out, b = [], 1
    while b <= max_batch:
        out.append(b)
        b *= 2
    return tuple(out)


def pick_bucket(rows, ladder):
    """Smallest ladder bucket holding ``rows`` rows."""
    enforce(rows >= 1, f"empty request (rows={rows})")
    enforce(rows <= ladder[-1],
            f"request of {rows} rows exceeds the top bucket "
            f"{ladder[-1]}; raise max_batch or split the request")
    for b in ladder:
        if rows <= b:
            return b
    raise AssertionError("unreachable")  # pragma: no cover


class PendingResult:
    """Future-like handle for one submitted request. ``result()``
    blocks until the micro-batch carrying the request completes and
    returns the outputs in fetch order (each with this request's
    leading rows), or raises the delivered error. When tracing is on
    (``monitor.trace``) and this request's trace was KEPT by tail
    sampling (errors, slow/exemplar requests, the head-sampled rate —
    every request at ``sample_rate=1.0``), ``trace_id`` names its span
    tree; None otherwise. The trace is materialized retroactively at
    delivery, so read it after ``result()``."""

    __slots__ = ("_event", "_outs", "_error", "t_done", "trace_id",
                 "_claim", "model_version")

    def __init__(self):
        self._event = threading.Event()
        self._outs = None
        self._error = None
        self.t_done = None          # perf_counter at completion
        self.trace_id = None        # monitor.trace id (kept traces)
        #: the model version of the pool whose replica computed the
        #: result (None where the dispatch target names none): across a
        #: hot-swap cutover the server's current version may already be
        #: the next one
        self.model_version = None
        self._claim = threading.Lock()

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"serving request not completed within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._outs

    def claim(self):
        """Atomically win the right to deliver this request — first
        wins, losers get False and must deliver NOTHING. The claim
        (not ``done()``) is the delivery arbiter: ``complete`` racing
        ``fail`` on another thread would otherwise both pass a
        ``done()`` pre-check and materialize two traces for one
        request, with ``trace_id`` naming whichever finished last —
        possibly an "ok" tree for a request that was delivered the
        error. The winner may do pre-wake work (retroactive trace
        assembly, so ``trace_id`` is readable the moment ``result()``
        returns) and MUST then call ``_deliver(claimed=True)``."""
        return self._claim.acquire(False)

    def _deliver(self, outs=None, error=None, claimed=False):
        """First delivery wins: a failure-path sweep (``MicroBatch.
        fail`` after a partial ``complete``) must not overwrite a
        result a caller may already be reading. Returns whether this
        call delivered."""
        if not claimed and not self.claim():
            return False
        self._outs = outs
        self._error = error
        self.t_done = time.perf_counter()
        self._event.set()
        return True


class _Request:
    __slots__ = ("feeds", "rows", "t_enqueue", "pending", "deadline",
                 "deadline_ms", "trace_attrs")

    def __init__(self, feeds, rows, deadline=None, deadline_ms=None,
                 trace_attrs=None):
        self.feeds = feeds
        self.rows = rows
        self.t_enqueue = time.perf_counter()
        self.pending = PendingResult()
        #: absolute perf_counter second past which this request is
        #: dead (anchored at submit ENTRY — the client's clock), or
        #: None for no deadline; deadline_ms kept for error messages
        self.deadline = deadline
        self.deadline_ms = deadline_ms
        #: caller-attributed trace attrs (the front door stamps the
        #: tenant id here); None — the in-process default — costs the
        #: hot path one attribute store and nothing at delivery
        self.trace_attrs = trace_attrs

    def expired(self, now=None):
        return self.deadline is not None and \
            (time.perf_counter() if now is None else now) >= self.deadline


def _deadline_error(req, stage, now=None):
    now = time.perf_counter() if now is None else now
    return DeadlineExceededError(
        f"request deadline {req.deadline_ms:g}ms exceeded at {stage} "
        f"({(now - req.t_enqueue) * 1e3:.1f}ms since submit); the "
        f"request was failed without consuming further serving work")


def _trace_root_error(t0, attrs=None):
    """Keep a root-only error trace for a request that never joined a
    batch (no stamps, no phases — errors are always kept). ``attrs``
    (e.g. the front door's tenant id) land on the root span. Returns
    the trace id, or None when tracing is off or telemetry failed —
    telemetry must never block delivery of a claimed request."""
    if not _trace._enabled:
        return None
    try:
        ctx = _trace.start_trace("serving/request")
        ctx.t0 = t0
        if attrs:
            ctx.attrs.update(attrs)
        _trace.end_trace(ctx, error=True)
        return ctx.trace_id
    except Exception:
        return None


def _fail_request(r, exc, outcome):
    """Deliver a typed failure to one request OUTSIDE any formed
    micro-batch (queue-time deadline expiry, formation-time drop):
    claims first-wins, keeps a root-only error trace, counts the
    outcome. Returns whether this call delivered."""
    if not r.pending.claim():
        return False
    r.pending.trace_id = _trace_root_error(
        r.t_enqueue, getattr(r, "trace_attrs", None))
    r.pending._deliver(error=exc, claimed=True)
    _m_requests.inc(outcome=outcome)
    return True


class MicroBatch:
    """A formed batch: requests concatenated along dim 0 and
    zero-padded up to ``bucket`` rows. ``feeds`` is the padded
    {name: array} the executor runs; ``complete(outs)`` slices each
    output back to per-request rows and delivers every pending result
    (latency observed per request); ``fail(exc)`` delivers the
    exception to every request instead."""

    #: per-batch trace timestamps, stamped by whatever thread ran the
    #: phase (batcher: form; replica: pick/execute). Per-REQUEST spans
    #: derive from these at tail-sampling KEEP time only
    #: (_assemble_trace) — the hot path pays attribute stores, never
    #: span construction.
    _TRACE_STAMPS = ("t_form", "t_formed", "t_dispatch", "t_pick",
                     "t_exec", "tid_batcher", "tid_replica", "replica")

    def __init__(self, requests, bucket, feed_names):
        self.requests = list(requests)
        self.bucket = int(bucket)
        for n in self._TRACE_STAMPS:
            setattr(self, n, None)
        self.rows = sum(r.rows for r in self.requests)
        #: the version of the pool that ran the batch (its replica stamps
        #: it before ``complete``)
        self.model_version = None
        enforce(self.rows <= self.bucket,
                f"batch of {self.rows} rows formed for bucket "
                f"{self.bucket}")
        self.feed_names = tuple(feed_names)
        self.feeds = {}
        pad = self.bucket - self.rows
        for n in self.feed_names:
            parts = [r.feeds[n] for r in self.requests]
            if pad:
                parts.append(np.zeros((pad,) + parts[0].shape[1:],
                                      dtype=parts[0].dtype))
            # the exact-fit single-request alias is safe: request
            # feeds are already PRIVATE copies (ownership taken at
            # submit in _validate)
            self.feeds[n] = (parts[0] if len(parts) == 1
                             else np.concatenate(parts, axis=0))

    def complete(self, outs):
        """``outs``: sequence of arrays in fetch order, leading dim ==
        bucket. Routes each request its own row slice."""
        now = time.perf_counter()
        outs = [np.asarray(o) for o in outs]
        for o in outs:
            enforce(o.shape[:1] == (self.bucket,),
                    f"micro-batch output leading dim {o.shape[:1]} != "
                    f"bucket {self.bucket}")
        hint = None
        if _trace._enabled and self.requests:
            # the whole trace is RETROACTIVE, and the tail screen runs
            # ONCE per micro-batch: the riders share the execute
            # window, the FIRST rider (FIFO formation) carries the max
            # latency, and only screened-in batches (head-sampled,
            # slow-reservoir/exemplar candidates — a few percent)
            # materialize contexts and assemble spans from the batch
            # stamps, BEFORE the _deliver wakes (the woken clients
            # contend for the GIL the moment the events set). The
            # exemplar force-keeps the slowest request's tree so the
            # SLO histogram's trace_id always dereferences.
            lat0 = (now - self.requests[0].t_enqueue) * 1e3
            hint = _trace.tail_candidate(
                "serving_request_latency_ms", lat0, lat0 / 1e3,
                count=len(self.requests))
        off = 0
        for r in self.requests:
            sliced = [o[off:off + r.rows] for o in outs]
            lat_ms = (now - r.t_enqueue) * 1e3
            # delivery-stage deadline: the result exists, but past the
            # deadline it is useless to the caller — the SLO contract
            # says fail typed, not hand back a late answer
            if r.expired(now):
                self._fail_one(r, _deadline_error(r, "delivery", now),
                               outcome="deadline")
                off += r.rows
                continue
            # claim BEFORE trace assembly: the claim is the first-wins
            # arbiter against a racing fail(), so exactly one thread
            # materializes exactly one trace — and it is the thread
            # whose outcome the client actually receives
            if r.pending.claim():
                if hint is not None:
                    self._finish_trace(r, lat_ms, now, hint=hint)
                r.pending.model_version = self.model_version
                r.pending._deliver(outs=sliced, claimed=True)
                _m_requests.inc(outcome="ok")
                _m_latency.observe(lat_ms)
            off += r.rows

    def _finish_trace(self, r, lat_ms, t_deliver0, error=None,
                      hint=None):
        """Retroactive trace materialization for one delivered request
        of a screened-in batch (``hint`` from the per-batch
        ``tail_candidate``). ``error`` skips the screen entirely —
        errors are always kept."""
        if error is None and hint is None:
            return
        try:
            ctx = _trace.start_trace("serving/request")
            ctx.t0 = r.t_enqueue
            r_attrs = getattr(r, "trace_attrs", None)
            if r_attrs:
                # caller attribution (front-door tenant id): on the
                # ROOT span, so a tenant's p99 is queryable
                # socket-to-device from the kept trees
                ctx.attrs.update(r_attrs)
            if error is None:
                # the per-batch screen already consumed this request's
                # sampling credit — end_trace must not count it again
                ctx.screened = True
                if hint == "sampled":
                    ctx.keep_reason = "sampled"
                _trace.record_exemplar("serving_request_latency_ms",
                                       lat_ms, ctx)
            reason = _trace.end_trace(
                ctx, error=error is not None,
                assemble=lambda c: self._assemble_trace(
                    c, r, t_deliver0,
                    None if error is not None else time.perf_counter()))
            if reason is not None:
                # only a trace that was actually kept is worth handing
                # to the client — a dropped candidate's id dereferences
                # to nothing
                r.pending.trace_id = ctx.trace_id
        except Exception:
            # telemetry must not break delivery: this runs INSIDE the
            # claim->_deliver window, and an escaped exception would
            # strand the claimed request forever (no sweep can re-claim
            # it, so result() would never wake)
            pass

    def _assemble_trace(self, ctx, r, t_deliver0, t_done):
        """Materialize one request's span tree from the batch-level
        timestamps — invoked by ``end_trace`` ONLY for kept traces.
        Each span carries the tid of the thread that actually ran its
        phase (stamped alongside the timestamps), so the cross-thread
        story in the timeline stays truthful even though assembly runs
        on the delivering thread. Phases whose stamps are missing
        (fail before pickup) are simply absent."""
        if self.t_form is not None:
            _trace.record_span(ctx, "serving/queue_wait",
                               r.t_enqueue, self.t_form,
                               tid=self.tid_batcher)
            _trace.record_span(
                ctx, "serving/batch_form", self.t_form, self.t_formed,
                tid=self.tid_batcher,
                attrs={"bucket": self.bucket, "rows": self.rows,
                       "fill": round(self.rows / self.bucket, 4),
                       "pad_rows": self.bucket - self.rows})
        if self.t_pick is not None:
            _trace.record_span(
                ctx, "serving/dispatch_wait",
                self.t_dispatch if self.t_dispatch is not None
                else self.t_pick,
                self.t_pick, tid=self.tid_replica,
                attrs={"replica": self.replica})
        if self.t_exec is not None:
            _trace.record_span(
                ctx, "serving/execute", self.t_pick, self.t_exec,
                tid=self.tid_replica,
                attrs={"replica": self.replica,
                       "bucket": self.bucket})
        if t_done is not None:
            _trace.record_span(ctx, "serving/deliver", t_deliver0,
                               t_done)

    def fail(self, exc):
        """Deliver ``exc`` to every request not already delivered —
        safe to call after a partial ``complete`` (first-wins), so an
        executor failure can always sweep the stragglers."""
        for r in self.requests:
            self._fail_one(r, exc, outcome="error")

    def _fail_one(self, r, exc, outcome):
        """Typed failure for one rider of THIS batch: first-wins claim,
        error trace carrying whatever phase stamps exist (errors are
        always kept), delivery, outcome accounting. Returns whether
        this call delivered."""
        if not r.pending.claim():   # first-wins vs a racing complete()
            return False
        if _trace._enabled:
            self._finish_trace(r, None, None, error=exc)
        r.pending._deliver(error=exc, claimed=True)
        _m_requests.inc(outcome=outcome)
        return True

    def expire_riders(self, now=None, stage="dispatch-wait"):
        """Fail every undelivered rider whose deadline has passed with
        a typed :class:`DeadlineExceededError` (``outcome="deadline"``,
        trace kept) and return the count of undelivered LIVE riders
        remaining. The replica calls this at pickup: a batch whose
        every rider is already dead must never consume a dispatch —
        the batch's run would compute answers nobody can use."""
        now = time.perf_counter() if now is None else now
        live = 0
        for r in self.requests:
            if r.pending.done():
                continue
            if r.expired(now):
                self._fail_one(r, _deadline_error(r, stage, now),
                               outcome="deadline")
            else:
                live += 1
        return live


#: queue sentinel: admission is closed and everything before it has
#: been admitted — the batcher drains up to here, then exits
_STOP = object()


class MicroBatchScheduler:
    """The continuous batcher. ``dispatch(micro_batch)`` is called from
    the batcher thread for every formed batch; it must arrange for
    ``micro_batch.complete``/``fail`` to run eventually (inline is
    fine). ``sample_specs``: optional {feed name: (sample_shape tuple,
    np.dtype)} validated at submit so a malformed request fails ITSELF
    with a precise error instead of poisoning a whole micro-batch."""

    def __init__(self, dispatch, feed_names, max_batch=8,
                 max_wait_ms=5.0, max_queue=256, sample_specs=None,
                 default_deadline_ms=None, shed=None):
        self._dispatch = dispatch
        self._feed_names = tuple(feed_names)
        self._ladder = bucket_ladder(max_batch)
        self._max_bucket = self._ladder[-1]
        enforce(max_wait_ms >= 0, f"max_wait_ms < 0 ({max_wait_ms})")
        self._max_wait = max_wait_ms / 1e3
        enforce(max_queue >= 1, f"max_queue < 1 ({max_queue})")
        self._max_queue = max_queue
        enforce(default_deadline_ms is None
                or float(default_deadline_ms) > 0,
                f"default_deadline_ms must be positive or None, got "
                f"{default_deadline_ms!r}")
        self._default_deadline_ms = (None if default_deadline_ms is None
                                     else float(default_deadline_ms))
        #: resilience.ShedController (or None = shedding off; off is
        #: the default and takes the exact legacy admission path)
        self._shed = shed
        self._q = queue.Queue(maxsize=max_queue + 1)  # +1: _STOP always fits
        self._specs = dict(sample_specs or {})
        self._closed = False
        self._draining = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-batcher")
        self._started = False

    @property
    def ladder(self):
        return self._ladder

    @property
    def draining(self):
        return self._draining

    def begin_drain(self):
        """Flip admission into DRAINING: every subsequent ``submit``
        refuses with the retryable :class:`ServerDrainingError` while
        already-accepted requests keep flowing to completion — the
        reversible first half of a graceful shutdown (``close()`` is
        the terminal second half, and still drains the same way).
        Idempotent; returns whether THIS call flipped the state (False
        when already draining or closed)."""
        with self._lock:
            if self._draining or self._closed:
                return False
            self._draining = True
        return True

    def set_dispatch(self, dispatch):
        """Retarget batch dispatch — the hot-swap cutover primitive
        (serving/swap.py). The batcher reads the target exactly ONCE
        per formed batch (a single GIL-atomic attribute load in
        ``_form_and_dispatch``), so the flip lands at a batch
        boundary: every micro-batch executes WHOLLY on the target it
        was dispatched to, never split across the old and new model
        version. Requests admitted mid-swap simply form batches
        against whichever target is current at their formation
        instant."""
        self._dispatch = dispatch

    def start(self):
        with self._lock:
            if self._closed:
                # a resurrected batcher would have no _STOP coming and
                # the next close() would join it forever
                raise ServerClosedError(
                    "serving scheduler already closed")
            if not self._started:
                self._started = True
                self._thread.start()
        return self

    # -- admission ---------------------------------------------------------
    def _validate_deadline(self, deadline_ms):
        """Argument validation for ``deadline_ms`` — runs with the
        feed validation, BEFORE any server-state check, so a malformed
        argument is a deterministic typed EnforceNotMet whether the
        server is open, closed, or mid-brownout. None means "use the
        configured default"; 0 is a legal already-exhausted budget
        (it expires at admission, with the deadline outcome — useful
        for propagated upstream deadlines)."""
        if deadline_ms is None:
            return self._default_deadline_ms
        enforce(isinstance(deadline_ms,
                           (int, float, np.integer, np.floating))
                and not isinstance(deadline_ms, bool)
                and float(deadline_ms) >= 0,   # also rejects NaN
                f"deadline_ms must be a non-negative number of "
                f"milliseconds, got {deadline_ms!r}")
        return float(deadline_ms)

    def _validate(self, feeds):
        missing = [n for n in self._feed_names if n not in feeds]
        enforce(not missing, f"request missing feeds: {missing}")
        arrs = {n: np.asarray(feeds[n]) for n in self._feed_names}
        rows = None
        for n, a in arrs.items():
            enforce(a.ndim >= 1,
                    f"feed {n!r} must carry a leading batch dim")
            if rows is None:
                rows = int(a.shape[0])
            else:
                enforce(int(a.shape[0]) == rows,
                        f"feed {n!r} rows {a.shape[0]} != {rows} (all "
                        f"feeds of one request share the batch dim)")
            spec = self._specs.get(n)
            if spec is not None:
                shape, dtype = spec
                enforce(tuple(a.shape[1:]) == tuple(shape),
                        f"feed {n!r} sample shape {tuple(a.shape[1:])} "
                        f"!= served model's {tuple(shape)}")
            else:
                dtype = a.dtype
            # the request takes OWNERSHIP here: submit is async, so
            # aliasing the caller's buffer would let a post-submit
            # overwrite change this request's answer in flight
            # (astype/np.array both copy)
            arrs[n] = (a.astype(dtype) if a.dtype != dtype
                       else np.array(a))
        # bucket-fit check runs through pick_bucket for the precise
        # message; rows >= 1 enforced there too
        pick_bucket(rows, self._ladder)
        return arrs, rows

    def submit(self, feeds, deadline_ms=None, trace_attrs=None):
        """Admit one request ({feed name: array with leading batch
        dim}); returns a :class:`PendingResult`. ``deadline_ms``
        bounds the request end to end (None = the scheduler's
        ``default_deadline_ms``; 0 = already exhausted).
        ``trace_attrs`` (optional dict) rides the request's kept trace
        as root-span attributes — the front door stamps the tenant id
        here. Failure precedence, deterministic regardless of server
        state: malformed arguments (bad feed, negative deadline, non-
        dict trace_attrs) raise ``EnforceNotMet`` first; then
        :class:`ServerClosedError` (with the retryable
        :class:`ServerDrainingError` subclass during a drain); then
        :class:`DeadlineExceededError` (admission-stage expiry,
        ``outcome="deadline"``); then
        :class:`~.resilience.OverloadedError` (adaptive shed,
        ``outcome="shed"``); then :class:`QueueFullError`
        (``outcome="rejected"``)."""
        t_adm = time.perf_counter()
        # ALL argument validation before any state check: a malformed
        # request must fail the same typed way on a closed server as
        # on an open one (satellite-pinned precedence)
        arrs, rows = self._validate(feeds)
        deadline_ms = self._validate_deadline(deadline_ms)
        enforce(trace_attrs is None or isinstance(trace_attrs, dict),
                f"trace_attrs must be a dict or None, got "
                f"{type(trace_attrs).__name__}")
        deadline = (None if deadline_ms is None
                    else t_adm + deadline_ms / 1e3)
        with self._lock:
            if self._closed or not self._started:
                raise ServerClosedError(
                    "serving scheduler is closed" if self._closed
                    else "serving scheduler not started")
            if self._draining:
                # draining beats deadline/shed/queue checks: the
                # verdict is about THIS server's lifecycle, and the
                # retryable type tells the caller to take the request
                # elsewhere rather than burn its remaining budget here
                raise ServerDrainingError(
                    "serving scheduler is draining (begin_drain); "
                    "already-accepted requests are completing — retry "
                    "against another server")
            if deadline is not None and \
                    time.perf_counter() >= deadline:
                # admission-stage expiry (deadline_ms=0, or a budget
                # so tight validation ate it): typed, counted, and the
                # trace kept (errors-always-kept) — no queue slot, no
                # batch, no dispatch ever spent on it
                _m_requests.inc(outcome="deadline")
                _trace_root_error(t_adm, trace_attrs)
                raise DeadlineExceededError(
                    f"request deadline {deadline_ms:g}ms already "
                    f"exceeded at admission; nothing was enqueued")
            if self._shed is not None:
                reason = self._shed.should_shed(deadline_ms,
                                                self._q.qsize())
                if reason is not None:
                    _m_requests.inc(outcome="shed")
                    raise OverloadedError(
                        f"request shed at admission ({reason}): "
                        f"queue-wait p50 "
                        f"{self._shed.p50_wait_ms:.1f}ms already "
                        f"exceeds the headroom of a "
                        f"{deadline_ms:g}ms deadline — slow down or "
                        f"route elsewhere until serving_brownout "
                        f"clears")
            if self._q.qsize() >= self._max_queue:
                _m_requests.inc(outcome="rejected")
                raise QueueFullError(
                    f"serving queue full (max_queue={self._max_queue}); "
                    f"shed load or retry after backoff")
            # constructed AFTER admission: a shed request must not pay
            # the Event/Lock allocation, and t_enqueue (the batcher's
            # max_wait deadline anchor AND the latency-metric origin)
            # must not start ticking while submit contends for the lock
            req = _Request(arrs, rows, deadline=deadline,
                           deadline_ms=deadline_ms,
                           trace_attrs=trace_attrs)
            self._q.put_nowait(req)
        _m_queue_depth.set(self._q.qsize())
        return req.pending

    def close(self, timeout=None):
        """Stop admission, drain every accepted request, join the
        batcher. Returns True when the batcher has fully drained and
        exited; with a ``timeout``, False means the join expired while
        the drain is STILL RUNNING (accepted requests will complete —
        call again, or wait on their PendingResults). Idempotent."""
        with self._lock:
            if not self._started:
                self._closed = True
                return True
            already = self._closed
            self._closed = True
        if not already:
            self._q.put(_STOP)      # maxsize has the +1 slot reserved
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- the batching loop -------------------------------------------------
    def _expire_in_queue(self, r):
        """A request found already past deadline as the batcher pulls
        it from the queue: its wait STILL feeds the shed controller —
        the casualties are the strongest overload evidence there is,
        and sampling only survivors would understate p50 exactly when
        shedding matters — then the typed failure."""
        now = time.perf_counter()
        if self._shed is not None:
            self._shed.observe_wait((now - r.t_enqueue) * 1e3)
        _fail_request(r, _deadline_error(r, "batch-formation", now),
                      outcome="deadline")

    def _loop(self):
        carry = None
        while True:
            if carry is not None:
                first, carry = carry, None
            else:
                first = self._q.get()
            if first is _STOP:
                break
            if first.expired():
                # dead on arrival at the batcher: fail it now instead
                # of anchoring a max_wait window on a request nobody
                # can be answered
                self._expire_in_queue(first)
                continue
            batch, rows = [first], first.rows
            wait_deadline = first.t_enqueue + self._max_wait
            saw_stop = False
            while rows < self._max_bucket:
                remaining = wait_deadline - time.perf_counter()
                try:
                    if remaining > 0:
                        nxt = self._q.get(timeout=remaining)
                    else:
                        # past the deadline: absorb whatever is already
                        # waiting (free fill), never wait for more
                        nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    saw_stop = True
                    break
                if nxt.expired():
                    self._expire_in_queue(nxt)
                    continue
                if rows + nxt.rows > self._max_bucket:
                    carry = nxt     # overflow starts the next batch
                    break
                batch.append(nxt)
                rows += nxt.rows
            _m_queue_depth.set(self._q.qsize())
            self._form_and_dispatch(batch, rows)
            if saw_stop:
                # FIFO: everything admitted precedes _STOP, and a carry
                # cannot coexist with saw_stop in one pass — drained
                break
        _m_queue_depth.set(0)

    def _form_and_dispatch(self, requests, rows):
        t_form = time.perf_counter()
        if self._shed is not None:
            # queue-wait observations feed the brownout controller —
            # including the casualties below, whose waits are exactly
            # the overload evidence the controller exists to see
            for r in requests:
                self._shed.observe_wait((t_form - r.t_enqueue) * 1e3)
        live = [r for r in requests if not r.expired(t_form)]
        if len(live) != len(requests):
            # expired riders drop OUT of the forming batch BEFORE
            # padding: the bucket is picked for the survivors, and the
            # dead get their typed error now
            for r in requests:
                if r.expired(t_form):
                    _fail_request(
                        r, _deadline_error(r, "batch-formation",
                                           t_form),
                        outcome="deadline")
            if not live:
                return      # never dispatch a batch with no live rider
            requests, rows = live, sum(r.rows for r in live)
        try:
            bucket = pick_bucket(rows, self._ladder)
            mb = MicroBatch(requests, bucket, self._feed_names)
        except Exception as e:
            # batch FORMATION failed (e.g. two spec-less requests with
            # incompatible trailing shapes hit np.concatenate): the
            # riders get the error (root-only kept trace, no stamps)
            # and the batcher survives — an exception here used to
            # kill the thread, hanging every pending and future
            # request while submit kept accepting
            for r in requests:
                _fail_request(r, e, outcome="error")
            return
        _m_batches.inc()
        _m_fill.observe(rows / bucket)
        if bucket > rows:
            _m_padded.inc(bucket - rows)
        # trace stamps only — four attribute stores per BATCH; the
        # per-request spans assemble from them at keep time
        mb.t_form = t_form
        mb.t_formed = mb.t_dispatch = time.perf_counter()
        mb.tid_batcher = threading.get_ident()
        try:
            self._dispatch(mb)
        except Exception as e:      # dispatch itself failed: the batch
            mb.fail(e)              # must still deliver, not hang
