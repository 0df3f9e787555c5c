"""End-to-end tracing: per-request span trees, the port of
``paddle_tpu/monitor/trace.py`` (stdlib only).

- a **trace** is one causal unit of work (a serving request:
  ``request -> queue_wait -> batch_form -> dispatch_wait -> execute ->
  deliver``), identified by a process-unique ``trace_id``;
- a **span** is one timed phase inside it, carrying ``span``/``parent`` ids
  so the tree survives thread hops: the objects that flow through the
  serving scheduler carry their :class:`TraceContext`, and whichever thread
  finishes a phase records the span against it.

Spans are recorded retroactively (``record_span(ctx, name, t0, t1)``) from
timestamps the hot paths already take. **Tail sampling** keeps the hot path
cheap and every trace worth keeping: errors always, SLO exemplars (the
slowest observation per window beating the reigning one by
``exemplar_factor``), the slowest ``slow_keep`` per rolling
``slow_window_s``, and every N-th of the rest at ``sample_rate``. Kept spans
land in a bounded ring (``spans()``) and, when armed with a directory
(``enable(dirname)``), in ``<dir>/rank<N>.trace.jsonl``.

**Merge**: each rank file opens with a clock-anchor meta line
``{"t":"meta","epoch":wall,"perf":perf_counter}``; span timestamps are raw
``perf_counter``, and :func:`merge_rank_traces` maps every file onto the
shared wall-clock timeline through its anchor, emitting one Chrome/Perfetto
trace JSON (one pid per rank). The file format is the JAX package's, so a
file written by either package merges with the other's.

``install_from_env()`` arms tracing iff ``PADDLE_TRACE_DIR`` is set (knobs
``PADDLE_TRACE_SAMPLE``, ``PADDLE_TRACE_SLOW_KEEP``). The static
Executor opens one ``executor/step`` trace per run (its ``prepare``,
``dispatch`` and ``fetch`` spans), and the flight recorder embeds
``inflight_report`` in its postmortems.
"""

import collections
import itertools
import json
import os
import re
import threading
import time

from paddle_tpu_torch.monitor.registry import counter, gauge

__all__ = [
    "TraceContext", "Tracer", "TRACER", "ENV_DIR",
    "enable", "disable", "is_enabled", "install_from_env",
    "start_trace", "end_trace", "record_span", "record_exemplar",
    "tail_candidate", "stage_note", "adopt_stage", "inflight_report",
    "spans", "flush",
    "merge_rank_traces", "EXEMPLAR_METRICS", "RANK_TRACE_RE",
]

ENV_DIR = "PADDLE_TRACE_DIR"
ENV_SAMPLE = "PADDLE_TRACE_SAMPLE"
ENV_SLOW_KEEP = "PADDLE_TRACE_SLOW_KEEP"

#: rank trace file grammar — the writer and the merge must agree, and a
#: format change must break loudly in one place
RANK_TRACE_RE = re.compile(r"^rank(\d+)\.trace\.jsonl$")

#: the SLO histograms whose slowest observation per window carries an
#: exemplar trace_id (tools/check_metrics.py lints these against the
#: docs catalogue: each must be a documented histogram)
EXEMPLAR_METRICS = ("serving_request_latency_ms", "executor_step_ms")

#: module-level fast-path switch — instrumented code checks this single
#: boolean before touching the tracer at all (the flight_recorder
#: pattern)
_enabled = False

_m_spans = counter(
    "trace_spans_total",
    "Spans recorded into trace trees. For span-recording paths "
    "(executor, prefetch) this is pre-tail-sampling volume — dropped "
    "traces' spans count too; deferred-assembly traces (serving) only "
    "materialize spans when kept, so a dropped request counts its "
    "root alone")
_m_kept = counter(
    "trace_traces_kept_total",
    "Traces kept by tail sampling, by reason: error (a span errored), "
    "exemplar (slowest SLO observation of its window), slow (slowest-"
    "N reservoir), sampled (deterministic every-Nth)",
    labels=("reason",))
_m_dropped = counter(
    "trace_traces_dropped_total",
    "Completed traces discarded by tail sampling (unremarkable and "
    "outside the sample rate)")
_g_exemplar = gauge(
    "slo_exemplar_ms",
    "Slowest observation of each exemplar SLO metric in the current "
    "window, labeled with the trace_id of the span tree that produced "
    "it — the metrics->traces dereference",
    labels=("metric", "trace_id"))

#: spans one trace may hold before the oldest drop (a long-lived
#: pipeline trace must not grow host memory without bound)
_MAX_SPANS_PER_TRACE = 256

#: how long an unadopted stage note may park before adopt_stage drops
#: it: once the staged arrays are garbage-collected their id()s can be
#: reused, and a stale note matched by a recycled id would misattribute
#: its feed_stage phase to an unrelated step. Staging-to-consumption is
#: normally sub-second; a note this old has no live consumer.
_STAGE_NOTE_TTL_S = 60.0

#: PROCESS-GLOBAL trace-id sequence: ids must stay unique across
#: tracer rebuilds (enable(**kwargs) swaps the Tracer but the gauge
#: series, rank files and rings that reference earlier ids live on —
#: a per-instance counter restarting at 1 would reissue them)
_trace_id_seq = itertools.count(1)


class TraceContext:
    """One in-flight trace: the identity (``trace_id``), the open root
    span, and the spans recorded so far. The context object IS the
    propagation currency — it rides on the request/step/batch objects
    across thread boundaries, and any thread may ``record_span``
    against it (deque.append is GIL-atomic)."""

    __slots__ = ("trace_id", "name", "t0", "attrs", "spans", "_seq",
                 "error", "ended", "keep_reason", "screened")

    ROOT = 1

    def __init__(self, trace_id, name, attrs=None):
        self.trace_id = trace_id
        self.name = name
        self.t0 = time.perf_counter()
        self.attrs = dict(attrs) if attrs else {}
        # a plain list, capped at append time (_MAX_SPANS_PER_TRACE):
        # list.append is the cheapest GIL-atomic recorder there is,
        # and span recording IS the tracing hot path
        self.spans = []
        self._seq = itertools.count(self.ROOT + 1)
        self.error = False
        self.ended = False
        #: force-keep with this reason ("exemplar", "sampled") — set
        #: by record_exemplar / the head-gate screen; overrides the
        #: end_trace verdict for everything but errors
        self.keep_reason = None
        #: True when a tail_candidate screen already consumed this
        #: unit's sampling credit (serving's per-batch head-gate):
        #: end_trace must then never run its own sampling branch, or
        #: screened-in riders would be counted — and sampled — twice
        self.screened = False


class _TraceWriter:
    """Appends kept spans as JSON lines to this rank's trace file. The
    FIRST line of every incarnation is the clock-anchor meta — span
    ``ts`` values are raw ``perf_counter`` seconds, and the anchor
    ``(epoch, perf)`` pair is what lets the merge map this process's
    monotonic clock onto the shared wall-clock timeline (a restarted
    rank appends a fresh meta; the merge applies the latest anchor
    seen)."""

    def __init__(self, dirname, rank, flush_every=128):
        os.makedirs(dirname, exist_ok=True)
        self.path = os.path.join(dirname, f"rank{rank}.trace.jsonl")
        self.epoch0 = time.time()
        self.perf0 = time.perf_counter()
        self._flush_every = int(flush_every)
        self._lock = threading.Lock()
        self._buf = [json.dumps({
            "t": "meta", "rank": int(rank), "pid": os.getpid(),
            "epoch": self.epoch0, "perf": self.perf0, "version": 1})]

    def add(self, span_dicts):
        with self._lock:
            self._buf.extend(json.dumps(d, default=str)
                             for d in span_dicts)
            if len(self._buf) >= self._flush_every:
                self._flush_locked()

    def flush(self):
        with self._lock:
            self._flush_locked()

    def _flush_locked(self):
        if not self._buf:
            return
        try:
            with open(self.path, "a") as f:
                f.write("\n".join(self._buf) + "\n")
        except OSError:
            pass        # a full disk must not kill serving/training
        self._buf = []


class Tracer:
    """The span recorder: bounded ring + optional jsonl writer +
    tail-sampling policy + exemplar store + the cross-thread
    stage-note mailbox."""

    def __init__(self, capacity=4096, sample_rate=0.05, slow_keep=8,
                 slow_window_s=60.0, exemplar_factor=1.2):
        self.capacity = int(capacity)
        self.sample_rate = float(sample_rate)
        self._sample_every = (int(round(1.0 / self.sample_rate))
                              if self.sample_rate > 0 else 0)
        self.slow_keep = int(slow_keep)
        self.slow_window_s = float(slow_window_s)
        # a fresh exemplar must beat the reigning one by this factor
        # (not by a hair): under a latency ramp every request is a new
        # max, and per-request exemplar churn would defeat the
        # head-gate — updates then happen log-many times per ramp
        self.exemplar_factor = float(exemplar_factor)
        self._ring = collections.deque(maxlen=self.capacity)
        self._writer = None
        self._lock = threading.Lock()
        self._completed = 0
        self._sampled_kept = 0          # credits spent on batch keeps
        self._slow = []                 # [(dur_s, monotonic kept at)]
        self._slow_floor = None         # unlocked pre-screen (None =
        self._slow_prune_at = 0.0       # reservoir not full)
        self._slow_kept = 0             # keeps spent this window
        self._slow_cap_reset = 0.0
        self._exemplars = {}            # metric -> (ms, trace_id, mono)
        self._stage_notes = collections.deque(maxlen=64)
        self._stage_seq = itertools.count()
        self._tls = threading.local()
        # the id prefix makes trace ids unique across ranks and
        # incarnations (rank from the launcher env, pid per process)
        rank = os.environ.get("PADDLE_TRAINER_ID", "0")
        rank = rank if rank.isdigit() else "0"
        self._prefix = f"{rank}-{os.getpid():x}-"
        self.rank = int(rank)

    # -- recording (hot path) ----------------------------------------------
    def start_trace(self, name, attrs=None, current=False):
        """Open a trace; the returned context is the propagation
        handle. ``current=True`` additionally marks it as this
        thread's in-flight trace, which is what a postmortem embeds
        (``inflight_report``) — use it for thread-resident work like
        the executor step, not for requests that complete on another
        thread."""
        ctx = TraceContext(self._prefix + format(next(_trace_id_seq),
                                                 "x"), name, attrs)
        if current:
            self._tls.current = ctx
        return ctx

    def record_span(self, ctx, name, t0, t1, parent=None, tid=None,
                    kind="span", status="ok", attrs=None):
        """Record one completed phase ``[t0, t1]`` (perf_counter
        seconds) into ``ctx``'s tree; returns the span id (usable as a
        later span's ``parent``). Defaults: parented to the root,
        attributed to the calling thread.

        Hot path: the span is held as a TUPLE — dicts (and the
        span-count metric) materialize once per trace at ``end_trace``,
        and only kept traces pay the dict conversion at all. Tail
        sampling's whole point is that recording must cost less than
        the phases it measures. A trace past ``_MAX_SPANS_PER_TRACE``
        keeps its FIRST spans and drops the rest (long-lived pipeline
        traces must not grow host memory without bound)."""
        sid = next(ctx._seq)
        if status != "ok":
            ctx.error = True
        if len(ctx.spans) < _MAX_SPANS_PER_TRACE:
            ctx.spans.append(
                (sid, ctx.ROOT if parent is None else parent,
                 name, t0, t1 - t0,
                 threading.get_ident() if tid is None else tid,
                 kind, status, attrs))
        return sid

    @staticmethod
    def _span_dict(trace_id, tup):
        sid, parent, name, t0, dur, tid, kind, status, attrs = tup
        d = {"t": "span", "trace": trace_id, "span": sid,
             "parent": parent, "name": name, "ts": t0, "dur": dur,
             "tid": tid, "kind": kind, "status": status}
        if attrs:
            d["attrs"] = dict(attrs)
        return d

    def end_trace(self, ctx, error=False, assemble=None):
        """Close the root span and run the tail-sampling decision over
        the completed tree: kept trees go to the ring (and the rank
        file when armed), dropped trees vanish. Idempotent per
        context; callers already serialize the end (the serving
        first-delivery-wins event, the executor's single thread), so
        the flag needs no lock. The common verdict — drop — takes NO
        lock at all: the slow-reservoir floor is read unlocked (a
        stale read at worst takes the lock for nothing or skips one
        borderline candidate), and the sampling counter tolerates the
        benign increment race.

        ``assemble(ctx)`` is the DEFERRED-assembly hook: a caller that
        only stamped timestamps on its hot path (the serving
        scheduler/replica) passes a callable that records the span
        tree from those stamps — invoked ONLY when the verdict keeps
        the trace, so the dropped majority never pays span
        construction at all."""
        now = time.perf_counter()
        if ctx.ended:
            return None
        ctx.ended = True
        dur = now - ctx.t0
        err = error or ctx.error
        if getattr(self._tls, "current", None) is ctx:
            self._tls.current = None
        if err:
            reason = "error"
        elif ctx.keep_reason:
            reason = ctx.keep_reason
        else:
            reason = None
            floor = self._slow_floor
            if floor is None or dur > floor \
                    or time.monotonic() > self._slow_prune_at:
                with self._lock:
                    if self._is_slow_locked(dur):
                        reason = "slow"
            if reason is None and not ctx.screened:
                self._completed += 1
                if self._sample_every and self._sampled_kept < \
                        self._completed // self._sample_every:
                    self._sampled_kept += 1
                    reason = "sampled"
        if reason is None:
            _m_spans.inc(len(ctx.spans) + 1)    # +1: the root
            _m_dropped.inc()
            return None
        if assemble is not None:
            try:
                assemble(ctx)
            except Exception:   # telemetry must not break delivery
                pass
        ctx.spans.append(
            (ctx.ROOT, None, ctx.name, ctx.t0, dur,
             threading.get_ident(), "root",
             "error" if err else "ok", ctx.attrs or None))
        _m_spans.inc(len(ctx.spans))
        _m_kept.inc(reason=reason)
        kept = [self._span_dict(ctx.trace_id, t) for t in ctx.spans]
        with self._lock:
            self._ring.extend(kept)
        w = self._writer
        if w is not None:
            w.add(kept)
        return reason

    def _is_slow_locked(self, dur):
        """Slowest-``slow_keep`` reservoir over a rolling window: a
        trace qualifies while the reservoir has room or its duration
        beats the reservoir's minimum. The very first traces of a
        window all qualify — warm-up is the honest cost of not knowing
        the distribution yet. ``_slow_floor`` caches the full
        reservoir's minimum so the drop path can pre-screen without
        the lock (None = reservoir not full, everything qualifies).

        Slow keeps are BUDGETED at ``2 * slow_keep`` per window: under
        a latency ramp (a draining burst, a saturating queue) every
        request is a new top-N-so-far, and an unbudgeted reservoir
        would silently turn tail sampling into keep-everything — the
        exact hot-path cost the sampling exists to avoid. Errors and
        exemplars never draw from this budget."""
        now = time.monotonic()
        if now > self._slow_cap_reset:
            self._slow_cap_reset = now + self.slow_window_s
            self._slow_kept = 0
        if self._slow_kept >= 2 * self.slow_keep:
            return False
        horizon = now - self.slow_window_s
        if self._slow and (now > self._slow_prune_at or
                           min(t for _d, t in self._slow) < horizon):
            self._slow = [(d, t) for d, t in self._slow
                          if t >= horizon]
            if len(self._slow) < self.slow_keep:
                self._slow_floor = None
        # the unlocked drop path re-checks this deadline so a stale
        # floor from a faster era cannot suppress slow-keeps forever
        self._slow_prune_at = now + self.slow_window_s / 2.0
        if len(self._slow) < self.slow_keep:
            self._slow.append((dur, now))
            self._slow_floor = None if len(self._slow) < \
                self.slow_keep else min(d for d, _t in self._slow)
            self._slow_kept += 1
            return True
        floor = min(self._slow)
        if dur > floor[0]:
            self._slow.remove(floor)
            self._slow.append((dur, now))
            self._slow_floor = min(d for d, _t in self._slow)
            self._slow_kept += 1
            return True
        return False

    def tail_candidate(self, metric, value_ms, dur_s, count=1):
        """The head-gate for stamp-based hot paths (the serving
        delivery loop): decide in a handful of UNLOCKED compares
        whether this completed unit of work could possibly be kept —
        head-sampled (the counter consumed here; mark the context
        ``keep_reason="sampled"``), a slow-reservoir candidate, or an
        exemplar candidate for ``metric``. Non-candidates pay nothing
        further: no context, no spans, no verdict — which is what
        keeps tracing unmeasurably cheap at full request rate. A
        candidate that loses the subsequent LOCKED check (borderline
        slow/exemplar) is simply dropped by ``end_trace``; the races
        are benign sampling skew.

        The serving scheduler screens once per MICRO-BATCH (its
        riders share the execute window, and the first rider carries
        the max latency), passing ``count`` = riders so the sampling
        cadence and drop accounting stay per-request.

        Returns "sampled" | "candidate" | None."""
        self._completed += count    # benign race: sampling skew only
        if self._sample_every and self._sampled_kept < \
                self._completed // self._sample_every:
            # kept-vs-target credits: keeping a whole batch spends
            # `count` credits, so the long-run kept-REQUEST fraction
            # stays ~sample_rate whatever the batch sizes
            self._sampled_kept += count
            return "sampled"
        now_m = time.monotonic()
        floor = self._slow_floor
        if floor is None or now_m > self._slow_prune_at \
                or now_m > self._slow_cap_reset:
            return "candidate"
        if dur_s > floor and self._slow_kept < 2 * self.slow_keep:
            # the keep budget gates candidacy too: under a latency
            # ramp EVERY request beats the floor, and screening them
            # in just to drop them at the locked check would put the
            # full trace cost back on the hot path
            return "candidate"
        cur = self._exemplars.get(metric)
        if cur is None or value_ms > cur[0] * self.exemplar_factor \
                or now_m - cur[2] > self.slow_window_s:
            return "candidate"
        _m_dropped.inc(count)
        return None

    # -- exemplars ---------------------------------------------------------
    def record_exemplar(self, metric, value_ms, ctx):
        """Remember ``ctx`` as ``metric``'s exemplar if this
        observation beats the reigning one by ``exemplar_factor`` (or
        the previous exemplar aged out of the window), publish it as
        ``slo_exemplar_ms`` (the superseded trace_id's series is
        REMOVED — label cardinality stays one per metric), and
        force-keep the trace so the dereference never dangles.
        Returns whether this observation became the exemplar."""
        # lock-free fast path: the common observation is NOT a new
        # exemplar (dict read is GIL-atomic; a raced stale read at
        # worst re-checks under the lock below)
        now = time.monotonic()
        cur = self._exemplars.get(metric)
        if cur is not None and now - cur[2] <= self.slow_window_s \
                and value_ms <= cur[0] * self.exemplar_factor:
            return False
        trace_id = ctx.trace_id if isinstance(ctx, TraceContext) \
            else str(ctx)
        with self._lock:
            cur = self._exemplars.get(metric)
            if cur is not None and now - cur[2] <= self.slow_window_s \
                    and value_ms <= cur[0] * self.exemplar_factor:
                return False
            if cur is not None and cur[1] != trace_id:
                _g_exemplar.remove(metric=metric, trace_id=cur[1])
            self._exemplars[metric] = (float(value_ms), trace_id, now)
            # publish INSIDE the lock: an unlocked set racing a
            # concurrent supersession could resurrect a removed
            # trace_id series forever (the gauge's own lock nests
            # under this one; nothing takes them in reverse order)
            _g_exemplar.set(float(value_ms), metric=metric,
                            trace_id=trace_id)
        if isinstance(ctx, TraceContext):
            ctx.keep_reason = "exemplar"
        return True

    def exemplars(self):
        """{metric: (value_ms, trace_id)} — the current window's
        slowest observation per exemplar metric."""
        with self._lock:
            return {m: (v, t) for m, (v, t, _at) in
                    self._exemplars.items()}

    # -- cross-thread stage mailbox ----------------------------------------
    def stage_note(self, name, t0, t1, tid=None, attrs=None,
                   key=None):
        """A producer-thread phase (feed staging in a prefetch worker)
        whose consuming trace does not exist yet: park it here; the
        consumer adopts it into its trace with ``adopt_stage``.
        ``key`` is the set of ``id()``s of the staged arrays — the
        identity the consuming step matches against, so a note can
        only ever land in the tree of the step that actually consumes
        those arrays."""
        d = dict(attrs or {})
        d["stage_seq"] = next(self._stage_seq)
        # the trailing parked-at stamp (NOT t1, which callers may
        # backfill) is what adopt_stage ages the note out by
        note = (name, t0, t1,
                threading.get_ident() if tid is None else tid, d,
                frozenset(key) if key is not None else None,
                time.perf_counter())
        # locked: adopt_stage iterates this deque from the consumer
        # thread while prefetch workers append — an unlocked append
        # mid-iteration raises "deque mutated during iteration" there
        with self._lock:
            self._stage_notes.append(note)

    def adopt_stage(self, ctx, match=None):
        """Adopt a parked stage note as a span of ``ctx`` — the
        cross-thread parenting move: the span executed on the worker
        thread (its tid says so) but belongs to this step's tree.
        With ``match`` (the consuming step's feed-array ids) only the
        note whose staged arrays THIS step consumes is adopted —
        an interleaved manually-fed step can neither steal a
        pipeline's note nor shift later adoptions off by one. Without
        ``match``, FIFO. Returns the span id or None."""
        with self._lock:
            # age out notes nobody adopted (an abandoned pipeline):
            # the staged arrays are gone and CPython may reuse their
            # ids, so a lingering note could otherwise be adopted into
            # an unrelated later step's tree. FIFO by parked-at, so
            # popping stale heads bounds the lingering window.
            horizon = time.perf_counter() - _STAGE_NOTE_TTL_S
            while self._stage_notes and self._stage_notes[0][6] < horizon:
                self._stage_notes.popleft()
            if match is None:
                try:
                    note = self._stage_notes.popleft()
                except IndexError:
                    return None
            else:
                note = None
                for n in self._stage_notes:
                    if n[5] is not None and not n[5].isdisjoint(match):
                        note = n
                        break
                if note is None:
                    return None
                self._stage_notes.remove(note)
        name, t0, t1, tid, attrs, _key, _parked = note
        return self.record_span(ctx, name, t0, t1, tid=tid,
                                attrs=attrs)

    # -- inspection --------------------------------------------------------
    def inflight_report(self):
        """The calling thread's in-flight trace (opened with
        ``current=True``) as a postmortem-embeddable dict, or None.
        This is what lets ``anomaly.trip()`` name the PHASE a dying
        step was in, not just the step number."""
        ctx = getattr(self._tls, "current", None)
        if ctx is None or ctx.ended:
            return None
        return {"trace_id": ctx.trace_id, "root": ctx.name,
                "age_s": round(time.perf_counter() - ctx.t0, 6),
                "attrs": dict(ctx.attrs),
                "spans": [self._span_dict(ctx.trace_id, t)
                          for t in list(ctx.spans)[-32:]]}

    def spans(self, trace_id=None):
        """Kept spans from the ring (newest last), optionally filtered
        to one trace. Snapshot under the lock — a replica thread
        extending the ring mid-iteration would otherwise raise."""
        with self._lock:
            out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s["trace"] == trace_id]
        return out

    # -- arming ------------------------------------------------------------
    def install(self, dirname):
        """Arm the jsonl writer under ``dirname`` for this rank. An
        already-armed writer is flushed before being replaced — a
        re-arm (enable(d) twice, or install_from_env after a manual
        enable) must not drop its buffered span lines on the floor."""
        rank = os.environ.get("PADDLE_TRAINER_ID", "0")
        old = self._writer
        if old is not None:
            old.flush()
        self._writer = _TraceWriter(
            dirname, rank if rank.isdigit() else "0")
        return self._writer.path

    def flush(self):
        w = self._writer
        if w is not None:
            w.flush()


#: process-wide default tracer the instrumented layers feed
TRACER = Tracer()

_atexit_registered = False


def enable(dirname=None, **kwargs):
    """Turn tracing on. ``kwargs`` (capacity / sample_rate / slow_keep
    / slow_window_s / exemplar_factor) rebuild the tracer with that
    policy — the installed writer and the exemplar bookkeeping CARRY
    OVER (an armed worker adjusting its sampling policy must not
    silently stop streaming to its rank file, and the reigning
    ``slo_exemplar_ms`` series must stay removable when superseded).
    With a ``dirname`` kept traces also stream to
    ``<dirname>/rank<N>.trace.jsonl`` (flushed at exit)."""
    global _enabled, TRACER, _atexit_registered
    if kwargs:
        old = TRACER
        TRACER = Tracer(**kwargs)
        TRACER._writer = old._writer
        TRACER._exemplars = dict(old._exemplars)
    _enabled = True
    if dirname:
        TRACER.install(dirname)
        if not _atexit_registered:
            import atexit
            _atexit_registered = True
            atexit.register(flush)
    return TRACER


def disable():
    """Turn tracing off, flush any buffered file lines (so a test or
    an operator can read the rank file immediately), and drop parked
    stage notes — a note surviving a disable/enable cycle would be
    adopted by an unrelated later step."""
    global _enabled
    _enabled = False
    with TRACER._lock:
        TRACER._stage_notes.clear()
    TRACER.flush()


def is_enabled():
    return _enabled


def install_from_env(env=None):
    """Worker-side hookup: arm tracing iff the launcher exported
    PADDLE_TRACE_DIR (sampling knobs PADDLE_TRACE_SAMPLE /
    PADDLE_TRACE_SLOW_KEEP ride the same env). Returns the tracer or
    None."""
    env = os.environ if env is None else env
    d = env.get(ENV_DIR)
    if not d:
        return None
    kw = {}
    # malformed knobs fall back to defaults: this runs inside
    # auto_checkpoint's startup wiring, and the tracing stack is
    # never-fail — a typo'd sample rate must not kill the worker
    if env.get(ENV_SAMPLE):
        try:
            kw["sample_rate"] = float(env[ENV_SAMPLE])
        except ValueError:
            pass
    if env.get(ENV_SLOW_KEEP):
        try:
            kw["slow_keep"] = int(env[ENV_SLOW_KEEP])
        except ValueError:
            pass
    return enable(d, **kw)


# module-level conveniences over the default tracer (mirror the
# flight_recorder surface; instrumented code guards on `_enabled`)
def start_trace(name, attrs=None, current=False):
    return TRACER.start_trace(name, attrs=attrs, current=current)


def end_trace(ctx, error=False, assemble=None):
    return TRACER.end_trace(ctx, error=error, assemble=assemble)


def record_span(ctx, name, t0, t1, parent=None, tid=None, kind="span",
                status="ok", attrs=None):
    return TRACER.record_span(ctx, name, t0, t1, parent=parent,
                              tid=tid, kind=kind, status=status,
                              attrs=attrs)


def tail_candidate(metric, value_ms, dur_s, count=1):
    return TRACER.tail_candidate(metric, value_ms, dur_s, count)


def record_exemplar(metric, value_ms, ctx):
    return TRACER.record_exemplar(metric, value_ms, ctx)


def stage_note(name, t0, t1, tid=None, attrs=None, key=None):
    return TRACER.stage_note(name, t0, t1, tid=tid, attrs=attrs,
                             key=key)


def adopt_stage(ctx, match=None):
    return TRACER.adopt_stage(ctx, match=match)


def inflight_report():
    return TRACER.inflight_report()


def spans(trace_id=None):
    return TRACER.spans(trace_id=trace_id)


def flush():
    TRACER.flush()


# -- cross-rank merge (launcher side, stdlib-only) ---------------------------
def _read_rank_file(path):
    """Yield (epoch_ts, span_dict) for every clock-aligned span line.
    Span ``ts`` values are raw perf_counter seconds; the latest meta
    anchor seen maps them onto the wall-clock timeline (a restarted
    incarnation appends a fresh anchor mid-file). Torn trailing lines
    (a killed rank mid-write) and pre-anchor spans are skipped — merge
    is a best-effort evidence reader, like the postmortem path."""
    anchor = None
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            try:
                d = json.loads(ln)
            except ValueError:
                continue
            if d.get("t") == "meta":
                anchor = (float(d["epoch"]), float(d["perf"]))
            elif d.get("t") == "span" and anchor is not None:
                yield anchor[0] + (float(d["ts"]) - anchor[1]), d


def merge_rank_traces(traces_dir, out_path=None):
    """Merge every ``rank<N>.trace.jsonl`` under ``traces_dir`` into
    ONE Chrome-trace/Perfetto JSON (default ``<parent>/trace.json``):
    one pid per rank, thread metadata, X slices carrying
    trace/span/parent ids + attrs in ``args``, and flow arrows for
    cross-thread parent->child hops (the batcher->replica and
    prefetch-worker->step hand-offs). Clock alignment: each rank's
    monotonic timestamps are mapped through its own (epoch, perf)
    anchor, so ranks with arbitrary perf_counter origins land on one
    shared timeline. Returns the output path, or None when there is
    nothing to merge."""
    try:
        names = sorted(os.listdir(traces_dir))
    except OSError:
        return None
    files = [(int(m.group(1)), os.path.join(traces_dir, fn))
             for fn in names for m in [RANK_TRACE_RE.match(fn)] if m]
    if not files:
        return None
    all_spans = []                  # (rank, epoch_ts, span_dict)
    for rank, path in files:
        try:
            for ets, d in _read_rank_file(path):
                all_spans.append((rank, ets, d))
        except OSError:
            continue
    if not all_spans:
        return None
    t0 = min(ets for _r, ets, _d in all_spans)
    events = []
    tid_map = {}                    # (rank, raw tid) -> small int
    index = {}                      # (rank, trace, span) -> (ts_us, tid)
    ranks = sorted({r for r, _e, _d in all_spans})
    for r in ranks:
        events.append({"name": "process_name", "ph": "M", "pid": r,
                       "args": {"name": f"rank {r}"}})
        events.append({"name": "process_sort_index", "ph": "M",
                       "pid": r, "args": {"sort_index": r}})
    for rank, ets, d in all_spans:
        key = (rank, d.get("tid"))
        if key not in tid_map:
            tid_map[key] = len([k for k in tid_map if k[0] == rank])
            events.append({"name": "thread_name", "ph": "M",
                           "pid": rank, "tid": tid_map[key],
                           "args": {"name":
                                    f"thread {d.get('tid')}"}})
        ts_us = (ets - t0) * 1e6
        args = {"trace": d.get("trace"), "span": d.get("span"),
                "parent": d.get("parent"),
                "status": d.get("status", "ok")}
        args.update(d.get("attrs") or {})
        events.append({
            "name": d.get("name", "?"), "ph": "X",
            "cat": d.get("kind", "span"), "ts": ts_us,
            "dur": float(d.get("dur", 0.0)) * 1e6,
            "pid": rank, "tid": tid_map[key], "args": args,
        })
        index[(rank, d.get("trace"), d.get("span"))] = \
            (ts_us, tid_map[key])
    # flow arrows: a span whose PARENT ran on a different thread is a
    # causal hand-off the timeline should draw (contexts never cross
    # ranks, so flows stay within one pid)
    flow_id = 0
    for rank, ets, d in all_spans:
        parent = d.get("parent")
        if parent is None:
            continue
        src = index.get((rank, d.get("trace"), parent))
        child_tid = tid_map[(rank, d.get("tid"))]
        if src is None or src[1] == child_tid:
            continue
        flow_id += 1
        ts_us = (ets - t0) * 1e6
        events.append({"name": "handoff", "ph": "s", "cat": "flow",
                       "id": flow_id, "ts": src[0], "pid": rank,
                       "tid": src[1]})
        events.append({"name": "handoff", "ph": "f", "bp": "e",
                       "cat": "flow", "id": flow_id, "ts": ts_us,
                       "pid": rank, "tid": child_tid})
    if out_path is None:
        out_path = os.path.join(
            os.path.dirname(os.path.abspath(traces_dir)), "trace.json")
    tmp = f"{out_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, out_path)
    return out_path


def main(argv=None):      # pragma: no cover - thin CLI over the merge
    import argparse
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.monitor.trace",
        description="merge per-rank trace jsonl files into one "
                    "Perfetto/Chrome trace JSON")
    ap.add_argument("traces_dir",
                    help="directory holding rank<N>.trace.jsonl files "
                         "(the launcher writes <log_dir>/traces)")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: <parent>/trace.json)")
    args = ap.parse_args(argv)
    out = merge_rank_traces(args.traces_dir, args.out)
    if out is None:
        print("no rank trace files found")
        return 1
    print(out)
    return 0


if __name__ == "__main__":        # pragma: no cover
    raise SystemExit(main())
