"""Per-request span trees for the serving scheduler: the part of
``paddle_tpu/monitor/trace.py`` that ``serving/scheduler.py`` calls
(``_enabled``, ``start_trace``, ``end_trace``, ``record_span``,
``record_exemplar``, ``tail_candidate``), with ``enable``/``disable`` and
``spans`` to arm and read it.

Tracing is disarmed by default, as in the JAX package: the scheduler checks
the module-level ``_enabled`` before touching the tracer at all, so a
disarmed server pays one boolean read per batch. Armed, a request's span
tree (``request -> queue_wait -> batch_form -> dispatch_wait -> execute ->
deliver``) is assembled retroactively from the batch's timestamps when the
tail-sampling verdict keeps it: errors always, the slowest observation of
each exemplar metric so far, and every N-th of the rest at ``sample_rate``.
Kept spans land in an in-process ring (``spans()``).

The constructor, ``enable`` and ``start_trace`` take the JAX package's
parameters in its order. Not ported yet: the per-rank jsonl writer
(``enable(dirname=)``) and the slowest-N reservoir over a rolling window
(``slow_keep``, ``slow_window_s``, ``exemplar_factor``), which raise
:class:`EnforceNotMet` naming ROADMAP queue 1 item 8 when asked for (their
defaults are taken; the port keeps an exemplar whenever an observation is
the slowest so far); the cross-rank merge, the ``slo_exemplar_ms`` gauge
and the trace metrics, stage notes and the executor's step traces (item
10).
"""

import collections
import itertools
import os
import threading
import time

from paddle_tpu_torch.core.enforce import EnforceNotMet

__all__ = ["TraceContext", "Tracer", "enable", "disable", "is_enabled",
           "start_trace", "end_trace", "record_span", "record_exemplar",
           "tail_candidate", "spans"]

#: module-level fast-path switch, read by instrumented code before it
#: touches the tracer
_enabled = False

#: process-global trace ids: unique across tracer rebuilds (enable())
_trace_id_seq = itertools.count(1)


class TraceContext:
    """One in-flight trace: its id, the root's name, start and attrs, and
    the spans recorded so far (tuples; dicts only for kept traces)."""

    __slots__ = ("trace_id", "name", "t0", "attrs", "spans", "_seq",
                 "error", "ended", "keep_reason", "screened")

    ROOT = 1

    def __init__(self, trace_id, name, attrs=None):
        self.trace_id = trace_id
        self.name = name
        self.t0 = time.perf_counter()
        self.attrs = dict(attrs) if attrs else {}
        self.spans = []
        self._seq = itertools.count(self.ROOT + 1)
        self.error = False
        self.ended = False
        #: force-keep with this reason ("exemplar", "sampled")
        self.keep_reason = None
        #: a tail_candidate screen already spent this unit's sampling
        #: credit: end_trace must not sample it again
        self.screened = False


class Tracer:
    """The span recorder: bounded ring, tail-sampling policy, exemplars."""

    def __init__(self, capacity=4096, sample_rate=0.05, slow_keep=8,
                 slow_window_s=60.0, exemplar_factor=1.2):
        slow = {"slow_keep": (slow_keep, 8),
                "slow_window_s": (slow_window_s, 60.0),
                "exemplar_factor": (exemplar_factor, 1.2)}
        asked = [f"{k}={v!r}" for k, (v, default) in slow.items()
                 if v != default]
        if asked:
            raise EnforceNotMet(
                f"Tracer({', '.join(asked)}): the slow reservoir is not "
                "ported yet (ROADMAP queue 1 item 8); the port takes only "
                "its defaults")
        self.capacity = int(capacity)
        self.sample_rate = float(sample_rate)
        self._sample_every = (int(round(1.0 / self.sample_rate))
                              if self.sample_rate > 0 else 0)
        self.slow_keep = int(slow_keep)
        self.slow_window_s = float(slow_window_s)
        self.exemplar_factor = float(exemplar_factor)
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._completed = 0
        self._sampled_kept = 0
        self._exemplars = {}            # metric -> slowest ms so far
        self._prefix = f"{os.getpid():x}-"
        self._tls = threading.local()

    def _sample(self, count):
        """Every N-th unit by kept-vs-target credits (benign races under
        concurrent callers skew the sampling only)."""
        self._completed += count
        if self._sample_every and self._sampled_kept < \
                self._completed // self._sample_every:
            self._sampled_kept += count
            return True
        return False

    def start_trace(self, name, attrs=None, current=False):
        """Open a trace. ``current=True`` also makes it this thread's
        in-flight trace (``_tls.current``, as in the JAX package) until it
        ends: for work that stays on one thread, not for requests
        completed on another."""
        ctx = TraceContext(self._prefix + format(next(_trace_id_seq), "x"),
                           name, attrs)
        if current:
            self._tls.current = ctx
        return ctx

    def record_span(self, ctx, name, t0, t1, parent=None, tid=None,
                    kind="span", status="ok", attrs=None):
        """Record the completed phase [t0, t1] (perf_counter seconds) into
        ``ctx``; returns its span id. Defaults: parented to the root, on
        the calling thread."""
        sid = next(ctx._seq)
        if status != "ok":
            ctx.error = True
        ctx.spans.append((sid, ctx.ROOT if parent is None else parent, name,
                          t0, t1 - t0,
                          threading.get_ident() if tid is None else tid,
                          kind, status, attrs))
        return sid

    def end_trace(self, ctx, error=False, assemble=None):
        """Close the root and decide: a kept tree (``assemble(ctx)`` first
        records its spans) goes to the ring and the keep reason is
        returned; a dropped one returns None. Idempotent per context."""
        if ctx.ended:
            return None
        ctx.ended = True
        if getattr(self._tls, "current", None) is ctx:
            self._tls.current = None
        dur = time.perf_counter() - ctx.t0
        err = error or ctx.error
        if err:
            reason = "error"
        elif ctx.keep_reason:
            reason = ctx.keep_reason
        elif not ctx.screened and self._sample(1):
            reason = "sampled"
        else:
            return None
        if assemble is not None:
            try:
                assemble(ctx)
            except Exception:   # telemetry must not break delivery
                pass
        ctx.spans.append((ctx.ROOT, None, ctx.name, ctx.t0, dur,
                          threading.get_ident(), "root",
                          "error" if err else "ok", ctx.attrs or None))
        kept = []
        for sid, parent, name, t0, d, tid, kind, status, attrs in ctx.spans:
            rec = {"trace": ctx.trace_id, "span": sid, "parent": parent,
                   "name": name, "ts": t0, "dur": d, "tid": tid,
                   "kind": kind, "status": status}
            if attrs:
                rec["attrs"] = dict(attrs)
            kept.append(rec)
        with self._lock:
            self._ring.extend(kept)
        return reason

    def tail_candidate(self, metric, value_ms, dur_s, count=1):
        """The per-batch head gate of the serving delivery loop: "sampled"
        (the sampling credit spent here for ``count`` riders), "candidate"
        (it could become the metric's exemplar) or None (drop it, no
        context built)."""
        if self._sample(count):
            return "sampled"
        if value_ms > self._exemplars.get(metric, -1.0):
            return "candidate"
        return None

    def record_exemplar(self, metric, value_ms, ctx):
        """Force-keep ``ctx`` when ``value_ms`` is the slowest observation
        of ``metric`` so far."""
        with self._lock:
            if value_ms > self._exemplars.get(metric, -1.0):
                self._exemplars[metric] = value_ms
                if ctx.keep_reason is None:
                    ctx.keep_reason = "exemplar"

    def spans(self, trace_id=None):
        with self._lock:
            return [s for s in self._ring
                    if trace_id is None or s["trace"] == trace_id]


TRACER = Tracer()


def enable(dirname=None, **kwargs):
    """Arm tracing. ``kwargs`` (``capacity``, ``sample_rate``, the slow
    reservoir's defaults) build a fresh tracer with that policy, keeping
    the exemplars, as in the JAX package; without them the current tracer
    stays. A ``dirname`` (the per-rank jsonl writer) raises: it is not
    ported yet (ROADMAP queue 1 item 8)."""
    global TRACER, _enabled
    if dirname:
        raise EnforceNotMet(
            f"trace.enable(dirname={dirname!r}): the trace file writer is "
            "not ported yet (ROADMAP queue 1 item 8); spans stay in the "
            "in-process ring (spans())")
    if kwargs:
        old = TRACER
        TRACER = Tracer(**kwargs)
        TRACER._exemplars = dict(old._exemplars)
    _enabled = True
    return TRACER


def disable():
    global _enabled
    _enabled = False


def is_enabled():
    return _enabled


def start_trace(name, attrs=None, current=False):
    return TRACER.start_trace(name, attrs=attrs, current=current)


def end_trace(ctx, error=False, assemble=None):
    return TRACER.end_trace(ctx, error=error, assemble=assemble)


def record_span(ctx, name, t0, t1, parent=None, tid=None, kind="span",
                status="ok", attrs=None):
    return TRACER.record_span(ctx, name, t0, t1, parent=parent, tid=tid,
                              kind=kind, status=status, attrs=attrs)


def tail_candidate(metric, value_ms, dur_s, count=1):
    return TRACER.tail_candidate(metric, value_ms, dur_s, count=count)


def record_exemplar(metric, value_ms, ctx):
    return TRACER.record_exemplar(metric, value_ms, ctx)


def spans(trace_id=None):
    return TRACER.spans(trace_id)
