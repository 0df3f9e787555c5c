"""Flight recorder: a bounded ring of recent spans/steps that dumps a
postmortem JSON when the process dies. The port's own copy of
``paddle_tpu/monitor/flight_recorder.py`` (stdlib only; same dump format,
so one package's postmortem reads in the other's tools).

The elastic supervisor (the JAX package's distributed/launch.py) makes
death routine — a
hung rank is killed and restarted, a preempted job is SIGTERMed — but
until now every kill discarded all evidence of what the rank was doing.
This module keeps a small always-on ring of recent events (profiler
spans via ``RecordEvent``, executor steps, anything ``note()``d) plus
the stack of spans currently IN FLIGHT per thread, and writes them — with
a full metrics-registry snapshot — as JSON when:

- an uncaught exception unwinds the process (``sys.excepthook`` chain),
- SIGTERM arrives (the launcher's watchdog kill and pod preemption both
  deliver it; the handler dumps, then chains to any previously
  installed handler so ``auto_checkpoint``'s preemption flush still
  runs),
- the user calls ``dump()`` explicitly.

The launcher exports ``PADDLE_POSTMORTEM_DIR=<log_dir>/postmortem`` to
every worker; ``install_from_env()`` (call it first thing in a worker)
arms the recorder iff that env is present, so production code pays one
boolean check per event when unsupervised. A hung rank's dump names the
span it was stuck inside — the "why did rank 3 die" answer. Overhead when armed is one deque append per span.

Dump files are ``<dir>/rank<R>.<pid>.<reason>.json``, written
atomically; format documented in docs/OBSERVABILITY.md.
"""

import collections
import itertools
import json
import os
import signal
import sys
import threading
import time
import traceback

__all__ = [
    "FlightRecorder", "RECORDER", "ENV_DIR",
    "enable", "disable", "is_enabled", "install_from_env",
    "note", "dump",
]

ENV_DIR = "PADDLE_POSTMORTEM_DIR"

#: module-level fast-path switch — instrumented code checks this single
#: boolean before touching the recorder at all
_enabled = False


class FlightRecorder:
    def __init__(self, capacity=4096):
        from paddle_tpu_torch.monitor.registry import _ThreadShards
        self.capacity = int(capacity)
        self._ring = collections.deque(maxlen=self.capacity)
        self._seq = itertools.count()
        # per-thread in-flight span stacks (the shared registry shard
        # idiom; dead threads' stacks are dropped — a dead thread has
        # nothing in flight)
        self._stacks = _ThreadShards(list)
        self._dir = None
        self._installed = False
        self._prev_term = None
        self._prev_hook = None

    # -- recording (hot path) ----------------------------------------------
    def note(self, kind, name, **data):
        """Append one event to the ring. deque.append is GIL-atomic, so
        concurrent writers need no lock."""
        self._ring.append((next(self._seq), time.time(), kind, name,
                           threading.get_ident(), data or None))

    def span_push(self, name):
        """Open an in-flight span; pairs with ``span_pop``. The stack is
        what a postmortem reports as "what was this thread doing"."""
        self._stacks.get().append((name, time.time()))

    def span_pop(self, name, dur_s):
        st = self._stacks.get()
        if st and st[-1][0] == name:
            st.pop()
        self.note("span", name, dur_ms=round(dur_s * 1e3, 3))

    # -- inspection --------------------------------------------------------
    def in_flight(self):
        """[{name, age_s, thread}] for every span currently open,
        innermost last per thread."""
        now = time.time()
        out = []
        for t, st in self._stacks.items():
            for name, t0 in list(st):
                out.append({"name": name, "age_s": round(now - t0, 3),
                            "thread": t.ident})
        return out

    def events(self):
        return [{"seq": s, "time": t, "kind": k, "name": n,
                 "thread": tid, **({"data": d} if d else {})}
                for s, t, k, n, tid, d in list(self._ring)]

    # -- dumping -----------------------------------------------------------
    def _metrics_snapshot(self):
        try:
            from paddle_tpu_torch.monitor.registry import REGISTRY
            out = {}
            for m in REGISTRY.collect():
                if m.kind == "histogram":
                    out[m.name] = {
                        "|".join(k) or "": {"sum": s, "count": c}
                        for k, (_cum, s, c) in m.samples().items()}
                else:
                    out[m.name] = {"|".join(k) or "": v
                                   for k, v in m.samples().items()}
            return out
        except Exception:       # telemetry must not break the dump
            return {}

    def dump(self, path=None, reason="", extra=None):
        """Write the postmortem JSON; returns the path or None when
        there is nowhere to write (no ``path`` and not installed)."""
        if path is None:
            if self._dir is None:
                return None
            rank = os.environ.get("PADDLE_TRAINER_ID", "0")
            tag = "".join(c if c.isalnum() else "-" for c in reason) \
                or "dump"
            path = os.path.join(
                self._dir, f"rank{rank}.{os.getpid()}.{tag}.json")
        doc = {
            "reason": reason,
            "rank": os.environ.get("PADDLE_TRAINER_ID"),
            "restart_count": os.environ.get("PADDLE_RESTART_COUNT"),
            "pid": os.getpid(),
            "time": time.time(),
            "in_flight_spans": self.in_flight(),
            "events": self.events(),
            "metrics": self._metrics_snapshot(),
        }
        try:
            # when tracing is armed, a dump (SIGTERM, watchdog kill,
            # uncaught exception) also carries the dumping thread's
            # in-flight trace tree — lazy import: the recorder must
            # stay importable standalone
            from paddle_tpu_torch.monitor import trace as _trace_mod
            if _trace_mod._enabled:
                tr = _trace_mod.inflight_report()
                if tr is not None:
                    doc["trace"] = tr
        except Exception:       # telemetry must not break the dump
            pass
        if extra:
            doc.update(extra)
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
        except OSError:
            return None
        return path

    # -- arming ------------------------------------------------------------
    def install(self, dirname):
        """Arm the recorder: dumps go under ``dirname``; SIGTERM and
        uncaught exceptions trigger one. Both hooks CHAIN to whatever
        was installed before (and by running first, a dump happens even
        if a later-installed handler exits the process). Returns an
        undo callable; idempotent."""
        os.makedirs(dirname, exist_ok=True)
        self._dir = dirname
        if self._installed:
            return lambda: None
        self._installed = True

        self._prev_hook = sys.excepthook

        def hook(etype, value, tb):
            self.dump(reason="exception", extra={
                "exception": "".join(traceback.format_exception_only(
                    etype, value)).strip(),
                "traceback": traceback.format_tb(tb)[-10:],
            })
            (self._prev_hook or sys.__excepthook__)(etype, value, tb)

        sys.excepthook = hook

        undo_sig = lambda: None
        if threading.current_thread() is threading.main_thread():
            self._prev_term = signal.getsignal(signal.SIGTERM)

            def on_term(signum, frame):
                self.dump(reason="sigterm")
                prev = self._prev_term
                if callable(prev):
                    prev(signum, frame)
                elif prev == signal.SIG_DFL:
                    # preserve default die-by-SIGTERM semantics (the
                    # launcher reads the exit status)
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            signal.signal(signal.SIGTERM, on_term)

            def undo_sig():
                signal.signal(signal.SIGTERM,
                              self._prev_term or signal.SIG_DFL)
                self._prev_term = None

        def undo():
            sys.excepthook = self._prev_hook or sys.__excepthook__
            undo_sig()
            self._installed = False

        return undo


#: process-wide default recorder (what RecordEvent/Executor feed)
RECORDER = FlightRecorder()


def enable(dirname=None):
    """Turn recording on; with ``dirname`` also arm the crash/SIGTERM
    dump hooks there."""
    global _enabled
    _enabled = True
    if dirname:
        RECORDER.install(dirname)
    return RECORDER


def disable():
    global _enabled
    _enabled = False


def is_enabled():
    return _enabled


def install_from_env(env=None):
    """Worker-side hookup: arm the recorder iff the launcher exported
    PADDLE_POSTMORTEM_DIR. Returns the recorder or None."""
    env = os.environ if env is None else env
    d = env.get(ENV_DIR)
    if not d:
        return None
    return enable(d)


def note(kind, name, **data):
    """Module-level convenience: record iff enabled."""
    if _enabled:
        RECORDER.note(kind, name, **data)


def dump(path=None, reason="manual"):
    return RECORDER.dump(path=path, reason=reason)
