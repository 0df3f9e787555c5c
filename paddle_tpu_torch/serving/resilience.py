"""Serving resilience: the typed request-level failure modes and the
adaptive load-shed controller. The port's copy of
``paddle_tpu/serving/resilience.py``'s errors, ``_log`` and
``ShedController`` (stdlib only).

- **Request deadlines** (``scheduler.py``): a request past its deadline
  fails with :class:`DeadlineExceededError` at whichever stage observes
  the expiry (admission, batch formation, dispatch wait, delivery).
- **Replica health** (``replica.py``): a wedged or dead replica's
  in-flight riders fail with :class:`ReplicaLostError`, and the slot is
  quarantined and respawned.
- **Adaptive load shedding** (:class:`ShedController`, wired by
  ``server.py`` under ``ServingConfig(shed_mode="adaptive")``): when
  queue-wait p50 eats the deadline headroom, admission sheds with
  :class:`OverloadedError`.

Not ported yet: the HBM-pressure shed input (``shed_hbm_frac``, which reads
the memory monitor, ROADMAP queue 1 item 10), the hot-swap watchdog and
``SwapFailedError`` (item 8, hot swap) and the front door's per-tenant fair
share (item 8).
"""

import collections
import statistics
import sys
import threading

from paddle_tpu_torch.core.enforce import EnforceNotMet, enforce
from paddle_tpu_torch.monitor.registry import counter, gauge

__all__ = ["DeadlineExceededError", "OverloadedError", "ReplicaLostError",
           "ShedController"]


class DeadlineExceededError(RuntimeError):
    """The request's deadline (``submit(deadline_ms=)`` or
    ``ServingConfig.default_deadline_ms``) passed before a result
    could be delivered. The message names the stage that observed the
    expiry (admission / batch-formation / dispatch-wait / delivery).
    Counted ``outcome="deadline"``; the request's trace is kept
    (errors-always-kept)."""


class OverloadedError(RuntimeError):
    """Admission refused by the adaptive shed controller: queue-wait
    p50 says this request would miss its deadline anyway, so failing
    it NOW costs nothing and saves the batch/dispatch work for
    requests that can still make it. Distinct from ``QueueFullError``
    (the bounded-queue refusal): a shed wants the client to slow down
    or route elsewhere until ``serving_brownout`` clears, not merely
    retry after backoff."""


class ReplicaLostError(RuntimeError):
    """The replica executing this request's micro-batch was lost —
    its thread wedged past ``replica_stall_ms`` or died — and the
    supervisor failed the in-flight riders rather than let them hang.
    The replica is quarantined and respawned (or permanently retired
    after repeated stalls); the request itself is safe to retry."""


_m_shed = counter(
    "serving_shed_total",
    "Requests shed at admission by the adaptive brownout controller, "
    "by reason: brownout (queue-wait p50 exceeded the request's "
    "deadline headroom while the brownout was active)",
    labels=("reason",))
_m_brownout = gauge(
    "serving_brownout",
    "1 while the adaptive shed controller is in brownout (shedding "
    "requests whose deadline headroom is already eaten by queue "
    "wait), 0 otherwise")


def _log(msg):
    """Loud, unbuffered operator-facing line (the launcher/faults
    idiom): resilience decisions must be visible in plain stderr, not
    only in metrics."""
    sys.stderr.write(f"[serving] {msg}\n")
    sys.stderr.flush()


class ShedController:
    """Brownout-with-hysteresis admission control.

    The batcher feeds it one ``observe_wait(wait_ms)`` per request at
    batch-formation time (queue wait = enqueue -> formation, the part
    of latency admission can still save); admission asks
    ``should_shed(deadline_ms, queue_depth)``. Control law:

    - **enter** brownout when the p50 of the recent-wait window
      exceeds ``enter_frac * deadline_ms`` (the reference deadline is
      the server's default; per-request deadlines are compared
      per-request at admission) — queue wait alone is already eating
      most of the headroom, so marginal requests will miss;
    - while in brownout, shed exactly the requests whose OWN deadline
      headroom is below the observed p50 wait over ``enter_frac`` — a
      long-deadline request still gets admitted;
    - **exit** (hysteresis) when p50 falls below ``exit_frac *
      deadline_ms``, or immediately when the queue is observed EMPTY
      at admission (drained: the waits in the window are history).
      The window is cleared on exit so stale overload samples cannot
      re-trigger instantly.

    The HBM-pressure input (``hbm_high_frac``) reads the memory monitor,
    which is not ported yet: anything but None raises.

    The clean path stays cheap: ``should_shed`` is a few unlocked
    float compares when not in brownout; the median runs on the
    batcher thread (bounded window), never on ``submit``.
    """

    def __init__(self, deadline_ms, enter_frac=0.5, exit_frac=0.25,
                 window=64, min_samples=8, hbm_high_frac=None):
        enforce(deadline_ms is not None and float(deadline_ms) > 0,
                f"ShedController needs a positive reference "
                f"deadline_ms (ServingConfig.default_deadline_ms), "
                f"got {deadline_ms!r} — without a deadline there is "
                f"no headroom to shed against")
        enforce(0.0 < float(exit_frac) < float(enter_frac),
                f"shed hysteresis needs 0 < exit_frac < enter_frac, "
                f"got enter={enter_frac} exit={exit_frac}")
        enforce(int(min_samples) >= 1 and int(window) >= int(min_samples),
                f"shed window must hold min_samples "
                f"(window={window}, min_samples={min_samples})")
        if hbm_high_frac is not None:
            raise EnforceNotMet(
                "shed_hbm_frac (the HBM-pressure shed input) reads the "
                "device-memory monitor, which is not ported yet (ROADMAP "
                "queue 1 item 10)")
        self.deadline_ms = float(deadline_ms)
        self.enter_frac = float(enter_frac)
        self.exit_frac = float(exit_frac)
        self._min_samples = int(min_samples)
        self._waits = collections.deque(maxlen=int(window))
        self._p50 = 0.0         # GIL-atomic float, read by submit
        self._brownout = False
        self._lock = threading.Lock()
        _m_brownout.set(0)

    @property
    def brownout(self):
        return self._brownout

    @property
    def p50_wait_ms(self):
        return self._p50

    def observe_wait(self, wait_ms):
        """One request's queue wait, observed at batch formation (the
        batcher thread). Drives the brownout state machine."""
        # append + median under the lock: a brownout exit on a submit
        # thread clears the deque, and an unlocked median iterating it
        # at that moment raises "deque mutated during iteration"
        with self._lock:
            self._waits.append(float(wait_ms))
            if len(self._waits) < self._min_samples:
                return
            p50 = statistics.median(self._waits)
            self._p50 = p50
        if not self._brownout:
            if p50 > self.enter_frac * self.deadline_ms:
                self._enter(p50)
        elif p50 < self.exit_frac * self.deadline_ms:
            self._exit(f"queue-wait p50 {p50:.1f}ms fell below "
                       f"{self.exit_frac:.2f}x deadline")

    def should_shed(self, deadline_ms, queue_depth):
        """Admission-time verdict: a shed reason string, or None to
        admit. ``deadline_ms`` is THIS request's effective deadline;
        ``queue_depth`` the request queue's current depth (0 exits the
        brownout on the spot — drained means the window is history)."""
        if not self._brownout:
            return None
        if queue_depth == 0:
            self._exit("request queue drained")
            return None
        if deadline_ms is not None and \
                self._p50 > self.enter_frac * float(deadline_ms):
            _m_shed.inc(reason="brownout")
            return "brownout"
        return None

    def _enter(self, p50):
        with self._lock:
            if self._brownout:
                return
            # re-validate against the LIVE p50: a concurrent
            # drain-exit just cleared the window (and zeroed _p50),
            # and entering from this thread's stale pre-clear read
            # would re-trip exactly the stale overload the clear
            # exists to forget
            if self._p50 <= self.enter_frac * self.deadline_ms:
                return
            self._brownout = True
        _m_brownout.set(1)
        _log(f"BROWNOUT: queue-wait p50 {p50:.1f}ms > "
             f"{self.enter_frac:.2f}x deadline {self.deadline_ms:.1f}ms"
             f" — shedding requests whose headroom is already spent "
             f"(OverloadedError; serving_shed_total counts)")

    def _exit(self, why):
        with self._lock:
            if not self._brownout:
                return
            self._brownout = False
            # fresh window: the overload samples that tripped the
            # brownout must not re-trip it the moment load resumes
            self._waits.clear()
            self._p50 = 0.0
        _m_brownout.set(0)
        _log(f"brownout cleared: {why}; re-admitting")

    def shutdown(self):
        """Server close: drop the brownout state and gauge quietly —
        a closed server is not shedding, and a lingering
        ``serving_brownout 1`` in exports would read as a live
        overload."""
        with self._lock:
            self._brownout = False
            self._waits.clear()
            self._p50 = 0.0
        _m_brownout.set(0)
