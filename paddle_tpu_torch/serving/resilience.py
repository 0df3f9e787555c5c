"""Serving resilience: the typed request-level failure modes, the adaptive
load-shed controller, the hot swap's watchdog and the front door's
per-tenant fair share. The port's copy of
``paddle_tpu/serving/resilience.py`` (stdlib only).

- **Request deadlines** (``scheduler.py``): a request past its deadline
  fails with :class:`DeadlineExceededError` at whichever stage observes the
  expiry (admission, batch formation, dispatch wait, delivery).
- **Replica health** (``replica.py``): a wedged or dead replica's in-flight
  riders fail with :class:`ReplicaLostError`, and the slot is quarantined
  and respawned.
- **Adaptive load shedding** (:class:`ShedController`, wired by
  ``server.py`` under ``ServingConfig(shed_mode="adaptive")``): when
  queue-wait p50 eats the deadline headroom, admission sheds with
  :class:`OverloadedError`; with ``shed_hbm_frac`` the worst card's memory
  utilization from the memory monitor (``monitor/memory.py``) sheds too.
- **Hot swap** (``swap.py``): :class:`SwapFailedError` names the stage a
  refused or rolled-back swap stopped at; :class:`SwapWatchdog` is the
  post-cutover rollback verdict.
- **Per-tenant fair share** (:class:`TenantFairShare`, wired by the HTTP
  front door, ``frontdoor.py``): per-tenant in-flight quotas plus a
  brownout fair-share squeeze.
"""

import collections
import statistics
import sys
import threading
import time

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.monitor.registry import REGISTRY, counter, gauge

__all__ = [
    "DeadlineExceededError", "OverloadedError", "ReplicaLostError",
    "ShedController", "SwapFailedError", "SwapWatchdog",
    "TenantFairShare",
]


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


class SwapFailedError(RuntimeError):
    """A hot model swap (``InferenceServer.swap``, docs/SERVING.md
    "Hot model swap") was refused or rolled back. ``stage`` names
    where: ``gate`` (integrity/compatibility refusal before any
    resource was committed), ``standby`` (the new version's warm boot
    failed or wedged past its timeout), ``canary`` (golden requests
    through the standby executables failed shape/finiteness/parity),
    ``cutover`` (the dispatch flip itself failed and was reverted), or
    ``watchdog`` (the post-cutover error/latency window tripped and
    traffic was reverted). In EVERY case the previously-live version
    is still serving — a failed swap costs the standby resources, not
    the old version's traffic.

    ``retryable`` distinguishes refusals that say nothing about the
    TARGET version (a concurrent swap held the lock, the server is
    closing) from verdicts against the artifact itself: the watch-dir
    failed-version memo only records the latter — blacklisting a
    never-evaluated publish would silently strand a good deploy."""

    def __init__(self, message, stage=None, retryable=False):
        super().__init__(message)
        self.stage = stage
        self.retryable = retryable


_m_shed = counter(
    "serving_shed_total",
    "Requests shed at admission by the adaptive brownout controller, "
    "by reason: brownout (queue-wait p50 exceeded the request's "
    "deadline headroom while the brownout was active), hbm_pressure "
    "(worst-device HBM utilization at/above shed_hbm_frac)",
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

    Optional HBM-pressure input (``hbm_high_frac``): worst-device
    utilization from the memory poller (``monitor.memory``) at/above
    the fraction sheds new admissions with ``reason="hbm_pressure"``
    regardless of queue-wait state — device-memory exhaustion, unlike
    queue wait, does not heal by admitting fewer marginal requests,
    so there is no hysteresis: the shed lasts exactly as long as the
    pressure reading does. None (the default) disables the input.

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
        enforce(hbm_high_frac is None or
                0.0 < float(hbm_high_frac) <= 1.0,
                f"shed_hbm_frac must be in (0, 1], got "
                f"{hbm_high_frac!r}")
        self.deadline_ms = float(deadline_ms)
        self.enter_frac = float(enter_frac)
        self.exit_frac = float(exit_frac)
        self.hbm_high_frac = None if hbm_high_frac is None \
            else float(hbm_high_frac)
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
        if self.hbm_high_frac is not None:
            try:
                from paddle_tpu_torch.monitor import memory as _memory
                util = _memory.hbm_utilization_max()
            except Exception:
                util = None
            if util is not None and util >= self.hbm_high_frac:
                _m_shed.inc(reason="hbm_pressure")
                return "hbm_pressure"
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


class SwapWatchdog:
    """Post-cutover rollback verdict for the hot model swap
    (docs/SERVING.md "Hot model swap"): for a bounded window after the
    dispatch flip, watch the process serving telemetry for evidence
    the NEW version is hurting live traffic —

    - **error storm**: the error count grew by ``max_errors`` or more
      since the flip. ``errors_fn`` supplies the count — the swap
      controller passes the NEW pool's ``batch_failures``, so errors
      from the OLD pool's still-draining batches can never roll back
      a healthy new version (attribution, not just a threshold);
      without ``errors_fn`` the process-global
      ``serving_requests_total{outcome="error"}`` counter is the
      fallback.
    - **latency regression** (opt-in, ``latency_x``): the window's
      mean request latency exceeds ``latency_x`` times the
      ``baseline_ms`` captured before the swap, judged only once
      ``min_latency_samples`` requests have landed (a 2-request window
      is noise, not a verdict). The latency histogram is
      process-global — run one server per process when this verdict
      must be attributable.

    The swap controller polls :meth:`verdict` until :meth:`expired`;
    a non-None verdict reason triggers the automatic rollback."""

    def __init__(self, window_ms, max_errors=3, latency_x=None,
                 baseline_ms=None, min_latency_samples=8,
                 errors_fn=None):
        enforce(window_ms >= 0,
                f"watchdog window_ms must be >= 0, got {window_ms!r}")
        enforce(int(max_errors) >= 1,
                f"watchdog max_errors must be >= 1, got {max_errors!r}")
        enforce(latency_x is None or float(latency_x) > 1.0,
                f"watchdog latency_x must be > 1.0 (a ratio) or None, "
                f"got {latency_x!r}")
        self.window_s = float(window_ms) / 1e3
        self.max_errors = int(max_errors)
        self.latency_x = None if latency_x is None else float(latency_x)
        self.baseline_ms = baseline_ms
        self.min_latency_samples = int(min_latency_samples)
        self._errors_fn = errors_fn
        self._t0 = None
        self._err0 = 0.0
        self._lat0 = (0.0, 0)

    def _errors(self):
        if self._errors_fn is not None:
            return float(self._errors_fn())
        m = REGISTRY.get("serving_requests_total")
        return m.value(outcome="error") if m is not None else 0.0

    @staticmethod
    def _latency():
        m = REGISTRY.get("serving_request_latency_ms")
        return (m.sum(), m.count()) if m is not None else (0.0, 0)

    def start(self):
        """Anchor the window at the cutover instant: only errors and
        latency observed AFTER the flip count against the new
        version."""
        self._t0 = time.monotonic()
        self._err0 = self._errors()
        self._lat0 = self._latency()
        return self

    def expired(self):
        return self._t0 is not None and \
            time.monotonic() - self._t0 >= self.window_s

    def verdict(self):
        """A rollback reason string, or None while the window looks
        healthy."""
        errs = self._errors() - self._err0
        if errs >= self.max_errors:
            return (f"{errs:.0f} request error(s) within "
                    f"{(time.monotonic() - self._t0) * 1e3:.0f}ms of "
                    f"cutover (watchdog max_errors={self.max_errors})")
        if self.latency_x is not None and self.baseline_ms:
            s, c = self._latency()
            ds, dc = s - self._lat0[0], c - self._lat0[1]
            if dc >= self.min_latency_samples:
                mean = ds / dc
                if mean > self.latency_x * float(self.baseline_ms):
                    return (f"post-cutover mean latency {mean:.1f}ms > "
                            f"{self.latency_x:g}x pre-swap baseline "
                            f"{float(self.baseline_ms):.1f}ms over "
                            f"{dc} request(s)")
        return None


class TenantFairShare:
    """Per-tenant in-flight admission: a hard quota always, plus a
    fair-share squeeze while the shed controller is in brownout.

    The HTTP front door (``serving/frontdoor.py``) asks
    :meth:`admit` before submitting a tenant's request and MUST pair
    every successful admit with exactly one :meth:`release` (the front
    door's try/finally owns that contract, including the
    client-disconnected-mid-wait path). Two refusal verdicts:

    - ``"quota"`` — the tenant already holds ``max_inflight``
      requests. An absolute per-tenant bound, active in any load
      state: no single key can occupy the whole request queue.
    - ``"fair_share"`` — the shed controller is in brownout AND
      admitting this request would push the tenant past
      ``fair_frac`` of ALL in-flight front-door requests. This is the
      "one abusive tenant brownouts itself, not the fleet" rule: in
      overload the heavy key gets squeezed back toward its fair
      share while light tenants keep flowing untouched.
      ``fair_min_inflight`` exempts small holdings — with one tenant
      and two requests the share test would otherwise refuse
      everyone.

    Verdicts are strings rather than exceptions because the caller
    maps them to BOTH a metric label and a status code; the counting
    itself (``serving_tenant_refused_total``) stays in the front door
    with the rest of the HTTP metrics. Stdlib-only and lock-cheap:
    one dict update under one lock per admit/release.
    """

    def __init__(self, max_inflight=64, fair_frac=0.5,
                 fair_min_inflight=4, shed=None):
        enforce(int(max_inflight) >= 1,
                f"tenant max_inflight must be >= 1, got "
                f"{max_inflight!r}")
        enforce(0.0 < float(fair_frac) <= 1.0,
                f"tenant fair_frac must be in (0, 1], got "
                f"{fair_frac!r}")
        enforce(int(fair_min_inflight) >= 1,
                f"tenant fair_min_inflight must be >= 1, got "
                f"{fair_min_inflight!r}")
        self.max_inflight = int(max_inflight)
        self.fair_frac = float(fair_frac)
        self.fair_min_inflight = int(fair_min_inflight)
        self.shed = shed
        self._inflight = {}
        self._total = 0
        self._lock = threading.Lock()

    def admit(self, tenant):
        """Refusal verdict (``"quota"`` / ``"fair_share"``) or None.
        None means the tenant's in-flight count was incremented and
        the caller OWES a :meth:`release`; a verdict changes no
        state."""
        with self._lock:
            cur = self._inflight.get(tenant, 0)
            if cur >= self.max_inflight:
                return "quota"
            if self.shed is not None and self.shed.brownout \
                    and cur >= self.fair_min_inflight \
                    and cur + 1 > self.fair_frac * (self._total + 1):
                return "fair_share"
            self._inflight[tenant] = cur + 1
            self._total += 1
        return None

    def release(self, tenant):
        """Return the tenant's remaining in-flight count (0 removes
        the entry, so idle tenants cost nothing and the front door
        knows to drop the per-tenant gauge)."""
        with self._lock:
            cur = self._inflight.get(tenant, 0)
            enforce(cur > 0,
                    f"TenantFairShare.release({tenant!r}) without a "
                    f"matching admit — the front door's "
                    f"admit/release pairing is broken")
            if cur == 1:
                del self._inflight[tenant]
            else:
                self._inflight[tenant] = cur - 1
            self._total -= 1
            return cur - 1

    def inflight(self, tenant):
        with self._lock:
            return self._inflight.get(tenant, 0)

    @property
    def total_inflight(self):
        return self._total
