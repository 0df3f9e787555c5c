"""Training-health anomaly detection, postmortem triggering, and
straggler readout: the port's own copy of ``paddle_tpu/monitor/anomaly.py``
(stdlib only).

The metrics registry answers "what are the numbers"; this module answers
"has the run gone wrong" — and makes sure the evidence survives. Four
anomaly kinds, matching how training runs actually die:

- ``non_finite`` — a nan/inf tensor (tripped by the in-graph sentinels
  in ``monitor.numerics``, or any non-finite signal — loss, grad norm
  — fed to the detector, so a NaN run is caught even without
  ``FLAGS_check_nan_inf``'s memory cost);
- ``loss_spike`` — loss jumps far above its trailing-window median;
- ``grad_explosion`` — gradient global norm (from
  ``monitor.tensorwatch``) jumps far above its trailing median;
- ``step_stall`` — wall step time (fed by ``Executor.run``) jumps far
  above its trailing median.

On a trip: the ``anomaly_trips_total{kind}`` counter moves,
``train_health`` drops to 0 (exported in this rank's ``.prom``
snapshot, so the launcher-side job view sees it), the flight recorder
gets a note, and — once per kind per process, so a persisting
condition cannot spam the disk — the recorder dumps a postmortem JSON
(``rank<R>.<pid>.anomaly-<kind>.json``) with the anomaly named under
an ``"anomaly"`` key. Everything is opt-in: ``enable()`` arms the
detector (the executor and tensorwatch check one module bool before
feeding it), while ``trip()`` itself always works — the numerics
sentinel uses it even when the windowed detector is off, because
``FLAGS_check_nan_inf`` was its own opt-in.

The launcher side (stdlib-only, like everything in this module):
``straggler_ranks`` and ``job_health`` read the per-rank ``.prom``
snapshots the exporter already aggregates and derive the ``health=``
field of the status line — a rank whose mean ``executor_step_ms``
sits far above the median rank's is a straggler (the data-parallel
gang runs at its pace), and any rank whose snapshot carries trips or
``train_health 0`` marks the job anomalous.

Docs: docs/DEBUGGING.md (detector + postmortems),
docs/OBSERVABILITY.md (metric catalogue entries).
"""

import collections
import statistics
import threading

from paddle_tpu_torch.monitor import flight_recorder as _flight
from paddle_tpu_torch.monitor.registry import counter, gauge

__all__ = [
    "AnomalyDetector", "DETECTOR", "enable", "disable", "is_enabled",
    "trip", "straggler_ranks", "job_health", "KINDS",
]

KINDS = ("non_finite", "loss_spike", "grad_explosion", "step_stall")

_m_trips = counter(
    "anomaly_trips_total",
    "Anomaly-detector trips by kind (non_finite, loss_spike, "
    "grad_explosion, step_stall)", labels=("kind",))
_g_health = gauge(
    "train_health",
    "1 while no anomaly has tripped in this process, 0 after any trip "
    "(set to 1 by anomaly.enable())")
_g_last_step = gauge(
    "last_anomaly_step",
    "Step index of this process's most recent anomaly trip")

#: instrumented hot paths read this bool directly (the
#: flight_recorder._enabled pattern) before touching the detector
_enabled = False

_trip_lock = threading.Lock()
_dumped_kinds = set()


def trip(kind, report=None, step=None):
    """Register one anomaly: count it, drop ``train_health``, note it
    to the flight recorder, and — first trip of this kind in this
    process only — dump a postmortem JSON with the anomaly named.
    Returns the dump path (or None: recorder unarmed / repeat kind).
    Works whether or not the windowed detector is enabled."""
    _m_trips.inc(kind=kind)
    _g_health.set(0.0)
    if step is not None:
        _g_last_step.set(step)
    if _flight._enabled:
        _flight.RECORDER.note("anomaly", kind, step=step)
    with _trip_lock:
        first = kind not in _dumped_kinds
        _dumped_kinds.add(kind)
    if not first:
        return None
    doc = dict(report or {})
    doc["kind"] = kind
    if step is not None:
        doc.setdefault("step", step)
    # the tripping thread's in-flight span tree rides the dump's own
    # top-level "trace" embed (flight_recorder.dump) — the postmortem
    # names the PHASE the step died in (dispatch vs fetch vs
    # feed_stage), not just the step number
    return _flight.RECORDER.dump(reason=f"anomaly-{kind}",
                                 extra={"anomaly": doc})


class AnomalyDetector:
    """Windowed host-side detector. Feed it whatever the loop has —
    ``observe(step=, loss=, grad_norm=, step_ms=)``, every argument
    optional — and it trips when a value jumps ``factor``× above the
    trailing-window median (median, not mean — and breaching values
    never join the window, so an anomaly cannot drag its own baseline
    up). ``step_stall`` additionally requires ``stall_consecutive``
    breaching steps in a row: a stall is sustained by definition, and
    a single scheduler hiccup on a shared host must not page anyone.
    A tripped kind cools down for ``cooldown`` observations so an
    ongoing condition counts once per cooldown, not once per step."""

    def __init__(self, window=64, min_samples=8, loss_spike_factor=4.0,
                 grad_explosion_factor=10.0, stall_factor=10.0,
                 stall_consecutive=3, cooldown=100):
        self.min_samples = int(min_samples)
        self.cooldown = int(cooldown)
        self._factors = {"loss_spike": float(loss_spike_factor),
                         "grad_explosion": float(grad_explosion_factor),
                         "step_stall": float(stall_factor)}
        # a stall is SUSTAINED by definition: on a shared host a single
        # step 10x above a ~ms median is a scheduler hiccup, and a trip
        # per hiccup would make step_stall unusable there — require
        # this many consecutive breaching steps (spike/explosion stay
        # single-shot: those are legitimately one-step events)
        self._needed = {"loss_spike": 1, "grad_explosion": 1,
                        "step_stall": max(int(stall_consecutive), 1)}
        self._window_len = int(window)
        self._streak = {}               # (kind, key) -> breach streak
        self._windows = {}              # (kind, key) -> deque
        self._cool = {}
        self._lock = threading.Lock()

    def window(self, kind, key=None):
        """This (kind, key)'s trailing window (created on demand)."""
        with self._lock:
            w = self._windows.get((kind, key))
            if w is None:
                w = self._windows[(kind, key)] = collections.deque(
                    maxlen=self._window_len)
            return w

    def observe(self, step=None, loss=None, grad_norm=None,
                step_ms=None, step_ms_key=None):
        """Judge this step's signals; returns the list of kinds that
        tripped (usually empty). ``step_ms_key`` scopes the stall
        baseline per workload — a loop alternating ~5 ms eval steps
        with ~100 ms train steps must not read its train steps as
        stalls of the eval baseline, so ``Executor.run`` passes its
        compiled-step identity here and each gets its own window."""
        tripped = []
        for kind, signal, value, key in (
                ("loss_spike", "loss", loss, None),
                ("grad_explosion", "grad_global_norm", grad_norm,
                 None),
                ("step_stall", "step_ms", step_ms, step_ms_key)):
            if value is None:
                continue
            value = float(value)
            if value != value or value in (float("inf"),
                                           float("-inf")):
                # a non-finite signal IS the anomaly — never a window
                # sample (one NaN in the deque would poison the median
                # baseline for `window` observations)
                if not self._cooling("non_finite"):
                    self._fire("non_finite",
                               {"signal": signal,
                                "value": repr(value)}, step)
                    tripped.append("non_finite")
            elif self._judge(kind, signal, value, step, key=key):
                tripped.append(kind)
        return tripped

    def _cooling(self, kind):
        """Tick the kind's cooldown by ONE OBSERVATION (the docstring's
        unit — a breach-based tick would swallow the next ``cooldown``
        genuine, well-separated anomalies); True while still cooling."""
        with self._lock:
            c = self._cool.get(kind, 0)
            if c > 0:
                self._cool[kind] = c - 1
                return True
        return False

    def _judge(self, kind, signal, value, step, key=None):
        cooling = self._cooling(kind)
        win = self.window(kind, key)
        wkey = (kind, key)
        with self._lock:
            baseline = statistics.median(win) \
                if len(win) >= self.min_samples else None
            breach = (baseline is not None and baseline > 0
                      and value > self._factors[kind] * baseline)
            # breaching values stay OUT of the window: a sustained
            # stall must not drag the baseline up toward itself while
            # the consecutive-breach count is still accumulating
            if not breach:
                win.append(value)
                self._streak[wkey] = 0
                return False
            self._streak[wkey] = self._streak.get(wkey, 0) + 1
            armed = self._streak[wkey] >= self._needed[kind]
            if armed:
                self._streak[wkey] = 0
        if not armed or cooling:
            return False
        self._fire(kind, {"signal": signal, "value": value,
                          "median": baseline,
                          "factor": self._factors[kind]}, step)
        return True

    def _fire(self, kind, report, step):
        with self._lock:
            self._cool[kind] = self.cooldown
        trip(kind, report=report, step=step)


#: process-wide detector the executor / tensorwatch feed when enabled
DETECTOR = AnomalyDetector()


def enable(**kwargs):
    """Arm the detector (fresh windows; kwargs go to AnomalyDetector)
    and declare this process healthy until proven otherwise."""
    global _enabled, DETECTOR
    DETECTOR = AnomalyDetector(**kwargs)
    _enabled = True
    _g_health.set(1.0)
    return DETECTOR


def disable():
    global _enabled
    _enabled = False


def is_enabled():
    return _enabled


# -- launcher-side readers (stdlib-only, over parsed .prom snapshots) -------
def _rank_step_ms(samples):
    s = samples.get(("executor_step_ms_sum", ()), 0.0)
    c = samples.get(("executor_step_ms_count", ()), 0.0)
    return (s / c) if c else None


def straggler_ranks(snaps, skew=1.75):
    """Ranks whose mean step time exceeds ``skew``× the median rank's.
    ``snaps``: {rank: (types, samples)} from
    exporter.read_rank_snapshots. Needs >= 3 reporting ranks — with 2
    there is no quorum for which one is slow."""
    ms = {}
    for r, (_types, samples) in snaps.items():
        v = _rank_step_ms(samples)
        if v:
            ms[r] = v
    if len(ms) < 3:
        return []
    med = statistics.median(ms.values())
    if med <= 0:
        return []
    return sorted(r for r, v in ms.items() if v > skew * med)


def job_health(snaps, skew=1.75):
    """(health string, straggler rank list) for the launcher's status
    line: ``ok``, or marks like ``anomaly:non_finite`` /
    ``straggler:r3`` joined with ``;``."""
    kinds = set()
    unhealthy = False
    for _r, (_types, samples) in snaps.items():
        for (name, labels), v in samples.items():
            if v <= 0:
                if name == "train_health":
                    unhealthy = True
                continue
            if name == "anomaly_trips_total":
                kinds.update(lv for ln, lv in labels if ln == "kind")
            elif name == "nonfinite_trips_total":
                kinds.add("non_finite")
    marks = []
    if kinds:
        marks.append("anomaly:" + ",".join(sorted(kinds)))
    elif unhealthy:
        marks.append("anomaly")
    stragglers = straggler_ranks(snaps, skew=skew)
    if stragglers:
        marks.append("straggler:"
                     + "+".join(f"r{r}" for r in stragglers))
    return (";".join(marks) if marks else "ok"), stragglers
