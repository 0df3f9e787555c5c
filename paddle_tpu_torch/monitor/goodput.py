"""Goodput ledger: end-to-end wall-clock attribution across incarnations.
The port's own copy of ``paddle_tpu/monitor/goodput.py`` (stdlib only): the
same phases, metric names and ``incarnations.jsonl`` format, so
``tools/goodput_report.py`` reads the port's ledger unchanged.

The observability spine (metrics, tracing, the memory ledger) explains
any single step or request; this module answers the production question
those can't: *of the N hours this job ran, how many produced training
progress, and where did the rest go?* Every wall-clock second of a
supervised job is attributed, per rank and per incarnation, to one
phase of an exhaustive vocabulary (``PHASES``), published as monotonic
``goodput_seconds_total{phase}`` counters that the launcher aggregates
into a job-level ``goodput_fraction`` gauge (the ``goodput=`` field of
the status line) and ``tools/goodput_report.py`` merges into a
per-incarnation waterfall.

Phase vocabulary (the ledger is exhaustive by construction — in-run
time splits into compile vs compute, between-run time splits into the
instrumented stalls vs ``device_idle`` residual):

- ``device_compute`` — dispatch + fetch of a compiled step (the only
  phase that counts toward goodput).
- ``compile`` — prepare + dispatch wall time of runs in which the
  Executor built a prepared runner (``Executor.trace_count`` moved): the
  pass pipeline plus the kernel libraries' nvcc builds and loads.
- ``replay`` — re-execution of steps a crash already paid for: step
  compute at ``step <= replayed-until`` (the previous incarnation's
  last observed step, from the launcher's incarnation records) is lost
  work, not progress.
- ``input_wait`` — the consumer side of ``background_prefetch``
  blocked on an empty queue (producer-bound input pipeline).
- ``device_idle`` — between-run residual no instrumented stall claims:
  eager host work, logging, the loop body itself.
- ``checkpoint_save`` / ``checkpoint_restore`` — the synchronous parts
  of checkpointing: d2h snapshot + enqueue (or the full durable write
  when sync), ``wait()`` barriers, restore + data-state restore.
- ``collective_wait`` — blocked in PS barriers / reconnect backoff.
- ``startup`` — process spawn (``PADDLE_SPAWN_WALLTIME``, stamped by
  the launcher) to ledger arming: imports, CUDA init, program build.
- ``restart_downtime`` — launcher-side: gang death to next spawn,
  weighted by the NEW incarnation's world size so launcher seconds and
  rank-seconds add up in one denominator.

The hot path is a single ``_armed`` check when disabled, and when armed
costs two
``perf_counter`` stamps plus one thread-local counter bump per step.
Stdlib-only: the launcher imports this freely.
"""

import json
import os
import threading
import time

from paddle_tpu_torch.monitor.registry import counter, gauge

__all__ = [
    "PHASES", "enable", "disable", "install_from_env", "attribute",
    "on_run_start", "on_run_end", "on_step", "on_restore",
    "flush_idle", "fraction_of", "phase_seconds_of",
    "record_incarnation", "read_incarnations", "INCARNATIONS_FILE",
    "ENV_DIR", "ENV_SPAWN",
]

#: the exhaustive phase vocabulary; tools/check_metrics.py lints that
#: every ``phase="..."`` literal in the tree is documented in the
#: goodput_seconds_total catalogue row
PHASES = (
    "device_compute", "compile", "replay", "input_wait", "device_idle",
    "checkpoint_save", "checkpoint_restore", "collective_wait",
    "startup", "restart_downtime",
)

ENV_DIR = "PADDLE_GOODPUT_DIR"
ENV_SPAWN = "PADDLE_SPAWN_WALLTIME"
INCARNATIONS_FILE = "incarnations.jsonl"

_c_phase = counter(
    "goodput_seconds_total",
    "Wall-clock seconds attributed to each goodput-ledger phase "
    "(exhaustive vocabulary, see monitor/goodput.py; launcher-side "
    "restart_downtime seconds are multiplied by the new incarnation's "
    "world size so they sum with per-rank seconds)",
    labels=("phase",))
_g_wall = gauge(
    "goodput_wall_seconds",
    "Wall-clock seconds from this process's spawn (or ledger arming) "
    "to its most recent attribution — the per-rank denominator the "
    "phase seconds must sum to (goodput_report asserts within 2%)")
_g_fraction = gauge(
    "goodput_fraction",
    "Job-level goodput: device_compute seconds / all attributed "
    "seconds across ranks + launcher, in [0, 1] (the status line's "
    "goodput= field; set launcher-side only)")
_g_step = gauge(
    "goodput_step",
    "Most recent global training-loop step this rank entered "
    "(auto_checkpoint); the launcher records the max across ranks as "
    "the incarnation's last_step — the replay watermark")
_g_restored = gauge(
    "goodput_restored_step",
    "Checkpoint step this incarnation restored from (unset when it "
    "started fresh); replayed lost work spans "
    "(goodput_restored_step, last_step of the crashed incarnation]")
_c_replayed = counter(
    "goodput_replayed_steps_total",
    "Training-loop steps re-executed below the previous incarnation's "
    "last observed step — work a crash already paid for once")

_armed = False
_lock = threading.Lock()
_origin = None          # wall epoch the wall gauge measures from
_mark = None            # perf_counter of the last attribution boundary
_accounted = 0.0        # externally attributed seconds since _mark
_replay_until = -1      # steps <= this are replayed lost work
_step = None            # current training-loop step (on_step)


def _touch_wall():
    if _origin is not None:
        _g_wall.set(time.time() - _origin)


def _inc(seconds, phase):
    """Unconditional phase credit (callers hold no lock)."""
    if seconds > 0:
        _c_phase.inc(float(seconds), phase=phase)
        _touch_wall()


def enable():
    """Arm the ledger (idempotent). The launcher calls this for its
    own registry; workers arm via ``install_from_env``."""
    global _armed, _origin, _mark
    with _lock:
        if _armed:
            return
        _armed = True
        if _origin is None:
            _origin = time.time()
        _mark = time.perf_counter()


def disable():
    """Disarm: zero recording from here on.
    Counters keep their values — the ledger is monotonic."""
    global _armed
    with _lock:
        _armed = False


def install_from_env():
    """Arm under a supervisor: PADDLE_GOODPUT_DIR (exported by
    launch.py next to the heartbeat/postmortem dirs) selects the
    incarnation-record directory; PADDLE_SPAWN_WALLTIME (stamped at
    spawn) prices the ``startup`` phase; the previous incarnation's
    record sets the replay watermark. Returns True when armed."""
    global _replay_until
    d = os.environ.get(ENV_DIR)
    if not d:
        return False
    global _origin
    spawn = os.environ.get(ENV_SPAWN)
    if spawn:
        try:
            _origin = float(spawn)
        except ValueError:
            pass
    enable()
    if _origin is not None:
        _inc(max(0.0, time.time() - _origin), phase="startup")
    recs = read_incarnations(d)
    if recs:
        last = recs[-1].get("last_step")
        if isinstance(last, (int, float)) and last >= 0:
            _replay_until = int(last)
    return True


def attribute(seconds, phase):
    """Credit ``seconds`` to ``phase`` from an instrumented stall seam
    (prefetch wait, checkpoint save/restore, collective wait, restart
    downtime). Also marks them *accounted*, so the between-run residual
    (``device_idle``) and the in-run compute split never double-count
    them. No-op while disarmed — call sites gate on ``_armed`` first
    so the disabled hot path pays one attribute read."""
    global _accounted
    if not _armed or seconds <= 0:
        return
    _inc(seconds, phase=phase)
    with _lock:
        _accounted += seconds


def on_run_start(t_run):
    """Executor.run entry: flush the between-run gap — whatever the
    instrumented stalls didn't claim since the last boundary was the
    host thinking while the device sat idle."""
    global _mark, _accounted
    if not _armed:
        return
    with _lock:
        if _mark is None:
            _mark = t_run
        residual = max(0.0, (t_run - _mark) - _accounted)
        _mark = t_run
        _accounted = 0.0
    _inc(residual, phase="device_idle")


def on_run_end(t_run, t_prep, t_disp, t_disp_end, traced):
    """Executor.run exit: split the in-run window. When a device
    segment (re)traced this run, prepare + dispatch carried the
    trace/compile (first step, signature churn, cache replay); the
    rest — minus any stall seconds attributed mid-run — is device
    compute, or ``replay`` while re-executing steps the previous
    incarnation already reached."""
    global _mark, _accounted
    if not _armed:
        return
    now = time.perf_counter()
    compile_s = ((t_prep - t_run) + (t_disp_end - t_disp)) \
        if traced else 0.0
    with _lock:
        ext = _accounted
        _accounted = 0.0
        _mark = now
    compute_s = max(0.0, (now - t_run) - compile_s - ext)
    if compile_s > 0:
        _inc(compile_s, phase="compile")
    if _step is not None and _step <= _replay_until:
        _inc(compute_s, phase="replay")
    else:
        _inc(compute_s, phase="device_compute")


def on_step(step):
    """Training-loop step marker (auto_checkpoint calls it before the
    step body): publishes the replay watermark source and counts
    replayed steps."""
    global _step
    if not _armed:
        return
    _step = int(step)
    _g_step.set(float(_step))
    if _step <= _replay_until:
        _c_replayed.inc()


def on_restore(step):
    """A checkpoint restore landed on ``step`` (before the +1 resume
    bump)."""
    if not _armed:
        return
    _g_restored.set(float(int(step)))


def flush_idle():
    """Attribute the tail since the last boundary (loop exit to final
    checkpoint/exporter shutdown) so the per-rank phase sum tracks the
    wall gauge to the end."""
    global _mark, _accounted
    if not _armed:
        return
    now = time.perf_counter()
    with _lock:
        if _mark is None:
            _mark = now
        residual = max(0.0, (now - _mark) - _accounted)
        _mark = now
        _accounted = 0.0
    _inc(residual, phase="device_idle")


# -- aggregation helpers (exporter / report side) ---------------------------
def phase_seconds_of(samples):
    """{phase: seconds} out of parsed/aggregated exporter samples
    (``{(name, label_pairs): value}``)."""
    out = {}
    for (name, pairs), v in samples.items():
        if name != "goodput_seconds_total":
            continue
        phase = dict(pairs).get("phase", "?")
        out[phase] = out.get(phase, 0.0) + float(v)
    return out


def fraction_of(samples):
    """device_compute share of all attributed seconds, or None when
    the samples carry no ledger yet."""
    phases = phase_seconds_of(samples)
    total = sum(phases.values())
    if total <= 0:
        return None
    return phases.get("device_compute", 0.0) / total


# -- incarnation records (launcher-side jsonl) ------------------------------
def record_incarnation(dirname, record):
    """Append one gang-incarnation record to
    ``<dirname>/incarnations.jsonl`` (the launcher writes one at every
    gang end — ok, fail, hung, timeout, preempted). One json object
    per line; a torn tail line is skipped by ``read_incarnations``."""
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, INCARNATIONS_FILE)
    with open(path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return path


def read_incarnations(dirname):
    """Parsed records, file order (incarnation order); unreadable or
    torn lines are skipped."""
    path = os.path.join(dirname, INCARNATIONS_FILE)
    out = []
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return out
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out
