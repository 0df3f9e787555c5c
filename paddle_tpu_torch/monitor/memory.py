"""Device-memory observability on ``torch.cuda``: the port of
``paddle_tpu/monitor/memory.py``'s entity ledger, runtime accounting, OOM
postmortems and admission arithmetic.

- **Ledger.** ``ledger_set(entity, nbytes)`` attributes resident bytes to
  named entities (the serving pools' params and buckets) under the
  ``memory_ledger_bytes`` gauge; ``ledger``, ``ledger_total`` and
  ``ledger_table`` read it back.
- **Runtime accounting.** ``sample_now()`` reads
  ``torch.cuda.memory_allocated`` per card into the ``hbm_bytes_in_use`` /
  ``hbm_bytes_limit`` / ``hbm_utilization`` gauges and advances the
  high-water marks; ``enable(interval)`` runs it on a daemon thread,
  ``disable()`` stops it and drops the runtime series.
- **OOM postmortem.** ``is_oom_error`` recognises
  ``torch.cuda.OutOfMemoryError`` (and the JAX package's message markers);
  ``handle_oom`` re-raises it as a typed :class:`OutOfDeviceMemoryError`
  carrying ``oom_postmortem()``: the ledger, the largest active blocks of
  the caching allocator, the per-card in-use, limit, high-water and peak
  allocated bytes.
- **Admission.** ``admission_headroom(projected)`` is the arithmetic the
  hot swap's memory-aware admission consults.

The limit is the card's total memory (``torch.cuda.mem_get_info``) where
the device is a card, else the ``PADDLE_TPU_HBM_LIMIT_BYTES`` override, else
None: on the CPU, admission is advisory unless the override is given.

- **Per-step peaks.** Where the JAX package reads XLA's compile-time
  analysis of each compiled segment, the port has no compiled executable:
  its counterpart is the **measured** peak of a prepared runner's first
  step on the card (the Executor's ``FLAGS_monitor_cost`` probe), turned by
  ``analyze_compiled`` into the JAX analysis dict and kept by
  ``record_segment_memory`` under the same ``segment_*_bytes`` gauges;
  ``memory_segments`` and ``peak_bytes_per_step`` read it back. The
  Executor reads ``torch.cuda.max_memory_allocated`` before and after the
  step and never resets it (a caller may be measuring its own peak): a step
  that sets a new high of the process is measured exactly, one that stays
  under an earlier high is not recorded (reset the high before it to have
  it measured). On the CPU nothing is measured and ``analyze_compiled``
  gives None. The serving pools measure their buckets' peaks with a reset
  of their own (``ReplicaPool.projected_bytes``).
- ``handle_oom`` escalates through ``anomaly.trip("oom")`` (the health
  gauge and a flight-recorder postmortem when it is armed).
"""

import os
import threading

from paddle_tpu_torch.monitor.registry import counter, gauge

__all__ = [
    "analyze_compiled", "record_segment_memory", "memory_segments",
    "peak_bytes_per_step", "ledger_set", "ledger_remove", "ledger",
    "ledger_total", "ledger_table", "enable", "disable", "poller_enabled",
    "sample_now", "high_water", "hbm_limit_bytes",
    "hbm_utilization_max", "device_usage", "top_live_buffers",
    "OutOfDeviceMemoryError", "is_oom_error", "oom_postmortem",
    "handle_oom", "admission_headroom", "summary_line", "reset",
]

#: env override for the per-device capacity where no card reports one;
#: also the serving admission limit's fallback
HBM_LIMIT_ENV = "PADDLE_TPU_HBM_LIMIT_BYTES"

_lock = threading.Lock()
_segments = {}            # group -> {index: {"temp_bytes", ...}}
_latest_group = None
_ledger = {}              # entity -> bytes
_high_water = {}          # device label -> peak observed in-use bytes

_g_temp = gauge(
    "segment_temp_bytes",
    "Temp bytes a prepared runner's first step allocated on the card "
    "beyond its arguments (measured peak minus the bytes resident at its "
    "start)", labels=("segment",))
_g_arg = gauge(
    "segment_argument_bytes",
    "Argument bytes of a prepared runner's step (its state, feeds and "
    "constants resident for the call)", labels=("segment",))
_g_peak = gauge(
    "segment_peak_bytes_estimate",
    "Measured peak device bytes of a prepared runner's first step "
    "(arguments + temps)", labels=("segment",))
_g_ledger = gauge(
    "memory_ledger_bytes",
    "Resident device/host bytes the memory ledger attributes to each "
    "named entity (params, optimizer slots, serving buckets, cache "
    "pools)", labels=("entity",))
_g_in_use = gauge(
    "hbm_bytes_in_use",
    "Allocated device bytes per card (torch.cuda.memory_allocated), "
    "sampled by the memory poller", labels=("device",))
_g_limit = gauge(
    "hbm_bytes_limit",
    "Device memory capacity bytes per card (torch.cuda.mem_get_info's "
    "total, else the PADDLE_TPU_HBM_LIMIT_BYTES override)",
    labels=("device",))
_g_util = gauge(
    "hbm_utilization",
    "hbm_bytes_in_use / hbm_bytes_limit per device, in [0, 1]; unset "
    "when no limit is known", labels=("device",))
_g_hwm = gauge(
    "hbm_bytes_high_water",
    "Peak hbm_bytes_in_use observed per device since process start "
    "(or the last reset)", labels=("device",))
_c_oom = counter(
    "oom_errors_total",
    "Device out-of-memory failures converted to typed "
    "OutOfDeviceMemoryError postmortems, by boundary",
    labels=("where",))


def analyze_compiled(compiled):
    """The JAX analysis dict ({'argument_bytes', 'output_bytes',
    'temp_bytes', 'alias_bytes', 'generated_code_bytes',
    'peak_bytes_estimate'}) of a step measured on the card: ``compiled`` is
    ``{"argument_bytes", "peak_bytes", "start_bytes"}`` (the step's
    arguments, ``torch.cuda.max_memory_allocated`` over the step and
    ``memory_allocated`` at its start), or None (the CPU: nothing measured),
    which gives None. The parameters are updated in place, so the outputs
    alias the arguments and count 0; the peak is arguments + temps."""
    if not compiled:
        return None
    arg = float(compiled.get("argument_bytes", 0) or 0)
    peak = float(compiled.get("peak_bytes", 0) or 0)
    start = float(compiled.get("start_bytes", 0) or 0)
    if not peak:
        return None
    tmp = max(0.0, peak - start)
    return {"argument_bytes": arg, "output_bytes": 0.0, "temp_bytes": tmp,
            "alias_bytes": 0.0, "generated_code_bytes": 0.0,
            "peak_bytes_estimate": arg + tmp}


def record_segment_memory(group, index, analysis):
    """Record one segment's analysis under ``group`` (the prepared runner's
    identity). The gauges mirror ONLY the most recent group, as
    ``cost.record_segment``'s do."""
    global _latest_group
    if not analysis:
        return
    with _lock:
        if group != _latest_group:
            _g_temp.clear()
            _g_arg.clear()
            _g_peak.clear()
        _segments.setdefault(group, {}).setdefault(
            int(index), {}).update(analysis)
        _latest_group = group
    seg = str(index)
    _g_temp.set(analysis.get("temp_bytes", 0.0), segment=seg)
    _g_arg.set(analysis.get("argument_bytes", 0.0), segment=seg)
    _g_peak.set(analysis.get("peak_bytes_estimate", 0.0), segment=seg)


def memory_segments(group=None):
    """{segment index: analysis dict} for ``group`` (default: the most
    recently recorded runner)."""
    with _lock:
        g = _latest_group if group is None else group
        return {i: dict(a) for i, a in _segments.get(g, {}).items()}


def peak_bytes_per_step():
    """Max peak across the latest runner's segments (segments run one
    after another, so the step's peak is the worst one, not the sum)."""
    with _lock:
        segs = _segments.get(_latest_group, {})
        return max((a.get("peak_bytes_estimate", 0.0)
                    for a in segs.values()), default=0.0)


# -- ledger ----------------------------------------------------------------

def ledger_set(entity, nbytes):
    """Attribute ``nbytes`` resident bytes to ``entity`` (a stable name like
    ``"serving/pool0:live/params"``); publishes the ``memory_ledger_bytes``
    series."""
    entity = str(entity)
    with _lock:
        _ledger[entity] = float(nbytes)
    _g_ledger.set(float(nbytes), entity=entity)


def ledger_remove(entity):
    """Forget ``entity`` and drop its gauge series (a released pool)."""
    entity = str(entity)
    with _lock:
        _ledger.pop(entity, None)
    _g_ledger.remove(entity=entity)


def ledger(prefix=None):
    """{entity: bytes}, optionally restricted to names under ``prefix``."""
    with _lock:
        if prefix is None:
            return dict(_ledger)
        return {k: v for k, v in _ledger.items() if k.startswith(prefix)}


def ledger_total(prefix=None):
    """Sum of ledger bytes, optionally under ``prefix``."""
    return sum(ledger(prefix).values())


def ledger_table(top=None):
    """[(entity, bytes)] sorted descending by bytes; ``top`` limits the
    rows."""
    rows = sorted(ledger().items(), key=lambda kv: -kv[1])
    return rows[:top] if top else rows


# -- runtime accounting ------------------------------------------------------

_poller = None                  # (thread, stop_event) when enabled


def _torch():
    import torch
    return torch


def _cards():
    """The cards this process can see (none on a CPU-only host)."""
    torch = _torch()
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device_label(dev):
    torch = _torch()
    try:
        dev = torch.device(dev)
        return f"{dev.type}:{dev.index or 0}"
    except Exception:
        return str(dev)


def hbm_limit_bytes(device=None):
    """Capacity bytes for ``device`` (a ``torch.device``, its string or a
    card index): the card's total memory from ``torch.cuda.mem_get_info``
    where ``device`` is a card, else the ``PADDLE_TPU_HBM_LIMIT_BYTES``
    override, else None (the CPU without the override)."""
    if device is not None:
        torch = _torch()
        try:
            dev = torch.device("cuda", device) if isinstance(device, int) \
                else torch.device(device)
            if dev.type == "cuda":
                return int(torch.cuda.mem_get_info(dev)[1])
        except Exception:
            pass
    v = os.environ.get(HBM_LIMIT_ENV)
    try:
        return int(float(v)) if v else None
    except ValueError:
        return None


def device_usage():
    """{device label: allocated bytes} per card right now
    (``torch.cuda.memory_allocated``: the caching allocator's live tensor
    bytes, not its cached reserve); {} on a CPU-only host."""
    torch = _torch()
    return {_device_label(d): int(torch.cuda.memory_allocated(d))
            for d in _cards()}


def top_live_buffers(k=8):
    """[{'shape', 'dtype', 'nbytes', 'device'}] for the ``k`` largest active
    blocks of ``torch.cuda.memory_snapshot()``. The allocator knows a
    block's size and card, not the tensor's shape or dtype: those keys are
    None."""
    torch = _torch()
    if not _cards():
        return []
    rows = []
    for seg in torch.cuda.memory_snapshot():
        dev = f"cuda:{seg.get('device', 0)}"
        for blk in seg.get("blocks", ()):
            if blk.get("state") == "active_allocated":
                rows.append({"shape": None, "dtype": None,
                             "nbytes": int(blk.get("size", 0)),
                             "device": dev})
    rows.sort(key=lambda r: -r["nbytes"])
    return rows[:k]


def sample_now():
    """Take one sample synchronously: refresh the in-use / limit /
    utilization gauges per card and advance the high-water marks. Returns
    the {device: bytes} usage map; never raises (telemetry must not fail a
    step)."""
    try:
        cards = _cards()
        usage = device_usage()
        limits = {_device_label(d): hbm_limit_bytes(d) for d in cards}
    except Exception:
        return {}
    with _lock:
        for lbl, used in usage.items():
            if used > _high_water.get(lbl, 0):
                _high_water[lbl] = used
    for lbl, used in usage.items():
        _g_in_use.set(float(used), device=lbl)
        _g_hwm.set(float(_high_water.get(lbl, used)), device=lbl)
        limit = limits.get(lbl) or hbm_limit_bytes()
        if limit:
            _g_limit.set(float(limit), device=lbl)
            _g_util.set(used / float(limit), device=lbl)
    return usage


def _poll_loop(stop, interval):
    while not stop.wait(interval):
        sample_now()


def enable(interval=2.0):
    """Start the background poller (a daemon thread sampling every
    ``interval`` seconds). Idempotent; takes one sample immediately."""
    global _poller
    with _lock:
        if _poller is not None:
            return
        stop = threading.Event()
        t = threading.Thread(target=_poll_loop, args=(stop, float(interval)),
                             name="memory-poller", daemon=True)
        _poller = (t, stop)
    sample_now()
    t.start()


def disable():
    """Stop the poller and drop the runtime gauge series (disabled means no
    recording, not stale last values)."""
    global _poller
    with _lock:
        p, _poller = _poller, None
    if p is not None:
        p[1].set()
        p[0].join(timeout=5.0)
    _g_in_use.clear()
    _g_util.clear()


def poller_enabled():
    with _lock:
        return _poller is not None


def high_water(device=None):
    """Peak observed in-use bytes: for ``device`` (label) when given, else
    the max across devices; 0 before any sample."""
    with _lock:
        if device is not None:
            return _high_water.get(device, 0)
        return max(_high_water.values(), default=0)


def hbm_utilization_max():
    """Worst-device utilization in [0, 1] from the last sample, or None when
    no limit is known or no sample was taken: the ShedController's
    HBM-pressure input."""
    vals = list(_g_util.samples().values())
    return max(vals) if vals else None


# -- OOM postmortem --------------------------------------------------------

class OutOfDeviceMemoryError(RuntimeError):
    """A device allocation failed, re-raised with attribution:
    ``.postmortem`` holds the ledger table, the largest active blocks, the
    failing boundary and the per-card in-use, limit and peak bytes."""

    def __init__(self, message, postmortem=None):
        super().__init__(message)
        self.postmortem = postmortem or {}


_OOM_MARKERS = ("resource_exhausted", "resource exhausted",
                "out of memory", "oom")


def is_oom_error(exc):
    """True when ``exc`` is a device out-of-memory failure:
    ``torch.cuda.OutOfMemoryError``, a ``MemoryError``, or a message with
    the markers the JAX function matches (RESOURCE_EXHAUSTED, out of
    memory)."""
    if exc is None:
        return False
    if isinstance(exc, (OutOfDeviceMemoryError, MemoryError)):
        return True
    oom = getattr(getattr(_torch(), "cuda", None), "OutOfMemoryError", None)
    if oom is not None and isinstance(exc, oom):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _OOM_MARKERS)


def _first_limit():
    limit = hbm_limit_bytes()
    cards = _cards()
    if cards:
        limit = hbm_limit_bytes(cards[0]) or limit
    return limit


def oom_postmortem(where, exc=None, top_k=8):
    """The postmortem dict: the ledger's attribution, the largest active
    blocks, and the in-use / limit / high-water / peak-allocated bytes
    (``peak_bytes`` is ``torch.cuda.max_memory_allocated``: measured, where
    the JAX package reports XLA's compile-time estimate)."""
    try:
        usage = sample_now()
    except Exception:
        usage = {}
    try:
        buffers = top_live_buffers(top_k)
    except Exception:
        buffers = []
    try:
        torch = _torch()
        peak = {_device_label(d): int(torch.cuda.max_memory_allocated(d))
                for d in _cards()}
    except Exception:
        peak = {}
    return {
        "where": str(where),
        "error": str(exc) if exc is not None else None,
        "ledger": ledger_table(),
        "top_live_buffers": buffers,
        "peak_bytes": peak,
        "hbm_bytes_in_use": dict(usage),
        "hbm_bytes_limit": _first_limit(),
        "hbm_bytes_high_water": dict(_high_water),
        "segments": memory_segments(),
        "peak_bytes_estimate": peak_bytes_per_step(),
    }


def handle_oom(exc, where, step=None):
    """Convert a device OOM into the typed error: build the postmortem, bump
    ``oom_errors_total{where=...}`` and raise :class:`OutOfDeviceMemoryError`
    chained from the original, after the ``anomaly.trip("oom")``
    escalation (health gauge + flight-recorder dump embedding the in-flight
    trace). Callers invoke this only after ``is_oom_error(exc)``."""
    pm = oom_postmortem(where, exc)
    _c_oom.inc(where=str(where))
    try:
        from paddle_tpu_torch.monitor import anomaly
        anomaly.trip("oom", report=pm, step=step)
    except Exception:
        pass
    peak = max(pm.get("peak_bytes", {}).values(), default=0)
    limit = pm.get("hbm_bytes_limit")
    msg = (f"device out of memory at {where}: peak allocated "
           f"{_fmt_bytes(peak)}"
           + (f" vs limit {_fmt_bytes(limit)}" if limit else "")
           + "; top resident: "
           + ", ".join(f"{e}={_fmt_bytes(b)}" for e, b in pm["ledger"][:3]))
    raise OutOfDeviceMemoryError(msg, postmortem=pm) from exc


# -- admission -------------------------------------------------------------

def admission_headroom(projected_bytes, limit=None):
    """(ok, projected, limit): would adding ``projected_bytes`` on top of the
    resident high-water mark (or the ledger's total, whichever is larger)
    still fit under ``limit`` (default: the card's or the env's)? ``ok`` is
    True when no limit is known: admission is advisory without one."""
    if limit is None:
        limit = _first_limit()
    resident = max(high_water(), int(ledger_total()))
    projected = int(resident + projected_bytes)
    if not limit:
        return True, projected, None
    return projected <= int(limit), projected, int(limit)


# -- reporting -------------------------------------------------------------

def _fmt_bytes(n):
    try:
        n = float(n)
    except (TypeError, ValueError):
        return "?"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.2f}{unit}"
        n /= 1024.0


def summary_line():
    """One human line: the per-device high-water mark (against the limit
    when known) and the top three ledger entries, or None when nothing was
    recorded."""
    with _lock:
        hwm = dict(_high_water)
    rows = ledger_table(top=3)
    if not hwm and not rows:
        return None
    parts = []
    if hwm:
        limit = hbm_limit_bytes()
        peak = max(hwm.values())
        parts.append("high-water " + _fmt_bytes(peak)
                     + (f"/{_fmt_bytes(limit)}" if limit else "")
                     + f" across {len(hwm)} device(s)")
    if rows:
        parts.append("top: " + ", ".join(
            f"{e}={_fmt_bytes(b)}" for e, b in rows))
    return "memory: " + "; ".join(parts)


def reset():
    """Forget the ledger and high-water marks, stop the poller and drop
    every gauge series (tests)."""
    disable()
    global _latest_group
    with _lock:
        _ledger.clear()
        _high_water.clear()
        _segments.clear()
        _latest_group = None
    _g_temp.clear()
    _g_arg.clear()
    _g_peak.clear()
    _g_ledger.clear()
    _g_in_use.clear()
    _g_limit.clear()
    _g_util.clear()
    _g_hwm.clear()
