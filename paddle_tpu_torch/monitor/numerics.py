"""Numerics sentinels and the non-finite localizer: the port of
``paddle_tpu/monitor/numerics.py`` behind ``FLAGS_check_nan_inf``.

The reference scans every op's outputs on the host after every kernel
(``framework/operator.cc``); a host check per op would serialize the
launch queue. The port keeps the JAX package's shape of the switch, wired
through ``static/executor.py``:

- **Sentinels on the device.** A *segment* is a run of device ops between
  host ops (``py_func``), as the JAX package cuts its compiled segments, so
  ``segment`` means the same in both packages. Under the flag, at the end of
  each device segment the step computes ``sentinel()``: one device bool, True
  iff every float tensor the segment wrote (outputs, grads, optimizer state)
  is finite. It is a max-abs norm per tensor in a few multi-tensor launches
  (``torch._foreach_norm(ts, inf)``), then ``isfinite().all()``: a max is
  non-finite exactly when an element is, where a plain sum of finite
  values can overflow. The host reads the stacked flags once, after the ops
  and before the new state reaches the scope.
- **A snapshot, because the port updates in place.** ``apply_optimizer``
  and the fused SGD/momentum/Adam kernels write into the tensors they are
  given. Under the flag the Executor runs the step on clones of the
  persistables and puts them in the scope only once the sentinel is read,
  so a trip leaves the scope's parameters bitwise at their pre-step values.
  Peak memory grows by one copy of the state, as the JAX checked mode's
  (which skips buffer donation) does.
- **Bisecting localizer.** ``localize()`` replays the tripped step op by op
  from the pre-step state with the step's own ``@step@`` (so every op that
  draws, dropout included, draws the same mask), recording a device-side
  cumulative finiteness flag after every op with no host read, then bisects
  the monotone flags with O(log n_ops) host reads to the first op whose
  outputs went non-finite, and names its first non-finite output with nan
  and inf counts. At the ``autodiff`` op each ``<param>@GRAD`` leaf is
  checked on its own. It refuses to replay across a host op.
- **Postmortem.** ``handle_trip`` counts the trip
  (``nonfinite_trips_total``), routes it through ``monitor.anomaly`` (a
  flight-recorder dump carrying the report, when armed) and raises
  :class:`NonFiniteError` with the report.
"""

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.monitor.registry import counter

__all__ = ["NonFiniteError", "sentinel", "localize", "handle_trip",
           "SENTINEL_KEY"]

#: key of a segment's flag among its outputs (the JAX package's name);
#: "@" keeps it out of any legal program var namespace
SENTINEL_KEY = "@sentinel@"

_m_trips = counter(
    "nonfinite_trips_total",
    "In-graph isfinite-sentinel trips (FLAGS_check_nan_inf): steps "
    "whose compiled segment produced a nan/inf tensor")


class NonFiniteError(EnforceNotMet):
    """A step produced nan/inf under FLAGS_check_nan_inf. ``report``
    carries the localizer's findings (first bad tensor and op, counts,
    postmortem path) as a dict, the dict the postmortem JSON embeds under
    ``anomaly``."""

    def __init__(self, msg, report=None):
        super().__init__(msg)
        self.report = dict(report or {})


def _checkable(v):
    import torch
    return (isinstance(v, torch.Tensor) and v.is_floating_point()
            and v.numel() > 0)


def finite_flags(values):
    """A device bool tensor [k]: for each float tensor of ``values`` (ints,
    bools, empties and non-tensors are skipped: nothing to check), whether
    all its elements are finite; None when none is checkable. One
    multi-tensor max-abs launch per dtype, then a stack."""
    import torch
    ts = [v.detach() for v in values if _checkable(v)]
    if not ts:
        return None
    with torch.no_grad():
        norms = torch._foreach_norm(ts, float("inf"))
        if len({n.dtype for n in norms}) > 1:
            norms = [n.float() for n in norms]
        return torch.stack(norms).isfinite()


def sentinel(values, device=None):
    """ONE 0-d device bool: True iff every float element of every value is
    finite (True, on ``device``, for an empty or uncheckable list: the
    Executor stacks every segment's flag on its own device)."""
    import torch
    f = finite_flags(values)
    if f is None:
        return torch.ones((), dtype=torch.bool, device=device)
    return f.all()


def snapshot(state):
    """Clones of the tensors of ``state`` ({name: value}): a checked step
    runs on them, so nothing reaches the scope before its sentinels are
    read."""
    import torch
    return {n: v.clone() if isinstance(v, torch.Tensor) else v
            for n, v in state.items()}


def read_flags(flags):
    """The checked step's one host read: [bool] of the segments'
    sentinels, in segment order."""
    import torch
    return torch.stack(flags).tolist()


class _Stop(Exception):
    def __init__(self, outs):
        super().__init__()
        self.outs = outs


def _replay_records(step, state, feeds, base_key, step_idx, end_seg,
                    want_outputs_of=None):
    """Re-run segments [0, end_seg] op by op from clones of ``state``,
    returning ``(records, wanted_outputs)``: one ``(op_idx, op_type,
    [names], flags, cum)`` per op with a checkable output, ``flags`` a
    device bool per name and ``cum`` the AND of every flag so far (the
    monotone signal the bisection needs). No host read happens here, and
    the records hold flags, not tensors. ``want_outputs_of=k`` stops after
    op k and returns its outputs (the second, bounded pass)."""
    import torch
    records = []
    cum = [None]
    hi = step.segs[end_seg][2]

    def after_op(k, op, outs):
        if want_outputs_of == k:
            raise _Stop(outs)
        names = [n for n in sorted(outs) if _checkable(outs[n])]
        if not names:
            return
        flags = finite_flags([outs[n] for n in names])
        c = flags.all()
        cum[0] = c if cum[0] is None else torch.logical_and(cum[0], c)
        records.append((k, op.type, names, flags, cum[0]))

    try:
        step.replay(state, feeds, base_key, step_idx, hi, after_op)
    except _Stop as s:
        return records, s.outs
    return records, None


def localize(step, state, feeds, base_key, step_idx, bad_dev_index):
    """Name the first non-finite tensor and its producing op by replay and
    bisection (module docstring). ``step`` is the Executor's prepared
    runner, ``state`` the pre-step persistables (cloned before the replay
    touches them), ``base_key`` the program's random seed and ``step_idx``
    the tripped run's ``@step@``. Returns a report dict, or one with
    ``localized=False`` when the replay is unsafe (a host op before the
    tripped segment, whose re-execution would repeat its side effects) or
    found nothing."""
    dev = -1
    end_seg = None
    for si, (is_host, _a, _b) in enumerate(step.segs):
        if is_host:
            return {"localized": False, "segment": int(bad_dev_index),
                    "why": "program contains host ops (RPC/save); "
                           "eager replay would repeat their side "
                           "effects"}
        dev += 1
        if dev == bad_dev_index:
            end_seg = si
            break
    if end_seg is None:
        return {"localized": False, "segment": int(bad_dev_index),
                "why": "tripped segment index out of range"}
    try:
        records, _ = _replay_records(step, state, feeds, base_key,
                                     step_idx, end_seg)
    except Exception as e:      # the replay must never mask the trip
        return {"localized": False, "segment": int(bad_dev_index),
                "why": f"eager replay failed: "
                       f"{type(e).__name__}: {e}"}
    if not records or bool(records[-1][4]):
        return {"localized": False, "segment": int(bad_dev_index),
                "why": "sentinel tripped but the eager replay stayed "
                       "finite (non-deterministic op or stale state?)"}
    # bisect the monotone cumulative flags: O(log n_ops) host reads
    lo_i, hi_i = 0, len(records) - 1
    while lo_i < hi_i:
        mid = (lo_i + hi_i) // 2
        if bool(records[mid][4]):
            lo_i = mid + 1
        else:
            hi_i = mid
    op_idx, op_type, names, flags, _ = records[lo_i]
    ok = flags.tolist()
    # second bounded replay: only the culprit op's outputs
    try:
        _, outs = _replay_records(step, state, feeds, base_key, step_idx,
                                  end_seg, want_outputs_of=op_idx)
    except Exception as e:
        return {"localized": False, "segment": int(bad_dev_index),
                "op_index": int(op_idx), "op_type": op_type,
                "why": f"culprit-op re-execution failed: "
                       f"{type(e).__name__}: {e}"}
    outs = outs or {}
    for name, good in zip(names, ok):
        if good or name not in outs:
            continue
        t = outs[name].detach()
        return {
            "localized": True,
            "tensor": name,
            "op_type": op_type,
            "op_index": int(op_idx),
            "segment": int(bad_dev_index),
            "shape": list(t.shape),
            "dtype": str(t.dtype).replace("torch.", ""),
            "nan_count": int(t.isnan().sum()),
            "inf_count": int(t.isinf().sum()),
            "size": int(t.numel()),
        }
    return {"localized": False, "segment": int(bad_dev_index),
            "why": "bad op found but no single non-finite output "
                   "(flag/value mismatch)"}


def handle_trip(step, state, feeds, base_key, step_idx, bad_dev_index):
    """The Executor's trip path: count it, localize it, leave a postmortem
    (through ``monitor.anomaly``, when the flight recorder is armed) and
    raise :class:`NonFiniteError`. Never returns."""
    from paddle_tpu_torch.monitor import anomaly

    _m_trips.inc()
    report = localize(step, state, feeds, base_key, step_idx,
                      bad_dev_index)
    report["step"] = int(step_idx)
    path = anomaly.trip("non_finite", report=report, step=int(step_idx))
    if path:
        report["postmortem"] = path
    if report.get("localized"):
        where = (f"first non-finite tensor {report['tensor']!r} "
                 f"(shape {tuple(report['shape'])}, "
                 f"{report['nan_count']} nan / {report['inf_count']} "
                 f"inf of {report['size']}) produced by op "
                 f"{report['op_type']!r} at position "
                 f"{report['op_index']}")
    else:
        where = (f"in device segment {report['segment']} "
                 f"(not localized: {report.get('why')})")
    raise NonFiniteError(
        f"FLAGS_check_nan_inf: step {int(step_idx)} produced "
        f"nan/inf — {where}"
        + (f"; postmortem: {path}" if path else ""),
        report=report)
