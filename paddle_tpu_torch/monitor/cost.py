"""Cost analytics: per-segment FLOPs/bytes and MFU, the port of
``paddle_tpu/monitor/cost.py``.

The JAX package reads XLA's analytical cost model off each compiled
segment's lowering. The port has no lowering; its counterpart is an
**abstract pass** over a prepared runner's ops, queued once per runner by
the Executor (``FLAGS_monitor_cost``, on by default) and run the first time
a reader asks (``defer_step``):

- ``analyze_step(ops, env, interpret)`` runs ``ops`` through the Executor's
  interpreter on ``meta`` copies of the state, feeds and constants (shapes,
  no values, no launch on any card), inside
  ``ops.kernels.registry.meta_shapes()`` so that every registered kernel is
  counted through its plain body, and under
  ``torch.utils.flop_counter.FlopCounterMode`` (2·M·N·K per matrix product,
  the convolutions and attention likewise; elementwise work counts 0).
  Counting the real step instead would miss every hand-written kernel (a
  ctypes launch is no aten op) and would run a state-mutating step twice.
- **Bytes** are each aten op's input plus output bytes on the same pass
  (views and aliases count nothing). This is the traffic of the op-by-op
  program, not XLA's post-fusion count: read it as an upper bound of what a
  step must move.
- **Where the pass stops.** A host op (``py_func``) stops it, as host
  segments stop the JAX walk: the recorded segment is the ops before the
  first host op. An op that ``meta`` cannot run (a data-dependent shape, a
  host read of a device value) stops it too; then nothing is recorded for
  that runner. The probe is never fatal.
- **When it runs.** The pass takes a second or two of host time at a
  model's width, so the Executor's first step of a runner only takes the
  ``meta`` copies (shapes, no data) and queues it; ``flops_per_step``,
  ``bytes_per_step``, ``segments`` and ``estimate_mfu`` (and so
  ``profiler.summary``) run what is queued for the runner they read, and
  the ``segment_flops``/``segment_bytes`` gauges are set then. A queued
  pass of a runner superseded before anything read it is dropped unrun.

``flops_per_step()`` sums the most recently recorded runner's segments
(older runners are superseded, not accumulated). ``estimate_comm`` stays a
parser of XLA's optimized HLO text, for the JAX package's dumps; the port's
Executor records 0 collective bytes (``record_segment_comm``) at world size
1. ``estimate_mfu()`` divides the achieved FLOP/s (``flops_per_step`` over
the ``executor_step_ms`` histogram's mean) by ``peak_flops()``.

``peak_flops()`` is ``PADDLE_TPU_PEAK_FLOPS`` when set, else the H100 SXM's
dense bf16 tensor-core peak (989e12 FLOP/s). An fp32 model run with TF32
off computes on the SIMT units, whose fp32 peak is 67e12 FLOP/s: set
``PADDLE_TPU_PEAK_FLOPS=67e12`` to read its MFU against what it can reach;
against the default its MFU reads ~15x lower. torch is imported inside the
functions only: the module loads under a stdlib-only launcher.
"""

import os
import re
import threading

from paddle_tpu_torch.monitor.registry import counter, gauge, histogram

__all__ = [
    "analyze_step", "defer_step", "estimate_comm", "record_segment",
    "record_segment_comm", "segments", "flops_per_step",
    "bytes_per_step", "comm_bytes_per_step", "estimate_mfu",
    "peak_flops", "record_pass", "pass_evidence", "reset",
]

#: H100 SXM dense bf16 tensor-core peak; override with
#: PADDLE_TPU_PEAK_FLOPS for other hardware or precisions (67e12 for fp32
#: SIMT with TF32 off)
DEFAULT_PEAK_FLOPS = 989e12

_lock = threading.Lock()
_run_lock = threading.Lock()     # one thread runs the queued passes
_segments = {}                  # group -> {index: {"flops","bytes"}}
_pending = {}                   # group -> {index: (ops, meta env, interpret)}
_latest_group = None

_g_flops = gauge(
    "segment_flops",
    "Analytical FLOPs per execution of each compiled device segment "
    "(XLA cost model via lowered.cost_analysis)", labels=("segment",))
_g_bytes = gauge(
    "segment_bytes",
    "Analytical bytes accessed per execution of each compiled device "
    "segment", labels=("segment",))
_g_comm = gauge(
    "segment_comm_bytes",
    "Estimated cross-device collective bytes per execution of each "
    "compiled device segment (result-buffer bytes of the collective "
    "ops in the post-SPMD optimized HLO)", labels=("segment",))

# program-level pass pipeline evidence (static/opt_passes.py): one
# record_pass call per pass application at runner build time
_c_pass_runs = counter(
    "program_pass_runs_total",
    "Applications of each program-level optimization pass "
    "(static/opt_passes.py; one per pass per step compile/export)",
    labels=("pass",))
_c_pass_removed = counter(
    "program_pass_ops_removed_total",
    "Program ops removed (folded, fused away, or dead-eliminated) by "
    "each optimization pass, summed over applications",
    labels=("pass",))
_h_pass_ms = histogram(
    "program_pass_ms",
    "Wall ms per optimization-pass application (program-level pass "
    "pipeline ahead of segment compilation)")
_g_pass_flops_delta = gauge(
    "program_pass_flops_delta",
    "Predicted analytical-FLOPs change of the last application of each "
    "optimization pass (post minus pre lowering cost_analysis, "
    "negative = cheaper; FLAGS_pass_cost_evidence probe)",
    labels=("pass",))
_g_pass_bytes_delta = gauge(
    "program_pass_bytes_delta",
    "Predicted bytes-accessed change of the last application of each "
    "optimization pass (post minus pre lowering cost_analysis, "
    "negative = cheaper; FLAGS_pass_cost_evidence probe)",
    labels=("pass",))

_pass_totals = {}               # pass name -> {"runs", "ops_removed"}

# collective instructions in XLA's post-SPMD optimized HLO text; the
# result type precedes the op name ("%x = f32[4,8]{1,0} all-reduce(..."
# or a tuple "(f32[128]{0}, f32[64]{0})" for fused buckets). Async split
# pairs count on -done only: a -start op's result tuple bundles operands,
# results and scheduling context.
_COLL_RE = re.compile(
    r"=\s+(\([^)]*\)|\S+)\s+"
    r"(all-reduce|all-gather|all-to-all|collective-permute|"
    r"reduce-scatter|collective-broadcast)(-start|-done)?\(")
_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")
_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}


def _type_bytes(type_str):
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(type_str):
        size = _DTYPE_BYTES.get(dt)
        if size is None:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * size
    return total


def estimate_comm(hlo_text):
    """{'comm_bytes': float, 'collectives': {op: count}} from an optimized
    HLO text, or None when there is no text: the sum of the collectives'
    result-buffer bytes per execution (async pairs counted on their
    -done)."""
    if not hlo_text:
        return None
    comm = 0.0
    counts = {}
    for type_str, op, suffix in _COLL_RE.findall(hlo_text):
        if suffix == "-start":
            continue
        counts[op] = counts.get(op, 0) + 1
        comm += _type_bytes(type_str)
    return {"comm_bytes": comm, "collectives": counts}


def _meta_copy(v):
    import torch
    if isinstance(v, torch.Tensor):
        return torch.empty_strided(tuple(v.shape), tuple(v.stride()),
                                   dtype=v.dtype, device="meta")
    return v


def _nbytes(tree):
    import torch
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _bytes_mode():
    """A dispatch mode summing every aten op's input + output bytes (an op
    whose results alias its inputs without writing them, a view, counts
    nothing)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Bytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns)
            if not view:
                self.total += _nbytes((args, kwargs)) + _nbytes(out)
            return out

    return _Bytes()


def analyze_step(ops, env, interpret):
    """{'flops': float, 'bytes': float} of running ``ops`` over ``env``
    ({name: value}) with ``interpret(ops, env)``, counted on ``meta``
    copies of the tensors (module docstring), or None when ``meta`` cannot
    run them. No value is computed and nothing launches."""
    return _analyze_meta(ops, {k: _meta_copy(v) for k, v in env.items()},
                         interpret)


def _analyze_meta(ops, meta, interpret):
    from torch.utils.flop_counter import FlopCounterMode

    from paddle_tpu_torch.ops.kernels.registry import meta_shapes
    nb = _bytes_mode()
    try:
        with meta_shapes(), FlopCounterMode(display=False) as fc, nb:
            interpret(ops, meta)
    except Exception:           # a data-dependent op: nothing recorded
        return None
    return {"flops": float(fc.get_total_flops()), "bytes": float(nb.total)}


def _switch(group):
    """Make ``group`` the latest (the caller holds ``_lock``): a new group
    drops the superseded one's gauge series and every other group's
    unread queued pass."""
    global _latest_group
    if group != _latest_group:
        _g_flops.clear()
        _g_bytes.clear()
        _g_comm.clear()
        for g in [g for g in _pending if g != group]:
            del _pending[g]
    _latest_group = group


def defer_step(group, index, ops, env, interpret):
    """Queue ``analyze_step(ops, env, interpret)`` as segment ``index`` of
    ``group`` (the prepared runner's identity), which becomes the latest:
    the ``meta`` copies are taken now, the pass runs the first time a
    reader asks for the group (module docstring)."""
    meta = {k: _meta_copy(v) for k, v in env.items()}
    with _lock:
        _switch(group)
        _pending.setdefault(group, {})[int(index)] = (list(ops), meta,
                                                      interpret)


def _run_pending(group):
    """Run ``group``'s queued passes, record what they count and, when it
    is still the latest group, set its gauges."""
    with _run_lock:
        with _lock:
            queued = _pending.pop(group, None)
        for index, (ops, meta, interpret) in sorted((queued or {}).items()):
            analysis = _analyze_meta(ops, meta, interpret)
            if analysis is None:
                continue
            with _lock:
                _segments.setdefault(group, {}).setdefault(
                    index, {}).update(analysis)
                latest = group == _latest_group
            if latest:
                _g_flops.set(analysis["flops"], segment=str(index))
                _g_bytes.set(analysis["bytes"], segment=str(index))


def record_segment(group, index, analysis):
    """Record one device segment's cost under ``group`` (the prepared
    runner's identity); the latest group becomes the per-step total
    ``flops_per_step`` reports. The gauges mirror ONLY the latest group:
    when a new runner starts recording, the superseded one's series are
    dropped."""
    if not analysis:
        return
    with _lock:
        _switch(group)
        _segments.setdefault(group, {}).setdefault(
            int(index), {}).update(analysis)
    _g_flops.set(analysis["flops"], segment=str(index))
    _g_bytes.set(analysis["bytes"], segment=str(index))


def record_segment_comm(group, index, comm):
    """Record one device segment's estimated collective bytes (an
    ``estimate_comm`` result) under ``group``; same latest-group gauge
    semantics as ``record_segment``."""
    if not comm:
        return
    with _lock:
        _switch(group)
        entry = _segments.setdefault(group, {}).setdefault(int(index), {})
        entry["comm_bytes"] = float(comm.get("comm_bytes", 0.0))
        entry["collectives"] = dict(comm.get("collectives", {}))
    _g_comm.set(float(comm.get("comm_bytes", 0.0)), segment=str(index))


def segments(group=None):
    """{segment index: {"flops","bytes"}} for ``group`` (default: the most
    recently recorded runner), its queued pass run first."""
    g = _latest_group if group is None else group
    _run_pending(g)
    with _lock:
        return {i: dict(a) for i, a in _segments.get(g, {}).items()}


def _total(key):
    _run_pending(_latest_group)
    with _lock:
        segs = _segments.get(_latest_group, {})
        return sum(a.get(key, 0.0) for a in segs.values())


def flops_per_step():
    return _total("flops")


def bytes_per_step():
    return _total("bytes")


def comm_bytes_per_step():
    return _total("comm_bytes")


def record_pass(name, ops_removed=0, ms=0.0, flops_delta=None,
                bytes_delta=None):
    """Publish one optimization-pass application (``opt_passes`` calls
    this): bumps the program_pass_* metrics and folds into the in-process
    evidence table ``pass_evidence`` reports. ``flops_delta`` /
    ``bytes_delta`` (``FLAGS_pass_cost_evidence``) are the pass's predicted
    cost change, signed."""
    name = str(name)
    _c_pass_runs.inc(**{"pass": name})
    if ops_removed:
        _c_pass_removed.inc(float(ops_removed), **{"pass": name})
    _h_pass_ms.observe(float(ms))
    if flops_delta is not None:
        _g_pass_flops_delta.set(float(flops_delta), **{"pass": name})
    if bytes_delta is not None:
        _g_pass_bytes_delta.set(float(bytes_delta), **{"pass": name})
    with _lock:
        t = _pass_totals.setdefault(name, {"runs": 0, "ops_removed": 0})
        t["runs"] += 1
        t["ops_removed"] += int(ops_removed)
        if flops_delta is not None:
            t["flops_delta"] = t.get("flops_delta", 0.0) + float(flops_delta)
        if bytes_delta is not None:
            t["bytes_delta"] = t.get("bytes_delta", 0.0) + float(bytes_delta)


def pass_evidence():
    """{pass name: {"runs", "ops_removed"[, "flops_delta",
    "bytes_delta"]}} accumulated since process start (or the last
    ``reset``)."""
    with _lock:
        return {k: dict(v) for k, v in _pass_totals.items()}


def peak_flops():
    v = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
    try:
        return float(v) if v else DEFAULT_PEAK_FLOPS
    except ValueError:
        return DEFAULT_PEAK_FLOPS


def estimate_mfu(ms_per_step=None):
    """Model FLOPs utilization in [0, 1], or None when either side of the
    ratio is missing. ``ms_per_step`` defaults to the mean of the
    ``executor_step_ms`` histogram (wall time around the step: on a
    host-bound model this understates the card's utilization)."""
    flops = flops_per_step()
    if not flops:
        return None
    if ms_per_step is None:
        from paddle_tpu_torch.monitor.registry import REGISTRY
        h = REGISTRY.get("executor_step_ms")
        if h is None or h.count() == 0:
            return None
        ms_per_step = h.sum() / h.count()
    if ms_per_step <= 0:
        return None
    return flops / (ms_per_step / 1e3) / peak_flops()


def reset():
    """Forget recorded segments and their gauge series (tests)."""
    global _latest_group
    with _lock:
        _segments.clear()
        _pending.clear()
        _latest_group = None
        _pass_totals.clear()
    _g_flops.clear()
    _g_bytes.clear()
    _g_comm.clear()
