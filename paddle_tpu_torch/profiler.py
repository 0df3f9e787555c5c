"""Profiler: the port of ``paddle_tpu/profiler.py``.

Parity: python/paddle/fluid/profiler.py (start_profiler, stop_profiler,
the profiler context manager, reset_profiler) over the reference's
two-layer host + CUPTI tracer (platform/profiler.h,
platform/device_tracer.h, tools/timeline.py). Host spans are recorded
here; with a ``trace_dir``, device tracing is ``torch.profiler`` (CPU and
CUDA activities, CUPTI underneath), which plays the role ``jax.profiler``
plays in the JAX package: its Chrome trace lands in ``trace_dir`` as
``torch_trace.<pid>.json`` and ``device_kernel_times()`` reads its kernels.

Event storage is a BOUNDED ring with thread-local shards (the
monitor-registry sharding pattern): appends touch only the calling
thread's deque, and a long run cannot grow host memory without bound (cap
via ``set_max_events``, default 1e6 per thread, env
``PADDLE_TPU_PROFILER_MAX_EVENTS``). When the flight recorder
(monitor/flight_recorder.py) is armed, ``RecordEvent`` also feeds it, so a
postmortem names the span a dying rank was stuck inside.
"""

import collections
import contextlib
import json
import os
import threading
import time

from paddle_tpu_torch.core.enforce import warn_once
from paddle_tpu_torch.monitor import flight_recorder as _flight
from paddle_tpu_torch.monitor.registry import _ThreadShards

__all__ = [
    "profiler", "start_profiler", "stop_profiler", "reset_profiler",
    "RecordEvent", "record_memory_event", "export_chrome_trace",
    "compilation_cache_stats", "set_max_events", "cuda_profiler",
    "device_kernel_times",
]

_DEFAULT_MAX_EVENTS = int(os.environ.get(
    "PADDLE_TPU_PROFILER_MAX_EVENTS", str(1_000_000)))


class _ShardedRing:
    """Bounded event store, one deque per writer thread (the shared
    monitor-registry shard idiom: registered under a lock once per
    thread, appended lock-free after; dead threads' deques fold into
    one bounded retired ring so thread churn cannot pin memory). The
    cap is read at every append, so ``set_max_events`` takes effect
    live; it bounds EACH live thread's shard — the reference's profiler
    grows one vector per thread the same way (profiler.cc thread-local
    EventList)."""

    def __init__(self, cap):
        self.cap = int(cap)
        self._retired = collections.deque()
        self._shards = _ThreadShards(collections.deque, self._retire)

    def _retire(self, d):
        self._retired.extend(d)
        self._trim(self._retired)

    def _trim(self, d):
        while len(d) > self.cap:
            try:
                d.popleft()
            except IndexError:
                # a concurrent clear() emptied the deque between the
                # length check and the pop — exactly the state the trim
                # wanted, so done
                break

    def append(self, item):
        d = self._shards.get()
        d.append(item)
        self._trim(d)

    def _all(self):
        return [self._retired] + self._shards.shards()

    def snapshot(self):
        out = []
        for d in self._all():
            out.extend(list(d))
        return out

    def clear(self):
        for d in self._all():
            d.clear()

    def __iter__(self):
        return iter(self.snapshot())

    def __len__(self):
        return sum(len(d) for d in self._all())


_events = _ShardedRing(_DEFAULT_MAX_EVENTS)   # (name, t0, dur, tid, args)
_mem_events = _ShardedRing(_DEFAULT_MAX_EVENTS)  # (name, ts, bytes, place)
_active = {"on": False, "trace_dir": None, "torch_prof": None,
           "last": None}


def set_max_events(n):
    """Cap the profiler's per-thread event rings (oldest events drop
    first). Returns the previous cap."""
    prev = _events.cap
    _events.cap = _mem_events.cap = max(int(n), 1)
    return prev


class RecordEvent:
    """RAII span (ref: platform/profiler.h:81 RecordEvent). Feeds the
    profiler ring when profiling is on AND the flight recorder when it
    is armed — a postmortem can name in-flight spans even when the
    profiler was never started. ``args`` rides into the recorded event
    (and the Chrome export); the executor passes ``{"flow": id}`` so
    ``export_chrome_trace`` can pair each dispatch with the fetch that
    materialized it BY ID instead of FIFO order."""

    def __init__(self, name, args=None):
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter()
        if _flight._enabled:
            _flight.RECORDER.span_push(self.name)
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        if _active["on"]:
            _events.append((self.name, self.t0, dur,
                            threading.get_ident(), self.args))
        if _flight._enabled:
            _flight.RECORDER.span_pop(self.name, dur)


def record_memory_event(name, nbytes, place="host"):
    """Memory event (ref: platform/profiler.h:44-57 MemEvent)."""
    if _active["on"]:
        _mem_events.append((name, time.perf_counter(), int(nbytes),
                            place))


def export_chrome_trace(path):
    """Write the recorded host spans + memory counters as a Chrome
    tracing JSON (chrome://tracing / Perfetto) — tools/timeline.py:131
    parity, in the JAX package's format. Device-side traces come from
    ``torch.profiler`` (start_profiler(trace_dir=...)); this export covers
    the host runtime
    the way the reference's host profiler layer does.

    Beyond the bare spans: per-tid thread metadata, FLOW arrows linking
    each ``executor.run/dispatch`` slice to the ``executor.run/fetch``
    that materializes it (under async dispatch they are separated in
    time — the arrow shows which fetch paid for which dispatch), and a
    ``steps/s`` counter track derived from consecutive dispatch
    starts.

    Dispatch->fetch pairing is BY SPAN ID: the executor stamps both
    events of one ``run()`` call with the same ``args={"flow": id}``.
    The old per-tid FIFO pairing misattributed whenever a dispatch had
    no fetch — async steps (``return_numpy=False``) emit none, so a
    later blocking step's fetch was paired to the oldest unpaired
    dispatch — and whenever concurrent ``run()`` callers interleaved.
    Events recorded without a flow id (third-party RecordEvents) keep
    the FIFO fallback per tid."""
    spans = sorted(_events.snapshot(), key=lambda e: e[1])
    events = []
    tids = {}
    for name, t0, dur, tid, _args in spans:
        tids.setdefault(tid, len(tids))
        events.append({
            "name": name, "ph": "X", "cat": "host",
            "ts": t0 * 1e6, "dur": dur * 1e6,
            "pid": 0, "tid": tids[tid],
        })
    flow_id = 0
    by_flow = {}                      # executor flow id -> chrome id
    fifo = {}                         # tid -> deque of chrome ids
    prev_dispatch = {}                # tid -> previous dispatch start
    for name, t0, dur, tid, args in spans:
        t = tids[tid]
        if name == "executor.run/dispatch":
            flow_id += 1
            fid = (args or {}).get("flow")
            if fid is not None:
                by_flow[fid] = flow_id
            else:
                fifo.setdefault(t, collections.deque()).append(flow_id)
            events.append({
                "name": "dispatch->fetch", "ph": "s", "cat": "flow",
                "id": flow_id, "ts": (t0 + dur * 0.5) * 1e6,
                "pid": 0, "tid": t,
            })
            last = prev_dispatch.get(t)
            prev_dispatch[t] = t0
            if last is not None and t0 > last:
                events.append({
                    "name": "steps/s", "ph": "C", "ts": t0 * 1e6,
                    "pid": 0, "args": {"steps/s":
                                       round(1.0 / (t0 - last), 3)},
                })
        elif name == "executor.run/fetch":
            fid = (args or {}).get("flow")
            if fid is not None:
                cid = by_flow.pop(fid, None)
            else:
                cid = fifo[t].popleft() if fifo.get(t) else None
            if cid is not None:
                events.append({
                    "name": "dispatch->fetch", "ph": "f", "bp": "e",
                    "cat": "flow", "id": cid,
                    "ts": (t0 + dur * 0.5) * 1e6, "pid": 0, "tid": t,
                })
    for name, ts, nbytes, place in sorted(_mem_events.snapshot(),
                                          key=lambda e: e[1]):
        events.append({
            "name": f"mem:{place}", "ph": "C", "ts": ts * 1e6,
            "pid": 0, "args": {name: nbytes},
        })
    meta = [{"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "paddle_tpu host"}}]
    for tid, t in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                     "tid": t, "args": {"name": f"host thread {tid}"}})
    trace = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def start_profiler(state="All", tracer_option=None, trace_dir=None):
    _active["on"] = True
    if trace_dir and _active["torch_prof"] is None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        _active["trace_dir"] = trace_dir
        _active["torch_prof"] = prof


def stop_profiler(sorted_key="total", profile_path=None):
    _active["on"] = False
    prof = _active["torch_prof"]
    if prof is not None:
        prof.__exit__(None, None, None)
        d = _active["trace_dir"]
        os.makedirs(d, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(d, f"torch_trace.{os.getpid()}.json"))
        _active.update(torch_prof=None, trace_dir=None, last=prof)
    return summary(sorted_key, profile_path)


def reset_profiler():
    _events.clear()
    _mem_events.clear()


def device_kernel_times():
    """[(kernel name, device ms, calls)] of the CUDA kernels and copies the
    last ``torch.profiler`` session (``start_profiler(trace_dir=...)`` to
    ``stop_profiler``) recorded, by device time; [] without one."""
    prof = _active["last"]
    if prof is None:
        return []
    import torch
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def compilation_cache_stats():
    """The build cache's counters ({'hits', 'misses', 'requests'}) from
    ``core/compile_cache.py``: a kernel or native library found under its
    fingerprint is a hit, one built is a miss. A restarted worker with
    hits and no misses built nothing."""
    from paddle_tpu_torch.core import compile_cache
    return compile_cache.stats()


def summary(sorted_key="total", profile_path=None):
    agg = {}
    for name, _, dur, _tid, _args in _events.snapshot():
        tot, cnt = agg.get(name, (0.0, 0))
        agg[name] = (tot + dur, cnt + 1)
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
    lines = [f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>12}"]
    for name, (tot, cnt) in rows:
        lines.append(f"{name:<40}{cnt:>8}{tot * 1e3:>12.3f}"
                     f"{tot / cnt * 1e3:>12.3f}")
    from paddle_tpu_torch.core import compile_cache
    if compile_cache.is_enabled():
        cc = compile_cache.stats()
        lines.append(f"compilation cache: {cc['hits']} hits / "
                     f"{cc['misses']} misses "
                     f"({compile_cache.cache_dir()})")
    from paddle_tpu_torch.monitor.registry import REGISTRY as _REG
    trips = _REG.get("anomaly_trips_total")
    trip_samples = trips.samples() if trips is not None else {}
    n_trips = sum(trip_samples.values())
    if n_trips:
        kinds = ",".join(sorted(k[0] for k, v in trip_samples.items()
                                if v > 0))
        lines.append(
            f"health: {int(n_trips)} anomaly trip(s) [{kinds}] -- "
            f"postmortems under PADDLE_POSTMORTEM_DIR "
            f"(docs/DEBUGGING.md)")
    from paddle_tpu_torch.monitor import cost as _cost
    mfu = _cost.estimate_mfu()
    if mfu is not None:
        from paddle_tpu_torch.monitor.registry import REGISTRY
        h = REGISTRY.get("executor_step_ms")
        ms = h.sum() / h.count() if h is not None and h.count() else 0.0
        lines.append(
            f"MFU estimate: {mfu * 100:.2f}% "
            f"(flops/step={_cost.flops_per_step():.3e}, "
            f"ms/step={ms:.3f}, peak={_cost.peak_flops():.3e} FLOP/s "
            f"-- see monitor/cost.py for the peak's precision)")
    from paddle_tpu_torch.monitor import memory as _memory
    mem_line = _memory.summary_line()
    if mem_line is not None:
        lines.append(
            mem_line + " -- torch.cuda accounting; on the CPU the "
            "limit needs PADDLE_TPU_HBM_LIMIT_BYTES")
    report = "\n".join(lines)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(report)
    return report


@contextlib.contextmanager
def profiler(state="All", sorted_key="total", profile_path=None,
             trace_dir=None):
    start_profiler(state, trace_dir=trace_dir)
    try:
        yield
    finally:
        print(stop_profiler(sorted_key, profile_path))


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """fluid.profiler.cuda_profiler parity shim: the reference drives
    nvprof; here device tracing is torch.profiler (use profiler()/
    start_profiler with a trace_dir instead). Kept as a working span so
    fluid scripts run unchanged: it records a host span and warns ONCE per
    process (a per-epoch shim invocation must not spam the log)."""
    warn_once("cuda_profiler",
              "cuda_profiler drives no nvprof here; use "
              "profiler.profiler(trace_dir=...) for device traces")
    with RecordEvent("cuda_profiler"):
        yield
