"""The port's ``profiler`` (``paddle_tpu_torch.profiler``, bound at the root
as ``pt.profiler``) against the JAX package's: the host spans, the memory
counters and the Chrome trace export in the JAX format (the dispatch ->
fetch flows and the steps/s track over Executor steps), ``summary``, the
bounded per-thread rings, ``cuda_profiler``'s one warning, the refused
compile-cache counters, ``torch.profiler`` under ``trace_dir`` and the
Executor's ``executor/step`` trace with its three spans."""

import json
import os
import time
import warnings

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.monitor import trace as ttrace


def _spans(prof):
    prof.reset_profiler()
    prof.start_profiler()
    with prof.RecordEvent("forward"):
        time.sleep(0.002)
    with prof.RecordEvent("backward"):
        time.sleep(0.001)
    prof.record_memory_event("arena", 1 << 20, place="host")
    report = prof.stop_profiler()
    return report


def test_chrome_trace_and_summary_like_jax(tmp_path):
    traces = []
    for prof, tag in ((tpt.profiler, "t"), (jpt.profiler, "j")):
        report = _spans(prof)
        assert report.splitlines()[0].split() == \
            ["Event", "Calls", "Total(ms)", "Avg(ms)"]
        assert "forward" in report and "backward" in report
        path = prof.export_chrome_trace(str(tmp_path / f"{tag}.json"))
        prof.reset_profiler()
        traces.append(json.load(open(path)))
    for trace in traces:
        evs = trace["traceEvents"]
        fwd = next(e for e in evs if e["name"] == "forward")
        assert fwd["ph"] == "X" and fwd["dur"] >= 1500
        assert "mem:host" in [e["name"] for e in evs]
    shape = [sorted((e["name"], e["ph"], tuple(sorted(e)))
                    for e in t["traceEvents"]) for t in traces]
    assert shape[0] == shape[1]
    assert traces[0]["displayTimeUnit"] == traces[1]["displayTimeUnit"]


def _fit(pt, uniq):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), uniq.guard():
        x = pt.data("x", [4], "float32")
        y = pt.data("y", [1], "float32")
        pred = pt.layers.fc(x, 1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.SGDOptimizer(0.05).minimize(loss)
    return main, startup, loss


def _steps(pt, uniq, exe, scope, n=3):
    main, startup, loss = _fit(pt, uniq)
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(0).rand(8, 4).astype(np.float32)
    for _ in range(n):
        exe.run(main, feed={"x": xv, "y": xv.sum(1, keepdims=True)},
                fetch_list=[loss], scope=scope)


def test_executor_spans_flows_and_rate_track_like_jax(tmp_path):
    from paddle_tpu.framework import unique_name as juniq
    out = []
    for prof, run in (
            (tpt.profiler, lambda: _steps(
                tpt, tpt.unique_name, tpt.Executor(tpt.CPUPlace()),
                tpt.Scope())),
            (jpt.profiler, lambda: _steps(
                jpt, juniq, jpt.static.Executor(), jpt.static.Scope()))):
        prof.reset_profiler()
        prof.start_profiler()
        with static_mode_guard(False):
            run()
        prof.stop_profiler()
        path = prof.export_chrome_trace(str(tmp_path / f"{len(out)}.json"))
        prof.reset_profiler()
        evs = json.load(open(path))["traceEvents"]
        slices = sorted(e["name"] for e in evs if e["ph"] == "X"
                        and e["name"].startswith("executor.run/"))
        starts = {e["id"] for e in evs if e["ph"] == "s"}
        finishes = {e["id"] for e in evs if e["ph"] == "f"}
        rates = [e for e in evs if e["ph"] == "C" and e["name"] == "steps/s"]
        assert finishes <= starts and all(e["args"]["steps/s"] > 0
                                          for e in rates)
        out.append((slices, len(starts), len(finishes), len(rates)))
    assert out[0] == out[1]
    assert out[0][1:] == (3, 3, 2)


def test_event_ring_is_bounded_per_thread():
    from paddle_tpu_torch.profiler import _events
    tpt.profiler.reset_profiler()
    prev = tpt.profiler.set_max_events(100)
    try:
        tpt.profiler.start_profiler()
        for _ in range(500):
            with tpt.profiler.RecordEvent("spin"):
                pass
        tpt.profiler.stop_profiler()
        assert len(_events) == 100
    finally:
        assert tpt.profiler.set_max_events(prev) == 100
        tpt.profiler.reset_profiler()


def test_cuda_profiler_warns_once_and_the_cache_counters_refuse():
    from paddle_tpu_torch.core import enforce
    enforce._warned_keys.discard("cuda_profiler")
    with pytest.warns(UserWarning, match="cuda_profiler"):
        with tpt.profiler.cuda_profiler():
            pass
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with tpt.profiler.cuda_profiler():
            pass
    with pytest.raises(EnforceNotMet, match="item 10, step 3"):
        tpt.profiler.compilation_cache_stats()
    assert "compilation cache" not in tpt.profiler.summary()


def test_trace_dir_runs_torch_profiler(tmp_path):
    d = str(tmp_path / "tr")
    with tpt.profiler.profiler(trace_dir=d):
        _steps(tpt, tpt.unique_name, tpt.Executor(tpt.CPUPlace()),
               tpt.Scope(), n=1)
    (name,) = os.listdir(d)
    assert name == f"torch_trace.{os.getpid()}.json"
    doc = json.load(open(os.path.join(d, name)))
    assert any("addmm" in e.get("name", "") or "mm" in e.get("name", "")
               for e in doc["traceEvents"])
    # the CPU records no device kernel
    assert tpt.profiler.device_kernel_times() == []


def test_executor_step_trace_has_its_three_spans(tmp_path):
    ttrace.enable(str(tmp_path), sample_rate=1.0)
    try:
        _steps(tpt, tpt.unique_name, tpt.Executor(tpt.CPUPlace()),
               tpt.Scope(), n=2)
        names = [s["name"] for s in ttrace.spans()]
    finally:
        ttrace.disable()
    for n in ("executor/step", "executor/prepare", "executor/dispatch",
              "executor/fetch"):
        assert names.count(n) == 2, n
