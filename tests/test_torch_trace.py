"""The tracer of the port (``paddle_tpu_torch/monitor/trace.py``) against the
JAX package's, on the CPU: the tail-sampling decisions (errors, exemplars,
the slowest-N reservoir, every N-th) over the same seeded sequence of
traces, the per-rank trace files (the same meta line and span keys), the
merge of a file written by each package into one Chrome-trace document, the
stage-note mailbox, ``install_from_env`` and a writer that never raises into
serving.
"""

import json
import os
import time

import numpy as np
import pytest

from paddle_tpu.monitor import trace as jtrace

from paddle_tpu_torch.monitor import trace as ttrace


@pytest.fixture(autouse=True)
def _restore():
    """Each package's module-level tracer and switch, as they were."""
    saved = [(m, m.TRACER, m._enabled, m.TRACER._writer)
             for m in (jtrace, ttrace)]
    yield
    for m, tracer, enabled, writer in saved:
        m.disable()
        tracer._writer = writer
        m.TRACER = tracer
        m._enabled = enabled


def _decisions(mod, seed):
    """Keep reasons of 300 traces with seeded durations, error flags,
    exemplar observations and head-gate screens, on a fresh tracer."""
    rng = np.random.RandomState(seed)
    tr = mod.Tracer(capacity=64, sample_rate=0.1, slow_keep=4,
                    slow_window_s=600.0, exemplar_factor=1.5)
    out = []
    for i in range(300):
        dur = float(rng.lognormal(-4.0, 0.6))
        if rng.rand() < 0.3:
            hint = tr.tail_candidate("serving_request_latency_ms",
                                     dur * 1e3, dur, count=2)
            out.append(("screen", hint))
            if hint is None:
                continue
        ctx = tr.start_trace("serving/request", attrs={"i": i})
        ctx.t0 = time.perf_counter() - dur
        if rng.rand() < 0.2:
            out.append(("exemplar", tr.record_exemplar(
                "serving_request_latency_ms", dur * 1e3, ctx)))
        tr.record_span(ctx, "serving/execute", ctx.t0, ctx.t0 + dur / 2,
                       status="error" if rng.rand() < 0.03 else "ok")
        out.append(("end", tr.end_trace(ctx)))
    return out, len(tr.spans())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tail_sampling_decides_like_jax(seed):
    want = _decisions(jtrace, seed)
    assert _decisions(ttrace, seed) == want
    reasons = {r for k, r in want[0] if k == "end"}
    assert {"error", "exemplar", "slow", "sampled", None} <= reasons


def _write_one(mod, d, tenant):
    mod.enable(str(d), sample_rate=1.0)
    ctx = mod.start_trace("serving/request", attrs={"tenant": tenant})
    t = ctx.t0
    mod.record_span(ctx, "serving/queue_wait", t, t + 0.001)
    sid = mod.record_span(ctx, "serving/execute", t + 0.001, t + 0.003,
                          tid=12345, attrs={"bucket": 2})
    mod.record_span(ctx, "serving/deliver", t + 0.003, t + 0.004,
                    parent=sid)
    reason = mod.end_trace(ctx)
    mod.disable()
    with open(os.path.join(d, "rank0.trace.jsonl")) as f:
        return reason, [json.loads(ln) for ln in f]


def test_trace_files_and_merge_like_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    jr, jlines = _write_one(jtrace, tmp_path / "j", "a")
    tr, tlines = _write_one(ttrace, tmp_path / "t", "b")
    assert jr == tr == "slow"          # a fresh reservoir keeps it
    assert [sorted(d) for d in tlines] == [sorted(d) for d in jlines]
    meta = tlines[0]
    assert meta["t"] == "meta" and meta["rank"] == 0 and \
        meta["pid"] == os.getpid() and meta["version"] == 1
    assert [d["name"] for d in tlines[1:]] == [d["name"] for d in jlines[1:]]
    root = tlines[-1]
    assert root["kind"] == "root" and root["attrs"] == {"tenant": "b"}
    # one file of each package, as ranks 0 and 1 of one job
    m = tmp_path / "merged"
    m.mkdir()
    os.replace(tmp_path / "t" / "rank0.trace.jsonl",
               m / "rank0.trace.jsonl")
    os.replace(tmp_path / "j" / "rank0.trace.jsonl",
               m / "rank1.trace.jsonl")
    tout = ttrace.merge_rank_traces(str(m), str(tmp_path / "t.json"))
    jout = jtrace.merge_rank_traces(str(m), str(tmp_path / "j.json"))
    with open(tout) as f:
        tdoc = json.load(f)
    with open(jout) as f:
        assert json.load(f) == tdoc
    spans = [e for e in tdoc["traceEvents"] if e["ph"] == "X"]
    assert sorted({e["pid"] for e in spans}) == [0, 1]
    assert {e["args"].get("tenant") for e in spans
            if e["cat"] == "root"} == {"a", "b"}
    # the execute span ran on another thread than its root, and deliver on
    # another than execute: two flow arrows per rank
    assert sum(e["ph"] == "s" for e in tdoc["traceEvents"]) == 4
    assert ttrace.merge_rank_traces(str(tmp_path / "nowhere")) is None
    assert ttrace.main([str(m), "-o", str(tmp_path / "cli.json")]) == 0


def test_writer_never_raises_into_serving(tmp_path):
    w = ttrace._TraceWriter(str(tmp_path), 3, flush_every=2)
    assert w.path.endswith("rank3.trace.jsonl")
    os.makedirs(w.path)           # the file's path is a directory now
    w.add([{"t": "span", "name": "x"}, {"t": "span", "name": "y"}])
    w.flush()
    assert os.path.isdir(w.path)


def test_stage_notes_inflight_and_env_like_jax(tmp_path):
    got = {}
    for mod in (jtrace, ttrace):
        tr = mod.Tracer(sample_rate=1.0)
        tr.stage_note("feed_stage", 1.0, 2.0, key=[7, 8])
        tr.stage_note("feed_stage", 2.0, 3.0, key=[9])
        ctx = tr.start_trace("executor/step", current=True)
        a = tr.adopt_stage(ctx, match={9})
        b = tr.adopt_stage(ctx, match={5})
        c = tr.adopt_stage(ctx)
        rep = tr.inflight_report()
        tr.end_trace(ctx)
        env = {"PADDLE_TRACE_DIR": str(tmp_path / mod.__name__),
               "PADDLE_TRACE_SAMPLE": "0.5", "PADDLE_TRACE_SLOW_KEEP": "x"}
        armed = mod.install_from_env(env)
        got[mod is ttrace] = (
            a, b, c, rep["root"], [s["name"] for s in rep["spans"]],
            [s["attrs"]["stage_seq"] for s in rep["spans"]],
            tr.inflight_report(), mod.install_from_env({}),
            armed.sample_rate, armed.slow_keep,
            os.path.basename(armed._writer.path), mod.is_enabled())
        mod.disable()
    assert got[True] == got[False]
    assert got[True][:3] == (2, None, 3)
