"""The port's observability modules against the JAX package's: the registry's
``collect``/``clear``, the flight recorder, the anomaly detector, the goodput
ledger, the exporter, the heartbeat files (``distributed/health.py``), the
cost monitor and the static Executor's step metrics.

Each case feeds the same inputs to both packages and holds the results
equal: the same dumps, trips, ledgers, snapshot texts and status lines.
One package's exposition text parses in the other's ``parse_text``, and
``tools/goodput_report.py`` (the JAX package's) reads a ledger the port
wrote. Every metric the port registers has the JAX package's name, kind and
labels and a row in docs/OBSERVABILITY.md. Metrics are process-global and
cumulative, so the cases hold deltas."""

import json
import os
import signal
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.distributed import health as jhealth
from paddle_tpu.monitor import anomaly as janomaly
from paddle_tpu.monitor import cost as jcost
from paddle_tpu.monitor import exporter as jexporter
from paddle_tpu.monitor import flight_recorder as jflight
from paddle_tpu.monitor import goodput as jgoodput
from paddle_tpu.monitor.registry import REGISTRY as JREG
from paddle_tpu.monitor.registry import Registry as JRegistry
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.distributed import health as thealth
from paddle_tpu_torch.monitor import anomaly as tanomaly
from paddle_tpu_torch.monitor import cost as tcost
from paddle_tpu_torch.monitor import exporter as texporter
from paddle_tpu_torch.monitor import flight_recorder as tflight
from paddle_tpu_torch.monitor import goodput as tgoodput
from paddle_tpu_torch.monitor.registry import REGISTRY as TREG
from paddle_tpu_torch.monitor.registry import Registry as TRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import check_metrics  # noqa: E402
import goodput_report  # noqa: E402


def _uniq(pt):
    """The package's unique_name module (the JAX package binds it under
    ``framework``)."""
    import importlib
    return importlib.import_module(pt.__name__ + ".framework").unique_name


def _filled(Registry):
    r = Registry()
    r.counter("t_steps_total", "steps").inc(7)
    r.gauge("t_flops", "flops", labels=("segment",)).set(1.5e9, segment="0")
    r.counter("t_esc_total", labels=("p",)).inc(p='we"ird\\path\nx')
    h = r.histogram("t_lat_ms", "lat", buckets=(1.0, 10.0))
    h.observe(0.5)
    h.observe(5.0)
    r.gauge("t_nan").set(float("nan"))
    return r


# ---------------------------------------------------------------------------
# the registry and the metric names
def test_registry_collect_and_clear_like_jax():
    out = []
    for Registry in (TRegistry, JRegistry):
        r = Registry()
        r.gauge("b_g")
        r.counter("a_total")
        r.histogram("c_ms")
        names = [m.name for m in r.collect()]
        kinds = [m.kind for m in r.collect()]
        r.clear()
        out.append((names, kinds, r.collect(), r.get("a_total")))
    assert out[0] == out[1] == (["a_total", "b_g", "c_ms"],
                                ["counter", "gauge", "histogram"], [], None)


def test_every_port_metric_has_the_jax_name_kind_labels_and_a_row():
    import paddle_tpu.monitor  # noqa: F401
    import paddle_tpu.profiler  # noqa: F401
    import paddle_tpu.serving  # noqa: F401
    import paddle_tpu.static.executor  # noqa: F401
    import paddle_tpu_torch.serving  # noqa: F401
    rows = check_metrics.doc_rows()
    ported = TREG.collect()
    assert {"executor_steps_total", "executor_step_ms", "segment_flops",
            "nonfinite_trips_total", "goodput_seconds_total",
            "anomaly_trips_total", "grad_global_norm", "loss_scale",
            "program_pass_runs_total", "segment_peak_bytes_estimate"} <= \
        {m.name for m in ported}
    wrong = []
    for m in ported:
        j = JREG.get(m.name)
        if j is None or (j.kind, j.labelnames) != (m.kind, m.labelnames) \
                or m.name not in rows:
            wrong.append((m.name, m.kind, m.labelnames,
                          j and (j.kind, j.labelnames), m.name in rows))
        elif m.kind == "histogram":
            assert m.buckets == j.buckets, m.name
    assert not wrong


# ---------------------------------------------------------------------------
# the flight recorder
def test_flight_recorder_ring_spans_and_dump_like_jax(tmp_path):
    docs = []
    for fl, tag in ((tflight, "t"), (jflight, "j")):
        fr = fl.FlightRecorder(capacity=4)
        for i in range(10):
            fr.note("step", "s", i=i)
        evs = fr.events()
        assert [e["data"]["i"] for e in evs] == [6, 7, 8, 9]
        fr.span_push("train/step")
        fr.span_push("executor.run/dispatch")
        path = fr.dump(path=str(tmp_path / f"{tag}.json"), reason="test")
        doc = json.load(open(path))
        assert [s["name"] for s in doc["in_flight_spans"]] == \
            ["train/step", "executor.run/dispatch"]
        fr.span_pop("executor.run/dispatch", 0.01)
        fr.span_pop("train/step", 0.02)
        assert fr.in_flight() == [] and fr.events()[-1]["name"] == \
            "train/step"
        assert fl.FlightRecorder().dump(reason="x") is None
        docs.append(doc)
    assert set(docs[0]) == set(docs[1])
    assert [(e["kind"], e["name"]) for e in docs[0]["events"]] == \
        [(e["kind"], e["name"]) for e in docs[1]["events"]]


def test_record_event_feeds_the_recorder_when_enabled():
    before = len(tflight.RECORDER.events())
    try:
        tflight.enable()
        with tprofiler.RecordEvent("t_span"):
            assert any(s["name"] == "t_span"
                       for s in tflight.RECORDER.in_flight())
    finally:
        tflight.disable()
    assert any(e["name"] == "t_span" and e["kind"] == "span"
               for e in tflight.RECORDER.events()[before:])


def test_sigterm_and_excepthook_dumps_chain_the_previous(tmp_path):
    fr = tflight.FlightRecorder()
    called, seen = [], []
    prev = signal.signal(signal.SIGTERM, lambda s, f: called.append(s))
    orig = sys.excepthook
    sys.excepthook = lambda *a: seen.append(a)
    undo = fr.install(str(tmp_path))
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not called and time.time() < deadline:
            time.sleep(0.01)
        assert called == [signal.SIGTERM]
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        assert len(seen) == 1
        names = sorted(os.listdir(tmp_path))
        assert len(names) == 2 and "sigterm" in names[1] \
            and "exception" in names[0]
        assert "boom" in json.load(open(tmp_path / names[0]))["exception"]
    finally:
        undo()
        sys.excepthook = orig
        signal.signal(signal.SIGTERM, prev)


def test_install_from_env(tmp_path, monkeypatch):
    assert tflight.install_from_env(env={}) is None
    monkeypatch.setattr(tflight.RECORDER, "install", lambda d: d)
    try:
        got = tflight.install_from_env(env={tflight.ENV_DIR: str(tmp_path)})
        assert got is tflight.RECORDER and tflight.is_enabled()
    finally:
        tflight.disable()


# ---------------------------------------------------------------------------
# the anomaly detector and the health readout
def _observe_all(mod, seq, **kw):
    det = mod.AnomalyDetector(**kw)
    return [det.observe(step=i, **o) for i, o in enumerate(seq)]


def test_anomaly_detector_trips_like_jax(tmp_path, monkeypatch):
    for mod, fl in ((tanomaly, tflight), (janomaly, jflight)):
        monkeypatch.setattr(fl.RECORDER, "_dir", str(tmp_path / mod.__name__))
        monkeypatch.setattr(mod, "_dumped_kinds", set())
    rng = np.random.RandomState(0)
    seq = ([{"loss": 2.0 + 0.01 * rng.rand(), "step_ms": 10.0}
            for _ in range(12)]
           + [{"loss": 50.0}, {"loss": 60.0}, {"loss": 2.0}]
           + [{"step_ms": 500.0}] * 4 + [{"grad_norm": float("nan")}]
           + [{"loss": float("inf")}] + [{"loss": 2.0, "grad_norm": 1.0}] * 9
           + [{"grad_norm": 1e6}])
    kw = dict(min_samples=8, cooldown=3)
    got = _observe_all(tanomaly, seq, **kw)
    assert got == _observe_all(janomaly, seq, **kw)
    assert ["loss_spike"] in got and ["step_stall"] in got \
        and ["non_finite"] in got and ["grad_explosion"] in got
    dumps = sorted(os.listdir(tmp_path / tanomaly.__name__))
    assert len(dumps) == 4 and all("anomaly-" in d for d in dumps)
    doc = json.load(open(tmp_path / tanomaly.__name__ / dumps[0]))
    assert doc["anomaly"]["kind"] in tanomaly.KINDS


def test_enable_resets_health_and_straggler_readout(tmp_path):
    tanomaly.enable(window=4)
    try:
        assert TREG.get("train_health").value() == 1.0
        assert tanomaly.DETECTOR._window_len == 4 and tanomaly.is_enabled()
    finally:
        tanomaly.disable()
    for rank, ms in enumerate((4.0, 4.2, 4.1, 12.0)):
        r = TRegistry()
        h = r.histogram("executor_step_ms")
        for _ in range(5):
            h.observe(ms)
        r.counter("executor_steps_total").inc(5)
        if rank == 2:
            r.counter("anomaly_trips_total", labels=("kind",)).inc(
                kind="loss_spike")
        texporter.write_snapshot(thealth.metrics_path(str(tmp_path), rank),
                                 r)
    tsnaps = texporter.read_rank_snapshots(str(tmp_path))
    jsnaps = jexporter.read_rank_snapshots(str(tmp_path))
    assert tsnaps == jsnaps
    assert tanomaly.straggler_ranks(tsnaps) == \
        janomaly.straggler_ranks(jsnaps) == [3]
    assert tanomaly.job_health(tsnaps) == janomaly.job_health(jsnaps) == \
        ("anomaly:loss_spike;straggler:r3", [3])


# ---------------------------------------------------------------------------
# the goodput ledger
@pytest.fixture
def ledgers():
    """Both ledgers disarmed and watermark-free for the body, restored
    after."""
    keys = ("_armed", "_origin", "_mark", "_accounted", "_replay_until",
            "_step")
    saved = [(m, {k: getattr(m, k) for k in keys})
             for m in (tgoodput, jgoodput)]
    for m, _ in saved:
        m._armed, m._origin, m._mark = False, None, None
        m._accounted, m._replay_until, m._step = 0.0, -1, None
    yield
    for m, vals in saved:
        for k, v in vals.items():
            setattr(m, k, v)


def _phases(m):
    return {p: m._c_phase.value(phase=p) for p in m.PHASES}


def test_goodput_ledger_units_like_jax(ledgers):
    deltas = []
    for m in (tgoodput, jgoodput):
        p0 = _phases(m)
        m.attribute(1.0, "input_wait")            # disarmed: nothing
        m.enable()
        m._mark = 100.0
        m.attribute(0.25, "input_wait")
        m.on_run_start(101.0)                      # 1 s gap - 0.25 accounted
        m._replay_until = 3
        m.on_step(2)
        t = time.perf_counter()
        m.on_run_end(t - 1.0, t - 0.9, t - 0.8, t - 0.5, True)
        m.on_step(4)
        m.on_run_end(t - 1.0, t - 0.9, t - 0.8, t - 0.5, False)
        m.disable()
        p1 = _phases(m)
        deltas.append({p: round(p1[p] - p0[p], 2) for p in m.PHASES
                       if p1[p] != p0[p]})
    assert deltas[0] == deltas[1]
    assert set(deltas[0]) == {"input_wait", "device_idle", "compile",
                              "replay", "device_compute"}


def test_port_ledger_reads_in_the_jax_report(tmp_path):
    d = tmp_path / "logs"
    gp = str(d / "goodput")
    rec = {"incarnation": 0, "world": 1, "status": "ok", "rc": 0,
           "rc_label": None, "start": 100.0, "end": 130.0, "last_step": 5,
           "restored_step": None,
           "ranks": {"0": {"wall_seconds": 29.0,
                           "phases": {"device_compute": 20.0,
                                      "startup": 5.0, "device_idle": 4.0}}}}
    tgoodput.record_incarnation(gp, rec)
    with open(os.path.join(gp, tgoodput.INCARNATIONS_FILE), "a") as f:
        f.write('{"torn": ')                      # a torn tail is skipped
    assert tgoodput.read_incarnations(gp) == \
        jgoodput.read_incarnations(gp) == [rec]
    text, data = goodput_report.build_report(str(d))
    assert data["goodput_fraction"] == pytest.approx(20.0 / 29.0)
    assert "rank 0: attributed" in text
    # the live fallback: a port rank snapshot of the ledger's counters
    d2 = tmp_path / "live"
    r = TRegistry()
    c = r.counter("goodput_seconds_total", labels=("phase",))
    c.inc(9.0, phase="device_compute")
    c.inc(1.0, phase="startup")
    r.gauge("goodput_wall_seconds").set(10.0)
    texporter.write_snapshot(
        thealth.metrics_path(str(d2 / "heartbeat"), 0), r)
    _, data = goodput_report.build_report(str(d2))
    assert data["incarnations"][0]["status"] == "live"
    assert data["goodput_fraction"] == pytest.approx(0.9)
    assert tgoodput.fraction_of(texporter.parse_text(
        texporter.render_text(r))[1]) == pytest.approx(0.9)


def test_executor_attributes_compile_then_compute(ledgers):
    main, startup, loss, feed = _fit_program(tpt)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    tgoodput.enable()
    try:
        p0 = _phases(tgoodput)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        p1 = _phases(tgoodput)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        p2 = _phases(tgoodput)
    finally:
        tgoodput.disable()
    assert p1["compile"] > p0["compile"]
    assert p2["compile"] == p1["compile"]
    assert p2["device_compute"] > p1["device_compute"]


# ---------------------------------------------------------------------------
# the exporter and the heartbeat files
def test_exposition_text_parses_across_the_packages():
    ttext = texporter.render_text(_filled(TRegistry))
    jtext = jexporter.render_text(_filled(JRegistry))
    assert ttext == jtext
    for parse in (texporter.parse_text, jexporter.parse_text):
        for text in (ttext, jtext):
            types, samples = parse(text)
            assert types["t_lat_ms"] == "histogram"
            assert samples[("t_lat_ms_bucket", (("le", "10"),))] == 2.0
            assert samples[("t_esc_total", (("p", 'we"ird\\path\nx'),))] \
                == 1.0
            with pytest.raises(ValueError):
                parse(text[:len(text) // 2])
    assert texporter.aggregate([texporter.parse_text(ttext)] * 2)[1][
        ("t_steps_total", ())] == 14.0


def test_rank_snapshots_job_view_and_status_line_like_jax(tmp_path):
    for rank, steps in ((0, 10), (1, 12)):
        r = TRegistry()
        r.counter("executor_steps_total").inc(steps)
        h = r.histogram("executor_step_ms")
        for _ in range(steps):
            h.observe(4.0)
        r.gauge("segment_flops", labels=("segment",)).set(2e6, segment="0")
        texporter.write_snapshot(thealth.metrics_path(str(tmp_path), rank),
                                 r)
    tline = texporter.job_status_line(str(tmp_path), restarts=3)
    jline = jexporter.job_status_line(str(tmp_path), restarts=3)
    # mfu is over each package's peak: the H100's bf16 here, a v5e's there
    strip = lambda s: [p for p in s.split() if not p.startswith("mfu=")]
    assert strip(tline) == strip(jline)
    assert "step=12" in tline and "ms/step=4.0" in tline and "mfu=" in tline
    out = texporter.write_job_snapshot(str(tmp_path),
                                       str(tmp_path / "metrics.prom"))
    _, samples = jexporter.parse_text((tmp_path / "metrics.prom").read_text())
    assert samples[("executor_steps_total", ())] == 22.0
    assert out == str(tmp_path / "metrics.prom")
    assert texporter.job_status_line(str(tmp_path / "nope")) is None


def test_metrics_server_and_rank_exporter(tmp_path):
    r = _filled(TRegistry)
    srv = texporter.MetricsServer(port=0, registry=r).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                    timeout=10) as resp:
            assert "text/plain" in resp.headers["Content-Type"]
            body = resp.read().decode()
        assert jexporter.parse_text(body)[1][("t_steps_total", ())] == 7.0
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/x",
                                   timeout=10)
    finally:
        srv.stop()
    env = {thealth.ENV_DIR: str(tmp_path), thealth.ENV_RANK: "2",
           "PADDLE_RESTART_COUNT": "1"}
    assert texporter.RankExporter.from_env(env={}) is None
    exp = texporter.RankExporter.from_env(env=env, interval=0.05,
                                          registry=TRegistry())
    with exp:
        time.sleep(0.15)
    snaps = jexporter.read_rank_snapshots(str(tmp_path))
    assert snaps[2][1][("restarts_total", ())] == 1.0


def test_heartbeat_files_like_jax(tmp_path):
    for rank in (0, 1):
        thealth.Heartbeat(str(tmp_path), rank, interval=0.0).beat()
    old = time.time() - 60
    os.utime(thealth.heartbeat_path(str(tmp_path), 1), (old, old))
    for h in (thealth, jhealth):
        assert [r for r, _ in h.stale_ranks(str(tmp_path), 3, 5.0)] == [1]
        assert h.silent_ranks(str(tmp_path), 3) == [2]
        assert h.metrics_path(str(tmp_path), 3).endswith("rank3.prom")
    open(thealth.metrics_path(str(tmp_path), 5), "w").close()
    assert thealth.sweep_stale_ranks(str(tmp_path), 2) == ["rank5.prom"]
    assert thealth.Heartbeat.from_env(env={}) is None


# ---------------------------------------------------------------------------
# the cost monitor
def test_record_mfu_math_and_superseded_series():
    tcost.reset()
    try:
        assert tcost.estimate_mfu(ms_per_step=10.0) is None
        tcost.record_segment("g1", 0, {"flops": 1e9, "bytes": 1e6})
        tcost.record_segment("g1", 1, {"flops": 1e9, "bytes": 1e6})
        assert tcost.flops_per_step() == 2e9 and tcost.bytes_per_step() \
            == 2e6
        tcost.record_segment("g2", 0, {"flops": 5e8, "bytes": 1e6})
        assert tcost.flops_per_step() == 5e8
        assert TREG.get("segment_flops").samples() == {("0",): 5e8}
        assert tcost.estimate_mfu(ms_per_step=10.0) == pytest.approx(
            5e8 / 0.01 / tcost.peak_flops())
    finally:
        tcost.reset()
    hlo = ("%a = f32[4,8]{1,0} all-reduce(%x)\n"
           "%s = (f32[8]{0}, f32[8]{0}) all-gather-start(%y)\n"
           "%d = f32[16]{0} all-gather-done(%s)\n")
    assert tcost.estimate_comm(hlo) == jcost.estimate_comm(hlo) == {
        "comm_bytes": 192.0, "collectives": {"all-reduce": 1,
                                             "all-gather": 1}}


def test_peak_flops_is_the_cards(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    assert tcost.peak_flops() == 989e12
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "67e12")
    assert tcost.peak_flops() == 67e12
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "junk")
    assert tcost.peak_flops() == tcost.DEFAULT_PEAK_FLOPS


def _fc_only(pt, M, K, N):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), _uniq(pt).guard():
        x = pt.data("x", [M, K], "float32", append_batch_size=False)
        out = pt.layers.fc(x, N, bias_attr=False)
    return main, startup, out


def test_fc_flops_are_2mnk_and_near_the_jax_count():
    """The port's abstract pass counts matrix products only: an fc without
    bias is exactly 2*M*N*K. XLA's cost model also counts elementwise work
    and the weight's read, so the JAX count lies within 1 % above it at
    this size."""
    M, K, N = 64, 96, 48
    xv = np.random.RandomState(0).rand(M, K).astype(np.float32)
    main, startup, out = _fc_only(tpt, M, K, N)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    launches = dict(tpt.ops.kernels.launch_counts())
    tcost.reset()
    exe.run(main, feed={"x": xv}, fetch_list=[out], scope=scope)
    assert tcost.flops_per_step() == 2 * M * N * K
    assert tcost.bytes_per_step() >= 4 * (M * K + K * N + M * N)
    assert tpt.ops.kernels.launch_counts() == launches
    with static_mode_guard(False):
        jmain, jstartup, jout = _fc_only(jpt, M, K, N)
        jexe = jpt.static.Executor()
        jscope = jpt.static.Scope()
        jexe.run(jstartup, scope=jscope)
        jcost.reset()
        jexe.run(jmain, feed={"x": xv}, fetch_list=[jout], scope=jscope)
    jf = jcost.flops_per_step()
    assert 2 * M * N * K <= jf <= 1.01 * 2 * M * N * K
    jcost.reset()
    tcost.reset()


def test_cost_pass_waits_for_its_first_reader(monkeypatch):
    """A runner's first step only queues the abstract pass: it runs when
    ``flops_per_step`` is first read, once, and sets the gauges then. A new
    runner (another feed shape) supersedes the queued pass of the first,
    which never runs."""
    M, K, N = 16, 24, 8
    main, startup, out = _fc_only(tpt, M, K, N)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    calls = []
    real = tcost._analyze_meta

    def counted(ops, meta, interpret):
        calls.append(len(ops))
        return real(ops, meta, interpret)

    monkeypatch.setattr(tcost, "_analyze_meta", counted)
    tcost.reset()
    try:
        x = np.ones((M, K), np.float32)
        exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
        exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
        assert calls == [] and TREG.get("segment_flops").samples() == {}
        assert tcost.flops_per_step() == 2 * M * N * K
        assert tcost.bytes_per_step() > 0 and len(calls) == 1
        assert TREG.get("segment_flops").samples() == {
            ("0",): 2.0 * M * N * K}
        # another runner: its pass supersedes the unread one of a third
        exe.run(main, feed={"x": x[:8]}, fetch_list=[out], scope=scope)
        exe.run(main, feed={"x": x[:4]}, fetch_list=[out], scope=scope)
        assert len(calls) == 1
        assert tcost.segments() == {0: {"flops": 2.0 * 4 * N * K,
                                        "bytes": tcost.bytes_per_step(),
                                        "comm_bytes": 0.0,
                                        "collectives": {}}}
        assert len(calls) == 2 and not tcost._pending
    finally:
        tcost.reset()


def test_cost_pass_leaves_the_state_and_flag_off_does_not_latch():
    main, startup, loss, feed = _fit_program(tpt)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    ref = tpt.Scope()
    for n in scope.names():
        v = scope.find_var(n)
        ref.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    tcost.reset()
    tpt.set_flags({"monitor_cost": False})
    try:
        (a,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert tcost.flops_per_step() == 0
    finally:
        tpt.set_flags({"monitor_cost": True})
    (b,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert tcost.flops_per_step() > 0
    # the same two steps without the probe: bitwise the same
    e2 = tpt.Executor(tpt.CPUPlace())
    tpt.set_flags({"monitor_cost": False})
    try:
        (a2,) = e2.run(main, feed=feed, fetch_list=[loss], scope=ref)
        (b2,) = e2.run(main, feed=feed, fetch_list=[loss], scope=ref)
    finally:
        tpt.set_flags({"monitor_cost": True})
    assert (a, b) == (a2, b2)
    tcost.reset()


def test_pass_cost_evidence_publishes_per_pass_deltas():
    main, startup, loss, feed = _fit_program(tpt)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    tpt.set_flags({"pass_cost_evidence": True})
    try:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    finally:
        tpt.set_flags({"pass_cost_evidence": False})
    ev = tcost.pass_evidence()
    assert ev and all("flops_delta" in v for v in ev.values())
    assert TREG.get("program_pass_flops_delta").samples()


# ---------------------------------------------------------------------------
# the Executor's step metrics
def _fit_program(pt):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), _uniq(pt).guard():
        x = pt.data("x", [4], "float32")
        y = pt.data("y", [1], "float32")
        pred = pt.layers.fc(x, 1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.SGDOptimizer(0.05).minimize(loss)
    xv = np.random.RandomState(0).rand(8, 4).astype(np.float32)
    return main, startup, loss, {"x": xv, "y": xv.sum(1, keepdims=True)}


def test_run_moves_the_step_metrics_like_jax():
    def deltas(reg, run):
        names = ("executor_steps_total", "executor_step_ms",
                 "executor_fetch_ms", "executor_retraces_total")
        get = lambda: [reg.get(n).value() if reg.get(n).kind == "counter"
                       else reg.get(n).count() for n in names]
        b = get()
        run()
        return [a - c for a, c in zip(get(), b)]

    def port():
        main, startup, loss, feed = _fit_program(tpt)
        exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
        exe.run(startup, scope=scope)
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                return_numpy=False)

    def jax_side():
        with static_mode_guard(False):
            main, startup, loss, feed = _fit_program(jpt)
            exe, scope = jpt.static.Executor(), jpt.static.Scope()
            exe.run(startup, scope=scope)
            for _ in range(3):
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)

    assert deltas(TREG, port) == deltas(JREG, jax_side) == [4, 4, 3, 1]
    assert tprofiler.summary().count("MFU estimate") == 1
