"""The hot model swap of the port (``paddle_tpu_torch/serving/swap.py``)
against the JAX package's, on the CPU, at ``max_batch`` 2.

Both packages serve the same model directories, written by the JAX package
(``save_inference_model`` + ``export_aot``, which stamps the manifest's
``model_version``):

- the serving MLP of ``tests/test_torch_serving.py`` (x[256] -> fc 256 relu
  -> fc 256 relu -> fc 10): v1 fp32 at its startup weights, v2 int8 at 0.9
  of them, a v2 copy with one byte of its int8 sidecar flipped, a feed-spec
  change (x[128]) and v1 with one weight NaN;
- ``mobilenet_v1_tiny`` (``models/mobilenet_v1.py``, its programs built by
  each package's layers): v1 fp32 at its startup weights, v2 int8 after two
  Momentum steps, and v1 with its first conv weight NaN.

The same swap sequence runs through each package's ``InferenceServer``: ok,
gate_failed (the spec change and the flipped byte), refused_memory (a limit
one byte over the live projection, under the projection plus the standby's
params), canary_failed (the NaN weight), rolled_back (a
``_build_standby_pool`` that wedges past ``standby_timeout_ms``; a patched
``_cutover`` that poisons the new pool so the watchdog trips) and a
concurrent swap refused. The outcome counters, the ``SwapFailedError``
stages and ``retryable`` flags and the report's keys must be equal; the
served outputs after each step within 1e-5 of the JAX package's, relative to
their largest magnitude (fp32 sums in another order; the int8 weight is the
same integers and scales in both). Each package's seams are patched on its
own controller OBJECT (pytest's ``monkeypatch``), never on a class.
"""

import json
import os
import shutil
import threading
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import inference as jinf
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.monitor.registry import REGISTRY as JREGISTRY
from paddle_tpu.serving import InferenceServer as JServer
from paddle_tpu.serving import ServingConfig as JConfig
from paddle_tpu.serving import SwapFailedError as JSwapFailed
from paddle_tpu.serving import SwapWatchdog as JWatchdog
from paddle_tpu.serving import TenantFairShare as JFair
from paddle_tpu.static.program import static_mode_guard

from paddle_tpu_torch.models import mobilenet_v1 as mb
from paddle_tpu_torch.monitor.registry import REGISTRY as TREGISTRY
from paddle_tpu_torch.serving import InferenceServer as TServer
from paddle_tpu_torch.serving import ServingConfig as TConfig
from paddle_tpu_torch.serving import SwapFailedError as TSwapFailed
from paddle_tpu_torch.serving import SwapWatchdog as TWatchdog
from paddle_tpu_torch.serving import TenantFairShare as TFair

TOL = 1e-5
CPU = torch.device("cpu")
OUTCOMES = ("ok", "gate_failed", "refused_memory", "canary_failed",
            "rolled_back")

JAX = types.SimpleNamespace(name="jax", Server=JServer, Config=JConfig,
                            Failed=JSwapFailed, reg=JREGISTRY, dev={})
PORT = types.SimpleNamespace(name="port", Server=TServer, Config=TConfig,
                             Failed=TSwapFailed, reg=TREGISTRY,
                             dev={"devices": [CPU]})


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave its static mode on for later files
    on their worker; the port's CPU ops take two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        with static_mode_guard(False):
            yield
    finally:
        torch.set_num_threads(threads)


def _count(P, outcome):
    m = P.reg.get("serving_swaps_total")
    return m.value(outcome=outcome) if m is not None else 0.0


def _snap(P):
    return {o: _count(P, o) for o in OUTCOMES}


# ---------------------------------------------------------------------------
# the exports (the JAX package writes every directory)
# ---------------------------------------------------------------------------
def _mlp(width):
    main, startup = jpt.Program(), jpt.Program()
    with jpt.program_guard(main, startup), junique.guard():
        x = jpt.data("x", [width], "float32")
        h = jpt.layers.fc(x, 256, act="relu")
        h = jpt.layers.fc(h, 256, act="relu")
        out = jpt.layers.fc(h, 10)
    return main, startup, out


def _export(d, built, feeds, bucket, scope, quantize=None):
    """save_inference_model of ``built``'s program with ``scope``'s weights,
    then export_aot of the loaded program."""
    main, out = built
    exe = jpt.Executor()
    with jpt.static.scope_guard(scope):
        jpt.io.save_inference_model(d, feeds, [out], exe, main_program=main)
        prog, fnames, fetches = jpt.io.load_inference_model(
            d, exe, scope=jpt.static.Scope())
    jinf.export_aot(d, prog, fnames, fetches, scope, [bucket],
                    quantize=quantize)
    return d


def _scaled(scope, names, k, nan=None):
    out = jpt.static.Scope()
    for n in names:
        v = np.array(scope.find_var(n)) * np.float32(k)
        if n == nan:
            v.flat[0] = np.nan
        out.set_var(n, v)
    return out


def _flip_sidecar(src, dst):
    """A copy of ``src`` with one byte of its int8 sidecar flipped (a file
    the integrity manifest vouches for)."""
    shutil.copytree(src, dst)
    aot = os.path.join(dst, jinf.AOT_DIR)
    name = next(f for f in os.listdir(aot) if f.startswith("quant."))
    path = os.path.join(aot, name)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    return dst


@pytest.fixture(scope="module")
def mlp_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("swap_mlp")
    with static_mode_guard(False):
        main, startup, out = _mlp(256)
        scope = jpt.static.Scope()
        with jpt.static.scope_guard(scope):
            jpt.Executor().run(startup)
        names = sorted(n for n, v in main.global_block().vars.items()
                       if v.persistable)
        bucket = {"x": ((1, 256), "float32")}
        d = {"v1": _export(str(root / "v1"), (main, out), ["x"], bucket,
                           scope)}
        d["v2"] = _export(str(root / "v2"), (main, out), ["x"], bucket,
                          _scaled(scope, names, 0.9), "int8")
        d["nan"] = _export(str(root / "nan"), (main, out), ["x"], bucket,
                           _scaled(scope, names, 1.0, nan=names[-1]))
        d["flip"] = _flip_sidecar(d["v2"], str(root / "flip"))
        m2, s2, o2 = _mlp(128)
        sc2 = jpt.static.Scope()
        with jpt.static.scope_guard(sc2):
            jpt.Executor().run(s2)
        d["spec"] = _export(str(root / "spec"), (m2, o2), ["x"],
                            {"x": ((1, 128), "float32")}, sc2)
    return d


@pytest.fixture(scope="module")
def mobilenet_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("swap_mobilenet")
    cfg = mb.mobilenet_v1_tiny()
    with static_mode_guard(False):
        built = mb.build_train(jpt, cfg)
        scope = jpt.static.Scope()
        exe = jpt.static.Executor(jpt.CPUPlace())
        exe.run(built["startup"], scope=scope)
        d = {"v1": mb.export_served(jpt, exe, scope, built,
                                    str(root / "v1"))}
        names = mb.param_names(built["main"])
        d["nan"] = mb.export_served(
            jpt, exe, _scaled(scope, [n for n in _persistables(built)],
                              1.0, nan="conv1_weights"),
            built, str(root / "nan"))
        for i in range(2):
            exe.run(built["main"], feed=mb.synthetic_batch(cfg, 4, seed=i),
                    fetch_list=[built["loss"]], scope=scope)
        d["v2"] = mb.export_served(jpt, exe, scope, built, str(root / "v2"),
                                   quantize="int8")
        assert "conv1_weights" in names
    return cfg, d


def _persistables(built):
    return sorted(n for n, v in built["test"].global_block().vars.items()
                  if v.persistable)


# ---------------------------------------------------------------------------
# the swap sequence
# ---------------------------------------------------------------------------
def _attempt(P, srv, d, **kw):
    """One swap: (("ok", report keys, stage keys, quantized) or ("failed",
    stage, retryable), {outcome: counter delta})."""
    before = _snap(P)
    try:
        rep = srv.swap(d, **kw)
        res = ("ok", sorted(rep), sorted(rep["stage_ms"]), rep["quantized"])
    except P.Failed as e:
        res = ("failed", e.stage, e.retryable)
    after = _snap(P)
    return res, {o: after[o] - before[o] for o in OUTCOMES
                 if after[o] != before[o]}


def _mlp_sequence(P, dirs, monkeypatch):
    x = {"x": np.random.RandomState(0).rand(2, 256).astype(np.float32)}
    srv = P.Server(dirs["v1"], P.Config(max_batch=2, max_wait_ms=1.0,
                                        **P.dev))
    steps, outs = [], []

    def step(label, d, **kw):
        res = _attempt(P, srv, d, **kw)
        outs.append(np.asarray(srv.infer(x, timeout=60)[0]))
        steps.append((label, res))

    try:
        outs.append(np.asarray(srv.infer(x, timeout=60)[0]))
        step("ok", dirs["v2"], watchdog_ms=50)
        step("spec", dirs["spec"])
        step("flip", dirs["flip"])
        srv.config.hbm_limit_bytes = srv.pool.projected_bytes() + 1
        step("memory", dirs["v1"])
        srv.config.hbm_limit_bytes = None
        step("nan", dirs["nan"])
        ctl = srv._swap_ctl()
        build = ctl._build_standby_pool

        def wedged(bundle):
            time.sleep(1.0)
            return build(bundle)

        monkeypatch.setattr(ctl, "_build_standby_pool", wedged)
        step("wedge", dirs["v1"], standby_timeout_ms=200)
        monkeypatch.setattr(ctl, "_build_standby_pool", build)
        cutover, flipped, rider = ctl._cutover, threading.Event(), {}

        def poisoned(standby, bundle):
            res = cutover(standby, bundle)
            for r in standby.replicas:
                monkeypatch.setattr(r, "run_batch", _boom)
            flipped.set()
            return res

        def send():
            flipped.wait(30)
            try:
                srv.infer(x, timeout=60)
            except RuntimeError as e:
                rider["error"] = str(e)

        monkeypatch.setattr(ctl, "_cutover", poisoned)
        t = threading.Thread(target=send)
        t.start()
        step("storm", dirs["v1"], watchdog_ms=10_000, watchdog_max_errors=1)
        t.join(60)
        monkeypatch.setattr(ctl, "_cutover", cutover)
        steps.append(("storm rider", rider.get("error")))
        assert ctl._swap_lock.acquire(False)
        try:
            step("concurrent", dirs["v1"])
        finally:
            ctl._swap_lock.release()
        step("back", dirs["v1"], watchdog_ms=50)
        steps.append(("version", srv.model_version == jinf.read_aot_version(
            dirs["v1"])))
    finally:
        assert srv.close(timeout=60)
    return steps, outs


def _boom(bucket, feeds):
    raise RuntimeError("poisoned replica")


def _assert_outs_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * float(np.abs(w).max()))


def test_swap_sequence_outcomes_like_jax(mlp_dirs, monkeypatch):
    want, wouts = _mlp_sequence(JAX, mlp_dirs, monkeypatch)
    got, gouts = _mlp_sequence(PORT, mlp_dirs, monkeypatch)
    assert got == want
    by = dict(want)
    ok = ("ok", ["model_dir", "model_version", "outcome",
                 "previous_version", "quantized", "stage_ms"],
          ["admit", "canary", "cutover", "gate", "standby", "watchdog"])
    assert by["ok"] == (ok + ("int8",), {"ok": 1})
    assert by["back"] == (ok + (None,), {"ok": 1})
    assert by["spec"] == by["flip"] == (("failed", "gate", False),
                                        {"gate_failed": 1})
    assert by["memory"] == (("failed", "admission", False),
                            {"refused_memory": 1})
    assert by["nan"] == (("failed", "canary", False), {"canary_failed": 1})
    assert by["wedge"] == (("failed", "standby", False), {"rolled_back": 1})
    assert by["storm"] == (("failed", "watchdog", False), {"rolled_back": 1})
    assert by["storm rider"] == "poisoned replica"
    assert by["concurrent"] == (("failed", "gate", True), {"gate_failed": 1})
    assert by["version"] is True
    _assert_outs_close(gouts, wouts)
    # v2 (int8) served between "ok" and "back"; v1 before and after
    assert not np.allclose(wouts[0], wouts[1], atol=1e-3)
    np.testing.assert_array_equal(wouts[0], wouts[-1])


def _mobilenet_sequence(P, cfg, dirs):
    x = {"image": mb.synthetic_batch(cfg, 2, seed=11)["image"]}
    srv = P.Server(dirs["v1"], P.Config(max_batch=2, max_wait_ms=1.0,
                                        **P.dev))
    try:
        outs = [np.asarray(srv.infer(x, timeout=60)[0])]
        res = [_attempt(P, srv, dirs["v2"], watchdog_ms=50)]
        outs.append(np.asarray(srv.infer(x, timeout=60)[0]))
        res.append(_attempt(P, srv, dirs["nan"]))
        outs.append(np.asarray(srv.infer(x, timeout=60)[0]))
    finally:
        assert srv.close(timeout=60)
    return res, outs


def test_mobilenet_swap_like_jax(mobilenet_dirs):
    """mobilenet_v1_tiny: v1 fp32 -> v2 int8 (ok, its report says int8),
    then a NaN conv weight refused at the canary; the served logits of each
    version within 1e-5 of the JAX package's."""
    cfg, dirs = mobilenet_dirs
    want, wouts = _mobilenet_sequence(JAX, cfg, dirs)
    got, gouts = _mobilenet_sequence(PORT, cfg, dirs)
    assert got == want
    assert want[0][0][0] == "ok" and want[0][0][3] == "int8"
    assert want[1] == (("failed", "canary", False), {"canary_failed": 1})
    _assert_outs_close(gouts, wouts)
    assert wouts[0].shape == (2, cfg.num_classes)
    np.testing.assert_array_equal(wouts[1], wouts[2])


# ---------------------------------------------------------------------------
# watch_dir
# ---------------------------------------------------------------------------
def _publish(src, dst):
    """Copy an export into the watched directory, its AOT index last, so a
    poll sees the new version only once every file it names is there."""
    idx = os.path.join(jinf.AOT_DIR, "index.json")
    for base, _dirs, files in os.walk(src):
        rel = os.path.relpath(base, src)
        os.makedirs(os.path.join(dst, rel), exist_ok=True)
        for f in files:
            if os.path.normpath(os.path.join(rel, f)) != idx:
                shutil.copy2(os.path.join(base, f), os.path.join(dst, rel, f))
    shutil.copy2(os.path.join(src, idx), os.path.join(dst, idx))


def _wait(cond, timeout=30.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _watch_sequence(P, dirs, root):
    w = os.path.join(root, P.name)
    shutil.copytree(dirs["v1"], w)
    version = {jinf.read_aot_version(dirs[k]): k for k in ("v1", "v2", "nan")}
    srv = P.Server(w, P.Config(max_batch=2, max_wait_ms=1.0, **P.dev))
    seen = [version[srv.model_version]]
    try:
        c0 = _snap(P)
        ctl = srv.watch_dir(poll_ms=30, watchdog_ms=0)
        _publish(dirs["v2"], w)
        assert _wait(lambda: version.get(srv.model_version) == "v2")
        seen.append(version[srv.model_version])
        _publish(dirs["nan"], w)
        assert _wait(lambda: _count(P, "canary_failed") > c0[
            "canary_failed"])
        time.sleep(0.3)                 # ten polls: the failure is skipped
        seen.append(version[srv.model_version])
        _publish(dirs["v1"], w)
        assert _wait(lambda: version.get(srv.model_version) == "v1")
        seen.append(version[srv.model_version])
        seen.append(ctl.stop_watch())
        _publish(dirs["v2"], w)
        time.sleep(0.3)
        seen.append(version[srv.model_version])
        c1 = _snap(P)
    finally:
        assert srv.close(timeout=60)
    return seen, {o: c1[o] - c0[o] for o in OUTCOMES}


def test_watch_dir_like_jax(mlp_dirs, tmp_path):
    """The watcher picks up a new manifest version, tries a failed one once
    and skips it, takes the next publish, and stops on ``stop_watch``."""
    want = _watch_sequence(JAX, mlp_dirs, str(tmp_path))
    got = _watch_sequence(PORT, mlp_dirs, str(tmp_path))
    assert got == want
    assert want == (["v1", "v2", "v2", "v1", True, "v1"],
                    {"ok": 2, "gate_failed": 0, "refused_memory": 0,
                     "canary_failed": 1, "rolled_back": 0})


# ---------------------------------------------------------------------------
# the watchdog and the tenant fair share, decision for decision
# ---------------------------------------------------------------------------
def _watchdog_verdicts(Watchdog, reg, seed):
    rng = np.random.RandomState(seed)
    hist = reg.get("serving_request_latency_ms")
    errors = [0]
    out = []
    for case in range(20):
        max_errors = int(rng.randint(1, 4))
        latency_x = None if rng.rand() < 0.3 else float(rng.uniform(1.5, 3))
        baseline = float(rng.uniform(5, 20))
        wd = Watchdog(window_ms=60_000, max_errors=max_errors,
                      latency_x=latency_x, baseline_ms=baseline,
                      min_latency_samples=4,
                      errors_fn=lambda: errors[0]).start()
        verdicts = []
        for _ in range(8):
            errors[0] += int(rng.rand() < 0.2)
            for _ in range(int(rng.randint(0, 3))):
                hist.observe(float(rng.uniform(1, 60)))
            v = wd.verdict()
            verdicts.append(None if v is None else v.split(" ")[1:4])
        out.append(verdicts)
    return out


def test_swap_watchdog_decides_like_jax():
    import paddle_tpu.serving.scheduler  # noqa: F401 (the histograms)
    import paddle_tpu_torch.serving.scheduler  # noqa: F401
    for seed in range(3):
        want = _watchdog_verdicts(JWatchdog, JREGISTRY, seed)
        got = _watchdog_verdicts(TWatchdog, TREGISTRY, seed)
        assert got == want
        assert any(v is not None for case in want for v in case)


class _Shed:
    brownout = False


def _fair_verdicts(Fair, seed):
    rng = np.random.RandomState(seed)
    shed = _Shed()
    fair = Fair(max_inflight=5, fair_frac=0.4, fair_min_inflight=2,
                shed=shed)
    held, out = [], []
    for _ in range(400):
        if rng.rand() < 0.05:
            shed.brownout = not shed.brownout
        if held and rng.rand() < 0.4:
            t = held.pop(int(rng.randint(len(held))))
            out.append(("release", t, fair.release(t)))
            continue
        t = "abc"[min(int(rng.exponential(0.8)), 2)]
        v = fair.admit(t)
        if v is None:
            held.append(t)
        out.append(("admit", t, v, fair.total_inflight))
    return out


def test_tenant_fair_share_decides_like_jax():
    for seed in range(3):
        want = _fair_verdicts(JFair, seed)
        assert _fair_verdicts(TFair, seed) == want
        kinds = {r[2] for r in want if r[0] == "admit"}
        assert kinds == {None, "quota", "fair_share"}
    with pytest.raises(Exception, match="without a matching admit"):
        TFair().release("nobody")


def test_manifest_versions_are_the_port_readers(mlp_dirs):
    """The port reads the JAX-written manifests' versions as the JAX
    package does (the watcher's probe), and its gate refuses the flipped
    byte naming the file."""
    from paddle_tpu_torch import inference as tinf
    for k in ("v1", "v2", "nan", "spec", "flip"):
        assert tinf.read_aot_version(mlp_dirs[k]) == \
            jinf.read_aot_version(mlp_dirs[k])
    with open(os.path.join(mlp_dirs["flip"], jinf.AOT_DIR,
                           "index.json")) as f:
        assert json.load(f)
    with pytest.raises(tinf.AOTIntegrityError, match="quant."):
        tinf.verify_aot_dir(mlp_dirs["flip"])
