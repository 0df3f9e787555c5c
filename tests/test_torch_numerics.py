"""The port's ``FLAGS_check_nan_inf`` (the sentinels and the bisecting
localizer of ``monitor/numerics.py``), tensor watch and AMP's
``monitor_state`` against the JAX package's.

The same program and feeds (made with numpy from a seed) run through both
packages' Executors from the JAX startup's weights: a NaN feed raises
``NonFiniteError`` in both, naming the same tensor and op type, and both
scopes keep their pre-step parameters (the port's bitwise: it runs a
checked step on clones). The tensor-watch stats agree within 1e-5
relative. A tensor-watch program's document is the JAX package's, and the
JAX program loads and runs in the port."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.monitor import numerics as jnumerics
from paddle_tpu.monitor import tensorwatch as jwatch
from paddle_tpu.monitor.registry import REGISTRY as JREG
from paddle_tpu.static import serialize as jser
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.models import ptb_lm
from paddle_tpu_torch.monitor import anomaly as tanomaly
from paddle_tpu_torch.monitor import flight_recorder as tflight
from paddle_tpu_torch.monitor import numerics as tnumerics
from paddle_tpu_torch.monitor import tensorwatch as twatch
from paddle_tpu_torch.monitor.registry import REGISTRY as TREG
from paddle_tpu_torch.static import serialize as tser

#: tensor watch's stats, port against JAX on the same weights and feeds
WATCH_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_static_off():
    """Some JAX test files leave that package's static mode on."""
    with static_mode_guard(False):
        yield


@pytest.fixture
def check_flag():
    tpt.set_flags({"check_nan_inf": True})
    jpt.set_flags({"check_nan_inf": True})
    try:
        yield
    finally:
        tpt.set_flags({"check_nan_inf": False})
        jpt.set_flags({"check_nan_inf": False})


@pytest.fixture
def postmortem_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(tflight.RECORDER, "_dir", str(tmp_path))
    monkeypatch.setattr(tanomaly, "_dumped_kinds", set())
    return tmp_path


def _uniq(pt):
    return tpt.unique_name if pt is tpt else junique


def _pair(build):
    """(port, JAX) of ``build(pt)`` -> (main, startup, fetch), the port's
    scope holding the JAX startup's weights."""
    with _uniq(jpt).guard():
        jmain, jstartup, jout = build(jpt)
    jexe, jscope = jpt.static.Executor(), jpt.static.Scope()
    jexe.run(jstartup, scope=jscope)
    with _uniq(tpt).guard():
        tmain, tstartup, tout = build(tpt)
    names = [n for n, v in tstartup.global_block().vars.items()
             if v.persistable]
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in names}, "cpu", tstartup)
    return ((tpt.Executor(tpt.CPUPlace()), tscope, tmain, tout),
            (jexe, jscope, jmain, jout))


def _fit(pt, lr=0.05, clip=None):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.data("x", [4], "float32")
        y = pt.data("y", [1], "float32")
        pred = pt.layers.fc(x, 1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.SGDOptimizer(lr, grad_clip=clip).minimize(loss)
    return main, startup, loss


def _params(scope, names):
    return {n: np.array(scope.find_var(n)) for n in names}


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_sentinel_trips_on_each_non_finite_kind(bad):
    ok = tnumerics.sentinel([torch.ones(3), torch.zeros(2, 2)])
    assert bool(ok)
    big = torch.full((5,), 3e38)          # a sum would overflow; a max not
    assert bool(tnumerics.sentinel([big, big]))
    for v in ([torch.ones(3), torch.tensor([1.0, bad])],
              [torch.tensor([bad], dtype=torch.bfloat16), torch.ones(2)]):
        assert not bool(tnumerics.sentinel(v))
    assert bool(tnumerics.sentinel([torch.arange(3), torch.tensor([True]),
                                    torch.empty(0)]))
    assert bool(tnumerics.sentinel([]))
    flags = tnumerics.finite_flags([torch.ones(2), torch.arange(2),
                                    torch.tensor([bad])])
    assert flags.tolist() == [True, False]


def test_nan_feed_names_the_same_tensor_and_op_as_jax(check_flag,
                                                      postmortem_dir):
    (texe, tscope, tmain, tloss), (jexe, jscope, jmain, jloss) = _pair(_fit)
    xv = np.random.RandomState(0).rand(8, 4).astype(np.float32)
    yv = xv.sum(1, keepdims=True)
    tl, = texe.run(tmain, feed={"x": xv, "y": yv}, fetch_list=[tloss],
                   scope=tscope)
    jl, = jexe.run(jmain, feed={"x": xv, "y": yv}, fetch_list=[jloss],
                   scope=jscope)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    names = ("fc_w", "fc_b")
    tpre = {n: tscope.find_var(n).clone() for n in names}
    jpre = _params(jscope, names)
    trips = TREG.get("nonfinite_trips_total").value()
    xbad = xv.copy()
    xbad[0, 0] = np.nan
    reports = []
    for exe, scope, main, loss, err in (
            (texe, tscope, tmain, tloss, tnumerics.NonFiniteError),
            (jexe, jscope, jmain, jloss, jnumerics.NonFiniteError)):
        with pytest.raises(err) as ei:
            exe.run(main, feed={"x": xbad, "y": yv}, fetch_list=[loss],
                    scope=scope)
        reports.append(ei.value.report)
    t, j = reports
    assert t["localized"] and j["localized"]
    for k in ("tensor", "op_type", "segment", "shape", "nan_count",
              "inf_count", "size"):
        assert t[k] == j[k], k
    assert all(torch.equal(tpre[n], tscope.find_var(n)) for n in names)
    for n in names:
        np.testing.assert_array_equal(jpre[n], np.array(jscope.find_var(n)))
    assert TREG.get("nonfinite_trips_total").value() == trips + 1
    (dump,) = [f for f in os.listdir(postmortem_dir)
               if "anomaly-non-finite" in f]
    doc = json.load(open(postmortem_dir / dump))
    assert doc["anomaly"]["tensor"] == t["tensor"]
    assert doc["anomaly"]["kind"] == "non_finite"


def _log_net(pt):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.data("x", [4], "float32")
        h = pt.layers.fc(x, 4, act="relu")
        out = pt.layers.mean(pt.layers.log(h - 10.0))
    return main, startup, out


def _sqrt_net(pt):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.data("x", [4], "float32")
        pred = pt.layers.fc(x, 1, bias_attr=False)
        loss = pt.layers.mean(pt.layers.sqrt(pt.layers.abs(pred)))
        pt.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("build,feed,op_type", [
    (_log_net, np.random.RandomState(0).rand(8, 4).astype(np.float32),
     "log"),
    # pred == 0: d sqrt|p| / dp is infinite, the forward finite; the
    # localizer names the @GRAD leaf off the autodiff op
    (_sqrt_net, np.zeros((8, 4), np.float32), "autodiff")])
def test_localizer_names_mid_graph_op_and_grad_leaf_like_jax(
        check_flag, build, feed, op_type):
    (texe, tscope, tmain, tout), (jexe, jscope, jmain, jout) = _pair(build)
    reports = []
    for exe, scope, main, out, err in (
            (texe, tscope, tmain, tout, tnumerics.NonFiniteError),
            (jexe, jscope, jmain, jout, jnumerics.NonFiniteError)):
        with pytest.raises(err) as ei:
            exe.run(main, feed={"x": feed}, fetch_list=[out], scope=scope)
        reports.append(ei.value.report)
    t, j = reports
    assert t["op_type"] == j["op_type"] == op_type
    assert t["tensor"] == j["tensor"] and t["op_index"] > 0
    if op_type == "autodiff":
        assert t["tensor"].endswith("@GRAD")
    else:
        assert t["nan_count"] == t["size"] == j["nan_count"]


def test_check_off_lets_nan_flow_and_checked_step_is_bitwise():
    (texe, tscope, tmain, tloss), _ = _pair(_fit)
    ref = tpt.Scope()
    for n in tscope.names():
        v = tscope.find_var(n)
        ref.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    xv = np.random.RandomState(1).rand(8, 4).astype(np.float32)
    yv = xv.sum(1, keepdims=True)
    e2 = tpt.Executor(tpt.CPUPlace())
    for check in (False, True, False):
        tpt.set_flags({"check_nan_inf": check})
        try:
            a, = texe.run(tmain, feed={"x": xv, "y": yv}, fetch_list=[tloss],
                          scope=tscope)
        finally:
            tpt.set_flags({"check_nan_inf": False})
        b, = e2.run(tmain, feed={"x": xv, "y": yv}, fetch_list=[tloss],
                    scope=ref)
        assert a == b
    for n in ("fc_w", "fc_b"):
        assert torch.equal(tscope.find_var(n), ref.find_var(n))
    nan, = texe.run(tmain, feed={"x": np.full((8, 4), np.nan, np.float32),
                                 "y": yv}, fetch_list=[tloss], scope=tscope)
    assert np.isnan(nan)


def test_localizer_refuses_to_replay_across_a_host_op(check_flag):
    """A host op before the tripped segment: the replay would repeat its
    side effects, so the report says why (the JAX string) and names the
    segment: the device ops after the host op are segment 1."""
    calls = []

    def host(x):
        calls.append(1)
        return x

    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = tpt.data("x", [4], "float32")
        h = tpt.layers.scale(x, 2.0)
        out = main.global_block().create_var(name="hostout", shape=[-1, 4],
                                             dtype="float32")
        tpt.layers.py_func(host, h, out)
        res = tpt.layers.log(tpt.layers.scale(out, 1.0, bias=-10.0))
    exe = tpt.Executor(tpt.CPUPlace())
    with pytest.raises(tnumerics.NonFiniteError) as ei:
        exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                fetch_list=[res])
    r = ei.value.report
    assert not r["localized"] and r["segment"] == 1
    assert r["why"].startswith("program contains host ops")
    assert calls == [1]                   # the host op ran once


def test_a_segment_that_writes_no_float_checks_on_the_steps_device(
        check_flag):
    """A device segment that writes only an int tensor has nothing to
    check: its flag is True on the step's device, so the Executor stacks
    it with the float segments' flags (on the card a CPU True among CUDA
    flags would not stack). The checked step gives the unchecked one's
    result."""
    flag = tnumerics.sentinel([torch.arange(3), torch.tensor([True])],
                              torch.device("meta"))
    assert flag.device.type == "meta" and flag.dtype == torch.bool

    def host(x):
        return x.astype(np.float32) * 2.0

    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = tpt.data("x", [4], "float32")
        ids = tpt.layers.cast(x, "int32")
        out = main.global_block().create_var(name="hostout", shape=[-1, 4],
                                             dtype="float32")
        tpt.layers.py_func(host, ids, out)
        res = tpt.layers.scale(out, 0.5)
    exe = tpt.Executor(tpt.CPUPlace())
    feed = {"x": np.arange(8, dtype=np.float32).reshape(2, 4) + 0.25}
    (checked,) = exe.run(main, feed=feed, fetch_list=[res])
    tpt.set_flags({"check_nan_inf": False})
    (plain,) = exe.run(main, feed=feed, fetch_list=[res])
    assert np.array_equal(checked, plain)
    assert np.array_equal(checked, np.floor(feed["x"]))


def test_dropout_replay_draws_the_tripped_steps_masks(check_flag):
    """The LM with dropout: the localizer's replay uses the step's own
    @step@, so its masks are the tripped step's, and a trip localizes;
    the next clean checked step equals an unchecked executor's from the
    same state, bitwise."""
    cfg = ptb_lm.lm_tiny(dropout=0.5)
    b = ptb_lm.build_train(tpt, cfg)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(b["startup"], scope=scope)
    (x, y), = ptb_lm.ptb_windows(ptb_lm.markov_stream(
        cfg, cfg.batch * (cfg.num_steps + 1), 3), cfg)
    xn, yn = [v.name for v in b["reader"].vars]
    state = np.zeros((cfg.batch, cfg.state_width), np.float32)
    feed = {xn: x, yn: y, "init": state}
    names = ptb_lm.param_names(cfg)
    pre = {n: scope.find_var(n).clone() for n in names}
    emb = scope.find_var("embedding_para")
    emb[int(x[0, 0])] = float("inf")
    with pytest.raises(tnumerics.NonFiniteError) as ei:
        exe.run(b["main"], feed=feed, fetch_list=[b["loss"]], scope=scope)
    r = ei.value.report
    assert r["localized"] and r["op_type"] == "embedding" \
        and r["inf_count"] > 0
    emb[int(x[0, 0])] = pre["embedding_para"][int(x[0, 0])]
    assert all(torch.equal(pre[n], scope.find_var(n)) for n in names)
    ref = tpt.Scope()
    for n in scope.names():
        v = scope.find_var(n)
        ref.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    a, = exe.run(b["main"], feed=feed, fetch_list=[b["loss"]], scope=scope)
    tpt.set_flags({"check_nan_inf": False})
    e2 = tpt.Executor(tpt.CPUPlace())
    c, = e2.run(b["main"], feed=feed, fetch_list=[b["loss"]], scope=ref)
    assert a == c
    assert all(torch.equal(scope.find_var(n), ref.find_var(n))
               for n in names)


# ---------------------------------------------------------------------------
def test_watch_stats_agree_with_jax_and_peel_off():
    from paddle_tpu.clip import GradientClipByGlobalNorm as JClip

    from paddle_tpu_torch.clip import GradientClipByGlobalNorm as TClip
    twatch.enable()
    jwatch.enable()
    try:
        (texe, tscope, tmain, tloss), _ = _pair(
            lambda pt: _fit(pt, clip=(TClip if pt is tpt else JClip)(1e6)))
        with _uniq(jpt).guard():
            jmain, jstartup, jloss = _fit(jpt, clip=JClip(1e6))
        jexe, jscope = jpt.static.Executor(), jpt.static.Scope()
        jexe.run(jstartup, scope=jscope)
        for n in ("fc_w", "fc_b"):
            tscope.set_var(n, torch.tensor(np.array(jscope.find_var(n))))
        assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
        xv = np.random.RandomState(0).rand(8, 4).astype(np.float32)
        yv = xv.sum(1, keepdims=True)
        h0 = TREG.get("grad_global_norm_per_step").count()
        out = texe.run(tmain, feed={"x": xv, "y": yv}, fetch_list=[tloss],
                       scope=tscope)
        assert len(out) == 1                # the stats var peeled off
        jexe.run(jmain, feed={"x": xv, "y": yv}, fetch_list=[jloss],
                 scope=jscope)
        stats = [(TREG.get(k).value(), JREG.get(k).value()) for k in (
            "grad_global_norm", "param_global_norm", "update_ratio")]
        for t, j in stats:
            assert t == pytest.approx(j, rel=WATCH_RTOL) and t > 0
        gn, pn, ratio = (t for t, _ in stats)
        # SGD under a clip that does not bind: ||delta|| = lr ||g||, so the
        # ratio is lr * gn / pn: the pre-op's copy is not the updated param
        assert ratio == pytest.approx(0.05 * gn / pn, rel=1e-4)
        assert TREG.get("grad_global_norm_per_step").count() == h0 + 1
        # the JAX package's watch program loads and runs in the port
        loaded = tser.program_from_dict(jser.program_to_dict(jmain))
        out = tpt.Executor(tpt.CPUPlace()).run(
            loaded, feed={"x": xv, "y": yv}, fetch_list=[tloss.name],
            scope=tscope)
        assert len(out) == 1 and np.isfinite(out[0])
    finally:
        twatch.disable()
        jwatch.disable()
    with _uniq(tpt).guard():
        main, _, _ = _fit(tpt)
    types = [op.type for op in main.global_block().ops]
    assert "tensor_watch_pre" not in types and "tensor_watch_post" \
        not in types


def test_watch_norms_are_the_clip_norms_on_the_lm():
    """Under the LM's global-norm clip the watch's pre-clip grad norm is
    ``clip.global_norm`` of the step's grads, to the last bit."""
    from paddle_tpu_torch.clip import global_norm
    cfg = ptb_lm.lm_tiny()
    twatch.enable()
    try:
        b = ptb_lm.build_train(tpt, cfg)
    finally:
        twatch.disable()
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(b["startup"], scope=scope)
    (x, y), = ptb_lm.ptb_windows(ptb_lm.markov_stream(
        cfg, cfg.batch * (cfg.num_steps + 1), 4), cfg)
    xn, yn = [v.name for v in b["reader"].vars]
    names = ptb_lm.param_names(cfg)
    grads = [n + "@GRAD" for n in names]
    old = [scope.find_var(n).clone() for n in names]
    stats, *g = exe.run(b["main"], feed={
        xn: x, yn: y, "init": np.zeros((cfg.batch, cfg.state_width),
                                       np.float32)},
        fetch_list=[twatch.STATS_VAR] + grads, scope=scope,
        return_numpy=False)
    new = [scope.find_var(n) for n in names]
    assert stats[0] == global_norm(g)
    assert stats[1] == global_norm(old)
    assert stats[2] == global_norm([a - o for a, o in zip(new, old)])


def test_eager_tensor_monitor_and_loss_scale_like_jax():
    import jax.numpy as jnp
    from paddle_tpu.monitor import TensorMonitor as JTM

    from paddle_tpu_torch.monitor import TensorMonitor as TTM
    tg = TTM().observe({"w": torch.ones(3)}, {"w": torch.full((3,), 2.0)},
                       {"w": torch.full((3,), 0.9)})
    tr = TREG.get("update_ratio").value()
    jg = JTM().observe({"w": jnp.ones((3,))}, {"w": jnp.full((3,), 2.0)},
                       {"w": jnp.full((3,), 0.9)})
    assert tg == pytest.approx(jg) == pytest.approx(np.sqrt(12.0))
    assert tr == pytest.approx(JREG.get("update_ratio").value(), rel=1e-6)
    twatch.enable()
    try:
        dec0 = TREG.get("loss_scale_decrements_total").value()
        for s in (1024.0, 1024.0, 512.0, 1024.0):
            twatch.record_loss_scale(s)
        assert TREG.get("loss_scale_decrements_total").value() == dec0 + 1
        # the amp hookup: a non-finite grad halves the scale and
        # monitor_state publishes the decrement
        opt = tamp.OptimizerWithMixedPrecision(
            tpt.optimizer.SGD(0.1), tamp.float16_policy(),
            tamp.LossScaler(init_loss_scaling=1024.0,
                            decr_every_n_nan_or_inf=1))
        params = {"w": torch.ones(2)}
        state = opt.init(params)
        assert opt.monitor_state(state) == 1024.0
        opt.apply_gradients(params, {"w": torch.tensor([np.inf, 1.0])},
                            state)
        assert opt.monitor_state(state, step=1) == 512.0
        assert TREG.get("loss_scale_decrements_total").value() == dec0 + 2
        assert tamp.decorate(tpt.optimizer.SGD(0.1)).monitor_state({}) \
            is None
    finally:
        twatch.disable()


def test_jax_sentinel_and_port_sentinel_agree():
    import jax.numpy as jnp
    cases = [[1.0, 2.0], [1.0, np.nan], [np.inf], [-np.inf, 0.0], [3e38]]
    for c in cases:
        a = np.asarray(c, np.float32)
        assert bool(tnumerics.sentinel([torch.tensor(a)])) == \
            bool(np.asarray(jax.jit(jnumerics.sentinel)([jnp.asarray(a)])))
