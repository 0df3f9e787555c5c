"""Learning-rate schedules, regularizers and gradient clipping in the port
(paddle_tpu_torch) against the JAX package, on the CPU: the schedules
alone, the regularizers and clips alone, the functional ``apply_gradients``
under all three, the static ``minimize`` (a schedule, a parameter's
``ParamAttr`` regularizer and learning rate, ``set_gradient_clip``), and
programs the JAX package wrote with a regularizer and a clip, loaded and run
by the port.

The JAX package runs its stock bodies (the default on the CPU). Tolerances:
the schedules are the same fp32 ops in the same order (``pow``, ``exp`` and
``cos`` may differ by an ulp): rtol 1e-6. The updates round every product
and sum alike; the global norm adds its per-leaf sums in another leaf order
(the JAX package's tree order is by sorted key): parameters and slots after
five steps rtol 1e-6 (atol 1e-7 where an element is near zero). The static
path as tests/test_torch_static.py holds it: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import clip as jclip
from paddle_tpu import regularizer as jreg
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.layers import learning_rate_scheduler as jlrs
from paddle_tpu.static import serialize as jser

import paddle_tpu_torch as tpt
from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.layers import learning_rate_scheduler as tlrs
from paddle_tpu_torch.static import serialize as tser

STEPS = range(0, 201)

# name -> (constructor name, args, kwargs); "warmup_over" wraps another
SCHEDULES = {
    "noam": ("noam_decay", (512, 40), {}),
    "noam_lr": ("noam_decay", (64, 25), {"learning_rate": 2.0}),
    "exponential": ("exponential_decay", (0.1, 30, 0.5), {}),
    "exponential_stair": ("exponential_decay", (0.1, 30, 0.5),
                          {"staircase": True}),
    "natural_exp": ("natural_exp_decay", (0.1, 30, 0.5), {}),
    "natural_exp_stair": ("natural_exp_decay", (0.1, 30, 0.5),
                          {"staircase": True}),
    "inverse_time": ("inverse_time_decay", (0.1, 30, 0.5), {}),
    "inverse_time_stair": ("inverse_time_decay", (0.1, 30, 0.5),
                           {"staircase": True}),
    "polynomial": ("polynomial_decay", (0.1, 50), {"power": 2.0}),
    "polynomial_cycle": ("polynomial_decay", (0.1, 50),
                         {"end_learning_rate": 1e-3, "cycle": True}),
    "piecewise": ("piecewise_decay", ([30, 80, 150],
                                      [0.1, 0.05, 0.01, 0.001]), {}),
    "cosine": ("cosine_decay", (0.1, 20, 10), {}),
    "warmup_float": ("linear_lr_warmup", (0.1, 20, 0.0, 0.1), {}),
}


def _make(mod, name):
    ctor, args, kw = SCHEDULES[name]
    return getattr(mod, ctor)(*args, **kw)


def _warmup_over(mod):
    inner = mod.piecewise_decay([40, 120], [0.1, 0.02, 0.004])
    return mod.linear_lr_warmup(inner, 25, 0.001, 0.1)


def _values(s_jax, s_port):
    want = np.array([float(s_jax(t)) for t in STEPS], np.float32)
    got = []
    for t in STEPS:
        v = s_port(torch.tensor(t, dtype=torch.int32))
        assert v.dtype == torch.float32 and v.dim() == 0
        got.append(float(v))
    return np.array(got, np.float32), want


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    got, want = _values(_make(jlrs, name), _make(tlrs, name))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_warmup_over_a_schedule_matches_jax():
    got, want = _values(_warmup_over(jlrs), _warmup_over(tlrs))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == np.float32(0.001) and got[60] == np.float32(0.02)


def test_schedules_are_exported_from_layers():
    for ctor in {c for c, _, _ in SCHEDULES.values()}:
        assert getattr(tpt.layers, ctor) is getattr(tlrs, ctor)
    assert tpt.layers.learning_rate_scheduler is tlrs


def test_schedule_of_a_python_step_and_a_tensor_step_agree():
    s = tlrs.piecewise_decay([3], [0.5, 0.25])
    assert float(s(2)) == 0.5 and float(s(3)) == 0.25
    assert float(s(torch.tensor(3.0))) == 0.25


# ---------------------------------------------------------------------------
# regularizers and clips
# ---------------------------------------------------------------------------
def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"w": (scale * rng.randn(7, 5)).astype(np.float32),
            "b": (scale * rng.randn(5)).astype(np.float32),
            "deep": [{"x": (scale * rng.randn(3)).astype(np.float32)}]}


@pytest.mark.parametrize("kind", ["L1Decay", "L2Decay", "L1DecayRegularizer",
                                  "L2DecayRegularizer"])
def test_decay_matches_jax(kind):
    p, g = _tree(0), _tree(1)
    jr, tr = getattr(jreg, kind)(0.01), getattr(treg, kind)(0.01)
    for k in ("w", "b"):
        want = np.asarray(jr(jnp.asarray(p[k]), jnp.asarray(g[k])))
        got = tr(torch.tensor(p[k]), torch.tensor(g[k])).numpy()
        np.testing.assert_array_equal(got, want)
    assert jreg.L2Decay is jreg.L2DecayRegularizer
    assert treg.L2Decay is treg.L2DecayRegularizer


CLIPS = {
    "value": ("GradientClipByValue", (0.5,), {}),
    "value_min": ("GradientClipByValue", (0.5,), {"min": -0.2}),
    "norm": ("GradientClipByNorm", (1.0,), {}),
    "global_norm": ("GradientClipByGlobalNorm", (1.0,), {}),
    "global_norm_not_reached": ("GradientClipByGlobalNorm", (100.0,), {}),
}


@pytest.mark.parametrize("name", list(CLIPS))
def test_clip_matches_jax(name):
    ctor, args, kw = CLIPS[name]
    g = _tree(2, scale=0.7)
    want = jax.tree.map(np.asarray, getattr(jclip, ctor)(*args, **kw)
                        .clip_tree(jax.tree.map(jnp.asarray, g)))
    got = getattr(tclip, ctor)(*args, **kw).clip_tree(
        jax.tree.map(torch.tensor, g))
    assert isinstance(got["deep"], list)
    for k, w in (("w", want["w"]), ("b", want["b"]),
                 ("x", want["deep"][0]["x"])):
        t = got["deep"][0]["x"] if k == "x" else got[k]
        np.testing.assert_allclose(t.numpy(), w, rtol=1e-6, atol=1e-7)


def test_global_norm_and_error_clip_match_jax():
    g = _tree(3)
    want = float(jclip.global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(tclip.global_norm(jax.tree.map(torch.tensor, g)))
    assert got == pytest.approx(want, rel=1e-6)
    assert float(tclip.global_norm({})) == 0.0
    e = tclip.ErrorClipByValue(2.0)
    assert (e.max, e.min) == (2.0, -2.0)


def test_set_gradient_clip_is_stored_on_the_program():
    main = tpt.Program()
    clip = tclip.GradientClipByGlobalNorm(1.0)
    tclip.set_gradient_clip(clip, program=main)
    assert tclip.get_gradient_clip(main) is clip
    assert main.clone()._grad_clip is clip
    assert tclip.get_gradient_clip(tpt.Program()) is None
    with tpt.program_guard(main):
        tclip.set_gradient_clip(None)
    assert tclip.get_gradient_clip(main) is None


# ---------------------------------------------------------------------------
# the functional apply_gradients under all three
# ---------------------------------------------------------------------------
def _opt(pt, rule):
    lrs = pt.layers.learning_rate_scheduler
    sched = lrs.linear_lr_warmup(lrs.exponential_decay(0.05, 2, 0.7), 2,
                                 0.01, 0.05)
    kw = {"learning_rate": sched,
          "regularization": pt.regularizer.L2Decay(0.01),
          "grad_clip": pt.clip.GradientClipByGlobalNorm(2.0)}
    if rule == "momentum":
        return pt.optimizer.Momentum(momentum=0.9, **kw)
    if rule == "nesterov":
        return pt.optimizer.Momentum(momentum=0.9, use_nesterov=True, **kw)
    if rule == "adam":
        return pt.optimizer.Adam(**kw)
    return pt.optimizer.SGD(**kw)


@pytest.mark.parametrize("rule", ["sgd", "momentum", "nesterov", "adam"])
def test_apply_gradients_under_schedule_regularizer_clip_matches_jax(rule):
    p_np = _tree(4)
    grads = [_tree(10 + i, scale=1.5) for i in range(5)]
    jopt = _opt(jpt, rule)
    jp = jax.tree.map(jnp.asarray, p_np)
    jstate = jopt.init(jp)
    for g in grads:
        jp, jstate = jopt.apply_gradients(jp, jax.tree.map(jnp.asarray, g),
                                          jstate)
    topt = _opt(tpt, rule)
    tp = jax.tree.map(torch.tensor, p_np)
    tstate = topt.init(tp)
    for g in grads:
        topt.apply_gradients(tp, jax.tree.map(torch.tensor, g), tstate)
    assert int(tstate["step"]) == 5
    for got, want in ((tp, jp), (tstate["slots"], jstate["slots"])):
        got = jax.tree.map(lambda t: t.numpy(), got)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_scheduled_rate_reaches_the_kernels_as_a_tensor(monkeypatch):
    """A schedule's value travels as a 0-d fp32 tensor on the counter's
    device (the kernels read it from device memory: no host sync)."""
    from paddle_tpu_torch import optimizer as topt
    seen = []
    real = topt.fused_momentum

    def spy(params, grads, velocities, lr, **kw):
        seen.append(lr)
        return real(params, grads, velocities, lr, **kw)

    monkeypatch.setattr(topt, "fused_momentum", spy)
    opt = topt.Momentum(tlrs.piecewise_decay([1], [0.1, 0.01]))
    p = {"w": torch.ones(3)}
    state = opt.init(p)
    for _ in range(2):
        opt.apply_gradients(p, {"w": torch.ones(3)}, state)
    assert [float(x) for x in seen] == pytest.approx([0.01, 0.01])
    assert all(isinstance(x, torch.Tensor) and x.dtype == torch.float32
               and x.dim() == 0 for x in seen)
    # a constant rate keeps the float
    seen.clear()
    opt = topt.Momentum(0.1)
    opt.apply_gradients(p, {"w": torch.ones(3)}, opt.init(p))
    assert seen == [0.1]


def test_optimizer_refuses_what_is_not_a_regularizer_or_clip():
    with pytest.raises(EnforceNotMet, match="regularization"):
        tpt.optimizer.SGD(0.1, regularization=object())
    with pytest.raises(EnforceNotMet, match="clip_tree"):
        tpt.optimizer.SGD(0.1, grad_clip=object())


# ---------------------------------------------------------------------------
# the static path
# ---------------------------------------------------------------------------
def _build(pt, unique_name, scheduled, clip):
    """Two fc layers (the first with its own L1 regularizer and half the
    learning rate), Momentum with L2 decay, and a Program clip."""
    main, startup = pt.Program(), pt.Program()
    lrs = pt.layers.learning_rate_scheduler
    lr = lrs.piecewise_decay([2], [0.01, 0.004]) if scheduled else 0.01
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", shape=[13], dtype="float32")
        y = pt.data("y", shape=[1], dtype="float32")
        h = pt.layers.fc(x, size=8, act="relu", param_attr=pt.ParamAttr(
            regularizer=pt.regularizer.L1Decay(1e-3), learning_rate=0.5))
        pred = pt.layers.fc(h, size=1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.clip.set_gradient_clip(clip(pt), program=main)
        pt.optimizer.Momentum(
            learning_rate=lr, momentum=0.9,
            regularization=pt.regularizer.L2Decay(1e-3)).minimize(loss)
    return main, startup, loss


_STATIC_CLIPS = {
    "global_norm": lambda pt: pt.clip.GradientClipByGlobalNorm(0.5),
    "value": lambda pt: pt.clip.GradientClipByValue(0.3),
}


def _feeds(steps):
    rng = np.random.RandomState(0)
    w = rng.randn(13, 1).astype(np.float32)
    out = []
    for _ in range(steps):
        x = rng.randn(16, 13).astype(np.float32)
        out.append({"x": x, "y": (x @ w + 0.5).astype(np.float32)})
    return out


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items()
                  if v.persistable)


def _jax_static(main, startup, loss, feeds):
    scope = jpt.static.Scope()
    exe = jpt.Executor()
    exe.run(startup, scope=scope)
    names = _persistables(startup)
    s0 = {n: np.array(scope.find_var(n)) for n in names}
    losses = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
              for f in feeds]
    return s0, losses, {n: np.array(scope.find_var(n)) for n in names}


def _port_static(main, startup, loss, s0, feeds):
    scope = tpt.Scope.from_numpy(s0, "cpu", startup)
    exe = tpt.Executor(tpt.CPUPlace())
    losses = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
              for f in feeds]
    return losses, {n: scope.find_var(n).numpy() for n in s0}


def _ops(program):
    out = []
    for op in program.global_block().ops:
        attrs = {}
        if op.type == "apply_optimizer":
            reg = op.attrs["regularizer"]
            attrs = {"regularizer": type(reg).__name__ if reg else None,
                     "coeff": getattr(reg, "coeff", None),
                     "param_lr": op.attrs["param_lr"]}
        elif op.type == "clip_grads":
            attrs = {"clip": type(op.attrs["clip"]).__name__,
                     **vars(op.attrs["clip"])}
        out.append((op.type, {k: list(v) for k, v in op.inputs.items()},
                    {k: list(v) for k, v in op.outputs.items()}, attrs))
    return out


@pytest.mark.parametrize("clip", list(_STATIC_CLIPS))
def test_static_minimize_with_schedule_param_attr_and_clip_matches_jax(clip):
    jmain, jstart, jloss = _build(jpt, junique, True, _STATIC_CLIPS[clip])
    tmain, tstart, tloss = _build(tpt, tpt.unique_name, True,
                                  _STATIC_CLIPS[clip])
    assert _ops(tmain) == _ops(jmain)
    types = [op.type for op in tmain.global_block().ops]
    assert types.index("increment_step") < types.index("clip_grads") \
        < types.index("apply_optimizer")
    feeds = _feeds(3)
    s0, losses_j, final_j = _jax_static(jmain, jstart, jloss, feeds)
    losses_t, final_t = _port_static(tmain, tstart, tloss, s0, feeds)
    np.testing.assert_allclose(losses_t, losses_j, rtol=0, atol=1e-5)
    assert losses_t[-1] < losses_t[0]
    for n in final_j:
        np.testing.assert_allclose(final_t[n], final_j[n], rtol=0,
                                   atol=1e-5, err_msg=n)


def test_programs_with_a_regularizer_and_a_clip_write_the_jax_documents():
    for clip in _STATIC_CLIPS.values():
        for t, j in zip(_build(tpt, tpt.unique_name, False, clip)[:2],
                        _build(jpt, junique, False, clip)[:2]):
            assert tser.program_to_dict(t) == jser.program_to_dict(j)


@pytest.mark.parametrize("clip", list(_STATIC_CLIPS))
def test_program_saved_by_jax_with_l2_decay_and_a_clip_runs_in_the_port(
        clip):
    jmain, jstart, jloss = _build(jpt, junique, False, _STATIC_CLIPS[clip])
    main, _ = tser.loads_program(jser.dumps_program(jmain))
    startup, _ = tser.loads_program(jser.dumps_program(jstart))
    blk = main.global_block()
    regs = [op.attrs["regularizer"] for op in blk.ops
            if op.type == "apply_optimizer"]
    assert isinstance(regs[0], treg.L1DecayRegularizer)
    opt = next(op.attrs["opt"] for op in blk.ops
               if op.type == "apply_optimizer")
    assert isinstance(opt.regularization, treg.L2DecayRegularizer)
    assert opt.regularization.coeff == 1e-3
    clip_op = next(op for op in blk.ops if op.type == "clip_grads")
    assert type(clip_op.attrs["clip"]).__module__ == "paddle_tpu_torch.clip"
    feeds = _feeds(3)
    s0, losses_j, final_j = _jax_static(jmain, jstart, jloss, feeds)
    losses_t, final_t = _port_static(main, startup, jloss.name, s0, feeds)
    np.testing.assert_allclose(losses_t, losses_j, rtol=0, atol=1e-5)
    for n in final_j:
        np.testing.assert_allclose(final_t[n], final_j[n], rtol=0,
                                   atol=1e-5, err_msg=n)
