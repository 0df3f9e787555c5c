"""The twelve update rules without a kernel (LarsMomentum, Adagrad, Adamax,
DecayedAdagrad, Adadelta, RMSProp, Ftrl, ProximalGD, ProximalAdagrad,
Lamb, ModelAverage, ExponentialMovingAverage) in the port against the JAX
package, on the CPU: the functional ``apply_gradients`` (plain and under a
piecewise schedule, L2 decay and a global-norm clip), the static
``minimize`` against the JAX static Executor, ``state_from_numpy`` from
the JAX ``init``, and each rule's traps one by one.

The JAX package runs its stock bodies (no Pallas body exists for these
rules). Tolerances: the elementwise rules round every product and sum in
the same order, but XLA on the CPU forms FMAs (ROADMAP queue 3 note c):
1e-6 after five steps. Lars and Lamb take whole-tensor norms, summed in
another order, and Ftrl's pow branch calls a different ``pow``: 1e-5.
The static path as tests/test_torch_static.py holds it: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.framework import unique_name as junique

import paddle_tpu_torch as tpt
from paddle_tpu_torch import optimizer as topt

# name -> (class, args, kwargs, tolerance)
RULES = {
    "lars": ("LarsMomentum", (0.1,), {"momentum": 0.9}, 1e-5),
    "lars_coeff": ("LarsMomentumOptimizer", (0.5,),
                   {"lars_coeff": 0.02, "lars_weight_decay": 0.01}, 1e-5),
    "adagrad": ("Adagrad", (0.1,), {}, 1e-6),
    "adagrad_initial": ("AdagradOptimizer", (0.1,),
                        {"initial_accumulator_value": 0.3}, 1e-6),
    "adamax": ("Adamax", (0.01,), {}, 1e-6),
    "decayed_adagrad": ("DecayedAdagrad", (0.05,), {}, 1e-6),
    "adadelta": ("Adadelta", (1.0,), {}, 1e-6),
    "rmsprop": ("RMSProp", (0.01,), {}, 1e-6),
    "rmsprop_centered": ("RMSPropOptimizer", (0.01,), {"centered": True},
                         1e-6),
    "rmsprop_momentum": ("RMSProp", (0.01,), {"momentum": 0.9}, 1e-6),
    "ftrl": ("Ftrl", (0.1,), {"l1": 0.01, "l2": 0.01}, 1e-6),
    "ftrl_pow": ("FtrlOptimizer", (0.1,),
                 {"l1": 0.01, "l2": 0.01, "lr_power": -0.3}, 1e-5),
    "proximal_gd": ("ProximalGD", (0.1,), {"l1": 0.01, "l2": 0.02}, 1e-6),
    "proximal_adagrad": ("ProximalAdagradOptimizer", (0.1,),
                         {"l1": 0.01, "l2": 0.02}, 1e-6),
    "lamb": ("Lamb", (0.01,), {}, 1e-5),
    "lamb_decay": ("LambOptimizer", (0.02,), {"lamb_weight_decay": 0.1},
                   1e-5),
}


def _make(pkg, name, scheduled=False):
    cls, args, kw, _ = RULES[name]
    kw = dict(kw)
    if scheduled:
        lr = args[0]
        args = (pkg.layers.piecewise_decay([2, 4], [lr, lr / 2, lr / 4]),
                ) + args[1:]
        kw.update(regularization=pkg.regularizer.L2Decay(0.01),
                  grad_clip=pkg.clip.GradientClipByGlobalNorm(1.0))
    return getattr(pkg.optimizer, cls)(*args, **kw)


def _tree(seed, scale=1.0, zero_b=False):
    rng = np.random.RandomState(seed)
    t = {"w": (scale * rng.randn(7, 5)).astype(np.float32),
         "b": (scale * rng.randn(5)).astype(np.float32),
         "deep": [{"x": (scale * rng.randn(3)).astype(np.float32)}]}
    if zero_b:
        t["b"][:] = 0.0
    return t


def _run_jax(opt, p_np, grads):
    jp = jax.tree.map(jnp.asarray, p_np)
    state = opt.init(jp)
    for g in grads:
        jp, state = opt.apply_gradients(jp, jax.tree.map(jnp.asarray, g),
                                        state)
    return jp, state


def _run_port(opt, p_np, grads):
    tp = jax.tree.map(torch.tensor, p_np)
    state = opt.init(tp)
    for g in grads:
        out = opt.apply_gradients(tp, jax.tree.map(torch.tensor, g), state)
        assert out[0] is tp and out[1] is state      # in place
    return tp, state


def _close(got, want, tol):
    got = jax.tree.map(lambda t: t.numpy(), got)
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("scheduled", [False, True],
                         ids=["plain", "schedule_l2_clip"])
@pytest.mark.parametrize("name", list(RULES))
def test_apply_gradients_matches_jax(name, scheduled):
    p_np = _tree(4)
    grads = [_tree(10 + i, scale=1.5) for i in range(5)]
    jp, jstate = _run_jax(_make(jpt, name, scheduled), p_np, grads)
    tp, tstate = _run_port(_make(tpt, name, scheduled), p_np, grads)
    tol = RULES[name][3]
    assert tstate["step"].dtype == torch.int32 and int(tstate["step"]) == 5
    _close(tp, jp, tol)
    _close(tstate["slots"], jstate["slots"], tol)


@pytest.mark.parametrize("name", ["lars", "lamb"])
def test_norm_rules_on_a_zero_tensor_match_jax(name):
    """A zero parameter has norm 0: the trust ratio is 1 (``jnp.where``),
    not 0/0."""
    p_np = _tree(5, zero_b=True)
    grads = [_tree(20 + i) for i in range(3)]
    jp, _ = _run_jax(_make(jpt, name), p_np, grads)
    tp, _ = _run_port(_make(tpt, name), p_np, grads)
    assert np.isfinite(tp["b"].numpy()).all()
    assert not np.array_equal(tp["b"].numpy(), p_np["b"])
    _close(tp, jp, RULES[name][3])


@pytest.mark.parametrize("name", [n for n in RULES if n not in
                                  ("lars_coeff", "lamb_decay")])
def test_state_from_numpy_of_the_jax_init(name):
    p_np = _tree(6)
    jopt, t = _make(jpt, name), _make(tpt, name)
    jstate = jax.tree.map(np.asarray, jopt.init(jax.tree.map(jnp.asarray,
                                                               p_np)))
    tp = jax.tree.map(torch.tensor, p_np)
    got = t.state_from_numpy(jstate, tp)
    want = t.init(tp)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0
    _close(got["slots"], jax.tree.map(lambda x: x.numpy(), want["slots"]),
           0)


def test_adagrad_initial_accumulator_reaches_init_and_minimize():
    opt = topt.Adagrad(0.1, initial_accumulator_value=0.3)
    assert opt._slot_defaults == {"moment": 0.3}
    assert topt.Adagrad._slot_defaults == {"moment": 0.0}
    state = opt.init({"w": torch.zeros(2, 3)})
    assert torch.equal(state["slots"]["w"]["moment"],
                       torch.full((2, 3), 0.3))
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = tpt.data("x", [4])
        loss = tpt.layers.mean(tpt.layers.fc(x, 2))
        opt.minimize(loss)
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(startup, scope=scope)
    assert torch.equal(scope.find_var("fc_w@moment"), torch.full((4, 2), 0.3))


def test_rmsprop_carries_mean_grad_when_not_centered():
    p_np = _tree(7)
    grads = [_tree(30 + i) for i in range(3)]
    for kw, moves in (({}, False), ({"centered": True}, True),
                      ({"momentum": 0.9}, False)):
        _, state = _run_port(topt.RMSProp(0.01, **kw), p_np, grads)
        mg = state["slots"]["w"]["mean_grad"]
        assert bool(mg.abs().sum() > 0) == moves, kw


def test_lamb_takes_and_ignores_its_exclude_function():
    calls = []

    def exclude(name):
        calls.append(name)
        return True

    p_np = _tree(8)
    grads = [_tree(40 + i) for i in range(3)]
    opt = topt.Lamb(0.01, exclude_from_weight_decay_fn=exclude)
    assert opt.exclude_fn is exclude
    a, _ = _run_port(opt, p_np, grads)
    b, _ = _run_port(topt.Lamb(0.01), p_np, grads)
    for x, y in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), a)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), b))):
        np.testing.assert_array_equal(x, y)
    assert calls == []


def test_ftrl_branches_on_lr_power():
    p_np = _tree(9)
    grads = [_tree(50 + i) for i in range(2)]
    a, _ = _run_port(topt.Ftrl(0.1, l1=0.01, lr_power=-0.5), p_np, grads)
    b, _ = _run_port(topt.Ftrl(0.1, l1=0.01, lr_power=-0.3), p_np, grads)
    assert not np.allclose(a["w"].numpy(), b["w"].numpy())


def test_proximal_adagrad_inherits_proximal_gd():
    opt = topt.ProximalAdagrad(0.1, l1=0.5, l2=0.2)
    assert isinstance(opt, topt.ProximalGD)
    assert (opt.l1, opt.l2) == (0.5, 0.2)
    assert topt.ProximalGD._slot_defaults == {}
    # a large l1 shrinks small entries to exactly 0
    p = {"w": torch.tensor([0.01, -0.02, 3.0])}
    opt.apply_gradients(p, {"w": torch.tensor([0.0, 0.0, 0.0])},
                        opt.init(p))
    assert p["w"][0] == 0 and p["w"][1] == 0 and p["w"][2] > 0


def test_rate_and_bias_correction_are_fp32_tensors_on_the_device(
        monkeypatch):
    """The rule sees the rate as a 0-d fp32 tensor (a float rate too), and
    a step makes no host sync: no ``.item()``, no Python branch on a
    tensor."""
    seen = []
    real = topt.AdamaxOptimizer._update

    def spy(self, p, g, slots, lr, t):
        seen.append((lr, t))
        return real(self, p, g, slots, lr, t)

    monkeypatch.setattr(topt.AdamaxOptimizer, "_update", spy)
    for name in list(RULES):
        for scheduled in (False, True):
            opt = _make(tpt, name, scheduled)
            p = jax.tree.map(torch.tensor, _tree(1))
            state = opt.init(p)

            def refuse(*a, **k):
                raise AssertionError("host sync in a step")

            with monkeypatch.context() as m:
                m.setattr(torch.Tensor, "item", refuse)
                m.setattr(torch.Tensor, "__bool__", refuse)
                m.setattr(torch.Tensor, "__float__", refuse)
                opt.apply_gradients(p, jax.tree.map(torch.tensor, _tree(2)),
                                    state)
    assert seen
    for lr, t in seen:
        assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
        assert lr.dim() == 0 and t.dtype == torch.int32


# ---------------------------------------------------------------------------
# ModelAverage and ExponentialMovingAverage
# ---------------------------------------------------------------------------
def test_model_average_matches_jax():
    ps = [_tree(60 + i) for i in range(4)]
    jma = jpt.optimizer.ModelAverage(0.15, 10000, 8)
    tma = topt.ModelAverage(0.15, 10000, 8)
    assert tma.max_window == jma.max_window == 8
    js = jma.init(jax.tree.map(jnp.asarray, ps[0]))
    tp = jax.tree.map(torch.tensor, ps[0])
    ts = tma.init(tp)
    empty = tma.average(ts)
    assert float(empty["w"].abs().sum()) == 0.0
    for p in ps:
        js = jma.accumulate(jax.tree.map(jnp.asarray, p), js)
        assert tma.accumulate(jax.tree.map(torch.tensor, p), ts) is ts
    assert int(ts["count"]) == 4 and ts["count"].dtype == torch.int32
    _close(tma.average(ts), jma.average(js), 1e-6)
    # the JAX rule raises from its (absent) ``_update`` once it gets past
    # reading the step counter, which its own state lacks
    with pytest.raises(NotImplementedError):
        jma.apply_gradients(jax.tree.map(jnp.asarray, ps[0]),
                            jax.tree.map(jnp.asarray, ps[1]),
                            {"step": jnp.zeros((), jnp.int32), "slots": {}})
    with pytest.raises(NotImplementedError):
        tma.apply_gradients(tp, jax.tree.map(torch.tensor, ps[1]), ts)


@pytest.mark.parametrize("decay", [0.999, 0.5])
def test_exponential_moving_average_matches_jax(decay):
    ps = [_tree(70 + i) for i in range(6)]
    jema = jpt.optimizer.ExponentialMovingAverage(decay, thres_steps=3)
    tema = topt.ExponentialMovingAverage(decay, thres_steps=3)
    js = jema.init(jax.tree.map(jnp.asarray, ps[0]))
    tp0 = jax.tree.map(torch.tensor, ps[0])
    ts = tema.init(tp0)
    assert ts["ema"]["w"] is not tp0["w"]
    for p in ps[1:]:
        js = jema.update(jax.tree.map(jnp.asarray, p), js)
        assert tema.update(jax.tree.map(torch.tensor, p), ts) is ts
    assert int(ts["step"]) == 5
    _close(tema.apply(ts), jema.apply(js), 1e-6)


# ---------------------------------------------------------------------------
# the static path: minimize against the JAX static Executor
# ---------------------------------------------------------------------------
def _build(pt, unique_name, name):
    """fit-a-line with a hidden layer (the first fc with its own L1
    regularizer and half the rate), the rule under a schedule, L2 decay
    and a Program clip."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", shape=[13], dtype="float32")
        y = pt.data("y", shape=[1], dtype="float32")
        h = pt.layers.fc(x, size=8, act="relu", param_attr=pt.ParamAttr(
            regularizer=pt.regularizer.L1Decay(1e-3), learning_rate=0.5))
        pred = pt.layers.fc(h, size=1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(0.5),
                                  program=main)
        _make(pt, name, scheduled=True).minimize(loss)
    return main, startup, loss


def _feeds(steps):
    rng = np.random.RandomState(0)
    w = rng.randn(13, 1).astype(np.float32)
    out = []
    for _ in range(steps):
        x = rng.randn(16, 13).astype(np.float32)
        out.append({"x": x, "y": (x @ w + 0.5).astype(np.float32)})
    return out


@pytest.mark.parametrize("name", [n for n in RULES if n not in
                                  ("lars_coeff", "lamb_decay")])
def test_minimize_matches_the_jax_static_executor(name):
    feeds = _feeds(5)
    jmain, jstart, jloss = _build(jpt, junique, name)
    scope = jpt.static.Scope()
    jexe = jpt.Executor()
    jexe.run(jstart, scope=scope)
    names = sorted(n for n, v in jstart.global_block().vars.items()
                   if v.persistable)
    s0 = {n: np.array(scope.find_var(n)) for n in names}
    jl = [float(jexe.run(jmain, feed=f, fetch_list=[jloss],
                         scope=scope)[0]) for f in feeds]
    jfinal = {n: np.array(scope.find_var(n)) for n in names}

    tmain, tstart, tloss = _build(tpt, tpt.unique_name, name)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    tscope = tpt.Scope.from_numpy(s0, "cpu", tstart)
    texe = tpt.Executor(tpt.CPUPlace())
    tl = [float(texe.run(tmain, feed=f, fetch_list=[tloss],
                         scope=tscope)[0]) for f in feeds]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(), jfinal[n],
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    assert tl[-1] < tl[0]


def test_static_rules_launch_only_their_kernels(monkeypatch):
    """SGD, Momentum and Adam keep one kernel call per parameter on the
    static path; the rules without a kernel call none. The cost monitor's
    abstract pass of a runner's first step calls the wrappers on ``meta``
    tensors, where they run their plain bodies: no kernel call."""
    calls = []

    def first_tensor(a):
        for x in a:
            if isinstance(x, torch.Tensor):
                return x
            if isinstance(x, (list, tuple)) and x:
                t = first_tensor(x)
                if t is not None:
                    return t
        return None

    def record(k, a):
        t = first_tensor(a)
        if t is None or t.device.type != "meta":
            calls.append(k)

    for k in ("fused_adam", "fused_momentum", "fused_sgd"):
        real = getattr(topt, k)
        monkeypatch.setattr(topt, k, lambda *a, _k=k, _r=real, **kw: (
            record(_k, a), _r(*a, **kw))[1])
    for opt, want in ((topt.Adam(0.01), ["fused_adam"] * 4),
                      (topt.Momentum(0.01), ["fused_momentum"] * 4),
                      (topt.SGD(0.01), ["fused_sgd"] * 4),
                      (topt.Adagrad(0.01), []), (topt.Lamb(0.01), [])):
        main, startup = tpt.Program(), tpt.Program()
        with tpt.program_guard(main, startup), tpt.unique_name.guard():
            x = tpt.data("x", [13])
            y = tpt.data("y", [1])
            h = tpt.layers.fc(x, 8, act="relu")
            loss = tpt.layers.mean(tpt.layers.square_error_cost(
                tpt.layers.fc(h, 1), y))
            opt.minimize(loss)
        scope = tpt.Scope()
        exe = tpt.Executor(tpt.CPUPlace())
        exe.run(startup, scope=scope)
        calls.clear()
        exe.run(main, feed=_feeds(1)[0], fetch_list=[loss], scope=scope)
        assert calls == want, type(opt).__name__
