"""The static-graph path of the port (paddle_tpu_torch) against the JAX
package: the three kernels it brings (embedding gather, fused matmul, SGD and
momentum), the programs the layers build and the pass pipeline rewrites, and
training through ``Executor.run``.

The JAX package runs its Pallas bodies in interpret mode
(``pallas.override("on")``), as its own tests do on the CPU; the port runs
the plain bodies its CPU tensors take. Parameters cross over by name: the JAX
startup program runs, its scope's persistables (parameters, optimizer slots,
step counter) go to ``Scope.from_numpy``, and the same numpy feeds then train
both.

Tolerances (fp32 throughout). Kernels: the gather is a copy (exact); SGD and
momentum round every product and sum in the same order, but XLA contracts
the interpret-mode kernel's multiply-adds into FMAs (the stock JAX rule
agrees with the port bit for bit): a few ulp of the largest values, observed
4.8e-7 on velocities near 4 after 4 steps, held to 1e-6; the fused matmul
sums K products in another order (atol 1e-5). Training, losses and final parameters after 10 word2vec
steps (SGD, Momentum, Adam) and 30 fit-a-line steps (SGD): expected within
1e-5; observed losses 9.5e-7 at most for word2vec (2 ulp of 7.7) and 3.8e-6
for fit-a-line (a loss of 25 to 7.6), parameters 6e-8 at most under SGD and
Momentum and 4.7e-7 under Adam (its sign-like early updates magnify
summation-order differences of near-zero grads); held to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.ops.pallas as jpallas
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.ops.pallas import embedding as jemb
from paddle_tpu.ops.pallas import matmul as jmm
from paddle_tpu.ops.pallas import optimizer as jopt_k
from paddle_tpu.static import opt_passes as jpasses

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops import nn as tnn
from paddle_tpu_torch.static import opt_passes as tpasses

TOL = 1e-5
# the reference's word2vec book test at its own width
V, E, H, BATCH = 2073, 32, 256, 100


def _build_word2vec(pt, unique_name, opt):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        words = [pt.data(f"w{i}", [1], "int64") for i in range(4)]
        nxt = pt.data("next", [1], "int64")
        embs = [pt.layers.embedding(w, size=[V, E], param_attr="shared_w")
                for w in words]
        concat = pt.layers.concat(embs, axis=1)
        hidden = pt.layers.fc(concat, H, act="sigmoid")
        pred = pt.layers.fc(hidden, V, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, nxt))
        opt(pt).minimize(loss)
    return main, startup, loss


def _build_fit_a_line(pt, unique_name, opt):
    """docs/MIGRATION.md:20-35."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", shape=[13], dtype="float32")
        y = pt.data("y", shape=[1], dtype="float32")
        pred = pt.layers.fc(x, size=1)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        opt(pt).minimize(loss)
    return main, startup, loss


_OPTS = {
    "sgd": lambda pt: pt.optimizer.SGDOptimizer(learning_rate=0.001),
    "sgd_fit": lambda pt: pt.optimizer.SGDOptimizer(0.01),
    "momentum": lambda pt: pt.optimizer.MomentumOptimizer(0.001,
                                                          momentum=0.9),
    "nesterov": lambda pt: pt.optimizer.MomentumOptimizer(
        0.001, momentum=0.9, use_nesterov=True),
    "adam": lambda pt: pt.optimizer.AdamOptimizer(learning_rate=0.001),
}


def _w2v_feeds(steps, batch=BATCH, seed=0):
    """One batch of 5-grams, drawn from a seed, fed ``steps`` times: a
    fixed corpus the model can learn (as tests/test_book.py's feeders)."""
    ids = np.random.RandomState(seed).randint(0, V, (batch, 5))
    feed = {f"w{i}": ids[:, i:i + 1] for i in range(4)}
    feed["next"] = ids[:, 4:5]
    return [feed] * steps


def _fit_feeds(steps, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(13, 1).astype(np.float32)
    out = []
    for _ in range(steps):
        x = rng.randn(32, 13).astype(np.float32)
        out.append({"x": x, "y": (x @ w + 0.5).astype(np.float32)})
    return out


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items()
                  if v.persistable)


def _jax_train(build, opt, feeds):
    """(startup persistables, losses, final persistables) of the JAX
    package's Executor, its kernels in Pallas interpret mode."""
    main, startup, loss = build(jpt, junique, _OPTS[opt])
    scope = jpt.static.Scope()
    exe = jpt.Executor()
    with jpallas.override("on"):
        exe.run(startup, scope=scope)
        names = _persistables(startup)
        s0 = {n: np.array(scope.find_var(n)) for n in names}
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0]) for f in feeds]
    return s0, losses, {n: np.array(scope.find_var(n)) for n in names}


def _port_train(build, opt, s0, feeds, strategy=None):
    main, startup, loss = build(tpt, tpt.unique_name, _OPTS[opt])
    scope = tpt.Scope.from_numpy(s0, "cpu", startup)
    exe = tpt.Executor(tpt.CPUPlace())
    prog = main if strategy is None else tpt.CompiledProgram(main, strategy)
    losses = [float(exe.run(prog, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    return losses, {n: scope.find_var(n).numpy() for n in s0}, exe


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("body", ["stock", "pallas"])
def test_embedding_gather_matches_jax(body):
    rng = np.random.RandomState(1)
    h, d = 37, 20
    table = rng.randn(h, d).astype(np.float32)
    if body == "stock":
        # negative ids wrap once, ids outside [-h, h) give NaN rows
        ids = np.array([[0, -1, h - 1, h], [-h, -h - 1, 5, 5]])
        want = jemb.embedding_gather_reference(table, ids)
    else:
        # the Pallas body turns negative ids into NaN: non-negative only
        ids = np.array([[0, 3, h - 1, h], [h + 4, 5, 5, 36]])
        want = jemb.embedding_gather_pallas(table, ids, interpret=True)
    got = K.embedding_gather(torch.tensor(table), torch.tensor(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # gradient: JAX's VJP (the stock take's, or _gather_bwd) against the
    # port's autograd Function
    dy = rng.randn(*ids.shape, d).astype(np.float32)
    fn = (jemb.embedding_gather_reference if body == "stock" else
          lambda t, i: jemb.embedding_gather_pallas(t, i, interpret=True))
    _, vjp = jax.vjp(lambda t: fn(t, jnp.asarray(ids)), jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    K.embedding_gather(t, torch.tensor(ids)).backward(torch.tensor(dy))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(dy)[0]),
                               rtol=1e-6, atol=1e-6)


def test_embedding_op_squeezes_and_pads_like_jax():
    rng = np.random.RandomState(2)
    table = rng.randn(11, 4).astype(np.float32)
    ids = np.array([[3], [10], [0], [3]])
    for pad in (None, 3, -1):
        want = jpt.ops.embedding(jnp.asarray(ids), jnp.asarray(table), pad)
        got = tnn.embedding(torch.tensor(ids), torch.tensor(table), pad)
        assert got.shape == want.shape == (4, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("act", [None, "relu", "sigmoid", "tanh", "gelu"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_matmul_matches_jax(act, with_bias):
    rng = np.random.RandomState(3)
    m, k, n = 19, 40, 300                  # n: a multiple of no tile
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    b = rng.randn(n).astype(np.float32) if with_bias else None
    dy = rng.randn(m, n).astype(np.float32)

    def jfn(x_, w_, b_):
        return jmm.fused_matmul_pallas(x_, w_, b_, act, interpret=True)

    args = [jnp.asarray(a) for a in (x, w, b) if a is not None]
    want, vjp = jax.vjp(lambda *a: jfn(a[0], a[1], a[2] if b is not None
                                       else None), *args)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, b)
              if a is not None]
    got = K.fused_matmul(leaves[0], leaves[1],
                         leaves[2] if b is not None else None, act)
    # sums of K fp32 products in another order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    got.backward(torch.tensor(dy))
    for leaf, g in zip(leaves, vjp(dy)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rule", ["sgd", "momentum", "nesterov"])
def test_fused_sgd_and_momentum_match_jax(rule):
    rng = np.random.RandomState(4)
    shapes = [(33, 70), (5,), (1,), (300,)]
    p = [rng.randn(*s).astype(np.float32) for s in shapes]
    g = [rng.randn(*s).astype(np.float32) for s in shapes]
    v = [rng.randn(*s).astype(np.float32) for s in shapes]
    tp, tg, tv = ([torch.tensor(a) for a in xs] for xs in (p, g, v))
    if rule == "sgd":
        want = [(jopt_k.fused_sgd_pallas(a, b, 0.01, interpret=True),)
                for a, b in zip(p, g)]
        K.fused_sgd(tp, tg, 0.01)
        got = [(a,) for a in tp]
    else:
        nest = rule == "nesterov"
        want = [jopt_k.fused_momentum_pallas(a, b, c, 0.01, 0.9, nest,
                                             interpret=True)
                for a, b, c in zip(p, g, v)]
        K.fused_momentum(tp, tg, tv, 0.01, 0.9, nest)
        got = list(zip(tp, tv))
    for gs, ws in zip(got, want):
        for a, b in zip(gs, ws):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov"])
def test_apply_gradients_matches_jax(opt):
    rng = np.random.RandomState(5)
    shapes = {"w": (33, 70), "b": (5,), "deep": [{"x": (1,)}, {"x": (9,)}]}
    make = lambda: jax.tree.map(  # noqa: E731
        lambda s: rng.randn(*s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    p_np, grads_np = make(), [make() for _ in range(4)]
    jo, to = _OPTS[opt](jpt), _OPTS[opt](tpt)
    jp = jax.tree.map(jnp.asarray, p_np)
    with jpallas.override("on"):
        js = jo.init(jp)
        for g in grads_np:
            jp, js = jo.apply_gradients(jp, jax.tree.map(jnp.asarray, g), js)
    tp = jax.tree.map(torch.tensor, p_np)
    ts = to.init(tp)
    for g in grads_np:
        out_p, out_s = to.apply_gradients(tp, jax.tree.map(torch.tensor, g),
                                          ts)
        assert out_p is tp and out_s is ts      # in place
    assert int(ts["step"]) == 4
    got = jax.tree.leaves((tp, ts["slots"]))
    want = jax.tree.leaves((jp, js["slots"]))
    assert len(got) == len(want) == (4 if opt == "sgd" else 8)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# programs and passes
# ---------------------------------------------------------------------------
def _op_list(program):
    return [(op.type, op.inputs, op.outputs)
            for op in program.global_block().ops]


@pytest.mark.parametrize("build,n_before,n_after", [
    (_build_word2vec, 20, 17), (_build_fit_a_line, 8, 7)])
def test_programs_and_passes_match_jax(build, n_before, n_after):
    jm, _, jl = build(jpt, junique, _OPTS["sgd"])
    tm, _, tl = build(tpt, tpt.unique_name, _OPTS["sgd"])
    assert _op_list(tm) == _op_list(jm) and len(_op_list(tm)) == n_before
    jvars, tvars = jm.global_block().vars, tm.global_block().vars
    assert set(jvars) == set(tvars)
    for n in jvars:
        assert tvars[n].shape == jvars[n].shape, n
        assert tvars[n].persistable == jvars[n].persistable, n
    jo, jreport = jpasses.optimize_program(jm, targets=(jl.name,),
                                           record=False)
    to, report = tpasses.optimize_program(tm, targets=(tl.name,))
    assert _op_list(to) == _op_list(jo) and len(_op_list(to)) == n_after
    assert report.ops_removed() == n_before - n_after
    for a, b in zip(to.global_block().ops, jo.global_block().ops):
        if a.type == "fused_matmul":
            assert a.attrs == b.attrs
    # the whole JAX pipeline, pass by pass: the same passes in the same
    # order, each removing the same ops
    assert [(r["pass"], r["ops_removed"]) for r in report.per_pass] == \
        [(r["pass"], r["ops_removed"]) for r in jreport.per_pass]
    for tcls, jcls in ((tpasses.ConstantFoldingPass,
                        jpasses.ConstantFoldingPass),
                       (tpasses.FoldScaleCastChainPass,
                        jpasses.FoldScaleCastChainPass),
                       (tpasses.CancelTransposeReshapePass,
                        jpasses.CancelTransposeReshapePass)):
        tprog, jprog = tm.clone(), jm.clone()
        tcls((tl.name,)).apply(tprog)
        jcls((jl.name,)).apply(jprog)
        assert _op_list(tprog) == _op_list(jprog), tcls.__name__


def test_gelu_keeps_its_op_as_in_jax():
    """fc(act="gelu") records gelu's ``approximate`` attr, which keeps the
    activation out of the fusion in both packages."""
    def build(pt, unique_name, _opt):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), unique_name.guard():
            x = pt.data("x", [8])
            out = pt.layers.fc(pt.layers.fc(x, 4, act="gelu"), 3,
                               act="tanh")
        return main, startup, out

    jm, _, jo = build(jpt, junique, None)
    tm, _, to = build(tpt, tpt.unique_name, None)
    j_opt, _ = jpasses.optimize_program(jm, targets=(jo.name,), record=False)
    t_opt, _ = tpasses.optimize_program(tm, targets=(to.name,))
    assert [op.type for op in t_opt.global_block().ops] == \
        [op.type for op in j_opt.global_block().ops] == \
        ["fused_matmul", "gelu", "fused_matmul"]


def test_softmax_layer_takes_the_jax_signature():
    """``layers.softmax(input, use_cudnn=False, name=None, axis=-1)``, as the
    JAX layer: a positional ``use_cudnn`` and the keywords record the same
    ops and attrs in both packages, and the eager call agrees."""
    def build(pt, unique_name):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), unique_name.guard():
            x = pt.data("x", [6])
            pt.layers.softmax(x, False)
            pt.layers.softmax(input=x, use_cudnn=True, axis=0)
        return main

    def ops(m):
        return [(op.type, dict(op.attrs)) for op in m.global_block().ops]

    assert ops(build(tpt, tpt.unique_name)) == ops(build(jpt, junique)) == [
        ("softmax", {"axis": -1}), ("softmax", {"axis": 0})]
    x = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    np.testing.assert_allclose(
        tpt.layers.softmax(torch.from_numpy(x), False).numpy(),
        np.asarray(jpt.layers.softmax(jnp.asarray(x), False)), atol=1e-6)


# ---------------------------------------------------------------------------
# training through Executor.run
# ---------------------------------------------------------------------------
def _check_training(losses_t, losses_j, final_t, final_j):
    np.testing.assert_allclose(losses_t, losses_j, atol=TOL, rtol=0)
    assert losses_t[-1] < losses_t[0]
    assert final_t.keys() == final_j.keys()
    for n in final_j:
        np.testing.assert_allclose(final_t[n], final_j[n], atol=TOL, rtol=0,
                                   err_msg=n)


def test_fit_a_line_trains_like_jax():
    feeds = _fit_feeds(30)
    s0, losses_j, final_j = _jax_train(_build_fit_a_line, "sgd_fit", feeds)
    losses_t, final_t, _ = _port_train(_build_fit_a_line, "sgd_fit", s0,
                                       feeds)
    _check_training(losses_t, losses_j, final_t, final_j)
    assert int(final_t["@opt@SGDOptimizer@step"]) == 30


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_word2vec_trains_like_jax(opt):
    feeds = _w2v_feeds(10)
    s0, losses_j, final_j = _jax_train(_build_word2vec, opt, feeds)
    losses_t, final_t, _ = _port_train(_build_word2vec, opt, s0, feeds)
    _check_training(losses_t, losses_j, final_t, final_j)
    # every parameter moved
    for n in ("shared_w", "fc_w", "fc_b", "fc_w_1", "fc_b_1"):
        assert not np.array_equal(final_t[n], s0[n]), n


def test_passes_on_and_off_agree():
    feeds = _w2v_feeds(3)
    s0, _, _ = _jax_train(_build_word2vec, "sgd", feeds[:0])
    off = tpt.BuildStrategy()
    off.apply_ir_passes = False
    losses_on, final_on, exe_on = _port_train(_build_word2vec, "sgd", s0,
                                              feeds)
    losses_off, final_off, exe_off = _port_train(_build_word2vec, "sgd", s0,
                                                 feeds, strategy=off)
    # the fused op and the composition it replaces: the same fp32 math
    np.testing.assert_allclose(losses_on, losses_off, atol=TOL, rtol=0)
    for n in final_on:
        np.testing.assert_allclose(final_on[n], final_off[n], atol=TOL,
                                   rtol=0)
    (run_on,) = exe_on._runners.values()
    assert [op.type for op in run_on.program.global_block().ops].count(
        "fused_matmul") == 2
    (run_off,) = exe_off._runners.values()
    assert "fused_matmul" not in [             # off: the program as built
        op.type for op in run_off.program.global_block().ops]
    tpt.set_flags({"apply_ir_passes": False})
    try:
        losses_flag, _, exe_flag = _port_train(_build_word2vec, "sgd", s0,
                                               feeds)
    finally:
        tpt.set_flags({"apply_ir_passes": True})
    (run_flag,) = exe_flag._runners.values()
    assert "fused_matmul" not in [
        op.type for op in run_flag.program.global_block().ops]
    assert losses_flag == losses_off


def test_unreached_parameter_gets_a_zero_grad():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = tpt.data("x", [4])
        tpt.layers.fc(x, 3)                    # fc_w, fc_b: not in the loss
        loss = tpt.layers.mean(tpt.layers.fc(x, 1))
        tpt.optimizer.SGDOptimizer(0.1).minimize(loss)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    w0 = scope.find_var("fc_w").clone()
    feed = {"x": np.ones((2, 4), np.float32)}
    g_unused, g_used = exe.run(main, feed=feed, scope=scope,
                               fetch_list=["fc_w@GRAD", "fc_w_1@GRAD"])
    assert not g_unused.any() and g_used.any()
    assert torch.equal(scope.find_var("fc_w"), w0)
    # no parameter at all: the autodiff op still runs
    main2, startup2 = tpt.Program(), tpt.Program()
    with tpt.program_guard(main2, startup2), tpt.unique_name.guard():
        loss2 = tpt.layers.mean(tpt.data("x", [4]))
        tpt.optimizer.SGDOptimizer(0.1).minimize(loss2)
    exe.run(startup2, scope=scope)
    (out,) = exe.run(main2, feed=feed, fetch_list=[loss2], scope=scope)
    assert out == 1.0


def test_startup_on_the_port_and_fetches():
    main, startup, loss = _build_word2vec(tpt, tpt.unique_name, _OPTS["sgd"])
    startup.random_seed = 7
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    (w0,) = exe.run(startup, fetch_list=["shared_w"], scope=scope)
    limit = np.sqrt(6.0 / (V + E))             # Xavier on [V, E]
    assert w0.shape == (V, E) and np.abs(w0).max() <= limit
    assert np.all(scope.find_var("fc_b").numpy() == 0)
    assert scope.find_var("@opt@SGDOptimizer@step").dtype == torch.int32
    feed = _w2v_feeds(1)[0]
    out = exe.run(main, feed=feed, fetch_list=[loss, "fc_w@GRAD"],
                  scope=scope, return_numpy=False)
    assert isinstance(out[0], torch.Tensor) and out[0].shape == ()
    assert out[1].shape == (4 * E, H) and out[1].abs().sum() > 0
    assert scope.find_var("@step@") == 1
    # the same seed gives the same weights
    scope2 = tpt.Scope()
    exe.run(startup, scope=scope2)
    assert torch.equal(scope2.find_var("shared_w"),
                       scope.find_var("shared_w").new_tensor(w0))


def test_scope_from_numpy_is_strict():
    _, startup, _ = _build_fit_a_line(tpt, tpt.unique_name, _OPTS["sgd"])
    good = {"fc_w": np.zeros((13, 1), np.float32),
            "fc_b": np.zeros((1,), np.float32),
            "@opt@SGDOptimizer@step": np.asarray(0, np.int32)}
    scope = tpt.Scope.from_numpy(good, "cpu", startup)
    assert scope.find_var("fc_w").shape == (13, 1)

    def bad(mutate, match):
        tree = dict(good)
        mutate(tree)
        with pytest.raises(EnforceNotMet, match=match):
            tpt.Scope.from_numpy(tree, "cpu", startup)

    bad(lambda t: t.pop("fc_b"), "missing")
    bad(lambda t: t.__setitem__("extra", np.zeros(1)), "unexpected")
    bad(lambda t: t.__setitem__("fc_w", np.zeros((1, 13), np.float32)),
        "'fc_w'")
    bad(lambda t: t.__setitem__("@opt@SGDOptimizer@step",
                                np.asarray(0, np.int64)), "int32")
    bad(lambda t: t.__setitem__("fc_b", [0.0]), "list")


def test_what_is_not_ported_raises(monkeypatch):
    # FLAGS_check_nan_inf is ported: a NaN feed raises NonFiniteError and
    # leaves the scope's parameters bitwise at their pre-step values
    from paddle_tpu_torch.monitor.numerics import NonFiniteError
    main, startup, loss = _build_fit_a_line(tpt, tpt.unique_name,
                                            _OPTS["sgd"])
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    xv = np.ones((4, 13), np.float32)
    xv[1, 2] = np.nan
    before = {n: scope.find_var(n).clone() for n in ("fc_w", "fc_b")}
    tpt.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(NonFiniteError) as ei:
            exe.run(main, feed={"x": xv, "y": np.ones((4, 1), np.float32)},
                    fetch_list=[loss], scope=scope)
    finally:
        tpt.set_flags({"check_nan_inf": False})
    assert ei.value.report["localized"]
    assert all(torch.equal(before[n], scope.find_var(n)) for n in before)
    with pytest.raises(EnforceNotMet, match="queue 1 item 10"):
        exe.feed_stage()
    with pytest.raises(EnforceNotMet, match="queue 1 item 10"):
        exe.train_from_dataset()
    main, _, _ = _build_fit_a_line(tpt, tpt.unique_name, _OPTS["sgd"])
    with pytest.raises(EnforceNotMet, match="queue 1 item 9"):
        tpt.CompiledProgram(main).with_data_parallel()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tpt.NoCudaDeviceError):
        tpt.Executor()
    assert tpt.Executor(tpt.CPUPlace()).device == torch.device("cpu")


def _checkpointed(pt, unique_name, checkpoints):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", [13], "float32")
        y = pt.data("y", [1], "float32")
        h = pt.layers.fc(x, 8, act="tanh")
        loss = pt.layers.mean(pt.layers.square_error_cost(
            pt.layers.fc(h, 1), y))
        pg = pt.static.append_backward(
            loss, checkpoints=[h] if checkpoints else None)
    return main, startup, loss, [g.name for _, g in pg]


@pytest.mark.parametrize("checkpoints", [False, True])
def test_append_backward_checkpoints_match_jax(checkpoints):
    """F11: ``append_backward(checkpoints=[...])`` records ``"checkpoint":
    True`` in the autodiff op as the JAX function does (no recompute in
    either package): the documents are equal, and so are the gradients,
    with and without it, from the JAX startup's weights."""
    from paddle_tpu.static import serialize as jser
    from paddle_tpu_torch.static import serialize as tser
    tm, ts, tl, tg = _checkpointed(tpt, tpt.unique_name, checkpoints)
    jm, js, jl, jg = _checkpointed(jpt, junique, checkpoints)
    assert tser.program_to_dict(tm) == jser.program_to_dict(jm)
    assert tm.global_block().ops[-1].attrs["checkpoint"] is checkpoints
    jscope, jexe = jpt.static.Scope(), jpt.static.Executor(jpt.CPUPlace())
    jexe.run(js, scope=jscope)
    names = [n for n, v in js.global_block().vars.items() if v.persistable]
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in names}, "cpu", ts)
    rng = np.random.RandomState(11)
    feed = {"x": rng.randn(6, 13).astype(np.float32),
            "y": rng.randn(6, 1).astype(np.float32)}
    want = jexe.run(jm, feed=feed, fetch_list=[jl] + jg, scope=jscope)
    got = tpt.Executor(tpt.CPUPlace()).run(tm, feed=feed,
                                           fetch_list=[tl] + tg, scope=tscope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
