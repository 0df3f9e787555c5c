"""Control flow, tensor arrays, ``backward``, the debugger and
``Executor.prepare`` in the port against the JAX package, on the CPU.

- eager: ``tests/test_control_flow_classes.py``'s cases (While, Switch,
  IfElse, StaticRNN, DynamicRNN) on both packages; ``cond``, ``case`` and
  ``switch_case`` (dict and list, with and without a default) run one
  branch on one host read; ``while_loop`` reads its predicate once per
  iteration; ``scan``, ``static_rnn``, ``dynamic_rnn`` and the RNN classes
  read nothing on the host (every host read raises around them);
- every tensor-array function, at tied lengths too (numpy's orders);
- static: ``tests/test_serialize.py``'s control-flow round trips on the
  port (the while and scan blocks, a captured parameter, the JSON round
  trip, a fresh interpreter loading a saved while model), the documents
  equal to the JAX package's; the refusals of both packages: an op that
  draws inside a body, training through a while block; a scan block's
  gradients against JAX's;
- ``backward.gradients`` / ``calc_gradient``, ``pprint_program``,
  ``draw_graph`` and ``memory_usage`` against the JAX package, and
  ``Executor.prepare`` with (shape, dtype) pairs and ``trace_count``
  (``tests/test_executor_cache.py``'s contract).

Tolerances: moved or compared values exact; sums 1e-6; the scan's
gradients 1e-5.
"""

import os
import re
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import backward as jbackward
from paddle_tpu import initializer as JI
from paddle_tpu import layers as jlayers
from paddle_tpu.core.lod import RaggedBatch as JRB
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.ops import control_flow as jcf
from paddle_tpu.ops import tensor_array as jta
from paddle_tpu.static import serialize as jser
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import backward as tbackward
from paddle_tpu_torch import initializer as TI
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.lod import RaggedBatch as TRB
from paddle_tpu_torch.ops import control_flow as tcf
from paddle_tpu_torch.ops import tensor_array as tta
from paddle_tpu_torch.static import serialize as tser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6

JAX = types.SimpleNamespace(
    pt=jpt, L=jlayers, I=JI, names=junique, arr=jnp.asarray, cf=jcf, ta=jta,
    RB=JRB, Exe=lambda: jpt.static.Executor(), Scope=jpt.static.Scope,
    backward=jbackward)
PORT = types.SimpleNamespace(
    pt=tpt, L=tlayers, I=TI, names=tpt.unique_name,
    arr=lambda a: torch.tensor(np.asarray(a)), cf=tcf, ta=tta, RB=TRB,
    Exe=lambda: tpt.Executor(tpt.CPUPlace()), Scope=tpt.Scope,
    backward=tbackward)
BOTH = pytest.mark.parametrize("P", [JAX, PORT], ids=["jax", "port"])


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d)."""
    with static_mode_guard(False):
        yield


def _np(x):
    if isinstance(x, (JRB, TRB)):
        return (_np(x.data), _np(x.lengths))
    if isinstance(x, (tuple, list)):
        return tuple(_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _same(got, want, tol=0.0):
    got, want = _np(got), _np(want)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, tol)
        return
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


class _NoHostReads:
    """Every way a tensor's value reaches the host raises inside."""

    NAMES = ("item", "__bool__", "__float__", "__int__", "__index__",
             "tolist", "numpy")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(*a, **k):
            raise AssertionError("a host read")
        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


# ---------------------------------------------------------------------------
# the eager classes (tests/test_control_flow_classes.py's cases)
# ---------------------------------------------------------------------------
@BOTH
def test_while_countdown(P):
    tcf.reset_host_reads()
    i, acc = P.L.While(lambda i, acc: i < 5)(
        lambda i, acc: (i + 1, acc + i), [P.arr(0), P.arr(0.0)])
    assert int(i) == 5 and float(acc) == 10.0
    if P is PORT:      # one read per iteration and the last, false one
        assert tcf.host_reads() == 6


@BOTH
def test_while_refuses_a_with_block_condition(P):
    with pytest.raises(Exception, match="callable"):
        P.L.While(P.arr(True))


@BOTH
@pytest.mark.parametrize("x,want", [(2.0, 200.0), (5.0, 50.0), (0.5, -0.5)])
def test_switch_first_true_case_wins(P, x, want):
    x = P.arr(np.float32(x))
    with P.L.Switch() as sw:
        with sw.case(x > 3.0):
            a = x * 10.0
        with sw.case(x > 1.0):
            b = x * 100.0
        with sw.default():
            c = -x
    assert float(sw.select(a, b, c)) == want


@BOTH
def test_switch_refuses_a_missing_default(P):
    x = P.arr(np.float32(0.5))
    with P.L.Switch() as sw:
        with sw.case(x > 3.0):
            a = x * 10.0
    with pytest.raises(Exception, match="default"):
        sw.select(a)


@BOTH
def test_ifelse_merges_rows_and_refuses_output_without_input(P):
    x = P.arr(np.array([[1.0], [2.0], [3.0], [4.0]], np.float32))
    ie = P.L.IfElse(x[:, 0] > 2.5)
    with ie.true_block():
        ie.output(ie.input(x) * 10.0)
    with ie.false_block():
        ie.output(ie.input(x) * -1.0)
    (out,) = ie()
    np.testing.assert_allclose(_np(out)[:, 0], [-1.0, -2.0, 30.0, 40.0])
    ie = P.L.IfElse(P.arr(np.array([True, False])))
    with ie.true_block():
        ie.output(P.arr(np.ones((2, 1), np.float32)))
    with ie.false_block():
        ie.output(P.arr(np.zeros((2, 1), np.float32)))
    with pytest.raises(Exception, match="input"):
        ie()


def _rnn_classes(P, lengths):
    x = P.arr(np.arange(24, dtype=np.float32).reshape(3, 4, 2))

    def step(x_t, h):
        h = h * 0.5 + x_t
        return {"mem": [h], "out": [h, h * 2.0]}

    outs = []
    for rnn in (P.L.StaticRNN(), P.L.DynamicRNN(lengths=P.arr(lengths))):
        rnn.step_input(x)
        rnn.memory(init=P.arr(np.ones((3, 2), np.float32)))
        outs.append(rnn(step))
    return outs


def test_rnn_classes_match_jax_and_read_nothing_on_the_host():
    lengths = np.array([2, 4, 0], np.int32)
    want = _rnn_classes(JAX, lengths)
    with _NoHostReads():
        got = _rnn_classes(PORT, lengths)
    _same(got, want, TOL)
    # tests/test_control_flow_classes.py's two cases
    with _NoHostReads():
        rnn = tlayers.DynamicRNN(lengths=torch.tensor([2, 4]))
        rnn.step_input(torch.ones(2, 4, 1))
        rnn.memory(init=torch.zeros(2, 1))
        (out,) = rnn(lambda x_t, h: {"mem": [h + x_t], "out": [h + x_t]})
    np.testing.assert_array_equal(_np(out)[:, :, 0], [[1, 2, 0, 0],
                                                      [1, 2, 3, 4]])


# ---------------------------------------------------------------------------
# cond / case / switch_case: one branch, one host read
# ---------------------------------------------------------------------------
def _branches(P, calls):
    def fn(k):
        def f(*ops):
            calls.append(k)
            return P.arr(np.float32(k)) + sum(ops, P.arr(np.float32(0.0)))
        return f
    return fn


@BOTH
@pytest.mark.parametrize("pred", [True, False])
def test_cond_runs_one_branch(P, pred):
    calls = []
    fn = _branches(P, calls)
    tcf.reset_host_reads()
    out = P.cf.cond(P.arr(pred), fn(1), fn(2),
                    (P.arr(np.float32(0.5)),))
    assert float(out) == (1.5 if pred else 2.5)
    if P is PORT:
        assert calls == [1 if pred else 2] and tcf.host_reads() == 1


@BOTH
@pytest.mark.parametrize("preds,default,want", [
    ((False, True, True), True, 2), ((False, False, False), True, 9),
    ((False, False, True), False, 3), ((False, False, False), False, 3),
    ((True, False, False), False, 1)])
def test_case_first_true_predicate(P, preds, default, want):
    calls = []
    fn = _branches(P, calls)
    pairs = [(P.arr(p), fn(k + 1)) for k, p in enumerate(preds)]
    tcf.reset_host_reads()
    out = P.cf.case(pairs, default=fn(9) if default else None)
    assert float(out) == want
    if P is PORT:
        assert calls == [want] and tcf.host_reads() == 1


@BOTH
@pytest.mark.parametrize("index,dict_fns,default,want", [
    (3, True, False, 3), (7, True, False, 1), (7, True, True, 9),
    (5, True, True, 5), (1, False, False, 2), (9, False, False, 3),
    (-4, False, False, 1), (9, False, True, 9), (0, False, True, 1)])
def test_switch_case_dict_and_list(P, index, dict_fns, default, want):
    calls = []
    fn = _branches(P, calls)
    fns = {1: fn(1), 3: fn(3), 5: fn(5)} if dict_fns else \
        [fn(1), fn(2), fn(3)]
    tcf.reset_host_reads()
    out = P.cf.switch_case(P.arr(np.int32(index)), fns,
                           default=fn(9) if default else None)
    assert float(out) == want
    if P is PORT:
        assert calls == [want] and tcf.host_reads() == 1


@pytest.mark.parametrize("n", [0, 1, 5])
def test_while_loop_reads_once_per_iteration(n):
    def run(P):
        return P.cf.while_loop(
            lambda i, s: i < n, lambda i, s: [i + 1, s * 2.0 + i],
            [P.arr(np.int32(0)), P.arr(np.float32(1.0))])
    want = run(JAX)
    tcf.reset_host_reads()
    got = run(PORT)
    _same(got, want)
    assert tcf.host_reads() == n + 1


def _scans(P):
    rng = np.random.RandomState(3)
    xs = P.arr(rng.randn(5, 2, 3).astype(np.float32))
    xb = P.arr(rng.randn(2, 4, 3).astype(np.float32))
    h0 = P.arr(np.zeros((2, 3), np.float32))

    def f(c, x):
        c = c * 0.9 + x
        return c, (c * 2.0, c.sum(-1))

    def step(h, x):
        h = h * 0.5 + x
        return h, h + 1.0

    rb = P.RB(xb, P.arr(np.array([2, 0], np.int32)))
    return (P.cf.scan(f, h0, xs), P.cf.scan(f, h0, xs, reverse=True),
            P.cf.static_rnn(step, xb, h0), P.cf.dynamic_rnn(step, rb, h0))


def test_scans_match_jax_and_read_nothing_on_the_host():
    want = _scans(JAX)
    with _NoHostReads():
        got = _scans(PORT)
    _same(got, want, TOL)


# ---------------------------------------------------------------------------
# tensor arrays
# ---------------------------------------------------------------------------
def _arrays(P, lens):
    rng = np.random.RandomState(5)
    a = P.ta.create_array(4, (2,), **({"device": "cpu"} if P is PORT
                                      else {}))
    a = P.ta.array_write(a, P.arr(np.int32(0)), P.arr(np.ones(2, np.float32)))
    a = P.ta.array_write(a, P.arr(np.int32(2)),
                         P.arr(np.full(2, 3.0, np.float32)))
    data = rng.randn(len(lens), max(lens), 3).astype(np.float32)
    rb = P.RB(P.arr(data), P.arr(np.array(lens, np.int32)))
    steps, order, sl = P.ta.lod_tensor_to_array(rb)
    back = P.ta.array_to_lod_tensor(steps, order, sl)
    table = P.ta.lod_rank_table(rb)
    t, fr, restore = P.ta.split_lod_tensor(
        P.arr(data[:, 0]), P.arr(np.array(lens) % 2 == 0))
    return dict(
        read=P.ta.array_read(a, 2), length=P.ta.array_length(a),
        lod_length=P.ta.lod_array_length(a), stacked=a.stack(),
        as_tensor=P.ta.tensor_array_to_tensor(a, axis=1), n=len(a),
        steps=tuple(steps), order=order, sl=sl, back=back, table=table,
        max_len=P.ta.max_sequence_len(table),
        reordered=P.ta.reorder_lod_tensor_by_rank(rb, table),
        reset=P.ta.lod_reset(rb, [sum(lens) - 1, 1]),
        split=(t, fr, restore),
        merged=P.ta.merge_lod_tensor(t, fr, restore),
        shrunk=P.ta.shrink_rnn_memory(P.arr(data[:, 0]), table, 1))


@pytest.mark.parametrize("lens", [[3, 1, 4, 2], [2, 3, 3, 1, 3, 2]],
                         ids=["distinct", "tied"])
def test_tensor_arrays_match_jax(lens):
    got, want = _arrays(PORT, lens), _arrays(JAX, lens)
    assert sorted(got) == sorted(want)
    for k in want:
        if k in ("table", "n", "max_len"):
            assert got[k] == want[k], k
        else:
            _same(got[k], want[k], 0.0)


def test_tensor_array_functions_are_all_ported():
    assert sorted(tta.__all__) == sorted(jta.__all__)


# ---------------------------------------------------------------------------
# static control flow: tests/test_serialize.py's round trips, documents
# ---------------------------------------------------------------------------
def _build(P, fn):
    main, startup = P.pt.Program(), P.pt.Program()
    with P.pt.program_guard(main, startup), P.names.guard():
        out = fn(P)
    return main, startup, out


def _while_prog(P, limit=4, captured=False):
    L = P.L
    x = P.pt.data("x", shape=[3], append_batch_size=False)
    w = L.create_parameter([3], "float32", name="w_cap",
                           default_initializer=P.I.Constant(3.0)) \
        if captured else None
    i = L.fill_constant(shape=[1], dtype="int32", value=0)
    lim = L.fill_constant(shape=[1], dtype="int32", value=limit)

    def cond(i, v):
        return L.reduce_all(L.less_than(i, lim))

    def body(i, v):
        return [L.increment(i, value=1),
                L.elementwise_add(v, w) if captured else L.scale(v, 2.0)]

    return L.while_loop(cond, body, [i, x])


def _scan_prog(P):
    L = P.L
    seq = P.pt.data("seq", shape=[2, 5, 3], append_batch_size=False)
    h0 = P.pt.data("h0", shape=[-1, 3], append_batch_size=False)

    def step(h, x_t):
        nh = L.elementwise_add(h, x_t)
        return nh, L.scale(nh, scale=1.0)

    return L.static_rnn(step, seq, h0)


def _run(P, prog, startup, feed, fetch):
    exe, scope = P.Exe(), P.Scope()
    if P is JAX:
        with jpt.static.scope_guard(scope):
            exe.run(startup)
            return exe.run(prog, feed=feed, fetch_list=fetch)
    exe.run(startup, scope=scope)
    return exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)


@pytest.mark.parametrize("case", ["while", "while_captured", "scan"])
def test_static_control_flow_round_trips_like_jax(case):
    xval = np.array([1.0, -2.0, 0.5], np.float32)
    rng = np.random.RandomState(0)
    sv = rng.randn(2, 5, 3).astype(np.float32)
    if case == "scan":
        build, feed = _scan_prog, {"seq": sv, "h0": np.zeros((2, 3),
                                                             np.float32)}
        expect = [sv.sum(1), np.cumsum(sv, 1)]
    else:
        cap = case == "while_captured"
        build = (lambda P: _while_prog(P, 2, True)) if cap else _while_prog
        feed = {"x": xval}
        expect = [None, xval + 6.0 if cap else xval * 16.0]
    docs, outs = [], []
    for P, ser in ((PORT, tser), (JAX, jser)):
        main, startup, fetch = _build(P, build)
        doc = ser.program_to_dict(main)
        docs.append(doc)
        names = [v.name for v in fetch]
        got = _run(P, main, startup, feed, names)
        rt = ser.program_from_dict(doc)   # sub-programs ride the op attrs
        again = _run(P, rt, startup, feed, names)
        for g, a in zip(got, again):
            np.testing.assert_array_equal(g, a)
        outs.append(got)
    assert docs[0] == docs[1]
    for w, g, j in zip(expect, *outs):
        np.testing.assert_allclose(g, j, rtol=TOL, atol=TOL)
        if w is not None:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_saved_while_model_runs_in_a_fresh_port_interpreter(tmp_path):
    """A control-flow model saved by the JAX package loads and runs in a
    process that imported only the port and never built a program."""
    d = str(tmp_path / "wm")
    main, startup, (_, v_out) = _build(JAX, lambda P: _while_prog(P, 3))
    exe, scope = jpt.static.Executor(), jpt.static.Scope()
    with jpt.static.scope_guard(scope):
        exe.run(startup)
        jpt.static.io.save_inference_model(d, ["x"], [v_out], exe,
                                           main_program=main)
    code = f"""
import sys
import numpy as np
import paddle_tpu_torch as pt
exe = pt.Executor(pt.CPUPlace())
prog, feeds, fetches = pt.io.load_inference_model({d!r}, exe)
out = exe.run(prog, feed={{"x": np.ones(3, np.float32)}},
              fetch_list=fetches)[0]
np.testing.assert_allclose(out, np.full(3, 8.0, np.float32))
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "paddle_tpu")]
print("FRESH_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert "FRESH_OK" in r.stdout, (r.stdout, r.stderr)


@BOTH
def test_an_op_that_draws_inside_a_body_is_refused(P):
    def build(P):
        seq = P.pt.data("seq", shape=[2, 5, 3], append_batch_size=False)
        h0 = P.pt.data("h0", shape=[2, 3], append_batch_size=False)

        def step(h, x_t):
            nh = P.L.elementwise_add(h, P.L.dropout(x_t, 0.5))
            return nh, nh
        return P.L.static_rnn(step, seq, h0)
    with pytest.raises(Exception, match="rng op 'dropout' inside a "
                                        "control-flow body"):
        _build(P, build)


def _train_through_while(P):
    L = P.L
    x = P.pt.data("x", shape=[2, 3], append_batch_size=False)
    w = L.create_parameter([3, 3], "float32", name="ww",
                           default_initializer=P.I.Constant(0.5))
    i = L.fill_constant(shape=[1], dtype="int32", value=0)
    lim = L.fill_constant(shape=[1], dtype="int32", value=2)
    _, h = L.while_loop(lambda i, h: L.reduce_all(L.less_than(i, lim)),
                        lambda i, h: [L.increment(i, value=1),
                                      L.tanh(L.matmul(h, w))], [i, x])
    loss = L.reduce_mean(h)
    P.pt.optimizer.SGDOptimizer(0.1).minimize(loss)
    return loss


@BOTH
def test_training_through_a_while_block_is_refused(P):
    main, startup, loss = _build(P, _train_through_while)
    feed = {"x": np.ones((2, 3), np.float32)}
    with pytest.raises(Exception, match="(?i)reverse-mode differentiation "
                                        "does not work"):
        _run(P, main, startup, feed, [loss.name])


def _scan_grad_prog(P):
    L = P.L
    seq = P.pt.data("seq", shape=[2, 4, 3], append_batch_size=False)
    h0 = P.pt.data("h0", shape=[2, 3], append_batch_size=False)
    w = L.create_parameter([6, 3], "float32", name="sw",
                           default_initializer=P.I.Uniform(-0.5, 0.5))

    def step(h, x_t):
        nh = L.tanh(L.matmul(L.concat([h, x_t], axis=1), w))
        return nh, nh

    final, outs = L.static_rnn(step, seq, h0)
    loss = L.reduce_mean(L.elementwise_add(L.reduce_sum(outs, dim=1),
                                           final))
    P.pt.optimizer.SGDOptimizer(0.1).minimize(loss)
    return loss


def test_scan_block_gradients_match_jax():
    rng = np.random.RandomState(7)
    feed = {"seq": rng.randn(2, 4, 3).astype(np.float32),
            "h0": rng.randn(2, 3).astype(np.float32)}
    jmain, jstart, jloss = _build(JAX, _scan_grad_prog)
    tmain, tstart, tloss = _build(PORT, _scan_grad_prog)
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    jscope = jpt.static.Scope()
    jexe = jpt.static.Executor()
    jexe.run(jstart, scope=jscope)
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in ("sw",
                                                   "@opt@SGDOptimizer@step")},
        "cpu", tstart)
    texe = tpt.Executor(tpt.CPUPlace())
    for _ in range(3):
        jl, jg = jexe.run(jmain, feed=feed, fetch_list=[jloss, "sw@GRAD"],
                          scope=jscope)
        tl, tg = texe.run(tmain, feed=feed, fetch_list=[tloss, "sw@GRAD"],
                          scope=tscope)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tscope.find_var("sw").numpy(),
                               np.array(jscope.find_var("sw")),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# backward, the debugger, prepare
# ---------------------------------------------------------------------------
def _toy(P, grads=False):
    x = P.pt.data("x", shape=[4], dtype="float32")
    y = P.pt.data("y", shape=[1], dtype="float32")
    pred = P.L.fc(x, size=1)
    loss = P.L.mean(P.L.square_error_cost(pred, y))
    if grads:
        return loss, P.backward.calc_gradient([loss], ["fc_w", "fc_b"])
    P.pt.optimizer.SGDOptimizer(0.1).minimize(loss)
    return loss


def test_backward_gradients_match_jax():
    assert tbackward.GRAD_SUFFIX == jbackward.GRAD_SUFFIX == "@GRAD"
    assert sorted(tbackward.__all__) == sorted(jbackward.__all__)
    assert tbackward.calc_gradient is tbackward.gradients
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(5, 4).astype(np.float32),
            "y": rng.randn(5, 1).astype(np.float32)}
    jmain, jstart, (jl, jg) = _build(JAX, lambda P: _toy(P, True))
    tmain, tstart, (tl, tg) = _build(PORT, lambda P: _toy(P, True))
    assert [g.name for g in tg] == [g.name for g in jg] == \
        ["fc_w@GRAD", "fc_b@GRAD"]
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    jscope = jpt.static.Scope()
    jexe = jpt.static.Executor()
    jexe.run(jstart, scope=jscope)
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in ("fc_w", "fc_b")}, "cpu",
        tstart)
    names = ["fc_w@GRAD", "fc_b@GRAD"]
    want = jexe.run(jmain, feed=feed, fetch_list=names, scope=jscope)
    got = tpt.Executor(tpt.CPUPlace()).run(tmain, feed=feed,
                                           fetch_list=names, scope=tscope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def _jax_text(text):
    """The JAX package prints a var's dtype as its Python class
    (``<class 'jax.numpy.int64'>``, ``<class 'numpy.float32'>``, by where
    the var's dtype came from); the port prints the dtype's name. Compared
    with the class written as its name."""
    return re.sub(r"<class '(?:jax\.)?numpy\.(\w+)'>", r"\1", text)


def test_debugger_text_dot_and_memory_band_match_jax(tmp_path):
    tmain, _, _ = _build(PORT, _toy)
    jmain, _, _ = _build(JAX, _toy)
    text = tpt.static.pprint_program(tmain)
    assert text == _jax_text(jpt.static.pprint_program(jmain))
    assert "block 0" in text and "autodiff" in text and "param" in text
    p = tmp_path / "g.dot"
    dot = tpt.static.draw_graph(tmain, path=str(p))
    assert dot == jpt.static.draw_graph(jmain)
    assert p.read_text() == dot and "peripheries=2" in dot
    for bs in (1, 32, 64):
        band = tpt.static.memory_usage(tmain, batch_size=bs)
        assert band == jpt.static.memory_usage(jmain, batch_size=bs)
        assert 0 < band[0] < band[1]
    # the LM's dtypes: int64 data vars print by name in both
    lm_t, _, _ = _build(PORT, lambda P: P.pt.data("ids", [3], "int64"))
    lm_j, _, _ = _build(JAX, lambda P: P.pt.data("ids", [3], "int64"))
    assert tpt.static.pprint_program(lm_t) == \
        _jax_text(jpt.static.pprint_program(lm_j))


def test_prepare_takes_shape_specs_and_counts_runner_builds():
    """tests/test_executor_cache.py's contract: prepare() with (shape,
    dtype) pairs builds the runner once; the first run reuses it."""
    main, startup, loss = _build(PORT, _toy)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    with pytest.raises(EnforceNotMet, match="run the startup program"):
        exe.prepare(main, feed={"x": ((32, 4), np.float32)},
                    fetch_list=[loss], scope=scope)
    assert exe.trace_count == 0
    exe.run(startup, scope=scope)
    assert exe.prepare(main, feed={"x": ((32, 4), np.float32),
                                   "y": ((32, 1), "float32")},
                       fetch_list=[loss], scope=scope)
    assert exe.trace_count == 1
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(32, 4).astype(np.float32),
            "y": rng.randn(32, 1).astype(np.float32)}
    (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(lv) and exe.trace_count == 1
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe.trace_count == 1
    # another feed signature, another runner
    half = {k: v[:16] for k, v in feed.items()}
    exe.run(main, feed=half, fetch_list=[loss], scope=scope)
    assert exe.trace_count == 2
    (runner,) = [r for k, r in exe._runners.items() if k[2][0][1] == (32, 4)]
    assert runner.kernel_libraries == ["fused_matmul", "fused_sgd"]


def test_static_split_gives_one_variable_in_jax_and_every_part_in_the_port():
    """ROADMAP queue 3 note i: the JAX package's static ``split`` keeps
    one output, the first section; the port's gives every part
    (tests/test_torch_book.py relies on it). Programs whose documents are
    compared cut with ``slice``."""
    def build(P):
        y = P.pt.data("y", shape=[4, 6], append_batch_size=False)
        return P.L.split(y, 3, dim=1), P.L.slice(y, axes=[1], starts=[0],
                                                 ends=[2])
    _, _, (jparts, jslice) = _build(JAX, build)
    _, _, (tparts, tslice) = _build(PORT, build)
    assert jparts.shape == (4, 2) and not isinstance(jparts, (list, tuple))
    assert [p.shape for p in tparts] == [(4, 2)] * 3
    assert tslice.shape == jslice.shape == (4, 2)
