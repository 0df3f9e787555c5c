"""``ops/aliases.py``, ``layers``' own functions and the root and ``static``
surface (ROADMAP 5+4 steps 5-6) in the port against the JAX package, on the
CPU.

1. The five aliases: ``range``'s values and dtypes (int64 and float64
   requests canonicalised as JAX with x64 off gives them);
   ``alloc_continuous_space``'s buffer and views (here true views of the
   buffer); ``rnn_memory_helper``; ``delete_var`` on a Scope;
   ``beam_search_decode`` over the steps of ``ops.beam_search`` (the JAX
   package's own steps fed to both), with and without ``end_token``.
   Integers equal.
2. ``autoincreased_step_counter``: the documents equal the JAX package's,
   runs 1, 2 and 3 read 1, 2 and 3 (int32 values), a second call adds a
   second increment, a run with no feed moves it too.
3. ``Print``: the stderr lines of a Program's runs (``first_n`` honoured)
   and of an eager call equal the JAX package's, character for character.
4. ``py_func`` in a Program: the same outputs and dtypes as the JAX
   package's (a func's float64 comes back float32, int64 int32); its
   outputs carry no gradient, and a py_func in the differentiated region
   raises in both packages.
5. ``hsigmoid``: the documents (with int64 written int32, as JAX without
   x64 computes the label's reshape), the parameters and the loss of one
   Program (the JAX startup's weights carried over) within 1e-6; ``hash`` and
   ``continuous_value_model`` equal; ``create_global_var``,
   ``register_op_init_param`` and ``OP_REGISTRY``.
6. The step-6 names: the dtype constants, the place helpers, ``flags``,
   ``ExecutionStrategy``, ``name_scope``, ``static_mode_guard``,
   ``Scope.version`` over the same sequence of changes as the JAX Scope,
   ``in_dygraph_mode``.
"""

import re

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import ops as jops
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.static import serialize as jser
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.static import serialize as tser

TOL = 1e-6


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d)."""
    with static_mode_guard(False):
        yield


def _dt(v):
    return str(v.dtype).replace("torch.", "")


@pytest.mark.parametrize("args,kw", [
    ((10,), {}), ((2, 11, 3), {}), ((0, 5), {"dtype": "int32"}),
    ((0, 2, 0.25), {"dtype": "float64"}), ((1, 3, 0.5), {"dtype": "float32"}),
    ((0.0, 2.0, 0.5), {"dtype": "int64"}), ((5, 0, -1), {}),
])
def test_range_matches_jax(args, kw):
    want = np.asarray(jops.range(*args, **kw))
    got = tops.range(*args, **kw, device="cpu")
    assert _dt(got) == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_alloc_continuous_space_and_the_identities():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.arange(4, dtype=np.float32) + 10
    jflat, jviews = jops.alloc_continuous_space([a, b])
    flat, views = tops.alloc_continuous_space([torch.tensor(a),
                                               torch.tensor(b)])
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    for v, w in zip(views, jviews):
        np.testing.assert_array_equal(v.numpy(), np.asarray(w))
    # true views: a write through one shows in the buffer
    views[1][0] = -1.0
    assert flat[6] == -1.0 and views[0].shape == (2, 3)
    jflat, _ = jops.alloc_continuous_space([a, b], set_constant=0.5)
    flat, views = tops.alloc_continuous_space(
        [torch.tensor(a), torch.tensor(b)], set_constant=0.5)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    x = torch.randn(3, 4)
    assert torch.equal(tops.rnn_memory_helper(x), x)
    scope = tpt.Scope()
    for n in ("a", "b", "c"):
        scope.set_var(n, torch.zeros(1))
    tops.delete_var(scope, "a", "c", "missing")
    assert scope.names() == ["b"]
    assert tpt.layers.delete_var is tops.delete_var
    assert tpt.layers.alloc_continuous_space is tops.alloc_continuous_space


def _beam_steps(T=5, B=2, beam=3, V=7, end=1):
    """T steps of the JAX ``beam_search`` (stacked ids and parents)."""
    rng = np.random.RandomState(4)
    scores = np.zeros(B * beam, np.float32)
    scores[np.arange(B * beam) % beam != 0] = -1e9
    ids = np.zeros((B * beam, 1), np.int32)
    step_ids, step_parents = [], []
    for t in range(T):
        lp = np.log(rng.dirichlet(np.ones(V), B * beam)).astype(np.float32)
        lp[:, end] += 1.0 if t == 2 else 0.0
        ids, scores, parent = jops.beam_search(lp, scores, ids, beam,
                                               end_token=end)
        ids, scores = np.asarray(ids), np.asarray(scores)
        step_ids.append(ids[:, -1])
        step_parents.append(np.asarray(parent))
    return np.stack(step_ids), np.stack(step_parents)


@pytest.mark.parametrize("end_token", [None, 1])
def test_beam_search_decode_matches_jax(end_token):
    step_ids, step_parents = _beam_steps()
    want = np.asarray(jax.jit(lambda a, b: jops.beam_search_decode(
        a, b, end_token=end_token))(step_ids, step_parents))
    got = tops.beam_search_decode(torch.as_tensor(step_ids),
                                  torch.as_tensor(step_parents),
                                  end_token=end_token)
    assert _dt(got) == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    if end_token is not None:
        assert (got.numpy() == end_token).any()


# ---------------------------------------------------------------------------
# layers' own functions
# ---------------------------------------------------------------------------
def _counter_program(pt, unique_name, twice):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", [2], "float32")
        c = pt.layers.autoincreased_step_counter()
        if twice:
            pt.layers.autoincreased_step_counter()
        y = pt.layers.scale(x, 2.0)
    return main, startup, c, y


@pytest.mark.parametrize("twice", [False, True])
def test_step_counter_over_three_runs(twice):
    jm, js, jc, jy = _counter_program(jpt, junique, twice)
    tm, ts, tc, ty = _counter_program(tpt, tpt.unique_name, twice)
    for t, j in ((tm, jm), (ts, js)):
        assert tser.program_to_dict(t) == jser.program_to_dict(j)
    jscope, tscope = jpt.static.Scope(), tpt.Scope()
    jexe, texe = jpt.static.Executor(jpt.CPUPlace()), tpt.Executor(
        tpt.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    per_run = 2 if twice else 1
    feed = {"x": np.ones((1, 2), np.float32)}
    for run in (1, 2, 3):
        (want,) = jexe.run(jm, feed=feed, fetch_list=[jc], scope=jscope)
        (got,) = texe.run(tm, feed=feed, fetch_list=[tc], scope=tscope)
        assert got.dtype == np.asarray(want).dtype == np.int32
        assert got.tolist() == np.asarray(want).tolist() == [run * per_run]
    (got,) = texe.run(tm, fetch_list=[tc], scope=tscope)
    assert got.tolist() == [4 * per_run]


def _print_program(pt, unique_name):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", [3], "float32")
        p = pt.layers.Print(x, message="hello", summarize=4, first_n=2)
        y = pt.layers.scale(p, 2.0)
    return main, y


def test_print_writes_the_jax_lines(capfd):
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3) / 7}
    jm, jy = _print_program(jpt, junique)
    tm, ty = _print_program(tpt, tpt.unique_name)
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops] == ["print", "scale"]
    jexe, texe = jpt.static.Executor(jpt.CPUPlace()), tpt.Executor(
        tpt.CPUPlace())
    capfd.readouterr()
    for _ in range(3):
        (jo,) = jexe.run(jm, feed=feed, fetch_list=[jy],
                         scope=jpt.static.Scope())
    jax.effects_barrier()
    want = capfd.readouterr().err
    for _ in range(3):
        (to,) = texe.run(tm, feed=feed, fetch_list=[ty], scope=tpt.Scope())
    got = capfd.readouterr().err
    np.testing.assert_array_equal(to, np.asarray(jo))
    assert got == want and got.count("hello shape=(2, 3)") == 2
    big = np.arange(30, dtype=np.float32).reshape(5, 6) / 3
    jpt.layers.Print(big, message="m")
    want = capfd.readouterr().err
    tpt.layers.Print(torch.as_tensor(big), message="m")
    assert capfd.readouterr().err == want and want.startswith("m shape=")


def _py_func_program(pt, unique_name):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", [3], "float32")
        y = pt.layers.scale(x, 2.0)
        blk = main.global_block()
        o1 = blk.create_var(name="pyout", shape=[-1, 3], dtype="float32")
        o2 = blk.create_var(name="pyint", shape=[-1], dtype="int32")
        outs = pt.layers.py_func(
            lambda a: (np.asarray(a, np.float64) * 3,
                       np.arange(np.shape(a)[0])), y, [o1, o2])
    return main, [y] + outs


def test_py_func_in_a_program_and_its_dtypes():
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    jm, jf = _py_func_program(jpt, junique)
    tm, tf = _py_func_program(tpt, tpt.unique_name)
    op = tm.global_block().ops[-1]
    assert op.type == "py_func" and op.attrs["_host"] is True
    want = jpt.static.Executor(jpt.CPUPlace()).run(
        jm, feed=feed, fetch_list=jf, scope=jpt.static.Scope())
    got = tpt.Executor(tpt.CPUPlace()).run(tm, feed=feed, fetch_list=tf,
                                           scope=tpt.Scope())
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert [str(g.dtype) for g in got] == ["float32", "float32", "int32"]


def _py_func_in_grad(pt, unique_name):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", [3], "float32")
        h = pt.layers.fc(x, 3)
        o = main.global_block().create_var(name="o", shape=[-1, 3],
                                           dtype="float32")
        pt.layers.py_func(lambda a: a, h, o)
        loss = pt.layers.mean(pt.layers.fc(o, 1))
        pt.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_py_func_outputs_carry_no_gradient():
    x = torch.randn(2, 3, requires_grad=True)
    (y,) = tpt.layers.py_func(lambda a: [a * 2.0], x, [None])
    assert not y.requires_grad and torch.equal(y, x.detach() * 2.0)
    feed = {"x": np.ones((2, 3), np.float32)}
    for pt, un, err in ((jpt, junique, jpt.EnforceNotMet),
                        (tpt, tpt.unique_name, EnforceNotMet)):
        main, startup, loss = _py_func_in_grad(pt, un)
        exe = (pt.static.Executor(pt.CPUPlace()) if pt is jpt
               else pt.Executor(pt.CPUPlace()))
        scope = pt.static.Scope() if pt is jpt else pt.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(err, match="host boundary"):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


def _x64_off(doc):
    """A document with its int64 dtypes written int32: the JAX package
    without x64 computes int64 as int32 (the label's reshape)."""
    return eval(re.sub(r"'int64'", "'int32'", repr(doc)))  # noqa: S307


def _hsigmoid_program(pt, unique_name, bias):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", [5], "float32")
        label = pt.data("label", [1], "int64")
        out = pt.layers.hsigmoid(x, label, 6,
                                 bias_attr=None if bias else False)
        loss = pt.layers.mean(out)
    return main, startup, out, loss


@pytest.mark.parametrize("bias", [True, False])
def test_hsigmoid_parameters_and_loss(bias):
    jm, js, jo, jl = _hsigmoid_program(jpt, junique, bias)
    tm, ts, to, tl = _hsigmoid_program(tpt, tpt.unique_name, bias)
    for t, j in ((tm, jm), (ts, js)):
        assert _x64_off(tser.program_to_dict(t)) == \
            _x64_off(jser.program_to_dict(j))
    params = {n: tuple(v.shape) for n, v in tm.global_block().vars.items()
              if v.persistable}
    assert params == ({"hsigmoid_w": (5, 5), "hsigmoid_b": (5,)} if bias
                      else {"hsigmoid_w": (5, 5)})
    jscope = jpt.static.Scope()
    jpt.static.Executor(jpt.CPUPlace()).run(js, scope=jscope)
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in params}, "cpu", ts)
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(4, 5).astype(np.float32),
            "label": rng.randint(0, 6, (4, 1)).astype(np.int64)}
    want = jpt.static.Executor(jpt.CPUPlace()).run(
        jm, feed=feed, fetch_list=[jo, jl], scope=jscope)
    got = tpt.Executor(tpt.CPUPlace()).run(tm, feed=feed,
                                           fetch_list=[to, tl], scope=tscope)
    assert got[0].shape == (4, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
    with pytest.raises(NotImplementedError):
        tpt.layers.hsigmoid(torch.zeros(2, 5), torch.zeros(2, 1), 6,
                            is_custom=True)


def test_hash_and_continuous_value_model_match_jax():
    rng = np.random.RandomState(8)
    ids = rng.randint(-50, 1000, (6, 3)).astype(np.int32)
    want = np.asarray(jpt.layers.hash(ids, 97, num_hash=2))
    got = tpt.layers.hash(torch.as_tensor(ids), 97, num_hash=2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _dt(got) == str(want.dtype)
    x = np.abs(rng.randn(5, 6)).astype(np.float32)
    for use_cvm in (True, False):
        want = np.asarray(jpt.layers.continuous_value_model(
            x, use_cvm=use_cvm))
        got = tpt.layers.continuous_value_model(torch.as_tensor(x),
                                                use_cvm=use_cvm)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_global_var_and_the_registry():
    def build(pt, un):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), un.guard():
            g = pt.layers.create_global_var([2, 3], 0.5, name="gv")
        return main, startup, g
    jm, js, jg = build(jpt, junique)
    tm, ts, tg = build(tpt, tpt.unique_name)
    assert tser.program_to_dict(ts) == jser.program_to_dict(js)
    assert tg.persistable and not tg.trainable and tg.shape == (2, 3)
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(ts, scope=scope)
    assert torch.equal(scope.find_var("gv"), torch.full((2, 3), 0.5))
    from paddle_tpu_torch.static.program import OP_REGISTRY
    assert tpt.layers.OP_REGISTRY is OP_REGISTRY
    fn = OP_REGISTRY["init_param"]
    tpt.layers.register_op_init_param()
    assert OP_REGISTRY["init_param"] is fn
    for op in ("print", "py_func", "increment_inplace",
               "fake_quantize_dequantize_abs_max", "quantized_conv2d",
               "beam_search_decode", "range", "rnn_memory_helper"):
        assert op in OP_REGISTRY, op


# ---------------------------------------------------------------------------
# the root and static surface (5+4 step 6)
# ---------------------------------------------------------------------------
def test_root_dtypes_places_and_flags():
    for n in ("float32", "float64", "float16", "bfloat16", "int8", "int16",
              "int32", "int64", "uint8"):
        assert getattr(tpt, n) is getattr(torch, n)
        assert np.dtype(getattr(jpt, n)).name == n
    assert tpt.bool_ is torch.bool
    assert tpt.is_compiled_with_tpu() is False
    assert tpt.is_compiled_with_cuda() is (torch.version.cuda is not None)
    assert tpt.device_count() == torch.cuda.device_count()
    assert tpt.cpu_places(3) == [tpt.CPUPlace(i) for i in range(3)]
    assert tpt.cuda_places([0, 1]) == [tpt.CUDAPlace(0), tpt.CUDAPlace(1)]
    assert tpt.cuda_pinned_places(2) == [tpt.CUDAPinnedPlace(0),
                                         tpt.CUDAPinnedPlace(1)]
    assert tpt.CUDAPinnedPlace(0).device() == torch.device("cpu")
    assert isinstance(tpt.CUDAPlace(0), tpt.Place)
    with pytest.raises(EnforceNotMet, match="CUDAPlace"):
        tpt.TPUPlace(0)
    with pytest.raises(EnforceNotMet, match="cuda_places"):
        tpt.tpu_places()
    try:
        assert tpt.set_device("cpu") == tpt.CPUPlace(0)
        assert tpt.get_device() == tpt.CPUPlace(0)
        assert tpt.set_device("gpu:1") == tpt.CUDAPlace(1)
        with pytest.raises(EnforceNotMet):
            tpt.set_device("tpu")
    finally:
        from paddle_tpu_torch.core import place
        place._current["place"] = None
    if not torch.cuda.is_available():
        with pytest.raises(tpt.NoCudaDeviceError):
            tpt.default_place()
    assert tpt.flags.apply_ir_passes is tpt.get_flag("apply_ir_passes")
    with pytest.raises(AttributeError):
        tpt.flags.no_such_flag
    je, te = jpt.ExecutionStrategy(), tpt.ExecutionStrategy()
    assert vars(te) == vars(je)
    assert tpt.static.ExecutionStrategy is tpt.ExecutionStrategy


def test_static_guards_and_scope_version():
    assert tpt.in_dygraph_mode() and not tpt.static.in_static_mode()
    with tpt.static.static_mode_guard(True):
        assert not tpt.in_dygraph_mode()
        with tpt.static.static_mode_guard(False):
            assert tpt.in_dygraph_mode()
        assert tpt.static.in_static_mode()
    assert tpt.in_dygraph_mode()
    with tpt.static.name_scope("block1"):
        pass
    versions = []
    for scope in (jpt.static.Scope(), tpt.Scope()):
        seen = [scope.version]
        scope.var("a")
        scope.set_var("a", 1)
        scope.set_var("b", 2)
        seen.append(scope.version)
        scope.var("b")
        scope.set_var("b", 3)
        seen.append(scope.version)
        scope.drop_var("a")
        scope.drop_var("a")
        seen.append(scope.version)
        versions.append(seen)
    assert versions[0] == versions[1] == [0, 2, 2, 3]
