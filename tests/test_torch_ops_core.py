"""The port's four core op modules against the JAX package, on the CPU:
every public function of ``ops/math.py``, ``ops/tensor_ops.py``,
``ops/reduce.py`` and ``ops/activation.py``, one parametrised test per
module with one case per name (each name over float, integer, boolean and
broadcasting inputs where it takes them), then the ``layers`` wrappers of
those modules in a Program and ``Variable`` arithmetic (the JAX op lists).

Inputs come from numpy with a seed. Tolerances: the ops that move, select,
compare or count values, and integer arithmetic, are exact; the float ones
1e-6 relative and absolute (transcendental functions round differently in
XLA and ATen by an ulp or so). Dtypes are compared through
``jax.dtypes.canonicalize_dtype``: JAX without x64 holds int64 as int32,
where the port keeps the int64 the JAX source asks for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.ops import activation as jact
from paddle_tpu.ops import math as jmath
from paddle_tpu.ops import reduce as jreduce
from paddle_tpu.ops import tensor_ops as jtensor
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.ops import activation as tact
from paddle_tpu_torch.ops import math as tmath
from paddle_tpu_torch.ops import reduce as treduce
from paddle_tpu_torch.ops import tensor_ops as ttensor

TOL = 1e-6


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d)."""
    with static_mode_guard(False):
        yield


R = np.random.RandomState(14)


def f(*shape, lo=-2.0, hi=2.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def i(*shape, lo=-5, hi=6):
    return R.randint(lo, hi, shape).astype(np.int32)


def b(*shape):
    return R.rand(*shape) > 0.5


class C:
    """One call: positional and keyword arguments; numpy arrays (alone or
    in a list of arrays) become tensors of each package."""

    def __init__(self, *args, tol=TOL, **kw):
        self.args, self.kw, self.tol = args, kw, tol


def _conv(v, to):
    if isinstance(v, (np.ndarray, np.bool_)):
        return to(v)
    if isinstance(v, (list, tuple)) and v and all(
            isinstance(x, np.ndarray) for x in v):
        return type(v)(to(x) for x in v)
    return v


def _np(x):
    if isinstance(x, (tuple, list)):
        return tuple(_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, want, tol, where):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), where
        for g, w in zip(got, want):
            _close(g, w, tol, where)
        return
    assert got.shape == want.shape, (where, got.shape, want.shape)
    assert jax.dtypes.canonicalize_dtype(got.dtype) == want.dtype, \
        (where, got.dtype, want.dtype)
    if tol == 0 or not np.issubdtype(want.dtype, np.inexact):
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=where)


def _run(tmod, jmod, name, cases, port_kw=None):
    for k, c in enumerate(cases):
        want = getattr(jmod, name)(*[_conv(a, jnp.asarray) for a in c.args],
                                   **{n: _conv(v, jnp.asarray)
                                      for n, v in c.kw.items()})
        got = getattr(tmod, name)(*[_conv(a, torch.tensor) for a in c.args],
                                  **{n: _conv(v, torch.tensor)
                                     for n, v in c.kw.items()},
                                  **(port_kw or {}))
        _close(_np(got), _np(want), c.tol, f"{name} case {k}")


# ---------------------------------------------------------------------------
# ops/math.py
# ---------------------------------------------------------------------------
def _binary_cases(name):
    out = [C(f(3, 4), f(3, 4)), C(f(2, 3, 4), f(3), axis=1),
           C(f(2, 3, 4), f(4)), C(f(2, 3), np.float32(1.5))]
    if name in ("elementwise_pow",):
        return [C(f(3, 4, lo=0.5), f(3, 4)), C(i(3, 4, lo=0, hi=4),
                                                i(3, 4, lo=0, hi=3))]
    if name in ("elementwise_mod", "elementwise_floordiv"):
        return [C(f(3, 4), f(3, 4, lo=0.5)), C(i(3, 4), i(3, 4, lo=1)),
                C(i(3, 4), -i(3, 4, lo=1))]
    if name == "elementwise_div":
        return out[:2] + [C(i(3, 4), i(3, 4, lo=1))]
    return out + [C(i(3, 4), i(3, 4)), C(i(2, 3, 4), i(3), axis=1)]


MATH = {n: _binary_cases(n) for n in jmath.__all__
        if n.startswith("elementwise_")}
MATH.update(
    minus=[C(f(3, 4), f(3, 4)), C(i(3), i(3))],
    matmul=[C(f(3, 4), f(4, 5)), C(f(2, 3, 4), f(2, 4, 5)),
            C(f(4, 3), f(5, 4), transpose_x=True, transpose_y=True,
              alpha=0.5),
            C(f(4), f(4, 5)), C(f(3, 4), f(4)), C(f(2, 3, 4), f(4, 5))],
    mul=[C(f(3, 4), f(4, 5)), C(f(2, 3, 4), f(4, 5), x_num_col_dims=2),
         C(f(2, 3, 4), f(12, 5)), C(f(3, 4), f(2, 2, 5), y_num_col_dims=2)],
    bmm=[C(f(2, 3, 4), f(2, 4, 5))],
    dot=[C(f(3, 4), f(3, 4)), C(f(5), f(5))],
    scale=[C(f(3, 4), scale=2.0, bias=0.5),
           C(f(3, 4), scale=2.0, bias=0.5, bias_after_scale=False),
           C(i(3, 4), scale=3, bias=1), C(i(3, 4), scale=0.5)],
    sums=[C([f(3, 4), f(3, 4), f(3, 4)]), C([i(3), i(3)])],
    cumsum=[C(f(3, 4)), C(f(3, 4), axis=1), C(f(3, 4), axis=0,
                                               exclusive=True),
            C(f(3, 4), axis=1, reverse=True),
            C(f(3, 4), axis=1, exclusive=True, reverse=True),
            C(i(3, 4), axis=1)],
    clip=[C(f(3, 4), -0.5, 0.7), C(i(3, 4), -2, 3)],
    clip_by_norm=[C(f(3, 4), 1.0), C(f(3, 4, lo=-0.01, hi=0.01), 1.0)],
    cast=[C(f(3, 4), "int32"), C(f(3, 4), "int64"), C(i(3, 4), "float32"),
          C(b(3, 4), "int32"), C(i(3, 4), "bool"), C(f(3, 4), "float16")],
    increment=[C(f(3)), C(i(3), value=1), C(i(3)), C(f(3), value=2.5)],
    isfinite=[C(f(3, 4)), C(np.array([1.0, np.inf, 0.0], np.float32)),
              C(np.array([np.nan], np.float32)), C(i(3))],
    abs=[C(f(3, 4)), C(i(3, 4))],
    ceil=[C(f(3, 4)), C(i(3, 4))],
    floor=[C(f(3, 4)), C(i(3, 4))],
    round=[C(np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.4, 0.6], np.float32)),
           C(f(3, 4)), C(i(3))],
    exp=[C(f(3, 4)), C(i(3, 4))],
    log=[C(f(3, 4, lo=0.1)), C(i(3, lo=1))],
    sqrt=[C(f(3, 4, lo=0.0)), C(i(3, lo=0))],
    rsqrt=[C(f(3, 4, lo=0.1))],
    square=[C(f(3, 4)), C(i(3, 4))],
    reciprocal=[C(f(3, 4, lo=0.5)), C(i(3, lo=1))],
    sign=[C(np.array([-2.0, 0.0, 3.0], np.float32)), C(i(3, 4))],
    cos=[C(f(3, 4)), C(i(3))],
    sin=[C(f(3, 4)), C(i(3))],
    atan=[C(f(3, 4)), C(i(3))],
    acos=[C(f(3, 4, lo=-1.0, hi=1.0))],
    asin=[C(f(3, 4, lo=-1.0, hi=1.0))],
    pow=[C(f(3, 4, lo=0.1), 2.0), C(f(3, 4, lo=0.1), factor=0.5),
         C(i(3, 4), 2.0), C(i(3, 4), factor=2)],
    logical_and=[C(b(3, 4), b(3, 4)), C(b(3, 4), b(4))],
    logical_or=[C(b(3, 4), b(3, 4)), C(b(3, 4), b(4))],
    logical_xor=[C(b(3, 4), b(3, 4)), C(b(3, 4), b(4))],
    logical_not=[C(b(3, 4))],
)
for _n in ("equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal"):
    _x = i(3, 4, lo=-2, hi=3)
    MATH[_n] = [C(_x, i(3, 4, lo=-2, hi=3)), C(_x, i(4, lo=-2, hi=3)),
                C(_x.astype(np.float32), np.float32(0.5)),
                C(f(3, 4), f(3, 4)), C(_x, 1)]


def test_math_covers_every_public_function():
    assert sorted(MATH) == sorted(jmath.__all__) == sorted(tmath.__all__)


@pytest.mark.parametrize("name", sorted(MATH))
def test_math_op_matches_jax(name):
    _run(tmath, jmath, name, MATH[name])


# ---------------------------------------------------------------------------
# ops/reduce.py
# ---------------------------------------------------------------------------
def _reduce_cases(name):
    x = i(2, 3, 4, lo=-3, hi=4) if name != "reduce_prod" \
        else i(2, 3, 4, lo=-2, hi=3)
    if name in ("reduce_all", "reduce_any"):
        x = b(2, 3, 4)
        return [C(x), C(x, dim=1), C(x, dim=[0, 2], keep_dim=True),
                C(np.ones((2, 3), bool), dim=-1), C(i(2, 3), dim=0)]
    return [C(f(2, 3, 4)), C(f(2, 3, 4), dim=1),
            C(f(2, 3, 4), dim=[0, 2]), C(f(2, 3, 4), dim=-1, keep_dim=True),
            C(f(2, 3, 4), keep_dim=True), C(x), C(x, dim=[1, 2]),
            C(np.float32(2.5))]


REDUCE = {n: _reduce_cases(n) for n in jreduce.__all__
          if n.startswith("reduce_")}
REDUCE.update(
    mean=[C(f(3, 4)), C(i(3, 4))],
    squared_l2_norm=[C(f(3, 4)), C(i(3))],
    l1_norm=[C(f(3, 4)), C(i(3))],
    l2_normalize=[C(f(3, 4)), C(f(3, 4), axis=0),
                  C(np.zeros((2, 3), np.float32))],
    norm=[C(f(3, 4)), C(f(3, 4), axis=0, epsilon=1e-3)],
    mean_iou=[C(i(4, 5, lo=0, hi=3), i(4, 5, lo=0, hi=3), 3),
              C(np.array([0, 0, 1]), np.array([0, 0, 0]), 4)],
)


def test_reduce_covers_every_public_function():
    assert sorted(REDUCE) == sorted(jreduce.__all__) == \
        sorted(treduce.__all__)


@pytest.mark.parametrize("name", sorted(REDUCE))
def test_reduce_op_matches_jax(name):
    _run(treduce, jreduce, name, REDUCE[name])


# ---------------------------------------------------------------------------
# ops/activation.py
# ---------------------------------------------------------------------------
_WIDE = np.concatenate([f(3, 4, lo=-40.0, hi=40.0).ravel(),
                        np.array([0.0, -0.5, 0.5, 1.0, 6.0, 30.0, -30.0],
                                 np.float32)])
ACT = {n: [C(f(3, 4)), C(_WIDE)] for n in jact.__all__}
ACT.update(
    relu=[C(f(3, 4)), C(i(3, 4))],
    relu6=[C(_WIDE), C(_WIDE, threshold=3.0)],
    leaky_relu=[C(_WIDE), C(_WIDE, alpha=0.3)],
    prelu=[C(f(2, 3, 4), np.float32(0.25)),
           C(f(2, 3, 4, 4), f(3), mode="channel"),
           C(f(2, 3, 4), f(2, 3, 4), mode="element")],
    elu=[C(_WIDE), C(_WIDE, alpha=0.5)],
    gelu=[C(_WIDE), C(_WIDE, approximate=True)],
    hard_sigmoid=[C(_WIDE), C(_WIDE, slope=0.1, offset=0.2)],
    softshrink=[C(_WIDE), C(_WIDE, alpha=1.0)],
    hard_shrink=[C(_WIDE), C(_WIDE, threshold=1.0)],
    brelu=[C(_WIDE), C(_WIDE, t_min=-1.0, t_max=2.0)],
    soft_relu=[C(_WIDE), C(_WIDE, threshold=5.0)],
    stanh=[C(_WIDE), C(_WIDE, scale_a=1.0, scale_b=2.0)],
    swish=[C(_WIDE), C(_WIDE, beta=2.0)],
    hard_swish=[C(_WIDE), C(_WIDE, threshold=5.0, scale=4.0, offset=2.0)],
    thresholded_relu=[C(_WIDE), C(_WIDE, threshold=0.5)],
    maxout=[C(f(2, 6, 3, 3), 2), C(f(2, 6, 3, 3), 3), C(f(2, 3, 4), 2,
                                                       axis=2)],
    softmax=[C(f(3, 4)), C(f(2, 3, 4), axis=1), C(_WIDE)],
    log_softmax=[C(f(3, 4)), C(f(2, 3, 4), axis=1), C(_WIDE)],
)


def test_activation_covers_every_public_function():
    assert sorted(ACT) == sorted(jact.__all__) == sorted(tact.__all__)


@pytest.mark.parametrize("name", sorted(ACT))
def test_activation_op_matches_jax(name):
    _run(tact, jact, name, ACT[name])


# ---------------------------------------------------------------------------
# ops/tensor_ops.py
# ---------------------------------------------------------------------------
_TIES = np.array([[3.0, 1.0, 3.0, 2.0, 1.0], [0.0, 0.0, 5.0, 5.0, 0.0]],
                 np.float32)
TENSOR = dict(
    concat=[C([f(2, 3), f(1, 3)]), C([i(2, 3), i(2, 2)], axis=1),
            C([f(2, 3), f(2, 3)], axis=-1)],
    split=[C(f(4, 6), 3, dim=1), C(f(4, 6), [1, 2, 3]), C(f(4, 6), 2, dim=0),
           C(i(4, 6), [2, 2, 9], dim=1)],
    stack=[C([f(2, 3), f(2, 3)]), C([i(2, 3), i(2, 3), i(2, 3)], axis=2)],
    unstack=[C(f(2, 3)), C(f(2, 3, 4), axis=1), C(i(3, 2), axis=-1)],
    squeeze=[C(f(1, 3, 1)), C(f(1, 3, 1), [0]), C(f(1, 3, 1), [1, 2]),
             C(f(2, 3), [0])],
    unsqueeze=[C(f(2, 3), 0), C(f(2, 3), [0, 3]), C(i(2), [-1])],
    reshape=[C(f(2, 3, 4), [6, 4]), C(f(2, 3, 4), [0, -1]),
             C(i(2, 3, 4), [4, 0, 2])],
    flatten=[C(f(2, 3, 4)), C(f(2, 3, 4), axis=2), C(f(2, 3, 4), axis=0)],
    transpose=[C(f(2, 3, 4), [2, 0, 1]), C(i(2, 3), [1, 0])],
    slice=[C(f(5, 6), [0], [1], [3]), C(f(5, 6), [0, 1], [-3, 2], [-1, 100]),
           C(f(5, 6), [1], [-100], [4]), C(i(5, 6), [1], [4], [2])],
    strided_slice=[C(f(6, 7), [0], [0], [6], [2]),
                   C(f(6, 7), [1], [6], [0], [-2]),
                   C(f(6, 7), [0, 1], [1, -1], [5, -7], [1, -1])],
    gather=[C(f(5, 3), np.array([0, 4, 2, 2])),
            C(f(5, 3), np.array([[1], [3]])), C(i(5), np.array([4, 0]))],
    gather_nd=[C(f(4, 5, 2), np.array([[0, 1], [3, 4]])),
               C(f(4, 5), np.array([[[1], [2]]]))],
    scatter=[C(f(5, 3), np.array([1, 3]), f(2, 3)),
             C(f(5, 3), np.array([1, 3, 1]), f(3, 3), overwrite=False),
             C(i(5, 2), np.array([[0], [4]]), i(2, 2))],
    scatter_nd_add=[C(f(4, 3), np.array([[0], [2], [0]]), f(3, 3)),
                    C(f(4, 3), np.array([[0, 1], [0, 1]]), f(2))],
    expand=[C(f(2, 3), [2, 1]), C(i(1, 3), [3, 2])],
    expand_as=[C(f(1, 3), f(4, 3))],
    tile=[C(f(2, 3), [1, 2]), C(i(3), [2])],
    shape=[C(f(2, 3, 4))],
    size=[C(f(2, 3, 4)), C(np.zeros((0, 3), np.float32))],
    fill_constant=[C([2, 3], "float32", 1.5), C([3], "int32", 7),
                   C((2,), "int64", -1), C([2], "bool", True)],
    fill_constant_batch_size_like=[
        C(f(5, 2), [1, 3], "float32", 2.0),
        C(f(2, 5), [3, 1], "int32", 4, input_dim_idx=1, output_dim_idx=1)],
    zeros=[C([2, 3]), C([3], "int32")],
    ones=[C([2, 3]), C([3], "int64")],
    zeros_like=[C(f(2, 3)), C(i(3))],
    ones_like=[C(f(2, 3)), C(i(3))],
    full_like=[C(f(2, 3), 3.5), C(i(3), 2), C(f(2, 3), 1, dtype="int32")],
    assign=[C(f(2, 3)), C(i(4))],
    argmax=[C(f(3, 4)), C(f(3, 4), axis=1), C(_TIES, axis=1), C(i(5))],
    argmin=[C(f(3, 4)), C(f(3, 4), axis=1), C(_TIES, axis=1), C(i(5))],
    argsort=[C(f(3, 4)), C(_TIES), C(_TIES, descending=True),
             C(_TIES, axis=0), C(i(3, 4), descending=True)],
    topk=[C(f(3, 5), 2), C(_TIES, 3), C(i(2, 6), 4)],
    where=[C(b(3, 4), f(3, 4), f(3, 4)), C(b(3, 4), i(3, 4), i(4)),
           C(np.array([[True, False], [False, True]]))],
    where_index=[C(np.array([[True, False], [True, True]])), C(i(3, 2))],
    diag=[C(f(3)), C(i(4))],
    linspace=[C(0.0, 1.0, 5), C(-2.0, 3.0, 7, "float32"), C(1.0, 1.0, 1)],
    arange=[C(5), C(1, 7, 2), C(0.0, 1.0, 0.25), C(3, dtype="int32")],
    reverse=[C(f(3, 4), 0), C(f(3, 4), [0, 1]), C(i(5), [0])],
    flip=[C(f(3, 4), 1), C(i(2, 3), [1])],
    roll=[C(f(3, 4), 1), C(f(3, 4), 2, axis=1), C(i(5), -2, axis=0)],
    unique=[C(np.array([3, 1, 3, 2, 1])), C(np.array([[2, 2], [0, 5]]),
                                            dtype="int64")],
    unique_with_counts=[C(np.array([3, 1, 3, 2, 1])),
                        C(f(5).round(0), dtype="int64")],
    is_empty=[C(f(2, 3)), C(np.zeros((0, 3), np.float32))],
    has_inf=[C(f(3)), C(np.array([1.0, -np.inf], np.float32))],
    has_nan=[C(f(3)), C(np.array([np.nan, 1.0], np.float32))],
    rank=[C(f(2, 3, 4)), C(np.float32(1.0))],
    create_tensor=[C(), C("int32")],
    multiplex=[C([f(4, 3), f(4, 3), f(4, 3)], np.array([[2], [0], [1], [2]])),
               C([i(3, 2), i(3, 2)], np.array([1, 0, 1]))],
    crop=[C(f(4, 5), [2, 3]), C(f(4, 5), [2, 2], [1, 3])],
    meshgrid=[C(f(3), f(4)), C(i(2), f(3), i(2))],
    eye=[C(3), C(2, 4), C(3, dtype="int32")],
)
#: the functions that make a tensor from nothing: the port's ask for the
#: card unless given a device
_CREATION = {"fill_constant", "zeros", "ones", "linspace", "arange", "eye",
             "create_tensor"}


def test_tensor_ops_covers_every_public_function():
    assert sorted(TENSOR) == sorted(jtensor.__all__) == \
        sorted(ttensor.__all__)


@pytest.mark.parametrize("name", sorted(TENSOR))
def test_tensor_op_matches_jax(name):
    _run(ttensor, jtensor, name, TENSOR[name],
         {"device": "cpu"} if name in _CREATION else None)


def test_creation_ops_ask_for_the_card_outside_a_program(monkeypatch):
    """Outside a Program a tensor made from nothing goes to the card (no
    CPU fallback); while a Program is built it is a CPU constant."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in sorted(_CREATION):
        with pytest.raises(tpt.NoCudaDeviceError):
            getattr(ttensor, name)(*TENSOR[name][0].args)
    with tpt.program_guard(tpt.Program(), tpt.Program()):
        assert tpt.layers.fill_constant([2], "int32", 3).device.type == "cpu"


def test_ops_star_export_the_four_modules():
    for mod in (tmath, treduce, tact, ttensor):
        for n in mod.__all__:
            assert getattr(tops, n) is getattr(mod, n), n


# ---------------------------------------------------------------------------
# the layers wrappers in a Program, and Variable arithmetic
# ---------------------------------------------------------------------------
def _program(pk, build):
    main, startup = pk.Program(), pk.Program()
    names = tpt.unique_name if pk is tpt else junique
    with pk.program_guard(main, startup), names.guard():
        fetches = build(pk)
    return main, startup, fetches


def _ops_program(pk):
    L = pk.layers
    x = pk.data("x", [3, 4], "float32", append_batch_size=False)
    n = pk.data("n", [3, 4], "int64", append_batch_size=False)
    s = L.slice(x, axes=[1], starts=[1], ends=[3])
    g = L.gather(x, L.argmax(x, axis=0))
    m = L.reduce_mean(L.elementwise_div(x, L.exp(x)),
                      dim=1)
    c = L.cast(L.reduce_all(L.less_than(n, 3), dim=1), "float32")
    t = L.topk(x, 2)
    u = L.increment(L.reduce_sum(n), value=1)
    return [s, g, m, c, t[0], t[1], u, L.softplus(x), L.cumsum(n, axis=1)]


def test_layers_wrap_the_ops_in_a_program():
    feed = {"x": f(3, 4), "n": i(3, 4).astype(np.int64)}
    tmain, _, tf = _program(tpt, _ops_program)
    jmain, _, jf = _program(jpt, _ops_program)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    for tv, jv in zip(tf, jf):
        assert tv.shape == jv.shape, (tv, jv)
    got = tpt.Executor(tpt.CPUPlace()).run(tmain, feed=feed, fetch_list=tf,
                                           scope=tpt.Scope())
    with static_mode_guard(False):
        want = jpt.static.Executor().run(jmain, feed=feed, fetch_list=jf,
                                         scope=jpt.static.Scope())
    for k, (g, w) in enumerate(zip(got, want)):
        _close(np.asarray(g), np.asarray(w), TOL, f"fetch {k}")


def _arith_program(pk):
    x = pk.data("x", [2, 3], "float32", append_batch_size=False)
    y = pk.data("y", [2, 3], "float32", append_batch_size=False)
    return [x + y, x - y, x * y, x / y, (x - y) * 2.0 / y]


def test_variable_arithmetic_appends_the_jax_ops():
    feed = {"x": f(2, 3), "y": f(2, 3, lo=0.5)}
    tmain, _, tf = _program(tpt, _arith_program)
    jmain, _, jf = _program(jpt, _arith_program)
    types_ = [op.type for op in tmain.global_block().ops]
    assert types_ == [op.type for op in jmain.global_block().ops]
    assert types_[:4] == ["elementwise_add", "elementwise_sub",
                          "elementwise_mul", "elementwise_div"]
    got = tpt.Executor(tpt.CPUPlace()).run(tmain, feed=feed, fetch_list=tf,
                                           scope=tpt.Scope())
    x, y = feed["x"], feed["y"]
    for g, w in zip(got, [x + y, x - y, x * y, x / y, (x - y) * 2.0 / y]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def _sampled_program(pt, unique_name, samples):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        logits = pt.data("logits", [50], "float32")
        label = pt.data("label", [1], "int64")
        kw = ({} if samples is None else
              {"use_customized_samples": True, "customized_samples": samples})
        loss = pt.layers.mean(pt.layers.sampled_softmax_with_cross_entropy(
            logits, label, 5, **kw))
    return main, loss


def test_sampled_softmax_builds_and_draws_in_a_program():
    """F13: ``layers.sampled_softmax_with_cross_entropy`` builds in a
    Program (its shape inference makes no generator on the meta device) as
    an op that draws (``_needs_rng``), as in the JAX package. With
    customized samples the two packages' losses are equal; without, each
    run draws new negatives, and the port's losses over 20 runs of one feed
    lie within the JAX package's 20."""
    rng = np.random.RandomState(13)
    feed = {"logits": rng.randn(4, 50).astype(np.float32),
            "label": rng.randint(0, 50, (4, 1)).astype(np.int64)}
    samples = rng.randint(0, 50, 5).astype(np.int64)   # shared by the rows
    samples[0] = feed["label"][0, 0]           # an accidental hit
    losses = {}
    for fixed in (samples, None):
        tm, tl = _sampled_program(tpt, tpt.unique_name, fixed)
        jm, jl = _sampled_program(jpt, junique, fixed)
        (op,) = [o for o in tm.global_block().ops
                 if o.type == "sampled_softmax_with_cross_entropy"]
        assert op.attrs["_needs_rng"]
        assert list(tm.global_block().var(op.output_names()[0]).shape) == [
            -1, 1]
        texe, tscope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
        jexe, jscope = jpt.static.Executor(jpt.CPUPlace()), \
            jpt.static.Scope()
        n = 1 if fixed is not None else 20
        losses[fixed is None] = (
            [float(texe.run(tm, feed=feed, fetch_list=[tl],
                            scope=tscope)[0]) for _ in range(n)],
            [float(jexe.run(jm, feed=feed, fetch_list=[jl],
                            scope=jscope)[0]) for _ in range(n)])
    (t_fixed,), (j_fixed,) = losses[False]
    np.testing.assert_allclose(t_fixed, j_fixed, rtol=TOL, atol=TOL)
    t_drawn, j_drawn = losses[True]
    assert len(set(t_drawn)) > 10 and len(set(j_drawn)) > 10
    assert min(j_drawn) <= np.mean(t_drawn) <= max(j_drawn)
    assert min(t_drawn) <= np.mean(j_drawn) <= max(t_drawn)
