"""``ops/quantize.py`` and its ``layers`` wrappers in the port against the
JAX package, on the CPU.

1. Every function of ``ops/quantize.py`` (the 14 names), one parametrised
   case per call, against ``jax.jit`` of the JAX function (the JAX
   package's programs run jitted; numbers given as Python values are
   constants there, and a division by one is a product with its fp32
   reciprocal, as the port computes it): the quantized values and scales
   equal, bit for bit; a dequantized value with no rounding after it
   within 2 ulps (XLA folds ``q * scale / bins`` with a Python scale into
   one product by ``scale * (1 / bins)``); the states within 1e-6 of their
   value (XLA may contract ``accum * rate + cur * (1 - rate)`` into an
   FMA).
2. The input gradients of every float input under a seeded cotangent,
   against ``jax.jit`` of ``jax.vjp``: within 1e-5 of the largest (the
   abs-max scale's gradient sums over every element, in another order in
   XLA and ATen); the tie case of the abs-max scale exactly as JAX splits
   it: at x = [0.3, -1.0, 0.77, 1.0, 0.1] and weights 1..5 the gradient of
   ``fake_quantize_dequantize_abs_max`` is [1, 1.992, 3, 4.008, 5].
3. ``quantized_mul`` and ``quantized_conv2d`` bit for bit against JAX's
   int32 accumulation, at K = 4608 too (3x3x512, past the 1032 where fp32
   sums stop being exact), depthwise (``groups``), strided, dilated,
   "SAME" and NHWC; ``quantize_linear``'s clip and storage dtypes.
4. The wrappers in a Program: the quantizers give 2 or 4 Variables, and a
   list of Variables in an attribute position (``fake_channel_wise_
   dequantize_max_abs(x, scales=[w_scale, 0.5])``) is flattened into the
   op's inputs with ``("scales", 2)`` in ``_tensor_params``: the documents
   equal the JAX package's and one run gives the same outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import ops as jops
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import ops as tops

GRAD_TOL = 1e-5
STATE_TOL = 1e-6


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d)."""
    with static_mode_guard(False):
        yield


R = np.random.RandomState(18)


def f(*shape, lo=-2.0, hi=2.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def q8(*shape):
    return R.randint(-127, 128, shape).astype(np.int8)


ACT = np.maximum(f(2, 8, 6, 6), 0)
W4 = f(6, 8, 3, 3)
#: (name, array args, keyword args, the outputs' kinds: "q" quantized or
#: integer values, "s" a scale, "d" dequantized values, "state" a running
#: state)
DEQ_RTOL = 2.4e-7
CASES = [
    ("fake_quantize_abs_max", [ACT], {}, "qs"),
    ("fake_quantize_abs_max", [f(40)], {"bit_length": 4}, "qs"),
    ("fake_quantize_dequantize_abs_max", [ACT], {}, "qs"),
    ("fake_quantize_dequantize_abs_max", [W4], {"bit_length": 6}, "qs"),
    ("fake_channel_wise_quantize_abs_max", [W4], {}, "qs"),
    ("fake_channel_wise_quantize_abs_max", [f(5, 7)], {"quant_axis": 1},
     "qs"),
    ("fake_channel_wise_quantize_dequantize_abs_max", [W4], {}, "qs"),
    ("fake_channel_wise_quantize_dequantize_abs_max", [f(9)], {}, "qs"),
    ("fake_quantize_range_abs_max", [ACT, np.float32(1.5), np.int32(20)],
     {"window_size": 10}, "qs"),
    ("fake_quantize_range_abs_max", [ACT, np.float32(9.0), np.int32(3)],
     {"window_size": 10}, "qs"),
    ("fake_quantize_range_abs_max", [ACT, np.float32(1.25), np.int32(3)],
     {"is_test": True}, "qs"),
    ("moving_average_abs_max_scale", [ACT, np.float32(1.2), np.float32(0.5)],
     {}, ["state"] * 3),
    ("fake_quantize_moving_average_abs_max",
     [ACT, np.float32(1.2), np.float32(0.5)], {}, ["q"] + ["state"] * 3),
    ("fake_quantize_moving_average_abs_max",
     [ACT, np.float32(1.2), np.float32(0.5)], {"is_test": True},
     ["q"] + ["state"] * 3),
    ("fake_quantize_dequantize_moving_average_abs_max",
     [ACT, np.float32(1.2), np.float32(0.5)], {"moving_rate": 0.8},
     ["q"] + ["state"] * 3),
    ("fake_quantize_dequantize_moving_average_abs_max",
     [ACT, np.float32(2.0), np.float32(0.9)], {"is_test": True},
     ["q"] + ["state"] * 3),
    ("fake_dequantize_max_abs", [q8(6, 5).astype(np.float32),
                                 np.float32(0.7)], {"max_range": 127}, "d"),
    ("fake_channel_wise_dequantize_max_abs", [q8(6, 5).astype(np.float32)],
     {"scales": [np.abs(f(6)) + 0.1]}, "d"),
    ("fake_channel_wise_dequantize_max_abs", [q8(6, 5).astype(np.float32)],
     {"scales": [np.abs(f(5)) + 0.1, 0.8], "quant_bits": (8, 8),
      "quant_axis": 1}, "d"),
    ("quantize_linear", [ACT], {"scale": 1.7}, "q"),
    ("quantize_linear", [f(50, lo=-4, hi=4)], {"scale": 1.0}, "q"),
    ("quantize_linear", [f(50)], {"scale": 1.3, "bit_length": 12}, "q"),
    ("quantize_linear", [f(50)], {"scale": 1.3, "bit_length": 20}, "q"),
    ("dequantize_linear", [q8(6, 5)], {"scale": 1.7}, "d"),
    ("quantized_mul", [f(6, 40), q8(40, 7)],
     {"x_scale": 2.0, "w_scale": 0.3}, "q"),
    ("quantized_mul", [f(2, 3, 4608), q8(4608, 5)],
     {"x_scale": 2.0, "w_scale": 0.3, "x_num_col_dims": 2}, "q"),
    ("quantized_mul", [f(6, 40), R.randint(-7, 8, (40, 7)).astype(np.int8)],
     {"x_scale": 1.5, "w_scale": 0.3, "w_bit_length": 4}, "q"),
    ("quantized_conv2d", [ACT, q8(4, 8, 3, 3)],
     {"x_scale": 2.0, "w_scale": 0.3, "padding": 1}, "q"),
    ("quantized_conv2d", [np.maximum(f(1, 512, 5, 5), 0), q8(3, 512, 3, 3)],
     {"x_scale": 2.0, "w_scale": 0.3}, "q"),
    ("quantized_conv2d", [ACT, q8(8, 1, 3, 3)],
     {"x_scale": 2.0, "w_scale": 0.3, "stride": 2, "padding": 1,
      "groups": 8}, "q"),
    ("quantized_conv2d", [ACT, q8(4, 4, 3, 3)],
     {"x_scale": 2.0, "w_scale": 0.3, "padding": "SAME", "dilation": 2,
      "groups": 2}, "q"),
    ("quantized_conv2d", [np.transpose(ACT, (0, 2, 3, 1)).copy(),
                          q8(4, 8, 1, 1)],
     {"x_scale": 2.0, "w_scale": 0.3, "data_format": "NHWC",
      "padding": "VALID"}, "q"),
]


def _ids():
    seen = {}
    out = []
    for c in CASES:
        seen[c[0]] = seen.get(c[0], 0) + 1
        out.append(f"{c[0]}-{seen[c[0]]}")
    return out


def _jit(name, args, kw):
    fn = getattr(jops, name)
    return jax.jit(lambda *a: fn(*a, **kw))(*[jnp.asarray(a) for a in args])


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _dtype(v):
    return str(v.dtype).replace("torch.", "")


@pytest.mark.parametrize("case", CASES, ids=_ids())
def test_op_matches_jax(case):
    name, args, kw, kinds = case
    want = _as_list(_jit(name, args, kw))
    got = _as_list(getattr(tops, name)(*[torch.as_tensor(a) for a in args],
                                       **kw))
    assert len(got) == len(want) == len(kinds)
    for g, w, kind in zip(got, want, kinds):
        w = np.asarray(w)
        g = torch.as_tensor(g)
        assert tuple(g.shape) == w.shape, name
        assert _dtype(g) == str(w.dtype), (name, g.dtype, w.dtype)
        if kind in ("state", "d"):
            np.testing.assert_allclose(
                g.numpy(), w, rtol=STATE_TOL if kind == "state" else DEQ_RTOL,
                atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def _float_positions(args):
    return [i for i, a in enumerate(args)
            if np.asarray(a).dtype == np.float32]


_DIFF = [(i, c) for i, c in zip(_ids(), CASES)
         if not c[0].startswith(("quantize_linear", "dequantize_linear",
                                 "quantized_"))]


@pytest.mark.parametrize("case", [c for _, c in _DIFF],
                         ids=[i for i, _ in _DIFF])
def test_input_gradients_match_jax(case):
    """The gradient of every float input under seeded cotangents on the
    float outputs, against ``jax.jit(jax.vjp)``."""
    name, args, kw, _ = case
    pos = _float_positions(args)
    jfn = getattr(jops, name)

    def jf(*fl):
        a = list(args)
        for i, v in zip(pos, fl):
            a[i] = v
        return [o for o in _as_list(jfn(*a, **kw))
                if jnp.issubdtype(jnp.asarray(o).dtype, jnp.floating)]
    rs = np.random.RandomState(5)
    outs = jax.jit(jf)(*[jnp.asarray(args[i]) for i in pos])
    cots = [np.asarray(rs.randn(*np.shape(o)), np.float32) for o in outs]
    want = jax.jit(lambda *fl: jax.vjp(jf, *fl)[1](
        [jnp.asarray(c) for c in cots]))(*[jnp.asarray(args[i]) for i in pos])
    xs = [torch.as_tensor(a) for a in args]
    leaves = [xs[i].requires_grad_() for i in pos]
    got = [o for o in _as_list(getattr(tops, name)(*xs, **kw))
           if isinstance(o, torch.Tensor) and o.is_floating_point()]
    grads = torch.autograd.grad(
        [o for o in got if o.requires_grad],
        leaves, [torch.as_tensor(c) for c, o in zip(cots, got)
                 if o.requires_grad], allow_unused=True)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=name)


def test_abs_max_ties_split_the_scale_gradient_as_jax():
    x = np.array([0.3, -1.0, 0.77, 1.0, 0.1], np.float32)
    wts = np.arange(1, 6, dtype=np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(
        jops.fake_quantize_dequantize_abs_max(v)[0] * wts)))(x))
    xt = torch.tensor(x, requires_grad=True)
    (tops.fake_quantize_dequantize_abs_max(xt)[0]
     * torch.as_tensor(wts)).sum().backward()
    np.testing.assert_allclose(want, [1, 1.992, 3, 4.008, 5], atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=1e-6)
    # the floor of the scale at 0: a zero input quantizes to zeros and its
    # gradient passes straight through
    z = torch.zeros(4, requires_grad=True)
    out, scale = tops.fake_quantize_dequantize_abs_max(z)
    out.sum().backward()
    assert float(scale.detach()) == 0.0 and torch.equal(out, torch.zeros(4))
    jz = np.asarray(jax.grad(lambda v: jnp.sum(
        jops.fake_quantize_dequantize_abs_max(v)[0]))(np.zeros(4,
                                                           np.float32)))
    np.testing.assert_array_equal(z.grad.numpy(), jz)


def test_quantize_linear_clips_and_stores_by_bit_length():
    x = torch.tensor([-3.0, -1.0, -0.5, 0.25, 1.0, 9.0])
    q = tops.quantize_linear(x, 1.0)
    assert q.dtype == torch.int8 and q.tolist() == [-128, -127, -64, 32, 127,
                                                    127]
    assert tops.quantize_linear(x, 1.0, bit_length=16).dtype == torch.int16
    assert tops.quantize_linear(x, 1.0, bit_length=24).dtype == torch.int32
    # round half to even, as jnp.round
    assert tops.quantize_linear(torch.tensor([0.5, 1.5, 2.5]) / 127.0 * 1.0,
                                1.0).tolist() == np.asarray(
        jops.quantize_linear(np.array([0.5, 1.5, 2.5], np.float32) / 127.0,
                             1.0)).tolist()


def test_integer_products_are_exact_past_fp32():
    """K = 4608 all at +-127 x +-127: an fp32 sum of the products would
    round (|acc| past 2^24); the port's and JAX's int32 sums are exact."""
    x = np.full((2, 4608), 1.0, np.float32)
    w = np.full((4608, 3), 127, np.int8)
    w[::2, 1] = -127
    got = tops.quantized_mul(torch.as_tensor(x), torch.as_tensor(w), 1.0,
                             1.0)
    want = np.asarray(jax.jit(lambda a, b: jops.quantized_mul(
        a, b, 1.0, 1.0))(x, w))
    np.testing.assert_array_equal(got.numpy(), want)
    acc = 127 * 127 * 4608
    assert acc > 2 ** 24
    np.testing.assert_array_equal(
        got.numpy()[0], (np.array([acc, 0, acc], np.float32)
                         * np.float32(1.0 / (127 * 127))))


# ---------------------------------------------------------------------------
# the wrappers in a Program
# ---------------------------------------------------------------------------
def _quant_program(pt, unique_name):
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", [4, 6], "float32")
        ws = pt.data("w_scale", [4], "float32", append_batch_size=False)
        qd, scale = L.fake_quantize_dequantize_abs_max(x)
        out4 = L.fake_quantize_dequantize_moving_average_abs_max(
            x, np.float32(1.0), np.float32(1.0), moving_rate=0.5)
        chan, cscale = L.fake_channel_wise_quantize_abs_max(qd,
                                                            quant_axis=1)
        deq = L.fake_channel_wise_dequantize_max_abs(
            chan, scales=[ws, 0.5], quant_bits=(8, 8), quant_axis=1)
        ql = L.quantize_linear(x, np.float32(1.5))
    fetch = [qd, scale, *out4, chan, cscale, deq, ql]
    return main, fetch


def _doc(pt_ser, program):
    return pt_ser.program_to_dict(program)


def test_wrappers_and_a_list_of_variables_in_a_program():
    from paddle_tpu.static import serialize as jser
    from paddle_tpu_torch.static import serialize as tser
    jm, jf = _quant_program(jpt, junique)
    tm, tf = _quant_program(tpt, tpt.unique_name)
    assert len(tf) == len(jf) == 10
    assert _doc(tser, tm) == _doc(jser, jm)
    op = next(o for o in tm.global_block().ops
              if o.type == "fake_channel_wise_dequantize_max_abs")
    assert op.attrs["_tensor_params"] == ("x", ("scales", 2))
    assert len(op.inputs["X"]) == 3
    feed = {"x": f(3, 4, 6), "w_scale": np.abs(f(4)) + 0.5}
    want = jpt.static.Executor(jpt.CPUPlace()).run(
        jm, feed=feed, fetch_list=jf, scope=jpt.static.Scope())
    got = tpt.Executor(tpt.CPUPlace()).run(tm, feed=feed, fetch_list=tf,
                                           scope=tpt.Scope())
    for g, w, v in zip(got, want, tf):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, v.name
        np.testing.assert_allclose(g, w, rtol=STATE_TOL, atol=0,
                                   err_msg=v.name)
