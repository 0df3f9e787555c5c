"""The rest of ``ops/nn.py``, its ``layers`` wrappers and the rest of
``initializer.py`` in the port against the JAX package, on the CPU.

1. Every function of ``ops/nn.py`` this slice ports, one parametrised case
   per call (layouts, strides, groups, dilations, padding modes, the
   divisible and the windowed adaptive paths): the value and the gradient
   of every float input under a seeded cotangent, against ``jax.jit`` of
   the JAX function and of its ``jax.vjp``. fp32 throughout; tolerance
   1e-5 of the largest magnitude (convolutions and reductions sum in
   another order in XLA and ATen; the norms' two-pass variance is the JAX
   arithmetic, so they hold to the same bound).
2. The traps of the JAX arithmetic, each against the JAX package and
   against the PyTorch function it is not: ties in adaptive max pooling,
   ``lrn``'s undivided ``alpha``, ``space_to_depth``'s channel order,
   ``one_hot``'s zero rows, ``pool3d``'s whole-window average,
   ``sync_batch_norm`` on one replica.
3. The ``layers`` wrappers (the parameterized ``conv2d_transpose``,
   ``conv3d``, ``conv3d_transpose``, ``layer_norm``, ``group_norm`` and the
   op layers) in a Program built by one builder over each package: the
   startup and main documents equal, then one run from the JAX startup's
   weights, every output and every parameter's gradient within 1e-5.
4. ``TruncatedNormal`` by its range and moments (the draws are torch's),
   ``Bilinear`` and ``NumpyArrayInitializer`` value for value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as jpt
from paddle_tpu import initializer as jinit
from paddle_tpu import ops as jops
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import initializer as tinit
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.core.enforce import EnforceNotMet

TOL = 1e-5


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d)."""
    with static_mode_guard(False):
        yield


R = np.random.RandomState(16)


def f(*shape, lo=-2.0, hi=2.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def _ints(*shape, lo=-2, hi=7):
    return R.randint(lo, hi, shape).astype(np.int32)


#: (op, args, keyword args); float32 array args are differentiated
CASES = [
    ("depthwise_conv2d", (f(2, 3, 8, 8), f(3, 1, 3, 3)),
     dict(stride=1, padding=1)),
    ("depthwise_conv2d", (f(2, 7, 7, 4), f(4, 1, 3, 3)),
     dict(stride=2, padding="SAME", data_format="NHWC")),
    ("conv2d_transpose", (f(2, 4, 5, 5), f(4, 3, 3, 3)),
     dict(stride=2, padding=1)),
    ("conv2d_transpose", (f(2, 4, 5, 5), f(4, 2, 3, 3)),
     dict(stride=2, padding=1, groups=2, dilation=2)),
    ("conv2d_transpose", (f(2, 5, 6, 4), f(4, 3, 2, 3)),
     dict(stride=(1, 2), padding=0, data_format="NHWC")),
    ("conv3d", (f(2, 3, 5, 6, 6), f(4, 3, 3, 3, 3)),
     dict(stride=1, padding=1)),
    ("conv3d", (f(1, 4, 5, 6, 7), f(4, 2, 2, 3, 3)),
     dict(stride=2, padding="SAME", groups=2)),
    ("conv3d", (f(1, 2, 6, 6, 6), f(3, 2, 3, 3, 3)),
     dict(dilation=2, padding="VALID")),
    ("conv3d_transpose", (f(1, 4, 3, 4, 4), f(4, 2, 3, 3, 3)),
     dict(stride=2, padding=1)),
    ("conv3d_transpose", (f(1, 4, 3, 4, 4), f(4, 1, 2, 2, 2)),
     dict(stride=1, padding=0, groups=2)),
    ("pool3d", (f(2, 3, 6, 6, 6),),
     dict(pool_size=2, pool_type="max", pool_stride=2)),
    ("pool3d", (f(2, 3, 5, 6, 6),),
     dict(pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1)),
    ("pool3d", (f(2, 3, 5, 6, 6),),
     dict(pool_size=(2, 3, 3), pool_type="max", pool_stride=(1, 2, 2),
          pool_padding=(0, 1, 1))),
    ("pool3d", (f(2, 3, 4, 4, 4),), dict(global_pooling=True,
                                         pool_type="avg")),
    ("pool3d", (f(2, 3, 4, 4, 4),), dict(global_pooling=True,
                                         pool_type="max")),
    ("adaptive_pool2d", (f(2, 3, 8, 8),), dict(pool_size=4,
                                               pool_type="avg")),
    ("adaptive_pool2d", (f(2, 3, 7, 9),), dict(pool_size=(3, 4),
                                               pool_type="avg")),
    ("adaptive_pool2d", (f(2, 3, 8, 8),), dict(pool_size=(2, 4),
                                               pool_type="max")),
    ("adaptive_pool2d", (f(2, 3, 7, 9),), dict(pool_size=(3, 4),
                                               pool_type="max")),
    ("adaptive_pool3d", (f(1, 2, 4, 6, 6),), dict(pool_size=(2, 3, 3),
                                                  pool_type="avg")),
    ("adaptive_pool3d", (f(1, 2, 5, 7, 6),), dict(pool_size=(2, 3, 4),
                                                  pool_type="avg")),
    ("adaptive_pool3d", (f(1, 2, 5, 7, 6),), dict(pool_size=(2, 3, 4),
                                                  pool_type="max")),
    ("sync_batch_norm", (f(4, 3, 5, 5), f(3), f(3), f(3), f(3, lo=0.5)),
     dict(momentum=0.8)),
    ("sync_batch_norm", (f(4, 3, 5, 5), f(3), f(3), f(3), f(3, lo=0.5)),
     dict(is_test=True)),
    ("sync_batch_norm", (f(4, 5, 3), f(3), f(3), f(3), f(3, lo=0.5)),
     dict(data_layout="NHWC")),
    ("layer_norm", (f(2, 3, 4, 5), f(60), f(60)), {}),
    ("layer_norm", (f(3, 4, 6), f(6), f(6)), dict(begin_norm_axis=2)),
    ("layer_norm", (f(3, 4, 6) + 5.0,), dict(begin_norm_axis=1,
                                             epsilon=1e-3)),
    ("group_norm", (f(2, 6, 4, 4), f(6), f(6)), dict(groups=3)),
    ("group_norm", (f(2, 6, 4, 4),), dict(groups=2)),
    ("group_norm", (f(2, 4, 3, 4, 2), f(4), f(4)), dict(groups=4)),
    ("instance_norm", (f(2, 4, 5, 5), f(4), f(4)), {}),
    ("instance_norm", (f(2, 4, 6, 6) * 3.0 + 1.0,), dict(epsilon=1e-3)),
    ("data_norm", (f(4, 3), np.full(3, 10.0, np.float32), f(3),
                   f(3, lo=30.0, hi=40.0)), {}),
    ("one_hot", (_ints(6, 1),), dict(depth=5)),
    ("one_hot", (_ints(2, 3),), dict(depth=4, dtype="int32")),
    ("label_smooth", (f(4, 5, lo=0, hi=1),), dict(epsilon=0.2)),
    ("label_smooth", (f(4, 5, lo=0, hi=1), f(5, lo=0, hi=0.4)), {}),
    ("lrn", (f(2, 7, 4, 4),), dict(n=5, k=2.0, alpha=1e-2, beta=0.75)),
    ("lrn", (f(1, 4, 3, 3),), dict(n=3)),
    ("pad", (f(2, 3, 4),), dict(paddings=[1, 0, 0, 2, 3, 1],
                                pad_value=0.5)),
    ("pad2d", (f(2, 3, 5, 5),), dict(paddings=[1, 2, 3, 0],
                                     pad_value=0.25)),
    ("pad2d", (f(2, 3, 5, 5),), dict(paddings=[3, 3, 3, 3],
                                     mode="reflect")),
    ("pad2d", (f(2, 3, 5, 5),), dict(paddings=[0, 2, 1, 3], mode="edge")),
    ("pad2d", (f(2, 5, 5, 3),), dict(paddings=[1, 2, 0, 1],
                                     mode="reflect", data_format="NHWC")),
    ("pad_constant_like", (f(4, 5, 6), f(2, 3, 6)), dict(pad_value=1.5)),
    ("pixel_shuffle", (f(2, 8, 3, 3),), dict(upscale_factor=2)),
    ("affine_channel", (f(2, 3, 4, 4), f(3), f(3)), {}),
    ("affine_channel", (f(2, 4, 4, 3), f(3), f(3)),
     dict(data_layout="NHWC")),
    ("unfold", (f(2, 3, 6, 6),), dict(kernel_sizes=3, strides=2,
                                      paddings=1)),
    ("unfold", (f(1, 2, 7, 8),), dict(kernel_sizes=(2, 3), dilations=2)),
    ("space_to_depth", (f(2, 3, 4, 6),), dict(blocksize=2)),
    ("shuffle_channel", (f(2, 6, 3, 3),), dict(group=3)),
    ("fc_act", (f(3, 4),), dict(act="relu")),
    ("fc_act", (f(3, 4),), dict(act="tanh")),
    ("fc_act", (f(3, 4),), dict(act=None)),
]
NAMES = ("depthwise_conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
         "pool3d", "adaptive_pool2d", "adaptive_pool3d", "sync_batch_norm",
         "layer_norm", "group_norm", "instance_norm", "data_norm", "one_hot",
         "label_smooth", "lrn", "pad", "pad2d", "pad_constant_like",
         "pixel_shuffle", "affine_channel", "unfold", "space_to_depth",
         "shuffle_channel", "fc_act")


def _outs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _close(got, want, where, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    assert jax.dtypes.canonicalize_dtype(got.dtype) == want.dtype, \
        (where, got.dtype, want.dtype)
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=where)


def test_the_cases_cover_every_ported_name():
    assert {c[0] for c in CASES} == set(NAMES)
    for n in NAMES:
        assert n in tops.nn.__all__ and getattr(tops, n) is getattr(
            tops.nn, n)
    assert set(NAMES) <= set(jops.nn.__all__)


@pytest.mark.parametrize("k", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_and_gradients_match_jax(k):
    name, args, kw = CASES[k]
    diff = [i for i, a in enumerate(args) if a.dtype == np.float32]
    targs = [torch.tensor(a, requires_grad=i in diff)
             for i, a in enumerate(args)]
    got = _outs(getattr(tops, name)(*targs, **kw))

    def jfn(*xs):
        full = list(map(jnp.asarray, args))
        for i, x in zip(diff, xs):
            full[i] = x
        return tuple(_outs(getattr(jops, name)(*full, **kw)))
    dxs = [jnp.asarray(args[i]) for i in diff]
    want = jax.jit(jfn)(*dxs)
    assert len(got) == len(want), name
    for j, (g, w) in enumerate(zip(got, want)):
        _close(g.detach().numpy(), w, f"{name} output {j}")
    floats = [j for j, w in enumerate(want)
              if jnp.issubdtype(w.dtype, jnp.floating)]
    if not diff or not floats:
        return
    cot = [R.randn(*want[j].shape).astype(np.float32) for j in floats]
    tgrads = torch.autograd.grad(
        [got[j] for j in floats], [targs[i] for i in diff],
        [torch.tensor(c) for c in cot], allow_unused=True)

    def jgrad(*xs):
        _, vjp = jax.vjp(lambda *v: tuple(jfn(*v)[j] for j in floats), *xs)
        return vjp(tuple(jnp.asarray(c) for c in cot))
    jgrads = jax.jit(jgrad)(*dxs)
    for i, g, w in zip(diff, tgrads, jgrads):
        g = np.zeros(args[i].shape, np.float32) if g is None else g.numpy()
        _close(g, w, f"{name} gradient of argument {i}")


# ---------------------------------------------------------------------------
# the traps
# ---------------------------------------------------------------------------
def _grad_of(fn, x, dy):
    xt = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(fn(xt), xt, torch.tensor(dy))
    return g.numpy()


@pytest.mark.parametrize("size,out", [((4, 4), (2, 2)), ((5, 7), (2, 3))])
def test_adaptive_max_splits_tied_gradients_like_jnp_max(size, out):
    """Tied maxima share the gradient evenly, as ``jnp.max``'s does, on
    the reshape path (divisible) and on the windowed one;
    ``F.adaptive_max_pool2d`` gives it all to one element."""
    x = np.round(R.uniform(0, 2, (1, 2) + size)).astype(np.float32)
    dy = np.ones((1, 2) + out, np.float32)
    got = _grad_of(lambda t: tops.adaptive_pool2d(t, out, "max"), x, dy)
    want = jax.jit(jax.grad(lambda v: jnp.sum(jops.adaptive_pool2d(
        v, out, "max"))))(jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-7)
    assert np.any((got > 0) & (got < 1))
    torch_one = _grad_of(lambda t: F.adaptive_max_pool2d(t, out), x, dy)
    assert not np.allclose(got, torch_one)


def test_adaptive_avg_windows_run_in_fp32():
    """The windowed average of a bf16 input is the fp32 mask product cast
    back to bf16, as the JAX op's promoted einsum."""
    x = f(1, 2, 7, 9)
    got = tops.adaptive_pool2d(torch.tensor(x).bfloat16(), (3, 4), "avg")
    want = jops.adaptive_pool2d(jnp.asarray(x, jnp.bfloat16), (3, 4), "avg")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_lrn_does_not_divide_alpha_by_n():
    x = f(2, 6, 3, 3)
    got = tops.lrn(torch.tensor(x), n=5, k=1.0, alpha=0.1, beta=0.75)
    _close(got.numpy(), jops.lrn(jnp.asarray(x), 5, 1.0, 0.1, 0.75), "lrn")
    other = F.local_response_norm(torch.tensor(x), 5, 0.1, 0.75, 1.0)
    assert not np.allclose(got.numpy(), other.numpy(), atol=1e-3)


def test_space_to_depth_orders_channels_bh_bw_c():
    x = f(1, 2, 4, 4)
    got = tops.space_to_depth(torch.tensor(x), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.space_to_depth(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(got[0, 1].numpy(), x[0, 1, 0::2, 0::2])
    assert not torch.equal(got, F.pixel_unshuffle(torch.tensor(x), 2))


def test_one_hot_gives_zero_rows_outside_the_depth():
    ids = np.array([[-1], [5], [2], [0], [7]], np.int32)
    got = tops.one_hot(torch.tensor(ids), 5)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.one_hot(ids, 5)))
    assert got.dtype == torch.float32
    assert got[[0, 1, 4]].abs().sum() == 0 and got[2, 2] == 1
    with pytest.raises(RuntimeError):
        F.one_hot(torch.tensor(ids[:, 0]).long(), 5)


def test_pool3d_average_divides_by_the_whole_window():
    x = f(1, 2, 4, 4, 4)
    got = tops.pool3d(torch.tensor(x), 3, "avg", 2, 1)
    _close(got.numpy(), jops.pool3d(jnp.asarray(x), 3, "avg", 2, 1), "avg")
    incl = F.avg_pool3d(torch.tensor(x), 3, 2, 1, count_include_pad=True)
    np.testing.assert_allclose(got.numpy(), incl.numpy(), atol=1e-6)
    excl = F.avg_pool3d(torch.tensor(x), 3, 2, 1, count_include_pad=False)
    assert not np.allclose(got.numpy(), excl.numpy(), atol=1e-3)


def test_sync_batch_norm_across_replicas_names_its_item():
    x = torch.tensor(f(4, 3, 2, 2))
    s, b, m, v = (torch.ones(3), torch.zeros(3), torch.zeros(3),
                  torch.ones(3))
    with pytest.raises(EnforceNotMet, match="queue 1 item 9"):
        tops.sync_batch_norm(x, s, b, m, v, axis_name="data")
    out = tops.sync_batch_norm(x, s, b, m, v, is_test=True, axis_name="data")
    torch.testing.assert_close(out[0], tops.batch_norm(
        x, s, b, m, v, is_test=True)[0])


# ---------------------------------------------------------------------------
# the layers in a Program
# ---------------------------------------------------------------------------
def _image_net(pt):
    """Every 2-D wrapper of the slice over one [B, 4, 6, 6] image."""
    L, I = pt.layers, pt.initializer

    def param(shape, name, init=None):
        return L.create_parameter(shape, "float32", attr=pt.ParamAttr(
            name=name, initializer=init or I.Normal(0.0, 0.5)))
    x = pt.data("x", [4, 6, 6], "float32")
    ids = pt.data("ids", [3, 1], "int32")
    outs = []
    y = L.conv2d_transpose(x, 6, filter_size=3, stride=2, padding=1,
                           act="relu")                          # 11x11
    outs.append(y)
    outs.append(L.conv2d_transpose(x, 4, output_size=12, stride=2,
                                   padding=1, groups=2,
                                   param_attr=pt.ParamAttr(name="ct_w"),
                                   bias_attr=False))
    outs.append(L.layer_norm(y, begin_norm_axis=2, act="tanh"))
    outs.append(L.layer_norm(x, scale=False))
    outs.append(L.group_norm(y, 3))
    outs.append(L.instance_norm(y, scale=param([6], "in_s"),
                                bias=param([6], "in_b")))
    outs.append(L.depthwise_conv2d(x, param([4, 1, 3, 3], "dw_w"),
                                   padding=1))
    outs.append(L.adaptive_pool2d(y, (3, 4), "avg"))
    outs.append(L.adaptive_pool2d(y, 2, "max"))
    outs.append(L.lrn(x, n=3, alpha=0.01))
    outs.append(L.pad2d(x, [3, 3, 3, 3], mode="reflect"))
    outs.append(L.pad2d(x, [0, 1, 0, 1], pad_value=0.5))
    outs.append(L.pad2d(x, [1, 0, 2, 1], mode="edge"))
    outs.append(L.pad(x, [0, 0, 1, 0, 0, 2, 1, 1]))
    outs.append(L.pixel_shuffle(x, 2))
    outs.append(L.affine_channel(x, param([4], "ac_s"), param([4], "ac_b")))
    outs.append(L.unfold(x, 3, strides=2, paddings=1))
    outs.append(L.space_to_depth(x, 2))
    outs.append(L.shuffle_channel(x, 2))
    outs.append(L.label_smooth(L.softmax(L.reshape(x, [-1, 36])),
                               epsilon=0.1))
    outs.append(L.data_norm(L.reshape(x, [-1, 144]),
                            param([144], "dn_n", I.Constant(10.0)),
                            param([144], "dn_s"),
                            param([144], "dn_q", I.Constant(50.0))))
    outs.append(L.sync_batch_norm(x, param([4], "sb_s"), param([4], "sb_b"),
                                  param([4], "sb_m", I.Constant(0.0)),
                                  param([4], "sb_v", I.Constant(1.0))))
    # (a dtype object default would not serialize in the JAX package)
    hot = L.one_hot(ids, 5, dtype="float32")
    return outs, [hot]


def _volume_net(pt):
    """The 3-D wrappers over one [B, 2, 4, 6, 6] volume."""
    L = pt.layers
    x = pt.data("v", [2, 4, 6, 6], "float32")
    y = L.conv3d(x, 4, 3, padding=1, act="relu")
    outs = [y, L.conv3d(x, 2, (2, 3, 3), stride=2, groups=2,
                        bias_attr=False)]
    outs.append(L.conv3d_transpose(y, 3, filter_size=2, stride=2))
    outs.append(L.conv3d_transpose(x, 2, output_size=(7, 11, 11), stride=2,
                                   padding=1))
    outs.append(L.pool3d(y, 2, "max", 2))
    outs.append(L.pool3d(y, 3, "avg", 1, 1))
    outs.append(L.adaptive_pool3d(y, (2, 3, 4), "avg"))
    return outs, []


def _build(pt, unique_name, net):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        outs, ints = net(pt)
        loss = pt.layers.sums([pt.layers.reduce_mean(o) for o in outs])
        pg = pt.static.append_backward(loss)
    return main, startup, outs + ints + [loss], [g for _, g in pg]


@pytest.mark.parametrize("net", [_image_net, _volume_net],
                         ids=["image", "volume"])
def test_layers_build_and_run_like_jax(net):
    from paddle_tpu.static import serialize as jser
    from paddle_tpu_torch.static import serialize as tser
    tm, ts, touts, tgrads = _build(tpt, tpt.unique_name, net)
    jm, js, jouts, jgrads = _build(jpt, junique, net)
    assert tser.program_to_dict(ts) == jser.program_to_dict(js)
    assert tser.program_to_dict(tm) == jser.program_to_dict(jm)
    jscope, jexe = jpt.static.Scope(), jpt.static.Executor(jpt.CPUPlace())
    jexe.run(js, scope=jscope)
    names = [n for n, v in js.global_block().vars.items() if v.persistable]
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in names}, "cpu", ts)
    rng = np.random.RandomState(7)
    feed = ({"x": rng.randn(2, 4, 6, 6).astype(np.float32),
             "ids": rng.randint(-1, 6, (2, 3, 1)).astype(np.int32)}
            if net is _image_net else
            {"v": rng.randn(2, 2, 4, 6, 6).astype(np.float32)})
    fetch = [v.name for v in touts] + [g.name for g in tgrads]
    assert fetch == [v.name for v in jouts] + [g.name for g in jgrads]
    got = tpt.Executor(tpt.CPUPlace()).run(tm, feed=feed, fetch_list=fetch,
                                           scope=tscope)
    want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
    for n, g, w in zip(fetch, got, want):
        _close(g, w, n)


def test_layer_shapes_and_parameters_are_the_jax_ones():
    """The parameterized layers' weights: IOHW (Xavier) for the transposed
    convs, OIDHW (MSRA) for conv3d, flat scale and shift for layer_norm,
    per-channel for group_norm; the filter size inferred from
    ``output_size``; ``fc_act`` is not a layer (the JAX ``_EXCLUDE``)."""
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = tpt.data("x", [4, 5, 5], "float32")
        v = tpt.data("v", [2, 3, 4, 4], "float32")
        a = tpt.layers.conv2d_transpose(x, 6, output_size=10, stride=2,
                                        padding=1)
        tpt.layers.conv3d_transpose(v, 3, filter_size=2, stride=2)
        tpt.layers.conv3d(v, 5, 3)
        tpt.layers.layer_norm(x, begin_norm_axis=1)
        tpt.layers.group_norm(x, 2)
    shapes = {n: tuple(p.shape) for n, p in
              ((p.name, p) for p in main.all_parameters())}
    assert shapes == {"conv2dT_w": (4, 6, 4, 4), "conv2dT_b": (6,),
                      "conv3dT_w": (2, 3, 2, 2, 2), "conv3dT_b": (3,),
                      "conv3d_w": (5, 2, 3, 3, 3), "conv3d_b": (5,),
                      "ln_scale": (100,), "ln_bias": (100,),
                      "gn_scale": (4,), "gn_bias": (4,)}
    assert list(a.shape) == [-1, 6, 10, 10]
    assert not hasattr(tpt.layers, "fc_act") and tops.fc_act
    with pytest.raises(EnforceNotMet, match="output_size or filter_size"):
        with tpt.program_guard(tpt.Program(), tpt.Program()):
            tpt.layers.conv2d_transpose(tpt.data("x", [4, 5, 5]), 6)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
#: the standard deviation of a standard normal truncated to [-2, 2]
TRUNC_STD = 0.8796256610342398


@pytest.mark.parametrize("cls", ["TruncatedNormal",
                                 "TruncatedNormalInitializer"])
def test_truncated_normal_range_and_moments(cls):
    """The draws are torch's: held by their range (within two standard
    deviations of ``loc``, as ``jax.random.truncated_normal(-2, 2)``) and
    by their first two moments, against the analytic ones and the JAX
    package's over the same count."""
    loc, scale, n = 1.0, 0.02, 200_000
    init = getattr(tinit, cls)(loc, scale)
    z = init(torch.Generator().manual_seed(3), (n,)).numpy()
    w = np.asarray(getattr(jinit, cls)(loc, scale)(jax.random.PRNGKey(3),
                                                   (n,)))
    for v in (z, w):
        assert v.dtype == np.float32 and v.shape == (n,)
        assert v.min() >= loc - 2 * scale - 1e-6
        assert v.max() <= loc + 2 * scale + 1e-6
        assert abs(v.mean() - loc) < 0.01 * scale
        assert abs(v.std() / (scale * TRUNC_STD) - 1) < 0.01
    seeded = getattr(tinit, cls)(0.0, 1.0, seed=5)
    np.testing.assert_array_equal(seeded(None, (64,)).numpy(),
                                  seeded(None, (64,)).numpy())


@pytest.mark.parametrize("shape", [(3, 3, 4, 4), (2, 3, 3, 3), (1, 1, 5, 5),
                                   (2, 2, 3, 3)])
@pytest.mark.parametrize("cls", ["Bilinear", "BilinearInitializer"])
def test_bilinear_matches_jax(cls, shape):
    got = getattr(tinit, cls)()(None, shape)
    want = getattr(jinit, cls)()(jax.random.PRNGKey(0), shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        getattr(tinit, cls)()(None, (3, 3))


def test_numpy_array_initializer_matches_jax():
    value = R.randn(2, 6)
    for shape, dtype in (((2, 6), "float32"), ((3, 4), "float32"),
                         ((12,), "int32")):
        got = tinit.NumpyArrayInitializer(value)(None, shape, dtype)
        want = jinit.NumpyArrayInitializer(value)(None, shape, dtype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert str(got.dtype) == f"torch.{dtype}"


def test_initializers_in_a_startup_program_match_jax():
    """The two drawless initializers through each package's startup
    program: the documents (an ndarray attr for ``NumpyArrayInitializer``)
    and the values are equal; ``init_on_cpu`` sets the flag inside."""
    from paddle_tpu.static import serialize as jser
    from paddle_tpu_torch.static import serialize as tser
    value = R.randn(4, 3).astype(np.float32)

    def build(pt, unique_name):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), unique_name.guard():
            x = pt.data("x", [3, 4, 4], "float32")
            pt.layers.conv2d_transpose(
                x, 3, filter_size=4, stride=2, bias_attr=False,
                param_attr=pt.ParamAttr(
                    name="up", initializer=pt.initializer.Bilinear()))
            pt.layers.create_parameter(
                [4, 3], "float32", attr=pt.ParamAttr(
                    name="arr",
                    initializer=pt.initializer.NumpyArrayInitializer(value)))
        return startup
    ts, js = build(tpt, tpt.unique_name), build(jpt, junique)
    assert tser.program_to_dict(ts) == jser.program_to_dict(js)
    tscope, jscope = tpt.Scope(), jpt.static.Scope()
    tpt.Executor(tpt.CPUPlace()).run(ts, scope=tscope)
    jpt.static.Executor(jpt.CPUPlace()).run(js, scope=jscope)
    for n in ("up", "arr"):
        np.testing.assert_array_equal(tscope.find_var(n).numpy(),
                                      np.asarray(jscope.find_var(n)))
    assert not tinit.force_init_on_cpu()
    with tinit.init_on_cpu():
        assert tinit.force_init_on_cpu()
    assert not tinit.force_init_on_cpu()
