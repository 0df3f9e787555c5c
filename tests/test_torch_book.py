"""The first Fluid book CNNs in the port against the JAX package, on the
CPU: the static ops they add (``conv2d``, ``pool2d``, ``batch_norm``,
``dropout``, ``scale``, ``elementwise_mul``, ``split``) over parametrised
grids, ``nets``, then recognize_digits, image_classification and
recommender_system (``tests/test_book.py``'s models, plus the reference's
``conv_net`` and a ``vgg16_bn_drop`` at small widths with batch norm and
dropout) trained in both packages from the JAX startup's weights, their
convergence on the port alone with dropout on, the ``for_test`` clone, and
``save_inference_model`` / ``load_inference_model`` across the packages
both ways.

The JAX package runs its stock bodies. Tolerances: the convolution sums
k*k*C products in another order than XLA's (1e-5); pooling and batch norm
round the same few sums (1e-6); after five Adam steps the losses and
parameters 1e-5 and the batch-norm running stats 1e-6, with the drop rate
0 (the masks are torch's draws, not threefry's: dropout is held by its
statistics, its values and its gradient instead).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import nets as jnets
from paddle_tpu import ops as jops
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.static import serialize as jser

import paddle_tpu_torch as tpt
from paddle_tpu_torch import nets as tnets
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.static import serialize as tser


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------
CONV = [  # stride, padding, dilation, groups, layout, (H, W), k
    (1, 0, 1, 1, "NCHW", (9, 9), 3),
    (1, 1, 1, 1, "NHWC", (9, 9), 3),
    (2, 1, 1, 1, "NCHW", (10, 9), 3),
    (2, [1, 2], 1, 1, "NCHW", (9, 11), 3),
    (1, "SAME", 1, 1, "NCHW", (9, 9), 3),
    (2, "SAME", 1, 1, "NCHW", (10, 9), 3),
    (2, "SAME", 1, 1, "NHWC", (9, 12), 4),
    (3, "same", 2, 1, "NCHW", (13, 11), 3),
    (2, "VALID", 1, 1, "NCHW", (10, 9), 3),
    (1, "VALID", 2, 1, "NHWC", (11, 11), 3),
    (1, 2, 2, 1, "NCHW", (9, 9), 3),
    (1, 1, 1, 2, "NCHW", (8, 8), 3),
    (2, "SAME", 1, 4, "NHWC", (8, 8), 3),
    (1, 2, 1, 1, "NCHW", (12, 12), 5),
]


@pytest.mark.parametrize("stride,padding,dilation,groups,layout,hw,k", CONV)
def test_conv2d_matches_jax(stride, padding, dilation, groups, layout, hw, k):
    cin, cout = 4, 8
    x = _np(0, 2, cin, *hw)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = _np(1, cout, cin // groups, k, k, scale=0.3)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=layout)
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(w), **kw))
    got = tops.conv2d(torch.tensor(x), torch.tensor(w), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


POOL = [  # type, k, stride, padding, ceil, exclusive, global, layout, hw
    ("max", 2, 2, 0, False, True, False, "NCHW", (8, 8)),
    ("max", 3, 2, 1, False, True, False, "NCHW", (9, 10)),
    ("max", 3, 2, 2, False, True, False, "NHWC", (9, 10)),
    ("max", 3, 2, 0, True, True, False, "NCHW", (10, 9)),
    ("max", 2, 2, 1, True, True, False, "NHWC", (7, 7)),
    ("max", [3, 2], [2, 1], [1, 0], False, True, False, "NCHW", (9, 8)),
    ("avg", 2, 2, 0, False, True, False, "NCHW", (8, 8)),
    ("avg", 3, 2, 1, False, True, False, "NCHW", (9, 10)),
    ("avg", 3, 2, 1, False, False, False, "NCHW", (9, 10)),
    ("avg", 3, 2, 2, False, True, False, "NHWC", (9, 10)),
    ("avg", 3, 2, 2, False, False, False, "NHWC", (9, 10)),
    ("avg", 3, 2, 0, True, True, False, "NCHW", (10, 9)),
    ("avg", 3, 2, 1, True, False, False, "NHWC", (10, 9)),
    ("max", 2, 1, 0, False, True, True, "NCHW", (5, 6)),
    ("avg", 2, 1, 0, False, True, True, "NHWC", (5, 6)),
]


@pytest.mark.parametrize(
    "ptype,k,stride,padding,ceil,exclusive,glob,layout,hw", POOL)
def test_pool2d_matches_jax(ptype, k, stride, padding, ceil, exclusive, glob,
                            layout, hw):
    shape = (2, 3, *hw) if layout == "NCHW" else (2, *hw, 3)
    x = _np(2, *shape)
    kw = dict(pool_size=k, pool_type=ptype, pool_stride=stride,
              pool_padding=padding, global_pooling=glob, ceil_mode=ceil,
              exclusive=exclusive, data_format=layout)
    want = np.asarray(jops.pool2d(jnp.asarray(x), **kw))
    got = tops.pool2d(torch.tensor(x), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_pool2d_refuses_an_unknown_layout():
    with pytest.raises(ValueError, match="NCHW|NHWC"):
        tops.pool2d(torch.zeros(1, 1, 4, 4), data_format="NCDHW")


@pytest.mark.parametrize("mode", ["train", "is_test", "use_global_stats"])
@pytest.mark.parametrize("layout,shape", [("NCHW", (4, 3, 5, 6)),
                                          ("NHWC", (4, 5, 6, 3)),
                                          ("NCHW", (16, 3))])
def test_batch_norm_matches_jax(mode, layout, shape):
    x = _np(3, *shape, scale=2.0) + 0.5
    c = 3
    scale, bias = _np(4, c) + 1.0, _np(5, c)
    mean, var = _np(6, c, scale=0.1), np.abs(_np(7, c)) + 0.5
    kw = dict(epsilon=1e-5, momentum=0.9, is_test=mode == "is_test",
              data_layout=layout, use_global_stats=mode == "use_global_stats")
    want = jops.batch_norm(*map(jnp.asarray, (x, scale, bias, mean, var)),
                           **kw)
    got = tops.batch_norm(*map(torch.tensor, (x, scale, bias, mean, var)),
                          **kw)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    if mode != "train":
        np.testing.assert_array_equal(got[1].numpy(), mean)
        np.testing.assert_array_equal(got[2].numpy(), var)


def test_batch_norm_keeps_the_jax_running_stats_not_torchs():
    """``m*old + (1-m)*batch`` with the biased variance, where
    ``F.batch_norm`` takes ``(1-m)*old + m*batch`` with the unbiased one."""
    x = torch.tensor(_np(8, 6, 2))
    mean, var = torch.zeros(2), torch.ones(2)
    _, m_out, v_out, m, v = tops.batch_norm(x, torch.ones(2), torch.zeros(2),
                                            mean, var, momentum=0.9)
    torch.testing.assert_close(m, x.mean(0))
    torch.testing.assert_close(v, x.var(0, unbiased=False))
    torch.testing.assert_close(m_out, 0.1 * x.mean(0))
    torch.testing.assert_close(v_out, 0.9 + 0.1 * x.var(0, unbiased=False))


def test_dropout_test_mode_and_zero_rate():
    x = torch.tensor(_np(9, 50, 20))
    assert tops.dropout(x, 0.0) is x
    assert tops.dropout(x, 0.0, is_test=True) is x
    for impl, want in (("downgrade_in_infer", x * 0.7),
                       ("upscale_in_train", x)):
        got = tops.dropout(x, 0.3, is_test=True,
                           dropout_implementation=impl)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        jgot = jops.dropout(jnp.asarray(x.numpy()), 0.3, is_test=True,
                            dropout_implementation=impl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


@pytest.mark.parametrize("p", [0.3, 0.5])
@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_statistics_values_and_gradient(p, impl):
    n = 200_000
    x = (torch.rand(n, generator=torch.Generator().manual_seed(1)) + 0.5
         ).requires_grad_()
    out = tops.dropout(x, p, dropout_implementation=impl,
                       rng=torch.Generator().manual_seed(7))
    kept = out != 0
    share = kept.double().mean().item()
    sigma = ((1 - p) * p / n) ** 0.5
    assert abs(share - (1 - p)) < 5 * sigma, (share, 1 - p)
    scale = 1.0 / (1.0 - p) if impl == "upscale_in_train" else 1.0
    want = x.detach() / (1.0 - p) if scale != 1.0 else x.detach()
    assert torch.equal(out.detach()[kept], want[kept])
    out.sum().backward()
    torch.testing.assert_close(x.grad, kept.float() * (want / x.detach()),
                               rtol=1e-6, atol=0)
    # the same seed draws the same mask; another draws another
    again = tops.dropout(x.detach(), p, dropout_implementation=impl, seed=3)
    assert torch.equal(again, tops.dropout(
        x.detach(), p, dropout_implementation=impl, seed=3))
    assert not torch.equal(again != 0, tops.dropout(
        x.detach(), p, dropout_implementation=impl, seed=4) != 0)


def test_scale_elementwise_mul_split_match_jax():
    x, y = _np(10, 2, 6, 4), _np(11, 6)
    for kw in ({}, {"scale": 2.5, "bias": -1.0},
               {"scale": 2.5, "bias": -1.0, "bias_after_scale": False}):
        np.testing.assert_array_equal(
            tops.scale(torch.tensor(x), **kw).numpy(),
            np.asarray(jops.scale(jnp.asarray(x), **kw)))
    np.testing.assert_array_equal(
        tops.elementwise_mul(torch.tensor(x), torch.tensor(y), axis=1)
        .numpy(), np.asarray(jops.elementwise_mul(jnp.asarray(x),
                                                  jnp.asarray(y), axis=1)))
    for sections, dim in ((2, 1), (3, 1), ([1, 2, 9], 1), ([2, 1], -1)):
        got = tops.split(torch.tensor(x), sections, dim)
        want = jops.split(jnp.asarray(x), sections, dim)
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="equal parts"):
        tops.split(torch.tensor(x), 4, 1)


def test_nets_glu_and_attention_match_jax():
    x = _np(12, 3, 8)
    np.testing.assert_allclose(
        tnets.glu(torch.tensor(x)).numpy(),
        np.asarray(jnets.glu(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    q, k, v = _np(13, 2, 5, 8), _np(14, 2, 7, 8), _np(15, 2, 7, 12)
    for heads in (1, 4):
        want = jnets.scaled_dot_product_attention(
            *map(jnp.asarray, (q, k, v)), num_heads=heads)
        got = tnets.scaled_dot_product_attention(
            *map(torch.tensor, (q, k, v)), num_heads=heads)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="num_heads"):
        tnets.scaled_dot_product_attention(*map(torch.tensor, (q, k, v)),
                                           num_heads=3)
    # sequence_conv_pool is ported (tests/test_torch_sequence.py); outside a
    # Program and a module context its parameters have nowhere to live
    with pytest.raises(EnforceNotMet, match="module context"):
        tnets.sequence_conv_pool(
            (torch.zeros(2, 3, 4), torch.tensor([3, 2])), 8, 3)


def test_layers_outside_a_program():
    """batch_norm keeps its running stats in the module context, and
    outside one it has nowhere to keep its parameters; dropout runs at once
    with a generator from ``seed``; a static split gives one Variable per
    part."""
    x = torch.tensor(_np(16, 4, 3, 5, 5))
    with pytest.raises(EnforceNotMet, match="module context"):
        tpt.layers.batch_norm(x)
    a = tpt.layers.dropout(x, 0.5, seed=11)
    assert torch.equal(a, tpt.layers.dropout(x, 0.5, seed=11))
    assert torch.equal(tpt.layers.dropout(x, 0.5, is_test=True), x * 0.5)
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()):
        v = tpt.data("v", [6, 4])
        parts = tpt.layers.split(v, [2, 4], dim=1)
        assert [p.shape for p in parts] == [(-1, 2, 4), (-1, 4, 4)]
        g = tnets.glu(v, dim=1)
        assert g.shape == (-1, 3, 4)
    out = tpt.Executor(tpt.CPUPlace()).run(
        main, feed={"v": _np(17, 2, 6, 4)}, fetch_list=[g, parts[1]])
    want = np.asarray(jnets.glu(jnp.asarray(_np(17, 2, 6, 4)), dim=1))
    np.testing.assert_allclose(out[0], want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the book models
# ---------------------------------------------------------------------------
def _digits(pt, nets, drop):
    """tests/test_book.py's recognize_digits."""
    img = pt.data("img", [1, 12, 12])
    label = pt.data("label", [1], "int64")
    c1 = nets.simple_img_conv_pool(img, num_filters=4, filter_size=3,
                                   pool_size=2, pool_stride=2, act="relu",
                                   conv_padding=1)
    c2 = nets.simple_img_conv_pool(c1, num_filters=8, filter_size=3,
                                   pool_size=2, pool_stride=2, act="relu",
                                   conv_padding=1)
    pred = pt.layers.fc(c2, 10, act="softmax")
    return pred, pt.layers.mean(pt.layers.cross_entropy(pred, label))


def _conv_net(pt, nets, drop):
    """The reference's recognize_digits conv_net (test_recognize_digits.py)
    at widths 4 and 8 on 16x16 images: conv-pool, batch norm, conv-pool,
    fc softmax."""
    img = pt.data("img", [1, 16, 16])
    label = pt.data("label", [1], "int64")
    c1 = nets.simple_img_conv_pool(img, num_filters=4, filter_size=5,
                                   pool_size=2, pool_stride=2, act="relu")
    c1 = pt.layers.batch_norm(c1)
    c2 = nets.simple_img_conv_pool(c1, num_filters=8, filter_size=5,
                                   pool_size=2, pool_stride=2, act="relu")
    pred = pt.layers.fc(c2, 10, act="softmax")
    return pred, pt.layers.mean(pt.layers.cross_entropy(pred, label))


def _image_classification(pt, nets, drop):
    """tests/test_book.py's image_classification."""
    img = pt.data("img", [3, 8, 8])
    label = pt.data("label", [1], "int64")
    g = nets.img_conv_group(img, conv_num_filter=[4, 4], pool_size=2,
                            conv_act="relu")
    pred = pt.layers.fc(g, 10, act="softmax")
    return pred, pt.layers.mean(pt.layers.cross_entropy(pred, label))


def _vgg_bn_drop(pt, nets, drop):
    """The reference's vgg16_bn_drop (test_image_classification.py) cut to
    two groups of widths 4 and 8 on 3x8x8 images and fc 16: batch norm
    after every conv, dropout at ``drop`` on each group's first conv and
    around the first fc."""
    img = pt.data("img", [3, 8, 8])
    label = pt.data("label", [1], "int64")
    x = img
    for width in (4, 8):
        x = nets.img_conv_group(
            x, conv_num_filter=[width, width], pool_size=2, pool_stride=2,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=[drop, 0.0], pool_type="max")
    x = pt.layers.dropout(x, dropout_prob=drop)
    fc1 = pt.layers.fc(x, 16)
    bn = pt.layers.batch_norm(fc1, act="relu")
    x = pt.layers.dropout(bn, dropout_prob=drop)
    fc2 = pt.layers.fc(x, 16)
    pred = pt.layers.fc(fc2, 10, act="softmax")
    return pred, pt.layers.mean(pt.layers.cross_entropy(pred, label))


NU, NI, E = 12, 15, 8


def _recommender(pt, nets, drop):
    """tests/test_book.py's two-tower recommender_system."""
    uid = pt.data("uid", [1], "int64")
    mid = pt.data("mid", [1], "int64")
    score = pt.data("score", [1])
    uemb = pt.layers.reshape(pt.layers.embedding(uid, [NU, E]), [-1, E])
    memb = pt.layers.reshape(pt.layers.embedding(mid, [NI, E]), [-1, E])
    sim = pt.layers.cos_sim(pt.layers.fc(uemb, E), pt.layers.fc(memb, E))
    pred = pt.layers.scale(sim, scale=5.0)
    return pred, pt.layers.mean(pt.layers.square_error_cost(pred, score))


def _image_feed(shape, div):
    def feed(rng):
        label = rng.randint(0, 10, (16, 1))
        img = (label[:, :, None, None] / div
               + 0.1 * rng.randn(16, *shape)).astype(np.float32)
        return {"img": img, "label": label.astype(np.int64)}
    return feed


_TRUTH = np.random.RandomState(1).rand(NU, NI).astype(np.float32) * 5


def _rec_feed(rng):
    uid = rng.randint(0, NU, (32, 1))
    mid = rng.randint(0, NI, (32, 1))
    return {"uid": uid.astype(np.int64), "mid": mid.astype(np.int64),
            "score": _TRUTH[uid[:, 0], mid[:, 0]][:, None]}


# name -> (builder, feeder, Adam rate and epsilon, test_book's steps and
# factor). A bias that feeds a batch norm (a conv's in vgg_bn_drop, one
# conv_net channel whose ReLU passes every input) has a gradient that is 0
# but for rounding and of either sign; at epsilon 1e-8 Adam's first step
# divides it by its own size and moves that bias by up to the rate, in
# each package its own way (tools/book_order_probe.py bias-noise:
# vgg_bn_drop's conv biases have gradients of 3e-9 to 1.3e-7 and end 6e-4
# to 1.4e-3 apart after one step; conv_net's first conv bias, a gradient of
# 1.0e-6 that the packages compute 2.7e-6 apart, ends 5.9e-3 apart). At
# epsilon 1e-4 they end at most 1.9e-6 apart, while the gradients that
# carry signal (1e-4 to 1) keep Adam's normalised step. The gradients
# themselves are held to JAX's directly (test_book_model_trains_like_jax,
# first step).
BOOK = {
    "recognize_digits": (_digits, _image_feed((1, 12, 12), 10.0),
                         (5e-3, 1e-8), 30, 0.8),
    "conv_net": (_conv_net, _image_feed((1, 16, 16), 10.0), (5e-3, 1e-4),
                 30, 0.8),
    "image_classification": (_image_classification,
                             _image_feed((3, 8, 8), 5.0), (5e-3, 1e-8), 25,
                             0.8),
    "vgg_bn_drop": (_vgg_bn_drop, _image_feed((3, 8, 8), 5.0), (5e-3, 1e-4),
                    40, 0.8),
    "recommender_system": (_recommender, _rec_feed, (5e-2, 1e-8), 40, 0.8),
}


def _program(pt, nets, unique_name, name, drop=0.0):
    """(main, startup, pred, loss, the for_test clone made before
    minimize, as a fluid script makes it)."""
    build, _, (lr, eps), _, _ = BOOK[name]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        pred, loss = build(pt, nets, drop)
        test = main.clone(for_test=True)
        pt.optimizer.AdamOptimizer(learning_rate=lr,
                                   epsilon=eps).minimize(loss)
    return main, startup, pred, loss, test


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items()
                  if v.persistable)


@pytest.mark.parametrize("name", list(BOOK))
def test_book_model_trains_like_jax(name):
    feeder = BOOK[name][1]
    rng = np.random.RandomState(0)
    feeds = [feeder(rng) for _ in range(5)]
    jmain, jstart, _, jloss, _ = _program(jpt, jnets, junique, name)
    tmain, tstart, _, tloss, _ = _program(tpt, tnets, tpt.unique_name, name)
    # the same documents: ops, attrs, vars and initializers
    for t, j in ((tmain, jmain), (tstart, jstart)):
        assert tser.program_to_dict(t) == jser.program_to_dict(j)
    jscope = jpt.static.Scope()
    jexe = jpt.Executor()
    jexe.run(jstart, scope=jscope)
    names = _persistables(jstart)
    s0 = {n: np.array(jscope.find_var(n)) for n in names}
    tscope = tpt.Scope.from_numpy(s0, "cpu", tstart)
    texe = tpt.Executor(tpt.CPUPlace())
    grads = [p.name + "@GRAD" for p in tmain.all_parameters() if p.trainable]
    jg = jexe.run(jmain, feed=feeds[0], fetch_list=grads, scope=jscope)
    tg = texe.run(tmain, feed=feeds[0], fetch_list=grads, scope=tscope)
    for n, a, b in zip(grads, tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=n)
    jl = [float(jexe.run(jmain, feed=f, fetch_list=[jloss],
                         scope=jscope)[0]) for f in feeds[1:]]
    tl = [float(texe.run(tmain, feed=f, fetch_list=[tloss],
                         scope=tscope)[0]) for f in feeds[1:]]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    stats = [n for n in names if n.startswith(("bn_mean", "bn_variance"))]
    assert bool(stats) == (name in ("conv_net", "vgg_bn_drop"))
    for n in names:
        tol = 1e-6 if n in stats else 1e-5
        got, want = tscope.find_var(n).numpy(), np.array(jscope.find_var(n))
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=n)
    for n in stats:        # the stats moved, and are no autodiff param
        assert not np.array_equal(tscope.find_var(n).numpy(), s0[n]), n
        assert not tmain.global_block().var(n).trainable


@pytest.mark.parametrize("name", list(BOOK))
def test_book_model_converges_on_the_port_with_dropout(name):
    """tests/test_book.py's criterion (the last loss below 0.8 of the
    first), the port alone, dropout at 0.3 where the model has it."""
    _, feeder, _, steps, factor = BOOK[name]
    main, startup, _, loss, _ = _program(tpt, tnets, tpt.unique_name, name,
                                         drop=0.3)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    losses = [float(exe.run(main, feed=feeder(rng), fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] * factor, losses


def _static_dropout_program(seed):
    main, startup = tpt.Program(), tpt.Program()
    main.random_seed = seed
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = tpt.data("x", [64])
        h = tpt.layers.fc(x, 64)
        d = tpt.layers.dropout(h, 0.5,
                               dropout_implementation="upscale_in_train")
        loss = tpt.layers.mean(d)
        tpt.optimizer.SGD(0.1).minimize(loss)
    return main, startup, h, d, loss


def test_static_dropout_masks_follow_the_seed_and_the_run():
    feed = {"x": np.ones((8, 64), np.float32)}

    def masks(seed, runs, passes=True):
        main, startup, h, d, loss = _static_dropout_program(seed)
        scope = tpt.Scope()
        exe = tpt.Executor(tpt.CPUPlace())
        exe.run(startup, scope=scope)
        tpt.set_flags({"apply_ir_passes": passes})
        try:
            out = []
            for _ in range(runs):
                hv, dv, grad = exe.run(main, feed=feed,
                                       fetch_list=[h, d, "fc_w@GRAD"],
                                       scope=scope)
                out.append((dv != 0, hv, dv, grad))
        finally:
            tpt.set_flags({"apply_ir_passes": True})
        return out

    a, b = masks(5, 2), masks(5, 2)
    for (ma, _, _, _), (mb, _, _, _) in zip(a, b):
        np.testing.assert_array_equal(ma, mb)       # two executors
    assert not np.array_equal(a[0][0], a[1][0])     # the run advances it
    assert not np.array_equal(a[0][0], masks(6, 1)[0][0])
    np.testing.assert_array_equal(a[0][0], masks(5, 1, passes=False)[0][0])
    share = a[0][0].mean()
    assert abs(share - 0.5) < 5 * (0.25 / a[0][0].size) ** 0.5
    # the loss and the grad saw the one mask: d(mean(drop(x W)))/dW is
    # x^T (mask * 2) / n
    m, hv, dv, grad = a[0]
    np.testing.assert_array_equal(dv[m], (hv / 0.5)[m])
    want = feed["x"].T @ (m * 2.0 / m.size).astype(np.float32)
    np.testing.assert_allclose(grad, want, rtol=1e-6, atol=1e-7)


def test_for_test_clone_freezes_dropout_and_batch_norm():
    main, startup, pred, loss, test = _program(
        tpt, tnets, tpt.unique_name, "vgg_bn_drop", drop=0.3)
    assert [op.type for op in main.clone(for_test=True).global_block().ops
            if op.type in ("dropout", "batch_norm")] == \
        [op.type for op in test.global_block().ops
         if op.type in ("dropout", "batch_norm")]
    frozen = [op for op in test.global_block().ops
              if op.type in ("dropout", "batch_norm")]
    assert frozen and all(op.attrs["is_test"] for op in frozen)
    assert not any(op.attrs["is_test"] for op in main.global_block().ops
                   if op.type in ("dropout", "batch_norm"))
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = _image_feed((3, 8, 8), 5.0)(np.random.RandomState(0))
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    stats = {n: scope.find_var(n).clone() for n in scope.names()
             if n.startswith("bn_mean")}
    one = exe.run(test, feed=feed, fetch_list=[pred], scope=scope)[0]
    two = exe.run(test, feed=feed, fetch_list=[pred], scope=scope)[0]
    np.testing.assert_array_equal(one, two)
    # a row's prediction does not depend on the rest of the batch
    half = {k: v[:4] for k, v in feed.items()}
    np.testing.assert_allclose(
        exe.run(test, feed=half, fetch_list=[pred], scope=scope)[0],
        one[:4], rtol=1e-6, atol=1e-7)
    for n, v in stats.items():
        assert torch.equal(scope.find_var(n), v), n


def _train(pkg, nets, unique_name, exe, scope, steps=3):
    main, startup, pred, loss, test = _program(pkg, nets, unique_name,
                                               "conv_net")
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feeder = BOOK["conv_net"][1]
    for _ in range(steps):
        exe.run(main, feed=feeder(rng), fetch_list=[loss], scope=scope)
    return main, pred, test


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_inference_model_loads_across_the_packages(tmp_path, direction):
    """A trained recognize_digits conv_net (batch norm included) saved by
    one package's ``save_inference_model`` predicts the same in the
    other's ``load_inference_model``, as the saving package's ``for_test``
    clone predicts."""
    feed = _image_feed((1, 16, 16), 10.0)(np.random.RandomState(9))
    d = str(tmp_path / "digits")
    if direction == "jax_to_port":
        exe, scope = jpt.Executor(), jpt.static.Scope()
        main, pred, test = _train(jpt, jnets, junique, exe, scope)
        with jpt.static.scope_guard(scope):
            jpt.io.save_inference_model(d, ["img"], [pred], exe,
                                        main_program=main)
        want = exe.run(test, feed=feed, fetch_list=[pred], scope=scope)[0]
        lexe, lscope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
        prog, feeds, fetches = tpt.io.load_inference_model(d, lexe,
                                                           scope=lscope)
    else:
        exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
        main, pred, test = _train(tpt, tnets, tpt.unique_name, exe, scope)
        with tpt.scope_guard(scope):
            tpt.io.save_inference_model(d, ["img"], [pred], exe,
                                        main_program=main)
        want = exe.run(test, feed=feed, fetch_list=[pred], scope=scope)[0]
        lexe, lscope = jpt.Executor(), jpt.static.Scope()
        prog, feeds, fetches = jpt.io.load_inference_model(d, lexe,
                                                           scope=lscope)
    assert feeds == ["img"] and len(fetches) == 1
    types = [op.type for op in prog.global_block().ops]
    assert "batch_norm" in types and "autodiff" not in types
    got = lexe.run(prog, feed={"img": feed["img"]}, fetch_list=fetches,
                   scope=lscope)[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
