"""``ops/misc.py`` and its ``layers`` wrappers in the port against the JAX
package, on the CPU.

1. Every function of ``ops/misc.py`` (the 38 names), one parametrised case
   per call: the value and the gradient of every float input under a
   seeded cotangent, against ``jax.jit`` of the JAX function and of its
   ``jax.vjp``. fp32 throughout; tolerance 1e-5 of the largest magnitude
   (einsums and reductions sum in another order in XLA and ATen); integer
   outputs equal. Where the port's output carries no gradient (a mask, a
   fill) the JAX gradient must be zero.
2. The traps of the JAX arithmetic, each against the JAX package and, where
   there is one, against the PyTorch function it is not: ``top_k``'s and
   ``beam_search``'s tie order, ``max_pool2d_with_index``'s padding and
   ties, ``unpool2d``'s adding collisions, ``hash_embedding_ids`` bit for
   bit (negative ids, the uint32 overflow of a third hash), ``spectral_norm``
   with ``u=None`` by its converged sigma, ``grid_sampler``'s grid gradient
   at integer coordinates, ``add_position_encoding``'s halves, ``spp``'s
   one-wide cells, ``assign_value`` through numpy, ``lookup_table`` as
   ``embedding``.
3. Every wrapper in a Program built by one function over each package: the
   documents equal (one Variable for the ops that return a tuple), then one
   run on the same feeds, every output within 1e-5; ``layers.sum`` over a
   list of Variables raises TypeError in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as jpt
from paddle_tpu import ops as jops
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.ops import misc as tmisc

TOL = 1e-5


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d)."""
    with static_mode_guard(False):
        yield


R = np.random.RandomState(17)


def f(*shape, lo=-2.0, hi=2.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def ints(lo, hi, *shape):
    return R.randint(lo, hi, shape).astype(np.int32)


def _rois():
    """Three RoIs [batch index, x1, y1, x2, y2] over two 9x11 images, one
    reaching past the border."""
    return np.array([[0, 1.3, 0.7, 6.2, 5.9], [1, 0.0, 2.1, 10.4, 8.6],
                     [1, 4.5, 3.2, 12.0, 11.0]], np.float32)


def _pool_indices():
    """unpool2d's indices: one position in each 2x2 window of a 6x6 map, as
    max_pool2d_with_index gives them, then a collision (two windows
    pointing at one position)."""
    dy, dx = R.randint(0, 2, (2, 3, 3, 3)), R.randint(0, 2, (2, 3, 3, 3))
    idx = ((2 * np.arange(3)[:, None] + dy) * 6
           + 2 * np.arange(3)[None] + dx).astype(np.int32)
    idx[:, :, 0, 1] = idx[:, :, 0, 0]
    return idx


#: (op, args, keyword args); float32 array args are differentiated, args
#: that are not arrays pass as they are
CASES = [
    ("add_position_encoding", (f(2, 5, 8),), dict(alpha=0.5, beta=2.0)),
    ("affine_grid", (f(2, 2, 3),), dict(out_shape=(2, 3, 4, 5))),
    ("grid_sampler", (f(2, 3, 5, 6), f(2, 4, 4, 2, lo=-1.2, hi=1.2)), {}),
    ("bilinear_tensor_product", (f(3, 4), f(3, 5), f(6, 4, 5), f(6)), {}),
    ("bilinear_tensor_product", (f(3, 4), f(3, 5), f(2, 4, 5)), {}),
    ("conv_shift", (f(3, 7), f(3, 3)), {}),
    ("row_conv", (f(2, 6, 4), f(3, 4)), {}),
    ("im2sequence", (f(2, 3, 6, 8),), dict(filter_size=[6, 1], stride=1)),
    ("im2sequence", (f(2, 2, 7, 8),), dict(filter_size=3, stride=(2, 1),
                                           padding=1)),
    ("similarity_focus", (f(2, 3, 4, 5),), dict(axis=1, indexes=[0, 2])),
    ("similarity_focus", (f(2, 3, 4, 5),), dict(axis=3, indexes=[4])),
    ("spectral_norm", (f(4, 6), f(4)), dict(power_iters=2)),
    ("spectral_norm", (f(3, 2, 4), f(2)), dict(dim=1, power_iters=3)),
    ("spp", (f(2, 3, 7, 9),), dict(pyramid_height=3, pool_type="max")),
    ("spp", (f(1, 2, 3, 5),), dict(pyramid_height=3, pool_type="avg")),
    ("temporal_shift", (f(6, 8, 3, 3),), dict(seg_num=3)),
    ("temporal_shift", (f(4, 6, 2, 2),), dict(seg_num=2, shift_ratio=0.5)),
    ("max_pool2d_with_index", (f(2, 3, 7, 7),), dict(pool_size=3, stride=2,
                                                     padding=1)),
    ("max_pool2d_with_index", (f(1, 2, 6, 5),), dict(pool_size=2)),
    ("unpool2d", (f(2, 3, 3, 3), _pool_indices()), dict(out_hw=(6, 6))),
    ("squared_l2_distance", (f(4, 3, 2), f(4, 3, 2)), {}),
    ("fsp_matrix", (f(2, 3, 4, 5), f(2, 4, 4, 5)), {}),
    ("hash_embedding_ids", (ints(-50, 10 ** 6, 4, 3),),
     dict(mod=1000, num_hash=2)),
    ("hash_embedding_ids", (ints(0, 99, 5),), dict(mod=7)),
    ("cvm", (f(4, 5, lo=0, hi=3),), dict(use_cvm=True)),
    ("cvm", (f(4, 5, lo=0, hi=3),), dict(use_cvm=False)),
    ("tree_conv", (f(2, 5, 3), np.round(f(2, 5, 5, lo=0, hi=1)),
                   f(3, 3, 4)), dict(max_depth=2)),
    ("nce", (f(4, 6), f(10, 6), f(10), ints(0, 10, 4), ints(0, 10, 5)),
     dict(num_total_classes=10)),
    ("hierarchical_sigmoid", (f(4, 6), f(6, 6), f(6), ints(0, 7, 4)),
     dict(num_classes=7)),
    ("hierarchical_sigmoid", (f(5, 3), f(7, 3), f(7), ints(0, 8, 5)),
     dict(num_classes=8)),
    ("sample_logits", (f(4, 10), ints(0, 10, 4), ints(0, 10, 3)), {}),
    ("gru_unit", (f(3, 12), f(3, 4), f(4, 8), f(4, 4), f(8), f(4)), {}),
    ("gru_unit", (f(3, 12), f(3, 4), f(4, 8), f(4, 4)), {}),
    ("lstm_unit", (f(3, 16), f(3, 4), f(3, 4)), {}),
    ("sum", (f(3, 4), f(3, 4), f(3, 4)), {}),
    ("top_k", (np.round(f(3, 8)),), dict(k=4)),
    ("arg_max", (np.round(f(3, 5)),), dict(axis=1)),
    ("arg_min", (np.round(f(3, 5)),), dict(axis=0)),
    ("fill_any_like", (f(3, 4),), dict(value=2.5)),
    ("fill_zeros_like", (f(3, 4),), {}),
    ("assign_value", (), dict(shape=[2, 3], dtype="float32",
                              values=[1.5, 2, 3, 4, 5, 6.25])),
    ("assign_value", (), dict(shape=[3], dtype="int32",
                              values=[1.9, -2.7, 3])),
    ("smooth_l1_loss", (f(4, 3), f(4, 3)), dict(sigma=2.0)),
    ("lookup_table", (ints(0, 10, 4, 1), f(10, 4)), dict(padding_idx=3)),
    ("lookup_table", (ints(0, 10, 2, 3), f(10, 4)), {}),
    ("deformable_conv", (f(2, 4, 6, 6), f(2, 36, 6, 6, lo=-1, hi=1),
                         f(3, 4, 3, 3)), dict(padding=1,
                                              deformable_groups=2)),
    ("deformable_conv", (f(1, 3, 7, 7), f(1, 8, 3, 3, lo=-1.5, hi=1.5),
                         f(2, 3, 2, 2), 2, 0, 1, f(1, 4, 3, 3, lo=0, hi=1)),
     {}),
    ("average_accumulates", (f(3), f(3), f(3), f(3), np.int32(1),
                             np.int32(1), np.int32(2)),
     dict(average_window=3, max_average_window=4)),
    ("average_accumulates", (f(3), f(3), f(3), f(3), np.int32(3),
                             np.int32(2), np.int32(6)),
     dict(average_window=5, max_average_window=4)),
    ("average_accumulates", (f(3), f(3), f(3), f(3), np.int32(0),
                             np.int32(0), np.int32(0)), {}),
    ("beam_search", (f(6, 5), f(6), ints(0, 5, 6, 2)),
     dict(beam_size=3, end_token=4, length_penalty=0.6, step=2)),
    ("beam_search", (np.round(f(4, 3)), np.zeros(4, np.float32),
                     ints(0, 3, 4, 1)), dict(beam_size=2)),
    ("conv2d_fusion", (f(2, 3, 6, 6), f(4, 3, 3, 3), f(4), f(2, 4, 6, 6)),
     dict(padding=1)),
    ("conv2d_fusion", (f(1, 4, 7, 7), f(4, 2, 3, 3)),
     dict(stride=2, dilation=2, groups=2, act="sigmoid")),
    ("deformable_psroi_pooling", (f(2, 8, 9, 11), _rois(),
                                  f(3, 2, 2, 2, lo=-1, hi=1)),
     dict(output_channels=2, group_size=2, pooled_size=2, part_size=2,
          spatial_scale=1.0, sample_per_part=2, trans_std=0.1)),
    ("deformable_psroi_pooling", (f(2, 12, 9, 11), _rois()[:, 1:], None),
     dict(output_channels=3, group_size=(2, 2), pooled_size=(3, 2),
          spatial_scale=0.5, sample_per_part=3)),
    ("deformable_roi_pooling", (f(2, 3, 9, 11), _rois(),
                                f(3, 2, 3, 3, lo=-1, hi=1)),
     dict(pooled_height=3, pooled_width=3, sample_per_part=2)),
    ("deformable_roi_pooling", (f(2, 8, 9, 11), _rois(), None),
     dict(no_trans=True, group_size=2, pooled_height=2, pooled_width=2,
          position_sensitive=True, spatial_scale=0.75)),
]
LIST_FIRST = {"sum"}
#: keyword arguments only the port takes (a tensor made from nothing goes
#: to the card by default)
PORT_KW = {"assign_value": dict(device="cpu")}


def _outs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _call(mod, name, args, kw):
    fn = getattr(mod, name)
    if name in LIST_FIRST:
        return fn(list(args), **kw)
    return fn(*args, **kw)


def _close(got, want, where, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    assert jax.dtypes.canonicalize_dtype(got.dtype) == want.dtype, \
        (where, got.dtype, want.dtype)
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=where)


def test_the_cases_cover_every_name():
    assert {c[0] for c in CASES} == set(tmisc.__all__)
    assert len(tmisc.__all__) == 38
    assert sorted(tmisc.__all__) == sorted(jops.misc.__all__)
    for n in tmisc.__all__:
        assert getattr(tops, n) is getattr(tmisc, n)


def _is_float(a):
    return isinstance(a, np.ndarray) and a.dtype == np.float32


@pytest.mark.parametrize("k", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_and_gradients_match_jax(k):
    name, args, kw = CASES[k]
    diff = [i for i, a in enumerate(args) if _is_float(a)]
    targs = [torch.tensor(a, requires_grad=i in diff)
             if isinstance(a, (np.ndarray, np.generic)) else a
             for i, a in enumerate(args)]
    got = _outs(_call(tops, name, targs, {**kw, **PORT_KW.get(name, {})}))

    def jfn(*xs):
        full = [jnp.asarray(a) if isinstance(a, (np.ndarray, np.generic))
                else a for a in args]
        for i, x in zip(diff, xs):
            full[i] = x
        return tuple(_outs(_call(jops, name, full, kw)))
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

    def jgrad(*xs):
        _, vjp = jax.vjp(lambda *v: tuple(jfn(*v)[j] for j in floats), *xs)
        return vjp(tuple(jnp.asarray(c) for c in cot))
    jgrads = jax.jit(jgrad)(*dxs)
    if not any(got[j].requires_grad for j in floats):
        # an output without a gradient in the port (a mask, a fill) is a
        # constant of its inputs in JAX too
        for w in jgrads:
            assert not np.any(np.asarray(w)), name
        return
    tgrads = torch.autograd.grad([got[j] for j in floats],
                                 [targs[i] for i in diff],
                                 [torch.tensor(c) for c in cot],
                                 allow_unused=True)
    for i, g, w in zip(diff, tgrads, jgrads):
        g = np.zeros(args[i].shape, np.float32) if g is None else g.numpy()
        _close(g, w, f"{name} gradient of argument {i}")


# ---------------------------------------------------------------------------
# the traps
# ---------------------------------------------------------------------------
def test_top_k_and_beam_search_put_the_lower_index_first_among_ties():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                  [2.0, 2.0, 2.0, 2.0, 1.0, 2.0]], np.float32)
    v, i = tops.top_k(torch.tensor(x), 4)
    jv, ji = jops.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i.dtype == torch.int32
    assert i.tolist() == [[1, 2, 4, 5], [0, 1, 2, 3]]
    lp = np.log(np.full((4, 3), 1.0 / 3.0, np.float32))
    got = tops.beam_search(torch.tensor(lp), torch.zeros(4),
                           torch.zeros(4, 1, dtype=torch.int32), 2)
    want = jops.beam_search(jnp.asarray(lp), jnp.zeros(4),
                            jnp.zeros((4, 1), jnp.int32), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].tolist() == [0, 0, 2, 2] and got[0][:, 1].tolist() == \
        [0, 1, 0, 1]


def test_max_pool_with_index_pads_with_finfo_min_and_takes_the_first_tie():
    """A corner window whose image values are all ``finfo.min`` ties with
    the padding (``finfo.min`` too), and the first element of the window in
    row-major order wins: a padding element, whose index lies outside the
    image, as the JAX op gives it; ``F.max_pool2d`` pads with -inf and
    returns an element of the image there. Ties inside the image take the
    first element too."""
    lo = np.finfo(np.float32).min
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, :2, :2] = lo
    x[0, 0, 2:, 2:] = 1.0
    got = tops.max_pool2d_with_index(torch.tensor(x), 3, 2, 1)
    want = jops.max_pool2d_with_index(jnp.asarray(x), 3, 2, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32
    assert got[1][0, 0, 0, 0] == -5 and got[0][0, 0, 0, 0] == lo
    assert got[1][0, 0, 1, 1] == 10       # the first of the four 1.0s
    ref = F.max_pool2d(torch.tensor(x), 3, 2, 1, return_indices=True)
    assert ref[1][0, 0, 0, 0] >= 0


def test_unpool_adds_colliding_values():
    """Two pooled values pointing at one position add (1e-6 of the largest
    value where they collide: one fp32 sum), where ``F.max_unpool2d``
    keeps one."""
    vals = np.array([[[[1.5, 2.0], [0.5, 4.0]]]], np.float32)
    idx = np.array([[[[5, 5], [10, 15]]]], np.int32)
    got = tops.unpool2d(torch.tensor(vals), torch.tensor(idx), (4, 4))
    want = jops.unpool2d(jnp.asarray(vals), jnp.asarray(idx), (4, 4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * 4.0)
    assert got[0, 0, 1, 1] == 3.5
    ref = F.max_unpool2d(torch.tensor(vals), torch.tensor(idx).long(), 2,
                         output_size=(4, 4))
    assert ref[0, 0, 1, 1] in (1.5, 2.0)


def test_hash_is_bit_for_bit_and_overflows_like_jax():
    ids = np.array([[-1, 0, 5, 2 ** 31 - 1, -7, 123456789]], np.int32)
    for mod, k in ((1000, 1), (2 ** 31 - 1, 2), (97, 2)):
        got = tops.hash_embedding_ids(torch.tensor(ids), mod, k)
        want = jops.hash_embedding_ids(jnp.asarray(ids), mod, k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(OverflowError):
        jops.hash_embedding_ids(jnp.asarray(ids), 1000, 3)
    with pytest.raises(OverflowError):
        tops.hash_embedding_ids(torch.tensor(ids), 1000, 3)


def test_spectral_norm_without_u_converges_to_the_jax_sigma():
    """``u=None``: the first vector is torch's draw (a generator seeded 0),
    not ``PRNGKey(0)``'s; after 60 power iterations both normalize by the
    largest singular value (1e-5 of the largest weight)."""
    w = f(5, 3, 2)
    got, u = tops.spectral_norm(torch.tensor(w), power_iters=60)
    want, _ = jops.spectral_norm(jnp.asarray(w), power_iters=60)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    sigma = np.linalg.svd(w.reshape(5, -1), compute_uv=False)[0]
    np.testing.assert_allclose(w / got.numpy(), sigma, rtol=1e-5)
    again, u2 = tops.spectral_norm(torch.tensor(w), power_iters=1)
    assert torch.equal(tops.spectral_norm(torch.tensor(w))[1], u2)


def test_grid_sampler_matches_grid_sample_and_jax_grad_at_integers():
    """The forward equals ``F.grid_sample(align_corners=True, zeros)``; at
    grid points on integer pixel coordinates (and one past the border) the
    grid gradient is the right-hand difference of the floor-based gathers,
    as ``jax.grad`` gives it."""
    x = f(1, 2, 4, 5)
    px = np.array([0.0, 1.0, 2.0, 4.0, 5.0], np.float32)
    py = np.array([0.0, 1.0, 3.0, 2.0, -1.0], np.float32)
    grid = np.stack([px * 2 / 4 - 1, py * 2 / 3 - 1], -1).reshape(
        1, 1, 5, 2).astype(np.float32)
    gt = torch.tensor(grid, requires_grad=True)
    out = tops.grid_sampler(torch.tensor(x), gt)
    torch.testing.assert_close(out, F.grid_sample(
        torch.tensor(x), torch.tensor(grid), align_corners=True,
        padding_mode="zeros"), rtol=0, atol=1e-6)
    (g,) = torch.autograd.grad(out.sum(), gt)
    want = jax.jit(jax.grad(lambda v: jnp.sum(jops.grid_sampler(
        jnp.asarray(x), v))))(jnp.asarray(grid))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_position_encoding_is_a_sin_half_then_a_cos_half():
    x = np.zeros((1, 4, 6), np.float32)
    got = tops.add_position_encoding(torch.tensor(x)).numpy()[0]
    pos = np.arange(4)[:, None] / 10000.0 ** (np.arange(3) * 2.0 / 6)
    np.testing.assert_allclose(got[:, :3], np.sin(pos), atol=1e-6)
    np.testing.assert_allclose(got[:, 3:], np.cos(pos), atol=1e-6)


def test_spp_cells_are_at_least_one_wide():
    """A 1x3 map at level 2 (4x4 bins): each bin still pools one element,
    as floor(i * size / bins) with a one-element minimum gives them (the
    first row of bins: columns 0, 0, 1, 2)."""
    x = f(1, 1, 1, 3)
    got = tops.spp(torch.tensor(x), 3, "max").numpy()
    _close(got, jops.spp(jnp.asarray(x), 3, "max"), "spp")
    assert got.shape == (1, 21)
    np.testing.assert_array_equal(got[0, 5:9], x[0, 0, 0, [0, 0, 1, 2]])


def test_assign_value_goes_through_numpy():
    got = tops.assign_value([2, 2], "int32", [1.9, -2.7, 3.0, 0.5],
                            device="cpu")
    want = jops.assign_value([2, 2], "int32", [1.9, -2.7, 3.0, 0.5])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[1, -2], [3, 0]]
    assert tops.assign_value([2], torch.float32, [1, 2],
                             device="cpu").dtype == torch.float32


def test_lookup_table_is_embedding():
    ids = torch.tensor([[1], [3], [0]])
    table = torch.tensor(f(5, 3))
    torch.testing.assert_close(tops.lookup_table(ids, table, 3),
                               tops.embedding(ids, table, 3), rtol=0, atol=0)
    assert tops.lookup_table(ids, table, 3)[1].abs().sum() == 0


# ---------------------------------------------------------------------------
# the layers in a Program
# ---------------------------------------------------------------------------
def _misc_net(pt):
    """Every misc wrapper but ``sum`` once, over data Variables and
    parameters (``assign_value`` computes at once: its one tensor argument
    is a shape); returns the outputs."""
    L, I = pt.layers, pt.initializer

    def param(shape, name):
        return L.create_parameter(shape, "float32", attr=pt.ParamAttr(
            name=name, initializer=I.Normal(0.0, 0.5)))
    x = pt.data("x", [3, 6, 6], "float32")
    xp = pt.data("xp", [8, 6, 6], "float32")
    s = pt.data("s", [5, 8], "float32")
    v = pt.data("v", [6], "float32")
    m = pt.data("m", [8], "float32")
    ids = pt.data("ids", [1], "int32")
    lab = pt.data("lab", [], "int32")
    rois = pt.data("rois", [5], "float32")
    idx = pt.data("idx", [3, 3, 3], "int32")
    trans = pt.data("trans", [2, 2, 2], "float32")
    return [
        L.add_position_encoding(s, 0.5, 2.0),
        L.affine_grid(param([2, 2, 3], "theta"), (2, 3, 4, 5)),
        L.grid_sampler(x, param([2, 4, 4, 2], "grid")),
        L.bilinear_tensor_product(v, v, param([3, 6, 6], "btp"),
                                  param([3], "btp_b")),
        L.conv_shift(v, param([2, 3], "cs")),
        L.row_conv(s, param([3, 8], "rc")),
        L.im2sequence(x, [6, 1]),
        L.similarity_focus(x, 1, [0, 2]),
        L.spectral_norm(param([4, 6], "sn"), param([4], "sn_u")),
        L.spp(x, 2),
        L.temporal_shift(x, 1),
        L.max_pool2d_with_index(x, 2),
        L.unpool2d(L.pool2d(x, 2, "max", 2), idx, (6, 6)),
        L.squared_l2_distance(s, L.scale(s, 0.5)),
        L.fsp_matrix(x, L.scale(x, 2.0)),
        L.hash_embedding_ids(ids, 1000, 2),
        L.cvm(L.abs(s)),
        L.tree_conv(s, param([2, 5, 5], "edges"), param([2, 8, 4], "tw")),
        L.nce(m, param([9, 8], "nce_w"), param([9], "nce_b"), lab,
              L.assign_value([4], "int32", [0, 3, 5, 8]), 9),
        L.hierarchical_sigmoid(m, param([6, 8], "hs_w"), param([6], "hs_b"),
                               lab, 7),
        L.sample_logits(m, lab, L.assign_value([3], "int32", [1, 2, 7])),
        L.gru_unit(param([2, 12], "gx"), param([2, 4], "gh"),
                   param([4, 8], "gw"), param([4, 4], "gc")),
        L.lstm_unit(param([2, 16], "lx"), param([2, 4], "lh"),
                    param([2, 4], "lc")),
        L.top_k(s, 3),
        L.arg_max(s, 1),
        L.arg_min(s, 0),
        L.fill_any_like(s, 2.5),
        L.fill_zeros_like(s),
        L.smooth_l1_loss(s, L.scale(s, 0.5), 2.0),
        L.lookup_table(ids, param([1000, 3], "table")),
        L.deformable_conv(x, param([2, 18, 6, 6], "dc_off"),
                          param([2, 3, 3, 3], "dc_w"), padding=1),
        L.average_accumulates(v, v, v, v, 1, 1, 2, 3, 4),
        L.beam_search(param([6, 5], "bs_lp"), param([6], "bs_sc"),
                      L.assign_value([6, 1], "int32", [0, 1, 2, 3, 4, 0]),
                      3),
        L.conv2d_fusion(x, param([4, 3, 3, 3], "cf_w"), param([4], "cf_b"),
                        padding=1),
        L.deformable_psroi_pooling(xp, rois, trans, 2, 2, 2, part_size=2,
                                   sample_per_part=2),
        L.deformable_roi_pooling(x, rois, L.scale(trans, 0.5),
                                 pooled_height=2, pooled_width=2),
    ]


def _build(pt, unique_name):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        outs = _misc_net(pt)
    return main, startup, outs


def _feed():
    rng = np.random.RandomState(5)
    rois = _rois()
    rois[:, 1:] *= 0.6
    return {"x": rng.randn(2, 3, 6, 6).astype(np.float32),
            "xp": rng.randn(2, 8, 6, 6).astype(np.float32),
            "s": rng.randn(2, 5, 8).astype(np.float32),
            "v": rng.randn(2, 6).astype(np.float32),
            "m": rng.randn(2, 8).astype(np.float32),
            "ids": rng.randint(-3, 1000, (2, 1)).astype(np.int32),
            "lab": rng.randint(0, 7, 2).astype(np.int32),
            "rois": rois,
            "idx": rng.randint(0, 36, (2, 3, 3, 3)).astype(np.int32),
            "trans": rng.uniform(-1, 1, (3, 2, 2, 2)).astype(np.float32)}


def test_layers_build_and_run_like_jax():
    from paddle_tpu.static import serialize as jser
    from paddle_tpu_torch.static import serialize as tser
    tm, ts, touts = _build(tpt, tpt.unique_name)
    jm, js, jouts = _build(jpt, junique)
    assert tser.program_to_dict(ts) == jser.program_to_dict(js)
    assert tser.program_to_dict(tm) == jser.program_to_dict(jm)
    # one Variable each, also for the ops that return a tuple
    assert all(not isinstance(o, (tuple, list)) for o in touts)
    assert [o.name for o in touts] == [o.name for o in jouts]
    assert [tuple(o.shape) for o in touts] == [tuple(o.shape) for o in jouts]
    jscope, jexe = jpt.static.Scope(), jpt.static.Executor(jpt.CPUPlace())
    jexe.run(js, scope=jscope)
    names = [n for n, v in js.global_block().vars.items() if v.persistable]
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in names}, "cpu", ts)
    fetch = [o.name for o in touts]
    got = tpt.Executor(tpt.CPUPlace()).run(tm, feed=_feed(),
                                           fetch_list=fetch, scope=tscope)
    want = jexe.run(jm, feed=_feed(), fetch_list=fetch, scope=jscope)
    for n, g, w in zip(fetch, got, want):
        if n == "top_k.out":
            # lax.top_k returns a list, which the JAX op's compute keeps as
            # one value: its run gives [values, indices] stacked (as
            # numpy floats) where the document declares the values' shape;
            # the port's op gives the values (ROADMAP queue 3 note o)
            assert w.shape == (2,) + g.shape
            w = w[0].astype(np.float32)
        _close(g, w, n)


def test_layers_sum_of_variables_raises_in_both():
    """``layers.sum`` takes its list as one tensor argument: a list of
    Variables in a Program is refused with TypeError by both packages'
    wrappers (``sums`` is the list op); outside a Program it sums."""
    for pt in (tpt, jpt):
        with pt.program_guard(pt.Program(), pt.Program()):
            a = pt.data("a", [3], "float32")
            with pytest.raises(TypeError):
                pt.layers.sum([a, a])
    xs = [torch.tensor(f(2, 3)) for _ in range(3)]
    torch.testing.assert_close(tpt.layers.sum(xs), xs[0] + xs[1] + xs[2])
