"""The port's detection op family (``ops/detection.py``) and interpolation
ops (``ops/nn.py``) against the JAX package, on the CPU.

One parametrised test per module part, one case per public name, each name
over the inputs of ``tests/test_ops_detection.py`` and the cases where the
JAX result hangs on an order or a tie: equal scores, all-zero ``yolo_box``
scores, equal IoUs in matching, ``nms_eta`` < 1, ``background_label`` -1
and 0, ``keep_top_k`` above and below the candidate count, padded gt rows
in ``ssd_loss``, the last-writer targets of ``yolov3_loss`` (zero padding
rows after a real box in cell (0, 0), two boxes in one cell in both
orders), and non-integer and down-sampling resizes. Then the input
gradients against ``jax.grad``, host reads refused around the fixed-trip
functions, and the static wrappers (a Program per op in both packages:
documents equal, and the port's Program computing what its op computes;
``multi_box_head``'s parameter names in a Program and in the module
context).

Tolerances: float values within 1e-5 of the largest magnitude of the JAX
result (or of 1); NMS labels, kept sets and -1 padding rows, indices,
masks and the host functions' outputs exact. The observed gaps are in
CHANGES.md.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import layers as jlayers
from paddle_tpu import nn as jnn
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.ops import detection as JD
from paddle_tpu.ops import nn as jnn_ops
from paddle_tpu.static import serialize as jser
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops import detection as TD
from paddle_tpu_torch.ops import nn as tnn_ops
from paddle_tpu_torch.static import serialize as tser

TOL = 1e-5


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d). The port's CPU
    ops take two threads here (set back after): these small shapes gain
    nothing from more, and the suite's other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        with static_mode_guard(False):
            yield
    finally:
        torch.set_num_threads(threads)


R = np.random.RandomState(15)


def f(*shape, lo=-2.0, hi=2.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def boxes(n, size=1.0, lead=()):
    xy = R.uniform(0, 0.6 * size, lead + (n, 2))
    wh = R.uniform(0.1 * size, 0.4 * size, lead + (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


class C:
    """One call: positional and keyword arguments; numpy arrays (alone or
    in a list of arrays) become tensors of each package."""

    def __init__(self, *args, **kw):
        self.args, self.kw = args, kw


def _conv(v, to):
    if isinstance(v, np.ndarray):
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
    if isinstance(x, float):
        return np.asarray(x)
    return np.asarray(x)


def _close(got, want, where, exact=False):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), where
        for k, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{k}]", exact)
        return
    assert got.shape == want.shape, (where, got.shape, want.shape)
    assert jax.dtypes.canonicalize_dtype(got.dtype) == \
        jax.dtypes.canonicalize_dtype(want.dtype), \
        (where, got.dtype, want.dtype)
    if exact or not np.issubdtype(want.dtype, np.inexact):
        np.testing.assert_array_equal(got, want, err_msg=where)
        return
    scale = max(1.0, float(np.max(np.abs(want[np.isfinite(want)]),
                                  initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=where)


def _nms_equal(got, want, where):
    """NMS outputs: labels, kept sets and -1 rows exact; scores and boxes
    within the tolerance."""
    assert got.shape == want.shape, (where, got.shape, want.shape)
    np.testing.assert_array_equal(got[..., 0], want[..., 0], err_msg=where)
    pad = want[..., 0] < 0
    np.testing.assert_array_equal(got[pad], want[pad], err_msg=where)
    _close(got, want, where)


class _Slot:
    def __init__(self, i):
        self.i = i


def _jit(fn, args, kw, transform=None):
    """``fn(*args, **kw)`` in JAX under one ``jax.jit`` over its numpy
    arrays (a whole function compiles once; eager JAX compiles op by op,
    several times slower here). ``transform`` wraps the closure first
    (``jax.grad``)."""
    arrays = []

    def mark(v):
        if isinstance(v, np.ndarray):
            arrays.append(v)
            return _Slot(len(arrays) - 1)
        if isinstance(v, (list, tuple)) and v and all(
                isinstance(x, np.ndarray) for x in v):
            return type(v)(mark(x) for x in v)
        return v

    margs = [mark(a) for a in args]
    mkw = {k: mark(v) for k, v in kw.items()}

    def fill(v, xs):
        if isinstance(v, _Slot):
            return xs[v.i]
        if isinstance(v, (list, tuple)) and v and all(
                isinstance(x, _Slot) for x in v):
            return type(v)(xs[x.i] for x in v)
        return v

    def run(*xs):
        return fn(*[fill(a, xs) for a in margs],
                  **{k: fill(v, xs) for k, v in mkw.items()})
    return jax.jit(transform(run) if transform else run)(*arrays)


def _call(fn_j, fn_t, c):
    want = _jit(fn_j, c.args, c.kw)
    got = fn_t(*[_conv(a, torch.tensor) for a in c.args],
               **{n: _conv(v, torch.tensor) for n, v in c.kw.items()})
    return _np(got), _np(want)


def _run(name, cases, nms=False, exact=False):
    for k, c in enumerate(cases):
        got, want = _call(getattr(JD, name), getattr(TD, name), c)
        if nms:
            _nms_equal(got, want, f"{name} case {k}")
        else:
            _close(got, want, f"{name} case {k}", exact)


# ---------------------------------------------------------------------------
# module 1: box utilities, priors and anchors
# ---------------------------------------------------------------------------
FEAT = np.zeros((2, 8, 4, 4), np.float32)
IMG = np.zeros((2, 3, 32, 32), np.float32)
# MobileNet-SSD's first and second maps at 300^2 (19^2 and 10^2)
M11 = np.zeros((1, 4, 19, 19), np.float32)
M13 = np.zeros((1, 4, 10, 10), np.float32)
IMG300 = np.zeros((1, 3, 300, 300), np.float32)

BOX_CASES = {
    "iou_similarity": [C(boxes(5), boxes(7)), C(boxes(4, lead=(2,)),
                                                boxes(6)),
                       C(boxes(5, 30.0), boxes(3, 30.0),
                         box_normalized=False),
                       C(boxes(3), np.zeros((2, 4), np.float32))],
    "box_clip": [C(np.array([[-5.0, -5.0, 50.0, 80.0]], np.float32),
                   np.array([[40.0, 60.0, 1.0]], np.float32)),
                 C(boxes(6, 80.0, lead=(2,)) - 10.0,
                   np.array([[40.0, 60.0, 1.0], [64.0, 32.0, 2.0]],
                            np.float32)),
                 C(boxes(4, 50.0), np.array([30.0, 40.0, 1.5], np.float32))],
    "polygon_box_transform": [C(f(2, 8, 3, 5))],
    "box_coder": [
        C(boxes(6), np.full((6, 4), 0.1, np.float32), boxes(4),
          "encode_center_size"),
        C(boxes(6), np.full((6, 4), 0.1, np.float32), f(3, 6, 4, lo=-0.5,
                                                          hi=0.5),
          "decode_center_size"),
        C(boxes(6), None, f(6, 4, lo=-0.5, hi=0.5), "decode_center_size",
          axis=1, variance=[0.1, 0.1, 0.2, 0.2]),
        C(boxes(5, 40.0), None, f(2, 5, 4, lo=-0.5, hi=0.5),
          "decode_center_size", box_normalized=False),
        C(boxes(5, 40.0), None, boxes(3, 40.0), "encode",
          box_normalized=False, variance=[0.1, 0.1, 0.2, 0.2])],
    "prior_box": [
        C(FEAT, IMG, min_sizes=[4.0], max_sizes=[8.0], aspect_ratios=[2.0],
          flip=True, clip=True),
        C(FEAT, IMG, min_sizes=[4.0, 6.0], max_sizes=[8.0, 9.0],
          aspect_ratios=[2.0, 3.0], flip=True,
          min_max_aspect_ratios_order=True, steps=(7.0, 9.0), offset=0.3),
        C(M11, IMG300, [60.0], [], [2.0], [0.1, 0.1, 0.2, 0.2], True),
        C(M13, IMG300, [105.0], [150.0], [2.0, 3.0], [0.1, 0.1, 0.2, 0.2],
          True)],
    "density_prior_box": [
        C(FEAT, IMG, densities=[2, 1], fixed_sizes=[4.0, 8.0],
          fixed_ratios=[1.0, 2.0]),
        C(FEAT, IMG, densities=[3], fixed_sizes=[5.0], fixed_ratios=[0.5],
          clip=True, flatten_to_2d=True, steps=(8.0, 8.0))],
    "anchor_generator": [
        C(FEAT, anchor_sizes=[32.0, 64.0], aspect_ratios=[1.0],
          stride=[16.0, 16.0]),
        C(np.zeros((1, 8, 3, 5), np.float32)),
        C(FEAT, anchor_sizes=[24.0], aspect_ratios=[0.5, 2.0],
          stride=[8.0, 12.0], offset=0.0)],
}


@pytest.mark.parametrize("name", sorted(BOX_CASES))
def test_box_utilities_and_priors_match_jax(name):
    _run(name, BOX_CASES[name])


def test_ssd_priors_are_the_published_count_and_equal():
    """MobileNet-SSD's six maps at 300^2 with the source's head settings
    give 1,917 priors, within an fp32 ulp of the JAX package's."""
    maps = [19, 10, 5, 3, 2, 1]
    mins = [60.0, 105.0, 150.0, 195.0, 240.0, 285.0]
    maxs = [[], 150.0, 195.0, 240.0, 285.0, 300.0]
    ars = [[2.0]] + [[2.0, 3.0]] * 5
    total = 0
    for s, mn, mx, ar in zip(maps, mins, maxs, ars):
        feat = np.zeros((1, 1, s, s), np.float32)
        mx = mx if isinstance(mx, list) else [mx]
        got = TD.prior_box(torch.tensor(feat), torch.tensor(IMG300), [mn],
                           mx, ar, flip=True)[0].numpy()
        want = np.asarray(JD.prior_box(feat, IMG300, [mn], mx, ar,
                                       flip=True)[0])
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
        total += got.shape[0] * got.shape[1] * got.shape[2]
    assert total == 1917


# ---------------------------------------------------------------------------
# module 2: matching, NMS and the SSD loss
# ---------------------------------------------------------------------------
def _nms_inputs(b, m, c, size=1.0, tie=False):
    bx = boxes(m, size, lead=(b,))
    sc = R.rand(b, c, m).astype(np.float32)
    if tie:
        sc = np.round(sc * 4) / 4          # many equal scores
    return bx, sc


_TIE_IOU = np.array([[0.5, 0.5, 0.2, 0.5],
                     [0.5, 0.5, 0.5, 0.1],
                     [0.3, 0.5, 0.5, 0.5]], np.float32)

MATCH_CASES = {
    "bipartite_match": [
        C(np.array([[0.9, 0.1, 0.3], [0.6, 0.8, 0.2]], np.float32)),
        C(np.array([[0.9, 0.1, 0.6], [0.6, 0.8, 0.2]], np.float32),
          "per_prediction", 0.5),
        C(R.rand(3, 4, 9).astype(np.float32), "per_prediction", 0.3),
        C(_TIE_IOU),                               # equal IoUs
        C(np.stack([_TIE_IOU, _TIE_IOU[::-1]]), "per_prediction", 0.4),
        C(np.zeros((2, 5), np.float32))],
    "target_assign": [
        C(np.arange(12, dtype=np.float32).reshape(1, 3, 4),
          np.array([[2, -1, 0]], np.int32), mismatch_value=9.0),
        C(f(2, 4, 3), np.array([[3, -1, 0, 1, -1], [-1, -1, 2, 2, 0]],
                               np.int32),
          np.array([[0, 1, 0, 0, 1], [1, 0, 0, 0, 0]], np.int32)),
        C(f(4, 2), np.array([[1, -1, 0], [3, 2, -1]], np.int32))],
    "mine_hard_examples": [
        C(R.rand(2, 9).astype(np.float32), None,
          np.array([[2, -1, -1, 0, -1, -1, -1, -1, -1],
                    [-1, -1, -1, -1, 1, -1, -1, -1, -1]], np.int32),
          R.rand(2, 9).astype(np.float32) * 0.8),
        C(np.full((1, 6), 0.5, np.float32), R.rand(1, 6).astype(np.float32),
          np.array([[0, -1, -1, -1, -1, -1]], np.int32),
          np.full((1, 6), 0.1, np.float32), 2.0, 0.5, 3, "hard_example"),
        C(np.array([[0.9, 0.8, 0.7, 0.6, 0.5]], np.float32),
          np.array([[0.9, 0.8, 0.7, 0.6, 0.5]], np.float32),
          np.array([[2, -1, -1, -1, -1]], np.int32),
          np.full((1, 5), 0.1, np.float32), sample_size=4,
          mining_type="hard_example")],
}


@pytest.mark.parametrize("name", sorted(MATCH_CASES))
def test_matching_matches_jax(name):
    _run(name, MATCH_CASES[name], exact=name != "target_assign")


def _nms_cases():
    bx, sc = _nms_inputs(2, 12, 4)
    tb, ts = _nms_inputs(2, 10, 3, tie=True)
    pb, ps = _nms_inputs(1, 9, 3, size=40.0)
    return [
        C(np.array([[[0, 0, 10, 10], [0.5, 0.5, 10.5, 10.5],
                     [50, 50, 60, 60]]], np.float32),
          np.array([[[0, 0, 0], [0.9, 0.8, 0.7]]], np.float32),
          background_label=0, score_threshold=0.1, nms_top_k=3,
          nms_threshold=0.5, keep_top_k=5),
        C(bx, sc, background_label=0, score_threshold=0.2, nms_top_k=8,
          nms_threshold=0.4, keep_top_k=6),            # keep below count
        C(bx, sc, background_label=-1, score_threshold=0.05, nms_top_k=5,
          nms_threshold=0.3, keep_top_k=40),           # keep above count
        C(tb, ts, background_label=-1, score_threshold=0.2, nms_top_k=10,
          nms_threshold=0.5, keep_top_k=12),           # tied scores
        C(tb, ts, background_label=1, score_threshold=0.0, nms_top_k=-1,
          nms_threshold=0.7, keep_top_k=-1, nms_eta=0.9),
        C(bx, sc, score_threshold=0.1, nms_top_k=12, nms_threshold=0.9,
          keep_top_k=10, nms_eta=0.7),                 # eta < 1
        C(pb, ps, score_threshold=0.3, nms_threshold=0.3, keep_top_k=8,
          normalized=False),
        C(bx, np.zeros_like(sc), background_label=-1, score_threshold=0.0,
          keep_top_k=4),                               # nothing passes
        C(bx, np.full_like(sc, 0.5), background_label=-1,
          score_threshold=0.1, nms_top_k=6, nms_threshold=0.5,
          keep_top_k=20)]                              # every score tied


def test_multiclass_nms_matches_jax():
    _run("multiclass_nms", _nms_cases(), nms=True)


def test_detection_output_matches_jax():
    pri = boxes(8)
    var = np.full((8, 4), 0.1, np.float32)
    loc = f(2, 8, 4) * 0.1
    sc = R.rand(2, 8, 3).astype(np.float32)
    sm = np.exp(sc) / np.exp(sc).sum(-1, keepdims=True)
    _run("detection_output", [
        C(loc, sc, pri, var, keep_top_k=4),
        C(loc, sm, pri, var, nms_threshold=0.45, keep_top_k=30,
          score_threshold=0.01),
        C(loc, sm, pri, var, background_label=-1, nms_top_k=5,
          nms_eta=0.8)], nms=True)


def _ssd_cases():
    pri = boxes(12)
    var = np.full((12, 4), 0.1, np.float32)
    gt = np.stack([pri[2], pri[7]])[None]
    padded = np.concatenate([np.stack([pri[0], pri[5] * 0.9 + 0.02])[None],
                             np.zeros((1, 3, 4), np.float32)], 1)
    two = np.concatenate([gt, padded[:, :2]], 0)
    return [
        C(f(1, 12, 4) * 0.05, f(1, 12, 3), gt,
          np.array([[1, 2]], np.int32), pri),
        C(f(2, 12, 4) * 0.1, f(2, 12, 4), two,
          np.array([[1, 3], [2, 1]], np.int32), pri, var),
        C(f(1, 12, 4) * 0.1, f(1, 12, 3), padded,
          np.array([[1, 2, -1, -1, -1]], np.int32), pri, var),
        C(f(1, 12, 4) * 0.1, f(1, 12, 3), padded[:, :2],
          np.array([[1, 2]], np.int32), pri, var),
        C(f(2, 12, 4) * 0.1, f(2, 12, 4), two,
          np.array([[1, 3], [2, 1]], np.int32)[..., None], pri,
          match_type="bipartite", normalize=False, neg_pos_ratio=2.0,
          sample_size=3, loc_loss_weight=0.5, conf_loss_weight=2.0)]


def test_ssd_loss_matches_jax_with_padded_gt():
    cases = _ssd_cases()
    _run("ssd_loss", cases)
    # padding rows change nothing (the JAX package's own regression)
    a = _call(JD.ssd_loss, TD.ssd_loss, cases[2])[0]
    b = _call(JD.ssd_loss, TD.ssd_loss, C(*cases[2].args[:2],
                                          cases[3].args[2],
                                          cases[3].args[3],
                                          *cases[2].args[4:]))[0]
    np.testing.assert_allclose(a, b, rtol=1e-6)


# ---------------------------------------------------------------------------
# module 3: the YOLO head and the focal loss
# ---------------------------------------------------------------------------
ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


def _yolo_x(b, na, cnum, h, w, scale=1.0):
    return f(b, na * (5 + cnum), h, w) * scale


def _cell00_gt(order=None, pad=0):
    """One box in cell (0, 0), optionally a second box in the same cell
    (``order`` 0 or 1 puts it before or after), then ``pad`` zero rows."""
    rows = [[0.05, 0.06, 0.3, 0.25]]
    if order is not None:
        second = [0.07, 0.04, 0.12, 0.2]
        rows = rows + [second] if order else [second] + rows
    rows += [[0.0] * 4] * pad
    gt = np.array([rows], np.float32)
    lab = np.array([[1, 2][:len(rows) - pad] + [0] * pad], np.int32) \
        if order is not None else np.array([[1] + [0] * pad], np.int32)
    return gt, lab


def _yolov3_cases():
    gt = np.zeros((2, 3, 4), np.float32)
    gt[:, 0] = [0.5, 0.5, 0.3, 0.3]
    gt[1, 1] = [0.2, 0.7, 0.1, 0.4]
    gtl = np.array([[0, 0, 0], [3, 1, 0]], np.int32)
    kw = dict(anchors=ANCHORS, class_num=4, ignore_thresh=0.7)
    return [
        C(_yolo_x(2, 2, 4, 4, 4), gt, gtl, anchor_mask=[0, 1],
          downsample_ratio=8, **kw),
        C(_yolo_x(2, 3, 4, 4, 4), gt, gtl, anchor_mask=[3, 4, 5],
          downsample_ratio=16, gt_score=R.rand(2, 3).astype(np.float32),
          **kw),
        C(_yolo_x(2, 3, 4, 2, 3), gt, gtl[..., None], anchor_mask=[0, 2, 4],
          downsample_ratio=32, use_label_smooth=False, **kw),
        C(np.zeros((2, 3 * 9, 4, 4), np.float32), gt, gtl,
          anchor_mask=[0, 1, 2], downsample_ratio=8, **kw),   # tie at 0
        C(_yolo_x(2, 2, 4, 4, 4), np.zeros_like(gt), gtl,
          anchor_mask=[0, 1], downsample_ratio=8, **kw)]      # no gt


def test_yolov3_loss_matches_jax():
    _run("yolov3_loss", _yolov3_cases())


def test_yolov3_loss_last_writer_targets_match_jax():
    """The JAX function's last-writer scatter (ROADMAP queue 3 note k):
    zero padding rows after a real box in cell (0, 0) erase its target, and
    two boxes in one cell give the later row's; both packages agree in each
    case, and the cases differ as the JAX package makes them differ."""
    x = _yolo_x(1, 3, 4, 4, 4)
    kw = dict(anchors=ANCHORS, anchor_mask=[0, 1, 2], class_num=4,
              ignore_thresh=0.7, downsample_ratio=8)
    got = {}
    for key, (order, pad) in {"alone": (None, 0), "padded": (None, 2),
                              "first": (0, 0), "second": (1, 0)}.items():
        gt, lab = _cell00_gt(order, pad)
        t, j = _call(JD.yolov3_loss, TD.yolov3_loss, C(x, gt, lab, **kw))
        _close(t, j, key)
        got[key] = float(j[0])
    assert got["padded"] != pytest.approx(got["alone"], rel=1e-3)
    assert got["first"] != pytest.approx(got["second"], rel=1e-4)


def test_yolo_box_and_focal_loss_match_jax():
    img = np.array([[64, 64], [48, 80]], np.int32)
    zero = np.zeros((2, 2 * 8, 3, 3), np.float32)
    zero[:, 4] = 5.0
    _run("yolo_box", [
        C(_yolo_x(2, 2, 3, 3, 3), img, anchors=[10, 10, 20, 20],
          class_num=3, conf_thresh=0.5, downsample_ratio=32),
        C(_yolo_x(2, 3, 3, 4, 2, 3.0), img, anchors=ANCHORS[:6],
          class_num=3, conf_thresh=0.005, downsample_ratio=16),
        C(zero, img, anchors=[10, 10, 20, 20], class_num=3,
          conf_thresh=0.5, downsample_ratio=32)])     # all-zero scores
    _run("sigmoid_focal_loss", [
        C(np.array([[2.0, -2.0], [-1.0, 3.0]], np.float32),
          np.array([1, 0], np.int32), 1),
        C(f(6, 4, lo=-3, hi=3), np.array([0, 1, 4, 2, 0, 3], np.int32),
          np.array([3.0], np.float32), gamma=1.5, alpha=0.4),
        C(np.zeros((3, 2), np.float32), np.array([1, 0, 2], np.int32),
          0.0)])


def test_yolo_box_all_zero_scores_tie_in_nms():
    """``yolo_box`` zeroes every score at or below conf_thresh: NMS over
    them sees many equal keys, and both packages keep the same rows."""
    x = _yolo_x(2, 3, 3, 4, 4, 2.0)
    img = np.array([[64, 64], [64, 64]], np.int32)
    res = []
    for mod in (JD, TD):
        def nms(x, img, mod=mod):
            b, s = mod.yolo_box(x, img, ANCHORS[:6], 3, 0.8, 16)
            s_t = jnp.swapaxes(s, 1, 2) if mod is JD else s.transpose(1, 2)
            return mod.multiclass_nms(b, s_t, background_label=-1,
                                      score_threshold=-1.0, nms_top_k=-1,
                                      keep_top_k=-1)
        res.append(_np(_jit(nms, (x, img), {}) if mod is JD
                       else nms(torch.tensor(x), torch.tensor(img))))
    assert (res[1][..., 1] == 0).sum() > 5
    _nms_equal(res[1], res[0], "nms over yolo_box")


# ---------------------------------------------------------------------------
# module 4: the RoI ops
# ---------------------------------------------------------------------------
def _quads(r, size):
    c = R.uniform(0.3 * size, 0.7 * size, (r, 1, 2))
    off = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    q = c + off[None] * R.uniform(0.1 * size, 0.25 * size, (r, 4, 2))
    return q.reshape(r, 8).astype(np.float32)


ROI_CASES = {
    "roi_align": [
        C(np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4),
          np.array([[0.0, 0.0, 3.0, 3.0]], np.float32), 2, 2, 1.0, 1),
        C(f(2, 3, 8, 9), boxes(5, 16.0), 3, 2, 0.5, -1,
          np.array([0, 1, 1, 0, 1], np.int32)),
        C(f(1, 2, 6, 6), boxes(3, 6.0) - 1.0, 2, 3, 1.0, 3)],
    "roi_pool": [
        C(np.pad(np.array([[[[7.0]]]], np.float32),
                 ((0, 0), (0, 0), (1, 2), (1, 2))),
          np.array([[0.0, 0.0, 3.0, 3.0]], np.float32), 1, 1, 1.0),
        C(f(2, 3, 8, 9), boxes(4, 16.0), 2, 3, 0.5,
          np.array([1, 0, 1, 1], np.int32)),
        C(np.stack([np.zeros((1, 3, 3)), np.ones((1, 3, 3))]).astype(
            np.float32), np.array([[0, 0, 2, 2], [0, 0, 2, 2]], np.float32),
          1, 1, 1.0, roi_batch_indices=[0, 1])],
    # bins of power-of-two widths: a bin edge that is an integer in exact
    # arithmetic (the last bin's end is the RoI's end) is one in fp32 too,
    # so its floor and ceil do not hang on how XLA rounds x1 + k * bin
    "psroi_pool": [
        C(f(1, 4, 6, 6), np.array([[0.0, 0.0, 5.0, 5.0]], np.float32), 1,
          1.0, 2, 2),
        C(f(2, 2 * 2 * 2, 7, 8), boxes(4, 8.0), 2, 0.5, 2, 2,
          np.array([0, 1, 1, 0], np.int32))],
    "roi_perspective_transform": [
        C(f(2, 3, 10, 12), np.array([[2, 2, 10, 2, 10, 6, 2, 6],
                                     [0, 4, 16, 4, 16, 12, 0, 12]],
                                    np.float32), 5, 9, 0.5,
          np.array([1, 0], np.int32))],
}


@pytest.mark.parametrize("name", sorted(ROI_CASES))
def test_roi_ops_match_jax(name):
    _run(name, ROI_CASES[name])


def test_roi_perspective_transform_over_general_quads_matches_jax():
    """Quads that are no rectangle: the output's border pixels map onto the
    quad's edges, where the point-in-quad test hangs on the last bit of
    the homography, so the JAX function runs op by op (as the port does),
    not as one XLA program whose fused arithmetic rounds otherwise."""
    x, q = f(1, 2, 8, 8), _quads(3, 8.0)
    want = JD.roi_perspective_transform(x, q, 4, 5)
    got = TD.roi_perspective_transform(torch.tensor(x), torch.tensor(q), 4,
                                       5)
    _close(_np(got), _np(want), "roi_perspective_transform")


# ---------------------------------------------------------------------------
# module 5: proposals, FPN and the RetinaNet output
# ---------------------------------------------------------------------------
def _proposal_inputs(scale=1.0):
    h = w = 4
    anchors, var = JD.anchor_generator(
        np.zeros((1, 8, h, w), np.float32), anchor_sizes=[16.0, 32.0, 64.0],
        aspect_ratios=[1.0], stride=[8.0, 8.0])
    return (R.rand(2, 3, h, w).astype(np.float32),
            f(2, 12, h, w) * 0.1, np.array([[32.0, 32.0, 1.0],
                                            [64.0, 48.0, scale]],
                                           np.float32),
            np.asarray(anchors), np.asarray(var))


def test_proposals_match_jax():
    sc, dl, info, anc, var = _proposal_inputs(2.0)
    _run("generate_proposals", [
        C(sc, dl, info, anc, var, pre_nms_top_n=20, post_nms_top_n=8,
          nms_thresh=0.7, min_size=1.0),
        C(sc, dl, info, anc, var, pre_nms_top_n=30, post_nms_top_n=30,
          nms_thresh=0.5, min_size=4.0, eta=0.8)])
    rois = np.concatenate([boxes(4, 32.0), boxes(4, 32.0) * 8])
    _run("distribute_fpn_proposals", [
        C(rois, min_level=2, max_level=5, refer_level=4, refer_scale=224),
        C(rois, 3, 4, 4, 56)])
    multi = [boxes(5, 32.0), boxes(3, 32.0)]
    scores = [R.rand(5).astype(np.float32), R.rand(3).astype(np.float32)]
    masks = [np.array([1, 0, 1, 1, 0], bool), np.array([1, 1, 0], bool)]
    _run("collect_fpn_proposals", [
        C(multi, scores, 2, 3, 4),
        C(multi, scores, 2, 3, 10, valid_masks=masks)])


def test_box_decoder_and_retinanet_output_match_jax():
    pri = boxes(5, 30.0)
    _run("box_decoder_and_assign", [
        C(pri, np.full((5, 4), 0.1, np.float32), f(5, 12) * 0.1,
          R.rand(5, 3).astype(np.float32)),
        C(pri, np.full((5, 4), 0.2, np.float32), f(5, 8) * 3.0,
          np.array([[0.1, 0.5], [0.2, 0.2], [0.9, 0.1], [0.3, 0.3],
                    [0.0, 0.0]], np.float32), box_clip_value=1.0)])
    levels = [f(2, n, 4) * 0.1 for n in (6, 4)]
    anchors = [boxes(n, 50.0) for n in (6, 4)]
    scores = [R.rand(2, n, 3).astype(np.float32) for n in (6, 4)]
    _run("retinanet_detection_output", [
        C(levels, scores, anchors, np.array([[64.0, 64.0, 1.0],
                                             [40.0, 56.0, 1.0]], np.float32),
          keep_top_k=5),
        C(levels, scores, anchors, np.array([[64.0, 64.0, 1.0],
                                             [40.0, 56.0, 2.0]], np.float32),
          score_threshold=0.3, nms_top_k=4, keep_top_k=12, nms_eta=0.5)],
        nms=True)


# ---------------------------------------------------------------------------
# module 6: the host functions (numpy in both packages): equal, bitwise
# ---------------------------------------------------------------------------
def _anchors16():
    a, _ = JD.anchor_generator(np.zeros((1, 8, 4, 4), np.float32),
                               anchor_sizes=[16.0], aspect_ratios=[1.0],
                               stride=[8.0, 8.0])
    return np.asarray(a).reshape(-1, 4)


def _host_cases():
    anc = _anchors16()
    gts = np.array([[4.0, 4.0, 20.0, 20.0], [8.0, 8.0, 24.0, 24.0]],
                   np.float32)
    info = np.array([32.0, 32.0, 1.0], np.float32)
    rois = boxes(10, 30.0)
    gt2 = boxes(2, 30.0)
    det = np.array([[[1, 0.9, 0, 0, 10, 10], [2, 0.8, 20, 20, 30, 30],
                     [1, 0.7, 1, 1, 9, 11], [-1, -1, -1, -1, -1, -1]],
                    [[2, 0.6, 0, 0, 10, 10], [1, 0.95, 2, 2, 12, 12],
                     [2, 0.5, 19, 21, 31, 29], [1, 0.4, 40, 40, 50, 50]]],
                   np.float32)
    # per-image gt as lists (a 2-D gt_label array is one image's rows to
    # the JAX function)
    gl = [np.array([1, 2]), np.array([1, 2])]
    gb = [np.array([[0, 0, 10, 10], [20, 20, 30, 30]], np.float32),
          np.array([[1, 1, 11, 11], [20, 20, 30, 30]], np.float32)]
    segs = [[[2.0, 2.0, 14.0, 2.0, 14.0, 12.0, 2.0, 12.0]],
            [np.array([[16.0, 16.0], [28.0, 18.0], [22.0, 28.0]],
                      np.float32)]]
    return {
        "rpn_target_assign": [
            C(None, None, anc, None, gts[:1], None, info,
              rpn_batch_size_per_im=8),
            C(None, None, anc, None, gts, np.array([0, 1]), info,
              rpn_batch_size_per_im=64),
            C(None, None, anc, None, gts, None, info,
              rpn_batch_size_per_im=6, rpn_fg_fraction=0.25,
              use_random=True, seed=3)],
        "generate_proposal_labels": [
            C(rois, np.array([1, 2]), None, gt2, info,
              batch_size_per_im=8, class_nums=4),
            C(rois, np.array([3, 1]), np.array([0, 0]), gt2, info,
              batch_size_per_im=6, fg_fraction=0.5, fg_thresh=0.3,
              class_nums=4, use_random=True, seed=7)],
        "detection_map": [
            C(det, gl, gb, 3), C(det, gl, gb, 3, ap_type="11point"),
            C(det[0], gl[0], gb[0], 3, overlap_threshold=0.7),
            C(det, gl, gb, 4, background_label=-1)],
        "retinanet_target_assign": [
            C(f(1, 16, 4), f(1, 16, 3), anc, None, gts,
              np.array([1, 3], np.int32), None, info, num_classes=3),
            C(np.zeros((1, 2, 4), np.float32), np.zeros((1, 2, 3),
                                                        np.float32),
              np.array([[0, 0, 1, 1], [5, 5, 6, 6]], np.float32), None,
              np.zeros((0, 4), np.float32), np.zeros((0,), np.int32), None,
              info)],
        "generate_mask_labels": [
            C(np.array([32.0, 32.0, 1.0], np.float32), np.array([1, 2]),
              None, segs, np.array([[0, 0, 16, 16], [14, 14, 30, 30],
                                    [1, 1, 5, 5]], np.float32),
              np.array([1, 2, 0], np.int32), 3, 4),
            C(np.array([32.0, 32.0, 1.0], np.float32), np.array([1, 2]),
              np.array([0, 1]), segs, np.array([[0, 0, 16, 16]],
                                               np.float32),
              np.array([0], np.int32), 3, 4)],
    }


HOST = sorted(_host_cases())


@pytest.mark.parametrize("name", HOST)
def test_host_functions_are_equal(name):
    for k, c in enumerate(_host_cases()[name]):
        want = getattr(JD, name)(*c.args, **c.kw)
        # the port takes tensors as well as arrays
        got = getattr(TD, name)(*[_conv(a, torch.tensor) for a in c.args],
                                **c.kw)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{name} case {k}")
            assert np.asarray(g).dtype == np.asarray(w).dtype, name


# ---------------------------------------------------------------------------
# module 7: interpolation (jax.image.resize semantics)
# ---------------------------------------------------------------------------
INTERP_CASES = {
    "interpolate": [
        C(f(2, 3, 5, 7), scale=2.0, resample="NEAREST"),
        C(f(1, 2, 6, 5), (9, 8), resample="NEAREST"),        # 1.5x, 1.6x
        C(f(1, 2, 9, 10), (4, 6), resample="NEAREST"),       # down
        C(f(1, 2, 5, 7), (8, 11), resample="BILINEAR", align_corners=False),
        C(f(1, 3, 12, 10), (5, 4), resample="BILINEAR",
          align_corners=False),                              # antialiased
        C(f(1, 2, 6, 9), (6, 4), resample="BILINEAR", align_corners=False),
        C(f(1, 2, 5, 7), (9, 13), resample="BILINEAR"),      # corners
        C(f(1, 2, 9, 8), (4, 3), resample="BILINEAR"),
        C(f(1, 1, 4, 4), (1, 6), resample="BILINEAR")],
    "resize_nearest": [C(f(2, 4, 3, 3), scale=2.0),
                       C(f(1, 2, 7, 5), scale=0.6)],
    "resize_bilinear": [C(f(1, 2, 4, 6), (7, 9)),
                        C(f(1, 2, 4, 6), (3, 2), align_corners=False)],
    "image_resize": [C(f(1, 2, 5, 5), (8, 3), resample="NEAREST"),
                     C(f(1, 2, 5, 5), scale=1.4, align_corners=False)],
    "image_resize_short": [C(f(1, 2, 6, 9), 4),
                           C(f(1, 2, 9, 6), 10, resample="NEAREST")],
}


@pytest.mark.parametrize("name", sorted(INTERP_CASES))
def test_interpolation_matches_jax(name):
    for k, c in enumerate(INTERP_CASES[name]):
        got, want = _call(getattr(jnn_ops, name), getattr(tnn_ops, name), c)
        _close(got, want, f"{name} case {k}")


# ---------------------------------------------------------------------------
# gradients against jax.grad
# ---------------------------------------------------------------------------
def _grad_pair(jfn, tfn, args, wrt):
    """Input gradients of sum(fn(*args)) (a tuple's outputs summed) with
    respect to the positions ``wrt``, in both packages."""
    def jloss(*xs):
        a = list(args)
        for p, v in zip(wrt, xs):
            a[p] = v
        out = jfn(*[jnp.asarray(v) if isinstance(v, np.ndarray) else v
                    for v in a])
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o) for o in outs)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(wrt)))))(
        *[jnp.asarray(args[p]) for p in wrt])
    ts = [torch.tensor(args[p], requires_grad=True) for p in wrt]
    a = [torch.tensor(v) if isinstance(v, np.ndarray) else v for v in args]
    for p, t in zip(wrt, ts):
        a[p] = t
    out = tfn(*a)
    outs = out if isinstance(out, tuple) else (out,)
    got = torch.autograd.grad(sum(o.sum() for o in outs), ts)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _grad_cases():
    ssd = _ssd_cases()
    yolo = _yolov3_cases()
    interp = [
        ((f(1, 2, 5, 7), (10, 14), None, "NEAREST"), "nearest 2x"),
        ((f(1, 2, 6, 5), (9, 8), None, "NEAREST"), "nearest 1.5x"),
        ((f(1, 2, 5, 7), (8, 11), None, "BILINEAR", False), "bilinear up"),
        ((f(1, 2, 12, 10), (5, 4), None, "BILINEAR", False),
         "bilinear down"),
        ((f(1, 2, 5, 7), (9, 13), None, "BILINEAR", True), "corners")]
    cases = [("ssd_loss", c.args, c.kw, (0, 1)) for c in ssd[1:3]]
    cases += [("yolov3_loss", c.args, c.kw, (0,)) for c in yolo[:4]]
    cases += [
        ("sigmoid_focal_loss", (f(6, 4, lo=-3, hi=3),
                                np.array([0, 1, 4, 2, 0, 3], np.int32),
                                np.array([3.0], np.float32)), {}, (0,)),
        ("box_coder", (boxes(6), np.full((6, 4), 0.1, np.float32),
                       f(3, 6, 4, lo=-0.5, hi=0.5), "decode_center_size"),
         {}, (2,)),
        ("roi_align", (f(2, 3, 8, 9), boxes(5, 16.0), 3, 2, 0.5, -1,
                       np.array([0, 1, 1, 0, 1], np.int32)), {}, (0, 1)),
        ("roi_pool", (f(2, 3, 8, 9), boxes(4, 16.0), 2, 3, 0.5,
                      np.array([1, 0, 1, 1], np.int32)), {}, (0,)),
        ("psroi_pool", (f(2, 12, 7, 8), boxes(4, 8.0), 2, 0.8, 2, 3,
                        np.array([0, 1, 1, 0], np.int32)), {}, (0,)),
        ("yolo_box", (_yolo_x(2, 3, 3, 4, 4), np.array([[64, 64], [48, 80]],
                                                       np.int32),
                      ANCHORS[:6], 3, 0.3, 16), {}, (0,))]
    out = [(n, a, k, w, n) for n, a, k, w in cases]
    out += [("interpolate", a, {}, (0,), label) for a, label in interp]
    return out


GRADS = _grad_cases()


@pytest.mark.parametrize("case", range(len(GRADS)),
                         ids=[f"{c[4]}-{i}" for i, c in enumerate(GRADS)])
def test_input_gradients_match_jax_grad(case):
    name, args, kw, wrt, _ = GRADS[case]
    mod_j = jnn_ops if name == "interpolate" else JD
    mod_t = tnn_ops if name == "interpolate" else TD

    def bind(fn):
        return lambda *a: fn(*a, **kw)
    got, want = _grad_pair(bind(getattr(mod_j, name)),
                           bind(getattr(mod_t, name)), args, wrt)
    for p, g, w in zip(wrt, got, want):
        assert np.isfinite(w).all() and np.isfinite(g).all(), (name, p)
        _close(g, w, f"{name} d/darg{p}")


# ---------------------------------------------------------------------------
# no host reads in the fixed-trip functions
# ---------------------------------------------------------------------------
def test_fixed_trip_functions_read_nothing_on_the_host(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("host read of a tensor")

    args = {
        "multiclass_nms": _nms_cases()[5],
        "detection_output": C(f(2, 8, 4) * 0.1, R.rand(2, 8, 3).astype(
            np.float32), boxes(8), np.full((8, 4), 0.1, np.float32),
            nms_eta=0.8),
        "ssd_loss": _ssd_cases()[1],
        "yolov3_loss": _yolov3_cases()[1],
        "bipartite_match": MATCH_CASES["bipartite_match"][2],
        "generate_proposals": C(*_proposal_inputs()[:5], pre_nms_top_n=20,
                                post_nms_top_n=8),
    }
    ready = {n: ([_conv(a, torch.tensor) for a in c.args],
                 {k: _conv(v, torch.tensor) for k, v in c.kw.items()})
             for n, c in args.items()}
    with monkeypatch.context() as m:
        for attr in ("item", "__bool__", "__float__", "__int__", "__index__",
                     "tolist", "numpy"):
            m.setattr(torch.Tensor, attr, refuse)
        outs = {n: getattr(TD, n)(*a, **k) for n, (a, k) in ready.items()}
    for n, c in args.items():
        _close(_np(outs[n]), _np(_jit(getattr(JD, n), c.args, c.kw)), n)


# ---------------------------------------------------------------------------
# static wrappers: a Program per op in both packages
# ---------------------------------------------------------------------------
def _static(pkg, name, feeds, consts, kw):
    """A Program of one ``layers.<name>`` call over data vars ``feeds``
    (name -> array; the batch dim as written) and constant args
    ``consts``: (document, the program, its startup, its fetch list)."""
    layers = pkg.layers
    guard = pkg.static.program_guard if pkg is jpt else pkg.program_guard
    uname = junique if pkg is jpt else tpt.unique_name
    main, startup = pkg.Program(), pkg.Program()
    with guard(main, startup), uname.guard():
        vs = {k: pkg.data(k, list(v.shape), str(v.dtype),
                          append_batch_size=False) for k, v in feeds.items()}
        args = [vs.get(k) for k in feeds] + list(consts)
        out = getattr(layers, name)(*args, **kw)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    ser = jser if pkg is jpt else tser
    return ser.program_to_dict(main), main, startup, outs


def _static_cases():
    pri = boxes(6)
    var = np.full((6, 4), 0.1, np.float32)
    return {
        "iou_similarity": (dict(x=boxes(4), y=boxes(5)), [], {}),
        "box_coder": (dict(p=pri, v=var, t=f(2, 6, 4) * 0.1), [],
                      dict(code_type="decode_center_size")),
        "prior_box": (dict(x=FEAT, img=IMG), [],
                      dict(min_sizes=[4.0], max_sizes=[8.0],
                           aspect_ratios=[2.0], flip=True)),
        "density_prior_box": (dict(x=FEAT, img=IMG), [],
                              dict(densities=[2], fixed_sizes=[4.0],
                                   fixed_ratios=[1.0])),
        "anchor_generator": (dict(x=FEAT), [], {}),
        "bipartite_match": (dict(d=R.rand(2, 3, 5).astype(np.float32)), [],
                            dict(match_type="per_prediction")),
        "target_assign": (dict(x=f(2, 3, 4),
                               i=np.array([[2, -1, 0], [1, 1, -1]],
                                          np.int32)), [], {}),
        "multiclass_nms": (dict(b=_nms_cases()[1].args[0],
                                s=_nms_cases()[1].args[1]), [],
                           dict(score_threshold=0.2, nms_top_k=6,
                                keep_top_k=5)),
        "detection_output": (dict(l=f(2, 6, 4) * 0.1,
                                  s=R.rand(2, 6, 3).astype(np.float32),
                                  p=pri, v=var), [], dict(keep_top_k=4)),
        "ssd_loss": (dict(l=f(1, 6, 4) * 0.05, c=f(1, 6, 3), g=pri[1:2][None],
                          gl=np.array([[1]], np.int32), p=pri), [], {}),
        "yolo_box": (dict(x=_yolo_x(2, 2, 3, 3, 3),
                          i=np.array([[64, 64], [48, 80]], np.int32)), [],
                     dict(anchors=[10, 10, 20, 20], class_num=3,
                          conf_thresh=0.4, downsample_ratio=32)),
        "yolov3_loss": (dict(x=_yolov3_cases()[0].args[0],
                             g=_yolov3_cases()[0].args[1],
                             gl=_yolov3_cases()[0].args[2]), [],
                        dict(anchors=ANCHORS, anchor_mask=[0, 1],
                             class_num=4, ignore_thresh=0.7,
                             downsample_ratio=8)),
        "box_clip": (dict(b=boxes(3, 50.0, lead=(2,)),
                          i=np.array([[40, 30, 1], [20, 60, 2]],
                                     np.float32)), [], {}),
        "polygon_box_transform": (dict(x=f(1, 8, 3, 3)), [], {}),
        "sigmoid_focal_loss": (dict(x=f(4, 3), l=np.array([0, 1, 3, 2],
                                                          np.int32),
                                    n=np.array([2.0], np.float32)), [], {}),
        "roi_align": (dict(x=f(1, 2, 6, 6), r=boxes(3, 6.0)), [],
                      dict(pooled_height=2, pooled_width=2)),
        "roi_pool": (dict(x=f(1, 2, 6, 6), r=boxes(3, 6.0)), [],
                     dict(pooled_height=2, pooled_width=2)),
        "psroi_pool": (dict(x=f(1, 8, 6, 6), r=boxes(2, 6.0)), [2, 1.0, 2,
                                                                2], {}),
        # an axis-aligned quad on integer coordinates: the homography is
        # exact, so no output pixel lies within rounding of the quad's edge
        # (random quads put the corner pixels there, where XLA's fused
        # Program and its eager ops may round to opposite sides)
        "roi_perspective_transform": (
            dict(x=f(1, 2, 8, 8), r=np.array([[1, 2, 5, 2, 5, 6, 1, 6]],
                                             np.float32)), [5, 5], {}),
        "mine_hard_examples": (
            dict(c=R.rand(1, 5).astype(np.float32),
                 lo=R.rand(1, 5).astype(np.float32),
                 m=np.array([[1, -1, -1, -1, -1]], np.int32),
                 d=np.full((1, 5), 0.1, np.float32)), [], {}),
        "generate_proposals": (dict(zip("sdiav", _proposal_inputs())), [],
                               dict(pre_nms_top_n=10, post_nms_top_n=5)),
        "box_decoder_and_assign": (
            dict(p=pri[:5] * 30, v=var[:5], t=f(5, 8) * 0.1,
                 s=R.rand(5, 2).astype(np.float32)), [], {}),
        "interpolate": (dict(x=f(1, 2, 3, 4)), [], dict(scale=2.0,
                                                        resample="NEAREST")),
        "resize_nearest": (dict(x=f(1, 2, 3, 4)), [], dict(scale=2.0)),
        "resize_bilinear": (dict(x=f(1, 2, 3, 4)), [(5, 7)], {}),
        "image_resize": (dict(x=f(1, 2, 3, 4)), [(2, 3)],
                         dict(align_corners=False)),
        "image_resize_short": (dict(x=f(1, 2, 3, 4)), [6], {}),
    }


STATIC = sorted(_static_cases())


@pytest.mark.parametrize("name", STATIC)
def test_static_wrapper_matches_jax(name):
    """The JAX package's document; the port's Program run by its Executor
    gives what its op gives called at once on the same inputs (the op
    itself is held against the JAX function above), one output per JAX
    output Variable."""
    feeds, consts, kw = _static_cases()[name]
    jdoc, jmain, _, jouts = _static(jpt, name, feeds, consts, kw)
    tdoc, main, startup, outs = _static(tpt, name, feeds, consts, kw)
    assert tdoc == jdoc
    assert len(outs) == len(jouts)
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup)
    got = exe.run(main, feed=feeds, fetch_list=outs)
    fn = getattr(TD, name, None) or getattr(tnn_ops, name)
    want = fn(*[torch.tensor(v) for v in feeds.values()], *consts, **kw)
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), w.numpy(),
                                      err_msg=f"{name} out {k}")


def test_host_detection_layers_are_eager_passthroughs():
    for name in ("rpn_target_assign", "generate_proposal_labels",
                 "detection_map", "distribute_fpn_proposals",
                 "collect_fpn_proposals", "retinanet_detection_output",
                 "retinanet_target_assign", "generate_mask_labels"):
        assert getattr(tlayers, name) is getattr(TD, name), name
        assert hasattr(jlayers, name)


def test_ssd_loss_static_with_prior_var():
    """tests/test_ops_detection.py::TestStaticPromotion::
    test_ssd_loss_static_with_prior_var on the port: ``prior_box_var`` as
    a Variable rides the op's inputs; documents and losses equal."""
    rng = np.random.RandomState(20)
    priors = boxes(6)
    pvar = np.full((6, 4), 0.1, np.float32)
    gt = np.stack([priors[1]])[None]
    gtl = np.array([[1]], np.int32)
    feed = {"loc": rng.randn(1, 6, 4).astype(np.float32) * 0.05,
            "conf": rng.randn(1, 6, 3).astype(np.float32),
            "pb": priors, "pbv": pvar}
    res = []
    for pkg in (jpt, tpt):
        guard = pkg.static.program_guard if pkg is jpt else \
            pkg.program_guard
        main, startup = pkg.Program(), pkg.Program()
        with guard(main, startup):
            v = {k: pkg.data(k, list(a.shape), "float32",
                             append_batch_size=False)
                 for k, a in feed.items()}
            loss = pkg.layers.ssd_loss(v["loc"], v["conf"], gt, gtl,
                                       v["pb"], prior_box_var=v["pbv"])
        exe = (jpt.static.Executor(jpt.CPUPlace()) if pkg is jpt
               else tpt.Executor(tpt.CPUPlace()))
        exe.run(startup)
        out = exe.run(main, feed=feed, fetch_list=[loss])
        ser = jser if pkg is jpt else tser
        ops = main.global_block().ops
        res.append((ser.program_to_dict(main), np.asarray(out[0]),
                    ops[-1].attrs["_tensor_params"]))
    assert res[1][0] == res[0][0]
    assert res[1][2] == ("location", "confidence", "gt_box", "gt_label",
                         "prior_box", "prior_box_var")
    _close(res[1][1], res[0][1], "ssd_loss static")


MBH = dict(base_size=32, num_classes=4, aspect_ratios=[[2.0], [2.0]],
           min_sizes=[8.0, 16.0], max_sizes=[16.0, 32.0], flip=True,
           offset=0.5)


def test_multi_box_head_in_a_program_names_and_priors():
    docs, shapes = [], []
    for pkg in (jpt, tpt):
        guard = pkg.static.program_guard if pkg is jpt else \
            pkg.program_guard
        uname = junique if pkg is jpt else tpt.unique_name
        main, startup = pkg.Program(), pkg.Program()
        with guard(main, startup), uname.guard():
            img = pkg.data("img", [3, 32, 32], "float32")
            f1 = pkg.data("f1", [3, 8, 8], "float32")
            f2 = pkg.data("f2", [3, 4, 4], "float32")
            outs = pkg.layers.multi_box_head([f1, f2], img, **MBH)
            outs2 = pkg.layers.multi_box_head(
                [f1, f2, f2], img, 32, 3, [[2.0], [3.0], [2.0, 3.0]],
                min_ratio=20, max_ratio=90, name="second")
        ser = jser if pkg is jpt else tser
        docs.append((ser.program_to_dict(main),
                     ser.program_to_dict(startup)))
        shapes.append([tuple(v.shape) for v in outs + outs2])
        params = sorted(n for n, v in main.global_block().vars.items()
                        if getattr(v, "trainable", False))
    assert docs[1] == docs[0]
    assert shapes[1] == shapes[0]
    b = 8 * 8 * 4 + 4 * 4 * 4          # 1 min + 1 max + 2 flipped ratios
    assert shapes[1][:4] == [(-1, b, 4), (-1, b, 4), (b, 4), (b, 4)]
    assert "multi_box_head_loc0_w" in params
    assert "multi_box_head_1_conf1_b" not in params
    assert "second_conf2_b" in params


def test_multi_box_head_in_the_module_context_names_and_priors():
    feats = [R.rand(2, 3, 8, 8).astype(np.float32),
             R.rand(2, 3, 4, 4).astype(np.float32)]
    image = np.ones((2, 3, 32, 32), np.float32)

    def head(nn, layers):
        class Head(nn.Layer):
            def forward(self, feats, image):
                return layers.multi_box_head(feats, image, **MBH)
        return Head()

    jm = head(jnn, jlayers)
    jp, js = jm.init(jax.random.PRNGKey(0), [jnp.asarray(v) for v in feats],
                     jnp.asarray(image))
    jout, _ = jm.apply(jp, js, jax.random.PRNGKey(1),
                       [jnp.asarray(v) for v in feats], jnp.asarray(image))
    tm = head(tnn, tlayers)
    tp, ts = tm.init(torch.Generator().manual_seed(0),
                     [torch.tensor(v) for v in feats], torch.tensor(image))
    assert sorted(tp) == sorted(jp)
    assert any(k.endswith("mbh_loc0_w") for k in tp)
    tparams = tnn.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    tout, _ = tm.apply(tparams, ts, None, [torch.tensor(v) for v in feats],
                       torch.tensor(image))
    b = 8 * 8 * 4 + 4 * 4 * 4
    assert tout[2].shape == (b, 4)
    for k, (g, w) in enumerate(zip(tout, jout)):
        _close(g.detach().numpy(), np.asarray(w), f"multi_box_head out {k}")
