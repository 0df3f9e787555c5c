"""MobileNet-SSD and YOLOv3 (``models/ssd.py``, ``models/yolov3.py``) in the
port against the JAX package, on the CPU, at a small width: ``ssd_tiny``
(MobileNet at width 1/8, 64^2 input, 4 classes, batch 2) and ``yolo_tiny``
(DarkNet stages [1,1,1,1,1] at width 1/16, 64^2, 3 classes, batch 2, 4 gt
rows).

Each model's programs are built by the same builder over each package's
layers. The startup and inference programs' documents must be equal; the
training program has none in either package (its optimizer holds a
learning-rate schedule, a closure), so its op list (types, inputs,
outputs) and var table (names, shapes, dtypes, persistable) are compared.
Both packages start from one set of weights (the port's startup, copied
into a JAX scope) and train 3 steps on seeded synthetic batches. YOLOv3:
losses, the first step's gradients and the parameters after (batch-norm
stats and momentum slots included) within 1e-5 of their largest magnitude
(fp32 sums in other orders; the observed gaps are in CHANGES.md), then the
inference program over each trained scope: NMS labels, kept sets and -1
rows equal, scores and boxes within 1e-5.

MobileNet-SSD at this size is chaotic in fp32 when it trains: 35 conv +
batch-norm layers with no residual path, the norms over batch statistics
of depthwise convolutions of non-negative inputs (means far above the
spread, so ``x - mean`` cancels), and four 1x1 maps normalised over 2
images. Rounding moves its gradients by percents whoever computes them: on
the port alone, scaling the input images by (1 + 2^-23) moves the first
step's gradients by more than 1e-3 of their largest value
(:func:`test_ssd_tiny_gradients_hang_on_rounding`; the gaps are in
CHANGES.md), while the loss agrees to 1e-5 and a MobileNet program of
three blocks built by the same helpers agrees to 1e-5 in every gradient
(:func:`test_mobilenet_blocks_train_like_jax`); the loss itself moves by
up to 1.2e-5 of its value under that scaling. So the SSD test holds each of
its 3 steps from the same weights (the port's scope set to the JAX
package's before each step): the loss within 1e-4 of itself; and it runs the
inference program from the JAX package's trained scope in both: NMS
outputs as above and the host ``detection_map`` equal.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch.models import ssd, yolov3
from paddle_tpu_torch.ops import detection as TD

TOL = 1e-5
#: MobileNet-SSD's loss, each step from the same weights: the port's own
#: loss moves by up to 1.2e-5 of itself when the input images are scaled by
#: (1 + 2^-23) (the module docstring; my CPU measurement, in CHANGES.md)
SSD_LOSS_TOL = 1e-4
STEPS = 3


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d). The JAX
    Executor's cost probe (a second lowering of every segment, for its MFU
    gauges) is off here, and the port's CPU ops take two threads (the
    suite's other workers share the cores); both are set back after."""
    from paddle_tpu.core.flags import get_flag, set_flags
    cost, threads = get_flag("monitor_cost"), torch.get_num_threads()
    set_flags({"FLAGS_monitor_cost": False})
    torch.set_num_threads(min(threads, 2))
    try:
        with static_mode_guard(False):
            yield
    finally:
        set_flags({"FLAGS_monitor_cost": cost})
        torch.set_num_threads(threads)


def _start(t, j):
    """Both packages' scopes from one set of initial weights: the port's
    startup program run on the CPU, its persistables copied into a JAX
    scope (the JAX startup draws each initializer as its own XLA program,
    ~20 s a model here; the startup documents are equal, so the names and
    shapes are). Returns (tscope, jscope, names)."""
    import jax.numpy as jnp
    tscope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(t["startup"], scope=tscope)
    names = sorted(n for n, v in t["startup"].global_block().vars.items()
                   if v.persistable)
    jscope = jpt.static.Scope()
    for n in names:
        jscope.set_var(n, jnp.asarray(tscope.find_var(n).numpy()))
    return tscope, jscope, names


def _close(got, want, where):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=where)


def _trainable(program):
    return [p.name for p in program.all_parameters() if p.trainable]


def _dtype(v):
    s = str(v.dtype)
    return s.replace("torch.", "") if "torch" in s else np.dtype(v.dtype).name


def _structure(program):
    blk = program.global_block()
    ops = [(op.type, {k: list(v) for k, v in op.inputs.items()},
            {k: list(v) for k, v in op.outputs.items()}) for op in blk.ops]
    var = [(n, None if v.shape is None else tuple(v.shape), _dtype(v),
            bool(v.persistable)) for n, v in blk.vars.items()]
    return ops, var


def _docs_equal(t, j, mod=None, cfg=None):
    """The startup and inference documents equal, the training programs'
    op lists and var tables equal; with ``mod``, ``build_infer``'s program
    is the training build's inference program."""
    from paddle_tpu.static import serialize as jser
    from paddle_tpu_torch.static import serialize as tser
    for k in ("startup", "infer"):
        assert tser.program_to_dict(t[k]) == jser.program_to_dict(j[k]), k
    assert _structure(t["main"]) == _structure(j["main"])
    if mod is not None:
        assert tser.program_to_dict(mod.build_infer(tpt, cfg)["main"]) == \
            tser.program_to_dict(t["infer"])


def _train_both(mod, cfg, feeds, docs=True):
    """Build in both packages, train ``STEPS`` steps from the JAX startup's
    weights; returns (t, j, tscope, jscope, texe, jexe) after checking
    losses, first grads and parameters."""
    if cfg is None:
        t, j = mod.build_train(tpt), mod.build_train(jpt)
    else:
        t, j = mod.build_train(tpt, cfg), mod.build_train(jpt, cfg)
    if docs:
        _docs_equal(t, j, mod, cfg)
    tscope, jscope, names = _start(t, j)
    texe, jexe = tpt.Executor(tpt.CPUPlace()), jpt.static.Executor(
        jpt.CPUPlace())
    params = _trainable(t["main"])
    assert params == _trainable(j["main"])
    grads = [p + "@GRAD" for p in params]
    for step in range(STEPS):
        fetch = [t["loss"]] + (grads if step == 0 else [])
        jout = jexe.run(j["main"], feed=feeds[step],
                        fetch_list=[j["loss"]] + fetch[1:], scope=jscope)
        tout = texe.run(t["main"], feed=feeds[step], fetch_list=fetch,
                        scope=tscope)
        _close(tout[0], jout[0], f"loss at step {step}")
        for n, g, w in zip(grads, tout[1:], jout[1:]):
            _close(g, w, f"{n} at step 0")
    for n in names:
        _close(tscope.find_var(n).numpy(), np.array(jscope.find_var(n)), n)
    return t, j, tscope, jscope, texe, jexe


def _nms_equal(got, want, where):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    np.testing.assert_array_equal(got[..., 0], want[..., 0], err_msg=where)
    pad = want[..., 0] < 0
    np.testing.assert_array_equal(got[pad], want[pad], err_msg=where)
    _close(got, want, where)


def _scope_from(jscope, names, startup):
    return tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in names}, "cpu", startup)


def test_ssd_tiny_trains_and_infers_like_jax():
    cfg = ssd.ssd_tiny()
    t, j = ssd.build_train(tpt, cfg), ssd.build_train(jpt, cfg)
    _docs_equal(t, j, ssd, cfg)
    _, jscope, names = _start(t, j)
    texe, jexe = tpt.Executor(tpt.CPUPlace()), jpt.static.Executor(
        jpt.CPUPlace())
    for step in range(STEPS):
        feed = ssd.synthetic_batch(cfg, cfg.batch, seed=step)
        tscope = _scope_from(jscope, names, t["startup"])
        (tl,) = texe.run(t["main"], feed=feed, fetch_list=[t["loss"]],
                         scope=tscope)
        (jl,) = jexe.run(j["main"], feed=feed, fetch_list=[j["loss"]],
                         scope=jscope)
        np.testing.assert_allclose(tl, jl, rtol=SSD_LOSS_TOL,
                                   err_msg=f"loss at step {step}")
    tscope = _scope_from(jscope, names, t["startup"])
    batch = ssd.synthetic_batch(cfg, cfg.infer_batch, seed=99)
    feed = {"image": batch["image"]}
    (tout,) = texe.run(t["infer"], feed=feed, fetch_list=[t["nmsed"]],
                       scope=tscope)
    (jout,) = jexe.run(j["infer"], feed=feed, fetch_list=[j["nmsed"]],
                       scope=jscope)
    assert tout.shape == (cfg.infer_batch, 200, 6)
    assert (tout[..., 0] >= 0).sum() > 0
    _nms_equal(tout, jout, "ssd detection_output")
    from paddle_tpu.ops import detection as JD
    gl = [r[r >= 0] for r in batch["gt_label"]]
    gb = [bx[r >= 0] for bx, r in zip(batch["gt_box"], batch["gt_label"])]
    m_t = TD.detection_map(tout, gl, gb, cfg.num_classes, ap_type="11point")
    m_j = JD.detection_map(np.asarray(jout), gl, gb, cfg.num_classes,
                           ap_type="11point")
    assert m_t == m_j


def test_yolo_tiny_trains_and_infers_like_jax():
    cfg = yolov3.yolo_tiny()
    data = [yolov3.synthetic_batch(cfg, cfg.batch, seed=s)
            for s in range(STEPS)]
    feeds = [{k: d[k] for k in ("image", "gt_box", "gt_label", "gt_score")}
             for d in data]
    t, j, tscope, jscope, texe, jexe = _train_both(yolov3, cfg, feeds)
    batch = yolov3.synthetic_batch(cfg, cfg.batch, seed=99)
    feed = {"image": batch["image"], "im_size": batch["im_size"]}
    (tout,) = texe.run(t["infer"], feed=feed, fetch_list=[t["nmsed"]],
                       scope=tscope)
    (jout,) = jexe.run(j["infer"], feed=feed, fetch_list=[j["nmsed"]],
                       scope=jscope)
    assert tout.shape == (cfg.batch, 100, 6)
    assert (tout[..., 0] >= 0).sum() > 0
    _nms_equal(tout, jout, "yolov3 multiclass_nms")


def test_ssd_tiny_gradients_hang_on_rounding():
    """The port alone: the first step's gradients of ``ssd_tiny`` from one
    set of weights, on images as they are and scaled by (1 + 2^-23), differ
    by more than 1e-3 of their largest value while the two losses agree to
    1e-4: the fp32 chaos the module docstring describes, which no
    elementwise gradient comparison at 1e-5 can pass."""
    cfg = ssd.ssd_tiny()
    t = ssd.build_train(tpt, cfg)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(t["startup"], scope=scope)
    init = {n: scope.find_var(n).clone() for n in scope.names()
            if hasattr(scope.find_var(n), "clone")}
    grads = [p + "@GRAD" for p in _trainable(t["main"])]
    feed = ssd.synthetic_batch(cfg, cfg.batch, seed=0)
    outs = []
    for factor in (1.0, 1.0 + 2.0 ** -23):
        for n, v in init.items():
            scope.set_var(n, v.clone())
        f = dict(feed, image=feed["image"] * np.float32(factor))
        outs.append(exe.run(t["main"], feed=f, fetch_list=[t["loss"]]
                            + grads, scope=scope))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=SSD_LOSS_TOL)
    gmax = max(np.abs(g).max() for g in outs[0][1:])
    gap = max(np.abs(a - b).max() for a, b in zip(outs[0][1:], outs[1][1:]))
    assert gap > 1e-3 * gmax, (gap, gmax)


def test_mobilenet_blocks_train_like_jax():
    """A conv_bn and a depthwise_separable block of ``models/ssd.py`` (the
    3x3 conv with ``groups`` = channels, then the 1x1, each with batch norm
    over batch statistics and ReLU) at 12^2: the first step's gradients and
    the parameters after 3 SGD steps within 1e-5, from one set of
    weights."""
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), \
                pkg.framework.unique_name.guard():
            x = pkg.data("x", [4, 12, 12], "float32")
            y = ssd._conv_bn(pkg, x, 3, 8, 2, 1)
            y = ssd._depthwise_separable(pkg, ssd.ssd_tiny(), y, 64, 128,
                                         64, 2)
            loss = pkg.layers.reduce_mean(pkg.layers.square(
                pkg.layers.elementwise_sub(y, pkg.layers.fill_constant(
                    [1], "float32", 0.5))))
            pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
        return dict(main=main, startup=startup, loss=loss)

    rng = np.random.RandomState(3)
    feeds = [{"x": rng.randn(4, 4, 12, 12).astype(np.float32)}
             for _ in range(STEPS)]

    class Blocks:
        build_train = staticmethod(build)

    _train_both(Blocks, None, feeds, docs=False)


def test_published_configs():
    """The published widths: MobileNet-SSD's head has 1,917 priors over six
    maps; YOLOv3's network has 222 trainable tensors and 255-channel output
    maps at strides 32, 16 and 8 (program construction only)."""
    s = ssd.build_train(tpt, ssd.mobilenet_ssd_voc())
    assert tuple(s["box"].shape) == (1917, 4)
    assert tuple(s["locs"].shape) == (-1, 1917, 4)
    assert tuple(s["confs"].shape) == (-1, 1917, 21)
    assert tuple(s["nmsed"].shape) == (-1, 200, 6)
    y = yolov3.build_train(tpt, yolov3.yolov3_coco())
    assert len(_trainable(y["main"])) == 222
    assert [tuple(o.shape) for o in y["outputs"]] == [
        (-1, 255, 19, 19), (-1, 255, 38, 38), (-1, 255, 76, 76)]
    assert tuple(y["nmsed"].shape) == (-1, 100, 6)
