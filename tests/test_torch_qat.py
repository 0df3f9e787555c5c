"""MobileNetV1 under quantization-aware training (``models/mobilenet_v1.py``)
and the QAT toolkit (``contrib/quant.py``) in the port against the JAX
package, on the CPU, at ``mobilenet_v1_tiny`` (32², width 0.125, three
blocks, 10 classes, batch 4), and the published ``mobilenet_v1``'s shapes.

One build function makes each package's programs from its own ``layers``:
the startup, training (``QuantizeTranspiler`` after ``minimize``) and test
documents are equal. Then 3 QAT Momentum steps on the same batches, each
from the JAX package's persistables before it. A fake-quant round turns an
ulp of difference before it into a whole step (a flip: the pre-round value
within rounding of a half integer), and batch norm's batch statistics
spread a flip over its channel (seed 0's first step flips one value of
4,096, and 3 downstream follow it: conv1's gradient moves by 4.9 % of its
largest value, 2.2 % of the largest gradient; tools/qat_flip_probe.py). So
at each step every fake-quant output's integers (each package's from its
own scale) are held equal but for at most ``FLIP_SHARE`` of them, each
differing by one step, the first (in the forward order) at a pre-round
value within ``HALF_INT`` of a half integer; the losses within
``LOSS_TOL``; the gradients within ``GRAD_TOL`` of the largest at a step
without a flip and within ``GRAD_FLIP`` at one; the momentum update, flips
or not, exactly as the gradients' gap moves it (within ``UPDATE_ULPS``
roundings: a 10x rate, a dropped L2 decay or another momentum fails); the
batch statistics within ``PARAM_TOL`` of max(1, largest) without a flip.
Batches seeded 100-102 flip nowhere, and hold every limit at 1e-5.

Then, from one set of trained weights in both: the calibration scales
within ``SCALE_TOL`` (the float forward sums in another order), the frozen
op lists and documents, the int8 weights and their scales equal (each
package freezes with the JAX calibration's scales), the frozen logits
within ``LOGIT_TOL`` of the largest (an ulp of a float op before a
``quantize_linear`` flips an integer too). The frozen program crosses the
packages both ways through ``save/load_inference_model``. The freeze's
float-stay and raise-before-mutate cases of tests/test_quant_freeze.py run
in the port, the storage-only pass, the one-call PTQ and the eager helpers
over the port's parameter trees.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.contrib import quant as jquant
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.static import serialize as jser
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch.contrib import quant as tquant
from paddle_tpu_torch.models import mobilenet_v1 as mb
from paddle_tpu_torch.static import serialize as tser

STEPS = 3
LOSS_TOL = 1e-5
FLIP_SHARE = 0.01
HALF_INT = 1e-3
GRAD_TOL = 1e-5
GRAD_FLIP = 0.1
PARAM_TOL = 1e-5
UPDATE_ULPS = 8
SCALE_TOL = 1e-5
LOGIT_TOL = 0.02


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d); the port's CPU
    ops take two threads (the suite's other workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        with static_mode_guard(False):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def built():
    cfg = mb.mobilenet_v1_tiny()
    with static_mode_guard(False):
        return cfg, mb.build_qat(tpt, cfg), mb.build_qat(jpt, cfg)


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items()
                  if v.persistable)


def _scopes(t, j):
    jscope = jpt.static.Scope()
    jpt.static.Executor(jpt.CPUPlace()).run(j["startup"], scope=jscope)
    names = _persistables(j["startup"])
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in names}, "cpu",
        t["startup"])
    return tscope, jscope, names


def test_documents_equal_jax(built):
    _, t, j = built
    for k in ("startup", "test", "main"):
        assert tser.program_to_dict(t[k]) == jser.program_to_dict(j[k]), k


def test_programs_hold_the_source_network(built):
    """conv1 and 3 blocks (7 convs, 3 of them depthwise), each with a
    batch norm and ReLU, the global pool, fc7; a fake quant-dequant before
    each input of each conv and of the fc's mul; one momentum update per
    trainable tensor with L2Decay(4e-5); the test program has no fake-quant
    op and no update."""
    cfg, t, _ = built
    ops = t["main"].global_block().ops
    types = [op.type for op in ops]
    assert types.count("conv2d") == 7 and types.count("batch_norm") == 7
    assert types.count("fake_quantize_dequantize_abs_max") == 16
    assert sorted(op.attrs["groups"] for op in ops
                  if op.type == "conv2d") == [1, 1, 1, 1, 4, 8, 16]
    params = mb.param_names(t["main"])
    assert params[:3] == ["conv1_weights", "conv1_bn_scale",
                          "conv1_bn_offset"]
    assert params[-2:] == ["fc7_weights", "fc7_offset"]
    assert len(params) == 23 == types.count("apply_optimizer")
    for op in ops:
        if op.type == "fake_quantize_dequantize_abs_max":
            x = op.inputs["X"][0]
            assert op.outputs["Out"] == [f"{x}.quant_dequant",
                                         f"{x}.quant_scale"]
            assert op.attrs == {"bit_length": 8}
        if op.type in ("conv2d", "mul"):
            assert all(n.endswith(".quant_dequant")
                       for n in op.input_names())
    test_types = [op.type for op in t["test"].global_block().ops]
    assert "fake_quantize_dequantize_abs_max" not in test_types
    assert "apply_optimizer" not in test_types
    assert list(t["logits"].shape) == [-1, cfg.num_classes]


def test_the_published_config():
    """``mobilenet_v1``: 224², 1000 classes, 27 convs (13 depthwise), 56
    fake-quant ops, 83 trainable tensors, 4.23 M values."""
    cfg = mb.mobilenet_v1()
    assert (cfg.image_size, cfg.num_classes, cfg.batch, cfg.blocks) == (
        224, 1000, 256, 13)
    with static_mode_guard(False):
        b = mb.build_qat(tpt, cfg)
    blk = b["main"].global_block()
    types = [op.type for op in blk.ops]
    assert types.count("conv2d") == 27
    assert types.count("fake_quantize_dequantize_abs_max") == 56
    params = mb.param_names(b["main"])
    assert len(params) == 83
    shapes = {n: tuple(blk.var(n).shape) for n in params}
    assert shapes["conv1_weights"] == (32, 3, 3, 3)
    assert shapes["conv6_dw_weights"] == (1024, 1, 3, 3)
    assert shapes["conv6_sep_weights"] == (1024, 1024, 1, 1)
    assert shapes["fc7_weights"] == (1024, 1000)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 4_231_976
    batch = mb.synthetic_batch(cfg, 2, seed=0)
    assert batch["image"].shape == (2, 3, 224, 224)
    assert batch["label"].dtype == np.int64 and batch["label"].max() < 1000


def _qat_steps(built, base):
    """``STEPS`` QAT steps of both packages on the batches seeded ``base``,
    ``base`` + 1, ..., each from the JAX package's persistables before it
    (weights, velocities, batch statistics): the flips of each step count
    and act only within it. Returns the flips of each step."""
    cfg, t, j = built
    jscope = jpt.static.Scope()
    jexe = jpt.static.Executor(jpt.CPUPlace())
    jexe.run(j["startup"], scope=jscope)
    names = _persistables(j["startup"])
    texe = tpt.Executor(tpt.CPUPlace())
    params = mb.param_names(t["main"])
    stats = [n for n in names
             if n not in params and not n.endswith("@velocity")]
    _, fq_names = mb.fake_quant_fetch(t["main"])
    fetch = [t["loss"].name] + [p + "@GRAD" for p in params] + fq_names
    n = 1 + len(params)
    flips_of = []
    for step in range(STEPS):
        feed = mb.synthetic_batch(cfg, cfg.batch, seed=base + step)
        before = {k: np.array(jscope.find_var(k)) for k in names}
        tscope = tpt.Scope.from_numpy(before, "cpu", t["startup"])
        got = texe.run(t["main"], feed=feed, fetch_list=fetch, scope=tscope)
        want = [np.asarray(v) for v in jexe.run(
            j["main"], feed=feed, fetch_list=fetch, scope=jscope)]
        assert np.isfinite(got[0])
        np.testing.assert_allclose(got[0], want[0], rtol=LOSS_TOL,
                                   err_msg=f"loss, step {step}")
        flips, _, fault = mb.check_flips(mb.quant_flips(got[n:], want[n:]),
                                         FLIP_SHARE, HALF_INT)
        assert fault is None, f"step {step}: {fault}"
        flips_of.append(flips)
        gmax = max(float(np.abs(g).max()) for g in want[1:n])
        for p, g, w in zip(params, got[1:n], want[1:n]):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=(GRAD_FLIP if flips else GRAD_TOL) * gmax,
                err_msg=f"{p}, step {step}")
            # the update from the same p and v, flips or not: v' = mu v +
            # g + l2 p, p' = p - lr v', so the velocities differ by the
            # gradients' gap and the parameters by -lr times that, within
            # UPDATE_ULPS roundings of the terms
            g, w = g.astype(np.float64), w.astype(np.float64)
            p0, v0 = (before[k].astype(np.float64) for k in
                      (p, p + "@velocity"))
            pt_, vt = (tscope.find_var(k).numpy().astype(np.float64)
                       for k in (p, p + "@velocity"))
            pj, vj = (np.array(jscope.find_var(k)).astype(np.float64)
                      for k in (p, p + "@velocity"))
            u = UPDATE_ULPS * 2.0 ** -24
            assert (np.abs((vt - vj) - (g - w)) <= u * (
                cfg.momentum * np.abs(v0) + np.abs(w) + cfg.l2 * np.abs(p0)
                + np.abs(vj))).all(), f"{p}@velocity, step {step}"
            assert (np.abs((pt_ - pj) + cfg.lr * (vt - vj)) <= u * (
                np.abs(p0) + cfg.lr * np.abs(vj) + np.abs(pj))).all(), \
                f"{p}, step {step}"
        for k in stats:
            # the batch statistics (and the step counter): with a flip,
            # their moves within GRAD_FLIP of the largest, as the gradients
            w = np.array(jscope.find_var(k))
            got_k = tscope.find_var(k).numpy()
            tol = (GRAD_FLIP * float(np.abs(w - before[k]).max()) if flips
                   else PARAM_TOL * max(1.0, float(np.abs(w).max())))
            np.testing.assert_allclose(got_k, w, rtol=0, atol=tol,
                                       err_msg=f"{k}, step {step}")
    return flips_of


def test_qat_steps_like_jax(built):
    """Seed 0's first step flips (4 of 39,912 values on the CPU)."""
    _qat_steps(built, 0)


def test_qat_steps_like_jax_without_flips(built):
    """Batches seeded 100-102: no flip on the CPU, every limit at 1e-5."""
    _qat_steps(built, 100)


@pytest.fixture(scope="module")
def frozen(built):
    """Both test programs frozen from the JAX package's weights after
    3 QAT steps, with the JAX calibration's scales; the port's own
    calibration beside."""
    cfg, _, _ = built
    with static_mode_guard(False):
        t, j = mb.build_qat(tpt, cfg), mb.build_qat(jpt, cfg)
        tscope, jscope, names = _scopes(t, j)
        jexe = jpt.static.Executor(jpt.CPUPlace())
        for s in range(STEPS):
            jexe.run(j["main"], feed=mb.synthetic_batch(cfg, cfg.batch, s),
                     fetch_list=[j["loss"]], scope=jscope)
        trained = {n: np.array(jscope.find_var(n)) for n in names}
        tscope = tpt.Scope.from_numpy(trained, "cpu", t["startup"])
        texe = tpt.Executor(tpt.CPUPlace())
        calib = [mb.synthetic_batch(cfg, cfg.batch, seed=10 + i)
                 for i in range(2)]
        jscales = jquant.calibrate_activations(jexe, j["test"], calib,
                                               scope=jscope)
        tscales = tquant.calibrate_activations(texe, t["test"], calib,
                                               scope=tscope)
        jfp = jquant.QuantizationFreezePass(scope=jscope,
                                            act_scales=jscales)
        jfp.apply(j["test"])
        tfp = tquant.QuantizationFreezePass(scope=tscope,
                                            act_scales=jscales)
        tfp.apply(t["test"])
    return dict(t=t, j=j, tscope=tscope, jscope=jscope, texe=texe,
                jexe=jexe, tscales=tscales, jscales=jscales, tfp=tfp,
                jfp=jfp)


def test_calibration_and_freeze_like_jax(frozen):
    f = frozen
    assert list(f["tscales"]) == list(f["jscales"])
    for k, v in f["jscales"].items():
        assert abs(f["tscales"][k] - v) <= SCALE_TOL * v, k
    tprog, jprog = f["t"]["test"], f["j"]["test"]
    assert tser.program_to_dict(tprog) == jser.program_to_dict(jprog)
    types = [op.type for op in tprog.global_block().ops]
    assert types.count("quantized_conv2d") == 7 and \
        types.count("quantized_mul") == 1
    assert not {"conv2d", "mul", "fake_quantize_dequantize_abs_max"} & \
        set(types)
    assert f["tfp"].weight_scales == f["jfp"].weight_scales
    for w in f["tfp"].weight_scales:
        got = f["tscope"].find_var(w)
        want = np.asarray(f["jscope"].find_var(w))
        assert got.dtype == torch.int8 and want.dtype == np.int8, w
        np.testing.assert_array_equal(got.numpy(), want, err_msg=w)


def _frozen_logits(f, seed=99):
    feed = mb.synthetic_batch(mb.mobilenet_v1_tiny(), 3, seed=seed)
    (got,) = f["texe"].run(f["t"]["test"], feed=feed,
                           fetch_list=[f["t"]["logits"]], scope=f["tscope"])
    (want,) = f["jexe"].run(f["j"]["test"], feed=feed,
                            fetch_list=[f["j"]["logits"]],
                            scope=f["jscope"])
    return feed, got, np.asarray(want)


def test_frozen_logits_like_jax(frozen):
    _, got, want = _frozen_logits(frozen)
    assert got.shape == want.shape == (3, 10)
    lmax = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * lmax)


def test_frozen_program_crosses_the_packages(frozen, tmp_path):
    f = frozen
    feed, got, want = _frozen_logits(f, seed=7)
    d_t, d_j = str(tmp_path / "port"), str(tmp_path / "jax")
    with tpt.scope_guard(f["tscope"]):
        tpt.io.save_inference_model(d_t, ["image"], [f["t"]["logits"]],
                                    f["texe"], main_program=f["t"]["test"])
    with jpt.static.scope_guard(f["jscope"]):
        jpt.io.save_inference_model(d_j, ["image"], [f["j"]["logits"]],
                                    f["jexe"], main_program=f["j"]["test"])
    # the port's directory in JAX, the JAX directory in the port
    jscope = jpt.static.Scope()
    with jpt.static.scope_guard(jscope):
        jprog, jfeeds, jfetch = jpt.io.load_inference_model(d_t, f["jexe"])
        (j_of_t,) = f["jexe"].run(jprog, feed={"image": feed["image"]},
                                  fetch_list=jfetch)
    tscope = tpt.Scope()
    tprog, tfeeds, tfetch = tpt.io.load_inference_model(d_j, f["texe"],
                                                        scope=tscope)
    assert tscope.find_var("fc7_weights").dtype == torch.int8
    (t_of_j,) = f["texe"].run(tprog, feed={"image": feed["image"]},
                              fetch_list=tfetch, scope=tscope)
    assert jfeeds == tfeeds == ["image"]
    np.testing.assert_array_equal(np.asarray(j_of_t), want)
    np.testing.assert_array_equal(t_of_j, got)


# ---------------------------------------------------------------------------
# the freeze's edge cases (tests/test_quant_freeze.py) in the port
# ---------------------------------------------------------------------------
def _run(program, scope, feed, fetch):
    return tpt.Executor(tpt.CPUPlace()).run(program, feed=feed,
                                            fetch_list=fetch, scope=scope)


def _start(startup):
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(startup, scope=scope)
    return scope


def _matmul_program(build):
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        out = build(tpt.layers)
    return main, startup, out


def test_transposed_matmul_stays_float():
    def build(L):
        x = tpt.data("x", [8], "float32")
        w = L.create_parameter([6, 8], "float32", name="wT")
        return L.matmul(x, w, transpose_y=True)
    main, startup, out = _matmul_program(build)
    scope = _start(startup)
    feed = {"x": np.ones((2, 8), np.float32)}
    (before,) = _run(main, scope, feed, [out])
    tquant.QuantizationFreezePass(scope=scope,
                                  act_scales={"x": 1.0}).apply(main)
    types = [op.type for op in main.global_block().ops]
    assert "matmul" in types and "quantized_mul" not in types
    (after,) = _run(main, scope, feed, [out])
    np.testing.assert_array_equal(after, before)


def test_depthwise_conv_freezes_with_groups():
    rng = np.random.RandomState(2)
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = tpt.data("x", [3, 6, 6], "float32")
        w = tpt.layers.create_parameter([3, 1, 3, 3], "float32", name="dw")
        out = tpt.layers.depthwise_conv2d(x, w, padding=1)
    scope = _start(startup)
    scope.set_var("dw", torch.as_tensor(
        (rng.randn(3, 1, 3, 3) * 0.2).astype(np.float32)))
    feed = {"x": rng.rand(2, 3, 6, 6).astype(np.float32)}
    (ref,) = _run(main, scope, feed, [out])
    tquant.QuantizationFreezePass(
        scope=scope, act_scales={"x": float(feed["x"].max())}).apply(main)
    (op,) = main.global_block().ops
    assert op.type == "quantized_conv2d" and op.attrs["groups"] == 3
    (got,) = _run(main, scope, feed, [out])
    assert np.abs(got - ref).max() < 0.05 * np.abs(ref).max()


def test_weight_first_and_shared_weights_stay_float():
    def first(L):
        x = tpt.data("x", [4], "float32", append_batch_size=False)
        w = L.create_parameter([6, 2], "float32", name="wf")
        return L.matmul(w, x)

    def shared(L):
        x = tpt.data("x", [6], "float32")
        w = L.create_parameter([6, 6], "float32", name="w_shared")
        return L.elementwise_add(L.matmul(x, w),
                                 L.matmul(x, w, transpose_y=True))
    for build, shape, wname in ((first, (2, 4), "wf"),
                                (shared, (2, 6), "w_shared")):
        main, startup, out = _matmul_program(build)
        scope = _start(startup)
        feed = {"x": np.ones(shape, np.float32)}
        (before,) = _run(main, scope, feed, [out])
        tquant.QuantizationFreezePass(scope=scope,
                                      act_scales={"x": 1.0}).apply(main)
        assert "quantized_mul" not in [op.type for op in
                                       main.global_block().ops]
        assert scope.find_var(wname).dtype == torch.float32
        (after,) = _run(main, scope, feed, [out])
        np.testing.assert_array_equal(after, before)


def test_missing_scale_raises_before_any_mutation():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = tpt.data("x", [8], "float32")
        tpt.layers.fc(tpt.layers.fc(x, 6, act="relu"), 2)
    scope = _start(startup)
    with pytest.raises(KeyError, match="calibrated"):
        tquant.QuantizationFreezePass(scope=scope,
                                      act_scales={"x": 1.0}).apply(main)
    assert "quantized_mul" not in [op.type for op in
                                   main.global_block().ops]
    for n in scope.names():
        assert scope.find_var(n).dtype == torch.float32, n


def _fc3(pt, unique_name):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", [16], "float32")
        h = pt.layers.fc(x, 12, act="relu")
        out = pt.layers.fc(pt.layers.fc(h, 8, act="relu"), 4)
    return main, startup, out


def test_storage_only_and_one_call_ptq_like_jax():
    tm, ts, to = _fc3(tpt, tpt.unique_name)
    jm, js, jo = _fc3(jpt, junique)
    jscope = jpt.static.Scope()
    jexe = jpt.static.Executor(jpt.CPUPlace())
    jexe.run(js, scope=jscope)
    names = _persistables(js)
    arrays = {n: np.array(jscope.find_var(n)) for n in names}
    tscope = tpt.Scope.from_numpy(arrays, "cpu", ts)
    scales = tquant.ConvertToInt8Pass(scope=tscope).apply(tm)
    jscales = jquant.ConvertToInt8Pass(scope=jscope).apply(jm)
    assert scales == jscales and len(scales) == 3
    for n in scales:
        np.testing.assert_array_equal(tscope.find_var(n).numpy(),
                                      np.asarray(jscope.find_var(n)))
    assert "mul" in [op.type for op in tm.global_block().ops]
    # the one call on fresh weights: calibrate, freeze, the same outputs
    tm, ts, to = _fc3(tpt, tpt.unique_name)
    jm, js, jo = _fc3(jpt, junique)
    jscope = jpt.static.Scope()
    for n, a in arrays.items():
        jscope.set_var(n, a)
    tscope = tpt.Scope.from_numpy(arrays, "cpu", ts)
    rng = np.random.RandomState(1)
    feeds = [{"x": rng.rand(8, 16).astype(np.float32)} for _ in range(2)]
    texe = tpt.Executor(tpt.CPUPlace())
    tquant.quantize_program_int8(texe, tm, feeds, scope=tscope)
    jquant.quantize_program_int8(jexe, jm, feeds, scope=jscope)
    tops, jops_ = tm.global_block().ops, jm.global_block().ops
    assert [(o.type, o.inputs, o.outputs) for o in tops] == \
        [(o.type, o.inputs, o.outputs) for o in jops_]
    for a, b in zip(tops, jops_):
        # the calibrated activation scales sum the float forward in another
        # order: within SCALE_TOL
        assert {k: v for k, v in a.attrs.items() if k != "x_scale"} == \
            {k: v for k, v in b.attrs.items() if k != "x_scale"}
        if "x_scale" in b.attrs:
            assert abs(a.attrs["x_scale"] - b.attrs["x_scale"]) <= \
                SCALE_TOL * b.attrs["x_scale"]
    (got,) = texe.run(tm, feed=feeds[0], fetch_list=[to], scope=tscope)
    (want,) = jexe.run(jm, feed=feeds[0], fetch_list=[jo], scope=jscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=LOGIT_TOL * float(np.abs(want).max()))


def test_eager_helpers_over_parameter_trees():
    rng = np.random.RandomState(3)
    arrays = {"w": rng.randn(6, 5).astype(np.float32),
              "b": rng.randn(5).astype(np.float32),
              "layers": [{"k": rng.randn(4, 3, 3, 3).astype(np.float32)}],
              "step": np.float32(2.0)}

    def to_t(tree):
        if isinstance(tree, dict):
            return {k: to_t(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_t(v) for v in tree]
        return torch.as_tensor(tree)
    params = to_t(arrays)
    for cw in (False, True):
        # the JAX helpers run eagerly: a division by bins there is a true
        # division, the port's the jitted product with its reciprocal
        want = jquant.fake_quant_params(arrays, channel_wise=cw)
        got = tquant.fake_quant_params(params, channel_wise=cw)
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                                   rtol=2.4e-7, atol=0)
        np.testing.assert_allclose(got["layers"][0]["k"].numpy(),
                                   np.asarray(want["layers"][0]["k"]),
                                   rtol=2.4e-7, atol=0)
        assert got["step"] is params["step"]
    q, treedef = tquant.post_training_quantize(params, bit_length=8)
    jq, jtreedef = jquant.post_training_quantize(arrays, bit_length=8)
    assert len(q) == len(jq) == 4
    back = tquant.dequantize_params(q, treedef)
    jback = jquant.dequantize_params(jq, jtreedef)
    # the port lists the leaves in its trees' order (dicts as built), JAX in
    # its pytrees' (keys sorted): match them by place in the tree
    jpos = jax.tree_util.tree_unflatten(jtreedef, list(range(len(jq))))
    pairs = [(treedef["w"], jpos["w"]), (treedef["b"], jpos["b"]),
             (treedef["step"], jpos["step"]),
             (treedef["layers"][0]["k"], jpos["layers"][0]["k"])]
    for i, k in pairs:
        (a, s), (b, r) = q[i], jq[k]
        assert s == r and str(a.dtype) == "torch.int8"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(back["layers"][0]["k"].numpy(),
                               np.asarray(jback["layers"][0]["k"]),
                               rtol=2.4e-7, atol=0)
