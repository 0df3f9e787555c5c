"""CycleGAN (``models/cycle_gan.py``) in the port against the JAX package, on
the CPU, at ``cyclegan_tiny`` (32^2, batch 1, ngf 4, ndf 8, 2 residual
blocks), and the published ``cyclegan_256``'s shapes.

One builder makes each package's programs from its own ``layers``. The
startup, inference and three training programs' documents must be equal
(no schedule: the training programs serialize too), and so their op lists
and var tables. The weights come from the JAX package's startup program
(``Scope.from_numpy``). Then 3 iterations of the source's loop (G, the
fakes through seeded image pools, D_A, D_B) on the same synthetic images:
every loss within 1e-5 of itself, and every persistable after (the
parameters of all four networks and the Adam moments) within 1e-4 of its
largest magnitude (Adam's early, sign-like steps magnify summation-order
differences of near-zero gradients; observed 2.3e-5 on my CPU run, in
CHANGES.md), then both generators of the inference program from each
trained scope within 1e-5.

The tiny config trains at the source's batch of 1. At batch 2 this seed's
first generator step is chaotic in fp32 whoever computes it: scaling one
input image by (1 + 2^-23) moves the port's own generator gradients by
0.4 % of their largest value while the loss agrees to 1e-6
(:func:`test_tiny_batch_of_two_hangs_on_rounding`); the two packages then
differ by as much (ROADMAP queue 3 note f: an activation input within
rounding of a kink). Other widths, sizes and depths, and batch 1, move by
1e-5 at most under the same scaling (my CPU run, in CHANGES.md).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch.models import cycle_gan as cg

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
ITERS = 3
PROGRAMS = ("startup", "infer", "main", "d_a", "d_b")


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
    cfg = cg.cyclegan_tiny()
    with static_mode_guard(False):
        return cfg, cg.build_train(tpt, cfg), cg.build_train(jpt, cfg)


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


def test_documents_equal_jax(built):
    from paddle_tpu.static import serialize as jser
    from paddle_tpu_torch.static import serialize as tser
    _, t, j = built
    for k in PROGRAMS:
        assert tser.program_to_dict(t[k]) == jser.program_to_dict(j[k]), k
        assert _structure(t[k]) == _structure(j[k]), k
    for k in ("g_params", "d_a_params", "d_b_params"):
        assert t[k] == j[k], k


def test_programs_hold_the_source_network(built):
    """Each optimizer updates only its networks' parameters, every
    ``fused_adam`` update one parameter; the inference program holds the
    two generators and no update."""
    cfg, t, _ = built
    assert {n[:3] for n in t["g_params"]} == {"g_A", "g_B"}
    assert {n[:3] for n in t["d_a_params"]} == {"d_A"}
    assert {n[:3] for n in t["d_b_params"]} == {"d_B"}
    assert len(t["g_params"]) == 2 * len(
        [n for n in t["g_params"] if n.startswith("g_A")])
    for key, params in (("main", "g_params"), ("d_a", "d_a_params"),
                        ("d_b", "d_b_params")):
        ops = t[key].global_block().ops
        updates = [op for op in ops if op.type == "apply_optimizer"]
        assert len(updates) == len(t[params])
    infer_ops = [op.type for op in t["infer"].global_block().ops]
    assert "autodiff" not in infer_ops and "apply_optimizer" not in infer_ops
    assert infer_ops.count("conv2d_transpose") == 4
    assert list(t["fake_B"].shape) == [-1, 3, cfg.image_size,
                                       cfg.image_size]


def _scopes(t, j):
    """The JAX startup's weights in both packages' scopes."""
    jscope = jpt.static.Scope()
    jpt.static.Executor(jpt.CPUPlace()).run(j["startup"], scope=jscope)
    names = sorted(n for n, v in j["startup"].global_block().vars.items()
                   if v.persistable)
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in names}, "cpu",
        t["startup"])
    return tscope, jscope, names


def test_tiny_trains_and_infers_like_jax(built):
    cfg, t, j = built
    tscope, jscope, names = _scopes(t, j)
    for n in names:
        np.testing.assert_array_equal(tscope.find_var(n).numpy(),
                                      np.array(jscope.find_var(n)))
    texe, jexe = tpt.Executor(tpt.CPUPlace()), jpt.static.Executor(
        jpt.CPUPlace())
    pools = [{d: cg.ImagePool(cfg.pool_size, seed=s)
              for d, s in (("A", 1), ("B", 2))} for _ in range(2)]
    losses = []
    for it in range(ITERS):
        a, b = cg.synthetic_images(cfg, cfg.batch, seed=it)
        got = cg.train_iteration(texe, t, tscope, a, b, pools[0])
        want = cg.train_iteration(jexe, j, jscope, a, b, pools[1])
        losses.append((got, want))
        for name, g, w in zip(("G", "D_A", "D_B"), got, want):
            np.testing.assert_allclose(g, w, rtol=LOSS_TOL,
                                       err_msg=f"{name} loss, iteration {it}")
    assert all(np.isfinite(v).all() for pair in losses for v in pair[0])
    for n in names:
        want = np.array(jscope.find_var(n))
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(tscope.find_var(n).numpy(), want, rtol=0,
                                   atol=PARAM_TOL * scale, err_msg=n)
    a, b = cg.synthetic_images(cfg, 2, seed=99)
    feed = {"input_A": a, "input_B": b}
    got = texe.run(t["infer"], feed=feed,
                   fetch_list=[t["fake_A"], t["fake_B"]], scope=tscope)
    want = jexe.run(j["infer"], feed=feed,
                    fetch_list=[j["fake_A"], j["fake_B"]], scope=jscope)
    for g, w in zip(got, want):
        assert g.shape == (2, 3, cfg.image_size, cfg.image_size)
        assert np.abs(g).max() < 1.0
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=LOSS_TOL)


def test_tiny_batch_of_two_hangs_on_rounding():
    """The port alone, batch 2: the first generator step's gradients from
    one set of weights, on image A as it is and scaled by (1 + 2^-23),
    differ by more than 1e-3 of their largest value while the losses agree
    to 1e-5 (the chaos the module docstring describes)."""
    cfg = cg.cyclegan_tiny(batch=2)
    t = cg.build_train(tpt, cfg)
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(t["startup"], scope=scope)
    names = [n for n, v in t["startup"].global_block().vars.items()
             if v.persistable]
    init = {n: scope.find_var(n).numpy().copy() for n in names}
    a, b = cg.synthetic_images(cfg, cfg.batch, seed=0)
    grads = [p + "@GRAD" for p in t["g_params"]]
    outs = []
    for factor in (1.0, 1.0 + 2.0 ** -23):
        s = tpt.Scope.from_numpy(init, "cpu", t["startup"])
        outs.append(exe.run(t["main"], feed={
            "input_A": a * np.float32(factor), "input_B": b},
            fetch_list=[t["g_loss"]] + grads, scope=s))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=LOSS_TOL)
    gmax = max(np.abs(g).max() for g in outs[0][1:])
    gap = max(np.abs(x - y).max() for x, y in zip(outs[0][1:], outs[1][1:]))
    assert gap > 1e-3 * gmax, (gap, gmax)


def test_image_pool_follows_the_source():
    """The first ``pool_size`` batches pass through and are kept; after
    that half the draws hand back a kept batch and keep the new one."""
    pool = cg.ImagePool(3, seed=0)
    imgs = [np.full((1,), float(i)) for i in range(40)]
    out = [pool.pool_image(x) for x in imgs]
    assert [float(o[0]) for o in out[:3]] == [0.0, 1.0, 2.0]
    swapped = sum(float(o[0]) != float(x[0]) for o, x in zip(out, imgs))
    assert 8 < swapped < 30
    again = cg.ImagePool(3, seed=0)
    assert [float(again.pool_image(x)[0]) for x in imgs] == \
        [float(o[0]) for o in out]


def test_published_config_shapes():
    """``cyclegan_256`` (built in the port only, no weights drawn): 30x30
    patches, 256^2 fakes, and the parameter counts of base_network.py's
    layers at ngf 32, ndf 64 and 9 blocks."""
    cfg = cg.cyclegan_256()
    assert (cfg.image_size, cfg.batch, cfg.ngf, cfg.ndf, cfg.n_blocks) == \
        (256, 1, 32, 64, 9)
    t = cg.build_train(tpt, cfg)
    assert list(t["fake_A"].shape) == [-1, 3, 256, 256]
    blk = t["d_a"].global_block()
    patches = [op for op in blk.ops if op.type == "conv2d"][4]
    assert list(blk.var(patches.output_names()[0]).shape) == [-1, 1, 30, 30]
    g_a = [n for n in t["g_params"] if n.startswith("g_A")]
    # c1 7x7 3->32, c2 3x3 32->64, c3 64->128, 9 blocks of two 3x3 128->128,
    # c4 and c5 transposed 3x3 128->64->32, c6 7x7 32->3 with a bias; an
    # instance norm's scale and offset after each but c6
    want_g = (7 * 7 * 3 * 32 + 9 * 32 * 64 + 9 * 64 * 128
              + 18 * 9 * 128 * 128 + 9 * 128 * 64 + 9 * 64 * 32
              + 7 * 7 * 32 * 3 + 3
              + 2 * (32 + 64 + 128 + 18 * 128 + 64 + 32))
    assert cg.param_count(t["main"], g_a) == want_g == 2853187
    # c1 4x4 3->64 with a bias, c2-c4 64->128->256->512 with instance norm,
    # c5 512->1 with a bias
    want_d = (16 * 3 * 64 + 64 + 16 * 64 * 128 + 16 * 128 * 256
              + 16 * 256 * 512 + 16 * 512 + 1 + 2 * (128 + 256 + 512))
    assert cg.param_count(t["d_a"], t["d_a_params"]) == want_d == 2765633
