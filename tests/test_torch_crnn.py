"""CRNN-CTC (``models/crnn_ctc.py``) in the port against the JAX package, on
the CPU, at ``crnn_ctc_tiny`` (16x64 grey images, batch 4, two conv groups,
hidden 8, 6 classes and the blank), and the published ``crnn_ctc``'s
shapes.

One build function makes each package's programs from its own
``layers``. The startup, evaluation and training documents must be equal,
and so the op lists and var tables. The weights come from the JAX
package's startup program (``Scope.from_numpy``). Then 3 Momentum steps on
the same synthetic batches: every loss within 1e-5 of itself and every
persistable after (the weights, the batch-norm statistics, the
velocities) within 1e-5 of its largest magnitude (2.4e-6 observed on an
x86 CPU), then the evaluation program from each trained scope: the
decoded rows and lengths equal, the edit distances within 1e-6.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch.models import crnn_ctc as cr

LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
STEPS = 3


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
    cfg = cr.crnn_ctc_tiny()
    with static_mode_guard(False):
        return cfg, cr.build_train(tpt, cfg), cr.build_train(jpt, cfg)


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
    for k in ("startup", "test", "main"):
        assert tser.program_to_dict(t[k]) == jser.program_to_dict(j[k]), k
        assert _structure(t[k]) == _structure(j[k]), k


def test_programs_hold_the_source_network(built):
    """Four convs with batch norm, one pool, im2sequence, three fcs at
    num_flatten_dims 2 (the last over two inputs), two GRUs (one reversed),
    warpctc; the evaluation program decodes and measures and updates
    nothing; one momentum update per trainable parameter; every parameter
    of a ParamAttr decayed, the GRU biases at twice the rate."""
    cfg, t, _ = built
    main_ops = [op.type for op in t["main"].global_block().ops]
    assert main_ops.count("conv2d") == 4 and main_ops.count("batch_norm") == 4
    assert main_ops.count("pool2d") == 1 and main_ops.count("mul") == 4
    assert [op.attrs["is_reverse"] for op in t["main"].global_block().ops
            if op.type == "dynamic_gru"] == [False, True]
    ctc = next(op for op in t["main"].global_block().ops
               if op.type == "warpctc")
    assert ctc.attrs["blank"] == cfg.num_classes and \
        ctc.attrs["norm_by_times"]
    params = cr.param_names(t["main"])
    updates = [op for op in t["main"].global_block().ops
               if op.type == "apply_optimizer"]
    assert len(updates) == len(params) == 27
    test_ops = [op.type for op in t["test"].global_block().ops]
    assert "autodiff" not in test_ops and "apply_optimizer" not in test_ops
    assert {"ctc_greedy_decoder", "edit_distance"} <= set(test_ops)
    blk = t["main"].global_block()
    for n in params:
        p = blk.var(n)
        if n.startswith("conv2d_b"):
            assert p.regularizer is None, n
        else:
            assert p.regularizer is not None, n
    lrs = {n: blk.var(n).optimize_attr["learning_rate"] for n in params}
    assert {n for n, v in lrs.items() if v == 2.0} == {"gru_fwd_b",
                                                        "gru_bwd_b"}
    assert list(t["logits"].shape) == [-1, cfg.time_steps,
                                       cfg.num_classes + 1]


def _scopes(t, j):
    jscope = jpt.static.Scope()
    jpt.static.Executor(jpt.CPUPlace()).run(j["startup"], scope=jscope)
    names = sorted(n for n, v in j["startup"].global_block().vars.items()
                   if v.persistable)
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in names}, "cpu",
        t["startup"])
    return tscope, jscope, names


def test_tiny_trains_and_decodes_like_jax(built):
    cfg, t, j = built
    tscope, jscope, names = _scopes(t, j)
    for n in names:
        np.testing.assert_array_equal(tscope.find_var(n).numpy(),
                                      np.array(jscope.find_var(n)))
    texe = tpt.Executor(tpt.CPUPlace())
    jexe = jpt.static.Executor(jpt.CPUPlace())
    for step in range(STEPS):
        feed = cr.feed_of(cr.synthetic_batch(cfg, cfg.batch, seed=step))
        (got,) = texe.run(t["main"], feed=feed, fetch_list=[t["loss"]],
                          scope=tscope)
        (want,) = jexe.run(j["main"], feed=feed, fetch_list=[j["loss"]],
                           scope=jscope)
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL,
                                   err_msg=f"loss, step {step}")
    for n in names:
        want = np.array(jscope.find_var(n))
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(tscope.find_var(n).numpy(), want, rtol=0,
                                   atol=PARAM_TOL * scale, err_msg=n)
    feed = cr.feed_of(cr.synthetic_batch(cfg, 3, seed=99))
    keys = ("decoded", "decoded_length", "distance", "seq_num")
    got = texe.run(t["test"], feed=feed, fetch_list=[t[k] for k in keys],
                   scope=tscope)
    want = jexe.run(j["test"], feed=feed, fetch_list=[j[k] for k in keys],
                    scope=jscope)
    for k, g, w in zip(keys, got, want):
        if k == "distance":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    assert got[0].shape == (3, cfg.time_steps) and int(got[3]) == 3


def test_the_published_config_shapes():
    """``crnn_ctc``: [B, 1, 48, 512] -> conv features [B, 128, 6, 64] ->
    64 steps of 768 -> logits [B, 64, 96]; 95 classes and the blank."""
    cfg = cr.crnn_ctc()
    assert (cfg.height, cfg.width, cfg.batch, cfg.hidden) == (48, 512, 32,
                                                               200)
    assert (cfg.time_steps, cfg.features, cfg.num_classes) == (64, 768, 95)
    b = cr.build_train(tpt, cfg)
    ops = b["main"].global_block().ops
    seq = next(op for op in ops if op.type == "im2sequence")
    conv_out = b["main"].global_block().var(seq.inputs["X"][0])
    assert list(conv_out.shape) == [-1, 128, 6, 64]
    assert list(b["main"].global_block().var(
        seq.outputs["Out"][0]).shape) == [-1, 64, 768]
    assert list(b["logits"].shape) == [-1, 64, 96]
    shapes = {n: tuple(b["main"].global_block().var(n).shape)
              for n in cr.param_names(b["main"])}
    assert shapes["gru_fwd_w"] == (200, 600) and shapes["fc1_w"] == (768, 600)
    assert shapes["out_fwd_w"] == (200, 96) and shapes["out_b"] == (96,)
    batch = cr.synthetic_batch(cfg, 2, seed=0)
    assert batch["pixel"].shape == (2, 1, 48, 512)
    assert batch["label"].shape == (2, 24)
    assert 1 <= batch["label_length"].min() and \
        batch["label_length"].max() <= 24
    assert batch["label"].max() < 95
