"""The gradients of the port's ops at their kinks against ``jax.grad`` of the
JAX package's ops, on the CPU (ROADMAP queue 3, F9).

The JAX ops are written with ``jnp.maximum``, ``jnp.clip`` and ``jnp.abs``:
at a tie ``jnp.maximum`` and ``jnp.clip`` give each side half the gradient,
and ``jnp.abs`` has gradient 1 at 0. The port mirrors each op, even where
that is not the math: ``sigmoid_cross_entropy_with_logits`` has gradient
``-label`` at logit 0 in both (ROADMAP queue 3 note n). Each case puts some
inputs exactly on a kink and the others off it; the gradient of the summed
output against each differentiated input must equal the JAX one within
1e-6 (the values at the kinks are exact halves, quarters and tenths).
The ties are exact in fp32 whichever way the product rounds: ``jax.jit``
may fuse ``slope * x + offset`` into one FMA, which moves the default
``hard_sigmoid``'s -2.5 (0.2 is not a binary fraction) off its tie, so
that case takes a slope of 0.25.

In a Program the kinks move training: a ``conv2d(act="relu")`` whose zero
bias meets an all-zero and an all-ones image takes, after one SGD step at
rate 1 on the mean, the bias that ``jax.grad`` gives it (-0.375; -0.125
with a gradient of 0 at the tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import ops as jops
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import ops as tops

TOL = 1e-6


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d)."""
    with static_mode_guard(False):
        yield


def a(*v):
    return np.array(v, np.float32)


#: name -> (op name, differentiated args, other args, keyword args); the
#: differentiated args' first entries sit on the kinks
CASES = {
    "relu at 0": ("relu", [a(0.0, -0.0, 1.5, -2.0)], [], {}),
    "relu6 at 0 and 6": ("relu6", [a(0.0, 6.0, 3.0, 7.0, -1.0)], [], {}),
    "brelu at both bounds": ("brelu", [a(1.0, 4.0, 2.0, 5.0, 0.5)], [],
                             {"t_min": 1.0, "t_max": 4.0}),
    "soft_relu at 40": ("soft_relu", [a(40.0, -40.0, 1.0, 50.0)], [], {}),
    "hard_sigmoid at both bounds": ("hard_sigmoid",
                                    [a(2.0, -2.0, 0.0, 3.0)], [],
                                    {"slope": 0.25}),
    "hard_swish at -3 and 3": ("hard_swish", [a(-3.0, 3.0, 1.0, -4.0)], [],
                               {}),
    "clip at both bounds": ("clip", [a(-1.0, 2.0, 0.5, 3.0)], [],
                            {"min": -1.0, "max": 2.0}),
    "clip_by_norm at max_norm": ("clip_by_norm", [a(3.0, 4.0)], [],
                                 {"max_norm": 5.0}),
    "abs at 0": ("abs", [a(0.0, -0.0, 1.0, -2.0)], [], {}),
    "l1_norm at 0": ("l1_norm", [a(0.0, 1.0, -2.0)], [], {}),
    "sigmoid_cross_entropy_with_logits at 0": (
        "sigmoid_cross_entropy_with_logits", [a(0.0, 0.0, 0.0, 1.5)],
        [a(0.0, 1.0, 0.3, 1.0)], {}),
    "teacher_student_sigmoid_loss at 0 and the bounds": (
        "teacher_student_sigmoid_loss", [a(0.0, 15.0, -15.0, 2.0)],
        [a(1.0, 0.0, 1.0, 0.0)], {}),
    "hinge_loss at the hinge": ("hinge_loss", [a(1.0, -1.0, 0.5)],
                                [a(1.0, 0.0, 1.0)], {}),
    "margin_rank_loss at the hinge": (
        "margin_rank_loss", [a(0.75, 1.0, 0.5), a(0.5, 1.25, 0.0)],
        [a(1.0, -1.0, 1.0)], {"margin": 0.25}, 1),
}


def _call(mod, name, diff, other, kw, first_other):
    fn = getattr(mod, name)
    if first_other:           # margin_rank_loss(label, left, right)
        return fn(*other, *diff, **kw)
    return fn(*diff, *other, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_at_the_kink_matches_jax(case):
    name, diff, other, kw, *flag = CASES[case]
    first_other = bool(flag)
    xs = [torch.tensor(d, requires_grad=True) for d in diff]
    out = _call(tops, name, xs, [torch.tensor(o) for o in other], kw,
                first_other)
    got = torch.autograd.grad(out.sum(), xs)

    def loss(*ds):
        return jnp.sum(_call(jops, name, list(ds),
                             [jnp.asarray(o) for o in other], kw,
                             first_other))
    want = jax.jit(jax.grad(loss, argnums=tuple(range(len(diff)))))(
        *[jnp.asarray(d) for d in diff])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=case)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(_call(
        jops, name, [jnp.asarray(d) for d in diff],
        [jnp.asarray(o) for o in other], kw, first_other)), rtol=TOL,
        atol=TOL, err_msg=case)


def test_the_kinks_take_the_jax_halves():
    """The values that F9 repairs, spelled out: relu 0.5 at 0, relu6 0.5 at
    each bound, abs 1 at 0, sigmoid cross-entropy -label at logit 0."""
    x = torch.tensor([0.0, 6.0], requires_grad=True)
    (g,) = torch.autograd.grad(tops.relu6(x).sum(), x)
    assert g.tolist() == [0.5, 0.5]
    x = torch.tensor([0.0], requires_grad=True)
    (g,) = torch.autograd.grad(tops.relu(x).sum(), x)
    assert g.tolist() == [0.5]
    (g,) = torch.autograd.grad(tops.abs(x).sum(), x)
    assert g.tolist() == [1.0]
    (g,) = torch.autograd.grad(tops.sigmoid_cross_entropy_with_logits(
        x, torch.tensor([0.25])).sum(), x)
    assert g.tolist() == [-0.25]


def _relu_conv_program(pt):
    """One conv2d(act="relu") over [2, 1, 1, 1] images: a 2x2 filter with
    padding 1 and a zero bias, SGD at rate 1 on the mean."""
    main, startup = pt.Program(), pt.Program()
    w = np.array([[[[1.0, -1.0], [-1.0, -1.0]]]], np.float32)
    with pt.program_guard(main, startup), pt.framework.unique_name.guard():
        x = pt.data("x", [1, 1, 1], "float32")
        y = pt.layers.conv2d(
            x, 1, 2, padding=1, act="relu",
            param_attr=pt.ParamAttr(
                name="w", initializer=pt.initializer.NumpyArrayInitializer(
                    w)),
            bias_attr=pt.ParamAttr(
                name="b", initializer=pt.initializer.Constant(0.0)))
        loss = pt.layers.mean(y)
        pt.optimizer.SGD(1.0).minimize(loss)
    return main, startup, loss


def test_relu_conv_program_takes_one_sgd_step_like_jax():
    """F9 in a Program: the zero image's outputs sit on the ReLU's kink (4
    of the 8 outputs, gradient 0.5 each), the ones image's outputs are the
    flipped filter (1 of 4 positive): the bias's gradient is (4 * 0.5 + 1)
    / 8 = 0.375 in JAX and now in the port, where ``torch.relu``'s 0 at the
    tie gave 0.125."""
    feed = {"x": np.array([[[[0.0]]], [[[1.0]]]], np.float32)}
    biases = []
    for pt, exe in ((tpt, tpt.Executor(tpt.CPUPlace())),
                    (jpt, jpt.static.Executor(jpt.CPUPlace()))):
        main, startup, loss = _relu_conv_program(pt)
        scope = pt.Scope() if pt is tpt else pt.static.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        biases.append(np.asarray(scope.find_var("b")))
    np.testing.assert_array_equal(biases[0], biases[1])
    np.testing.assert_array_equal(biases[0], np.array([-0.375], np.float32))
