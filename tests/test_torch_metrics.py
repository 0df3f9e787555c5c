"""The metric ops (``ops/metric_ops.py``) in the port against the JAX package,
on the CPU, and their ``layers`` wrappers in a Program.

``accuracy`` and ``auc`` are tensor ops: ``accuracy`` held within 1e-6
(its count of correct rows is exact; XLA's mean may multiply by the
reciprocal, an ulp off the division) including tied scores (the first
maximum for k = 1, the stable descending order for k > 1), and ``auc``
within 1e-6 (the trapezoid sums in another order) including probabilities
that fall on bin edges (``p * num_thresholds`` truncated in fp32), p = 1
(clipped to the last bin) and two-column predictions. ``precision_recall``,
``chunk_eval`` and ``positive_negative_pair`` are the JAX package's numpy
code: their results are equal, from tensors and from arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.ops import metric_ops as jm
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.ops import metric_ops as tm

R = np.random.RandomState(8)


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d)."""
    with static_mode_guard(False):
        yield


def test_every_name_is_ported_and_exported():
    assert tm.__all__ == jm.__all__
    for n in tm.__all__:
        assert getattr(tops, n) is getattr(tm, n)
        assert getattr(tpt.layers, n).__wrapped__ is getattr(tm, n)


def _tied_scores():
    """Scores on a grid of quarters: many rows hold tied maxima."""
    return (np.round(R.uniform(0, 1, (40, 6)) * 4) / 4).astype(np.float32)


ACC = [
    ("top-1 ties, [B, 1] labels", _tied_scores(),
     R.randint(0, 6, (40, 1)).astype(np.int64), 1),
    ("top-1, [B] labels", R.randn(30, 10).astype(np.float32),
     R.randint(0, 10, 30).astype(np.int32), 1),
    ("top-3 ties", _tied_scores(), R.randint(0, 6, (40, 1)).astype(np.int64),
     3),
    ("top-5", R.randn(30, 10).astype(np.float32),
     R.randint(0, 10, (30, 1)).astype(np.int64), 5),
    ("all scores equal, top-2", np.zeros((6, 4), np.float32),
     np.array([[0], [1], [2], [3], [1], [0]], np.int64), 2),
]


@pytest.mark.parametrize("case", ACC, ids=[c[0] for c in ACC])
def test_accuracy_matches_jax(case):
    _, x, label, k = case
    got = tm.accuracy(torch.tensor(x), torch.tensor(label), k=k)
    want = jax.jit(lambda a, b: jm.accuracy(a, b, k=k))(jnp.asarray(x),
                                                         jnp.asarray(label))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)
    n = len(x)
    assert round(float(got) * n) == round(float(want) * n)


def test_accuracy_takes_the_first_maximum():
    x = torch.tensor([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0]])
    assert float(tm.accuracy(x, torch.tensor([1, 0]))) == 1.0
    assert float(tm.accuracy(x, torch.tensor([2, 2]))) == 0.0
    assert float(tm.accuracy(x, torch.tensor([2, 1]), k=2)) == 1.0
    assert float(tm.accuracy(x, torch.tensor([0, 2]), k=2)) == 0.0


def _edges(n, t):
    """Probabilities on the bins' edges (i / t), between them, 0 and 1."""
    p = R.randint(0, t + 1, n) / t
    p[::3] = R.uniform(0, 1, len(p[::3]))
    return p.astype(np.float32)


AUC = [
    ("bin edges, 8 thresholds", _edges(64, 8), R.randint(0, 2, 64), 8),
    ("bin edges, 4096 thresholds", _edges(200, 4096), R.randint(0, 2, 200),
     4096),
    ("every p = 1", np.ones(10, np.float32), R.randint(0, 2, 10), 16),
    ("one class only", R.uniform(0, 1, 20).astype(np.float32),
     np.ones(20, np.int64), 32),
    ("fp32 products that round", (np.arange(1, 40) * 0.1 / 4).astype(
        np.float32), np.arange(39) % 2, 10),
]


@pytest.mark.parametrize("case", AUC, ids=[c[0] for c in AUC])
@pytest.mark.parametrize("two_col", [False, True])
def test_auc_matches_jax(case, two_col):
    _, p, label, t = case
    x = np.stack([1 - p, p], 1) if two_col else p[:, None]
    label = label.reshape(-1, 1)
    got = tm.auc(torch.tensor(x), torch.tensor(label), num_thresholds=t)
    want = jax.jit(lambda a, b: jm.auc(a, b, num_thresholds=t))(
        jnp.asarray(x), jnp.asarray(label))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)


def test_precision_recall_matches_jax():
    scores = _tied_scores()
    label = R.randint(0, 6, 40)
    for p, lab in ((scores, label), (torch.tensor(scores),
                                     torch.tensor(label))):
        got = tm.precision_recall(p, lab, 6)
        want = jm.precision_recall(jnp.asarray(scores), label, 6)
        assert got == want


def _tags(scheme, n, types):
    width = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    return R.randint(0, types * width + 1, n)     # the last tag is "O"


@pytest.mark.parametrize("scheme", ["IOB", "IOE", "IOBES", "plain"])
def test_chunk_eval_matches_jax(scheme):
    for trial in range(4):
        inf, lab = _tags(scheme, 60, 3), _tags(scheme, 60, 3)
        lab[:30] = inf[:30]                       # some chunks agree
        kw = [{}, {"num_chunk_types": 3}, {"num_chunk_types": 3,
                                           "excluded_chunk_types": (1,)},
              {"excluded_chunk_types": (0, 2)}][trial]
        got = tm.chunk_eval(torch.tensor(inf), torch.tensor(lab), scheme,
                            **kw)
        want = jm.chunk_eval(inf, lab, scheme, **kw)
        assert got == want, (scheme, kw)
    with pytest.raises(ValueError):
        tm.chunk_eval(inf, lab, "BIO")


def test_positive_negative_pair_matches_jax():
    score = np.round(R.uniform(0, 1, 50) * 5) / 5          # with ties
    label = R.randint(0, 3, 50)
    query = R.randint(0, 6, 50)
    got = tm.positive_negative_pair(torch.tensor(score), torch.tensor(label),
                                    torch.tensor(query))
    want = jm.positive_negative_pair(score, label, query)
    assert got == want and got[2] > 0


def _metric_program(pt, unique_name):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        x = pt.data("x", [5], "float32")
        label = pt.data("label", [1], "int64")
        prob = pt.layers.softmax(x)
        acc1 = pt.layers.accuracy(prob, label)
        acc3 = pt.layers.accuracy(prob, label, k=3)
        p = pt.layers.data("p", [2], "float32")
        auc = pt.layers.auc(p, label, num_thresholds=64)
    return main, [acc1, acc3, auc]


def test_accuracy_and_auc_layers_match_jax():
    """``layers.accuracy`` and ``layers.auc`` in a Program: the documents
    are equal, and so are the values the two Executors fetch."""
    from paddle_tpu.static import serialize as jser
    from paddle_tpu_torch.static import serialize as tser
    tprog, touts = _metric_program(tpt, tpt.unique_name)
    jprog, jouts = _metric_program(jpt, junique)
    assert tser.program_to_dict(tprog) == jser.program_to_dict(jprog)
    p = _edges(32, 64)
    feed = {"x": np.round(R.randn(32, 5)).astype(np.float32),
            "label": R.randint(0, 2, (32, 1)).astype(np.int64),
            "p": np.stack([1 - p, p], 1)}
    got = tpt.Executor(tpt.CPUPlace()).run(tprog, feed=feed,
                                           fetch_list=touts,
                                           scope=tpt.Scope())
    want = jpt.static.Executor(jpt.CPUPlace()).run(
        jprog, feed=feed, fetch_list=jouts, scope=jpt.static.Scope())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
