"""``ops/ctc.py`` and its ``layers`` wrappers in the port against the JAX
package, on the CPU.

- ``ctc_loss`` / ``warpctc``: the losses and the logits' gradient under a
  seeded cotangent against ``jax.jit`` of the JAX op and of its
  ``jax.vjp``, at ragged logit and label lengths, with repeated labels
  (the skip mask), an empty label, ``norm_by_times`` and a blank that is
  not 0; fp32, 1e-5 of the largest magnitude (the log-space recursion
  rounds in another order).
- ``ctc_align`` and ``ctc_greedy_decoder``: outputs and lengths equal,
  with ties in the argmax (the first max wins in both) and ragged lengths.
- ``edit_distance``: equal at empty hypotheses and references, normalized
  and not (exact: integer costs in fp32).
- The wrappers in a Program: the documents equal, the optional lengths in
  attribute positions promoted to inputs, both outputs of the multi-output
  ops, and one run equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import ops as jops
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import ops as tops

TOL = 1e-5


@pytest.fixture(autouse=True)
def _eager_mode():
    with static_mode_guard(False):
        yield


R = np.random.RandomState(23)


def _close(got, want, where, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=where)


#: (batch, time, classes, max label, logit lengths, label lengths, blank,
#: norm_by_times, repeated labels)
LOSS_CASES = [
    (3, 8, 5, 3, [8, 6, 3], [3, 2, 1], 0, False, False),
    (4, 10, 6, 4, [10, 10, 7, 4], [4, 0, 3, 2], 0, True, True),
    (2, 6, 4, 3, None, None, 3, False, True),
    (3, 12, 7, 5, [12, 9, 5], [5, 0, 2], 6, True, False),
    (2, 5, 3, 2, [5, 1], [2, 0], 0, False, True),
]


def _labels(b, l, c, blank, repeated):
    """Label ids that are not the blank, repeated neighbours if asked."""
    ids = [i for i in range(c) if i != blank]
    lab = np.array(ids, np.int32)[R.randint(0, len(ids), (b, l))]
    if repeated and l > 1:
        lab[:, 1] = lab[:, 0]
    return lab


@pytest.mark.parametrize("k", range(len(LOSS_CASES)))
@pytest.mark.parametrize("name", ["ctc_loss", "warpctc"])
def test_loss_and_gradient_match_jax(name, k):
    b, t, c, l, tl, ll, blank, norm, rep = LOSS_CASES[k]
    x = R.randn(b, t, c).astype(np.float32) * 2
    lab = _labels(b, l, c, blank, rep)
    tl_a = None if tl is None else np.array(tl, np.int32)
    ll_a = None if ll is None else np.array(ll, np.int32)
    xt = torch.tensor(x, requires_grad=True)
    got = getattr(tops, name)(
        xt, torch.tensor(lab), None if tl is None else torch.tensor(tl_a),
        None if ll is None else torch.tensor(ll_a), blank, norm)

    def jfn(v):
        return getattr(jops, name)(v, jnp.asarray(lab), tl_a, ll_a, blank,
                                   norm)
    want = jax.jit(jfn)(jnp.asarray(x))
    _close(got.detach().numpy(), want, "loss")
    assert got.dtype == torch.float32 and np.all(np.isfinite(
        got.detach().numpy()))
    cot = R.randn(b).astype(np.float32)
    (g,) = torch.autograd.grad(got, xt, torch.tensor(cot))
    _, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jg,) = jax.jit(lambda c_: vjp(c_))(jnp.asarray(cot))
    _close(g.numpy(), jg, "gradient")
    # frames past a logit length get no gradient
    if tl is not None:
        for i, n in enumerate(tl):
            assert not g[i, n:].any()


def test_empty_label_loss_is_the_all_blank_path():
    """A label length of 0: the loss is -sum_t log p(blank)."""
    x = R.randn(1, 5, 4).astype(np.float32)
    got = tops.ctc_loss(torch.tensor(x), torch.zeros(1, 2, dtype=torch.int32),
                        None, torch.tensor([0]), blank=2)
    logp = torch.log_softmax(torch.tensor(x), -1)
    torch.testing.assert_close(got, -logp[0, :, 2].sum().reshape(1),
                               rtol=1e-6, atol=1e-6)


ALIGN_CASES = [
    (np.array([[0, 1, 1, 0, 2, 2, 2, 0, 1, 3],
               [3, 3, 0, 0, 0, 1, 0, 1, 1, 0]], np.int32), None, 0, 0),
    (np.array([[0, 1, 1, 0, 2, 2, 2, 0, 1, 3],
               [3, 3, 0, 0, 0, 1, 0, 1, 1, 0]], np.int32),
     np.array([6, 0], np.int32), 0, -1),
    (np.array([[2, 2, 2, 1, 1, 0], [1, 2, 1, 2, 2, 2]], np.int32),
     np.array([6, 4], np.int32), 2, 7),
]


@pytest.mark.parametrize("k", range(len(ALIGN_CASES)))
def test_ctc_align_matches_jax(k):
    x, lens, blank, pad = ALIGN_CASES[k]
    got = tops.ctc_align(torch.tensor(x), None if lens is None
                         else torch.tensor(lens), blank, pad)
    want = jops.ctc_align(x, lens, blank, pad)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("blank", [None, 0, 2])
def test_greedy_decoder_ties_take_the_first_max(blank):
    """Logits with tied maxima in most frames (quarter steps): the first
    maximal class wins in both packages, then the collapse; ragged
    lengths."""
    x = (np.round(R.uniform(0, 1, (3, 9, 4)) * 2) / 2).astype(np.float32)
    lens = np.array([9, 5, 0], np.int32)
    got = tops.ctc_greedy_decoder(torch.tensor(x), blank, torch.tensor(lens),
                                  padding_value=-1)
    want = jops.ctc_greedy_decoder(jnp.asarray(x), blank, lens,
                                   padding_value=-1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1][2] == 0
    ties = (x == x.max(-1, keepdims=True)).sum(-1)
    assert (ties > 1).sum() > 5
    got3 = tops.ctc_align(torch.tensor(x), torch.tensor(lens), 3)
    want3 = jops.ctc_align(jnp.asarray(x), lens, 3)
    for g, w in zip(got3, want3):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


EDIT_CASES = [
    # hyps, refs, hyp lengths, ref lengths
    ([[1, 2, 3, 0], [1, 1, 0, 0], [5, 6, 7, 8]],
     [[1, 3, 0], [2, 2, 2], [5, 6, 7]], [3, 2, 4], [2, 0, 3]),
    ([[0, 0, 0], [4, 4, 4], [1, 2, 1]], [[1, 2], [4, 4], [2, 1]],
     [0, 3, 3], [2, 0, 0]),
    ([[1, 2, 3, 4, 5, 6]], [[6, 5, 4, 3, 2, 1, 0, 0]], [6], [6]),
    ([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]], [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2]],
     None, None),
]


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("k", range(len(EDIT_CASES)))
def test_edit_distance_matches_jax(k, normalized):
    h, r, hl, rl = (None if v is None else np.array(v, np.int32)
                    for v in EDIT_CASES[k])
    got = tops.edit_distance(torch.tensor(h), torch.tensor(r),
                             None if hl is None else torch.tensor(hl),
                             None if rl is None else torch.tensor(rl),
                             normalized)
    want = jops.edit_distance(h, r, hl, rl, normalized)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1]) == h.shape[0]


def test_edit_distance_conventions():
    """An empty reference gives the hypothesis length (not normalized); an
    empty hypothesis gives the reference length (1 normalized)."""
    h = torch.tensor([[1, 2, 0], [0, 0, 0]])
    r = torch.tensor([[0, 0], [3, 4]])
    d, n = tops.edit_distance(h, r, torch.tensor([2, 0]),
                              torch.tensor([0, 2]))
    assert d.tolist() == [2.0, 1.0] and int(n) == 2
    d, _ = tops.edit_distance(h, r, torch.tensor([2, 0]),
                              torch.tensor([0, 2]), normalized=False)
    assert d.tolist() == [2.0, 2.0]


# ---------------------------------------------------------------------------
# the layers in a Program
# ---------------------------------------------------------------------------
def _ctc_net(pt):
    L = pt.layers
    x = pt.data("x", [7, 5], "float32")
    lab = pt.data("lab", [3], "int32")
    tl = pt.data("tl", [], "int32")
    ll = pt.data("ll", [], "int32")
    loss = L.ctc_loss(x, lab, tl, ll, blank=4)
    wloss = L.warpctc(x, lab, input_length=tl, label_length=ll, blank=4,
                      norm_by_times=True)
    dec, dlen = L.ctc_greedy_decoder(x, blank=4, input_length=tl)
    ali, alen = L.ctc_align(L.arg_max(x, 2), tl, blank=4)
    dist, num = L.edit_distance(dec, lab, input_length=dlen,
                                label_length=ll)
    return [loss, wloss, dec, dlen, ali, alen, dist, num]


def _build(pt, unique_name):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        outs = _ctc_net(pt)
    return main, outs


def test_layers_build_and_run_like_jax():
    from paddle_tpu.static import serialize as jser
    from paddle_tpu_torch.static import serialize as tser
    tm, touts = _build(tpt, tpt.unique_name)
    jm, jouts = _build(jpt, junique)
    assert tser.program_to_dict(tm) == jser.program_to_dict(jm)
    ops = {op.type: op for op in tm.global_block().ops}
    assert ops["warpctc"].attrs["_tensor_params"] == (
        "input", "label", "input_length", "label_length")
    assert len(ops["edit_distance"].outputs["Out"]) == 2
    assert [o.name for o in touts] == [o.name for o in jouts]
    feed = {"x": R.randn(3, 7, 5).astype(np.float32),
            "lab": R.randint(0, 4, (3, 3)).astype(np.int32),
            "tl": np.array([7, 4, 2], np.int32),
            "ll": np.array([3, 1, 0], np.int32)}
    fetch = [o.name for o in touts]
    got = tpt.Executor(tpt.CPUPlace()).run(tm, feed=feed, fetch_list=fetch)
    want = jpt.static.Executor(jpt.CPUPlace()).run(jm, feed=feed,
                                                   fetch_list=fetch)
    for n, g, w in zip(fetch, got, want):
        _close(g, w, n)
        assert jax.dtypes.canonicalize_dtype(g.dtype) == np.asarray(w).dtype
