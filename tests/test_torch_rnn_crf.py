"""The linear-chain CRF and the recurrent ops of the port against the JAX
package, on the CPU, forward and gradients; then their layers in a
Program (the promoted ``length`` / ``lengths`` inputs, one output
Variable for ``dynamic_lstm``) against the JAX package's documents.

Inputs come from numpy seeds; the port runs its Python loops over time,
the JAX package its ``lax.scan``. Tolerances: losses, outputs and
gradients 1e-5 (fp32 sums over a few steps in another order); Viterbi
paths exactly (continuous emissions: no ties); the CRF's gradient in fp64
against ``jax.grad`` 1e-10 and against a central difference 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.ops import crf as jcrf
from paddle_tpu.ops import rnn as jrnn
from paddle_tpu.static import serialize as jser

import paddle_tpu_torch as tpt
from paddle_tpu_torch.ops import crf as tcrf
from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.static import serialize as tser

TOL = 1e-5


def _np(seed, *shape, scale=1.0, dtype=np.float32):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(dtype)


def _grads(jfn, tfn, arrays, argnums):
    """Value and gradients of ``sum(sin(f(...)))`` in both packages over
    the arrays at ``argnums`` (None entries pass through)."""
    def jl(*xs):
        out = jfn(*xs)
        return sum(jnp.sum(jnp.sin(o)) for o in jax.tree.leaves(out)), out

    (jv, jout), jg = jax.jit(jax.value_and_grad(
        jl, argnums=argnums, has_aux=True))(
        *[None if a is None else jnp.asarray(a) for a in arrays])
    ts = [None if a is None else torch.tensor(a) for a in arrays]
    for i in argnums:
        ts[i].requires_grad_()
    tout = tfn(*ts)
    flat = []

    def walk(o):
        if isinstance(o, (tuple, list)):
            for v in o:
                walk(v)
        else:
            flat.append(o)
    walk(tout)
    tv = sum(torch.sum(torch.sin(o)) for o in flat)
    tg = torch.autograd.grad(tv, [ts[i] for i in argnums])
    return (jv, jax.tree.leaves(jout), jg), (tv, flat, tg)


def _assert_same(j, t, tol=TOL):
    (jv, jout, jg), (tv, tout, tg) = j, t
    assert len(jout) == len(tout)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=tol, atol=tol)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=tol,
                               atol=tol)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol)


# ---------------------------------------------------------------------------
# CRF
# ---------------------------------------------------------------------------
CRF = [  # B, T, D, lengths (None = full)
    (3, 5, 4, [5, 1, 3]),
    (2, 4, 3, None),
    (1, 6, 5, [6]),
    (4, 3, 2, [0, 3, 1, 2]),
]


@pytest.mark.parametrize("B,T,D,lens", CRF)
def test_linear_chain_crf_matches_jax_with_gradients(B, T, D, lens):
    em = _np(0, B, T, D)
    trans = _np(1, D + 2, D, scale=0.5)
    lab = np.random.RandomState(2).randint(0, D, (B, T))
    ln = None if lens is None else np.array(lens, np.int32)
    # the [B, T, 1] label form once
    for label in (lab, lab[..., None]) if lens == CRF[0][3] else (lab,):
        j, t = _grads(
            lambda e, tr: jcrf.linear_chain_crf(e, tr, label, ln),
            lambda e, tr: tcrf.linear_chain_crf(
                e, tr, torch.tensor(label),
                None if ln is None else torch.tensor(ln)),
            [em, trans], (0, 1))
        _assert_same(j, t)


@pytest.mark.parametrize("B,T,D,lens", CRF[:2] + CRF[3:])
def test_crf_decoding_matches_jax(B, T, D, lens):
    em = _np(3, B, T, D)
    trans = _np(4, D + 2, D, scale=0.5)
    ln = None if lens is None else np.array(lens, np.int32)
    want = np.asarray(jcrf.crf_decoding(jnp.asarray(em), jnp.asarray(trans),
                                        None if ln is None
                                        else jnp.asarray(ln)))
    got = tcrf.crf_decoding(torch.tensor(em), torch.tensor(trans),
                            None if ln is None else torch.tensor(ln))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if ln is not None:
        assert (got.numpy()[np.arange(T)[None, :] >= ln[:, None]] == 0).all()


def test_crf_decoding_takes_the_first_maximum_on_ties():
    """All-equal scores: the JAX argmax's first index, and the port's."""
    em = np.zeros((2, 4, 3), np.float32)
    trans = np.zeros((5, 3), np.float32)
    got = tcrf.crf_decoding(torch.tensor(em), torch.tensor(trans))
    want = jcrf.crf_decoding(jnp.asarray(em), jnp.asarray(trans))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 0).all()


def test_crf_gradient_in_fp64_matches_jax_grad_and_a_numeric_one():
    """tests/test_book.py's gradient check (op_test.py's numeric gradient),
    on the port, and held to ``jax.grad`` too."""
    rng = np.random.RandomState(0)
    em = rng.randn(2, 4, 3) * 0.5
    trans = rng.randn(5, 3) * 0.3
    lab = rng.randint(0, 3, (2, 4))
    length = np.array([4, 2], np.int32)
    tem, tlab, tlen = (torch.tensor(em), torch.tensor(lab),
                       torch.tensor(length))

    def f(tr):
        return torch.sum(tcrf.linear_chain_crf(tem, tr, tlab, tlen))

    tr = torch.tensor(trans, requires_grad=True)
    ana = torch.autograd.grad(f(tr), [tr])[0].numpy()
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(
            jcrf.linear_chain_crf(em, t, lab, length))))(
                jnp.asarray(trans)))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert want.dtype == np.float64
    np.testing.assert_allclose(ana, want, rtol=1e-10, atol=1e-10)
    num = np.zeros_like(trans)
    eps = 1e-5
    with torch.no_grad():
        for i in range(trans.shape[0]):
            for k in range(trans.shape[1]):
                tp, tm = trans.copy(), trans.copy()
                tp[i, k] += eps
                tm[i, k] -= eps
                num[i, k] = (float(f(torch.tensor(tp)))
                             - float(f(torch.tensor(tm)))) / (2 * eps)
    np.testing.assert_allclose(ana, num, atol=1e-6)


# ---------------------------------------------------------------------------
# the recurrent ops
# ---------------------------------------------------------------------------
B, T, D, H = 3, 5, 4, 6
LENS = [None, [5, 1, 3], [0, 5, 2]]


def _ln(lens):
    return None if lens is None else np.array(lens, np.int32)


@pytest.mark.parametrize("lens,reverse,peep", [
    (None, False, False), (LENS[1], True, True), (LENS[2], False, True),
    (LENS[2], True, False)])
def test_lstm_matches_jax_with_gradients(lens, reverse, peep):
    ln = _ln(lens)
    arrays = [_np(10, B, T, D), _np(11, D, 4 * H, scale=0.4),
              _np(12, H, 4 * H, scale=0.4), _np(13, 4 * H, scale=0.1),
              _np(14, B, H, scale=0.5), _np(15, B, H, scale=0.5),
              _np(16, 3 * H, scale=0.3) if peep else None]

    def call(mod, lenv):
        return lambda x, wi, wh, b, h0, c0, p: mod.lstm(
            x, wi, wh, b=b, h0=h0, c0=c0, lengths=lenv, reverse=reverse,
            peepholes=p)

    argnums = (0, 1, 2, 3, 4, 5) + ((6,) if peep else ())
    j, t = _grads(call(jrnn, None if ln is None else jnp.asarray(ln)),
                  call(trnn, None if ln is None else torch.tensor(ln)),
                  arrays, argnums)
    _assert_same(j, t)


@pytest.mark.parametrize("lens,reverse,bias", [
    (LENS[1], True, "7H"), (LENS[2], False, "7H"), (None, True, "4H"),
    (LENS[1], False, None)])
def test_dynamic_lstm_matches_jax_with_gradients(lens, reverse, bias):
    ln = _ln(lens)
    width = {"7H": 7 * H, "4H": 4 * H}.get(bias)
    arrays = [_np(20, B, T, 4 * H), _np(21, H, 4 * H, scale=0.4),
              None if width is None else _np(22, 1, width, scale=0.3)]

    def call(mod, lenv):
        return lambda x, wh, b: mod.dynamic_lstm(
            x, wh, b, lengths=lenv, is_reverse=reverse)

    argnums = (0, 1) + ((2,) if width else ())
    j, t = _grads(call(jrnn, None if ln is None else jnp.asarray(ln)),
                  call(trnn, None if ln is None else torch.tensor(ln)),
                  arrays, argnums)
    _assert_same(j, t)
    with pytest.raises(ValueError, match="7H"):
        trnn.dynamic_lstm(torch.zeros(B, T, 4 * H), torch.zeros(H, 4 * H),
                          torch.zeros(5 * H))


@pytest.mark.parametrize("lens,reverse", [(LENS[1], True), (LENS[2], False)])
def test_dynamic_lstmp_matches_jax_with_gradients(lens, reverse):
    ln, P = _ln(lens), 3
    arrays = [_np(30, B, T, 4 * H), _np(31, P, 4 * H, scale=0.4),
              _np(32, H, P, scale=0.4), _np(33, 4 * H, scale=0.1)]

    def call(mod, lenv):
        return lambda x, wh, wp, b: mod.dynamic_lstmp(
            x, wh, wp, b, lengths=lenv, is_reverse=reverse)

    j, t = _grads(call(jrnn, None if ln is None else jnp.asarray(ln)),
                  call(trnn, None if ln is None else torch.tensor(ln)),
                  arrays, (0, 1, 2, 3))
    _assert_same(j, t)


@pytest.mark.parametrize("lens,reverse,origin", [
    (None, False, False), (LENS[1], True, True), (LENS[2], False, True),
    (LENS[2], True, False)])
def test_gru_matches_jax_with_gradients(lens, reverse, origin):
    ln = _ln(lens)
    arrays = [_np(40, B, T, D), _np(41, D, 3 * H, scale=0.4),
              _np(42, H, 3 * H, scale=0.4), _np(43, 3 * H, scale=0.1),
              _np(44, B, H, scale=0.5)]

    def call(mod, lenv):
        return lambda x, wi, wh, b, h0: mod.gru(
            x, wi, wh, b=b, h0=h0, lengths=lenv, reverse=reverse,
            origin_mode=origin)

    j, t = _grads(call(jrnn, None if ln is None else jnp.asarray(ln)),
                  call(trnn, None if ln is None else torch.tensor(ln)),
                  arrays, (0, 1, 2, 3, 4))
    _assert_same(j, t)
    # the projected form
    def dyn(mod, lenv):
        return lambda x, wh, b: mod.dynamic_gru(
            x, wh, b, lengths=lenv, is_reverse=reverse, origin_mode=origin)

    j, t = _grads(dyn(jrnn, None if ln is None else jnp.asarray(ln)),
                  dyn(trnn, None if ln is None else torch.tensor(ln)),
                  [_np(45, B, T, 3 * H), arrays[2], arrays[3]], (0, 1, 2))
    _assert_same(j, t)


def test_gru_applies_the_reset_before_the_recurrent_product():
    """Paddle's candidate tanh(xc + (r*h) @ w_c), not PyTorch's
    r * (h @ W): one step by hand from a nonzero h0."""
    x = torch.tensor(_np(46, 1, 1, 3 * H))
    wh = torch.tensor(_np(47, H, 3 * H, scale=0.5))
    h0 = torch.tensor(_np(48, 1, H))
    out, _ = trnn.dynamic_gru(x, wh, h0=h0)
    xu, xr, xc = torch.chunk(x[:, 0], 3, dim=-1)
    u = torch.sigmoid(xu + h0 @ wh[:, :H])
    r = torch.sigmoid(xr + h0 @ wh[:, H:2 * H])
    c = torch.tanh(xc + (r * h0) @ wh[:, 2 * H:])
    torch.testing.assert_close(out[:, 0], (1 - u) * h0 + u * c)


@pytest.mark.parametrize("lens", LENS[1:])
def test_simple_rnn_and_bidirectional_lstm_match_jax(lens):
    ln = _ln(lens)
    arrays = [_np(50, B, T, D), _np(51, D, H, scale=0.4),
              _np(52, H, H, scale=0.4), _np(53, H, scale=0.1),
              _np(54, B, H, scale=0.5)]

    def rnn(mod, lenv):
        return lambda x, wi, wh, b, h0: mod.simple_rnn(x, wi, wh, b, h0,
                                                       lengths=lenv)

    j, t = _grads(rnn(jrnn, None if ln is None else jnp.asarray(ln)),
                  rnn(trnn, None if ln is None else torch.tensor(ln)),
                  arrays, (0, 1, 2, 3, 4))
    _assert_same(j, t)
    arrays = [_np(55, B, T, D)] + [
        _np(56 + i, *s, scale=0.4) for i, s in enumerate(
            ((D, 4 * H), (H, 4 * H), (D, 4 * H), (H, 4 * H), (4 * H,),
             (4 * H,)))]

    def bi(mod, lenv):
        return lambda x, fi, fh, bi_, bh, fb, bb: mod.bidirectional_lstm(
            x, fi, fh, bi_, bh, fb, bb, lengths=lenv)

    j, t = _grads(bi(jrnn, None if ln is None else jnp.asarray(ln)),
                  bi(trnn, None if ln is None else torch.tensor(ln)),
                  arrays, tuple(range(7)))
    _assert_same(j, t)


@pytest.mark.parametrize("lens", [None, LENS[2]])
def test_attention_lstm_matches_jax_with_gradients(lens):
    ln, M, Dc = _ln(lens), 4, 5
    arrays = [_np(60, B, T, M), _np(61, B, Dc, scale=0.5),
              _np(62, M + Dc, 1, scale=0.4), _np(63, M + Dc, 4 * Dc,
                                                 scale=0.4),
              _np(64, 1, scale=0.1), _np(65, 4 * Dc, scale=0.1),
              _np(66, B, Dc, scale=0.5)]

    def call(mod, lenv):
        return lambda x, c0, aw, lw, ab, lb, h0: mod.attention_lstm(
            x, c0, aw, lw, ab, lb, h0, lengths=lenv)

    j, t = _grads(call(jrnn, None if ln is None else jnp.asarray(ln)),
                  call(trnn, None if ln is None else torch.tensor(ln)),
                  arrays, tuple(range(7)))
    _assert_same(j, t)


def test_recurrences_read_nothing_on_the_host(monkeypatch):
    """A step reads no tensor value on the host: every conversion to a
    Python number raises while the loops run."""
    def boom(*a, **k):
        raise AssertionError("host read in a recurrence")

    for name in ("item", "__bool__", "__float__", "__int__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    ln = torch.tensor([5, 1, 3], dtype=torch.int32)
    x = torch.tensor(_np(70, B, T, 4 * H))
    trnn.dynamic_lstm(x, torch.tensor(_np(71, H, 4 * H)),
                      torch.tensor(_np(72, 7 * H)), lengths=ln,
                      is_reverse=True)
    trnn.gru(torch.tensor(_np(73, B, T, D)), torch.tensor(_np(74, D, 3 * H)),
             torch.tensor(_np(75, H, 3 * H)), lengths=ln)
    em = torch.tensor(_np(76, B, T, 4))
    tr = torch.tensor(_np(77, 6, 4))
    tcrf.linear_chain_crf(em, tr, torch.zeros(B, T, dtype=torch.int64), ln)
    tcrf.crf_decoding(em, tr, ln)


# ---------------------------------------------------------------------------
# the layers in a Program
# ---------------------------------------------------------------------------
def _tagger(pt, with_length, reverse):
    """embedding -> fc(num_flatten_dims=2) -> dynamic_lstm -> fc ->
    linear_chain_crf (+ crf_decoding), an int32 length feed."""
    words = pt.data("words", [-1, -1], "int64", lod_level=1)
    tags = pt.data("tags", [-1, -1], "int64", lod_level=1)
    length = pt.data("length", [], "int32") if with_length else None
    emb = pt.layers.embedding(words, size=[11, 4])
    proj = pt.layers.fc(emb, 4 * 3, num_flatten_dims=2)
    w_hh = pt.layers.create_parameter([3, 12], name="lstm_w")
    b = pt.layers.create_parameter([7 * 3], name="lstm_b", is_bias=True)
    hid = pt.layers.dynamic_lstm(proj, w_hh, b, lengths=length,
                                 is_reverse=reverse)
    feat = pt.layers.fc(hid, 5, num_flatten_dims=2, act="tanh")
    cost = pt.layers.linear_chain_crf(
        feat, tags, param_attr=pt.ParamAttr(name="crfw"), length=length)
    crfw = pt.default_main_program().global_block().var("crfw")
    decode = pt.layers.crf_decoding(feat, crfw, length=length)
    return hid, decode, pt.layers.mean(cost)


def _tagger_program(pt, unique_name, with_length, reverse):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        hid, decode, loss = _tagger(pt, with_length, reverse)
        test = main.clone(for_test=True)
        pt.optimizer.SGD(0.5).minimize(loss)
    return main, startup, hid, decode, loss, test


@pytest.mark.parametrize("with_length", [True, False])
def test_static_tagger_matches_jax(with_length):
    """The document (ops, attrs with ``_tensor_params``, vars with their
    lod_level, shapes), one Variable out of ``dynamic_lstm``, then 3 SGD
    steps from the JAX startup's weights and the decoded paths."""
    reverse = with_length
    jm, js, jhid, jdec, jloss, jtest = _tagger_program(jpt, junique,
                                                       with_length, reverse)
    tm, ts, thid, tdec, tloss, ttest = _tagger_program(
        tpt, tpt.unique_name, with_length, reverse)
    for t, j in ((tm, jm), (ts, js), (ttest, jtest)):
        assert tser.program_to_dict(t) == jser.program_to_dict(j)
    assert thid.shape == (-1, -1, 3) and tdec.shape == (-1, -1)
    ops = {op.type: op for op in tm.global_block().ops}
    lstm_op = ops["dynamic_lstm"]
    assert lstm_op.outputs["Out"] == [thid.name]
    if with_length:
        assert lstm_op.attrs["_tensor_params"] == (
            "input", "w_hh", "bias", "lengths")
        assert ops["crf_decoding"].attrs["_tensor_params"] == (
            "input", "transition", "length")
        assert len(ops["linear_chain_crf"].inputs["X"]) == 4
    assert tm.global_block().var("words").lod_level == 1
    jscope, jexe = jpt.static.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    names = sorted(n for n, v in js.global_block().vars.items()
                   if v.persistable)
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in names}, "cpu", ts)
    texe = tpt.Executor(tpt.CPUPlace())
    rng = np.random.RandomState(3)
    for step in range(3):
        Tn = 6
        words = rng.randint(0, 11, (4, Tn)).astype(np.int64)
        feed = {"words": words, "tags": (words % 5).astype(np.int64)}
        if with_length:
            feed["length"] = np.array([6, 1, 4, 0][:4], np.int32)
        jl = jexe.run(jm, feed=feed, fetch_list=[jloss], scope=jscope)[0]
        tl = texe.run(tm, feed=feed, fetch_list=[tloss], scope=tscope)[0]
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=TOL, atol=TOL)
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.array(jscope.find_var(n)), rtol=TOL,
                                   atol=TOL, err_msg=n)
    jd = jexe.run(jtest, feed=feed, fetch_list=[jdec], scope=jscope)[0]
    td = texe.run(ttest, feed=feed, fetch_list=[tdec], scope=tscope)[0]
    assert td.dtype == np.int32
    np.testing.assert_array_equal(td, np.asarray(jd))
