"""Ragged batches, the sequence ops and the module context of the port
against the JAX package, on the CPU.

``RaggedBatch`` and ``lod_tensor`` round trips and refusals; every one of
the 17 sequence ops over lengths that include 0, 1 and T and a batch of
one (every ``pool_type``); ``sequence_conv`` and ``nets.sequence_conv_pool``
forward and gradients; ``nn``'s module context (``transform``, ``Layer``
scopes, ``Sequential``, state, ``params_from_numpy``) with the JAX keys;
the port's refusal where a name is asked for again with another shape
(the JAX package silently reuses it); ``sums`` and ``create_parameter``.

Tolerances: the ops that only move, mask or compare values are exact;
those that sum, divide or exponentiate 1e-6; the convolution's matmul and
its gradients 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import layers as jlayers
from paddle_tpu import nets as jnets
from paddle_tpu import nn as jnn
from paddle_tpu import ops as jops
from paddle_tpu.core.enforce import EnforceNotMet as JEnforceNotMet
from paddle_tpu.core.lod import RaggedBatch as JRB
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import nets as tnets
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.lod import RaggedBatch as TRB


@pytest.fixture(autouse=True)
def _eager_mode():
    """The module context runs outside static mode; some JAX-package test
    files leave that package's static mode on for later files on their
    worker (ROADMAP queue 3 note d), so each test here runs with it off and
    puts it back after."""
    with static_mode_guard(False):
        yield


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _a(x):
    """A port or JAX value (or RaggedBatch, or tuple of them) as numpy."""
    if isinstance(x, (JRB, TRB)):
        return (_a(x.data), _a(x.lengths))
    if isinstance(x, (tuple, list)):
        return tuple(_a(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, want, tol):
    got, want = _a(got), _a(want)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    assert got.shape == want.shape, (got.shape, want.shape)
    # JAX without x64 holds int64 as int32; the port keeps int64
    assert jax.dtypes.canonicalize_dtype(got.dtype) == want.dtype, \
        (got.dtype, want.dtype)
    if tol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# RaggedBatch and lod_tensor
# ---------------------------------------------------------------------------
SEQS = [np.arange(3, dtype=np.int64), np.arange(5, dtype=np.int64) + 10,
        np.zeros(0, np.int64), np.array([7], np.int64)]


@pytest.mark.parametrize("max_len", [None, 4, 6])
def test_ragged_batch_round_trips_match_jax(max_len):
    j = JRB.from_list(SEQS, max_len=max_len)
    t = TRB.from_list(SEQS, max_len=max_len, device="cpu")
    _close(t, j, 0)
    for dt in (torch.float32, torch.int32):
        jdt = jnp.float32 if dt == torch.float32 else jnp.int32
        _close(t.mask(dt), j.mask(jdt), 0)
    _close(t.segment_ids(), j.segment_ids(), 0)
    jflat, jlod = j.to_lod()
    tflat, tlod = t.to_lod()
    np.testing.assert_array_equal(tflat, jflat)
    assert tlod == jlod
    assert (t.batch_size, t.max_len, tuple(t.shape)) == \
        (j.batch_size, j.max_len, tuple(j.shape))
    # back from the reference's offsets
    _close(TRB.from_lod(tflat, tlod, max_len=max_len, device="cpu"),
           JRB.from_lod(jflat, jlod, max_len=max_len), 0)
    feats = [np.ones((n, 2), np.float32) * n for n in (2, 0, 3)]
    _close(TRB.from_list(feats, device="cpu"), JRB.from_list(feats), 0)


def test_sequence_mask_matches_jax_and_needs_maxlen():
    lens = np.array([0, 1, 4, 2], np.int32)
    for maxlen in (4, 6):
        _close(tops.sequence_mask(torch.tensor(lens), maxlen),
               jops.sequence_mask(jnp.asarray(lens), maxlen), 0)
    with pytest.raises(ValueError, match="maxlen"):
        jops.sequence_mask(jnp.asarray(lens))
    with pytest.raises(ValueError, match="maxlen"):
        tops.sequence_mask(torch.tensor(lens))


RSL = [
    ([[2, 0, 3]], None),
    ([[1, 2], [2, 0, 3]], None),
    ([[3]], None),
]


@pytest.mark.parametrize("rsl", [r for r, _ in RSL])
def test_create_lod_tensor_matches_jax(rsl):
    rows = sum(rsl[-1])
    data = _np(1, rows, 3)
    j = jpt.create_lod_tensor(data, rsl)
    t = tpt.create_lod_tensor(data, rsl, tpt.CPUPlace())
    _close(t, j, 0)
    assert t.recursive_seq_lens == j.recursive_seq_lens
    lists = [list(range(n)) for n in rsl[-1]]
    _close(tpt.create_lod_tensor(lists, rsl, tpt.CPUPlace()),
           jpt.create_lod_tensor(lists, rsl), 0)
    _close(tpt.create_random_int_lodtensor(rsl, [2], tpt.CPUPlace(), 0, 9,
                                           seed=3),
           jpt.create_random_int_lodtensor(rsl, [2], None, 0, 9, seed=3), 0)


@pytest.mark.parametrize("args,match", [
    ((np.zeros((4, 2)), []), "non-empty"),
    ((np.zeros((4, 2)), [[]]), "non-empty"),
    ((np.zeros((4, 2)), [[1, 1], [2, 1, 1]]), "outer level"),
    ((np.zeros((4, 2)), [[1, 2]]), "data rows"),
    (([[1, 2], [3]], [[1, 2]]), "does not match"),
])
def test_create_lod_tensor_refuses_what_jax_refuses(args, match):
    with pytest.raises(JEnforceNotMet, match=match):
        jpt.create_lod_tensor(*args)
    with pytest.raises(EnforceNotMet, match=match):
        tpt.create_lod_tensor(*args, place=tpt.CPUPlace())


# ---------------------------------------------------------------------------
# the sequence ops
# ---------------------------------------------------------------------------
#: (lengths, T): zero-length, one-long and full rows; a batch of one
LENS = [([0, 1, 5, 3], 5), ([5], 5)]


def _pair(seed, lens, T, tail=(3,)):
    data = _np(seed, len(lens), T, *tail)
    ln = np.array(lens, np.int32)
    return ((jnp.asarray(data), jnp.asarray(ln)),
            (torch.tensor(data), torch.tensor(ln)))


def _ids(seed, lens, T, hi=6):
    data = np.random.RandomState(seed).randint(0, hi, (len(lens), T))
    ln = np.array(lens, np.int32)
    return ((jnp.asarray(data.astype(np.int32)), jnp.asarray(ln)),
            (torch.tensor(data.astype(np.int32)), torch.tensor(ln)))


@pytest.mark.parametrize("lens,T", LENS)
@pytest.mark.parametrize("pool", ["sum", "average", "mean", "sqrt", "max",
                                  "first", "last"])
def test_sequence_pool_matches_jax(lens, T, pool):
    j, t = _pair(0, lens, T)
    tol = 0 if pool in ("max", "first", "last") else 1e-6
    _close(tops.sequence_pool(t, pool), jops.sequence_pool(j, pool), tol)
    # through the RaggedBatch form and the layer, integer data too
    _close(tlayers.sequence_pool(TRB(*t), pool),
           jlayers.sequence_pool(JRB(*j), pool), tol)
    ji, ti = _ids(1, lens, T)
    if pool in ("sum", "max", "first", "last"):
        _close(tops.sequence_pool(ti, pool), jops.sequence_pool(ji, pool), 0)


def test_sequence_pool_max_of_an_empty_row_is_the_lowest_value():
    """Hazard of the padded form: no -inf, the dtype's lowest value."""
    j, t = _pair(0, [0, 2], 3)
    got = tops.sequence_pool(t, "max").numpy()
    assert (got[0] == np.finfo(np.float32).min).all()
    with pytest.raises(ValueError, match="unknown pool_type"):
        tops.sequence_pool(t, "median")


@pytest.mark.parametrize("lens,T", LENS)
def test_sequence_ops_match_jax(lens, T):
    j, t = _pair(2, lens, T)
    b = len(lens)
    ops = [
        ("sequence_first_step", lambda m, x: m.sequence_first_step(x), 0),
        ("sequence_last_step", lambda m, x: m.sequence_last_step(x), 0),
        ("sequence_softmax", lambda m, x: m.sequence_softmax(x), 1e-6),
        ("sequence_reverse", lambda m, x: m.sequence_reverse(x), 0),
        ("sequence_pad", lambda m, x: m.sequence_pad(x, -1.5), 0),
        ("sequence_pad longer", lambda m, x: m.sequence_pad(x, 2.0, T + 2),
         0),
        ("sequence_pad shorter", lambda m, x: m.sequence_pad(x, 0.0, T - 1),
         0),
    ]
    for name, f, tol in ops:
        _close(f(tops, t), f(jops, j), tol)
    _close(tops.sequence_unpad(*t), jops.sequence_unpad(*j), 0)
    xd = _np(3, b, 2)
    _close(tops.sequence_expand(torch.tensor(xd), t),
           jops.sequence_expand(jnp.asarray(xd), j), 0)
    _close(tops.sequence_expand_as(torch.tensor(xd), t),
           jops.sequence_expand_as(jnp.asarray(xd), j), 0)
    off = np.minimum(np.arange(b), T - 1).astype(np.int32)
    ln = np.full(b, 2, np.int32)
    _close(tops.sequence_slice(t, torch.tensor(off), torch.tensor(ln)),
           jops.sequence_slice(j, jnp.asarray(off), jnp.asarray(ln)), 0)
    idx = np.random.RandomState(4).randint(0, T, (b, 3))
    idx[:, 1] = idx[:, 0]           # a repeated position sums
    upd = _np(5, b, 3, 3)
    _close(tops.sequence_scatter(t[0], torch.tensor(idx), torch.tensor(upd)),
           jops.sequence_scatter(j[0], jnp.asarray(idx), jnp.asarray(upd)),
           1e-6)


@pytest.mark.parametrize("lens,T", LENS)
def test_sequence_concat_matches_jax(lens, T):
    parts_j, parts_t = [], []
    for seed, (ls, tt) in enumerate(((lens, T), ([min(l, 2) for l in lens],
                                                 2),
                                     ([T - l for l in lens], T))):
        j, t = _pair(10 + seed, ls, tt)
        parts_j.append(j)
        parts_t.append(t)
    _close(tops.sequence_concat(parts_t), jops.sequence_concat(parts_j),
           1e-6)
    _close(tlayers.sequence_concat([TRB(*p) for p in parts_t]),
           jlayers.sequence_concat([JRB(*p) for p in parts_j]), 1e-6)


@pytest.mark.parametrize("lens,T", LENS)
def test_sequence_int_ops_match_jax(lens, T):
    j, t = _ids(6, lens, T)
    for win, pad in ((1, 0), (2, -1), (4, 9)):
        _close(tops.sequence_enumerate(t, win, pad),
               jops.sequence_enumerate(j, win, pad), 0)
    for toks in ([0], [1, 3], [7]):
        _close(tops.sequence_erase(t, toks), jops.sequence_erase(j, toks), 0)


@pytest.mark.parametrize("lens,T,m,nd", [
    ([2, 4, 0], 4, 6, 3), ([4], 4, 2, 4), ([1, 3], 3, 4, 2),
    ([2, 1], 5, 3, 3),
])
def test_sequence_reshape_matches_jax(lens, T, m, nd):
    j, t = _pair(7, lens, T, tail=(m,))
    _close(tops.sequence_reshape(t, nd), jops.sequence_reshape(j, nd), 0)


def test_sequence_reshape_refuses_indivisible_cpu_lengths():
    j, t = _pair(7, [3, 2], 4, tail=(2,))
    with pytest.raises(JEnforceNotMet, match="not divisible"):
        jops.sequence_reshape(j, 4)
    with pytest.raises(EnforceNotMet, match="not divisible"):
        tops.sequence_reshape(t, 4)


@pytest.mark.parametrize("lens,T,cl,cs", [
    LENS[0] + (3, None), LENS[0] + (4, None), LENS[0] + (3, -2),
    LENS[1] + (1, 1), LENS[1] + (4, None)])
def test_sequence_conv_matches_jax_with_gradients(lens, T, cl, cs):
    H, F = 3, 4
    j, t = _pair(8, lens, T, tail=(H,))
    w = _np(9, cl * H, F, scale=0.5)
    jw, tw = jnp.asarray(w), torch.tensor(w, requires_grad=True)
    tx = t[0].clone().requires_grad_()

    def jloss(x, w):
        out = jops.sequence_conv((x, j[1]), w, cl, cs)
        return jnp.sum(out.data * jnp.cos(out.data)), out

    (jl, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                        has_aux=True)(j[0], jw)
    tout = tops.sequence_conv((tx, t[1]), tw, cl, cs)
    tl = torch.sum(tout.data * torch.cos(tout.data))
    tgx, tgw = torch.autograd.grad(tl, [tx, tw])
    _close(tout, jout, 1e-5)
    _close(tgx, jg[0], 1e-5)
    _close(tgw, jg[1], 1e-5)
    # a dense input: no mask
    _close(tops.sequence_conv(t[0], torch.tensor(w), cl, cs),
           jops.sequence_conv(j[0], jw, cl, cs), 1e-5)


def _conv_pool_model(pkg_layers, pkg_nets, rb_cls, attr_cls, pool):
    def model(emb, lengths):
        a = pkg_nets.sequence_conv_pool(
            rb_cls(emb, lengths), 4, 3, act="tanh", pool_type=pool,
            param_attr=attr_cls(name="c3_w"), bias_attr=attr_cls(name="c3_b"))
        b = pkg_nets.sequence_conv_pool(
            rb_cls(emb, lengths), 4, 4, act="sigmoid", pool_type=pool,
            param_attr=attr_cls(name="c4_w"), bias_attr=attr_cls(name="c4_b"))
        return pkg_layers.fc([a, b], 2, param_attr=[attr_cls(name="o3"),
                                                    attr_cls(name="o4")],
                             bias_attr=attr_cls(name="ob"))
    return model


@pytest.mark.parametrize("pool", ["sqrt", "max"])
def test_sequence_conv_pool_matches_jax_with_gradients(pool):
    """The sentiment model's pair of sequence_conv_pool (filters 3 and 4)
    in the module context, from the JAX init's weights."""
    emb = _np(20, 3, 6, 5)
    lens = np.array([6, 1, 4], np.int32)
    jm = jnn.transform(_conv_pool_model(jlayers, jnets, JRB, jpt.ParamAttr,
                                        pool))
    tm = tnn.transform(_conv_pool_model(tlayers, tnets, TRB, tpt.ParamAttr,
                                        pool))
    jp, _ = jm.init(jax.random.PRNGKey(0), jnp.asarray(emb),
                    jnp.asarray(lens))
    tp = tnn.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert sorted(tp) == sorted(jp) == ["c3_b", "c3_w", "c4_b", "c4_w", "o3",
                                        "o4", "ob"]

    def jloss(p, e):
        out, _ = jm.apply(p, {}, None, e, jnp.asarray(lens))
        return jnp.sum(jnp.sin(out))

    jl, (jg, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(emb))
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    te = torch.tensor(emb, requires_grad=True)
    out, _ = tm.apply(leaves, {}, None, te, torch.tensor(lens))
    tl = torch.sum(torch.sin(out))
    grads = torch.autograd.grad(tl, list(leaves.values()) + [te])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-5)
    for k, g in zip(leaves, grads):
        _close(g, jg[k], 1e-5)
    _close(grads[-1], jge, 1e-5)


# ---------------------------------------------------------------------------
# the module context
# ---------------------------------------------------------------------------
def _two_fc(pkg_layers, attr_cls, named):
    """Two fcs of widths 4 and 3 over one input."""
    def model(x):
        if named:
            return (pkg_layers.fc(x, 4, param_attr=attr_cls(name="fc1_w"),
                                  bias_attr=attr_cls(name="fc1_b")),
                    pkg_layers.fc(x, 3, param_attr=attr_cls(name="fc2_w"),
                                  bias_attr=attr_cls(name="fc2_b")))
        return pkg_layers.fc(x, 4), pkg_layers.fc(x, 3)
    return model


def test_bare_names_reuse_in_jax_and_refuse_in_the_port():
    """ROADMAP queue 3 note h: the second bare ``fc`` after a wider one
    gets the first one's ``fc_w`` [5, 4] in the JAX package and returns
    width 4; the port refuses, naming the parameter. With ParamAttr names
    both agree."""
    x = _np(30, 2, 5)
    jm = jnn.transform(_two_fc(jlayers, jpt.ParamAttr, named=False))
    jp, _ = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    (a, b), _ = jm.apply(jp, {}, None, jnp.asarray(x))
    assert sorted(jp) == ["fc_b", "fc_w"] and a.shape == b.shape == (2, 4)
    tm = tnn.transform(_two_fc(tlayers, tpt.ParamAttr, named=False))
    with pytest.raises(EnforceNotMet, match="'fc_w' exists with shape "
                                            r"\[5, 4\].*\[5, 3\]"):
        tm.init(torch.Generator().manual_seed(0), torch.tensor(x))
    jm = jnn.transform(_two_fc(jlayers, jpt.ParamAttr, named=True))
    tm = tnn.transform(_two_fc(tlayers, tpt.ParamAttr, named=True))
    jp, _ = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tp = tnn.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tinit, _ = tm.init(torch.Generator().manual_seed(0), torch.tensor(x))
    assert sorted(tinit) == sorted(jp) == ["fc1_b", "fc1_w", "fc2_b",
                                           "fc2_w"]
    assert all(tinit[k].shape == tp[k].shape for k in tp)
    jout, _ = jm.apply(jp, {}, None, jnp.asarray(x))
    tout, _ = tm.apply(tp, {}, None, torch.tensor(x))
    _close(tout, jout, 1e-6)


class _Block:
    """A Layer subclass with a sublayer and state, built for either
    package."""

    @staticmethod
    def make(nn, layers, attr_cls):
        class Dense(nn.Layer):
            def __init__(self, width):
                super().__init__()
                self.width = width

            def forward(self, x):
                w = nn.create_parameter("w", (x.shape[-1], self.width))
                n = nn.create_state("calls", (1,), init_value=0.0)
                nn.set_state("calls", n + 1.0)
                return layers.tanh(layers.matmul(x, w))

        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.a = Dense(4)
                self.b = Dense(4)
                self.seq = nn.Sequential(Dense(3), Dense(2))

            def forward(self, x):
                return self.seq(self.b(self.a(x)))

        return Net()


def test_layer_scopes_sequential_and_state_match_jax():
    x = _np(31, 2, 5)
    jnet = _Block.make(jnn, jlayers, jpt.ParamAttr)
    tnet = _Block.make(tnn, tlayers, tpt.ParamAttr)
    jp, js = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tinit, tinit_s = tnet.init(torch.Generator().manual_seed(0),
                               torch.tensor(x))
    assert sorted(tinit) == sorted(jp) == [
        "net/dense/w", "net/dense_1/w", "net/sequential/dense/w",
        "net/sequential/dense_1/w"]
    assert sorted(tinit_s) == sorted(js)
    assert all(v.device == torch.device("cpu") for v in tinit.values())
    tp = tnn.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ts = tnn.params_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    jout, js2 = jnet.apply(jp, js, None, jnp.asarray(x))
    tout, ts2 = tnet.apply(tp, ts, None, torch.tensor(x))
    _close(tout, jout, 1e-6)
    for k in js2:
        _close(ts2[k], js2[k], 0)
    # init ran the forward once too
    assert float(ts2["net/dense/calls"][0]) == 2.0
    # a params dict that does not match the structure
    with pytest.raises(EnforceNotMet, match="missing at apply time"):
        tnet.apply({}, ts, None, torch.tensor(x))
    with pytest.raises(EnforceNotMet, match="State .* missing"):
        tnet.apply(tp, {}, None, torch.tensor(x))
    bad = dict(tp, **{"net/dense/w": torch.zeros(5, 7)})
    with pytest.raises(EnforceNotMet, match="exists with shape"):
        tnet.apply(bad, ts, None, torch.tensor(x))
    with pytest.raises(EnforceNotMet, match="outside a module context"):
        tnet(torch.tensor(x))
    ll = tnn.LayerList([tnet])
    assert len(ll) == 1 and ll[0] is tnet and list(ll) == [tnet]
    with pytest.raises(EnforceNotMet, match="container"):
        ll.forward()


def test_module_context_draws_from_the_generator_on_its_device():
    def model():
        tnn.create_parameter("w", (4, 3))
        tlayers.create_parameter([3], is_bias=True, name="b")
        tlayers.create_parameter([2, 2], attr=tpt.ParamAttr(
            name="c", initializer=tpt.initializer.Constant(0.5)))

    tm = tnn.transform(model)
    a, _ = tm.init(torch.Generator().manual_seed(7))
    b, _ = tm.init(torch.Generator().manual_seed(7))
    c, _ = tm.init(torch.Generator().manual_seed(8))
    assert sorted(a) == ["b", "c", "w"]
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])
    assert torch.equal(a["b"], torch.zeros(3))
    assert torch.equal(a["c"], torch.full((2, 2), 0.5))
    with pytest.raises(EnforceNotMet, match="module context"):
        tnn.create_parameter("w", (2,))
    with pytest.raises(EnforceNotMet, match="module context"):
        tlayers.create_parameter([2])


def test_layers_embedding_and_fc_run_eagerly_in_a_frame():
    ids = np.array([[1, 0, 3], [2, 2, 0]])
    x = _np(32, 2, 3, 4)

    def mk(layers, attr):
        def model(ids, x):
            e = layers.embedding(ids, [5, 4], padding_idx=0,
                                 param_attr=attr(name="emb"))
            return layers.fc(e + x, 2, num_flatten_dims=2, act="relu",
                             param_attr=attr(name="w"),
                             bias_attr=attr(name="b"))
        return model

    jm, tm = jnn.transform(mk(jlayers, jpt.ParamAttr)), \
        tnn.transform(mk(tlayers, tpt.ParamAttr))
    jp, _ = jm.init(jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(x))
    tp = tnn.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jout, _ = jm.apply(jp, {}, None, jnp.asarray(ids), jnp.asarray(x))
    tout, _ = tm.apply(tp, {}, None, torch.tensor(ids), torch.tensor(x))
    _close(tout, jout, 1e-6)


def test_sums_matches_jax():
    xs = [_np(40 + i, 3, 4) for i in range(4)]
    _close(tops.sums([torch.tensor(x) for x in xs]),
           jops.sums([jnp.asarray(x) for x in xs]), 1e-6)
    _close(tlayers.sums([torch.tensor(x) for x in xs[:1]]),
           jlayers.sums([jnp.asarray(x) for x in xs[:1]]), 0)


def test_entry_points_ask_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tpt.NoCudaDeviceError):
        TRB.from_list(SEQS)
    with pytest.raises(tpt.NoCudaDeviceError):
        tpt.create_lod_tensor(np.zeros((3, 1)), [[1, 2]])
    with pytest.raises(tpt.NoCudaDeviceError):
        tnn.params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(tpt.NoCudaDeviceError):
        tnn.transform(lambda: tnn.create_parameter("w", (2,))).init(None)
