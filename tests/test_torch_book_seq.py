"""The Fluid book's sequence models in the port against the JAX package, on
the CPU, at small widths: understand_sentiment's ``convolution_net`` and
the full recommender_system (the module context), label_semantic_roles'
``db_lstm`` with its CRF (the static path) and machine_translation's GRU
encoder-decoder (functional).

Each is built in both packages from the same parameter names; the port
starts from the JAX weights (``nn.params_from_numpy``, or the JAX
startup's scope through ``Scope.from_numpy``) and both train 5 steps on
the same numpy batches: the first step's gradients, the losses and the
parameters after within 1e-5 (fp32 sums in another order over a few
recurrent steps; the observed gaps are in CHANGES.md). The SRL program's
documents equal the JAX ones and its Viterbi paths are equal. Then
``tests/test_book.py``'s convergence criterion (the last loss below 0.8 of
the first, Adam at its rates and step counts) on the port alone.
"""

import types

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
from paddle_tpu.core.lod import RaggedBatch as JRB
from paddle_tpu.static.program import static_mode_guard
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.ops import rnn as jrnn
from paddle_tpu.static import serialize as jser

import paddle_tpu_torch as tpt
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import nets as tnets
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.core.lod import RaggedBatch as TRB
from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.static import serialize as tser

TOL = 1e-5

JAX = types.SimpleNamespace(
    pt=jpt, layers=jlayers, nets=jnets, nn=jnn, ops=jops, rnn=jrnn, RB=JRB,
    unique_name=junique, sum=jnp.sum, asarray=jnp.asarray)
PORT = types.SimpleNamespace(
    pt=tpt, layers=tlayers, nets=tnets, nn=tnn, ops=tops, rnn=trnn, RB=TRB,
    unique_name=tpt.unique_name, sum=torch.sum,
    asarray=lambda a: torch.tensor(np.asarray(a)))


@pytest.fixture(autouse=True)
def _eager_mode():
    """The module context runs outside static mode; some JAX-package test
    files leave that package's static mode on for later files on their
    worker (ROADMAP queue 3 note d), so each test here runs with it off and
    puts it back after."""
    with static_mode_guard(False):
        yield


def _lengths(rng, b, lo, hi):
    """Lengths uniform over [lo, hi] with one row at hi, so every batch
    pads to hi (the JAX programs then compile once)."""
    ln = rng.randint(lo, hi + 1, b)
    ln[rng.randint(b)] = hi
    return ln.astype(np.int32)


def _ids(rng, ln, hi, T):
    x = rng.randint(0, hi, (len(ln), T))
    x[np.arange(T)[None, :] >= ln[:, None]] = 0
    return x.astype(np.int64)


# ---------------------------------------------------------------------------
# understand_sentiment: convolution_net (module context)
# ---------------------------------------------------------------------------
SENT = dict(vocab=50, emb=8, hid=6, T=12)


def sentiment(pk, cfg):
    """Fluid 1.5 test_understand_sentiment.py convolution_net: embedding,
    sequence_conv_pool filter 3 and 4 (tanh, sqrt pool), fc softmax over
    both, cross entropy, mean. Every parameter named."""
    A = pk.pt.ParamAttr

    def model(words, lengths, label):
        emb = pk.layers.embedding(words, [cfg["vocab"], cfg["emb"]],
                                  param_attr=A(name="emb"))
        convs = [pk.nets.sequence_conv_pool(
            pk.RB(emb, lengths), cfg["hid"], k, act="tanh",
            pool_type="sqrt", param_attr=A(name=f"conv{k}_w"),
            bias_attr=A(name=f"conv{k}_b")) for k in (3, 4)]
        pred = pk.layers.fc(convs, 2, act="softmax",
                            param_attr=[A(name="fc3_w"), A(name="fc4_w")],
                            bias_attr=A(name="fc_b"))
        return pk.layers.mean(pk.layers.cross_entropy(pred, label))
    return pk.nn.transform(model)


def sentiment_batches(n, seed, cfg=SENT, b=6):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ln = _lengths(rng, b, 3, cfg["T"])
        words = _ids(rng, ln, cfg["vocab"], cfg["T"])
        words[::2, 1] = 1        # the signal: token 1 near the front
        label = (words[:, :3] == 1).any(axis=1).astype(np.int64)[:, None]
        out.append((words, ln, label))
    return out


# ---------------------------------------------------------------------------
# recommender_system: the full MovieLens model (module context)
# ---------------------------------------------------------------------------
ML = dict(users=20, jobs=5, movies=25, cats=6, titles=30, emb=8, small=4,
          fc=10, cat_T=3, title_T=5)


def movielens(pk, cfg):
    """Fluid 1.5 test_recommender_system.py: the user tower (id, gender,
    age and job embeddings, an fc each, concat, fc tanh) and the movie
    tower (id embedding and fc, categories summed, title through
    sequence_conv_pool(3, tanh, sum), concat, fc tanh); cos_sim scaled by
    5, square error, mean."""
    A = pk.pt.ParamAttr
    L = pk.layers
    e, s = cfg["emb"], cfg["small"]

    def emb_fc(ids, rows, width, name, fc_width):
        x = L.embedding(ids, [rows, width], param_attr=A(name=f"{name}_table"))
        return L.fc(x, fc_width, param_attr=A(name=f"{name}_fc_w"),
                    bias_attr=A(name=f"{name}_fc_b"))

    def model(uid, gender, age, job, mid, cat, cat_len, title, title_len,
              score):
        usr = L.concat([emb_fc(uid, cfg["users"], e, "user", e),
                        emb_fc(gender, 2, s, "gender", s),
                        emb_fc(age, 7, s, "age", s),
                        emb_fc(job, cfg["jobs"], s, "job", s)], axis=1)
        usr = L.fc(usr, cfg["fc"], act="tanh", param_attr=A(name="usr_w"),
                   bias_attr=A(name="usr_b"))
        cat_emb = L.embedding(cat, [cfg["cats"], e],
                              param_attr=A(name="category_table"))
        cat_vec = L.sequence_pool(pk.RB(cat_emb, cat_len), "sum")
        title_emb = L.embedding(title, [cfg["titles"], e],
                                param_attr=A(name="title_table"))
        title_vec = pk.nets.sequence_conv_pool(
            pk.RB(title_emb, title_len), e, 3, act="tanh", pool_type="sum",
            param_attr=A(name="title_conv_w"),
            bias_attr=A(name="title_conv_b"))
        mov = L.concat([emb_fc(mid, cfg["movies"], e, "movie", e), cat_vec,
                        title_vec], axis=1)
        mov = L.fc(mov, cfg["fc"], act="tanh", param_attr=A(name="mov_w"),
                   bias_attr=A(name="mov_b"))
        pred = L.scale(L.cos_sim(usr, mov), scale=5.0)
        return L.mean(L.square_error_cost(pred, score))
    return pk.nn.transform(model)


def movielens_batches(n, seed, cfg=ML, b=8):
    rng = np.random.RandomState(seed)
    pu = rng.rand(cfg["users"], 3)
    pm = rng.rand(cfg["movies"], 3)
    out = []
    for _ in range(n):
        uid = rng.randint(0, cfg["users"], (b, 1))
        mid = rng.randint(0, cfg["movies"], (b, 1))
        cat_len = _lengths(rng, b, 1, cfg["cat_T"])
        title_len = _lengths(rng, b, 1, cfg["title_T"])
        score = (pu[uid[:, 0]] * pm[mid[:, 0]]).sum(1, keepdims=True) * 1.6
        out.append((uid.astype(np.int64),
                    rng.randint(0, 2, (b, 1)).astype(np.int64),
                    rng.randint(0, 7, (b, 1)).astype(np.int64),
                    rng.randint(0, cfg["jobs"], (b, 1)).astype(np.int64),
                    mid.astype(np.int64),
                    _ids(rng, cat_len, cfg["cats"], cfg["cat_T"]), cat_len,
                    _ids(rng, title_len, cfg["titles"], cfg["title_T"]),
                    title_len, score.astype(np.float32)))
    return out


def _train_module(pk, tmod, params, opt, batches):
    """(losses, first-step grads, params) of ``len(batches)`` steps."""
    if pk is JAX:
        state = opt.init(params)

        @jax.jit
        def step(p, s, *batch):
            loss, g = jax.value_and_grad(
                lambda q: tmod.apply(q, {}, None, *batch)[0])(p)
            p, s = opt.apply_gradients(p, g, s)
            return loss, g, p, s

        losses, first = [], None
        for batch in batches:
            loss, g, params, state = step(params, state,
                                          *map(jnp.asarray, batch))
            losses.append(float(loss))
            first = first or jax.tree.map(np.asarray, g)
        return losses, first, jax.tree.map(np.asarray, params)
    params = {k: v.requires_grad_() for k, v in params.items()}
    state = opt.init(params)
    losses, first = [], None
    for batch in batches:
        loss = tmod.apply(params, {}, None,
                          *map(lambda a: torch.tensor(a), batch))[0]
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.apply_gradients(params, dict(zip(params, grads)), state)
        losses.append(float(loss.detach()))
        first = first or {k: g.numpy() for k, g in zip(params, grads)}
    return losses, first, {k: v.detach().numpy() for k, v in params.items()}


def _assert_runs_equal(t, j):
    (tl, tg, tp), (jl, jg, jp) = t, j
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert sorted(tg) == sorted(jg) and sorted(tp) == sorted(jp)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
        np.testing.assert_allclose(tp[k], jp[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


MODULE_MODELS = {
    "understand_sentiment": (sentiment, SENT, sentiment_batches,
                             lambda pt: pt.optimizer.Adagrad(0.002),
                             lambda pt: pt.optimizer.Adam(1e-2), 30),
    "recommender_system": (movielens, ML, movielens_batches,
                           lambda pt: pt.optimizer.SGD(0.2),
                           lambda pt: pt.optimizer.Adam(5e-2), 40),
}


@pytest.mark.parametrize("name", list(MODULE_MODELS))
def test_module_book_model_trains_like_jax(name):
    build, cfg, batches_of, opt, _, _ = MODULE_MODELS[name]
    batches = batches_of(5, 0)
    jm, tm = build(JAX, cfg), build(PORT, cfg)
    jp, _ = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, batches[0]))
    tinit, _ = tm.init(torch.Generator().manual_seed(0),
                       *map(torch.tensor, batches[0]))
    assert sorted(tinit) == sorted(jp)
    assert all(tuple(tinit[k].shape) == jp[k].shape for k in jp)
    tp = tnn.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    _assert_runs_equal(_train_module(PORT, tm, tp, opt(tpt), batches),
                       _train_module(JAX, jm, jp, opt(jpt), batches))


@pytest.mark.parametrize("name", list(MODULE_MODELS))
def test_module_book_model_converges_on_the_port(name):
    build, cfg, batches_of, _, opt, steps = MODULE_MODELS[name]
    tm = build(PORT, cfg)
    data = batches_of(1, 1, b=16)[0]
    params, _ = tm.init(torch.Generator().manual_seed(0),
                        *map(torch.tensor, data))
    losses, _, _ = _train_module(PORT, tm, params, opt(tpt), [data] * steps)
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] * 0.8, losses


# ---------------------------------------------------------------------------
# label_semantic_roles: db_lstm with a CRF (static path)
# ---------------------------------------------------------------------------
SRL = dict(words=40, preds=12, labels=5, word_dim=4, mark_dim=2, hidden=16,
           depth=2, T=7)
SRL_SLOTS = ["word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
             "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data"]


def _book_sgd(pt):
    return pt.optimizer.SGD(pt.layers.exponential_decay(
        0.01, 100000, 0.5, staircase=True))


def db_lstm(pk, cfg, make_opt=_book_sgd):
    """Fluid 1.5 test_label_semantic_roles.py db_lstm: the word and five
    context slots share one frozen table ``emb``, the predicate ``vemb``,
    the mark its own; an fc tanh on each, summed; then ``depth``
    dynamic_lstm layers at hidden/4 with a [7H] peephole bias, every second
    one reversed, joined by sums of two fcs; a linear_chain_crf
    (``crfw``, learning rate 1e-3) under SGD at exponential_decay(0.01,
    100000, 0.5, staircase) (``make_opt``); crf_decoding over the same
    ``crfw``. Returns (main, startup, loss, decode, the for_test clone)."""
    pt = pk.pt
    main, startup = pt.Program(), pt.Program()
    L = pt.layers
    A = pt.ParamAttr
    H = cfg["hidden"] // 4
    with pt.program_guard(main, startup), pk.unique_name.guard():
        slots = {n: pt.data(n, [-1, -1], "int64", lod_level=1)
                 for n in SRL_SLOTS}
        target = pt.data("target", [-1, -1], "int64", lod_level=1)
        length = pt.data("length", [], "int32")
        embs = [L.embedding(slots[n], [cfg["words"], cfg["word_dim"]],
                            param_attr=A(name="emb", trainable=False))
                for n in SRL_SLOTS[:6]]
        embs.append(L.embedding(slots["verb_data"],
                                [cfg["preds"], cfg["word_dim"]],
                                param_attr="vemb"))
        embs.append(L.embedding(slots["mark_data"], [2, cfg["mark_dim"]]))
        hidden_0 = L.sums([L.fc(e, cfg["hidden"], num_flatten_dims=2,
                                act="tanh") for e in embs])

        def lstm(x, i):
            w = L.create_parameter([H, 4 * H], name=f"lstm{i}_w")
            b = L.create_parameter([7 * H], name=f"lstm{i}_b", is_bias=True)
            return L.dynamic_lstm(x, w, b, lengths=length,
                                  is_reverse=(i % 2) == 1)

        tmp = [hidden_0, lstm(hidden_0, 0)]
        for i in range(1, cfg["depth"]):
            mix = L.sums([L.fc(t, cfg["hidden"], num_flatten_dims=2,
                               act="tanh") for t in tmp])
            tmp = [mix, lstm(mix, i)]
        feature = L.sums([L.fc(t, cfg["labels"], num_flatten_dims=2,
                               act="tanh") for t in tmp])
        cost = L.linear_chain_crf(feature, target, length=length,
                                  param_attr=A(name="crfw",
                                               learning_rate=1e-3))
        crfw = main.global_block().var("crfw")
        decode = L.crf_decoding(feature, crfw, length=length)
        loss = L.mean(cost)
        test = main.clone(for_test=True)
        make_opt(pt).minimize(loss)
    return main, startup, loss, decode, test


def srl_feed(rng, cfg=SRL, b=5):
    ln = _lengths(rng, b, 2, cfg["T"])
    feed = {n: _ids(rng, ln, cfg["words"], cfg["T"]) for n in SRL_SLOTS[:6]}
    feed["verb_data"] = _ids(rng, ln, cfg["preds"], cfg["T"])
    feed["mark_data"] = _ids(rng, ln, 2, cfg["T"])
    feed["target"] = (feed["word_data"] + feed["mark_data"]) % cfg["labels"]
    feed["length"] = ln
    return feed


def test_srl_program_matches_jax_and_trains_like_it():
    # a schedule is a closure, which neither package's document holds: the
    # documents are compared with the rate a constant (what the schedule
    # gives before step 100000), and the runs use the schedule
    def const(pt):
        return pt.optimizer.SGD(0.01)

    docs = [db_lstm(pk, SRL, const) for pk in (PORT, JAX)]
    for t, j in zip(docs[0][:2] + docs[0][4:], docs[1][:2] + docs[1][4:]):
        assert tser.program_to_dict(t) == jser.program_to_dict(j)
    jmain, jstart, jloss, jdec, jtest = db_lstm(JAX, SRL)
    tmain, tstart, tloss, tdec, ttest = db_lstm(PORT, SRL)
    assert tser.program_to_dict(ttest) == jser.program_to_dict(jtest)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    types_ = [op.type for op in tmain.global_block().ops]
    assert types_.count("dynamic_lstm") == SRL["depth"]
    assert types_.count("embedding") == 8
    assert not tmain.global_block().var("emb").trainable
    jscope, jexe = jpt.static.Scope(), jpt.Executor()
    jexe.run(jstart, scope=jscope)
    names = sorted(n for n, v in jstart.global_block().vars.items()
                   if v.persistable)
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in names}, "cpu", tstart)
    texe = tpt.Executor(tpt.CPUPlace())
    rng = np.random.RandomState(0)
    feeds = [srl_feed(rng) for _ in range(5)]
    grads = [p.name + "@GRAD" for p in tmain.all_parameters()
             if p.trainable]
    assert "emb@GRAD" not in grads and "crfw@GRAD" in grads
    jg = jexe.run(jmain, feed=feeds[0], fetch_list=grads, scope=jscope)
    tg = texe.run(tmain, feed=feeds[0], fetch_list=grads, scope=tscope)
    for n, a, b in zip(grads, tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL,
                                   err_msg=n)
    jl = [float(jexe.run(jmain, feed=f, fetch_list=[jloss],
                         scope=jscope)[0]) for f in feeds[1:]]
    tl = [float(texe.run(tmain, feed=f, fetch_list=[tloss],
                         scope=tscope)[0]) for f in feeds[1:]]
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.array(jscope.find_var(n)), rtol=TOL,
                                   atol=TOL, err_msg=n)
    np.testing.assert_array_equal(tscope.find_var("emb").numpy(),
                                  np.array(jscope.find_var("emb")))
    for f in feeds[:2]:
        jd = jexe.run(jtest, feed=f, fetch_list=[jdec], scope=jscope)[0]
        td = texe.run(ttest, feed=f, fetch_list=[tdec], scope=tscope)[0]
        np.testing.assert_array_equal(td, np.asarray(jd))
        assert (td[np.arange(SRL["T"])[None, :]
                   >= f["length"][:, None]] == 0).all()


def test_srl_converges_on_the_port():
    """test_book.py's SRL criterion (Adam 5e-2, 40 steps, the last loss
    below 0.8 of the first) on db_lstm, the port alone."""
    main, startup, loss, _, _ = db_lstm(
        PORT, SRL, lambda pt: pt.optimizer.Adam(5e-2))
    scope, exe = tpt.Scope(), tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = srl_feed(np.random.RandomState(1), b=8)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(40)]
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] * 0.8, losses


# ---------------------------------------------------------------------------
# machine_translation: the GRU encoder-decoder (functional)
# ---------------------------------------------------------------------------
NMT = dict(src=30, tgt=30, emb=6, hid=8, T=7)


def nmt_params(cfg, seed):
    rng = np.random.RandomState(seed)
    E, H = cfg["emb"], cfg["hid"]

    def r(*s):
        return (rng.randn(*s) * 0.1).astype(np.float32)
    return {"src_emb": r(cfg["src"], E), "tgt_emb": r(cfg["tgt"], E),
            "enc_wih": r(E, 3 * H), "enc_whh": r(H, 3 * H),
            "enc_b": np.zeros(3 * H, np.float32),
            "dec_wih": r(E, 3 * H), "dec_whh": r(H, 3 * H),
            "dec_b": np.zeros(3 * H, np.float32),
            "out_w": r(H, cfg["tgt"]), "out_b": np.zeros(cfg["tgt"],
                                                         np.float32)}


def nmt_loss(pk, p, src, src_len, tgt_in, tgt_out, tgt_len):
    """tests/test_book.py's encoder-decoder with lengths: the source GRU's
    last state starts the target GRU; the token cross entropy averaged
    over the valid target steps."""
    es = pk.ops.embedding(src, p["src_emb"])
    _, h = pk.rnn.gru(es, p["enc_wih"], p["enc_whh"], p["enc_b"],
                      lengths=src_len)
    et = pk.ops.embedding(tgt_in, p["tgt_emb"])
    outs, _ = pk.rnn.gru(et, p["dec_wih"], p["dec_whh"], p["dec_b"], h0=h,
                         lengths=tgt_len)
    logits = outs @ p["out_w"] + p["out_b"]
    xent = pk.ops.softmax_with_cross_entropy(logits, tgt_out[..., None])
    mask = pk.ops.sequence_mask(tgt_len, tgt_out.shape[1])
    return pk.sum(xent[..., 0] * mask) / pk.sum(mask)


def nmt_batches(n, seed, cfg=NMT, b=6):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        sl = _lengths(rng, b, 2, cfg["T"])
        src = _ids(rng, sl, cfg["src"], cfg["T"])
        tgt = np.roll(src, 1, axis=1)          # the copy-shift task
        tgt_in = np.concatenate([np.zeros((b, 1), np.int64), tgt[:, :-1]], 1)
        out.append((src, sl, tgt_in, tgt, sl.copy()))
    return out


def _train_nmt(pk, params, opt, batches):
    if pk is JAX:
        state = opt.init(params)

        @jax.jit
        def step(p, s, *batch):
            loss, g = jax.value_and_grad(
                lambda q: nmt_loss(JAX, q, *batch))(p)
            p, s = opt.apply_gradients(p, g, s)
            return loss, g, p, s

        losses, first = [], None
        for batch in batches:
            loss, g, params, state = step(params, state,
                                          *map(jnp.asarray, batch))
            losses.append(float(loss))
            first = first or jax.tree.map(np.asarray, g)
        return losses, first, jax.tree.map(np.asarray, params)
    params = {k: v.requires_grad_() for k, v in params.items()}
    state = opt.init(params)
    losses, first = [], None
    for batch in batches:
        loss = nmt_loss(PORT, params, *map(torch.tensor, batch))
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.apply_gradients(params, dict(zip(params, grads)), state)
        losses.append(float(loss.detach()))
        first = first or {k: g.numpy() for k, g in zip(params, grads)}
    return losses, first, {k: v.detach().numpy() for k, v in params.items()}


def test_nmt_trains_like_jax():
    p = nmt_params(NMT, 3)
    batches = nmt_batches(5, 0)
    _assert_runs_equal(
        _train_nmt(PORT, tnn.params_from_numpy(p, device="cpu"),
                   tpt.optimizer.Adam(1e-2), batches),
        _train_nmt(JAX, jax.tree.map(jnp.asarray, p),
                   jpt.optimizer.Adam(1e-2), batches))


def test_nmt_converges_on_the_port():
    """test_book.py's criterion: Adam 1e-2, 40 steps on one batch."""
    batch = nmt_batches(1, 1, b=8)[0]
    losses, _, _ = _train_nmt(
        PORT, tnn.params_from_numpy(nmt_params(NMT, 3), device="cpu"),
        tpt.optimizer.Adam(1e-2), [batch] * 40)
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] * 0.8, losses
