"""The Transformer NMT model of the port (paddle_tpu_torch.models.transformer)
against the JAX package's, on the CPU.

The JAX package runs as its own tests run it (``JAX_PLATFORMS=cpu``); its
``make_train_step`` runs on a one-device mesh with the stock body of its Adam
(the only Pallas kernel the model reaches; the port's Adam is held to the
interpret-mode kernel in tests/test_torch_train.py, and the stock body takes
half the compile time). Its initial parameters cross over through
``params_from_numpy`` and the same numpy batch, with a padded source row and
a padded target row, goes through both.

Tolerances (transformer_tiny in fp32; observed in brackets). The two differ
by summation order only: forward logits 1e-5 of the largest [3e-7];
``nmt_loss`` 1e-6 relative [1.1e-7]; three Adam steps at bench.py nmt's
rate 1e-4: losses 1e-5 [4.8e-7] and parameters 1e-5 absolute [1.4e-6];
greedy and beam tokens equal, beam scores 1e-5 absolute [3.8e-6 at ~27, so
1.4e-7 relative]. bf16: activations round at other places in the two
frameworks: losses 0.03 over three steps [1.4e-4], the bound the card is
held to against the CPU for BERT. ``remat=True`` recomputes the same ops: equal to ``remat=False``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.models import transformer as jtr
from paddle_tpu.parallel.mesh import MeshConfig, make_mesh, mesh_guard

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.tree import leaves
from paddle_tpu_torch.models import transformer as ttr

LR = 1e-4           # bench.py nmt's Adam rate
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="float32", **kw):
    jd, td = _DT[dtype]
    return (jtr.transformer_tiny(dtype=jd, **kw),
            ttr.transformer_tiny(dtype=td, **kw))


def _start(jcfg, tcfg, seed=0):
    jp = jtr.init_params(jax.random.PRNGKey(seed), jcfg)
    p0 = jax.tree.map(lambda a: np.array(a), jp)
    return jp, p0, ttr.params_from_numpy(p0, tcfg, device="cpu")


def _batch(cfg, seed=1):
    """Source 12, target 10 (max_seq 16), a padded source and target row."""
    b = jtr.synthetic_batch(cfg, 3, 12, 10, seed=seed)
    b["src_mask"][1, 8:] = 0
    b["tgt_mask"][2, 7:] = 0
    return b


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# surface
# ---------------------------------------------------------------------------
def test_surface_is_the_jax_modules():
    assert set(jtr.__all__) <= set(ttr.__all__)
    assert set(ttr.__all__) - set(jtr.__all__) == {"params_from_numpy"}
    for name in ("forward", "nmt_loss", "encode", "decode_train",
                 "greedy_decode", "beam_search_decode", "flops_per_step",
                 "synthetic_batch", "transformer_big", "_init_cache",
                 "_cross_kv", "_decode_step"):
        want = inspect.signature(getattr(jtr, name)).parameters
        got = inspect.signature(getattr(ttr, name)).parameters
        got = [p for p in got.values() if p.name != "device"]
        assert [(p.name, p.default) for p in got] == \
            [(p.name, p.default) for p in want.values()], name
    # the port's own argument order (a torch.Generator, not a PRNG key),
    # and the mesh at its reference position
    assert list(inspect.signature(ttr.init_params).parameters) == \
        ["cfg", "generator", "device"]
    assert list(inspect.signature(ttr.make_train_step).parameters) == \
        ["cfg", "optimizer", "mesh", "device"]
    cfg = ttr.transformer_big()
    assert (cfg.hidden, cfg.num_heads, cfg.ffn, cfg.dtype) == \
        (1024, 16, 4096, torch.bfloat16)


def test_parameter_tree_and_counts_equal_jax():
    jcfg = jtr.transformer_big(max_seq=256)
    tcfg = ttr.transformer_big(max_seq=256)
    want = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    want = {jax.tree_util.keystr(k).replace("['", ".").replace("']", "")
            .replace("[", ".").replace("]", "").lstrip("."): tuple(a.shape)
            for k, a in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {}
    ttr._walk(ttr._layout(tcfg),
              lambda path, shape, _: got.__setitem__(path, shape))
    assert got == want and len(got) == 258
    for b, s, t in ((32, 256, 256), (4, 100, 37)):
        assert ttr.flops_per_step(tcfg, b, s, t) == \
            jtr.flops_per_step(jcfg, b, s, t)
    for k, v in jtr.synthetic_batch(jcfg, 2, 9, 7, seed=3).items():
        np.testing.assert_array_equal(
            ttr.synthetic_batch(tcfg, 2, 9, 7, seed=3)[k], v)


def test_params_from_numpy_is_strict():
    jcfg, tcfg = _cfgs()
    _, p0, tp = _start(jcfg, tcfg)
    assert torch.equal(tp["dec"][1]["cross_attn"]["o_w"],
                       torch.from_numpy(p0["dec"][1]["cross_attn"]["o_w"]))
    bad = jax.tree.map(lambda a: a, p0)
    bad["enc"][0]["ffn"]["w1"] = bad["enc"][0]["ffn"]["w1"].astype(np.float64)
    with pytest.raises(EnforceNotMet, match=r"enc\.0\.ffn\.w1"):
        ttr.params_from_numpy(bad, tcfg, device="cpu")
    bad = jax.tree.map(lambda a: a, p0)
    bad["dec"] = bad["dec"][:1]
    with pytest.raises(EnforceNotMet, match="dec must be a list of 2"):
        ttr.params_from_numpy(bad, tcfg, device="cpu")


def test_mesh_must_be_none():
    _, tcfg = _cfgs()
    opt = topt.Adam(learning_rate=LR)
    init_fn, _ = ttr.make_train_step(tcfg, opt, None, device="cpu")
    params, state = init_fn(torch.Generator().manual_seed(0))
    assert state["step"].device == params["src_embed"].device == \
        torch.device("cpu")
    with pytest.raises(EnforceNotMet, match="queue 1 item 9"):
        ttr.make_train_step(tcfg, opt, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------
def test_forward_logits_match_jax():
    jcfg, tcfg = _cfgs()
    jp, _, tp = _start(jcfg, tcfg)
    b = _batch(jcfg)
    jl = np.asarray(jtr.forward(jp, jcfg, b["src_ids"], b["tgt_in"],
                                b["src_mask"], b["tgt_mask"]))
    tl = ttr.forward(tp, tcfg, b["src_ids"], b["tgt_in"], b["src_mask"],
                     b["tgt_mask"])
    assert tl.dtype == torch.float32 and tl.shape == (3, 10, 64)
    assert _rel(tl.detach().numpy(), jl) < 1e-5
    # masks default to all ones in both
    jl = np.asarray(jtr.forward(jp, jcfg, b["src_ids"], b["tgt_in"]))
    tl = ttr.forward(tp, tcfg, b["src_ids"], b["tgt_in"])
    assert _rel(tl.detach().numpy(), jl) < 1e-5


def test_nmt_loss_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, _, tp = _start(jcfg, tcfg)
    b = _batch(jcfg)
    want = float(jtr.nmt_loss(jp, jcfg, b))
    got = float(ttr.nmt_loss(tp, tcfg, b))
    assert abs(got - want) <= 1e-6 * abs(want)
    # without tgt_mask every token weighs 1, as in the JAX package
    nb = {k: v for k, v in b.items() if k != "tgt_mask"}
    want = float(jtr.nmt_loss(jp, jcfg, nb))
    assert abs(float(ttr.nmt_loss(tp, tcfg, nb)) - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _jax_train(jcfg, batch, steps):
    """(initial params, initial opt state, losses, final params), numpy."""
    mesh = make_mesh(MeshConfig(data=1, model=1, seq=1, pipe=1))
    with mesh_guard(mesh):
        init_fn, step_fn = jtr.make_train_step(
            jcfg, jpt.optimizer.Adam(learning_rate=LR), mesh)
        params, state = init_fn(jax.random.PRNGKey(0))
        p0 = jax.tree.map(lambda a: np.array(a), params)
        s0 = jax.tree.map(lambda a: np.array(a), state)
        losses = []
        for _ in range(steps):
            loss, params, state = step_fn(params, state, batch)
            losses.append(float(loss))
        return p0, s0, losses, jax.tree.map(lambda a: np.array(a), params)


def _port_train(tcfg, p0, s0, batch, steps):
    opt = topt.Adam(learning_rate=LR)
    params = ttr.params_from_numpy(p0, tcfg, device="cpu")
    state = opt.state_from_numpy(s0, params)
    _, step_fn = ttr.make_train_step(tcfg, opt, device="cpu")
    losses = []
    for _ in range(steps):
        loss, params, state = step_fn(params, state, batch)
        losses.append(float(loss))
    assert int(state["step"]) == steps
    return losses, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_match_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    batch = _batch(jcfg)
    p0, s0, losses_j, pj = _jax_train(jcfg, batch, 3)
    losses_t, params = _port_train(tcfg, p0, s0, batch, 3)
    assert losses_t[-1] < losses_t[0] and losses_j[-1] < losses_j[0]
    if dtype == "bfloat16":
        np.testing.assert_allclose(losses_t, losses_j, atol=0.03, rtol=0)
        return
    np.testing.assert_allclose(losses_t, losses_j, atol=1e-5, rtol=0)
    want = _flat(pj)
    got = _flat(jax.tree.map(lambda t: t.numpy(), params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_remat_equals_no_remat():
    _, tcfg = _cfgs()
    b = _batch(tcfg)
    params = ttr.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    loss, grads = ttr._loss_and_grads(params, tcfg, b)
    rcfg = ttr.transformer_tiny(dtype=torch.float32, remat=True)
    rloss, rgrads = ttr._loss_and_grads(params, rcfg, b)
    assert float(rloss) == float(loss)
    for a, r in zip(leaves(grads), leaves(rgrads)):
        assert torch.equal(a, r)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------
def test_greedy_decode_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, _, tp = _start(jcfg, tcfg)
    b = _batch(jcfg)
    for max_len in (None, 9):
        want = np.asarray(jtr.greedy_decode(jp, jcfg, b["src_ids"],
                                            b["src_mask"], max_len))
        got = ttr.greedy_decode(tp, tcfg, b["src_ids"], b["src_mask"],
                                max_len)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_beam_search_decode_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, _, tp = _start(jcfg, tcfg)
    b = _batch(jcfg)
    for beam, max_len in ((4, None), (3, 7)):
        wseq, wsc = jtr.beam_search_decode(jp, jcfg, b["src_ids"],
                                           b["src_mask"], beam, max_len)
        gseq, gsc = ttr.beam_search_decode(tp, tcfg, b["src_ids"],
                                           b["src_mask"], beam, max_len)
        assert gseq.dtype == torch.int32 and gsc.dtype == torch.float32
        assert gseq.shape == wseq.shape
        np.testing.assert_array_equal(gseq.numpy(), np.asarray(wseq))
        np.testing.assert_allclose(gsc.numpy(), np.asarray(wsc), atol=1e-5,
                                   rtol=0)
        # best first
        assert (np.diff(gsc.numpy(), axis=1) <= 0).all()


def test_decoding_past_max_seq_raises_as_jax():
    jcfg, tcfg = _cfgs()
    jp, _, tp = _start(jcfg, tcfg)
    b = _batch(jcfg)
    msg = "max_len=17 exceeds cfg.max_seq=16"
    for jfn, tfn in ((jtr.greedy_decode, ttr.greedy_decode),
                     (jtr.beam_search_decode, ttr.beam_search_decode)):
        with pytest.raises(ValueError, match=msg):
            jfn(jp, jcfg, b["src_ids"], b["src_mask"], max_len=17)
        with pytest.raises(ValueError, match=msg):
            tfn(tp, tcfg, b["src_ids"], b["src_mask"], max_len=17)


def test_decode_step_writes_the_cache_in_place():
    """The port's in-place cache write at ``pos`` against the JAX step's
    ``dynamic_update_slice`` copy, over three steps."""
    jcfg, tcfg = _cfgs()
    jp, _, tp = _start(jcfg, tcfg)
    b = _batch(jcfg)
    jmem = jtr.encode(jp, jcfg, b["src_ids"], b["src_mask"])
    jcross = jtr._cross_kv(jp, jcfg, jmem)
    jbias = jnp.where(jnp.asarray(b["src_mask"])[:, None, None, :] > 0,
                      0.0, -1e9)
    jcache = jtr._init_cache(jcfg, 3)
    with torch.no_grad():
        tmem = ttr.encode(tp, tcfg, b["src_ids"], b["src_mask"])
        tcross = ttr._cross_kv(tp, tcfg, tmem)
        tbias = ttr._mask_bias(torch.as_tensor(b["src_mask"]))
        tcache = ttr._init_cache(tcfg, 3, torch.device("cpu"))
        buffers = [c["k"].data_ptr() for c in tcache]
        for pos, tok in enumerate((0, 5, 9)):
            jl, jcache = jtr._decode_step(jp, jcfg, jnp.full((3,), tok),
                                          pos, jcache, jcross, jbias)
            tl, tcache = ttr._decode_step(tp, tcfg, torch.full((3,), tok),
                                          pos, tcache, tcross, tbias)
            assert _rel(tl.numpy(), np.asarray(jl)) < 1e-5
    assert [c["k"].data_ptr() for c in tcache] == buffers
    for jc, tc in zip(jcache, tcache):
        for n in ("k", "v"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       atol=1e-5, rtol=0)
            assert not tc[n][:, :, 3:].any()
