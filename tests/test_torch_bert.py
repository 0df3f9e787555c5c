"""The port's BERT (paddle_tpu_torch.models.bert) against the JAX package's.

JAX ``init_params`` cross over through ``params_from_numpy``; the same
numpy batch (with attention-mask padding and token types) goes through
both ``forward`` and ``mlm_loss`` on the CPU, in both batch layouts, with
dense attention and with flash attention (the JAX side under
``pallas.override("on")``, i.e. its Pallas kernels in interpret mode).

Tolerances: in fp32 the two differ only by summation order (observed
~1e-6 on hidden states of unit scale): hidden 1e-4, loss 1e-5. In bf16 the
frameworks round at other places (observed 1.6e-2 on hidden, 1.2e-4 on
the loss): hidden 0.06 (a few bf16 units at |x| ~ 2), loss 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.pallas as jpallas
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.models import bert as tbert

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (0.06, 2e-3)}


def _configs(dtype, impl):
    jd, td = _DT[dtype]
    return (jbert.bert_tiny(dtype=jd, attention_impl=impl),
            tbert.bert_tiny(dtype=td, attention_impl=impl))


def _jax_params(jcfg, seed=0):
    jp = jbert.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, jax.tree.map(np.asarray, jp)


def _batch(cfg, gathered, seed=1):
    b = jbert.synthetic_batch(cfg, 2, 48, seed=seed,
                              max_preds=6 if gathered else None)
    b["attention_mask"][1, 40:] = 0          # a padded row
    b["token_type_ids"][:, 20:] = 1
    return b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("layout", ["dense", "gathered"])
def test_forward_and_mlm_loss_match_jax(dtype, impl, layout):
    jcfg, tcfg = _configs(dtype, impl)
    jp, npp = _jax_params(jcfg)
    tp = tbert.params_from_numpy(npp, tcfg, device="cpu")
    batch = _batch(jcfg, layout == "gathered")
    with jpallas.override("on" if impl == "flash" else "auto"):
        hj = jbert.forward(jp, jcfg, batch["input_ids"],
                           batch["token_type_ids"], batch["attention_mask"])
        lj = float(jbert.mlm_loss(jp, jcfg, batch))
    with torch.inference_mode():
        ht = tbert.forward(tp, tcfg, batch["input_ids"],
                           batch["token_type_ids"], batch["attention_mask"])
        lt = float(tbert.mlm_loss(tp, tcfg, batch))
    assert ht.dtype == tcfg.dtype and tuple(ht.shape) == (2, 48, 64)
    h_tol, l_tol = _TOL[dtype]
    np.testing.assert_allclose(ht.float().numpy(),
                               np.asarray(hj.astype(jnp.float32)),
                               atol=h_tol, rtol=0)
    assert np.isfinite(lt)
    assert abs(lt - lj) <= l_tol, (lt, lj)


def test_mlm_head_gathered_equals_dense_rows():
    # the fill-mask head at given positions is the dense head's rows there
    _, tcfg = _configs("float32", "dense")
    jcfg, _ = _configs("float32", "dense")
    _, npp = _jax_params(jcfg)
    tp = tbert.params_from_numpy(npp, tcfg, device="cpu")
    batch = _batch(jcfg, gathered=True)
    with torch.inference_mode():
        hidden = tbert.forward(tp, tcfg, batch["input_ids"])
        dense = tbert._mlm_head(tp, tcfg, hidden)
        picked = tbert._mlm_head(tp, tcfg, hidden,
                                 batch["masked_positions"])
    assert dense.dtype == picked.dtype == torch.float32
    rows = torch.stack([dense[i, torch.as_tensor(p).long()]
                        for i, p in enumerate(batch["masked_positions"])])
    torch.testing.assert_close(picked, rows, atol=1e-5, rtol=1e-5)


def test_params_from_numpy_is_strict():
    jcfg, tcfg = _configs("float32", "dense")
    _, npp = _jax_params(jcfg)
    tp = tbert.params_from_numpy(npp, tcfg, device="cpu")
    assert tp["layers"][1]["qkv_w"].shape == (64, 192)
    np.testing.assert_array_equal(tp["embed"]["word"].numpy(),
                                  npp["embed"]["word"])

    def bad(mutate, match):
        tree = jax.tree.map(lambda a: a, npp)      # a fresh container tree
        mutate(tree)
        with pytest.raises(EnforceNotMet, match=match):
            tbert.params_from_numpy(tree, tcfg, device="cpu")

    bad(lambda t: t["mlm"].pop("bias"), r"missing \['bias'\]")
    bad(lambda t: t["embed"].__setitem__("extra", np.zeros(3, np.float32)),
        r"unexpected \['extra'\]")
    bad(lambda t: t["layers"].pop(), "list of 2")
    bad(lambda t: t["layers"][0].__setitem__(
        "fc1_w", np.zeros((64, 64), np.float32)), "layers.0.fc1_w")
    bad(lambda t: t["embed"].__setitem__(
        "pos", t["embed"]["pos"].astype(np.float64)), "embed.pos")
    bad(lambda t: t.__setitem__("mlm", [1]), "mlm must be a dict")


def test_init_params_layout_and_scale():
    cfg = tbert.bert_tiny(dtype=torch.float32)
    p = tbert.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    jcfg = jbert.bert_tiny(dtype=jnp.float32)
    ref = jax.eval_shape(lambda: jbert.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    flat = jax.tree_util.tree_flatten_with_path
    assert ({jax.tree_util.keystr(k): tuple(t.shape)
             for k, t in flat(p)[0]}
            == {jax.tree_util.keystr(k): tuple(a.shape)
                for k, a in flat(ref)[0]})
    w = p["layers"][0]["fc1_w"]
    assert w.dtype == torch.float32 and abs(w.std().item() - 0.02) < 2e-3
    assert torch.equal(p["mlm"]["ln_g"], torch.ones(64))
    again = tbert.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    assert torch.equal(again["embed"]["word"], p["embed"]["word"])


def test_synthetic_batch_and_flops_match_jax():
    for kw in ({}, {"max_preds": 5}):
        jb = jbert.synthetic_batch(jbert.bert_tiny(), 3, 32, seed=4, **kw)
        tb = tbert.synthetic_batch(tbert.bert_tiny(), 3, 32, seed=4, **kw)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
            assert jb[k].dtype == tb[k].dtype
    for kw in ({}, {"seq_len": 128, "max_preds": 20}):
        assert tbert.flops_per_token(tbert.bert_base(), **kw) == \
            jbert.flops_per_token(jbert.bert_base(), **kw)


def test_presets_match_jax():
    # both configs' fields: a field the port lacks fails here too
    names = ({f.name for f in dataclasses.fields(jbert.BertConfig)}
             | {f.name for f in dataclasses.fields(tbert.BertConfig)})
    for name in ("bert_base", "bert_large", "ernie_base", "bert_tiny"):
        jc, tc = getattr(jbert, name)(), getattr(tbert, name)()
        for f in sorted(names - {"dtype"}):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert tc.dtype == torch.bfloat16 and tc.head_dim == jc.head_dim
    # the bench trainers build their configs so
    assert tbert.bert_base(remat=False).remat is False
    assert tbert.bert_tiny().remat is False and tbert.bert_base().remat


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_remat_gives_the_same_loss_and_grads(impl):
    cfg = tbert.bert_tiny(dtype=torch.float32, attention_impl=impl)
    params = tbert.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    batch = tbert.synthetic_batch(cfg, 2, 48, seed=1, max_preds=6)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        live = jax.tree.map(lambda t: t.clone().requires_grad_(), params)
        loss = tbert.mlm_loss(live, c, batch)
        grads = torch.autograd.grad(loss, jax.tree.leaves(live))
        out.append((loss, grads))
    (l0, g0), (l1, g1) = out
    # the recompute repeats the same ops on the same inputs: bit-identical
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_auto_attention_takes_flash_beyond_1024(monkeypatch):
    calls = []
    real = tbert.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tbert, "flash_attention", spy)
    cfg = tbert.bert_tiny(dtype=torch.float32, hidden=32, num_heads=2,
                          num_layers=1, intermediate=32, max_seq=1100,
                          vocab_size=64)
    p = tbert.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    ids = np.zeros((1, 1024), np.int32)
    with torch.inference_mode():
        tbert.forward(p, cfg, ids)
        assert calls == []
        tbert.forward(p, cfg, np.zeros((1, 1100), np.int32))
    assert calls == [(1, 2, 1100, 16)]


def test_ring_attention_is_not_ported():
    cfg = tbert.bert_tiny(dtype=torch.float32, attention_impl="ring")
    p = tbert.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    with pytest.raises(EnforceNotMet, match="ring"):
        tbert.forward(p, cfg, np.zeros((1, 8), np.int32))
