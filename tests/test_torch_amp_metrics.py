"""``amp``, ``metrics`` and ``distributions`` in the port against the JAX
package, on the CPU.

- ``LossScaler``: the state (scale, good, bad) and the ``finite`` flag
  after each step of a sequence with injected infs and NaNs, equal to the
  JAX scaler's, and the unscaled grads within 1e-7.
- The fp16 policy with a scaler: a non-finite step leaves params, Adam
  slots and the step counter bitwise unchanged, with no host read (a
  ``.item()``, ``bool()`` or ``float()`` on a tensor raises inside
  ``apply_gradients``); over a sequence of finite and non-finite steps the
  params and slots equal the JAX optimizer's within 1e-6.
- The bf16 policy (no scaler; the grads cast to fp32), ``cast_tree`` and
  the lists.
- The 37 ``metrics`` names: every class over the same update sequences,
  the port's fed tensors, the JAX package's numpy, ``eval()`` equal.
- ``distributions``: ``log_prob``, ``entropy`` and ``kl_divergence``
  within 1e-6 of JAX; samples by their moments (4 standard errors) and
  the seed rules (a seed gives the same draws every call; seed 0 the
  global counter's next generator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import amp as jamp
from paddle_tpu import distributions as jdist
from paddle_tpu import metrics as jmetrics

import paddle_tpu_torch as tpt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import distributions as tdist
from paddle_tpu_torch import metrics as tmetrics
from paddle_tpu_torch.core import random as trandom


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


#: the grads of each step are finite, or hold an inf or a NaN
PATTERN = ("ok", "inf", "nan", "ok", "ok", "ok", "ok", "inf", "ok", "inf",
           "inf", "inf", "ok", "ok", "ok")


def _grads(step, kind):
    g = {"w": _np(step, 3, 4) * 8.0, "b": [_np(50 + step, 4) * 8.0]}
    if kind != "ok":
        g["w"][1, 2] = np.inf if kind == "inf" else np.nan
    return g


def test_loss_scaler_state_sequence_equals_jax():
    kw = dict(init_loss_scaling=8.0, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=3, decr_every_n_nan_or_inf=2)
    ts, js = tamp.LossScaler(**kw), jamp.LossScaler(**kw)
    tst, jst = ts.init(device="cpu"), js.init()
    assert tst["scale"].dtype == torch.float32
    assert tst["good"].dtype == tst["bad"].dtype == torch.int32
    scales = []
    for step, kind in enumerate(PATTERN):
        g = _grads(step, kind)
        tg, tfin, tst = ts.unscale_and_update(
            jax.tree.map(torch.as_tensor, g), tst)
        jg, jfin, jst = js.unscale_and_update(
            jax.tree.map(jnp.asarray, g), jst)
        assert bool(tfin) == bool(jfin) == (kind == "ok")
        for k in ("scale", "good", "bad"):
            assert tst[k].item() == np.asarray(jst[k]).item(), (step, k)
        if kind == "ok":
            np.testing.assert_allclose(tg["w"].numpy(), np.asarray(jg["w"]),
                                       rtol=1e-7)
        scales.append(tst["scale"].item())
    # the sequence both halves and doubles the scale
    assert any(b < a for a, b in zip(scales, scales[1:]))
    assert any(b > a for a, b in zip(scales, scales[1:]))
    loss = torch.tensor(1.5)
    assert ts.scale_loss(loss, tst).item() == 1.5 * scales[-1]
    static = tamp.LossScaler(use_dynamic_loss_scaling=False)
    st = static.init(device="cpu")
    _, fin, st2 = static.unscale_and_update(
        jax.tree.map(torch.as_tensor, _grads(0, "inf")), st)
    assert not bool(fin) and st2 is st


def _params():
    return {"w": _np(70, 3, 4), "b": [_np(71, 4)]}


def _refuse(*a, **k):
    raise AssertionError("a host read inside apply_gradients")


def test_fp16_skipped_step_is_bitwise_and_reads_nothing_on_the_host(
        monkeypatch):
    topt = tamp.decorate(tpt.optimizer.Adam(0.01), use_bf16=False,
                         init_loss_scaling=4.0)
    jopt = jamp.decorate(jpt.optimizer.Adam(0.01), use_bf16=False,
                         init_loss_scaling=4.0)
    assert isinstance(topt.policy.compute_dtype, torch.dtype)
    assert topt.policy.compute_dtype == torch.float16
    tp = jax.tree.map(torch.as_tensor, _params())
    jp = jax.tree.map(jnp.asarray, _params())
    tst, jst = topt.init(tp), jopt.init(jp)
    skipped = 0
    for step, kind in enumerate(PATTERN[:9]):
        g = _grads(step, kind)
        before = [t.clone() for t in (tp["w"], tp["b"][0],
                                      tst["opt"]["step"],
                                      *tst["opt"]["slots"]["w"].values())]
        with monkeypatch.context() as m:
            for name in ("item", "__bool__", "__float__", "__int__",
                         "tolist", "numpy"):
                m.setattr(torch.Tensor, name, _refuse)
            tp, tst = topt.apply_gradients(
                tp, jax.tree.map(torch.as_tensor, g), tst)
        jp, jst = jopt.apply_gradients(jp, jax.tree.map(jnp.asarray, g), jst)
        after = (tp["w"], tp["b"][0], tst["opt"]["step"],
                 *tst["opt"]["slots"]["w"].values())
        if kind != "ok":
            skipped += 1
            for a, b in zip(after, before):
                assert torch.equal(a, b) and a.dtype == b.dtype
        assert tst["opt"]["step"].item() == int(jst["opt"]["step"])
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   atol=1e-6)
        for k, v in tst["opt"]["slots"]["w"].items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(jst["opt"]["slots"]["w"][k]),
                atol=1e-6, rtol=1e-5)
        for k in ("scale", "good", "bad"):
            assert tst["loss_scale"][k].item() == \
                np.asarray(jst["loss_scale"][k]).item()
    assert skipped == 3
    assert topt.scale_loss(torch.tensor(2.0), tst).item() == \
        2.0 * tst["loss_scale"]["scale"].item()
    # monitor_state publishes the scale to tensor watch, as the JAX one does
    from paddle_tpu.monitor.registry import REGISTRY as JREG

    from paddle_tpu_torch.monitor.registry import REGISTRY as TREG
    assert topt.monitor_state(tst, step=9) == jopt.monitor_state(jst, step=9)
    assert TREG.get("loss_scale").value() == JREG.get("loss_scale").value() \
        == tst["loss_scale"]["scale"].item()


def test_bf16_policy_cast_tree_and_lists():
    t = tamp.decorate(tpt.optimizer.SGD(0.1))
    j = jamp.decorate(jpt.optimizer.SGD(0.1))
    assert t.scaler is None and j.scaler is None
    assert t.policy.compute_dtype == torch.bfloat16
    assert t.policy.param_dtype == t.policy.output_dtype == torch.float32
    tp = jax.tree.map(torch.as_tensor, _params())
    tp["n"] = torch.arange(3)
    cast = t.cast_params(tp)
    assert cast["w"].dtype == cast["b"][0].dtype == torch.bfloat16
    assert cast["n"].dtype == torch.int64 and tp["w"].dtype == torch.float32
    jp = jax.tree.map(jnp.asarray, _params())
    st, jst = t.init({"w": tp["w"], "b": tp["b"]}), j.init(jp)
    g = jax.tree.map(torch.as_tensor, _grads(1, "ok"))
    g = tamp.cast_tree(g, torch.bfloat16)
    t.apply_gradients({"w": tp["w"], "b": tp["b"]}, g, st)
    jp, _ = j.apply_gradients(
        jp, jamp.cast_tree(jax.tree.map(jnp.asarray, _grads(1, "ok")),
                           jnp.bfloat16), jst)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)
    assert t.monitor_state(st) is None
    assert tamp.black_list == jamp.black_list
    assert tamp.white_list == jamp.white_list
    for kw in ({}, dict(custom_white_list={"layer_norm", "exp"}),
               dict(custom_black_list={"conv2d"}),
               dict(custom_white_list={"softmax"},
                    custom_black_list={"mul", "tanh"})):
        a, b = tamp.AutoMixedPrecisionLists(**kw), \
            jamp.AutoMixedPrecisionLists(**kw)
        assert (a.white_list, a.black_list, a.gray_list) == \
            (b.white_list, b.black_list, b.gray_list)
    for pkg in (tamp, jamp):
        with pytest.raises(ValueError):
            pkg.AutoMixedPrecisionLists(custom_white_list={"x"},
                                        custom_black_list={"x"})


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _metric_updates(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "Accuracy":
        return [(np.float32(rng.rand()), int(rng.randint(1, 9)))
                for _ in range(5)]
    if kind in ("Precision", "Recall", "Composite"):
        return [(rng.rand(20, 1).astype(np.float32),
                 rng.randint(0, 2, (20, 1)).astype(np.int64))
                for _ in range(4)]
    if kind == "Auc":
        return [(rng.dirichlet([1, 1], 30).astype(np.float32),
                 rng.randint(0, 2, (30, 1)).astype(np.int64))
                for _ in range(4)]
    if kind == "ChunkEvaluator":
        return [tuple(np.int64(v) for v in (rng.randint(5, 9),
                                            rng.randint(5, 9),
                                            rng.randint(0, 5)))
                for _ in range(4)]
    if kind == "EditDistance":
        return [(rng.randint(0, 3, (6, 1)).astype(np.float32), np.int64(6))
                for _ in range(4)]
    raise KeyError(kind)


def _as_port(args):
    return tuple(torch.as_tensor(a) if isinstance(a, np.ndarray)
                 else torch.tensor(a) if isinstance(a, np.generic) else a
                 for a in args)


@pytest.mark.parametrize("kind", ["Accuracy", "Precision", "Recall", "Auc",
                                  "ChunkEvaluator", "EditDistance",
                                  "Composite"])
def test_metric_matches_jax_over_updates(kind):
    if kind == "Composite":
        t, j = tmetrics.CompositeMetric(), jmetrics.CompositeMetric()
        for cls in ("Precision", "Recall"):
            t.add_metric(getattr(tmetrics, cls)())
            j.add_metric(getattr(jmetrics, cls)())
    else:
        t, j = getattr(tmetrics, kind)(), getattr(jmetrics, kind)()
    for rnd in range(2):
        for args in _metric_updates(kind, 10 * rnd + 1):
            t.update(*_as_port(args))
            j.update(*args)
        got, want = t.eval(), j.eval()
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=1e-12)
        t.reset()
        j.reset()
    assert t._name == j._name


def test_detection_map_metric_matches_jax():
    rng = np.random.RandomState(3)
    t = tmetrics.DetectionMAP(class_num=3, overlap_threshold=0.5)
    j = jmetrics.DetectionMAP(class_num=3, overlap_threshold=0.5)
    for _ in range(3):
        gt_box = rng.rand(4, 4).astype(np.float32)
        gt_box[:, 2:] = gt_box[:, :2] + 0.3
        gt_label = rng.randint(0, 3, (4,)).astype(np.int32)
        det = np.concatenate([gt_label[:, None].astype(np.float32),
                              rng.rand(4, 1).astype(np.float32),
                              gt_box + 0.02 * rng.randn(4, 4)
                              .astype(np.float32)], axis=1)
        t.update(torch.as_tensor(det), torch.as_tensor(gt_label),
                 torch.as_tensor(gt_box))
        j.update(det, gt_label, gt_box)
    np.testing.assert_allclose(float(t.eval()), float(j.eval()), rtol=1e-6)
    for pkg in (tmetrics, jmetrics):
        with pytest.raises(ValueError):
            pkg.DetectionMAP().eval()


def test_metrics_surface_is_the_jax_one():
    assert tmetrics.__all__ == jmetrics.__all__
    for n in jmetrics.__all__:
        for m in ("reset", "update", "eval"):
            assert callable(getattr(getattr(tmetrics, n), m))


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------
def _pairs():
    loc, scale = _np(80, 3), np.abs(_np(81, 3)) + 0.5
    loc2, scale2 = _np(82, 3), np.abs(_np(83, 3)) + 0.3
    logits, logits2 = _np(84, 2, 5), _np(85, 2, 5)
    return {
        "Uniform": ((loc - 1.0, loc + scale), (loc2 - 1.0, loc2 + 1.0),
                    loc + 0.2),
        "Normal": ((loc, scale), (loc2, scale2), _np(86, 3)),
        "Categorical": ((logits,), (logits2,),
                        np.array([1, 4], np.int64)),
        "MultivariateNormalDiag": ((loc, scale), (loc2, scale2),
                                   _np(87, 4, 3)),
    }


@pytest.mark.parametrize("name", ["Uniform", "Normal", "Categorical",
                                  "MultivariateNormalDiag"])
def test_distribution_formulas_match_jax(name):
    a, b, value = _pairs()[name]
    t = getattr(tdist, name)(*a, device="cpu")
    j = getattr(jdist, name)(*a)
    tv, jv = torch.as_tensor(value), jnp.asarray(value)
    np.testing.assert_allclose(t.log_prob(tv).numpy(),
                               np.asarray(j.log_prob(jv)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(t.entropy().numpy(), np.asarray(j.entropy()),
                               rtol=1e-6, atol=1e-6)
    if name != "Uniform":
        np.testing.assert_allclose(
            t.kl_divergence(getattr(tdist, name)(*b, device="cpu")).numpy(),
            np.asarray(j.kl_divergence(getattr(jdist, name)(*b))),
            rtol=1e-6, atol=1e-6)


def test_distribution_samples_by_moments_and_seed_rules():
    n = 20000
    u = tdist.Uniform(-1.0, 3.0, device="cpu")
    s = u.sample([n], seed=5)
    assert s.shape == (n,) and s.dtype == torch.float32
    assert float(s.min()) >= -1.0 and float(s.max()) < 3.0
    se = 4 * np.sqrt(16 / 12 / n)
    assert abs(float(s.mean()) - 1.0) < se
    assert torch.equal(s, u.sample([n], seed=5))
    assert not torch.equal(s, u.sample([n], seed=6))
    trandom.seed(11)
    a = u.sample([n])
    b = u.sample([n])
    trandom.seed(11)
    assert torch.equal(u.sample([n]), a) and not torch.equal(a, b)
    g = torch.Generator().manual_seed(3)
    assert torch.equal(u.sample([4], rng=g),
                       u.sample([4], rng=torch.Generator().manual_seed(3)))
    nrm = tdist.Normal(torch.tensor([0.0, 2.0]), torch.tensor([1.0, 0.5]))
    x = nrm.sample([n], seed=7)
    assert x.shape == (n, 2)
    np.testing.assert_allclose(x.mean(0).numpy(), [0.0, 2.0],
                               atol=4 * 1.0 / np.sqrt(n))
    np.testing.assert_allclose(x.std(0).numpy(), [1.0, 0.5], rtol=0.03)
    mvn = tdist.MultivariateNormalDiag(torch.tensor([1.0, -1.0, 0.0]),
                                       torch.tensor([0.5, 2.0, 1.0]))
    y = mvn.sample([n], seed=8)
    np.testing.assert_allclose(y.mean(0).numpy(), [1.0, -1.0, 0.0],
                               atol=4 * 2.0 / np.sqrt(n))
    np.testing.assert_allclose(y.std(0).numpy(), [0.5, 2.0, 1.0], rtol=0.03)
    logits = torch.log(torch.tensor([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]]))
    cat = tdist.Categorical(logits)
    c = cat.sample([n], seed=9)
    assert c.shape == (n, 2) and c.dtype == torch.int64
    freq = torch.stack([torch.bincount(c[:, i], minlength=3) for i in
                        range(2)]).numpy() / n
    np.testing.assert_allclose(freq, torch.exp(logits).numpy(), atol=0.015)
    jc = np.asarray(jdist.Categorical(logits.numpy()).sample(
        [n], rng=jax.random.PRNGKey(0)))
    assert jc.shape == tuple(c.shape)
