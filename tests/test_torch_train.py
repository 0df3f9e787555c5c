"""BERT pretraining in the port (paddle_tpu_torch) against the JAX package.

The JAX package's ``make_train_step`` on a one-device mesh runs under
``pallas.override("on")``, so its LayerNorm (with ``_fused_ln_bwd``), flash
attention (with both Pallas backward kernels) and fused Adam run as Pallas
kernels in interpret mode. Its initial parameters and optimizer state cross
over through ``params_from_numpy`` / ``state_from_numpy``; the same numpy
batch then trains both for five steps on the CPU.

Tolerances. fp32: the two differ only by summation order (~1e-6 relative
per op; observed losses 1e-6): losses 2e-5. Adam's early updates are
sign-like, lr * m1 / (sqrt(m2) + eps), so where a grad is within rounding
of zero a relative grad difference becomes an update difference of a few
percent of lr (observed 1.6e-5 on parameters): parameters 1e-4, a tenth of
one step. bf16: activations round at other places in the two frameworks
(forward hidden states differ by a few bf16 units, tests/test_torch_bert.py;
observed losses 6e-4): losses 5e-3; and two updates of at most ~lr each
may differ by 2 lr per step where the grad is near zero (observed 3.6e-3
after five steps): parameters 10 * lr. That bound alone would pass an
update of half strength or none, so each leaf's update (final minus
initial parameters) is also held to JAX's by relative norm error: observed
at most 6e-5 in fp32 and 0.062 in bf16 (per-leaf median 0.012), held to
1e-3 and 0.15, where an update of half strength reads 0.5 and none 1.0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.ops.pallas as jpallas
from paddle_tpu.models import bert as jbert
from paddle_tpu.parallel.mesh import MeshConfig, make_mesh, mesh_guard
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.models import bert as tbert

LR = 1e-3
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_TOL = {"float32": (2e-5, 1e-4, 1e-3), "bfloat16": (5e-3, 10 * LR, 0.15)}


def _copy(tree):
    # a copy, not a view: the JAX step donates its inputs
    return jax.tree.map(lambda a: np.array(a), tree)


def _jax_run(jcfg, batch, n_steps):
    """(initial params, initial opt state, losses, final params) of the
    JAX package's train step, all as numpy."""
    mesh = make_mesh(MeshConfig(data=1, model=1, seq=1, pipe=1))
    with mesh_guard(mesh), jpallas.override("on"):
        init_fn, step_fn = jbert.make_train_step(
            jcfg, pt.optimizer.Adam(learning_rate=LR), mesh)
        params, state = init_fn(jax.random.PRNGKey(0))
        p0, s0 = _copy(params), _copy(state)
        losses = []
        for _ in range(n_steps):
            loss, params, state = step_fn(params, state, batch)
            losses.append(float(loss))
        return p0, s0, losses, _copy(params)


def _port_setup(tcfg, p0, s0, **kw):
    opt = topt.Adam(learning_rate=LR)
    params = tbert.params_from_numpy(p0, tcfg, device="cpu")
    state = opt.state_from_numpy(s0, params)
    _, step_fn = tbert.make_train_step(tcfg, opt, device="cpu", **kw)
    return params, state, step_fn


def _batch(cfg, gathered):
    b = jbert.synthetic_batch(cfg, 2, 48, seed=1,
                              max_preds=6 if gathered else None)
    b["attention_mask"][1, 40:] = 0          # a padded row
    return b


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype,impl,layout", [
    ("float32", "dense", "dense"), ("float32", "dense", "gathered"),
    ("float32", "flash", "dense"), ("float32", "flash", "gathered"),
    ("bfloat16", "dense", "gathered"), ("bfloat16", "flash", "dense")])
def test_train_step_matches_jax(dtype, impl, layout):
    jd, td = _DT[dtype]
    jcfg = jbert.bert_tiny(dtype=jd, attention_impl=impl)
    tcfg = tbert.bert_tiny(dtype=td, attention_impl=impl)
    batch = _batch(jcfg, layout == "gathered")
    p0, s0, losses_j, pj = _jax_run(jcfg, batch, 5)
    params, state, step_fn = _port_setup(tcfg, p0, s0)
    losses_t = []
    for _ in range(5):
        loss, params, state = step_fn(params, state, batch)
        losses_t.append(float(loss))
    assert int(state["step"]) == 5
    loss_tol, p_tol, upd_tol = _TOL[dtype]
    np.testing.assert_allclose(losses_t, losses_j, atol=loss_tol, rtol=0)
    assert losses_t[-1] < losses_t[0]
    start, want = _flat(p0), _flat(pj)
    got = _flat(jax.tree.map(lambda t: t.numpy(), params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=p_tol, rtol=0,
                                   err_msg=k)
        upd_j, upd_t = want[k] - start[k], got[k] - start[k]
        err = np.linalg.norm(upd_t - upd_j) / np.linalg.norm(upd_j)
        assert err < upd_tol, f"{k}: update relative norm error {err}"


def test_adam_apply_gradients_matches_jax():
    rng = np.random.RandomState(0)
    shapes = {"w": (33, 70), "b": (5,), "deep": [{"x": (1,)}, {"x": (130,)}]}
    make = lambda: jax.tree.map(  # noqa: E731
        lambda s: rng.randn(*s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    p_np, grads_np = make(), [make() for _ in range(7)]
    jopt = pt.optimizer.Adam(learning_rate=0.01)
    jp = jax.tree.map(jnp.asarray, p_np)
    with jpallas.override("on"):
        jstate = jopt.init(jp)
        for g in grads_np:
            jp, jstate = jopt.apply_gradients(
                jp, jax.tree.map(jnp.asarray, g), jstate)
    topt_ = topt.Adam(learning_rate=0.01)
    tp = jax.tree.map(torch.tensor, p_np)
    tstate = topt_.init(tp)
    for g in grads_np:
        out_p, out_s = topt_.apply_gradients(tp, jax.tree.map(torch.tensor, g),
                                             tstate)
        assert out_p is tp and out_s is tstate      # in place
    assert int(tstate["step"]) == 7 and tstate["step"].dtype == torch.int32
    # the same fp32 ops in the same order: only pow may differ by an ulp
    for got, want in ((tp, jp), (tstate["slots"], jstate["slots"])):
        np.testing.assert_allclose(
            np.concatenate([t.numpy().ravel() for t in jax.tree.leaves(got)]),
            np.concatenate([np.asarray(a).ravel()
                            for a in jax.tree.leaves(want)]),
            rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("stacked", [False, True])
def test_steps_per_call_equals_single_steps(stacked):
    cfg = tbert.bert_tiny(dtype=torch.float32)
    batch = tbert.synthetic_batch(cfg, 4, 32)
    opt = topt.Adam(learning_rate=LR)

    def fresh(k):
        init_fn, step_fn = tbert.make_train_step(cfg, opt, steps_per_call=k,
                                                 device="cpu")
        params, state = init_fn(torch.Generator().manual_seed(0))
        return params, state, step_fn

    params1, state1, step1 = fresh(1)
    for _ in range(3):
        loss1, params1, state1 = step1(params1, state1, batch)
    params3, state3, step3 = fresh(3)
    b3 = ({k: np.broadcast_to(v, (3,) + v.shape).copy()
           for k, v in batch.items()} if stacked else batch)
    loss3, params3, state3 = step3(params3, state3, b3)
    assert int(state3["step"]) == 3
    assert float(loss3) == float(loss1)
    for a, b in zip(jax.tree.leaves(params1), jax.tree.leaves(params3)):
        assert torch.equal(a, b)
    if stacked:
        bad = {k: v[:2] for k, v in b3.items()}
        with pytest.raises(ValueError, match="leading axis 2 != "
                                             "steps_per_call 3"):
            step3(params3, state3, bad)


def test_state_from_numpy_is_strict():
    cfg = tbert.bert_tiny(dtype=torch.float32)
    params = tbert.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    opt = topt.Adam()
    good = {"step": np.asarray(3, np.int32),
            "slots": jax.tree.map(
                lambda t: {"moment1": np.ones(t.shape, np.float32),
                           "moment2": np.zeros(t.shape, np.float32)},
                params)}
    state = opt.state_from_numpy(good, params)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 3
    assert torch.equal(state["slots"]["layers"][1]["qkv_w"]["moment1"],
                       torch.ones(64, 192))

    def bad(mutate, match):
        tree = jax.tree.map(lambda a: a, good)
        mutate(tree)
        with pytest.raises(EnforceNotMet, match=match):
            opt.state_from_numpy(tree, params)

    bad(lambda t: t.__setitem__("step", np.asarray(3, np.int64)), "step")
    bad(lambda t: t.__setitem__("step", np.zeros(1, np.int32)), "step")
    bad(lambda t: t.pop("step"), "keys")
    bad(lambda t: t["slots"]["mlm"].pop("bias"), "at mlm")
    bad(lambda t: t["slots"]["layers"].pop(), "list of 2")
    bad(lambda t: t["slots"]["embed"]["word"].pop("moment2"),
        "slots.embed.word must be a dict")
    bad(lambda t: t["slots"]["embed"]["pos"].__setitem__(
        "moment1", np.zeros((3, 3), np.float32)), "slots.embed.pos.moment1")
    bad(lambda t: t["slots"]["mlm"]["bias"].__setitem__(
        "moment2", np.zeros(512, np.float64)), "slots.mlm.bias.moment2")


def test_optimizer_refuses_what_is_not_ported():
    for kw in ({"learning_rate": lambda step: 0.1},
               {"regularization": object()}, {"grad_clip": object()}):
        with pytest.raises(EnforceNotMet, match="ROADMAP"):
            topt.Adam(**kw)
        for cls in (topt.SGD, topt.Momentum):
            with pytest.raises(EnforceNotMet, match="ROADMAP"):
                cls(**{"learning_rate": 0.1, **kw})
    # outside a Program, minimize() is refused
    with pytest.raises(EnforceNotMet, match="static-graph"):
        topt.Adam().minimize(None)
