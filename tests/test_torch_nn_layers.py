"""The 22 Layer classes of ``nn/layers.py`` in the port against the JAX
package, on the CPU, with ``grad``, ``no_grad`` and
``WeightNormParamAttr``.

Each class is built in both packages on the same numpy-seeded inputs: the
two ``init``s give the same parameter keys and shapes (the JAX one traced
by ``jax.eval_shape``); the port's initial values, moved by seeded noise,
in both packages give outputs within 1e-5
and ``grad``s (of the outputs' product with a seeded cotangent, with
respect to the parameters and the float inputs) within 1e-5, both of the
largest magnitude (at least 1). BatchNorm and SpectralNorm hold their state
too; NCE holds its loss on the same negatives (the JAX layer's draw is
replaced by them); Dropout holds its rate by its draws (torch's, not
threefry's) and its inference output exactly. ``no_grad`` gives exact-zero
gradients to a layer used only inside it, in both forms.
``WeightNormParamAttr`` is held in the module context and in a Program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import nn as jnn
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import layers as tlayers

TOL = 1e-5


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d)."""
    with static_mode_guard(False):
        yield


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _a(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL, what=""):
    got, want = _a(got), _a(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def _ids(seed, hi, *shape):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(np.int64)


def _tree(arrays):
    return tnn.params_from_numpy(jax.tree.map(np.asarray, arrays),
                                 device="cpu")


#: name -> (ctor args, kwargs, inputs, indices of the float inputs that are
#: differentiated, kwargs of the call)
CASES = {
    "Linear": ((4, 3), dict(act="relu"), lambda: [_np(0, 2, 4)], (0,), {}),
    "FC": ((3,), dict(num_flatten_dims=2, act="tanh"),
           lambda: [_np(1, 2, 3, 4)], (0,), {}),
    "Conv2D": ((3, 4, 3), dict(padding=1, act="relu"),
               lambda: [_np(2, 2, 3, 6, 6)], (0,), {}),
    "Conv2D_groups": ((4, 4, 3), dict(stride=2, groups=2),
                      lambda: [_np(3, 2, 4, 7, 7)], (0,), {}),
    "Conv2DTranspose": ((3, 4, 3), dict(stride=2, padding=1),
                        lambda: [_np(4, 2, 3, 5, 5)], (0,), {}),
    "Conv3D": ((2, 3, 2), dict(act="sigmoid"),
               lambda: [_np(5, 1, 2, 4, 4, 4)], (0,), {}),
    "Conv3DTranspose": ((2, 3, 2), dict(stride=2),
                        lambda: [_np(6, 1, 2, 3, 3, 3)], (0,), {}),
    "Pool2D": ((), dict(pool_size=2, pool_type="avg", pool_stride=2),
               lambda: [_np(7, 2, 3, 6, 6)], (0,), {}),
    "Pool2D_max": ((), dict(pool_size=3, pool_type="max", pool_stride=2,
                            pool_padding=1),
                   lambda: [_np(8, 2, 3, 7, 7)], (0,), {}),
    "BatchNorm": ((3,), dict(act="relu"), lambda: [_np(9, 4, 3, 5, 5)],
                  (0,), {}),
    "BatchNorm_test": ((3,), dict(), lambda: [_np(10, 4, 3, 5, 5)], (0,),
                       dict(is_test=True)),
    "LayerNorm": ((4,), dict(act="tanh"), lambda: [_np(11, 2, 3, 4)], (0,),
                  {}),
    "GroupNorm": ((4, 2), dict(), lambda: [_np(12, 2, 4, 3, 3)], (0,), {}),
    "InstanceNorm": ((3,), dict(), lambda: [_np(13, 2, 3, 4, 4)], (0,), {}),
    "Embedding": (((10, 4),), dict(padding_idx=0),
                  lambda: [_ids(14, 10, 2, 5)], (), {}),
    "PRelu": ((), dict(mode="channel", channel=3),
              lambda: [_np(15, 2, 3, 4, 4)], (0,), {}),
    "PRelu_all": ((), dict(mode="all"), lambda: [_np(16, 2, 3, 4)], (0,),
                  {}),
    "PRelu_element": ((), dict(mode="element"), lambda: [_np(17, 2, 3, 4)],
                      (0,), {}),
    "GRUUnit": ((12,), dict(), lambda: [_np(18, 2, 12), _np(19, 2, 4)],
                (0, 1), {}),
    "GRUUnit_origin": ((12,), dict(origin_mode=True, bias_attr=False),
                       lambda: [_np(20, 2, 12), _np(21, 2, 4)], (0, 1), {}),
    "LSTMCell": ((4, 3), dict(), lambda: [_np(22, 2, 3), _np(23, 2, 4),
                                          _np(24, 2, 4)], (0, 1, 2), {}),
    "GRUCell": ((4, 3), dict(), lambda: [_np(25, 2, 3), _np(26, 2, 4)],
                (0, 1), {}),
    "SpectralNorm": (((4, 6),), dict(power_iters=2),
                     lambda: [_np(27, 4, 6)], (0,), {}),
    "SpectralNorm_dim1": (((3, 4, 2),), dict(dim=1),
                          lambda: [_np(28, 3, 4, 2)], (0,), {}),
    "BilinearTensorProduct": ((3, 4, 2), dict(act="sigmoid"),
                              lambda: [_np(29, 2, 3), _np(30, 2, 4)],
                              (0, 1), {}),
    "RowConv": ((4, 2), dict(), lambda: [_np(31, 2, 5, 4)], (0,), {}),
    "TreeConv": ((4, 3), dict(num_filters=2, max_depth=2),
                 lambda: [_np(32, 2, 5, 4),
                          (np.random.RandomState(33).rand(2, 5, 5) > 0.6)
                          .astype(np.float32)], (0,), {}),
}


def _layer(pkg, name, args, kw):
    return getattr(pkg, name.split("_")[0])(*args, **kw)


def _run_case(name):
    args, kw, make, diff, call_kw = CASES[name]
    inputs = make()
    jl = _layer(jpt.nn.layers, name, args, kw)
    tl = _layer(tlayers, name, args, kw)
    jin = [jnp.asarray(x) for x in inputs]
    tin = [torch.as_tensor(x) for x in inputs]
    jshapes = jax.eval_shape(lambda k: jl.init(k, *jin, **call_kw),
                             jax.random.PRNGKey(0))
    tp, ts = tl.init(torch.Generator().manual_seed(0), *tin, **call_kw)
    for t, j in zip((tp, ts), jshapes):
        assert {k: tuple(v.shape) for k, v in t.items()} == \
            {k: tuple(v.shape) for k, v in j.items()}, name
    # the port's initial values, moved off their draws a little, in both
    tp = {k: v + 0.05 * torch.as_tensor(_np(200 + i, *v.shape))
          for i, (k, v) in enumerate(sorted(tp.items()))}
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    js = {k: jnp.asarray(v.numpy()) for k, v in ts.items()}
    shapes = jax.eval_shape(lambda p: jl.apply(p, js, None, *jin,
                                               **call_kw)[0], jp)
    shapes = shapes if isinstance(shapes, tuple) else (shapes,)
    cots = [_np(100 + i, *o.shape) for i, o in enumerate(shapes)]

    def jloss(p, *xs):
        full = list(jin)
        for i, x in zip(diff, xs):
            full[i] = x
        out, st = jl.apply(p, js, None, *full, **call_kw)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (outs, st)

    def tloss(p, *xs):
        full = list(tin)
        for i, x in zip(diff, xs):
            full[i] = x
        out, st = tl.apply(p, ts, None, *full, **call_kw)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(torch.sum(o * torch.as_tensor(c))
                   for o, c in zip(outs, cots)), (outs, st)

    nums = tuple(range(1 + len(diff)))
    jg, (jo, jst) = jax.jit(jax.grad(jloss, argnums=nums, has_aux=True))(
        jp, *[jin[i] for i in diff])
    tg, (to, tst) = tpt.grad(tloss, argnums=nums, has_aux=True)(
        tp, *[tin[i] for i in diff])
    for i, (t, j) in enumerate(zip(to, jo)):
        _close(t, j, what=f"{name} output {i}")
    assert set(tst) == set(jst)
    for k in jst:
        _close(tst[k], jst[k], what=f"{name} state {k}")
    assert set(tg[0]) == set(jg[0])
    for k in jg[0]:
        _close(tg[0][k], jg[0][k], what=f"{name} grad {k}")
    for i, (t, j) in enumerate(zip(tg[1:], jg[1:])):
        _close(t, j, what=f"{name} input grad {i}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name):
    _run_case(name)


def test_every_class_is_covered_and_exported_as_in_jax():
    covered = {n.split("_")[0] for n in CASES} | {"NCE", "Dropout"}
    assert covered == set(tlayers.__all__)
    assert len(tlayers.__all__) == 22
    jax_nn = {n for n in dir(jnn) if n[:1].isupper()}
    port_nn = {n for n in dir(tnn) if n[:1].isupper()}
    assert jax_nn <= port_nn, jax_nn - port_nn
    for n in ("Conv3D", "Conv3DTranspose"):
        assert not hasattr(jnn, n) and not hasattr(tnn, n)
        assert hasattr(jpt.dygraph, n) and hasattr(tpt.dygraph, n)


def test_batch_norm_state_moves_and_test_mode_reads_it():
    """Training overwrites the running stats with momentum * old + (1 -
    momentum) * batch; ``is_test`` normalises by them and keeps them."""
    x = _np(40, 6, 3, 4, 4)
    jl, tl = jnn.BatchNorm(3, momentum=0.8), tnn.BatchNorm(3, momentum=0.8)
    jp, js = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tp, ts = _tree(jp), _tree(js)
    for step in range(3):
        xs = x * (step + 1) + step
        _, js = jl.apply(jp, js, None, jnp.asarray(xs))
        _, ts = tl.apply(tp, ts, None, torch.as_tensor(xs))
        for k in ("batch_norm/mean", "batch_norm/variance"):
            _close(ts[k], js[k], what=k)
    assert float(ts["batch_norm/mean"].abs().max()) > 0.1
    jo, js2 = jl.apply(jp, js, None, jnp.asarray(x), is_test=True)
    to, ts2 = tl.apply(tp, ts, None, torch.as_tensor(x), is_test=True)
    _close(to, jo)
    for k in js:
        assert torch.equal(ts2[k], ts[k])


def test_spectral_norm_state_is_detached_power_iteration():
    w = _np(41, 5, 3)
    jl, tl = jnn.SpectralNorm((5, 3), power_iters=1), \
        tnn.SpectralNorm((5, 3), power_iters=1)
    jp, js = jl.init(None, jnp.asarray(w))
    tp, ts = tl.init(torch.Generator(), torch.as_tensor(w))
    assert set(ts) == set(js) == {"spectral_norm/u", "spectral_norm/v"}
    tw = torch.as_tensor(w).requires_grad_()
    for _ in range(4):
        jo, js = jl.apply(jp, js, None, jnp.asarray(w))
        to, ts = tl.apply(tp, ts, None, tw)
        for k in js:
            _close(ts[k], js[k], what=k)
            assert not ts[k].requires_grad
    _close(to, jo)
    # after a few iterations sigma is the largest singular value
    sigma = np.linalg.svd(w, compute_uv=False)[0]
    _close(to.detach().numpy() * sigma, w, tol=1e-3)


def test_nce_loss_on_the_same_negatives(monkeypatch):
    """The JAX layer's negatives are replaced by a given array (its
    ``jax.random.randint`` draw), the port's are passed in: the loss and
    its gradients agree; the port's own draws lie in [0, n)."""
    n, dim, k = 20, 4, 5
    x, label = _np(42, 3, dim), _ids(43, n, 3, 1)
    neg = _ids(44, n, 3, k)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(
                            neg, jnp.int32))
    jl, tl = jnn.NCE(n, dim, num_neg_samples=k), \
        tnn.NCE(n, dim, num_neg_samples=k)
    jp, js = jax.jit(jl.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(label))
    tp, _ = tl.init(torch.Generator().manual_seed(0), torch.as_tensor(x),
                    torch.as_tensor(label))
    assert {k_: tuple(v.shape) for k_, v in tp.items()} == \
        {k_: tuple(v.shape) for k_, v in jp.items()}
    jp = {k_: v + 0.1 * _np(45 + i, *v.shape)
          for i, (k_, v) in enumerate(sorted(jp.items()))}
    tp = _tree(jp)
    def jloss(p):
        out = jl.apply(p, js, jax.random.PRNGKey(1), jnp.asarray(x),
                       jnp.asarray(label))[0]
        return jnp.sum(out), out

    def tloss(p):
        out = tl.apply(p, {}, None, torch.as_tensor(x),
                       torch.as_tensor(label), torch.as_tensor(neg))[0]
        return torch.sum(out), out

    jg, jo = jax.jit(jax.grad(jloss, has_aux=True))(jp)
    tg, to = tpt.grad(tloss, has_aux=True)(tp)
    _close(to, jo, what="nce loss")
    for k_ in jg:
        _close(tg[k_], jg[k_], what=k_)
    drawn, _ = tl.apply(tp, {}, torch.Generator().manual_seed(3),
                        torch.as_tensor(x), torch.as_tensor(label))
    assert drawn.shape == (3, 1) and torch.isfinite(drawn).all()
    negs = torch.randint(0, n, (3, k), generator=torch.Generator()
                         .manual_seed(3))
    _close(drawn, tlayers.nce_loss(torch.as_tensor(x),
                                   torch.as_tensor(label), tp["nce/w"],
                                   tp["nce/b"], negs, n))


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_rate_and_inference(impl):
    """Training draws torch's mask at rate p (held by its statistics: 40000
    draws, within 4 standard deviations); the kept values are x or x / (1 -
    p) by the implementation; inference equals the JAX layer exactly."""
    p = 0.3
    x = np.abs(_np(50, 200, 200)) + 1.0
    tl, jl = tnn.Dropout(p, impl), jnn.Dropout(p, impl)
    out, _ = tl.apply({}, {}, torch.Generator().manual_seed(0),
                      torch.as_tensor(x))
    out = out.numpy()
    dropped = float(np.mean(out == 0))
    assert abs(dropped - p) < 4 * np.sqrt(p * (1 - p) / x.size), dropped
    kept = out != 0
    keep_scale = 1.0 / (1 - p) if impl == "upscale_in_train" else 1.0
    np.testing.assert_allclose(out[kept], x[kept] * keep_scale, rtol=1e-6)
    jo, _ = jl.apply({}, {}, jax.random.PRNGKey(0), jnp.asarray(x),
                     is_test=True)
    to, _ = tl.apply({}, {}, None, torch.as_tensor(x), is_test=True)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    again, _ = tl.apply({}, {}, torch.Generator().manual_seed(0),
                        torch.as_tensor(x))
    np.testing.assert_array_equal(again.numpy(), out)


def _frozen_model(pkg, decorate):
    """Two Linear layers; the first under ``no_grad`` (context or
    decorator form), then raw math on its output, then the second."""
    a, b = pkg.nn.Linear(4, 3, act="tanh"), pkg.nn.Linear(3, 2)

    def inner(x):
        return a(x)

    if decorate:
        inner = pkg.no_grad(inner)

    def fn(x):
        if decorate:
            h = inner(x)
        else:
            with pkg.no_grad():
                h = a(x)
        return b(h * 2.0 + 1.0)
    return pkg.nn.transform(fn)


@pytest.mark.parametrize("decorate", [False, True])
def test_no_grad_gives_exact_zero_gradients(decorate):
    x = _np(60, 5, 4)
    jm, tm = _frozen_model(jpt, decorate), _frozen_model(tpt, decorate)
    jp, js = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    tp = _tree(jp)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(
        p, js, None, jnp.asarray(x))[0] ** 2)))(jp)
    tg = tpt.grad(lambda p: torch.sum(tm.apply(p, {}, None,
                                               torch.as_tensor(x))[0]
                                      ** 2))(tp)
    for k in jg:
        _close(tg[k], jg[k], what=k)
        if k.startswith("linear/"):
            assert not torch.any(tg[k]) and not np.any(np.asarray(jg[k]))
        else:
            assert torch.any(tg[k])
    assert not tpt.framework.in_no_grad()


def _wn_fn(pkg, dim):
    def fn(x):
        h = pkg.layers.fc(x, 3, param_attr=pkg.WeightNormParamAttr(dim=dim),
                          bias_attr="h_b", act="tanh")
        return pkg.layers.fc(
            h, 2, param_attr=pkg.WeightNormParamAttr(
                dim=None, name="out_w",
                initializer=pkg.initializer.Normal(0.0, 0.5)),
            bias_attr="out_b")
    return fn


@pytest.mark.parametrize("dim", [None, 0, 1])
def test_weight_norm_in_the_module_context(dim):
    """``g`` starts at the norm of ``v``, the keys are the JAX package's,
    and the output and gradients agree."""
    x = _np(70, 4, 5)
    jm, tm = jpt.nn.transform(_wn_fn(jpt, dim)), \
        tpt.nn.transform(_wn_fn(tpt, dim))
    jp, js = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    tp, _ = tm.init(torch.Generator().manual_seed(0), torch.as_tensor(x))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert {"fc_w_wn_v", "fc_w_wn_g", "out_w_v", "out_w_g"} <= set(tp)
    v = tp["fc_w_wn_v"]
    want = (v.norm().reshape(1) if dim is None
            else v.norm(dim=1 - dim))
    _close(tp["fc_w_wn_g"], want.detach())
    tp = _tree(jp)
    def jloss(p):
        out = jm.apply(p, js, None, jnp.asarray(x))[0]
        return jnp.sum(out), out

    def tloss(p):
        out = tm.apply(p, {}, None, torch.as_tensor(x))[0]
        return torch.sum(out), out

    jg, jo = jax.jit(jax.grad(jloss, has_aux=True))(jp)
    tg, to = tpt.grad(tloss, has_aux=True)(tp)
    _close(to, jo)
    for k in jg:
        _close(tg[k], jg[k], what=k)


def test_weight_norm_in_a_program():
    """The same layers in a Program: the startup op sets ``g`` to the norm
    of ``v``; from the JAX startup's weights the outputs agree."""
    x = _np(71, 4, 5)
    built = {}
    for name, pkg in (("t", tpt), ("j", jpt)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            with pkg.framework.unique_name.guard():
                xv = pkg.static.data("x", [-1, 5], "float32")
                out = _wn_fn(pkg, 1)(xv)
        built[name] = (main, startup, out)
    jmain, jstart, jout = built["j"]
    tmain, tstart, tout = built["t"]
    assert [op.type for op in tstart.global_block().ops] == \
        [op.type for op in jstart.global_block().ops]
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    jscope = jpt.static.Scope()
    jexe = jpt.static.Executor(jpt.CPUPlace())
    jexe.run(jstart, scope=jscope)
    names = sorted(n for n, v in jstart.global_block().vars.items()
                   if v.persistable)
    arrays = {n: np.array(jscope.find_var(n)) for n in names}
    np.testing.assert_allclose(arrays["fc_w_wn_g"],
                               np.linalg.norm(arrays["fc_w_wn_v"], axis=0),
                               rtol=1e-6)
    tscope = tpt.Scope()
    texe = tpt.Executor(tpt.CPUPlace())
    texe.run(tstart, scope=tscope)
    g = tscope.find_var("fc_w_wn_g")
    v = tscope.find_var("fc_w_wn_v")
    _close(g, torch.linalg.vector_norm(v, dim=0))
    tscope = tpt.Scope.from_numpy(arrays, "cpu", tstart)
    jo = jexe.run(jmain, feed={"x": x}, fetch_list=[jout], scope=jscope)[0]
    to = texe.run(tmain, feed={"x": x}, fetch_list=[tout], scope=tscope)[0]
    _close(to, jo)
