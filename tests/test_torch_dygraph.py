"""The port's ``dygraph`` namespace, eager checkpoints, ``parallel``'s
process environment, eager ``layers.batch_norm`` and ``grad`` against the
JAX package, on the CPU.

``guard``/``enabled`` around static mode; the seven ``LearningRateDecay``
classes against JAX over 50 steps, as an optimizer calls them (an fp32
step tensor) and on their own (``step()``), within 1e-6 relative;
``save/load_persistables`` and ``save/load_dygraph`` across the packages
in both directions, bit for bit; ``DataParallel`` at one rank (identity)
and its refusal at two; eager ``layers.batch_norm`` (outputs, running stats
and gradients within 1e-5); ``grad``'s ``argnums``, ``has_aux``, zeros for
an unused leaf and its refusal of a non-scalar result, as ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.enforce import EnforceNotMet

TOL = 1e-5


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d)."""
    with static_mode_guard(False):
        yield


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, what


def test_guard_and_enabled():
    assert tpt.dygraph.enabled() and tpt.in_dygraph_mode()
    with tpt.static.static_mode_guard(True):
        assert not tpt.dygraph.enabled()
        with tpt.dygraph.guard():
            assert tpt.dygraph.enabled()
        assert not tpt.dygraph.enabled()
    assert tpt.dygraph.enabled()
    assert tpt.dygraph.__all__ == jpt.dygraph.__all__
    for n in tpt.dygraph.__all__:
        assert hasattr(tpt.dygraph, n), n


DECAYS = {
    "NoamDecay": ((512, 8000), dict(learning_rate=2.0)),
    "PiecewiseDecay": (([10, 25], [0.1, 0.01, 0.001]), {}),
    "NaturalExpDecay": ((0.5, 10, 0.3), dict(staircase=True)),
    "ExponentialDecay": ((0.5, 7, 0.9), {}),
    "InverseTimeDecay": ((0.5, 5, 0.2), dict(staircase=True)),
    "PolynomialDecay": ((0.5, 30), dict(end_learning_rate=0.01, power=2.0,
                                        cycle=True)),
    "CosineDecay": ((0.5, 6, 9), {}),
}


@pytest.mark.parametrize("name", sorted(DECAYS))
def test_decay_classes_match_jax_over_50_steps(name):
    args, kw = DECAYS[name]
    t = getattr(tpt.dygraph, name)(*args, **kw)
    j = getattr(jpt.dygraph, name)(*args, **kw)
    assert isinstance(t, tpt.dygraph.LearningRateDecay)
    want = np.array([float(j(np.float32(s))) for s in range(1, 51)])
    got = np.array([float(t(torch.tensor(s, dtype=torch.int32)))
                    for s in range(1, 51)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert t.step_num == j.step_num
    own = [float(t())] + [float(t.step()) for _ in range(50)]
    jown = [float(j())] + [float(j.step()) for _ in range(50)]
    np.testing.assert_allclose(own, jown, rtol=1e-6)
    assert t.step_num == j.step_num


def test_decay_rate_stays_on_the_step_device_as_a_0d_fp32_tensor():
    """An optimizer calls the object with its step counter; the rate it
    reads is a 0-d fp32 tensor on that counter's device (the kernels read
    it from device memory)."""
    sched = tpt.dygraph.NoamDecay(16, 4)
    step = torch.zeros((), dtype=torch.int32)
    lr = sched(step.to(torch.float32))
    assert lr.dtype == torch.float32 and lr.shape == () and \
        lr.device == step.device
    p = {"w": torch.ones(3)}
    opt = tpt.optimizer.Adam(learning_rate=sched)
    st = opt.init(p)
    opt.apply_gradients(p, {"w": torch.ones(3)}, st)
    jp = {"w": jnp.ones(3)}
    jopt = jpt.optimizer.Adam(learning_rate=jpt.dygraph.NoamDecay(16, 4))
    jp, _ = jopt.apply_gradients(jp, {"w": jnp.ones(3)}, jopt.init(jp))
    _close(p["w"], jp["w"], tol=1e-7)


def _tree():
    return {"layer": {"w": _np(1, 3, 4), "b": _np(2, 4)},
            "stack": [_np(3, 2), np.arange(5, dtype=np.int32)],
            "pair": (_np(4, 1, 2), 7), "rate": 0.5}


def _eq(t, j):
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _eq(t[k], j[k])
    elif isinstance(j, (list, tuple)):
        assert type(t) is type(j) and len(t) == len(j)
        for a, b in zip(t, j):
            _eq(a, b)
    elif isinstance(j, (int, float)):
        assert t == j
    else:
        t = t.numpy() if isinstance(t, torch.Tensor) else t
        assert np.asarray(t).dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def test_dygraph_checkpoints_load_across_the_packages(tmp_path):
    tree = _tree()
    ttree = {"layer": {k: torch.as_tensor(v) for k, v in
                       tree["layer"].items()},
             "stack": [torch.as_tensor(v) for v in tree["stack"]],
             "pair": (torch.as_tensor(tree["pair"][0]), 7), "rate": 0.5}
    jtree = jax.tree.map(jnp.asarray, tree)
    tpt.io.save_dygraph(ttree, str(tmp_path / "t"))
    jpt.io.save_dygraph(jtree, str(tmp_path / "j"))
    jt, opt = jpt.io.load_dygraph(str(tmp_path / "t"))
    assert opt is None
    _eq(jax.tree.map(np.asarray, jt), tree)
    tj, opt = tpt.io.load_dygraph(str(tmp_path / "j"), device="cpu")
    assert opt is None
    _eq(tj, tree)
    tpt.io.save_pytree(ttree, str(tmp_path / "p.npz"))
    _eq(jax.tree.map(np.asarray, jpt.io.load_pytree(str(tmp_path /
                                                        "p.npz"))), tree)
    _eq(tpt.io.load_pytree(str(tmp_path / "p.npz"), device="cpu"), tree)
    # persistables: the model and optimizer trees, both directions
    opt_state = {"step": np.int32(3), "slots": {"w": _np(5, 3, 4)}}
    tpt.dygraph.save_persistables(
        ttree["layer"], str(tmp_path / "tp"),
        optimizers={"step": torch.tensor(3, dtype=torch.int32),
                    "slots": {"w": torch.as_tensor(opt_state["slots"]["w"])}})
    jpt.dygraph.save_persistables(jax.tree.map(jnp.asarray, tree["layer"]),
                                  str(tmp_path / "jp"))
    jparams, jopt = jpt.dygraph.load_persistables(str(tmp_path / "tp"))
    _eq(jax.tree.map(np.asarray, jparams), tree["layer"])
    _eq(jax.tree.map(np.asarray, jopt), opt_state)
    tparams, topt = tpt.dygraph.load_persistables(str(tmp_path / "jp"),
                                                  device="cpu")
    _eq(tparams, tree["layer"])
    assert topt is None
    # the files hold no pickle: every member loads with allow_pickle=False
    with np.load(str(tmp_path / "t.pdparams"), allow_pickle=False) as blob:
        assert all(blob[k].dtype != object for k in blob.files)


def test_data_parallel_at_one_rank_and_refusal_at_two(monkeypatch):
    for v in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM"):
        monkeypatch.delenv(v, raising=False)
    env = tpt.parallel.ParallelEnv()
    assert (env.local_rank, env.nranks, env.dev_id) == (0, 1, 0)
    assert tpt.parallel.get_rank() == 0 and tpt.parallel.get_world_size() == 1
    lin = tpt.nn.Linear(3, 2)
    dp = tpt.dygraph.DataParallel(lin)
    x = torch.as_tensor(_np(6, 4, 3))
    p, s = dp.init(torch.Generator().manual_seed(0), x)
    out, _ = dp.apply(p, s, None, x)
    ref, _ = lin.apply(p, s, None, x)
    assert torch.equal(out, ref)
    loss = out.sum()
    assert dp.scale_loss(loss) is loss
    g = {"w": torch.ones(2)}
    assert dp.apply_collective_grads(g) is g
    st = tpt.dygraph.prepare_context()
    assert isinstance(st, tpt.parallel.ParallelStrategy) and st.nranks == 1
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    assert (tpt.parallel.get_rank(), tpt.parallel.get_world_size()) == \
        (jpt.parallel.get_rank(), jpt.parallel.get_world_size()) == (1, 2)
    dp2 = tpt.dygraph.DataParallel(lin)
    with pytest.raises(EnforceNotMet, match="queue 1 item 9"):
        dp2.scale_loss(loss)
    with pytest.raises(EnforceNotMet, match="queue 1 item 9"):
        dp2.apply_collective_grads(g)
    assert tpt.parallel.init_parallel_env().nranks == 2


def test_init_parallel_env_starts_a_one_rank_group(monkeypatch):
    """With an address, ``init_parallel_env`` initialises the
    ``torch.distributed`` group (gloo without a card), and the environment
    reads its rank and size from it."""
    import socket
    for v in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM"):
        monkeypatch.delenv(v, raising=False)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = tpt.parallel.init_parallel_env(f"localhost:{port}", 1, 0)
    try:
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
        assert (env.local_rank, env.nranks) == (0, 1)
    finally:
        torch.distributed.destroy_process_group()


def _bn_fn(pkg, is_test):
    def fn(x):
        h = pkg.layers.conv2d(x, 4, 3, padding=1, param_attr="c_w",
                              bias_attr="c_b")
        return pkg.layers.batch_norm(h, act="relu", is_test=is_test,
                                     momentum=0.7)
    return pkg.nn.transform(fn)


@pytest.mark.parametrize("is_test", [False, True])
def test_eager_batch_norm_matches_jax(is_test):
    x = _np(7, 3, 2, 5, 5)
    jm, tm = _bn_fn(jpt, is_test), _bn_fn(tpt, is_test)
    jp, js = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    tp, ts = tm.init(torch.Generator().manual_seed(0), torch.as_tensor(x))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert set(ts) == set(js) == {"bn_mean", "bn_variance"}
    tp = tpt.nn.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    js = {"bn_mean": js["bn_mean"] + 0.1, "bn_variance": js["bn_variance"]
          * 1.5}
    ts = tpt.nn.params_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    cot = _np(8, 3, 4, 5, 5)

    def jloss(p):
        out, st = jm.apply(p, js, None, jnp.asarray(x))
        return jnp.sum(out * cot), (out, st)

    def tloss(p):
        out, st = tm.apply(p, ts, None, torch.as_tensor(x))
        return torch.sum(out * torch.as_tensor(cot)), (out, st)

    jg, (jo, jst) = jax.jit(jax.grad(jloss, has_aux=True))(jp)
    tg, (to, tst) = tpt.grad(tloss, has_aux=True)(tp)
    _close(to, jo, what="out")
    for k in jst:
        _close(tst[k], jst[k], what=k)
    if is_test:
        for k in js:
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(js[k]))
    for k in jg:
        _close(tg[k], jg[k], what=k)


def test_grad_argnums_has_aux_and_unused_leaves():
    a, b, c = _np(9, 3), _np(10, 3), _np(11, 2)

    def jf(t, c):
        return jnp.sum(jnp.tanh(t["a"]) * t["b"][0]), t["a"] * 2

    def tf(t, c):
        return torch.sum(torch.tanh(t["a"]) * t["b"][0]), t["a"] * 2

    jt = {"a": jnp.asarray(a), "b": [jnp.asarray(b)], "u": jnp.asarray(c)}
    tt = {"a": torch.as_tensor(a), "b": [torch.as_tensor(b)],
          "u": torch.as_tensor(c)}
    (jg, jgc), jaux = jax.grad(jf, argnums=(0, 1), has_aux=True)(
        jt, jnp.asarray(c))
    (tg, tgc), taux = tpt.grad(tf, argnums=(0, 1), has_aux=True)(
        tt, torch.as_tensor(c))
    for k in ("a", "u"):
        _close(tg[k], jg[k], what=k)
    _close(tg["b"][0], jg["b"][0])
    assert isinstance(tg["b"], list)
    assert torch.equal(tg["u"], torch.zeros(2)) and torch.equal(
        tgc, torch.zeros(2))
    _close(taux, jaux)
    assert not taux.requires_grad
    # an int argnum gives the tree itself; the inputs are not touched
    g = tpt.grad(lambda t, c: tf(t, c)[0])(tt, torch.as_tensor(c))
    assert set(g) == {"a", "b", "u"} and not tt["a"].requires_grad
    # a loss that reaches no input: zeros everywhere, as jax.grad
    z = tpt.grad(lambda t: torch.tensor(1.0))(tt)
    assert all(not torch.any(v) for v in (z["a"], z["b"][0], z["u"]))
    with pytest.raises(TypeError, match="scalar-output"):
        tpt.grad(lambda t: t["a"] * 2)(tt)
    with pytest.raises(TypeError, match="scalar-output"):
        jax.grad(lambda t: t["a"] * 2)(jt)
    with pytest.raises(TypeError):
        tpt.grad(lambda n: n.sum())(torch.arange(3))


def test_grad_runs_the_kernel_functions_and_no_grad_is_not_torch_no_grad():
    """The embedding's autograd Function (an old-style ``forward(ctx,
    ...)``) takes part; math between layers under ``no_grad`` is still
    differentiated, as in the JAX package."""
    emb = tpt.nn.Embedding((6, 3))
    ids = torch.tensor([[1, 2], [2, 5]])
    p, s = emb.init(torch.Generator().manual_seed(0), ids)
    x = torch.as_tensor(_np(12, 2, 2, 3))

    def loss(p, x):
        with tpt.no_grad():
            y = x * 3.0
        out, _ = emb.apply(p, s, None, ids)
        return torch.sum(out * y)

    gp, gx = tpt.grad(loss, argnums=(0, 1))(p, x)
    want = torch.zeros(6, 3).index_add_(0, ids.reshape(-1),
                                        (x * 3.0).reshape(-1, 3))
    _close(gp["embedding/w"], want.numpy())
    assert torch.any(gx)
    assert torch.is_grad_enabled()
