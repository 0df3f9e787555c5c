"""The image models of the port (paddle_tpu_torch.models: resnet, vgg,
se_resnext) against the JAX package's, on the CPU.

The JAX package runs as its own tests run it (``JAX_PLATFORMS=cpu``, stock
bodies, a one-device mesh); its initial parameters cross over through
``params_from_numpy`` (HWIO conv weights become OIHW) and the same numpy
batch goes through both.

Tolerances (fp32 unless named). Forward: the port normalises with
``torch.native_batch_norm`` (Welford statistics), the JAX package with
E[x^2] - mean^2; convolutions sum in another order. Observed logits 1e-6
relative for resnet_cifar10(depth=8) and 1e-5 for VGG and SE-ResNeXt,
batch-norm statistics 4e-6 at most: logits held to 1e-4 relative to their
largest, stats to 1e-5. Training (three Momentum steps at lr 0.01):
losses 1e-4, parameters and velocities 1e-4 relative to each leaf's
largest value; bf16 activations round at other places in the two
frameworks: losses 0.03, as the card is held to the CPU for BERT. Two runs
of the port that compute the same ops (steps per call, stacked or reused
batches, ``remat="block"``) are held to each other exactly, or to 1e-6
where the recomputation may reorder a sum.

Why lr 0.01 and VGG at batch 2. A ReLU input within the two frameworks'
rounding (~1e-6) of zero may take the other branch in one of them, and
that one element's upstream gradient, spread over its channel by the
batch-norm backward, moves a whole leaf's gradient by several percent.
resnet_cifar10(depth=8) at lr 0.1 and batch 4 holds such an input after
its first step (``tools/relu_tie_check.py``: one gradient of stage 1's
conv2 is 0.00855 in JAX and -0.00308 in the port, whose fp64 gradient and
fp64 finite difference give -0.00308), and VGG-11 at batch 4 (~600 K
pre-activations) holds one at every seed tried (1-4); at lr 0.1 VGG's loss
also climbs (2.0, 7.0, 61.6), where any two implementations part. At lr
0.01, batch 4 (VGG 2), every case here passes with these tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import regularizer as jreg
from paddle_tpu.models import resnet as jres
from paddle_tpu.models import se_resnext as jse
from paddle_tpu.models import vgg as jvgg
from paddle_tpu.parallel.mesh import MeshConfig, make_mesh, mesh_guard

import paddle_tpu_torch
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.tree import leaves, map_tree
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.models import se_resnext as tse
from paddle_tpu_torch.models import vgg as tvgg

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# name -> (JAX module, port module, config kwargs)
MODELS = {
    "resnet_cifar8": (jres, tres, "resnet_cifar10",
                      dict(depth=8, image_size=16)),
    "vgg11": (jvgg, tvgg, "vgg11",
              dict(num_classes=10, image_size=32, fc_dim=64, dropout=0.0)),
    "vgg11_48": (jvgg, tvgg, "vgg11",
                 dict(num_classes=10, image_size=48, fc_dim=64,
                      dropout=0.0)),
    "se_resnext_tiny": (jse, tse, "se_resnext_tiny", {}),
}
BATCH = 4
LR = 0.01
# VGG-11 at batch 4 has ~600 K pre-activations; see the module docstring
TRAIN_BATCH = {"vgg11": 2}


def _cfgs(name, dtype="float32", **extra):
    jm, tm, ctor, kw = MODELS[name]
    jd, td = _DT[dtype]
    return (getattr(jm, ctor)(dtype=jd, **kw, **extra),
            getattr(tm, ctor)(dtype=td, **kw, **extra))


def _jflat(tree):
    """{dotted path: numpy} of a JAX tree, in the port's path spelling."""
    return {".".join(str(getattr(e, "key", getattr(e, "idx", None)))
                     for e in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    """{dotted path: numpy} of a port tree, OIHW conv weights as HWIO."""
    out = {}

    def put(path, t):
        a = t.detach().float().cpu().numpy()
        out[path] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    map_tree(put, tree)
    return out


def _mesh():
    return mesh_guard(make_mesh(MeshConfig(data=1, model=1, seq=1, pipe=1)))


def _start(name, jcfg, tcfg, seed=0):
    jm, tm = MODELS[name][:2]
    jp = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    p0 = jax.tree.map(lambda a: np.array(a), jp)
    return jp, p0, tm.params_from_numpy(p0, tcfg, device="cpu")


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(name, train):
    jm, tm = MODELS[name][:2]
    jcfg, tcfg = _cfgs(name)
    jp, _, tp = _start(name, jcfg, tcfg)
    images, _ = jm.synthetic_batch(jcfg, BATCH, seed=1)
    jl, jnew = jm.forward(jp, jcfg, jnp.asarray(images), train=train)
    tl, tnew = tm.forward(tp, tcfg, images, train=train)
    assert tl.dtype == torch.float32 and tl.shape == (BATCH, 10)
    assert _rel(tl.detach().numpy(), np.asarray(jl)) < 1e-4
    if not train:
        assert tnew is tp
        return
    want, got = _jflat(jnew), _tflat(tnew)
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith(("mean", "var")):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bf16_forward_matches_jax():
    jcfg, tcfg = _cfgs("resnet_cifar8", "bfloat16")
    jp, _, tp = _start("resnet_cifar8", jcfg, tcfg)
    images, _ = jres.synthetic_batch(jcfg, BATCH, seed=1)
    jl, _ = jres.forward(jp, jcfg, jnp.asarray(images))
    tl, _ = tres.forward(tp, tcfg, images)
    # observed 2.6e-3 of the largest logit
    assert _rel(tl.detach().numpy(), np.asarray(jl)) < 0.02


# the bottleneck ResNet (7x7/2 stem, SAME max-pool, bottleneck blocks) at a
# small width; bounds relative to the largest fp64 logit, each side held to
# the port's own fp64 run. Observed (train; eval): port 3.9e-5; 8.9e-7 from
# fp64, JAX 6.7e-4; 1.8e-6 from it: the JAX training batch norm takes var =
# E[x^2] - mean^2 (ROADMAP queue 3 note g), which loses fp32 digits at this
# depth, where the port's Welford statistics do not. So |port - JAX| is
# bounded by the two distances to fp64, each held about 3x above what it
# reads, and not by a bare 1e-4
RESNET50_FP64_TOL = {True: (1e-4, 2e-3), False: (1e-5, 1e-5)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_resnet50_forward_matches_jax_and_fp64(train):
    kw = dict(num_classes=10, image_size=64, width=16)
    jcfg = jres.resnet50(dtype=jnp.float32, **kw)
    tcfg = tres.resnet50(dtype=torch.float32, **kw)
    jp = jres.init_params(jax.random.PRNGKey(0), jcfg)
    p0 = jax.tree.map(lambda a: np.array(a), jp)
    tp = tres.params_from_numpy(p0, tcfg, device="cpu")
    images, _ = jres.synthetic_batch(jcfg, 8, seed=1)
    jl, _ = jres.forward(jp, jcfg, jnp.asarray(images), train=train)
    tl, _ = tres.forward(tp, tcfg, images, train=train)
    # the port in fp64 up to the pooled features; the head stays fp32, as
    # the model casts its pooled features to fp32 (one product, ~1e-7)
    p64 = map_tree(lambda path, t: t if path.startswith("head")
                   else t.double(), tp)
    ref, _ = tres.forward(p64, dataclasses.replace(tcfg, dtype=torch.float64),
                          images.astype(np.float64), train=train)
    ref = ref.detach().numpy()
    jl, tl = np.asarray(jl), tl.detach().numpy()

    def err(a, b):
        return float(np.abs(a - b).max() / np.abs(ref).max())

    port_tol, jax_tol = RESNET50_FP64_TOL[train]
    assert err(tl, ref) < port_tol
    assert err(jl, ref) < jax_tol
    assert err(tl, jl) < port_tol + jax_tol


def test_eval_mode_uses_running_stats():
    _, tcfg = _cfgs("resnet_cifar8")
    params = tres.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    images, _ = tres.synthetic_batch(tcfg, BATCH, seed=2)
    a, _ = tres.forward(params, tcfg, images, train=False)
    with torch.no_grad():
        params["stem"]["bn"]["mean"].add_(0.5)
    b, _ = tres.forward(params, tcfg, images, train=False)
    c, _ = tres.forward(params, tcfg, images, train=True)
    d, _ = tres.forward(tres.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"), tcfg, images,
        train=True)
    assert not torch.allclose(a, b)
    torch.testing.assert_close(c, d, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _jax_train(name, jcfg, images, labels, steps, opt):
    jm = MODELS[name][0]
    with _mesh():
        init_fn, step_fn = jm.make_train_step(jcfg, opt)
        params, state = init_fn(jax.random.PRNGKey(0))
        p0 = jax.tree.map(lambda a: np.array(a), params)
        s0 = jax.tree.map(lambda a: np.array(a), state)
        losses = []
        for _ in range(steps):
            loss, _, params, state = step_fn(params, state,
                                             jnp.asarray(images),
                                             jnp.asarray(labels))
            losses.append(float(loss))
        return p0, s0, losses, _jflat(params), _jflat(state["slots"])


def _state_from_jax(s0, params):
    """The JAX Momentum state as the port's (HWIO velocities of the conv
    weights as OIHW)."""
    def slot(path, p, s):
        v = s["velocity"]
        v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
        return {"velocity": torch.tensor(np.ascontiguousarray(v))}
    return {"step": torch.tensor(s0["step"]),
            "slots": map_tree(slot, params, s0["slots"])}


@pytest.mark.parametrize("name,dtype", [
    ("resnet_cifar8", "float32"), ("vgg11", "float32"),
    ("se_resnext_tiny", "float32"), ("resnet_cifar8", "bfloat16")])
def test_momentum_steps_match_jax(name, dtype):
    jm, tm = MODELS[name][:2]
    jcfg, tcfg = _cfgs(name, dtype)
    images, labels = jm.synthetic_batch(jcfg, TRAIN_BATCH.get(name, BATCH),
                                        seed=1)
    p0, s0, losses_j, pj, vj = _jax_train(
        name, jcfg, images, labels, 3,
        jpt.optimizer.Momentum(learning_rate=LR, momentum=0.9))
    opt = topt.Momentum(learning_rate=LR, momentum=0.9)
    params = tm.params_from_numpy(p0, tcfg, device="cpu")
    state = _state_from_jax(s0, params)
    _, step_fn = tm.make_train_step(tcfg, opt, device="cpu")
    losses_t = []
    for _ in range(3):
        loss, acc, params, state = step_fn(params, state, images, labels)
        losses_t.append(float(loss))
        assert 0.0 <= float(acc) <= 1.0
    assert int(state["step"]) == 3
    if dtype == "bfloat16":
        np.testing.assert_allclose(losses_t, losses_j, atol=0.03, rtol=0)
        return
    np.testing.assert_allclose(losses_t, losses_j, atol=1e-4, rtol=0)
    _assert_trees(params, state, pj, vj)


def _assert_trees(params, state, pj, vj):
    """Params and velocities within 1e-4 of each leaf's largest value (a
    leaf of zeros, a stat's velocity without decay, exactly)."""
    got, gotv = _tflat(params), _tflat(state["slots"])
    assert got.keys() == pj.keys() and gotv.keys() == vj.keys()
    for want, have in ((pj, got), (vj, gotv)):
        for k in want:
            if np.abs(want[k]).max() == 0:
                np.testing.assert_array_equal(have[k], want[k], err_msg=k)
            else:
                assert _rel(have[k], want[k]) < 1e-4, k


@pytest.mark.parametrize("stacked", [False, True], ids=["reused", "stacked"])
@pytest.mark.parametrize("name", ["resnet_cifar8", "vgg11"])
def test_steps_per_call_equals_single_steps(name, stacked):
    tm = MODELS[name][1]
    _, tcfg = _cfgs(name)
    images, labels = tm.synthetic_batch(tcfg, BATCH, seed=1)
    if stacked:
        im2, lb2 = tm.synthetic_batch(tcfg, BATCH, seed=2)
        batches = [(images, labels), (im2, lb2)]
        call = (np.stack([images, im2]), np.stack([labels, lb2]))
    else:
        batches = [(images, labels)] * 2
        call = (images, labels)
    runs = []
    for spc in (1, 2):
        opt = topt.Momentum(learning_rate=0.1, momentum=0.9)
        init_fn, step_fn = tm.make_train_step(tcfg, opt, steps_per_call=spc,
                                              device="cpu")
        params, state = init_fn(torch.Generator().manual_seed(0))
        if spc == 1:
            for im, lb in batches:
                loss, acc, params, state = step_fn(params, state, im, lb)
        else:
            loss, acc, params, state = step_fn(params, state, *call)
        runs.append((loss, acc, params, state))
    (l1, a1, p1, s1), (l2, a2, p2, s2) = runs
    assert int(s1["step"]) == int(s2["step"]) == 2
    torch.testing.assert_close(l1, l2, rtol=0, atol=0)
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    for a, b in zip(leaves(p1) + leaves(s1), leaves(p2) + leaves(s2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_stacked_batch_must_match_steps_per_call():
    _, tcfg = _cfgs("resnet_cifar8")
    init_fn, step_fn = tres.make_train_step(
        tcfg, topt.Momentum(0.1), steps_per_call=2, device="cpu")
    params, state = init_fn(torch.Generator().manual_seed(0))
    images, labels = tres.synthetic_batch(tcfg, BATCH)
    with pytest.raises(ValueError, match="steps_per_call 2"):
        step_fn(params, state, np.stack([images] * 3),
                np.stack([labels] * 3))


def test_remat_block_equals_none():
    losses, finals = [], []
    for remat in ("none", "block"):
        _, tcfg = _cfgs("resnet_cifar8", remat=remat)
        init_fn, step_fn = tres.make_train_step(
            tcfg, topt.Momentum(learning_rate=0.1, momentum=0.9),
            device="cpu")
        params, state = init_fn(torch.Generator().manual_seed(0))
        images, labels = tres.synthetic_batch(tcfg, BATCH, seed=1)
        ls = []
        for _ in range(2):
            loss, _, params, state = step_fn(params, state, images, labels)
            ls.append(float(loss))
        losses.append(ls)
        finals.append(leaves(params))
    np.testing.assert_allclose(losses[0], losses[1], rtol=0, atol=1e-6)
    for a, b in zip(*finals):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_remat_must_be_known():
    with pytest.raises(ValueError, match="remat"):
        tres.resnet50(remat="all")


# ---------------------------------------------------------------------------
# sizes
# ---------------------------------------------------------------------------
def test_resnet50_parameter_count_equals_jax():
    shapes = jax.eval_shape(lambda k: jres.init_params(k, jres.resnet50()),
                            jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in _jflat_shapes(shapes).items()}
    got = {}
    map_tree(lambda path, s: got.__setitem__(
        path, (s[2], s[3], s[1], s[0]) if len(s) == 4 else s),
        tres.param_shapes(tres.resnet50()), path="")
    assert got == want
    assert len(got) == 267
    assert sum(int(np.prod(s)) for s in got.values()) == 25_610_152


def _jflat_shapes(tree):
    return {".".join(str(getattr(e, "key", getattr(e, "idx", None)))
                     for e in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("ctor,kw", [
    ("resnet50", {}), ("resnet18", {}), ("resnet101", {}),
    ("resnet_cifar10", {"depth": 20}),
    ("resnet_cifar10", {"depth": 8, "image_size": 16}),
    ("resnet50", {"image_size": 160, "width": 32})])
def test_flops_per_image_equals_jax(ctor, kw):
    want = jres.flops_per_image(getattr(jres, ctor)(**kw))
    assert tres.flops_per_image(getattr(tres, ctor)(**kw)) == want
    if (ctor, kw) == ("resnet50", {}):
        assert round(want / 1e9, 2) == 23.15


def test_vgg_and_se_resnext_shapes_equal_jax():
    for jm, tm, jcfg, tcfg in (
            (jvgg, tvgg, jvgg.vgg16(), tvgg.vgg16()),
            (jvgg, tvgg, jvgg.vgg11(image_size=48), tvgg.vgg11(image_size=48)),
            (jse, tse, jse.se_resnext50(), tse.se_resnext50())):
        shapes = jax.eval_shape(lambda k: jm.init_params(k, jcfg),
                                jax.random.PRNGKey(0))
        want = {k: v.shape for k, v in _jflat_shapes(shapes).items()}
        got = {}
        map_tree(lambda path, s: got.__setitem__(
            path, (s[2], s[3], s[1], s[0]) if len(s) == 4 else s),
            tm.param_shapes(tcfg))
        assert got == want
    # the grouped 3x3 conv: OIHW [gw, gw / cardinality, 3, 3]
    cfg = tse.se_resnext50()
    blk = tse.param_shapes(cfg)["stages"][0][0]
    gw = cfg.cardinality * cfg.group_width
    assert blk["conv2"] == (gw, gw // cfg.cardinality, 3, 3)


# ---------------------------------------------------------------------------
# SAME padding: the odd pixel goes after
# ---------------------------------------------------------------------------
def test_same_padding_puts_the_odd_pixel_after():
    assert tres._same_pad(224, 7, 2) == (2, 3)        # the stem
    assert tres._same_pad(56, 3, 2) == (0, 1)         # a strided 3x3
    assert tres._same_pad(112, 3, 2) == (0, 1)        # the max-pool
    assert tres._same_pad(7, 3, 2) == (1, 1)
    assert tres._same_pad(56, 1, 2) == (0, 0)
    assert tres._same_pad(56, 3, 1) == (1, 1)
    assert tres._same_pad(3, 2, 2) == (0, 1)          # VGG at 48, pool 5


@pytest.mark.parametrize("side,k,stride", [
    (16, 7, 2), (15, 7, 2), (16, 3, 2), (15, 3, 2), (9, 3, 1), (8, 1, 2)])
def test_conv_matches_xla_same(side, k, stride):
    rng = np.random.RandomState(side * 10 + k)
    x = rng.randn(2, side, side, 5).astype(np.float32)
    w = rng.randn(k, k, 5, 6).astype(np.float32)
    want = np.asarray(jres._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tres._conv(torch.tensor(x).permute(0, 3, 1, 2),
                     torch.tensor(w.transpose(3, 2, 0, 1).copy()), stride)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if k > 1 and (side - 1) % stride != (k - 1) % stride:
        # PyTorch's symmetric padding gives the same shape, other windows
        sym = torch.nn.functional.conv2d(
            torch.tensor(x).permute(0, 3, 1, 2),
            torch.tensor(w.transpose(3, 2, 0, 1).copy()), None, stride,
            k // 2).permute(0, 2, 3, 1).numpy()
        if sym.shape == want.shape:
            assert np.abs(sym - want).max() > 1e-2


@pytest.mark.parametrize("side,window,stride", [
    (112, 3, 2), (15, 3, 2), (16, 2, 2), (3, 2, 2), (7, 3, 1)])
def test_maxpool_matches_xla_same(side, window, stride):
    rng = np.random.RandomState(side)
    x = rng.randn(2, side, side, 4).astype(np.float32) - 3.0   # all < 0
    want = np.asarray(jres._maxpool(jnp.asarray(x), window, stride))
    got = tres._maxpool(torch.tensor(x).permute(0, 3, 1, 2), window,
                        stride).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_odd_padded_grouped_conv_matches_xla():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 15, 15, 8).astype(np.float32)
    w = rng.randn(3, 3, 2, 8).astype(np.float32)     # 4 groups
    want = np.asarray(jse._group_conv(jnp.asarray(x), jnp.asarray(w), 4, 2))
    got = tres._conv(torch.tensor(x).permute(0, 3, 1, 2),
                     torch.tensor(w.transpose(3, 2, 0, 1).copy()), 2,
                     groups=4).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# batch-norm statistics and the regularizer
# ---------------------------------------------------------------------------
def test_batch_norm_is_the_jax_one():
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 5, 5, 3) * 2 + 1).astype(np.float32)
    bn = {"g": rng.rand(3).astype(np.float32) + 0.5,
          "b": rng.randn(3).astype(np.float32),
          "mean": rng.randn(3).astype(np.float32),
          "var": rng.rand(3).astype(np.float32) + 0.5}
    for train in (True, False):
        yj, nj = jres._bn(jnp.asarray(x), jax.tree.map(jnp.asarray, bn),
                          train, 0.9, 1e-5)
        yt, nt = tres._bn(torch.tensor(x).permute(0, 3, 1, 2),
                          {k: torch.tensor(v) for k, v in bn.items()},
                          train, 0.9, 1e-5)
        np.testing.assert_allclose(yt.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(yj), rtol=1e-5, atol=1e-5)
        if train:
            # biased variance in the running update (torch's buffers keep
            # the unbiased one)
            for k in ("mean", "var"):
                np.testing.assert_allclose(nt[k].numpy(), np.asarray(nj[k]),
                                           rtol=1e-6, atol=1e-6)
        else:
            assert nt is None


def test_regularizer_never_touches_bn_stats():
    """L2 decay must not decay the running stats: they are copied over
    their leaves after the update (the JAX package's pin,
    tests/test_models_vision.py)."""
    cfg = tse.se_resnext_tiny(dtype=torch.float32)
    opt = topt.Momentum(learning_rate=0.1, momentum=0.9,
                        regularization=treg.L2Decay(0.1))
    init_fn, step_fn = tse.make_train_step(cfg, opt, device="cpu")
    imgs, labels = tse.synthetic_batch(cfg, 8, seed=1)
    params, state = init_fn(torch.Generator().manual_seed(0))
    p2 = tse.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, fwd_new = tse.forward(p2, cfg, imgs, train=True)
    _, _, new_params, _ = step_fn(params, state, imgs, labels)
    for k in ("mean", "var"):
        torch.testing.assert_close(new_params["stem"]["bn"][k],
                                   fwd_new["stem"]["bn"][k], rtol=0, atol=0)


def test_l2_decay_and_global_clip_see_the_stats_as_jax_does():
    """The stats are leaves of the grads tree (zeros), so L2 decay gives
    them coeff * stat, which enters the global norm and the velocities, as
    in the JAX package; the stats themselves end as the forward's."""
    from paddle_tpu import clip as jclip
    from paddle_tpu_torch import clip as tclip
    name = "se_resnext_tiny"
    jcfg, tcfg = _cfgs(name)
    images, labels = jse.synthetic_batch(jcfg, 8, seed=1)
    p0, s0, losses_j, pj, vj = _jax_train(
        name, jcfg, images, labels, 2, jpt.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, regularization=jreg.L2Decay(0.1),
            grad_clip=jclip.GradientClipByGlobalNorm(1.0)))
    opt = topt.Momentum(learning_rate=0.1, momentum=0.9,
                        regularization=treg.L2Decay(0.1),
                        grad_clip=tclip.GradientClipByGlobalNorm(1.0))
    params = tse.params_from_numpy(p0, tcfg, device="cpu")
    state = _state_from_jax(s0, params)
    _, step_fn = tse.make_train_step(tcfg, opt, device="cpu")
    losses_t = []
    for _ in range(2):
        loss, _, params, state = step_fn(params, state, images, labels)
        losses_t.append(float(loss))
    np.testing.assert_allclose(losses_t, losses_j, atol=1e-4, rtol=0)
    _assert_trees(params, state, pj, vj)
    # the stats' velocities carry the decay: nonzero, as JAX's
    assert state["slots"]["stem"]["bn"]["var"]["velocity"].abs().max() > 0


# ---------------------------------------------------------------------------
# VGG's dropout (its bits cannot be JAX's: held on its own)
# ---------------------------------------------------------------------------
def _vgg_dropout_cfg():
    return tvgg.vgg11(num_classes=10, image_size=32, fc_dim=256,
                      dtype=torch.float32, dropout=0.5)


def test_dropout_keeps_its_rate_and_scales_by_keep():
    x = torch.ones(200, 500)
    y = tvgg._dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))


def test_dropout_only_with_a_generator():
    cfg = _vgg_dropout_cfg()
    params = tvgg.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    images, _ = tvgg.synthetic_batch(cfg, 2, seed=1)
    a, _ = tvgg.forward(params, cfg, images)
    b, _ = tvgg.forward(params, cfg, images)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c, _ = tvgg.forward(params, cfg, images,
                        generator=torch.Generator().manual_seed(5))
    d, _ = tvgg.forward(params, cfg, images,
                        generator=torch.Generator().manual_seed(5))
    e, _ = tvgg.forward(params, cfg, images,
                        generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(c, d, rtol=0, atol=0)
    assert not torch.allclose(a, c) and not torch.allclose(c, e)
    f, _ = tvgg.forward(params, cfg, images, train=False,
                        generator=torch.Generator().manual_seed(5))
    g, _ = tvgg.forward(params, cfg, images, train=False)
    torch.testing.assert_close(f, g, rtol=0, atol=0)


def test_dropout_draws_fresh_each_inner_step():
    cfg = _vgg_dropout_cfg()
    images, labels = tvgg.synthetic_batch(cfg, 2, seed=1)

    def run(spc, gen):
        init_fn, step_fn = tvgg.make_train_step(
            cfg, topt.SGD(learning_rate=0.0), steps_per_call=spc,
            device="cpu")
        params, state = init_fn(torch.Generator().manual_seed(0))
        out = []
        for _ in range(2 // spc):
            loss, _, params, state = step_fn(params, state, images, labels,
                                             generator=gen)
            out.append(float(loss))
        return out

    # lr 0: the params never move, so each loss differs by its mask alone
    seq = run(1, torch.Generator().manual_seed(9))
    assert seq[0] != seq[1]
    # two inner steps of one call draw as two calls do
    assert run(2, torch.Generator().manual_seed(9)) == seq[1:]
    # the step's own generator advances too
    init_fn, step_fn = tvgg.make_train_step(cfg, topt.SGD(0.0),
                                            device="cpu")
    params, state = init_fn(torch.Generator().manual_seed(0))
    l1 = float(step_fn(params, state, images, labels)[0])
    l2 = float(step_fn(params, state, images, labels)[0])
    assert l1 != l2


# ---------------------------------------------------------------------------
# fp32 stays fp32; devices; strict weights
# ---------------------------------------------------------------------------
def test_fp32_models_turn_tf32_off_while_they_run(monkeypatch):
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return real(*a, **kw)

    monkeypatch.setattr(tres.F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    for dtype, want in (("float32", (False, False)),
                        ("bfloat16", (True, True))):
        _, tcfg = _cfgs("resnet_cifar8", dtype)
        params = tres.init_params(tcfg, torch.Generator().manual_seed(0),
                                  device="cpu")
        images, labels = tres.synthetic_batch(tcfg, 2)
        seen.clear()
        tres.forward(params, tcfg, images)
        assert seen and set(seen) == {want}
        # the backward of a train step too
        _, step_fn = tres.make_train_step(tcfg, topt.SGD(0.1), device="cpu")
        seen.clear()
        step_fn(params, topt.SGD(0.1).init(params), images, labels)
        assert seen and set(seen) == {want}
        # and set back after
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tm, cfg in ((tres, tres.resnet_cifar10(depth=8)),
                    (tvgg, tvgg.vgg11(num_classes=10, image_size=32)),
                    (tse, tse.se_resnext_tiny())):
        with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
            tm.init_params(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
            tm.params_from_numpy({}, cfg)
        with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
            tm.make_train_step(cfg, topt.Momentum(0.1))


def test_params_from_numpy_is_strict():
    jcfg, tcfg = _cfgs("resnet_cifar8")
    p0 = jax.tree.map(np.asarray, jres.init_params(jax.random.PRNGKey(0),
                                                   jcfg))

    def bad(edit, match):
        tree = jax.tree.map(np.copy, p0)
        edit(tree)
        with pytest.raises(EnforceNotMet, match=match):
            tres.params_from_numpy(tree, tcfg, device="cpu")

    bad(lambda t: t["stem"].pop("w"), "missing")
    bad(lambda t: t["stem"].__setitem__(
        "w", t["stem"]["w"].transpose(3, 2, 0, 1)), "stem.w")     # OIHW
    bad(lambda t: t["head"].__setitem__("b", np.zeros(10, np.float64)),
        "head.b")
    bad(lambda t: t["stages"].pop(), "stages")
