"""``core/random.py`` and ``ops/random_ops.py`` in the port against the JAX
package, on the CPU, eagerly and in a Program.

The draws are torch's, never the JAX package's threefry bits, so the ops
are held by what carries over: shape, dtype (the JAX dtype canonicalized:
with x64 off its int64 is int32), range, and the first two moments of
N = 200,000 draws within 5 standard errors of the analytic ones (the JAX
package's draws within the same bound, as a check of the bound); then the
seed and rng rules: an op seed that is not 0 gives the same draws on every
call, seed 0 advances the global counter and ``seed(s)`` restarts it, and a
given rng beats the seed. In a Program the five ops with a tensor input
are ops that draw (``_needs_rng`` in both packages' documents) and take
the Executor's generator; the four that take only a shape draw at once.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import ops as jops
from paddle_tpu.core import random as jrandom
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.ops import random_ops as trand

N = 200_000
#: the standard deviation of a standard normal truncated to [-2, 2]
TRUNC_STD = 0.8796256610342398


@pytest.fixture(autouse=True)
def _eager_mode():
    with static_mode_guard(False):
        yield


def _gen(s=0):
    return torch.Generator().manual_seed(s)


def _moments(v, mean, std, lo=None, hi=None):
    v = np.asarray(v, np.float64)
    if lo is not None:
        assert v.min() >= lo and v.max() <= hi, (v.min(), v.max())
    assert abs(v.mean() - mean) <= 5 * std / math.sqrt(v.size), v.mean()
    # the sample variance's standard error, 4th moment bounded by 3 std^4
    assert abs(v.var() - std ** 2) <= 5 * math.sqrt(2.0 / v.size) * \
        std ** 2 * 1.3, v.var()


def _jdtype(a):
    """The dtype as the JAX package (x64 off) has it: float64 and int64
    are float32 and int32 there; the port keeps them."""
    if isinstance(a, torch.Tensor):
        name = str(a.dtype).replace("torch.", "")
        return jax.dtypes.canonicalize_dtype(
            jnp.bfloat16 if name == "bfloat16" else np.dtype(name))
    return jax.dtypes.canonicalize_dtype(a.dtype)


def test_the_module_ports_every_name():
    assert trand.__all__ == jops.random_ops.__all__
    for n in trand.__all__:
        assert getattr(tops, n) is getattr(trand, n)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_gaussian_random(dtype):
    got = tops.gaussian_random((N,), mean=1.5, std=0.5, dtype=dtype,
                               rng=_gen(1))
    want = jops.gaussian_random((N,), 1.5, 0.5, dtype=dtype,
                                rng=jax.random.PRNGKey(1))
    assert _jdtype(got) == _jdtype(want) and got.shape == (N,)
    for v in (got.float().numpy(), np.asarray(want, np.float32)):
        _moments(v, 1.5, 0.5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_random(dtype):
    got = tops.uniform_random((400, 500), dtype, min=-3.0, max=5.0,
                              rng=_gen(2))
    want = jops.uniform_random((400, 500), dtype, -3.0, 5.0,
                               rng=jax.random.PRNGKey(2))
    assert _jdtype(got) == _jdtype(want) and got.shape == (400, 500)
    for v in (got.numpy(), np.asarray(want)):
        assert v.min() >= -3.0 and v.max() < 5.0
        _moments(v, 1.0, 8.0 / math.sqrt(12.0))


def test_truncated_gaussian_random():
    got = tops.truncated_gaussian_random((N,), mean=-1.0, std=2.0,
                                         rng=_gen(3))
    want = jops.truncated_gaussian_random((N,), -1.0, 2.0,
                                          rng=jax.random.PRNGKey(3))
    assert got.dtype == torch.float32
    for v in (got.numpy(), np.asarray(want)):
        _moments(v, -1.0, 2.0 * TRUNC_STD, lo=-5.0 - 1e-5, hi=3.0 + 1e-5)
    # the tails reach close to the bounds
    assert got.min() < -4.9 and got.max() > 2.9


def test_batch_size_like_takes_the_input_dim():
    x = torch.zeros(7, 3)
    got = tops.uniform_random_batch_size_like(x, [2, 4, 5], 0, 1, 0.0, 2.0,
                                              rng=_gen(4))
    want = jops.uniform_random_batch_size_like(jnp.zeros((7, 3)), [2, 4, 5],
                                               0, 1, 0.0, 2.0,
                                               rng=jax.random.PRNGKey(4))
    assert got.shape == want.shape == (2, 7, 5)
    assert got.min() >= 0 and got.max() < 2.0
    got = tops.gaussian_random_batch_size_like(x, [-1, 6000], 1, 0, 2.0,
                                               0.1, rng=_gen(5))
    want = jops.gaussian_random_batch_size_like(jnp.zeros((7, 3)),
                                                [-1, 6000], 1, 0, 2.0, 0.1,
                                                rng=jax.random.PRNGKey(5))
    assert got.shape == want.shape == (3, 6000)
    _moments(got.numpy(), 2.0, 0.1)
    # drawn on the input's device without a generator or device
    assert tops.gaussian_random_batch_size_like(x, [-1, 2]).device == \
        x.device


def test_randint_range_dtype_and_high_none():
    got = tops.randint(3, 9, (N,), rng=_gen(6))
    want = jops.randint(3, 9, (N,), rng=jax.random.PRNGKey(6))
    # "int64": int64 in the port, int32 in the JAX package (x64 off)
    assert got.dtype == torch.int64 and np.asarray(want).dtype == np.int32
    assert torch.arange(3, 5, dtype=torch.int64).dtype == got.dtype
    for v in (got.numpy(), np.asarray(want)):
        assert set(np.unique(v)) == set(range(3, 9))
        _moments(v, 5.5, math.sqrt((6 ** 2 - 1) / 12.0))
    low_only = tops.randint(4, shape=(1000,), dtype="int32", rng=_gen(7))
    assert low_only.dtype == torch.int32
    assert set(low_only.tolist()) == {0, 1, 2, 3}
    assert set(np.unique(np.asarray(jops.randint(
        4, shape=(1000,), rng=jax.random.PRNGKey(7))))) == {0, 1, 2, 3}


def test_sampling_id_follows_the_row_probabilities():
    """Each row's draws follow its probabilities (a zero probability is
    never drawn); ``min`` and ``max`` are unused."""
    p = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    x = np.tile(p, (N // 4, 1))
    got = tops.sampling_id(torch.tensor(x), min=5.0, max=9.0, rng=_gen(8))
    want = jops.sampling_id(jnp.asarray(x), rng=jax.random.PRNGKey(8))
    assert got.dtype == torch.int64 and got.shape == (N // 4,)
    for v in (got.numpy(), np.asarray(want)):
        freq = np.bincount(v, minlength=4) / v.size
        assert freq[1] == 0
        np.testing.assert_allclose(freq, p, atol=5 * math.sqrt(
            0.25 / v.size))
    assert tops.sampling_id(torch.tensor(x[:3]), dtype="int32",
                            rng=_gen(0)).dtype == torch.int32


def test_random_crop_takes_one_window_for_the_batch():
    x = torch.arange(2 * 3 * 6 * 7, dtype=torch.float32).reshape(2, 3, 6, 7)
    seen = set()
    for s in range(60):
        out = tops.random_crop(x, (4, 5), rng=_gen(s))
        assert out.shape == (2, 3, 4, 5)
        y0 = int((out[0, 0, 0, 0] % 42) // 7)
        x0 = int(out[0, 0, 0, 0] % 7)
        torch.testing.assert_close(out, x[:, :, y0:y0 + 4, x0:x0 + 5])
        seen.add((y0, x0))
    # every start in [0, dim - size] is drawn
    assert seen == {(a, b) for a in range(3) for b in range(3)}
    want = jops.random_crop(jnp.asarray(x.numpy()), (4, 5),
                            rng=jax.random.PRNGKey(0))
    assert want.shape == (2, 3, 4, 5)


def test_shuffle_batch_permutes_the_rows():
    x = torch.arange(50 * 3).reshape(50, 3)
    got = tops.shuffle_batch(x, rng=_gen(9))
    assert sorted(got[:, 0].tolist()) == x[:, 0].tolist()
    torch.testing.assert_close(got[:, 1:] - got[:, :1],
                               x[:, 1:] - x[:, :1])
    assert not torch.equal(got, x)
    want = np.asarray(jops.shuffle_batch(jnp.asarray(x.numpy()),
                                         rng=jax.random.PRNGKey(9)))
    assert sorted(want[:, 0].tolist()) == x[:, 0].tolist()


# ---------------------------------------------------------------------------
# the seed and rng rules
# ---------------------------------------------------------------------------
CALLS = {
    "gaussian_random": lambda m, **k: m.gaussian_random((64,), **k),
    "uniform_random": lambda m, **k: m.uniform_random((64,), **k),
    "truncated_gaussian_random":
        lambda m, **k: m.truncated_gaussian_random((64,), **k),
    "randint": lambda m, **k: m.randint(0, 1000, (64,), **k),
    "uniform_random_batch_size_like":
        lambda m, **k: m.uniform_random_batch_size_like(
            torch.zeros(64, 2), [-1], **k),
    "gaussian_random_batch_size_like":
        lambda m, **k: m.gaussian_random_batch_size_like(
            torch.zeros(64, 2), [-1], **k),
    "sampling_id": lambda m, **k: m.sampling_id(torch.full((64, 50), 0.02),
                                                **k),
    "random_crop": lambda m, **k: m.random_crop(
        torch.arange(64 * 40.0).reshape(64, 40), (64, 30), **k),
    "shuffle_batch": lambda m, **k: m.shuffle_batch(torch.arange(64.0), **k),
}


def _on_cpu(name):
    return {} if name.endswith("like") or name in (
        "sampling_id", "random_crop", "shuffle_batch") else {"device": "cpu"}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_seed_and_rng_rules(name):
    call, dev = CALLS[name], _on_cpu(name)
    # an op seed gives the same draws on every call
    a = call(tops, seed=11, **dev)
    b = call(tops, seed=11, **dev)
    assert torch.equal(a, b)
    assert not torch.equal(a, call(tops, seed=12, **dev))
    # seed 0: the global counter; seed(s) restarts it
    trandom.seed(5)
    first = [call(tops, **dev) for _ in range(2)]
    assert not torch.equal(first[0], first[1])
    trandom.seed(5)
    again = [call(tops, **dev) for _ in range(2)]
    for x, y in zip(first, again):
        assert torch.equal(x, y)
    # the rng beats the seed
    assert torch.equal(call(tops, seed=11, rng=_gen(3)),
                       call(tops, seed=99, rng=_gen(3)))
    assert name in jpt.layers._NEEDS_RNG and name in tpt.layers._NEEDS_RNG


def test_the_jax_package_has_the_same_seed_rules():
    """The rules the port mirrors, in the JAX package: ``key_for(s)`` is
    ``PRNGKey(s)``, ``key_for(0)`` the counter's next key."""
    k = jrandom.key_for(11)
    np.testing.assert_array_equal(np.asarray(k),
                                  np.asarray(jax.random.PRNGKey(11)))
    jrandom.seed(5)
    a = np.asarray(jrandom.key_for(0))
    b = np.asarray(jrandom.key_for(0))
    jrandom.seed(5)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(jrandom.key_for(0)), a)


def test_a_generator_on_the_device_of_the_call():
    g = trandom.generator_for(3, "cpu")
    assert isinstance(g, torch.Generator) and g.device.type == "cpu"
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=_gen(3)))


# ---------------------------------------------------------------------------
# in a Program
# ---------------------------------------------------------------------------
def _random_net(pt):
    L = pt.layers
    x = pt.data("x", [40], "float32")
    p = pt.data("p", [5], "float32")
    outs = [L.uniform_random_batch_size_like(x, [-1, 300], min=2.0, max=3.0),
            L.gaussian_random_batch_size_like(x, [4, -1], 0, 1, mean=1.0,
                                              std=0.5),
            L.sampling_id(p),
            L.random_crop(x, [25]),
            L.shuffle_batch(x)]
    consts = [L.gaussian_random([3, 4]), L.uniform_random([5]),
              L.truncated_gaussian_random([6]), L.randint(7, shape=(8,))]
    return outs, consts


def _build(pt, unique_name):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), unique_name.guard():
        outs, consts = _random_net(pt)
    return main, outs, consts


def _int32_doc(doc):
    """A document with its int64 dtypes written int32 (``sampling_id``'s
    "int64" output is int32 in the JAX package, x64 off)."""
    return eval(re.sub(r"'int64'", "'int32'", repr(doc)))  # noqa: S307


def test_random_ops_in_a_program():
    from paddle_tpu.static import serialize as jser
    from paddle_tpu_torch.static import serialize as tser
    tm, touts, tconsts = _build(tpt, tpt.unique_name)
    jm, jouts, jconsts = _build(jpt, junique)
    assert _int32_doc(tser.program_to_dict(tm)) == \
        _int32_doc(jser.program_to_dict(jm))
    ops = tm.global_block().ops
    assert [op.type for op in ops] == [
        "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
        "sampling_id", "random_crop", "shuffle_batch"]
    assert all(op.attrs["_needs_rng"] for op in ops)
    assert all(op.attrs["_needs_rng"] for op in jm.global_block().ops)
    # the shape-only ops drew at once: a CPU tensor, an array in JAX
    for c, j in zip(tconsts, jconsts):
        assert isinstance(c, torch.Tensor) and c.device.type == "cpu"
        assert tuple(c.shape) == np.asarray(j).shape
    x = np.arange(6 * 40, dtype=np.float32).reshape(6, 40)
    p = np.tile(np.array([0.0, 0.5, 0.0, 0.5, 0.0], np.float32), (6, 1))
    fetch = [o.name for o in touts]
    feed = {"x": x, "p": p}
    runs = [tpt.Executor(tpt.CPUPlace()).run(tm, feed=feed, fetch_list=fetch,
                                             scope=tpt.Scope())
            for _ in range(2)]
    want = jpt.static.Executor(jpt.CPUPlace()).run(jm, feed=feed,
                                                   fetch_list=fetch)
    # the first run over a fresh scope draws the same (the program's seed,
    # the scope's run count and the op make the generator)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    u, g, sid, crop, shuf = runs[0]
    assert u.shape == np.asarray(want[0]).shape == (6, 300)
    assert u.min() >= 2.0 and u.max() < 3.0
    assert g.shape == np.asarray(want[1]).shape == (4, 6)
    assert set(sid.tolist()) <= {1, 3} and sid.shape == (6,)
    assert crop.shape == np.asarray(want[3]).shape == (6, 25)
    start = int(crop[0, 0])
    np.testing.assert_array_equal(crop, x[:, start:start + 25])
    assert sorted(shuf[:, 0].tolist()) == x[:, 0].tolist()
    # the next run over one scope draws anew
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    a = exe.run(tm, feed=feed, fetch_list=fetch[:1], scope=scope)[0]
    b = exe.run(tm, feed=feed, fetch_list=fetch[:1], scope=scope)[0]
    assert not np.array_equal(a, b)
