"""The port's sparse-row and loss ops against the JAX package, on the CPU.

- ``embedding_scatter_add``: the port's plain body against the JAX stock
  body (``.at[].add``) and the Pallas ``_scatter_kernel`` run in interpret
  mode; its autograd Function against ``jax.vjp``; the plain emulation of
  the kernel's two-level summation order (``_scatter_add_two_level``, which
  the card's kernel matches bit for bit) against a scalar fp32 loop and
  the plain body.
- ``ops.selected_rows``: all six functions against
  ``paddle_tpu/ops/selected_rows.py``.
- ``softmax_cross_entropy``: the plain body against ``_xent_reference`` and
  the Pallas ``_xent_kernel`` in interpret mode, and its gradient against
  ``jax.grad`` of the Pallas function.
- ``ops.loss``: the 19 names of the JAX module's ``__all__``.

The JAX package's stock and Pallas bodies disagree on ids outside
``[0, h)`` and labels outside ``[0, V)``: the port follows the stock ones,
so cases against the Pallas bodies keep ids and labels in range, and the
edge cases are held against the stock bodies alone.

Tolerances: the port's scatter-add sums each row in fp32 and adds dst once,
where the stock body adds in dst's dtype one update at a time: fp32 agrees
to rounding (1e-6; bit for bit into zeros, where the order is the same);
bf16 to a few bf16 units (2^-6 relative, 1e-2 absolute). Cross-entropy:
fp32 sums of V exps in another order, 1e-6 relative with 1e-5 absolute;
bf16 logits are read exactly by both and summed in fp32, so bf16 is held to
1e-2 (a loose bound, far above the observed error). Each loss case
states its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import loss as jloss
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops import selected_rows as jsr
from paddle_tpu.ops.pallas import embedding as pemb

import paddle_tpu_torch.ops as ops
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops import loss as tloss


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype="float32"):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


# ---------------------------------------------------------------------------
# embedding_scatter_add
# ---------------------------------------------------------------------------
_SCATTER_CASES = [
    # (h, d, n, dtype)
    (33, 130, 40, "float32"),     # heavy duplication onto few rows
    (9, 8, 25, "float32"),
    (64, 768, 100, "float32"),
    (33, 130, 40, "bfloat16"),
    (200, 16, 7, "bfloat16"),
]


def _scatter_inputs(h, d, n, dup_rows, seed):
    rng = np.random.RandomState(seed)
    dst = rng.randn(h, d).astype(np.float32)
    ids = rng.randint(0, dup_rows, n).astype(np.int32)
    upd = rng.randn(n, d).astype(np.float32)
    return dst, ids, upd


@pytest.mark.parametrize("h,d,n,dtype", _SCATTER_CASES)
def test_scatter_add_reference_matches_stock_and_pallas(h, d, n, dtype):
    dst, ids, upd = _scatter_inputs(h, d, n, min(h, 5 + n // 4), h + d)
    (dj, dt), (uj, ut) = _pair(dst, dtype), _pair(upd, dtype)
    stock = pemb.embedding_scatter_add_reference(dj, jnp.asarray(ids), uj)
    pallas = pemb.embedding_scatter_add_pallas(dj, jnp.asarray(ids), uj,
                                               interpret=True)
    out = K.embedding_scatter_add(dt, torch.tensor(ids), ut)
    assert out.dtype == dt.dtype and out.shape == dt.shape
    atol, rtol = (1e-2, 2.0 ** -6) if dtype == "bfloat16" else (1e-6, 1e-6)
    np.testing.assert_allclose(_np(out), _np(stock), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=atol, rtol=rtol)
    # out of place
    np.testing.assert_array_equal(_np(dt), _np(dj))


def test_scatter_add_into_zeros_is_bitwise_the_stock_sum():
    # into zeros both add the updates one by one in ascending j in fp32
    _, ids, upd = _scatter_inputs(16, 24, 200, 6, 0)
    stock = pemb.embedding_scatter_add_reference(
        jnp.zeros((16, 24)), jnp.asarray(ids), jnp.asarray(upd))
    out = K.embedding_scatter_add(torch.zeros(16, 24), torch.tensor(ids),
                                  torch.tensor(upd))
    np.testing.assert_array_equal(out.numpy(), np.asarray(stock))


@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
def test_scatter_add_edge_ids_match_stock(ids_dtype):
    # -1 and -h wrap once; h and -h-1 are dropped, as .at[].add does
    h, d = 9, 5
    rng = np.random.RandomState(3)
    dst = rng.randn(h, d).astype(np.float32)
    ids = np.array([-1, -h, h, -h - 1, 3, 3, 8, 100], ids_dtype)
    upd = rng.randn(len(ids), d).astype(np.float32)
    stock = pemb.embedding_scatter_add_reference(
        jnp.asarray(dst), jnp.asarray(ids), jnp.asarray(upd))
    out = K.embedding_scatter_add(torch.tensor(dst), torch.tensor(ids),
                                  torch.tensor(upd))
    np.testing.assert_allclose(out.numpy(), np.asarray(stock), atol=1e-6,
                               rtol=1e-6)
    untouched = [1, 2, 4, 5, 6, 7]
    np.testing.assert_array_equal(out.numpy()[untouched], dst[untouched])


def test_scatter_add_zero_ids_returns_a_copy():
    dst = torch.randn(4, 3)
    out = K.embedding_scatter_add(dst, torch.zeros(0, dtype=torch.int64),
                                  torch.zeros(0, 3))
    assert torch.equal(out, dst) and out.data_ptr() != dst.data_ptr()


def test_scatter_add_is_deterministic_and_counts_no_cpu_launch():
    dst, ids, upd = _scatter_inputs(33, 130, 400, 3, 5)
    K.reset_launch_counts()
    a = K.embedding_scatter_add(torch.tensor(dst), torch.tensor(ids),
                                torch.tensor(upd))
    b = K.embedding_scatter_add(torch.tensor(dst), torch.tensor(ids),
                                torch.tensor(upd))
    assert torch.equal(a, b)
    assert K.launch_counts()["embedding_scatter_add"] == 0


def test_scatter_add_chunk_matches_the_kernel_source():
    # the sorted positions are cut into chunks of kChunk: the wrapper sizes
    # the chunk partials, and the emulation takes the order, from _CHUNK; a
    # smaller number than kChunk's would let the kernel write past the
    # partials
    import pathlib
    import re
    from paddle_tpu_torch.ops.kernels import embedding
    src = (pathlib.Path(embedding.__file__).parent / "csrc"
           / "embedding.cu").read_text()
    m = re.search(r"constexpr int kChunk = (\d+);", src)
    assert m and int(m.group(1)) == embedding._CHUNK
    assert embedding._scatter_add_two_level.__defaults__ == (
        embedding._CHUNK,)


# ---------------------------------------------------------------------------
# the kernel's two-level summation order, emulated in plain PyTorch
# ---------------------------------------------------------------------------
def _two_level_by_scalars(dst, ids, upd, chunk):
    """The order spelled out with fp32 scalars: sorted positions in chunks,
    each piece of a row's run summed in ascending position from 0, the
    pieces in ascending chunk order from 0, then dst once."""
    h, d = dst.shape
    keys = np.where((ids >= -h) & (ids < h), np.where(ids < 0, ids + h, ids),
                    h)
    order = np.argsort(keys, kind="stable")
    pieces = {}
    for p, j in enumerate(order):
        if keys[j] < h:
            pieces.setdefault(keys[j], {}).setdefault(p // chunk, []).append(j)
    out = dst.astype(np.float32).copy()
    for r, by_chunk in pieces.items():
        for c in range(d):
            total = np.float32(0)
            for q in sorted(by_chunk):
                part = np.float32(0)
                for j in by_chunk[q]:
                    part = np.float32(part + np.float32(upd[j, c]))
                total = np.float32(total + part)
            out[r, c] = np.float32(out[r, c] + total)
    return out


def _scatter_atol(ids, h, upd):
    # the plain body sums in ascending j: each of a row's c adds may round
    # by 2^-24 of the partial sum, so 1e-6 * c_max * max|update| (fp32)
    wrapped = np.where(ids < 0, ids + h, ids)
    valid = (ids >= -h) & (ids < h)
    c_max = np.bincount(wrapped[valid], minlength=1).max()
    return 1e-6 * c_max * np.abs(upd).max() + 1e-6


_TWO_LEVEL_CASES = [
    # (h, d, n, id range (lo, hi) or None for 2 rows' long run)
    (600, 16, 3000, (0, 600)),        # random ids, runs cross chunk edges
    (2, 24, 4096, (0, 2)),            # one long run per row (16 chunks)
    (40, 8, 1500, (-43, 43)),         # wrapped and dropped ids
    (50, 12, 200, (0, 9)),            # n < C
    (7, 5, 1, (0, 7)),                # n = 1
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,d,n,id_range", _TWO_LEVEL_CASES)
def test_scatter_add_two_level_is_within_scatter_atol_of_plain(
        h, d, n, id_range, dtype):
    from paddle_tpu_torch.ops.kernels import embedding as E
    rng = np.random.RandomState(h + n)
    dst = rng.randn(h, d).astype(np.float32)
    ids = rng.randint(*id_range, n).astype(np.int64)
    upd = rng.randn(n, d).astype(np.float32)
    _, dt = _pair(dst, dtype)
    _, ut = _pair(upd, dtype)
    got = E._scatter_add_two_level(dt, torch.tensor(ids), ut)
    plain = E._embedding_scatter_add_reference(dt, torch.tensor(ids), ut)
    assert got.dtype == dt.dtype and got.shape == dt.shape
    # another fp32 order: within scatter_atol (fp32); bf16 rounds the sum
    # once, so one bf16 unit may flip (rtol 2^-7)
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(_np(got), _np(plain), rtol=rtol,
                               atol=_scatter_atol(ids, h, _np(ut)))
    # rows no id names are dst as it is
    keys = np.where(ids < 0, ids + h, ids)[(ids >= -h) & (ids < h)]
    untouched = np.setdiff1d(np.arange(h), keys)
    np.testing.assert_array_equal(_np(got)[untouched], _np(dt)[untouched])


@pytest.mark.parametrize("h,d,n,chunk", [
    (2, 3, 700, 256),       # two rows' runs, each over several chunks
    (9, 5, 1000, 16),       # many runs, cut at many chunk edges
    (13, 4, 300, 7)])       # a chunk that is no power of two
def test_scatter_add_two_level_follows_the_scalar_order(h, d, n, chunk):
    from paddle_tpu_torch.ops.kernels import embedding as E
    rng = np.random.RandomState(n)
    dst = rng.randn(h, d).astype(np.float32)
    ids = rng.randint(-h - 2, h + 2, n)
    upd = rng.randn(n, d).astype(np.float32)
    got = E._scatter_add_two_level(torch.tensor(dst), torch.tensor(ids),
                                   torch.tensor(upd), chunk)
    np.testing.assert_array_equal(
        got.numpy(), _two_level_by_scalars(dst, ids, upd, chunk))


def test_scatter_add_two_level_is_deterministic_and_plain_when_runs_fit():
    from paddle_tpu_torch.ops.kernels import embedding as E
    rng = np.random.RandomState(11)
    C = E._CHUNK
    # four rows of exactly C ids each, shuffled: each row's run is one
    # whole chunk, so the two levels add as the plain body does, bit for bit
    ids = rng.permutation(np.repeat(np.arange(4), C))
    dst = torch.tensor(rng.randn(6, 10).astype(np.float32))
    upd = torch.tensor(rng.randn(4 * C, 10).astype(np.float32))
    got = E._scatter_add_two_level(dst, torch.tensor(ids), upd)
    again = E._scatter_add_two_level(dst, torch.tensor(ids), upd)
    assert torch.equal(got, again)
    plain = E._embedding_scatter_add_reference(dst, torch.tensor(ids), upd)
    assert torch.equal(got, plain)
    # fewer than C ids: every run fits one chunk, bf16 dst too
    ids = rng.randint(-3, 8, C - 1)
    upd = torch.tensor(rng.randn(C - 1, 10).astype(np.float32))
    for dt in (dst, dst.bfloat16()):
        assert torch.equal(
            E._scatter_add_two_level(dt, torch.tensor(ids), upd),
            E._embedding_scatter_add_reference(dt, torch.tensor(ids), upd))
    # runs across chunks: deterministic, and the plain body to fp32
    # rounding
    ids = rng.randint(0, 2, 4 * C)
    upd = torch.tensor(rng.randn(4 * C, 10).astype(np.float32))
    a = E._scatter_add_two_level(dst, torch.tensor(ids), upd)
    assert torch.equal(a, E._scatter_add_two_level(dst, torch.tensor(ids),
                                                   upd))
    plain = E._embedding_scatter_add_reference(dst, torch.tensor(ids), upd)
    np.testing.assert_allclose(a.numpy(), plain.numpy(), rtol=1e-6,
                               atol=_scatter_atol(ids, 6, upd.numpy()))


def test_scatter_add_function_matches_jax_vjp():
    h, d, n = 16, 24, 9
    dst, ids, upd = _scatter_inputs(h, d, n, h, 7)
    dy = np.random.RandomState(8).randn(h, d).astype(np.float32)
    yj, vjp = jax.vjp(
        lambda a, u: pemb.embedding_scatter_add_pallas(
            a, jnp.asarray(ids), u, interpret=True),
        jnp.asarray(dst), jnp.asarray(upd))
    ddj, duj = vjp(jnp.asarray(dy))
    dt = torch.tensor(dst).requires_grad_()
    ut = torch.tensor(upd).requires_grad_()
    yt = K.embedding_scatter_add(dt, torch.tensor(ids), ut)
    yt.backward(torch.tensor(dy))
    # forward: fp32 rounding (1e-6); backward: copies of dy, exact
    np.testing.assert_allclose(_np(yt), _np(yj), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(_np(dt.grad), _np(ddj))
    np.testing.assert_array_equal(_np(ut.grad), _np(duj))


def test_scatter_add_function_grad_at_edge_ids_matches_stock_gather():
    # dy at the ids with jnp.take's meaning: -1 wraps, h gives NaN
    h, d = 6, 4
    ids = np.array([-1, 2, h], np.int64)
    dy = np.random.RandomState(9).randn(h, d).astype(np.float32)
    ut = torch.zeros(3, d, requires_grad=True)
    K.embedding_scatter_add(torch.zeros(h, d), torch.tensor(ids),
                            ut).backward(torch.tensor(dy))
    want = jnp.take(jnp.asarray(dy), jnp.asarray(ids), axis=0)
    np.testing.assert_array_equal(_np(ut.grad), _np(want))
    assert np.isnan(_np(ut.grad)[2]).all()


# ---------------------------------------------------------------------------
# selected_rows
# ---------------------------------------------------------------------------
def _sr_pair(rows, values, height):
    return (jsr.SelectedRows(jnp.asarray(rows), jnp.asarray(values), height),
            ops.SelectedRows(torch.tensor(rows), torch.tensor(values),
                             height))


def test_merge_selected_rows_layout_matches_jax():
    rows = np.array([5, 2, 5, 0, 2, 2], np.int64)
    srj, srt = _sr_pair(rows, np.ones((6, 1), np.float32), 8)
    (mj, vj), (mt, vt) = jsr.merge_selected_rows(srj), \
        ops.merge_selected_rows(srt)
    assert mt.rows.tolist() == [0, 2, 5, 0, 0, 0] == np.asarray(
        mj.rows).tolist()
    assert vt.tolist() == [True, True, True, False, False, False] \
        == np.asarray(vj).tolist()
    assert mt.values[:, 0].tolist() == [1, 3, 2, 0, 0, 0]
    np.testing.assert_array_equal(_np(mt.values), _np(mj.values))
    assert mt.height == mj.height == 8


@pytest.mark.parametrize("shape", [(40, 7), (40, 3, 4), (40,)])
def test_merge_and_densify_match_jax(shape):
    rng = np.random.RandomState(len(shape))
    rows = rng.randint(0, 12, shape[0]).astype(np.int64)
    vals = rng.randn(*shape).astype(np.float32)
    srj, srt = _sr_pair(rows, vals, 15)
    (mj, vj), (mt, vt) = jsr.merge_selected_rows(srj), \
        ops.merge_selected_rows(srt)
    np.testing.assert_array_equal(mt.rows.numpy(), np.asarray(mj.rows))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # sums into zeros in ascending j on both sides: bit for bit
    np.testing.assert_array_equal(_np(mt.values), _np(mj.values))
    dj = jsr.get_tensor_from_selected_rows(srj)
    dt = ops.get_tensor_from_selected_rows(srt)
    assert tuple(dt.shape) == (15,) + shape[1:]
    np.testing.assert_array_equal(_np(dt), _np(dj))
    # merge, then densify, equals densify
    np.testing.assert_array_equal(
        _np(ops.get_tensor_from_selected_rows(mt)), _np(dt))


def test_sparse_sgd_update_matches_jax():
    rng = np.random.RandomState(11)
    param = rng.randn(20, 6).astype(np.float32)
    rows = np.array([3, 19, 3, 0, -1], np.int64)
    vals = rng.randn(5, 6).astype(np.float32)
    srj, srt = _sr_pair(rows, vals, 20)
    pt = torch.tensor(param)
    want = jsr.sparse_sgd_update(jnp.asarray(param), srj, 0.1)
    got = ops.sparse_sgd_update(pt, srt, 0.1)
    # the stock body adds each -lr*g to the param in turn, the port sums
    # them first: fp32 rounding, 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(pt.numpy(), param)     # out of place


def test_split_selected_rows_matches_jax():
    rng = np.random.RandomState(12)
    rows = rng.randint(0, 10, 30).astype(np.int64)
    vals = rng.randn(30, 4).astype(np.float32)
    srj, srt = _sr_pair(rows, vals, 10)
    outj = jsr.split_selected_rows(srj, 3)
    outt = ops.split_selected_rows(srt, 3)
    assert len(outt) == len(outj) == 3
    for a, b in zip(outt, outj):
        np.testing.assert_array_equal(a.rows.numpy(), np.asarray(b.rows))
        np.testing.assert_array_equal(a.values.numpy(), np.asarray(b.values))
        assert a.height == b.height


def test_lookup_sparse_table_rows_are_bit_identical():
    ids = np.array([4, 7, 4, 1, 9], np.int64)
    tj, tt = {}, {}
    rj = jsr.lookup_sparse_table(tj, ids, 6, seed=3)
    rt = ops.lookup_sparse_table(tt, torch.tensor(ids), 6, seed=3,
                                 device="cpu")
    assert rt.dtype == torch.float32 and rt.device.type == "cpu"
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert sorted(tt) == sorted(tj) == [1, 4, 7, 9]
    # a second lookup reuses the rows and draws only the new one
    rj = jsr.lookup_sparse_table(tj, [9, 2], 6, seed=5)
    rt = ops.lookup_sparse_table(tt, [9, 2], 6, seed=5, device="cpu")
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


def test_selected_rows_functions_are_exported_from_ops():
    # ops star-exports every ported op module (tests/test_torch_surface.py),
    # the SelectedRows functions among them
    assert set(jsr.__all__) <= set(ops.__all__)
    for name in jsr.__all__:
        assert callable(getattr(ops, name))
        assert getattr(ops, name) is getattr(ops.selected_rows, name)


# ---------------------------------------------------------------------------
# softmax_cross_entropy
# ---------------------------------------------------------------------------
_XENT_CASES = [
    # (lead shape, V, dtype)
    ((13,), 77, "float32"),
    ((2, 5), 40, "float32"),
    ((130,), 2073, "float32"),      # word2vec's dictionary, ragged
    ((13,), 77, "bfloat16"),
    ((64,), 512, "bfloat16"),
]


def _xent_inputs(lead, v, seed, scale=2.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*lead, v) * scale).astype(np.float32)
    lab = rng.randint(0, v, lead).astype(np.int32)
    return x, lab


@pytest.mark.parametrize("lead,v,dtype", _XENT_CASES)
def test_xent_reference_matches_stock_and_pallas(lead, v, dtype):
    x, lab = _xent_inputs(lead, v, v)
    xj, xt = _pair(x, dtype)
    stock = pk._xent_reference(xj, jnp.asarray(lab))
    pallas = pk._softmax_xent_pallas(xj, jnp.asarray(lab), interpret=True)
    out = K.softmax_cross_entropy(xt, torch.tensor(lab))
    assert out.dtype == torch.float32 and tuple(out.shape) == lead
    atol, rtol = (1e-2, 1e-2) if dtype == "bfloat16" else (1e-5, 1e-6)
    np.testing.assert_allclose(_np(out), _np(stock), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=atol, rtol=rtol)


def test_xent_edge_labels_match_stock():
    v = 8
    x, _ = _xent_inputs((6,), v, 4)
    lab = np.array([-1, -v, v, -v - 1, 0, v - 1], np.int64)
    stock = pk._xent_reference(jnp.asarray(x), jnp.asarray(lab))
    out = K.softmax_cross_entropy(torch.tensor(x), torch.tensor(lab))
    np.testing.assert_allclose(out.numpy(), _np(stock), atol=1e-5,
                               rtol=1e-6)
    assert np.isnan(out.numpy()[[2, 3]]).all()
    assert np.isfinite(out.numpy()[[0, 1, 4, 5]]).all()


def test_xent_rows_with_inf_and_nan_match_stock():
    x = np.zeros((4, 6), np.float32)
    x[0, :] = -np.inf                 # every logit -inf
    x[1, 2] = -np.inf                 # one masked logit
    x[2, 3] = np.inf
    x[3, 1] = np.nan
    lab = np.array([0, 1, 1, 0], np.int32)
    stock = np.asarray(pk._xent_reference(jnp.asarray(x), jnp.asarray(lab)))
    loss, lse = K.get_body("softmax_cross_entropy", "reference")(
        torch.tensor(x), torch.tensor(lab))
    np.testing.assert_allclose(loss.numpy(), stock, atol=1e-6)
    assert np.isnan(lse.numpy()[[0, 2, 3]]).all()
    assert np.isfinite(lse.numpy()[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xent_grad_matches_jax_grad_of_pallas(dtype):
    lead, v = (3, 11), 130
    x, lab = _xent_inputs(lead, v, 21)
    w = np.random.RandomState(22).rand(*lead).astype(np.float32)
    xj, xt = _pair(x, dtype)

    def f(lg):
        return jnp.sum(pk._softmax_xent_pallas(lg, jnp.asarray(lab),
                                               interpret=True)
                       * jnp.asarray(w))

    gj = jax.grad(f)(xj)
    xt = xt.clone().requires_grad_()
    K.reset_launch_counts()
    (K.softmax_cross_entropy(xt, torch.tensor(lab))
     * torch.tensor(w)).sum().backward()
    assert xt.grad.dtype == xt.dtype
    assert K.launch_counts()["softmax_cross_entropy"] == 0
    # fp32: exp(x - lse) from lse summed in another order, 1e-6; bf16: the
    # same fp32 values rounded once to bf16, one unit (2^-7 relative)
    atol, rtol = (1e-6, 2.0 ** -7) if dtype == "bfloat16" else (1e-7, 1e-5)
    np.testing.assert_allclose(_np(xt.grad), _np(gj), atol=atol, rtol=rtol)


def test_xent_grad_matches_autograd_of_plain_body():
    x, lab = _xent_inputs((20,), 50, 31)
    lab[:3] = [-1, -50, 49]
    a = torch.tensor(x, requires_grad=True)
    K.softmax_cross_entropy(a, torch.tensor(lab)).sum().backward()
    b = torch.tensor(x, requires_grad=True)
    K.get_body("softmax_cross_entropy", "reference")(
        b, torch.tensor(lab))[0].sum().backward()
    # the same softmax minus one-hot, lse's max subtracted or not: 1e-6
    torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=1e-5)


def test_xent_accepts_and_ignores_block_n():
    x, lab = _xent_inputs((9,), 30, 41)
    a = K.softmax_cross_entropy(torch.tensor(x), torch.tensor(lab))
    b = K.softmax_cross_entropy(torch.tensor(x), torch.tensor(lab),
                                block_n=8)
    c = K.softmax_cross_entropy(torch.tensor(x),
                                torch.tensor(lab).to(torch.int16))
    assert torch.equal(a, b) and torch.equal(a, c)


# ---------------------------------------------------------------------------
# ops.loss: the 19 names of paddle_tpu/ops/loss.py
# ---------------------------------------------------------------------------
def _loss_case(name, seed):
    """(args as numpy arrays or scalars, kwargs, atol) for one loss; each
    atol states the loss's own rounding (fp32 throughout)."""
    r = np.random.RandomState(seed)
    f = lambda *s: r.randn(*s).astype(np.float32)         # noqa: E731
    prob = lambda *s: (r.rand(*s) * 0.98 + 0.01).astype(np.float32)  # noqa

    def softmax(a):
        e = np.exp(a - a.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    lab10 = r.randint(0, 10, (6, 1)).astype(np.int64)
    binary = (r.rand(6, 4) > 0.5).astype(np.float32)
    cases = {
        "cross_entropy": [((softmax(f(6, 10)), lab10), {}, 1e-6),
                          ((softmax(f(6, 10)), softmax(f(6, 10))),
                           {"soft_label": True}, 1e-6),
                          ((softmax(f(6, 10)), lab10),
                           {"ignore_index": int(lab10[0, 0])}, 1e-6)],
        "softmax_with_cross_entropy": [
            ((f(6, 10), lab10), {}, 1e-5),
            ((f(6, 10), lab10[:, 0]), {}, 1e-5),
            ((f(6, 10), softmax(f(6, 10))), {"soft_label": True}, 1e-5),
            ((f(6, 10), lab10), {"ignore_index": int(lab10[1, 0]),
                                 "return_softmax": True}, 1e-5),
            ((f(10, 6), r.randint(0, 10, (1, 6)).astype(np.int64)),
             {"axis": 0}, 1e-5)],
        "sigmoid_cross_entropy_with_logits": [
            ((f(6, 4), binary), {}, 1e-6),
            ((f(6, 4), np.where(r.rand(6, 4) < 0.3, -100.0, binary)
              .astype(np.float32)), {"normalize": True}, 1e-6)],
        "square_error_cost": [((f(6, 4), f(6, 4)), {}, 1e-6)],
        "mse_loss": [((f(6, 4), f(6, 4)), {}, 1e-6)],
        "smooth_l1": [((f(6, 4), f(6, 4)), {}, 1e-5),
                      ((f(6, 2, 3), f(6, 2, 3)),
                       {"inside_weight": prob(6, 2, 3),
                        "outside_weight": prob(6, 2, 3), "sigma": 2.0},
                       1e-5)],
        "huber_loss": [((f(6, 4) * 2, f(6, 4)), {"delta": 0.7}, 1e-6)],
        "log_loss": [((prob(6, 1), binary[:, :1]), {}, 1e-6)],
        "hinge_loss": [((f(6, 1), binary[:, :1]), {}, 1e-6)],
        "margin_rank_loss": [((np.sign(f(6, 1)), f(6, 1), f(6, 1)),
                              {"margin": 0.2}, 1e-6)],
        "rank_loss": [((binary[:, :1], f(6, 1), f(6, 1)), {}, 1e-6)],
        "kldiv_loss": [((np.log(softmax(f(6, 5))), softmax(f(6, 5))),
                        {"reduction": red}, 1e-6)
                       for red in ("mean", "sum", "batchmean", "none")],
        "bpr_loss": [((f(6, 10), lab10), {}, 1e-6)],
        "cos_sim": [((f(6, 8), f(6, 8)), {}, 1e-6),
                    ((f(6, 8), f(1, 8)), {}, 1e-6)],
        "modified_huber_loss": [((f(6, 1) * 2, binary[:, :1]), {}, 1e-6)],
        "teacher_student_sigmoid_loss": [((f(6, 1) * 10, prob(6, 1)), {},
                                          1e-6)],
        "npair_loss": [((f(6, 8), f(6, 8),
                         r.randint(0, 3, (6, 1)).astype(np.int64)), {},
                        1e-5)],
        "dice_loss": [((softmax(f(6, 5)), r.randint(0, 5, (6, 1))
                        .astype(np.int64)), {}, 1e-6),
                      ((softmax(f(2, 3, 5)), r.randint(0, 5, (2, 3, 1))
                        .astype(np.int64)), {}, 1e-6)],
        "sampled_softmax_with_cross_entropy": [
            ((f(6, 50), lab10, 7),
             {"use_customized_samples": True,
              "customized_samples": r.randint(0, 50, (6, 7)).astype(
                  np.int64)}, 1e-5),
            ((f(6, 50), lab10, 5),
             {"use_customized_samples": True,
              "customized_samples": np.array([0, 1, 2, 3, 4], np.int64),
              "remove_accidental_hits": False}, 1e-5)],
    }
    return cases[name]


_LOSS_NAMES = list(jloss.__all__)


def test_loss_module_has_every_name():
    assert sorted(tloss.__all__) == sorted(_LOSS_NAMES)
    assert len(_LOSS_NAMES) == 19


@pytest.mark.parametrize("name", _LOSS_NAMES)
def test_loss_matches_jax(name):
    for i, (args, kwargs, atol) in enumerate(_loss_case(name, len(name))):
        def conv(a, to_jax):
            if isinstance(a, np.ndarray):
                return jnp.asarray(a) if to_jax else torch.tensor(a)
            return a
        want = getattr(jloss, name)(*(conv(a, True) for a in args),
                                    **{k: conv(v, True)
                                       for k, v in kwargs.items()})
        got = getattr(tloss, name)(*(conv(a, False) for a in args),
                                   **{k: conv(v, False)
                                      for k, v in kwargs.items()})
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want), (name, i)
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(np.shape(w)), (name, i)
            np.testing.assert_allclose(_np(g), _np(w), atol=atol,
                                       rtol=1e-5, err_msg=f"{name} case {i}")


def test_sampled_softmax_draws_from_the_generator():
    r = np.random.RandomState(5)
    logits = torch.tensor(r.randn(4, 30).astype(np.float32))
    lab = torch.tensor(r.randint(0, 30, (4, 1)))
    a = tloss.sampled_softmax_with_cross_entropy(
        logits, lab, 6, rng=torch.Generator().manual_seed(1))
    b = tloss.sampled_softmax_with_cross_entropy(
        logits, lab, 6, rng=torch.Generator().manual_seed(1))
    c = tloss.sampled_softmax_with_cross_entropy(logits, lab, 6, seed=2)
    assert a.shape == (4, 1) and torch.equal(a, b)
    assert torch.isfinite(c).all()
