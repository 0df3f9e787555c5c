"""The CTR path of the port against the JAX package's, on the CPU: the
host-resident sparse embedding table (paddle_tpu_torch.distributed, the
port's own copy of the numpy module) and the DeepFM trainer
(paddle_tpu_torch.models.deepfm).

The tables run the same numpy code in both packages: rows, pushes and
checkpoints are held bitwise equal, pushes to 1e-7. The DeepFM step is
plain jnp in the JAX package and plain PyTorch in the port, on the same
dense params (through ``params_from_numpy``) and the same tables (equal by
construction): forward and loss 1e-6 (observed ~1e-7: fp32 sums in another
order), five synchronous steps: losses 1e-5 and every pulled row of both
tables 1e-6 with SGD and 1e-5 with Adagrad (see ROW_TOL). ``train_stream`` is racy by
design (its pushes land up to ``prefetch`` steps late), so it is held to
what the JAX package's own tests hold it to: the loss falls and every push
lands, also on an early exit; the reduced wire dtypes converge like fp32
(tests/test_sparse_embedding.py:151-195).
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import sparse_embedding as jse
from paddle_tpu.models import deepfm as jfm

from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.distributed import sparse_embedding as tse
from paddle_tpu_torch.models import deepfm as tfm

CPU = torch.device("cpu")


def _small(**kw):
    kw = dict(dict(num_slots=5, embed_dim=4, dense_dim=3, dnn_sizes=(16,),
                   vocab_per_slot=200), **kw)
    return jfm.DeepFMConfig(**kw), tfm.DeepFMConfig(**kw)


# ---------------------------------------------------------------------------
# the sparse table
# ---------------------------------------------------------------------------
def test_surface_is_the_jax_modules():
    assert tdist.SparseEmbeddingTable is tse.SparseEmbeddingTable
    assert tse.__all__ == jse.__all__
    assert set(jfm.__all__) <= set(tfm.__all__)
    assert set(tfm.__all__) - set(jfm.__all__) == {"params_from_numpy"}
    for name in ("pull", "push", "push_async", "flush", "save", "load"):
        assert inspect.signature(getattr(tse.SparseEmbeddingTable, name)) == \
            inspect.signature(getattr(jse.SparseEmbeddingTable, name)), name
    for fn in (tse.sparse_sgd, tse.sparse_adagrad, tse._hash_ids,
               tse._hash_uniform_rows):
        assert inspect.signature(fn) == \
            inspect.signature(getattr(jse, fn.__name__)), fn.__name__
    want = inspect.signature(jfm.CTRTrainer).parameters
    got = inspect.signature(tfm.CTRTrainer).parameters
    assert list(got) == list(want) + ["device"]
    for name in ("forward", "loss_fn", "synthetic_ctr_batch"):
        assert inspect.signature(getattr(tfm, name)) == \
            inspect.signature(getattr(jfm, name)), name


@pytest.mark.parametrize("shards", [1, 3])
def test_init_rows_equal_jax_bitwise(shards):
    rng = np.random.RandomState(shards)
    ids = rng.randint(0, 10 ** 7, (64, 5)).astype(np.int64)
    ids[3, :] = ids[0, :]                     # duplicates in one pull
    jt = jse.SparseEmbeddingTable(8, num_shards=shards, seed=11)
    tt = tse.SparseEmbeddingTable(8, num_shards=shards, seed=11)
    np.testing.assert_array_equal(tt.pull(ids), jt.pull(ids))
    assert tt.size == jt.size == len(np.unique(ids))
    # a new id among known ones, and the 1-dim table
    more = np.concatenate([ids[:, 0], [123456789]])
    np.testing.assert_array_equal(tt.pull(more), jt.pull(more))
    j1 = jse.SparseEmbeddingTable(1, num_shards=shards, seed=12)
    t1 = tse.SparseEmbeddingTable(1, num_shards=shards, seed=12)
    np.testing.assert_array_equal(t1.pull(ids), j1.pull(ids))


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
@pytest.mark.parametrize("shards", [1, 3])
def test_push_matches_jax(optimizer, shards):
    rng = np.random.RandomState(7)
    jt = jse.SparseEmbeddingTable(4, num_shards=shards, seed=5,
                                  optimizer=optimizer, learning_rate=0.05)
    tt = tse.SparseEmbeddingTable(4, num_shards=shards, seed=5,
                                  optimizer=optimizer, learning_rate=0.05)
    for step in range(3):
        ids = rng.randint(0, 300, (40,)).astype(np.int64)   # duplicates
        grads = rng.randn(40, 4).astype(np.float32)
        if step == 1:
            jt.push_async(ids, grads)
            tt.push_async(ids, grads)
            jt.flush()
            tt.flush()
        else:
            jt.push(ids, grads, learning_rate=0.1 if step else None)
            tt.push(ids, grads, learning_rate=0.1 if step else None)
    all_ids = np.arange(300)
    np.testing.assert_allclose(tt.pull(all_ids), jt.pull(all_ids), rtol=0,
                               atol=1e-7)


def test_checkpoints_load_across_packages(tmp_path):
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 1000, (50,)).astype(np.int64)
    grads = rng.randn(50, 4).astype(np.float32)
    for save_cls, load_cls, d in (
            (jse.SparseEmbeddingTable, tse.SparseEmbeddingTable, "j2t"),
            (tse.SparseEmbeddingTable, jse.SparseEmbeddingTable, "t2j")):
        a = save_cls(4, num_shards=3, seed=1, optimizer="adagrad")
        a.push(ids, grads)
        a.save(str(tmp_path / d), "tab")
        # another shard count and seed: the checkpoint's rows and slots
        # must be what the loaded table holds
        b = load_cls(4, num_shards=2, seed=99, optimizer="adagrad")
        b.load(str(tmp_path / d), "tab")
        assert b.size == a.size
        np.testing.assert_array_equal(b.pull(ids), a.pull(ids))
        a.push(ids, grads)
        b.push(ids, grads)           # the adagrad slots came along
        np.testing.assert_array_equal(b.pull(ids), a.pull(ids))


# ---------------------------------------------------------------------------
# DeepFM
# ---------------------------------------------------------------------------
def test_forward_and_loss_match_jax():
    jcfg, tcfg = _small()
    jp = jfm.init_dense_params(jax.random.PRNGKey(0), jcfg)
    tp = tfm.params_from_numpy(jax.tree.map(np.array, jp), tcfg, device=CPU)
    ids, dense, labels = jfm.synthetic_ctr_batch(jcfg, 64, seed=2)
    table = jse.SparseEmbeddingTable(4, seed=0)
    emb = table.pull(ids)
    first = jse.SparseEmbeddingTable(1, seed=1).pull(ids)[..., 0]
    jl = np.asarray(jfm.forward(jp, jcfg, emb, first, dense))
    tl = tfm.forward(tp, tcfg, torch.from_numpy(emb),
                     torch.from_numpy(first), torch.from_numpy(dense))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=1e-6 * np.abs(jl).max())
    jloss, _ = jfm.loss_fn(jp, jcfg, emb, first, dense, labels)
    tloss, tlog = tfm.loss_fn(tp, tcfg, torch.from_numpy(emb),
                              torch.from_numpy(first),
                              torch.from_numpy(dense),
                              torch.from_numpy(labels))
    assert abs(float(tloss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    torch.testing.assert_close(tlog, tl, rtol=0, atol=0)


def test_params_from_numpy_is_strict():
    jcfg, tcfg = _small()
    jp = jax.tree.map(np.array, jfm.init_dense_params(
        jax.random.PRNGKey(0), jcfg))
    assert sorted(tfm.params_from_numpy(jp, tcfg, device=CPU)) == sorted(jp)
    bad = dict(jp, dnn_w1=jp["dnn_w1"].T.copy())
    with pytest.raises(EnforceNotMet, match="dnn_w1"):
        tfm.params_from_numpy(bad, tcfg, device=CPU)
    with pytest.raises(EnforceNotMet, match="expected a dict"):
        tfm.params_from_numpy({"w0": jp["w0"]}, tcfg, device=CPU)
    with pytest.raises(EnforceNotMet, match="wire_dtype"):
        tfm.CTRTrainer(tcfg, wire_dtype="int8", device=CPU)


def _record_pushes(trainer):
    """Wrap both tables' push to record (table, ids, grads) as pushed."""
    out = []
    for name in ("table", "table_w1"):
        table = getattr(trainer, name)

        def push(ids, grads, learning_rate=None, _push=table.push,
                 _name=name):
            out.append((_name, np.array(ids), np.array(grads)))
            return _push(ids, grads, learning_rate)
        table.push = push            # the async worker calls self.push too
    return out


# Rows after five steps. SGD moves a row by lr * g, so the rows differ as
# little as the grads do (observed ~1e-9): 1e-6. Adagrad moves it by
# lr * g / (sqrt(sum g^2) + eps), which does not depend on g's scale: a grad
# near zero, whose last bits differ in the two packages, moves its row by up
# to lr times its relative difference. Observed: the pushed grads agree to
# 7.2e-9 absolute (6.2e-7 of the largest), each package 1.5e-9 from an fp64
# run of the step, and relative differences reach 1.8e-4 on grads of ~1e-5,
# which moves 5 of 12,800 row values by up to 1.3e-6: rows held to 1e-5
ROW_TOL = {"sgd": 1e-6, "adagrad": 1e-5}


@pytest.mark.parametrize("optimizer,shards", [("adagrad", 1), ("sgd", 2)])
def test_sync_train_steps_match_jax(optimizer, shards):
    jcfg, tcfg = _small(num_shards=shards, sparse_optimizer=optimizer)
    jtr = jfm.CTRTrainer(jcfg, seed=0, sync_push=True)
    ttr = tfm.CTRTrainer(tcfg, seed=0, sync_push=True, device=CPU)
    ttr.params = tfm.params_from_numpy(jax.tree.map(np.array, jtr.params),
                                       tcfg, device=CPU)
    jpushed, tpushed = _record_pushes(jtr), _record_pushes(ttr)
    batches = [jfm.synthetic_ctr_batch(jcfg, 128, seed=s) for s in range(5)]
    jl, tl = [], []
    for ids, dense, labels in batches:
        jl.append(jtr.train_step(ids, dense, labels, lr=0.05)[0])
        loss, logits = ttr.train_step(ids, dense, labels, lr=0.05)
        assert isinstance(loss, float) and logits.shape == (128,)
        tl.append(loss)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert len(tpushed) == len(jpushed) == 10
    for (jn, jids, jg), (tn, tids, tg) in zip(jpushed, tpushed):
        assert tn == jn
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_allclose(tg, jg, rtol=0,
                                   atol=2e-6 * np.abs(jg).max())
    ids = np.concatenate([b[0] for b in batches])
    for jt, tt in ((jtr.table, ttr.table), (jtr.table_w1, ttr.table_w1)):
        assert tt.size == jt.size
        np.testing.assert_allclose(tt.pull(ids), jt.pull(ids), rtol=0,
                                   atol=ROW_TOL[optimizer])
    want = jax.tree.map(np.asarray, jtr.params)
    for k, v in ttr.params.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_async_push_matches_sync_when_flushed():
    _, tcfg = _small()
    tr_s = tfm.CTRTrainer(tcfg, seed=0, sync_push=True, device=CPU)
    tr_a = tfm.CTRTrainer(tcfg, seed=0, sync_push=False, device=CPU)
    ids, dense, labels = tfm.synthetic_ctr_batch(tcfg, 32, seed=6)
    for _ in range(4):
        ls, _ = tr_s.train_step(ids, dense, labels)
        tr_a.finalize()
        la, _ = tr_a.train_step(ids, dense, labels)
        assert ls == la
    tr_a.finalize()


def test_train_stream_falls_and_lands_every_push():
    _, tcfg = _small()
    batches = [tfm.synthetic_ctr_batch(tcfg, 128, seed=s) for s in range(12)]
    tr = tfm.CTRTrainer(tcfg, seed=0, device=CPU)
    pushed = _record_pushes(tr)
    losses = list(tr.train_stream(iter(batches * 3), lr=0.05))
    assert len(losses) == 36
    assert np.mean(losses[-6:]) < np.mean(losses[:6])
    # train_stream returned after its finalize: all 36 steps' pushes have
    # landed, in order, each table's ids those of its batch
    for name in ("table", "table_w1"):
        got = [ids for n, ids, _ in pushed if n == name]
        assert len(got) == 36
        for ids, (want, _, _) in zip(got, batches * 3):
            np.testing.assert_array_equal(ids, want)


def test_train_stream_early_exit_still_pushes():
    _, tcfg = _small(num_slots=4, dense_dim=2, dnn_sizes=(8,),
                     vocab_per_slot=100)
    batches = [tfm.synthetic_ctr_batch(tcfg, 64, seed=s) for s in range(6)]
    tr = tfm.CTRTrainer(tcfg, seed=0, device=CPU)
    before = tr.table.pull(batches[0][0]).copy()
    for i, _ in enumerate(tr.train_stream(iter(batches), lr=0.1)):
        if i == 1:
            break   # early stop: pending grads must still land
    after = tr.table.pull(batches[0][0])
    assert not np.allclose(before, after), \
        "early-exit stream dropped the pending sparse pushes"


@pytest.mark.parametrize("wire", ["float16", "bfloat16"])
def test_reduced_wire_dtype_converges_like_fp32(wire):
    """The JAX package's check (tests/test_sparse_embedding.py:177-195):
    synchronous stepping, the loss trajectory within rtol 5e-2, atol 5e-3
    of the fp32 wire's; bf16 (8 bits of mantissa against fp16's 11) is held
    to the same bounds."""
    _, tcfg = _small()
    batches = [tfm.synthetic_ctr_batch(tcfg, 128, seed=s) for s in range(10)]
    runs = {}
    for wd in ("float32", wire):
        tr = tfm.CTRTrainer(tcfg, seed=0, sync_push=True, wire_dtype=wd,
                            device=CPU)
        runs[wd] = [tr.train_step(ids, dense, labels, lr=0.05)[0]
                    for ids, dense, labels in batches * 2]
    np.testing.assert_allclose(runs[wire], runs["float32"], rtol=5e-2,
                               atol=5e-3)
    assert runs[wire][-1] < runs[wire][0]


def test_fp16_wire_matches_jax():
    jcfg, tcfg = _small()
    jtr = jfm.CTRTrainer(jcfg, seed=0, sync_push=True, wire_dtype="float16")
    ttr = tfm.CTRTrainer(tcfg, seed=0, sync_push=True, wire_dtype="float16",
                         device=CPU)
    ttr.params = tfm.params_from_numpy(jax.tree.map(np.array, jtr.params),
                                       tcfg, device=CPU)
    for s in range(4):
        ids, dense, labels = jfm.synthetic_ctr_batch(jcfg, 128, seed=s)
        jl = jtr.train_step(ids, dense, labels, lr=0.05)[0]
        tl = ttr.train_step(ids, dense, labels, lr=0.05)[0]
        assert abs(tl - jl) <= 1e-5
