"""The Fluid CTR-DNN (``models/ctr_dnn.py``) trained through the port's data
path against the JAX package's, on the CPU, at ``ctr_dnn_tiny`` (4 slots, a
[1000, 8] table, fc 32 x3, batch 64).

One builder makes each package's programs from its own ``layers``: the
startup, for-test and training documents are equal. The weights come from
the JAX package's startup program (``Scope.from_numpy``). Both packages
then train 10 Adam steps with ``train_from_dataset`` over the same
MultiSlot files (written by the port's ``MultiSlotDataGenerator``) through
an ``InMemoryDataset`` at one thread (more threads parse in a racing order
in both packages): the printed auc and loss and the final persistables
agree within 1e-5. ``infer_from_dataset`` over a ``QueueDataset`` leaves
the parameters bitwise as they were, and ``AsyncExecutor.run_from_files``
trains as ``train_from_dataset`` does.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.static.executor import Scope as JScope
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch.models import ctr_dnn as cd

TOL = 1e-5
STEPS = 10
CPU = tpt.CPUPlace()


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker; the port's CPU ops take two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        with static_mode_guard(False):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    cfg = cd.ctr_dnn_tiny()
    files = cd.write_files(cfg, str(tmp_path_factory.mktemp("ctr")), 2,
                           STEPS * cfg.batch // 2, 22)
    with static_mode_guard(False):
        t, j = cd.ctr_dnn(tpt, cfg), cd.ctr_dnn(jpt, cfg)
    jexe, jscope = jpt.static.Executor(), JScope()
    jexe.run(j["startup"], scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n, v in j["startup"].global_block().vars.items()
              if v.persistable}
    return cfg, files, t, j, arrays


def _dataset(pt, cfg, net, files, kind="InMemoryDataset"):
    ds = pt.dataio.DatasetFactory().create_dataset(kind)
    ds.set_use_var(net["slots"])
    ds.set_batch_size(cfg.batch)
    ds.set_thread(1)
    ds.set_filelist(files)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        ds.local_shuffle(7)
    return ds


def _printed(text):
    """[(step, auc, loss)] of train_from_dataset's lines."""
    return [(int(m[0]), float(m[1]), float(m[2])) for m in re.findall(
        r"step (\d+): auc=([-\d.e]+), loss=([-\d.e]+)", text)]


def test_documents_equal_jax(built):
    from paddle_tpu.static import serialize as jser
    from paddle_tpu_torch.static import serialize as tser
    _, _, t, j, _ = built
    for k in ("startup", "test", "main"):
        assert tser.program_to_dict(t[k]) == jser.program_to_dict(j[k]), k


def test_program_holds_the_source_network(built):
    """One shared table looked up once per slot, the concat, four fcs,
    softmax, the mean cross-entropy and the batch auc; one Adam update per
    trainable tensor (the table and 4 weights and biases); the test
    program updates nothing."""
    cfg, _, t, _, _ = built
    ops = [op.type for op in t["main"].global_block().ops]
    assert ops.count("embedding") == cfg.sparse_slots
    assert {op.inputs["W"][0] if "W" in op.inputs else
            op.input_names()[-1] for op in t["main"].global_block().ops
            if op.type == "embedding"} == {"SparseFeatFactors"}
    assert ops.count("concat") == 1 and ops.count("mul") == 4
    assert ops.count("relu") == 3 and ops.count("softmax") == 1
    assert ops.count("auc") == 1 and ops.count("apply_optimizer") == 9
    blk = t["main"].global_block()
    trained = [n for n, v in blk.vars.items()
               if getattr(v, "trainable", False) and v.persistable]
    assert sum(int(np.prod(blk.var(n).shape)) for n in trained) == \
        cd.param_count(cfg)
    test_ops = [op.type for op in t["test"].global_block().ops]
    assert "autodiff" not in test_ops and "apply_optimizer" not in test_ops
    assert cd.param_count(cd.ctr_dnn_config()) == 10_431_212


def _train(pt, exe, net, ds, scope, run):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = run(exe, net, ds, scope)
    return res, _printed(out.getvalue())


def _fit(exe, net, ds, scope):
    return exe.train_from_dataset(net["main"], ds,
                                  fetch_list=[net["auc"], net["loss"]],
                                  fetch_info=["auc", "loss"], print_period=2,
                                  scope=scope)


def test_train_from_dataset_equals_jax(built):
    cfg, files, t, j, arrays = built
    scope = tpt.Scope.from_numpy(arrays, "cpu", t["startup"])
    got, got_lines = _train(tpt, tpt.Executor(CPU), t,
                            _dataset(tpt, cfg, t, files), scope, _fit)
    jscope = JScope()
    for n, a in arrays.items():
        jscope.set_var(n, a)
    want, want_lines = _train(jpt, jpt.static.Executor(), j,
                              _dataset(jpt, cfg, j, files), jscope, _fit)
    assert [s for s, _, _ in got_lines] == [2, 4, 6, 8, 10]
    assert [s for s, _, _ in want_lines] == [2, 4, 6, 8, 10]
    for (_, ga, gl), (_, wa, wl) in zip(got_lines, want_lines):
        assert abs(ga - wa) <= TOL and abs(gl - wl) <= TOL
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL)
    for n in arrays:
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=0, atol=TOL, err_msg=n)


def test_infer_from_dataset_leaves_the_parameters(built):
    cfg, files, t, _, arrays = built
    scope = tpt.Scope.from_numpy(arrays, "cpu", t["startup"])
    before = {n: scope.find_var(n).clone() for n in arrays}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        auc, = tpt.Executor(CPU).infer_from_dataset(
            t["test"], _dataset(tpt, cfg, t, files, "QueueDataset"),
            fetch_list=[t["auc"]], fetch_info=["auc"], print_period=3,
            scope=scope)
    assert 0.0 <= float(auc) <= 1.0
    assert [s for s, in re.findall(r"step (\d+): auc=", out.getvalue())] \
        == ["3", "6", "9"]
    for n, v in before.items():
        assert torch.equal(scope.find_var(n), v), n


def test_async_executor_trains_as_train_from_dataset(built):
    cfg, files, t, _, arrays = built
    ref = tpt.Scope.from_numpy(arrays, "cpu", t["startup"])
    want, _ = _train(tpt, tpt.Executor(CPU), t,
                     _dataset(tpt, cfg, t, files, "QueueDataset"), ref,
                     lambda exe, net, ds, sc: exe.train_from_dataset(
                         net["main"], ds, fetch_list=[net["loss"]],
                         scope=sc))
    scope = tpt.Scope.from_numpy(arrays, "cpu", t["startup"])
    ds = tpt.dataio.QueueDataset()
    ds.set_use_var(t["slots"])
    ds.set_batch_size(cfg.batch)
    with tpt.scope_guard(scope):
        got = tpt.static.AsyncExecutor(CPU).run_from_files(
            t["main"], ds, files, 1, [t["loss"]])
    assert ds.filelist == files and ds.thread_num == 1
    np.testing.assert_array_equal(got[0], want[0])
    for n in arrays:
        assert torch.equal(scope.find_var(n), ref.find_var(n)), n


def test_generated_lines_are_the_source_slots(built):
    cfg, files, _, _, _ = built
    with open(files[0]) as f:
        toks = f.readline().split()
    assert toks[0] == str(cfg.dense_dim)
    rest = toks[1 + cfg.dense_dim:]
    assert rest[0::2] == ["1"] * (cfg.sparse_slots + 1)
    ids = [int(v) for v in rest[1::2][:-1]]
    assert all(0 <= i < cfg.sparse_feature_dim for i in ids)
    assert rest[-1] in ("0", "1")
