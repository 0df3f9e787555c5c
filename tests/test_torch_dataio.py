"""The port's data path (``dataio``, the prefetch helpers, ``feed_stage``,
``recordio_writer``, ``incubate.data_generator``, ``layers.open_files`` and
``layers.load``) against the JAX package's, on the CPU.

``FileDataLoader`` streams, native and through the Python oracle, are
bitwise the JAX package's, and so are their ``state()`` cursors after k
batches; a cursor resumes across the packages, ranks slice one job-level
stream and ``merge_rank_states`` folds their cursors. The prefetch helpers
keep their contract (order, a failure re-raised in the consumer with its
batch's index, the worker gone after an early close), and a CPU
executor's ``feed_stage`` places a batch that ``Executor.run`` takes
without a copy and without a new runner. The Fluid datasets give the JAX
package's batches, shuffles and hash partition at one thread (more
threads race, in both packages); the exchange of ``global_shuffle`` runs
between two processes on localhost.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.core.enforce import EnforceNotMet as JEnforceNotMet
from paddle_tpu.dataio import dataloader as jdl
from paddle_tpu.dataio import fluid_dataset as jfd
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.incubate import data_generator as jgen

import paddle_tpu_torch as tpt
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.dataio import dataloader as tdl
from paddle_tpu_torch.dataio import fluid_dataset as tfd
from paddle_tpu_torch.incubate import data_generator as tgen
from paddle_tpu_torch.monitor.registry import REGISTRY
from paddle_tpu_torch.static import executor as texe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tpt.CPUPlace()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Three text shards of 'i r a b' records (shard, record, two ints)."""
    d = tmp_path_factory.mktemp("lines")
    rng = np.random.RandomState(1)
    out = []
    for i, n in enumerate((50, 31, 70)):
        p = d / f"part{i}.txt"
        p.write_text("".join(f"{i} {r} {rng.randint(1000)} {rng.rand():.6f}\n"
                             for r in range(n)))
        out.append(str(p))
    return out


def _parse(rec):
    a, b, c, d = rec.split()
    return np.int64(int(a) * 1000 + int(b)), np.float32(float(d))


def _mk(mod, files, **kw):
    kw.setdefault("device_put", False)
    return mod.FileDataLoader(files, _parse, 8, nthreads=kw.pop("nthreads", 2),
                              **kw)


def _equal_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shuffle,nthreads", [(0, 1), (0, 4), (16, 3)])
def test_file_loader_stream_equals_jax(files, native, shuffle, nthreads):
    kw = dict(shuffle_buffer=shuffle, seed=9, epochs=2, drop_last=False,
              nthreads=nthreads)
    got = list(_mk(tdl, files, native=native, **kw))
    want = list(_mk(jdl, files, native=True, **kw))
    assert sum(len(b[0]) for b in got) == 2 * (50 + 31 + 70)
    _equal_batches(got, want)


@pytest.mark.parametrize("native", [True, False])
def test_stateful_cursor_equals_jax_and_resumes_across(files, native):
    kw = dict(shuffle_buffer=8, seed=3, epochs=2, stateful=True)
    t, j = _mk(tdl, files, native=native, **kw), _mk(jdl, files, **kw)
    it_t, it_j = iter(t), iter(j)
    for _ in range(7):
        _equal_batches([next(it_t)], [next(it_j)])
    st = t.state()
    assert st == j.state() and st["version"] == tdl.STATE_VERSION == 2
    rest = list(it_j)
    # the port resumes from the cursor, and so does the JAX loader: both
    # continue the uninterrupted stream bitwise
    r_t = _mk(tdl, files, native=native, **kw)
    r_t.set_state(st)
    r_j = _mk(jdl, files, **kw)
    r_j.set_state(st)
    _equal_batches(list(r_t), rest)
    _equal_batches(list(r_j), rest)
    # one live iterator: a second __iter__ continues, never replays
    t2 = _mk(tdl, files, native=native, **kw)
    first = next(iter(t2))
    again = next(iter(t2))
    assert not np.array_equal(first[0], again[0])


def test_cursor_checks_and_v1_migration_equal_jax(files):
    kw = dict(shuffle_buffer=8, seed=3, stateful=True)
    base = _mk(tdl, files, **kw).state()
    for bad in (dict(base, seed=4), dict(base, nfiles=2),
                dict(base, files=[["x", 1]] * 3)):
        with pytest.raises(ValueError) as got:
            _mk(tdl, files, **kw).set_state(bad)
        with pytest.raises(ValueError) as want:
            _mk(jdl, files, **kw).set_state(bad)
        assert str(got.value) == str(want.value)
    v1 = {"version": 1, "epoch": 1, "epoch_records": 0, "file_index": 0,
          "offset": 0, "records_consumed": 151, "seed": 3,
          "shuffle_buffer": 8, "nfiles": 3}
    assert tdl._migrate_v1_state(v1) == jdl._migrate_v1_state(v1)
    with pytest.raises(RuntimeError, match="non-stateful"):
        _mk(tdl, files).state()


def test_rank_slicing_and_merge_rank_states(files):
    kw = dict(shuffle_buffer=8, seed=5, epochs=-1, stateful=True)
    glob = iter(_mk(tdl, files, native=False, **kw))
    ref = [next(glob) for _ in range(6)]
    r0 = _mk(tdl, files, world_size=2, rank=0, native=True, **kw)
    r1 = _mk(tdl, files, world_size=2, rank=1, native=False, **kw)
    i0, i1 = iter(r0), iter(r1)
    for s in range(3):
        a, b = next(i0), next(i1)
        for f in range(2):
            assert np.array_equal(np.concatenate([a[f], b[f]]), ref[s][f])
    states = [r0.state(), r1.state()]
    frontier = tdl.merge_rank_states(states)
    assert frontier == jdl.merge_rank_states(states)
    one = _mk(tdl, files, **kw)
    one.set_state(frontier)
    _equal_batches([next(iter(one))], [ref[3]])
    with pytest.raises(ValueError, match="diverge"):
        tdl.merge_rank_states([states[0], dict(states[1], epoch=9)])


def test_background_prefetch_order_failure_index_and_close():
    got = list(texe.background_prefetch(iter(range(50)), lambda b: b * 2,
                                        depth=3))
    assert got == [2 * i for i in range(50)]

    def boom():
        yield 0
        yield 1
        raise RuntimeError("record 2 is garbage")

    seen = []
    with pytest.raises(RuntimeError, match="garbage") as ei:
        for b in texe.background_prefetch(boom(), lambda b: b, depth=8):
            seen.append(b)
    assert seen == [0, 1] and ei.value.prefetch_batch_index == 2

    def transform(b):
        if b == 3:
            raise ValueError("bad batch")
        return b
    with pytest.raises(ValueError) as ei:
        list(texe.background_prefetch(iter(range(9)), transform))
    assert ei.value.prefetch_batch_index == 3
    # an early close stops the worker and closes the producer
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()
    before = {t.ident for t in threading.enumerate()}
    it = texe.background_prefetch(endless(), lambda b: b, depth=2)
    assert [next(it) for _ in range(5)] == list(range(5))
    it.close()
    assert closed.wait(10)
    assert not [t for t in threading.enumerate()
                if t.name == "pt-prefetch-worker" and t.ident not in before]


def test_loader_parse_error_names_batch(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("1\n2\n3\n4\nnope\n6\n")
    for native in (True, False):
        ld = tdl.FileDataLoader([str(p)], lambda r: np.float32(r), 2,
                                device_put=False, native=native)
        with pytest.raises(ValueError) as ei:
            list(ld)
        assert ei.value.prefetch_batch_index == 2


def _fit_program():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = tpt.data("x", [4], "float32")
        y = tpt.data("y", [1], "float32")
        loss = tpt.layers.mean(tpt.layers.square_error_cost(
            tpt.layers.fc(x, 1), y))
        tpt.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, loss


def test_feed_stage_on_the_cpu_passes_through_run():
    main, startup, loss = _fit_program()
    exe, scope = tpt.Executor(CPU), tpt.Scope()
    exe.run(startup, scope=scope)
    xb = np.arange(8, dtype=np.float64).reshape(2, 4)
    yb = np.ones((2, 1), np.float32)
    exe.run(main, feed={"x": xb.astype(np.float32), "y": yb},
            fetch_list=[loss], scope=scope)
    traces = exe.trace_count
    put = exe.feed_stage(main, ["x", "y"])
    staged = put((xb, yb))
    assert isinstance(staged, texe.StagedFeed) and staged.event is None
    x_t, y_t = staged.hand_over()
    # cast on the host to the data var's dtype, so run takes it as it is
    assert x_t.dtype == torch.float32 and x_t.device.type == "cpu"
    blk = main.global_block()
    assert exe._as_feed(blk, "x", x_t) is x_t
    exe.run(main, feed={"x": x_t, "y": y_t}, fetch_list=[loss], scope=scope)
    exe.run(main, feed=put({"x": xb, "y": yb}), fetch_list=[loss],
            scope=scope)
    assert exe.trace_count == traces
    batches = [(xb + i, yb) for i in range(5)]
    out = list(texe.device_prefetch(iter(batches), put=put))
    assert [float(b[0][0, 0]) for b in out] == [0.0, 1.0, 2.0, 3.0, 4.0]


def test_hand_over_waits_on_the_event_and_records_the_stream(monkeypatch):
    """At delivery the consumer's stream waits on the copy's event and each
    staged tensor is recorded on it (so the allocator keeps its memory
    while a step reads it): stream and event stand-ins on the CPU."""
    calls = []

    class Stream:
        def wait_event(self, event):
            calls.append(("wait", event))
    stream = Stream()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: calls.append(("record", self, s)))
    event = object()
    batch = (torch.zeros(2), np.ones(3), torch.ones(4))
    staged = texe.StagedFeed(batch, event, torch.device("cpu"))
    assert texe.hand_over(staged) is batch
    assert calls[0] == ("wait", event)
    assert [(c[1].shape, c[2]) for c in calls[1:]] == \
        [((2,), stream), ((4,), stream)]
    assert texe.hand_over(batch) is batch


def test_default_stage_is_the_card(monkeypatch, files):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tpt.NoCudaDeviceError):
        texe.device_prefetch(iter([]))
    with pytest.raises(tpt.NoCudaDeviceError):
        next(iter(tdl.FileDataLoader(files, _parse, 4)))


def test_loader_overlap_metric_counts_the_stage(files):
    before = REGISTRY.get("dataio_h2d_overlap_ms").value()
    exe = tpt.Executor(CPU)
    ld = tdl.FileDataLoader(files, _parse, 8, device_put=exe.feed_stage())
    n = 0
    for a, b in ld:
        assert isinstance(a, torch.Tensor) and a.dtype == torch.int64
        n += a.numel()
    assert n == 144
    assert REGISTRY.get("dataio_h2d_overlap_ms").value() > before


SLOTS = [("ids", "int64"), ("dense", "float32"), ("label", "int64")]


@pytest.fixture(scope="module")
def slot_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("slots")
    rng = np.random.RandomState(7)
    out = []
    for i in range(2):
        p = d / f"ms{i}.txt"
        lines = []
        for _ in range(45):
            k = rng.randint(1, 4)
            ids = " ".join(map(str, rng.randint(1, 10 ** 9, k)))
            dense = " ".join(f"{v:.4f}" for v in rng.rand(2))
            lines.append(f"{k} {ids} 2 {dense} 1 {rng.randint(2)}\n")
        p.write_text("".join(lines))
        out.append(str(p))
    return out


def _dataset(mod, kind, files, batch=16, thread=1, pipe=None):
    ds = mod.DatasetFactory().create_dataset(kind)
    ds.set_filelist(files)
    ds.set_batch_size(batch)
    ds.set_thread(thread)
    ds.set_use_var(SLOTS)
    if pipe is not None:
        ds.set_pipe_command(pipe)
    return ds


def _equal_dicts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_queue_dataset_batches_equal_jax(slot_files):
    _equal_dicts(list(_dataset(tfd, "QueueDataset", slot_files)),
                 list(_dataset(jfd, "QueueDataset", slot_files)))
    # the Python parse path (a pipe command that parses as MultiSlot)
    t = _dataset(tfd, "QueueDataset", slot_files,
                 pipe=lambda ln: tfd._parse_multislot(ln, SLOTS))
    j = _dataset(jfd, "QueueDataset", slot_files,
                 pipe=lambda ln: jfd._parse_multislot(ln, SLOTS))
    _equal_dicts(list(t), list(j))
    with pytest.raises(RuntimeError, match="local_shuffle"):
        t.local_shuffle()


def test_in_memory_dataset_shuffles_and_partition_equal_jax(slot_files):
    t = _dataset(tfd, "InMemoryDataset", slot_files)
    j = _dataset(jfd, "InMemoryDataset", slot_files)
    t.load_into_memory()
    j.load_into_memory()
    assert t.get_memory_data_size() == j.get_memory_data_size() == 90
    _equal_dicts(list(t), list(j))
    t.local_shuffle(5)
    j.local_shuffle(5)
    _equal_dicts(list(t), list(j))

    class Fleet:
        def worker_index(self):
            return 1

        def worker_num(self):
            return 2

        def worker_endpoints(self):
            return []
    t.global_shuffle(Fleet(), seed=2)
    j.global_shuffle(Fleet(), seed=2)
    assert 0 < t.get_memory_data_size() == j.get_memory_data_size() < 90
    _equal_dicts(list(t), list(j))
    t.release_memory()
    assert t.get_memory_data_size() == 0 and list(t) == []


def test_malformed_lines_raise_one_type_on_both_paths(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("1 5 2 0.1 0.2 1 0\n1 zz 2 0.1 0.2 1 0\n")
    for kind in ("QueueDataset", "InMemoryDataset"):
        for pipe in (None, lambda ln: tfd._parse_multislot(ln, SLOTS)):
            ds = _dataset(tfd, kind, [str(p)], batch=2, pipe=pipe)
            with pytest.raises(EnforceNotMet):
                if kind == "InMemoryDataset":
                    ds.load_into_memory()
                list(ds)
    with pytest.raises(EnforceNotMet) as got:
        tfd._parse_multislot("1 zz 2 0.1 0.2 1 0", SLOTS)
    with pytest.raises(JEnforceNotMet) as want:
        jfd._parse_multislot("1 zz 2 0.1 0.2 1 0", SLOTS)
    assert str(got.value) == str(want.value)


_EXCHANGE = r"""
import json, sys
import numpy as np
from paddle_tpu_torch.dataio.sample_exchange import exchange_samples
rank, eps = int(sys.argv[1]), sys.argv[2].split(",")
mine = [(np.asarray([rank * 100 + i], np.int64),
         np.asarray([0.5 * i], np.float32)) for i in range(40)]
got = exchange_samples(mine, eps, rank, timeout=60.0)
print(json.dumps(sorted(int(s[0][0]) for s in got)))
"""


def _free_ports(n):
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_global_shuffle_exchange_between_two_processes():
    from paddle_tpu_torch.dataio.sample_exchange import sample_hash
    eps = ",".join(f"127.0.0.1:{p}" for p in _free_ports(2))
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _EXCHANGE, str(r), eps],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    import json
    got = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    every = [(np.asarray([r * 100 + i], np.int64),
              np.asarray([0.5 * i], np.float32))
             for r in range(2) for i in range(40)]
    for rank in range(2):
        assert got[rank] == sorted(int(s[0][0]) for s in every
                                   if sample_hash(s) % 2 == rank)


def _samples():
    rng = np.random.RandomState(4)
    return [(rng.rand(3).astype(np.float32), np.int64(rng.randint(10)))
            for _ in range(10)]


def test_data_loader_equals_jax():
    assert tpt.io.DataLoader is tpt.dataio.DataLoader
    got, want = [], []
    for mod, out, kw in ((tpt, got, {"places": CPU}), (jpt, want, {})):
        feeds = ["x", "y"]
        dl = mod.io.DataLoader.from_generator(feed_list=feeds, capacity=4,
                                              return_list=True)
        dl.set_sample_generator(lambda: iter(_samples()), 4,
                                drop_last=False, **kw)
        out.extend([[np.asarray(v) for v in b] for b in dl])
    assert [len(b[0]) for b in got] == [4, 4, 2]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(b, a.dtype))
    # a batch generator of dicts flattens in sorted-key order
    dl = tpt.io.DataLoader.from_generator(return_list=True)
    dl.set_batch_generator(lambda: iter([{"b": np.ones(2), "a": np.zeros(1)}]),
                           places=CPU)
    (a, b), = list(dl)
    assert a.shape == (1,) and b.shape == (2,)


def test_data_loader_from_dataset_and_refusals(slot_files):
    ds = _dataset(tfd, "QueueDataset", slot_files, batch=16)
    dl = tpt.dataio.DataLoader.from_dataset(ds, drop_last=False)
    sizes = [b["ids"].shape[0] for b in dl]
    assert sizes == [16] * 5 + [10] and ds.drop_last
    with pytest.raises(RuntimeError, match="from_dataset"):
        dl.set_batch_generator(lambda: iter([]))
    with pytest.raises(ValueError, match="feed_list"):
        tpt.io.DataLoader.from_generator().set_sample_list_generator(
            lambda: iter([]))
    with pytest.raises(NotImplementedError):
        tpt.io.DataLoader(iterable=False)


def _gen_lines(mod, samples):
    import io

    class Gen(mod.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                yield from samples
            return it
    g = Gen()
    g.set_batch(3)
    out = io.StringIO()
    g.run_from_memory(out=out)
    return out.getvalue(), g._proto_info


def test_generator_lines_equal_jax():
    samples = [[("ids", [1, 2, 3]), ("w", [0.5]), ("y", [1])],
               [("ids", [7]), ("w", [1.25]), ("y", [0])]] * 4
    got, want = _gen_lines(tgen, samples), _gen_lines(jgen, samples)
    assert got == want
    assert got[0].splitlines()[0] == "3 1 2 3 1 0.5 1 1"
    for bad in ([("ids", [True])], [("ids", [])], [("ids", ["a"])],
                [(3, [1])]):
        with pytest.raises(ValueError) as e1:
            _gen_lines(tgen, [bad])
        with pytest.raises(ValueError) as e2:
            _gen_lines(jgen, [bad])
        assert str(e1.value) == str(e2.value)


def _records():
    rng = np.random.RandomState(2)
    return [(rng.rand(2, 3).astype(np.float32),
             np.asarray([i], np.int64)) for i in range(9)]


def test_recordio_writer_and_open_files_across_packages(tmp_path):
    from paddle_tpu import native as jnative
    from paddle_tpu.recordio_writer import (
        convert_reader_to_recordio_file as jconvert,
    )
    paths = tpt.recordio_writer.convert_reader_to_recordio_files(
        str(tmp_path / "t"), 4, lambda: iter(_records()))
    assert [os.path.basename(p) for p in paths] == \
        ["t-00000", "t-00001", "t-00002"]
    jpath = str(tmp_path / "j.recordio")
    assert jconvert(jpath, lambda: iter(_records()), compressor=1) == 9
    # the JAX scanner reads the port's records
    import io
    recs = [r for p in paths for r in jnative.RecordIOScanner(p)]
    for r, (a, b) in zip(recs, _records()):
        with np.load(io.BytesIO(r)) as z:
            np.testing.assert_array_equal(z["f0"], a)
            np.testing.assert_array_equal(z["f1"], b)
    shapes, dtypes = [[2, 3], [1]], ["float32", "int64"]
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()), tpt.unique_name.guard():
        rdr = tpt.layers.open_files(paths + [jpath], shapes, dtypes,
                                    pass_num=2)
    jmain = jpt.Program()
    with jpt.static.program_guard(jmain, jpt.Program()), junique.guard():
        jrdr = jpt.layers.open_files(paths + [jpath], shapes, dtypes,
                                     pass_num=2)
    got, want = list(rdr._source()), list(jrdr._source())
    assert len(got) == len(want) == 36
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_layers_load_reads_the_jax_file_format(tmp_path):
    path = str(tmp_path / "w")
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    jprog = jpt.Program()
    with jpt.static.program_guard(jprog, jpt.Program()):
        jv = jprog.global_block().create_var(name="w", shape=[2, 3],
                                             dtype="float32",
                                             persistable=True)
        jpt.static.io.append_save_op(jprog, [jv], path)
    from paddle_tpu.static.executor import Scope as JScope
    jscope = JScope()
    jscope.set_var("w", value)
    jpt.static.Executor().run(jprog, scope=jscope)
    assert os.path.exists(path + ".npz")
    # layers.load in a startup program
    startup = tpt.Program()
    with tpt.program_guard(startup, tpt.Program()):
        w = startup.global_block().create_var(name="w", shape=[2, 3],
                                              dtype="float32",
                                              persistable=True)
        op = tpt.layers.load(w, path)
    assert op.type == "load_combine" and op.attrs["_host"]
    exe, scope = tpt.Executor(CPU), tpt.Scope()
    exe.run(startup, scope=scope)
    np.testing.assert_array_equal(scope.find_var("w").numpy(), value)
    # the host op in a main program: the executor runs it and puts its
    # value on its device; the persistable it writes needs no startup
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()):
        x = tpt.data("x", [3], "float32")
        wv = main.global_block().create_var(name="w", shape=[2, 3],
                                            dtype="float32",
                                            persistable=True)
        tpt.static.io.append_load_op(main, [wv], path + ".npz")
        out = tpt.layers.matmul(x, wv, transpose_y=True)
    (got,) = exe.run(main, feed={"x": np.ones((1, 3), np.float32)},
                     fetch_list=[out], scope=tpt.Scope())
    np.testing.assert_array_equal(got, [[3.0, 12.0]])
