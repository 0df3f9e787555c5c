"""The reader protocol in the port against the JAX package, on the CPU:
the ``reader`` decorators from the same seeds, ``DataFeeder``, and
``layers.py_reader`` in both protocols (iterable, and start/reset with
``EOFException``) through ``Executor.run``: the same batches and losses as
the JAX executor fed by its own py_reader, ``reset`` stopping the staging
thread (``threading.active_count`` back where it began after repeated
cycles), two started readers on one var refused, the batch/shuffle chain,
``random_data_generator``, ``Preprocessor``; ``open_files`` and ``load``
raise naming their ROADMAP item. Values are moved, never computed, so the
comparisons are exact, except the losses (1e-6).
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import reader as jreader
from paddle_tpu.core.enforce import EOFException as JEOF
from paddle_tpu.dataio.feeder import DataFeeder as JFeeder
from paddle_tpu.framework import unique_name as junique
from paddle_tpu.static.program import static_mode_guard

import paddle_tpu_torch as tpt
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.core import EOFException
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.dataio import DataFeeder, PyReader

CPU = tpt.CPUPlace()


@pytest.fixture(autouse=True)
def _eager_mode():
    """Some JAX-package test files leave that package's static mode on for
    later files on their worker (ROADMAP queue 3 note d)."""
    with static_mode_guard(False):
        yield


def _samples(n=7, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(3).astype(np.float32), int(rng.randint(10)))
            for _ in range(n)]


def _src(n=7, seed=0):
    data = _samples(n, seed)
    return lambda: iter(data)


def _eq(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(y, tuple):
            assert isinstance(x, tuple) and len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the decorators
# ---------------------------------------------------------------------------
DECORATED = {
    "map_readers": lambda R: R.map_readers(lambda a, b: (a[0] * 2, b[1]),
                                           _src(), _src(seed=1)),
    "shuffle": lambda R: R.shuffle(_src(9), 4, seed=3),
    "chain": lambda R: R.chain(_src(2), _src(3, 1)),
    "compose": lambda R: R.compose(_src(4), _src(4, 1)),
    "compose_unaligned": lambda R: R.compose(_src(4), _src(2, 1),
                                             check_alignment=False),
    "buffered": lambda R: R.buffered(_src(6), 2),
    "firstn": lambda R: R.firstn(_src(), 3),
    "xmap_readers": lambda R: R.xmap_readers(lambda s: (s[0] + 1, s[1]),
                                             _src(8), 3, 4, order=True),
    "cache": lambda R: R.cache(_src()),
    "multiprocess_reader": lambda R: R.multiprocess_reader(
        [_src(3), _src(2, 1)]),
    "multiprocess_reader_one": lambda R: R.multiprocess_reader([_src(3)]),
    "fake": lambda R: R.Fake()(_src(), 4),
    "bucketed_batch": lambda R: R.bucketed_batch(
        lambda: iter([(np.arange(n), n % 3) for n in (2, 5, 3, 7, 1, 4, 9)]),
        [3, 6], 2),
}


@pytest.mark.parametrize("name", sorted(DECORATED))
def test_decorator_matches_jax(name):
    got, want = DECORATED[name](treader), DECORATED[name](jreader)
    _eq(got(), want())
    _eq(got(), want())          # a second pass (cache replays)


def test_compose_refuses_unaligned_readers_and_pipe_reader_streams():
    for R in (treader, jreader):
        with pytest.raises(R.ComposeNotAligned):
            list(R.compose(_src(4), _src(2))())
    want = list(jreader.PipeReader("printf 'a\\nbb\\nc'").get_line())
    assert list(treader.PipeReader("printf 'a\\nbb\\nc'").get_line()) == \
        want == ["a", "bb", "c"]
    assert sorted(treader.__all__) == sorted(jreader.__all__)


def test_data_feeder_matches_jax():
    samples = [(np.arange(3, dtype=np.float64) + k, k, np.arange(k + 1))
               for k in range(4)]
    got = DataFeeder(["x", "y", "seq"], place=CPU).feed(samples)
    want = JFeeder(["x", "y", "seq"]).feed(samples)
    assert got["x"].dtype == torch.float32          # float64 fields cast
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["seq"].data.numpy(),
                                  np.asarray(want["seq"].data))
    np.testing.assert_array_equal(got["seq"].lengths.numpy(),
                                  np.asarray(want["seq"].lengths))


# ---------------------------------------------------------------------------
# py_reader through the Executor
# ---------------------------------------------------------------------------
def _batches(n=5, seed=2):
    rng = np.random.RandomState(seed)
    return [(rng.randn(4, 3).astype(np.float32),
             rng.randn(4, 1).astype(np.float32)) for _ in range(n)]


def _model(pk, names, double_buffer=True):
    main, startup = pk.Program(), pk.Program()
    with pk.program_guard(main, startup), names.guard():
        rdr = pk.layers.py_reader(capacity=2, shapes=[[4, 3], [4, 1]],
                                  dtypes=["float32", "float32"],
                                  use_double_buffer=double_buffer)
        x, y = pk.layers.read_file(rdr)
        pred = pk.layers.fc(x, 1, param_attr=pk.ParamAttr(
            name="w", initializer=pk.initializer.Constant(0.1)))
        loss = pk.layers.mean(pk.layers.square_error_cost(pred, y))
        pk.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, rdr, loss


def _jax_losses(batches):
    main, startup, rdr, loss = _model(jpt, junique)
    rdr.decorate_tensor_provider(lambda: iter(batches))
    scope, exe = jpt.static.Scope(), jpt.static.Executor()
    exe.run(startup, scope=scope)
    out = []
    rdr.start()
    while True:
        try:
            out.append(float(exe.run(main, fetch_list=[loss],
                                     scope=scope)[0]))
        except JEOF:
            rdr.reset()
            break
    return out


def _port(double_buffer=True):
    main, startup, rdr, loss = _model(tpt, tpt.unique_name, double_buffer)
    scope, exe = tpt.Scope(), tpt.Executor(CPU)
    exe.run(startup, scope=scope)
    return main, rdr, loss, scope, exe


@pytest.mark.parametrize("double_buffer", [True, False])
def test_start_reset_protocol_matches_jax(double_buffer):
    batches = _batches()
    want = _jax_losses(batches)
    main, rdr, loss, scope, exe = _port(double_buffer)
    rdr.decorate_tensor_provider(lambda: iter(batches), places=CPU)
    for _ in range(2):                  # two epochs, two resets
        got = []
        rdr.start()
        with pytest.raises(EOFException, match="reset"):
            while True:
                got.append(float(exe.run(main, fetch_list=[loss],
                                         scope=scope)[0]))
        rdr.reset()
        assert len(got) == len(batches)
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            want = None                 # the second epoch starts moved on


def test_iterable_protocol_yields_the_batches_staged():
    batches = _batches(3)
    main, rdr, loss, scope, exe = _port()
    rdr.decorate_tensor_provider(lambda: iter(batches), places=CPU)
    feeds = list(rdr)
    assert [sorted(f) for f in feeds] == [[v.name for v in rdr.vars]] * 3
    for f, (x, y) in zip(feeds, batches):
        names = [v.name for v in rdr.vars]
        assert isinstance(f[names[0]], torch.Tensor)
        np.testing.assert_array_equal(f[names[0]].numpy(), x)
        np.testing.assert_array_equal(f[names[1]].numpy(), y)
    for f in feeds:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)


def test_reset_stops_the_staging_thread():
    main, rdr, loss, scope, exe = _port()
    rdr.decorate_tensor_provider(lambda: iter(_batches(50)), places=CPU)
    before = threading.active_count()
    for _ in range(5):
        rdr.start()
        exe.run(main, fetch_list=[loss], scope=scope)
        rdr.reset()
    assert threading.active_count() == before
    # an abandoned start is closed by the next one
    rdr.start()
    rdr.start()
    rdr.reset()
    assert threading.active_count() == before


def test_reader_errors_reach_the_consumer():
    def bad():
        yield _batches(1)[0]
        raise ValueError("broken source")
    main, rdr, loss, scope, exe = _port()
    rdr.decorate_tensor_provider(bad, places=CPU)
    rdr.start()
    exe.run(main, fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match="broken source"):
        exe.run(main, fetch_list=[loss], scope=scope)
    rdr.reset()


def test_two_started_readers_on_one_var_are_refused():
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        rdr = tpt.layers.py_reader(2, [[4, 3]], ["float32"])
        x = tpt.layers.read_file(rdr)
        loss = tpt.layers.mean(x)
        chained = tpt.layers.batch(rdr, 2)
    src = [(np.ones((4, 3), np.float32),)] * 4
    rdr.decorate_tensor_provider(lambda: iter(src), places=CPU)
    rdr.start()
    chained.start()
    exe = tpt.Executor(CPU)
    with pytest.raises(EnforceNotMet, match="two started readers"):
        exe.run(main, fetch_list=[loss], scope=tpt.Scope())
    rdr.reset()
    chained.reset()


def test_batch_and_shuffle_chains_match_jax():
    def chain(pk, names):
        main = pk.Program()
        with pk.program_guard(main, pk.Program()), names.guard():
            rdr = pk.layers.py_reader(2, [[3], [1]], ["float32", "int64"],
                                      use_double_buffer=False)
            return pk.layers.batch(pk.layers.shuffle(rdr, 3, seed=5), 2), rdr
    recs = [(np.arange(3, dtype=np.float32) + k, np.array([k]))
            for k in range(7)]
    (tb, tr), (jb, jr) = chain(tpt, tpt.unique_name), chain(jpt, junique)
    tr.decorate_tensor_provider(lambda: iter(recs), places=CPU)
    jr.decorate_tensor_provider(lambda: iter(recs))
    got, want = list(tb), list(jb)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


def test_random_data_generator_and_preprocessor():
    # each package names its reader vars from its own process-wide
    # counter: fresh counters keep the two names equal whatever ran before
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()), tpt.unique_name.guard():
        rdr = tpt.layers.random_data_generator(-1.0, 1.0, [[2, 3]], seed=4)
    jmain = jpt.Program()
    with jpt.static.program_guard(jmain, jpt.Program()), junique.guard():
        jrdr = jpt.layers.random_data_generator(-1.0, 1.0, [[2, 3]], seed=4)
    got = next(iter(rdr._source()))
    want = next(iter(jrdr._source()))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # Preprocessor: the batch through a sub-program on the CPU
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()):
        base = tpt.layers.py_reader(2, [[2, 3]], ["float32"],
                                    use_double_buffer=False)
        p = tpt.layers.Preprocessor(base, place=CPU)
        with p.block():
            (x,) = p.inputs()
            p.outputs(tpt.layers.scale(x, 2.0))
        (out_var,) = p.vars
    data = [(np.ones((2, 3), np.float32),)] * 2
    base.decorate_tensor_provider(lambda: iter(data), places=CPU)
    feeds = list(p)
    assert len(feeds) == 2
    np.testing.assert_array_equal(feeds[0][out_var.name].numpy(),
                                  np.full((2, 3), 2.0, np.float32))


def test_double_buffer_create_by_data_and_refusals():
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()):
        x = tpt.data("x", [3])
        rdr = tpt.layers.create_py_reader_by_data(2, [x],
                                                  use_double_buffer=False)
        assert tpt.layers.double_buffer(rdr) is rdr and rdr.use_double_buffer
        assert tpt.layers.read_file(rdr) is x
        assert main._py_readers == [rdr]
        with pytest.raises(EnforceNotMet, match="queue 1 item 10"):
            tpt.layers.open_files(["f.recordio"], [[3]], ["float32"])
        with pytest.raises(EnforceNotMet, match="queue 1 item 10"):
            tpt.layers.load(x, "f.npz")
    with pytest.raises(EnforceNotMet, match="no data source"):
        iter(rdr)
    buffered = tpt.layers.double_buffer(_src(3))
    _eq(buffered(), _src(3)())


def test_prepare_then_the_reader_protocol():
    """prepare() with the reader's (shape, dtype) pairs builds the one
    runner the start/reset loop then uses."""
    main, rdr, loss, scope, exe = _port()
    names = [v.name for v in rdr.vars]
    assert exe.prepare(main, feed={names[0]: ((4, 3), "float32"),
                                   names[1]: ((4, 1), np.float32)},
                       fetch_list=[loss], scope=scope)
    rdr.decorate_tensor_provider(lambda: iter(_batches(3)), places=CPU)
    rdr.start()
    for _ in range(3):
        exe.run(main, fetch_list=[loss], scope=scope)
    with pytest.raises(EOFException):
        exe.run(main, fetch_list=[loss], scope=scope)
    rdr.reset()
    assert exe.trace_count == 1


def test_staging_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = PyReader(capacity=2)
    with pytest.raises(tpt.NoCudaDeviceError):
        r.decorate_batch_generator(lambda: iter([]))
