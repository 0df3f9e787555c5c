"""The port's native data-path library (``paddle_tpu_torch/native``) against
the JAX package's (``paddle_tpu/native``), on the CPU: each package builds
its own library with g++ from its own sources.

RecordIO files round-trip, plain and deflate-compressed, and a file written
by either package reads in the other; ``parse_multislot`` gives the JAX
package's arrays on int64 and float lines and its error types and texts on
malformed ones; the threaded ``NativeLoader`` gives the JAX loader's record
stream, bulk reads and cursors at 1 and 4 threads, with and without a
shuffle buffer; ``NativeBatcher`` gives its batches (at one parse thread
in order; at four, whose workers race as the JAX package's do, the same
rows).
"""

import os

import numpy as np
import pytest

from paddle_tpu import native as jnative

from paddle_tpu_torch import native as tnative


@pytest.fixture(scope="module")
def libs():
    assert tnative.available() and jnative.available()
    return tnative, jnative


def test_library_builds_from_the_ports_own_sources(libs):
    lib = tnative.get_lib()
    src = os.path.realpath(tnative._SRC_DIR)
    port = os.path.realpath(os.path.dirname(os.path.dirname(
        tnative.__file__)))
    assert src == os.path.join(port, "native", "src")
    assert os.path.realpath(lib._name).startswith(
        os.path.join(port, "_build") + os.sep)
    assert sorted(os.listdir(src)) == sorted(tnative._SOURCES + ["enforce.h"])


@pytest.mark.parametrize("compress", [False, True])
def test_recordio_round_trip(tmp_path, libs, compress):
    recs = [b"", b"x", bytes(range(256)) * 9, b"\n\x00tail"] + \
        [f"rec{i}".encode() for i in range(2500)]
    p = str(tmp_path / "a.recordio")
    with tnative.RecordIOWriter(p, compress=compress,
                                max_chunk_records=300) as w:
        for r in recs:
            w.write(r)
    with tnative.RecordIOScanner(p) as s:
        assert list(s) == recs


@pytest.mark.parametrize("compress", [False, True])
def test_recordio_files_read_across_packages(tmp_path, libs, compress):
    recs = [np.arange(i, dtype=np.int64).tobytes() for i in range(700)]
    for writer, scanner, name in ((tnative, jnative, "t"),
                                  (jnative, tnative, "j")):
        p = str(tmp_path / f"{name}.recordio")
        with writer.RecordIOWriter(p, compress=compress,
                                   max_chunk_records=64) as w:
            for r in recs:
                w.write(r)
        with scanner.RecordIOScanner(p) as s:
            assert list(s) == recs, name
    with open(tmp_path / "t.recordio", "rb") as a, \
            open(tmp_path / "j.recordio", "rb") as b:
        assert a.read() == b.read()


def test_recordio_corruption_raises_ioerror(tmp_path, libs):
    p = tmp_path / "c.recordio"
    with tnative.RecordIOWriter(str(p)) as w:
        for i in range(10):
            w.write(b"abcdef%d" % i)
    raw = bytearray(p.read_bytes())
    raw[-3] ^= 0xFF
    p.write_bytes(bytes(raw))
    with tnative.RecordIOScanner(str(p)) as s, \
            pytest.raises(IOError, match="CRC mismatch"):
        list(s)


@pytest.mark.parametrize("line,slots", [
    ("3 1 2 3 1 -9223372036854775807 2 0.5 -1e-3",
     ["int64", "int64", "float32"]),
    ("1 9007199254740993 4 1.5 2.5 3.5 4.5", ["int64", "float32"]),
    ("2 7 8 0 1 5", ["int32", "float32", "int64"]),
    (b"13 " + b" ".join(b"0.%d" % i for i in range(13)) + b" 1 42 1 1",
     ["float32", "int64", "int64"]),
    ("2 1.25 2.5", 1),
])
def test_parse_multislot_equals_jax(libs, line, slots):
    got = tnative.parse_multislot(line, slots)
    want = jnative.parse_multislot(line, slots)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("line,slots", [
    ("2 1", ["int64"]),
    ("x 1", ["int64"]),
    ("1 1.5", ["int64"]),
    ("1 abc", ["float32"]),
    ("1 1", ["int64", "int64"]),
    ("-1 3", ["int64"]),
])
def test_parse_multislot_errors_equal_jax(libs, line, slots):
    with pytest.raises(ValueError) as got:
        tnative.parse_multislot(line, slots)
    with pytest.raises(ValueError) as want:
        jnative.parse_multislot(line, slots)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def shard_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.RandomState(0)
    paths = []
    for i, n in enumerate((37, 120, 5, 64)):
        p = d / f"s{i}.txt"
        p.write_text("".join(
            f"{i} {r} " + " ".join(map(str, rng.randint(0, 99, 3))) + "\n"
            for r in range(n)))
        paths.append(str(p))
    return paths


def _loader_run(mod, files, nthreads, shuffle, epochs, cut):
    """The whole stream, and the cursor and bulk read after ``cut``
    records."""
    with mod.NativeLoader(files, nthreads=nthreads, shuffle_buffer=shuffle,
                          seed=11, epochs=epochs) as ld:
        head = [next(ld) for _ in range(cut)]
        st = ld.state()
        rest = ld.read_records(10 ** 6)
    return head + rest, st


@pytest.mark.parametrize("nthreads", [1, 4])
@pytest.mark.parametrize("shuffle", [0, 16])
def test_native_loader_stream_and_cursor_equal_jax(libs, shard_files,
                                                   nthreads, shuffle):
    got, got_st = _loader_run(tnative, shard_files, nthreads, shuffle, 2, 57)
    want, want_st = _loader_run(jnative, shard_files, nthreads, shuffle, 2,
                                57)
    assert len(got) == 2 * (37 + 120 + 5 + 64)
    assert got == want
    assert got_st == want_st
    # a loader resumed from the cursor continues the stream
    with tnative.NativeLoader(shard_files, nthreads=nthreads,
                              shuffle_buffer=shuffle, seed=11, epochs=2,
                              start_state=want_st) as ld:
        assert list(ld) == want[57:]


def _batches(mod, files, slots, parse_threads):
    with mod.NativeBatcher(files, slots, 32, read_threads=1,
                           parse_threads=parse_threads,
                           drop_last=False) as b:
        return list(b)


@pytest.mark.parametrize("parse_threads", [1, 4])
def test_native_batcher_equals_jax(tmp_path, libs, parse_threads):
    rng = np.random.RandomState(3)
    files = []
    for i in range(2):
        p = tmp_path / f"ms{i}.txt"
        lines = []
        for _ in range(75):
            k = rng.randint(1, 4)
            ids = " ".join(map(str, rng.randint(0, 10 ** 12, k)))
            dense = " ".join(f"{v:.5f}" for v in rng.rand(3))
            lines.append(f"{k} {ids} 3 {dense} 1 {rng.randint(2)}\n")
        p.write_text("".join(lines))
        files.append(str(p))
    slots = [("ids", "int64"), ("dense", "float32"), ("label", "int64")]
    got = _batches(tnative, files, slots, parse_threads)
    want = _batches(jnative, files, slots, parse_threads)
    assert [b["ids"].shape[0] for b in got] == \
        [b["ids"].shape[0] for b in want] == [32, 32, 32, 32, 22]
    if parse_threads == 1:
        for g, w in zip(got, want):
            for n, _ in slots:
                assert g[n].dtype == w[n].dtype and np.array_equal(g[n], w[n])
        return

    def rows(bs):
        """Each row with its ids' padding cut (a row's batch, and so its
        padded width, may differ between two racing runs)."""
        out = []
        for b in bs:
            for r in range(b["ids"].shape[0]):
                out.append((tuple(np.trim_zeros(b["ids"][r], "b").tolist()),
                            tuple(b["dense"][r].tolist()),
                            tuple(b["label"][r].tolist())))
        return sorted(out)
    assert rows(got) == rows(want)


def test_native_batcher_error_is_ioerror(tmp_path, libs):
    p = tmp_path / "bad.txt"
    p.write_text("1 5 1 0\n1 zz 1 0\n")
    with tnative.NativeBatcher([str(p)], [("a", "int64"), ("b", "int64")],
                               2) as b, pytest.raises(IOError):
        list(b)
