"""The port's dataset readers (``paddle_tpu_torch/dataio``: ``text_corpus``,
``common``, ``parsers``, ``dataset``, ``image``) against the JAX package's on
the same inputs, on the CPU: the same ids, vocabularies, batches, samples
and errors, compared exactly (numpy arrays by dtype, shape and bytes).

The parsers read the committed fixtures in the real archive formats
(``tests/fixtures/datasets``, as ``tests/test_dataset_parsers.py`` reads
them); ``common``'s readers read small idx, CIFAR and npz files the tests
write; ``download`` fetches a file the test wrote from a local HTTP server
on 127.0.0.1 (no other host is contacted).
"""

import gzip
import hashlib
import http.server
import io
import os
import pickle
import sys
import tarfile
import threading

import numpy as np
import pytest

from paddle_tpu.dataio import common as jcommon
from paddle_tpu.dataio import dataset as jdataset
from paddle_tpu.dataio import image as jimage
from paddle_tpu.dataio import parsers as jparsers
from paddle_tpu.dataio import text_corpus as jtc
from paddle_tpu_torch.dataio import common as tcommon
from paddle_tpu_torch.dataio import dataset as tdataset
from paddle_tpu_torch.dataio import image as timage
from paddle_tpu_torch.dataio import parsers as tparsers
from paddle_tpu_torch.dataio import text_corpus as ttc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "datasets")


def fx(name):
    return os.path.join(FIX, name)


def same(a, b, path="/"):
    """Exact equality of nested samples: numpy arrays by dtype, shape and
    bytes, numpy scalars by type and value, objects by class name and
    attributes."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(b, np.generic):
        assert type(a) is type(b) and a.tobytes() == b.tobytes(), path
    elif isinstance(b, dict):
        assert type(a) is type(b) and list(a) == list(b), path
        for k in b:
            same(a[k], b[k], f"{path}{k}/")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}{i}/")
    elif hasattr(b, "__dict__") and not callable(b):
        assert type(a).__name__ == type(b).__name__, path
        same(vars(a), vars(b), path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def both(fn):
    """``fn`` run on the port's modules and on the JAX package's: the two
    results, readers drained to lists."""
    out = []
    for mods in ((tdataset, tparsers, tcommon, timage, ttc),
                 (jdataset, jparsers, jcommon, jimage, jtc)):
        r = fn(*mods)
        out.append(list(r()) if callable(r) else r)
    return out


# ---------------------------------------------------------------------------
# text_corpus
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(REPO, "tests", "fixtures",
                           "bert_corpus_manifest.txt")) as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")]


@pytest.mark.parametrize("vocab,max_bytes", [(512, 1 << 18),
                                             (30528, 1 << 20)])
def test_build_corpus_same_ids_and_vocab(manifest, vocab, max_bytes):
    got, want = both(lambda d, p, c, i, tc: tc.build_corpus(
        REPO, vocab_size=vocab, max_bytes=max_bytes, files=manifest))
    same(got, want)
    assert got[0].dtype == np.int32 and len(got[0]) > 10_000
    # walking a directory instead of a manifest
    d = os.path.join(REPO, "tests", "fixtures")
    got, want = both(lambda *m: m[4].build_corpus(d, vocab_size=300,
                                                  max_bytes=1 << 16))
    same(got, want)


def test_mlm_batch_stream_same_batches(manifest):
    ids, _ = ttc.build_corpus(REPO, vocab_size=512, max_bytes=1 << 18,
                              files=manifest)
    for kw in (dict(seed=0), dict(seed=3, mask_prob=0.3,
                                  region=(0.5, 1.0))):
        streams = [tc.mlm_batch_stream(ids, 512, 4, 64, **kw)
                   for tc in (ttc, jtc)]
        for _ in range(3):
            same(next(streams[0]), next(streams[1]))
    errs = []
    for tc in (ttc, jtc):
        with pytest.raises(ValueError, match="too small") as ei:
            next(tc.mlm_batch_stream(ids[:60], 512, 2, 64))
        errs.append(str(ei.value))
    assert errs[0] == errs[1]
    assert ttc.__all__ == jtc.__all__
    assert (ttc.PAD_ID, ttc.UNK_ID, ttc.MASK_ID, ttc.RESERVED) == \
        (jtc.PAD_ID, jtc.UNK_ID, jtc.MASK_ID, jtc.RESERVED)


# ---------------------------------------------------------------------------
# common: md5, the data home, download from a local server, the readers
# ---------------------------------------------------------------------------
class _Server:
    """A local HTTP server on 127.0.0.1 serving ``files`` ({path: bytes});
    ``hits`` counts the requests of each path."""

    def __init__(self, files):
        self.files, self.hits = files, {}
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                outer.hits[self.path] = outer.hits.get(self.path, 0) + 1
                body = outer.files.get(self.path)
                if body is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_md5file_data_home_and_switch(tmp_path, monkeypatch):
    p = tmp_path / "f.bin"
    p.write_bytes(os.urandom(3 << 20))
    assert tcommon.md5file(str(p)) == jcommon.md5file(str(p)) == \
        hashlib.md5(p.read_bytes()).hexdigest()
    monkeypatch.setattr(tcommon, "DATA_HOME", str(tmp_path / "home"))
    d = tcommon.data_home("mnist")
    assert d == str(tmp_path / "home" / "mnist") and os.path.isdir(d)
    for v, want in (("1", True), ("on", True), ("0", False), ("no", False)):
        monkeypatch.setenv("PT_DATASET_REAL", v)
        assert tcommon.real_data_enabled() is jcommon.real_data_enabled() \
            is want
    assert tcommon.__all__ == jcommon.__all__
    assert tcommon.MNIST_URLS == jcommon.MNIST_URLS
    assert tcommon.CIFAR10_URL == jcommon.CIFAR10_URL


def test_download_from_a_local_server(tmp_path, monkeypatch):
    blob = os.urandom(100_000)
    md5 = hashlib.md5(blob).hexdigest()
    srv = _Server({"/data/a.bin": blob})
    try:
        for label, mod in (("port", tcommon), ("jax", jcommon)):
            monkeypatch.setattr(mod, "DATA_HOME", str(tmp_path / label))
            monkeypatch.setattr(mod.time, "sleep", lambda s: None)
            path = mod.download(srv.url + "/data/a.bin", "m", md5)
            assert path == str(tmp_path / label / "m" / "a.bin")
            assert open(path, "rb").read() == blob
            # cached under a matching md5: no second request
            n = srv.hits["/data/a.bin"]
            assert mod.download(srv.url + "/data/a.bin", "m", md5) == path
            assert srv.hits["/data/a.bin"] == n
            # save_name, no md5
            assert open(mod.download(srv.url + "/data/a.bin", "m",
                                     save_name="b.bin"), "rb").read() == blob
        # an md5 mismatch: each attempt fetches, fails the check, leaves
        # no .part file; after ``retries`` attempts RuntimeError, the same
        # text from both packages
        errs = []
        for label, mod in (("port", tcommon), ("jax", jcommon)):
            srv.hits.clear()
            with pytest.raises(RuntimeError) as ei:
                mod.download(srv.url + "/data/a.bin", "bad", "0" * 32,
                             retries=3)
            assert srv.hits == {"/data/a.bin": 3}
            d = tmp_path / label / "bad"
            assert os.listdir(d) == []
            errs.append(str(ei.value).replace(str(tmp_path / label), ""))
        assert errs[0] == errs[1] and "md5 mismatch" in errs[0]
        # a missing file: the HTTP error after the retries
        with pytest.raises(RuntimeError, match="after 2 attempts"):
            tcommon.download(srv.url + "/nope", "m", retries=2)
    finally:
        srv.close()


def _idx_files(tmp_path, n=5, rows=3, cols=4, seed=0):
    rng = np.random.RandomState(seed)
    pix = rng.randint(0, 256, (n, rows * cols)).astype(np.uint8)
    lab = rng.randint(0, 10, n).astype(np.uint8)
    imgs = (b"\x00\x00\x08\x03" + n.to_bytes(4, "big")
            + rows.to_bytes(4, "big") + cols.to_bytes(4, "big")
            + pix.tobytes())
    labs = b"\x00\x00\x08\x01" + n.to_bytes(4, "big") + lab.tobytes()
    pi, pl = tmp_path / "imgs.gz", tmp_path / "labs.gz"
    with gzip.open(pi, "wb") as f:
        f.write(imgs)
    with gzip.open(pl, "wb") as f:
        f.write(labs)
    return str(pi), str(pl)


def test_idx_and_mnist_readers(tmp_path, monkeypatch):
    pi, pl = _idx_files(tmp_path)
    same(tcommon._read_idx_images(pi), jcommon._read_idx_images(pi))
    same(tcommon._read_idx_labels(pl), jcommon._read_idx_labels(pl))
    for mod in (tcommon, jcommon):
        monkeypatch.setattr(mod, "download", lambda url, m, md5: (
            pi if "images" in url else pl))
    got, want = both(lambda d, p, c, i, tc: c.mnist_reader("train"))
    same(got, want)
    assert len(got) == 5 and got[0][0].dtype == np.float32


def test_cifar10_reader(tmp_path, monkeypatch):
    rng = np.random.RandomState(1)
    path = tmp_path / "cifar.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        for name in ("data_batch_1", "data_batch_2", "test_batch"):
            blob = pickle.dumps({b"data": rng.randint(
                0, 256, (3, 3072)).astype(np.uint8),
                b"labels": rng.randint(0, 10, 3).tolist()})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    for mod in (tcommon, jcommon):
        monkeypatch.setattr(mod, "download",
                            lambda url, m, md5: str(path))
    for split, n in (("train", 6), ("test", 3)):
        got, want = both(lambda d, p, c, i, tc: c.cifar10_reader(split))
        same(got, want)
        assert len(got) == n


def test_digits_reader_and_the_real_only_dataset(monkeypatch):
    pytest.importorskip("sklearn")
    for split in ("train", "test"):
        got, want = both(lambda d, p, c, i, tc: c.digits_reader(split))
        same(got, want)
        got, want = both(lambda d, *m: getattr(d.digits, split)())
        same(got, want)
    assert len(got) == 359
    # the refusals: no synthetic tier to ask for, and no sklearn -> the
    # same ImportError
    for d in (tdataset, jdataset):
        with pytest.raises(TypeError):
            d.digits.train(source="synthetic")
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    errs = []
    for d in (tdataset, jdataset):
        with pytest.raises(ImportError) as ei:
            d.digits.train()
        errs.append(type(ei.value))
    assert errs[0] is errs[1]


def test_split_cluster_files_reader_and_npz(tmp_path):
    rng = np.random.RandomState(2)
    samples = [(rng.randn(3).astype(np.float32), np.int64(i), [i, i + 1])
               for i in range(7)]

    def reader():
        return iter(samples)
    written = {}
    for label, mod in (("port", tcommon), ("jax", jcommon)):
        d = tmp_path / label
        d.mkdir()
        written[label] = mod.split(reader, 3, suffix=str(d / "%05d.npz"))
        assert [os.path.basename(p) for p in written[label]] == \
            ["00000.npz", "00001.npz", "00002.npz"]
    # each package reads the other's chunk files, the same samples
    for label, mod in (("port", jcommon), ("jax", tcommon)):
        for tid in (0, 1):
            r = mod.cluster_files_reader(str(tmp_path / label / "*.npz"),
                                         2, tid)
            other = (tcommon if mod is jcommon else jcommon)
            same(list(r()), list(other.cluster_files_reader(
                str(tmp_path / label / "*.npz"), 2, tid)()))
    got = list(tcommon.cluster_files_reader(str(tmp_path / "jax" / "*.npz"),
                                            1, 0)())
    assert len(got) == 7
    np.testing.assert_array_equal(got[4][0], samples[4][0])
    buf = io.BytesIO()
    tcommon._npz_dump(samples[:2], buf)
    buf.seek(0)
    same(tcommon._npz_load(buf), jcommon._npz_load(io.BytesIO(
        buf.getvalue())))
    for mod in (tcommon, jcommon):
        with pytest.raises(TypeError, match="object-dtype"):
            mod._npz_dump([(np.array([1, "a"], dtype=object),)], io.BytesIO())
        with pytest.raises(TypeError, match="dumper should be callable"):
            mod.split(reader, 3, dumper=3)


def test_convert_writes_the_jax_recordio_files(tmp_path):
    def reader():
        for i in range(10):
            yield (np.arange(3, dtype=np.float32) + i, np.int64(i))
    paths = {}
    for label, mod in (("port", tcommon), ("jax", jcommon)):
        d = tmp_path / label
        d.mkdir()
        paths[label] = mod.convert(str(d), reader, 4, "train")
    assert [os.path.basename(p) for p in paths["port"]] == \
        [os.path.basename(p) for p in paths["jax"]]
    for p, q in zip(paths["port"], paths["jax"]):
        assert open(p, "rb").read() == open(q, "rb").read()


# ---------------------------------------------------------------------------
# parsers: every function on the real archive formats
# ---------------------------------------------------------------------------
_CONLL = ("conll05st-release/test.wsj/words/test.wsj.words.gz",
          "conll05st-release/test.wsj/props/test.wsj.props.gz")
_FLOWERS = (fx("102flowers_fixture.tgz"), fx("flowers_imagelabels.mat"),
            fx("flowers_setid.mat"))
_IMDB_TRAIN = ("aclImdb/train/pos/.*\\.txt$", "aclImdb/train/neg/.*\\.txt$")


def _imdb_dict(p):
    return p.imdb_build_dict(fx("aclImdb_fixture.tar.gz"),
                             "aclImdb/((train)|(test))/((pos)|(neg))/"
                             ".*\\.txt$", 0)


def _conll_dicts(p):
    return (p.conll05_load_dict(fx("conll05_wordDict.txt")),
            p.conll05_load_dict(fx("conll05_verbDict.txt")),
            p.conll05_load_label_dict(fx("conll05_targetDict.txt")))


PARSER_CASES = {
    "imdb_tokenize": lambda p: list(p.imdb_tokenize(
        fx("aclImdb_fixture.tar.gz"), "aclImdb/train/pos/.*\\.txt$")),
    "imdb_build_dict": _imdb_dict,
    "imdb_reader": lambda p: p.imdb_reader(
        fx("aclImdb_fixture.tar.gz"), *_IMDB_TRAIN, _imdb_dict(p)),
    "imikolov_build_dict": lambda p: p.imikolov_build_dict(
        fx("simple-examples_fixture.tgz"), min_word_freq=0),
    "imikolov_reader": lambda p: p.imikolov_reader(
        fx("simple-examples_fixture.tgz"),
        "./simple-examples/data/ptb.train.txt",
        p.imikolov_build_dict(fx("simple-examples_fixture.tgz"), 0), 5),
    "imikolov_reader_seq": lambda p: p.imikolov_reader(
        fx("simple-examples_fixture.tgz"),
        "./simple-examples/data/ptb.valid.txt",
        p.imikolov_build_dict(fx("simple-examples_fixture.tgz"), 0), 97,
        data_type="seq"),
    "movielens_meta": lambda p: p.movielens_meta(fx("ml-1m_fixture.zip")),
    "movielens_reader": lambda p: p.movielens_reader(
        fx("ml-1m_fixture.zip")),
    "movielens_reader_test": lambda p: p.movielens_reader(
        fx("ml-1m_fixture.zip"), is_test=True, test_ratio=0.5,
        rand_seed=3),
    "wmt14_dicts": lambda p: p.wmt14_dicts(fx("wmt14_fixture.tgz"), 30000),
    "wmt14_reader": lambda p: p.wmt14_reader(
        fx("wmt14_fixture.tgz"), "train/train", 30000),
    "wmt16_build_dict": lambda p: p.wmt16_build_dict(
        fx("wmt16_fixture.tar.gz"), 1000, "en"),
    "wmt16_reader": lambda p: p.wmt16_reader(
        fx("wmt16_fixture.tar.gz"), "wmt16/train", 1000, 1000, "de"),
    "conll05_load_dict": lambda p: p.conll05_load_dict(
        fx("conll05_wordDict.txt")),
    "conll05_load_label_dict": lambda p: p.conll05_load_label_dict(
        fx("conll05_targetDict.txt")),
    "conll05_corpus_reader": lambda p: p.conll05_corpus_reader(
        fx("conll05st_fixture.tar.gz"), *_CONLL),
    "conll05_reader": lambda p: p.conll05_reader(
        p.conll05_corpus_reader(fx("conll05st_fixture.tar.gz"), *_CONLL),
        *_conll_dicts(p)),
    "_bracket_spans_to_bio": lambda p: p._bracket_spans_to_bio(
        ["(A0*", "*)", "(V*)", "(A1*", "*", "*)", "*"]),
    "sentiment_word_dict": lambda p: p.sentiment_word_dict(
        fx("movie_reviews")),
    "sentiment_reader": lambda p: p.sentiment_reader(fx("movie_reviews")),
    "sentiment_reader_test": lambda p: p.sentiment_reader(
        fx("movie_reviews"), split="test"),
    "mq2007_queries": lambda p: p.mq2007_queries(fx("mq2007_fixture.txt")),
    "mq2007_reader": lambda p: p.mq2007_reader(fx("mq2007_fixture.txt")),
    "mq2007_reader_listwise": lambda p: p.mq2007_reader(
        fx("mq2007_fixture.txt"), fmt="listwise"),
    "voc2012_reader": lambda p: p.voc2012_reader(
        fx("voc2012_fixture.tar"), "trainval"),
    "flowers_reader": lambda p: p.flowers_reader(*_FLOWERS, "trnid", None),
    "flowers_reader_mapped": lambda p: p.flowers_reader(
        *_FLOWERS, "tstid", lambda im: im[::2, ::2].astype(np.float32)),
}


@pytest.mark.parametrize("case", sorted(PARSER_CASES))
def test_parser_matches_jax(case):
    fn = PARSER_CASES[case]
    got, want = both(lambda d, p, *rest: fn(p))
    same(got, want)
    assert got not in ([], {}, None), case


def test_every_parser_function_has_a_case():
    names = set(jparsers.__all__) | {"_bracket_spans_to_bio"}
    covered = {c.split("_reader_")[0] if "_reader_" in c else c
               for c in PARSER_CASES}
    covered |= {"imikolov_reader", "movielens_reader", "sentiment_reader",
                "mq2007_reader", "flowers_reader"}
    assert names <= covered, names - covered
    assert tparsers.__all__ == jparsers.__all__


# ---------------------------------------------------------------------------
# dataset: the builtin datasets' synthetic samples and their real readers
# ---------------------------------------------------------------------------
SYNTHETIC = ("mnist", "cifar10", "uci_housing", "imdb", "imikolov",
             "movielens", "wmt14", "wmt16", "conll05", "sentiment",
             "voc2012", "mq2007", "flowers")


@pytest.mark.parametrize("name", SYNTHETIC)
def test_builtin_dataset_same_synthetic_samples(name):
    for split in ("train", "test"):
        got, want = both(lambda d, *m: getattr(getattr(d, name), split)())
        same(got, want)
        assert len(got) > 0


REAL_CASES = {
    "imdb": lambda d: d.imdb.train(d.imdb.word_dict(
        path=fx("aclImdb_fixture.tar.gz"), cutoff=0),
        path=fx("aclImdb_fixture.tar.gz")),
    "imikolov": lambda d: d.imikolov.test(d.imikolov.build_dict(
        0, path=fx("simple-examples_fixture.tgz")), n=3,
        path=fx("simple-examples_fixture.tgz")),
    "movielens": lambda d: [d.movielens.max_movie_id(
        path=fx("ml-1m_fixture.zip")), d.movielens.movie_categories(
        path=fx("ml-1m_fixture.zip")), d.movielens.get_movie_title_dict(
        path=fx("ml-1m_fixture.zip")), list(d.movielens.train(
            path=fx("ml-1m_fixture.zip"))())],
    "wmt14": lambda d: [d.wmt14.get_dict(30000, reverse=True,
                                         path=fx("wmt14_fixture.tgz")),
                        list(d.wmt14.test(30000,
                                          path=fx("wmt14_fixture.tgz"))())],
    "wmt16": lambda d: d.wmt16.validation(1000, 1000,
                                          path=fx("wmt16_fixture.tar.gz")),
    "conll05": lambda d: d.conll05.test(
        tar_path=fx("conll05st_fixture.tar.gz"),
        word_dict=d.conll05.get_dict(
            fx("conll05_wordDict.txt"), fx("conll05_verbDict.txt"),
            fx("conll05_targetDict.txt"))[0],
        verb_dict=d.conll05.get_dict(
            fx("conll05_wordDict.txt"), fx("conll05_verbDict.txt"),
            fx("conll05_targetDict.txt"))[1],
        label_dict=d.conll05.get_dict(
            fx("conll05_wordDict.txt"), fx("conll05_verbDict.txt"),
            fx("conll05_targetDict.txt"))[2]),
    "sentiment": lambda d: d.sentiment.test(fx("movie_reviews")),
    "voc2012": lambda d: d.voc2012.val(fx("voc2012_fixture.tar")),
    "mq2007": lambda d: d.mq2007.test(path=fx("mq2007_fixture.txt"),
                                      fmt="pointwise"),
    "flowers": lambda d: d.flowers.valid(*_FLOWERS),
}


@pytest.mark.parametrize("name", sorted(REAL_CASES))
def test_builtin_dataset_real_reader_matches_jax(name):
    got, want = both(lambda d, *m: REAL_CASES[name](d))
    same(got, want)


def test_real_tier_is_opt_in_the_same_way(monkeypatch):
    monkeypatch.delenv("PT_DATASET_REAL", raising=False)
    for d in (tdataset, jdataset):
        assert not d.mnist._use_real(None)
        with pytest.raises(ValueError):
            d.mnist.train(source="bogus")
    assert tdataset.__all__ == jdataset.__all__


# ---------------------------------------------------------------------------
# image: decoding and the numpy geometry
# ---------------------------------------------------------------------------
def _png(seed, h=21, w=34):
    cv2 = pytest.importorskip("cv2")
    img = np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype(np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("is_color", [True, False])
def test_image_decoding_with_the_decoder_both_pick(tmp_path, is_color):
    data = _png(0)
    got, want = both(lambda d, p, c, i, tc: i.load_image_bytes(data,
                                                               is_color))
    same(got, want)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    got, want = both(lambda d, p, c, i, tc: i.load_image(str(path),
                                                         is_color))
    same(got, want)


def test_image_decoding_falls_back_to_pil_then_refuses(monkeypatch):
    pytest.importorskip("PIL")
    data = _png(1)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got, want = both(lambda d, p, c, i, tc: i.load_image_bytes(data))
    same(got, want)
    monkeypatch.setitem(sys.modules, "PIL", None)
    errs = []
    for mod in (timage, jimage):
        with pytest.raises(RuntimeError) as ei:
            mod.load_image_bytes(data)
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and "cv2 or PIL" in errs[0]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_image_geometry_helpers(dtype):
    img = (np.random.RandomState(3).rand(37, 50, 3) * 255).astype(dtype)
    gray = img[:, :, 0]
    for fn in (lambda i: i._resize_bilinear_np(img, 20, 61),
               lambda i: i._resize_bilinear_np(gray, 9, 9),
               lambda i: i.resize_short(img, 24),
               lambda i: i.to_chw(img),
               lambda i: i.center_crop(img, 30),
               lambda i: i.random_crop(img, 30,
                                       rng=np.random.RandomState(5)),
               lambda i: i.left_right_flip(img),
               lambda i: i.simple_transform(img, 32, 24, True,
                                            mean=[1.0, 2.0, 3.0],
                                            rng=np.random.RandomState(6)),
               lambda i: i.simple_transform(img, 32, 24, False),
               lambda i: i.simple_transform(gray, 32, 24, False,
                                            mean=5.0)):
        same(fn(timage), fn(jimage))
    assert timage.__all__ == jimage.__all__


def test_load_and_transform_and_batch_images_from_tar(tmp_path):
    tar = tmp_path / "imgs.tar"
    label = {}
    with tarfile.open(tar, "w") as tf:
        for i in range(5):
            data = _png(10 + i, 40, 30)
            info = tarfile.TarInfo(f"jpg/image_{i:05d}.png")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
            if i != 2:
                label[info.name] = i % 3
    with tarfile.open(tar) as tf:
        tf.extract("jpg/image_00000.png", tmp_path, filter="data")
    one = str(tmp_path / "jpg" / "image_00000.png")
    same(timage.load_and_transform(one, 32, 24, False),
         jimage.load_and_transform(one, 32, 24, False))
    outs = []
    for mod, name in ((timage, "port"), (jimage, "jax")):
        out = mod.batch_images_from_tar(str(tar), name, label,
                                        num_per_batch=3)
        names = open(os.path.join(out, "batch_names.txt")).read().split()
        batches = [pickle.load(open(n, "rb")) for n in names]
        outs.append(([os.path.basename(n) for n in names], batches))
    same(outs[0], outs[1])
    assert [len(b["data"]) for b in outs[0][1]] == [3, 1]
