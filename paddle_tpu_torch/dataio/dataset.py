"""Builtin datasets (synthetic by default, reference-shaped).

The port of ``paddle_tpu/dataio/dataset.py``: host code on numpy, the same
samples, ids and errors for the same inputs and seeds.

Parity: python/paddle/dataset/{mnist,cifar,uci_housing,imdb,imikolov,
movielens,…}.py — same reader contract (`train()`/`test()` return
zero-arg callables yielding tuples), same sample shapes/ranges, but
deterministic synthetic data so tests are hermetic (the reference
downloads with md5 caching, dataset/common.py).

Real corpora are OPT-IN: set ``PT_DATASET_REAL=1`` (or pass
``source="real"``) and mnist/cifar10 route through
dataio.common's download+md5 cache (the reference's
dataset/common.py contract, same md5 pins).
"""

import numpy as np

__all__ = ["mnist", "cifar10", "uci_housing", "imdb", "imikolov"]


class _Synthetic:
    def __init__(self, make_sample, n_train, n_test, seed=7):
        self._make = make_sample
        self.n_train = n_train
        self.n_test = n_test
        self.seed = seed

    def train(self):
        def reader():
            rng = np.random.RandomState(self.seed)
            for _ in range(self.n_train):
                yield self._make(rng)
        return reader

    def test(self):
        def reader():
            rng = np.random.RandomState(self.seed + 1)
            for _ in range(self.n_test):
                yield self._make(rng)
        return reader


class _MaybeReal(_Synthetic):
    """Synthetic by default; ``source="real"`` (or PT_DATASET_REAL=1)
    switches to the downloaded corpus via ``real_factory(split)``."""

    def __init__(self, make_sample, n_train, n_test, real_factory,
                 seed=7):
        super().__init__(make_sample, n_train, n_test, seed)
        self._real_factory = real_factory

    def _use_real(self, source):
        if source is None:
            from paddle_tpu_torch.dataio.common import real_data_enabled
            return real_data_enabled()
        if source not in ("synthetic", "real"):
            raise ValueError(f"source must be synthetic|real, "
                             f"got {source!r}")
        return source == "real"

    def train(self, source=None):
        if self._use_real(source):
            return self._real_factory("train")
        return super().train()

    def test(self, source=None):
        if self._use_real(source):
            return self._real_factory("test")
        return super().test()


def _mnist_sample(rng):
    img = rng.uniform(-1, 1, size=(784,)).astype(np.float32)
    label = rng.randint(0, 10)
    return img, label


def _mnist_real(split):
    from paddle_tpu_torch.dataio import common
    return common.mnist_reader(split)


mnist = _MaybeReal(_mnist_sample, n_train=1024, n_test=256,
                   real_factory=_mnist_real)


def _cifar_sample(rng):
    img = rng.uniform(0, 1, size=(3, 32, 32)).astype(np.float32)
    label = rng.randint(0, 10)
    return img.reshape(-1), label


def _cifar_real(split):
    from paddle_tpu_torch.dataio import common
    return common.cifar10_reader(split)


cifar10 = _MaybeReal(_cifar_sample, n_train=1024, n_test=256,
                     real_factory=_cifar_real)


def _housing_sample(rng):
    x = rng.uniform(-1, 1, size=(13,)).astype(np.float32)
    w = np.linspace(-0.5, 0.5, 13).astype(np.float32)
    y = np.array([float(x @ w) + 0.1 * rng.randn()], np.float32)
    return x, y


uci_housing = _Synthetic(_housing_sample, n_train=512, n_test=128)

IMDB_VOCAB = 5147  # matches paddle.dataset.imdb word_dict size order


def _imdb_sample(rng):
    n = rng.randint(8, 100)
    words = rng.randint(0, IMDB_VOCAB, size=(n,)).astype(np.int64)
    label = rng.randint(0, 2)
    return words, label


class _Downloadable:
    """Shared download tier for the real-corpus datasets: subclasses
    pin URL/MD5/MODULE (the reference's per-module constants) and
    ``path`` overrides the download — that is how CI proves the
    parsers on in-tree fixtures in zero-egress environments."""

    URL = MD5 = MODULE = None

    def _archive(self, path):
        if path is not None:
            return path
        from paddle_tpu_torch.dataio.common import download
        return download(self.URL, self.MODULE, self.MD5)


class _Imdb(_Downloadable, _Synthetic):
    """paddle.dataset.imdb parity: no-arg train()/test() serve the
    synthetic tier; passing ``word_idx`` (and optionally ``path`` to a
    local aclImdb-format tarball) runs the REAL parser
    (ref: dataset/imdb.py:96-138). Downloads stay network-gated."""

    URL = ("http://ai.stanford.edu/%7Eamaas/data/sentiment/"
           "aclImdb_v1.tar.gz")
    MD5 = "7c2ac02c03563afcf9b574c7e56c153a"
    MODULE = "imdb"

    def build_dict(self, pattern, cutoff, path=None):
        from paddle_tpu_torch.dataio import parsers
        return parsers.imdb_build_dict(self._archive(path), pattern,
                                       cutoff)

    def word_dict(self, path=None, cutoff=150):
        return self.build_dict(
            r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$",
            cutoff, path)

    def train(self, word_idx=None, path=None):
        if word_idx is None:
            return super().train()
        from paddle_tpu_torch.dataio import parsers
        return parsers.imdb_reader(
            self._archive(path), r"aclImdb/train/pos/.*\.txt$",
            r"aclImdb/train/neg/.*\.txt$", word_idx)

    def test(self, word_idx=None, path=None):
        if word_idx is None:
            return super().test()
        from paddle_tpu_torch.dataio import parsers
        return parsers.imdb_reader(
            self._archive(path), r"aclImdb/test/pos/.*\.txt$",
            r"aclImdb/test/neg/.*\.txt$", word_idx)


imdb = _Imdb(_imdb_sample, n_train=512, n_test=128)

IMIKOLOV_VOCAB = 2074


def _imikolov_sample(rng):
    return tuple(rng.randint(0, IMIKOLOV_VOCAB) for _ in range(5))


class _Imikolov(_Downloadable, _Synthetic):
    """paddle.dataset.imikolov parity (ref: dataset/imikolov.py): real
    PTB n-gram/seq readers when ``word_idx`` is given."""

    URL = "http://www.fit.vutbr.cz/~imikolov/rnnlm/simple-examples.tgz"
    MD5 = "30177ea32e27c525793142b6bf2c8e2d"
    MODULE = "imikolov"
    NGRAM, SEQ = "ngram", "seq"

    def build_dict(self, min_word_freq=50, path=None):
        from paddle_tpu_torch.dataio import parsers
        return parsers.imikolov_build_dict(self._archive(path),
                                           min_word_freq)

    def train(self, word_idx=None, n=5, data_type="ngram", path=None):
        if word_idx is None:
            return super().train()
        from paddle_tpu_torch.dataio import parsers
        return parsers.imikolov_reader(
            self._archive(path), parsers.IMIKOLOV_TRAIN, word_idx, n,
            data_type)

    def test(self, word_idx=None, n=5, data_type="ngram", path=None):
        if word_idx is None:
            return super().test()
        from paddle_tpu_torch.dataio import parsers
        return parsers.imikolov_reader(
            self._archive(path), parsers.IMIKOLOV_VALID, word_idx, n,
            data_type)


imikolov = _Imikolov(_imikolov_sample, n_train=512, n_test=128)


# -- remaining reference dataset family (python/paddle/dataset/) ----------
MOVIELENS_USERS, MOVIELENS_MOVIES, MOVIELENS_CATEGORIES = 6040, 3952, 18


def _movielens_sample(rng):
    """movielens.py: (user_id, gender, age, job, movie_id,
    category-id list, title words, rating)."""
    user = rng.randint(1, MOVIELENS_USERS + 1)
    gender = rng.randint(0, 2)
    age = rng.randint(0, 7)
    job = rng.randint(0, 21)
    movie = rng.randint(1, MOVIELENS_MOVIES + 1)
    # variable-length category-id list (CATEGORIES_DICT indices), like
    # MovieInfo.value() — NOT a one-hot
    cats = rng.choice(MOVIELENS_CATEGORIES, size=rng.randint(1, 4),
                      replace=False).astype(np.int64)
    title = rng.randint(0, 5175, size=(rng.randint(1, 6),)).astype(np.int64)
    rating = float(rng.randint(1, 6))
    return user, gender, age, job, movie, cats, title, rating


class _Movielens(_Downloadable, _Synthetic):
    """paddle.dataset.movielens parity (ref: dataset/movielens.py):
    ``path`` to an ml-1m.zip-format archive enables the real parser;
    meta queries (max ids, dicts) come from one cached parse."""

    URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"
    MD5 = "c4d9eecfca2ab87c1945afe126590906"
    MODULE = "movielens"
    _meta_cache = None

    @property
    def age_table(self):
        from paddle_tpu_torch.dataio import parsers
        return tuple(parsers.MOVIELENS_AGE_TABLE)

    def _meta(self, path):
        archive = self._archive(path)
        if self._meta_cache is None or self._meta_cache[0] != archive:
            from paddle_tpu_torch.dataio import parsers
            self._meta_cache = (archive,
                                parsers.movielens_meta(archive))
        return self._meta_cache[1]

    def _real_reader(self, path, is_test):
        from paddle_tpu_torch.dataio import parsers
        archive = self._archive(path)
        return parsers.movielens_reader(archive, is_test=is_test,
                                        meta=self._meta(path))

    def train(self, path=None):
        if path is None:
            return super().train()
        return self._real_reader(path, is_test=False)

    def test(self, path=None):
        if path is None:
            return super().test()
        return self._real_reader(path, is_test=True)

    def get_movie_title_dict(self, path=None):
        return self._meta(path)[3]

    def movie_categories(self, path=None):
        return self._meta(path)[2]

    def max_movie_id(self, path=None):
        return max(self._meta(path)[0])

    def max_user_id(self, path=None):
        return max(self._meta(path)[1])

    def max_job_id(self, path=None):
        return max(u[3] for u in self._meta(path)[1].values())

    def movie_info(self, path=None):
        return self._meta(path)[0]

    def user_info(self, path=None):
        return self._meta(path)[1]


movielens = _Movielens(_movielens_sample, n_train=1024, n_test=256)

WMT14_DICT_SIZE = 30000
WMT16_DICT_SIZE = 10000


def _wmt_sample(vocab):
    def make(rng):
        """(src ids, tgt ids, tgt-next ids) — the seq2seq triple
        wmt14/wmt16.py yield (with <s>/<e> at ids 0/1)."""
        ns = rng.randint(4, 30)
        nt = rng.randint(4, 30)
        # src wrapped in <s>=0 ... <e>=1 like the reference
        src = np.concatenate(
            [[0], rng.randint(2, vocab, size=(ns,)), [1]]).astype(np.int64)
        tgt = np.concatenate([[0], rng.randint(2, vocab, size=(nt,))]) \
            .astype(np.int64)
        tgt_next = np.concatenate([tgt[1:], [1]]).astype(np.int64)
        return src, tgt, tgt_next
    return make


class _Wmt14(_Downloadable, _Synthetic):
    """paddle.dataset.wmt14 parity (ref: dataset/wmt14.py): real
    parallel-corpus reader when ``dict_size`` is given."""

    URL = "http://paddlemodels.bj.bcebos.com/wmt/wmt14.tgz"
    MD5 = "0791583d57d5beb693b9414c5b36798c"
    MODULE = "wmt14"

    def train(self, dict_size=None, path=None):
        if dict_size is None:
            return super().train()
        from paddle_tpu_torch.dataio import parsers
        return parsers.wmt14_reader(self._archive(path), "train/train",
                                    dict_size)

    def test(self, dict_size=None, path=None):
        if dict_size is None:
            return super().test()
        from paddle_tpu_torch.dataio import parsers
        return parsers.wmt14_reader(self._archive(path), "test/test",
                                    dict_size)

    def get_dict(self, dict_size, reverse=False, path=None):
        from paddle_tpu_torch.dataio import parsers
        src, trg = parsers.wmt14_dicts(self._archive(path), dict_size)
        if reverse:
            src = {v: k for k, v in src.items()}
            trg = {v: k for k, v in trg.items()}
        return src, trg


class _Wmt16(_Downloadable, _Synthetic):
    """paddle.dataset.wmt16 parity (ref: dataset/wmt16.py): dicts built
    from the train split with <s>/<e>/<unk> pinned at 0/1/2."""

    URL = ("http://paddlemodels.bj.bcebos.com/wmt/wmt16.tar.gz")
    MD5 = "0c38be43600334966403524a40dcd81e"
    MODULE = "wmt16"

    def _reader(self, split, src_dict_size, trg_dict_size, src_lang,
                path):
        from paddle_tpu_torch.dataio import parsers
        # an omitted trg size mirrors src (never None: a None size
        # would silently build the full target vocab and hand a model
        # sized to src_dict_size out-of-range ids)
        if trg_dict_size is None:
            trg_dict_size = src_dict_size
        return parsers.wmt16_reader(self._archive(path),
                                    f"wmt16/{split}", src_dict_size,
                                    trg_dict_size, src_lang)

    def train(self, src_dict_size=None, trg_dict_size=None,
              src_lang="en", path=None):
        if src_dict_size is None:
            return super().train()
        return self._reader("train", src_dict_size, trg_dict_size,
                            src_lang, path)

    def test(self, src_dict_size=None, trg_dict_size=None,
             src_lang="en", path=None):
        if src_dict_size is None:
            return super().test()
        return self._reader("test", src_dict_size, trg_dict_size,
                            src_lang, path)

    def validation(self, src_dict_size, trg_dict_size, src_lang="en",
                   path=None):
        return self._reader("val", src_dict_size, trg_dict_size,
                            src_lang, path)

    def get_dict(self, lang, dict_size, reverse=False, path=None):
        from paddle_tpu_torch.dataio import parsers
        d = parsers.wmt16_build_dict(self._archive(path), dict_size,
                                     lang)
        return {v: k for k, v in d.items()} if reverse else d


wmt14 = _Wmt14(_wmt_sample(WMT14_DICT_SIZE), n_train=512, n_test=128)
wmt16 = _Wmt16(_wmt_sample(WMT16_DICT_SIZE), n_train=512, n_test=128)

CONLL05_WORD_VOCAB, CONLL05_LABELS = 44068, 59


CONLL05_PRED_VOCAB = 3162


def _conll05_sample(rng):
    """conll05.py SRL 9-tuple: (words, ctx_n2, ctx_n1, ctx_0, ctx_p1,
    ctx_p2, predicate, mark, labels) — length-aligned id sequences."""
    n = rng.randint(5, 40)
    seq = lambda hi: rng.randint(0, hi, size=(n,)).astype(np.int64)
    return (seq(CONLL05_WORD_VOCAB),) \
        + tuple(seq(CONLL05_WORD_VOCAB) for _ in range(5)) \
        + (seq(CONLL05_PRED_VOCAB), seq(2), seq(CONLL05_LABELS))


class _Conll05(_Synthetic):
    """paddle.dataset.conll05 parity (ref: dataset/conll05.py): real
    SRL readers over a conll05st tarball + dict files."""

    def get_dict(self, word_dict_path, verb_dict_path,
                 label_dict_path):
        from paddle_tpu_torch.dataio import parsers
        return (parsers.conll05_load_dict(word_dict_path),
                parsers.conll05_load_dict(verb_dict_path),
                parsers.conll05_load_label_dict(label_dict_path))

    def reader(self, tar_path, words_name, props_name, word_dict,
               verb_dict, label_dict):
        from paddle_tpu_torch.dataio import parsers
        corpus = parsers.conll05_corpus_reader(tar_path, words_name,
                                               props_name)
        return parsers.conll05_reader(corpus, word_dict, verb_dict,
                                      label_dict)

    def test(self, tar_path=None, word_dict=None, verb_dict=None,
             label_dict=None, words_name=("conll05st-release/test.wsj/"
                                          "words/test.wsj.words.gz"),
             props_name=("conll05st-release/test.wsj/props/"
                         "test.wsj.props.gz")):
        if tar_path is None:
            return super().test()
        return self.reader(tar_path, words_name, props_name,
                           word_dict, verb_dict, label_dict)


conll05 = _Conll05(_conll05_sample, n_train=512, n_test=128)


SENTIMENT_VOCAB = 39768   # NLTK movie_reviews word-dict size order


def _sentiment_sample(rng):
    n = rng.randint(8, 60)
    return (rng.randint(0, SENTIMENT_VOCAB, size=(n,)).astype(np.int64),
            rng.randint(0, 2))


class _Sentiment(_Synthetic):
    """paddle.dataset.sentiment parity (ref: dataset/sentiment.py):
    real NLTK movie_reviews-layout readers when ``root`` is given."""

    def get_word_dict(self, root):
        from paddle_tpu_torch.dataio import parsers
        return parsers.sentiment_word_dict(root)

    def train(self, root=None):
        if root is None:
            return super().train()
        from paddle_tpu_torch.dataio import parsers
        return parsers.sentiment_reader(root, "train")

    def test(self, root=None):
        if root is None:
            return super().test()
        from paddle_tpu_torch.dataio import parsers
        return parsers.sentiment_reader(root, "test")


sentiment = _Sentiment(_sentiment_sample, n_train=512, n_test=128)


def _voc2012_sample(rng):
    """voc2012.py: (image CHW float, segmentation label HW int32)."""
    img = rng.uniform(0, 1, size=(3, 64, 64)).astype(np.float32)
    seg = rng.randint(0, 21, size=(64, 64)).astype(np.int32)
    return img, seg


class _Voc2012(_Synthetic):
    """paddle.dataset.voc2012 parity (ref: dataset/voc2012.py): real
    VOC-tar segmentation readers when ``path`` is given; same
    split->set-file mapping (train:trainval, test:train, val:val)."""

    def train(self, path=None):
        if path is None:
            return super().train()
        from paddle_tpu_torch.dataio import parsers
        return parsers.voc2012_reader(path, "trainval")

    def test(self, path=None):
        if path is None:
            return super().test()
        from paddle_tpu_torch.dataio import parsers
        return parsers.voc2012_reader(path, "train")

    def val(self, path):
        from paddle_tpu_torch.dataio import parsers
        return parsers.voc2012_reader(path, "val")


voc2012 = _Voc2012(_voc2012_sample, n_train=128, n_test=32)


def _mq2007_sample(rng):
    """mq2007.py pairwise form: (label, query-doc features a,
    features b) — label FIRST, like the reference's yield."""
    fa = rng.uniform(0, 1, size=(46,)).astype(np.float32)
    fb = rng.uniform(0, 1, size=(46,)).astype(np.float32)
    return float(rng.randint(0, 2)), fa, fb


class _Mq2007(_Synthetic):
    """paddle.dataset.mq2007 parity (ref: dataset/mq2007.py): real
    LETOR readers (pointwise/pairwise/listwise) when ``path`` is
    given."""

    def train(self, path=None, fmt="pairwise"):
        if path is None:
            return super().train()
        from paddle_tpu_torch.dataio import parsers
        return parsers.mq2007_reader(path, fmt)

    def test(self, path=None, fmt="pairwise"):
        if path is None:
            return super().test()
        from paddle_tpu_torch.dataio import parsers
        return parsers.mq2007_reader(path, fmt)


mq2007 = _Mq2007(_mq2007_sample, n_train=512, n_test=128)


def _flowers_sample(rng):
    img = rng.uniform(0, 1, size=(3, 224, 224)).astype(np.float32)
    return img, rng.randint(0, 102)


class _Flowers(_Synthetic):
    """paddle.dataset.flowers parity (ref: dataset/flowers.py): real
    102flowers readers when the three archive paths are given."""

    def _reader(self, data_tar, label_mat, setid_mat, split, mapper):
        from paddle_tpu_torch.dataio import parsers
        return parsers.flowers_reader(data_tar, label_mat, setid_mat,
                                      split, mapper)

    def train(self, data_tar=None, label_mat=None, setid_mat=None,
              mapper=None):
        if data_tar is None:
            return super().train()
        return self._reader(data_tar, label_mat, setid_mat, "trnid",
                            mapper)

    def test(self, data_tar=None, label_mat=None, setid_mat=None,
             mapper=None):
        if data_tar is None:
            return super().test()
        return self._reader(data_tar, label_mat, setid_mat, "tstid",
                            mapper)

    def valid(self, data_tar, label_mat, setid_mat, mapper=None):
        return self._reader(data_tar, label_mat, setid_mat, "valid",
                            mapper)


flowers = _Flowers(_flowers_sample, n_train=256, n_test=64)

__all__ += ["movielens", "wmt14", "wmt16", "conll05", "sentiment",
            "voc2012", "mq2007", "flowers"]


class _RealOnly:
    """Dataset whose train()/test() always serve a REAL local corpus
    (no network, no synthetic fallback needed)."""

    def __init__(self, factory):
        self._factory = factory

    def train(self):
        return self._factory("train")

    def test(self):
        return self._factory("test")


def _digits_factory(split):
    from paddle_tpu_torch.dataio.common import digits_reader
    return digits_reader(split)


# real handwritten digits, available offline (sklearn bundle) — the
# zero-egress stand-in for dataset.mnist in convergence runs
# (BASELINE.md "Real-data convergence")
digits = _RealOnly(_digits_factory)

__all__ += ["digits"]


# fluid namespace parity: paddle.dataset.common (download cache +
# split/cluster_files_reader/convert file sharding)
from paddle_tpu_torch.dataio import common  # noqa: E402,F401
