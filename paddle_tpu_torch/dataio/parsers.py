"""Real-format corpus parsers for the builtin dataset family.

The port of ``paddle_tpu/dataio/parsers.py``: host code on numpy, the same
samples, ids and errors for the same inputs and seeds.

Each function parses the REAL archive/file format the reference
downloads — aclImdb tarballs, PTB tgz, ml-1m.zip, WMT parallel-corpus
tars, CoNLL-2005 bracket-label props, NLTK movie_reviews layout, LETOR
text, VOC tars, 102flowers — from a LOCAL path, so the same code serves
the downloaded corpus and the small in-tree fixtures CI parses
(zero-egress environments prove the parsers on fixtures; the download
tier is gated in dataio.dataset).

Semantics match the reference parsers exactly (vocab sort orders,
special-token ids, length filters, split rules):
 - imdb:      python/paddle/dataset/imdb.py:38-93
 - imikolov:  python/paddle/dataset/imikolov.py:40-110
 - movielens: python/paddle/dataset/movielens.py:48-175
 - wmt14:     python/paddle/dataset/wmt14.py:56-115
 - wmt16:     python/paddle/dataset/wmt16.py:62-145
 - conll05:   python/paddle/dataset/conll05.py:36-202
 - sentiment: python/paddle/dataset/sentiment.py:56-132
 - mq2007:    python/paddle/dataset/mq2007.py:85-240
 - voc2012:   python/paddle/dataset/voc2012.py:44-66
 - flowers:   python/paddle/dataset/flowers.py:76-143
"""

import collections
import gzip
import io
import os
import re
import string
import tarfile
import zipfile

import numpy as np

__all__ = [
    "imdb_tokenize", "imdb_build_dict", "imdb_reader",
    "imikolov_build_dict", "imikolov_reader",
    "movielens_meta", "movielens_reader",
    "wmt14_dicts", "wmt14_reader",
    "wmt16_build_dict", "wmt16_reader",
    "conll05_corpus_reader", "conll05_reader", "conll05_load_dict",
    "conll05_load_label_dict",
    "sentiment_word_dict", "sentiment_reader",
    "mq2007_queries", "mq2007_reader",
    "voc2012_reader", "flowers_reader",
]


# -- imdb (aclImdb_v1.tar.gz) ---------------------------------------------

def imdb_tokenize(tar_path, pattern):
    """Yield one token list per tar member matching ``pattern``:
    newline-strip, punctuation removal, lowercase, whitespace split
    (ref: imdb.py:38-55 — sequential tarfile.next() scan)."""
    if isinstance(pattern, str):
        pattern = re.compile(pattern)
    table = bytes.maketrans(b"", b"")
    punct = string.punctuation.encode()
    with tarfile.open(tar_path) as tarf:
        tf = tarf.next()
        while tf is not None:
            if pattern.match(tf.name):
                raw = tarf.extractfile(tf).read().rstrip(b"\n\r")
                yield raw.translate(table, punct).lower().split()
            tf = tarf.next()


def imdb_build_dict(tar_path, pattern, cutoff):
    """Frequency-cutoff vocab: sort by (-freq, word), '<unk>' last
    (ref: imdb.py:58-75)."""
    word_freq = collections.defaultdict(int)
    for doc in imdb_tokenize(tar_path, pattern):
        for word in doc:
            word_freq[word] += 1
    kept = [x for x in word_freq.items() if x[1] > cutoff]
    dictionary = sorted(kept, key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(dictionary)}
    word_idx[b"<unk>"] = len(word_idx)
    return word_idx


def imdb_reader(tar_path, pos_pattern, neg_pattern, word_idx):
    """(id-sequence, label) reader — pos label 0, neg label 1, like the
    reference's load order (ref: imdb.py:78-93)."""
    unk = word_idx[b"<unk>"]
    ins = []
    for doc in imdb_tokenize(tar_path, pos_pattern):
        ins.append(([word_idx.get(w, unk) for w in doc], 0))
    for doc in imdb_tokenize(tar_path, neg_pattern):
        ins.append(([word_idx.get(w, unk) for w in doc], 1))

    def reader():
        yield from ins
    return reader


# -- imikolov (simple-examples.tgz / PTB) ---------------------------------

IMIKOLOV_TRAIN = "./simple-examples/data/ptb.train.txt"
IMIKOLOV_VALID = "./simple-examples/data/ptb.valid.txt"


def _imikolov_word_count(f, word_freq):
    for line in f:
        for w in line.strip().split():
            word_freq[w] += 1
        word_freq["<s>"] += 1
        word_freq["<e>"] += 1
    return word_freq


def imikolov_build_dict(tar_path, min_word_freq=50,
                        train_name=IMIKOLOV_TRAIN,
                        valid_name=IMIKOLOV_VALID):
    """PTB vocab over train+valid, '<unk>' forced last
    (ref: imikolov.py:53-80)."""
    word_freq = collections.defaultdict(int)
    with tarfile.open(tar_path) as tf:
        for name in (train_name, valid_name):
            text = io.TextIOWrapper(tf.extractfile(name))
            _imikolov_word_count(text, word_freq)
    word_freq.pop("<unk>", None)
    kept = [x for x in word_freq.items() if x[1] > min_word_freq]
    kept = sorted(kept, key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def imikolov_reader(tar_path, file_name, word_idx, n, data_type="ngram"):
    """NGRAM: sliding n-gram tuples over '<s>' + line + '<e>'.
    SEQ: (src, trg) = ('<s>'+line, line+'<e>'), drop if len > n
    (ref: imikolov.py:83-110)."""
    def reader():
        with tarfile.open(tar_path) as tf:
            f = io.TextIOWrapper(tf.extractfile(file_name))
            unk = word_idx["<unk>"]
            for line in f:
                if data_type == "ngram":
                    assert n > -1, "Invalid gram length"
                    words = ["<s>"] + line.strip().split() + ["<e>"]
                    if len(words) >= n:
                        ids = [word_idx.get(w, unk) for w in words]
                        for i in range(n, len(ids) + 1):
                            yield tuple(ids[i - n:i])
                elif data_type == "seq":
                    ids = [word_idx.get(w, unk)
                           for w in line.strip().split()]
                    src = [word_idx["<s>"]] + ids
                    trg = ids + [word_idx["<e>"]]
                    if n > 0 and len(src) > n:
                        continue
                    yield src, trg
                else:
                    raise ValueError(f"unknown data type {data_type!r}")
    return reader


# -- movielens (ml-1m.zip) ------------------------------------------------

MOVIELENS_AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]
_TITLE_YEAR = re.compile(r"^(.*)\((\d+)\)$")


def movielens_meta(zip_path, prefix="ml-1m"):
    """Parse movies.dat / users.dat ('::'-separated, latin-1) into
    (movie_info, user_info, categories_dict, title_dict) with the
    reference's field semantics: title year stripped, categories
    split on '|', age bucketed by age_table, gender M->0/F->1
    (ref: movielens.py:107-149)."""
    movie_info, title_words, categories = {}, set(), set()
    with zipfile.ZipFile(zip_path) as z:
        with z.open(f"{prefix}/movies.dat") as f:
            for line in f:
                line = line.decode("latin-1")
                movie_id, title, cats = line.strip().split("::")
                cats = cats.split("|")
                categories.update(cats)
                title = _TITLE_YEAR.match(title).group(1)
                movie_info[int(movie_id)] = (int(movie_id), cats, title)
                title_words.update(w.lower() for w in title.split())
        # set-iteration-order dicts, like the reference (the ids are
        # corpus-stable only per build, there as here)
        categories_dict = {c: i for i, c in enumerate(categories)}
        title_dict = {w: i for i, w in enumerate(title_words)}
        user_info = {}
        with z.open(f"{prefix}/users.dat") as f:
            for line in f:
                line = line.decode("latin-1")
                uid, gender, age, job, _ = line.strip().split("::")
                user_info[int(uid)] = (
                    int(uid), 0 if gender == "M" else 1,
                    MOVIELENS_AGE_TABLE.index(int(age)), int(job))
    return movie_info, user_info, categories_dict, title_dict


def movielens_reader(zip_path, prefix="ml-1m", is_test=False,
                     test_ratio=0.1, rand_seed=0, meta=None):
    """Rating stream: per-line random test split, rating rescaled to
    r*2-5, sample = user.value() + movie.value() + [[rating]]
    (ref: movielens.py:152-167)."""
    if meta is None:
        meta = movielens_meta(zip_path, prefix)
    movie_info, user_info, categories_dict, title_dict = meta

    def reader():
        rng = np.random.RandomState(rand_seed)
        with zipfile.ZipFile(zip_path) as z:
            with z.open(f"{prefix}/ratings.dat") as f:
                for line in f:
                    line = line.decode("latin-1")
                    if (rng.random_sample() < test_ratio) != is_test:
                        continue
                    uid, mov_id, rating, _ = line.strip().split("::")
                    uid, mov_id = int(uid), int(mov_id)
                    rating = float(rating) * 2 - 5.0
                    midx, cats, title = movie_info[mov_id]
                    yield (list(user_info[uid])
                           + [midx,
                              [categories_dict[c] for c in cats],
                              [title_dict[w.lower()]
                               for w in title.split()]]
                           + [[rating]])
    return reader


# -- wmt14 (wmt14.tgz: src.dict/trg.dict + tab-separated parallel) --------

WMT_START, WMT_END, WMT_UNK, WMT_UNK_IDX = "<s>", "<e>", "<unk>", 2


def wmt14_dicts(tar_path, dict_size):
    """First ``dict_size`` lines of the members ending in src.dict /
    trg.dict (ref: wmt14.py:56-79)."""
    def to_dict(fd, size):
        out = {}
        for i, line in enumerate(fd):
            if i >= size:
                break
            out[line.decode().strip()] = i
        return out

    with tarfile.open(tar_path) as f:
        src_names = [m.name for m in f if m.name.endswith("src.dict")]
        trg_names = [m.name for m in f if m.name.endswith("trg.dict")]
        assert len(src_names) == 1 and len(trg_names) == 1
        src = to_dict(f.extractfile(src_names[0]), dict_size)
        trg = to_dict(f.extractfile(trg_names[0]), dict_size)
    return src, trg


def wmt14_reader(tar_path, file_name, dict_size):
    """(src ids with <s>/<e>, <s>+trg ids, trg ids+<e>) from
    tab-separated parallel lines; drops pairs over 80 tokens
    (ref: wmt14.py:82-115)."""
    def reader():
        src_dict, trg_dict = wmt14_dicts(tar_path, dict_size)
        with tarfile.open(tar_path) as f:
            names = [m.name for m in f if m.name.endswith(file_name)]
            for name in names:
                for line in f.extractfile(name):
                    parts = line.decode().strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_ids = [src_dict.get(w, WMT_UNK_IDX) for w in
                               [WMT_START] + parts[0].split() + [WMT_END]]
                    trg_ids = [trg_dict.get(w, WMT_UNK_IDX)
                               for w in parts[1].split()]
                    if len(src_ids) > 80 or len(trg_ids) > 80:
                        continue
                    trg_next = trg_ids + [trg_dict[WMT_END]]
                    trg_ids = [trg_dict[WMT_START]] + trg_ids
                    yield src_ids, trg_ids, trg_next
    return reader


# -- wmt16 (tokenized en-de tar; dicts built from train split) ------------

def wmt16_build_dict(tar_path, dict_size, lang,
                     train_name="wmt16/train"):
    """Freq-sorted vocab from the train split with <s>/<e>/<unk> at
    0/1/2 (ref: wmt16.py:62-99 build+load collapsed — no dict-file
    cache side effect; deterministic tie order by (-freq, word))."""
    word_freq = collections.defaultdict(int)
    col = 0 if lang == "en" else 1
    with tarfile.open(tar_path) as f:
        for line in f.extractfile(train_name):
            parts = line.decode().strip().split("\t")
            if len(parts) != 2:
                continue
            for w in parts[col].split():
                word_freq[w] += 1
    word_dict = {WMT_START: 0, WMT_END: 1, WMT_UNK: 2}
    for w, _ in sorted(word_freq.items(), key=lambda x: (-x[1], x[0])):
        if len(word_dict) == dict_size:
            break
        word_dict[w] = len(word_dict)
    return word_dict


def wmt16_reader(tar_path, file_name, src_dict_size, trg_dict_size,
                 src_lang="en", train_name="wmt16/train"):
    """(src ids with marks, <s>+trg, trg+<e>) over tab-separated en\\tde
    lines; column order follows src_lang (ref: wmt16.py:110-145)."""
    def reader():
        src_dict = wmt16_build_dict(tar_path, src_dict_size, src_lang,
                                    train_name)
        trg_lang = "de" if src_lang == "en" else "en"
        trg_dict = wmt16_build_dict(tar_path, trg_dict_size, trg_lang,
                                    train_name)
        start_id, end_id, unk_id = (src_dict[WMT_START],
                                    src_dict[WMT_END],
                                    src_dict[WMT_UNK])
        src_col = 0 if src_lang == "en" else 1
        with tarfile.open(tar_path) as f:
            for line in f.extractfile(file_name):
                parts = line.decode().strip().split("\t")
                if len(parts) != 2:
                    continue
                src_ids = ([start_id]
                           + [src_dict.get(w, unk_id)
                              for w in parts[src_col].split()]
                           + [end_id])
                trg_ids = [trg_dict.get(w, unk_id)
                           for w in parts[1 - src_col].split()]
                yield (src_ids, [start_id] + trg_ids,
                       trg_ids + [end_id])
    return reader


# -- conll05 (words.gz + props.gz inside the test tarball) ----------------

CONLL_UNK_IDX = 0


def conll05_load_dict(path):
    """One entry per line -> zero-based ids (ref: conll05.py:68-73)."""
    with open(path) as f:
        return {line.strip(): i for i, line in enumerate(f)}


def conll05_load_label_dict(path):
    """Expand the target-tag file into B-/I- pairs + 'O' last
    (ref: conll05.py:48-65; set-iteration order, as there)."""
    tag_set = set()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("B-") or line.startswith("I-"):
                tag_set.add(line[2:])
    d, index = {}, 0
    for tag in tag_set:
        d["B-" + tag] = index
        d["I-" + tag] = index + 1
        index += 2
    d["O"] = index
    return d


def _bracket_spans_to_bio(column):
    """Convert one predicate's props column of bracket annotations
    ('(A0*' opens a span, '*' continues, '*)' closes, '(V*)' is a
    one-token span) into BIO tags. Tokens outside any span are 'O';
    the opening token is 'B-<tag>'; tokens inside (including the
    closer) are 'I-<tag>'. Anything else in the column is malformed.
    Behavioral parity with the reference's per-label branch logic
    (ref: conll05.py:76-147), including the degenerate cases: a '*)'
    with no open span repeats the most recent span's tag (initially
    'O')."""
    bio = []
    open_span = False             # inside an unclosed bracket?
    last_tag = "O"                # most recent span tag — STICKY
    # across closes, so a degenerate '*)' with no open span repeats
    # the previous tag exactly as the reference automaton does
    for cell in column:
        if cell.startswith("("):
            last_tag = cell[1:cell.index("*")]
            bio.append("B-" + last_tag)
            open_span = not cell.endswith(")")
        elif cell == "*":
            bio.append("I-" + last_tag if open_span else "O")
        elif cell == "*)":
            bio.append("I-" + last_tag)
            open_span = False
        else:
            raise RuntimeError(f"unexpected props cell: {cell!r}")
    return bio


def conll05_corpus_reader(data_path, words_name, props_name):
    """Parse the CoNLL-2005 column format: a words file (one token per
    line) zipped against a props file whose first column holds the
    predicate lemma ('-' for non-predicates) and whose remaining
    columns carry one bracket annotation per predicate. Rows
    accumulate until a blank props line, then transpose: column 0
    lists the sentence's predicates in order, and each later column
    converts to a BIO sequence via _bracket_spans_to_bio. Yields
    (tokens, predicate, bio_labels) once per predicate
    (ref: conll05.py:76-147, same yielded tuples)."""
    def reader():
        with tarfile.open(data_path) as archive:
            w_member = archive.extractfile(words_name)
            p_member = archive.extractfile(props_name)
            with gzip.GzipFile(fileobj=w_member) as w_stream, \
                    gzip.GzipFile(fileobj=p_member) as p_stream:
                tokens, prop_rows = [], []
                for w_line, p_line in zip(w_stream, p_stream):
                    cells = p_line.decode().strip().split()
                    if cells:
                        tokens.append(w_line.decode().strip())
                        prop_rows.append(cells)
                        continue
                    if prop_rows:   # blank line: sentence boundary
                        # rectangular check first: zip() would silently
                        # truncate a ragged (corrupt) sentence to its
                        # shortest row and drop annotation columns
                        width = len(prop_rows[0])
                        if any(len(row) != width for row in prop_rows):
                            raise ValueError(
                                "ragged props sentence: rows carry "
                                f"{sorted({len(r) for r in prop_rows})}"
                                " columns")
                        columns = list(zip(*prop_rows))
                        predicates = [lemma for lemma in columns[0]
                                      if lemma != "-"]
                        # predicates[i] (not zip): a corrupt file with
                        # more annotation columns than predicate
                        # lemmas must fail loudly, not silently drop
                        for i, col in enumerate(columns[1:]):
                            yield (tokens, predicates[i],
                                   _bracket_spans_to_bio(col))
                    tokens, prop_rows = [], []
    return reader


def conll05_reader(corpus_reader, word_dict, predicate_dict, label_dict):
    """9-slot SRL tuple: words, 5 predicate-context windows (each
    broadcast to sentence length), predicate, mark, labels
    (ref: conll05.py:150-202)."""
    def reader():
        for sentence, predicate, labels in corpus_reader():
            sen_len = len(sentence)
            verb_index = labels.index("B-V")
            mark = [0] * len(labels)

            def ctx(off, default):
                i = verb_index + off
                if 0 <= i < len(labels):
                    mark[i] = 1
                    return sentence[i]
                return default
            ctx_n2 = ctx(-2, "bos")
            ctx_n1 = ctx(-1, "bos")
            ctx_0 = ctx(0, "bos")
            ctx_p1 = ctx(1, "eos")
            ctx_p2 = ctx(2, "eos")
            word_idx = [word_dict.get(w, CONLL_UNK_IDX)
                        for w in sentence]
            bcast = lambda w: [word_dict.get(w, CONLL_UNK_IDX)] * sen_len
            yield (word_idx, bcast(ctx_n2), bcast(ctx_n1), bcast(ctx_0),
                   bcast(ctx_p1), bcast(ctx_p2),
                   [predicate_dict.get(predicate)] * sen_len, mark,
                   [label_dict.get(w) for w in labels])
    return reader


# -- sentiment (NLTK movie_reviews directory layout) ----------------------

def _sentiment_words(root, fileid):
    with open(os.path.join(root, fileid)) as f:
        # NLTK's word tokenization over this corpus ~ whitespace +
        # punctuation split; the corpus files are pre-tokenized
        # one-token-per-whitespace, so split() matches words()
        return f.read().split()


def sentiment_word_dict(root):
    """Frequency-ordered (word, id) pairs over neg+pos, lowercased so
    lookup (which lowercases, like the reference's words_ids[w.lower()]
    at sentiment.py:104) can never miss on mixed-case corpora
    (ref: sentiment.py:56-74)."""
    freq = collections.defaultdict(int)
    for cat in ("neg", "pos"):
        cat_dir = os.path.join(root, cat)
        for name in sorted(os.listdir(cat_dir)):
            for w in _sentiment_words(root, os.path.join(cat, name)):
                freq[w.lower()] += 1
    ordered = sorted(freq.items(), key=lambda x: -x[1])
    return [(w, i) for i, (w, _) in enumerate(ordered)]


def sentiment_reader(root, split="train", train_fraction=0.8,
                     seed=2718):
    """Neg/pos corpus -> (ids, label 0|1) with a randomized
    train/test split: the reference shuffles the combined corpus
    (random.shuffle — UNSEEDED, so its membership differs run to run)
    before slicing the first NUM_TRAINING_INSTANCES for train
    (ref: sentiment.py:77-132). Here the shuffle uses a FIXED seed:
    split membership is a random mix like the reference's, but stable
    across runs and processes (exact membership parity with the
    reference is impossible by construction — its shuffle is
    unseeded). Interleaving neg/pos before the shuffle keeps the
    stream label-balanced for any seed."""
    import random as _random
    word_ids = dict(sentiment_word_dict(root))
    neg = sorted(os.listdir(os.path.join(root, "neg")))
    pos = sorted(os.listdir(os.path.join(root, "pos")))
    files = []
    for n, p in zip(neg, pos):
        files += [os.path.join("neg", n), os.path.join("pos", p)]
    data = []
    for fileid in files:
        label = 0 if fileid.startswith("neg") else 1
        data.append(([word_ids[w.lower()]
                      for w in _sentiment_words(root, fileid)], label))
    _random.Random(seed).shuffle(data)
    n_train = int(len(data) * train_fraction)
    part = data[:n_train] if split == "train" else data[n_train:]

    def reader():
        yield from part
    return reader


# -- mq2007 (LETOR 4.0 text format) ---------------------------------------

def mq2007_queries(path, n_features=46):
    """Parse 'rel qid:q 1:v .. 46:v # comment' lines grouped by qid,
    in file order (ref: mq2007.py:85-146)."""
    queries = collections.OrderedDict()
    with open(path) as f:
        for line in f:
            comment = line.find("#")
            body = line[:comment] if comment != -1 else line
            parts = body.split()
            if len(parts) != n_features + 2:
                continue
            rel = int(parts[0])
            qid = int(parts[1].split(":")[1])
            feat = [float(p.split(":")[1]) for p in parts[2:]]
            queries.setdefault(qid, []).append((rel, feat))
    return queries


def mq2007_reader(path, fmt="pairwise", n_features=46):
    """LETOR readers (ref: mq2007.py:148-240):
    - 'pointwise': (label, feature-vector), ranked desc per query
    - 'pairwise': (1-or-0? no — the reference yields (d_high, d_low)
      feature pairs for every rel_a > rel_b pair) -> here
      (label=1.0, f_high, f_low) triplets matching the repo's
      synthetic pairwise shape AND the reference gen_pair order
    - 'listwise': (qid, labels list, feature matrix)
    """
    queries = mq2007_queries(path, n_features)

    def reader():
        for qid, docs in queries.items():
            ranked = sorted(docs, key=lambda d: d[0], reverse=True)
            if fmt == "pointwise":
                for rel, feat in ranked:
                    yield float(rel), np.asarray(feat, np.float32)
            elif fmt == "pairwise":
                for i, (ra, fa) in enumerate(ranked):
                    for rb, fb in ranked[i + 1:]:
                        if ra > rb:
                            yield (1.0, np.asarray(fa, np.float32),
                                   np.asarray(fb, np.float32))
            elif fmt == "listwise":
                yield (qid, [float(r) for r, _ in ranked],
                       np.asarray([f for _, f in ranked], np.float32))
            else:
                raise ValueError(f"unknown format {fmt!r}")
    return reader


# -- voc2012 (VOCtrainval tar) --------------------------------------------

VOC_SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
VOC_DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
VOC_LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"


def voc2012_reader(tar_path, sub_name):
    """(HWC image array, HW label array) per id in the split's set file
    (ref: voc2012.py:44-66; the tar opens lazily inside reader() so an
    unconsumed creator does not hold a file descriptor)."""
    from PIL import Image

    def reader():
        with tarfile.open(tar_path) as tarobject:
            name2mem = {m.name: m for m in tarobject.getmembers()}
            sets = tarobject.extractfile(name2mem[VOC_SET_FILE
                                                  .format(sub_name)])
            for line in sets:
                line = line.decode().strip()
                data = tarobject.extractfile(
                    name2mem[VOC_DATA_FILE.format(line)]).read()
                label = tarobject.extractfile(
                    name2mem[VOC_LABEL_FILE.format(line)]).read()
                yield (np.array(Image.open(io.BytesIO(data))),
                       np.array(Image.open(io.BytesIO(label))))
    return reader


# -- flowers (102flowers.tgz + imagelabels.mat + setid.mat) ---------------

def flowers_reader(data_tar, label_mat, setid_mat, dataset_name,
                   mapper=None):
    """(image bytes -> mapper output, 0-based label) per index in the
    requested setid split; labels from the .mat are 1-based
    (ref: flowers.py:76-143; batching/pickle cache dropped — the
    reader streams straight from the tar, mapper replaces
    train_mapper/test_mapper)."""
    import scipy.io as scio
    from PIL import Image
    labels = scio.loadmat(label_mat)["labels"][0]
    indexes = scio.loadmat(setid_mat)[dataset_name][0]
    wanted = {"jpg/image_%05d.jpg" % i: int(labels[i - 1])
              for i in indexes}

    def reader():
        with tarfile.open(data_tar) as f:
            for member in f:
                if member.name in wanted:
                    raw = f.extractfile(member).read()
                    img = np.array(Image.open(io.BytesIO(raw)))
                    if mapper is not None:
                        img = mapper(img)
                    yield img, wanted[member.name] - 1
    return reader
