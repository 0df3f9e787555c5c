"""Real-text corpus utilities for language-model convergence runs.

The port of ``paddle_tpu/dataio/text_corpus.py``: host code on numpy, the same
samples, ids and errors for the same inputs and seeds.

The reference's text datasets (imdb, imikolov, wmt14/16 —
python/paddle/dataset/) download corpora and build word vocabularies
with UNK cutoffs; this module does the same over LOCAL text files so
MLM convergence can be proven with zero network egress (a machine
without network access): any directory of .md/.txt/.py files is a real
corpus.

Layout mirrors the reference's vocab discipline (imikolov.py
build_dict): whitespace word tokens, frequency-ranked vocab with
reserved ids, everything else UNK.
"""

import os
import re

import numpy as np

__all__ = ["RESERVED", "PAD_ID", "UNK_ID", "MASK_ID", "build_corpus",
           "mlm_batch_stream"]

PAD_ID, UNK_ID, MASK_ID, CLS_ID, SEP_ID = 0, 1, 2, 3, 4
RESERVED = 5


def _iter_files(root, exts=(".md", ".txt", ".rst", ".py")):
    if os.path.isfile(root):
        yield root
        return
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(exts):
                yield os.path.join(dirpath, f)


def build_corpus(root, vocab_size=2048, max_bytes=8 << 20,
                 exts=(".md", ".txt", ".rst", ".py"), files=None):
    """Tokenize local files into one id stream.

    Returns (ids int32 [N], word->id dict). ids use the RESERVED
    prefix (0 pad, 1 unk, 2 mask, 3 cls, 4 sep); the vocab keeps the
    (vocab_size - RESERVED) most frequent words.

    ``files`` pins the corpus to an explicit ORDERED list of paths
    (relative to ``root`` or absolute; missing entries are skipped,
    ``exts`` ignored) instead of walking ``root``. Convergence tests
    pass a committed manifest here so a growing tree no longer shifts
    their training data (tests/fixtures/bert_corpus_manifest.txt).
    """
    if files is not None:
        paths = [p if os.path.isabs(p) else os.path.join(root, p)
                 for p in files]
        paths = [p for p in paths if os.path.isfile(p)]
    else:
        paths = _iter_files(root, exts)
    words = []
    budget = max_bytes
    for path in paths:
        try:
            with open(path, "r", encoding="utf-8", errors="ignore") as f:
                text = f.read(budget)
        except OSError:
            continue
        budget -= len(text)
        words.extend(re.findall(r"[A-Za-z_]+|[0-9]+|[^\sA-Za-z0-9_]",
                                text.lower()))
        if budget <= 0:
            break
    from collections import Counter
    counts = Counter(words)
    vocab = {w: i + RESERVED
             for i, (w, _) in enumerate(
                 counts.most_common(vocab_size - RESERVED))}
    ids = np.fromiter((vocab.get(w, UNK_ID) for w in words),
                      dtype=np.int32, count=len(words))
    return ids, vocab


def mlm_batch_stream(ids, vocab_size, batch_size, seq_len, seed=0,
                     mask_prob=0.15, region=(0.0, 1.0)):
    """Yield BERT-style dense MLM batches from the id stream.

    Each batch samples batch_size random windows from the given
    ``region`` fraction of the stream (disjoint regions give train vs
    held-out eval), masks ~mask_prob of positions with the 80/10/10
    rule (MASK / random id / keep), and emits the dense layout
    mlm_loss consumes: input_ids, labels, weights (+ type/mask).
    """
    ids = np.asarray(ids, np.int32)
    lo = int(len(ids) * region[0])
    hi = int(len(ids) * region[1]) - seq_len - 1
    if hi <= lo:
        raise ValueError(
            f"corpus region {region} spans "
            f"{int(len(ids) * (region[1] - region[0]))} tokens — too "
            f"small for seq_len={seq_len}; use a larger corpus or "
            f"region")
    rng = np.random.RandomState(seed)
    while True:
        starts = rng.randint(lo, hi, size=batch_size)
        seqs = np.stack([ids[s:s + seq_len] for s in starts])
        labels = seqs.copy()
        mask = rng.rand(batch_size, seq_len) < mask_prob
        mask &= seqs >= RESERVED          # never mask reserved ids
        r = rng.rand(batch_size, seq_len)
        inputs = seqs.copy()
        inputs[mask & (r < 0.8)] = MASK_ID
        rand_ids = rng.randint(RESERVED, vocab_size,
                               size=(batch_size, seq_len)).astype(np.int32)
        swap = mask & (r >= 0.8) & (r < 0.9)
        inputs[swap] = rand_ids[swap]
        yield {
            "input_ids": inputs.astype(np.int32),
            "token_type_ids": np.zeros_like(inputs, np.int32),
            "attention_mask": np.ones_like(inputs, np.int32),
            "labels": labels.astype(np.int32),
            "weights": mask.astype(np.float32),
        }
