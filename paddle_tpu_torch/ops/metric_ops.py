"""Metric ops: the port of ``paddle_tpu/ops/metric_ops.py``, every public
function.

Parity targets: operators/metrics/ (accuracy_op.cc, auc_op.cc,
precision_recall_op.cc, positive_negative_pair_op.cc) and chunk_eval_op.cc.

``accuracy`` and ``auc`` are tensor ops on the inputs' device, with the JAX
functions' tie rules: top-1 is the first maximum (``argmax``), top-k the
first k of a stable descending order (``jnp.argsort(-x)``); ``auc`` bins
each fp32 probability by truncation of ``p * num_thresholds``, histograms
the labels with an index add, integrates the reverse cumulative sums by
the trapezoid rule. ``precision_recall``, ``chunk_eval`` and
``positive_negative_pair`` run on the host in the JAX package: here they
are the same numpy code, their tensors copied to the host once.
"""

import numpy as np
import torch

__all__ = ["accuracy", "auc", "precision_recall", "chunk_eval",
           "positive_negative_pair"]


def _host(x):
    """A tensor or array-like as a numpy array (one copy to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def accuracy(input, label, k=1, name=None):
    """accuracy_op.cc parity: the share of rows whose label is among the k
    best scores, a 0-d fp32 tensor."""
    input, label = torch.as_tensor(input), torch.as_tensor(label)
    if label.dim() == 2 and label.shape[1] == 1:
        label = label[:, 0]
    if k == 1:
        correct = torch.argmax(input, dim=-1) == label
    else:
        idx = torch.argsort(-input, dim=-1, stable=True)[:, :k]
        correct = (idx == label[:, None]).any(dim=-1)
    return correct.to(torch.float32).mean()


def auc(predict, label, num_thresholds=4096, name=None):
    """auc_op.cc parity (the batch's AUC over a threshold histogram), a 0-d
    fp32 tensor."""
    predict = torch.as_tensor(predict)
    label = torch.as_tensor(label, device=predict.device).reshape(-1)
    pos_prob = (predict[:, 1] if predict.dim() == 2 and predict.shape[1] == 2
                else predict.reshape(-1))
    bins = torch.clamp((pos_prob * num_thresholds).to(torch.int32), 0,
                       num_thresholds - 1).long()
    lab = label.to(torch.float32)
    zeros = torch.zeros(num_thresholds, device=predict.device)
    pos = zeros.index_add(0, bins, lab)
    neg = zeros.index_add(0, bins, 1.0 - lab)
    tp = torch.cumsum(pos.flip(0), 0)
    fp = torch.cumsum(neg.flip(0), 0)
    tpr = tp / torch.clamp(tp[-1], min=1.0)
    fpr = fp / torch.clamp(fp[-1], min=1.0)
    # jnp.trapezoid's arithmetic
    return 0.5 * ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1])).sum()


def precision_recall(predict, label, num_classes):
    """operators/metrics/precision_recall_op.cc: per-class and macro
    (precision, recall, f1) of the argmax predictions, as Python floats."""
    pred = np.argmax(_host(predict), axis=-1).reshape(-1)
    lab = _host(label).reshape(-1)
    eps = 1e-12
    per = []
    for c in range(num_classes):
        tp = float(((pred == c) & (lab == c)).sum())
        fp = float(((pred == c) & (lab != c)).sum())
        fn = float(((pred != c) & (lab == c)).sum())
        p = tp / (tp + fp + eps)
        r = tp / (tp + fn + eps)
        f1 = 2 * p * r / (p + r + eps)
        per.append((p, r, f1))
    macro = tuple(sum(m[i] for m in per) / num_classes for i in range(3))
    return per, macro


def chunk_eval(inference, label, chunk_scheme="IOB", num_chunk_types=None,
               excluded_chunk_types=()):
    """operators/chunk_eval_op.cc: chunking F1 for sequence labeling. A tag
    is ``type * width + position`` in the scheme's position alphabet (IOB:
    B=0, I=1; IOE: I=0, E=1; IOBES: B, I, E, S = 0..3; plain: one tag per
    type). Returns (precision, recall, f1, num_infer, num_label,
    num_correct)."""
    schemes = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}
    if chunk_scheme not in schemes:
        raise ValueError(f"unknown chunk_scheme {chunk_scheme!r}")
    width = schemes[chunk_scheme]

    def extract(tags):
        """A tag sequence as its set of (start, end, type) chunks; a stray
        continuation tag starts a chunk (CoNLL's ChunkEvaluator)."""
        chunks = []
        state = {"start": None, "type": None}

        def close(i):
            if state["start"] is not None:
                chunks.append((state["start"], i - 1, state["type"]))
            state["start"] = state["type"] = None

        def open_(i, typ):
            close(i)
            state["start"], state["type"] = i, typ

        for i, t in enumerate(list(tags) + [-1]):
            if t < 0:
                close(i)
                continue
            typ, pos = divmod(int(t), width)
            outside = num_chunk_types is not None and typ >= num_chunk_types
            if outside or typ in excluded_chunk_types:
                close(i)      # an 'O' tag (>= types * width) ends chunks
                continue
            if chunk_scheme == "plain":
                if state["start"] is None or typ != state["type"]:
                    open_(i, typ)
            elif chunk_scheme == "IOB":
                if pos == 0 or state["start"] is None \
                        or typ != state["type"]:
                    open_(i, typ)
            elif chunk_scheme == "IOE":          # the end is inclusive
                if state["start"] is None or typ != state["type"]:
                    open_(i, typ)
                if pos == 1:
                    chunks.append((state["start"], i, state["type"]))
                    state["start"] = state["type"] = None
            else:                                 # IOBES
                if pos == 3:
                    close(i)
                    chunks.append((i, i, typ))
                elif pos == 0:
                    open_(i, typ)
                else:
                    if state["start"] is None or typ != state["type"]:
                        open_(i, typ)
                    if pos == 2:
                        chunks.append((state["start"], i, state["type"]))
                        state["start"] = state["type"] = None
        return set(chunks)

    ci = extract(_host(inference).reshape(-1))
    cl = extract(_host(label).reshape(-1))
    correct = len(ci & cl)
    eps = 1e-12
    p = correct / (len(ci) + eps)
    r = correct / (len(cl) + eps)
    f1 = 2 * p * r / (p + r + eps)
    return p, r, f1, len(ci), len(cl), correct


def positive_negative_pair(score, label, query_ids):
    """operators/metrics/positive_negative_pair_op.cc: within each query,
    the ordered pairs where the higher-labelled document scores higher
    (positive), lower (negative) or the same (neutral)."""
    s = _host(score).reshape(-1)
    lab = _host(label).reshape(-1)
    q = _host(query_ids).reshape(-1)
    pos = neg = neu = 0
    for qid in np.unique(q):
        idx = np.nonzero(q == qid)[0]
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                i, j = idx[a], idx[b]
                if lab[i] == lab[j]:
                    continue
                hi, lo = (i, j) if lab[i] > lab[j] else (j, i)
                if s[hi] > s[lo]:
                    pos += 1
                elif s[hi] < s[lo]:
                    neg += 1
                else:
                    neu += 1
    return pos, neg, neu
