"""Stateful metric aggregators: the port of ``paddle_tpu/metrics.py``
(the reference's python/paddle/fluid/metrics.py: MetricBase, Accuracy,
Precision, Recall, Auc, ChunkEvaluator, EditDistance, CompositeMetric,
DetectionMAP).

Host numpy, as in the JAX package. ``update`` takes tensors on the card
too: each is copied to the host once per update (what a metric does);
``DetectionMAP`` evaluates through the port's host ``detection_map``.
"""

import numpy as np
import torch


def _host(x):
    """``x`` as numpy: a tensor is copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

__all__ = [
    "MetricBase", "Accuracy", "Precision", "Recall", "Auc",
    "CompositeMetric", "ChunkEvaluator", "EditDistance", "DetectionMAP",
]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        self.value += float(_host(value)) * float(_host(weight))
        self.weight += float(_host(weight))

    def eval(self):
        return self.value / max(self.weight, 1e-12)


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(_host(preds)).astype(np.int64).reshape(-1)
        labels = _host(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(_host(preds)).astype(np.int64).reshape(-1)
        labels = _host(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(MetricBase):
    """metrics.py Auc parity: threshold-bucketed streaming AUC."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self.n = num_thresholds
        self.reset()

    def reset(self):
        self.stat_pos = np.zeros(self.n + 1)
        self.stat_neg = np.zeros(self.n + 1)

    def update(self, preds, labels):
        preds = _host(preds)
        labels = _host(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 \
            else preds.reshape(-1)
        bins = np.clip((pos_prob * self.n).astype(int), 0, self.n)
        pos = labels.astype(bool)
        self.stat_pos += np.bincount(bins[pos], minlength=self.n + 1)
        self.stat_neg += np.bincount(bins[~pos], minlength=self.n + 1)

    def eval(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.n, -1, -1):
            new_pos = tot_pos + self.stat_pos[i]
            new_neg = tot_neg + self.stat_neg[i]
            auc += (new_pos + tot_pos) * self.stat_neg[i] / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        denom = tot_pos * tot_neg
        return auc / denom if denom else 0.0


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class ChunkEvaluator(MetricBase):
    """metrics.py ChunkEvaluator parity: F1 over chunk counts produced by
    a chunk-matching routine (the reference feeds it from chunk_eval_op)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(_host(num_infer_chunks))
        self.num_label_chunks += int(_host(num_label_chunks))
        self.num_correct_chunks += int(_host(num_correct_chunks))

    def eval(self):
        precision = self.num_correct_chunks / self.num_infer_chunks \
            if self.num_infer_chunks else 0.0
        recall = self.num_correct_chunks / self.num_label_chunks \
            if self.num_label_chunks else 0.0
        f1 = 2 * precision * recall / (precision + recall) \
            if self.num_correct_chunks else 0.0
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0
        self.correct = 0

    def update(self, distances, seq_num):
        d = _host(distances)
        self.total += float(d.sum())
        self.count += int(_host(seq_num))
        self.correct += int(np.sum(d == 0))

    def eval(self):
        avg = self.total / max(self.count, 1)
        acc = self.correct / max(self.count, 1)
        return avg, acc


class DetectionMAP(MetricBase):
    """fluid.metrics.DetectionMAP parity: accumulates per-batch
    detections + ground truth and evaluates mean average precision via
    ops.detection.detection_map (detection_map_op.cc)."""

    def __init__(self, name=None, class_num=None, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral"):
        super().__init__(name)
        self.class_num = class_num
        self.overlap_threshold = overlap_threshold
        self.evaluate_difficult = evaluate_difficult
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        self._dets = []
        self._gt_labels = []
        self._gt_boxes = []

    def update(self, detect_res, gt_label, gt_box):
        self._dets.append(_host(detect_res))
        self._gt_labels.append(_host(gt_label))
        self._gt_boxes.append(_host(gt_box))

    def eval(self):
        from paddle_tpu_torch.ops.detection import detection_map
        if self.class_num is None:
            raise ValueError("DetectionMAP needs class_num")
        return detection_map(
            self._dets, self._gt_labels, self._gt_boxes, self.class_num,
            overlap_threshold=self.overlap_threshold,
            evaluate_difficult=self.evaluate_difficult,
            ap_type=self.ap_version)
