"""The Fluid CTR-DNN (click-through-rate prediction) as a static program,
trained from MultiSlot files through the Dataset API.

Source: PaddlePaddle/models ``PaddleRec/ctr/dnn`` (Fluid 1.5),
``network_conf.py`` and ``train.py``: 13 dense features (``dense_input``)
and 26 categorical slots ``C1``..``C26``, each one int64 id hashed into
``sparse_feature_dim`` = 1,000,001, all looking up one shared table
``SparseFeatFactors`` [1,000,001, 10] (``is_sparse=True``, a Uniform
initializer); the concat of 26 x 10 + 13 = 273 features through three fc
400 + ReLU, each fc's weight Normal with scale 1/sqrt(fan-in); fc 2 +
softmax, ``cross_entropy`` against ``label`` and the batch ``auc`` over
2^12 thresholds; Adam at 1e-4, batch 1000, ``set_thread(10)``, trained
with ``exe.train_from_dataset(..., fetch_list=[auc], fetch_info=["auc"])``.
:func:`ctr_dnn_config` is that config.

Where this program departs from ``network_conf.py``:

- no ``sequence_pool``: Criteo gives exactly one value per categorical
  field, so the reference's average pool over a slot averages one id,
  the identity; each slot is declared ``shape=[1]`` with ``lod_level`` 0
  (a LoD input fails in a Program in both packages);
- the loss is the ``mean`` of the cross-entropy over the batch;
- ``auc`` is the batch AUC (the one Variable ``layers.auc`` gives in
  both packages), not the reference's sliding-window state.

The data are synthetic Criteo-shaped MultiSlot lines written from a seed
by :func:`write_files` through ``incubate.data_generator``'s
``MultiSlotDataGenerator``: 13 dense floats in [0, 1), 26 ids uniform in
[0, sparse_feature_dim), and a label drawn from a fixed logistic rule on
four dense features, so that the loss falls. Only the data and the epoch
length are cut; the widths are the published ones.

``ctr_dnn(pt, cfg)`` builds the programs from either package (``pt`` is
``paddle_tpu_torch`` or the JAX package): the same builder makes both, so
their documents compare.
"""

import dataclasses
import math
import os

import numpy as np

__all__ = ["CTRDNNConfig", "ctr_dnn_config", "ctr_dnn_tiny", "ctr_dnn",
           "slot_names", "write_files", "param_shapes", "param_count"]


@dataclasses.dataclass(frozen=True)
class CTRDNNConfig:
    sparse_slots: int = 26
    dense_dim: int = 13
    sparse_feature_dim: int = 1000001
    embedding_size: int = 10
    fc_sizes: tuple = (400, 400, 400)
    batch: int = 1000
    lr: float = 1e-4
    num_thresholds: int = 4096
    threads: int = 10


def ctr_dnn_config():
    """``network_conf.py`` / ``train.py``'s config."""
    return CTRDNNConfig()


def ctr_dnn_tiny(**kw):
    """A narrow config for CPU tests: 4 slots, a [1000, 8] table, fc 32
    x3, batch 64."""
    return dataclasses.replace(CTRDNNConfig(
        sparse_slots=4, sparse_feature_dim=1000, embedding_size=8,
        fc_sizes=(32, 32, 32), batch=64, threads=2), **kw)


def slot_names(cfg):
    """The data vars in the files' slot order: dense, C1..Cn, label."""
    return (["dense_input"] + [f"C{i + 1}" for i in range(cfg.sparse_slots)]
            + ["label"])


def param_shapes(cfg):
    """The trainable tensors' shapes in creation order: the table, then
    each fc's weight and bias."""
    shapes = [(cfg.sparse_feature_dim, cfg.embedding_size)]
    k = cfg.sparse_slots * cfg.embedding_size + cfg.dense_dim
    for m in list(cfg.fc_sizes) + [2]:
        shapes += [(k, m), (m,)]
        k = m
    return shapes


def param_count(cfg):
    """The trainable values: the table and the four fcs' weights and
    biases."""
    return sum(math.prod(s) for s in param_shapes(cfg))


def ctr_dnn(pt, cfg):
    """The main program (Adam-minimized), its startup and the for-test
    clone made before ``minimize``. Returns a dict: main, startup, test,
    loss, auc, predict, feeds (the data vars in slot order) and slots
    ([(name, dtype)] for ``Dataset.set_use_var``)."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.framework.unique_name.guard():
        dense = pt.data("dense_input", [cfg.dense_dim], "float32")
        sparse = [pt.data(f"C{i + 1}", [1], "int64")
                  for i in range(cfg.sparse_slots)]
        label = pt.data("label", [1], "int64")
        table = pt.ParamAttr(name="SparseFeatFactors",
                             initializer=pt.initializer.Uniform())
        embs = [L.reshape(L.embedding(
            s, size=[cfg.sparse_feature_dim, cfg.embedding_size],
            is_sparse=True, param_attr=table), [-1, cfg.embedding_size])
            for s in sparse]
        x = L.concat(embs + [dense], axis=1)
        width = cfg.sparse_slots * cfg.embedding_size + cfg.dense_dim
        for size in cfg.fc_sizes:
            x = L.fc(x, size, act="relu", param_attr=pt.ParamAttr(
                initializer=pt.initializer.Normal(
                    scale=1 / math.sqrt(width))))
            width = size
        predict = L.fc(x, 2, act="softmax", param_attr=pt.ParamAttr(
            initializer=pt.initializer.Normal(scale=1 / math.sqrt(width))))
        loss = L.mean(L.cross_entropy(predict, label))
        auc = L.auc(predict, label, num_thresholds=cfg.num_thresholds)
        test = main.clone(for_test=True)
        pt.optimizer.Adam(learning_rate=cfg.lr).minimize(loss)
    feeds = [dense] + sparse + [label]
    return dict(main=main, startup=startup, test=test, loss=loss, auc=auc,
                predict=predict, feeds=feeds,
                slots=[(n, "float32" if n == "dense_input" else "int64")
                       for n in slot_names(cfg)])


def _generator(cfg, n, seed):
    """A ``MultiSlotDataGenerator`` whose ``generate_sample`` yields ``n``
    samples drawn from ``seed``."""
    from paddle_tpu_torch.incubate.data_generator import (
        MultiSlotDataGenerator,
    )
    rng = np.random.RandomState(seed)
    dense = np.round(rng.random_sample((n, cfg.dense_dim)), 6)
    ids = rng.randint(0, cfg.sparse_feature_dim, (n, cfg.sparse_slots))
    z = 4.0 * (dense[:, 0] - dense[:, 1]) + 2.0 * (dense[:, 2] - dense[:, 3])
    label = (rng.random_sample(n) < 1.0 / (1.0 + np.exp(-z))).astype(int)
    names = slot_names(cfg)

    class Lines(MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                for r in range(n):
                    yield ([(names[0], [float(v) for v in dense[r]])]
                           + [(names[1 + j], [int(ids[r, j])])
                              for j in range(cfg.sparse_slots)]
                           + [(names[-1], [int(label[r])])])
            return it

    return Lines()


def write_files(cfg, dirname, n_files, lines_per_file, seed):
    """``n_files`` MultiSlot text files of ``lines_per_file`` samples each
    under ``dirname``, file i drawn from ``seed + i``. Returns the
    paths."""
    os.makedirs(dirname, exist_ok=True)
    paths = []
    for i in range(n_files):
        path = os.path.join(dirname, f"part-{i:05d}")
        with open(path, "w") as f:
            _generator(cfg, lines_per_file, seed + i).run_from_memory(out=f)
        paths.append(path)
    return paths
