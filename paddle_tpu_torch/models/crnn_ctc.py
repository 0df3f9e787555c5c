"""CRNN-CTC, the text-line recognizer of PaddlePaddle/models (Fluid 1.5 era)
``PaddleCV/ocr_recognition``, as a Fluid static training program and its
``clone(for_test=True)`` evaluation program.

Source: ``crnn_ctc_model.py`` (``conv_bn_pool``, ``ocr_convs``,
``encoder_net``, ``ctc_train_net``, ``ctc_infer``) and ``data_reader.py``
(grey images ``[1, 48, 512]``, 95 classes). :func:`crnn_ctc` is its
published configuration: 48x512 images, batch 32, 95 classes and the
blank (96 outputs), GRU hidden 200, Momentum(1e-3, 0.9), L2Decay(4e-4).

- **ocr_convs**: four ``conv_bn_pool`` groups of two 3x3 convs (padding 1,
  the default bias) with out channels [16, 16], [32, 32], [64, 64] and
  [128, 128], each conv followed by ``batch_norm(act="relu")``; groups 1-3
  end in ``pool2d(2, "max", stride 2, ceil_mode=True)``, group 4 has no
  pool. At [B, 1, 48, 512] the features are [B, 128, 6, 64].
- **encoder_net**: ``im2sequence`` with filter [6, 1] and stride 1 makes a
  sequence of 64 steps of 768 features; two fcs of 600 (3 x hidden) at
  ``num_flatten_dims=2``; a forward and a reverse ``dynamic_gru`` of hidden
  200 over ``create_parameter`` weights; one fc of 96 over the list
  ``[gru_fwd, gru_bwd]`` with one shared bias.
- **The initialisers**: the convs of group 1 ``Normal(0, 0.0005)``, every
  other conv ``Normal(0, 0.01)``; batch norm's scale ``Normal(0, 0.01)``
  and its bias ``Normal(0, 0.0)``; the fcs' weights and the GRUs'
  ``Normal(0, 0.02)``, the first two fcs' biases ``Normal(0, 0.02)``, the
  GRUs' biases ``Normal(0, 0.02)`` at ``learning_rate=2.0``, the last fc's
  bias ``Normal(0, 0.0)``. Every ``ParamAttr`` of the source carries
  ``L2Decay(4e-4)``; the convs' default biases carry none, as there.
- **The loss**: ``warpctc(logits, label, blank=95, norm_by_times=True)``
  then ``reduce_sum``, minimized by ``Momentum(1e-3, 0.9)``.
- **The evaluation program**: ``ctc_greedy_decoder(logits, blank=95)`` and
  ``edit_distance(decoded, label)`` (normalized, the evaluator's default),
  built before the clone as the source builds them; the pass pipeline drops
  them from a training run that does not fetch them.

Where the JAX package cannot express the source, this module follows it:

- the source's ``candidate_activation="relu"`` has no counterpart (the
  GRU's candidate is tanh in both packages);
- the LoD inputs are dense tensors with lengths: the label ``[B, L]``
  int32 padded with 0 beside ``label_length`` [B]; the logits are
  ``[B, 64, 96]`` with every row 64 steps long (the images are all 512
  wide);
- the source casts the label to int64 for its evaluator; here the label
  goes to ``edit_distance`` as it is (the JAX package has no int64 without
  x64);
- the images and labels are synthetic (:func:`synthetic_batch`), seeded.

The programs are built with whichever package is passed as ``pt`` (this
one, or the JAX package, whose layers take the same calls), so the two
build the same documents. :func:`crnn_ctc_tiny` is the CPU tests' config.
"""

import dataclasses

import numpy as np

__all__ = ["CRNNConfig", "crnn_ctc", "crnn_ctc_tiny", "ocr_convs",
           "encoder_net", "build_train", "synthetic_batch", "feed_of",
           "param_names"]


@dataclasses.dataclass(frozen=True)
class CRNNConfig:
    height: int = 48
    width: int = 512
    batch: int = 32
    groups: tuple = ((16, 16), (32, 32), (64, 64), (128, 128))
    pooled: int = 3              # the first groups that end in a pool
    num_classes: int = 95        # the blank is num_classes
    hidden: int = 200
    max_label: int = 24          # label lengths are drawn from 1 to this
    lr: float = 1e-3
    momentum: float = 0.9
    l2: float = 4e-4

    @property
    def time_steps(self):
        return self.width // 2 ** self.pooled

    @property
    def feat_height(self):
        return self.height // 2 ** self.pooled

    @property
    def features(self):
        return self.groups[-1][-1] * self.feat_height


def crnn_ctc():
    """The source's configuration: 48x512, batch 32, 95 classes, hidden
    200."""
    return CRNNConfig()


def crnn_ctc_tiny(**kw):
    """16x64, batch 4, two groups of 4 and 8 channels (the first pooled),
    6 classes, hidden 8, labels 1-5 long."""
    return dataclasses.replace(CRNNConfig(
        height=16, width=64, batch=4, groups=((4, 4), (8, 8)), pooled=1,
        num_classes=6, hidden=8, max_label=5), **kw)


def _attr(pt, cfg, std, name=None, **kw):
    return pt.ParamAttr(name=name,
                        initializer=pt.initializer.Normal(0.0, std),
                        regularizer=pt.regularizer.L2Decay(cfg.l2), **kw)


def ocr_convs(pt, cfg, images, is_test=False):
    """The conv groups of ``images`` [B, 1, H, W]: [B, C, H/2^p, W/2^p]."""
    L = pt.layers
    x = images
    for g, chans in enumerate(cfg.groups):
        for i, ch in enumerate(chans):
            std = 0.0005 if g == 0 else 0.01
            x = L.conv2d(x, ch, 3, padding=1,
                         param_attr=_attr(pt, cfg, std, f"conv{g}_{i}_w"))
            x = L.batch_norm(
                x, act="relu", is_test=is_test,
                param_attr=_attr(pt, cfg, 0.01, f"bn{g}_{i}_scale"),
                bias_attr=_attr(pt, cfg, 0.0, f"bn{g}_{i}_offset"))
        if g < cfg.pooled:
            x = L.pool2d(x, pool_size=2, pool_type="max", pool_stride=2,
                         ceil_mode=True)
    return x


def _gru(pt, cfg, x, name, is_reverse):
    L, h = pt.layers, cfg.hidden
    w = L.create_parameter([h, 3 * h], "float32",
                           attr=_attr(pt, cfg, 0.02, f"{name}_w"))
    b = L.create_parameter([3 * h], "float32", is_bias=True,
                           attr=_attr(pt, cfg, 0.02, f"{name}_b",
                                      learning_rate=2.0))
    return L.dynamic_gru(x, w, bias=b, is_reverse=is_reverse)


def encoder_net(pt, cfg, images, is_test=False):
    """The logits [B, T, num_classes + 1] of ``images``."""
    L = pt.layers
    conv = ocr_convs(pt, cfg, images, is_test)
    seq = L.im2sequence(conv, filter_size=[int(conv.shape[2]), 1],
                        stride=[1, 1])
    fcs = [L.fc(seq, 3 * cfg.hidden, num_flatten_dims=2,
                param_attr=_attr(pt, cfg, 0.02, f"fc{k}_w"),
                bias_attr=_attr(pt, cfg, 0.02, f"fc{k}_b"))
           for k in (1, 2)]
    fwd = _gru(pt, cfg, fcs[0], "gru_fwd", False)
    bwd = _gru(pt, cfg, fcs[1], "gru_bwd", True)
    return L.fc([fwd, bwd], cfg.num_classes + 1, num_flatten_dims=2,
                param_attr=[_attr(pt, cfg, 0.02, "out_fwd_w"),
                            _attr(pt, cfg, 0.02, "out_bwd_w")],
                bias_attr=_attr(pt, cfg, 0.0, "out_b"))


def build_train(pt, cfg):
    """The training program and, cloned before ``minimize``, the evaluation
    program. Feeds: ``pixel`` [B, 1, H, W] fp32, ``label`` [B, L] int32
    (padded with 0), ``label_length`` [B] int32. Returns a dict: main,
    startup, test, logits, loss (the summed CTC cost), decoded,
    decoded_length, distance (per row), seq_num."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.framework.unique_name.guard():
        pixel = pt.data("pixel", [1, cfg.height, cfg.width], "float32")
        label = pt.data("label", [cfg.max_label], "int32")
        label_length = pt.data("label_length", [], "int32")
        logits = encoder_net(pt, cfg, pixel)
        cost = L.warpctc(logits, label, label_length=label_length,
                         blank=cfg.num_classes, norm_by_times=True)
        loss = L.reduce_sum(cost)
        decoded, dec_len = L.ctc_greedy_decoder(logits,
                                                blank=cfg.num_classes)
        distance, seq_num = L.edit_distance(
            decoded, label, input_length=dec_len, label_length=label_length)
        test = main.clone(for_test=True)
        pt.optimizer.Momentum(learning_rate=cfg.lr,
                              momentum=cfg.momentum).minimize(loss)
    return dict(main=main, startup=startup, test=test, logits=logits,
                loss=loss, decoded=decoded, decoded_length=dec_len,
                distance=distance, seq_num=seq_num)


def synthetic_batch(cfg, batch, seed):
    """A text-line batch from ``seed``: labels of 1 to ``max_label`` ids in
    [0, num_classes) (0-padded), and grey images [B, 1, H, W] in [0, 1] of
    noise with each label drawn as a vertical bar pattern of its id in its
    slot along the width. Returns dict(pixel, label, label_length) of
    numpy arrays."""
    rng = np.random.RandomState(seed)
    h, w, L = cfg.height, cfg.width, cfg.max_label
    pixel = rng.uniform(0.0, 0.2, (batch, 1, h, w)).astype(np.float32)
    label = np.zeros((batch, L), np.int32)
    length = rng.randint(1, L + 1, batch).astype(np.int32)
    for b in range(batch):
        ids = rng.randint(0, cfg.num_classes, length[b])
        label[b, :length[b]] = ids
        slot = w // L
        for k, c in enumerate(ids):
            rows = slice(int(h * (c % 7) / 8), int(h * (c % 7 + 2) / 8))
            pixel[b, 0, rows, k * slot:k * slot + max(1, slot // 2)] += \
                0.5 + 0.5 * c / cfg.num_classes
    return dict(pixel=np.clip(pixel, 0.0, 1.0), label=label,
                label_length=length)


def feed_of(batch, keys=("pixel", "label", "label_length")):
    return {k: batch[k] for k in keys}


def param_names(program):
    """The trainable parameters of ``program``, in creation order."""
    return [n for n, v in program.global_block().vars.items()
            if getattr(v, "trainable", False) and v.persistable]
