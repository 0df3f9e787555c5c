"""MobileNet-SSD as a Fluid static program: training (``ssd_loss``) and,
from the same network, an inference program (``clone(for_test=True)``,
``softmax`` and ``detection_output``).

Source: PaddlePaddle/models (Fluid 1.5 era), ``PaddleCV/ssd``:
``mobilenet_ssd.py`` (MobileNet v1 at scale 1.0: each ``conv_bn`` a conv2d
without bias, MSRA init at learning rate 0.1, then batch_norm with ReLU;
each ``depthwise_separable`` a 3x3 conv with ``groups`` = channels and a 1x1
conv; four ``extra_block``s of 1x1 then 3x3 stride 2; ``multi_box_head`` over
module11 (19^2), module13 (10^2) and the extras (5^2, 3^2, 2^2, 1^2)), and
``train.py``'s ``train_parameters["pascalvoc"]`` (3x300x300, 21 classes,
batch 64, RMSProp at 0.001 under ``piecewise_decay`` at 40/60/80/100 epochs
of 16,551 // 64 iterations with decays 1, 0.5, 0.25, 0.1, 0.01,
``L2Decay(5e-5)``); :func:`mobilenet_ssd_voc` is that config, and its head
gives 1,917 priors.

The program is built with whichever package is passed as ``pt`` (this one,
or the JAX package, whose layers take the same calls), so the two build the
same document. Where it departs from the source:

- ground truth is dense and padded (``gt_box`` [B, G, 4], ``gt_label``
  [B, G] int32 with -1 on padding rows), as the JAX ``ssd_loss`` takes it;
  G = 20 is a choice (the source's LoD input has no padded width);
- the JAX ``detection_output`` applies no softmax (ROADMAP queue 3 note l),
  so the inference program calls ``layers.softmax`` on the confidences
  first, where Fluid's ``detection_output`` applies it inside;
- the data are synthetic (:func:`synthetic_batch`): seeded noise images
  with 1-8 boxes each, labels 1-20, each box painted into the image.

:func:`ssd_tiny` is the CPU tests' config: MobileNet at width 1/8 (the
extras too), 64^2 input, 4 classes, the head's sizes scaled to the input.
"""

import dataclasses

import numpy as np

from paddle_tpu_torch.models.mobilenet_v1 import conv_bn

__all__ = ["SSDConfig", "mobilenet_ssd_voc", "ssd_tiny", "build_train",
           "build_infer", "synthetic_batch"]

#: multi_box_head's settings in mobilenet_ssd.py (sizes for a 300^2 input)
MIN_SIZES = (60.0, 105.0, 150.0, 195.0, 240.0, 285.0)
MAX_SIZES = ((), 150.0, 195.0, 240.0, 285.0, 300.0)
ASPECT_RATIOS = ((2.0,),) + ((2.0, 3.0),) * 5
#: the extra blocks' (1x1, 3x3) widths
EXTRAS = ((256, 512), (128, 256), (128, 256), (64, 128))


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    image_size: int = 300
    num_classes: int = 21
    scale: float = 1.0           # MobileNet's width multiplier
    extra_scale: float = 1.0     # the extra blocks' width multiplier
    batch: int = 64
    infer_batch: int = 32
    max_gt: int = 20
    lr: float = 0.001
    l2: float = 5e-5
    train_images: int = 16551
    lr_epochs: tuple = (40, 60, 80, 100)
    lr_decay: tuple = (1.0, 0.5, 0.25, 0.1, 0.01)
    nms_threshold: float = 0.45

    @property
    def min_sizes(self):
        return [s * self.image_size / 300 for s in MIN_SIZES]

    @property
    def max_sizes(self):
        return [[] if s == () else s * self.image_size / 300
                for s in MAX_SIZES]


def mobilenet_ssd_voc():
    """``train_parameters["pascalvoc"]`` with mobilenet_ssd.py at scale 1."""
    return SSDConfig()


def ssd_tiny(**kw):
    """MobileNet at width 1/8 (extras too), 64^2, 4 classes, batch 2."""
    return dataclasses.replace(SSDConfig(
        image_size=64, num_classes=4, scale=0.125, extra_scale=0.125,
        batch=2, infer_batch=2, max_gt=4), **kw)


def _conv_bn(pt, x, k, c, stride, pad, groups=1, act="relu"):
    """MobileNet's conv_bn (``models/mobilenet_v1.py``), unnamed, its
    convs learning at 0.1 as in mobilenet_ssd.py."""
    return conv_bn(pt, x, k, c, stride, pad, groups=groups, act=act,
                   learning_rate=0.1)


def _depthwise_separable(pt, cfg, x, c1, c2, groups, stride):
    s = cfg.scale
    dw = _conv_bn(pt, x, 3, int(c1 * s), stride, 1, groups=int(groups * s))
    return _conv_bn(pt, dw, 1, int(c2 * s), 1, 0)


def _extra_block(pt, x, c1, c2):
    return _conv_bn(pt, _conv_bn(pt, x, 1, c1, 1, 0), 3, c2, 2, 1)


def mobilenet_ssd(pt, cfg, image):
    """The network: (mbox_locs, mbox_confs, boxes, variances)."""
    x = _conv_bn(pt, image, 3, int(32 * cfg.scale), 2, 1)
    for c1, c2, stride in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                           (128, 256, 2), (256, 256, 1), (256, 512, 2)):
        x = _depthwise_separable(pt, cfg, x, c1, c2, c1, stride)
    for _ in range(5):
        x = _depthwise_separable(pt, cfg, x, 512, 512, 512, 1)
    module11 = x
    x = _depthwise_separable(pt, cfg, x, 512, 1024, 512, 2)
    x = _depthwise_separable(pt, cfg, x, 1024, 1024, 1024, 1)
    maps = [module11, x]
    for c1, c2 in EXTRAS:
        x = _extra_block(pt, x, int(c1 * cfg.extra_scale),
                         int(c2 * cfg.extra_scale))
        maps.append(x)
    return pt.layers.multi_box_head(
        inputs=maps, image=image, num_classes=cfg.num_classes,
        min_ratio=20, max_ratio=90, min_sizes=cfg.min_sizes,
        max_sizes=cfg.max_sizes,
        aspect_ratios=[list(a) for a in ASPECT_RATIOS],
        base_size=cfg.image_size, offset=0.5, flip=True)


def build_train(pt, cfg):
    """The training program (path A) and, cloned from its network before
    the loss, the inference program (path B). ``pt`` is
    ``paddle_tpu_torch`` (or the JAX package). Feeds: ``image`` [B, 3, S,
    S] fp32, ``gt_box`` [B, G, 4] fp32 (normalized corners), ``gt_label``
    [B, G] int32 (-1 on padding). Returns a dict: main, startup, loss,
    infer (the inference program: ``image`` in, ``nmsed`` out [B, 200, 6]),
    nmsed, locs, confs, box, box_var."""
    L = pt.layers
    S, G = cfg.image_size, cfg.max_gt
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.framework.unique_name.guard():
        image = pt.data("image", [3, S, S], "float32")
        gt_box = pt.data("gt_box", [G, 4], "float32")
        gt_label = pt.data("gt_label", [G], "int32")
        locs, confs, box, box_var = mobilenet_ssd(pt, cfg, image)
        infer = main.clone(for_test=True)
        with pt.program_guard(infer, startup):
            nmsed = L.detection_output(locs, L.softmax(confs), box, box_var,
                                       nms_threshold=cfg.nms_threshold)
        loss = L.reduce_sum(L.ssd_loss(locs, confs, gt_box, gt_label, box,
                                       box_var))
        iters = cfg.train_images // cfg.batch
        lr = L.piecewise_decay([e * iters for e in cfg.lr_epochs],
                               [d * cfg.lr for d in cfg.lr_decay])
        pt.optimizer.RMSPropOptimizer(
            lr, regularization=pt.regularizer.L2Decay(cfg.l2)).minimize(loss)
    return dict(main=main, startup=startup, loss=loss, infer=infer,
                nmsed=nmsed, locs=locs, confs=confs, box=box,
                box_var=box_var)


def build_infer(pt, cfg):
    """The inference program alone (path B): dict(main, startup, nmsed)."""
    b = build_train(pt, cfg)
    return dict(main=b["infer"], startup=b["startup"], nmsed=b["nmsed"])


def synthetic_batch(cfg, batch, seed):
    """A VOC-shaped batch from ``seed``: images [B, 3, S, S] of noise with
    1-8 boxes each (normalized corners, sides 0.1-0.6), labels 1 to
    num_classes - 1, each box painted into the image (its label's channel
    raised inside it), padding rows -1. Returns a dict of numpy arrays:
    image, gt_box, gt_label."""
    rng = np.random.RandomState(seed)
    S, G = cfg.image_size, cfg.max_gt
    image = (rng.standard_normal((batch, 3, S, S)) * 0.1).astype(np.float32)
    gt_box = np.zeros((batch, G, 4), np.float32)
    gt_label = np.full((batch, G), -1, np.int32)
    for b in range(batch):
        n = rng.randint(1, min(8, G) + 1)
        wh = rng.uniform(0.1, 0.6, (n, 2))
        xy = rng.uniform(0.0, 1.0, (n, 2)) * (1.0 - wh)
        gt_box[b, :n] = np.concatenate([xy, xy + wh], 1)
        gt_label[b, :n] = rng.randint(1, cfg.num_classes, n)
        for (x1, y1, x2, y2), lab in zip(gt_box[b, :n], gt_label[b, :n]):
            image[b, lab % 3, int(y1 * S):int(y2 * S),
                  int(x1 * S):int(x2 * S)] += 1.0 + lab / cfg.num_classes
    return dict(image=image, gt_box=gt_box, gt_label=gt_label)
