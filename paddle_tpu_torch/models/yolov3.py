"""YOLOv3 over DarkNet-53 as a Fluid static program: training (three
``yolov3_loss`` levels) and, cloned from the same network, an inference
program (``yolo_box`` per level and one ``multiclass_nms``).

Source: PaddlePaddle/models (Fluid 1.5 era), ``PaddleCV/yolov3``:
``models/darknet.py`` (DarkNet-53: stages of [1, 2, 8, 8, 4] residual
blocks; each ``conv_bn_layer`` a conv without bias, Normal(0, 0.02), then
batch_norm with ``L2Decay(0.)`` on its scale and offset, then
``leaky_relu(0.1)``), ``models/yolov3.py`` (three detection blocks of width
512/256/128, each level's 1x1 route conv, ``resize_nearest(scale=2.)`` and
``concat``; 3 * (5 + 80) = 255 output channels) and ``config.py`` (anchors
[10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326],
masks [[6,7,8], [3,4,5], [0,1,2]], ``ignore_thresh`` 0.7, label smoothing,
Momentum 0.9 under ``linear_lr_warmup(piecewise_decay([400000, 450000],
[1e-3, 1e-4, 1e-5]), 4000, 0., 1e-3)`` with ``L2Decay(5e-4)``, inference at
``valid_thresh`` 0.005, ``nms_topk`` 400, ``nms_posk`` 100, ``nms_thresh``
0.45). :func:`yolov3_coco` is that config at 608^2 and batch 8.

The program is built with whichever package is passed as ``pt`` (this one
or the JAX package), so the two build the same document. Where it departs
from the source: a fixed 608^2 input (no multi-scale sizes, no mixup, so
``gt_score`` is 1 on every real box and 0 on padding); ``resize_nearest``
takes ``scale=2.`` without the source's ``actual_shape`` (the size is
static); ground truth is ``gt_max_num`` = 50 rows, zero-padded, as the
source's reader pads it; the data are synthetic (:func:`synthetic_batch`).

:func:`yolo_tiny` is the CPU tests' config: stages [1, 1, 1, 1, 1] at width
1/16, 64^2 input, 3 classes, batch 2, 4 gt rows.
"""

import dataclasses

import numpy as np

__all__ = ["YOLOConfig", "yolov3_coco", "yolo_tiny", "build_train",
           "build_infer", "synthetic_batch"]

ANCHORS = (10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156,
           198, 373, 326)
ANCHOR_MASKS = ((6, 7, 8), (3, 4, 5), (0, 1, 2))


@dataclasses.dataclass(frozen=True)
class YOLOConfig:
    image_size: int = 608
    num_classes: int = 80
    stages: tuple = (1, 2, 8, 8, 4)
    width: float = 1.0          # channel multiplier of every conv
    batch: int = 8
    max_gt: int = 50
    ignore_thresh: float = 0.7
    label_smooth: bool = True
    lr: float = 0.001
    momentum: float = 0.9
    l2: float = 5e-4
    warmup_iters: int = 4000
    warmup_factor: float = 0.0
    lr_steps: tuple = (400000, 450000)
    lr_gamma: float = 0.1
    valid_thresh: float = 0.005
    nms_topk: int = 400
    nms_posk: int = 100
    nms_thresh: float = 0.45

    def ch(self, c):
        return max(1, int(c * self.width))


def yolov3_coco():
    """config.py's YOLOv3 (DarkNet-53, COCO's 80 classes) at 608^2."""
    return YOLOConfig()


def yolo_tiny(**kw):
    """Stages [1,1,1,1,1] at width 1/16, 64^2, 3 classes, batch 2, G 4."""
    return dataclasses.replace(YOLOConfig(
        image_size=64, num_classes=3, stages=(1, 1, 1, 1, 1),
        width=1 / 16, batch=2, max_gt=4), **kw)


def _conv_bn(pt, x, c, k, stride, pad, name):
    L, P = pt.layers, pt.ParamAttr
    normal = pt.initializer.Normal(0.0, 0.02)
    no_decay = pt.regularizer.L2Decay(0.0)
    conv = L.conv2d(x, c, k, stride=stride, padding=pad,
                    param_attr=P(initializer=normal,
                                 name=name + ".conv.weights"),
                    bias_attr=False)
    bn = name + ".bn"
    out = L.batch_norm(
        conv, param_attr=P(initializer=normal, regularizer=no_decay,
                           name=bn + ".scale"),
        bias_attr=P(initializer=pt.initializer.Constant(0.0),
                    regularizer=no_decay, name=bn + ".offset"),
        moving_mean_name=bn + ".mean", moving_variance_name=bn + ".var")
    return L.leaky_relu(out, alpha=0.1)


def darknet53(pt, cfg, image):
    """DarkNet-53's body: the last three stages' outputs, deepest first."""
    L = pt.layers
    x = _conv_bn(pt, image, cfg.ch(32), 3, 1, 1, "yolo_input")
    down = _conv_bn(pt, x, x.shape[1] * 2, 3, 2, 1, "yolo_input.downsample")
    blocks = []
    for i, count in enumerate(cfg.stages):
        x = down
        for j in range(count):
            name = f"stage.{i}.{j}"
            c1 = _conv_bn(pt, x, cfg.ch(32 * 2 ** i), 1, 1, 0, name + ".0")
            c2 = _conv_bn(pt, c1, cfg.ch(32 * 2 ** i) * 2, 3, 1, 1,
                          name + ".1")
            x = L.elementwise_add(x, c2)
        blocks.append(x)
        if i < len(cfg.stages) - 1:
            down = _conv_bn(pt, x, x.shape[1] * 2, 3, 2, 1,
                            f"stage.{i}.downsample")
    return blocks[-1:-4:-1]


def _detection_block(pt, x, channel, name):
    for j in range(2):
        x = _conv_bn(pt, x, channel, 1, 1, 0, f"{name}.{j}.0")
        x = _conv_bn(pt, x, channel * 2, 3, 1, 1, f"{name}.{j}.1")
    route = _conv_bn(pt, x, channel, 1, 1, 0, f"{name}.2")
    tip = _conv_bn(pt, route, channel * 2, 3, 1, 1, f"{name}.tip")
    return route, tip


def yolov3_heads(pt, cfg, image):
    """The three levels' output maps [B, 3 * (5 + C), H, W], strides 32,
    16 and 8."""
    L, P = pt.layers, pt.ParamAttr
    outputs, route = [], None
    for i, block in enumerate(darknet53(pt, cfg, image)):
        if i > 0:
            block = L.concat([route, block], axis=1)
        route, tip = _detection_block(pt, block, cfg.ch(512 // 2 ** i),
                                      f"yolo_block.{i}")
        outputs.append(L.conv2d(
            tip, len(ANCHOR_MASKS[i]) * (cfg.num_classes + 5), 1,
            param_attr=P(initializer=pt.initializer.Normal(0.0, 0.02),
                         name=f"yolo_output.{i}.conv.weights"),
            bias_attr=P(initializer=pt.initializer.Constant(0.0),
                        regularizer=pt.regularizer.L2Decay(0.0),
                        name=f"yolo_output.{i}.conv.bias")))
        if i < 2:
            route = _conv_bn(pt, route, cfg.ch(256 // 2 ** i), 1, 1, 0,
                             f"yolo_transition.{i}")
            route = L.resize_nearest(route, scale=2.0)
    return outputs


def build_train(pt, cfg):
    """The training program (path C) and, cloned from its network before
    the loss, the inference program (path D). Feeds: ``image`` [B, 3, S,
    S] fp32, ``gt_box`` [B, G, 4] fp32 (normalized cx, cy, w, h, zero rows
    as padding), ``gt_label`` [B, G] int32, ``gt_score`` [B, G] fp32; the
    inference program takes ``image`` and ``im_size`` [B, 2] int32. Returns
    a dict: main, startup, loss, infer, nmsed ([B, 100, 6]), outputs."""
    L = pt.layers
    S, G = cfg.image_size, cfg.max_gt
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.framework.unique_name.guard():
        image = pt.data("image", [3, S, S], "float32")
        gt_box = pt.data("gt_box", [G, 4], "float32")
        gt_label = pt.data("gt_label", [G], "int32")
        gt_score = pt.data("gt_score", [G], "float32")
        outputs = yolov3_heads(pt, cfg, image)
        infer = main.clone(for_test=True)
        with pt.program_guard(infer, startup):
            im_size = pt.data("im_size", [2], "int32")
            boxes, scores = [], []
            for i, out in enumerate(outputs):
                anchors = [a for m in ANCHOR_MASKS[i]
                           for a in ANCHORS[2 * m:2 * m + 2]]
                b, s = L.yolo_box(out, im_size, anchors, cfg.num_classes,
                                  cfg.valid_thresh, 32 // 2 ** i)
                boxes.append(b)
                scores.append(L.transpose(s, perm=[0, 2, 1]))
            nmsed = L.multiclass_nms(
                L.concat(boxes, axis=1), L.concat(scores, axis=2),
                score_threshold=cfg.valid_thresh, nms_top_k=cfg.nms_topk,
                keep_top_k=cfg.nms_posk, nms_threshold=cfg.nms_thresh,
                background_label=-1)
        losses = [L.reduce_mean(L.yolov3_loss(
            out, gt_box, gt_label, list(ANCHORS), list(ANCHOR_MASKS[i]),
            cfg.num_classes, cfg.ignore_thresh, 32 // 2 ** i,
            gt_score=gt_score, use_label_smooth=cfg.label_smooth))
            for i, out in enumerate(outputs)]
        loss = L.sums(losses)
        lr = L.linear_lr_warmup(
            L.piecewise_decay(list(cfg.lr_steps),
                              [cfg.lr * cfg.lr_gamma ** k
                               for k in range(len(cfg.lr_steps) + 1)]),
            cfg.warmup_iters, cfg.lr * cfg.warmup_factor, cfg.lr)
        pt.optimizer.MomentumOptimizer(
            lr, momentum=cfg.momentum,
            regularization=pt.regularizer.L2Decay(cfg.l2)).minimize(loss)
    return dict(main=main, startup=startup, loss=loss, infer=infer,
                nmsed=nmsed, outputs=outputs)


def build_infer(pt, cfg):
    """The inference program alone (path D): dict(main, startup, nmsed)."""
    b = build_train(pt, cfg)
    return dict(main=b["infer"], startup=b["startup"], nmsed=b["nmsed"])


def synthetic_batch(cfg, batch, seed):
    """A COCO-shaped batch from ``seed``: images [B, 3, S, S] of noise with
    1-16 boxes each (normalized cx, cy, w, h; sides 0.05-0.5), labels 0-79
    (0 to num_classes - 1), each box painted into the image, zero padding
    rows to ``max_gt``; ``gt_score`` 1 on real rows; ``im_size`` [B, 2]
    int32 (S, S). Returns a dict of numpy arrays."""
    rng = np.random.RandomState(seed)
    S, G = cfg.image_size, cfg.max_gt
    image = (rng.standard_normal((batch, 3, S, S)) * 0.1).astype(np.float32)
    gt_box = np.zeros((batch, G, 4), np.float32)
    gt_label = np.zeros((batch, G), np.int32)
    gt_score = np.zeros((batch, G), np.float32)
    for b in range(batch):
        n = rng.randint(1, min(16, G) + 1)
        wh = rng.uniform(0.05, 0.5, (n, 2))
        c = wh / 2 + rng.uniform(0.0, 1.0, (n, 2)) * (1.0 - wh)
        gt_box[b, :n] = np.concatenate([c, wh], 1)
        gt_label[b, :n] = rng.randint(0, cfg.num_classes, n)
        gt_score[b, :n] = 1.0
        for (cx, cy, w, h), lab in zip(gt_box[b, :n], gt_label[b, :n]):
            image[b, lab % 3, int((cy - h / 2) * S):int((cy + h / 2) * S),
                  int((cx - w / 2) * S):int((cx + w / 2) * S)] += \
                1.0 + lab / cfg.num_classes
    im_size = np.full((batch, 2), S, np.int32)
    return dict(image=image, gt_box=gt_box, gt_label=gt_label,
                gt_score=gt_score, im_size=im_size)
