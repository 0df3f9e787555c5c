"""MobileNetV1 under quantization-aware training, and its int8 deployment:
the model of Fluid 1.5's slim quantization, as Fluid static programs.

Source: PaddlePaddle/models (Fluid 1.5 era) ``PaddleCV/image_classification``
``models/mobilenet.py`` at ``scale=1.0`` (:func:`mobilenet_v1`): 3x224x224
images, 1000 classes; ``conv_bn_layer`` a conv2d with MSRA weights
(``{name}_weights``) and no bias, then ``batch_norm`` with ReLU
(``{name}_bn_scale``, ``_offset``, ``_mean``, ``_variance``); ``conv1`` (3x3,
32, stride 2), then 13 depthwise-separable blocks (a 3x3 conv with
``groups`` = channels, ``{block}_dw``, then a 1x1 conv, ``{block}_sep``),
global average pooling and ``fc(1000)`` (``fc7_weights`` MSRA,
``fc7_offset``). The batch is 256, the ``image_classification`` trainer's
default. 27 convs, 27 batch norms and the fc: 83 trainable tensors.

Training, stated here because the source's trainer offers several:

- the loss is ``softmax_with_cross_entropy`` then ``mean``, as in the
  trainer's ``net_config``;
- Momentum(0.9) at a constant learning rate of 1e-3 with ``L2Decay(4e-5)``
  (the trainer's momentum and decay; a constant rate, as a fine-tune from
  a trained float model runs);
- the quantization is the JAX package's ``QuantizeTranspiler``, applied to
  the training program after ``minimize`` (as the JAX package's test
  applies it): abs-max, 8 bits, weights and activations. Fluid's slim also
  offers moving-average activation scales (``moving_average_abs_max``);
  the JAX transpiler has abs-max only, and this module follows it;
- deployment: :func:`freeze` calibrates the activation ranges over sample
  batches (``calibrate_activations``, abs-max) on the ``clone(for_test=
  True)`` taken before ``minimize``, then ``QuantizationFreezePass`` turns
  it into ``quantized_conv2d`` / ``batch_norm`` / ... / ``quantized_mul``
  over int8 weights.

Images and labels are synthetic (:func:`synthetic_batch`), made from a
seed: the published pretrained weights and ImageNet are not in the
repository, so no top-1 is measured. :func:`mobilenet_v1_tiny` is the CPU
tests' config (32², scale 0.125, the first three blocks, 10 classes, batch
4).

The programs are built with whichever package is passed as ``pt`` (this
one, or the JAX package, whose layers take the same calls), so the two
build the same documents. :func:`conv_bn` is shared with ``models/ssd.py``
(whose convs learn at 0.1 and are unnamed).
"""

import dataclasses
import importlib

import numpy as np

__all__ = ["MobileNetConfig", "mobilenet_v1", "mobilenet_v1_tiny",
           "conv_bn", "mobilenet", "build_qat", "build_train", "freeze",
           "export_served", "synthetic_batch", "param_names",
           "fake_quant_fetch", "quant_flips", "check_flips"]

#: the depthwise-separable blocks: (in width, out width, groups, stride,
#: name), before the width multiplier
BLOCKS = ((32, 64, 32, 1, "conv2_1"), (64, 128, 64, 2, "conv2_2"),
          (128, 128, 128, 1, "conv3_1"), (128, 256, 128, 2, "conv3_2"),
          (256, 256, 256, 1, "conv4_1"), (256, 512, 256, 2, "conv4_2")) \
    + tuple((512, 512, 512, 1, f"conv5_{i + 1}") for i in range(5)) \
    + ((512, 1024, 512, 2, "conv5_6"), (1024, 1024, 1024, 1, "conv6"))


@dataclasses.dataclass(frozen=True)
class MobileNetConfig:
    image_size: int = 224
    num_classes: int = 1000
    scale: float = 1.0
    blocks: int = 13
    batch: int = 256
    lr: float = 1e-3
    momentum: float = 0.9
    l2: float = 4e-5


def mobilenet_v1():
    """The source's network at scale 1.0, batch 256."""
    return MobileNetConfig()


def mobilenet_v1_tiny(**kw):
    """32², scale 0.125, the first three blocks, 10 classes, batch 4."""
    return dataclasses.replace(MobileNetConfig(
        image_size=32, num_classes=10, scale=0.125, blocks=3, batch=4), **kw)


def conv_bn(pt, x, k, c, stride, pad, groups=1, act="relu", name=None,
            learning_rate=1.0):
    """``conv_bn_layer``: a conv2d without bias (MSRA weights) and a batch
    norm with ``act``; with ``name``, the source's parameter names."""
    L = pt.layers
    bn = name and f"{name}_bn"
    conv = L.conv2d(x, c, k, stride=stride, padding=pad, groups=groups,
                    param_attr=pt.ParamAttr(
                        name=name and f"{name}_weights",
                        learning_rate=learning_rate,
                        initializer=pt.initializer.MSRA()),
                    bias_attr=False)
    if name is None:
        return L.batch_norm(conv, act=act)
    return L.batch_norm(conv, act=act,
                        param_attr=pt.ParamAttr(name=f"{bn}_scale"),
                        bias_attr=pt.ParamAttr(name=f"{bn}_offset"),
                        moving_mean_name=f"{bn}_mean",
                        moving_variance_name=f"{bn}_variance")


def mobilenet(pt, cfg, image):
    """The network: logits [B, num_classes]."""
    s = cfg.scale
    x = conv_bn(pt, image, 3, int(32 * s), 2, 1, name="conv1")
    for c1, c2, groups, stride, name in BLOCKS[:cfg.blocks]:
        x = conv_bn(pt, x, 3, int(c1 * s), stride, 1, groups=int(groups * s),
                    name=f"{name}_dw")
        x = conv_bn(pt, x, 1, int(c2 * s), 1, 0, name=f"{name}_sep")
    x = pt.layers.pool2d(x, pool_size=0, pool_type="avg", pool_stride=1,
                         global_pooling=True)
    return pt.layers.fc(
        x, cfg.num_classes,
        param_attr=pt.ParamAttr(name="fc7_weights",
                                initializer=pt.initializer.MSRA()),
        bias_attr=pt.ParamAttr(name="fc7_offset"))


def _quant(pt):
    return importlib.import_module(pt.__name__ + ".contrib.quant")


def build_qat(pt, cfg):
    """The startup program, the QAT training program (``QuantizeTranspiler``
    applied after ``minimize``) and the evaluation program (the
    ``clone(for_test=True)`` taken before ``minimize``). Feeds: ``image``
    [B, 3, S, S] fp32, ``label`` [B, 1] int64. Returns a dict: main,
    startup, test, logits, loss."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.framework.unique_name.guard():
        image = pt.data("image", [3, cfg.image_size, cfg.image_size],
                        "float32")
        label = pt.data("label", [1], "int64")
        logits = mobilenet(pt, cfg, image)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        test = main.clone(for_test=True)
        pt.optimizer.Momentum(
            learning_rate=cfg.lr, momentum=cfg.momentum,
            regularization=pt.regularizer.L2Decay(cfg.l2)).minimize(loss)
    _quant(pt).QuantizeTranspiler().transpile(main)
    return dict(main=main, startup=startup, test=test, logits=logits,
                loss=loss)


def build_train(pt, cfg):
    """The plain (float) training program: the network, the loss and
    Momentum(``cfg.lr``, ``cfg.momentum``) with no weight decay and no
    quantization, and the ``clone(for_test=True)`` taken before
    ``minimize`` that serving exports. Returns a dict: main, startup, test,
    logits, loss."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.framework.unique_name.guard():
        image = pt.data("image", [3, cfg.image_size, cfg.image_size],
                        "float32")
        label = pt.data("label", [1], "int64")
        logits = mobilenet(pt, cfg, image)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        test = main.clone(for_test=True)
        pt.optimizer.Momentum(learning_rate=cfg.lr,
                              momentum=cfg.momentum).minimize(loss)
    return dict(main=main, startup=startup, test=test, logits=logits,
                loss=loss)


def export_served(pt, exe, scope, built, dirname, quantize=None):
    """Deploy the evaluation program of :func:`build_train` (or
    :func:`build_qat`) with ``scope``'s weights: ``save_inference_model``
    (feed ``image``, fetch the logits), then ``export_aot`` of the loaded
    program, which stamps the manifest's ``model_version`` and, with
    ``quantize="int8"``, writes the int8 fc weight the server folds into
    its matmul. ``pt`` is either package. Returns ``dirname``."""
    inference = importlib.import_module(pt.__name__ + ".inference")
    s = int(built["test"].global_block().var("image").shape[-1])
    with pt.static.scope_guard(scope):
        pt.io.save_inference_model(dirname, ["image"], [built["logits"]],
                                   exe, main_program=built["test"])
        prog, feeds, fetches = pt.io.load_inference_model(
            dirname, exe, scope=pt.static.Scope())
    inference.export_aot(dirname, prog, feeds, fetches, scope,
                         [{"image": ((1, 3, s, s), "float32")}],
                         quantize=quantize)
    return dirname


def freeze(pt, exe, scope, test_prog, calib_feeds):
    """Calibrate ``test_prog``'s activation ranges over ``calib_feeds``
    (abs-max), then freeze it to int8 in place (the weights become int8 in
    ``scope``). Returns (activation scales, {weight: scale})."""
    q = _quant(pt)
    scales = q.calibrate_activations(exe, test_prog, calib_feeds,
                                     scope=scope)
    fp = q.QuantizationFreezePass(scope=scope, act_scales=scales)
    fp.apply(test_prog)
    return scales, fp.weight_scales


def synthetic_batch(cfg, batch, seed):
    """dict(image [B, 3, S, S] fp32 in [0, 1), label [B, 1] int64) from
    ``seed``: each class a colour offset over seeded noise."""
    rng = np.random.RandomState(seed)
    s = cfg.image_size
    label = rng.randint(0, cfg.num_classes, (batch, 1)).astype(np.int64)
    image = rng.uniform(0.0, 0.5, (batch, 3, s, s)).astype(np.float32)
    tint = (label[:, 0, None] * np.array([0.37, 0.61, 0.83])) % 0.5
    image += tint[:, :, None, None].astype(np.float32)
    return dict(image=image, label=label)


def param_names(program):
    """The trainable parameters of ``program``, in creation order."""
    return [n for n, v in program.global_block().vars.items()
            if getattr(v, "trainable", False) and v.persistable]


def fake_quant_fetch(program):
    """The fake quant-dequant ops of ``program`` in the forward order, and
    the names to fetch for them: each op's output, scale and input, op
    after op."""
    fq = [op for op in program.global_block().ops
          if op.type == "fake_quantize_dequantize_abs_max"]
    return fq, [n for op in fq for n in (op.outputs["Out"][0],
                                         op.outputs["Out"][1],
                                         op.inputs["X"][0])]


def quant_flips(got, want, bins=127.0):
    """The rounding flips between two runs of the ops of
    :func:`fake_quant_fetch`, given each run's fetched values in that order:
    a fake-quant round turns an ulp of difference before it into a whole
    step where the pre-round value lies within rounding of a half integer.
    Each run's integers come from its own scale (the scales may differ by
    an ulp: each is the max of its input). One tuple per op: (values that
    differ, values, the largest difference in steps, the largest distance
    of ``want``'s pre-round values from a half integer where they
    differ)."""
    recs = []
    for k in range(0, len(want), 3):
        ints = [np.round(r[k] / float(r[k + 1]) * bins) for r in (got, want)]
        diff = ints[0] != ints[1]
        if not diff.any():
            recs.append((0, diff.size, 0.0, 0.0))
            continue
        pre = want[k + 2][diff] / float(want[k + 1]) * bins
        recs.append((int(diff.sum()), diff.size,
                     float(np.abs(ints[0] - ints[1])[diff].max()),
                     float(np.abs(pre - np.floor(pre) - 0.5).max())))
    return recs


def check_flips(recs, share, half_int):
    """(flips, values, fault) over :func:`quant_flips`' records. ``fault``
    says which rule broke, else None: every differing integer one step
    from the other; the first op with a flip (in the forward order) at
    pre-round values within ``half_int`` of a half integer (the later ones
    follow from it through batch norm's batch statistics); at most
    ``share`` of the values flipped."""
    flips = sum(r[0] for r in recs)
    total = sum(r[1] for r in recs)
    fault = None
    steps = [r[2] for r in recs if r[0]]
    if steps and max(steps) != 1.0:
        fault = f"integers differ by {max(steps)} steps"
    elif steps and next(r[3] for r in recs if r[0]) > half_int:
        fault = (f"the first flip lies {next(r[3] for r in recs if r[0])} "
                 "from a half integer")
    elif flips > share * total:
        fault = f"{flips} of {total} quantized values flipped"
    return flips, total, fault
