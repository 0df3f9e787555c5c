"""ResNet-50 of Fluid 1.5's dygraph examples, as ``nn.Layer`` classes,
trained eagerly: ``model.init`` / ``model.apply``, ``pt.grad``, then the
optimizer's ``apply_gradients``, the batch norms' running stats carried as
``nn`` state.

Source: PaddlePaddle/models ``dygraph/resnet/train.py`` (Fluid 1.5) and
the reference's ``test_imperative_resnet.py``: ``ConvBNLayer`` (``Conv2D``
without a bias, padding ``(k - 1) // 2``, then ``BatchNorm`` with the
activation), ``BottleneckBlock`` (1x1, 3x3 with the stride, 1x1 to 4x the
filters, a 1x1 ``ConvBNLayer`` shortcut where the shape changes, the sum
through ReLU), a 7x7/2 stem with a 3x3/2 max ``Pool2D``, the depth-50
stages [3, 4, 6, 3] at 64, 128, 256 and 512 filters, a global average
``Pool2D`` and ``FC`` to the classes with softmax (weights
``Uniform(-1/sqrt(2048), 1/sqrt(2048))``), then ``cross_entropy`` and its
mean. :func:`resnet50_flowers` is its configuration: 102 classes
(flowers), 224^2, batch 32, Momentum 0.9 under piecewise decay from 0.1
(x0.1 at epochs 30, 60 and 90 of ceil(1281167 / 32) steps) with
``L2Decay(1e-4)``.

The images are synthetic and seeded (:func:`synthetic_batch`), NCHW fp32
with labels [B, 1] int64. The model and its optimizer are built from
whichever package is passed as ``pt`` (this one, or the JAX package).
:func:`resnet_tiny` is the CPU tests' config: depth-50 blocks, one a
stage, narrow filters, 64^2, batch 4, a rate of 0.01. Smaller images leave
the last stages' batch norms a few values each, and with them ReLU inputs
within rounding of zero that take either branch (ROADMAP queue 3 note f).
"""

import dataclasses
import math

import numpy as np

__all__ = ["DygraphResNetConfig", "resnet50_flowers", "resnet_tiny",
           "build", "make_optimizer", "synthetic_batch", "loss_fn",
           "train_step", "evaluate"]


@dataclasses.dataclass(frozen=True)
class DygraphResNetConfig:
    class_dim: int = 102
    image_size: int = 224
    batch: int = 32
    depth_blocks: tuple = (3, 4, 6, 3)
    num_filters: tuple = (64, 128, 256, 512)
    stem_filters: int = 64
    base_lr: float = 0.1
    momentum: float = 0.9
    l2_decay: float = 1e-4
    total_images: int = 1281167
    epochs: tuple = (30, 60, 90)


def resnet50_flowers():
    """The source's configuration."""
    return DygraphResNetConfig()


def resnet_tiny():
    """The CPU tests' config."""
    return DygraphResNetConfig(class_dim=10, image_size=64, batch=4,
                               depth_blocks=(1, 1, 1, 1),
                               num_filters=(4, 8, 8, 8), stem_filters=8,
                               base_lr=0.01)


def build(pt, cfg):
    """The model, a ``pt.nn.Layer``: ``forward(images, labels,
    is_test=False)`` returns ``(avg_loss, accuracy, softmax output)``."""
    nn, L = pt.nn, pt.layers

    class ConvBNLayer(nn.Layer):
        def __init__(self, num_channels, num_filters, filter_size, stride=1,
                     groups=1, act=None):
            super().__init__("conv_bn_layer")
            self.conv = nn.Conv2D(num_channels, num_filters, filter_size,
                                  stride=stride,
                                  padding=(filter_size - 1) // 2,
                                  groups=groups, bias_attr=False)
            self.bn = nn.BatchNorm(num_filters, act=act)

        def forward(self, x, is_test):
            return self.bn(self.conv(x), is_test=is_test)

    class BottleneckBlock(nn.Layer):
        def __init__(self, num_channels, num_filters, stride, shortcut):
            super().__init__("bottleneck_block")
            self.conv0 = ConvBNLayer(num_channels, num_filters, 1,
                                     act="relu")
            self.conv1 = ConvBNLayer(num_filters, num_filters, 3,
                                     stride=stride, act="relu")
            self.conv2 = ConvBNLayer(num_filters, num_filters * 4, 1)
            if not shortcut:
                self.short = ConvBNLayer(num_channels, num_filters * 4, 1,
                                         stride=stride)
            self.shortcut = shortcut

        def forward(self, x, is_test):
            y = self.conv2(self.conv1(self.conv0(x, is_test), is_test),
                           is_test)
            short = x if self.shortcut else self.short(x, is_test)
            return L.relu(short + y)

    class ResNet(nn.Layer):
        def __init__(self):
            super().__init__("resnet")
            self.stem = ConvBNLayer(3, cfg.stem_filters, 7, stride=2,
                                    act="relu")
            self.pool = nn.Pool2D(pool_size=3, pool_stride=2,
                                  pool_padding=1, pool_type="max")
            blocks, c = [], cfg.stem_filters
            for stage, (n, f) in enumerate(zip(cfg.depth_blocks,
                                               cfg.num_filters)):
                for i in range(n):
                    blocks.append(BottleneckBlock(
                        c, f, 2 if i == 0 and stage != 0 else 1,
                        shortcut=i != 0))
                    c = f * 4
            self.blocks = nn.LayerList(blocks)
            self.gap = nn.Pool2D(pool_size=7, pool_type="avg",
                                 global_pooling=True)
            stdv = 1.0 / math.sqrt(c * 1.0)
            self.out = nn.FC(cfg.class_dim, act="softmax",
                             param_attr=pt.ParamAttr(
                                 initializer=pt.initializer.Uniform(
                                     -stdv, stdv)))

        def forward(self, images, labels, is_test=False):
            x = self.pool(self.stem(images, is_test))
            for b in self.blocks:
                x = b(x, is_test)
            out = self.out(self.gap(x))
            loss = L.mean(L.cross_entropy(out, labels))
            return loss, L.accuracy(out, labels), out

    return ResNet()


def make_optimizer(pt, cfg):
    """Momentum under the source's piecewise decay, with L2 decay."""
    step = int(math.ceil(float(cfg.total_images) / cfg.batch))
    bd = [step * e for e in cfg.epochs]
    lr = [cfg.base_lr * (0.1 ** i) for i in range(len(bd) + 1)]
    return pt.optimizer.Momentum(
        learning_rate=pt.dygraph.PiecewiseDecay(bd, lr, begin=0),
        momentum=cfg.momentum,
        regularization=pt.regularizer.L2Decay(cfg.l2_decay))


def synthetic_batch(cfg, seed, batch=None):
    """Seeded images [B, 3, S, S] fp32 (normal) and labels [B, 1] int64."""
    b = batch or cfg.batch
    rng = np.random.RandomState(seed)
    images = rng.standard_normal(
        (b, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    labels = rng.randint(0, cfg.class_dim, (b, 1)).astype(np.int64)
    return images, labels


def loss_fn(model, params, state, images, labels):
    """``(loss, (loss, new_state, accuracy))`` of one training batch (the
    loss again in the aux, which ``pt.grad`` hands back)."""
    (loss, acc, _), new_state = model.apply(params, state, None, images,
                                            labels)
    return loss, (loss, new_state, acc)


def train_step(pt, model, opt, params, state, opt_state, images, labels):
    """One eager step in either package: ``pt.grad`` of the loss, the new
    batch-norm state kept, then ``opt.apply_gradients`` (in place in this
    package). Returns ``(loss, accuracy, params, state, opt_state)``."""
    grads, (loss, new_state, acc) = pt.grad(
        lambda p: loss_fn(model, p, state, images, labels),
        has_aux=True)(params)
    params, opt_state = opt.apply_gradients(params, grads, opt_state)
    return loss, acc, params, new_state, opt_state


def evaluate(pt, model, params, state, images, labels):
    """The evaluation pass: ``is_test`` under ``pt.no_grad()`` (the running
    stats, no state change). Returns ``(loss, accuracy, softmax)``."""
    with pt.no_grad():
        (loss, acc, out), _ = model.apply(params, state, None, images,
                                          labels, is_test=True)
    return loss, acc, out
