"""SE-ResNeXt: the port of paddle_tpu/models/se_resnext.py.

As ``models/resnet.py`` (whose helpers it uses): NHWC images, OIHW weights
(the grouped 3x3 conv's JAX HWIO ``[3, 3, gw / cardinality, gw]`` becomes
``[gw, gw / cardinality, 3, 3]``, grouped by ``cardinality``), bf16
activations with fp32 batch-norm statistics, and squeeze-and-excite as two
small fp32 products over the pooled vector.
"""

import dataclasses

import numpy as np
import torch

from paddle_tpu_torch.models._mesh import refuse_mesh
from paddle_tpu_torch.models.resnet import (
    _accuracy, _bn, _bn_spec, _conv, _conv_spec, _copy_tree, _from_numpy,
    _images, _init_from_layout, _label_smoothed_xent, _labels,
    _loss_and_grads, _maxpool, _merge_bn_stats, _precision, _relu,
    _set_path, _train_step_fns, _walk_layout)
from paddle_tpu_torch.models.resnet import synthetic_batch as \
    _resnet_synthetic_batch

__all__ = ["SEResNeXtConfig", "se_resnext50", "se_resnext_tiny",
           "init_params", "params_from_numpy", "forward", "loss_fn",
           "make_train_step", "synthetic_batch"]


@dataclasses.dataclass(frozen=True)
class SEResNeXtConfig:
    num_classes: int = 1000
    image_size: int = 224
    cardinality: int = 32            # groups in the 3x3 conv
    group_width: int = 4             # channels per group at stage 1
    stage_depths: tuple = (3, 4, 6, 3)
    reduction: int = 16              # SE bottleneck ratio
    width: int = 64                  # stem channels
    dtype: torch.dtype = torch.bfloat16
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    label_smoothing: float = 0.1


def se_resnext50(**kw):
    return SEResNeXtConfig(**kw)


def se_resnext_tiny(**kw):
    """Small config for tests."""
    kw.setdefault("num_classes", 10)
    kw.setdefault("image_size", 32)
    kw.setdefault("cardinality", 4)
    kw.setdefault("group_width", 4)
    kw.setdefault("stage_depths", (1, 1))
    kw.setdefault("width", 16)
    return SEResNeXtConfig(**kw)


def _stage_channels(cfg):
    """Per stage (group channels, output channels): the grouped width
    doubles each stage; the output is twice the grouped width."""
    chans = []
    for s in range(len(cfg.stage_depths)):
        gw = cfg.cardinality * cfg.group_width * (2 ** s)
        chans.append((gw, gw * 2))
    return chans


def _fc_spec(shape, scale=1.0):
    return (shape, scale * float(np.sqrt(2.0 / shape[0])))


def _layout(cfg):
    p = {"stem": {"w": _conv_spec(7, 7, 3, cfg.width),
                  "bn": _bn_spec(cfg.width)},
         "stages": [], "head": {}}
    cin = cfg.width
    for (gw, cout), depth in zip(_stage_channels(cfg), cfg.stage_depths):
        stage = []
        for bi in range(depth):
            blk = {
                "conv1": _conv_spec(1, 1, cin, gw),
                "bn1": _bn_spec(gw),
                # grouped 3x3: OIHW with I = gw / cardinality
                "conv2": _conv_spec(3, 3, gw // cfg.cardinality, gw),
                "bn2": _bn_spec(gw),
                "conv3": _conv_spec(1, 1, gw, cout),
                "bn3": _bn_spec(cout),
                "se_w1": _fc_spec((cout, cout // cfg.reduction)),
                "se_b1": ((cout // cfg.reduction,), "zeros"),
                "se_w2": _fc_spec((cout // cfg.reduction, cout)),
                "se_b2": ((cout,), "zeros"),
            }
            if bi == 0 and cin != cout:
                blk["proj"] = _conv_spec(1, 1, cin, cout)
                blk["proj_bn"] = _bn_spec(cout)
            stage.append(blk)
            cin = cout
        p["stages"].append(stage)
    p["head"]["w"] = _fc_spec((cin, cfg.num_classes), 0.1)
    p["head"]["b"] = ((cfg.num_classes,), "zeros")
    return p


def init_params(cfg, generator, device=None):
    """fp32 params (conv weights OIHW) drawn from ``generator``; ``device``
    defaults to the card."""
    return _init_from_layout(_layout(cfg), generator, device)


def params_from_numpy(tree, cfg, device=None):
    """The port's params from the JAX package's numpy tree (HWIO conv
    weights, grouped ones too, become OIHW; strict). ``device`` defaults to
    the card."""
    return _from_numpy(_layout(cfg), tree, device)


def param_shapes(cfg):
    return _walk_layout(_layout(cfg), lambda _, shape, init: shape)


def _se(x, blk):
    """Squeeze-and-excite: the pooled fp32 vector -> 2 fc -> sigmoid, which
    scales x in x's dtype."""
    z = torch.mean(x.to(torch.float32), dim=(2, 3))       # [B, C]
    z = torch.relu(z @ blk["se_w1"] + blk["se_b1"])
    z = torch.sigmoid(z @ blk["se_w2"] + blk["se_b2"])
    return x * z[:, :, None, None].to(x.dtype)


def forward(params, cfg, images, train=True):
    """images [B, H, W, 3] -> (logits fp32, new params)."""
    device = params["head"]["w"].device
    with _precision(cfg.dtype):
        new = _copy_tree(params) if train else params

        def bn_apply(y, bn, path):
            y, upd = _bn(y, bn, train, cfg.bn_momentum, cfg.bn_eps)
            if upd is not None:
                _set_path(new, path, upd)
            return y

        x = _images(images, cfg.dtype, device)
        x = _conv(x, params["stem"]["w"], stride=2)
        x = _relu(bn_apply(x, params["stem"]["bn"], ("stem", "bn")))
        x = _maxpool(x)
        for si, stage in enumerate(params["stages"]):
            for bi, blk in enumerate(stage):
                s = 2 if (bi == 0 and si > 0) else 1
                at = ("stages", si, bi)
                sc = x
                if "proj" in blk:
                    sc = bn_apply(_conv(x, blk["proj"], stride=s),
                                  blk["proj_bn"], (*at, "proj_bn"))
                elif s != 1:
                    raise AssertionError("a strided block without a proj")
                y = _relu(bn_apply(_conv(x, blk["conv1"]), blk["bn1"],
                                   (*at, "bn1")))
                y = _relu(bn_apply(
                    _conv(y, blk["conv2"], stride=s,
                          groups=cfg.cardinality),
                    blk["bn2"], (*at, "bn2")))
                y = bn_apply(_conv(y, blk["conv3"]), blk["bn3"],
                             (*at, "bn3"))
                y = _se(y, blk)
                x = _relu(y + sc)
        x = torch.mean(x.to(torch.float32), dim=(2, 3))
        logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits, new


def loss_fn(params, cfg, images, labels, train=True):
    """Label-smoothed softmax cross-entropy. Returns (loss, (acc, new
    params))."""
    logits, new = forward(params, cfg, images, train=train)
    labels = _labels(labels, logits.device)
    loss = _label_smoothed_xent(logits, labels, cfg.label_smoothing)
    return loss, (_accuracy(logits.detach(), labels), new)


def make_train_step(cfg, optimizer, mesh=None, steps_per_call=1,
                    device=None):
    """(init_fn, step_fn) as ``resnet.make_train_step`` (``mesh`` must be
    None; ``steps_per_call`` is the port's, after the JAX package's
    parameters): the batch-norm stats are copied over their leaves after
    the optimizer's update, so a regularizer or clip never leaves its mark
    on them."""
    refuse_mesh(mesh, "se_resnext.make_train_step")

    def step(params, opt_state, images, labels):
        loss, (acc, bn_params), grads = _loss_and_grads(
            lambda p: loss_fn(p, cfg, images, labels), params, cfg)
        optimizer.apply_gradients(params, grads, opt_state)
        _merge_bn_stats(params, bn_params)
        return loss, acc

    return _train_step_fns(lambda g, d: init_params(cfg, g, device=d), step,
                           optimizer, steps_per_call, device)


def synthetic_batch(cfg, batch_size, seed=0):
    return _resnet_synthetic_batch(cfg, batch_size, seed=seed)
