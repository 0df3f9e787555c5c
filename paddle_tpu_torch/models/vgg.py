"""VGG-11/13/16/19: the port of paddle_tpu/models/vgg.py.

NHWC images and HWIO-to-OIHW weights as in ``models/resnet.py``, whose
conv, batch-norm and SAME max-pool helpers this model uses. Dropout after
the two fc layers runs only when a ``torch.Generator`` is given, as the JAX
package drops only with a key; its masks cannot reproduce
``jax.random.bernoulli``'s bits, so parity with the JAX package holds with
dropout off.
"""

import dataclasses

import numpy as np
import torch

from paddle_tpu_torch.models._mesh import refuse_mesh
from paddle_tpu_torch.models.resnet import (
    _accuracy, _bn, _bn_spec, _conv, _conv_spec, _copy_tree, _from_numpy,
    _init_from_layout, _labels, _loss_and_grads, _maxpool, _merge_bn_stats,
    _precision, _relu, _train_step_fns, _walk_layout, _images)
from paddle_tpu_torch.models.resnet import synthetic_batch as \
    _resnet_synthetic_batch

__all__ = ["VGGConfig", "vgg11", "vgg13", "vgg16", "vgg19", "init_params",
           "params_from_numpy", "forward", "loss_fn", "make_train_step",
           "synthetic_batch"]

_PLANS = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}
_CHANNELS = (64, 128, 256, 512, 512)


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    depth: int = 16
    num_classes: int = 1000
    image_size: int = 224
    fc_dim: int = 4096
    batch_norm: bool = True
    dropout: float = 0.5
    dtype: torch.dtype = torch.bfloat16
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5


def vgg11(**kw):
    return VGGConfig(depth=11, **kw)


def vgg13(**kw):
    return VGGConfig(depth=13, **kw)


def vgg16(**kw):
    return VGGConfig(depth=16, **kw)


def vgg19(**kw):
    return VGGConfig(depth=19, **kw)


def _layout(cfg):
    p = {"convs": [], "bns": []}
    cin = 3
    for reps, ch in zip(_PLANS[cfg.depth], _CHANNELS):
        for _ in range(reps):
            p["convs"].append(_conv_spec(3, 3, cin, ch))
            p["bns"].append(_bn_spec(ch))
            cin = ch
    # five SAME-padded stride-2 maxpools ceil-divide the spatial dims
    side = cfg.image_size
    for _ in range(5):
        side = -(-side // 2)
    feat = cin * side ** 2

    def fc(i, o):
        return {"w": ((i, o), float(np.sqrt(2.0 / i))), "b": ((o,), "zeros")}

    p["fc1"] = fc(feat, cfg.fc_dim)
    p["fc2"] = fc(cfg.fc_dim, cfg.fc_dim)
    p["head"] = fc(cfg.fc_dim, cfg.num_classes)
    return p


def init_params(cfg, generator, device=None):
    """fp32 params (conv weights OIHW) drawn from ``generator``; ``device``
    defaults to the card."""
    return _init_from_layout(_layout(cfg), generator, device)


def params_from_numpy(tree, cfg, device=None):
    """The port's params from the JAX package's numpy tree (HWIO conv
    weights become OIHW; strict). ``device`` defaults to the card."""
    return _from_numpy(_layout(cfg), tree, device)


def param_shapes(cfg):
    return _walk_layout(_layout(cfg), lambda _, shape, init: shape)


def _dropout(x, rate, generator):
    """x / keep where a uniform draw from ``generator`` is below keep, else
    0 (jax.random.bernoulli's meaning, other bits)."""
    keep = 1.0 - rate
    m = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(m, x / keep, 0.0)


def forward(params, cfg, images, train=True, generator=None):
    """images [B, H, W, 3] -> (logits fp32, new params). Dropout (rate
    ``cfg.dropout``) after fc1 and fc2 only when ``train`` and a
    ``generator`` is given."""
    device = params["head"]["w"].device
    with _precision(cfg.dtype):
        x = _images(images, cfg.dtype, device)
        new = _copy_tree(params) if train else params
        i = 0
        for reps in _PLANS[cfg.depth]:
            for _ in range(reps):
                x = _conv(x, params["convs"][i])
                if cfg.batch_norm:
                    x, upd = _bn(x, params["bns"][i], train, cfg.bn_momentum,
                                 cfg.bn_eps)
                    if upd is not None:
                        new["bns"][i] = upd
                x = _relu(x)
                i += 1
            x = _maxpool(x, window=2, stride=2)
        # flatten in the JAX package's NHWC order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).to(torch.float32)

        def drop(x):
            if not train or cfg.dropout <= 0 or generator is None:
                return x
            return _dropout(x, cfg.dropout, generator)

        x = drop(torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"]))
        x = drop(torch.relu(x @ params["fc2"]["w"] + params["fc2"]["b"]))
        logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits, new


def loss_fn(params, cfg, images, labels, train=True, generator=None):
    """Softmax cross-entropy, -mean(log_softmax[label]). Returns (loss,
    (new_params, logits))."""
    logits, new_params = forward(params, cfg, images, train=train,
                                 generator=generator)
    labels = _labels(labels, logits.device)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.take_along_dim(logp, labels[:, None], dim=-1))
    return loss, (new_params, logits)


def make_train_step(cfg, optimizer, mesh=None, steps_per_call=1,
                    device=None):
    """(init_fn, step_fn) as ``resnet.make_train_step`` (``mesh`` must be
    None), with
    ``step_fn(params, opt_state, images, labels, generator=None)``: dropout
    draws from ``generator``, or from one of the step's own (seeded 0 when
    made) that advances every step, as the JAX package folds its step count
    into the default key; each inner step takes a fresh draw."""
    refuse_mesh(mesh, "vgg.make_train_step")
    own = {}

    def step(params, opt_state, images, labels, generator=None):
        if generator is None:
            dev = images.device
            if dev not in own:
                own[dev] = torch.Generator(device=dev).manual_seed(0)
            generator = own[dev]
        loss, (bn_params, logits), grads = _loss_and_grads(
            lambda p: loss_fn(p, cfg, images, labels, True, generator),
            params, cfg)
        optimizer.apply_gradients(params, grads, opt_state)
        _merge_bn_stats(params, bn_params)
        return loss, _accuracy(logits.detach(), labels)

    return _train_step_fns(lambda g, d: init_params(cfg, g, device=d), step,
                           optimizer, steps_per_call, device)


synthetic_batch = _resnet_synthetic_batch
