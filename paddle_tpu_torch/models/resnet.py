"""ResNet family (18/34/50/101/152 and the CIFAR variants): the port of
paddle_tpu/models/resnet.py, and the conv, batch-norm and pooling helpers
that ``vgg.py`` and ``se_resnext.py`` import from here, as the JAX
package's models do.

The API keeps the JAX package's: images are NHWC ``[B, H, W, 3]`` (numpy
or tensor), parameters a nested dict/list tree keyed like the JAX one, fp32
masters with the batch-norm running statistics (``mean``, ``var``) as
leaves, activations in ``cfg.dtype`` (bf16 by default). Inside, the model
runs NCHW logically on ``torch.channels_last`` memory (an NHWC image viewed
as NCHW already is), the layout cuDNN's bf16 kernels take on Hopper, and
conv weights are kept OIHW: :func:`params_from_numpy` transposes the JAX
package's HWIO weights.

What is the JAX package's and not PyTorch's default:

- ``padding="SAME"`` puts the odd pixel of padding at the high end (the
  7x7/2 stem at 224 pads 2 before and 3 after; a 3x3/2 conv or max-pool on
  an even side pads 0 and 1): :func:`_conv` and :func:`_maxpool` pad
  explicitly where the two ends differ (``-inf`` for the pool);
- batch norm normalises by the biased batch variance, and updates the
  running statistics as ``m * old + (1 - m) * batch`` with that biased
  variance; the port normalises with ``torch.native_batch_norm`` (no
  running buffers) and updates the statistics itself;
- an fp32 model convolves in fp32: cuDNN's TF32 is off while it runs
  (:func:`_precision`), and back as it was after.

Conv, batch norm and pooling reach no Pallas kernel in the JAX package (XLA
convolutions and plain jnp), so they run through PyTorch here; training
updates the parameters with the optimizer's one ``fused_momentum`` launch
per step. The mesh (data parallelism) is not ported yet.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.tree import map_tree
from paddle_tpu_torch.models._mesh import refuse_mesh
from paddle_tpu_torch.ops.nn import _same_pad, no_tf32

__all__ = ["ResNetConfig", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "resnet_cifar10", "init_params", "params_from_numpy",
           "forward", "loss_fn", "make_train_step", "synthetic_batch",
           "flops_per_image"]

# (block fn, stage depths)
_DEPTHS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    image_size: int = 224
    width: int = 64                  # stem channels
    cifar: bool = False              # 3x3 stem, no maxpool
    cifar_n: int = 3                 # blocks per stage in the CIFAR variant
    dtype: torch.dtype = torch.bfloat16
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    label_smoothing: float = 0.1
    # "block": each residual block under torch.utils.checkpoint, keeping
    # only its conv outputs; the backward recomputes the batch-norm / ReLU
    # chain (the JAX package's save_only_these_names("conv_out", ...))
    remat: str = "none"              # "none" | "block"

    def __post_init__(self):
        if self.remat not in ("none", "block"):
            raise ValueError(
                f"remat must be 'none' or 'block', got {self.remat!r}")

    @property
    def block(self):
        return _DEPTHS[self.depth][0]

    @property
    def stage_depths(self):
        return _DEPTHS[self.depth][1]


def resnet18(**kw):
    return ResNetConfig(depth=18, **kw)


def resnet34(**kw):
    return ResNetConfig(depth=34, **kw)


def resnet50(**kw):
    return ResNetConfig(depth=50, **kw)


def resnet101(**kw):
    return ResNetConfig(depth=101, **kw)


def resnet152(**kw):
    return ResNetConfig(depth=152, **kw)


def resnet_cifar10(depth=20, **kw):
    """CIFAR-10 ResNet: depth in {20, 32, 44, 56, 110}, 3 stages of
    (depth - 2) / 6 basic blocks, 16/32/64 channels."""
    kw.setdefault("num_classes", 10)
    kw.setdefault("image_size", 32)
    kw.setdefault("width", 16)
    return ResNetConfig(depth=18, cifar=True, cifar_n=(depth - 2) // 6, **kw)


# ---------------------------------------------------------------------------
# params: one layout tree of (shape, init) leaves, shared by init_params and
# params_from_numpy; init is "ones", "zeros" or the std of a normal draw
# ---------------------------------------------------------------------------
def _conv_spec(kh, kw, cin, cout):
    """An OIHW conv weight, He-normal over fan-out (the reference's MSRA
    initializer)."""
    return ((cout, cin, kh, kw), float(np.sqrt(2.0 / (kh * kw * cout))))


def _bn_spec(c):
    return {"g": ((c,), "ones"), "b": ((c,), "zeros"),
            "mean": ((c,), "zeros"), "var": ((c,), "ones")}


def _stages(cfg):
    """(stage channels, depth, stride) per stage."""
    if cfg.cifar:
        n = cfg.cifar_n
        return [(16, n, 1), (32, n, 2), (64, n, 2)]
    w = cfg.width
    return [(w, cfg.stage_depths[0], 1), (2 * w, cfg.stage_depths[1], 2),
            (4 * w, cfg.stage_depths[2], 2), (8 * w, cfg.stage_depths[3], 2)]


def _expansion(cfg):
    return 4 if (cfg.block == "bottleneck" and not cfg.cifar) else 1


def _layout(cfg):
    exp = _expansion(cfg)
    stem_k = 3 if cfg.cifar else 7
    p = {"stem": {"w": _conv_spec(stem_k, stem_k, 3, cfg.width),
                  "bn": _bn_spec(cfg.width)},
         "stages": []}
    cin = cfg.width
    for ch, depth, stride in _stages(cfg):
        stage = []
        for i in range(depth):
            s = stride if i == 0 else 1
            blk = {}
            if cfg.block == "bottleneck" and not cfg.cifar:
                blk["conv1"] = _conv_spec(1, 1, cin, ch)
                blk["bn1"] = _bn_spec(ch)
                blk["conv2"] = _conv_spec(3, 3, ch, ch)
                blk["bn2"] = _bn_spec(ch)
                blk["conv3"] = _conv_spec(1, 1, ch, ch * exp)
                blk["bn3"] = _bn_spec(ch * exp)
            else:
                blk["conv1"] = _conv_spec(3, 3, cin, ch)
                blk["bn1"] = _bn_spec(ch)
                blk["conv2"] = _conv_spec(3, 3, ch, ch * exp)
                blk["bn2"] = _bn_spec(ch * exp)
            if s != 1 or cin != ch * exp:
                blk["proj"] = _conv_spec(1, 1, cin, ch * exp)
                blk["proj_bn"] = _bn_spec(ch * exp)
            stage.append(blk)
            cin = ch * exp
        p["stages"].append(stage)
    p["head"] = {"w": ((cin, cfg.num_classes), float(np.sqrt(1.0 / cin))),
                 "b": ((cfg.num_classes,), "zeros")}
    return p


def _walk_layout(spec, fn, path=""):
    if isinstance(spec, dict):
        return {k: _walk_layout(s, fn, f"{path}.{k}".lstrip("."))
                for k, s in spec.items()}
    if isinstance(spec, list):
        return [_walk_layout(s, fn, f"{path}.{i}".lstrip("."))
                for i, s in enumerate(spec)]
    return fn(path, *spec)


def _init_from_layout(layout, generator, device):
    """fp32 leaves of ``layout``: ones, zeros, or ``std * normal`` drawn
    from ``generator`` (a ``torch.Generator`` on the CPU or the card)."""
    device = resolve_device(device)

    def make(_, shape, init):
        if init == "ones":
            return torch.ones(shape, dtype=torch.float32, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=torch.float32, device=device)
        t = init * torch.randn(shape, generator=generator,
                               device=generator.device, dtype=torch.float32)
        return t.to(device)

    return _walk_layout(layout, make)


def _from_numpy(layout, tree, device):
    """The port's params from the JAX package's numpy tree. Strict: every
    leaf a float32 array of the JAX shape (a 4-D conv weight HWIO, the
    transpose of the port's OIHW), every expected leaf present and no
    other; anything else raises."""
    device = resolve_device(device)

    def walk(spec, node, path):
        where = path or "params"
        if isinstance(spec, dict):
            if not isinstance(node, dict):
                raise EnforceNotMet(f"params_from_numpy: {where} must be a "
                                    f"dict, got {type(node).__name__}")
            if set(node) != set(spec):
                raise EnforceNotMet(
                    f"params_from_numpy: {where}: missing "
                    f"{sorted(set(spec) - set(node))}, unexpected "
                    f"{sorted(set(node) - set(spec))}")
            return {k: walk(spec[k], node[k], f"{path}.{k}".lstrip("."))
                    for k in spec}
        if isinstance(spec, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(spec):
                raise EnforceNotMet(
                    f"params_from_numpy: {where} must be a list of "
                    f"{len(spec)}, got {type(node).__name__}")
            return [walk(s, n, f"{path}.{i}")
                    for i, (s, n) in enumerate(zip(spec, node))]
        shape = spec[0]
        want = ((shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4
                else shape)
        if (not isinstance(node, np.ndarray) or node.dtype != np.float32
                or node.shape != want):
            got = (f"{node.dtype}{list(node.shape)}"
                   if isinstance(node, np.ndarray) else type(node).__name__)
            raise EnforceNotMet(
                f"params_from_numpy: {where} must be a float32 numpy array "
                f"of shape {list(want)}, got {got}")
        if len(shape) == 4:                       # HWIO -> OIHW
            node = np.ascontiguousarray(node.transpose(3, 2, 0, 1))
        return torch.tensor(node).to(device)

    return walk(layout, tree, "")


def init_params(cfg, generator, device=None):
    """fp32 params as a nested dict/list tree like the JAX package's (conv
    weights OIHW), drawn from ``generator`` (a ``torch.Generator``, on the
    CPU or on the card). ``device`` defaults to the card."""
    return _init_from_layout(_layout(cfg), generator, device)


def params_from_numpy(tree, cfg, device=None):
    """The port's params from the JAX package's, after
    ``jax.tree.map(np.asarray, params)``: HWIO conv weights become OIHW,
    everything else crosses as it is. Strict (see ``_from_numpy``).
    ``device`` defaults to the card."""
    return _from_numpy(_layout(cfg), tree, device)


def param_shapes(cfg):
    """The parameter tree's shapes (conv weights OIHW), without drawing:
    ``leaves`` of it give the count and sizes."""
    return _walk_layout(_layout(cfg), lambda _, shape, init: shape)


# ---------------------------------------------------------------------------
# forward: the shared helpers
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _precision(dtype):
    """While an fp32 model runs (forward and backward), fp32 convolutions
    and matrix products stay fp32: cuDNN's and cuBLAS's TF32 are off, and
    set back as they were after. A bf16 model changes nothing."""
    if dtype != torch.float32:
        yield
        return
    with no_tf32():
        yield


def _images(images, dtype, device):
    """NHWC images (numpy or tensor) as an NCHW view on channels_last
    memory, in ``dtype`` on ``device``."""
    x = images if isinstance(images, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(images))
    if x.dim() != 4 or x.shape[-1] != 3:
        raise EnforceNotMet(f"images must be [B, H, W, 3], got "
                            f"{list(x.shape)}")
    return x.to(device).permute(0, 3, 1, 2).to(dtype)


def _conv(x, w, stride=1, dilation=1, groups=1):
    """SAME convolution of NCHW ``x`` with the OIHW fp32 weight ``w`` cast
    to x's dtype (lax.conv_general_dilated with padding="SAME"). Symmetric
    padding goes to the convolution; otherwise x is padded first."""
    (h0, h1) = _same_pad(x.shape[2], w.shape[2], stride, dilation)
    (w0, w1) = _same_pad(x.shape[3], w.shape[3], stride, dilation)
    if h0 == h1 and w0 == w1:
        pad = (h0, w0)
    else:
        x = F.pad(x, (w0, w1, h0, h1))
        pad = 0
    return F.conv2d(x, w.to(x.dtype), None, stride, pad, dilation, groups)


def _bn(x, bn, train, momentum, eps):
    """Returns (y, new stats | None). Training normalises by the batch's
    fp32 mean and biased variance, y = (x - mean) * rsqrt(var + eps) * g +
    b in fp32, cast to x's dtype (``torch.native_batch_norm`` with no
    running buffers), and the new running stats are ``momentum * old +
    (1 - momentum) * batch`` with the biased variance, outside autograd.
    Eval mode normalises by the running stats."""
    if not train:
        return F.batch_norm(x, bn["mean"], bn["var"], bn["g"], bn["b"],
                            False, 0.0, eps), None
    y, mean, invstd = torch.native_batch_norm(x, bn["g"], bn["b"], None,
                                              None, True, 0.0, eps)
    with torch.no_grad():
        var = (1.0 / invstd.double().square() - eps).float()
        new = {"g": bn["g"], "b": bn["b"],
               "mean": momentum * bn["mean"] + (1 - momentum) * mean,
               "var": momentum * bn["var"] + (1 - momentum) * var}
    return y, new


def _maxpool(x, window=3, stride=2):
    """SAME max-pool (lax.reduce_window with -inf padding)."""
    (h0, h1) = _same_pad(x.shape[2], window, stride)
    (w0, w1) = _same_pad(x.shape[3], window, stride)
    if h0 == h1 and w0 == w1:
        return F.max_pool2d(x, window, stride, (h0, w0))
    x = F.pad(x, (w0, w1, h0, h1), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def _relu(x):
    """ReLU in place: every caller's input is a fresh tensor that no
    backward reads (a batch-norm output or a residual sum)."""
    return F.relu(x, inplace=True)


def _copy_tree(tree):
    """The same leaves in a new dict/list structure."""
    return map_tree(lambda _, t: t, tree)


def _set_path(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _is_stat(path):
    return path.rsplit(".", 1)[-1] in ("mean", "var")


def _merge_bn_stats(params, bn_params):
    """Copy the ``mean``/``var`` leaves of ``bn_params`` (a tree like
    params) into params' tensors, in place; every other leaf of params
    stays. Returns params. (The JAX package builds a new tree with the same
    leaves.)"""
    with torch.no_grad():
        map_tree(lambda path, p, b: p.copy_(b) if _is_stat(path) else None,
                 params, bn_params)
    return params


def _label_smoothed_xent(logits, labels, eps):
    """-mean(sum(soft * log_softmax(logits))) with soft = onehot * (1 -
    eps) + eps / n, in fp32 (plain, as resnet.py:311-322)."""
    n = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels, n).to(torch.float32)
    soft = onehot * (1 - eps) + eps / n
    return -torch.mean(torch.sum(soft * logp, dim=-1))


def _labels(labels, device):
    x = labels if isinstance(labels, torch.Tensor) \
        else torch.from_numpy(np.asarray(labels))
    return x.to(device=device, dtype=torch.long)


def _accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, -1) == labels)
                      .to(torch.float32))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _block_fwd(x, blk, cfg, stride, train):
    """One residual block, pure: returns (out, {bn key: new stats}), so
    ``remat="block"`` may recompute it."""
    upds = {}

    def bn_apply(h, key):
        y, upd = _bn(h, blk[key], train, cfg.bn_momentum, cfg.bn_eps)
        if upd is not None:
            upds[key] = upd
        return y

    sc = x
    if "proj" in blk:
        sc = bn_apply(_conv(x, blk["proj"], stride), "proj_bn")
    if "conv3" in blk:   # bottleneck
        y = _relu(bn_apply(_conv(x, blk["conv1"]), "bn1"))
        y = _relu(bn_apply(_conv(y, blk["conv2"], stride), "bn2"))
        y = bn_apply(_conv(y, blk["conv3"]), "bn3")
    else:                # basic
        y = _relu(bn_apply(_conv(x, blk["conv1"], stride), "bn1"))
        y = bn_apply(_conv(y, blk["conv2"]), "bn2")
    return _relu(y + sc), upds


def _save_conv_outputs(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.aten.convolution.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                   _save_conv_outputs)


def forward(params, cfg, images, train=True):
    """images: [B, H, W, 3] (numpy or tensor). Returns (logits fp32
    [B, num_classes], new params: a tree like params whose batch-norm stats
    are the updated ones when ``train``, else params itself)."""
    device = params["head"]["w"].device
    with _precision(cfg.dtype):
        x = _images(images, cfg.dtype, device)
        new = _copy_tree(params) if train else params

        def bn_apply(h, bn, path):
            y, upd = _bn(h, bn, train, cfg.bn_momentum, cfg.bn_eps)
            if upd is not None:
                _set_path(new, path, upd)
            return y

        block_fn = _block_fwd
        if cfg.remat == "block" and train and torch.is_grad_enabled():
            def block_fn(*a):
                return checkpoint(_block_fwd, *a, use_reentrant=False,
                                  context_fn=_REMAT_CONTEXT)

        x = _conv(x, params["stem"]["w"], stride=1 if cfg.cifar else 2)
        x = _relu(bn_apply(x, params["stem"]["bn"], ("stem", "bn")))
        if not cfg.cifar:
            x = _maxpool(x)
        stages = _stages(cfg)
        for si, stage in enumerate(params["stages"]):
            for bi, blk in enumerate(stage):
                s = stages[si][2] if bi == 0 else 1
                x, upds = block_fn(x, blk, cfg, s, train)
                for key, upd in upds.items():
                    new["stages"][si][bi][key] = upd
        x = torch.mean(x.to(torch.float32), dim=(2, 3))   # global avg pool
        logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits, new


def loss_fn(params, cfg, images, labels, train=True):
    """Label-smoothed softmax cross-entropy. Returns (loss, (new_params,
    logits))."""
    logits, new_params = forward(params, cfg, images, train=train)
    labels = _labels(labels, logits.device)
    loss = _label_smoothed_xent(logits, labels, cfg.label_smoothing)
    return loss, (new_params, logits)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def _loss_and_grads(loss_of, params, cfg):
    """(loss, aux, grads) of ``loss_of(live params)``: the grads of every
    leaf but the batch-norm stats, which get zeros (JAX differentiates them
    too, and no loss reaches them), so a regularizer and a global-norm clip
    see them as JAX's do. One zero buffer backs every stat's grad."""
    live = map_tree(lambda path, t: t if _is_stat(path)
                    else t.detach().requires_grad_(), params)
    trained = [t for path, t in _with_paths(live) if not _is_stat(path)]
    with _precision(cfg.dtype):
        loss, aux = loss_of(live)
        grads = iter(torch.autograd.grad(loss, trained,
                                         materialize_grads=True))
    stats = [t for path, t in _with_paths(live) if _is_stat(path)]
    zero = torch.zeros(max((t.numel() for t in stats), default=0),
                       dtype=torch.float32, device=loss.device)
    return loss.detach(), aux, map_tree(
        lambda path, t: zero[:t.numel()].view(t.shape) if _is_stat(path)
        else next(grads), live)


def _with_paths(tree):
    out = []
    map_tree(lambda path, t: out.append((path, t)), tree)
    return out


def _batches(images, labels, steps_per_call, device):
    """The per-step (images, labels): slices of a stacked [K, B, H, W, 3]
    batch, or the one batch reused K times; on ``device`` once."""
    stacked = np.ndim(images) == 5
    if stacked and np.shape(images)[0] != steps_per_call:
        raise ValueError(
            f"stacked batch leading axis {np.shape(images)[0]} != "
            f"steps_per_call {steps_per_call}")
    im = images if isinstance(images, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(images))
    im, lb = im.to(device), _labels(labels, device)
    if stacked:
        return [(im[i], lb[i]) for i in range(steps_per_call)]
    return [(im, lb)] * steps_per_call


def _train_step_fns(init, step, optimizer, steps_per_call, device):
    """(init_fn, step_fn) around ``step(params, opt_state, images, labels,
    **kw) -> (loss, acc)``, which updates params and opt_state in place."""
    device = resolve_device(device)

    def init_fn(generator):
        params = init(generator, device)
        return params, optimizer.init(params)

    def step_fn(params, opt_state, images, labels, **kw):
        for im, lb in _batches(images, labels, steps_per_call, device):
            loss, acc = step(params, opt_state, im, lb, **kw)
        return loss, acc, params, opt_state

    return init_fn, step_fn


def make_train_step(cfg, optimizer, mesh=None, steps_per_call=1,
                    device=None):
    """Returns (init_fn, step_fn), as the JAX package's ``make_train_step``
    on one device: ``mesh`` must be None.

    ``init_fn(generator)`` -> (params, opt_state) on ``device`` (the card
    by default). ``step_fn(params, opt_state, images, labels)`` -> (loss,
    acc, params, opt_state): the grads of :func:`loss_fn`, then
    ``optimizer.apply_gradients`` over every leaf (the stats with zero
    grads), then the new batch-norm stats copied over the stat leaves
    (``_merge_bn_stats``); params and opt_state are updated **in place**
    and returned (JAX donates them instead). loss and acc are 0-d fp32
    tensors of the last step; reading them syncs.

    ``steps_per_call > 1`` runs that many steps per call: ``images`` either
    one batch [B, H, W, 3], reused every step, or stacked [K, B, H, W, 3]
    with labels [K, B]."""
    refuse_mesh(mesh, "resnet.make_train_step")

    def step(params, opt_state, images, labels):
        loss, (bn_params, logits), grads = _loss_and_grads(
            lambda p: loss_fn(p, cfg, images, labels), params, cfg)
        optimizer.apply_gradients(params, grads, opt_state)
        _merge_bn_stats(params, bn_params)
        return loss, _accuracy(logits.detach(), labels)

    return _train_step_fns(lambda g, d: init_params(cfg, g, device=d), step,
                           optimizer, steps_per_call, device)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def synthetic_batch(cfg, batch_size, seed=0):
    """Random images [B, H, W, 3] in [0, 1) and int32 labels (numpy),
    identical to the JAX package's."""
    rng = np.random.RandomState(seed)
    images = rng.rand(batch_size, cfg.image_size, cfg.image_size, 3) \
        .astype(np.float32)
    labels = rng.randint(0, cfg.num_classes, (batch_size,), dtype=np.int32)
    return images, labels


def flops_per_image(cfg):
    """Training FLOPs/image ~ 3x forward conv FLOPs (analytic)."""
    fwd = 0
    size = cfg.image_size if cfg.cifar else cfg.image_size // 2
    stem_k = 3 if cfg.cifar else 7
    fwd += 2 * stem_k * stem_k * 3 * cfg.width * size * size
    if not cfg.cifar:
        size //= 2
    cin = cfg.width
    exp = _expansion(cfg)
    for ch, depth, stride in _stages(cfg):
        for i in range(depth):
            if i == 0 and stride == 2:
                size //= 2
            hw = size * size
            if cfg.block == "bottleneck" and not cfg.cifar:
                fwd += 2 * hw * (cin * ch + 9 * ch * ch + ch * ch * exp)
            else:
                fwd += 2 * hw * (9 * cin * ch + 9 * ch * ch * exp)
            if i == 0 and cin != ch * exp:
                fwd += 2 * hw * cin * ch * exp
            cin = ch * exp
    fwd += 2 * cin * cfg.num_classes
    return 3 * fwd
