#!/usr/bin/env python3
"""Tell a ReLU tie from a port fault in image-model gradient parity.

    JAX_PLATFORMS=cpu python tools/relu_tie_check.py [--lr 0.1] [--seed 1] \
        [--batch 4]

Trains resnet_cifar10(depth=8, image_size=16) in fp32 for one Momentum
step in the JAX package (``batch`` images of ``synthetic_batch(seed)``),
then, at
the JAX parameters after that step, prints for the element whose gradient
the two packages disagree on most: the JAX gradient, the port's (fp32), the
port's autograd gradient in fp64 (its forward on fp64 tensors) and a
central finite difference of that fp64 loss (h = 1e-8). Where the port
agrees with fp64 and JAX does not, the gap is a ReLU input within rounding
of zero taking the other branch, not a port fault. Also prints how many
ReLU inputs of the port's forward lie within 1e-5 of zero.
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.models import resnet as jres  # noqa: E402
from paddle_tpu.parallel.mesh import MeshConfig, make_mesh, mesh_guard  # noqa: E402
from paddle_tpu_torch.core.tree import leaves, map_tree  # noqa: E402
from paddle_tpu_torch.models import resnet as tres  # noqa: E402


def flat_jax(tree):
    return {".".join(str(getattr(e, "key", getattr(e, "idx", None)))
                     for e in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_port(tree):
    out = {}

    def put(path, t):
        a = t.detach().double().numpy()
        out[path] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    map_tree(put, tree)
    return out


def fp64_loss(params, cfg, images, labels):
    """The port's training loss with every tensor in fp64 (the model's own
    forward casts its pooled features to fp32, so this walks its blocks)."""
    x = torch.tensor(images).double().permute(0, 3, 1, 2)
    x = tres._conv(x, params["stem"]["w"], 1)
    x = F.relu(tres._bn(x, params["stem"]["bn"], True, 0.9, 1e-5)[0])
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            s = tres._stages(cfg)[si][2] if bi == 0 else 1
            x, _ = tres._block_fwd(x, blk, cfg, s, True)
    logits = x.mean((2, 3)) @ params["head"]["w"] + params["head"]["b"]
    return tres._label_smoothed_xent(logits, torch.tensor(labels).long(),
                                     cfg.label_smoothing)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    jcfg = jres.resnet_cifar10(depth=8, image_size=16, dtype=jnp.float32)
    tcfg = tres.resnet_cifar10(depth=8, image_size=16, dtype=torch.float32)
    images, labels = jres.synthetic_batch(jcfg, args.batch,
                                           seed=args.seed)
    with mesh_guard(make_mesh(MeshConfig(data=1, model=1, seq=1, pipe=1))):
        init_fn, step_fn = jres.make_train_step(
            jcfg, jpt.optimizer.Momentum(learning_rate=args.lr, momentum=0.9))
        params, state = init_fn(jax.random.PRNGKey(0))
        _, _, params, _ = step_fn(params, state, jnp.asarray(images),
                                  jnp.asarray(labels))
    p1 = jax.tree.map(lambda a: np.array(a), params)
    (_, _), gj = jax.value_and_grad(jres.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, p1), jcfg, jnp.asarray(images),
        jnp.asarray(labels))
    gj = flat_jax(gj)
    tp = tres.params_from_numpy(p1, tcfg, device="cpu")
    _, _, gt = tres._loss_and_grads(
        lambda p: tres.loss_fn(p, tcfg, images, labels), tp, tcfg)
    gt = flat_port(gt)

    def rel(k):
        return np.abs(gt[k] - gj[k]).max() / max(np.abs(gj[k]).max(), 1e-30)

    key = max(gj, key=rel)
    i = np.unravel_index(np.abs(gt[key] - gj[key]).argmax(), gj[key].shape)
    p64 = map_tree(lambda _, t: t.detach().double().requires_grad_(), tp)
    g64 = iter(torch.autograd.grad(fp64_loss(p64, tcfg, images, labels),
                                   leaves(p64), materialize_grads=True))
    g64 = flat_port(map_tree(lambda _, t: next(g64), p64))
    leaf = p64
    for k in key.split("."):
        leaf = leaf[int(k)] if isinstance(leaf, list) else leaf[k]
    port_i = (i[3], i[2], i[0], i[1]) if leaf.dim() == 4 else i  # OIHW
    h = 1e-8
    with torch.no_grad():
        old = leaf[port_i].item()
        leaf[port_i] = old + h
        up = fp64_loss(p64, tcfg, images, labels).item()
        leaf[port_i] = old - h
        down = fp64_loss(p64, tcfg, images, labels).item()
        leaf[port_i] = old
    print(f"leaf {key} {tuple(int(j) for j in i)}: relative gap "
          f"{rel(key):.3g}; JAX {gj[key][i]:.9g}, port {gt[key][i]:.9g}, "
          f"port in fp64 {g64[key][i]:.9g}, its finite difference (h={h}) "
          f"{(up - down) / (2 * h):.9g}")
    near = []
    orig = tres._relu

    def spy(x):
        near.append(int((x.abs() < 1e-5).sum()))
        return orig(x)

    tres._relu = spy
    with torch.no_grad():
        tres.forward(tp, tcfg, images)
    tres._relu = orig
    print(f"ReLU inputs within 1e-5 of zero, per ReLU: {near}")


if __name__ == "__main__":
    main()
