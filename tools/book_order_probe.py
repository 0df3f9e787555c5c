#!/usr/bin/env python3
"""How far a summation order alone moves the book CNNs' training, on the
CPU: the bounds of chip_smoke.py's phase 21 (``BOOK_TOL``) and the Adam
epsilon of tests/test_torch_book.py come from here.

    python tools/book_order_probe.py order [--model vgg16_bn_drop] [--batch 16]
    JAX_PLATFORMS=cpu python tools/book_order_probe.py bias-noise \
        [--model conv_net|vgg_bn_drop]

``order``: the port on the CPU twice from the same startup weights, with
oneDNN's convolutions on and off (another summation order): the first
step's loss gap and each parameter's gradient relative norm error, then
the loss, parameter and batch-norm-stat gaps after 3 Adam(1e-3, epsilon
1e-4) steps (chip_smoke.py's ``build_conv_net`` / ``build_vgg16_bn_drop``
at drop rate 0, its ``book_batches``).

``bias-noise``: tests/test_torch_book.py's small conv_net (or
vgg_bn_drop) in the JAX package and in the port from the JAX startup's weights: each parameter's
largest gradient in both packages, then each parameter's gap after one
Adam step at epsilon 1e-8 and at 1e-4.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def order(model, batch):
    import chip_smoke as C
    import paddle_tpu_torch as pt
    opt = pt.optimizer.Adam(C.BOOK_LR, epsilon=1e-4)
    if model == "conv_net":
        built = C.build_conv_net(pt, opt)
        feeds = C.book_batches((1, 28, 28), batch, 3, 11)
    else:
        built = C.build_vgg16_bn_drop(pt, opt, drop=0.0)
        feeds = C.book_batches((3, 32, 32), batch, 3, 12)
    main, startup, _, loss, _ = built
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    snap = {n: scope.find_var(n).numpy().copy()
            for n, v in startup.global_block().vars.items() if v.persistable}
    params = C.trainable(main)
    out = {}
    for onednn in (True, False):
        with torch.backends.mkldnn.flags(enabled=onednn):
            s = pt.Scope.from_numpy(snap, "cpu", startup)
            first = exe.run(main, feed=feeds[0], scope=s, fetch_list=[loss] + [
                n + "@GRAD" for n in params])
            losses = [float(first[0])] + [
                float(exe.run(main, feed=f, fetch_list=[loss], scope=s)[0])
                for f in feeds[1:]]
            out[onednn] = (losses, first[1:],
                           {n: s.find_var(n).numpy() for n in snap})
    (la, ga, pa), (lb, gb, pb) = out[True], out[False]
    print(f"{model} batch {batch}: losses oneDNN on {la}, off {lb}")
    for n, a, b in zip(params, ga, gb):
        nb = np.linalg.norm(b)
        print(f"  {n:16s} grad norm {nb:.3e}, relative norm error "
              f"{np.linalg.norm(a - b) / max(nb, 1e-30):.3e}")
    stats = [n for n in snap if n.startswith(("bn_mean", "bn_variance"))]
    print(f"  first-step loss gap {abs(la[0] - lb[0]):.3e}; after 3 steps: "
          f"loss gap {max(abs(x - y) for x, y in zip(la, lb)):.3e}, "
          f"parameter gap {max(np.abs(pa[n] - pb[n]).max() for n in params):.3e}"
          f", bn-stat gap "
          f"{max([np.abs(pa[n] - pb[n]).max() for n in stats] or [0]):.3e}")


def bias_noise(model):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import paddle_tpu as jpt
    from paddle_tpu import nets as jnets
    from paddle_tpu.framework import unique_name as junique
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import nets as tnets
    import test_torch_book as B

    build, feeder, _, _, _ = B.BOOK[model]
    feed = feeder(np.random.RandomState(0))

    def program(pt, nets, un, eps):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), un.guard():
            _, loss = build(pt, nets, 0.0)
            pt.optimizer.AdamOptimizer(5e-3, epsilon=eps).minimize(loss)
        return main, startup

    for eps in (1e-8, 1e-4):
        jm, js = program(jpt, jnets, junique, eps)
        tm, ts = program(tpt, tnets, tpt.unique_name, eps)
        jscope, jexe = jpt.static.Scope(), jpt.Executor()
        jexe.run(js, scope=jscope)
        names = sorted(n for n, v in js.global_block().vars.items()
                       if v.persistable)
        s0 = {n: np.array(jscope.find_var(n)) for n in names}
        tscope = tpt.Scope.from_numpy(s0, "cpu", ts)
        texe = tpt.Executor(tpt.CPUPlace())
        params = [p.name for p in tm.all_parameters() if p.trainable]
        grads = [n + "@GRAD" for n in params]
        jg = jexe.run(jm, feed=feed, fetch_list=grads, scope=jscope)
        tg = texe.run(tm, feed=feed, fetch_list=grads, scope=tscope)
        print(f"Adam epsilon {eps}, one step:")
        for n, a, b in zip(params, jg, tg):
            a = np.asarray(a)
            gap = np.abs(np.array(jscope.find_var(n))
                         - tscope.find_var(n).numpy()).max()
            print(f"  {n:12s} JAX |grad| max {np.abs(a).max():.3e}, min "
                  f"{np.abs(a).min():.3e}; grad gap {np.abs(a - b).max():.3e};"
                  f" parameter gap after the step {gap:.3e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=["order", "bias-noise"])
    ap.add_argument("--model", default=None,
                    help="order: conv_net or vgg16_bn_drop (the default); "
                         "bias-noise: conv_net (the default) or vgg_bn_drop")
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()
    if args.what == "order":
        order(args.model or "vgg16_bn_drop", args.batch)
    else:
        bias_noise(args.model or "conv_net")


if __name__ == "__main__":
    main()
