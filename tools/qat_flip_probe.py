#!/usr/bin/env python3
"""How far a rounding flip moves mobilenet_v1_tiny's QAT gradients, on the
CPU: the flip tolerances of tests/test_torch_qat.py and of chip_smoke.py's
phase 44 (``QUANT_TOL``) come from here.

    JAX_PLATFORMS=cpu python tools/qat_flip_probe.py [--seed 0]

One QAT Momentum step of ``models/mobilenet_v1.py``'s tiny config in the
JAX package and in the port from the JAX startup's weights: for each fake
quant-dequant op, the quantized values whose integers differ between the
packages (each package's from its own scale), then each parameter's
largest gradient gap over its own largest gradient and over the largest
of all.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import paddle_tpu as jpt
    from paddle_tpu.static.program import static_mode_guard

    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.models import mobilenet_v1 as mb

    cfg = mb.mobilenet_v1_tiny()
    with static_mode_guard(False):
        t, j = mb.build_qat(tpt, cfg), mb.build_qat(jpt, cfg)
    jscope = jpt.static.Scope()
    jexe = jpt.static.Executor(jpt.CPUPlace())
    jexe.run(j["startup"], scope=jscope)
    names = [n for n, v in j["startup"].global_block().vars.items()
             if v.persistable]
    tscope = tpt.Scope.from_numpy(
        {n: np.array(jscope.find_var(n)) for n in names}, "cpu",
        t["startup"])
    params = mb.param_names(t["main"])
    fq, fq_names = mb.fake_quant_fetch(t["main"])
    fetch = [p + "@GRAD" for p in params] + fq_names
    feed = mb.synthetic_batch(cfg, cfg.batch, seed=args.seed)
    got = tpt.Executor(tpt.CPUPlace()).run(t["main"], feed=feed,
                                           fetch_list=fetch, scope=tscope)
    want = [np.asarray(v) for v in jexe.run(j["main"], feed=feed,
                                            fetch_list=fetch, scope=jscope)]
    n = len(params)
    for op, (flips, size, _, frac) in zip(
            fq, mb.quant_flips(got[n:], want[n:])):
        print(f"{op.outputs['Out'][0]}: {flips} of {size} integers differ"
              + (f" (pre-round {frac:.3g} from a half integer)"
                 if flips else ""))
    gmax = max(float(np.abs(g).max()) for g in want[:n])
    for p, g, w in zip(params, got[:n], want[:n]):
        gap = float(np.abs(g - w).max())
        print(f"{p}: gradient gap {gap / float(np.abs(w).max()):.3g} of its "
              f"largest value, {gap / gmax:.3g} of the largest gradient")


if __name__ == "__main__":
    main()
