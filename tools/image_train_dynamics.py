#!/usr/bin/env python3
"""Per-step losses of ResNet-50 training at bench.py resnet50's config, to
tell optimizer dynamics from a precision fault.

    python3 tools/image_train_dynamics.py [--steps 24]     # on one card

bf16 and fp32 (cuDNN's TF32 off) at Momentum(0.1, 0.9), then bf16 at lr
0.05 and 0.01: batch 256 of ``synthetic_batch`` reused every step, weights
from one seed. Prints the card's name and power limit, then one line of
losses per run. If fp32 follows bf16 step for step, a rising loss is the
rule's dynamics on that batch, not bf16 rounding.
"""

import argparse
import dataclasses
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("image_train_dynamics: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import resnet
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = resnet.resnet50()
    images, labels = resnet.synthetic_batch(cfg, 256)
    images = torch.as_tensor(images, device="cuda")
    labels = torch.as_tensor(labels, device="cuda")
    for dtype, lr in ((torch.bfloat16, 0.1), (torch.float32, 0.1),
                      (torch.bfloat16, 0.05), (torch.bfloat16, 0.01)):
        c = dataclasses.replace(cfg, dtype=dtype)
        init_fn, step_fn = resnet.make_train_step(
            c, optimizer.Momentum(learning_rate=lr, momentum=0.9))
        params, state = init_fn(torch.Generator(device="cuda").manual_seed(7))
        losses = []
        for _ in range(args.steps):
            loss, _, params, state = step_fn(params, state, images, labels)
            losses.append(round(loss.item(), 4))
        print(f"{str(dtype)[6:]} lr {lr}: {losses}", flush=True)
        del params, state
    return 0


if __name__ == "__main__":
    sys.exit(main())
