#!/usr/bin/env python3
"""Does a card test's result change from run to run under cuDNN's default
algorithms, and not under its deterministic ones?

    python tools/cudnn_determinism_check.py [--runs 6]     # on the card

Runs resnet_cifar10(depth=8, image_size=16) in fp32 for 3 Momentum steps
(lr 0.05, batch 8 of ``synthetic_batch(seed=3)``: the configuration of
``tests/test_torch_cuda.py::test_image_train_step_on_card_matches_cpu``)
``--runs`` times with cuDNN's defaults and ``--runs`` times with
``cudnn.deterministic``, printing each run's loss, a hash of its
parameters and whether they are within the test's 1e-4 of the CPU's;
then how many distinct results each setting gave.
"""

import argparse
import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from paddle_tpu_torch import optimizer  # noqa: E402
from paddle_tpu_torch.core.tree import leaves  # noqa: E402
from paddle_tpu_torch.models import resnet  # noqa: E402


def train(device):
    cfg = resnet.resnet_cifar10(depth=8, image_size=16, dtype=torch.float32)
    images, labels = resnet.synthetic_batch(cfg, 8, seed=3)
    init_fn, step_fn = resnet.make_train_step(
        cfg, optimizer.Momentum(0.05, 0.9), steps_per_call=3, device=device)
    params, state = init_fn(torch.Generator().manual_seed(3))
    loss, _, params, _ = step_fn(params, state, images, labels)
    return float(loss), [t.detach().cpu() for t in leaves(params)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    _, want = train("cpu")
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = False
        hashes = set()
        for i in range(args.runs):
            loss, got = train("cuda")
            h = hashlib.sha256(b"".join(t.numpy().tobytes() for t in got))
            hashes.add(h.hexdigest()[:16])
            worst = max(((a - b).abs() - 1e-4 * b.abs()).max().item()
                        for a, b in zip(got, want))
            print(f"deterministic={det} run {i}: loss {loss!r}, params "
                  f"{h.hexdigest()[:16]}, within 1e-4 of the CPU: "
                  f"{worst <= 1e-4}", flush=True)
        print(f"deterministic={det}: {len(hashes)} distinct results in "
              f"{args.runs} runs", flush=True)


if __name__ == "__main__":
    main()
