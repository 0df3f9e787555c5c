"""Time the port's scatter-add kernel on the card, through its wrapper.

    python3 tools/time_scatter_add.py [--repo DIR] [--label NAME]

Imports ``paddle_tpu_torch`` from ``--repo`` (default: this checkout), so
two versions of the kernel can be compared in one run on one card: call it
once per checkout, in the order A B B A. At each shape the ids and rows are
made on the card from a fixed seed; the kernel's result is held bit for bit
against ``_scatter_add_two_level`` (the plain emulation of its summation
order) on CPU copies, then timed with ``chip_smoke.device_ms`` (20 calls
captured in one CUDA graph; the sort, the sum and the join all count).
Prints one JSON line: the label, the card's name and power limit as
nvidia-smi gives them, and per shape the device ms of each of 5 timings.
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (label, h, d, n): bench.py's CTR point, the same table with the most ids
#: one block sorts and one more, and BERT-base's word gradient
SHAPES = (("CTR [65536,256], 4096 ids", 65536, 256, 4096),
          ("[65536,256], 8192 ids", 65536, 256, 8192),
          ("[65536,256], 8193 ids", 65536, 256, 8193),
          ("word [30528,768], 32768 ids", 30528, 768, 32768))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=ROOT)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_scatter_add: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import device_ms, nvidia_smi_line
    sys.path.insert(0, os.path.abspath(args.repo))
    from paddle_tpu_torch.ops.kernels import embedding as E
    from paddle_tpu_torch.ops.kernels import get_body
    if not E.__file__.startswith(os.path.abspath(args.repo)):
        raise SystemExit(f"imported {E.__file__}, not from {args.repo}")
    kern = get_body("embedding_scatter_add", "kernel")
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {"label": args.label, "repo": os.path.abspath(args.repo),
           "card": nvidia_smi_line(), "ms": {}}
    with torch.inference_mode():
        for label, h, d, n in SHAPES:
            dst = torch.randn(h, d, generator=gen, device="cuda")
            ids = torch.randint(0, h, (n,), generator=gen, device="cuda")
            upd = torch.randn(n, d, generator=gen, device="cuda")
            got = kern(dst, ids, upd).cpu()
            want = E._scatter_add_two_level(dst.cpu(), ids.cpu(), upd.cpu())
            if not torch.equal(got, want):
                raise SystemExit(f"{label}: kernel differs from the "
                                 "two-level emulation")
            out["ms"][label] = [device_ms(lambda: kern(dst, ids, upd), 20)
                                for _ in range(5)]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
