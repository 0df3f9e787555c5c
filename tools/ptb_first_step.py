"""Where the PTB LSTM language model's first training step spends its host
time, on the card, in a fresh process.

    python3 tools/ptb_first_step.py

Builds ``models/ptb_lm.py``'s training program at ``lm_model.py``'s medium
config, runs the startup program, then profiles the first
``Executor.run`` of the process with ``torch.profiler`` (host and device)
and times three more steps on the host clock. Prints one JSON line: the
card's name and power limit as nvidia-smi gives them, the first step's ms
(profiled), the next three steps' ms, and the host operators by self time
(the top 12: CUDA's lazy module loading shows as "Runtime Triggered Module
Loading").
"""

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    if not torch.cuda.is_available():
        print("ptb_first_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import ptb_lm
    from paddle_tpu_torch.ops.kernels import _build

    _build.build(["embedding", "fused_matmul", "fused_sgd"])
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ptb_lm.medium()
    lm = ptb_lm.build_train(pt, cfg)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(lm["startup"], scope=scope)
    windows = ptb_lm.ptb_windows(ptb_lm.markov_stream(
        cfg, cfg.batch * (cfg.num_steps * 4 + 1), 3), cfg)
    xn, yn = [v.name for v in lm["reader"].vars]
    state = torch.zeros(cfg.batch, cfg.state_width, device="cuda")

    def step(k):
        x, y = windows[k]
        t0 = time.perf_counter()
        exe.run(lm["main"], feed={xn: x, yn: y, "init": state},
                fetch_list=[lm["loss"]], scope=scope)
        return (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        first = step(0)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(dict(
        card=card, first_step_ms_profiled=first,
        next_steps_ms=[step(k) for k in (1, 2, 3)],
        host_top_ms=[[k[:60], ms, n] for k, ms, n in host[:12]])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
