#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one card

Phases; any failure raises and the script exits non-zero:

0. Require a CUDA device (no CPU fallback); print the card's name and
   power limit.
1. Build every kernel of the path from ``paddle_tpu_torch/ops/kernels/csrc``
   with nvcc (one process per source, all at once).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and a few edge cases, each with its stated
   tolerance, and time kernel, plain version and one PyTorch library call
   (a yardstick only; the port never calls it) beside the kernel's bound:
   LayerNorm, the flash-attention forward and its two backward kernels,
   the multi-tensor Adam over BERT-base's parameter list; and the static
   path's kernels: the embedding gather (word2vec's table with 100 and
   8192 ids, BERT-base's word table with 64x512 ids), the fused matmul
   (each activation at both word2vec fc shapes, those at 8192 rows, and
   BERT's FFN [4096,768]x[768,3072] relu in fp32 and bf16), and SGD and
   momentum (plain and nesterov) over word2vec's parameters, one launch
   per parameter as the static path makes them and one over the list, and
   over BERT-base's 154 tensors.
3. Serve BERT-base masked-LM requests at S=512: 4 batches of 8x512 tokens
   with 80 masked positions each (loss and fill-mask top-1), exactly 26
   LayerNorm launches per batch; one 2x512 batch is held against the port
   run on the CPU in fp32 with the same weights.
4. BERT-base at S=2048 (``attention_impl="auto"`` takes the flash kernel),
   batch 2: exactly 12 flash launches per forward, loss held against the
   dense path on the card.
5. Pretrain BERT-base as ``bench.py``'s default mode does (pretrain-512):
   batch 64x512, gathered MLM head at 80 positions, Adam 1e-4, remat off,
   bf16 softmax, 16 steps per call on one reused batch; 3 calls. Exactly 26
   LayerNorm and 1 Adam launch per step and no flash launch; the loss falls.
6. Pretrain BERT-base at S=2048 as ``bench.py longcontext`` does
   (pretrain-2048): batch 8x2048, flash attention, remat off, dense MLM
   head, 4 steps per call; 3 calls. Exactly 12 flash forward, 12 dK/dV, 12
   dQ, 26 LayerNorm and 1 Adam launch per step; tokens/s beside the dense
   path with remat, as the bench pairs them.
7. Training correctness on the card: (a) BERT-base, 2x128, 3 Adam steps in
   bf16 on the card against the port on the CPU in fp32 from the same
   weights; (b) at S=2048, batch 1, every parameter gradient of one step
   with the flash kernels against dense attention, by relative norm error.
8. The Fluid static path (static-w2v): the word2vec book model (vocabulary
   2073, embedding 32, hidden 256) built with ``paddle_tpu_torch.layers``,
   minimized by SGD(0.001) and run through ``Executor.run`` on the card:
   3 calls of 10 steps at batch 100 and 3 steps at batch 8192, exactly 4
   gather, 2 fused matmul and 5 SGD launches per step; the loss falls. The
   card against the port on the CPU, and the pass pipeline off against on,
   over 3 steps from the same weights; then Momentum(0.001, 0.9), 5
   momentum launches per step.
9. Print one JSON line of every ported kernel (launches on the main paths,
   error, times, bound), the nvidia-smi line, then the result line
   ``{"ok": true, "device": {...}}``.

Kernel times are device times per launch from CUDA events around a CUDA
graph of back-to-back launches (no host overhead; LayerNorm's inputs are
cycled through copies larger than the L2, so it reads from HBM), except
the Adam, SGD and momentum kernels', timed by CUDA events around a loop of
calls queued behind a spin kernel that outlasts their issue (checked; their
wrappers copy a pointer table from pinned memory, which a graph does not
replay).
Request and step latencies are host wall-clock around work that ends in a
synchronize. The device time of the same work captured in a CUDA graph
over its host latency gives the device's busy share, and a
``torch.profiler`` trace of one more request or training step ranks its
device time by kernel (``profile`` in each model phase's line). The
card's SM clock, temperature and power draw are logged at the start, after
phase 2, after each trainer's counted calls and at the end (``card ...``
lines), so a time taken on a slowed card shows as such.
"""

import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
L2_BYTES = 50 * 2 ** 20
PEAK_OPS_PER_S = {                    # dense, NVIDIA data sheet (700 W)
    torch.bfloat16: 989e12,           # tensor cores
    torch.float32: 67e12,             # SIMT fp32 (no TF32 on the path)
}


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


CARD_STATE_FIELDS = ("clocks.sm", "clocks.max.sm", "clocks.mem",
                     "temperature.gpu", "power.draw")


def card_state():
    """The card's SM and memory clocks (MHz), temperature (C) and power
    draw (W) now, as nvidia-smi reads them; a time measured while the SM
    clock sits below its maximum is a time of a slowed card."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + ",".join(CARD_STATE_FIELDS),
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        return {"error": (r.stderr or r.stdout).strip()[:200]}
    vals = r.stdout.strip().splitlines()[0].split(",")
    return dict(zip(CARD_STATE_FIELDS, (v.strip() for v in vals)))


def log_card(label):
    state = card_state()
    log(f"card {label}: " + json.dumps(state))
    return state


def device_ms(fn, n):
    """Device time per call of ``fn``: n calls captured in one CUDA graph,
    replayed between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / n


def host_ms(fn, n):
    """Wall-clock per call, launches issued one by one from Python (the
    wrapper's own cost shows here when the kernel is shorter)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


_SPIN_CYCLES_PER_MS = []


def spin_cycles_per_ms():
    """The card's clock as ``torch.cuda._sleep`` counts it, from one spin
    of 2e7 cycles between two CUDA events."""
    if not _SPIN_CYCLES_PER_MS:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(20_000_000)
        e1.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(20_000_000 / e0.elapsed_time(e1))
    return _SPIN_CYCLES_PER_MS[0]


def events_ms(fn, n):
    """Device time per call of ``fn`` from CUDA events around n calls
    issued from Python (for work a CUDA graph cannot hold). A spin kernel
    ahead of the first event holds the card while the host issues the n
    calls, so they run back to back and a wrapper's host time does not
    count. The spin lasts four times the n calls' measured issue time (at
    least 20 ms); the host's clock from queueing the spin to the last call
    must stay under the spin's device time, or the spin is doubled and the
    run repeated, twice at most, and then the check fails.
    Returns (ms per call, host issue ms per call, spin ms)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    want_ms = max(20.0, 4 * issue_ms)
    for _ in range(3):
        es, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        es.record()
        t0 = time.perf_counter()
        torch.cuda._sleep(int(want_ms * spin_cycles_per_ms()))
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = es.elapsed_time(e0)
        if queued_ms < spin_ms:
            return e0.elapsed_time(e1) / n, queued_ms / n, spin_ms
        want_ms *= 2
    raise AssertionError(
        f"events_ms: issuing {n} calls took {queued_ms:.3f} ms of host "
        f"time, longer than the {spin_ms:.3f} ms spin ahead of them")


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def within(a, b, atol, rtol):
    """|a - b| <= atol + rtol * |b| everywhere."""
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_layer_norm(K, rows, hidden, dtype, gen):
    dev = "cuda"
    x = (torch.randn(rows, hidden, generator=gen, device=dev) * 3 + 1
         ).to(dtype)
    g = torch.randn(hidden, generator=gen, device=dev)
    b = torch.randn(hidden, generator=gen, device=dev)
    kern = K.get_body("fused_layer_norm", "kernel")
    plain = K.get_body("fused_layer_norm", "reference")
    y, mu, rstd = kern(x, g, b, return_stats=True)
    yr, mur, rstdr = plain(x, g, b, return_stats=True)
    torch.cuda.synchronize()
    # y: both round the same fp32 value once to x's dtype; the fp32 sums
    # run in another order, which may flip that rounding by one unit in
    # the last place: rtol 2^-7 for bf16 (one ulp), 1e-5 for fp32.
    # mu, rstd: fp32 reductions in another order, rtol 1e-5.
    rtol_y = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    ok = (within(y, yr, 1e-5, rtol_y) and within(mu, mur, 1e-5, 1e-5)
          and within(rstd, rstdr, 0.0, 1e-5))
    err = max_err(y, yr)
    check(ok, f"fused_layer_norm [{rows},{hidden}] {dtype}: kernel "
              f"disagrees with plain: y {err}, mu {max_err(mu, mur)}, "
              f"rstd {max_err(rstd, rstdr)}")
    nbytes = 2 * x.numel() * x.element_size() + 2 * hidden * 4
    ops = 8 * x.numel()
    b_ms, b_by = bound(nbytes, ops, torch.float32)
    # the bound counts HBM bytes, so the timed launches cycle through
    # copies of x that together exceed twice the L2: each reads x from HBM
    copies = math.ceil(2 * L2_BYTES / (x.numel() * x.element_size()))
    xs = [x] + [x.clone() for _ in range(copies - 1)]
    nxt = itertools.cycle(xs).__next__
    ms = device_ms(lambda: kern(nxt(), g, b), 200)
    plain_ms = device_ms(lambda: plain(nxt(), g, b), 50)
    g_lib, b_lib = g.to(dtype), b.to(dtype)
    lib_ms = device_ms(lambda: torch.nn.functional.layer_norm(
        nxt(), (hidden,), g_lib, b_lib, 1e-12), 200)
    # x in L2, as the model's LayerNorm finds the sum it just wrote
    warm_ms = device_ms(lambda: kern(x, g, b), 200)
    call_ms = host_ms(lambda: kern(x, g, b), 200)
    del xs
    rec = dict(shape=[rows, hidden], dtype=str(dtype), max_abs_err=err,
               mu_err=max_err(mu, mur), rstd_err=max_err(rstd, rstdr),
               tol=f"y atol 1e-5 rtol {rtol_y:g}; mu/rstd rtol 1e-5",
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, l2_warm_ms=warm_ms, host_ms_per_call=call_ms)
    log("check fused_layer_norm " + json.dumps(rec))
    return rec


def check_flash(K, B, H, S, D, dtype, causal, masked_keys, gen):
    dev = "cuda"
    q, k, v = (torch.randn(B, H, S, D, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    bias = None
    if masked_keys:
        bias = torch.zeros(B, S, device=dev)
        bias[:, -masked_keys:] = -1e9
    kern = K.get_body("flash_attention", "kernel")
    plain = K.get_body("flash_attention", "reference")
    o, lse = kern(q, k, v, bias=bias, causal=causal, return_lse=True)
    orf, lser = plain(q, k, v, bias=bias, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    # o: both keep fp32 softmax and products and round once to q's dtype;
    # the sums run in another order (online vs two-pass softmax), which
    # may flip that rounding: atol 1e-4 + one bf16 ulp (rtol 2^-7), or
    # 1e-5 for fp32. lse: fp32 sums of up to S terms, atol 1e-4.
    rtol_o = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    atol_o = 1e-4 if dtype == torch.bfloat16 else 1e-5
    ok = within(o, orf, atol_o, rtol_o) and within(lse, lser, 1e-4, 0.0)
    err = max_err(o, orf)
    check(ok, f"flash_attention {[B, H, S, D]} {dtype} causal={causal}: "
              f"kernel disagrees with plain: o {err}, lse "
              f"{max_err(lse, lser)}")
    pairs = S * (S + 1) / 2 if causal else S * S
    ops = 4 * B * H * D * pairs
    nbytes = (4 * B * H * S * D * q.element_size() + B * H * S * 4
              + (B * S * 4 if bias is not None else 0))
    b_ms, b_by = bound(nbytes, ops, dtype)
    ms = device_ms(lambda: kern(q, k, v, bias=bias, causal=causal), 10)
    plain_ms = device_ms(lambda: plain(q, k, v, bias=bias, causal=causal), 5)
    mask = None if bias is None else bias[:, None, None, :].to(dtype)
    lib_ms = device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal), 10)
    rec = dict(shape=[B, H, S, D], dtype=str(dtype), causal=causal,
               masked_keys=masked_keys, max_abs_err=err,
               lse_err=max_err(lse, lser),
               tol=f"o atol {atol_o:g} rtol {rtol_o:g}; lse atol 1e-4",
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, tflops=ops / (ms * 1e-3) / 1e12)
    log("check flash_attention " + json.dumps(rec))
    return rec


def check_flash_bwd(K, B, H, S, D, dtype, causal, masked_keys, gen,
                    library=False):
    """Both backward kernels against their plain bodies on the residuals of
    the plain forward; returns the dK/dV and dQ records. With ``library``
    (the main shape; non-causal with a key bias), also times the library's
    attention backward alone on the same inputs."""
    dev = "cuda"
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    bias = None
    if masked_keys:
        bias = torch.zeros(B, S, device=dev)
        bias[:, -masked_keys:] = -1e9
    o, lse = K.get_body("flash_attention", "reference")(
        q, k, v, bias=bias, causal=causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, bias, do, lse, delta)
    names = ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
    kern = {n: K.get_body(n, "kernel") for n in names}
    plain = {n: K.get_body(n, "reference") for n in names}
    dk, dv, dbh = kern[names[0]](*args, causal=causal)
    dq = kern[names[1]](*args, causal=causal)
    rdk, rdv, rdbh = plain[names[0]](*args, causal=causal)
    rdq = plain[names[1]](*args, causal=causal)
    torch.cuda.synchronize()
    # dq, dk, dv: both sum fp32 products over up to S rows and round once to
    # q's dtype; the order differs, which may flip that rounding by one
    # unit (rtol 2^-7 for bf16) or move fp32 sums of S terms by ~1e-6 of
    # their scale: atol 1e-4, rtol 1e-5. dbh (fp32 sums of S terms):
    # atol 1e-4, rtol 1e-5.
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    ok = (within(dq, rdq, 1e-4, rtol) and within(dk, rdk, 1e-4, rtol)
          and within(dv, rdv, 1e-4, rtol) and within(dbh, rdbh, 1e-4, 1e-5))
    errs = dict(dq=max_err(dq, rdq), dk=max_err(dk, rdk),
                dv=max_err(dv, rdv), dbh=max_err(dbh, rdbh))
    check(ok, f"flash backward {[B, H, S, D]} {dtype} causal={causal}: "
              f"kernels disagree with plain: {errs}")
    pairs = S * (S + 1) / 2 if causal else S * S
    e = q.element_size()
    n_in = (4 * B * H * S * D * e + 2 * B * H * S * 4
            + (B * S * 4 if bias is not None else 0))
    recs = {}
    for name, n_products, n_out, err in (
            (names[0], 4, 2 * B * H * S * D * e + B * H * S * 4,
             max(errs["dk"], errs["dv"])),
            (names[1], 3, B * H * S * D * e, errs["dq"])):
        b_ms, b_by = bound(n_in + n_out, 2 * n_products * B * H * D * pairs,
                           dtype)
        ms = device_ms(lambda: kern[name](*args, causal=causal), 10)
        plain_ms = device_ms(lambda: plain[name](*args, causal=causal), 2)
        recs[name] = dict(
            shape=[B, H, S, D], dtype=str(dtype), causal=causal,
            masked_keys=masked_keys, max_abs_err=err, errs=errs,
            tol=f"dq/dk/dv atol 1e-4 rtol {rtol:g}; dbh atol 1e-4 rtol 1e-5",
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            tflops=2 * n_products * B * H * D * pairs / (ms * 1e-3) / 1e12)

    lib = dict(library_ms=None, library="timed at the main shape only")
    if library:
        # the library's attention backward alone on the same inputs, with
        # the key bias broadcast as SDPA passes it: cuDNN's, which SDPA
        # picks on the H100 for a biased bf16 attention (its forward and
        # backward kernels fill the profile of SDPA's gradient), and the
        # memory-efficient one beside it (bias gradient off: it would be
        # [B,H,S,S]). Yardsticks for both kernels together, timed only
        check(bias is not None and not causal,
              "the library backward is timed non-causal with a key bias")
        aten = torch.ops.aten
        lbias = bias[:, None, None, :].to(dtype).expand(B, H, S, S)
        (co, clse, cum_q, cum_k, max_q, max_k, cseed, coff,
         _) = aten._scaled_dot_product_cudnn_attention(
            q, k, v, lbias, True, 0.0, False, False)
        eff_o, eff_lse, eff_seed, eff_off = (
            aten._scaled_dot_product_efficient_attention(
                q, k, v, lbias, True, 0.0, False))

        def cudnn_bwd():
            return aten._scaled_dot_product_cudnn_attention_backward(
                do, q, k, v, co, clse, cseed, coff, lbias, cum_q, cum_k,
                max_q, max_k, 0.0, False)

        def efficient_bwd():
            return aten._scaled_dot_product_efficient_attention_backward(
                do, q, k, v, lbias, eff_o, eff_lse, eff_seed, eff_off, 0.0,
                [True, True, True, False], False)

        lib_errs = [max(max_err(a, r) for a, r in zip(fn()[:3],
                                                        (rdq, rdk, rdv)))
                    for fn in (cudnn_bwd, efficient_bwd)]
        lib_ms = device_ms(cudnn_bwd, 10)
        eff_ms = device_ms(efficient_bwd, 10)
        lib = dict(
            library_ms=lib_ms,
            library="aten._scaled_dot_product_cudnn_attention_backward "
                    "(dq, dk, dv; yardstick for both backward kernels)",
            library_max_abs_err_vs_plain=lib_errs[0],
            efficient_backward_ms=eff_ms,
            efficient_backward_max_abs_err_vs_plain=lib_errs[1])
    for name in names:
        recs[name].update(lib)
        log(f"check {name} " + json.dumps(recs[name]))
    return recs


def check_adam(K, bert, t, gen):
    """The multi-tensor Adam kernel against its plain body over BERT-base's
    parameter list (random p, g, m1 and m2 >= 0) at step t."""
    from paddle_tpu_torch.core.tree import leaves
    shapes = [p.shape for p in leaves(bert.init_params(bert.bert_base(),
                                                        gen))]
    p, g, m1, m2 = ([torch.randn(sh, generator=gen, device="cuda")
                     for sh in shapes] for _ in range(4))
    m2 = [x.abs() for x in m2]
    ref = [[x.clone() for x in xs] for xs in (p, g, m1, m2)]
    lib = [[x.clone() for x in xs] for xs in (p, g, m1, m2)]
    step = torch.tensor(t, dtype=torch.int32, device="cuda")
    kern = K.get_body("fused_adam", "kernel")
    plain = K.get_body("fused_adam", "reference")
    kern(p, g, m1, m2, 1e-4, step)
    plain(*ref, 1e-4, step)
    torch.cuda.synchronize()
    # the kernel rounds every product and sum on its own in the plain
    # version's order (no FMA); only powf in the bias correction may differ
    # by an ulp: rtol 1e-6, atol 1e-7
    ok = all(within(x, r, 1e-7, 1e-6)
             for xs, rs in zip((p, m1, m2), (ref[0], ref[2], ref[3]))
             for x, r in zip(xs, rs))
    err = max(max_err(x, r) for xs, rs in zip((p, m1, m2),
                                              (ref[0], ref[2], ref[3]))
              for x, r in zip(xs, rs))
    check(ok, f"fused_adam t={t}: kernel disagrees with plain: {err}")
    # the library's fused Adam divides eps by sqrt(1 - b2^t) where this
    # rule adds it to sqrt(m2) before the bias correction; with eps_t =
    # eps / sqrt(1 - b2^t) the two compute the same update. A yardstick,
    # timed only: the port never calls it
    eps_t = 1e-8 / math.sqrt(1 - 0.999 ** t)
    steps = [torch.tensor(float(t), device="cuda") for _ in p]

    def library():
        torch._fused_adam_(*lib, [], steps, lr=1e-4, beta1=0.9,
                           beta2=0.999, weight_decay=0.0, eps=eps_t,
                           amsgrad=False, maximize=False)

    library()
    lib_err = max(max_err(x, r) for xs, rs in zip(
        (lib[0], lib[2], lib[3]), (ref[0], ref[2], ref[3]))
        for x, r in zip(xs, rs))
    n = sum(x.numel() for x in p)
    b_ms, b_by = bound(28 * n, 12 * n, torch.float32)
    # the wrapper's host cost (checks, pointer table, pinned copy) is the
    # issue time: the spin ahead of the timed calls hides it
    ms, issue_ms, spin_ms = events_ms(
        lambda: kern(p, g, m1, m2, 1e-4, step), 20)
    plain_ms = device_ms(lambda: plain(*ref, 1e-4, step), 3)
    lib_ms = device_ms(library, 20)
    rec = dict(tensors=len(p), elements=n, t=t, max_abs_err=err,
               tol="p/m1/m2 atol 1e-7 rtol 1e-6", ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms,
               library="torch._fused_adam_ with eps / sqrt(1 - b2^t) "
                       "(yardstick, timed only)",
               library_max_abs_err_vs_plain=lib_err,
               bound_ms=b_ms, bound_by=b_by, host_issue_ms_per_call=issue_ms,
               spin_ms=spin_ms, gbytes_per_s=28 * n / (ms * 1e-3) / 1e9)
    log("check fused_adam " + json.dumps(rec))
    del p, g, m1, m2, ref, lib
    return rec


def check_embedding(K, h, d, dtype, n, gen, edge_ids=True):
    """The gather kernel against its plain body on a [h, d] table and n
    ids; with ``edge_ids``, the ids include negative ones (wrap once) and
    ones outside [-h, h) (NaN rows). Timed on n valid ids, the main path's
    kind, beside ``F.embedding`` on the same table and ids."""
    table = torch.randn(h, d, generator=gen, device="cuda").to(dtype)
    ids = torch.randint(0, h, (n,), generator=gen, device="cuda")
    kern = K.get_body("embedding_gather", "kernel")
    plain = K.get_body("embedding_gather", "reference")
    test_ids = ids.clone()
    if edge_ids:
        test_ids[:4] = torch.tensor([-1, -h, h, -h - 1], device="cuda")
    out, ref = kern(table, test_ids), plain(table, test_ids)
    torch.cuda.synchronize()
    # a copy: bit-identical, NaN rows included
    ok = bool((out == ref).logical_or(out.isnan() & ref.isnan()).all())
    err = max_err(torch.nan_to_num(out), torch.nan_to_num(ref))
    check(ok, f"embedding_gather [{h},{d}] {dtype} n={n}: kernel disagrees "
              f"with plain: {err}")
    row = d * table.element_size()
    b_ms, b_by = bound(n * 8 + 2 * n * row, 0, torch.float32)
    ms = device_ms(lambda: kern(table, ids), 50)
    plain_ms = device_ms(lambda: plain(table, ids), 20)
    lib_ms = device_ms(lambda: torch.nn.functional.embedding(ids, table), 50)
    rec = dict(table=[h, d], dtype=str(dtype), ids=n, max_abs_err=err,
               tol="exact (NaN rows where the plain body has them)", ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               library="torch.nn.functional.embedding", bound_ms=b_ms,
               bound_by=b_by, host_ms_per_call=host_ms(
                   lambda: kern(table, ids), 200))
    log("check embedding_gather " + json.dumps(rec))
    return rec


def check_fused_matmul(K, m, k, n, act, dtype, gen, with_bias=True):
    """The fused matmul kernel (+ gelu outside it) against its plain body,
    fp32 out; library yardstick ``torch.addmm`` (no act) or
    ``torch._addmm_activation`` (relu), else none."""
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
         ).to(dtype)
    b = torch.randn(n, generator=gen, device="cuda") if with_bias else None
    kern = K.get_body("fused_matmul", "kernel")
    plain = K.get_body("fused_matmul", "reference")
    kact = None if act == "gelu" else act

    def run_kernel():
        z = kern(x, w, b, kact)
        return torch.nn.functional.gelu(z) if act == "gelu" else z

    def run_plain():
        z = plain(x, w, b, kact)
        return torch.nn.functional.gelu(z) if act == "gelu" else z

    out, ref = run_kernel(), run_plain()
    torch.cuda.synchronize()
    # fp32 sums of K products (bf16 inputs: exact fp32 products) in another
    # order than cuBLAS's (no TF32): atol 1e-4, rtol 1e-4 at outputs O(1)
    err = max_err(out, ref)
    check(within(out, ref, 1e-4, 1e-4),
          f"fused_matmul [{m},{k}]x[{k},{n}] {act} {dtype}: kernel "
          f"disagrees with plain: {err}")
    e = x.element_size()
    nbytes = (m * k + k * n) * e + (n * 4 if b is not None else 0) \
        + m * n * 4
    b_ms, b_by = bound(nbytes, 2 * m * n * k, dtype)
    ms = device_ms(run_kernel, 20)
    plain_ms = device_ms(run_plain, 20)
    lib_ms, lib = None, None
    if act is None:
        lib = "torch.addmm" if b is not None else "torch.mm"
        lib_ms = device_ms((lambda: torch.addmm(b.to(dtype), x, w))
                           if b is not None else (lambda: torch.mm(x, w)), 20)
    elif act == "relu" and b is not None:
        lib = "torch._addmm_activation (one cuBLASLt call, relu epilogue)"
        lib_ms = device_ms(lambda: torch._addmm_activation(b.to(dtype), x, w),
                           20)
    rec = dict(shape=[m, k, n], act=act, dtype=str(dtype), bias=b is not None,
               max_abs_err=err, tol="atol 1e-4 rtol 1e-4 (fp32 out)", ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, library=lib,
               bound_ms=b_ms, bound_by=b_by,
               tflops=2 * m * n * k / (ms * 1e-3) / 1e12)
    log("check fused_matmul " + json.dumps(rec))
    return rec


def check_sgd(K, shapes, rule, gen, label, per_tensor=False):
    """The SGD or momentum kernel against its plain body over fp32 tensors
    of ``shapes`` (bit-identical: every product and sum rounds singly in
    the plain order), timed behind a spin as Adam is. ``per_tensor``: one
    launch per tensor, as the static path's ``apply_optimizer`` ops make
    them; else one launch over the list, as ``apply_gradients`` does.
    Library yardsticks over the list: ``torch._fused_sgd_`` (dampening 0,
    the same rule) and, for SGD, ``torch._foreach_add_(p, g, alpha=-lr)``."""
    name = "fused_sgd" if rule == "sgd" else "fused_momentum"
    nest = rule == "nesterov"
    lr, mu = 1e-3, 0.9
    p, g, v = ([torch.randn(sh, generator=gen, device="cuda")
                for sh in shapes] for _ in range(3))
    ref_p, ref_v = [t.clone() for t in p], [t.clone() for t in v]
    kern = K.get_body(name, "kernel")
    plain = K.get_body(name, "reference")
    lists, ref_lists, scalars = (
        ((p, g), (ref_p, g), (lr,)) if rule == "sgd"
        else ((p, g, v), (ref_p, g, ref_v), (lr, mu, nest)))
    groups = ([[i] for i in range(len(shapes))] if per_tensor
              else [range(len(shapes))])

    def run_kernel():
        for idx in groups:
            kern(*([xs[i] for i in idx] for xs in lists), *scalars)

    def run_plain():
        plain(*ref_lists, *scalars)

    run_kernel()
    run_plain()
    torch.cuda.synchronize()
    outs = list(zip(p, ref_p)) + ([] if rule == "sgd" else list(zip(v, ref_v)))
    err = max(max_err(a, r) for a, r in outs)
    check(all(torch.equal(a, r) for a, r in outs),
          f"{name} ({rule}, {label}): kernel disagrees with plain: {err}")
    n = sum(math.prod(sh) for sh in shapes)
    per_elem = 12 if rule == "sgd" else 20
    b_ms, b_by = bound(per_elem * n, (2 if rule == "sgd" else 5) * n,
                       torch.float32)
    ms, issue_ms, spin_ms = events_ms(run_kernel, 20)
    plain_ms = device_ms(run_plain, 5)
    lib_p = [t.clone() for t in p]
    lib_v = [t.clone() for t in v]

    def fused_sgd_lib():
        torch._fused_sgd_(lib_p, g, [] if rule == "sgd" else lib_v,
                          weight_decay=0.0, momentum=0.0 if rule == "sgd"
                          else mu, lr=lr, dampening=0.0, nesterov=nest,
                          maximize=False, is_first_step=False)

    lib_ms = device_ms(fused_sgd_lib, 20)
    rec = dict(rule=rule, label=label, tensors=len(shapes), elements=n,
               launches_per_update=len(shapes) if per_tensor else 1,
               max_abs_err=err, tol="bit-identical", ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               library="torch._fused_sgd_ (dampening 0: the same rule)",
               bound_ms=b_ms, bound_by=b_by, host_issue_ms_per_call=issue_ms,
               spin_ms=spin_ms)
    if rule == "sgd":
        rec["foreach_add_ms"] = device_ms(
            lambda: torch._foreach_add_(lib_p, g, alpha=-lr), 20)
    log(f"check {name} " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phases 3 and 4: the model
# ---------------------------------------------------------------------------
def serve(bert, params, cfg, batch):
    """One fill-mask request batch: loss and top-1 ids at the masked
    positions, through the model's own entry points."""
    hidden = bert.forward(params, cfg, batch["input_ids"],
                          batch["token_type_ids"], batch["attention_mask"])
    logits = bert._mlm_head(params, cfg, hidden, batch["masked_positions"])
    loss = bert._mlm_xent(logits, batch["masked_labels"],
                          batch["masked_weights"])
    return loss, logits, logits.argmax(-1)


def phase_serving(K, bert, card, ln_ms):
    from paddle_tpu_torch.core.tree import map_tree
    cfg = bert.bert_base()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = bert.init_params(cfg, gen)
    B, S, P = 8, 512, 80
    lat, ln_launches = [], 0
    for i in range(4):
        batch = bert.synthetic_batch(cfg, B, S, seed=i, max_preds=P)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _, top1 = serve(bert, params, cfg, batch)
        loss = loss.item()          # synchronizes
        top1 = top1.cpu().numpy()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        check(counts["fused_layer_norm"] == 26,
              f"batch {i}: {counts['fused_layer_norm']} LayerNorm kernel "
              "launches, expected 26")
        check(counts["flash_attention"] == 0,
              f"batch {i}: flash kernel launched at S=512")
        ln_launches += counts["fused_layer_norm"]
        # random init: logits ~N(0, 0.55^2), so the loss sits near ln(V)
        check(math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size))
              < 1.0, f"batch {i}: loss {loss} not within 1.0 of ln(V)")
        check(top1.shape == (B, P) and top1.min() >= 0
              and top1.max() < cfg.vocab_size, f"batch {i}: bad top-1 ids")
        lat.append(dt)
        log(f"serve batch {i}: {B}x{S} tokens, {P} masked/row, loss "
            f"{loss:.6f}, top1[0,:5] {top1[0, :5].tolist()}, latency "
            f"{dt * 1e3:.3f} ms, {B * S / dt:.1f} tokens/s, "
            f"LayerNorm launches 26 [{card}]")
    steady = lat[1:]
    serving = dict(batch=B, seq=S, masked=P, latency_ms=[t * 1e3 for t in lat],
                   steady_latency_ms=1e3 * sum(steady) / len(steady),
                   steady_tokens_per_s=B * S * len(steady) / sum(steady),
                   ln_launches=ln_launches)
    serving.update(device_split(
        lambda b: serve(bert, params, cfg, b), batch,
        serving["steady_latency_ms"], {"fused_layer_norm": (26, ln_ms)}))

    # the same weights through the port on the CPU in fp32
    batch = bert.synthetic_batch(cfg, 2, S, seed=100, max_preds=P)
    loss_gpu, logits_gpu, _ = serve(bert, params, cfg, batch)
    cfg_cpu = dataclasses.replace(cfg, dtype=torch.float32)
    t0 = time.perf_counter()
    params_cpu = map_tree(lambda _, t: t.cpu(), params)
    loss_cpu, logits_cpu, _ = serve(bert, params_cpu, cfg_cpu, batch)
    cpu_s = time.perf_counter() - t0
    dl = abs(loss_gpu.item() - loss_cpu.item())
    dlog = max_err(logits_gpu.cpu(), logits_cpu)
    # bf16 activations through 12 layers against fp32. Set before the
    # first card run from the same comparison on the CPU (loss diff 2.5e-5,
    # logits 0.043 at a logit std of 0.56): loss within 0.005, logits
    # within 0.15
    check(dl < 0.005 and dlog < 0.15,
          f"card bf16 vs CPU fp32: loss diff {dl}, logits diff {dlog}")
    serving.update(cpu_ref_loss=loss_cpu.item(), gpu_loss=loss_gpu.item(),
                   loss_diff=dl, logits_max_abs_diff=dlog,
                   tol="loss 0.005, logits 0.15", cpu_ref_seconds=cpu_s)
    log("serving " + json.dumps(serving))
    del params
    return serving


#: (group, pattern of the CUDA kernel's name), the first match wins: the
#: port's own kernels, then the library kernels of the plain ops
KERNEL_GROUPS = (
    ("flash_attention", r"flash_fwd_kernel"),
    ("flash_attention_bwd_dkdv", r"flash_bwd_dkdv_kernel"),
    ("flash_attention_bwd_dq", r"flash_bwd_dq_kernel"),
    ("fused_layer_norm", r"layer_norm_fwd_kernel"),
    ("fused_adam", r"fused_adam_kernel"),
    ("embedding_gather", r"::gather_kernel<"),
    ("fused_matmul", r"fused_matmul_kernel"),
    ("fused_sgd", r"fused_sgd_kernel"),
    ("fused_momentum", r"fused_momentum_kernel"),
    ("matmul", r"gemm|xmma|cutlass|cublas|nvjet|sm90_"),
    ("softmax", r"softmax"),
    ("reduction", r"reduce"),
    ("index/scatter/sort", r"index|scatter|gather|sort"),
    ("copy/cast", r"copy|cat"),
    ("elementwise", r"elementwise"),
)


def op_breakdown(fn, top=10, host_top=0):
    """Device time by CUDA kernel over one call of ``fn`` (after one
    warm-up call), from ``torch.profiler``: ms per group of KERNEL_GROUPS
    ("other" for the rest) and the ``top`` kernels by time, names cut to
    100 characters; with ``host_top``, also the host's total time in the
    call and its ``host_top`` operators by self CPU time. Empty when the
    profiler recorded no device time."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    stats = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in stats
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        return {}
    groups = {}
    for name, ms, _ in kernels:
        g = next((g for g, pat in KERNEL_GROUPS
                  if re.search(pat, name, re.I)), "other")
        groups[g] = groups.get(g, 0.0) + ms
    total = sum(groups.values())
    kernels.sort(key=lambda r: -r[1])
    out = dict(
        kernel_ms=total,
        groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        top=[[name[:100], ms, n] for name, ms, n in kernels[:top]])
    if host_top:
        cpu = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                      for e in stats
                      if e.device_type == torch.autograd.DeviceType.CPU),
                     key=lambda r: -r[1])
        out.update(host_ms_profiled=host_ms,
                   host_top=[[n[:80], ms, c] for n, ms, c in cpu[:host_top]])
    return out


def device_split(fn, batch, host_latency_ms, kernels):
    """Where a request's time goes: ``fn(batch)`` captured in a CUDA graph
    gives the device time of the work without the host's launch overhead;
    its ratio to the host latency is the device's busy share, and each
    kernel's share is launches x its device time at the main shape (from
    phase 2) over it.
    Runs after the counted runs; its launches are not counted."""
    dev_batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in batch.items()}
    dev_ms = device_ms(lambda: fn(dev_batch), 3)
    out = dict(device_ms=dev_ms, device_busy_share=dev_ms / host_latency_ms)
    for name, (launches, ms) in kernels.items():
        out[f"{name}_device_share"] = launches * ms / dev_ms
    out["profile"] = op_breakdown(lambda: fn(dev_batch))
    return out


def phase_long_context(K, bert, card, flash_ms, ln_ms):
    cfg = bert.bert_base(max_seq=2048)            # attention_impl "auto"
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = bert.init_params(cfg, gen)
    B, S = 2, 2048
    batch = bert.synthetic_batch(cfg, B, S, seed=7)
    lat, flash_launches, loss_flash = [], 0, None
    for i in range(3):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss = bert.mlm_loss(params, cfg, batch).item()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        check(counts["flash_attention"] == 12,
              f"S=2048 forward {i}: {counts['flash_attention']} flash "
              "kernel launches, expected 12")
        check(counts["fused_layer_norm"] == 26,
              f"S=2048 forward {i}: {counts['fused_layer_norm']} "
              "LayerNorm launches, expected 26")
        check(math.isfinite(loss), f"S=2048 loss {loss}")
        flash_launches += counts["flash_attention"]
        loss_flash = loss
        lat.append(dt)
        log(f"long-context forward {i}: {B}x{S} tokens, loss {loss:.6f}, "
            f"latency {dt * 1e3:.3f} ms, {B * S / dt:.1f} tokens/s, flash "
            f"launches 12 [{card}]")
    cfg_dense = dataclasses.replace(cfg, attention_impl="dense")
    t0 = time.perf_counter()
    loss_dense = bert.mlm_loss(params, cfg_dense, batch).item()
    dense_s = time.perf_counter() - t0
    dl = abs(loss_flash - loss_dense)
    # same weights and dtype; the dense path rounds scores and
    # probabilities to bf16, the kernel keeps them fp32. Set before the
    # first card run from the same comparison on the CPU at 2 layers
    # (loss diff 5e-5): within 0.005
    check(dl < 0.005, f"S=2048 flash loss {loss_flash} vs dense "
                      f"{loss_dense}: diff {dl} >= 0.005")
    steady = lat[1:]
    rec = dict(batch=B, seq=S, latency_ms=[t * 1e3 for t in lat],
               steady_latency_ms=1e3 * sum(steady) / len(steady),
               steady_tokens_per_s=B * S * len(steady) / sum(steady),
               loss_flash=loss_flash, loss_dense=loss_dense, loss_diff=dl,
               tol="loss 0.005", dense_first_call_ms=dense_s * 1e3,
               flash_launches=flash_launches)
    rec.update(device_split(
        lambda b: bert.mlm_loss(params, cfg, b), batch,
        rec["steady_latency_ms"],
        {"flash_attention": (12, flash_ms), "fused_layer_norm": (26, ln_ms)}))
    log("long_context " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phases 5 to 7: training
# ---------------------------------------------------------------------------
FLASH_NAMES = ("flash_attention", "flash_attention_bwd_dkdv",
               "flash_attention_bwd_dq")


def train_split(bert, params, cfg, batch, step_ms, adam_ms, kernels, step):
    """Where a training step's time goes: the forward and backward of one
    step captured in a CUDA graph (no host launch overhead) plus the Adam
    kernel's device time (phase 2) is the step's device time; over the
    host step latency it is the device's busy share. ``kernels`` maps a
    name to (launches, ms per launch) from phase 2 at the step's shapes;
    their product over the step's device time is the kernel's share, and
    ``op_breakdown`` of ``step()`` (one whole training step) ranks the
    kernels. Runs after the counted runs; its launches are not counted."""
    dev_batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in batch.items()}
    fb_ms = device_ms(lambda: bert._loss_and_grads(params, cfg, dev_batch),
                      1)
    dev_ms = fb_ms + adam_ms
    out = dict(fwd_bwd_device_ms=fb_ms, device_ms=dev_ms,
               device_busy_share=dev_ms / step_ms)
    for name, (launches, ms) in kernels.items():
        out[f"{name}_device_share"] = launches * ms / dev_ms
    out["profile"] = op_breakdown(step)
    return out


def train_calls(K, step_fn, params, state, batch, calls, steps, label,
                card):
    """``calls`` calls of ``step_fn`` (``steps`` steps each) on one reused
    batch, each with the launch counts set to 0 just before and read just
    after. Returns (per-call seconds, per-call losses, per-call counts)."""
    lat, losses, counts = [], [], []
    for i in range(calls):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss, params, state = step_fn(params, state, batch)
        loss = loss.item()          # synchronizes
        dt = time.perf_counter() - t0
        counts.append(K.launch_counts())
        check(math.isfinite(loss), f"{label} call {i}: loss {loss}")
        lat.append(dt)
        losses.append(loss)
        log(f"{label} call {i}: {steps} steps, last loss {loss:.6f}, "
            f"{dt * 1e3 / steps:.3f} ms/step [{card}]")
    return lat, losses, counts


def check_counts(label, counts, want):
    for i, c in enumerate(counts):
        for name, n in want.items():
            check(c[name] == n, f"{label} call {i}: {c[name]} {name} "
                                f"launches, expected {n}")


def phase_pretrain_512(K, bert, optimizer, card, adam_ms, ln_step_ms):
    cfg = bert.bert_base(attention_impl="dense", remat=False,
                         softmax_dtype="bf16")
    B, S, P, spc = 64, 512, 80, 16
    opt = optimizer.Adam(learning_rate=1e-4)
    init_fn, step_fn = bert.make_train_step(cfg, opt, steps_per_call=spc)
    params, state = init_fn(torch.Generator(device="cuda").manual_seed(2))
    batch = bert.synthetic_batch(cfg, B, S, max_preds=P)
    with torch.no_grad():
        loss0 = bert.mlm_loss(params, cfg, batch).item()
    torch.cuda.reset_peak_memory_stats()
    lat, losses, counts = train_calls(K, step_fn, params, state, batch, 3,
                                      spc, "pretrain-512", card)
    peak = torch.cuda.max_memory_allocated()
    card_after = log_card("after pretrain-512's calls")
    check_counts("pretrain-512", counts, {
        "fused_layer_norm": 26 * spc, "fused_adam": spc,
        **{n: 0 for n in FLASH_NAMES}})
    check(losses[-1] < loss0, f"pretrain-512: loss {losses[-1]} after "
                              f"{3 * spc} steps, {loss0} before the first")
    step_ms = 1e3 * sum(lat[1:]) / (len(lat[1:]) * spc)
    tps = B * S / (step_ms * 1e-3)
    rec = dict(batch=B, seq=S, masked=P, steps_per_call=spc,
               loss_before=loss0, losses=losses,
               ms_per_step=[t * 1e3 / spc for t in lat],
               steady_ms_per_step=step_ms, steady_tokens_per_s=tps,
               mfu=bert.flops_per_token(cfg, S, P) * tps / PEAK_OPS_PER_S[
                   torch.bfloat16],
               peak_gb=peak / 1e9, card_after=card_after,
               launches={n: sum(c[n] for c in counts) for n in counts[0]})
    _, step1 = bert.make_train_step(cfg, opt)
    rec.update(train_split(bert, params, cfg, batch, step_ms, adam_ms,
                           {"fused_adam": (1, adam_ms),
                            "fused_layer_norm": (1, ln_step_ms)},
                           lambda: step1(params, state, batch)))
    log("pretrain_512 " + json.dumps(rec))
    return rec


def phase_pretrain_2048(K, bert, optimizer, card, fa_ms, adam_ms, ln_ms):
    cfg = bert.bert_base(max_seq=2048, attention_impl="flash", remat=False)
    B, S, spc = 8, 2048, 4
    batch = bert.synthetic_batch(cfg, B, S)
    recs = {}
    for impl, remat, calls in (("flash", False, 3), ("dense", True, 2)):
        c = dataclasses.replace(cfg, attention_impl=impl, remat=remat)
        opt = optimizer.Adam(learning_rate=1e-4)
        init_fn, step_fn = bert.make_train_step(c, opt, steps_per_call=spc)
        params, state = init_fn(
            torch.Generator(device="cuda").manual_seed(3))
        torch.cuda.reset_peak_memory_stats()
        label = f"pretrain-2048 {impl}"
        lat, losses, counts = train_calls(K, step_fn, params, state, batch,
                                          calls, spc, label, card)
        peak = torch.cuda.max_memory_allocated()
        card_after = log_card(f"after {label}'s calls")
        step_ms = 1e3 * sum(lat[1:]) / (len(lat[1:]) * spc)
        tps = B * S / (step_ms * 1e-3)
        recs[impl] = dict(
            remat=remat, losses=losses, card_after=card_after,
            ms_per_step=[t * 1e3 / spc for t in lat],
            steady_ms_per_step=step_ms, steady_tokens_per_s=tps,
            mfu=bert.flops_per_token(c, S) * tps / PEAK_OPS_PER_S[
                torch.bfloat16],
            peak_gb=peak / 1e9,
            launches={n: sum(x[n] for x in counts) for n in counts[0]})
        if impl == "flash":
            check_counts(label, counts, {
                **{n: 12 * spc for n in FLASH_NAMES},
                "fused_layer_norm": 26 * spc, "fused_adam": spc})
            _, step1 = bert.make_train_step(c, opt)
            recs[impl].update(train_split(
                bert, params, c, batch, step_ms, adam_ms,
                {**{n: (12, fa_ms[n]) for n in FLASH_NAMES},
                 "fused_adam": (1, adam_ms),
                 "fused_layer_norm": (26, ln_ms)},
                lambda: step1(params, state, batch)))
        del params, state
    rec = dict(batch=B, seq=S, steps_per_call=spc, **recs,
               flash_vs_dense_tokens_per_s=(
                   recs["flash"]["steady_tokens_per_s"]
                   / recs["dense"]["steady_tokens_per_s"]))
    log("pretrain_2048 " + json.dumps(rec))
    return rec


def phase_train_checks(bert, optimizer, card):
    from paddle_tpu_torch.core.tree import leaves
    # (a) the card in bf16 against the CPU in fp32, same weights and batch
    cfg = bert.bert_base(remat=False)
    batch = bert.synthetic_batch(cfg, 2, 128, seed=5, max_preds=20)
    losses = {}
    for dev, c in (("cuda", cfg),
                   ("cpu", dataclasses.replace(cfg, dtype=torch.float32))):
        init_fn, step_fn = bert.make_train_step(
            c, optimizer.Adam(learning_rate=1e-4), device=dev)
        params, state = init_fn(torch.Generator().manual_seed(3))
        losses[dev] = []
        for _ in range(3):
            loss, params, state = step_fn(params, state, batch)
            losses[dev].append(loss.item())
        del params, state
    diffs = [abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"])]
    # set before the first card run from the same comparison on the CPU
    # (port bf16 against port fp32): loss differences 0.0012, 0.0049 and
    # 0.0088 over the three steps: within 0.03 at every step
    check(max(diffs) < 0.03, f"train card bf16 vs CPU fp32: losses "
                             f"{losses}, diffs {diffs}")
    rec = dict(losses_card_bf16=losses["cuda"], losses_cpu_fp32=losses["cpu"],
               loss_diffs=diffs, tol="loss 0.03 at each of 3 steps")
    log(f"train check (a): card bf16 {losses['cuda']} vs CPU fp32 "
        f"{losses['cpu']} [{card}]")

    # (b) flash against dense attention: every parameter gradient
    cfg = bert.bert_base(max_seq=2048, attention_impl="flash", remat=False)
    params = bert.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(4))
    batch = bert.synthetic_batch(cfg, 1, 2048, seed=6)
    lf, gf = bert._loss_and_grads(params, cfg, batch)
    ld, gd = bert._loss_and_grads(
        params, dataclasses.replace(cfg, attention_impl="dense"), batch)
    errs = [((a - b).norm() / b.norm().clamp_min(1e-12)).item()
            for a, b in zip(leaves(gf), leaves(gd))]
    # set before the first card run from the same comparison on the CPU
    # (the port's plain bodies, 12 layers, bf16): relative norm errors
    # median 0.012, max 0.015 (the dense path rounds scores and
    # probabilities to bf16; flash keeps them fp32): within 0.05
    check(max(errs) < 0.05, f"S=2048 flash vs dense gradients: max "
                            f"relative norm error {max(errs)}")
    rec.update(grad_loss_flash=lf.item(), grad_loss_dense=ld.item(),
               grad_rel_norm_err_max=max(errs),
               grad_rel_norm_err_median=sorted(errs)[len(errs) // 2],
               grad_tol="relative norm error 0.05 per leaf")
    log("train_checks " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phase 8: the Fluid static-graph path (static-w2v)
# ---------------------------------------------------------------------------
W2V_VOCAB, W2V_EMBED, W2V_HIDDEN = 2073, 32, 256


def build_word2vec(pt, opt):
    """The reference's book test (test_word2vec.py): an N-gram model over
    four context words sharing one embedding table, fc(256, sigmoid),
    fc(2073, softmax), cross_entropy, mean, minimized by ``opt``."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        words = [pt.data(f"w{i}", [1], "int64") for i in range(4)]
        nxt = pt.data("next", [1], "int64")
        embs = [pt.layers.embedding(w, size=[W2V_VOCAB, W2V_EMBED],
                                    param_attr="shared_w") for w in words]
        concat = pt.layers.concat(embs, axis=1)
        hidden = pt.layers.fc(concat, W2V_HIDDEN, act="sigmoid")
        pred = pt.layers.fc(hidden, W2V_VOCAB, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, nxt))
        opt.minimize(loss)
    return main, startup, loss


def w2v_feed(batch, seed):
    import numpy as np
    ids = np.random.RandomState(seed).randint(0, W2V_VOCAB, (batch, 5))
    feed = {f"w{i}": ids[:, i:i + 1] for i in range(4)}
    feed["next"] = ids[:, 4:5]
    return feed


W2V_PARAMS = ("shared_w", "fc_w", "fc_b", "fc_w_1", "fc_b_1")


def static_steps(K, exe, main, loss, feed, scope, steps, want, label, card):
    """``steps`` runs of ``main`` through ``Executor.run`` (each fetching
    the loss as numpy, as a fluid script does, which waits for the step),
    launch counts set to 0 just before and read just after, held to
    ``want`` per step. Returns (losses, ms of each step, counts)."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = K.launch_counts()
    for name, n in want.items():
        check(counts[name] == n * steps,
              f"{label}: {counts[name]} {name} launches in {steps} steps, "
              f"expected {n} per step")
    check(all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")
    log(f"{label}: {steps} steps, loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
        f"{sum(step_ms) / steps:.3f} ms/step (median "
        f"{statistics.median(step_ms):.3f}) [{card}]")
    return losses, step_ms, counts


def phase_static_w2v(K, pt, card):
    """The word2vec book model through the Fluid static path on the card:
    Program, layers, append_backward (minimize), the pass pipeline and
    Executor.run, with exact launch counts per step."""
    per_step = {"embedding_gather": 4, "fused_matmul": 2, "fused_sgd": 5,
                "fused_momentum": 0, "fused_adam": 0, "fused_layer_norm": 0,
                **{n: 0 for n in FLASH_NAMES}}
    main, startup, loss = build_word2vec(
        pt, pt.optimizer.SGDOptimizer(learning_rate=0.001))
    exe = pt.Executor()                   # the card, by default
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    # the weights every comparison below starts from
    snap = {n: scope.find_var(n).cpu().numpy().copy()
            for n in (*W2V_PARAMS, "@opt@SGDOptimizer@step")}
    feed = w2v_feed(100, 0)
    rec = dict(vocab=W2V_VOCAB, embed=W2V_EMBED, hidden=W2V_HIDDEN,
               optimizer="SGD 0.001", launches_per_step=per_step)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    calls, call_ms = [], []
    for i in range(3):
        losses, ms, counts = static_steps(
            K, exe, main, loss, feed, scope, 10, per_step,
            f"static-w2v SGD batch 100 call {i}", card)
        calls.append(losses)
        call_ms.append(ms)
        add(counts)
    check(calls[-1][-1] < calls[0][0], f"static-w2v: loss {calls[-1][-1]} "
                                       f"after 30 steps, {calls[0][0]} first")
    # steady state: calls 2-3 (the first pays first-use costs)
    steady = call_ms[1] + call_ms[2]
    rec.update(batch100_losses=[c[0] for c in calls] + [calls[-1][-1]],
               batch100_ms_per_step=[sum(c) / len(c) for c in call_ms],
               batch100_steady_ms_per_step=statistics.median(steady),
               batch100_steady_ms_quartiles=statistics.quantiles(steady,
                                                                 n=4))
    # where a step's time goes: the profile of one more step, its kernel
    # time over the step's host latency (the steps above sync on the
    # fetched loss), and the host time of 10 steps that fetch no numpy
    prof = op_breakdown(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope), host_top=12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                return_numpy=False)
    torch.cuda.synchronize()
    rec.update(profile=prof, device_busy_share=prof.get("kernel_ms", 0.0)
               / rec["batch100_steady_ms_per_step"],
               async_ms_per_step=(time.perf_counter() - t0) * 1e2)

    big = w2v_feed(8192, 1)
    losses, ms, counts = static_steps(K, exe, main, loss, big, scope, 3,
                                      per_step, "static-w2v SGD batch 8192",
                                      card)
    add(counts)
    prof8k = op_breakdown(lambda: exe.run(main, feed=big, fetch_list=[loss],
                                          scope=scope), host_top=12)
    # steady state: steps 2-3 (the first allocates the new shapes' memory)
    rec.update(batch8192_losses=losses, batch8192_step_ms=ms,
               batch8192_steady_ms_per_step=sum(ms[1:]) / 2,
               batch8192_profile=prof8k,
               batch8192_device_busy_share=prof8k.get("kernel_ms", 0.0)
               / (sum(ms[1:]) / 2))

    # the card against the port on the CPU, 3 steps from the same weights;
    # and the pass pipeline off against on, on the card
    def from_snap(device, passes=True, steps=3):
        s = pt.Scope.from_numpy(snap, device, startup)
        e = pt.Executor(pt.CPUPlace() if device == "cpu" else None)
        pt.set_flags({"apply_ir_passes": passes})
        try:
            K.reset_launch_counts()
            out = [float(e.run(main, feed=feed, fetch_list=[loss],
                               scope=s)[0]) for _ in range(steps)]
            counts = K.launch_counts()
        finally:
            pt.set_flags({"apply_ir_passes": True})
        return out, {n: s.find_var(n).cpu() for n in W2V_PARAMS}, counts

    card_l, card_p, _ = from_snap("cuda")
    cpu_l, cpu_p, _ = from_snap("cpu")
    off_l, off_p, off_counts = from_snap("cuda", passes=False)
    dl = max(abs(a - b) for a, b in zip(card_l, cpu_l))
    dp = max(max_err(card_p[n], cpu_p[n]) for n in W2V_PARAMS)
    # fp32 on both; the card's kernels and cuBLAS sum in other orders than
    # the CPU's (the port on the CPU matches the JAX package within 1e-6,
    # tests/test_torch_static.py): losses 1e-4, parameters 1e-5
    check(dl < 1e-4 and dp < 1e-5, f"static-w2v card vs CPU: losses "
                                   f"{card_l} vs {cpu_l}, params diff {dp}")
    d_off = max(abs(a - b) for a, b in zip(card_l, off_l))
    dp_off = max(max_err(card_p[n], off_p[n]) for n in W2V_PARAMS)
    # the fused op against the composition it replaced, both on the card
    # (the composition's matmuls are cuBLAS's): losses 1e-4, params 1e-5
    check(d_off < 1e-4 and dp_off < 1e-5,
          f"static-w2v passes off vs on: losses {off_l} vs {card_l}, params "
          f"diff {dp_off}")
    check(off_counts["fused_matmul"] == 0
          and off_counts["embedding_gather"] == 12
          and off_counts["fused_sgd"] == 15,
          f"static-w2v passes off: launches {off_counts}")
    rec.update(card_losses=card_l, cpu_losses=cpu_l, card_cpu_loss_diff=dl,
               card_cpu_param_diff=dp, passes_off_losses=off_l,
               passes_off_loss_diff=d_off, passes_off_param_diff=dp_off,
               passes_off_launches={k: v for k, v in off_counts.items() if v},
               tol="card vs CPU and passes off vs on: losses 1e-4, "
                   "parameters 1e-5")

    # Momentum: one fused_momentum launch per parameter per step
    main_m, startup_m, loss_m = build_word2vec(
        pt, pt.optimizer.MomentumOptimizer(0.001, momentum=0.9))
    scope_m = pt.Scope()
    exe.run(startup_m, scope=scope_m)
    losses, ms, counts = static_steps(
        K, exe, main_m, loss_m, feed, scope_m, 10,
        {**per_step, "fused_sgd": 0, "fused_momentum": 5},
        "static-w2v Momentum batch 100", card)
    add(counts)
    check(losses[-1] < losses[0], f"static-w2v Momentum: losses {losses}")
    rec.update(momentum_losses=losses,
               momentum_ms_per_step=statistics.median(ms), launches=total)
    log("static_w2v " + json.dumps(rec))
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's main path runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    log(f"phase 0: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")
    log_card("at start")

    t0 = time.perf_counter()
    built = _build.build()
    log(f"phase 1: built {sorted(built)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, r in built.items():
        regs = [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  {name}: {r['seconds']:.1f} s; " + " | ".join(regs))

    gen = torch.Generator(device="cuda").manual_seed(1234)
    log("phase 2: kernels against their plain versions")
    with torch.inference_mode():
        ln_main = check_layer_norm(K, 4096, 768, torch.bfloat16, gen)
        check_layer_norm(K, 4096, 768, torch.float32, gen)
        check_layer_norm(K, 640, 768, torch.bfloat16, gen)
        check_layer_norm(K, 1000, 768, torch.bfloat16, gen)
        # the trainers' shapes: pretrain-512's layers (64x512 rows) and
        # gathered head (64x80); pretrain-2048's layers and dense head
        ln_512 = check_layer_norm(K, 32768, 768, torch.bfloat16, gen)
        ln_head = check_layer_norm(K, 5120, 768, torch.bfloat16, gen)
        ln_2048 = check_layer_norm(K, 16384, 768, torch.bfloat16, gen)
        fa_main = check_flash(K, 2, 12, 2048, 64, torch.bfloat16, False,
                              100, gen)
        fa_train = check_flash(K, 8, 12, 2048, 64, torch.bfloat16, False,
                               100, gen)
        check_flash(K, 1, 12, 1024, 64, torch.bfloat16, True, 0, gen)
        check_flash(K, 2, 12, 1000, 64, torch.bfloat16, False, 100, gen)
        check_flash(K, 1, 4, 1000, 64, torch.float32, True, 0, gen)
    bwd_main = check_flash_bwd(K, 8, 12, 2048, 64, torch.bfloat16, False,
                               100, gen, library=True)
    check_flash_bwd(K, 2, 12, 1000, 64, torch.bfloat16, False, 100, gen)
    check_flash_bwd(K, 1, 4, 1000, 64, torch.float32, True, 0, gen)
    check_flash_bwd(K, 2, 4, 300, 32, torch.bfloat16, True, 30, gen)
    adam_main = check_adam(K, bert, 1, gen)
    check_adam(K, bert, 1000, gen)
    # the static path's kernels: the word2vec step's shapes at batch 100
    # (the main path) and 8192, and BERT-base's shapes beside them
    with torch.inference_mode():
        emb_main = check_embedding(K, W2V_VOCAB, W2V_EMBED, torch.float32,
                                   100, gen)
        check_embedding(K, W2V_VOCAB, W2V_EMBED, torch.float32, 8192, gen)
        check_embedding(K, 30528, 768, torch.bfloat16, 64 * 512, gen)
        fmm = {}
        for act in (None, "relu", "sigmoid", "tanh", "gelu"):
            for m, k, n in ((100, 4 * W2V_EMBED, W2V_HIDDEN),
                            (100, W2V_HIDDEN, W2V_VOCAB)):
                fmm[(m, k, n, act)] = check_fused_matmul(
                    K, m, k, n, act, torch.float32, gen)
        check_fused_matmul(K, 8192, 4 * W2V_EMBED, W2V_HIDDEN, "sigmoid",
                           torch.float32, gen)
        check_fused_matmul(K, 8192, W2V_HIDDEN, W2V_VOCAB, None,
                           torch.float32, gen)
        check_fused_matmul(K, 33, 70, 130, "tanh", torch.float32, gen,
                           with_bias=False)
        # the static BERT trunk's FFN (bench.py:485)
        for dt in (torch.float32, torch.bfloat16):
            check_fused_matmul(K, 4096, 768, 3072, "relu", dt, gen)
        from paddle_tpu_torch.core.tree import leaves
        bert_shapes = [t.shape for t in leaves(bert.init_params(
            bert.bert_base(), gen))]
        w2v_shapes = [(W2V_VOCAB, W2V_EMBED), (4 * W2V_EMBED, W2V_HIDDEN),
                      (W2V_HIDDEN,), (W2V_HIDDEN, W2V_VOCAB), (W2V_VOCAB,)]
        opt_main = {}
        for rule in ("sgd", "momentum", "nesterov"):
            opt_main[rule] = check_sgd(K, w2v_shapes, rule, gen,
                                       "word2vec, one launch per parameter",
                                       per_tensor=True)
            check_sgd(K, w2v_shapes, rule, gen, "word2vec, one launch")
            check_sgd(K, bert_shapes, rule, gen,
                      "BERT-base's 154 tensors, one launch")
    log(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")
    log_card("after phase 2")

    with torch.inference_mode():
        log("phase 3: serving BERT-base masked-LM at S=512")
        # in the model, LayerNorm reads the residual sum just written: its
        # share of a request uses the L2-warm time
        serving = phase_serving(K, bert, card, ln_main["l2_warm_ms"])
        log("phase 4: long context S=2048")
        longc = phase_long_context(K, bert, card, fa_main["ms"],
                                   ln_main["l2_warm_ms"])
    log("phase 5: pretraining BERT-base, 64x512 (pretrain-512)")
    # LayerNorm per step from its phase-2 times read from HBM: 25 at the
    # layers' rows, 1 at the gathered head's
    pre512 = phase_pretrain_512(K, bert, optimizer, card, adam_main["ms"],
                                25 * ln_512["ms"] + ln_head["ms"])
    log("phase 6: pretraining BERT-base, 8x2048 flash (pretrain-2048)")
    fa_ms = {"flash_attention": fa_train["ms"],
             **{n: r["ms"] for n, r in bwd_main.items()}}
    pre2048 = phase_pretrain_2048(K, bert, optimizer, card, fa_ms,
                                  adam_main["ms"], ln_2048["ms"])
    log("phase 7: training correctness on the card")
    phase_train_checks(bert, optimizer, card)
    log("phase 8: the Fluid static path, word2vec (static-w2v)")
    static = phase_static_w2v(K, pt, card)
    log(f"phases 0-8 done at {time.perf_counter() - t_start:.1f} s")
    log_card("at the end")

    # launches on the main paths: each phase's counted runs, counts set to
    # 0 just before and read just after
    by_phase = {
        "serve-512": {"fused_layer_norm": serving["ln_launches"]},
        "longctx-2048": {"flash_attention": longc["flash_launches"]},
        "pretrain-512": pre512["launches"],
        "pretrain-2048": pre2048["flash"]["launches"],
        "static-w2v": static["launches"],
    }
    kernels = []
    for name, main_rec in (
            ("fused_layer_norm", ln_main), ("flash_attention", fa_main),
            ("flash_attention_bwd_dkdv",
             bwd_main["flash_attention_bwd_dkdv"]),
            ("flash_attention_bwd_dq", bwd_main["flash_attention_bwd_dq"]),
            ("fused_adam", adam_main), ("embedding_gather", emb_main),
            ("fused_matmul", fmm[(100, W2V_HIDDEN, W2V_VOCAB, None)]),
            ("fused_sgd", opt_main["sgd"]),
            ("fused_momentum", opt_main["momentum"])):
        phases = {ph: c[name] for ph, c in by_phase.items()
                  if c.get(name, 0) > 0}
        launches = sum(phases.values())
        check(launches > 0, f"{name} never launched on its main path")
        kd = K.get_kernel(name)
        kernels.append(dict(
            name=name, route="cuda", source=kd.source,
            replaces=kd.replaces, launches=launches,
            launches_by_phase=phases,
            max_abs_err=main_rec["max_abs_err"], ms=main_rec["ms"],
            plain_ms=main_rec["plain_ms"], bound_ms=main_rec["bound_ms"],
            bound_by=main_rec["bound_by"],
            library_ms=main_rec["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
