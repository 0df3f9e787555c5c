#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one card

Phases; any failure raises and the script exits non-zero:

0. Require a CUDA device (no CPU fallback); print the card's name and
   power limit.
1. Build every kernel of the path from ``paddle_tpu_torch/ops/kernels/csrc``
   with nvcc (one process per source, all at once); for the flash and
   fused-matmul kernels, print each kernel's ptxas registers and spills
   and, where the toolkit has ``cuobjdump``, its count of tensor-core
   instructions (HGMMA, HMMA) in the SASS; fail if a wgmma kernel spills or
   issues no HGMMA.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and a few edge cases, each with its stated
   tolerance, and time kernel, plain version and one PyTorch library call
   (a yardstick only; the port never calls it) beside the kernel's bound:
   LayerNorm, the flash-attention forward and its two backward kernels
   (the bf16 forward and dK/dV on the tensor cores also at each head size,
   S = 300, 1000 and 2048, causal and masked keys, rows that see no key,
   the fused QKV projection's head views and views the wrapper copies, and
   the fp32 SIMT instantiation at the same edges),
   the multi-tensor Adam over BERT-base's parameter list, over
   Transformer-big's 258 tensors (~243 M values) and over the GRU
   encoder-decoder's 10 (phase 25); and the static
   path's kernels: the embedding gather (word2vec's table with 100 and
   8192 ids, BERT-base's word table with 64x512 ids, and the sequence
   models' tables at their batches' ids: IMDB's 5147 words with 128x512,
   the SRL's 44068 with 10x64, the NMT's 30000 x512 with 64x50, MovieLens'
   6041 users with 256), the fused matmul (db_lstm's six fc shapes at
   10x64 rows with tanh;
   each activation at both word2vec fc shapes, those at 8192 rows, the
   serving MLP's fp32 buckets [1|8,256]x[256,256] relu and [1|8,256]x
   [256,10], word2vec's fc 2 with a bf16 weight, inf, -inf and NaN in x
   and w through each activation, and BERT's FFN [4096,768]x[768,3072]
   relu in fp32 and bf16; the fp32 operations bound is three TF32 passes
   at 495 TFLOP/s, the least time an fp32-accurate product takes), the int8
   fused matmul on the same tensor-core kernel (the serving MLP's
   [1|8,256]x[256,256] relu and [8,256]x[256,10], word2vec's two fcs at 64
   rows, with bf16 x too at the wider, BERT's FFN shape, also held against
   an fp64 product of the dequantized weight, and a ragged [33,70,130] tanh
   without bias; its bound is three bf16 passes for fp32 x, one for bf16
   x, the int8 weight being exact in bf16;
   ``addmm`` on the weight dequantized beforehand is timed beside it as a
   yardstick of other work), and SGD and
   momentum (plain and nesterov) over word2vec's parameters, one launch
   per parameter as the static path makes them and one over the list, and
   over BERT-base's 154 tensors; SGD over db_lstm's 67 with the rate on
   the card; momentum over ResNet-50's 267 tensors
   (the image models' update), and the three rules with the rate read
   from a tensor on the card, as a learning-rate schedule gives it; the scatter-add (bench.py's CTR point
   [65536,256] with 4096 ids, BERT-base's word, position and token-type
   gradients with pretrain-512's 32768 ids into zeros, the merge's
   inverse ids into [32768,768], phase 10's DeepFM-width CTR table
   [2600000,8] densified from one batch's ids and updated by its merged
   rows (uniform and skewed), a bf16 table and edge ids; two launches
   bitwise equal, bitwise equal to the emulation of the kernel's two-level
   summation order on the CPU, and within ``scatter_atol`` of the plain
   body (ascending j) on the CPU and on the card) and the
   softmax cross-entropy (pretrain-512's gathered MLM head [5120,30528] in
   bf16 and fp32, bench.py's [512,32000], word2vec's ragged V 2073 and
   edge labels).
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
9. Fluid inference and weight-only int8 serving (serve-int8): the serving
   MLP of ``bench.py`` (``_freeze_serving_mlp``'s widths) and the word2vec
   model phase 8 trained, each saved with ``save_inference_model`` as an
   fp32 directory and exported with ``export_aot(quantize="int8")``; an
   ``InferenceServer`` on the card for each of the four (``max_batch`` 8,
   ``max_wait_ms`` 2, one replica: bench.py's defaults) takes 400 one-row
   requests, open loop, on one Poisson schedule per model at 3x its fp32
   server's service rate. Exact launch counts per formed micro-batch (MLP:
   3 fused matmul, or 3 int8 fused matmul and no fp32 one; word2vec: 4
   gather and 2 of either), QPS, p50/p99, resident param bytes and, over
   a profiled window of 100 more requests, the device's busy share and its
   kernels by share. Checks: int8/fp32 resident bytes <= 0.55, int8 vs
   fp32 outputs within 0.02 of the output range on a 16-row fixture, the
   int8 server on the card vs the port's plain path on the CPU from the
   same directory, and the ``Predictor`` on the card vs the fp32 server,
   within 1e-5.
10. Sparse rows and the fused loss at BERT-base width (sparse-xent), on
   pretrain-512's batch and BERT-base weights from the seed: the gathered
   MLM head's logits [5120,30528] (fp32, then bf16) through
   ``softmax_cross_entropy``, whose weighted mean must equal ``mlm_loss``
   and whose gradient must equal the plain body's autograd gradient; the
   word gradient as a ``SelectedRows`` of 32768 ids into [30528,768]:
   densify (against ``index_add_``), merge, densify the merged rows
   (bitwise), ``sparse_sgd_update`` (against the dense update); then a
   DeepFM-width CTR table (26 slots x 100,000 ids x 8, 83 MB) through 3
   steps of 2048x26 ids drawn uniform as ``synthetic_ctr_batch`` draws
   them, then 3 Zipf-skewed ones, each checked as the word gradient is
   (densify against ``index_add_``, merged rows densified bitwise, sparse
   SGD against the dense update). Exactly 1 cross-entropy
   launch per forward and none in the backward, 1 scatter-add per merge,
   densify and sparse SGD.
11. Train ResNet-50 as ``bench.py resnet50`` does (train-resnet50),
   nothing cut: bf16, 224x224, batch 256 of ``synthetic_batch`` reused,
   Momentum(0.1, 0.9), 8 steps per call, 3 calls. Exactly 1 momentum launch
   per step (over the 267 parameter tensors) and no other registered
   kernel; every loss finite; images/s, MFU against 989 TFLOP/s with
   ``flops_per_image``, peak memory, and one profiled step's kernels by
   group and the top 10 (busy share: their device time over the steady
   step latency).
12. Image training correctness (train-correctness): resnet_cifar10(depth=8,
   image_size=16) at batch 8, three Momentum steps in bf16 on the card
   against the port on the CPU in fp32 from the same weights, losses within
   0.03; then the same with ``piecewise_decay``, ``L2Decay(1e-4)`` and
   ``GradientClipByGlobalNorm(1.0)``, so the schedule (read by the kernel
   from the card), the regularizer and the clip run there.
13. Image inference as ``bench.py inference`` measures it (infer-image):
   ``forward(train=False)`` of ResNet-50 at batches 1-128 and VGG-16 at
   1-64, bf16 and fp32, on zero images: latency per batch (host clock to a
   synchronize, 30 runs after warm-up); at batch 2, from one set of weights
   (batch-norm stats from a training forward), the card against the port
   on the CPU in fp32 with cuDNN's TF32 left on (the fp32 model turns it
   off itself): fp32 logits within 1e-3 and bf16 within 0.15 of the largest
   logit.
14. Train SE-ResNeXt-50 (train-se-resnext50): bf16, 224x224, batch 32 (a
   choice: ``bench.py`` has no SE-ResNeXt), 3 Momentum steps, exactly 1
   momentum launch per step, finite losses, images/s.
15. Train Transformer-big as ``bench.py nmt`` does (train-transformer-big),
   nothing cut: hidden 1024, 16 heads, FFN 4096, 6+6 layers, vocab 32768,
   bf16, batch 32, source and target 256, Adam(1e-4) on one reused
   ``synthetic_batch``, 2 warm-up and 20 counted steps. Exactly 1
   ``fused_adam`` launch per step and no other registered kernel; the loss
   falls; target tokens/s, MFU against 989 TFLOP/s with
   ``flops_per_step``, step latency, peak memory, one profiled step's
   kernels by group with the tied fp32 output projection on its own line,
   and that projection's three products timed alone.
16. Decode with those weights as ``bench.py nmt`` does
   (decode-transformer-big): ``beam_search_decode(beam_size=4,
   max_len=64)`` and ``greedy_decode(max_len=64)`` of the 32 sources, 5
   timed decodes after one warm-up: latency, decode tokens/s, kernel
   launches per step and the busy share; no registered kernel launches.
17. Transformer correctness (transformer-correctness): transformer_tiny in
   fp32 on the card against the CPU (logits within 1e-4 of the largest,
   greedy tokens equal), and Transformer-big's widths at 1+1 layers, 3
   Adam steps in bf16 on the card against fp32 on the CPU (losses within
   0.03).
18. The DeepFM CTR trainer (ctr-deepfm): ``DeepFMConfig()`` with nothing
   cut over the host tables (Adagrad 0.05), batch 4096
   (``benchmark/ctr_trace_r2.json``'s), 20 steps of ``train_step`` with
   sync and async pushes and of ``train_stream(prefetch=2)``, with the fp32
   and the fp16 wire: examples/s, the host split of a synchronous step
   (pull, copy, step, fetch, push) and the step's device busy share; the
   loss falls and no registered kernel launches.
19. The recognize_digits ``conv_net`` of the Fluid book, nothing cut
   (train-book-digits): 1x28x28, conv-pool 20, batch norm, conv-pool 50,
   fc 10 softmax, built with ``layers``/``nets`` and minimized by
   Adam(1e-3) through ``Program``/``Executor.run`` on the card, batch 64,
   50 steps over 10 synthetic batches: exactly 1 fused matmul (the fc) and
   1 ``fused_adam`` per parameter per step; the loss falls; ms per step,
   images/s, peak memory, one profiled step by op group and the busy share.
20. The image_classification ``vgg16_bn_drop``, nothing cut
   (train-book-vgg): 3x32x32, five conv groups with batch norm and the
   reference's drop rates, fc 512 twice, batch 128, the same records;
   exactly 3 fused matmuls and 60 ``fused_adam`` per step.
21. Book correctness (book-correctness): conv_net (batch 64), vgg16_bn_drop
   (batch 16, drop rates 0) and the two-tower recommender at MovieLens-1M's
   id counts (batch 256; 2 gathers, 2 fused matmuls per step), 3 Adam
   steps on the card against the CPU from the same weights with TF32 off
   and cuDNN's deterministic algorithms: first-step gradients, losses,
   parameters and the batch-norm running stats within ``BOOK_TOL``;
   dropout on the card at p 0.3 and 0.5 (keep share within 5 sigma, kept
   values exactly x or x/(1-p), the seed sets the mask, the Executor's
   masks follow the program's seed); the for_test clone against a
   save/load_inference_model round trip.
22. The twelve optimizer rules without a kernel (optimizer-rules), each
   under a schedule, L2 decay and a global-norm clip: 3 updates on the
   card against the CPU over vgg16_bn_drop's 60 parameters, then device
   microseconds and device events per update over that list and over
   ResNet-50's 267 tensors; no registered kernel launches.
23. The Fluid book's understand_sentiment ``convolution_net``
   (train-book-sentiment) in the module context at its published widths
   (the IMDB word_dict's 5147 ids, embedding 32, ``sequence_conv_pool`` of
   32 filters at 3 and 4 with tanh and sqrt pooling, fc 2 softmax), batch
   128 of synthetic reviews 16-512 tokens long, 30 Adagrad(0.002) steps
   through ``nn.transform``, autograd and ``apply_gradients``: exactly 1
   gather a step; the loss falls; ms per step (median of steps 5-29),
   reviews/s, peak memory, the busy share.
24. label_semantic_roles' ``db_lstm`` (train-book-srl) through
   ``Program``/``Executor.run`` at its widths (word table 44068 x32 frozen
   and shared by six slots, predicates 3162 x32, marks 2 x5, hidden 512,
   depth 8 of ``dynamic_lstm`` at 128 with peepholes, every second one
   reversed, 59 labels, ``linear_chain_crf``), batch 10 of sentences 8-64
   long, 30 SGD steps under ``exponential_decay(0.01, 100000, 0.5,
   staircase)``: exactly 8 gathers, 24 fused matmuls (every fc) and one
   ``fused_sgd`` per trainable parameter a step; then ``crf_decoding`` of a
   batch through the for_test clone (latency), and the recurrences'
   device events per time step.
25. The machine_translation GRU encoder-decoder (train-book-nmt) at book
   ch. 08's widths (dictionaries 30000, word and hidden 512), batch 64,
   lengths 10-50, 20 Adam steps: exactly 2 gathers and 1 ``fused_adam`` a
   step; target tokens/s, peak memory, the busy share.
26. The full MovieLens recommender (train-book-movielens): the user and
   movie towers at Fluid 1.5's widths (categories summed, the title through
   ``sequence_conv_pool``), batch 256, 30 SGD(0.2) steps: exactly 7
   gathers and 1 ``fused_sgd`` a step; examples/s.
27. Sequence correctness (sequence-correctness): the four models at batch
   4-8 and their full widths, 3 steps on the card against the port on the
   CPU from the same weights in fp32 with TF32 off (losses, first-step
   gradients, parameters within ``SEQ_TOL``, the SRL's Viterbi paths
   equal); every sequence op, the CRF and each recurrent function (outputs
   and gradients) card against CPU at a zero-length, a one-step and a full
   row, forward and reversed.
28. The PTB LSTM language model at ``lm_model.py``'s medium config
   (train-ptb-lm; ``models/ptb_lm.py``): vocabulary 10000, hidden 650, 2
   layers, 35 steps, batch 20, dropout 0.5 outside the loop, SGD 1.0 under
   ``GradientClipByGlobalNorm(5.0)``, built with ``layers.static_rnn`` (a
   ``scan_block``) and fed by a ``py_reader``: ``Executor.prepare`` (its
   time; the kernel libraries it loads; no runner built after it), then
   two epochs of 30 windows of a seeded Markov stream through the
   start/reset protocol, each window's final state fed back on the card.
   Exactly 1 gather, 1 fused matmul and 7 ``fused_sgd`` launches a step;
   the loss falls; first step against the median of steps 5 on, tokens/s,
   peak memory beside ``memory_usage``'s estimate, the busy share and the
   device events per step and per time step.
29. Greedy generation over phase 28's weights through ``layers.while_loop``
   (generate-ptb-lm): 35 tokens for 20 streams, one host read per
   iteration and one more, no registered kernel; latency, tokens/s, device
   events per iteration.
30. Control-flow correctness (control-flow-correctness): the LM at medium's
   widths and batch 4 (dropout 0), 3 steps on the card against the CPU
   within ``LM_TOL``; phase 29's windows again on the CPU, token for
   token; module 1's ops, the eager and static control flow (zero-trip
   loops) and the tensor arrays (tied lengths, a row of length 0) card
   against CPU within ``CF_OP_TOL``.
31. Print one JSON line of every ported kernel (launches on the main paths,
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
    # fp32-accurate products: the least the card takes is three TF32 passes
    # (hi*hi + hi*lo + lo*hi) on the tensor cores at 495 TFLOP/s, so 165
    # (above the 67 of SIMT fp32; one TF32 pass is not fp32-accurate; six
    # bf16 passes at 989 are no faster). With one side exact in bf16 (bf16,
    # or an int8 weight, |q| <= 127) the bf16 tensor cores are faster: fp32
    # x splits exactly into three bf16 pieces, so 989 / 3 (BERT's FFN with
    # an int8 w is bound at 58.63 us), and bf16 x takes one pass (989);
    # fmm_peak picks the rate
    torch.float32: 495e12 / 3,
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


def bound(nbytes, ops, dtype, ops_per_s=None):
    """(the larger of the bytes' and the operations' least times in ms, which
    of them); the operations at dtype's peak unless ``ops_per_s`` is given."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (ops_per_s or PEAK_OPS_PER_S[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: what the compiler made of the tensor-core kernels
# ---------------------------------------------------------------------------
_MANGLED_ARGS = (("f", "f32"), ("13__nv_bfloat16", "bf16"), ("a", "i8"))


def kernel_label(mangled):
    """``flash_fwd_wgmma_kernel<64>``, ``flash_bwd_dq_kernel<f32,64>`` or
    ``fused_matmul_wgmma_kernel<f32,bf16,1,64>`` from a mangled kernel
    name: the template's types and integers in order."""
    import re
    m = re.search(r"\d+((?:flash|fused_matmul)\w*?_kernel)I", mangled)
    if m is None:
        return mangled[:80]
    rest, args = mangled[m.end():], []
    while rest and rest[0] != "E":
        num = re.match(r"Li(-?\d+)E", rest)
        if num:
            args.append(num.group(1))
            rest = rest[num.end():]
            continue
        # a repeated class type is mangled as a back-reference (S_, S0_,
        # ...); bf16 is the only class type among these kernels' arguments
        ref = re.match(r"S\d*_", rest)
        if ref:
            args.append("bf16")
            rest = rest[ref.end():]
            continue
        code = next(((c, lab) for c, lab in _MANGLED_ARGS
                     if rest.startswith(c)), None)
        if code is None:
            break
        args.append(code[1])
        rest = rest[len(code[0]):]
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_report(log):
    """{kernel label: {registers, spill_stores, spill_loads}} from the
    ``-Xptxas -v`` build log, and the compiler's remarks on the wgmma
    pipeline (C75xx: waits it inserted or products it serialized)."""
    import re
    out, cur, remarks = {}, None, []
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = kernel_label(m.group(1))
            out[cur] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            out[cur].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
        if re.search(r"\(C75\d\d\)", line):
            remarks.append(line.strip()[:200])
    return out, remarks


def sass_census(so_path):
    """{kernel label: {"HGMMA": n, "HMMA": n}} over the library's SASS
    (cuobjdump), or None where the toolkit has no cuobjdump."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None
    r = subprocess.run([tool, "-sass", so_path], capture_output=True,
                       text=True, timeout=300, check=True)
    out, cur = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            cur = kernel_label(line.split("Function :", 1)[1].strip())
            out[cur] = {"HGMMA": 0, "HMMA": 0}
        elif cur:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\b", line):
                    out[cur][op] += 1
    return out


TENSOR_CORE_LIBS = ("flash_attention_fwd", "flash_attention_bwd",
                    "fused_matmul")


def tensor_core_report(built):
    """Phase 1's lines for the tensor-core kernels: ptxas registers and
    spills, the tensor-core instructions in their SASS; fails if a wgmma
    kernel spills or issues none."""
    recs = {}
    for lib in TENSOR_CORE_LIBS:
        regs, remarks = ptxas_report(built[lib]["log"])
        census = sass_census(built[lib]["path"])
        for label in sorted(regs):
            rec = dict(regs[label])
            if census is not None:
                rec.update(census.get(label, {}))
            recs[label] = rec
            log(f"  {label}: " + json.dumps(rec))
            if "wgmma" in label:
                check(rec.get("spill_stores", 1) == 0
                      and rec.get("spill_loads", 1) == 0,
                      f"{label} spills registers: {rec}")
                check(census is None or rec.get("HGMMA", 0) > 0,
                      f"{label} issues no HGMMA instruction: {rec}")
        for r in remarks:
            log(f"  {lib} ptxas remark: {r}")
    check(any("wgmma" in label for label in recs),
          f"no wgmma kernel in {TENSOR_CORE_LIBS}: {sorted(recs)}")
    return recs


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


def flash_inputs(n, B, H, S, D, dtype, gen, layout="contiguous"):
    """n [B, H, S, D] operands: contiguous; "qkv", head views of one fused
    [B, S, n*H*D] projection as bert.py makes them (the TMA loads take
    them as they are); or "unaligned", views 2 bytes off a 16-byte
    boundary (the wrapper copies them for the same kernel)."""
    dev = "cuda"
    if layout == "qkv":
        fused = torch.randn(B, S, n * H * D, generator=gen, device=dev)
        return [t.reshape(B, S, H, D).transpose(1, 2)
                for t in fused.to(dtype).split(H * D, dim=-1)]
    if layout == "unaligned":
        size = B * H * S * D
        return [torch.randn(size + 1, generator=gen, device=dev).to(dtype)
                [1:].view(B, H, S, D) for _ in range(n)]
    return [torch.randn(B, H, S, D, generator=gen, device=dev).to(dtype)
            for _ in range(n)]


def key_bias(B, S, masked_keys):
    """The key bias: -1e9 on the last ``masked_keys`` keys of every row,
    or with "all", on every key of batch 0 (rows that see no key) and the
    last tenth of the others; None for 0."""
    if not masked_keys:
        return None
    bias = torch.zeros(B, S, device="cuda")
    if masked_keys == "all":
        bias[0] = -1e9
        bias[:, -(S // 10):] = -1e9
    else:
        bias[:, -masked_keys:] = -1e9
    return bias


def check_flash(K, B, H, S, D, dtype, causal, masked_keys, gen,
                layout="contiguous", timed=True):
    q, k, v = flash_inputs(3, B, H, S, D, dtype, gen, layout)
    bias = key_bias(B, S, masked_keys)
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
    check(ok, f"flash_attention {[B, H, S, D]} {dtype} causal={causal} "
              f"masked={masked_keys} {layout}: kernel disagrees with plain: "
              f"o {err}, lse {max_err(lse, lser)}")
    if not timed:
        rec = dict(shape=[B, H, S, D], dtype=str(dtype), causal=causal,
                   masked_keys=masked_keys, layout=layout, max_abs_err=err,
                   lse_err=max_err(lse, lser),
                   tol=f"o atol {atol_o:g} rtol {rtol_o:g}; lse atol 1e-4")
        log("check flash_attention " + json.dumps(rec))
        return rec
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
               bound_by=b_by, tflops=ops / (ms * 1e-3) / 1e12,
               card=nvidia_smi_line())
    log("check flash_attention " + json.dumps(rec))
    return rec


def check_flash_bwd(K, B, H, S, D, dtype, causal, masked_keys, gen,
                    library=False, layout="contiguous", timed=True):
    """Both backward kernels against their plain bodies on the residuals of
    the plain forward; returns the dK/dV and dQ records. With ``library``
    (the main shape; non-causal with a key bias), also times the library's
    attention backward alone on the same inputs. ``layout`` as in
    ``flash_inputs`` (dO is a view of its own [B, S, H*D] gradient)."""
    q, k, v = flash_inputs(3, B, H, S, D, dtype, gen, layout)
    do = flash_inputs(1, B, H, S, D, dtype, gen, layout)[0]
    bias = key_bias(B, S, masked_keys)
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
    check(ok, f"flash backward {[B, H, S, D]} {dtype} causal={causal} "
              f"masked={masked_keys} {layout}: kernels disagree with plain: "
              f"{errs}")
    if not timed:
        rec = dict(shape=[B, H, S, D], dtype=str(dtype), causal=causal,
                   masked_keys=masked_keys, layout=layout, errs=errs)
        log("check flash backward " + json.dumps(rec))
        return rec
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
            tflops=2 * n_products * B * H * D * pairs / (ms * 1e-3) / 1e12,
            card=nvidia_smi_line())

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


def check_adam(K, shapes, t, gen, lr_on_card=False, label="BERT-base"):
    """The multi-tensor Adam kernel against its plain body over a model's
    parameter list (``shapes``: BERT-base's 154 tensors, Transformer-big's
    258; random p, g, m1 and m2 >= 0) at step t; with ``lr_on_card`` the
    kernel reads the rate from a 0-d fp32 tensor on the card (a schedule's
    value), the plain body takes the float."""
    p, g, m1, m2 = ([torch.randn(sh, generator=gen, device="cuda")
                     for sh in shapes] for _ in range(4))
    m2 = [x.abs() for x in m2]
    ref = [[x.clone() for x in xs] for xs in (p, g, m1, m2)]
    lib = [[x.clone() for x in xs] for xs in (p, g, m1, m2)]
    step = torch.tensor(t, dtype=torch.int32, device="cuda")
    kern = K.get_body("fused_adam", "kernel")
    plain = K.get_body("fused_adam", "reference")
    lr_k = torch.tensor(1e-4, device="cuda") if lr_on_card else 1e-4
    kern(p, g, m1, m2, lr_k, step)
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
        lambda: kern(p, g, m1, m2, lr_k, step), 20)
    plain_ms = device_ms(lambda: plain(*ref, 1e-4, step), 3)
    lib_ms = device_ms(library, 20)
    rec = dict(model=label, tensors=len(p), elements=n, t=t,
               lr_on_card=lr_on_card, max_abs_err=err,
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


def fmm_peak(x_dtype, w_dtype):
    """The least time's rate for the fused matmul's fp32-accurate products.
    A bf16 operand, or an int8 weight (|q| <= 127), is exact in bf16, and
    an fp32 one splits exactly into three bf16 pieces, so on the bf16
    tensor cores (989 TFLOP/s) a product with one fp32 side takes three
    passes and one with none a single pass; fp32 x fp32 takes three TF32
    passes (165 TFLOP/s, as fast as the six bf16 ones it would need)."""
    if x_dtype == w_dtype == torch.float32:
        return PEAK_OPS_PER_S[torch.float32]
    pieces = 3 if torch.float32 in (x_dtype, w_dtype) else 1
    return PEAK_OPS_PER_S[torch.bfloat16] / pieces


def check_fused_matmul(K, m, k, n, act, dtype, gen, with_bias=True,
                       w_dtype=None):
    """The fused matmul kernel (+ gelu outside it) against its plain body,
    fp32 out; x in ``dtype``, w in ``w_dtype`` (default ``dtype``). Library
    yardstick ``torch.addmm`` (no act) or ``torch._addmm_activation``
    (relu) where x and w share a dtype, else none."""
    w_dtype = dtype if w_dtype is None else w_dtype
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
         ).to(w_dtype)
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
    # the kernel's TF32 passes carry each product to ~2^-22 relative (bf16
    # operands: exactly), summed in fp32 in another order than cuBLAS's fp32
    # product (no TF32): atol 1e-4, rtol 1e-4 at outputs O(1)
    err = max_err(out, ref)
    label = (f"fused_matmul [{m},{k}]x[{k},{n}] {act} {dtype}"
             + ("" if w_dtype == dtype else f" x {w_dtype}"))
    check(within(out, ref, 1e-4, 1e-4),
          f"{label}: kernel disagrees with plain: {err}")
    nbytes = (m * k * x.element_size() + k * n * w.element_size()
              + (n * 4 if b is not None else 0) + m * n * 4)
    b_ms, b_by = bound(nbytes, 2 * m * n * k, dtype, fmm_peak(dtype, w_dtype))
    ms = device_ms(run_kernel, 20)
    plain_ms = device_ms(run_plain, 20)
    lib_ms, lib = None, None
    one_dtype = w_dtype == dtype
    if one_dtype and act is None:
        lib = "torch.addmm" if b is not None else "torch.mm"
        lib_ms = device_ms((lambda: torch.addmm(b.to(dtype), x, w))
                           if b is not None else (lambda: torch.mm(x, w)), 20)
    elif one_dtype and act == "relu" and b is not None:
        lib = "torch._addmm_activation (one cuBLASLt call, relu epilogue)"
        lib_ms = device_ms(lambda: torch._addmm_activation(b.to(dtype), x, w),
                           20)
    rec = dict(shape=[m, k, n], act=act, dtype=str(dtype),
               w_dtype=str(w_dtype), bias=b is not None,
               max_abs_err=err, tol="atol 1e-4 rtol 1e-4 (fp32 out)", ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, library=lib,
               bound_ms=b_ms, bound_by=b_by,
               tflops=2 * m * n * k / (ms * 1e-3) / 1e12,
               host_ms_per_call=host_ms(run_kernel, 200))
    log("check fused_matmul " + json.dumps(rec))
    return rec


def check_fused_matmul_special(K, gen):
    """inf and NaN in x and in w through each activation: the kernel
    against the plain body, with the non-finite outputs where the plain
    body has them (the same signs of inf) and the finite ones within atol
    1e-4, rtol 1e-4."""
    m, k, n = 33, 70, 130
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
        x[0, 3], x[1, 5], x[2, 7] = math.inf, -math.inf, math.nan
        w[9, 4], w[11, 6], w[13, 8] = math.inf, -math.inf, math.nan
        # under x's inf: an exact TF32 value (lo = 0, where inf * lo would
        # be NaN) and values whose lo is positive and negative (where it
        # would be inf of either sign)
        w[3, 0], w[3, 1], w[3, 2] = 0.99999, 1.0, 1.0001
        x, w = x.to(dtype), w.to(dtype)
        b = torch.randn(n, generator=gen, device="cuda")
        for act in (None, "relu", "sigmoid", "tanh"):
            out = K.get_body("fused_matmul", "kernel")(x, w, b, act)
            ref = K.get_body("fused_matmul", "reference")(x, w, b, act)
            torch.cuda.synchronize()
            same_nan = torch.equal(out.isnan(), ref.isnan())
            fin = ref.isfinite()
            same_inf = torch.equal(out[~fin & ~ref.isnan()],
                                   ref[~fin & ~ref.isnan()])
            both = fin & out.isfinite()
            check(same_nan and same_inf and torch.equal(out.isfinite(), fin)
                  and within(out[fin], ref[fin], 1e-4, 1e-4),
                  f"fused_matmul inf/NaN {dtype} {act}: kernel disagrees "
                  f"with plain: NaN {same_nan}, inf {same_inf}, finite "
                  f"err {max_err(out[both], ref[both])}")
    log("check fused_matmul inf/NaN: x and w with inf, -inf and NaN, "
        "fp32 and bf16, each activation: as the plain body")


def int8_weight(k, n, gen):
    """An int8 weight [k, n] and its scale table, quantized from a random
    fp32 one as export_aot(quantize="int8") does."""
    from paddle_tpu_torch.static.opt_passes import quantize_weight_values
    wf = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
    q = quantize_weight_values({"w": wf}, ["w"], "int8")
    return q["w"].cuda(), q["w@quant_scale"].cuda()


def check_fused_matmul_int8(K, m, k, n, act, gen, with_bias=True,
                            dtype=torch.float32):
    """The int8 fused matmul kernel (scale in the epilogue) against its
    plain body (the whole weight dequantized first), x in ``dtype``, fp32
    out, the weight quantized from a random fp32 one as
    export_aot(quantize="int8") does. No single PyTorch call computes this
    function (library_ms null); ``torch.addmm`` on the weight already
    dequantized to fp32 is timed beside it as a yardstick of other work (no
    dequant, no activation)."""
    w, scale = int8_weight(k, n, gen)
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    b = torch.randn(n, generator=gen, device="cuda") if with_bias else None
    kern = K.get_body("fused_matmul_int8", "kernel")
    plain = K.get_body("fused_matmul_int8", "reference")
    out, ref = kern(x, w, scale, b, act), plain(x, w, scale, b, act)
    torch.cuda.synchronize()
    # fp32 sums of K products in another order than cuBLAS's, the scale
    # applied once to each column's sum where the plain body scales every
    # weight: atol 1e-4, rtol 1e-4 at outputs O(1)
    err = max_err(out, ref)
    check(within(out, ref, 1e-4, 1e-4),
          f"fused_matmul_int8 [{m},{k}]x[{k},{n}] {act} {dtype}: kernel "
          f"disagrees with plain: {err}")
    nbytes = m * k * x.element_size() + k * n + n * 4 \
        + (n * 4 if with_bias else 0) + m * n * 4
    b_ms, b_by = bound(nbytes, 2 * m * n * k, dtype,
                       fmm_peak(dtype, torch.int8))
    ms = device_ms(lambda: kern(x, w, scale, b, act), 20)
    plain_ms = device_ms(lambda: plain(x, w, scale, b, act), 20)
    wd = w.float() * (scale / 127.0)
    xf = x.float()
    yard_ms = device_ms((lambda: torch.addmm(b, xf, wd)) if with_bias
                        else (lambda: torch.mm(xf, wd)), 20)
    rec = dict(shape=[m, k, n], act=act, dtype=str(dtype), bias=with_bias,
               max_abs_err=err,
               tol="atol 1e-4 rtol 1e-4 (fp32 out)", ms=ms,
               plain_ms=plain_ms, library_ms=None, library="none",
               addmm_dequantized_ms=yard_ms,
               yardstick="torch.addmm on the fp32 weight dequantized "
                         "beforehand (other work: no dequant, no "
                         "activation)",
               bound_ms=b_ms, bound_by=b_by,
               tflops=2 * m * n * k / (ms * 1e-3) / 1e12,
               host_ms_per_call=host_ms(lambda: kern(x, w, scale, b, act),
                                        200))
    log("check fused_matmul_int8 " + json.dumps(rec))
    return rec


def check_fused_matmul_int8_accuracy(K, m, k, n, gen):
    """The int8 kernel's accuracy at BERT's FFN: fp32 x and bf16 x against
    an fp64 product of the dequantized weight (the scale applied in fp64),
    with the tolerance the kernel keeps against its plain body (atol 1e-4,
    rtol 1e-4: fp32 x takes two TF32 passes, hi and lo of x; bf16 x and
    the int8 weight are exact in TF32)."""
    w, scale = int8_weight(k, n, gen)
    b = torch.randn(n, generator=gen, device="cuda")
    wd = w.double() * (scale.double() / 127.0)
    kern = K.get_body("fused_matmul_int8", "kernel")
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        out = kern(x, w, scale, b, None)
        ref = x.double() @ wd + b.double()
        torch.cuda.synchronize()
        errs[str(dt)] = max_err(out.double(), ref)
        check(within(out.double(), ref, 1e-4, 1e-4),
              f"fused_matmul_int8 [{m},{k}]x[{k},{n}] {dt} vs fp64: "
              f"{errs[str(dt)]}")
    log("check fused_matmul_int8 accuracy " + json.dumps(dict(
        shape=[m, k, n], max_abs_err_vs_fp64=errs,
        tol="atol 1e-4 rtol 1e-4 against x @ (w * scale / 127) + b in "
            "fp64")))


def check_sgd(K, shapes, rule, gen, label, per_tensor=False,
              lr_on_card=False):
    """The SGD or momentum kernel against its plain body over fp32 tensors
    of ``shapes`` (bit-identical: every product and sum rounds singly in
    the plain order), timed behind a spin as Adam is. ``per_tensor``: one
    launch per tensor, as the static path's ``apply_optimizer`` ops make
    them; else one launch over the list, as ``apply_gradients`` does.
    Library yardsticks over the list: ``torch._fused_sgd_`` (dampening 0,
    the same rule) and, for SGD, ``torch._foreach_add_(p, g, alpha=-lr)``.
    ``lr_on_card``: the kernel reads the rate from a 0-d fp32 tensor on the
    card (a schedule's value), the plain body takes the float."""
    name = "fused_sgd" if rule == "sgd" else "fused_momentum"
    nest = rule == "nesterov"
    lr, mu = 1e-3, 0.9
    p, g, v = ([torch.randn(sh, generator=gen, device="cuda")
                for sh in shapes] for _ in range(3))
    ref_p, ref_v = [t.clone() for t in p], [t.clone() for t in v]
    kern = K.get_body(name, "kernel")
    plain = K.get_body(name, "reference")
    lr_k = torch.tensor(lr, device="cuda") if lr_on_card else lr
    lists, ref_lists, scalars, ref_scalars = (
        ((p, g), (ref_p, g), (lr_k,), (lr,)) if rule == "sgd"
        else ((p, g, v), (ref_p, g, ref_v), (lr_k, mu, nest), (lr, mu, nest)))
    groups = ([[i] for i in range(len(shapes))] if per_tensor
              else [range(len(shapes))])

    def run_kernel():
        for idx in groups:
            kern(*([xs[i] for i in idx] for xs in lists), *scalars)

    def run_plain():
        plain(*ref_lists, *ref_scalars)

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
               lr_on_card=lr_on_card,
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


def scatter_atol(ids, h, upd):
    """Tolerance of the scatter-add against its plain body, which sums in
    another order (ascending j on the CPU, atomics on the card) than the
    kernel's two levels: each of a row's c adds may round by 2^-24 of the
    partial sum, so 1e-6 * c_max * max|update|."""
    wrapped = torch.where(ids < 0, ids + h, ids).long()
    valid = (ids >= -h) & (ids < h)
    c_max = torch.bincount(wrapped[valid], minlength=1).max().item()
    return 1e-6 * c_max * upd.float().abs().max().item() + 1e-6


def check_scatter_add(K, label, dst, ids, upd, edge=False):
    """The scatter-add kernel against its plain body on ``dst`` [h, d],
    ``ids`` [n] and ``upd`` [n, d] on the card: two launches bitwise
    equal (no atomics); bitwise equal to ``_scatter_add_two_level`` on the
    CPU, the plain emulation of the kernel's fixed two-level order; within
    :func:`scatter_atol` of the plain body (ascending j) on the CPU and on
    the card. With ``edge``, the checked ids include -1 and -h (wrap once),
    h and -h-1 (dropped). Timed on the valid ids beside
    ``dst.index_add(0, ids, upd)``, the same function with atomic order;
    one more call profiled (the keys, sort, summing and join kernels by
    time)."""
    from paddle_tpu_torch.ops.kernels.embedding import _scatter_add_two_level
    h, d = dst.shape
    n = ids.numel()
    kern = K.get_body("embedding_scatter_add", "kernel")
    plain = K.get_body("embedding_scatter_add", "reference")
    test_ids = ids.clone()
    if edge:
        test_ids[:4] = torch.tensor([-1, -h, h, -h - 1], device="cuda")
    out, again = kern(dst, test_ids, upd), kern(dst, test_ids, upd)
    ref = plain(dst, test_ids, upd)
    args_cpu = (dst.cpu(), test_ids.cpu(), upd.cpu())
    cpu = plain(*args_cpu)
    emulated = _scatter_add_two_level(*args_cpu)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"embedding_scatter_add {label}: two "
                                   "launches differ")
    check(torch.equal(out.cpu(), emulated), f"embedding_scatter_add "
          f"{label}: kernel differs from the two-level emulation on the "
          f"CPU: {max_err(out.cpu(), emulated)}")
    atol = scatter_atol(test_ids, h, upd)
    rtol = 2.0 ** -7 if dst.dtype == torch.bfloat16 else 1e-6
    cpu_err = max_err(out.cpu(), cpu)
    check(within(out.cpu(), cpu, atol, rtol), f"embedding_scatter_add "
          f"{label}: kernel disagrees with plain on the CPU: {cpu_err}")
    err = max_err(out, ref)
    check(within(out, ref, atol, rtol), f"embedding_scatter_add {label}: "
          f"kernel disagrees with plain on the card: {err}")
    nbytes = (2 * dst.numel() * dst.element_size()
              + upd.numel() * upd.element_size() + n * ids.element_size())
    b_ms, b_by = bound(nbytes, (n + h) * d, torch.float32)
    ms = device_ms(lambda: kern(dst, ids, upd), 20)
    plain_ms = device_ms(lambda: plain(dst, ids, upd), 5)
    lib_ms = device_ms(lambda: dst.index_add(0, ids, upd), 20)
    rec = dict(label=label, dst=[h, d], dtype=str(dst.dtype),
               updates_dtype=str(upd.dtype), ids=n, ids_dtype=str(ids.dtype),
               edge_ids=edge, max_abs_err=err, max_abs_err_cpu=cpu_err,
               tol=f"bitwise on repeat and against the two-level emulation "
                   f"on the CPU; plain body (CPU and card): atol "
                   f"{atol:.3g}, rtol {rtol:.3g}",
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               library="Tensor.index_add", bound_ms=b_ms, bound_by=b_by,
               bytes=nbytes, host_ms_per_call=host_ms(
                   lambda: kern(dst, ids, upd), 50),
               profile=op_breakdown(lambda: kern(dst, ids, upd), top=8))
    log("check embedding_scatter_add " + json.dumps(rec))
    return rec


def check_xent(K, label, n, v, dtype, gen, edge=False):
    """The softmax cross-entropy kernel against its plain body on logits
    [n, v] (N(0, 4)) and labels in [0, v); with ``edge`` the checked labels
    include -1 (the last column) and v (NaN). Timed on the valid labels
    beside ``F.cross_entropy(x.float(), labels, reduction="none")``."""
    x = (torch.randn(n, v, generator=gen, device="cuda") * 2).to(dtype)
    labels = torch.randint(0, v, (n,), generator=gen, device="cuda")
    test_labels = labels.clone()
    if edge:
        test_labels[:2] = torch.tensor([-1, v], device="cuda")
    kern = K.get_body("softmax_cross_entropy", "kernel")
    plain = K.get_body("softmax_cross_entropy", "reference")
    (loss, lse), (loss_r, lse_r) = kern(x, test_labels), plain(x,
                                                               test_labels)
    torch.cuda.synchronize()
    # fp32 sums of v exps in another order (online per thread, then merged)
    # and logs of them: lse within 1e-5 relative, loss = lse - picked
    # within 1e-4 absolute (losses ~ log v); NaN exactly where plain has it
    nan_same = bool((loss.isnan() == loss_r.isnan()).all())
    err = max(max_err(torch.nan_to_num(loss), torch.nan_to_num(loss_r)),
              max_err(lse, lse_r))
    check(nan_same and within(torch.nan_to_num(loss),
                              torch.nan_to_num(loss_r), 1e-4, 1e-5)
          and within(lse, lse_r, 1e-5, 1e-5),
          f"softmax_cross_entropy {label}: kernel disagrees with plain: "
          f"{err}")
    if edge:
        check(bool(loss[1].isnan()) and bool(loss[0].isfinite()),
              f"softmax_cross_entropy {label}: edge labels")
    nbytes = n * v * x.element_size() + n * labels.element_size() + 8 * n
    b_ms, b_by = bound(nbytes, 4 * n * v, torch.float32)
    ms = device_ms(lambda: kern(x, labels), 20)
    plain_ms = device_ms(lambda: plain(x, labels), 5)
    lib_ms = device_ms(lambda: torch.nn.functional.cross_entropy(
        x.float(), labels, reduction="none"), 20)
    rec = dict(label=label, logits=[n, v], dtype=str(dtype), edge=edge,
               max_abs_err=err, tol="lse atol 1e-5 rtol 1e-5; loss atol "
               "1e-4 rtol 1e-5; NaN where plain", ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms,
               library="F.cross_entropy(x.float(), reduction='none')",
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
               host_ms_per_call=host_ms(lambda: kern(x, labels), 50))
    log("check softmax_cross_entropy " + json.dumps(rec))
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
    dev_batch = on_card(batch)
    serving.update(device_split(
        lambda: serve(bert, params, cfg, dev_batch),
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
    ("flash_attention", r"flash_fwd_(wgmma_)?kernel"),
    ("flash_attention_bwd_dkdv", r"flash_bwd_dkdv_(wgmma_)?kernel"),
    ("flash_attention_bwd_dq", r"flash_bwd_dq_(wgmma_)?kernel"),
    ("fused_layer_norm", r"layer_norm_fwd_kernel"),
    ("fused_adam", r"fused_adam_kernel"),
    ("embedding_gather", r"::gather_kernel<"),
    ("fused_matmul_int8", r"fused_matmul_(wgmma_)?kernel<\w+, signed char"),
    ("fused_matmul", r"fused_matmul_(wgmma_)?kernel"),
    ("fused_sgd", r"fused_sgd_kernel"),
    ("fused_momentum", r"fused_momentum_kernel"),
    # the port's own CUB sort (namespace cub::, where torch's is
    # at_cuda_detail::cub::) is the scatter-add's index preparation
    ("embedding_scatter_add",
     r"scatter_(keys|sum|join)_kernel|^(void )?cub::"),
    ("softmax_cross_entropy", r"xent_kernel"),
    # the image models: cuDNN's convolutions (forward, data and weight
    # gradients), batch norm, pooling
    ("conv", r"fprop|dgrad|wgrad|implicit_gemm|conv|winograd|fft"),
    ("batch_norm", r"batch_norm|batchnorm|welford|bn_"),
    ("pool", r"pool"),
    ("matmul", r"gemm|xmma|cutlass|cublas|nvjet|sm90_"),
    ("softmax", r"softmax"),
    ("reduction", r"reduce"),
    ("index/scatter/sort", r"index|scatter|gather|sort"),
    ("copy/cast", r"copy|cat"),
    ("elementwise", r"elementwise"),
)


def op_breakdown(fn, top=10, host_top=0, groups=KERNEL_GROUPS):
    """Device time by CUDA kernel over one call of ``fn`` (after one
    warm-up call), from ``torch.profiler``: ms per group of ``groups``
    ("other" for the rest), the number of device events (kernels and
    copies) and the ``top`` kernels by time, names cut to 100 characters;
    with ``host_top``, also the host's total time in the call and its
    ``host_top`` operators by self CPU time. Empty when the profiler
    recorded no device time."""
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
    by_group = {}
    for name, ms, _ in kernels:
        g = next((g for g, pat in groups
                  if re.search(pat, name, re.I)), "other")
        by_group[g] = by_group.get(g, 0.0) + ms
    total = sum(by_group.values())
    kernels.sort(key=lambda r: -r[1])
    out = dict(
        kernel_ms=total, launches=sum(n for _, _, n in kernels),
        groups_ms=dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        top=[[name[:100], ms, n] for name, ms, n in kernels[:top]])
    if host_top:
        cpu = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                      for e in stats
                      if e.device_type == torch.autograd.DeviceType.CPU),
                     key=lambda r: -r[1])
        out.update(host_ms_profiled=host_ms,
                   host_top=[[n[:80], ms, c] for n, ms, c in cpu[:host_top]])
    return out


def on_card(batch):
    """A feed dict of host arrays as CUDA tensors."""
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def device_split(fn, host_latency_ms, kernels=None, top=10):
    """Where a call's time goes: ``fn()`` captured in a CUDA graph gives the
    device time of the work without the host's launch overhead; its ratio
    to the host latency of the same call is the device's busy share, and
    each kernel's share is launches x its device time at the main shape
    (from phase 2) over it.
    Runs after the counted runs; its launches are not counted."""
    dev_ms = device_ms(fn, 3)
    out = dict(device_ms=dev_ms, device_busy_share=dev_ms / host_latency_ms)
    for name, (launches, ms) in (kernels or {}).items():
        out[f"{name}_device_share"] = launches * ms / dev_ms
    out["profile"] = op_breakdown(fn, top=top)
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
    dev_batch = on_card(batch)
    rec.update(device_split(
        lambda: bert.mlm_loss(params, cfg, dev_batch),
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
    return main, startup, loss, pred


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
    main, startup, loss, pred = build_word2vec(
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
    main_m, startup_m, loss_m, _ = build_word2vec(
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
    # the SGD-trained model, for phase 9 to deploy
    return rec, (main, scope, pred, exe)


# ---------------------------------------------------------------------------
# phase 9: Fluid inference and weight-only int8 serving (serve-int8)
# ---------------------------------------------------------------------------
#: bench.py:1101-1104's defaults
SERVE_MAX_BATCH, SERVE_MAX_WAIT_MS, SERVE_REQUESTS, SERVE_RATE_X = \
    8, 2.0, 400, 3.0
W2V_FEEDS = tuple(f"w{i}" for i in range(4))


def freeze_serving_mlp(pt, d_fp, d_q):
    """bench.py:629-665's serving model with the port: x[256] -> fc 256
    relu -> fc 256 relu -> fc 10, random weights from the startup
    program's seed on the card, saved twice (fp32; and the same weights
    exported with quantize="int8")."""
    from paddle_tpu_torch import inference
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.data("x", [256], "float32")
        h = pt.layers.fc(x, 256, act="relu")
        h = pt.layers.fc(h, 256, act="relu")
        out = pt.layers.fc(h, 10)
    scope = pt.Scope()
    exe = pt.Executor()
    exe.run(startup, scope=scope)
    with pt.scope_guard(scope):
        for d in (d_fp, d_q):
            pt.io.save_inference_model(d, ["x"], [out], exe,
                                       main_program=main)
    inference.export_aot(d_q, main, ["x"], [out.name], scope,
                         [{"x": ((1, 256), "float32")}], quantize="int8")


def export_word2vec(pt, trained, d_fp, d_q):
    """The word2vec model phase 8 trained, deployed: save_inference_model
    with fetch = the softmax, then the int8 export of the saved program."""
    from paddle_tpu_torch import inference
    main, scope, pred, exe = trained
    with pt.scope_guard(scope):
        for d in (d_fp, d_q):
            pt.io.save_inference_model(d, list(W2V_FEEDS), [pred], exe,
                                       main_program=main)
    prog, feeds, fetches = pt.io.load_inference_model(d_q, exe,
                                                      scope=pt.Scope())
    inference.export_aot(d_q, prog, feeds, fetches, scope,
                         [{n: ((1, 1), "int64") for n in W2V_FEEDS}],
                         quantize="int8")


def serve_fixture(srv, feeds):
    """Outputs of a 16-row fixture through ``srv``, in top-bucket
    requests."""
    import numpy as np
    rows = len(next(iter(feeds.values())))
    return np.concatenate([
        srv.infer({n: a[i:i + SERVE_MAX_BATCH] for n, a in feeds.items()},
                  timeout=120)[0]
        for i in range(0, rows, SERVE_MAX_BATCH)])


def open_loop(srv, feed, sched):
    """One request of ``feed`` per arrival time of ``sched`` (seconds from
    now), submitted without waiting for answers; returns (latencies in ms
    sorted, QPS, window s)."""
    import numpy as np
    pend, arrived = [], []
    t_origin = time.perf_counter()
    for t in sched:
        dly = t_origin + t - time.perf_counter()
        if dly > 0:
            time.sleep(dly)
        arrived.append(t_origin + t)
        pend.append(srv.submit(feed))
    for p in pend:
        p.result(timeout=600)
    done = [p.t_done for p in pend]
    lat = np.sort((np.asarray(done) - np.asarray(arrived)) * 1e3)
    return lat, len(sched) / (max(done) - t_origin), max(done) - t_origin


def serve_cell(K, label, d, fixture, one_row, want, sched, card):
    """Boot an InferenceServer on the card from ``d`` (bench.py's serving
    defaults), run the fixture, measure the service time of 20 sequential
    one-row requests, then the counted open-loop run of ``sched`` (launch
    counts set to 0 just before and read just after, held to ``want`` per
    formed micro-batch), and a profiled window of 100 more requests on
    the same schedule (device busy share, kernels by share)."""
    from paddle_tpu_torch.serving import InferenceServer, ServingConfig
    t0 = time.perf_counter()
    srv = InferenceServer(d, ServingConfig(
        max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_MAX_WAIT_MS,
        max_queue=SERVE_REQUESTS + 64, replicas=1))
    boot_s = time.perf_counter() - t0
    try:
        fix = serve_fixture(srv, fixture)
        t0 = time.perf_counter()
        for _ in range(20):
            srv.infer(one_row, timeout=60)
        svc_s = (time.perf_counter() - t0) / 20
        if sched is None:
            import numpy as np
            sched = np.cumsum(np.random.RandomState(42).exponential(
                svc_s / SERVE_RATE_X, size=SERVE_REQUESTS))
        batches0 = sum(r.batches_run for r in srv.pool.replicas)
        K.reset_launch_counts()
        lat, qps, window_s = open_loop(srv, one_row, sched)
        counts = K.launch_counts()
        batches = sum(r.batches_run for r in srv.pool.replicas) - batches0
        for name, n in counts.items():
            check(n == want.get(name, 0) * batches,
                  f"{label}: {n} {name} launches over {batches} micro-"
                  f"batches, expected {want.get(name, 0)} per batch")
        prof = op_breakdown(lambda: open_loop(srv, one_row, sched[:100]),
                            host_top=8)
        kernel_ms = prof.get("kernel_ms", 0.0)
        rec = dict(
            cell=label, boot_s=boot_s, service_ms=svc_s * 1e3,
            offered_qps=len(sched) / sched[-1], n_requests=len(sched),
            qps=qps, window_s=window_s,
            p50_ms=float(lat[len(lat) // 2]),
            p99_ms=float(lat[min(len(lat) - 1, int(0.99 * len(lat)))]),
            micro_batches=batches, rows_per_batch=len(sched) / batches,
            launches={k: v for k, v in counts.items() if v},
            param_bytes=srv.pool.resident_param_bytes(),
            model_version=srv.model_version,
            device_busy_share=kernel_ms / prof["host_ms_profiled"]
            if prof else None,
            kernel_share={g: ms / kernel_ms
                          for g, ms in prof.get("groups_ms", {}).items()},
            profile=prof)
        log(f"serve-int8 {label}: {rec['qps']:.1f} QPS (offered "
            f"{rec['offered_qps']:.1f}), p50 {rec['p50_ms']:.3f} ms, p99 "
            f"{rec['p99_ms']:.3f} ms, {batches} micro-batches, "
            f"{rec['param_bytes']} resident param bytes [{card}]")
    finally:
        check(srv.close(timeout=120), f"{label}: server did not close")
    return rec, fix, sched, counts


def phase_serve_int8(K, pt, card, trained):
    """Deploy the serving MLP and the word2vec model phase 8 trained as
    fp32 and int8 directories, serve each on the card at bench.py's
    defaults under one open-loop Poisson schedule per model at 3x its fp32
    server's service rate, and hold int8 against fp32, the card against
    the CPU and the Predictor against the server."""
    import tempfile

    import numpy as np

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import InferenceServer, ServingConfig
    per_batch = {
        ("mlp", "fp32"): {"fused_matmul": 3},
        ("mlp", "int8"): {"fused_matmul_int8": 3},
        ("w2v", "fp32"): {"embedding_gather": 4, "fused_matmul": 2},
        ("w2v", "int8"): {"embedding_gather": 4, "fused_matmul_int8": 2},
    }
    rng = np.random.RandomState(0)
    inputs = {
        "mlp": ({"x": rng.rand(16, 256).astype(np.float32)},
                {"x": rng.rand(1, 256).astype(np.float32)}),
        "w2v": ({n: rng.randint(0, W2V_VOCAB, (16, 1)) for n in W2V_FEEDS},
                {n: rng.randint(0, W2V_VOCAB, (1, 1)) for n in W2V_FEEDS}),
    }
    out = {"cells": {}, "launches": {}}
    with tempfile.TemporaryDirectory() as root:
        dirs = {(m, q): os.path.join(root, f"{m}_{q}")
                for m in ("mlp", "w2v") for q in ("fp32", "int8")}
        t0 = time.perf_counter()
        freeze_serving_mlp(pt, dirs["mlp", "fp32"], dirs["mlp", "int8"])
        export_word2vec(pt, trained, dirs["w2v", "fp32"],
                        dirs["w2v", "int8"])
        out["export_s"] = time.perf_counter() - t0
        for model in ("mlp", "w2v"):
            fixture, one_row = inputs[model]
            sched, fix = None, {}
            for q in ("fp32", "int8"):
                label = f"{model}-{q}"
                rec, fix[q], sched, counts = serve_cell(
                    K, label, dirs[model, q], fixture, one_row,
                    per_batch[model, q], sched, card)
                out["cells"][label] = rec
                for k, v in counts.items():
                    out["launches"][k] = out["launches"].get(k, 0) + v
            fp, i8 = out["cells"][f"{model}-fp32"], \
                out["cells"][f"{model}-int8"]
            ratio = i8["param_bytes"] / fp["param_bytes"]
            span = float(np.abs(fix["fp32"]).max())
            delta = float(np.abs(fix["int8"] - fix["fp32"]).max()) / span
            # the CPU's plain path from the same int8 directory
            with InferenceServer(dirs[model, "int8"], ServingConfig(
                    max_batch=SERVE_MAX_BATCH,
                    devices=[torch.device("cpu")])) as cpu_srv:
                cpu_fix = serve_fixture(cpu_srv, fixture)
            card_cpu = float(np.abs(fix["int8"] - cpu_fix).max())
            cfg = inference.Config(dirs[model, "fp32"])
            pred = inference.create_predictor(cfg).run(fixture)[0]
            pred_diff = float(np.abs(pred - fix["fp32"]).max())
            # acceptance of bench.py's BENCH_SERVING_QUANT A/B: resident
            # bytes <= 0.55x; int8 against fp32 set before the first card
            # run from the JAX package on the CPU (0.0041 and 0.0030 of the
            # output range): within 0.02. The card against the CPU, and the
            # Predictor against the server: fp32 sums in another order,
            # within 1e-5
            check(ratio <= 0.55, f"{model}: int8/fp32 resident bytes "
                                 f"{ratio}")
            check(delta <= 0.02, f"{model}: int8 vs fp32 outputs {delta} "
                                 f"of the output range")
            check(card_cpu <= 1e-5, f"{model}: int8 card vs CPU {card_cpu}")
            check(pred_diff <= 1e-5, f"{model}: Predictor vs server "
                                     f"{pred_diff}")
            check(all(np.isfinite(v).all() for v in
                      (*fix.values(), cpu_fix, pred)), f"{model}: not finite")
            out[model] = dict(
                resident_bytes_ratio=ratio, int8_vs_fp32_of_range=delta,
                fp32_output_range=span, int8_card_vs_cpu=card_cpu,
                predictor_vs_server=pred_diff,
                qps_ratio=i8["qps"] / fp["qps"],
                tol="bytes ratio <= 0.55; int8 vs fp32 <= 0.02 of the "
                    "range; card vs CPU and Predictor vs server <= 1e-5")
            log(f"serve-int8 {model}: resident bytes int8/fp32 {ratio:.4f}, "
                f"int8 vs fp32 {delta:.6f} of the range, card vs CPU "
                f"{card_cpu:.3g}, Predictor vs server {pred_diff:.3g}")
    log("serve_int8 " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 10: sparse-row updates and the fused loss (sparse-xent)
# ---------------------------------------------------------------------------
XENT, SCATTER = "softmax_cross_entropy", "embedding_scatter_add"
CTR_SLOTS, CTR_VOCAB, CTR_DIM, CTR_BATCH = 26, 100_000, 8, 2048  # deepfm.py
#: the exponent of the skewed CTR traffic: chosen, from no published
#: source; it stresses the merge's padding (few unique ids, long pad runs)
CTR_ZIPF_A = 1.2


def ctr_ids(rng, zipf_a=None):
    """One CTR batch's ids [2048 * 26] into the DeepFM table (one table,
    slot s's ids offset by s * 100,000) on the card: uniform over each
    slot's ids, as ``synthetic_ctr_batch`` (models/deepfm.py:242-250) draws
    them, or with ``zipf_a`` Zipf-skewed (rank r with weight r^-a, folded
    into the slot's ids)."""
    import numpy as np
    if zipf_a is None:
        z = rng.randint(0, CTR_VOCAB, (CTR_BATCH, CTR_SLOTS))
    else:
        z = (rng.zipf(zipf_a, (CTR_BATCH, CTR_SLOTS)) - 1) % CTR_VOCAB
    ids = (z + np.arange(CTR_SLOTS) * CTR_VOCAB).reshape(-1)
    return torch.as_tensor(ids, device="cuda")


def counted(K, label, fn, want, card):
    """``fn()`` with the launch counts set to 0 just before and read just
    after (a synchronize ends it): checks that exactly ``want`` kernels
    launched ({name: launches}, every other name 0). Returns (result, host
    ms, counts)."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = K.launch_counts()
    for name, n in counts.items():
        check(n == want.get(name, 0), f"{label}: {n} {name} launches, "
                                      f"expected {want.get(name, 0)}")
    log(f"sparse-xent {label}: {ms:.3f} ms, launches {want} [{card}]")
    return out, ms, counts


def phase_sparse_xent(K, bert, ops, card):
    """The functional surface for sparse-row gradients and losses at
    BERT-base width: pretrain-512's batch and BERT-base weights from the
    seed. (1) The gathered MLM head's logits [5120, 30528] through
    ``softmax_cross_entropy``: its weighted mean against ``mlm_loss``, its
    gradient against the plain body's autograd gradient. (2) The word
    embedding's gradient as a row set, 32768 ids into [30528, 768]:
    densify, merge, sparse SGD. (3) A DeepFM-width CTR table, 2.6 M rows x
    8, three steps of 53248 ids drawn as ``synthetic_ctr_batch`` draws
    them (uniform), then three Zipf-skewed: each densified against
    ``index_add_``, merged, its merged rows densified (bitwise equal) and
    applied by sparse SGD. Every call counts its launches exactly."""
    import numpy as np

    out, launches = {}, {}

    def run(label, fn, want):
        res, ms, counts = counted(K, label, fn, want, card)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return res, ms

    cfg = bert.bert_base(attention_impl="dense", remat=False,
                         softmax_dtype="bf16")
    B, S, P = 64, 512, 80
    V, H = cfg.vocab_size, cfg.hidden
    params = bert.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(2))
    batch = bert.synthetic_batch(cfg, B, S, max_preds=P)
    with torch.no_grad():
        want_loss = bert.mlm_loss(params, cfg, batch).item()
        hidden = bert.forward(params, cfg, batch["input_ids"],
                              batch["token_type_ids"],
                              batch["attention_mask"])
        logits32 = bert._mlm_head(params, cfg, hidden,
                                  batch["masked_positions"]).reshape(-1, V)
    del hidden
    labels = torch.as_tensor(batch["masked_labels"],
                             device="cuda").reshape(-1).long()
    w = torch.as_tensor(batch["masked_weights"], device="cuda").reshape(-1)
    denom = torch.clamp(w.sum(), min=1.0)

    # (1) the loss, fp32 logits (the head's own) and bf16
    loss32, ms32 = run("xent fp32 forward", lambda: (
        (K.softmax_cross_entropy(logits32, labels) * w).sum() / denom
    ).item(), {XENT: 1})
    logits = logits32.to(torch.bfloat16).requires_grad_()
    del logits32
    mean, fwd_ms = run("xent bf16 forward", lambda: (
        K.softmax_cross_entropy(logits, labels) * w).sum() / denom,
        {XENT: 1})
    _, bwd_ms = run("xent bf16 backward", lambda: mean.backward(), {})
    rel32 = abs(loss32 - want_loss) / abs(want_loss)
    rel16 = abs(mean.item() - want_loss) / abs(want_loss)
    # fp32: the same logits, sums of 30528 exps in another order: 1e-5
    # relative. bf16: each logit rounded once (~2^-9 of |x| ~ 0.5), which
    # moves the mean of 5120 losses by ~1e-6 relative (the CPU estimate):
    # 1e-4
    check(rel32 <= 1e-5, f"xent fp32 mean {loss32} vs mlm_loss "
                         f"{want_loss}: {rel32}")
    check(rel16 <= 1e-4, f"xent bf16 mean {mean.item()} vs mlm_loss "
                         f"{want_loss}: {rel16}")
    plain_lg = logits.detach().clone().requires_grad_()
    plain = K.get_body(XENT, "reference")(plain_lg, labels)[0]
    ((plain * w).sum() / denom).backward()
    g_err = max_err(logits.grad, plain_lg.grad)
    # the same fp32 softmax minus one-hot (lse summed in another order),
    # rounded once to bf16: one unit in the last place (rtol 2^-7)
    check(within(logits.grad, plain_lg.grad, 1e-10, 2.0 ** -7),
          f"xent bf16 grad vs plain autograd: {g_err}")
    out["xent"] = dict(
        logits=[B * P, V], mlm_loss=want_loss, mean_fp32=loss32,
        mean_bf16=mean.item(), rel_err_fp32=rel32, rel_err_bf16=rel16,
        grad_max_abs_err=g_err, fwd_fp32_ms=ms32, fwd_bf16_ms=fwd_ms,
        bwd_bf16_ms=bwd_ms,
        tol="mean vs mlm_loss: fp32 1e-5, bf16 1e-4 relative; grad rtol "
            "2^-7 atol 1e-10",
        # busy: the bf16 forward's own work (its saved lse aside) over its
        # host latency
        busy_bf16_forward=device_split(
            lambda: (K.softmax_cross_entropy(logits.detach(), labels) * w
                     ).sum() / denom, fwd_ms, top=6))
    del logits, plain_lg, plain, mean

    # (2) the word embedding's gradient as a row set
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = torch.as_tensor(batch["input_ids"], device="cuda").reshape(-1)
    rows = rows.long()
    vals = torch.randn(rows.numel(), H, generator=gen, device="cuda")
    sr = ops.SelectedRows(rows, vals, V)
    dense, dense_ms = run("densify 32768 rows",
                          lambda: ops.get_tensor_from_selected_rows(sr),
                          {SCATTER: 1})
    lib = torch.zeros(V, H, device="cuda").index_add_(0, rows, vals)
    d_err = max_err(dense, lib)
    check(within(dense, lib, scatter_atol(rows, V, vals), 1e-6),
          f"densify vs index_add_: {d_err}")
    (merged, valid), merge_ms = run(
        "merge 32768 rows", lambda: ops.merge_selected_rows(sr),
        {SCATTER: 1})
    n_unique = int(valid.sum())
    dense2, dense2_ms = run("densify merged",
                            lambda: ops.get_tensor_from_selected_rows(merged),
                            {SCATTER: 1})
    check(torch.equal(dense2, dense), "merge then densify differs from "
                                      f"densify: {max_err(dense2, dense)}")
    table = torch.randn(V, H, generator=gen, device="cuda")
    lr = 0.01
    new, sgd_ms = run("sparse SGD [30528,768]",
                      lambda: ops.sparse_sgd_update(table, merged, lr),
                      {SCATTER: 1})
    want = table - lr * dense
    s_err = max_err(new, want)
    check(within(new, want, 1e-7, 1e-6), f"sparse SGD vs table - lr * "
                                         f"dense: {s_err}")
    out["rows"] = dict(
        ids=rows.numel(), unique_rows=n_unique, table=[V, H],
        densify_vs_index_add=d_err, merged_densify_bitwise=True,
        sgd_vs_dense=s_err, sgd_bitwise=bool(torch.equal(new, want)),
        densify_ms=dense_ms, merge_ms=merge_ms, densify_merged_ms=dense2_ms,
        sgd_ms=sgd_ms,
        tol="densify vs index_add_: scatter_atol; merged densify: "
            "bitwise; SGD: atol 1e-7 rtol 1e-6",
        busy_sgd=device_split(
            lambda: ops.sparse_sgd_update(table, merged, lr), sgd_ms, top=6))
    del dense, dense2, lib, table, new, want, merged, vals, sr

    # (3) a DeepFM-width CTR table: 26 slots x 100,000 ids, 8 dims; three
    # steps of uniform ids, then three of skewed ones
    h_ctr = CTR_SLOTS * CTR_VOCAB
    table = torch.randn(h_ctr, CTR_DIM, generator=gen, device="cuda") * 0.01
    rng = np.random.RandomState(4)
    out["ctr"] = dict(table=[h_ctr, CTR_DIM],
                      table_mb=table.numel() * 4 / 1e6, batch=CTR_BATCH,
                      slots=CTR_SLOTS)
    for traffic, zipf_a in (("uniform", None), ("zipf", CTR_ZIPF_A)):
        steps = []
        for step in range(3):
            label = f"CTR {traffic} step {step}"
            ids = ctr_ids(rng, zipf_a)
            grads = torch.randn(ids.numel(), CTR_DIM, generator=gen,
                                device="cuda")
            sr = ops.SelectedRows(ids, grads, h_ctr)
            t0 = time.perf_counter()
            (merged, valid), m_ms = run(f"{label} merge",
                                        lambda: ops.merge_selected_rows(sr),
                                        {SCATTER: 1})
            new, s_ms = run(f"{label} sparse SGD",
                            lambda: ops.sparse_sgd_update(table, merged,
                                                          0.05),
                            {SCATTER: 1})
            step_ms = (time.perf_counter() - t0) * 1e3
            dense, d_ms = run(f"{label} densify",
                              lambda: ops.get_tensor_from_selected_rows(sr),
                              {SCATTER: 1})
            dense2, d2_ms = run(
                f"{label} densify merged",
                lambda: ops.get_tensor_from_selected_rows(merged),
                {SCATTER: 1})
            lib = torch.zeros(h_ctr, CTR_DIM, device="cuda").index_add_(
                0, ids, grads)
            d_err = max_err(dense, lib)
            check(within(dense, lib, scatter_atol(ids, h_ctr, grads), 1e-6),
                  f"{label}: densify vs index_add_: {d_err}")
            check(torch.equal(dense2, dense), f"{label}: merge then densify "
                  f"differs from densify: {max_err(dense2, dense)}")
            want = table - 0.05 * dense
            err = max_err(new, want)
            check(within(new, want, 1e-7, 1e-6), f"{label}: sparse SGD vs "
                                                 f"dense: {err}")
            top = int(torch.unique(ids, return_counts=True)[1].max())
            steps.append(dict(step=step, ids=ids.numel(),
                              unique_rows=int(valid.sum()), top_row_ids=top,
                              merge_ms=m_ms, sgd_ms=s_ms,
                              merge_sgd_ms=step_ms, densify_ms=d_ms,
                              densify_merged_ms=d2_ms,
                              densify_vs_index_add=d_err, sgd_vs_dense=err))
            table = new
        out["ctr"][traffic] = dict(
            zipf_a=zipf_a, steps=steps,
            busy_sgd=device_split(
                lambda: ops.sparse_sgd_update(table, merged, 0.05),
                statistics.mean(st["sgd_ms"] for st in steps[1:]), top=6))
    check(bool(table.isfinite().all()), "CTR table not finite")
    out["ctr"]["tol"] = ("densify vs index_add_: scatter_atol; merged "
                         "densify: bitwise; sparse SGD vs table - lr * "
                         "dense: atol 1e-7 rtol 1e-6")
    out["launches"] = launches
    log("sparse_xent " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 11 to 14: the image models (train-resnet50, train-correctness,
# infer-image, train-se-resnext50)
# ---------------------------------------------------------------------------
def image_train_calls(K, step_fn, params, state, images, labels, calls,
                      steps, label, card):
    """``calls`` calls of an image model's ``step_fn`` on one reused batch
    already on the card, each with the launch counts set to 0 just before
    and read just after; every call must launch exactly ``steps``
    ``fused_momentum`` kernels and nothing else registered, and end with a
    finite loss. Returns (per-call seconds, losses, accuracies, counts)."""
    lat, losses, accs, counts = [], [], [], []
    for i in range(calls):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss, acc, params, state = step_fn(params, state, images, labels)
        loss = loss.item()          # synchronizes
        dt = time.perf_counter() - t0
        c = K.launch_counts()
        counts.append(c)
        check(math.isfinite(loss), f"{label} call {i}: loss {loss}")
        for name, n in c.items():
            want = steps if name == "fused_momentum" else 0
            check(n == want, f"{label} call {i}: {n} {name} launches, "
                             f"expected {want}")
        lat.append(dt)
        losses.append(loss)
        accs.append(acc.item())
        log(f"{label} call {i}: {steps} steps, last loss {loss:.6f}, "
            f"{dt * 1e3 / steps:.3f} ms/step [{card}]")
    return lat, losses, accs, counts


def phase_train_resnet50(K, resnet, optimizer, card):
    """``bench.py resnet50``'s config, nothing cut: ResNet-50, bf16, 224,
    batch 256 of ``synthetic_batch`` reused, Momentum(0.1, 0.9), 8 steps a
    call, 3 calls (steady state: calls 2-3)."""
    cfg = resnet.resnet50()
    B, spc, calls = 256, 8, 3
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    init_fn, step_fn = resnet.make_train_step(cfg, opt, steps_per_call=spc)
    params, state = init_fn(torch.Generator(device="cuda").manual_seed(7))
    images, labels = resnet.synthetic_batch(cfg, B)
    images = torch.as_tensor(images, device="cuda")
    labels = torch.as_tensor(labels, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat, losses, accs, counts = image_train_calls(
        K, step_fn, params, state, images, labels, calls, spc,
        "train-resnet50", card)
    peak = torch.cuda.max_memory_allocated()
    card_after = log_card("after train-resnet50's calls")
    step_ms = 1e3 * sum(lat[1:]) / (len(lat[1:]) * spc)
    ips = B / (step_ms * 1e-3)
    _, step1 = resnet.make_train_step(cfg, opt)
    # one more step under the profiler: its kernels' device time over the
    # steady step latency is the busy share
    prof = op_breakdown(lambda: step1(params, state, images, labels),
                        top=10, host_top=8)
    rec = dict(batch=B, image_size=cfg.image_size, dtype="bfloat16",
               steps_per_call=spc, losses=losses, accuracies=accs,
               ms_per_step=[t * 1e3 / spc for t in lat],
               steady_ms_per_step=step_ms, steady_images_per_s=ips,
               gflop_per_image=resnet.flops_per_image(cfg) / 1e9,
               mfu=resnet.flops_per_image(cfg) * ips / PEAK_OPS_PER_S[
                   torch.bfloat16],
               device_busy_share=(prof.get("kernel_ms", 0.0) / step_ms
                                  if prof else None),
               peak_gb=peak / 1e9, card_after=card_after, card=card,
               launches={n: sum(c[n] for c in counts) for n in counts[0]},
               profile=prof)
    log("train_resnet50 " + json.dumps(rec))
    del params, state, images
    return rec


def phase_image_train_checks(K, resnet, optimizer, pt, card):
    """resnet_cifar10(depth=8, image_size=16), batch 8: three Momentum
    steps in bf16 on the card against the port on the CPU in fp32 from the
    same weights; then the same with a piecewise schedule, L2 decay and a
    global-norm clip, so they run on the card (exactly 1 momentum launch
    per step, the rate read from the card)."""
    cfg = resnet.resnet_cifar10(depth=8, image_size=16)
    images, labels = resnet.synthetic_batch(cfg, 8, seed=3)

    def make(variant):
        if variant == "momentum":
            return optimizer.Momentum(learning_rate=0.1, momentum=0.9)
        return optimizer.Momentum(
            learning_rate=pt.layers.piecewise_decay([2], [0.1, 0.05]),
            momentum=0.9, regularization=pt.regularizer.L2Decay(1e-4),
            grad_clip=pt.clip.GradientClipByGlobalNorm(1.0))

    rec, launches = {}, {}
    for variant in ("momentum", "schedule+l2+clip"):
        losses = {}
        for dev, c in (("cuda", cfg),
                       ("cpu", dataclasses.replace(cfg,
                                                   dtype=torch.float32))):
            init_fn, step_fn = resnet.make_train_step(c, make(variant),
                                                      device=dev)
            params, state = init_fn(torch.Generator().manual_seed(3))
            if dev == "cuda":
                _, ls, _, counts = image_train_calls(
                    K, step_fn, params, state, torch.as_tensor(
                        images, device="cuda"), torch.as_tensor(
                        labels, device="cuda"), 3, 1,
                    f"train-correctness {variant}", card)
                for cn in counts:
                    for n, v in cn.items():
                        launches[n] = launches.get(n, 0) + v
            else:
                ls = []
                for _ in range(3):
                    loss, _, params, state = step_fn(params, state, images,
                                                     labels)
                    ls.append(loss.item())
            losses[dev] = ls
        diffs = [abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"])]
        # set before the first card run from the same comparison on the CPU
        # (port bf16 against port fp32): loss differences at most 0.0054
        # (Momentum) and 0.0028 (schedule, L2 decay, clip): within 0.03
        check(max(diffs) < 0.03, f"train-correctness {variant}: card bf16 "
                                 f"vs CPU fp32 losses {losses}")
        rec[variant] = dict(losses_card_bf16=losses["cuda"],
                            losses_cpu_fp32=losses["cpu"], loss_diffs=diffs)
    rec.update(tol="loss 0.03 at each of 3 steps", card=card,
               launches=launches)
    log("image_train_checks " + json.dumps(rec))
    return rec


def phase_infer_image(K, resnet, vgg, card):
    """``bench.py inference``'s shapes: ``forward(train=False)`` of
    ResNet-50 at batches 1-128 and VGG-16 at 1-64, bf16 and fp32, on zero
    images (bench.py:258-259): host clock to a synchronize, 30 runs after 3
    of warm-up; no registered kernel launches. Then at batch 2, from the
    same weights (batch-norm stats set by one training forward on the CPU),
    the card against the port on the CPU in fp32, with cuDNN's TF32 left
    at PyTorch's default (on): the fp32 model must turn it off itself."""
    from paddle_tpu_torch.core.tree import map_tree
    out = {"card": card}
    for mod, cfg, batches in (
            (resnet, resnet.resnet50(), (1, 2, 4, 8, 16, 32, 64, 128)),
            (vgg, vgg.vgg16(), (1, 2, 4, 8, 16, 32, 64))):
        name = type(cfg).__name__
        params = mod.init_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(8))
        for dt in (torch.bfloat16, torch.float32):
            c = dataclasses.replace(cfg, dtype=dt)
            rows = []
            for b in batches:
                x = torch.zeros(b, cfg.image_size, cfg.image_size, 3,
                                device="cuda")
                with torch.inference_mode():
                    for _ in range(3):
                        mod.forward(params, c, x, train=False)
                    torch.cuda.synchronize()
                    K.reset_launch_counts()
                    ms = []
                    for _ in range(30):
                        t0 = time.perf_counter()
                        logits, _ = mod.forward(params, c, x, train=False)
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t0) * 1e3)
                check(bool(torch.isfinite(logits).all()),
                      f"infer-image {name} {dt} batch {b}: logits")
                check(not any(K.launch_counts().values()),
                      f"infer-image {name}: a registered kernel launched")
                rows.append(dict(batch=b, median_ms=statistics.median(ms),
                                 min_ms=min(ms), max_ms=max(ms),
                                 images_per_s=b / statistics.median(ms)
                                 * 1e3))
                log(f"infer-image {name} {str(dt)[6:]} batch {b}: "
                    f"{statistics.median(ms):.3f} ms median [{card}]")
            out[f"{name} {str(dt)[6:]}"] = rows
        del params
        # the card against the CPU at batch 2, from one set of weights
        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        cpu = mod.init_params(c32, torch.Generator().manual_seed(8),
                              device="cpu")
        calib, _ = mod.synthetic_batch(cfg, 4, seed=9)
        with torch.no_grad():
            _, new = mod.forward(cpu, c32, calib, train=True)
            resnet._merge_bn_stats(cpu, new)
            x = calib[:2]
            want = mod.forward(cpu, c32, x, train=False)[0]
        card_params = map_tree(lambda _, t: t.to("cuda"), cpu)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            with torch.inference_mode():
                got32 = mod.forward(card_params, c32, x, train=False)[0]
                got16 = mod.forward(card_params, cfg, x, train=False)[0]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        scale = want.abs().max().item()
        e32 = max_err(got32.cpu(), want) / scale
        e16 = max_err(got16.cpu(), want) / scale
        # fp32: the card and the CPU sum in other orders (observed 1.6e-6
        # relative on a reduced ResNet-50 in eval mode against the JAX
        # package); bf16 against fp32 on the CPU at 64x64: 0.046 and 0.011
        # of the largest logit (ResNet-50, VGG-16)
        check(e32 < 1e-3, f"infer-image {name}: card fp32 vs CPU fp32 "
                          f"{e32} of the largest logit {scale}")
        check(e16 < 0.15, f"infer-image {name}: card bf16 vs CPU fp32 "
                          f"{e16} of the largest logit {scale}")
        out[f"{name} card vs cpu"] = dict(
            batch=2, max_abs_logit=scale, fp32_rel_err=e32,
            bf16_rel_err=e16, tol="fp32 1e-3, bf16 0.15 of the largest "
                                  "logit")
        log(f"infer-image {name} batch 2: card fp32 {e32:.3g}, bf16 "
            f"{e16:.3g} of the largest logit {scale:.4g} vs the CPU in fp32 "
            f"[{card}]")
        del cpu, card_params
    log("infer_image " + json.dumps(out))
    return out


def phase_train_se_resnext50(K, se_resnext, optimizer, card):
    """SE-ResNeXt-50 at 224, batch 32 (a choice: bench.py has no
    SE-ResNeXt), bf16, Momentum(0.1, 0.9): 3 calls of one step, exactly 1
    momentum launch each."""
    cfg = se_resnext.se_resnext50()
    B = 32
    init_fn, step_fn = se_resnext.make_train_step(
        cfg, optimizer.Momentum(learning_rate=0.1, momentum=0.9))
    params, state = init_fn(torch.Generator(device="cuda").manual_seed(9))
    images, labels = se_resnext.synthetic_batch(cfg, B)
    images = torch.as_tensor(images, device="cuda")
    labels = torch.as_tensor(labels, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat, losses, accs, counts = image_train_calls(
        K, step_fn, params, state, images, labels, 3, 1,
        "train-se-resnext50", card)
    step_ms = 1e3 * sum(lat[1:]) / len(lat[1:])
    rec = dict(batch=B, image_size=cfg.image_size, losses=losses,
               ms_per_step=[t * 1e3 for t in lat], steady_ms_per_step=step_ms,
               steady_images_per_s=B / (step_ms * 1e-3),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, card=card,
               launches={n: sum(c[n] for c in counts) for n in counts[0]})
    log("train_se_resnext50 " + json.dumps(rec))
    del params, state, images
    return rec


# ---------------------------------------------------------------------------
# phases 15-18: Transformer-big NMT and the DeepFM CTR trainer
# ---------------------------------------------------------------------------
NMT_B, NMT_S, NMT_STEPS = 32, 256, 20     # bench.py nmt (:1738-1745)
NMT_DECODE_LEN, NMT_BEAM, NMT_REPS = 64, 4, 5    # bench.py nmt (:1762-1780)
# the tied output projection's three fp32 products (x @ E^T and its two
# backward products) are the step's only fp32 GEMMs: cuBLAS's fp32 SIMT
# kernels (gemm_f32f32_f32f32_f32_..._ffma)
TIED_FP32_GROUP = ("tied fp32 projection (fp32 SIMT GEMMs)",
                   r"f32f32_f32f32_f32|sgemm")


def tied_projection_ms(cfg, B, T):
    """Device ms of the tied output projection's forward and its two
    backward products at train-transformer-big's shapes, fp32, TF32 off (as
    the model runs them): x [B*T, h] @ E^T, dlogits @ E, dlogits^T @ x."""
    n, h, v = B * T, cfg.hidden, cfg.tgt_vocab
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(n, h, generator=gen, device="cuda")
    e = torch.randn(v, h, generator=gen, device="cuda")
    dl = torch.randn(n, v, generator=gen, device="cuda")
    out = {}
    for name, fn in (("forward x @ E^T", lambda: x @ e.T),
                     ("backward dlogits @ E", lambda: dl @ e),
                     ("backward dlogits^T @ x", lambda: dl.T @ x)):
        out[name] = device_ms(fn, 3)
    out["total"] = sum(out.values())
    out["tflops"] = 3 * 2 * n * h * v / (out["total"] * 1e-3) / 1e12
    del x, e, dl
    return out


def phase_train_transformer_big(K, transformer, optimizer, card, adam_ms):
    """``bench.py nmt``'s training config, nothing cut: Transformer-big
    (hidden 1024, 16 heads, FFN 4096, 6+6 layers, vocab 32768), bf16, batch
    32, source and target 256, Adam(1e-4) on one reused ``synthetic_batch``;
    2 warm-up steps, then 20 counted steps, each with the launch counts set
    to 0 just before and read just after: exactly 1 ``fused_adam`` and no
    other registered kernel. tokens/s (target tokens), MFU against 989
    TFLOP/s on ``flops_per_step``, step latency, peak memory, and one
    profiled step's kernels by group with the tied fp32 projection on a
    line of its own (busy share: their device time over the step
    latency)."""
    cfg = transformer.transformer_big(max_seq=NMT_S)
    B, S, steps = NMT_B, NMT_S, NMT_STEPS
    opt = optimizer.Adam(learning_rate=1e-4)
    init_fn, step_fn = transformer.make_train_step(cfg, opt)
    params, state = init_fn(torch.Generator(device="cuda").manual_seed(11))
    batch = on_card(transformer.synthetic_batch(cfg, B, S, S))
    warm = []
    for _ in range(2):
        loss, params, state = step_fn(params, state, batch)
        warm.append(loss.item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, losses = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        K.reset_launch_counts()
        loss, params, state = step_fn(params, state, batch)
        counts.append(K.launch_counts())
        losses.append(loss)
    losses = torch.stack(losses).tolist()       # synchronizes
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated()
    card_after = log_card("after train-transformer-big's steps")
    for i, c in enumerate(counts):
        for name, n in c.items():
            want = 1 if name == "fused_adam" else 0
            check(n == want, f"train-transformer-big step {i}: {n} {name} "
                             f"launches, expected {want}")
    check(all(math.isfinite(x) for x in losses),
          f"train-transformer-big: losses {losses}")
    check(losses[-1] < warm[0], f"train-transformer-big: loss {losses[-1]} "
                                f"after {steps + 2} steps, {warm[0]} first")
    tps = B * S / (step_ms * 1e-3)
    flops = transformer.flops_per_step(cfg, B, S, S)
    prof = op_breakdown(lambda: step_fn(params, state, batch), top=12,
                        host_top=8,
                        groups=(TIED_FP32_GROUP,) + KERNEL_GROUPS)
    tied = tied_projection_ms(cfg, B, S)
    rec = dict(batch=B, src_len=S, tgt_len=S, dtype="bfloat16", steps=steps,
               warmup_losses=warm, losses=losses, steady_ms_per_step=step_ms,
               target_tokens_per_s=tps, tflop_per_step=flops / 1e12,
               mfu=flops / (step_ms * 1e-3) / PEAK_OPS_PER_S[torch.bfloat16],
               device_busy_share=(prof.get("kernel_ms", 0.0) / step_ms
                                  if prof else None),
               peak_gb=peak / 1e9, card_after=card_after, card=card,
               adam_device_share=adam_ms / step_ms,
               tied_projection_ms=tied,
               launches={n: sum(c[n] for c in counts) for n in counts[0]},
               profile=prof)
    log("train_transformer_big " + json.dumps(rec))
    if prof:
        log("train-transformer-big kernels by share of one step's "
            f"{prof['kernel_ms']:.3f} device ms:")
        for g, ms in prof["groups_ms"].items():
            log(f"  {g}: {ms:.3f} ms ({ms / prof['kernel_ms']:.1%})")
    log(f"train-transformer-big tied fp32 projection: "
        f"{tied['total']:.3f} ms a step ({tied['total'] / step_ms:.1%} of "
        f"{step_ms:.3f} ms; {tied['tflops']:.1f} TFLOP/s), forward "
        f"{tied['forward x @ E^T']:.3f}, backward "
        f"{tied['backward dlogits @ E']:.3f} + "
        f"{tied['backward dlogits^T @ x']:.3f} ms [{card}]")
    return rec, (params, cfg, batch)


def phase_decode_transformer_big(K, transformer, card, trained):
    """``bench.py nmt``'s decode on train-transformer-big's params and
    source batch: ``beam_search_decode(beam_size=4, max_len=64)`` and
    ``greedy_decode(max_len=64)``, one warm-up then 5 timed decodes each
    (host clock to the tokens read back); no registered kernel launches.
    Latency per decode, decode tokens/s (batch x max_len over it), and from
    one profiled decode the device's busy share and its kernel launches
    per step."""
    params, cfg, batch = trained
    src, mask = batch["src_ids"], batch["src_mask"]
    B, L = src.shape[0], NMT_DECODE_LEN
    runs = {
        "beam4": lambda: transformer.beam_search_decode(
            params, cfg, src, mask, beam_size=NMT_BEAM, max_len=L),
        "greedy": lambda: transformer.greedy_decode(params, cfg, src, mask,
                                                    max_len=L),
    }
    rec = dict(batch=B, max_len=L, beam=NMT_BEAM, reps=NMT_REPS, card=card)
    for name, fn in runs.items():
        out = fn()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        lat = []
        for _ in range(NMT_REPS):
            t0 = time.perf_counter()
            out = fn()
            toks = (out[0] if isinstance(out, tuple) else out).cpu()
            lat.append((time.perf_counter() - t0) * 1e3)
        counts = K.launch_counts()
        check(not any(counts.values()), f"decode {name}: registered kernel "
                                        f"launches {counts}")
        want = (B, NMT_BEAM, L) if name == "beam4" else (B, L)
        check(tuple(toks.shape) == want and toks.dtype == torch.int32,
              f"decode {name}: tokens {toks.dtype}{list(toks.shape)}")
        if name == "beam4":
            scores = out[1].cpu()
            check(bool(torch.isfinite(scores).all())
                  and bool((scores[:, 1:] <= scores[:, :-1]).all()),
                  f"decode beam4: scores not finite or not best-first")
        prof = op_breakdown(fn, top=8, host_top=6)
        launches = prof.get("launches")
        ms = statistics.median(lat)
        rec[name] = dict(
            latency_ms=lat, median_ms=ms,
            decode_tokens_per_s=B * L / (ms * 1e-3),
            device_busy_share=(prof["kernel_ms"] / prof["host_ms_profiled"]
                               if prof else None),
            kernel_launches_per_step=(launches / L if launches else None),
            profile=prof)
        log(f"decode-transformer-big {name}: {ms:.3f} ms per decode (median "
            f"of {NMT_REPS}), {B * L / (ms * 1e-3):.1f} tokens/s, "
            f"{rec[name]['kernel_launches_per_step']} launches a step, "
            f"busy {rec[name]['device_busy_share']} [{card}]")
    log("decode_transformer_big " + json.dumps(rec))
    return rec


def phase_transformer_checks(K, transformer, optimizer, card):
    """(a) transformer_tiny in fp32 on the card (TF32 off) against the port
    on the CPU from the same weights: forward logits within 1e-4 of the
    largest, greedy tokens equal (a flip prints its position and the CPU's
    top-2 margin there). (b) Transformer-big's widths, depth cut to 1+1
    layers, batch 2x32: 3 Adam(1e-4) steps in bf16 on the card against
    fp32 on the CPU from the same weights, losses within 0.03 (BERT's
    bound)."""
    cfg = transformer.transformer_tiny(dtype=torch.float32)
    b = transformer.synthetic_batch(cfg, 4, 12, 10, seed=1)
    b["src_mask"][1, 8:] = 0
    b["tgt_mask"][2, 7:] = 0
    out = {}
    for dev in ("cuda", "cpu"):
        params = transformer.init_params(
            cfg, torch.Generator().manual_seed(5), device=dev)
        with torch.no_grad():
            logits = transformer.forward(params, cfg, b["src_ids"],
                                         b["tgt_in"], b["src_mask"],
                                         b["tgt_mask"])
        out[dev] = (logits.cpu(), transformer.greedy_decode(
            params, cfg, b["src_ids"], b["src_mask"]).cpu())
    cpu_params = params          # the loop ends on the CPU
    err = max_err(out["cuda"][0], out["cpu"][0]) / \
        out["cpu"][0].abs().max().item()
    check(err < 1e-4, f"transformer fp32 card vs CPU: logits {err} of the "
                      "largest")
    flips = (out["cuda"][1] != out["cpu"][1]).nonzero().tolist()
    for row, pos in flips[:3]:
        # the CPU's logits at the flipped step, teacher-forced on its own
        # tokens: the top-2 margin there
        toks = out["cpu"][1][row:row + 1]
        tin = torch.cat([torch.full((1, 1), cfg.bos_id, dtype=torch.int32),
                         toks[:, :-1]], dim=1)
        with torch.no_grad():
            lg = transformer.forward(cpu_params, cfg,
                                     b["src_ids"][row:row + 1], tin,
                                     b["src_mask"][row:row + 1])[0, pos]
        top2 = torch.topk(lg, 2).values
        log(f"transformer greedy flip at row {row} pos {pos}: CPU top-2 "
            f"margin {(top2[0] - top2[1]).item():.3e}")
    check(not flips, f"transformer fp32 card vs CPU: greedy tokens differ "
                     f"at {flips[:8]}")
    rec = dict(fp32_logits_rel_err=err, fp32_tol="1e-4 of the largest logit",
               greedy_equal=True)

    cfg = transformer.transformer_big(enc_layers=1, dec_layers=1,
                                      max_seq=64)
    batch = transformer.synthetic_batch(cfg, 2, 32, 32, seed=5)
    losses = {}
    for dev, c in (("cuda", cfg),
                   ("cpu", dataclasses.replace(cfg, dtype=torch.float32))):
        init_fn, step_fn = transformer.make_train_step(
            c, optimizer.Adam(learning_rate=1e-4), device=dev)
        params, state = init_fn(torch.Generator().manual_seed(3))
        losses[dev] = []
        for _ in range(3):
            loss, params, state = step_fn(params, state, batch)
            losses[dev].append(loss.item())
        del params, state
    diffs = [abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"])]
    # set before the first card run from the same comparison on the CPU
    # (port bf16 against port fp32): loss differences 0.00053, 0.0010 and
    # 0.00018 over the three steps: within 0.03 at every step
    check(max(diffs) < 0.03, f"transformer card bf16 vs CPU fp32: losses "
                             f"{losses}")
    rec.update(losses_card_bf16=losses["cuda"], losses_cpu_fp32=losses["cpu"],
               loss_diffs=diffs, tol="loss 0.03 at each of 3 steps",
               card=card)
    log("transformer_checks " + json.dumps(rec))
    return rec


CTR_TRAIN_BATCH = 4096    # benchmark/ctr_trace_r2.json's batch


def phase_ctr_deepfm(K, deepfm, card):
    """``DeepFMConfig()`` with nothing cut (26 slots, embed 8, 13 dense,
    DNN (64, 32), 100,000 ids per slot, Adagrad 0.05 on the host tables),
    batch 4096 of ``synthetic_ctr_batch`` (4 batches cycled over 20 steps):
    ``train_step`` with sync and async pushes and ``train_stream(prefetch=
    2)``, each with the fp32 and the fp16 wire, from a fresh trainer; the
    loss falls and no registered kernel launches. examples/s per run, and
    the host split of a synchronous step (pull, copy to the card, step,
    fetch, push), each part ended by a synchronize, the median over 8 more
    steps on known ids; the device step's time in a CUDA graph over that
    split's total is the busy share."""
    import numpy as np
    cfg = deepfm.DeepFMConfig()
    B, steps = CTR_TRAIN_BATCH, 20
    batches = [deepfm.synthetic_ctr_batch(cfg, B, seed=s) for s in range(4)]
    stream = [batches[i % 4] for i in range(steps)]
    rec = dict(batch=B, steps=steps, card=card)
    for wire in ("float32", "float16"):
        for mode in ("sync_push", "async_push", "stream"):
            tr = deepfm.CTRTrainer(cfg, seed=0, sync_push=mode == "sync_push",
                                   wire_dtype=wire)
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            if mode == "stream":
                losses = list(tr.train_stream(iter(stream), lr=0.05,
                                              prefetch=2))
            else:
                losses = [tr.train_step(*b, lr=0.05)[0] for b in stream]
                tr.finalize()
            dt = time.perf_counter() - t0
            counts = K.launch_counts()
            check(not any(counts.values()), f"ctr {wire} {mode}: registered "
                                            f"kernel launches {counts}")
            check(len(losses) == steps
                  and all(math.isfinite(x) for x in losses)
                  and np.mean(losses[-4:]) < np.mean(losses[:4]),
                  f"ctr {wire} {mode}: losses {losses}")
            rec[f"{wire}/{mode}"] = dict(
                examples_per_s=B * steps / dt, ms_per_step=dt * 1e3 / steps,
                losses=losses, table_rows=tr.table.size)
            log(f"ctr-deepfm {wire} {mode}: {B * steps / dt:.1f} examples/s, "
                f"{dt * 1e3 / steps:.3f} ms a step, loss {losses[0]:.4f} -> "
                f"{losses[-1]:.4f} [{card}]")

    # the host split of a synchronous fp32 step, from a fresh trainer: the
    # median over steps 4-11, whose ids the tables hold already (steps 0-3
    # first materialize theirs)
    tr = deepfm.CTRTrainer(cfg, seed=0, sync_push=True)
    split = {k: [] for k in ("pull", "copy", "step", "fetch", "push")}

    def timed(part, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[part].append((time.perf_counter() - t0) * 1e3)
        return out

    for i in range(12):
        ids, dense, labels = batches[i % 4]
        emb, first = timed("pull", lambda: tr._pull(ids))
        dev = tr.device
        on = timed("copy", lambda: (
            emb.to(dev), first.to(dev),
            torch.as_tensor(dense, device=dev),
            torch.as_tensor(labels, device=dev)))
        loss, _, tr.params, gemb, gfirst = timed(
            "step", lambda: deepfm._train_step(cfg, tr.params, *on, 0.05))
        gemb, gfirst = timed("fetch", lambda: tr._fetch(gemb, gfirst))
        timed("push", lambda: tr._push(ids, gemb, gfirst, sync=True))
    split = {k: statistics.median(v[4:]) for k, v in split.items()}
    total = sum(split.values())
    batch0 = [t.to("cuda") for t in tr._pull(batches[0][0])] + [
        torch.as_tensor(batches[0][1], device="cuda"),
        torch.as_tensor(batches[0][2], device="cuda")]
    step_dev_ms = device_ms(lambda: deepfm._train_step(
        cfg, {k: v.clone() for k, v in tr.params.items()}, *batch0, 0.0), 1)
    rec["host_split_ms"] = split
    rec["host_split_total_ms"] = total
    rec["step_device_ms"] = step_dev_ms
    rec["device_busy_share"] = step_dev_ms / total
    log("ctr-deepfm host split of a synchronous fp32 step (median ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; total {total:.3f}, device {step_dev_ms:.3f} (busy "
          f"{step_dev_ms / total:.4f}) [{card}]")
    log("ctr_deepfm " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phases 19-22: the Fluid book CNNs through the static path (train-book-
# digits, train-book-vgg, book-correctness) and the optimizer rules without
# a kernel (optimizer-rules)
# ---------------------------------------------------------------------------
DIGITS_BATCH, VGG_BATCH, BOOK_STEPS = 64, 128, 50
#: the recommender's two towers at MovieLens-1M's id counts (users, movies)
ML_USERS, ML_MOVIES, ML_EMBED, ML_BATCH = 6040, 3952, 32, 256
#: the rate of the book models' Adam; the correctness runs take epsilon
#: 1e-4 (see phase_book_checks)
BOOK_LR = 1e-3
#: phase 21's limits on the card against the CPU, set before the first card
#: run from the port on the CPU against itself with oneDNN's convolutions
#: off (another summation order; tools/book_order_probe.py order):
#: conv_net's first-step gradients agree to 1.4e-6 and its 3-step
#: parameters to 5.6e-6; vgg16_bn_drop's 13 conv+ReLU layers carry a
#: summation order's rounding to 1.2e-2 (batch 16) and 3.6e-2 (batch 64) of
#: a gradient's norm at the first step, and a loss 0.068 apart after 3 Adam
#: steps, so its trajectory is bounded, not held; its forward is held
#: (1.7e-5 in the probe). The recommender has no conv
BOOK_TOL = {
    "conv_net": {"loss_gap": 1e-4, "grad_relnorm_err": 1e-4,
                 "param_gap": 1e-4, "bn_stat_gap": 1e-5},
    "vgg16_bn_drop": {"loss_gap_step1": 1e-4, "grad_relnorm_err": 0.2,
                      "loss_gap": 0.5},
    "recommender": {"loss_gap": 1e-4, "grad_relnorm_err": 1e-4,
                    "param_gap": 1e-4},
}
#: phase 22's card-against-CPU limit on the parameters after 3 updates
#: (values near 0.1): the elementwise rules round alike up to an ulp of
#: pow and the clip's norm (CPU tests: 1e-6 against JAX)
RULE_TOL = {"default": 1e-5}


def build_conv_net(pt, opt):
    """The reference's recognize_digits ``conv_net`` (Fluid 1.5,
    tests/book/test_recognize_digits.py), nothing cut: 1x28x28 images,
    simple_img_conv_pool(20 filters, 5x5, pool 2/2, relu), batch_norm,
    simple_img_conv_pool(50, 5x5, 2/2, relu), fc(10, softmax), cross
    entropy, mean. Returns (main, startup, pred, loss, the for_test clone
    made before minimize)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        img = pt.data("img", [1, 28, 28])
        label = pt.data("label", [1], "int64")
        x = pt.nets.simple_img_conv_pool(img, num_filters=20, filter_size=5,
                                         pool_size=2, pool_stride=2,
                                         act="relu")
        x = pt.layers.batch_norm(x)
        x = pt.nets.simple_img_conv_pool(x, num_filters=50, filter_size=5,
                                         pool_size=2, pool_stride=2,
                                         act="relu")
        pred = pt.layers.fc(x, 10, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
        test = main.clone(for_test=True)
        opt.minimize(loss)
    return main, startup, pred, loss, test


#: vgg16_bn_drop's five groups: (width, convs, drop rate of each conv)
VGG_GROUPS = ((64, 2, (0.3, 0.0)), (128, 2, (0.4, 0.0)),
              (256, 3, (0.4, 0.4, 0.0)), (512, 3, (0.4, 0.4, 0.0)),
              (512, 3, (0.4, 0.4, 0.0)))


def build_vgg16_bn_drop(pt, opt, drop=1.0):
    """The reference's image_classification ``vgg16_bn_drop`` (Fluid 1.5,
    tests/book/test_image_classification.py), nothing cut: 3x32x32 images,
    five img_conv_groups (64x2, 128x2, 256x3, 512x3, 512x3) of 3x3 convs
    with batch norm and relu, the reference's drop rates (0 on each group's
    last conv) and pool 2/2; dropout 0.5, fc 512, batch_norm relu, dropout
    0.5, fc 512, fc 10 softmax. ``drop`` scales every rate (0 for the
    correctness phase: the ops stay, at rate 0). Returns what
    ``build_conv_net`` returns."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        img = pt.data("img", [3, 32, 32])
        label = pt.data("label", [1], "int64")
        x = img
        for width, convs, rates in VGG_GROUPS:
            x = pt.nets.img_conv_group(
                x, conv_num_filter=[width] * convs, pool_size=2,
                pool_stride=2, conv_filter_size=3, conv_act="relu",
                conv_with_batchnorm=True,
                conv_batchnorm_drop_rate=[r * drop for r in rates],
                pool_type="max")
        x = pt.layers.dropout(x, dropout_prob=0.5 * drop)
        x = pt.layers.fc(x, 512)
        x = pt.layers.batch_norm(x, act="relu")
        x = pt.layers.dropout(x, dropout_prob=0.5 * drop)
        x = pt.layers.fc(x, 512)
        pred = pt.layers.fc(x, 10, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(pred, label))
        test = main.clone(for_test=True)
        opt.minimize(loss)
    return main, startup, pred, loss, test


def build_recommender(pt, opt):
    """tests/test_book.py's two-tower recommender_system at MovieLens-1M's
    id counts: user and movie embeddings of 32, an fc of 32 on each, cosine
    similarity scaled by 5, square error against the score. (The
    reference's full model needs sequence_conv_pool: ROADMAP queue 1 item
    5+4, step 4.)"""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        uid = pt.data("uid", [1], "int64")
        mid = pt.data("mid", [1], "int64")
        score = pt.data("score", [1])
        u = pt.layers.reshape(pt.layers.embedding(uid, [ML_USERS, ML_EMBED]),
                              [-1, ML_EMBED])
        m = pt.layers.reshape(pt.layers.embedding(mid, [ML_MOVIES,
                                                        ML_EMBED]),
                              [-1, ML_EMBED])
        sim = pt.layers.cos_sim(pt.layers.fc(u, ML_EMBED),
                                pt.layers.fc(m, ML_EMBED))
        pred = pt.layers.scale(sim, scale=5.0)
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, score))
        test = main.clone(for_test=True)
        opt.minimize(loss)
    return main, startup, pred, loss, test


def book_batches(shape, batch, n, seed):
    """``n`` feeds of ``batch`` images of ``shape`` in [0, 1], each half a
    class template (one per label, from the seed) and half noise, with
    their int64 labels: data in the datasets' shapes that a model can
    learn."""
    import numpy as np
    rng = np.random.RandomState(seed)
    templates = rng.rand(10, *shape).astype(np.float32)
    out = []
    for _ in range(n):
        label = rng.randint(0, 10, (batch, 1))
        img = 0.5 * templates[label[:, 0]] + 0.5 * rng.rand(batch, *shape)
        out.append({"img": img.astype(np.float32),
                    "label": label.astype(np.int64)})
    return out


def ml_batches(batch, n, seed):
    """``n`` feeds of (user, movie, score): scores in [0, 5] from a fixed
    low-rank table, so the two towers can fit them."""
    import numpy as np
    rng = np.random.RandomState(seed)
    pu = rng.rand(ML_USERS, 4).astype(np.float32)
    pm = rng.rand(ML_MOVIES, 4).astype(np.float32)
    out = []
    for _ in range(n):
        uid = rng.randint(0, ML_USERS, (batch, 1))
        mid = rng.randint(0, ML_MOVIES, (batch, 1))
        s = (pu[uid[:, 0]] * pm[mid[:, 0]]).sum(1, keepdims=True) * 1.25
        out.append({"uid": uid.astype(np.int64), "mid": mid.astype(np.int64),
                    "score": s.astype(np.float32)})
    return out


def trainable(program):
    return [p.name for p in program.all_parameters() if p.trainable]


def phase_train_book(K, pt, card, label, built, feeds, batch, fmm_per_step):
    """``BOOK_STEPS`` steps of a book model through ``Executor.run`` on the
    card (each fetching the loss as numpy, as a fluid script does), the
    launch counts set to 0 just before and read just after: exactly
    ``fmm_per_step`` fused matmuls (the fcs) and one ``fused_adam`` per
    parameter per step, nothing else registered; the loss falls. Records
    ms per step (steady: the median of steps 5 on), images/s, the peak
    memory above what was allocated before the startup program ran (the
    model's weights and slots included), and one more profiled step's
    device time by op group over the step latency (the busy share).
    Returns (record, (the built program, executor, scope))."""
    main, startup, pred, loss, test = built
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    n_params = len(trainable(main))
    want = {"fused_matmul": fmm_per_step, "fused_adam": n_params}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(BOOK_STEPS):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed=feeds[i % len(feeds)],
                                    fetch_list=[loss], scope=scope)[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = K.launch_counts()
    # this model's own peak: earlier phases may still hold memory
    peak = torch.cuda.max_memory_allocated() - base
    for name, n in counts.items():
        check(n == want.get(name, 0) * BOOK_STEPS,
              f"{label}: {n} {name} launches in {BOOK_STEPS} steps, "
              f"expected {want.get(name, 0)} per step")
    check(all(math.isfinite(x) for x in losses), f"{label}: {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"{label}: loss {first} over the first 5 steps, "
                        f"{last} over the last 5")
    steady = statistics.median(step_ms[5:])
    prof = op_breakdown(lambda: exe.run(main, feed=feeds[0],
                                        fetch_list=[loss], scope=scope),
                        top=10, host_top=8)
    rec = dict(batch=batch, steps=BOOK_STEPS, params=n_params,
               optimizer=f"Adam {BOOK_LR}", losses_first5_last5=[first, last],
               loss_first=losses[0], loss_last=losses[-1],
               ms_per_step_steady=steady,
               ms_per_step_quartiles=statistics.quantiles(step_ms[5:], n=4),
               first_step_ms=step_ms[0], images_per_s=batch / steady * 1e3,
               launches_per_step={k: v // BOOK_STEPS
                                  for k, v in counts.items() if v},
               device_events_per_step=prof.get("launches"),
               device_busy_share=(prof.get("kernel_ms", 0.0) / steady
                                  if prof else None),
               peak_gb=peak / 1e9, card=card, profile=prof,
               launches={k: v for k, v in counts.items() if v})
    log(f"{label}: {BOOK_STEPS} steps at batch {batch}, loss {losses[0]:.4f}"
        f" -> {losses[-1]:.4f}, {steady:.3f} ms/step, "
        f"{batch / steady * 1e3:.1f} images/s, peak {peak / 1e9:.3f} GB "
        f"[{card}]")
    log(label.replace("-", "_") + " " + json.dumps(rec))
    return rec, (built, exe, scope)


def card_vs_cpu(K, pt, label, built, feeds, steps=3):
    """``steps`` steps of one program on the card and on the CPU from the
    startup weights drawn on the card: the first step's gradients (the
    largest relative norm error over the parameters whose gradient norm is
    at least 1e-4 of the largest: a bias that feeds a batch norm has a
    gradient of rounding noise alone), the losses, the largest parameter
    and batch-norm-stat gaps after the last step, and the card's
    launches."""
    import numpy as np
    main, startup, pred, loss, test = built
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    snap = {n: scope.find_var(n).cpu().numpy().copy()
            for n, v in startup.global_block().vars.items() if v.persistable}
    params = trainable(main)
    out = {}
    for dev in ("cuda", "cpu"):
        s = pt.Scope.from_numpy(snap, dev, startup)
        e = pt.Executor(pt.CPUPlace() if dev == "cpu" else None)
        K.reset_launch_counts()
        first = e.run(main, feed=feeds[0], scope=s,
                      fetch_list=[loss] + [n + "@GRAD" for n in params])
        ls = [float(first[0])] + [
            float(e.run(main, feed=feeds[i % len(feeds)], fetch_list=[loss],
                        scope=s)[0]) for i in range(1, steps)]
        out[dev] = (ls, first[1:], {n: s.find_var(n).cpu() for n in snap},
                    K.launch_counts(), s)
    (cl, cg, cp, counts, card_scope), (pl, pg, pp, _, _) = \
        out["cuda"], out["cpu"]
    norms = [float(np.linalg.norm(g)) for g in pg]
    errs = {n: float(np.linalg.norm(a - b)) / nb for n, a, b, nb in
            zip(params, cg, pg, norms) if nb >= 1e-4 * max(norms)}
    stats = [n for n in snap if n.startswith(("bn_mean", "bn_variance"))]
    rec = dict(
        losses_card=cl, losses_cpu=pl, loss_gap_step1=abs(cl[0] - pl[0]),
        loss_gap=max(abs(a - b) for a, b in zip(cl, pl)),
        grad_relnorm_err=max(errs.values()),
        grad_relnorm_err_worst=max(errs, key=errs.get),
        grads_held=len(errs), grads_noise=len(params) - len(errs),
        param_gap=max(max_err(cp[n], pp[n]) for n in params),
        param_gap_rel=max(max_err(cp[n], pp[n])
                          / max(pp[n].abs().max().item(), 1e-30)
                          for n in params),
        launches={k: v for k, v in counts.items() if v})
    if stats:
        rec["bn_stat_gap"] = max(max_err(cp[n], pp[n]) for n in stats)
        rec["bn_stats_card_first4"] = {n: cp[n][:4].tolist()
                                       for n in stats[:2]}
    log(f"book-correctness {label}: " + json.dumps(rec))
    return rec, (built, card_scope, out["cpu"][4])


def phase_book_checks(K, pt, ops, card):
    """recognize_digits' conv_net (batch 64), vgg16_bn_drop (batch 16, every
    drop rate 0) and the recommender (batch 256): 3 Adam steps each on the
    card against the CPU from the same weights, TF32 off and cuDNN's
    deterministic algorithms pinned (the default backward algorithms sum in
    an order that changes from run to run, ROADMAP queue 3 F8); then
    dropout on the card, and the for_test clone against a
    save/load_inference_model round trip."""
    import tempfile
    import numpy as np
    # a bias that feeds a batch norm has a gradient that is 0 but for
    # rounding; at epsilon 1e-8 Adam's first step moves it by up to the
    # rate, differently on the card and on the CPU (tests/test_torch_book.py
    # BOOK, tools/book_order_probe.py bias-noise): the CNNs' comparisons
    # take epsilon 1e-4
    opt = lambda eps=1e-4: pt.optimizer.Adam(BOOK_LR, epsilon=eps)  # noqa
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        digits, (dig_built, dig_scope, _) = card_vs_cpu(
            K, pt, "conv_net", build_conv_net(pt, opt()),
            book_batches((1, 28, 28), DIGITS_BATCH, 3, 11))
        vgg, _ = card_vs_cpu(
            K, pt, "vgg16_bn_drop", build_vgg16_bn_drop(pt, opt(), drop=0.0),
            book_batches((3, 32, 32), 16, 3, 12))
        rec_sys, _ = card_vs_cpu(
            K, pt, "recommender", build_recommender(pt, opt(1e-8)),
            ml_batches(ML_BATCH, 3, 13))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            old
    for name, r in (("conv_net", digits), ("vgg16_bn_drop", vgg),
                    ("recommender", rec_sys)):
        tol = BOOK_TOL[name]
        bad = {k: r.get(k, 0.0) for k in tol if r.get(k, 0.0) > tol[k]}
        check(not bad, f"book-correctness {name}: card vs CPU {bad} beyond "
                       f"{tol}")
    check(digits["launches"] == {"fused_matmul": 3, "fused_adam": 24},
          f"conv_net: card launches {digits['launches']}")
    check(vgg["launches"] == {"fused_matmul": 9, "fused_adam": 180},
          f"vgg16_bn_drop: card launches {vgg['launches']}")
    check(rec_sys["launches"] == {"embedding_gather": 6, "fused_matmul": 6,
                                  "fused_adam": 18},
          f"recommender: card launches {rec_sys['launches']}")

    # dropout on the card: the keep share within 5 sigma of the binomial,
    # kept values exactly x (downgrade_in_infer) or x / (1 - p)
    # (upscale_in_train), the same seed the same mask
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand(VGG_BATCH, 512, 4, 4, generator=gen, device="cuda") + 0.5
    drops = {}
    for p in (0.3, 0.5):
        for impl in ("downgrade_in_infer", "upscale_in_train"):
            out = ops.dropout(x, p, dropout_implementation=impl,
                              rng=torch.Generator(device="cuda").manual_seed(17))
            kept = out != 0
            share = kept.double().mean().item()
            sigma = math.sqrt(p * (1 - p) / x.numel())
            want = x / (1.0 - p) if impl == "upscale_in_train" else x
            same = ops.dropout(x, p, dropout_implementation=impl,
                               rng=torch.Generator(device="cuda").manual_seed(
                                   17))
            other = ops.dropout(x, p, dropout_implementation=impl,
                                rng=torch.Generator(device="cuda").manual_seed(
                                    18))
            check(abs(share - (1 - p)) < 5 * sigma,
                  f"dropout p={p} {impl}: keep share {share}, 5 sigma "
                  f"{5 * sigma}")
            check(torch.equal(out[kept], want[kept]),
                  f"dropout p={p} {impl}: kept values are not x or x/(1-p)")
            check(torch.equal(same, out) and not torch.equal(other, out),
                  f"dropout p={p} {impl}: the seed does not set the mask")
            drops[f"{p}/{impl}"] = dict(keep_share=share,
                                        sigmas=(share - (1 - p)) / sigma)
    # the Executor's masks: two executors on one seed draw the same, the
    # next run another
    def masks(runs):
        main, startup = pt.Program(), pt.Program()
        main.random_seed = 7
        with pt.program_guard(main, startup), pt.unique_name.guard():
            d = pt.layers.dropout(pt.data("x", [4096]), 0.5)
        e, s = pt.Executor(), pt.Scope()
        e.run(startup, scope=s)
        return [e.run(main, feed={"x": np.ones((64, 4096), np.float32)},
                      fetch_list=[d], scope=s)[0] != 0 for _ in range(runs)]
    a, b = masks(2), masks(1)
    check(np.array_equal(a[0], b[0]) and not np.array_equal(a[0], a[1]),
          "static dropout: the executors' masks do not follow the seed")

    # the for_test clone of the conv_net trained above on the card against
    # a save/load_inference_model round trip
    (main, startup, pred, loss, test) = dig_built
    e = pt.Executor()
    feed = book_batches((1, 28, 28), DIGITS_BATCH, 1, 14)[0]
    want = e.run(test, feed=feed, fetch_list=[pred], scope=dig_scope)[0]
    with tempfile.TemporaryDirectory() as d:
        with pt.scope_guard(dig_scope):
            pt.io.save_inference_model(d, ["img"], [pred], e,
                                       main_program=main)
        ls = pt.Scope()
        prog, feeds, fetches = pt.io.load_inference_model(d, e, scope=ls)
        got = e.run(prog, feed={"img": feed["img"]}, fetch_list=fetches,
                    scope=ls)[0]
    infer_gap = float(np.abs(got - want).max())
    check(infer_gap <= 1e-6, f"conv_net: the loaded inference model "
                             f"predicts {infer_gap} off the for_test clone")
    launches = {}
    for r in (digits, vgg, rec_sys):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    rec = dict(conv_net=digits, vgg16_bn_drop=vgg, recommender=rec_sys,
               tol=BOOK_TOL, dropout=drops, inference_round_trip_gap=infer_gap,
               launches=launches, card=card)
    log("book_checks " + json.dumps(rec))
    return rec


def rule_optimizers(pt):
    """The twelve rules without a kernel, each under a piecewise schedule,
    L2 decay and a global-norm clip (ModelAverage and the EMA take none)."""
    o = pt.optimizer

    def kw(lr):
        return dict(learning_rate=pt.layers.piecewise_decay(
                        [2], [lr, lr / 2]),
                    regularization=pt.regularizer.L2Decay(1e-4),
                    grad_clip=pt.clip.GradientClipByGlobalNorm(1.0))

    return {
        "LarsMomentum": lambda: o.LarsMomentum(momentum=0.9, **kw(0.1)),
        "Adagrad": lambda: o.Adagrad(epsilon=1e-6, **kw(0.01)),
        "Adamax": lambda: o.Adamax(**kw(0.002)),
        "DecayedAdagrad": lambda: o.DecayedAdagrad(**kw(0.01)),
        "Adadelta": lambda: o.Adadelta(**kw(1.0)),
        "RMSProp": lambda: o.RMSProp(**kw(0.001)),
        "RMSProp centered": lambda: o.RMSProp(centered=True, momentum=0.9,
                                              **kw(0.001)),
        "Ftrl": lambda: o.Ftrl(l1=1e-4, l2=1e-4, **kw(0.05)),
        "Ftrl lr_power -0.3": lambda: o.Ftrl(l1=1e-4, l2=1e-4, lr_power=-0.3,
                                             **kw(0.05)),
        "ProximalGD": lambda: o.ProximalGD(l1=1e-4, l2=1e-4, **kw(0.05)),
        "ProximalAdagrad": lambda: o.ProximalAdagrad(l1=1e-4, l2=1e-4,
                                                     **kw(0.05)),
        "Lamb": lambda: o.Lamb(**kw(0.002)),
        "ModelAverage": lambda: o.ModelAverage(0.15, 10000, 10000),
        "ExponentialMovingAverage": lambda: o.ExponentialMovingAverage(0.999),
    }


def rule_step(opt):
    """One update of ``opt`` as a function of (params, grads, state)."""
    name = type(opt).__name__
    if name == "ModelAverage":
        return lambda p, g, s: opt.accumulate(g, s)
    if name == "ExponentialMovingAverage":
        return lambda p, g, s: opt.update(g, s)
    return lambda p, g, s: opt.apply_gradients(p, g, s)


def rule_result(opt, params, state):
    name = type(opt).__name__
    if name == "ModelAverage":
        return opt.average(state)
    if name == "ExponentialMovingAverage":
        return opt.apply(state)
    return params


def phase_optimizer_rules(K, pt, resnet, card, vgg_shapes):
    """Each rule 3 updates on the card against the CPU over phase 20's
    parameter list (vgg16_bn_drop's 60 tensors) from the same values and
    grads (the averages take the grads as the next parameters), then, over
    that list and over ResNet-50's 267 tensors, the device time of one
    update (captured in a CUDA graph: its thousands of small launches
    overrun the launch queue behind a spin), its host time (wall clock to
    a synchronize) and its device events. No registered kernel may launch.
    Data for a later PR: nothing here is tuned."""
    from paddle_tpu_torch.core.tree import leaves

    def tree(shapes, seed, device, scale):
        g = torch.Generator().manual_seed(seed)
        return {f"t{i}": (scale * torch.randn(tuple(s), generator=g)).to(
            device) for i, s in enumerate(shapes)}

    rn50 = [tuple(s) for s in leaves(resnet.param_shapes(resnet.resnet50()))]
    check(len(rn50) == 267, f"{len(rn50)} ResNet-50 leaves")
    rec = {}
    for name, make in rule_optimizers(pt).items():
        finals = {}
        for dev in ("cuda", "cpu"):
            opt = make()
            params = tree(vgg_shapes, 0, dev, 0.1)
            grads = [tree(vgg_shapes, 1 + i, dev, 0.01) for i in range(3)]
            state = opt.init(params)
            step = rule_step(opt)
            K.reset_launch_counts()
            for g in grads:
                step(params, g, state)
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = K.launch_counts()
                check(not any(counts.values()),
                      f"optimizer-rules {name}: kernel launches {counts}")
            finals[dev] = {k: v.cpu() for k, v in
                           rule_result(opt, params, state).items()}
        gap = max(max_err(finals["cuda"][k], finals["cpu"][k])
                  for k in finals["cpu"])
        scale_ = max(finals["cpu"][k].abs().max().item()
                     for k in finals["cpu"])
        r = dict(gap=gap, gap_rel=gap / scale_)
        for label, shapes in (("vgg16_bn_drop", vgg_shapes),
                              ("resnet50", rn50)):
            opt = make()
            params = tree(shapes, 0, "cuda", 0.1)
            g = tree(shapes, 1, "cuda", 0.01)
            state = opt.init(params)
            step = rule_step(opt)
            dev = device_ms(lambda: step(params, g, state), 1)
            host = host_ms(lambda: step(params, g, state), 3)
            prof = op_breakdown(lambda: step(params, g, state), top=3)
            r[label] = dict(device_us=dev * 1e3, host_us=host * 1e3,
                            device_busy_share=dev / host,
                            device_events=prof.get("launches"),
                            top=prof.get("top"))
        check(gap <= RULE_TOL.get(name, RULE_TOL["default"]),
              f"optimizer-rules {name}: card vs CPU gap {gap}")
        rec[name] = r
        log(f"optimizer-rules {name}: gap {gap:.3g} (rel {gap / scale_:.3g});"
            + "".join(f" {k} {r[k]['device_us']:.1f} us device, "
                      f"{r[k]['host_us']:.1f} us host, "
                      f"{r[k]['device_events']} events;"
                      for k in ("vgg16_bn_drop", "resnet50"))
            + f" [{card}]")
    rec.update(tensors={"vgg16_bn_drop": len(vgg_shapes), "resnet50": 267},
               values={"vgg16_bn_drop": sum(math.prod(s) for s in vgg_shapes),
                       "resnet50": sum(math.prod(s) for s in rn50)},
               tol=RULE_TOL, card=card)
    log("optimizer_rules " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phases 23-27: the Fluid book's sequence models (train-book-sentiment,
# train-book-srl, train-book-nmt, train-book-movielens, sequence-
# correctness)
# ---------------------------------------------------------------------------
#: understand_sentiment's convolution_net (Fluid 1.5 tests/book/
#: test_understand_sentiment.py, book ch. 06): the IMDB word_dict's 5147
#: ids, embedding 32, sequence_conv_pool of 32 filters at 3 and 4 (tanh,
#: sqrt pool), fc 2 softmax; batch 128, Adagrad 0.002; review lengths
#: uniform over 16-512 tokens (synthetic), padded to the batch's longest
SENT = dict(vocab=5147, emb=32, hid=32, batch=128, lens=(16, 512), lr=0.002)
#: label_semantic_roles' db_lstm (Fluid 1.5 test_label_semantic_roles.py):
#: word dict 44068 (one frozen table ``emb`` [44068, 32] for the word and
#: its five context slots), predicates 3162 x32, marks 2 x5, labels 59,
#: hidden_dim 512 (each dynamic_lstm at 128 with a [7*128] peephole bias),
#: depth 8; batch 10, sentence lengths uniform over 8-64 (synthetic)
SRL = dict(words=44068, preds=3162, labels=59, word_dim=32, mark_dim=5,
           hidden=512, depth=8, batch=10, lens=(8, 64))
SRL_SLOTS = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
             "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data")
#: machine_translation: tests/test_book.py's GRU encoder-decoder at book
#: ch. 08's widths (the WMT-14 dictionaries' default 30000, word and hidden
#: 512); batch 64, source and target lengths uniform over 10-50
#: (synthetic), Adam 1e-3
NMT = dict(src=30000, tgt=30000, emb=512, hid=512, batch=64, lens=(10, 50),
           lr=1e-3)
#: recommender_system's full MovieLens model (Fluid 1.5
#: test_recommender_system.py): users 6041 x32, gender 2 x16, age 7 x16,
#: jobs 21 x16, movies 3953 x32, 18 categories x32 summed over 1-6 ids,
#: title words 5175 x32 through sequence_conv_pool(32, 3, tanh, sum) over
#: 1-15 words, towers of fc 200 tanh; batch 256, SGD 0.2
MLF = dict(users=6041, jobs=21, movies=3953, cats=18, titles=5175, emb=32,
           small=16, fc=200, cat_T=6, title_T=15, batch=256, lr=0.2)
#: counted steps (30; 20 for the NMT), over SEQ_BATCHES batches cycled, so
#: the first and the last five steps see the same batches
SEQ_STEPS, NMT_STEPS, SEQ_BATCHES = 30, 20, 5
#: phase 27's limits, card against the port on the CPU in fp32 with TF32
#: off, set before the first card run from the CPU tests against the JAX
#: package (gaps of 1e-7 to 2e-6 at small widths, tests/test_torch_book_
#: seq.py): losses 1e-5 of the loss (the SRL's CRF loss is ~260 at full
#: width), first-step gradients 1e-4 of their norm, parameters 1e-4 after
#: 3 steps; Viterbi paths equal; the ops and recurrences 1e-5 of their
#: largest value (1e-6 on the CPU against JAX)
SEQ_TOL = {"loss_gap_rel": 1e-5, "grad_relnorm_err": 1e-4,
           "param_gap": 1e-4}
SEQ_OP_TOL = 1e-5


def seq_lengths(rng, b, lo, hi):
    return rng.randint(lo, hi + 1, b).astype("int32")


def padded_ids(rng, ln, vocab, T=None):
    """[B, T] int64 ids below ``vocab``, 0 past each row's length; T the
    longest row by default."""
    import numpy as np
    T = T or int(ln.max())
    x = rng.randint(0, vocab, (len(ln), T))
    x[np.arange(T)[None, :] >= ln[:, None]] = 0
    return x.astype(np.int64)


def sentiment_model(pt, cfg):
    """The convolution_net in the module context, every parameter named
    (ROADMAP queue 3 note h: the JAX module context would share a bare
    name between the two sequence_conv_pool)."""
    from paddle_tpu_torch.core.lod import RaggedBatch
    A = pt.ParamAttr

    def model(words, lengths, label):
        emb = pt.layers.embedding(words, [cfg["vocab"], cfg["emb"]],
                                  param_attr=A(name="emb"))
        convs = [pt.nets.sequence_conv_pool(
            RaggedBatch(emb, lengths), cfg["hid"], k, act="tanh",
            pool_type="sqrt", param_attr=A(name=f"conv{k}_w"),
            bias_attr=A(name=f"conv{k}_b")) for k in (3, 4)]
        pred = pt.layers.fc(convs, 2, act="softmax",
                            param_attr=[A(name="fc3_w"), A(name="fc4_w")],
                            bias_attr=A(name="fc_b"))
        return pt.layers.mean(pt.layers.cross_entropy(pred, label))
    return pt.nn.transform(model)


def sentiment_batches(cfg, n, seed, b=None):
    """(words, lengths, label) of ``b`` reviews, the label drawn at random
    and written into the words: a positive review has token 1 at every
    eighth position (learnable)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    b = b or cfg["batch"]
    out = []
    for _ in range(n):
        ln = seq_lengths(rng, b, *cfg["lens"])
        words = padded_ids(rng, ln, cfg["vocab"])
        label = rng.randint(0, 2, b)
        words[label == 1, ::8] = 1
        words[np.arange(words.shape[1])[None, :] >= ln[:, None]] = 0
        out.append((words, ln, label.astype(np.int64)[:, None]))
    return out


def movielens_model(pt, cfg):
    """The full recommender in the module context: the user tower (id,
    gender, age and job embeddings, an fc each, concat, fc 200 tanh), the
    movie tower (id embedding and fc, categories summed, title through
    sequence_conv_pool, concat, fc 200 tanh), cos_sim scaled by 5, square
    error, mean."""
    from paddle_tpu_torch.core.lod import RaggedBatch
    A, L = pt.ParamAttr, pt.layers
    e, s = cfg["emb"], cfg["small"]

    def emb_fc(ids, rows, width, name):
        x = L.embedding(ids, [rows, width], param_attr=A(name=f"{name}_table"))
        return L.fc(x, width, param_attr=A(name=f"{name}_fc_w"),
                    bias_attr=A(name=f"{name}_fc_b"))

    def model(uid, gender, age, job, mid, cat, cat_len, title, title_len,
              score):
        usr = L.concat([emb_fc(uid, cfg["users"], e, "user"),
                        emb_fc(gender, 2, s, "gender"),
                        emb_fc(age, 7, s, "age"),
                        emb_fc(job, cfg["jobs"], s, "job")], axis=1)
        usr = L.fc(usr, cfg["fc"], act="tanh", param_attr=A(name="usr_w"),
                   bias_attr=A(name="usr_b"))
        cat_emb = L.embedding(cat, [cfg["cats"], e],
                              param_attr=A(name="category_table"))
        cat_vec = L.sequence_pool(RaggedBatch(cat_emb, cat_len), "sum")
        title_emb = L.embedding(title, [cfg["titles"], e],
                                param_attr=A(name="title_table"))
        title_vec = pt.nets.sequence_conv_pool(
            RaggedBatch(title_emb, title_len), e, 3, act="tanh",
            pool_type="sum", param_attr=A(name="title_conv_w"),
            bias_attr=A(name="title_conv_b"))
        mov = L.concat([emb_fc(mid, cfg["movies"], e, "movie"), cat_vec,
                        title_vec], axis=1)
        mov = L.fc(mov, cfg["fc"], act="tanh", param_attr=A(name="mov_w"),
                   bias_attr=A(name="mov_b"))
        pred = L.scale(L.cos_sim(usr, mov), scale=5.0)
        return L.mean(L.square_error_cost(pred, score))
    return pt.nn.transform(model)


def movielens_batches(cfg, n, seed, b=None):
    """Feeds in MovieLens-1M's id ranges; scores in [0, 5] from a fixed
    low-rank table (learnable); categories and titles ragged, padded to
    6 and 15."""
    import numpy as np
    rng = np.random.RandomState(seed)
    b = b or cfg["batch"]
    pu, pm = rng.rand(cfg["users"], 4), rng.rand(cfg["movies"], 4)
    out = []
    for _ in range(n):
        uid = rng.randint(1, cfg["users"], (b, 1))
        mid = rng.randint(1, cfg["movies"], (b, 1))
        cat_len = seq_lengths(rng, b, 1, cfg["cat_T"])
        title_len = seq_lengths(rng, b, 1, cfg["title_T"])
        score = (pu[uid[:, 0]] * pm[mid[:, 0]]).sum(1, keepdims=True) * 1.25
        out.append((uid.astype(np.int64),
                    rng.randint(0, 2, (b, 1)).astype(np.int64),
                    rng.randint(0, 7, (b, 1)).astype(np.int64),
                    rng.randint(0, cfg["jobs"], (b, 1)).astype(np.int64),
                    mid.astype(np.int64),
                    padded_ids(rng, cat_len, cfg["cats"], cfg["cat_T"]),
                    cat_len,
                    padded_ids(rng, title_len, cfg["titles"],
                               cfg["title_T"]),
                    title_len, score.astype(np.float32)))
    return out


def db_lstm_program(pt, cfg, make_opt):
    """label_semantic_roles' db_lstm through the static path: the word and
    context slots share the frozen ``emb``, the predicate takes ``vemb``,
    the mark its own table; an fc tanh on each (num_flatten_dims 2), summed;
    ``depth`` dynamic_lstm layers (every second one reversed) joined by sums
    of two fcs; linear_chain_crf (``crfw``, learning rate 1e-3) and
    crf_decoding over it. Returns (main, startup, decode, loss, the
    for_test clone made before minimize)."""
    main, startup = pt.Program(), pt.Program()
    L, A = pt.layers, pt.ParamAttr
    H = cfg["hidden"] // 4
    with pt.program_guard(main, startup), pt.unique_name.guard():
        slots = {n: pt.data(n, [-1, -1], "int64", lod_level=1)
                 for n in SRL_SLOTS}
        target = pt.data("target", [-1, -1], "int64", lod_level=1)
        length = pt.data("length", [], "int32")
        embs = [L.embedding(slots[n], [cfg["words"], cfg["word_dim"]],
                            param_attr=A(name="emb", trainable=False))
                for n in SRL_SLOTS[:6]]
        embs.append(L.embedding(slots["verb_data"],
                                [cfg["preds"], cfg["word_dim"]],
                                param_attr="vemb"))
        embs.append(L.embedding(slots["mark_data"], [2, cfg["mark_dim"]]))
        hidden_0 = L.sums([L.fc(x, cfg["hidden"], num_flatten_dims=2,
                                act="tanh") for x in embs])

        def lstm(x, i):
            w = L.create_parameter([H, 4 * H], name=f"lstm{i}_w")
            b = L.create_parameter([7 * H], name=f"lstm{i}_b", is_bias=True)
            return L.dynamic_lstm(x, w, b, lengths=length,
                                  is_reverse=(i % 2) == 1)

        tmp = [hidden_0, lstm(hidden_0, 0)]
        for i in range(1, cfg["depth"]):
            mix = L.sums([L.fc(x, cfg["hidden"], num_flatten_dims=2,
                               act="tanh") for x in tmp])
            tmp = [mix, lstm(mix, i)]
        feature = L.sums([L.fc(x, cfg["labels"], num_flatten_dims=2,
                               act="tanh") for x in tmp])
        cost = L.linear_chain_crf(feature, target, length=length,
                                  param_attr=A(name="crfw",
                                               learning_rate=1e-3))
        decode = L.crf_decoding(feature, main.global_block().var("crfw"),
                                length=length)
        loss = L.mean(cost)
        test = main.clone(for_test=True)
        make_opt(pt).minimize(loss)
    return main, startup, decode, loss, test


def srl_sgd(pt):
    """The book's SGD at exponential_decay(0.01, 100000, 0.5,
    staircase)."""
    return pt.optimizer.SGD(pt.layers.exponential_decay(
        0.01, 100000, 0.5, staircase=True))


def srl_feeds(cfg, n, seed, b=None):
    import numpy as np
    rng = np.random.RandomState(seed)
    b = b or cfg["batch"]
    out = []
    for _ in range(n):
        ln = seq_lengths(rng, b, *cfg["lens"])
        feed = {s: padded_ids(rng, ln, cfg["words"]) for s in SRL_SLOTS[:6]}
        feed["verb_data"] = padded_ids(rng, ln, cfg["preds"])
        feed["mark_data"] = padded_ids(rng, ln, 2)
        # a tag the words and the mark decide: learnable
        feed["target"] = (feed["word_data"] * 7 + feed["mark_data"]) \
            % cfg["labels"]
        feed["length"] = ln
        out.append(feed)
    return out


def gru_nmt_shapes(cfg):
    E, H = cfg["emb"], cfg["hid"]
    return {"src_emb": (cfg["src"], E), "tgt_emb": (cfg["tgt"], E),
            "enc_wih": (E, 3 * H), "enc_whh": (H, 3 * H), "enc_b": (3 * H,),
            "dec_wih": (E, 3 * H), "dec_whh": (H, 3 * H), "dec_b": (3 * H,),
            "out_w": (H, cfg["tgt"]), "out_b": (cfg["tgt"],)}


def nmt_params(cfg, seed, device):
    """The encoder-decoder's weights from a CPU generator (N(0, 0.1), zero
    biases), on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    return {k: (torch.zeros(s) if k.endswith("_b")
                else torch.randn(*s, generator=gen) * 0.1).to(device)
            for k, s in gru_nmt_shapes(cfg).items()}


def nmt_loss(ops, p, src, src_len, tgt_in, tgt_out, tgt_len):
    """tests/test_book.py's encoder-decoder with lengths: two gathers, the
    source GRU's last state starts the target GRU, the [B*T, 512] x [512,
    30000] projection (plain, as in the JAX package) and the token cross
    entropy averaged over the valid target steps."""
    es = ops.embedding(src, p["src_emb"])
    _, h = ops.rnn.gru(es, p["enc_wih"], p["enc_whh"], p["enc_b"],
                       lengths=src_len)
    et = ops.embedding(tgt_in, p["tgt_emb"])
    outs, _ = ops.rnn.gru(et, p["dec_wih"], p["dec_whh"], p["dec_b"], h0=h,
                          lengths=tgt_len)
    logits = outs @ p["out_w"] + p["out_b"]
    xent = ops.softmax_with_cross_entropy(logits, tgt_out[..., None])
    mask = ops.sequence_mask(tgt_len, tgt_out.shape[1])
    return torch.sum(xent[..., 0] * mask) / torch.sum(mask)


def nmt_batches(cfg, n, seed, b=None):
    """(src, src_len, tgt_in, tgt_out, tgt_len): ids in the dictionaries'
    ranges, the target a function of the source (learnable), source and
    target lengths drawn on their own."""
    import numpy as np
    rng = np.random.RandomState(seed)
    b = b or cfg["batch"]
    out = []
    for _ in range(n):
        sl = seq_lengths(rng, b, *cfg["lens"])
        tl = seq_lengths(rng, b, *cfg["lens"])
        src = padded_ids(rng, sl, cfg["src"])
        T = int(tl.max())
        tgt = (np.pad(src, ((0, 0), (0, max(T - src.shape[1], 0))))[:, :T]
               * 3 + 1) % cfg["tgt"]
        tgt[np.arange(T)[None, :] >= tl[:, None]] = 0
        tgt_in = np.concatenate([np.zeros((b, 1), np.int64), tgt[:, :-1]], 1)
        out.append((src, sl, tgt_in, tgt.astype(np.int64), tl))
    return out


def tensors_on(batch, device="cuda"):
    return [torch.as_tensor(a, device=device) for a in batch]


def eager_step(loss_fn, params, opt, state):
    """One training step of a module-context or functional model: the
    loss, autograd's gradients, ``apply_gradients`` (in place)."""
    keys = list(params)

    def step(batch):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        opt.apply_gradients(params, dict(zip(keys, grads)), state)
        return loss.detach()
    return step


def seq_train(K, label, step, batches, steps, want, card, units, unit,
              extra=None):
    """``steps`` steps over ``batches`` cycled (each ending in a
    synchronize), the launch counts set to 0 just before and read just
    after: exactly ``want`` launches per step, nothing else registered;
    every loss finite and the last five steps' mean below the first five's
    (the same batches). ms per step (the median of steps 5 on), ``unit``
    per second (``units(batch)`` a step), and one more profiled step's
    device time by op group over it (the busy share). The peak memory is
    the caller's."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(batches[i % len(batches)]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = K.launch_counts()
    losses = [float(x) for x in losses]
    for name, n in counts.items():
        check(n == want.get(name, 0) * steps,
              f"{label}: {n} {name} launches in {steps} steps, expected "
              f"{want.get(name, 0)} per step")
    check(all(math.isfinite(x) for x in losses), f"{label}: {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"{label}: loss {first} over the first 5 steps, "
                        f"{last} over the last 5 (the same batches)")
    steady = statistics.median(step_ms[5:])
    per_s = statistics.mean(units(b) for b in batches) / steady * 1e3
    prof = op_breakdown(lambda: step(batches[0]), top=8, host_top=6)
    rec = dict(steps=steps, losses_first5_last5=[first, last],
               loss_first=losses[0], loss_last=losses[-1],
               ms_per_step_steady=steady,
               ms_per_step_quartiles=statistics.quantiles(step_ms[5:], n=4),
               first_step_ms=step_ms[0], **{f"{unit}_per_s": per_s},
               launches_per_step={k: v // steps for k, v in counts.items()
                                  if v},
               device_events_per_step=prof.get("launches"),
               device_busy_share=(prof.get("kernel_ms", 0.0) / steady
                                  if prof else None),
               card=card, profile=prof,
               launches={k: v for k, v in counts.items() if v})
    rec.update(extra or {})
    log(f"{label}: {steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"{steady:.3f} ms/step, {per_s:.1f} {unit}/s, busy "
        f"{rec['device_busy_share']} [{card}]")
    return rec


def peak_since(base):
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def phase_train_module_book(K, pt, card, label, model, cfg, batches_of,
                            opt, want, unit, seed):
    """A book model of the module context at ``cfg``'s widths: init on the
    card from a generator, ``SEQ_STEPS`` steps through ``nn.transform``,
    autograd and ``apply_gradients``, exactly ``want`` launches a step.
    The sentiment model (Adagrad has no kernel): 1 gather; MovieLens: 7
    gathers and 1 ``fused_sgd``."""
    from paddle_tpu_torch.ops.nn import no_tf32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    batches = [tensors_on(b) for b in batches_of(cfg, SEQ_BATCHES, seed)]
    tm = model(pt, cfg)
    with no_tf32():
        params, _ = tm.init(torch.Generator(device="cuda").manual_seed(seed),
                            *batches[0])
        params = {k: v.requires_grad_() for k, v in params.items()}
        step = eager_step(lambda p, b: tm.apply(p, {}, None, *b)[0], params,
                          opt, opt.init(params))
        rec = seq_train(
            K, label, step, batches, SEQ_STEPS, want, card,
            lambda b: b[0].shape[0], unit,
            dict(batch=cfg["batch"], params=len(params),
                 optimizer=f"{type(opt).__name__} {cfg['lr']}"))
    rec["peak_gb"] = peak_since(base)
    log(label.replace("-", "_") + " " + json.dumps(rec))
    return rec


def phase_train_book_nmt(K, pt, ops, card):
    """The GRU encoder-decoder at NMT's widths, batch 64: ``NMT_STEPS``
    Adam steps, exactly 2 gathers and 1 ``fused_adam`` a step; target
    tokens/s counts the valid target steps."""
    from paddle_tpu_torch.ops.nn import no_tf32
    cfg = NMT
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    batches = [tensors_on(b) for b in nmt_batches(cfg, SEQ_BATCHES, 25)]
    params = {k: v.requires_grad_()
              for k, v in nmt_params(cfg, 25, "cuda").items()}
    opt = pt.optimizer.Adam(cfg["lr"])
    with no_tf32():
        step = eager_step(lambda p, b: nmt_loss(ops, p, *b), params, opt,
                          opt.init(params))
        rec = seq_train(
            K, "train-book-nmt", step, batches, NMT_STEPS,
            {"embedding_gather": 2, "fused_adam": 1}, card,
            lambda b: int(b[4].sum()), "target_tokens",
            dict(batch=cfg["batch"], params=len(params),
                 values=sum(v.numel() for v in params.values()),
                 optimizer=f"Adam {cfg['lr']}",
                 target_T=[int(b[3].shape[1]) for b in batches]))
    rec["peak_gb"] = peak_since(base)
    log("train_book_nmt " + json.dumps(rec))
    return rec


def recurrence_launches(ops):
    """Device events per time step of the loops (the cost of a Python loop
    over time, which CUDA graphs later remove): dynamic_lstm at the SRL's
    hidden 128, gru at the NMT's 512, the CRF's forward and Viterbi at 59
    tags, batch 10 over 64 steps; forward alone and forward plus backward,
    from one profiled call each."""
    B, T, H, G = SRL["batch"], SRL["lens"][1], SRL["hidden"] // 4, \
        NMT["hid"]
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*s):
        return (torch.randn(*s, generator=gen, device="cuda") * 0.1
                ).requires_grad_()

    ln = torch.full((B,), T, dtype=torch.int32, device="cuda")
    x, w, b = rnd(B, T, 4 * H), rnd(H, 4 * H), rnd(7 * H)
    xg, wi, wh, bg = rnd(B, T, G), rnd(G, 3 * G), rnd(G, 3 * G), rnd(3 * G)
    em, tr = rnd(B, T, SRL["labels"]), rnd(SRL["labels"] + 2, SRL["labels"])
    lab = torch.zeros(B, T, dtype=torch.int64, device="cuda")

    def fwd_bwd(f, leaves):
        return lambda: torch.autograd.grad(f().sum(), leaves)

    calls = {
        "dynamic_lstm_fwd": lambda: ops.rnn.dynamic_lstm(
            x.detach(), w.detach(), b.detach(), lengths=ln),
        "dynamic_lstm_fwd_bwd": fwd_bwd(lambda: ops.rnn.dynamic_lstm(
            x, w, b, lengths=ln)[0], [x, w, b]),
        "gru_fwd": lambda: ops.rnn.gru(xg.detach(), wi.detach(), wh.detach(),
                                       bg.detach(), lengths=ln),
        "gru_fwd_bwd": fwd_bwd(lambda: ops.rnn.gru(
            xg, wi, wh, bg, lengths=ln)[0], [xg, wi, wh, bg]),
        "linear_chain_crf_fwd_bwd": fwd_bwd(lambda: ops.linear_chain_crf(
            em, tr, lab, ln), [em, tr]),
        "crf_decoding": lambda: ops.crf_decoding(em.detach(), tr.detach(),
                                                 ln),
    }
    out = {}
    for name, fn in calls.items():
        prof = op_breakdown(fn, top=0)
        out[name] = prof.get("launches", 0) / T
    return out


def phase_train_book_srl(K, pt, ops, card):
    """db_lstm through ``Executor.run`` at SRL's widths, batch 10:
    ``SEQ_STEPS`` SGD steps under the book's schedule, exactly 8 gathers,
    one fused matmul per fc (24 at depth 8) and one ``fused_sgd`` per
    trainable parameter a step; then ``crf_decoding`` of one batch through
    the for_test clone (latency, the paths' shape and range, 0 past each
    length), and the recurrences' device events per time step."""
    import numpy as np
    cfg = SRL
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    main, startup, decode, loss, test = db_lstm_program(pt, cfg, srl_sgd)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feeds = srl_feeds(cfg, SEQ_BATCHES, 24)
    n_params = len(trainable(main))
    n_fc = 8 + 2 * (cfg["depth"] - 1) + 2
    check("emb" not in trainable(main) and "crfw" in trainable(main),
          "db_lstm: the frozen table or the CRF's transitions")

    def step(feed):
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]

    rec = seq_train(
        K, "train-book-srl", step, feeds, SEQ_STEPS,
        {"embedding_gather": 8, "fused_matmul": n_fc,
         "fused_sgd": n_params}, card, lambda f: int(f["length"].sum()),
        "tokens", dict(batch=cfg["batch"], params=n_params, fcs=n_fc,
                       optimizer="SGD exponential_decay(0.01, 100000, 0.5,"
                                 " staircase)",
                       padded_T=[int(f["length"].max()) for f in feeds]))
    rec["peak_gb"] = peak_since(base)
    dec_ms = []
    for i in range(6):
        t0 = time.perf_counter()
        paths = exe.run(test, feed=feeds[i % len(feeds)], fetch_list=[decode],
                        scope=scope)[0]
        dec_ms.append((time.perf_counter() - t0) * 1e3)
    f = feeds[5 % len(feeds)]
    T = int(f["length"].max())
    check(paths.dtype == np.int32 and paths.shape == (cfg["batch"], T)
          and paths.min() >= 0 and paths.max() < cfg["labels"]
          and (paths[np.arange(T)[None, :] >= f["length"][:, None]] == 0
               ).all(), "train-book-srl: crf_decoding's paths")
    rec.update(decode_ms=statistics.median(dec_ms[1:]),
               decode_first_ms=dec_ms[0],
               decode_tokens_per_s=int(f["length"].sum())
               / statistics.median(dec_ms[1:]) * 1e3,
               launches_per_time_step=recurrence_launches(ops))
    log("train_book_srl " + json.dumps(rec))
    return rec, (main, startup, decode, loss, test)


def eager_card_vs_cpu(K, label, loss_fn, params_np, make_opt, batches,
                      steps=3):
    """``steps`` steps of a module-context or functional model on the card
    and on the CPU from the same weights (fp32, TF32 off): first-step
    gradients (the largest relative norm error over the parameters whose
    gradient norm is at least 1e-4 of the largest), losses, the largest
    parameter gap after the last step, and the card's launches."""
    import numpy as np
    from paddle_tpu_torch.ops.nn import no_tf32
    out = {}
    for dev in ("cuda", "cpu"):
        params = {k: torch.tensor(v, device=dev).requires_grad_()
                  for k, v in params_np.items()}
        opt = make_opt()
        state = opt.init(params)
        K.reset_launch_counts()
        losses, first = [], None
        with no_tf32():
            for i in range(steps):
                batch = tensors_on(batches[i % len(batches)], dev)
                loss = loss_fn(params, batch)
                grads = torch.autograd.grad(loss, list(params.values()))
                if first is None:
                    first = [g.detach().cpu().numpy() for g in grads]
                opt.apply_gradients(params, dict(zip(params, grads)), state)
                losses.append(float(loss.detach()))
        out[dev] = (losses, first, {k: v.detach().cpu()
                                    for k, v in params.items()},
                    K.launch_counts())
    (cl, cg, cp, counts), (pl, pg, pp, _) = out["cuda"], out["cpu"]
    names = list(params_np)
    norms = [float(np.linalg.norm(g)) for g in pg]
    errs = {n: float(np.linalg.norm(a - b)) / nb for n, a, b, nb in
            zip(names, cg, pg, norms) if nb >= 1e-4 * max(norms)}
    rec = dict(
        losses_card=cl, losses_cpu=pl,
        loss_gap_rel=max(abs(a - b) / max(abs(b), 1.0)
                         for a, b in zip(cl, pl)),
        grad_relnorm_err=max(errs.values()),
        grad_relnorm_err_worst=max(errs, key=errs.get),
        grads_held=len(errs), grads_noise=len(names) - len(errs),
        param_gap=max(max_err(cp[n], pp[n]) for n in names),
        launches={k: v for k, v in counts.items() if v})
    log(f"sequence-correctness {label}: " + json.dumps(rec))
    return rec


def seq_ops_card_vs_cpu(ops):
    """Every sequence op, the CRF (with its gradient) and each recurrent
    function (outputs and gradients) on the card against the CPU at the
    hazard cases: a zero-length row, a full one, a one-step one; the
    recurrences forward and reversed. Returns {case: the largest gap over
    the largest value}; moves and compares must be exact."""
    import numpy as np
    from paddle_tpu_torch.ops.nn import no_tf32
    rng = np.random.RandomState(27)
    B, T, Hd = 4, 9, 6
    x = rng.randn(B, T, Hd).astype(np.float32)
    ln = np.array([0, T, 1, 5], np.int32)
    ids = rng.randint(0, 7, (B, T)).astype(np.int64)
    exact = {
        "sequence_first_step": lambda d, l, i: ops.sequence_first_step((d, l)),
        "sequence_last_step": lambda d, l, i: ops.sequence_last_step((d, l)),
        "sequence_reverse": lambda d, l, i: ops.sequence_reverse((d, l)).data,
        "sequence_pad": lambda d, l, i: ops.sequence_pad((d, l), -2.0,
                                                         T + 2)[0],
        "sequence_pool max": lambda d, l, i: ops.sequence_pool((d, l),
                                                               "max"),
        "sequence_slice": lambda d, l, i: ops.sequence_slice(
            (d, l), torch.ones_like(l), torch.full_like(l, 3)).data,
        "sequence_expand": lambda d, l, i: ops.sequence_expand(
            d[:, 0], (d, l)).data,
        "sequence_concat": lambda d, l, i: ops.sequence_concat(
            [(d, l), (d[:, :4], torch.clamp(l, max=4))]).data,
        "sequence_reshape": lambda d, l, i: ops.sequence_reshape(
            (d, l), 3).data,
        "sequence_enumerate": lambda d, l, i: ops.sequence_enumerate(
            (i, l), 3, -1).data,
        "sequence_erase": lambda d, l, i: ops.sequence_erase(
            (i, l), [0, 3]).data,
        "sequence_mask": lambda d, l, i: ops.sequence_mask(l, T),
        "crf_decoding": lambda d, l, i: ops.crf_decoding(
            d, d.new_tensor(np.random.RandomState(1).randn(
                Hd + 2, Hd).astype(np.float32)), l),
    }
    summed = {
        "sequence_pool " + p: (lambda p: lambda d, l, i: ops.sequence_pool(
            (d, l), p))(p) for p in ("sum", "average", "sqrt")}
    summed.update({
        "sequence_softmax": lambda d, l, i: ops.sequence_softmax(
            (d, l)).data,
        "sequence_scatter": lambda d, l, i: ops.sequence_scatter(
            d, i[:, :3], d[:, :3]),
        "sequence_conv": lambda d, l, i: ops.sequence_conv(
            (d, l), d.new_tensor(np.random.RandomState(2).randn(
                3 * Hd, 5).astype(np.float32)), 3).data,
    })
    gaps = {}
    with no_tf32():
        dev_in = {dev: (torch.tensor(x, device=dev),
                        torch.tensor(ln, device=dev),
                        torch.tensor(ids, device=dev))
                  for dev in ("cuda", "cpu")}
        for name, fn in {**exact, **summed}.items():
            a = fn(*dev_in["cuda"]).cpu()
            b = fn(*dev_in["cpu"])
            scale = max(float(b.abs().max()), 1.0) if b.numel() else 1.0
            gaps[name] = max_err(a, b) / scale if b.numel() else 0.0
            if name in exact:
                check(torch.equal(a, b), f"sequence-correctness: {name} "
                                         f"card != CPU")

        # the recurrences and the CRF, outputs and gradients
        def leaf(*s, seed):
            return np.random.RandomState(seed).randn(*s).astype(
                np.float32) * 0.4

        H, D = 5, Hd
        cases = {
            "lstm peepholes reverse": (lambda a: ops.rnn.lstm(
                a[0], a[1], a[2], a[3], lengths=a[-1], reverse=True,
                peepholes=a[4])[0],
                [leaf(B, T, D, seed=1), leaf(D, 4 * H, seed=2),
                 leaf(H, 4 * H, seed=3), leaf(4 * H, seed=4),
                 leaf(3 * H, seed=5)]),
            "dynamic_lstm 7H": (lambda a: ops.rnn.dynamic_lstm(
                a[0], a[1], a[2], lengths=a[-1])[0],
                [leaf(B, T, 4 * H, seed=6), leaf(H, 4 * H, seed=7),
                 leaf(7 * H, seed=8)]),
            "dynamic_lstmp reverse": (lambda a: ops.rnn.dynamic_lstmp(
                a[0], a[1], a[2], a[3], lengths=a[-1], is_reverse=True)[0],
                [leaf(B, T, 4 * H, seed=9), leaf(3, 4 * H, seed=10),
                 leaf(H, 3, seed=11), leaf(4 * H, seed=12)]),
            "gru origin_mode reverse": (lambda a: ops.rnn.gru(
                a[0], a[1], a[2], a[3], h0=a[4], lengths=a[-1],
                reverse=True, origin_mode=True)[0],
                [leaf(B, T, D, seed=13), leaf(D, 3 * H, seed=14),
                 leaf(H, 3 * H, seed=15), leaf(3 * H, seed=16),
                 leaf(B, H, seed=17)]),
            "dynamic_gru": (lambda a: ops.rnn.dynamic_gru(
                a[0], a[1], a[2], lengths=a[-1])[0],
                [leaf(B, T, 3 * H, seed=18), leaf(H, 3 * H, seed=19),
                 leaf(3 * H, seed=20)]),
            "simple_rnn": (lambda a: ops.rnn.simple_rnn(
                a[0], a[1], a[2], a[3], lengths=a[-1])[0],
                [leaf(B, T, D, seed=21), leaf(D, H, seed=22),
                 leaf(H, H, seed=23), leaf(H, seed=24)]),
            "bidirectional_lstm": (lambda a: ops.rnn.bidirectional_lstm(
                *a[:-1], lengths=a[-1]),
                [leaf(B, T, D, seed=25), leaf(D, 4 * H, seed=26),
                 leaf(H, 4 * H, seed=27), leaf(D, 4 * H, seed=28),
                 leaf(H, 4 * H, seed=29), leaf(4 * H, seed=30),
                 leaf(4 * H, seed=31)]),
            "attention_lstm": (lambda a: ops.rnn.attention_lstm(
                a[0], a[1], a[2], a[3], a[4], a[5], lengths=a[-1])[0],
                [leaf(B, T, D, seed=32), leaf(B, H, seed=33),
                 leaf(D + H, 1, seed=34), leaf(D + H, 4 * H, seed=35),
                 leaf(1, seed=36), leaf(4 * H, seed=37)]),
            "linear_chain_crf": (lambda a: ops.linear_chain_crf(
                a[0], a[1], torch.as_tensor(ids % 4, device=a[0].device),
                a[-1]),
                [leaf(B, T, 4, seed=38), leaf(6, 4, seed=39)]),
        }
        for name, (fn, arrays) in cases.items():
            res = []
            for dev in ("cuda", "cpu"):
                ts = [torch.tensor(a, device=dev, requires_grad=True)
                      for a in arrays]
                out = fn(ts + [torch.tensor(ln, device=dev)])
                grads = torch.autograd.grad(torch.sin(out).sum(), ts)
                res.append([out.detach().cpu()] + [g.cpu() for g in grads])
            gaps[name] = max(max_err(a, b) / max(float(b.abs().max()), 1.0)
                             for a, b in zip(*res))
    worst = max(gaps, key=gaps.get)
    check(gaps[worst] <= SEQ_OP_TOL, f"sequence-correctness: {worst} card "
                                     f"vs CPU {gaps[worst]} > {SEQ_OP_TOL}")
    return gaps


def phase_sequence_checks(K, pt, ops, card, srl_built):
    """The four models at batch 4-8 and their full widths, 3 steps on the
    card against the port on the CPU from the same weights in fp32 with
    TF32 off (losses, first-step gradients, parameters within SEQ_TOL; the
    SRL's Viterbi paths equal after the steps); then every sequence op,
    the CRF and each recurrence at the hazard cases."""
    import numpy as np
    recs = {}
    sent_b = sentiment_batches(SENT, 2, 271, b=8)
    tm = sentiment_model(pt, SENT)
    p0, _ = tm.init(torch.Generator().manual_seed(271),
                    *tensors_on(sent_b[0], "cpu"))
    recs["sentiment"] = eager_card_vs_cpu(
        K, "sentiment", lambda p, b: tm.apply(p, {}, None, *b)[0],
        {k: v.numpy() for k, v in p0.items()},
        lambda: pt.optimizer.Adagrad(SENT["lr"]), sent_b)
    ml_b = movielens_batches(MLF, 2, 272, b=8)
    mm = movielens_model(pt, MLF)
    p0, _ = mm.init(torch.Generator().manual_seed(272),
                    *tensors_on(ml_b[0], "cpu"))
    recs["movielens"] = eager_card_vs_cpu(
        K, "movielens", lambda p, b: mm.apply(p, {}, None, *b)[0],
        {k: v.numpy() for k, v in p0.items()},
        lambda: pt.optimizer.SGD(MLF["lr"]), ml_b)
    recs["nmt"] = eager_card_vs_cpu(
        K, "nmt", lambda p, b: nmt_loss(ops, p, *b),
        {k: v.numpy() for k, v in nmt_params(NMT, 273, "cpu").items()},
        lambda: pt.optimizer.Adam(NMT["lr"]), nmt_batches(NMT, 2, 273, b=4))
    srl, (built, card_scope, cpu_scope) = card_vs_cpu(
        K, pt, "db_lstm", srl_built, srl_feeds(SRL, 2, 274, b=4))
    srl["loss_gap_rel"] = max(abs(a - b) / max(abs(b), 1.0) for a, b in
                              zip(srl["losses_card"], srl["losses_cpu"]))
    main, startup, decode, loss, test = built
    feed = srl_feeds(SRL, 1, 275, b=4)[0]
    paths = [pt.Executor(place).run(test, feed=feed, fetch_list=[decode],
                                    scope=s)[0]
             for place, s in ((None, card_scope),
                              (pt.CPUPlace(), cpu_scope))]
    srl["viterbi_equal"] = bool(np.array_equal(*paths))
    srl["viterbi_tokens"] = int(feed["length"].sum())
    check(srl["viterbi_equal"], "sequence-correctness: db_lstm's Viterbi "
                                "paths differ between the card and the CPU")
    recs["srl"] = srl
    for name, r in recs.items():
        bad = {k: r[k] for k in SEQ_TOL if r[k] > SEQ_TOL[k]}
        check(not bad, f"sequence-correctness {name}: card vs CPU {bad} "
                       f"beyond {SEQ_TOL}")
    want = {"sentiment": {"embedding_gather": 3},
            "movielens": {"embedding_gather": 21, "fused_sgd": 3},
            "nmt": {"embedding_gather": 6, "fused_adam": 3},
            "srl": {"embedding_gather": 24, "fused_matmul": 72,
                    "fused_sgd": 3 * len(trainable(main))}}
    for name, w in want.items():
        check(recs[name]["launches"] == w, f"sequence-correctness {name}: "
              f"card launches {recs[name]['launches']}, expected {w}")
    gaps = seq_ops_card_vs_cpu(ops)
    launches = {}
    for r in recs.values():
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    rec = dict(models=recs, tol=SEQ_TOL, ops_tol=SEQ_OP_TOL, op_gaps=gaps,
               launches=launches, card=card)
    log("sequence_checks " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phases 28-30: static control flow, the reader protocol and prepare: the
# PTB LSTM language model at lm_model.py's medium config
# ---------------------------------------------------------------------------
#: steps per epoch of phase 28's two epochs (the same windows each epoch)
LM_STEPS = 30
#: phase 30's limits, card against the port on the CPU in fp32 with TF32
#: off, set before the first card run as phase 27's are (the CPU tests
#: against the JAX package show gaps of 1e-7 to 1e-6 at a small width,
#: tests/test_torch_ptb.py); the loss is a sum over 35 steps (~322 at the
#: start), so its limit is relative
LM_TOL = {"loss_gap_rel": 1e-5, "grad_relnorm_err": 1e-4, "param_gap": 1e-4}
#: module 1's ops and the control-flow constructs, card against CPU: moves,
#: selections and compares exact, float results 1e-5 of their largest value
CF_OP_TOL = 1e-5


def lm_windows(ptb_lm, cfg, steps, seed):
    """``steps`` windows of a seeded Markov stream cut as the PTB reader
    cuts its corpus."""
    stream = ptb_lm.markov_stream(cfg, cfg.batch * (cfg.num_steps * steps
                                                    + 1), seed)
    w = ptb_lm.ptb_windows(stream, cfg)
    check(len(w) == steps, f"{len(w)} windows, expected {steps}")
    return w


def lm_epoch(exe, built, scope, device):
    """One epoch of the start/reset protocol: ``reader.start()``, then
    ``Executor.run`` with the state fed back (a tensor on ``device``) until
    ``EOFException``, then ``reset``. Returns (losses, ms of each step,
    the last state); each step ends in the loss's host read."""
    from paddle_tpu_torch.core import EOFException
    cfg_b, cfg_w = built["init"].shape
    state = torch.zeros(cfg_b, cfg_w, device=device)
    fetch = [built["loss"], built["final"]]
    losses, step_ms = [], []
    built["reader"].start()
    while True:
        t0 = time.perf_counter()
        try:
            loss, state = exe.run(built["main"], feed={"init": state},
                                  fetch_list=fetch, scope=scope,
                                  return_numpy=False)
        except EOFException:
            break
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    built["reader"].reset()
    return losses, step_ms, state


def phase_train_ptb_lm(K, pt, ptb_lm, card):
    """Path A at lm_model.py's medium config: ``Executor.prepare`` with the
    feeds' (shape, dtype) pairs (its time, the kernel libraries it loads,
    and no runner built after it), then two epochs of ``LM_STEPS`` steps
    through the py_reader's start/reset protocol (the batches staged in
    pinned memory by the reader's thread), each window's final state fed
    back as a card tensor. Exactly 1 gather, 1 fused matmul and 7
    fused_sgd launches a step; the mean loss of the last five steps below
    the first five's."""
    cfg = ptb_lm.medium()
    B, T, W = cfg.batch, cfg.num_steps, cfg.state_width
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    built = ptb_lm.build_train(pt, cfg)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(built["startup"], scope=scope)
    windows = lm_windows(ptb_lm, cfg, LM_STEPS, 14)
    built["reader"].decorate_tensor_provider(lambda: iter(windows))
    xn, yn = [v.name for v in built["reader"].vars]
    t0 = time.perf_counter()
    check(exe.prepare(built["main"], feed={
        xn: ((B, T), "int64"), yn: ((B, T, 1), "int64"),
        "init": ((B, W), "float32")},
        fetch_list=[built["loss"], built["final"]], scope=scope),
        "train-ptb-lm: prepare")
    prepare_ms = (time.perf_counter() - t0) * 1e3
    (runner,) = exe._runners.values()
    check(runner.kernel_libraries == ["embedding", "fused_matmul",
                                      "fused_sgd"],
          f"train-ptb-lm: prepare loaded {runner.kernel_libraries}")
    want = {"embedding_gather": 1, "fused_matmul": 1, "fused_sgd": 7}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(2):
        ls, ms, state = lm_epoch(exe, built, scope, "cuda")
        check(len(ls) == LM_STEPS, f"train-ptb-lm: {len(ls)} steps in an "
                                   f"epoch, expected {LM_STEPS}")
        losses += ls
        step_ms += ms
    counts = K.launch_counts()
    steps = len(losses)
    for name, n in counts.items():
        check(n == want.get(name, 0) * steps,
              f"train-ptb-lm: {n} {name} launches in {steps} steps, "
              f"expected {want.get(name, 0)} per step")
    check(exe.trace_count == 1, f"train-ptb-lm: {exe.trace_count} runners "
                                "built; prepare's should serve every step")
    check(all(math.isfinite(x) for x in losses), f"train-ptb-lm: {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"train-ptb-lm: loss {first} over the first 5 "
                        f"steps, {last} over the last 5")
    steady = statistics.median(step_ms[5:])
    x, y = windows[0]

    def one_step():
        exe.run(built["main"], feed={xn: x, yn: y, "init": state},
                fetch_list=[built["loss"]], scope=scope, return_numpy=False)

    prof = op_breakdown(one_step, top=8, host_top=8)
    est = pt.static.memory_usage(built["main"], batch_size=B)
    rec = dict(
        config="lm_model.py medium", vocab=cfg.vocab, hidden=cfg.hidden,
        layers=cfg.layers, num_steps=T, batch=B, dropout=cfg.dropout,
        optimizer="SGD 1.0, GradientClipByGlobalNorm(5.0)",
        params=sum(math.prod(scope.find_var(n).shape)
                   for n in ptb_lm.param_names(cfg)),
        prepare_ms=prepare_ms, kernel_libraries=runner.kernel_libraries,
        steps=steps, first_step_ms=step_ms[0], ms_per_step_steady=steady,
        ms_per_step_quartiles=statistics.quantiles(step_ms[5:], n=4),
        tokens_per_s=B * T / steady * 1e3,
        loss_per_token_first5_last5=[first / T, last / T],
        loss_first=losses[0], loss_last=losses[-1],
        launches_per_step={k: v // steps for k, v in counts.items() if v},
        device_events_per_step=prof.get("launches"),
        device_events_per_time_step=(prof.get("launches") or 0) / T,
        device_busy_share=prof.get("kernel_ms", 0.0) / steady,
        peak_gb=peak_since(base),
        memory_usage_estimate_gb=[est[0] / 1e9, est[1] / 1e9],
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        card=card, profile=prof,
        launches={k: v for k, v in counts.items() if v})
    log(f"train-ptb-lm: {steps} steps, loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}, first step {step_ms[0]:.1f} ms, steady "
        f"{steady:.3f} ms/step, {rec['tokens_per_s']:.0f} tokens/s [{card}]")
    log("train_ptb_lm " + json.dumps(rec))
    return rec, (built, scope, state, windows)


def phase_generate_ptb_lm(K, pt, ptb_lm, card, trained):
    """Path B over phase 28's trained scope: greedy generation of 35 tokens
    for the 20 streams through ``layers.while_loop``, from the last
    window's final state; one host read per iteration (the predicate) and
    one more, and no registered kernel."""
    from paddle_tpu_torch.ops import control_flow as cf
    cfg = ptb_lm.medium()
    built, scope, state, windows = trained
    n = cfg.num_steps
    gen = ptb_lm.build_generate(pt, cfg, n)
    exe = pt.Executor()
    x_last = windows[-1][0]
    feed = {"gen_state": state, "gen_tok": x_last[:, -1], "gen_buf": x_last}

    def run():
        return exe.run(gen["main"], feed=feed, fetch_list=[gen["out"]],
                       scope=scope)[0]

    run()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    cf.reset_host_reads()
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = run()
        ms.append((time.perf_counter() - t0) * 1e3)
    reads = cf.host_reads() / 5
    counts = {k: v for k, v in K.launch_counts().items() if v}
    check(not counts, f"generate-ptb-lm: registered kernels launched: "
                      f"{counts}")
    check(reads == n + 1, f"generate-ptb-lm: {reads} host reads per "
                          f"generation, expected {n + 1}")
    check(out.shape == (cfg.batch, n) and out.min() >= 0
          and out.max() < cfg.vocab, f"generate-ptb-lm: window {out.shape}")
    prof = op_breakdown(run, top=6, host_top=6)
    lat = statistics.median(ms)
    rec = dict(streams=cfg.batch, tokens=n, latency_ms=lat, latency_ms_all=ms,
               tokens_per_s=cfg.batch * n / lat * 1e3,
               host_reads_per_generation=reads,
               device_events_per_iteration=(prof.get("launches") or 0) / n,
               device_busy_share=prof.get("kernel_ms", 0.0) / lat,
               card=card, profile=prof)
    log(f"generate-ptb-lm: {cfg.batch}x{n} tokens in {lat:.2f} ms, "
        f"{rec['tokens_per_s']:.0f} tokens/s, {reads:.0f} host reads [{card}]")
    log("generate_ptb_lm " + json.dumps(rec))
    return rec, out


def lm_card_vs_cpu(K, pt, ptb_lm, steps=3, devices=("cuda", "cpu")):
    """The LM at medium's widths and batch 4 (dropout 0), ``steps`` steps
    on the card and on the port on the CPU from the same weights through
    the reader, fp32 with TF32 off: losses, the first step's gradients
    (the largest relative norm error), the parameters after."""
    import dataclasses
    import numpy as np
    cfg = dataclasses.replace(ptb_lm.medium(), batch=4, dropout=0.0)
    windows = lm_windows(ptb_lm, cfg, steps, 30)
    names = ptb_lm.param_names(cfg)
    grads = [n + "@GRAD" for n in names]
    snap, out = None, {}
    for key, dev in zip(("card", "cpu"), devices):
        built = ptb_lm.build_train(pt, cfg)
        exe = pt.Executor(pt.CPUPlace() if dev == "cpu" else None)
        if snap is None:
            scope = pt.Scope()
            exe.run(built["startup"], scope=scope)
            snap = {n: scope.find_var(n).cpu().numpy().copy()
                    for n, v in built["startup"].global_block().vars.items()
                    if v.persistable}
        scope = pt.Scope.from_numpy(snap, dev, built["startup"])
        built["reader"].decorate_tensor_provider(
            lambda: iter(windows), places=pt.CPUPlace() if dev == "cpu"
            else None)
        built["reader"].start()
        state = torch.zeros(cfg.batch, cfg.state_width, device=dev)
        K.reset_launch_counts()
        losses, first = [], None
        for i in range(steps):
            res = exe.run(built["main"], feed={"init": state},
                          fetch_list=[built["loss"], built["final"]]
                          + (grads if i == 0 else []), scope=scope,
                          return_numpy=False)
            losses.append(float(res[0]))
            state = res[1]
            first = first or [g.cpu().numpy().copy() for g in res[2:]]
        built["reader"].reset()
        out[key] = (losses, first, {n: scope.find_var(n).cpu()
                                    for n in names}, K.launch_counts())
    (cl, cg, cp, counts), (pl, pg, pp, _) = out["card"], out["cpu"]
    errs = {n: float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
            for n, a, b in zip(names, cg, pg)}
    rec = dict(
        batch=cfg.batch, losses_card=cl, losses_cpu=pl,
        loss_gap_rel=max(abs(a - b) / max(abs(b), 1.0)
                         for a, b in zip(cl, pl)),
        grad_relnorm_err=max(errs.values()),
        grad_relnorm_err_worst=max(errs, key=errs.get),
        param_gap=max(max_err(cp[n], pp[n]) for n in names),
        launches={k: v for k, v in counts.items() if v})
    for k, lim in LM_TOL.items():
        check(rec[k] <= lim, f"control-flow-correctness LM: {k} {rec[k]} "
                             f"above {lim}: {rec}")
    check(rec["launches"] == {"embedding_gather": steps,
                              "fused_matmul": steps,
                              "fused_sgd": 7 * steps},
          f"control-flow-correctness LM: launches {rec['launches']}")
    log("control-flow-correctness LM: " + json.dumps(rec))
    return rec


def lm_generation_card_vs_cpu(pt, ptb_lm, trained, card_out):
    """Phase 29's generation from phase 28's trained weights, run again by
    the port on the CPU: the windows must be equal token for token."""
    import numpy as np
    cfg = ptb_lm.medium()
    built, scope, state, windows = trained
    cpu = pt.Scope()
    for n in ptb_lm.param_names(cfg):
        cpu.set_var(n, scope.find_var(n).cpu())
    gen = ptb_lm.build_generate(pt, cfg, cfg.num_steps)
    x_last = windows[-1][0]
    got = pt.Executor(pt.CPUPlace()).run(
        gen["main"], feed={"gen_state": state.cpu(),
                           "gen_tok": x_last[:, -1], "gen_buf": x_last},
        fetch_list=[gen["out"]], scope=cpu)[0]
    differ = int((got != card_out).sum())
    check(differ == 0, f"control-flow-correctness: the CPU's generated "
                       f"windows differ from the card's at {differ} tokens: "
                       f"first at {np.argwhere(got != card_out)[:1]}")
    return dict(generated_tokens=int(got.size), differ=differ)


def cf_cases(pt, ops):
    """Module 1's ops, the eager and static control-flow constructs and the
    tensor arrays as (name, fn(device) -> tensors) cases at tied lengths
    (numpy's sort orders), zero-trip loops and rows of length 0."""
    import numpy as np
    from paddle_tpu_torch.core.lod import RaggedBatch
    from paddle_tpu_torch.ops import control_flow as cf
    from paddle_tpu_torch.ops import tensor_array as ta
    rng = np.random.RandomState(30)
    xf = rng.randn(64, 33).astype("float32")
    xp = (np.abs(xf) + 0.1).astype("float32")
    xu = rng.uniform(-0.99, 0.99, (64, 33)).astype("float32")
    yf = rng.randn(64, 33).astype("float32")
    xi = rng.randint(-5, 6, (64, 33)).astype("int32")
    ties = rng.randint(0, 4, (16, 9)).astype("float32")
    xb, yb = xf > 0, yf > 0
    lens = np.array([3, 0, 5, 5, 2, 3], "int32")
    seq = rng.randn(6, 5, 4).astype("float32")

    def T(a, dev):
        return torch.tensor(a, device=dev)

    cases = []
    for n in ops.activation.__all__:
        if n == "prelu":
            cases.append((n, lambda d: ops.prelu(T(xf, d), T(xf[0], d),
                                                 mode="element")))
        elif n == "maxout":
            cases.append((n, lambda d: ops.maxout(T(xf[:, :32], d).reshape(
                8, 8, 4, 8), 2)))
        else:
            cases.append((n, lambda d, n=n: getattr(ops, n)(T(xf, d))))
    unary_pos = {"log", "sqrt", "rsqrt", "reciprocal"}
    unary = {"abs", "ceil", "floor", "round", "exp", "square", "sign", "cos",
             "sin", "atan", "isfinite", "increment"} | unary_pos
    for n in sorted(unary):
        src = xp if n in unary_pos else xf
        cases.append((n, lambda d, n=n, src=src: getattr(ops, n)(T(src, d))))
    for n in ("acos", "asin"):
        cases.append((n, lambda d, n=n: getattr(ops, n)(T(xu, d))))
    for n in ops.math.__all__:
        if n.startswith("elementwise_") or n == "minus":
            b = xp if n in ("elementwise_div", "elementwise_mod",
                            "elementwise_floordiv", "elementwise_pow") else yf
            a = xp if n == "elementwise_pow" else xf
            cases.append((n, lambda d, n=n, a=a, b=b: getattr(ops, n)(
                T(a, d), T(b, d))))
            cases.append((n + "_int", lambda d, n=n: getattr(ops, n)(
                T(xi, d), T(np.abs(xi) + 1, d))))
        elif n in ("equal", "not_equal", "less_than", "less_equal",
                   "greater_than", "greater_equal"):
            cases.append((n, lambda d, n=n: getattr(ops, n)(T(xi, d),
                                                            T(xi[0], d))))
        elif n.startswith("logical_"):
            cases.append((n, lambda d, n=n: getattr(ops, n)(
                T(xb, d), T(yb, d)) if n != "logical_not"
                else ops.logical_not(T(xb, d))))
    cases += [
        ("matmul", lambda d: ops.matmul(T(xf, d), T(yf, d),
                                        transpose_y=True)),
        ("mul", lambda d: ops.mul(T(seq, d), T(xf[:4, :7], d),
                                  x_num_col_dims=2)),
        ("bmm", lambda d: ops.bmm(T(seq, d), T(seq, d).transpose(1, 2))),
        ("dot", lambda d: ops.dot(T(xf, d), T(yf, d))),
        ("scale", lambda d: ops.scale(T(xf, d), 2.0, 0.5, False)),
        ("sums", lambda d: ops.sums([T(xf, d), T(yf, d), T(xf, d)])),
        ("cumsum", lambda d: ops.cumsum(T(xi, d), axis=1, exclusive=True,
                                        reverse=True)),
        ("clip", lambda d: ops.clip(T(xf, d), -0.5, 0.5)),
        ("clip_by_norm", lambda d: ops.clip_by_norm(T(xf, d), 1.0)),
        ("cast", lambda d: ops.cast(T(xf, d), "int64")),
        ("pow", lambda d: ops.pow(T(xp, d), 1.5)),
    ]
    for n in ops.reduce.__all__:
        if n.startswith("reduce_"):
            src = xb if n in ("reduce_all", "reduce_any") else (
                xp[:, :4] if n == "reduce_prod" else xf)
            cases.append((n, lambda d, n=n, src=src: getattr(ops, n)(
                T(src, d), dim=[0], keep_dim=True)))
            cases.append((n + "_all", lambda d, n=n, src=src: getattr(
                ops, n)(T(src, d))))
    cases += [
        ("mean", lambda d: ops.mean(T(xi, d))),
        ("squared_l2_norm", lambda d: ops.squared_l2_norm(T(xf, d))),
        ("l1_norm", lambda d: ops.l1_norm(T(xf, d))),
        ("l2_normalize", lambda d: ops.l2_normalize(T(xf, d))),
        ("norm", lambda d: ops.norm(T(xf, d), axis=0)),
        ("mean_iou", lambda d: ops.mean_iou(
            T(np.abs(xi) % 3, d), T(np.abs(xi[::-1].copy()) % 3, d), 3)),
        ("argsort_ties", lambda d: ops.argsort(T(ties, d), descending=True)),
        ("argsort_ties_axis0", lambda d: ops.argsort(T(ties, d), axis=0)),
        ("topk_ties", lambda d: ops.topk(T(ties, d), 4)),
        ("argmax_ties", lambda d: ops.argmax(T(ties, d), axis=1)),
        ("argmin_ties", lambda d: ops.argmin(T(ties, d), axis=1)),
        ("unique_ties", lambda d: ops.unique_with_counts(T(ties, d))),
        ("gather", lambda d: ops.gather(T(xf, d), T(np.array([5, 0, 5]), d))),
        ("gather_nd", lambda d: ops.gather_nd(T(seq, d), T(np.array(
            [[0, 1], [5, 4]]), d))),
        ("scatter_add", lambda d: ops.scatter(T(xf, d), T(np.array(
            [1, 3, 1]), d), T(yf[:3], d), overwrite=False)),
        ("scatter", lambda d: ops.scatter(T(xf, d), T(np.array([2, 7]), d),
                                          T(yf[:2], d))),
        ("scatter_nd_add", lambda d: ops.scatter_nd_add(
            T(xf, d), T(np.array([[0, 1], [0, 1]]), d), T(yf[0, :2], d))),
        ("slice", lambda d: ops.slice(T(seq, d), [1, 2], [-3, 1], [100, 3])),
        ("strided_slice", lambda d: ops.strided_slice(T(seq, d), [1], [4],
                                                      [0], [-2])),
        ("where", lambda d: ops.where(T(xb, d), T(xf, d), T(yf, d))),
        ("where_index", lambda d: ops.where_index(T(xb, d))),
        ("multiplex", lambda d: ops.multiplex(
            [T(xf, d), T(yf, d)], T(np.arange(64) % 2, d))),
        ("concat_split", lambda d: ops.split(ops.concat(
            [T(xf, d), T(yf, d)], axis=1), [10, 20, 36], dim=1)),
        ("stack_unstack", lambda d: ops.unstack(ops.stack(
            [T(xf, d), T(yf, d)], axis=2), axis=1)),
        ("expand_tile_flip_roll", lambda d: ops.roll(ops.flip(ops.tile(
            ops.expand(T(seq, d), [1, 2, 1]), [1, 1, 2]), [0, 2]), 3,
            axis=1)),
        ("transpose_reshape", lambda d: ops.reshape(ops.transpose(
            T(seq, d), [2, 0, 1]), [0, -1])),
        ("fill_constant", lambda d: ops.fill_constant([3, 4], "int64", 7,
                                                      device=d)),
        ("arange_linspace_eye", lambda d: (
            ops.arange(0, 7, 2, "int32", device=d),
            ops.linspace(-1.0, 1.0, 9, device=d), ops.eye(3, 5, device=d))),
        ("cond", lambda d: cf.cond(T(True, d), lambda a: a * 2.0,
                                   lambda a: a - 1.0, (T(xf, d),))),
        ("case", lambda d: cf.case([(T(False, d), lambda: T(xf, d)),
                                    (T(True, d), lambda: T(yf, d))],
                                   default=lambda: T(xf * 0, d))),
        ("switch_case", lambda d: cf.switch_case(
            T(np.int32(7), d), {1: lambda: T(xf, d), 3: lambda: T(yf, d)},
            default=lambda: T(xf + 1.0, d))),
        ("while_zero_trip", lambda d: cf.while_loop(
            lambda i, v: i < 0, lambda i, v: [i + 1, v * 2.0],
            [T(np.int32(0), d), T(xf, d)])),
        ("while_5", lambda d: cf.while_loop(
            lambda i, v: i < 5, lambda i, v: [i + 1, ops.tanh(v) * 1.5],
            [T(np.int32(0), d), T(xf, d)])),
        ("static_rnn", lambda d: cf.static_rnn(
            lambda h, x: (ops.tanh(h + x), h * 2.0), T(seq, d),
            T(seq[:, 0], d))),
        ("dynamic_rnn_len0", lambda d: cf.dynamic_rnn(
            lambda h, x: (ops.tanh(h + x), h * 2.0),
            RaggedBatch(T(seq, d), T(lens, d)), T(seq[:, 0], d))),
        ("StaticRNN_DynamicRNN", lambda d: _rnn_classes(
            pt, ops, T(seq, d), T(lens, d))),
        ("Switch", lambda d: _switch(pt, T(xf, d))),
        ("IfElse", lambda d: _ifelse(pt, T(xf, d))),
        ("tensor_array", lambda d: _arrays(ta, RaggedBatch(T(seq, d),
                                                           T(lens, d)), d)),
        ("static_while_scan", lambda d: _static_blocks(pt, xf, seq, d)),
    ]
    return cases


def _rnn_classes(pt, ops, seq, lens):
    outs = []
    for rnn in (pt.layers.StaticRNN(), pt.layers.DynamicRNN(lengths=lens)):
        rnn.step_input(seq)
        rnn.memory(init=seq[:, 0])
        outs += rnn(lambda x, h: {"mem": [ops.tanh(h + x)], "out": [h]})
    return outs


def _switch(pt, x):
    with pt.layers.Switch() as sw:
        with sw.case(x > 1.0):
            a = x * 10.0
        with sw.case(x > 0.0):
            b = x * 100.0
        with sw.default():
            c = -x
    return sw.select(a, b, c)


def _ifelse(pt, x):
    ie = pt.layers.IfElse(x[:, 0] > 0)
    with ie.true_block():
        ie.output(ie.input(x) * 10.0)
    with ie.false_block():
        ie.output(ie.input(x) - 1.0)
    return ie()[0]


def _arrays(ta, rb, dev):
    """Every tensor-array function at tied lengths (numpy's orders) and a
    row of length 0."""
    a = ta.create_array(4, (rb.data.shape[2],), device=dev)
    a = ta.array_write(a, torch.tensor(2, device=dev), rb.data[0, 0])
    steps, order, lens = ta.lod_tensor_to_array(rb)
    table = ta.lod_rank_table(rb)
    t, f, restore = ta.split_lod_tensor(rb.data[:, 0], rb.lengths > 2)
    return [a.stack(), ta.tensor_array_to_tensor(a, axis=1),
            ta.array_read(a, 2), ta.array_length(a), *steps,
            torch.tensor(order), ta.array_to_lod_tensor(steps, order,
                                                        lens).data,
            torch.tensor(table), ta.reorder_lod_tensor_by_rank(rb, table).data,
            ta.lod_reset(rb, [int(lens.sum()) - 2, 2]).data,
            ta.merge_lod_tensor(t, f, restore),
            ta.shrink_rnn_memory(rb.data[:, 0], table, 2)]


def _static_blocks(pt, xf, seq, dev):
    """A while_block (5 trips, and 0) and a scan_block through
    ``Executor.run`` on ``dev``."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.data("x", list(xf.shape), append_batch_size=False)
        s = pt.data("s", list(seq.shape), append_batch_size=False)
        outs = []
        for trips in (5, 0):
            lim = L.fill_constant([1], "int32", trips)
            outs.append(L.while_loop(
                lambda i, v: L.reduce_all(L.less_than(i, lim)),
                lambda i, v: [L.increment(i, value=1), L.tanh(v)],
                [L.fill_constant([1], "int32", 0), x])[1])
        h0 = pt.data("h0", [seq.shape[0], seq.shape[2]],
                     append_batch_size=False)
        outs += list(L.static_rnn(
            lambda h, x_t: (L.tanh(L.elementwise_add(h, x_t)), h), s, h0))
    exe = pt.Executor(pt.CPUPlace() if dev == "cpu" else None)
    return exe.run(main, feed={"x": xf, "s": seq, "h0": seq[:, 0]},
                   fetch_list=outs, scope=pt.Scope(), return_numpy=False)


def cf_card_vs_cpu(pt, ops):
    """Each case of :func:`cf_cases` on the card and on the CPU: returns
    {case: the largest gap over the largest value}; integer and boolean
    results must be equal."""
    from paddle_tpu_torch.ops.nn import no_tf32

    def flat(v):
        if isinstance(v, (list, tuple)):
            return [x for e in v for x in flat(e)]
        if hasattr(v, "lengths"):           # a RaggedBatch
            return [v.data, v.lengths]
        return [v if isinstance(v, torch.Tensor) else torch.as_tensor(v)]

    gaps = {}
    with no_tf32():
        for name, fn in cf_cases(pt, ops):
            a, b = flat(fn("cuda")), flat(fn("cpu"))
            check(len(a) == len(b), f"{name}: {len(a)} vs {len(b)} outputs")
            worst = 0.0
            for u, v in zip(a, b):
                u = u.cpu()
                check(u.shape == v.shape and u.dtype == v.dtype,
                      f"{name}: {u.shape} {u.dtype} vs {v.shape} {v.dtype}")
                if not v.is_floating_point():
                    check(torch.equal(u, v), f"{name}: card and CPU differ")
                    continue
                scale = max(v.abs().max().item(), 1.0) if v.numel() else 1.0
                gap = (u - v).abs().max().item() / scale if v.numel() else 0.0
                check(gap <= CF_OP_TOL, f"{name}: card vs CPU {gap}")
                worst = max(worst, gap)
            gaps[name] = worst
    return gaps


def phase_control_flow_checks(K, pt, ops, ptb_lm, trained, card_out):
    """Phase 30: the LM at batch 4 card vs CPU (3 steps), phase 29's
    generation again on the CPU, then module 1's ops, the control-flow
    constructs and the tensor arrays card vs CPU."""
    rec = dict(lm=lm_card_vs_cpu(K, pt, ptb_lm),
               generation=lm_generation_card_vs_cpu(pt, ptb_lm, trained,
                                                    card_out))
    K.reset_launch_counts()
    gaps = cf_card_vs_cpu(pt, ops)
    rec.update(cases=len(gaps), worst_gap=max(gaps.values()),
               worst_case=max(gaps, key=gaps.get), gaps=gaps,
               tol=f"{LM_TOL}; ops {CF_OP_TOL} of the largest value, "
                   "integers and booleans equal")
    log("control_flow_correctness " + json.dumps(rec))
    rec["launches"] = rec["lm"]["launches"]
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's main path runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    import numpy as np

    from paddle_tpu_torch import ops, optimizer
    from paddle_tpu_torch.models import (
        bert, deepfm, ptb_lm, resnet, se_resnext, transformer, vgg,
    )
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
    log("phase 1: the tensor-core kernels (ptxas registers and spills, "
        "tensor-core instructions in the SASS)")
    tensor_core_report(built)

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
    # the tensor-core kernels' edges: bf16 at each head size, S = 300, 1000
    # and 2048 (not all multiples of the 128-row tiles), causal and masked
    # keys, rows that see no key (batch 0's keys all masked), the fused QKV
    # projection's head views (taken as they are) and views 2 bytes off a
    # 16-byte boundary (copied by the wrapper for the same kernel); then the
    # fp32 SIMT instantiation at the same edges. Rows that see no key are
    # held in the forward only: there lse rounds to the -1e9 bias, so the
    # backward's p is 1 on every key and it sums S unnormalized terms whose
    # cancellation left the tensor-core dK and the SIMT dQ alike up to 2
    # bf16 units from the plain body (on an H100 80GB HBM3: 0.125 and
    # 0.0625 at [2,4,300,64], 0.5 and 0.5 at [2,4,2048,32]; PERF.md); their
    # backward runs with the last tenth of the keys masked instead
    bf = torch.bfloat16
    edges = [(300, 16, True, 30, "contiguous"),
             (1000, 32, False, 100, "contiguous"),
             (2048, 16, True, 0, "contiguous"),
             (2048, 32, False, "all", "contiguous"),
             (300, 64, False, "all", "qkv"),
             (1000, 64, True, 100, "qkv"),
             (300, 32, False, 30, "unaligned"),
             (1000, 64, True, "all", "unaligned")]
    for S, D, causal, masked, layout in edges:
        for dt in (bf, torch.float32):
            with torch.inference_mode():
                check_flash(K, 2, 4, S, D, dt, causal, masked, gen,
                            layout=layout, timed=False)
            check_flash_bwd(K, 2, 4, S, D, dt, causal,
                            S // 10 if masked == "all" else masked, gen,
                            layout=layout, timed=False)
    from paddle_tpu_torch.core.tree import leaves
    bert_shapes = [t.shape for t in leaves(bert.init_params(
        bert.bert_base(), gen))]
    adam_main = check_adam(K, bert_shapes, 1, gen)
    check_adam(K, bert_shapes, 1000, gen)
    check_adam(K, bert_shapes, 1, gen, lr_on_card=True)
    # Transformer-big's 258 tensors (~243 M values), train-transformer-big's
    # update
    nmt_shapes = [t.shape for t in leaves(transformer.init_params(
        transformer.transformer_big(max_seq=256), gen))]
    check(len(nmt_shapes) == 258, f"{len(nmt_shapes)} Transformer-big "
                                  "leaves")
    adam_nmt = check_adam(K, nmt_shapes, 1, gen, label="Transformer-big")
    check_adam(K, list(gru_nmt_shapes(NMT).values()), 1, gen,
               label="the GRU encoder-decoder")
    # the static path's kernels: the word2vec step's shapes at batch 100
    # (the main path) and 8192, and BERT-base's shapes beside them
    with torch.inference_mode():
        emb_main = check_embedding(K, W2V_VOCAB, W2V_EMBED, torch.float32,
                                   100, gen)
        check_embedding(K, W2V_VOCAB, W2V_EMBED, torch.float32, 8192, gen)
        check_embedding(K, 30528, 768, torch.bfloat16, 64 * 512, gen)
        # the sequence models' tables at their batches' ids: the IMDB
        # words (128 x 512), the SRL word table (10 x 64), the NMT
        # dictionaries (64 x 50), MovieLens' users (256)
        for h, d, n in ((SENT["vocab"], SENT["emb"], 128 * 512),
                        (SRL["words"], SRL["word_dim"], 10 * 64),
                        (NMT["src"], NMT["emb"], 64 * 50),
                        (MLF["users"], MLF["emb"], MLF["batch"])):
            check_embedding(K, h, d, torch.float32, n, gen)
        # the PTB LM's table (phase 28): [10000,650] with 20x35 ids
        lm = ptb_lm.medium()
        check_embedding(K, lm.vocab, lm.hidden, torch.float32,
                        lm.batch * lm.num_steps, gen)
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
        # the serving MLP's fp32 buckets 1 and 8 (bench.py:629-665), and
        # word2vec's fc with a bf16 weight (export_aot(quantize="bf16"))
        for m in (1, 8):
            fmm[(m, 256, 256, "relu")] = check_fused_matmul(
                K, m, 256, 256, "relu", torch.float32, gen)
            check_fused_matmul(K, m, 256, 10, None, torch.float32, gen)
        check_fused_matmul(K, 100, W2V_HIDDEN, W2V_VOCAB, None,
                           torch.float32, gen, w_dtype=torch.bfloat16)
        check_fused_matmul_special(K, gen)
        # the sequence models' static fcs (phase 24, db_lstm at batch 10 x
        # 64 steps): each input slot's fc 512, the mix fcs over the hidden
        # and the LSTM's 128, the label fcs (59)
        for k, n in ((SRL["word_dim"], SRL["hidden"]),
                     (SRL["mark_dim"], SRL["hidden"]),
                     (SRL["hidden"], SRL["hidden"]),
                     (SRL["hidden"] // 4, SRL["hidden"]),
                     (SRL["hidden"], SRL["labels"]),
                     (SRL["hidden"] // 4, SRL["labels"])):
            check_fused_matmul(K, SRL["batch"] * SRL["lens"][1], k, n,
                               "tanh", torch.float32, gen)
        # the PTB LM's softmax fc (phase 28): [700,650]x[650,10000] fp32
        check_fused_matmul(K, lm.batch * lm.num_steps, lm.hidden, lm.vocab,
                           None, torch.float32, gen)
        # the static BERT trunk's FFN (bench.py:485)
        for dt in (torch.float32, torch.bfloat16):
            check_fused_matmul(K, 4096, 768, 3072, "relu", dt, gen)
        # the int8 kernel at the served micro-batches' shapes: the MLP's
        # buckets 1 and 8, word2vec's two fcs at 64 rows, BERT's FFN (where
        # the fp32 kernel is timed) and the ragged case
        fmm8 = {}
        for m, k, n, act, bias in (
                (1, 256, 256, "relu", True), (8, 256, 256, "relu", True),
                (8, 256, 10, None, True),
                (64, 4 * W2V_EMBED, W2V_HIDDEN, "sigmoid", True),
                (64, W2V_HIDDEN, W2V_VOCAB, None, True),
                (4096, 768, 3072, "relu", True),
                (33, 70, 130, "tanh", False)):
            fmm8[(m, k, n)] = check_fused_matmul_int8(K, m, k, n, act, gen,
                                                      with_bias=bias)
        # bf16 x (one TF32 pass), and the FFN against fp64
        check_fused_matmul_int8(K, 64, W2V_HIDDEN, W2V_VOCAB, None, gen,
                                dtype=torch.bfloat16)
        check_fused_matmul_int8_accuracy(K, 4096, 768, 3072, gen)
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
        # the image models' update: one momentum launch over ResNet-50's 267
        # tensors (25,610,152 values); the rate as a float and, as a
        # schedule gives it, read from the card; the other rules with a
        # rate on the card
        rn50_shapes = leaves(resnet.param_shapes(resnet.resnet50()))
        check(len(rn50_shapes) == 267, f"{len(rn50_shapes)} ResNet-50 leaves")
        opt_main["momentum_rn50"] = check_sgd(
            K, rn50_shapes, "momentum", gen, "ResNet-50's 267 tensors, one "
            "launch")
        check_sgd(K, rn50_shapes, "momentum", gen, "ResNet-50's 267 "
                  "tensors, lr on the card", lr_on_card=True)
        check_sgd(K, w2v_shapes, "sgd", gen, "word2vec, lr on the card",
                  lr_on_card=True)
        # db_lstm's 67 tensors with the schedule's rate read from the card,
        # in one launch: the static path's one launch per parameter cannot
        # be timed behind a spin (each launch's pinned table waits on the
        # spun stream, so the host allocates a new one: ~0.6 ms a launch on
        # an H100 80GB HBM3, PERF.md); phase 27 holds those launches card
        # vs CPU
        srl_main = db_lstm_program(pt, SRL, srl_sgd)[0]
        srl_shapes = [tuple(srl_main.global_block().var(n).shape)
                      for n in trainable(srl_main)]
        check_sgd(K, srl_shapes, "sgd", gen, f"db_lstm's {len(srl_shapes)} "
                  "tensors, lr on the card, one launch", lr_on_card=True)
        # the PTB LM's 7 tensors (19.8 M values), one launch
        lm_main = ptb_lm.build_train(pt, lm)["main"]
        check_sgd(K, [tuple(lm_main.global_block().var(n).shape)
                      for n in ptb_lm.param_names(lm)], "sgd", gen,
                  "the PTB LM's 7 tensors, one launch")
        del lm_main
        # the scatter-add: bench.py's CTR point; BERT-base's three
        # embedding gradients with pretrain-512's ids into zeros (phase
        # 10's word shape is the main one); the merge's inverse ids; bf16;
        # edge ids
        ids_512 = torch.as_tensor(bert.synthetic_batch(
            bert.bert_base(), 64, 512, max_preds=80)["input_ids"],
            device="cuda").reshape(-1).long()
        dy = torch.randn(ids_512.numel(), 768, generator=gen, device="cuda")
        check_scatter_add(
            K, "CTR [65536,256], 4096 ids",
            torch.randn(65536, 256, generator=gen, device="cuda"),
            torch.randint(0, 65536, (4096,), generator=gen, device="cuda"),
            torch.randn(4096, 256, generator=gen, device="cuda"))
        sc = {}
        for name, h, ids in (
                ("word", 30528, ids_512),
                ("position", 512, torch.arange(512, device="cuda").repeat(64)),
                ("token-type", 2, torch.zeros_like(ids_512))):
            sc[name] = check_scatter_add(
                K, f"BERT {name} [{h},768], 32768 ids",
                torch.zeros(h, 768, device="cuda"), ids, dy)
        inv = torch.unique(ids_512, return_inverse=True)[1]
        check_scatter_add(K, "merge [32768,768], inverse ids",
                          torch.zeros(32768, 768, device="cuda"), inv, dy)
        check_scatter_add(
            K, "bf16 word [30528,768], 32768 ids",
            torch.randn(30528, 768, generator=gen, device="cuda").bfloat16(),
            ids_512, dy.bfloat16())
        # the CTR table of phase 10 at DeepFM's width (d = 8): one batch's
        # ids densified into zeros, then its merged rows (row 0 takes the
        # padding: one long run) as sparse SGD applies them; uniform ids,
        # then skewed ones (the longer pad run)
        rng = np.random.RandomState(5)
        for traffic, zipf_a in (("uniform", None), ("zipf", CTR_ZIPF_A)):
            ids = ctr_ids(rng, zipf_a)
            sr = ops.SelectedRows(ids, torch.randn(
                ids.numel(), CTR_DIM, generator=gen, device="cuda"),
                CTR_SLOTS * CTR_VOCAB)
            if zipf_a is None:
                check_scatter_add(
                    K, f"CTR densify [2600000,8], {ids.numel()} {traffic} "
                       "ids", torch.zeros(sr.height, CTR_DIM, device="cuda"),
                    ids, sr.values)
            merged = ops.merge_selected_rows(sr)[0]
            check_scatter_add(
                K, f"CTR sparse SGD [2600000,8], merged {traffic} rows",
                torch.randn(sr.height, CTR_DIM, generator=gen,
                            device="cuda"), merged.rows, merged.values)
        check_scatter_add(
            K, "edge ids [1000,100]",
            torch.randn(1000, 100, generator=gen, device="cuda"),
            torch.randint(0, 8, (300,), generator=gen, device="cuda"),
            torch.randn(300, 100, generator=gen, device="cuda"), edge=True)
        del dy
        # the cross-entropy: pretrain-512's gathered MLM head (the main
        # shape), in fp32, bench.py's point, word2vec's ragged V, edges
        xent_main = check_xent(K, "MLM head", 5120, 30528, torch.bfloat16,
                               gen)
        check_xent(K, "MLM head fp32", 5120, 30528, torch.float32, gen)
        check_xent(K, "bench.py", 512, 32000, torch.float32, gen)
        check_xent(K, "word2vec", 100, W2V_VOCAB, torch.float32, gen)
        check_xent(K, "edge labels", 64, 1000, torch.bfloat16, gen,
                   edge=True)
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
    static, trained = phase_static_w2v(K, pt, card)
    log(f"phases 0-8 done at {time.perf_counter() - t_start:.1f} s")
    log("phase 9: Fluid inference and int8 serving (serve-int8)")
    served = phase_serve_int8(K, pt, card, trained)
    log(f"phases 0-9 done at {time.perf_counter() - t_start:.1f} s")
    log("phase 10: sparse rows and the fused loss at BERT-base width "
        "(sparse-xent)")
    sparse = phase_sparse_xent(K, bert, ops, card)
    log(f"phases 0-10 done at {time.perf_counter() - t_start:.1f} s")
    log("phase 11: training ResNet-50, 256x224^2 bf16 (train-resnet50)")
    rn50 = phase_train_resnet50(K, resnet, optimizer, card)
    log("phase 12: image training correctness on the card "
        "(train-correctness)")
    img_checks = phase_image_train_checks(K, resnet, optimizer, pt, card)
    log("phase 13: ResNet-50 and VGG-16 inference latency (infer-image)")
    phase_infer_image(K, resnet, vgg, card)
    log("phase 14: training SE-ResNeXt-50, 32x224^2 bf16 "
        "(train-se-resnext50)")
    sx50 = phase_train_se_resnext50(K, se_resnext, optimizer, card)
    log(f"phases 0-14 done at {time.perf_counter() - t_start:.1f} s")
    log("phase 15: training Transformer-big, 32x256 bf16 "
        "(train-transformer-big)")
    nmt, trained = phase_train_transformer_big(K, transformer, optimizer,
                                               card, adam_nmt["ms"])
    log("phase 16: Transformer-big beam-4 and greedy decode, 32 sources, "
        "64 tokens (decode-transformer-big)")
    phase_decode_transformer_big(K, transformer, card, trained)
    del trained
    log("phase 17: Transformer correctness on the card "
        "(transformer-correctness)")
    phase_transformer_checks(K, transformer, optimizer, card)
    log("phase 18: the DeepFM CTR trainer over the host tables, batch 4096 "
        "(ctr-deepfm)")
    phase_ctr_deepfm(K, deepfm, card)
    log(f"phases 0-18 done at {time.perf_counter() - t_start:.1f} s")
    log("phase 19: the recognize_digits conv_net through the static path, "
        "batch 64 (train-book-digits)")
    digits, _ = phase_train_book(
        K, pt, card, "train-book-digits",
        build_conv_net(pt, pt.optimizer.Adam(BOOK_LR)),
        book_batches((1, 28, 28), DIGITS_BATCH, 10, 1), DIGITS_BATCH, 1)
    log("phase 20: vgg16_bn_drop through the static path, 3x32x32, batch "
        "128 (train-book-vgg)")
    vgg_rec, (vgg_built, _, _) = phase_train_book(
        K, pt, card, "train-book-vgg",
        build_vgg16_bn_drop(pt, pt.optimizer.Adam(BOOK_LR)),
        book_batches((3, 32, 32), VGG_BATCH, 10, 2), VGG_BATCH, 3)
    vgg_main = vgg_built[0]
    vgg_shapes = [tuple(vgg_main.global_block().var(n).shape)
                  for n in trainable(vgg_main)]
    del vgg_built
    log(f"phases 0-20 done at {time.perf_counter() - t_start:.1f} s")
    log("phase 21: the book models on the card against the CPU, dropout, "
        "the inference round trip (book-correctness)")
    book = phase_book_checks(K, pt, ops, card)
    log("phase 22: the twelve optimizer rules without a kernel, card "
        "against CPU, device time per update (optimizer-rules)")
    phase_optimizer_rules(K, pt, resnet, card, vgg_shapes)
    log(f"phases 0-22 done at {time.perf_counter() - t_start:.1f} s")
    log("phase 23: understand_sentiment's convolution_net, batch 128 "
        "(train-book-sentiment)")
    sent = phase_train_module_book(
        K, pt, card, "train-book-sentiment", sentiment_model, SENT,
        sentiment_batches, pt.optimizer.Adagrad(SENT["lr"]),
        {"embedding_gather": 1}, "reviews", 23)
    log("phase 24: label_semantic_roles' db_lstm through the static path, "
        "batch 10 (train-book-srl)")
    srl, _ = phase_train_book_srl(K, pt, ops, card)
    log("phase 25: the GRU encoder-decoder at 512, batch 64 "
        "(train-book-nmt)")
    book_nmt = phase_train_book_nmt(K, pt, ops, card)
    log("phase 26: the full MovieLens recommender, batch 256 "
        "(train-book-movielens)")
    movielens = phase_train_module_book(
        K, pt, card, "train-book-movielens", movielens_model, MLF,
        movielens_batches, pt.optimizer.SGD(MLF["lr"]),
        {"embedding_gather": 7, "fused_sgd": 1}, "examples", 26)
    log(f"phases 0-26 done at {time.perf_counter() - t_start:.1f} s")
    log("phase 27: the sequence models, ops and recurrences on the card "
        "against the CPU (sequence-correctness)")
    seq_checks = phase_sequence_checks(K, pt, ops, card,
                                       db_lstm_program(pt, SRL, srl_sgd))
    log(f"phases 0-27 done at {time.perf_counter() - t_start:.1f} s")
    log("phase 28: the PTB LSTM language model at lm_model.py's medium "
        "config through the reader, StaticRNN and prepare (train-ptb-lm)")
    lm_train, lm_trained = phase_train_ptb_lm(K, pt, ptb_lm, card)
    log("phase 29: greedy generation through the while loop, 20 streams x "
        "35 tokens (generate-ptb-lm)")
    _, lm_out = phase_generate_ptb_lm(K, pt, ptb_lm, card, lm_trained)
    log("phase 30: the LM, the control flow, tensor arrays and module 1's "
        "ops on the card against the CPU (control-flow-correctness)")
    cf_checks = phase_control_flow_checks(K, pt, ops, ptb_lm, lm_trained,
                                          lm_out)
    del lm_trained
    log(f"phases 0-30 done at {time.perf_counter() - t_start:.1f} s")
    log_card("at the end")

    # launches on the main paths: each phase's counted runs, counts set to
    # 0 just before and read just after
    by_phase = {
        "serve-512": {"fused_layer_norm": serving["ln_launches"]},
        "longctx-2048": {"flash_attention": longc["flash_launches"]},
        "pretrain-512": pre512["launches"],
        "pretrain-2048": pre2048["flash"]["launches"],
        "static-w2v": static["launches"],
        "serve-int8": served["launches"],
        "sparse-xent": sparse["launches"],
        "train-resnet50": rn50["launches"],
        "train-correctness": img_checks["launches"],
        "train-se-resnext50": sx50["launches"],
        "train-transformer-big": nmt["launches"],
        "train-book-digits": digits["launches"],
        "train-book-vgg": vgg_rec["launches"],
        "book-correctness": book["launches"],
        "train-book-sentiment": sent["launches"],
        "train-book-srl": srl["launches"],
        "train-book-nmt": book_nmt["launches"],
        "train-book-movielens": movielens["launches"],
        "sequence-correctness": seq_checks["launches"],
        "train-ptb-lm": lm_train["launches"],
        "control-flow-correctness": cf_checks["launches"],
    }
    kernels = []
    for name, main_rec in (
            ("fused_layer_norm", ln_main), ("flash_attention", fa_main),
            ("flash_attention_bwd_dkdv",
             bwd_main["flash_attention_bwd_dkdv"]),
            ("flash_attention_bwd_dq", bwd_main["flash_attention_bwd_dq"]),
            ("fused_adam", adam_main), ("embedding_gather", emb_main),
            ("fused_matmul", fmm[(100, W2V_HIDDEN, W2V_VOCAB, None)]),
            ("fused_matmul_int8", fmm8[(8, 256, 256)]),
            ("fused_sgd", opt_main["sgd"]),
            ("fused_momentum", opt_main["momentum_rn50"]),
            ("embedding_scatter_add", sc["word"]),
            ("softmax_cross_entropy", xent_main)):
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
    check(sorted(k["name"] for k in kernels) == K.list_kernels(),
          "the kernels line must list every registered kernel")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
