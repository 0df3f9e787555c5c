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
   Transformer-big's 258 tensors (~243 M values), over the GRU
   encoder-decoder's 10 (phase 25) and over the dygraph Transformer-base's
   list (49,485,824 values) with the Noam rate read from the card (phase
   48); the gather at that model's word table [10000,512] with 4096 ids in
   fp32 and bf16, and momentum over the dygraph ResNet-50's 161 tensors
   with its rate on the card (phase 49); and the static
   path's kernels: the embedding gather (word2vec's table with 100 and
   8192 ids, BERT-base's word table with 64x512 ids, and the sequence
   models' tables at their batches' ids: IMDB's 5147 words with 128x512,
   the SRL's 44068 with 10x64, the NMT's 30000 x512 with 64x50, MovieLens'
   6041 users with 256), the fused matmul (db_lstm's six fc shapes at
   10x64 rows with tanh;
   each activation at both word2vec fc shapes, those at 8192 rows, the
   serving MLP's fp32 buckets [1|8,256]x[256,256] relu and [1|8,256]x
   [256,10], word2vec's fc 2 with a bf16 weight, inf, -inf and NaN in x
   and w through each activation, MobileNetV1's classifier fc
   [256,1024]x[1024,1000] fp32 with its bias (phase 42) and at the served
   top bucket [32,1024]x[1024,1000] (phase 45), and BERT's FFN
   [4096,768]x[768,3072] relu in fp32 and bf16; the fp32 operations bound is three TF32 passes
   at 495 TFLOP/s, the least time an fp32-accurate product takes), the int8
   fused matmul on the same tensor-core kernel (the serving MLP's
   [1|8,256]x[256,256] relu and [8,256]x[256,10], word2vec's two fcs at 64
   rows, with bf16 x too at the wider, BERT's FFN shape, also held against
   an fp64 product of the dequantized weight, MobileNetV1's served fc
   [32,1024]x[1024,1000] with its bias (phase 45's v2 and v3), and a ragged
   [33,70,130] tanh without bias; its bound is three bf16 passes for fp32 x, one for bf16
   x, the int8 weight being exact in bf16;
   ``addmm`` on the weight dequantized beforehand is timed beside it as a
   yardstick of other work), and SGD and
   momentum (plain and nesterov) over word2vec's parameters, one launch
   per parameter as the static path makes them and one over the list, and
   over BERT-base's 154 tensors; SGD over db_lstm's 67 with the rate on
   the card; momentum over ResNet-50's 267 tensors
   (the image models' update) and over YOLOv3's 222 with the rate on the
   card (phase 33's update) and over MobileNetV1's 83 (phase 42's), and
   the three rules with the rate read
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
31. MobileNet-SSD training (train-ssd-mobilenet; ``models/ssd.py``) at
   PaddleCV/ssd's pascalvoc config, nothing cut: 3x300x300, 21 classes,
   batch 64, MobileNet v1 at scale 1.0 and ``multi_box_head`` over six maps
   (1,917 priors), ``reduce_sum(ssd_loss(...))``, RMSProp 0.001 under
   ``piecewise_decay`` with ``L2Decay(5e-5)``; ``Executor.prepare`` then
   ``SSD_STEPS`` steps over 4 seeded synthetic batches (gt padded to 20
   rows). No registered kernel launches (RMSProp has none); the loss
   falls; step latency (median from step 5), images/s, the busy share,
   peak memory, device events per step, and ``ssd_loss``'s forward and
   backward timed alone on the step's tensors (its share of the step's
   device time, its device events: the matching and mining loops), with
   the card refusing any synchronisation while it runs.
32. MobileNet-SSD inference over phase 31's scope (infer-ssd-mobilenet):
   the ``clone(for_test=True)`` program with ``softmax`` and
   ``detection_output(nms_threshold=0.45)`` at batch 32: latency,
   images/s, peak memory; ``detection_output`` alone on the same tensors
   (its 400-step NMS over 32 x 20 lanes) with synchronisation refused,
   equal to the program's output, its device events and time and its
   peak memory; the host time of ``detection_map`` (11point) against the
   synthetic gt.
33. YOLOv3 training (train-yolov3; ``models/yolov3.py``) at PaddleCV/yolov3's
   config: DarkNet-53, 608^2, 80 classes, batch 8, three ``yolov3_loss``
   levels with ``gt_score`` and label smoothing, Momentum 0.9 under
   ``linear_lr_warmup(piecewise_decay(...))`` with ``L2Decay(5e-4)``;
   ``prepare`` then ``YOLO_STEPS`` steps: exactly one ``fused_momentum``
   per trainable tensor (222) a step and nothing else registered; the loss
   falls; the records of phase 31 with ``yolov3_loss`` timed alone, and
   ``resize_nearest`` (forward and backward at both routes) timed alone.
34. YOLOv3 inference over phase 33's scope (infer-yolov3): ``yolo_box`` per
   level, the scores transposed and concatenated, ``multiclass_nms``
   (400 candidates, 100 kept, background -1) at batch 8: latency,
   images/s, peak memory; ``multiclass_nms`` alone (400 steps over 8 x 80
   lanes) with synchronisation refused, its device events and time.
35. Detection correctness (detection-correctness): ``ssd_tiny`` and
   ``yolo_tiny`` 3 steps on the card against the port on the CPU in fp32
   with TF32 off and cuDNN's deterministic algorithms (YOLOv3 from one set
   of weights: losses, first-step gradients, parameters within
   ``DET_TOL``; MobileNet-SSD, whose small-batch training is chaotic in
   fp32, each step from the same weights: the loss within
   ``DET_TOL["ssd_loss_rel"]``), then each inference program from the same
   weights: the networks' outputs and their decoding (``yolo_box``;
   ``box_coder`` and the softmax) within ``DET_TOL["op"]``, and
   ``multiclass_nms`` on the card from the CPU's decoding equal to the
   CPU's; and the detection ops on the card against
   the CPU at the tie cases (equal scores, all-zero ``yolo_box`` scores,
   equal IoUs) and the last-writer ``yolov3_loss`` cases.
36. CycleGAN training (train-cycle-gan; ``models/cycle_gan.py``) at
   PaddleGAN's published config: 256^2, batch 1, two ResNet-9-block
   generators (ngf 32) and two 70x70 PatchGAN discriminators (ndf 64),
   fp32 with TF32 off, Adam 2e-4 (beta1 0.5) in each of the three programs;
   ``prepare`` then ``CG_ITERS`` iterations of the source's loop on
   synthetic images in [-1, 1] (G, the fakes to the host and through the
   50-image pools, D_A, D_B): exactly one ``fused_adam`` per trainable
   tensor a step (142 + 13 + 13 an iteration) and nothing else registered,
   the losses finite; each program's host latency (median from iteration
   3), device events, kernel time and busy share of one profiled run,
   peak memory.
37. Both generators of the ``clone(for_test=True)`` inference program over
   phase 36's scope (infer-cycle-gan) at batch 1 and 8: latency (median of
   10), time per translated image, device events, peak memory; the
   outputs finite and within [-1, 1].
38. nn-correctness: ``cyclegan_tiny``'s three programs 3 iterations on the
   card against the port on the CPU from one set of weights and the same
   pool draws, with cuDNN's deterministic algorithms (losses, the first
   generator step's gradients, the persistables after, within ``CG_TOL``);
   every op the slice ports (the rest of ``ops/nn.py`` and the metric
   ops), value and input gradients, card against CPU at CycleGAN 256's
   shapes where it has them (``conv2d_transpose`` at [1,128,64,64],
   reflect ``pad2d`` at 256^2, instance norm at [1,128,64,64]) within
   ``CG_TOL["op"]``, host metrics equal; the kink gradients of F9 on the
   card equal to the CPU's (0.5 for ``relu`` at 0), and the conv2d + relu
   program's bias at -0.375 after one SGD step on the card.
39. CRNN-CTC training (train-crnn-ctc; ``models/crnn_ctc.py``) at
   PaddleCV/ocr_recognition's config: grey 48x512 images, batch 32, four
   conv groups with batch norm, ``im2sequence`` to 64 steps of 768, two
   fcs of 600, a forward and a reverse ``dynamic_gru`` of 200, an fc of 96,
   ``warpctc(blank=95, norm_by_times=True)``, Momentum(1e-3, 0.9) with
   ``L2Decay(4e-4)``, fp32 with TF32 off; ``prepare`` then ``CRNN_STEPS``
   steps over 4 synthetic batches (labels 1-24 long): exactly 2
   ``fused_matmul`` (fc1 and fc2; the output fc over two inputs sums them
   outside the kernel's contract) and one ``fused_momentum`` per trainable
   tensor (43) a step; the losses finite
   and falling; step latency (median from step 5), images/s, device events
   and busy share of one profiled step, peak memory.
40. CRNN-CTC's evaluation program over phase 39's scope (infer-crnn-ctc):
   the ``clone(for_test=True)`` with ``ctc_greedy_decoder`` and
   ``edit_distance`` at batch 32 and 1: latency (median of 10), time per
   image, decoded lengths, the mean edit distance, device events, busy
   share; exactly 2 ``fused_matmul`` a run.
41. misc-correctness: ``crnn_ctc_tiny`` 3 Momentum steps on the card
   against the port on the CPU from one set of weights with cuDNN's
   deterministic algorithms (losses, first-step gradients, persistables
   within ``CRNN_TOL``); every op of ``ops/misc.py`` and ``ops/ctc.py``,
   value and input gradients, card against CPU at CRNN-CTC's shapes where
   it has them (``im2sequence`` at [32,128,6,64], ``warpctc`` and the
   decoder at [32,64,96], the edit distance of 32 rows of 64 against 24),
   ties included, within ``CRNN_TOL["op"]``, integers equal;
   ``lookup_table`` launching the gather (row 6) once; the random ops on
   the card by range, moments, frequencies, windows, permutations and the
   seed rules.
42. MobileNetV1 under quantization-aware training (train-qat-mobilenet;
   ``models/mobilenet_v1.py``) at PaddleCV/image_classification's
   ``mobilenet.py``, scale 1.0: 3x224x224 images, batch 256, 1000 classes,
   27 convs with batch norm, the fc; Momentum(1e-3, 0.9) with
   ``L2Decay(4e-5)``, then ``QuantizeTranspiler`` (56 fake
   quant-dequant ops, abs-max 8 bits), fp32 with TF32 off; ``prepare``
   then ``QAT_STEPS`` steps over 2 synthetic batches: exactly 1
   ``fused_matmul`` (the fc, over two quant-dequant outputs) and 83
   ``fused_momentum`` (one per trainable tensor) a step; the losses finite
   and falling; step latency (median from step 5), images/s, first step,
   device events and busy share of one profiled step, peak memory.
43. The int8 deployment of phase 42's model (infer-int8-mobilenet):
   ``calibrate_activations`` over 4 synthetic batches of 256, then
   ``QuantizationFreezePass`` on the ``clone(for_test=True)``: 27
   ``quantized_conv2d`` and 1 ``quantized_mul`` over int8 weights on the
   card, exact integer sums (fp64 products of the integer values); latency
   at batch 256 and 1 (median of 10), time per image, device events, busy
   share; no registered kernel launched; the device time of one
   ``quantized_conv2d``'s and the ``quantized_mul``'s integer products
   (fp64, beside ``torch._int_mm``'s IMMA as a yardstick, whose int32 sums
   must equal them); the frozen program through ``save_inference_model``,
   ``load_inference_model`` and a ``Predictor``, the logits equal.
44. quant-correctness: ``mobilenet_v1_tiny`` 3 QAT Momentum steps on the
   card against the port on the CPU, each from the CPU's persistables,
   with cuDNN's deterministic algorithms (every fake-quant output's flips
   counted at every step and checked to be one step at a half integer;
   losses, gradients, the momentum update against the gradients' gap and
   the batch statistics within ``QUANT_TOL``), calibration on both
   devices, the freeze with the same scales (op lists and int8 weights
   equal, logits within ``QUANT_TOL``); every op of ``ops/quantize.py``
   and ``ops/aliases.py`` and ``layers``' ``hash`` and
   ``continuous_value_model``, value and input gradients, card against
   CPU at MobileNetV1's shapes where it has them, the abs-max ties and a K
   of 4608 included: integers and the integer products' results equal,
   values within ``QUANT_TOL["op_ulps"]``, gradients within
   ``QUANT_TOL["op"]`` (the abs-max scale's over a whole activation
   within ``QUANT_TOL["op_scale_grad"]``); ``py_func`` and ``delete_var``
   on the card; four programs of the new passes (scale chains,
   transposes, reshapes, casts) with the op lists equal on both devices
   and the outputs within ``QUANT_TOL["op"]``.
45. serve-http-swap-mobilenet: MobileNetV1 at 224^2 (``models/
   mobilenet_v1.py``'s ``build_train`` and ``export_served``): v1 fp32 at
   the seed's weights, v2 int8 after 5 Momentum steps at batch 32 on
   synthetic images, v3 int8 after 5 more (exactly 83 ``fused_momentum`` a
   step), a NaN version and a v2 copy with one byte of its int8 sidecar
   flipped. ``InferenceServer(ServingConfig(max_batch=32, replicas=1))``
   (ladder 1-32 warmed on the card) behind ``HttpFrontDoor``, with
   ``trace.enable(dirname=)`` armed; 8 ``WireClient`` threads (tenants a
   and b) POST one pre-encoded image a request (a body of ~3 MB of JSON).
   After 100 responses ``server.swap(v2)`` (the default canary,
   ``watchdog_ms=500``), its stage milliseconds, the standby's projection
   and warm boot, the card's allocated bytes and the ledger's resident
   params sampled through the window; then ``watch_dir(poll_ms=200)`` and
   v3 published into the watched directory (index last). The JSON encode
   and decode of one request on the host; latency p50/p99 before, across
   and after the hand swap; the device's busy share over a profiled burst;
   launches exact: 1 ``fused_matmul`` per v1 micro-batch, 1
   ``fused_matmul_int8`` per v2/v3 micro-batch, per standby warm-up bucket
   and per canary request.
46. swap-refusals, on the same server under the same load: the flipped
   byte (``gate_failed``), ``hbm_limit_bytes`` one byte under the
   projection (``SwapFailedError(stage="admission")``, ``refused_memory``,
   no pool built, the ledger unchanged), the NaN version by hand and then
   published into the watched directory (``canary_failed`` once each; the
   watcher skips it over the next polls and takes the next published
   version).
47. serving-correctness: every one of the >= 400 responses 200, each within
   ``HTTP_TOL["own"]`` of the largest logit of the version it names (that
   version's served program run alone on the card), and at least 10x that
   far from the other versions; v1 on the card against the CPU, v2 int8
   against its fp32 Predictor, v1's Predictor against its served program;
   the merged trace file's kept requests each with its tenant and every
   stage span; after the last drain the card's allocated bytes within 10%
   of v1's footprint plus the change in params.
48. train-dygraph-transformer: the dygraph Transformer-base of Fluid
   1.5's examples (``models/dygraph_transformer.py``: d_model 512, 8
   heads, 6 + 6 layers, d_inner 2048, vocabularies of 10,000 sharing one
   word table, dropouts 0.1, label smoothing 0.1) at 64 x 64 tokens a
   side, built from ``nn`` Layers and ``layers`` calls and trained
   eagerly (``pt.grad`` of the average cost, then Adam's
   ``apply_gradients`` under ``dygraph.NoamDecay(512, 8000, 2.0)``): 10
   counted fp32 steps (TF32 off), then 10 from the same weights under
   ``amp.decorate(use_bf16=True)``, each after one warm-up step; exactly 4
   ``embedding_gather`` and 1 ``fused_adam`` a step; step ms, tokens/s,
   MFU (bf16 against 989 TFLOP/s, fp32 against the 67 of SIMT fp32), the
   busy share of a profiled step, peak memory; then an evaluation pass
   under ``no_grad`` with dropout off (4 gathers).
49. train-dygraph-resnet50: Fluid 1.5's dygraph ResNet-50
   (``models/dygraph_resnet.py``: ConvBNLayer, BottleneckBlock, Pool2D,
   FC) at 224^2, batch 32, 102 classes, fp32 with TF32 off: 10 counted
   Momentum steps (piecewise decay from 0.1, L2 1e-4), the batch norms'
   running stats carried as ``nn`` state (every one moves), exactly one
   ``fused_momentum`` a step; images/s, busy share, peak memory; then an
   evaluation batch with ``is_test`` under ``no_grad`` (the state kept, no
   kernel) scored by ``metrics.Accuracy`` on the host.
50. dygraph-correctness: ``transformer_tiny`` and ``resnet_tiny`` 3 steps
   on the card against the CPU from the same weights (losses, params,
   slots, running stats, the evaluation's softmax), every Layer class of
   ``nn/layers.py`` (outputs, state, the gradients through ``pt.grad``),
   all within ``DY_TOL`` (cuDNN's deterministic algorithms, TF32 off);
   Dropout's rate on the card; ``amp`` under the fp16 policy with a
   ``LossScaler``: inf and NaN gradients injected, each
   ``apply_gradients`` with the card refusing every synchronisation, a
   skipped step's params, slots and step counter bitwise unchanged, the
   scale following the JAX rule step for step; the distributions' draws
   on the card against their closed forms; ``save_dygraph`` on the card,
   ``load_dygraph`` on the CPU, bit for bit.
51. Print one JSON line of every ported kernel (launches on the main paths,
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


def check_embedding(K, h, d, dtype, n, gen, edge_ids=True, ids=None):
    """The gather kernel against its plain body on a [h, d] table and n
    ids (``ids`` when given, else uniform in [0, h)); with ``edge_ids``, the
    ids include negative ones (wrap once) and ones outside [-h, h) (NaN
    rows). Timed on n valid ids, the main path's kind, beside
    ``F.embedding`` on the same table and ids. The bound reads the ids,
    each distinct row once and writes the n rows."""
    table = torch.randn(h, d, generator=gen, device="cuda").to(dtype)
    if ids is None:
        ids = torch.randint(0, h, (n,), generator=gen, device="cuda")
    check(ids.numel() == n, f"embedding_gather: {ids.numel()} ids, not {n}")
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
    rows_read = int(torch.unique(ids).numel())
    b_ms, b_by = bound(n * 8 + (rows_read + n) * row, 0, torch.float32)
    ms = device_ms(lambda: kern(table, ids), 50)
    plain_ms = device_ms(lambda: plain(table, ids), 20)
    lib_ms = device_ms(lambda: torch.nn.functional.embedding(ids, table), 50)
    rec = dict(table=[h, d], dtype=str(dtype), ids=n, rows_read=rows_read,
               max_abs_err=err,
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


# ---------------------------------------------------------------------------
# phases 31-35: the detection models
# ---------------------------------------------------------------------------
SSD_STEPS, YOLO_STEPS = 20, 10
#: distinct synthetic batches each trainer cycles over
DET_SEEDS = 4
#: phase 35's limits, card against the port on the CPU in fp32 with TF32 off,
#: set before the first card run: YOLOv3's as the CPU tests hold the port
#: against the JAX package (tests/test_torch_ssd_yolo.py: 1e-5 of the
#: largest magnitude, the gradients of the largest gradient); MobileNet-SSD's
#: loss 1e-4 of itself (its own loss moves by up to 1.2e-5 under a one-ulp
#: change of the images, the same file); NMS outputs and op results as the
#: CPU tests hold them
DET_TOL = {"loss_rel": 1e-5, "grad_gap_of_max": 1e-5, "param_gap_rel": 1e-5,
           "ssd_loss_rel": 1e-4, "op": 1e-5}


def no_sync(fn):
    """``fn()`` with the card refusing every synchronisation (a host read of
    a device value, a blocking copy): it raises if ``fn`` makes one."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def det_batches(mod, cfg, batch, keys, n, device="cuda"):
    return [{k: torch.as_tensor(v, device=device)
             for k, v in mod.synthetic_batch(cfg, batch, seed=s).items()
             if k in keys} for s in range(n)]


def phase_train_detection(K, pt, label, mod, cfg, steps, keys, want_of,
                          card, probes):
    """``steps`` steps of ``mod``'s training program through
    ``Executor.prepare`` and ``Executor.run`` on the card, over
    ``DET_SEEDS`` synthetic batches cycled, the launch counts set to 0 just
    before and read just after: exactly ``want_of(trainable tensors)``
    launches per step, nothing else registered; the loss finite and the
    mean of the last five steps below the first five's. ``probes(exe,
    built, scope, batch)`` adds the records of work timed alone. Returns
    (record, (built, exe, scope))."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    built = mod.build_train(pt, cfg)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(built["startup"], scope=scope)
    params = trainable(built["main"])
    want = want_of(len(params))
    batches = det_batches(mod, cfg, cfg.batch, keys, DET_SEEDS)
    spec = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in batches[0].items()}
    t0 = time.perf_counter()
    check(exe.prepare(built["main"], feed=spec, fetch_list=[built["loss"]],
                      scope=scope), f"{label}: prepare")
    prepare_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    K.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        (loss,) = exe.run(built["main"], feed=batches[i % DET_SEEDS],
                          fetch_list=[built["loss"]], scope=scope,
                          return_numpy=False)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = K.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    for name, n in counts.items():
        check(n == want.get(name, 0) * steps,
              f"{label}: {n} {name} launches in {steps} steps, expected "
              f"{want.get(name, 0)} per step")
    check(exe.trace_count == 1, f"{label}: {exe.trace_count} runners built; "
                                "prepare's should serve every step")
    check(all(math.isfinite(x) for x in losses), f"{label}: {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"{label}: loss {first} over the first 5 steps, "
                        f"{last} over the last 5")
    steady = statistics.median(step_ms[5:])
    log_card(f"after {label}'s counted steps")
    prof = op_breakdown(lambda: exe.run(
        built["main"], feed=batches[0], fetch_list=[built["loss"]],
        scope=scope, return_numpy=False), top=12, host_top=8)
    rec = dict(
        image_size=cfg.image_size, classes=cfg.num_classes, batch=cfg.batch,
        steps=steps, params=len(params), prepare_ms=prepare_ms,
        first_step_ms=step_ms[0], ms_per_step_steady=steady,
        ms_per_step_quartiles=statistics.quantiles(step_ms[5:], n=4),
        images_per_s=cfg.batch / steady * 1e3,
        loss_first5_last5=[first, last], loss_first=losses[0],
        loss_last=losses[-1], losses=losses,
        launches_per_step={k: v // steps for k, v in counts.items() if v},
        device_events_per_step=prof.get("launches"),
        device_ms_per_step=prof.get("kernel_ms"),
        device_busy_share=(prof.get("kernel_ms", 0.0) / steady
                           if prof else None),
        peak_gb=peak, card=card, profile=prof,
        launches={k: v for k, v in counts.items() if v})
    rec.update(probes(exe, built, scope, batches[0]))
    if prof and rec.get("loss_op_ms"):
        rec["loss_op_share"] = rec["loss_op_ms"] / prof["kernel_ms"]
    log(f"{label}: {steps} steps at batch {cfg.batch}, loss {losses[0]:.3f}"
        f" -> {losses[-1]:.3f}, {steady:.2f} ms/step, "
        f"{rec['images_per_s']:.1f} images/s, peak {peak:.2f} GB [{card}]")
    log(label.replace("-", "_") + " " + json.dumps(rec))
    return rec, (built, exe, scope)


#: the labels of the probes whose device time the profiler did not record
#: (``timed_alone``'s "not measured"), listed in the last line
UNMEASURED = []


def timed_alone(fn, label, refuse_sync=True):
    """One call of ``fn`` with synchronisation refused (``refuse_sync``),
    then its wall-clock ms per call (host clock to a synchronize, 3 calls)
    and, from one profiled call, its device time (the sum of its kernels'
    times: thousands of launches overrun the launch queue behind a spin,
    so ``events_ms`` cannot hold them) and device events."""
    if refuse_sync:
        no_sync(fn)
    wall = host_ms(fn, 3)
    # the profiler at times records no device time for a short call: up to
    # three profiled calls, then "not measured"
    for _ in range(3):
        prof = op_breakdown(fn, top=6)
        if prof:
            break
    ms = prof.get("kernel_ms")
    if ms is None:
        UNMEASURED.append(label)
    kernels = ("no device time recorded by the profiler (not measured)"
               if ms is None else f"{ms:.3f} ms of kernels")
    log(f"  {label}: {kernels}, {prof.get('launches')} device events, "
        f"{wall:.3f} ms wall-clock")
    return dict(ms=ms, wall_ms=wall, device_events=prof.get("launches"),
                profile=prof)


def ssd_probes(ops):
    def probes(exe, built, scope, batch):
        locs, confs, box, var = exe.run(
            built["infer"], feed={"image": batch["image"]},
            fetch_list=[built["locs"], built["confs"], built["box"],
                        built["box_var"]], scope=scope, return_numpy=False)
        loc_p = locs.detach().requires_grad_()
        conf_p = confs.detach().requires_grad_()

        def loss_fb():
            loss = ops.ssd_loss(loc_p, conf_p, batch["gt_box"],
                                batch["gt_label"], box, var).sum()
            return torch.autograd.grad(loss, [loc_p, conf_p])
        r = timed_alone(loss_fb, "ssd_loss forward and backward")
        return dict(loss_op_ms=r["ms"], loss_op_wall_ms=r["wall_ms"],
                    loss_op_device_events=r["device_events"],
                    loss_op_profile=r["profile"])
    return probes


def yolo_probes(ops, yolov3, cfg):
    def probes(exe, built, scope, batch):
        outs = exe.run(built["infer"], feed={"image": batch["image"],
                                            "im_size": torch.full(
                                                (cfg.batch, 2),
                                                cfg.image_size,
                                                dtype=torch.int32,
                                                device="cuda")},
                       fetch_list=built["outputs"], scope=scope,
                       return_numpy=False)
        xs = [o.detach().requires_grad_() for o in outs]

        def loss_fb():
            total = sum(ops.yolov3_loss(
                x, batch["gt_box"], batch["gt_label"], list(yolov3.ANCHORS),
                list(yolov3.ANCHOR_MASKS[i]), cfg.num_classes,
                cfg.ignore_thresh, 32 // 2 ** i, gt_score=batch["gt_score"],
                use_label_smooth=cfg.label_smooth).mean()
                for i, x in enumerate(xs))
            return torch.autograd.grad(total, xs)
        r = timed_alone(loss_fb, "yolov3_loss x3 forward and backward")
        rec = dict(loss_op_ms=r["ms"], loss_op_wall_ms=r["wall_ms"],
                   loss_op_device_events=r["device_events"],
                   loss_op_profile=r["profile"])
        for c, hw in ((cfg.ch(256), cfg.image_size // 32),
                      (cfg.ch(128), cfg.image_size // 16)):
            route = torch.randn(cfg.batch, c, hw, hw, device="cuda",
                                requires_grad=True)
            dy = torch.randn(cfg.batch, c, 2 * hw, 2 * hw, device="cuda")

            def up():
                y = ops.resize_nearest(route, scale=2.0)
                return torch.autograd.grad(y, route, dy)
            rec[f"resize_nearest_ms_{c}x{hw}"] = timed_alone(
                up, f"resize_nearest [{cfg.batch},{c},{hw},{hw}] x2 "
                    "forward and backward", refuse_sync=False)["ms"]
        return rec
    return probes


def phase_infer_detection(pt, label, built, scope, feed, nms_alone, card):
    """The inference program over a trained scope: 5 timed runs after one
    warm-up (host clock to the numpy result), peak memory, and the NMS
    function alone on the same tensors (``nms_alone()`` returns the output
    the program must equal, and the call to time)."""
    exe = pt.Executor()

    def run():
        return exe.run(built["infer"], feed=feed, fetch_list=[built["nmsed"]],
                       scope=scope)[0]
    out = run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = run()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    b = out.shape[0]
    check(out.ndim == 3 and out.shape[2] == 6, f"{label}: {out.shape}")
    check(bool((out[..., 0] >= -1).all()) and (out[..., 0] >= 0).any(),
          f"{label}: no detection kept")
    want, call = nms_alone()
    got = no_sync(call)
    check(torch.equal(got[..., 0], want[..., 0])
          and within(got, want, 1e-5, 1e-5),
          f"{label}: NMS alone differs from the program's output")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base2 = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    nms_peak = (torch.cuda.max_memory_allocated() - base2) / 1e9
    nms = timed_alone(call, f"{label}: NMS alone")
    lat = statistics.median(ms)
    rec = dict(batch=b, latency_ms=lat, latency_ms_all=ms,
               images_per_s=b / lat * 1e3, peak_gb=peak,
               kept_per_image=float((out[..., 0] >= 0).sum() / b),
               nms_ms=nms["ms"], nms_device_events=nms["device_events"],
               nms_wall_ms=nms["wall_ms"], nms_peak_gb=nms_peak,
               nms_profile=nms["profile"], card=card)
    log(f"{label}: batch {b} in {lat:.2f} ms, {rec['images_per_s']:.1f} "
        f"images/s, NMS alone {nms['ms']} ms of kernels in "
        f"{nms['device_events']} device events ({nms['wall_ms']:.2f} ms "
        f"wall-clock), peak {peak:.2f} GB [{card}]")
    return rec, out


def phase_infer_ssd(pt, ops, ssd, card, trained):
    built, _, scope = trained
    cfg = ssd.mobilenet_ssd_voc()
    (batch,) = det_batches(ssd, cfg, cfg.infer_batch,
                           ("image", "gt_box", "gt_label"), 1)
    feed = {"image": batch["image"]}

    def nms_alone():
        locs, confs, box, var, out = pt.Executor().run(
            built["infer"], feed=feed,
            fetch_list=[built["locs"], built["confs"], built["box"],
                        built["box_var"], built["nmsed"]], scope=scope,
            return_numpy=False)
        probs = torch.softmax(confs, dim=-1)
        return out, lambda: ops.detection_output(
            locs, probs, box, var, nms_threshold=cfg.nms_threshold)
    rec, out = phase_infer_detection(pt, "infer-ssd-mobilenet", built, scope,
                                     feed, nms_alone, card)
    gl = batch["gt_label"].cpu().numpy()
    gb = batch["gt_box"].cpu().numpy()
    t0 = time.perf_counter()
    m = ops.detection_map(out, [r[r >= 0] for r in gl],
                          [x[r >= 0] for x, r in zip(gb, gl)],
                          cfg.num_classes, ap_type="11point")
    rec.update(detection_map_host_ms=(time.perf_counter() - t0) * 1e3,
               detection_map_11point=m)
    log("infer_ssd_mobilenet " + json.dumps(rec))
    return rec


def phase_infer_yolo(pt, ops, yolov3, card, trained):
    built, _, scope = trained
    cfg = yolov3.yolov3_coco()
    (batch,) = det_batches(yolov3, cfg, cfg.batch, ("image", "im_size"), 1)

    def nms_alone():
        res = pt.Executor().run(built["infer"], feed=batch,
                                fetch_list=built["outputs"]
                                + [built["nmsed"]], scope=scope,
                                return_numpy=False)
        boxes, scores = [], []
        for i, x in enumerate(res[:3]):
            anchors = [a for m in yolov3.ANCHOR_MASKS[i]
                       for a in yolov3.ANCHORS[2 * m:2 * m + 2]]
            bx, sc = ops.yolo_box(x, batch["im_size"], anchors,
                                  cfg.num_classes, cfg.valid_thresh,
                                  32 // 2 ** i)
            boxes.append(bx)
            scores.append(sc.transpose(1, 2))
        bx, sc = torch.cat(boxes, 1), torch.cat(scores, 2)
        return res[3], lambda: ops.multiclass_nms(
            bx, sc, score_threshold=cfg.valid_thresh,
            nms_top_k=cfg.nms_topk, keep_top_k=cfg.nms_posk,
            nms_threshold=cfg.nms_thresh, background_label=-1)
    rec, _ = phase_infer_detection(pt, "infer-yolov3", built, scope, batch,
                                   nms_alone, card)
    log("infer_yolov3 " + json.dumps(rec))
    return rec


def det_train_card_vs_cpu(K, pt, mod, cfg, keys, infer_keys, synced,
                          pre_of, decode, nms):
    """``mod``'s tiny config 3 steps on the card and on the CPU from one set
    of weights (drawn on the CPU), fp32 with TF32 off: per step the loss,
    the first step's gradients and the parameters after; with ``synced``
    each step starts from the CPU's weights on both. Then the inference
    program from the CPU's trained weights on both: the network's outputs
    ``pre_of(built)`` and ``decode(those outputs, feed, device)`` (boxes
    [B, M, 4], scores [B, C, M]) within the limit, and ``nms(boxes,
    scores)`` on the card from the CPU's decoding, equal to the CPU's."""
    import numpy as np
    t = mod.build_train(pt, cfg)
    cpu_exe, card_exe = pt.Executor(pt.CPUPlace()), pt.Executor()
    cpu_scope = pt.Scope()
    cpu_exe.run(t["startup"], scope=cpu_scope)
    names = [n for n, v in t["startup"].global_block().vars.items()
             if v.persistable]

    def snap(scope):
        return {n: scope.find_var(n).cpu().numpy().copy() for n in names}
    card_scope = pt.Scope.from_numpy(snap(cpu_scope), "cuda", t["startup"])
    grads = [p + "@GRAD" for p in trainable(t["main"])]
    losses, first = [], None
    K.reset_launch_counts()
    for step, batch in enumerate(det_batches(mod, cfg, cfg.batch, keys, 3,
                                             "cpu")):
        if synced:
            card_scope = pt.Scope.from_numpy(snap(cpu_scope), "cuda",
                                             t["startup"])
        fetch = [t["loss"]] + (grads if step == 0 and not synced else [])
        card = card_exe.run(t["main"], feed=batch, fetch_list=fetch,
                            scope=card_scope)
        cpu = cpu_exe.run(t["main"], feed=batch, fetch_list=fetch,
                          scope=cpu_scope)
        losses.append((float(card[0]), float(cpu[0])))
        if len(fetch) > 1:
            first = (card[1:], cpu[1:])
    launches = {k: v for k, v in K.launch_counts().items() if v}
    rec = dict(losses_card_cpu=losses, loss_gap_rel=max(
        abs(a - b) / abs(b) for a, b in losses))
    tol = DET_TOL["ssd_loss_rel"] if synced else DET_TOL["loss_rel"]
    check(rec["loss_gap_rel"] <= tol, f"detection-correctness "
          f"{mod.__name__}: losses card/cpu {losses}")
    if not synced:
        gmax = max(float(np.abs(g).max()) for g in first[1])
        gap = max(float(np.abs(a - b).max()) for a, b in zip(*first))
        pgap = max(float(np.abs(card_scope.find_var(n).cpu().numpy()
                                - cpu_scope.find_var(n).numpy()).max())
                   / max(1.0, float(np.abs(cpu_scope.find_var(n).numpy())
                                    .max())) for n in names)
        rec.update(grad_gap_of_max=gap / gmax, param_gap_rel=pgap)
        check(gap <= DET_TOL["grad_gap_of_max"] * gmax,
              f"detection-correctness {mod.__name__}: first-step gradients "
              f"differ by {gap} (largest gradient {gmax})")
        check(pgap <= DET_TOL["param_gap_rel"],
              f"detection-correctness {mod.__name__}: parameters differ by "
              f"{pgap}")
    # inference from the CPU's trained weights on both: the network's
    # outputs and their decoding (exp and sigmoid round differently on the
    # card) within the limit, then NMS on the card from the CPU's decoded
    # boxes and scores equal to the CPU's (near-tied scores one rounding
    # apart would order differently)
    card_scope = pt.Scope.from_numpy(snap(cpu_scope), "cuda", t["startup"])
    (feed,) = det_batches(mod, cfg, cfg.batch, infer_keys, 1, "cpu")
    heads = [exe.run(t["infer"], feed=feed, fetch_list=pre_of(t), scope=sc,
                     return_numpy=False)
             for exe, sc in ((card_exe, card_scope), (cpu_exe, cpu_scope))]
    decoded = [decode(heads[0], feed, "cuda"), decode(heads[1], feed, "cpu")]
    head_gap = max(max_err(a.cpu(), b) / max(1.0, b.abs().max().item())
                   for a, b in zip(list(heads[0]) + list(decoded[0]),
                                   list(heads[1]) + list(decoded[1])))
    check(head_gap <= DET_TOL["op"], f"detection-correctness "
          f"{mod.__name__}: network outputs or their decoding differ by "
          f"{head_gap}")
    outs = [nms(*(x.to(dev) for x in decoded[1])).cpu().numpy()
            for dev in ("cuda", "cpu")]
    check(np.array_equal(outs[0], outs[1]) and (outs[1][..., 0] >= 0).any(),
          f"detection-correctness {mod.__name__}: NMS on the card differs "
          f"from the CPU's at {int((outs[0] != outs[1]).any(-1).sum())} rows")
    rec.update(head_gap=head_gap, nms_kept=int((outs[1][..., 0] >= 0).sum()),
               launches=launches)
    return rec


def det_op_cases(ops, rng):
    """The detection ops' tie and last-writer cases: (name, call) with
    numpy inputs; each runs on the card and on the CPU."""
    import numpy as np

    def boxes(n, lead=(), size=1.0):
        xy = rng.uniform(0, 0.6 * size, lead + (n, 2))
        wh = rng.uniform(0.1 * size, 0.4 * size, lead + (n, 2))
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)
    tie_sc = (np.round(rng.rand(2, 4, 30) * 4) / 4).astype(np.float32)
    bx = boxes(30, (2,))
    iou_tie = np.array([[[0.5, 0.5, 0.2, 0.5], [0.5, 0.5, 0.5, 0.1],
                         [0.3, 0.5, 0.5, 0.5]]], np.float32)
    x_yolo = (rng.randn(2, 3 * 9, 4, 4) * 2).astype(np.float32)
    img = np.array([[64, 64], [64, 64]], np.int32)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    cell00 = {
        "alone": [[0.05, 0.06, 0.3, 0.25]],
        "padded": [[0.05, 0.06, 0.3, 0.25], [0, 0, 0, 0], [0, 0, 0, 0]],
        "first": [[0.07, 0.04, 0.12, 0.2], [0.05, 0.06, 0.3, 0.25]],
        "second": [[0.05, 0.06, 0.3, 0.25], [0.07, 0.04, 0.12, 0.2]]}
    pri = boxes(12)
    gt_pad = np.concatenate([pri[[2, 7]][None],
                             np.zeros((1, 3, 4), np.float32)], 1)
    loc = (rng.randn(1, 12, 4) * 0.1).astype(np.float32)
    conf = rng.randn(1, 12, 3).astype(np.float32)

    def yolo_nms(t):
        b, s = ops.yolo_box(t(x_yolo[:, :24]), t(img), anchors[:6], 3, 0.8,
                            16)
        return ops.multiclass_nms(b, s.transpose(1, 2), background_label=-1,
                                  score_threshold=-1.0, nms_top_k=-1,
                                  keep_top_k=-1)
    cases = [
        ("multiclass_nms tied scores", True, lambda t: ops.multiclass_nms(
            t(bx), t(tie_sc), background_label=-1, score_threshold=0.2,
            nms_top_k=20, keep_top_k=30)),
        ("multiclass_nms tied scores, eta 0.9", True,
         lambda t: ops.multiclass_nms(t(bx), t(tie_sc), background_label=1,
                                      score_threshold=0.0, nms_top_k=-1,
                                      nms_threshold=0.7, keep_top_k=-1,
                                      nms_eta=0.9)),
        ("multiclass_nms every score equal", True,
         lambda t: ops.multiclass_nms(t(bx), t(np.full_like(tie_sc, 0.5)),
                                      background_label=-1, nms_top_k=6,
                                      keep_top_k=20)),
        ("yolo_box all-zero scores then NMS", True, yolo_nms),
        ("bipartite_match equal IoUs", False,
         lambda t: ops.bipartite_match(t(iou_tie), "per_prediction", 0.4)),
        ("ssd_loss padded gt", False, lambda t: ops.ssd_loss(
            t(loc), t(conf), t(gt_pad),
            t(np.array([[1, 2, -1, -1, -1]], np.int32)), t(pri))),
        ("interpolate bilinear down", False, lambda t: ops.interpolate(
            t(x_yolo), (3, 2), resample="BILINEAR", align_corners=False)),
        ("interpolate nearest 2x", False, lambda t: ops.resize_nearest(
            t(x_yolo), scale=2.0)),
    ]
    for key, rows in cell00.items():
        gt = np.array([rows], np.float32)
        lab = np.arange(len(rows), dtype=np.int32)[None] % 4
        cases.append((f"yolov3_loss cell (0, 0), {key}", False,
                      lambda t, gt=gt, lab=lab: ops.yolov3_loss(
                          t(x_yolo[:1]), t(gt), t(lab), anchors, [0, 1, 2],
                          4, 0.7, 8)))
    return cases


def phase_detection_checks(K, pt, ops, ssd, yolov3, card):
    """Phase 35 (see the module docstring); returns the card's launches of
    the tiny trainers."""
    import numpy as np
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        ycfg, scfg = yolov3.yolo_tiny(), ssd.ssd_tiny()

        def yolo_decode(xs, feed, dev):
            boxes, scores = [], []
            for i, x in enumerate(xs):
                anchors = [a for m in yolov3.ANCHOR_MASKS[i]
                           for a in yolov3.ANCHORS[2 * m:2 * m + 2]]
                b, sc = ops.yolo_box(x.to(dev), feed["im_size"].to(dev),
                                     anchors, ycfg.num_classes,
                                     ycfg.valid_thresh, 32 // 2 ** i)
                boxes.append(b)
                scores.append(sc.transpose(1, 2))
            return torch.cat(boxes, 1), torch.cat(scores, 2)

        def yolo_nms(boxes, scores):
            return ops.multiclass_nms(
                boxes, scores, score_threshold=ycfg.valid_thresh,
                nms_top_k=ycfg.nms_topk, keep_top_k=ycfg.nms_posk,
                nms_threshold=ycfg.nms_thresh, background_label=-1)

        def ssd_decode(heads, feed, dev):
            # detection_output's two stages: box_coder's decode and, on the
            # softmax-ed scores, multiclass_nms
            locs, confs, box, var = (h.to(dev) for h in heads)
            return (ops.box_coder(box, var, locs, "decode_center_size"),
                    torch.softmax(confs, -1).transpose(1, 2))

        def ssd_nms(boxes, scores):
            return ops.multiclass_nms(boxes, scores, score_threshold=0.01,
                                      nms_top_k=400, keep_top_k=200,
                                      nms_threshold=scfg.nms_threshold)
        yolo = det_train_card_vs_cpu(
            K, pt, yolov3, ycfg, ("image", "gt_box", "gt_label", "gt_score"),
            ("image", "im_size"), False, lambda b: b["outputs"],
            yolo_decode, yolo_nms)
        ssd_rec = det_train_card_vs_cpu(
            K, pt, ssd, scfg, ("image", "gt_box", "gt_label"), ("image",),
            True, lambda b: [b["locs"], b["confs"], b["box"], b["box_var"]],
            ssd_decode, ssd_nms)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    ops_rec = {}
    for name, nms, call in det_op_cases(ops, np.random.RandomState(35)):
        outs = [call(lambda a, d=d: torch.as_tensor(a, device=d))
                for d in ("cuda", "cpu")]
        got, want = [[o.detach().cpu() for o in (x if isinstance(
            x, (tuple, list)) else [x])] for x in outs]
        for g, w in zip(got, want):
            if nms:
                check(torch.equal(g[..., 0], w[..., 0]),
                      f"detection-correctness: {name}: labels or kept set")
            if not w.is_floating_point():
                check(torch.equal(g, w), f"detection-correctness: {name}")
            else:
                scale = max(1.0, w.abs().max().item())
                check(max_err(g, w) <= DET_TOL["op"] * scale,
                      f"detection-correctness: {name}: {max_err(g, w)}")
        ops_rec[name] = max((max_err(g, w) for g, w in zip(got, want)
                             if w.is_floating_point()), default=0.0)
    rec = dict(yolo_tiny=yolo, ssd_tiny=ssd_rec, ops_max_err=ops_rec,
               card=card)
    log("detection_correctness " + json.dumps(rec))
    launches = dict(yolo["launches"])
    for k, v in ssd_rec["launches"].items():
        launches[k] = launches.get(k, 0) + v
    return dict(rec, launches=launches)


# ---------------------------------------------------------------------------
# phases 36-38: CycleGAN and the rest of ops/nn.py
# ---------------------------------------------------------------------------
CG_ITERS = 8
#: phase 38's limits, set before the first card run: losses relative to the
#: loss; first-iteration generator gradients against the largest; the
#: parameters after 3 iterations at most 6 learning rates apart (each Adam
#: step moves a value by about the rate, either way where a gradient within
#: rounding of 0 changes sign) and no more than a 1e-3 share of them off by
#: over 1e-5; the ops' values and input gradients relative to their largest
#: value; the kink gradients within 1e-6 (``relu`` and ``abs`` exactly the
#: JAX values)
CG_TOL = {"loss_rel": 1e-4, "grad_gap_of_max": 1e-4, "param_gap": 1.2e-3,
          "param_share_off": 1e-3, "op": 1e-4}


def cg_programs(built):
    """{program: (Program, feed names, fetch list)} of the three trainers."""
    return {
        "G": (built["main"], ("input_A", "input_B"),
              [built["g_loss"], built["fake_A"], built["fake_B"]]),
        "D_A": (built["d_a"], ("input_B", "fake_pool_B"),
                [built["d_a_loss"]]),
        "D_B": (built["d_b"], ("input_A", "fake_pool_A"),
                [built["d_b_loss"]])}


def cg_iteration(exe, built, scope, a, b, pools, ms):
    """``cycle_gan.train_iteration`` with each program's host wall-clock to
    its fetch appended to ``ms``; returns the three losses."""
    progs = cg_programs(built)
    t0 = time.perf_counter()
    g_loss, fake_a, fake_b = exe.run(progs["G"][0], feed={
        "input_A": a, "input_B": b}, fetch_list=progs["G"][2], scope=scope)
    t1 = time.perf_counter()
    pool_a, pool_b = pools["A"].pool_image(fake_a), pools["B"].pool_image(
        fake_b)
    t2 = time.perf_counter()
    (d_a,) = exe.run(progs["D_A"][0], feed={"input_B": b,
                                            "fake_pool_B": pool_b},
                     fetch_list=progs["D_A"][2], scope=scope)
    t3 = time.perf_counter()
    (d_b,) = exe.run(progs["D_B"][0], feed={"input_A": a,
                                            "fake_pool_A": pool_a},
                     fetch_list=progs["D_B"][2], scope=scope)
    t4 = time.perf_counter()
    for k, dt in (("G", t1 - t0), ("D_A", t3 - t2), ("D_B", t4 - t3)):
        ms[k].append(dt * 1e3)
    return float(g_loss), float(d_a), float(d_b)


def phase_train_cycle_gan(K, pt, cg, card):
    """Phase 36 (see the module docstring). Returns (record, (built, exe,
    scope))."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = cg.cyclegan_256()
    t0 = time.perf_counter()
    built = cg.build_train(pt, cfg)
    build_s = time.perf_counter() - t0
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(built["startup"], scope=scope)
    S = cfg.image_size
    progs = cg_programs(built)
    t0 = time.perf_counter()
    for name, (prog, feeds, fetch) in progs.items():
        check(exe.prepare(prog, feed={n: ((cfg.batch, 3, S, S), "float32")
                                      for n in feeds},
                          fetch_list=fetch, scope=scope),
              f"train-cycle-gan: prepare {name}")
    prepare_ms = (time.perf_counter() - t0) * 1e3
    n_params = {k: len(built[f"{p}_params"]) for k, p in
                (("G", "g"), ("D_A", "d_a"), ("D_B", "d_b"))}
    want = sum(n_params.values())
    check(n_params == {"G": 142, "D_A": 13, "D_B": 13},
          f"train-cycle-gan: trainable tensors {n_params}")
    images = [cg.synthetic_images(cfg, cfg.batch, seed=i)
              for i in range(CG_ITERS)]
    pools = {"A": cg.ImagePool(cfg.pool_size, seed=1),
             "B": cg.ImagePool(cfg.pool_size, seed=2)}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    ms = {k: [] for k in progs}
    losses = [cg_iteration(exe, built, scope, a, b, pools, ms)
              for a, b in images]
    counts = K.launch_counts()
    peak = peak_since(base)
    check({k: v for k, v in counts.items() if v} == {
        "fused_adam": want * CG_ITERS},
        f"train-cycle-gan: launches {counts} in {CG_ITERS} iterations, "
        f"expected {want} fused_adam an iteration and nothing else")
    check(exe.trace_count == 3, f"train-cycle-gan: {exe.trace_count} "
                                "runners built; prepare's should serve")
    check(all(math.isfinite(x) for row in losses for x in row),
          f"train-cycle-gan: {losses}")
    log_card("after train-cycle-gan's counted iterations")
    a, b = images[0]
    pa, pb = pools["A"].pool[0], pools["B"].pool[0]
    feeds = {"G": {"input_A": a, "input_B": b},
             "D_A": {"input_B": b, "fake_pool_B": pb},
             "D_B": {"input_A": a, "fake_pool_A": pa}}
    rec = dict(image_size=S, batch=cfg.batch, ngf=cfg.ngf, ndf=cfg.ndf,
               blocks=cfg.n_blocks, iterations=CG_ITERS, build_s=build_s,
               prepare_ms=prepare_ms, params=n_params,
               param_values={k: cg.param_count(progs[k][0], built[
                   f"{p}_params"]) for k, p in (("G", "g"), ("D_A", "d_a"),
                                                ("D_B", "d_b"))},
               losses=losses, peak_gb=peak, card=card,
               launches_per_iteration={"fused_adam": want},
               launches={k: v for k, v in counts.items() if v})
    for name, (prog, _, fetch) in progs.items():
        steady = statistics.median(ms[name][2:])
        prof = op_breakdown(lambda prog=prog, fetch=fetch, feed=feeds[name]:
                            exe.run(prog, feed=feed, fetch_list=fetch,
                                    scope=scope, return_numpy=False),
                            top=8, host_top=6)
        rec[name] = dict(
            first_ms=ms[name][0], ms_steady=steady, ms_all=ms[name],
            fused_adam_per_step=n_params[name],
            device_events=prof.get("launches"),
            device_ms=prof.get("kernel_ms"),
            device_busy_share=(prof.get("kernel_ms", 0.0) / steady
                               if prof else None), profile=prof)
    it_ms = sum(rec[k]["ms_steady"] for k in progs)
    rec.update(iteration_ms=it_ms, images_per_s=cfg.batch / it_ms * 1e3)
    log(f"train-cycle-gan: {CG_ITERS} iterations at {S}^2 batch "
        f"{cfg.batch}: G {rec['G']['ms_steady']:.2f} ms, D_A "
        f"{rec['D_A']['ms_steady']:.2f} ms, D_B {rec['D_B']['ms_steady']:.2f}"
        f" ms, busy G {rec['G']['device_busy_share']}, {want} fused_adam an "
        f"iteration, peak {peak:.2f} GB [{card}]")
    log("train_cycle_gan " + json.dumps(rec))
    return rec, (built, exe, scope)


def phase_infer_cycle_gan(pt, cg, card, trained):
    """Phase 37: both generators of the inference program over phase 36's
    scope at batch 1 and 8: latency (median of 10 after 3 warm-up) and
    time per image (two images translated per input pair)."""
    built, exe, scope = trained
    cfg = cg.cyclegan_256()
    rec = dict(card=card)
    for batch in (1, 8):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        a, b = cg.synthetic_images(cfg, batch, seed=100 + batch)
        feed = {"input_A": torch.as_tensor(a, device="cuda"),
                "input_B": torch.as_tensor(b, device="cuda")}

        def run(feed=feed):
            return exe.run(built["infer"], feed=feed,
                           fetch_list=[built["fake_A"], built["fake_B"]],
                           scope=scope, return_numpy=False)
        outs = run()
        for o in outs:
            check(tuple(o.shape) == (batch, 3, cfg.image_size,
                                     cfg.image_size)
                  and bool(torch.isfinite(o).all())
                  and float(o.abs().max()) <= 1.0,
                  f"infer-cycle-gan: batch {batch} output")
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(lat)
        prof = op_breakdown(run, top=6)
        rec[f"batch_{batch}"] = dict(
            ms=med, ms_quartiles=statistics.quantiles(lat, n=4),
            ms_per_image=med / (2 * batch), images_per_s=2 * batch / med * 1e3,
            device_events=prof.get("launches"),
            device_ms=prof.get("kernel_ms"),
            device_busy_share=prof.get("kernel_ms", 0.0) / med if prof
            else None, peak_gb=peak_since(base), profile=prof)
        log(f"infer-cycle-gan: batch {batch}: {med:.2f} ms, "
            f"{med / (2 * batch):.3f} ms an image [{card}]")
    log("infer_cycle_gan " + json.dumps(rec))
    return rec


def nn_op_cases(ops, rng):
    """(name, op, args, keyword args) of every op of the slice (ops/nn.py's
    remaining 24 and the 5 metric ops), the args numpy arrays drawn once;
    CycleGAN 256's shapes where it has them."""
    import numpy as np

    def f(*shape, lo=-2.0, hi=2.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)
    x128, x5 = f(1, 128, 64, 64), f(2, 3, 5, 6, 6)
    tied = np.round(rng.uniform(0, 2, (1, 2, 7, 9))).astype(np.float32)
    scores = (np.round(rng.uniform(0, 1, (40, 6)) * 4) / 4).astype(
        np.float32)
    labels = rng.randint(0, 6, (40, 1))
    tags = rng.randint(0, 7, 60)
    return [
        ("conv2d_transpose c4 [1,128,64,64]", ops.conv2d_transpose,
         (x128, f(128, 64, 3, 3) * 0.05), dict(stride=2, padding=1)),
        ("pad2d reflect [1,3,256,256]", ops.pad2d, (f(1, 3, 256, 256),),
         dict(paddings=[3, 3, 3, 3], mode="reflect")),
        ("pad2d [0,1,0,1] [1,64,127,127]", ops.pad2d, (f(1, 64, 127, 127),),
         dict(paddings=[0, 1, 0, 1])),
        ("pad2d edge", ops.pad2d, (f(2, 3, 5, 5),),
         dict(paddings=[0, 2, 1, 3], mode="edge")),
        ("instance_norm [1,128,64,64]", ops.instance_norm,
         (x128, f(128), f(128)), {}),
        ("layer_norm", ops.layer_norm, (f(4, 3, 8, 8), f(192), f(192)), {}),
        ("group_norm", ops.group_norm, (f(2, 6, 8, 8), f(6), f(6)),
         dict(groups=3)),
        ("depthwise_conv2d", ops.depthwise_conv2d,
         (f(2, 8, 16, 16), f(8, 1, 3, 3)), dict(padding=1)),
        ("conv3d", ops.conv3d, (x5, f(4, 3, 3, 3, 3)), dict(padding="SAME")),
        ("conv3d_transpose", ops.conv3d_transpose, (x5, f(3, 2, 3, 3, 3)),
         dict(stride=2, padding=1)),
        ("pool3d max", ops.pool3d, (x5,), dict(pool_size=2, pool_stride=2)),
        ("pool3d avg padded", ops.pool3d, (x5,),
         dict(pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1)),
        ("adaptive_pool2d avg windows", ops.adaptive_pool2d,
         (f(2, 3, 7, 9),), dict(pool_size=(3, 4), pool_type="avg")),
        ("adaptive_pool2d max ties", ops.adaptive_pool2d, (tied,),
         dict(pool_size=(3, 4), pool_type="max")),
        ("adaptive_pool3d", ops.adaptive_pool3d, (f(1, 2, 5, 7, 6),),
         dict(pool_size=(2, 3, 4), pool_type="avg")),
        ("sync_batch_norm", ops.sync_batch_norm,
         (f(4, 3, 5, 5), f(3), f(3), f(3), f(3, lo=0.5)), {}),
        ("data_norm", ops.data_norm,
         (f(4, 3), np.full(3, 10.0, np.float32), f(3),
          f(3, lo=30.0, hi=40.0)), {}),
        ("one_hot", ops.one_hot, (rng.randint(-2, 7, (6, 1)),),
         dict(depth=5)),
        ("label_smooth", ops.label_smooth, (f(4, 5, lo=0, hi=1),),
         dict(epsilon=0.2)),
        ("lrn", ops.lrn, (f(2, 7, 4, 4),), dict(n=5, k=2.0, alpha=1e-2)),
        ("pad", ops.pad, (f(2, 3, 4),),
         dict(paddings=[1, 0, 0, 2, 3, 1], pad_value=0.5)),
        ("pad_constant_like", ops.pad_constant_like,
         (f(4, 5, 6), f(2, 3, 6)), dict(pad_value=1.5)),
        ("pixel_shuffle", ops.pixel_shuffle, (f(2, 8, 3, 3),),
         dict(upscale_factor=2)),
        ("affine_channel", ops.affine_channel, (f(2, 3, 4, 4), f(3), f(3)),
         {}),
        ("unfold", ops.unfold, (f(2, 3, 6, 6),),
         dict(kernel_sizes=3, strides=2, paddings=1)),
        ("space_to_depth", ops.space_to_depth, (f(2, 3, 4, 6),),
         dict(blocksize=2)),
        ("shuffle_channel", ops.shuffle_channel, (f(2, 6, 3, 3),),
         dict(group=3)),
        ("fc_act", ops.fc_act, (f(3, 4),), dict(act="relu")),
        ("accuracy top-3 ties", ops.accuracy, (scores, labels), dict(k=3)),
        ("auc bin edges", ops.auc,
         ((rng.randint(0, 9, 64) / 8).astype(np.float32),
          rng.randint(0, 2, 64)), dict(num_thresholds=8)),
        ("precision_recall", ops.precision_recall, (scores, labels),
         dict(num_classes=6)),
        ("chunk_eval", ops.chunk_eval, (tags, np.roll(tags, 1)),
         dict(chunk_scheme="IOB", num_chunk_types=3)),
        ("positive_negative_pair", ops.positive_negative_pair,
         (np.round(rng.uniform(0, 1, 50) * 5) / 5, rng.randint(0, 3, 50),
          rng.randint(0, 6, 50)), {}),
    ]


def kink_cases(ops):
    """(name, op, args, keyword args) of F9's kink gradients: each input on
    a kink of its op (relu, relu6, hard_sigmoid, hard_swish, clip,
    clip_by_norm, abs, l1_norm and four losses)."""
    import numpy as np

    def a(*v):
        return np.array(v, np.float32)
    return [
        ("relu", ops.relu, (a(0.0, 1.5, -2.0),), {}),
        ("relu6", ops.relu6, (a(0.0, 6.0, 3.0),), {}),
        ("hard_sigmoid", ops.hard_sigmoid, (a(2.0, -2.0, 0.0),),
         dict(slope=0.25)),
        ("hard_swish", ops.hard_swish, (a(-3.0, 3.0, 1.0),), {}),
        ("clip", ops.clip, (a(-1.0, 2.0, 0.5),), dict(min=-1.0, max=2.0)),
        ("clip_by_norm", ops.clip_by_norm, (a(3.0, 4.0),),
         dict(max_norm=5.0)),
        ("abs", ops.abs, (a(0.0, -1.0),), {}),
        ("l1_norm", ops.l1_norm, (a(0.0, 1.0),), {}),
        ("sigmoid_cross_entropy_with_logits",
         ops.sigmoid_cross_entropy_with_logits,
         (a(0.0, 0.0), a(0.0, 0.25)), {}),
        ("teacher_student_sigmoid_loss", ops.teacher_student_sigmoid_loss,
         (a(0.0, 15.0), a(1.0, 0.0)), {}),
        ("hinge_loss", ops.hinge_loss, (a(1.0, -1.0), a(1.0, 0.0)), {}),
        ("margin_rank_loss", ops.margin_rank_loss,
         (a(1.0, -1.0), a(0.75, 1.0), a(0.5, 1.25)), dict(margin=0.25)),
    ]


def op_card_vs_cpu(fn, args, kw, cot_seed=None, count_outputs=False):
    """``fn(*args, **kw)`` on the card and on the CPU, the float args
    leaves: the outputs and the input gradients under one seeded cotangent
    (ones without a seed: the gradient of the sum), as (card, cpu) lists of
    CPU tensors; a host result (a metric's numbers) as it is.
    ``count_outputs``: the number of outputs (the gradients follow them)
    comes third."""
    import numpy as np
    res, n_out = [], 1
    for dev in ("cuda", "cpu"):
        xs = [torch.as_tensor(v, device=dev) for v in args]
        leaves = [x.requires_grad_() for x in xs if x.is_floating_point()]
        out = fn(*xs, **kw)
        if not isinstance(out, torch.Tensor) and not (
                isinstance(out, (tuple, list)) and out
                and isinstance(out[0], torch.Tensor)):
            res.append([out])
            continue
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        n_out = len(outs)
        diff = [o for o in outs if o.requires_grad]
        rs = np.random.RandomState(cot_seed)
        cots = [torch.ones_like(o) if cot_seed is None else torch.as_tensor(
            np.asarray(rs.randn(*o.shape), np.float32), device=dev)
            for o in diff]
        grads = (torch.autograd.grad(diff, leaves, cots, allow_unused=True)
                 if diff else [])
        res.append([o.detach().cpu() for o in outs]
                   + [g.detach().cpu() for g in grads if g is not None])
    return (*res, n_out) if count_outputs else res


def cg_tiny_card_vs_cpu(K, pt, cg):
    """``cyclegan_tiny``'s three programs 3 iterations on the card and on
    the CPU from one set of weights (the CPU startup's) and the same pool
    draws, fp32 with TF32 off: losses, the first generator step's
    gradients, the persistables after; the card's launches."""
    import numpy as np
    cfg = cg.cyclegan_tiny()
    built = cg.build_train(pt, cfg)
    cpu_exe, card_exe = pt.Executor(pt.CPUPlace()), pt.Executor()
    cpu_scope = pt.Scope()
    cpu_exe.run(built["startup"], scope=cpu_scope)
    names = [n for n, v in built["startup"].global_block().vars.items()
             if v.persistable]
    init = {n: cpu_scope.find_var(n).numpy().copy() for n in names}
    card_scope = pt.Scope.from_numpy(init, "cuda", built["startup"])
    a, b = cg.synthetic_images(cfg, cfg.batch, seed=0)
    grads = [p + "@GRAD" for p in built["g_params"]]
    # the first generator step's gradients, each device from the same
    # weights in a scope of its own
    first = [exe.run(built["main"], feed={"input_A": a, "input_B": b},
                     fetch_list=grads,
                     scope=pt.Scope.from_numpy(init, dev, built["startup"]))
             for exe, dev in ((card_exe, "cuda"), (cpu_exe, "cpu"))]
    gmax = max(float(np.abs(g).max()) for g in first[1])
    ggap = max(float(np.abs(x - y).max()) for x, y in zip(*first))
    pools = [{"A": cg.ImagePool(cfg.pool_size, seed=1),
              "B": cg.ImagePool(cfg.pool_size, seed=2)} for _ in range(2)]
    K.reset_launch_counts()
    losses = []
    for it in range(3):
        a, b = cg.synthetic_images(cfg, cfg.batch, seed=it)
        losses.append(tuple(
            [float(v) for v in cg.train_iteration(exe, built, sc, a, b, p)]
            for exe, sc, p in ((card_exe, card_scope, pools[0]),
                               (cpu_exe, cpu_scope, pools[1]))))
    launches = {k: v for k, v in K.launch_counts().items() if v}
    gaps, off, total = [], 0, 0
    for n in names:
        c = card_scope.find_var(n).cpu().numpy()
        w = cpu_scope.find_var(n).numpy()
        d = np.abs(c - w) / max(1.0, float(np.abs(w).max()))
        gaps.append(float(d.max()))
        off += int((d > 1e-5).sum())
        total += d.size
    loss_gap = max(abs(x - y) / abs(y) for c, w in losses
                   for x, y in zip(c, w))
    n_upd = len(built["g_params"]) + len(built["d_a_params"]) + len(
        built["d_b_params"])
    rec = dict(losses_card_cpu=losses, loss_gap_rel=loss_gap,
               grad_gap_of_max=ggap / gmax, param_gap=max(gaps),
               param_share_off=off / total, launches=launches)
    check(loss_gap <= CG_TOL["loss_rel"],
          f"nn-correctness: cyclegan_tiny losses card/cpu {losses}")
    check(ggap <= CG_TOL["grad_gap_of_max"] * gmax,
          f"nn-correctness: cyclegan_tiny first G gradients differ by {ggap}"
          f" (largest {gmax})")
    check(max(gaps) <= CG_TOL["param_gap"]
          and off / total <= CG_TOL["param_share_off"],
          f"nn-correctness: cyclegan_tiny parameters {max(gaps)}, "
          f"{off} of {total} off by over 1e-5")
    check(launches == {"fused_adam": 3 * n_upd},
          f"nn-correctness: cyclegan_tiny launches {launches}")
    return rec


def phase_nn_checks(K, pt, ops, cg, card):
    """Phase 38 (see the module docstring); returns the card's launches of
    the tiny trainers."""
    import numpy as np
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        tiny = cg_tiny_card_vs_cpu(K, pt, cg)
        ops_rec = {}
        for i, (name, fn, args, kw) in enumerate(nn_op_cases(
                ops, np.random.RandomState(38))):
            got, want = op_card_vs_cpu(fn, args, kw, i)
            check(len(got) == len(want), f"nn-correctness: {name}: outputs")
            err = 0.0
            for g, w in zip(got, want):
                if not isinstance(w, torch.Tensor):
                    check(g == w, f"nn-correctness: {name}: {g} vs {w}")
                    continue
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"nn-correctness: {name}: {g.shape} {g.dtype}")
                if not w.is_floating_point():
                    check(torch.equal(g, w), f"nn-correctness: {name}")
                    continue
                scale = max(1.0, w.abs().max().item())
                e = max_err(g, w) / scale
                check(e <= CG_TOL["op"], f"nn-correctness: {name}: {e}")
                err = max(err, e)
            ops_rec[name] = err
        kinks = {}
        for i, (name, fn, args, kw) in enumerate(kink_cases(ops)):
            got, want = op_card_vs_cpu(fn, args, kw)
            for g, w in zip(got, want):
                check(max_err(g, w) <= 1e-6 * max(1.0, w.abs().max().item()),
                      f"nn-correctness: kink {name}: {g.tolist()} vs "
                      f"{w.tolist()}")
            kinks[name] = [x.tolist() for x in got[1:]]
        check(kinks["relu"] == [[0.5, 1.0, 0.0]]
              and kinks["abs"] == [[1.0, -1.0]],
              f"nn-correctness: kink halves {kinks['relu']}")
        # F9's program: one SGD step of conv2d(act="relu") over a zero and
        # a ones image on the card takes the bias to -0.375
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), pt.unique_name.guard():
            x = pt.data("x", [1, 1, 1], "float32")
            y = pt.layers.conv2d(
                x, 1, 2, padding=1, act="relu",
                param_attr=pt.ParamAttr(
                    name="w", initializer=pt.initializer.NumpyArrayInitializer(
                        np.array([[[[1.0, -1.0], [-1.0, -1.0]]]]))),
                bias_attr=pt.ParamAttr(
                    name="b", initializer=pt.initializer.Constant(0.0)))
            loss = pt.layers.mean(y)
            pt.optimizer.SGD(1.0).minimize(loss)
        exe, scope = pt.Executor(), pt.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed={"x": np.array([[[[0.0]]], [[[1.0]]]],
                                          np.float32)},
                fetch_list=[loss], scope=scope)
        bias = scope.find_var("b").cpu().tolist()
        check(bias == [-0.375], f"nn-correctness: conv2d+relu bias {bias}")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    rec = dict(cyclegan_tiny=tiny, ops_max_err_of_max=ops_rec,
               kink_grads=kinks, relu_program_bias=bias, card=card)
    log("nn_correctness " + json.dumps(rec))
    return dict(rec, launches=tiny["launches"])


# ---------------------------------------------------------------------------
# phases 39-41: CRNN-CTC (models/crnn_ctc.py), the random ops, ops/misc.py
# and the CTC ops
# ---------------------------------------------------------------------------
CRNN_STEPS = 16
CRNN_BATCHES = 4
#: phase 41's limits, set before the first card run: crnn_ctc_tiny's losses
#: relative to the loss, its first-step gradients against the largest, its
#: persistables after 3 Momentum steps against max(1, largest); the ops'
#: values and input gradients relative to their largest value (integer
#: outputs equal); the random ops' mean and variance within 5 standard
#: errors of the analytic ones
CRNN_TOL = {"loss_rel": 1e-5, "grad_gap_of_max": 1e-5, "param_gap": 1e-5,
            "op": 1e-5, "sigmas": 5.0}
#: the standard deviation of a standard normal truncated to [-2, 2]
TRUNC_STD = 0.8796256610342398


def fused_matmuls_after_passes(built, fetch):
    """(the ``fused_matmul`` ops of the main program after the pass
    pipeline for ``fetch``, those inside the kernel's contract: one launch
    each a forward). A fused op whose addend is not a bias vector (CRNN's
    output fc over [gru_fwd, gru_bwd] becomes a ``mul`` and a
    ``fused_matmul`` adding that ``mul``'s [B, T, 96] output) is outside
    the contract: it runs the plain composition."""
    from paddle_tpu_torch.static import opt_passes
    prog = opt_passes.optimize_for_execution(built["main"],
                                             [v.name for v in fetch])
    blk = prog.global_block()
    fmm = [op for op in blk.ops if op.type == "fused_matmul"]
    return len(fmm), sum(not op.attrs.get("has_bias")
                         or len(blk.var(op.inputs["X"][2]).shape) == 1
                         for op in fmm)


def crnn_feed_spec(cfg, batch):
    return {"pixel": ((batch, 1, cfg.height, cfg.width), "float32"),
            "label": ((batch, cfg.max_label), "int32"),
            "label_length": ((batch,), "int32")}


def phase_train_crnn(K, pt, cr, card):
    """Phase 39 (see the module docstring). Returns (record, (built, exe,
    scope))."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = cr.crnn_ctc()
    t0 = time.perf_counter()
    built = cr.build_train(pt, cfg)
    build_s = time.perf_counter() - t0
    main, loss = built["main"], built["loss"]
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(built["startup"], scope=scope)
    t0 = time.perf_counter()
    check(exe.prepare(main, feed=crnn_feed_spec(cfg, cfg.batch),
                      fetch_list=[loss], scope=scope),
          "train-crnn-ctc: prepare")
    prepare_ms = (time.perf_counter() - t0) * 1e3
    n_params = len(cr.param_names(main))
    n_ops, n_fmm = fused_matmuls_after_passes(built, [loss])
    check(n_params == 43 and (n_ops, n_fmm) == (3, 2),
          f"train-crnn-ctc: {n_params} trainable tensors, {n_ops} fused "
          f"matmul ops, {n_fmm} inside the kernel's contract (expected 43, "
          "3 and 2: fc1 and fc2 launch the kernel)")
    feeds = [cr.feed_of(cr.synthetic_batch(cfg, cfg.batch, seed=i))
             for i in range(CRNN_BATCHES)]

    def step(feed):
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]

    rec = seq_train(
        K, "train-crnn-ctc", step, feeds, CRNN_STEPS,
        {"fused_matmul": n_fmm, "fused_momentum": n_params}, card,
        lambda f: cfg.batch, "images",
        dict(image=[1, cfg.height, cfg.width], batch=cfg.batch,
             time_steps=cfg.time_steps, classes=cfg.num_classes + 1,
             hidden=cfg.hidden, params=n_params,
             param_values=sum(math.prod(main.global_block().var(n).shape)
                              for n in cr.param_names(main)),
             fused_matmul_ops=n_ops, fused_matmul_launches=n_fmm,
             build_s=build_s, prepare_ms=prepare_ms,
             optimizer=f"Momentum({cfg.lr}, {cfg.momentum}), "
                       f"L2Decay({cfg.l2})"))
    check(exe.trace_count == 1, f"train-crnn-ctc: {exe.trace_count} "
                                "runners built; prepare's should serve")
    rec["peak_gb"] = peak_since(base)
    log_card("after train-crnn-ctc's counted steps")
    log("train_crnn_ctc " + json.dumps(rec))
    return rec, (built, exe, scope)


def phase_infer_crnn(K, pt, cr, card, trained):
    """Phase 40: the evaluation program (the ``clone(for_test=True)``:
    network, greedy decoder, edit distance) over phase 39's scope at batch
    32 and 1: latency (median of 10 after 2 warm-up), time per image, the
    decoded lengths, the mean edit distance, device events and busy share
    of one profiled run; exactly 2 ``fused_matmul`` launches a run."""
    built, exe, scope = trained
    cfg = cr.crnn_ctc()
    keys = ("decoded", "decoded_length", "distance")
    fetch = [built[k] for k in keys]
    rec = dict(card=card)
    runs = 0
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for batch in (cfg.batch, 1):
        feed = cr.feed_of(cr.synthetic_batch(cfg, batch, seed=100 + batch))
        ms = []
        for _ in range(12):
            t0 = time.perf_counter()
            dec, dlen, dist = exe.run(built["test"], feed=feed,
                                      fetch_list=fetch, scope=scope)
            ms.append((time.perf_counter() - t0) * 1e3)
        runs += 12
        T = cfg.time_steps
        check(dec.shape == (batch, T) and str(dec.dtype) == "int32"
              and dlen.min() >= 0 and dlen.max() <= T
              and all(math.isfinite(float(d)) and d >= 0 for d in dist),
              f"infer-crnn-ctc: batch {batch}: {dec.shape} {dlen} {dist}")
        prof = op_breakdown(lambda feed=feed: exe.run(
            built["test"], feed=feed, fetch_list=fetch, scope=scope,
            return_numpy=False), top=6, host_top=4)
        runs += 2
        steady = statistics.median(ms[2:])
        rec[f"batch_{batch}"] = dict(
            ms=steady, first_ms=ms[0], ms_all=ms, ms_per_image=steady / batch,
            images_per_s=batch / steady * 1e3,
            decoded_length_mean=float(dlen.mean()),
            decoded_length_max=int(dlen.max()),
            mean_edit_distance=float(dist.mean()),
            device_events=prof.get("launches"),
            device_ms=prof.get("kernel_ms"),
            device_busy_share=(prof.get("kernel_ms", 0.0) / steady
                               if prof else None), profile=prof)
        log(f"infer-crnn-ctc: batch {batch}: {steady:.3f} ms, "
            f"{steady / batch:.3f} ms an image, mean edit distance "
            f"{float(dist.mean()):.4f}, decoded length mean "
            f"{float(dlen.mean()):.2f} [{card}]")
    counts = {k: v for k, v in K.launch_counts().items() if v}
    check(counts == {"fused_matmul": 2 * runs},
          f"infer-crnn-ctc: launches {counts} in {runs} runs, expected 2 "
          "fused_matmul a run")
    rec["launches"] = counts
    log("infer_crnn_ctc " + json.dumps(rec))
    return rec


def misc_op_cases(ops, rng):
    """(name, op, args, keyword args) of every op of the slice but
    ``lookup_table`` (held on its own: it launches the gather) and the
    random ops (held by distribution): ``ops/misc.py``'s 37 and the 5 CTC
    ops, the args numpy arrays drawn once; CRNN-CTC's shapes where it has
    them (im2sequence over [32,128,6,64], the loss and the decoder over
    [32,64,96] with labels 1-24 long, the edit distance of 32 decoded rows
    of 64 against 24). Tie cases: top_k, beam_search, max pooling and the
    decoder's argmax on quantized values."""
    import numpy as np

    def f(*shape, lo=-2.0, hi=2.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def ints(lo, hi, *shape):
        return rng.randint(lo, hi, shape).astype(np.int32)

    def q(*shape):
        return (np.round(rng.uniform(0, 1, shape) * 4) / 4).astype(
            np.float32)
    B, T, C, L = 32, 64, 96, 24
    lens = rng.randint(1, L + 1, B).astype(np.int32)
    labels = ints(0, C - 1, B, L) * (np.arange(L)[None] < lens[:, None])
    labels[:4, 1] = labels[:4, 0]            # repeated labels
    rois = np.array([[0, 1.3, 0.7, 6.2, 5.9], [1, 0.0, 2.1, 10.4, 8.6],
                     [1, 4.5, 3.2, 12.0, 11.0]], np.float32)
    return [
        ("im2sequence [32,128,6,64] [6,1]", ops.im2sequence,
         (f(B, 128, 6, 64),), dict(filter_size=[6, 1], stride=[1, 1])),
        ("warpctc [32,64,96] blank 95 norm_by_times",
         lambda x, lab, ll: ops.warpctc(x, lab, label_length=ll, blank=95,
                                        norm_by_times=True),
         (f(B, T, C), labels, lens), {}),
        ("ctc_loss ragged logit lengths, empty label",
         lambda x, lab, tl, ll: ops.ctc_loss(x, lab, tl, ll, blank=0),
         (f(8, T, 12), ints(1, 12, 8, 10), np.array(
             [64, 50, 33, 64, 10, 1, 64, 20], np.int32),
          np.array([10, 4, 0, 7, 3, 1, 10, 2], np.int32)), {}),
        ("ctc_greedy_decoder [32,64,96] ties",
         lambda x: ops.ctc_greedy_decoder(x, blank=95), (q(B, T, C),), {}),
        ("ctc_align ragged", ops.ctc_align,
         (ints(0, 5, B, T), ints(0, T + 1, B)), dict(blank=0,
                                                     padding_value=-1)),
        ("edit_distance [32,64] vs [32,24]",
         lambda h, r, hl, rl: ops.edit_distance(h, r, hl, rl),
         (ints(0, C, B, T), labels, ints(0, T + 1, B), lens), {}),
        ("edit_distance empty rows, not normalized",
         lambda h, r, hl, rl: ops.edit_distance(h, r, hl, rl, False),
         (ints(0, 4, 6, 9), ints(0, 4, 6, 7),
          np.array([0, 9, 3, 0, 5, 9], np.int32),
          np.array([7, 0, 0, 0, 2, 7], np.int32)), {}),
        ("add_position_encoding", ops.add_position_encoding,
         (f(4, 64, 200),), dict(alpha=0.5, beta=2.0)),
        ("affine_grid", lambda t: ops.affine_grid(t, (2, 3, 16, 20)),
         (f(2, 2, 3),), {}),
        ("grid_sampler", ops.grid_sampler,
         (f(2, 3, 16, 20), f(2, 8, 8, 2, lo=-1.2, hi=1.2)), {}),
        ("bilinear_tensor_product", ops.bilinear_tensor_product,
         (f(8, 16), f(8, 12), f(6, 16, 12), f(6)), {}),
        ("conv_shift", ops.conv_shift, (f(8, 31), f(8, 5)), {}),
        ("row_conv", ops.row_conv, (f(4, 64, 32), f(3, 32)), {}),
        ("similarity_focus", lambda x: ops.similarity_focus(x, 1, [0, 2]),
         (q(2, 3, 8, 9),), {}),
        ("spectral_norm", ops.spectral_norm, (f(16, 3, 3, 3), f(16)),
         dict(power_iters=3)),
        ("spp", ops.spp, (f(2, 8, 13, 17),), dict(pyramid_height=3)),
        ("spp avg", ops.spp, (f(2, 8, 13, 17),),
         dict(pyramid_height=3, pool_type="avg")),
        ("temporal_shift", ops.temporal_shift, (f(8, 16, 7, 7),),
         dict(seg_num=4)),
        ("max_pool2d_with_index ties", ops.max_pool2d_with_index,
         (q(2, 8, 15, 15),), dict(pool_size=3, stride=2, padding=1)),
        ("unpool2d collisions", lambda x, i: ops.unpool2d(x, i, (12, 12)),
         (f(2, 4, 6, 6), ints(0, 144, 2, 4, 6, 6)), {}),
        ("squared_l2_distance", ops.squared_l2_distance,
         (f(16, 5, 4), f(16, 5, 4)), {}),
        ("fsp_matrix", ops.fsp_matrix, (f(2, 8, 9, 9), f(2, 6, 9, 9)), {}),
        ("hash_embedding_ids", lambda i: ops.hash_embedding_ids(i, 100003,
                                                                2),
         (ints(-2 ** 31, 2 ** 31 - 1, 64, 3),), {}),
        ("cvm", ops.cvm, (f(16, 10, lo=0, hi=5),), {}),
        ("tree_conv", ops.tree_conv,
         (f(2, 10, 8), np.round(f(2, 10, 10, lo=0, hi=1)), f(3, 8, 6)),
         {}),
        ("nce", lambda x, w, b, lab, s: ops.nce(x, w, b, lab, s, 50),
         (f(16, 32), f(50, 32), f(50), ints(0, 50, 16), ints(0, 50, 10)),
         {}),
        ("hierarchical_sigmoid",
         lambda x, w, b, lab: ops.hierarchical_sigmoid(x, w, b, lab, 37),
         (f(16, 32), f(36, 32), f(36), ints(0, 37, 16)), {}),
        ("sample_logits", ops.sample_logits,
         (f(16, 50), ints(0, 50, 16), ints(0, 50, 12)), {}),
        ("gru_unit", ops.gru_unit,
         (f(32, 600), f(32, 200), f(200, 400), f(200, 200), f(400),
          f(200)), {}),
        ("lstm_unit", ops.lstm_unit, (f(32, 800), f(32, 200), f(32, 200)),
         {}),
        ("sum", lambda a, b, c: ops.sum([a, b, c]),
         (f(8, 9), f(8, 9), f(8, 9)), {}),
        ("top_k ties", lambda x: ops.top_k(x, 5), (q(16, 40),), {}),
        ("arg_max", lambda x: ops.arg_max(x, 1), (q(16, 40),), {}),
        ("arg_min", lambda x: ops.arg_min(x, 0), (q(16, 40),), {}),
        ("fill_any_like", lambda x: ops.fill_any_like(x, 2.5),
         (f(8, 9),), {}),
        ("fill_zeros_like", ops.fill_zeros_like, (f(8, 9),), {}),
        ("assign_value", lambda ref: ops.assign_value(
            [2, 3], "float32", [1.5, 2, 3, 4, 5, 6.25], device=ref.device),
         (f(1),), {}),
        ("smooth_l1_loss", ops.smooth_l1_loss, (f(16, 4), f(16, 4)),
         dict(sigma=3.0)),
        ("deformable_conv groups 2", lambda x, o, w: ops.deformable_conv(
            x, o, w, 1, 1, 2), (f(2, 8, 12, 12), f(2, 36, 12, 12, lo=-1,
                                                     hi=1), f(6, 8, 3, 3)),
         {}),
        ("deformable_conv modulated stride 2",
         lambda x, o, w, m: ops.deformable_conv(x, o, w, 2, 0, 1, m),
         (f(1, 3, 11, 11), f(1, 8, 5, 5, lo=-1.5, hi=1.5), f(4, 3, 2, 2),
          f(1, 4, 5, 5, lo=0, hi=1)), {}),
        ("average_accumulates", lambda p, a, b, c: ops.average_accumulates(
            p, a, b, c, 3, 2, 6, average_window=5, max_average_window=4),
         (f(64), f(64), f(64), f(64)), {}),
        ("beam_search ties", lambda lp, sc, ids: ops.beam_search(
            lp, sc, ids, 4, end_token=3, length_penalty=0.6, step=2),
         (q(16, 9), q(16), ints(0, 9, 16, 3)), {}),
        ("conv2d_fusion", lambda x, w, b, r: ops.conv2d_fusion(
            x, w, b, r, padding=1), (f(2, 8, 12, 12), f(16, 8, 3, 3),
                                     f(16), f(2, 16, 12, 12)), {}),
        ("deformable_psroi_pooling",
         lambda x, r, t: ops.deformable_psroi_pooling(
             x, r, t, 2, 2, 2, part_size=2, sample_per_part=2),
         (f(2, 8, 9, 11), rois, f(3, 2, 2, 2, lo=-1, hi=1)), {}),
        ("deformable_roi_pooling",
         lambda x, r, t: ops.deformable_roi_pooling(
             x, r, t, pooled_height=3, pooled_width=3, sample_per_part=2),
         (f(2, 3, 9, 11), rois, f(3, 2, 3, 3, lo=-1, hi=1)), {}),
    ]


def crnn_tiny_card_vs_cpu(K, pt, cr):
    """``crnn_ctc_tiny`` 3 Momentum steps on the card and on the CPU from
    one set of weights (the CPU startup's), fp32 with TF32 off: the first
    step's gradients, the losses, the persistables after; the card's
    launches (exactly 2 ``fused_matmul`` and one ``fused_momentum`` per
    parameter a step)."""
    import numpy as np
    cfg = cr.crnn_ctc_tiny()
    built = cr.build_train(pt, cfg)
    main, startup, loss = built["main"], built["startup"], built["loss"]
    cpu_exe, card_exe = pt.Executor(pt.CPUPlace()), pt.Executor()
    cpu_scope = pt.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    names = [n for n, v in startup.global_block().vars.items()
             if v.persistable]
    init = {n: cpu_scope.find_var(n).numpy().copy() for n in names}
    card_scope = pt.Scope.from_numpy(init, "cuda", startup)
    params = cr.param_names(main)
    feeds = [cr.feed_of(cr.synthetic_batch(cfg, cfg.batch, seed=i))
             for i in range(3)]
    first = [exe.run(main, feed=feeds[0],
                     fetch_list=[p + "@GRAD" for p in params],
                     scope=pt.Scope.from_numpy(init, dev, startup))
             for exe, dev in ((card_exe, "cuda"), (cpu_exe, "cpu"))]
    gmax = max(float(np.abs(g).max()) for g in first[1])
    ggap = max(float(np.abs(x - y).max()) for x, y in zip(*first))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    losses = []
    for feed in feeds:
        losses.append(tuple(
            float(exe.run(main, feed=feed, fetch_list=[loss], scope=sc)[0])
            for exe, sc in ((card_exe, card_scope), (cpu_exe, cpu_scope))))
    launches = {k: v for k, v in K.launch_counts().items() if v}
    gap = max(float(np.abs(card_scope.find_var(n).cpu().numpy()
                           - cpu_scope.find_var(n).numpy()).max())
              / max(1.0, float(np.abs(cpu_scope.find_var(n).numpy()).max()))
              for n in names)
    loss_gap = max(abs(c - w) / abs(w) for c, w in losses)
    rec = dict(losses_card_cpu=losses, loss_gap_rel=loss_gap,
               grad_gap_of_max=ggap / gmax, param_gap=gap,
               launches=launches)
    check(loss_gap <= CRNN_TOL["loss_rel"],
          f"misc-correctness: crnn_ctc_tiny losses card/cpu {losses}")
    check(ggap <= CRNN_TOL["grad_gap_of_max"] * gmax,
          f"misc-correctness: crnn_ctc_tiny first gradients differ by "
          f"{ggap} (largest {gmax})")
    check(gap <= CRNN_TOL["param_gap"],
          f"misc-correctness: crnn_ctc_tiny persistables differ by {gap}")
    check(launches == {"fused_matmul": 2 * 3,
                       "fused_momentum": 3 * len(params)},
          f"misc-correctness: crnn_ctc_tiny launches {launches}")
    return rec


def moments_within(v, mean, std, label):
    """The mean and variance of the draws ``v`` (on the card) within
    ``CRNN_TOL["sigmas"]`` standard errors of ``mean`` and ``std``^2 (the
    variance's error with a fourth moment of at most 3 std^4)."""
    v = v.double()
    n, k = v.numel(), CRNN_TOL["sigmas"]
    m, var = float(v.mean()), float(v.var(unbiased=False))
    check(abs(m - mean) <= k * std / math.sqrt(n)
          and abs(var - std ** 2) <= k * math.sqrt(2.0 / n) * std ** 2
          * 1.3, f"misc-correctness: {label}: mean {m} (want {mean}), "
                 f"variance {var} (want {std ** 2}) over {n}")
    return [m, var]


def random_card_checks(ops, pt):
    """The random ops on the card, 10^6 draws each: range, moments,
    frequencies, windows and permutations; the same op seed gives the same
    draws, a given generator beats the seed, seed 0 advances the global
    counter and ``seed(s)`` restarts it."""
    dev, n = torch.device("cuda"), 1_000_000
    rec = {}
    g = ops.gaussian_random((n,), 1.5, 0.5, seed=7, device=dev)
    check(g.device.type == "cuda" and g.dtype == torch.float32,
          "misc-correctness: gaussian_random on the card")
    rec["gaussian"] = moments_within(g, 1.5, 0.5, "gaussian_random")
    check(torch.equal(g, ops.gaussian_random((n,), 1.5, 0.5, seed=7,
                                             device=dev)),
          "misc-correctness: the same seed gives the same draws")
    u = ops.uniform_random((n,), min=-3.0, max=5.0, seed=1,
                           rng=torch.Generator(device=dev).manual_seed(3))
    check(torch.equal(u, ops.uniform_random(
        (n,), min=-3.0, max=5.0, seed=2,
        rng=torch.Generator(device=dev).manual_seed(3))),
        "misc-correctness: the generator beats the seed")
    check(float(u.min()) >= -3.0 and float(u.max()) < 5.0,
          "misc-correctness: uniform_random's range")
    rec["uniform"] = moments_within(u, 1.0, 8.0 / math.sqrt(12.0),
                                    "uniform_random")
    t = ops.truncated_gaussian_random((n,), -1.0, 2.0, seed=4, device=dev)
    check(float(t.min()) >= -5.0 - 1e-5 and float(t.max()) <= 3.0 + 1e-5,
          "misc-correctness: truncated_gaussian_random's range")
    rec["truncated"] = moments_within(t, -1.0, 2.0 * TRUNC_STD,
                                      "truncated_gaussian_random")
    r = ops.randint(3, 9, (n,), seed=5, device=dev)
    check(r.dtype == torch.int64 and torch.equal(
        torch.unique(r).cpu(), torch.arange(3, 9)),
        "misc-correctness: randint's range and dtype")
    rec["randint"] = moments_within(r, 5.5, math.sqrt(35 / 12.0), "randint")
    p = torch.tensor([0.1, 0.0, 0.6, 0.3], device=dev).repeat(n // 4, 1)
    sid = ops.sampling_id(p, seed=6)
    freq = torch.bincount(sid, minlength=4).double() / sid.numel()
    want = torch.tensor([0.1, 0.0, 0.6, 0.3], dtype=torch.float64,
                        device=dev)
    check(float(freq[1]) == 0 and float((freq - want).abs().max())
          <= CRNN_TOL["sigmas"] * math.sqrt(0.25 / sid.numel()),
          f"misc-correctness: sampling_id's frequencies {freq.tolist()}")
    rec["sampling_id"] = freq.tolist()
    x = torch.arange(2 * 3 * 6 * 7, dtype=torch.float32,
                     device=dev).reshape(2, 3, 6, 7)
    seen = set()
    for s in range(1, 41):
        out = ops.random_crop(x, (4, 5), seed=s)
        y0, x0 = int(out[0, 0, 0, 0]) // 7, int(out[0, 0, 0, 0]) % 7
        check(torch.equal(out, x[:, :, y0:y0 + 4, x0:x0 + 5]),
              "misc-correctness: random_crop's window")
        seen.add((y0, x0))
    check(len(seen) == 9, f"misc-correctness: random_crop's starts {seen}")
    perm = ops.shuffle_batch(torch.arange(4096, device=dev), seed=8)
    check(torch.equal(torch.sort(perm).values,
                      torch.arange(4096, device=dev))
          and not torch.equal(perm, torch.arange(4096, device=dev)),
          "misc-correctness: shuffle_batch permutes")
    like = ops.gaussian_random_batch_size_like(torch.zeros(300, 2,
                                                           device=dev),
                                               [-1, 1000], seed=9)
    check(like.shape == (300, 1000) and like.device.type == "cuda",
          "misc-correctness: the batch_size_like draws")
    pt.core.random.seed(11)
    a = [ops.uniform_random((8,), device=dev) for _ in range(2)]
    pt.core.random.seed(11)
    b = [ops.uniform_random((8,), device=dev) for _ in range(2)]
    check(not torch.equal(a[0], a[1]) and torch.equal(a[0], b[0])
          and torch.equal(a[1], b[1]),
          "misc-correctness: the global counter and seed()")
    return rec


def phase_misc_checks(K, pt, ops, cr, card):
    """Phase 41 (see the module docstring); returns the card's launches of
    the counted runs (crnn_ctc_tiny's steps and the ``lookup_table``
    call)."""
    import numpy as np
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        tiny = crnn_tiny_card_vs_cpu(K, pt, cr)
        ops_rec = {}
        for i, (name, fn, args, kw) in enumerate(misc_op_cases(
                ops, np.random.RandomState(41))):
            got, want = op_card_vs_cpu(fn, args, kw, i)
            check(len(got) == len(want), f"misc-correctness: {name}: "
                                         "outputs")
            err = 0.0
            for g, w in zip(got, want):
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"misc-correctness: {name}: {g.shape} {g.dtype}")
                if not w.is_floating_point():
                    check(torch.equal(g, w), f"misc-correctness: {name}")
                    continue
                scale = max(1.0, w.abs().max().item())
                e = max_err(g, w) / scale
                check(e <= CRNN_TOL["op"], f"misc-correctness: {name}: {e}")
                err = max(err, e)
            ops_rec[name] = err
        # lookup_table is ops/nn.embedding: one gather launch on the card
        rng = np.random.RandomState(6)
        table = rng.randn(5000, 64).astype(np.float32)
        ids = rng.randint(0, 5000, (32, 24, 1))
        torch.cuda.synchronize()
        K.reset_launch_counts()
        got = ops.lookup_table(torch.as_tensor(ids, device="cuda"),
                               torch.as_tensor(table, device="cuda"), 3)
        torch.cuda.synchronize()
        lookup = {k: v for k, v in K.launch_counts().items() if v}
        check(lookup == {"embedding_gather": 1},
              f"misc-correctness: lookup_table launched {lookup}")
        want = ops.lookup_table(torch.as_tensor(ids), torch.as_tensor(table),
                                3)
        check(torch.equal(got.cpu(), want),
              "misc-correctness: lookup_table card vs CPU")
        rand = random_card_checks(ops, pt)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    launches = dict(tiny["launches"])
    launches["embedding_gather"] = lookup["embedding_gather"]
    rec = dict(crnn_ctc_tiny=tiny, ops_max_err_of_max=ops_rec,
               lookup_table_launches=lookup, random=rand, card=card)
    log(f"misc-correctness: {len(ops_rec)} op cases within "
        f"{max(ops_rec.values()):.3g} of their largest value; "
        f"crnn_ctc_tiny losses {tiny['loss_gap_rel']:.3g}, parameters "
        f"{tiny['param_gap']:.3g} [{card}]")
    log("misc_correctness " + json.dumps(rec))
    return dict(rec, launches=launches)


# ---------------------------------------------------------------------------
# phases 42-44: MobileNetV1 under quantization-aware training
# (models/mobilenet_v1.py), its int8 deployment, the quantization ops,
# ops/aliases.py, layers' own functions and the three new passes
# ---------------------------------------------------------------------------
QAT_STEPS = 10
QAT_BATCHES = 2
QAT_CALIB = 4
#: phase 44's limits, set before the first card run. A fake-quant round
#: turns an ulp of difference before it into a whole step (scale / 127)
#: where the pre-round value lies within rounding of a half integer (a
#: flip), and batch norm's batch statistics spread a flip over its channel:
#: so the tiny model's quantized integers (each device's from its own
#: scale) are held equal at every step but for a share (``flip_share``)
#: that differ by one step, the first at a pre-round value within
#: ``half_int`` of a half integer; its losses within ``loss_rel``; its
#: gradients within ``grad_gap_of_max`` of the largest at a step without a
#: flip, and within ``grad_flip_of_max`` at one (against the JAX package on
#: the CPU one flip moved conv1's gradient by 2.2 % of the largest
#: gradient: tools/qat_flip_probe.py); each step runs from the CPU's
#: persistables, and the momentum update, flips or not, moves the card's
#: velocities and parameters off the CPU's by exactly the gradients' gap
#: (v' = mu v + g + l2 p, p' = p - lr v'), within ``update_ulps`` roundings
#: of the terms (4 a side); the batch statistics within ``param_gap`` of
#: max(1, largest) at a step without a flip, and their moves within
#: ``grad_flip_of_max`` of the largest at one; the calibration scales
#: within ``scale_rel``; the frozen logits (same int8 weights and scales on
#: both devices) within ``logit_of_max`` of the largest (a float op's ulp
#: before a quantize_linear flips an integer too). The ops: integers equal;
#: float values within ``op_ulps`` units in the last place (each is a few
#: elementwise products or a maximum on each device); the values of
#: ``continuous_value_model`` (a difference of two logarithms, whose
#: rounding differs between the devices' libraries) and the input
#: gradients within ``op`` of their largest value, but for the abs-max scale's
#: gradient over a whole activation (``QUANT_SCALE_GRAD_CASES``, 401,408
#: terms at conv5's, summed in other orders on the two devices: 1.3e-5 on
#: an earlier run), within ``op_scale_grad``.
QUANT_TOL = {"op": 1e-5, "op_ulps": 1.0, "op_scale_grad": 1e-4,
             "flip_share": 0.01, "half_int": 1e-3, "loss_rel": 1e-5,
             "grad_gap_of_max": 1e-5, "grad_flip_of_max": 0.1,
             "update_ulps": 8, "param_gap": 1e-5, "scale_rel": 1e-5,
             "logit_of_max": 0.02}
#: the op cases whose input gradient carries a scale's gradient summed over
#: a whole [4,512,14,14] activation
QUANT_SCALE_GRAD_CASES = frozenset({
    "fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
    "fake_quantize_range_abs_max", "moving_average_abs_max_scale",
    "fake_quantize_moving_average_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max"})


def qat_feed_spec(cfg, batch):
    s = cfg.image_size
    return {"image": ((batch, 3, s, s), "float32"),
            "label": ((batch, 1), "int64")}


def phase_train_qat(K, pt, mb, card):
    """Phase 42 (see the module docstring). Returns (record, (built, exe,
    scope))."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = mb.mobilenet_v1()
    t0 = time.perf_counter()
    built = mb.build_qat(pt, cfg)
    build_s = time.perf_counter() - t0
    main, loss = built["main"], built["loss"]
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(built["startup"], scope=scope)
    t0 = time.perf_counter()
    check(exe.prepare(main, feed=qat_feed_spec(cfg, cfg.batch),
                      fetch_list=[loss], scope=scope),
          "train-qat-mobilenet: prepare")
    prepare_ms = (time.perf_counter() - t0) * 1e3
    n_params = len(mb.param_names(main))
    types = [op.type for op in main.global_block().ops]
    n_fq = types.count("fake_quantize_dequantize_abs_max")
    n_ops, n_fmm = fused_matmuls_after_passes(built, [loss])
    check(n_params == 83 and n_fq == 56 and types.count("conv2d") == 27
          and (n_ops, n_fmm) == (1, 1),
          f"train-qat-mobilenet: {n_params} trainable tensors, {n_fq} "
          f"fake-quant ops, {types.count('conv2d')} convs, {n_ops} fused "
          f"matmul ops ({n_fmm} in the kernel's contract); expected 83, 56, "
          "27 and 1 (the fc over two quant-dequant outputs)")
    feeds = [mb.synthetic_batch(cfg, cfg.batch, seed=i)
             for i in range(QAT_BATCHES)]

    def step(feed):
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]

    rec = seq_train(
        K, "train-qat-mobilenet", step, feeds, QAT_STEPS,
        {"fused_matmul": n_fmm, "fused_momentum": n_params}, card,
        lambda f: cfg.batch, "images",
        dict(image=[3, cfg.image_size, cfg.image_size], batch=cfg.batch,
             classes=cfg.num_classes, params=n_params,
             param_values=sum(math.prod(main.global_block().var(n).shape)
                              for n in mb.param_names(main)),
             fake_quant_ops=n_fq, fused_matmul_ops=n_ops,
             fused_matmul_launches=n_fmm, build_s=build_s,
             prepare_ms=prepare_ms,
             optimizer=f"Momentum({cfg.lr}, {cfg.momentum}), "
                       f"L2Decay({cfg.l2})"))
    check(exe.trace_count == 1, f"train-qat-mobilenet: {exe.trace_count} "
                                "runners built; prepare's should serve")
    rec["peak_gb"] = peak_since(base)
    log_card("after train-qat-mobilenet's counted steps")
    log("train_qat_mobilenet " + json.dumps(rec))
    return rec, (built, exe, scope)


def int_product_times(cfg, gen):
    """Device ms of the exact integer products the frozen program runs: one
    ``quantized_conv2d``'s fp64 convolution (conv5_1_sep: [B,512,14,14] x
    [512,512,1,1], the widest K of the 1x1 convs but conv6's) and the
    ``quantized_mul``'s fp64 product ([B,1024] x [1024,1000]), beside
    ``torch._int_mm`` on the same int8 values (cuBLAS's IMMA, a yardstick:
    its int32 sums must equal the fp64 ones) and the whole op with its
    on-the-fly activation quantization."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import quantize as Q
    B = cfg.batch
    q = lambda *s: torch.randint(-127, 128, s, generator=gen, device="cuda",
                                 dtype=torch.int8)
    xc, wc = q(B, 512, 14, 14), q(512, 512, 1, 1)
    xm, wm = q(B, 1024), q(1024, 1000)
    xcd, wcd, xmd, wmd = (t.double() for t in (xc, wc, xm, wm))
    conv = F.conv2d(xcd, wcd)
    mm = xmd @ wmd
    ref = torch._int_mm(xm, wm)
    check(torch.equal(mm.to(torch.int32), ref),
          "infer-int8-mobilenet: the fp64 product and _int_mm's int32 "
          "sums differ")
    xf = torch.rand(B, 512, 14, 14, generator=gen, device="cuda") * 4
    xf2 = torch.rand(B, 1024, generator=gen, device="cuda") * 4
    rec = dict(
        conv_fp64_ms=device_ms(lambda: F.conv2d(xcd, wcd), 10),
        conv_op_ms=device_ms(lambda: Q.quantized_conv2d(xf, wc, 4.0, 0.5),
                             10),
        mul_fp64_ms=device_ms(lambda: xmd @ wmd, 20),
        mul_int_mm_ms=device_ms(lambda: torch._int_mm(xm, wm), 20),
        mul_op_ms=device_ms(lambda: Q.quantized_mul(xf2, wm, 4.0, 0.5), 20),
        conv_shape=[B, 512, 14, 14, 512], mul_shape=[B, 1024, 1000],
        conv_max_abs_acc=float(conv.abs().max()))
    return rec


def phase_infer_int8(K, pt, mb, card, trained):
    """Phase 43 (see the module docstring)."""
    import tempfile

    import numpy as np
    from paddle_tpu_torch import inference
    built, exe, scope = trained
    cfg = mb.mobilenet_v1()
    test, logits = built["test"], built["logits"]
    calib = [mb.synthetic_batch(cfg, cfg.batch, seed=100 + i)
             for i in range(QAT_CALIB)]
    t0 = time.perf_counter()
    scales, wscales = mb.freeze(pt, exe, scope, test, calib)
    freeze_s = time.perf_counter() - t0
    types = [op.type for op in test.global_block().ops]
    check(types.count("quantized_conv2d") == 27
          and types.count("quantized_mul") == 1
          and not {"conv2d", "mul", "fake_quantize_dequantize_abs_max"}
          & set(types) and len(scales) == 28 and len(wscales) == 28,
          f"infer-int8-mobilenet: frozen ops {sorted(set(types))}, "
          f"{len(scales)} activation and {len(wscales)} weight scales")
    check(all(scope.find_var(n).dtype == torch.int8
              and scope.find_var(n).is_cuda for n in wscales),
          "infer-int8-mobilenet: the frozen weights are not int8 on the card")
    rec = dict(card=card, freeze_s=freeze_s, calibration_batches=QAT_CALIB,
               act_scale_range=[min(scales.values()), max(scales.values())])
    torch.cuda.synchronize()
    K.reset_launch_counts()
    runs, outs = 0, {}
    for batch in (cfg.batch, 1):
        feed = mb.synthetic_batch(cfg, batch, seed=200 + batch)
        ms = []
        for _ in range(12):
            t0 = time.perf_counter()
            (out,) = exe.run(test, feed=feed, fetch_list=[logits],
                             scope=scope)
            ms.append((time.perf_counter() - t0) * 1e3)
        runs += 12
        check(out.shape == (batch, cfg.num_classes)
              and bool(np.isfinite(out).all()),
              f"infer-int8-mobilenet: batch {batch}: {out.shape}")
        outs[batch] = (feed, out)
        prof = op_breakdown(lambda feed=feed: exe.run(
            test, feed=feed, fetch_list=[logits], scope=scope,
            return_numpy=False), top=6, host_top=4)
        runs += 1
        steady = statistics.median(ms[2:])
        rec[f"batch_{batch}"] = dict(
            ms=steady, first_ms=ms[0], ms_all=ms, ms_per_image=steady / batch,
            images_per_s=batch / steady * 1e3,
            device_events=prof.get("launches"),
            device_ms=prof.get("kernel_ms"),
            device_busy_share=(prof.get("kernel_ms", 0.0) / steady
                               if prof else None), profile=prof)
        log(f"infer-int8-mobilenet: batch {batch}: {steady:.3f} ms, "
            f"{steady / batch:.4f} ms an image, busy "
            f"{rec[f'batch_{batch}']['device_busy_share']} [{card}]")
    counts = {k: v for k, v in K.launch_counts().items() if v}
    check(counts == {}, f"infer-int8-mobilenet: launches {counts} in {runs} "
                        "runs; the frozen program launches no registered "
                        "kernel (its fc is a quantized_mul)")
    rec["launches"] = counts
    rec["int_products"] = int_product_times(
        cfg, torch.Generator(device="cuda").manual_seed(43))
    log("infer-int8-mobilenet: integer products " + json.dumps(
        rec["int_products"]))
    feed, want = outs[cfg.batch]
    with tempfile.TemporaryDirectory() as d:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(d, ["image"], [logits], exe,
                                       main_program=test)
        prog, feeds, fetches = pt.io.load_inference_model(
            d, exe, scope=pt.Scope())
        predictor = inference.create_predictor(inference.Config(d))
        (pred,) = predictor.run({"image": feed["image"]})
    (again,) = exe.run(test, feed=feed, fetch_list=[logits], scope=scope)
    check(np.array_equal(pred, want) and np.array_equal(again, want)
          and feeds == ["image"] and len(fetches) == 1,
          "infer-int8-mobilenet: the Predictor's logits differ from the "
          f"frozen program's by {float(np.abs(pred - want).max())}")
    rec["predictor_equal"] = True
    log("infer_int8_mobilenet " + json.dumps(rec))
    return rec


def quant_op_cases(ops, rng):
    """(name, op, args, keyword args) of every op of the slice's ops
    modules (``ops/quantize.py``'s 14, ``ops/aliases.py``'s but ``range``
    and ``delete_var``, held on their own) and ``layers``' ``hash`` and
    ``continuous_value_model``, the args numpy arrays drawn once;
    MobileNetV1's shapes where it has them (conv5_1_sep's activation
    [4,512,14,14] and weight, the fc's [4,1024] x [1024,1000]); the tie
    case of the abs-max gradient; a K of 4608 (3x3x512) for the integer
    products."""
    import numpy as np
    from paddle_tpu_torch import layers

    def f(*shape, lo=-2.0, hi=2.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def q(*shape):
        return rng.randint(-127, 128, shape).astype(np.int8)
    act = np.maximum(f(4, 512, 14, 14), 0)
    ties = np.array([0.3, -1.0, 0.77, 1.0, 0.1], np.float32)
    ids = rng.randint(0, 8, (6, 4)).astype(np.int32)
    parents = rng.randint(0, 4, (6, 4)).astype(np.int32)
    ids[3, 1] = 2
    return [
        ("fake_quantize_abs_max", ops.fake_quantize_abs_max, [act], {}),
        ("fake_quantize_dequantize_abs_max",
         ops.fake_quantize_dequantize_abs_max, [act], {}),
        ("fake_quantize_dequantize_abs_max ties",
         ops.fake_quantize_dequantize_abs_max, [ties], {}),
        ("fake_channel_wise_quantize_abs_max",
         ops.fake_channel_wise_quantize_abs_max, [f(512, 512, 1, 1)], {}),
        ("fake_channel_wise_quantize_dequantize_abs_max",
         ops.fake_channel_wise_quantize_dequantize_abs_max,
         [f(512, 1, 3, 3)], {}),
        ("fake_quantize_range_abs_max", ops.fake_quantize_range_abs_max,
         [act, np.float32(1.5), np.int32(3)], {"window_size": 4}),
        ("moving_average_abs_max_scale", ops.moving_average_abs_max_scale,
         [act, np.float32(1.2), np.float32(0.5)], {}),
        ("fake_quantize_moving_average_abs_max",
         ops.fake_quantize_moving_average_abs_max,
         [act, np.float32(1.2), np.float32(0.5)], {}),
        ("fake_quantize_dequantize_moving_average_abs_max",
         ops.fake_quantize_dequantize_moving_average_abs_max,
         [act, np.float32(1.2), np.float32(0.5)], {}),
        ("fake_dequantize_max_abs", ops.fake_dequantize_max_abs,
         [q(4, 1024).astype(np.float32), np.float32(0.7)], {"max_range": 127}),
        ("fake_channel_wise_dequantize_max_abs",
         ops.fake_channel_wise_dequantize_max_abs,
         [q(64, 32).astype(np.float32)],
         {"scales": [np.abs(f(64)) + 0.1, 0.8], "quant_bits": (8, 8)}),
        ("quantize_linear", ops.quantize_linear, [act], {"scale": 1.7}),
        ("dequantize_linear", ops.dequantize_linear, [q(4, 1024)],
         {"scale": 1.7}),
        ("quantized_mul", ops.quantized_mul, [f(4, 1024), q(1024, 1000)],
         {"x_scale": 2.0, "w_scale": 0.3}),
        ("quantized_mul K=4608", ops.quantized_mul,
         [f(32, 4608), q(4608, 64)], {"x_scale": 2.0, "w_scale": 0.3}),
        ("quantized_conv2d", ops.quantized_conv2d,
         [act, q(512, 512, 1, 1)], {"x_scale": 2.0, "w_scale": 0.3}),
        ("quantized_conv2d 3x3x512", ops.quantized_conv2d,
         [act, q(64, 512, 3, 3)],
         {"x_scale": 2.0, "w_scale": 0.3, "padding": 1}),
        ("quantized_conv2d depthwise", ops.quantized_conv2d,
         [act, q(512, 1, 3, 3)],
         {"x_scale": 2.0, "w_scale": 0.3, "stride": 2, "padding": 1,
          "groups": 512}),
        ("alloc_continuous_space", lambda a, b: ops.alloc_continuous_space(
            [a, b])[0], [f(4, 8), f(16)], {}),
        ("rnn_memory_helper", ops.rnn_memory_helper, [f(4, 8)], {}),
        ("beam_search_decode", ops.beam_search_decode, [ids, parents],
         {"end_token": 2}),
        ("hash", layers.hash, [rng.randint(0, 1000, (8, 4)).astype(
            np.int32)], {"hash_size": 97, "num_hash": 2}),
        ("continuous_value_model", layers.continuous_value_model,
         [np.abs(f(8, 6))], {}),
    ]


def qat_tiny_card_vs_cpu(K, pt, mb):
    """``mobilenet_v1_tiny`` 3 QAT Momentum steps on the card and on the
    CPU, each from the CPU's persistables before it (the flips of a step
    count and act only within it), with the flips of every fake-quant
    output counted at every step and the momentum update held to the
    gradients' gap; then calibration on both devices, and the freeze of
    each from the CPU's trained weights
    with the CPU's scales: the frozen op lists, int8 weights and logits.
    The card's launches: exactly 1 ``fused_matmul`` and one
    ``fused_momentum`` per parameter a step."""
    import numpy as np
    cfg = mb.mobilenet_v1_tiny()
    built = mb.build_qat(pt, cfg)
    main, startup, loss = built["main"], built["startup"], built["loss"]
    cpu_exe, card_exe = pt.Executor(pt.CPUPlace()), pt.Executor()
    cpu_scope = pt.Scope()
    cpu_exe.run(startup, scope=cpu_scope)
    names = [n for n, v in startup.global_block().vars.items()
             if v.persistable]
    params = mb.param_names(main)
    stats = [n for n in names
             if n not in params and not n.endswith("@velocity")]
    _, fq_names = mb.fake_quant_fetch(main)
    fetch = [loss.name] + [p + "@GRAD" for p in params] + fq_names
    n = 1 + len(params)
    u = QUANT_TOL["update_ulps"] * 2.0 ** -24
    losses, flips_of, ggaps, upd_gap, stat_gap = [], [], [], 0.0, 0.0
    launches = {}
    for step in range(3):
        feed = mb.synthetic_batch(cfg, cfg.batch, seed=step)
        before = {k: cpu_scope.find_var(k).numpy().copy() for k in names}
        card_scope = pt.Scope.from_numpy(before, "cuda", startup)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        got = card_exe.run(main, feed=feed, fetch_list=fetch,
                           scope=card_scope)
        torch.cuda.synchronize()
        for k, v in K.launch_counts().items():
            if v:
                launches[k] = launches.get(k, 0) + v
        want = cpu_exe.run(main, feed=feed, fetch_list=fetch,
                           scope=cpu_scope)
        losses.append((float(got[0]), float(want[0])))
        flips, total, fault = mb.check_flips(
            mb.quant_flips(got[n:], want[n:]), QUANT_TOL["flip_share"],
            QUANT_TOL["half_int"])
        check(fault is None, f"quant-correctness: step {step}: {fault}")
        flips_of.append(flips)
        gmax = max(float(np.abs(g).max()) for g in want[1:n])
        ggap = max(float(np.abs(x - y).max())
                   for x, y in zip(got[1:n], want[1:n]))
        ggaps.append(ggap / gmax)
        check(ggap <= QUANT_TOL["grad_flip_of_max" if flips else
                                "grad_gap_of_max"] * gmax,
              f"quant-correctness: step {step} gradients differ by {ggap} "
              f"(largest {gmax}, {flips} flips)")
        # the update from the same p and v, flips or not: v' = mu v + g +
        # l2 p, p' = p - lr v', so the velocities differ by the gradients'
        # gap and the parameters by -lr times that, within update_ulps
        # roundings of the terms
        for p, g, w in zip(params, got[1:n], want[1:n]):
            g, w = g.astype(np.float64), w.astype(np.float64)
            p0, v0 = (before[k].astype(np.float64)
                      for k in (p, p + "@velocity"))
            pc, vc = (card_scope.find_var(k).cpu().numpy().astype(np.float64)
                      for k in (p, p + "@velocity"))
            pw, vw = (cpu_scope.find_var(k).numpy().astype(np.float64)
                      for k in (p, p + "@velocity"))
            rv = np.abs((vc - vw) - (g - w)) / (u * (
                cfg.momentum * np.abs(v0) + np.abs(w) + cfg.l2 * np.abs(p0)
                + np.abs(vw)) + 1e-45)
            rp = np.abs((pc - pw) + cfg.lr * (vc - vw)) / (u * (
                np.abs(p0) + cfg.lr * np.abs(vw) + np.abs(pw)) + 1e-45)
            worst = max(float(rv.max()), float(rp.max()))
            upd_gap = max(upd_gap, worst)
            check(worst <= 1.0, f"quant-correctness: step {step}: {p}'s "
                                f"update off the gradients' gap by {worst} "
                                "of its limit")
        # the batch statistics (and the step counter): with a flip, their
        # moves within grad_flip_of_max of the largest, as the gradients
        for k in stats:
            c = card_scope.find_var(k).cpu().numpy()
            w = cpu_scope.find_var(k).numpy()
            gap = float(np.abs(c - w).max())
            lim = (QUANT_TOL["grad_flip_of_max"]
                   * float(np.abs(w - before[k]).max()) if flips else
                   QUANT_TOL["param_gap"] * max(1.0, float(np.abs(w).max())))
            stat_gap = max(stat_gap, gap / max(1.0, float(np.abs(w).max())))
            check(gap <= lim, f"quant-correctness: step {step}: {k} "
                              f"differs by {gap} ({flips} flips)")
    loss_gap = max(abs(c - w) / abs(w) for c, w in losses)
    check(loss_gap <= QUANT_TOL["loss_rel"],
          f"quant-correctness: mobilenet_v1_tiny losses card/cpu {losses}")
    check(launches == {"fused_matmul": 3, "fused_momentum": 3 * len(params)},
          f"quant-correctness: mobilenet_v1_tiny launches {launches}")
    # calibration on both devices; the freeze of each from the CPU's weights
    calib = [mb.synthetic_batch(cfg, cfg.batch, seed=10 + i)
             for i in range(2)]
    trained = {n: cpu_scope.find_var(n).numpy().copy() for n in names}
    frozen = []
    for exe, dev in ((card_exe, "cuda"), (cpu_exe, "cpu")):
        b = mb.build_qat(pt, cfg)
        sc = pt.Scope.from_numpy(trained, dev, startup)
        q = mb._quant(pt)
        sc_scales = q.calibrate_activations(exe, b["test"], calib, scope=sc)
        frozen.append((exe, sc, b, sc_scales))
    scale_gap = max(abs(frozen[0][3][k] - v) / v
                    for k, v in frozen[1][3].items())
    check(scale_gap <= QUANT_TOL["scale_rel"] and set(frozen[0][3]) == set(
        frozen[1][3]), f"quant-correctness: calibration scales differ by "
                       f"{scale_gap}")
    outs = []
    feed = mb.synthetic_batch(cfg, 3, seed=99)
    for exe, sc, b, _ in frozen:
        fp = mb._quant(pt).QuantizationFreezePass(scope=sc,
                                                  act_scales=frozen[1][3])
        fp.apply(b["test"])
        outs.append(([op.type for op in b["test"].global_block().ops],
                     {w: sc.find_var(w).cpu() for w in fp.weight_scales},
                     exe.run(b["test"], feed=feed, fetch_list=[b["logits"]],
                             scope=sc)[0]))
    check(outs[0][0] == outs[1][0] and all(
        torch.equal(outs[0][1][w], outs[1][1][w]) for w in outs[1][1]),
          "quant-correctness: the frozen programs or int8 weights differ")
    lmax = float(np.abs(outs[1][2]).max())
    lgap = float(np.abs(outs[0][2] - outs[1][2]).max())
    check(lgap <= QUANT_TOL["logit_of_max"] * lmax,
          f"quant-correctness: frozen logits differ by {lgap} (largest "
          f"{lmax})")
    return dict(losses_card_cpu=losses, loss_gap_rel=loss_gap,
                flips=flips_of, quantized_values=total,
                grad_gap_of_max=ggaps, update_gap_of_limit=upd_gap,
                stat_gap=stat_gap,
                scale_gap_rel=scale_gap, frozen_logit_gap_of_max=lgap / lmax,
                launches=launches)


def pass_programs(pt):
    """Four programs of the three new passes' families, each with its feed
    and fetch names: scale chains, identity and inverse transposes and
    reshapes, same-dtype casts, a constant operand folded, fcs."""
    import numpy as np
    L = pt.layers
    progs = []
    for k in range(4):
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), \
                pt.framework.unique_name.guard():
            x = pt.data("x", [8], "float32")
            h = L.scale(L.scale(x, scale=2.0, bias=0.5), scale=0.25,
                        bias=-1.0, bias_after_scale=k % 2 == 0)
            h = L.transpose(L.transpose(h, [1, 0]), [1, 0])
            h = L.reshape(L.reshape(h, [-1, 2, 4]), [-1, 8])
            h = L.cast(L.cast(h, "float32"), "float32")
            c = L.elementwise_add(L.fill_constant([1, 8], "float32", 0.5),
                                  np.ones((1, 8), np.float32))
            h = L.elementwise_mul(h, c)
            out = L.fc(h, 4 + k, act="relu" if k < 2 else None)
        feed = {"x": np.random.RandomState(k).randn(3, 8).astype(
            np.float32)}
        progs.append((main, startup, feed, [out.name]))
    return progs


def passes_card_vs_cpu(pt):
    """The pass programs through each device's Executor: the op lists its
    prepared runner interprets equal on both devices and shorter than the
    program, the outputs within ``QUANT_TOL["op"]`` of their largest."""
    import numpy as np
    rec = []
    for main, startup, feed, fetch in pass_programs(pt):
        got = []
        for exe in (pt.Executor(), pt.Executor(pt.CPUPlace())):
            sc = pt.Scope()
            exe.run(startup, scope=sc)
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=sc)[0]
            (runner,) = exe._runners.values()
            got.append(([op.type for op in runner.ops], out))
        (card_ops, card_out), (cpu_ops, cpu_out) = got
        n = len(main.global_block().ops)
        err = float(np.abs(card_out - cpu_out).max()) / max(
            1.0, float(np.abs(cpu_out).max()))
        check(card_ops == cpu_ops and len(cpu_ops) < n
              and err <= QUANT_TOL["op"],
              f"quant-correctness: pass program {card_ops} / {cpu_ops} "
              f"(from {n} ops), outputs {err}")
        rec.append(dict(ops_before=n, ops_after=cpu_ops, max_err=err))
    return rec


def phase_quant_checks(K, pt, ops, mb, card):
    """Phase 44 (see the module docstring); returns the card's launches of
    the counted runs (mobilenet_v1_tiny's steps)."""
    import numpy as np
    from paddle_tpu_torch import layers
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        tiny = qat_tiny_card_vs_cpu(K, pt, mb)
        ops_rec = {}
        for i, (name, fn, args, kw) in enumerate(quant_op_cases(
                ops, np.random.RandomState(44))):
            got, want, n_out = op_card_vs_cpu(fn, args, kw, i,
                                              count_outputs=True)
            check(len(got) == len(want), f"quant-correctness: {name}: "
                                         "outputs")
            ulps, err = 0.0, 0.0
            for j, (g, w) in enumerate(zip(got, want)):
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"quant-correctness: {name}: {g.shape} {g.dtype}")
                if not w.is_floating_point() or name.startswith("quantized"):
                    # integers, and the exact integer products' results
                    check(torch.equal(g, w), f"quant-correctness: {name}")
                elif j < n_out and name != "continuous_value_model":
                    # a value: within op_ulps units in the last place
                    wn = w.numpy()
                    e = float((np.abs(g.numpy() - wn)
                               / np.spacing(np.abs(wn))).max())
                    check(e <= QUANT_TOL["op_ulps"],
                          f"quant-correctness: {name}: output {j} {e} ulps")
                    ulps = max(ulps, e)
                else:
                    lim = QUANT_TOL["op_scale_grad" if name in
                                    QUANT_SCALE_GRAD_CASES else "op"]
                    e = max_err(g, w) / max(1.0, w.abs().max().item())
                    check(e <= lim, f"quant-correctness: {name}: "
                                    f"tensor {j} {e}")
                    err = max(err, e)
            ops_rec[name] = dict(value_ulps=ulps, grad_err_of_max=err)
        check(torch.equal(ops.range(3, 40, 3, device="cuda").cpu(),
                          ops.range(3, 40, 3, device="cpu")),
              "quant-correctness: range")
        x = torch.randn(4, 8, device="cuda", requires_grad=True)
        (y,) = layers.py_func(lambda a: [a * 2.0], x, [None])
        check(y.is_cuda and y.dtype == torch.float32 and not y.requires_grad
              and torch.equal(y, x.detach() * 2.0),
              "quant-correctness: py_func on the card")
        scope = pt.Scope()
        scope.set_var("a", x)
        layers.delete_var(scope, "a")
        check(scope.find_var("a") is None, "quant-correctness: delete_var")
        passes = passes_card_vs_cpu(pt)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    rec = dict(mobilenet_v1_tiny=tiny, ops_max_err_of_max=ops_rec,
               passes=passes, card=card)
    log(f"quant-correctness: {len(ops_rec)} op cases, values within "
        f"{max(r['value_ulps'] for r in ops_rec.values()):.3g} ulps, "
        f"gradients within "
        f"{max(r['grad_err_of_max'] for r in ops_rec.values()):.3g} of "
        f"their largest; mobilenet_v1_tiny losses "
        f"{tiny['loss_gap_rel']:.3g}, flips by step {tiny['flips']}, "
        f"updates within {tiny['update_gap_of_limit']:.3g} of their limit, "
        f"batch statistics {tiny['stat_gap']:.3g}, frozen logits "
        f"{tiny['frozen_logit_gap_of_max']:.3g} [{card}]")
    log("quant_correctness " + json.dumps(rec))
    return dict(rec, launches=tiny["launches"])


# ---------------------------------------------------------------------------
# phases 45-47: MobileNetV1 served over HTTP and hot-swapped
# ---------------------------------------------------------------------------
HTTP_CLIENTS = 8                # WireClient threads, tenants a and b
HTTP_REQUESTS = 400             # at least this many requests in all
HTTP_SWAP_AFTER = 100           # responses before server.swap(v2)
HTTP_PUBLISH_AFTER = 220        # responses before v3 is published
HTTP_V3_MIN = 40                # responses v3 must serve before the stop
HTTP_IMAGES = 16                # distinct 224^2 images the clients send
SWAP_TRAIN_BATCH, SWAP_TRAIN_STEPS = 32, 5
SWAP_MAX_BATCH = 32
SWAP_WATCHDOG_MS, SWAP_POLL_MS = 500.0, 200.0
#: phase 47's limits: a response against its version's program run alone
#: on the card (fp32 with TF32 off, the same kernels, another batch:
#: other summation orders), relative to the largest logit; the other
#: versions at least 10x as far; phase 13's fp32 card-vs-CPU limit and
#: phase 9's int8-vs-fp32 limit
HTTP_TOL = dict(own=1e-4, other_x=10.0, card_cpu=1e-3, int8_fp32=0.02)


def publish_version(src, dst):
    """Copy an export over the watched directory ``dst``, its AOT index
    last, so a poll sees the new version only once every file it names is
    in place."""
    import shutil
    idx = os.path.join("__aot__", "index.json")
    for base, _dirs, files in os.walk(src):
        rel = os.path.relpath(base, src)
        os.makedirs(os.path.join(dst, rel), exist_ok=True)
        for f in files:
            if os.path.normpath(os.path.join(rel, f)) != idx:
                shutil.copy2(os.path.join(base, f), os.path.join(dst, rel, f))
    shutil.copy2(os.path.join(src, idx), os.path.join(dst, idx))


def export_mobilenet_versions(K, pt, mb, root):
    """v1 (fp32, the seed's weights), v2 (int8, after SWAP_TRAIN_STEPS
    Momentum steps), v3 (int8, after as many more), a NaN version (v2's
    weights with conv1's filled with NaN, int8) and v2 with one byte of its
    int8 sidecar flipped, all of MobileNetV1 at 224^2 through
    ``models/mobilenet_v1.py``'s ``export_served``. The training launches
    are counted (83 ``fused_momentum`` a step)."""
    import shutil

    import numpy as np
    cfg = mb.mobilenet_v1()
    built = mb.build_train(pt, cfg)
    exe, scope = pt.Executor(), pt.Scope()
    pt.core.random.seed(45)
    exe.run(built["startup"], scope=scope)
    dirs = {k: os.path.join(root, k) for k in ("v1", "v2", "v3", "nan",
                                               "flip")}
    t0 = time.perf_counter()
    mb.export_served(pt, exe, scope, built, dirs["v1"])
    n_params = len(mb.param_names(built["main"]))
    feeds = [mb.synthetic_batch(cfg, SWAP_TRAIN_BATCH, seed=450 + i)
             for i in range(2 * SWAP_TRAIN_STEPS)]
    K.reset_launch_counts()
    losses = []
    for v, steps in (("v2", feeds[:SWAP_TRAIN_STEPS]),
                     ("v3", feeds[SWAP_TRAIN_STEPS:])):
        for f in steps:
            (loss,) = exe.run(built["main"], feed=f,
                              fetch_list=[built["loss"]], scope=scope)
            losses.append(float(np.asarray(loss)))
        if v == "v2":
            counts = {k: n for k, n in K.launch_counts().items() if n}
            mb.export_served(pt, exe, scope, built, dirs["v2"],
                             quantize="int8")
            w = scope.find_var("conv1_weights")
            keep = w.clone()
            w.fill_(float("nan"))
            mb.export_served(pt, exe, scope, built, dirs["nan"],
                             quantize="int8")
            w.copy_(keep)
            K.reset_launch_counts()
        else:
            for k, n in K.launch_counts().items():
                counts[k] = counts.get(k, 0) + n
            mb.export_served(pt, exe, scope, built, dirs["v3"],
                             quantize="int8")
    shutil.copytree(dirs["v2"], dirs["flip"])
    aot = os.path.join(dirs["flip"], "__aot__")
    side = next(f for f in os.listdir(aot) if f.startswith("quant."))
    with open(os.path.join(aot, side), "r+b") as f:
        blob = bytearray(f.read())
        blob[len(blob) // 2] ^= 0xFF
        f.seek(0)
        f.write(bytes(blob))
    check(counts.get("fused_momentum") == 2 * SWAP_TRAIN_STEPS * n_params
          and n_params == 83 and all(math.isfinite(x) for x in losses),
          f"serve-http-swap: training the versions launched {counts} over "
          f"{2 * SWAP_TRAIN_STEPS} steps of {n_params} tensors, losses "
          f"{losses}; expected 83 fused_momentum a step and finite losses")
    rec = dict(export_train_s=time.perf_counter() - t0,
               train_batch=SWAP_TRAIN_BATCH, steps=2 * SWAP_TRAIN_STEPS,
               losses=losses, launches=counts, params=n_params)
    del exe, scope, built
    return dirs, rec


def run_version(d, images, device):
    """Each image alone (one row) through the served program of the export
    ``d`` (the server's own load path: ``_load_bundle``, the int8 sidecar
    folded in), on ``device``. Returns [N, classes] numpy."""
    import numpy as np
    from paddle_tpu_torch.serving.server import _load_bundle
    b = _load_bundle(d)
    params = tuple(p.to(device) for p in b.params)
    with torch.inference_mode():
        outs = [b.pure_fn(params, (torch.from_numpy(im[None]).to(device),)
                          )[0].cpu().numpy() for im in images]
    del params
    return np.concatenate(outs)


class HttpLoad:
    """HTTP_CLIENTS WireClient threads, each with its own connection, each
    POSTing one pre-encoded 224^2 image a request until ``stop`` is set;
    every response is recorded (send and receive times, status, version,
    logits, trace id, image index, tenant)."""

    def __init__(self, port, bodies):
        import threading
        self.port, self.bodies = port, bodies
        self.lock = threading.Lock()
        self.rows = []
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._client, args=(i,),
                                         daemon=True)
                        for i in range(HTTP_CLIENTS)]

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def _client(self, i):
        import numpy as np
        from paddle_tpu_torch.serving import WireClient
        tenant = "a" if i < HTTP_CLIENTS // 2 else "b"
        c = WireClient("127.0.0.1", self.port, timeout_s=120)
        k = 0
        while not self.stop.is_set():
            img = (i * 7 + k) % len(self.bodies)
            k += 1
            t0 = time.perf_counter()
            try:
                st, _h, payload = c.request(
                    "POST", "/v1/infer", self.bodies[img],
                    {"X-Tenant": tenant})
            except Exception as e:          # recorded, judged by the check
                st, payload = -1, {"error": f"{type(e).__name__}: {e}"}
            t1 = time.perf_counter()
            row = dict(t0=t0, t1=t1, status=st, image=img, tenant=tenant,
                       version=(payload or {}).get("model_version"),
                       trace_id=(payload or {}).get("trace_id"),
                       error=(payload or {}).get("error") if st != 200
                       else None,
                       out=np.asarray(payload["outputs"][0], np.float32)
                       if st == 200 else None)
            with self.lock:
                self.rows.append(row)
        c.close()

    def done(self):
        with self.lock:
            return len(self.rows)

    def wait_for(self, n, timeout=600.0):
        t_end = time.monotonic() + timeout
        while self.done() < n:
            check(time.monotonic() < t_end,
                  f"serve-http-swap: {self.done()} responses, waited for {n}")
            time.sleep(0.01)

    def finish(self):
        self.stop.set()
        for t in self.threads:
            t.join(300)
        return self.rows


def latency_ms(rows):
    lat = sorted((r["t1"] - r["t0"]) * 1e3 for r in rows)
    if not lat:
        return None
    return dict(n=len(lat), p50_ms=lat[len(lat) // 2],
                p99_ms=lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                max_ms=lat[-1])


def params_in_ledger(memory):
    return int(sum(b for e, b in memory.ledger("serving/").items()
                   if e.endswith("/params")))


def swap_sampled(srv, memory, fn):
    """Run ``fn()`` (a swap) while a thread samples the card's allocated
    bytes and the ledger's resident params every 2 ms; returns (fn's
    result, peak allocated sampled, peak ledger params)."""
    import threading
    peak = {"alloc": 0, "params": 0}
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            peak["alloc"] = max(peak["alloc"], torch.cuda.memory_allocated())
            peak["params"] = max(peak["params"], params_in_ledger(memory))
            time.sleep(0.002)

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        out = fn()
    finally:
        stop.set()
        t.join(10)
    return out, peak["alloc"], peak["params"]


def wait_drained(srv, timeout=300.0):
    ctl = srv._swap_ctl()
    t_end = time.monotonic() + timeout
    while True:
        with ctl._drain_lock:
            busy = list(ctl._drain_threads) + list(ctl._standby_threads)
        if not busy:
            return
        check(time.monotonic() < t_end,
              "serve-http-swap: a retired pool did not drain")
        time.sleep(0.02)


def wait_swapped(srv, label, want, reg, ok0, timeout=120.0):
    """Wait until ``watch_dir``'s swap to ``want`` has returned: the
    version is live (set at the cutover), the ok count has moved (after
    the watchdog window) and the swap lock is free again (released just
    after the count)."""
    lock = srv._swap_ctl()._swap_lock
    t_end = time.monotonic() + timeout
    while label.get(srv.model_version) != want or \
            swaps_total(reg)["ok"] <= ok0 or lock.locked():
        check(time.monotonic() < t_end,
              f"serve-http-swap: watch_dir did not deploy {want}")
        time.sleep(0.01)


def swaps_total(reg):
    m = reg.get("serving_swaps_total")
    return {o: m.value(outcome=o) if m else 0.0
            for o in ("ok", "gate_failed", "refused_memory",
                      "canary_failed", "rolled_back")}


def phase_serve_http_swap(K, pt, mb, card):
    """Phases 45-47 (see the module docstring). Returns the record; its
    ``launches`` are those of the served window (counts set to 0 just
    before the clients start and read just after they stop)."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.monitor import memory, trace
    from paddle_tpu_torch.monitor.registry import REGISTRY
    from paddle_tpu_torch.serving import (
        FrontDoorConfig, HttpFrontDoor, InferenceServer, ServingConfig,
        SwapFailedError,
    )
    from paddle_tpu_torch.serving import replica as replica_mod
    from paddle_tpu_torch.serving.server import _load_bundle

    t_phase = time.perf_counter()
    cfg = mb.mobilenet_v1()
    root = tempfile.mkdtemp(prefix="serve_http_swap_")
    rec = dict(card=card, clients=HTTP_CLIENTS, max_batch=SWAP_MAX_BATCH)
    try:
        dirs, rec["versions"] = export_mobilenet_versions(K, pt, mb, root)
        live_dir = os.path.join(root, "live")
        shutil.copytree(dirs["v2"], live_dir)
        label = {inference.read_aot_version(dirs[k]): k
                 for k in ("v1", "v2", "v3", "nan")}
        images = [mb.synthetic_batch(cfg, 1, seed=4700 + i)["image"][0]
                  for i in range(HTTP_IMAGES)]
        # the wire's host cost: one request's JSON encode (tolist + dumps)
        # and decode (loads + asarray), the front door's own work
        enc, dec = [], []
        for im in images[:5]:
            t0 = time.perf_counter()
            body = json.dumps({"feeds": {"image": im[None].tolist()}}
                              ).encode()
            enc.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            back = np.asarray(json.loads(body)["feeds"]["image"])
            dec.append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(back.astype(np.float32), im[None]),
                  "serve-http-swap: the JSON round trip changed an image")
        bodies = [json.dumps({"feeds": {"image": im[None].tolist()}}
                             ).encode() for im in images]
        rec["json"] = dict(body_bytes=len(bodies[0]),
                           floats=int(images[0].size),
                           encode_ms=statistics.median(enc),
                           decode_ms=statistics.median(dec),
                           encode_ms_all=enc, decode_ms_all=dec)
        log("serve-http-swap json " + json.dumps(rec["json"]))

        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        memory.reset()
        base = torch.cuda.memory_allocated()
        tdir = os.path.join(root, "traces")
        old_tracer = trace.TRACER
        trace.enable(tdir, sample_rate=0.05)
        t0 = time.perf_counter()
        srv = InferenceServer(dirs["v1"], ServingConfig(
            max_batch=SWAP_MAX_BATCH, replicas=1, max_queue=256,
            default_deadline_ms=120_000.0))
        rec["boot_s"] = time.perf_counter() - t0
        pools = {"v1": srv.pool}
        torch.cuda.synchronize()
        v1_alloc = torch.cuda.memory_allocated() - base
        mem = dict(v1_alone=dict(
            allocated=v1_alloc, params=params_in_ledger(memory),
            pool_param_bytes=srv.pool.resident_param_bytes(),
            projected=srv.pool.projected_bytes()))
        door = HttpFrontDoor(srv, FrontDoorConfig(socket_timeout_s=60.0))
        door.start()
        swaps0 = swaps_total(REGISTRY)
        attempts = []               # (label, outcome, canary launches)
        try:
            K.reset_launch_counts()
            load = HttpLoad(door.port, bodies).start()
            load.wait_for(HTTP_SWAP_AFTER)

            # phase 45: v1 -> v2 by hand, mid-traffic
            t_swap0 = time.perf_counter()
            report, peak_alloc, peak_params = swap_sampled(
                srv, memory, lambda: srv.swap(
                    live_dir, watchdog_ms=SWAP_WATCHDOG_MS))
            t_swap1 = time.perf_counter()
            attempts.append(("v2", "ok", 2))
            pools["v2"] = srv.pool
            check(report["outcome"] == "ok"
                  and label.get(report["model_version"]) == "v2"
                  and report["quantized"] == "int8",
                  f"serve-http-swap: swap report {report}")
            mem["both_pools"] = dict(
                params=peak_params, allocated_peak_sampled=peak_alloc - base,
                max_memory_allocated=torch.cuda.max_memory_allocated()
                - base)
            rec["swap"] = dict(
                report=report, stage_ms=report["stage_ms"],
                standby_warm_boot_s=report["stage_ms"]["standby"] / 1e3,
                live_projected_bytes=mem["v1_alone"]["projected"],
                standby_projected_bytes=srv.pool.projected_bytes(),
                window_s=t_swap1 - t_swap0)
            log("serve-http-swap swap " + json.dumps(rec["swap"]))
            wait_drained(srv)
            torch.cuda.synchronize()
            mem["v2_after_drain_under_load"] = dict(
                allocated=torch.cuda.memory_allocated() - base,
                params=params_in_ledger(memory))

            # v3 through the watched directory
            srv.watch_dir(poll_ms=SWAP_POLL_MS,
                          watchdog_ms=SWAP_WATCHDOG_MS)
            load.wait_for(HTTP_PUBLISH_AFTER)
            ok0 = swaps_total(REGISTRY)["ok"]
            t_pub = time.perf_counter()
            publish_version(dirs["v3"], live_dir)
            wait_swapped(srv, label, "v3", REGISTRY, ok0)
            t_v3 = time.perf_counter()
            attempts.append(("v3", "ok", 2))
            pools["v3"] = srv.pool
            rec["watch_deploy_s"] = t_v3 - t_pub

            # phase 46: three refusals on the live server under load
            refusals = {}
            before = swaps_total(REGISTRY)
            try:
                srv.swap(dirs["flip"])
                check(False, "swap-refusals: the flipped byte was served")
            except SwapFailedError as e:
                refusals["gate"] = dict(stage=e.stage, retryable=e.retryable,
                                        error=str(e)[:200])
            attempts.append(("flip", "gate_failed", 0))
            standby_params = int(sum(p.numel() * p.element_size()
                                     for p in _load_bundle(dirs["v2"]).params))
            projection = srv.pool.projected_bytes() + standby_params
            srv.config.hbm_limit_bytes = projection - 1
            ledger0 = memory.ledger()
            seq0 = next(replica_mod._POOL_SEQ)
            alloc0 = torch.cuda.memory_allocated()
            try:
                srv.swap(dirs["v2"])
                check(False, "swap-refusals: admission let the swap through")
            except SwapFailedError as e:
                refusals["admission"] = dict(
                    stage=e.stage, retryable=e.retryable,
                    projection=projection, limit=projection - 1,
                    error=str(e)[:300])
            finally:
                srv.config.hbm_limit_bytes = None
            seq1 = next(replica_mod._POOL_SEQ)
            refusals["admission"].update(
                pools_built_between=seq1 - seq0 - 1,
                ledger_unchanged=memory.ledger() == ledger0,
                allocated_before=alloc0 - base,
                allocated_after=torch.cuda.memory_allocated() - base)
            attempts.append(("memory", "refused_memory", 0))
            try:
                srv.swap(dirs["nan"])
                check(False, "swap-refusals: the NaN version was served")
            except SwapFailedError as e:
                refusals["canary"] = dict(stage=e.stage,
                                          retryable=e.retryable,
                                          error=str(e)[:200])
            attempts.append(("nan", "canary_failed", 1))
            cf0 = swaps_total(REGISTRY)["canary_failed"]
            publish_version(dirs["nan"], live_dir)
            t_end = time.monotonic() + 60
            while swaps_total(REGISTRY)["canary_failed"] == cf0:
                check(time.monotonic() < t_end,
                      "swap-refusals: watch_dir never tried the NaN version")
                time.sleep(0.01)
            attempts.append(("nan (watch_dir)", "canary_failed", 1))
            time.sleep(5 * SWAP_POLL_MS / 1e3)
            refusals["watch_dir_retries"] = \
                swaps_total(REGISTRY)["canary_failed"] - cf0 - 1
            check(label.get(srv.model_version) == "v3",
                  f"swap-refusals: serving {srv.model_version} after the "
                  "refusals")
            # a different version published: the watcher takes it
            ok0 = swaps_total(REGISTRY)["ok"]
            publish_version(dirs["v2"], live_dir)
            wait_swapped(srv, label, "v2", REGISTRY, ok0)
            attempts.append(("v2 again", "ok", 2))
            pools["v2 again"] = srv.pool
            after = swaps_total(REGISTRY)
            refusals["outcomes"] = {o: after[o] - before[o] for o in after}
            check(refusals["gate"]["stage"] == "gate"
                  and not refusals["gate"]["retryable"]
                  and "integrity" in refusals["gate"]["error"]
                  and refusals["admission"]["stage"] == "admission"
                  and refusals["admission"]["pools_built_between"] == 0
                  and refusals["admission"]["ledger_unchanged"]
                  and refusals["canary"]["stage"] == "canary"
                  and refusals["watch_dir_retries"] == 0
                  and refusals["outcomes"] == {
                      "ok": 1, "gate_failed": 1, "refused_memory": 1,
                      "canary_failed": 2, "rolled_back": 0},
                  f"swap-refusals: {refusals}")
            rec["refusals"] = refusals
            log("swap-refusals " + json.dumps(refusals))

            # the last stretch on the final version, then stop
            n_now = load.done()
            load.wait_for(max(HTTP_REQUESTS, n_now + HTTP_V3_MIN))
            rows = load.finish()
            counts = {k: v for k, v in K.launch_counts().items() if v}
            srv._swap_ctl().stop_watch()
            wait_drained(srv)
            # the card at rest after the last drain, the final version
            # alone: v1's footprint plus the change in params
            torch.cuda.synchronize()
            p1 = mem["v1_alone"]["pool_param_bytes"]
            p_last = srv.pool.resident_param_bytes()
            mem["final_alone"] = dict(
                allocated=torch.cuda.memory_allocated() - base,
                params=params_in_ledger(memory), pool_param_bytes=p_last,
                want=v1_alloc + (p_last - p1))
            batches = {k: sum(r.batches_run for r in p.replicas)
                       for k, p in pools.items()}
            ladder = len(srv.ladder)
            want_i8 = (sum(n for k, n in batches.items() if k != "v1")
                       + sum(ladder + c for _lab, out, c in attempts
                             if out in ("ok", "canary_failed")))
            rec["launches"] = counts
            rec["micro_batches"] = batches
            check(counts.get("fused_matmul", 0) == batches["v1"]
                  and counts.get("fused_matmul_int8", 0) == want_i8
                  and set(counts) <= {"fused_matmul", "fused_matmul_int8"},
                  f"serve-http-swap: launches {counts} over micro-batches "
                  f"{batches} and swap attempts {attempts} (ladder of "
                  f"{ladder}): expected 1 fused_matmul per v1 batch and 1 "
                  f"fused_matmul_int8 per int8 batch, warm-up run and "
                  f"canary request ({want_i8})")
            # the device's busy share over a burst of requests
            def burst():
                b = HttpLoad(door.port, bodies).start()
                b.wait_for(4 * HTTP_CLIENTS)
                b.finish()

            prof = op_breakdown(burst, top=6, host_top=6)
            rec["profile"] = prof
            rec["device_busy_share"] = (prof.get("kernel_ms", 0.0)
                                        / prof["host_ms_profiled"]
                                        if prof else None)
        finally:
            door.stop()
            closed = srv.close(timeout=300)
            trace.disable()
            trace.TRACER = old_tracer
        check(closed, "serve-http-swap: the server did not close")
        gc.collect()
        torch.cuda.synchronize()
        mem["closed_allocated"] = torch.cuda.memory_allocated() - base

        # phases 45 and 47: every request answered, by its version
        bad = [r for r in rows if r["status"] != 200]
        check(len(rows) >= HTTP_REQUESTS and not bad,
              f"serve-http-swap: {len(rows)} requests, {len(bad)} failed: "
              f"{[(r['status'], r['error']) for r in bad[:3]]}")
        ref = {k: run_version(dirs[k], images, "cuda")
               for k in ("v1", "v2", "v3")}
        served = {}
        dist = {"own": 0.0, "other": math.inf}
        for r in rows:
            v = label.get(r["version"])
            check(v in ref, f"serving-correctness: a response names "
                            f"{r['version']}")
            served[v] = served.get(v, 0) + 1
            want = ref[v][r["image"]]
            m = float(np.abs(want).max())
            own = float(np.abs(r["out"] - want).max()) / m
            other = min(float(np.abs(r["out"] - ref[o][r["image"]]).max())
                        / m for o in ref if o != v)
            dist["own"] = max(dist["own"], own)
            dist["other"] = min(dist["other"], other)
        check(dist["own"] <= HTTP_TOL["own"]
              and dist["other"] >= HTTP_TOL["other_x"] * HTTP_TOL["own"]
              and served.get("v3", 0) >= HTTP_V3_MIN,
              f"serving-correctness: responses {dist} from their versions "
              f"(relative to the largest logit), served {served}")
        cpu_v1 = run_version(dirs["v1"], images, "cpu")
        card_cpu = float(np.abs(ref["v1"] - cpu_v1).max()
                         / np.abs(cpu_v1).max())
        fp32_v2 = np.concatenate([inference.create_predictor(
            inference.Config(dirs["v2"])).run({"image": im[None]})[0]
            for im in images])
        int8_fp32 = float(np.abs(ref["v2"] - fp32_v2).max()
                          / np.abs(fp32_v2).max())
        pred_v1 = np.concatenate([inference.create_predictor(
            inference.Config(dirs["v1"])).run({"image": im[None]})[0]
            for im in images])
        pred_v1_diff = float(np.abs(pred_v1 - ref["v1"]).max()
                             / np.abs(pred_v1).max())
        check(card_cpu <= HTTP_TOL["card_cpu"]
              and int8_fp32 <= HTTP_TOL["int8_fp32"]
              and pred_v1_diff <= HTTP_TOL["own"],
              f"serving-correctness: v1 card vs CPU {card_cpu}, v2 int8 vs "
              f"fp32 {int8_fp32}, v1 Predictor vs the served program "
              f"{pred_v1_diff}")
        # the merged trace: every kept request is a whole tree with its
        # tenant
        merged = trace.merge_rank_traces(tdir, os.path.join(root,
                                                            "trace.json"))
        with open(merged) as f:
            events = json.load(f)["traceEvents"]
        roots = [e for e in events if e.get("cat") == "root"]
        names = {}
        for e in events:
            if e.get("ph") == "X":
                names.setdefault(e["args"]["trace"], set()).add(e["name"])
        stages = {"serving/queue_wait", "serving/batch_form",
                  "serving/dispatch_wait", "serving/execute",
                  "serving/deliver"}
        whole = [e for e in roots
                 if e["args"].get("tenant") in ("a", "b")
                 and e["args"].get("transport") == "http"
                 and stages <= names[e["args"]["trace"]]]
        slowest = max(rows, key=lambda r: r["t1"] - r["t0"])
        check(roots and len(whole) == len(roots),
              f"serving-correctness: {len(roots)} kept traces, "
              f"{len(whole)} with the tenant and every stage span")
        rec["correctness"] = dict(
            requests=len(rows), served=served, own_max=dist["own"],
            other_min=dist["other"], v1_card_vs_cpu=card_cpu,
            v2_int8_vs_fp32=int8_fp32, v1_predictor_vs_served=pred_v1_diff,
            kept_traces=len(roots),
            slowest_request_kept=slowest["trace_id"] in names,
            tol=HTTP_TOL)
        log("serving-correctness " + json.dumps(rec["correctness"]))

        # latency before, across and after the hand swap
        rec["latency"] = dict(
            before=latency_ms([r for r in rows if r["t1"] < t_swap0]),
            across=latency_ms([r for r in rows if r["t0"] < t_swap1
                               and r["t1"] > t_swap0]),
            after=latency_ms([r for r in rows if r["t0"] > t_swap1
                              and r["t1"] < t_pub]),
            all=latency_ms(rows),
            qps=len(rows) / (max(r["t1"] for r in rows)
                             - min(r["t0"] for r in rows)))
        rec["memory"] = mem
        log("serve-http-swap memory " + json.dumps(mem))
        fin = mem["final_alone"]
        check(abs(fin["allocated"] - fin["want"]) <= 0.1 * fin["want"]
              and fin["params"] == p_last
              and mem["v2_after_drain_under_load"]["params"] == p_last
              and mem["both_pools"]["params"] == p1 + p_last,
              f"serve-http-swap: the card's allocated bytes and resident "
              f"params {mem}; expected v1's footprint plus the change in "
              f"params within 10% once the retired pools drained")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    log("serve_http_swap " + json.dumps(
        {k: v for k, v in rec.items() if k != "profile"}))
    return rec


# ---------------------------------------------------------------------------
# phases 48-50: the eager (dygraph) surface
# ---------------------------------------------------------------------------
DY_STEPS = 10                   # counted steps of each precision (48, 49)
#: card against CPU, of the largest magnitude (at least 1): fp32 with TF32
#: off (and cuDNN's deterministic algorithms for the convolutions); the
#: draws' moments within this many standard errors
DY_TOL = {"card_cpu": 1e-5, "sigmas": 5.0}
#: the SIMT fp32 peak the fp32 steps' MFU is taken against (TF32 is off,
#: so cuBLAS's fp32 products run there; NVIDIA data sheet, H100 SXM)
FP32_SIMT_OPS_PER_S = 67e12
#: launches a step: the four embedding lookups (source and target words
#: through ``layers.embedding``, their positions through ``nn.Embedding``)
#: and one Adam update; the ResNet's one momentum update
DY_TRANSFORMER_WANT = {"embedding_gather": 4, "fused_adam": 1}
DY_RESNET_WANT = {"fused_momentum": 1}


def dygraph_init(pt, dt, dr):
    """The two eager trainers at their published configs, initialised on
    the card (from a seeded generator, with one batch each): (transformer
    model, params), (resnet model, params, state)."""
    from paddle_tpu_torch.ops.nn import no_tf32
    tcfg, rcfg = dt.transformer_base(), dr.resnet50_flowers()
    b = dt.synthetic_batch(tcfg, 480, batch=2)
    images, labels = dr.synthetic_batch(rcfg, 490, batch=2)
    tm, rm = dt.build(pt, tcfg), dr.build(pt, rcfg)
    with no_tf32():
        tp, _ = tm.init(torch.Generator(device="cuda").manual_seed(48),
                        *[torch.as_tensor(b[k], device="cuda")
                          for k in dt.INPUTS])
        rp, rs = rm.init(torch.Generator(device="cuda").manual_seed(49),
                         torch.as_tensor(images, device="cuda"),
                         torch.as_tensor(labels, device="cuda"))
    check(dt.param_count(tp) == 49_485_824,
          f"dygraph Transformer-base: {dt.param_count(tp)} values")
    check(len(rp) == 161 and len(rs) == 106,
          f"dygraph ResNet-50: {len(rp)} tensors, {len(rs)} state")
    return (tm, tp), (rm, rp, rs)


def dy_counted_steps(K, label, step, want, steps=DY_STEPS):
    """``steps`` calls of ``step()`` (each returns a 0-d loss and ends in a
    synchronize), the launch counts set to 0 just before and read just
    after: exactly ``want`` a step, nothing else registered. Returns (the
    losses, ms per step, the counts)."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = K.launch_counts()
    for name, n in counts.items():
        check(n == want.get(name, 0) * steps,
              f"{label}: {n} {name} launches in {steps} steps, expected "
              f"{want.get(name, 0)} a step")
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"{label}: {losses}")
    return losses, ms, {k: v for k, v in counts.items() if v}


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_train_dygraph_transformer(K, pt, dt, card, init):
    """The dygraph Transformer-base (``models/dygraph_transformer.py``) at
    its published widths, 64 x 64 tokens a side, eagerly: ``pt.grad`` of
    the average cost, then ``apply_gradients`` of Adam under
    ``dygraph.NoamDecay``; 1 warm-up step, then ``DY_STEPS`` counted fp32
    steps (TF32 off), then the same from the same weights under
    ``amp.decorate(..., use_bf16=True)``; then an evaluation pass under
    ``no_grad`` with dropout off. Exactly 4 gathers and 1 ``fused_adam``
    a step, 4 gathers in the evaluation."""
    from paddle_tpu_torch.ops.nn import no_tf32
    model, params0 = init
    cfg = dt.transformer_base()
    batch = dt.synthetic_batch(cfg, 48)
    inputs = [torch.as_tensor(batch[k], device="cuda") for k in dt.INPUTS]
    tokens = cfg.batch * cfg.seq_len
    flops = dt.flops_per_step(cfg, cfg.batch, cfg.seq_len, cfg.seq_len)
    rng = torch.Generator(device="cuda").manual_seed(481)
    total, rec = {}, dict(batch=cfg.batch, src_len=cfg.seq_len,
                          tgt_len=cfg.seq_len, values=dt.param_count(params0),
                          tflop_per_step=flops / 1e12, card=card)
    with no_tf32():
        for label, amp in (("fp32", False), ("bf16", True)):
            params = {k: v.clone() for k, v in params0.items()}
            opt = dt.make_optimizer(pt, cfg)
            if amp:
                opt = pt.amp.decorate(opt, use_bf16=True)
            ostate = opt.init(params)

            def step():
                loss, _, _ = dt.train_step(pt, model, opt, params, {},
                                           ostate, inputs, rng, amp=amp)
                return loss.detach()

            warm = float(step())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, ms, counts = dy_counted_steps(
                K, f"train-dygraph-transformer {label}", step,
                DY_TRANSFORMER_WANT)
            peak = torch.cuda.max_memory_allocated()
            add_counts(total, counts)
            ln_v = math.log(cfg.trg_vocab)
            check(all(0.5 * ln_v < x < 2 * ln_v for x in losses),
                  f"train-dygraph-transformer {label}: losses {losses}")
            check(not torch.equal(params["transformer/word_emb_table"],
                                  params0["transformer/word_emb_table"]),
                  f"train-dygraph-transformer {label}: Adam moved nothing")
            steady = statistics.median(ms)
            prof = op_breakdown(step, top=10, host_top=6)
            peak_rate = (PEAK_OPS_PER_S[torch.bfloat16] if amp
                         else FP32_SIMT_OPS_PER_S)
            rec[label] = dict(
                warmup_loss=warm, losses=losses, ms_per_step=steady,
                ms_per_step_quartiles=statistics.quantiles(ms, n=4),
                target_tokens_per_s=tokens / steady * 1e3,
                tokens_per_s_both_sides=2 * tokens / steady * 1e3,
                mfu=flops / (steady * 1e-3) / peak_rate,
                mfu_against_tflops=peak_rate / 1e12,
                device_busy_share=(prof.get("kernel_ms", 0.0) / steady
                                   if prof else None),
                device_events_per_step=prof.get("launches"),
                peak_gb=peak / 1e9, launches=counts, profile=prof)
            log(f"train-dygraph-transformer {label}: loss {warm:.4f} -> "
                f"{losses[-1]:.4f}, {steady:.3f} ms/step, "
                f"{rec[label]['target_tokens_per_s']:.0f} target tokens/s, "
                f"MFU {rec[label]['mfu']:.3f} of {peak_rate / 1e12:.0f} "
                f"TFLOP/s, busy {rec[label]['device_busy_share']} [{card}]")
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with pt.no_grad():
            (sum_cost, avg, predict, _), _ = model.apply(
                params, {}, None, *inputs, is_test=True)
        avg = float(avg)
        eval_ms = (time.perf_counter() - t0) * 1e3
        counts = K.launch_counts()
    check(counts.get("embedding_gather") == 4 and not any(
        v for k, v in counts.items() if k != "embedding_gather"),
        f"train-dygraph-transformer eval: launches {counts}")
    check(math.isfinite(avg) and not predict.requires_grad
          and tuple(predict.shape) == (tokens, cfg.trg_vocab),
          f"train-dygraph-transformer eval: loss {avg}, logits "
          f"{tuple(predict.shape)}")
    add_counts(total, {k: v for k, v in counts.items() if v})
    rec["eval"] = dict(loss=avg, ms=eval_ms, launches=counts)
    rec["launches"] = total
    log("train_dygraph_transformer " + json.dumps(rec))
    return rec


def phase_train_dygraph_resnet(K, pt, dr, card, init):
    """The dygraph ResNet-50 (``models/dygraph_resnet.py``) at 224^2,
    batch 32, 102 classes, fp32 with TF32 off: ``DY_STEPS`` counted eager
    Momentum steps (piecewise decay from 0.1, L2 1e-4) after 1 warm-up,
    the batch norms' running stats carried as ``nn`` state; exactly one
    ``fused_momentum`` a step. Then an evaluation batch with ``is_test``
    under ``no_grad``, scored by ``metrics.Accuracy`` on the host (no
    kernel launches)."""
    from paddle_tpu_torch.ops.nn import no_tf32
    model, params0, state0 = init
    cfg = dr.resnet50_flowers()
    images, labels = dr.synthetic_batch(cfg, 49)
    x = torch.as_tensor(images, device="cuda")
    y = torch.as_tensor(labels, device="cuda")
    params = {k: v.clone() for k, v in params0.items()}
    holder = {"state": {k: v.clone() for k, v in state0.items()}}
    opt = dr.make_optimizer(pt, cfg)
    ostate = opt.init(params)

    def step():
        loss, _, _, holder["state"], _ = dr.train_step(
            pt, model, opt, params, holder["state"], ostate, x, y)
        return loss.detach()

    with no_tf32():
        warm = float(step())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, counts = dy_counted_steps(
            K, "train-dygraph-resnet50", step, DY_RESNET_WANT)
        peak = torch.cuda.max_memory_allocated()
        state = holder["state"]
        moved = sum(not torch.equal(state[k], state0[k]) for k in state)
        check(moved == len(state), f"train-dygraph-resnet50: {moved} of "
                                   f"{len(state)} running stats moved")
        steady = statistics.median(ms)
        prof = op_breakdown(step, top=10, host_top=6)
        ev_images, ev_labels = dr.synthetic_batch(cfg, 490)
        metric = pt.metrics.Accuracy()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        before = {k: v.clone() for k, v in holder["state"].items()}
        ev_loss, ev_acc, out = dr.evaluate(
            pt, model, params, holder["state"],
            torch.as_tensor(ev_images, device="cuda"),
            torch.as_tensor(ev_labels, device="cuda"))
        metric.update(ev_acc, weight=cfg.batch)
        eval_ms = (time.perf_counter() - t0) * 1e3
        ev_counts = K.launch_counts()
    check(not any(ev_counts.values()), f"train-dygraph-resnet50 eval: "
                                       f"launches {ev_counts}")
    check(all(torch.equal(before[k], holder["state"][k]) for k in before)
          and not out.requires_grad and math.isfinite(float(ev_loss)),
          "train-dygraph-resnet50 eval: the state moved or the loss is "
          f"{float(ev_loss)}")
    acc = metric.eval()
    check(0.0 <= acc <= 1.0, f"train-dygraph-resnet50 eval accuracy {acc}")
    rec = dict(batch=cfg.batch, image_size=cfg.image_size,
               classes=cfg.class_dim, tensors=len(params),
               warmup_loss=warm, losses=losses, ms_per_step=steady,
               ms_per_step_quartiles=statistics.quantiles(ms, n=4),
               images_per_s=cfg.batch / steady * 1e3,
               device_busy_share=(prof.get("kernel_ms", 0.0) / steady
                                  if prof else None),
               device_events_per_step=prof.get("launches"),
               peak_gb=peak / 1e9, eval=dict(loss=float(ev_loss),
                                             accuracy=acc, ms=eval_ms),
               launches=counts, profile=prof, card=card)
    log(f"train-dygraph-resnet50: loss {warm:.4f} -> {losses[-1]:.4f}, "
        f"{steady:.3f} ms/step, {rec['images_per_s']:.1f} images/s, busy "
        f"{rec['device_busy_share']} [{card}]")
    log("train_dygraph_resnet50 " + json.dumps(rec))
    return rec


def dy_close(label, card, cpu, tol=None):
    """``card`` (any device) within ``tol`` (``DY_TOL["card_cpu"]``) of the
    largest magnitude of ``cpu`` (at least 1); returns the error."""
    tol = DY_TOL["card_cpu"] if tol is None else tol
    card, cpu = card.detach().float().cpu(), cpu.detach().float().cpu()
    check(card.shape == cpu.shape, f"{label}: shapes {tuple(card.shape)} "
                                   f"and {tuple(cpu.shape)}")
    err = max_err(card, cpu)
    scale = max(1.0, cpu.abs().max().item()) if cpu.numel() else 1.0
    check(err <= tol * scale, f"dygraph-correctness: {label}: card - cpu "
                              f"{err} > {tol} x {scale}")
    return err


def dy_models_card_vs_cpu(pt, dt, dr):
    """Both tiny configs 3 steps on the card and on the CPU from the same
    initial weights (the CPU init's), fp32: losses, parameters, optimizer
    slots and running stats within ``DY_TOL``. Returns the largest
    errors."""
    errs = {}
    cfg = dt.transformer_tiny()
    batch = dt.synthetic_batch(cfg, 50)
    model = dt.build(pt, cfg)
    p0, _ = model.init(torch.Generator().manual_seed(50),
                       *[torch.as_tensor(batch[k]) for k in dt.INPUTS])
    runs = {}
    for dev in ("cuda", "cpu"):
        ins = [torch.as_tensor(batch[k], device=dev) for k in dt.INPUTS]
        p = {k: v.to(dev, copy=True) for k, v in p0.items()}
        opt = dt.make_optimizer(pt, cfg)
        ost = opt.init(p)
        losses = []
        for _ in range(3):
            loss, p, ost = dt.train_step(pt, model, opt, p, {}, ost, ins)
            losses.append(loss.detach())
        runs[dev] = (torch.stack(losses), p, ost)
    errs["transformer_loss"] = dy_close("transformer_tiny losses",
                                        runs["cuda"][0], runs["cpu"][0])
    errs["transformer_params"] = max(
        dy_close(f"transformer_tiny {k}", runs["cuda"][1][k],
                 runs["cpu"][1][k]) for k in p0)
    errs["transformer_slots"] = max(
        dy_close(f"transformer_tiny {k} {s}", runs["cuda"][2]["slots"][k][s],
                 runs["cpu"][2]["slots"][k][s])
        for k in p0 for s in ("moment1", "moment2"))
    rcfg = dr.resnet_tiny()
    images, labels = dr.synthetic_batch(rcfg, 51)
    rmodel = dr.build(pt, rcfg)
    rp0, rs0 = rmodel.init(torch.Generator().manual_seed(51),
                           torch.as_tensor(images), torch.as_tensor(labels))
    runs = {}
    for dev in ("cuda", "cpu"):
        x, y = (torch.as_tensor(a, device=dev) for a in (images, labels))
        p = {k: v.to(dev, copy=True) for k, v in rp0.items()}
        s = {k: v.to(dev, copy=True) for k, v in rs0.items()}
        opt = dr.make_optimizer(pt, rcfg)
        ost = opt.init(p)
        losses = []
        for _ in range(3):
            loss, _, p, s, ost = dr.train_step(pt, rmodel, opt, p, s, ost,
                                               x, y)
            losses.append(loss.detach())
        ev = dr.evaluate(pt, rmodel, p, s, x, y)[2]
        runs[dev] = (torch.stack(losses), p, s, ev)
    errs["resnet_loss"] = dy_close("resnet_tiny losses", runs["cuda"][0],
                                   runs["cpu"][0])
    errs["resnet_params"] = max(
        dy_close(f"resnet_tiny {k}", runs["cuda"][1][k], runs["cpu"][1][k])
        for k in rp0)
    errs["resnet_state"] = max(
        dy_close(f"resnet_tiny state {k}", runs["cuda"][2][k],
                 runs["cpu"][2][k]) for k in rs0)
    errs["resnet_eval"] = dy_close("resnet_tiny eval softmax",
                                   runs["cuda"][3], runs["cpu"][3])
    return errs


def dy_nn_cases(nn):
    """Every Layer class of ``nn/layers.py`` at a small size: (label,
    layer, input arrays, indices of the inputs differentiated)."""
    import numpy as np
    rs = np.random.RandomState(52)

    def f(*shape):
        return rs.randn(*shape).astype(np.float32)

    L = nn.layers
    return [
        ("Linear", L.Linear(16, 8, act="relu"), [f(4, 16)], (0,)),
        ("FC", L.FC(8, num_flatten_dims=2, act="tanh"), [f(2, 3, 16)], (0,)),
        ("Conv2D", L.Conv2D(3, 8, 3, padding=1, act="relu"),
         [f(2, 3, 12, 12)], (0,)),
        ("Conv2DTranspose", L.Conv2DTranspose(3, 4, 3, stride=2, padding=1),
         [f(2, 3, 7, 7)], (0,)),
        ("Conv3D", L.Conv3D(2, 4, 2), [f(1, 2, 5, 5, 5)], (0,)),
        ("Conv3DTranspose", L.Conv3DTranspose(2, 3, 2, stride=2),
         [f(1, 2, 3, 3, 3)], (0,)),
        ("Pool2D", L.Pool2D(pool_size=3, pool_type="max", pool_stride=2,
                            pool_padding=1), [f(2, 3, 9, 9)], (0,)),
        ("BatchNorm", L.BatchNorm(4, act="relu"), [f(6, 4, 5, 5)], (0,)),
        ("LayerNorm", L.LayerNorm(16), [f(2, 5, 16)], (0,)),
        ("GroupNorm", L.GroupNorm(8, 4), [f(2, 8, 4, 4)], (0,)),
        ("InstanceNorm", L.InstanceNorm(3), [f(2, 3, 6, 6)], (0,)),
        ("Embedding", L.Embedding((50, 16), padding_idx=0),
         [rs.randint(0, 50, (4, 7)).astype(np.int64)], ()),
        ("PRelu", L.PRelu(mode="channel", channel=3), [f(2, 3, 4, 4)], (0,)),
        ("GRUUnit", L.GRUUnit(24), [f(4, 24), f(4, 8)], (0, 1)),
        ("LSTMCell", L.LSTMCell(8, 6), [f(4, 6), f(4, 8), f(4, 8)],
         (0, 1, 2)),
        ("GRUCell", L.GRUCell(8, 6), [f(4, 6), f(4, 8)], (0, 1)),
        ("SpectralNorm", L.SpectralNorm((8, 6), power_iters=3),
         [f(8, 6)], (0,)),
        ("NCE", L.NCE(40, 8, num_neg_samples=5),
         [f(6, 8), rs.randint(0, 40, (6, 1)).astype(np.int64),
          rs.randint(0, 40, (6, 5)).astype(np.int64)], (0,)),
        ("BilinearTensorProduct", L.BilinearTensorProduct(5, 6, 3),
         [f(4, 5), f(4, 6)], (0, 1)),
        ("RowConv", L.RowConv(8, 2), [f(2, 9, 8)], (0,)),
        ("TreeConv", L.TreeConv(8, 4, num_filters=2),
         [f(2, 6, 8), (rs.rand(2, 6, 6) > 0.6).astype(np.float32)], (0,)),
    ]


def dy_nn_card_vs_cpu(pt):
    """Every Layer class on the card against the CPU from the same
    parameters (the CPU init's): outputs, state and the gradients of the
    outputs' product with a seeded cotangent (parameters and float
    inputs, through ``pt.grad``) within ``DY_TOL``; Dropout by its rate
    on the card (2^20 draws) and its inference output exactly."""
    import numpy as np
    errs = {}
    for label, layer, arrays, diff in dy_nn_cases(pt.nn):
        p0, s0 = layer.init(torch.Generator().manual_seed(53),
                            *[torch.as_tensor(a) for a in arrays])
        res = {}
        for dev in ("cuda", "cpu"):
            xs = [torch.as_tensor(a, device=dev) for a in arrays]
            p = {k: v.to(dev, copy=True) for k, v in p0.items()}
            s = {k: v.to(dev, copy=True) for k, v in s0.items()}
            holder = {}

            def loss(p, *d):
                full = list(xs)
                for i, x in zip(diff, d):
                    full[i] = x
                out, st = layer.apply(p, s, None, *full)
                outs = out if isinstance(out, tuple) else (out,)
                cots = [torch.as_tensor(np.random.RandomState(54 + i).randn(
                    *o.shape).astype(np.float32), device=dev)
                    for i, o in enumerate(outs)]
                holder["out"], holder["state"] = outs, st
                return sum(torch.sum(o * c) for o, c in zip(outs, cots))

            grads = pt.grad(loss, argnums=tuple(range(1 + len(diff))))(
                p, *[xs[i] for i in diff])
            res[dev] = (holder["out"], holder["state"], grads)
        e = [dy_close(f"{label} out", a, b)
             for a, b in zip(res["cuda"][0], res["cpu"][0])]
        e += [dy_close(f"{label} state {k}", res["cuda"][1][k],
                       res["cpu"][1][k]) for k in s0]
        e += [dy_close(f"{label} grad {k}", res["cuda"][2][0][k],
                       res["cpu"][2][0][k]) for k in p0]
        e += [dy_close(f"{label} input grad", a, b)
              for a, b in zip(res["cuda"][2][1:], res["cpu"][2][1:])]
        errs[label] = max(e)
    p, n = 0.3, 1 << 20
    x = torch.rand(n, device="cuda") + 1.0
    drop = pt.nn.Dropout(p)
    out, _ = drop.apply({}, {}, torch.Generator(device="cuda").manual_seed(5),
                        x)
    rate = float((out == 0).float().mean())
    check(abs(rate - p) <= DY_TOL["sigmas"] * math.sqrt(p * (1 - p) / n),
          f"dygraph-correctness: Dropout rate {rate}, want {p}")
    check(torch.equal(out[out != 0], x[out != 0]),
          "dygraph-correctness: Dropout changed a kept value")
    test_out, _ = drop.apply({}, {}, None, x, is_test=True)
    check(torch.equal(test_out.cpu(), x.cpu() * (1 - p)),
          "dygraph-correctness: Dropout's inference output")
    errs["Dropout_rate"] = rate
    return errs


def loss_scale_rule(state, finite, incr_every_n, decr_every_n,
                    incr_ratio=2.0, decr_ratio=0.5):
    """The JAX package's dynamic loss-scale rule (amp/__init__.py:83-96) on
    Python numbers: (scale, good, bad) after one step."""
    scale, good, bad = state
    good, bad = (good + 1, 0) if finite else (0, bad + 1)
    if good >= incr_every_n:
        scale, good = scale * incr_ratio, 0
    if bad >= decr_every_n:
        scale, bad = max(scale * decr_ratio, 1.0), 0
    return scale, good, bad


def dy_amp_checks(pt):
    """fp16 with a ``LossScaler`` on the card over Adam under a Noam
    schedule: inf and NaN gradients injected; each ``apply_gradients`` runs
    with the card refusing every synchronisation (``no_sync``); a
    non-finite step leaves params, slots and step counter bitwise as they
    were; the scale, good and bad counts follow the JAX rule step for
    step."""
    gen = torch.Generator(device="cuda").manual_seed(55)
    params = {"w": torch.randn(64, 64, generator=gen, device="cuda"),
              "b": [torch.randn(64, generator=gen, device="cuda")]}
    scaler = pt.amp.LossScaler(8.0, incr_every_n_steps=2,
                               decr_every_n_nan_or_inf=2)
    opt = pt.amp.OptimizerWithMixedPrecision(
        pt.optimizer.Adam(learning_rate=pt.dygraph.NoamDecay(64, 10)),
        pt.amp.float16_policy(), scaler)
    st = opt.init(params)
    rule = (8.0, 0, 0)
    pattern = ("ok", "inf", "nan", "ok", "ok", "ok", "inf", "ok", "inf",
               "inf", "ok")
    skipped = 0
    for i, kind in enumerate(pattern):
        grads = {"w": torch.randn(64, 64, generator=gen, device="cuda") * 8,
                 "b": [torch.randn(64, generator=gen, device="cuda") * 8]}
        if kind != "ok":
            grads["w"][3, 5] = math.inf if kind == "inf" else math.nan
        written = [params["w"], params["b"][0], st["opt"]["step"],
                   *st["opt"]["slots"]["w"].values(),
                   *st["opt"]["slots"]["b"][0].values()]
        before = [t.clone() for t in written]
        no_sync(lambda: opt.apply_gradients(params, grads, st))
        rule = loss_scale_rule(rule, kind == "ok", 2, 2)
        got = tuple(st["loss_scale"][k].item()
                    for k in ("scale", "good", "bad"))
        check(got == rule, f"dygraph-correctness: amp step {i} ({kind}): "
                           f"loss scale state {got}, the JAX rule {rule}")
        if kind != "ok":
            skipped += 1
            check(all(torch.equal(a, b) for a, b in zip(written, before)),
                  f"dygraph-correctness: amp step {i} ({kind}) changed "
                  "params, slots or the step counter")
        else:
            check(not torch.equal(written[0], before[0]),
                  f"dygraph-correctness: amp step {i} did not update")
    check(st["opt"]["step"].item() == len(pattern) - skipped,
          f"dygraph-correctness: amp step counter {st['opt']['step']}")
    return dict(steps=len(pattern), skipped=skipped, scale=rule[0])


def dy_distribution_checks(pt):
    """Samples on the card against the closed forms: Uniform, Normal,
    MultivariateNormalDiag by their moments (2^20 draws), Categorical by
    its frequencies; the same seed gives the same draws."""
    d, n, k = pt.distributions, 1 << 20, DY_TOL["sigmas"]
    out = {}
    u = d.Uniform(torch.tensor(-1.0, device="cuda"),
                  torch.tensor(3.0, device="cuda"))
    s = u.sample([n], seed=3)
    check(s.is_cuda and torch.equal(s, u.sample([n], seed=3))
          and float(s.min()) >= -1.0 and float(s.max()) < 3.0,
          "dygraph-correctness: Uniform draws")
    std = 4.0 / math.sqrt(12.0)
    check(abs(float(s.mean()) - 1.0) <= k * std / math.sqrt(n),
          f"dygraph-correctness: Uniform mean {float(s.mean())}")
    out["uniform_mean"] = float(s.mean())
    for name, dist, mean, sd in (
            ("Normal", d.Normal(torch.tensor([0.5, -2.0], device="cuda"),
                                torch.tensor([1.0, 3.0], device="cuda")),
             [0.5, -2.0], [1.0, 3.0]),
            ("MultivariateNormalDiag", d.MultivariateNormalDiag(
                torch.tensor([1.0, 0.0, -1.0], device="cuda"),
                torch.tensor([0.5, 2.0, 1.0], device="cuda")),
             [1.0, 0.0, -1.0], [0.5, 2.0, 1.0])):
        x = dist.sample([n], seed=4).double()
        m, v = x.mean(0).tolist(), x.var(0, unbiased=False).tolist()
        for j in range(len(mean)):
            check(abs(m[j] - mean[j]) <= k * sd[j] / math.sqrt(n)
                  and abs(v[j] - sd[j] ** 2) <= k * math.sqrt(2.0 / n)
                  * sd[j] ** 2 * 1.3,
                  f"dygraph-correctness: {name} moments {m[j]}, {v[j]}")
        out[name] = [m, v]
    probs = torch.tensor([0.1, 0.6, 0.3], device="cuda")
    c = d.Categorical(torch.log(probs)).sample([n], seed=6)
    freq = (torch.bincount(c, minlength=3).double() / n).tolist()
    for j, pj in enumerate(probs.tolist()):
        check(abs(freq[j] - pj) <= k * math.sqrt(pj * (1 - pj) / n),
              f"dygraph-correctness: Categorical frequency {freq}")
    out["categorical"] = freq
    return out


def phase_dygraph_checks(K, pt, dt, dr, card):
    """Phase 50 (dygraph-correctness): the tiny trainers and every Layer
    class on the card against the CPU, ``amp``'s skipped steps with no
    host read, the distributions' draws, and ``save_dygraph`` on the card
    loaded on the CPU bit for bit; the card's launches counted over the
    phase."""
    import tempfile
    from paddle_tpu_torch.ops.nn import no_tf32
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.synchronize()
    K.reset_launch_counts()
    try:
        with no_tf32():
            models = dy_models_card_vs_cpu(pt, dt, dr)
            layers = dy_nn_card_vs_cpu(pt)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = cudnn
    amp = dy_amp_checks(pt)
    dists = dy_distribution_checks(pt)
    gen = torch.Generator(device="cuda").manual_seed(56)
    tree = {"w": torch.randn(33, 7, generator=gen, device="cuda"),
            "stats": [torch.randn(7, generator=gen, device="cuda"),
                      torch.arange(5, device="cuda", dtype=torch.int32)],
            "step": 3}
    with tempfile.TemporaryDirectory() as d:
        pt.io.save_dygraph(tree, os.path.join(d, "m"))
        back, _ = pt.io.load_dygraph(os.path.join(d, "m"), device="cpu")
    check(back["step"] == 3 and all(
        torch.equal(a.cpu(), b) and b.device.type == "cpu"
        for a, b in ((tree["w"], back["w"]),
                     (tree["stats"][0], back["stats"][0]),
                     (tree["stats"][1], back["stats"][1]))),
        "dygraph-correctness: save_dygraph on the card, load_dygraph on "
        "the CPU")
    counts = {k: v for k, v in K.launch_counts().items() if v}
    check(counts.get("embedding_gather", 0) > 0
          and counts.get("fused_adam", 0) > 0
          and counts.get("fused_momentum", 0) > 0,
          f"dygraph-correctness: launches {counts}")
    rec = dict(models=models, layers=layers, amp=amp, distributions=dists,
               tol=DY_TOL, launches=counts, card=card)
    log("dygraph_correctness " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phases 51-53: observability on the PTB LM at lm_model.py's medium config
# ---------------------------------------------------------------------------
#: steps of each monitor configuration of phase 51, from the same state
OBS_STEPS = 40
#: phase 51: the cost monitor's FLOPs a step against the analytic count of
#: the config's matrix products (forward, and twice that backward)
OBS_FLOPS_TOL = 0.01
#: phase 51: each configuration's losses against off's. The first step's
#: loss is bitwise equal (the forward from the same state, the same dropout
#: masks); later ones differ by rounding: the embedding's gradient is a
#: float-atomic index_add_ on the card, whose order changes from run to
#: run, and SGD at rate 1.0 carries that into the next losses. Held to
#: this relative gap: about 100 times the 9.6e-8 that every configuration
#: read against off on an H100 (off against off again is the floor the run
#: measures), and below what one dropped update moves the losses by (the
#: phase shows it: ``obs_dropped_update``)
OBS_LOSS_REL = 1e-5
#: phase 52: the clean checked step against the unchecked one from the same
#: state: the loss bitwise, the parameters within this absolute gap (the
#: same index_add_ rounding, at rate 1.0)
CLEAN_PARAM_GAP = 1e-6
#: phase 53's limits, card against the port on the CPU in fp32 with TF32
#: off, set before the first card run: the tensor-watch stats are norms of
#: the grads and of the update, so they take phase 30's relative gradient
#: error (LM_TOL); the cost FLOPs count the same plain bodies on meta
#: tensors on both devices, so they are equal; the localizer's report
#: names the same tensor, op, index and counts
MON_TOL = {"watch_rel": LM_TOL["grad_relnorm_err"], "flops": 0.0}
LM_WANT = {"embedding_gather": 1, "fused_matmul": 1, "fused_sgd": 7}


def lm_flops(cfg):
    """The LM's matrix-product FLOPs a step: each of the B*T tokens runs
    every layer's [x, h] x [2H, 4H] gate product and the [H, V] softmax fc,
    2 FLOPs a multiply-add, forward once and backward twice."""
    H = cfg.hidden
    return (cfg.batch * cfg.num_steps * 3
            * (cfg.layers * 2 * (2 * H) * (4 * H) + 2 * H * cfg.vocab))


def lm_state(pt, ptb_lm, cfg):
    """(startup-made persistables as numpy, the built program's dict)."""
    built = ptb_lm.build_train(pt, cfg)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(built["startup"], scope=scope)
    snap = {n: scope.find_var(n).cpu().numpy().copy()
            for n, v in built["startup"].global_block().vars.items()
            if v.persistable}
    return snap, built


def lm_feeds(cfg, built, windows, device):
    """The feed of each window: x, y and a zero initial state, on the
    device."""
    import numpy as np
    xn, yn = [v.name for v in built["reader"].vars]
    z = np.zeros((cfg.batch, cfg.state_width), np.float32)
    return [{xn: torch.as_tensor(x, device=device),
             yn: torch.as_tensor(y, device=device),
             "init": torch.as_tensor(z, device=device)} for x, y in windows]


def lm_run(pt, built, scope, feeds, device, exe=None):
    """One step per feed through ``Executor.run``; returns (losses, ms of
    each step, the executor). Each step ends in the loss's host read."""
    exe = exe or pt.Executor(pt.CPUPlace() if device == "cpu" else None)
    losses, ms = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        (loss,) = exe.run(built["main"], feed=feed,
                          fetch_list=[built["loss"]], scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, ms, exe


def group_kernels(rows, groups=KERNEL_GROUPS):
    """{group: [device ms, calls]} of [(kernel name, ms, calls)]."""
    import re
    out = {}
    for name, ms, n in rows:
        g = next((g for g, pat in groups if re.search(pat, name, re.I)),
                 "other")
        acc = out.setdefault(g, [0.0, 0])
        acc[0] += ms
        acc[1] += n
    return out


def _monitors_on(names, tmp):
    """Turn on the monitors of one phase-51 configuration; returns the
    function that turns them off again."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.monitor import (
        anomaly, flight_recorder, goodput, tensorwatch, trace)
    undo = None
    if "trace" in names:
        trace.enable(os.path.join(tmp, "traces"), sample_rate=1.0)
    if "profiler" in names:
        profiler.start_profiler()
    if "goodput" in names:
        goodput.enable()
    if "anomaly" in names:
        anomaly.enable()
    if "flight" in names:
        undo = flight_recorder.RECORDER.install(os.path.join(tmp, "pm"))
        flight_recorder.enable()
    if "watch" in names:
        tensorwatch.enable()
    if "check" in names:
        import paddle_tpu_torch as pt
        pt.set_flags({"check_nan_inf": True})

    def off():
        import paddle_tpu_torch as pt
        pt.set_flags({"check_nan_inf": False})
        tensorwatch.disable()
        flight_recorder.disable()
        if undo is not None:
            undo()
        anomaly.disable()
        goodput.disable()
        if "profiler" in names:
            profiler.stop_profiler()
        if "trace" in names:
            trace.disable()
    return off


#: the monitors of each phase-51 configuration
OBS_ON = {"off": (), "trace+profiler": ("trace", "profiler"),
          "goodput+anomaly+flight": ("goodput", "anomaly", "flight"),
          "tensorwatch": ("watch",), "check_nan_inf": ("check",),
          "all": ("trace", "profiler", "goodput", "anomaly", "flight",
                  "watch", "check"), "off again": ()}
#: phase 51 runs the configurations in turns: this many rounds of
#: ``OBS_STEPS // OBS_ROUNDS`` steps each, so the host's drift lands on
#: every configuration alike (the step is host-bound)
OBS_ROUNDS = 5


class HookTimer:
    """Host time inside the Executor's monitor hooks, by monitor. While
    installed, each hook is a wrapper that reads ``time.perf_counter``
    around it and keeps its exclusive seconds and its calls: a hook called
    from another (the flight recorder's span from a ``RecordEvent``) counts
    in its own monitor only. ``install()`` after the monitors are on
    (``anomaly.enable`` makes a new detector), ``remove()`` before they go
    off. The profiler's ``RecordEvent`` spans run in every configuration:
    off's reading is their cost with the profiler off."""

    def __init__(self):
        self.secs, self.calls, self._stack, self._undo = {}, {}, [], []

    @staticmethod
    def _targets():
        from paddle_tpu_torch import profiler
        from paddle_tpu_torch.monitor import (
            anomaly, flight_recorder, goodput, numerics, tensorwatch, trace)
        from paddle_tpu_torch.static.program import OP_REGISTRY
        return [
            ("trace", trace, ("start_trace", "record_span",
                              "record_exemplar", "end_trace")),
            ("profiler", profiler.RecordEvent, ("__enter__", "__exit__")),
            ("goodput", goodput, ("on_run_start", "on_run_end")),
            ("anomaly", anomaly.DETECTOR, ("observe",)),
            ("flight", flight_recorder.RECORDER, ("note", "span_push",
                                                  "span_pop")),
            ("tensorwatch", tensorwatch, ("on_step",)),
            ("tensorwatch", OP_REGISTRY, ("tensor_watch_pre",
                                          "tensor_watch_post")),
            ("check_nan_inf", numerics, ("snapshot", "sentinel")),
            # the checked step's host read waits here for the card, where
            # an unchecked step waits in its fetch
            ("check_nan_inf flag read", numerics, ("read_flags",))]

    def _wrap(self, label, fn):
        def timed(*a, **k):
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                inner = self._stack.pop()
                self.secs[label] = self.secs.get(label, 0.0) + dt - inner
                self.calls[label] = self.calls.get(label, 0) + 1
                if self._stack:
                    self._stack[-1] += dt
        return timed

    def install(self):
        for label, owner, names in self._targets():
            for n in names:
                if isinstance(owner, dict):
                    fn = owner[n]
                    owner[n] = self._wrap(label, fn)
                    self._undo.append(
                        lambda o=owner, n=n, f=fn: o.__setitem__(n, f))
                    continue
                own = n in vars(owner)
                fn = getattr(owner, n)
                setattr(owner, n, self._wrap(label, fn))
                self._undo.append(
                    lambda o=owner, n=n, f=fn, own=own:
                    setattr(o, n, f) if own else delattr(o, n))

    def remove(self):
        while self._undo:
            self._undo.pop()()

    def per_step(self, steps):
        """{monitor: [host ms a step, calls a step]}."""
        return {k: [v * 1e3 / steps, self.calls[k] / steps]
                for k, v in sorted(self.secs.items())}


def obs_monitor_device_ms(pt, runs, tmp, snap, n=10):
    """Device ms of the work ``check_nan_inf`` and tensor watch add to a
    step, from CUDA events around it (``events_ms``), on the tensors of one
    real step of each (their configurations' executors and scopes, after
    the rounds): the snapshot of the persistables, the sentinels over each
    segment's writes, and the two watch ops."""
    from paddle_tpu_torch.monitor import numerics
    from paddle_tpu_torch.static.program import OP_REGISTRY
    took = {"sentinel": []}
    real = {"sentinel": numerics.sentinel,
            "tensor_watch_pre": OP_REGISTRY["tensor_watch_pre"],
            "tensor_watch_post": OP_REGISTRY["tensor_watch_post"]}

    def grab_sentinel(values, device=None):
        took["sentinel"].append((list(values), device))
        return real["sentinel"](values, device)

    def grabber(t):
        def grab(ins, attrs):
            took[t] = ({k: list(v) for k, v in ins.items()}, dict(attrs))
            return real[t](ins, attrs)
        return grab

    numerics.sentinel = grab_sentinel
    for t in ("tensor_watch_pre", "tensor_watch_post"):
        OP_REGISTRY[t] = grabber(t)
    try:
        for name in ("check_nan_inf", "tensorwatch"):
            r = runs[name]
            off = _monitors_on(r["on"], tmp)
            try:
                lm_run(pt, r["built"], r["scope"], r["feeds"][:1], "cuda",
                       r["exe"])
            finally:
                off()
    finally:
        numerics.sentinel = real["sentinel"]
        for t in ("tensor_watch_pre", "tensor_watch_post"):
            OP_REGISTRY[t] = real[t]
    scope = runs["check_nan_inf"]["scope"]
    state = {k: scope.find_var(k) for k in snap}
    pre, post = took["tensor_watch_pre"], took["tensor_watch_post"]
    out = dict(
        snapshot=events_ms(lambda: numerics.snapshot(state), n)[0],
        sentinels=events_ms(lambda: [numerics.sentinel(v, d)
                                     for v, d in took["sentinel"]], n)[0],
        sentinel_segments=len(took["sentinel"]),
        sentinel_tensors=sum(len(v) for v, _ in took["sentinel"]),
        watch_pre=events_ms(lambda: real["tensor_watch_pre"](*pre), n)[0],
        watch_post=events_ms(lambda: real["tensor_watch_post"](*post),
                             n)[0])
    out["check_nan_inf"] = out["snapshot"] + out["sentinels"]
    out["tensorwatch"] = out["watch_pre"] + out["watch_post"]
    return out


def obs_dropped_update(pt, ptb_lm, cfg, built, snap, device, feeds,
                       off_losses):
    """The loss check's power: off's first four steps again, with the
    second step's update dropped (the parameters put back to their values
    before it, as a monitor that lost an update would leave them). Returns
    the largest relative gap of the last two losses to off's, which the
    phase requires above ``OBS_LOSS_REL``."""
    scope = pt.Scope.from_numpy(snap, device, built["startup"])
    exe = pt.Executor(pt.CPUPlace() if device == "cpu" else None)
    names = ptb_lm.param_names(cfg)
    losses, _, _ = lm_run(pt, built, scope, feeds[:1], device, exe)
    pre = {n: scope.find_var(n).clone() for n in names}
    more, _, _ = lm_run(pt, built, scope, feeds[1:2], device, exe)
    with torch.no_grad():
        for n, v in pre.items():
            scope.find_var(n).copy_(v)
    rest, _, _ = lm_run(pt, built, scope, feeds[2:4], device, exe)
    return max(abs(a - b) / abs(b) for a, b in zip(rest, off_losses[2:4]))


def phase_observe_ptb_lm(K, pt, ptb_lm, card, cfg=None, device="cuda",
                         steps=OBS_STEPS):
    """Phase 51: the LM at medium through ``Executor.run`` from one state
    under each configuration of ``OBS_ON`` (off, each monitor group, all,
    off again), each its own executor and scope, run in turns
    (``OBS_ROUNDS`` rounds of a share of ``steps``; each step ends in the
    loss's host read): steady ms a step and the overhead against off; what
    each monitor adds, measured directly: the host ms a step inside its
    hooks (``HookTimer``) and the device ms of its own work
    (``obs_monitor_device_ms``); the launch counts (exactly 1/1/7 a step in
    every configuration); the losses against off's (``OBS_LOSS_REL``, which
    a dropped update must exceed: ``obs_dropped_update``); the extra peak
    of each; the cost FLOPs against the analytic count, MFU, tensor watch's
    stats against the norms from the snapshot, the profiler's device spans
    against the launch counts and ``op_breakdown``, goodput's
    compile/compute split and a ``MetricsServer`` scrape."""
    import tempfile

    import numpy as np
    from paddle_tpu_torch.clip import global_norm
    from paddle_tpu_torch.monitor import (
        cost, exporter, goodput, memory, tensorwatch)
    from paddle_tpu_torch.monitor.registry import REGISTRY
    cuda = device == "cuda"
    cfg = cfg or ptb_lm.medium()
    per = steps // OBS_ROUNDS
    windows = lm_windows(ptb_lm, cfg, per * OBS_ROUNDS, 51)
    snap, plain = lm_state(pt, ptb_lm, cfg)
    tensorwatch.enable()
    try:
        watched = ptb_lm.build_train(pt, cfg)
    finally:
        tensorwatch.disable()
    tmp = tempfile.mkdtemp(prefix="obs51.")
    srv = exporter.MetricsServer(port=0).start()
    steps_total = REGISTRY.get("executor_steps_total")
    runs = {}
    for name, on in OBS_ON.items():
        built = watched if "watch" in on else plain
        runs[name] = dict(
            built=built, on=on,
            scope=pt.Scope.from_numpy(snap, device, built["startup"]),
            feeds=lm_feeds(cfg, built, windows, device),
            exe=pt.Executor(pt.CPUPlace() if device == "cpu" else None),
            ms=[], losses=[], peak=0, counts={}, scraped=0.0, ran=0,
            timer=HookTimer(), fetch=[0.0, 0])
    fetch_h = REGISTRY.get("executor_fetch_ms")
    try:
        for rnd in range(OBS_ROUNDS):
            for name, r in runs.items():
                off = _monitors_on(r["on"], tmp)
                try:
                    feeds = r["feeds"][rnd * per:(rnd + 1) * per]
                    scraped0 = exporter.parse_text(urllib_get(srv.port))[
                        1].get(("executor_steps_total", ()), 0.0)
                    steps0 = steps_total.value()
                    phases0 = {p: goodput._c_phase.value(phase=p)
                               for p in ("compile", "device_compute")}
                    start = 0
                    if rnd == 0:
                        # the first step builds the runner: not counted.
                        # The Executor measures its peak when it sets a
                        # new high of the process, so the high is reset
                        if cuda:
                            torch.cuda.reset_peak_memory_stats()
                        losses, ms, _ = lm_run(pt, r["built"], r["scope"],
                                               feeds[:1], device, r["exe"])
                        r["losses"] += losses
                        r["first_step_ms"] = ms[0]
                        r["cost"] = (cost.flops_per_step(),
                                     cost.bytes_per_step())
                        r["goodput_first_step"] = {
                            p: goodput._c_phase.value(phase=p) - phases0[p]
                            for p in phases0}
                        phases0 = {p: goodput._c_phase.value(phase=p)
                                   for p in phases0}
                        start = 1
                    if cuda:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        base = torch.cuda.memory_allocated()
                    K.reset_launch_counts()
                    fetch0 = (fetch_h.sum(), fetch_h.count())
                    r["timer"].install()
                    try:
                        losses, ms, _ = lm_run(pt, r["built"], r["scope"],
                                               feeds[start:], device,
                                               r["exe"])
                    finally:
                        r["timer"].remove()
                    r["fetch"][0] += fetch_h.sum() - fetch0[0]
                    r["fetch"][1] += fetch_h.count() - fetch0[1]
                    for k, v in K.launch_counts().items():
                        r["counts"][k] = r["counts"].get(k, 0) + v
                    if cuda:
                        r["peak"] = max(r["peak"],
                                        torch.cuda.max_memory_allocated()
                                        - base)
                    r["goodput_after"] = {
                        p: r.get("goodput_after", {}).get(p, 0.0)
                        + goodput._c_phase.value(phase=p) - phases0[p]
                        for p in phases0}
                    r["losses"] += losses
                    r["ms"] += ms
                    r["ran"] += steps_total.value() - steps0
                    r["scraped"] += exporter.parse_text(urllib_get(
                        srv.port))[1].get(("executor_steps_total", ()),
                                          0.0) - scraped0
                finally:
                    off()
        # tensor watch: one more step, its stats against the snapshot's
        r = runs["tensorwatch"]
        off = _monitors_on(r["on"], tmp)
        try:
            names = ptb_lm.param_names(cfg)
            old = [r["scope"].find_var(n).clone() for n in names]
            (_, stats) = r["exe"].run(
                r["built"]["main"], feed=r["feeds"][0],
                fetch_list=[r["built"]["loss"], tensorwatch.STATS_VAR],
                scope=r["scope"], return_numpy=False)
            new = [r["scope"].find_var(n) for n in names]
        finally:
            off()
        gn, pn, un, ratio = stats.tolist()
        pn_t = global_norm(old)
        un_t = global_norm([a - b for a, b in zip(new, old)])
        ratio_d = (un_t / torch.clamp(pn_t, min=1e-12)).item()
        watch = dict(stats=[gn, pn, un, ratio], param_norm_direct=pn_t.item(),
                     update_norm_direct=un_t.item(), ratio_direct=ratio_d,
                     clip_relation=[min(gn, cfg.max_grad_norm) * cfg.lr, un],
                     gauges_published={k: REGISTRY.get(k).value() for k in (
                         "grad_global_norm", "param_global_norm",
                         "update_ratio")})
        check(pn == pn_t.item() and un == un_t.item() and ratio == ratio_d,
              f"observe-ptb-lm tensorwatch: stats {watch}")
        check(abs(min(gn, cfg.max_grad_norm) * cfg.lr - un) <= 1e-4 * un,
              f"observe-ptb-lm tensorwatch: the update norm is not lr x "
              f"the clipped grad norm: {watch}")
        rec = dict(configs={}, tensorwatch=watch)
        if cuda:
            rec["monitor_device_ms"] = obs_monitor_device_ms(pt, runs, tmp,
                                                             snap)
        ref = runs["off"]
        rec["dropped_update_loss_rel_gap"] = obs_dropped_update(
            pt, ptb_lm, cfg, plain, snap, device, ref["feeds"],
            ref["losses"])
        check(rec["dropped_update_loss_rel_gap"] > OBS_LOSS_REL,
              f"observe-ptb-lm: one dropped update moved the losses by "
              f"{rec['dropped_update_loss_rel_gap']}, within the "
              f"{OBS_LOSS_REL} the configurations are held to")
        for name, r in runs.items():
            counted = len(r["ms"])
            for k, v in r["counts"].items():
                check(v == LM_WANT.get(k, 0) * counted,
                      f"observe-ptb-lm {name}: {v} {k} launches in "
                      f"{counted} steps, expected {LM_WANT.get(k, 0)} a "
                      "step")
            gap = max(abs(a - b) / abs(b)
                      for a, b in zip(r["losses"], ref["losses"]))
            check(r["losses"][0] == ref["losses"][0]
                  and gap <= OBS_LOSS_REL,
                  f"observe-ptb-lm {name}: the losses moved under the "
                  f"monitors: {r['losses'][0]} vs {ref['losses'][0]}, "
                  f"relative gap {gap}")
            check(r["scraped"] == r["ran"],
                  f"observe-ptb-lm {name}: the scrape moved "
                  f"executor_steps_total by {r['scraped']}, {r['ran']} ran")
            c = dict(ms_per_step_steady=statistics.median(r["ms"]),
                     ms_per_step_quartiles=statistics.quantiles(r["ms"],
                                                                n=4),
                     first_step_ms=r["first_step_ms"], steps=counted,
                     peak_gb=r["peak"] / 1e9, loss_first=r["losses"][0],
                     loss_last=r["losses"][-1], loss_rel_gap_to_off=gap,
                     steps_scraped=r["scraped"],
                     hook_host_ms_per_step=r["timer"].per_step(counted),
                     fetch_ms_mean=r["fetch"][0] / max(r["fetch"][1], 1),
                     launches_per_step={k: v // counted
                                        for k, v in r["counts"].items()
                                        if v})
            if "goodput" in r["on"]:
                c.update(goodput_first_step=r["goodput_first_step"],
                         goodput_after=r["goodput_after"])
                check(r["goodput_first_step"]["compile"] > 0
                      and r["goodput_after"]["compile"] == 0
                      and r["goodput_after"]["device_compute"] > 0,
                      f"observe-ptb-lm {name}: goodput split {c}")
            rec["configs"][name] = c
        off_ms = rec["configs"]["off"]["ms_per_step_steady"]
        for c in rec["configs"].values():
            # the host time in the hooks, the flag read's wait for the card
            # apart (an unchecked step waits as long in its fetch)
            c["hook_host_ms"] = sum(
                v[0] for k, v in c["hook_host_ms_per_step"].items()
                if k != "check_nan_inf flag read")
        off_hooks = rec["configs"]["off"]["hook_host_ms"]
        for name, c in rec["configs"].items():
            c["overhead_ms"] = c["ms_per_step_steady"] - off_ms
            c["overhead_rel"] = c["ms_per_step_steady"] / off_ms - 1.0
            c["hook_host_ms_over_off"] = c["hook_host_ms"] - off_hooks
            log(f"observe-ptb-lm {name}: steady {c['ms_per_step_steady']:.3f}"
                f" ms/step ({c['overhead_rel'] * 100:+.2f} % against off), "
                f"hooks {c['hook_host_ms']:.4f} ms of host a step "
                f"({c['hook_host_ms_over_off']:+.4f} over off), fetch "
                f"{c['fetch_ms_mean']:.3f} ms, peak {c['peak_gb']:.4f} GB "
                f"[{card}]")
        if cuda:
            log("observe-ptb-lm monitors' device ms a step "
                + json.dumps(rec["monitor_device_ms"]) + f" [{card}]")
        from paddle_tpu_torch import profiler
        report = profiler.summary()
        check("executor.run/dispatch" in report and "MFU estimate" in report,
              f"observe-ptb-lm: profiler summary {report}")
        flops, nbytes = runs["off"]["cost"]
        want = lm_flops(cfg)
        for name, r in runs.items():
            rec["configs"][name]["flops_per_step"], \
                rec["configs"][name]["bytes_per_step"] = r["cost"]
            check(abs(r["cost"][0] - want) <= OBS_FLOPS_TOL * want,
                  f"observe-ptb-lm {name}: cost FLOPs {r['cost'][0]} "
                  f"against the analytic {want}")
        counts_all = {}
        for r in runs.values():
            for k, v in r["counts"].items():
                counts_all[k] = counts_all.get(k, 0) + v
        rec.update(
            config="lm_model.py medium" if cfg == ptb_lm.medium() else str(
                cfg), rounds=OBS_ROUNDS, steps_per_round=per,
            flops_per_step=flops, flops_analytic=want,
            flops_rel_err=flops / want - 1.0,
            bytes_per_step=nbytes, off_ms_per_step=off_ms,
            mfu_at_steady=cost.estimate_mfu(ms_per_step=off_ms),
            peak_flops=cost.peak_flops(),
            mfu_at_steady_fp32_simt=flops / (off_ms / 1e3) / 67e12,
            check_nan_inf_extra_peak_gb=rec["configs"]["check_nan_inf"][
                "peak_gb"] - rec["configs"]["off"]["peak_gb"],
            state_gb=sum(np.asarray(v).nbytes for v in snap.values()) / 1e9,
            memory_peak_bytes_per_step=memory.peak_bytes_per_step(),
            profiler_summary=report.splitlines(), trace_files=sorted(
                os.listdir(os.path.join(tmp, "traces"))),
            launches=counts_all, card=card)
        if cuda:
            rec["device_spans"] = obs_device_spans(
                K, pt, profiler, plain, snap, device, runs["off"]["feeds"],
                tmp)
    finally:
        srv.stop()
    log("observe_ptb_lm " + json.dumps(rec))
    return rec


def urllib_get(port):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        return resp.read().decode()


#: spin kernels that open phase 51's profiled session ahead of the steps
OBS_PAD_KERNELS = 256


def obs_device_spans(K, pt, profiler, built, snap, device, feeds, tmp):
    """Two steps under ``profiler.profiler(trace_dir=...)`` (torch.profiler
    in the JAX profiler's role): its kernels by ``KERNEL_GROUPS``, the three
    registered kernels' calls, which must equal their launch counts, and
    its groups against ``op_breakdown``'s of one step. Late in a long
    process a profiling session can lose the kernel records at its start
    (~40 of a step's 3,612 on an H100 at the end of a run of every phase):
    a pause and ``OBS_PAD_KERNELS`` spin kernels open the session, and the
    spins the trace misses are the records it lost there."""
    scope = pt.Scope.from_numpy(snap, device, built["startup"])
    exe = pt.Executor()

    def one_step():
        exe.run(built["main"], feed=feeds[0], fetch_list=[built["loss"]],
                scope=scope)

    one_step()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with profiler.profiler(trace_dir=os.path.join(tmp, "torch_trace")):
        time.sleep(0.05)
        for _ in range(OBS_PAD_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        one_step()
        one_step()
        torch.cuda.synchronize()
    counts = {k: v for k, v in K.launch_counts().items() if v}
    rows = profiler.device_kernel_times()
    pads = sum(c for n, _, c in rows if "spin_kernel" in n)
    rows = [r for r in rows if "spin_kernel" not in r[0]]
    mine = group_kernels(rows)
    ref = op_breakdown(one_step, top=1000)
    out = dict(launches=counts, groups=mine,
               op_breakdown_groups_ms=ref["groups_ms"],
               records_lost_at_start=OBS_PAD_KERNELS - pads,
               step_records=sum(c for _, _, c in rows),
               op_breakdown_step_records=ref["launches"],
               kernels=[[n[:100], ms, c] for n, ms, c in rows],
               trace_files=os.listdir(os.path.join(tmp, "torch_trace")))
    log("observe-ptb-lm device spans " + json.dumps(out))
    check(counts == {k: 2 * v for k, v in LM_WANT.items()},
          f"observe-ptb-lm: the two profiled steps launched {counts}")
    for g in ("embedding_gather", "fused_matmul", "fused_sgd"):
        check(mine.get(g, [0, 0])[1] == counts.get(g),
              f"observe-ptb-lm: the profiler saw {mine.get(g)} of {g} "
              f"against {counts.get(g)} launches in two steps "
              f"({out['records_lost_at_start']} records lost at the "
              f"session's start)")
    big = {g for g, ms in ref["groups_ms"].items()
           if ms >= 0.01 * ref["kernel_ms"]}
    check(big <= set(mine), f"observe-ptb-lm: op_breakdown's groups "
          f"{sorted(big)} missing from the profiler's {sorted(mine)}")
    return out


def lm_grad_overflow(scope, cfg):
    """Make ``fc_weight1_0@GRAD`` overflow while the forward stays finite:
    the embedding rows at +-1e38 (the forward never sees them: the gate
    matmul's input rows of ``fc_weight1_0`` are zero, 0 x 1e38 = 0), and
    ``softmax_weight`` scaled by 1e4 so the gates' gradients are O(10);
    the input rows' gradient, the embedding times those gradients summed
    over the tokens, is then far beyond fp32. No other leaf overflows: the
    embedding's gradient is the gates' gradients times the zero rows."""
    H = cfg.hidden
    with torch.no_grad():
        emb = scope.find_var("embedding_para")
        emb.copy_(torch.sign(emb) * 1e38)
        scope.find_var("fc_weight1_0")[:H].zero_()
        scope.find_var("softmax_weight").mul_(1e4)


def phase_nonfinite_ptb_lm(K, pt, ptb_lm, card, cfg=None, device="cuda"):
    """Phase 52: the LM at medium under ``check_nan_inf``, three trips: NaN
    fed in ``init``, +inf in one row of ``embedding_para``, and a gradient
    leaf that overflows (``lm_grad_overflow``). Each report names the right
    tensor and op type and leaves the scope's parameters bitwise at their
    pre-step values; ``nonfinite_trips_total`` moves by 3; the anomaly
    postmortem carries the first report; the next clean checked step equals
    an unchecked executor's from the same state (same @step@, same dropout
    masks), bitwise; the sentinel trips on NaN, +inf and -inf on the
    device; a checked step whose first segment writes only an int tensor
    runs (``int_segment_step``)."""
    import tempfile

    from paddle_tpu_torch.monitor import flight_recorder, numerics
    from paddle_tpu_torch.monitor.registry import REGISTRY
    cfg = cfg or ptb_lm.medium()
    windows = lm_windows(ptb_lm, cfg, 1, 52)
    snap, built = lm_state(pt, ptb_lm, cfg)
    names = ptb_lm.param_names(cfg)
    feed = lm_feeds(cfg, built, windows, device)[0]
    xn = built["reader"].vars[0].name
    row = int(feed[xn][0, 0])
    exe = pt.Executor(pt.CPUPlace() if device == "cpu" else None)
    tmp = tempfile.mkdtemp(prefix="nonfinite52.")
    undo = flight_recorder.RECORDER.install(tmp)
    flight_recorder.enable()
    from paddle_tpu_torch.monitor import anomaly
    anomaly._dumped_kinds.discard("non_finite")
    trips0 = REGISTRY.get("nonfinite_trips_total").value()
    scope = pt.Scope.from_numpy(snap, device, built["startup"])
    main_ops = built["main"].global_block().ops
    scan_outs = next(op for op in main_ops
                     if op.type == "scan_block").output_names()
    emb_out = next(op for op in main_ops
                   if op.type == "embedding").output_names()
    cases = (
        ("nan-init", lambda s: None,
         {"init": torch.full_like(feed["init"], 0.0).index_fill_(
             0, torch.tensor([0], device=feed["init"].device),
             float("nan"))},
         lambda r: r["op_type"] == "scan_block"
         and r["tensor"] in scan_outs and r["nan_count"] > 0),
        ("inf-embedding-row",
         lambda s: s.find_var("embedding_para")[row].fill_(float("inf")),
         {}, lambda r: r["op_type"] == "embedding"
         and r["tensor"] in emb_out and r["inf_count"] > 0),
        ("overflowing-grad-leaf", lambda s: lm_grad_overflow(s, cfg), {},
         lambda r: r["op_type"] == "autodiff"
         and r["tensor"] == "fc_weight1_0@GRAD"))
    rec = dict(trips={})
    pt.set_flags({"check_nan_inf": True})
    try:
        for label, poison, feed_over, ok in cases:
            with torch.no_grad():
                poison(scope)
            pre = {n: scope.find_var(n).clone() for n in names}
            t0 = time.perf_counter()
            try:
                exe.run(built["main"], feed={**feed, **feed_over},
                        fetch_list=[built["loss"]], scope=scope)
                report = None
            except numerics.NonFiniteError as e:
                report = e.report
            ms = (time.perf_counter() - t0) * 1e3
            check(report is not None and report.get("localized")
                  and ok(report), f"nonfinite-ptb-lm {label}: {report}")
            bitwise = all(torch.equal(pre[n], scope.find_var(n))
                          for n in names)
            check(bitwise, f"nonfinite-ptb-lm {label}: the scope's "
                           "parameters moved")
            rec["trips"][label] = dict(report=report, ms=ms,
                                       params_bitwise_unchanged=bitwise)
            scope = pt.Scope.from_numpy(snap, device, built["startup"])
            scope.set_var("@step@", 0)
        trips = REGISTRY.get("nonfinite_trips_total").value() - trips0
        check(trips == 3, f"nonfinite-ptb-lm: nonfinite_trips_total moved "
                          f"by {trips}, expected 3")
        dumps = [f for f in os.listdir(tmp) if "anomaly-non-finite" in f]
        check(len(dumps) == 1, f"nonfinite-ptb-lm: postmortems {dumps}")
        doc = json.load(open(os.path.join(tmp, dumps[0])))
        first = rec["trips"]["nan-init"]["report"]
        check(doc["anomaly"]["tensor"] == first["tensor"]
              and doc["anomaly"]["op_type"] == first["op_type"],
              f"nonfinite-ptb-lm: postmortem {doc.get('anomaly')}")
        # the next clean step: checked against unchecked, same state
        ref = pt.Scope.from_numpy(snap, device, built["startup"])
        scope = pt.Scope.from_numpy(snap, device, built["startup"])
        (a,) = exe.run(built["main"], feed=feed, fetch_list=[built["loss"]],
                       scope=scope)
        pt.set_flags({"check_nan_inf": False})
        e2 = pt.Executor(pt.CPUPlace() if device == "cpu" else None)
        (b,) = e2.run(built["main"], feed=feed, fetch_list=[built["loss"]],
                      scope=ref)
        gaps = {n: max_err(scope.find_var(n), ref.find_var(n))
                for n in names}
        same = bool(a == b) and max(gaps.values()) <= CLEAN_PARAM_GAP
        check(same, f"nonfinite-ptb-lm: the clean checked step {a} vs "
                    f"unchecked {b}, parameter gaps {gaps}")
        sent = {}
        for label, bad in (("nan", float("nan")), ("+inf", float("inf")),
                           ("-inf", float("-inf"))):
            v = torch.full((1 << 20,), 3e38, device=device)
            sent["finite_3e38"] = bool(numerics.sentinel([v, v]))
            v[12345] = bad
            sent[label] = bool(numerics.sentinel([v]))
        check(sent == {"finite_3e38": True, "nan": False, "+inf": False,
                       "-inf": False}, f"nonfinite-ptb-lm: sentinel {sent}")
        int_seg = int_segment_step(pt, device)
        check(int_seg, "nonfinite-ptb-lm: a checked step whose first "
                       "segment writes only an int tensor")
        rec.update(nonfinite_trips=trips, postmortem=dumps[0],
                   int_only_segment_checked_step_ok=int_seg,
                   clean_step_loss_bitwise=bool(a == b),
                   clean_step_param_gaps=gaps, sentinel=sent, card=card)
    finally:
        pt.set_flags({"check_nan_inf": False})
        flight_recorder.disable()
        undo()
    log("nonfinite_ptb_lm " + json.dumps(rec, default=str))
    return rec


def int_segment_step(pt, device):
    """A checked step whose first device segment writes only an int tensor,
    then a host op (``py_func``) and a float segment, so every segment's
    flag must stack on one device: True when it gives the unchecked step's
    result."""
    import numpy as np
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = pt.data("x", [4], "float32")
        ids = pt.layers.cast(x, "int32")
        out = main.global_block().create_var(name="hostout", shape=[-1, 4],
                                             dtype="float32")
        pt.layers.py_func(lambda v: v.astype(np.float32) * 2.0, ids, out)
        res = pt.layers.scale(out, 0.5)
    exe = pt.Executor(pt.CPUPlace() if device == "cpu" else None)
    feed = {"x": np.arange(8, dtype=np.float32).reshape(2, 4) + 0.25}
    pt.set_flags({"check_nan_inf": True})
    try:
        (a,) = exe.run(main, feed=feed, fetch_list=[res], scope=pt.Scope())
    finally:
        pt.set_flags({"check_nan_inf": False})
    (b,) = exe.run(main, feed=feed, fetch_list=[res], scope=pt.Scope())
    return bool(np.array_equal(a, b) and np.array_equal(a, np.floor(
        feed["x"])))


def phase_monitor_checks(K, pt, ptb_lm, card, devices=("cuda", "cpu")):
    """Phase 53: ``lm_tiny`` with the watch ops, the same program card
    against the port on the CPU from the same weights (``MON_TOL``): the
    tensor-watch stats of 3 steps, the cost FLOPs (equal), the localizer's
    report of a NaN ``init``, and the goodput ledger of the card's run
    written as an incarnation record and read back; on the card, a runner's
    first step leaves a peak set before it in place."""
    import tempfile

    from paddle_tpu_torch.monitor import (
        cost, exporter, goodput, numerics, tensorwatch)
    from paddle_tpu_torch.monitor.registry import REGISTRY
    cfg = ptb_lm.lm_tiny()
    windows = lm_windows(ptb_lm, cfg, 3, 53)
    tensorwatch.enable()
    try:
        snap, built = lm_state(pt, ptb_lm, cfg)
        out = {}
        for key, dev in zip(("card", "cpu"), devices):
            scope = pt.Scope.from_numpy(snap, dev, built["startup"])
            feeds = lm_feeds(cfg, built, windows, dev)
            exe = pt.Executor(pt.CPUPlace() if dev == "cpu" else None)
            stats = []
            if dev == "cuda":
                # a high set before the runner's first step: the Executor
                # reads its peak without resetting the caller's
                torch.empty(1 << 28, dtype=torch.uint8, device=dev)
                high = torch.cuda.max_memory_allocated()
            K.reset_launch_counts()
            goodput.enable()
            t0 = time.time()
            for f in feeds:
                exe.run(built["main"], feed=f, fetch_list=[built["loss"]],
                        scope=scope)
                stats.append([REGISTRY.get(k).value() for k in (
                    "grad_global_norm", "param_global_norm",
                    "update_ratio")])
            if dev == "cuda":
                check(torch.cuda.max_memory_allocated() >= high,
                      "monitor-correctness: the Executor reset the "
                      "process's peak memory")
            goodput.flush_idle()
            goodput.disable()
            counts = K.launch_counts()
            flops = cost.flops_per_step()
            pt.set_flags({"check_nan_inf": True})
            try:
                bad = dict(feeds[0])
                bad["init"] = bad["init"].clone()
                bad["init"][1, 3] = float("nan")
                exe.run(built["main"], feed=bad,
                        fetch_list=[built["loss"]], scope=scope)
                report = None
            except numerics.NonFiniteError as e:
                report = {k: e.report.get(k) for k in (
                    "tensor", "op_type", "op_index", "segment", "shape",
                    "nan_count", "inf_count", "size", "localized")}
            finally:
                pt.set_flags({"check_nan_inf": False})
            out[key] = dict(stats=stats, flops=flops, report=report,
                            counts={k: v for k, v in counts.items() if v},
                            start=t0)
    finally:
        tensorwatch.disable()
    card_r, cpu_r = out["card"], out["cpu"]
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for sa, sb in zip(card_r["stats"], cpu_r["stats"])
            for a, b in zip(sa, sb)]
    rec = dict(watch_rel_gap=max(gaps), flops_card=card_r["flops"],
               flops_cpu=cpu_r["flops"], flops_analytic=lm_flops(cfg),
               report_card=card_r["report"], report_cpu=cpu_r["report"],
               launches=card_r["counts"], tol=MON_TOL)
    check(rec["watch_rel_gap"] <= MON_TOL["watch_rel"],
          f"monitor-correctness: watch stats {card_r['stats']} vs "
          f"{cpu_r['stats']}")
    check(card_r["flops"] == cpu_r["flops"] == lm_flops(cfg),
          f"monitor-correctness: FLOPs {rec}")
    check(card_r["report"] is not None and card_r["report"]["localized"]
          and card_r["report"] == cpu_r["report"],
          f"monitor-correctness: reports {card_r['report']} vs "
          f"{cpu_r['report']}")
    if devices[0] == "cuda":
        check(card_r["counts"] == {k: 3 * v for k, v in LM_WANT.items()},
              f"monitor-correctness: launches {card_r['counts']}")
    # the ledger as the launcher writes it, read back
    d = tempfile.mkdtemp(prefix="goodput53.")
    _, samples = exporter.parse_text(exporter.render_text())
    phases = goodput.phase_seconds_of(samples)
    goodput.record_incarnation(d, {
        "incarnation": 0, "world": 1, "status": "ok", "rc": 0,
        "rc_label": None, "start": card_r["start"], "end": time.time(),
        "last_step": 3, "restored_step": None,
        "ranks": {"0": {"wall_seconds": goodput._g_wall.value(),
                        "phases": phases}}})
    (back,) = goodput.read_incarnations(d)
    check(back["ranks"]["0"]["phases"] == phases
          and phases.get("compile", 0) > 0
          and phases.get("device_compute", 0) > 0,
          f"monitor-correctness: ledger {back}")
    rec.update(goodput_phases=phases,
               goodput_fraction=goodput.fraction_of(samples), card=card)
    log("monitor_correctness " + json.dumps(rec, default=str))
    return rec


#: the phases after 0-2 (the builds and every kernel against its plain
#: version, which always run, as do the kernels line and the last line)
ALL_PHASES = frozenset(range(3, 54))
#: a selected phase also runs the phases whose results it takes
PHASE_NEEDS = {9: {8}, 16: {15}, 22: {20}, 29: {28}, 30: {28, 29},
               32: {31}, 34: {33}, 37: {36}, 40: {39}, 43: {42}, 46: {45},
               47: {45}}


def selected_phases(argv):
    """The phases ``--phases A-B,C,...`` selects (a dev run), with those
    they need; every phase with no argument (the contract's run)."""
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on the card.")
    ap.add_argument("--phases", default=None,
                    help="phases to run after 0-2, e.g. 51-53 or 28,51-53 "
                         "(default: all)")
    spec = ap.parse_args(argv).phases
    if spec is None:
        return ALL_PHASES
    want = set()
    for part in spec.split(","):
        lo, _, hi = part.strip().partition("-")
        want.update(range(int(lo), int(hi or lo) + 1))
    todo = list(want)
    while todo:
        for d in PHASE_NEEDS.get(todo.pop(), ()):
            if d not in want:
                want.add(d)
                todo.append(d)
    unknown = sorted(want - ALL_PHASES - {0, 1, 2})
    if unknown:
        ap.error(f"no phase {unknown}: phases are 0-53")
    return frozenset(want & ALL_PHASES)


def main(argv=None):
    selected = selected_phases(sys.argv[1:] if argv is None else argv)
    run = selected.__contains__
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
        bert, crnn_ctc, cycle_gan, deepfm, dygraph_resnet, dygraph_transformer,
        mobilenet_v1, ptb_lm, resnet, se_resnext, ssd, transformer, vgg,
        yolov3,
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
    # the eager trainers of phases 48 and 49 at their published configs:
    # Adam over the dygraph Transformer-base's list with the Noam rate read
    # from the card (phase 48's update), momentum over the dygraph
    # ResNet-50's 161 tensors below
    dy_transformer, dy_resnet = dygraph_init(pt, dygraph_transformer,
                                             dygraph_resnet)
    adam_dy = check_adam(K, [tuple(v.shape) for v in
                             dy_transformer[1].values()], 1, gen,
                         lr_on_card=True,
                         label="the dygraph Transformer-base")
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
        # MobileNetV1's classifier fc (phase 42): [256,1024]x[1024,1000]
        # fp32 with its bias, no act
        mbc = mobilenet_v1.mobilenet_v1()
        check_fused_matmul(K, mbc.batch, int(1024 * mbc.scale),
                           mbc.num_classes, None, torch.float32, gen)
        # the served classifier fc (phase 45) at its top bucket:
        # [32,1024]x[1024,1000] fp32 with its bias (v1), and with the int8
        # weight below (v2, v3)
        served_fc = check_fused_matmul(K, SWAP_MAX_BATCH, 1024, 1000, None,
                                       torch.float32, gen)
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
        served_fc8 = check_fused_matmul_int8(K, SWAP_MAX_BATCH, 1024, 1000,
                                             None, gen)
        log("served fc (phase 45) " + json.dumps(dict(
            fp32=served_fc, int8=served_fc8)))
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
        # YOLOv3's 222 tensors with the schedule's rate read from the card,
        # in one launch (phase 33 launches it once per tensor a step)
        yolo_main = yolov3.build_train(pt, yolov3.yolov3_coco())["main"]
        opt_main["momentum_yolo"] = check_sgd(
            K, [tuple(yolo_main.global_block().var(n).shape)
                for n in trainable(yolo_main)], "momentum", gen,
            "YOLOv3's 222 tensors, lr on the card, one launch",
            lr_on_card=True)
        del yolo_main
        # MobileNetV1's 83 tensors (phase 42 launches it once per tensor a
        # step), one launch
        mb_main = mobilenet_v1.build_qat(pt, mbc)["main"]
        mb_shapes = [tuple(mb_main.global_block().var(n).shape)
                     for n in mobilenet_v1.param_names(mb_main)]
        check(len(mb_shapes) == 83, f"{len(mb_shapes)} MobileNetV1 tensors")
        check_sgd(K, mb_shapes, "momentum", gen,
                  "MobileNetV1's 83 tensors, one launch")
        del mb_main
        # the dygraph ResNet-50's 161 tensors, the piecewise rate read from
        # the card, one launch (phase 49's update); the dygraph
        # Transformer's word table [10000,512] at its 4096 ids a side and
        # its position tables [256,512] at the 64 positions of its 64
        # sentences, fp32 and (under amp) bf16 (phase 48's lookups)
        mom_dy = check_sgd(
            K, [tuple(v.shape) for v in dy_resnet[1].values()], "momentum",
            gen, "the dygraph ResNet-50's 161 tensors, lr on the card, one "
            "launch", lr_on_card=True)
        positions = torch.as_tensor(dygraph_transformer.synthetic_batch(
            dygraph_transformer.transformer_base(), 0)["src_pos"],
            device="cuda").reshape(-1)
        emb_dy = {}
        for dt in (torch.float32, torch.bfloat16):
            emb_dy[f"word {dt}"] = check_embedding(K, 10000, 512, dt,
                                                   64 * 64, gen)
            emb_dy[f"position {dt}"] = check_embedding(
                K, 256, 512, dt, 64 * 64, gen, ids=positions)
        log("dygraph kernels (phases 48-49) " + json.dumps(dict(
            adam=adam_dy, momentum=mom_dy, gather=emb_dy)))
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

    by_phase = {}   # launches on the main paths: each phase's counted
    # runs, counts set to 0 just before and read just after
    if run(3) or run(4):
        with torch.inference_mode():
            log("phase 3: serving BERT-base masked-LM at S=512")
            # in the model, LayerNorm reads the residual sum just written:
            # its share of a request uses the L2-warm time
            serving = phase_serving(K, bert, card, ln_main["l2_warm_ms"])
            by_phase["serve-512"] = {
                "fused_layer_norm": serving["ln_launches"]}
            log("phase 4: long context S=2048")
            longc = phase_long_context(K, bert, card, fa_main["ms"],
                                       ln_main["l2_warm_ms"])
            by_phase["longctx-2048"] = {
                "flash_attention": longc["flash_launches"]}
    if run(5):
        log("phase 5: pretraining BERT-base, 64x512 (pretrain-512)")
        # LayerNorm per step from its phase-2 times read from HBM: 25 at
        # the layers' rows, 1 at the gathered head's
        pre512 = phase_pretrain_512(K, bert, optimizer, card,
                                    adam_main["ms"],
                                    25 * ln_512["ms"] + ln_head["ms"])
        by_phase["pretrain-512"] = pre512["launches"]
    if run(6):
        log("phase 6: pretraining BERT-base, 8x2048 flash (pretrain-2048)")
        fa_ms = {"flash_attention": fa_train["ms"],
                 **{n: r["ms"] for n, r in bwd_main.items()}}
        pre2048 = phase_pretrain_2048(K, bert, optimizer, card, fa_ms,
                                      adam_main["ms"], ln_2048["ms"])
        by_phase["pretrain-2048"] = pre2048["flash"]["launches"]
    if run(7):
        log("phase 7: training correctness on the card")
        phase_train_checks(bert, optimizer, card)
    if run(8):
        log("phase 8: the Fluid static path, word2vec (static-w2v)")
        static, trained = phase_static_w2v(K, pt, card)
        by_phase["static-w2v"] = static["launches"]
        log(f"phases 0-8 done at {time.perf_counter() - t_start:.1f} s")
    if run(9):
        log("phase 9: Fluid inference and int8 serving (serve-int8)")
        served = phase_serve_int8(K, pt, card, trained)
        by_phase["serve-int8"] = served["launches"]
        log(f"phases 0-9 done at {time.perf_counter() - t_start:.1f} s")
    if run(10):
        log("phase 10: sparse rows and the fused loss at BERT-base width "
            "(sparse-xent)")
        sparse = phase_sparse_xent(K, bert, ops, card)
        by_phase["sparse-xent"] = sparse["launches"]
        log(f"phases 0-10 done at {time.perf_counter() - t_start:.1f} s")
    if run(11):
        log("phase 11: training ResNet-50, 256x224^2 bf16 (train-resnet50)")
        rn50 = phase_train_resnet50(K, resnet, optimizer, card)
        by_phase["train-resnet50"] = rn50["launches"]
    if run(12):
        log("phase 12: image training correctness on the card "
            "(train-correctness)")
        img_checks = phase_image_train_checks(K, resnet, optimizer, pt,
                                              card)
        by_phase["train-correctness"] = img_checks["launches"]
    if run(13):
        log("phase 13: ResNet-50 and VGG-16 inference latency "
            "(infer-image)")
        phase_infer_image(K, resnet, vgg, card)
    if run(14):
        log("phase 14: training SE-ResNeXt-50, 32x224^2 bf16 "
            "(train-se-resnext50)")
        sx50 = phase_train_se_resnext50(K, se_resnext, optimizer, card)
        by_phase["train-se-resnext50"] = sx50["launches"]
        log(f"phases 0-14 done at {time.perf_counter() - t_start:.1f} s")
    if run(15):
        log("phase 15: training Transformer-big, 32x256 bf16 "
            "(train-transformer-big)")
        nmt, trained = phase_train_transformer_big(
            K, transformer, optimizer, card, adam_nmt["ms"])
        by_phase["train-transformer-big"] = nmt["launches"]
    if run(16):
        log("phase 16: Transformer-big beam-4 and greedy decode, 32 "
            "sources, 64 tokens (decode-transformer-big)")
        phase_decode_transformer_big(K, transformer, card, trained)
        del trained
    if run(17):
        log("phase 17: Transformer correctness on the card "
            "(transformer-correctness)")
        phase_transformer_checks(K, transformer, optimizer, card)
    if run(18):
        log("phase 18: the DeepFM CTR trainer over the host tables, batch "
            "4096 (ctr-deepfm)")
        phase_ctr_deepfm(K, deepfm, card)
        log(f"phases 0-18 done at {time.perf_counter() - t_start:.1f} s")
    if run(19):
        log("phase 19: the recognize_digits conv_net through the static "
            "path, batch 64 (train-book-digits)")
        digits, _ = phase_train_book(
            K, pt, card, "train-book-digits",
            build_conv_net(pt, pt.optimizer.Adam(BOOK_LR)),
            book_batches((1, 28, 28), DIGITS_BATCH, 10, 1), DIGITS_BATCH, 1)
        by_phase["train-book-digits"] = digits["launches"]
    if run(20):
        log("phase 20: vgg16_bn_drop through the static path, 3x32x32, "
            "batch 128 (train-book-vgg)")
        vgg_rec, (vgg_built, _, _) = phase_train_book(
            K, pt, card, "train-book-vgg",
            build_vgg16_bn_drop(pt, pt.optimizer.Adam(BOOK_LR)),
            book_batches((3, 32, 32), VGG_BATCH, 10, 2), VGG_BATCH, 3)
        by_phase["train-book-vgg"] = vgg_rec["launches"]
        vgg_main = vgg_built[0]
        vgg_shapes = [tuple(vgg_main.global_block().var(n).shape)
                      for n in trainable(vgg_main)]
        del vgg_built
        log(f"phases 0-20 done at {time.perf_counter() - t_start:.1f} s")
    if run(21):
        log("phase 21: the book models on the card against the CPU, "
            "dropout, the inference round trip (book-correctness)")
        book = phase_book_checks(K, pt, ops, card)
        by_phase["book-correctness"] = book["launches"]
    if run(22):
        log("phase 22: the twelve optimizer rules without a kernel, card "
            "against CPU, device time per update (optimizer-rules)")
        phase_optimizer_rules(K, pt, resnet, card, vgg_shapes)
        log(f"phases 0-22 done at {time.perf_counter() - t_start:.1f} s")
    if run(23):
        log("phase 23: understand_sentiment's convolution_net, batch 128 "
            "(train-book-sentiment)")
        sent = phase_train_module_book(
            K, pt, card, "train-book-sentiment", sentiment_model, SENT,
            sentiment_batches, pt.optimizer.Adagrad(SENT["lr"]),
            {"embedding_gather": 1}, "reviews", 23)
        by_phase["train-book-sentiment"] = sent["launches"]
    if run(24):
        log("phase 24: label_semantic_roles' db_lstm through the static "
            "path, batch 10 (train-book-srl)")
        srl, _ = phase_train_book_srl(K, pt, ops, card)
        by_phase["train-book-srl"] = srl["launches"]
    if run(25):
        log("phase 25: the GRU encoder-decoder at 512, batch 64 "
            "(train-book-nmt)")
        book_nmt = phase_train_book_nmt(K, pt, ops, card)
        by_phase["train-book-nmt"] = book_nmt["launches"]
    if run(26):
        log("phase 26: the full MovieLens recommender, batch 256 "
            "(train-book-movielens)")
        movielens = phase_train_module_book(
            K, pt, card, "train-book-movielens", movielens_model, MLF,
            movielens_batches, pt.optimizer.SGD(MLF["lr"]),
            {"embedding_gather": 7, "fused_sgd": 1}, "examples", 26)
        by_phase["train-book-movielens"] = movielens["launches"]
        log(f"phases 0-26 done at {time.perf_counter() - t_start:.1f} s")
    if run(27):
        log("phase 27: the sequence models, ops and recurrences on the card "
            "against the CPU (sequence-correctness)")
        seq_checks = phase_sequence_checks(
            K, pt, ops, card, db_lstm_program(pt, SRL, srl_sgd))
        by_phase["sequence-correctness"] = seq_checks["launches"]
        log(f"phases 0-27 done at {time.perf_counter() - t_start:.1f} s")
    if run(28):
        log("phase 28: the PTB LSTM language model at lm_model.py's medium "
            "config through the reader, StaticRNN and prepare "
            "(train-ptb-lm)")
        lm_train, lm_trained = phase_train_ptb_lm(K, pt, ptb_lm, card)
        by_phase["train-ptb-lm"] = lm_train["launches"]
    if run(29):
        log("phase 29: greedy generation through the while loop, 20 "
            "streams x 35 tokens (generate-ptb-lm)")
        _, lm_out = phase_generate_ptb_lm(K, pt, ptb_lm, card, lm_trained)
    if run(30):
        log("phase 30: the LM, the control flow, tensor arrays and module "
            "1's ops on the card against the CPU (control-flow-correctness)")
        cf_checks = phase_control_flow_checks(K, pt, ops, ptb_lm,
                                              lm_trained, lm_out)
        by_phase["control-flow-correctness"] = cf_checks["launches"]
        log(f"phases 0-30 done at {time.perf_counter() - t_start:.1f} s")
    lm_trained = None
    if run(31):
        log("phase 31: MobileNet-SSD at 300^2, batch 64, through prepare "
            "and Executor.run (train-ssd-mobilenet)")
        ssd_cfg = ssd.mobilenet_ssd_voc()
        ssd_train, ssd_trained = phase_train_detection(
            K, pt, "train-ssd-mobilenet", ssd, ssd_cfg, SSD_STEPS,
            ("image", "gt_box", "gt_label"), lambda n: {}, card,
            ssd_probes(ops))
        by_phase["train-ssd-mobilenet"] = ssd_train["launches"]
    if run(32):
        log("phase 32: MobileNet-SSD inference, batch 32, detection_output "
            "(infer-ssd-mobilenet)")
        phase_infer_ssd(pt, ops, ssd, card, ssd_trained)
        del ssd_trained
    if run(33):
        log("phase 33: YOLOv3 (DarkNet-53) at 608^2, batch 8 "
            "(train-yolov3)")
        yolo_cfg = yolov3.yolov3_coco()
        yolo_train, yolo_trained = phase_train_detection(
            K, pt, "train-yolov3", yolov3, yolo_cfg, YOLO_STEPS,
            ("image", "gt_box", "gt_label", "gt_score"),
            lambda n: {"fused_momentum": n}, card,
            yolo_probes(ops, yolov3, yolo_cfg))
        check(yolo_train["params"] == 222, f"train-yolov3: "
              f"{yolo_train['params']} trainable tensors, expected 222")
        by_phase["train-yolov3"] = yolo_train["launches"]
    if run(34):
        log("phase 34: YOLOv3 inference, batch 8, yolo_box and "
            "multiclass_nms (infer-yolov3)")
        phase_infer_yolo(pt, ops, yolov3, card, yolo_trained)
        del yolo_trained
    if run(35):
        log("phase 35: the detection models and ops on the card against "
            "the CPU (detection-correctness)")
        det_checks = phase_detection_checks(K, pt, ops, ssd, yolov3, card)
        by_phase["detection-correctness"] = det_checks["launches"]
        log(f"phases 0-35 done at {time.perf_counter() - t_start:.1f} s")
    if run(36):
        log("phase 36: CycleGAN at 256^2, batch 1: G, D_A and D_B through "
            "Executor.run with the image pool (train-cycle-gan)")
        cg_train, cg_trained = phase_train_cycle_gan(K, pt, cycle_gan, card)
        by_phase["train-cycle-gan"] = cg_train["launches"]
    if run(37):
        log("phase 37: both CycleGAN generators at batch 1 and 8 "
            "(infer-cycle-gan)")
        phase_infer_cycle_gan(pt, cycle_gan, card, cg_trained)
        del cg_trained
    if run(38):
        log("phase 38: the rest of ops/nn.py, the metric ops, the kink "
            "gradients and cyclegan_tiny on the card against the CPU "
            "(nn-correctness)")
        nn_checks = phase_nn_checks(K, pt, ops, cycle_gan, card)
        by_phase["nn-correctness"] = nn_checks["launches"]
        log(f"phases 0-38 done at {time.perf_counter() - t_start:.1f} s")
    if run(39):
        log("phase 39: CRNN-CTC at 48x512, batch 32, through prepare and "
            "Executor.run (train-crnn-ctc)")
        crnn_train, crnn_trained = phase_train_crnn(K, pt, crnn_ctc, card)
        by_phase["train-crnn-ctc"] = crnn_train["launches"]
    if run(40):
        log("phase 40: CRNN-CTC's evaluation program at batch 32 and 1 "
            "(infer-crnn-ctc)")
        crnn_infer = phase_infer_crnn(K, pt, crnn_ctc, card, crnn_trained)
        by_phase["infer-crnn-ctc"] = crnn_infer["launches"]
        del crnn_trained
    if run(41):
        log("phase 41: the random ops, ops/misc.py, the CTC ops and "
            "crnn_ctc_tiny on the card against the CPU (misc-correctness)")
        misc_checks = phase_misc_checks(K, pt, ops, crnn_ctc, card)
        by_phase["misc-correctness"] = misc_checks["launches"]
        log(f"phases 0-41 done at {time.perf_counter() - t_start:.1f} s")
    if run(42):
        log("phase 42: MobileNetV1 under quantization-aware training at "
            "224^2, batch 256, through prepare and Executor.run "
            "(train-qat-mobilenet)")
        qat_train, qat_trained = phase_train_qat(K, pt, mobilenet_v1, card)
        by_phase["train-qat-mobilenet"] = qat_train["launches"]
    if run(43):
        log("phase 43: calibration, the int8 freeze and the frozen program "
            "at batch 256 and 1, through save/load_inference_model and a "
            "Predictor (infer-int8-mobilenet)")
        phase_infer_int8(K, pt, mobilenet_v1, card, qat_trained)
        del qat_trained
    if run(44):
        log("phase 44: the quantization ops, ops/aliases.py, layers' own "
            "functions, mobilenet_v1_tiny and the three new passes on the "
            "card against the CPU (quant-correctness)")
        quant_checks = phase_quant_checks(K, pt, ops, mobilenet_v1, card)
        by_phase["quant-correctness"] = quant_checks["launches"]
        log(f"phases 0-44 done at {time.perf_counter() - t_start:.1f} s")
    if run(45):
        log("phases 45-47: MobileNetV1 at 224^2 served over HTTP, "
            "hot-swapped from fp32 to int8 by hand and by watch_dir, three "
            "refusals under load, every response held against its version "
            "(serve-http-swap-mobilenet, swap-refusals, "
            "serving-correctness)")
        t45 = time.perf_counter()
        http_swap = phase_serve_http_swap(K, pt, mobilenet_v1, card)
        by_phase["train-mobilenet-versions"] = \
            http_swap["versions"]["launches"]
        by_phase["serve-http-swap-mobilenet"] = http_swap["launches"]
        log(f"phases 45-47 took {time.perf_counter() - t45:.1f} s; phases "
            f"0-47 done at {time.perf_counter() - t_start:.1f} s")
    t48 = time.perf_counter()
    if run(48):
        log("phase 48: the dygraph Transformer-base, 64x64 tokens a side, "
            "10 eager Adam steps in fp32 and 10 under amp bf16, then "
            "evaluation under no_grad (train-dygraph-transformer)")
        dy_t = phase_train_dygraph_transformer(
            K, pt, dygraph_transformer, card, dy_transformer)
        by_phase["train-dygraph-transformer"] = dy_t["launches"]
    del dy_transformer
    if run(49):
        log("phase 49: the dygraph ResNet-50 at 224^2, batch 32, 10 eager "
            "Momentum steps, then an evaluation batch scored by "
            "metrics.Accuracy (train-dygraph-resnet50)")
        dy_r = phase_train_dygraph_resnet(K, pt, dygraph_resnet, card,
                                          dy_resnet)
        by_phase["train-dygraph-resnet50"] = dy_r["launches"]
    del dy_resnet
    if run(50):
        log("phase 50: the tiny trainers and every nn class on the card "
            "against the CPU, amp's skipped steps with no host read, the "
            "distributions' draws, save/load_dygraph (dygraph-correctness)")
        dy_checks = phase_dygraph_checks(K, pt, dygraph_transformer,
                                         dygraph_resnet, card)
        by_phase["dygraph-correctness"] = dy_checks["launches"]
        log(f"phases 48-50 took {time.perf_counter() - t48:.1f} s; phases "
            f"0-50 done at {time.perf_counter() - t_start:.1f} s")
    t51 = time.perf_counter()
    if run(51):
        log("phase 51: the PTB LM at medium under each monitor: off, trace "
            "+ profiler, goodput + anomaly + flight recorder, tensor watch, "
            "check_nan_inf, all, off again (observe-ptb-lm)")
        obs = phase_observe_ptb_lm(K, pt, ptb_lm, card)
        by_phase["observe-ptb-lm"] = obs["launches"]
    if run(52):
        log("phase 52: three non-finite trips at medium under "
            "check_nan_inf, localized, the parameters bitwise unchanged "
            "(nonfinite-ptb-lm)")
        phase_nonfinite_ptb_lm(K, pt, ptb_lm, card)
    if run(53):
        log("phase 53: the monitors on lm_tiny, card against the CPU "
            "(monitor-correctness)")
        mon = phase_monitor_checks(K, pt, ptb_lm, card)
        by_phase["monitor-correctness"] = mon["launches"]
    log(f"phases 51-53 took {time.perf_counter() - t51:.1f} s; the selected "
        f"phases done at {time.perf_counter() - t_start:.1f} s")
    log_card("at the end")

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
        check(launches > 0 or selected != ALL_PHASES,
              f"{name} never launched on its main path")
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
    log(f"probes not measured: {len(UNMEASURED)} {UNMEASURED}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()},
        "probes_not_measured": UNMEASURED}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
