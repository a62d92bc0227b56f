#!/usr/bin/env python3
"""Drive the PyTorch port (deeplearning4j_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab PARENT_TREE    # the A/B call, below

Phases, in order; any failure ends the run with a nonzero exit code and
no result line:

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from the sources in this checkout (one
   ``nvcc`` per source, all started together); every kernel of the flash
   libraries (forward, merged and two-kernel backward), of
   ``conv3x3_bn_act``, of the ``matmul_bn_act`` backward and forward and of
   ``int8_matmul``, f32 and bf16, must hold wgmma and TMA loads (``HGMMA``
   and ``UTMALDG`` in ``cuobjdump -sass``; the counts are printed; the
   forward's f32 weight transpose, a copy, no wgmma), and none of their
   templates may spill (ptxas);
3. for each distinct (M, K, N, prologue) of the 36 ``matmul_bn_act`` calls
   of ResNet-50 at batch 32 x 224 x 224, in f32 and bf16: hold the forward
   kernel to ``matmul_bn_act_plain`` on the card, show that planted faults
   (in f32 one TF32 pass in place of the kernel's three; rows past M
   counted in s1 and s2 where M is no multiple of 128 with a prologue)
   move that check at least 10x past its limit, call each shape twice for
   the same bits (K split over blocks at M = 1568), and time the kernel,
   the plain version and one library yardstick (``torch.matmul`` with the
   prologue and the statistics as torch ops) beside the bound (f32: three
   TF32 passes', the CUDA cores' beside it);
4. serve full-width ResNet-50 (224x224x3, 1000 classes, 16 fused
   bottlenecks, seeded weights) through ``InferenceEngine(max_batch=32)``:
   16 requests of 1-8 images from 4 threads.  Every answer must match a
   direct forward of the same images, the whole forward through the
   kernel must match the same net with the plain version (in log
   probabilities), and the kernel must have launched 36 times per
   dispatched batch.  The 16 requests are a smoke reading of the engine,
   not a throughput metric: the forward alone at batch 32 is timed for
   that;
5. the same shapes for the merged backward, in f32 and bf16 with random
   O(1) dy, ds1, ds2: hold the backward kernel's dx, dW, da, db to
   ``matmul_bn_act_bwd_plain``, show that dropping either cotangent term
   of dyt, or (f32) running one TF32 pass in place of the kernel's three,
   would move that check far past its limit, call each shape twice for the
   same bits (dW's M split over blocks), and time the kernel, the plain
   version and a library yardstick (two ``torch.matmul`` with the
   elementwise work as torch ops);
6. train full-width ResNet-50 in f32 at batch 32 for 3 steps of
   ``Trainer.fit_batch`` (``Nesterovs(TRAIN_LR, 0.9)``) through the
   kernels, then 3 steps from the same start with both plain versions in
   their place: every step launches each kernel 36 times, step 0's loss
   and every param's step-0 update (its gradient, scaled) agree with the
   plain run, and so do the later losses;
7. the headline training configuration: bf16 policy, batch 256,
   ``Nesterovs(0.1, 0.9)``, a few timed steps (a smaller power-of-two
   batch, said so, if 256 does not fit the card); then phases 3 and 5
   again, in bf16, at every distinct shape of the headline's batch;
8. phases 3 and 5 at K and N that are no multiples of 32 (``RAGGED_CALLS``,
   M = 32 x 56 x 56), f32 and bf16, with planted faults for the ragged
   tails (x's K tail zero-filled and still folded, act(b) in place of
   act(x a + b); the forward's columns, the backward's dx and dW tails
   left unwritten); then a graph of the reference's ragged bottlenecks
   FusedBottleneck (4, 4, 8) and (8, 8, 32), f32: 8 requests through the
   engine (6 launches per batch, answers equal to direct forwards), the
   forward against the plain version, and one Trainer step against one
   through both plain versions;
9. the fused 3x3 conv + BN statistics ``conv3x3_bn_act``, which no model
   calls: (a) the kernel against ``conv3x3_bn_act_plain`` at ResNet-50's
   four 3x3 shapes at batch 32 (56x56x64, 28x28x128, 14x14x256, 7x7x512,
   C = Cout), with the prologue and relu_in, without relu_in and without
   the prologue, then at ``CONV3_RAGGED`` (the reference test's case, C !=
   Cout, C = 3, planes over 1 MB), f32 and bf16, planted faults (border
   taps act(b), neighbours across row and image seams, a tap dropped; in
   f32 one TF32 pass in place of three) each at least 10x past the limit,
   and a second call giving the same bits (K split over blocks at 7x7x512
   batch 32: the split-K repeat); (b) its path: the 16 3x3
   stages of a train-mode forward of the seeded full-width ResNet-50,
   captured through ``fused.conv3x3_stage`` at batch 32 in f32 and at the
   headline's batch in bf16, each run through the op with the count set
   to 0 just before (16 launches) and held to the stage's own
   outputs and to the plain version; (c) autograd through the op against
   ``conv3x3_reference`` at the four shapes (no kernel launched by the
   backward); (d) times of the kernel, the plain version and the layer's
   own chain (normalize pass, cuDNN, sums; a yardstick only) per shape
   and per pass of 16 calls at batch 32 (f32, bf16) and the headline's
   batch (bf16), beside the bound;
10. flash attention at BERT-base's attention shape (B, H, T, D) = (2, 12,
   4096, 64), in f32 and bf16: no mask; a key mask with valid lengths 4096
   and 2500; causal at offsets (1024, 512); Tq = 1000 against Tk = 4096; a
   batch row whose mask is all zeros (dead rows); tails of both the query
   and the key tiles (Tq = 1000, Tk = 2999) under causal at offsets (300,
   0) with a key mask of valid lengths 2999 and 2000.  Both kernels and the
   two-kernel backward (``merged=False``) are held to their plain versions
   (o, m, l; the normalized output and lse; dq, dk, dv with O(1)
   cotangents), the two backward forms to each other, planted faults (the
   lse shift or delta dropped; in f32 one TF32 pass in place of three, for
   the forward and both backward forms) must move the check far past its
   limit, and
   each is timed against the plain version and
   ``scaled_dot_product_attention`` (forward and autograd backward, a
   yardstick only); at the base case both backward forms run twice and
   must give the same bits; the merged form's scratch beside dq is printed
   and held to ``MERGED_SCRATCH_LIMIT``; then one call of
   ``flash_attention_block_bwd(merged=False)`` with every flash count set
   to 0 before it: 2 split launches;
11. the same at head dims 32 (24 heads) and 128 (6 heads), BERT-base's
   width, the base case at 80 (12 heads, zero-padded to 128), and the
   base, key-mask, causal and dead-row cases at 256 (3 heads) and 192 (4
   heads, zero-padded to 256), which run in column slabs;
12. both backward forms at (2, 12, 16384, 64), f32 and bf16, and at
   (2, 12, 32768, 64), bf16: times, peak memory, split against merged on
   all heads and the split against the plain version on two (batch,
   head) slices;
13. serve 12-layer BERT-base MLM at seq 4096 (``BertConfig.base()``,
   ``max_position=4096``, ``use_flash=None``, seeded weights) through
   ``predict_mlm`` on 2 x 4096 seeded ids, under the f32 and the bf16
   policy: 12 forward flash launches per call, the kernel path against
   the plain path in log-softmax, and a seq-512 call that takes the einsum
   path (no launch); then the same with 2 layers at 6, 24 and 3 heads
   (head dims 128, 32 and 256), 2 launches per call;
14. fine-tune ``bench.py``'s long-sequence configuration (4 layers of
   BERT-base, seq 4096, batch 2, bf16 policy, ``use_flash=True``,
   ``Adam(2e-5)``, its seeded ids, labels and weights) through
   ``BertForMaskedLM.fit``: one warm-up step, then 3 timed steps, each with
   4 forward and 4 backward flash launches; peak memory;
15. the same fine-tune in f32 through the kernels and through both plain
   versions from one set of weights and the same dropout masks: step-0
   loss, every param's step-0 update and the later losses agree;
16. the int8 dequant-matmul alone at every (K, N) it serves, VGG-16's
   (25088, 4096), (4096, 4096), (4096, 1000) and ``bench_quantized``'s MLP
   (1024, 1024), (1024, 10), at M = 1, 2, 4, 7, 8, 16 and 32 (every bucket
   of the engine, and ragged rows), in f32 and bf16: held to
   ``int8_matmul_plain`` (f32 within 1e-5 of max |y|, bf16 within one bf16
   ulp per entry), planted faults (the scale dropped, the last K split
   skipped; in f32 one TF32 pass in place of the kernel's three, x cut to
   its TF32 hi)
   at least 10x past the limit, a second call giving the same bits, and
   timed with the L2 flushed against the plain version, a library
   yardstick and the bound;
17. the headline of int8 serving: full-width VGG-16 (224x224x3, 1000
   classes, seeded weights) under ``bench_quantized``'s serving policy
   (bf16 params, compute and outputs), ``quantize_net`` with two seeded
   calibration batches, 16 seeded requests of 1-32 images from 4 threads
   through ``InferenceEngine(qnet, max_batch=32)``: 3 launches per batch,
   every answer equal to ``qnet.output`` of the batch it was served in, the
   int8 outputs within the report's calibrated band of the fp net's, the
   forward through the kernel against the same qnet with
   ``int8_matmul_plain`` in log probabilities, and the forward alone at
   batch 32 timed for the fp and the int8 net;
18. the same qnet under the f32 policy: 3 launches per forward; the
   forward through the kernel against the same qnet with its dense
   products exact (f64) at 1e-5 in log probabilities, and against
   ``int8_matmul_plain`` at 1e-4 (cuBLAS's own f32 rounding, printed
   against the exact product beside the kernel's);
19. the zoo's ``MultiLayerNetwork`` entries, f32, which run no kernel of
   this repo: (a) ``mlp_mnist()`` and ``lenet(32, 32, 3)`` at batch 128 on
   ``bench.py``'s ``bench_workload_steps`` data, step 0 of
   ``Trainer.fit_batch`` on the card and on the CPU from the same weights
   (the loss; every param's gradient, and its update under an updater
   linear in it), then 20 steps timed, with the device time alone and the
   busy share; (b) the examples' flow, ``datasets.mnist`` into 2 epochs of
   ``mlp_mnist().fit`` (its accuracy above 0.9) and ``datasets.cifar10``
   into 1 epoch of ``lenet``, each evaluated on the card and, with the
   same weights, on the CPU (at most 0.1% of the predictions differ);
   (c) ``simple_cnn`` (48x48x3) and ``alexnet`` (224x224x3) with their
   dropout and LRN: 3 steps at batch 32 with every mask recorded (each
   keep share within 5 sigma of its retain probability, each step's masks
   new, a second step 0 from the same weights drawing the same masks) and the inference forward
   at batch 2 against the CPU's; (d) ``vgg19``'s forward timed at batch 32
   and at batch 2 against the CPU's (each forward in f32 and in f64 on
   both devices, held as ``ZOO_FWD_TOL``'s comment says);
20. BERT-base MLM's seq-128 headline at ``bench.py:181-230``'s
   configuration: ``BertConfig.base()`` with ``max_predictions=32``, the
   bf16 policy, batch 32 x 128, 12 layers, ``Adam(2e-5, mu_dtype="bf16")``,
   its ids, labels and 15% weights from ``default_rng(0)`` and an all-ones
   attention mask: 3 warm-up steps of ``make_train_step``, then 20 timed
   (step ms, sequences/s, tokens/s, device time alone, busy share; no
   flash launch: the einsum path), then 10 steps through ``fit`` (its
   ``DeviceFeeder`` and ``ListenerBus``); at 2 layers and batch 4 (f32
   policy, dropout 0, one set of weights) the card against the CPU:
   step 0's loss and every gradient, Adam's bf16 mu within one bf16 ulp,
   3 later losses; and the feeder's CUDA staging (a refilled host buffer,
   a busy consumer: no batch overwritten in flight);
21. the config-first encoder at BERT-base's width (an
   ``EmbeddingSequenceLayer``, 4 blocks of ``SelfAttentionLayer(n_heads=12,
   has_bias=True)``, residual adds, ``LayerNormalization``, Dense(3072,
   gelu) -> Dense(768); average pooling, a 2-class softmax) at 2 x 4096
   with a features mask, bf16 params and compute: one ``output`` with 4
   forward flash launches, a warm-up and 3 timed ``Trainer.fit_batch``
   steps with 4 forward and 4 backward launches each, a seq-512 call with
   none; the same net in f32 through the kernels and through the flash
   plain versions from one set of weights (served log probabilities,
   step-0 loss and every param's gradient, phases 13-15's limits); an
   ``AttentionVertex`` graph at 2 x 4096 (one launch per forward);
22. the captured steps (``train/capture.py``, ``train/step_cache.py``):
   phases 3-21 run their steps eagerly (``capture.eager()``), and here
   each training and serving path runs twice from the same start, eager
   and through the step cache as CUDA graphs, in one call: MLP-MNIST and
   LeNet ``fit`` at batch 128 (``bench.py:484-496``), ResNet-50's f32
   ``Trainer.fit_batch`` at batch 32 (its graph holds the 36 + 36
   ``matmul_bn_act`` launches), the seq-128 headline's ``make_train_step``
   (phase 20's configuration, not cut), the config-first encoder's
   ``fit_batch`` at 2 x 4096 with bf16 params (4 + 4 flash launches), the
   engine serving ResNet-50 f32 and VGG-16 int8 at batch 32, phase 24's
   frozen fine-tune's ``fit_batch`` (its own step: frozen layers and a
   per-layer updater keep a net out of the step cache), the UCI-HAR
   ``lstm_classifier``'s ``Trainer.fit_batch`` at 64 x 128 x 9 and the
   char-RNN's tBPTT ``fit`` at 32 x 250 (5 segments, so 5 graph launches a
   batch): 5 steps (or requests, or batches) that must give the same bits
   (losses or answers, params, state, updater state), the kernel launches
   of the capture call equal to an eager step's and none counted on a
   replay, one graph; then step ms (mean of 20; 3 char-RNN batches),
   device ms and busy share, device operations and the host's kernel and
   graph launches per step (torch.profiler), peak memory, per mode.  Then
   MLP-MNIST with dropout (retain 0.8): 5 captured steps against eager
   ones, masks included, two replays
   drawing different masks; two nets of one configuration interleaved on
   one graph, each against its eager twin; the cache's hits and misses
   over two ``fit`` and two ``eval_loss`` calls (one miss per kind);
   planted faults that must fail loudly: a graph captured without the
   generator registered (raises) and replays without the new batch copied
   in (the bits differ); two int8 MLPs of one configuration (N = 10: the
   int8 kernel's row-padded weight copy) behind two engines that share one
   captured forward, served in turns, each answer equal to the eager one;
   and the headline through ``BertForMaskedLM.fit`` (feeder and bus),
   eager against captured;
23. the recurrent nets, which run no kernel of this repo: (a)
   ``bench.py:499-502``'s UCI-HAR step, ``lstm_classifier(timesteps=128)``
   (GravesLSTM(128), LastTimeStep, softmax over 6; Adam(5e-3), gradients
   clipped element-wise at 0.5) by ``Trainer.fit_batch`` at 64 x 128 x 9:
   step 0 on the card against the CPU from the same weights (the loss and
   every clipped gradient held, Adam's updates printed), 20 eager steps
   timed with device time, busy share and kernels per step, beside phase
   22's captured reading; (b) ``datasets.uci_har`` (synthetic) into 2
   epochs of ``fit`` and ``evaluate`` on the card and, with the same
   weights, on the CPU (accuracy above ``HAR_ACCURACY``, no prediction
   differing); (c) ``text_gen_lstm()`` (2 x GravesLSTM(256), vocab 77,
   tBPTT 50/50) through 4 ``fit`` calls on seeded 32 x 1000 sequences of a
   Markov chain: the loss falls, 20 segments a batch, one graph, ms per
   batch (and one batch eager); then 200 characters sampled one at a
   time through ``rnn_time_step``, held to ``output`` of the whole sampled
   sequence;
24. fine-tune ResNet-50 as DL4J's transfer-learning examples do
   (``finetune_net``): the seeded 1000-class net of the other phases as
   the "pretrained" backbone, its params and state carried into a 5-class
   net whose stem and res2-res4 (13 ``FusedBottleneck`` s) are frozen,
   the head on ``AdamW(RampSchedule(ExponentialSchedule))`` of its own, the
   rest on ``Nesterovs(StepSchedule)`` whose rate halves every 8 steps;
   f32, batch 32, 12 training and 2 validation batches of seeded images.
   (a) ``EarlyStoppingTrainer`` (validation loss, at most 3 epochs,
   patience 1, ``LocalFileModelSaver``) with a ``CheckpointListener``
   (every 5 iterations, keep 2): the reason, best epoch, scores, ms per
   step, a validation pass, a checkpoint's write and restore; frozen
   params bit-unchanged, a frozen block's BN running statistics moved,
   res5 and the head changed; (b) under deterministic algorithms,
   captured: a 2-epoch ``Trainer.fit`` over a ``ResumableIterator``, the
   same run stopped after iteration 17 (mid-epoch 1) by a listener, and a
   fresh net resumed from the checkpoint directory, its losses and final
   trees bit-equal to the uninterrupted run's; the planted fault of a
   damaged newest zip, where the resume falls back to the one before it
   and still matches; (c) 10 steps captured against eager across the
   rate's halving at step 8 (the same bits), 36 + 36 ``matmul_bn_act``
   launches per eager step, and the planted fault of rates read from a
   host count (captured then differs from eager); (d) 3 steps through the
   kernels against 3 through the plain versions (phase 6's limits); (e)
   VGG-16's ``EditLastLayerOthersFrozen`` through ``TransferLearning``
   (``Nesterovs(5e-5)``, layers 0-19 frozen, a new 5-class output): 5
   steps on one batch,
   frozen params unchanged, the loss falling, ``save``/``load`` with the
   same output bits; (f) the dropout MLP's 2-epoch ``fit`` stopped after
   iteration 8 and resumed, captured: its random stream restored, every
   loss and tensor the same bits; (g) a two-input graph through ``fit`` on
   ``MultiDataSet`` s, captured against eager (the same bits);
25. the serving stack (``serve/``, ``online/``, ``obs/``,
   ``resilience/faults.py``), every part but the captured round of (c) and
   the online round of (e) eager: (a) the seeded VGG-16 (f32 params) and
   ResNet-50 written as model zips; ``ModelRegistry().deploy("vgg16",
   precision="int8")`` under bench_quantized's bf16 serving policy with 2
   seeded calibration batches of 32, the three
   ``tpudl_serve_quantized_*`` gauges equal to the net's report; (b)
   ``ModelServer`` on loopback: 8 client threads POST 64 requests of 1-4
   images (JSON bodies encoded before the clock starts), each answer
   equal to its version's output of the batch it was served in,
   ``/metrics`` counting every request ok, ``/healthz`` 200, 3
   ``int8_matmul`` launches a batch; requests/s and latency, and the same
   requests through the engine alone; (c) under the clients' load a hot
   swap to the fp VGG-16 and a rollback to int8: no request fails, each
   answer is its version's, ``/healthz`` reads 503 only inside the
   registry's swap windows; then captured: one bucket of each precision
   warmed, and a second round int8 -> fp that captures no new graph (the
   tree switches on the shared graph printed); (e) ``GatedDeployer``
   scores an int8 candidate against the fp incumbent (eval loss on 2
   seeded held-out batches), a truncated candidate is refused with the
   incumbent serving, a ``DeployWatch`` window over live requests; (f)
   planted faults: ``serve.dispatch@2:error`` fails its batch's request
   with ``error_status``'s code and no other, the errors counted equal
   the planted ones, a flight-recorder dump (``chiprun_out/``, read by
   ``read_dump``) holds the ``serve_error`` event and the ``serve`` spans
   with their device-sync time; a refused ``int8_matmul`` launch answers
   a 5xx and the plain version is never called; (d) ResNet-50 f32 behind
   ``ReplicaRouter(replicas=2)`` with two lanes and a tenant quota: 36
   ``matmul_bn_act`` launches a batch, each answer within phase 4's
   ``SERVE_TOL`` of the net's output of its request alone, the quota's
   ``QuotaExceeded``, a lane shed, a fan-out deploy, the registry's
   ``RoutedModelError``, the autoscaler from 1 to 2 replicas and back;
   images/s and latency through the router and the engine alone; (e)
   ``examples/online_learning.py``'s flow: a classifier served,
   ``:feedback`` into a ``FeedbackLog``, ``OnlineTrainer.run_once``
   deploying a gated version 2 while the server answers requests (its
   training step captured under that load), and the same round on an
   idle card, captured anew, with the same candidate bits;
26. print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

The A/B call (``--ab PARENT_TREE``, the directory of another checkout,
e.g. the parent commit unpacked with ``git archive``) runs none of the
phases: it times the flash forward (normalized) and both backward forms
at the base case of every head dim in ``AB_HEAD_DIMS``, f32 and bf16, the
16-call ``conv3x3_bn_act`` pass (f32 at batch 32, bf16 at batch 32 and
256) beside the layer's chain, with a checksum of y, s1 and s2 at each of
its shapes, the 36-call ``matmul_bn_act`` pass of ResNet-50 (the
backward beside its library yardstick, and the forward with its host
microseconds per call and a checksum of y, s1 and s2 per shape; f32 at
batch 32, bf16 at 32 and 256; events and device time alone), where the
forward wrapper's host time goes (``mba_host_us``), ResNet-50's f32
served forward and training step at batch 32, the int8 kernel at
VGG-16's fc6, fc7 and fc8 at M = 1, 8 and 32 (f32 and bf16, L2 cold,
beside ``torch.matmul`` on the widened weight), the BERT fine-tune step
and the BERT serving call, in the other tree and in this one, each in its
own process, in the order parent, change, change, parent, and prints the
times side by side (``chiprun_out/chip_ab.json``).

f32 means full f32 here: TF32 is switched off for cuBLAS and cuDNN
(``allow_tf32 = False``) for the whole run, so the plain versions and the
convolutions around the kernel compute in f32 as the JAX package's
HIGHEST precision does.  The printed lines and the per-shape tables go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 32
SEED = 20261016
# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# f32-accurate work on the tensor cores: three TF32 passes a product at
# 495 TFLOP/s of TF32 (the f32 flash kernels, conv3x3_bn_act, the
# matmul_bn_act backward, and int8_matmul, whose weight is exact in TF32 and
# x takes three parts)
PEAK_F32_TF32X3 = 495e12 / 3
PEAK_BYTES = 3.35e12
# kernel vs plain on the same inputs, max |diff| over a scale of the result:
# y against max|y|; s1 against max_n sum_m |y|; s2 against max|s2|.  f32: sum
# order only (K up to 2048 terms; 4608 for conv3x3_bn_act, read at most
# 3.2e-6 (y), 2.1e-7 (s1), 4.9e-7 (s2) on the H100); bf16: y rounds to bf16
# (2^-8 relative; conv3x3_bn_act read 5.5e-3, s1 and s2 8.3e-6).
TOL = {"float32": {"y": 1e-5, "s1": 1e-5, "s2": 1e-5},
       "bfloat16": {"y": 8e-3, "s1": 1e-4, "s2": 1e-4}}
SERVE_TOL = 1e-5      # engine answer vs direct forward of the same images
# forward through the kernel vs through the plain version, as max |diff| of
# log probabilities: logits up to a per-row shift, i.e. each probability's
# error over its own size.  The probabilities sit near 1/1000, so an absolute
# limit on them would let a wiring fault of the layer through; f32 sum order
# alone stays far below this limit over the 16 blocks.
PLAIN_FWD_TOL = 1e-5
# backward kernel vs plain, max |diff| over max |plain| per output, with dy,
# ds1, ds2 all O(1) (as a train-mode BN's cotangents are).  f32: sum order
# only (read at most 1.9e-6 on the H100); bf16: dx and dW round to bf16
# (2^-8 relative; read at most 4.0e-3 at batch 32, 6.6e-3 at the headline's
# batch 256), da/db are f32 sums (read 2.4e-6).
TOL_BWD = {"float32": {"dx": 2e-5, "dw": 2e-5, "da": 2e-5, "db": 2e-5},
           "bfloat16": {"dx": 1.6e-2, "dw": 1.6e-2, "da": 2e-5, "db": 2e-5}}
# the check must see a fault in dyt = dy + ds1 + 2*y*ds2: with either term
# dropped, the plain backward's dx and dW move by this many times their limit
BWD_FAULT_MARGIN = 10
TRAIN_LR = 0.003       # f32 check: three steps stay finite and O(1)
TRAIN_STEPS = 3
# training through the kernels vs through the plain versions, same start,
# as read on the H100: step 0's loss, relative (read 9.4e-8); every param's
# step-0 update, max over params of |u_kernel - u_plain| / |u_plain| in norm
# (read 3.5e-2, median 2.5e-2: the train-mode BN backward amplifies sum-order
# rounding block over block, as f32 against f64 does on the CPU; a wiring
# fault of the backward reads above 100, tests/test_torch_resnet50_train.py);
# the later losses, relative (read 6.7e-4 at step 2: the two runs' updates
# differ by ~2.5%, so their losses drift apart by ~2.5% of the loss's change)
TRAIN_LOSS0_TOL = 1e-5
TRAIN_UPDATE_TOL = 0.25
TRAIN_LOSS_TOL = 5e-3
HEADLINE_BATCH = 256   # bench.py's ResNet-50 training configuration
HEADLINE_STEPS = 3
# matmul_bn_act at K and N that are no multiples of 32 (the ragged template),
# at the M of a batch-32 56x56 plane, held to the limits of the ResNet shapes
RAGGED_M = BATCH * 56 * 56
RAGGED_CALLS = tuple((RAGGED_M, k, n, pro) for k, n, pro in (
    (4, 8, True), (4, 8, False), (8, 4, True), (24, 100, True), (100, 24, False),
    (200, 1000, True), (1000, 200, True)))
# every planted fault of the forward check (in f32 one TF32 pass in place of
# three; rows past M counted in s1 and s2; at ragged shapes the columns past
# the last multiple of 32 left unwritten, x's K tail folded) must move the
# check this many times past its limit
FWD_FAULT_MARGIN = 10
# a ComputationGraph of the reference's own ragged bottlenecks
# (tests/test_conv_bn_fused.py): FusedBottleneck (4, 4, 8) and (8, 8, 32)
RAGGED_GRAPH_INPUT = (56, 56, 4)


LOG_LINES: list[str] = []   # every line printed, kept for the result file


def log(msg: str) -> None:
    print(msg, flush=True)
    LOG_LINES.append(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_usage(name: str, nvcc_log: str) -> dict:
    """Kernel name with its template arguments -> ptxas's "Used N
    registers, ... smem" line, after its spill line where it spills."""
    from deeplearning4j_tpu_torch.ops.kernels import _build
    known = sorted({k for path in _build.source_files(name)
                    for k in re.findall(r"\b(\w+_kernel)\(", path.read_text())},
                   key=len, reverse=True)
    usage, kernel, spill = {}, None, ""
    for line in nvcc_log.splitlines():
        if "Compiling entry function" in line:
            base = next((k for k in known if k in line), line)
            args = re.findall(r"L[ib](\d+)E", line.split(base, 1)[-1])
            kernel, spill = base + (f"<{', '.join(args)}>" if args else ""), ""
        elif "spill" in line and kernel and not re.search(r"\b0 bytes spill stores", line):
            spill = line.strip() + "; "
        elif "Used" in line and kernel:
            usage[kernel] = spill + line.split(":", 1)[1].strip()
    return usage


# the libraries every kernel of which must run on Hopper's tensor-core path,
# wgmma (HGMMA in SASS) fed by TMA loads (UTMALDG), in f32 and bf16, with no
# template spilling: the flash kernels, the fused 3x3 conv, the
# matmul_bn_act backward and forward and the int8 dequant-matmul
HOPPER_LIBS = ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_bwd_split",
               "conv3x3_bn_act", "matmul_bn_act_bwd", "int8_matmul", "matmul_bn_act")
FLASH_LIBS = HOPPER_LIBS[:3]
# kernels of those libraries that compute no product and are held to no
# wgmma: the matmul_bn_act forward's f32 weight transpose (W^T, a copy made
# once a call before the GEMM kernel, which reads it by TMA)
HOPPER_COPIES = {"mbf_wt_kernel"}


def sass_counts(name: str) -> dict:
    """Kernel name with its template arguments -> its (HGMMA, UTMALDG)
    instruction counts in the built library's SASS (``cuobjdump -sass``)."""
    from deeplearning4j_tpu_torch.ops.kernels import _build
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            # the mangled kernel name: its length, then the name (a hash of the
            # anonymous namespace before it may hold "fa_" too), then its
            # template arguments
            kernel = line.split(": ", 1)[1]
            for m in re.finditer(r"(?=((?:fa|c3|mbb|mbf|i8)_\w*?_kernel)(I(?:L[ib]\d+E)+E)?)",
                                 line):
                name = m.group(1)
                if line[:m.start()].endswith(str(len(name))):
                    args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
                    kernel = name + (f"<{', '.join(args)}>" if args else "")
                    break
            counts[kernel] = [0, 0]
        elif kernel is not None:
            counts[kernel][0] += "HGMMA" in line
            counts[kernel][1] += "UTMALDG" in line
    return {k: tuple(c) for k, c in counts.items()}


def check_hopper_path(built: dict) -> dict:
    """Every kernel of ``HOPPER_LIBS`` (the flash libraries,
    ``conv3x3_bn_act``, the ``matmul_bn_act`` backward and forward,
    ``int8_matmul``), f32 and bf16, holds wgmma and TMA loads in its SASS
    (the copies of ``HOPPER_COPIES`` no wgmma: they compute no product),
    and no template of them spills (ptxas's report of this build)."""
    result = {}
    for name in HOPPER_LIBS:
        counts = sass_counts(name)
        for kernel, (hgmma, utmaldg) in sorted(counts.items()):
            log(f"  {name}: {kernel}: {hgmma} HGMMA, {utmaldg} UTMALDG"
                + (" (a copy: no product)" if kernel in HOPPER_COPIES else ""))
        missing = [k for k, (hgmma, utmaldg) in counts.items()
                   if k not in HOPPER_COPIES and not (hgmma and utmaldg)]
        if missing or not any("f32" in k for k in counts) or not any("bf16" in k for k in counts):
            raise AssertionError(f"{name}: kernels without wgmma or TMA loads, or no f32 and "
                                 f"bf16 kernels: {missing or sorted(counts)}")
        result[name] = {k: {"hgmma": c[0], "utmaldg": c[1]} for k, c in counts.items()}
        spills = {k: u for k, u in ptxas_usage(name, built[name]["log"]).items() if "spill" in u}
        if spills:
            raise AssertionError(f"{name}: templates spill: {spills}")
    return result


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 3) -> float:
    """The device time of the CUDA kernels one call of ``fn`` launches (all
    of them, summed; torch.profiler over ``reps`` calls after a warm-up),
    without the host's time between them that ``cuda_ms`` also sees."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                for e in prof.key_averages())
    return total / reps / 1e3


def resnet50_calls(net, batch: int) -> list[tuple]:
    """(M, K, N, prologue) of every matmul_bn_act call in one forward."""
    from deeplearning4j_tpu_torch.nn.layers import FusedBottleneck
    calls = []
    for spec in net._topo:
        layer = spec.obj
        if not isinstance(layer, FusedBottleneck):
            continue
        t = net._arriving[spec.name][0]
        sh, sw = layer.stride
        m = batch * (-(-t.height // sh)) * (-(-t.width // sw))
        f1, f2, f3 = layer.filters
        calls += [(m, t.channels, f1, False), (m, f2, f3, True)]
        if layer.project:
            calls.append((m, t.channels, f3, False))
    return calls


def library_matmul_bn_act(x, w, a, b):
    """Yardstick only, never on the port's path: torch.matmul in x's dtype
    (cuBLAS) with the prologue and the statistics as torch ops."""
    import torch
    xh = x if a is None else torch.relu(x * a + b).to(x.dtype)
    y = torch.matmul(xh, w)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def fwd_errs(got, want) -> dict:
    """The forward's (y, s1, s2) against the plain version's, each over its
    scale: y over max |y|, s1 over max_n sum_m |y|, s2 over max |s2|."""
    (y, s1, s2), (ye, s1e, s2e) = got, want
    return {"y": rel_max(y, ye),
            "s1": (s1 - s1e).abs().max().item() / ye.float().abs().sum(0).max().item(),
            "s2": (s2 - s2e).abs().max().item() / s2e.abs().max().item()}


def fwd_over_limit(got, want, dname: str) -> float:
    """How far past its limit the forward check reads ``got``: the largest
    of y, s1 and s2 over their limits."""
    return max(v / TOL[dname][key] for key, v in fwd_errs(got, want).items())


def fwd_one_tf32_pass(x, w, a, b):
    """Comparison only: the f32 forward with one TF32 pass in place of the
    kernel's three (xhat and W cut to TF32 as the tensor core reads f32
    words), the rest as ``matmul_bn_act_plain`` (relu_in on)."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels.flash_attention import tf32_cut
    xh = x.float() if a is None else torch.relu(x.float() * a + b)
    y = tf32_cut(xh) @ tf32_cut(w)
    return y, y.sum(0), (y * y).sum(0)


def fwd_rows_past_m(x, w, a, b):
    """Comparison only: the forward with the rows past M of the last
    128-row tile counted in s1 and s2 (zero rows of x, which a prologue
    folds to act(b)), y of the real rows (relu_in on)."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    m = x.shape[0]
    xp = torch.zeros(-(-m // conv_bn.TILE_M) * conv_bn.TILE_M, x.shape[1], dtype=x.dtype,
                     device=x.device)
    xp[:m] = x
    y, s1, s2 = conv_bn.matmul_bn_act_plain(xp, w, a, b, relu_in=True)
    return y[:m], s1, s2


def check_kernels(calls, dtypes) -> list[dict]:
    """The forward kernel against its plain version at each (M, K, N,
    prologue), with the planted faults, a second call that must give the
    same bits (K split over blocks at the small-M shapes), and times
    (kernel, plain, library yardstick).  The f32 bound is three TF32
    passes' (the kernel's design), the CUDA cores' beside it."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for dtype in dtypes:
        dname = str(dtype).split(".")[1]
        for (m, k, n, pro) in sorted(set(calls)):
            x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5).to(dtype)
            a = torch.rand(k, device="cuda", generator=gen) + 0.5 if pro else None
            b = torch.randn(k, device="cuda", generator=gen) * 0.2 if pro else None
            got = conv_bn.matmul_bn_act(x, w, a, b, relu_in=True)
            torch.cuda.synchronize()
            want = conv_bn.matmul_bn_act_plain(x, w, a, b, relu_in=True)
            ye = want[0]
            yd = (got[0].float() - ye.float()).abs().max().item()
            errs = fwd_errs(got, want)
            bad = {key: v for key, v in errs.items() if not v <= TOL[dname][key]}
            if bad:
                raise AssertionError(f"matmul_bn_act {dname} M={m} K={k} N={n} "
                                     f"prologue={pro}: errors {bad} over {TOL[dname]}")
            # planted faults, each read as the check reads it: its largest
            # error over the limit of y, s1 or s2
            faults = {}
            if dname == "float32":
                faults["one TF32 pass"] = fwd_over_limit(fwd_one_tf32_pass(x, w, a, b), want,
                                                         dname)
            if m % conv_bn.TILE_M and pro:
                faults["rows past M counted"] = fwd_over_limit(fwd_rows_past_m(x, w, a, b),
                                                               want, dname)
            if n % 32:
                # the columns past the last multiple of 32 left unwritten
                yf = ye.float().clone()
                yf[:, n // 32 * 32:] = 0.0
                faults["N tail unwritten"] = fwd_over_limit((yf, yf.sum(0), (yf * yf).sum(0)),
                                                            want, dname)
            if k % 32 and pro:
                # the trap of a ragged K: x's tail past the last multiple of 32
                # zero-filled and still folded, each of its rows adding act(b) W
                # in place of act(x a + b) W
                xf = x.clone()
                xf[:, k // 32 * 32:] = 0
                faults["K tail folded"] = fwd_over_limit(
                    conv_bn.matmul_bn_act_plain(xf, w, a, b, relu_in=True), want, dname)
                del xf
            fault = min(faults.values()) if faults else None
            if faults and not fault >= FWD_FAULT_MARGIN:
                raise AssertionError(f"matmul_bn_act {dname} M={m} K={k} N={n}: a planted fault "
                                     f"moves the check by only {faults} times its limit")
            again = conv_bn.matmul_bn_act(x, w, a, b, relu_in=True)
            if not all(bool(torch.equal(u, v)) for u, v in zip(got, again)):
                raise AssertionError(f"matmul_bn_act {dname} M={m} K={k} N={n} "
                                     f"prologue={pro}: a second call gave other bits")
            del again
            splits = conv_bn.fwd_plan(m, k, n, dtype)["splits"]
            isz = x.element_size()
            nbytes = (m * k + k * n + m * n) * isz + (2 * k * 4 if pro else 0) + 2 * n * 4
            flops = 2 * m * k * n
            peak = PEAK_F32_TF32X3 if dname == "float32" else PEAK_FLOPS[dname]
            row = {"dtype": dname, "M": m, "K": k, "N": n, "prologue": pro,
                   "count": calls.count((m, k, n, pro)), "k_splits": splits,
                   "second_call_bits_equal": True,
                   "max_abs_err": yd, "rel_err": errs, "fault_over_limit": faults,
                   "fault_over_limit_min": fault,
                   "ms": cuda_ms(lambda: conv_bn.matmul_bn_act(x, w, a, b, relu_in=True)),
                   "plain_ms": cuda_ms(lambda: conv_bn.matmul_bn_act_plain(x, w, a, b,
                                                                           relu_in=True)),
                   "library_ms": cuda_ms(lambda: library_matmul_bn_act(x, w, a, b)),
                   "bytes_ms": nbytes / PEAK_BYTES * 1e3,
                   "ops_ms": flops / peak * 1e3,
                   "fma_ops_ms": flops / PEAK_FLOPS[dname] * 1e3}
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            rows.append(row)
            log(f"  {dname:8s} M={m:6d} K={k:4d} N={n:4d} pro={int(pro)} x{row['count']}: "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
                f"library {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
                f"({'bytes' if row['bytes_ms'] >= row['ops_ms'] else 'operations'}; FMA "
                f"{max(row['bytes_ms'], row['fma_ops_ms']):.4f}), K splits {splits}, second "
                f"call same bits; rel err y {errs['y']:.2e} s1 {errs['s1']:.2e} "
                f"s2 {errs['s2']:.2e}"
                + "".join(f"; {key} reads {v:.0f}x the limit" for key, v in faults.items()))
            del x, w, got, ye, want
    return rows


def per_forward(rows, dname: str) -> dict:
    """Sums over the launches of one pass (each row times its ``count``):
    the 36 of one forward (or backward), the 16 3x3 calls."""
    sel = [r for r in rows if r["dtype"] == dname]
    tot = {key: sum(r[key] * r["count"] for r in sel)
           for key in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
    tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in sel)
    return tot


def build_net(updater=None):
    """Full-width ResNet-50 with seeded weights.  The residual-branch BN
    gammas are damped (x0.3, as in the CPU tests) so that 16 blocks of
    random weights keep activations O(1) and the softmax unsaturated:
    otherwise every comparison below would compare one-hot vectors."""
    from deeplearning4j_tpu_torch.models import resnet50
    return damp_residual_gammas(resnet50(fused=True, device="cuda",
                                         updater=updater).init(seed=SEED))


def damp_residual_gammas(net, factor: float = 0.3):
    for d in net.params_.values():
        for key in ("gamma_c", "gamma_proj"):
            if key in d:
                d[key].mul_(factor)
    return net


def log_prob_err(p, q) -> float:
    """max |log p - log q| of two softmax outputs: their logits' difference
    up to a per-row shift, each probability's error over its own size."""
    return (p.log() - q.log()).abs().max().item()


def serve(net, card: str) -> dict:
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nn.layers import fused as fused_mod
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    from deeplearning4j_tpu_torch.serve import InferenceEngine

    rng = np.random.default_rng(SEED)
    sizes = [int(s) for s in rng.integers(1, 9, size=16)]
    images = rng.normal(size=(sum(sizes), 224, 224, 3)).astype(np.float32)
    offsets = np.cumsum([0] + sizes)
    requests = [images[offsets[i]:offsets[i + 1]] for i in range(len(sizes))]

    warm = net.output(images[:BATCH])          # cuDNN and allocator warm-up
    torch.cuda.synchronize()
    assert tuple(warm.shape) == (min(BATCH, len(images)), 1000)

    answers, latency = {}, {}
    conv_bn.launches = 0
    engine = InferenceEngine(net, max_batch=BATCH, max_latency_ms=5.0)
    try:
        def client(ids):
            for i in ids:
                t0 = time.perf_counter()
                answers[i] = engine.predict(requests[i], timeout_s=300)
                latency[i] = time.perf_counter() - t0

        threads = [threading.Thread(target=client, args=(list(range(j, len(sizes), 4)),))
                   for j in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("serving clients did not finish")
    finally:
        engine.shutdown()
    launches, batches = conv_bn.launches, engine.batches
    if len(answers) != len(sizes):
        raise AssertionError(f"{len(answers)} of {len(sizes)} requests answered")
    if launches != 36 * batches or batches == 0:
        raise AssertionError(f"matmul_bn_act launched {launches} times for {batches} batches")

    # every answer against a direct forward of the same images
    serve_err = 0.0
    for i, req in enumerate(requests):
        direct = net.output(req).cpu().numpy()
        a = answers[i]
        if a.shape != (sizes[i], 1000) or not np.isfinite(a).all():
            raise AssertionError(f"request {i}: answer shape {a.shape} or non-finite")
        serve_err = max(serve_err, float(np.abs(a - direct).max()))
    if not serve_err <= SERVE_TOL:
        raise AssertionError(f"engine answers differ from direct forwards by {serve_err}")

    # the whole forward through the kernel vs through the plain version
    x = torch.from_numpy(images[:BATCH]).cuda()
    y_kernel = net.output(x)
    saved = fused_mod.matmul_bn_act
    fused_mod.matmul_bn_act = conv_bn.matmul_bn_act_plain   # comparison only
    try:
        y_plain = net.output(x)
        plain_fwd_ms = cuda_ms(lambda: net.output(x), reps=5)
    finally:
        fused_mod.matmul_bn_act = saved
    fwd_err = log_prob_err(y_kernel, y_plain)
    if not fwd_err <= PLAIN_FWD_TOL:
        raise AssertionError(f"kernel forward differs from plain forward by {fwd_err} "
                             f"in log probabilities")
    top = y_kernel.max(dim=1).values
    if not (torch.isfinite(y_kernel).all() and top.max().item() < 0.99):
        raise AssertionError("forward is non-finite or saturated")
    kernel_fwd_ms = cuda_ms(lambda: net.output(x), reps=5)

    lat = np.array([latency[i] for i in range(len(sizes))]) * 1e3
    result = {"card": card, "requests": len(sizes), "images": int(sum(sizes)),
              "batches": batches, "launches": launches,
              "images_per_s": sum(sizes) / wall, "wall_s": wall,
              "p50_ms": float(np.percentile(lat, 50)), "max_ms": float(lat.max()),
              "serve_max_abs_err": serve_err, "plain_forward_max_log_prob_err": fwd_err,
              "forward_ms_batch32": kernel_fwd_ms, "plain_forward_ms_batch32": plain_fwd_ms,
              "forward_images_per_s_batch32": BATCH / kernel_fwd_ms * 1e3}
    log(f"serve smoke on {card}: {result['images']} images in {len(sizes)} requests, "
        f"{batches} batches, {launches} kernel launches; "
        f"{result['images_per_s']:.1f} images/s, latency p50 {result['p50_ms']:.1f} ms, "
        f"p99 = max of {len(sizes)} {result['max_ms']:.1f} ms; forward at batch {BATCH}: "
        f"{kernel_fwd_ms:.2f} ms ({result['forward_images_per_s_batch32']:.1f} images/s), "
        f"with the plain version {plain_fwd_ms:.2f} ms; errors: engine {serve_err:.2e}, "
        f"kernel vs plain forward {fwd_err:.2e} (log probabilities)")
    return result


class _PlainMatmulBnAct:
    """Comparison only, never on the port's path: ``matmul_bn_act`` with the
    plain forward and the plain backward, whatever the device."""

    def __init__(self):
        import torch
        from deeplearning4j_tpu_torch.ops.kernels import conv_bn

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, w, a, b, relu_in):
                y, s1, s2 = conv_bn.matmul_bn_act_plain(x, w, a, b, relu_in=relu_in)
                ctx.save_for_backward(x, w, a, b, y)
                ctx.relu_in = relu_in
                return y, s1, s2

            @staticmethod
            def backward(ctx, dy, ds1, ds2):
                x, w, a, b, y = ctx.saved_tensors
                return conv_bn.matmul_bn_act_bwd_plain(x, w, a, b, y, dy, ds1, ds2,
                                                       relu_in=ctx.relu_in) + (None,)

        self.fn = Fn

    def __call__(self, x, w, a=None, b=None, *, relu_in: bool = True):
        return self.fn.apply(x, w, a, b, relu_in)


def library_matmul_bn_act_bwd(x, w, a, b, y, dy, ds1, ds2):
    """Yardstick only, never on the port's path: the backward as two
    ``torch.matmul`` in x's dtype (cuBLAS) with the elementwise work and
    the sums as torch ops (relu_in on)."""
    import torch
    dyt = (dy.float() + ds1 + 2.0 * y.float() * ds2).to(dy.dtype)
    dxh = torch.matmul(dyt, w.t())
    da = db = None
    if a is not None:
        xf = x.float()
        pre = xf * a + b
        xh = torch.relu(pre).to(x.dtype)
        dpre = torch.where(pre > 0, dxh.float(), 0.0)
        dx, da, db = (dpre * a).to(x.dtype), (dpre * xf).sum(0), dpre.sum(0)
    else:
        xh, dx = x, dxh
    return dx, torch.matmul(xh.t(), dyt), da, db


def bwd_errs(got, want) -> tuple[dict, float]:
    """Per output of the backward, max |got - want| / max |want|; and the
    largest max |got - want|."""
    errs, abs_err = {}, 0.0
    for name, g, e in zip(("dx", "dw", "da", "db"), got, want):
        if e is None:
            if g is not None:
                raise AssertionError(f"backward {name} given without a prologue")
            continue
        diff = (g.float() - e.float()).abs().max().item()
        abs_err = max(abs_err, diff)
        errs[name] = diff / e.float().abs().max().item()
    return errs, abs_err


def bwd_over_limit(got, want, dname: str) -> float:
    """How far past its limit the backward check reads ``got``: the
    largest of dx, dW, da and db over their limits."""
    return max(v / TOL_BWD[dname][key] for key, v in bwd_errs(got, want)[0].items())


def bwd_one_tf32_pass(x, w, a, b, y, dy, ds1, ds2):
    """Comparison only: the f32 backward with one TF32 pass in place of
    the kernel's three (each product's operands cut to TF32 as the tensor
    core reads f32 words), the rest as ``matmul_bn_act_bwd_plain``
    (relu_in on)."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels.flash_attention import tf32_cut
    dyt = dy.float() + ds1 + 2.0 * y.float() * ds2
    dxh = tf32_cut(dyt) @ tf32_cut(w).t()
    da = db = None
    if a is not None:
        pre = x.float() * a + b
        xh = torch.relu(pre)
        dpre = torch.where(pre > 0, dxh, 0.0)
        dx, da, db = dpre * a, (dpre * x.float()).sum(0), dpre.sum(0)
    else:
        xh, dx = x.float(), dxh
    return dx, tf32_cut(xh).t() @ tf32_cut(dyt), da, db


def check_bwd_kernels(calls, dtypes) -> list[dict]:
    """The backward kernel pair against its plain version at each (M, K, N,
    prologue), with the planted faults, a second call that must give the
    same bits, and times (kernel, plain, library yardstick).  The f32
    bound is three TF32 passes' (the kernels' design), the CUDA cores'
    beside it."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    for dtype in dtypes:
        dname = str(dtype).split(".")[1]
        for (m, k, n, pro) in sorted(set(calls)):
            # as in the net: a call without a prologue reads a ReLU's output
            x = torch.randn(m, k, device="cuda", generator=gen)
            x = (x if pro else x.relu()).to(dtype)
            w = (torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5).to(dtype)
            a = torch.rand(k, device="cuda", generator=gen) + 0.5 if pro else None
            b = torch.randn(k, device="cuda", generator=gen) * 0.2 if pro else None
            y = conv_bn.matmul_bn_act_plain(x, w, a, b, relu_in=True)[0]
            dy = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
            # 2*y*ds2 is O(1) beside dy: y is O(1) here
            ds1 = torch.randn(n, device="cuda", generator=gen)
            ds2 = torch.randn(n, device="cuda", generator=gen) * 0.5
            args = (x, w, a, b, y, dy, ds1, ds2)
            got = conv_bn.matmul_bn_act_bwd(*args, relu_in=True)
            torch.cuda.synchronize()
            want = conv_bn.matmul_bn_act_bwd_plain(*args, relu_in=True)
            errs, abs_err = bwd_errs(got, want)
            bad = {key: v for key, v in errs.items() if not v <= TOL_BWD[dname][key]}
            if bad:
                raise AssertionError(f"matmul_bn_act backward {dname} M={m} K={k} N={n} "
                                     f"prologue={pro}: errors {bad} over {TOL_BWD[dname]}")
            fault_errs, seen = {}, {}
            for term, fargs in (("ds1", (x, w, a, b, y, dy, torch.zeros_like(ds1), ds2)),
                                ("2*y*ds2", (x, w, a, b, y, dy, ds1, torch.zeros_like(ds2)))):
                moved = bwd_errs(conv_bn.matmul_bn_act_bwd_plain(*fargs, relu_in=True), want)[0]
                for key in ("dx", "dw"):
                    fault_errs[f"{term} dropped: {key}"] = moved[key] / TOL_BWD[dname][key]
                seen[f"{term} dropped"] = max(v / TOL_BWD[dname][key] for key, v in moved.items())
            if dname == "float32":
                seen["one TF32 pass"] = fault_errs["one TF32 pass"] = bwd_over_limit(
                    bwd_one_tf32_pass(*args), want, dname)
            gated, ragged = dict(fault_errs), bool(k % 32 or n % 32)
            if ragged:
                # ragged shapes: every planted fault is gated as the check reads
                # it, its largest error over the limits of dx, dW, da and db.
                # With N of a few columns a dropped dyt term shifts every row of
                # dx by one vector, a sum of N terms, beside max |dx| over M rows:
                # a few times dx's bf16 limit, while dW moves far past its own.
                tails = {}
                if k % 32:
                    kt = k // 32 * 32
                    dxf, dwf = want[0].float().clone(), want[1].float().clone()
                    dxf[:, kt:], dwf[kt:] = 0.0, 0.0
                    tails |= {"K tail unwritten: dx": (dxf, *want[1:]),
                              "K tail unwritten: dw": (want[0], dwf, *want[2:])}
                    if pro:
                        # the trap of a ragged K: x's tail zero-filled and still
                        # folded, act(b) in place of act(x a + b)
                        xf = x.clone()
                        xf[:, kt:] = 0
                        tails["K tail folded"] = conv_bn.matmul_bn_act_bwd_plain(
                            xf, w, a, b, y, dy, ds1, ds2, relu_in=True)
                        del xf
                if n % 32:
                    dwf = want[1].float().clone()
                    dwf[:, n // 32 * 32:] = 0.0
                    tails["N tail unwritten: dw"] = (want[0], dwf, *want[2:])
                gated = seen | {key: bwd_over_limit(t, want, dname) for key, t in tails.items()}
                fault_errs |= gated
                del tails
            weak = {key: v for key, v in gated.items() if not v >= BWD_FAULT_MARGIN}
            if weak:
                raise AssertionError(f"matmul_bn_act backward {dname} M={m} K={k} N={n}: "
                                     f"a planted fault moves the check by only {weak} "
                                     f"times its limit")
            again = conv_bn.matmul_bn_act_bwd(*args, relu_in=True)
            if not all(u is None and v is None or bool(torch.equal(u, v))
                       for u, v in zip(got, again)):
                raise AssertionError(f"matmul_bn_act backward {dname} M={m} K={k} N={n} "
                                     f"prologue={pro}: a second call gave other bits")
            del again
            splits = conv_bn.bwd_plan(m, k, n, dtype)["splits"]
            isz = x.element_size()
            nbytes = ((2 * m * k + 2 * m * n + 2 * k * n) * isz
                      + (4 * k * 4 if pro else 0) + 2 * n * 4)
            flops = 4 * m * k * n
            peak = PEAK_F32_TF32X3 if dname == "float32" else PEAK_FLOPS[dname]
            row = {"dtype": dname, "M": m, "K": k, "N": n, "prologue": pro,
                   "count": calls.count((m, k, n, pro)), "max_abs_err": abs_err,
                   "m_splits": splits, "second_call_bits_equal": True,
                   "rel_err": errs, "fault_over_limit": fault_errs,
                   "fault_over_limit_min": min(gated.values()),
                   "ms": cuda_ms(lambda: conv_bn.matmul_bn_act_bwd(*args, relu_in=True)),
                   "plain_ms": cuda_ms(lambda: conv_bn.matmul_bn_act_bwd_plain(*args,
                                                                               relu_in=True)),
                   "library_ms": cuda_ms(lambda: library_matmul_bn_act_bwd(*args)),
                   "bytes_ms": nbytes / PEAK_BYTES * 1e3,
                   "ops_ms": flops / peak * 1e3,
                   "fma_ops_ms": flops / PEAK_FLOPS[dname] * 1e3}
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            rows.append(row)
            log(f"  {dname:8s} M={m:6d} K={k:4d} N={n:4d} pro={int(pro)} x{row['count']}: "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
                f"library {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
                f"({'bytes' if row['bytes_ms'] >= row['ops_ms'] else 'operations'}; FMA "
                f"{max(row['bytes_ms'], row['fma_ops_ms']):.4f}), M splits {splits}, second "
                f"call same bits; rel err "
                + " ".join(f"{key} {v:.2e}" for key, v in errs.items())
                + f"; a planted fault reads >= {row['fault_over_limit_min']:.0f}x the limit"
                + ("" if not ragged else " (" + ", ".join(
                    f"{key} {v:.1f}x" for key, v in gated.items()) + "; dx alone under a "
                    f"dropped dyt term {min(fault_errs[f'{t} dropped: dx'] for t in ('ds1', '2*y*ds2')):.1f}x)"))
            del x, w, y, dy, got, want
    return rows


def train_steps(net, batch, steps: int) -> dict:
    """``steps`` steps of ``Trainer(net).fit_batch``, each driven with the
    launch counts set to 0 just before it and read just after; returns the
    losses, each step's counts and seconds (synchronized), and the step-0
    update of every param."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    from deeplearning4j_tpu_torch.train import Trainer
    trainer = Trainer(net)
    p0 = {v: {k: t.clone() for k, t in d.items()} for v, d in net.params_.items()}
    out = {"losses": [], "launches": [], "seconds": []}
    for step in range(steps):
        conv_bn.launches = conv_bn.bwd_launches = 0
        if net.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.fit_batch(batch)
        out["losses"].append(loss.item())   # waits for the step
        out["seconds"].append(time.perf_counter() - t0)
        out["launches"].append((conv_bn.launches, conv_bn.bwd_launches))
        if step == 0:
            out["update0"] = {v: {k: net.params_[v][k] - t for k, t in d.items()}
                              for v, d in p0.items()}
    return out


def update_errs(got: dict, want: dict) -> dict:
    """Per param, |u_got - u_want| / |u_want| in norm: the relative error
    of that param's gradient (same learning rate and momentum)."""
    return {f"{v}.{k}": ((u - want[v][k]).norm() / want[v][k].norm()).item()
            for v, d in got.items() for k, u in d.items()}


def train_check(card: str) -> dict:
    """Phase 6: full-width f32 training, kernels vs plain versions."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn.layers import fused as fused_mod
    from deeplearning4j_tpu_torch.train import Nesterovs

    rng = np.random.default_rng(SEED + 3)
    batch = DataSet(torch.from_numpy(rng.normal(size=(BATCH, 224, 224, 3)).astype(np.float32))
                    .cuda(), torch.eye(1000, device="cuda")[rng.integers(0, 1000, BATCH)])
    kernel = train_steps(build_net(Nesterovs(TRAIN_LR, 0.9)), batch, TRAIN_STEPS)
    saved = fused_mod.matmul_bn_act
    fused_mod.matmul_bn_act = _PlainMatmulBnAct()   # comparison only
    try:
        plain = train_steps(build_net(Nesterovs(TRAIN_LR, 0.9)), batch, TRAIN_STEPS)
    finally:
        fused_mod.matmul_bn_act = saved
    if any(c != (36, 36) for c in kernel["launches"]):
        raise AssertionError(f"training launched (forward, backward) kernels "
                             f"{kernel['launches']} per step, not (36, 36)")
    if any(c != (0, 0) for c in plain["launches"]):
        raise AssertionError("the plain run launched a kernel")
    if not all(np.isfinite(kernel["losses"] + plain["losses"])):
        raise AssertionError(f"non-finite loss: {kernel['losses']} vs {plain['losses']}")
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(kernel["losses"], plain["losses"])]
    if not loss_errs[0] <= TRAIN_LOSS0_TOL:
        raise AssertionError(f"step-0 loss {kernel['losses'][0]} vs plain "
                             f"{plain['losses'][0]}: {loss_errs[0]:.2e} relative")
    if not max(loss_errs[1:]) <= TRAIN_LOSS_TOL:
        raise AssertionError(f"later losses {kernel['losses']} vs plain {plain['losses']}")
    errs = update_errs(kernel["update0"], plain["update0"])
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    if not worst[0][1] <= TRAIN_UPDATE_TOL:
        raise AssertionError(f"step-0 updates differ from the plain run's: {worst[:5]}")
    step_s = float(np.mean(kernel["seconds"][1:]))
    plain_step_s = float(np.mean(plain["seconds"][1:]))
    result = {"card": card, "batch": BATCH, "lr": TRAIN_LR, "losses": kernel["losses"],
              "plain_losses": plain["losses"], "loss_rel_errs": loss_errs,
              "launches_per_step": kernel["launches"],
              "update_rel_err_max": worst[0][1], "update_rel_err_worst": worst[:5],
              "update_rel_err_median": float(np.median(list(errs.values()))),
              "step_ms": step_s * 1e3, "plain_step_ms": plain_step_s * 1e3,
              "images_per_s": BATCH / step_s}
    log(f"train f32 batch {BATCH} on {card}: losses {kernel['losses']} "
        f"(plain {plain['losses']}), step-0 loss rel err {loss_errs[0]:.2e}, "
        f"update rel err max {worst[0][1]:.2e} ({worst[0][0]}), median "
        f"{result['update_rel_err_median']:.2e}; (forward, backward) launches per step "
        f"{kernel['launches']}; step {result['step_ms']:.1f} ms "
        f"({result['images_per_s']:.1f} images/s), plain {result['plain_step_ms']:.1f} ms")
    return result


def headline(card: str) -> dict:
    """Phase 7: bf16 policy, batch 256 (or the largest power of two that
    fits), Nesterovs(0.1, 0.9): timed steps after one warm-up step."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.train import Nesterovs

    rng = np.random.default_rng(SEED + 4)
    config.set_dtype_policy(config.DTypePolicy.bf16())
    try:
        batch_size, run = HEADLINE_BATCH, None
        while run is None:
            torch.cuda.reset_peak_memory_stats()
            try:
                batch = DataSet(torch.from_numpy(rng.normal(size=(batch_size, 224, 224, 3))
                                                 .astype(np.float32)).cuda(),
                                torch.eye(1000, device="cuda")[rng.integers(0, 1000,
                                                                            batch_size)])
                run = train_steps(build_net(Nesterovs(0.1, 0.9)), batch, 1 + HEADLINE_STEPS)
            except torch.cuda.OutOfMemoryError:
                if batch_size == 1:
                    raise
            if run is None:   # out of the handler, so the failed step's tensors are gone
                batch = None
                torch.cuda.empty_cache()
                log(f"headline: batch {batch_size} does not fit the card; halving")
                batch_size //= 2
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    if any(c != (36, 36) for c in run["launches"]):
        raise AssertionError(f"headline launched {run['launches']} per step, not (36, 36)")
    if not np.isfinite(run["losses"][0]):
        raise AssertionError(f"headline step-0 loss {run['losses'][0]}")
    step_s = float(np.mean(run["seconds"][1:]))
    result = {"card": card, "policy": "bf16", "batch": batch_size,
              "batch_is_headline": batch_size == HEADLINE_BATCH, "updater": "nesterovs(0.1, 0.9)",
              "losses": run["losses"], "step_ms": step_s * 1e3,
              "images_per_s": batch_size / step_s,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"headline train bf16 batch {batch_size} on {card}: step {result['step_ms']:.1f} ms "
        f"({result['images_per_s']:.1f} images/s) over {HEADLINE_STEPS} steps after one "
        f"warm-up, peak memory {result['peak_memory_gib']:.1f} GiB, losses {run['losses']}")
    return result


def build_ragged_graph():
    """FusedBottleneck (4, 4, 8), projected, then (8, 8, 32) at stride 2,
    global average pooling and a 10-class softmax: every 1x1 conv at a K
    or N that is no multiple of 32 but the last ones' N = 32."""
    from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import (FusedBottleneck, GlobalPoolingLayer,
                                                    OutputLayer)
    from deeplearning4j_tpu_torch.train import Nesterovs
    gb = (NeuralNetConfiguration.builder().seed(SEED).updater(Nesterovs(TRAIN_LR, 0.9))
          .weight_init("relu").graph().add_inputs("in")
          .set_input_types(InputType.convolutional(*RAGGED_GRAPH_INPUT)))
    gb.add_layer("b1", FusedBottleneck(filters=(4, 4, 8), project=True), "in")
    gb.add_layer("b2", FusedBottleneck(filters=(8, 8, 32), stride=(2, 2), project=True), "b1")
    gb.add_layer("pool", GlobalPoolingLayer(pooling_type="avg"), "b2")
    gb.add_layer("out", OutputLayer(n_out=10, activation="softmax", loss="mcxent"), "pool")
    gb.set_outputs("out")
    return ComputationGraph(gb.build(), device="cuda").init(seed=SEED)


def ragged_graph(card: str) -> dict:
    """The ragged bottlenecks as a graph on the card, f32: 8 requests of
    1-8 images served through the engine (6 forward launches per batch,
    each answer equal to a direct forward), the forward at batch 32
    through the kernel against the plain version in log probabilities,
    and one Trainer step through the kernels against one through both
    plain versions from the same start."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn.layers import fused as fused_mod
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    from deeplearning4j_tpu_torch.serve import InferenceEngine

    rng = np.random.default_rng(SEED + 6)
    net = build_ragged_graph()
    sizes = [int(n) for n in rng.integers(1, 9, size=8)]
    requests = [rng.normal(size=(n, *RAGGED_GRAPH_INPUT)).astype(np.float32) for n in sizes]
    conv_bn.launches = 0
    with InferenceEngine(net, max_batch=BATCH) as engine:
        answers = [engine.predict(r, timeout_s=120) for r in requests]
        batches = engine.batches
    launches = conv_bn.launches
    if launches != 6 * batches or batches == 0:
        raise AssertionError(f"ragged graph: matmul_bn_act launched {launches} times for "
                             f"{batches} batches, not 6 per batch")
    serve_err = max(float(np.abs(a - net.output(r).cpu().numpy()).max())
                    for a, r in zip(answers, requests))
    if not serve_err <= SERVE_TOL or any(a.shape != (len(r), 10) for a, r in zip(answers,
                                                                                requests)):
        raise AssertionError(f"ragged graph: engine answers differ from direct forwards by "
                             f"{serve_err}")
    x = torch.from_numpy(rng.normal(size=(BATCH, *RAGGED_GRAPH_INPUT)).astype(np.float32)).cuda()
    conv_bn.launches = 0
    y_kernel = net.output(x)
    fwd_launches = conv_bn.launches
    saved = fused_mod.matmul_bn_act
    fused_mod.matmul_bn_act = conv_bn.matmul_bn_act_plain   # comparison only
    try:
        y_plain = net.output(x)
    finally:
        fused_mod.matmul_bn_act = saved
    fwd_err = log_prob_err(y_kernel, y_plain)
    if fwd_launches != 6 or not fwd_err <= PLAIN_FWD_TOL or not torch.isfinite(y_kernel).all():
        raise AssertionError(f"ragged graph forward: {fwd_launches} launches, kernel vs plain "
                             f"{fwd_err} in log probabilities")

    batch = DataSet(x, torch.eye(10, device="cuda")[rng.integers(0, 10, BATCH)])
    kernel = train_steps(build_ragged_graph(), batch, 1)
    fused_mod.matmul_bn_act = _PlainMatmulBnAct()   # comparison only
    try:
        plain = train_steps(build_ragged_graph(), batch, 1)
    finally:
        fused_mod.matmul_bn_act = saved
    if kernel["launches"] != [(6, 6)] or plain["launches"] != [(0, 0)]:
        raise AssertionError(f"ragged graph step launched {kernel['launches']} (plain "
                             f"{plain['launches']}), not [(6, 6)] ([(0, 0)])")
    loss_err = abs(kernel["losses"][0] - plain["losses"][0]) / abs(plain["losses"][0])
    errs = update_errs(kernel["update0"], plain["update0"])
    worst = max(errs.items(), key=lambda kv: kv[1])
    if not (loss_err <= TRAIN_LOSS0_TOL and worst[1] <= TRAIN_UPDATE_TOL):
        raise AssertionError(f"ragged graph step: loss {kernel['losses']} vs plain "
                             f"{plain['losses']} ({loss_err:.2e}), worst update {worst}")
    result = {"card": card, "requests": len(sizes), "images": sum(sizes), "batches": batches,
              "launches": launches, "serve_max_abs_err": serve_err,
              "plain_forward_max_log_prob_err": fwd_err, "loss": kernel["losses"][0],
              "loss_rel_err": loss_err, "update_rel_err_max": worst[1],
              "update_rel_err_worst": worst[0]}
    log(f"ragged FusedBottleneck (4, 4, 8) + (8, 8, 32) graph on {card}: {sum(sizes)} images in "
        f"{len(sizes)} requests, {batches} batches, {launches} kernel launches, engine vs direct "
        f"{serve_err:.2e}; forward at batch {BATCH} kernel vs plain {fwd_err:.2e} (log "
        f"probabilities); one Trainer step: launches {kernel['launches'][0]}, loss "
        f"{kernel['losses'][0]:.6f} vs plain {plain['losses'][0]:.6f} ({loss_err:.2e}), update "
        f"rel err max {worst[1]:.2e} ({worst[0]})")
    return result


# ------------------------------------------------------- 3x3 conv + BN
CONV3_SEED = SEED + 20
# ResNet-50 v1's 3x3 stages, every one stride 1 with C = Cout (the stride
# sits on the first 1x1): (H = W, C, calls per pass)
CONV3_STAGES = ((56, 64, 3), (28, 128, 4), (14, 256, 6), (7, 512, 3))
# at the ResNet shapes: (prologue, relu_in), the first the path's and timed
CONV3_VARIANTS = ((True, True), (True, False), (False, True))
# shapes the path does not give, f32 and bf16, prologue and relu_in on:
# (N, H, W, C, Cout)
CONV3_RAGGED = (
    (2, 8, 7, 16, 16),          # the reference test's case
    (BATCH, 28, 28, 24, 40),    # C != Cout, neither a multiple of 8 or 32
    (BATCH, 56, 56, 3, 5),      # C = 3 -> 5: the element-by-element template
    (8, 112, 112, 64, 64),      # a plane over 1 MB with H % 8 == 0 (the TPU's tiled body)
    (6, 113, 97, 64, 64),       # over 1 MB, H % 8 != 0 (the reference refuses it); H*W
                                # no multiple of the kernel's 128-pixel tile, so tiles
                                # cross row and image seams
)
# kernel vs plain: TOL, as fwd_errs reads it on y as [N*H*W, Cout]; kernel
# vs the layer's own chain (fused.conv3x3_stage: relu(y1*a1 + b1) in
# the compute dtype, cuDNN, the sums of its y) on the 16 captured stages.
# f32: the same function, sum order only.  bf16: the chain folds in bf16
# arithmetic (a1 and b1 rounded to bf16, then each op), where the kernel
# folds in f32 and rounds once: where y1 a1 and b1 nearly cancel (BN centres
# the channel), 2^-9 of |b1| is a percent of the folded value, in the same
# direction for a whole channel; cuDNN rounds y, and the chain's sums are
# of the rounded y.  (Read on the H100 at batch 256: 7.5e-3 (y), 7.5e-3
# (s1), 4.8e-3 (s2).)  A wiring fault (a tap, a fold, the weights) reads
# O(1).
CONV3_LAYER_TOL = {"float32": TOL["float32"],
                   "bfloat16": {"y": 4e-2, "s1": 4e-2, "s2": 4e-2}}
# gradients of x, w, a, b through the op (autograd of conv3x3_reference at
# the kernel's outputs) vs through conv3x3_reference, max |diff| over max
# |grad|: the two differ only through ds1 = 2 s1 (the kernel's s1 against
# the reference's, sum order) and cuDNN's own sum order
CONV3_GRAD_TOL = 1e-4
CONV3_FAULT_MARGIN = 10


def conv3_calls(batch: int) -> list[tuple]:
    """(N, H, W, C, Cout) of each of the 16 3x3 calls of one pass."""
    return [(batch, h, h, c, c) for h, c, count in CONV3_STAGES for _ in range(count)]


def conv3_work(n, h, w, c, cout, isz, prologue=True) -> tuple[int, int]:
    """(bytes, operations) of one call: x and w read once, a and b, y and
    the two statistics written once; 2 N H W 9C Cout operations."""
    m = n * h * w
    nbytes = (m * c + 9 * c * cout + m * cout) * isz + (2 * c * 4 if prologue else 0) + 2 * cout * 4
    return nbytes, 2 * m * 9 * c * cout


def conv3_flat(outs):
    """(y, s1, s2) with y as [N*H*W, Cout], as fwd_errs reads it."""
    y, s1, s2 = outs
    return y.reshape(-1, y.shape[-1]), s1, s2


def library_conv3(x, w, a, b):
    """Yardstick only, never the op's path: the port's own chain
    (``fused.conv3x3_stage``: relu(x*a + b) in x's dtype, ``F.conv2d``
    through cuDNN, the two sums)."""
    from deeplearning4j_tpu_torch.nn.layers import fused as fused_mod
    n, h, wd, c = x.shape
    return fused_mod.conv3x3_stage(x.reshape(-1, c), a, b, w, (n, h, wd), train=True)


def conv3_faults(x, w, a, b, relu_in, want, dname) -> dict:
    """Each planted fault, read as the check reads it (its largest error
    over the limits of y, s1 and s2): (a) the taps outside the image filled
    with act(0 a + b), the fold applied after the zero padding (prologue
    only); (b) the flattened neighbours taken across row and image seams;
    (c) the last tap dropped; (d) f32: one TF32 pass in place of three (the
    folded input and the weights cut to TF32, as the tensor core reads f32
    words)."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops.kernels import conv3_bn
    from deeplearning4j_tpu_torch.ops.kernels.flash_attention import tf32_cut

    def fold(t):
        if a is None:
            return t.float()
        h = t.float() * a + b
        return (torch.relu(h) if relu_in else h).to(x.dtype).float()

    def finish(y):
        return y.to(x.dtype), y.sum((0, 1, 2)), (y * y).sum((0, 1, 2))

    def over(got):
        return fwd_over_limit(conv3_flat(got), conv3_flat(want), dname)

    n, h, wd, c = x.shape
    wf = w.float()
    faults = {}
    if a is not None:
        xp = fold(F.pad(x, (0, 0, 1, 1, 1, 1)))
        faults["border taps act(b)"] = over(finish(F.conv2d(
            xp.permute(0, 3, 1, 2), wf.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)))
    flat = F.pad(fold(x).reshape(-1, c), (0, 0, wd + 1, wd + 1))
    m = n * h * wd
    y = sum(flat[wd + 1 + (di - 1) * wd + dj - 1:][:m] @ wf[di, dj]
            for di in range(3) for dj in range(3))
    faults["neighbours across seams"] = over(finish(y.reshape(n, h, wd, -1)))
    w_drop = w.clone()
    w_drop[2, 2] = 0
    faults["last tap dropped"] = over(conv3_bn.conv3x3_bn_act_plain(x, w_drop, a, b,
                                                                   relu_in=relu_in))
    if dname == "float32":
        y = F.conv2d(tf32_cut(fold(x)).permute(0, 3, 1, 2), tf32_cut(wf).permute(3, 2, 0, 1),
                     padding=1).permute(0, 2, 3, 1)
        faults["one TF32 pass"] = over(finish(y))
    return faults


def check_conv3(shapes, dtypes, variants, timed: bool = True) -> list[dict]:
    """The kernel against its plain version at each (N, H, W, C, Cout) and
    (prologue, relu_in), with the planted faults, and a second call that
    must give the same bits (where the plan splits K too); times the first
    variant (kernel, plain, the library yardstick: one warm-up, 10 calls
    each).  The f32 bound is three TF32 passes' (the kernel's design), the
    CUDA cores' beside it."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv3_bn
    gen = torch.Generator(device="cuda").manual_seed(CONV3_SEED)
    rows = []
    for dtype in dtypes:
        dname = str(dtype).split(".")[1]
        for shape in sorted(set(shapes)):
            n, h, wd, c, cout = shape
            x = torch.randn(n, h, wd, c, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(3, 3, c, cout, device="cuda", generator=gen)
                 / (9 * c) ** 0.5).to(dtype)
            a0 = torch.rand(c, device="cuda", generator=gen) + 0.5
            b0 = torch.randn(c, device="cuda", generator=gen) * 0.2
            for vi, (pro, relu_in) in enumerate(variants):
                a, b = (a0, b0) if pro else (None, None)
                got = conv3_bn.conv3x3_bn_act(x, w, a, b, relu_in=relu_in)
                torch.cuda.synchronize()
                want = conv3_bn.conv3x3_bn_act_plain(x, w, a, b, relu_in=relu_in)
                errs = fwd_errs(conv3_flat(got), conv3_flat(want))
                bad = {key: v for key, v in errs.items() if not v <= TOL[dname][key]}
                if bad:
                    raise AssertionError(f"conv3x3_bn_act {dname} {shape} prologue={pro} "
                                         f"relu_in={relu_in}: errors {bad} over {TOL[dname]}")
                faults = conv3_faults(x, w, a, b, relu_in, want, dname)
                weak = {key: v for key, v in faults.items() if not v >= CONV3_FAULT_MARGIN}
                if weak:
                    raise AssertionError(f"conv3x3_bn_act {dname} {shape} prologue={pro} "
                                         f"relu_in={relu_in}: a planted fault moves the check "
                                         f"by only {weak} times its limit")
                again = conv3_bn.conv3x3_bn_act(x, w, a, b, relu_in=relu_in)
                if not all(bool(torch.equal(u, v)) for u, v in zip(got, again)):
                    raise AssertionError(f"conv3x3_bn_act {dname} {shape} prologue={pro} "
                                         f"relu_in={relu_in}: a second call gave other bits")
                del again
                splits = conv3_bn.plan(n * h * wd, cout, 9 * c, dtype)["splits"]
                nbytes, flops = conv3_work(*shape, x.element_size(), pro)
                peak = PEAK_F32_TF32X3 if dname == "float32" else PEAK_FLOPS[dname]
                row = {"dtype": dname, "N": n, "H": h, "W": wd, "C": c, "Cout": cout,
                       "prologue": pro, "relu_in": relu_in, "count": shapes.count(shape),
                       "k_splits": splits, "second_call_bits_equal": True,
                       "max_abs_err": (got[0].float() - want[0].float()).abs().max().item(),
                       "rel_err": errs, "fault_over_limit": faults,
                       "fault_over_limit_min": min(faults.values()),
                       "bytes_ms": nbytes / PEAK_BYTES * 1e3, "ops_ms": flops / peak * 1e3,
                       "fma_ops_ms": flops / PEAK_FLOPS[dname] * 1e3}
                row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
                row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
                text = ""
                if timed and vi == 0:
                    row |= {"ms": cuda_ms(lambda: conv3_bn.conv3x3_bn_act(x, w, a, b),
                                          warmup=1),
                            "plain_ms": cuda_ms(lambda: conv3_bn.conv3x3_bn_act_plain(x, w, a, b),
                                                warmup=1),
                            "library_ms": cuda_ms(lambda: library_conv3(x, w, a, b), warmup=1),
                            "device_ms": device_ms(lambda: conv3_bn.conv3x3_bn_act(x, w, a, b))}
                    text = (f"kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
                            f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, ")
                rows.append(row)
                log(f"  {dname:8s} {shape} pro={int(pro)} relu={int(relu_in)} x{row['count']}: "
                    f"{text}bound {row['bound_ms']:.4f} ({row['bound_by']}; FMA "
                    f"{row['fma_ops_ms']:.4f}), K splits {splits}, second call same bits; rel "
                    f"err y {errs['y']:.2e} s1 {errs['s1']:.2e} s2 {errs['s2']:.2e}; faults "
                    + ", ".join(f"{key} {v:.0f}x" for key, v in faults.items()))
                del got, want
            del x, w
    torch.cuda.empty_cache()
    return rows


def conv3_path(card: str, batch: int, policy: str) -> dict:
    """The op's path: one train-mode forward of the seeded full-width
    ResNet-50 at ``batch`` under ``policy``, its 16 3x3 stages captured
    through ``fused.conv3x3_stage``; then, with the counts set to 0 just
    before, ``conv3x3_bn_act(y1, W_b3, a1, b1, relu_in=True)`` on each
    stage's inputs, held to the stage's own outputs and to the plain
    version.  The model itself never calls the op."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.nn.layers import fused as fused_mod
    from deeplearning4j_tpu_torch.ops.kernels import conv3_bn

    dname = "float32" if policy == "f32" else "bfloat16"
    rng = np.random.default_rng(CONV3_SEED + batch)
    x = torch.from_numpy(rng.normal(size=(batch, 224, 224, 3)).astype(np.float32)).cuda()
    net = build_net()
    stage, captured = fused_mod.conv3x3_stage, []

    def watch(y1, a1, b1, w, shape, *, train):
        out = stage(y1, a1, b1, w, shape, train=train)
        captured.append(((y1, a1, b1, w, shape), out))
        return out

    config.set_dtype_policy(getattr(config.DTypePolicy, policy)())
    fused_mod.conv3x3_stage = watch
    try:
        with torch.no_grad():
            net._forward(net.params_, net.state_, x, train=True)
    finally:
        fused_mod.conv3x3_stage = stage
        config.set_dtype_policy(config.DTypePolicy.f32())
    del net, x
    shapes = [(*shape, w.shape[2], w.shape[3]) for (_, _, _, w, shape), _ in captured]
    if shapes != conv3_calls(batch):
        raise AssertionError(f"captured 3x3 stages {shapes}, not {conv3_calls(batch)}")
    torch.cuda.synchronize()
    conv3_bn.launches = 0
    outs = [conv3_bn.conv3x3_bn_act(y1.reshape(*shape, -1), w, a1.float(), b1.float(),
                                    relu_in=True) for (y1, a1, b1, w, shape), _ in captured]
    torch.cuda.synchronize()
    launches = conv3_bn.launches
    if launches != 16:
        raise AssertionError(f"the 16 stages launched the kernel {launches} times, not 16")
    layer_errs, plain_errs = [], []
    for ((y1, a1, b1, w, shape), (y2, s1b, s2b)), got in zip(captured, outs):
        if got[0].dtype != y1.dtype or not all(bool(torch.isfinite(t).all()) for t in got):
            raise AssertionError(f"3x3 stage {shape}: kernel output non-finite or {got[0].dtype}")
        layer = fwd_errs(conv3_flat(got), (y2, s1b, s2b))
        plain = fwd_errs(conv3_flat(got), conv3_flat(conv3_bn.conv3x3_bn_act_plain(
            y1.reshape(*shape, -1), w, a1.float(), b1.float(), relu_in=True)))
        for errs, tol, what in ((layer, CONV3_LAYER_TOL, "the layer's chain"),
                                (plain, TOL, "the plain version")):
            bad = {key: v for key, v in errs.items() if not v <= tol[dname][key]}
            if bad:
                raise AssertionError(f"3x3 stage {shape} {dname}: kernel vs {what}: {bad} over "
                                     f"{tol[dname]}")
        layer_errs.append(layer)
        plain_errs.append(plain)
    worst = {src: {key: max(e[key] for e in errs) for key in ("y", "s1", "s2")}
             for src, errs in (("layer", layer_errs), ("plain", plain_errs))}
    result = {"card": card, "batch": batch, "policy": policy, "stages": len(captured),
              "launches": launches,
              "vs_layer_rel_err_max": worst["layer"], "vs_plain_rel_err_max": worst["plain"]}
    log(f"3x3 path {policy} batch {batch} on {card}: 16 stages captured from a train-mode "
        f"ResNet-50 forward; launches {launches}; kernel vs the layer's chain "
        + " ".join(f"{k} {v:.2e}" for k, v in worst["layer"].items()) + "; vs plain "
        + " ".join(f"{k} {v:.2e}" for k, v in worst["plain"].items()))
    return result


def conv3_autograd(card: str) -> dict:
    """The reference test's loss y.sum() + (s1*s1).sum() + s2.sum() at each
    ResNet 3x3 shape, batch 32, f32: gradients of x, w, a, b through the op
    against those through ``conv3x3_reference``; the backward launches no
    kernel of the port."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv3_bn, conv_bn, flash_attention as fa
    from deeplearning4j_tpu_torch.ops.kernels import quant_matmul

    def counts():
        return (conv3_bn.launches, conv_bn.launches,
                conv_bn.bwd_launches, fa.launches, fa.bwd_launches, fa.split_launches,
                quant_matmul.launches)

    gen = torch.Generator(device="cuda").manual_seed(CONV3_SEED + 1)
    errs = {}
    for h, c, _ in CONV3_STAGES:
        x = torch.randn(BATCH, h, h, c, device="cuda", generator=gen)
        w = torch.randn(3, 3, c, c, device="cuda", generator=gen) / (9 * c) ** 0.5
        a = torch.rand(c, device="cuda", generator=gen) + 0.5
        b = torch.randn(c, device="cuda", generator=gen) * 0.2
        grads = []
        for through in ("op", "reference"):
            prims = [t.detach().clone().requires_grad_(True) for t in (x, w, a, b)]
            if through == "op":
                y, s1, s2 = conv3_bn.conv3x3_bn_act(*prims, relu_in=True)
            else:
                y, s1, s2 = conv3_bn.conv3x3_reference(*prims, has_prologue=True, relu_in=True)
            loss = y.sum() + (s1 * s1).sum() + s2.sum()
            torch.cuda.synchronize()
            before = counts()
            grads.append(torch.autograd.grad(loss, prims))
            torch.cuda.synchronize()
            if counts() != before:
                raise AssertionError(f"the 3x3 backward ({through}) launched a port kernel")
        shape_errs = {name: rel_max(g, e) for name, g, e in zip("xwab", *grads)}
        bad = {k: v for k, v in shape_errs.items() if not v <= CONV3_GRAD_TOL}
        if bad or not all(bool(torch.isfinite(g).all()) for g in grads[0]):
            raise AssertionError(f"3x3 autograd ({BATCH}, {h}, {h}, {c}): gradients through "
                                 f"the op vs conv3x3_reference {bad} over {CONV3_GRAD_TOL}")
        errs[f"{h}x{h}x{c}"] = shape_errs
        del x, w, a, b, grads
    log(f"3x3 autograd on {card}: gradients through conv3x3_bn_act vs conv3x3_reference, "
        f"batch {BATCH} f32, max over x, w, a, b: "
        + ", ".join(f"{k} {max(v.values()):.2e}" for k, v in errs.items()))
    return {"card": card, "rel_err": errs}


# ------------------------------------------------------------------ BERT
FLASH_SEED = SEED + 10
# (name, B, H, Tq, Tk, causal, key-mask valid lengths or None, q_offset, k_offset)
FLASH_CASES = (
    ("base", 2, 12, 4096, 4096, False, None, 0, 0),
    ("key_mask", 2, 12, 4096, 4096, False, (4096, 2500), 0, 0),
    ("causal_offsets", 2, 12, 4096, 4096, True, None, 1024, 512),
    ("cross", 2, 12, 1000, 4096, False, None, 0, 0),
    ("dead_rows", 2, 12, 4096, 4096, False, (4096, 0), 0, 0),
    ("ragged", 2, 12, 1000, 2999, True, (2999, 2000), 300, 0),
)
# flash kernel vs plain on the same inputs, max |diff| over the largest
# |plain| of each output (m and lse over live rows); dead rows must be
# exactly o = 0, m = NEG_INF, l = 0.  f32: sum order and the three TF32
# passes (read at most 7.0e-6 at D = 64 and 1.3e-5 at D = 256 over the six
# cases on the H100; the CUDA-core kernels before them 3.1e-6); bf16: p is rounded to bf16
# against the running max in the kernel and against the final max in the
# plain version (o read 2.3e-3), out is bf16 itself (one ulp is 3.9e-3 of
# the largest entry; read 5.8e-3), p and ds round to bf16 before the
# backward's products (read 1.3e-3).
FLASH_TOL = {"float32": {"o": 2e-5, "m": 1e-5, "l": 1e-5, "out": 2e-5, "lse": 1e-5,
                         "dq": 2e-5, "dk": 2e-5, "dv": 2e-5},
             "bfloat16": {"o": 1e-2, "m": 1e-5, "l": 1e-5, "out": 1.6e-2, "lse": 1e-5,
                          "dq": 1e-2, "dk": 1e-2, "dv": 1e-2}}
# the check must see a fault: with the lse shift dropped from p, the plain
# backward's dq, dk and dv move by at least this many times their limits;
# with delta dropped from ds, dq and dk do in f32 (in bf16 a dropped delta
# moves dq by a few percent, within reach of the bf16 limit: it is read,
# not gated); and in f32 one TF32 pass in place of three (q, k, v and dout
# cut to TF32) moves each of o, dq, dk and dv (read 44-412x on the H100)
FLASH_FAULT_MARGIN = 10
# head dims besides BERT-base's 64, each with BERT-base's width 768 where it
# divides it: (head dim, heads, cases); 80 runs through the zero-padding, 192
# and 256 in column slabs (192 padded to 256)
FLASH_WIDE_CASES = ("base", "key_mask", "causal_offsets", "dead_rows")
FLASH_HEAD_DIMS = ((32, 24, None), (128, 6, None), (80, 12, ("base",)),
                   (256, 3, FLASH_WIDE_CASES), (192, 4, FLASH_WIDE_CASES))
# long sequences, no mask, (2, 12, T, 64): (T, dtypes)
LONG_SEQS = ((16384, ("float32", "bfloat16")), (32768, ("bfloat16",)))
BERT_SEQ, BERT_BATCH = 4096, 2
# 2-layer BERT at BERT-base's width with 6, 24 and 3 heads (head dims 128, 32
# and 256)
BERT_HEADS = (6, 24, 3)
# serving through the kernels vs through the plain versions, max |diff| of
# log-softmax over the 30522-word vocab, 12 layers at seq 4096, as read on
# the H100: f32 4.8e-6 (sum order); bf16 2.5e-2 (the two attentions'
# bf16 roundings differ, and 12 bf16 layers carry the difference on)
BERT_SERVE_TOL = {"float32": 5e-5, "bfloat16": 1e-1}
BERT_TRAIN_LAYERS, BERT_TRAIN_LR, BERT_TRAIN_STEPS = 4, 2e-5, 3
# fine-tuning through the kernels vs through the plain versions, f32, TF32
# off, one start, the same dropout masks, as read on the H100: step-0 loss
# relative (read 9.1e-8); every param's step-0 update, |u_kernel - u_plain|
# / |u_plain| in norm (read at most 3.2e-4, median 5.9e-6; Adam's first
# update is -lr g/(|g|+eps), which keeps each gradient's sign); later
# losses relative (read 0).  The attention key biases are left out of the
# update check: softmax is shift-invariant in each row's scores, so their
# gradient is exactly zero and their Adam updates are rounding noise in
# both runs; they are held to |u| <= lr.
BERT_LOSS0_TOL, BERT_UPDATE_TOL, BERT_LOSS_TOL = 1e-5, 5e-3, 1e-5


def flash_inputs(case, dtype, gen, d: int = 64):
    import torch
    name, b, h, tq, tk, causal, lengths, qo, ko = case
    q = torch.randn(b, h, tq, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, h, tk, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, h, tk, d, device="cuda", generator=gen).to(dtype)
    dout = torch.randn(b, h, tq, d, device="cuda", generator=gen).to(dtype)
    mask = None
    if lengths is not None:
        mask = (torch.arange(tk, device="cuda")[None, :]
                < torch.tensor(lengths, device="cuda")[:, None]).float()
    return q, k, v, dout, mask, dict(scale=d ** -0.5, causal=causal, key_mask=mask,
                                     q_offset=qo, k_offset=ko)


def rel_max(got, want, rows=None) -> float:
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    if want.numel() == 0:
        return 0.0
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def library_attention(q, k, v, kw):
    """Yardstick only, never on the port's path: PyTorch's fused
    scaled_dot_product_attention with the same visibility as a bool mask."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    mask = None
    if kw["key_mask"] is not None or kw["causal"]:
        mask = fa._visible(q.shape[0], q.shape[2], k.shape[2], q.device, kw["causal"],
                           kw["key_mask"], kw["q_offset"], kw["k_offset"])
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=kw["scale"])


def check_flash(dtypes, d: int = 64, heads: int | None = None,
                cases=FLASH_CASES) -> list[dict]:
    """Both flash kernels and the two-kernel backward against their plain
    versions at every case, in each dtype, at head dim ``d`` (``heads``
    in place of each case's H), with a planted fault; the two backward
    forms against each other; times each kernel, the plain version and
    the library yardstick."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    # D = 64 keeps the stream its earlier rows were read on
    gen = torch.Generator(device="cuda").manual_seed(FLASH_SEED + d - 64)
    rows = []
    for dtype in dtypes:
        dname = str(dtype).split(".")[1]
        tol = FLASH_TOL[dname]
        for case in cases:
            if heads is not None:
                case = (*case[:2], heads, *case[3:])
            name, b, h, tq, tk = case[:5]
            q, k, v, dout, mask, kw = flash_inputs(case, dtype, gen, d)
            o, m, l = fa.flash_attention_block(q, k, v, **kw)
            torch.cuda.synchronize()
            oe, me, le = fa.flash_attention_block_plain(q, k, v, **kw)
            dead, live = le == 0, le > 0
            if name == "dead_rows" and not dead.any():
                raise AssertionError("flash dead_rows case has no dead row")
            if not (bool((o[dead] == 0).all()) and bool((l[dead] == 0).all())
                    and bool((m[dead] == fa.NEG_INF).all()) and bool((l[live] > 0).all())):
                raise AssertionError(f"flash {dname} {name}: dead rows are not o=0, m=NEG_INF, l=0")
            errs = {"o": rel_max(o, oe), "m": rel_max(m, me, live), "l": rel_max(l, le)}
            out, lse = fa._forward(q, k, v, mask, kw["scale"], kw["causal"], kw["q_offset"],
                                   kw["k_offset"], normalize=True)
            oute = (oe / torch.clamp(le[..., None], min=1e-20)).to(dtype)
            lsee = fa.flash_lse(me, le)
            errs |= {"out": rel_max(out, oute), "lse": rel_max(lse, lsee, live)}
            # planted fault (f32): one TF32 pass, the plain versions on q, k, v
            # and dout cut to TF32 as the tensor core reads f32 words
            one_pass, cut = {}, None
            if dname == "float32":
                cut = [fa.tf32_cut(x) for x in (q, k, v, dout)]
                one_pass["o"] = rel_max(fa.flash_attention_block_plain(*cut[:3], **kw)[0],
                                        oe) / tol["o"]
            del o, m, l, oe, me, le
            got = fa.flash_attention_block_bwd(q, k, v, oute, lsee, dout, **kw)
            split = fa.flash_attention_block_bwd(q, k, v, oute, lsee, dout, merged=False, **kw)
            torch.cuda.synchronize()
            want = fa.flash_attention_block_bwd_plain(q, k, v, oute, lsee, dout, **kw)
            for key, g, sp, w in zip(("dq", "dk", "dv"), got, split, want):
                errs[key] = rel_max(g, w)
                errs[f"split_{key}"] = rel_max(sp, w)
            bad = {key: e for key, e in errs.items() if not e <= tol[key.split("_")[-1]]}
            # the two forms on the same inputs, within the same limits
            vs_merged = {key: rel_max(sp, g) for key, sp, g in zip(("dq", "dk", "dv"), split, got)}
            bad |= {f"split vs merged {key}": e for key, e in vs_merged.items()
                    if not e <= tol[key]}
            if bad:
                raise AssertionError(f"flash {dname} {name} D={d}: errors {bad} over {tol}")
            # planted faults: the lse shift dropped (lse = 0), delta dropped (out = 0)
            faults = {}
            for fault, fargs in (("lse", (oute, torch.zeros_like(lsee))),
                                 ("delta", (torch.zeros_like(oute), lsee))):
                moved = fa.flash_attention_block_bwd_plain(q, k, v, *fargs, dout, **kw)
                for key, g, w in zip(("dq", "dk", "dv"), moved, want):
                    faults[f"{fault} dropped: {key}"] = rel_max(g, w) / tol[key]
                del moved
            gated = [v for key, v in faults.items() if key.startswith("lse")
                     or (dname == "float32" and key[-2:] in ("dq", "dk"))]
            if not min(gated) >= FLASH_FAULT_MARGIN:
                raise AssertionError(f"flash {dname} {name}: a planted fault moves the check "
                                     f"by only {faults} times its limit")
            if cut is not None:
                # one TF32 pass in either backward form: both are held to the
                # same plain dq, dk, dv at the same limits
                moved = fa.flash_attention_block_bwd_plain(*cut[:3], oute, lsee, cut[3], **kw)
                for key, g, w in zip(("dq", "dk", "dv"), moved, want):
                    one_pass[key] = one_pass[f"split_{key}"] = rel_max(g, w) / tol[key]
                del moved, cut
                if not min(one_pass.values()) >= FLASH_FAULT_MARGIN:
                    raise AssertionError(f"flash {dname} {name} D={d}: one TF32 pass moves the "
                                         f"check by only {one_pass} times its limit")
            if name == "base":
                # both forms give the same bits on a second run (a fixed order of
                # every sum, no free-running atomics)
                for form, first in (("merged", got), ("split", split)):
                    again = fa.flash_attention_block_bwd(q, k, v, oute, lsee, dout,
                                                         merged=form == "merged", **kw)
                    if not all(bool(torch.equal(x, y)) for x, y in zip(first, again)):
                        raise AssertionError(f"flash {dname} D={d}: the {form} backward gave "
                                             f"other bits on a second run")
                    del again
            bwd_abs = max((g - w).abs().max().item() for g, w in zip(got, want))
            split_abs = max((g - w).abs().max().item() for g, w in zip(split, want))
            del got, split, want
            # the work these inputs need: visible (query, key) pairs
            vis = fa._visible(b, tq, tk, q.device, kw["causal"], mask, kw["q_offset"],
                              kw["k_offset"])
            pairs = int(vis.expand(b, 1, tq, tk).sum().item()) * h
            isz = q.element_size()
            fwd_bytes = (2 * b * h * tq * d + 2 * b * h * tk * d) * isz + b * h * tq * 4 \
                + (b * tk * 4 if mask is not None else 0)
            bwd_bytes = ((3 * b * h * tq * d + 2 * b * h * tk * d) * isz + b * h * tq * 4
                         + (b * h * tq * d + 2 * b * h * tk * d) * 4
                         + (b * tk * 4 if mask is not None else 0))
            args = (q, k, v, mask, kw["scale"], kw["causal"], kw["q_offset"], kw["k_offset"])
            # every kernel runs on the tensor cores, f32 in three TF32 passes
            tensor_peak = PEAK_F32_TF32X3 if dname == "float32" else PEAK_FLOPS[dname]
            ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
            lib_out = library_attention(ql, kl, vl, kw)
            row = {"case": name, "dtype": dname, "B": b, "H": h, "Tq": tq, "Tk": tk, "D": d,
                   "causal": kw["causal"], "q_offset": kw["q_offset"],
                   "k_offset": kw["k_offset"], "visible_pairs": pairs, "rel_err": errs,
                   "split_vs_merged": vs_merged,
                   "fault_over_limit": faults, "fault_over_limit_min": min(gated),
                   "one_pass_tf32_over_limit": one_pass,
                   "second_run_bits_checked": name == "base",
                   "max_abs_err": (out.float() - oute.float()).abs().max().item(),
                   "bwd_max_abs_err": bwd_abs, "split_max_abs_err": split_abs,
                   "ms": cuda_ms(lambda: fa._forward(*args, normalize=True), reps=5),
                   "plain_ms": cuda_ms(lambda: fa.normalized_plain(*args[:6]), reps=3),
                   "library_ms": cuda_ms(lambda: library_attention(q, k, v, kw), reps=5),
                   "bytes_ms": fwd_bytes / PEAK_BYTES * 1e3,
                   "ops_ms": 4 * d * pairs / tensor_peak * 1e3,
                   "fma_ops_ms": 4 * d * pairs / PEAK_FLOPS[dname] * 1e3,
                   "bwd_ms": cuda_ms(lambda: fa.flash_attention_block_bwd(
                       q, k, v, oute, lsee, dout, **kw), reps=5),
                   "bwd_plain_ms": cuda_ms(lambda: fa.flash_attention_block_bwd_plain(
                       q, k, v, oute, lsee, dout, **kw), reps=3),
                   "bwd_library_ms": cuda_ms(lambda: torch.autograd.grad(
                       lib_out, (ql, kl, vl), dout, retain_graph=True), reps=5),
                   "bwd_bytes_ms": bwd_bytes / PEAK_BYTES * 1e3,
                   "bwd_ops_ms": 10 * d * pairs / tensor_peak * 1e3,
                   "bwd_fma_ops_ms": 10 * d * pairs / PEAK_FLOPS[dname] * 1e3,
                   "split_ms": cuda_ms(lambda: fa.flash_attention_block_bwd(
                       q, k, v, oute, lsee, dout, merged=False, **kw), reps=5),
                   "split_bytes_ms": bwd_bytes / PEAK_BYTES * 1e3,
                   # the function's five products, as the merged form's; the
                   # split algorithm does seven (s and dp in both kernels)
                   "split_ops_ms": 10 * d * pairs / tensor_peak * 1e3,
                   "split_fma_ops_ms": 10 * d * pairs / PEAK_FLOPS[dname] * 1e3,
                   "split_algo_ops_ms": 14 * d * pairs / tensor_peak * 1e3}
            # one plain version and one yardstick serve both backward forms
            row["split_plain_ms"], row["split_library_ms"] = row["bwd_plain_ms"], \
                row["bwd_library_ms"]
            for prefix in ("", "bwd_", "split_"):
                row[f"{prefix}bound_ms"] = max(row[f"{prefix}bytes_ms"], row[f"{prefix}ops_ms"])
            rows.append(row)
            log(f"  {dname:8s} {name:14s} B={b} H={h} Tq={tq} Tk={tk} D={d}: fwd kernel "
                f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f}, library "
                f"{row['library_ms']:.3f}, bound {row['bound_ms']:.3f} (FMA "
                f"{row['fma_ops_ms']:.3f}); bwd kernel "
                f"{row['bwd_ms']:.3f} ms, split {row['split_ms']:.3f}, plain "
                f"{row['bwd_plain_ms']:.3f}, library {row['bwd_library_ms']:.3f}, bound "
                f"{row['bwd_bound_ms']:.3f} (FMA {row['bwd_fma_ops_ms']:.3f}; the split "
                f"{row['split_bound_ms']:.3f}, its seven products "
                f"{row['split_algo_ops_ms']:.3f}); rel err "
                + " ".join(f"{key} {e:.1e}" for key, e in errs.items())
                + "; split vs merged " + " ".join(f"{key} {e:.1e}" for key, e in vs_merged.items())
                + f"; a planted fault reads >= {row['fault_over_limit_min']:.0f}x the limit"
                + ("; one TF32 pass reads " + " ".join(f"{k} {v:.0f}x" for k, v in one_pass.items()
                                                       if not k.startswith("split_"))
                   + " (either backward form)" if one_pass else ""))
            del q, k, v, dout, oute, lsee, ql, kl, vl, lib_out
            torch.cuda.empty_cache()
    return rows


def split_main_path() -> dict:
    """The two-kernel backward's path: one call of the public
    ``flash_attention_block_bwd(merged=False)`` at BERT-base's attention
    shape in bf16, with every flash count set to 0 just before it and read
    just after: its two kernels, and nothing else."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(FLASH_SEED)
    q, k, v, dout, mask, kw = flash_inputs(FLASH_CASES[0], torch.bfloat16, gen)
    out, lse = fa._forward(q, k, v, mask, kw["scale"], kw["causal"], 0, 0, normalize=True)
    torch.cuda.synchronize()
    fa.launches = fa.bwd_launches = fa.split_launches = 0
    dq, dk, dv = fa.flash_attention_block_bwd(q, k, v, out, lse, dout, merged=False, **kw)
    torch.cuda.synchronize()
    counts = (fa.launches, fa.bwd_launches, fa.split_launches)
    if counts != (0, 0, 2):
        raise AssertionError(f"the split backward's path launched (forward, merged, split) "
                             f"{counts}, not (0, 0, 2)")
    if not all(bool(torch.isfinite(g).all()) and g.shape == t.shape
               for g, t in ((dq, q), (dk, k), (dv, v))):
        raise AssertionError("the split backward's gradients are non-finite or misshapen")
    return {"launches": counts[2]}


def flash_long(card: str) -> list[dict]:
    """Both backward forms at long sequences, no mask: time and peak
    memory of each, split against merged on all heads, and the split
    against the plain version on two (batch, head) slices, whose [T, T]
    scores take 1 GB per head in f32 at 16384.  Where the merged form's
    scratch would not fit the card, it is not run: its size is printed."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(FLASH_SEED + 1)
    total = torch.cuda.mem_get_info()[1]
    rows = []
    for t, dnames in LONG_SEQS:
        for dname in dnames:
            dtype = getattr(torch, dname)
            tol = FLASH_TOL[dname]
            case = ("long", BERT_BATCH, 12, t, t, False, None, 0, 0)
            q, k, v, dout, mask, kw = flash_inputs(case, dtype, gen)
            out, lse = fa._forward(q, k, v, None, kw["scale"], False, 0, 0, normalize=True)
            torch.cuda.synchronize()
            b, h, d = BERT_BATCH, 12, 64
            scratch = fa.merged_scratch_bytes(b, h, t, d)   # beside dq: the ordered sum's flags
            row = {"dtype": dname, "B": b, "H": h, "T": t, "D": d, "card": card,
                   "merged_scratch_bytes": scratch}
            runs = {}
            for form, merged in (("split", False), ("merged", True)):
                if merged and scratch > 0.8 * total:
                    continue
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                runs[form] = fa.flash_attention_block_bwd(q, k, v, out, lse, dout,
                                                          merged=merged, **kw)
                torch.cuda.synchronize()
                row[f"{form}_peak_bytes"] = torch.cuda.max_memory_allocated()
                row[f"{form}_extra_bytes"] = torch.cuda.max_memory_allocated() - before
                row[f"{form}_ms"] = cuda_ms(lambda: fa.flash_attention_block_bwd(
                    q, k, v, out, lse, dout, merged=merged, **kw), reps=2, warmup=1)
            errs = {}
            if "merged" in runs:
                errs |= {f"split vs merged {key}": rel_max(sp, g)
                         for key, sp, g in zip(("dq", "dk", "dv"), runs["split"], runs["merged"])}
            runs.pop("merged", None)
            torch.cuda.empty_cache()
            for bi, hi in ((0, 0), (b - 1, h - 1)):
                sl = lambda x: x[bi:bi + 1, hi:hi + 1]   # noqa: E731
                want = fa.flash_attention_block_bwd_plain(sl(q), sl(k), sl(v), sl(out), sl(lse),
                                                          sl(dout), **kw)
                for key, g, w in zip(("dq", "dk", "dv"), runs["split"], want):
                    errs[f"split vs plain ({bi}, {hi}) {key}"] = rel_max(sl(g), w)
                del want
                torch.cuda.empty_cache()
            bad = {key: e for key, e in errs.items() if not e <= tol[key[-2:]]}
            if bad:
                raise AssertionError(f"flash long {dname} T={t}: errors {bad} over {tol}")
            row["rel_err"] = errs
            rows.append(row)
            merged_text = (f"merged {row['merged_ms']:.1f} ms, peak "
                           f"{row['merged_peak_bytes'] / 1e9:.2f} GB "
                           f"({row['merged_extra_bytes'] / 1e9:.2f} GB over the inputs; "
                           f"{scratch} bytes of scratch beside dq)"
                           if "merged_ms" in row else
                           f"merged not run: its scratch alone would take "
                           f"{scratch / 1e9:.1f} GB of the card's {total / 1e9:.1f} GB")
            log(f"  {dname:8s} (B, H, T, D) = ({b}, {h}, {t}, {d}) on {card}: split "
                f"{row['split_ms']:.1f} ms, peak {row['split_peak_bytes'] / 1e9:.2f} GB "
                f"({row['split_extra_bytes'] / 1e9:.2f} GB over the inputs); {merged_text}; "
                f"rel err " + " ".join(f"{key} {e:.1e}" for key, e in errs.items()))
            del q, k, v, dout, out, lse, runs
            torch.cuda.empty_cache()
    return rows


class plain_flash:
    """Comparison only, never on the port's path: inside the ``with``, the
    flash Function runs the plain forward and backward on the card."""

    def __enter__(self):
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        self.fa, self.saved = fa, (fa._forward, fa.flash_attention_block_bwd)
        fa._forward = lambda q, k, v, key_mask, scale, causal, qo, ko, *, normalize: \
            fa.normalized_plain(q, k, v, key_mask, scale, causal)
        fa.flash_attention_block_bwd = fa.flash_attention_block_bwd_plain
        return self

    def __exit__(self, *exc):
        self.fa._forward, self.fa.flash_attention_block_bwd = self.saved


def bert_config(layers: int, **changes):
    from deeplearning4j_tpu_torch.models import BertConfig
    import dataclasses
    return dataclasses.replace(BertConfig.base(), num_layers=layers, max_position=BERT_SEQ,
                               **changes)


def bert_serve(card: str, layers: int = 12, heads: int = 12) -> dict:
    """Phase: predict_mlm on BERT-base (``layers`` layers, ``heads`` heads)
    at seq 4096, f32 and bf16 policy, through the kernels and through the
    plain versions."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.models import BertForMaskedLM
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa

    model = BertForMaskedLM(bert_config(layers, use_flash=None, num_heads=heads), seed=0,
                            device="cuda")
    ids = np.random.default_rng(SEED + 11).integers(0, model.config.vocab_size,
                                                    (BERT_BATCH, BERT_SEQ))
    result = {"card": card, "batch": BERT_BATCH, "seq": BERT_SEQ, "layers": layers,
              "heads": heads, "head_dim": model.config.hidden_size // heads,
              "params": model.num_params()}
    try:
        for policy in ("f32", "bf16"):
            config.set_dtype_policy(getattr(config.DTypePolicy, policy)())
            dname = "float32" if policy == "f32" else "bfloat16"
            model.predict_mlm(ids)                       # warm-up
            torch.cuda.synchronize()
            fa.launches = fa.bwd_launches = 0
            t0 = time.perf_counter()
            logits = model.predict_mlm(ids)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fa.launches
            if launches != layers or fa.bwd_launches:
                raise AssertionError(f"BERT serve {policy}: {launches} forward flash launches "
                                     f"(and {fa.bwd_launches} backward) for one call, "
                                     f"not {layers}")
            if tuple(logits.shape) != (BERT_BATCH, BERT_SEQ, model.config.vocab_size) \
                    or logits.dtype != torch.float32 or not torch.isfinite(logits).all():
                raise AssertionError(f"BERT serve {policy}: logits {tuple(logits.shape)} "
                                     f"{logits.dtype} or non-finite")
            ms = cuda_ms(lambda: model.predict_mlm(ids), reps=3, warmup=0)
            fa.launches = 0
            with plain_flash():
                plain = model.predict_mlm(ids)
                plain_ms = cuda_ms(lambda: model.predict_mlm(ids), reps=2, warmup=0)
            if fa.launches:
                raise AssertionError("the plain serving run launched a flash kernel")
            err = (torch.log_softmax(logits, -1) - torch.log_softmax(plain, -1)).abs().max().item()
            if not err <= BERT_SERVE_TOL[dname]:
                raise AssertionError(f"BERT serve {policy}: kernel vs plain log-softmax differ "
                                     f"by {err} (limit {BERT_SERVE_TOL[dname]})")
            del logits, plain
            fa.launches = 0
            short = model.predict_mlm(ids[:, :512])
            if fa.launches != 0 or tuple(short.shape)[:2] != (BERT_BATCH, 512):
                raise AssertionError(f"BERT serve {policy} at seq 512 launched {fa.launches} "
                                     f"flash kernels (the einsum path takes it)")
            del short
            result[policy] = {"launches": launches, "first_call_s": wall, "ms": ms,
                              "tokens_per_s": BERT_BATCH * BERT_SEQ / ms * 1e3,
                              "plain_ms": plain_ms, "max_log_softmax_err": err}
            log(f"BERT-base serve {policy} on {card}: predict_mlm batch {BERT_BATCH} x "
                f"{BERT_SEQ}, {layers} layers, {heads} heads of {result['head_dim']}: "
                f"{ms:.1f} ms ({result[policy]['tokens_per_s']:.0f} "
                f"tokens/s), plain {plain_ms:.1f} ms; {launches} flash launches per call; "
                f"kernel vs plain log-softmax {err:.2e}; seq 512: 0 launches")
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    return result


class StepWatch:
    """A ``fit`` listener: per step, the seconds since the last step (host
    clock; ``fit`` reads the loss, which waits for the step), the flash
    launch counts (then set to 0), the loss, and after step 0 each
    param's update against ``p0``."""

    def __init__(self, p0=None):
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        self.fa, self.p0 = fa, p0
        self.seconds, self.launches, self.losses, self.update0 = [], [], [], None
        fa.launches = fa.bwd_launches = 0
        self.t0 = time.perf_counter()

    def iteration_done(self, model, iteration, epoch, score):
        from deeplearning4j_tpu_torch.train.updaters import tree_map
        now = time.perf_counter()
        self.seconds.append(now - self.t0)
        self.launches.append((self.fa.launches, self.fa.bwd_launches))
        self.losses.append(score)
        if iteration == 0 and self.p0 is not None:
            self.update0 = tree_map(lambda p, q: p - q, model.params, self.p0)
        self.fa.launches = self.fa.bwd_launches = 0
        self.t0 = time.perf_counter()


def bert_batch(vocab: int) -> dict:
    """bench.py's long-sequence batch: ids, labels and weights from
    ``default_rng(0)``, an all-ones attention mask."""
    import numpy as np
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (BERT_BATCH, BERT_SEQ))
    labels = rng.integers(0, vocab, (BERT_BATCH, BERT_SEQ))
    weights = (rng.random((BERT_BATCH, BERT_SEQ)) < 0.15).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "label_weights": weights,
            "attention_mask": np.ones((BERT_BATCH, BERT_SEQ), np.float32)}


def bert_finetune(card: str) -> dict:
    """Phase: bench.py's long-sequence fine-tune (4 layers of BERT-base,
    seq 4096, batch 2, bf16 policy, use_flash=True, Adam(2e-5)) through
    ``BertForMaskedLM.fit``: one warm-up step, then timed steps."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.models import BertForMaskedLM
    from deeplearning4j_tpu_torch.train import Adam

    config.set_dtype_policy(config.DTypePolicy.bf16())
    try:
        model = BertForMaskedLM(bert_config(BERT_TRAIN_LAYERS, use_flash=True), seed=0,
                                device="cuda")
        batch = bert_batch(model.config.vocab_size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        watch = StepWatch()
        model.fit([batch] * (1 + BERT_TRAIN_STEPS), updater=Adam(BERT_TRAIN_LR),
                  listeners=[watch])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    if any(c != (BERT_TRAIN_LAYERS, BERT_TRAIN_LAYERS) for c in watch.launches):
        raise AssertionError(f"BERT fine-tune launched (forward, backward) flash kernels "
                             f"{watch.launches} per step, not ({BERT_TRAIN_LAYERS}, "
                             f"{BERT_TRAIN_LAYERS})")
    if not all(np.isfinite(watch.losses)):
        raise AssertionError(f"BERT fine-tune losses {watch.losses}")
    step_s = float(np.mean(watch.seconds[1:]))
    result = {"card": card, "policy": "bf16", "layers": BERT_TRAIN_LAYERS, "seq": BERT_SEQ,
              "batch": BERT_BATCH, "updater": f"adam({BERT_TRAIN_LR})",
              "params": model.num_params(), "losses": watch.losses,
              "launches_per_step": watch.launches, "step_s": watch.seconds,
              "step_ms": step_s * 1e3, "tokens_per_s": BERT_BATCH * BERT_SEQ / step_s,
              "peak_memory_gib": peak}
    log(f"BERT fine-tune bf16 on {card}: {BERT_TRAIN_LAYERS} layers, batch {BERT_BATCH} x "
        f"{BERT_SEQ}: step {result['step_ms']:.1f} ms ({result['tokens_per_s']:.0f} tokens/s) "
        f"over {BERT_TRAIN_STEPS} steps after one warm-up; (forward, backward) flash launches "
        f"per step {watch.launches}; peak memory {peak:.1f} GiB; losses {watch.losses}")
    return result


def bert_train_check(card: str) -> dict:
    """Phase: the fine-tune in f32 (TF32 off) through the kernels and
    through the plain versions, from one set of weights, with the same
    dropout masks (fit seeds its generator from the model's seed)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models import BertForMaskedLM
    from deeplearning4j_tpu_torch.train import Adam
    from deeplearning4j_tpu_torch.train.updaters import tree_map

    cfg = bert_config(BERT_TRAIN_LAYERS, use_flash=True)
    runs = {}
    for name in ("kernel", "plain"):
        model = BertForMaskedLM(cfg, seed=0, device="cuda")
        batch = bert_batch(cfg.vocab_size)
        watch = StepWatch(tree_map(lambda p: p.clone(), model.params))
        if name == "plain":
            with plain_flash():
                model.fit([batch] * BERT_TRAIN_STEPS, updater=Adam(BERT_TRAIN_LR),
                          listeners=[watch])
        else:
            model.fit([batch] * BERT_TRAIN_STEPS, updater=Adam(BERT_TRAIN_LR), listeners=[watch])
        runs[name] = watch
        del model
    kernel, plain = runs["kernel"], runs["plain"]
    if any(c != (BERT_TRAIN_LAYERS, BERT_TRAIN_LAYERS) for c in kernel.launches):
        raise AssertionError(f"f32 fine-tune launched {kernel.launches} per step")
    if any(c != (0, 0) for c in plain.launches):
        raise AssertionError("the plain fine-tune launched a flash kernel")
    if not all(np.isfinite(kernel.losses + plain.losses)):
        raise AssertionError(f"non-finite loss: {kernel.losses} vs {plain.losses}")
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(kernel.losses, plain.losses)]
    if not loss_errs[0] <= BERT_LOSS0_TOL:
        raise AssertionError(f"BERT step-0 loss {kernel.losses[0]} vs plain {plain.losses[0]}")
    if not max(loss_errs[1:]) <= BERT_LOSS_TOL:
        raise AssertionError(f"BERT later losses {kernel.losses} vs plain {plain.losses}")
    errs, key_bias = bert_update_errs(kernel.update0, plain.update0)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    if not worst[0][1] <= BERT_UPDATE_TOL:
        raise AssertionError(f"BERT step-0 updates differ from the plain run's: {worst[:5]}")
    if not key_bias <= BERT_TRAIN_LR * (1 + 1e-6):
        raise AssertionError(f"a key bias moved by {key_bias}, past lr {BERT_TRAIN_LR}")
    result = {"card": card, "policy": "f32", "layers": BERT_TRAIN_LAYERS, "losses":
              kernel.losses, "plain_losses": plain.losses, "loss_rel_errs": loss_errs,
              "launches_per_step": kernel.launches, "update_rel_err_max": worst[0][1],
              "update_rel_err_worst": worst[:5],
              "update_rel_err_median": float(np.median(list(errs.values()))),
              "key_bias_update_max": key_bias,
              "step_ms": float(np.mean(kernel.seconds[1:])) * 1e3,
              "plain_step_ms": float(np.mean(plain.seconds[1:])) * 1e3}
    log(f"BERT fine-tune f32 kernel vs plain on {card}: losses {kernel.losses} (plain "
        f"{plain.losses}), step-0 loss rel err {loss_errs[0]:.2e}, update rel err max "
        f"{worst[0][1]:.2e} ({worst[0][0]}), median {result['update_rel_err_median']:.2e}; "
        f"step {result['step_ms']:.1f} ms, plain {result['plain_step_ms']:.1f} ms")
    return result


def bert_update_errs(got: dict, want: dict) -> tuple[dict, float]:
    """Per param but the attention key biases, |u_got - u_want| / |u_want|
    in norm; and the largest |u| of a key bias in either tree."""
    from deeplearning4j_tpu_torch.io.model_serializer import leaf_at, tree_paths
    errs, key_bias = {}, 0.0
    for path in tree_paths(want):
        ug, uw = leaf_at(got, path), leaf_at(want, path)
        if path[-2:] == ("key", "bias"):
            key_bias = max(key_bias, ug.abs().max().item(), uw.abs().max().item())
            continue
        errs["/".join(path)] = ((ug - uw).norm() / uw.norm().clamp_min(1e-30)).item()
    return errs, key_bias


# ------------------------------------------------------------ VGG-16 int8
INT8_SEED = SEED + 20
# (name, K, N) of every int8_matmul call: VGG-16's three dense layers and
# bench/serving.py's bench_quantized MLP (hidden and output layers)
INT8_SHAPES = (("vgg16_fc6", 25088, 4096), ("vgg16_fc7", 4096, 4096), ("vgg16_fc8", 4096, 1000),
               ("mlp_hidden", 1024, 1024), ("mlp_out", 1024, 10))
# every bucket the engine pads a batch to at max_batch 32 (each picks its own
# template of the kernel by M), and 7 for ragged rows
INT8_BATCHES = (1, 2, 4, 7, 8, 16, 32)
# int8 kernel vs int8_matmul_plain on the same inputs: both sum in f32 and
# differ in order only.  f32: max |diff| within 1e-5 of the largest |y|;
# bf16: each entry within one bf16 ulp of its own size, |diff| <= 2^-7 |y| +
# 1e-6 max |y| (the two f32 sums may round to neighbouring bf16 values).
INT8_F32_TOL = 1e-5
# a planted fault (scale dropped, or the last K split skipped) must move the
# plain version's result this many times past the limit
INT8_FAULT_MARGIN = 10
VGG_BATCH, VGG_REQUESTS, VGG_CALIB = 32, 16, (2, 32)   # calibration: 2 batches of 32
# VGG-16 forward through the kernel vs the same qnet with its dense products
# exact (f64, rounded once to the layer's dtype), max |diff| of log
# probabilities.  f32 (TF32 off): the kernel's f32 sum order only, held at
# the 1e-5 of the ResNet and BERT checks.  The plain version is held to the
# kernel too, and its gap to the exact product is printed: cuBLAS's f32 sum
# reads 1e-6 of max |y| at fc6's K = 25088 against the kernel's 2e-7 (phase
# 15 prints both), and the seeded VGG-16's large logits (top probability
# ~0.92, log probabilities down to ~-39) carry that to 2.5e-5 (read on the
# H100), so kernel vs plain is held at 1e-4.  bf16: a dense output may round
# to the neighbouring bf16 value in one of the two, and fc8's bf16 logits (|z|
# in [32, 64) have a bf16 ulp of 0.25) carry that to the log probabilities:
# one such ulp; against the exact product it is printed only.
VGG_EXACT_TOL = 1e-5
VGG_PLAIN_TOL = {"float32": 1e-4, "bfloat16": 0.25}
# engine answer vs qnet.output of the batch it was served in (the same images
# at the same rows, the same bucket, so the same convolution algorithms and
# the same kernels): equal.  Against the request's images alone the reading
# is printed only: cuDNN picks its algorithms by batch size, and in bf16 two
# algorithms may round an fc8 logit to neighbouring values (read 0.2513 in
# log probabilities, one ulp of a logit in [32, 64)).
VGG_SERVE_TOL = 0.0


def int8_over_limit(y, ye, dname: str) -> float:
    """max over entries of |y - ye| over that entry's limit (f32: 1e-5 max
    |ye|; bf16: 2^-7 |ye| + 1e-6 max |ye|); at most 1 passes."""
    yf, ef = y.float(), ye.float()
    big = ef.abs().max()
    lim = INT8_F32_TOL * big if dname == "float32" else 2.0 ** -7 * ef.abs() + 1e-6 * big
    return ((yf - ef).abs() / lim.clamp_min(1e-30)).max().item()


def cold_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device ms of ``fn`` with the 50 MB L2 flushed before each call
    (a serving forward finds its dense weights cold): CUDA events around
    each call alone."""
    import torch
    # 512 MB: its zeroing also keeps the card busy while the host enqueues the call
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start, end = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def library_int8_matmul(x, w_q, scale):
    """Yardstick only, never on the port's path: the weight widened to x's
    dtype, torch.matmul (cuBLAS), the scale as a torch op."""
    import torch
    return (torch.matmul(x, w_q.to(x.dtype)) * scale).to(x.dtype)


def check_int8(dtypes) -> list[dict]:
    """Phase: the int8 kernel against its plain version at every shape and
    batch, in each dtype, with the planted faults (f32: one TF32 pass in
    place of its three, too) and a second call that must give the same
    bits; times the kernel, the plain version and the library yardstick, L2
    cold.  The f32 bound is three TF32 passes' (the kernel's design), the
    CUDA cores' beside it."""
    import torch
    from deeplearning4j_tpu_torch.nn.quantize import quantize_weight
    from deeplearning4j_tpu_torch.ops.kernels import quant_matmul as qm
    from deeplearning4j_tpu_torch.ops.kernels.flash_attention import tf32_split
    gen = torch.Generator(device="cuda").manual_seed(INT8_SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for name, k, n in INT8_SHAPES:
        w_q, scale = quantize_weight(torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5)
        for dtype in dtypes:
            dname = str(dtype).split(".")[1]
            splits, per = qm.k_splits(k, n, sms, qm.TILE_N[dtype])
            for m in INT8_BATCHES:
                x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
                y = qm.int8_matmul(x, w_q, scale)
                torch.cuda.synchronize()
                ye = qm.int8_matmul_plain(x, w_q, scale)
                over = int8_over_limit(y, ye, dname)
                if y.dtype != dtype or tuple(y.shape) != (m, n) or not over <= 1.0:
                    raise AssertionError(f"int8_matmul {dname} {name} M={m}: {over:.3g} times "
                                         f"the limit ({y.dtype}, {tuple(y.shape)})")
                skipped = x.clone()
                skipped[:, (splits - 1) * per:] = 0
                faults = {"scale dropped": int8_over_limit(
                              qm.int8_matmul_plain(x, w_q, torch.ones_like(scale)), ye, dname),
                          "last K split skipped": int8_over_limit(
                              qm.int8_matmul_plain(skipped, w_q, scale), ye, dname)}
                if dname == "float32":
                    faults["one TF32 pass"] = int8_over_limit(
                        qm.int8_matmul_plain(tf32_split(x)[0], w_q, scale), ye, dname)
                if not min(faults.values()) >= INT8_FAULT_MARGIN:
                    raise AssertionError(f"int8_matmul {dname} {name} M={m}: a planted fault "
                                         f"moves the check by only {faults} times its limit")
                if not torch.equal(qm.int8_matmul(x, w_q, scale), y):
                    raise AssertionError(f"int8_matmul {dname} {name} M={m}: a second call gave "
                                         f"other bits")
                # reading only: both f32 sums against the f64 product, over max |y|
                exact = (x.double() @ w_q.double()) * scale.double()
                f64_err = {key: ((v.double() - exact).abs().max() / exact.abs().max()).item()
                           for key, v in (("kernel", y), ("plain", ye))}
                isz = x.element_size()
                nbytes = k * n + (m * k + m * n) * isz + 4 * n
                flops = 2 * m * k * n
                peak = PEAK_F32_TF32X3 if dname == "float32" else PEAK_FLOPS[dname]
                row = {"shape": name, "dtype": dname, "M": m, "K": k, "N": n, "splits": splits,
                       "second_call_bits_equal": True,
                       "max_abs_err": (y.float() - ye.float()).abs().max().item(),
                       "f64_rel_err": f64_err,
                       "over_limit": over, "fault_over_limit": faults,
                       "fault_over_limit_min": min(faults.values()),
                       "ms": cold_ms(lambda: qm.int8_matmul(x, w_q, scale)),
                       "plain_ms": cold_ms(lambda: qm.int8_matmul_plain(x, w_q, scale)),
                       "library_ms": cold_ms(lambda: library_int8_matmul(x, w_q, scale)),
                       "bytes_ms": nbytes / PEAK_BYTES * 1e3,
                       "ops_ms": flops / peak * 1e3,
                       "fma_ops_ms": flops / PEAK_FLOPS[dname] * 1e3}
                row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
                row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
                rows.append(row)
                log(f"  {dname:8s} {name:10s} M={m:2d} K={k:5d} N={n:4d} splits={splits:2d}: "
                    f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, library "
                    f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} ({row['bound_by']}; FMA "
                    f"{max(row['bytes_ms'], row['fma_ops_ms']):.4f}), second call same bits; "
                    f"error {over:.2f} of the limit (against f64: kernel "
                    f"{f64_err['kernel']:.1e}, plain {f64_err['plain']:.1e}); a planted fault reads >= "
                    f"{row['fault_over_limit_min']:.0f}x the limit")
                del x, y, ye, skipped, exact
        del w_q, scale
    return rows


def served_at(served, images) -> tuple[int, int]:
    """(dispatch, row) at which ``images`` sit, whole, in the recorded
    batches."""
    import torch
    n = images.shape[0]
    for d, xb in enumerate(served):
        for o in range(xb.shape[0] - n + 1):
            if torch.equal(xb[o], images[0]) and torch.equal(xb[o:o + n], images):
                return d, o
    raise AssertionError("a request's images were not served in any batch")


def exact_int8_matmul(x, w_q, scale):
    """Comparison only: the dequant-matmul in f64, rounded once to x's
    dtype."""
    return ((x.double() @ w_q.double()) * scale.double()).to(x.dtype)


class int8_swapped:
    """Comparison only, never on the port's path: inside the ``with``, the
    quantized dense layers run ``fn`` (int8_matmul_plain or
    exact_int8_matmul) in place of the kernel."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from deeplearning4j_tpu_torch.ops.kernels import quant_matmul as qm
        self.qm, self.saved = qm, qm.int8_matmul
        qm.int8_matmul = self.fn
        return self

    def __exit__(self, *exc):
        self.qm.int8_matmul = self.saved


def int8_forward_check(qnet, x, dname: str) -> dict:
    """The whole forward at batch 32 through the kernel (3 launches),
    through the plain version and through the exact product (none), in log
    probabilities; times the first two."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import quant_matmul as qm
    qnet.output(x)                                 # warm-up
    torch.cuda.synchronize()
    qm.launches = 0
    y_kernel = qnet.output(x)
    torch.cuda.synchronize()
    launches = qm.launches
    if launches != 3:
        raise AssertionError(f"VGG-16 {dname} forward launched int8_matmul {launches} "
                             f"times, not 3")
    ms = cuda_ms(lambda: qnet.output(x), reps=5)
    qm.launches = 0
    with int8_swapped(qm.int8_matmul_plain):
        y_plain = qnet.output(x)
        plain_ms = cuda_ms(lambda: qnet.output(x), reps=5)
    with int8_swapped(exact_int8_matmul):
        y_exact = qnet.output(x)
    torch.cuda.synchronize()
    if qm.launches:
        raise AssertionError("the plain or exact int8 forward launched the kernel")
    if not (torch.isfinite(y_kernel.float()).all() and tuple(y_kernel.shape) == (len(x), 1000)):
        raise AssertionError(f"VGG-16 {dname} int8 forward: {tuple(y_kernel.shape)} or non-finite")
    err = log_prob_err(y_kernel.float(), y_plain.float())
    exact_err = {key: log_prob_err(y.float(), y_exact.float())
                 for key, y in (("kernel", y_kernel), ("plain", y_plain))}
    log(f"  {dname}: kernel vs plain {err:.3g} in log probabilities; vs the exact product: "
        f"kernel {exact_err['kernel']:.3g}, plain {exact_err['plain']:.3g}; log probabilities "
        f"reach {y_exact.float().log().min().item():.1f}")
    if not err <= VGG_PLAIN_TOL[dname]:
        raise AssertionError(f"VGG-16 {dname}: kernel vs plain forward differ by {err} in log "
                             f"probabilities (limit {VGG_PLAIN_TOL[dname]})")
    if dname == "float32" and not exact_err["kernel"] <= VGG_EXACT_TOL:
        raise AssertionError(f"VGG-16 f32: the kernel's forward differs from the exact "
                             f"product's by {exact_err['kernel']} in log probabilities "
                             f"(limit {VGG_EXACT_TOL})")
    return {"ms": ms, "plain_ms": plain_ms, "images_per_s": len(x) / ms * 1e3,
            "kernel_vs_plain_log_prob_err": err,
            "kernel_vs_exact_log_prob_err": exact_err["kernel"],
            "plain_vs_exact_log_prob_err": exact_err["plain"], "launches_per_forward": launches}


def vgg_serve(card: str) -> dict:
    """Phase: full-width VGG-16 under bench_quantized's serving policy (bf16
    params, compute and outputs), quantized by quantize_net with two
    seeded calibration batches, served through InferenceEngine; then the
    same qnet under the f32 policy, kernel against plain."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.models import vgg16
    from deeplearning4j_tpu_torch.nn.quantize import quantize_net
    from deeplearning4j_tpu_torch.ops.kernels import quant_matmul as qm
    from deeplearning4j_tpu_torch.serve import InferenceEngine

    rng = np.random.default_rng(INT8_SEED)
    sizes = [int(s) for s in rng.integers(1, VGG_BATCH + 1, size=VGG_REQUESTS)]
    images = rng.normal(size=(sum(sizes), 224, 224, 3)).astype(np.float32)
    offsets = np.cumsum([0] + sizes)
    requests = [images[offsets[i]:offsets[i + 1]] for i in range(len(sizes))]
    calib = [rng.normal(size=(VGG_CALIB[1], 224, 224, 3)).astype(np.float32)
             for _ in range(VGG_CALIB[0])]
    config.set_dtype_policy(config.DTypePolicy(param_dtype=torch.bfloat16,
                                               compute_dtype=torch.bfloat16,
                                               output_dtype=torch.bfloat16))
    try:
        net = vgg16(device="cuda").init(seed=SEED)
        qnet = quantize_net(net, calibration=calib)
        report = qnet.quantization_
        x = torch.from_numpy(images[:VGG_BATCH]).cuda()
        fp = net.output(x).float()
        top = fp.max(dim=1).values
        entropy = -(fp * fp.clamp_min(1e-30).log()).sum(dim=1)
        fp_ms = cuda_ms(lambda: net.output(x), reps=5)

        # comparison only: record the batch of every dispatch, so that each
        # answer can be held to qnet.output of the very batch it was served in
        served, forward = [], qnet._forward

        def recording(params, state, xb, **kw):
            served.append(xb.clone())
            return forward(params, state, xb, **kw)

        answers = {}
        qm.launches = 0
        qnet._forward = recording
        engine = InferenceEngine(qnet, max_batch=VGG_BATCH, max_latency_ms=5.0)
        try:
            def client(ids):
                for i in ids:
                    answers[i] = engine.predict(requests[i], timeout_s=300)

            threads = [threading.Thread(target=client, args=(list(range(j, len(sizes), 4)),))
                       for j in range(4)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            if any(t.is_alive() for t in threads):
                raise AssertionError("VGG-16 serving clients did not finish")
        finally:
            engine.shutdown()
            del qnet._forward
        launches, batches = qm.launches, engine.batches
        if engine.precision != "int8" or len(answers) != len(sizes):
            raise AssertionError(f"engine precision {engine.precision!r}, {len(answers)} of "
                                 f"{len(sizes)} requests answered")
        if launches != 3 * batches or batches != len(served) or batches == 0:
            raise AssertionError(f"int8_matmul launched {launches} times for {batches} batches")

        direct = [qnet.output(xb).float().cpu() for xb in served]
        serve_err = alone_err = band_err = 0.0
        for i, req in enumerate(requests):
            a = torch.from_numpy(answers[i])
            if tuple(a.shape) != (sizes[i], 1000) or not torch.isfinite(a).all():
                raise AssertionError(f"VGG-16 request {i}: answer {tuple(a.shape)} or non-finite")
            d, o = served_at(served, torch.from_numpy(req).cuda())
            serve_err = max(serve_err, (a - direct[d][o:o + sizes[i]]).abs().max().item())
            alone = qnet.output(req).float()
            alone_err = max(alone_err, log_prob_err(a, alone.cpu()))
            band_err = max(band_err, (alone - net.output(req).float()).abs().max().item())
        log(f"  readings: fp top prob max {top.max().item():.4f} mean {top.mean().item():.4f}, "
            f"entropy {entropy.mean().item():.3f}; engine vs its batch {serve_err:.3g}, vs the "
            f"request alone {alone_err:.4g} (log probabilities); int8 vs fp {band_err:.4g}, "
            f"band {report.tolerance_band:.4g}")
        if not serve_err <= VGG_SERVE_TOL:
            raise AssertionError(f"engine answers differ from qnet.output of their batch by "
                                 f"{serve_err} (limit {VGG_SERVE_TOL})")
        if not band_err <= report.tolerance_band:
            raise AssertionError(f"int8 outputs differ from fp by {band_err}, past the "
                                 f"calibrated band {report.tolerance_band}")
        bf16 = int8_forward_check(qnet, x, "bfloat16")
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    f32 = int8_forward_check(qnet, x, "float32")      # phase: the same qnet, f32 policy
    result = {"card": card, "params": net.num_params(), "report": report.to_dict(),
              "fp_top_prob_max": top.max().item(), "fp_top_prob_mean": top.mean().item(),
              "fp_entropy_mean": entropy.mean().item(),
              "requests": len(sizes), "images": int(sum(sizes)), "batches": batches,
              "launches": launches, "wall_s": wall, "images_per_s": sum(sizes) / wall,
              "serve_max_abs_err": serve_err, "alone_max_log_prob_err": alone_err,
              "int8_vs_fp_max_abs": band_err,
              "fp_forward_ms_batch32": fp_ms,
              "fp_forward_images_per_s_batch32": VGG_BATCH / fp_ms * 1e3,
              "bf16": bf16, "f32": f32}
    log(f"VGG-16 int8 on {card}: {result['params']} params; quantize_net report "
        f"{json.dumps(report.to_dict())}")
    log(f"  fp softmax: largest probability {result['fp_top_prob_max']:.4f} (mean of the "
        f"row maxima {result['fp_top_prob_mean']:.4f}), mean entropy "
        f"{result['fp_entropy_mean']:.3f} nats (uniform: {np.log(1000):.3f})")
    log(f"  engine: {result['images']} images in {len(sizes)} requests, {batches} batches, "
        f"{launches} int8_matmul launches; {result['images_per_s']:.1f} images/s (smoke); "
        f"answer vs qnet.output of its batch {serve_err:.2e}, of the request alone "
        f"{alone_err:.2e} (log probabilities, bf16 convolution algorithms); int8 vs fp "
        f"{band_err:.3e} within the band {report.tolerance_band:.3e}")
    log(f"  forward at batch {VGG_BATCH}, bf16: fp {fp_ms:.2f} ms "
        f"({result['fp_forward_images_per_s_batch32']:.1f} images/s), int8 {bf16['ms']:.2f} ms "
        f"({bf16['images_per_s']:.1f} images/s), int8 with the plain version "
        f"{bf16['plain_ms']:.2f} ms; kernel vs plain {bf16['kernel_vs_plain_log_prob_err']:.2e} "
        f"(limit {VGG_PLAIN_TOL['bfloat16']})")
    log(f"  f32 policy: int8 {f32['ms']:.2f} ms, plain {f32['plain_ms']:.2f} ms; kernel vs plain "
        f"{f32['kernel_vs_plain_log_prob_err']:.2e} (limit {VGG_PLAIN_TOL['float32']}); against the exact product kernel "
        f"{f32['kernel_vs_exact_log_prob_err']:.2e} (limit {VGG_EXACT_TOL}), plain "
        f"{f32['plain_vs_exact_log_prob_err']:.2e}")
    return result


def int8_entry(rows, vgg: dict) -> dict:
    """The kernels-line entry of int8_matmul: bf16 (the serving policy)
    summed over VGG-16's three dense calls at batch 32, f32 beside it, and
    every per-shape row."""
    def pick(dname):
        sel = [r for r in rows if r["dtype"] == dname and r["M"] == VGG_BATCH
               and r["shape"].startswith("vgg16")]
        tot = {key: sum(r[key] for r in sel)
               for key in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
        by = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
        return {"ms": tot["ms"], "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
                "bound_ms": max(tot["bytes_ms"], tot["ops_ms"]), "bound_by": by,
                "max_abs_err": max(r["max_abs_err"] for r in sel)}
    shapes = [{key: r[key] for key in ("shape", "dtype", "M", "K", "N", "ms", "plain_ms",
                                       "library_ms", "bound_ms", "bound_by", "max_abs_err")}
              for r in rows]
    return {"name": "int8_matmul", "route": "cuda",
            "source": "deeplearning4j_tpu_torch/ops/kernels/csrc/int8_matmul.cu",
            "replaces": "deeplearning4j_tpu/ops/pallas/quant_matmul.py:45",
            "launches": vgg["launches"],
            "launches_per_forward": vgg["bf16"]["launches_per_forward"], **pick("bfloat16"),
            "work": f"VGG-16's three dense layers at batch {VGG_BATCH}, bf16, L2 cold (f32_*: "
                    f"f32); launches: the 16 served requests",
            **{f"f32_{k}": v for k, v in pick("float32").items()}, "shapes": shapes}


# ------------------------------------------------------------------- A/B
# the merged backward's scratch beside dq at the base case, at most (the
# per-key-tile f32 partials of the design before the ordered sum took
# 4 D BH Tq ceil(Tk/64) = 1.61 GB there)
MERGED_SCRATCH_LIMIT = 0.2e9
# the A/B call's head dims at BERT-base's width: (D, heads)
AB_HEAD_DIMS = ((64, 12), (32, 24), (128, 6), (80, 12), (256, 3), (192, 4))
# the A/B call's 16-call conv3x3_bn_act passes: (batch, dtype)
AB_CONV3 = ((BATCH, "float32"), (BATCH, "bfloat16"), (HEADLINE_BATCH, "bfloat16"))


def conv3_pass_ms(batch: int, dname: str) -> dict:
    """The 16 3x3 calls of one ResNet-50 pass at ``batch``: the kernel's ms
    and the layer's chain's (a yardstick), each stage timed on seeded
    inputs with the prologue and relu_in and counted once per call, by
    CUDA events around back-to-back calls and as device time alone (the
    small stages' calls can be shorter than the host's work per call);
    the checksum of y, s1 and s2 at each stage's shape."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv3_bn
    gen = torch.Generator(device="cuda").manual_seed(CONV3_SEED + batch)
    dtype = getattr(torch, dname)
    out = {"batch": batch, "dtype": dname, "ms": 0.0, "library_ms": 0.0, "device_ms": 0.0,
           "library_device_ms": 0.0, "checksums": {}}
    for h, c, count in CONV3_STAGES:
        x = torch.randn(batch, h, h, c, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(3, 3, c, c, device="cuda", generator=gen) / (9 * c) ** 0.5).to(dtype)
        a = torch.rand(c, device="cuda", generator=gen) + 0.5
        b = torch.randn(c, device="cuda", generator=gen) * 0.2
        out["checksums"][f"{h}x{h}x{c}"] = checksum(*conv3_bn.conv3x3_bn_act(x, w, a, b))
        out["ms"] += count * cuda_ms(lambda: conv3_bn.conv3x3_bn_act(x, w, a, b), warmup=1)
        out["library_ms"] += count * cuda_ms(lambda: library_conv3(x, w, a, b), warmup=1)
        out["device_ms"] += count * device_ms(lambda: conv3_bn.conv3x3_bn_act(x, w, a, b))
        out["library_device_ms"] += count * device_ms(lambda: library_conv3(x, w, a, b))
        del x, w
    torch.cuda.empty_cache()
    return out


# the A/B call's 36-call matmul_bn_act passes of ResNet-50: (batch, dtype)
AB_MBA = ((BATCH, "float32"), (BATCH, "bfloat16"), (HEADLINE_BATCH, "bfloat16"))
# the A/B call's int8 calls: VGG-16's dense layers at these batch sizes
AB_INT8_BATCHES = (1, 8, 32)


def checksum(*tensors) -> str:
    """A digest of the tensors' bytes (None skipped): equal digests, equal
    bits."""
    import hashlib
    import torch
    digest = hashlib.sha256()
    for t in tensors:
        if t is not None:
            digest.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def host_us(fn, reps: int = 20, warmup: int = 3) -> float:
    """Host microseconds per call of ``fn``: the time the calling thread
    spends in it, the device's work excluded (no synchronize inside the
    timed loop; the launch queue holds the few calls it runs ahead)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


def mba_pass_ms(batch: int, dname: str) -> dict:
    """The 36 matmul_bn_act calls of one ResNet-50 pass at ``batch``: the
    backward kernel pair's ms and its library yardstick's, and the
    forward kernel's, each distinct shape timed on seeded inputs (as
    ``check_bwd_kernels`` makes them) and counted once per call, by CUDA
    events around back-to-back calls and as device time alone, and the
    forward's host microseconds per call (averaged over the 36 calls); the
    checksum of each shape's first backward and first forward."""
    import torch
    from deeplearning4j_tpu_torch.models import resnet50
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    calls = resnet50_calls(resnet50(fused=True, device="cuda"), batch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2 + batch)
    dtype = getattr(torch, dname)
    out = {"batch": batch, "dtype": dname, "calls": len(calls), "checksums": {},
           "fwd_checksums": {}, "fwd_host_us": 0.0}
    keys = ("ms", "device_ms", "library_ms", "library_device_ms", "fwd_ms", "fwd_device_ms")
    out |= {key: 0.0 for key in keys}
    for (m, k, n, pro) in sorted(set(calls)):
        count = calls.count((m, k, n, pro))
        x = torch.randn(m, k, device="cuda", generator=gen)
        x = (x if pro else x.relu()).to(dtype)
        w = (torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5).to(dtype)
        a = torch.rand(k, device="cuda", generator=gen) + 0.5 if pro else None
        b = torch.randn(k, device="cuda", generator=gen) * 0.2 if pro else None
        y = conv_bn.matmul_bn_act_plain(x, w, a, b, relu_in=True)[0]
        dy = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
        ds1 = torch.randn(n, device="cuda", generator=gen)
        ds2 = torch.randn(n, device="cuda", generator=gen) * 0.5
        args = (x, w, a, b, y, dy, ds1, ds2)
        shape = f"{m}x{k}x{n}x{int(pro)}"
        out["checksums"][shape] = checksum(*conv_bn.matmul_bn_act_bwd(*args, relu_in=True))
        out["fwd_checksums"][shape] = checksum(*conv_bn.matmul_bn_act(x, w, a, b, relu_in=True))
        for key, fn in (("", lambda: conv_bn.matmul_bn_act_bwd(*args, relu_in=True)),
                        ("library_", lambda: library_matmul_bn_act_bwd(*args)),
                        ("fwd_", lambda: conv_bn.matmul_bn_act(x, w, a, b, relu_in=True))):
            out[f"{key}ms"] += count * cuda_ms(fn, warmup=1)
            out[f"{key}device_ms"] += count * device_ms(fn)
        out["fwd_host_us"] += count * host_us(
            lambda: conv_bn.matmul_bn_act(x, w, a, b, relu_in=True)) / len(calls)
        del x, w, y, dy, args
    torch.cuda.empty_cache()
    return out


# the shape of the forward's host breakdown: a 1x1 call of ResNet-50 at batch
# 32 with a prologue (the last stage's c conv)
MBA_HOST_SHAPE = (BATCH * 7 * 7, 512, 2048)


def mba_host_us(dname: str) -> dict:
    """Host microseconds per call of the ``matmul_bn_act`` forward's wrapper
    and of its parts, at ``MBA_HOST_SHAPE`` with a prologue, in whichever
    tree is first on the path: the call where no gradient is asked for and
    where x requires one (``autograd.Function.apply``), the checks, the
    ``torch.cuda.device`` context, the stream lookups (public and raw), and
    ``_launch`` with and without its library call (allocations, pointers,
    the plan, tensor maps and launches: the difference is the library
    call)."""
    import inspect
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    m, k, n = MBA_HOST_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    dtype = getattr(torch, dname)
    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5).to(dtype)
    a = torch.rand(k, device="cuda", generator=gen) + 0.5
    b = torch.randn(k, device="cuda", generator=gen) * 0.2
    xg = x.clone().requires_grad_(True)
    dev, lib = x.device, conv_bn._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    extra = ((conv_bn._sm_count(dev.index),)
             if "sms" in inspect.signature(conv_bn._launch).parameters else ())

    class NoLaunch:
        """The library with its kernel entry points answering 0 unlaunched."""

        def __getattr__(self, name):
            if name in ("matmul_bn_act_f32", "matmul_bn_act_bf16"):
                return lambda *args: 0
            return getattr(lib, name)

    def context():
        with torch.cuda.device(dev):
            pass

    parts = {"call": lambda: conv_bn.matmul_bn_act(x, w, a, b, relu_in=True),
             "call_autograd": lambda: conv_bn.matmul_bn_act(xg, w, a, b, relu_in=True),
             "check": lambda: conv_bn._check(x, w, a, b),
             "device_context": context,
             "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
             "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
             "launch": lambda: conv_bn._launch(lib, x, w, a, b, True, stream, *extra),
             "launch_no_call": lambda: conv_bn._launch(NoLaunch(), x, w, a, b, True, stream,
                                                       *extra)}
    before = conv_bn.launches
    out = {key: host_us(fn, reps=200, warmup=10) for key, fn in parts.items()}
    conv_bn.launches = before
    out["library_call"] = out["launch"] - out["launch_no_call"]
    return out


def int8_ab_ms() -> list[dict]:
    """The int8 kernel and ``torch.matmul`` on the widened weight at
    VGG-16's three dense shapes and ``AB_INT8_BATCHES``, f32 and bf16, L2
    cold, on seeded inputs; the checksum of each first call."""
    import torch
    from deeplearning4j_tpu_torch.nn.quantize import quantize_weight
    from deeplearning4j_tpu_torch.ops.kernels import quant_matmul as qm
    gen = torch.Generator(device="cuda").manual_seed(INT8_SEED)
    rows = []
    for name, k, n in INT8_SHAPES[:3]:
        w_q, scale = quantize_weight(torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5)
        for dname in ("float32", "bfloat16"):
            for m in AB_INT8_BATCHES:
                x = torch.randn(m, k, device="cuda", generator=gen).to(getattr(torch, dname))
                rows.append({"shape": name, "dtype": dname, "M": m,
                             "checksum": checksum(qm.int8_matmul(x, w_q, scale)),
                             "ms": cold_ms(lambda: qm.int8_matmul(x, w_q, scale)),
                             "library_ms": cold_ms(lambda: library_int8_matmul(x, w_q, scale))})
    return rows


def resnet_ab_ms() -> dict:
    """ResNet-50 in f32 at batch 32, seeded: the served forward
    (``net.output``, 10 runs after 3 warm-ups) and one training step
    (``Trainer.fit_batch``, ``Nesterovs(TRAIN_LR, 0.9)``, 5 steps after 3),
    wall ms by CUDA events."""
    import torch
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.train import Nesterovs, Trainer
    net = build_net(Nesterovs(TRAIN_LR, 0.9))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(BATCH, 224, 224, 3, device="cuda", generator=gen)
    labels = torch.eye(1000, device="cuda")[torch.randint(0, 1000, (BATCH,), device="cuda",
                                                          generator=gen)]
    trainer, batch = Trainer(net), DataSet(x, labels)
    out = {"resnet_forward_f32_ms": cuda_ms(lambda: net.output(x), reps=10, warmup=3),
           "resnet_step_f32_ms": cuda_ms(lambda: trainer.fit_batch(batch), reps=5, warmup=3)}
    del net, trainer
    torch.cuda.empty_cache()
    return out


def ab_times() -> dict:
    """Times of whichever ``deeplearning4j_tpu_torch`` is first on the
    path: the forward (normalized) and both backward forms at the base case
    of every AB head dim, f32 and bf16, the forward and the merged backward
    at the causal case with offsets as well, the ``AB_CONV3`` passes of
    ``conv3x3_bn_act``, the ``AB_MBA`` passes of ``matmul_bn_act`` (its
    backward and forward, and where the forward wrapper's host time goes),
    the int8 kernel at VGG-16's dense shapes, ResNet-50's f32 served
    forward and training step, and the BERT-base fine-tune step (4 layers,
    2 x 4096) and serving call (12 layers), in bf16 and f32."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import _build
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build((*FLASH_LIBS, "conv3x3_bn_act", "matmul_bn_act", "matmul_bn_act_bwd",
                  "int8_matmul"))
    gen = torch.Generator(device="cuda").manual_seed(FLASH_SEED)
    rows = []
    for d, heads in AB_HEAD_DIMS:
        for dname in ("float32", "bfloat16"):
            case = ("base", BERT_BATCH, heads, BERT_SEQ, BERT_SEQ, False, None, 0, 0)
            q, k, v, dout, _, kw = flash_inputs(case, getattr(torch, dname), gen, d)
            out, lse = fa._forward(q, k, v, None, kw["scale"], False, 0, 0, normalize=True)
            row = {"D": d, "H": heads, "dtype": dname,
                   "forward_ms": cuda_ms(lambda: fa._forward(q, k, v, None, kw["scale"], False,
                                                             0, 0, normalize=True), reps=5)}
            for form in ("merged", "split"):
                row[f"{form}_ms"] = cuda_ms(lambda: fa.flash_attention_block_bwd(
                    q, k, v, out, lse, dout, merged=form == "merged", **kw), reps=5)
            case = ("causal_offsets", BERT_BATCH, heads, BERT_SEQ, BERT_SEQ, True, None, 1024, 512)
            q, k, v, dout, _, kw = flash_inputs(case, getattr(torch, dname), gen, d)
            out, lse = fa._forward(q, k, v, None, kw["scale"], True, 1024, 512, normalize=True)
            row["forward_causal_ms"] = cuda_ms(lambda: fa._forward(
                q, k, v, None, kw["scale"], True, 1024, 512, normalize=True), reps=5)
            row["merged_causal_ms"] = cuda_ms(lambda: fa.flash_attention_block_bwd(
                q, k, v, out, lse, dout, merged=True, **kw), reps=5)
            rows.append(row)
            del q, k, v, dout, out, lse
            torch.cuda.empty_cache()
    conv3 = [conv3_pass_ms(batch, dname) for batch, dname in AB_CONV3]
    mba = [mba_pass_ms(batch, dname) for batch, dname in AB_MBA]
    mba_host = {dname: mba_host_us(dname) for dname in ("float32", "bfloat16")}
    int8 = int8_ab_ms()
    try:
        from deeplearning4j_tpu_torch.train.capture import eager
    except ImportError:     # a tree from before the captured steps: they are eager there
        eager = contextlib.nullcontext
    with eager():
        resnet = resnet_ab_ms()
        bert = bert_ab_ms()
    return {"flash_bwd": rows, "conv3": conv3, "mba": mba, "mba_host": mba_host, "int8": int8,
            **resnet, **bert}


def bert_ab_ms() -> dict:
    """The BERT-base fine-tune step (4 layers, 2 x 4096, through ``fit``)
    and serving call (12 layers), bf16 and f32."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.models import BertForMaskedLM
    from deeplearning4j_tpu_torch.train import Adam
    bert = {}
    for policy in ("bf16", "f32"):
        config.set_dtype_policy(getattr(config.DTypePolicy, policy)())
        try:
            model = BertForMaskedLM(bert_config(BERT_TRAIN_LAYERS, use_flash=True), seed=0,
                                    device="cuda")
            watch = StepWatch()
            model.fit([bert_batch(model.config.vocab_size)] * (1 + BERT_TRAIN_STEPS),
                      updater=Adam(BERT_TRAIN_LR), listeners=[watch])
            bert[f"bert_finetune_step_{policy}_ms"] = float(np.mean(watch.seconds[1:])) * 1e3
            del model
            model = BertForMaskedLM(bert_config(12, use_flash=None), seed=0, device="cuda")
            ids = np.random.default_rng(SEED + 11).integers(0, model.config.vocab_size,
                                                            (BERT_BATCH, BERT_SEQ))
            bert[f"bert_serve_{policy}_ms"] = cuda_ms(lambda: model.predict_mlm(ids), reps=3,
                                                      warmup=1)
            del model
            torch.cuda.empty_cache()
        finally:
            config.set_dtype_policy(config.DTypePolicy.f32())
    return bert


def ab(parent: Path) -> int:
    """The A/B call: ``ab_times`` of the tree at ``parent`` and of this
    one, each in its own process, in the order parent, change, change,
    parent; prints both trees' times side by side and writes them to
    ``chiprun_out/chip_ab.json``."""
    card = card_line()
    log(card)
    runs = []
    for label, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--times",
                               str(tree)], capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-8000:], file=sys.stderr)
            return 1
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
        log(f"  {label} run {len(runs)} done")
    times = {label: [r for lab, r in runs if lab == label] for label in ("parent", "change")}

    def pair(label, pick):
        return ", ".join(f"{pick(r):.3f}" for r in times[label])

    for i, row in enumerate(runs[0][1]["flash_bwd"]):
        for form, what in (("forward", "forward"), ("forward_causal", "forward, causal"),
                           ("merged", "merged backward"), ("split", "split backward"),
                           ("merged_causal", "merged, causal")):
            def pick(r, form=form):
                return r["flash_bwd"][i][f"{form}_ms"]
            gain = (sum(map(pick, times["parent"])) / sum(map(pick, times["change"])))
            log(f"  D={row['D']} H={row['H']} {row['dtype']:8s} {what:15s}: parent "
                f"{pair('parent', pick)} ms; change {pair('change', pick)} ms ({gain:.3f}x)")
    for i, row in enumerate(runs[0][1]["conv3"]):
        for key, what in (("ms", "kernel"), ("library_ms", "the layer's chain"),
                          ("device_ms", "kernel, device time"),
                          ("library_device_ms", "the chain, device time")):
            def pick(r, key=key):
                return r["conv3"][i][key]
            gain = (sum(map(pick, times["parent"])) / sum(map(pick, times["change"])))
            log(f"  conv3x3_bn_act 16-call pass, batch {row['batch']} {row['dtype']:8s} {what}: "
                f"parent {pair('parent', pick)} ms; change {pair('change', pick)} ms "
                f"({gain:.3f}x)")
    same = len({json.dumps([c["checksums"] for c in r["conv3"]], sort_keys=True)
                for _, r in runs}) == 1
    log(f"  conv3x3_bn_act checksums of y, s1 and s2 at the "
        f"{sum(len(c['checksums']) for c in runs[0][1]['conv3'])} (pass, shape) pairs: "
        f"{'equal in all four runs' if same else 'DIFFERENT between runs'}")
    for i, row in enumerate(runs[0][1]["mba"]):
        for key, what in (("ms", "backward kernels"), ("device_ms", "backward, device time"),
                          ("library_ms", "backward library (cuBLAS + torch ops)"),
                          ("library_device_ms", "backward library, device time"),
                          ("fwd_ms", "forward kernel"), ("fwd_device_ms", "forward, device time")):
            def pick(r, key=key):
                return r["mba"][i][key]
            gain = (sum(map(pick, times["parent"])) / sum(map(pick, times["change"])))
            log(f"  matmul_bn_act {row['calls']}-call pass, batch {row['batch']} "
                f"{row['dtype']:8s} {what}: parent {pair('parent', pick)} ms; change "
                f"{pair('change', pick)} ms ({gain:.3f}x)")
    for i, row in enumerate(runs[0][1]["mba"]):
        def pick(r, i=i):
            return r["mba"][i]["fwd_host_us"]
        log(f"  matmul_bn_act forward, host us per call (mean of the {row['calls']} calls), batch "
            f"{row['batch']} {row['dtype']:8s}: parent {pair('parent', pick)}; change "
            f"{pair('change', pick)}")
    for label in ("parent", "change"):
        same = len({json.dumps([m["fwd_checksums"] for m in r["mba"]], sort_keys=True)
                    for r in times[label]}) == 1
        log(f"  matmul_bn_act forward checksums of y, s1 and s2 at every shape of the "
            f"{len(AB_MBA)} passes: {'equal' if same else 'DIFFERENT'} in the two {label} runs")
    for dname in ("float32", "bfloat16"):
        for key in runs[0][1]["mba_host"][dname]:
            def pick(r, key=key, dname=dname):
                return r["mba_host"][dname][key]
            log(f"  matmul_bn_act forward host us per call at {MBA_HOST_SHAPE}, {dname:8s} "
                f"{key}: parent {pair('parent', pick)}; change {pair('change', pick)}")
    for i, row in enumerate(runs[0][1]["int8"]):
        for key, what in (("ms", "kernel"), ("library_ms", "library")):
            def pick(r, key=key):
                return r["int8"][i][key]
            gain = (sum(map(pick, times["parent"])) / sum(map(pick, times["change"])))
            log(f"  int8_matmul {row['shape']} M={row['M']:2d} {row['dtype']:8s} {what}: parent "
                f"{pair('parent', pick)} ms; change {pair('change', pick)} ms ({gain:.3f}x)")
    for key, what in (("resnet_forward_f32_ms", "ResNet-50 served forward (f32, batch 32)"),
                      ("resnet_step_f32_ms", "ResNet-50 training step (f32, batch 32)"),
                      ("bert_finetune_step_bf16_ms", "BERT fine-tune step (bf16, 4 layers)"),
                      ("bert_serve_bf16_ms", "BERT serve (bf16, 12 layers)"),
                      ("bert_finetune_step_f32_ms", "BERT fine-tune step (f32, 4 layers)"),
                      ("bert_serve_f32_ms", "BERT serve (f32, 12 layers)")):
        log(f"  {what}: parent {pair('parent', lambda r: r[key])} ms; change "
            f"{pair('change', lambda r: r[key])} ms")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_ab.json").write_text(json.dumps(
        {"card": card, "order": [label for label, _ in runs], "runs": [r for _, r in runs],
         "conv3_checksums_equal": same, "log": LOG_LINES}, indent=1))
    return 0


def flash_entry(name, source, replaces, rows, prefix, launches, work) -> dict:
    """The kernels-line entry of one flash kernel (``prefix`` "" for the
    forward, "bwd_" for the backward): f32 figures at the base case, bf16
    ones beside them."""
    def pick(dname):
        r = next(r for r in rows if r["case"] == "base" and r["dtype"] == dname)
        bound = {"bytes": r[f"{prefix}bytes_ms"], "operations": r[f"{prefix}ops_ms"]}
        by = max(bound, key=bound.get)
        return {"ms": r[f"{prefix}ms"], "plain_ms": r[f"{prefix}plain_ms"],
                "bound_ms": bound[by], "bound_by": by, "library_ms": r[f"{prefix}library_ms"],
                "max_abs_err": r[f"{prefix}max_abs_err"]}
    bf16 = pick("bfloat16")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **pick("float32"), "work": work,
            **{f"bf16_{k}": v for k, v in bf16.items()}}


# ---------------------------------------------------------------- small nets
# MultiLayerNetwork's training path (the zoo's small nets, the canned
# datasets, evaluation, dropout, LRN); no kernel of this repo runs on it
SMALL_SEED = SEED + 30
SMALL_BATCH = 128        # bench.py's bench_workload_steps
SMALL_STEPS = 20         # timed steps after step 0
# card against the CPU from the same weights and batch, as read there: step
# 0's loss, relative; each param's step-0 gradient (and, under an updater
# linear in it, its update), max |card - cpu| over max |cpu|: f32 sum order
# only (the CPU's f32 against its f64 read at most 1.2e-6).  Adam's first
# update is lr * g / (|g| + eps): where |g| nears eps it carries the
# gradient's rounding on at full size (on the CPU, f32 against f64: 163 of
# LeNet's 1.6 M dense weights past 1e-4), so Adam's update is printed, not held
SMALL_LOSS0_TOL, SMALL_STEP0_TOL = 1e-5, 1e-4
LINEAR_UPDATERS = ("sgd", "nesterovs")
MNIST_ACCURACY = 0.9     # the verify recipe's bar for 2 epochs of MLP-MNIST
# card-trained weights evaluated on the card and on the CPU: predictions
# that may differ (argmax near-ties), as a share of the test set
EVAL_DIFFER_SHARE = 1e-3
DROPOUT_STEPS, DROPOUT_BATCH, DROPOUT_SIGMA = 3, 32, 5
# the zoo's inference forwards at batch 2, card against CPU, max |diff| of
# log probabilities.  In f64 both compute the same function (read at most
# 1.0e-13 on the H100).  In f32 AlexNet and SimpleCNN read 6.6e-6 and
# 7.7e-6, held to ZOO_FWD_TOL.  VGG-19's log probabilities reach -31, and
# f32 itself is 4.6e-5 (card) and 5.9e-5 (CPU) from the f64 forward there,
# so its f32 pair is printed, and the card's f32 forward is held to the
# f64 one within twice the CPU's own f32 error (ZOO_FWD_TOL at least)
ZOO_FWD_TOL, ZOO_F64_TOL = 1e-5, 1e-10


class _Recorded:
    """A trainer's optimizer (``Trainer.tx``) that keeps the gradient and
    the update of its last step (comparison only)."""

    def __init__(self, tx):
        self.tx, self.grads, self.updates = tx, None, None

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params=None):
        updates, state = self.tx.update(grads, state, params)
        self.grads, self.updates = grads, updates
        return updates, state


def cpu_twin(net, factory, **kwargs):
    """The same net on the CPU, with a copy of ``net``'s params and state."""
    twin = factory(device="cpu", **kwargs)
    twin.set_params([{k: t.cpu() for k, t in d.items()} for d in net.params_])
    twin.state_ = [{k: t.cpu() for k, t in d.items()} for d in net.state_]
    return twin


def tree_errs(got, want) -> dict:
    """Per param (layer index.name): max |got - want| over max |want|."""
    return {f"{i}.{k}": ((g.cpu() - want[i][k]).abs().max() / want[i][k].abs().max()).item()
            for i, d in enumerate(got) for k, g in d.items() if want[i][k].abs().max() > 0}


def small_step(card, name, factory, kwargs, x, y) -> dict:
    """Step 0 of ``Trainer.fit_batch`` on the card and on the CPU from the
    same weights and batch, then ``SMALL_STEPS`` timed steps on the card:
    their mean (synchronized), the device time of one step alone
    (torch.profiler) and the busy share."""
    import torch
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.train import Trainer, step_cache
    net = factory(device="cuda", **kwargs).init(seed=SMALL_SEED)
    twin = cpu_twin(net, factory, **kwargs)
    batch = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    runs = []
    for model, data in ((net, batch), (twin, DataSet(x, y))):
        # the twins share a configuration, so a step cached by the first
        # would record into the first's updater: each builds its own
        step_cache.clear_step_cache()
        trainer = Trainer(model)
        trainer.tx = rec = _Recorded(trainer.tx)
        runs.append((trainer, rec, trainer.fit_batch(data).item()))
    (trainer, rec, loss), (_, rec_cpu, loss_cpu) = runs
    loss_err = abs(loss - loss_cpu) / abs(loss_cpu)
    grad_errs = tree_errs(rec.grads, rec_cpu.grads)
    upd_errs = tree_errs(rec.updates, rec_cpu.updates)
    kind = net.conf.updater["type"]
    held = grad_errs | (upd_errs if kind in LINEAR_UPDATERS else {})
    if not (loss_err <= SMALL_LOSS0_TOL and max(held.values()) <= SMALL_STEP0_TOL):
        raise AssertionError(f"{name} step 0, card vs CPU: loss {loss} vs {loss_cpu} "
                             f"({loss_err:.2e}); gradients {grad_errs}; updates {upd_errs}")
    off = sum(int(((u.cpu() - rec_cpu.updates[i][k]).abs()
                   > SMALL_STEP0_TOL * rec_cpu.updates[i][k].abs().max()).sum())
              for i, d in enumerate(rec.updates) for k, u in d.items())
    step_cache.clear_step_cache()
    trainer = Trainer(net)     # a step without the recorder for the timed steps

    def step():
        return trainer.fit_batch(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SMALL_STEPS):
        last = step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / SMALL_STEPS * 1e3
    dev = device_ms(step)
    ops = step_profile(step, reps=1)
    result = {"card": card, "batch": len(x), "updater": kind, "loss0": loss,
              "loss0_cpu": loss_cpu, "loss0_rel_err": loss_err,
              "grad_rel_err_max": max(grad_errs.values()),
              "update_rel_err_max": max(upd_errs.values()), "update_entries_off": off,
              "update_held": kind in LINEAR_UPDATERS, "last_loss": last.item(),
              "step_ms": step_ms, "images_per_s": len(x) / step_ms * 1e3,
              "device_ms": dev, "busy_share": dev / step_ms,
              "device_ops_per_step": ops["device_ops"],
              "kernel_launches_per_step": ops["kernel_launches"]}
    log(f"{name} train f32 batch {len(x)} on {card}: step 0 vs CPU loss {loss:.6f} "
        f"({loss_err:.2e} rel), gradients {result['grad_rel_err_max']:.2e}, {kind} updates "
        f"{result['update_rel_err_max']:.2e} ({off} entries past {SMALL_STEP0_TOL} of their "
        f"largest{'' if result['update_held'] else '; not held'}); step {step_ms:.3f} ms "
        f"({result['images_per_s']:.1f} images/s) over {SMALL_STEPS} steps after step 0, "
        f"device time {dev:.3f} ms, busy {result['busy_share']:.1%}, "
        f"{ops['device_ops']:.0f} kernels and copies a step ({ops['kernel_launches']:.0f} "
        f"kernel launches)")
    return result


def predictions_differ(net, twin, features) -> int:
    """Test examples whose argmax differs between ``net`` (the card) and
    ``twin`` (the CPU)."""
    return int((net.output(features).argmax(-1).cpu() != twin.output(features).argmax(-1))
               .sum())


def small_flow(card, name, factory, kwargs, train_it, test_it, epochs) -> dict:
    """The examples' flow on the card: zoo -> dataset -> net.fit ->
    net.evaluate; the card-trained weights also evaluated on the CPU."""
    import torch
    net = factory(device="cuda", **kwargs).init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(train_it, epochs)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    ev = net.evaluate(test_it)
    twin = cpu_twin(net, factory, **kwargs)
    ev_cpu = twin.evaluate(test_it)
    differ = predictions_differ(net, twin, test_it.features)
    cm_differ = int(abs(ev.confusion_matrix() - ev_cpu.confusion_matrix()).sum()) // 2
    limit = int(EVAL_DIFFER_SHARE * ev.total)
    result = {"card": card, "epochs": epochs, "steps": net.iteration, "fit_s": fit_s,
              "train_synthetic": train_it.synthetic, "test_synthetic": test_it.synthetic,
              "train_examples": len(train_it.features), "test_examples": ev.total,
              "accuracy": ev.accuracy(), "cpu_accuracy": ev_cpu.accuracy(),
              "predictions_differ": differ, "confusion_entries_differ": cm_differ,
              "differ_limit": limit, "score": net.score(), "stats": ev.stats()}
    log(f"{name} flow on {card}: {epochs} epoch(s) of net.fit over {result['train_examples']} "
        f"examples (synthetic {train_it.synthetic}; test synthetic {test_it.synthetic}) in "
        f"{fit_s:.2f} s, {net.iteration} steps, last loss {result['score']:.4f}; accuracy "
        f"{ev.accuracy():.4f} on the card, {ev_cpu.accuracy():.4f} with the same weights on "
        f"the CPU; {differ} of {ev.total} predictions differ (limit {limit}; confusion "
        f"matrices {cm_differ})")
    if differ > limit or cm_differ > differ:
        raise AssertionError(f"{name}: {differ} predictions differ between card and CPU "
                             f"(limit {limit}), confusion matrices {cm_differ}")
    return result


def forward_vs_cpu(net, factory, x, hold_f32_pair: bool) -> dict:
    """``net``'s inference forward on ``x`` (batch 2, on the card) against
    the CPU's, in log probabilities: the f32 pair, the same net in f64 on
    both devices, and each f32 forward against the CPU's f64 one."""
    import torch
    from deeplearning4j_tpu_torch import config

    def log_p(model, device, dtype):
        return model.output(x.to(device, dtype)).cpu().double().log()

    f32 = {"cuda": log_p(net, "cuda", torch.float32),
           "cpu": log_p(cpu_twin(net, factory), "cpu", torch.float32)}
    config.set_dtype_policy(config.DTypePolicy(torch.float64, torch.float64, torch.float64))
    try:
        f64 = {}
        for device in ("cuda", "cpu"):
            twin = factory(device=device)
            twin.set_params([{k: t.to(device, torch.float64) for k, t in d.items()}
                             for d in net.params_])
            twin.state_ = [{k: t.to(device, torch.float64) for k, t in d.items()}
                           for d in net.state_]
            f64[device] = log_p(twin, device, torch.float64)
            del twin
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    errs = {"f32_card_vs_cpu": (f32["cuda"] - f32["cpu"]).abs().max().item(),
            "f64_card_vs_cpu": (f64["cuda"] - f64["cpu"]).abs().max().item(),
            "f32_card_vs_f64": (f32["cuda"] - f64["cpu"]).abs().max().item(),
            "f32_cpu_vs_f64": (f32["cpu"] - f64["cpu"]).abs().max().item(),
            "log_p_min": f64["cpu"].min().item(), "f32_pair_held": hold_f32_pair}
    limit = max(ZOO_FWD_TOL, 2 * errs["f32_cpu_vs_f64"])
    if not (errs["f64_card_vs_cpu"] <= ZOO_F64_TOL and errs["f32_card_vs_f64"] <= limit
            and (errs["f32_card_vs_cpu"] <= ZOO_FWD_TOL or not hold_f32_pair)):
        raise AssertionError(f"inference forward, card vs CPU: {errs}")
    return errs


def fwd_line(errs: dict) -> str:
    return (f"card vs CPU {errs['f32_card_vs_cpu']:.2e} in log probabilities"
            f"{'' if errs['f32_pair_held'] else ' (printed, not held)'}, f64 "
            f"{errs['f64_card_vs_cpu']:.2e}; f32 against f64: card "
            f"{errs['f32_card_vs_f64']:.2e}, CPU {errs['f32_cpu_vs_f64']:.2e} (log p down to "
            f"{errs['log_p_min']:.1f})")


class masks_recorded:
    """Every dropout mask the port draws (``base._keep_mask``), kept with
    its retain probability, while the context is open."""

    def __enter__(self):
        from deeplearning4j_tpu_torch.nn.layers import base
        self.base, self.draw, self.masks = base, base._keep_mask, []

        def record(shape, p, gen, device):
            mask = self.draw(shape, p, gen, device)
            self.masks.append((mask, p))
            return mask
        base._keep_mask = record
        return self

    def __exit__(self, *exc):
        self.base._keep_mask = self.draw


def dropout_net(card, name, factory, shape, classes) -> dict:
    """``DROPOUT_STEPS`` training steps at batch ``DROPOUT_BATCH`` on the
    card, every dropout mask recorded: finite losses, each mask's keep
    share within ``DROPOUT_SIGMA`` sigma of its retain probability, and a
    second step 0 from the same weights and stream seed drawing the same
    masks; then the inference forward at batch 2 against the CPU."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.train import Trainer
    rng = np.random.default_rng(SMALL_SEED + classes)
    x = rng.normal(size=(DROPOUT_BATCH,) + shape).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, DROPOUT_BATCH)]
    batch = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    net = factory(device="cuda").init(seed=SMALL_SEED)
    with masks_recorded() as infer:
        fwd = forward_vs_cpu(net, factory, torch.from_numpy(x[:2]), hold_f32_pair=True)
    p0 = [{k: t.clone() for k, t in d.items()} for d in net.params_]
    s0 = [{k: t.clone() for k, t in d.items()} for d in net.state_]
    with masks_recorded() as run:
        trainer = Trainer(net)
        losses = [trainer.fit_batch(batch).item() for _ in range(DROPOUT_STEPS)]
    per_step = len(run.masks) // DROPOUT_STEPS
    net.set_params(p0)
    net.state_, net.opt_state = s0, None
    with masks_recorded() as again:
        loss0 = Trainer(net).fit_batch(batch).item()
    sigmas = [abs(m.float().mean().item() - p) / np.sqrt(p * (1 - p) / m.numel())
              for m, p in run.masks]
    same = len(again.masks) == per_step and all(
        torch.equal(a, b) for (a, _), (b, _) in zip(again.masks, run.masks[:per_step]))
    # the stream moves on: no mask repeats the one of the step before
    moved = all(not torch.equal(a, b) for (a, _), (b, _) in zip(run.masks[per_step:],
                                                                run.masks))
    result = {"card": card, "batch": DROPOUT_BATCH, "losses": losses, "repeat_loss0": loss0,
              "masks_per_step": per_step, "mask_shapes": [list(m.shape) for m, _ in
                                                          run.masks[:per_step]],
              "retain": [p for _, p in run.masks[:per_step]], "keep_share_sigmas": sigmas,
              "repeat_same_masks": same, "masks_move_step_to_step": moved,
              "inference_draws": len(infer.masks),
              "forward": fwd}
    log(f"{name} dropout on {card}: {DROPOUT_STEPS} steps at batch {DROPOUT_BATCH}, losses "
        f"{losses}; {per_step} masks a step {result['mask_shapes']} at retain "
        f"{result['retain']}, keep shares within {max(sigmas):.2f} sigma; a second step 0 "
        f"drew the same masks: {same} (loss {loss0:.6f}), each step new ones: {moved}; "
        f"inference forward at batch 2 "
        f"({len(infer.masks)} masks drawn): {fwd_line(fwd)}")
    if not (all(np.isfinite(losses + [loss0])) and per_step and max(sigmas) <= DROPOUT_SIGMA
            and same and moved and not infer.masks
            and len(run.masks) == per_step * DROPOUT_STEPS):
        raise AssertionError(f"{name} dropout check failed: {result}")
    return result


def vgg19_forward(card) -> dict:
    """Full-width VGG-19: the forward at batch 32 timed on the card, and at
    batch 2 against the CPU (``forward_vs_cpu``)."""
    import torch
    from deeplearning4j_tpu_torch.models import vgg19
    net = vgg19(device="cuda").init(seed=SMALL_SEED)
    gen = torch.Generator(device="cuda").manual_seed(SMALL_SEED)
    x = torch.randn(BATCH, 224, 224, 3, device="cuda", generator=gen)
    ms = cuda_ms(lambda: net.output(x), reps=5, warmup=2)
    fwd = forward_vs_cpu(net, vgg19, x[:2], hold_f32_pair=False)
    result = {"card": card, "batch": BATCH, "forward_ms": ms, "images_per_s": BATCH / ms * 1e3,
              "params": net.num_params(), "forward": fwd}
    log(f"vgg19 forward f32 batch {BATCH} on {card}: {ms:.3f} ms "
        f"({result['images_per_s']:.1f} images/s), {net.num_params()} params; batch 2: "
        f"{fwd_line(fwd)}")
    return result


def small_nets(card: str) -> dict:
    """Phase 19: the zoo's MultiLayerNetwork entries on the card, f32."""
    import numpy as np
    from deeplearning4j_tpu_torch.data import datasets
    from deeplearning4j_tpu_torch.models import alexnet, lenet, mlp_mnist, simple_cnn
    # bench.py's bench_workload_steps data: one numpy stream, seed 0
    rng = np.random.default_rng(0)
    xm = rng.normal(size=(SMALL_BATCH, 784)).astype(np.float32)
    ym = np.eye(10, dtype=np.float32)[rng.integers(0, 10, SMALL_BATCH)]
    xl = rng.normal(size=(SMALL_BATCH, 32, 32, 3)).astype(np.float32)
    yl = np.eye(10, dtype=np.float32)[rng.integers(0, 10, SMALL_BATCH)]
    cifar = {"height": 32, "width": 32, "channels": 3}
    out = {"mlp_mnist_step": small_step(card, "mlp_mnist", mlp_mnist, {}, xm, ym),
           "lenet_cifar10_step": small_step(card, "lenet", lenet, cifar, xl, yl)}
    out["mlp_mnist_flow"] = small_flow(
        card, "mlp_mnist", mlp_mnist, {}, datasets.mnist(batch_size=128, n_synthetic=6000),
        datasets.mnist(batch_size=256, train=False, n_synthetic=6000), 2)
    if not out["mlp_mnist_flow"]["accuracy"] > MNIST_ACCURACY:
        raise AssertionError(f"mlp_mnist accuracy {out['mlp_mnist_flow']['accuracy']} after 2 "
                             f"epochs, not above {MNIST_ACCURACY}")
    out["lenet_cifar10_flow"] = small_flow(
        card, "lenet", lenet, cifar, datasets.cifar10(n_synthetic=2000),
        datasets.cifar10(train=False, n_synthetic=2000), 1)
    log("lenet cifar10 evaluation on the card:\n" + out["lenet_cifar10_flow"]["stats"])
    out["simple_cnn_dropout"] = dropout_net(card, "simple_cnn", simple_cnn, (48, 48, 3), 10)
    out["alexnet_dropout"] = dropout_net(card, "alexnet", alexnet, (224, 224, 3), 1000)
    out["vgg19_forward"] = vgg19_forward(card)
    return out


# ------------------------------------------ BERT-base MLM, the seq-128 headline
HEADLINE_SEQ, HEADLINE_SEQS = 128, 32      # bench.py:181's batch and sequence
HEADLINE_WARMUP, HEADLINE_TIMED, HEADLINE_FIT_STEPS = 3, 20, 10
HEADLINE_LR, HEADLINE_MAX_PREDICTIONS = 2e-5, 32
# card against the CPU, 2 layers, batch 4, f32 policy (TF32 off), dropout 0,
# one set of weights: step 0's loss, relative; each param's step-0 gradient,
# max |card - cpu| over max |cpu| (the small nets' SMALL_STEP0_TOL); Adam's
# bf16 first moment per entry within one bf16 ulp of the CPU's, where the
# card's updater runs on the CPU's gradients (the rounding order itself) and
# after each device's own step (there an entry whose gradient is below the
# gradient band may differ by the band: it is rounding noise on both
# devices); the 3 later losses, relative
HEADLINE_CHECK_LAYERS, HEADLINE_CHECK_SEQS = 2, 4
HEADLINE_LOSS_TOL, HEADLINE_GRAD_TOL, HEADLINE_UPDATE_TOL = 1e-5, 1e-4, 1e-6
FEEDER_BATCHES = 8


def headline_config(**changes):
    import dataclasses
    from deeplearning4j_tpu_torch.models import BertConfig
    return dataclasses.replace(BertConfig.base(), max_predictions=HEADLINE_MAX_PREDICTIONS,
                               **changes)


def headline_batch(vocab: int) -> dict:
    """bench.py's seq-128 batch: ids, labels and 15% weights from
    ``default_rng(0)``, an all-ones attention mask."""
    import numpy as np
    rng = np.random.default_rng(0)
    shape = (HEADLINE_SEQS, HEADLINE_SEQ)
    ids = rng.integers(0, vocab, shape)
    labels = rng.integers(0, vocab, shape)
    weights = (rng.random(shape) < 0.15).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "label_weights": weights,
            "attention_mask": np.ones(shape, np.float32)}


def bf16_ulps(got, want):
    """|got - want| in bf16 ulps of |want| (at least the smallest normal's),
    per entry, as an f32 tensor."""
    import torch
    want = want.float()
    _, exp = torch.frexp(want.abs().clamp_min(torch.finfo(torch.bfloat16).tiny))
    return (got.float() - want).abs() / torch.ldexp(torch.ones_like(want), exp - 8)


def leaf_names(tree, prefix: str = "") -> list[str]:
    """The key path of each leaf of a nested dict, in ``tree_leaves``'
    order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def headline_check(card: str) -> dict:
    """Phase 20's card-against-CPU check of the headline's step at 2 layers
    and batch 4 (f32 policy, dropout 0, one set of weights)."""
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.models import BertForMaskedLM, bert
    from deeplearning4j_tpu_torch.train import Adam
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

    cfg = headline_config(num_layers=HEADLINE_CHECK_LAYERS, hidden_dropout=0.0,
                          attention_dropout=0.0)
    data = {k: v[:HEADLINE_CHECK_SEQS] for k, v in headline_batch(cfg.vocab_size).items()}
    config.set_dtype_policy(config.DTypePolicy.f32())
    runs = {}
    for dev in ("cuda", "cpu"):
        model = BertForMaskedLM(cfg, seed=0, device=dev)
        args = [torch.as_tensor(data[k], device=dev).to(dt) for k, dt in
                (("input_ids", torch.long), ("labels", torch.long),
                 ("label_weights", torch.float32), ("attention_mask", torch.float32))]
        params = tree_map(lambda p: p.detach().requires_grad_(True), model.params)
        loss = bert.mlm_loss(params, cfg, args[0], args[1], args[2], attention_mask=args[3],
                             train=True)
        grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
        updater = Adam(HEADLINE_LR, mu_dtype="bf16")
        step = model.make_train_step(updater)
        gen = torch.Generator(device=dev).manual_seed(0)
        p, state, losses = model.params, updater.init(model.params), []
        for i in range(4):
            p, state, step_loss = step(p, state, *args, gen)
            losses.append(step_loss.item())
            if i == 0:     # the later steps update mu in place
                mu0 = [m.clone() for m in tree_leaves(state["mu"])]
        runs[dev] = {"loss": loss.item(), "grads": [None if g is None else g.detach()
                                                     for g in grads],
                     "mu0": mu0, "losses": losses, "params": model.params}
    card_run, cpu = runs["cuda"], runs["cpu"]
    names = leaf_names(cpu["params"])
    loss_err = abs(card_run["loss"] - cpu["loss"]) / abs(cpu["loss"])
    # softmax ignores a shift of a row's scores: a key bias's gradient is
    # zero but for rounding on both devices, held against its layer's value
    # bias gradient and left out of the per-entry checks (as phase 15 does)
    grad_errs, key_bias = {}, 0.0
    for name, g, w in zip(names, card_run["grads"], cpu["grads"]):
        if w is None:
            continue
        if name.endswith("key/bias"):
            ref = cpu["grads"][names.index(name.replace("key/bias", "value/bias"))].norm()
            key_bias = max(key_bias, max(g.norm().item(), w.norm().item()) / ref.item())
            continue
        grad_errs[name] = ((g.cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
    worst = max(grad_errs.items(), key=lambda kv: kv[1])
    # the rounding order alone: the card's updater on the CPU's gradients
    updater = Adam(HEADLINE_LR, mu_dtype="bf16")
    g_cpu = [torch.zeros_like(p) if g is None else g
             for p, g in zip(tree_leaves(cpu["params"]), cpu["grads"])]
    on_card = updater.update([g.cuda() for g in g_cpu], updater.init([g.cuda() for g in g_cpu]))
    on_cpu = updater.update(g_cpu, updater.init(g_cpu))
    rounding_ulps = max(bf16_ulps(m.cpu(), w).max().item()
                        for m, w in zip(on_card[1]["mu"], on_cpu[1]["mu"]))
    update_err = max(((u.cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
                     for u, w in zip(on_card[0], on_cpu[0]))
    # after each device's own step 0
    step_ulps, noise = 0.0, 0
    for name, m, w, g in zip(names, card_run["mu0"], cpu["mu0"], g_cpu):
        if name.endswith("key/bias") or not g.abs().max() > 0:
            continue
        ulps = bf16_ulps(m.cpu(), w)
        band = 0.1 * HEADLINE_GRAD_TOL * g.abs().max()   # mu = 0.1 g at step 0
        below = (m.cpu().float() - w.float()).abs() <= band
        step_ulps = max(step_ulps, ulps[~below].max().item() if (~below).any() else 0.0)
        noise += int(((ulps > 1) & below).sum())
    later = [abs(a - b) / abs(b) for a, b in zip(card_run["losses"][1:], cpu["losses"][1:])]
    result = {"layers": HEADLINE_CHECK_LAYERS, "seqs": HEADLINE_CHECK_SEQS,
              "loss0": card_run["loss"], "loss0_cpu": cpu["loss"], "loss0_rel_err": loss_err,
              "grad_rel_err_max": worst[1], "grad_rel_err_worst": worst[0],
              "key_bias_grad_max": key_bias, "mu_rounding_ulps_max": rounding_ulps,
              "update_rel_err_max": update_err, "mu_step0_ulps_max": step_ulps,
              "mu_step0_noise_entries": noise, "losses": card_run["losses"],
              "losses_cpu": cpu["losses"], "later_loss_rel_errs": later}
    log(f"seq-128 headline check, card vs CPU ({HEADLINE_CHECK_LAYERS} layers, batch "
        f"{HEADLINE_CHECK_SEQS}, f32, dropout 0) on {card}: step-0 loss {loss_err:.2e} rel, "
        f"gradients {worst[1]:.2e} ({worst[0]}; key biases {key_bias:.1e} of the value "
        f"bias's), bf16 mu on the CPU's gradients {rounding_ulps:.0f} "
        f"ulp (updates {update_err:.2e}), mu after each device's step 0 {step_ulps:.0f} ulp "
        f"({noise} entries past 1 ulp inside the gradient band), later losses "
        f"{max(later):.2e} rel")
    if not (loss_err <= HEADLINE_LOSS_TOL and worst[1] <= HEADLINE_GRAD_TOL
            and key_bias <= 1e-2 and rounding_ulps <= 1 and update_err <= HEADLINE_UPDATE_TOL and step_ulps <= 1
            and max(later) <= HEADLINE_LOSS_TOL):
        raise AssertionError(f"seq-128 headline check failed: {result}")
    return result


def feeder_check(card: str) -> dict:
    """The feeder's CUDA staging: an iterator that refills one host buffer
    for every batch, a consumer that keeps the card busy before it reads
    each batch and holds them all; every batch keeps its own values."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.device_pipeline import DeviceFeeder
    buf = np.zeros((HEADLINE_SEQS, HEADLINE_SEQ), np.int64)

    def refilled():
        for i in range(FEEDER_BATCHES):
            buf[:] = i
            yield {"input_ids": buf}

    feeder = DeviceFeeder(depth=2, bucketing=False, device="cuda")
    busy = torch.randn(4096, 4096, device="cuda")
    held = []
    for fed in feeder.feed(refilled()):
        for _ in range(4):
            busy = torch.tanh(busy @ busy * 1e-3)   # the consumer's stream is busy
        held.append(fed.batch["input_ids"] + 0)
    torch.cuda.synchronize()
    values = [(int(t.min()), int(t.max())) for t in held]
    ok = (values == [(i, i) for i in range(FEEDER_BATCHES)] and feeder.slots >= 2
          and all(t.is_cuda for t in held))
    log(f"DeviceFeeder on {card}: {FEEDER_BATCHES} batches through a ring of {feeder.slots} "
        f"page-locked slots and a side stream, each batch's (min, max) {values}")
    if not ok:
        raise AssertionError(f"the feeder overwrote a batch in flight: {values}")
    return {"batches": FEEDER_BATCHES, "slots": feeder.slots, "values": values}


def bert_headline(card: str) -> dict:
    """Phase 20: BERT-base MLM's seq-128 headline at bench.py:181-230's
    configuration on the card (einsum attention, no flash launch), its
    check against the CPU, and the feeder's staging."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.models import BertForMaskedLM
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.train import Adam
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves

    config.set_dtype_policy(config.DTypePolicy.bf16())
    try:
        cfg = headline_config()
        model = BertForMaskedLM(cfg, seed=0, device="cuda")
        batch = headline_batch(cfg.vocab_size)
        args = [torch.as_tensor(batch[k], device="cuda").to(dt) for k, dt in
                (("input_ids", torch.long), ("labels", torch.long),
                 ("label_weights", torch.float32), ("attention_mask", torch.float32))]
        updater = Adam(HEADLINE_LR, mu_dtype="bf16")
        step = model.make_train_step(updater)
        gen = torch.Generator(device="cuda").manual_seed(0)
        state = [model.params, updater.init(model.params)]

        def run():
            state[0], state[1], loss = step(state[0], state[1], *args, gen)
            return loss

        for _ in range(HEADLINE_WARMUP):
            loss = run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        for _ in range(HEADLINE_TIMED):
            loss = run()
        last = loss.item()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / HEADLINE_TIMED
        launches = (fa.launches, fa.bwd_launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # the same steps, each read back as fit reads its loss (no feeder)
        t0 = time.perf_counter()
        for _ in range(HEADLINE_FIT_STEPS):
            run().item()
        sync_s = (time.perf_counter() - t0) / HEADLINE_FIT_STEPS
        dev = device_ms(run)
        mu_bf16 = all(m.dtype == torch.bfloat16 for m in tree_leaves(state[1]["mu"]))
        fit_model = BertForMaskedLM(cfg, seed=0, device="cuda")
        watch = StepWatch()
        fit_loss = fit_model.fit([batch] * HEADLINE_FIT_STEPS,
                                 updater=Adam(HEADLINE_LR, mu_dtype="bf16"), listeners=[watch])
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    if launches != (0, 0) or any(c != (0, 0) for c in watch.launches):
        raise AssertionError(f"the seq-128 headline launched flash kernels: {launches}, "
                             f"fit {watch.launches}")
    if not (np.isfinite(last) and np.isfinite(fit_loss) and mu_bf16):
        raise AssertionError(f"seq-128 headline: loss {last}, fit loss {fit_loss}, "
                             f"bf16 mu {mu_bf16}")
    tokens = HEADLINE_SEQS * HEADLINE_SEQ
    fit_s = float(np.mean(watch.seconds[1:]))
    result = {"card": card, "policy": "bf16", "layers": cfg.num_layers, "seqs": HEADLINE_SEQS,
              "seq": HEADLINE_SEQ, "max_predictions": cfg.max_predictions,
              "updater": f"adam({HEADLINE_LR}, mu_dtype=bf16)", "params": model.num_params(),
              "flash_launches": launches, "warmup_steps": HEADLINE_WARMUP,
              "timed_steps": HEADLINE_TIMED, "step_ms": step_s * 1e3,
              "sequences_per_s": HEADLINE_SEQS / step_s, "tokens_per_s": tokens / step_s,
              "device_ms": dev, "busy_share": dev / (step_s * 1e3), "last_loss": last,
              "peak_memory_gib": peak, "fit_steps": HEADLINE_FIT_STEPS,
              "fit_step_ms": fit_s * 1e3, "fit_tokens_per_s": tokens / fit_s,
              "synced_step_ms": sync_s * 1e3,
              "fit_losses": watch.losses}
    log(f"BERT-base MLM seq-128 headline on {card}: bf16, {cfg.num_layers} layers, batch "
        f"{HEADLINE_SEQS} x {HEADLINE_SEQ}, max_predictions {cfg.max_predictions}, "
        f"Adam({HEADLINE_LR}, mu_dtype=bf16): step {result['step_ms']:.2f} ms over "
        f"{HEADLINE_TIMED} steps after {HEADLINE_WARMUP} warm-ups "
        f"({result['sequences_per_s']:.1f} sequences/s, {result['tokens_per_s']:.0f} "
        f"tokens/s), device time {dev:.2f} ms, busy {result['busy_share']:.1%}; flash "
        f"launches {launches}; peak memory {peak:.2f} GiB; through fit (DeviceFeeder, "
        f"ListenerBus) {result['fit_step_ms']:.2f} ms a step over {HEADLINE_FIT_STEPS - 1} "
        f"steps after the first, make_train_step reading each loss {sync_s * 1e3:.2f} ms; last "
        f"loss {last:.4f}")
    result["check"] = headline_check(card)
    result["feeder"] = feeder_check(card)
    return result


# ------------------------------ the config-first encoder through the flash kernels
STACK_BLOCKS, STACK_CLASSES, STACK_STEPS, STACK_LR = 4, 2, 3, 1e-4
STACK_VALID = (BERT_SEQ, 3000)     # the features mask's valid lengths
# the encoder in f32 through the kernels against the flash plain versions,
# one set of weights, held to phases 13-15's limits: the served log
# probabilities at BERT_SERVE_TOL (5e-5, max |diff|), the step-0 loss at
# BERT_LOSS0_TOL (1e-5 relative), each param's step-0 gradient at
# BERT_UPDATE_TOL (5e-3 relative, in norm); the key biases, whose gradient
# is zero but for rounding, at 1e-2 of their block's value-bias gradient
# (read on the H100: 1.2e-7, 0, 1.4e-5 and 3.9e-7)


def stack_conf():
    """BERT-base's width as a config-first ComputationGraph: a token
    embedding, ``STACK_BLOCKS`` transformer blocks (self attention with biases,
    residual add, layer norm, Dense(3072, gelu) -> Dense(768), add, layer
    norm), average pooling and a 2-class softmax."""
    from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
    from deeplearning4j_tpu_torch.train import Adam
    g = (NeuralNetConfiguration.builder().seed(SEED).updater(Adam(STACK_LR)).graph()
         .add_inputs("ids").set_input_types(InputType.recurrent(1, BERT_SEQ))
         .add_layer("emb", L.EmbeddingSequenceLayer(n_in=30522, n_out=768), "ids"))
    prev = "emb"
    for i in range(STACK_BLOCKS):
        g = (g.add_layer(f"att{i}", L.SelfAttentionLayer(n_heads=12, has_bias=True), prev)
             .add_vertex(f"res{i}a", ElementWiseVertex(op="add"), prev, f"att{i}")
             .add_layer(f"ln{i}a", L.LayerNormalization(), f"res{i}a")
             .add_layer(f"ff{i}", L.DenseLayer(n_out=3072, activation="gelu"), f"ln{i}a")
             .add_layer(f"proj{i}", L.DenseLayer(n_out=768), f"ff{i}")
             .add_vertex(f"res{i}b", ElementWiseVertex(op="add"), f"ln{i}a", f"proj{i}")
             .add_layer(f"ln{i}b", L.LayerNormalization(), f"res{i}b"))
        prev = f"ln{i}b"
    return (g.add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"), prev)
            .add_layer("out", L.OutputLayer(n_out=STACK_CLASSES, activation="softmax",
                                            loss="mcxent"), "pool")
            .set_outputs("out").build())


def vertex_conf():
    """Three Dense projections into ``AttentionVertex(n_heads=12)``, pooled
    into a 2-class softmax."""
    from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.vertices import AttentionVertex
    g = (NeuralNetConfiguration.builder().seed(SEED).graph()
         .add_inputs("x").set_input_types(InputType.recurrent(768, BERT_SEQ)))
    for name in ("q", "k", "v"):
        g = g.add_layer(name, L.DenseLayer(n_out=768), "x")
    return (g.add_vertex("attn", AttentionVertex(n_heads=12), "q", "k", "v")
            .add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"), "attn")
            .add_layer("out", L.OutputLayer(n_out=STACK_CLASSES, activation="softmax"), "pool")
            .set_outputs("out").build())


def stack_batch():
    """Seeded ids [2, 4096, 1], one-hot labels and a features mask of
    valid lengths ``STACK_VALID``."""
    import numpy as np
    rng = np.random.default_rng(SEED + 40)
    ids = rng.integers(0, 30522, (BERT_BATCH, BERT_SEQ, 1)).astype(np.float32)
    labels = np.eye(STACK_CLASSES, dtype=np.float32)[rng.integers(0, STACK_CLASSES, BERT_BATCH)]
    mask = (np.arange(BERT_SEQ)[None] < np.array(STACK_VALID)[:, None]).astype(np.float32)
    return ids, labels, mask


def graph_step0(net, batch):
    """One forward and backward of ``Trainer.fit_batch``'s loss (no
    update): the loss, each param's gradient, and the flash launches."""
    import torch
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.train import Trainer
    from deeplearning4j_tpu_torch.train.trainer import make_loss_fn
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map
    batch = Trainer(net)._place(batch)
    params = tree_map(lambda p: p.detach().requires_grad_(True), net.params_)
    fa.launches = fa.bwd_launches = 0
    loss, _ = make_loss_fn(net)(params, net.state_, batch.features, batch.labels,
                                batch.features_mask, batch.labels_mask)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    names = [f"{v}.{k}" for v, d in params.items() for k in d]
    return loss.item(), dict(zip(names, grads)), (fa.launches, fa.bwd_launches)


def attention_stack(card: str) -> dict:
    """Phase 21: the config-first encoder at BERT-base's width through the
    flash kernels, and the AttentionVertex graph."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.train import Trainer

    ids, labels, mask = stack_batch()
    x, m = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    batch = DataSet(x, torch.from_numpy(labels).cuda(), m)
    # bf16 throughout: with the bf16 policy's f32 params the attention's q,
    # k, v promote to f32, as in JAX; bf16 params keep them bf16
    bf16 = config.DTypePolicy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                              output_dtype=torch.bfloat16)
    config.set_dtype_policy(bf16)
    try:
        net = ComputationGraph(stack_conf(), device="cuda").init()
        net.output(x, mask=m)
        torch.cuda.synchronize()
        fa.launches = fa.bwd_launches = 0
        t0 = time.perf_counter()
        out = net.output(x, mask=m)
        torch.cuda.synchronize()
        out_ms = (time.perf_counter() - t0) * 1e3
        out_launches = (fa.launches, fa.bwd_launches)
        trainer = Trainer(net)
        losses, step_launches, seconds = [], [], []
        for _ in range(1 + STACK_STEPS):          # a warm-up step, then the timed ones
            fa.launches = fa.bwd_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.fit_batch(batch).item())
            seconds.append(time.perf_counter() - t0)
            step_launches.append((fa.launches, fa.bwd_launches))
        fa.launches = fa.bwd_launches = 0
        short = net.output(x[:, :512], mask=m[:, :512])
        short_launches = fa.launches + fa.bwd_launches
        vnet = ComputationGraph(vertex_conf(), device="cuda").init()
        xv = torch.randn(BERT_BATCH, BERT_SEQ, 768, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(SEED))
        vnet.output(xv)
        fa.launches = fa.bwd_launches = 0
        vout = vnet.output(xv)
        vertex_launches = (fa.launches, fa.bwd_launches)
        bf16_ok = (out.dtype == torch.bfloat16 and tuple(out.shape) == (BERT_BATCH, STACK_CLASSES)
                   and bool(torch.isfinite(out.float()).all())
                   and bool(torch.isfinite(vout.float()).all()) and tuple(short.shape) ==
                   (BERT_BATCH, STACK_CLASSES))
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    want = (STACK_BLOCKS, 0)
    if (out_launches != want or any(c != (STACK_BLOCKS, STACK_BLOCKS) for c in step_launches)
            or short_launches or vertex_launches != (1, 0)):
        raise AssertionError(f"config-first encoder flash launches: output {out_launches}, "
                             f"steps {step_launches}, seq 512 {short_launches}, "
                             f"AttentionVertex {vertex_launches}")
    if not (bf16_ok and np.isfinite(losses).all()):
        raise AssertionError(f"config-first encoder bf16: output {out}, losses {losses}")
    del net, trainer, vnet

    # f32 (TF32 off), one set of weights: through the kernels and through the
    # flash plain versions
    net = ComputationGraph(stack_conf(), device="cuda").init()
    served = torch.log(net.output(x, mask=m))
    loss, grads, f32_launches = graph_step0(net, batch)
    with plain_flash():
        fa.launches = 0
        served_plain = torch.log(net.output(x, mask=m))
        loss_plain, grads_plain, plain_launches = graph_step0(net, batch)
    if f32_launches != (STACK_BLOCKS, STACK_BLOCKS) or plain_launches != (0, 0):
        raise AssertionError(f"f32 encoder launches {f32_launches}, plain {plain_launches}")
    served_err = (served - served_plain).abs().max().item()
    loss_err = abs(loss - loss_plain) / abs(loss_plain)
    errs, key_bias = {}, {}
    for name, g in grads.items():
        w = grads_plain[name]
        if name.endswith(".bk"):
            # softmax ignores a shift of a row's scores: the key bias's
            # gradient is zero but for rounding, held against its block's
            # value-bias gradient
            ref = grads_plain[name[:-1] + "v"].norm()
            key_bias[name] = max(g.norm().item(), w.norm().item()) / ref.item()
            continue
        errs[name] = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
    worst = max(errs.items(), key=lambda kv: kv[1])
    result = {"card": card, "blocks": STACK_BLOCKS, "batch": BERT_BATCH, "seq": BERT_SEQ,
              "valid_lengths": STACK_VALID, "params": net.num_params(),
              "bf16_output_ms": out_ms, "bf16_output_launches": out_launches,
              "bf16_losses": losses, "bf16_step_launches": step_launches,
              "bf16_step_s": seconds, "bf16_step_ms": float(np.mean(seconds[1:])) * 1e3,
              "seq512_launches": short_launches, "vertex_launches": vertex_launches,
              "f32_launches": f32_launches, "served_log_prob_err": served_err,
              "loss0": loss, "loss0_plain": loss_plain, "loss0_rel_err": loss_err,
              "grad_rel_err_max": worst[1], "grad_rel_err_worst": worst[0],
              "grad_rel_err_median": float(np.median(list(errs.values()))),
              "key_bias_grad_max": max(key_bias.values())}
    log(f"config-first encoder on {card}: {STACK_BLOCKS} blocks at BERT-base's width, batch "
        f"{BERT_BATCH} x {BERT_SEQ} (valid {STACK_VALID}), {net.num_params()} params; bf16: "
        f"output {out_ms:.1f} ms with (forward, backward) flash launches {out_launches}, "
        f"Trainer.fit_batch {result['bf16_step_ms']:.1f} ms a step over {STACK_STEPS} after a "
        f"warm-up, launches {step_launches}, losses {losses}; seq 512: {short_launches} "
        f"launches; AttentionVertex graph {vertex_launches}; f32 kernels vs plain: served "
        f"log-probabilities {served_err:.2e}, step-0 loss {loss_err:.2e} rel, gradients "
        f"{worst[1]:.2e} ({worst[0]}; median {result['grad_rel_err_median']:.2e}), key-bias "
        f"gradients {result['key_bias_grad_max']:.1e} of the value bias's")
    if not (served_err <= BERT_SERVE_TOL["float32"] and loss_err <= BERT_LOSS0_TOL
            and worst[1] <= BERT_UPDATE_TOL and result["key_bias_grad_max"] <= 1e-2):
        raise AssertionError(f"config-first encoder f32, kernels vs plain: {result}")
    return result


# ------------------------------ phase 22: the captured steps (train/capture.py)
# each path is run twice from the same start, eager (capture.eager()) and
# through the step cache (CUDA graphs): CAPTURE_STEPS steps that must give
# the same bits (losses or outputs, params, state, updater state), then
# CAPTURE_TIMED timed steps and CAPTURE_PROFILED traced ones
CAPTURE_STEPS, CAPTURE_TIMED, CAPTURE_PROFILED = 5, 20, 3
CAPTURE_DROPOUT = 0.8     # the dropout MLP's retain probability
CAPTURE_SEED = SEED + 50
# the host-side launch calls of the CUDA runtime and driver, as the profiler
# names them: a kernel launch, and a graph launch
KERNEL_LAUNCH_API, GRAPH_LAUNCH_API = "LaunchKernel", "GraphLaunch"


def kernel_counts(zero: bool = False) -> dict:
    """Every kernel wrapper's launch count (each set to 0 after reading
    when ``zero``), by the kernel's name in the ``kernels`` line."""
    from deeplearning4j_tpu_torch.ops.kernels import conv3_bn, conv_bn, quant_matmul
    from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
    attrs = {"matmul_bn_act": (conv_bn, "launches"), "matmul_bn_act_bwd": (conv_bn, "bwd_launches"),
             "flash_attention": (fa, "launches"), "flash_attention_bwd": (fa, "bwd_launches"),
             "flash_attention_bwd_split": (fa, "split_launches"),
             "int8_matmul": (quant_matmul, "launches"), "conv3x3_bn_act": (conv3_bn, "launches")}
    counts = {}
    for name, (module, attr) in attrs.items():
        counts[name] = getattr(module, attr)
        if zero:
            setattr(module, attr, 0)
    return counts


def launched(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def same_bits(a, b) -> bool:
    import torch
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def host_copy(*trees) -> list:
    """Every leaf of ``trees`` (nested dicts and lists of tensors), copied
    to the host, in order."""
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    return [t.detach().to("cpu", copy=True) for tree in trees for t in tree_leaves(tree)]


def step_profile(fn, reps: int = CAPTURE_PROFILED) -> dict:
    """``reps`` calls of ``fn`` traced (torch.profiler, CPU and CUDA): per
    call the device time of every kernel, copy and memset, their number,
    the kernel launches and graph launches the host made and the host time
    they took; and the device's busy share of the traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    out = {"device_ms": 0.0, "device_ops": 0, "kernel_launches": 0, "graph_launches": 0,
           "kernel_launch_api_ms": 0.0, "graph_launch_api_ms": 0.0}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CPU:
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0)
            out["device_ms"] += dev_us / 1e3
            out["device_ops"] += e.count
        elif GRAPH_LAUNCH_API in e.key:
            out["graph_launches"] += e.count
            out["graph_launch_api_ms"] += e.cpu_time_total / 1e3
        elif KERNEL_LAUNCH_API in e.key:
            out["kernel_launches"] += e.count
            out["kernel_launch_api_ms"] += e.cpu_time_total / 1e3
    return {k: v / reps for k, v in out.items()} | {"busy_share": out["device_ms"] / window_ms}


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` while open: cuDNN's
    convolution backward and the scatter-add behind a gather's backward
    otherwise sum in an order that varies from run to run, so two eager
    runs of ResNet-50, LeNet or the seq-128 headline differ in their last
    bits.  cuBLAS takes it with its workspace set as ``:4096:8`` (the
    default size on Hopper)."""
    import os
    import torch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def capture_mode(captured: bool, make, policy=None, deterministic: bool = False,
                 timed: bool = True, timed_steps: int = CAPTURE_TIMED,
                 profiled: int = CAPTURE_PROFILED) -> dict:
    """One mode of a path, from a cleared step cache: ``make()`` gives
    ``(run, snapshot, close, steps)``; ``run(i, n)`` takes steps i..i+n-1
    (its outputs as tensors), ``snapshot()`` copies the trees it updates
    to the host, ``steps()`` are the captured steps it holds outside the
    step cache.  The first ``WARMUP_CALLS`` steps, the next one (the
    capture) and the rest of ``CAPTURE_STEPS`` run with the launch counts
    read between them; then, if ``timed``, ``timed_steps`` timed steps
    and ``profiled`` traced ones."""
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.train import capture, step_cache
    step_cache.clear_step_cache()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts0 = step_cache.counters()
    if policy is not None:
        config.set_dtype_policy(policy)
    out = {"captured": captured, "deterministic": deterministic}
    try:
        with (contextlib.nullcontext() if captured else capture.eager()), \
                (deterministic_algorithms() if deterministic else contextlib.nullcontext()):
            run, snapshot, close, extra_steps = make()
            try:
                w = capture.WARMUP_CALLS
                kernel_counts(zero=True)
                outs = run(0, w)
                out["launches_warmup"] = launched(kernel_counts(zero=True))
                outs += run(w, 1)
                out["launches_capture_call"] = launched(kernel_counts(zero=True))
                outs += run(w + 1, CAPTURE_STEPS - w - 1)
                out["launches_after_capture"] = launched(kernel_counts(zero=True))
                out["final"] = [o.detach().to("cpu", copy=True) for o in outs] + snapshot()
                if timed:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run(CAPTURE_STEPS, timed_steps)
                    torch.cuda.synchronize()
                    out["step_ms"] = (time.perf_counter() - t0) / timed_steps * 1e3
                    out["launches_timed"] = launched(kernel_counts(zero=True))
                    out.update(step_profile(lambda: run(CAPTURE_STEPS + timed_steps, 1),
                                            reps=profiled))
                    # the traced device time over the untraced step: the busy
                    # share without the profiler's cost on each launch
                    out["device_share_of_step"] = out["device_ms"] / out["step_ms"]
                    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
                out["graphs"] = step_cache.captured_graphs(*step_cache.cached_steps(),
                                                           *extra_steps())
            finally:
                close()
    finally:
        if policy is not None:
            config.set_dtype_policy(config.DTypePolicy.f32())
    counts = step_cache.counters()
    out["cache_hits"] = counts[step_cache.HITS] - counts0[step_cache.HITS]
    out["cache_misses"] = counts[step_cache.MISSES] - counts0[step_cache.MISSES]
    return out


def restarted(build):
    """``build()``'s net, made once; every call gives it back with copies
    of its first params and state and no updater state."""
    from deeplearning4j_tpu_torch.train.updaters import tree_map
    made = []

    def again():
        if not made:
            net = build()
            made.append((net, tree_map(lambda t: t.clone(), net.params_),
                         tree_map(lambda t: t.clone(), net.state_)))
        net, p0, s0 = made[0]
        net.params_, net.state_ = (tree_map(lambda t: t.clone(), t) for t in (p0, s0))
        net.opt_state = None
        return net
    return again


def fit_path(build, batches):
    """``make`` of a ``MultiLayerNetwork.fit`` path: ``run(i, n)`` is one
    ``fit`` call over batches i..i+n-1 (a fresh Trainer each call, as fit
    builds), its output the last step's loss."""
    from deeplearning4j_tpu_torch.data import ListDataSetIterator
    start = restarted(build)

    def make():
        net = start()

        def run(i, n):
            net.fit(ListDataSetIterator([batches[(i + j) % len(batches)] for j in range(n)]))
            return [net._score]
        return (run, lambda: host_copy(net.params_, net.state_, net.opt_state), lambda: None,
                lambda: [])
    return make


def trainer_path(build, batches, seed):
    """``make`` of a ``Trainer.fit_batch`` path on ``build()``'s net, with a
    generator seeded ``seed``: ``run(i, n)`` is n steps on batches i...
    (a net that the step cache does not key, with frozen layers or
    per-layer updaters, holds its step on its trainer)."""
    import torch
    from deeplearning4j_tpu_torch.train import Trainer
    start = restarted(build)

    def make():
        net = start()
        trainer = Trainer(net)
        gen = torch.Generator(device="cuda").manual_seed(seed)

        def run(i, n):
            return [trainer.fit_batch(batches[(i + j) % len(batches)], gen) for j in range(n)]
        return (run, lambda: host_copy(net.params_, net.state_, net.opt_state), lambda: None,
                lambda: [] if trainer._cache_sig is not None else [trainer._step])
    return make


def engine_path(net, requests):
    """``make`` of a serving path: an ``InferenceEngine(net, max_batch=32)``,
    ``run(i, n)`` n blocking requests of 32 images each, their answers."""
    import torch
    from deeplearning4j_tpu_torch.serve import InferenceEngine

    def make():
        engine = InferenceEngine(net, max_batch=BATCH)

        def run(i, n):
            return [torch.from_numpy(engine.predict(requests[(i + j) % len(requests)]))
                    for j in range(n)]
        return run, lambda: [], engine.shutdown, lambda: []
    return make


def bert_path(batches):
    """``make`` of the seq-128 headline's ``make_train_step`` path (phase
    20's configuration, dropout 0.1): ``run(i, n)`` n steps."""
    import torch
    from deeplearning4j_tpu_torch.models import BertForMaskedLM
    from deeplearning4j_tpu_torch.train import Adam

    from deeplearning4j_tpu_torch.train.updaters import tree_map
    made = []

    def make():
        if not made:       # one init (~8 s on the host); each mode starts from its params
            made.append(BertForMaskedLM(headline_config(), seed=0, device="cuda"))
            made.append(tree_map(lambda t: t.clone(), made[0].params))
        model = made[0]
        model.params = tree_map(lambda t: t.clone(), made[1])
        updater = Adam(HEADLINE_LR, mu_dtype="bf16")
        step = model.make_train_step(updater)
        opt = [updater.init(model.params)]
        gen = torch.Generator(device="cuda").manual_seed(0)

        def run(i, n):
            losses = []
            for j in range(n):
                model.params, opt[0], loss = step(model.params, opt[0],
                                                  *batches[(i + j) % len(batches)], gen)
                losses.append(loss)
            return losses
        return run, lambda: host_copy(model.params, opt[0]), lambda: None, lambda: [step]
    return make


def capture_path(card, name, make, policy=None, expect=None, graph_launches: int = 1,
                 timed_steps: int = CAPTURE_TIMED, profiled: int = CAPTURE_PROFILED) -> dict:
    """A path eager and captured in one call (``timed_steps`` timed steps
    and ``profiled`` traced ones per mode).  Under
    ``deterministic_algorithms()`` the two must give the same bits over
    ``CAPTURE_STEPS`` steps (losses or answers, params, state, updater
    state).  Then, in the default mode: the kernel launches of the capture
    call equal to an eager step's (``expect``, where given) and none
    counted on a replay, one graph and ``graph_launches`` graph launches a
    replayed step (a tBPTT batch replays its graph once a segment);
    step ms, device ms, busy share, device operations and the host's
    launches per step, peak memory; and the tensors in which the captured
    run, and a second eager run, differ from the eager one there."""
    pair = [capture_mode(c, make, policy, deterministic=True, timed=False) for c in (False, True)]
    eager, graph = (capture_mode(c, make, policy, timed_steps=timed_steps, profiled=profiled)
                    for c in (False, True))
    again = capture_mode(False, make, policy, timed=False)

    def differing(got, want):
        return [i for i, (a, b) in enumerate(zip(got["final"], want["final"]))
                if not same_bits(a, b)]
    differ = differing(pair[1], pair[0])
    result = {"path": name, "card": card, "steps_compared": CAPTURE_STEPS,
              "tensors_compared": len(pair[0]["final"]), "tensors_differ": len(differ),
              "default_mode_captured_differ": len(differing(graph, eager)),
              "default_mode_eager_rerun_differ": len(differing(again, eager))}
    for mode, r in (("eager", eager), ("captured", graph)):
        result[mode] = {k: v for k, v in r.items() if k != "final"}
    log(f"{name} on {card}: eager {eager['step_ms']:.3f} ms a step (device "
        f"{eager['device_ms']:.3f} ms, {eager['device_share_of_step']:.1%} of the step, busy "
        f"{eager['busy_share']:.1%} of the traced window, "
        f"{eager['device_ops']:.0f} device ops, {eager['kernel_launches']:.0f} kernel launches, "
        f"peak {eager['peak_memory_gib']:.2f} GiB); captured {graph['step_ms']:.3f} ms (device "
        f"{graph['device_ms']:.3f} ms, {graph['device_share_of_step']:.1%} of the step, busy "
        f"{graph['busy_share']:.1%} of the traced window, "
        f"{graph['device_ops']:.0f} device ops, {graph['graph_launches']:.0f} graph and "
        f"{graph['kernel_launches']:.0f} kernel launches, peak {graph['peak_memory_gib']:.2f} "
        f"GiB), {graph['graphs']} graph; kernels at the capture call "
        f"{graph['launches_capture_call']}, an eager step {eager['launches_capture_call']}, "
        f"replays {graph['launches_after_capture']}; deterministic algorithms: "
        f"{len(pair[0]['final'])} tensors over {CAPTURE_STEPS} steps, {len(differ)} differ; "
        f"default mode: captured {result['default_mode_captured_differ']}, a second eager run "
        f"{result['default_mode_eager_rerun_differ']} differ")
    if differ:
        raise AssertionError(f"{name}: captured steps differ from eager ones in tensors "
                             f"{differ[:10]}")
    want = eager["launches_capture_call"] if expect is None else expect
    if (graph["launches_capture_call"] != want or eager["launches_capture_call"] != want
            or graph["launches_after_capture"] or graph["launches_timed"] or graph["graphs"] != 1
            or pair[1]["graphs"] != 1 or graph["graph_launches"] != graph_launches
            or eager["graph_launches"]):
        raise AssertionError(f"{name}: launches or graphs off: {result}")
    return result


def dropout_mlp(seed: int = SMALL_SEED):
    """``mlp_mnist()`` with every layer's input dropout at retain
    probability ``CAPTURE_DROPOUT`` (its own configuration, so its own key)."""
    from deeplearning4j_tpu_torch.models import mlp_mnist
    net = mlp_mnist(device="cuda")
    for layer in net.layers:
        layer.dropout = CAPTURE_DROPOUT
    return net.init(seed=seed)


def mask_steps(net, batches, seed: int, steps: int) -> tuple:
    """``steps`` ``Trainer.fit_batch`` steps of ``net`` (a generator seeded
    ``seed``) with every dropout mask recorded; returns the losses, each
    step's masks and the trees after the last step, on the host.  A step
    that draws (eager, or the capture) records its masks; a replay draws
    into the masks recorded at the capture, so those are read again."""
    import torch
    from deeplearning4j_tpu_torch.train import Trainer
    trainer = Trainer(net)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    losses, masks, current = [], [], []
    with masks_recorded() as rec:
        for i in range(steps):
            before = len(rec.masks)
            losses.append(trainer.fit_batch(batches[i % len(batches)], gen).cpu())
            if len(rec.masks) > before:
                current = rec.masks[before:]
            masks.append([m.cpu() for m, _ in current])
    return losses, masks, host_copy(net.params_, net.state_, net.opt_state), trainer


def bits_differ(got: list, want: list) -> int:
    return sum(not same_bits(a, b) for a, b in zip(got, want)) + abs(len(got) - len(want))


def capture_checks(card: str, batches) -> dict:
    """The dropout MLP (retain ``CAPTURE_DROPOUT``) on ``batches``:
    ``CAPTURE_STEPS`` captured steps against eager ones, masks included
    (the same bits; two replays draw different masks); two nets of one
    configuration on one captured step, each against its eager twin; the
    cache's hits and misses over two ``fit`` calls and two ``eval_loss``
    calls; and two planted faults that must fail loudly: a capture
    without the generator registered (it raises), and replays without the
    new batch copied in (the bits differ)."""
    import torch
    from deeplearning4j_tpu_torch.data import ListDataSetIterator
    from deeplearning4j_tpu_torch.train import Trainer, capture, step_cache
    seed = CAPTURE_SEED
    step_cache.clear_step_cache()
    with capture.eager():
        e_loss, e_masks, e_trees, _ = mask_steps(dropout_mlp(), batches, seed, CAPTURE_STEPS)
    step_cache.clear_step_cache()
    c_loss, c_masks, c_trees, trainer = mask_steps(dropout_mlp(), batches, seed, CAPTURE_STEPS)
    graphs = step_cache.captured_graphs(trainer._step)
    w = capture.WARMUP_CALLS
    masks_differ = sum(bits_differ(c, e) for c, e in zip(c_masks, e_masks))
    fresh = bits_differ(c_masks[w], c_masks[w + 1])
    differ = bits_differ(c_loss + c_trees, e_loss + e_trees)

    # two nets of one configuration through one step, interleaved, each
    # against an eager twin on the same schedule
    schedule = ((0, 0, w + 1), (1, 0, w + 1), (0, w + 1, CAPTURE_STEPS), (1, w + 1, CAPTURE_STEPS))

    def two_nets():
        nets = [dropout_mlp(SMALL_SEED + k) for k in (1, 2)]
        trainers = [Trainer(n) for n in nets]
        gens = [torch.Generator(device="cuda").manual_seed(seed + k) for k in (1, 2)]
        losses = [[], []]
        for k, i0, i1 in schedule:
            losses[k] += [trainers[k].fit_batch(batches[i], gens[k]).cpu() for i in range(i0, i1)]
        return [losses[k] + host_copy(n.params_, n.state_, n.opt_state)
                for k, n in enumerate(nets)], trainers
    step_cache.clear_step_cache()
    with capture.eager():
        twins, _ = two_nets()
    step_cache.clear_step_cache()
    pair, trainers = two_nets()
    shared = trainers[0]._step is trainers[1]._step
    pair_graphs = step_cache.captured_graphs(trainers[0]._step)
    pair_differ = [bits_differ(a, b) for a, b in zip(pair, twins)]

    # the cache over two fit calls and two eval_loss calls
    step_cache.clear_step_cache()
    net = dropout_mlp()
    counts = [step_cache.counters()]
    for _ in range(2):
        net.fit(ListDataSetIterator(batches[:w + 2]))
        counts.append(step_cache.counters())
    for _ in range(2):
        Trainer(net).eval_loss(batches[0])
        counts.append(step_cache.counters())
    deltas = [(c[step_cache.HITS] - counts[0][step_cache.HITS],
               c[step_cache.MISSES] - counts[0][step_cache.MISSES]) for c in counts[1:]]
    cache_ok = deltas == [(0, 1), (1, 1), (1, 2), (2, 2)] and step_cache.cache_size() == 2

    # planted fault 1: the generator not registered with the graph
    step_cache.clear_step_cache()
    register = torch.cuda.CUDAGraph.register_generator_state
    torch.cuda.CUDAGraph.register_generator_state = lambda self, gen: None
    try:
        mask_steps(dropout_mlp(), batches, seed, w + 1)
        unregistered = "no error"
    except capture.CaptureError as e:
        unregistered = str(e)
    finally:
        torch.cuda.CUDAGraph.register_generator_state = register
    # planted fault 2: replays without the new batch copied in
    step_cache.clear_step_cache()
    copy_in = capture.CapturedStep._copy_in
    capture.CapturedStep._copy_in = lambda self, static, rest: None
    try:
        f_loss, _, f_trees, _ = mask_steps(dropout_mlp(), batches, seed, CAPTURE_STEPS)
    finally:
        capture.CapturedStep._copy_in = copy_in
    stale_differ = bits_differ(f_loss + f_trees, e_loss + e_trees)
    step_cache.clear_step_cache()

    result = {"card": card, "retain": CAPTURE_DROPOUT, "steps": CAPTURE_STEPS,
              "masks_per_step": [len(m) for m in c_masks], "masks_differ": masks_differ,
              "tensors_differ": differ, "replay_masks_fresh": fresh, "graphs": graphs,
              "two_nets_share_step": shared, "two_nets_graphs": pair_graphs,
              "two_nets_differ": pair_differ, "cache_deltas_hits_misses": deltas,
              "fault_unregistered_generator": unregistered,
              "fault_no_copy_in_tensors_differ": stale_differ}
    log(f"captured dropout MLP on {card} (retain {CAPTURE_DROPOUT}): {CAPTURE_STEPS} steps, "
        f"{len(e_trees) + len(e_loss)} tensors and {sum(len(m) for m in e_masks)} masks against "
        f"eager, {differ} and {masks_differ} differ; two replays' masks differ in {fresh} of "
        f"{len(c_masks[w])}; {graphs} graph; two nets share one step: {shared} ({pair_graphs} "
        f"graph), tensors differing from their eager twins {pair_differ}; cache (hits, misses) "
        f"after fit, fit, eval_loss, eval_loss: {deltas}; planted faults: no generator "
        f"registered -> {unregistered[:120]!r}; no copy-in -> {stale_differ} tensors differ")
    if differ or masks_differ or fresh != len(c_masks[w]) or graphs != 1:
        raise AssertionError(f"captured dropout steps: {result}")
    if not shared or pair_graphs != 1 or any(pair_differ):
        raise AssertionError(f"two nets on one captured step: {result}")
    if not cache_ok:
        raise AssertionError(f"step cache hits and misses: {result}")
    if unregistered == "no error" or not stale_differ:
        raise AssertionError(f"a planted fault went unseen: {result}")
    return result


def shared_int8_forward(card: str) -> dict:
    """Two int8 nets of one configuration (bench_quantized's MLP shapes,
    1024 -> 1024 -> 10, whose output layer's N = 10 makes the int8 kernel
    read a row-padded copy of its weight) behind two engines that share
    one cached forward, served in turns: every answer the same bits as the
    same request served eagerly, one graph."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.quantize import quantize_net
    from deeplearning4j_tpu_torch.serve import InferenceEngine
    from deeplearning4j_tpu_torch.train import capture, step_cache
    conf = (NeuralNetConfiguration.builder().seed(SEED).list()
            .layer(L.DenseLayer(n_out=1024, activation="relu"))
            .layer(L.OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(1024)).build())
    rng = np.random.default_rng(SEED + 60)
    requests = [rng.normal(size=(BATCH, 1024)).astype(np.float32) for _ in range(CAPTURE_STEPS)]
    config.set_dtype_policy(config.DTypePolicy(param_dtype=torch.bfloat16,
                                               compute_dtype=torch.bfloat16,
                                               output_dtype=torch.bfloat16))
    try:
        nets = [quantize_net(MultiLayerNetwork(conf, device="cuda").init(seed=SEED + k),
                             calibration=requests[:1]) for k in (1, 2)]

        def serve_in_turns():
            engines = [InferenceEngine(net, max_batch=BATCH) for net in nets]
            try:
                answers = [[e.predict(x) for e in engines] for x in requests]
            finally:
                for e in engines:
                    e.shutdown()
            return answers, engines
        step_cache.clear_step_cache()
        with capture.eager():
            want, _ = serve_in_turns()
        step_cache.clear_step_cache()
        got, engines = serve_in_turns()
        shared = engines[0]._fwd is engines[1]._fwd
        graphs = step_cache.captured_graphs(engines[0]._fwd)
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
        step_cache.clear_step_cache()
    differ = sum(not np.array_equal(g, w) for gs, ws in zip(got, want) for g, w in zip(gs, ws))
    nets_differ = not np.array_equal(want[0][0], want[0][1])
    result = {"card": card, "requests": len(requests), "engines": 2, "answers_differ": differ,
              "share_one_forward": shared, "graphs": graphs, "nets_answer_differently": nets_differ}
    log(f"two int8 MLPs (1024 -> 1024 -> 10, bf16) of one configuration on {card}: two engines "
        f"served in turns share one forward: {shared} ({graphs} graph); {differ} of "
        f"{2 * len(requests)} answers differ from the eager ones; the two nets answer "
        f"differently: {nets_differ}")
    if differ or not shared or graphs != 1 or not nets_differ:
        raise AssertionError(f"two int8 nets on one captured forward: {result}")
    return result


def captured_steps(card: str) -> dict:
    """Phase 22: every training and serving step of the port through the
    step cache as CUDA graphs, against the same steps eager (module
    docstring)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import (lenet, lstm_classifier, mlp_mnist,
                                                 text_gen_lstm, vgg16)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.quantize import quantize_net
    from deeplearning4j_tpu_torch.train import Nesterovs
    n = CAPTURE_STEPS
    rng = np.random.default_rng(0)      # bench.py's bench_workload_steps data first

    def small(shape, size=SMALL_BATCH):
        return [DataSet(torch.from_numpy(rng.normal(size=(size,) + shape).astype(np.float32))
                        .cuda(), torch.eye(10, device="cuda")[rng.integers(0, 10, size)])
                for _ in range(n)]
    mlp_batches, lenet_batches = small((784,)), small((32, 32, 3))
    gen = torch.Generator(device="cuda").manual_seed(CAPTURE_SEED)
    images = [torch.randn(BATCH, 224, 224, 3, device="cuda", generator=gen) for _ in range(n)]
    labels = [torch.eye(1000, device="cuda")[torch.randint(0, 1000, (BATCH,), device="cuda",
                                                           generator=gen)] for _ in range(n)]
    hb = headline_batch(headline_config().vocab_size)
    ft_labels = [torch.eye(FT_CLASSES, device="cuda")[torch.randint(
        0, FT_CLASSES, (BATCH,), device="cuda", generator=gen)] for _ in range(n)]
    bert_batches = [[torch.as_tensor(np.roll(hb[k], i, axis=0), device="cuda").to(dt) for k, dt in
                     (("input_ids", torch.long), ("labels", torch.long),
                      ("label_weights", torch.float32), ("attention_mask", torch.float32))]
                    for i in range(n)]
    ids, stack_labels, stack_mask = stack_batch()
    stack_batches = [DataSet(torch.from_numpy(np.roll(ids, 97 * i, axis=1)).cuda(),
                             torch.from_numpy(stack_labels).cuda(),
                             torch.from_numpy(stack_mask).cuda()) for i in range(n)]
    bf16_params = config.DTypePolicy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                                     output_dtype=torch.bfloat16)
    paths = [
        capture_path(card, f"MLP-MNIST fit, batch {SMALL_BATCH}",
                     fit_path(lambda: mlp_mnist(device="cuda").init(seed=SMALL_SEED),
                              mlp_batches), expect={}),
        capture_path(card, f"LeNet(32, 32, 3) fit, batch {SMALL_BATCH}",
                     fit_path(lambda: lenet(height=32, width=32, channels=3, device="cuda")
                              .init(seed=SMALL_SEED),
                              lenet_batches),
                     expect={}),
        capture_path(card, f"ResNet-50 f32 Trainer.fit_batch, batch {BATCH}",
                     trainer_path(lambda: build_net(Nesterovs(TRAIN_LR, 0.9)),
                                  [DataSet(x, y) for x, y in zip(images, labels)], CAPTURE_SEED),
                     expect={"matmul_bn_act": 36, "matmul_bn_act_bwd": 36}),
        capture_path(card, f"ResNet-50 frozen fine-tune Trainer.fit_batch (stem-res4 frozen, "
                     f"AdamW head, schedules), batch {BATCH}",
                     trainer_path(lambda: finetune_net(finetune_backbone()),
                                  [DataSet(x, y) for x, y in zip(images, ft_labels)],
                                  CAPTURE_SEED), expect=FT_LAUNCHES),
        capture_path(card, f"BERT-base MLM seq-128 headline make_train_step, {HEADLINE_SEQS} x "
                     f"{HEADLINE_SEQ}, bf16", bert_path(bert_batches),
                     policy=config.DTypePolicy.bf16(), expect={}),
        capture_path(card, f"config-first encoder Trainer.fit_batch, {BERT_BATCH} x {BERT_SEQ}, "
                     f"bf16 params", trainer_path(
                         lambda: ComputationGraph(stack_conf(), device="cuda").init(),
                         stack_batches, CAPTURE_SEED), policy=bf16_params,
                     expect={"flash_attention": STACK_BLOCKS, "flash_attention_bwd": STACK_BLOCKS}),
    ]
    del images, labels, ft_labels, bert_batches, stack_batches
    requests = [rng.normal(size=(BATCH, 224, 224, 3)).astype(np.float32) for _ in range(n)]
    net = build_net()
    paths.append(capture_path(card, f"ResNet-50 f32 served, batch {BATCH}",
                              engine_path(net, requests), expect={"matmul_bn_act": 36}))
    del net
    config.set_dtype_policy(bf16_params)     # bench_quantized's serving policy, as phase 17
    try:
        calib = [rng.normal(size=(VGG_CALIB[1], 224, 224, 3)).astype(np.float32)
                 for _ in range(VGG_CALIB[0])]
        qnet = quantize_net(vgg16(device="cuda").init(seed=SEED), calibration=calib)
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    paths.append(capture_path(card, f"VGG-16 int8 served, batch {BATCH}, bf16",
                              engine_path(qnet, requests), policy=bf16_params,
                              expect={"int8_matmul": 3}))
    del qnet
    har = [DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
           for x, y in har_batches(n)]
    paths.append(capture_path(card, f"UCI-HAR lstm_classifier Trainer.fit_batch, {HAR_BATCH} x "
                              f"{HAR_T} x {HAR_CHANNELS}",
                              trainer_path(lambda: lstm_classifier(device="cuda")
                                           .init(seed=SMALL_SEED), har, CAPTURE_SEED),
                              expect={}))
    del har
    chars = char_batches(n, CHAR_CAPTURE_T)
    segments = CHAR_CAPTURE_T // CHAR_SEGMENT
    paths.append(capture_path(card, f"char-RNN text_gen_lstm tBPTT fit, {CHAR_BATCH} x "
                              f"{CHAR_CAPTURE_T} ({segments} segments)",
                              fit_path(lambda: text_gen_lstm(device="cuda")
                                       .init(seed=SMALL_SEED), chars),
                              expect={}, graph_launches=segments,
                              timed_steps=CHAR_TIMED, profiled=1))
    del chars
    checks = capture_checks(card, small((784,)))
    shared = shared_int8_forward(card)
    fit = bert_fit_modes(card)
    return {"paths": paths, "checks": checks, "shared_int8_forward": shared, "bert_fit": fit}


def bert_fit_modes(card: str) -> dict:
    """``BertForMaskedLM.fit`` of the seq-128 headline (its feeder and
    bus), eager and captured: step ms after the first ``w + 1`` steps (the
    warm-up calls and the capture), the graph its step holds, finite
    losses (the bits are held by ``capture_path``'s run of its step)."""
    import numpy as np
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.models import BertForMaskedLM
    from deeplearning4j_tpu_torch.train import Adam, capture
    import contextlib
    w = capture.WARMUP_CALLS
    batch = headline_batch(headline_config().vocab_size)
    out = {}
    config.set_dtype_policy(config.DTypePolicy.bf16())
    try:
        for mode in ("eager", "captured"):
            with capture.eager() if mode == "eager" else contextlib.nullcontext():
                model = BertForMaskedLM(headline_config(), seed=0, device="cuda")
                watch = StepWatch()
                model.fit([batch] * (w + 1 + CAPTURE_STEPS), listeners=[watch],
                          updater=Adam(HEADLINE_LR, mu_dtype="bf16"))
                out[mode] = {"step_ms": float(np.mean(watch.seconds[w + 1:])) * 1e3,
                             "losses": watch.losses, "graphs": model._step.graph_count}
                del model
    finally:
        config.set_dtype_policy(config.DTypePolicy.f32())
    log(f"BERT-base seq-128 headline through fit (DeviceFeeder, ListenerBus) on {card}: "
        f"eager {out['eager']['step_ms']:.2f} ms a step, captured {out['captured']['step_ms']:.2f} "
        f"ms ({out['captured']['graphs']} graph), over {CAPTURE_STEPS} steps after {w + 1} "
        f"(default mode, so the losses are not held to each other: "
        f"{out['eager']['losses']} and {out['captured']['losses']})")
    if out["captured"]["graphs"] != 1 or not np.isfinite(out["captured"]["losses"]).all():
        raise AssertionError(f"BERT fit captured: {out}")
    return out


# ------------------------------ phase 23: the recurrent nets (nn/layers/recurrent.py)
# BASELINE config 3 at bench.py:499-502's shape: lstm_classifier(timesteps=128)
# (GravesLSTM(128) -> LastTimeStep -> OutputLayer(6)), batch 64 x 128 x 9 from
# bench_workload_steps' numpy stream after MLP-MNIST's and LeNet's arrays
HAR_BATCH, HAR_T, HAR_CHANNELS, HAR_CLASSES = 64, 128, 9, 6
HAR_EPOCHS = 2
# synthetic UCI-HAR after 2 epochs (126 steps): chance is 1/6, and the bar is
# 3x chance.  Adam(5e-3) on this data spikes now and then (loss 0.03 -> 1.19 in
# 2 steps); the card and the CPU agree to 4 digits for ~20 steps and then
# spike at other steps: the CPU ended at loss 0.02, accuracy 1.0000, the H100
# (eager and captured bit for bit equal over all 126 steps) inside a spike at
# loss 0.94, accuracy 0.8200.  The bar holds what a spike leaves
HAR_ACCURACY = 0.5
# the char-RNN: text_gen_lstm() at its defaults (vocab 77, 2 x GravesLSTM(256),
# tBPTT 50/50) on DL4J's char-modelling example's shape, 32 sequences of 1000
# characters, so 20 segments a batch.  The text is a seeded Markov chain in
# which each character is followed by one of CHAR_BRANCH others: the loss can
# fall from ln 77 = 4.34 towards ln 3 = 1.10
CHAR_VOCAB, CHAR_BATCH, CHAR_T, CHAR_SEGMENT = 77, 32, 1000, 50
CHAR_SEGMENTS = CHAR_T // CHAR_SEGMENT
CHAR_BRANCH, CHAR_SEED = 3, SEED + 60
CHAR_FITS = 4            # net.fit calls, one batch each
# phase 22 holds the tBPTT fit eager against captured on sequences of 250 (5
# segments a batch: an eager batch of 1000 takes ~3.6 s on the H100, and the
# path runs 19 of them eagerly), with CHAR_TIMED timed fit calls per mode
CHAR_CAPTURE_T, CHAR_TIMED = 250, 3
CHAR_SAMPLE = 200        # characters sampled through rnn_time_step
# rnn_time_step one step at a time against output of the whole sequence, max
# |diff| of the probabilities: the cells run the same arithmetic; only the
# input projection's product is one row against 200 (cuBLAS may sum K in
# another order), and that rounding goes through 200 steps of the recurrence
RNN_STEP_TOL = 1e-5


def har_batches(n: int) -> list:
    """``n`` batches of ``HAR_BATCH`` sequences, bench.py's stream: the
    first is ``lstm_har_step_ms``'s batch."""
    import numpy as np
    rng = np.random.default_rng(0)
    for shape in ((784,), (32, 32, 3)):       # MLP-MNIST's and LeNet's draws first
        rng.normal(size=(SMALL_BATCH,) + shape)
        rng.integers(0, 10, SMALL_BATCH)
    out = []
    for _ in range(n):
        x = rng.normal(size=(HAR_BATCH, HAR_T, HAR_CHANNELS)).astype(np.float32)
        out.append((x, np.eye(HAR_CLASSES, dtype=np.float32)[rng.integers(0, HAR_CLASSES,
                                                                          HAR_BATCH)]))
    return out


def char_chain():
    """The Markov chain's table: row c lists the ``CHAR_BRANCH`` characters
    that may follow c."""
    import numpy as np
    return np.random.default_rng(CHAR_SEED).integers(0, CHAR_VOCAB, (CHAR_VOCAB, CHAR_BRANCH))


def char_batches(n: int, t: int = CHAR_T) -> list:
    """``n`` batches of ``CHAR_BATCH`` one-hot sequences of ``t``
    characters from :func:`char_chain` on the card, labels the next
    character."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import DataSet
    follow = char_chain()
    rng = np.random.default_rng(CHAR_SEED + 1)
    eye = torch.eye(CHAR_VOCAB, device="cuda")
    out = []
    for _ in range(n):
        ids = np.empty((CHAR_BATCH, t + 1), np.int64)
        ids[:, 0] = rng.integers(0, CHAR_VOCAB, CHAR_BATCH)
        pick = rng.integers(0, CHAR_BRANCH, (CHAR_BATCH, t))
        for j in range(t):
            ids[:, j + 1] = follow[ids[:, j], pick[:, j]]
        ids = torch.from_numpy(ids).cuda()
        out.append(DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]]))
    return out


def har_step(card: str, captured: dict) -> dict:
    """``lstm_har_step_ms``'s step: step 0 on the card against the CPU from
    the same weights (``small_step``: the loss, every gradient after the
    clip, Adam's updates printed), then 20 eager steps timed with device
    time, busy share and kernels per step; beside them phase 22's reading
    of the same step captured (``captured``)."""
    from deeplearning4j_tpu_torch.models import lstm_classifier
    from deeplearning4j_tpu_torch.train import capture
    x, y = har_batches(1)[0]
    with capture.eager():
        out = small_step(card, "lstm_classifier", lstm_classifier, {}, x, y)
    keep = ("step_ms", "device_ms", "busy_share", "device_share_of_step", "device_ops",
            "kernel_launches", "graph_launches", "peak_memory_gib")
    out["captured"] = {k: captured["captured"][k] for k in keep}
    out["eager_phase22"] = {k: captured["eager"][k] for k in keep}
    c = out["captured"]
    log(f"lstm_classifier step at {HAR_BATCH} x {HAR_T} x {HAR_CHANNELS} on {card}: eager "
        f"{out['step_ms']:.3f} ms (device {out['device_ms']:.3f} ms, busy "
        f"{out['busy_share']:.1%}, {out['device_ops_per_step']:.0f} kernels and copies); "
        f"captured (phase 22) {c['step_ms']:.3f} ms (device {c['device_ms']:.3f} ms, "
        f"{c['device_share_of_step']:.1%} of the step, {c['device_ops']:.0f} kernels and "
        f"copies in {c['graph_launches']:.0f} graph launch)")
    return out


def char_rnn(card: str) -> dict:
    """The char-RNN through ``net.fit``: ``CHAR_FITS`` calls on batches of
    ``CHAR_BATCH`` x ``CHAR_T`` (the loss of each call's last segment must
    fall from the first call to the last; each batch ``CHAR_SEGMENTS``
    segments, one captured graph; ms per batch), one more batch eagerly,
    then ``CHAR_SAMPLE`` characters sampled one at a time through
    ``rnn_time_step``, held to ``output`` of the whole sampled sequence."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import ListDataSetIterator
    from deeplearning4j_tpu_torch.models import text_gen_lstm
    from deeplearning4j_tpu_torch.train import capture, step_cache
    step_cache.clear_step_cache()
    batches = char_batches(CHAR_FITS + 1)
    net = text_gen_lstm(device="cuda").init(seed=SMALL_SEED)
    losses, ms, segments = [], [], []
    for i in range(CHAR_FITS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ListDataSetIterator([batches[i]]))
        losses.append(net.score())
        ms.append((time.perf_counter() - t0) * 1e3)
        (step,) = step_cache.cached_steps()
        segments.append(step.calls - sum(segments))
    graphs = step_cache.captured_graphs(step)
    with capture.eager():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ListDataSetIterator([batches[-1]]))
        eager_loss = net.score()
        eager_ms = (time.perf_counter() - t0) * 1e3
    # sampling: one stream, seeded, from character 0
    gen = torch.Generator(device="cuda").manual_seed(CHAR_SEED)
    eye = torch.eye(CHAR_VOCAB, device="cuda")
    net.rnn_clear_previous_state()
    ids, probs = [0], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CHAR_SAMPLE):
        p = net.rnn_time_step(eye[ids[-1]][None])
        probs.append(p)
        ids.append(int(torch.multinomial(p[0], 1, generator=gen)))
    sample_ms = (time.perf_counter() - t0) * 1e3 / CHAR_SAMPLE
    steps = torch.stack(probs, 1)
    whole = net.output(eye[torch.tensor(ids[:-1], device="cuda")][None])
    step_err = (steps - whole).abs().max().item()
    follow = char_chain()
    legal = float(np.mean([b in follow[a] for a, b in zip(ids[:-1], ids[1:])]))
    result = {"card": card, "batch": CHAR_BATCH, "timesteps": CHAR_T,
              "segment": net.conf.tbptt_fwd_length, "losses_per_fit": losses,
              "ms_per_batch": ms, "segments_per_batch": segments, "graphs": graphs,
              "eager_ms_per_batch": eager_ms, "eager_loss": eager_loss,
              "sampled": ids[1:], "sample_ms_per_char": sample_ms,
              "rnn_time_step_vs_output_max_abs": step_err, "sampled_legal_share": legal,
              "chance_legal_share": CHAR_BRANCH / CHAR_VOCAB}
    log(f"char-RNN text_gen_lstm (vocab {CHAR_VOCAB}, 2 x GravesLSTM(256)) tBPTT on {card}: "
        f"{CHAR_FITS} fit calls of {CHAR_BATCH} x {CHAR_T}, losses "
        f"{[round(v, 4) for v in losses]}, "
        f"segments a batch {segments}, {graphs} graph, ms per batch "
        f"{[round(v, 1) for v in ms]} (eager {eager_ms:.1f}); rnn_time_step: {CHAR_SAMPLE} "
        f"characters sampled at {sample_ms:.3f} ms each, {legal:.1%} of them a transition "
        f"of the chain (chance {CHAR_BRANCH / CHAR_VOCAB:.1%}), against output of the whole "
        f"sequence max |diff| {step_err:.2e} (limit {RNN_STEP_TOL})")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0] and graphs == 1
            and segments == [CHAR_SEGMENTS] * CHAR_FITS
            and step_err <= RNN_STEP_TOL):
        raise AssertionError(f"char-RNN check failed: {result}")
    return result


def recurrent_nets(card: str, captured: list) -> dict:
    """Phase 23: the UCI-HAR classifier's step (``har_step``) and its
    examples' flow (``datasets.uci_har`` into 2 epochs of ``fit``, then
    ``evaluate`` on the card and, with the same weights, on the CPU), and
    the char-RNN (``char_rnn``)."""
    from deeplearning4j_tpu_torch.data import datasets
    from deeplearning4j_tpu_torch.models import lstm_classifier
    path = next(p for p in captured if p["path"].startswith("UCI-HAR"))
    out = {"step": har_step(card, path)}
    release()
    out["flow"] = small_flow(card, "lstm_classifier", lstm_classifier, {},
                             datasets.uci_har(batch_size=HAR_BATCH),
                             datasets.uci_har(batch_size=HAR_BATCH, train=False), HAR_EPOCHS)
    if not out["flow"]["accuracy"] > HAR_ACCURACY:
        raise AssertionError(f"lstm_classifier accuracy {out['flow']['accuracy']} on synthetic "
                             f"UCI-HAR after {HAR_EPOCHS} epochs, not above {HAR_ACCURACY}")
    release()
    out["char_rnn"] = char_rnn(card)
    return out


# Phase 24: fine-tune ResNet-50 with early stopping, checkpoints and a resume.
# The fine-tune (DL4J's transfer-learning recipe): a seeded 1000-class
# backbone's params and state carried into a 5-class net, its stem and
# res2-res4 (13 FusedBottlenecks) frozen, the head on an AdamW of its own
# (a 4-step ramp over a decaying rate), the rest on the net's Nesterovs
# whose rate halves every FT_BOUNDARY steps; f32, batch 32, seeded images.
FT_CLASSES, FT_TRAIN, FT_VAL = 5, 12, 2       # classes; training and validation batches
FT_EPOCHS, FT_PATIENCE = 3, 1                 # MaxEpochs, ScoreImprovement
FT_EVERY, FT_KEEP = 5, 2                      # checkpoint every 5 iterations, keep 2
FT_RESUME_EPOCHS, FT_STOP = 2, 17             # the interrupted run: 2 epochs, stopped after 17
FT_BOUNDARY = 8                               # the Nesterovs rate halves every 8 steps
FT_SEED = SEED + 70
FT_FROZEN = ("stem", "res2_", "res3_", "res4_")
FT_CHECK_STEPS = 10                           # captured against eager, across step 8
FT_LAUNCHES = {"matmul_bn_act": 36, "matmul_bn_act_bwd": 36}   # per eager step
VGG_FT_FROZEN, VGG_FT_STEPS = 19, 5           # EditLastLayerOthersFrozen: layers 0-19 frozen
VGG_FT_LR = 5e-5       # the example's Nesterovs rate (VGG-16's own 1e-2 diverges on the new head)


class _Preempted(Exception):
    """The interrupted run's stop, raised by a listener after ``FT_STOP``."""


def finetune_backbone():
    """The "pretrained" backbone: the seeded 1000-class ResNet-50 of the
    other phases (residual gammas damped)."""
    return build_net()


def finetune_net(backbone):
    """The fine-tune net (phase 24's comment) with ``backbone``'s params and
    state copied into every vertex but the head."""
    from deeplearning4j_tpu_torch.models import resnet50
    from deeplearning4j_tpu_torch.train import (AdamW, ExponentialSchedule, Nesterovs,
                                                RampSchedule, StepSchedule)
    net = resnet50(num_classes=FT_CLASSES, fused=True, device="cuda", updater=Nesterovs(
        StepSchedule(initial_value=1e-2, decay_rate=0.5, step=FT_BOUNDARY), 0.9))
    for spec in net._topo:
        if spec.kind == "layer":
            spec.obj.frozen = spec.name.startswith(FT_FROZEN)
            if spec.name == "out":
                spec.obj.updater = AdamW(RampSchedule(
                    underlying=ExponentialSchedule(initial_value=1e-3, gamma=0.99),
                    num_iterations=4))
    net.init(seed=FT_SEED)
    for tree, source in ((net.params_, backbone.params_), (net.state_, backbone.state_)):
        for name, d in source.items():
            if name != "out":
                for k, t in d.items():
                    tree[name][k].copy_(t)
    return net


def finetune_data():
    """``FT_TRAIN`` training and ``FT_VAL`` validation batches of seeded
    images (host arrays; the trainer's feeder stages them)."""
    import numpy as np
    from deeplearning4j_tpu_torch.data import DataSet
    rng = np.random.default_rng(FT_SEED)

    def batch():
        return DataSet(rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32),
                       np.eye(FT_CLASSES, dtype=np.float32)[rng.integers(0, FT_CLASSES, BATCH)])
    return [batch() for _ in range(FT_TRAIN)], [batch() for _ in range(FT_VAL)]


def flip_byte(path: str) -> None:
    """The planted fault of a damaged checkpoint: one byte in the middle."""
    with open(path, "r+b") as f:
        f.seek(0, 2)
        f.seek(f.tell() // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))


class _HostCountSchedules:
    """The planted fault of the schedule module: each schedule's rate from a
    count kept on the host (a Python float made from it), as code reading
    the updater's count with ``.item()`` would; a captured step bakes the
    rate of the capture call into every replay."""

    def __enter__(self):
        import torch
        from deeplearning4j_tpu_torch.train import schedules
        self.cls, self.call, counts = schedules.BaseSchedule, schedules.BaseSchedule.__call__, {}
        call = self.call

        def on_host(sched, count):
            n = counts.get(id(sched), 0)
            counts[id(sched)] = n + 1
            rate = float(call(sched, torch.tensor(n, dtype=torch.int32)))
            return torch.full((), rate, dtype=torch.float32, device=count.device)
        self.cls.__call__ = on_host
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.call


def finetune_steps(backbone, batches, steps: int, eager: bool) -> tuple:
    """``steps`` ``Trainer.fit_batch`` steps of a fresh fine-tune net, eager
    or captured: the losses and the trees after the last step on the host,
    each eager step's launch counts, and the step ms after the capture
    call (synchronized per step)."""
    import torch
    from deeplearning4j_tpu_torch.train import Trainer, capture
    net = finetune_net(backbone)
    trainer = Trainer(net)
    losses, counts, seconds = [], [], []
    with capture.eager() if eager else contextlib.nullcontext():
        for i in range(steps):
            kernel_counts(zero=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.fit_batch(batches[i % len(batches)]).cpu())
            seconds.append(time.perf_counter() - t0)
            counts.append(launched(kernel_counts(zero=True)))
    out = losses + host_copy(net.params_, net.state_, net.opt_state)
    device = (None if eager else
              step_profile(lambda: trainer.fit_batch(batches[0]), reps=1)["device_ms"])
    del trainer, net
    torch.cuda.empty_cache()
    w = 2 if eager else 3          # the warm-up calls and the capture
    return out, counts, sum(seconds[w:]) / len(seconds[w:]) * 1e3, device


def finetune_vs_plain(backbone, batch) -> dict:
    """The fine-tune step through the kernels against the same steps
    through both plain versions, from one start (phase 6's limits; the
    frozen params' updates are zero in both)."""
    import numpy as np
    from deeplearning4j_tpu_torch.nn.layers import fused as fused_mod
    from deeplearning4j_tpu_torch.train import capture
    with capture.eager():
        kernel = train_steps(finetune_net(backbone), batch, TRAIN_STEPS)
        saved = fused_mod.matmul_bn_act
        fused_mod.matmul_bn_act = _PlainMatmulBnAct()   # comparison only
        try:
            plain = train_steps(finetune_net(backbone), batch, TRAIN_STEPS)
        finally:
            fused_mod.matmul_bn_act = saved
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(kernel["losses"], plain["losses"])]
    moved = {v: {k: u for k, u in d.items() if plain["update0"][v][k].norm() > 0}
             for v, d in kernel["update0"].items()}
    errs = update_errs(moved, plain["update0"])
    worst = max(errs.items(), key=lambda kv: kv[1])
    result = {"losses": kernel["losses"], "plain_losses": plain["losses"],
              "loss_rel_errs": loss_errs, "update_rel_err_max": worst[1],
              "update_rel_err_worst": worst[0], "params_compared": len(errs),
              "launches_per_step": kernel["launches"], "plain_launches": plain["launches"]}
    if not (loss_errs[0] <= TRAIN_LOSS0_TOL and max(loss_errs[1:]) <= TRAIN_LOSS_TOL
            and worst[1] <= TRAIN_UPDATE_TOL and np.isfinite(kernel["losses"]).all()
            and all(c == (0, 0) for c in plain["launches"])):
        raise AssertionError(f"fine-tune step through the kernels vs plain: {result}")
    return result


def finetune(card: str) -> dict:
    """Phase 24: fine-tune ResNet-50 (``finetune_net``) with early stopping,
    checkpoints and a resume, its checks, and VGG-16's transfer recipe."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import (DataSet, EarlyTerminationIterator,
                                               ListDataSetIterator, ResumableIterator)
    from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.io.model_serializer import read_training_state, restore_into
    from deeplearning4j_tpu_torch.obs.listeners import CollectScoresListener, TrainingListener
    from deeplearning4j_tpu_torch.train import Trainer
    from deeplearning4j_tpu_torch.train import early_stopping as es

    class Preempt(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score):
            if iteration == FT_STOP:
                raise _Preempted(iteration)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_finetune_"))
    out: dict = {"card": card}
    try:
        backbone = finetune_backbone()
        train, val = finetune_data()
        frozen0 = {name: {k: t.detach().to("cpu", copy=True) for k, t in d.items()}
                   for name, d in backbone.params_.items() if name.startswith(FT_FROZEN)}
        stats0 = {k: t.detach().to("cpu", copy=True)
                  for k, t in backbone.state_["res2_0"].items()}

        # the run through early stopping, checkpoints and a score listener
        net = finetune_net(backbone)
        head0 = {k: t.clone() for k, t in net.params_["out"].items()}
        scores = CollectScoresListener()
        listener = CheckpointListener(str(tmp / "es"), save_every_n_iterations=FT_EVERY,
                                      keep_last=FT_KEEP)
        conf = es.EarlyStoppingConfiguration(
            score_calculator=es.DataSetLossCalculator(ListDataSetIterator(val)),
            epoch_termination_conditions=[es.MaxEpochsTerminationCondition(FT_EPOCHS),
                                          es.ScoreImprovementEpochTerminationCondition(
                                              FT_PATIENCE)],
            model_saver=es.LocalFileModelSaver(str(tmp / "best")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = es.EarlyStoppingTrainer(conf, net, ListDataSetIterator(train),
                                         listeners=[listener, scores]).fit()
        torch.cuda.synchronize()
        es_s = time.perf_counter() - t0
        steps = len(scores.scores)
        # what the run cost beside its steps
        t0 = time.perf_counter()
        val_score = conf.score_calculator.calculate_score(net)
        val_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        path = listener.save_now(net)
        write_s = time.perf_counter() - t0
        fresh = finetune_net(backbone)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_into(fresh, path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del fresh
        zip_gb = os.path.getsize(path) / 1e9
        best = result.best_model
        best_out = best.output(val[0].features)
        checks = {
            "frozen_unchanged": all(torch.equal(net.params_[n][k].cpu(), t)
                                    for n, d in frozen0.items() for k, t in d.items()),
            "frozen_bn_moved": sum(not torch.equal(net.state_["res2_0"][k].cpu(), t)
                                   for k, t in stats0.items()),
            "frozen_bn_stats": len(stats0),
            "trained_changed": sum(not torch.equal(net.params_[n][k].cpu(),
                                                   backbone.params_[n][k].cpu())
                                   for n in net.params_ if n.startswith("res5_")
                                   for k in net.params_[n]),
            "trained_params": sum(len(net.params_[n]) for n in net.params_
                                  if n.startswith("res5_")),
            "head_changed": all(not torch.equal(t, head0[k])
                                for k, t in net.params_["out"].items()),
            "best_model_finite": bool(torch.isfinite(best_out).all()),
        }
        out["early_stopping"] = {
            "termination_reason": result.termination_reason,
            "termination_details": result.termination_details,
            "best_model_epoch": result.best_model_epoch,
            "best_model_score": result.best_model_score, "total_epochs": result.total_epochs,
            "score_vs_epoch": result.score_vs_epoch, "steps": steps, "losses": scores.scores,
            "ms_per_step": es_s / steps * 1e3, "run_s": es_s, "val_pass_ms": val_ms,
            "val_score": val_score, "checkpoint_write_s": write_s,
            "checkpoint_restore_s": restore_s, "checkpoint_gb": zip_gb,
            "checkpoints_kept": sorted(os.path.basename(p) for p in listener._saved)} | checks
        log(f"fine-tune ResNet-50 (stem-res4 frozen, AdamW head, schedules) on {card}: "
            f"{result.termination_reason} ({result.termination_details}) after "
            f"{result.total_epochs} epochs, best epoch {result.best_model_epoch} "
            f"(score {result.best_model_score:.6f}); scores {result.score_vs_epoch}; {steps} "
            f"steps, {es_s / steps * 1e3:.1f} ms a step with validation and checkpoints; a "
            f"validation pass {val_ms:.1f} ms; a checkpoint ({zip_gb:.3f} GB) written in "
            f"{write_s:.2f} s, restored in {restore_s:.2f} s; frozen params unchanged: "
            f"{checks['frozen_unchanged']}; res2_0's BN statistics moved "
            f"{checks['frozen_bn_moved']} of {checks['frozen_bn_stats']}; res5 params changed "
            f"{checks['trained_changed']} of {checks['trained_params']}; head changed: "
            f"{checks['head_changed']}")
        if not (checks["frozen_unchanged"] and checks["frozen_bn_moved"] == len(stats0)
                and checks["trained_changed"] == checks["trained_params"]
                and checks["head_changed"] and checks["best_model_finite"]
                and np.isfinite(scores.scores).all()):
            raise AssertionError(f"fine-tune checks: {out['early_stopping']}")
        del net, best, result, conf, listener
        torch.cuda.empty_cache()

        # the uninterrupted fit, an interrupted one and its resumes, captured
        # and under deterministic algorithms
        with deterministic_algorithms():
            whole, whole_scores = finetune_net(backbone), CollectScoresListener()
            Trainer(whole, [whole_scores]).fit(ResumableIterator(ListDataSetIterator(train)),
                                               epochs=FT_RESUME_EPOCHS)
            want = whole_scores.scores
            want_trees = host_copy(whole.params_, whole.state_, whole.opt_state)
            del whole
            torch.cuda.empty_cache()
            run_dir = str(tmp / "run")
            cut = finetune_net(backbone)
            try:
                Trainer(cut, [CheckpointListener(run_dir, save_every_n_iterations=FT_EVERY,
                                                 keep_last=FT_KEEP), Preempt()]).fit(
                    ResumableIterator(ListDataSetIterator(train)), epochs=FT_RESUME_EPOCHS)
                raise AssertionError("the interrupted run was not interrupted")
            except _Preempted:
                pass
            del cut
            torch.cuda.empty_cache()

            def resume(expect_zip):
                newest = CheckpointListener.last_checkpoint_in(run_dir)
                start = read_training_state(newest)["iteration"]
                net = finetune_net(backbone)
                got = CollectScoresListener()
                Trainer(net, [got]).fit(ResumableIterator(ListDataSetIterator(train)),
                                        epochs=FT_RESUME_EPOCHS, resume_from=run_dir)
                trees = host_copy(net.params_, net.state_, net.opt_state)
                differ = (sum(a != b for a, b in zip(got.scores, want[start:]))
                          + abs(len(got.scores) - len(want[start:])))
                del net
                torch.cuda.empty_cache()
                return {"checkpoint": os.path.basename(newest), "expected": expect_zip,
                        "start_iteration": start, "steps": len(got.scores),
                        "losses_differ": differ,
                        "tensors_differ": bits_differ(trees, want_trees)}
            resumed = resume(f"checkpoint_iter{FT_STOP // FT_EVERY * FT_EVERY}_epoch1.zip")
            # the planted fault: the newest zip damaged, the one before it taken
            flip_byte(CheckpointListener.last_checkpoint_in(run_dir))
            fallback = resume(f"checkpoint_iter{(FT_STOP // FT_EVERY - 1) * FT_EVERY}"
                              f"_epoch{((FT_STOP // FT_EVERY - 1) * FT_EVERY) // FT_TRAIN}.zip")
        out["resume"] = {"uninterrupted_losses": want, "resumed": resumed,
                         "damaged_newest": fallback}
        log(f"interrupted after iteration {FT_STOP} (mid-epoch 1), resumed from "
            f"{resumed['checkpoint']} at iteration {resumed['start_iteration']}: "
            f"{resumed['steps']} steps, {resumed['losses_differ']} losses and "
            f"{resumed['tensors_differ']} of {len(want_trees)} tensors differ from the "
            f"uninterrupted fit (deterministic algorithms, captured); planted fault, the newest "
            f"zip damaged: resumed from {fallback['checkpoint']} at iteration "
            f"{fallback['start_iteration']}, {fallback['losses_differ']} losses and "
            f"{fallback['tensors_differ']} tensors differ")
        for r in (resumed, fallback):
            if r["checkpoint"] != r["expected"] or r["losses_differ"] or r["tensors_differ"]:
                raise AssertionError(f"resume: {out['resume']}")

        # captured against eager across the schedule's boundary, the launches
        # per eager step, and the planted fault of a rate read on the host
        batches = [DataSet(torch.from_numpy(b.features).cuda(), torch.from_numpy(b.labels).cuda())
                   for b in train[:FT_CHECK_STEPS]]
        with deterministic_algorithms():
            eager, eager_counts, eager_ms, _ = finetune_steps(backbone, batches, FT_CHECK_STEPS,
                                                              eager=True)
            graph, _, graph_ms, device_ms = finetune_steps(backbone, batches, FT_CHECK_STEPS,
                                                           eager=False)
            with _HostCountSchedules():
                f_eager = finetune_steps(backbone, batches, FT_CHECK_STEPS, eager=True)[0]
                f_graph = finetune_steps(backbone, batches, FT_CHECK_STEPS, eager=False)[0]
        out["capture"] = {"steps": FT_CHECK_STEPS, "tensors": len(eager),
                          "differ": bits_differ(graph, eager),
                          "fault_host_rate_differ": bits_differ(f_graph, f_eager),
                          "eager_launches_per_step": eager_counts,
                          "eager_step_ms": eager_ms, "captured_step_ms": graph_ms,
                          "captured_device_ms": device_ms}
        c = out["capture"]
        log(f"fine-tune step on {card}: eager {eager_ms:.3f} ms, captured {graph_ms:.3f} ms "
            f"(device {device_ms:.3f} ms); captured against eager over {FT_CHECK_STEPS} steps "
            f"across the rate's halving at step {FT_BOUNDARY} (deterministic algorithms): "
            f"{c['differ']} of {len(eager)} tensors differ; planted fault, the rate from a "
            f"host count: {c['fault_host_rate_differ']} differ; launches per eager step "
            f"{eager_counts[0]}")
        if c["differ"] or not c["fault_host_rate_differ"] or any(
                counts != FT_LAUNCHES for counts in eager_counts):
            raise AssertionError(f"fine-tune capture checks: {c}")
        out["vs_plain"] = finetune_vs_plain(backbone, batches[0])
        v = out["vs_plain"]
        log(f"fine-tune step through the kernels vs the plain versions: losses "
            f"{v['losses']} (plain {v['plain_losses']}), step-0 loss {v['loss_rel_errs'][0]:.2e}"
            f", updates of {v['params_compared']} moving params at most "
            f"{v['update_rel_err_max']:.2e} ({v['update_rel_err_worst']}); limits "
            f"{TRAIN_LOSS0_TOL}, {TRAIN_UPDATE_TOL}, {TRAIN_LOSS_TOL}")
        del backbone, batches, train, val
        torch.cuda.empty_cache()
        out["dropout_resume"] = dropout_resume(card, tmp)
        out["multi_input"] = multi_input_graph(card)
        out["vgg16"] = vgg_transfer(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def dropout_resume(card: str, tmp: Path) -> dict:
    """The dropout MLP (retain ``CAPTURE_DROPOUT``) through 2 epochs of
    ``fit`` over a ``ResumableIterator``, against the same run stopped after
    iteration 8 and resumed by a fresh net from its checkpoints: the
    random stream restored into the new trainer's generator, which its
    captured step registers, so the masks and every loss repeat bit for
    bit (deterministic algorithms)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import ListDataSetIterator, ResumableIterator
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.io.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.obs.listeners import CollectScoresListener, TrainingListener
    from deeplearning4j_tpu_torch.train import Trainer
    stop = 8

    class Preempt(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score):
            if iteration == stop:
                raise _Preempted(iteration)
    rng = np.random.default_rng(FT_SEED + 3)
    data = [DataSet(rng.standard_normal((SMALL_BATCH, 784), dtype=np.float32),
                    np.eye(10, dtype=np.float32)[rng.integers(0, 10, SMALL_BATCH)])
            for _ in range(6)]

    def run(listeners, resume_from=None):
        net, scores = dropout_mlp(), CollectScoresListener()
        Trainer(net, [*listeners, scores]).fit(ResumableIterator(ListDataSetIterator(data)),
                                               epochs=2, resume_from=resume_from)
        return scores.scores, host_copy(net.params_, net.opt_state)
    run_dir = str(tmp / "dropout")
    with deterministic_algorithms():
        want, want_trees = run([])
        try:
            run([CheckpointListener(run_dir, save_every_n_iterations=3), Preempt()])
            raise AssertionError("the interrupted run was not interrupted")
        except _Preempted:
            pass
        got, got_trees = run([], resume_from=run_dir)
    differ = sum(a != b for a, b in zip(got, want[-len(got):])) + bits_differ(got_trees,
                                                                               want_trees)
    result = {"card": card, "steps": len(want), "resumed_steps": len(got), "differ": differ}
    log(f"dropout MLP (retain {CAPTURE_DROPOUT}) interrupted after iteration {stop} and "
        f"resumed, captured: {len(got)} steps, {differ} losses and tensors differ from the "
        f"uninterrupted run")
    if differ or len(got) != len(want) - 7:
        raise AssertionError(f"dropout resume: {result}")
    return result


def multi_input_graph(card: str) -> dict:
    """A two-input graph (dense branches added, softmax) through ``fit`` on
    ``MultiDataSet`` s, whose features are a list: captured against eager
    over ``FT_CHECK_STEPS`` steps, the same bits."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import ListDataSetIterator, MultiDataSet
    from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
    from deeplearning4j_tpu_torch.train import Adam, capture, step_cache
    rng = np.random.default_rng(FT_SEED + 2)
    data = [MultiDataSet([rng.standard_normal((BATCH, 64), dtype=np.float32),
                          rng.standard_normal((BATCH, 32), dtype=np.float32)],
                         [np.eye(FT_CLASSES, dtype=np.float32)[rng.integers(0, FT_CLASSES, BATCH)]])
            for _ in range(FT_CHECK_STEPS)]

    def run(eager: bool) -> list:
        g = (NeuralNetConfiguration.builder().seed(FT_SEED).updater(Adam(1e-3)).graph()
             .add_inputs("a", "b")
             .set_input_types(InputType.feed_forward(64), InputType.feed_forward(32)))
        g.add_layer("da", DenseLayer(n_out=128, activation="relu"), "a")
        g.add_layer("db", DenseLayer(n_out=128, activation="relu"), "b")
        g.add_vertex("sum", ElementWiseVertex(op="add"), "da", "db")
        g.add_layer("out", OutputLayer(n_out=FT_CLASSES, activation="softmax", loss="mcxent"),
                    "sum")
        net = ComputationGraph(g.set_outputs("out").build(), device="cuda").init()
        step_cache.clear_step_cache()
        losses = []
        with capture.eager() if eager else contextlib.nullcontext():
            for batch in data:
                net.fit(ListDataSetIterator([batch]))
                losses.append(net._score.cpu())
        graphs = step_cache.captured_graphs(*step_cache.cached_steps())
        return losses + host_copy(net.params_, net.opt_state), graphs
    with deterministic_algorithms():
        eager, _ = run(True)
        graph, graphs = run(False)
    result = {"card": card, "steps": FT_CHECK_STEPS, "tensors": len(eager),
              "differ": bits_differ(graph, eager), "graphs": graphs}
    log(f"two-input graph fit on MultiDataSets on {card}: captured against eager over "
        f"{FT_CHECK_STEPS} steps, {result['differ']} of {len(eager)} tensors differ; "
        f"{graphs} graph")
    if result["differ"] or graphs != 1:
        raise AssertionError(f"two-input graph: {result}")
    return result


def vgg_transfer(card: str, tmp: Path) -> dict:
    """VGG-16's ``EditLastLayerOthersFrozen``: a ``FineTuneConfiguration``
    with the example's ``Nesterovs(5e-5)``, layers 0-19 frozen, the output
    layer replaced by a 5-class one; ``VGG_FT_STEPS`` steps at
    batch 32 on one batch (frozen params unchanged, the loss falling),
    then a save and load with the same output bits."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import vgg16
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.transfer import FineTuneConfiguration, TransferLearning
    from deeplearning4j_tpu_torch.train import Nesterovs, Trainer
    base = vgg16(device="cuda").init(seed=SEED)
    net = (TransferLearning.builder(base)
           .fine_tune_configuration(FineTuneConfiguration(updater=Nesterovs(VGG_FT_LR, 0.9)))
           .set_feature_extractor(VGG_FT_FROZEN)
           .remove_output_layer()
           .add_layer(OutputLayer(n_out=FT_CLASSES, activation="softmax", loss="mcxent"))
           .build())
    del base
    torch.cuda.empty_cache()
    frozen = host_copy(net.params_[:VGG_FT_FROZEN + 1])
    rng = np.random.default_rng(FT_SEED + 1)
    batch = DataSet(torch.from_numpy(rng.standard_normal((BATCH, 224, 224, 3),
                                                         dtype=np.float32)).cuda(),
                    torch.eye(FT_CLASSES, device="cuda")[rng.integers(0, FT_CLASSES, BATCH)])
    trainer = Trainer(net)
    losses = [trainer.fit_batch(batch).item() for _ in range(VGG_FT_STEPS)]
    del trainer
    unchanged = bits_differ(host_copy(net.params_[:VGG_FT_FROZEN + 1]), frozen) == 0
    path = str(tmp / "vgg16_transfer.zip")
    t0 = time.perf_counter()
    net.save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = MultiLayerNetwork.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    with deterministic_algorithms():
        same = same_bits(net.output(batch.features), back.output(batch.features))
    result = {"card": card, "frozen_layers": VGG_FT_FROZEN + 1, "losses": losses,
              "frozen_unchanged": unchanged, "save_s": save_s, "load_s": load_s,
              "zip_gb": os.path.getsize(path) / 1e9, "output_same_bits": same,
              "iteration_after_load": back.iteration}
    log(f"VGG-16 transfer (layers 0-{VGG_FT_FROZEN} frozen, a new 5-class output) on {card}: "
        f"losses {[round(v, 6) for v in losses]}, frozen params unchanged: {unchanged}; "
        f"save {save_s:.2f} s ({result['zip_gb']:.3f} GB), load {load_s:.2f} s, output "
        f"after load the same bits: {same}")
    if not (unchanged and same and losses[-1] < losses[0] and np.isfinite(losses).all()):
        raise AssertionError(f"VGG-16 transfer: {result}")
    del net, back
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------- phase 25
SS_SEED = SEED + 40
SS_HW = 224                  # the served images' side
# (b): client threads, requests, images a request (1 to this many)
SS_CLIENTS, SS_REQUESTS, SS_MAX_IMAGES = 8, 64, 4
# (c): the captured rounds send one request of this many images at a time (one
# bucket), this many times a version (two eager calls and the capture)
SS_WARM_IMAGES, SS_WARM_CALLS = 4, 3
# (c): client threads posting the one-image requests of (b) through the swaps (a
# thread decoding a body holds the interpreter lock the deploy needs too: under 2
# clients a deploy took 17-20 s, idle 4 s)
SS_SWAP_CLIENTS = 1
# (d): requests of this many images through the router and the engine alone
SS_ROUTER_REQUESTS, SS_ROUTER_IMAGES = 32, 8
# (e): the gate's held-out batches of VGG-16 images, and the online classifier
SS_HOLDOUT = (2, 16)
ONLINE_IN, ONLINE_CLASSES, ONLINE_RECORDS = 12, 3, 64


def serving_vgg16():
    """Phase 25's VGG-16: full width, seeded (the other phases' seed)."""
    from deeplearning4j_tpu_torch.models import vgg16
    return vgg16(device="cuda").init(seed=SEED)


def serving_resnet50():
    """Phase 25's ResNet-50: phase 3's seeded, fused net."""
    return build_net()


def http_call(port: int, method: str, path: str, body=None, headers=None,
              timeout: float = 300.0):
    """(status, body bytes) of one request to the loopback server."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def ok_count(port: int) -> float:
    """``tpudl_serve_requests_total{status="ok"}`` read from /metrics."""
    status, raw = http_call(port, "GET", "/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    m = re.search(r'^tpudl_serve_requests_total\{status="ok"\} (\S+)$', raw.decode(), re.M)
    return float(m.group(1)) if m else 0.0


class dispatches_recorded:
    """Comparison only: every engine dispatch's model, staged batch (a host
    copy) and output, so that each answer is held to the output of the
    very batch it was served in (phase 17's check)."""

    def __enter__(self):
        import numpy as np
        from deeplearning4j_tpu_torch.serve.engine import InferenceEngine
        self.cls, saved = InferenceEngine, InferenceEngine._forward
        self.saved, records, lock = saved, [], threading.Lock()
        self.records = records

        def recording(engine, features, mask):
            y = saved(engine, features, mask)
            with lock:
                records.append((engine.model, np.array(features), y.clone()))
            return y

        InferenceEngine._forward = recording
        return self

    def __exit__(self, *exc):
        self.cls._forward = self.saved


def hold_answers(records, answers, models) -> dict:
    """Each recorded dispatch's output equal to ``model.output`` of its
    staged batch, and each answer ``(version, images, predictions)`` equal
    to the rows of the dispatch of that version's model that served its
    images."""
    import numpy as np
    import torch
    index = {}
    for r, (model, x, y) in enumerate(records):
        direct = model.output(x)
        if not torch.equal(direct, y):
            raise AssertionError(f"dispatch {r}: the engine's output differs from output() of "
                                 f"its batch by {(direct.float() - y.float()).abs().max().item()}")
        for row in range(x.shape[0]):
            index.setdefault((id(model), x[row].tobytes()), []).append((r, row))
    for version, images, preds in answers:
        n, found = images.shape[0], False
        for r, row in index.get((id(models[version]), images[0].tobytes()), ()):
            x, y = records[r][1], records[r][2]
            if row + n <= x.shape[0] and np.array_equal(x[row:row + n], images):
                found = True
                if np.array_equal(preds, y[row:row + n].float().cpu().numpy()):
                    break
        else:
            # the images may sit in several dispatches (the engine-alone pass
            # repeats them beside other batchmates): one must give the answer
            raise AssertionError(f"an answer of version {version} equals the rows of no dispatch "
                                 f"of that version's model that served its images "
                                 f"(served: {found})")
    return {"dispatches": len(records), "answers": len(answers)}


def percentiles(seconds) -> dict:
    import numpy as np
    ms = np.asarray(seconds) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}


def vgg_requests(rng, count: int, max_images: int):
    """``count`` seeded requests of 1 to ``max_images`` VGG images, and their
    JSON bodies, encoded before any clock starts.  Every image is one
    seeded N(0, 1) base image with a row of its own (row 0), so that each
    image is distinct (an answer is found by its images) while the client
    encodes the shared rows once; the server decodes every body whole."""
    import numpy as np
    base = rng.normal(size=(SS_HW, SS_HW, 3)).astype(np.float32)
    rest = json.dumps(base[1:].tolist())[1:-1]
    images, bodies = [], []
    for n in rng.integers(1, max_images + 1, size=count):
        x = np.repeat(base[None], int(n), axis=0)
        x[:, 0] = rng.normal(size=(int(n), SS_HW, 3)).astype(np.float32)
        rows = ",".join(f"[{json.dumps(img[0].tolist())},{rest}]" for img in x)
        images.append(x)
        bodies.append(f'{{"instances": [{rows}]}}'.encode())
    return images, bodies


def post_clients(port, images, bodies, threads: int, answers: list, failures: list,
                 stop=None, path: str = "/v1/models/vgg16:predict"):
    """``threads`` clients POST the bodies (each thread every ``threads``-th,
    round after round while ``stop`` is given and not set); each answer is
    appended as (version, images, predictions, seconds), each other status
    to ``failures``.  Returns the wall seconds."""
    import numpy as np
    lock = threading.Lock()

    def client(j):
        while True:
            for i in range(j, len(bodies), threads):
                t0 = time.perf_counter()
                status, raw = http_call(port, "POST", path, bodies[i])
                dt = time.perf_counter() - t0
                with lock:
                    if status != 200:
                        failures.append((status, raw[:300]))
                    else:
                        body = json.loads(raw)
                        answers.append((body["model_version"], images[i],
                                        np.asarray(body["predictions"], np.float32), dt))
                if stop is not None and stop.is_set():
                    return
            if stop is None:
                return

    workers = [threading.Thread(target=client, args=(j,)) for j in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=900)
    if any(w.is_alive() for w in workers):
        raise AssertionError("HTTP clients did not finish")
    return time.perf_counter() - t0


class HealthPoller:
    """GET /healthz every 10 ms from a thread; ``readings`` are (sent,
    answered, status) on the monotonic clock."""

    def __init__(self, port: int):
        self.port, self.readings = port, []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run)
        self.thread.start()

    def _run(self):
        while not self.stop.is_set():
            t0 = time.monotonic()
            status, _ = http_call(self.port, "GET", "/healthz")
            self.readings.append((t0, time.monotonic(), status))
            self.stop.wait(0.01)

    def close(self):
        self.stop.set()
        self.thread.join(timeout=60)


def record_swaps(registry) -> list:
    """Comparison only: the registry's readiness windows (monotonic
    start, end), appended as each swap ends."""
    windows, saved = [], registry._swap

    @contextlib.contextmanager
    def swap():
        t0 = time.monotonic()
        with saved():
            yield
        windows.append((t0, time.monotonic()))

    registry._swap = swap
    return windows


def vgg_http(card, registry, server, models, images, bodies, counters) -> dict:
    """25 (b): the clients over HTTP against the int8 VGG-16, then the same
    requests through its engine alone."""
    import numpy as np
    from deeplearning4j_tpu_torch.ops.kernels import quant_matmul as qm
    reg = counters["metrics"]
    batches0, launches0 = reg.counter("tpudl_serve_batches_total").value, qm.launches
    answers, failed = [], []
    wall = post_clients(server.port, images, bodies, SS_CLIENTS, answers, failed)
    if failed:
        raise AssertionError(f"HTTP requests failed: {failed[:3]}")
    batches = reg.counter("tpudl_serve_batches_total").value - batches0
    launches = qm.launches - launches0
    ok = ok_count(server.port)
    status, _ = http_call(server.port, "GET", "/healthz")
    if ok != len(bodies) or status != 200:
        raise AssertionError(f"/metrics counts {ok} ok of {len(bodies)} requests sent; /healthz "
                             f"{status}")
    if launches != 3 * batches or batches == 0:
        raise AssertionError(f"int8_matmul launched {launches} times for {batches} batches")
    engine = registry.get("vgg16").engine
    alone: list = []

    def client(j):
        for i in range(j, len(images), SS_CLIENTS):
            t0 = time.perf_counter()
            engine.predict(images[i], timeout_s=300)
            alone.append(time.perf_counter() - t0)

    workers = [threading.Thread(target=client, args=(j,)) for j in range(SS_CLIENTS)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=600)
    alone_wall = time.perf_counter() - t0
    n_images = int(sum(x.shape[0] for x in images))
    result = {"requests": len(bodies), "images": n_images, "batches": int(batches),
              "launches": int(launches), "wall_s": wall,
              "requests_per_s": len(bodies) / wall, "images_per_s": n_images / wall,
              **percentiles([a[3] for a in answers]),
              "body_mb_mean": float(np.mean([len(b) for b in bodies]) / 1e6),
              "engine_alone": {"wall_s": alone_wall, "requests_per_s": len(images) / alone_wall,
                               "images_per_s": n_images / alone_wall, **percentiles(alone)}}
    log(f"  (b) HTTP on {card}: {len(bodies)} requests ({n_images} images, JSON bodies of "
        f"{result['body_mb_mean']:.2f} MB on average) from {SS_CLIENTS} threads in "
        f"{wall:.2f} s: {result['requests_per_s']:.2f} requests/s, "
        f"{result['images_per_s']:.1f} images/s, latency p50 {result['p50_ms']:.1f} ms, p99 "
        f"{result['p99_ms']:.1f} ms; {int(batches)} batches, {int(launches)} int8_matmul "
        f"launches; /metrics ok {ok:.0f}, /healthz {status}")
    log(f"      the same requests through the engine alone: "
        f"{result['engine_alone']['requests_per_s']:.2f} requests/s, "
        f"{result['engine_alone']['images_per_s']:.1f} images/s, p50 "
        f"{result['engine_alone']['p50_ms']:.1f} ms, p99 {result['engine_alone']['p99_ms']:.1f} ms")
    return result, [(v, x, p) for v, x, p, _ in answers]


def timed_deploy(registry, name, models, *args, **kw):
    """``registry.deploy`` (or ``rollback`` with no path), its seconds and
    the new version's model noted in ``models``."""
    t0 = time.perf_counter()
    entry = (registry.deploy(name, *args, **kw) if args else registry.rollback(name))
    seconds = time.perf_counter() - t0
    models[entry.version] = entry.engine.model
    return entry, seconds


def vgg_swaps(card, registry, server, models, images, bodies, vgg_zip) -> dict:
    """25 (c): a hot swap to the full-precision VGG-16 and a rollback to int8
    under the clients' load, /healthz polled throughout; no request may
    fail and each answer must be its version's."""
    answers, failures, stop = [], [], threading.Event()
    windows = record_swaps(registry)
    poller = HealthPoller(server.port)
    ones = [i for i, x in enumerate(images) if x.shape[0] == 1]
    load = threading.Thread(target=lambda: post_clients(
        server.port, [images[i] for i in ones], [bodies[i] for i in ones], SS_SWAP_CLIENTS,
        answers, failures, stop=stop))
    load.start()

    def wait_for(version, count):
        deadline = time.monotonic() + 300
        while sum(1 for a in answers if version is None or a[0] == version) < count:
            if failures or time.monotonic() > deadline:
                raise AssertionError(f"waiting for {count} answers of version {version}: "
                                     f"{len(answers)} answers, failures {failures[:3]}")
            time.sleep(0.05)

    try:
        wait_for(None, 8)
        fp, fp_s = timed_deploy(registry, "vgg16", models, vgg_zip)
        n_fp = len(answers)
        wait_for(fp.version, 8)
        back, back_s = timed_deploy(registry, "vgg16", models)
        n_back = len(answers)
        wait_for(back.version, 8)
    finally:
        stop.set()
        load.join(timeout=900)
        poller.close()
    del registry._swap
    if failures:
        raise AssertionError(f"{len(failures)} requests failed across the swaps: {failures[:3]}")
    if back.precision != "int8" or fp.precision != "bf16":
        raise AssertionError(f"swap precisions {fp.precision}, {back.precision}")
    outside = [(t0, t1) for t0, t1, s in poller.readings if s == 503
               and not any(t0 <= w1 and t1 >= w0 for w0, w1 in windows)]
    unready = sum(1 for *_, s in poller.readings if s == 503)
    if outside or any(s not in (200, 503) for *_, s in poller.readings):
        raise AssertionError(f"/healthz read 503 outside the swap windows {outside[:3]}")
    versions = sorted({a[0] for a in answers})
    result = {"answers": len(answers), "versions": versions, "failed": 0,
              "deploy_fp_s": fp_s, "rollback_int8_s": back_s,
              "swap_windows_s": [w1 - w0 for w0, w1 in windows],
              "healthz_readings": len(poller.readings), "healthz_503": unready,
              "answers_during": {"int8_before": n_fp, "after_rollback": len(answers) - n_back}}
    log(f"  (c) hot swap under load ({SS_SWAP_CLIENTS} clients posting one-image requests) on "
        f"{card}: {len(answers)} answers from versions {versions}, "
        f"none failed; deploy fp (load, verify, engine, flip, drain) {fp_s:.2f} s, rollback to "
        f"int8 (load, verify, quantize, flip, drain) {back_s:.2f} s; readiness windows "
        f"{[round(w, 3) for w in result['swap_windows_s']]} s; /healthz {unready} x 503 of "
        f"{len(poller.readings)} readings, all inside them")
    return result, [(v, x, p) for v, x, p, _ in answers]


def vgg_captured_rounds(card, registry, server, models, vgg_zip, rng, counters) -> dict:
    """25 (c), captured: one bucket of int8 and of fp warmed (captured), then
    a second round int8 -> fp through rollback and deploy that must capture
    no new graph; each switch of trees on the shared graph is counted."""
    import numpy as np
    reg = counters["metrics"]
    x = rng.normal(size=(SS_WARM_IMAGES, SS_HW, SS_HW, 3)).astype(np.float32)
    body = json.dumps({"instances": x.tolist()}).encode()
    answers = []

    def calls(n):
        for _ in range(n):
            status, raw = http_call(server.port, "POST", "/v1/models/vgg16:predict", body)
            if status != 200:
                raise AssertionError(f"captured round: {status} {raw[:300]}")
            out = json.loads(raw)
            answers.append((out["model_version"], x, np.asarray(out["predictions"], np.float32)))

    calls(SS_WARM_CALLS)                                   # the int8 version: its graph
    timed_deploy(registry, "vgg16", models, vgg_zip)
    calls(SS_WARM_CALLS)                                   # the fp version: its graph
    step = registry.get("vgg16").engine._fwd
    graphs0, switches0 = step.graph_count, step.switches
    recaptures0 = reg.counter("tpudl_serve_recompiles_total").value
    back, back_s = timed_deploy(registry, "vgg16", models)         # int8 again
    calls(SS_WARM_CALLS)
    fp, fp_s = timed_deploy(registry, "vgg16", models, vgg_zip)    # fp again
    calls(SS_WARM_CALLS)
    engine = registry.get("vgg16").engine
    result = {"graphs_before": graphs0, "graphs_after": engine.compiled_programs,
              "recaptures": reg.counter("tpudl_serve_recompiles_total").value - recaptures0,
              "switches": step.switches - switches0, "rollback_s": back_s, "deploy_s": fp_s,
              "versions": [back.version, fp.version]}
    log(f"  (c) captured second round int8 -> fp (versions {result['versions']}) on {card}: "
        f"graphs {graphs0} -> {result['graphs_after']}, new captures "
        f"{result['recaptures']:.0f}, tree switches on the shared graph {result['switches']} "
        f"(each a copy of one net's trees into the graph's buffers); rollback {back_s:.2f} s, "
        f"deploy {fp_s:.2f} s")
    if result["graphs_after"] != graphs0 or result["recaptures"] or graphs0 < 2 \
            or step is not engine._fwd:
        raise AssertionError(f"the second round captured a new graph: {result}")
    return result, answers


def vgg_faults(card, registry, server, rng, counters) -> dict:
    """25 (f): a planted dispatch fault (its batch's requests fail with
    error_status's code, the next batch succeeds, the errors counted equal
    the planted ones, and a flight-recorder dump holds the serve_error
    event and the serve spans with their device-sync time); and a planted
    int8 launch failure (a 5xx, no answer from the plain version)."""
    import numpy as np
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.obs import flight_recorder, tracing
    from deeplearning4j_tpu_torch.ops.kernels import quant_matmul as qm
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.serve.server import error_status
    reg = counters["metrics"]
    if registry.get("vgg16").precision != "int8":
        raise AssertionError("the fault checks need the int8 version serving")
    x = rng.normal(size=(2, SS_HW, SS_HW, 3)).astype(np.float32)
    body = json.dumps({"instances": x.tolist()}).encode()
    requests = reg.labeled_counter("tpudl_serve_requests_total")
    errors0 = requests.labeled_value(status="error")
    flight_recorder.get_recorder().clear()
    config.set_config(tracing=True)
    tracer = tracing.Tracer()
    try:
        with tracing.use_tracer(tracer), faults.inject("serve.dispatch@2:error"):
            statuses = [http_call(server.port, "POST", "/v1/models/vgg16:predict", body)[0]
                        for _ in range(4)]
    finally:
        config.set_config(tracing=False)
    errors = requests.labeled_value(status="error") - errors0
    want = error_status(faults.InjectedFault("x"))
    if statuses != [200, 200, want, 200] or errors != 1:
        raise AssertionError(f"planted dispatch fault: statuses {statuses} (want the third "
                             f"{want}), {errors} errors counted for 1 planted")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    dump = out_dir / "flight_phase25.jsonl"
    dump.unlink(missing_ok=True)
    flight_recorder.dump(str(dump), reason="phase 25 planted dispatch fault")
    lines = flight_recorder.read_dump(str(dump))
    events = [ln for ln in lines if ln.get("type") == "event"]
    serve_errors = [e for e in events if e["kind"] == "serve_error"]
    spans = [e for e in events if e["kind"] == "span" and e["name"] == "serve"]
    if [ln["type"] for ln in lines[:2]] != ["header", "liveness"] or len(serve_errors) != 1 \
            or len(spans) != 3 or not all(s["device_sync_ms"] > 0 for s in spans) \
            or len(tracer.find("serve")) != 3:
        raise AssertionError(f"the flight dump holds {len(serve_errors)} serve_error events and "
                             f"{len(spans)} serve spans ({[s['device_sync_ms'] for s in spans]} "
                             f"ms of device sync)")

    def refuse(*args, **kwargs):
        raise RuntimeError("planted fault: the int8_matmul launch failed")

    plain_calls, plain = [], qm.int8_matmul_plain

    def counted_plain(*args):
        plain_calls.append(1)
        return plain(*args)

    saved_launch, launches0 = qm._launch, qm.launches
    qm._launch, qm.int8_matmul_plain = refuse, counted_plain
    try:
        status, raw = http_call(server.port, "POST", "/v1/models/vgg16:predict", body)
    finally:
        qm._launch, qm.int8_matmul_plain = saved_launch, plain
    launched = qm.launches - launches0
    after, _ = http_call(server.port, "POST", "/v1/models/vgg16:predict", body)
    if not 500 <= status < 600 or b"planted fault" not in raw or plain_calls \
            or launched or after != 200:
        raise AssertionError(f"planted int8 launch failure: status {status} {raw[:200]}, plain "
                             f"version called {len(plain_calls)} times, next request {after}")
    result = {"dispatch_fault_statuses": statuses, "errors_counted": errors,
              "dump_lines": len(lines), "serve_spans_device_sync_ms":
              [s["device_sync_ms"] for s in spans], "launch_fault_status": status}
    log(f"  (f) planted faults on {card}: serve.dispatch@2:error gave {statuses}, {errors:.0f} "
        f"error counted; the dump ({len(lines)} lines) holds the serve_error event and 3 serve "
        f"spans with {result['serve_spans_device_sync_ms']} ms of device sync; a refused int8 "
        f"launch answered {status}, the plain version never called")
    return result


def vgg_gate(card, registry, server, models, vgg_zip, tmp, rng, calib) -> dict:
    """25 (e): the gate scores a VGG-16 int8 candidate against the serving
    fp incumbent (eval loss on held-out seeded batches); a truncated
    candidate is refused and the incumbent keeps serving; a DeployWatch
    window runs over live requests."""
    import numpy as np
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.io.model_serializer import restore_model
    from deeplearning4j_tpu_torch.online import DeployWatch, EvalGate, GatedDeployer
    from deeplearning4j_tpu_torch.resilience.checkpoint import CheckpointCorruptError
    incumbent = registry.get("vgg16")
    if incumbent.precision == "int8":
        raise AssertionError("the gate check needs the fp version serving")
    holdout = ListDataSetIterator([
        DataSet(rng.normal(size=(SS_HOLDOUT[1], SS_HW, SS_HW, 3)).astype(np.float32),
                np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, SS_HOLDOUT[1])])
        for _ in range(SS_HOLDOUT[0])])
    deployer = GatedDeployer(registry, EvalGate(holdout, metric="loss"))
    t0 = time.perf_counter()
    decision = deployer.deploy_if_better("vgg16", vgg_zip, precision="int8", calibration=calib)
    gate_s = time.perf_counter() - t0
    if decision.deploy:
        models[decision.version] = registry.get("vgg16").engine.model
    if not (np.isfinite(decision.candidate_score) and np.isfinite(decision.incumbent_score)):
        raise AssertionError(f"gate scores are not finite: {decision.to_dict()}")
    torn = str(tmp / "torn.zip")
    with open(vgg_zip, "rb") as src, open(torn, "wb") as dst:
        dst.write(src.read(min(os.path.getsize(vgg_zip) // 2, 64 * 2 ** 20)))
    serving = registry.get("vgg16").version
    refused = deployer.deploy_if_better("vgg16", torn, precision="int8")
    try:
        restore_model(torn)
        raise AssertionError("a truncated zip restored")
    except CheckpointCorruptError:
        pass
    x = rng.normal(size=(1, SS_HW, SS_HW, 3)).astype(np.float32)
    body = json.dumps({"instances": x.tolist()}).encode()
    status, raw = http_call(server.port, "POST", "/v1/models/vgg16:predict", body)
    if refused.deploy or "failed verification" not in refused.reason or status != 200 \
            or json.loads(raw)["model_version"] != serving:
        raise AssertionError(f"truncated candidate: {refused.to_dict()}, then {status}")
    stop, answers, failures = threading.Event(), [], []
    load = threading.Thread(target=lambda: post_clients(
        server.port, [x], [body], 1, answers, failures, stop=stop))
    load.start()
    try:
        verdict = DeployWatch(registry, "vgg16", window_s=0.8, poll_s=0.05,
                              min_requests=2).run()
    finally:
        stop.set()
        load.join(timeout=300)
    if verdict["rolled_back"] or failures:
        raise AssertionError(f"the watch rolled a clean deploy back: {verdict}, {failures[:3]}")
    result = {"decision": decision.to_dict(), "gate_s": gate_s,
              "truncated": refused.reason[:200], "watch": verdict,
              "watch_answers": len(answers)}
    log(f"  (e) gate on {card}: int8 candidate eval loss {decision.candidate_score:.6f} vs the fp "
        f"incumbent's {decision.incumbent_score:.6f} (delta {decision.delta:.3g}): "
        f"{'deployed as version ' + str(decision.version) if decision.deploy else 'refused'} "
        f"({decision.reason[:80]}) in {gate_s:.2f} s; a truncated candidate refused "
        f"({refused.reason[:60]}...), version {serving} kept serving; DeployWatch over "
        f"{len(answers)} live answers: {verdict['reason']}")
    return result


def online_round(card, tmp) -> dict:
    """25 (e): examples/online_learning.py's flow on the card: a small
    classifier served, ``:feedback`` POSTs into a FeedbackLog, and
    ``OnlineTrainer.run_once`` training (its step captured while the
    server answers requests) and deploying a gated version 2; then the
    same round on an idle card, captured anew, must give the same
    candidate bits."""
    import shutil
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.io.model_serializer import restore_model
    from deeplearning4j_tpu_torch.nn import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.online import EvalGate, OnlineConfig, OnlineTrainer
    from deeplearning4j_tpu_torch.serve import FeedbackLog, ModelRegistry, ModelServer
    from deeplearning4j_tpu_torch.train import Adam
    rng = np.random.default_rng(SS_SEED + 7)
    w = rng.normal(size=(ONLINE_IN, ONLINE_CLASSES)).astype(np.float32)

    def make_xy(n, seed):
        x = np.random.default_rng(seed).normal(size=(n, ONLINE_IN)).astype(np.float32)
        return x, np.eye(ONLINE_CLASSES, dtype=np.float32)[np.argmax(x @ w, -1)]

    conf = (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2)).list()
            .layer(DenseLayer(n_out=24, activation="relu"))
            .layer(OutputLayer(n_out=ONLINE_CLASSES, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(ONLINE_IN)).build())
    net = MultiLayerNetwork(conf).init()
    x0, y0 = make_xy(32, 1)
    net.fit(ListDataSetIterator([DataSet(x0, y0)]), epochs=1)
    base = str(tmp / "clf_base.zip")
    net.save(base)
    hx, hy = make_xy(128, 3)
    spool = str(tmp / "spool")
    feedback = FeedbackLog(spool)
    registry = ModelRegistry(max_batch=8, max_latency_ms=2.0)
    registry.deploy("clf", base)
    server = ModelServer(registry, feedback=feedback)
    xq, yq = make_xy(ONLINE_RECORDS, 2)

    def post(path, body):
        status, raw = http_call(server.port, "POST", path, json.dumps(body).encode())
        return status, json.loads(raw)

    stop, served, failures = threading.Event(), [], []
    client = None
    try:
        status, body = post("/v1/models/clf:predict", {"instances": xq[:8].tolist(),
                                                       "labels": yq[:8].tolist()})
        status2, body2 = post("/v1/models/clf:feedback", {"instances": xq[8:].tolist(),
                                                          "labels": yq[8:].tolist()})
        if status != 200 or status2 != 200 or body2["accepted"] != ONLINE_RECORDS - 8:
            raise AssertionError(f"feedback intake: {status} {status2} {body2}")
        if not feedback.flush():
            raise AssertionError("the feedback spool did not drain")
        shutil.copytree(spool, str(tmp / "spool_idle"))     # round stamps live in the spool

        def load():
            while not stop.is_set():
                s, b = post("/v1/models/clf:predict", {"instances": xq[:4].tolist()})
                (served if s == 200 else failures).append(b.get("model_version", s))

        client = threading.Thread(target=load)
        client.start()
        trainer = OnlineTrainer(
            registry, "clf", spool, str(tmp / "online"),
            EvalGate(ListDataSetIterator([DataSet(hx, hy)]), metric="accuracy"), base,
            config=OnlineConfig(min_records=ONLINE_RECORDS, batch_size=16,
                                max_records_per_round=ONLINE_RECORDS, epochs_per_round=2))
        t0 = time.perf_counter()
        decision = trainer.run_once()
        round_s = time.perf_counter() - t0
        deadline = time.monotonic() + 60
        while sum(1 for v in served if v == 2) < 4 and not failures \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        if client is not None:
            client.join(timeout=60)
        server.stop()
        feedback.close()
        registry.close()
    if decision["status"] != "deployed" or decision["gate"]["version"] != 2 or failures:
        raise AssertionError(f"online round: {decision}, failures {failures[:3]}")
    release()                                         # the idle round captures anew
    idle_registry = ModelRegistry(max_batch=8, max_latency_ms=2.0)
    idle_registry.deploy("clf", base)
    try:
        idle = OnlineTrainer(
            idle_registry, "clf", str(tmp / "spool_idle"), str(tmp / "online_idle"),
            EvalGate(ListDataSetIterator([DataSet(hx, hy)]), metric="accuracy"), base,
            config=OnlineConfig(min_records=ONLINE_RECORDS, batch_size=16,
                                max_records_per_round=ONLINE_RECORDS, epochs_per_round=2))
        idle_decision = idle.run_once()
    finally:
        idle_registry.close()
    a = restore_model(str(tmp / "online" / "round-0" / "candidate.zip"))
    b = restore_model(str(tmp / "online_idle" / "round-0" / "candidate.zip"))
    same = all(torch.equal(p, q) for la, lb in zip(a.params_, b.params_)
               for p, q in zip(la.values(), lb.values()))
    result = {"decision": {k: decision[k] for k in ("status", "round")},
              "gate": decision["gate"], "round_s": round_s,
              "answers_during": len(served), "versions_served": sorted(set(served)),
              "idle_status": idle_decision["status"], "same_bits_as_idle": same}
    log(f"  (e) online round on {card}: {ONLINE_RECORDS} feedback records, run_once "
        f"{decision['status']} version {decision['gate']['version']} in {round_s:.2f} s (gate "
        f"accuracy {decision['gate']['candidate_score']:.4f} vs "
        f"{decision['gate']['incumbent_score']:.4f}) while {len(served)} requests were answered "
        f"(versions {result['versions_served']}); the same round on an idle card, captured "
        f"anew: {idle_decision['status']}, candidate the same bits: {same}")
    if not same or sorted(set(served)) != [1, 2]:
        raise AssertionError(f"online round: {result}")
    return result


def resnet_router(card, tmp, counters) -> dict:
    """25 (d): ResNet-50 (f32) behind a two-replica ReplicaRouter with two
    priority lanes and a tenant quota: answers held to the net's output of
    each request alone (phase 4's SERVE_TOL), 36 matmul_bn_act launches a
    served batch, quota and lane sheds, a fan-out deploy, the registry's
    refusal of a routed name, the autoscaler from 1 to 2 replicas and
    back, all eager; images/s and latency through the router and the
    engine alone, each path warm, eager and captured."""
    import numpy as np
    from deeplearning4j_tpu_torch.ops.kernels import conv_bn
    from deeplearning4j_tpu_torch.train import capture
    from deeplearning4j_tpu_torch.serve import (AdmissionControl, AutoscaleConfig, Autoscaler,
                                                InferenceEngine, Lane, ModelRegistry,
                                                Overloaded, QuotaExceeded, ReplicaRouter,
                                                RoutedModelError, TenantQuota)
    reg = counters["metrics"]
    net = serving_resnet50()
    path = str(tmp / "resnet50.zip")
    net.save(path, save_updater=False)
    rng = np.random.default_rng(SS_SEED + 3)
    requests = [rng.normal(size=(SS_ROUTER_IMAGES, SS_HW, SS_HW, 3)).astype(np.float32)
                for _ in range(SS_ROUTER_REQUESTS)]
    registry = ModelRegistry(max_batch=BATCH, max_latency_ms=5.0)
    registry.deploy("resnet50", path)
    admission = AdmissionControl(lanes=[Lane("interactive", 0, 1.0), Lane("batch", 1, 0.5)],
                                 default_lane="interactive",
                                 quotas={"metered": TenantQuota(rate=1e-3, burst=2)})
    router = ReplicaRouter(registry, "resnet50", replicas=2, min_replicas=1, admission=admission)

    def drive(predict):
        answers, latency = {}, {}

        def client(j):
            for i in range(j, len(requests), 4):
                t0 = time.perf_counter()
                answers[i] = predict(requests[i])
                latency[i] = time.perf_counter() - t0

        workers = [threading.Thread(target=client, args=(j,)) for j in range(4)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=900)
        wall = time.perf_counter() - t0
        if len(answers) != len(requests):
            raise AssertionError(f"{len(answers)} of {len(requests)} requests answered")
        n = len(requests) * SS_ROUTER_IMAGES
        return answers, {"wall_s": wall, "images_per_s": n / wall,
                         **percentiles(list(latency.values()))}

    def timed(predict) -> dict:
        """Eager and captured readings of ``predict``, each after warm passes
        (the captured one's capture each bucket)."""
        out = {}
        for mode in ("eager", "captured"):
            with capture.eager() if mode == "eager" else contextlib.nullcontext():
                for _ in range(1 if mode == "eager" else 2):
                    drive(predict)
                b0 = reg.counter("tpudl_serve_batches_total").value
                out[mode] = drive(predict)[1]
                out[mode]["batches"] = int(reg.counter("tpudl_serve_batches_total").value - b0)
        return out

    def routed(x):
        return router.predict(x, timeout_s=300, tenant="open", lane="interactive")

    try:
        with capture.eager():
            batches0, launches0 = reg.counter("tpudl_serve_batches_total").value, conv_bn.launches
            answers, _ = drive(routed)
            batches = reg.counter("tpudl_serve_batches_total").value - batches0
            launches = conv_bn.launches - launches0
            if launches != 36 * batches or batches == 0:
                raise AssertionError(f"matmul_bn_act launched {launches} times for {batches} "
                                     f"batches through the router")
            dispatch = reg.labeled_counter("tpudl_router_dispatch_total",
                                           label_names=("replica",))
            per_replica = {k[0]: v for k, v in dispatch.child_values().items()}
            err = max(float(np.abs(answers[i] - net.output(x).cpu().numpy()).max())
                      for i, x in enumerate(requests))
            if not err <= SERVE_TOL:
                raise AssertionError(f"router answers differ from output() of each request "
                                     f"alone by {err} (phase 4's SERVE_TOL {SERVE_TOL})")
        through = timed(routed)
        with capture.eager():
            one = requests[0][:1]
            metered = []
            for _ in range(3):
                try:
                    router.predict(one, timeout_s=300, tenant="metered")
                    metered.append("ok")
                except QuotaExceeded:
                    metered.append("quota")
            fill, router.queue_fill = router.queue_fill, lambda: 0.6
            lanes = {}
            for lane in ("batch", "interactive"):
                try:
                    router.predict(one, timeout_s=300, lane=lane)
                    lanes[lane] = "ok"
                except QuotaExceeded:
                    lanes[lane] = "quota"
                except Overloaded:
                    lanes[lane] = "shed"
            router.queue_fill = fill
            if metered != ["ok", "ok", "quota"] or lanes != {"batch": "shed", "interactive": "ok"}:
                raise AssertionError(f"admission: metered tenant {metered}, lanes at 60% fill "
                                     f"{lanes}")
            entry = router.deploy(path)
            fanned = [r["version"] for r in router.replica_stats()]
            try:
                registry.deploy("resnet50", path)
                raise AssertionError("the registry deployed onto a router-managed name")
            except RoutedModelError:
                pass
            if fanned != [entry.version] * 2 or entry.version != 2:
                raise AssertionError(f"fan-out deploy: version {entry.version}, replicas "
                                     f"{fanned}")
            router.retire_replica()
            scaler = Autoscaler(router, AutoscaleConfig(scale_up_at=2.0, scale_down_at=-1.0,
                                                        poll_s=3600.0))
            scaler.close()            # its loop's first poll could not scale
            scaler.config = AutoscaleConfig(scale_up_at=0.25, scale_down_at=0.02, poll_s=3600.0,
                                            up_cooldown_s=0.0, down_cooldown_s=0.0, window=1)
            script = iter([0.5, 0.0])
            router.queue_fill = lambda: next(script)
            sizes = [router.replicas]
            for _ in range(2):
                scaler.step()
                sizes.append(router.replicas)
            router.queue_fill = fill
            if sizes != [1, 2, 1]:
                raise AssertionError(f"autoscaler replicas {sizes}, not 1 -> 2 -> 1")
    finally:
        registry.close()
    with InferenceEngine(net, max_batch=BATCH, max_latency_ms=5.0) as engine:
        alone = timed(lambda x: engine.predict(x, timeout_s=300))
    result = {"batches": int(batches), "launches": int(launches), "max_abs_err": err,
              "per_replica_dispatches": per_replica, "router": through, "engine_alone": alone,
              "metered": metered, "lanes_at_60_percent": lanes, "fan_out": fanned,
              "autoscale": sizes}
    log(f"  (d) ResNet-50 f32 behind a 2-replica router on {card}: "
        f"{len(requests)} requests of {SS_ROUTER_IMAGES} images from 4 threads, "
        f"{int(batches)} batches, {int(launches)} matmul_bn_act launches (36 a batch), "
        f"dispatches {per_replica}; answers vs output() alone {err:.2e} (limit {SERVE_TOL})")
    for mode in ("eager", "captured"):
        r, a = through[mode], alone[mode]
        log(f"      {mode}, warm: router {r['images_per_s']:.1f} images/s in {r['batches']} "
            f"batches, p50 {r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms; engine alone "
            f"{a['images_per_s']:.1f} images/s in {a['batches']} batches, p50 "
            f"{a['p50_ms']:.1f} ms, p99 {a['p99_ms']:.1f} ms (max_batch {BATCH})")
    log(f"      metered tenant {metered}, lanes at 60% fill {lanes}, fan-out to version "
        f"{entry.version} on replicas {fanned}, a direct registry deploy refused, autoscaler "
        f"{sizes}")
    return result


def serving_stack(card: str) -> dict:
    """Phase 25: the serving stack (module docstring)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import config
    from deeplearning4j_tpu_torch.obs.registry import MetricsRegistry, set_registry
    from deeplearning4j_tpu_torch.ops.kernels import quant_matmul as qm
    from deeplearning4j_tpu_torch.serve import ModelRegistry, ModelServer
    from deeplearning4j_tpu_torch.train import capture

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serving_"))
    metrics = MetricsRegistry()
    prev = set_registry(metrics)
    counters = {"metrics": metrics}
    rng = np.random.default_rng(SS_SEED)
    out: dict = {"card": card, "part_s": {}}
    t_phase = t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        out["part_s"][name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    try:
        vgg_zip = str(tmp / "vgg16.zip")
        net = serving_vgg16()
        t0 = time.perf_counter()
        net.save(vgg_zip, save_updater=False)
        out["vgg16_zip"] = {"gb": os.path.getsize(vgg_zip) / 1e9,
                            "save_s": time.perf_counter() - t0, "params": net.num_params()}
        del net
        torch.cuda.empty_cache()
        calib = [rng.normal(size=(VGG_CALIB[1], SS_HW, SS_HW, 3)).astype(np.float32)
                 for _ in range(VGG_CALIB[0])]
        images, bodies = vgg_requests(rng, SS_REQUESTS, SS_MAX_IMAGES)
        models: dict = {}
        config.set_dtype_policy(config.DTypePolicy(param_dtype=torch.bfloat16,
                                                   compute_dtype=torch.bfloat16,
                                                   output_dtype=torch.bfloat16))
        registry = ModelRegistry(max_batch=VGG_BATCH, max_latency_ms=5.0)
        server = ModelServer(registry)
        try:
            with capture.eager(), dispatches_recorded() as rec:
                entry, deploy_s = timed_deploy(registry, "vgg16", models, vgg_zip,
                                               precision="int8", calibration=calib)
                report = entry.engine.model.quantization_
                gauges = {name: metrics.gauge(f"tpudl_serve_quantized_{name}").value
                          for name in ("weight_bytes", "compression_ratio", "max_abs_err")}
                want = {"weight_bytes": report.quantized_weight_bytes,
                        "compression_ratio": report.compression_ratio,
                        "max_abs_err": report.max_abs_err}
                if gauges != want or entry.precision != "int8":
                    raise AssertionError(f"quantized gauges {gauges} differ from the report "
                                         f"{want}")
                out["deploy_int8"] = {"seconds": deploy_s, "gauges": gauges,
                                      "report": report.to_dict()}
                log(f"  (a) deployed VGG-16 ({out['vgg16_zip']['params']} params, a "
                    f"{out['vgg16_zip']['gb']:.3f} GB f32 zip) as int8 on {card} in "
                    f"{deploy_s:.2f} s (load, verify, quantize, calibrate on "
                    f"{VGG_CALIB[0]} x {VGG_CALIB[1]}); gauges {gauges}")
                part("a")
                out["http"], answers = vgg_http(card, registry, server, models, images, bodies,
                                                counters)
                part("b")
                out["swap"], more = vgg_swaps(card, registry, server, models, images, bodies,
                                              vgg_zip)
                answers += more
                part("c")
            held = hold_answers(rec.records, answers, models)
            del rec
            part("held")
            with dispatches_recorded() as rec:         # captured (no capture.eager())
                out["captured_round"], more = vgg_captured_rounds(
                    card, registry, server, models, vgg_zip, rng, counters)
            part("c_captured")
            with capture.eager():
                held_captured = hold_answers(rec.records, more, models)
                del rec
                out["held"] = {"eager": held, "captured": held_captured}
                log(f"  each answer equal to its version's output of the batch it was served "
                    f"in: {held['answers']} answers over {held['dispatches']} dispatches "
                    f"(eager), {held_captured['answers']} over "
                    f"{held_captured['dispatches']} (captured)")
                out["gate"] = vgg_gate(card, registry, server, models, vgg_zip, tmp, rng, calib)
                part("e_gate")
                if registry.get("vgg16").precision != "int8":
                    timed_deploy(registry, "vgg16", models, vgg_zip, precision="int8")
                out["faults"] = vgg_faults(card, registry, server, rng, counters)
                part("f")
            out["int8_launches"] = out["http"]["launches"]
        finally:
            server.stop()
            registry.close()
            config.set_dtype_policy(config.DTypePolicy.f32())
        models.clear()
        release()
        out["router"] = resnet_router(card, tmp, counters)
        part("d")
        release()
        out["online"] = online_round(card, tmp)
        part("e_online")
    finally:
        set_registry(prev)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"serving stack (phase 25) on {card}: {out['seconds']:.1f} s; seconds by part "
        f"{ {k: round(v, 1) for k, v in out['part_s'].items()} }")
    return out


def release() -> None:
    """Drop the cached steps (the nets and graphs they hold) and return the
    allocator's free memory to the card, between phases."""
    import torch
    from deeplearning4j_tpu_torch.train import step_cache
    step_cache.clear_step_cache()
    torch.cuda.empty_cache()


def main() -> int:
    if sys.argv[1:2] == ["--times"]:           # one run of the A/B call, in the tree given
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(ab_times()))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "deeplearning4j_tpu_torch").is_dir():
        print("chip_smoke: the deeplearning4j_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["--ab"]:
        return ab(Path(sys.argv[2]).resolve())
    from deeplearning4j_tpu_torch.ops.kernels import _build
    from deeplearning4j_tpu_torch.train import capture

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    log(card)
    log(f"SMs: {torch.cuda.get_device_properties(0).multi_processor_count}")

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, info in built.items():
        log(f"  {name}: nvcc {info['seconds']:.1f} s")
        for kernel, usage in ptxas_usage(name, info["log"]).items():
            log(f"    {kernel}: {usage}")
    log(f"the kernels of {', '.join(HOPPER_LIBS)} in SASS (cuobjdump -sass):")
    hopper = check_hopper_path(built)

    # phases 3-21 hold the kernels per step and against their plain versions
    # on the eager steps (capture.eager()); phase 22 captures the same paths
    with capture.eager():
        net = build_net()
        calls = resnet50_calls(net, BATCH)
        if len(calls) != 36:
            raise AssertionError(f"ResNet-50 makes {len(calls)} matmul_bn_act calls, not 36")
        log(f"kernel check: {len(set(calls))} distinct shapes of the 36 calls at batch {BATCH}, "
            f"{sum(2 * m * k * n for m, k, n, _ in calls) / BATCH / 1e9:.3f} GFLOP per image")
        rows = check_kernels(calls, (torch.float32, torch.bfloat16))

        serving = serve(net, card)
        del net
        release()

        log(f"backward kernel check: {len(set(calls))} distinct shapes, "
            f"{sum(4 * m * k * n for m, k, n, _ in calls) / BATCH / 1e9:.3f} GFLOP per image")
        bwd_rows = check_bwd_kernels(calls, (torch.float32, torch.bfloat16))
        training = train_check(card)
        head = headline(card)
        # the headline ran both kernels at its own shapes: hold them there too
        from deeplearning4j_tpu_torch.models import resnet50
        head_calls = resnet50_calls(resnet50(fused=True, device="cuda"), head["batch"])
        log(f"kernel checks at the headline's batch {head['batch']}, bf16: "
            f"{len(set(head_calls))} distinct shapes")
        head_rows = check_kernels(head_calls, (torch.bfloat16,))
        head_bwd_rows = check_bwd_kernels(head_calls, (torch.bfloat16,))
        release()

        log(f"ragged matmul_bn_act kernel check: M = {RAGGED_M}, (K, N, prologue) = "
            f"{[c[1:] for c in RAGGED_CALLS]}, f32 and bf16")
        ragged_rows = check_kernels(list(RAGGED_CALLS), (torch.float32, torch.bfloat16))
        ragged_bwd_rows = check_bwd_kernels(list(RAGGED_CALLS), (torch.float32, torch.bfloat16))
        ragged = ragged_graph(card)
        release()

        log(f"conv3x3_bn_act kernel check: ResNet-50's four 3x3 shapes at batch {BATCH}, "
            f"(prologue, "
            f"relu_in) in {CONV3_VARIANTS}, then {len(CONV3_RAGGED)} other shapes, f32 and bf16")
        conv3_rows = check_conv3(conv3_calls(BATCH), (torch.float32, torch.bfloat16),
                                 CONV3_VARIANTS)
        conv3_ragged_rows = check_conv3(list(CONV3_RAGGED), (torch.float32, torch.bfloat16),
                                        CONV3_VARIANTS[:1], timed=False)
        conv3_paths = [conv3_path(card, BATCH, "f32"), conv3_path(card, head["batch"], "bf16")]
        conv3_grads = conv3_autograd(card)
        log(f"conv3x3_bn_act at the headline's batch {head['batch']}, bf16")
        conv3_head_rows = check_conv3(conv3_calls(head["batch"]), (torch.bfloat16,),
                                      CONV3_VARIANTS[:1])
        timed = [r for r in conv3_rows if "ms" in r]
        c3f32, c3bf16 = per_forward(timed, "float32"), per_forward(timed, "bfloat16")
        c3h16 = per_forward(conv3_head_rows, "bfloat16")
        for name, tot, sel in ((f"batch {BATCH} f32", c3f32, (timed, "float32")),
                               (f"batch {BATCH} bf16", c3bf16, (timed, "bfloat16")),
                               (f"batch {head['batch']} bf16", c3h16, (conv3_head_rows, "bfloat16"))):
            fma = sum(r["fma_ops_ms"] * r["count"] for r in sel[0] if r["dtype"] == sel[1])
            dev = sum(r["device_ms"] * r["count"] for r in sel[0] if r["dtype"] == sel[1])
            log(f"  the 16 3x3 calls of one pass, {name}: kernel {tot['ms']:.3f} ms (device time "
                f"{dev:.3f}), plain "
                f"{tot['plain_ms']:.3f}, library (the layer's chain) {tot['library_ms']:.3f}, "
                f"bound {tot['bound_ms']:.3f} ({tot['bound_by']}; bytes {tot['bytes_ms']:.3f}, "
                f"operations "
                f"{tot['ops_ms']:.3f}; on the CUDA cores {fma:.3f})")
        release()

        log(f"flash attention kernel check: {len(FLASH_CASES)} cases at (B, H, D) = "
            f"({BERT_BATCH}, 12, 64), f32 and bf16")
        flash_rows = check_flash((torch.float32, torch.bfloat16))
        f32_worst = max(e for r in flash_rows if r["dtype"] == "float32"
                        for e in list(r["rel_err"].values()) + list(r["split_vs_merged"].values()))
        log(f"f32 flash errors at D = 64 (three TF32 passes): at most {f32_worst:.2e} over every "
            f"case and output (the CUDA-core kernels before them read at most 3.1e-6; limits "
            f"{FLASH_TOL['float32']})")
        from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
        scratch = fa.merged_scratch_bytes(BERT_BATCH, 12, BERT_SEQ, 64)
        log(f"merged backward's scratch beside dq at ({BERT_BATCH}, 12, {BERT_SEQ}, 64): {scratch} "
            f"bytes ({scratch / 1e9:.6f} GB; limit {MERGED_SCRATCH_LIMIT / 1e9} GB); both forms "
            f"gave "
            f"the same bits on a second run at the base case of every head dim, f32 and bf16")
        if scratch > MERGED_SCRATCH_LIMIT:
            raise AssertionError(f"the merged backward's scratch {scratch} bytes is over "
                                 f"{MERGED_SCRATCH_LIMIT}")
        split_main = split_main_path()
        flash_dim_rows = []
        for d, heads, names in FLASH_HEAD_DIMS:
            cases = tuple(c for c in FLASH_CASES if names is None or c[0] in names)
            log(f"flash attention at head dim {d}: {len(cases)} cases at (B, H) = ({BERT_BATCH}, "
                f"{heads}), f32 and bf16")
            flash_dim_rows += check_flash((torch.float32, torch.bfloat16), d, heads, cases)
        log(f"flash attention backward, both forms, at long sequences {LONG_SEQS}")
        long_rows = flash_long(card)
        bert_served = bert_serve(card)
        bert_heads = [bert_serve(card, 2, heads) for heads in BERT_HEADS]
        bert_head = bert_finetune(card)
        bert_check = bert_train_check(card)
        release()

        log(f"int8_matmul kernel check: {len(INT8_SHAPES)} shapes at M in {INT8_BATCHES}, f32 and "
            f"bf16, L2 cold")
        int8_rows = check_int8((torch.float32, torch.bfloat16))
        vgg = vgg_serve(card)
        release()
        small = small_nets(card)
        release()
        headline128 = bert_headline(card)
        release()
        stack = attention_stack(card)
    release()
    captured = captured_steps(card)
    release()
    recurrent = recurrent_nets(card, captured["paths"])
    release()
    tuned = finetune(card)
    release()
    stack_run = serving_stack(card)

    def entry(name, source, replaces, tot, tot16, head16, launches, work):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": tot["bound_by"], "library_ms": tot["library_ms"], "work": work,
                "bf16_ms": tot16["ms"], "bf16_plain_ms": tot16["plain_ms"],
                "bf16_bound_ms": tot16["bound_ms"], "bf16_bound_by": tot16["bound_by"],
                "bf16_library_ms": tot16["library_ms"], "bf16_max_abs_err": tot16["max_abs_err"],
                "headline_bf16_ms": head16["ms"], "headline_bf16_max_abs_err": head16["max_abs_err"]}

    f32, bf16 = per_forward(rows, "float32"), per_forward(rows, "bfloat16")
    for dname, tot in (("float32", f32), ("bfloat16", bf16)):
        fma = sum(r["fma_ops_ms"] * r["count"] for r in rows if r["dtype"] == dname)
        log(f"  the 36 matmul_bn_act forward calls of one pass, batch {BATCH} {dname}: kernel "
            f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f}, library {tot['library_ms']:.3f}, "
            f"bound {tot['bound_ms']:.3f} ({tot['bound_by']}; bytes {tot['bytes_ms']:.3f}, "
            f"operations {tot['ops_ms']:.3f}; on the CUDA cores {fma:.3f})")
    b32, b16 = per_forward(bwd_rows, "float32"), per_forward(bwd_rows, "bfloat16")
    h16, hb16 = per_forward(head_rows, "bfloat16"), per_forward(head_bwd_rows, "bfloat16")
    train_launches = [sum(c[i] for c in training["launches_per_step"]) for i in (0, 1)]
    work = (f"the 36 calls of one ResNet-50 {{}} at batch {BATCH}, f32 (bf16_*: bf16; "
            f"headline_*: bf16 at batch {head['batch']})")
    flash_launches = [sum(c[i] for c in bert_head["launches_per_step"]) for i in (0, 1)]
    flash_work = (f"one attention call of the BERT-base path, (B, H, T, D) = ({BERT_BATCH}, 12, "
                  f"{BERT_SEQ}, 64), f32 (bf16_*: bf16); launches: the bf16 fine-tune's "
                  f"{1 + BERT_TRAIN_STEPS} steps")
    kernels = [
        entry("matmul_bn_act", "deeplearning4j_tpu_torch/ops/kernels/csrc/matmul_bn_act.cu",
              "deeplearning4j_tpu/ops/pallas/conv_bn.py:58", f32, bf16, h16, train_launches[0],
              work.format("forward"))
        | {"serve_launches": serving["launches"], "sass": hopper["matmul_bn_act"],
           "serving_stack_launches": stack_run["router"]["launches"],
           "finetune_launches_per_step": tuned["capture"]["eager_launches_per_step"][0][
               "matmul_bn_act"],
           "design": "persistent blocks on the GEMM core (gemm_sm90.cuh), each keeping a "
                     "column tile: wgmma fed by TMA, x folded in place by prep threads (bf16: A "
                     "from shared memory; f32: A split in registers into TF32 hi and lo, three "
                     "passes, W^T written once a call by mbf_wt_kernel and split in place by "
                     "prep), K split where the tiles do not fill the card, y (TMA stores), s1, "
                     "s2 from one launch (running column sums, arrival counts, fixed order)"},
        entry("matmul_bn_act_bwd",
              "deeplearning4j_tpu_torch/ops/kernels/csrc/matmul_bn_act_bwd.cu",
              "deeplearning4j_tpu/ops/pallas/conv_bn.py:92", b32, b16, hb16, train_launches[1],
              work.format("backward"))
        | {"sass": hopper["matmul_bn_act_bwd"],
           "finetune_launches_per_step": tuned["capture"]["eager_launches_per_step"][0][
               "matmul_bn_act_bwd"]},
        flash_entry("flash_attention",
                    "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_attention_fwd.cu",
                    "deeplearning4j_tpu/ops/pallas/flash_attention.py:33", flash_rows, "",
                    flash_launches[0], flash_work)
        | {"serve_launches": sum(bert_served[p]["launches"] for p in ("f32", "bf16")),
           "config_first_launches_per_forward": stack["bf16_output_launches"][0],
           "sass": hopper["flash_attention_fwd"]},
        flash_entry("flash_attention_bwd",
                    "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
                    "deeplearning4j_tpu/ops/pallas/flash_attention.py:380", flash_rows, "bwd_",
                    flash_launches[1], flash_work)
        | {"sass": hopper["flash_attention_bwd"], "merged_scratch_bytes": scratch,
           "config_first_launches_per_step": stack["bf16_step_launches"][-1][1]},
        flash_entry("flash_attention_bwd_split",
                    "deeplearning4j_tpu_torch/ops/kernels/csrc/flash_attention_bwd_split.cu",
                    "deeplearning4j_tpu/ops/pallas/flash_attention.py:266", flash_rows, "split_",
                    split_main["launches"],
                    flash_work.split("; launches")[0] + "; launches: one call of "
                    "flash_attention_block_bwd(merged=False), its dq and its dk/dv kernel")
        | {"replaces_all": ["deeplearning4j_tpu/ops/pallas/flash_attention.py:266",
                            "deeplearning4j_tpu/ops/pallas/flash_attention.py:318"],
           "sass": hopper["flash_attention_bwd_split"]},
        int8_entry(int8_rows, vgg) | {"sass": hopper["int8_matmul"],
                                      "serving_stack_launches": stack_run["int8_launches"]},
        entry("conv3x3_bn_act", "deeplearning4j_tpu_torch/ops/kernels/csrc/conv3x3_bn_act.cu",
              "deeplearning4j_tpu/ops/pallas/conv3_bn.py:37", c3f32, c3bf16, c3h16,
              sum(path["launches"] for path in conv3_paths),
              f"the 16 3x3 calls of one ResNet-50 pass at batch {BATCH}, f32 (bf16_*: bf16; "
              f"headline_*: bf16 at batch {head['batch']}); no model calls it; launches: the "
              f"16 stages captured from a train-mode forward at batch {BATCH} (f32) and "
              f"{head['batch']} (bf16)")
        | {"replaces_all": ["deeplearning4j_tpu/ops/pallas/conv3_bn.py:37",
                            "deeplearning4j_tpu/ops/pallas/conv3_bn.py:84"],
           "sass": hopper["conv3x3_bn_act"]},
    ]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "shapes": rows, "per_forward": {"float32": f32, "bfloat16": bf16},
         "bwd_shapes": bwd_rows, "per_backward": {"float32": b32, "bfloat16": b16},
         "headline_shapes": head_rows, "headline_bwd_shapes": head_bwd_rows,
         "per_headline_step": {"forward": h16, "backward": hb16},
         "serve": serving, "train": training, "headline": head,
         "ragged_shapes": ragged_rows, "ragged_bwd_shapes": ragged_bwd_rows,
         "ragged_graph": ragged, "conv3_shapes": conv3_rows,
         "conv3_ragged_shapes": conv3_ragged_rows, "conv3_headline_shapes": conv3_head_rows,
         "conv3_per_pass": {"float32": c3f32, "bfloat16": c3bf16, "headline_bfloat16": c3h16},
         "conv3_paths": conv3_paths, "conv3_autograd": conv3_grads,
         "flash_head_dim_shapes": flash_dim_rows,
         "flash_long": long_rows, "bert_serve_heads": bert_heads, "flash_sass": hopper,
         "flash_shapes": flash_rows, "bert_serve": bert_served, "bert_finetune": bert_head,
         "bert_train_check": bert_check, "int8_shapes": int8_rows, "vgg16_int8": vgg,
         "small_nets": small, "bert_headline_seq128": headline128, "attention_stack": stack,
         "captured_steps": captured, "recurrent_nets": recurrent, "finetune": tuned,
         "serving_stack": stack_run,
         "kernels": kernels, "log": LOG_LINES,
         "seconds": time.perf_counter() - t_start}, indent=1))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
