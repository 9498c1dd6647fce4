#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``mxnet_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. build — compile every hand-written kernel (``mxnet_tpu_torch/csrc``)
   with nvcc for sm_90a, one nvcc per source, in parallel, and load them;
2. kernels — hold each kernel against its plain PyTorch version on the
   card at the serving path's shapes, and time kernel, plain version and
   one library call that computes the same function (a yardstick the
   port never calls) with the L2 cache flushed before every launch;
   kernel A and F cases name the variant ``ops/fused_kernel.py``'s plan
   ran and the share of the bound it reached; kernel B cases the variant
   and split count of ``ops/decode_kernel.py``'s plan, with the combine
   kernel held against its plain version and timed beside kernel B;
3. kernels C-F — the training kernels (flash attention forward, dQ,
   dK/dV; the fused LN->linear backward) against their plain versions at
   the training path's shapes (C-E in f32 and bf16, G = 1 and 2; each
   case names the variant that ran, ``simt`` or ``wgmma``), timed the
   same way;
4. kernel B1 — the multi-tensor optimizer update against its plain
   version over the slabs of ResNet-50's 157 trainables (12,556 blocks)
   and of the LM's, for SGD, SGD-momentum and Adam, f32 masters with and
   without a bf16 compute copy, bf16 masters, clip on and off, lr / wd
   differing per segment, over the bucketed LSTM LM's slab and the SSD
   example's for the Adam update their paths run, and over
   Inception-v3's (284 tensors, f32
   masters with the bf16 copy) and AlexNet's (16 tensors, 50.8M values,
   f32) for the SGD-momentum theirs run: bit for bit for SGD and
   SGD-momentum, within one f32 ulp for Adam, padding still 0; timed
   beside the port's per-parameter update and ``torch.optim``'s fused
   SGD / Adam step;
5. serve — build the full-width ``attention_lm`` (vocab 8192, embed
   1024, 4 heads, FFN 4096; depth cut to 2 layers) from seeded random
   weights, capture its paged programs (``prepare_programs``: decode
   step, prefill chunk, slot commit, page fork as CUDA graphs) and serve
   8 requests (128-1024-token prompts, half sharing a 256-token prefix,
   32 greedy tokens each) through ``DecodeServer`` over a paged int8
   ``DecodePredictor`` (4 slots, 16-token pages, 256-token prefill
   chunks), counting every kernel launch and graph replay; serve again
   under ``programs.eager()`` (the same tokens and launches); then
   re-serve with the plain versions and compare teacher-forced
   probabilities (the kernel side replaying the captured programs); a
   profiled repeat of each of the captured and eager serves; the
   programs must not have been captured again;
5b. serve spec — the same model and requests with speculative decoding
   (``bench_decode.py``'s spec_k 8, the n-gram proposer at n-gram 2):
   ``prepare_programs`` captures the verify program too; the captured
   serve (timed) must emit the non-speculative serve's tokens, the
   eager one the same tokens and launches, the plain one the same
   greedy tokens; a teacher-forced verify (the kernel run's tokens as
   drafts) against the plain predictor, at all k + 1 positions; a
   self-draft serve (a dense int8 predictor of the same weights) must
   accept every draft; a sampled serve (temperature 1, top-k 8) must
   repeat from its seed with every token in the plain top 8; then
   profiled repeats, captured and eager;
6. train — ``Module.forward_backward`` + ``update`` steps of the
   full-width training configuration (vocab 8192, T 2048, batch 8, embed
   1024, 8 heads, FFN 4096, 4 layers, f32, SGD, seeded Xavier-gaussian
   weights) on one repeated token batch through the compiled train step
   (``train_step.CompiledTrainStep``: forward, backward, the gradient
   pack and kernel B1 in one CUDA graph), counting every kernel launch
   and graph replay; the first step runs unrecorded
   (``programs.eager()``): its update is held bit for bit against the
   plain version on copies of its slabs, its gradients against a
   ``plain=True`` module's; the second sets up the graph (a warm-up run
   and the capture), the timed steps replay it; the loss must fall; the
   bench's learning rate is recorded beside the one timed; the captured
   steps against the same steps under ``programs.eager()`` from the same
   start (and two eager runs against each other, naming the gradients
   that differ between them); profiled steps, captured and eager; then
   the attention routing: a Module at head dims 32 and 256, which the
   flash kernels are not built for, takes sdpa ("einsum") and matches a
   plain module's forward and backward;
6b. predict — the training configuration's LM and weights saved with
   ``model.save_checkpoint`` and loaded by ``Module.load``, then
   ``Module.predict`` over 20 sequences at batch 8 (the last batch
   padded by 4): each batch one replay of the captured inference forward
   (``train_step.CompiledForward``: kernels A 20 and C 4 times a batch),
   bit for bit against the same predict under ``programs.eager()`` and
   within TOL_LOGP of a plain module; timed captured and eager, a
   profiled batch of each; ``Predictor.from_checkpoint`` bit for bit
   against predict's first batch, its reshape to batch 2 and back with
   no new capture; ``Module.reshape`` to batch 4; ``backward(out_grads)``
   on the logits with a random head gradient against a plain module
   (kernels D, E, F); a serve from the ``.params`` file (path, then
   bytes) over a prompt holding ids ``vocab``, ``vocab + 2`` and
   ``-vocab - 1``, equal to the prompt with the clamped ids;
6c. train imperative — the training configuration written as ``nd``
   calls (``models/attention_lm.py``'s ``imperative_lm``, the graph of
   its ``get_symbol``) on a thread of its own under
   ``autograd.record()``, ``autograd.backward`` into marked gradient
   buffers and ``nd.sgd_update(w, g, out=w)`` per parameter: the first
   step's loss and gradients and the parameters after 3 steps against a
   Module's eager SGD steps from the same parameters and batch, 20 / 20
   / 4 / 4 / 4 launches of A / F / C / D / E a step, 3 timed steps, the
   host time spent in ``imperative_invoke``, a profiled step; then ops
   — every op case of the slice (``tests/test_torch_op_cases.py``: the
   elementwise, tensor and layer ops, forward and gradient) on the card
   against the CPU, and the samplers' moments and repeatability;
7. train ResNet-50 — ``bench.py``'s configuration at full depth and
   width (batch 256, bf16 compute, f32 masters, SGD lr 0.1, momentum
   0.9, wd 1e-4, seeded Xavier(gaussian, in, 2) weights, one resident
   batch) through the compiled step and its slab plan: an unrecorded
   first step whose update is held against the plain version and, on
   copies of the masters and the momentum from before it with the
   gradients it packed, against the per-parameter update (the
   optimizer's ``update_multi``), bit for bit in the masters, the
   momentum and the bf16 copy; the graph's set-up, then timed replays
   (one B1 launch each, the moving statistics moving, finite losses);
   profiled steps, captured and eager; then, at the same batch with
   cuDNN's deterministic algorithms, captured steps against eager ones
   bit for bit and the card round trip (``save_checkpoint`` with the
   optimizer states, ``Module.load``, one more step of each: bit for
   bit), with the peak memory of the two modules alive at once.
8. train LSTM — the bucketed LSTM language model (see LSTM_* below):
   the fused RNN op (cuDNN) against the unfused LSTMCell stack carrying
   the same blob at batch 32, T 40, 2 x 200 (outputs, final states, the
   data's and the blob's gradients); then the bench's LSTMCell
   configuration and ``models.lstm_lm``'s fused default (2 epochs each)
   through ``BucketingModule.fit`` with Adam, every bucket on the
   primary's one store, compiled (a captured program a bucket, the
   perplexity accumulated on the card) and again under
   ``programs.eager()`` from the same start: the first step's B1 launch
   against its plain version and against the per-parameter update on
   copies, its outputs and gradients against the port on the CPU; B1
   launches equal to the steps; one capture a bucket; every bucket's
   parameters and gradients the slab views (equal data_ptr), none
   demoted; perplexity finite and (configuration 1) falling; the
   device-side perplexity against the host metric over 8 more batches;
   tokens/s, ms per step by bucket, peak memory, and a profiled repeat
   of those batches (idle share, device ms by kernel); the compiled and
   eager runs' parameters bit for bit.

9. train zoo — Inception-v3 (batch 32 of 3 x 299 x 299, bf16 compute
   over f32 masters, SGD lr 0.1) and AlexNet (batch 256 of 3 x 224 x 224,
   f32, SGD lr 0.01) at full width, train_imagenet.py --benchmark 1's
   settings (ZOO_TRAIN), through Module and the slab plan: a first step,
   unrecorded and with cuDNN's deterministic algorithms, whose B1 launch
   is held against its plain version and against the per-parameter
   update on copies (bit for bit), whose gradients are held against a
   ``plain=True`` module's in the two tiers, whose fixed gammas
   (Inception-v3's ``fix_gamma``) take a zero gradient and move by the
   weight decay alone; the graph's set-up and timed replays (one B1
   launch each); profiled steps, captured and eager (device time by
   kind of kernel); captured steps against eager ones bit for bit, the
   Dropout masks from generators seeded alike; AlexNet's LRN on the card
   against the CPU on its real input;
10. train MNIST — the canonical drive: MNISTIter's synthetic set,
   ``models.get_mlp`` then ``get_lenet``, one epoch of ``Module.fit``
   with SGD-momentum (one B1 launch a step), ``score`` at least
   MNIST_MIN_ACC; the MLP under AdaGrad and RMSProp (plain, centered)
   through the compiled step's per-parameter path, captured against
   eager bit for bit; AdaDelta (eager only) against the CPU;
11. zoo steps — VGG, GoogLeNet, Inception-BN and ResNeXt-50 at full
   width, one step each (batch 32, f32) with the first-step gates of
   phase 9 and one timed replay;
12. train SSD — the SSD example (``models.ssd``, SSD_* below) end to
   end: its record file, ImageDetIter, Adam through Module, 3 epochs of 8
   captured steps (one B1 launch each); the first step against the port
   on the CPU, captured against eager, the loss falling, the trained
   model's detections card vs CPU; img/s, step ms, idle share, peak
   memory, device ms by class (``train ssd`` lines);
13. detection ops — MultiBoxPrior (SSD300's six maps, 8,732 anchors),
   MultiBoxTarget with hard-negative mining and MultiBoxDetection (full
   NMS, nms_topk 400) at batch 8 and 21 classes, card against the CPU,
   timed (the ``detection:`` line, with the card's name and power
   limit).  The ops phase (6c) now also holds the contrib and spatial
   op cases, the 38 x 50 Proposal among them.

The last lines are a ``kernels`` JSON object, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
TF32 is off throughout (``allow_tf32`` False for matmuls and cuDNN), so
f32 products and convolutions are full f32.
"""
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12,    # CUDA cores, no tensor cores
              "bfloat16": 989e12}  # dense tensor-core rate
L2_FLUSH_BYTES = 64 << 20          # > the card's 50 MB L2

# the model: benchmarks/bench_decode.py's chip configuration
VOCAB, SEQ, EMBED, HEADS, FFN, LAYERS = 8192, 2048, 1024, 4, 4096, 2
# the training configuration: benchmarks/bench_train_kernels.py:71-86 on
# the chip, in f32 (with bf16 compute the reference casts token ids to
# bf16, which rounds ids above 256).  The bench's SGD rate, 0.01, does
# not train this f32 step stably: SoftmaxOutput's null-normalised
# gradient sums over the 2048 positions of a row, and the loss rises by
# the third step.  The timed steps use 0.001; the bench rate's losses are
# recorded beside them
TRAIN_BATCH, TRAIN_HEADS, TRAIN_LAYERS = 8, 8, 4
TRAIN_LR, BENCH_LR = 0.001, 0.01
TRAIN_STEPS = 3     # timed steps after one warm-up step
# inference (phase 6b): the training configuration's LM and weights
# through Module.predict, 20 sequences at batch 8 (two full batches and
# one padded by 4), then at batch 4 after Module.reshape; its profiled
# batch's device time by kind of kernel
PREDICT_N, PREDICT_SMALL_BATCH = 20, 4
PREDICT_OOB_PROMPT = 300    # the out-of-range serve's prompt length
PREDICT_KERNEL_GROUPS = {
    "A (simt_kernel)": ("simt_kernel",),
    "C (flash_fwd_simt)": ("flash_fwd_simt",),
    "products (the head, cuBLAS)": ("gemm", "sm90_", "cutlass", "xmma"),
    "softmax": ("softmax", "Softmax", "SoftMax"),
    "element-wise and reductions": ("elementwise", "reduce_kernel"),
    "copies": ("copy", "Copy", "Memcpy"),
}
# the ResNet-50 training configuration: bench.py:87-125 at full depth and
# width, one resident batch (x uniform(-1, 1), labels in [0, 1000))
RESNET_BATCH, RESNET_STEPS = 256, 3
RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# the captured-vs-eager gate and the checkpoint round trip: the timed
# steps' shapes (two modules of batch 256 alive at once in the round
# trip, twice the ~22 GB peak of one)
RESNET_GATE_STEPS = 3
# the bucketed LSTM language model.  Configuration 1 is
# benchmarks/bench_bucketing.py:32-60 at full width: two LSTMCell(200)
# layers ("l0_", "l1_") over a 10,000-word embedding of 200, an FC head
# ("fc") and SoftmaxOutput(use_ignore, ignore_label -1); batch 32,
# buckets 10 / 20 / 30 / 40 over 2,000 sentences of 5-40 tokens from
# RandomState(0), iterator seed 0; Xavier weights (torch's generator at
# seed 0), Adam at lr 0.001, Perplexity(ignore_label=-1); 2 epochs, the
# first a warm-up as in the bench.  Configuration 2 is
# models.lstm_lm.sym_gen_factory()'s defaults (FusedRNNCell 2 x 200 over
# the same embedding and vocabulary, the cuDNN RNN op) with the same
# padded head, 2 epochs over the same iterator (the first captures each
# bucket's step program).  Train in f32: token ids
# up to 9,999 ride in float data
LSTM_VOCAB, LSTM_EMBED, LSTM_HIDDEN, LSTM_LAYERS = 10000, 200, 200, 2
LSTM_BATCH, LSTM_BUCKETS, LSTM_SENTENCES = 32, [10, 20, 30, 40], 2000
LSTM_LR, LSTM_EPOCHS, LSTM_FUSED_EPOCHS = 0.001, 2, 2
LSTM_PARAMS = 4_653_200     # embed 2,000,000, 2 x 321,600, fc 2,010,000
LSTM_PROFILE_BATCHES = 8    # the profiled repeat, over every bucket
# the profiled LSTM steps' device time by kind of kernel; the copies to
# the host are the perplexity's read of each step's probabilities (the
# port's metrics reduce on the host), a copy engine's time, not a kernel's
LSTM_HOST_COPIES = "copies to the host (the metric)"
LSTM_KERNEL_GROUPS = {
    LSTM_HOST_COPIES: ("Memcpy DtoH",),
    "B1 (mtu_kernel)": ("mtu_kernel",),
    "cuDNN RNN": ("RNN", "rnn", "LSTM", "lstm"),
    "products": ("gemm", "gemv", "sm90_", "cutlass", "xmma", "splitK"),
    "softmax": ("softmax", "Softmax", "SoftMax"),
    "indexing (embedding, its scatter-add)": ("index",),
    "element-wise and reductions": ("elementwise", "reduce_kernel"),
    "casts and copies": ("copy", "Copy", "Cat"),
}
# the zoo's full-width training cells: example/image-classification's
# train_imagenet.py --benchmark 1 settings (BASELINE.md:9-16, from the
# reference's docs/how_to/perf.md:157-190): Inception-v3 at batch 32 of
# 3 x 299 x 299 with bf16 compute over f32 masters, AlexNet at batch 256
# of 3 x 224 x 224 in f32; SGD as ResNet-50's (RESNET_OPT: the script's
# default lr 0.1, momentum 0.9, wd 1e-4), but AlexNet, which has no
# BatchNorm, at lr 0.01: over one resident batch lr 0.1 takes its loss
# to NaN by the fifth step (measured with the port on the CPU at batch
# 16); weights Xavier(gaussian, in, 2) and one resident batch from
# RandomState(0), as _resnet_values draws them; every module that is
# compared draws its Dropout masks from a generator seeded with
# ZOO_DROPOUT_SEED
ZOO_TRAIN = {
    "inception_v3": {"batch": 32, "image": (3, 299, 299),
                     "compute_dtype": "bfloat16", "opt": RESNET_OPT,
                     "params": (284, 23_834_568), "classifier": ("fc_",)},
    "alexnet": {"batch": 256, "image": (3, 224, 224), "compute_dtype": None,
                "opt": dict(RESNET_OPT, learning_rate=0.01),
                "params": (16, 50_844_008),
                "classifier": ("fullyconnected2_",)},
}
ZOO_STEPS = 3       # timed steps after the set-up step
ZOO_DROPOUT_SEED = 11
# the profiled zoo steps' device time by kind of kernel (the first label
# whose substring a kernel's name holds)
ZOO_KERNEL_GROUPS = {
    "B1 (mtu_kernel)": ("mtu_kernel",),
    "cuDNN layout transposes": ("nchwToNhwc", "nhwcToNchw"),
    "convolutions and products": ("cudnn", "xmma", "gemm", "cutlass",
                                  "sm90_", "conv"),
    "Concat copies": ("CatArray",),
    "pooling": ("pool",),
    "casts and copies (the grad pack among them)": ("direct_copy", "copy",
                                                    "Copy"),
    "element-wise and reductions (BatchNorm, ReLU, LRN, Dropout)": (
        "elementwise", "reduce_kernel", "bernoulli"),
}
# the other zoo members, one step each at batch 32 of 3 x 224 x 224 in
# f32 against a plain=True module: (builder kwargs, classifier prefix,
# SGD settings; the nets without BatchNorm at lr 0.01, as AlexNet)
ZOO_ONE_STEP_BATCH, ZOO_ONE_STEP_IMAGE = 32, (3, 224, 224)
ZOO_ONE_STEP = {
    "vgg": ({}, ("fc8_",), ZOO_TRAIN["alexnet"]["opt"]),
    "googlenet": ({}, ("fc_",), ZOO_TRAIN["alexnet"]["opt"]),
    "inception_bn": ({}, ("fc1_",), RESNET_OPT),
    "resnext": ({"num_layers": 50}, ("fc_",), RESNET_OPT)}
# MNIST through the canonical drive (the reference's train_mnist.py):
# MNISTIter's synthetic set (6,000 images, seed 0; validation seed 1) at
# batch 100, one epoch of Module.fit with SGD-momentum, then score.  The
# JAX package's drive reaches accuracy 1.0 on the CPU with the MLP and
# with LeNet; the card must reach MNIST_MIN_ACC (its Xavier draws come
# from torch's generator, not numpy's)
MNIST_BATCH, MNIST_MIN_ACC = 100, 0.99
MNIST_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# AdaGrad / RMSProp through the compiled step's per-parameter path,
# captured against eager; AdaDelta (eager only) on the card against the
# CPU: parameters max |card - cpu| (the same f32 operations; the card
# divides by a host scalar as a product with its reciprocal)
MNIST_OPT_STEPS = 4
MNIST_PER_PARAM = (("adagrad", {"learning_rate": 0.05, "wd": 1e-4}),
                   ("rmsprop", {"learning_rate": 0.001, "wd": 1e-4}),
                   ("rmsprop", {"learning_rate": 0.001, "centered": True,
                                "clip_weights": 2.0}))
TOL_ADADELTA_CPU = 1e-5
# AlexNet's LRN on the card against the CPU: max |card - cpu| over max
# |cpu| for the output and the input gradient (f32 pow and division,
# correctly rounded on neither side)
TOL_LRN_CPU = 1e-5
# the profiled ResNet-50 step's device time by kind of kernel (kernel B1;
# convolutions and products, cuDNN's layout transposes; the BatchNorm /
# ReLU / loss element-wise ops and reductions; dtype casts and copies,
# the grad pack among them); the first label whose substring a kernel's
# name holds
RESNET_KERNEL_GROUPS = {
    "B1 (mtu_kernel)": ("mtu_kernel",),
    "cuDNN layout transposes": ("nchwToNhwc", "nhwcToNchw"),
    "convolutions and products": ("cudnn", "xmma", "gemm", "cutlass",
                                  "sm90_", "conv"),
    "casts and copies": ("direct_copy",),
    "element-wise and reductions": ("elementwise", "reduce_kernel"),
}
# the profiled serve's device time of kernel B and of its combine kernel
SERVE_KERNEL_GROUPS = {"B (paged_decode)": ("paged_decode_",),
                       "B's combine (paged_combine)": ("paged_combine",)}
SLOTS, PAGE_TOKENS, CHUNK, MAX_NEW = 4, 16, 256, 32
# speculation: benchmarks/bench_decode.py:139's spec_k, the n-gram
# proposer at MXNET_SPEC_NGRAM's default; a verify window is k + 1 rows
# a slot, so kernel A sees SLOTS x (k + 1) rows
SPEC_K, SPEC_NGRAM = 8, 2
VERIFY_M = SLOTS * (SPEC_K + 1)
# one decode or verify step's device time by kernel: A's weight-streaming
# (decode) and tile (simt) variants, B, its combine, and all of it
STEP_PARTS = {"all": "", "A decode": "decode_kernel", "A simt": "simt_kernel",
              "B": "paged_decode_", "combine": "paged_combine"}
# the sampled speculative serve's policy
SAMPLE_TEMPERATURE, SAMPLE_TOP_K, SAMPLE_SEED = 1.0, 8, 5
PROMPT_LENS = [384, 128, 640, 1024, 512, 300, 1000, 768]
SHARED_PREFIX = 256

# tolerances (kernel vs plain version on the same inputs)
TOL_A = {"float32": 1e-5, "bfloat16": 2 ** -7}   # x max|y| (abs)
TOL_A_STATS = {"float32": 1e-4, "bfloat16": 2 ** -7}
TOL_B = 1e-4        # absolute; outputs are O(1) averages of V rows
# teacher-forced |log p_kernel - log p_plain|: both sides read the same f32
# weights and int8 pages and accumulate in f32, so the gap is f32 rounding
# (~1e-6); a kernel that dropped to bf16 anywhere would round at bf16's
# relative step, 2^-8 ~ 4e-3
TOL_LOGP = 1e-4
# kernels C-E and F against their plain versions, relative to each
# output's largest magnitude: f32 outputs whose sums run over at most
# T = 2048 terms 1e-5 (the same f32 products in another order); F's dW,
# dscale and dshift sum over M = 16384 rows, one sequential f32 chain per
# thread plus per-tile atomics, 1e-4; bf16 outputs 2^-7 (one bf16 ulp)
TOL_F32, TOL_F32_LONG, TOL_BF16 = 1e-5, 1e-4, 2 ** -7
# the train step's gradients, kernel vs plain module from the same params
# and batch, as ||g_kernel - g_plain|| / ||g_plain|| per parameter.  Both
# sides are f32, so the gap is summation order (M = 16384-long sums,
# atomics): 1e-4 for the parameters the backward reaches before any ReLU
# (the head, the final LayerNorm, the last layer's ffn2).  Every other
# parameter's gradient passes through ffn2's ReLU mask, recomputed from a
# pre-activation that differs between the two runs by f32 rounding: the
# few elements within that rounding of 0 (about 1e-6 of them) flip the
# mask and move each downstream gradient by about sqrt(1e-6) of its norm,
# so 1e-2 there (a bf16 slip anywhere would flip about 4e-3 of them:
# about 6e-2).  The analytically-zero *_k_bias gradient is measured on
# its layer's *_q_bias gradient norm
TOL_TRAIN_GRAD, TOL_TRAIN_GRAD_RELU = 1e-4, 1e-2
# a compiled (captured) train step against its body run under
# programs.eager() from the same start.  ResNet-50 (with cuDNN's
# deterministic algorithms for the comparison) and the LSTM are held bit
# for bit.  The LM's kernel F sums the LayerNorm scale / shift gradients
# with atomics, so two eager runs of the LM differ from the first step,
# and near the edge of stability (lr 0.001, above) the difference grows
# with every step: one step from the same masters is held bit for bit
# but those gradients (TOL_F32_LONG there), and after 2 + TRAIN_STEPS
# steps per parameter ||captured - eager|| / ||eager - start|| (the train
# gradients' two tiers) to CAPTURE_SPREAD times two eager runs' own
# spread
CAPTURE_SPREAD = 4.0
# the perplexity the compiled step accumulates on the card against the
# host metric fed the same steps' outputs: per-batch exp(mean nll) summed
# in f32 on the card, in f64 on the host
TOL_DEVICE_METRIC = 1e-5
# the fused RNN op (cuDNN) against the unfused LSTMCell graph carrying the
# same blob (cuBLAS products, torch element-wise ops), both full f32 at
# batch 32, T 40, 2 x 200: outputs and final states absolute (values in
# (-1, 1); the same f32 products summed in another order), gradients of
# the data and of the blob relative to their largest magnitude (the same
# rounding chained back through 40 steps and 2 layers)
TOL_RNN_OUT, TOL_RNN_GRAD = 1e-5, 1e-4
# the first LSTM step on the card against the port on the CPU (ATen's
# loops and BLAS) from the same parameters and batch: outputs and every
# gradient, max |card - cpu| / max |cpu| per tensor
TOL_LSTM_CPU = 1e-4
# the first Adam update on the LSTM LM's shared slab against the
# per-parameter update on copies: the per-parameter update rounds
# 1 - beta1 and 1 - beta2 from f64 constants (the JAX package's eager
# adam_update), kernel B1 in f32 (its fused step), so the second moment
# differs by up to 4.7e-5 relative and the step by half that: each
# tensor within 1e-4 of its change, or 1 ulp where that is larger (the
# ulp distance is printed).  Kernel
# B1 against its plain version on copies of the slabs stays within 1 ulp
TOL_ADAM_PER_PARAM = 1e-4
# kernel B1 against its plain version: SGD and SGD-momentum bit for bit
# (both round every f32 product and sum once, in the same order); Adam
# within one f32 ulp (its square root and quotient are correctly rounded
# on both sides, so 0 is expected and the measured distance is printed)
B1_ADAM_ULPS = 1
# the imperative LM (phase 6c): the training configuration written as
# nd calls under autograd.record() with an sgd_update per parameter (the
# Module's rescale_grad, 1 / batch), IMP_GATE_STEPS steps held against a
# Module's eager SGD steps (kernel B1, bit for bit with the per-parameter
# update), then IMP_TIMED_STEPS timed steps.  Gates: the first step's
# loss within TOL_IMP_LOSS relative of the Module's (the same kernels on
# the same inputs; only F's atomics differ, in the LayerNorm gradients),
# every first-step gradient within TOL_TRAIN_GRAD norm-wise, every
# parameter after that step within TOL_IMP_PARAMS of the Module's,
# ||dw|| / ||w||.  Past the first step the runs part: at this learning
# rate (the edge of stability, above) F's atomics flip ReLU masks and
# the difference grows with every step, so two Module runs from the same
# start differ too.  After IMP_GATE_STEPS steps the imperative run is
# held to CAPTURE_SPREAD times two Module runs' own spread, per tier, as
# the captured step is held to eager ones (phase 6)
IMP_GATE_STEPS, IMP_TIMED_STEPS = 3, 3
TOL_IMP_LOSS, TOL_IMP_PARAMS = 1e-6, 1e-5
# phase 6c's ops: every op case on the card against the CPU, f32 with
# TF32 off: |card - cpu| <= TOL_OPS_CARD x max(1, max|cpu|) (the same
# formulas in CUDA's and the host's libraries, a few ulp apart; cuDNN's
# and the host's convolutions sum in another order, and the backward
# scatter-adds of count_sketch, the gathers and the bilinear sampler add
# with atomics on the card); the
# samplers' mean and variance over OPS_DRAWS draws within 6 standard
# errors of the difference
TOL_OPS_CARD, OPS_DRAWS = 1e-5, 100000
# greedy tokens of the kernel run and the plain run must all agree: the
# weights and prompts are seeded, so a near-tie that a 1e-6 gap could flip
# would show in every run, not now and then
MIN_GREEDY_AGREEMENT = 1.0
# phase 12, the SSD example (examples/ssd_detection.py) at its own
# widths (32 x 32 images, 16 / 32 filters, 256 anchors, 3 classes):
# make_dataset's 64 records, ImageDetIter at batch 8 (shuffle, mirror,
# seed 0), Adam lr 2e-3, 3 epochs of 8 steps through Module, captured.
# Its first step on the card against the port on the CPU: the class
# targets and box masks exactly, the two losses (the class cross-entropy
# and the smooth-L1 box loss, per image) within TOL_SSD_LOSS relative,
# the gradients in _grad_tiers' two tiers (the heads, cls_pred_* /
# loc_pred_*, reach no ReLU; c1 / c2 are behind one)
SSD_IMAGES, SSD_BATCH, SSD_EPOCHS = 64, 8, 3
SSD_OPT = {"learning_rate": 2e-3}
SSD_DIRECT = ("cls_pred_", "loc_pred_")
TOL_SSD_LOSS = 1e-5
SSD_KERNEL_GROUPS = {"convolutions": ("conv", "cudnn", "xmma", "gemm",
                                      "Conv", "wgrad", "dgrad"),
                     "B1 (multi_tensor_update)": ("mtu_kernel",)}
# phase 13, the MultiBox ops at SSD300 scale (VOC, 21 classes, batch 8,
# benchmarks/bench_detection.py): MXNet's example/ssd VGG16-reduced
# priors over six maps (8,732 anchors), MultiBoxTarget with hard-negative
# mining, MultiBoxDetection on the bench's inputs with full NMS and with
# nms_topk 400.  Card against the port on the CPU: integer outputs
# exactly, floats within TOL_DET x max(1, max|cpu|)
DET_MAPS = (38, 19, 10, 5, 3, 1)
DET_SIZES = ((.1, .141), (.2, .272), (.37, .447), (.54, .619), (.71, .79),
             (.88, .961))
DET_RATIOS = ((1, 2, .5), (1, 2, .5, 3, 1 / 3), (1, 2, .5, 3, 1 / 3),
              (1, 2, .5, 3, 1 / 3), (1, 2, .5), (1, 2, .5))
DET_STEPS = (8, 16, 32, 64, 100, 300)
DET_ANCHORS, DET_CLASSES, DET_BATCH, DET_TOPK = 8732, 21, 8, 400
DET_LABEL_ROWS = 16
TOL_DET = 1e-5


def log(*args):
    print(*args, flush=True)


def _timed(torch, fn, flush, iters):
    """Mean ms of ``fn`` over ``iters`` launches, the L2 flushed before
    each (events around the call only)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _kernel_us(evt):
    """Device microseconds of a profiler row that is a device activity
    (a kernel, memcpy or memset); 0 for host ops, whose device time
    would count their kernels twice."""
    if "CUDA" not in str(getattr(evt, "device_type", "")):
        return 0.0
    us = getattr(evt, "self_device_time_total", None)
    return us if us is not None else evt.self_cuda_time_total


def _device_ms(torch, fn, calls=3):
    """Device-busy ms per call of ``fn`` (the sum of its kernels' device
    time under torch.profiler, no host time), or "not measured" when the
    profiler sees no device activity."""
    return _device_parts(torch, fn, {"all": ""}, calls)["all"]


def _device_parts(torch, fn, parts, calls=3):
    """Device ms per call of ``fn`` by part: {label: ms of the kernels
    whose names hold the label's substring}, one profiled run (profiled
    again, at most twice, when it recorded no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [(_kernel_us(e), e.key) for e in prof.key_averages()]
        out = {label: sum(us for us, k in rows if sub in k) * 1e-3 / calls
               for label, sub in parts.items()}
        if any(v > 0 for v in out.values()):
            return out
    return {label: "not measured" for label in parts}


def _bound_share(case):
    """The achieved share of the bound: bound ms over the kernel's device
    ms ("not measured" without a device reading)."""
    dev = case["device_ms"]["kernel"]
    return case["bound_ms"] / dev if isinstance(dev, float) else dev


def phase_build():
    from mxnet_tpu_torch import cuda_build

    t0 = time.perf_counter()
    cuda_build.build()
    dt = time.perf_counter() - t0
    for name, text in cuda_build.BUILD_LOG.items():
        for line in text.splitlines():
            if "Used" in line or "error" in line.lower():
                log("ptxas %s: %s" % (name, line.strip()))
    log("build: %d kernel libraries in %.2f s" % (len(cuda_build.SOURCES),
                                                  dt))


def _a_case(torch, dev, flush, g, dtype, m, k, n, relu_res):
    """Kernel A at one (M, K, N) against its plain version, timed beside
    the plain version and an ``addmm`` yardstick."""
    from mxnet_tpu_torch.ops import fused_kernel as fk

    dname = str(dtype).split(".")[-1]
    isz = torch.empty((), dtype=dtype).element_size()

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x = r(m, k).to(dtype)
    w = (r(n, k) / k ** 0.5).to(dtype)
    scale, shift, bias = 1 + 0.1 * r(k), 0.1 * r(k), 0.1 * r(n)
    res = r(m, n).to(dtype) if relu_res else None
    kw = dict(residual=res, relu=relu_res, bias=bias)
    got = fk.fused_scale_relu_matmul(x, scale, shift, w, **kw)
    variant = fk.LAST_VARIANT["fused_fwd"]
    want = fk.fused_plain(x, scale, shift, w, **kw)
    torch.cuda.synchronize()
    err = float((got[0].float() - want[0].float()).abs().max())
    mag = max(1.0, float(want[0].float().abs().max()))
    if not err <= TOL_A[dname] * mag:
        raise AssertionError(
            "kernel A %s m=%d k=%d n=%d: max |y - plain| %.3g > %.3g"
            % (dname, m, k, n, err, TOL_A[dname] * mag))
    yabs = want[0].float().abs()
    for i, lim in ((1, yabs.sum(0)), (2, (yabs * yabs).sum(0))):
        serr = (got[i] - want[i]).abs()
        if not bool((serr <= TOL_A_STATS[dname]
                     * torch.clamp_min(lim, 1.0)).all()):
            raise AssertionError(
                "kernel A %s m=%d k=%d n=%d: column statistic %d off by "
                "%.3g" % (dname, m, k, n, i, float(serr.max())))
    # the library yardstick: one addmm on the pre-applied input (no
    # prologue, no statistics)
    a = x.float() * scale + shift
    if relu_res:
        a = torch.clamp_min(a, 0)
    a = a.to(dtype)
    c = (bias + res.float()).to(dtype) if relu_res else bias.to(dtype)
    wt = w.t()
    iters = 20
    ms = _timed(torch, lambda: fk.fused_scale_relu_matmul(
        x, scale, shift, w, **kw), flush, iters)
    plain_ms = _timed(torch, lambda: fk.fused_plain(
        x, scale, shift, w, **kw), flush, iters)
    lib_ms = _timed(torch, lambda: torch.addmm(c, a, wt), flush, iters)
    dev_ms = {
        "kernel": _device_ms(torch, lambda: fk.fused_scale_relu_matmul(
            x, scale, shift, w, **kw)),
        "plain": _device_ms(torch, lambda: fk.fused_plain(
            x, scale, shift, w, **kw)),
        "library": _device_ms(torch, lambda: torch.addmm(c, a, wt))}
    nbytes = (m * k * isz + 2 * k * 4 + n * k * isz + n * 4
              + (m * n * isz if relu_res else 0) + m * n * isz + 2 * n * 4)
    bound_ms, bound_by = _bound(nbytes, 2.0 * m * n * k, dname)
    case = {"dtype": dname, "m": m, "k": k, "n": n,
            "relu_residual": relu_res, "variant": variant,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "device_ms": dev_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}
    case["bound_share"] = _bound_share(case)
    log("kernel A case: " + json.dumps(case))
    return case


def phase_kernel_a(torch, dev, flush):
    """Kernel A at the LM's segments: M = 4 (decode), 256 (a prefill
    chunk) and 16384 (a training batch of 8 x 2048 tokens);
    q/k/v/attout-sized (1024, 1024), ffn1 (1024, 4096) and ffn2 (4096,
    1024, ReLU + residual); f32 and bf16.  Then at the speculative serve's
    verify rows, M = 4 slots x 9 = 36, f32: ffn1, ffn2 and a head-wide N
    (1024 -> 8192; the model's head itself is a FullyConnected)."""
    cases = []
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for m in (4, 256, TRAIN_BATCH * SEQ):
            for k, n, relu_res in ((1024, 1024, False), (1024, 4096, False),
                                   (4096, 1024, True)):
                cases.append(_a_case(torch, dev, flush, g, dtype, m, k, n,
                                     relu_res))
    for k, n, relu_res in ((EMBED, FFN, False), (FFN, EMBED, True),
                           (EMBED, VOCAB, False)):
        cases.append(_a_case(torch, dev, flush, g, torch.float32, VERIFY_M,
                             k, n, relu_res))
    return cases


def _pools(torch, attn, dev, g, pages, kvh, hd, dtype):
    e_kv = kvh * hd

    def one():
        x = torch.randn(1, pages * PAGE_TOKENS, e_kv, generator=g,
                        device=dev)
        if dtype == torch.float32:
            return x.reshape(pages, PAGE_TOKENS, e_kv)
        q = attn.quantize_kv(x, dtype, kvh)
        return attn.QuantKV(q.data.reshape(pages, PAGE_TOKENS, e_kv),
                            q.scale.reshape(pages, PAGE_TOKENS, kvh))

    return one(), one()


def phase_kernel_b(torch, dev, flush):
    """Kernel B and its combine kernel at the serving shapes: 4 slots x
    2048-token views of 16-token pages, 4 heads of 256; tq = 1 (decode, 4
    slots) and tq = 256 (a prefill chunk, 1 slot); f32 / int8 / fp8-e4m3
    pools; G = 1 and 2; padded, long and wrapped rings; the int8 G = 1
    decode at 8 heads of 128; and the speculative serve's verify window,
    tq = SPEC_K + 1 = 9 over int8 pages at G = 1, 4 slots at lengths like
    the serve's.  Each case names the variant, split count, rows a block
    serves and row tiles ``decode_kernel._plan`` chose and reports the
    combine kernel's device ms beside kernel B's; the combine is also
    held against its plain version (``_combine``) on the case's own
    partials."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import attention as attn
    from mxnet_tpu_torch.ops import decode_kernel as dk

    cases = []
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    m = SEQ // PAGE_TOKENS
    c = m * PAGE_TOKENS
    pages = SLOTS * m + 1
    perm = torch.randperm(pages - 1, generator=g, device=dev).to(
        torch.int32) + 1
    table_all = perm[:SLOTS * m].reshape(SLOTS, m).contiguous()
    windows = ((1, [130, 700, 1100, c + 37]), (CHUNK, [768 + CHUNK]))
    verify = (SPEC_K + 1, [416, 160, 672, 1056])
    configs = [(HEADS, pdt, group,
                windows + ((verify,) if (pdt, group) == (torch.int8, 1)
                           else ()))
               for pdt in (torch.float32, torch.int8, torch.float8_e4m3fn)
               for group in (1, 2)]
    # head dim 128 (twice the heads over the same width): the decode
    # variant's four-dim lanes
    configs.append((2 * HEADS, torch.int8, 1, windows[:1]))
    for heads, pdt, group, wins in configs:
        pname = str(pdt).split(".")[-1]
        hd = EMBED // heads
        kvh = heads // group
        kp, vp = _pools(torch, attn, dev, g, pages, kvh, hd, pdt)
        isz = torch.empty((), dtype=pdt).element_size()
        for tq, lens_list in wins:
            b = len(lens_list)
            table = table_all[:b].contiguous()
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            q = torch.randn(b, tq, EMBED, generator=g, device=dev)
            fn = dk.flash_sdpa_decode if tq == 1 \
                else dk.flash_sdpa_verify
            kw = dict(num_heads=heads, num_kv_heads=kvh)
            got = fn(q, kp, vp, table, lens, **kw)
            variant = dk.LAST_VARIANT["paged_decode"]
            plan = dk._plan(b, tq, heads, kvh, hd, hd, m, PAGE_TOKENS,
                            dk._sm_count(dev))
            want = dk.paged_plain(q, kp, vp, table, lens, heads, None,
                                  kvh)
            parts = dk._paged_launch(q, kp, vp, table, lens, heads,
                                     None, kvh, combined=False)
            comb = dk._launch_combine(*parts)
            comb_plain = dk._combine(*parts)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not (err <= TOL_B and bool(torch.isfinite(got).all())):
                raise AssertionError(
                    "kernel B %s hd=%d G=%d tq=%d: max |out - plain| %.3g "
                    "> %.3g" % (pname, hd, group, tq, err, TOL_B))
            comb_err = float((comb - comb_plain).abs().max())
            if not comb_err <= TOL_B:
                raise AssertionError(
                    "combine kernel %s hd=%d G=%d tq=%d: max |out - plain| "
                    "%.3g > %.3g" % (pname, hd, group, tq, comb_err, TOL_B))
            # yardstick: SDPA over the already-gathered, dequantized
            # view (it skips the page walk and the dequantization)
            kv = attn.dequantize_kv(attn.paged_gather(kp, table), kvh)
            vv = attn.dequantize_kv(attn.paged_gather(vp, table), kvh)
            kh = kv.reshape(b, c, kvh, hd).permute(0, 2, 1, 3)
            vh = vv.reshape(b, c, kvh, hd).permute(0, 2, 1, 3)
            qh = q.reshape(b, tq, heads, hd).permute(0, 2, 1, 3)
            limit = torch.clamp_max(
                lens.long()[:, None] - (tq - 1)
                + torch.arange(tq, device=dev)[None, :], c)
            mask = (torch.arange(c, device=dev)[None, None, :]
                    < limit[:, :, None])[:, None]
            iters = 20
            ms = _timed(torch, lambda: fn(q, kp, vp, table, lens, **kw),
                        flush, iters)
            plain_ms = _timed(torch, lambda: dk.paged_plain(
                q, kp, vp, table, lens, heads, None, kvh), flush, iters)
            lib_ms = _timed(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=group > 1),
                flush, iters)
            comb_ms = _timed(torch, lambda: dk._launch_combine(*parts),
                             flush, iters)
            comb_plain_ms = _timed(torch, lambda: dk._combine(*parts),
                                   flush, iters)
            dev_parts = _device_parts(
                torch, lambda: fn(q, kp, vp, table, lens, **kw),
                {"kernel_b": "paged_decode_", "combine": "paged_combine"})
            dev_ms = {
                "kernel": _device_ms(torch, lambda: fn(
                    q, kp, vp, table, lens, **kw)),
                "kernel_b": dev_parts["kernel_b"],
                "combine": dev_parts["combine"],
                "combine_plain": _device_ms(
                    torch, lambda: dk._combine(*parts)),
                "plain": _device_ms(torch, lambda: dk.paged_plain(
                    q, kp, vp, table, lens, heads, None, kvh)),
                "library": _device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask,
                        enable_gqa=group > 1))}
            live = [min(int(t), c) for t in lens_list]
            nbytes = (q.numel() * 4 + b * m * 4 + b * 4
                      + b * tq * EMBED * 4
                      + sum(live) * kvh * hd * isz * 2
                      + (sum(live) * kvh * 4 * 2 if pdt != torch.float32
                         else 0))
            keys = sum(min(int(t) - (tq - 1) + i, c)
                       for t in lens_list for i in range(tq))
            flops = 4.0 * keys * heads * hd
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS["float32"]
            # the combine reads m and l of every split, acc of the
            # splits that saw something, and writes the output
            seen = int((parts[1] > -torch.inf).sum())
            comb_bytes = (seen * hd + parts[1].numel() * 2) * 4 \
                + b * tq * EMBED * 4
            case = {"pool": pname, "head_dim": hd, "group": group, "tq": tq,
                    "lens": lens_list, "variant": variant,
                    "splits": plan.splits,
                    "pages_per_split": plan.pages_per_split,
                    "rows": plan.rows, "row_tiles": plan.row_tiles,
                    "blocks": plan.blocks, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "device_ms": dev_ms,
                    "bound_ms": max(t_bytes, t_ops) * 1e3,
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations",
                    "combine": {
                        "max_abs_err": comb_err, "ms": comb_ms,
                        "plain_ms": comb_plain_ms,
                        "bound_ms": comb_bytes / HBM_BYTES_PER_S * 1e3,
                        "bound_by": "bytes",
                        "device_ms": dev_parts["combine"],
                        "plain_device_ms": dev_ms["combine_plain"],
                        "splits_seen": seen}}
            case["bound_share"] = _bound_share(case)
            log("kernel B case: " + json.dumps(case))
            cases.append(case)
            del parts, comb, comb_plain
    return cases


def _lm(torch, dev):
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.weights import params_from_jax

    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=SEQ,
                                  num_layers=LAYERS, embed=EMBED,
                                  heads=HEADS, ffn_hidden=FFN)
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = sym.infer_shape(data=(1, SEQ),
                                       softmax_label=(1, SEQ))
    params = {n: rng.normal(0, 0.02, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    n_params = sum(v.size for v in params.values())
    return sym, params_from_jax(params, device=dev), n_params


def _prompts():
    rng = np.random.RandomState(1)
    shared = rng.randint(0, VOCAB, SHARED_PREFIX)
    out = []
    for i, n in enumerate(PROMPT_LENS):
        if i % 2 == 0:
            out.append(np.concatenate(
                [shared, rng.randint(0, VOCAB, n - SHARED_PREFIX)]))
        else:
            out.append(rng.randint(0, VOCAB, n))
    return out


def _predictor(sym, params, plain, dev, **kw):
    from mxnet_tpu_torch.decode import DecodePredictor

    return DecodePredictor(sym, params, cache_len=SEQ, device=dev,
                           paged=True, kv_dtype="int8",
                           page_tokens=PAGE_TOKENS, prefill_chunk=CHUNK,
                           plain=plain, **kw)


def _serve(torch, pred, prompts, **kw):
    """Serve ``prompts`` through a new DecodeServer (``kw``: its
    speculation and seed arguments); returns (results, wall s,
    stats)."""
    from mxnet_tpu_torch.decode import DecodeServer

    srv = DecodeServer(pred, max_prefill=max(PROMPT_LENS), slots=SLOTS,
                       max_new_tokens=MAX_NEW, **kw)
    for p in prompts:
        srv.submit(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = srv.run()
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0, dict(srv.stats(),
                                                   chunks=srv.chunks)


def _profile(torch, run, groups=None):
    """Device time by kernel over one more run of ``run`` (which returns
    its wall seconds, ending in a synchronize) under torch.profiler: busy
    share of the wall clock and the kernels that take most of it; with
    ``groups`` ({label: name substrings}), the device time of the kernels
    whose names hold each label's substrings (first label that matches).
    The profiler slows the host side, so the idle share read here is an
    upper bound."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    rows = [(_kernel_us(e), e.count, e.key) for e in prof.key_averages()]
    rows = [r for r in rows if r[0] > 0]
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) * 1e-6
    if not rows:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    out = {"wall_s": wall, "device_busy_s": busy_s,
           "device_idle_share": 1.0 - busy_s / wall,
           "top": [{"name": k[:90], "calls": n, "device_ms": us * 1e-3,
                    "share_of_busy": us * 1e-6 / busy_s}
                   for us, n, k in rows[:10]]}
    if groups:
        sums = {label: [0, 0.0] for label in list(groups) + ["other"]}
        for us, n, k in rows:
            label = next((lb for lb, subs in groups.items()
                          if any(sub in k for sub in subs)), "other")
            sums[label][0] += n
            sums[label][1] += us
        out["groups"] = {lb: {"calls": n, "device_ms": us * 1e-3,
                              "share_of_busy": us * 1e-6 / busy_s}
                         for lb, (n, us) in sums.items()}
    return out


def _idle_shares(profile, profile_eager, step_s, eager_step_s):
    """A training step's idle share, captured and eager: 1 - the device
    busy seconds of its profiled repeat / the wall of the timed
    (unprofiled) step.  The profiler slows the host, the eager step's
    thousands of launches most, so the profiled steps' own shares
    (``profiled``) are upper bounds only."""
    out = {}
    for key, prof, wall in (("captured", profile, step_s),
                            ("eager", profile_eager, eager_step_s)):
        busy = prof["device_busy_s"]
        out[key] = 1.0 - busy / wall if isinstance(busy, float) else busy
    out["profiled"] = {"captured": profile.get("device_idle_share"),
                       "eager": profile_eager.get("device_idle_share")}
    return out


def _serve_reading(stats, wall, tokens, profile):
    """A serve's end-to-end numbers: tokens/s, TTFT, wall, and the
    device busy seconds of its profiled repeat, with the idle share of
    the timed (unprofiled) wall and of the profiled one."""
    busy = profile["device_busy_s"]
    measured = isinstance(busy, float)
    return {"tokens_per_s": tokens / wall, "wall_s": wall,
            "ttft_p50_s": stats.get("ttft_p50_s"),
            "ttft_p95_s": stats.get("ttft_p95_s"),
            "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall if measured else busy,
            "profiled_wall_s": profile["wall_s"],
            "profiled_idle_share": profile.get("device_idle_share", busy)}


def phase_serve(torch, dev):
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.ops import attention as attn
    from mxnet_tpu_torch.ops import decode_kernel as dk
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.ops import fused_lm

    sym, params, n_params = _lm(torch, dev)
    log("model: attention_lm vocab=%d embed=%d heads=%d ffn=%d layers=%d "
        "params=%d (f32)" % (VOCAB, EMBED, HEADS, FFN, LAYERS, n_params))
    prompts = _prompts()
    pred = _predictor(sym, params, False, dev)
    # every paged program captured before the first request
    report = pred.prepare_programs(SLOTS, CHUNK)
    log("prepare_programs: " + json.dumps(report))
    log("program fingerprints: "
        + json.dumps(pred.program_fingerprints(SLOTS, CHUNK)))
    # warm-up: CUDA context, library handles, allocator
    _serve(torch, pred, [p[:64] for p in prompts[:2]])

    def counted_serve():
        fk.LAUNCHES["fused_fwd"] = 0
        dk.LAUNCHES["paged_decode"] = dk.LAUNCHES["paged_combine"] = 0
        replays = programs.GRAPH_STATS["replays"]
        out = _serve(torch, pred, prompts)
        launches = {"fused_fwd": fk.LAUNCHES["fused_fwd"],
                    "paged_decode": dk.LAUNCHES["paged_decode"],
                    "paged_combine": dk.LAUNCHES["paged_combine"]}
        return out + (launches,
                      programs.GRAPH_STATS["replays"] - replays)

    # the captured programs (the default), then the same requests with
    # every program run as its eager body
    results, wall, stats, launches, replays = counted_serve()
    paths = {"fused": fused_lm.FUSED_PATH["last"],
             "decode": attn.DECODE_PATH["last"]}
    log("serve launches: %s paths: %s replays: %d (steps %d, chunks %d)"
        % (launches, paths, replays, stats["steps"], stats["chunks"]))
    if min(launches.values()) <= 0 or paths != {"fused": "kernel",
                                                 "decode": "kernel"}:
        raise AssertionError("the serve did not run through every kernel: "
                             "%s %s" % (launches, paths))
    if replays < stats["steps"] + stats["chunks"]:
        raise AssertionError("%d replays for %d decode steps and %d chunks"
                             % (replays, stats["steps"], stats["chunks"]))
    for rid in range(len(prompts)):
        toks = results[rid]
        if toks.shape != (MAX_NEW,) or toks.min() < 0 \
                or toks.max() >= VOCAB:
            raise AssertionError("request %d returned %s" % (rid, toks))
    with programs.eager():
        e_results, e_wall, e_stats, e_launches, e_replays = counted_serve()
    log("eager serve launches: %s replays: %d" % (e_launches, e_replays))
    if any(not np.array_equal(results[r], e_results[r]) for r in results):
        raise AssertionError("greedy tokens of the captured and eager runs "
                             "differ")
    if e_launches != launches:
        raise AssertionError("launches of the captured run %s != the eager "
                             "run's %s" % (launches, e_launches))

    # the same requests with every kernel's plain version (eager)
    plain = _predictor(sym, params, True, dev)
    with programs.eager():
        p_results, p_wall, _ = _serve(torch, plain, prompts)
    agree = float(np.mean([np.mean(results[r] == p_results[r])
                           for r in results]))
    if not agree >= MIN_GREEDY_AGREEMENT:
        raise AssertionError("greedy tokens of the kernel and plain runs "
                             "agree at %.4f < %.4f"
                             % (agree, MIN_GREEDY_AGREEMENT))

    # teacher-forced probabilities: the kernel run's tokens fed to both
    # (the kernel side through the captured programs)
    batch = np.zeros((SLOTS, max(PROMPT_LENS[:SLOTS])), np.float32)
    for i in range(SLOTS):
        batch[i, :PROMPT_LENS[i]] = prompts[i]
    lens = np.asarray(PROMPT_LENS[:SLOTS])
    replays_tf = programs.GRAPH_STATS["replays"]
    ks, kprobs = pred.prefill(batch, lens)
    with programs.eager():
        ps, pprobs = plain.prefill(batch, lens)
    worst = 0.0
    for step in range(9):
        if not bool(torch.isfinite(kprobs).all()) \
                or tuple(kprobs.shape) != (SLOTS, VOCAB):
            raise AssertionError("bad probabilities at step %d" % step)
        worst = max(worst, float((torch.log(kprobs.double())
                                  - torch.log(pprobs.double())).abs().max()))
        if step == 8:
            break
        forced = torch.tensor([[int(results[i][step])]
                               for i in range(SLOTS)], dtype=torch.int32,
                              device=dev)
        ks, kprobs = pred.step(ks._replace(tok=forced))
        with programs.eager():
            ps, pprobs = plain.step(ps._replace(tok=forced.clone()))
    if programs.GRAPH_STATS["replays"] - replays_tf < 8:
        raise AssertionError("the teacher-forced steps did not replay the "
                             "captured programs")
    if not worst <= TOL_LOGP:
        raise AssertionError("teacher-forced |log p_kernel - log p_plain| "
                             "%.3g > %.3g" % (worst, TOL_LOGP))
    tokens = sum(len(t) for t in results.values())
    profile = _profile(torch, lambda: _serve(torch, pred, prompts)[1],
                       groups=SERVE_KERNEL_GROUPS)
    with programs.eager():
        e_profile = _profile(torch, lambda: _serve(torch, pred, prompts)[1],
                             groups=SERVE_KERNEL_GROUPS)
    traces = pred.trace_counts
    log("trace_counts: " + json.dumps(traces))
    log("graph stats: " + json.dumps(programs.GRAPH_STATS))
    if (traces["decode"], traces["chunk"], traces["commit"]) != (1, 1, 1) \
            or traces["fork"] > 1:
        raise AssertionError("the serve captured its programs again: %s"
                             % traces)
    serve = {"requests": len(prompts), "tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall,
             "ttft_p50_s": stats.get("ttft_p50_s"),
             "ttft_p95_s": stats.get("ttft_p95_s"),
             "decode_steps": stats["steps"], "chunks": stats["chunks"],
             "replays": replays,
             "prefix_cache_hit_rate": stats.get("prefix_cache_hit_rate"),
             "cow_forks": stats.get("cow_forks"),
             "captured": _serve_reading(stats, wall, tokens, profile),
             "eager": _serve_reading(e_stats, e_wall, tokens, e_profile),
             "plain_wall_s": p_wall, "plain_tokens_per_s": tokens / p_wall,
             "greedy_token_agreement": agree,
             "teacher_forced_max_abs_dlogp": worst,
             "launches": launches}
    log("serve: " + json.dumps(serve))
    log("profile: " + json.dumps(profile))
    log("eager profile: " + json.dumps(e_profile))
    return serve, launches, (sym, params, results)


def _launch_counts():
    from mxnet_tpu_torch.ops import decode_kernel as dk
    from mxnet_tpu_torch.ops import fused_kernel as fk

    return {"fused_fwd": fk.LAUNCHES["fused_fwd"],
            "paged_decode": dk.LAUNCHES["paged_decode"],
            "paged_combine": dk.LAUNCHES["paged_combine"]}


def _spec_reading(stats):
    """Steps and acceptance of a speculative serve: decode and verify
    steps, chunks, drafted and accepted tokens, and the tokens a verify
    step commits, per active slot (1 + k x accept rate) and in all."""
    spec = stats["spec_steps"]
    slot_steps = stats["proposed"] / SPEC_K
    return {"decode_steps": stats["steps"] - spec, "verify_steps": spec,
            "chunks": stats["chunks"], "proposed": stats["proposed"],
            "accepted": stats["accepted"],
            "accept_rate": stats["accept_rate"],
            "tokens_per_verify_step_per_slot":
                1.0 + SPEC_K * stats["accept_rate"],
            "tokens_per_verify_step":
                (stats["accepted"] + slot_steps) / spec if spec else None}


def _first_rejection(torch, pred):
    """Wrap ``pred.paged_verify`` to record the first window in which an
    active row rejected a draft: row, position, the draft, the token the
    target emitted there and the target's top-2 log-probability gap."""
    real = pred.paged_verify
    seen = {}

    def spy(state, lens_h, drafts, draft_probs=None, generator=None,
            active=None):
        out = real(state, lens_h, drafts, draft_probs, generator, active)
        if not seen:
            counts = out[2].cpu().numpy()
            act = np.ones(len(counts)) if active is None \
                else np.asarray(active)
            bad = [r for r in range(len(counts))
                   if act[r] and counts[r] < SPEC_K + 1]
            if bad:
                r, i = bad[0], int(counts[bad[0]]) - 1
                top = torch.log(pred.verify_probs[r, i].double()).topk(2)
                seen.update(row=r, position=i,
                            draft=int(np.asarray(drafts[r, i].cpu()
                                                 if torch.is_tensor(drafts)
                                                 else drafts[r, i])),
                            emitted=int(out[1][r, i]),
                            top2=top.indices.tolist(),
                            top2_logp_gap=float(top.values[0]
                                                - top.values[1]))
        return out

    pred.paged_verify = spy
    return seen


def phase_serve_spec(torch, dev, base):
    """The serve cell with speculation: the same model and requests,
    spec_k 8 with the n-gram proposer, captured (timed), under
    programs.eager(), and with the plain versions; then a teacher-forced
    verify against the plain predictor, a self-draft serve and a sampled
    serve."""
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.decode import DecodePredictor, NGramProposer
    from mxnet_tpu_torch.ops import decode_kernel as dk

    sym, params, base_results = base
    prompts = _prompts()
    spec = dict(proposer=NGramProposer(SPEC_K, SPEC_NGRAM))
    pred = _predictor(sym, params, False, dev)
    report = pred.prepare_programs(SLOTS, CHUNK, spec_k=SPEC_K)
    keys = pred.program_fingerprints(SLOTS, CHUNK, spec_k=SPEC_K)
    log("serve spec: prepare_programs: " + json.dumps(report))
    log("serve spec: program fingerprints: " + json.dumps(keys))
    if "verify" not in report["programs"] or "verify" not in keys \
            or report["programs"]["verify"]["source"] != "capture":
        raise AssertionError("prepare_programs did not capture verify: %s"
                             % report)
    _serve(torch, pred, [p[:64] for p in prompts[:2]], **spec)

    def counted(p, **kw):
        before = _launch_counts()
        replays = programs.GRAPH_STATS["replays"]
        out = _serve(torch, p, prompts, **dict(spec, **kw))
        after = _launch_counts()
        return out + ({n: after[n] - before[n] for n in after},
                      programs.GRAPH_STATS["replays"] - replays)

    results, wall, stats, launches, replays = counted(pred)
    reading = _spec_reading(stats)
    log("serve spec launches: %s replays: %d %s"
        % (launches, replays, json.dumps(reading)))
    # 1. greedy speculation emits the non-speculative serve's tokens
    diff = [r for r in base_results
            if not np.array_equal(results[r], base_results[r])]
    if diff:
        raise AssertionError("speculative tokens differ from the serve's "
                             "for requests %s" % diff)
    # 4. counters
    if stats["spec_steps"] <= 0 or min(launches.values()) <= 0:
        raise AssertionError("no verify step or a kernel not launched: %s "
                             "%s" % (reading, launches))
    if replays < reading["decode_steps"] + reading["verify_steps"] \
            + reading["chunks"]:
        raise AssertionError("%d replays for %s" % (replays, reading))
    # 2. the eager bodies: the same tokens and launches
    with programs.eager():
        e_results, e_wall, e_stats, e_launches, _ = counted(pred)
    if any(not np.array_equal(results[r], e_results[r]) for r in results):
        raise AssertionError("speculative tokens of the captured and eager "
                             "runs differ")
    if e_launches != launches:
        raise AssertionError("launches of the captured speculative run %s "
                             "!= the eager run's %s" % (launches,
                                                        e_launches))
    # 3. the plain versions (eager)
    plain = _predictor(sym, params, True, dev)
    with programs.eager():
        p_results, p_wall, _ = _serve(torch, plain, prompts, **spec)
    agree = float(np.mean([np.mean(results[r] == p_results[r])
                           for r in results]))
    if not agree >= MIN_GREEDY_AGREEMENT:
        raise AssertionError("speculative greedy tokens of the kernel and "
                             "plain runs agree at %.4f < %.4f"
                             % (agree, MIN_GREEDY_AGREEMENT))

    # 5. teacher-forced verify: the kernel run's tokens as the drafts
    batch = np.zeros((SLOTS, max(PROMPT_LENS[:SLOTS])), np.float32)
    for i in range(SLOTS):
        batch[i, :PROMPT_LENS[i]] = prompts[i]
    lens = np.asarray(PROMPT_LENS[:SLOTS])
    ks, _ = pred.prefill(batch, lens)
    with programs.eager():
        ps, _ = plain.prefill(batch, lens)
    done = np.ones(SLOTS, np.int64)     # tokens committed past the prompt
    worst, tf_counts = 0.0, []
    replays_tf = programs.GRAPH_STATS["replays"]
    for _ in range(3):
        drafts = np.stack([results[i][done[i]:done[i] + SPEC_K]
                           for i in range(SLOTS)]).astype(np.int32)
        lens_k, lens_p = pred._paged_lens.copy(), plain._paged_lens.copy()
        ks, _, kc = pred.verify_step(ks, drafts)
        kp = pred.verify_probs.double()
        kc = kc.cpu().numpy()
        with programs.eager():
            ps, _, pc = plain.verify_step(ps, drafts)
        pc = pc.cpu().numpy()
        if not (bool(torch.isfinite(kp).all())
                and tuple(kp.shape) == (SLOTS, SPEC_K + 1, VOCAB)):
            raise AssertionError("bad verify probabilities")
        worst = max(worst, float((torch.log(kp) - torch.log(
            plain.verify_probs.double())).abs().max()))
        if not np.array_equal(kc, pc) or not np.array_equal(lens_k, lens_p):
            raise AssertionError("teacher-forced verify counts %s != the "
                                 "plain run's %s" % (kc, pc))
        tf_counts.append(kc.tolist())
        done += kc
    if programs.GRAPH_STATS["replays"] - replays_tf < 3:
        raise AssertionError("the teacher-forced verify steps did not "
                             "replay the captured program")
    if not worst <= TOL_LOGP:
        raise AssertionError("teacher-forced verify |log p_kernel - log "
                             "p_plain| %.3g > %.3g" % (worst, TOL_LOGP))
    # kernel B's variant at the verify window (an eager verify: a replay
    # runs no Python)
    dk.LAST_VARIANT["paged_decode"] = None
    with programs.eager():
        pred.verify_step(ks, np.zeros((SLOTS, SPEC_K), np.int32))
    verify_variant = dk.LAST_VARIANT["paged_decode"]
    if verify_variant != "decode":
        raise AssertionError("kernel B ran %r at the verify window"
                             % verify_variant)
    # the device time of one verify step and one decode step (replays,
    # from the teacher-forced state) by kernel
    zeros = np.zeros((SLOTS, SPEC_K), np.int32)
    step_ms = {
        "verify": _device_parts(torch, lambda: pred.verify_step(ks, zeros),
                                STEP_PARTS),
        "decode": _device_parts(torch, lambda: pred.step(ks), STEP_PARTS)}
    if all(isinstance(v["all"], float) for v in step_ms.values()):
        step_ms["verify_over_decode"] = step_ms["verify"]["all"] \
            / step_ms["decode"]["all"]
    log("serve spec step device ms: " + json.dumps(step_ms))

    # 6. self-draft: a dense int8 predictor of the same weights drafts
    draft = DecodePredictor(sym, params, cache_len=SEQ, device=dev,
                            kv_dtype="int8")
    rejected = _first_rejection(torch, pred)
    d_results, d_wall, d_stats = _serve(torch, pred, prompts,
                                        spec_k=SPEC_K, draft=draft)
    del pred.paged_verify
    d_reading = _spec_reading(d_stats)
    log("serve spec self-draft: %s first rejection: %s wall %.5f s"
        % (json.dumps(d_reading), json.dumps(rejected or None), d_wall))
    if any(not np.array_equal(d_results[r], base_results[r])
           for r in base_results):
        raise AssertionError("self-draft tokens differ from the serve's")
    if d_stats["accept_rate"] != 1.0 or d_stats["spec_steps"] <= 0:
        raise AssertionError("self-draft accept rate %r (first rejection "
                             "%s)" % (d_stats["accept_rate"], rejected))

    # 7. sampled speculation: the same seed twice, tokens in the top 8
    hot = _predictor(sym, params, False, dev,
                     temperature=SAMPLE_TEMPERATURE, top_k=SAMPLE_TOP_K)
    hot.prepare_programs(SLOTS, CHUNK, spec_k=SPEC_K)
    s_runs = [_serve(torch, hot, prompts, seed=SAMPLE_SEED, **spec)
              for _ in range(2)]
    if any(not np.array_equal(s_runs[0][0][r], s_runs[1][0][r])
           for r in s_runs[0][0]):
        raise AssertionError("two sampled speculative serves from one "
                             "seed differ")
    with programs.eager():
        ps, probs = plain.prefill(batch, lens)
        outside = 0
        for step in range(MAX_NEW):
            tok = np.array([s_runs[0][0][i][step] for i in range(SLOTS)])
            top = torch.topk(probs, SAMPLE_TOP_K, dim=-1).indices
            outside += int((~(top == torch.from_numpy(tok).to(dev)[:, None])
                            .any(dim=-1)).sum())
            if step + 1 < MAX_NEW:
                forced = torch.from_numpy(tok[:, None].astype(np.int32))
                ps, probs = plain.step(ps._replace(tok=forced.to(dev)))
    s_reading = dict(_spec_reading(s_runs[0][2]), wall_s=s_runs[0][1],
                     tokens_outside_top_k=outside)
    log("serve spec sampled: " + json.dumps(s_reading))
    if outside:
        raise AssertionError("%d sampled speculative tokens outside the "
                             "top %d" % (outside, SAMPLE_TOP_K))

    tokens = sum(len(t) for t in results.values())
    profile = _profile(torch, lambda: _serve(torch, pred, prompts,
                                             **spec)[1],
                       groups=SERVE_KERNEL_GROUPS)
    with programs.eager():
        e_profile = _profile(torch, lambda: _serve(torch, pred, prompts,
                                                   **spec)[1],
                             groups=SERVE_KERNEL_GROUPS)
    traces = pred.trace_counts
    log("serve spec trace_counts: " + json.dumps(traces))
    if (traces["verify"], traces["chunk"], traces["commit"]) != (1, 1, 1) \
            or traces["decode"] > 1 or traces["fork"] > 1:
        raise AssertionError("the speculative serve captured its programs "
                             "again: %s" % traces)
    out = {"requests": len(prompts), "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "ttft_p50_s": stats.get("ttft_p50_s"),
           "ttft_p95_s": stats.get("ttft_p95_s"),
           "replays": replays,
           "captured": _serve_reading(stats, wall, tokens, profile),
           "eager": _serve_reading(e_stats, e_wall, tokens, e_profile),
           "plain_wall_s": p_wall, "plain_tokens_per_s": tokens / p_wall,
           "greedy_token_agreement": agree,
           "teacher_forced_verify_max_abs_dlogp": worst,
           "teacher_forced_verify_counts": tf_counts,
           "verify_variant": verify_variant, "step_device_ms": step_ms,
           "self_draft": dict(d_reading, wall_s=d_wall),
           "sampled": s_reading, "launches": launches}
    out.update(reading)
    log("serve spec: " + json.dumps(out))
    log("serve spec profile: " + json.dumps(profile))
    log("serve spec eager profile: " + json.dumps(e_profile))
    return out, launches


def _check_close(what, got, want, tol):
    """max |got - want|, failing beyond ``tol`` x max(1, max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    lim = tol * max(1.0, float(want.float().abs().max()))
    if not err <= lim:
        raise AssertionError("%s: max |kernel - plain| %.3g > %.3g"
                             % (what, err, lim))
    return err


def _bound(nbytes, flops, dname):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _case(torch, flush, kernel, plain, library, extra, iters=10):
    """Event and device times of a kernel, its plain version and the
    library yardstick, merged into ``extra``."""
    case = dict(extra)
    case.update(
        ms=_timed(torch, kernel, flush, iters),
        plain_ms=_timed(torch, plain, flush, iters),
        library_ms=_timed(torch, library, flush, iters),
        device_ms={"kernel": _device_ms(torch, kernel),
                   "plain": _device_ms(torch, plain),
                   "library": _device_ms(torch, library)})
    return case


def phase_kernels_cde(torch, dev, flush):
    """Kernels C, D and E at the training path's attention shape: (B*H,
    T, hd) = (64, 2048, 128), causal; f32 and bf16 with G = 1 and with
    G = 2 (32 kv rows).  D and E run on the kernel's own o / lse.
    Yardsticks: SDPA's forward (C) and its backward through autograd,
    which computes dq, dk and dv in one call (D and E).  Every case names
    the variant that ran (``flash_kernel.LAST_VARIANT``)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import flash_kernel as fl

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    b, h, t, hd = TRAIN_BATCH, TRAIN_HEADS, SEQ, EMBED // TRAIN_HEADS
    bh = b * h
    scale = hd ** -0.5
    pairs = t * (t + 1) // 2   # causal (query, key) pairs per row
    cases = {"C": [], "D": [], "E": []}
    for dtype, groups in ((torch.float32, 1), (torch.bfloat16, 1),
                          (torch.float32, 2), (torch.bfloat16, 2)):
        dname = str(dtype).split(".")[-1]
        isz = torch.empty((), dtype=dtype).element_size()
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16

        def r(rows):
            return torch.randn(rows, t, hd, generator=g,
                               device=dev).to(dtype)

        bkv = bh // groups
        q, do, k, v = r(bh), r(bh), r(bkv), r(bkv)
        args = (scale, True, groups)
        what = "%s G=%d" % (dname, groups)
        o, lse = fl.flash_fwd(q, k, v, *args)
        wo, wlse = fl.flash_plain_fwd(q, k, v, *args)
        delta = fl.flash_delta(o, do)
        dq = fl.flash_bwd_dq(q, k, v, do, lse, delta, *args)
        dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
        variants = {"C": fl.LAST_VARIANT["flash_fwd"],
                    "D": fl.LAST_VARIANT["flash_bwd_dq"],
                    "E": fl.LAST_VARIANT["flash_bwd_dkv"]}
        wdq, wdk, wdv = fl.flash_plain_bwd(q, k, v, o, lse, do, *args)
        torch.cuda.synchronize()
        errs = {"C": max(_check_close("kernel C %s o" % what, o, wo, tol),
                         _check_close("kernel C %s lse" % what, lse, wlse,
                                      TOL_F32)),
                "D": _check_close("kernel D %s dq" % what, dq, wdq, tol),
                "E": max(_check_close("kernel E %s dk" % what, dk, wdk, tol),
                         _check_close("kernel E %s dv" % what, dv, wdv,
                                      tol))}
        del wo, wlse, wdq, wdk, wdv
        # yardsticks on the (B, H, T, hd) views of the same tensors
        q4 = q.view(b, h, t, hd)
        k4, v4 = k.view(b, h // groups, t, hd), v.view(b, h // groups, t, hd)
        sdpa_kw = dict(is_causal=True, scale=scale, enable_gqa=groups > 1)
        leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]
        lo = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
        do4 = do.view(b, h, t, hd)
        fns = {
            "C": (lambda: fl.flash_fwd(q, k, v, *args),
                  lambda: fl.flash_plain_fwd(q, k, v, *args),
                  lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                         **sdpa_kw)),
            "D": (lambda: fl.flash_bwd_dq(q, k, v, do, lse, delta, *args),
                  lambda: fl.flash_plain_bwd(q, k, v, o, lse, do, *args),
                  lambda: torch.autograd.grad(lo, leaves, do4,
                                              retain_graph=True)),
            "E": (lambda: fl.flash_bwd_dkv(q, k, v, do, lse, delta, *args),
                  lambda: fl.flash_plain_bwd(q, k, v, o, lse, do, *args),
                  lambda: torch.autograd.grad(lo, leaves, do4,
                                              retain_graph=True))}
        qb, kvb, rowb = bh * t * hd * isz, bkv * t * hd * isz, bh * t * 4
        nbytes = {"C": 2 * qb + 2 * kvb + rowb,
                  "D": 3 * qb + 2 * kvb + 2 * rowb,
                  "E": 2 * qb + 4 * kvb + 2 * rowb}
        flops = {"C": 4.0 * pairs * hd * bh, "D": 6.0 * pairs * hd * bh,
                 "E": 8.0 * pairs * hd * bh}
        for name in "CDE":
            bound_ms, bound_by = _bound(nbytes[name], flops[name], dname)
            extra = {
                "kernel": name, "dtype": dname, "bh": bh, "t": t, "hd": hd,
                "groups": groups, "causal": True, "max_abs_err": errs[name],
                "tol": tol, "bound_ms": bound_ms, "bound_by": bound_by}
            extra["variant"] = variants[name]
            case = _case(torch, flush, *fns[name], extra=extra)
            case["bound_share"] = _bound_share(case)
            log("kernel %s case: %s" % (name, json.dumps(case)))
            cases[name].append(case)
        del lo, leaves
    return cases


def phase_kernel_f(torch, dev, flush):
    """Kernel F at the training path's M = B*T = 16384 rows for the
    q/k/v (1024 -> 1024), ffn1 (1024 -> 4096) and ffn2 (4096 -> 1024,
    ReLU; its residual's gradient is dy itself) segments, f32 and bf16.
    Yardstick: the two torch.matmul products plus the two column sums."""
    from mxnet_tpu_torch.ops import fused_kernel as fk

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    m = TRAIN_BATCH * SEQ
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        isz = torch.empty((), dtype=dtype).element_size()
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        for k, n, relu in ((EMBED, EMBED, False), (EMBED, FFN, False),
                           (FFN, EMBED, True)):
            def r(*shape):
                return torch.randn(*shape, generator=g, device=dev)

            x, dy = r(m, k).to(dtype), r(m, n).to(dtype)
            w = (r(n, k) / k ** 0.5).to(dtype)
            scale, shift = 1 + 0.1 * r(k), 0.1 * r(k)
            got = fk.fused_bwd(x, dy, scale, shift, w, relu)
            variant = fk.LAST_VARIANT["fused_bwd"]
            want = fk.fused_bwd_plain(x, dy, scale, shift, w, relu)
            torch.cuda.synchronize()
            what = "kernel F %s m=%d k=%d n=%d" % (dname, m, k, n)
            err = max(_check_close(what + " " + nm, gv, wv, tl)
                      for nm, gv, wv, tl in zip(
                          ("dx", "dw", "dscale", "dshift"), got, want,
                          (tol, TOL_F32_LONG, TOL_F32_LONG, TOL_F32_LONG)))
            del got, want
            x32 = x.float()
            a = x32 * scale + shift
            a = (torch.clamp_min(a, 0) if relu else a).to(dtype)

            def library():
                dz = torch.matmul(dy, w)
                dw = torch.matmul(dy.t(), a)
                return dw, (dz * x32).sum(0), dz.sum(0)

            nbytes = (m * k * isz + m * n * isz + n * k * isz + 2 * k * 4
                      + m * k * isz + n * k * 4 + 2 * k * 4)
            bound_ms, bound_by = _bound(nbytes, 4.0 * m * n * k, dname)
            case = _case(
                torch, flush,
                lambda: fk.fused_bwd(x, dy, scale, shift, w, relu),
                lambda: fk.fused_bwd_plain(x, dy, scale, shift, w, relu),
                library, extra={
                    "kernel": "F", "dtype": dname, "m": m, "k": k, "n": n,
                    "relu": relu, "variant": variant, "max_abs_err": err,
                    "tol": tol, "bound_ms": bound_ms, "bound_by": bound_by})
            case["bound_share"] = _bound_share(case)
            log("kernel F case: " + json.dumps(case))
            cases.append(case)
    return cases


def _ulp_map(torch, a, b):
    """Elementwise distance in f32 ulps between two tensors, read as
    f32."""
    def ordered(t):
        i = t.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (ordered(a) - ordered(b)).abs()


def _ulps(torch, a, b):
    """Largest distance in f32 ulps between two tensors, read as f32."""
    return int(_ulp_map(torch, a, b).max())


def _trainable_shapes(sym, **shapes):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    return {n: s for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _b1_capture(torch, uk):
    """A stand-in for ``uk.multi_tensor_update`` that copies each launch's
    slabs just before it, runs the plain version on the copies after it,
    and records whether the two agree bit for bit."""
    real = uk.multi_tensor_update
    report = {"launches": 0, "bitwise": True, "path": None}

    def checked(kind, nslots, w, g, slots, wc, lrb, wdb, hyp, plain=False):
        ref = [w.clone()] + [s.clone() for s in slots] \
            + ([wc.clone()] if wc is not None else [])
        path = real(kind, nslots, w, g, slots, wc, lrb, wdb, hyp,
                    plain=plain)
        uk.update_plain(kind, nslots, ref[0], g, ref[1:1 + nslots],
                        ref[-1] if wc is not None else None, lrb, wdb, hyp)
        got = [w, *slots] + ([wc] if wc is not None else [])
        report["launches"] += 1
        report["path"] = path
        report["bitwise"] &= all(torch.equal(a, b) for a, b in zip(got, ref))
        return path

    return real, checked, report


def _b1_case(torch, dev, flush, net, shapes, kind, nslots, master, cdtype,
             clip, g):
    """Kernel B1 over the slab of ``shapes`` (trainable name -> shape):
    held against the plain version on copies, then timed beside the plain
    version, ``torch.optim``'s fused step over the same tensors (the
    yardstick; its momentum form is ``buf = m * buf + g; w -= lr * buf``,
    not MXNet's) and the port's per-parameter update over them."""
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ops import update_kernel as uk

    metas = {n: torch.empty(s, dtype=master, device="meta")
             for n, s in shapes.items()}
    plan = uk.UpdatePlan(kind, nslots, uk._segments_for(metas), cdtype)
    (bk,) = plan.buckets
    segs = plan.buckets[bk]
    rows = plan.rows(bk)
    live = torch.zeros(rows * uk.LANES, dtype=torch.bool, device=dev)
    for s in segs:
        live[s.row0 * uk.LANES:s.row0 * uk.LANES + s.size] = True
    live = live.view(rows, uk.LANES)

    def slab(scale, dtype, positive=False):
        t = torch.randn((rows, uk.LANES), generator=g, device=dev) * scale
        return torch.where(live, t.abs() if positive else t, 0.0).to(dtype)

    w = slab(1.0, master)
    grad = slab(1.0, torch.float32)
    slots = tuple(slab(0.01, master, positive=i == 1) for i in range(nslots))
    wc = w.to(cdtype) if cdtype is not None else None
    lrb, wdb = plan.lr_wd_blocks(
        {s.name: 0.1 * (1 + i % 5) / 5 for i, s in enumerate(segs)},
        {s.name: 1e-4 * (i % 3) for i, s in enumerate(segs)})
    lrb = torch.from_numpy(lrb[bk]).to(dev)
    wdb = torch.from_numpy(wdb[bk]).to(dev)
    hyp = [0.5, clip, 0.9] if kind == "sgd" else [0.5, clip, 0.9, 0.999,
                                                    1e-8]
    ref = [w.clone()] + [s.clone() for s in slots] \
        + ([wc.clone()] if wc is not None else [])
    uk.multi_tensor_update(kind, nslots, w, grad, slots, wc, lrb, wdb, hyp)
    uk.update_plain(kind, nslots, ref[0], grad, ref[1:1 + nslots],
                    ref[-1] if wc is not None else None, lrb, wdb, hyp)
    torch.cuda.synchronize()
    got = [w, *slots] + ([wc] if wc is not None else [])
    name = {("sgd", 0): "sgd", ("sgd", 1): "sgd_momentum",
            ("adam", 2): "adam"}[(kind, nslots)]
    mname = str(master).split(".")[-1]
    cname = str(cdtype).split(".")[-1] if cdtype is not None else None
    what = "kernel B1 %s %s master=%s wc=%s clip=%g" % (net, name, mname,
                                                        cname, clip)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
    ulps = max(_ulps(torch, a, b) for a, b in zip(got, ref))
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, ref))
    if kind == "sgd" and not bitwise:
        raise AssertionError("%s: not bit for bit equal to the plain "
                             "version (%d ulps, max abs %.3g)"
                             % (what, ulps, err))
    if ulps > B1_ADAM_ULPS:
        raise AssertionError("%s: %d ulps from the plain version > %d"
                             % (what, ulps, B1_ADAM_ULPS))
    if any(bool(t[~live].any()) for t in got):
        raise AssertionError("%s: a padding lane is not 0" % what)
    del ref

    # the same tensors one by one: torch.optim's fused step, the port's
    # per-parameter update, and the grad pack of the train step (one copy
    # per gradient, in the compute dtype, into the f32 grad slab's views)
    params = []
    for s in shapes.values():
        p = torch.randn(s, generator=g, device=dev).to(master)
        p.requires_grad_(True)
        p.grad = torch.randn(s, generator=g, device=dev).to(master)
        params.append(p)
    if kind == "sgd":
        lib = torch.optim.SGD(params, lr=0.1, momentum=0.9 if nslots else 0.0,
                              weight_decay=1e-4, fused=True)
        mine = topt.SGD(learning_rate=0.1, momentum=0.9 if nslots else 0.0,
                        wd=1e-4, rescale_grad=0.5,
                        clip_gradient=clip if clip > 0 else None)
    else:
        lib = torch.optim.Adam(params, lr=1e-3, weight_decay=1e-4,
                               fused=True)
        mine = topt.Adam(learning_rate=1e-3, wd=1e-4, rescale_grad=0.5,
                         clip_gradient=clip if clip > 0 else None)
    lib.step()   # creates its state
    weights = [nd.NDArray(p.detach()) for p in params]
    grads = [nd.NDArray(p.grad) for p in params]
    states = [mine.create_state(i, wt) for i, wt in enumerate(weights)]
    indices = list(range(len(weights)))

    def per_param():
        mine.update_multi(indices, weights, grads, states)

    views = list(plan.unpack(bk, grad).values())
    cgrads = [p.grad.to(cdtype or master) for p in params]

    def pack():
        for v, c in zip(views, cgrads):
            v.copy_(c)

    # the bound counts the tensors' own values, not the slab's padding
    n = rows * uk.LANES
    values = sum(int(np.prod(s)) for s in shapes.values())
    isz = w.element_size()
    nbytes = values * (2 * isz + 4 + 2 * nslots * isz
                       + (wc.element_size() if wc is not None else 0)) \
        + 2 * 4 * lrb.numel()
    flops = values * {"sgd": 5, "sgd_momentum": 7, "adam": 17}[name]
    bound_ms, bound_by = _bound(nbytes, flops, "float32")
    case = _case(
        torch, flush,
        lambda: uk.multi_tensor_update(kind, nslots, w, grad, slots, wc,
                                       lrb, wdb, hyp),
        lambda: uk.update_plain(kind, nslots, w, grad, slots, wc, lrb, wdb,
                                hyp),
        lib.step, extra={
            "kernel": "B1", "net": net, "kind": name, "master": mname,
            "wc": cname, "clip": clip, "tensors": len(shapes),
            "blocks": lrb.numel(), "elements": n, "values": values,
            "bitwise": bitwise,
            "max_ulps": ulps, "max_abs_err": err,
            "library": "torch.optim.%s(fused=True).step"
            % ("SGD" if kind == "sgd" else "Adam"),
            "bound_ms": bound_ms, "bound_by": bound_by})
    case["per_param_ms"] = _timed(torch, per_param, flush, 10)
    case["grad_pack_ms"] = _timed(torch, pack, flush, 10)
    case["device_ms"]["per_param"] = _device_ms(torch, per_param)
    case["device_ms"]["grad_pack"] = _device_ms(torch, pack)
    return case


def phase_kernel_b1(torch, dev, flush):
    """Kernel B1 over ResNet-50's slab (157 tensors, 12,556 blocks) and
    the training LM's: SGD, SGD-momentum and Adam; f32 masters without and
    with a bf16 compute copy (clip off and on), bf16 masters (clip on);
    over the bucketed LSTM LM's slab (11 tensors, 4,653,200 values) the
    update its path runs, Adam over f32 masters; and over the zoo's
    training slabs the update theirs run, SGD-momentum: Inception-v3's
    (284 tensors, most of them BatchNorm vectors of 32-2048 values) over
    f32 masters with the bf16 compute copy, AlexNet's (16 tensors,
    50,844,008 values) over f32 masters; and over the SSD example's slab
    (8 tensors, 14,336 values) its Adam update.  Every segment is
    padded to whole 2,048-element blocks, and lr / wd differ from segment
    to segment."""
    from mxnet_tpu_torch.models import alexnet, attention_lm, inception_v3
    from mxnet_tpu_torch.models import resnet, ssd

    nets = {
        "resnet50": _trainable_shapes(
            resnet.get_symbol(1000, 50, (3, 224, 224)),
            data=(RESNET_BATCH, 3, 224, 224),
            softmax_label=(RESNET_BATCH,)),
        "lm": _trainable_shapes(
            attention_lm.get_symbol(vocab_size=VOCAB, seq_len=SEQ,
                                    num_layers=TRAIN_LAYERS, embed=EMBED,
                                    heads=TRAIN_HEADS, ffn_hidden=FFN),
            data=(TRAIN_BATCH, SEQ), softmax_label=(TRAIN_BATCH, SEQ)),
        "lstm": _trainable_shapes(
            _bench_lstm_sym_gen()(LSTM_BUCKETS[-1])[0],
            data=(LSTM_BATCH, LSTM_BUCKETS[-1]),
            softmax_label=(LSTM_BATCH, LSTM_BUCKETS[-1])),
        "inception_v3": _trainable_shapes(
            inception_v3.get_symbol(num_classes=1000),
            data=(ZOO_TRAIN["inception_v3"]["batch"], 3, 299, 299),
            softmax_label=(ZOO_TRAIN["inception_v3"]["batch"],)),
        "alexnet": _trainable_shapes(
            alexnet.get_symbol(num_classes=1000),
            data=(ZOO_TRAIN["alexnet"]["batch"], 3, 224, 224),
            softmax_label=(ZOO_TRAIN["alexnet"]["batch"],)),
        "ssd": _trainable_shapes(ssd.get_symbol(),
                                 data=(SSD_BATCH, 3, 32, 32),
                                 label=(SSD_BATCH, 1, 5))}
    for net, want in (("resnet50", (157, 25_549_486)),
                      ("ssd", (8, 14_336)),
                      ("lstm", (11, LSTM_PARAMS)),
                      ("inception_v3", ZOO_TRAIN["inception_v3"]["params"]),
                      ("alexnet", ZOO_TRAIN["alexnet"]["params"])):
        got = (len(nets[net]), sum(int(np.prod(s))
                                   for s in nets[net].values()))
        if got != want:
            raise AssertionError("%s trainables: %d tensors, %d values"
                                 % ((net,) + got))
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    variants = ((torch.float32, None, -1.0),
                (torch.float32, torch.bfloat16, -1.0),
                (torch.float32, torch.bfloat16, 0.3),
                (torch.bfloat16, None, 0.3))
    # every update over the ResNet-50 and LM slabs; over the LSTM LM's,
    # the one its bucketed path runs (Adam, f32 masters, no clip)
    by_net = {"resnet50": [(k, n, v) for k, n in (("sgd", 0), ("sgd", 1),
                                                   ("adam", 2))
                           for v in variants]}
    by_net["lm"] = by_net["resnet50"]
    by_net["lstm"] = [("adam", 2, variants[0])]
    # the zoo's training paths: SGD-momentum, Inception-v3's f32 masters
    # with the bf16 compute copy, AlexNet's f32
    by_net["inception_v3"] = [("sgd", 1, variants[1])]
    by_net["alexnet"] = [("sgd", 1, variants[0])]
    by_net["ssd"] = [("adam", 2, variants[0])]
    cases = []
    for net, shapes in nets.items():
        for kind, nslots, (master, cdtype, clip) in by_net[net]:
            case = _b1_case(torch, dev, flush, net, shapes, kind, nslots,
                            master, cdtype, clip, g)
            log("kernel B1 case: " + json.dumps(case))
            cases.append(case)
            torch.cuda.empty_cache()
    return cases


def _train_params(sym):
    """Seeded numpy parameters: Xavier-gaussian weights (magnitude 3,
    factor avg, the initializer's formula), LayerNorm gamma 1, beta and
    biases 0."""
    rng = np.random.RandomState(0)
    shapes, _, _ = sym.infer_shape(data=(TRAIN_BATCH, SEQ),
                                   softmax_label=(TRAIN_BATCH, SEQ))
    out = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            rf = int(np.prod(shape[2:])) if len(shape) > 2 else 1
            fan_in, fan_out = shape[1] * rf, shape[0] * rf
            bound = np.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
            out[name] = rng.normal(0.0, bound, shape).astype(np.float32)
        elif name.endswith("_gamma"):
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def _snapshot(mod):
    """Device copies of a module's parameters and aux states."""
    exe = mod._exec_group.exec_
    out = {n: a.data.clone() for n, a in exe.arg_dict.items()
           if n in mod._exec_group.param_names}
    out.update({"aux:" + n: a.data.clone() for n, a in exe.aux_dict.items()})
    return out


def _run_diff(torch, got, want, start, direct):
    """``got`` against ``want`` (snapshots after the same steps from
    ``start``): per tensor ||got - want|| / ||want - start|| (a *_k_bias
    on its layer's *_q_bias change), the worst in each tier (``direct``:
    the name prefixes the backward reaches before any ReLU), and the
    tensors that are not bit for bit equal."""
    errs, unequal = {}, []
    for name, w in want.items():
        if not torch.equal(got[name], w):
            unequal.append(name)
        ref = name[:-len("_k_bias")] + "_q_bias" \
            if name.endswith("_k_bias") else name
        denom = float(torch.linalg.vector_norm(
            (want[ref] - start[ref]).double()))
        errs[name] = float(torch.linalg.vector_norm(
            (got[name] - w).double())) / max(denom, 1e-30)
    tiers = {}
    for tier, keep in (("before_relu", True), ("behind_relu", False)):
        sub = {n: e for n, e in errs.items()
               if n.startswith(direct) == keep}
        worst = max(sub, key=sub.get) if sub else None
        tiers[tier] = {"max": sub[worst] if worst else 0.0,
                       "tensor": worst}
    return {"bitwise": not unequal, "unequal": len(unequal),
            "tensors": len(want), "first_unequal": unequal[:6],
            "tiers": tiers}


def _graph_delta(before):
    from mxnet_tpu_torch import programs

    return {k: programs.GRAPH_STATS[k] - before[k]
            for k in ("captures", "replays", "capture_s")}


# the LM parameters the backward reaches before any ReLU mask
_DIRECT = ("head_", "final_", "layer%d_ffn2_" % (TRAIN_LAYERS - 1))


def _grad_tiers(torch, got, want, what, direct=_DIRECT):
    """Per parameter ||got - want|| / ||want|| (a *_k_bias on its layer's
    *_q_bias), the worst in each tier against its tolerance
    (TOL_TRAIN_GRAD before any ReLU mask: the names ``direct`` begins,
    TOL_TRAIN_GRAD_RELU behind one); raises past it."""
    errs = {}
    for name, gp in want.items():
        ref = name[:-len("_k_bias")] + "_q_bias" \
            if name.endswith("_k_bias") else name
        denom = float(torch.linalg.vector_norm(want[ref].double()))
        errs[name] = float(torch.linalg.vector_norm(
            (got[name] - gp).double())) / max(denom, 1e-30)
    tiers = {"before_relu": ({n: e for n, e in errs.items()
                              if n.startswith(direct)}, TOL_TRAIN_GRAD),
             "behind_relu": ({n: e for n, e in errs.items()
                              if not n.startswith(direct)},
                             TOL_TRAIN_GRAD_RELU)}
    check = {}
    for tier, (tier_errs, tol) in tiers.items():
        worst = max(tier_errs, key=tier_errs.get)
        check[tier] = {"max": tier_errs[worst], "param": worst, "tol": tol}
        if not tier_errs[worst] <= tol:
            raise AssertionError(
                "%s gradients, kernel vs plain: %s off by %.3g > %.3g"
                % (what, worst, tier_errs[worst], tol))
    return check


def phase_train(torch, dev):
    """The full-width training step through Module on the card: the
    compiled step (one CUDA graph), held against its body under
    programs.eager()."""
    from mxnet_tpu_torch import gpu, programs
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ops import attention as attn
    from mxnet_tpu_torch.ops import flash_kernel as fl
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.ops import fused_lm
    from mxnet_tpu_torch.ops import update_kernel as uk

    b, t = TRAIN_BATCH, SEQ
    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=t,
                                  num_layers=TRAIN_LAYERS, embed=EMBED,
                                  heads=TRAIN_HEADS, ffn_hidden=FFN)
    params = _train_params(sym)
    n_params = sum(v.size for v in params.values())
    log("train model: attention_lm vocab=%d T=%d batch=%d embed=%d heads=%d "
        "ffn=%d layers=%d params=%d (f32), SGD lr=%g" % (
            VOCAB, t, b, EMBED, TRAIN_HEADS, FFN, TRAIN_LAYERS, n_params,
            TRAIN_LR))
    rng = np.random.RandomState(1)
    x = rng.randint(0, VOCAB, size=(b, t)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((b, 1), np.float32)], axis=1)
    batch = DataBatch([nd.array(x)], [nd.array(y)])
    labels = torch.from_numpy(y.reshape(-1)).long().to(dev)[:, None]

    def module(plain, lr=TRAIN_LR):
        mod = Module(sym, context=gpu(0), plain=plain)
        mod.bind(data_shapes=[DataDesc("data", (b, t), layout="NT")],
                 label_shapes=[DataDesc("softmax_label", (b, t),
                                        layout="NT")])
        mod.init_params(arg_params=params, aux_params={})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": lr})
        if mod._train_step.plan is None:
            raise AssertionError("the LM's train step armed no slab plan")
        return mod

    def grads(mod):
        group = mod._exec_group
        return {n: a.data.clone() for n, a in zip(group.param_names,
                                                   group.grad_arrays)}

    def loss(mod):
        # mean -log p(label) of the step's forward (before its update)
        p = mod.get_outputs()[0].data.gather(1, labels)
        return float(-torch.log(torch.clamp_min(p, 1e-30)).mean())

    start = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}
    kmod = module(False)
    torch.cuda.reset_peak_memory_stats()
    # warm-up: the first step, run unrecorded, whose gradients the plain
    # module must match and whose update the plain version must match bit
    # for bit
    real, checked, b1_first = _b1_capture(torch, uk)
    uk.multi_tensor_update = checked
    try:
        t0 = time.perf_counter()
        with programs.eager():
            kmod.forward_backward(batch)
            kmod.update()
        losses = [loss(kmod)]
        warm_s = time.perf_counter() - t0
    finally:
        uk.multi_tensor_update = real
    if b1_first != {"launches": 1, "bitwise": True, "path": "kernel"}:
        raise AssertionError("the LM's first update, kernel B1 vs plain on "
                             "the same slabs: %s" % b1_first)
    first = grads(kmod)
    # the second step sets up the step program: a warm-up run (the step's
    # real work) and the capture
    graphs0 = dict(programs.GRAPH_STATS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kmod.forward_backward(batch)
    kmod.update()
    losses.append(loss(kmod))
    setup_s = time.perf_counter() - t0

    counters = ((fk.LAUNCHES, "fused_fwd"), (fk.LAUNCHES, "fused_bwd"),
                (fl.LAUNCHES, "flash_fwd"), (fl.LAUNCHES, "flash_bwd_dq"),
                (fl.LAUNCHES, "flash_bwd_dkv"),
                (uk.LAUNCHES, "multi_tensor_update"))
    for d, name in counters:
        d[name] = 0
    fused_lm.FUSED_PATH["last"] = attn.PATH_TAKEN["last"] = None
    uk.UPDATE_PATH["last"] = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        kmod.forward_backward(batch)
        kmod.update()
        losses.append(loss(kmod))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs = _graph_delta(graphs0)
    peak_captured_gb = torch.cuda.max_memory_allocated() / 1e9
    captured = _snapshot(kmod)
    launches = {name: d[name] for d, name in counters}
    paths = {"fused": fused_lm.FUSED_PATH["last"],
             "attention": attn.PATH_TAKEN["last"],
             "update": uk.UPDATE_PATH["last"]}
    if graphs["captures"] != 1 \
            or graphs["replays"] != TRAIN_STEPS:
        raise AssertionError("the LM's train step: %s (want one capture, "
                             "then a replay a step)" % graphs)
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    segments = 5 * TRAIN_LAYERS
    want = {"fused_fwd": segments, "fused_bwd": segments,
            "flash_fwd": TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
            "flash_bwd_dkv": TRAIN_LAYERS, "multi_tensor_update": 1}
    log("train launches: %s per step %s paths: %s"
        % (launches, per_step, paths))
    if per_step != want or paths != {"fused": "kernel",
                                     "attention": "flash",
                                     "update": "kernel"}:
        raise AssertionError("the train step did not run every kernel the "
                             "expected number of times: %s (want %s per "
                             "step) %s" % (per_step, want, paths))

    # the same first step from the same params through the plain versions
    pmod = module(True)
    with programs.eager():
        pmod.forward_backward(batch)
    plain = grads(pmod)
    del pmod
    grad_check = _grad_tiers(torch, first, plain, "train")
    del first, plain
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("the loss did not fall on the repeated batch: "
                             "%s" % losses)
    # the bench's rate from the same params, recorded (not asserted)
    bmod = module(False, lr=BENCH_LR)
    bench_losses = []
    for _ in range(1 + TRAIN_STEPS):
        bmod.forward_backward(batch)
        bmod.update()
        bench_losses.append(loss(bmod))
    del bmod
    gc.collect()
    torch.cuda.empty_cache()

    # one replay against one eager step from the same masters (SGD
    # without momentum: the masters are the whole state): every gradient
    # and master bit for bit but the LayerNorm scale / shift gradients
    # kernel F sums with atomics (and the masters they update), which are
    # held to TOL_F32_LONG of their largest magnitude
    tstep = kmod._train_step
    saved = {bk: w.clone() for bk, w in tstep._w.items()}

    def from_saved(eager):
        with torch.no_grad():
            for bk, w in tstep._w.items():
                w.copy_(saved[bk])
        with programs.eager() if eager else contextlib.nullcontext():
            kmod.forward_backward(batch)
        torch.cuda.synchronize()
        out = {"grad:" + n: g for n, g in grads(kmod).items()}
        out.update({n: v.clone() for n, v in
                    tstep.plan.unpack_all(tstep._w).items()})
        return out

    one_c, one_e = from_saved(False), from_saved(True)
    unequal = sorted(n for n in one_e if not torch.equal(one_c[n], one_e[n]))
    atomics = [n for n in unequal if n.split(":")[-1].endswith(
        ("_ln_gamma", "_ln_beta")) and n.split(":")[-1].startswith("layer")]
    worst = max([_rel_err(one_c[n], one_e[n]) for n in atomics] or [0.0])
    one_step_gate = {"tensors": len(one_e), "unequal": unequal,
                     "kernel_f_atomics": len(atomics),
                     "max_rel_err_atomics": worst, "tol": TOL_F32_LONG}
    del one_c, one_e, saved
    log("train captured vs eager, one step: " + json.dumps(one_step_gate))
    if set(unequal) != set(atomics) or not worst <= TOL_F32_LONG:
        raise AssertionError("the LM's captured step against eager from "
                             "the same masters: %s" % one_step_gate)

    # the same 2 + TRAIN_STEPS steps under programs.eager(), twice: the
    # captured run against the first, and the eager runs' own spread
    def eager_run():
        mod = module(False)
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        with programs.eager():
            for i in range(2 + TRAIN_STEPS):
                mod.forward_backward(batch)
                mod.update()
                if i == 0:
                    g1 = grads(mod)
                if i == 1:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t1) / TRAIN_STEPS
        snap = _snapshot(mod)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del mod
        gc.collect()
        torch.cuda.empty_cache()
        return snap, g1, step_s, peak

    eager1, eg1, eager_step_s, peak_eager_gb = eager_run()
    eager2, eg2, _, _ = eager_run()
    vs_eager = _run_diff(torch, captured, eager1, start, _DIRECT)
    spread = _run_diff(torch, eager2, eager1, start, _DIRECT)
    nondeterministic = sorted(n for n in eg1 if not torch.equal(eg1[n],
                                                                eg2[n]))
    del eager1, eager2, eg1, eg2, captured
    capture_gate = {"steps": 2 + TRAIN_STEPS, "captured_vs_eager": vs_eager,
                    "eager_vs_eager": spread,
                    "first_step_grads_differing_between_eager_runs":
                        nondeterministic,
                    "max_over_spread": CAPTURE_SPREAD}
    log("train captured vs eager: " + json.dumps(capture_gate))
    if any(vs_eager["tiers"][t]["max"]
           > CAPTURE_SPREAD * max(spread["tiers"][t]["max"], 1e-7)
           for t in ("before_relu", "behind_relu")):
        raise AssertionError("the LM's captured steps against eager, "
                             "beyond the eager runs' own spread: %s"
                             % capture_gate)
    capture_gate["one_step"] = one_step_gate

    def one_step(eager=False):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with programs.eager() if eager else contextlib.nullcontext():
            kmod.forward_backward(batch)
            kmod.update()
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    profile = _profile(torch, one_step)
    profile_eager = _profile(torch, lambda: one_step(eager=True))
    train = {"config": {"vocab": VOCAB, "t": t, "batch": b,
                        "embed": EMBED, "heads": TRAIN_HEADS, "ffn": FFN,
                        "layers": TRAIN_LAYERS, "dtype": "float32",
                        "optimizer": "sgd", "lr": TRAIN_LR,
                        "params": n_params, "update": "slab plan"},
             "smoke_reading": True, "steps": TRAIN_STEPS,
             "step_s": wall / TRAIN_STEPS, "warmup_step_s": warm_s,
             "first_update_bitwise_vs_plain": b1_first["bitwise"],
             "tokens_per_s": b * t * TRAIN_STEPS / wall, "losses": losses,
             "setup_step_s": setup_s, "graph_stats": graphs,
             "eager_step_s": eager_step_s,
             "eager_tokens_per_s": b * t / eager_step_s,
             "idle_share": _idle_shares(profile, profile_eager,
                                        wall / TRAIN_STEPS, eager_step_s),
             "bench_lr": BENCH_LR, "bench_lr_losses": bench_losses,
             "launches": launches, "launches_per_step": per_step,
             "grad_rel_err": grad_check,
             "peak_memory_gb": {"captured": peak_captured_gb,
                                "eager": peak_eager_gb}}
    log("train: " + json.dumps(train))
    log("train profile: " + json.dumps(profile))
    log("train profile eager: " + json.dumps(profile_eager))
    return train, launches


def _op_cases():
    """``tests/test_torch_op_cases.py`` loaded by its path (nothing else
    of ``tests/`` becomes importable): the slice's op cases and samplers
    and their runners (jax-free)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "test_torch_op_cases.py")
    spec = importlib.util.spec_from_file_location("_smoke_op_cases", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    return cases


def _on_own_thread(fn, *args):
    """``fn(*args)`` on a thread of its own.  autograd's marked variables
    are thread-local, so the marks ``fn`` makes (and the parameters and
    gradient buffers they hold) end with its thread."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # re-raised on the main thread
            box["err"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def phase_train_imperative(torch, dev):
    """The full-width training configuration through the imperative
    front end: the LM as nd calls under autograd.record(), autograd's
    backward into marked gradient buffers, then nd.sgd_update(w, g,
    out=w) per parameter; held against a Module's eager SGD steps from
    the same parameters and batch."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.models.attention_lm import imperative_lm
    from mxnet_tpu_torch.ops import attention as attn
    from mxnet_tpu_torch.ops import flash_kernel as fl
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.ops import fused_lm

    b, t = TRAIN_BATCH, SEQ
    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=t,
                                  num_layers=TRAIN_LAYERS, embed=EMBED,
                                  heads=TRAIN_HEADS, ffn_hidden=FFN)
    params = _train_params(sym)
    names = sorted(params)
    rng = np.random.RandomState(1)
    x = rng.randint(0, VOCAB, size=(b, t)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((b, 1), np.float32)], axis=1)
    labels = torch.from_numpy(y.reshape(-1)).long().to(dev)[:, None]

    def loss_of(probs):
        p = probs.detach().gather(1, labels)
        return float(-torch.log(torch.clamp_min(p, 1e-30)).mean())

    start = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}

    def module_run():
        """IMP_GATE_STEPS eager SGD steps of a Module (kernel B1): the
        first step's gradients and loss, the parameters after the first
        and after the last step."""
        mod = mt.mod.Module(sym, context=mt.gpu(0))
        mod.bind(data_shapes=[DataDesc("data", (b, t), layout="NT")],
                 label_shapes=[DataDesc("softmax_label", (b, t),
                                        layout="NT")])
        mod.init_params(arg_params=params, aux_params={})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": TRAIN_LR})
        batch = DataBatch([mt.nd.array(x)], [mt.nd.array(y)])
        snaps = []
        with programs.eager():
            for i in range(IMP_GATE_STEPS):
                mod.forward_backward(batch)
                if i == 0:
                    group = mod._exec_group
                    grads = {n: a.data.clone() for n, a in zip(
                        group.param_names, group.grad_arrays)}
                    loss = loss_of(mod.get_outputs()[0].data)
                mod.update()
                if i in (0, IMP_GATE_STEPS - 1):
                    snaps.append(_snapshot(mod))
        del mod, batch
        gc.collect()
        torch.cuda.empty_cache()
        return grads, loss, snaps

    m_grads, m_loss, (m_one, m_last) = module_run()
    _, _, (_, m2_last) = module_run()

    # the imperative steps
    counters = ((fk.LAUNCHES, "fused_fwd"), (fk.LAUNCHES, "fused_bwd"),
                (fl.LAUNCHES, "flash_fwd"), (fl.LAUNCHES, "flash_bwd_dq"),
                (fl.LAUNCHES, "flash_bwd_dkv"))
    ctx = mt.current_context()
    if ctx != mt.gpu(0):
        raise AssertionError("the default context on the card is %s, not "
                             "gpu(0)" % ctx)
    p = {k: mt.nd.array(v) for k, v in params.items()}
    g = {k: mt.nd.zeros(v.shape) for k, v in params.items()}
    data, label = mt.nd.array(x), mt.nd.array(y)
    if not (data.data.is_cuda and p[names[0]].data.is_cuda):
        raise AssertionError("nd.array without a context is not on the "
                             "card")
    mt.autograd.mark_variables([p[k] for k in names], [g[k] for k in names])

    def step():
        with mt.autograd.record():
            out = imperative_lm(mt.nd, p, data, label, TRAIN_LAYERS, EMBED,
                                TRAIN_HEADS, FFN, VOCAB)
        mt.autograd.backward([out])
        for k in names:
            mt.nd.sgd_update(p[k], g[k], lr=TRAIN_LR,
                             rescale_grad=1.0 / b, out=p[k])
        return out

    def snapshot():
        return {k: p[k].data.detach().clone() for k in names}

    for d, name in counters:
        d[name] = 0
    fused_lm.FUSED_PATH["last"] = attn.PATH_TAKEN["last"] = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step()
    i_loss = loss_of(out.data)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    i_grads = {k: g[k].data.clone() for k in names}
    i_one = snapshot()
    for _ in range(IMP_GATE_STEPS - 1):
        step()
    torch.cuda.synchronize()
    i_last = snapshot()
    paths = {"fused": fused_lm.FUSED_PATH["last"],
             "attention": attn.PATH_TAKEN["last"]}

    # gates
    def on_q(k, table):
        # the analytically-zero *_k_bias gradient (its parameter holds
        # rounding noise) on its layer's *_q_bias norm
        return table[k[:-len("_k_bias")] + "_q_bias"] \
            if k.endswith("_k_bias") else table[k]

    def rel(got, want):
        errs = {k: float(torch.linalg.vector_norm((got[k] - w).double()))
                / max(float(torch.linalg.vector_norm(
                    on_q(k, want).double())), 1e-30)
                for k, w in want.items()}
        worst = max(errs, key=errs.get)
        return errs[worst], worst, sum(torch.equal(got[k], w)
                                       for k, w in want.items())

    grad_err, grad_worst, grads_bitwise = rel(i_grads, m_grads)
    one_err, one_worst, one_bitwise = rel(i_one, m_one)
    last_err, last_worst, _ = rel(i_last, m_last)
    vs_module = _run_diff(torch, i_last, m_last, start, _DIRECT)
    spread = _run_diff(torch, m2_last, m_last, start, _DIRECT)
    gates = {"loss": i_loss, "module_loss": m_loss,
             "loss_rel_err": abs(i_loss - m_loss) / abs(m_loss),
             "loss_tol": TOL_IMP_LOSS,
             "grad_max_rel_err": grad_err, "grad_worst": grad_worst,
             "grad_tol": TOL_TRAIN_GRAD, "grads_bitwise": grads_bitwise,
             "params_one_step_max_rel_err": one_err,
             "params_one_step_worst": one_worst,
             "params_one_step_bitwise": one_bitwise,
             "param_tol": TOL_IMP_PARAMS,
             "steps": IMP_GATE_STEPS,
             "params_last_max_rel_err": last_err,
             "params_last_worst": last_worst,
             "imperative_vs_module": vs_module,
             "module_vs_module": spread,
             "max_over_spread": CAPTURE_SPREAD, "tensors": len(m_last)}
    log("train imperative vs module: " + json.dumps(gates))
    del m_grads, i_grads, m_one, m_last, m2_last, i_one, i_last, start
    within_spread = all(
        vs_module["tiers"][tr]["max"]
        <= CAPTURE_SPREAD * max(spread["tiers"][tr]["max"], 1e-7)
        for tr in ("before_relu", "behind_relu"))
    if not (gates["loss_rel_err"] <= TOL_IMP_LOSS
            and grad_err <= TOL_TRAIN_GRAD and one_err <= TOL_IMP_PARAMS
            and within_spread):
        raise AssertionError("the imperative LM against the Module: %s"
                             % gates)

    # timed steps
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for _ in range(IMP_TIMED_STEPS):
        losses.append(step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [loss_of(o.data) for o in losses]
    steps = IMP_GATE_STEPS + IMP_TIMED_STEPS
    launches = {name: d[name] for d, name in counters}
    per_step = {k: v / steps for k, v in launches.items()}
    segments = 5 * TRAIN_LAYERS
    want = {"fused_fwd": segments, "fused_bwd": segments,
            "flash_fwd": TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
            "flash_bwd_dkv": TRAIN_LAYERS}
    log("train imperative launches: %s per step %s paths: %s"
        % (launches, per_step, paths))
    if per_step != want or paths != {"fused": "kernel",
                                     "attention": "flash"}:
        raise AssertionError("the imperative step did not run every kernel "
                             "the expected number of times: %s (want %s "
                             "per step) %s" % (per_step, want, paths))
    if not (all(np.isfinite(losses)) and losses[-1] < i_loss):
        raise AssertionError("the imperative loss did not fall: %s, %s"
                             % (i_loss, losses))

    # host time in the dispatch path, over one more step
    real = mt.ndarray.imperative_invoke
    spent = [0.0, 0]

    def timed_invoke(*args, **kwargs):
        t1 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            spent[0] += time.perf_counter() - t1
            spent[1] += 1

    mt.ndarray.imperative_invoke = timed_invoke
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host_step_s = time.perf_counter() - t1
    finally:
        mt.ndarray.imperative_invoke = real

    def one_step():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    profile = _profile(torch, one_step)
    busy = profile["device_busy_s"]
    step_s = wall / IMP_TIMED_STEPS
    reading = {"config": {"vocab": VOCAB, "t": t, "batch": b,
                          "embed": EMBED, "heads": TRAIN_HEADS, "ffn": FFN,
                          "layers": TRAIN_LAYERS, "dtype": "float32",
                          "update": "nd.sgd_update per parameter",
                          "lr": TRAIN_LR, "params": int(sum(
                              v.size for v in params.values()))},
               "smoke_reading": True, "steps": IMP_TIMED_STEPS,
               "step_s": step_s, "warmup_step_s": warm_s,
               "tokens_per_s": b * t * IMP_TIMED_STEPS / wall,
               "losses": [i_loss] + losses,
               "idle_share": 1.0 - busy / step_s
               if isinstance(busy, float) else busy,
               "profiled_idle_share": profile.get("device_idle_share"),
               "peak_memory_gb": peak_gb,
               "invoke_host_ms_per_step": spent[0] * 1e3,
               "invoke_calls_per_step": spent[1],
               "instrumented_step_s": host_step_s,
               "launches": launches, "launches_per_step": per_step,
               "gates": gates}
    log("train imperative: " + json.dumps(reading))
    log("train imperative profile: " + json.dumps(profile))
    del p, g, out, data, label
    gc.collect()
    torch.cuda.empty_cache()
    return reading, launches


def phase_ops(torch, dev):
    """Every op case (tests/test_torch_op_cases.py: the elementwise,
    tensor and layer ops, the contrib ops with the 38 x 50 Proposal, the
    spatial ops; forward and gradient) on the card against the same op
    on the CPU, and the samplers by their moments; every op of the
    imperative slice's 163 names runs."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import registry as reg

    cases = _op_cases()
    ran = {id(reg.get_op(n)) for n in cases.case_ops()}
    missing = [n for n in cases.NEW_NAMES if id(reg.get_op(n)) not in ran]
    if missing:
        raise AssertionError("ops of the slice no case runs: %s" % missing)
    worst, bad, count = (0.0, None), [], 0
    t0 = time.perf_counter()
    for table in (cases.ELEMWISE, cases.TENSOR, cases.NN, cases.CONTRIB,
                  cases.CONTRIB_LARGE, cases.SPATIAL):
        for name, (op, arrays, attrs, grad) in sorted(table.items()):
            (outs, grads), (c_outs, c_grads) = (
                cases.run_port(op, arrays, attrs, grad, ctx)
                for ctx in (mt.gpu(0), mt.cpu()))
            count += 1
            for got, want in zip(outs + grads, c_outs + c_grads):
                if not want.size:
                    continue
                mag = max(1.0, float(np.nanmax(np.abs(want))))
                err = float(np.nanmax(np.abs(got.astype(np.float64)
                                             - want))) / mag
                if got.dtype != want.dtype or not err <= TOL_OPS_CARD \
                        or not np.array_equal(np.isnan(got),
                                              np.isnan(want)):
                    bad.append({"case": name, "err": err,
                                "dtype": str(got.dtype)})
                if err > worst[0]:
                    worst = (err, name)
    samplers = {}
    for op, (attrs, params) in sorted(cases.SAMPLERS.items()):
        got = cases.draw_port(op, attrs, params, OPS_DRAWS, 3, mt.gpu(0))
        again = cases.draw_port(op, attrs, params, OPS_DRAWS, 3, mt.gpu(0))
        want = cases.draw_port(op, attrs, params, OPS_DRAWS, 3, mt.cpu())
        z = max(max(abs(gr.mean() - w.mean())
                    / np.sqrt((gr.var() + w.var()) / OPS_DRAWS),
                    abs(gr.var() - w.var()) / np.sqrt(
                        2 * max(np.mean((w - w.mean()) ** 4) - w.var() ** 2,
                                1e-12) / OPS_DRAWS))
                for gr, w in zip(got, want))
        samplers[op] = {"repeats": bool(np.array_equal(got, again)),
                        "max_z": float(z)}
        if not (samplers[op]["repeats"] and z <= 6.0):
            bad.append({"sampler": op, **samplers[op]})
    line = {"cases": count, "names": len(cases.NEW_NAMES),
            "ops": len({id(reg.get_op(n)) for n in cases.NEW_NAMES}),
            "max_rel_err": worst[0], "worst_case": worst[1],
            "tol": TOL_OPS_CARD, "samplers": len(samplers),
            "sampler_max_z": max(v["max_z"] for v in samplers.values()),
            "draws": OPS_DRAWS, "seconds": time.perf_counter() - t0,
            "failed": bad}
    log("ops: " + json.dumps(line))
    if bad:
        raise AssertionError("ops on the card against the CPU: %s" % bad)
    return line


def _logp_gap(torch, got, want):
    """max |log got - log want| over probabilities (floored at 1e-30)."""
    return float((torch.log(torch.clamp_min(got, 1e-30))
                  - torch.log(torch.clamp_min(want, 1e-30))).abs().max())


def phase_predict(torch, dev):
    """Inference through the normal entry points at the training
    configuration's full width: a checkpoint saved and loaded back
    (``Module.load``), ``Module.predict`` over a padded iterator through
    the captured inference forward (kernels A and C inside), held
    against the same predict under programs.eager() and against a plain
    module; ``Predictor.from_checkpoint`` and its reshape round trip;
    ``Module.reshape`` to batch 4; ``backward(out_grads)`` on the LM's
    logits against a plain module (kernels D, E, F behind it); a serve
    from the ``.params`` file over a prompt holding out-of-range ids."""
    from mxnet_tpu_torch import Predictor, gpu, model, programs
    from mxnet_tpu_torch.decode import DecodeServer
    from mxnet_tpu_torch.io import DataBatch, DataDesc, NDArrayIter
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import attention as attn
    from mxnet_tpu_torch.ops import flash_kernel as fl
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.ops import fused_lm

    b, t, n = TRAIN_BATCH, SEQ, PREDICT_N
    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=t,
                                  num_layers=TRAIN_LAYERS, embed=EMBED,
                                  heads=TRAIN_HEADS, ffn_hidden=FFN)
    params = _train_params(sym)
    rng = np.random.RandomState(2)
    x = rng.randint(0, VOCAB, (n, t)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.full((n, 1), -1, np.float32)], 1)
    batches = -(-n // b)
    pad = batches * b - n
    segments = 5 * TRAIN_LAYERS
    counters = ((fk.LAUNCHES, "fused_fwd"), (fl.LAUNCHES, "flash_fwd"))
    log("predict model: the train model's LM and weights, %d sequences at "
        "batch %d (%d batches, the last padded by %d)" % (n, b, batches,
                                                          pad))

    def descs(batch):
        return ([DataDesc("data", (batch, t), layout="NT")],
                [DataDesc("softmax_label", (batch, t), layout="NT")])

    def loaded(prefix, plain=False):
        mod = Module.load(prefix, 0, context=gpu(0), plain=plain)
        mod.bind(*descs(b), for_training=False)
        return mod

    def timed_predict(mod, batch=b, eager=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with programs.eager() if eager else contextlib.nullcontext():
            out = mod.predict(NDArrayIter(x, y, batch_size=batch)).data
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "lm")
        model.save_checkpoint(prefix, 0, sym, params, {})
        kmod = loaded(prefix)
        torch.cuda.reset_peak_memory_stats()
        for d, name in counters:
            d[name] = 0
        fused_lm.FUSED_PATH["last"] = attn.PATH_TAKEN["last"] = None
        graphs0 = dict(programs.GRAPH_STATS)
        out, first_wall = timed_predict(kmod)
        launches = {name: d[name] for d, name in counters}
        paths = {"fused": fused_lm.FUSED_PATH["last"],
                 "attention": attn.PATH_TAKEN["last"]}
        graphs = _graph_delta(graphs0)
        want = {"fused_fwd": segments * batches,
                "flash_fwd": TRAIN_LAYERS * batches}
        # the reference's strip: each output loses the pad by its own
        # leading dimension, here the flattened (B * T, V) head's rows
        rows = batches * b * t - pad
        log("predict launches: %s paths: %s graph stats: %s rows: %d"
            % (launches, paths, graphs, out.shape[0]))
        if launches != want or paths != {"fused": "kernel",
                                         "attention": "flash"}:
            raise AssertionError("predict did not run kernels A and C %s "
                                 "times: %s %s" % (want, launches, paths))
        if (graphs["captures"], graphs["replays"]) != (1, batches - 1):
            raise AssertionError("predict: %s (want one capture, then a "
                                 "replay a batch)" % graphs)
        if tuple(out.shape) != (rows, VOCAB) \
                or not bool(torch.isfinite(out).all()):
            raise AssertionError("predict output %s (want (%d, %d), "
                                 "finite)" % (tuple(out.shape), rows, VOCAB))
        graphs1 = dict(programs.GRAPH_STATS)
        again, wall = timed_predict(kmod)
        replay_graphs = _graph_delta(graphs1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # eager timed on its second call, as captured is (the first
        # fills the allocator's cache)
        eager_out, _ = timed_predict(kmod, eager=True)
        _, eager_wall = timed_predict(kmod, eager=True)
        capture_gate = {"replayed_bitwise": bool(torch.equal(again, out)),
                        "eager_bitwise": bool(torch.equal(eager_out, out)),
                        "replay_graphs": replay_graphs}
        log("predict captured vs eager: " + json.dumps(capture_gate))
        if not (capture_gate["replayed_bitwise"]
                and capture_gate["eager_bitwise"]) \
                or replay_graphs["captures"] != 0:
            raise AssertionError("predict captured against eager: %s"
                                 % capture_gate)
        del again, eager_out

        # the plain versions, over the n real sequences' rows
        pmod = loaded(prefix, plain=True)
        with programs.eager():
            plain = pmod.predict(NDArrayIter(x, y, batch_size=b)).data
        del pmod
        live = n * t
        plain_gate = {
            "max_abs_logp": _logp_gap(torch, out[:live], plain[:live]),
            "max_abs_p": float((out[:live] - plain[:live]).abs().max()),
            "tol_logp": TOL_LOGP}
        del plain
        log("predict kernel vs plain: " + json.dumps(plain_gate))
        if not plain_gate["max_abs_logp"] <= TOL_LOGP:
            raise AssertionError("predict, kernel vs plain: %s"
                                 % plain_gate)

        # one batch profiled, captured and eager
        it = NDArrayIter(x, y, batch_size=b)
        one = next(iter(it))

        def one_batch(eager=False):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with programs.eager() if eager else contextlib.nullcontext():
                kmod.forward(one, is_train=False)
            torch.cuda.synchronize()
            return time.perf_counter() - t1

        profile = _profile(torch, one_batch, PREDICT_KERNEL_GROUPS)
        profile_eager = _profile(torch, lambda: one_batch(eager=True),
                                 PREDICT_KERNEL_GROUPS)

        # Predictor from the same files: its first batch is predict's,
        # and a reshape round trip captures nothing new on the way back
        pred = Predictor.from_checkpoint(
            prefix, 0, {"data": (b, t), "softmax_label": (b, t)},
            ctx=gpu(0))
        p_out = pred.forward(data=x[:b])[0].data.clone()
        small = pred.reshape({"data": (2, t), "softmax_label": (2, t)})
        s_out = small.forward(data=x[:2])[0].data
        captures = programs.GRAPH_STATS["captures"]
        back = small.reshape({"data": (b, t), "softmax_label": (b, t)})
        b_out = back.forward(data=x[:b])[0].data
        torch.cuda.synchronize()
        predictor_gate = {
            "first_batch_bitwise": bool(torch.equal(p_out, out[:b * t])),
            "batch2_bitwise": bool(torch.equal(s_out, out[:2 * t])),
            "batch2_max_abs_logp": _logp_gap(torch, s_out, out[:2 * t]),
            "round_trip_new_captures":
                programs.GRAPH_STATS["captures"] - captures,
            "round_trip_same_executor": back._exec is pred._exec,
            "round_trip_bitwise": bool(torch.equal(b_out, p_out))}
        del pred, small, back, p_out, s_out, b_out
        log("predict Predictor: " + json.dumps(predictor_gate))
        if not (predictor_gate["first_batch_bitwise"]
                and predictor_gate["round_trip_bitwise"]
                and predictor_gate["round_trip_same_executor"]
                and predictor_gate["round_trip_new_captures"] == 0
                and predictor_gate["batch2_max_abs_logp"] <= TOL_LOGP):
            raise AssertionError("Predictor against predict: %s"
                                 % predictor_gate)

        # Module.reshape to batch 4: n / 4 unpadded batches
        kmod.reshape(*descs(PREDICT_SMALL_BATCH))
        r_out, r_first_wall = timed_predict(kmod, batch=PREDICT_SMALL_BATCH)
        _, r_wall = timed_predict(kmod, batch=PREDICT_SMALL_BATCH)
        reshape_gate = {"rows": r_out.shape[0],
                        "bitwise": bool(torch.equal(r_out, out[:live])),
                        "max_abs_logp": _logp_gap(torch, r_out,
                                                  out[:live]),
                        "tol_logp": TOL_LOGP}
        del r_out, kmod, out
        log("predict reshape: " + json.dumps(reshape_gate))
        if reshape_gate["rows"] != live \
                or not reshape_gate["max_abs_logp"] <= TOL_LOGP:
            raise AssertionError("predict after Module.reshape: %s"
                                 % reshape_gate)
        gc.collect()
        torch.cuda.empty_cache()

        # backward(out_grads) on the logits: D, E and F behind the head
        # gradients, against the plain versions
        head = sym.get_internals()["head_output"]
        gen = torch.Generator(device=dev).manual_seed(3)
        g = torch.randn((b * t, VOCAB), generator=gen, device=dev) * 1e-3
        data = [NDArray(torch.from_numpy(x[:b]))]
        grad_counters = counters + ((fk.LAUNCHES, "fused_bwd"),
                                    (fl.LAUNCHES, "flash_bwd_dq"),
                                    (fl.LAUNCHES, "flash_bwd_dkv"))

        def head_grads(plain):
            mod = Module(head, label_names=None, context=gpu(0),
                         plain=plain)
            mod.bind(descs(b)[0], None, for_training=True)
            mod.init_params(arg_params=params)
            mod.forward(DataBatch(data, []), is_train=True)
            mod.backward(out_grads=[NDArray(g)])
            group = mod._exec_group
            return {name: a.data.clone() for name, a in
                    zip(group.param_names, group.grad_arrays)}

        for d, name in grad_counters:
            d[name] = 0
        kgrads = head_grads(False)
        torch.cuda.synchronize()
        grad_launches = {name: d[name] for d, name in grad_counters}
        pgrads = head_grads(True)
        grad_check = _grad_tiers(torch, kgrads, pgrads, "out_grads")
        # the head's bias gradient is the column sum of the head gradient
        bias_err = _rel_err(kgrads["head_bias"], g.sum(0))
        del kgrads, pgrads, g
        out_grads_gate = {"launches": grad_launches,
                          "grad_rel_err": grad_check,
                          "head_bias_vs_column_sum": bias_err,
                          "tol": TOL_TRAIN_GRAD}
        log("predict out_grads: " + json.dumps(out_grads_gate))
        if not bias_err <= TOL_TRAIN_GRAD or any(
                v == 0 for v in grad_launches.values()):
            raise AssertionError("backward(out_grads): %s" % out_grads_gate)
        gc.collect()
        torch.cuda.empty_cache()

        # a serve over a prompt holding out-of-range ids, predictors made
        # from the .params file (its path, then its bytes)
        json_path, params_path = prefix + "-symbol.json", \
            prefix + "-0000.params"
        prompt = np.random.RandomState(4).randint(0, VOCAB,
                                                  PREDICT_OOB_PROMPT)
        at = [3, PREDICT_OOB_PROMPT // 3, PREDICT_OOB_PROMPT - 2]
        bad, clamped = prompt.copy(), prompt.copy()
        bad[at] = [VOCAB, VOCAB + 2, -VOCAB - 1]
        clamped[at] = [VOCAB - 1, VOCAB - 1, 0]
        pred = _predictor(json_path, params_path, False, dev)
        _, probs = pred.prefill(np.stack([bad, clamped]).astype(np.float32))
        torch.cuda.synchronize()
        prefill_equal = bool(torch.equal(probs[0], probs[1]))
        del pred, probs
        with open(params_path, "rb") as f:
            pred = _predictor(json_path, f.read(), False, dev)
        srv = DecodeServer(pred, max_prefill=len(prompt), slots=2,
                           max_new_tokens=8)
        rids = [srv.submit(bad), srv.submit(clamped)]
        served = srv.run()
        torch.cuda.synchronize()
        oob_gate = {"prefill_probs_equal": prefill_equal,
                    "tokens_equal": bool(np.array_equal(served[rids[0]],
                                                        served[rids[1]])),
                    "tokens": len(served[rids[0]])}
        del pred, srv
        log("predict out-of-range serve: " + json.dumps(oob_gate))
        if not (prefill_equal and oob_gate["tokens_equal"]
                and oob_gate["tokens"] == 8):
            raise AssertionError("out-of-range prompt: %s" % oob_gate)
    gc.collect()
    torch.cuda.empty_cache()

    reading = {"config": {"model": "train-f32 LM", "sequences": n,
                          "batch": b, "t": t, "pad": pad,
                          "checkpoint": "model.save_checkpoint -> "
                                        "Module.load"},
               "tokens_per_s": {"captured": live / wall,
                                "captured_first_call": live / first_wall,
                                "eager": live / eager_wall,
                                "batch4_first_call": live / r_first_wall,
                                "batch4": live / r_wall},
               "wall_s": {"captured": wall, "captured_first_call":
                          first_wall, "eager": eager_wall,
                          "batch4_first_call": r_first_wall,
                          "batch4": r_wall},
               "idle_share": {"captured": profile.get("device_idle_share"),
                              "eager": profile_eager.get(
                                  "device_idle_share")},
               "batch_device_busy_s": {
                   "captured": profile.get("device_busy_s"),
                   "eager": profile_eager.get("device_busy_s")},
               "device_ms_by_kernel": {
                   k: v["device_ms"] for k, v in
                   profile.get("groups", {}).items()},
               "peak_memory_gb": peak_gb, "launches": launches,
               "launches_per_batch": {k: v / batches
                                      for k, v in launches.items()},
               "graph_stats": graphs, "kernel_vs_plain": plain_gate,
               "reshape_batch4": reshape_gate}
    log("predict: " + json.dumps(reading))
    log("predict profile: " + json.dumps(profile))
    log("predict profile eager: " + json.dumps(profile_eager))
    return reading, launches, grad_launches


def phase_routing(torch, dev):
    """The attention routing on the card: a Module over attention_lm at
    head dim 32 (16 heads over 512) and 256 (2 heads over 512), shapes
    the flash kernels are not built for, takes sdpa ("einsum") as the JAX
    package's gate routes them, launches no flash kernel, and matches a
    plain=True module's forward and backward."""
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ops import attention as attn
    from mxnet_tpu_torch.ops import flash_kernel as fl

    b, t, embed = 2, 256, 512
    out = {}
    for heads in (16, 2):
        sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=t,
                                      num_layers=1, embed=embed, heads=heads,
                                      ffn_hidden=2 * embed)
        rng = np.random.RandomState(heads)
        shapes, _, _ = sym.infer_shape(data=(b, t), softmax_label=(b, t))
        params = {n: (rng.normal(0, 0.05, sh) + n.endswith("_gamma"))
                  .astype(np.float32)
                  for n, sh in zip(sym.list_arguments(), shapes)
                  if n not in ("data", "softmax_label")}
        x = rng.randint(0, VOCAB, (b, t)).astype(np.float32)
        batch = DataBatch([nd.array(x)], [nd.array(np.roll(x, -1, 1))])
        outs, grads = [], []
        for plain in (False, True):
            mod = Module(sym, context=gpu(0), plain=plain)
            mod.bind(data_shapes=[DataDesc("data", (b, t), layout="NT")],
                     label_shapes=[DataDesc("softmax_label", (b, t),
                                            layout="NT")])
            mod.init_params(arg_params=params, aux_params={})
            before = dict(fl.LAUNCHES)
            attn.PATH_TAKEN["last"] = None
            mod.forward_backward(batch)
            torch.cuda.synchronize()
            if attn.PATH_TAKEN["last"] != "einsum" or fl.LAUNCHES != before:
                raise AssertionError(
                    "hd %d: attention took %s, flash launches %s -> %s"
                    % (embed // heads, attn.PATH_TAKEN["last"], before,
                       fl.LAUNCHES))
            group = mod._exec_group
            outs.append(mod.get_outputs()[0].data.clone())
            grads.append({n: a.data.clone() for n, a in
                          zip(group.param_names, group.grad_arrays)})
            del mod
        err = _check_close("routing hd %d outputs" % (embed // heads), outs[0],
                           outs[1], TOL_F32)
        worst = {}
        for name, gp in grads[1].items():
            ref = name[:-len("_k_bias")] + "_q_bias" \
                if name.endswith("_k_bias") else name
            rel = float(torch.linalg.vector_norm(
                (grads[0][name] - gp).double())) / max(float(
                    torch.linalg.vector_norm(grads[1][ref].double())), 1e-30)
            tol = TOL_TRAIN_GRAD if name.startswith(
                ("head_", "final_", "layer0_ffn2_")) else TOL_TRAIN_GRAD_RELU
            if not rel <= tol:
                raise AssertionError(
                    "routing hd %d: %s gradient off by %.3g > %.3g"
                    % (embed // heads, name, rel, tol))
            worst[name] = rel
        out["hd%d" % (embed // heads)] = {
            "path": "einsum", "max_abs_err_out": err,
            "max_grad_rel_err": max(worst.values())}
    log("routing: " + json.dumps(out))
    return out


def _resnet_values(sym, b, image=(3, 224, 224)):
    """bench.py's start, drawn with numpy: Xavier(gaussian, in, 2) weights
    (normal with std sqrt(2 / fan_in), OIHW fan-in I*kh*kw) from
    RandomState(0), gammas 1, betas and the bias 0, moving means 0 and
    variances 1; the resident batch (``image`` a sample, labels in
    [0, 1000)) from another RandomState(0)."""
    shapes, _, aux_shapes = sym.infer_shape(data=(b,) + tuple(image),
                                            softmax_label=(b,))
    rng = np.random.RandomState(0)
    args = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            fan_in = shape[1] * int(np.prod(shape[2:]))
            args[name] = rng.normal(0.0, np.sqrt(2.0 / fan_in),
                                    shape).astype(np.float32)
        elif name.endswith("_gamma"):
            args[name] = np.ones(shape, np.float32)
        else:
            args[name] = np.zeros(shape, np.float32)
    aux = {n: (np.ones if n.endswith("_var") else np.zeros)(s, np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (b,) + tuple(image)).astype(np.float32)
    y = rng.randint(0, 1000, (b,)).astype(np.float32)
    return args, aux, x, y


def phase_train_resnet(torch, dev):
    """ResNet-50 training through Module at bench.py's configuration, the
    optimizer update through the slab plan."""
    from mxnet_tpu_torch import gpu, programs
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ops import update_kernel as uk

    b = RESNET_BATCH
    sym = resnet.get_symbol(num_classes=1000, num_layers=50,
                            image_shape=(3, 224, 224))
    args, aux, x, y = _resnet_values(sym, b)
    n_params = sum(v.size for v in args.values())
    log("train model: resnet-50 batch=%d params=%d (f32 masters, bf16 "
        "compute), SGD %s" % (b, n_params, RESNET_OPT))
    batch = DataBatch([nd.array(x, ctx=gpu(0))], [nd.array(y, ctx=gpu(0))])
    labels = torch.from_numpy(y).long().to(dev)[:, None]

    kmod = Module(sym, context=gpu(0), compute_dtype="bfloat16")
    kmod.bind(data_shapes=[DataDesc("data", (b, 3, 224, 224))],
              label_shapes=[DataDesc("softmax_label", (b,))])
    kmod.init_params(arg_params=args, aux_params=aux)
    kmod.init_optimizer(optimizer="sgd", optimizer_params=RESNET_OPT)
    tstep = kmod._train_step
    if tstep.plan is None:
        raise AssertionError("ResNet-50's train step armed no slab plan")

    def step(mod):
        # the loss of the step's forward, left on the card
        mod.forward_backward(batch)
        mod.update()
        p = mod.get_outputs()[0].data.float().gather(1, labels)
        return -torch.log(torch.clamp_min(p, 1e-30)).mean()

    plan = tstep.plan
    blocks = {bk: plan.rows(bk) // uk.BLOCK_ROWS for bk in plan.buckets}
    # the per-parameter update's inputs from before the first step: copies
    # of the masters and the momentum, and an optimizer made as
    # init_optimizer made the module's
    group = kmod._exec_group
    idx = sorted(kmod._updater.states)
    ref_w = [nd.NDArray(group.param_arrays[i].data.clone()) for i in idx]
    ref_m = [kmod._updater.states[i].clone() for i in idx]
    ref_opt = opt_mod.create("sgd", sym=sym, rescale_grad=1.0 / b,
                             param_idx2name=dict(enumerate(
                                 group.param_names)), **RESNET_OPT)
    real, checked, b1_first = _b1_capture(torch, uk)
    uk.multi_tensor_update = checked
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with programs.eager():
            losses = [step(kmod)]
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        uk.multi_tensor_update = real
    if b1_first != {"launches": 1, "bitwise": True, "path": "kernel"}:
        raise AssertionError("ResNet-50's first update, kernel B1 vs plain "
                             "on the same slabs: %s" % b1_first)
    # the per-parameter update (the path a step takes where the plan
    # declines) on the copies, with the gradients the step packed: the
    # masters, the momentum and the bf16 copy the next forward reads must
    # equal the kernel's bit for bit
    ref_opt.update_multi(idx, ref_w, [group.grad_arrays[i] for i in idx],
                         ref_m)
    sides = {"params": [(group.param_arrays[i].data, w.data)
                        for i, w in zip(idx, ref_w)],
             "momentum": [(kmod._updater.states[i], m)
                          for i, m in zip(idx, ref_m)],
             "bf16_copy": [(tstep._views[group.param_names[i]],
                            w.data.to(torch.bfloat16))
                           for i, w in zip(idx, ref_w)]}
    parity = {}
    for label, pairs in sides.items():
        diff = [(a, c) for a, c in pairs if not torch.equal(a, c)]
        parity[label] = {"tensors": len(pairs), "unequal": len(diff),
                         "max_abs_diff": max(
                             [float((a.float() - c.float()).abs().max())
                              for a, c in diff] or [0.0])}
    del sides, ref_w, ref_m, ref_opt
    log("train resnet plan vs per-parameter update: " + json.dumps(parity))
    if any(v["unequal"] for v in parity.values()):
        raise AssertionError("ResNet-50's first update, kernel B1 vs the "
                             "per-parameter update: %s" % parity)

    # the peak over the set-up and timed steps, without the copies above
    # (the cache keeps its blocks: emptying it would time the allocator's
    # refill)
    torch.cuda.reset_peak_memory_stats()
    graphs0 = dict(programs.GRAPH_STATS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses.append(step(kmod))   # the step program's set-up: warm-up, capture
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    uk.LAUNCHES["multi_tensor_update"] = 0
    uk.UPDATE_PATH["last"] = None
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        losses.append(step(kmod))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs = _graph_delta(graphs0)
    launches = {"multi_tensor_update": uk.LAUNCHES["multi_tensor_update"]}
    path = uk.UPDATE_PATH["last"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if graphs["captures"] != 1 or graphs["replays"] != RESNET_STEPS:
        raise AssertionError("the ResNet-50 step: %s (want one capture, "
                             "then a replay a step)" % graphs)
    losses = [float(v) for v in losses]
    log("train resnet launches: %s path: %s" % (launches, path))
    if launches["multi_tensor_update"] != RESNET_STEPS or path != "kernel":
        raise AssertionError("the ResNet-50 step did not launch kernel B1 "
                             "once a step: %s %s" % (launches, path))
    if not all(np.isfinite(losses)):
        raise AssertionError("ResNet-50 losses %s" % losses)
    _, aux_now = kmod.get_params()
    unmoved = [n for n, v in aux_now.items()
               if np.array_equal(v.asnumpy(), aux[n])]
    if unmoved:
        raise AssertionError("moving statistics that did not move: %s"
                             % unmoved)

    def one_step(eager=False):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with programs.eager() if eager else contextlib.nullcontext():
            step(kmod)
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    profile = _profile(torch, one_step, groups=RESNET_KERNEL_GROUPS)
    profile_eager = _profile(torch, lambda: one_step(eager=True),
                             groups=RESNET_KERNEL_GROUPS)
    eager_s = min(one_step(eager=True) for _ in range(RESNET_STEPS))
    del kmod, tstep, batch
    gc.collect()
    torch.cuda.empty_cache()
    capture_gate, round_trip = _resnet_capture_and_round_trip(
        torch, dev, sym, args, aux, x, y)
    train = {"config": {"model": "resnet-50", "batch": b,
                        "image": [3, 224, 224], "compute_dtype": "bfloat16",
                        "masters": "float32", "optimizer": "sgd",
                        "optimizer_params": RESNET_OPT, "params": n_params,
                        "update": "slab plan",
                        "source": "bench.py:87-125"},
             "slab_blocks": blocks, "steps": RESNET_STEPS,
             "step_s": wall / RESNET_STEPS, "warmup_step_s": warm_s,
             "setup_step_s": setup_s, "graph_stats": graphs,
             "eager_step_s": eager_s,
             "idle_share": _idle_shares(profile, profile_eager,
                                        wall / RESNET_STEPS, eager_s),
             "img_per_s": b * RESNET_STEPS / wall, "losses": losses,
             "launches": launches, "update_path": path,
             "first_update_bitwise_vs_plain": b1_first["bitwise"],
             "moving_stats_moved": len(aux_now),
             "plan_vs_per_param": parity, "peak_memory_gb": peak_gb,
             "captured_vs_eager": capture_gate, "round_trip": round_trip}
    log("train resnet: " + json.dumps(train))
    log("train resnet profile: " + json.dumps(profile))
    log("train resnet profile eager: " + json.dumps(profile_eager))
    return train, launches


def _resnet_capture_and_round_trip(torch, dev, sym, args, aux, x, y):
    """ResNet-50 at batch RESNET_BATCH with cuDNN's deterministic
    algorithms: RESNET_GATE_STEPS captured steps against the same steps
    under programs.eager() from the same start (masters, moving
    statistics and momentum bit for bit), then the card round trip: the
    captured module saves a checkpoint with its optimizer states,
    ``Module.load`` reads it back into a new module, and one more step
    of each lands on the same values bit for bit."""
    from mxnet_tpu_torch import gpu, programs
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    from mxnet_tpu_torch.module import Module

    b = RESNET_BATCH
    batch = DataBatch([nd.array(x, ctx=gpu(0))], [nd.array(y, ctx=gpu(0))])
    shapes = ([DataDesc("data", (b, 3, 224, 224))],
              [DataDesc("softmax_label", (b,))])

    def ready(mod):
        mod.bind(*shapes)
        mod.init_optimizer(optimizer="sgd", optimizer_params=RESNET_OPT)
        return mod

    def fresh():
        mod = Module(sym, context=gpu(0), compute_dtype="bfloat16")
        mod.bind(*shapes)
        mod.init_params(arg_params=args, aux_params=aux)
        mod.init_optimizer(optimizer="sgd", optimizer_params=RESNET_OPT)
        return mod

    def state(mod):
        snap = _snapshot(mod)
        snap.update({"momentum:%d" % i: s.clone()
                     for i, s in mod._updater.states.items()})
        return snap

    def run(mod, steps, eager):
        with programs.eager() if eager else contextlib.nullcontext():
            for _ in range(steps):
                mod.forward_backward(batch)
        torch.cuda.synchronize()

    start = {n: torch.from_numpy(v).to(dev) for n, v in args.items()}
    start.update({"aux:" + n: torch.from_numpy(v).to(dev)
                  for n, v in aux.items()})
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.cuda.reset_peak_memory_stats()
    try:
        emod = fresh()
        run(emod, RESNET_GATE_STEPS, eager=True)
        eager = state(emod)
        del emod
        cmod = fresh()
        run(cmod, RESNET_GATE_STEPS, eager=False)
        got = state(cmod)
        start.update({k: torch.zeros_like(v) for k, v in got.items()
                      if k.startswith("momentum:")})
        gate = _run_diff(torch, got, eager, start, ("fc1_",))
        gate.update(steps=RESNET_GATE_STEPS, batch=b,
                    cudnn_deterministic=True)
        log("train resnet captured vs eager: " + json.dumps(gate))
        del eager, got
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "resnet50")
            cmod.save_checkpoint(prefix, 1, save_optimizer_states=True)
            sizes = {f: os.path.getsize(os.path.join(tmp, f))
                     for f in sorted(os.listdir(tmp))}
            lmod = ready(Module.load(prefix, 1, load_optimizer_states=True,
                                     context=gpu(0),
                                     compute_dtype="bfloat16"))
        loaded = _run_diff(torch, state(lmod), state(cmod), start,
                           ("fc1_",))
        run(cmod, 1, eager=False)
        run(lmod, 1, eager=False)
        after = _run_diff(torch, state(lmod), state(cmod), start,
                          ("fc1_",))
        del cmod, lmod
    finally:
        torch.backends.cudnn.deterministic = saved
    gc.collect()
    torch.cuda.empty_cache()
    trip = {"files": sizes, "loaded_vs_saved": loaded,
            "one_more_step": after,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("train resnet round trip: " + json.dumps(trip))
    if not gate["bitwise"]:
        raise AssertionError("ResNet-50's captured steps against eager: %s"
                             % gate)
    if not (loaded["bitwise"] and after["bitwise"]):
        raise AssertionError("ResNet-50's checkpoint round trip: %s" % trip)
    return gate, trip


def _bench_lstm_sym_gen():
    """benchmarks/bench_bucketing.py's sym_gen (configuration 1), built
    with the port's symbols and cells."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import symbol as sym

    def sym_gen(seq_len):
        net = sym.Embedding(sym.Variable("data"), input_dim=LSTM_VOCAB,
                            output_dim=LSTM_EMBED, name="embed")
        for i in range(LSTM_LAYERS):
            cell = mt.rnn.LSTMCell(LSTM_HIDDEN, prefix="l%d_" % i)
            net, _ = cell.unroll(seq_len, inputs=net, merge_outputs=True)
        pred = sym.FullyConnected(sym.Reshape(net, shape=(-1, LSTM_HIDDEN)),
                                  num_hidden=LSTM_VOCAB, name="fc")
        label = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
        out = sym.SoftmaxOutput(pred, label, use_ignore=True,
                                ignore_label=-1, name="softmax")
        return out, ("data",), ("softmax_label",)

    return sym_gen


def _lstm_sentences():
    """The bench's corpus: 2,000 sentences of 5-40 tokens in [1, 10000)
    from RandomState(0)."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(LSTM_SENTENCES):
        length = rng.randint(5, 41)
        out.append(rng.randint(1, LSTM_VOCAB, size=length).tolist())
    return out


def _rel_err(got, want):
    """max |got - want| / max |want| (0 when both are 0)."""
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    return err / scale if scale > 0 else err


def _rnn_fused_vs_unfused(torch, dev):
    """Gate 1: the fused RNN op (cuDNN) against the unfused LSTMCell
    stack carrying ``FusedRNNCell.unpack_weights`` of the same blob, at
    batch 32, T 40 and the LM's widths, f32: outputs, final states and
    the gradients of the data and the blob, both graphs seeded with ones
    at every output; then the device ms of each graph's forward and
    backward."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.executor import simple_bind

    n, t, i, h, layers = LSTM_BATCH, LSTM_BUCKETS[-1], LSTM_EMBED, \
        LSTM_HIDDEN, LSTM_LAYERS
    fused = mt.rnn.FusedRNNCell(h, num_layers=layers, mode="lstm",
                                prefix="lstm_", get_next_state=True)
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (n, t, i)).astype(np.float32)
    blob = None
    runs = []
    for cell in (fused, fused.unfuse()):
        out, states = cell.unroll(t, inputs=mt.sym.Variable("data"),
                                  layout="NTC", merge_outputs=True)
        exe = simple_bind(mt.sym.Group([out] + states), dev,
                          data=(n, t, i))
        if blob is None:
            blob = rng.uniform(-0.07, 0.07, exe.arg_dict[
                "lstm_parameters"].shape).astype(np.float32)
            values = {"lstm_parameters": blob}
        else:
            values = fused.unpack_weights({"lstm_parameters": blob},
                                          input_size=i)
        values["data"] = x
        for name, v in values.items():
            exe.arg_dict[name][:] = v

        def fwd_bwd(exe=exe):
            exe.forward(is_train=True)
            exe.backward()

        fwd_bwd()
        torch.cuda.synchronize()
        outs = [o.data.clone() for o in exe.outputs]
        grads = {k: g.data.clone() for k, g in exe.grad_dict.items()}
        runs.append((outs, grads, _device_ms(torch, fwd_bwd)))
    (f_outs, f_grads, f_ms), (u_outs, u_grads, u_ms) = runs
    # the fused states are (layers, n, h); the unfused h0, c0, h1, c1
    u_cmp = [u_outs[0], torch.stack(u_outs[1::2]),
             torch.stack(u_outs[2::2])]
    out_err = max(float((a - b).abs().max()) for a, b in zip(f_outs, u_cmp))
    packed = fused.pack_weights(
        {k: v.cpu().numpy() for k, v in u_grads.items() if k != "data"},
        input_size=i)["lstm_parameters"]
    grad_err = {"data": _rel_err(f_grads["data"], u_grads["data"]),
                "lstm_parameters": _rel_err(
                    f_grads["lstm_parameters"],
                    torch.from_numpy(packed).to(dev))}
    report = {"shape": [n, t, i, h, layers], "max_abs_err_out": out_err,
              "tol_out": TOL_RNN_OUT, "grad_rel_err": grad_err,
              "tol_grad": TOL_RNN_GRAD,
              "fused_fwd_bwd_device_ms": f_ms,
              "unfused_fwd_bwd_device_ms": u_ms}
    log("train lstm fused vs unfused: " + json.dumps(report))
    if not (out_err <= TOL_RNN_OUT
            and max(grad_err.values()) <= TOL_RNN_GRAD):
        raise AssertionError("the fused RNN op against the unfused cells: "
                             "%s" % report)
    return report


def _lstm_first_step(torch, dev, mod, batch, sym_gen):
    """Gates 2 and 3 on the first step of a BucketingModule: kernel B1
    against its plain version on copies of the shared slabs (within one
    ulp) and against the per-parameter update on copies; outputs and
    gradients against the port on the CPU from the same parameters and
    batch."""
    from mxnet_tpu_torch import cpu, programs
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import update_kernel as uk

    primary = mod._primary
    group = primary._exec_group
    args, aux = mod.get_params()
    args = {k: v.asnumpy().copy() for k, v in args.items()}
    aux = {k: v.asnumpy().copy() for k, v in aux.items()}
    idx = sorted(primary._updater.states)
    before = [group.param_arrays[i].data.clone() for i in idx]
    ref_w = [NDArray(w.clone()) for w in before]
    ref_s = [tuple(t.clone() for t in primary._updater.states[i])
             for i in idx]
    ref_opt = opt_mod.create("adam", sym=primary.symbol,
                             rescale_grad=1.0 / LSTM_BATCH,
                             param_idx2name=dict(enumerate(
                                 group.param_names)),
                             learning_rate=LSTM_LR)
    real = uk.multi_tensor_update
    b1 = {"launches": 0, "max_ulps": 0, "path": None}

    def checked(kind, nslots, w, g, slots, wc, lrb, wdb, hyp, plain=False):
        ref = [w.clone()] + [t.clone() for t in slots]
        path = real(kind, nslots, w, g, slots, wc, lrb, wdb, hyp,
                    plain=plain)
        uk.update_plain(kind, nslots, ref[0], g, ref[1:], None, lrb, wdb,
                        hyp)
        b1["launches"] += 1
        b1["path"] = path
        b1["max_ulps"] = max(b1["max_ulps"], max(
            _ulps(torch, a, c) for a, c in zip([w, *slots], ref)))
        return path

    uk.multi_tensor_update = checked
    try:
        with programs.eager():
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
    finally:
        uk.multi_tensor_update = real
    if b1["launches"] != 1 or b1["path"] != "kernel" \
            or b1["max_ulps"] > B1_ADAM_ULPS:
        raise AssertionError("the first LSTM update, kernel B1 vs plain on "
                             "the shared slabs: %s" % b1)
    active = mod._active._exec_group
    out = mod.get_outputs()[0].data.clone()
    grads = {n: g.data.clone() for n, g in zip(active.param_names,
                                               active.grad_arrays)}
    # the per-parameter update on the copies, with the gradients the
    # step packed
    ref_opt.update_multi(idx, ref_w, [group.grad_arrays[i] for i in idx],
                         ref_s)
    per_param = {"max_rel_to_change": 0.0, "max_ulps": 0, "outside": 0}
    for i, w0, w, s in zip(idx, before, ref_w, ref_s):
        pairs = [(group.param_arrays[i].data, w.data, w0)] + [
            (a, c, torch.zeros_like(c))
            for a, c in zip(primary._updater.states[i], s)]
        for got, want, start in pairs:
            change = float((want - start).abs().max())
            diff = (got - want).abs()
            per_param["max_rel_to_change"] = max(
                per_param["max_rel_to_change"],
                float(diff.max()) / max(change, 1e-30))
            per_param["max_ulps"] = max(per_param["max_ulps"],
                                        _ulps(torch, got, want))
            # an element may also sit one ulp from the other side's
            # (w near 1 rounds at 2^-23 when its change is 1e-3)
            per_param["outside"] += int(
                ((diff > TOL_ADAM_PER_PARAM * change)
                 & (_ulp_map(torch, got, want) > 1)).sum())
    del ref_w, ref_s, before
    if per_param["outside"]:
        raise AssertionError("the first LSTM update against the "
                             "per-parameter update: %s" % per_param)

    # the same step's forward and backward on the CPU
    sym, data_names, label_names = sym_gen(batch.bucket_key)
    cmod = Module(sym, data_names, label_names, context=cpu())
    cmod.bind(data_shapes=batch.provide_data,
              label_shapes=batch.provide_label)
    cmod.init_params(arg_params=args, aux_params=aux)
    cmod.forward(batch, is_train=True)
    cmod.backward()
    cgroup = cmod._exec_group
    errs = {"outputs": _rel_err(out.cpu(), cmod.get_outputs()[0].data)}
    for n, g in zip(cgroup.param_names, cgroup.grad_arrays):
        errs[n] = _rel_err(grads[n].cpu(), g.data)
    del cmod
    worst = max(errs, key=errs.get)
    if not errs[worst] <= TOL_LSTM_CPU:
        raise AssertionError("the first LSTM step, card against CPU: %s "
                             "off by %.3g > %g" % (worst, errs[worst],
                                                   TOL_LSTM_CPU))
    return {"bucket": batch.bucket_key, "b1_vs_plain": b1,
            "vs_per_param_update": per_param,
            "vs_cpu": {"max_rel_err": errs[worst], "tensor": worst,
                       "tol": TOL_LSTM_CPU}}


def _train_lstm(torch, dev, label, sym_gen, epochs, eager=False):
    """One configuration through BucketingModule.fit on the card: bind,
    Xavier weights and Adam (the calls fit makes), the first step under
    gates 2 and 3, then ``epochs`` epochs of fit — the compiled step, a
    captured program a bucket, or with ``eager`` every step under
    programs.eager(); ms per step by bucket in the last epoch (host
    clock between batch-end callbacks: with the async loop, the time to
    dispatch), tokens/s of the last epoch (tokens counted as the bench
    counts them), perplexity per epoch (accumulated on the card), B1
    launches against steps, the sharing and learning gates, peak memory,
    the device-side perplexity against the host metric over a few more
    batches, and a profiled repeat of them.  Returns the reading, the B1
    launches and the parameters after fit."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.ops import update_kernel as uk

    mode = programs.eager if eager else contextlib.nullcontext
    label = "%s %s" % (label, "eager" if eager else "captured")

    sentences = _lstm_sentences()
    tokens = sum(min(len(s), LSTM_BUCKETS[-1]) for s in sentences)
    it = mt.rnn.BucketSentenceIter(sentences, batch_size=LSTM_BATCH,
                                   buckets=LSTM_BUCKETS, seed=0)
    mod = mt.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=mt.gpu(0))
    torch.manual_seed(0)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mt.initializer.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": LSTM_LR})
    step = mod._primary._train_step
    if step is None or step.plan is None or step.plan.kind != "adam":
        raise AssertionError("%s: the train step armed no Adam slab plan"
                             % label)
    n_params = sum(int(np.prod(s.shape))
                   for s in step.plan.unpack_all(step._w).values())
    first = _lstm_first_step(torch, dev, mod, next(it), sym_gen)

    metric = mt.metric.Perplexity(ignore_label=-1)
    clock = {"last": None, "epoch_start": None}
    step_s, epoch_s, perplexity, steps = {}, [], [], [0]

    def batch_end(param):
        now = time.perf_counter()
        steps[0] += 1
        if param.epoch == epochs - 1 and param.nbatch > 0:
            key = param.locals["batch"].bucket_key
            step_s.setdefault(key, []).append(now - clock["last"])
        clock["last"] = now

    def epoch_end(epoch, *_):
        now = time.perf_counter()
        epoch_s.append(now - clock["epoch_start"])
        clock["epoch_start"] = now
        perplexity.append(metric.get()[1])

    uk.LAUNCHES["multi_tensor_update"] = 0
    uk.UPDATE_PATH["last"] = None
    graphs0 = dict(programs.GRAPH_STATS)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    clock["epoch_start"] = clock["last"] = time.perf_counter()
    with mode():
        mod.fit(it, eval_metric=metric, optimizer="adam",
                optimizer_params={"learning_rate": LSTM_LR},
                initializer=mt.initializer.Xavier(), num_epoch=epochs,
                batch_end_callback=batch_end, epoch_end_callback=epoch_end)
    torch.cuda.synchronize()
    graphs = _graph_delta(graphs0)
    launches = uk.LAUNCHES["multi_tensor_update"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    path = uk.UPDATE_PATH["last"]
    trained = {n: v.clone() for n, v in step.plan.unpack_all(step._w).items()}
    want_graphs = (0, 0) if eager else (len(LSTM_BUCKETS),
                                        steps[0] - len(LSTM_BUCKETS))
    if (graphs["captures"], graphs["replays"]) != want_graphs \
            or step._metric_acc is None:
        raise AssertionError("%s: graph stats %s (want captures and replays "
                             "%s), metric on the card: %s"
                             % (label, graphs, want_graphs,
                                step._metric_acc is not None))
    log("train lstm %s launches: B1 %d, steps %d, path %s"
        % (label, launches, steps[0], path))
    if launches != steps[0] or path != "kernel":
        raise AssertionError("%s: kernel B1 launched %d times in %d steps "
                             "(path %s)" % (label, launches, steps[0], path))
    # gate 4: every bucket on the primary's train step and its slab views
    views = step.plan.unpack_all(step._w)
    grad_views = step.plan.unpack_all(step._g)
    unshared = [(key, name) for key, m in mod._buckets.items()
                for name, v in views.items()
                if m._train_step is not step
                or m._exec_group.exec_.arg_dict[name].data.data_ptr()
                != v.data_ptr()
                or m._exec_group.exec_.grad_dict[name].data.data_ptr()
                != grad_views[name].data_ptr()]
    if sorted(mod._buckets) != LSTM_BUCKETS or unshared:
        raise AssertionError("%s: buckets %s, parameters not on the shared "
                             "slab (or demoted): %s"
                             % (label, sorted(mod._buckets), unshared[:5]))
    if not (all(np.isfinite(perplexity))
            and (len(perplexity) < 2 or perplexity[-1] < perplexity[0])):
        raise AssertionError("%s: perplexity per epoch %s" % (label,
                                                              perplexity))

    batches = []
    it.reset()
    for b in it:
        if len(batches) < LSTM_PROFILE_BATCHES:
            batches.append(b)

    # the perplexity accumulated on the card against the host metric fed
    # the same steps' outputs
    on_card = mt.metric.Perplexity(ignore_label=-1)
    on_host = mt.metric.Perplexity(ignore_label=-1)
    mod._bind_metric(on_card)
    with mode():
        for b in batches:
            mod.forward_backward(b)
            mod.update_metric(on_card, b.label)
            on_host.update(b.label, mod.get_outputs())
    metric_gate = {"device": on_card.get()[1], "host": on_host.get()[1],
                   "tol": TOL_DEVICE_METRIC}
    metric_gate["rel_err"] = abs(metric_gate["device"] - metric_gate["host"]) \
        / abs(metric_gate["host"])
    if not metric_gate["rel_err"] <= TOL_DEVICE_METRIC:
        raise AssertionError("%s: the perplexity on the card against the "
                             "host metric: %s" % (label, metric_gate))

    def repeat():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with mode():
            for b in batches:
                mod.forward_backward(b)
                mod.update()
                mod.update_metric(on_card, b.label)
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    wall = repeat()
    profile = _profile(torch, repeat, groups=LSTM_KERNEL_GROUPS)
    busy = profile["device_busy_s"]
    kernels_busy = busy - profile["groups"][LSTM_HOST_COPIES]["device_ms"] \
        * 1e-3 if isinstance(busy, float) else busy
    reading = {
        "config": label, "epochs": epochs, "params": n_params,
        "buckets_bound": sorted(mod._buckets), "steps": steps[0],
        "graph_stats": graphs, "device_metric_vs_host": metric_gate,
        "b1_launches": launches, "first_step": first,
        "epoch_s": epoch_s, "perplexity_per_epoch": perplexity,
        "tokens_per_epoch": tokens,
        # epoch 0 also binds each bucket and, in configuration 2, plans
        # cuDNN's RNN at each bucket's length
        "tokens_per_s_last_epoch": tokens / epoch_s[-1],
        "step_ms_by_bucket_last_epoch": {
            str(k): {"steps": len(v), "mean_ms": 1e3 * sum(v) / len(v),
                     "min_ms": 1e3 * min(v)}
            for k, v in sorted(step_s.items())},
        "repeat": {"batches": [b.bucket_key for b in batches],
                   "wall_s": wall, "device_busy_s": busy,
                   "idle_share": 1.0 - busy / wall
                   if isinstance(busy, float) else busy,
                   "profiled_idle_share": profile.get("device_idle_share",
                                                      busy),
                   "kernels_busy_s": kernels_busy,
                   "kernels_idle_share": 1.0 - kernels_busy / wall
                   if isinstance(busy, float) else busy},
        "peak_memory_gb": peak_gb}
    log("train lstm %s: %s" % (label, json.dumps(reading)))
    log("train lstm %s profile: %s" % (label, json.dumps(profile)))
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    return reading, launches, trained


def phase_train_lstm(torch, dev):
    """The bucketed LSTM LM on the card: gate 1 (the fused RNN op against
    the unfused cells), then configuration 1 (the bench's LSTMCell
    stack, 2 epochs) and configuration 2 (the fused default of
    models.lstm_lm, 2 epochs) through BucketingModule.fit, every bucket
    on one Adam slab (kernel B1 once a step): each configuration
    compiled (a captured program a bucket) and under programs.eager()
    from the same start, the two runs' parameters bit for bit."""
    from mxnet_tpu_torch.models import lstm_lm

    rnn = _rnn_fused_vs_unfused(torch, dev)
    torch.cuda.empty_cache()
    sym_gen, _ = lstm_lm.sym_gen_factory(ignore_label=-1)
    out, launches = {"fused_vs_unfused": rnn}, {}
    for label, gen, epochs in (("bench", _bench_lstm_sym_gen(), LSTM_EPOCHS),
                               ("fused", sym_gen, LSTM_FUSED_EPOCHS)):
        runs = {}
        for eager in (False, True):
            runs[eager] = _train_lstm(torch, dev, label, gen, epochs,
                                      eager=eager)
        (captured, n, w_c), (eager_run, _, w_e) = runs[False], runs[True]
        unequal = sorted(k for k in w_e if not torch.equal(w_c[k], w_e[k]))
        gate = {"steps": captured["steps"], "tensors": len(w_e),
                "unequal": unequal,
                "tokens_per_s": {
                    "captured": captured["tokens_per_s_last_epoch"],
                    "eager": eager_run["tokens_per_s_last_epoch"]},
                "idle_share": {"captured": captured["repeat"]["idle_share"],
                               "eager": eager_run["repeat"]["idle_share"]},
                "peak_memory_gb": {"captured": captured["peak_memory_gb"],
                                   "eager": eager_run["peak_memory_gb"]}}
        log("train lstm %s captured vs eager: %s" % (label, json.dumps(gate)))
        if unequal:
            raise AssertionError("%s: the captured run's parameters differ "
                                 "from the eager run's: %s" % (label,
                                                               unequal))
        out[label] = {"captured": captured, "eager": eager_run,
                      "captured_vs_eager": gate}
        launches["train_lstm_" + label] = n
        del runs, w_c, w_e
    return out, launches


def _zoo_module(torch, dev, sym, cfg, args, aux, plain=False):
    """A Module of a zoo symbol on the card at ``cfg``'s batch, compute
    dtype and SGD-momentum settings (``opt``, RESNET_OPT by default), its
    Dropout masks from a generator seeded with ZOO_DROPOUT_SEED; the slab
    plan must arm."""
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch.io import DataDesc
    from mxnet_tpu_torch.module import Module

    b = cfg["batch"]
    kw = {"compute_dtype": cfg["compute_dtype"]} \
        if cfg["compute_dtype"] else {}
    mod = Module(sym, context=gpu(0), plain=plain, **kw)
    mod.bind(data_shapes=[DataDesc("data", (b,) + tuple(cfg["image"]))],
             label_shapes=[DataDesc("softmax_label", (b,))])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=cfg.get("opt", RESNET_OPT))
    gen = torch.Generator(device=dev)
    gen.manual_seed(ZOO_DROPOUT_SEED)
    mod._exec_group.exec_.generator = gen
    if mod._train_step is None or mod._train_step.plan is None:
        raise AssertionError("the zoo module's train step armed no slab "
                             "plan")
    return mod


def _loss_step(torch, dev, batch, y):
    """``step(mod)``: one training step of ``mod`` on ``batch`` (labels
    ``y``), returning the mean -log p(label) of its forward, on the
    card."""
    labels = torch.from_numpy(y).long().to(dev)[:, None]

    def step(mod):
        mod.forward_backward(batch)
        mod.update()
        p = mod.get_outputs()[0].data.float().gather(1, labels)
        return -torch.log(torch.clamp_min(p, 1e-30)).mean()

    return step


def _zoo_grads(mod):
    group = mod._exec_group
    return {n: a.data.clone() for n, a in zip(group.param_names,
                                               group.grad_arrays)}


@contextlib.contextmanager
def _cudnn_deterministic(torch):
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _fixed_gammas(sym):
    """The gamma parameters of the symbol's ``fix_gamma`` BatchNorms."""
    out = []
    for node in json.loads(sym.tojson())["nodes"]:
        attrs = node.get("attrs", node.get("param", {})) or {}
        if node["op"] == "BatchNorm" \
                and str(attrs.get("fix_gamma", "True")) == "True":
            out.append(node["name"] + "_gamma")
    return out


def _zoo_first_step(torch, dev, sym, cfg, args, aux, step, what):
    """The first step of a kernel module (unrecorded), with cuDNN's
    deterministic algorithms: B1 against its plain version on copies of
    the slabs, then against the per-parameter update on copies of the
    masters and momentum with the gradients the step packed (masters,
    momentum and the bf16 copy bit for bit); the gradients against a
    ``plain=True`` module's first step in the two tiers; fixed gammas:
    a zero gradient and the weight decay's move, bit for bit."""
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.ops import update_kernel as uk

    with _cudnn_deterministic(torch):
        kmod = _zoo_module(torch, dev, sym, cfg, args, aux)
        group = kmod._exec_group
        idx = sorted(kmod._updater.states)
        ref_w = [nd.NDArray(group.param_arrays[i].data.clone()) for i in idx]
        ref_m = [kmod._updater.states[i].clone() for i in idx]
        opt = cfg.get("opt", RESNET_OPT)
        ref_opt = opt_mod.create(
            "sgd", sym=sym, rescale_grad=1.0 / cfg["batch"],
            param_idx2name=dict(enumerate(group.param_names)), **opt)
        real, checked, b1_first = _b1_capture(torch, uk)
        uk.multi_tensor_update = checked
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with programs.eager():
                loss = step(kmod)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        finally:
            uk.multi_tensor_update = real
        if b1_first != {"launches": 1, "bitwise": True, "path": "kernel"}:
            raise AssertionError("%s's first update, kernel B1 vs plain on "
                                 "the same slabs: %s" % (what, b1_first))
        kgrads = _zoo_grads(kmod)
        ref_opt.update_multi(idx, ref_w, [group.grad_arrays[i] for i in idx],
                             ref_m)
        tstep = kmod._train_step
        sides = {"params": [(group.param_arrays[i].data, w.data)
                            for i, w in zip(idx, ref_w)],
                 "momentum": [(kmod._updater.states[i], m)
                              for i, m in zip(idx, ref_m)]}
        if cfg["compute_dtype"]:
            sides["bf16_copy"] = [(tstep._views[group.param_names[i]],
                                   w.data.to(torch.bfloat16))
                                  for i, w in zip(idx, ref_w)]
        parity = {}
        for label, pairs in sides.items():
            diff = [(a, c) for a, c in pairs if not torch.equal(a, c)]
            parity[label] = {"tensors": len(pairs), "unequal": len(diff),
                             "max_abs_diff": max(
                                 [float((a.float() - c.float()).abs().max())
                                  for a, c in diff] or [0.0])}
        log("%s plan vs per-parameter update: %s"
            % (what, json.dumps(parity)))
        if any(v["unequal"] for v in parity.values()):
            raise AssertionError("%s's first update, kernel B1 vs the "
                                 "per-parameter update: %s" % (what, parity))
        # fix_gamma: the gamma takes a zero gradient, and weight decay
        # alone moves it: w + (momentum * 0 - lr * (0 + wd * w)) in f32
        gammas = _fixed_gammas(sym)
        lr = torch.tensor(opt["learning_rate"], device=dev)
        wd = torch.tensor(opt["wd"], device=dev)
        fixed = {"gammas": len(gammas), "zero_grad": True,
                 "wd_move_bitwise": True}
        for n in gammas:
            w0 = torch.from_numpy(args[n]).to(dev)
            fixed["zero_grad"] &= not bool(kgrads[n].any())
            want = w0 + (opt["momentum"] * torch.zeros_like(w0)
                         - lr * (0.0 + wd * w0))
            fixed["wd_move_bitwise"] &= torch.equal(
                kmod._exec_group.exec_.arg_dict[n].data, want)
        if gammas and not (fixed["zero_grad"] and fixed["wd_move_bitwise"]):
            raise AssertionError("%s's fixed gammas: %s" % (what, fixed))
        pmod = _zoo_module(torch, dev, sym, cfg, args, aux, plain=True)
        with programs.eager():
            step(pmod)
        pgrads = _zoo_grads(pmod)
        bitwise = all(torch.equal(kgrads[n], pgrads[n]) for n in kgrads)
        tiers = _grad_tiers(torch, kgrads, pgrads, what,
                            direct=cfg["classifier"])
        del pmod, pgrads, kgrads, ref_w, ref_m, sides
    grads = {"tiers": tiers, "bitwise": bitwise, "cudnn_deterministic": True}
    log("%s gradients vs plain module: %s" % (what, json.dumps(grads)))
    return kmod, float(loss), warm_s, b1_first, parity, fixed, grads


def _zoo_capture_gate(torch, dev, sym, cfg, args, aux, batch, what):
    """ZOO_STEPS captured steps against the same steps under
    programs.eager() from the same start and the same Dropout masks
    (generators seeded alike), cuDNN deterministic: masters, moving
    statistics and momentum bit for bit."""
    from mxnet_tpu_torch import programs

    def run(mod, eager):
        with programs.eager() if eager else contextlib.nullcontext():
            for _ in range(ZOO_STEPS):
                mod.forward_backward(batch)
        torch.cuda.synchronize()

    def state(mod):
        snap = _snapshot(mod)
        snap.update({"momentum:%d" % i: s.clone()
                     for i, s in mod._updater.states.items()})
        return snap

    start = {n: torch.from_numpy(v).to(dev) for n, v in args.items()}
    start.update({"aux:" + n: torch.from_numpy(v).to(dev)
                  for n, v in aux.items()})
    with _cudnn_deterministic(torch):
        emod = _zoo_module(torch, dev, sym, cfg, args, aux)
        run(emod, eager=True)
        eager = state(emod)
        del emod
        cmod = _zoo_module(torch, dev, sym, cfg, args, aux)
        run(cmod, eager=False)
        got = state(cmod)
        del cmod
    start.update({k: torch.zeros_like(v) for k, v in got.items()
                  if k.startswith("momentum:")})
    gate = _run_diff(torch, got, eager, start, cfg["classifier"])
    gate.update(steps=ZOO_STEPS, batch=cfg["batch"],
                cudnn_deterministic=True)
    log("%s captured vs eager: %s" % (what, json.dumps(gate)))
    if not gate["bitwise"]:
        raise AssertionError("%s's captured steps against eager: %s"
                             % (what, gate))
    return gate


def _lrn_card_vs_cpu(torch, dev, args, x):
    """AlexNet's first LRN on the card against the CPU: its input is
    conv1 -> ReLU of the first 8 images of the batch under the starting
    weights; forward and input gradient (a random head gradient), max
    |card - cpu| over max |cpu| against TOL_LRN_CPU."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.registry import OpContext, get_op

    op = get_op("LRN")
    attrs = op.parse_attrs({"nsize": "5", "alpha": "0.0001",
                            "beta": "0.75", "knorm": "2"})
    with torch.no_grad():
        xin = F.relu(F.conv2d(
            torch.from_numpy(x[:8]).to(dev),
            torch.from_numpy(args["convolution0_weight"]).to(dev),
            torch.from_numpy(args["convolution0_bias"]).to(dev), stride=4))
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    dy = torch.randn(xin.shape, generator=gen, device=dev)
    out = {}
    runs = {}
    for where in ("card", "cpu"):
        leaf = (xin if where == "card" else xin.cpu()).clone()
        leaf.requires_grad_(True)
        (y,), _ = op.fcompute(attrs, [leaf], [], OpContext())
        (dx,) = torch.autograd.grad(y, leaf, dy.to(leaf.device))
        runs[where] = (y.detach().cpu(), dx.cpu())
    for i, part in enumerate(("out", "dx")):
        got, want = runs["card"][i], runs["cpu"][i]
        err = float((got - want).abs().max() / want.abs().max())
        out[part] = err
        if not err <= TOL_LRN_CPU:
            raise AssertionError("LRN %s on the card vs the CPU: %.3g > %g"
                                 % (part, err, TOL_LRN_CPU))
    out["shape"] = list(xin.shape)
    log("train alexnet LRN card vs cpu: " + json.dumps(out))
    return out


def phase_train_zoo(torch, dev, name):
    """A zoo model at full width through Module on the card (ZOO_TRAIN):
    the first step's gates (_zoo_first_step), the step program's set-up,
    ZOO_STEPS timed replays (one B1 launch each), profiled steps captured
    and eager, and the captured-vs-eager gate; AlexNet also holds LRN on
    the card against the CPU."""
    from mxnet_tpu_torch import NameManager, gpu, models, programs
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.ops import update_kernel as uk

    cfg = ZOO_TRAIN[name]
    b, image = cfg["batch"], tuple(cfg["image"])
    what = "train %s" % name.replace("_", "-")
    with NameManager():
        sym = getattr(models, "get_" + name)(num_classes=1000)
    args, aux, x, y = _resnet_values(sym, b, image)
    n_params = sum(v.size for v in args.values())
    log("%s model: batch=%d image=%s params=%d (%s), SGD %s"
        % (what, b, image, n_params, "f32 masters, bf16 compute"
           if cfg["compute_dtype"] else "f32", cfg["opt"]))
    batch = DataBatch([nd.array(x, ctx=gpu(0))], [nd.array(y, ctx=gpu(0))])
    step = _loss_step(torch, dev, batch, y)
    lrn = _lrn_card_vs_cpu(torch, dev, args, x) if name == "alexnet" \
        else None
    kmod, loss0, warm_s, b1_first, parity, fixed, grads = _zoo_first_step(
        torch, dev, sym, cfg, args, aux, step, what)
    plan = kmod._train_step.plan
    blocks = {bk: plan.rows(bk) // uk.BLOCK_ROWS for bk in plan.buckets}
    padding = {bk: 1.0 - sum(sg.size for sg in segs)
               / (plan.rows(bk) * uk.LANES)
               for bk, segs in plan.buckets.items()}
    losses = [loss0]
    torch.cuda.reset_peak_memory_stats()
    graphs0 = dict(programs.GRAPH_STATS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses.append(step(kmod))   # the step program's set-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    uk.LAUNCHES["multi_tensor_update"] = 0
    uk.UPDATE_PATH["last"] = None
    t0 = time.perf_counter()
    for _ in range(ZOO_STEPS):
        losses.append(step(kmod))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs = _graph_delta(graphs0)
    launches = {"multi_tensor_update": uk.LAUNCHES["multi_tensor_update"]}
    path = uk.UPDATE_PATH["last"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    log("%s launches: %s path: %s" % (what, launches, path))
    if graphs["captures"] != 1 or graphs["replays"] != ZOO_STEPS:
        raise AssertionError("%s: %s (want one capture, then a replay a "
                             "step)" % (what, graphs))
    if launches["multi_tensor_update"] != ZOO_STEPS or path != "kernel":
        raise AssertionError("%s did not launch kernel B1 once a step: %s "
                             "%s" % (what, launches, path))
    if not all(np.isfinite(losses)):
        raise AssertionError("%s losses %s" % (what, losses))
    _, aux_now = kmod.get_params()
    unmoved = [n for n, v in aux_now.items()
               if np.array_equal(v.asnumpy(), aux[n])]
    if unmoved:
        raise AssertionError("%s: moving statistics that did not move: %s"
                             % (what, unmoved))

    def one_step(eager=False):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with programs.eager() if eager else contextlib.nullcontext():
            step(kmod)
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    profile = _profile(torch, one_step, groups=ZOO_KERNEL_GROUPS)
    profile_eager = _profile(torch, lambda: one_step(eager=True),
                             groups=ZOO_KERNEL_GROUPS)
    eager_s = min(one_step(eager=True) for _ in range(ZOO_STEPS))
    del kmod
    gc.collect()
    torch.cuda.empty_cache()
    gate = _zoo_capture_gate(torch, dev, sym, cfg, args, aux, batch, what)
    gc.collect()
    torch.cuda.empty_cache()
    reading = {
        "config": {"model": name, "batch": b, "image": list(image),
                   "compute_dtype": cfg["compute_dtype"] or "float32",
                   "masters": "float32", "optimizer": "sgd",
                   "optimizer_params": cfg["opt"], "params": n_params,
                   "trainable_tensors": len(args), "update": "slab plan",
                   "source": "BASELINE.md:9-16 (train_imagenet.py "
                             "--benchmark 1)"},
        "slab_blocks": blocks, "slab_padding_share": padding,
        "steps": ZOO_STEPS, "step_s": wall / ZOO_STEPS,
        "warmup_step_s": warm_s, "setup_step_s": setup_s,
        "graph_stats": graphs, "eager_step_s": eager_s,
        "img_per_s": b * ZOO_STEPS / wall, "eager_img_per_s": b / eager_s,
        "idle_share": _idle_shares(profile, profile_eager,
                                   wall / ZOO_STEPS, eager_s),
        "losses": losses, "launches": launches, "update_path": path,
        "first_update_bitwise_vs_plain": b1_first["bitwise"],
        "plan_vs_per_param": parity, "fixed_gammas": fixed,
        "grads_vs_plain": grads, "moving_stats_moved": len(aux_now),
        "peak_memory_gb": peak_gb, "captured_vs_eager": gate}
    if lrn is not None:
        reading["lrn_card_vs_cpu"] = lrn
    log("%s: %s" % (what, json.dumps(reading)))
    log("%s profile: %s" % (what, json.dumps(profile)))
    log("%s profile eager: %s" % (what, json.dumps(profile_eager)))
    return reading, launches


def phase_zoo_steps(torch, dev):
    """VGG, GoogLeNet, Inception-BN and ResNeXt-50 at full width, one
    step each (batch ZOO_ONE_STEP_BATCH, f32): the first step's gates
    (_zoo_first_step), then the step program's set-up and one timed
    replay, a reading only."""
    from mxnet_tpu_torch import NameManager, gpu, models
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch

    out = {}
    for name, (kw, classifier, opt) in ZOO_ONE_STEP.items():
        cfg = {"batch": ZOO_ONE_STEP_BATCH, "image": ZOO_ONE_STEP_IMAGE,
               "compute_dtype": None, "classifier": classifier, "opt": opt}
        with NameManager():
            sym = getattr(models, "get_" + name)(num_classes=1000, **kw)
        args, aux, x, y = _resnet_values(sym, cfg["batch"], cfg["image"])
        batch = DataBatch([nd.array(x, ctx=gpu(0))],
                          [nd.array(y, ctx=gpu(0))])
        step = _loss_step(torch, dev, batch, y)
        what = "zoo step %s" % name
        kmod, loss0, _, b1_first, parity, fixed, grads = _zoo_first_step(
            torch, dev, sym, cfg, args, aux, step, what)
        step(kmod)   # the step program's set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(kmod))
        torch.cuda.synchronize()
        out[name] = {"params": sum(v.size for v in args.values()),
                     "batch": cfg["batch"], "optimizer_params": opt,
                     "step_s":
                     time.perf_counter() - t0, "losses": [loss0, loss],
                     "b1_bitwise_vs_plain": b1_first["bitwise"],
                     "plan_vs_per_param": parity, "grads_vs_plain": grads,
                     "fixed_gammas": fixed}
        if not np.isfinite([loss0, loss]).all():
            raise AssertionError("%s losses %s" % (what, [loss0, loss]))
        log("%s: %s" % (what, json.dumps(out[name])))
        del kmod, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_train_mnist(torch, dev):
    """The canonical MNIST drive through the port on the card: MNISTIter
    (synthetic, seeds 0 / 1), get_mlp then get_lenet, Module.fit for one
    epoch with SGD-momentum (one B1 launch a step), score against
    MNIST_MIN_ACC; then the MLP under AdaGrad and RMSProp (plain and
    centered) through the compiled step's per-parameter path, captured
    against eager bit for bit; then AdaDelta (eager only) on the card
    against the CPU."""
    from mxnet_tpu_torch import NameManager, cpu, gpu, initializer, models
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.io import DataDesc, MNISTIter
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ops import update_kernel as uk

    out = {}
    fit_launches = 0
    steps = 6000 // MNIST_BATCH
    for name in ("mlp", "lenet"):
        flat = name == "mlp"
        train = MNISTIter(batch_size=MNIST_BATCH, seed=0, flat=flat,
                          silent=True)
        val = MNISTIter(batch_size=MNIST_BATCH, seed=1, flat=flat,
                        silent=True)
        with NameManager():
            sym = getattr(models, "get_" + name)(num_classes=10)
        torch.manual_seed(0)
        mod = Module(sym, context=gpu(0))
        uk.LAUNCHES["multi_tensor_update"] = 0
        uk.UPDATE_PATH["last"] = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.fit(train, eval_data=val, initializer=initializer.Xavier(),
                optimizer="sgd", optimizer_params=MNIST_OPT, num_epoch=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        n = uk.LAUNCHES["multi_tensor_update"]
        path = uk.UPDATE_PATH["last"]
        armed = mod._train_step is not None \
            and mod._train_step.plan is not None
        acc = dict(mod.score(val, "acc"))["accuracy"]
        out[name] = {"fit_s": fit_s, "steps": steps, "b1_launches": n,
                     "update_path": path, "plan_armed": armed,
                     "accuracy": acc, "min_accuracy": MNIST_MIN_ACC,
                     "img_per_s": steps * MNIST_BATCH / fit_s}
        log("train mnist %s: %s" % (name, json.dumps(out[name])))
        if not armed or n != steps or path != "kernel":
            raise AssertionError("MNIST %s: plan %s, %d B1 launches for %d "
                                 "steps, path %s" % (name, armed, n, steps,
                                                     path))
        if not acc >= MNIST_MIN_ACC:
            raise AssertionError("MNIST %s accuracy %.4f < %g"
                                 % (name, acc, MNIST_MIN_ACC))
        fit_launches += n

    # the MLP under the per-parameter optimizers, from seeded weights
    with NameManager():
        sym = models.get_mlp(num_classes=10)
    it = MNISTIter(batch_size=MNIST_BATCH, seed=0, flat=True, silent=True)
    batches = [it.next() for _ in range(MNIST_OPT_STEPS)]
    shapes, _, _ = sym.infer_shape(data=(MNIST_BATCH, 784),
                                   softmax_label=(MNIST_BATCH,))
    rng = np.random.RandomState(0)
    params = {n: (rng.randn(*s) * np.sqrt(2.0 / s[1]) if len(s) > 1
                  else np.zeros(s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}

    def run(opt, kw, ctx, eager=False):
        mod = Module(sym, context=ctx)
        mod.bind(data_shapes=[DataDesc("data", (MNIST_BATCH, 784))],
                 label_shapes=[DataDesc("softmax_label", (MNIST_BATCH,))])
        mod.init_params(arg_params=params)
        mod.init_optimizer(optimizer=opt, optimizer_params=kw)
        with programs.eager() if eager else contextlib.nullcontext():
            for b in batches:
                mod.forward_backward(b)
                mod.update()
        return mod

    def values(mod):
        arg, _ = mod.get_params()
        vals = {n: v.data.float().cpu() for n, v in arg.items()}
        for i, st in mod._updater.states.items():
            for j, t in enumerate(st if isinstance(st, tuple) else (st,)):
                vals["state:%d:%d" % (i, j)] = t.float().cpu()
        return vals

    per_param = []
    for opt, kw in MNIST_PER_PARAM:
        graphs0 = dict(programs.GRAPH_STATS)
        cmod = run(opt, kw, gpu(0))
        graphs = _graph_delta(graphs0)
        path = uk.UPDATE_PATH["last"]
        no_plan = cmod._train_step is not None \
            and cmod._train_step.plan is None
        emod = run(opt, kw, gpu(0), eager=True)
        got, want = values(cmod), values(emod)
        unequal = [n for n in want if not torch.equal(got[n], want[n])]
        case = {"optimizer": opt, "params": kw, "steps": MNIST_OPT_STEPS,
                "update_path": path, "no_slab_plan": no_plan,
                "graph_stats": graphs, "tensors": len(want),
                "unequal": len(unequal), "first_unequal": unequal[:4]}
        log("train mnist per-parameter captured vs eager: "
            + json.dumps(case))
        if unequal or path != "per_param" or not no_plan \
                or graphs["captures"] != 1 \
                or graphs["replays"] != MNIST_OPT_STEPS - 1:
            raise AssertionError("MNIST %s captured vs eager: %s"
                                 % (opt, case))
        per_param.append(case)
        del cmod, emod
    kmod = run("adadelta", {"wd": 1e-4}, gpu(0))
    hmod = run("adadelta", {"wd": 1e-4}, cpu())
    got, want = values(kmod), values(hmod)
    err = max(float((got[n] - want[n]).abs().max()) for n in want)
    adadelta = {"steps": MNIST_OPT_STEPS, "eager": kmod._train_step is None,
                "max_abs_err": err, "tol": TOL_ADADELTA_CPU}
    log("train mnist adadelta card vs cpu: " + json.dumps(adadelta))
    if not adadelta["eager"] or not err <= TOL_ADADELTA_CPU:
        raise AssertionError("MNIST AdaDelta card vs cpu: %s" % adadelta)
    out["per_param"] = per_param
    out["adadelta_card_vs_cpu"] = adadelta
    return out, {"multi_tensor_update": fit_launches}


def _smi_line():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % smi.stderr)
    return smi.stdout.strip().splitlines()[0]


def _ssd_losses(torch, outs):
    """The two losses of the SSD objective a step trains, per image: the
    class cross-entropy over the anchors MultiBoxTarget did not ignore,
    and the smooth-L1 box loss, from the step's outputs (on its
    device)."""
    prob, loc_loss, cls_t = (o.data for o in outs[:3])
    keep = cls_t >= 0
    p = prob.gather(1, torch.clamp_min(cls_t, 0).long()[:, None])[:, 0]
    ce = torch.where(keep, -torch.log(torch.clamp_min(p, 1e-30)), 0.0)
    return torch.stack([ce.sum(), loc_loss.sum()]) / prob.shape[0]


def _ssd_targets(torch, sym, ctx, params, batch):
    """The graph's MultiBoxTarget outputs (box mask, class targets) at
    ``params`` on ``batch``, by an executor on ``ctx`` (numpy)."""
    from mxnet_tpu_torch import symbol as S

    internals = sym.get_internals()
    names = internals.list_outputs()
    pick = [next(n for n in names if n.endswith(suffix))
            for suffix in ("loc_mask", "cls_target")]
    tgt = S.Group([internals[n] for n in pick])
    exe = tgt.simple_bind(ctx, grad_req="null",
                          data=tuple(batch.data[0].shape),
                          label=tuple(batch.label[0].shape))
    for n, a in exe.arg_dict.items():
        a[:] = params[n] if n in params else \
            (batch.data[0] if n == "data" else batch.label[0])
    return [o.asnumpy() for o in exe.forward(is_train=True)]


def _multibox_ms(torch, dev, mod, batch):
    """Device ms of the graph's three MultiBox ops a step, each alone on
    the card at the path's shapes (their inputs taken from one forward
    of ``mod``); the ops are ordinary torch kernels, so the step's
    profile cannot tell them apart by name."""
    from mxnet_tpu_torch import symbol as S
    from mxnet_tpu_torch.registry import get_op, invoke

    internals = mod.symbol.get_internals()
    names = internals.list_outputs()
    want = {}
    for key, suffix in (("anchors", "multiboxprior0_output"),
                        ("cls_pred", "transpose1_output"),
                        ("loc_pred", "flatten0_output"),
                        ("cls_prob", "cls_prob_output")):
        want[key] = next(n for n in names if n.endswith(suffix))
    exe = S.Group([internals[want[k]] for k in
                   ("anchors", "cls_pred", "loc_pred", "cls_prob")]) \
        .simple_bind(mod._context, grad_req="null",
                     data=tuple(batch.data[0].shape),
                     label=tuple(batch.label[0].shape))
    arg, _ = mod.get_params()
    for n, a in exe.arg_dict.items():
        a[:] = arg[n] if n in arg else \
            (batch.data[0] if n == "data" else batch.label[0])
    anchors, cls_pred, loc_pred, cls_prob = \
        [o.data for o in exe.forward(is_train=True)]
    label = batch.label[0].data.to(dev)
    feat = torch.zeros((SSD_BATCH, 32, 8, 8), device=dev)
    calls = {
        "MultiBoxPrior": (get_op("MultiBoxPrior"), [feat],
                          {"sizes": (0.3, 0.6), "ratios": (1.0, 2.0, 0.5)}),
        "MultiBoxTarget": (get_op("MultiBoxTarget"),
                           [anchors, label, cls_pred], {}),
        "MultiBoxDetection": (get_op("MultiBoxDetection"),
                              [cls_prob, loc_pred, anchors], {})}
    return {name: _device_ms(torch, lambda op=op, xs=xs, at=at:
                             invoke(op, xs, at))
            for name, (op, xs, at) in calls.items()}


def phase_train_ssd(torch, dev):
    """The SSD example end to end on the card: its record file
    (``models.ssd.make_dataset``: 64 images of 32 x 32, seed 0, ".png"
    through OpenCV where it is installed, else the raw-array codec; the
    reading names which), ImageDetIter (batch 8, shuffle, mirror,
    seed 0), ``models.ssd.get_symbol()`` through Module on gpu(0) with
    Xavier (seeded) and Adam lr 2e-3, SSD_EPOCHS epochs of 8 captured
    steps, the example's loop (reset, forward_backward, update).  Gates:
    the first step against the port's CPU Module (class targets and box
    masks exactly, both losses within TOL_SSD_LOSS, gradients in two
    tiers); one B1 launch a step; the captured run against the same run
    under programs.eager() bit for bit (cuDNN deterministic); the loss
    of epoch 3 below that of epoch 1; detections of the trained model
    card vs CPU (kept rows' class ids and order exactly, scores and
    boxes within TOL_DET).  Readings: img/s and step ms captured and
    eager, idle share, peak memory, device ms by class."""
    from mxnet_tpu_torch import NameManager, cpu, gpu, initializer, models
    from mxnet_tpu_torch import image, programs
    from mxnet_tpu_torch.image import ImageDetIter
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ops import update_kernel as uk

    tmp = tempfile.mkdtemp(prefix="ssd_smoke_")
    prefix = os.path.join(tmp, "shapes")
    models.ssd.make_dataset(prefix, n=SSD_IMAGES)

    def iterator():
        return ImageDetIter(batch_size=SSD_BATCH, data_shape=(3, 32, 32),
                            path_imgrec=prefix + ".rec",
                            path_imgidx=prefix + ".idx", shuffle=True,
                            rand_mirror=True, label_name="label", seed=0)

    probe = iterator()
    first = probe.next()
    with NameManager():
        sym = models.ssd.get_symbol()
    torch.manual_seed(0)
    init = Module(sym, data_names=("data",), label_names=("label",),
                  context=cpu())
    init.bind(data_shapes=probe.provide_data,
              label_shapes=probe.provide_label, for_training=False)
    init.init_params(initializer.Xavier())
    start = {k: v.asnumpy() for k, v in init.get_params()[0].items()}

    def module(ctx):
        mod = Module(sym, data_names=("data",), label_names=("label",),
                     context=ctx)
        mod.bind(data_shapes=probe.provide_data,
                 label_shapes=probe.provide_label)
        mod.init_params(arg_params=start)
        mod.init_optimizer(optimizer="adam", optimizer_params=SSD_OPT)
        return mod

    out = {"images": SSD_IMAGES, "batch": SSD_BATCH, "epochs": SSD_EPOCHS,
           "anchors": 256,
           "image_codec": "cv2" if image._cv2() is not None else "raw"}
    with _cudnn_deterministic(torch):
        # the first step, card against the host
        kmod, hmod = module(gpu(0)), module(cpu())
        if kmod._train_step is None or kmod._train_step.plan is None:
            raise AssertionError("the SSD module armed no slab plan")
        steps = []
        for mod in (kmod, hmod):
            before = uk.LAUNCHES["multi_tensor_update"]
            mod.forward_backward(first)
            mod.update()
            outs = mod.get_outputs()
            steps.append(([o.asnumpy() for o in outs],
                          _ssd_losses(torch, outs).double().cpu().numpy(),
                          _zoo_grads(mod),
                          uk.LAUNCHES["multi_tensor_update"] - before))
        (k_outs, k_loss, k_grads, k_b1), (h_outs, h_loss, h_grads, h_b1) \
            = steps
        targets = [_ssd_targets(torch, sym, ctx, start, first)
                   for ctx in (gpu(0), cpu())]
        loss_err = [float(abs(k - h) / max(abs(h), 1e-30))
                    for k, h in zip(k_loss, h_loss)]
        first_gate = {
            "cls_target_equal": bool(np.array_equal(k_outs[2], h_outs[2])
                                     and np.array_equal(targets[0][1],
                                                        targets[1][1])),
            "loc_mask_equal": bool(np.array_equal(targets[0][0],
                                                  targets[1][0])),
            "matched_anchors": int(targets[1][0].sum() / 4),
            "losses": [float(v) for v in h_loss],
            "loss_rel_err": loss_err, "tol": TOL_SSD_LOSS,
            "b1_launches": [k_b1, h_b1],
            "grads": _grad_tiers(torch, k_grads,
                                 {n: g.to(dev) for n, g in h_grads.items()},
                                 "ssd first step", direct=SSD_DIRECT)}
        log("train ssd first step card vs cpu: " + json.dumps(first_gate))
        if not (first_gate["cls_target_equal"]
                and first_gate["loc_mask_equal"]
                and max(loss_err) <= TOL_SSD_LOSS and k_b1 == 1):
            raise AssertionError("SSD first step, card vs cpu: %s"
                                 % first_gate)
        del kmod, hmod, steps, k_grads, h_grads

        def train(eager):
            mod = module(gpu(0))
            it = iterator()
            losses, walls, nsteps = [], [], 0
            with programs.eager() if eager else contextlib.nullcontext():
                for _ in range(SSD_EPOCHS):
                    it.reset()
                    total = torch.zeros((), device=dev)
                    n = 0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for batch in it:
                        mod.forward_backward(batch)
                        mod.update()
                        total += _ssd_losses(torch, mod.get_outputs()).sum()
                        n += 1
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    losses.append(float(total) / n)
                    nsteps += n
            return mod, losses, walls, nsteps

        def values(mod):
            arg, _ = mod.get_params()
            vals = {n: v.data.clone() for n, v in arg.items()}
            for i, st in mod._updater.states.items():
                for j, t in enumerate(st if isinstance(st, tuple)
                                      else (st,)):
                    vals["state:%d:%d" % (i, j)] = t.clone()
            return vals

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        graphs0 = dict(programs.GRAPH_STATS)
        uk.LAUNCHES["multi_tensor_update"] = 0
        cmod, losses, walls, nsteps = train(eager=False)
        launched = uk.LAUNCHES["multi_tensor_update"]
        graphs = _graph_delta(graphs0)
        # the run's own peak, above what earlier phases left allocated
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        emod, e_losses, e_walls, _ = train(eager=True)
        got, want = values(cmod), values(emod)
        unequal = [n for n in want if not torch.equal(got[n], want[n])]
        capture = {"tensors": len(want), "unequal": len(unequal),
                   "first_unequal": unequal[:4],
                   "losses_equal": losses == e_losses}
        if unequal:
            # the rule of phase 6: within twice two eager runs' spread
            e2 = values(train(eager=True)[0])
            spread = max(float((want[n] - e2[n]).abs().max())
                         for n in want)
            diff = max(float((got[n] - want[n]).abs().max())
                       for n in want)
            capture.update(eager_spread=spread, max_abs_diff=diff)
        log("train ssd captured vs eager: " + json.dumps(capture))
        if unequal and not capture["max_abs_diff"] <= \
                2 * capture["eager_spread"]:
            raise AssertionError("SSD captured vs eager: %s" % capture)
        if launched != nsteps or not losses[-1] < losses[0]:
            raise AssertionError("SSD: %d B1 launches for %d steps, losses "
                                 "%s" % (launched, nsteps, losses))

        # the trained model's detections, card against the host
        trained = {k: v.asnumpy() for k, v in cmod.get_params()[0].items()}
        dets = []
        for ctx in (gpu(0), cpu()):
            mod = Module(sym, data_names=("data",), label_names=("label",),
                         context=ctx)
            mod.bind(data_shapes=probe.provide_data,
                     label_shapes=probe.provide_label, for_training=False)
            mod.init_params(arg_params=trained)
            mod.forward(first, is_train=False)
            dets.append(mod.get_outputs()[3].asnumpy())
        det, h_det = dets
        kept = h_det[..., 0] >= 0
        det_gate = {"kept_rows": int(kept.sum()),
                    "rows_equal": bool(np.array_equal(det[..., 0] >= 0,
                                                      kept)),
                    "class_ids_equal": bool(np.array_equal(
                        det[..., 0][kept], h_det[..., 0][kept])),
                    "max_rel_err": float(np.abs(det[kept][:, 1:]
                                                - h_det[kept][:, 1:]).max())
                    / max(1.0, float(np.abs(h_det[kept][:, 1:]).max()))
                    if kept.any() else 0.0, "tol": TOL_DET}
        log("train ssd detections card vs cpu: " + json.dumps(det_gate))
        if not (det_gate["kept_rows"] and det_gate["rows_equal"]
                and det_gate["class_ids_equal"]
                and det_gate["max_rel_err"] <= TOL_DET):
            raise AssertionError("SSD detections card vs cpu: %s"
                                 % det_gate)

        # readings: the last epochs' walls, a profiled epoch of each
        def epoch_run(mod, eager):
            def run():
                it = iterator()
                with programs.eager() if eager \
                        else contextlib.nullcontext():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for batch in it:
                        mod.forward_backward(batch)
                        mod.update()
                    torch.cuda.synchronize()
                return time.perf_counter() - t0
            return run

        epoch_s = epoch_run(cmod, False)()
        eager_epoch_s = epoch_run(emod, True)()
        profile = _profile(torch, epoch_run(cmod, False), SSD_KERNEL_GROUPS)
        profile_eager = _profile(torch, epoch_run(emod, True),
                                 SSD_KERNEL_GROUPS)
        multibox = _multibox_ms(torch, dev, cmod, first)
    steps_epoch = SSD_IMAGES // SSD_BATCH
    out.update(
        losses=losses, eager_losses=e_losses, b1_launches=launched,
        steps=nsteps, graph_stats=graphs, peak_memory_gb=peak,
        epoch_walls_s=walls, eager_epoch_walls_s=e_walls,
        step_ms={"captured": epoch_s / steps_epoch * 1e3,
                 "eager": eager_epoch_s / steps_epoch * 1e3},
        img_per_s={"captured": SSD_IMAGES / epoch_s,
                   "eager": SSD_IMAGES / eager_epoch_s},
        idle_share=_idle_shares(profile, profile_eager, epoch_s,
                                eager_epoch_s),
        device_ms_by_class={
            "captured_epoch": profile.get("groups"),
            "eager_epoch": profile_eager.get("groups"),
            "multibox_ops_a_step": multibox},
        first_step=first_gate, capture=capture, detections=det_gate)
    log("train ssd: " + json.dumps(out))
    log("train ssd profile: " + json.dumps(profile))
    shutil.rmtree(tmp, ignore_errors=True)
    return out, {"multi_tensor_update": launched}


def _det_labels(rng):
    """(DET_BATCH, DET_LABEL_ROWS, 5) ground truth: 1-8 real boxes an
    image (classes 0-19, sides 0.05-0.5), -1 padding."""
    out = np.full((DET_BATCH, DET_LABEL_ROWS, 5), -1.0, np.float32)
    for i in range(DET_BATCH):
        k = rng.randint(1, 9)
        wh = rng.uniform(0.05, 0.5, (k, 2))
        x0 = rng.uniform(0, 1, k) * (1 - wh[:, 0])
        y0 = rng.uniform(0, 1, k) * (1 - wh[:, 1])
        out[i, :k] = np.stack([rng.randint(0, DET_CLASSES - 1, k), x0, y0,
                               x0 + wh[:, 0], y0 + wh[:, 1]], axis=1)
    return out


def _det_compare(outs, h_outs, ints):
    """Card outputs against the host's: ``ints`` (output indices, or
    (index, column)) exactly, the rest within TOL_DET x max(1,
    max|cpu|)."""
    res = {"int_equal": True, "max_rel_err": 0.0}
    for i, (got, want) in enumerate(zip(outs, h_outs)):
        got, want = got.astype(np.float64), want.astype(np.float64)
        if i in ints:
            res["int_equal"] &= bool(np.array_equal(got, want))
            continue
        if (i, 0) in ints:
            res["int_equal"] &= bool(np.array_equal(got[..., 0],
                                                    want[..., 0]))
            got, want = got[..., 1:], want[..., 1:]
        err = float(np.abs(got - want).max()) / max(
            1.0, float(np.abs(want).max()))
        res["max_rel_err"] = max(res["max_rel_err"], err)
    res["ok"] = res["int_equal"] and res["max_rel_err"] <= TOL_DET
    return res


def phase_detection_ops(torch, dev):
    """MultiBoxPrior, MultiBoxTarget and MultiBoxDetection (full NMS and
    nms_topk) at SSD300 scale on the card against the port on the CPU
    (see DET_*), with ms a batch (CUDA events), device ms and peak
    memory; a ``detection:`` line with the card's name and power
    limit."""
    from mxnet_tpu_torch.registry import get_op, invoke

    def run(op, xs, attrs, device):
        return [o for o in invoke(get_op(op), [x.to(device) for x in xs],
                                  attrs)[0]]

    def timed(fn, iters=3):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def peak_gb(fn):
        """The call's own peak: above what was allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    cases = {}
    # MultiBoxPrior over the six maps, concatenated
    prior_calls = []
    for m, size, ratio, step in zip(DET_MAPS, DET_SIZES, DET_RATIOS,
                                    DET_STEPS):
        prior_calls.append(([torch.zeros((1, 1, m, m))],
                            {"sizes": size, "ratios": ratio,
                             "steps": (step / 300, step / 300)}))

    def priors(device):
        return torch.cat([run("MultiBoxPrior", xs, at, device)[0]
                          for xs, at in prior_calls], dim=1)

    anchors = priors(dev)
    h_anchors = priors(torch.device("cpu"))
    if anchors.shape != (1, DET_ANCHORS, 4):
        raise AssertionError("SSD300 priors: %s anchors, not %d"
                             % (tuple(anchors.shape), DET_ANCHORS))
    cases["MultiBoxPrior"] = (lambda: priors(dev), [anchors], [h_anchors],
                              ())
    rng = np.random.RandomState(0)
    labels = torch.from_numpy(_det_labels(rng))
    cls_pred = torch.from_numpy(rng.randn(DET_BATCH, DET_CLASSES,
                                          DET_ANCHORS).astype(np.float32))
    tattrs = {"overlap_threshold": 0.5, "negative_mining_ratio": 3.0,
              "negative_mining_thresh": 0.5}
    txs = [h_anchors, labels, cls_pred]
    cases["MultiBoxTarget"] = (
        lambda: run("MultiBoxTarget", txs, tattrs, dev),
        run("MultiBoxTarget", txs, tattrs, dev),
        run("MultiBoxTarget", txs, tattrs, torch.device("cpu")), (1, 2))
    # benchmarks/bench_detection.py:37-46's inputs
    rng = np.random.RandomState(0)
    logits = rng.randn(DET_BATCH, DET_CLASSES, DET_ANCHORS) \
        .astype(np.float32)
    logits[:, 0] += 3.0
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.randn(DET_BATCH, DET_ANCHORS * 4) * 0.1).astype(np.float32)
    centers = rng.rand(1, DET_ANCHORS, 4).astype(np.float32)
    bench_anchors = np.concatenate(
        [centers[..., :2] - 0.05 * centers[..., 2:],
         centers[..., :2] + 0.05 * centers[..., 2:]], axis=-1) \
        .astype(np.float32)
    dxs = [torch.from_numpy(prob), torch.from_numpy(loc),
           torch.from_numpy(bench_anchors)]
    for name, extra in (("MultiBoxDetection", {}),
                        ("MultiBoxDetection nms_topk",
                         {"nms_topk": DET_TOPK})):
        attrs = dict({"threshold": 0.01, "nms_threshold": 0.45}, **extra)
        cases[name] = (
            lambda attrs=attrs: run("MultiBoxDetection", dxs, attrs, dev),
            run("MultiBoxDetection", dxs, attrs, dev),
            run("MultiBoxDetection", dxs, attrs, torch.device("cpu")),
            ((0, 0),))
    line = {"card": _smi_line(), "anchors": DET_ANCHORS,
            "classes": DET_CLASSES, "batch": DET_BATCH, "ops": {}}
    bad = []
    for name, (fn, outs, h_outs, ints) in cases.items():
        gate = _det_compare([o.cpu().numpy() for o in outs],
                            [o.numpy() for o in h_outs], ints)
        reading = {"ms": timed(fn), "device_ms": _device_ms(torch, fn, 1),
                   "peak_memory_gb": peak_gb(fn), **gate}
        if name.startswith("MultiBoxDetection"):
            reading["kept"] = int((outs[0][..., 0] >= 0).sum())
        if name == "MultiBoxTarget":
            cls_t = outs[2]
            reading.update(positives=int((cls_t > 0).sum()),
                           negatives=int((cls_t == 0).sum()),
                           ignored=int((cls_t < 0).sum()))
        line["ops"][name] = reading
        if not gate["ok"]:
            bad.append(name)
    log("detection: " + json.dumps(line))
    if bad:
        raise AssertionError("detection ops card vs cpu: %s" % bad)
    return line


def _entry(name, source, replaces, launches, case):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
            "device_ms": case["device_ms"]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import mxnet_tpu_torch  # noqa: F401  (fails outside the repository)

    # the plain versions and yardsticks run in full f32, as stated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log("torch %s cuda %s device %s" % (torch.__version__, torch.version.cuda,
                                        torch.cuda.get_device_name(0)))
    log("tolerances: kernel A |y - plain| <= %s x max(1, max|y|), column "
        "statistics <= %s x max(1, column sum of |y| or y^2); kernel B "
        "|out - plain| <= %g; teacher-forced |log p_kernel - log p_plain| "
        "<= %g; greedy-token agreement >= %g; kernels C-F |out - plain| "
        "<= tol x max(1, max|plain|) with tol %g (f32), %g (f32 sums over "
        "M = 16384 rows: F's dW, dscale, dshift), %g (bf16); train "
        "gradients kernel vs plain ||dg|| / ||g|| <= %g before any ReLU "
        "mask, %g behind one"
        % (TOL_A, TOL_A_STATS, TOL_B, TOL_LOGP, MIN_GREEDY_AGREEMENT,
           TOL_F32, TOL_F32_LONG, TOL_BF16, TOL_TRAIN_GRAD,
           TOL_TRAIN_GRAD_RELU))
    t0 = time.perf_counter()
    phase_build()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    a_cases = phase_kernel_a(torch, dev, flush)
    b_cases = phase_kernel_b(torch, dev, flush)
    cde_cases = phase_kernels_cde(torch, dev, flush)
    f_cases = phase_kernel_f(torch, dev, flush)
    b1_cases = phase_kernel_b1(torch, dev, flush)
    del flush
    torch.cuda.empty_cache()
    serve, launches, base = phase_serve(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    _, spec_launches = phase_serve_spec(torch, dev, base)
    del base
    # a predictor and its programs reference each other (each program
    # holds a bound method): collect them, their buffers and their
    # graphs' memory pool before training
    gc.collect()
    torch.cuda.empty_cache()
    train, train_launches = phase_train(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # on a thread of its own: the phase's autograd marks end with it
    _, imp_launches = _on_own_thread(phase_train_imperative, torch, dev)
    phase_ops(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    _, predict_launches, out_grads_launches = phase_predict(torch, dev)
    phase_routing(torch, dev)
    torch.cuda.empty_cache()
    resnet, resnet_launches = phase_train_resnet(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    _, lstm_launches = phase_train_lstm(torch, dev)
    zoo_launches = {}
    for name in ZOO_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        _, launched = phase_train_zoo(torch, dev, name)
        zoo_launches["train_" + name] = launched["multi_tensor_update"]
    gc.collect()
    torch.cuda.empty_cache()
    _, mnist_launches = phase_train_mnist(torch, dev)
    zoo_launches["train_mnist"] = mnist_launches["multi_tensor_update"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_zoo_steps(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    _, ssd_launches = phase_train_ssd(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_detection_ops(torch, dev)

    # one line per kernel at its main serving shape: A at decode ffn1
    # (M=4, 1024->4096, f32), B at decode over int8 pages (tq=1, G=1);
    # A's and B's entries carry their cases at the verify window too
    a_main = next(c for c in a_cases if c["dtype"] == "float32"
                  and c["m"] == 4 and c["n"] == 4096)
    a_verify = [c for c in a_cases if c["m"] == VERIFY_M]
    b_main = next(c for c in b_cases if c["pool"] == "int8"
                  and c["head_dim"] == EMBED // HEADS
                  and c["group"] == 1 and c["tq"] == 1)
    b_verify = next(c for c in b_cases if c["tq"] == SPEC_K + 1)

    def brief(c, *keys):
        return {k: c[k] for k in keys + (
            "variant", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bound_share", "device_ms")}
    # C, D, E at (64, 2048, 128) f32 G=1; F at ffn1 (m=16384, 1024->4096)
    # f32: the training step's shapes
    cde_main = {name: next(c for c in cases if c["dtype"] == "float32"
                           and c["groups"] == 1)
                for name, cases in cde_cases.items()}
    f_main = next(c for c in f_cases if c["dtype"] == "float32"
                  and c["n"] == FFN)
    a_launch = launches["fused_fwd"] + spec_launches["fused_fwd"] \
        + train_launches["fused_fwd"] + predict_launches["fused_fwd"] \
        + imp_launches["fused_fwd"]
    kernels = [
        dict(_entry("fused_ln_linear_fwd",
                    "mxnet_tpu_torch/csrc/fused_fwd.cu",
                    "mxnet_tpu/ops/pallas_fused.py:118",
                    a_launch, a_main),
             shape="m=4 k=1024 n=4096 float32",
             variant=a_main["variant"],
             launches_by_path={"serve": launches["fused_fwd"],
                               "serve_spec": spec_launches["fused_fwd"],
                               "train": train_launches["fused_fwd"],
                               "predict": predict_launches["fused_fwd"],
                               "imperative": imp_launches["fused_fwd"]},
             verify_cases=[brief(c, "m", "k", "n") for c in a_verify],
             max_abs_err_all_cases=max(c["max_abs_err"] for c in a_cases)),
        dict(_entry("paged_flash_decode",
                    "mxnet_tpu_torch/csrc/paged_decode.cu",
                    "mxnet_tpu/ops/pallas_decode.py:169",
                    launches["paged_decode"] + spec_launches["paged_decode"],
                    b_main),
             shape="B=4 tq=1 H=4 hd=256 int8 pages lens=%s"
             % b_main["lens"],
             variant=b_main["variant"], splits=b_main["splits"],
             launches_by_path={"serve": launches["paged_decode"],
                               "serve_spec": spec_launches["paged_decode"]},
             verify_case=brief(b_verify, "tq", "lens", "splits", "rows",
                               "row_tiles"),
             max_abs_err_all_cases=max(c["max_abs_err"] for c in b_cases)),
        dict(_entry("paged_split_combine",
                    "mxnet_tpu_torch/csrc/paged_decode.cu",
                    "mxnet_tpu/ops/pallas_decode.py:354",
                    launches["paged_combine"]
                    + spec_launches["paged_combine"],
                    dict(b_main["combine"], library_ms=None,
                         device_ms=b_main["combine"]["device_ms"])),
             shape="B=4 tq=1 H=4 hd=256, %d splits (%d seen)"
             % (b_main["splits"], b_main["combine"]["splits_seen"]),
             launches_by_path={"serve": launches["paged_combine"],
                               "serve_spec": spec_launches["paged_combine"]},
             verify_case=b_verify["combine"],
             max_abs_err_all_cases=max(c["combine"]["max_abs_err"]
                                       for c in b_cases)),
    ]
    for name, counter, replaces in (
            ("C", "flash_fwd", "mxnet_tpu/ops/pallas_attention.py:129"),
            ("D", "flash_bwd_dq", "mxnet_tpu/ops/pallas_attention.py:300"),
            ("E", "flash_bwd_dkv",
             "mxnet_tpu/ops/pallas_attention.py:336 (and :381, G > 1)")):
        by_path = {"train": train_launches[counter],
                   "imperative": imp_launches[counter]}
        if counter == "flash_fwd":
            by_path["predict"] = predict_launches[counter]
        else:
            by_path["out_grads"] = out_grads_launches[counter]
        entry = dict(
            _entry("flash_attention_" + counter[6:],
                   "mxnet_tpu_torch/csrc/flash_attention.cu", replaces,
                   sum(by_path.values()), cde_main[name]),
            shape="bh=64 t=2048 hd=128 causal float32",
            launches_by_path=by_path,
            max_abs_err_all_cases=max(c["max_abs_err"]
                                      for c in cde_cases[name]))
        entry["variant"] = cde_main[name]["variant"]
        kernels.append(entry)
    kernels.append(dict(
        _entry("fused_ln_linear_bwd", "mxnet_tpu_torch/csrc/fused_bwd.cu",
               "mxnet_tpu/ops/pallas_fused.py:214",
               train_launches["fused_bwd"] + out_grads_launches["fused_bwd"]
               + imp_launches["fused_bwd"], f_main),
        shape="m=16384 k=1024 n=4096 float32",
        variant=f_main["variant"],
        launches_by_path={"train": train_launches["fused_bwd"],
                          "out_grads": out_grads_launches["fused_bwd"],
                          "imperative": imp_launches["fused_bwd"]},
        max_abs_err_all_cases=max(c["max_abs_err"] for c in f_cases)))
    # B1 at the ResNet-50 path's update: SGD-momentum over f32 masters
    # with the bf16 compute copy, no clip
    b1_main = next(c for c in b1_cases if c["net"] == "resnet50"
                   and c["kind"] == "sgd_momentum" and c["master"] == "float32"
                   and c["wc"] == "bfloat16" and c["clip"] < 0)
    b1_by_path = {"train_lm": train_launches["multi_tensor_update"],
                  "train_resnet": resnet_launches["multi_tensor_update"]}
    b1_by_path.update(lstm_launches)
    b1_by_path.update(zoo_launches)
    b1_by_path["train_ssd"] = ssd_launches["multi_tensor_update"]
    b1_lstm = next(c for c in b1_cases if c["net"] == "lstm")
    b1_ssd = next(c for c in b1_cases if c["net"] == "ssd")
    b1_zoo = {c["net"]: c for c in b1_cases if c["net"] in ZOO_TRAIN}
    kernels.append(dict(
        _entry("multi_tensor_update",
               "mxnet_tpu_torch/csrc/multi_tensor_update.cu",
               "mxnet_tpu/ops/pallas_update.py:346",
               sum(b1_by_path.values()), b1_main),
        shape="resnet-50 slab (157 tensors, %d blocks) sgd-momentum "
              "float32 masters + bfloat16 copy" % b1_main["blocks"],
        launches_by_path=b1_by_path,
        per_param_ms=b1_main["per_param_ms"],
        grad_pack_ms=b1_main["grad_pack_ms"],
        library=b1_main["library"],
        lstm_case={k: b1_lstm[k] for k in (
            "kind", "master", "blocks", "elements", "max_ulps",
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "device_ms")},
        ssd_case={k: b1_ssd[k] for k in (
            "kind", "master", "blocks", "elements", "max_ulps",
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "device_ms")},
        zoo_cases={net: {k: c[k] for k in (
            "kind", "master", "wc", "tensors", "blocks", "elements",
            "bitwise", "max_abs_err", "ms", "plain_ms", "library_ms",
            "per_param_ms", "grad_pack_ms", "bound_ms", "bound_by",
            "device_ms")} for net, c in b1_zoo.items()},
        max_abs_err_all_cases=max(c["max_abs_err"] for c in b1_cases),
        max_ulps_all_cases=max(c["max_ulps"] for c in b1_cases)))
    log("total wall: %.1f s" % (time.perf_counter() - t0))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
