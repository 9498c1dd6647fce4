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
   op cases, the 38 x 50 Proposal among them;
14. fleet — run right after phase 5b on phase 5's model and tokens:
   (a) phase 5's requests through ``DecodeServer``'s session one
   ``serve_tick`` at a time, phase 5's tokens; (b) preemption by page
   swap: a pool cut to the four longest requests' reservations plus
   FLEET_SWAP_SLACK pages (its size printed), those four submitted first
   at priority -1, MXNET_FLEET_DECODE_BOUND 4, MXNET_FLEET_SWAP on:
   swap-outs equal swap-ins, at least one; restored pages re-extracted
   and held byte for byte (``_verify_restore``); phase 5's tokens;
   extract and install captured once; a page's bytes and the CUDA-event
   and device ms of one swap-out and one swap-in of the largest record;
   (c) FLEET_HOSTS hosts x SLOTS slots and one prefill worker under
   ``cache_aware``, then ``round_robin``: 16 requests in 2 waves from
   two tenants, each with its own 256-token prefix and 128-768-token
   tails, MAX_NEW greedy tokens; the tokens of one host serving the same
   requests, pages migrated, one host per tenant, no program captured
   twice, every pool drained to 0 once the prefix caches are cleared;
   fleet tokens/s, TTFT p50 / p95 (``mx_fleet_ttft``) and the cache hit
   rates; (d) ``/metrics`` and ``/metrics.json`` scraped over HTTP, the
   trace exported with the serving programs' spans, the ``mfu_table``
   with the H100 spec peaks, three profiled captured decode steps with
   the same kernels and counts in PROFILE_REPEATS reads with
   MXNET_TELEMETRY on and as many off (one profiling session, opened by
   a long spin of the card and an uncounted step, each read between two
   marker spins; a session that lost a marker run once again, a second
   loss fails; a read in a session of its own printed beside), and
   phase 5's captured serve tokens/s with telemetry on beside off.
15. export — deployment export on ``torch.export``, kernels A, B and C
   being torch operators (``mxnet_tpu_torch::fused_fwd``,
   ``::paged_decode``, ``::flash_fwd``): (a) phase 6b's LM (the training
   configuration, 4 layers, f32, from its checkpoint) as a
   ``Predictor`` at batch 8 exported on the card, saved to a file (its
   size printed), loaded with ``load_exported`` and run: A 20 and C 4
   launches a forward from the loaded graph, within TOL_LOGP of the
   captured ``Predictor.forward`` on the same batch ("bitwise" printed),
   the export and load seconds, and the CUDA-event and device ms of one
   forward of each; (b) the same model exported from a ``cpu()``
   Predictor and loaded with the card as its device
   (``move_to_device_pass``): the same launches and gate; (c) phase 5's
   predictor's decode, verify and prefill-chunk artifacts and its decode
   program's ``ProgramSpec.artifact``: 5 ``fused_fwd`` and one
   ``paged_decode`` node a layer, none in a ``plain=True`` twin's
   decode artifact; (d)
   the deploy walkthrough (``examples/deploy_predictor.py``) on the
   card: ``Module.fit``, ``save_checkpoint``,
   ``Predictor.from_checkpoint``, export, ``load_exported``, the same
   classes as the Predictor.
16. moe — the mixture-of-experts op and LM (``ops/moe.py``, MOE_*
   below): (a) MoEFFN's op cases (dense top-1 and top-2, sparse at
   capacity factor 1.25 with 1 and 4 token groups, dropless) on the card
   against the CPU, the output and the six gradients with the balance
   loss at 0.3, the routing tables exactly, and each sparse case under
   MXNET_MOE_DISPATCH ``sort`` and ``onehot`` bit for bit; (b)
   ``benchmarks/bench_moe.py``'s chip configuration (1 layer, 8 experts,
   top-2, f32) trained through Module's captured step at capacity
   factor 1.25 and at 0 (the dense oracle): the first step's gradients
   against a ``plain=True`` module's, A / F 3, C / D / E 1 and B1 1
   launches a step, ``MOE_PATH`` / ``MOE_DISPATCH``, the captured steps
   against eager ones within CAPTURE_SPREAD of two eager runs' spread,
   the loss falling, tokens/s of both and their ratio, MoEFFN's share of
   a profiled step's device time and the step's roofline row; (c) phase
   5's model with 8 experts, top-2, capacity factor 1.25, serving phase
   5's requests through the paged int8 ``DecodeServer`` programs
   captured by ``prepare_programs``: the same tokens and launches under
   ``programs.eager()``, the plain versions' greedy tokens, teacher-forced
   probabilities within TOL_LOGP where no routing flip reached, every
   flip a near tie (TOL_FLIP_GAP) and counted, tokens/s and the launches
   of A, B and the combine; and, not gated, the same model with its
   LayerNorm gammas at 1 teacher-forced over int8 and over f32 pages.
17. resume — ``Module.fit(..., elastic=ElasticController(...))`` over
   RESUME_BATCHES seeded batches, RESUME_EPOCHS epochs, fence checkpoints
   every RESUME_PERIOD steps (``elastic.Checkpointer``: clones on the
   card, a writer thread copying them to pinned host buffers on a side
   stream and writing a ``torch.distributed.checkpoint`` step
   directory): (a) phase 6's LM with Adam, two uninterrupted runs
   (asynchronous and synchronous writes: the stall of each, the write
   ms, the snapshot's bytes, the peak memory), a run killed at
   RESUME_KILL (``FaultInjector``) and one resumed from the fence at
   RESUME_FENCE (epoch 1, 2 batches in): every parameter within
   RESUME_SPREAD times the two uninterrupted runs' spread, the metric
   across the kill bit for bit (after its first step the resumed run's
   perplexity sums and counts are the killed run's after that step) and
   the last epoch's count the uninterrupted run's, steps overlapping a
   write, A / F 20, C / D / E 4 and B1 1 launches a step; (b) AlexNet at phase 9's configuration with cuDNN's
   deterministic algorithms, killed and resumed: parameters, momentum
   and the accuracy line bit for bit; (c) ``checkpoint.save_sharded`` /
   ``load_sharded`` of (a)'s trained module: a bit-for-bit round trip, an
   inference Module loaded from it whose ``predict`` equals the trained
   module's forward bit for bit (A and C), a torn step skipped by
   ``latest_step``.
18. tuning — kernel plans (``ops/tuning.py``) and user kernels
   (``rtc.py``), in a tuning cache of the phase's own (a temporary
   directory, deleted after; phases 1-17 run the hand-fixed plans from
   an empty, unarmed cache of the run's own): (a) MXNET_PALLAS_TUNE
   armed, every class of TUNE_CASES resolved, so swept: each candidate
   plan timed (CUDA events over a captured replay) and held against
   the kernel's plain version within the tolerance of the kernel's own
   phase; each class's candidates, the default's ms and the winner
   printed (``tuning (a)`` lines); (b) a cold process sharing only the
   cache directory resolves every class with 0 probes and the same
   params; (c) with the cache warm and the sweep unarmed, phase 5's
   serve against the same serve on the hand-fixed plans (greedy tokens
   equal, teacher-forced |d log p| <= TOL_LOGP, kernel A's and B's last
   plan the winners', tokens/s of both) and TUNE_LM_STEPS captured
   steps of phase 6's LM against two runs on the hand-fixed plans
   (launches A / F 20, C / D / E 4, B1 1 a step, finite losses, the
   parameters within CAPTURE_SPREAD of the two runs' spread, step s of
   each); (d) a user kernel built from a source string by
   ``rtc.build`` and registered by ``rtc.register_cuda_op``: bit for bit
   against its plain expression imperatively and through a bound
   symbol's gradient, an MLP with it inside trained through the
   captured Module step bit for bit against eager, the kernel found in
   a profiled replay, the build seconds.  Every line names the card and
   its power limit.
20. data parallel — (a) ``parallel.launch.init`` from DMLC_* variables
   (127.0.0.1, a free port) at a world of one on NCCL, then a
   ``dist_sync`` store's exact push / pull sums on CUDA tensors at
   three keys and shapes over three steps, and its updater on the sum
   (``tests/dist_worker.py``'s cases); (b) phase 6's LM trained through
   ``Module.fit(kvstore="dist_sync")`` on that group: the eager path
   (the executor's forward and backward, then push, the all-reduce, the
   store's SGD and pull, per parameter), one warm-up and DP_STEPS timed
   steps: step s, tokens/s, the share of the step spent in ``update``
   (host clock, synchronized), launches A / F 20, C / D / E 4 a step
   and B1 0, the parameters within CAPTURE_SPREAD times the spread of
   two eager ``kvstore="local"`` runs of the same steps (against the
   first of them); (c) ``context=[gpu(0), gpu(0)]`` with
   ``kvstore="device"``: one executor, the compiled step, B1 once a
   step, step s beside phase 6's captured step; (d) two ranks sharing
   the card over gloo (two processes of this script), each with its
   own half of a global batch, phase 6's LM cut to DP_RANK_LAYERS
   layer(s), DP_RANK_STEPS steps: the ranks' parameters equal bit for
   bit, within CAPTURE_SPREAD times the spread of two single-process
   runs over the concatenated global batch (the second with the halves
   swapped: the same sum in another order) of the first, the
   all-reduce's bytes and seconds a step, and
   ``tools/bandwidth_torch.py``'s rows for the two ranks.
21. tensor and model parallelism — (a) two ranks sharing the card over
   gloo (two processes of this script), ``Module(mesh_config=
   MeshConfig(data=1, model=2))`` through ``fit``: phase 6's LM cut to
   TP_LAYERS layer, TP_STEPS steps; each rank's launches a step (A / F
   5, C / D / E 1, at half the column N or the row K), collectives a step
   by kind with their bytes and seconds, step s and peak memory; the
   gathered parameters after every step within CAPTURE_SPREAD times the
   widest spread of single-process eager runs around the first (the
   same run again, F's atomics; the batch halves swapped, as phase 20
   (d); the plain versions); (b) ``examples/model_parallel_lstm.py``'s
   net at its widths built with the port's symbols, ``group2ctx`` with
   embed and decode on the card and the layers alternating host / card:
   forward and backward within 1e-5 of an all-card bind, the example's
   30 batches with a falling loss, the cross-device copies a step; (c)
   predict-f32's LM (TRAIN_LAYERS layers) exported and run in this
   process through the port's MXPred* C ABI with dev_type 2 (A 20 and C
   4 launches, TOL_LOGP of the Python Predictor), then its C++ client
   as a subprocess on the card: the argmax classes equal; (d)
   ``serving_avals`` at serve-int8-paged's configuration: no allocation
   across the call, and the programs ``prepare_programs`` captures take
   arguments of those shapes and dtypes.

22. the serving mesh and the pipeline — (a) two ranks sharing the card
   over gloo (two processes of this script), serve-int8-paged's model and
   requests through ``DecodePredictor(mesh=MeshConfig(data=1, model=2))``
   (eager programs, A at the shard widths, B on 2 of the 4 kv-heads):
   every rank's tokens equal to the single-rank captured serve's, A and B
   launches by program, collectives, tokens/s, TTFT, peak memory; kernel
   A held against its plain version at the shard widths (M 4 and 256),
   kernel B at 2 kv-heads; (b) two ranks, a
   ``PipelineModule`` of ``examples/pipeline_lm.py``'s blocks at
   train-f32's widths (2 stages, 4 microbatches, Adam), PIPE_STEPS
   ``fit`` steps: C / D / E 4 and B1 1 a step a rank, the hops' bytes
   and seconds, the step-1 loss within TOL_PIPE_LOSS, the gathered
   parameters and the step-1 gradients times ``rescale_grad`` within
   CAPTURE_SPREAD times the widest spread of single-process unrolled
   Modules (again, batch halves swapped, plain versions, microbatches
   summed in turn); C / D / E held against their plain versions at the
   stage shape.
23. the ring — two ranks sharing the card over gloo (two processes of
   this script): (a) ``parallel.ring.ring_attention`` under
   ``compat.shard_map`` over MeshConfig(seq=2) at
   ``benchmarks/bench_long_context.py``'s attention (B 2, T 8192, 16
   heads of 128, causal; a hop is (32, 4096, 128)), f32 and bf16 at G 1
   and 2 (8 kv-heads): forward and gradients against the single-process
   flash op on the whole sequence and against the same ring on the plain
   versions (TOL_F32 / TOL_BF16 x max(1, max |reference|)), the serial
   and double-buffered schedules bit for bit, C / D / E launched once
   each on rank 0 (its second hop skipped) and twice on rank 1, the
   bytes each rank sends (1 K and 1 V block forward; 1 K / V rotation
   and 2 f32 dK / dV rotations backward; half at G 2); (b) the bench's
   LM (T 8192, batch 2, embed 2048, 16 heads, vocab 8192, f32, its SGD)
   through ``Module(mesh_config=MeshConfig(seq=2))``, LC_STEPS ``fit``
   steps: C / D / E 1 (rank 0) or 2 (rank 1) and B1 1 a step, the
   step-1 parameters and outputs (row for row) within CAPTURE_SPREAD
   times the widest spread of single-process steps (again, the plain
   versions, the two sequences swapped), step s and tokens/s of each
   schedule, gloo seconds, peak memory a rank against the single
   process's; then C / D / E at the hop shape against their plain
   versions, timed beside SDPA.
24. expert parallelism — two ranks sharing the card over gloo (in phase
   22's processes, or alone ``--p24-rank``): (a) MoEFFN's sharded path
   (``ops.moe``: route, pack, ``collectives.all_to_all`` over the expert
   group, the rank's 4 experts, exchange back, combine) over
   MeshConfig(expert=2) at the MoE LM layer's shape (N 16384 tokens, d
   1024, 8 experts of hidden 4096, top-2, cf 1.25, f32) against the
   single-process ``_moe_forward_sparse(num_groups=2)`` on the card
   (outputs TOL_F32, the six gradients TOL_F32_LONG, x max(1, max
   |reference|)), the drop set read from each output identical (the
   router's inputs lie on an exact grid: no near ties), 2 exchanges a forward and 6 a step with their
   bytes and seconds, the experts' products timed, the dense oracle
   once; (b) phase 16 (b)'s MoE LM through ``Module(mesh_config=
   MeshConfig(expert=2))``, EP_FIT_STEPS ``fit`` steps: A / F 3, C / D /
   E 1, B1 1 and 6 exchanges a step a rank, MOE_PATH "sparse_a2a",
   falling losses, the step-1 parameters and outputs against the same
   mesh on the plain versions within CAPTURE_SPREAD times the widest
   spread of single-process steps (again, the plain versions), step s,
   tokens/s of the pair, peak memory a rank against the single
   process's; (c) phase 16 (c)'s MoE serve model and phase 5's requests
   over ``DecodePredictor(mesh=MeshConfig(expert=2))``: the same tokens
   on both ranks, A and B launches a rank, teacher-forced against the
   same mesh on the plain versions (|d log p| <= TOL_LOGP, flips only
   at near ties), tokens/s and TTFT a rank.
25. the expert x seq mesh and the elastic mesh — four rank processes of
   this script on the card over gloo (``--p25-rank``): (a) phase 16
   (b)'s MoE LM through ``Module(mesh_config=MeshConfig(seq=2,
   expert=2))``, ES_FIT_STEPS ``fit`` steps: A / F 3, C / D / E 1 (seq
   rank 0) or 2 (seq rank 1), B1 1 and 6 exchanges a step a rank, the
   rank's (8, 1024) block of the batch, falling losses, the step-1
   parameters and outputs against the same mesh on the plain versions
   within phase 24's bounds, step s, exchange s and peak memory a rank;
   (b) on ranks 0 and 1 (a group of 2 through a rendezvous file): the
   2-layer training LM over MeshConfig(data=2), an uninterrupted ``fit``
   of EL_EPOCHS epochs of EL_BATCHES steps, then the same ``fit`` under
   an ElasticController (sync fences every EL_PERIOD steps, one DCP
   directory over the group) with worker 1's stamp stale at EL_STALE
   (rank 0 alone on its captured step with B1, rank 1 standing by) and
   back at EL_BACK (regrown): recoveries 2 on both, every batch of each
   epoch once, A / F 10, C / D / E 2, B1 1 a step, the final parameters
   within CAPTURE_SPREAD times the single-process spread of the
   uninterrupted run's; then a ``fit`` in which rank 1 ``os._exit``s at
   EL_DEATH_STEP and rank 0 resumes alone: the seconds from the death to
   its first step alone on the re-formed mesh, the fence's bytes and
   write ms, the re-forms' parts.
26. fused BN (run with the kernel phases, after phase 4) — kernel B4
   (``ops/fused_bn.py``: BatchNorm-apply -> ReLU -> 1x1 convolution with
   the accumulator's column statistics, the reference's
   ``benchmarks/proto_fused.py`` and ``proto_sweep.py``) at ResNet-50's
   batch-256 stage shapes: the main path is ``fused_bn.bench_cases`` and
   ``fused_bn.sweep`` (the prototypes' ``main()``s), their launches
   counted; then (a) the five ``proto_fused`` cases (M 802,816 to
   12,544) against the plain version (TOL_B4, TOL_B4_STATS), timed beside
   it and ``library_chain`` (the prototype's ``maxerr`` / ``srel``
   against it, minimum GB and effective GB/s); (b) every tile variant at
   the three ``proto_sweep`` shapes, statistics off and on, against the
   plain version, with the sweep's two floors (a bf16 ``mm`` alone, the
   chain without statistics); (c) two launches of s1 c3 +r bit for bit.

The last lines are a ``kernels`` JSON object (each entry with its
phase 18 ``tuning`` reading: the class, the winner, its ms and the
default's), the card's name and power limit, and ``{"ok": true,
"device": {...}}``.  Imports nothing of JAX.
TF32 is off throughout (``allow_tf32`` False for matmuls and cuDNN), so
f32 products and convolutions are full f32.
"""
import contextlib
import gc
import json
import logging
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
# phase 14, the fleet: FLEET_HOSTS hosts of SLOTS slots and one prefill
# worker; FLEET_WAVES waves of FLEET_PER_TENANT requests from each of two
# tenants (a SHARED_PREFIX-token prefix of its own and a tail of
# FLEET_TAIL tokens), FLEET_WAVE_TICKS router ticks apart; the swap
# serve's pool holds the four longest requests' reservations plus
# FLEET_SWAP_SLACK pages; the fleet drained FLEET_REPEATS times under
# each policy, in turns; phase 5's serve timed TELEMETRY_REPEATS times
# with telemetry on and off each, in turns
FLEET_HOSTS, FLEET_WAVES, FLEET_PER_TENANT = 2, 2, 4
FLEET_TAIL, FLEET_WAVE_TICKS, FLEET_SWAP_SLACK = (128, 768), 8, 2
FLEET_REPEATS, TELEMETRY_REPEATS = 2, 2
# phase 16, mixture-of-experts: (a) the op cases at MOE_OP_SHAPE (N
# tokens, width d, E experts, hidden h), the aux term at MOE_OP_COEFF;
# (b) benchmarks/bench_moe.py:87-129's chip configuration (vocab 8192, T
# 2048, batch 8, embed 1024, 8 heads, FFN 4096, 8 experts, top-2, one
# layer, Xavier-gaussian, SGD-momentum 0.9) in f32 (bf16 compute casts
# token ids to bf16 in the reference), at capacity factor MOE_CF
# (sparse) and 0 (the dense oracle), the timed steps at TRAIN_LR and the
# bench's rate recorded; (c) phase 5's model with MOE_EXPERTS experts,
# top-MOE_TOP_K, capacity factor MOE_CF, serving phase 5's requests
MOE_OP_SHAPE, MOE_OP_COEFF = (512, 64, 8, 128), 0.3
MOE_OP_CASES = [("dense", 1, 1, False), ("dense", 2, 1, False),
                ("sparse", 2, 1, False), ("sparse", 2, 4, False),
                ("sparse", 2, 1, True)]
MOE_EXPERTS, MOE_TOP_K, MOE_CF = 8, 2, 1.25
MOE_SERVE = {"moe_experts": MOE_EXPERTS, "moe_top_k": MOE_TOP_K,
             "moe_capacity_factor": MOE_CF}
MOE_TRAIN_LAYERS, MOE_MOMENTUM = 1, 0.9
# a routing choice that differs between the kernel and the plain serve
# must be a near tie: the plain run's probabilities of the two experts
# within TOL_FLIP_GAP (the runs' router inputs differ by f32 rounding,
# about 1e-6 relative, which moves the probabilities by about 1e-7)
TOL_FLIP_GAP = 1e-5
# phase 14 (d)'s profiled decode steps: PROFILE_REPEATS reads with
# telemetry on and as many off in one profiling session that opens with
# a spin of the card of PROFILE_LEAD_CYCLES (100-200 ms at the H100's
# clocks), each read between two spins of PROFILE_MARK_CYCLES (see
# _step_kernel_reads)
PROFILE_REPEATS = 5
PROFILE_LEAD_CYCLES, PROFILE_MARK_CYCLES = 200_000_000, 2_000_000
# a session that lost marker spins (the profiler drops device records
# now and then, late in a long run: the first session of 4 in 8 full
# runs on the H100, and the second of 2 of those 4; and a session's last
# record, which a trailing spin now takes) is run again, up to
# PROFILE_SESSIONS sessions; a fault that keeps coming back still fails
# the run.  The reads of a session with every marker are gated, the lost
# sessions' spins are printed with their places
# (sessions_with_lost_markers)
PROFILE_SESSIONS = 4

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
# kernel B4: y within one bf16 ulp of the plain version's (an f32
# accumulator summed in another order rounds the other way), the column
# statistics of the accumulator within 1e-5 of the column's sum of |y| or
# y^2 (f32 sums over M = 802,816 rows in another order)
TOL_B4, TOL_B4_STATS = 2 ** -7, 1e-5
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
# phase 15, export: the predict configuration's LM (phase 6b) exported
# through torch.export, saved and loaded; EXPORT_CALLS forwards of the
# loaded program and of the captured Predictor timed each.  The
# walkthrough: examples/deploy_predictor.py's MLP and data (256 x 16,
# batch 32, Adam lr 5e-3, 5 epochs)
EXPORT_CALLS = 5
DEPLOY_N, DEPLOY_IN, DEPLOY_BATCH, DEPLOY_EPOCHS = 256, 16, 32, 5
# phase 17, resume: fit over RESUME_BATCHES seeded batches for
# RESUME_EPOCHS epochs with fence checkpoints every RESUME_PERIOD steps,
# killed at RESUME_KILL (the writer waited for at RESUME_FENCE, so that
# fence is written), resumed from RESUME_FENCE: epoch 1, 2 batches in.
# The LM (phase 6's configuration, Adam at RESUME_LM_LR, perplexity)
# within RESUME_SPREAD times the spread of two uninterrupted runs (F's
# atomicAdd rules out bit equality), its metric across the kill bit for
# bit; AlexNet (phase 9's configuration,
# SGD-momentum, Dropout from torch's default CUDA generator, accuracy,
# cuDNN's deterministic algorithms) bit for bit
RESUME_BATCHES, RESUME_EPOCHS, RESUME_PERIOD = 4, 2, 3
RESUME_KILL, RESUME_FENCE, RESUME_SEED = 7, 6, 5
RESUME_LM_LR = 1e-4
RESUME_SPREAD = 4.0
# phase 18, tuning: the shape classes of the main paths swept under
# MXNET_PALLAS_TUNE (label, space, dims, dtype).  A / F at the LM training
# step's three segments and the serve's 256-row chunks (f32), and a bf16
# class of the zoo (ResNet-50's stage-4 1x1 convolution at batch 256:
# 12,544 x 2048 -> 512; the zoo runs it on cuDNN, so this class is a
# reading for queue B's B4); B at the int8 serve's decode (tq 1), its
# verify window (tq 9) and its prefill chunk (tq 256) over 128-page
# views; C-E at the LM's attention; B1 at ResNet-50's slab and the LM's.
# Phase 18 (c) reruns the serve and three captured LM steps with the
# winners against the hand-fixed plans: greedy tokens equal,
# teacher-forced |d log p| within TOL_LOGP, the LM's parameters within
# CAPTURE_SPREAD times two untuned runs' spread
TUNE_CASES = [
    ("A+F LM q/k/v", "fused_kernel",
     {"m": TRAIN_BATCH * SEQ, "k": EMBED, "n": EMBED}, "float32"),
    ("A+F LM ffn1", "fused_kernel",
     {"m": TRAIN_BATCH * SEQ, "k": EMBED, "n": FFN}, "float32"),
    ("A+F LM ffn2", "fused_kernel",
     {"m": TRAIN_BATCH * SEQ, "k": FFN, "n": EMBED}, "float32"),
    ("A+F serve chunk q/k/v", "fused_kernel",
     {"m": CHUNK, "k": EMBED, "n": EMBED}, "float32"),
    ("A+F serve chunk ffn1", "fused_kernel",
     {"m": CHUNK, "k": EMBED, "n": FFN}, "float32"),
    ("A+F serve chunk ffn2", "fused_kernel",
     {"m": CHUNK, "k": FFN, "n": EMBED}, "float32"),
    ("A+F resnet50 1x1 bf16", "fused_kernel",
     {"m": 256 * 7 * 7, "k": 2048, "n": 512}, "bfloat16"),
    ("B serve decode", "decode_kernel",
     {"m": SEQ // PAGE_TOKENS, "tq": 1}, "any"),
    ("B serve verify", "decode_kernel",
     {"m": SEQ // PAGE_TOKENS, "tq": SPEC_K + 1}, "any"),
    ("B serve chunk", "decode_kernel",
     {"m": SEQ // PAGE_TOKENS, "tq": CHUNK}, "any"),
    ("C-E LM attention", "flash_kernel",
     {"t": SEQ, "d": EMBED // TRAIN_HEADS, "g": 1}, "float32"),
    ("B1 resnet50 slab", "update_kernel", None, "any"),
    ("B1 LM slab", "update_kernel", None, "any"),
]
TUNE_LM_STEPS = 3
# phase 18 (d), rtc: a user kernel from a source string, x * alpha + y
# rounded as the plain expression rounds it (a product, then a sum: no
# FMA), trained inside a small MLP (RTC_MLP: batch, inputs, hidden,
# classes) for TUNE_LM_STEPS captured steps against eager ones
RTC_SOURCE = r'''
#include <cuda_runtime.h>
__global__ void rtc_scale_add_kernel(const float* x, const float* y,
                                     float* o, float a, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = __fadd_rn(__fmul_rn(x[i], a), y[i]);
}
extern "C" int rtc_scale_add(const void* x, const void* y, void* o,
                             float a, int n, void* stream) {
  rtc_scale_add_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (float*)o, a, n);
  return (int)cudaGetLastError();
}
'''
RTC_MLP = (256, 512, 1024, 10)


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

    from mxnet_tpu_torch import cuda_build
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
                            cuda_build.sm_count(dev))
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


def _lm(torch, dev, unit_gammas=False, **moe_kw):
    """Phase 5's model (``moe_kw``: get_symbol's MoE options) with every
    weight drawn from normal(0, 0.02), the LayerNorm gammas set to 1 with
    ``unit_gammas``."""
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.weights import params_from_jax

    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=SEQ,
                                  num_layers=LAYERS, embed=EMBED,
                                  heads=HEADS, ffn_hidden=FFN, **moe_kw)
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = sym.infer_shape(data=(1, SEQ),
                                       softmax_label=(1, SEQ))
    params = {n: rng.normal(0, 0.02, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    if unit_gammas:
        params.update({n: np.ones_like(v) for n, v in params.items()
                       if n.endswith("_gamma")})
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


def _fleet_prompts():
    """The fleet traffic: FLEET_WAVES waves of FLEET_PER_TENANT requests
    from each of two tenants, each tenant's own SHARED_PREFIX-token
    prefix and a seeded tail of FLEET_TAIL tokens; (tenant, prompt)."""
    rng = np.random.RandomState(2)
    prefixes = [rng.randint(0, VOCAB, SHARED_PREFIX) for _ in range(2)]
    out = []
    for _ in range(FLEET_WAVES):
        for tenant in range(2):
            for _ in range(FLEET_PER_TENANT):
                tail = rng.randint(FLEET_TAIL[0], FLEET_TAIL[1] + 1)
                out.append((tenant, np.concatenate(
                    [prefixes[tenant], rng.randint(0, VOCAB, tail)])))
    return out


def _swap_pool_pages(prompts, longest):
    """A pool that holds the ``longest`` requests' admission reservations
    (a dry run of the page manager, their prefix hits included) and the
    scratch page, plus FLEET_SWAP_SLACK pages: the gate blocks with
    those four slots busy."""
    from mxnet_tpu_torch.serve import PagedKVManager

    mgr = PagedKVManager(SLOTS, SEQ, PAGE_TOKENS)
    for slot, i in enumerate(longest):
        p = np.asarray(prompts[i], np.int64)
        matched, pages, need = mgr.gate(p, p.size, MAX_NEW)
        mgr.map_slot(slot, pages, need)
        mgr.ensure(slot, matched, p.size)
        mgr.publish(slot, p, p.size)
    return mgr.pool_pages - mgr.allocator.available() + FLEET_SWAP_SLACK


def _telemetry(on):
    from mxnet_tpu_torch import config

    os.environ["MXNET_TELEMETRY"] = "1" if on else "0"
    config.refresh("MXNET_TELEMETRY")


def _launch_delta(before):
    now = _launch_counts()
    return {k: now[k] - before[k] for k in now}


def _event_ms(torch, fn, calls=5):
    """Median ms of ``fn`` by CUDA events around the call (its host
    work, copies and synchronizations included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _same_tokens(what, got, want):
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    if bad:
        raise AssertionError("%s: tokens differ for requests %s" % (what,
                                                                    bad))


def _fleet_session(torch, pred, prompts, base_results):
    """(a) phase 5's requests one serve_tick at a time."""
    from mxnet_tpu_torch.decode import DecodeServer

    srv = DecodeServer(pred, max_prefill=max(PROMPT_LENS), slots=SLOTS,
                       max_new_tokens=MAX_NEW)
    rids = [srv.submit(p) for p in prompts]
    srv.serve_reset()
    srv.serve_open()
    before = _launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, ticks = {}, 0
    while srv.has_work:
        srv.serve_tick()
        ticks += 1
        results.update(srv.serve_results())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_delta(before)
    _same_tokens("fleet (a) session vs phase 5",
                 {i: results[r] for i, r in enumerate(rids)}, base_results)
    if min(launches.values()) <= 0:
        raise AssertionError("the session ran no kernel A or B: %s"
                             % launches)
    tokens = sum(len(t) for t in results.values())
    reading = {"ticks": ticks, "steps": srv.steps, "chunks": srv.chunks,
               "tokens": tokens, "wall_s": wall,
               "tokens_per_s": tokens / wall, "launches": launches}
    log("fleet (a) session: " + json.dumps(reading))
    return reading, launches


def _fleet_swap(torch, sym, params, dev, prompts, base_results):
    """(b) preemption by page swap: a tight pool, the four longest
    requests at priority -1 submitted first."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.decode import DecodeServer, _cache_leaves

    longest = sorted(range(len(prompts)),
                     key=lambda i: -len(prompts[i]))[:SLOTS]
    order = longest + [i for i in range(len(prompts)) if i not in longest]
    pool = _swap_pool_pages(prompts, longest)
    pred = _predictor(sym, params, False, dev, pool_pages=pool)
    pred.prepare_programs(SLOTS, CHUNK)
    with config.overrides(MXNET_FLEET_DECODE_BOUND=4, MXNET_FLEET_SWAP=True):
        srv = DecodeServer(pred, max_prefill=max(PROMPT_LENS), slots=SLOTS,
                           max_new_tokens=MAX_NEW)
    srv._verify_restore = True
    records = []
    swap_out = srv._swap_out

    def spy(ps, slot):
        records.append(swap_out(ps, slot))
        return records[-1]

    srv._swap_out = spy
    index = {srv.submit(prompts[i], priority=-1 if i in longest else 0): i
             for i in order}
    before = _launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_delta(before)
    _same_tokens("fleet (b) swap vs phase 5",
                 {index[r]: t for r, t in res.items()}, base_results)
    tc = pred.trace_counts
    if not srv.swap_outs >= 1 or srv.swap_ins != srv.swap_outs:
        raise AssertionError("swap_outs %d, swap_ins %d"
                             % (srv.swap_outs, srv.swap_ins))
    if (tc["extract"], tc["install"], tc["decode"], tc["chunk"]) \
            != (1, 1, 1, 1) or tc["commit"] != 1 or tc["fork"] > 1:
        raise AssertionError("the swap serve captured a program again: %s"
                             % tc)
    if min(launches.values()) <= 0:
        raise AssertionError("the swap serve ran no kernel A or B: %s"
                             % launches)
    # one swap-out and one swap-in of the largest record, timed
    caches = srv._ps["state"].caches
    page_bytes = sum(t[0].numel() * t.element_size()
                     for t in _cache_leaves(caches))
    big = max(records, key=lambda r: r.n_pages)
    row = np.zeros(pred._manager.pages_per_slot, np.int64)
    row[:big.n_pages] = np.arange(1, big.n_pages + 1)
    data = pred.extract_pages(caches, row)

    def out():
        pred.extract_pages(caches, row)

    def back():
        pred.install_pages(caches, row, data)

    timing = {"out_event_ms": _event_ms(torch, out),
              "in_event_ms": _event_ms(torch, back),
              "out_device_ms": _device_ms(torch, out),
              "in_device_ms": _device_ms(torch, back)}
    if pred.trace_counts["extract"] != 1 \
            or pred.trace_counts["install"] != 1:
        raise AssertionError("timing the swap captured again: %s"
                             % pred.trace_counts)
    tokens = sum(len(t) for t in res.values())
    reading = {"pool_pages": pool, "page_bytes": page_bytes,
               "swap_outs": srv.swap_outs, "swap_ins": srv.swap_ins,
               "swapped_pages": [r.n_pages for r in records],
               "record_bytes": big.nbytes(), "record_pages": big.n_pages,
               "tokens": tokens, "wall_s": wall,
               "tokens_per_s": tokens / wall, "launches": launches,
               "trace_counts": tc, **timing}
    log("fleet (b) swap: " + json.dumps(reading))
    return reading, launches


def _host_seconds(obj, name, acc, key):
    """Wrap ``obj.name`` (an instance's method) to add its host seconds
    to ``acc[key]``; returns the undo."""
    fn = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0

    setattr(obj, name, timed)
    return lambda: delattr(obj, name)


def _fleet_drain(torch, router, fprompts, rids_out):
    """One timed drain of the fleet traffic through ``router`` (reset
    first); the waves are FLEET_WAVE_TICKS router ticks apart.  Returns
    the results, the wall, the launches and where the host's time went
    (seconds inside the worker's prefills, each host's serve_tick and
    the routing around the worker; router ticks)."""
    router.reset()
    split = {}
    undo = [_host_seconds(w, "prefill", split, "worker_prefill_s")
            for w in router.workers]
    undo += [_host_seconds(h.server, "serve_tick", split,
                           "%s_tick_s" % h.name) for h in router.hosts]
    undo.append(_host_seconds(router, "route", split, "route_s"))
    before = _launch_counts()
    steps = {h.name: (h.server.steps, h.server.chunks) for h in router.hosts}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_wave = len(fprompts) // FLEET_WAVES
    rids_out.clear()
    ticks = 0
    for wave in range(FLEET_WAVES):
        for _, p in fprompts[wave * per_wave:(wave + 1) * per_wave]:
            rids_out.append(router.submit(p, MAX_NEW))
        for _ in range(FLEET_WAVE_TICKS):
            router.tick()
            ticks += 1
    while router.has_work:
        router.tick()
        ticks += 1
    res = dict(router.results)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for u in undo:
        u()
    split["ticks"] = ticks
    for h in router.hosts:
        split["%s_steps_chunks" % h.name] = [
            h.server.steps - steps[h.name][0],
            h.server.chunks - steps[h.name][1]]
    return res, wall, _launch_delta(before), split


def _fleet_hosts(torch, sym, params, dev, fprompts, one_pred):
    """(c) the fleet against one host, cache_aware and round_robin."""
    from mxnet_tpu_torch.decode import DecodeServer
    from mxnet_tpu_torch.serve.fleet import FleetHost, PrefillWorker, Router

    one = DecodeServer(one_pred, max_prefill=max(PROMPT_LENS), slots=SLOTS,
                       max_new_tokens=MAX_NEW)
    for _, p in fprompts:
        one.submit(p)
    want = one.run()
    hosts = []
    for i in range(FLEET_HOSTS):
        pred = _predictor(sym, params, False, dev)
        pred.prepare_programs(SLOTS, CHUNK)
        hosts.append(FleetHost("h%d" % i, DecodeServer(
            pred, max_prefill=max(PROMPT_LENS), slots=SLOTS,
            max_new_tokens=MAX_NEW)))
    wpred = _predictor(sym, params, False, dev)
    wpred.prepare_programs(1, CHUNK)
    worker = PrefillWorker(wpred, "w0")
    preds = [h.server._pred for h in hosts] + [wpred]
    # a warm-up drain: the first page migration captures extract and
    # install
    warm = Router(hosts, [worker], policy="cache_aware")
    for tenant in range(2):
        warm.submit(next(p for t, p in fprompts if t == tenant)[:300],
                    MAX_NEW)
    warm.drain()
    readings, launches = {"cache_aware": [], "round_robin": []}, {}
    for policy in ("cache_aware", "round_robin") * FLEET_REPEATS:
        router = Router(hosts, [worker] if policy == "cache_aware" else [],
                        policy=policy)
        rids = []
        res, wall, launched, split = _fleet_drain(torch, router, fprompts,
                                                  rids)
        _same_tokens("fleet (c) %s vs one host" % policy,
                     {i: res[r] for i, r in enumerate(rids)}, want)
        stats = router.stats()
        tokens = sum(len(res[r]) for r in rids)
        hits = [h.server.stats().get("prefix_cache_hit_rate")
                for h in hosts]
        reading = {
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_s": stats.get("ttft_p50_s"),
            "ttft_p95_s": stats.get("ttft_p95_s"),
            "router_cache_hit_rate": stats["router_cache_hit_rate"],
            "host_prefix_cache_hit_rate": hits,
            "routed_by_host": stats["routed_by_host"],
            "migrated_pages_by_host": stats["migrated_pages_by_host"],
            "worker_prefills": stats["worker_prefills"],
            "host_split": split, "launches": launched}
        for k, v in launched.items():
            launches[k] = launches.get(k, 0) + v
        if min(launched.values()) <= 0:
            raise AssertionError("the %s fleet ran no kernel A or B: %s"
                                 % (policy, launched))
        if policy == "cache_aware":
            if not sum(stats["migrated_pages_by_host"].values()) > 0:
                raise AssertionError("no page migrated: %s" % stats)
            tenants = {}
            for (rid, host, _, _), (tenant, _) in zip(router.decisions,
                                                      fprompts):
                tenants.setdefault(tenant, set()).add(host)
            if any(len(h) != 1 for h in tenants.values()):
                raise AssertionError("a tenant spans hosts: %s" % tenants)
            reading["tenant_hosts"] = {
                str(t): sorted(h) for t, h in tenants.items()}
        readings[policy].append(reading)
        log("fleet (c) %s: %s" % (policy, json.dumps(reading)))
    # one profiled drain a policy: device busy time, the idle share of
    # the timed drains' walls, the kernels that take most of it
    for policy in ("cache_aware", "round_robin"):
        router = Router(hosts, [worker] if policy == "cache_aware" else [],
                        policy=policy)
        prof = _profile(torch, lambda: _fleet_drain(
            torch, router, fprompts, [])[1], groups=SERVE_KERNEL_GROUPS)
        busy = prof["device_busy_s"]
        walls = [r["wall_s"] for r in readings[policy]]
        prof["idle_share_of_timed"] = [1.0 - busy / w for w in walls] \
            if isinstance(busy, float) else busy
        prof["top"] = prof.get("top", [])[:6]
        readings[policy + "_profile"] = prof
        log("fleet (c) %s profile: %s" % (policy, json.dumps(prof)))
    for pred in preds:
        tc = pred.trace_counts
        if max(tc.values()) > 1:
            raise AssertionError("a fleet predictor captured a program "
                                 "twice: %s" % tc)
        mgr = pred._manager
        if mgr.prefix_cache is not None:
            mgr.prefix_cache.clear()
        if mgr.allocator.used_pages:
            raise AssertionError("a pool kept %d pages: %s"
                                 % (mgr.allocator.used_pages, mgr.stats()))
    return readings, launches, hosts


def _guard(torch, cycles=None):
    """A spin of the card (``torch.cuda._sleep``, PROFILE_MARK_CYCLES
    cycles unless given), waited for: a marker in the profiler's
    record."""
    torch.cuda._sleep(PROFILE_MARK_CYCLES if cycles is None else cycles)
    torch.cuda.synchronize()


def _decode_state(pred, prompts):
    """Phase 5's first SLOTS prompts prefilled and one decode step
    taken: the state the profiled steps start from."""
    batch = np.zeros((SLOTS, max(PROMPT_LENS[:SLOTS])), np.float32)
    for i in range(SLOTS):
        batch[i, :PROMPT_LENS[i]] = prompts[i]
    state, _ = pred.prefill(batch, np.asarray(PROMPT_LENS[:SLOTS]))
    state, _ = pred.step(state)
    return state


def _profiled_step_kernels(torch, pred, prompts, steps=3):
    """{kernel name: launches} of ``steps`` captured decode steps, in a
    torch.profiler session of their own (device activities only)."""
    from torch.profiler import ProfilerActivity, profile

    state = _decode_state(pred, prompts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = pred.step(state)
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if _kernel_us(e) > 0}


def _step_kernel_reads(torch, pred, prompts, repeats=PROFILE_REPEATS,
                       steps=3):
    """Phase 14 (d)'s kernel gate: ``repeats`` reads of ``steps``
    captured decode steps with telemetry on and as many off, in turns,
    all equal; returns (the kernels, a reading).

    A profiling session loses device records near its start: late in a
    long run the first replay of a graph loses its first kernels (the
    Embedding's id cast, compare, add and where: 773-775 of 777 in a
    session of its own, as ``_profiled_step_kernels`` counts), and now
    and then a session drops its first tens of milliseconds.  So the
    reads share one session that opens with a PROFILE_LEAD_CYCLES spin
    and one uncounted prefill and step (every program's first replay),
    and each read counts the device activities between two marker
    spins; a trailing spin closes the session (its last device record is
    often dropped too).  A session that lost a marker spin is run again,
    up to PROFILE_SESSIONS sessions.  One read in a session of its own is printed
    beside them (not gated), with the launches it lacks by name."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    order = (True, False) * repeats
    lost = []
    for _ in range(PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _guard(torch, PROFILE_LEAD_CYCLES)
            _decode_state(pred, prompts)
            torch.cuda.synchronize()
            for on in order:
                _telemetry(on)
                state = _decode_state(pred, prompts)
                torch.cuda.synchronize()
                _guard(torch)
                for _ in range(steps):
                    state, _ = pred.step(state)
                torch.cuda.synchronize()
                _guard(torch)
            # a session also drops its last device record (the last
            # marker, in most sessions of two full runs on the H100): a
            # trailing spin takes that place
            _guard(torch, PROFILE_LEAD_CYCLES)
        _telemetry(True)
        device = [e for e in prof.events()
                  if "CUDA" in str(getattr(e, "device_type", ""))]
        spins = sorted((e.time_range.start, e.time_range.end)
                       for e in device if "spin_kernel" in e.name)
        # the markers: the lead and trailing spins last 100 times longer
        shortest = min((b - a for a, b in spins), default=0)
        marks = [(a, b) for a, b in spins if b - a < 10 * shortest]
        if len(marks) >= 2 * len(order):
            break
        # where the session lost them: each recorded spin's start after
        # the session's first device record and its length, in ms
        t0 = min((e.time_range.start for e in device), default=0)
        lost.append({"spins": len(marks), "device_records": len(device),
                     "spins_ms": [[round((a - t0) / 1e3, 3),
                                   round((b - a) / 1e3, 3)]
                                  for a, b in spins]})
    else:
        raise AssertionError("the profiled decode steps: %s marker spins "
                             "recorded of %d in %d sessions"
                             % (json.dumps(lost), 2 * len(order),
                                PROFILE_SESSIONS))
    marks = marks[-2 * len(order):]
    reads = [dict(Counter(
        e.name for e in device if marks[2 * i][1] <= e.time_range.start
        and e.time_range.end <= marks[2 * i + 1][0]))
        for i in range(len(order))]
    kern = reads[0]
    for on, k in zip(order, reads):
        if k != kern or not k:
            raise AssertionError(
                "the decode steps' kernels differ between reads (telemetry "
                "%s): %s against %s" % (on, k, kern))
    bare = _profiled_step_kernels(torch, pred, prompts, steps)
    lacks = {n[:90]: kern[n] - bare.get(n, 0) for n in kern
             if bare.get(n, 0) != kern[n]}
    return kern, {"reads": [[on, sum(k.values())]
                            for on, k in zip(order, reads)],
                  "sessions_with_lost_markers": lost,
                  "own_session": sum(bare.values()),
                  "own_session_lacks": lacks}


def _kernel_brief(kernels):
    """A profiled kernel set as (names, launches, the longest names cut to
    90 characters with their counts)."""
    return {"names": len(kernels), "launches": sum(kernels.values()),
            "by_name": sorted((k[:90], n) for k, n in kernels.items())}


def _fleet_telemetry(torch, pred, prompts, base_results, hosts):
    """(d) the exporter, the trace, the roofline table, and the kernels
    and tokens/s with MXNET_TELEMETRY on and off."""
    import urllib.request

    from mxnet_tpu_torch import obs
    from mxnet_tpu_torch.test_utils import assert_chrome_trace

    ms = obs.MetricsServer(port=0).start()
    try:
        ms.add_json("mx_serve_summary:h0", hosts[0].server.serve_summary)
        base = "http://127.0.0.1:%d" % ms.port
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=30).read().decode()
        payload = json.loads(urllib.request.urlopen(
            base + "/metrics.json", timeout=30).read())
    finally:
        ms.stop()
    for want in ("mx_serve_steps", 'mx_fleet_ttft_count{host="h0"}',
                 "mx_request_ttft_seconds_count", "mx_fleet_migrated_pages"):
        if want not in text:
            raise AssertionError("/metrics lacks %s" % want)
    summ = payload.get("mx_serve_summary:h0") or {}
    if (summ.get("chains") or {}).get("page_tokens") != PAGE_TOKENS:
        raise AssertionError("/metrics.json lacks h0's chain summary: %s"
                             % summ)
    trace = obs.timeline.export()
    names = assert_chrome_trace(trace, ("paged_decode_step",
                                        "prefill_chunk", "page_extract",
                                        "page_install", "swap_out",
                                        "swap_in", "route"))
    rows = obs.mfu_table()
    peaks = {"bfloat16": obs.auto_peak("bfloat16"),
             "float32": obs.auto_peak("float32")}
    for line in obs.render_mfu_table(rows).splitlines():
        log("mfu table: " + line)
    f32_rows = obs.programs.table(peaks["float32"])
    # the same captured decode steps with telemetry on and off
    kern_on, window = _step_kernel_reads(torch, pred, prompts)
    # phase 5's captured serve, telemetry on / off / on / off
    rates = {"on": [], "off": []}
    for on in (True, False) * TELEMETRY_REPEATS:
        _telemetry(on)
        results, wall, _ = _serve(torch, pred, prompts)
        _same_tokens("serve with telemetry %s" % on, results, base_results)
        rates["on" if on else "off"].append(
            sum(len(t) for t in results.values()) / wall)
    _telemetry(True)
    reading = {"metrics_bytes": len(text), "metrics_json_keys": len(payload),
               "trace_events": len(trace["traceEvents"]),
               "trace_dropped": obs.timeline.dropped,
               "trace_names": len(names), "peaks": peaks,
               "mfu_rows": rows,
               "mfu_f32": {r["program"]: r["mfu"] for r in f32_rows},
               "decode_step_kernels": _kernel_brief(kern_on),
               "decode_step_reads": window,
               "serve_tokens_per_s": rates}
    log("fleet (d) telemetry: " + json.dumps(reading))
    return reading


def phase_fleet(torch, dev, base):
    """Phase 14: phase 5's model served (a) as a tick session, (b) with
    priorities and preemption by page swap, (c) as a fleet of hosts and
    a prefill worker, with (d) its telemetry exported."""
    from mxnet_tpu_torch import obs

    sym, params, base_results = base
    prompts = _prompts()
    obs.programs.reset()
    pred = _predictor(sym, params, False, dev)
    pred.prepare_programs(SLOTS, CHUNK)
    _serve(torch, pred, [p[:64] for p in prompts[:2]])
    session, session_launches = _fleet_session(torch, pred, prompts,
                                               base_results)
    gc.collect()
    swap, swap_launches = _fleet_swap(torch, sym, params, dev, prompts,
                                      base_results)
    gc.collect()
    fprompts = _fleet_prompts()
    fleet, fleet_launches, hosts = _fleet_hosts(torch, sym, params, dev,
                                                fprompts, pred)
    telemetry = _fleet_telemetry(torch, pred, prompts, base_results, hosts)
    reading = {"session": session, "swap": swap, "fleet": fleet,
               "telemetry": telemetry, "requests": len(fprompts)}
    log("fleet: " + json.dumps({k: reading[k] for k in ("session", "swap")}))
    return reading, {"session": session_launches, "swap": swap_launches,
                     "fleet": fleet_launches}


def _close_err(got, want, tol):
    """(max |got - want|, tol x max(1, max |want|))."""
    err = float((got.float() - want.float()).abs().max())
    return err, tol * max(1.0, float(want.float().abs().max()))


def _check_close(what, got, want, tol):
    """max |got - want|, failing beyond ``tol`` x max(1, max |want|)."""
    err, lim = _close_err(got, want, tol)
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

    def checked(kind, nslots, w, g, slots, wc, lrb, wdb, hyp, plain=False,
                block_rows=uk.BLOCK_ROWS):
        ref = [w.clone()] + [s.clone() for s in slots] \
            + ([wc.clone()] if wc is not None else [])
        path = real(kind, nslots, w, g, slots, wc, lrb, wdb, hyp,
                    plain=plain, block_rows=block_rows)
        uk.update_plain(kind, nslots, ref[0], g, ref[1:1 + nslots],
                        ref[-1] if wc is not None else None, lrb, wdb, hyp,
                        block_rows)
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


def _b4_hold(torch, what, got, want):
    """Kernel B4's outputs against its plain version's: y within TOL_B4 x
    max(1, |y|) element by element, the two column statistics within
    TOL_B4_STATS x max(1, the column's sum of |y| or y^2); returns
    (max |y - plain|, max |statistic - plain| / its limit)."""
    y = want[0].float()
    dy = (got[0].float() - y).abs()
    if not bool((dy <= TOL_B4 * y.abs().clamp_min(1.0)).all()):
        raise AssertionError("%s: y off its plain version by %.3g"
                             % (what, float(dy.max())))
    share = 0.0
    for i, lim in ((1, y.abs().sum(0)), (2, (y * y).sum(0))):
        if got[i].numel() == 0:
            continue
        rel = (got[i] - want[i]).abs() / (TOL_B4_STATS * lim.clamp_min(1.0))
        share = max(share, float(rel.max()))
        if not share <= 1.0:
            raise AssertionError("%s: column statistic %d off its plain "
                                 "version by %.3g of the limit"
                                 % (what, i, share))
    return float(dy.max()), share


def phase_fused_bn(torch, dev, flush):
    """Kernel B4 (``ops/fused_bn.py``, ``csrc/fused_bn_matmul.cu``) at
    ResNet-50's batch-256 stage shapes.  The main path: the two
    prototypes' ``main()`` counterparts, ``bench_cases`` and ``sweep``,
    each run with the launch count set to 0 just before it.  Then (a)
    every B4a case held against the plain version and timed beside it
    and ``library_chain``; (b) every tile variant at the sweep's shapes,
    statistics off and on, held against the plain version; (c) two
    launches of s1 c3 +r bit for bit."""
    from mxnet_tpu_torch.ops import fused_bn as fb

    launches = {}
    readings = {}
    for path, run in (("bench_cases", fb.bench_cases),
                      ("sweep", fb.sweep)):
        fb.LAUNCHES["fused_bn_matmul"] = 0
        readings[path] = run(dev)
        torch.cuda.synchronize()
        launches[path] = fb.LAUNCHES["fused_bn_matmul"]
    # one warm-up and 3 x ITERS timed calls a reading
    calls = 1 + 3 * fb.ITERS
    want = {"bench_cases": len(fb.CASES) * calls,
            "sweep": len(fb.SWEEP_CASES) * len(fb.VARIANTS) * 2 * calls}
    if launches != want:
        raise AssertionError("kernel B4 launches %s, expected %s"
                             % (launches, want))
    for row in readings["bench_cases"]:
        log("kernel B4 bench_cases: " + json.dumps(row))
    for row in readings["sweep"]:
        log("kernel B4 sweep: " + json.dumps(row))
    g = torch.Generator(device=dev)
    g.manual_seed(26)
    cases = []
    # (a) the five B4a cases
    for name, m, k, n, has_res in fb.CASES:
        args = fb.case_inputs(m, k, n, has_res, g, dev)
        got = fb.fused_bn_matmul(*args)
        variant = fb.LAST_VARIANT["fused_bn_matmul"]
        err, share = _b4_hold(torch, "kernel B4 " + name, got,
                              fb.fused_bn_matmul_plain(*args))
        lib = fb.library_chain(*args)
        maxerr = float((got[0].float() - lib[0].float()).abs().max())
        srel = float(((got[1] - lib[1]).abs() / (lib[1].abs() + 1)).max())
        del got, lib
        nbytes = 2 * (m * k + k * n + m * n + (m * n if has_res else 0))
        bound_ms, bound_by = _bound(nbytes, 2.0 * m * n * k, "bfloat16")
        case = _case(torch, flush, lambda: fb.fused_bn_matmul(*args),
                     lambda: fb.fused_bn_matmul_plain(*args),
                     lambda: fb.library_chain(*args),
                     {"case": name, "m": m, "k": k, "n": n,
                      "residual": has_res, "variant": variant,
                      "max_abs_err": err, "stats_limit_share": share,
                      "maxerr": maxerr, "srel": srel,
                      "bound_ms": bound_ms, "bound_by": bound_by})
        case["bound_share"] = _bound_share(case)
        # the prototype's count: x, y and W (the residual is not counted)
        case["min_gb"] = (m * k + m * n + k * n) * 2 / 1e9
        case["gbps"] = case["min_gb"] / case["ms"] * 1e3
        log("kernel B4 case: " + json.dumps(case))
        cases.append(case)
        if name == fb.CASES[1][0]:
            # (c) two launches of one case: bit for bit
            one = fb.fused_bn_matmul(*args)
            two = fb.fused_bn_matmul(*args)
            same = [bool(torch.equal(a, b)) for a, b in zip(one, two)]
            log("kernel B4 bitwise (%s, two launches): y %s, ysum %s, "
                "ysumsq %s" % ((name,) + tuple(same)))
            if not all(same):
                raise AssertionError("kernel B4 differs between two "
                                     "launches: %s" % same)
            del one, two
        del args
        torch.cuda.empty_cache()
    # (b) every variant at the sweep's shapes, statistics off and on
    sweeps = []
    for (name, m, k, n), timed in zip(fb.SWEEP_CASES, readings["sweep"]):
        x, s, b, w, _ = fb.case_inputs(m, k, n, False, g, dev)
        want = fb.fused_bn_matmul_plain(x, s, b, w)
        worst = (0.0, 0.0)
        for variant in fb.VARIANTS:
            for stats in (False, True):
                got = fb.fused_bn_matmul_op(x, s, b, w, None, True, stats,
                                            variant)
                held = _b4_hold(torch, "kernel B4 sweep %s %s stats=%d"
                                % (name, variant, stats), got, want)
                worst = tuple(max(p) for p in zip(worst, held))
                del got
        nbytes = 2 * (m * k + k * n + m * n)
        bound_ms, bound_by = _bound(nbytes, 2.0 * m * n * k, "bfloat16")
        case = _case(torch, flush, lambda: fb.fused(x, s, b, w),
                     lambda: fb.fused_bn_matmul_plain(x, s, b, w),
                     lambda: fb._chain_y(x, s, b, w),
                     {"case": name, "m": m, "k": k, "n": n,
                      "variant": fb._rule(n),
                      "max_abs_err": worst[0],
                      "stats_limit_share": worst[1],
                      "matmul_floor_ms": timed["matmul_ms"],
                      "chain_floor_ms": timed["chain_ms"],
                      "runs": timed["runs"],
                      "bound_ms": bound_ms, "bound_by": bound_by})
        case["bound_share"] = _bound_share(case)
        log("kernel B4 sweep case: " + json.dumps(case))
        sweeps.append(case)
        del x, s, b, w, want
        torch.cuda.empty_cache()
    return {"cases": cases, "sweep": sweeps, "launches": launches}


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


def _forward_reading(torch, fn, counters):
    """One forward of ``fn`` (already warm) with the kernels' launches it
    made, then its CUDA-event ms (median of EXPORT_CALLS) and device ms
    (mean of 3, profiled)."""
    for d, name in counters:
        d[name] = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {name: d[name] for d, name in counters}
    return out, {"launches": launches,
                 "event_ms": _event_ms(torch, fn, EXPORT_CALLS),
                 "device_ms": _device_ms(torch, fn)}


def _export_decode_artifacts(torch, dev):
    """Phase 15 (c): phase 5's predictor (the serve model, paged int8):
    the decode, verify (k = SPEC_K) and prefill-chunk artifacts and the
    decode program's ``ProgramSpec.artifact``, against the node counts
    the model implies (5 A nodes and one B node a layer); the decode
    artifact of its plain twin holds none."""
    from mxnet_tpu_torch.analysis import kernel_ops

    sym, params, _ = _lm(torch, dev)
    want = {"fused_fwd": 5 * LAYERS, "paged_decode": LAYERS}
    got, seconds = {}, {}
    for plain in (False, True):
        pred = _predictor(sym, params, plain, dev)
        state = pred.paged_batch_state(SLOTS)
        key = "plain" if plain else "kernel"
        t0 = time.perf_counter()
        arts = {"decode": pred.decode_artifact(state)}
        if not plain:
            arts["verify"] = pred.verify_artifact(state, SPEC_K)
            arts["prefill"] = pred.prefill_artifact(1, CHUNK)
            args = pred.serving_avals(SLOTS, CHUNK)["decode"]
            arts["spec_decode"] = pred._program_spec(
                "decode", args).artifact()
        seconds[key] = time.perf_counter() - t0
        got[key] = {k: kernel_ops(a) for k, a in arts.items()}
        del pred, state
    expect = {"kernel": {k: want for k in got["kernel"]},
              "plain": {"decode": {}}}
    gate = {"kernel_ops": got, "expected": expect,
            "artifacts_s": seconds}
    log("export decode artifacts: " + json.dumps(gate))
    if got != expect:
        raise AssertionError("decode artifacts' kernel nodes: %s (want %s)"
                             % (got, expect))
    return gate


def _export_walkthrough(torch, dev, tmp):
    """Phase 15 (d): examples/deploy_predictor.py on the card through the
    port: Module.fit, save_checkpoint, Predictor.from_checkpoint (and a
    tap on fc1), export, load_exported; the loaded program's classes
    must be the Predictor's."""
    from mxnet_tpu_torch import Predictor, gpu, sym
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.predictor import load_exported

    rng = np.random.RandomState(0)
    x = rng.normal(size=(DEPLOY_N, DEPLOY_IN)).astype(np.float32)
    half = DEPLOY_IN // 2
    y = (x[:, :half].sum(1) > x[:, half:].sum(1)).astype(np.float32)
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=32,
                             name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=2, name="fc2")
    net = sym.SoftmaxOutput(net, name="softmax")
    mod = Module(net, context=gpu(0))
    mod.fit(NDArrayIter(x, y, batch_size=DEPLOY_BATCH), optimizer="adam",
            optimizer_params={"learning_rate": 5e-3}, initializer=Xavier(),
            num_epoch=DEPLOY_EPOCHS)
    prefix = os.path.join(tmp, "clf")
    mod.save_checkpoint(prefix, DEPLOY_EPOCHS)
    shapes = {"data": (DEPLOY_BATCH, DEPLOY_IN)}
    pred = Predictor.from_checkpoint(prefix, DEPLOY_EPOCHS, shapes,
                                     ctx=gpu(0))
    probs = pred.forward(data=x[:DEPLOY_BATCH])[0].data.clone()
    taps = Predictor.from_checkpoint(prefix, DEPLOY_EPOCHS,
                                     {"data": (4, DEPLOY_IN)},
                                     output_names=["fc1"], ctx=gpu(0))
    tap_shape = tuple(taps.forward(data=x[:4])[0].shape)
    path = prefix + ".pt2"
    pred.export(path)
    out = load_exported(path)(x[:DEPLOY_BATCH])[0]
    torch.cuda.synchronize()
    gate = {"accuracy": float((probs.argmax(1).cpu().numpy()
                               == y[:DEPLOY_BATCH]).mean()),
            "fc1_tap_shape": tap_shape,
            "artifact_bytes": os.path.getsize(path),
            "same_classes": bool(torch.equal(out.argmax(1),
                                             probs.argmax(1))),
            "bitwise": bool(torch.equal(out, probs)),
            "max_abs": float((out - probs).abs().max()),
            "device": str(out.device)}
    log("export walkthrough: " + json.dumps(gate))
    if not (gate["same_classes"] and gate["max_abs"] <= TOL_F32
            and tap_shape == (4, 32) and out.device == dev):
        raise AssertionError("deploy walkthrough: %s" % gate)
    return gate


def phase_export(torch, dev):
    """Phase 15: deployment export through the port.  (a) phase 6b's LM
    Predictor, from its checkpoint, exported on the card (``torch.export``
    with kernels A and C as operators), saved, loaded with
    ``load_exported`` and run: A 20 and C 4 launches a forward, within
    TOL_LOGP of the captured ``Predictor.forward`` on the same batch,
    both timed; (b) the same model exported from a ``cpu()`` Predictor
    and loaded onto the card: the same kernels and gate; (c) the serve
    model's decode, verify and prefill artifacts; (d) the deploy
    walkthrough."""
    from mxnet_tpu_torch import Predictor, cpu, gpu, model
    from mxnet_tpu_torch.analysis import kernel_ops
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.ops import flash_kernel as fl
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.predictor import load_exported

    b, t = TRAIN_BATCH, SEQ
    lm = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=t,
                                 num_layers=TRAIN_LAYERS, embed=EMBED,
                                 heads=TRAIN_HEADS, ffn_hidden=FFN)
    params = _train_params(lm)
    x = np.random.RandomState(2).randint(0, VOCAB, (b, t)).astype(
        np.float32)
    label = np.zeros((b, t), np.float32)
    shapes = {"data": (b, t), "softmax_label": (b, t)}
    counters = ((fk.LAUNCHES, "fused_fwd"), (fl.LAUNCHES, "flash_fwd"))
    want = {"fused_fwd": 5 * TRAIN_LAYERS, "flash_fwd": TRAIN_LAYERS}
    want_ops = dict(want)
    xd = torch.from_numpy(x).to(dev)
    yd = torch.from_numpy(label).to(dev)
    reading = {}
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "lm")
        model.save_checkpoint(prefix, 0, lm, params, {})
        pred = Predictor.from_checkpoint(prefix, 0, shapes, ctx=gpu(0))
        pred.forward(data=xd)          # captures the inference forward
        ref, captured = _forward_reading(
            torch, lambda: pred.forward(data=xd)[0].data, counters)
        ref = ref.clone()

        # (a) exported on the card
        path = os.path.join(tmp, "lm.pt2")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.export(path)
        export_s = time.perf_counter() - t0
        ops = kernel_ops(pred.artifact())
        t0 = time.perf_counter()
        run = load_exported(path)
        load_s = time.perf_counter() - t0
        run(xd, yd)                     # first call: the kernels' set-up
        out, loaded = _forward_reading(torch, lambda: run(xd, yd)[0],
                                       counters)
        card = {"artifact_bytes": os.path.getsize(path),
                "export_s": export_s, "load_s": load_s, "kernel_ops": ops,
                "bitwise": bool(torch.equal(out, ref)),
                "max_abs_logp": _logp_gap(torch, out, ref),
                "max_abs_p": float((out - ref).abs().max()),
                "device": str(out.device), "loaded": loaded,
                "captured_predictor": captured}
        del out, run
        log("export (a) card: " + json.dumps(card))
        if not (ops == want_ops and loaded["launches"] == want
                and captured["launches"] == want
                and card["device"] == str(dev)
                and card["max_abs_logp"] <= TOL_LOGP):
            raise AssertionError("export on the card: %s (want kernel ops "
                                 "and launches %s)" % (card, want))

        # (b) exported from the host, loaded onto the card
        cpred = Predictor.from_checkpoint(prefix, 0, shapes, ctx=cpu())
        t0 = time.perf_counter()
        blob = cpred.export()
        cexport_s = time.perf_counter() - t0
        cops = kernel_ops(cpred.artifact())
        del cpred
        t0 = time.perf_counter()
        crun = load_exported(blob, device=gpu(0))
        cload_s = time.perf_counter() - t0
        crun(xd, yd)
        cout, cloaded = _forward_reading(torch, lambda: crun(xd, yd)[0],
                                         counters)
        host = {"artifact_bytes": len(blob), "export_s": cexport_s,
                "load_to_card_s": cload_s, "kernel_ops": cops,
                "bitwise": bool(torch.equal(cout, ref)),
                "max_abs_logp": _logp_gap(torch, cout, ref),
                "device": str(cout.device), "loaded": cloaded}
        del cout, crun, blob
        log("export (b) host to card: " + json.dumps(host))
        if not (cops == want_ops and cloaded["launches"] == want
                and host["device"] == str(dev)
                and host["max_abs_logp"] <= TOL_LOGP):
            raise AssertionError("export from the host, run on the card: "
                                 "%s" % host)
        del pred, ref
        gc.collect()
        torch.cuda.empty_cache()
        reading["predictor"] = {"card": card, "host_to_card": host}
        reading["decode_artifacts"] = _export_decode_artifacts(torch, dev)
        gc.collect()
        torch.cuda.empty_cache()
        reading["walkthrough"] = _export_walkthrough(torch, dev, tmp)
    launches = {name: card["loaded"]["launches"][name]
                + host["loaded"]["launches"][name]
                for name in ("fused_fwd", "flash_fwd")}
    log("export: " + json.dumps(reading))
    return reading, launches


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

    def checked(kind, nslots, w, g, slots, wc, lrb, wdb, hyp, plain=False,
                block_rows=uk.BLOCK_ROWS):
        ref = [w.clone()] + [t.clone() for t in slots]
        path = real(kind, nslots, w, g, slots, wc, lrb, wdb, hyp,
                    plain=plain, block_rows=block_rows)
        uk.update_plain(kind, nslots, ref[0], g, ref[1:], None, lrb, wdb,
                        hyp, block_rows)
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


# ---------------------------------------------------------------------------
# phase 16: mixture-of-experts
# ---------------------------------------------------------------------------
def _moe_op_inputs(torch, seed):
    """The op cases' seeded inputs (MOE_OP_SHAPE) as host tensors."""
    n, d, e, h = MOE_OP_SHAPE
    rng = np.random.RandomState(seed)
    arrays = [rng.normal(size=(n, d)), rng.normal(0, 0.5, (d, e)),
              rng.normal(0, 0.5, (e, d, h)) / np.sqrt(d),
              rng.normal(0, 0.1, (e, h)),
              rng.normal(0, 0.5, (e, h, d)) / np.sqrt(h),
              rng.normal(0, 0.1, (e, d))]
    dy = rng.normal(size=(n, d))
    return ([torch.from_numpy(a.astype(np.float32)) for a in arrays],
            torch.from_numpy(dy.astype(np.float32)))


def _moe_fwd(moe, path, k, groups, dropless):
    """The forward of one op case: the dense oracle or the sparse path at
    MOE_CF (``groups`` token groups, dropless or not)."""
    e = MOE_OP_SHAPE[2]
    if path == "dense":
        return lambda *a: moe._moe_forward(*a, e, num_experts_per_tok=k)
    return lambda *a: moe._moe_forward_sparse(
        *a, e, MOE_CF, num_experts_per_tok=k, num_groups=groups,
        dropless=dropless)


def _moe_run(torch, moe, dev, case, inputs, dy):
    """One op case on ``dev``: y, the six gradients of y + coeff * aux
    (MoEFn's backward, head gradient ``dy``) and the routing tables."""
    path, k, groups, dropless = case
    fwd = _moe_fwd(moe, path, k, groups, dropless)
    xs = [t.detach().to(dev).requires_grad_(True) for t in inputs]
    y = moe.MoEFn.apply(fwd, MOE_OP_COEFF, *xs)
    y.backward(dy.to(dev))
    with torch.no_grad():
        probs = torch.softmax(xs[0] @ xs[1], dim=-1)
        choice, _ = moe._route(probs, k)
        e, n = MOE_OP_SHAPE[2], MOE_OP_SHAPE[0]
        tables = [choice]
        if path == "sparse":
            ng = n // groups
            cap = moe._capacity(MOE_CF, k, ng, e, dropless)
            for g in range(groups):
                tables += list(moe._slot_assign(choice[g * ng:(g + 1) * ng],
                                                e, cap))
    return ([y.detach()] + [t.grad for t in xs],
            [t.detach() for t in tables])


def _moe_op_cases(torch, dev):
    """(a) MoEFFN on the card against the CPU, forward and six gradients,
    the routing tables exactly; under each MXNET_MOE_DISPATCH on the
    card, the sparse cases' tables, outputs and gradients bit for bit."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.ops import moe

    names = ["y", "d_data", "d_gate_weight", "d_expert1_weight",
             "d_expert1_bias", "d_expert2_weight", "d_expert2_bias"]
    rows = []
    for i, case in enumerate(MOE_OP_CASES):
        inputs, dy = _moe_op_inputs(torch, 40 + i)
        card, card_tables = _moe_run(torch, moe, dev, case, inputs, dy)
        host, host_tables = _moe_run(torch, moe, torch.device("cpu"), case,
                                     inputs, dy)
        errs = {nm: float((a.cpu() - b).abs().max())
                / max(1.0, float(b.abs().max()))
                for nm, a, b in zip(names, card, host)}
        tables_equal = all(torch.equal(a.cpu(), b)
                           for a, b in zip(card_tables, host_tables))
        row = {"case": "%s k=%d groups=%d%s" % (
                   case[0], case[1], case[2],
                   " dropless" if case[3] else ""),
               "tables_equal": tables_equal,
               "max_rel_err": max(errs.values()),
               "worst": max(errs, key=errs.get), "tol": TOL_OPS_CARD}
        if case[0] == "sparse":
            runs = {}
            for algo in ("sort", "onehot"):
                with config.overrides(MXNET_MOE_DISPATCH=algo):
                    runs[algo] = _moe_run(torch, moe, dev, case, inputs, dy)
                    if moe.MOE_DISPATCH["last"] != algo:
                        raise AssertionError("dispatch %s ran %s" % (
                            algo, moe.MOE_DISPATCH["last"]))
            row["sort_equals_onehot"] = all(
                torch.equal(a, b) for part in (0, 1)
                for a, b in zip(runs["sort"][part], runs["onehot"][part]))
            row["dropped_choices"] = int(sum(
                int((~keep).sum()) for keep in card_tables[2::3]))
        rows.append(row)
        if not tables_equal or not row["max_rel_err"] <= TOL_OPS_CARD \
                or row.get("sort_equals_onehot") is False:
            raise AssertionError("MoEFFN on the card against the CPU: %s"
                                 % row)
    return rows


# the MoE LM's parameters the backward reaches before any ReLU mask
_MOE_DIRECT = ("head_", "final_", "layer%d_moe_expert2_"
               % (MOE_TRAIN_LAYERS - 1))


def _train_moe(torch, dev, cf):
    """(b) one configuration of the MoE LM through Module on the card (see
    MOE_* above): returns (its reading, launches)."""
    from mxnet_tpu_torch import gpu, obs, programs
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ops import flash_kernel as fl
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.ops import moe
    from mxnet_tpu_torch.ops import update_kernel as uk

    b, t = TRAIN_BATCH, SEQ
    sym = attention_lm.get_symbol(
        vocab_size=VOCAB, seq_len=t, num_layers=MOE_TRAIN_LAYERS,
        embed=EMBED, heads=TRAIN_HEADS, ffn_hidden=FFN,
        moe_experts=MOE_EXPERTS, moe_capacity_factor=cf,
        moe_top_k=MOE_TOP_K)
    params = _train_params(sym)
    n_params = sum(v.size for v in params.values())
    rng = np.random.RandomState(1)
    x = rng.randint(0, VOCAB, size=(b, t)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((b, 1), np.float32)], axis=1)
    batch = DataBatch([nd.array(x)], [nd.array(y)])
    labels = torch.from_numpy(y.reshape(-1)).long().to(dev)[:, None]
    opt = {"momentum": MOE_MOMENTUM}

    def module(plain, lr=TRAIN_LR):
        mod = Module(sym, context=gpu(0), plain=plain)
        mod.bind(data_shapes=[DataDesc("data", (b, t), layout="NT")],
                 label_shapes=[DataDesc("softmax_label", (b, t),
                                        layout="NT")])
        mod.init_params(arg_params=params, aux_params={})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=dict(opt, learning_rate=lr))
        if mod._train_step is None or mod._train_step.plan is None:
            raise AssertionError("the MoE LM's train step armed no slab "
                                 "plan")
        return mod

    def grads(mod):
        group = mod._exec_group
        return {n: a.data.clone() for n, a in zip(group.param_names,
                                                   group.grad_arrays)}

    def loss(mod):
        p = mod.get_outputs()[0].data.gather(1, labels)
        return float(-torch.log(torch.clamp_min(p, 1e-30)).mean())

    start = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}
    kmod = module(False)
    moe.MOE_PATH["last"] = moe.MOE_DISPATCH["last"] = None
    with programs.eager():
        kmod.forward_backward(batch)
        kmod.update()
    losses = [loss(kmod)]
    first = grads(kmod)
    # the step program's set-up (a warm-up run and the capture), then the
    # timed replays with a fresh roofline row
    kmod.forward_backward(batch)
    kmod.update()
    losses.append(loss(kmod))
    counters = ((fk.LAUNCHES, "fused_fwd"), (fk.LAUNCHES, "fused_bwd"),
                (fl.LAUNCHES, "flash_fwd"), (fl.LAUNCHES, "flash_bwd_dq"),
                (fl.LAUNCHES, "flash_bwd_dkv"),
                (uk.LAUNCHES, "multi_tensor_update"))
    for d, name in counters:
        d[name] = 0
    obs.programs.reset(clear_static=True)
    graphs0 = dict(programs.GRAPH_STATS)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        kmod.forward_backward(batch)
        kmod.update()
        losses.append(loss(kmod))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    graphs = _graph_delta(graphs0)
    launches = {name: d[name] for d, name in counters}
    paths = {"moe": moe.MOE_PATH["last"],
             "dispatch": moe.MOE_DISPATCH["last"]}
    mfu = next((r for r in obs.mfu_table(obs.auto_peak("float32"))
                if r["program"] == "train_step"), None)
    captured = _snapshot(kmod)
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    want = {"fused_fwd": 3 * MOE_TRAIN_LAYERS,
            "fused_bwd": 3 * MOE_TRAIN_LAYERS,
            "flash_fwd": MOE_TRAIN_LAYERS, "flash_bwd_dq": MOE_TRAIN_LAYERS,
            "flash_bwd_dkv": MOE_TRAIN_LAYERS, "multi_tensor_update": 1}
    want_paths = {"moe": "sparse" if cf else "dense",
                  "dispatch": "sort" if cf else None}
    if graphs["captures"] != 0 or graphs["replays"] != TRAIN_STEPS \
            or per_step != want or paths != want_paths:
        raise AssertionError("the MoE LM's train step (cf %g): graphs %s, "
                             "launches a step %s (want %s), paths %s"
                             % (cf, graphs, per_step, want, paths))
    if mfu is None or not mfu.get("flops"):
        raise AssertionError("no train_step roofline row: %s" % mfu)

    # the first step's gradients against a plain module's
    pmod = module(True)
    with programs.eager():
        pmod.forward_backward(batch)
    plain = grads(pmod)
    del pmod
    grad_check = _grad_tiers(torch, first, plain, "train moe", _MOE_DIRECT)
    del first, plain
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("the MoE LM's loss did not fall: %s" % losses)
    bmod = module(False, lr=BENCH_LR)
    bench_losses = []
    for _ in range(1 + TRAIN_STEPS):
        bmod.forward_backward(batch)
        bmod.update()
        bench_losses.append(loss(bmod))
    del bmod
    gc.collect()
    torch.cuda.empty_cache()

    # the same 2 + TRAIN_STEPS steps under programs.eager(), twice
    def eager_run():
        mod = module(False)
        with programs.eager():
            for _ in range(2 + TRAIN_STEPS):
                mod.forward_backward(batch)
                mod.update()
        torch.cuda.synchronize()
        snap = _snapshot(mod)
        del mod
        gc.collect()
        torch.cuda.empty_cache()
        return snap

    eager1 = eager_run()
    eager2 = eager_run()
    vs_eager = _run_diff(torch, captured, eager1, start, _MOE_DIRECT)
    spread = _run_diff(torch, eager2, eager1, start, _MOE_DIRECT)
    del eager1, eager2, captured
    capture_gate = {"steps": 2 + TRAIN_STEPS, "captured_vs_eager": vs_eager,
                    "eager_vs_eager": spread,
                    "max_over_spread": CAPTURE_SPREAD}
    if any(vs_eager["tiers"][tr]["max"]
           > CAPTURE_SPREAD * max(spread["tiers"][tr]["max"], 1e-7)
           for tr in ("before_relu", "behind_relu")):
        raise AssertionError("the MoE LM's captured steps against eager "
                             "(cf %g), beyond the eager runs' own spread: "
                             "%s" % (cf, capture_gate))

    def one_step(eager=False):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with programs.eager() if eager else contextlib.nullcontext():
            kmod.forward_backward(batch)
            kmod.update()
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    profile = _profile(torch, one_step)
    share = _moe_share(torch, lambda: one_step(eager=True))
    del kmod
    gc.collect()
    torch.cuda.empty_cache()
    reading = {"config": {"vocab": VOCAB, "t": t, "batch": b,
                          "embed": EMBED, "heads": TRAIN_HEADS, "ffn": FFN,
                          "layers": MOE_TRAIN_LAYERS,
                          "experts": MOE_EXPERTS, "top_k": MOE_TOP_K,
                          "capacity_factor": cf, "dtype": "float32",
                          "optimizer": "sgd", "momentum": MOE_MOMENTUM,
                          "lr": TRAIN_LR, "params": n_params},
               "paths": paths, "steps": TRAIN_STEPS,
               "step_s": wall / TRAIN_STEPS,
               "tokens_per_s": b * t * TRAIN_STEPS / wall,
               "losses": losses, "bench_lr": BENCH_LR,
               "bench_lr_losses": bench_losses, "graph_stats": graphs,
               "launches_per_step": per_step, "grad_rel_err": grad_check,
               "captured_vs_eager": capture_gate,
               "moe_share_of_step": share, "mfu_row": mfu,
               "profile_device_busy_s": profile["device_busy_s"],
               "idle_share": (1.0 - profile["device_busy_s"]
                              / (wall / TRAIN_STEPS)
                              if isinstance(profile["device_busy_s"], float)
                              else profile["device_busy_s"]),
               "peak_memory_gb": peak_gb}
    log("train moe cf=%g: %s" % (cf, json.dumps(reading)))
    log("train moe cf=%g profile: %s" % (cf, json.dumps(profile)))
    return reading, launches


def _moe_share(torch, run):
    """The share of a step's device time that MoEFFN takes: one eager
    step (``run``) under torch.profiler with host activities, the device
    time of the kernels launched inside the op's autograd Function
    (``MoEFn``, its forward) and its backward (``MoEFnBackward``: the
    recompute and the gradients), over all kernels' device time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = prof.key_averages()
    busy = sum(_kernel_us(e) for e in rows)

    def device_us(e):
        us = getattr(e, "device_time_total", None)
        return us if us is not None else e.cuda_time_total

    parts = {e.key: device_us(e) for e in rows
             if e.key in ("MoEFn", "MoEFnBackward")}
    if not busy or len(parts) != 2:
        return {"share": "not measured", "parts_ms": parts}
    return {"share": sum(parts.values()) / busy,
            "forward_ms": parts["MoEFn"] * 1e-3,
            "backward_ms": parts["MoEFnBackward"] * 1e-3,
            "step_device_ms": busy * 1e-3}


def phase_train_moe(torch, dev):
    """(b) the MoE LM trained at full width, sparse (MOE_CF) and dense."""
    sparse, sparse_launches = _train_moe(torch, dev, MOE_CF)
    dense, dense_launches = _train_moe(torch, dev, 0.0)
    ratio = sparse["tokens_per_s"] / dense["tokens_per_s"]
    flops = {"sparse": sparse["mfu_row"]["flops"],
             "dense": dense["mfu_row"]["flops"]}
    log("train moe: " + json.dumps({
        "tokens_per_s": {"sparse": sparse["tokens_per_s"],
                         "dense": dense["tokens_per_s"]},
        "sparse_over_dense": ratio, "train_step_flops": flops,
        "mfu": {"sparse": sparse["mfu_row"]["mfu"],
                "dense": dense["mfu_row"]["mfu"]},
        "moe_share": {"sparse": sparse["moe_share_of_step"]["share"],
                      "dense": dense["moe_share_of_step"]["share"]}}))
    return {"sparse": sparse_launches, "dense": dense_launches}


def _routed_run(torch, moe, pred, batch, lens, forced):
    """A teacher-forced run (prefill, then a step a column of ``forced``)
    under programs.eager(), with every MoEFFN call's routing recorded:
    returns (the probabilities after the prefill and each step, [(tag,
    router probabilities, choice)] in call order), the tag ("prefill",
    slot, the chunk's first position) for a prefill chunk's call and
    ("step", s) for step s's."""
    from mxnet_tpu_torch import programs

    calls, tag = [], [None]
    route, chunk = moe._route, pred._chunk

    def tapped_route(probs, k):
        choice, gate = route(probs, k)
        if probs.device.type != "meta":     # not a shape probe's run
            calls.append((tag[0], probs.clone(), choice.clone()))
        return choice, gate

    def tagged_chunk(caches, slot, toks, pos0, *args, **kw):
        tag[0] = ("prefill", int(slot), int(pos0))
        return chunk(caches, slot, toks, pos0, *args, **kw)

    moe._route, pred._chunk = tapped_route, tagged_chunk
    try:
        with programs.eager():
            state, probs = pred.prefill(batch, lens)
            out = [probs.clone()]
            for col in range(forced.shape[1]):
                tag[0] = ("step", col)
                state, probs = pred.step(state._replace(
                    tok=forced[:, col:col + 1].clone()))
                out.append(probs.clone())
    finally:
        moe._route = route
        del pred._chunk
    return out, calls


def _route_flips(k_calls, p_calls):
    """The routing choices that differ between a kernel and a plain run:
    [(tag, token, rank, kernel's expert, plain's expert, the plain run's
    probability gap between the two)] (a flip is explained by a near tie:
    a gap within TOL_FLIP_GAP)."""
    if [(t, c.shape) for t, _, c in k_calls] \
            != [(t, c.shape) for t, _, c in p_calls]:
        raise AssertionError("the kernel and plain runs made other MoE "
                             "calls")
    flips = []
    for (tag, _, kc), (_, pp, pc) in zip(k_calls, p_calls):
        for tok, rank in (kc != pc).nonzero().tolist():
            a, b = int(kc[tok, rank]), int(pc[tok, rank])
            flips.append((tag, tok, rank, a, b,
                          float((pp[tok, a] - pp[tok, b]).abs())))
    return flips


def _teacher_forced_moe(torch, moe, pred, plain, prompts, forced):
    """The kernel predictor ``pred`` against ``plain``, teacher-forced
    (phase 5's first SLOTS prompts, then the columns of ``forced``),
    both eagerly with their routing recorded: (the kernel run's
    probabilities, a reading).  A flip moves its token's output by O(1):
    a prefill flip its slot and every slot that shares the token's prefix
    (the prefix cache shares its pages) from the prefill on, a step's
    flip every slot from that step on (the step's capacity is shared);
    ``max_abs_dlogp`` is the gap of the positions no flip reached."""
    batch = np.zeros((SLOTS, max(PROMPT_LENS[:SLOTS])), np.float32)
    for i in range(SLOTS):
        batch[i, :PROMPT_LENS[i]] = prompts[i]
    lens = np.asarray(PROMPT_LENS[:SLOTS])
    k_probs, k_calls = _routed_run(torch, moe, pred, batch, lens, forced)
    p_probs, p_calls = _routed_run(torch, moe, plain, batch, lens, forced)
    flips = _route_flips(k_calls, p_calls)
    reached = torch.zeros((1 + forced.shape[1], SLOTS), dtype=torch.bool)
    for tag, tok, *_ in flips:
        if tag[0] == "prefill":
            pos = tag[2] + tok
            for slot in range(SLOTS):
                if PROMPT_LENS[slot] > pos and np.array_equal(
                        prompts[slot][:pos + 1], prompts[tag[1]][:pos + 1]):
                    reached[:, slot] = True
        else:
            reached[1 + tag[1]:] = True
    if bool(reached.all()):
        raise AssertionError("routing flips reached every teacher-forced "
                             "position: %s" % flips)
    gaps = torch.stack([(torch.log(a.double()) - torch.log(b.double()))
                        .abs().amax(-1).cpu()
                        for a, b in zip(k_probs, p_probs)])
    return k_probs, {
        "max_abs_dlogp": float(gaps[~reached].max()),
        "positions_reached_by_a_flip": int(reached.sum()),
        "positions": int(reached.numel()),
        "max_abs_dlogp_reached": (float(gaps[reached].max())
                                  if reached.any() else None),
        "routing_choices": sum(c.numel() for _, _, c in k_calls),
        "routing_flips": len(flips),
        "flips": [{"call": list(tag), "token": tok, "rank": rank,
                   "kernel_expert": a, "plain_expert": b,
                   "plain_prob_gap": gap}
                  for tag, tok, rank, a, b, gap in flips]}


def _unit_gamma_probe(torch, moe, dev, prompts, forced):
    """Not gated: the teacher-forced comparison of the MoE serve model
    with its LayerNorm gammas at 1 (unit-scale activations, 50 times
    phase 5's), over int8 pages and over f32 pages."""
    from mxnet_tpu_torch.decode import DecodePredictor

    sym, params, _ = _lm(torch, dev, unit_gammas=True, **MOE_SERVE)
    out = {}
    for kv in ("int8", ""):
        pair = [DecodePredictor(sym, params, cache_len=SEQ, device=dev,
                                paged=True, kv_dtype=kv,
                                page_tokens=PAGE_TOKENS, prefill_chunk=CHUNK,
                                plain=plain) for plain in (False, True)]
        _, reading = _teacher_forced_moe(torch, moe, *pair, prompts, forced)
        out[kv or "float32"] = reading
        del pair
        gc.collect()
    return out


def phase_serve_moe(torch, dev):
    """(c) the MoE LM served through the paged DecodeServer's captured
    programs: returns the launches of the captured serve."""
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.ops import moe

    sym, params, n_params = _lm(torch, dev, **MOE_SERVE)
    prompts = _prompts()
    pred = _predictor(sym, params, False, dev)
    report = pred.prepare_programs(SLOTS, CHUNK)
    _serve(torch, pred, [p[:64] for p in prompts[:2]])

    def counted(p):
        before = _launch_counts()
        replays = programs.GRAPH_STATS["replays"]
        out = _serve(torch, p, prompts)
        return out + (_launch_delta(before),
                      programs.GRAPH_STATS["replays"] - replays)

    moe.MOE_PATH["last"] = moe.MOE_DISPATCH["last"] = None
    results, wall, stats, launches, replays = counted(pred)
    paths = {"moe": moe.MOE_PATH["last"],
             "dispatch": moe.MOE_DISPATCH["last"]}
    if min(launches.values()) <= 0 \
            or paths != {"moe": "sparse", "dispatch": "sort"} \
            or replays < stats["steps"] + stats["chunks"]:
        raise AssertionError("the MoE serve: launches %s paths %s replays "
                             "%d" % (launches, paths, replays))
    for rid in range(len(prompts)):
        toks = results[rid]
        if toks.shape != (MAX_NEW,) or toks.min() < 0 \
                or toks.max() >= VOCAB:
            raise AssertionError("MoE request %d returned %s" % (rid, toks))
    with programs.eager():
        e_results, e_wall, _, e_launches, _ = counted(pred)
    _same_tokens("the MoE serve under programs.eager()", e_results, results)
    if e_launches != launches:
        raise AssertionError("MoE serve launches, captured %s against eager "
                             "%s" % (launches, e_launches))
    plain = _predictor(sym, params, True, dev)
    with programs.eager():
        p_results, p_wall, _ = _serve(torch, plain, prompts)
    _same_tokens("the MoE serve's plain versions", p_results, results)

    # teacher-forced: the kernel run's tokens fed to both; the kernel side
    # captured must equal it eager, bit for bit
    forced = torch.tensor([[int(results[i][s]) for s in range(8)]
                           for i in range(SLOTS)], dtype=torch.int32,
                          device=dev)
    batch = np.zeros((SLOTS, max(PROMPT_LENS[:SLOTS])), np.float32)
    for i in range(SLOTS):
        batch[i, :PROMPT_LENS[i]] = prompts[i]
    ks, kprobs = pred.prefill(batch, np.asarray(PROMPT_LENS[:SLOTS]))
    captured = [kprobs.clone()]
    for step in range(forced.shape[1]):
        ks, kprobs = pred.step(ks._replace(tok=forced[:, step:step + 1]
                                           .clone()))
        captured.append(kprobs.clone())
    k_probs, forced_reading = _teacher_forced_moe(torch, moe, pred, plain,
                                                  prompts, forced)
    if not all(torch.equal(a, b) for a, b in zip(captured, k_probs)):
        raise AssertionError("the MoE serve's captured teacher-forced "
                             "probabilities differ from eager ones")
    traces = pred.trace_counts
    if (traces["decode"], traces["chunk"], traces["commit"]) != (1, 1, 1):
        raise AssertionError("the MoE serve captured its programs again: %s"
                             % traces)
    del pred, plain
    gc.collect()
    probe = _unit_gamma_probe(torch, moe, dev, prompts, forced)
    tokens = sum(len(t) for t in results.values())
    reading = {"model": dict(MOE_SERVE, vocab=VOCAB, embed=EMBED,
                             heads=HEADS, ffn=FFN, layers=LAYERS,
                             params=n_params),
               "prepare_programs_s": report["wall_s"],
               "requests": len(prompts), "tokens": tokens, "wall_s": wall,
               "tokens_per_s": tokens / wall,
               "eager_tokens_per_s": tokens / e_wall,
               "plain_tokens_per_s": tokens / p_wall,
               "ttft_p50_s": stats.get("ttft_p50_s"),
               "ttft_p95_s": stats.get("ttft_p95_s"),
               "decode_steps": stats["steps"], "chunks": stats["chunks"],
               "replays": replays, "paths": paths, "launches": launches,
               "captured_equals_eager": True,
               "greedy_token_agreement_plain": 1.0,
               "teacher_forced_captured_equals_eager": True,
               "teacher_forced": forced_reading, "tol": TOL_LOGP,
               "tol_flip_gap": TOL_FLIP_GAP, "trace_counts": traces,
               "unit_gamma_probe": probe}
    log("serve moe: " + json.dumps(reading))
    flips = forced_reading["flips"]
    if not forced_reading["max_abs_dlogp"] <= TOL_LOGP \
            or any(f["plain_prob_gap"] > TOL_FLIP_GAP for f in flips):
        raise AssertionError("the MoE serve, teacher-forced |log p_kernel - "
                             "log p_plain| %.3g (tol %.3g) where no routing "
                             "flip reached; flips %s (gap tol %.3g)"
                             % (forced_reading["max_abs_dlogp"], TOL_LOGP,
                                flips, TOL_FLIP_GAP))
    return launches


def phase_moe(torch, dev):
    """Phase 16: (a) the op cases, (b) the MoE LM trained, (c) served."""
    rows = _moe_op_cases(torch, dev)
    log("moe (a) op cases: " + json.dumps(rows))
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train_moe(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    serve = phase_serve_moe(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    return {"moe_train_sparse": train["sparse"],
            "moe_train_dense": train["dense"], "moe_serve": serve}


class _Lines(logging.Handler):
    """The messages of a module's logger (fit's epoch lines)."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def emit(self, record):
        self.rows.append(record.getMessage())


def _resume_counts(zero=False):
    """The launch counts of A, F, C, D, E and B1 (set to 0 first with
    ``zero``)."""
    from mxnet_tpu_torch.ops import flash_kernel, fused_kernel, update_kernel

    out = {}
    for counts, names in (
            (fused_kernel.LAUNCHES, ("fused_fwd", "fused_bwd")),
            (flash_kernel.LAUNCHES, ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")),
            (update_kernel.LAUNCHES, ("multi_tensor_update",))):
        for name in names:
            if zero:
                counts[name] = 0
            out[name] = counts[name]
    return out


def _store(mod):
    """Clones of a module's store: parameters, aux states, slots."""
    from mxnet_tpu_torch import checkpoint

    return {k: t.clone() for k, t in checkpoint._flatten(
        checkpoint._state_of(mod)).items()}


def _resume_run(torch, make, X, Y, batch, directory, async_write,
                metric, kill=False):
    """One seeded ``fit`` of ``make(logger)``'s module (it returns the
    module and fit's keyword arguments) over RESUME_EPOCHS epochs of an
    NDArrayIter over ``X`` / ``Y``, with a Checkpointer (RESUME_PERIOD)
    in ``directory``.  ``kill``: the FaultInjector waits for the writer
    at RESUME_FENCE (that fence is then written, not skipped) and kills
    the run at RESUME_KILL.  ``metric()`` makes the eval metric.  The
    train step's metric accumulators are cloned after every step (a copy
    on the stream, no sync), keyed by (epoch, batch): ``"acc"``."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import elastic, profiler

    t_make = time.perf_counter()
    mt.random.seed(RESUME_SEED)
    lines = _Lines()
    logger = logging.Logger("resume")
    logger.addHandler(lines)
    mod, fit_kw = make(logger)
    ck = elastic.Checkpointer(directory, period=RESUME_PERIOD,
                              async_write=async_write)
    inj = elastic.FaultInjector()
    if kill:
        inj.at_step(RESUME_FENCE, ck.wait).kill_at(RESUME_KILL)
    ctl = elastic.ElasticController(checkpointer=ck, injector=inj)
    acc = {}

    def after_step(p):
        state = mod._train_step._metric_acc
        if state is not None and state.state is not None:
            acc[(p.epoch, p.nbatch)] = [t.clone() for t in state._tensors()]

    profiler.reset_step_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    killed = False
    try:
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=batch),
                eval_metric=metric(), num_epoch=RESUME_EPOCHS, elastic=ctl,
                batch_end_callback=after_step, **fit_kw)
    except elastic.WorkerKilled:
        killed = True
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if killed != kill:
        raise AssertionError("resume: the run was%s killed" %
                             ("" if killed else " not"))
    stats = profiler.step_stats()
    return {"mod": mod, "ck": ck, "ctl": ctl, "wall_s": wall,
            "run_s": time.perf_counter() - t_make,
            "lines": [r for r in lines.rows if "Train-" in r],
            "acc": {k: [float(t) for t in v] for k, v in acc.items()},
            "steps": stats["steps"], "stats": stats,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _ckpt_reading(run):
    ck, st = run["ck"], run["stats"]
    return {"ckpt_stall_s": st["ckpt_stall_s"],
            "checkpoint_stall_fraction": st["checkpoint_stall_fraction"],
            "wall_s": run["wall_s"], "run_s": run["run_s"],
            "steps": run["steps"],
            "writes": ck.writes, "skipped_busy": ck.skipped_busy,
            "steps_during_write": ck.steps_during_write,
            "last_write_ms": ck.last_write_ms,
            "snapshot_bytes": ck.snapshot_bytes,
            "peak_memory_gb": run["peak_gb"]}


def _metric_value(line):
    return float(line.rsplit("=", 1)[1])


def _fence_meta(directory):
    with open(os.path.join(directory, str(RESUME_FENCE),
                           "elastic.json")) as f:
        meta = json.load(f)
    if (meta["epoch"], meta["nbatch_done"], meta["global_step"]) != (
            1, 2, RESUME_FENCE):
        raise AssertionError("resume: the fence is not epoch 1, 2 batches "
                             "in: %s" % {k: meta[k] for k in (
                                 "epoch", "nbatch_done", "global_step")})
    return {k: meta[k] for k in ("epoch", "nbatch_done", "global_step")}


def _resume_lm(torch, dev, base):
    """(a) the LM killed and resumed, and (c) its step-directory
    checkpoint; returns the launches and the trained module's reading."""
    from mxnet_tpu_torch import checkpoint, gpu
    from mxnet_tpu_torch import metric as metric_mod
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.elastic import FaultInjector
    from mxnet_tpu_torch.io import DataBatch, DataDesc, NDArrayIter
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.module import Module

    b, t = TRAIN_BATCH, SEQ
    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=t,
                                  num_layers=TRAIN_LAYERS, embed=EMBED,
                                  heads=TRAIN_HEADS, ffn_hidden=FFN)
    params = _train_params(sym)
    rng = np.random.RandomState(7)
    X = rng.randint(0, VOCAB, size=(RESUME_BATCHES * b, t)) \
        .astype(np.float32)
    Y = np.concatenate([X[:, 1:], np.zeros((len(X), 1), np.float32)],
                       axis=1)
    fit_kw = {"optimizer": "adam",
              "optimizer_params": {"learning_rate": RESUME_LM_LR},
              "arg_params": params}

    def make(logger):
        return Module(sym, context=gpu(0), logger=logger), fit_kw

    def perplexity():
        return metric_mod.Perplexity(None)

    def dirs(name):
        return os.path.join(base, "lm-" + name)

    _resume_counts(zero=True)
    runs = {}
    for name, async_write, kill, directory in (
            ("whole", True, False, dirs("whole")),
            ("whole_sync", False, False, dirs("whole_sync")),
            ("killed", True, True, dirs("kill")),
            ("resumed", True, False, dirs("kill"))):
        run = _resume_run(torch, make, X, Y, b, directory, async_write,
                          perplexity, kill)
        run["store"] = _store(run["mod"])
        if name == "killed":
            fence = _fence_meta(directory)
        if name == "resumed" and run["ctl"].recoveries != 1:
            raise AssertionError("resume (a): the run did not resume")
        if run["ck"]._error is not None:
            raise AssertionError("resume (a): a write failed")
        if name != "whole":
            run["mod"] = None     # the first run's module stays for (c)
        runs[name] = run
        if name == "whole_sync":
            shutil.rmtree(directory, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    launches = _resume_counts()
    steps = sum(r["steps"] for r in runs.values())
    per_step = {"fused_fwd": 5 * TRAIN_LAYERS, "fused_bwd": 5 * TRAIN_LAYERS,
                "flash_fwd": TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
                "flash_bwd_dkv": TRAIN_LAYERS, "multi_tensor_update": 1}
    if launches != {k: v * steps for k, v in per_step.items()}:
        raise AssertionError("resume (a): launches %s over %d steps, want "
                             "%s a step" % (launches, steps, per_step))
    if runs["whole"]["ck"].steps_during_write <= 0:
        raise AssertionError("resume (a): no step overlapped a write")
    whole, other, resumed = (runs[k]["store"] for k in (
        "whole", "whole_sync", "resumed"))

    def gap(a, c):
        return float(torch.linalg.vector_norm(a.double() - c.double()))

    spread = {}
    for k in whole:
        if not k.startswith("params/"):
            continue
        s, r = gap(other[k], whole[k]), gap(resumed[k], whole[k])
        spread[k] = (r, s)
        if not r <= RESUME_SPREAD * s:
            raise AssertionError(
                "resume (a): %s resumed vs uninterrupted %.3g, the two "
                "uninterrupted runs %.3g (x%g allowed)"
                % (k, r, s, RESUME_SPREAD))
    lines = {k: runs[k]["lines"][-1] for k in ("whole", "whole_sync",
                                               "resumed")}
    # the metric across the kill: after its first step the resumed run
    # holds what the killed run held after that step, bit for bit (the
    # fence's sums, the batch the iterator gave, the parameters the
    # forward read), and its last epoch counts the uninterrupted run's
    # batches.  The lines' values part with the runs' histories (F's
    # atomics), as the parameters do: those are held to the spread above
    first = divmod(RESUME_FENCE, RESUME_BATCHES)
    last = (RESUME_EPOCHS - 1, RESUME_BATCHES - 1)
    across = {k: runs[k]["acc"].get(first) for k in ("killed", "resumed")}
    counts = {k: runs[k]["acc"][last][1] for k in ("whole", "resumed")}
    if across["killed"] is None or across["killed"] != across["resumed"] \
            or counts["resumed"] != counts["whole"]:
        raise AssertionError(
            "resume (a): the metric across the kill: after epoch %d batch "
            "%d %s (killed) against %s (resumed); the last epoch's count %s; "
            "lines %s" % (first + (across["killed"], across["resumed"],
                                   counts, lines)))
    vals = {k: _metric_value(v) for k, v in lines.items()}
    worst = max(spread, key=lambda k: spread[k][0] / max(spread[k][1],
                                                         1e-300))
    reading = {
        "card": _smi_line(), "fence": fence, "lines": lines,
        "line_gap": {"resumed": vals["resumed"] - vals["whole"],
                     "whole_sync": vals["whole_sync"] - vals["whole"]},
        "metric_across_kill": across["resumed"], "metric_counts": counts,
        "params_bitwise": all(r == 0 for r, _ in spread.values()),
        "spread_bitwise": all(s == 0 for _, s in spread.values()),
        "worst": {"param": worst, "resumed_gap": spread[worst][0],
                  "spread": spread[worst][1]},
        "async": _ckpt_reading(runs["whole"]),
        "sync": _ckpt_reading(runs["whole_sync"]),
        "killed": _ckpt_reading(runs["killed"]),
        "resumed": _ckpt_reading(runs["resumed"]),
        "launches": launches, "steps": steps}
    log("resume (a) lm: " + json.dumps(reading))

    # (c) the step-directory checkpoint of the trained module
    trained = runs["whole"]["mod"]
    d = os.path.join(base, "sharded")
    t0 = time.perf_counter()
    checkpoint.save_sharded(d, 8, trained)
    save_s = time.perf_counter() - t0
    descs = ([DataDesc("data", (b, t))], [DataDesc("softmax_label", (b, t))])
    fresh = Module(sym, context=gpu(0))
    fresh.bind(data_shapes=descs[0], label_shapes=descs[1])
    fresh.init_params(arg_params=params)
    fresh.init_optimizer(optimizer="adam", optimizer_params=fit_kw[
        "optimizer_params"])
    t0 = time.perf_counter()
    checkpoint.load_sharded(d, 8, fresh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got, want = _store(fresh), _store(trained)
    if sorted(got) != sorted(want) or not all(
            torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("resume (c): the round trip is not bit for "
                             "bit")
    del fresh, got
    gc.collect()
    torch.cuda.empty_cache()
    infer = Module(sym, context=gpu(0))
    infer.bind(data_shapes=descs[0], label_shapes=descs[1],
               for_training=False)
    infer.init_params(arg_params=params)
    checkpoint.load_sharded(d, 8, infer)
    before = _resume_counts()
    pred = infer.predict(NDArrayIter(X[:b], Y[:b], batch_size=b))
    trained.forward(DataBatch([nd.array(X[:b], ctx=gpu(0))],
                              [nd.array(Y[:b], ctx=gpu(0))]),
                    is_train=False)
    ref = trained.get_outputs()[0]
    torch.cuda.synchronize()
    after = _resume_counts()
    c_launches = {k: after[k] - before[k] for k in after}
    if not torch.equal(pred.data, ref.data):
        raise AssertionError("resume (c): the inference module's predict "
                             "differs from the trained module's forward "
                             "(max |d| %g)" % float(
                                 (pred.data - ref.data).abs().max()))
    if (c_launches["fused_fwd"], c_launches["flash_fwd"]) != (
            2 * 5 * TRAIN_LAYERS, 2 * TRAIN_LAYERS):
        raise AssertionError("resume (c): forward launches %s" % c_launches)
    FaultInjector.torn_checkpoint(d, 9)
    if checkpoint.latest_step(d) != 8:
        raise AssertionError("resume (c): latest_step took the torn step")
    log("resume (c) sharded: " + json.dumps({
        "card": _smi_line(), "save_s": save_s, "load_s": load_s,
        "files": sorted(os.listdir(os.path.join(d, "8"))),
        "bytes": sum(os.path.getsize(os.path.join(d, "8", f))
                     for f in os.listdir(os.path.join(d, "8"))),
        "round_trip_bitwise": True, "predict_bitwise": True,
        "launches": c_launches, "torn_skipped": True}))
    for k in c_launches:
        launches[k] += c_launches[k]
    return launches


def _resume_alexnet(torch, dev, base):
    """(b) AlexNet killed and resumed, bit for bit."""
    from mxnet_tpu_torch import NameManager, gpu, models
    from mxnet_tpu_torch.module import Module

    cfg = ZOO_TRAIN["alexnet"]
    b, image = cfg["batch"], tuple(cfg["image"])
    with NameManager():
        sym = models.get_alexnet(num_classes=1000)
    args, aux, _, _ = _resnet_values(sym, b, image)
    rng = np.random.RandomState(3)
    X = rng.uniform(-1, 1, (RESUME_BATCHES * b,) + image).astype(np.float32)
    Y = rng.randint(0, 1000, (RESUME_BATCHES * b,)).astype(np.float32)
    fit_kw = {"optimizer": "sgd", "optimizer_params": cfg["opt"],
              "arg_params": args, "aux_params": aux}

    def make(logger):
        return Module(sym, context=gpu(0), logger=logger), fit_kw

    before = _resume_counts()
    runs = {}
    with _cudnn_deterministic(torch):
        for name, kill, sub in (("whole", False, "whole"),
                                ("killed", True, "kill"),
                                ("resumed", False, "kill")):
            directory = os.path.join(base, "alexnet-" + sub)
            run = _resume_run(torch, make, X, Y, b, directory, True,
                              lambda: "acc", kill)
            run["store"] = _store(run["mod"])
            run["mod"] = None
            if name == "killed":
                fence = _fence_meta(directory)
            runs[name] = run
            gc.collect()
            torch.cuda.empty_cache()
    after = _resume_counts()
    launches = {k: after[k] - before[k] for k in after}
    steps = sum(r["steps"] for r in runs.values())
    if launches["multi_tensor_update"] != steps:
        raise AssertionError("resume (b): B1 launched %d times in %d steps"
                             % (launches["multi_tensor_update"], steps))
    whole, resumed = runs["whole"]["store"], runs["resumed"]["store"]
    unequal = [k for k in whole if not torch.equal(whole[k], resumed[k])]
    lines = (runs["whole"]["lines"][-1], runs["resumed"]["lines"][-1])
    if unequal or lines[0] != lines[1]:
        raise AssertionError("resume (b): not bit for bit: %s, lines %s"
                             % (unequal[:6], lines))
    log("resume (b) alexnet: " + json.dumps({
        "card": _smi_line(), "fence": fence, "lines": lines,
        "bitwise": True, "tensors": len(whole),
        "slots": sum(k.startswith("slots/") for k in whole),
        "async": _ckpt_reading(runs["whole"]),
        "killed": _ckpt_reading(runs["killed"]),
        "resumed": _ckpt_reading(runs["resumed"]), "launches": launches,
        "steps": steps}))
    return launches


def phase_resume(torch, dev):
    """Phase 17: fit killed and resumed from its fence checkpoint, (a)
    the LM, (b) AlexNet, (c) the LM's step-directory checkpoint.
    Returns the launches of A, F, C, D, E and B1."""
    base = tempfile.mkdtemp(prefix="mxtorch-resume-")
    t0 = time.perf_counter()
    try:
        lm = _resume_lm(torch, dev, base)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        alexnet = _resume_alexnet(torch, dev, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log("resume: (a) + (c) %.1f s, (b) %.1f s" % (
        t1 - t0, time.perf_counter() - t1))
    return {k: lm[k] + alexnet[k] for k in lm}


def _tune_classes():
    """TUNE_CASES with their shape classes: (label, op, class, dtype); the
    B1 classes from the ResNet-50 and LM trainables' element counts."""
    from mxnet_tpu_torch.models import attention_lm, resnet
    from mxnet_tpu_torch.ops import tuning

    slabs = {
        "B1 resnet50 slab": _trainable_shapes(
            resnet.get_symbol(1000, 50, (3, 224, 224)),
            data=(1, 3, 224, 224), softmax_label=(1,)),
        "B1 LM slab": _trainable_shapes(
            attention_lm.get_symbol(vocab_size=VOCAB, seq_len=SEQ,
                                    num_layers=TRAIN_LAYERS, embed=EMBED,
                                    heads=TRAIN_HEADS, ffn_hidden=FFN),
            data=(1, SEQ), softmax_label=(1, SEQ))}
    out = []
    for label, op, dims, dtype in TUNE_CASES:
        if dims is None:
            dims = {"n": sum(int(np.prod(s)) for s in slabs[label].values())}
        out.append((label, op, tuning.shape_class_for(**dims), dtype))
    return out


def _sweep_table(tuning, aot, op, sc, dtype, gen):
    """The record a sweep wrote: the winner and every candidate."""
    space = tuning.spaces()[op]
    key = tuning.cache_key(op, sc, dtype, space.version, device=gen)
    with open(os.path.join(aot.cache_dir(), key + ".json")) as f:
        entry = json.load(f)
    swept = entry["swept"]
    default = next(r for r in swept if r["params"] == space.defaults)
    win = min((r for r in swept if r["tol_share"] <= 1.0),
              key=lambda r: r["ms"])
    if win["params"] != entry["params"]:
        raise AssertionError("tuning %s %s: the record's winner %s is not "
                             "its fastest candidate %s"
                             % (op, sc, entry["params"], win["params"]))
    return {"candidates": len(swept), "default_ms": default["ms"],
            "winner": entry["params"], "winner_ms": win["ms"],
            "max_abs_err": max(r["max_abs_err"] for r in swept),
            "worst_tol_share": max(r["tol_share"] for r in swept),
            "table": [[list(r["params"].values()), round(r["ms"], 5),
                       float("%.3g" % r["max_abs_err"])] for r in swept]}


def _tuned_serve(torch, dev, sym, params, prompts, cache, forced):
    """Phase 5's serve through a predictor whose plans resolve from
    ``cache`` (an empty directory: the hand-fixed plans), unarmed; then a
    teacher-forced prefill of the first SLOTS prompts and 8 decode steps
    fed ``forced`` (or the serve's own tokens).  Returns the tokens, the
    serve's tokens/s, the per-step probabilities and what kernels A and
    B last ran after the prefill and after the steps."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.ops import decode_kernel as dk
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.ops import tuning

    with config.overrides(MXNET_PROGRAM_CACHE=cache,
                          MXNET_PALLAS_TUNE=False):
        tuning.reset_memo()
        pred = _predictor(sym, params, False, dev)
        pred.prepare_programs(SLOTS, CHUNK)
        _serve(torch, pred, [p[:64] for p in prompts[:2]])
        _all_counts(zero=True)
        results, wall, _ = _serve(torch, pred, prompts)
        launches = _all_counts()
        forced = forced or results
        batch = np.zeros((SLOTS, max(PROMPT_LENS[:SLOTS])), np.float32)
        for i in range(SLOTS):
            batch[i, :PROMPT_LENS[i]] = prompts[i]
        state, probs = pred.prefill(batch, np.asarray(PROMPT_LENS[:SLOTS]))
        after_prefill = fk.LAST_VARIANT["fused_fwd"]
        steps = [probs.double().clone()]
        for step in range(8):
            tok = torch.tensor([[int(forced[i][step])] for i in range(SLOTS)],
                               dtype=torch.int32, device=dev)
            state, probs = pred.step(state._replace(tok=tok))
            steps.append(probs.double().clone())
        b_ran = (dk.LAST_VARIANT["paged_decode"],
                 dk.LAST_VARIANT["paged_decode_splits"])
        tokens = sum(len(t) for t in results.values())
        del pred, state, probs
        gc.collect()
        torch.cuda.empty_cache()
    return {"results": results, "tokens_per_s": tokens / wall,
            "steps": steps, "a_after_prefill": after_prefill,
            "b_after_steps": b_ran, "launches": launches}


def _tuned_lm_run(torch, dev, sym, params, batch, labels, cache):
    """Phase 6's LM through Module with plans resolved from ``cache``,
    unarmed: the set-up step (warm-up and capture), then TUNE_LM_STEPS
    captured steps, counted and timed.  Returns (parameters, launches,
    step s, losses)."""
    from mxnet_tpu_torch import config, gpu
    from mxnet_tpu_torch.io import DataDesc
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ops import tuning

    with config.overrides(MXNET_PROGRAM_CACHE=cache,
                          MXNET_PALLAS_TUNE=False):
        tuning.reset_memo()
        mod = Module(sym, context=gpu(0))
        mod.bind(data_shapes=[DataDesc("data", (TRAIN_BATCH, SEQ),
                                       layout="NT")],
                 label_shapes=[DataDesc("softmax_label", (TRAIN_BATCH, SEQ),
                                        layout="NT")])
        mod.init_params(arg_params=params, aux_params={})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": TRAIN_LR})
        mod.forward_backward(batch)
        mod.update()
        _all_counts(zero=True)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TUNE_LM_STEPS):
            mod.forward_backward(batch)
            mod.update()
            p = mod.get_outputs()[0].data.gather(1, labels)
            losses.append(float(-torch.log(torch.clamp_min(p, 1e-30))
                                .mean()))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / TUNE_LM_STEPS
        launches = _all_counts()
        snap = _snapshot(mod)
        del mod
        gc.collect()
        torch.cuda.empty_cache()
    return snap, launches, step_s, losses


_COLD_CHILD = """
import json, sys
import torch
from mxnet_tpu_torch.ops import tuning

tuning.spaces()
dev = torch.device("cuda", 0)
out = [tuning.resolve(op, sc, dt, device=dev)
       for op, sc, dt in json.loads(sys.argv[1])]
print(json.dumps({"probes": tuning.PROBE_COUNT["n"], "params": out}))
"""


def _rtc_phase(torch, dev, card):
    """(d): build a user kernel from a source string, register it, hold
    it against the plain expression imperatively and through a bound
    symbol's gradient, train an MLP with the op inside through the
    captured Module step bit for bit against eager, and find the user
    kernel in a profiled replay."""
    import ctypes

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import programs
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    lib = mt.rtc.build(RTC_SOURCE)
    build_s = time.perf_counter() - t0
    p = ctypes.c_void_p
    lib.rtc_scale_add.argtypes = [p, p, p, ctypes.c_float, ctypes.c_int, p]
    launched = {"n": 0}

    def forward(x, y, alpha=2.0):
        if x.device.type != "cuda":
            return x * alpha + y
        x, y = x.contiguous(), y.contiguous()
        o = torch.empty_like(x)
        rc = lib.rtc_scale_add(x.data_ptr(), y.data_ptr(), o.data_ptr(),
                               alpha, x.numel(),
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError("rtc_scale_add: CUDA error %d" % rc)
        launched["n"] += 1
        return o

    def backward(inputs, outputs, cotangents, alpha=2.0):
        (g,) = cotangents
        return [g * alpha, g]

    mt.rtc.register_cuda_op("smoke_scale_add", forward, backward=backward,
                            num_inputs=2, attr_params={"alpha": 2.0})
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    x = torch.randn(1 << 20, generator=g, device=dev)
    y = torch.randn(1 << 20, generator=g, device=dev)
    got = mt.nd.smoke_scale_add(mt.nd.NDArray(x), mt.nd.NDArray(y),
                                alpha=3.0).data
    torch.cuda.synchronize()
    imp_err = float((got - (x * 3.0 + y)).abs().max())
    a, b = mt.sym.Variable("a"), mt.sym.Variable("b")
    xs, ys = x[:4096].reshape(64, 64), y[:4096].reshape(64, 64)
    ex = mt.sym.smoke_scale_add(a, b, alpha=1.5).bind(
        mt.gpu(0), {"a": mt.nd.NDArray(xs), "b": mt.nd.NDArray(ys)},
        args_grad={"a": mt.nd.NDArray(torch.zeros_like(xs)),
                   "b": mt.nd.NDArray(torch.zeros_like(ys))})
    sym_out = ex.forward(is_train=True)[0].data
    dy = torch.randn(64, 64, generator=g, device=dev)
    ex.backward(out_grads=mt.nd.NDArray(dy))
    torch.cuda.synchronize()
    sym_err = max(float((sym_out - (xs * 1.5 + ys)).abs().max()),
                  float((ex.grad_dict["a"].data - dy * 1.5).abs().max()),
                  float((ex.grad_dict["b"].data - dy).abs().max()))
    if imp_err != 0.0 or sym_err != 0.0 or launched["n"] < 2:
        raise AssertionError("rtc (d): the user kernel against the plain "
                             "expression: imperative %g, symbolic %g, %d "
                             "launches" % (imp_err, sym_err, launched["n"]))

    nb, ni, nh, nc = RTC_MLP
    rng = np.random.RandomState(18)
    xb = rng.randn(nb, ni).astype(np.float32)
    yb = rng.randint(0, nc, size=nb).astype(np.float32)
    args = {"fc1_weight": rng.randn(nh, ni) * ni ** -0.5,
            "fc1_bias": np.zeros(nh), "skip_weight": rng.randn(nh, ni)
            * ni ** -0.5, "skip_bias": np.zeros(nh),
            "fc2_weight": rng.randn(nc, nh) * nh ** -0.5,
            "fc2_bias": np.zeros(nc)}
    args = {k: v.astype(np.float32) for k, v in args.items()}
    data = mt.sym.Variable("data")
    h = mt.sym.smoke_scale_add(
        mt.sym.FullyConnected(data, num_hidden=nh, name="fc1"),
        mt.sym.FullyConnected(data, num_hidden=nh, name="skip"), alpha=0.5)
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.Activation(h, act_type="tanh"), num_hidden=nc, name="fc2"),
        name="softmax")
    batch = mt.io.DataBatch([mt.nd.array(xb, ctx=mt.gpu(0))],
                            [mt.nd.array(yb, ctx=mt.gpu(0))])

    def train(eager):
        mod = mt.mod.Module(net, context=mt.gpu(0))
        mod.bind(data_shapes=[("data", xb.shape)],
                 label_shapes=[("softmax_label", yb.shape)])
        mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.gpu(0))
                                    for k, v in args.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        if mod._train_step is None:
            raise AssertionError("rtc (d): no compiled step for the MLP")
        for _ in range(TUNE_LM_STEPS):
            with programs.eager() if eager else contextlib.nullcontext():
                mod.forward_backward(batch)
                mod.update()
        torch.cuda.synchronize()
        return mod, {k: v.data.detach().cpu().clone()
                     for k, v in mod.get_params()[0].items()}

    replays = programs.GRAPH_STATS["replays"]
    mod, captured = train(False)
    replays = programs.GRAPH_STATS["replays"] - replays
    _, eager = train(True)
    unequal = sorted(k for k in eager if not torch.equal(captured[k],
                                                         eager[k]))
    moved = sorted(k for k in args if not torch.equal(
        captured[k], torch.from_numpy(args[k])))
    # the profiled replays: a spin first, so the session's early loss of
    # device records falls on the spin, then five replays of the step
    spin = torch.randn(4096, 4096, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            spin = spin @ spin * (1.0 / 64)
        for _ in range(5):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
    calls = sum(e.count for e in prof.key_averages()
                if "rtc_scale_add_kernel" in e.key)
    out = {"card": card, "build_s": build_s, "imperative_max_abs_err":
           imp_err, "symbolic_max_abs_err": sym_err,
           "captured_steps": TUNE_LM_STEPS, "step_replays": replays,
           "captured_vs_eager_bitwise": not unequal, "unequal": unequal,
           "parameters_moved": moved,
           "profiled_kernel_calls": calls}
    log("rtc (d): " + json.dumps(out))
    if unequal or replays < TUNE_LM_STEPS - 1 or calls < 1 \
            or "fc1_weight" not in moved:
        raise AssertionError("rtc (d): the MLP with the user op, captured "
                             "against eager: %s" % out)
    return out


def phase_tuning(torch, dev):
    """Phase 18: sweep the main paths' shape classes (a), read them back
    in a cold process with zero probes (b), run the serve and the LM's
    captured steps with the winners against the hand-fixed plans (c),
    and a user kernel through rtc (d).  The tuning cache is a fresh
    temporary directory, deleted at the end; the memo is reset at the
    start and at the end."""
    from mxnet_tpu_torch import config, cuda_build
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.ops import decode_kernel as dk
    from mxnet_tpu_torch.ops import flash_kernel as fl
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.ops import tuning
    from mxnet_tpu_torch.programs import aot

    card = _smi_line()
    # the sweeps hold each candidate to the tolerance of its kernel's own
    # phase
    want_tol = (fk.SWEEP_TOL == {"a": TOL_A, "a_stats": TOL_A_STATS,
                                 "dx": {"float32": TOL_F32,
                                        "bfloat16": TOL_BF16},
                                 "long": TOL_F32_LONG}
                and dk.SWEEP_TOL == TOL_B
                and fl.SWEEP_TOL == {"float32": TOL_F32,
                                     "bfloat16": TOL_BF16,
                                     "lse": TOL_F32})
    if not want_tol:
        raise AssertionError("tuning: the sweeps' tolerances differ from "
                             "the kernel phases'")
    t_all = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mx_tuning_")
    cache, cold = os.path.join(root, "cache"), os.path.join(root, "cold")
    gen = tuning.device_generation(dev)
    tuning.reset_memo()
    try:
        # (a) the sweep
        classes = _tune_classes()
        tables = {}
        t0 = time.perf_counter()
        with config.overrides(MXNET_PROGRAM_CACHE=cache,
                              MXNET_PALLAS_TUNE=True):
            launches0 = _all_counts()
            for label, op, sc, dtype in classes:
                t1 = time.perf_counter()
                tuning.resolve(op, sc, dtype, device=dev)
                table = _sweep_table(tuning, aot, op, sc, dtype, gen)
                table.update(label=label, op=op, shape_class=sc,
                             dtype=dtype, card=card,
                             sweep_s=time.perf_counter() - t1)
                log("tuning (a) %s: %s" % (label, json.dumps(table)))
                tables[label] = table
                if table["worst_tol_share"] > 1.0:
                    raise AssertionError(
                        "tuning (a) %s: a candidate beyond its kernel's "
                        "tolerance (%.3gx)" % (label,
                                               table["worst_tol_share"]))
            if _all_counts() != launches0:
                raise AssertionError("tuning (a): the sweeps moved the "
                                     "kernels' launch counters")
        sweep_s = time.perf_counter() - t0
        probes = tuning.PROBE_COUNT["n"]

        # (b) a cold process sharing only the cache directory
        t0 = time.perf_counter()
        env = dict(os.environ, MXNET_PROGRAM_CACHE=cache,
                   MXNET_PALLAS_TUNE="1")
        proc = subprocess.run(
            [sys.executable, "-c", _COLD_CHILD,
             json.dumps([c[1:] for c in classes])], capture_output=True,
            text=True, timeout=600, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            raise AssertionError("tuning (b): the cold process failed:\n"
                                 + proc.stderr[-3000:])
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        same = child["params"] == [tables[c[0]]["winner"] for c in classes]
        cold_read = {"card": card, "probes": child["probes"],
                     "classes": len(classes), "same_params": same,
                     "wall_s": time.perf_counter() - t0}
        log("tuning (b): " + json.dumps(cold_read))
        if child["probes"] != 0 or not same:
            raise AssertionError("tuning (b): the cold process probed %d "
                                 "times or resolved other params: %s"
                                 % (child["probes"], child["params"]))

        # (c) the winners on the main paths, against the hand-fixed plans
        t0 = time.perf_counter()
        sym, params, _ = _lm(torch, dev)
        prompts = _prompts()
        base = _tuned_serve(torch, dev, sym, params, prompts, cold, None)
        tuned = _tuned_serve(torch, dev, sym, params, prompts, cache,
                             base["results"])
        del params
        agree = float(np.mean([np.mean(base["results"][r]
                                       == tuned["results"][r])
                               for r in base["results"]]))
        dlogp = max(float((torch.log(a) - torch.log(b)).abs().max())
                    for a, b in zip(tuned["steps"], base["steps"]))
        sms = cuda_build.sm_count(dev)
        hd = EMBED // HEADS
        win = {label: tables[label]["winner"] for label in tables}
        want_a = fk._plan(CHUNK, FFN, EMBED, torch.float32, "fwd", True,
                          win["A+F serve chunk ffn2"], sms).variant
        bw = win["B serve decode"]
        b_plan = dk._plan(SLOTS, 1, HEADS, HEADS, hd, hd,
                          SEQ // PAGE_TOKENS, PAGE_TOKENS, sms, True,
                          bw["blocks_per_sm"], bw["min_split_tokens"],
                          bw["max_splits"])
        serve = {"card": card, "greedy_token_agreement": agree,
                 "teacher_forced_max_abs_dlogp": dlogp,
                 "tokens_per_s": {"tuned": tuned["tokens_per_s"],
                                  "untuned": base["tokens_per_s"]},
                 "a_variant": {"tuned": tuned["a_after_prefill"],
                               "untuned": base["a_after_prefill"],
                               "winner": want_a},
                 "b_ran": {"tuned": tuned["b_after_steps"],
                           "untuned": base["b_after_steps"],
                           "winner": [b_plan.variant, b_plan.splits]}}
        log("tuning (c) serve: " + json.dumps(serve))
        path_launches = dict(tuned["launches"])
        del base, tuned
        if not (agree >= MIN_GREEDY_AGREEMENT and dlogp <= TOL_LOGP):
            raise AssertionError("tuning (c): the tuned serve against the "
                                 "untuned one: %s" % serve)
        if serve["a_variant"]["tuned"] != want_a or \
                list(serve["b_ran"]["tuned"]) != serve["b_ran"]["winner"]:
            raise AssertionError("tuning (c): kernels A and B did not run "
                                 "the winners: %s" % serve)

        lm_sym = attention_lm.get_symbol(
            vocab_size=VOCAB, seq_len=SEQ, num_layers=TRAIN_LAYERS,
            embed=EMBED, heads=TRAIN_HEADS, ffn_hidden=FFN)
        lm_params = _train_params(lm_sym)
        rng = np.random.RandomState(1)
        x = rng.randint(0, VOCAB, size=(TRAIN_BATCH, SEQ)).astype(np.float32)
        y = np.concatenate([x[:, 1:], np.zeros((TRAIN_BATCH, 1),
                                               np.float32)], axis=1)
        batch = DataBatch([nd.array(x)], [nd.array(y)])
        labels = torch.from_numpy(y.reshape(-1)).long().to(dev)[:, None]
        start = {n: torch.from_numpy(v).to(dev)
                 for n, v in lm_params.items()}
        runs = {k: _tuned_lm_run(torch, dev, lm_sym, lm_params, batch,
                                 labels, d)
                for k, d in (("untuned", cold), ("untuned_2", cold),
                             ("tuned", cache))}
        per_step = {"fused_fwd": 20, "fused_bwd": 20, "flash_fwd": 4,
                    "flash_bwd_dq": 4, "flash_bwd_dkv": 4,
                    "multi_tensor_update": 1}
        vs = _run_diff(torch, runs["tuned"][0], runs["untuned"][0], start,
                       _DIRECT)
        spread = _run_diff(torch, runs["untuned_2"][0], runs["untuned"][0],
                           start, _DIRECT)
        train = {"card": card, "steps": TUNE_LM_STEPS,
                 "step_s": {k: r[2] for k, r in runs.items()},
                 "losses": {k: r[3] for k, r in runs.items()},
                 "launches": runs["tuned"][1],
                 "tuned_vs_untuned": vs, "untuned_vs_untuned": spread,
                 "max_over_spread": CAPTURE_SPREAD}
        log("tuning (c) train: " + json.dumps(train))
        for k, r in runs.items():
            if {n: r[1].get(n) for n in per_step} != \
                    {n: v * TUNE_LM_STEPS for n, v in per_step.items()}:
                raise AssertionError("tuning (c): %s launches %s, want %s a "
                                     "step" % (k, r[1], per_step))
            if not all(np.isfinite(r[3])):
                raise AssertionError("tuning (c): %s losses %s" % (k, r[3]))
        if any(vs["tiers"][t]["max"]
               > CAPTURE_SPREAD * max(spread["tiers"][t]["max"], 1e-7)
               for t in ("before_relu", "behind_relu")):
            raise AssertionError("tuning (c): the tuned LM steps beyond "
                                 "two untuned runs' spread: %s" % train)
        for k, v in runs["tuned"][1].items():
            path_launches[k] += v
        del runs
        gc.collect()
        torch.cuda.empty_cache()
        c_s = time.perf_counter() - t0

        # (d) a user kernel
        rtc = _rtc_phase(torch, dev, card)
    finally:
        tuning.reset_memo()
        shutil.rmtree(root, ignore_errors=True)
    log("tuning: %s" % json.dumps({
        "card": card, "sweep_s": sweep_s, "probes": probes,
        "cold_s": cold_read["wall_s"], "winners_s": c_s,
        "rtc_build_s": rtc["build_s"], "launches": path_launches,
        "wall_s": time.perf_counter() - t_all}))
    return tables, path_launches


def _all_counts(zero=False):
    """Every kernel's launch count (set to 0 first with ``zero``)."""
    out = _resume_counts(zero)
    if zero:
        from mxnet_tpu_torch.ops import decode_kernel as dk
        from mxnet_tpu_torch.ops import fused_kernel as fk

        fk.LAUNCHES["fused_fwd"] = 0
        dk.LAUNCHES["paged_decode"] = dk.LAUNCHES["paged_combine"] = 0
    out.update(_launch_counts())
    return out


def _tuning_field(tables, label):
    """A kernels-line entry's tuning reading: the class, the winner, its
    ms and the default's."""
    t = tables[label]
    return {"class": "%s %s" % (t["shape_class"], t["dtype"]),
            "winner": t["winner"], "winner_ms": t["winner_ms"],
            "default_ms": t["default_ms"]}


# phase 19: the q rows of the LM's (64, 2048, 128) attention whose
# kernel D / E gradients are held against the operators' CPU
# implementations (the plain backward, one (T, T) f32 logit plane a row)
ANALYSIS_CPU_ROWS = 8
# the LM's captured step time and the imperative LM's as PERF.md
# recorded them before kernels D, E, F and B1 became operators (phase
# 18 (c)'s tuned step; phase 6c)
RECORDED_STEP_S, RECORDED_IMPERATIVE_STEP_S = 0.19892, 0.20048
# the canonical programs a report must show as notes (mesh programs: the
# port's mesh is eager ranks of processes, no single traced graph)
ANALYSIS_NOTES = ["moe_train_step", "ring_tp_step"]


def _err_share(torch, got, want, tol):
    """(max |got - want|, that over tol x max(1, max |want|)) on the
    host."""
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    return err, err / (tol * max(1.0, float(want.abs().max())))


def _analysis_operators(torch, dev, n_params):
    """(a) Kernels F, D, E and B1 as operators: each CUDA implementation
    against the CPU implementation on the same inputs at the LM's shapes
    (F: m 16384, 1024 -> 4096; D / E: (64, 2048, 128) causal, the CPU
    side on ANALYSIS_CPU_ROWS rows; B1: the LM's slab, bit for bit),
    then torch.library.opcheck on CUDA tensors for every kernel
    operator.  ``n_params``: the LM's trainable element count."""
    from mxnet_tpu_torch.ops import flash_kernel as fl
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.ops import update_kernel as uk

    g = torch.Generator(device=dev)
    g.manual_seed(19)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    cases = {}
    m, k, n = TRAIN_BATCH * SEQ, EMBED, FFN
    x, w, dy = r(m, k), r(n, k) / k ** 0.5, r(m, n)
    scale, shift = 1 + 0.1 * r(k), 0.1 * r(k)
    got = fk.fused_bwd_op(x, dy, scale, shift, w, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fk.fused_bwd_op(*(t.cpu() for t in (x, dy, scale, shift, w)),
                           True)
    cpu_s = time.perf_counter() - t0
    errs = [_err_share(torch, got[0], want[0], TOL_F32)] + [
        _err_share(torch, a, b, TOL_F32_LONG)
        for a, b in zip(got[1:], want[1:])]
    cases["fused_bwd"] = {"shape": "m=%d k=%d n=%d float32 relu" % (m, k, n),
                          "max_abs_err": max(e for e, _ in errs),
                          "tol_share": max(sh for _, sh in errs),
                          "cpu_s": cpu_s}
    del x, w, dy, got, want
    bh, hd = TRAIN_BATCH * TRAIN_HEADS, EMBED // TRAIN_HEADS
    q, kk, v, do = (r(bh, SEQ, hd) for _ in range(4))
    sc = hd ** -0.5
    o, lse = fl.flash_fwd(q, kk, v, sc, True)
    delta = fl.flash_delta(o, do)
    dq = fl.flash_bwd_dq_op(q, kk, v, do, lse, delta, sc, True, 1)
    dk, dv = fl.flash_bwd_dkv_op(q, kk, v, do, lse, delta, sc, True, 1)
    rows = ANALYSIS_CPU_ROWS
    cpu = [t[:rows].cpu() for t in (q, kk, v, do, lse, delta)]
    t0 = time.perf_counter()
    wdq = fl.flash_bwd_dq_op(*cpu, sc, True, 1)
    wdk, wdv = fl.flash_bwd_dkv_op(*cpu, sc, True, 1)
    cpu_s = time.perf_counter() - t0
    for name, pairs in (("flash_bwd_dq", ((dq, wdq),)),
                        ("flash_bwd_dkv", ((dk, wdk), (dv, wdv)))):
        errs = [_err_share(torch, a[:rows], b, TOL_F32) for a, b in pairs]
        cases[name] = {"shape": "bh=%d t=%d hd=%d causal float32, %d rows "
                                "held on the CPU" % (bh, SEQ, hd, rows),
                       "max_abs_err": max(e for e, _ in errs),
                       "tol_share": max(sh for _, sh in errs),
                       "cpu_s": cpu_s}
    del q, kk, v, do, o, lse, delta, dq, dk, dv
    # B1 over the LM's slab: its SGD (no slot) and SGD-momentum with a
    # bf16 compute copy, from the same start on both sides
    rows_b1 = -(-n_params // uk.BLOCK) * uk.BLOCK_ROWS
    shape = (rows_b1, uk.LANES)
    nb = rows_b1 // uk.BLOCK_ROWS
    for label, nslots, wc_dtype in (("sgd", 0, None),
                                    ("sgd_momentum_bf16_copy", 1,
                                     torch.bfloat16)):
        w0, grad = r(*shape), r(*shape)
        slots = [r(*shape) for _ in range(nslots)]
        wc = None if wc_dtype is None else torch.empty(shape, dtype=wc_dtype,
                                                       device=dev)
        lrb = torch.full((nb,), TRAIN_LR, device=dev)
        wdb = torch.full((nb,), 1e-4, device=dev)
        hyp = [1.0, -1.0] + ([0.9] if nslots else [])
        cpu = [w0.cpu(), grad.cpu(), [s.cpu() for s in slots],
               None if wc is None else wc.cpu(), lrb.cpu(), wdb.cpu()]
        uk.multi_tensor_update_op("sgd", nslots, w0, grad, slots, wc, lrb,
                                  wdb, hyp, uk.BLOCK_ROWS)
        uk.multi_tensor_update_op("sgd", nslots, cpu[0], cpu[1], cpu[2],
                                  cpu[3], cpu[4], cpu[5], hyp, uk.BLOCK_ROWS)
        outs = [(w0, cpu[0])] + list(zip(slots, cpu[2])) + \
            ([(wc, cpu[3])] if wc is not None else [])
        bitwise = all(torch.equal(a.cpu(), b) for a, b in outs)
        cases["multi_tensor_update " + label] = {
            "shape": "(%d, 128) slab, %d blocks" % (rows_b1, nb),
            "bitwise": bitwise,
            "max_abs_err": max(float((a.float().cpu() - b.float()).abs()
                                     .max()) for a, b in outs)}
        if not bitwise:
            raise AssertionError("kernel B1's operator against its CPU "
                                 "implementation: %s" % cases)
    for name, c in cases.items():
        if "tol_share" in c and not c["tol_share"] <= 1.0:
            raise AssertionError("operator %s against its CPU "
                                 "implementation: %s" % (name, c))
    # opcheck: schema, fake and autograd registration, aot dispatch
    xs, ws = r(256, 128), r(64, 128) / 16
    sc1, sh1 = 1 + 0.1 * r(128), 0.1 * r(128)
    qs = r(2, 128, 64)
    os_, lses = fl.flash_fwd(qs, qs, qs, 0.125, True)
    ds = fl.flash_delta(os_, qs)
    wsl = r(32, 128)
    checks = {
        "fused_fwd": (fk.fused_fwd_op, (xs.requires_grad_(), sc1, sh1,
                                        ws.requires_grad_(), None, None,
                                        True)),
        "fused_bwd": (fk.fused_bwd_op, (xs.detach(), r(256, 64), sc1, sh1,
                                        ws.detach(), True)),
        "flash_fwd": (fl.flash_fwd_op, (qs.clone().requires_grad_(),
                                        qs.clone(), qs.clone(), 0.125, True,
                                        1)),
        "flash_bwd_dq": (fl.flash_bwd_dq_op, (qs, qs, qs, qs, lses, ds,
                                              0.125, True, 1)),
        "flash_bwd_dkv": (fl.flash_bwd_dkv_op, (qs, qs, qs, qs, lses, ds,
                                                0.125, True, 1)),
        "multi_tensor_update": (uk.multi_tensor_update_op, (
            "sgd", 1, wsl, r(32, 128), [r(32, 128)],
            torch.empty(32, 128, dtype=torch.bfloat16, device=dev),
            torch.full((2,), 0.1, device=dev), torch.zeros(2, device=dev),
            [1.0, -1.0, 0.9], 16)),
    }
    opcheck = {}
    for name, (op, args) in checks.items():
        opcheck[name] = {k: v for k, v in
                         torch.library.opcheck(op, args).items()}
        bad = {k: v for k, v in opcheck[name].items() if v != "SUCCESS"}
        if bad:
            raise AssertionError("torch.library.opcheck(%s) on CUDA "
                                 "tensors: %s" % (name, bad))
    return cases, opcheck


def phase_analysis(torch, dev, train, imp):
    """Phase 19: kernels D, E, F and B1 as torch operators, the training
    programs' artifacts and the analysis passes on the card.

    (a) the four new operators against their CPU implementations and
    opcheck; (b) train-f32's LM through the operators: 3 captured steps
    through Module, launches a step, beside phase 6's gradient gate and
    step time; (c) artifacts at full width (the LM's train_step and
    eval_step through Module.program_artifacts; serve-int8-paged's
    prefill chunk, paged decode and verify steps), their kernel nodes,
    costs and build seconds, run_passes over them; train_step's
    dot_flops beside the roofline row's FLOPs; (d) tools/mxlint_torch.py
    on the card (the canonical programs at the reference's dims): exit
    0, its contract line.  Returns the launches of (b)'s timed steps."""
    from mxnet_tpu_torch import analysis, gpu, programs
    from mxnet_tpu_torch import metric as metric_mod
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch, DataDesc, NDArrayIter
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ops import flash_kernel as fl
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.ops import update_kernel as uk

    t_phase = time.perf_counter()
    b, t = TRAIN_BATCH, SEQ
    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=t,
                                  num_layers=TRAIN_LAYERS, embed=EMBED,
                                  heads=TRAIN_HEADS, ffn_hidden=FFN)
    params = _train_params(sym)
    t0 = time.perf_counter()
    cases, opcheck = _analysis_operators(
        torch, dev, sum(int(v.size) for v in params.values()))
    log("analysis (a) operators vs their CPU implementations: "
        + json.dumps({"cases": cases, "opcheck": opcheck,
                      "seconds": time.perf_counter() - t0}))
    gc.collect()
    torch.cuda.empty_cache()

    # (b) 3 captured steps through Module, every kernel an operator
    rng = np.random.RandomState(1)
    x = rng.randint(0, VOCAB, size=(b, t)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((b, 1), np.float32)], axis=1)
    batch = DataBatch([nd.array(x)], [nd.array(y)])
    mod = Module(sym, context=gpu(0))
    mod.bind(data_shapes=[DataDesc("data", (b, t), layout="NT")],
             label_shapes=[DataDesc("softmax_label", (b, t), layout="NT")])
    mod.init_params(arg_params=params, aux_params={})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": TRAIN_LR})
    with programs.eager():
        mod.forward_backward(batch)
        mod.update()
    mod.forward_backward(batch)      # the step program's set-up
    mod.update()
    counters = ((fk.LAUNCHES, "fused_fwd"), (fk.LAUNCHES, "fused_bwd"),
                (fl.LAUNCHES, "flash_fwd"), (fl.LAUNCHES, "flash_bwd_dq"),
                (fl.LAUNCHES, "flash_bwd_dkv"),
                (uk.LAUNCHES, "multi_tensor_update"))
    for d, name in counters:
        d[name] = 0
    graphs0 = dict(programs.GRAPH_STATS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        mod.forward_backward(batch)
        mod.update()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {name: d[name] for d, name in counters}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    graphs = _graph_delta(graphs0)
    want = {"fused_fwd": 5 * TRAIN_LAYERS, "fused_bwd": 5 * TRAIN_LAYERS,
            "flash_fwd": TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
            "flash_bwd_dkv": TRAIN_LAYERS, "multi_tensor_update": 1}
    reading_b = {"steps": TRAIN_STEPS, "step_s": step_s,
                 "recorded_step_s": RECORDED_STEP_S, "graph_stats": graphs,
                 "launches": launches, "launches_per_step": per_step,
                 "phase_train_step_s": train["step_s"],
                 "phase_train_grad_rel_err": train["grad_rel_err"],
                 "imperative_step_s": imp["step_s"],
                 "recorded_imperative_step_s": RECORDED_IMPERATIVE_STEP_S}
    log("analysis (b) train through the operators: "
        + json.dumps(reading_b))
    if per_step != want or graphs["captures"] != 0 \
            or graphs["replays"] != TRAIN_STEPS:
        raise AssertionError("the LM's captured steps through the "
                             "operators: %s (want %s a step, replays only)"
                             % (per_step, want))

    # (c) the full-width artifacts
    built = {}
    t0 = time.perf_counter()
    mod.score(NDArrayIter(x, y, batch_size=b),
              metric_mod.Perplexity(ignore_label=None))
    score_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    arts = mod.program_artifacts()
    trace_s = time.perf_counter() - t0
    if sorted(arts) != ["eval_step", "train_step"]:
        raise AssertionError("Module.program_artifacts: %s" % sorted(arts))
    train_art = arts.pop("train_step")
    train_art.name = "lm_train_step"
    eval_art = arts.pop("eval_step")
    eval_art.name = "lm_eval_step"
    built["lm_train_step"] = built["lm_eval_step"] = trace_s
    ops = analysis.kernel_ops(train_art)
    if ops != {k: int(v) for k, v in want.items()}:
        raise AssertionError("train_step's kernel nodes %s != its launches "
                             "a step %s" % (ops, want))
    roof = mod._train_step.roofline_static()["flops"]
    dots = {}
    for rec in train_art.parsed()["dots"]:
        dots[rec["op"]] = dots.get(rec["op"], 0) + rec["flops"]
    flops_line = {"train_step_dot_flops": train_art.parsed()["flops"],
                  "roofline_flops": roof,
                  "difference": train_art.parsed()["flops"] - roof,
                  "dot_flops_by_op": dots,
                  "roofline_counts": "3 x (2 M K N a FullyConnected / "
                                     "FusedLNLinear + 4 rows keys hd heads "
                                     "an attention)"}
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    ssym, sparams, _ = _lm(torch, dev)
    pred = _predictor(ssym, sparams, False, dev)
    serve_arts = []
    t0 = time.perf_counter()
    serve_arts.append(pred.prefill_artifact(1, CHUNK, name="serve_prefill"))
    built["serve_prefill"] = time.perf_counter() - t0
    state = pred.paged_batch_state(SLOTS)
    t0 = time.perf_counter()
    serve_arts.append(pred.decode_artifact(state,
                                           name="serve_paged_decode_step"))
    built["serve_paged_decode_step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_arts.append(pred.verify_artifact(state, SPEC_K,
                                           name="serve_paged_verify_step"))
    built["serve_paged_verify_step"] = time.perf_counter() - t0
    del pred, state
    for art in serve_arts:
        if analysis.kernel_ops(art).get("paged_decode") != LAYERS:
            raise AssertionError("%s holds %s, not one paged_decode a layer"
                                 % (art.name, analysis.kernel_ops(art)))
    full = [train_art, eval_art] + serve_arts
    report = analysis.run_passes(full, budgets=analysis.load_budgets())
    costs = {a.name: analysis.artifact_cost(a) for a in full}
    log("analysis (c) full-width artifacts: " + json.dumps({
        "costs": costs, "build_s": built, "score_s": score_s,
        "kernel_ops": {a.name: analysis.kernel_ops(a) for a in full},
        "summary": report.summary(),
        "unsuppressed": [str(f) for f in report.unsuppressed]}))
    log("analysis (c) train_step flops: " + json.dumps(flops_line))
    if report.errors:
        raise AssertionError("unsuppressed errors over the full-width "
                             "programs: %s" % [str(f) for f in report.errors])
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the CLI on the card: the canonical programs at the reference's
    # dims, built, audited and priced in a process of its own
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, os.path.join(root, "tools",
                                                       "mxlint_torch.py")],
                         capture_output=True, text=True, cwd=root,
                         timeout=900)
    lint_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError("tools/mxlint_torch.py on the card exited %d: "
                             "%s" % (out.returncode, out.stderr[-4000:]))
    line = json.loads(out.stdout.strip().splitlines()[-1])
    log("analysis (d) mxlint_torch: " + json.dumps(
        dict(line, wall_s=lint_s)))
    if line["errors"] != 0 or line["skipped_programs"] != ANALYSIS_NOTES \
            or line["programs"] != 11:
        raise AssertionError("tools/mxlint_torch.py on the card: %s" % line)
    for name in ("paged_decode_step", "paged_verify_step",
                 "gqa_decode_step"):
        if not line["kernel_ops"][name].get("paged_decode"):
            raise AssertionError("%s holds no paged_decode: %s"
                                 % (name, line["kernel_ops"][name]))
    log("analysis: %.1f s" % (time.perf_counter() - t_phase))
    return launches


# phase 20, data parallel: DP_STEPS timed steps of (b) and (c) after one
# warm-up (or set-up) step; (d) runs DP_RANKS ranks of this script on the
# one card over gloo, phase 6's LM cut to DP_RANK_LAYERS layer(s) for
# time, DP_RANK_STEPS steps, each rank DP_RANK_BATCH sequences of the
# global batch (phase 6's batch of 8); the ranks' bandwidth rows at
# DP_BANDWIDTH_MIB
DP_STEPS = 3
DP_RANKS, DP_RANK_LAYERS, DP_RANK_STEPS, DP_RANK_BATCH = 2, 1, 2, 4
DP_BANDWIDTH_MIB = (1, 16, 64, 128)
DP_RANK_TIMEOUT = 300
DP_DIRECT_1 = ("head_", "final_", "layer%d_ffn2_" % (DP_RANK_LAYERS - 1))


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def _all_reduce_timer(torch):
    """``collectives.global_sum`` synchronized and timed while the block
    runs (the store's one collective a push); yields the running
    ``{"calls", "bytes", "s"}``."""
    from mxnet_tpu_torch.parallel import collectives

    acc = {"calls": 0, "bytes": 0, "s": 0.0}
    real = collectives.global_sum

    def timed(value):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(value)
        torch.cuda.synchronize()
        acc["s"] += time.perf_counter() - t0
        acc["calls"] += 1
        acc["bytes"] += value.numel() * value.element_size()
        return out

    collectives.global_sum = timed
    try:
        yield acc
    finally:
        collectives.global_sum = real


def _dp_store(torch, dev):
    """(a): the NCCL group from the DMLC_* variables, a dist_sync store's
    sums and updater on CUDA tensors."""
    import torch.distributed as dist

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel import launch

    env = {"DMLC_PS_ROOT_URI": "127.0.0.1",
           "DMLC_PS_ROOT_PORT": str(_free_port()), "DMLC_NUM_WORKER": "1",
           "DMLC_WORKER_ID": "0"}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        launch.init()
        init_s = time.perf_counter() - t0
    finally:
        for k in env:
            os.environ.pop(k)
    group = {"backend": dist.get_backend(),
             "world": dist.get_world_size(), "rank": dist.get_rank(),
             "init_s": init_s}
    if group["backend"] != "nccl" or group["world"] != 1:
        raise AssertionError("the group from the DMLC_* variables: %s"
                             % group)
    ctx = mt.gpu(0)
    kv = mt.kvstore.create("dist_sync")
    shapes = {3: (4, 5), "big": (30, 10), 9: (2,)}
    for key, shape in shapes.items():
        kv.init(key, mt.nd.zeros(shape, ctx))
    exact = True
    for step in range(3):
        for key, shape in shapes.items():
            # rank r pushes (r + 1) * (step + 1): at a world of one the
            # global sum is step + 1
            kv.push(key, mt.nd.full(shape, float(step + 1), ctx))
            out = mt.nd.zeros(shape, ctx)
            kv.pull(key, out=out)
            exact &= out.data.device == dev and bool(torch.equal(
                out.data, torch.full(shape, float(step + 1), device=dev)))
    kv2 = mt.kvstore.create("dist_sync")
    kv2.set_optimizer(mt.optimizer.SGD(learning_rate=0.5, rescale_grad=1.0))
    kv2.init(0, mt.nd.full((3, 3), 10.0, ctx))
    kv2.push(0, mt.nd.full((3, 3), 1.0, ctx))
    out = mt.nd.zeros((3, 3), ctx)
    kv2.pull(0, out=out)
    updated = [float(out.data.max()), float(out.data.min())]
    reading = dict(group, sums_exact=exact, updater=updated,
                   updater_want=9.5, types=[kv.type, kv2.type],
                   num_workers=kv.num_workers)
    log("dp (a) store: " + json.dumps(reading))
    if not exact or updated != [9.5, 9.5]:
        raise AssertionError("the dist_sync store on NCCL: %s" % reading)
    return reading


def _lm_loss_metric(torch, labels):
    """A metric for fit that keeps each step's mean -log p(label) on the
    card (the host Accuracy would copy the (B * T, V) output to the host
    every step)."""
    from mxnet_tpu_torch import metric as metric_mod

    class LMLoss(metric_mod.EvalMetric):
        def __init__(self):
            super().__init__("lm_loss")
            self.losses = []

        def update(self, _, preds):
            p = preds[0].data.gather(1, labels)
            self.losses.append(-torch.log(torch.clamp_min(p, 1e-30)).mean())

    return LMLoss()


def _dp_fit(torch, dev, sym, params, x, y, kvstore, eager=False):
    """One epoch of fit over the repeated batch (1 + DP_STEPS steps):
    the module, the seconds of each step after the first (callbacks
    synchronized), the seconds in each such step's update (synchronized
    around it), the launches of the epoch and the losses."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import config

    b = x.shape[0]
    reps = 1 + DP_STEPS
    it = mt.io.NDArrayIter(np.concatenate([x] * reps),
                           np.concatenate([y] * reps), batch_size=b)
    labels = torch.from_numpy(y.reshape(-1)).long().to(dev)[:, None]
    metric = _lm_loss_metric(torch, labels)
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    stamps, update_s = [], []
    real_update = mod.update

    def timed_update():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_update()
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t0)

    mod.update = timed_update

    def stamp(_):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    with config.overrides(MXNET_FUSED_TRAIN_STEP=not eager):
        _resume_counts(zero=True)
        mod.fit(it, eval_metric=metric, batch_end_callback=stamp,
                kvstore=kvstore, optimizer="sgd",
                optimizer_params={"learning_rate": TRAIN_LR},
                arg_params=params, aux_params={}, num_epoch=1)
        torch.cuda.synchronize()
        launches = _resume_counts()
    steps = [t1 - t0 for t0, t1 in zip(stamps, stamps[1:])]
    losses = [float(v) for v in metric.losses]
    return mod, steps, update_s[1:], launches, losses


def _dp_train(torch, dev):
    """(b): the LM through fit(kvstore="dist_sync") on the NCCL group,
    against two eager kvstore="local" runs (no store: one context)."""
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.ops import update_kernel as uk

    b, t = TRAIN_BATCH, SEQ
    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=t,
                                  num_layers=TRAIN_LAYERS, embed=EMBED,
                                  heads=TRAIN_HEADS, ffn_hidden=FFN)
    params = _train_params(sym)
    rng = np.random.RandomState(1)
    x = rng.randint(0, VOCAB, size=(b, t)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((b, 1), np.float32)], axis=1)
    start = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}
    graphs0 = dict(programs.GRAPH_STATS)
    uk.UPDATE_PATH["last"] = None
    torch.cuda.reset_peak_memory_stats()
    mod, steps, update_s, launches, losses = _dp_fit(
        torch, dev, sym, params, x, y, "dist_sync")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    graphs = _graph_delta(graphs0)
    path = {"kvstore": mod._kvstore.type,
            "update_on_kvstore": mod._update_on_kvstore,
            "train_step": mod._train_step is not None,
            "rescale_grad": mod._optimizer.rescale_grad,
            "b1_path": uk.UPDATE_PATH["last"]}
    dist_snap = _snapshot(mod)
    # one more step, after the snapshot: its update with every
    # all-reduce synchronized and timed alone
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch

    mod.forward_backward(DataBatch([nd.array(x)], [nd.array(y)]))
    torch.cuda.synchronize()
    with _all_reduce_timer(torch) as ar:
        t0 = time.perf_counter()
        mod.update()
        torch.cuda.synchronize()
        breakdown = {"update_s": time.perf_counter() - t0,
                     "all_reduce_s": ar["s"],
                     "all_reduce_calls": ar["calls"],
                     "all_reduce_bytes": ar["bytes"]}
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    local_snaps, local_steps, local_update, local_losses = [], [], [], []
    for _ in range(2):
        lmod, lsteps, lupdate, _, llosses = _dp_fit(
            torch, dev, sym, params, x, y, "local", eager=True)
        if lmod._kvstore is not None or lmod._train_step is not None:
            raise AssertionError("the eager local reference took a store "
                                 "or a train step")
        local_snaps.append(_snapshot(lmod))
        local_steps.append(lsteps)
        local_update.append(lupdate)
        local_losses.append(llosses)
        del lmod
        gc.collect()
        torch.cuda.empty_cache()
    vs_local = _run_diff(torch, dist_snap, local_snaps[0], start, _DIRECT)
    spread = _run_diff(torch, local_snaps[1], local_snaps[0], start, _DIRECT)
    del dist_snap, local_snaps, start
    per_step = {k: v / (1 + DP_STEPS) for k, v in launches.items()}
    segments = 5 * TRAIN_LAYERS
    want = {"fused_fwd": segments, "fused_bwd": segments,
            "flash_fwd": TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
            "flash_bwd_dkv": TRAIN_LAYERS, "multi_tensor_update": 0}
    step_s = sum(steps) / len(steps)
    local_step_s = sum(local_steps[0]) / len(local_steps[0])
    reading = {
        "config": "train-f32 (phase 6's LM), fit(kvstore='dist_sync'), "
                  "NCCL world 1",
        "path": path, "steps": DP_STEPS, "step_s": step_s,
        "step_s_each": steps, "tokens_per_s": b * t / step_s,
        "update_s": sum(update_s) / len(update_s),
        "update_share": sum(update_s) / sum(steps),
        "update_breakdown_synchronized": breakdown,
        "local_eager_step_s": local_step_s,
        "local_eager_step_s_each": local_steps,
        "local_eager_update_s": sum(local_update[0]) / len(local_update[0]),
        "vs_local_eager_step": step_s / local_step_s,
        "pushed_values": sum(int(np.prod(v.shape)) for v in params.values()),
        "losses": losses, "local_losses": local_losses[0],
        "launches": launches, "launches_per_step": per_step,
        "graph_stats": graphs, "peak_memory_gb": peak_gb,
        "vs_local": vs_local, "local_spread": spread,
        "max_over_spread": CAPTURE_SPREAD}
    log("dp (b) train dist_sync: " + json.dumps(reading))
    if per_step != want or path["update_on_kvstore"] is not True \
            or path["train_step"] or path["kvstore"] != "dist_sync" \
            or path["b1_path"] is not None or graphs["captures"] != 0:
        raise AssertionError("the dist_sync fit did not take the eager "
                             "kvstore path with %s launches a step: %s"
                             % (want, reading))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("the dist_sync loss did not fall: %s" % losses)
    if any(vs_local["tiers"][tier]["max"]
           > CAPTURE_SPREAD * max(spread["tiers"][tier]["max"], 1e-7)
           for tier in ("before_relu", "behind_relu")):
        raise AssertionError("the dist_sync parameters against the eager "
                             "local run, beyond two local runs' own "
                             "spread: %s" % reading)
    return reading, launches, sym, params, x, y


def _dp_two_contexts(torch, dev, sym, params, x, y, train):
    """(c): context=[gpu(0), gpu(0)], kvstore="device": one executor,
    the compiled step, B1 once a step."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.io import DataBatch, DataDesc

    b, t = x.shape
    mod = mt.mod.Module(sym, context=[mt.gpu(0), mt.gpu(0)])
    mod.bind(data_shapes=[DataDesc("data", (b, t), layout="NT")],
             label_shapes=[DataDesc("softmax_label", (b, t), layout="NT")])
    mod.init_params(arg_params=params, aux_params={})
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params={"learning_rate": TRAIN_LR})
    step = mod._train_step
    path = {"contexts": [str(c) for c in mod._contexts],
            "kvstore": mod._kvstore.type,
            "update_on_kvstore": mod._update_on_kvstore,
            "train_step": step is not None,
            "plan": step is not None and step.plan is not None}
    batch = DataBatch([nd.array(x)], [nd.array(y)])
    graphs0 = dict(programs.GRAPH_STATS)
    mod.forward_backward(batch)     # set-up: a warm-up run and the capture
    mod.update()
    torch.cuda.synchronize()
    _resume_counts(zero=True)
    t0 = time.perf_counter()
    for _ in range(DP_STEPS):
        mod.forward_backward(batch)
        mod.update()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _resume_counts()
    graphs = _graph_delta(graphs0)
    per_step = {k: v / DP_STEPS for k, v in launches.items()}
    step_s = wall / DP_STEPS
    reading = {"path": path, "steps": DP_STEPS, "step_s": step_s,
               "phase6_captured_step_s": train["step_s"],
               "vs_phase6": step_s / train["step_s"],
               "tokens_per_s": b * t / step_s, "launches": launches,
               "launches_per_step": per_step, "graph_stats": graphs}
    log("dp (c) two contexts of one card: " + json.dumps(reading))
    if per_step["multi_tensor_update"] != 1 or not path["plan"] \
            or path["update_on_kvstore"] is not False \
            or graphs["captures"] != 1 or graphs["replays"] != DP_STEPS:
        raise AssertionError("the two-context module did not take the "
                             "compiled step with B1 once a step: %s"
                             % reading)
    del mod, step
    gc.collect()
    torch.cuda.empty_cache()
    return reading, launches


def _dp_rank_sym_params():
    from mxnet_tpu_torch.models import attention_lm

    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=SEQ,
                                  num_layers=DP_RANK_LAYERS, embed=EMBED,
                                  heads=TRAIN_HEADS, ffn_hidden=FFN)
    return sym, _train_params(sym)


def _dp_global_batch():
    rng = np.random.RandomState(2)
    x = rng.randint(0, VOCAB, size=(DP_RANKS * DP_RANK_BATCH, SEQ)).astype(
        np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((len(x), 1), np.float32)],
                       axis=1)
    return x, y


def _dp_module(sym, params, b, kvstore):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.io import DataDesc

    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[DataDesc("data", (b, SEQ), layout="NT")],
             label_shapes=[DataDesc("softmax_label", (b, SEQ),
                                    layout="NT")])
    mod.init_params(arg_params=params, aux_params={})
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": TRAIN_LR})
    return mod


def _dp_rank_main(rank, world, address, outdir):
    """One rank of (d): its half of the global batch, DP_RANK_STEPS
    dist_sync steps over gloo (each all-reduce synchronized and timed),
    then the bandwidth rows; writes its parameters and reading to
    ``outdir``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import bandwidth_torch

    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    launch.init(address, world, rank, backend="gloo")
    init_s = time.perf_counter() - t0
    sym, params = _dp_rank_sym_params()
    x, y = _dp_global_batch()
    sl = slice(rank * DP_RANK_BATCH, (rank + 1) * DP_RANK_BATCH)
    mod = _dp_module(sym, params, DP_RANK_BATCH, "dist_sync")
    batch = DataBatch([nd.array(x[sl])], [nd.array(y[sl])])
    _resume_counts(zero=True)
    steps = []
    with _all_reduce_timer(torch) as ar:
        for _ in range(DP_RANK_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t1)
    launches = _resume_counts()
    torch.save({k: v.cpu() for k, v in _snapshot(mod).items()},
               os.path.join(outdir, "rank%d.pt" % rank))
    # the bandwidth rows on the device the rank trains on
    dev = mod._exec_group.param_arrays[0].data.device
    rows = bandwidth_torch.measure(DP_BANDWIDTH_MIB, dev, iters=3)
    reading = {"rank": rank, "world": world, "backend": "gloo",
               "init_s": init_s, "step_s_each": steps,
               "rescale_grad": mod._optimizer.rescale_grad,
               "update_on_kvstore": mod._update_on_kvstore,
               "all_reduce_calls_per_step": ar["calls"] / DP_RANK_STEPS,
               "all_reduce_bytes_per_step": ar["bytes"] / DP_RANK_STEPS,
               "all_reduce_s_per_step": ar["s"] / DP_RANK_STEPS,
               "launches": launches, "bandwidth": rows}
    with open(os.path.join(outdir, "rank%d.json" % rank), "w") as f:
        json.dump(reading, f)
    launch.shutdown()
    print("DP_RANK_%d_OK" % rank, flush=True)
    return 0


def _dp_single(torch, sym, params, x, y):
    """A single-process eager run of DP_RANK_STEPS steps over the global
    batch (one context: no store), (d)'s reference."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch

    with config.overrides(MXNET_FUSED_TRAIN_STEP=False):
        mod = _dp_module(sym, params, len(x), "local")
    batch = DataBatch([nd.array(x)], [nd.array(y)])
    for _ in range(DP_RANK_STEPS):
        mod.forward_backward(batch)
        mod.update()
    torch.cuda.synchronize()
    snap = _snapshot(mod)
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    return snap


def _dp_ranks(torch, dev):
    """(d): DP_RANKS processes of this script on the one card over gloo
    against single-process runs over the concatenated global batch."""
    outdir = tempfile.mkdtemp(prefix="mx_smoke_dp_")
    try:
        address = "127.0.0.1:%d" % _free_port()
        here = os.path.abspath(__file__)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, here, "--dp-rank", str(r), str(DP_RANKS),
             address, outdir], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(here)) for r in range(DP_RANKS)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=DP_RANK_TIMEOUT)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or "DP_RANK_%d_OK" % r not in out:
                raise AssertionError("rank %d of (d) exited %s:\n%s"
                                     % (r, p.returncode, out[-6000:]))
        ranks, snaps = [], []
        for r in range(DP_RANKS):
            with open(os.path.join(outdir, "rank%d.json" % r)) as f:
                ranks.append(json.load(f))
            snaps.append({k: v.to(dev) for k, v in torch.load(
                os.path.join(outdir, "rank%d.pt" % r)).items()})
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    unequal = sorted(n for n in snaps[0]
                     if not torch.equal(snaps[0][n], snaps[1][n]))
    sym, params = _dp_rank_sym_params()
    x, y = _dp_global_batch()
    start = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}
    t1 = time.perf_counter()
    single = _dp_single(torch, sym, params, x, y)
    # the same global sum in another order: the halves swapped
    half = DP_RANK_BATCH
    single_swapped = _dp_single(
        torch, sym, params, np.concatenate([x[half:], x[:half]]),
        np.concatenate([y[half:], y[:half]]))
    single_s = time.perf_counter() - t1
    vs_single = _run_diff(torch, snaps[0], single, start, DP_DIRECT_1)
    spread = _run_diff(torch, single_swapped, single, start, DP_DIRECT_1)
    del snaps, single, single_swapped, start
    reading = {
        "config": "phase 6's LM cut to %d layer(s), %d ranks x batch %d "
                  "over gloo on one card, %d steps"
                  % (DP_RANK_LAYERS, DP_RANKS, DP_RANK_BATCH,
                     DP_RANK_STEPS),
        "ranks_wall_s": wall, "single_runs_s": single_s,
        "ranks_bitwise_equal": not unequal, "unequal": unequal[:6],
        "vs_single": vs_single, "single_order_spread": spread,
        "max_over_spread": CAPTURE_SPREAD,
        "ranks": [{k: v for k, v in rd.items() if k != "bandwidth"}
                  for rd in ranks]}
    log("dp (d) two ranks over gloo: " + json.dumps(reading))
    for rd in ranks:
        log("dp (d) bandwidth rank %d (gloo, CUDA tensors): %s"
            % (rd["rank"], json.dumps(rd["bandwidth"])))
    if unequal or any(rd["rescale_grad"] != 1.0 / (DP_RANKS * DP_RANK_BATCH)
                      for rd in ranks):
        raise AssertionError("the ranks' parameters differ: %s" % reading)
    if any(vs_single["tiers"][tier]["max"]
           > CAPTURE_SPREAD * max(spread["tiers"][tier]["max"], 1e-7)
           for tier in ("before_relu", "behind_relu")):
        raise AssertionError("the ranks against the single-process run, "
                             "beyond its own spread under a reordered "
                             "batch: %s" % reading)
    return reading


def phase_data_parallel(torch, dev, train):
    """Phase 20 (see the module's docstring): (a) the store on NCCL,
    (b) the LM through fit(kvstore="dist_sync"), (c) two contexts of one
    card, (d) two ranks over gloo.  Returns the launches of (b) and
    (c)."""
    from mxnet_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    try:
        store = _dp_store(torch, dev)
        dist_reading, dist_launches, sym, params, x, y = _dp_train(torch,
                                                                   dev)
    finally:
        launch.shutdown()
    two, two_launches = _dp_two_contexts(torch, dev, sym, params, x, y,
                                         train)
    del sym, params
    gc.collect()
    torch.cuda.empty_cache()
    ranks = _dp_ranks(torch, dev)
    log("dp: " + json.dumps({
        "card": _smi_line(), "wall_s": time.perf_counter() - t0,
        "nccl_init_s": store["init_s"],
        "dist_step_s": dist_reading["step_s"],
        "dist_update_share": dist_reading["update_share"],
        "local_eager_step_s": dist_reading["local_eager_step_s"],
        "two_context_step_s": two["step_s"],
        "phase6_captured_step_s": train["step_s"],
        "ranks_step_s": [r["step_s_each"] for r in ranks["ranks"]],
        "ranks_all_reduce_s_per_step": [
            r["all_reduce_s_per_step"] for r in ranks["ranks"]],
        "ranks_all_reduce_bytes_per_step": [
            r["all_reduce_bytes_per_step"] for r in ranks["ranks"]]}))
    return {"dist": dist_launches, "dist_two_context": two_launches}


# ---------------------------------------------------------------------------
# phase 21: tensor and model parallelism, the C ABI, serving_avals
# ---------------------------------------------------------------------------
TP_RANKS, TP_LAYERS, TP_STEPS = 2, 1, 2
TP_RANK_TIMEOUT = 400
TP_DIRECT = ("head_", "final_", "layer%d_ffn2_" % (TP_LAYERS - 1))
LSTM_MP = dict(seq_len=12, vocab=200, num_embed=32, num_hidden=64,
               num_layers=2, batch_size=16, num_batches=30, lr=0.5)


def _tp_sym_params():
    from mxnet_tpu_torch.models import attention_lm

    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=SEQ,
                                  num_layers=TP_LAYERS, embed=EMBED,
                                  heads=TRAIN_HEADS, ffn_hidden=FFN)
    params = _train_params(sym)
    # biases, LN betas and gammas moved off their initial 0 / 1, so a
    # bias or an affine applied on the wrong ranks changes the first
    # step (tools/tp_gate_controls.py plants such faults)
    rng = np.random.RandomState(21)
    for name in sorted(params):
        if name.endswith(("_bias", "_beta", "_gamma")):
            params[name] = (params[name] + rng.normal(
                0.0, 0.02, params[name].shape)).astype(np.float32)
    return sym, params


def _tp_batch():
    rng = np.random.RandomState(5)
    x = rng.randint(0, VOCAB, size=(TRAIN_BATCH, SEQ)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((len(x), 1), np.float32)],
                       axis=1)
    return x, y


def _tp_rank_main(rank, world, address, outdir):
    """One rank of phase 21 (a): the LM at a model axis of ``world``
    over gloo on the shared card, TP_STEPS steps of ``Module.fit``; each
    step's launches, collectives and seconds, the peak memory, and (rank
    0) the gathered parameters, written to ``outdir``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.io import DataDesc
    from mxnet_tpu_torch.parallel import MeshConfig, collectives, launch

    t0 = time.perf_counter()
    launch.init(address, world, rank, backend="gloo")
    init_s = time.perf_counter() - t0
    sym, params = _tp_sym_params()
    x, y = _tp_batch()
    mod = mt.mod.Module(sym, context=mt.gpu(0),
                        mesh_config=MeshConfig(data=1, model=world))
    mod.bind(data_shapes=[DataDesc("data", (TRAIN_BATCH, SEQ),
                                   layout="NT")],
             label_shapes=[DataDesc("softmax_label", (TRAIN_BATCH, SEQ),
                                    layout="NT")])
    mod.init_params(arg_params=params, aux_params={})
    exe = mod._exec_group.exec_
    a_widths = {n: list(exe.arg_dict[n].shape) for n in sorted(
        exe.arg_dict) if n.endswith("_weight") and n.startswith("layer")}
    it = mt.io.NDArrayIter(np.tile(x, (TP_STEPS, 1)),
                           np.tile(y, (TP_STEPS, 1)),
                           batch_size=TRAIN_BATCH)
    labels = torch.from_numpy(y.reshape(-1, 1)).long().cuda()
    metric = _lm_loss_metric(torch, labels)
    steps = []
    collectives.SYNC_TIMING = True
    torch.cuda.reset_peak_memory_stats()

    def begin():
        torch.cuda.synchronize()
        collectives.reset_counts()
        return _resume_counts(zero=True), time.perf_counter()

    state = {"mark": begin()}

    snaps = []

    def on_batch(param):
        torch.cuda.synchronize()
        _, t_start = state["mark"]
        steps.append({"s": time.perf_counter() - t_start,
                      "launches": _resume_counts(),
                      "collectives": {k: dict(v) for k, v in
                                      collectives.COUNTS.items()}})
        # the gathered parameters after this step (a collective of both
        # ranks, outside the step's counts and seconds)
        arg, _ = mod.get_params()
        snaps.append({k: v.data.clone() for k, v in arg.items()})
        state["mark"] = begin()

    mod.fit(it, eval_metric=metric, batch_end_callback=on_batch,
            optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN_LR}, num_epoch=1)
    collectives.SYNC_TIMING = False
    peak = torch.cuda.max_memory_allocated()
    if rank == 0:
        torch.save(snaps, os.path.join(outdir, "tp_params.pt"))
    reading = {"rank": rank, "world": world, "backend": "gloo",
               "init_s": init_s, "steps": steps,
               "losses": [float(v) for v in metric.losses],
               "peak_bytes": peak, "local_weight_shapes": a_widths,
               "train_step": mod._train_step is not None,
               "sharded": dict(mod._exec_group.tp.sharded)}
    with open(os.path.join(outdir, "tp_rank%d.json" % rank), "w") as f:
        json.dump(reading, f)
    launch.shutdown()
    print("TP_RANK_%d_OK" % rank, flush=True)
    return 0


def _tp_single(torch, sym, params, x, y, plain=False):
    """A single-process eager run of TP_STEPS steps (one card, no mesh;
    ``plain``: every kernel's plain version), (a)'s reference: the
    parameters after each step."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch, DataDesc

    with config.overrides(MXNET_FUSED_TRAIN_STEP=False):
        mod = mt.mod.Module(sym, context=mt.gpu(0), plain=plain)
        mod.bind(data_shapes=[DataDesc("data", x.shape, layout="NT")],
                 label_shapes=[DataDesc("softmax_label", y.shape,
                                        layout="NT")])
        mod.init_params(arg_params=params, aux_params={})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": TRAIN_LR})
    batch = DataBatch([nd.array(x)], [nd.array(y)])
    snaps = []
    for _ in range(TP_STEPS):
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        snaps.append({k: v for k, v in _snapshot(mod).items()
                      if not k.startswith("aux:")})
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    return snaps


def _tp_measure(torch, dev):
    """(a)'s runs: TP_RANKS processes of this script on the one card over
    gloo, a model axis of TP_RANKS, and the single-process eager runs
    they are held against.  Returns the logged reading and the ranks'
    own readings."""
    outdir = tempfile.mkdtemp(prefix="mx_smoke_tp_")
    try:
        address = "127.0.0.1:%d" % _free_port()
        here = os.path.abspath(__file__)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, here, "--tp-rank", str(r), str(TP_RANKS),
             address, outdir], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(here)) for r in range(TP_RANKS)]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=TP_RANK_TIMEOUT)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or "TP_RANK_%d_OK" % r not in out:
                raise AssertionError("rank %d of phase 21 (a) exited %s:\n%s"
                                     % (r, p.returncode, out[-6000:]))
        ranks = []
        for r in range(TP_RANKS):
            with open(os.path.join(outdir, "tp_rank%d.json" % r)) as f:
                ranks.append(json.load(f))
        got = [{k: v.to(dev) for k, v in snap.items()} for snap in
               torch.load(os.path.join(outdir, "tp_params.pt"))]
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    sym, params = _tp_sym_params()
    x, y = _tp_batch()
    start = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}
    t1 = time.perf_counter()
    single = _tp_single(torch, sym, params, x, y)
    again = _tp_single(torch, sym, params, x, y)
    # the same sums in another order: the batch halves swapped
    half = TRAIN_BATCH // 2
    swapped = _tp_single(torch, sym, params,
                         np.concatenate([x[half:], x[:half]]),
                         np.concatenate([y[half:], y[:half]]))
    # the kernels' plain versions: the same sums in the order PyTorch's
    # reductions take (the LN gammas' gradients are sums over 16,384
    # rows that nearly cancel, so any other order moves them)
    plain = _tp_single(torch, sym, params, x, y, plain=True)
    single_s = time.perf_counter() - t1
    by_step = []
    for i in range(TP_STEPS):
        by_step.append({
            "step": i + 1,
            "vs_single": _run_diff(torch, got[i], single[i], start,
                                   TP_DIRECT)["tiers"],
            "atomics_spread": _run_diff(torch, again[i], single[i], start,
                                        TP_DIRECT)["tiers"],
            "reorder_spread": _run_diff(torch, swapped[i], single[i], start,
                                        TP_DIRECT)["tiers"],
            "plain_spread": _run_diff(torch, plain[i], single[i], start,
                                      TP_DIRECT)["tiers"]})
    def rel(a, b):
        return {n: float(torch.linalg.vector_norm((a[n] - w).double()))
                / max(float(torch.linalg.vector_norm(
                    (w - start[n]).double())), 1e-30)
                for n, w in b.items()}

    by_step[0]["tensors"] = {"vs_single": rel(got[0], single[0]),
                             "plain": rel(plain[0], single[0])}
    vs_single = _run_diff(torch, got[-1], single[-1], start, TP_DIRECT)
    spread = _run_diff(torch, swapped[-1], single[-1], start, TP_DIRECT)
    del got, single, again, swapped, plain, start
    gc.collect()
    torch.cuda.empty_cache()
    per_rank = []
    for rd in ranks:
        timed = rd["steps"][1:] or rd["steps"]
        n = len(timed)
        kinds = sorted({k for s in timed for k in s["collectives"]})
        per_rank.append({
            "rank": rd["rank"],
            "launches_per_step": {k: sum(s["launches"][k] for s in timed)
                                  / n for k in timed[0]["launches"]},
            "collectives_per_step": {k: {
                f: sum(s["collectives"].get(k, {}).get(f, 0)
                       for s in timed) / n for f in ("calls", "bytes", "s")}
                for k in kinds},
            "step_s": [s["s"] for s in rd["steps"]],
            "peak_bytes": rd["peak_bytes"], "losses": rd["losses"],
            "init_s": rd["init_s"],
            "local_weight_shapes": rd["local_weight_shapes"]})
    reading = {
        "card": _smi_line(),
        "config": "phase 6's LM (vocab %d, T %d, batch %d, embed %d, %d "
                  "heads, FFN %d, f32, SGD lr %g) cut to %d layer(s), "
                  "MeshConfig(data=1, model=%d): %d ranks over gloo on "
                  "one card, %d fit steps"
                  % (VOCAB, SEQ, TRAIN_BATCH, EMBED, TRAIN_HEADS, FFN,
                     TRAIN_LR, TP_LAYERS, TP_RANKS, TP_RANKS, TP_STEPS),
        "ranks_wall_s": wall, "single_runs_s": single_s,
        "vs_single": vs_single, "single_order_spread": spread,
        "by_step": by_step,
        "max_over_spread": CAPTURE_SPREAD, "ranks": per_rank}
    log("tp (a) LM over a model axis of %d: %s" % (TP_RANKS,
                                                   json.dumps(reading)))
    return reading, ranks


def _tp_spread_bound(step, tier):
    """(a)'s bound at one step and tier: CAPTURE_SPREAD times the widest
    of the single-process spreads (the same run again: F's atomics; the
    batch halves swapped; the plain versions, whose sums in another
    order move the ReLU masks as the row-parallel sums do)."""
    return CAPTURE_SPREAD * max(1e-7, *(step[k][tier]["max"] for k in (
        "atomics_spread", "reorder_spread", "plain_spread")))


def _tp_gate(reading, ranks):
    """(a)'s checks, the list of what failed (empty: passed): A / F at 5
    a step, C / D / E at 1 and B1 at 1 (one f32 slab) on every rank, the
    eager path, finite losses, the shard widths, and every step's
    parameters within the spread bound in each tier."""
    failed = []
    want = {"fused_fwd": 5 * TP_LAYERS, "fused_bwd": 5 * TP_LAYERS,
            "flash_fwd": TP_LAYERS, "flash_bwd_dq": TP_LAYERS,
            "flash_bwd_dkv": TP_LAYERS, "multi_tensor_update": 1}
    for rd in ranks:
        for s in rd["steps"]:
            got_l = {k: s["launches"][k] for k in want}
            if got_l != want:
                failed.append("rank %d launched %s a step, want %s"
                              % (rd["rank"], got_l, want))
        if rd["train_step"] or not all(np.isfinite(rd["losses"])):
            failed.append("rank %d: captured step %s, losses %s"
                          % (rd["rank"], rd["train_step"], rd["losses"]))
        shapes = rd["local_weight_shapes"]
        if shapes["layer0_q_weight"] != [EMBED // TP_RANKS, EMBED] \
                or shapes["layer0_ffn1_weight"] != [FFN // TP_RANKS, EMBED] \
                or shapes["layer0_ffn2_weight"] != [EMBED, FFN // TP_RANKS]:
            failed.append("rank %d's shards: %s" % (rd["rank"], shapes))
    for st in reading["by_step"]:
        for tier in ("before_relu", "behind_relu"):
            got = st["vs_single"][tier]
            bound = _tp_spread_bound(st, tier)
            if got["max"] > bound:
                failed.append(
                    "step %d %s: the ranks %.6g (%s) against the single-"
                    "process run, beyond the bound %.6g"
                    % (st["step"], tier, got["max"], got["tensor"], bound))
    return failed


def _tp_ranks(torch, dev):
    """(a): the runs, their gate, and the launches of both ranks."""
    reading, ranks = _tp_measure(torch, dev)
    failed = _tp_gate(reading, ranks)
    if failed:
        raise AssertionError("phase 21 (a): " + "; ".join(failed))
    launches = {k: sum(s["launches"][k] for rd in ranks
                       for s in rd["steps"])
                for k in ranks[0]["steps"][0]["launches"]}
    return reading, launches


def _mp_lstm(mt, g2c):
    """``examples/model_parallel_lstm.py``'s net (``build_lstm``) with the
    port's symbols: embed and decode on the card, the layers alternating
    between the host and the card."""
    c = LSTM_MP
    sym = mt.sym
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    with mt.AttrScope(ctx_group="embed"):
        hidden = sym.Embedding(data, input_dim=c["vocab"],
                               output_dim=c["num_embed"], name="embed")
    for layer in range(c["num_layers"]):
        with mt.AttrScope(ctx_group="layer%d" % layer):
            cell = mt.rnn.LSTMCell(c["num_hidden"],
                                   prefix="lstm_l%d_" % layer)
            hidden, _ = cell.unroll(c["seq_len"], inputs=hidden,
                                    layout="NTC", merge_outputs=True)
    with mt.AttrScope(ctx_group="decode"):
        pred = sym.Reshape(hidden, shape=(-1, c["num_hidden"]))
        pred = sym.FullyConnected(pred, num_hidden=c["vocab"],
                                  name="decode")
        flat = sym.Reshape(label, shape=(-1,))
        net = sym.SoftmaxOutput(pred, flat, name="softmax")
    return net


def _mp_lstm_phase(torch, dev):
    """(b): group2ctx on the card.  The model-parallel LSTM's forward and
    backward against an all-card bind (1e-5 relative), then the
    example's 30 batches: the loss falls; the cross-device copies a
    step."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import executor as ex

    c = LSTM_MP
    g2c = {"embed": mt.gpu(0), "decode": mt.gpu(0)}
    for layer in range(c["num_layers"]):
        g2c["layer%d" % layer] = (mt.cpu(0), mt.gpu(0))[layer % 2]
    net = _mp_lstm(mt, g2c)
    shapes = {"data": (c["batch_size"], c["seq_len"]),
              "softmax_label": (c["batch_size"], c["seq_len"])}
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = net.infer_shape(**shapes)
    init = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        # the example's Xavier (uniform, magnitude 3, factor avg); biases 0
        bound = np.sqrt(6.0 / (s[0] + s[1])) if len(s) == 2 else 0.0
        init[n] = rng.uniform(-bound, bound, s).astype(np.float32)

    def markov():
        x = np.empty(shapes["data"], np.float32)
        x[:, 0] = rng.randint(1, c["vocab"], c["batch_size"])
        for t in range(1, c["seq_len"]):
            x[:, t] = (x[:, t - 1] * 31 + 7) % c["vocab"]
            x[:, t][x[:, t] == 0] = 1
        return x, np.roll(x, -1, axis=1)

    exes = {}
    for key, mapping in (("placed", g2c), ("card", None)):
        exe = net.simple_bind(mt.gpu(0), grad_req="write",
                              group2ctx=mapping, **shapes)
        for n, v in init.items():
            exe.arg_dict[n][:] = v
        exes[key] = exe
    placed_devices = sorted({str(a.data.device) for a in
                             exes["placed"].arg_dict.values()})
    x, y = markov()
    outs = {}
    for key, exe in exes.items():
        exe.arg_dict["data"][:] = x
        exe.arg_dict["softmax_label"][:] = y
        ex.CROSS_DEVICE.update(copies=0, bytes=0)
        exe.forward(is_train=True)
        exe.backward()
        torch.cuda.synchronize()
        outs[key] = ([exe.outputs[0].data.float().cpu()]
                     + [exe.grad_dict[n].data.float().cpu()
                        for n in sorted(init)], dict(ex.CROSS_DEVICE))
    rel = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
              for g, w in zip(outs["placed"][0], outs["card"][0]))
    copies = outs["placed"][1]
    # the example's loop on the placed executor
    exe = exes["placed"]
    opt = mt.optimizer.SGD(learning_rate=c["lr"], rescale_grad=1.0 / (
        c["batch_size"] * c["seq_len"]))
    updater = mt.optimizer.get_updater(opt)
    names = net.list_arguments()
    losses = []
    t0 = time.perf_counter()
    for _ in range(c["num_batches"]):
        x, y = markov()
        exe.arg_dict["data"][:] = x
        exe.arg_dict["softmax_label"][:] = y
        exe.forward(is_train=True)
        exe.backward()
        for i, name in enumerate(names):
            if name not in shapes:
                updater(i, exe.grad_dict[name], exe.arg_dict[name])
        prob = exe.outputs[0].asnumpy()
        losses.append(float(-np.log(np.maximum(
            prob[np.arange(prob.shape[0]), y.reshape(-1).astype(int)],
            1e-10)).mean()))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    reading = {"card": _smi_line(),
               "config": "examples/model_parallel_lstm.py at its widths: "
                         "%s; embed and decode on gpu(0), layer 0 on "
                         "cpu(0), layer 1 on gpu(0)" % json.dumps(c),
               "placed_nodes": {
                   str(ctx): sum(1 for v in exes["placed"]._placement.values()
                                 if v == ctx)
                   for ctx in set(exes["placed"]._placement.values())},
               "array_devices": placed_devices,
               "vs_card_max_rel": rel,
               "cross_device_copies_per_step": copies,
               "loss_first": losses[0], "loss_last": losses[-1],
               "batches": len(losses), "loop_s": loop_s,
               "step_ms": 1e3 * loop_s / len(losses)}
    log("tp (b) group2ctx LSTM: " + json.dumps(reading))
    if not rel <= 1e-5 or copies["copies"] <= 0 \
            or not losses[-1] < losses[0] or len(placed_devices) != 2:
        raise AssertionError("group2ctx on the card: %s" % reading)
    return reading


def _capi_phase(torch, dev):
    """(c): predict-f32's LM (full width, TRAIN_LAYERS layers) exported
    by ``Predictor.export``, run in this process through the port's C ABI
    (``_native.predict_lib``, dev_type 2): A and C launched inside, the
    outputs within TOL_LOGP of the Python Predictor's; then the C++
    client as a subprocess on the card: its argmax classes equal the
    Python ones."""
    import ctypes
    import re

    from mxnet_tpu_torch import Predictor, _native, gpu
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.ops import flash_kernel as fl
    from mxnet_tpu_torch.ops import fused_kernel as fk

    b, t = TRAIN_BATCH, SEQ
    lm = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=t,
                                 num_layers=TRAIN_LAYERS, embed=EMBED,
                                 heads=TRAIN_HEADS, ffn_hidden=FFN)
    params = _train_params(lm)
    x = np.random.RandomState(6).randint(0, VOCAB, (b, t)).astype(
        np.float32)
    label = np.zeros((b, t), np.float32)
    pred = Predictor(lm, params, {"data": (b, t), "softmax_label": (b, t)},
                     ctx=gpu(0))
    pred.forward(data=x, softmax_label=label)
    want = pred.get_output(0).data.clone()
    want_cls = want.argmax(1).cpu().numpy()
    tmp = tempfile.mkdtemp(prefix="mx_smoke_capi_")
    try:
        path = os.path.join(tmp, "lm.pt2")
        blob = pred.export(path)
        del pred
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lib = _native.predict_lib()
        build_s = time.perf_counter() - t0
        c = ctypes
        h = c.c_void_p()
        keys = (c.c_char_p * 2)(b"data", b"softmax_label")
        indptr = (c.c_uint32 * 3)(0, 2, 4)
        shp = (c.c_uint32 * 4)(b, t, b, t)
        t0 = time.perf_counter()
        if lib.MXPredCreate(blob, len(blob), 2, 0, 2, keys, indptr, shp,
                            c.byref(h)) != 0:
            raise AssertionError("MXPredCreate: %s"
                                 % lib.MXGetLastError().decode())
        create_s = time.perf_counter() - t0
        for key, arr in ((b"data", x), (b"softmax_label", label)):
            a = np.ascontiguousarray(arr, np.float32)
            if lib.MXPredSetInput(h, key, a.ctypes.data_as(
                    c.POINTER(c.c_float)), a.size,
                    (c.c_uint32 * 2)(b, t), 2) != 0:
                raise AssertionError(lib.MXGetLastError().decode())
        counts = ((fk.LAUNCHES, "fused_fwd"), (fl.LAUNCHES, "flash_fwd"))
        for d, k in counts:
            d[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if lib.MXPredForward(h) != 0:
            raise AssertionError("MXPredForward: %s"
                                 % lib.MXGetLastError().decode())
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        launches = {k: d[k] for d, k in counts}
        out = np.zeros((b * t, VOCAB), np.float32)
        if lib.MXPredGetOutput(h, 0, out.ctypes.data_as(
                c.POINTER(c.c_float)), out.size) != 0:
            raise AssertionError(lib.MXGetLastError().decode())
        lib.MXPredFree(h)
        gap = _logp_gap(torch, torch.from_numpy(out).to(dev), want)
        abi_cls = out.argmax(1)
        del out
        # the standalone client on the card
        rec = os.path.join(tmp, "batch.rec")
        from mxnet_tpu_torch import recordio

        w = recordio.MXRecordIO(rec, "w")
        for row in x:
            w.write(row.astype("<f4").tobytes())
        w.close()
        t0 = time.perf_counter()
        exe = _native.predict_client()
        client_build_s = time.perf_counter() - t0
        import mxnet_tpu_torch

        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            mxnet_tpu_torch.__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in sys.path if p.endswith("-packages")]
            + [env.get("PYTHONPATH", "")])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [exe, "--dev-type", "2", "--dev-id", "0", "--zeros",
             "softmax_label", "%dx%d" % (b, t), path, rec, str(b), str(t)],
            capture_output=True, text=True, env=env, timeout=300)
        client_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if proc.returncode != 0:
        raise AssertionError("predict_client exited %d:\n%s"
                             % (proc.returncode, proc.stderr[-4000:]))
    cls = np.full(b * t, -1)
    for m in re.finditer(r"record (\d+): class (\d+)", proc.stdout):
        cls[int(m.group(1))] = int(m.group(2))
    reading = {"card": _smi_line(),
               "config": "predict-f32's LM: vocab %d, T %d, batch %d, embed "
                         "%d, %d heads, FFN %d, %d layers, f32"
                         % (VOCAB, t, b, EMBED, TRAIN_HEADS, FFN,
                            TRAIN_LAYERS),
               "artifact_bytes": len(blob), "lib_build_s": build_s,
               "create_s": create_s, "forward_s": forward_s,
               "launches": launches, "max_abs_logp": gap,
               "abi_argmax_equal": bool((abi_cls == want_cls).all()),
               "client_build_s": client_build_s, "client_s": client_s,
               "client_rows": int((cls >= 0).sum()),
               "client_argmax_equal": bool((cls == want_cls).all())}
    log("tp (c) C ABI: " + json.dumps(reading))
    if launches != {"fused_fwd": 5 * TRAIN_LAYERS,
                    "flash_fwd": TRAIN_LAYERS} or not gap <= TOL_LOGP \
            or not reading["client_argmax_equal"]:
        raise AssertionError("the C ABI on the card: %s" % reading)
    return reading, launches


def _avals_phase(torch, dev):
    """(d): ``serving_avals`` at serve-int8-paged's configuration (SLOTS
    slots, cache SEQ, pages of PAGE_TOKENS): no allocation across the
    call, and every program ``prepare_programs`` then captures takes
    arguments of those shapes and dtypes."""
    from mxnet_tpu_torch.programs.spec import _leaf_sigs

    sym, params, _ = _lm(torch, dev)
    pred = _predictor(sym, params, False, dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    avals = pred.serving_avals(SLOTS, CHUNK)
    avals_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated(dev)
    keys = pred.program_fingerprints(SLOTS, CHUNK)
    pred.prepare_programs(SLOTS, CHUNK)
    progs = pred._programs()
    checked = {}
    for kind in ("chunk", "decode", "commit", "fork"):
        args = avals[kind][1:] if kind in ("chunk", "decode") \
            else avals[kind]
        want = [tuple(x) for x in _leaf_sigs(args, [])
                if isinstance(x, list)]
        (key,) = progs[kind]._entries
        got = [(list(x[0]), str(x[1])) for x in key[1]
               if isinstance(x, tuple) and len(x) >= 2
               and isinstance(x[1], torch.dtype)]
        checked[kind] = {"args": len(want), "equal": got == want}
    reading = {"card": _smi_line(), "slots": SLOTS, "cache": SEQ,
               "page_tokens": PAGE_TOKENS, "chunk": CHUNK,
               "allocated_before": before, "allocated_after": after,
               "avals_s": avals_s, "programs": sorted(avals),
               "fingerprints": len(keys), "captured_vs_avals": checked}
    log("tp (d) serving_avals: " + json.dumps(reading))
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    if before != after or not all(v["equal"] for v in checked.values()):
        raise AssertionError("serving_avals: %s" % reading)
    return reading


def phase_tensor_parallel(torch, dev):
    """Phase 21 (see the module's docstring): (a) the LM over a model
    axis of two ranks, (b) group2ctx on the card, (c) the C ABI, (d)
    serving_avals.  Returns the launches of (a) (both ranks) and (c)."""
    t0 = time.perf_counter()
    tp, tp_launches = _tp_ranks(torch, dev)
    _mp_lstm_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    _, capi_launches = _capi_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    _avals_phase(torch, dev)
    log("tp: " + json.dumps({"card": _smi_line(),
                             "wall_s": time.perf_counter() - t0,
                             "tp_step_s": [r["step_s"] for r in tp["ranks"]],
                             "tp_launches": tp_launches,
                             "capi_launches": capi_launches}))
    return {"tp": tp_launches, "capi": capi_launches}


# ---------------------------------------------------------------------------
# phase 22: the serving mesh and the pipeline
# ---------------------------------------------------------------------------
P22_RANKS = 2       # the ranks of both paths: model=2, two stages
P22_RANK_TIMEOUT = 800   # phases 22, 23 and 24 in the same processes
# examples/pipeline_lm.py's stage / embed / head at train-f32's widths
PIPE_HIDDEN, PIPE_HEADS, PIPE_MICRO, PIPE_STEPS = 1024, 8, 4, 2
PIPE_LR = 3e-3      # the example's Adam rate
PIPE_DIRECT = ("decode_", "s%d_ffn2_" % (P22_RANKS - 1))
# the step-1 loss of the pipeline against the unrolled Module: the same
# f32 products over other GEMM shapes (microbatches of 2 against the
# batch of 8), relative
TOL_PIPE_LOSS = 1e-5


def _p22_rank_main(rank, world, address, outdir):
    """One rank of phases 22, 23 and 24 over gloo on the shared card: 22
    (a) and (b), then 23 (a) and (b), then 24 (a)-(c), in one process
    (one start-up for all)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mxnet_tpu_torch.parallel import launch

    launch.init(address, world, rank, backend="gloo")
    _serve_mesh_rank(torch, rank, world, outdir)
    gc.collect()
    torch.cuda.empty_cache()
    _pipe_rank(torch, rank, world, outdir)
    gc.collect()
    torch.cuda.empty_cache()
    _ring_ranks(torch, rank, world, outdir)
    gc.collect()
    torch.cuda.empty_cache()
    _expert_ranks(torch, rank, world, outdir)
    launch.shutdown()
    print("P22_RANK_%d_OK" % rank, flush=True)
    return 0


def _serve_mesh_rank(torch, rank, world, outdir):
    """Phase 22 (a) on one rank: serve-int8-paged's model and requests
    through a ``DecodePredictor(mesh=MeshConfig(data=1, model=world))``:
    its tokens, launches by program, collectives and peak memory, written
    to ``outdir``."""
    from mxnet_tpu_torch.ops import decode_kernel as dk
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.parallel import MeshConfig, collectives

    dev = torch.device("cuda", 0)
    sym, params, _ = _lm(torch, dev)
    pred = _predictor(sym, params, False, dev,
                      mesh=MeshConfig(data=1, model=world))
    report = pred.prepare_programs(SLOTS, CHUNK)
    local = {n: list(v.shape) for n, v in pred._env.items()
             if n.startswith("layer0_") and n.endswith("_weight")}
    prompts = _prompts()
    _serve(torch, pred, [p[:64] for p in prompts[:2]])
    by_program = {}

    def counting(kind, body):
        def run(*args, **kw):
            before = (fk.LAUNCHES["fused_fwd"], dk.LAUNCHES["paged_decode"],
                      dk.LAUNCHES["paged_combine"])
            out = body(*args, **kw)
            got = by_program.setdefault(kind, {
                "calls": 0, "fused_fwd": 0, "paged_decode": 0,
                "paged_combine": 0, "b_variant": None})
            got["calls"] += 1
            got["fused_fwd"] += fk.LAUNCHES["fused_fwd"] - before[0]
            got["paged_decode"] += dk.LAUNCHES["paged_decode"] - before[1]
            got["paged_combine"] += dk.LAUNCHES["paged_combine"] - before[2]
            got["b_variant"] = dk.LAST_VARIANT.get("paged_decode")
            return out
        return run

    for kind, prog in (("decode", pred._decode_fn),
                       ("chunk", pred._chunk_fn)):
        prog.body = counting(kind, prog.body)
    collectives.SYNC_TIMING = True
    collectives.reset_counts()
    fk.LAUNCHES["fused_fwd"] = 0
    dk.LAUNCHES["paged_decode"] = dk.LAUNCHES["paged_combine"] = 0
    torch.cuda.reset_peak_memory_stats()
    results, wall, stats = _serve(torch, pred, prompts)
    launches = {"fused_fwd": fk.LAUNCHES["fused_fwd"],
                "paged_decode": dk.LAUNCHES["paged_decode"],
                "paged_combine": dk.LAUNCHES["paged_combine"]}
    collectives.SYNC_TIMING = False
    tokens = sum(len(t) for t in results.values())
    reading = {
        "rank": rank, "world": world,
        "tokens": {str(k): np.asarray(v).tolist()
                   for k, v in results.items()},
        "launches": launches, "by_program": by_program,
        "collectives": {k: dict(v) for k, v in collectives.COUNTS.items()},
        "steps": stats["steps"], "chunks": stats["chunks"],
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_p50_s": stats.get("ttft_p50_s"),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "trace_counts": pred.trace_counts,
        "sources": sorted({p["source"] for p in
                           report["programs"].values()}),
        "local_weight_shapes": local,
        "pool_width": int(pred._live.pools[0][0].data.shape[2]),
        "degrades": list(pred._replicated_degrades)}
    with open(os.path.join(outdir, "mesh_rank%d.json" % rank), "w") as f:
        json.dump(reading, f)


def _pipe_syms(mt, stages=None):
    """examples/pipeline_lm.py's stage, embed and head with the port's
    symbols; with ``stages``, the unrolled net of that many blocks
    (names prefixed ``s<k>_``) between the same embed and head."""
    sym = mt.sym

    def block(x, pre=""):
        q = sym.FullyConnected(x, num_hidden=PIPE_HIDDEN, flatten=False,
                               name=pre + "q")
        k = sym.FullyConnected(x, num_hidden=PIPE_HIDDEN, flatten=False,
                               name=pre + "k")
        v = sym.FullyConnected(x, num_hidden=PIPE_HIDDEN, flatten=False,
                               name=pre + "v")
        a = sym.dot_product_attention(q, k, v, num_heads=PIPE_HEADS,
                                      causal=True, name=pre + "attn")
        o = sym.FullyConnected(a, num_hidden=PIPE_HIDDEN, flatten=False,
                               name=pre + "o")
        h = x + o
        f1 = sym.FullyConnected(h, num_hidden=PIPE_HIDDEN * 4,
                                flatten=False, name=pre + "ffn1")
        f1 = sym.Activation(f1, act_type="relu")
        f2 = sym.FullyConnected(f1, num_hidden=PIPE_HIDDEN, flatten=False,
                                name=pre + "ffn2")
        return h + f2

    def head(h):
        logits = sym.FullyConnected(h, num_hidden=VOCAB, flatten=False,
                                    name="decode")
        return sym.SoftmaxOutput(logits, preserve_shape=True,
                                 name="softmax")

    embed = sym.Embedding(sym.Variable("data"), input_dim=VOCAB,
                          output_dim=PIPE_HIDDEN, name="embed")
    if stages is None:
        return block(sym.Variable("data")), head(sym.Variable("data")), \
            embed
    h = embed
    for s in range(stages):
        h = block(h, "s%d_" % s)
    return head(h)


def _pipe_params(mt):
    """Seeded numpy parameters (Xavier-uniform weights, biases N(0, 0.02))
    of the pipeline: stacked stage parameters, embed and head."""
    stage, head, embed = _pipe_syms(mt)
    rng = np.random.RandomState(22)
    a_shapes, _, _ = stage.infer_shape(data=(2, SEQ, PIPE_HIDDEN))
    out = {}

    def draw(name, shape):
        if name.endswith("_weight"):
            lim = np.sqrt(6.0 / (shape[0] + shape[-1]))
            return rng.uniform(-lim, lim, shape).astype(np.float32)
        return rng.normal(0, 0.02, shape).astype(np.float32)

    for n, s in zip(stage.list_arguments(), a_shapes):
        if n != "data":
            out[n] = np.stack([draw(n, s) for _ in range(P22_RANKS)])
    out["embed_weight"] = draw("embed_weight", (VOCAB, PIPE_HIDDEN))
    out["decode_weight"] = draw("decode_weight", (VOCAB, PIPE_HIDDEN))
    out["decode_bias"] = draw("decode_bias", (VOCAB,))
    return out


def _pipe_batch():
    """examples/pipeline_lm.py's corpus: a learnable next-token rule."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, VOCAB // 2, (TRAIN_BATCH, SEQ + 1))
    base[:, 1:] = (base[:, :-1] + 1) % VOCAB
    return base[:, :-1].astype(np.float32), base[:, 1:].astype(np.float32)


def _nll(torch, probs, y):
    """Mean -log p of the labels (f64)."""
    p = probs.reshape(-1, probs.shape[-1]).double()
    lab = torch.as_tensor(y.reshape(-1), device=p.device).long()
    return float(-torch.log(p[torch.arange(len(lab), device=p.device),
                               lab]).mean())


def _pipe_rank(torch, rank, world, outdir):
    """Phase 22 (b) on one rank: a PipelineModule of ``world`` stages,
    PIPE_STEPS ``fit`` steps with Adam; each step's launches, hops and
    seconds, the peak memory, the step-1 loss, the rank's step-1
    gradients times the optimizer's ``rescale_grad`` (its stage's by the
    unrolled names, the embed's and the head's) and (rank 0) the gathered
    parameters after step 1."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel import collectives

    stage, head, embed = _pipe_syms(mt)
    params = _pipe_params(mt)
    x, y = _pipe_batch()
    pipe = mt.mod.PipelineModule(stage, head, num_stages=world,
                                 num_microbatches=PIPE_MICRO,
                                 embed_symbol=embed, context=mt.gpu(0))
    it = mt.io.NDArrayIter({"data": np.tile(x, (PIPE_STEPS, 1))},
                           {"softmax_label": np.tile(y, (PIPE_STEPS, 1))},
                           batch_size=TRAIN_BATCH)
    steps = []
    collectives.SYNC_TIMING = True
    torch.cuda.reset_peak_memory_stats()
    state = {}

    def begin():
        torch.cuda.synchronize()
        collectives.reset_counts()
        _resume_counts(zero=True)

    def on_batch(param):
        counts = {k: dict(v) for k, v in collectives.COUNTS.items()}
        steps.append({"s": pipe.last_step_s, "launches": _resume_counts(),
                      "collectives": counts})
        if len(steps) == 1:
            if pipe._outputs is not None:
                state["loss"] = _nll(torch, pipe._outputs[0], y)
            scale = pipe._optimizer.rescale_grad
            torch.save({("s%d_%s" % (pipe.stage, k)
                         if k in stage.list_arguments() else k):
                        scale * g.data for k, g in pipe._grads.items()},
                       os.path.join(outdir, "pipe_grads_rank%d.pt" % rank))
            arg, _ = pipe.get_params()
            if rank == 0:
                torch.save({k: v.data for k, v in arg.items()},
                           os.path.join(outdir, "pipe_params.pt"))
        begin()

    begin()
    pipe.fit(it, eval_metric=mt.metric.Perplexity(ignore_label=None),
             batch_end_callback=on_batch, optimizer="adam",
             optimizer_params={"learning_rate": PIPE_LR},
             arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                         for k, v in params.items()},
             num_epoch=1)
    collectives.SYNC_TIMING = False
    reading = {"rank": rank, "stage": pipe.stage, "steps": steps,
               "loss_step1": state.get("loss"),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "update": "kernel B1 slab" if pipe._slab is not None
               else "per-parameter",
               "perplexity": pipe._metric_acc is not None}
    with open(os.path.join(outdir, "pipe_rank%d.json" % rank), "w") as f:
        json.dump(reading, f)


def _spawn_ranks(phase, n, tags, timeout, may_die=()):
    """``n`` rank processes of this script (``--p<phase>-rank`` rank world
    address outdir), each with a timeout: ``({tag: readings}, outdir,
    wall s)``, a reading a rank from ``<tag>_rank<r>.json`` (the caller
    removes ``outdir``).  A rank in ``may_die`` may leave with exit code 0
    and no OK line (phase 25's real death)."""
    outdir = tempfile.mkdtemp(prefix="mx_smoke_p%d_" % phase)
    address = "127.0.0.1:%d" % _free_port()
    here = os.path.abspath(__file__)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, here, "--p%d-rank" % phase, str(r), str(n),
         address, outdir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=os.path.dirname(here)) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        ok = "P%d_RANK_%d_OK" % (phase, r) in out or r in may_die
        if p.returncode != 0 or not ok:
            shutil.rmtree(outdir, ignore_errors=True)
            raise AssertionError("rank %d of phase %d exited %s:\n%s"
                                 % (r, phase, p.returncode, out[-6000:]))
    ranks = {}
    for tag in tags:
        ranks[tag] = []
        for r in range(n):
            with open(os.path.join(outdir, "%s_rank%d.json" % (tag, r))) as f:
                ranks[tag].append(json.load(f))
    return ranks, outdir, wall


def _b_local_case(torch, dev, flush):
    """Kernel B at a mesh rank's shapes: 2 of the 4 heads of 256 (kv-heads
    as many) over int8 pages, tq = 1 at 4 slots and tq = CHUNK at one,
    against its plain version; times as phase 2's."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import attention as attn
    from mxnet_tpu_torch.ops import decode_kernel as dk

    g = torch.Generator(device=dev)
    g.manual_seed(22)
    heads = HEADS // P22_RANKS
    hd = EMBED // HEADS
    e = heads * hd
    m = SEQ // PAGE_TOKENS
    c = m * PAGE_TOKENS
    pages = SLOTS * m + 1
    table_all = (torch.randperm(pages - 1, generator=g, device=dev).to(
        torch.int32) + 1)[:SLOTS * m].reshape(SLOTS, m).contiguous()
    kp, vp = _pools(torch, attn, dev, g, pages, heads, hd, torch.int8)
    cases = []
    for tq, lens_list in ((1, [130, 700, 1100, c + 37]),
                          (CHUNK, [768 + CHUNK])):
        b = len(lens_list)
        table = table_all[:b].contiguous()
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        q = torch.randn(b, tq, e, generator=g, device=dev)
        fn = dk.flash_sdpa_decode if tq == 1 else dk.flash_sdpa_verify
        kw = dict(num_heads=heads, num_kv_heads=heads)
        got = fn(q, kp, vp, table, lens, **kw)
        variant = dk.LAST_VARIANT["paged_decode"]
        want = dk.paged_plain(q, kp, vp, table, lens, heads, None, heads)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (err <= TOL_B and bool(torch.isfinite(got).all())):
            raise AssertionError("kernel B at 2 kv-heads tq=%d: max |out - "
                                 "plain| %.3g > %.3g" % (tq, err, TOL_B))
        kv = attn.dequantize_kv(attn.paged_gather(kp, table), heads)
        vv = attn.dequantize_kv(attn.paged_gather(vp, table), heads)
        kh = kv.reshape(b, c, heads, hd).permute(0, 2, 1, 3)
        vh = vv.reshape(b, c, heads, hd).permute(0, 2, 1, 3)
        qh = q.reshape(b, tq, heads, hd).permute(0, 2, 1, 3)
        limit = torch.clamp_max(lens.long()[:, None] - (tq - 1)
                                + torch.arange(tq, device=dev)[None, :], c)
        mask = (torch.arange(c, device=dev)[None, None, :]
                < limit[:, :, None])[:, None]
        live = [min(int(t), c) for t in lens_list]
        nbytes = (2 * q.numel() * 4 + b * m * 4 + b * 4
                  + sum(live) * heads * (hd + 4) * 2)
        keys = sum(min(int(t) - (tq - 1) + i, c)
                   for t in lens_list for i in range(tq))
        bound_ms, bound_by = _bound(nbytes, 4.0 * keys * heads * hd,
                                    "float32")
        case = _case(
            torch, flush, lambda: fn(q, kp, vp, table, lens, **kw),
            lambda: dk.paged_plain(q, kp, vp, table, lens, heads, None,
                                   heads),
            lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                   attn_mask=mask),
            {"kernel": "B", "pool": "int8", "heads": heads, "head_dim": hd,
             "tq": tq, "lens": lens_list, "variant": variant,
             "max_abs_err": err, "bound_ms": bound_ms,
             "bound_by": bound_by}, iters=20)
        case["bound_share"] = _bound_share(case)
        log("serve mesh kernel B case: " + json.dumps(case))
        cases.append(case)
    return cases


def _a_local_cases(torch, dev, flush):
    """Kernel A at a mesh rank's shard widths, f32, against its plain
    version: decode (M = SLOTS) and a prefill chunk (M = CHUNK) through
    q / k / v (N = EMBED / ranks), ffn1 (N = FFN / ranks) and ffn2 (K =
    FFN / ranks, ReLU and residual)."""
    g = torch.Generator(device=dev)
    g.manual_seed(24)
    return [_a_case(torch, dev, flush, g, torch.float32, m, k, n, relu_res)
            for m in (SLOTS, CHUNK)
            for k, n, relu_res in ((EMBED, EMBED // P22_RANKS, False),
                                   (EMBED, FFN // P22_RANKS, False),
                                   (FFN // P22_RANKS, EMBED, True))]


def _cde_stage_cases(torch, dev, flush):
    """Kernels C, D and E at a pipeline stage's attention: (mb * heads, T,
    hd) = (16, 2048, 128), causal, f32, against their plain versions."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import flash_kernel as fl

    g = torch.Generator(device=dev)
    g.manual_seed(23)
    b = TRAIN_BATCH // PIPE_MICRO
    h, t, hd = PIPE_HEADS, SEQ, PIPE_HIDDEN // PIPE_HEADS
    bh = b * h
    scale = hd ** -0.5
    pairs = t * (t + 1) // 2
    q, k, v, do = (torch.randn(bh, t, hd, generator=g, device=dev)
                   for _ in range(4))
    args = (scale, True, 1)
    o, lse = fl.flash_fwd(q, k, v, *args)
    wo, wlse = fl.flash_plain_fwd(q, k, v, *args)
    delta = fl.flash_delta(o, do)
    dq = fl.flash_bwd_dq(q, k, v, do, lse, delta, *args)
    dk_, dv = fl.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
    wdq, wdk, wdv = fl.flash_plain_bwd(q, k, v, o, lse, do, *args)
    torch.cuda.synchronize()
    errs = {"C": max(_check_close("stage C o", o, wo, TOL_F32),
                     _check_close("stage C lse", lse, wlse, TOL_F32)),
            "D": _check_close("stage D dq", dq, wdq, TOL_F32),
            "E": max(_check_close("stage E dk", dk_, wdk, TOL_F32),
                     _check_close("stage E dv", dv, wdv, TOL_F32))}
    q4, k4, v4, do4 = (x.view(b, h, t, hd) for x in (q, k, v, do))
    leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]
    lo = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                        scale=scale)
    fns = {
        "C": (lambda: fl.flash_fwd(q, k, v, *args),
              lambda: fl.flash_plain_fwd(q, k, v, *args),
              lambda: F.scaled_dot_product_attention(
                  q4, k4, v4, is_causal=True, scale=scale)),
        "D": (lambda: fl.flash_bwd_dq(q, k, v, do, lse, delta, *args),
              lambda: fl.flash_plain_bwd(q, k, v, o, lse, do, *args),
              lambda: torch.autograd.grad(lo, leaves, do4,
                                          retain_graph=True)),
        "E": (lambda: fl.flash_bwd_dkv(q, k, v, do, lse, delta, *args),
              lambda: fl.flash_plain_bwd(q, k, v, o, lse, do, *args),
              lambda: torch.autograd.grad(lo, leaves, do4,
                                          retain_graph=True))}
    qb, rowb = bh * t * hd * 4, bh * t * 4
    nbytes = {"C": 4 * qb + rowb, "D": 5 * qb + 2 * rowb,
              "E": 6 * qb + 2 * rowb}
    flops = {"C": 4.0 * pairs * hd * bh, "D": 6.0 * pairs * hd * bh,
             "E": 8.0 * pairs * hd * bh}
    cases = {}
    for name in "CDE":
        bound_ms, bound_by = _bound(nbytes[name], flops[name], "float32")
        case = _case(torch, flush, *fns[name], extra={
            "kernel": name, "dtype": "float32", "bh": bh, "t": t, "hd": hd,
            "causal": True, "max_abs_err": errs[name], "tol": TOL_F32,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "variant": fl.LAST_VARIANT[{"C": "flash_fwd",
                                        "D": "flash_bwd_dq",
                                        "E": "flash_bwd_dkv"}[name]]})
        case["bound_share"] = _bound_share(case)
        log("pipeline kernel %s case: %s" % (name, json.dumps(case)))
        cases[name] = case
    return cases


def _serve_mesh_phase(torch, dev, flush, ranks, wall):
    """(a): the ranks' readings against the single-rank captured serve,
    kernels A and B at their shapes; returns the reading, both ranks'
    launches and the A and B cases."""
    sym, params, _ = _lm(torch, dev)
    pred = _predictor(sym, params, False, dev)
    pred.prepare_programs(SLOTS, CHUNK)
    single, s_wall, s_stats = _serve(torch, pred, _prompts())
    single = {str(k): np.asarray(v).tolist() for k, v in single.items()}
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    a_cases = _a_local_cases(torch, dev, flush)
    b_cases = _b_local_case(torch, dev, flush)
    failed = []
    hd = EMBED // HEADS
    for rd in ranks:
        if rd["tokens"] != single:
            failed.append("rank %d's tokens differ from the single-rank "
                          "serve's" % rd["rank"])
        bp = rd["by_program"]
        if min(rd["launches"].values()) <= 0 \
                or bp["decode"]["b_variant"] != "decode" \
                or bp["chunk"]["b_variant"] != "chunk":
            failed.append("rank %d launched %s (%s)" % (
                rd["rank"], rd["launches"], bp))
        want = {"layer0_q_weight": [EMBED // P22_RANKS, EMBED],
                "layer0_ffn1_weight": [FFN // P22_RANKS, EMBED],
                "layer0_ffn2_weight": [EMBED, FFN // P22_RANKS]}
        if any(rd["local_weight_shapes"].get(n) != s
               for n, s in want.items()) \
                or rd["pool_width"] != (HEADS // P22_RANKS) * hd \
                or rd["sources"] != ["eager"] \
                or set(rd["trace_counts"].values()) != {0}:
            failed.append("rank %d's shards / programs: %s %d %s %s" % (
                rd["rank"], rd["local_weight_shapes"], rd["pool_width"],
                rd["sources"], rd["trace_counts"]))
    if failed:
        raise AssertionError("phase 22 (a): " + "; ".join(failed))
    per_rank = []
    for rd in ranks:
        calls = rd["steps"] + rd["chunks"]
        per_rank.append({
            "rank": rd["rank"], "launches": rd["launches"],
            "by_program": rd["by_program"],
            "collectives_per_program_call": {
                k: {f: v[f] / calls for f in ("calls", "bytes", "s")}
                for k, v in rd["collectives"].items()},
            "collectives": rd["collectives"], "steps": rd["steps"],
            "chunks": rd["chunks"], "wall_s": rd["wall_s"],
            "tokens_per_s": rd["tokens_per_s"],
            "ttft_p50_s": rd["ttft_p50_s"], "peak_bytes": rd["peak_bytes"],
            "local_weight_shapes": rd["local_weight_shapes"],
            "pool_width": rd["pool_width"]})
    s_tokens = sum(len(t) for t in single.values())
    reading = {
        "card": _smi_line(),
        "config": "serve-int8-paged's LM (vocab %d, embed %d, %d heads, "
                  "FFN %d, %d layers, int8 pages of %d, %d slots, %d "
                  "requests, %d greedy tokens), MeshConfig(data=1, "
                  "model=%d): %d ranks over gloo on one card, eager "
                  "programs" % (VOCAB, EMBED, HEADS, FFN, LAYERS,
                                PAGE_TOKENS, SLOTS, len(PROMPT_LENS),
                                MAX_NEW, P22_RANKS, P22_RANKS),
        "tokens_equal_single_rank": True, "ranks_wall_s": wall,
        "single_rank": {"tokens_per_s": s_tokens / s_wall,
                        "ttft_p50_s": s_stats.get("ttft_p50_s")},
        "ranks": per_rank,
        "kernel_a_local": [{k: c[k] for k in (
            "m", "k", "n", "variant", "max_abs_err", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_share")}
            for c in a_cases],
        "kernel_b_local": [{k: c[k] for k in (
            "tq", "variant", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bound_share")} for c in b_cases]}
    log("serve mesh (a): " + json.dumps(reading))
    launches = {k: sum(rd["launches"][k] for rd in ranks)
                for k in ranks[0]["launches"]}
    return reading, launches, a_cases, b_cases


def _pipe_single(torch, dev, x, y, plain=False, micro=1):
    """The unrolled Module of the P22_RANKS blocks on the card, one Adam
    step from the pipeline's parameters: (parameters after it, by the
    unrolled names; the step's gradients times ``rescale_grad``; the
    step's loss; the start).  ``micro`` > 1 sums the gradients of that
    many microbatches in turn (``grad_req="add"``) before the step: the
    sums a pipeline takes, in another order."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch, DataDesc

    params = _pipe_params(mt)
    args = {"embed_weight": params["embed_weight"],
            "decode_weight": params["decode_weight"],
            "decode_bias": params["decode_bias"]}
    stage, _, _ = _pipe_syms(mt)
    for n in stage.list_arguments():
        if n != "data":
            for s in range(P22_RANKS):
                args["s%d_%s" % (s, n)] = params[n][s]
    net = _pipe_syms(mt, P22_RANKS)
    mod = mt.mod.Module(net, context=mt.gpu(0), plain=plain)
    rows = len(x) // micro
    mod.bind(data_shapes=[DataDesc("data", (rows,) + x.shape[1:],
                                   layout="NT")],
             label_shapes=[DataDesc("softmax_label", (rows,) + y.shape[1:],
                                    layout="NT")],
             grad_req="write" if micro == 1 else "add")
    mod.init_params(arg_params=args)
    mod.init_optimizer(optimizer="adam", optimizer_params={
        "learning_rate": PIPE_LR, "rescale_grad": 1.0 / len(x)})
    loss = None
    for j in range(micro):
        part = slice(j * rows, (j + 1) * rows)
        mod.forward_backward(DataBatch([nd.array(x[part])],
                                       [nd.array(y[part])]))
        if micro == 1:
            loss = _nll(torch, mod.get_outputs()[0].data, y)
    group = mod._exec_group
    grads = {n: mod._optimizer.rescale_grad * g.data
             for n, g in zip(group.param_names, group.grad_arrays)}
    mod.update()
    torch.cuda.synchronize()
    start = {n: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for n, v in args.items()}
    snap = {k: v for k, v in _snapshot(mod).items()
            if not k.startswith("aux:")}
    del mod, group
    gc.collect()
    torch.cuda.empty_cache()
    return snap, grads, loss, start


def _pipe_spread_bound(step, tier):
    """(b)'s bound at one tier: CAPTURE_SPREAD times the widest of the
    single-process spreads: the same run again, the batch halves
    swapped, the plain versions, and the gradients summed over the
    microbatches in turn (a pipeline sums a stage's gradient microbatch
    by microbatch: Adam's first step, about lr x sign(g), moves every
    element whose gradient that order flips)."""
    return CAPTURE_SPREAD * max(1e-7, *(step[k][tier]["max"] for k in (
        "atomics_spread", "reorder_spread", "plain_spread",
        "microbatch_spread")))


def _pipeline_phase(torch, dev, flush, ranks, wall, stacked, rank_grads):
    """(b): the ranks' readings, step-1 parameters (``stacked``) and
    rescaled step-1 gradients (``rank_grads``, one dict a rank) against
    the unrolled single-process runs, C / D / E at the stage shape;
    returns the reading and both ranks' launches.  The gradients carry
    what Adam's first step hides (it moves about lr x sign(g)): a
    gradient scaled by a factor, counted twice or not summed."""
    import mxnet_tpu_torch as mt

    stage, _, _ = _pipe_syms(mt)
    got = {}
    for n, v in stacked.items():
        if n in stage.list_arguments():
            for s in range(P22_RANKS):
                got["s%d_%s" % (s, n)] = v[s].to(dev)
        else:
            got[n] = v.to(dev)
    x, y = _pipe_batch()
    # the gradients: each rank's stage, the embed and head of rank 0
    # (every rank's copies of those must equal rank 0's)
    got_g = {n: v.to(dev) for n, v in rank_grads[0].items()}
    for rg in rank_grads[1:]:
        got_g.update({n: v.to(dev) for n, v in rg.items()
                      if n.startswith("s")})
    shared_unequal = sorted(
        n for rg in rank_grads[1:] for n, v in rg.items()
        if not n.startswith("s") and not torch.equal(v, rank_grads[0][n]))
    t0 = time.perf_counter()
    single, s_g, loss, start = _pipe_single(torch, dev, x, y)
    again, a_g, _, _ = _pipe_single(torch, dev, x, y)
    half = TRAIN_BATCH // 2
    swapped, w_g, _, _ = _pipe_single(
        torch, dev, np.concatenate([x[half:], x[:half]]),
        np.concatenate([y[half:], y[:half]]))
    plain, p_g, p_loss, _ = _pipe_single(torch, dev, x, y, plain=True)
    summed, m_g, _, _ = _pipe_single(torch, dev, x, y, micro=PIPE_MICRO)
    single_s = time.perf_counter() - t0

    def diffs(pairs, base, origin):
        return {k: _run_diff(torch, v, base, origin, PIPE_DIRECT)["tiers"]
                for k, v in pairs}

    keys = ("vs_single", "atomics_spread", "reorder_spread",
            "plain_spread", "microbatch_spread")
    step1 = diffs(zip(keys, (got, again, swapped, plain, summed)), single,
                  start)
    zero = {n: torch.zeros_like(v) for n, v in s_g.items()}
    grads1 = diffs(zip(keys, (got_g, a_g, w_g, p_g, m_g)), s_g, zero)
    del got, single, again, swapped, plain, summed, start
    del got_g, s_g, a_g, w_g, p_g, m_g, zero
    gc.collect()
    torch.cuda.empty_cache()
    cde = _cde_stage_cases(torch, dev, flush)
    failed = []
    want = {"flash_fwd": PIPE_MICRO, "flash_bwd_dq": PIPE_MICRO,
            "flash_bwd_dkv": PIPE_MICRO, "multi_tensor_update": 1}
    for rd in ranks:
        for i, s in enumerate(rd["steps"]):
            got_l = {k: s["launches"][k] for k in want}
            if got_l != want:
                failed.append("rank %d step %d launched %s, want %s"
                              % (rd["rank"], i + 1, got_l, want))
        if rd["update"] != "kernel B1 slab":
            failed.append("rank %d updated %s" % (rd["rank"], rd["update"]))
    last = next(rd for rd in ranks if rd["loss_step1"] is not None)
    loss_gap = abs(last["loss_step1"] - loss) / abs(loss)
    if not loss_gap <= TOL_PIPE_LOSS:
        failed.append("step-1 loss %.9g against the unrolled Module's %.9g"
                      % (last["loss_step1"], loss))
    if shared_unequal:
        failed.append("the embed / head gradients differ over the ranks: "
                      "%s" % shared_unequal)
    for what, diff in (("step 1", step1), ("step-1 gradients", grads1)):
        for tier in ("before_relu", "behind_relu"):
            reading_t = diff["vs_single"][tier]
            bound = _pipe_spread_bound(diff, tier)
            if reading_t["max"] > bound:
                failed.append("%s %s: %.6g (%s) beyond the bound %.6g"
                              % (what, tier, reading_t["max"],
                                 reading_t["tensor"], bound))
    if failed:
        raise AssertionError("phase 22 (b): " + "; ".join(failed))
    per_rank = []
    for rd in ranks:
        timed = rd["steps"][1:] or rd["steps"]
        n = len(timed)
        kinds = sorted({k for s in timed for k in s["collectives"]})
        per_rank.append({
            "rank": rd["rank"], "stage": rd["stage"],
            "launches_per_step": {k: sum(s["launches"][k] for s in timed)
                                  / n for k in want},
            "collectives_per_step": {k: {
                f: sum(s["collectives"].get(k, {}).get(f, 0)
                       for s in timed) / n for f in ("calls", "bytes", "s")}
                for k in kinds},
            "step_s": [s["s"] for s in rd["steps"]],
            "peak_bytes": rd["peak_bytes"],
            "device_perplexity": rd["perplexity"]})
    reading = {
        "card": _smi_line(),
        "config": "examples/pipeline_lm.py's stage / embed / head at "
                  "hidden %d, %d heads, FFN %d, T %d, batch %d, vocab %d; "
                  "PipelineModule(num_stages=%d, num_microbatches=%d), %d "
                  "ranks over gloo on one card, %d fit steps, Adam lr %g"
                  % (PIPE_HIDDEN, PIPE_HEADS, 4 * PIPE_HIDDEN, SEQ,
                     TRAIN_BATCH, VOCAB, P22_RANKS, PIPE_MICRO,
                     P22_RANKS, PIPE_STEPS, PIPE_LR),
        "ranks_wall_s": wall, "single_runs_s": single_s,
        "loss_step1": last["loss_step1"], "single_loss_step1": loss,
        "plain_loss_step1": p_loss, "loss_gap": loss_gap,
        "step1": step1, "step1_grads": grads1,
        "max_over_spread": CAPTURE_SPREAD,
        "ranks": per_rank,
        "kernels_cde_stage": {k: {f: c[f] for f in (
            "variant", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bound_share")} for k, c in cde.items()}}
    log("pipeline (b): " + json.dumps(reading))
    launches = {k: sum(s["launches"][k] for rd in ranks
                       for s in rd["steps"]) for k in want}
    return reading, launches, cde


def phase_mesh_pipeline(torch, dev):
    """Phase 22 (see the module's docstring): (a) the serving mesh, (b)
    the pipeline.  Returns both paths' launches and the kernel cases at
    their shapes."""
    t0 = time.perf_counter()
    ranks, outdir, wall = _spawn_ranks(22, P22_RANKS, (
        "mesh", "pipe", "op", "lm", "ep_op", "ep_lm", "ep_serve"),
        P22_RANK_TIMEOUT)
    try:
        stacked = torch.load(os.path.join(outdir, "pipe_params.pt"))
        rank_grads = [torch.load(os.path.join(
            outdir, "pipe_grads_rank%d.pt" % r)) for r in range(P22_RANKS)]
        ring = {"op": ranks["op"], "lm": ranks["lm"], "wall_s": wall,
                "step1": torch.load(os.path.join(outdir, "lc_step1.pt"))}
        expert = {"ranks": {k: ranks[k] for k in ("ep_op", "ep_lm",
                                                  "ep_serve")},
                  "wall_s": wall}
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    serve, serve_l, a_cases, b_cases = _serve_mesh_phase(
        torch, dev, flush, ranks["mesh"], wall)
    gc.collect()
    torch.cuda.empty_cache()
    pipe, pipe_l, cde = _pipeline_phase(torch, dev, flush, ranks["pipe"],
                                        wall, stacked, rank_grads)
    del stacked, rank_grads
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    log("mesh pipeline: " + json.dumps({
        "card": _smi_line(), "wall_s": time.perf_counter() - t0,
        "serve_mesh_launches": serve_l, "pipeline_launches": pipe_l,
        "serve_mesh_tokens_per_s": [r["tokens_per_s"]
                                    for r in serve["ranks"]],
        "pipeline_step_s": [r["step_s"] for r in pipe["ranks"]]}))
    return {"serve_mesh": serve_l, "pipeline": pipe_l,
            "a_cases": a_cases, "b_cases": b_cases, "cde": cde,
            "ring": ring, "expert": expert}


# ---------------------------------------------------------------------------
# phase 23: sequence parallelism (the ring)
# ---------------------------------------------------------------------------
P23_RANKS = 2       # the seq axis: two ranks over gloo on the one card
P23_RANK_TIMEOUT = 500
# benchmarks/bench_long_context.py:124-160's LM at its TPU widths, nothing
# cut: T 8192, batch 2, embed 2048, 16 heads (head dim 128), vocab 8192;
# its SGD (lr 0.01, momentum 0.9), here in f32 (the port trains its LMs in
# f32: ROADMAP section C's bf16 token-id cast)
LC_T, LC_BATCH, LC_EMBED, LC_HEADS, LC_VOCAB = 8192, 2, 2048, 16, 8192
LC_STEPS = 2        # fit steps through the ring
LC_SCHEDULE_STEPS = 1   # steps a schedule, timed after the fit
LC_LR, LC_MOMENTUM = 0.01, 0.9
LC_COLS = 64        # output columns a row held against the single process
# (a)'s cases at the bench's attention shape: (dtype, groups)
RING_CASES = (("float32", 1), ("bfloat16", 1), ("float32", 2),
              ("bfloat16", 2))


def _ring_ranks(torch, rank, world, outdir):
    """Phase 23 on one rank: (a) the op, then (b) the LM."""
    _ring_op_rank(torch, rank, world, outdir)
    gc.collect()
    torch.cuda.empty_cache()
    _ring_lm_rank(torch, rank, world, outdir)


def _p23_rank_main(rank, world, address, outdir):
    """One rank of phase 23 run alone (the full smoke runs it in phase
    22's rank processes)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mxnet_tpu_torch.parallel import launch

    launch.init(address, world, rank, backend="gloo")
    _ring_ranks(torch, rank, world, outdir)
    launch.shutdown()
    print("P23_RANK_%d_OK" % rank, flush=True)
    return 0


def _ring_op_rank(torch, rank, world, outdir):
    """(a) on one rank: ``ring_attention`` under ``compat.shard_map`` over
    MeshConfig(seq=world) at the bench's attention shape (B 2, T 8192, 16
    heads of 128; G = 2 at 8 kv-heads), causal, f32 and bf16.  Each case:
    the mapped ring (kernels, double-buffered; its launches and sends
    counted), the same ring on the rank's blocks serial (bit for bit) and
    on the plain versions (TOL_F32 / TOL_BF16); rank 0 also holds the
    gathered result against the single-process flash op on the whole
    sequence."""
    from mxnet_tpu_torch.ops import attention as attn
    from mxnet_tpu_torch.ops import flash_kernel as fl
    from mxnet_tpu_torch.parallel import MeshConfig, build_mesh, compat, ring
    from mxnet_tpu_torch.parallel import collectives as C

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    mesh = build_mesh(MeshConfig(data=1, seq=world))
    group = mesh.get_group("seq")
    tl = LC_T // world
    lo, hi = rank * tl, (rank + 1) * tl
    spec = (None, "seq", None)
    cases = []
    for dname, groups in RING_CASES:
        dtype = getattr(torch, dname)
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        kvh = LC_HEADS // groups
        hd = LC_EMBED // LC_HEADS
        g = torch.Generator(device=dev)
        g.manual_seed(230 + groups)

        def r(e):
            return torch.randn(LC_BATCH, LC_T, e, generator=g,
                               device=dev).to(dtype)

        q, k, v, w = r(LC_EMBED), r(kvh * hd), r(kvh * hd), r(LC_EMBED)

        def attend(plain, db, axis):
            return lambda a, b, c: ring.ring_attention(
                a, b, c, axis, num_heads=LC_HEADS, causal=True,
                num_kv_heads=kvh, double_buffer=db, plain=plain)

        def run(fn, xs, cot):
            leaves = [x.detach().clone().requires_grad_() for x in xs]
            torch.cuda.synchronize()
            C.reset_counts()
            launched = _resume_counts(zero=True)
            t0 = time.perf_counter()
            out = fn(*leaves)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sends_fwd = dict(C.COUNTS.get("send", {}))
            out.backward(cot)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launched = {n: c for n, c in _resume_counts().items()
                        if n.startswith("flash")}
            return ([out.detach()] + [x.grad for x in leaves],
                    {"fwd_s": t1 - t0, "bwd_s": t2 - t1,
                     "launches": launched, "send_fwd": sends_fwd,
                     "send": dict(C.COUNTS.get("send", {})),
                     "path": ring.RING_PATH["last"]})

        mapped, m_info = run(compat.shard_map(attend(False, True, "seq"),
                                              mesh, (spec,) * 3, spec),
                             (q, k, v), w)
        mine = [x[:, lo:hi] for x in mapped]
        local = [x[:, lo:hi] for x in (q, k, v)]
        serial, s_info = run(attend(False, False, group), local,
                             w[:, lo:hi])
        plain, _ = run(attend(True, True, group), local, w[:, lo:hi])
        names = ("out", "dq", "dk", "dv")
        case = {
            "dtype": dname, "groups": groups, "kv_heads": kvh, "tol": tol,
            "mapped": m_info, "serial": s_info,
            "schedules_equal": all(torch.equal(a, b) for a, b in
                                   zip(serial, mine)),
            "vs_plain_ring": {n: _close_err(a, b, tol) for n, a, b in
                              zip(names, mine, plain)},
            "finite": all(bool(torch.isfinite(x).all()) for x in mapped)}
        del serial, plain
        if rank == 0:
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            out = attn.sdpa_flash(*leaves, LC_HEADS, True,
                                  num_kv_heads=kvh)
            out.backward(w)
            torch.cuda.synchronize()
            case["vs_single"] = {
                n: _close_err(a, b, tol) for n, a, b in zip(
                    names, mapped, [out.detach()]
                    + [x.grad for x in leaves])}
            case["variant"] = dict(fl.LAST_VARIANT)
            del leaves, out
        cases.append(case)
        del mapped, mine, local, q, k, v, w
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(outdir, "op_rank%d.json" % rank), "w") as f:
        json.dump({"rank": rank, "cases": cases,
                   "wall_s": time.perf_counter() - t_start}, f)


def _lc_sym(mt):
    """bench_long_context.py's ``build_lm`` in the port's symbols."""
    sym = mt.sym
    e = LC_EMBED
    data, label = sym.Variable("data"), sym.Variable("softmax_label")
    emb = sym.Embedding(data, input_dim=LC_VOCAB, output_dim=e,
                        name="embed")
    q = sym.FullyConnected(emb, num_hidden=e, flatten=False, name="q")
    k = sym.FullyConnected(emb, num_hidden=e, flatten=False, name="k")
    v = sym.FullyConnected(emb, num_hidden=e, flatten=False, name="v")
    att = sym.dot_product_attention(q, k, v, num_heads=LC_HEADS,
                                    causal=True)
    out = sym.FullyConnected(att, num_hidden=e, flatten=False, name="proj")
    head = sym.FullyConnected(sym.Reshape(out, shape=(-1, e)),
                              num_hidden=LC_VOCAB, name="head")
    return sym.SoftmaxOutput(head, sym.Reshape(label, shape=(-1,)),
                             name="softmax")


def _lc_params(sym):
    """Seeded numpy parameters: Xavier-gaussian weights (the bench's
    initializer: magnitude 3, factor avg), biases 0.02-scaled normals (so
    a bias applied on the wrong rows shows)."""
    rng = np.random.RandomState(23)
    shapes, _, _ = sym.infer_shape(data=(LC_BATCH, LC_T),
                                   softmax_label=(LC_BATCH, LC_T))
    out = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            bound = np.sqrt(3.0 / ((shape[0] + shape[1]) / 2.0))
            out[name] = rng.normal(0.0, bound, shape).astype(np.float32)
        else:
            out[name] = rng.normal(0.0, 0.02, shape).astype(np.float32)
    return out


def _lc_batch():
    """The bench's batch: seed 0 tokens, labels the next token."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, LC_VOCAB, size=(LC_BATCH, LC_T)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((LC_BATCH, 1), np.float32)],
                       axis=1)
    return x, y


def _lc_module(mt, ctx, mesh_config=None, plain=False):
    from mxnet_tpu_torch.io import DataDesc

    sym = _lc_sym(mt)
    kw = {} if mesh_config is None else {"mesh_config": mesh_config}
    mod = mt.mod.Module(sym, context=ctx, plain=plain, **kw)
    mod.bind(data_shapes=[DataDesc("data", (LC_BATCH, LC_T), layout="NT")],
             label_shapes=[DataDesc("softmax_label", (LC_BATCH, LC_T),
                                    layout="NT")])
    mod.init_params(arg_params=_lc_params(sym), aux_params={})
    return mod


def _ring_lm_rank(torch, rank, world, outdir):
    """(b) on one rank: the long-context LM through
    ``Module(mesh_config=MeshConfig(seq=world))``, LC_STEPS ``fit`` steps
    (the double-buffered ring): each step's launches, collectives and
    seconds, the peak memory; rank 0 writes the step-1 parameters and
    the step-1 outputs' first LC_COLS columns (gathered: the reference's
    row order).  Then LC_SCHEDULE_STEPS steps under each schedule,
    timed."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.ops import update_kernel
    from mxnet_tpu_torch.ops.attention import PATH_TAKEN
    from mxnet_tpu_torch.parallel import MeshConfig, collectives, ring

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mod = _lc_module(mt, mt.gpu(0), MeshConfig(seq=world))
    x, y = _lc_batch()
    it = mt.io.NDArrayIter(np.tile(x, (LC_STEPS, 1)),
                           np.tile(y, (LC_STEPS, 1)), batch_size=LC_BATCH)
    labels = torch.from_numpy(y.reshape(-1, 1)).long().cuda()
    metric = _lm_loss_metric(torch, labels)
    steps = []
    collectives.SYNC_TIMING = True
    PATH_TAKEN["last"] = ring.RING_PATH["last"] = None
    update_kernel.UPDATE_PATH["last"] = None

    def begin():
        torch.cuda.synchronize()
        collectives.reset_counts()
        return _resume_counts(zero=True), time.perf_counter()

    state = {"mark": begin()}

    def on_batch(param):
        torch.cuda.synchronize()
        _, t_start = state["mark"]
        steps.append({"s": time.perf_counter() - t_start,
                      "launches": _resume_counts(),
                      "collectives": {k: dict(v) for k, v in
                                      collectives.COUNTS.items()}})
        if len(steps) == 1:
            # every rank reads them (get_params / get_outputs may gather)
            arg, _ = mod.get_params()
            cols = mod.get_outputs()[0].data[:, :LC_COLS].clone()
            if rank == 0:
                torch.save({"params": {k: v.data.clone() for k, v in
                                       arg.items()}, "cols": cols},
                           os.path.join(outdir, "lc_step1.pt"))
        state["mark"] = begin()

    mod.fit(it, eval_metric=metric, batch_end_callback=on_batch,
            optimizer="sgd", optimizer_params={"learning_rate": LC_LR,
                                               "momentum": LC_MOMENTUM},
            num_epoch=1)
    paths = {"attention": PATH_TAKEN["last"],
             "ring": ring.RING_PATH["last"],
             "update": update_kernel.UPDATE_PATH["last"],
             "slab_update": mod._slab_update is not None,
             "train_step": mod._train_step is not None}
    batch = DataBatch([nd.array(x)], [nd.array(y)])
    schedules = {}
    for name, db in (("overlapped", True), ("serial", False)):
        with config.overrides(MXNET_RING_DOUBLE_BUFFER=db):
            times = []
            for _ in range(LC_SCHEDULE_STEPS):
                state["mark"] = begin()
                mod.forward_backward(batch)
                mod.update()
                torch.cuda.synchronize()
                times.append({"s": time.perf_counter() - state["mark"][1],
                              "collectives": {k: dict(v) for k, v in
                                              collectives.COUNTS.items()}})
            schedules[name] = times
    collectives.SYNC_TIMING = False
    reading = {"rank": rank, "world": world, "steps": steps,
               "schedules": schedules, "paths": paths,
               "losses": [float(v) for v in metric.losses],
               # the path's own peak (above what the process held before)
               "peak_bytes": torch.cuda.max_memory_allocated() - base,
               "local_data_shape": list(
                   mod._exec_group.exec_.arg_dict["data"].shape),
               "wall_s": time.perf_counter() - t_start}
    with open(os.path.join(outdir, "lm_rank%d.json" % rank), "w") as f:
        json.dump(reading, f)
    del mod
    gc.collect()
    torch.cuda.empty_cache()


def _ring_op_gate(ranks):
    """(a)'s gates, the list of what failed: the path, the launches (rank
    0 C, D, E once: its second hop is skipped; rank 1 twice: the
    diagonal, then a full block), the bytes sent (forward 1 K and 1 V
    block; backward 1 K / V rotation and 2 dK / dV rotations, f32; G = 2
    half), both schedules bit for bit, the plain ring and the single
    process within tolerance, finite values."""
    failed = []
    hd = LC_EMBED // LC_HEADS
    tl = LC_T // P23_RANKS
    for rd in ranks:
        r = rd["rank"]
        for c in rd["cases"]:
            what = "rank %d %s G=%d" % (r, c["dtype"], c["groups"])
            isz = 4 if c["dtype"] == "float32" else 2
            kv_block = LC_BATCH * c["kv_heads"] * tl * hd * isz
            acc_block = LC_BATCH * c["kv_heads"] * tl * hd * 4
            want_l = 1 + r
            for mode in ("mapped", "serial"):
                info = c[mode]
                if info["path"] != "flash" or info["launches"] != {
                        "flash_fwd": want_l, "flash_bwd_dq": want_l,
                        "flash_bwd_dkv": want_l}:
                    failed.append("%s %s: path %s, launches %s" % (
                        what, mode, info["path"], info["launches"]))
                sends = (info["send_fwd"].get("bytes", 0),
                         info["send"].get("bytes", 0))
                want = (2 * kv_block, 4 * kv_block + 4 * acc_block)
                if sends != want:
                    failed.append("%s %s: sent %s bytes, want %s"
                                  % (what, mode, sends, want))
            if not (c["schedules_equal"] and c["finite"]):
                failed.append("%s: serial equal %s, finite %s"
                              % (what, c["schedules_equal"], c["finite"]))
            for ref in ("vs_plain_ring", "vs_single"):
                for n, (err, lim) in c.get(ref, {}).items():
                    if not err <= lim:
                        failed.append("%s %s %s: %.3g > %.3g"
                                      % (what, ref, n, err, lim))
    for dname in ("float32", "bfloat16"):
        by_g = {c["groups"]: c for c in ranks[0]["cases"]
                if c["dtype"] == dname}
        if by_g[2]["mapped"]["send"]["bytes"] * 2 \
                != by_g[1]["mapped"]["send"]["bytes"]:
            failed.append("%s: G = 2 sent %s bytes, G = 1 %s" % (
                dname, by_g[2]["mapped"]["send"], by_g[1]["mapped"]["send"]))
    return failed


def _ring_hop_cases(torch, dev, flush):
    """Kernels C, D and E at the ring's hop, (B x H, T / 2, hd) = (32,
    4096, 128): the diagonal hop (causal) in f32 and bf16 at G 1 and 2,
    and a full hop (not causal) in f32 at G 1; against their plain
    versions (TOL_F32 / TOL_BF16), timed beside SDPA (its forward for C,
    its backward through autograd for D and E)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import flash_kernel as fl

    g = torch.Generator(device=dev)
    g.manual_seed(24)
    b, h, hd = LC_BATCH, LC_HEADS, LC_EMBED // LC_HEADS
    t = LC_T // P23_RANKS
    bh = b * h
    scale = hd ** -0.5
    cases = {"C": [], "D": [], "E": []}
    for dname, groups, causal in (("float32", 1, True), ("float32", 1, False),
                                  ("bfloat16", 1, True), ("float32", 2, True),
                                  ("bfloat16", 2, True)):
        dtype = getattr(torch, dname)
        isz = torch.empty((), dtype=dtype).element_size()
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        pairs = t * (t + 1) // 2 if causal else t * t

        def r(rows):
            return torch.randn(rows, t, hd, generator=g,
                               device=dev).to(dtype)

        bkv = bh // groups
        q, do, k, v = r(bh), r(bh), r(bkv), r(bkv)
        args = (scale, causal, groups)
        what = "ring hop %s G=%d %s" % (dname, groups,
                                        "diagonal" if causal else "full")
        o, lse = fl.flash_fwd(q, k, v, *args)
        delta = fl.flash_delta(o, do)
        dq = fl.flash_bwd_dq(q, k, v, do, lse, delta, *args)
        dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, delta, *args)
        variants = {"C": fl.LAST_VARIANT["flash_fwd"],
                    "D": fl.LAST_VARIANT["flash_bwd_dq"],
                    "E": fl.LAST_VARIANT["flash_bwd_dkv"]}
        # each kernel's largest error beside the limit its check applied
        # (tol x max(1, max |plain|))
        errs, limits = {}, {}

        def check(name, label, got, want, tol_):
            err = _check_close(what + " " + label, got, want, tol_)
            if name not in errs or err > errs[name]:
                errs[name] = err
                limits[name] = _close_err(got, want, tol_)[1]

        wo, wlse = fl.flash_plain_fwd(q, k, v, *args)
        check("C", "C o", o, wo, tol)
        check("C", "C lse", lse, wlse, TOL_F32)
        del wo, wlse
        wdq, wdk, wdv = fl.flash_plain_bwd(q, k, v, o, lse, do, *args)
        check("D", "D dq", dq, wdq, tol)
        check("E", "E dk", dk, wdk, tol)
        check("E", "E dv", dv, wdv, tol)
        del wdq, wdk, wdv
        q4 = q.view(b, h, t, hd)
        k4, v4 = k.view(b, h // groups, t, hd), v.view(b, h // groups, t, hd)
        sdpa_kw = dict(is_causal=causal, scale=scale, enable_gqa=groups > 1)
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
            case = _case(torch, flush, *fns[name], extra={
                "kernel": name, "dtype": dname, "bh": bh, "t": t, "hd": hd,
                "groups": groups, "causal": causal,
                "max_abs_err": errs[name], "limit": limits[name],
                "tol": tol, "bound_ms": bound_ms, "bound_by": bound_by,
                "variant": variants[name]}, iters=5)
            case["bound_share"] = _bound_share(case)
            log("ring hop kernel %s case: %s" % (name, json.dumps(case)))
            cases[name].append(case)
        del lo, leaves, q, do, k, v, o, lse, delta, dq, dk, dv
        gc.collect()
        torch.cuda.empty_cache()
    return cases


def _lc_single(torch, x, y, plain=False):
    """One eager single-process step of the long-context LM on the card
    (kernels C-E on the whole T; ``plain``: their plain versions):
    (parameters after it, the step's outputs' first LC_COLS columns, its
    seconds, its peak memory above what the process held before)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with config.overrides(MXNET_FUSED_TRAIN_STEP=False):
        mod = _lc_module(mt, mt.gpu(0), plain=plain)
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": LC_LR, "momentum": LC_MOMENTUM})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.forward_backward(DataBatch([nd.array(x)], [nd.array(y)]))
    mod.update()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    cols = mod.get_outputs()[0].data[:, :LC_COLS].clone()
    params = {k: v for k, v in _snapshot(mod).items()
              if not k.startswith("aux:")}
    peak = torch.cuda.max_memory_allocated() - base
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    return params, cols, step_s, peak


def _lc_diff(torch, got, want, start):
    """The worst per-tensor ||got - want|| / ||want - start|| (k_bias on
    q_bias's change: its gradient is zero, softmax does not see a shift
    of the keys), and its tensor."""
    worst, name = 0.0, None
    for n, w in want.items():
        ref = "q_bias" if n == "k_bias" else n
        denom = float(torch.linalg.vector_norm((want[ref]
                                                - start[ref]).double()))
        e = float(torch.linalg.vector_norm((got[n] - w).double())) \
            / max(denom, 1e-30)
        if e > worst:
            worst, name = e, n
    return {"max": worst, "tensor": name}


def _cols_diff(torch, got, want):
    """max |got - want| / max |want| over the output columns."""
    return float((got - want).abs().max()) / float(want.abs().max())


def _ring_lm_phase(torch, dev, ranks, step1):
    """(b): the ranks' readings against single-process steps of the same
    Module (kernels C-E on the whole T): the step-1 parameters and
    outputs (row for row) within CAPTURE_SPREAD times the widest
    single-process spread (the same run again; the plain versions; the
    two sequences swapped, whose per-token gradient sums run in another
    order); the launches (C, D, E 1 a step on rank 0, 2 on rank 1; B1 1),
    the ring path, finite losses."""
    import mxnet_tpu_torch as mt

    x, y = _lc_batch()
    params = _lc_params(_lc_sym(mt))
    start = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}
    del params
    got = {n: v.to(dev) for n, v in step1["params"].items()}
    got_cols = step1["cols"].to(dev)
    t0 = time.perf_counter()
    # the first run is the process's first LM step on the card (cold);
    # the second times the warm step
    single, cols, cold_s, single_peak = _lc_single(torch, x, y)
    again, a_cols, single_s, _ = _lc_single(torch, x, y)
    plain, p_cols, plain_s, _ = _lc_single(torch, x, y, plain=True)
    swapped, w_cols, _, _ = _lc_single(torch, x[::-1].copy(),
                                       y[::-1].copy())
    # the swapped run's rows back in the batch's order
    w_cols = torch.cat([w_cols[LC_T:], w_cols[:LC_T]])
    single_runs_s = time.perf_counter() - t0
    spreads = {"again": _lc_diff(torch, again, single, start),
               "plain": _lc_diff(torch, plain, single, start),
               "reorder": _lc_diff(torch, swapped, single, start)}
    col_spreads = {"again": _cols_diff(torch, a_cols, cols),
                   "plain": _cols_diff(torch, p_cols, cols),
                   "reorder": _cols_diff(torch, w_cols, cols)}
    vs_single = _lc_diff(torch, got, single, start)
    cols_vs_single = _cols_diff(torch, got_cols, cols)
    bound = CAPTURE_SPREAD * max(1e-7, *(s["max"] for s in
                                         spreads.values()))
    col_bound = CAPTURE_SPREAD * max(1e-7, *col_spreads.values())
    del got, got_cols, single, cols, again, a_cols, plain, p_cols
    del swapped, w_cols, start
    gc.collect()
    torch.cuda.empty_cache()
    failed = []
    if not vs_single["max"] <= bound:
        failed.append("step-1 parameters %.6g (%s) beyond the bound %.6g"
                      % (vs_single["max"], vs_single["tensor"], bound))
    if not cols_vs_single <= col_bound:
        failed.append("step-1 outputs %.6g beyond the bound %.6g"
                      % (cols_vs_single, col_bound))
    for rd in ranks:
        want = {"flash_fwd": 1 + rd["rank"], "flash_bwd_dq": 1 + rd["rank"],
                "flash_bwd_dkv": 1 + rd["rank"], "multi_tensor_update": 1}
        for i, s in enumerate(rd["steps"]):
            got_l = {k: s["launches"][k] for k in want}
            if got_l != want:
                failed.append("rank %d step %d launched %s, want %s"
                              % (rd["rank"], i + 1, got_l, want))
        if len(rd["steps"]) != LC_STEPS \
                or rd["paths"] != {"attention": "ring", "ring": "flash",
                                   "update": "kernel", "slab_update": True,
                                   "train_step": False} \
                or not all(np.isfinite(rd["losses"])) \
                or rd["local_data_shape"] != [LC_BATCH, LC_T // P23_RANKS]:
            failed.append("rank %d: %d steps, paths %s, losses %s, local "
                          "data %s" % (rd["rank"], len(rd["steps"]),
                                       rd["paths"], rd["losses"],
                                       rd["local_data_shape"]))
    if failed:
        raise AssertionError("phase 23 (b): " + "; ".join(failed))
    per_rank = []
    for rd in ranks:
        timed = rd["steps"][1:] or rd["steps"]
        n = len(timed)
        kinds = sorted({k for s in timed for k in s["collectives"]})
        step_s = sum(s["s"] for s in timed) / n
        sched = {name: {"step_s": [s["s"] for s in runs],
                        "send_s": [s["collectives"].get("send", {}).get(
                            "s", 0.0) + s["collectives"].get(
                            "recv", {}).get("s", 0.0) for s in runs],
                        "tokens_per_s": LC_BATCH * LC_T
                        / (sum(s["s"] for s in runs) / len(runs))}
                 for name, runs in rd["schedules"].items()}
        per_rank.append({
            "rank": rd["rank"],
            "launches_per_step": {k: sum(s["launches"][k] for s in timed)
                                  / n for k in ("flash_fwd", "flash_bwd_dq",
                                                "flash_bwd_dkv",
                                                "multi_tensor_update")},
            "collectives_per_step": {k: {
                f: sum(s["collectives"].get(k, {}).get(f, 0)
                       for s in timed) / n for f in ("calls", "bytes", "s")}
                for k in kinds},
            "fit_step_s": [s["s"] for s in rd["steps"]],
            "fit_tokens_per_s": LC_BATCH * LC_T / step_s,
            "schedules": sched, "losses": rd["losses"],
            "peak_bytes": rd["peak_bytes"]})
    reading = {
        "card": _smi_line(),
        "config": "bench_long_context.py's LM (T %d, batch %d, embed %d, "
                  "%d heads, vocab %d; nothing cut), f32, SGD lr %g "
                  "momentum %g, Module(mesh_config=MeshConfig(seq=%d)): %d "
                  "ranks over gloo on one card, %d fit steps, then %d "
                  "steps a schedule" % (LC_T, LC_BATCH, LC_EMBED, LC_HEADS,
                                        LC_VOCAB, LC_LR, LC_MOMENTUM,
                                        P23_RANKS, P23_RANKS, LC_STEPS,
                                        LC_SCHEDULE_STEPS),
        "step1_vs_single": vs_single, "step1_spreads": spreads,
        "bound": bound, "step1_cols_vs_single": cols_vs_single,
        "cols_spreads": col_spreads, "cols_bound": col_bound,
        "max_over_spread": CAPTURE_SPREAD,
        "single": {"step_s": single_s, "cold_step_s": cold_s,
                   "plain_step_s": plain_s,
                   "tokens_per_s": LC_BATCH * LC_T / single_s,
                   "peak_bytes": single_peak},
        "single_runs_s": single_runs_s, "ranks": per_rank}
    log("ring (b): " + json.dumps(reading))
    launches = {k: sum(s["launches"][k] for rd in ranks
                       for s in rd["steps"])
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                          "multi_tensor_update")}
    return reading, launches


def phase_ring(torch, dev, spawned=None):
    """Phase 23 (see the module's docstring): (a) the op, (b) the LM over
    a seq axis of P23_RANKS, then C / D / E at the hop shape.  The ranks'
    readings come from phase 22's processes (``spawned``: its return's
    "ring") or, alone, from a spawn of its own.  Returns the launches of
    (a) and (b) and the hop cases."""
    t0 = time.perf_counter()
    if spawned is None:
        ranks, outdir, wall = _spawn_ranks(23, P23_RANKS, ("op", "lm"),
                                           P23_RANK_TIMEOUT)
        try:
            step1 = torch.load(os.path.join(outdir, "lc_step1.pt"))
        finally:
            shutil.rmtree(outdir, ignore_errors=True)
    else:
        ranks = {"op": spawned["op"], "lm": spawned["lm"]}
        step1, wall = spawned["step1"], spawned["wall_s"]
    failed = _ring_op_gate(ranks["op"])
    if failed:
        raise AssertionError("phase 23 (a): " + "; ".join(failed))
    op_launches = {k: sum(c["mapped"]["launches"][k] for rd in ranks["op"]
                          for c in rd["cases"])
                   for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    log("ring (a): " + json.dumps({
        "card": _smi_line(),
        "config": "ring_attention under compat.shard_map, MeshConfig("
                  "seq=%d), B %d, T %d, %d heads of %d, causal; G 1 and 2 "
                  "(8 kv-heads), f32 and bf16; tolerances TOL_F32 %g / "
                  "TOL_BF16 %g x max(1, max |reference|)"
                  % (P23_RANKS, LC_BATCH, LC_T, LC_HEADS,
                     LC_EMBED // LC_HEADS, TOL_F32, TOL_BF16),
        "ranks": ranks["op"], "launches": op_launches}))
    lm, lm_launches = _ring_lm_phase(torch, dev, ranks["lm"], step1)
    del step1
    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    hop = _ring_hop_cases(torch, dev, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    log("ring: " + json.dumps({
        "card": _smi_line(), "wall_s": time.perf_counter() - t0,
        "ranks_wall_s": wall,
        "ranks_ring_s": [a["wall_s"] + b["wall_s"] for a, b in
                         zip(ranks["op"], ranks["lm"])],
        "op_launches": op_launches,
        "lm_launches": lm_launches,
        "lm_fit_step_s": [r["fit_step_s"] for r in lm["ranks"]],
        "lm_peak_bytes": [r["peak_bytes"] for r in lm["ranks"]],
        "single_peak_bytes": lm["single"]["peak_bytes"]}))
    return {"op": op_launches, "lm": lm_launches, "hop": hop}


# ---------------------------------------------------------------------------
# phase 24: expert parallelism (the sharded MoE)
# ---------------------------------------------------------------------------
P24_RANKS = 2       # the expert axis: two ranks over gloo on the one card
P24_RANK_TIMEOUT = 500
# (a) the op at the MoE LM layer's shape (phase 16 (b)'s configuration:
# batch 8 x T 2048 tokens of width 1024, 8 experts of hidden 4096, top-2,
# capacity factor 1.25), f32, the aux term at MOE_OP_COEFF: a rank routes
# 8192 tokens into C_loc = 2560 slots an expert
EP_OP_SHAPE = (TRAIN_BATCH * SEQ, EMBED, MOE_EXPERTS, FFN)
# (b) phase 16 (b)'s MoE LM: EP_FIT_STEPS fit steps a rank
EP_FIT_STEPS = 2


def _p24_rank_main(rank, world, address, outdir):
    """One rank of phase 24 run alone (the full smoke runs it in phase
    22's rank processes)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mxnet_tpu_torch.parallel import launch

    launch.init(address, world, rank, backend="gloo")
    _expert_ranks(torch, rank, world, outdir)
    launch.shutdown()
    print("P24_RANK_%d_OK" % rank, flush=True)
    return 0


def _expert_ranks(torch, rank, world, outdir):
    """Phase 24 on one rank: (a) the op, (b) the MoE LM, (c) the serve."""
    for part in (_expert_op_rank, _expert_lm_rank, _expert_serve_rank):
        part(torch, rank, world, outdir)
        gc.collect()
        torch.cuda.empty_cache()


def _ep_op_inputs(torch, dev):
    """(a)'s seeded inputs on the card.  The tokens and the router lie on
    grids of 1/16 and 1/64 (|values| <= 1/2 and 1/4): every router logit
    is a multiple of 2^-10 below 2^7, exact in f32 whatever the order of
    its sums, so a rank's routing of its tokens and the single process's
    routing of all of them are the same bit for bit.  The last two
    experts' router columns are twice the others': their logits spread
    twice as wide, so they draw more than their capacity and choices
    drop."""
    n, d, e, h = EP_OP_SHAPE
    g = torch.Generator(device=dev)
    g.manual_seed(240)
    x = torch.randint(-8, 9, (n, d), generator=g, device=dev).float() / 16
    wg = torch.randint(-8, 9, (d, e), generator=g, device=dev).float() / 64
    wg[:, e - 2:] *= 2

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    return ([x, wg, r(e, d, h) / np.sqrt(d), 0.1 * r(e, h),
             r(e, h, d) / np.sqrt(h), 0.1 * r(e, d)], r(n, d))


def _ep_drop_sets(torch, inputs, y, y_ref, cap):
    """The drop sets of (a)'s two outputs, each read from the output
    itself: at the single process's routing every token's output is the
    sum of its kept choices' terms (gate x the chosen expert's FFN of
    the token), so the kept set of a row is the subset of its k terms
    whose sum lies nearest the row (max |difference| over d), and the
    rest are its dropped choices.  ``residual`` is that nearest
    distance, which must stay within TOL_F32_LONG x max(1, max
    |reference|) for the row to be read at all."""
    x, wg, w1, b1, w2, b2 = inputs
    n, d = x.shape
    k = MOE_TOP_K
    with torch.no_grad():
        from mxnet_tpu_torch.ops import moe

        choice, gate = moe._route(torch.softmax(x @ wg, dim=-1), k)
        terms = torch.zeros(n, k, d, device=x.device)
        for ex in range(w1.shape[0]):
            tok, slot = (choice == ex).nonzero(as_tuple=True)
            hid = torch.relu(x[tok] @ w1[ex] + b1[ex])
            terms[tok, slot] = gate[tok, slot, None] * (hid @ w2[ex] + b2[ex])
        subsets = torch.tensor([[(m >> j) & 1 for j in range(k)]
                                for m in range(1 << k)],
                               dtype=x.dtype, device=x.device)

        def read(out):
            out = out.reshape(n, d)
            resid = torch.stack([
                (out - (terms * s[None, :, None]).sum(1)).abs().amax(-1)
                for s in subsets])                          # (2^k, n)
            best = resid.min(0)
            return subsets[best.indices] == 0, best.values.max()

        drop, res = read(y)
        r_drop, r_res = read(y_ref)
        tol = TOL_F32_LONG * max(1.0, float(y_ref.abs().max()))
        rows = (drop != r_drop).any(-1).nonzero().flatten().tolist()
        del terms
    return {"tokens": n, "capacity": cap,
            "dropped_choices": int(drop.sum()),
            "reference_dropped_choices": int(r_drop.sum()),
            "dropped_rows": int(drop.all(-1).sum()),
            "drops_equal": not rows, "differing_rows": rows[:16],
            "residual": float(res), "reference_residual": float(r_res),
            "residual_tol": tol}


def _expert_op_rank(torch, rank, world, outdir):
    """(a) on one rank: MoEFFN's sharded path (``MoEFn`` over
    ``ops.moe._forward_impl`` on a MoEMesh of MeshConfig(expert=world))
    on EP_OP_SHAPE against the single-process ``_moe_forward_sparse(
    num_groups=world)`` on the same card (outputs TOL_F32, the six
    gradients TOL_F32_LONG, x max(1, max |reference|)); the drop set read
    from the output against the one read from the reference's
    (``_ep_drop_sets``: identical); the exchanges' calls, bytes and seconds a forward and a training step;
    the experts' two products timed; then the dense oracle once."""
    from mxnet_tpu_torch.ops import moe
    from mxnet_tpu_torch.parallel import MeshConfig, build_mesh
    from mxnet_tpu_torch.parallel import collectives as C

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    n, d, e, h = EP_OP_SHAPE
    mesh = moe.MoEMesh.of(build_mesh(MeshConfig(data=1, expert=world)))
    inputs, dy = _ep_op_inputs(torch, dev)
    n_loc = n // world
    cap = moe._capacity(MOE_CF, MOE_TOP_K, n_loc, e, False)
    names = ("y", "d_data", "d_gate_weight", "d_expert1_weight",
             "d_expert1_bias", "d_expert2_weight", "d_expert2_bias")

    def run(fwd):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        torch.cuda.synchronize()
        C.reset_counts()
        t0 = time.perf_counter()
        y = moe.MoEFn.apply(fwd, MOE_OP_COEFF, *leaves)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd_counts = dict(C.COUNTS.get("all_to_all", {}))
        y.backward(dy)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return ([y.detach()] + [t.grad for t in leaves],
                {"fwd_s": t1 - t0, "step_s": t2 - t0,
                 "all_to_all_fwd": fwd_counts,
                 "all_to_all_step": dict(C.COUNTS.get("all_to_all", {})),
                 "all_reduce_step": dict(C.COUNTS.get("all_reduce", {}))})

    C.SYNC_TIMING = True
    cases = {}
    for kind, cf in (("sparse", MOE_CF), ("dense", 0.0)):
        fwd = moe._forward_impl(e, cf, MOE_TOP_K, False, mesh)
        run(fwd)                                    # warm-up
        got, info = run(fwd)
        info["path"] = moe.MOE_PATH["last"]
        if kind == "sparse":
            ref_fwd = lambda *a: moe._moe_forward_sparse(   # noqa: E731
                *a, e, cf, num_experts_per_tok=MOE_TOP_K, num_groups=world)
        else:
            ref_fwd = lambda *a: moe._moe_forward(          # noqa: E731
                *a, e, num_experts_per_tok=MOE_TOP_K)
        want, ref_info = run(ref_fwd)
        info["single_fwd_s"] = ref_info["fwd_s"]
        info["single_step_s"] = ref_info["step_s"]
        info["errors"] = {
            nm: _close_err(a, b, TOL_F32 if nm == "y" else TOL_F32_LONG)
            for nm, a, b in zip(names, got, want)}
        info["finite"] = all(bool(torch.isfinite(t).all()) for t in got)
        if kind == "sparse":
            info["routing"] = _ep_drop_sets(torch, inputs, got[0], want[0],
                                            cap)
            # the experts' two products at the rank's shapes, timed
            e_loc = e // world
            xs = torch.randn(e_loc, world * cap, d, device=dev)
            w1, w2 = inputs[2][:e_loc], inputs[4][:e_loc]
            hid = torch.relu(torch.bmm(xs, w1))
            info["bmm_ms"] = {"ffn1": _event_ms(torch, lambda: torch.bmm(
                                  xs, w1)),
                              "ffn2": _event_ms(torch, lambda: torch.bmm(
                                  hid, w2))}
            info["bmm_shapes"] = [[e_loc, world * cap, d, h],
                                  [e_loc, world * cap, h, d]]
            del xs, hid
        cases[kind] = info
        del got, want
        gc.collect()
        torch.cuda.empty_cache()
    C.SYNC_TIMING = False
    with open(os.path.join(outdir, "ep_op_rank%d.json" % rank), "w") as f:
        json.dump({"rank": rank, "cases": cases,
                   "wall_s": time.perf_counter() - t_start}, f)


def _ep_sym():
    """Phase 16 (b)'s MoE LM at MOE_CF."""
    from mxnet_tpu_torch.models import attention_lm

    return attention_lm.get_symbol(
        vocab_size=VOCAB, seq_len=SEQ, num_layers=MOE_TRAIN_LAYERS,
        embed=EMBED, heads=TRAIN_HEADS, ffn_hidden=FFN,
        moe_experts=MOE_EXPERTS, moe_capacity_factor=MOE_CF,
        moe_top_k=MOE_TOP_K)


def _ep_batch():
    """Phase 16 (b)'s batch."""
    rng = np.random.RandomState(1)
    x = rng.randint(0, VOCAB, size=(TRAIN_BATCH, SEQ)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((TRAIN_BATCH, 1), np.float32)],
                       axis=1)
    return x, y


def _ep_module(mt, sym, params, plain=False, mesh_config=None,
               optimizer=True):
    from mxnet_tpu_torch.io import DataDesc

    kw = {} if mesh_config is None else {"mesh_config": mesh_config}
    mod = mt.mod.Module(sym, context=mt.gpu(0), plain=plain, **kw)
    mod.bind(data_shapes=[DataDesc("data", (TRAIN_BATCH, SEQ),
                                   layout="NT")],
             label_shapes=[DataDesc("softmax_label", (TRAIN_BATCH, SEQ),
                                    layout="NT")])
    mod.init_params(arg_params=params, aux_params={})
    if optimizer:
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": TRAIN_LR, "momentum": MOE_MOMENTUM})
    return mod


def _expert_lm_rank(torch, rank, world, outdir, mc=None, tag="ep_lm",
                    steps_n=None):
    """(b) on one rank: the MoE LM through
    ``Module(mesh_config=MeshConfig(expert=world))`` (or ``mc``),
    EP_FIT_STEPS (or ``steps_n``) ``fit`` steps: each step's launches,
    collectives and seconds, the losses, the peak memory; then one step
    of the same mesh on the plain versions from the same parameters, and
    rank 0 holds the step-1 parameters and the outputs' first LC_COLS
    columns of the two against each other.  Written as ``<tag>_rank<r>``
    (phase 25 (a) runs it over MeshConfig(seq=2, expert=2))."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.ops import moe, update_kernel
    from mxnet_tpu_torch.parallel import MeshConfig, collectives

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    mc = mc or MeshConfig(data=1, expert=world)
    steps_n = steps_n or EP_FIT_STEPS
    sym = _ep_sym()
    params = _train_params(sym)
    x, y = _ep_batch()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mod = _ep_module(mt, sym, params, mesh_config=mc, optimizer=False)
    it = mt.io.NDArrayIter(np.tile(x, (steps_n, 1)),
                           np.tile(y, (steps_n, 1)),
                           batch_size=TRAIN_BATCH)
    labels = torch.from_numpy(y.reshape(-1, 1)).long().to(dev)
    metric = _lm_loss_metric(torch, labels)
    steps, first = [], {}
    collectives.SYNC_TIMING = True
    moe.MOE_PATH["last"] = update_kernel.UPDATE_PATH["last"] = None

    def begin():
        torch.cuda.synchronize()
        collectives.reset_counts()
        return _resume_counts(zero=True), time.perf_counter()

    state = {"mark": begin()}

    def on_batch(param):
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - state["mark"][1],
                      "launches": _resume_counts(),
                      "collectives": {k: dict(v) for k, v in
                                      collectives.COUNTS.items()}})
        if len(steps) == 1:
            # every rank reads them (get_params gathers the stacks)
            arg, _ = mod.get_params()
            first["params"] = {k: v.data.to(dev).clone()
                               for k, v in arg.items()}
            first["cols"] = mod.get_outputs()[0].data[:, :LC_COLS].clone()
        state["mark"] = begin()

    mod.fit(it, eval_metric=metric, batch_end_callback=on_batch,
            optimizer="sgd", optimizer_params={"learning_rate": TRAIN_LR,
                                               "momentum": MOE_MOMENTUM},
            num_epoch=1)
    collectives.SYNC_TIMING = False
    peak = torch.cuda.max_memory_allocated() - base
    paths = {"moe": moe.MOE_PATH["last"],
             "update": update_kernel.UPDATE_PATH["last"],
             "slab_update": mod._slab_update is not None,
             "train_step": mod._train_step is not None}
    local = {n: list(mod._exec_group.exec_.arg_dict[n].shape)
             for n in mod._exec_group.param_names if "_moe_" in n}
    local["data"] = list(mod._exec_group.exec_.arg_dict["data"].shape)
    seq_rank = mod._mesh.seq_rank
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    # the same mesh on the plain versions, one step
    pmod = _ep_module(mt, sym, params, plain=True, mesh_config=mc)
    pmod.forward_backward(DataBatch([nd.array(x)], [nd.array(y)]))
    pmod.update()
    arg, _ = pmod.get_params()
    plain = {k: v.data.to(dev).clone() for k, v in arg.items()}
    p_cols = pmod.get_outputs()[0].data[:, :LC_COLS].clone()
    del pmod, arg
    reading = {"rank": rank, "world": world, "steps": steps,
               "seq_rank": seq_rank,
               "paths": paths, "local_expert_shapes": local,
               "losses": [float(v) for v in metric.losses],
               "peak_bytes": peak,
               "wall_s": time.perf_counter() - t_start}
    if rank == 0:
        start = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}
        reading["vs_plain"] = _run_diff(torch, first["params"], plain,
                                        start, _MOE_DIRECT)
        reading["cols_vs_plain"] = _cols_diff(torch, first["cols"], p_cols)
        del start
    del first, plain
    with open(os.path.join(outdir, "%s_rank%d.json" % (tag, rank)),
              "w") as f:
        json.dump(reading, f)


def _expert_serve_rank(torch, rank, world, outdir):
    """(c) on one rank: phase 16 (c)'s MoE serve model and phase 5's
    requests through ``DecodePredictor(mesh=MeshConfig(expert=world))``
    and a DecodeServer (eager programs): its tokens, A and B launches,
    exchanges, tokens/s, TTFT; then teacher-forced against the same mesh
    on the plain versions (phase 16 (c)'s gate)."""
    from mxnet_tpu_torch.ops import decode_kernel as dk
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.ops import moe
    from mxnet_tpu_torch.parallel import MeshConfig, collectives

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    mc = MeshConfig(data=1, expert=world)
    sym, params, n_params = _lm(torch, dev, **MOE_SERVE)
    pred = _predictor(sym, params, False, dev, mesh=mc)
    prompts = _prompts()
    _serve(torch, pred, [p[:64] for p in prompts[:2]])
    collectives.SYNC_TIMING = True
    collectives.reset_counts()
    fk.LAUNCHES["fused_fwd"] = 0
    dk.LAUNCHES["paged_decode"] = dk.LAUNCHES["paged_combine"] = 0
    moe.MOE_PATH["last"] = None
    torch.cuda.reset_peak_memory_stats()
    results, wall, stats = _serve(torch, pred, prompts)
    launches = {"fused_fwd": fk.LAUNCHES["fused_fwd"],
                "paged_decode": dk.LAUNCHES["paged_decode"],
                "paged_combine": dk.LAUNCHES["paged_combine"]}
    collectives.SYNC_TIMING = False
    path = moe.MOE_PATH["last"]
    counts = {k: dict(v) for k, v in collectives.COUNTS.items()}
    peak = torch.cuda.max_memory_allocated()
    plain = _predictor(sym, params, True, dev, mesh=mc)
    forced = torch.tensor([[int(results[i][s]) for s in range(8)]
                           for i in range(SLOTS)], dtype=torch.int32,
                          device=dev)
    _, forced_reading = _teacher_forced_moe(torch, moe, pred, plain,
                                            prompts, forced)
    tokens = sum(len(t) for t in results.values())
    reading = {
        "rank": rank, "world": world, "params": n_params,
        "tokens": {str(k): np.asarray(v).tolist()
                   for k, v in results.items()},
        "path": path, "launches": launches, "collectives": counts,
        "steps": stats["steps"], "chunks": stats["chunks"],
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_p50_s": stats.get("ttft_p50_s"),
        "ttft_p95_s": stats.get("ttft_p95_s"),
        "peak_bytes": peak, "teacher_forced": forced_reading,
        "expert_stacks_whole": list(pred._env[
            "layer0_moe_expert1_weight"].shape),
        "phase_wall_s": time.perf_counter() - t_start}
    del pred, plain
    with open(os.path.join(outdir, "ep_serve_rank%d.json" % rank), "w") as f:
        json.dump(reading, f)


def _ep_single(torch, x, y, plain=False):
    """One eager single-process step of the MoE LM on the card (one
    capacity quota over the batch): (parameters after it, the outputs'
    first LC_COLS columns, its seconds, its peak memory above what the
    process held before)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch.io import DataBatch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sym = _ep_sym()
    with config.overrides(MXNET_FUSED_TRAIN_STEP=False):
        mod = _ep_module(mt, sym, _train_params(sym), plain=plain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.forward_backward(DataBatch([nd.array(x)], [nd.array(y)]))
    mod.update()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    cols = mod.get_outputs()[0].data[:, :LC_COLS].clone()
    params = {k: v for k, v in _snapshot(mod).items()
              if not k.startswith("aux:")}
    peak = torch.cuda.max_memory_allocated() - base
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    return params, cols, step_s, peak


def _ep_op_gate(ranks):
    """(a)'s gates, the list of what failed."""
    failed = []
    for rd in ranks:
        r = rd["rank"]
        for kind, case in rd["cases"].items():
            want = "sparse_a2a" if kind == "sparse" else "dense"
            if case["path"] != want:
                failed.append("rank %d %s path %s" % (r, kind, case["path"]))
            for nm, (err, lim) in case["errors"].items():
                if not err <= lim:
                    failed.append("rank %d %s %s %.3g > %.3g"
                                  % (r, kind, nm, err, lim))
            if not case["finite"]:
                failed.append("rank %d %s not finite" % (r, kind))
        sp = rd["cases"]["sparse"]
        calls = (sp["all_to_all_fwd"].get("calls"),
                 sp["all_to_all_step"].get("calls"))
        if calls != (2, 6):
            failed.append("rank %d exchanges %s, want (2, 6)" % (r, calls))
        n, d, e, _ = EP_OP_SHAPE
        table = e * sp["routing"]["capacity"] * d * 4
        if sp["all_to_all_step"].get("bytes") != 6 * table:
            failed.append("rank %d exchange bytes %s, want 6 x %d"
                          % (r, sp["all_to_all_step"].get("bytes"), table))
        rt = sp["routing"]
        if rt["reference_dropped_choices"] <= 0:
            failed.append("rank %d: capacity never bound" % r)
        if not (rt["drops_equal"] and rt["residual"] <= rt["residual_tol"]
                and rt["reference_residual"] <= rt["residual_tol"]):
            failed.append("rank %d drop set against the single process: %s"
                          % (r, rt))
        if rd["cases"]["dense"]["all_to_all_step"]:
            failed.append("rank %d dense exchanged" % r)
    return failed


def _ep_lm_phase(torch, dev, ranks):
    """(b): the ranks' readings (launches and exchanges a step, paths,
    falling losses) and rank 0's step-1 parameters and outputs against
    the same mesh on the plain versions, within CAPTURE_SPREAD times the
    widest spread of single-process steps (again; the plain versions)."""
    x, y = _ep_batch()
    sym = _ep_sym()
    start = {n: torch.from_numpy(v).to(dev)
             for n, v in _train_params(sym).items()}
    single, cols, cold_s, single_peak = _ep_single(torch, x, y)
    again, a_cols, single_s, _ = _ep_single(torch, x, y)
    plain, p_cols, plain_s, _ = _ep_single(torch, x, y, plain=True)
    spreads = {"again": _run_diff(torch, again, single, start, _MOE_DIRECT),
               "plain": _run_diff(torch, plain, single, start, _MOE_DIRECT)}
    col_spreads = {"again": _cols_diff(torch, a_cols, cols),
                   "plain": _cols_diff(torch, p_cols, cols)}
    del single, again, plain, start
    gc.collect()
    torch.cuda.empty_cache()
    want = {"fused_fwd": 3 * MOE_TRAIN_LAYERS,
            "fused_bwd": 3 * MOE_TRAIN_LAYERS,
            "flash_fwd": MOE_TRAIN_LAYERS, "flash_bwd_dq": MOE_TRAIN_LAYERS,
            "flash_bwd_dkv": MOE_TRAIN_LAYERS, "multi_tensor_update": 1}
    failed = []
    for rd in ranks:
        r = rd["rank"]
        if len(rd["steps"]) != EP_FIT_STEPS:
            failed.append("rank %d ran %d steps" % (r, len(rd["steps"])))
        for i, st in enumerate(rd["steps"]):
            if st["launches"] != want:
                failed.append("rank %d step %d launches %s" % (
                    r, i, st["launches"]))
            a2a = st["collectives"].get("all_to_all", {}).get("calls")
            if a2a != 6 * MOE_TRAIN_LAYERS:
                failed.append("rank %d step %d exchanges %s" % (r, i, a2a))
        if rd["paths"] != {"moe": "sparse_a2a", "update": "kernel",
                           "slab_update": True, "train_step": False}:
            failed.append("rank %d paths %s" % (r, rd["paths"]))
        losses = rd["losses"]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            failed.append("rank %d losses %s" % (r, losses))
    vs = ranks[0]["vs_plain"]
    bounds = {tier: CAPTURE_SPREAD * max(
        1e-7, *(s["tiers"][tier]["max"] for s in spreads.values()))
        for tier in ("before_relu", "behind_relu")}
    col_bound = CAPTURE_SPREAD * max(1e-7, *col_spreads.values())
    for tier, bound in bounds.items():
        if not vs["tiers"][tier]["max"] <= bound:
            failed.append("step-1 %s against the plain mesh %.3g > %.3g"
                          % (tier, vs["tiers"][tier]["max"], bound))
    if not ranks[0]["cols_vs_plain"] <= col_bound:
        failed.append("step-1 outputs against the plain mesh %.3g > %.3g"
                      % (ranks[0]["cols_vs_plain"], col_bound))
    step_s = [float(np.mean([st["s"] for st in rd["steps"][1:]]))
              for rd in ranks]
    reading = {
        "config": "phase 16 (b)'s MoE LM (vocab %d, T %d, batch %d, embed "
                  "%d, %d heads, FFN %d, %d experts, top-%d, cf %g, %d "
                  "layer, f32, SGD lr %g momentum %g) through Module("
                  "mesh_config=MeshConfig(expert=%d)), %d fit steps"
                  % (VOCAB, SEQ, TRAIN_BATCH, EMBED, TRAIN_HEADS, FFN,
                     MOE_EXPERTS, MOE_TOP_K, MOE_CF, MOE_TRAIN_LAYERS,
                     TRAIN_LR, MOE_MOMENTUM, P24_RANKS, EP_FIT_STEPS),
        "ranks": ranks, "spreads": spreads, "col_spreads": col_spreads,
        "bounds": bounds, "col_bound": col_bound,
        "step_s": step_s,
        "tokens_per_s_pair": TRAIN_BATCH * SEQ / max(step_s),
        "single": {"step_s": single_s, "cold_step_s": cold_s,
                   "plain_step_s": plain_s, "peak_bytes": single_peak,
                   "tokens_per_s": TRAIN_BATCH * SEQ / single_s}}
    log("expert (b): " + json.dumps(reading))
    if failed:
        raise AssertionError("phase 24 (b): " + "; ".join(failed))
    launches = {k: sum(st["launches"][k] for rd in ranks
                       for st in rd["steps"]) for k in want}
    return reading, launches


def _ep_serve_gate(ranks):
    failed = []
    t0 = ranks[0]["tokens"]
    for rd in ranks:
        r = rd["rank"]
        if rd["tokens"] != t0:
            failed.append("rank %d's tokens differ from rank 0's" % r)
        if rd["path"] != "sparse_a2a":
            failed.append("rank %d path %s" % (r, rd["path"]))
        if min(rd["launches"].values()) <= 0:
            failed.append("rank %d launches %s" % (r, rd["launches"]))
        tf = rd["teacher_forced"]
        if not tf["max_abs_dlogp"] <= TOL_LOGP \
                or any(f["plain_prob_gap"] > TOL_FLIP_GAP
                       for f in tf["flips"]):
            failed.append("rank %d teacher-forced |dlogp| %.3g (tol %.3g), "
                          "flips %s" % (r, tf["max_abs_dlogp"], TOL_LOGP,
                                        tf["flips"]))
        for toks in rd["tokens"].values():
            if len(toks) != MAX_NEW or min(toks) < 0 or max(toks) >= VOCAB:
                failed.append("rank %d returned %s" % (r, toks))
                break
    return failed


def phase_expert(torch, dev, spawned=None):
    """Phase 24 (see the module's docstring): (a) the op, (b) the MoE LM,
    (c) the serve over an expert axis of P24_RANKS.  The ranks' readings
    come from phase 22's processes (``spawned``) or, alone, from a spawn
    of its own.  Returns the launches of (b) and (c)."""
    t0 = time.perf_counter()
    tags = ("ep_op", "ep_lm", "ep_serve")
    if spawned is None:
        ranks, outdir, wall = _spawn_ranks(24, P24_RANKS, tags,
                                           P24_RANK_TIMEOUT)
        shutil.rmtree(outdir, ignore_errors=True)
    else:
        ranks, wall = spawned["ranks"], spawned["wall_s"]
    failed = _ep_op_gate(ranks["ep_op"])
    log("expert (a): " + json.dumps({
        "card": _smi_line(),
        "config": "MoEFFN's sharded path over MeshConfig(expert=%d): N %d "
                  "tokens, d %d, E %d, h %d, top-%d, cf %g, f32, aux %g; "
                  "against the single-process _moe_forward_sparse("
                  "num_groups=%d) (outputs TOL_F32 %g, gradients "
                  "TOL_F32_LONG %g, x max(1, max |reference|)); the dense "
                  "oracle against _moe_forward"
                  % ((P24_RANKS,) + EP_OP_SHAPE
                     + (MOE_TOP_K, MOE_CF, MOE_OP_COEFF, P24_RANKS, TOL_F32,
                        TOL_F32_LONG)),
        "ranks": ranks["ep_op"]}))
    if failed:
        raise AssertionError("phase 24 (a): " + "; ".join(failed))
    lm, lm_launches = _ep_lm_phase(torch, dev, ranks["ep_lm"])
    gc.collect()
    torch.cuda.empty_cache()
    failed = _ep_serve_gate(ranks["ep_serve"])
    serve_launches = {k: sum(rd["launches"][k] for rd in ranks["ep_serve"])
                      for k in ("fused_fwd", "paged_decode",
                                "paged_combine")}
    log("expert (c): " + json.dumps({
        "card": _smi_line(),
        "config": "phase 16 (c)'s MoE serve model (%d experts, top-%d, cf "
                  "%g) and phase 5's requests over DecodePredictor(mesh="
                  "MeshConfig(expert=%d)), int8 pages, %d slots"
                  % (MOE_EXPERTS, MOE_TOP_K, MOE_CF, P24_RANKS, SLOTS),
        "tol": TOL_LOGP, "tol_flip_gap": TOL_FLIP_GAP,
        "ranks": ranks["ep_serve"]}))
    if failed:
        raise AssertionError("phase 24 (c): " + "; ".join(failed))
    log("expert: " + json.dumps({
        "card": _smi_line(), "wall_s": time.perf_counter() - t0,
        "ranks_wall_s": wall,
        "op_step_s": [rd["cases"]["sparse"]["step_s"]
                      for rd in ranks["ep_op"]],
        "op_exchange_s": [rd["cases"]["sparse"]["all_to_all_step"]["s"]
                          for rd in ranks["ep_op"]],
        "lm_step_s": lm["step_s"],
        "lm_tokens_per_s_pair": lm["tokens_per_s_pair"],
        "lm_peak_bytes": [rd["peak_bytes"] for rd in ranks["ep_lm"]],
        "single_peak_bytes": lm["single"]["peak_bytes"],
        "serve_tokens_per_s": [rd["tokens_per_s"]
                               for rd in ranks["ep_serve"]],
        "serve_ttft_p50_s": [rd["ttft_p50_s"] for rd in ranks["ep_serve"]],
        "lm_launches": lm_launches, "serve_launches": serve_launches}))
    return {"lm": lm_launches, "serve": serve_launches,
            "bounds": lm["bounds"], "col_bound": lm["col_bound"]}


# ---------------------------------------------------------------------------
# phase 25: the expert x seq mesh and the elastic mesh
# ---------------------------------------------------------------------------

P25_RANKS = 4       # (a): MeshConfig(seq=2, expert=2); (b) on ranks 0 and 1
P25_RANK_TIMEOUT = 600
ES_FIT_STEPS = 3    # (a): fit steps of the MoE LM
# (b): phase 17's / 20's training LM (TRAIN_HEADS: heads of 128, which
# the flash kernels take; LAYERS layers) over MeshConfig(data=2), a
# global batch of EL_BATCH, EL_EPOCHS epochs of EL_BATCHES steps, SGD
# with momentum; fences every EL_PERIOD steps; worker 1 stale at EL_STALE
# and back at EL_BACK; then a fit of EL_DEATH_BATCHES steps in which
# rank 1 os._exits at step EL_DEATH_STEP
EL_BATCH, EL_BATCHES, EL_EPOCHS = 8, 3, 2
EL_PERIOD, EL_STALE, EL_BACK = 2, 2, 4
EL_DEATH_BATCHES, EL_DEATH_STEP = 4, 3
EL_MOMENTUM = 0.9
EL_DIRECT = ("head_", "final_", "layer%d_ffn2_" % (LAYERS - 1))
# launches a step a rank of (b)'s LM: A / F 5 a layer, C / D / E 1, B1 1
EL_PER_STEP = {"fused_fwd": 5 * LAYERS, "fused_bwd": 5 * LAYERS,
               "flash_fwd": LAYERS, "flash_bwd_dq": LAYERS,
               "flash_bwd_dkv": LAYERS, "multi_tensor_update": 1}


def _p25_rank_main(rank, world, address, outdir):
    """One rank of phase 25: (a) over all P25_RANKS ranks, then (b) on
    ranks 0 and 1, which form a group of 2 through a rendezvous file in
    ``outdir`` (rank 1 dies in (b)'s last fit)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mxnet_tpu_torch.parallel import MeshConfig, launch

    launch.init(address, world, rank, backend="gloo")
    _expert_lm_rank(torch, rank, world, outdir,
                    mc=MeshConfig(data=1, seq=2, expert=2), tag="es_lm",
                    steps_n=ES_FIT_STEPS)
    launch.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    if rank < 2:
        launch.reform(outdir, 0, [0, 1], rank)
        _elastic_rank(torch, rank, outdir)
    print("P25_RANK_%d_OK" % rank, flush=True)
    return 0


def _el_sym_params():
    from mxnet_tpu_torch.models import attention_lm

    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=SEQ,
                                  num_layers=LAYERS, embed=EMBED,
                                  heads=TRAIN_HEADS, ffn_hidden=FFN)
    return sym, _train_params(sym)


def _el_data(batches):
    rng = np.random.RandomState(25)
    x = rng.randint(0, VOCAB, size=(batches * EL_BATCH, SEQ)) \
        .astype(np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((len(x), 1), np.float32)],
                       axis=1)
    return x, y


def _el_fit(torch, sym, params, x, y, mc=None, ctl=None, epochs=EL_EPOCHS,
            record=None):
    """One ``fit`` of (b)'s LM (a mesh rank with ``mc``, else one
    process); ``record`` gets (epoch, nbatch, data axis, time, the
    step's launches, captured) a step.  Returns the module."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import metric as metric_mod

    kw = {} if mc is None else {"mesh_config": mc}
    mod = mt.mod.Module(sym, context=mt.gpu(0), **kw)
    it = mt.io.NDArrayIter(x, y, batch_size=EL_BATCH)

    def on_batch(p):
        torch.cuda.synchronize()
        if record is not None:
            mesh = mod._mesh
            record.append((p.epoch, p.nbatch,
                           mesh.data if mesh is not None else 1,
                           time.time(), _resume_counts(),
                           mod._train_step is not None))
        _resume_counts(zero=True)

    _resume_counts(zero=True)
    mod.fit(it, eval_metric=metric_mod.Perplexity(None), num_epoch=epochs,
            batch_end_callback=on_batch, optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN_LR,
                              "momentum": EL_MOMENTUM},
            arg_params=params, elastic=ctl)
    torch.cuda.synchronize()
    return mod


def _el_controller(outdir, tag, rank, inj):
    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.parallel import collectives
    from mxnet_tpu_torch.parallel.health import FailureMonitor, Heartbeat

    hb = os.path.join(outdir, "hb-" + tag)
    Heartbeat(hb, rank).beat()       # one worker a rank, stamped once
    collectives.barrier()
    mon = FailureMonitor(hb, num_workers=2, my_rank=rank, timeout=1e6,
                         grace=0)
    return elastic.ElasticController(
        checkpointer=elastic.Checkpointer(os.path.join(outdir, "ck-" + tag),
                                          period=EL_PERIOD,
                                          async_write=False),
        monitor=mon, injector=inj), hb


def _fence_reading(ck):
    step = ck.latest()
    path = os.path.join(ck.directory, str(step))
    return {"step": step, "write_ms": ck.last_write_ms,
            "bytes": sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path)),
            "files": len(os.listdir(path))}


def _elastic_rank(torch, rank, outdir):
    """(b) on rank 0 or 1: an uninterrupted fit, the elastic fit (worker
    1 stale at EL_STALE: rank 0 alone, its step captured; back at
    EL_BACK: regrown), then the fit in which rank 1 dies; rank 0 then
    runs the two single-process references of the bound."""
    from mxnet_tpu_torch import elastic
    from mxnet_tpu_torch.ops import update_kernel
    from mxnet_tpu_torch.parallel import MeshConfig

    dev = torch.device("cuda", 0)
    sym, params = _el_sym_params()
    x, y = _el_data(EL_BATCHES)
    mc = MeshConfig(data=2)
    t0 = time.perf_counter()
    mod = _el_fit(torch, sym, params, x, y, mc=mc)
    whole = {k: v.data.to(dev).clone()
             for k, v in mod.get_params()[0].items()}
    whole_s = time.perf_counter() - t0
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    inj = elastic.FaultInjector()
    ctl, hb = _el_controller(outdir, "shrink", rank, inj)
    inj.stale_heartbeat_at(EL_STALE, hb, 1, age=1e9)
    inj.revive_heartbeat_at(EL_BACK, hb, 1)
    steps = []
    update_kernel.UPDATE_PATH["last"] = None
    t0 = time.perf_counter()
    mod = _el_fit(torch, sym, params, x, y, mc=mc, ctl=ctl, record=steps)
    fit_s = time.perf_counter() - t0
    got = {k: v.data.to(dev).clone() for k, v in mod.get_params()[0].items()}
    reading = {"rank": rank, "recoveries": ctl.recoveries, "steps": steps,
               "reform": ctl.last_reform, "fit_s": fit_s,
               "whole_fit_s": whole_s, "fence": _fence_reading(
                   ctl.checkpointer),
               "update_path": update_kernel.UPDATE_PATH["last"],
               "world_after": mod._mesh.data if mod._mesh else 1}
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        start = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}
        reading["vs_whole"] = _run_diff(torch, got, whole, start, EL_DIRECT)
    with open(os.path.join(outdir, "el_shrink_rank%d.json" % rank),
              "w") as f:
        json.dump(reading, f)
    del got
    # the real death
    xd, yd = _el_data(EL_DEATH_BATCHES)
    inj = elastic.FaultInjector()
    if rank == 1:
        def die():
            with open(os.path.join(outdir, "el_death"), "w") as f:
                f.write(repr(time.time()))
            os._exit(0)
        inj.at_step(EL_DEATH_STEP, die)
    ctl, _ = _el_controller(outdir, "death", rank, inj)
    steps = []
    t0 = time.perf_counter()
    mod = _el_fit(torch, sym, params, xd, yd, mc=mc, ctl=ctl, epochs=1,
                  record=steps)
    death = {"rank": rank, "recoveries": ctl.recoveries, "steps": steps,
             "reform": ctl.last_reform, "fit_s": time.perf_counter() - t0,
             "world_after": mod._mesh.data if mod._mesh else 1}
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    # the bound's single-process spread: the global batch in two orders
    # (each batch's halves swapped: the same sum in another order)
    half = EL_BATCH // 2
    order = np.concatenate([np.arange(i * EL_BATCH + half, (i + 1) * EL_BATCH)
                            .tolist() + np.arange(i * EL_BATCH, i * EL_BATCH
                                                  + half).tolist()
                            for i in range(len(x) // EL_BATCH)])
    singles = []
    for xs, ys in ((x, y), (x[order], y[order])):
        smod = _el_fit(torch, sym, params, xs, ys)
        singles.append({k: v.data.to(dev).clone()
                        for k, v in smod.get_params()[0].items()})
        del smod
        gc.collect()
        torch.cuda.empty_cache()
    start = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}
    death["single_spread"] = _run_diff(torch, singles[1], singles[0], start,
                                       EL_DIRECT)
    death["single_vs_whole"] = _run_diff(torch, singles[0], whole, start,
                                         EL_DIRECT)
    with open(os.path.join(outdir, "el_death_rank%d.json" % rank),
              "w") as f:
        json.dump(death, f)


def _es_gate(ranks, bounds, col_bound):
    """(a): each rank's launches and exchanges a step, paths, falling
    losses, the local blocks; rank 0's step-1 parameters and outputs
    against the same mesh on the plain versions within phase 24's
    bounds (the same model and batch)."""
    failed = []
    for rd in ranks:
        r, sr = rd["rank"], rd["seq_rank"]
        want = {"fused_fwd": 3 * MOE_TRAIN_LAYERS,
                "fused_bwd": 3 * MOE_TRAIN_LAYERS,
                "flash_fwd": (sr + 1) * MOE_TRAIN_LAYERS,
                "flash_bwd_dq": (sr + 1) * MOE_TRAIN_LAYERS,
                "flash_bwd_dkv": (sr + 1) * MOE_TRAIN_LAYERS,
                "multi_tensor_update": 1}
        if len(rd["steps"]) != ES_FIT_STEPS:
            failed.append("rank %d ran %d steps" % (r, len(rd["steps"])))
        for i, st in enumerate(rd["steps"]):
            if st["launches"] != want:
                failed.append("rank %d step %d launches %s, want %s"
                              % (r, i, st["launches"], want))
            a2a = st["collectives"].get("all_to_all", {}).get("calls")
            if a2a != 6 * MOE_TRAIN_LAYERS:
                failed.append("rank %d step %d exchanges %s" % (r, i, a2a))
        if rd["paths"] != {"moe": "sparse_a2a", "update": "kernel",
                           "slab_update": True, "train_step": False}:
            failed.append("rank %d paths %s" % (r, rd["paths"]))
        if rd["local_expert_shapes"]["data"] != [TRAIN_BATCH, SEQ // 2]:
            failed.append("rank %d data block %s" % (
                r, rd["local_expert_shapes"]["data"]))
        losses = rd["losses"]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            failed.append("rank %d losses %s" % (r, losses))
    vs = ranks[0]["vs_plain"]
    for tier, bound in bounds.items():
        if not vs["tiers"][tier]["max"] <= bound:
            failed.append("step-1 %s against the plain mesh %.3g > %.3g"
                          % (tier, vs["tiers"][tier]["max"], bound))
    if not ranks[0]["cols_vs_plain"] <= col_bound:
        failed.append("step-1 outputs against the plain mesh %.3g > %.3g"
                      % (ranks[0]["cols_vs_plain"], col_bound))
    return failed


def _el_gate(shrink, death, died):
    """(b): recoveries, the data axis 2 -> 1 -> 2, every batch of each
    epoch once, the survivor alone on its captured step with B1, the
    launches a step, the final parameters against the uninterrupted
    2-rank run within CAPTURE_SPREAD times the single-process spread;
    the death survived by rank 0."""
    failed = []
    for rd in shrink:
        r = rd["rank"]
        if rd["recoveries"] != 2:
            failed.append("rank %d recoveries %d" % (r, rd["recoveries"]))
        if rd["world_after"] != 2:
            failed.append("rank %d ends at data %s" % (r, rd["world_after"]))
        for st in rd["steps"]:
            if st[4] != EL_PER_STEP:
                failed.append("rank %d step %s launches %s"
                              % (r, st[:2], st[4]))
    s0 = shrink[0]["steps"]
    datas = [st[2] for st in s0]
    want_datas = [2] * EL_STALE + [1] * (EL_BACK - EL_STALE) + [2] * (
        EL_BATCHES * EL_EPOCHS - EL_BACK)
    if datas != want_datas:
        failed.append("rank 0's data axis %s, want %s" % (datas, want_datas))
    alone = [st for st in s0 if st[2] == 1]
    if not alone or not all(st[5] for st in alone):
        failed.append("rank 0 alone without its captured step")
    if shrink[0]["update_path"] != "kernel":
        failed.append("update path %s" % shrink[0]["update_path"])
    for ep in range(EL_EPOCHS):
        seen = sorted(st[1] for st in s0 if st[0] == ep)
        if seen != list(range(EL_BATCHES)):
            failed.append("epoch %d batches %s" % (ep, seen))
    standby = [st for st in shrink[1]["steps"] if st[2] == 1]
    if standby:
        failed.append("rank 1 ran steps while standing by: %s" % standby)
    spread = death[0]["single_spread"]
    vs = shrink[0]["vs_whole"]
    for tier in ("before_relu", "behind_relu"):
        bound = CAPTURE_SPREAD * max(spread["tiers"][tier]["max"], 1e-7)
        if not vs["tiers"][tier]["max"] <= bound:
            failed.append("final %s against the uninterrupted run %.3g > "
                          "%.3g" % (tier, vs["tiers"][tier]["max"], bound))
    d0 = death[0]
    if d0["recoveries"] != 1 or d0["world_after"] != 1:
        failed.append("the death: recoveries %d, data %s"
                      % (d0["recoveries"], d0["world_after"]))
    # the survivor's steps alone on the re-formed mesh: a step that the
    # dying rank's collectives completed may end after its death
    after = [st[3] for st in d0["steps"] if st[2] == 1 and st[3] > died]
    if not after:
        failed.append("rank 0 ran no step on the re-formed mesh")
    if sorted(set(st[1] for st in d0["steps"])) != list(
            range(EL_DEATH_BATCHES)):
        failed.append("the death fit's batches %s"
                      % [st[1] for st in d0["steps"]])
    return failed, (min(after) - died) if after else None


def phase_elastic_mesh(torch, dev, expert):
    """Phase 25 (see the module's docstring): (a) the MoE LM over
    MeshConfig(seq=2, expert=2), (b) the elastic fit of the LM over
    MeshConfig(data=2).  Returns the launches of (a) and (b)."""
    t0 = time.perf_counter()
    ranks, outdir, wall = _spawn_ranks(25, P25_RANKS, ("es_lm",),
                                       P25_RANK_TIMEOUT, may_die=(1,))
    try:
        shrink, death = [], []
        for r in range(2):
            with open(os.path.join(outdir, "el_shrink_rank%d.json"
                                   % r)) as f:
                shrink.append(json.load(f))
        with open(os.path.join(outdir, "el_death_rank0.json")) as f:
            death.append(json.load(f))
        with open(os.path.join(outdir, "el_death")) as f:
            died = float(f.read())
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    es = ranks["es_lm"]
    failed = _es_gate(es, expert["bounds"], expert["col_bound"])
    step_s = [float(np.mean([st["s"] for st in rd["steps"][1:]]))
              for rd in es]
    a2a_s = [float(np.mean([st["collectives"]["all_to_all"]["s"]
                            for st in rd["steps"][1:]])) for rd in es]
    log("expert seq (a): " + json.dumps({
        "card": _smi_line(),
        "config": "phase 16 (b)'s MoE LM (vocab %d, T %d, batch %d, embed "
                  "%d, %d heads, FFN %d, %d experts, top-%d, cf %g, f32) "
                  "through Module(mesh_config=MeshConfig(seq=2, "
                  "expert=2)), %d ranks over gloo on one card, %d fit "
                  "steps" % (VOCAB, SEQ, TRAIN_BATCH, EMBED, TRAIN_HEADS,
                             FFN, MOE_EXPERTS, MOE_TOP_K, MOE_CF, P25_RANKS,
                             ES_FIT_STEPS),
        "step_s": step_s, "exchange_s": a2a_s,
        "peak_bytes": [rd["peak_bytes"] for rd in es],
        "bounds": expert["bounds"], "col_bound": expert["col_bound"],
        "ranks": es}))
    if failed:
        raise AssertionError("phase 25 (a): " + "; ".join(failed))
    failed, death_to_step = _el_gate(shrink, death, died)
    log("elastic (b): " + json.dumps({
        "card": _smi_line(),
        "config": "phase 17's / 20's LM (vocab %d, T %d, embed %d, %d "
                  "heads, FFN %d, %d layers, f32, SGD lr %g momentum %g) "
                  "over MeshConfig(data=2), batch %d, %d epochs of %d "
                  "steps, fences every %d steps (sync, DCP over the "
                  "group); worker 1 stale at step %d, back at step %d; "
                  "then %d steps with rank 1 dying at step %d"
                  % (VOCAB, SEQ, EMBED, TRAIN_HEADS, FFN, LAYERS, TRAIN_LR,
                     EL_MOMENTUM, EL_BATCH, EL_EPOCHS, EL_BATCHES,
                     EL_PERIOD, EL_STALE, EL_BACK, EL_DEATH_BATCHES,
                     EL_DEATH_STEP),
        "shrink": shrink, "death": death,
        "death_to_first_step_s": death_to_step,
        "fence_bytes": shrink[0]["fence"]["bytes"],
        "fence_write_ms": shrink[0]["fence"]["write_ms"],
        "reform_s": shrink[0]["reform"],
        "death_reform_s": death[0]["reform"]}))
    if failed:
        raise AssertionError("phase 25 (b): " + "; ".join(failed))
    log("elastic mesh: " + json.dumps({
        "card": _smi_line(), "wall_s": time.perf_counter() - t0,
        "ranks_wall_s": wall, "es_step_s": step_s, "es_exchange_s": a2a_s,
        "el_death_to_first_step_s": death_to_step,
        "el_fence_bytes": shrink[0]["fence"]["bytes"],
        "el_fence_write_ms": shrink[0]["fence"]["write_ms"]}))
    es_launches = {k: sum(st["launches"][k] for rd in es
                          for st in rd["steps"])
                   for k in EL_PER_STEP}
    el_launches = {k: sum(st[4][k] for rd in shrink + death
                          for st in rd["steps"]) for k in EL_PER_STEP}
    return {"es": es_launches, "el": el_launches}


_PHASE_MARKS = []


def _mark(name):
    """The end of phase ``name`` (``phase walls:`` logs each phase's
    seconds)."""
    _PHASE_MARKS.append((name, time.perf_counter()))


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
    if sys.argv[1:2] == ["--dp-rank"]:
        # one rank of phase 20 (d), started by the phase itself
        rank, world, address, outdir = sys.argv[2:6]
        return _dp_rank_main(int(rank), int(world), address, outdir)
    if sys.argv[1:2] == ["--tp-rank"]:
        # one rank of phase 21 (a), started by the phase itself
        rank, world, address, outdir = sys.argv[2:6]
        return _tp_rank_main(int(rank), int(world), address, outdir)
    if sys.argv[1:2] == ["--p22-rank"]:
        # one rank of phase 22, started by the phase itself
        rank, world, address, outdir = sys.argv[2:6]
        return _p22_rank_main(int(rank), int(world), address, outdir)
    if sys.argv[1:2] == ["--p23-rank"]:
        # one rank of phase 23, started by the phase itself
        rank, world, address, outdir = sys.argv[2:6]
        return _p23_rank_main(int(rank), int(world), address, outdir)
    if sys.argv[1:2] == ["--p24-rank"]:
        # one rank of phase 24, started by the phase itself
        rank, world, address, outdir = sys.argv[2:6]
        return _p24_rank_main(int(rank), int(world), address, outdir)
    if sys.argv[1:2] == ["--p25-rank"]:
        # one rank of phase 25, started by the phase itself
        rank, world, address, outdir = sys.argv[2:6]
        return _p25_rank_main(int(rank), int(world), address, outdir)
    # phases 1-17 run the hand-fixed kernel plans: an empty tuning cache
    # of this run's own, unarmed (phase 18 arms a directory of its own);
    # nothing is read from or left in the user's cache
    tune_root = tempfile.mkdtemp(prefix="mx_smoke_tuning_")
    os.environ["MXNET_PROGRAM_CACHE"] = os.path.join(tune_root, "empty")
    os.environ["MXNET_PALLAS_TUNE"] = "0"
    try:
        return _main(torch)
    finally:
        shutil.rmtree(tune_root, ignore_errors=True)


def _main(torch):
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
    _PHASE_MARKS[:] = [("start", t0)]
    phase_build()
    _mark("build")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    a_cases = phase_kernel_a(torch, dev, flush)
    _mark("kernel_a")
    b_cases = phase_kernel_b(torch, dev, flush)
    _mark("kernel_b")
    cde_cases = phase_kernels_cde(torch, dev, flush)
    _mark("kernels_cde")
    f_cases = phase_kernel_f(torch, dev, flush)
    _mark("kernel_f")
    b1_cases = phase_kernel_b1(torch, dev, flush)
    _mark("kernel_b1")
    b4 = phase_fused_bn(torch, dev, flush)
    _mark("fused_bn")
    del flush
    torch.cuda.empty_cache()
    serve, launches, base = phase_serve(torch, dev)
    _mark("serve")
    gc.collect()
    torch.cuda.empty_cache()
    _, spec_launches = phase_serve_spec(torch, dev, base)
    _mark("serve_spec")
    gc.collect()
    torch.cuda.empty_cache()
    _, fleet_launches = phase_fleet(torch, dev, base)
    _mark("fleet")
    del base
    # a predictor and its programs reference each other (each program
    # holds a bound method): collect them, their buffers and their
    # graphs' memory pool before training
    gc.collect()
    torch.cuda.empty_cache()
    train, train_launches = phase_train(torch, dev)
    _mark("train")
    gc.collect()
    torch.cuda.empty_cache()
    # on a thread of its own: the phase's autograd marks end with it
    imp, imp_launches = _on_own_thread(phase_train_imperative, torch, dev)
    _mark("train_imperative")
    phase_ops(torch, dev)
    _mark("ops")
    gc.collect()
    torch.cuda.empty_cache()
    _, predict_launches, out_grads_launches = phase_predict(torch, dev)
    _mark("predict")
    phase_routing(torch, dev)
    _mark("routing")
    gc.collect()
    torch.cuda.empty_cache()
    _, export_launches = phase_export(torch, dev)
    _mark("export")
    torch.cuda.empty_cache()
    resnet, resnet_launches = phase_train_resnet(torch, dev)
    _mark("train_resnet")
    gc.collect()
    torch.cuda.empty_cache()
    _, lstm_launches = phase_train_lstm(torch, dev)
    _mark("train_lstm")
    zoo_launches = {}
    for name in ZOO_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        _, launched = phase_train_zoo(torch, dev, name)
        _mark("train_zoo_" + name)
        zoo_launches["train_" + name] = launched["multi_tensor_update"]
    gc.collect()
    torch.cuda.empty_cache()
    _, mnist_launches = phase_train_mnist(torch, dev)
    _mark("train_mnist")
    zoo_launches["train_mnist"] = mnist_launches["multi_tensor_update"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_zoo_steps(torch, dev)
    _mark("zoo_steps")
    gc.collect()
    torch.cuda.empty_cache()
    _, ssd_launches = phase_train_ssd(torch, dev)
    _mark("train_ssd")
    gc.collect()
    torch.cuda.empty_cache()
    phase_detection_ops(torch, dev)
    _mark("detection_ops")
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches = phase_moe(torch, dev)
    _mark("moe")
    moe_train = {k: v for k, v in moe_launches.items() if "train" in k}
    gc.collect()
    torch.cuda.empty_cache()
    resume_launches = phase_resume(torch, dev)
    _mark("resume")
    gc.collect()
    torch.cuda.empty_cache()
    tune_tables, tune_launches = phase_tuning(torch, dev)
    _mark("tuning")
    gc.collect()
    torch.cuda.empty_cache()
    analysis_launches = phase_analysis(torch, dev, train, imp)
    _mark("analysis")
    gc.collect()
    torch.cuda.empty_cache()
    dp_launches = phase_data_parallel(torch, dev, train)
    _mark("data_parallel")
    dist_l, two_l = dp_launches["dist"], dp_launches["dist_two_context"]
    gc.collect()
    torch.cuda.empty_cache()
    tp_launches = phase_tensor_parallel(torch, dev)
    _mark("tensor_parallel")
    tp_l, capi_l = tp_launches["tp"], tp_launches["capi"]
    gc.collect()
    torch.cuda.empty_cache()
    mp = phase_mesh_pipeline(torch, dev)
    _mark("mesh_pipeline")
    sm_l, pp_l = mp["serve_mesh"], mp["pipeline"]
    gc.collect()
    torch.cuda.empty_cache()
    rg = phase_ring(torch, dev, mp.pop("ring"))
    _mark("ring")
    gc.collect()
    torch.cuda.empty_cache()
    ep = phase_expert(torch, dev, mp.pop("expert"))
    _mark("expert")
    gc.collect()
    torch.cuda.empty_cache()
    em = phase_elastic_mesh(torch, dev, ep)
    _mark("elastic_mesh")

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
        + imp_launches["fused_fwd"] + export_launches["fused_fwd"] \
        + sum(f["fused_fwd"] for f in fleet_launches.values()) \
        + sum(m["fused_fwd"] for m in moe_launches.values()) \
        + resume_launches["fused_fwd"] + tune_launches["fused_fwd"] \
        + analysis_launches["fused_fwd"] + dist_l["fused_fwd"] \
        + two_l["fused_fwd"] + tp_l["fused_fwd"] + capi_l["fused_fwd"] \
        + sm_l["fused_fwd"] + ep["lm"]["fused_fwd"] \
        + ep["serve"]["fused_fwd"] + em["es"]["fused_fwd"] \
        + em["el"]["fused_fwd"]
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
                               "imperative": imp_launches["fused_fwd"],
                               "export": export_launches["fused_fwd"],
                               **{path: f["fused_fwd"] for path, f
                                  in fleet_launches.items()},
                               **{path: m["fused_fwd"] for path, m
                                  in moe_launches.items()},
                               "resume": resume_launches["fused_fwd"],
                               "tuning": tune_launches["fused_fwd"],
                               "analysis": analysis_launches["fused_fwd"],
                               "dist": dist_l["fused_fwd"],
                               "dist_two_context": two_l["fused_fwd"],
                               "tensor_parallel": tp_l["fused_fwd"],
                               "capi": capi_l["fused_fwd"],
                               "serve_mesh": sm_l["fused_fwd"],
                               "expert_lm": ep["lm"]["fused_fwd"],
                               "expert_serve": ep["serve"]["fused_fwd"],
                               "expert_seq_lm": em["es"]["fused_fwd"],
                               "elastic_lm": em["el"]["fused_fwd"]},
             tuning=_tuning_field(tune_tables, "A+F LM ffn1"),
             verify_cases=[brief(c, "m", "k", "n") for c in a_verify],
             mesh_cases=[brief(c, "m", "k", "n", "relu_residual")
                         for c in mp["a_cases"]],
             max_abs_err_all_cases=max(c["max_abs_err"] for c
                                       in a_cases + mp["a_cases"])),
        dict(_entry("paged_flash_decode",
                    "mxnet_tpu_torch/csrc/paged_decode.cu",
                    "mxnet_tpu/ops/pallas_decode.py:169",
                    launches["paged_decode"] + spec_launches["paged_decode"]
                    + sum(f["paged_decode"] for f in fleet_launches.values())
                    + moe_launches["moe_serve"]["paged_decode"]
                    + tune_launches["paged_decode"] + sm_l["paged_decode"]
                    + ep["serve"]["paged_decode"],
                    b_main),
             shape="B=4 tq=1 H=4 hd=256 int8 pages lens=%s"
             % b_main["lens"],
             variant=b_main["variant"], splits=b_main["splits"],
             launches_by_path={"serve": launches["paged_decode"],
                               "serve_spec": spec_launches["paged_decode"],
                               **{path: f["paged_decode"] for path, f
                                  in fleet_launches.items()},
                               "moe_serve":
                                   moe_launches["moe_serve"]["paged_decode"],
                               "tuning": tune_launches["paged_decode"],
                               "serve_mesh": sm_l["paged_decode"],
                               "expert_serve": ep["serve"]["paged_decode"]},
             tuning=_tuning_field(tune_tables, "B serve decode"),
             verify_case=brief(b_verify, "tq", "lens", "splits", "rows",
                               "row_tiles"),
             mesh_cases=[brief(c, "heads", "tq", "lens")
                         for c in mp["b_cases"]],
             max_abs_err_all_cases=max(c["max_abs_err"] for c
                                       in b_cases + mp["b_cases"])),
        dict(_entry("paged_split_combine",
                    "mxnet_tpu_torch/csrc/paged_decode.cu",
                    "mxnet_tpu/ops/pallas_decode.py:354",
                    launches["paged_combine"]
                    + spec_launches["paged_combine"]
                    + sum(f["paged_combine"] for f in fleet_launches.values())
                    + moe_launches["moe_serve"]["paged_combine"]
                    + tune_launches["paged_combine"]
                    + sm_l["paged_combine"] + ep["serve"]["paged_combine"],
                    dict(b_main["combine"], library_ms=None,
                         device_ms=b_main["combine"]["device_ms"])),
             shape="B=4 tq=1 H=4 hd=256, %d splits (%d seen)"
             % (b_main["splits"], b_main["combine"]["splits_seen"]),
             launches_by_path={"serve": launches["paged_combine"],
                               "serve_spec": spec_launches["paged_combine"],
                               **{path: f["paged_combine"] for path, f
                                  in fleet_launches.items()},
                               "moe_serve":
                                   moe_launches["moe_serve"]["paged_combine"],
                               "tuning": tune_launches["paged_combine"],
                               "serve_mesh": sm_l["paged_combine"],
                               "expert_serve":
                                   ep["serve"]["paged_combine"]},
             tuning=_tuning_field(tune_tables, "B serve decode"),
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
            by_path["export"] = export_launches[counter]
        else:
            by_path["out_grads"] = out_grads_launches[counter]
        by_path.update({path: m[counter] for path, m in moe_train.items()})
        by_path["resume"] = resume_launches[counter]
        by_path["tuning"] = tune_launches[counter]
        by_path["analysis"] = analysis_launches[counter]
        by_path["dist"] = dist_l[counter]
        by_path["dist_two_context"] = two_l[counter]
        by_path["tensor_parallel"] = tp_l[counter]
        if counter == "flash_fwd":
            by_path["capi"] = capi_l[counter]
        by_path["pipeline"] = pp_l[counter]
        by_path["ring_op"] = rg["op"][counter]
        by_path["ring_lm"] = rg["lm"][counter]
        by_path["expert_lm"] = ep["lm"][counter]
        by_path["expert_seq_lm"] = em["es"][counter]
        by_path["elastic_lm"] = em["el"][counter]
        entry = dict(
            _entry("flash_attention_" + counter[6:],
                   "mxnet_tpu_torch/csrc/flash_attention.cu", replaces,
                   sum(by_path.values()), cde_main[name]),
            shape="bh=64 t=2048 hd=128 causal float32",
            launches_by_path=by_path,
            max_abs_err_all_cases=max(c["max_abs_err"]
                                      for c in cde_cases[name]
                                      + rg["hop"][name]))
        entry["variant"] = cde_main[name]["variant"]
        entry["pipeline_stage_case"] = brief(mp["cde"][name], "bh", "t",
                                             "hd")
        entry["ring_hop_cases"] = [brief(c, "dtype", "groups", "causal", "bh",
                                         "t", "hd", "limit")
                                   for c in rg["hop"][name]]
        entry["tuning"] = _tuning_field(tune_tables, "C-E LM attention")
        kernels.append(entry)
    kernels.append(dict(
        _entry("fused_ln_linear_bwd", "mxnet_tpu_torch/csrc/fused_bwd.cu",
               "mxnet_tpu/ops/pallas_fused.py:214",
               train_launches["fused_bwd"] + out_grads_launches["fused_bwd"]
               + imp_launches["fused_bwd"]
               + sum(m["fused_bwd"] for m in moe_train.values())
               + resume_launches["fused_bwd"] + tune_launches["fused_bwd"]
               + analysis_launches["fused_bwd"] + dist_l["fused_bwd"]
               + two_l["fused_bwd"] + tp_l["fused_bwd"]
               + ep["lm"]["fused_bwd"] + em["es"]["fused_bwd"]
               + em["el"]["fused_bwd"],
               f_main),
        shape="m=16384 k=1024 n=4096 float32",
        variant=f_main["variant"],
        launches_by_path={"train": train_launches["fused_bwd"],
                          "out_grads": out_grads_launches["fused_bwd"],
                          "imperative": imp_launches["fused_bwd"],
                          **{path: m["fused_bwd"] for path, m
                             in moe_train.items()},
                          "resume": resume_launches["fused_bwd"],
                          "tuning": tune_launches["fused_bwd"],
                          "analysis": analysis_launches["fused_bwd"],
                          "dist": dist_l["fused_bwd"],
                          "dist_two_context": two_l["fused_bwd"],
                          "tensor_parallel": tp_l["fused_bwd"],
                          "expert_lm": ep["lm"]["fused_bwd"],
                          "expert_seq_lm": em["es"]["fused_bwd"],
                          "elastic_lm": em["el"]["fused_bwd"]},
        tuning=_tuning_field(tune_tables, "A+F LM ffn1"),
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
    b1_by_path.update({path: m["multi_tensor_update"]
                       for path, m in moe_train.items()})
    b1_by_path["resume"] = resume_launches["multi_tensor_update"]
    b1_by_path["tuning"] = tune_launches["multi_tensor_update"]
    b1_by_path["analysis"] = analysis_launches["multi_tensor_update"]
    b1_by_path["dist"] = dist_l["multi_tensor_update"]
    b1_by_path["dist_two_context"] = two_l["multi_tensor_update"]
    b1_by_path["tensor_parallel"] = tp_l["multi_tensor_update"]
    b1_by_path["pipeline"] = pp_l["multi_tensor_update"]
    b1_by_path["ring_lm"] = rg["lm"]["multi_tensor_update"]
    b1_by_path["expert_lm"] = ep["lm"]["multi_tensor_update"]
    b1_by_path["expert_seq_lm"] = em["es"]["multi_tensor_update"]
    b1_by_path["elastic_lm"] = em["el"]["multi_tensor_update"]
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
        tuning=_tuning_field(tune_tables, "B1 resnet50 slab"),
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
    # B4 at ResNet-50's s1 c3 (+ residual, the most bytes) and the sweep
    # at s1 c1 (statistics on, the rule's variant)
    b4_main = next(c for c in b4["cases"] if c["residual"]
                   and c["m"] == 802816)
    b4_sweep = b4["sweep"][0]
    kernels.append(dict(
        _entry("fused_bn_matmul", "mxnet_tpu_torch/csrc/fused_bn_matmul.cu",
               "benchmarks/proto_fused.py:24",
               b4["launches"]["bench_cases"], b4_main),
        shape="m=802816 k=64 n=256 bfloat16 + residual",
        variant=b4_main["variant"],
        launches_by_path={"bench_cases": b4["launches"]["bench_cases"]},
        cases=[brief(c, "case", "residual", "maxerr", "srel", "min_gb",
                     "gbps") for c in b4["cases"]],
        max_abs_err_all_cases=max(c["max_abs_err"] for c in b4["cases"])))
    kernels.append(dict(
        _entry("fused_bn_sweep", "mxnet_tpu_torch/csrc/fused_bn_matmul.cu",
               "benchmarks/proto_sweep.py:11", b4["launches"]["sweep"],
               b4_sweep),
        shape="m=802816 k=256 n=64 bfloat16, statistics on",
        variant=b4_sweep["variant"],
        launches_by_path={"sweep": b4["launches"]["sweep"]},
        library="the chain without statistics (proto_sweep.py:79-90)",
        cases=[brief(c, "case", "matmul_floor_ms", "chain_floor_ms",
                     "runs") for c in b4["sweep"]],
        max_abs_err_all_cases=max(c["max_abs_err"] for c in b4["sweep"])))
    log("phase walls: " + json.dumps({
        name: round(t - _PHASE_MARKS[i][1], 1)
        for i, (name, t) in enumerate(_PHASE_MARKS[1:])}))
    log("total wall: %.1f s" % (time.perf_counter() - t0))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
