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
   ran and the share of the bound it reached;
3. kernels C-F — the training kernels (flash attention forward, dQ,
   dK/dV; the fused LN->linear backward) against their plain versions at
   the training path's shapes (C-E in f32 and bf16, G = 1 and 2; C and
   E cases name the variant that ran, ``simt`` or ``wgmma``), timed the
   same way;
4. kernel B1 — the multi-tensor optimizer update against its plain
   version over the slabs of ResNet-50's 157 trainables (12,556 blocks)
   and of the LM's, for SGD, SGD-momentum and Adam, f32 masters with and
   without a bf16 compute copy, bf16 masters, clip on and off, lr / wd
   differing per segment: bit for bit for SGD and SGD-momentum, within
   one f32 ulp for Adam, padding still 0; timed beside the port's
   per-parameter update and ``torch.optim``'s fused SGD / Adam step;
5. serve — build the full-width ``attention_lm`` (vocab 8192, embed
   1024, 4 heads, FFN 4096; depth cut to 2 layers) from seeded random
   weights and serve 8 requests (128-1024-token prompts, half sharing a
   256-token prefix, 32 greedy tokens each) through ``DecodeServer`` over
   a paged int8 ``DecodePredictor`` (4 slots, 16-token pages, 256-token
   prefill chunks), counting every kernel launch; then re-serve with the
   plain versions and compare teacher-forced probabilities;
6. train — ``Module.forward_backward`` + ``update`` steps of the
   full-width training configuration (vocab 8192, T 2048, batch 8, embed
   1024, 8 heads, FFN 4096, 4 layers, f32, SGD, seeded Xavier-gaussian
   weights) on one repeated token batch, the optimizer update through
   the slab plan (kernel B1), counting every kernel launch; the first
   step's update is held bit for bit against the plain version on copies
   of its slabs, its gradients against a ``plain=True`` module's; the
   loss must fall; the bench's learning rate is recorded beside the one
   timed; then one profiled step;
7. train ResNet-50 — ``bench.py``'s configuration at full depth and
   width (batch 256, bf16 compute, f32 masters, SGD lr 0.1, momentum
   0.9, wd 1e-4, seeded Xavier(gaussian, in, 2) weights, one resident
   batch) through the slab plan: a warm-up step whose update is held
   against the plain version and, on copies of the masters and the
   momentum from before it with the gradients it packed, against the
   per-parameter update (the optimizer's ``update_multi``), bit for bit
   in the masters, the momentum and the bf16 copy; timed steps (one B1
   launch each, the moving statistics moving, finite losses); then one
   profiled step.

The last lines are a ``kernels`` JSON object, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
TF32 is off throughout (``allow_tf32`` False for matmuls and cuDNN), so
f32 products and convolutions are full f32.
"""
import json
import subprocess
import sys
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
# the ResNet-50 training configuration: bench.py:87-125 at full depth and
# width, one resident batch (x uniform(-1, 1), labels in [0, 1000))
RESNET_BATCH, RESNET_STEPS = 256, 3
RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
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
SLOTS, PAGE_TOKENS, CHUNK, MAX_NEW = 4, 16, 256, 32
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
# kernel B1 against its plain version: SGD and SGD-momentum bit for bit
# (both round every f32 product and sum once, in the same order); Adam
# within one f32 ulp (its square root and quotient are correctly rounded
# on both sides, so 0 is expected and the measured distance is printed)
B1_ADAM_ULPS = 1
# greedy tokens of the kernel run and the plain run must all agree: the
# weights and prompts are seeded, so a near-tie that a 1e-6 gap could flip
# would show in every run, not now and then
MIN_GREEDY_AGREEMENT = 1.0


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
    profiler sees no device activity.  One profiled run; a run whose
    records the profiler dropped (no device activity at all) is profiled
    again, at most twice."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    us = 0.0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(_kernel_us(e) for e in prof.key_averages())
        if us > 0:
            break
    return us * 1e-3 / calls if us > 0 else "not measured"


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


def phase_kernel_a(torch, dev, flush):
    """Kernel A at the LM's segments: M = 4 (decode), 256 (a prefill
    chunk) and 16384 (a training batch of 8 x 2048 tokens);
    q/k/v/attout-sized (1024, 1024), ffn1 (1024, 4096) and ffn2 (4096,
    1024, ReLU + residual); f32 and bf16."""
    from mxnet_tpu_torch.ops import fused_kernel as fk

    cases = []
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        isz = torch.empty((), dtype=dtype).element_size()
        for m in (4, 256, TRAIN_BATCH * SEQ):
            for k, n, relu_res in ((1024, 1024, False), (1024, 4096, False),
                                   (4096, 1024, True)):
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
                        "kernel A %s m=%d k=%d n=%d: max |y - plain| %.3g "
                        "> %.3g" % (dname, m, k, n, err,
                                    TOL_A[dname] * mag))
                yabs = want[0].float().abs()
                for i, lim in ((1, yabs.sum(0)), (2, (yabs * yabs).sum(0))):
                    serr = (got[i] - want[i]).abs()
                    if not bool((serr <= TOL_A_STATS[dname]
                                 * torch.clamp_min(lim, 1.0)).all()):
                        raise AssertionError(
                            "kernel A %s m=%d k=%d n=%d: column statistic "
                            "%d off by %.3g" % (dname, m, k, n, i,
                                                float(serr.max())))
                # the library yardstick: one addmm on the pre-applied
                # input (no prologue, no statistics)
                a = x.float() * scale + shift
                if relu_res:
                    a = torch.clamp_min(a, 0)
                a = a.to(dtype)
                c = (bias + res.float()).to(dtype) if relu_res \
                    else bias.to(dtype)
                wt = w.t()
                iters = 20
                ms = _timed(torch, lambda: fk.fused_scale_relu_matmul(
                    x, scale, shift, w, **kw), flush, iters)
                plain_ms = _timed(torch, lambda: fk.fused_plain(
                    x, scale, shift, w, **kw), flush, iters)
                lib_ms = _timed(torch, lambda: torch.addmm(c, a, wt), flush,
                                iters)
                dev_ms = {
                    "kernel": _device_ms(torch, lambda: (
                        fk.fused_scale_relu_matmul(x, scale, shift, w,
                                                   **kw))),
                    "plain": _device_ms(torch, lambda: fk.fused_plain(
                        x, scale, shift, w, **kw)),
                    "library": _device_ms(torch,
                                          lambda: torch.addmm(c, a, wt))}
                nbytes = (m * k * isz + 2 * k * 4 + n * k * isz + n * 4
                          + (m * n * isz if relu_res else 0) + m * n * isz
                          + 2 * n * 4)
                flops = 2.0 * m * n * k
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = flops / PEAK_FLOPS[dname]
                case = {"dtype": dname, "m": m, "k": k, "n": n,
                        "relu_residual": relu_res, "variant": variant,
                        "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "device_ms": dev_ms,
                        "bound_ms": max(t_bytes, t_ops) * 1e3,
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations"}
                case["bound_share"] = _bound_share(case)
                log("kernel A case: " + json.dumps(case))
                cases.append(case)
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
    """Kernel B at the serving shapes: 4 slots x 2048-token views of
    16-token pages, 4 heads of 256; tq = 1 (decode, 4 slots) and tq =
    256 (a prefill chunk, 1 slot); f32 / int8 / fp8-e4m3 pools; G = 1
    and 2; padded, long and wrapped rings."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import attention as attn
    from mxnet_tpu_torch.ops import decode_kernel as dk

    cases = []
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    hd = EMBED // HEADS
    m = SEQ // PAGE_TOKENS
    c = m * PAGE_TOKENS
    pages = SLOTS * m + 1
    perm = torch.randperm(pages - 1, generator=g, device=dev).to(
        torch.int32) + 1
    table_all = perm[:SLOTS * m].reshape(SLOTS, m).contiguous()
    for pdt in (torch.float32, torch.int8, torch.float8_e4m3fn):
        pname = str(pdt).split(".")[-1]
        for group in (1, 2):
            kvh = HEADS // group
            kp, vp = _pools(torch, attn, dev, g, pages, kvh, hd, pdt)
            isz = torch.empty((), dtype=pdt).element_size()
            for tq, lens_list in ((1, [130, 700, 1100, c + 37]),
                                  (CHUNK, [768 + CHUNK])):
                b = len(lens_list)
                table = table_all[:b].contiguous()
                lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
                q = torch.randn(b, tq, EMBED, generator=g, device=dev)
                fn = dk.flash_sdpa_decode if tq == 1 \
                    else dk.flash_sdpa_verify
                kw = dict(num_heads=HEADS, num_kv_heads=kvh)
                got = fn(q, kp, vp, table, lens, **kw)
                want = dk.paged_plain(q, kp, vp, table, lens, HEADS, None,
                                      kvh)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not (err <= TOL_B and bool(torch.isfinite(got).all())):
                    raise AssertionError(
                        "kernel B %s G=%d tq=%d: max |out - plain| %.3g > "
                        "%.3g" % (pname, group, tq, err, TOL_B))
                # yardstick: SDPA over the already-gathered, dequantized
                # view (it skips the page walk and the dequantization)
                kv = attn.dequantize_kv(attn.paged_gather(kp, table), kvh)
                vv = attn.dequantize_kv(attn.paged_gather(vp, table), kvh)
                kh = kv.reshape(b, c, kvh, hd).permute(0, 2, 1, 3)
                vh = vv.reshape(b, c, kvh, hd).permute(0, 2, 1, 3)
                qh = q.reshape(b, tq, HEADS, hd).permute(0, 2, 1, 3)
                limit = torch.clamp_max(
                    lens.long()[:, None] - (tq - 1)
                    + torch.arange(tq, device=dev)[None, :], c)
                mask = (torch.arange(c, device=dev)[None, None, :]
                        < limit[:, :, None])[:, None]
                iters = 20
                ms = _timed(torch, lambda: fn(q, kp, vp, table, lens, **kw),
                            flush, iters)
                plain_ms = _timed(torch, lambda: dk.paged_plain(
                    q, kp, vp, table, lens, HEADS, None, kvh), flush, iters)
                lib_ms = _timed(torch, lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, enable_gqa=group > 1),
                    flush, iters)
                dev_ms = {
                    "kernel": _device_ms(torch, lambda: fn(
                        q, kp, vp, table, lens, **kw)),
                    "plain": _device_ms(torch, lambda: dk.paged_plain(
                        q, kp, vp, table, lens, HEADS, None, kvh)),
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
                flops = 4.0 * keys * HEADS * hd
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = flops / PEAK_FLOPS["float32"]
                case = {"pool": pname, "group": group, "tq": tq,
                        "lens": lens_list, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "device_ms": dev_ms,
                        "bound_ms": max(t_bytes, t_ops) * 1e3,
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations"}
                log("kernel B case: " + json.dumps(case))
                cases.append(case)
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


def _predictor(sym, params, plain, dev):
    from mxnet_tpu_torch.decode import DecodePredictor

    return DecodePredictor(sym, params, cache_len=SEQ, device=dev,
                           paged=True, kv_dtype="int8",
                           page_tokens=PAGE_TOKENS, prefill_chunk=CHUNK,
                           plain=plain)


def _serve(torch, pred, prompts):
    from mxnet_tpu_torch.decode import DecodeServer

    srv = DecodeServer(pred, max_prefill=max(PROMPT_LENS), slots=SLOTS,
                       max_new_tokens=MAX_NEW)
    for p in prompts:
        srv.submit(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = srv.run()
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0, srv.stats()


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


def phase_serve(torch, dev):
    from mxnet_tpu_torch.ops import attention as attn
    from mxnet_tpu_torch.ops import decode_kernel as dk
    from mxnet_tpu_torch.ops import fused_kernel as fk
    from mxnet_tpu_torch.ops import fused_lm

    sym, params, n_params = _lm(torch, dev)
    log("model: attention_lm vocab=%d embed=%d heads=%d ffn=%d layers=%d "
        "params=%d (f32)" % (VOCAB, EMBED, HEADS, FFN, LAYERS, n_params))
    prompts = _prompts()
    pred = _predictor(sym, params, False, dev)
    # warm-up: CUDA context, library handles, allocator
    _serve(torch, pred, [p[:64] for p in prompts[:2]])

    fk.LAUNCHES["fused_fwd"] = 0
    dk.LAUNCHES["paged_decode"] = 0
    results, wall, stats = _serve(torch, pred, prompts)
    launches = {"fused_fwd": fk.LAUNCHES["fused_fwd"],
                "paged_decode": dk.LAUNCHES["paged_decode"]}
    paths = {"fused": fused_lm.FUSED_PATH["last"],
             "decode": attn.DECODE_PATH["last"]}
    log("serve launches: %s paths: %s" % (launches, paths))
    if min(launches.values()) <= 0 or paths != {"fused": "kernel",
                                                 "decode": "kernel"}:
        raise AssertionError("the serve did not run through both kernels: "
                             "%s %s" % (launches, paths))
    for rid in range(len(prompts)):
        toks = results[rid]
        if toks.shape != (MAX_NEW,) or toks.min() < 0 \
                or toks.max() >= VOCAB:
            raise AssertionError("request %d returned %s" % (rid, toks))

    # the same requests with every kernel's plain version
    plain = _predictor(sym, params, True, dev)
    p_results, p_wall, _ = _serve(torch, plain, prompts)
    agree = float(np.mean([np.mean(results[r] == p_results[r])
                           for r in results]))
    if not agree >= MIN_GREEDY_AGREEMENT:
        raise AssertionError("greedy tokens of the kernel and plain runs "
                             "agree at %.4f < %.4f"
                             % (agree, MIN_GREEDY_AGREEMENT))

    # teacher-forced probabilities: the kernel run's tokens fed to both
    batch = np.zeros((SLOTS, max(PROMPT_LENS[:SLOTS])), np.float32)
    for i in range(SLOTS):
        batch[i, :PROMPT_LENS[i]] = prompts[i]
    lens = np.asarray(PROMPT_LENS[:SLOTS])
    ks, kprobs = pred.prefill(batch, lens)
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
        ps, pprobs = plain.step(ps._replace(tok=forced.clone()))
    if not worst <= TOL_LOGP:
        raise AssertionError("teacher-forced |log p_kernel - log p_plain| "
                             "%.3g > %.3g" % (worst, TOL_LOGP))
    tokens = sum(len(t) for t in results.values())
    profile = _profile(torch, lambda: _serve(torch, pred, prompts)[1])
    serve = {"requests": len(prompts), "tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall,
             "ttft_p50_s": stats.get("ttft_p50_s"),
             "ttft_p95_s": stats.get("ttft_p95_s"),
             "decode_steps": stats["steps"],
             "prefix_cache_hit_rate": stats.get("prefix_cache_hit_rate"),
             "cow_forks": stats.get("cow_forks"),
             "plain_wall_s": p_wall, "plain_tokens_per_s": tokens / p_wall,
             "greedy_token_agreement": agree,
             "teacher_forced_max_abs_dlogp": worst,
             "launches": launches}
    log("serve: " + json.dumps(serve))
    log("profile: " + json.dumps(profile))
    return serve, launches


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
    G = 2 (32 kv rows).  D and E run on the kernel's own o / lse; C and E
    cases name the variant that ran (``flash_kernel.LAST_VARIANT``).
    Yardsticks: SDPA's forward (C) and its backward through autograd,
    which computes dq, dk and dv in one call (D and E)."""
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
            if name in variants:
                extra["variant"] = variants[name]
            case = _case(torch, flush, *fns[name], extra=extra)
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


def _ulps(torch, a, b):
    """Largest distance in f32 ulps between two tensors, read as f32."""
    def ordered(t):
        i = t.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max())


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

    n = rows * uk.LANES
    isz = w.element_size()
    nbytes = n * (2 * isz + 4 + 2 * nslots * isz
                  + (wc.element_size() if wc is not None else 0)) \
        + 2 * 4 * lrb.numel()
    flops = n * {"sgd": 5, "sgd_momentum": 7, "adam": 17}[name]
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
            "blocks": lrb.numel(), "elements": n, "bitwise": bitwise,
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
    with a bf16 compute copy (clip off and on), bf16 masters (clip on).
    Every segment is padded to whole 2,048-element blocks, and lr / wd
    differ from segment to segment."""
    from mxnet_tpu_torch.models import attention_lm, resnet

    nets = {
        "resnet50": _trainable_shapes(
            resnet.get_symbol(1000, 50, (3, 224, 224)),
            data=(RESNET_BATCH, 3, 224, 224),
            softmax_label=(RESNET_BATCH,)),
        "lm": _trainable_shapes(
            attention_lm.get_symbol(vocab_size=VOCAB, seq_len=SEQ,
                                    num_layers=TRAIN_LAYERS, embed=EMBED,
                                    heads=TRAIN_HEADS, ffn_hidden=FFN),
            data=(TRAIN_BATCH, SEQ), softmax_label=(TRAIN_BATCH, SEQ))}
    n50 = nets["resnet50"]
    if (len(n50), sum(int(np.prod(s)) for s in n50.values())) \
            != (157, 25_549_486):
        raise AssertionError("ResNet-50 trainables: %d tensors, %d values"
                             % (len(n50), sum(int(np.prod(s))
                                              for s in n50.values())))
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    variants = ((torch.float32, None, -1.0),
                (torch.float32, torch.bfloat16, -1.0),
                (torch.float32, torch.bfloat16, 0.3),
                (torch.bfloat16, None, 0.3))
    cases = []
    for net, shapes in nets.items():
        for kind, nslots in (("sgd", 0), ("sgd", 1), ("adam", 2)):
            for master, cdtype, clip in variants:
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


def phase_train(torch, dev):
    """The full-width training step through Module on the card."""
    from mxnet_tpu_torch import gpu
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

    kmod = module(False)
    torch.cuda.reset_peak_memory_stats()
    # warm-up: the first step, whose gradients the plain module must match
    # and whose update the plain version must match bit for bit
    real, checked, b1_first = _b1_capture(torch, uk)
    uk.multi_tensor_update = checked
    try:
        t0 = time.perf_counter()
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
    launches = {name: d[name] for d, name in counters}
    paths = {"fused": fused_lm.FUSED_PATH["last"],
             "attention": attn.PATH_TAKEN["last"],
             "update": uk.UPDATE_PATH["last"]}
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
    pmod.forward_backward(batch)
    plain = grads(pmod)
    del pmod
    errs = {}
    for name, gp in plain.items():
        ref = name[:-len("_k_bias")] + "_q_bias" \
            if name.endswith("_k_bias") else name
        denom = float(torch.linalg.vector_norm(plain[ref].double()))
        errs[name] = float(torch.linalg.vector_norm(
            (first[name] - gp).double())) / max(denom, 1e-30)
    direct = ("head_", "final_", "layer%d_ffn2_" % (TRAIN_LAYERS - 1))
    tiers = {"before_relu": ({n: e for n, e in errs.items()
                              if n.startswith(direct)}, TOL_TRAIN_GRAD),
             "behind_relu": ({n: e for n, e in errs.items()
                              if not n.startswith(direct)},
                             TOL_TRAIN_GRAD_RELU)}
    grad_check = {}
    for tier, (tier_errs, tol) in tiers.items():
        worst = max(tier_errs, key=tier_errs.get)
        grad_check[tier] = {"max": tier_errs[worst], "param": worst,
                            "tol": tol}
        if not tier_errs[worst] <= tol:
            raise AssertionError(
                "train gradients, kernel vs plain: %s off by %.3g > %.3g"
                % (worst, tier_errs[worst], tol))
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
    torch.cuda.empty_cache()

    def one_step():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kmod.forward_backward(batch)
        kmod.update()
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    profile = _profile(torch, one_step)
    train = {"config": {"vocab": VOCAB, "t": t, "batch": b,
                        "embed": EMBED, "heads": TRAIN_HEADS, "ffn": FFN,
                        "layers": TRAIN_LAYERS, "dtype": "float32",
                        "optimizer": "sgd", "lr": TRAIN_LR,
                        "params": n_params, "update": "slab plan"},
             "smoke_reading": True, "steps": TRAIN_STEPS,
             "step_s": wall / TRAIN_STEPS, "warmup_step_s": warm_s,
             "first_update_bitwise_vs_plain": b1_first["bitwise"],
             "tokens_per_s": b * t * TRAIN_STEPS / wall, "losses": losses,
             "bench_lr": BENCH_LR, "bench_lr_losses": bench_losses,
             "launches": launches, "launches_per_step": per_step,
             "grad_rel_err": grad_check,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("train: " + json.dumps(train))
    log("train profile: " + json.dumps(profile))
    return train, launches


def _resnet_values(sym, b):
    """bench.py's start, drawn with numpy: Xavier(gaussian, in, 2) weights
    (normal with std sqrt(2 / fan_in), OIHW fan-in I*kh*kw) from
    RandomState(0), gammas 1, betas and the bias 0, moving means 0 and
    variances 1; the resident batch from another RandomState(0)."""
    shapes, _, aux_shapes = sym.infer_shape(data=(b, 3, 224, 224),
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
    x = rng.uniform(-1, 1, (b, 3, 224, 224)).astype(np.float32)
    y = rng.randint(0, 1000, (b,)).astype(np.float32)
    return args, aux, x, y


def phase_train_resnet(torch, dev):
    """ResNet-50 training through Module at bench.py's configuration, the
    optimizer update through the slab plan."""
    from mxnet_tpu_torch import gpu
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

    # the peak over the timed steps, without the copies above (the cache
    # keeps its blocks: emptying it would time the allocator's refill)
    torch.cuda.reset_peak_memory_stats()
    uk.LAUNCHES["multi_tensor_update"] = 0
    uk.UPDATE_PATH["last"] = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        losses.append(step(kmod))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"multi_tensor_update": uk.LAUNCHES["multi_tensor_update"]}
    path = uk.UPDATE_PATH["last"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
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

    torch.cuda.empty_cache()

    def one_step():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(kmod)
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    profile = _profile(torch, one_step, groups=RESNET_KERNEL_GROUPS)
    train = {"config": {"model": "resnet-50", "batch": b,
                        "image": [3, 224, 224], "compute_dtype": "bfloat16",
                        "masters": "float32", "optimizer": "sgd",
                        "optimizer_params": RESNET_OPT, "params": n_params,
                        "update": "slab plan",
                        "source": "bench.py:87-125"},
             "slab_blocks": blocks, "steps": RESNET_STEPS,
             "step_s": wall / RESNET_STEPS, "warmup_step_s": warm_s,
             "img_per_s": b * RESNET_STEPS / wall, "losses": losses,
             "launches": launches, "update_path": path,
             "first_update_bitwise_vs_plain": b1_first["bitwise"],
             "moving_stats_moved": len(aux_now),
             "plan_vs_per_param": parity, "peak_memory_gb": peak_gb}
    log("train resnet: " + json.dumps(train))
    log("train resnet profile: " + json.dumps(profile))
    return train, launches


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
    serve, launches = phase_serve(torch, dev)
    torch.cuda.empty_cache()
    train, train_launches = phase_train(torch, dev)
    torch.cuda.empty_cache()
    resnet, resnet_launches = phase_train_resnet(torch, dev)

    # one line per kernel at its main serving shape: A at decode ffn1
    # (M=4, 1024->4096, f32), B at decode over int8 pages (tq=1, G=1)
    a_main = next(c for c in a_cases if c["dtype"] == "float32"
                  and c["m"] == 4 and c["n"] == 4096)
    b_main = next(c for c in b_cases if c["pool"] == "int8"
                  and c["group"] == 1 and c["tq"] == 1)
    # C, D, E at (64, 2048, 128) f32 G=1; F at ffn1 (m=16384, 1024->4096)
    # f32: the training step's shapes
    cde_main = {name: next(c for c in cases if c["dtype"] == "float32"
                           and c["groups"] == 1)
                for name, cases in cde_cases.items()}
    f_main = next(c for c in f_cases if c["dtype"] == "float32"
                  and c["n"] == FFN)
    a_launch = launches["fused_fwd"] + train_launches["fused_fwd"]
    kernels = [
        dict(_entry("fused_ln_linear_fwd",
                    "mxnet_tpu_torch/csrc/fused_fwd.cu",
                    "mxnet_tpu/ops/pallas_fused.py:118",
                    a_launch, a_main),
             shape="m=4 k=1024 n=4096 float32",
             variant=a_main["variant"],
             launches_by_path={"serve": launches["fused_fwd"],
                               "train": train_launches["fused_fwd"]},
             max_abs_err_all_cases=max(c["max_abs_err"] for c in a_cases)),
        dict(_entry("paged_flash_decode",
                    "mxnet_tpu_torch/csrc/paged_decode.cu",
                    "mxnet_tpu/ops/pallas_decode.py:169",
                    launches["paged_decode"], b_main),
             shape="B=4 tq=1 H=4 hd=256 int8 pages lens=%s"
             % b_main["lens"],
             launches_by_path={"serve": launches["paged_decode"]},
             max_abs_err_all_cases=max(c["max_abs_err"] for c in b_cases)),
    ]
    for name, counter, replaces in (
            ("C", "flash_fwd", "mxnet_tpu/ops/pallas_attention.py:129"),
            ("D", "flash_bwd_dq", "mxnet_tpu/ops/pallas_attention.py:300"),
            ("E", "flash_bwd_dkv",
             "mxnet_tpu/ops/pallas_attention.py:336 (and :381, G > 1)")):
        entry = dict(
            _entry("flash_attention_" + counter[6:],
                   "mxnet_tpu_torch/csrc/flash_attention.cu", replaces,
                   train_launches[counter], cde_main[name]),
            shape="bh=64 t=2048 hd=128 causal float32",
            launches_by_path={"train": train_launches[counter]},
            max_abs_err_all_cases=max(c["max_abs_err"]
                                      for c in cde_cases[name]))
        if "variant" in cde_main[name]:   # C and E
            entry["variant"] = cde_main[name]["variant"]
        kernels.append(entry)
    kernels.append(dict(
        _entry("fused_ln_linear_bwd", "mxnet_tpu_torch/csrc/fused_bwd.cu",
               "mxnet_tpu/ops/pallas_fused.py:214",
               train_launches["fused_bwd"], f_main),
        shape="m=16384 k=1024 n=4096 float32",
        variant=f_main["variant"],
        launches_by_path={"train": train_launches["fused_bwd"]},
        max_abs_err_all_cases=max(c["max_abs_err"] for c in f_cases)))
    # B1 at the ResNet-50 path's update: SGD-momentum over f32 masters
    # with the bf16 compute copy, no clip
    b1_main = next(c for c in b1_cases if c["net"] == "resnet50"
                   and c["kind"] == "sgd_momentum" and c["master"] == "float32"
                   and c["wc"] == "bfloat16" and c["clip"] < 0)
    b1_by_path = {"train_lm": train_launches["multi_tensor_update"],
                  "train_resnet": resnet_launches["multi_tensor_update"]}
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
        max_abs_err_all_cases=max(c["max_abs_err"] for c in b1_cases),
        max_ulps_all_cases=max(c["max_ulps"] for c in b1_cases)))
    log("total wall: %.1f s" % (time.perf_counter() - t0))
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % smi.stderr)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
