#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``mxnet_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. build — compile both hand-written kernels (``mxnet_tpu_torch/csrc``)
   with nvcc for sm_90a, in parallel, and load them;
2. kernels — hold each kernel against its plain PyTorch version on the
   card at the serving path's shapes, and time kernel, plain version and
   one library call that computes the same function (a yardstick the
   port never calls) with the L2 cache flushed before every launch;
3. kernels C-F — the training kernels (flash attention forward, dQ,
   dK/dV; the fused LN->linear backward) against their plain versions at
   the training path's shapes, timed the same way;
4. serve — build the full-width ``attention_lm`` (vocab 8192, embed
   1024, 4 heads, FFN 4096; depth cut to 2 layers) from seeded random
   weights and serve 8 requests (128-1024-token prompts, half sharing a
   256-token prefix, 32 greedy tokens each) through ``DecodeServer`` over
   a paged int8 ``DecodePredictor`` (4 slots, 16-token pages, 256-token
   prefill chunks), counting every kernel launch; then re-serve with the
   plain versions and compare teacher-forced probabilities;
5. train — ``Module.forward_backward`` + ``update`` steps of the
   full-width training configuration (vocab 8192, T 2048, batch 8, embed
   1024, 8 heads, FFN 4096, 4 layers, f32, SGD, seeded Xavier-gaussian
   weights) on one repeated token batch, counting every kernel launch;
   the first step's gradients are held against a ``plain=True``
   module's; the loss must fall; the bench's learning rate is recorded
   beside the one timed; then one profiled step.

The last lines are a ``kernels`` JSON object, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
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
    profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(_kernel_us(e) for e in prof.key_averages())
    return us * 1e-3 / calls if us > 0 else "not measured"


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
                        "relu_residual": relu_res, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "device_ms": dev_ms,
                        "bound_ms": max(t_bytes, t_ops) * 1e3,
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations"}
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


def _profile(torch, run):
    """Device time by kernel over one more run of ``run`` (which returns
    its wall seconds, ending in a synchronize) under torch.profiler: busy
    share of the wall clock and the kernels that take most of it.  The
    profiler slows the host side, so the idle share read here is an upper
    bound."""
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
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall,
            "top": [{"name": k[:90], "calls": n, "device_ms": us * 1e-3,
                     "share_of_busy": us * 1e-6 / busy_s}
                    for us, n, k in rows[:10]]}


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
    T, hd) = (64, 2048, 128), causal; f32 and bf16 with G = 1, and f32
    with G = 2 (32 kv rows).  D and E run on the kernel's own o / lse.
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
                          (torch.float32, 2)):
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
            case = _case(torch, flush, *fns[name], extra={
                "kernel": name, "dtype": dname, "bh": bh, "t": t, "hd": hd,
                "groups": groups, "causal": True, "max_abs_err": errs[name],
                "tol": tol, "bound_ms": bound_ms, "bound_by": bound_by})
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
                    "relu": relu, "max_abs_err": err, "tol": tol,
                    "bound_ms": bound_ms, "bound_by": bound_by})
            log("kernel F case: " + json.dumps(case))
            cases.append(case)
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
    t0 = time.perf_counter()
    kmod.forward_backward(batch)
    kmod.update()
    losses = [loss(kmod)]
    warm_s = time.perf_counter() - t0
    first = grads(kmod)

    counters = ((fk.LAUNCHES, "fused_fwd"), (fk.LAUNCHES, "fused_bwd"),
                (fl.LAUNCHES, "flash_fwd"), (fl.LAUNCHES, "flash_bwd_dq"),
                (fl.LAUNCHES, "flash_bwd_dkv"))
    for d, name in counters:
        d[name] = 0
    fused_lm.FUSED_PATH["last"] = attn.PATH_TAKEN["last"] = None
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
             "attention": attn.PATH_TAKEN["last"]}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    segments = 5 * TRAIN_LAYERS
    want = {"fused_fwd": segments, "fused_bwd": segments,
            "flash_fwd": TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
            "flash_bwd_dkv": TRAIN_LAYERS}
    log("train launches: %s per step %s paths: %s"
        % (launches, per_step, paths))
    if per_step != want or paths != {"fused": "kernel",
                                     "attention": "flash"}:
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
                        "params": n_params},
             "smoke_reading": True, "steps": TRAIN_STEPS,
             "step_s": wall / TRAIN_STEPS, "warmup_step_s": warm_s,
             "tokens_per_s": b * t * TRAIN_STEPS / wall, "losses": losses,
             "bench_lr": BENCH_LR, "bench_lr_losses": bench_losses,
             "launches": launches, "launches_per_step": per_step,
             "grad_rel_err": grad_check,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("train: " + json.dumps(train))
    log("train profile: " + json.dumps(profile))
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
    del flush
    torch.cuda.empty_cache()
    serve, launches = phase_serve(torch, dev)
    torch.cuda.empty_cache()
    train, train_launches = phase_train(torch, dev)

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
        kernels.append(dict(
            _entry("flash_attention_" + counter[6:],
                   "mxnet_tpu_torch/csrc/flash_attention.cu", replaces,
                   train_launches[counter], cde_main[name]),
            shape="bh=64 t=2048 hd=128 causal float32",
            launches_by_path={"train": train_launches[counter]},
            max_abs_err_all_cases=max(c["max_abs_err"]
                                      for c in cde_cases[name])))
    kernels.append(dict(
        _entry("fused_ln_linear_bwd", "mxnet_tpu_torch/csrc/fused_bwd.cu",
               "mxnet_tpu/ops/pallas_fused.py:214",
               train_launches["fused_bwd"], f_main),
        shape="m=16384 k=1024 n=4096 float32",
        launches_by_path={"train": train_launches["fused_bwd"]},
        max_abs_err_all_cases=max(c["max_abs_err"] for c in f_cases)))
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
