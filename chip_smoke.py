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
3. serve — build the full-width ``attention_lm`` (vocab 8192, embed
   1024, 4 heads, FFN 4096; depth cut to 2 layers) from seeded random
   weights and serve 8 requests (128-1024-token prompts, half sharing a
   256-token prefix, 32 greedy tokens each) through ``DecodeServer`` over
   a paged int8 ``DecodePredictor`` (4 slots, 16-token pages, 256-token
   prefill chunks), counting every kernel launch; then re-serve with the
   plain versions and compare teacher-forced probabilities.

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
    """Kernel A at the LM's segments: M = 4 (decode) and 256 (a prefill
    chunk); q/k/v/attout-sized (1024, 1024), ffn1 (1024, 4096) and ffn2
    (4096, 1024, ReLU + residual); f32 and bf16."""
    from mxnet_tpu_torch.ops import fused_kernel as fk

    cases = []
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        isz = torch.empty((), dtype=dtype).element_size()
        for m in (4, 256):
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


def _profile(torch, pred, prompts):
    """Device time by kernel over one more serve of the same requests,
    under torch.profiler: busy share of the wall clock and the kernels
    that take most of it.  The profiler slows the host side, so the idle
    share read here is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall, _ = _serve(torch, pred, prompts)
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
    profile = _profile(torch, pred, prompts)
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
        "<= %g; greedy-token agreement >= %g"
        % (TOL_A, TOL_A_STATS, TOL_B, TOL_LOGP, MIN_GREEDY_AGREEMENT))
    t0 = time.perf_counter()
    phase_build()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    a_cases = phase_kernel_a(torch, dev, flush)
    b_cases = phase_kernel_b(torch, dev, flush)
    del flush
    serve, launches = phase_serve(torch, dev)

    # one line per kernel at its main serving shape: A at decode ffn1
    # (M=4, 1024->4096, f32), B at decode over int8 pages (tq=1, G=1)
    a_main = next(c for c in a_cases if c["dtype"] == "float32"
                  and c["m"] == 4 and c["n"] == 4096)
    b_main = next(c for c in b_cases if c["pool"] == "int8"
                  and c["group"] == 1 and c["tq"] == 1)
    kernels = [
        dict(_entry("fused_ln_linear_fwd",
                    "mxnet_tpu_torch/csrc/fused_fwd.cu",
                    "mxnet_tpu/ops/pallas_fused.py:118",
                    launches["fused_fwd"], a_main),
             shape="m=4 k=1024 n=4096 float32",
             max_abs_err_all_cases=max(c["max_abs_err"] for c in a_cases)),
        dict(_entry("paged_flash_decode",
                    "mxnet_tpu_torch/csrc/paged_decode.cu",
                    "mxnet_tpu/ops/pallas_decode.py:169",
                    launches["paged_decode"], b_main),
             shape="B=4 tq=1 H=4 hd=256 int8 pages lens=%s"
             % b_main["lens"],
             max_abs_err_all_cases=max(c["max_abs_err"] for c in b_cases)),
    ]
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
