"""The PyTorch port's CUDA kernels against their plain PyTorch versions,
on the card.  Every test is marked ``cuda`` and skips without a card;
the file imports nothing of JAX, so it runs where only PyTorch is
installed::

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Shapes are small and ragged on purpose (masked tile edges, every kernel
A / F variant, several kernel-B tq tiles, page sizes, head dims and
pool dtypes, flash T that are not multiples of the 64-row tile, kv
groups); ``chip_smoke.py`` covers the serving and training shapes.  Tolerances:
f32 1e-5 relative to the output's magnitude (the same products summed in
another order); bf16 one bf16 ulp (2^-7 relative, a rounding flip); the
paged kernel 1e-5 (f32 softmax, streamed in another order), 1e-2 for
bf16 pools, whose plain version rounds the probabilities to bf16.
"""
import contextlib

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import attention as attn
from mxnet_tpu_torch.ops import decode_kernel as dk
from mxnet_tpu_torch.ops import fused_kernel as fk

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# kernels A and F over every variant's edges: M across the decode / tile
# boundary, K and N not multiples of any tile, K = 1 mod 4 (scalar loads),
# K and N multiples of 8 (16-byte loads, the tensor-core path), and
# shapes large enough for the 128 x 128 tiles and dW's split over M.
# scale and shift are views whose storage continues past K with huge
# values, so a kernel that read past K would show it.
FUSED_M = [1, 4, 16, 17, 100, 256, 1000]
FUSED_KN = [(33, 70), (136, 200), (5, 3)]
FUSED_BIG = [(4200, 264, 1104), (2100, 1032, 136)]


def _fused_inputs(card, dtype, m, k, n, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(card)

    def padded(v):
        return torch.cat([v, torch.full((9,), 1e30, device=card)])[:v.numel()]

    x, w, r = rand(m, k).to(dtype), (rand(n, k) / k ** 0.5).to(dtype), \
        rand(m, n).to(dtype)
    scale, shift, bias = padded(1 + 0.1 * rand(k)), padded(0.1 * rand(k)), \
        0.1 * rand(n)
    return x, w, r, scale, shift, bias


def _fwd_case(card, dtype, m, k, n, x, w, r, scale, shift, bias):
    for relu, res, b in ((True, r, bias), (False, None, bias),
                         (False, None, None)):
        before = fk.LAUNCHES["fused_fwd"]
        got = fk.fused_scale_relu_matmul(x, scale, shift, w, residual=res,
                                         relu=relu, bias=b)
        torch.cuda.synchronize()
        assert fk.LAUNCHES["fused_fwd"] == before + 1
        want = fk.fused_plain(x, scale, shift, w, residual=res, relu=relu,
                              bias=b)
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7
        for gv, wv in zip(got, want):
            mag = max(1.0, float(wv.float().abs().max()))
            torch.testing.assert_close(gv.float(), wv.float(), rtol=tol,
                                       atol=tol * mag)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", FUSED_M)
@pytest.mark.parametrize("k,n", FUSED_KN)
def test_fused_kernel_matches_plain(card, dtype, m, k, n):
    args = _fused_inputs(card, dtype, m, k, n, m * 1000 + k)
    _fwd_case(card, dtype, m, k, n, *args)
    aligned = fk._aligned(*args)
    assert fk.LAST_VARIANT["fused_fwd"] == fk._plan(
        m, k, n, dtype, "fwd", aligned).variant


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", FUSED_BIG)
def test_fused_kernel_large_tiles_match_plain(card, dtype, m, k, n):
    args = _fused_inputs(card, dtype, m, k, n, m + k)
    _fwd_case(card, dtype, m, k, n, *args)
    assert fk.LAST_VARIANT["fused_fwd"] == fk._plan(m, k, n, dtype).variant
    if n > 1000:
        assert fk.LAST_VARIANT["fused_fwd"] in ("simt128", "wgmma128")


def test_fused_kernel_unaligned_takes_scalar_loads(card):
    """A view 4 bytes into its storage takes the scalar-load variant."""
    x, w, r, scale, shift, bias = _fused_inputs(card, torch.float32, 300,
                                                64, 96, 5)
    xs = torch.empty(300 * 64 + 1, device=card)[1:].view(300, 64)
    xs.copy_(x)
    _fwd_case(card, torch.float32, 300, 64, 96, xs, w, r, scale, shift, bias)
    assert fk.LAST_VARIANT["fused_fwd"].endswith("_scalar")


FWD_ONLY = ("decode", "decode_scalar", "wgmma128")  # kernel A's alone
BWD_ONLY = ("mma128",)                             # kernel F's alone


@pytest.mark.parametrize("variant", fk.VARIANTS)
def test_every_fused_variant_matches_plain(card, variant, monkeypatch):
    """Each variant forced onto ragged shapes it accepts: decode at M <= 16,
    the tiles at M = 100 and 1000, 16-byte loads only where K and N
    allow them, bf16 only for the tensor-core variants; each through the
    kernels that have it."""
    dtypes = ([torch.bfloat16] if "mma" in variant else
              [torch.float32] if variant.startswith("simt")
              and not variant.endswith("_scalar")
              else [torch.float32, torch.bfloat16])
    ms = [1, 13] if variant.startswith("decode") else [100, 1000]
    kn = [(136, 200)] + ([] if not variant.endswith("_scalar") else [(33, 70)])
    code = fk.VARIANTS.index(variant)
    real = fk._plan

    def forced(m, k, n, dtype, product="fwd", aligned=True):
        p = real(m, k, n, dtype, product, aligned)
        return p._replace(variant=variant, code=code)

    monkeypatch.setattr(fk, "_plan", forced)
    for dtype in dtypes:
        for m in ms:
            for k, n in kn:
                args = _fused_inputs(card, dtype, m, k, n, m + n)
                if variant not in BWD_ONLY:
                    _fwd_case(card, dtype, m, k, n, *args)
                if variant in FWD_ONLY:
                    continue
                _bwd_case(card, dtype, *args[:2], args[3], args[4])
                assert fk.LAST_VARIANT["fused_bwd"].startswith(variant)


POOL_DTYPES = [torch.float32, torch.bfloat16, torch.int8,
               torch.float8_e4m3fn, torch.float8_e5m2]


def _paged_case(card, pool_dtype, tq, pt, hd, group, m, seed, heads=4):
    g = torch.Generator(device="cpu").manual_seed(seed)
    kvh = heads // group
    pages = 1 + 2 * m
    e_kv = kvh * hd

    def pool():
        x = torch.randn(pages, pt, e_kv, generator=g)
        if pool_dtype in (torch.float32, torch.bfloat16):
            return x.to(pool_dtype).to(card)
        qkv = attn.quantize_kv(x.reshape(1, pages * pt, e_kv), pool_dtype,
                               kvh)
        return attn.QuantKV(qkv.data.reshape(pages, pt, e_kv).to(card),
                            qkv.scale.reshape(pages, pt, kvh).to(card))

    kp, vp = pool(), pool()
    table = torch.randint(1, pages, (2, m), generator=g,
                          dtype=torch.int32).to(card)
    q = torch.randn(2, tq, heads * hd, generator=g).to(card)
    return q, kp, vp, table, kvh


@pytest.mark.parametrize("pool_dtype", POOL_DTYPES)
@pytest.mark.parametrize("tq,pt,hd,group", [(1, 16, 256, 1),
                                            (3, 4, 16, 2),
                                            (37, 16, 64, 2),
                                            (256, 16, 256, 1)])
def test_paged_kernel_matches_plain(card, pool_dtype, tq, pt, hd, group):
    heads, m = 4, 8
    q, kp, vp, table, kvh = _paged_case(card, pool_dtype, tq, pt, hd, group,
                                        m, tq + pt + hd)
    c = m * pt
    # every window holds its own queries (total >= tq), as in serving
    for lens in ([tq + 3, tq], [c + tq + 5, min(tq + 1, c) + tq]):
        lens = torch.tensor(lens, dtype=torch.int32, device=card)
        before = dk.LAUNCHES["paged_decode"]
        fn = dk.flash_sdpa_decode if tq == 1 else dk.flash_sdpa_verify
        got = fn(q, kp, vp, table, lens, num_heads=heads, num_kv_heads=kvh)
        torch.cuda.synchronize()
        assert dk.LAUNCHES["paged_decode"] == before + 1
        want = dk.paged_plain(q, kp, vp, table, lens, heads, None, kvh)
        assert got.dtype == want.dtype
        tol = 1e-2 if pool_dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("pool_dtype", POOL_DTYPES)
@pytest.mark.parametrize("tq", [1, 4, 16, 17, 64, 256])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("pt", [4, 16])
@pytest.mark.parametrize("hd", [64, 128])
def test_paged_kernel_variants_match_plain(card, pool_dtype, tq, group, pt,
                                           hd):
    """Kernel B and the combine kernel across the decode / chunk boundary
    (tq 16 / 17), G q-heads a kv-head, every pool dtype, page sizes 4 and
    16, head dims 64 and 128; windows whose later splits lie wholly past
    the live length, and a wrapped ring (every view slot live).
    ``LAST_VARIANT`` names what ran, as ``_plan`` chose it."""
    heads, m = 4, 32
    q, kp, vp, table, kvh = _paged_case(card, pool_dtype, tq, pt, hd, group,
                                        m, tq * 7 + group + pt + hd)
    c = m * pt
    for lens in ([tq + 3, tq + 40], [c + tq + 5, min(tq + 1, c) + tq]):
        lens = torch.tensor(lens, dtype=torch.int32, device=card)
        before = dict(dk.LAUNCHES)
        fn = dk.flash_sdpa_decode if tq == 1 else dk.flash_sdpa_verify
        got = fn(q, kp, vp, table, lens, num_heads=heads, num_kv_heads=kvh)
        torch.cuda.synchronize()
        assert {n: dk.LAUNCHES[n] - before[n] for n in before} == {
            "paged_decode": 1, "paged_combine": 1}
        assert dk.LAST_VARIANT["paged_decode"] == dk._plan(
            2, tq, heads, kvh, hd, hd, m, pt, dk._sm_count(card)).variant
        want = dk.paged_plain(q, kp, vp, table, lens, heads, None, kvh)
        assert got.dtype == want.dtype
        tol = 1e-2 if pool_dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("b,heads,kvh,tq", [(32, 32, 32, 1),
                                            (8, 32, 8, 16)])
def test_paged_kernel_long_views_on_full_grids(card, pool_dtype, b, heads,
                                               kvh, tq):
    """Grids already full at one split (b * kv-heads * row tiles >= four
    blocks an SM) over views longer than a split's page-id store
    (MAX_SPLIT_PAGES): 32 slots of a 32-head model decoding, and 8 slots'
    16-row verify windows at G = 4, over 2050 pages of 4 tokens.  The
    plan still cuts the view into splits the kernel takes."""
    hd, pt, m, pages = 64, 4, 2050, 257
    g = torch.Generator(device="cpu").manual_seed(b + tq)
    e_kv = kvh * hd

    def pool():
        x = torch.randn(pages, pt, e_kv, generator=g)
        if pool_dtype == torch.float32:
            return x.to(card)
        qkv = attn.quantize_kv(x.reshape(1, pages * pt, e_kv), pool_dtype,
                               kvh)
        return attn.QuantKV(qkv.data.reshape(pages, pt, e_kv).to(card),
                            qkv.scale.reshape(pages, pt, kvh).to(card))

    kp, vp = pool(), pool()
    table = torch.randint(1, pages, (b, m), generator=g,
                          dtype=torch.int32).to(card)
    q = torch.randn(b, tq, heads * hd, generator=g).to(card)
    c = m * pt
    lens = torch.randint(tq, c, (b,), generator=g, dtype=torch.int32)
    lens[0], lens[1] = tq, c + tq + 5
    lens = lens.to(card)
    plan = dk._plan(b, tq, heads, kvh, hd, hd, m, pt, dk._sm_count(card))
    assert plan.splits >= 2 and plan.pages_per_split <= dk.MAX_SPLIT_PAGES
    before = dk.LAUNCHES["paged_decode"]
    fn = dk.flash_sdpa_decode if tq == 1 else dk.flash_sdpa_verify
    got = fn(q, kp, vp, table, lens, num_heads=heads, num_kv_heads=kvh)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["paged_decode"] == before + 1
    want = dk.paged_plain(q, kp, vp, table, lens, heads, None, kvh)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.int8,
                                        torch.float8_e4m3fn])
@pytest.mark.parametrize("group", [1, 2])
def test_paged_kernel_at_the_verify_window(card, pool_dtype, group):
    """Kernel B at the speculative verify window, tq = k + 1 = 9, over
    the serve's head dim (4 heads of 256, 16-token pages): the decode
    variant, 4-row tiles (3 of them at G = 1, 5 at G = 2).  Four slots
    of different lengths: one just past its window (every later split
    dead), one mid-view, one at the full view, and an inactive row whose
    table is all scratch page and whose length is its own window."""
    heads, hd, pt, m, tq = 4, 256, 16, 16, 9
    g = torch.Generator(device="cpu").manual_seed(90 + group)
    kvh = heads // group
    pages = 1 + 3 * m
    e_kv = kvh * hd

    def pool():
        x = torch.randn(pages, pt, e_kv, generator=g)
        if pool_dtype == torch.float32:
            return x.to(card)
        qkv = attn.quantize_kv(x.reshape(1, pages * pt, e_kv), pool_dtype,
                               kvh)
        return attn.QuantKV(qkv.data.reshape(pages, pt, e_kv).to(card),
                            qkv.scale.reshape(pages, pt, kvh).to(card))

    kp, vp = pool(), pool()
    table = torch.randint(1, pages, (4, m), generator=g, dtype=torch.int32)
    table[3] = 0
    table = table.to(card)
    q = torch.randn(4, tq, heads * hd, generator=g).to(card)
    lens = torch.tensor([tq + 3, 130, m * pt, tq], dtype=torch.int32,
                        device=card)
    plan = dk._plan(4, tq, heads, kvh, hd, hd, m, pt, dk._sm_count(card))
    assert (plan.variant, plan.rows) == ("decode", 4)
    assert plan.row_tiles == -(-group * tq // 4) and plan.splits >= 2
    before = dict(dk.LAUNCHES)
    got = dk.flash_sdpa_verify(q, kp, vp, table, lens, num_heads=heads,
                               num_kv_heads=kvh)
    torch.cuda.synchronize()
    assert dk.LAST_VARIANT["paged_decode"] == "decode"
    assert dk.LAUNCHES["paged_decode"] == before["paged_decode"] + 1
    assert dk.LAUNCHES["paged_combine"] == before["paged_combine"] + 1
    want = dk.paged_plain(q, kp, vp, table, lens, heads, None, kvh)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,n,relu_res", [(1024, 1024, False),
                                          (1024, 4096, False),
                                          (4096, 1024, True),
                                          (1024, 8192, False)])
def test_fused_kernel_at_the_verify_rows(card, k, n, relu_res):
    """Kernel A at M = slots x (k + 1) = 36 rows, past the decode
    variant's 16: the serve's q/k/v, ffn1 and ffn2 widths and a
    vocabulary-wide N, f32, against the plain version."""
    x, w, r, scale, shift, bias = _fused_inputs(card, torch.float32, 36, k,
                                                n, k + n)
    assert fk._plan(36, k, n, torch.float32).variant.startswith("simt")
    kw = dict(residual=r if relu_res else None, relu=relu_res, bias=bias)
    before = fk.LAUNCHES["fused_fwd"]
    got = fk.fused_scale_relu_matmul(x, scale, shift, w, **kw)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fused_fwd"] == before + 1
    assert fk.LAST_VARIANT["fused_fwd"].startswith("simt")
    want = fk.fused_plain(x, scale, shift, w, **kw)
    for gv, wv in zip(got, want):
        mag = max(1.0, float(wv.abs().max()))
        torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-5 * mag)


@pytest.mark.parametrize("tq,hd", [(1, 256), (16, 128), (256, 256),
                                   (64, 128)])
def test_paged_kernel_is_bitwise_repeatable(card, tq, hd):
    """Each block owns its partials and the combine sums the splits in a
    fixed order (no atomics): two runs agree bit for bit."""
    q, kp, vp, table, kvh = _paged_case(card, torch.int8, tq, 16, hd, 2, 16,
                                        tq + hd)
    lens = torch.tensor([tq + 100, 16 * 16 + tq], dtype=torch.int32,
                        device=card)
    fn = dk.flash_sdpa_decode if tq == 1 else dk.flash_sdpa_verify
    runs = [fn(q, kp, vp, table, lens, num_heads=4, num_kv_heads=kvh)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [256, 6])
def test_combine_kernel_matches_plain(card, out_dtype, hd):
    """The combine kernel against ``_combine`` on partials with splits
    that saw nothing (m = -inf, l = 0, acc 0) and a row no split saw."""
    g = torch.Generator(device="cpu").manual_seed(hd)
    b, h, s, tq = 2, 3, 5, 4
    acc = torch.randn(b, h, s, tq, hd, generator=g)
    m = torch.randn(b, h, s, tq, generator=g) * 3
    l = torch.rand(b, h, s, tq, generator=g) + 0.5
    m[:, :, 2] = -torch.inf
    m[0, 1, :, 3] = -torch.inf
    dead = m == -torch.inf
    l[dead] = 0.0
    acc[dead] = 0.0
    acc, m, l = acc.to(card), m.to(card), l.to(card)
    before = dk.LAUNCHES["paged_combine"]
    got = dk._launch_combine(acc, m, l, out_dtype)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["paged_combine"] == before + 1
    want = dk._combine(acc, m, l, out_dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 1e-6 if out_dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_card_tensors_the_kernels_refuse_raise(card):
    """On the card there is no third path: a dtype kernel A does not
    take, or a shape kernel B does not take, raises."""
    from mxnet_tpu_torch.registry import OpContext, get_op

    op = get_op("FusedLNLinear")
    x = torch.zeros((2, 3, 8), dtype=torch.float16, device=card)
    ins = [x, torch.ones((1, 1, 8), dtype=torch.float16, device=card),
           torch.zeros((1, 1, 8), dtype=torch.float16, device=card),
           torch.zeros((4, 8), dtype=torch.float16, device=card),
           torch.zeros((4,), dtype=torch.float16, device=card)]
    with pytest.raises(ValueError, match="float16"):
        op.fcompute(op.parse_attrs({"num_hidden": "4"}), ins, [],
                    OpContext())
    q = torch.zeros((2, 1, 64), device=card)
    pool = torch.zeros((5, 4, 32), device=card)
    table = torch.ones((2, 2), dtype=torch.int32, device=card)
    lens = torch.ones((2,), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="do not fit"):
        attn.paged_attend(q, pool, pool, table, lens, num_heads=4)


def test_dense_ring_kernel_matches_plain(card):
    g = torch.Generator(device="cpu").manual_seed(0)
    heads, hd, c = 4, 32, 24
    kc = torch.randn(2, c, heads * hd, generator=g).to(card)
    vc = torch.randn(2, c, heads * hd, generator=g).to(card)
    q = torch.randn(2, 1, heads * hd, generator=g).to(card)
    lens = torch.tensor([5, c + 9], dtype=torch.int32, device=card)
    got = dk.dense_ring_attend(q, kc, vc, lens, num_heads=heads)
    want = attn._sdpa_cache(q, kc, vc, lens, heads, None)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# kernels C, D, E (flash attention) and F (fused backward).  f32: 1e-5 of
# each output's largest magnitude (the same f32 products summed in
# another order; F's column sums add per-tile atomics in varying order);
# bf16: 2^-7 of it (bf16 outputs, and p / ds rounded to bf16 inside the
# backward: a rounding flip between orders moves a sum by one bf16 ulp
# of a term).
# ---------------------------------------------------------------------------

CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _card_close(got, want, tol):
    mag = max(1.0, float(want.float().abs().max()))
    assert got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * mag)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,hd,groups", [(128, 64, 1), (100, 128, 2),
                                         (67, 64, 2), (193, 128, 1),
                                         (1000, 128, 1), (321, 64, 2)])
def test_flash_kernels_match_plain(card, dtype, causal, t, hd, groups):
    from mxnet_tpu_torch.ops import flash_kernel as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cpu").manual_seed(t + hd + groups)
    bh = 4

    def rand(rows):
        return torch.randn(rows, t, hd, generator=g).to(dtype).to(card)

    q, k, v, do = rand(bh), rand(bh // groups), rand(bh // groups), rand(bh)
    scale = hd ** -0.5
    before = dict(fl.LAUNCHES)
    o, lse = fl.flash_fwd(q, k, v, scale, causal, groups)
    dq, dk, dv = fl.flash_bwd(q, k, v, o, lse, do, scale, causal, groups)
    torch.cuda.synchronize()
    assert {n: fl.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    variant = "simt" if dtype == torch.float32 else "wgmma"
    assert fl.LAST_VARIANT == {"flash_fwd": variant, "flash_bwd_dq": variant,
                               "flash_bwd_dkv": variant}
    wo, wlse = fl.flash_plain_fwd(q, k, v, scale, causal, groups)
    _card_close(o, wo, CARD_TOL[dtype])
    _card_close(lse, wlse, 1e-5)
    # the backward from the same o / lse, so the check is D and E alone
    want = fl.flash_plain_bwd(q, k, v, o, lse, do, scale, causal, groups)
    for got, w in zip((dq, dk, dv), want):
        _card_close(got, w, CARD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_are_bitwise_repeatable(card, dtype):
    """C, D and E own their output tiles and sum in a fixed order (no
    atomics): two runs on the same inputs agree bit for bit."""
    from mxnet_tpu_torch.ops import flash_kernel as fl

    g = torch.Generator(device="cpu").manual_seed(5)
    t, hd, groups = 321, 128, 2

    def rand(rows):
        return torch.randn(rows, t, hd, generator=g).to(dtype).to(card)

    q, k, v, do = rand(4), rand(2), rand(2), rand(4)
    runs = []
    for _ in range(2):
        o, lse = fl.flash_fwd(q, k, v, hd ** -0.5, True, groups)
        delta = fl.flash_delta(o, do)
        dq = fl.flash_bwd_dq(q, k, v, do, lse, delta, hd ** -0.5, True,
                             groups)
        dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, delta, hd ** -0.5, True,
                                  groups)
        runs.append((o, lse, dq, dk, dv))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_kernels_take_unaligned_views(card):
    """A view whose data is not 16-byte aligned is copied before the
    16-byte loads of C, D and E (never a plain fallback)."""
    from mxnet_tpu_torch.ops import flash_kernel as fl

    g = torch.Generator(device="cpu").manual_seed(6)
    n = 2 * 70 * 64
    base = torch.randn(4 * n + 1, generator=g).to(torch.bfloat16).to(card)
    q, k, v, do = (base[1 + i * n:1 + (i + 1) * n].view(2, 70, 64)
                   for i in range(4))
    assert q.data_ptr() % 16 != 0
    before = dict(fl.LAUNCHES)
    o, lse = fl.flash_fwd(q, k, v, 0.125, True)
    delta = fl.flash_delta(o, do)
    dq = fl.flash_bwd_dq(q, k, v, do, lse, delta, 0.125, True)
    dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, delta, 0.125, True)
    torch.cuda.synchronize()
    assert {n: fl.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    wo, wlse = fl.flash_plain_fwd(q, k, v, 0.125, True)
    _card_close(o, wo, CARD_TOL[torch.bfloat16])
    wdq, wdk, wdv = fl.flash_plain_bwd(q, k, v, o, lse, do, 0.125, True)
    _card_close(dq, wdq, CARD_TOL[torch.bfloat16])
    _card_close(dk, wdk, CARD_TOL[torch.bfloat16])
    _card_close(dv, wdv, CARD_TOL[torch.bfloat16])


def _bwd_case(card, dtype, x, w, scale, shift, seed=0):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cpu").manual_seed(seed)
    dy = torch.randn(x.shape[0], w.shape[0], generator=g).to(card).to(dtype)
    for relu in (True, False):
        before = fk.LAUNCHES["fused_bwd"]
        got = fk.fused_bwd(x, dy, scale, shift, w, relu)
        torch.cuda.synchronize()
        assert fk.LAUNCHES["fused_bwd"] == before + 1
        want = fk.fused_bwd_plain(x, dy, scale, shift, w, relu)
        # dW, dscale and dshift sum over M: 1e-4 past a few hundred rows
        tol = 1e-5 if x.shape[0] <= 256 else 1e-4
        tols = (CARD_TOL[dtype], tol, tol, tol)
        for gv, wv, tol in zip(got, want, tols):
            _card_close(gv, wv, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", FUSED_M)
@pytest.mark.parametrize("k,n", FUSED_KN)
def test_fused_bwd_kernel_matches_plain(card, dtype, m, k, n):
    x, w, _, scale, shift, _ = _fused_inputs(card, dtype, m, k, n, m * 7 + k)
    _bwd_case(card, dtype, x, w, scale, shift, m)
    aligned = fk._aligned(x, w, scale, shift)
    dx, dw = (fk._plan(m, k, n, dtype, p, aligned) for p in ("dx", "dw"))
    assert fk.LAST_VARIANT["fused_bwd"] == "%s/%sx%d" % (
        dx.variant, dw.variant, dw.splits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", FUSED_BIG)
def test_fused_bwd_large_tiles_and_split_match_plain(card, dtype, m, k, n):
    x, w, _, scale, shift, _ = _fused_inputs(card, dtype, m, k, n, m + k)
    _bwd_case(card, dtype, x, w, scale, shift, 1)
    assert fk._plan(m, k, n, dtype, "dw").splits > 1
    dy = torch.randn(m, n, device=card).to(dtype)
    dw1 = fk.fused_bwd(x, dy, scale, shift, w, True)[1]
    dw2 = fk.fused_bwd(x, dy, scale, shift, w, True)[1]
    # the split's partials are summed in a fixed order: dW is bitwise
    # the same from run to run
    assert torch.equal(dw1, dw2)


def test_autograd_runs_the_kernels(card):
    """FlashAttentionFn and FusedLNLinearFn launch the kernels forward
    and backward on the card, and their gradients equal the plain
    path's."""
    from mxnet_tpu_torch.ops import flash_kernel as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cpu").manual_seed(11)
    q, k, v = (torch.randn(4, 96, 64, generator=g).to(card)
               for _ in range(3))
    grads = []
    for plain in (False, True):
        leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
        before = dict(fl.LAUNCHES)
        out = fl.FlashAttentionFn.apply(*leaves, 0.125, True, 1, plain)
        grads.append(torch.autograd.grad(out.square().sum(), leaves))
        launched = sum(fl.LAUNCHES[n] - before[n] for n in before)
        assert launched == (0 if plain else 3)
    for a, b in zip(*grads):
        _card_close(a, b, 1e-5)

    x = torch.randn(40, 24, generator=g).to(card)
    w = (torch.randn(16, 24, generator=g) / 5).to(card)
    sc, sh, b = (torch.randn(n, generator=g).to(card) for n in (24, 24, 16))
    res = torch.randn(40, 16, generator=g).to(card)
    grads = []
    for plain in (False, True):
        leaves = [a.clone().requires_grad_(True)
                  for a in (x, sc, sh, w, b, res)]
        before = dict(fk.LAUNCHES)
        y, s1, s2 = fk.FusedLNLinearFn.apply(*leaves, True, plain)
        grads.append(torch.autograd.grad((y * y).sum() + s1.sum(), leaves))
        assert fk.LAUNCHES["fused_bwd"] - before["fused_bwd"] == (
            0 if plain else 1)
    for a, b in zip(*grads):
        _card_close(a, b, 1e-5)


def test_card_tensors_the_training_kernels_refuse_raise(card):
    """A dtype or head dim kernels C-F do not take raises on the card."""
    from mxnet_tpu_torch.ops import flash_kernel as fl

    h = torch.zeros((2, 64, 64), dtype=torch.float16, device=card)
    with pytest.raises(ValueError, match="float16"):
        fl.flash_fwd(h, h, h, 0.125, True)
    q = torch.zeros((2, 64, 256), device=card)
    with pytest.raises(ValueError, match="head dim 256"):
        fl.flash_fwd(q, q, q, 0.0625, True)
    x = torch.zeros((4, 8), dtype=torch.float16, device=card)
    one = torch.ones((8,), device=card)
    with pytest.raises(ValueError, match="float16"):
        fk.fused_bwd(x, torch.zeros((4, 4), dtype=torch.float16,
                                    device=card), one, one,
                     torch.zeros((4, 8), dtype=torch.float16, device=card),
                     False)


@pytest.mark.parametrize("embed,heads", [(512, 16), (512, 2)])
def test_module_trains_head_dims_the_flash_kernels_refuse(card, embed,
                                                          heads):
    """A Module over attention_lm at head dim 32 (16 heads over 512) and
    256 (2 heads over 512): the attention goes to sdpa ("einsum") on the
    card, as the JAX package routes the shapes its gate refuses, the
    flash kernels are not launched, and the step matches a plain=True
    module: outputs 1e-5, gradients 1e-4 of their norm before any ReLU
    mask and 1e-2 behind one (a mask flip where a pre-activation lies
    within f32 rounding of 0, as chip_smoke.py states)."""
    import numpy as np

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.ops import flash_kernel as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    b, t, vocab = 2, 64, 64
    sym = attention_lm.get_symbol(vocab_size=vocab, seq_len=t, num_layers=1,
                                  embed=embed, heads=heads, ffn_hidden=1024)
    rng = np.random.RandomState(embed + heads)
    shapes, _, _ = sym.infer_shape(data=(b, t), softmax_label=(b, t))
    params = {n: (rng.randn(*s) * 0.05 + n.endswith("_gamma")).astype(
        np.float32) for n, s in zip(sym.list_arguments(), shapes)
        if n not in ("data", "softmax_label")}
    x = rng.randint(0, vocab, (b, t)).astype(np.float32)
    batch = DataBatch([mt.nd.array(x)], [mt.nd.array(np.roll(x, -1, 1))])
    outs, grads = [], []
    for plain in (False, True):
        mod = mt.mod.Module(sym, context=mt.gpu(0), plain=plain)
        mod.bind(data_shapes=[DataDesc("data", (b, t), layout="NT")],
                 label_shapes=[DataDesc("softmax_label", (b, t),
                                        layout="NT")])
        mod.init_params(arg_params=params, aux_params={})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.01})
        attn.PATH_TAKEN["last"] = None
        before = dict(fl.LAUNCHES)
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        assert attn.PATH_TAKEN["last"] == "einsum"
        assert fl.LAUNCHES == before
        group = mod._exec_group
        outs.append(mod.get_outputs()[0].data.clone())
        grads.append({n: a.data.clone() for n, a in
                      zip(group.param_names, group.grad_arrays)})
    _card_close(outs[0], outs[1], 1e-5)
    for name, gp in grads[1].items():
        err = float(torch.linalg.vector_norm(grads[0][name] - gp))
        ref = name[:-len("_k_bias")] + "_q_bias" \
            if name.endswith("_k_bias") else name
        norm = float(torch.linalg.vector_norm(grads[1][ref]))
        tol = 1e-4 if name.startswith(("head_", "final_",
                                       "layer0_ffn2_")) else 1e-2
        assert err <= tol * max(norm, 1e-30), (name, err, norm)


# ---------------------------------------------------------------------------
# kernel B1 (the multi-tensor optimizer update).  Bitwise against its plain
# version: both round every f32 operation once, in the same order, and
# round to bf16 / f16 to nearest even; Adam's square root and quotient are
# correctly rounded on both sides (__fsqrt_rn / __fdiv_rn, torch's sqrt and
# division), so Adam is held to one f32 ulp and reported when it is not 0.
# ---------------------------------------------------------------------------

def _ulps(a, b):
    """Largest distance in f32 ulps between two f32 tensors."""
    ia = a.float().contiguous().view(torch.int32).long()
    ib = b.float().contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def _update_case(dev, kind, nslots, master, cdtype, seed):
    """Slabs of a plan over ragged segments (sizes not multiples of the
    2,048-element block), with lr / wd differing per segment."""
    from mxnet_tpu_torch.ops import update_kernel as uk

    g = torch.Generator(device="cpu").manual_seed(seed)
    sizes = [(7,), (3, 700), (2049,), (64, 3, 3, 3), (1,), (5000,)]
    params = {"p%d" % i: torch.randn(s, generator=g).to(master)
              for i, s in enumerate(sizes)}
    plan = uk.UpdatePlan(kind, nslots, uk._segments_for(params), cdtype)
    (bk,) = plan.buckets
    w = plan.pack(params, dev)[bk]
    grads = {n: 0.1 * torch.randn(v.shape, generator=g)
             for n, v in params.items()}
    gs = plan.pack(grads, dev, dtype=torch.float32)[bk]
    slots = {n: tuple(0.01 * torch.randn(v.shape, generator=g).abs()
                      for _ in range(nslots)) for n, v in params.items()}
    ss = plan.pack_slots(slots, dev)[bk]
    wc = plan.cast_slabs({bk: w}).get(bk)
    lrs = {n: 0.01 * (i + 1) for i, n in enumerate(params)}
    wds = {n: 1e-4 * (i % 3) for i, n in enumerate(params)}
    lrb, wdb = plan.lr_wd_blocks(lrs, wds)
    lrb = torch.from_numpy(lrb[bk]).to(dev)
    wdb = torch.from_numpy(wdb[bk]).to(dev)
    return plan, w, gs, ss, wc, lrb, wdb


@pytest.mark.parametrize("kind,nslots", [("sgd", 0), ("sgd", 1),
                                         ("adam", 2)])
@pytest.mark.parametrize("master,cdtype", [
    (torch.float32, None), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float16), (torch.bfloat16, None)])
@pytest.mark.parametrize("clip", [-1.0, 0.05])
def test_update_kernel_matches_plain(card, kind, nslots, master, cdtype,
                                     clip):
    from mxnet_tpu_torch.ops import update_kernel as uk

    plan, w, gs, ss, wc, lrb, wdb = _update_case(card, kind, nslots, master,
                                                 cdtype, nslots + len(kind))
    hyp = [0.5, clip, 0.9] if kind == "sgd" else [0.5, clip, 0.9, 0.999,
                                                    1e-8]
    want = [t.clone() for t in (w, *ss)] + ([wc.clone()] if wc is not None
                                            else [])
    ptrs = [t.data_ptr() for t in (w, gs, *ss)]
    before = uk.LAUNCHES["multi_tensor_update"]
    path = uk.multi_tensor_update(kind, nslots, w, gs, ss, wc, lrb, wdb, hyp)
    torch.cuda.synchronize()
    assert path == "kernel"
    assert uk.LAUNCHES["multi_tensor_update"] == before + 1
    # in place: the same storage, padding lanes still 0
    assert [t.data_ptr() for t in (w, gs, *ss)] == ptrs
    uk.update_plain(kind, nslots, want[0], gs, want[1:1 + nslots],
                    want[-1] if wc is not None else None, lrb, wdb, hyp)
    got = [w, *ss] + ([wc] if wc is not None else [])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        if kind == "sgd":
            assert torch.equal(a, b)
        else:
            assert _ulps(a, b) <= 1
    pad = torch.ones(w.numel(), dtype=torch.bool, device=card)
    for segs in plan.buckets.values():
        for seg in segs:
            start = seg.row0 * uk.LANES
            pad[start:start + seg.size] = False
    for t in got:
        assert not bool(t.reshape(-1)[pad].any())


def test_update_kernel_refuses_what_it_does_not_take(card):
    """A CUDA slab of a dtype the kernel does not take, a slot count the
    kind does not have, or a misshapen slab raises: no third path."""
    from mxnet_tpu_torch.ops import update_kernel as uk

    lr = torch.full((1,), 0.1, device=card)
    g = torch.zeros((16, 128), device=card)
    for dtype in (torch.float16, torch.float64):
        w = torch.zeros((16, 128), dtype=dtype, device=card)
        with pytest.raises(ValueError, match="dtype"):
            uk.multi_tensor_update("sgd", 0, w, g, (), None, lr, lr,
                                   [1.0, -1.0, 0.0])
    w = torch.zeros((16, 128), device=card)
    with pytest.raises(ValueError, match="slots"):
        uk.multi_tensor_update("adam", 1, w, g, (w.clone(),), None, lr, lr,
                               [1.0, -1.0, 0.9, 0.999, 1e-8])
    with pytest.raises(ValueError, match="slab"):
        uk.multi_tensor_update("sgd", 0, torch.zeros((8, 128), device=card),
                               g[:8], (), None, lr, lr, [1.0, -1.0, 0.0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_step_plan_matches_per_param(card, dtype):
    """A small ResNet's train step on the card through the slab plan
    (kernel B1), held against the per-parameter update (the optimizer's
    ``update_multi``, the path a step takes where the plan declines) run
    on copies of the masters and the momentum from before the step, with
    the gradients the step packed: the masters, the momentum and the
    compute copy the next forward reads are bit for bit equal."""
    import numpy as np

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import update_kernel as uk

    sym = resnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                        filter_list=[8, 16, 32, 64, 128], num_classes=10,
                        image_shape=(3, 32, 32))
    b = 8
    shapes, _, aux_shapes = sym.infer_shape(data=(b, 3, 32, 32),
                                            softmax_label=(b,))
    rng = np.random.RandomState(0)
    args = {n: (rng.randn(*s) * 0.1 + (n.endswith("_gamma"))).astype(
        np.float32) for n, s in zip(sym.list_arguments(), shapes)
        if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if n.endswith("_var") else np.zeros(s)).astype(
        np.float32) for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    batch = DataBatch([mt.nd.array(rng.uniform(-1, 1, (b, 3, 32, 32)))],
                      [mt.nd.array(rng.randint(0, 10, b))])
    mod = mt.mod.Module(sym, context=mt.gpu(0), compute_dtype=dtype)
    mod.bind(data_shapes=[DataDesc("data", (b, 3, 32, 32))],
             label_shapes=[DataDesc("softmax_label", (b,))])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    step = mod._train_step
    assert step.plan is not None
    group = mod._exec_group
    idx = sorted(mod._updater.states)
    weights = [NDArray(group.param_arrays[i].data.clone()) for i in idx]
    states = [mod._updater.states[i].clone() for i in idx]
    # an optimizer made as init_optimizer made the module's
    opt = mt.optimizer.create("sgd", sym=sym, rescale_grad=1.0 / b,
                              param_idx2name=dict(enumerate(
                                  group.param_names)),
                              learning_rate=0.1, momentum=0.9, wd=1e-4)
    before = uk.LAUNCHES["multi_tensor_update"]
    mod.forward_backward(batch)
    mod.update()
    assert uk.UPDATE_PATH["last"] == "kernel"
    assert uk.LAUNCHES["multi_tensor_update"] - before == 1
    opt.update_multi(idx, weights, [group.grad_arrays[i] for i in idx],
                     states)
    torch.cuda.synchronize()
    for i, w, m in zip(idx, weights, states):
        name = group.param_names[i]
        assert torch.equal(group.param_arrays[i].data, w.data), name
        assert torch.equal(mod._updater.states[i], m), name
        want = w.data if dtype == "float32" else w.data.to(torch.bfloat16)
        assert torch.equal(step._views[name], want), name


# ---------------------------------------------------------------------------
# the serving programs as captured CUDA graphs (programs/graphs.py): a
# small int8 paged LM (2 layers, embed 128, 2 heads of 64, 16-token pages)
# ---------------------------------------------------------------------------

def _graph_lm(card, **kw):
    import numpy as np

    from mxnet_tpu_torch.decode import DecodePredictor
    from mxnet_tpu_torch.models import attention_lm

    sym = attention_lm.get_symbol(vocab_size=64, seq_len=64, num_layers=2,
                                  embed=128, heads=2, ffn_hidden=256)
    rng = np.random.RandomState(0)
    shapes, _, _ = sym.infer_shape(data=(1, 64), softmax_label=(1, 64))
    params = {n: rng.normal(0, 0.1, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    return DecodePredictor(sym, params, cache_len=64, device=card,
                           paged=True, kv_dtype="int8", page_tokens=16,
                           prefill_chunk=16, **kw)


def _graph_prompts():
    import numpy as np

    x = np.random.RandomState(1).randint(0, 64, (2, 40)).astype(np.float32)
    return x, np.array([23, 40])


def test_captured_paged_step_matches_eager_bitwise(card):
    """Prepared (captured) programs against a second predictor run under
    programs.eager() from the same state: prefill and 30 steps (across
    page boundaries, one row idle now and then) give bit-equal
    probabilities, tokens, lengths and pools (the scratch page aside,
    where idle rows' writes collide); each replay adds the launches its
    capture recorded, equal to the eager step's; the tables are shipped
    exactly when the manager changed them."""
    import numpy as np

    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.decode import _cache_leaves

    g, e = _graph_lm(card), _graph_lm(card)
    rep = g.prepare_programs(2)
    assert {r["source"] for r in rep["programs"].values()} == {"capture"}
    x, lens = _graph_prompts()
    gs, gp = g.prefill(x, lens)
    with programs.eager():
        es, ep = e.prefill(x, lens)
    assert torch.equal(gp, ep)
    counters = (fk.LAUNCHES, dk.LAUNCHES)
    lens_h = lens.astype(np.int64)
    for i in range(30):
        act = np.array([1, 0 if i % 7 == 3 else 1], np.int32)
        version, ships = g._manager.version, g._table_ships
        before = [dict(c) for c in counters]
        replays = programs.GRAPH_STATS["replays"]
        gs, gp = g.paged_step(gs, lens_h, active=act)
        gp = gp.clone()
        mid = [dict(c) for c in counters]
        with programs.eager():
            es, ep = e.paged_step(es, lens_h, active=act)
        torch.cuda.synchronize()
        after = [dict(c) for c in counters]
        assert torch.equal(gp, ep), i
        assert torch.equal(gs.tok, es.tok) and torch.equal(gs.lens, es.lens)
        assert programs.GRAPH_STATS["replays"] - replays == 1
        assert (g._table_ships - ships) == int(g._manager.version
                                                != version)
        for b, m, a in zip(before, mid, after):
            for k in b:
                assert m[k] - b[k] == a[k] - m[k], (i, k)
        assert mid[0]["fused_fwd"] - before[0]["fused_fwd"] == 10
        assert mid[1]["paged_decode"] - before[1]["paged_decode"] == 2
        assert mid[1]["paged_combine"] - before[1]["paged_combine"] == 2
        lens_h = lens_h + act
    for a, b in zip(_cache_leaves(gs.caches), _cache_leaves(es.caches)):
        assert torch.equal(a[1:], b[1:])
    assert g.trace_counts["decode"] == g.trace_counts["chunk"] == 1
    assert e.trace_counts["decode"] == 0


def test_captured_sampling_stays_in_top_k(card):
    """Temperature 1, top_k 8 through the captured chunk and decode
    programs with the predictor's seeded generator registered: every
    drawn token is among its row's 8 most probable, and the same seed
    draws the same tokens again (without a new capture)."""
    import numpy as np

    pred = _graph_lm(card, temperature=1.0, top_k=8)
    pred.prepare_programs(2)
    x, lens = _graph_prompts()
    st, probs = pred.prefill(x, lens, pred._sampling_generator(7))
    lens_h = lens.astype(np.int64)
    drawn = set()
    for _ in range(12):
        top = torch.topk(probs, 8, dim=-1).indices
        assert bool((top == st.tok.long()).any(dim=-1).all())
        drawn.update(st.tok.flatten().tolist())
        st, probs = pred.paged_step(st, lens_h, pred._gen)
        lens_h = lens_h + 1
    assert len(drawn) > 2
    traces = dict(pred.trace_counts)
    a = pred.generate(x, lens, max_new_tokens=10, seed=3)
    b = pred.generate(x, lens, max_new_tokens=10, seed=3)
    np.testing.assert_array_equal(a, b)
    assert pred.trace_counts == traces


def test_uncapturable_program_raises(card):
    """A body that syncs with the host (.item()) cannot be captured: the
    call raises (no eager stand-in), nothing is counted, and the card
    goes on working."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.programs import GraphProgram

    prog = GraphProgram("t_item", lambda x: x * float(x.sum().item()))
    x = torch.ones(4, device=card)
    with pytest.raises(MXNetError, match="capture failed"):
        prog(x)
    assert prog.traces == 0
    torch.cuda.synchronize()
    assert float((x + 1).sum()) == 8.0


def test_captured_paged_verify_matches_eager_bitwise(card):
    """The prepared (captured) verify program against a second predictor
    run under programs.eager() from the same state: prefill and 20
    verify steps with n-gram drafts (rows that would pass the ring sit
    out, inactive) give bit-equal emitted tokens, counts, window
    probabilities, tokens, lengths and pools (the scratch page aside);
    each replay adds the launches its capture recorded, equal to the
    eager step's: A 10 (2 layers x q, k, v, ffn1, ffn2 at M = 2 x 4),
    B 2 and the combine 2."""
    import numpy as np

    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.decode import NGramProposer, _cache_leaves

    k = 3
    g, e = _graph_lm(card), _graph_lm(card)
    rep = g.prepare_programs(2, spec_k=k)
    assert rep["programs"]["verify"]["source"] == "capture"
    x, lens = _graph_prompts()
    x, lens = x[:, :20], np.array([12, 20])
    gs, _ = g.prefill(x, lens)
    with programs.eager():
        es, _ = e.prefill(x, lens)
    hists = [list(x[r, :lens[r]].astype(np.int64)) + [int(gs.tok[r, 0])]
             for r in range(2)]
    proposer = NGramProposer(k)
    counters = (fk.LAUNCHES, dk.LAUNCHES)
    lens_h = lens.astype(np.int64)
    accepted = 0
    for i in range(20):
        act = (lens_h + k + 1 <= 64).astype(np.int32)
        drafts, _ = proposer.propose(hists)
        before = [dict(c) for c in counters]
        replays = programs.GRAPH_STATS["replays"]
        gs, out, counts = g.paged_verify(gs, lens_h, drafts, active=act)
        out, counts = out.clone(), counts.clone()
        probs = g.verify_probs.clone()
        mid = [dict(c) for c in counters]
        with programs.eager():
            es, eout, ecounts = e.paged_verify(es, lens_h, drafts,
                                               active=act)
        torch.cuda.synchronize()
        after = [dict(c) for c in counters]
        assert torch.equal(out, eout) and torch.equal(counts, ecounts), i
        assert torch.equal(probs, e.verify_probs), i
        assert torch.equal(gs.tok, es.tok) and torch.equal(gs.lens, es.lens)
        assert programs.GRAPH_STATS["replays"] - replays == 1
        for b, m, a in zip(before, mid, after):
            for key in b:
                assert m[key] - b[key] == a[key] - m[key], (i, key)
        assert mid[0]["fused_fwd"] - before[0]["fused_fwd"] == 10
        assert mid[1]["paged_decode"] - before[1]["paged_decode"] == 2
        assert mid[1]["paged_combine"] - before[1]["paged_combine"] == 2
        counts_h = counts.cpu().numpy().astype(np.int64)
        assert (counts_h[act == 0] == 0).all()
        for r in range(2):
            hists[r].extend(int(t) for t in out[r, :counts_h[r]])
        accepted += int(np.maximum(counts_h - 1, 0).sum())
        lens_h = lens_h + counts_h
    assert accepted > 0
    for a, b in zip(_cache_leaves(gs.caches), _cache_leaves(es.caches)):
        assert torch.equal(a[1:], b[1:])
    assert g.trace_counts["verify"] == 1 and e.trace_counts["verify"] == 0


def test_speculative_server_matches_plain_server(card):
    """A paged int8 DecodeServer with spec_k 3 (n-gram drafts) returns
    the non-speculative server's greedy tokens for every request, with
    verify steps taken and the verify program captured once; the same
    serve under programs.eager() gives the same tokens."""
    import numpy as np

    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.decode import DecodeServer

    rng = np.random.RandomState(2)
    prefix = rng.randint(0, 64, 16)
    prompts = [np.concatenate([prefix, rng.randint(0, 64, n)])
               for n in (3, 9, 5)] + [rng.randint(0, 64, 12)]

    def serve(pred, spec_k):
        srv = DecodeServer(pred, 32, slots=2, max_new_tokens=12,
                           spec_k=spec_k)
        for p in prompts:
            srv.submit(p)
        return srv.run(), srv

    want, _ = serve(_graph_lm(card), 0)
    spec = _graph_lm(card)
    spec.prepare_programs(2, spec_k=3)
    got, srv = serve(spec, 3)
    with programs.eager():
        eager, _ = serve(spec, 3)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        np.testing.assert_array_equal(eager[rid], want[rid])
    assert srv.spec_steps > 0 and srv.proposed > 0
    assert spec.trace_counts["verify"] == 1


def test_captured_sampled_verify_repeats_per_seed(card):
    """Temperature 1, top_k 8 through the captured verify program with
    the predictor's generator registered: every emitted token lies in
    the top 8 of its window row's probabilities (accepted drafts and
    the drawn token alike), and the same seed emits the same tokens
    again without a new capture."""
    import numpy as np

    pred = _graph_lm(card, temperature=1.0, top_k=8)
    pred.prepare_programs(2, spec_k=3)
    x, lens = _graph_prompts()

    def run(seed):
        gen = pred._sampling_generator(seed)
        st, _ = pred.prefill(x, lens, gen)
        lens_h = lens.astype(np.int64)
        rng = np.random.RandomState(0)
        emitted = []
        for _ in range(5):
            drafts = rng.randint(0, 64, (2, 3)).astype(np.int32)
            drafts[:, 0] = st.tok[:, 0].cpu().numpy()
            st, out, counts = pred.paged_verify(st, lens_h, drafts, None,
                                                gen)
            top = torch.topk(pred.verify_probs, 8, dim=-1).indices
            for r in range(2):
                c = int(counts[r])
                for i in range(c):
                    assert int(out[r, i]) in top[r, i].tolist()
                emitted.append(out[r, :c].cpu().numpy().copy())
            lens_h = lens_h + counts.cpu().numpy()
        return emitted

    a = run(7)
    traces = dict(pred.trace_counts)
    b = run(7)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    assert pred.trace_counts == traces and traces["verify"] == 1


# ---------------------------------------------------------------------------
# the bucketed LSTM language model (models/lstm_lm.py, BucketingModule):
# the fused RNN op on cuDNN against the unfused cell stack, and every
# bucket training through the one slab plan (kernel B1)
# ---------------------------------------------------------------------------

@pytest.fixture
def full_f32():
    """Full f32 products and cuDNN calls (no TF32) for the test."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _rnn_fused_and_unfused(card, n, t, i, h, layers, seed=0):
    """Outputs, final states and gradients (data, the flat blob) of the
    fused LSTM graph and of the unfused LSTMCell stack carrying
    ``unpack_weights`` of the same blob, both seeded with ones at every
    output on the card."""
    import numpy as np

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.executor import simple_bind

    fused = mt.rnn.FusedRNNCell(h, num_layers=layers, mode="lstm",
                                prefix="lstm_", get_next_state=True)
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, t, i)).astype(np.float32)
    runs = []
    for cell in (fused, fused.unfuse()):
        out, states = cell.unroll(t, inputs=mt.sym.Variable("data"),
                                  layout="NTC", merge_outputs=True)
        exe = simple_bind(mt.sym.Group([out] + states), card,
                          data=(n, t, i))
        if cell is fused:
            blob = rng.uniform(-0.3, 0.3, exe.arg_dict[
                "lstm_parameters"].shape).astype(np.float32)
            values = {"lstm_parameters": blob}
        else:
            values = fused.unpack_weights({"lstm_parameters": blob},
                                          input_size=i)
        values["data"] = x
        for name, v in values.items():
            exe.arg_dict[name][:] = v
        outs = exe.forward(is_train=True)
        exe.backward()
        grads = {k: g.asnumpy() for k, g in exe.grad_dict.items()}
        if cell is not fused:
            grads["lstm_parameters"] = fused.pack_weights(
                {k: v for k, v in grads.items() if k != "data"},
                input_size=i)["lstm_parameters"]
        runs.append(([o.asnumpy() for o in outs], grads))
    (f_outs, f_grads), (u_outs, u_grads) = runs
    # the fused states are (layers, n, h); the unfused h0, c0, h1, c1
    u_states = [np.stack(u_outs[1::2][:layers]),
                np.stack(u_outs[2::2][:layers])]
    return f_outs, [u_outs[0]] + u_states, f_grads, u_grads


@pytest.mark.parametrize("n,t,i,h", [(4, 7, 8, 6), (3, 12, 16, 32)])
def test_fused_rnn_on_the_card_matches_unfused_cells(card, full_f32, n, t,
                                                     i, h):
    """The RNN op (cuDNN) against the unfused LSTMCell graph (cuBLAS and
    torch element-wise ops) from one blob: outputs and final states 1e-5
    absolute, the data's and the blob's gradients 1e-4 relative to their
    largest magnitude."""
    import numpy as np

    f_outs, u_outs, f_grads, u_grads = _rnn_fused_and_unfused(
        card, n, t, i, h, layers=2)
    assert [o.shape for o in f_outs] == [(n, t, h), (2, n, h), (2, n, h)]
    for a, b in zip(f_outs, u_outs):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for name in ("data", "lstm_parameters"):
        scale = float(np.abs(u_grads[name]).max())
        assert float(np.abs(f_grads[name] - u_grads[name]).max()) \
            <= 1e-4 * scale, name


def test_bucketed_lstm_trains_through_one_slab(card, full_f32,
                                              monkeypatch):
    """A small unfused LSTM LM through BucketingModule on the card (two
    buckets): every bucket's parameters and gradients are the primary's
    slab views (equal data_ptr), no bucket is demoted, kernel B1
    launches once a step, each launch equals its plain version on
    copies of the slabs within one f32 ulp, and the first Adam update
    lands where the per-parameter update (the optimizer's
    ``update_multi`` on copies, with the gradients the step packed)
    does.  That update rounds 1 - beta1 and 1 - beta2 from f64 constants
    (the JAX package's eager ``adam_update``), the kernel in f32 (its
    fused step), so the second moment differs by up to 5e-5 relative:
    each element within 1e-4 of its tensor's change, or one ulp (a
    weight near 1 whose change is 1e-3 rounds at 2^-23)."""
    import numpy as np

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.models import lstm_lm
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import update_kernel as uk

    vocab, batch = 50, 4
    sym_gen, _ = lstm_lm.sym_gen_factory(16, 2, 16, vocab, fused=False,
                                         ignore_label=-1)
    rng = np.random.RandomState(0)
    sents = [rng.randint(1, vocab, size=rng.randint(2, 9)).tolist()
             for _ in range(48)]
    it = mt.rnn.BucketSentenceIter(sents, batch, buckets=[4, 8], seed=0)
    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                 context=mt.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(initializer=mt.initializer.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.01})
    primary = mod._primary
    step = primary._train_step
    assert step.plan is not None and step.plan.kind == "adam"
    group = primary._exec_group
    idx = sorted(primary._updater.states)
    before_w = [group.param_arrays[i].data.clone() for i in idx]
    weights = [NDArray(w.clone()) for w in before_w]
    states = [tuple(s.clone() for s in primary._updater.states[i])
              for i in idx]
    opt = mt.optimizer.create("adam", sym=primary.symbol,
                              rescale_grad=1.0 / batch,
                              param_idx2name=dict(enumerate(
                                  group.param_names)), learning_rate=0.01)
    real = uk.multi_tensor_update
    ulps = []

    def checked(kind, nslots, w, g, slots, wc, lrb, wdb, hyp, plain=False):
        ref = [w.clone()] + [t.clone() for t in slots]
        path = real(kind, nslots, w, g, slots, wc, lrb, wdb, hyp,
                    plain=plain)
        uk.update_plain(kind, nslots, ref[0], g, ref[1:], None, lrb, wdb,
                        hyp)
        ulps.append(max(_ulps(a, b) for a, b in zip([w, *slots], ref)))
        return path

    monkeypatch.setattr(uk, "multi_tensor_update", checked)
    batches = list(it)
    before = uk.LAUNCHES["multi_tensor_update"]
    # the checked step runs unrecorded: a Python check cannot run inside
    # a replay
    with programs.eager():
        mod.forward_backward(batches[0])
        mod.update()
    torch.cuda.synchronize()
    opt.update_multi(idx, weights, [group.grad_arrays[i] for i in idx],
                     states)
    for i, w0, w, s in zip(idx, before_w, weights, states):
        name = group.param_names[i]
        pairs = [(group.param_arrays[i].data, w.data, w0)] + [
            (a, b, torch.zeros_like(b))
            for a, b in zip(primary._updater.states[i], s)]
        for got, want, start in pairs:
            change = float((want - start).abs().max())
            ia = got.contiguous().view(torch.int32).long()
            ib = want.contiguous().view(torch.int32).long()
            dist = (torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
                    - torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)).abs()
            outside = ((got - want).abs() > 1e-4 * change) & (dist > 1)
            assert not bool(outside.any()), name
    # the rest through the captured programs, whose replays re-add the
    # launches and path markers their captures saw
    monkeypatch.setattr(uk, "multi_tensor_update", real)
    replays = programs.GRAPH_STATS["replays"]
    for b in batches[1:]:
        mod.forward_backward(b)
        mod.update()
    torch.cuda.synchronize()
    assert programs.GRAPH_STATS["replays"] - replays >= len(batches) - 3
    assert uk.LAUNCHES["multi_tensor_update"] - before == len(batches)
    assert uk.UPDATE_PATH["last"] == "kernel"
    assert ulps and max(ulps) <= 1
    assert set(mod._buckets) == {4, 8}
    views = step.plan.unpack_all(step._w)
    grads = step.plan.unpack_all(step._g)
    for module in mod._buckets.values():
        assert module._train_step is step
        exe = module._exec_group.exec_
        for name, view in views.items():
            assert exe.arg_dict[name].data.data_ptr() == view.data_ptr()
            assert exe.grad_dict[name].data.data_ptr() == \
                grads[name].data_ptr()


# ---------------------------------------------------------------------------
# the compiled train step (train_step.CompiledTrainStep): one CUDA graph a
# bucket executor, held against its body run under programs.eager()
# ---------------------------------------------------------------------------

def _lstm_bucketing(card, fused, vocab=60, batch=4):
    import numpy as np

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import lstm_lm

    sym_gen, _ = lstm_lm.sym_gen_factory(16, 2, 16, vocab, fused=fused,
                                         ignore_label=-1)
    rng = np.random.RandomState(1)
    sents = [rng.randint(1, vocab, size=rng.randint(2, 9)).tolist()
             for _ in range(40)]
    it = mt.rnn.BucketSentenceIter(sents, batch, buckets=[4, 8], seed=0)
    torch.manual_seed(0)
    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                 context=mt.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(initializer=mt.initializer.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.01})
    return mod, list(it)


@pytest.mark.parametrize("fused", [False, True])
def test_captured_train_step_matches_eager_bitwise(card, full_f32, fused):
    """The bucketed LSTM LM (unfused cells, or cuDNN's RNN op) trained
    through its captured step programs against the same steps under
    programs.eager() from the same start: the parameters, the Adam slots
    and the device-accumulated perplexity bit for bit; one capture a
    bucket, replays after; B1 once a step in both."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.ops import update_kernel as uk

    runs = []
    for eager in (False, True):
        mod, batches = _lstm_bucketing(card, fused)
        metric = mt.metric.Perplexity(ignore_label=-1)
        mod._bind_metric(metric)
        stats = dict(programs.GRAPH_STATS)
        launches = uk.LAUNCHES["multi_tensor_update"]
        for b in batches:
            if eager:
                with programs.eager():
                    mod.forward_backward(b)
            else:
                mod.forward_backward(b)
            mod.update()
            mod.update_metric(metric, b.label)
        torch.cuda.synchronize()
        step = mod._primary._train_step
        runs.append((
            {n: v.clone() for n, v in step.plan.unpack_all(step._w).items()},
            [t.clone() for t in step._slots["float32"]], metric.get()[1],
            {k: programs.GRAPH_STATS[k] - stats[k]
             for k in ("captures", "replays")},
            uk.LAUNCHES["multi_tensor_update"] - launches, len(batches),
            len(mod._buckets)))
    (w_c, s_c, m_c, st_c, l_c, n, buckets), \
        (w_e, s_e, m_e, st_e, l_e, _, _) = runs
    for name in w_e:
        assert torch.equal(w_c[name], w_e[name]), name
    assert all(torch.equal(a, b) for a, b in zip(s_c, s_e))
    assert m_c == m_e
    assert st_c == {"captures": buckets, "replays": n - buckets}
    assert st_e == {"captures": 0, "replays": 0}
    assert l_c == l_e == n


def test_bucket_graphs_share_one_pool(card, full_f32):
    """Every bucket's captured program belongs to the one store and
    captures into its one memory pool; a second pass over the batches
    captures nothing more."""
    from mxnet_tpu_torch import programs

    mod, batches = _lstm_bucketing(card, False)
    for b in batches:
        mod.forward_backward(b)
    step = mod._primary._train_step
    progs = [p for p, _ in step._fns.values()]
    assert len(progs) == len(mod._buckets) == 2
    assert all(p.pool is step._pool for p in progs)
    assert step._pool.handle() is not None
    assert all(m._train_step is step for m in mod._buckets.values())
    captures = programs.GRAPH_STATS["captures"]
    for b in batches:
        mod.forward_backward(b)
    assert programs.GRAPH_STATS["captures"] == captures
    assert step.trace_count == step.programs_built == 2


def _mlp_module(card, dropout):
    import numpy as np

    import mxnet_tpu_torch as mt

    s = mt.sym
    net = s.FullyConnected(s.Variable("data"), num_hidden=32, name="fc1")
    net = s.Activation(net, act_type="tanh", name="act")
    if dropout:
        net = s.Dropout(net, p=0.5, name="drop")
    net = s.SoftmaxOutput(s.FullyConnected(net, num_hidden=5, name="fc2"),
                          name="softmax")
    rng = np.random.RandomState(2)
    x = rng.randn(48, 16).astype(np.float32)
    y = rng.randint(0, 5, 48).astype(np.float32)
    shapes, _, _ = net.infer_shape(data=(8, 16), softmax_label=(8,))
    args = {n: (0.3 * rng.randn(*sh)).astype(np.float32)
            for n, sh in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    mod = mt.mod.Module(net, context=mt.gpu(0))
    return mod, mt.io.NDArrayIter(x, y, batch_size=8), args


def test_captured_dropout_draws_from_the_registered_generator(card,
                                                              full_f32):
    """Dropout's explicit generator (``Executor.generator``) rides the
    captured step as a registered generator: every replay draws a new
    mask, the same masks the eager steps draw from the same seed, so the
    two runs' parameters agree bit for bit."""
    from mxnet_tpu_torch import programs

    runs = []
    for eager in (False, True):
        mod, it, args = _mlp_module(card, dropout=True)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params=args)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        exe = mod._exec_group.exec_
        exe.generator = torch.Generator(device=card).manual_seed(7)
        for b in it:
            with programs.eager() if eager else contextlib.nullcontext():
                mod.forward_backward(b)
        torch.cuda.synchronize()
        runs.append({n: a.data.clone() for n, a in exe.arg_dict.items()
                     if n in args})
    assert all(torch.equal(runs[0][n], runs[1][n]) for n in runs[1])


def test_fit_feeds_the_step_through_device_prefetch(card, full_f32,
                                                   monkeypatch):
    """``Module.fit`` on the card wraps the iterator in a
    ``DevicePrefetchIter`` (pinned batches copied on a side stream the
    step waits on) and lands on the parameters of a fit without it
    (``MXNET_DEVICE_PREFETCH=0``), bit for bit; the metric is
    accumulated on the card."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import config, io

    taken = []
    real_next = io.DevicePrefetchIter.next

    def counted(self):
        batch = real_next(self)
        taken.append(batch.data[0].data.device.type)
        return batch

    monkeypatch.setattr(io.DevicePrefetchIter, "next", counted)
    runs = []
    for prefetch in (True, False):
        mod, it, args = _mlp_module(card, dropout=False)
        metric = mt.metric.Accuracy()
        with config.overrides(MXNET_DEVICE_PREFETCH=prefetch):
            mod.fit(it, eval_metric=metric, arg_params=args,
                    optimizer="sgd", num_epoch=2,
                    optimizer_params={"learning_rate": 0.1})
        assert mod._train_step._metric_acc.metric is metric
        runs.append(({n: v.asnumpy() for n, v in
                      mod.get_params()[0].items()}, metric.get()[1]))
    assert taken and set(taken) == {"cuda"} and len(taken) == 12
    (p1, m1), (p2, m2) = runs
    assert m1 == m2
    assert all((p1[n] == p2[n]).all() for n in p2)


# ---------------------------------------------------------------------------
# inference: the captured eval forward (train_step.CompiledForward) under
# Module.predict and Predictor, the monitor's handoff, Embedding's range
# ---------------------------------------------------------------------------

def _predict_lm(card, plain=False, batch=4):
    """A small attention LM (2 layers, embed 128, 2 heads of 64, T 64) as
    an inference Module on the card, its weights seeded, and 10
    sequences (the last batch padded by 2)."""
    import numpy as np

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import attention_lm

    sym = attention_lm.get_symbol(vocab_size=64, seq_len=64, num_layers=2,
                                  embed=128, heads=2, ffn_hidden=256)
    rng = np.random.RandomState(0)
    shapes, _, _ = sym.infer_shape(data=(batch, 64),
                                   softmax_label=(batch, 64))
    params = {n: rng.normal(0, 0.1, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    x = rng.randint(0, 64, (10, 64)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.full((10, 1), -1, np.float32)], 1)
    it = mt.io.NDArrayIter(x, y, batch_size=batch)
    mod = mt.mod.Module(sym, context=mt.gpu(0), plain=plain)
    mod.bind(it.provide_data, it.provide_label, for_training=False)
    mod.init_params(arg_params=params)
    return mod, it, sym, params


def test_captured_eval_forward_matches_eager_bitwise(card, full_f32):
    """``Module.predict`` through the captured inference forward against
    the same predict under programs.eager(): the merged outputs bit for
    bit, one capture then a replay a batch, and each batch launching
    kernels A (10: five fused linears a layer) and C (2) in both; the
    plain module within 1e-5."""
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.ops import flash_kernel as fl

    mod, it, _, _ = _predict_lm(card)
    counters = ((fk.LAUNCHES, "fused_fwd"), (fl.LAUNCHES, "flash_fwd"))
    runs = []
    for eager in (False, True):
        before = [d[k] for d, k in counters]
        stats = dict(programs.GRAPH_STATS)
        with programs.eager() if eager else contextlib.nullcontext():
            out = mod.predict(it).data.clone()
        torch.cuda.synchronize()
        runs.append((out, [d[k] - b for (d, k), b in zip(counters, before)],
                     {k: programs.GRAPH_STATS[k] - stats[k]
                      for k in ("captures", "replays")}))
    (cap, cap_l, cap_s), (eag, eag_l, eag_s) = runs
    assert torch.equal(cap, eag)
    assert cap_l == eag_l == [30, 6]
    assert cap_s == {"captures": 1, "replays": 2}
    assert eag_s == {"captures": 0, "replays": 0}
    pmod, pit, _, _ = _predict_lm(card, plain=True)
    _card_close(cap, pmod.predict(pit).data, 1e-5)


def test_predictor_reshape_round_trip_captures_once(card):
    """A card Predictor reshaped to batch 2 and back to 4: the way back
    reuses the first executor and its captured forward (no new capture)
    and gives the first forward's outputs bit for bit."""
    import numpy as np

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import programs

    _, _, sym, params = _predict_lm(card)
    shapes = {"data": (4, 64), "softmax_label": (4, 64)}
    x = np.random.RandomState(3).randint(0, 64, (4, 64))
    pred = mt.Predictor(sym, params, shapes, ctx=mt.gpu(0))
    first = pred.forward(data=x)[0].data.clone()
    small = pred.reshape({"data": (2, 64), "softmax_label": (2, 64)})
    two = small.forward(data=x[:2])[0].data
    captures = programs.GRAPH_STATS["captures"]
    back = small.reshape(shapes)
    again = back.forward(data=x)[0].data
    torch.cuda.synchronize()
    assert programs.GRAPH_STATS["captures"] == captures
    assert back._exec is pred._exec
    assert torch.equal(again, first)
    _card_close(two, first[:128], 1e-5)


def test_install_monitor_hands_the_slots_to_the_eager_update(card,
                                                            full_f32):
    """Two compiled SGD-momentum steps, ``install_monitor``, two more
    (eager, monitored) steps: the parameters equal a module that took
    all four steps eagerly (the momentum carried over), and the monitor
    collected on the card."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import config

    runs = []
    for compiled in (True, False):
        mod, it, args = _mlp_module(card, dropout=False)
        with config.overrides(MXNET_FUSED_TRAIN_STEP=compiled):
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params(arg_params=args)
            mod.init_optimizer(optimizer="sgd", optimizer_params={
                "learning_rate": 0.1, "momentum": 0.9})
        assert (mod._train_step is not None) == compiled
        mon = mt.monitor.Monitor(1, pattern=".*output")
        records = []
        for i, b in enumerate(it):
            if i == 4:
                break
            if i == 2:
                mod.install_monitor(mon)
                assert mod._train_step is None
            if i >= 2:
                mon.tic()
            mod.forward_backward(b)
            mod.update()
            if i >= 2:
                records += mon.toc()
        torch.cuda.synchronize()
        runs.append(({n: v.data.clone() for n, v in
                      mod.get_params()[0].items()}, records))
    (p1, r1), (p2, r2) = runs
    for n in p2:
        _card_close(p1[n], p2[n], 1e-5)
    assert [r[:2] for r in r1] == [r[:2] for r in r2] and len(r1) >= 8


def test_out_of_range_prompt_serves_without_a_device_assert(card):
    """A prompt holding ids ``vocab``, ``vocab + 2`` and ``-vocab - 1``
    through a captured paged DecodeServer: no device assert (the card
    stays usable), and the tokens of the same prompt with the ids the
    reference's gather takes (clamped)."""
    import numpy as np

    from mxnet_tpu_torch.decode import DecodeServer

    prompt = np.random.RandomState(4).randint(0, 64, 12)
    bad, clamped = prompt.copy(), prompt.copy()
    bad[[1, 4, 7]] = [64, 66, -65]
    clamped[[1, 4, 7]] = [63, 63, 0]
    pred = _graph_lm(card)
    pred.prepare_programs(2)
    srv = DecodeServer(pred, 32, slots=2, max_new_tokens=8)
    rids = [srv.submit(bad), srv.submit(clamped)]
    out = srv.run()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out[rids[0]], out[rids[1]])
    assert len(out[rids[0]]) == 8


# ---------------------------------------------------------------------------
# the image-classification zoo on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net,batch,image,cdtype", [
    ("inception_v3", 32, (3, 299, 299), torch.bfloat16),
    ("alexnet", 256, (3, 224, 224), None)])
def test_update_kernel_over_the_zoo_slabs(card, net, batch, image, cdtype):
    """B1's SGD-momentum over Inception-v3's slab (284 tensors, most of
    them BatchNorm vectors, f32 masters with the bf16 copy) and
    AlexNet's (16 tensors, 50,844,008 values, f32): bit for bit against
    its plain version, padding lanes still 0."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import update_kernel as uk

    sym = getattr(mt.models, "get_" + net)(num_classes=1000)
    shapes, _, _ = sym.infer_shape(data=(batch,) + image,
                                   softmax_label=(batch,))
    metas = {n: torch.empty(s, device="meta")
             for n, s in zip(sym.list_arguments(), shapes)
             if n not in ("data", "softmax_label")}
    plan = uk.UpdatePlan("sgd", 1, uk._segments_for(metas), cdtype)
    (bk,) = plan.buckets
    rows = plan.rows(bk)
    live = torch.zeros(rows * uk.LANES, dtype=torch.bool, device=card)
    for s in plan.buckets[bk]:
        live[s.row0 * uk.LANES:s.row0 * uk.LANES + s.size] = True
    live = live.view(rows, uk.LANES)
    g = torch.Generator(device=card).manual_seed(5)

    def slab(scale):
        t = torch.randn((rows, uk.LANES), generator=g, device=card) * scale
        return torch.where(live, t, 0.0)

    w, grad, mom = slab(1.0), slab(1.0), slab(0.01)
    wc = w.to(cdtype) if cdtype is not None else None
    segs = plan.buckets[bk]
    lrb, wdb = plan.lr_wd_blocks(
        {s.name: 0.1 * (1 + i % 4) for i, s in enumerate(segs)},
        {s.name: 1e-4 * (i % 2) for i, s in enumerate(segs)})
    lrb = torch.from_numpy(lrb[bk]).to(card)
    wdb = torch.from_numpy(wdb[bk]).to(card)
    want = [w.clone(), mom.clone()] + ([wc.clone()] if wc is not None
                                       else [])
    hyp = [1.0 / batch, -1.0, 0.9]
    assert uk.multi_tensor_update("sgd", 1, w, grad, (mom,), wc, lrb, wdb,
                                  hyp) == "kernel"
    uk.update_plain("sgd", 1, want[0], grad, (want[1],),
                    want[2] if wc is not None else None, lrb, wdb, hyp)
    torch.cuda.synchronize()
    got = [w, mom] + ([wc] if wc is not None else [])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(bool(t[~live].any()) for t in got)
    assert len(segs) == len(metas)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -7)])
def test_lrn_on_the_card_matches_the_cpu(card, dtype, tol):
    """LRN's output and input gradient on the card against the CPU's, in
    the input's dtype: f32 within 1e-5 of the largest magnitude, bf16
    within one bf16 rounding (2^-7)."""
    from mxnet_tpu_torch.registry import OpContext, get_op

    op = get_op("LRN")
    attrs = op.parse_attrs({"nsize": "5", "alpha": "0.0001",
                            "beta": "0.75", "knorm": "2"})
    g = torch.Generator(device="cpu").manual_seed(1)
    x = (4 * torch.randn(3, 17, 9, 11, generator=g)).abs().to(dtype)
    dy = torch.randn(3, 17, 9, 11, generator=g).to(dtype)
    runs = []
    for dev in (card, torch.device("cpu")):
        leaf = x.to(dev).requires_grad_(True)
        (y,), _ = op.fcompute(attrs, [leaf], [], OpContext())
        (dx,) = torch.autograd.grad(y, leaf, dy.to(dev))
        assert y.dtype == dx.dtype == dtype
        runs.append((y.detach().float().cpu(), dx.float().cpu()))
    for a, b in zip(*runs):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def _zoo_small(card, name, image, seed=0):
    """A small zoo Module on the card (batch 4, 10 classes, the slab plan
    armed), its seeded parameters and one resident batch."""
    import numpy as np

    import mxnet_tpu_torch as mt

    with mt.NameManager():
        sym = getattr(mt.models, "get_" + name)(num_classes=10)
    shape = (4,) + image
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape,
                                                softmax_label=(4,))
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        args[n] = (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
                   if n.endswith("_weight") else
                   np.ones(s) if n.endswith("_gamma")
                   else np.zeros(s)).astype(np.float32)
    aux = {n: (np.ones(s) if n.endswith("_var") else np.zeros(s))
           .astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    batch = mt.io.DataBatch(
        [mt.nd.array(rng.uniform(-1, 1, shape).astype(np.float32))],
        [mt.nd.array(rng.randint(0, 10, 4).astype(np.float32))])
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    assert mod._train_step.plan is not None
    mod._exec_group.exec_.generator = \
        torch.Generator(device=card).manual_seed(9)
    return mod, batch


@pytest.mark.parametrize("name,image", [("inception_bn", (3, 64, 64)),
                                        ("alexnet", (3, 67, 67))])
def test_captured_zoo_step_matches_eager_bitwise(card, full_f32, name,
                                                 image):
    """Inception-BN and AlexNet (LRN, two Dropouts from the executor's
    seeded generator) at a small size: 3 captured steps against the same
    steps under programs.eager() with cuDNN's deterministic algorithms:
    masters, momentum and moving statistics bit for bit; one capture,
    replays after, B1 once a step."""
    from mxnet_tpu_torch import programs
    from mxnet_tpu_torch.ops import update_kernel as uk

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for eager in (False, True):
            mod, batch = _zoo_small(card, name, image)
            stats = dict(programs.GRAPH_STATS)
            launches = uk.LAUNCHES["multi_tensor_update"]
            with programs.eager() if eager else contextlib.nullcontext():
                for _ in range(3):
                    mod.forward_backward(batch)
            torch.cuda.synchronize()
            exe = mod._exec_group.exec_
            state = {n: a.data.clone() for n, a in exe.arg_dict.items()
                     if n in mod._exec_group.param_names}
            state.update({"aux:" + n: a.data.clone()
                          for n, a in exe.aux_dict.items()})
            state.update({"mom:%d" % i: s.clone()
                          for i, s in mod._updater.states.items()})
            runs.append((state, {k: programs.GRAPH_STATS[k] - stats[k]
                                 for k in ("captures", "replays")},
                         uk.LAUNCHES["multi_tensor_update"] - launches))
    finally:
        torch.backends.cudnn.deterministic = saved
    (c, st_c, l_c), (e, st_e, l_e) = runs
    assert all(torch.equal(c[k], e[k]) for k in e), \
        [k for k in e if not torch.equal(c[k], e[k])][:5]
    assert st_c == {"captures": 1, "replays": 2}
    assert st_e == {"captures": 0, "replays": 0}
    assert l_c == l_e == 3


def test_mnist_drive_reaches_the_reference_accuracy(card):
    """The canonical drive on the card: MNISTIter's synthetic set, the
    MLP, one epoch of Module.fit with SGD-momentum through B1 (one launch
    a step), then score: accuracy at least 0.99 (the JAX package's drive
    reaches 1.0 on the CPU)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import update_kernel as uk

    train = mt.io.MNISTIter(batch_size=100, seed=0, flat=True, silent=True)
    val = mt.io.MNISTIter(batch_size=100, seed=1, flat=True, silent=True)
    torch.manual_seed(0)
    mod = mt.mod.Module(mt.models.get_mlp(num_classes=10),
                        context=mt.gpu(0))
    before = uk.LAUNCHES["multi_tensor_update"]
    mod.fit(train, eval_data=val, initializer=mt.initializer.Xavier(),
            optimizer="sgd", optimizer_params={
                "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
            num_epoch=1)
    torch.cuda.synchronize()
    assert uk.LAUNCHES["multi_tensor_update"] - before == 60
    assert uk.UPDATE_PATH["last"] == "kernel"
    assert dict(mod.score(val, "acc"))["accuracy"] >= 0.99


# ---------------------------------------------------------------------------
# the imperative front end: every op of the slice, the samplers and the
# small LM through nd + autograd, card against CPU
# ---------------------------------------------------------------------------

def _card_vs_cpu(card, table):
    """Every case of ``table`` run on the card and on the CPU; the cases
    whose outputs or gradients differ by more than 1e-5 of the CPU's
    largest magnitude (f32, TF32 off), or whose dtypes differ."""
    import mxnet_tpu_torch as mt
    from test_torch_op_cases import run_port

    bad = []
    for name, (op, arrays, attrs, grad) in sorted(table.items()):
        runs = [run_port(op, arrays, attrs, grad, ctx)
                for ctx in (mt.gpu(card.index or 0), mt.cpu())]
        (outs, grads), (c_outs, c_grads) = runs
        for got, want in zip(outs + grads, c_outs + c_grads):
            mag = max(1.0, float(np.nanmax(np.abs(want))) if want.size
                      else 1.0)
            err = float(np.nanmax(np.abs(got.astype(np.float64) - want)))\
                if want.size else 0.0
            if got.dtype != want.dtype or not err <= 1e-5 * mag \
                    or not np.array_equal(np.isnan(got), np.isnan(want)):
                bad.append((name, got.dtype, want.dtype, err))
    return bad


@pytest.mark.parametrize("group", ["ELEMWISE", "TENSOR", "NN", "CONTRIB",
                                   "SPATIAL"])
def test_slice_ops_on_the_card_match_the_cpu(card, full_f32, group):
    """Forward and gradients of every op case on the card against the
    CPU (the same port ops: ATen's CUDA and CPU loops, cuBLAS / cuDNN;
    count_sketch's and the samplers' gather backward add with atomics,
    within the same 1e-5)."""
    import test_torch_op_cases as cases

    assert _card_vs_cpu(card, getattr(cases, group)) == []


def test_samplers_on_the_card_repeat_and_match_the_cpu(card):
    """Each sampler on the card repeats its draws after ``seed`` and
    agrees with the CPU's draws in mean and variance (20,000 each, 6
    standard errors of the difference)."""
    import mxnet_tpu_torch as mt
    from test_torch_op_cases import SAMPLERS, draw_port

    n = 20000
    for op, (attrs, params) in sorted(SAMPLERS.items()):
        got = draw_port(op, attrs, params, n, 3, mt.gpu(card.index or 0))
        again = draw_port(op, attrs, params, n, 3, mt.gpu(card.index or 0))
        want = draw_port(op, attrs, params, n, 3, mt.cpu())
        assert np.array_equal(got, again), op
        for g, w in zip(got, want):
            se = np.sqrt((g.var() + w.var()) / n)
            assert abs(g.mean() - w.mean()) <= 6 * se, op


def test_load_lands_on_the_card_with_no_scope(card, full_f32, tmp_path):
    """``nd.load`` with no ``with ctx:`` scope reads onto the card, as
    ``nd.array`` does, so ops on what it read run there; under
    ``with mt.cpu():`` it reads onto the host, and the checkpoint reader
    names the host whatever the scope."""
    import mxnet_tpu_torch as mt

    w = np.random.RandomState(5).randn(4, 4).astype(np.float32)
    fname = str(tmp_path / "p-0000.params")
    mt.nd.save(fname, {"arg:w": w})
    got = mt.nd.load(fname)["arg:w"]
    assert got.data.device == card and got.context == mt.current_context()
    prod = mt.nd.dot(got, got)
    assert prod.data.device == card
    np.testing.assert_allclose(prod.asnumpy(), w @ w, rtol=1e-5, atol=1e-5)
    with mt.cpu():
        assert mt.nd.load(fname)["arg:w"].context == mt.cpu()
    mt.sym.Variable("w").save(str(tmp_path / "p-symbol.json"))
    _, args, _ = mt.model.load_checkpoint(str(tmp_path / "p"), 0)
    assert args["w"].context == mt.cpu()


def test_imperative_lm_on_the_card_matches_the_cpu(card, full_f32):
    """The LM as nd calls under autograd.record() on the card (kernels A,
    F, C, D, E) against the same step on the CPU (their plain versions):
    the probabilities within 1e-4 relative, every gradient within 1e-4
    norm-wise (the kernels sum in another order), and one kernel launch
    a segment (A, F) and a layer (C, D, E)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import flash_kernel as fl
    from mxnet_tpu_torch.models.attention_lm import imperative_lm

    b, t, vocab, embed, heads, ffn, layers = 2, 128, 64, 128, 2, 256, 2
    sym = mt.models.attention_lm.get_symbol(
        vocab_size=vocab, seq_len=t, num_layers=layers, embed=embed,
        heads=heads, ffn_hidden=ffn)
    shapes, _, _ = sym.infer_shape(data=(b, t), softmax_label=(b, t))
    rng = np.random.RandomState(2)
    params = {n: (1.0 + 0.1 * rng.randn(*s) if n.endswith("_gamma")
                  else 0.08 * rng.randn(*s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    x = rng.randint(0, vocab, (b, t)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.full((b, 1), -1, np.float32)], 1)
    runs = []
    for ctx in (mt.gpu(card.index or 0), mt.cpu()):
        with ctx:
            p = {k: mt.nd.array(v) for k, v in params.items()}
            g = {k: mt.nd.zeros(v.shape) for k, v in params.items()}
            mt.autograd._st().variables.clear()
            mt.autograd.mark_variables([p[k] for k in sorted(p)],
                                       [g[k] for k in sorted(p)])
            before = (fk.LAUNCHES["fused_fwd"], fk.LAUNCHES["fused_bwd"],
                      fl.LAUNCHES["flash_fwd"], fl.LAUNCHES["flash_bwd_dq"],
                      fl.LAUNCHES["flash_bwd_dkv"])
            with mt.autograd.record():
                out = imperative_lm(mt.nd, p, mt.nd.array(x),
                                    mt.nd.array(y), layers, embed, heads,
                                    ffn, vocab)
            mt.autograd.backward([out])
            launched = tuple(a - c for a, c in zip(
                (fk.LAUNCHES["fused_fwd"], fk.LAUNCHES["fused_bwd"],
                 fl.LAUNCHES["flash_fwd"], fl.LAUNCHES["flash_bwd_dq"],
                 fl.LAUNCHES["flash_bwd_dkv"]), before))
            mt.autograd._st().variables.clear()
            runs.append((out.asnumpy(), {k: v.asnumpy()
                                         for k, v in g.items()}, launched))
    (out, grads, launched), (c_out, c_grads, c_launched) = runs
    assert launched == (5 * layers, 5 * layers, layers, layers, layers)
    assert c_launched == (0, 0, 0, 0, 0)
    np.testing.assert_allclose(out, c_out, rtol=1e-4, atol=1e-6)
    for k, want in c_grads.items():
        # the analytically-zero *_k_bias gradient on its *_q_bias's norm
        ref = c_grads[k[:-len("_k_bias")] + "_q_bias"] \
            if k.endswith("_k_bias") else want
        err = np.linalg.norm(grads[k] - want) / np.linalg.norm(ref)
        assert err <= 1e-4, (k, err)


def _ssd_module(ctx, batch_shape, label_shape, args):
    import mxnet_tpu_torch as mt

    mod = mt.mod.Module(mt.models.ssd.get_symbol(), data_names=("data",),
                        label_names=("label",), context=ctx)
    mod.bind(data_shapes=[mt.io.DataDesc("data", batch_shape)],
             label_shapes=[mt.io.DataDesc("label", label_shape)])
    mod.init_params(arg_params=args)
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 2e-3})
    return mod


def test_ssd_first_step_on_the_card_matches_the_cpu(card, full_f32,
                                                    tmp_path):
    """The SSD example's first Adam step (captured program: its eager
    warm-up run) on the card against the CPU from the same parameters and
    ImageDetIter batch: class targets exactly, the two losses (the class
    cross-entropy over the anchors not ignored and the smooth-L1 box
    loss) within 1e-5 relative, gradients within 1e-4 (heads, no ReLU
    behind them) and 1e-2 (behind a ReLU) of each tensor's norm, one B1
    launch."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import update_kernel as uk

    prefix = str(tmp_path / "shapes")
    mt.models.ssd.make_dataset(prefix, n=16)
    it = mt.image.ImageDetIter(batch_size=8, data_shape=(3, 32, 32),
                               path_imgrec=prefix + ".rec",
                               path_imgidx=prefix + ".idx", shuffle=True,
                               rand_mirror=True, label_name="label", seed=0)
    batch = it.next()
    shapes = (tuple(batch.data[0].shape), tuple(batch.label[0].shape))
    mt.random.seed(0)
    with mt.cpu():
        start = _ssd_module(mt.cpu(), *shapes, None)
    init = mt.initializer.Xavier()
    start.init_params(init, force_init=True)
    args = {k: v.asnumpy() for k, v in start.get_params()[0].items()}
    runs = []
    for ctx in (mt.gpu(card.index or 0), mt.cpu()):
        mod = _ssd_module(ctx, *shapes, args)
        before = uk.LAUNCHES["multi_tensor_update"]
        mod.forward_backward(batch)
        mod.update()
        launched = uk.LAUNCHES["multi_tensor_update"] - before
        group = mod._exec_group
        grads = {n: a.asnumpy() for n, a in zip(group.param_names,
                                                 group.grad_arrays)}
        runs.append(([o.asnumpy() for o in mod.get_outputs()], grads,
                     launched))
    (outs, grads, launched), (c_outs, c_grads, c_launched) = runs
    assert (launched, c_launched) == (1, 0)
    np.testing.assert_array_equal(outs[2], c_outs[2])

    def losses(o):
        keep = o[2] >= 0
        p = np.take_along_axis(o[0], np.maximum(o[2], 0).astype(np.int64)
                               [:, None], axis=1)[:, 0].astype(np.float64)
        ce = np.where(keep, -np.log(np.maximum(p, 1e-30)), 0.0)
        return np.array([ce.sum(), o[1].astype(np.float64).sum()])

    np.testing.assert_allclose(losses(outs), losses(c_outs), rtol=1e-5)
    for n, want in c_grads.items():
        err = np.linalg.norm(grads[n] - want) / max(np.linalg.norm(want),
                                                     1e-30)
        tol = 1e-4 if n.startswith(("cls_pred_", "loc_pred_")) else 1e-2
        assert err <= tol, (n, err)


def test_multibox_detection_replays_bitwise(card):
    """MultiBoxDetection (the suppression loop, sorts, gathers) captured
    in a GraphProgram and replayed on new inputs: bit for bit against
    the eager op on the card, and the eager op equal to the CPU's."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.programs import GraphProgram
    from mxnet_tpu_torch.registry import get_op, invoke
    from test_torch_op_cases import _det_inputs

    op = get_op("MultiBoxDetection")
    attrs = {"nms_threshold": 0.45, "nms_topk": 200}

    def det(*xs):
        return invoke(op, list(xs), attrs)[0][0]

    prog = GraphProgram("t_multibox_detection", det)
    for seed in (1, 2, 3):
        xs = [torch.from_numpy(a) for a in _det_inputs(seed, 4, 5, 1000)]
        on_card = [x.to(card) for x in xs]
        got = prog(*on_card).clone()
        want = det(*on_card)
        assert torch.equal(got, want), seed
        host = det(*xs)
        assert torch.equal(want.cpu(), host), seed
    assert prog.traces == 1


def test_custom_graph_trains_eagerly_on_the_card(card, full_f32, caplog):
    """A Custom node keeps a Module on the eager path on the card (a
    warning, no train step), its forward and backward running on the
    card; four SGD steps end where the same steps on the CPU end."""
    import logging

    import mxnet_tpu_torch as mt

    @mt.operator.register("card_scale2x")
    class Scale2Prop(mt.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Scale2(mt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    assert in_data[0].context == devices[-1]
                    self.assign(out_data[0], req[0], in_data[0] * 2.0)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * 2.0)
            return Scale2()

    sym = mt.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=8, name="fc1")
    net = sym.Custom(net, op_type="card_scale2x", name="c")
    net = sym.SoftmaxOutput(sym.FullyConnected(net, num_hidden=2,
                                               name="fc2"), name="softmax")
    rng = np.random.RandomState(0)
    x = rng.randn(10, 6).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    args = {"fc1_weight": rng.randn(8, 6).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rng.randn(2, 8).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(2, np.float32)}
    devices, params = [], []
    for ctx in (mt.gpu(card.index or 0), mt.cpu()):
        devices.append(ctx)
        mod = mt.mod.Module(net, context=ctx)
        mod.bind([mt.io.DataDesc("data", x.shape)],
                 [mt.io.DataDesc("softmax_label", y.shape)])
        mod.init_params(arg_params=args)
        with caplog.at_level(logging.WARNING):
            mod.init_optimizer(optimizer="sgd",
                               optimizer_params={"learning_rate": 0.5})
        assert mod._train_step is None
        batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                [mt.nd.array(y, ctx=mt.cpu())])
        for _ in range(4):
            mod.forward_backward(batch)
            mod.update()
        mod.forward(batch, is_train=False)
        params.append({k: v.asnumpy()
                       for k, v in mod.get_params()[0].items()})
    assert "compiled train step unavailable" in caplog.text
    for k in args:
        np.testing.assert_allclose(params[0][k], params[1][k], rtol=1e-5,
                                   atol=1e-6)

