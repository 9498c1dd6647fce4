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


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16,
                                        torch.int8, torch.float8_e4m3fn,
                                        torch.float8_e5m2])
@pytest.mark.parametrize("tq,pt,hd,group", [(1, 16, 256, 1),
                                            (3, 4, 16, 2),
                                            (37, 16, 64, 2),
                                            (256, 16, 256, 1)])
def test_paged_kernel_matches_plain(card, pool_dtype, tq, pt, hd, group):
    g = torch.Generator(device="cpu").manual_seed(tq + pt + hd)
    heads, m = 4, 8
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
    assert fl.LAST_VARIANT == {"flash_fwd": variant,
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
    """C and E own their output tiles and sum in a fixed order (no
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
        dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, delta, hd ** -0.5, True,
                                  groups)
        runs.append((o, lse, dk, dv))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_kernels_take_unaligned_views(card):
    """A view whose data is not 16-byte aligned is copied before the
    16-byte loads of C and E (never a plain fallback)."""
    from mxnet_tpu_torch.ops import flash_kernel as fl

    g = torch.Generator(device="cpu").manual_seed(6)
    n = 2 * 70 * 64
    base = torch.randn(4 * n + 1, generator=g).to(torch.bfloat16).to(card)
    q, k, v, do = (base[1 + i * n:1 + (i + 1) * n].view(2, 70, 64)
                   for i in range(4))
    assert q.data_ptr() % 16 != 0
    before = dict(fl.LAUNCHES)
    o, lse = fl.flash_fwd(q, k, v, 0.125, True)
    dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, fl.flash_delta(o, do),
                              0.125, True)
    torch.cuda.synchronize()
    assert fl.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert fl.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    wo, wlse = fl.flash_plain_fwd(q, k, v, 0.125, True)
    _card_close(o, wo, CARD_TOL[torch.bfloat16])
    _, wdk, wdv = fl.flash_plain_bwd(q, k, v, o, lse, do, 0.125, True)
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
