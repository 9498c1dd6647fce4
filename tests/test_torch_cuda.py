"""The PyTorch port's CUDA kernels against their plain PyTorch versions,
on the card.  Every test is marked ``cuda`` and skips without a card;
the file imports nothing of JAX, so it runs where only PyTorch is
installed::

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Shapes are small and ragged on purpose (masked tile edges, both kernel-A
tile configurations, several kernel-B tq tiles, page sizes, head dims and
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 5, 3), (4, 33, 70), (67, 130, 65)])
def test_fused_kernel_matches_plain(card, dtype, m, k, n):
    g = torch.Generator(device="cpu").manual_seed(m * 1000 + k)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(card)

    x, w, r = rand(m, k).to(dtype), (rand(n, k) / k ** 0.5).to(dtype), \
        rand(m, n).to(dtype)
    scale, shift, bias = 1 + 0.1 * rand(k), 0.1 * rand(k), 0.1 * rand(n)
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
                                         (67, 64, 2), (193, 128, 1)])
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
    wo, wlse = fl.flash_plain_fwd(q, k, v, scale, causal, groups)
    _card_close(o, wo, CARD_TOL[dtype])
    _card_close(lse, wlse, 1e-5)
    # the backward from the same o / lse, so the check is D and E alone
    want = fl.flash_plain_bwd(q, k, v, o, lse, do, scale, causal, groups)
    for got, w in zip((dq, dk, dv), want):
        _card_close(got, w, CARD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 5, 3), (67, 130, 65), (256, 64, 96)])
def test_fused_bwd_kernel_matches_plain(card, dtype, m, k, n):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cpu").manual_seed(m * 7 + k)

    def rand(*shape):
        return torch.randn(*shape, generator=g).to(card)

    x, dy = rand(m, k).to(dtype), rand(m, n).to(dtype)
    w = (rand(n, k) / k ** 0.5).to(dtype)
    scale, shift = 1 + 0.1 * rand(k), 0.1 * rand(k)
    for relu in (True, False):
        before = fk.LAUNCHES["fused_bwd"]
        got = fk.fused_bwd(x, dy, scale, shift, w, relu)
        torch.cuda.synchronize()
        assert fk.LAUNCHES["fused_bwd"] == before + 1
        want = fk.fused_bwd_plain(x, dy, scale, shift, w, relu)
        tols = (CARD_TOL[dtype], 1e-5, 1e-5, 1e-5)
        for gv, wv, tol in zip(got, want, tols):
            _card_close(gv, wv, tol)


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
