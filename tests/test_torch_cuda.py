"""The PyTorch port's CUDA kernels against their plain PyTorch versions,
on the card.  Every test is marked ``cuda`` and skips without a card;
the file imports nothing of JAX, so it runs where only PyTorch is
installed::

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Shapes are small and ragged on purpose (masked tile edges, both kernel-A
tile configurations, several kernel-B tq tiles, page sizes, head dims and
pool dtypes); ``chip_smoke.py`` covers the serving shapes.  Tolerances:
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
