"""Kernel B of the PyTorch port (mxnet_tpu_torch.ops.decode_kernel) and
the cache ops around it, held against the JAX package's einsum decode
path (``MXNET_PALLAS_DECODE`` off: ``paged_gather`` + ``dequantize_kv`` +
``sdpa_decode``/``sdpa_verify``).

Inputs are numpy arrays from a seed, handed to both packages; quantized
pools are quantized once (by the JAX package) and the same bytes go to
both.  Tolerances: f32 pools rtol 1e-5 / atol 1e-6 (as
tests/test_pallas_decode.py:123); int8 and fp8 pools rtol 1e-4 /
atol 1e-5 (tests/test_pallas_decode.py:140): dequantized K/V reach
|x| ~ 3 where f32 rounding of the score sums is larger, and a K that
differs by one ulp before quantization can flip a quantization step.
On the CPU the wrappers run their plain version; the kernel itself is
held against it on the card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops import pallas_decode as jpd
from mxnet_tpu_torch.ops import attention as attn
from mxnet_tpu_torch.ops import decode_kernel as dk

torch.set_num_threads(1)

HEADS, HD = 4, 4
B = 2

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "int8": dict(rtol=1e-4, atol=1e-5),
       "float8_e4m3fn": dict(rtol=1e-4, atol=1e-5)}
_TORCH_DT = {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn,
             "float8_e5m2": torch.float8_e5m2}


def _t(a):
    """numpy (incl. ml_dtypes fp8) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name in _TORCH_DT and a.dtype.name != "int8":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            _TORCH_DT[a.dtype.name])
    return torch.from_numpy(np.array(a, copy=True))


def _pools(rng, pages, pt, kvh, dtype):
    """(jax pools, port pools) holding the same numbers."""
    e = kvh * HD
    k = rng.randn(pages, pt, e).astype(np.float32)
    v = rng.randn(pages, pt, e).astype(np.float32)
    if dtype == "float32":
        return (jnp.asarray(k), jnp.asarray(v)), (_t(k), _t(v))

    def q(x):
        flat = jattn.quantize_kv(jnp.asarray(x.reshape(1, pages * pt, e)),
                                 dtype, kvh)
        data = np.asarray(flat.data).reshape(pages, pt, e)
        scale = np.asarray(flat.scale).reshape(pages, pt, kvh)
        return (jattn.QuantKV(jnp.asarray(data), jnp.asarray(scale)),
                attn.QuantKV(_t(data), _t(scale)))

    (jk, tk), (jv, tv) = q(k), q(v)
    return (jk, jv), (tk, tv)


@pytest.mark.parametrize("dtype", ["float32", "int8", "float8_e4m3fn"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("tq", [1, 3, 4])
def test_paged_attend_matches_jax_einsum(tq, group, dtype):
    """Padded rows, an exactly-full view and a wrapped ring (every view
    slot live), with pages shared across slots and repeated in a slot."""
    rng = np.random.RandomState(tq * 10 + group)
    kvh = HEADS // group
    m, pt = 4, 4
    (jk, jv), (tk, tv) = _pools(rng, 1 + B * m, pt, kvh, dtype)
    table = np.array([[1, 2, 3, 4], [2, 5, 6, 5]], np.int32)
    q = rng.randn(B, tq, HEADS * HD).astype(np.float32)
    for lens in ([tq + 2, 9], [m * pt, m * pt + 7]):
        lens = np.asarray(lens, np.int32)
        got = attn.paged_attend(_t(q), tk, tv, _t(table), _t(lens),
                                num_heads=HEADS, num_kv_heads=kvh)
        assert attn.DECODE_PATH["last"] == "plain"
        want = jattn.paged_attend(jnp.asarray(q), jk, jv,
                                  jnp.asarray(table), jnp.asarray(lens),
                                  num_heads=HEADS, num_kv_heads=kvh)
        assert jattn.DECODE_PATH["last"] == "einsum"
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("group", [1, 2])
def test_cache_attend_dense_ring_matches_jax(group, dtype):
    """Dense (B, C, E) rings, C not a power of two, incl. wrap."""
    rng = np.random.RandomState(7 + group)
    kvh = HEADS // group
    c = 24
    (jk, jv), (tk, tv) = _pools(rng, B, c, kvh, dtype)
    for tq, lens in ((1, [4, c]), (3, [c + 9, c + 1])):
        q = rng.randn(B, tq, HEADS * HD).astype(np.float32)
        lens = np.asarray(lens, np.int32)
        got = attn.cache_attend(_t(q), tk, tv, _t(lens), num_heads=HEADS,
                                num_kv_heads=kvh)
        want = jattn.cache_attend(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                                  num_heads=HEADS, num_kv_heads=kvh)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn", "float8_e5m2"])
def test_quantize_kv_bit_identical(dtype):
    """Same float K/V -> the same quantized bytes and scales in both
    packages (round-half-even, f32 division)."""
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 5, 8) * 3).astype(np.float32)
    x[0, 1] = 0.0                       # an all-zero token: floor scale
    got = attn.quantize_kv(_t(x), _TORCH_DT[dtype], 2)
    want = jattn.quantize_kv(jnp.asarray(x), dtype, 2)
    np.testing.assert_array_equal(
        got.data.view(torch.uint8).numpy() if dtype != "int8"
        else got.data.numpy(),
        np.asarray(want.data).view(np.uint8) if dtype != "int8"
        else np.asarray(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        attn.dequantize_kv(got, 2).numpy(),
        np.asarray(jattn.dequantize_kv(want, 2)))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_paged_append_and_copy_match_jax(dtype):
    """Appends through page tables with an inactive row and a padded
    (``valid``) chunk land in the same pages and slots; a COW page copy
    duplicates both planes."""
    rng = np.random.RandomState(4)
    pages, pt, kvh = 9, 4, 2
    (jk, _), (tk, _) = _pools(rng, pages, pt, kvh, dtype)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    new = rng.randn(B, 6, kvh * HD).astype(np.float32)
    start = np.array([3, 14], np.int32)
    active = np.array([1, 1], np.int32)
    valid = np.array([6, 4], np.int32)
    got = attn.paged_append(tk, _t(table), _t(new), _t(start),
                            num_heads=kvh, active=_t(active),
                            valid=_t(valid))
    want = jattn.paged_append(jk, jnp.asarray(table), jnp.asarray(new),
                              jnp.asarray(start), num_heads=kvh,
                              active=jnp.asarray(active),
                              valid=jnp.asarray(valid))
    got = attn.paged_copy(got, 2, 7)
    want = jattn.paged_copy(want, 2, 7)
    gl = [got.data, got.scale] if dtype != "float32" else [got]
    wl = [want.data, want.scale] if dtype != "float32" else [want]
    for g, w in zip(gl, wl):
        # page 0 is scratch: masked writes land there in either order
        np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])


def test_cache_append_ring_wrap_matches_jax():
    rng = np.random.RandomState(5)
    c, e = 8, 8
    cache = rng.randn(B, c, e).astype(np.float32)
    for t, start in ((1, [3, 7]), (5, [6, 2]), (11, [0, 4])):
        new = rng.randn(B, t, e).astype(np.float32)
        got = attn.cache_append(_t(cache), _t(new), _t(np.int32(start)))
        want = jattn.cache_append(jnp.asarray(cache), jnp.asarray(new),
                                  jnp.asarray(start, jnp.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_num_splits_matches_jax():
    for m in (1, 2, 3, 6, 8, 12, 16, 128):
        assert dk._num_splits(m) == jpd._num_splits(m, cap=dk.MAX_SPLITS)


def _split_partials(q, kp, vp, table, lens, heads, kvh, s):
    """The kernel's arithmetic in plain torch: per split, the unnormalised
    (acc, max, sum) of the flash softmax over that split's view slots."""
    b, tq, e = q.shape
    hd = e // heads
    g = heads // kvh
    kv = attn.dequantize_kv(attn.paged_gather(kp, table), kvh)
    vv = attn.dequantize_kv(attn.paged_gather(vp, table), kvh)
    c = kv.shape[1]
    per = c // s
    acc = torch.zeros(b, heads, s, tq, hd)
    mx = torch.full((b, heads, s, tq), -torch.inf)
    sm = torch.zeros(b, heads, s, tq)
    for bi in range(b):
        for h in range(heads):
            qh = q[bi, :, h * hd:(h + 1) * hd]
            kh = kv[bi, :, (h // g) * hd:(h // g + 1) * hd]
            vh = vv[bi, :, (h // g) * hd:(h // g + 1) * hd]
            logits = (qh @ kh.t()) / np.sqrt(hd)
            limit = torch.clamp_max(int(lens[bi]) - (tq - 1)
                                    + torch.arange(tq), c)[:, None]
            logits = torch.where(torch.arange(c)[None, :] < limit, logits,
                                 -torch.inf)
            for si in range(s):
                part = logits[:, si * per:(si + 1) * per]
                m = part.amax(dim=1)
                safe = torch.where(m == -torch.inf, 0.0, m)
                p = torch.where(part == -torch.inf, 0.0,
                                torch.exp(part - safe[:, None]))
                mx[bi, h, si] = m
                sm[bi, h, si] = p.sum(dim=1)
                acc[bi, h, si] = p @ vh[si * per:(si + 1) * per]
    return acc, mx, sm


@pytest.mark.parametrize("tq", [1, 4])
def test_split_combine_reproduces_plain_version(tq):
    """Per-split partials (some splits wholly past the live window)
    combined by the wrapper's logsumexp reduction equal the plain
    version — the combine the card runs after the kernel."""
    rng = np.random.RandomState(6)
    kvh = 2
    m, pt = 8, 4
    _, (tk, tv) = _pools(rng, 1 + B * m, pt, kvh, "int8")
    table = _t(rng.randint(1, 1 + B * m, size=(B, m)).astype(np.int32))
    q = _t(rng.randn(B, tq, HEADS * HD).astype(np.float32))
    lens = _t(np.array([tq + 5, m * pt + 3], np.int32))
    s = dk._num_splits(m)
    assert s == 8
    acc, mx, sm = _split_partials(q, tk, tv, table, lens, HEADS, kvh, s)
    got = dk._combine(acc, mx, sm, torch.float32)
    want = dk.paged_plain(q, tk, tv, table, lens, HEADS, None, kvh)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_supported_keeps_correctness_checks_only():
    rng = np.random.RandomState(8)
    _, (tk, tv) = _pools(rng, 5, 16, 2, "int8")
    # page size 16 and any head dim pass: no TPU tile gate
    assert dk.supported((B, 1, HEADS * HD), tk, tv, (B, 2), HEADS,
                        num_kv_heads=2)
    # scale plane with the wrong head count is refused
    bad = attn.QuantKV(tk.data, tk.scale[..., :1])
    assert not dk.supported((B, 1, HEADS * HD), bad, tv, (B, 2), HEADS,
                            num_kv_heads=2)
    # pools narrower than H_kv * head_dim are refused
    assert not dk.supported((B, 1, HEADS * HD), tk, tv, (B, 2), HEADS)


def test_attend_raises_off_cpu_on_shapes_the_kernel_refuses():
    """Two paths only, kernel and plain version: off the CPU a shape
    ``supported`` refuses raises in paged_attend and cache_attend instead
    of running a plain path (``meta`` tensors stand in for the card's)."""
    rng = np.random.RandomState(9)
    _, (tk, tv) = _pools(rng, 5, 4, 2, "int8")

    def meta(p):
        return attn.QuantKV(p.data.to("meta"), p.scale.to("meta"))

    q = torch.zeros((B, 1, HEADS * HD), device="meta")
    lens = torch.ones((B,), dtype=torch.int32, device="meta")
    table = torch.zeros((B, 2), dtype=torch.int32, device="meta")
    ring = torch.zeros((B, 8, 2 * HD), device="meta")
    attn.DECODE_PATH["last"] = None
    # the pools are 2 kv-heads wide; no num_kv_heads claims 4
    with pytest.raises(ValueError, match="do not fit"):
        attn.paged_attend(q, meta(tk), meta(tv), table, lens,
                          num_heads=HEADS)
    with pytest.raises(ValueError, match="do not fit"):
        attn.cache_attend(q, ring, ring, lens, num_heads=HEADS)
    assert attn.DECODE_PATH["last"] is None
    # a shape the kernel takes reaches the device check
    with pytest.raises(ValueError, match="unsupported device"):
        attn.paged_attend(q, meta(tk), meta(tv), table, lens,
                          num_heads=HEADS, num_kv_heads=2)
