"""Kernels C, D and E of the PyTorch port (mxnet_tpu_torch.ops.
flash_kernel): their plain versions held against the JAX package's
flash-attention Pallas kernels, run in Pallas's interpreter.

* ``flash_plain_fwd`` vs ``pallas_attention._fwd_call(with_lse=True)``:
  o and lse;
* ``flash_plain_bwd`` vs ``jax.vjp`` of ``pallas_attention.
  flash_attention`` (the custom VJP over the dQ and dK/dV kernels);
* causal and not, G = 1 and 2 (grouped K/V), f32 and bf16;
* ``FlashAttentionFn``'s autograd gradients equal ``flash_plain_bwd``;
* the wrapper's side of the kernels: which variant of C and E a dtype
  and head dim take, the aligned copy of an unaligned view, and the C
  entries' ctypes declarations.

Shapes: (B*H, T, hd) = (4, 128, 64), which clears the JAX gate (T % 128,
hd % 64).  Tolerances: f32 1e-5 relative to each tensor's largest
magnitude (the same f32 products summed in another order); bf16 2^-7 of
it (the outputs are rounded to bf16, and a bf16 rounding of p or ds that
flips between the two orders moves a sum by one bf16 ulp of a term).
The kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_attention as pa
from mxnet_tpu_torch.ops import flash_kernel as fk

torch.set_num_threads(1)

BH, T, HD = 4, 128, 64
SCALE = 1.0 / np.sqrt(HD)
TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


def _inputs(seed, groups):
    rng = np.random.RandomState(seed)
    q = rng.randn(BH, T, HD).astype(np.float32)
    k = rng.randn(BH // groups, T, HD).astype(np.float32)
    v = rng.randn(BH // groups, T, HD).astype(np.float32)
    do = rng.randn(BH, T, HD).astype(np.float32)
    return q, k, v, do


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    mag = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * mag)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups", [1, 2])
def test_plain_matches_pallas_interpret(dtype, causal, groups):
    q, k, v, do = _inputs(groups + 2 * causal, groups)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))

    before = dict(fk.LAUNCHES)
    o, lse = fk.flash_fwd(tq, tk, tv, SCALE, causal, groups)
    assert o.dtype == tdt and lse.dtype == torch.float32
    jo, jlse = pa._fwd_call(jq, jk, jv, SCALE, causal, True, with_lse=True,
                            groups=groups)
    _close(o, jo, dtype)
    _close(lse, jlse[..., 0], "float32")

    dq, dk, dv = fk.flash_bwd(tq, tk, tv, o, lse, tdo, SCALE, causal,
                              groups)
    _, vjp = jax.vjp(lambda a, b, c: pa.flash_attention(
        a, b, c, SCALE, causal=causal, interpret=True, groups=groups),
        jq, jk, jv)
    for got, want in zip((dq, dk, dv), vjp(jdo)):
        assert got.dtype == tdt
        _close(got, want, dtype)
    # CPU tensors never launch a kernel
    assert fk.LAUNCHES == before


@pytest.mark.parametrize("groups", [1, 2])
def test_autograd_function_matches_plain_bwd(groups):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(7, groups))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fk.FlashAttentionFn.apply(*leaves, SCALE, True, groups, False)
    o.backward(do)
    o2, lse = fk.flash_plain_fwd(q, k, v, SCALE, True, groups)
    torch.testing.assert_close(o.detach(), o2, rtol=0, atol=0)
    want = fk.flash_plain_bwd(q, k, v, o2, lse, do, SCALE, True, groups)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Off the CPU (``meta`` tensors stand in for the card's) a dtype or
    head dim the kernels do not take raises; nothing runs quietly."""
    def meta(hd, dtype=torch.float32, rows=BH):
        return torch.empty((rows, T, hd), device="meta", dtype=dtype)

    with pytest.raises(ValueError, match="head dim 96"):
        fk.flash_fwd(meta(96), meta(96), meta(96), SCALE, True)
    with pytest.raises(ValueError, match="float16"):
        fk.flash_fwd(meta(64, torch.float16), meta(64, torch.float16),
                     meta(64, torch.float16), SCALE, True)
    with pytest.raises(ValueError, match="groups=2"):
        fk.flash_fwd(meta(64), meta(64), meta(64), SCALE, True, groups=2)
    with pytest.raises(ValueError, match="unsupported device"):
        fk.flash_fwd(meta(64), meta(64), meta(64), SCALE, True)
    with pytest.raises(ValueError, match="head dim 32"):
        fk.flash_bwd(meta(32), meta(32), meta(32), meta(32),
                     torch.empty((BH, T), device="meta"), meta(32), SCALE,
                     True)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma")])
def test_variant_rule(dtype, hd, want):
    """Kernels C and E run the CUDA-core tiles in f32 and wgmma in bf16,
    at every head dim they take."""
    assert fk._variant(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd", [(torch.float16, 64),
                                      (torch.float32, 96)])
def test_variant_rule_refuses_what_has_no_kernel(dtype, hd):
    with pytest.raises(ValueError, match="no flash kernel"):
        fk._variant(dtype, hd)


def test_unaligned_data_is_copied_before_the_kernels():
    """The kernels read 16-byte chunks: a view whose data starts off a
    16-byte boundary is copied, an aligned tensor passes as it is."""
    base = torch.arange(65, dtype=torch.float32)
    view = base[1:].view(4, 16)
    assert view.data_ptr() % 16 != 0
    copy = fk._aligned16(view)
    assert copy.data_ptr() % 16 == 0
    assert torch.equal(copy, view)
    aligned = torch.zeros(4, 16)
    assert aligned.data_ptr() % 16 == 0
    assert fk._aligned16(aligned) is aligned


def test_flash_entries_ctypes_declarations():
    """The C entries keep their signatures: every pointer and the stream
    as c_void_p (a 64-bit pointer never cut to an int), ints, the scale a
    float, an int error code back."""
    import ctypes
    from types import SimpleNamespace

    from mxnet_tpu_torch import cuda_build

    fake = SimpleNamespace(flash_fwd=SimpleNamespace(),
                           flash_bwd_dq=SimpleNamespace(),
                           flash_bwd_dkv=SimpleNamespace(),
                           mx_error_string=SimpleNamespace())
    cuda_build._declare("flash_attention", fake)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    assert fake.flash_fwd.argtypes == [i, i, p, p, p, p, p, i, i, i, f, i, p]
    assert fake.flash_bwd_dq.argtypes == [i, i, p, p, p, p, p, p, p,
                                          i, i, i, f, i, p]
    assert fake.flash_bwd_dkv.argtypes == [i, i, p, p, p, p, p, p, p, p,
                                           i, i, i, f, i, p]
    for fn in (fake.flash_fwd, fake.flash_bwd_dq, fake.flash_bwd_dkv):
        assert fn.restype is i
