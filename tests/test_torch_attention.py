"""The ``dot_product_attention`` op's routing in the PyTorch port
(``mxnet_tpu_torch.ops.flash_kernel.supported``) held against the JAX
package's gate (``pallas_attention.supported``) and its op.

The port sends a self-attention to kernels C, D and E only where they
are built (head dims 64 and 128, float32 or bfloat16; any T, as they
mask ragged tiles); every other shape goes to ``sdpa`` with
``PATH_TAKEN`` "einsum", as the reference routes the shapes its gate
refuses.  Outputs and gradients are compared with the JAX op on the same
numpy inputs, f32, within 1e-5 of each tensor's largest magnitude (the
same f32 products summed in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops import pallas_attention as jpa
from mxnet_tpu.registry import OpContext as JOpContext
from mxnet_tpu.registry import get_op as jget_op
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import flash_kernel as fk
from mxnet_tpu_torch.registry import OpContext, get_op

torch.set_num_threads(1)

TOL = 1e-5


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2)])
def test_gate_agrees_with_jax_where_both_take(t, hd, heads, kv_heads):
    """Shapes both kernels take (T a multiple of 128, hd 64 / 128, G 1 /
    2) pass both gates; cross-attention and a K width that is not H_kv
    head slices fail both."""
    e = heads * hd
    q, k = (2, t, e), (2, t, kv_heads * hd)
    for dtype in (torch.float32, torch.bfloat16):
        assert fk.supported(q, k, dtype, heads, kv_heads, v_shape=k)
    assert jpa.supported(q, k, True, heads, num_kv_heads=kv_heads)
    cross = (2, t // 2, kv_heads * hd)
    assert not fk.supported(q, cross, torch.float32, heads, kv_heads)
    assert not jpa.supported(q, cross, True, heads, num_kv_heads=kv_heads)
    wide = (2, t, (kv_heads + 1) * hd)
    assert not fk.supported(q, wide, torch.float32, heads, kv_heads)
    assert not jpa.supported(q, wide, True, heads, num_kv_heads=kv_heads)


@pytest.mark.parametrize("hd", [32, 256])
def test_gate_refuses_head_dims_without_a_kernel(hd):
    """hd 32 (both gates refuse it) and hd 256 (the reference's kernel
    takes it; the port's kernels are not built for it yet)."""
    q = (2, 128, 4 * hd)
    assert not fk.supported(q, q, torch.float32, 4, 4)
    assert jpa.supported(q, q, True, 4) == (hd == 256)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_gate_refuses_dtypes_without_a_kernel(dtype):
    q = (2, 128, 256)
    assert not fk.supported(q, q, dtype, 4, 4)
    assert fk.supported(q, q, torch.float32, 4, 4)


def test_gate_takes_ragged_t_and_refuses_odd_v():
    """Any T (the port's kernels mask ragged tiles, so the reference's T
    % 128 rule does not carry over); a value head dim other than the
    query's goes to sdpa."""
    q = (2, 67, 256)
    assert fk.supported(q, q, torch.float32, 4, 4, v_shape=q)
    assert not jpa.supported(q, q, True, 4)
    assert not fk.supported(q, q, torch.float32, 4, 4,
                            v_shape=(2, 67, 128))


def _op_inputs(seed, t, e, e_kv):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, t, n).astype(np.float32) for n in (e, e_kv, e_kv)]


@pytest.mark.parametrize("heads,kv_heads,t,causal", [
    (16, 16, 64, True),      # E 512 over 16 heads: hd 32
    (16, 8, 40, False),      # grouped, hd 32, ragged T
    (2, 2, 128, True),       # hd 256
])
def test_op_routes_what_the_kernels_refuse_to_sdpa(heads, kv_heads, t,
                                                   causal):
    """The op at a head dim the kernels refuse records "einsum" and
    matches the JAX op (which takes its einsum path on the CPU), output
    and the gradients of q, k and v."""
    hd = 512 // heads
    ins = _op_inputs(heads + t, t, heads * hd, kv_heads * hd)
    attrs = {"num_heads": str(heads), "num_kv_heads": str(kv_heads),
             "causal": str(causal)}
    op = get_op("dot_product_attention")
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    tattn.PATH_TAKEN["last"] = None
    (out,), _ = op.fcompute(op.parse_attrs(attrs), leaves, [], OpContext())
    assert tattn.PATH_TAKEN["last"] == "einsum"
    cot = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))

    jop = jget_op("dot_product_attention")
    jattrs = jop.parse_attrs(attrs)

    def jf(q, k, v):
        (o,), _ = jop.fcompute(jattrs, [q, k, v], [], JOpContext())
        return o

    jout, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in ins))
    assert jattn.PATH_TAKEN["last"] == "einsum"
    jgrads = vjp(jnp.asarray(cot))
    for got, want in zip([out] + list(grads), [jout] + list(jgrads)):
        want = np.asarray(want)
        mag = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=TOL * mag)


def test_op_takes_the_flash_path_where_the_kernels_are_built():
    """hd 64 self-attention goes through FlashAttentionFn (its plain
    version on the CPU) and matches the JAX op."""
    ins = _op_inputs(3, 96, 256, 256)
    attrs = {"num_heads": "4", "causal": "True"}
    op = get_op("dot_product_attention")
    tattn.PATH_TAKEN["last"] = None
    (out,), _ = op.fcompute(op.parse_attrs(attrs),
                            [torch.from_numpy(a) for a in ins], [],
                            OpContext())
    assert tattn.PATH_TAKEN["last"] == "plain"
    jop = jget_op("dot_product_attention")
    (jout,), _ = jop.fcompute(jop.parse_attrs(attrs),
                              [jnp.asarray(a) for a in ins], [],
                              JOpContext())
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=TOL)
