"""Kernels A and F of the PyTorch port (mxnet_tpu_torch.ops.fused_kernel),
the FusedLNLinear op and the SoftmaxOutput loss gradient, held against
the JAX package's fused op (forward and VJP) and loss head.

On the CPU the port's wrapper runs its plain PyTorch version; it is
compared with ``pallas_fused.fused_scale_relu_matmul(..., interpret=True)``
(the TPU kernel in Pallas's interpreter) and ``pallas_fused.reference_impl``
on the same numpy inputs, for every relu/residual/bias combination the LM
uses.  f32 parity is rtol 1e-5: the same products summed in another
order.  The CUDA kernel itself is held against the plain version on the
card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_fused as pf
from mxnet_tpu_torch.ops import fused_kernel as fk
from mxnet_tpu_torch.ops import fused_lm
from mxnet_tpu_torch.registry import OpContext, get_op

torch.set_num_threads(1)

# (relu, residual, bias): q/k/v/ffn1 segments, the ffn2 segment, and the
# remaining combinations of the kernel's options
COMBOS = [(False, False, True), (True, True, True), (False, True, True),
          (True, False, True), (False, False, False), (True, True, False)]


def _inputs(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(m, k).astype(np.float32),
                scale=(1.0 + 0.1 * rng.randn(k)).astype(np.float32),
                shift=(0.1 * rng.randn(k)).astype(np.float32),
                w=(rng.randn(n, k) / np.sqrt(k)).astype(np.float32),
                bias=(0.1 * rng.randn(n)).astype(np.float32),
                res=rng.randn(m, n).astype(np.float32))


@pytest.mark.parametrize("relu,has_res,has_bias", COMBOS)
def test_wrapper_matches_pallas_interpret_and_reference(relu, has_res,
                                                        has_bias):
    d = _inputs(0, 16, 24, 8)
    res = d["res"] if has_res else None
    bias = d["bias"] if has_bias else None
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    before = fk.LAUNCHES["fused_fwd"]
    y, s1, s2 = fk.fused_scale_relu_matmul(
        t["x"], t["scale"], t["shift"], t["w"],
        residual=t["res"] if has_res else None, relu=relu,
        bias=t["bias"] if has_bias else None, wt=True)
    # a CPU tensor never launches the kernel
    assert fk.LAUNCHES["fused_fwd"] == before
    j = {k: jnp.asarray(v) for k, v in d.items()}
    ref_i = pf.fused_scale_relu_matmul(
        j["x"], j["scale"], j["shift"], j["w"],
        residual=j["res"] if has_res else None, relu=relu,
        bias=j["bias"] if has_bias else None, wt=True, interpret=True)
    ref_r = pf.reference_impl(
        j["x"], j["scale"], j["shift"], j["w"],
        residual=None if res is None else j["res"], relu=relu,
        bias=None if bias is None else j["bias"], wt=True)
    for ref in (ref_i, ref_r):
        for got, want in zip((y, s1, s2), ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def test_bf16_plain_matches_reference_impl():
    """bf16 inputs: the activation and y round to bf16 at the same
    places as reference_impl; one bf16 ulp (2^-8 relative) covers a
    rounding flip from the f32 sums' order."""
    d = _inputs(1, 8, 32, 16)
    xb = torch.from_numpy(d["x"]).to(torch.bfloat16)
    wb = torch.from_numpy(d["w"]).to(torch.bfloat16)
    rb = torch.from_numpy(d["res"]).to(torch.bfloat16)
    y, s1, _ = fk.fused_scale_relu_matmul(
        xb, torch.from_numpy(d["scale"]), torch.from_numpy(d["shift"]), wb,
        residual=rb, relu=True, bias=torch.from_numpy(d["bias"]))
    assert y.dtype == torch.bfloat16
    ry, rs1, _ = pf.reference_impl(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(d["scale"]), jnp.asarray(d["shift"]),
        jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16),
        residual=jnp.asarray(rb.float().numpy()).astype(jnp.bfloat16),
        relu=True, bias=jnp.asarray(d["bias"]), wt=True)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ry, np.float32),
                               rtol=2 ** -8, atol=2 ** -8)
    np.testing.assert_allclose(s1.numpy(), np.asarray(rs1), rtol=1e-2,
                               atol=1e-1)


def _op_inputs(d, relu, has_res):
    attrs = {"num_hidden": str(d["w"].shape[0])}
    x3 = torch.from_numpy(d["x"]).reshape(2, -1, d["x"].shape[1])
    k = d["x"].shape[1]
    gamma = torch.from_numpy(d["scale"]).reshape(1, 1, k)
    beta = torch.from_numpy(d["shift"]).reshape(1, 1, k)
    ins = [x3]
    if relu:
        # the LM's ffn2 segment: ReLU prologue, no LN affine, residual
        attrs.update(relu="True", no_affine="True")
    else:
        ins += [gamma, beta]
    if has_res:
        attrs["has_residual"] = "True"
        ins.append(torch.from_numpy(d["res"]).reshape(2, -1,
                                                      d["res"].shape[1]))
    ins += [torch.from_numpy(d["w"]), torch.from_numpy(d["bias"])]
    return attrs, ins


@pytest.mark.parametrize("relu,has_res", [(False, False), (True, True)])
def test_fused_ln_linear_op_matches_jax_op(relu, has_res):
    """The registered op (the graph node attention_lm emits) equals the
    JAX package's FusedLNLinear on the same inputs, and records the
    plain path on the CPU."""
    from mxnet_tpu.registry import OpContext as JOpContext
    from mxnet_tpu.registry import get_op as jget_op

    d = _inputs(2, 12, 16, 20)
    attrs, ins = _op_inputs(d, relu, has_res)
    op = get_op("FusedLNLinear")
    (y,), _ = op.fcompute(op.parse_attrs(attrs), ins, [], OpContext())
    assert fused_lm.FUSED_PATH["last"] == "plain"
    jop = jget_op("FusedLNLinear")
    (jy,), _ = jop.fcompute(jop.parse_attrs(attrs),
                            [jnp.asarray(t.numpy()) for t in ins], [],
                            JOpContext())
    assert tuple(y.shape) == tuple(jy.shape) == (2, 6, 20)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def test_op_gates_dtypes_the_kernel_does_not_take():
    """The op has two paths, kernel and plain version.  On the CPU any
    float dtype takes the plain version; off the CPU a dtype the kernel
    does not take (f16 here, on ``meta`` tensors that stand in for the
    card's) raises instead of running anything quietly."""
    d = _inputs(3, 4, 8, 4)
    attrs, ins = _op_inputs(d, False, False)
    op = get_op("FusedLNLinear")
    pattrs = op.parse_attrs(attrs)
    (y,), _ = op.fcompute(pattrs, [t.double() for t in ins], [], OpContext())
    assert fused_lm.FUSED_PATH["last"] == "plain"
    assert y.dtype == torch.float64
    (y32,), _ = op.fcompute(pattrs, ins, [], OpContext())
    np.testing.assert_allclose(y.numpy(), y32.numpy(), rtol=1e-6)
    fused_lm.FUSED_PATH["last"] = None
    with pytest.raises(ValueError, match="float16"):
        op.fcompute(pattrs, [t.to("meta", torch.float16) for t in ins], [],
                    OpContext())
    assert fused_lm.FUSED_PATH["last"] is None


def test_wrapper_rejects_other_devices():
    x = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fk.fused_scale_relu_matmul(x, x[0], x[0], x)



# ---------------------------------------------------------------------------
# kernel F (the backward) and FusedLNLinearFn against jax.vjp of the JAX
# package's fused op (Pallas interpreter).  f32: 1e-5 relative to each
# gradient's largest magnitude (the same f32 products in another order).
# bf16: x, dy, W and so dx, dW and dresidual are bf16, rounded at the
# same places on both sides; 2^-7 of the magnitude covers one bf16
# rounding flip; the f32 sums (dscale, dshift, dbias) of bf16 terms keep
# 1e-5.
# ---------------------------------------------------------------------------

BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _grad_close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    mag = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * mag)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu,has_res,has_bias", COMBOS)
def test_fused_bwd_matches_jax_vjp(dtype, relu, has_res, has_bias):
    d = _inputs(4, 32, 24, 16)
    rng = np.random.RandomState(5)
    dy = rng.randn(32, 16).astype(np.float32)
    # nonzero statistics cotangents exercise the fold into dy
    dys1 = (0.1 * rng.randn(16)).astype(np.float32)
    dys2 = (0.01 * rng.randn(16)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def t(a, cast=True):
        x = torch.from_numpy(a)
        return x.to(dtype) if cast else x

    x, w, res = t(d["x"]), t(d["w"]), t(d["res"])
    scale, shift, bias = (t(d[k], cast=False)
                          for k in ("scale", "shift", "bias"))
    leaves = [x, scale, shift, w] + ([bias] if has_bias else []) \
        + ([res] if has_res else [])
    leaves = [a.clone().requires_grad_(True) for a in leaves]
    it = iter(leaves[4:])
    lb = next(it) if has_bias else None
    lr = next(it) if has_res else None
    before = fk.LAUNCHES["fused_bwd"]
    outs = fk.FusedLNLinearFn.apply(*leaves[:4], lb, lr, relu, False)
    grads = torch.autograd.grad(outs, leaves, (t(dy), torch.from_numpy(dys1),
                                               torch.from_numpy(dys2)))
    assert fk.LAUNCHES["fused_bwd"] == before

    def jx(a, cast=True):
        return jnp.asarray(a).astype(jdt) if cast else jnp.asarray(a)

    jargs = [jx(d["x"]), jx(d["scale"], False), jx(d["shift"], False),
             jx(d["w"])] + ([jx(d["bias"], False)] if has_bias else []) \
        + ([jx(d["res"])] if has_res else [])

    def f(x_, sc_, sh_, w_, *extra):
        extra = list(extra)
        b_ = extra.pop(0) if has_bias else None
        r_ = extra.pop(0) if has_res else None
        return pf.fused_scale_relu_matmul(x_, sc_, sh_, w_, residual=r_,
                                          relu=relu, bias=b_, wt=True,
                                          interpret=True)

    _, vjp = jax.vjp(f, *jargs)
    want = vjp((jx(dy), jnp.asarray(dys1), jnp.asarray(dys2)))
    for i, (g, wv) in enumerate(zip(grads, want)):
        lowp = g.dtype == torch.bfloat16
        _grad_close(g, wv, BWD_TOL[dtype] if lowp else 1e-5)
        assert g.dtype == leaves[i].dtype

    # the plain version alone, on the effective dy the VJP folds
    y = outs[0].detach().float()
    dy_eff = (torch.from_numpy(dy).to(dtype).float()
              + torch.from_numpy(dys1) + 2.0 * y
              * torch.from_numpy(dys2)).to(dtype)
    dx, dw, dsc, dsh = fk.fused_bwd_plain(x, dy_eff, scale, shift, w, relu)
    torch.testing.assert_close(dx, grads[0], rtol=0, atol=0)
    torch.testing.assert_close(dw.to(dtype), grads[3], rtol=0, atol=0)
    torch.testing.assert_close(dsc, grads[1], rtol=0, atol=0)
    torch.testing.assert_close(dsh, grads[2], rtol=0, atol=0)


def test_fused_op_backward_reaches_gamma_beta():
    """Through the registered op, gamma and beta (shape (1, 1, E)) take
    dscale/dshift; a no_affine segment's constant scale takes none."""
    d = _inputs(6, 12, 16, 20)
    for relu, has_res in ((False, False), (True, True)):
        attrs, ins = _op_inputs(d, relu, has_res)
        ins = [a.clone().requires_grad_(True) for a in ins]
        op = get_op("FusedLNLinear")
        (y,), _ = op.fcompute(op.parse_attrs(attrs), ins, [], OpContext())
        grads = torch.autograd.grad(y.sum(), ins)
        assert [tuple(g.shape) for g in grads] == [tuple(a.shape)
                                                   for a in ins]
        assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
def test_softmax_output_gradient_matches_jax(norm):
    """SoftmaxOutput's loss gradient (softmax - onehot, ignore-masked,
    normalised, scaled) equals the JAX head's custom VJP; the upstream
    gradient is ignored.  f32 on both sides: 1e-6 absolute on O(1)
    values."""
    from mxnet_tpu.registry import OpContext as JOpContext
    from mxnet_tpu.registry import get_op as jget_op

    rng = np.random.RandomState(7)
    data = rng.randn(12, 10).astype(np.float32)
    label = rng.randint(0, 10, 12).astype(np.float32)
    label[[2, 5]] = -1
    attrs = {"use_ignore": "True", "ignore_label": "-1",
             "normalization": norm, "grad_scale": "0.5"}
    op = get_op("SoftmaxOutput")
    td = torch.from_numpy(data).requires_grad_(True)
    (out,), _ = op.fcompute(op.parse_attrs(attrs),
                            [td, torch.from_numpy(label)], [], OpContext())
    (g,) = torch.autograd.grad(out, [td], torch.full_like(out, 3.0))
    jop = jget_op("SoftmaxOutput")
    jattrs = jop.parse_attrs(attrs)

    def head(x):
        return jop.fcompute(jattrs, [x, jnp.asarray(label)], [],
                            JOpContext())[0][0]

    jout, vjp = jax.vjp(head, jnp.asarray(data))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jout)[0]),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the variant plan (ops/fused_kernel.py _plan) over the LM's shapes: the
# serve's decode (M = 4) and prefill chunks (M = 256), the training batch
# (M = 8 x 2048), the q/k/v (1024 -> 1024), ffn1 (1024 -> 4096) and ffn2
# (4096 -> 1024) segments, f32 and bf16.  No card needed.
# ---------------------------------------------------------------------------

LM_SEGMENTS = [(1024, 1024), (1024, 4096), (4096, 1024)]


def _side(plan):
    """The square tile side a tiled variant's name carries."""
    return int("".join(c for c in plan.variant.split("_")[0] if c.isdigit()))


def _blocks(plan, m, k, n, product="fwd"):
    """Blocks a tiled variant launches: output tiles of its side times
    the dW splits."""
    rows, cols = {"fwd": (m, n), "dx": (m, k), "dw": (n, k)}[product]
    side = _side(plan)
    return -(-rows // side) * -(-cols // side) * plan.splits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", LM_SEGMENTS)
def test_plan_decode_rows_stream_the_weight(dtype, k, n):
    for m in (1, 4, 16):
        plan = fk._plan(m, k, n, dtype)
        assert (plan.variant, plan.splits) == ("decode", 1)
    assert fk._plan(17, k, n, dtype).variant != "decode"


@pytest.mark.parametrize("k,n", LM_SEGMENTS)
def test_plan_prefill_chunk_fills_the_card(k, n):
    plan = fk._plan(256, k, n, torch.float32)
    assert plan.variant.startswith("simt") and plan.variant != "simt128"
    assert plan.splits == 1 and _blocks(plan, 256, k, n) >= fk.SMS
    # the largest tile that fills the card: one side up falls short
    if _side(plan) < 128:
        bigger = fk.Plan("simt%d" % (2 * _side(plan)), 0, 1)
        assert _blocks(bigger, 256, k, n) < fk.SMS
    if n == 1024:
        assert plan.variant == "simt32" and _blocks(plan, 256, k, n) == 256


@pytest.mark.parametrize("k,n", LM_SEGMENTS)
def test_plan_training_batch_takes_the_large_tiles(k, n):
    m = 8 * 2048
    for product in ("fwd", "dx", "dw"):
        assert fk._plan(m, k, n, torch.float32, product).variant == "simt128"
    for product in ("dx", "dw"):
        assert fk._plan(m, k, n, torch.bfloat16, product).variant == "mma128"
    # kernel A in bf16: wgmma on the same 128 x 128 tiles
    wg = fk._plan(m, k, n, torch.bfloat16)
    assert (wg.variant, wg.splits) == ("wgmma128", 1)
    assert _blocks(wg, m, k, n) == (n // 128) * (m // 128)
    for product in ("fwd", "dx"):
        assert fk._plan(m, k, n, torch.float32, product).splits == 1


def test_plan_splits_dw_over_m_where_its_tiles_are_few():
    m = 8 * 2048
    qkv = fk._plan(m, 1024, 1024, torch.float32, "dw")
    # 64 tiles of 128 x 128 on 132 SMs: M in 4 ranges, 256 blocks
    assert (qkv.variant, qkv.splits) == ("simt128", 4)
    assert _blocks(qkv, m, 1024, 1024, "dw") == 256 >= 2 * fk.SMS - 64
    for k, n in ((1024, 4096), (4096, 1024)):
        plan = fk._plan(m, k, n, torch.float32, "dw")
        assert plan.splits == 1 and _blocks(plan, m, k, n, "dw") == 256
    # a shallow contraction is not split
    assert fk._plan(512, 1024, 1024, torch.float32, "dw").splits == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_unaligned_takes_scalar_loads(dtype):
    # K = 1 mod 4: no 16-byte load lines up with a row
    for m in (4, 256, 16384):
        for product in ("fwd", "dx", "dw"):
            if m == 4 and product != "fwd":
                continue
            plan = fk._plan(m, 1025, 1024, dtype, product)
            assert plan.variant.endswith("_scalar"), (m, product, plan)
    # unaligned pointers likewise, with aligned widths
    assert fk._plan(4, 1024, 1024, dtype,
                    aligned=False).variant == "decode_scalar"
    assert fk._plan(16384, 1024, 1024, dtype, "fwd",
                    aligned=False).variant == "simt128_scalar"
    # bf16 widths the tensor cores cannot load (K % 8 == 4) take the
    # scalar f32 engine
    if dtype == torch.bfloat16:
        assert fk._plan(16384, 1028, 1024, dtype).variant == "simt128_scalar"
    else:
        assert fk._plan(16384, 1028, 1024, dtype).variant == "simt128"


def test_plan_codes_match_the_variant_table():
    for m in (1, 100, 256, 16384):
        for dtype in (torch.float32, torch.bfloat16):
            for product in ("fwd", "dx", "dw"):
                plan = fk._plan(m, 1032, 264, dtype, product)
                assert fk.VARIANTS[plan.code] == plan.variant
