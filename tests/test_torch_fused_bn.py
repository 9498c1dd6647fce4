"""Kernel B4 of the PyTorch port (mxnet_tpu_torch.ops.fused_bn: the fused
BatchNorm-apply -> ReLU -> 1x1-conv link with the output's statistics),
held against the reference's two prototypes, ``benchmarks/proto_fused.py``
(``fused_bn_matmul``, ``xla_chain``) and ``benchmarks/proto_sweep.py``
(``fused``), run by Pallas's interpreter on the CPU.

On the CPU the port's operator runs its plain PyTorch version.  The same
numpy inputs go to both sides.  Tolerances: y within one bf16 ulp,
|d| <= 2^-7 * max(1, |y_ref|) (the same products summed in another order
can round an accumulator the other way); the column statistics within
1e-5 * max(1, the column's sum of |acc| or acc^2), f32 sums over the rows
in another order.  The CUDA kernel is held against the plain version on
the card by tests/test_torch_cuda.py.
"""
import functools
import importlib.util
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_bn as fb

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_Y = 2 ** -7
TOL_SUM = 1e-5


def _proto(name):
    spec = importlib.util.spec_from_file_location(
        "_" + name, os.path.join(_ROOT, "benchmarks", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


proto_fused = _proto("proto_fused")
proto_sweep = _proto("proto_sweep")


def _inputs(seed, m, k, n):
    """The prototypes' draws, as bf16-exact f32 numpy arrays (x, w,
    residual) and f32 (scale, shift)."""
    rng = np.random.RandomState(seed)

    def bf16(a):
        return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    return dict(x=bf16(rng.normal(0, 1, (m, k))),
                w=bf16(rng.normal(0, 0.05, (k, n))),
                scale=(rng.rand(k) + 0.5).astype(np.float32),
                shift=rng.normal(0, 0.1, k).astype(np.float32),
                res=bf16(rng.normal(0, 1, (m, n))))


def _jax(d):
    return dict(x=jnp.asarray(d["x"], jnp.bfloat16),
                w=jnp.asarray(d["w"], jnp.bfloat16),
                scale=jnp.asarray(d["scale"]), shift=jnp.asarray(d["shift"]),
                res=jnp.asarray(d["res"], jnp.bfloat16))


def _torch(d):
    return dict(x=torch.from_numpy(d["x"]).bfloat16(),
                w=torch.from_numpy(d["w"]).bfloat16(),
                scale=torch.from_numpy(d["scale"]),
                shift=torch.from_numpy(d["shift"]),
                res=torch.from_numpy(d["res"]).bfloat16())


def _acc(d, residual, relu_in):
    """The f32 accumulator of the same inputs (for the sums' limits)."""
    t = _torch(d)
    a = t["x"].float() * t["scale"] + t["shift"]
    if relu_in:
        a = torch.clamp_min(a, 0.0)
    acc = a.bfloat16().float() @ t["w"].float()
    return acc + t["res"].float() if residual else acc


def _assert_y(got, want):
    got = np.asarray(got.float() if torch.is_tensor(got) else
                     jnp.asarray(got, jnp.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    lim = TOL_Y * np.maximum(1.0, np.abs(want))
    assert (np.abs(got - want) <= lim).all(), float(
        np.abs(got - want).max())


def _assert_sums(got, want, acc):
    for i, lim in ((0, acc.abs().sum(0)), (1, (acc * acc).sum(0))):
        err = (got[i] - torch.from_numpy(np.array(want[i]))).abs()
        assert bool((err <= TOL_SUM * torch.clamp_min(lim, 1.0)).all()), (
            i, float(err.max()))


@pytest.mark.parametrize("k,n,residual,relu_in", [
    (64, 128, True, True), (64, 128, False, True), (128, 256, True, False),
    (128, 256, False, False), (64, 256, True, True)])
def test_fused_bn_matmul_matches_proto_fused(k, n, residual, relu_in):
    m = 512
    d = _inputs(k + n + residual, m, k, n)
    t, j = _torch(d), _jax(d)
    before = fb.LAUNCHES["fused_bn_matmul"]
    got = fb.fused_bn_matmul(t["x"], t["scale"], t["shift"], t["w"],
                             t["res"] if residual else None, relu_in=relu_in)
    # a CPU tensor never launches the kernel
    assert fb.LAUNCHES["fused_bn_matmul"] == before
    want = proto_fused.fused_bn_matmul(
        j["x"], j["scale"], j["shift"], j["w"], j["res"] if residual
        else None, relu_in=relu_in, block_m=128, block_n=64, interpret=True)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (m, n)
    assert got[1].shape == got[2].shape == (n,)
    _assert_y(got[0], want[0])
    _assert_sums(got[1:], want[1:], _acc(d, residual, relu_in))


@pytest.mark.parametrize("stats", [True, False])
def test_fused_matches_proto_sweep(stats):
    m, k, n = 512, 64, 128
    d = _inputs(7, m, k, n)
    t, j = _torch(d), _jax(d)
    got = fb.fused(t["x"], t["scale"], t["shift"], t["w"], stats=stats)
    # proto_sweep.fused has no interpret argument: run its pallas_call
    # through the interpreter
    real = pl.pallas_call
    with mock.patch.object(pl, "pallas_call",
                           functools.partial(real, interpret=True)):
        want = proto_sweep.fused(j["x"], j["scale"], j["shift"], j["w"],
                                 128, 64, stats)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _assert_y(got, want)
    # the statistics change what the operator writes, not y
    _, s1, s2 = fb.fused_bn_matmul_op(t["x"], t["scale"], t["shift"],
                                      t["w"], None, True, stats, "128x64")
    assert s1.shape == s2.shape == ((n,) if stats else (0,))


@pytest.mark.parametrize("residual", [True, False])
def test_library_chain_matches_xla_chain(residual):
    m, k, n = 256, 64, 128
    d = _inputs(11, m, k, n)
    t, j = _torch(d), _jax(d)
    got = fb.library_chain(t["x"], t["scale"], t["shift"], t["w"],
                           t["res"] if residual else None)
    want = proto_fused.xla_chain(j["x"], j["scale"], j["shift"], j["w"],
                                 j["res"] if residual else None)
    _assert_y(got[0], want[0])
    # the sums of each side's own stored y: the y difference carried over
    dy = (got[0].float() - torch.from_numpy(
        np.array(want[0].astype(jnp.float32)))).abs()
    y = got[0].float()
    for i, (lim, carried) in enumerate((
            (y.abs().sum(0), dy.sum(0)),
            (y.square().sum(0), (dy * (2 * y.abs() + dy)).sum(0)))):
        err = (got[1 + i] - torch.from_numpy(np.array(want[1 + i]))).abs()
        assert bool((err <= carried + TOL_SUM
                     * torch.clamp_min(lim, 1.0)).all()), i
    # the statistics the kernel replaces them with are the accumulator's
    acc = _acc(d, residual, True)
    kern = fb.fused_bn_matmul(t["x"], t["scale"], t["shift"], t["w"],
                              t["res"] if residual else None)
    torch.testing.assert_close(kern[1], acc.sum(0), rtol=0, atol=float(
        TOL_SUM * torch.clamp_min(acc.abs().sum(0), 1.0).max()))


def test_operator_dispatch_fake_and_refusals():
    m, k, n = 64, 32, 24
    t = _torch(_inputs(3, m, k, n))
    args = (t["x"], t["scale"], t["shift"], t["w"], t["res"], True, True,
            None)
    # the CPU dispatch is the plain version, bit for bit
    got = fb.fused_bn_matmul_op(*args)
    want = fb.fused_bn_matmul_plain(t["x"], t["scale"], t["shift"], t["w"],
                                    t["res"], True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    torch.library.opcheck(fb.fused_bn_matmul_op, args)
    torch.library.opcheck(fb.fused_bn_matmul_op, args[:6] + (False, None))
    # the fake implementation gives a launch's shapes and dtypes
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) for a in args[:5]]
        for stats, width in ((True, n), (False, 0)):
            y, s1, s2 = fb.fused_bn_matmul_op(*fake, True, stats, None)
            assert (y.shape, y.dtype) == ((m, n), torch.bfloat16)
            assert s1.shape == s2.shape == (width,)
            assert s1.dtype == s2.dtype == torch.float32
    # off the host: the prototype's contract, K and N multiples of 8
    meta = {name: v.to("meta") for name, v in t.items()}

    def call(**kw):
        a = dict(meta, **kw)
        return fb.fused_bn_matmul_op(a["x"], a["scale"], a["shift"], a["w"],
                                     a["res"], True, True, None)

    for bad in (dict(x=meta["x"].float()), dict(w=meta["w"].float()),
                dict(scale=meta["scale"].bfloat16()),
                dict(res=meta["res"].float()),
                dict(w=torch.empty((k + 1, n), dtype=torch.bfloat16,
                                   device="meta")),
                dict(res=torch.empty((m, n + 8), dtype=torch.bfloat16,
                                     device="meta"))):
        with pytest.raises(MXNetError, match="proto_fused.py:52"):
            call(**bad)
    with pytest.raises(MXNetError, match="multiples of 8"):
        call(x=torch.empty((m, 12), dtype=torch.bfloat16, device="meta"),
             w=torch.empty((12, n), dtype=torch.bfloat16, device="meta"),
             scale=torch.empty((12,), device="meta"),
             shift=torch.empty((12,), device="meta"))
    # a meta tensor given directly stands for no device a kernel runs on
    with pytest.raises(ValueError, match="unsupported device"):
        call()
    with pytest.raises(MXNetError, match="unknown variant"):
        fb.fused(t["x"], t["scale"], t["shift"], t["w"], variant="64x64")


def test_plan_covers_n_and_fills_the_card():
    # the narrowest tile that covers N, so x is read once for N <= 256
    for n, want in ((8, "128x64"), (64, "128x64"), (128, "128x128"),
                    (200, "128x256"), (256, "128x256"), (512, "128x256"),
                    (2048, "128x256")):
        assert fb._plan(1000, n).variant == want
    for _, m, k, n, _ in fb.CASES:
        for occ, sms in ((1, 132), (2, 132), (1, 114)):
            p = fb._plan(m, n, None, occ, sms)
            bm, bn = fb._TILES[p.variant]
            tiles, cols = -(-m // bm), -(-n // bn)
            per = -(-tiles // p.rows)
            # every tile walked, the groups' loads equal to one tile
            assert p.rows * per >= tiles > (p.rows - 1) * per
            assert p.rows * cols <= max(cols, occ * sms)
            assert fb.VARIANTS[p.code] == p.variant
    assert fb._plan(5, 64, "256x128", 2, 132).rows == 1
    assert fb._plan(802816, 64, None, 1000, 1000).rows <= 65535


def test_prototype_cases_and_entry_points():
    assert [c[1:] for c in fb.CASES] == [
        (802816, 256, 64, False), (802816, 64, 256, True),
        (200704, 128, 512, True), (50176, 1024, 256, False),
        (12544, 512, 2048, True)]
    assert [c[1:] for c in fb.SWEEP_CASES] == [
        (802816, 256, 64), (802816, 64, 256), (12544, 2048, 512)]
    for entry in (fb.bench_cases, fb.sweep):
        with pytest.raises(MXNetError, match="CUDA device"):
            entry("cpu")
