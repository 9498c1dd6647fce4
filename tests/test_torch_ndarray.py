"""The port's imperative NDArray API (``mxnet_tpu_torch/ndarray.py``),
``random`` and ``test_utils`` against the JAX package.

* The default context: the card with no ``with ctx:`` scope (without a
  card, creation raises), the host inside ``with mt.cpu():``.
* Operators (arithmetic, reflected, in-place, comparisons), methods,
  indexing and constructors: each expression runs on both packages'
  NDArrays from the same numpy values; values and dtypes must agree to
  1e-6 relative (the same f32 operation on both sides).
* The dispatch path: ``out=``, aux states written back, visible
  outputs, variadic inputs, arrays by keyword.
* ``random``: ``seed(n)`` repeats the draws of every sampler and of
  Dropout, and another seed changes them; each sampler's mean and
  variance over 20,000 draws agree with the JAX package's over as many
  (its own generator: the draws themselves differ) within 6 standard
  errors of the difference.
* ``test_utils``: the numeric-gradient, symbolic forward / backward and
  consistency checks on the port, and ``default_context``.
"""
import contextlib
import operator

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import test_utils as tu
from test_torch_op_cases import SAMPLERS

REL = 1e-6


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel)


def test_default_context_is_the_card():
    assert mt.current_context is mt.context.current_context
    if torch.cuda.is_available():
        assert mt.current_context() == mt.gpu(0)
        assert mt.nd.zeros((2,)).data.is_cuda
    else:
        for make in (lambda: mt.nd.array([1.0]), lambda: mt.nd.zeros(2),
                     lambda: mt.nd.ones(2), lambda: mt.nd.full(2, 1.0),
                     lambda: mt.nd.empty(2), lambda: mt.nd.arange(3),
                     lambda: mt.nd._zeros(shape=(2,)),
                     tu.default_context):
            with pytest.raises(mt.MXNetError, match="cpu"):
                make()
    with mt.cpu():
        assert mt.current_context() == mt.cpu() == tu.default_context()
        x = mt.nd.array([1.0, 2.0])
        assert x.context == mt.cpu() and x.data.device.type == "cpu"
        assert mt.nd.uniform(shape=(3,)).context == mt.cpu()
        with mt.gpu(0):
            assert mt.current_context() == mt.gpu(0)
        assert mt.current_context() == mt.cpu()
    assert mt.nd.array([1.0], ctx=mt.cpu()).context == mt.cpu()


def test_load_lands_on_the_current_context(tmp_path):
    """``nd.load`` reads onto ``current_context()``, as ``nd.array`` does
    (without a card and with no scope it raises); the checkpoint readers
    name the host themselves, so a CPU module loads with no scope."""
    rng = np.random.RandomState(3)
    arrays = {"arg:w": rng.randn(3, 2).astype(np.float32),
              "aux:m": rng.randn(2).astype(np.float32)}
    fname = str(tmp_path / "p-0000.params")
    mx.nd.save(fname, {k: mx.nd.array(v) for k, v in arrays.items()})
    if torch.cuda.is_available():
        assert mt.nd.load(fname)["arg:w"].data.is_cuda
    else:
        with pytest.raises(mt.MXNetError, match="cpu"):
            mt.nd.load(fname)
    with mt.cpu():
        got = mt.nd.load(fname)
        from_bytes = mt.nd.load(open(fname, "rb").read())
    for k, v in arrays.items():
        for loaded in (got, from_bytes):
            assert loaded[k].context == mt.cpu()
            _close(loaded[k].asnumpy(), v)
    mt.sym.Variable("w").save(str(tmp_path / "p-symbol.json"))
    _, args, auxs = mt.model.load_checkpoint(str(tmp_path / "p"), 0)
    assert args["w"].context == mt.cpu() and auxs["m"].context == mt.cpu()


@pytest.mark.parametrize("recording", [False, True])
def test_out_takes_the_ops_dtype_and_shape(recording):
    """``out=`` leaves the destination holding the op's result in the
    op's dtype and shape (the reference rebinds it); a destination of
    the same shape and dtype is written in place outside recording."""
    x = np.random.RandomState(4).randn(2, 3).astype(np.float32)

    def run(pkg):
        nd = pkg.nd
        xs = nd.array(x)
        y, z, same = nd.zeros((2, 3)), nd.zeros((6,)), nd.zeros((2, 3))
        before = same.data
        with pkg.autograd.record() if recording \
                else contextlib.nullcontext():
            half = nd.Cast(xs, dtype="float16", out=y)
            flat = nd.Reshape(xs, shape=(3, 2), out=z)
            nd.relu(xs, out=same)
        kept = same.data is before
        return [half, y, flat, z, same], kept

    want, _ = run(mx)
    with mt.cpu():
        got, kept = run(mt)
    assert got[0] is got[1] and got[2] is got[3]
    assert kept != recording
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        _close(g.asnumpy(), w_.asnumpy())


A = np.random.RandomState(0).uniform(0.5, 2.0, (3, 4)).astype(np.float32)
B = np.random.RandomState(1).uniform(0.5, 2.0, (1, 4)).astype(np.float32)

EXPRESSIONS = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "pow": lambda a, b: a ** b, "mod": lambda a, b: (a * 3) % b,
    "radd": lambda a, b: 2 + a, "rsub": lambda a, b: 2 - a,
    "rmul": lambda a, b: 2 * a, "rdiv": lambda a, b: 2 / a,
    "rpow": lambda a, b: 2 ** a,
    "add_s": lambda a, b: a + 1.5, "sub_s": lambda a, b: a - 1.5,
    "div_s": lambda a, b: a / 1.5, "pow_s": lambda a, b: a ** 1.5,
    "mod_s": lambda a, b: a % 0.7, "neg": lambda a, b: -a,
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
    "eq_s": lambda a, b: a == A[0, 0].item(), "gt_s": lambda a, b: a > 1.0,
    "T": lambda a, b: a.T, "astype": lambda a, b: a.astype("float16"),
    "astype_np": lambda a, b: a.astype(np.int32),
    "reshape": lambda a, b: a.reshape((0, 2, -1)),
    "broadcast_to": lambda a, b: b.broadcast_to((3, 4)),
    "copy": lambda a, b: a.copy(), "index": lambda a, b: a[1],
    "slice": lambda a, b: a[1:3],
}


def _both(fn, *arrays):
    want = fn(*[mx.nd.array(x) for x in arrays])
    with mt.cpu():
        got = fn(*[mt.nd.array(x) for x in arrays])
    return got, want


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_operators_and_methods(name):
    got, want = _both(EXPRESSIONS[name], A, B)
    assert isinstance(got, mt.nd.NDArray)
    assert got.shape == want.shape and got.dtype == want.dtype
    _close(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("op", [operator.iadd, operator.isub,
                                operator.imul, operator.itruediv])
def test_inplace_operators(op):
    def run(a, b):
        c = a[1:2]             # a view: sees the write in both packages
        return op(a, b), c

    (ga, gc), (wa, wc) = _both(run, A, B)
    _close(ga.asnumpy(), wa.asnumpy())
    _close(gc.asnumpy(), wc.asnumpy())


def test_indexing_writes_through_views():
    def run(x, rows):
        row = x[1]
        row[:] = 7.0                       # through a basic-index view
        x[0] = 1.0                         # an int row
        x[2:3] = np.full((1, 4), -2.0, np.float32)
        x[:] = x * 2                       # the whole array
        return x, row, x[rows]             # an NDArray key

    got, want = _both(run, A.copy(), np.array([0, 2]))
    for g, w in zip(got, want):
        _close(g.asnumpy(), w.asnumpy())
    with mt.cpu():
        with pytest.raises(ValueError, match="non-unit"):
            mt.nd.array(A)[0:3:2]


def test_outputs_are_new_arrays():
    """Op and method results never share storage with their inputs (torch
    would return views): writing to one leaves the source alone, as the
    JAX package's new arrays do; basic indexing is the one view."""
    def run(x):
        outs = [x.reshape((2, -1)), x.T, x.broadcast_to((3, 4)),
                x.copy(), x.astype("float32"), mt_or_mx(x).Reshape(
                    x, shape=(4, 3)), mt_or_mx(x).BlockGrad(x),
                mt_or_mx(x).identity(x)]
        for o in outs:
            o[:] = 0.0
        return [x] + outs

    def mt_or_mx(x):
        return mt.nd if isinstance(x, mt.nd.NDArray) else mx.nd

    got, want = _both(run, A)
    for g, w in zip(got, want):
        _close(g.asnumpy(), w.asnumpy())
    np.testing.assert_array_equal(got[0].asnumpy(), A)


def test_scalar_methods_and_properties():
    def run(x):
        s = x[0:1, 0:1]
        return (x.shape, x.ndim, x.size, len(x), str(x.context),
                float(s.asscalar()), bool(x[0:1, 0:1] > 0), x.T.shape)

    got, want = _both(run, A)
    assert got == want
    with mt.cpu():
        with pytest.raises(ValueError):
            bool(mt.nd.array(A) > 0)
        x = mt.nd.array(A)
        assert x.as_in_context(mt.cpu()) is x
        y = x.copyto(mt.cpu())
        assert y is not x and np.array_equal(y.asnumpy(), A)
        z = mt.nd.zeros(A.shape)
        assert x.copyto(z) is z and np.array_equal(z.asnumpy(), A)
        x.wait_to_read()


CONSTRUCTORS = {
    "zeros": lambda nd, c: nd.zeros((2, 3), ctx=c),
    "zeros_int": lambda nd, c: nd.zeros(4, ctx=c, dtype="int32"),
    "ones": lambda nd, c: nd.ones((2, 3), ctx=c, dtype=np.float16),
    "full": lambda nd, c: nd.full((3,), 2.5, ctx=c),
    "empty": lambda nd, c: nd.empty((2, 2), ctx=c),
    "arange": lambda nd, c: nd.arange(1, 7, 1.5, ctx=c),
    "arange_repeat": lambda nd, c: nd.arange(4, repeat=2, ctx=c,
                                             dtype="int32"),
    "array_f64": lambda nd, c: nd.array(A.astype(np.float64), ctx=c),
    "array_dtype": lambda nd, c: nd.array(A, ctx=c, dtype="float64"),
    "concatenate": lambda nd, c: nd.concatenate(
        [nd.array(A, ctx=c), nd.array(B, ctx=c)]),
    "concatenate_axis": lambda nd, c: nd.concatenate(
        [nd.array(A, ctx=c), nd.array(A, ctx=c)], axis=1),
    "onehot_encode": lambda nd, c: nd.onehot_encode(
        nd.array([1, 0, 3], ctx=c), nd.zeros((3, 4), ctx=c)),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors(name):
    want = CONSTRUCTORS[name](mx.nd, mx.cpu())
    got = CONSTRUCTORS[name](mt.nd, mt.cpu())
    assert got.context == mt.cpu()
    _close(got.asnumpy(), want.asnumpy())
    mt.nd.waitall()


def test_dispatch_out_aux_visible_variadic_keywords():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 3, 2, 2).astype(np.float32)
    gamma, beta = rng.rand(3).astype(np.float32) + 0.5, np.zeros(3, "f")
    w, b = rng.randn(5, 3).astype(np.float32), rng.randn(5).astype("f")

    def run(pkg):
        nd = pkg.nd
        xs = nd.array(x)
        mm, mv = nd.zeros((3,)), nd.ones((3,))
        with pkg.autograd.record():
            bn = nd.BatchNorm(xs, nd.array(gamma), nd.array(beta), mm, mv,
                              fix_gamma=False)
        three = nd.BatchNorm(xs, nd.array(gamma), nd.array(beta), mm, mv,
                             output_mean_var=True)
        dst = nd.zeros((4, 5))
        res = nd.FullyConnected(nd.Flatten(xs[:, :, 0, 0]), weight=nd.array(w),
                                bias=nd.array(b), num_hidden=5, out=dst)
        by_name = nd.FullyConnected(data=nd.array(x[:, :, 0, 0]),
                                    bias=nd.array(b), weight=nd.array(w),
                                    num_hidden=5)
        return [bn, mm, mv] + list(three) + [
            dst, by_name, nd.add_n(xs, xs, xs),
            nd.Concat(xs, xs, dim=0), nd.Dropout(xs, p=0.5)], res is dst

    want, want_same = run(mx)
    with mt.cpu():
        got, got_same = run(mt)
    assert got_same and want_same
    assert len(got) == len(want) == 11
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w_.asnumpy(), rtol=1e-5,
                                   atol=1e-6)


N_DRAWS = 20000


def _draw(pkg, op, attrs, params, seed):
    pkg.random.seed(seed)
    nd = pkg.nd
    if params:
        out = getattr(nd, op)(*[nd.array(np.float32(p)) for p in params],
                              shape=(N_DRAWS,), **attrs)
    else:
        out = getattr(nd, op)(shape=(N_DRAWS,), **attrs)
    return out.asnumpy().reshape(-1, N_DRAWS)


@pytest.mark.parametrize("op", sorted(SAMPLERS))
def test_samplers_repeat_and_match_moments(op):
    attrs, params = SAMPLERS[op]
    want = _draw(mx, op, attrs, params, 0)
    with mt.cpu():
        got = _draw(mt, op, attrs, params, 5)
        again = _draw(mt, op, attrs, params, 5)
        other = _draw(mt, op, attrs, params, 6)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, again) and not np.array_equal(got, other)
    for g, w in zip(got, want):
        se = np.sqrt((g.var() + w.var()) / N_DRAWS)
        assert abs(g.mean() - w.mean()) <= 6 * se, (g.mean(), w.mean())
        # the variance of a variance estimate: (m4 - var^2) / N
        m4 = np.mean((w - w.mean()) ** 4)
        se_var = np.sqrt(2 * max(m4 - w.var() ** 2, 1e-12) / N_DRAWS)
        assert abs(g.var() - w.var()) <= 6 * se_var, (g.var(), w.var())
    # the symbol: the same JSON and shapes, and a bound forward's draw
    shapes = {"p%d" % i: (len(p),) for i, p in enumerate(params)}
    syms = [getattr(pkg.sym, op)(*[pkg.sym.Variable(n) for n in shapes],
                                 shape=(3,), name="op0", **attrs)
            for pkg in (mx, mt)]
    assert syms[1].tojson() == syms[0].tojson()
    assert syms[1].infer_shape(**shapes) == syms[0].infer_shape(**shapes)
    exe = syms[1].simple_bind(mt.cpu(), grad_req="null", **shapes)
    for n, p in zip(shapes, params):
        exe.arg_dict[n][:] = np.float32(p)
    assert exe.forward()[0].shape == syms[0].infer_shape(**shapes)[1][0]


def test_seed_repeats_dropout_and_numpy():
    with mt.cpu():
        x = mt.nd.ones((50, 50))
        masks = []
        for _ in range(2):
            mt.random.seed(9)
            first = np.random.rand()
            with mt.autograd.record():
                masks.append(mt.nd.Dropout(x, p=0.5).asnumpy())
        assert np.random.RandomState(9).rand() == first
    assert np.array_equal(masks[0], masks[1])
    assert 0.3 < (masks[0] == 0).mean() < 0.7


def test_test_utils_checks():
    rng = np.random.RandomState(4)
    s = mt.sym
    net = s.tanh(s.FullyConnected(s.Variable("x"), num_hidden=3,
                                  name="fc"))
    loc = {"x": rng.randn(2, 4), "fc_weight": 0.5 * rng.randn(3, 4),
           "fc_bias": rng.randn(3)}
    with mt.cpu():
        tu.check_numeric_gradient(net, loc, numeric_eps=1e-3, rtol=1e-2,
                                  atol=1e-3)
        y = np.tanh(loc["x"] @ loc["fc_weight"].T + loc["fc_bias"])
        tu.check_symbolic_forward(net, loc, [y], rtol=1e-5, atol=1e-6)
        head = rng.randn(2, 3)
        dz = head * (1 - y ** 2)
        for req in ("write", "add"):
            tu.check_symbolic_backward(
                net, loc, [head], {"x": dz @ loc["fc_weight"],
                                   "fc_weight": dz.T @ loc["x"],
                                   "fc_bias": dz.sum(0)},
                rtol=1e-4, atol=1e-5, grad_req=req)
        _close(tu.simple_forward(net, **loc), y.astype(np.float32), 1e-5)
        tu.check_consistency(net, [
            {"ctx": mt.cpu(), "x": (2, 4)},
            {"ctx": mt.cpu(), "x": (2, 4),
             "type_dict": {"x": "float64", "fc_weight": "float64",
                           "fc_bias": "float64"}}])
        with pytest.raises(AssertionError, match="differ beyond"):
            tu.assert_almost_equal(np.ones(3), np.array([1, 1, 1.1]))
