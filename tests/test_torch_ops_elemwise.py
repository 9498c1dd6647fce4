"""The port's elementwise ops (``mxnet_tpu_torch/ops/elemwise.py``)
against the JAX package's, through both packages' imperative front end.

Every case runs the op on the same seeded numpy inputs in both
packages and holds the forward (values and dtype) and the gradient of
every marked input under the same seeded head gradient.  The port runs
its imperative front end: ``nd.<op>(*arrays, **attrs)`` under
``autograd.record()`` with the inputs marked, then ``autograd.backward``.
The JAX side runs the registry op's ``fcompute`` under one jitted
``jax.vjp`` — what its ``autograd`` replays, at one compile a case
instead of one a primitive (its imperative autograd itself is held in
``test_torch_autograd.py``).  Every case also builds ``sym.<op>`` over
named variables in both packages and holds ``tojson`` (byte for byte),
``infer_shape`` and ``infer_type`` alike, and runs the port's through
``simple_bind`` and a forward (bit for bit with the imperative one).  :func:`run_case` is the
harness; ``test_torch_ops_tensor.py`` and ``test_torch_ops_nn.py`` use
it too.

The cases are ``test_torch_op_cases.py``'s.  Tolerances (``TOL``: rtol
1e-5, atol 1e-6 on values and gradients): both sides compute in f32
with the same formulas, so they differ by a few ulp where the
libraries' transcendental functions round differently (XLA's and ATen's
``lgamma``, ``erf``, ``tan`` ...).  Inputs keep away from kinks (0 for
``abs`` / ``relu`` / ``sign``, .5 for the roundings, ties for
``maximum``), where the two libraries' subgradients may differ.
"""
import jax
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import registry as treg
from test_torch_op_cases import (ELEMWISE, NEW_NAMES, case_ops, heads,
                                 run_port)

TOL = (1e-5, 1e-6)


def _jax_run(op, arrays, attrs, grad, head_seed):
    """The JAX op's visible outputs and, for the inputs ``grad``, its VJP
    of the seeded heads, in one jitted program."""
    opdef = jreg.get_op(op)
    raw = dict(attrs)
    if opdef.key_var_num_args:
        raw.setdefault(opdef.key_var_num_args, str(len(arrays)))
    parsed = opdef.parse_attrs(raw)
    n_vis = opdef.n_visible_outputs(parsed)

    def fwd(*xs):
        outs, _ = opdef.fcompute(parsed, list(xs), [],
                                 jreg.OpContext(is_train=True))
        return list(outs[:n_vis])

    if not grad:
        return [np.asarray(o) for o in jax.jit(fwd)(*arrays)], []
    hs = heads([o.shape for o in jax.eval_shape(fwd, *arrays)], head_seed)

    def both(xs, hs):
        outs, vjp = jax.vjp(fwd, *xs)
        return outs, vjp(hs)

    outs, grads = jax.jit(both)(list(arrays), hs)
    return [np.asarray(o) for o in outs], \
        [np.asarray(grads[i]) for i in grad]


def _symbol(pkg, op, arrays, attrs):
    sym = pkg.sym
    names = ["in%d" % i for i in range(len(arrays))]
    s = getattr(sym, op)(*[sym.Variable(n) for n in names], name="op0",
                         **attrs)
    shapes = {n: a.shape for n, a in zip(names, arrays)}
    types = {n: a.dtype for n, a in zip(names, arrays)}
    _, out_shapes, _ = s.infer_shape(**shapes)
    _, out_types, _ = s.infer_type(**types)
    return s.tojson(), [tuple(x) for x in out_shapes], \
        [str(np.dtype(t)) if not str(t).endswith("bfloat16") else
         "bfloat16" for t in out_types]


def _port_bound(op, arrays, attrs):
    """The port's symbol through ``simple_bind`` on the host and one
    training forward: the executor's path to the same ``fcompute``."""
    names = ["in%d" % i for i in range(len(arrays))]
    s = getattr(mt.sym, op)(*[mt.sym.Variable(n) for n in names],
                            name="op0", **attrs)
    exe = s.simple_bind(mt.cpu(), grad_req="null",
                        type_dict={n: a.dtype for n, a in zip(names, arrays)},
                        **{n: a.shape for n, a in zip(names, arrays)})
    for n, a in zip(names, arrays):
        exe.arg_dict[n][:] = a
    return [o.asnumpy() for o in exe.forward(is_train=True)]


def run_case(op, arrays, attrs=None, grad=(), tol=TOL, symbol=True,
             head_seed=0):
    """Hold ``nd.<op>(*arrays, **attrs)`` and its gradient to the
    inputs ``grad`` (indices) in the port against the JAX package, and
    (``symbol``) the symbol's JSON, shapes and types, and the port's
    bound symbol's forward against its imperative one, bit for bit."""
    attrs = dict(attrs or {})
    want, want_g = _jax_run(op, arrays, attrs, grad, head_seed)
    got, got_g = run_port(op, arrays, attrs, grad, mt.cpu(), head_seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (op, g.dtype, w.dtype)
        assert g.shape == w.shape, (op, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                                   err_msg="%s forward" % op)
    for i, g, w in zip(grad, got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                                   err_msg="%s gradient of input %d"
                                   % (op, i))
    if symbol:
        jjson, jshapes, jtypes = _symbol(mx, op, arrays, attrs)
        tjson, tshapes, ttypes = _symbol(mt, op, arrays, attrs)
        assert tjson == jjson
        assert tshapes == jshapes == [o.shape for o in want][:len(jshapes)]
        assert ttypes == jtypes
        for b, g in zip(_port_bound(op, arrays, attrs), got):
            np.testing.assert_array_equal(b, g)


@pytest.mark.parametrize("case", sorted(ELEMWISE))
def test_elemwise_op(case):
    op, arrays, attrs, grad = ELEMWISE[case]
    run_case(op, arrays, attrs, grad=grad)


@pytest.mark.parametrize("alias,op", [("cast", "Cast"),
                                      ("identity", "_copy"),
                                      ("stop_gradient", "BlockGrad"),
                                      ("_sum", "add_n")])
def test_alias_runs_as_its_op(alias, op):
    case = next(c for c in ELEMWISE.values() if c[0] == op)
    run_case(alias, *case[1:3], grad=case[3])


def test_every_reference_op_is_ported_under_its_names():
    """The registries differ by exactly the names left for the
    parallelism slice (ops/moe.py's MoEFFN), and every other name of the
    reference is an alias of the same op in both packages."""
    later = {"MoEFFN", "_contrib_MoEFFN"}
    # user kernels other tests register at run time (mx.rtc) are not
    # the package's
    ref = {n for n in jreg.list_ops() if not jreg.get_op(n).user_defined}
    port = set(treg.list_ops())
    assert len(later) == 2
    assert ref - port == later
    assert port <= ref
    for name in sorted(port):
        assert treg.get_op(name).name == jreg.get_op(name).name, name
        assert treg.get_op(name).hint == jreg.get_op(name).hint, name
    # the slice's 163 names: every op they name runs in a case
    assert len(NEW_NAMES) == 163 and set(NEW_NAMES) <= port
    ran = {id(treg.get_op(n)) for n in case_ops()}
    assert [n for n in NEW_NAMES if id(treg.get_op(n)) not in ran] == []
