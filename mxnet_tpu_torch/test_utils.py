"""Numerics-testing toolkit (counterpart of ``mxnet_tpu/test_utils.py``):
finite-difference gradient checks, forward / backward checks against
numpy references, and cross-context consistency.

:func:`default_context` is the card (:func:`~mxnet_tpu_torch.context.
current_context`: the innermost ``with ctx:`` scope, else ``gpu(0)``),
so the checks run on the host only under ``with cpu():`` or given
``ctx=cpu()``.  ``check_consistency`` compares every configuration
against the widest-dtype one — on one card with a CPU, "cpu vs gpu" is
the oracle pair.  The reference's ``check_speed`` and
``assert_chrome_trace`` are not ported (they wait for the profiler).
"""
from __future__ import annotations

import logging

import numpy as np

from . import ndarray as nd
from . import symbol as sym_mod
from .context import current_context

__all__ = ["default_context", "default_dtype", "random_arrays",
           "rand_ndarray", "rand_shape_2d", "rand_shape_3d", "np_reduce",
           "same", "reldiff", "almost_equal", "assert_almost_equal",
           "simple_forward", "numeric_grad", "check_numeric_gradient",
           "check_symbolic_forward", "check_symbolic_backward",
           "check_consistency"]

_rng = np.random.RandomState(1234)


def default_context():
    return current_context()


def default_dtype():
    return np.float32


def random_arrays(*shapes):
    """Random float32 arrays (a scalar np.float32 for 0-d shapes)."""
    out = [_rng.standard_normal(s).astype(default_dtype()) if s
           else np.float32(_rng.standard_normal()) for s in shapes]
    return out[0] if len(out) == 1 else out


def rand_ndarray(shape, dtype=np.float32):
    return nd.array(_rng.standard_normal(shape).astype(dtype))


def rand_shape_2d(dim0=10, dim1=10):
    return tuple(_rng.randint(1, d + 1) for d in (dim0, dim1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return tuple(_rng.randint(1, d + 1) for d in (dim0, dim1, dim2))


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """A numpy reduction with MXNet's axis / keepdims semantics."""
    axes = ((axis,) if isinstance(axis, int)
            else tuple(axis) if axis is not None
            else tuple(range(dat.ndim)))
    out = numpy_reduce_func(dat, axis=axes)
    if keepdims:
        shape = tuple(1 if i in axes else s for i, s in enumerate(dat.shape))
        out = np.asarray(out).reshape(shape)
    return out


def same(a, b):
    return np.array_equal(a, b)


def reldiff(a, b):
    """L1 relative difference in [0, 1]."""
    num = np.abs(a - b).sum()
    den = np.abs(a).sum() + np.abs(b).sum()
    return 0.0 if num == 0 else float(num / den)


def _to_numpy(x):
    return x.asnumpy() if isinstance(x, nd.NDArray) else np.asarray(x)


def almost_equal(a, b, rtol=1e-5, atol=1e-20):
    return np.allclose(_to_numpy(a), _to_numpy(b), rtol=rtol, atol=atol)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b")):
    """np.allclose with an error report locating the worst element."""
    a, b = _to_numpy(a), _to_numpy(b)
    if np.allclose(a, b, rtol=rtol, atol=atol):
        return
    err = np.abs(a - b)
    worst = np.unravel_index(int(np.argmax(err)), err.shape) if err.ndim \
        else ()
    raise AssertionError(
        "%s and %s differ beyond rtol=%g atol=%g: max |diff| = %g at %s "
        "(%s=%s, %s=%s)" % (names[0], names[1], rtol, atol, err.max(),
                            worst, names[0], a[worst], names[1], b[worst]))


def _named_arrays(names, values, ctx, what):
    """A dict or sequence of inputs as {name: NDArray on ctx}."""
    if values is None:
        return None
    if isinstance(values, dict):
        if set(values) != set(names):
            raise ValueError("%s mismatch: symbol wants %s, got %s"
                             % (what, sorted(names), sorted(values)))
        pairs = values.items()
    else:
        pairs = zip(names, values)
    return {k: v if isinstance(v, nd.NDArray) else nd.array(v, ctx=ctx)
            for k, v in pairs}


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    """One forward pass on numpy inputs; numpy output(s)."""
    ctx = ctx or default_context()
    args = {k: nd.array(v, ctx=ctx) for k, v in inputs.items()}
    outs = [o.asnumpy()
            for o in sym.bind(ctx, args=args,
                              grad_req="null").forward(is_train=is_train)]
    return outs[0] if len(outs) == 1 else outs


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True):
    """Central-difference gradient of ``sum(outputs[0])`` with respect to
    each float input; the argument is restored after its sweep."""
    aux_states = aux_states or {}

    def objective(name, perturbed):
        executor.arg_dict[name][:] = perturbed
        for aux_name, aux_val in aux_states.items():
            executor.aux_dict[aux_name][:] = aux_val
        executor.forward(is_train=use_forward_train)
        return float(executor.outputs[0].asnumpy().astype(np.float64).sum())

    for name, value in location.items():
        executor.arg_dict[name][:] = value

    grads = {}
    for name, value in location.items():
        base = np.asarray(value, dtype=np.float64).reshape(-1)
        grads[name] = np.zeros(np.shape(value), np.float32)
        if np.asarray(value).dtype.kind != "f":
            continue
        flat_grad = grads[name].reshape(-1)
        shape = np.shape(value)
        for i in range(base.size):
            probe = base.copy()
            probe[i] += eps / 2.0
            hi = objective(name, probe.reshape(shape))
            probe[i] -= eps
            lo = objective(name, probe.reshape(shape))
            flat_grad[i] = (hi - lo) / eps
        executor.arg_dict[name][:] = value
    return grads


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None):
    """Assert the symbolic backward matches central differences; the
    output is projected to a scalar by a fixed random projection, so
    every output element counts."""
    ctx = ctx or default_context()
    atol = atol if atol is not None else 1e-4
    location = _named_arrays(sym.list_arguments(), location, ctx, "location")
    aux_states = _named_arrays(sym.list_auxiliary_states(), aux_states, ctx,
                               "aux_states")
    host_location = {k: v.asnumpy() for k, v in location.items()}
    host_aux = {k: v.asnumpy() for k, v in aux_states.items()} \
        if aux_states else None

    if grad_nodes is None:
        grad_req = {k: "write" for k in sym.list_arguments()}
    elif isinstance(grad_nodes, dict):
        grad_req = dict(grad_nodes)
    else:
        grad_req = {k: "write" for k in grad_nodes}

    _, out_shapes, _ = sym.infer_shape(
        **{k: v.shape for k, v in location.items()})
    call_rng = np.random.RandomState(1234)
    proj_value = call_rng.uniform(0.1, 1.1, out_shapes[0])
    scalar = sym_mod.MakeLoss(
        sym_mod.sum(sym * sym_mod.Variable("__random_proj")))

    bind_args = dict(location)
    bind_args["__random_proj"] = nd.array(proj_value, ctx=ctx)
    seed_grads = {k: call_rng.normal(0, 0.01, bind_args[k].shape)
                  for k in list(grad_req) + ["__random_proj"]}
    grad_req["__random_proj"] = grad_req.get("__random_proj", "write")
    exe = scalar.bind(ctx, args=bind_args,
                      args_grad={k: nd.array(v, ctx=ctx)
                                 for k, v in seed_grads.items()},
                      grad_req=grad_req, aux_states=aux_states)
    exe.forward(is_train=True)
    exe.backward()

    fd = numeric_grad(exe, host_location, host_aux, eps=numeric_eps,
                      use_forward_train=use_forward_train)
    for name, req in grad_req.items():
        if name == "__random_proj":
            continue
        got = exe.grad_dict[name].asnumpy()
        if req == "null":
            assert_almost_equal(seed_grads[name], got, rtol, atol)
        elif req == "add":
            assert_almost_equal(fd[name], got - seed_grads[name], rtol, atol,
                                ("NUMERIC_%s" % name, "SYMBOLIC_%s" % name))
        elif req == "write":
            assert_almost_equal(fd[name], got, rtol, atol,
                                ("NUMERIC_%s" % name, "SYMBOLIC_%s" % name))
        else:
            raise ValueError("unknown grad_req %r for %s" % (req, name))


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=None,
                           aux_states=None, ctx=None):
    """Assert the forward outputs match expected numpy arrays."""
    ctx = ctx or default_context()
    location = _named_arrays(sym.list_arguments(), location, ctx, "location")
    aux_states = _named_arrays(sym.list_auxiliary_states(), aux_states, ctx,
                               "aux_states")
    if isinstance(expected, dict):
        expected = [expected[k] for k in sym.list_outputs()]
    exe = sym.bind(ctx, args=location,
                   args_grad={k: nd.zeros(v.shape, ctx=ctx)
                              for k, v in location.items()},
                   aux_states=aux_states)
    exe.forward()
    for name, want, got in zip(sym.list_outputs(), expected, exe.outputs):
        assert_almost_equal(want, got, rtol, atol if atol is not None
                            else 1e-5,
                            ("EXPECTED_%s" % name, "FORWARD_%s" % name))
    return exe.outputs


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None):
    """Assert the backward gradients (from ``out_grads``) match expected
    numpy arrays; "add" is checked against the seeded buffers."""
    ctx = ctx or default_context()
    atol = atol if atol is not None else 1e-8
    location = _named_arrays(sym.list_arguments(), location, ctx, "location")
    aux_states = _named_arrays(sym.list_auxiliary_states(), aux_states, ctx,
                               "aux_states")
    if not isinstance(expected, dict):
        expected = dict(zip(sym.list_arguments(), expected))
    if isinstance(grad_req, str):
        grad_req = {k: grad_req for k in location}
    elif not isinstance(grad_req, dict):
        grad_req = dict(zip(location, grad_req))

    seed = {k: _rng.standard_normal(location[k].shape) for k in expected}
    exe = sym.bind(ctx, args=location,
                   args_grad={k: nd.array(v, ctx=ctx)
                              for k, v in seed.items()},
                   aux_states=aux_states, grad_req=grad_req)
    exe.forward(is_train=True)
    if isinstance(out_grads, dict):
        out_grads = [out_grads[k] for k in sym.list_outputs()]
    if isinstance(out_grads, (list, tuple)):
        out_grads = [g if isinstance(g, nd.NDArray) else nd.array(g, ctx=ctx)
                     for g in out_grads]
    exe.backward(out_grads)

    for name, want in expected.items():
        got = exe.grad_dict[name].asnumpy()
        req = grad_req[name]
        if req == "null":
            assert_almost_equal(seed[name], got, rtol, atol)
        elif req == "add":
            assert_almost_equal(want, got - seed[name], rtol, atol,
                                ("EXPECTED_%s" % name, "BACKWARD_%s" % name))
        elif req == "write":
            assert_almost_equal(want, got, rtol, atol,
                                ("EXPECTED_%s" % name, "BACKWARD_%s" % name))
        else:
            raise ValueError("unknown grad_req %r for %s" % (req, name))
    return exe.grad_arrays


# tolerance and width by dtype name (bfloat16: 7 mantissa bits)
_CONSISTENCY_TOL = {"float16": 1e-1, "bfloat16": 1e-1, "float32": 1e-3,
                    "float64": 1e-5, "uint8": 0, "int32": 0}
_WIDTH = {"uint8": 0, "int32": 1, "bfloat16": 2, "float16": 3,
          "float32": 4, "float64": 5}


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True, ground_truth=None):
    """Run the same symbol in several context / dtype configurations and
    compare every output and gradient against the widest-dtype run (or
    ``ground_truth``).  Each ``ctx_list`` entry is ``simple_bind``'s
    keyword arguments (``ctx``, the input shapes, ``type_dict``)."""
    if tol is None:
        tol = dict(_CONSISTENCY_TOL)
    elif isinstance(tol, float):
        tol = {dt: tol for dt in _CONSISTENCY_TOL}
    else:
        tol = {nd.dtype_name(k): v for k, v in tol.items()}

    syms = list(sym) if isinstance(sym, (list, tuple)) \
        else [sym] * len(ctx_list)
    assert len(syms) == len(ctx_list) >= 2
    out_names = syms[0].list_outputs()
    arg_names = syms[0].list_arguments()
    exes = [s.simple_bind(grad_req=grad_req, **cfg)
            for s, cfg in zip(syms, ctx_list)]

    arg_params = dict(arg_params or {})
    for name, arr in exes[0].arg_dict.items():
        arg_params.setdefault(name,
                              _rng.normal(size=arr.shape, scale=scale))
    aux_params = dict(aux_params or {})
    for name in exes[0].aux_dict:
        aux_params.setdefault(name, 0)
    for exe in exes:
        for name, arr in exe.arg_dict.items():
            arr[:] = arg_params[name]
        for name, arr in exe.aux_dict.items():
            arr[:] = aux_params[name]

    def compare(collect, oracle):
        for i, exe in enumerate(exes):
            if i == oracle_idx and ground_truth is None:
                continue
            bound = tol[dtypes[i]]
            for name, got in collect(exe).items():
                if name not in oracle:
                    continue
                try:
                    assert_almost_equal(got, oracle[name], rtol=bound,
                                        atol=bound,
                                        names=("ctx%d_%s" % (i, name),
                                               "oracle_%s" % name))
                except AssertionError:
                    if raise_on_err:
                        raise
                    logging.warning("check_consistency mismatch (ctx %d, "
                                    "%s)", i, name, exc_info=True)

    def collect_outputs(exe):
        return {n: o.asnumpy() for n, o in zip(out_names, exe.outputs)}

    def collect_all(exe):
        named = dict(zip(out_names, exe.outputs))
        named.update({n: g for n, g in zip(arg_names, exe.grad_arrays)
                      if g is not None})
        return {k: v.asnumpy() for k, v in named.items()}

    # eval-mode forward first: train-only randomness stays out of it
    for exe in exes:
        exe.forward(is_train=False)
    dtypes = [nd.dtype_name(exe.outputs[0].data.dtype) for exe in exes]
    oracle_idx = max(range(len(exes)), key=lambda i: _WIDTH[dtypes[i]])
    oracle = ground_truth or collect_outputs(exes[oracle_idx])
    compare(collect_outputs, oracle)

    if grad_req != "null":
        for exe in exes:
            exe.forward(is_train=True)
            exe.backward()
        oracle = ground_truth or collect_all(exes[oracle_idx])
        compare(collect_all, oracle)
    return oracle
