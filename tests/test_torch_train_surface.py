"""The port's training surface beyond the model zoo — the optimizers
AdaGrad, RMSProp (plain and centered), AdaDelta, Ftrl, SGLD, DCASGD and
Test, the five optimizer update ops, the initializers Orthogonal,
MSRAPrelu, Bilinear, Load and Mixed, the metrics F1, Torch, Caffe,
CustomMetric and ``np_metric``, and the iterators MNISTIter, CSVIter,
ResizeIter and PrefetchingIter — held against the JAX package on the
same numpy inputs, on the CPU.

Tolerances:

* each optimizer's eager ``update`` over 3 steps: weights and states
  within 1e-6 of max(1, their magnitude) (the same f32 operations in
  the same order; measured 0 for AdaGrad, DCASGD and Test, up to 6e-8
  for RMSProp, AdaDelta and Ftrl);
* AdaGrad and RMSProp through the port's compiled step (its
  per-parameter path) against the JAX Module's fused step, and AdaDelta
  and Ftrl through both eager updates, 3 steps of a conv / BatchNorm /
  FC net: parameters 1e-5 absolute (the forward and backward in another
  summation order, and the JAX fused step rounds RMSProp's ``1 - rho``
  in f32 where the eager bodies round it from a Python float; measured
  up to 2.8e-6); the port's compiled step against its own eager update
  bit for bit;
* SGLD's noise cannot match torch's generators to jax's: the step minus
  its drift is N(0, lr) (mean within 4 standard errors of 0, standard
  deviation within 2% of sqrt(lr) over 200,000 draws) and repeats from
  a seed bit for bit;
* the update ops, deterministic initializers, metrics and iterators
  exactly (the same arithmetic or the same numpy arrays); the random
  initializers by their properties (Q^T Q = scale^2 I to 1e-6,
  MSRAPrelu's standard deviation within 2% of the formula's).
"""
import gzip
import json
import os
import pickle
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import config as jconfig
from mxnet_tpu import initializer as jinit
from mxnet_tpu import io as jio
from mxnet_tpu import metric as jmetric
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.registry import OpContext as JOpContext
from mxnet_tpu.registry import get_op as jget_op

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ndarray import NDArray
from mxnet_tpu_torch.ops import update_kernel as uk
from mxnet_tpu_torch.registry import OpContext, get_op


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    """Arrays made without a context go to the host: the port's default
    context is the card."""
    with mt.cpu():
        yield


torch.set_num_threads(1)

TOL_EAGER = 1e-6
TOL_STEP = 1e-5


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return list(state)
    return [state]


def _host(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return a.asnumpy()


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTIMIZERS = [
    ("adagrad", {"learning_rate": 0.1, "wd": 1e-3}),
    ("adagrad", {"learning_rate": 0.05, "eps": 1e-5, "clip_gradient": 0.5,
                 "rescale_grad": 0.5}),
    ("rmsprop", {"learning_rate": 0.01, "wd": 1e-3}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True, "gamma1": 0.95,
                 "gamma2": 0.8, "clip_weights": 0.9}),
    ("rmsprop", {"learning_rate": 0.01, "clip_gradient": 0.3,
                 "clip_weights": 0.9}),
    ("adadelta", {"wd": 1e-3}),
    ("adadelta", {"rho": 0.5, "epsilon": 1e-3, "clip_gradient": 0.5}),
    ("ftrl", {"wd": 1e-3}),
    ("ftrl", {"lamda1": 0.5, "learning_rate": 0.5, "beta": 2}),
    ("dcasgd", {"learning_rate": 0.1, "wd": 1e-3}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "lamda": 0.5}),
    ("test", {"rescale_grad": 0.5}),
]


def _opt_inputs(seed=0, shape=(5, 7)):
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    grads = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    return w, grads


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(OPTIMIZERS)])
def test_eager_update_matches_jax(name, kw):
    """Three eager ``update`` calls on the same weight, gradients and
    hyperparameters: the weight and every state array."""
    w0, grads = _opt_inputs()
    jo = jopt.create(name, **kw)
    jw = mx.nd.array(w0)
    jst = jo.create_state(0, jw)
    to = topt.create(name, **kw)
    tw = NDArray(torch.from_numpy(w0.copy()))
    tst = to.create_state(0, tw)
    for g in grads:
        jo.update(0, jw, mx.nd.array(g), jst)
        to.update(0, tw, NDArray(torch.from_numpy(g.copy())), tst)
    pairs = [(tw.asnumpy(), jw.asnumpy())] + list(zip(
        [_host(s) for s in _flat(tst)], [_host(s) for s in _flat(jst)]))
    assert len(_flat(tst)) == len(_flat(jst))
    for got, want in pairs:
        if want is None:
            assert got is None
            continue
        assert got.dtype == np.float32
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= TOL_EAGER * scale
    assert to.num_update == jo.num_update
    assert (to.fused_kernel() is None) == (jo.fused_kernel() is None)
    np.testing.assert_array_equal(to.fused_extra(), jo.fused_extra())


def test_sgld_is_half_a_step_plus_gaussian_noise():
    """SGLD: w' - (w - lr / 2 * (g + wd * w)) is N(0, lr), drawn from
    torch's default generator: the same seed repeats the step bit for
    bit, another seed does not."""
    lr, wd, n = 0.04, 0.01, 200_000
    rng = np.random.RandomState(1)
    w0 = rng.randn(n).astype(np.float32)
    g = rng.randn(n).astype(np.float32)

    def step(seed):
        torch.manual_seed(seed)
        opt = topt.create("sgld", learning_rate=lr, wd=wd)
        w = NDArray(torch.from_numpy(w0.copy()))
        opt.update(0, w, NDArray(torch.from_numpy(g)),
                   opt.create_state(0, w))
        return w.asnumpy()

    a, b, c = step(3), step(3), step(4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    noise = a.astype(np.float64) - (w0 - lr / 2 * (g + wd * w0))
    assert abs(noise.mean()) <= 4 * np.sqrt(lr / n)
    assert abs(noise.std() / np.sqrt(lr) - 1) <= 0.02


def _sym(pkg):
    s = pkg.sym
    net = s.Convolution(s.Variable("data"), num_filter=4, kernel=(3, 3),
                        pad=(1, 1), name="conv")
    net = s.BatchNorm(net, fix_gamma=False, name="bn")
    net = s.Activation(net, act_type="tanh", name="act")
    net = s.Pooling(net, kernel=(6, 6), pool_type="avg", global_pool=True,
                    name="pool")
    net = s.FullyConnected(s.Flatten(net, name="flat"), num_hidden=5,
                           name="fc")
    return s.SoftmaxOutput(net, name="softmax")


def _net_values():
    rng = np.random.RandomState(5)
    sym = _sym(mt)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(4, 3, 6, 6),
                                                softmax_label=(4,))
    args = {n: (0.3 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if n.endswith("_var") else np.zeros(s))
           .astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    batches = [(rng.randn(4, 3, 6, 6).astype(np.float32),
                rng.randint(0, 5, 4).astype(np.float32)) for _ in range(3)]
    return args, aux, batches


def _module(pkg, name, kw, args, aux):
    mod = pkg.mod.Module(_sym(pkg), context=pkg.cpu())
    mod.bind(data_shapes=[("data", (4, 3, 6, 6))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(arg_params={k: pkg.nd.array(v) for k, v in args.items()},
                    aux_params={k: pkg.nd.array(v) for k, v in aux.items()})
    mod.init_optimizer(optimizer=name, optimizer_params=kw)
    return mod


def _train(pkg, mod, batches):
    cls = jio.DataBatch if pkg is mx else tio.DataBatch
    for x, y in batches:
        mod.forward_backward(cls([pkg.nd.array(x)], [pkg.nd.array(y)]))
        mod.update()
    arg, aux = mod.get_params()
    out = {k: v.asnumpy().copy() for k, v in arg.items()}
    out.update({"aux:" + k: v.asnumpy().copy() for k, v in aux.items()})
    return out


@pytest.mark.parametrize("name,kw", [
    ("adagrad", {"learning_rate": 0.1, "wd": 1e-3}),
    ("rmsprop", {"learning_rate": 0.01, "wd": 1e-3, "clip_weights": 0.4}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True,
                 "clip_gradient": 0.5})])
def test_compiled_per_parameter_step_matches_jax(tmp_path, name, kw):
    """AdaGrad and RMSProp train through the compiled step's
    per-parameter path (no slab plan) as the JAX Module's fused step
    does; the port's eager update gives the same values bit for bit; the
    ``.states`` file crosses to the JAX Module and back."""
    args, aux, batches = _net_values()
    with jconfig.overrides(MXNET_PALLAS_UPDATE=False):
        jmod = _module(mx, name, kw, args, aux)
        want = _train(mx, jmod, batches)
    tmod = _module(mt, name, kw, args, aux)
    step = tmod._train_step
    assert step is not None and step.plan is None
    got = _train(mt, tmod, batches)
    assert uk.UPDATE_PATH["last"] == "per_param"
    with mt.config.overrides(MXNET_FUSED_TRAIN_STEP=False):
        emod = _module(mt, name, kw, args, aux)
        assert emod._train_step is None
        eager = _train(mt, emod, batches)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL_STEP,
                                   err_msg=k)
        np.testing.assert_array_equal(got[k], eager[k], err_msg=k)
    # .states across the packages, both ways: name-keyed numpy tuples
    tmod.save_optimizer_states(str(tmp_path / "port.states"))
    jmod.save_optimizer_states(str(tmp_path / "jax.states"))
    port_states = pickle.loads(open(tmp_path / "port.states", "rb").read())
    jax_states = pickle.loads(open(tmp_path / "jax.states", "rb").read())
    assert set(port_states) == set(jax_states)
    for k, v in jax_states.items():
        assert len(port_states[k]) == len(v)
        for a, b in zip(port_states[k], v):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL_STEP)
    with jconfig.overrides(MXNET_PALLAS_UPDATE=False):
        jload = _module(mx, name, kw, args, aux)
        jload.load_optimizer_states(str(tmp_path / "port.states"))
        jback = pickle.loads(jload._fused_step.get_states())
    tload = _module(mt, name, kw, args, aux)
    tload.load_optimizer_states(str(tmp_path / "jax.states"))
    tback = pickle.loads(tload._train_step.get_states())
    for k in port_states:
        for a, b in zip(jback[k], port_states[k]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tback[k], jax_states[k]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kw", [("adadelta", {"wd": 1e-3}),
                                     ("ftrl", {"learning_rate": 0.5})])
def test_eager_only_optimizers_train_and_cross(name, kw):
    """AdaDelta and Ftrl have no fused kernel: both Modules keep the
    eager update; 3 steps agree, and each package's saved states load
    into the other's updater (the JAX package's eager updater pickles its
    own arrays, so its states cross as numpy tuples, converted on the
    JAX side: the port unpickles numpy only)."""
    args, aux, batches = _net_values()
    with jconfig.overrides(MXNET_PALLAS_UPDATE=False):
        jmod = _module(mx, name, kw, args, aux)
        want = _train(mx, jmod, batches)
    tmod = _module(mt, name, kw, args, aux)
    assert tmod._train_step is None
    got = _train(mt, tmod, batches)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL_STEP,
                                   err_msg=k)
    names = dict(enumerate(tmod._exec_group.param_names))
    jpayload = _numpy_states(jmod._updater.get_states())
    tpayload = tmod._updater.get_states()
    tload = _module(mt, name, kw, args, aux)
    tload._updater.set_states(jpayload)
    jload = _module(mx, name, kw, args, aux)
    jload._updater.set_states(tpayload)
    ported = pickle.loads(tpayload)
    for idx, st in tload._updater.states.items():
        for a, b in zip(_flat(st), ported[names[idx]]):
            np.testing.assert_allclose(_host(a), b, rtol=0, atol=TOL_STEP)
    for idx, st in jload._updater.states.items():
        for a, b in zip(_flat(st), _flat(tmod._updater.states[idx])):
            np.testing.assert_array_equal(_host(a), _host(b))


def _numpy_states(payload):
    """The JAX eager updater's payload with its arrays as numpy."""
    return pickle.dumps({k: tuple(_host(a) for a in _flat(v))
                         for k, v in pickle.loads(payload).items()})


def test_states_of_another_package_are_refused_without_importing_it(
        tmp_path):
    """The JAX eager updater's raw payload pickles mxnet_tpu NDArrays:
    the port's Updater and compiled step refuse it with
    ``UnpicklingError`` and import neither mxnet_tpu nor jax (in a fresh
    interpreter); the same states as numpy load."""
    args, aux, batches = _net_values()
    with jconfig.overrides(MXNET_PALLAS_UPDATE=False):
        jmod = _module(mx, "adadelta", {}, args, aux)
        _train(mx, jmod, batches[:1])
    raw = jmod._updater.get_states()
    assert b"mxnet_tpu" in raw
    (tmp_path / "raw.states").write_bytes(raw)
    (tmp_path / "numpy.states").write_bytes(_numpy_states(raw))
    code = (
        "import json, pickle, sys, types\n"
        "from mxnet_tpu_torch import optimizer as topt\n"
        "from mxnet_tpu_torch.train_step import CompiledTrainStep\n"
        "raw = open(%r, 'rb').read()\n"
        "step = types.SimpleNamespace(_param_names=[],\n"
        "                             import_updater_states=print)\n"
        "refused = []\n"
        "for load in (topt.Updater(topt.AdaDelta()).set_states,\n"
        "             lambda p: CompiledTrainStep.set_states(step, p)):\n"
        "    try:\n"
        "        load(raw)\n"
        "    except pickle.UnpicklingError as e:\n"
        "        refused.append('mxnet_tpu' in str(e))\n"
        "upd = topt.Updater(topt.AdaDelta())\n"
        "upd.set_states(open(%r, 'rb').read())\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m == "
        "'mxnet_tpu' or m.startswith(('jax.', 'jaxlib', 'mxnet_tpu.')))\n"
        "print(json.dumps([refused, sorted(upd.states), bad]))\n"
        % (str(tmp_path / "raw.states"), str(tmp_path / "numpy.states")))
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    refused, keys, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert refused == [True, True]
    assert keys == sorted(jmod._updater.states)
    assert bad == []


# ---------------------------------------------------------------------------
# the update ops
# ---------------------------------------------------------------------------

UPDATE_OPS = [
    ("sgd_update", 2, {"lr": "0.1", "wd": "0.01"}),
    ("sgd_update", 2, {"lr": "0.1", "rescale_grad": "0.5",
                       "clip_gradient": "0.4"}),
    ("sgd_mom_update", 3, {"lr": "0.1", "momentum": "0.9", "wd": "0.01"}),
    ("adam_update", 4, {"lr": "0.01", "wd": "0.001", "beta1": "0.8",
                        "clip_gradient": "0.5"}),
    ("rmsprop_update", 3, {"lr": "0.01", "gamma1": "0.9",
                           "clip_weights": "0.6"}),
    ("rmspropalex_update", 5, {"lr": "0.01", "wd": "0.01",
                               "clip_weights": "2.0"}),
]


@pytest.mark.parametrize("name,nin,attrs", UPDATE_OPS)
def test_update_ops_match_jax(name, nin, attrs):
    """Each op's outputs (new weight and states) from the same inputs;
    its argument and output names are the reference's."""
    rng = np.random.RandomState(2)
    inputs = [rng.randn(4, 6).astype(np.float32) for _ in range(nin)]
    inputs[2:] = [np.abs(v) + 1.0 if i == 0 else v
                  for i, v in enumerate(inputs[2:])]
    jop, op = jget_op(name), get_op(name)
    want, _ = jop.fcompute(jop.parse_attrs(attrs),
                           [jnp.asarray(v) for v in inputs], [],
                           JOpContext())
    got, _ = op.fcompute(op.parse_attrs(attrs),
                         [torch.from_numpy(v) for v in inputs], [],
                         OpContext())
    assert op.list_arguments(op.parse_attrs(attrs)) == \
        jop.list_arguments(jop.parse_attrs(attrs))
    assert op.list_outputs(op.parse_attrs(attrs)) == \
        jop.list_outputs(jop.parse_attrs(attrs))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL_EAGER)
    assert hasattr(mt.sym, name)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _init_pair(init_t, init_j, name, shape):
    t = mt.nd.zeros(shape)
    init_t(tinit.InitDesc(name), t)
    j = mx.nd.zeros(shape)
    init_j(jinit.InitDesc(name), j)
    return t.asnumpy(), j.asnumpy()


@pytest.mark.parametrize("name,shape", [("up_weight", (2, 3, 4, 4)),
                                        ("deconv_weight", (1, 1, 3, 5)),
                                        ("upsampling0_weight", (2, 2, 6, 6))])
def test_bilinear_is_the_jax_kernel(name, shape):
    got, want = _init_pair(tinit.Bilinear(), jinit.Bilinear(), name, shape)
    np.testing.assert_array_equal(got, want)
    if name.startswith("upsampling"):
        # any initializer gives an upsampling weight the bilinear kernel
        got, want = _init_pair(tinit.Zero(), jinit.Zero(), name, shape)
        np.testing.assert_array_equal(got, want)
        assert got.any()


def test_load_and_mixed_route_as_jax():
    """Load serves a dict (``arg:`` / ``aux:`` prefixes dropped, others
    to ``default_init``, a wrong shape refused); Mixed sends each name
    to its first matching pattern."""
    rng = np.random.RandomState(0)
    saved = {"arg:fc_weight": rng.randn(3, 4).astype(np.float32),
             "aux:bn_moving_var": rng.rand(4).astype(np.float32)}
    tl = tinit.Load({k: mt.nd.array(v) for k, v in saved.items()},
                    default_init=tinit.Constant(0.5))
    jl = jinit.Load({k: mx.nd.array(v) for k, v in saved.items()},
                    default_init=jinit.Constant(0.5))
    for name, shape in (("fc_weight", (3, 4)), ("bn_moving_var", (4,)),
                        ("fc_bias", (3,))):
        got, want = _init_pair(tl, jl, name, shape)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(mt.MXNetError, match="shape"):
        tl("fc_weight", mt.nd.zeros((4, 3)))
    tm = tinit.Mixed([".*_bias", "fc.*", ".*"],
                     [tinit.Constant(2.0), tinit.Bilinear(), tinit.One()])
    jm = jinit.Mixed([".*_bias", "fc.*", ".*"],
                     [jinit.Constant(2.0), jinit.Bilinear(), jinit.One()])
    for name, shape in (("fc_bias", (3,)), ("fc_weight", (2, 2, 3, 3)),
                        ("conv_weight", (2, 3)), ("bn_gamma", (3,))):
        got, want = _init_pair(tm, jm, name, shape)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(mt.MXNetError, match="matched no pattern"):
        tinit.Mixed(["fc.*"], [tinit.One()])("conv_weight",
                                             mt.nd.zeros((2,)))


@pytest.mark.parametrize("shape", [(6, 4), (3, 2, 2, 2), (5, 5)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_is_orthogonal(shape, rand_type):
    torch.manual_seed(0)
    arr = mt.nd.zeros(shape)
    tinit.Orthogonal(scale=1.5, rand_type=rand_type)("fc_weight", arr)
    q = arr.asnumpy().reshape(shape[0], -1).astype(np.float64)
    small = q.T @ q if q.shape[0] >= q.shape[1] else q @ q.T
    np.testing.assert_allclose(small, 1.5 ** 2 * np.eye(len(small)),
                               atol=1e-6 * 1.5 ** 2)
    assert tinit.Orthogonal().dumps() == jinit.Orthogonal().dumps()


def test_msraprelu_variance():
    torch.manual_seed(0)
    shape = (256, 64, 3, 3)
    arr = mt.nd.zeros(shape)
    tinit.MSRAPrelu(factor_type="in", slope=0.25)("conv_weight", arr)
    want = np.sqrt(2.0 / (1 + 0.25 ** 2) / (64 * 9))
    assert abs(arr.asnumpy().std() / want - 1) <= 0.02
    assert tinit.MSRAPrelu().dumps() == jinit.MSRAPrelu().dumps()
    for klass in ("orthogonal", "msraprelu", "bilinear", "load", "mixed"):
        assert klass in tinit.init_registry


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _metric_batches():
    rng = np.random.RandomState(4)
    out = []
    for _ in range(3):
        label = rng.randint(0, 2, 8).astype(np.float32)
        pred = rng.rand(8, 2).astype(np.float32)
        out.append(([label], [pred / pred.sum(1, keepdims=True)]))
    return out


def _mse(label, pred):
    return float(((label - pred[:, 1]) ** 2).mean())


def _sum_count(label, pred):
    return float(np.abs(label - pred[:, 0]).sum()), label.size


@pytest.mark.parametrize("make", [
    lambda m: m.F1(), lambda m: m.Torch(), lambda m: m.Caffe("caffe2"),
    lambda m: m.create("f1"), lambda m: m.create("torch"),
    lambda m: m.create("caffe"), lambda m: m.CustomMetric(_mse),
    lambda m: m.CustomMetric(lambda l, p: float(p.max())),
    lambda m: m.np_metric("sc")(_sum_count), lambda m: m.create(_mse),
    lambda m: m.create([_mse, "f1", "acc"])])
def test_metrics_match_jax(make):
    """The same predictions through both packages' metric: names and
    values, and whether it can accumulate on the device."""
    jm, tm = make(jmetric), make(tmetric)
    for labels, preds in _metric_batches():
        jm.update([mx.nd.array(v) for v in labels],
                  [mx.nd.array(v) for v in preds])
        tm.update([mt.nd.array(v) for v in labels],
                  [mt.nd.array(v) for v in preds])
    assert tm.get_name_value() == jm.get_name_value()
    assert bool(tm.device_supported()) == bool(jm.device_supported())
    assert tmetric.DeviceMetricAccumulator.supported(tm) == \
        bool(jm.device_supported())


def test_f1_refuses_more_than_two_classes():
    with pytest.raises(ValueError, match="binary"):
        tmetric.F1().update([mt.nd.array(np.array([0, 1, 2], np.float32))],
                            [mt.nd.array(np.eye(3, dtype=np.float32))])


# ---------------------------------------------------------------------------
# iterators
# ---------------------------------------------------------------------------

def _batches(it, limit=100):
    out = []
    for i, b in enumerate(it):
        out.append(([d.asnumpy() for d in b.data],
                    [lb.asnumpy() for lb in b.label or []], b.pad))
        if i + 1 >= limit:
            break
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_mnist_is_the_jax_set(seed):
    ti, tl = tio._synthetic_mnist(seed=seed)
    ji, jl = jio._synthetic_mnist(seed=seed)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    assert ti.dtype == ji.dtype and tl.dtype == jl.dtype


@pytest.mark.parametrize("kw", [
    {"batch_size": 500, "seed": 1},
    {"batch_size": 700, "flat": True, "shuffle": False},
    {"batch_size": 250, "input_shape": (784,), "num_parts": 3,
     "part_index": 2, "seed": 2}])
def test_mnist_iter_synthetic_batches(kw):
    """Missing idx files: the synthetic set, batched as the reference
    batches it (the last partial batch dropped)."""
    kw = dict(kw, image="no-such-images", label="no-such-labels",
              silent=True)
    t, j = tio.MNISTIter(**kw), jio.MNISTIter(**kw)
    assert t.provide_data == [(d.name, d.shape) for d in j.provide_data]
    assert t.provide_label == [(d.name, d.shape) for d in j.provide_label]
    _same_batches(_batches(t), _batches(j))
    t.reset()
    j.reset()
    _same_batches(_batches(t, 2), _batches(j, 2))


def _write_idx(path, arr, gz=False):
    header = struct.pack(">i", 0x0800 + arr.ndim) + b"".join(
        struct.pack(">i", d) for d in arr.shape)
    data = header + arr.astype(np.uint8).tobytes()
    if gz:
        with gzip.open(path + ".gz", "wb") as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_iter_reads_idx_files(tmp_path, gz):
    """Small idx files written here (20 images of 6 x 5, plain or
    ``.gz``): the file's own dims, the same batches as the reference."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (20, 6, 5))
    labels = rng.randint(0, 10, 20)
    img, lab = str(tmp_path / "img-idx3"), str(tmp_path / "lab-idx1")
    _write_idx(img, images, gz)
    _write_idx(lab, labels, gz)
    np.testing.assert_array_equal(tio._read_idx(img), images)
    np.testing.assert_array_equal(tio._read_idx(lab), labels)
    kw = dict(image=img, label=lab, batch_size=6, seed=4)
    t, j = tio.MNISTIter(**kw), jio.MNISTIter(**kw)
    got, want = _batches(t), _batches(j)
    assert got[0][0][0].shape == (6, 1, 6, 5)
    _same_batches(got, want)


def test_csv_and_resize_iters_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    data = rng.randn(10, 6).astype(np.float32)
    label = rng.randint(0, 3, 10).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    for kw in ({"data_shape": (2, 3), "label_csv": str(tmp_path / "l.csv"),
                "batch_size": 4},
               {"data_shape": (6,), "batch_size": 3, "round_batch": False}):
        kw = dict(kw, data_csv=str(tmp_path / "d.csv"))
        t, j = tio.CSVIter(**kw), jio.CSVIter(**kw)
        assert t.provide_data == [(d.name, d.shape) for d in j.provide_data]
        _same_batches(_batches(t), _batches(j))
        # ResizeIter over them: 7 batches an epoch, wrapping around
        for reset_internal in (True, False):
            t.reset()
            j.reset()
            rt = tio.ResizeIter(t, 7, reset_internal=reset_internal)
            rj = jio.ResizeIter(j, 7, reset_internal=reset_internal)
            for _ in range(2):
                _same_batches(_batches(rt), _batches(rj))
                rt.reset()
                rj.reset()


def _bounded(fn, seconds=60):
    """Run ``fn`` on a thread and fail (instead of hanging the run) when
    it does not finish within ``seconds``."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as exc:  # re-raised below
            box["exc"] = exc

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), "timed out"
    if "exc" in box:
        raise box["exc"]
    return box.get("out")


def _ndarray_iters(pkg_io, pkg_nd):
    rng = np.random.RandomState(2)
    a = rng.randn(9, 3).astype(np.float32)
    b = rng.randn(9, 2).astype(np.float32)
    y = rng.randint(0, 2, 9).astype(np.float32)
    return [pkg_io.NDArrayIter(a, y, batch_size=4),
            pkg_io.NDArrayIter({"b": b}, {"yb": y}, batch_size=4)]


def test_prefetching_iter_matches_jax():
    """Two iterators joined and renamed on a worker thread: the same
    descriptors and batches as the reference's, over two epochs; the
    worker stops at reset and close."""
    rename_data = [{"data": "x"}, {"b": "z"}]
    rename_label = [{"softmax_label": "y1"}, {"yb": "y2"}]

    def run():
        t = tio.PrefetchingIter(_ndarray_iters(tio, mt.nd), rename_data,
                                rename_label)
        j = jio.PrefetchingIter(_ndarray_iters(jio, mx.nd), rename_data,
                                rename_label)
        assert [(d.name, d.shape) for d in t.provide_data] == \
            [(d.name, d.shape) for d in j.provide_data] == \
            [("x", (4, 3)), ("z", (4, 2))]
        assert [d.name for d in t.provide_label] == ["y1", "y2"]
        for _ in range(2):
            _same_batches(_batches(t), _batches(j))
            t.reset()
            j.reset()
        one = tio.PrefetchingIter(tio.NDArrayIter(
            np.arange(12, dtype=np.float32).reshape(6, 2), batch_size=2))
        first = one.next()
        one.reset()  # mid-epoch: the worker is stopped and restarted
        np.testing.assert_array_equal(one.next().data[0].asnumpy(),
                                      first.data[0].asnumpy())
        for it in (t, j, one):
            it.close()
        assert t._thread is None and one._thread is None
        with pytest.raises(StopIteration):
            one.next()

    _bounded(run)


def test_prefetching_iter_raises_the_workers_error():
    class Broken(tio.DataIter):
        batch_size = 1
        provide_data = provide_label = []

        def next(self):
            raise RuntimeError("source broke")

        def reset(self):
            pass

    def run():
        it = tio.PrefetchingIter(Broken())
        with pytest.raises(RuntimeError, match="source broke"):
            it.next()
        it.close()

    _bounded(run)
