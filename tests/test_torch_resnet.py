"""The port's ResNet path — ``models.resnet``, the ops it needs
(Convolution, BatchNorm, Pooling, Activation, Flatten) and ``Module``
training with the slab plan armed — held against the JAX package on the
same numpy inputs, on the CPU.

Tolerances, all f32:

* symbols: the JSON is byte-identical;
* ops: 1e-5 of the largest magnitude of each output or gradient (the
  same products and sums, summed in another order).  BatchNorm's output
  on the refine input (|mean| = 50 against a spread of 0.1) is held to
  1e-6 of max |x * scale|: it is x * scale + shift with scale ~ 10 and
  shift ~ -500, so both sides lose the leading digits the same way and
  keep their own f32 rounding of them (measured 2e-7); its gradients to
  1e-3 (measured 1.4e-4: the two means differ by a few f32 ulps, each
  4e-5 of the spread there);
* two ``Module`` steps (SGD-momentum, wd, plan armed, the plain update on
  the CPU) against the JAX ``Module``'s per-parameter path, over seeds 1-4.
  Before the second step the port takes the reference's parameters and
  moving statistics (``set_params``, through the slab views) and keeps
  its own momentum, so each step starts where the reference's does.
  Outputs 1e-5 absolute, the moving statistics 1e-5 absolute.  Each
  parameter's delta in two tiers, as ``chip_smoke.py`` holds the train
  gradients: the classifier (``fc1_*``, which the backward reaches before
  any ReLU) to 1e-4 of its largest |delta|, the rest to 5e-2.  At batch 4
  some ReLU input lies within f32 rounding of 0 for some seeds, the two
  packages then take different sides of the mask, and the gradients
  upstream of it move by up to 2e-2 of their largest value.  Measured
  over seeds 1-10: outputs 4.5e-7, statistics 1.4e-6, the classifier
  7e-6, the rest 7.8e-5 where no mask flips and 1.9e-2 where one does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import config as jconfig
from mxnet_tpu import ndarray as jnd
from mxnet_tpu.io import DataBatch as JBatch
from mxnet_tpu.io import DataDesc as JDesc
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.registry import OpContext as JOpContext
from mxnet_tpu.registry import get_op as jget_op

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.io import DataBatch, DataDesc, NDArrayIter
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.ops import update_kernel as uk
from mxnet_tpu_torch.registry import OpContext, get_op
from mxnet_tpu_torch.weights import params_from_jax, params_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    """Arrays made without a context go to the host: the port's default
    context is the card."""
    with mt.cpu():
        yield


torch.set_num_threads(1)

TOL_OP = 1e-5
TOL_OUT, TOL_AUX = 1e-5, 1e-5
TOL_DELTA, TOL_DELTA_RELU = 1e-4, 5e-2


@pytest.mark.parametrize("args", [(1000, 50, (3, 224, 224)),
                                  (10, 20, (3, 28, 28)),
                                  (10, 18, (3, 224, 224))])
def test_symbol_json_is_byte_identical(args):
    with mx.NameManager(), mt.NameManager():
        want = jresnet.get_symbol(*args).tojson()
        got = resnet.get_symbol(*args).tojson()
    assert got == want


def test_resnet50_sizes():
    """ResNet-50 at batch 256: 157 trainables, 25,549,486 parameters,
    102 aux values; the slab plan's 12,556 blocks of 2,048."""
    sym = resnet.get_symbol(1000, 50)
    shapes, outs, aux = sym.infer_shape(data=(256, 3, 224, 224),
                                        softmax_label=(256,))
    train = {n: torch.empty(s, device="meta")
             for n, s in zip(sym.list_arguments(), shapes)
             if n not in ("data", "softmax_label")}
    assert outs == [(256, 1000)]
    assert len(train) == 157
    assert sum(v.numel() for v in train.values()) == 25_549_486
    assert (len(aux), int(sum(np.prod(s) for s in aux))) == (102, 45_574)
    segs = uk._segments_for(train)
    assert sum(s.nblocks for s in segs["float32"]) == 12_556


def _close(got, want, tol=TOL_OP, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mag = scale if scale is not None else max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= tol * mag, \
        (np.abs(got - want).max(), tol * mag)


def _jax_op(name, attrs, inputs, aux=(), is_train=True, cotangent=None):
    """The JAX op's outputs, new aux and (with a cotangent on output 0)
    its VJP to the inputs."""
    op = jget_op(name)
    parsed = op.parse_attrs(attrs)
    octx = JOpContext(is_train=is_train)
    jaux = [jnp.asarray(a) for a in aux]

    def f(*xs):
        outs, new_aux = op.fcompute(parsed, list(xs), jaux, octx)
        return outs[0], (outs, new_aux)

    out, vjp, (outs, new_aux) = jax.vjp(f, *[jnp.asarray(x) for x in inputs],
                                        has_aux=True)
    grads = vjp(jnp.asarray(cotangent)) if cotangent is not None else None
    return [np.asarray(o) for o in outs], [np.asarray(a) for a in new_aux], \
        None if grads is None else [np.asarray(g) for g in grads]


def _port_op(name, attrs, inputs, aux=(), is_train=True, cotangent=None):
    op = get_op(name)
    parsed = op.parse_attrs(attrs)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    outs, new_aux = op.fcompute(parsed, leaves,
                                [torch.from_numpy(a) for a in aux],
                                OpContext(is_train=is_train))
    grads = None
    if cotangent is not None:
        grads = torch.autograd.grad(outs[0], leaves,
                                    torch.from_numpy(cotangent),
                                    allow_unused=True)
        grads = [np.zeros_like(x) if g is None else g.numpy()
                 for x, g in zip(inputs, grads)]
    return [o.detach().numpy() for o in outs], \
        [a.detach().numpy() for a in new_aux], grads


BN_SHAPE = (4, 6, 5, 3)


def _bn_inputs(case):
    rng = np.random.RandomState(7)
    c = BN_SHAPE[1]
    if case == "refine":
        x = 50.0 + 0.1 * rng.randn(*BN_SHAPE)
        mm = np.zeros(c)
    else:
        x = 0.5 + 2.0 * rng.randn(*BN_SHAPE)
        mm = 0.3 * rng.randn(c)
    gamma = 1.0 + 0.2 * rng.randn(c)
    beta = 0.1 * rng.randn(c)
    mv = 1.0 + 0.5 * rng.rand(c)
    dy = rng.randn(*BN_SHAPE)
    f = np.float32
    return [x.astype(f), gamma.astype(f), beta.astype(f)], \
        [mm.astype(f), mv.astype(f)], dy.astype(f)


@pytest.mark.parametrize("case,fix_gamma,is_train,global_stats", [
    ("normal", False, True, False), ("refine", False, True, False),
    ("normal", True, True, False), ("normal", False, False, False),
    ("normal", False, True, True)])
def test_batchnorm_matches_jax(case, fix_gamma, is_train, global_stats):
    """Forward, mean / var outputs, moving statistics and the VJP to x,
    gamma and beta, in training (batch statistics, the shifted single
    pass or its refine) and with the moving statistics."""
    inputs, aux, dy = _bn_inputs(case)
    attrs = {"eps": "2e-05", "momentum": "0.9",
             "fix_gamma": str(fix_gamma), "use_global_stats":
             str(global_stats)}
    want = _jax_op("BatchNorm", attrs, inputs, aux, is_train, dy)
    got = _port_op("BatchNorm", attrs, inputs, aux, is_train, dy)
    (w_out, w_mean, w_var), w_aux, w_grads = want
    (g_out, g_mean, g_var), g_aux, g_grads = got
    if case == "refine":
        x = inputs[0]
        var2 = x.astype(np.float64).var(axis=(0, 2, 3))
        # the refine pass ran: the variance is the two-pass one
        _close(g_var, var2, 1e-4, scale=var2.max())
        scale = float(np.abs(x).max() / np.sqrt(var2.min() + 2e-5))
        _close(g_out, w_out, 1e-6, scale=scale)
    else:
        _close(g_out, w_out)
    _close(g_mean, w_mean)
    _close(g_var, w_var, scale=max(1e-30, np.abs(w_var).max()))
    for a, b in zip(g_aux, w_aux):
        _close(a, b)
    # on the refine input one f32 ulp of the mean (3.8e-6 at 50) is 4e-5
    # of the spread, and x - mean carries it into every term of the
    # gradients: 1e-3 of their magnitude there (measured 1.4e-4)
    tol = 1e-3 if case == "refine" else TOL_OP
    for a, b in zip(g_grads, w_grads):
        _close(a, b, tol, scale=max(1e-30, np.abs(b).max()))
    if fix_gamma:
        assert not g_grads[1].any()


@pytest.mark.parametrize("attrs,hw", [
    ({"kernel": "(3, 3)", "stride": "(2, 2)", "pad": "(1, 1)",
      "pool_type": "max"}, (9, 8)),
    ({"kernel": "(3, 3)", "stride": "(2, 2)", "pool_type": "avg",
      "pooling_convention": "full"}, (7, 8)),
    ({"kernel": "(2, 3)", "stride": "(1, 2)", "pad": "(1, 0)",
      "pool_type": "sum", "pooling_convention": "full"}, (6, 7)),
    ({"kernel": "(2, 2)", "pool_type": "avg", "pad": "(1, 1)"}, (5, 5)),
    ({"kernel": "(7, 7)", "pool_type": "avg", "global_pool": "True"},
     (4, 5)),
    ({"kernel": "(1, 1)", "pool_type": "max", "global_pool": "True"},
     (3, 6))])
def test_pooling_matches_jax(attrs, hw):
    """max / avg / sum, valid / full, padded and global: forward, shape
    inference and the VJP (random inputs, so max has no ties)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, *hw).astype(np.float32)
    (w_out,), _, _ = _jax_op("Pooling", attrs, [x])
    dy = rng.randn(*w_out.shape).astype(np.float32)
    (w_out,), _, (w_dx,) = _jax_op("Pooling", attrs, [x], cotangent=dy)
    (g_out,), _, (g_dx,) = _port_op("Pooling", attrs, [x], cotangent=dy)
    assert g_out.shape == w_out.shape
    _close(g_out, w_out)
    _close(g_dx, w_dx)
    op = get_op("Pooling")
    assert op.infer_shape(op.parse_attrs(attrs), [x.shape])[1] == \
        [w_out.shape]


@pytest.mark.parametrize("attrs", [
    {"kernel": "(3, 3)", "stride": "(2, 2)", "pad": "(1, 1)",
     "num_filter": "6", "no_bias": "True"},
    {"kernel": "(1, 3)", "num_filter": "4", "num_group": "2",
     "dilate": "(1, 2)", "pad": "(0, 2)"}])
def test_convolution_matches_jax(attrs):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 7, 9).astype(np.float32)
    op = get_op("Convolution")
    parsed = op.parse_attrs(attrs)
    shapes, outs, _ = op.infer_shape(parsed, [x.shape])
    inputs = [x] + [(0.3 * rng.randn(*s)).astype(np.float32)
                    for s in shapes[1:]]
    dy = rng.randn(*outs[0]).astype(np.float32)
    (w_out,), _, w_grads = _jax_op("Convolution", attrs, inputs,
                                   cotangent=dy)
    (g_out,), _, g_grads = _port_op("Convolution", attrs, inputs,
                                    cotangent=dy)
    assert g_out.shape == w_out.shape == outs[0]
    _close(g_out, w_out)
    for a, b in zip(g_grads, w_grads):
        _close(a, b, scale=np.abs(b).max())
    # NHWC data, the weight still OIHW, through both packages
    nhwc = dict(attrs, layout="NHWC")
    inputs = [np.ascontiguousarray(x.transpose(0, 2, 3, 1))] + inputs[1:]
    dy = np.ascontiguousarray(dy.transpose(0, 2, 3, 1))
    (w_out,), _, w_grads = _jax_op("Convolution", nhwc, inputs, cotangent=dy)
    (g_out,), _, g_grads = _port_op("Convolution", nhwc, inputs,
                                    cotangent=dy)
    assert g_out.shape == w_out.shape == op.infer_shape(
        op.parse_attrs(nhwc), [inputs[0].shape])[1][0]
    _close(g_out, w_out)
    for a, b in zip(g_grads, w_grads):
        _close(a, b, scale=np.abs(b).max())


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation_matches_jax(act):
    rng = np.random.RandomState(9)
    x = (3 * rng.randn(4, 33)).astype(np.float32)
    dy = rng.randn(4, 33).astype(np.float32)
    (w_out,), _, (w_dx,) = _jax_op("Activation", {"act_type": act}, [x],
                                   cotangent=dy)
    (g_out,), _, (g_dx,) = _port_op("Activation", {"act_type": act}, [x],
                                    cotangent=dy)
    _close(g_out, w_out)
    _close(g_dx, w_dx)


# ---------------------------------------------------------------------------
# Module: two steps against the JAX Module
# ---------------------------------------------------------------------------

B, IMG = 4, (3, 32, 32)
NETS = {
    "bottleneck": dict(units=[1, 1, 1, 1], num_stages=4,
                       filter_list=[8, 16, 32, 64, 128], num_classes=10,
                       image_shape=IMG),
    "basic": dict(units=[1, 1, 1], num_stages=3, filter_list=[8, 8, 16, 32],
                  num_classes=10, image_shape=IMG, bottle_neck=False)}
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _values(sym, seed=5):
    """Seeded numpy parameters (He-scaled weights, gamma near 1) and aux
    (moving mean near 0, variance near 1), and one batch."""
    shapes, _, aux_shapes = sym.infer_shape(data=(B,) + IMG,
                                            softmax_label=(B,))
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            v = 1.0 + 0.1 * rng.randn(*s)
        elif n.endswith("_beta") or n.endswith("_bias"):
            v = 0.1 * rng.randn(*s)
        else:
            v = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        args[n] = v.astype(np.float32)
    aux = {n: (0.1 * rng.randn(*s) if n.endswith("_mean")
               else 1.0 + 0.1 * rng.rand(*s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    x = rng.uniform(-1, 1, (B,) + IMG).astype(np.float32)
    y = rng.randint(0, 10, B).astype(np.float32)
    return args, aux, x, y


def _jax_module(kw, args, aux, x, y, steps, compute_dtype="float32"):
    """The JAX Module's outputs, and its (arg, aux) numpy parameters,
    after each of ``steps`` forward_backward + update."""
    dd, ld = JDesc("data", (B,) + IMG), JDesc("softmax_label", (B,))
    batch = JBatch([jnd.array(x)], [jnd.array(y)], provide_data=[dd],
                   provide_label=[ld])
    with jconfig.overrides(MXNET_PALLAS_UPDATE=False):
        mod = mx.mod.Module(jresnet.resnet(**kw), context=mx.cpu(),
                            compute_dtype=compute_dtype)
        mod.bind(data_shapes=[dd], label_shapes=[ld])
        mod.init_params(arg_params={k: jnd.array(v) for k, v in
                                    args.items()},
                        aux_params={k: jnd.array(v) for k, v in aux.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
        outs, params = [], []
        for _ in range(steps):
            mod.forward_backward(batch)
            mod.update()
            outs.append(np.asarray(mod.get_outputs()[0].asnumpy(),
                                   np.float32))
            arg, aux_out = mod.get_params()
            params.append(({k: v.asnumpy().copy() for k, v in arg.items()},
                           {k: v.asnumpy().copy()
                            for k, v in aux_out.items()}))
    return outs, params


def _port_module(kw, args, aux, compute_dtype=None):
    mod = mt.mod.Module(resnet.resnet(**kw), context=mt.cpu(),
                        compute_dtype=compute_dtype)
    mod.bind(data_shapes=[DataDesc("data", (B,) + IMG)],
             label_shapes=[DataDesc("softmax_label", (B,))])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    assert mod._train_step.plan is not None
    return mod


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("net", sorted(NETS))
def test_module_two_steps_match_jax(net, seed):
    kw = NETS[net]
    args, aux, x, y = _values(resnet.resnet(**kw), seed)
    want_outs, want = _jax_module(kw, args, aux, x, y, 2)
    mod = _port_module(kw, args, aux)
    batch = DataBatch([mt.nd.array(x)], [mt.nd.array(y)])
    start, start_aux = args, aux
    for step in range(2):
        if step:
            mod.set_params(start, start_aux)
        mod.forward_backward(batch)
        mod.update()
        assert uk.UPDATE_PATH["last"] == "plain"
        np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(),
                                   want_outs[step], rtol=0, atol=TOL_OUT)
        got = params_to_numpy(*mod.get_params())
        # the JAX parameters come back through weights.params_from_jax,
        # which carries the moving statistics beside the arguments
        ref = params_from_jax(*want[step], device="cpu")
        for k, v in start.items():
            delta = ref[k].numpy() - v
            err = float(np.abs(got[k] - v - delta).max())
            tol = TOL_DELTA if k.startswith("fc1_") else TOL_DELTA_RELU
            assert err <= tol * float(np.abs(delta).max()), (k, step, err)
        for k, v in start_aux.items():
            assert not np.array_equal(got["aux:" + k], v)
            np.testing.assert_allclose(got["aux:" + k], ref[k].numpy(),
                                       rtol=0, atol=TOL_AUX)
        start = {k: ref[k].numpy() for k in args}
        start_aux = {k: ref[k].numpy() for k in aux}


def test_bf16_module_step_tracks_jax():
    """``compute_dtype="bfloat16"``: every floating parameter (gammas and
    betas too) is read through the bf16 compute slab, the aux states stay
    f32, the masters stay f32.  Both sides round to bf16 at different
    places (XLA fuses elementwise chains in f32, PyTorch rounds each op),
    so the tolerances are bf16-sized and norm-wise: outputs 2^-7
    absolute, the whole step's parameter delta 0.15 and each tensor's 0.4
    relative to its norm, the moving statistics 2^-7 of their magnitude.
    Measured over seeds 1, 3 and 5: outputs up to 2.9e-3, whole delta
    0.038-0.087, per tensor up to 0.25 (a BatchNorm beta or gamma, whose
    gradient is a sum of cancelling bf16 terms), statistics up to
    2.3e-3."""
    kw = NETS["basic"]
    args, aux, x, y = _values(resnet.resnet(**kw))
    want_outs, ((want_arg, want_aux),) = _jax_module(
        kw, args, aux, x, y, 1, compute_dtype="bfloat16")
    mod = _port_module(kw, args, aux, compute_dtype="bfloat16")
    step = mod._train_step
    assert set(step._views) == set(args)
    assert all(v.dtype == torch.bfloat16 for v in step._views.values())
    mod.forward_backward(DataBatch([mt.nd.array(x)], [mt.nd.array(y)]))
    mod.update()
    out = mod.get_outputs()[0]
    assert out.data.dtype == torch.bfloat16
    np.testing.assert_allclose(out.asnumpy(), want_outs[0], rtol=0,
                               atol=2 ** -7)
    arg_p, aux_p = mod.get_params()
    assert all(v.data.dtype == torch.float32 for v in arg_p.values())
    assert all(v.data.dtype == torch.float32 for v in aux_p.values())
    got = params_to_numpy(arg_p, aux_p)
    sq_err = sq_delta = 0.0
    for k, v in args.items():
        err = float(np.sum((got[k] - want_arg[k]) ** 2))
        delta = float(np.sum((want_arg[k] - v) ** 2))
        assert err <= 0.4 ** 2 * delta, (k, np.sqrt(err / delta))
        sq_err += err
        sq_delta += delta
    assert sq_err <= 0.15 ** 2 * sq_delta, np.sqrt(sq_err / sq_delta)
    for k in aux:
        w = want_aux[k]
        _close(got["aux:" + k], w, 2 ** -7, scale=np.abs(w).max())


def test_fit_and_score_use_the_moving_statistics():
    """fit over an NDArrayIter trains (the moving statistics move), score
    with Accuracy runs the global-statistics forward: it leaves them as
    they are and gives the same answer twice, and the scored outputs
    equal a forward that reads the moving statistics."""
    kw = dict(NETS["basic"], num_classes=2)
    rng = np.random.RandomState(4)
    n = 16
    x = rng.uniform(-1, 1, (n,) + IMG).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.float32)
    it = NDArrayIter(x, y, batch_size=B)
    mod = mt.mod.Module(resnet.resnet(**kw), context=mt.cpu())
    mod.fit(it, eval_metric="acc", optimizer="sgd", optimizer_params=OPT,
            initializer=mt.initializer.Xavier(rnd_type="gaussian",
                                              factor_type="in",
                                              magnitude=2),
            num_epoch=2)
    assert mod._train_step.plan is not None
    aux = {k: v.asnumpy().copy() for k, v in mod.get_params()[1].items()}
    assert not np.array_equal(aux["bn1_moving_var"],
                              np.ones_like(aux["bn1_moving_var"]))
    first = dict(mod.score(it, mt.metric.Accuracy()))
    second = dict(mod.score(it, "acc"))
    assert first == second and 0.0 <= first["accuracy"] <= 1.0
    after = {k: v.asnumpy() for k, v in mod.get_params()[1].items()}
    for k in aux:
        np.testing.assert_array_equal(after[k], aux[k])
    # the scored forward is the global-statistics forward
    it.reset()
    batch = next(iter(it))
    mod.forward(batch, is_train=False)
    scored = mod.get_outputs()[0].asnumpy()
    mod.forward(batch, is_train=False)
    np.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(), scored)


def test_initializer_fan_in_and_batchnorm_rules():
    """Xavier(gaussian, in, 2) scales OIHW weights by fan-in I*kh*kw;
    BatchNorm gammas start at 1, betas and moving means at 0, moving
    variances at 1; the FC bias at 0."""
    torch.manual_seed(0)
    init = mt.initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                 magnitude=2)
    w = mt.nd.zeros((256, 64, 3, 3))
    init(mt.initializer.InitDesc("stage1_unit1_conv2_weight"), w)
    std = float(w.data.std())
    assert abs(std / np.sqrt(2.0 / (64 * 9)) - 1.0) < 0.02
    sym = resnet.resnet(**NETS["basic"])
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(data_shapes=[DataDesc("data", (B,) + IMG)],
             label_shapes=[DataDesc("softmax_label", (B,))])
    mod.init_params(initializer=init)
    arg, aux = mod.get_params()
    for k, v in arg.items():
        if k.endswith("_gamma"):
            assert bool((v.data == 1).all()), k
        elif k.endswith("_beta") or k.endswith("_bias"):
            assert not v.data.any(), k
    for k, v in aux.items():
        want = 1.0 if k.endswith("_var") else 0.0
        assert bool((v.data == want).all()), k
