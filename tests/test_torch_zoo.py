"""The port's image-classification zoo — ``models.mlp``, ``lenet``,
``alexnet``, ``vgg``, ``googlenet``, ``inception_bn``, ``inception_v3``
and ``resnext`` — and the ``LRN`` op, held against the JAX package on the
same numpy inputs, on the CPU (the deep BatchNorm nets' training steps
run from ``tests/test_torch_zoo_train.py``, the same checks).

Tolerances, all stated against the JAX package's values:

* symbols: the JSON is byte-identical, and the full-width parameter
  counts are the reference's;
* ``LRN``: f32 output and input gradient within 1e-6 of the largest
  magnitude (measured 9.2e-8); bf16 within 2^-7 of it, one bf16
  rounding (measured 7.0e-3: the port rounds every step to bf16, XLA
  keeps the fused chain in f32 between its roundings);
* eval forwards (``is_train=False``: Dropout is the identity, BatchNorm
  reads the moving statistics): the softmax outputs within 1e-5
  absolute (measured up to 5.1e-7);
* two ``Module`` steps (SGD-momentum 0.9, lr 0.1, wd 1e-4, the slab plan
  armed, the plain update on the CPU) against the JAX ``Module``'s
  per-parameter path, as ``tests/test_torch_resnet.py`` holds ResNet:
  before the second step the port takes the reference's parameters and
  moving statistics and keeps its own momentum.  MLP, LeNet and AlexNet
  in the ResNet test's tiers: outputs 1e-5 absolute, moving statistics
  1e-5, each parameter's delta max-abs, the classifier (which the
  backward reaches before any ReLU) to 1e-4 of its largest |delta|, the
  rest to 5e-2; measured outputs 8.3e-7, classifier 2.1e-6, the rest
  3.6e-6.  Inception-BN, ResNeXt and Inception-v3 stack 53-94
  BatchNorms, and the reference itself is ill-conditioned there: moving
  its input by one f32 rounding (x (1 + 2e-7)) moves its own first step
  by up to 0.0062 / 0.021 / 0.039 of a tensor's delta and 7.8e-4 /
  0.018 / 0.032 of the whole step's (norm-wise; Inception-BN at 2 x 64
  x 64, ResNeXt-50 at 2 x 32 x 32, Inception-v3 at 2 x 299 x 299, where
  each BatchNorm averages over 128 values or more; at 1 x 139 x 139:
  0.15 / 0.038).  Larger batches do not help (ResNeXt at batch 8:
  0.021 / 0.016; Inception-BN at 8 x 128 x 128: 0.031 / 0.011): the
  betas' and early layers' deltas are sums that cancel.  Each net is
  held to about three times its own measured error (a delta under 1e-5
  of the step's largest, such as the conv biases feeding a BatchNorm,
  measured on that floor), in ``TOLS``'s order: outputs, classifier
  max-abs, every other tensor, the whole step, moving statistics of
  max(1, |value|); measured 5.0e-5 / 1.6e-3 / 0.011 / 0.0043 / 5.0e-5
  (Inception-BN), 1.9e-5 / 7.7e-5 / 0.022 / 0.019 / 2.3e-5 (ResNeXt),
  1.2e-5 / 1.3e-4 / 0.056 / 0.044 / 1.5e-5 (Inception-v3).  What these
  limits catch, from faults put into a copy of the port: BatchNorm at
  eps 1e-5 instead of the symbol's fails Inception-BN (outputs 7.8e-3)
  and Inception-v3 (classifier 5.9e-4), not ResNeXt (its eps is 2e-5:
  a tensor 0.052); the middle BatchNorm's input gradient without its
  x-hat term fails Inception-BN (a tensor 0.19) and ResNeXt (0.23),
  not Inception-v3 (0.076); weight decay
  applied after the momentum fails Inception-v3 on its fixed gammas
  (0.47), and moves the other nets' second step by less than their
  spread.  Dropout masks cannot match
  across the packages (jax's PRNG against torch's generators), so
  AlexNet and Inception-v3 train cut just before their first Dropout,
  with the same ``FullyConnected`` + ``SoftmaxOutput`` head built by hand
  in both packages; their full symbols are held by the eval forward.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import config as jconfig
from mxnet_tpu import models as jmodels
from mxnet_tpu import ndarray as jnd
from mxnet_tpu.io import DataBatch as JBatch
from mxnet_tpu.io import DataDesc as JDesc
from mxnet_tpu.registry import OpContext as JOpContext
from mxnet_tpu.registry import get_op as jget_op

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models
from mxnet_tpu_torch.io import DataBatch, DataDesc
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

TOL_OUT = 1e-5
# (outputs, classifier delta, every other delta, whole step, moving
# statistics): the ResNet test's max-abs tiers, and for the deep
# BatchNorm nets norm-wise ones about three times each net's measured
# error (see the module docstring)
TOLS = {"*": (TOL_OUT, 1e-4, 5e-2, None, 1e-5),
        "inception_bn": (1.5e-4, 5e-3, 0.03, 0.015, 1.5e-4),
        "resnext": (1e-4, 5e-4, 0.06, 0.05, 1e-4),
        "inception_v3": (1e-4, 5e-4, 0.15, 0.12, 1e-4)}
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


# ---------------------------------------------------------------------------
# symbols
# ---------------------------------------------------------------------------

JSON_CASES = [
    ("mlp", {}), ("mlp", {"num_classes": 4}),
    ("lenet", {}), ("lenet", {"num_classes": 7}),
    ("alexnet", {}), ("alexnet", {"num_classes": 10}),
    ("vgg", {}), ("vgg", {"num_classes": 4, "num_layers": 16}),
    ("googlenet", {}), ("googlenet", {"num_classes": 4}),
    ("inception_bn", {}), ("inception_bn", {"num_classes": 4}),
    ("inception_v3", {}), ("inception_v3", {"num_classes": 4}),
    ("resnext", {}), ("resnext", {"num_classes": 4, "num_layers": 101}),
    ("resnext", {"num_classes": 10, "image_shape": (3, 32, 32),
                 "cardinality": 8, "bottleneck_width": 2}),
    ("resnet", {"num_classes": 10, "num_layers": 18}),
    ("attention_lm", {"vocab_size": 17, "seq_len": 8, "num_layers": 1,
                      "embed": 8, "heads": 2, "ffn_hidden": 16}),
]


@pytest.mark.parametrize("name,kw", JSON_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(JSON_CASES)])
def test_symbol_json_is_byte_identical(name, kw):
    """Every ``get_<model>`` alias builds the reference's JSON."""
    with mx.NameManager(), mt.NameManager():
        want = getattr(jmodels, "get_" + name)(**kw).tojson()
        got = getattr(models, "get_" + name)(**kw).tojson()
    assert got == want


@pytest.mark.parametrize("name,shape,want", [
    ("alexnet", (3, 224, 224), (16, 50_844_008, 0)),
    ("inception_v3", (3, 299, 299), (284, 23_834_568, 188)),
    ("vgg", (3, 224, 224), (22, 132_863_336, 0)),
    ("inception_bn", (3, 224, 224), (278, 11_295_240, 138)),
    ("resnext", (3, 224, 224), (161, 25_028_904, 106))])
def test_full_width_sizes(name, shape, want):
    """Trainable tensors, parameters and aux states at 1000 classes (the
    reference's ``infer_shape``); the reference's VGG is VGG-11's table
    whatever ``num_layers`` says."""
    sym = getattr(models, "get_" + name)(num_classes=1000)
    shapes, outs, aux = sym.infer_shape(data=(2,) + shape,
                                        softmax_label=(2,))
    train = [s for n, s in zip(sym.list_arguments(), shapes)
             if n not in ("data", "softmax_label")]
    assert outs == [(2, 1000)]
    assert (len(train), sum(int(np.prod(s)) for s in train), len(aux)) \
        == want


# ---------------------------------------------------------------------------
# LRN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2 ** -7)])
@pytest.mark.parametrize("attrs", [
    {"nsize": "5", "alpha": "0.0001", "beta": "0.75", "knorm": "2"},
    {"nsize": "3", "alpha": "0.5", "beta": "0.5", "knorm": "1"}])
def test_lrn_matches_jax(attrs, dtype, tol):
    """Forward and the input gradient (AlexNet's setting, and a strong
    one), computed in the input's dtype on both sides."""
    rng = np.random.RandomState(3)
    x = (2 * rng.randn(2, 7, 5, 4)).astype(np.float32)
    dy = rng.randn(2, 7, 5, 4).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jop = jget_op("LRN")
    jattrs = jop.parse_attrs(attrs)

    def f(v):
        return jop.fcompute(jattrs, [v], [], JOpContext())[0][0]

    w_out, vjp = jax.vjp(f, jnp.asarray(x).astype(jdt))
    (w_dx,) = vjp(jnp.asarray(dy).astype(jdt))
    op = get_op("LRN")
    leaf = torch.from_numpy(x).to(tdt).requires_grad_(True)
    (g_out,), _ = op.fcompute(op.parse_attrs(attrs), [leaf], [], OpContext())
    (g_dx,) = torch.autograd.grad(g_out, leaf, torch.from_numpy(dy).to(tdt))
    assert g_out.dtype == g_dx.dtype == tdt
    for got, want in ((g_out, w_out), (g_dx, w_dx)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.detach().float().numpy() - want).max()
        assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())
    assert op.infer_shape(op.parse_attrs(attrs), [x.shape])[1] == [x.shape]


# ---------------------------------------------------------------------------
# models: eval forwards and training steps
# ---------------------------------------------------------------------------

# builder kwargs and a small input: the channel widths are the full ones,
# the images small (each model's pooling still leaves a 1 x 1 map or
# more) but Inception-v3's, the classes 4
ZOO = {
    "mlp": ({}, (2, 1, 28, 28)),
    "lenet": ({}, (2, 1, 28, 28)),
    "alexnet": ({}, (2, 3, 67, 67)),
    "vgg": ({"num_layers": 11}, (2, 3, 32, 32)),
    "googlenet": ({}, (2, 3, 32, 32)),
    "inception_bn": ({}, (2, 3, 64, 64)),
    "inception_v3": ({}, (2, 3, 299, 299)),
    "resnext": ({"num_layers": 50, "image_shape": (3, 32, 32)},
                (2, 3, 32, 32)),
}
# the parameters the backward reaches before any ReLU mask
CLASSIFIER = {"mlp": "fc3_", "lenet": "fullyconnected1_",
              "inception_bn": "fc1_", "resnext": "fc_",
              "alexnet": "head_", "inception_v3": "head_"}


def _build(pkg, name, cut):
    """The zoo symbol (``pkg`` is either package's root), or the symbol
    cut at its first Dropout's input with a hand-built FC + SoftmaxOutput
    head; the names are pinned by a fresh NameManager."""
    kw, _ = ZOO[name]
    with pkg.NameManager():
        sym = getattr(pkg.models if pkg is mt else jmodels,
                      "get_" + name)(num_classes=4, **kw)
        if not cut:
            return sym
        nodes = json.loads(sym.tojson())["nodes"]
        drop = next(n for n in nodes if n["op"] == "Dropout")
        src = nodes[drop["inputs"][0][0]]["name"]
        body = sym.get_internals()[src + "_output"]
        head = pkg.sym.FullyConnected(pkg.sym.Flatten(body), num_hidden=4,
                                      name="head")
        return pkg.sym.SoftmaxOutput(head, name="softmax")


def _values(sym, shape, seed=5):
    """Seeded numpy parameters (He-scaled weights, gamma near 1), aux
    (moving mean near 0, variance near 1) and one batch."""
    shapes, _, aux_shapes = sym.infer_shape(data=shape,
                                            softmax_label=(shape[0],))
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
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    y = rng.randint(0, 4, shape[0]).astype(np.float32)
    return args, aux, x, y


def _jax_run(sym, shape, args, aux, x, y, steps, train):
    """The JAX Module's outputs and (arg, aux) numpy parameters after
    each of ``steps`` training steps (SGD-momentum through its
    per-parameter chain), or its eval forward when not ``train``."""
    dd, ld = JDesc("data", shape), JDesc("softmax_label", (shape[0],))
    batch = JBatch([jnd.array(x)], [jnd.array(y)], provide_data=[dd],
                   provide_label=[ld])
    with jconfig.overrides(MXNET_PALLAS_UPDATE=False):
        mod = mx.mod.Module(sym, context=mx.cpu())
        mod.bind(data_shapes=[dd], label_shapes=[ld], for_training=train)
        mod.init_params(arg_params={k: jnd.array(v) for k, v in
                                    args.items()},
                        aux_params={k: jnd.array(v) for k, v in aux.items()})
        if not train:
            mod.forward(batch, is_train=False)
            return np.asarray(mod.get_outputs()[0].asnumpy(), np.float32)
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


def _port_module(sym, shape, args, aux, train):
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(data_shapes=[DataDesc("data", shape)],
             label_shapes=[DataDesc("softmax_label", (shape[0],))],
             for_training=train)
    mod.init_params(arg_params=args, aux_params=aux)
    return mod


@pytest.mark.parametrize("name", sorted(ZOO))
def test_eval_forward_matches_jax(name):
    """The full symbol's inference forward (Dropout the identity)."""
    _, shape = ZOO[name]
    jsym, tsym = _build(mx, name, False), _build(mt, name, False)
    assert tsym.tojson() == jsym.tojson()
    args, aux, x, y = _values(tsym, shape)
    want = _jax_run(jsym, shape, args, aux, x, y, 1, train=False)
    mod = _port_module(tsym, shape, args, aux, train=False)
    mod.forward(DataBatch([mt.nd.array(x)], [mt.nd.array(y)]),
                is_train=False)
    got = mod.get_outputs()[0].asnumpy()
    assert got.shape == (shape[0], 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_OUT)


def _delta_errors(got, ref, start):
    """Per tensor ||port delta - reference delta|| / ||reference delta||
    (a delta under 1e-5 of the step's largest is measured on that floor:
    the conv biases that feed a BatchNorm have an analytically zero
    gradient, so both deltas are rounding noise), the max-abs form of the
    same ratio, and the whole step's norm-wise ratio."""
    norms, errs, maxabs = {}, {}, {}
    sq_err = sq_delta = 0.0
    for k, v in start.items():
        delta = ref[k].numpy().astype(np.float64) - v
        diff = got[k] - v - delta
        norms[k] = float(np.linalg.norm(delta))
        errs[k] = float(np.linalg.norm(diff))
        maxabs[k] = float(np.abs(diff).max()) / max(
            1e-30, float(np.abs(delta).max()))
        sq_err += errs[k] ** 2
        sq_delta += norms[k] ** 2
    floor = 1e-5 * max(norms.values())
    rel = {k: errs[k] / max(norms[k], floor) for k in errs}
    return rel, maxabs, float(np.sqrt(sq_err / sq_delta))


def two_steps_match_jax(name, cut):
    """Two SGD-momentum steps of ``name`` (cut before its first Dropout
    when ``cut``) with the slab plan armed, against the JAX Module, in
    the model's tolerances (``TOLS``); fixed gammas take a zero gradient
    and weight decay."""
    _, shape = ZOO[name]
    tol_out, tol_cl, tol_rest, tol_whole, tol_aux = TOLS.get(
        name, TOLS["*"])
    jsym, tsym = _build(mx, name, cut), _build(mt, name, cut)
    assert tsym.tojson() == jsym.tojson()
    args, aux, x, y = _values(tsym, shape)
    want_outs, want = _jax_run(jsym, shape, args, aux, x, y, 2, train=True)
    mod = _port_module(tsym, shape, args, aux, train=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    assert mod._train_step.plan is not None
    batch = DataBatch([mt.nd.array(x)], [mt.nd.array(y)])
    start, start_aux = args, aux
    for step in range(2):
        if step:
            mod.set_params(start, start_aux)
        mod.forward_backward(batch)
        mod.update()
        assert uk.UPDATE_PATH["last"] == "plain"
        out_err = np.abs(mod.get_outputs()[0].asnumpy()
                         - want_outs[step]).max()
        got = params_to_numpy(*mod.get_params())
        ref = params_from_jax(*want[step], device="cpu")
        rel, maxabs, whole = _delta_errors(got, ref, start)
        head = {k: v for k, v in maxabs.items()
                if k.startswith(CLASSIFIER[name])}
        rest = {k: v for k, v in (maxabs if tol_whole is None
                                  else rel).items() if k not in head}
        aux_err = max([np.abs(got["aux:" + k] - ref[k].numpy()).max()
                       / max(1.0, np.abs(ref[k].numpy()).max())
                       for k in start_aux] or [0.0])
        assert out_err <= tol_out, (step, out_err)
        assert max(head.values()) <= tol_cl, (step, head)
        worst = max(rest, key=rest.get)
        assert rest[worst] <= tol_rest, (step, worst, rest[worst])
        if tol_whole is not None:
            assert whole <= tol_whole, (step, whole)
        assert aux_err <= tol_aux, (step, aux_err)
        start = {k: ref[k].numpy() for k in args}
        start_aux = {k: ref[k].numpy() for k in aux}
    if name == "inception_v3":
        # fix_gamma: a zero gradient, so weight decay alone moves gamma
        exe = mod._exec_group.exec_
        gammas = [n for n in args if n.endswith("_gamma")]
        assert gammas and not any(exe.grad_dict[n].data.any()
                                  for n in gammas)


@pytest.mark.parametrize("name,cut", [("mlp", False), ("lenet", False),
                                      ("alexnet", True)])
def test_module_two_steps_match_jax(name, cut):
    """The small nets' two steps (the deep BatchNorm nets' are in
    ``tests/test_torch_zoo_train.py``)."""
    two_steps_match_jax(name, cut)
