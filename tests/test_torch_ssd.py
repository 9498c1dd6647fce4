"""The SSD example (``examples/ssd_detection.py``) through the port on
the CPU, against the JAX package: ``models.ssd.get_symbol()``'s JSON is
the example's ``ssd_symbol()`` byte for byte; from the JAX Module's
Xavier parameters (carried by ``weights.params_from_jax``) and one batch
of both packages' ``ImageDetIter`` (equal bit for bit), the training
forward's outputs and the gradients of every parameter, then three Adam
steps of ``Module`` (the port's compiled step, slab plan armed) and the
detections of the trained model.

Tolerances: the class targets, masks and the kept detections' class ids
and row order exactly; outputs and gradients within 1e-5 of each
tensor's largest magnitude (the libraries' convolutions sum in their own
orders, about 1e-7 apart); parameters after each Adam step within 1e-5
of the step's largest change; detection scores and boxes 1e-5.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import examples.ssd_detection as example
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.weights import params_from_jax, params_to_numpy

SHAPE = (3, 32, 32)
BATCH = 8
ADAM = {"learning_rate": 2e-3}


def _near(got, want, tol=1e-5, what=""):
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The example's record file (its make_dataset, 64 images) and one
    batch from each package's ImageDetIter, which must agree."""
    prefix = str(tmp_path_factory.mktemp("ssd") / "shapes")
    mt.models.ssd.make_dataset(prefix, n=64)
    kw = dict(batch_size=BATCH, data_shape=SHAPE, path_imgrec=prefix + ".rec",
              path_imgidx=prefix + ".idx", shuffle=True, rand_mirror=True,
              label_name="label", seed=0)
    jit, tit = example.ImageDetIter(**kw), mt.image.ImageDetIter(**kw)
    jb, tb = jit.next(), tit.next()
    for a, b in ((jb.data[0], tb.data[0]), (jb.label[0], tb.label[0])):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert tit.provide_label[0].shape == jit.provide_label[0].shape
    x, y = tb.data[0].asnumpy(), tb.label[0].asnumpy()
    return x, y, [tuple(d) for d in tit.provide_data], \
        [tuple(d) for d in tit.provide_label]


def test_symbol_json_is_the_examples():
    with mx.NameManager(), mt.NameManager():
        assert mt.models.ssd.get_symbol().tojson() == \
            example.ssd_symbol().tojson()


def _jax_module(data, steps):
    """The JAX Module: its Xavier start, then outputs and parameters after
    each Adam step, then the inference forward's outputs."""
    x, y, pdata, plabel = data
    mx.random.seed(0)
    with mx.NameManager():
        mod = mx.mod.Module(example.ssd_symbol(), data_names=("data",),
                            label_names=("label",), context=mx.cpu())
    mod.bind(data_shapes=[mx.io.DataDesc(*d) for d in pdata],
             label_shapes=[mx.io.DataDesc(*d) for d in plabel])
    mod.init_params(mx.initializer.Xavier())
    start = mod.get_params()
    start = ({k: v.asnumpy().copy() for k, v in start[0].items()},
             {k: v.asnumpy().copy() for k, v in start[1].items()})
    mod.init_optimizer(optimizer="adam", optimizer_params=ADAM)
    batch = mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)])
    trail = []
    for _ in range(steps):
        mod.forward_backward(batch)
        mod.update()
        trail.append(({k: v.asnumpy().copy()
                       for k, v in mod.get_params()[0].items()},
                      [o.asnumpy() for o in mod.get_outputs()]))
    mod.forward(batch, is_train=False)
    return start, trail, [o.asnumpy() for o in mod.get_outputs()]


def _executor_pass(pkg, ctx, params, x, y):
    """A bound symbol's training forward and backward (every parameter a
    gradient): outputs and gradients as numpy."""
    with pkg.NameManager():
        net = mt.models.ssd.get_symbol() if pkg is mt \
            else example.ssd_symbol()
    arrays = {k: pkg.nd.array(v, ctx=ctx) for k, v in params.items()}
    arrays["data"] = pkg.nd.array(x, ctx=ctx)
    arrays["label"] = pkg.nd.array(y, ctx=ctx)
    grads = {k: pkg.nd.zeros(v.shape, ctx=ctx) for k, v in params.items()}
    req = {k: ("write" if k in params else "null") for k in arrays}
    ex = net.bind(ctx, arrays, args_grad=grads, grad_req=req)
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward()
    return outs, {k: ex.grad_dict[k].asnumpy() for k in params}


def test_ssd_matches_the_jax_module(data):
    x, y, pdata, plabel = data
    start, trail, want_infer = _jax_module(data, steps=3)
    args = {k: v.numpy() for k, v in
            params_from_jax(start[0], start[1], device="cpu").items()}

    # the training forward and the gradients, through a bound symbol
    want_outs, want_grads = _executor_pass(mx, mx.cpu(), args, x, y)
    got_outs, got_grads = _executor_pass(mt, mt.cpu(), args, x, y)
    np.testing.assert_array_equal(got_outs[2], want_outs[2])  # cls_target
    for i, (g, w) in enumerate(zip(got_outs, want_outs)):
        _near(g, w, what="output %d" % i)
    for k in args:
        _near(got_grads[k], want_grads[k], what=k)

    # three Adam steps through Module: the compiled step, slab plan armed
    mod = mt.mod.Module(mt.models.ssd.get_symbol(), data_names=("data",),
                        label_names=("label",), context=mt.cpu())
    mod.bind(data_shapes=[mt.io.DataDesc(*d) for d in pdata],
             label_shapes=[mt.io.DataDesc(*d) for d in plabel])
    mod.init_params(arg_params=args)
    mod.init_optimizer(optimizer="adam", optimizer_params=ADAM)
    assert mod._train_step is not None and mod._train_step.plan is not None
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                            [mt.nd.array(y, ctx=mt.cpu())])
    prev = args
    for step, (want_params, want_step_outs) in enumerate(trail):
        mod.forward_backward(batch)
        mod.update()
        got = params_to_numpy(mod.get_params()[0])
        for k in args:
            delta = np.abs(want_params[k] - prev[k]).max()
            err = np.abs(got[k] - want_params[k]).max()
            assert err <= 1e-5 * max(delta, 1e-12) + 1e-7, (k, step, err)
        got_step_outs = [o.asnumpy() for o in mod.get_outputs()]
        np.testing.assert_array_equal(got_step_outs[2], want_step_outs[2])
        for i in (0, 1):
            _near(got_step_outs[i], want_step_outs[i],
                  what="step %d output %d" % (step, i))
        prev = want_params
        mod.set_params(want_params, {})

    # the detections of the trained model
    mod.forward(batch, is_train=False)
    det = mod.get_outputs()[3].asnumpy()
    want_det = want_infer[3]
    assert det.shape == want_det.shape == (BATCH, 256, 6)
    np.testing.assert_array_equal(det[..., 0], want_det[..., 0])
    _near(det[..., 1:], want_det[..., 1:], what="detections")
    assert (det[..., 0] >= 0).any()
