"""User ops and python modules through both packages on the CPU:
``Custom`` (``mxnet_tpu_torch/operator.py``) imperatively, in a bound
symbol and trained by ``Module.fit``, and ``PythonModule`` /
``PythonLossModule`` / ``SequentialModule`` — the cases of
``tests/test_spatial_contrib.py`` (Custom) and
``tests/test_python_module.py``, each run in the JAX package and in the
port from the same numpy values and held against each other.

A graph with a Custom node is never captured in the port (its body may
read values back to the host): the compiled train step refuses it and
``Module`` trains eagerly with a warning.  Values: rtol 1e-5 for a
forward or a gradient, 1e-4 (relative to each parameter's norm) after
the training runs, whose f32 updates round in each library's order.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError


def _register(pkg):
    """The reference tests' two user ops, "sqr" and "scale2x", in
    ``pkg``."""
    op_mod = pkg.operator

    class Sqr(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2.0 * in_data[0] * out_grad[0])

    @op_mod.register("sqr")
    class SqrProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Sqr()

    class Scale2(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2.0)

    @op_mod.register("scale2x")
    class Scale2Prop(op_mod.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Scale2()


_register(mx)
_register(mt)


def _rel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-12))


def test_custom_forward_backward():
    """nd.Custom, then a bound symbol's forward and backward with a head
    gradient, in both packages."""
    x = np.random.RandomState(42).rand(3, 4).astype(np.float32)
    head = np.random.RandomState(43).randn(3, 4).astype(np.float32)
    res = {}
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        with ctx:
            y = pkg.nd.Custom(pkg.nd.array(x), op_type="sqr").asnumpy()
            net = pkg.sym.Custom(pkg.sym.Variable("data"), op_type="sqr",
                                 name="sqr")
            ex = net.bind(ctx, {"data": pkg.nd.array(x)},
                          args_grad={"data": pkg.nd.zeros(x.shape)})
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward(out_grads=pkg.nd.array(head))
            res[pkg] = (y, out, ex.grad_dict["data"].asnumpy(),
                        net.tojson(), net.infer_shape(data=(3, 4)))
    for got, want in zip(res[mt][:3], res[mx][:3]):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(res[mt][0], x * x, rtol=1e-6)
    np.testing.assert_allclose(res[mt][2], 2 * x * head, rtol=1e-5)
    assert res[mt][3] == res[mx][3]
    assert [list(map(tuple, s)) for s in res[mt][4]] == \
        [list(map(tuple, s)) for s in res[mx][4]]


def test_custom_under_autograd():
    """nd.Custom inside autograd.record(): the user's backward supplies
    the gradient, as in the JAX package."""
    x = np.random.RandomState(44).rand(2, 5).astype(np.float32)
    grads = {}
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        with ctx:
            a = pkg.nd.array(x)
            g = pkg.nd.zeros(x.shape)
            pkg.autograd.mark_variables([a], [g])
            with pkg.autograd.record():
                y = pkg.nd.Custom(a, op_type="sqr") * 3.0
            pkg.autograd.backward([y])
            grads[pkg] = g.asnumpy()
    np.testing.assert_allclose(grads[mt], grads[mx], rtol=1e-5)
    np.testing.assert_allclose(grads[mt], 6 * x, rtol=1e-5)


def _custom_net(pkg):
    sym = pkg.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=8, name="fc1")
    net = sym.Custom(net, op_type="scale2x", name="c")
    net = sym.FullyConnected(net, num_hidden=2, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def test_custom_graph_trains_eagerly(caplog):
    """Module.fit over a Custom graph: the port refuses the compiled step
    (a warning), trains eagerly and ends where the JAX Module ends."""
    rng = np.random.RandomState(7)
    X = rng.randn(40, 6).astype(np.float32)
    y = (X @ rng.randn(6).astype(np.float32) > 0).astype(np.float32)
    init = {"fc1_weight": rng.randn(8, 6).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rng.randn(2, 8).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(2, np.float32)}
    params, acc = {}, {}
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        it = pkg.io.NDArrayIter({"data": X}, {"softmax_label": y},
                                batch_size=10)
        mod = pkg.mod.Module(_custom_net(pkg), context=ctx)
        with caplog.at_level(logging.WARNING):
            mod.fit(it, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.5},
                    arg_params={k: pkg.nd.array(v, ctx=ctx)
                                for k, v in init.items()},
                    num_epoch=8)
        acc[pkg] = dict(mod.score(it, "acc"))["accuracy"]
        params[pkg] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        if pkg is mt:
            assert mod._train_step is None
            assert "compiled train step unavailable" in caplog.text
    for k in init:
        assert _rel(params[mt][k], params[mx][k]) < 1e-4, k
    assert acc[mt] == acc[mx] > 0.8


def test_compiled_step_refuses_a_custom_graph():
    mod = mt.mod.Module(_custom_net(mt), context=mt.cpu())
    mod.bind([("data", (4, 6))], [("softmax_label", (4,))])
    mod.init_params(mt.initializer.Xavier())
    with pytest.raises(MXNetError, match="Custom"):
        mt.train_step.CompiledTrainStep(
            mod._exec_group, mt.optimizer.create("sgd"),
            mt.optimizer.get_updater(mt.optimizer.create("sgd")))


def test_custom_aux_states_are_refused():
    @mt.operator.register("with_aux")
    class AuxProp(mt.operator.CustomOpProp):
        def list_auxiliary_states(self):
            return ["state"]

    with mt.cpu(), pytest.raises(MXNetError, match="aux"):
        mt.nd.Custom(mt.nd.ones((2,)), op_type="with_aux")


# ---------------------------------------------------------------------------
# python modules (tests/test_python_module.py's cases)
# ---------------------------------------------------------------------------

def _mse(pkg):
    if pkg is mx:
        import jax.numpy as jnp

        return lambda pred, label: jnp.mean((pred - label[:, None]) ** 2)
    return lambda pred, label: ((pred - label[:, None]) ** 2).mean()


def test_passthrough_loss_module():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    g = np.full((4, 3), 2.0, np.float32)
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        with ctx:
            m = pkg.mod.PythonLossModule()
            m.bind(data_shapes=[("data", (4, 3))],
                   label_shapes=[("softmax_label", (4,))])
            m.init_params()
            m.forward(pkg.io.DataBatch([pkg.nd.array(x)],
                                       [pkg.nd.zeros((4,))]))
            np.testing.assert_array_equal(m.get_outputs()[0].asnumpy(), x)
            m.backward([pkg.nd.array(g)])
            np.testing.assert_array_equal(m.get_input_grads()[0].asnumpy(),
                                          g)
            m2 = pkg.mod.PythonLossModule()
            m2.bind(data_shapes=[("data", (4, 3))])
            m2.forward(pkg.io.DataBatch([pkg.nd.array(x)], []))
            with pytest.raises(Exception, match="out_grads"):
                m2.backward()


def test_loss_function_and_grad_func():
    """A loss function's value and autograd gradient (jax.grad in the
    JAX package, torch's autograd in the port), and an explicit
    grad_func, alike in both packages."""
    rng = np.random.RandomState(0)
    p = rng.normal(size=(4, 3)).astype(np.float32)
    y = rng.normal(size=(4,)).astype(np.float32)
    res = {}
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        with ctx:
            m = pkg.mod.PythonLossModule(loss_function=_mse(pkg))
            m.bind(data_shapes=[("data", (4, 3))],
                   label_shapes=[("softmax_label", (4,))])
            m.forward(pkg.io.DataBatch([pkg.nd.array(p)], [pkg.nd.array(y)]))
            loss = m.get_outputs()[0].asnumpy()
            m.backward()
            calls = []

            def gf(pred, label, pkg=pkg):
                calls.append(1)
                return pkg.nd.array(np.full(pred.shape, 7.0, np.float32))

            m2 = pkg.mod.PythonLossModule(grad_func=gf)
            m2.bind(data_shapes=[("data", (2, 2))])
            m2.forward(pkg.io.DataBatch([pkg.nd.ones((2, 2))], []))
            m2.backward()
            assert calls == [1]
            np.testing.assert_array_equal(
                m2.get_input_grads()[0].asnumpy(), np.full((2, 2), 7.0))
            res[pkg] = (loss, m.get_input_grads()[0].asnumpy())
    for got, want in zip(res[mt], res[mx]):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(res[mt][1], 2.0 * (p - y[:, None]) / p.size,
                               rtol=1e-5)


def test_sequential_module_trains_alike():
    """Module (features) -> PythonLossModule through SequentialModule,
    Adam from the same start: the port's predictions and parameters end
    where the JAX package's do."""
    rng = np.random.RandomState(1)
    x = rng.normal(size=(128, 6)).astype(np.float32)
    w_true = rng.normal(size=(6,)).astype(np.float32)
    y = (x @ w_true).astype(np.float32)
    init = {"fc_weight": rng.uniform(-0.1, 0.1, (1, 6)).astype(np.float32),
            "fc_bias": np.zeros(1, np.float32)}
    res = {}
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        with ctx:
            net = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                         num_hidden=1, name="fc")
            feat = pkg.mod.Module(net, label_names=[], context=ctx)
            loss = pkg.mod.PythonLossModule(loss_function=_mse(pkg))
            seq = pkg.mod.SequentialModule()
            seq.add(feat, auto_wiring=True).add(loss, take_labels=True)
            seq.bind(data_shapes=[pkg.io.DataDesc("data", (32, 6))],
                     label_shapes=[pkg.io.DataDesc("softmax_label", (32,))])
            seq.init_params(arg_params={k: pkg.nd.array(v)
                                        for k, v in init.items()})
            seq.init_optimizer(optimizer="adam",
                               optimizer_params={"learning_rate": 0.2})
            it = pkg.io.NDArrayIter(x, y, batch_size=32)
            for _ in range(4):
                it.reset()
                for batch in it:
                    seq.forward(batch, is_train=True)
                    seq.backward()
                    seq.update()
            it.reset()
            seq.forward(next(iter(it)), is_train=False)
            res[pkg] = (seq.get_outputs()[0].asnumpy(),
                        {k: v.asnumpy()
                         for k, v in seq.get_params()[0].items()})
            # it learns: the weights close on the generating ones
            w = res[pkg][1]["fc_weight"][0]
            assert np.linalg.norm(w - w_true) < \
                0.5 * np.linalg.norm(init["fc_weight"][0] - w_true)
    np.testing.assert_allclose(res[mt][0], res[mx][0], rtol=1e-4, atol=1e-5)
    for k in init:
        assert _rel(res[mt][1][k], res[mx][1][k]) < 1e-4, k


def test_sequential_module_chains_two_modules():
    """Two symbol stages: the second's input gradient feeds the first's
    backward; parameters after two SGD steps equal the JAX package's."""
    rng = np.random.RandomState(3)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.float32)
    init = {"fc1_weight": rng.normal(size=(4, 5)).astype(np.float32) * 0.4,
            "fc1_bias": np.zeros(4, np.float32),
            "fc2_weight": rng.normal(size=(3, 4)).astype(np.float32) * 0.4,
            "fc2_bias": np.zeros(3, np.float32)}
    res = {}
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        with ctx:
            sym = pkg.sym
            s1 = sym.Activation(sym.FullyConnected(
                sym.Variable("data"), num_hidden=4, name="fc1"),
                act_type="tanh", name="t1")
            s2 = sym.SoftmaxOutput(sym.FullyConnected(
                sym.Variable("data"), num_hidden=3, name="fc2"),
                name="softmax")
            seq = pkg.mod.SequentialModule()
            seq.add(pkg.mod.Module(s1, label_names=[], context=ctx))
            seq.add(pkg.mod.Module(s2, context=ctx), take_labels=True,
                    auto_wiring=True)
            seq.bind(data_shapes=[("data", (8, 5))],
                     label_shapes=[("softmax_label", (8,))])
            seq.init_params(arg_params={k: pkg.nd.array(v)
                                        for k, v in init.items()},
                            allow_missing=True)
            seq.init_optimizer(optimizer="sgd",
                               optimizer_params={"learning_rate": 0.5})
            batch = pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)])
            for _ in range(2):
                seq.forward(batch, is_train=True)
                seq.backward()
                seq.update()
            metric = pkg.metric.create("acc")
            seq.update_metric(metric, batch.label)
            res[pkg] = ({k: v.asnumpy()
                         for k, v in seq.get_params()[0].items()},
                        metric.get()[1])
    for k in init:
        np.testing.assert_allclose(res[mt][0][k], res[mx][0][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert res[mt][1] == res[mx][1]
