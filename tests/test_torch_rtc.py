"""User-registered device kernels — the port's ``rtc``
(``mxnet_tpu_torch/rtc.py``) against the JAX package's
``register_pallas_op`` (``mxnet_tpu/rtc.py``).

``tests/test_rtc.py``'s four cases run through both packages on the
same numpy inputs: the JAX op's forward is a Pallas kernel in interpret
mode, the port's forward is the plain PyTorch version it runs on a CPU
tensor (its CUDA launch is held on the card, ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 18).  Outputs and gradients agree at rtol
1e-5 (both f32: x * alpha + y rounds once on each side).  A small MLP
with the op inside trains 3 steps through the captured ``Module`` step
bit for bit against the same steps under ``programs.eager()``.
"""
import functools

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import programs

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    with mt.cpu():
        yield


def _jax_scale_add(name):
    import jax
    from jax.experimental import pallas as pl

    def kernel(x_ref, y_ref, o_ref, *, alpha):
        o_ref[...] = x_ref[...] * alpha + y_ref[...]

    def forward(x, y, alpha=2.0):
        return pl.pallas_call(
            functools.partial(kernel, alpha=alpha),
            out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=True)(x, y)

    def backward(inputs, outputs, cotangents, alpha=2.0):
        (g,) = cotangents
        return [g * alpha, g]

    return mx.rtc.register_pallas_op(name, forward, backward=backward,
                                     num_inputs=2,
                                     attr_params={"alpha": 2.0})


def _torch_scale_add(name):
    """The port's op: on a CPU (or meta) tensor the forward is its plain
    version; on a card it would launch the user kernel."""
    def forward(x, y, alpha=2.0):
        if x.device.type == "cuda":
            raise AssertionError("the CPU tests launch no kernel")
        return x * alpha + y

    def backward(inputs, outputs, cotangents, alpha=2.0):
        (g,) = cotangents
        return [g * alpha, g]

    return mt.rtc.register_cuda_op(name, forward, backward=backward,
                                   num_inputs=2,
                                   attr_params={"alpha": 2.0})


OPS = {"jax": _jax_scale_add("torch_rtc_scale_add"),
       "port": _torch_scale_add("torch_rtc_scale_add")}
PKGS = {"jax": mx, "port": mt}


def test_cuda_op_imperative_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 8).astype(np.float32)
    got = {k: p.nd.torch_rtc_scale_add(p.nd.array(x), p.nd.array(y),
                                       alpha=3.0).asnumpy()
           for k, p in PKGS.items()}
    np.testing.assert_allclose(got["port"], got["jax"], rtol=RTOL)
    np.testing.assert_allclose(got["port"], x * 3.0 + y, rtol=RTOL)
    assert OPS["port"].user_defined and OPS["jax"].user_defined


def test_cuda_op_symbolic_and_gradient_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 6).astype(np.float32)
    y = rng.randn(4, 6).astype(np.float32)
    dy = rng.randn(4, 6).astype(np.float32)
    got = {}
    for k, p in PKGS.items():
        a, b = p.sym.Variable("a"), p.sym.Variable("b")
        net = p.sym.torch_rtc_scale_add(a, b, alpha=1.5)
        ex = net.bind(p.cpu(), {"a": p.nd.array(x), "b": p.nd.array(y)},
                      args_grad={"a": p.nd.zeros(x.shape),
                                 "b": p.nd.zeros(y.shape)})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(out_grads=p.nd.array(dy))
        got[k] = (out, ex.grad_dict["a"].asnumpy(),
                  ex.grad_dict["b"].asnumpy())
    for g, w in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(g, w, rtol=RTOL)
    np.testing.assert_allclose(got["port"][1], 1.5 * dy, rtol=RTOL)
    np.testing.assert_allclose(got["port"][2], dy, rtol=RTOL)


def test_cuda_op_forward_only_blocks_grad():
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    def kernel(x_ref, o_ref):
        o_ref[...] = jnp.tanh(x_ref[...])

    def jforward(x):
        return pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=True)(x)

    mx.rtc.register_pallas_op("torch_rtc_fwd_only", jforward)
    mt.rtc.register_cuda_op("torch_rtc_fwd_only", lambda x: x.tanh())
    ones = np.ones((2, 2), np.float32)
    for p in PKGS.values():
        np.testing.assert_allclose(
            p.nd.torch_rtc_fwd_only(p.nd.array(ones)).asnumpy(),
            np.tanh(ones), rtol=RTOL)

    def loss(v):
        import mxnet_tpu.registry as reg

        return jnp.sum(reg.invoke(reg.get_op("torch_rtc_fwd_only"), [v],
                                  {})[0])

    # no backward registered: differentiating fails loudly in both
    with pytest.raises(Exception):
        jax.grad(loss)(jnp.ones((2, 2)))
    x = mt.nd.array(ones)
    mt.autograd.mark_variables([x], [mt.nd.zeros((2, 2))])
    with mt.autograd.record():
        y = mt.nd.torch_rtc_fwd_only(x)
    with pytest.raises(mt.MXNetError, match="without a backward"):
        mt.autograd.backward([y])


@pytest.mark.parametrize("name", ["FullyConnected", "torch_rtc_scale_add",
                                  "array", "Variable"])
def test_cuda_op_name_collision_rejected(name):
    """An op already registered, or a name of ``mx.nd`` / ``mx.sym``, is
    refused in both packages."""
    for pkg, reg in ((mx, mx.rtc.register_pallas_op),
                     (mt, mt.rtc.register_cuda_op)):
        with pytest.raises(pkg.MXNetError):
            reg(name, lambda x: x)


def test_cuda_op_trains_through_the_captured_module_step():
    """A small MLP with the op between its layers, 3 SGD steps through
    the compiled Module step, bit for bit against the same 3 steps under
    ``programs.eager()`` from the same parameters."""
    rng = np.random.RandomState(2)
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randint(0, 3, size=8).astype(np.float32)
    args = {"fc1_weight": rng.randn(5, 6).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(5, np.float32),
            "skip_weight": rng.randn(5, 6).astype(np.float32) * 0.3,
            "skip_bias": np.zeros(5, np.float32),
            "fc2_weight": rng.randn(3, 5).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(3, np.float32)}
    data = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(data, num_hidden=5, name="fc1")
    s = mt.sym.FullyConnected(data, num_hidden=5, name="skip")
    h = mt.sym.torch_rtc_scale_add(h, s, alpha=0.5)
    h = mt.sym.Activation(h, act_type="tanh")
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(h, num_hidden=3,
                                                     name="fc2"),
                               name="softmax")

    def train(eager):
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        mod.init_params(arg_params={k: mt.nd.array(v)
                                    for k, v in args.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        assert mod._train_step is not None
        batch = mt.io.DataBatch([mt.nd.array(x)], [mt.nd.array(y)])
        for _ in range(3):
            if eager:
                with programs.eager():
                    mod.forward_backward(batch)
                    mod.update()
            else:
                mod.forward_backward(batch)
                mod.update()
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    captured, eager = train(False), train(True)
    for k in args:
        np.testing.assert_array_equal(captured[k], eager[k])
        assert not np.array_equal(captured[k], args[k]) \
            or k.endswith("bias")
