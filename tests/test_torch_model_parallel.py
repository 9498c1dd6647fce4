"""Model parallelism by placement (``group2ctx``) through the port: the
six cases of ``tests/test_model_parallel.py``, each held against the JAX
package on the same numpy values.

Every ``cpu(i)`` is one torch device, so on the host the placement map
is what differs between groups: it is held against the reference's
(node by node, the same contexts), with the numbers; the card phase of
``chip_smoke.py`` holds the transfers between the card and the host.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError


def _chain_net(pkg):
    data1 = pkg.sym.Variable("data1")
    data2 = pkg.sym.Variable("data2")
    with pkg.AttrScope(ctx_group="dev1"):
        net = data1 + data2
        net = net * 3.0
    with pkg.AttrScope(ctx_group="dev2"):
        net = net + data1
    return net


def _placement_map(exe):
    """{node name: cpu index} of a placed executor: the port keeps
    Contexts, the JAX package jax devices."""
    return {n: c.device_id if isinstance(c, mt.Context) else c.id
            for n, c in exe._placement.items()}


def _both(fn):
    """``fn(pkg)`` for both packages, the port's under ``with cpu()``;
    auto-names pinned so the graphs' names agree."""
    with mx.NameManager():
        want = fn(mx)
    with mt.cpu(), mt.NameManager():
        got = fn(mt)
    return got, want


def test_group2ctx_matches_single_device_and_jax():
    shape = (4, 5)
    vals = [np.random.RandomState(3).rand(*shape).astype(np.float32),
            np.random.RandomState(4).rand(*shape).astype(np.float32)]

    def run(pkg):
        net = _chain_net(pkg)
        res = {}
        for key, g2c in (("mp", {"dev1": pkg.cpu(0), "dev2": pkg.cpu(1)}),
                         ("sd", None)):
            grads = [pkg.nd.zeros(shape), pkg.nd.zeros(shape)]
            exe = net.bind(pkg.cpu(), args=[pkg.nd.array(v) for v in vals],
                           args_grad=grads, group2ctx=g2c)
            out = exe.forward(is_train=True)[0].asnumpy()
            exe.backward([pkg.nd.ones(shape)])
            res[key] = [out] + [g.asnumpy() for g in grads]
            if g2c:
                res["placement"] = _placement_map(exe)
        return res

    got, want = _both(run)
    assert got["placement"] == want["placement"]
    for key in ("mp", "sd"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g, w, rtol=1e-6)
    for g, w in zip(got["mp"], got["sd"]):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_group2ctx_places_nodes_on_distinct_contexts():
    def run(pkg):
        net = _chain_net(pkg)
        exe = net.bind(pkg.cpu(), args=[pkg.nd.ones((2, 2)),
                                        pkg.nd.ones((2, 2))],
                       group2ctx={"dev1": pkg.cpu(2), "dev2": pkg.cpu(5)})
        out = exe.forward()[0].asnumpy()
        return _placement_map(exe), out, net.get_internals().list_outputs()

    (got, gout, gnames), (want, wout, _) = _both(run)
    assert got == want and set(got.values()) == {2, 5}
    np.testing.assert_allclose(gout, wout)
    # the output comes from the dev2 stage: the last op node is placed
    last = [n for n in gnames if n.endswith("_output")][-1]
    assert got[last[:-len("_output")]] == 5


def test_group2ctx_join_on_default_device():
    """An unannotated op joining two placed groups runs on the bind
    context (it is not in the placement map)."""
    def run(pkg):
        d1, d2 = pkg.sym.Variable("d1"), pkg.sym.Variable("d2")
        with pkg.AttrScope(ctx_group="g1"):
            x = d1 * 2.0
        with pkg.AttrScope(ctx_group="g2"):
            y = d2 * 3.0
        net = x + y
        exe = net.bind(pkg.cpu(0), args=[pkg.nd.ones((2, 2)),
                                         pkg.nd.ones((2, 2))],
                       group2ctx={"g1": pkg.cpu(1), "g2": pkg.cpu(2)})
        return exe.forward()[0].asnumpy(), _placement_map(exe), \
            net.name

    (gout, gmap, gname), (wout, wmap, _) = _both(run)
    np.testing.assert_allclose(gout, np.full((2, 2), 5.0))
    np.testing.assert_allclose(gout, wout)
    assert gmap == wmap and gname not in gmap


def test_group2ctx_weights_resident_on_placed_device():
    """Parameters created inside an AttrScope are placed with their
    group (arrays on its device), and their gradients stay there."""
    def run(pkg):
        data = pkg.sym.Variable("data")
        with pkg.AttrScope(ctx_group="s0"):
            net = pkg.sym.FullyConnected(data, num_hidden=4, name="fc0")
        exe = net.simple_bind(pkg.cpu(0), group2ctx={"s0": pkg.cpu(3)},
                              data=(2, 3))
        exe.arg_dict["fc0_weight"][:] = np.arange(12, dtype=np.float32
                                                  ).reshape(4, 3) / 10
        exe.arg_dict["data"][:] = np.ones((2, 3), np.float32)
        exe.forward(is_train=True)
        exe.backward()
        return (_placement_map(exe), exe.outputs[0].asnumpy(),
                exe.grad_dict["fc0_weight"].asnumpy(), exe)

    (gmap, gout, ggrad, exe), (wmap, wout, wgrad, _) = _both(run)
    assert gmap["fc0_weight"] == 3 and gmap == wmap
    dev = mt.context.resolve_device(mt.cpu(3))
    assert exe.arg_dict["fc0_weight"].data.device == dev
    assert exe.grad_dict["fc0_weight"].data.device == dev
    assert not exe._capturable       # a placed graph runs eagerly
    np.testing.assert_allclose(gout, wout, rtol=1e-6)
    np.testing.assert_allclose(ggrad, wgrad, rtol=1e-6)


def test_group2ctx_unknown_group_raises():
    for pkg, err in ((mx, mx.base.MXNetError), (mt, MXNetError)):
        with mt.cpu():
            net = _chain_net(pkg)
            with pytest.raises(err, match="has no entry in group2ctx"):
                net.bind(pkg.cpu(), args=[pkg.nd.ones((2, 2)),
                                          pkg.nd.ones((2, 2))],
                         group2ctx={"dev1": pkg.cpu(0)})


def test_model_parallel_mlp_training():
    """Two FC stages on different contexts train to the same outputs and
    gradients as one context, and as the JAX package's placed
    executor."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 6).astype(np.float32)

    def build(pkg):
        data = pkg.sym.Variable("data")
        with pkg.AttrScope(ctx_group="stage0"):
            h = pkg.sym.Activation(pkg.sym.FullyConnected(
                data, num_hidden=16, name="fc0"), act_type="relu")
        with pkg.AttrScope(ctx_group="stage1"):
            out = pkg.sym.FullyConnected(h, num_hidden=4, name="fc1")
        return pkg.sym.MakeLoss(pkg.sym.sum(out * out))

    net = build(mt)
    arg_shapes, _, _ = net.infer_shape(data=(8, 6))
    init = {n: rng.randn(*s).astype(np.float32) * 0.1
            for n, s in zip(net.list_arguments(), arg_shapes)}
    init["data"] = x

    def run(pkg):
        net = build(pkg)
        res = {}
        for key, g2c in (("mp", {"stage0": pkg.cpu(1),
                                 "stage1": pkg.cpu(3)}), ("sd", None)):
            args = {n: pkg.nd.array(v) for n, v in init.items()}
            grads = {n: pkg.nd.zeros(v.shape) for n, v in init.items()
                     if n != "data"}
            exe = net.bind(pkg.cpu(), args=args, args_grad=grads,
                           group2ctx=g2c)
            exe.forward(is_train=True)
            exe.backward()
            res[key] = {"out": exe.outputs[0].asnumpy(),
                        **{n: g.asnumpy() for n, g in
                           exe.grad_dict.items()}}
        return res

    got, want = _both(run)
    for key in ("mp", "sd"):
        for n in got[key]:
            np.testing.assert_allclose(got[key][n], want[key][n],
                                       rtol=1e-4, atol=1e-5)
    for n in got["mp"]:
        np.testing.assert_allclose(got["mp"][n], got["sd"][n], rtol=1e-5,
                                   atol=1e-6)


def test_reshape_keeps_the_placement():
    """``Executor.reshape`` carries ``group2ctx`` (the reference's
    ``reshape`` passes it on)."""
    with mt.cpu():
        data = mt.sym.Variable("data")
        with mt.AttrScope(ctx_group="s0"):
            net = mt.sym.FullyConnected(data, num_hidden=4, name="fc0")
        exe = net.simple_bind(mt.cpu(0), group2ctx={"s0": mt.cpu(3)},
                              data=(2, 3))
        new = exe.reshape(data=(1, 3))
    assert _placement_map(new) == _placement_map(exe)
    assert new.arg_dict["fc0_weight"] is exe.arg_dict["fc0_weight"]
