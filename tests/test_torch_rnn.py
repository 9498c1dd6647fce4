"""The PyTorch port's recurrent pieces held against the JAX package on
the CPU: the fused ``RNN`` op (all four modes, one and two directions),
``FusedRNNCell``'s pack / unpack, every cell class's unrolled graph,
``BucketSentenceIter``, and the tensor / elementwise ops the cells build.
Inputs are made from seeded numpy and fed to both packages.

Tolerances: forward values 1e-5 absolute (f32 on both sides; the port's
recurrence is ATen's native loop, the reference's ``lax.scan``, so the
products are summed in another order); gradients 1e-4 relative to the
largest magnitude of each reference gradient (the same rounding chained
back through T steps and two layers).  The iterator's batches are exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import registry as jreg
from mxnet_tpu.base import NameManager as JNameManager

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import registry as treg
from mxnet_tpu_torch.base import NameManager as TNameManager
from mxnet_tpu_torch.executor import simple_bind


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    """Arrays made without a context go to the host: the port's default
    context is the card."""
    with mt.cpu():
        yield


torch.set_num_threads(1)

TOL_OUT = 1e-5
TOL_GRAD = 1e-4
L, T, N, I, H = 2, 5, 3, 8, 6


def _jax_op(name, attrs, inputs, is_train=False):
    op = jreg.get_op(name)
    parsed = op.parse_attrs({k: str(v) for k, v in attrs.items()})
    outs, _ = op.fcompute(parsed, [jnp.asarray(x) for x in inputs], [],
                          jreg.OpContext(is_train=is_train,
                                         rng=jax.random.PRNGKey(0)))
    return list(outs)


def _torch_op(name, attrs, inputs, is_train=False):
    op = treg.get_op(name)
    parsed = op.parse_attrs({k: str(v) for k, v in attrs.items()})
    outs, _ = op.fcompute(parsed, inputs, [], treg.OpContext(
        is_train=is_train))
    return list(outs)


def _vjp_pair(name, attrs, inputs, cot_seed=7, is_train=False):
    """(outputs, input gradients) of both packages for one op, the
    gradients of sum(outputs * random cotangents)."""
    shapes = jax.eval_shape(lambda *xs: _jax_op(name, attrs, xs, is_train),
                            *[jnp.asarray(x) for x in inputs])
    rng = np.random.RandomState(cot_seed)
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in shapes]

    def jloss(*xs):
        outs = _jax_op(name, attrs, xs, is_train)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    # one traced program for the outputs and the gradients
    (_, jouts), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(len(inputs))), has_aux=True))(
        *[jnp.asarray(x) for x in inputs])
    tin = [torch.tensor(x, requires_grad=True) for x in inputs]
    touts = _torch_op(name, attrs, tin, is_train)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cots))
    tgrads = torch.autograd.grad(loss, tin, allow_unused=True) \
        if loss.requires_grad else [None] * len(tin)
    tgrads = [torch.zeros_like(x) if g is None else g
              for x, g in zip(tin, tgrads)]
    return ([np.asarray(o) for o in jouts],
            [o.detach().numpy() for o in touts],
            [np.asarray(g) for g in jgrads],
            [g.numpy() for g in tgrads])


def _assert_grads(jgrads, tgrads):
    for jg, tg in zip(jgrads, tgrads):
        scale = max(float(np.abs(jg).max()), 1e-30)
        assert float(np.abs(tg - jg).max()) / scale <= TOL_GRAD


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_matches_jax(mode, bidirectional):
    """Outputs, final states and the gradients of data, the flat
    parameter blob and the initial states."""
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size

    d = 2 if bidirectional else 1
    rng = np.random.RandomState(3)
    inputs = [rng.uniform(-1, 1, (T, N, I)).astype(np.float32),
              rng.uniform(-0.4, 0.4, rnn_param_size(
                  L, H, mode, bidirectional, I)).astype(np.float32),
              rng.uniform(-0.5, 0.5, (L * d, N, H)).astype(np.float32)]
    if mode == "lstm":
        inputs.append(rng.uniform(-0.5, 0.5, (L * d, N, H)).astype(
            np.float32))
    attrs = {"state_size": H, "num_layers": L, "mode": mode,
             "bidirectional": bidirectional, "state_outputs": True}
    jouts, touts, jgrads, tgrads = _vjp_pair("RNN", attrs, inputs)
    assert [o.shape for o in touts] == [o.shape for o in jouts]
    assert touts[0].shape == (T, N, H * d)
    for jo, to in zip(jouts, touts):
        np.testing.assert_allclose(to, jo, rtol=0, atol=TOL_OUT)
    _assert_grads(jgrads, tgrads)


def test_fused_cell_pack_unpack_matches_jax():
    """unpack_weights gives the JAX package's per-gate arrays, and
    pack_weights their blob back, bit for bit."""
    psize = mx.ops.rnn_op.rnn_param_size(2, H, "gru", True, I)
    flat = np.random.RandomState(4).uniform(-1, 1, psize).astype(np.float32)
    jcell = mx.rnn.FusedRNNCell(H, num_layers=2, mode="gru",
                                bidirectional=True, prefix="gru_")
    tcell = mt.rnn.FusedRNNCell(H, num_layers=2, mode="gru",
                                bidirectional=True, prefix="gru_")
    junp = jcell.unpack_weights({"gru_parameters": flat})
    tunp = tcell.unpack_weights({"gru_parameters": mt.nd.array(flat)})
    assert sorted(junp) == sorted(tunp) and "gru_parameters" not in tunp
    for k in junp:
        np.testing.assert_array_equal(tunp[k], junp[k])
    np.testing.assert_array_equal(
        tcell.pack_weights(tunp)["gru_parameters"], flat)
    # the unfused stack carries the unpacked names
    assert set(tcell.unfuse().params._params) == set(
        jcell.unfuse().params._params)


def _cell(pkg, kind):
    r = pkg.rnn
    if kind == "rnn":
        return r.RNNCell(H, activation="relu", prefix="r_")
    if kind == "lstm":
        return r.LSTMCell(H, prefix="l_", forget_bias=2.0)
    if kind == "gru":
        return r.GRUCell(H, prefix="g_")
    if kind == "fused_lstm":
        return r.FusedRNNCell(H, num_layers=2, mode="lstm", prefix="f_",
                              get_next_state=True)
    if kind == "fused_gru_bi":
        return r.FusedRNNCell(H, num_layers=2, mode="gru",
                              bidirectional=True, prefix="fb_",
                              get_next_state=True)
    if kind == "unfused":
        return r.FusedRNNCell(H, num_layers=2, mode="lstm",
                              bidirectional=True, prefix="u_").unfuse()
    if kind == "sequential":
        cell = r.SequentialRNNCell()
        cell.add(r.LSTMCell(H, prefix="s0_"))
        cell.add(r.DropoutCell(0.0, prefix="sd_"))
        cell.add(r.GRUCell(H, prefix="s1_"))
        return cell
    if kind == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(H // 2, prefix="bl_"),
                                   r.GRUCell(H // 2, prefix="br_"))
    if kind == "dropout":
        return r.DropoutCell(0.5, prefix="d_")
    if kind == "zoneout":
        return r.ZoneoutCell(r.LSTMCell(H, prefix="z_"), zoneout_outputs=0.3,
                             zoneout_states=0.2)
    if kind == "residual":
        return r.ResidualCell(r.GRUCell(I, prefix="res_"))
    raise ValueError(kind)


CELLS = ["rnn", "lstm", "gru", "fused_lstm", "fused_gru_bi", "unfused",
         "sequential", "bidirectional", "dropout", "zoneout", "residual"]


def _unrolled(pkg, names, kind, merge):
    with names():
        cell = _cell(pkg, kind)
        outs, states = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                                   layout="NTC", merge_outputs=merge)
        outs = outs if isinstance(outs, list) else [outs]
        return pkg.sym.Group(outs + list(states))


# merge_outputs=False (a list of per-step outputs) where it changes the
# graph beyond dropping the final Concat
CELL_CASES = [(kind, True) for kind in CELLS] + [
    (kind, False) for kind in ("lstm", "fused_lstm", "bidirectional",
                               "dropout")]


@pytest.mark.parametrize("kind,merge", CELL_CASES)
def test_cell_unroll_matches_jax(kind, merge):
    """The unrolled graph's arguments, outputs and JSON are the JAX
    package's; its forward (inference: dropout and zoneout are the
    identity there, in both packages) agrees within 1e-5."""
    jsym = _unrolled(mx, JNameManager, kind, merge)
    tsym = _unrolled(mt, TNameManager, kind, merge)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    assert tsym.tojson() == jsym.tojson()
    shapes, _, _ = jsym.infer_shape(data=(N, T, I))
    rng = np.random.RandomState(5)
    values = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for n, s in zip(jsym.list_arguments(), shapes)}
    jex = jsym.simple_bind(mx.cpu(), data=(N, T, I))
    tex = simple_bind(tsym, "cpu", data=(N, T, I))
    for n, v in values.items():
        jex.arg_dict[n][:] = v
        tex.arg_dict[n][:] = v
    jout = [o.asnumpy() for o in jex.forward()]
    tout = [o.asnumpy() for o in tex.forward()]
    assert [o.shape for o in tout] == [o.shape for o in jout]
    for jo, to in zip(jout, tout):
        np.testing.assert_allclose(to, jo, rtol=0, atol=TOL_OUT)


def test_fused_rnn_initializer_matches_jax():
    """FusedRNN initializes the packed blob through the unfused layout:
    the inner initializer on each weight, the LSTM forget bias on each
    bias; with a constant inner initializer both packages agree
    exactly."""
    shape = (mx.ops.rnn_op.rnn_param_size(2, H, "lstm", False, I),)
    jinit = mx.initializer.FusedRNN(mx.initializer.Constant(0.25), H, 2,
                                    "lstm", forget_bias=1.5)
    tinit = mt.initializer.FusedRNN(mt.initializer.Constant(0.25), H, 2,
                                    "lstm", forget_bias=1.5)
    assert tinit.dumps() == jinit.dumps()
    jarr = mx.nd.zeros(shape)
    tarr = mt.nd.zeros(shape)
    jinit("lstm_parameters", jarr)
    tinit("lstm_parameters", tarr)
    np.testing.assert_array_equal(tarr.asnumpy(), jarr.asnumpy())
    bias = mt.nd.zeros((4 * H,))
    mt.initializer.Xavier()(mt.initializer.InitDesc(
        "l_i2h_bias", {"__init__": mt.initializer.LSTMBias(1.5).dumps()}),
        bias)
    np.testing.assert_array_equal(bias.asnumpy()[H:2 * H], 1.5)
    assert float(np.abs(bias.asnumpy()).sum()) == 1.5 * H


def _sentences(n, vocab, lo, hi, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("layout,buckets", [("NT", [4, 8, 12]),
                                            ("TN", [6, 12]),
                                            ("NT", None)])
def test_bucket_sentence_iter_matches_jax(layout, buckets):
    """Two epochs of the same sentences and seed: the same bucket keys,
    data, labels and descriptors, exactly (sentences longer than the
    largest bucket are dropped by both)."""
    sents = _sentences(60, 30, 1, 14, 0)
    kw = dict(batch_size=4, buckets=buckets, invalid_label=-1, seed=3,
              layout=layout)
    jit = mx.rnn.BucketSentenceIter(sents, **kw)
    tit = mt.rnn.BucketSentenceIter(sents, **kw)
    assert tit.default_bucket_key == jit.default_bucket_key
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    for epoch in range(2):
        if epoch:
            jit.reset()
            tit.reset()
        jb, tb = list(jit), list(tit)
        assert len(tb) == len(jb) > 0
        for j, t in zip(jb, tb):
            assert t.bucket_key == j.bucket_key
            assert tuple(t.provide_data[0]) == tuple(j.provide_data[0])
            np.testing.assert_array_equal(t.data[0].asnumpy(),
                                          j.data[0].asnumpy())
            np.testing.assert_array_equal(t.label[0].asnumpy(),
                                          j.label[0].asnumpy())


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


# (op, attrs, inputs, is_train): every op the cells build, the arithmetic
# family, and Dropout where the two packages' generators do not enter
OP_CASES = [
    ("_plus", {}, [_rand(3, 4), _rand(3, 4, seed=1)], False),
    ("_minus", {}, [_rand(3, 4), _rand(3, 4, seed=1)], False),
    ("_mul", {}, [_rand(3, 4), _rand(3, 4, seed=1)], False),
    ("_div", {}, [_rand(3, 4), 2 + _rand(3, 4, seed=1)], False),
    ("elemwise_sub", {}, [_rand(3, 4), _rand(3, 4, seed=1)], False),
    ("elemwise_mul", {}, [_rand(3, 4), _rand(3, 4, seed=1)], False),
    ("elemwise_div", {}, [_rand(3, 4), 2 + _rand(3, 4, seed=1)], False),
    ("broadcast_div", {}, [_rand(3, 4), 2 + _rand(1, 4, seed=1)], False),
    ("_plus_scalar", {"scalar": 0.3}, [_rand(3, 4)], False),
    ("_minus_scalar", {"scalar": 0.3}, [_rand(3, 4)], False),
    ("_rminus_scalar", {"scalar": 1.0}, [_rand(3, 4)], False),
    ("_mul_scalar", {"scalar": -0.7}, [_rand(3, 4)], False),
    ("_div_scalar", {"scalar": 3.0}, [_rand(3, 4)], False),
    ("_rdiv_scalar", {"scalar": 0.1}, [2 + _rand(3, 4)], False),
    ("expand_dims", {"axis": 1}, [_rand(3, 4)], False),
    ("SwapAxis", {"dim1": 0, "dim2": 2}, [_rand(2, 3, 4)], False),
    ("Concat", {"num_args": 3, "dim": 1},
     [_rand(2, 3), _rand(2, 1, seed=1), _rand(2, 2, seed=2)], False),
    ("Concat", {"num_args": 2, "dim": 0},
     [_rand(2, 3), _rand(4, 3, seed=1)], False),
    ("SliceChannel", {"num_outputs": 4, "axis": 1}, [_rand(3, 8)], False),
    ("SliceChannel", {"num_outputs": 5, "axis": 1, "squeeze_axis": True},
     [_rand(3, 5, 2)], False),
    ("zeros_like", {}, [_rand(3, 4)], False),
    ("ones_like", {}, [_rand(3, 4)], False),
    ("where", {}, [(_rand(3, 4) > 0).astype(np.float32), _rand(3, 4, seed=1),
                   _rand(3, 4, seed=2)], False),
    ("where", {}, [(_rand(3) > 0).astype(np.float32), _rand(3, 4, seed=1),
                   _rand(3, 4, seed=2)], False),
    ("Dropout", {"p": 0.5}, [_rand(3, 4)], False),
    ("Dropout", {"p": 0.0}, [_rand(3, 4)], True),
    ("_rnn_begin_state", {"shape": (2, 0, 5), "batch_axis": 1},
     [_rand(4, 3, 2)], False),
]


@pytest.mark.parametrize("name,attrs,inputs,is_train", OP_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(OP_CASES)])
def test_tensor_and_elemwise_ops_match_jax(name, attrs, inputs, is_train):
    """Forward values and the gradients of every float input."""
    jouts, touts, jgrads, tgrads = _vjp_pair(name, attrs, inputs,
                                             is_train=is_train)
    assert len(touts) == len(jouts)
    for jo, to in zip(jouts, touts):
        assert to.shape == jo.shape
        np.testing.assert_allclose(to, jo, rtol=0, atol=TOL_OUT)
    _assert_grads(jgrads, tgrads)


def test_dropout_in_training_masks_from_the_generator():
    """In training, Dropout keeps about 1 - p of the values, scaled by
    1 / (1 - p), and the executor's generator repeats its mask."""
    x = torch.ones(64, 64)
    op = treg.get_op("Dropout")
    attrs = op.parse_attrs({"p": "0.25"})

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        (out, mask), _ = op.fcompute(attrs, [x], [], treg.OpContext(
            is_train=True, generator=gen))
        return out

    out = run(1)
    kept = out != 0
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert 0.7 < float(kept.float().mean()) < 0.8
    assert torch.equal(run(1), out) and not torch.equal(run(2), out)


def test_slice_channel_gradient_through_the_graph():
    """A SliceChannel output that nothing reads takes a zero gradient:
    the executor's backward equals the JAX executor's."""
    def net(pkg):
        parts = pkg.sym.SliceChannel(pkg.sym.Variable("data"),
                                     num_outputs=3, axis=1, name="sc")
        return (parts[0] * 2.0 - parts[2]) * parts[0]

    x = _rand(2, 6)
    jex = net(mx).simple_bind(mx.cpu(), data=(2, 6))
    jex.arg_dict["data"][:] = x
    jex.forward(is_train=True)
    jex.backward([mx.nd.ones((2, 2))])
    tex = simple_bind(net(mt), "cpu", data=(2, 6))
    tex.arg_dict["data"][:] = x
    tex.forward(is_train=True)
    tex.backward()
    got = tex.grad_dict["data"].asnumpy()
    np.testing.assert_allclose(got, jex.grad_dict["data"].asnumpy(),
                               rtol=0, atol=TOL_OUT)
    assert not got[:, 2:4].any()
