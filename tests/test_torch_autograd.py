"""The port's imperative autograd (``mxnet_tpu_torch/autograd.py``) and
``grad_req="add"`` against the JAX package.

* ``tests/test_autograd.py``'s cases, each run through both packages
  (the JAX package's default context is the host; the port runs under
  ``with mt.cpu():``) and held to the same expected values, 1e-6
  relative: write / add / null requests, ``out_grads``, the training
  flag, ``retain_graph``, ``out=`` on the tape, ``grad_and_loss`` /
  ``grad`` with ``argnum``, and the port's in-place writes while
  recording.
* ``grad_req="add"`` on the Executor and through ``Module`` (the
  compiled step refuses it, both packages train on the eager path),
  against the JAX package, 1e-6 relative.
* The attention LM written as ``nd`` calls under ``autograd.record()``
  (``mxnet_tpu_torch.models.attention_lm.imperative_lm``, the graph of
  ``mxnet_tpu/models/attention_lm.py``) at vocab 64, T 16, batch 2,
  embed 32, 4 heads, FFN 64, 2 layers: its loss and every parameter's
  gradient against the JAX package's same imperative step and against
  the port's own ``Module``, and the parameters after two
  ``sgd_update`` steps against the JAX package's, each within 1e-5
  norm-wise (||got - want|| / ||want||; the attention ``*_k_bias``
  gradient, analytically zero, on its layer's ``*_q_bias`` norm).
  Both sides are f32 and differ by summation order only.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models.attention_lm import imperative_lm

PKGS = {"jax": mx, "port": mt}
REL = 1e-6


def _clear(pkg):
    pkg.autograd._st().variables.clear()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    p = PKGS[request.param]
    _clear(p)
    with p.cpu():
        yield p
    _clear(p)


def _close(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rel,
                               atol=rel)


def test_unary_func(pkg):
    nd = pkg.nd
    x_np = np.random.RandomState(0).uniform(0.5, 1.0, (4, 5)) \
        .astype(np.float32)
    for func, want in ((lambda x: nd.sum(nd.exp(x)), np.exp(x_np)),
                       (lambda x: nd.sum(x * x), 2 * x_np)):
        grads, loss = pkg.autograd.grad_and_loss(func)(nd.array(x_np))
        _close(grads[0].asnumpy(), want)
        assert loss.shape == ()


def test_mark_variables_backward(pkg):
    nd = pkg.nd
    x = nd.array([1.0, 2.0, 3.0])
    g = nd.zeros((3,))
    pkg.autograd.mark_variables([x], [g])
    with pkg.autograd.train_section():
        y = x * 2 + nd.square(x)
        pkg.autograd.backward([y])
    _close(g.asnumpy(), 2 + 2 * np.array([1, 2, 3]))


def test_training_flag(pkg):
    nd, ag = pkg.nd, pkg.autograd
    x = nd.ones((100, 100))
    assert not ag.is_training() and not ag.is_recording()
    with ag.record(train_mode=True):
        assert ag.is_training() and ag.is_recording()
        y = nd.Dropout(x, p=0.5)
    assert (y.asnumpy() == 0).any()
    with ag.record(train_mode=False):
        y = nd.Dropout(x, p=0.5)
    assert not (y.asnumpy() == 0).any()
    with ag.test_section():
        assert not ag.is_training()
    prev = ag.set_is_training(True)
    assert prev is False and ag.is_training()
    ag.set_is_training(False)


def test_out_grads(pkg):
    nd = pkg.nd
    x = nd.array([1.0, 2.0, 3.0])
    g = nd.zeros((3,))
    pkg.autograd.mark_variables([x], [g])
    with pkg.autograd.record():
        y = x * 1.0
        pkg.autograd.backward([y], out_grads=[nd.array([10.0, 20.0, 30.0])])
    _close(g.asnumpy(), [10, 20, 30])


def test_grad_reqs(pkg):
    """add accumulates over backwards, null leaves its buffer, write
    overwrites; a marked variable no recorded op reached takes a zero
    gradient."""
    nd = pkg.nd
    x, u, n, w = (nd.array([1.0, 2.0]) for _ in range(4))
    gx, gu, gw = nd.zeros((2,)), nd.ones((2,)), nd.ones((2,))
    gn = nd.full((2,), 7.0)
    pkg.autograd.mark_variables([x, n, w], [gx, gn, gw],
                                grad_reqs=["add", "null", "write"])
    pkg.autograd.mark_variables([u], [gu])
    for _ in range(3):
        with pkg.autograd.record():
            y = x * 2 + n * w
            pkg.autograd.backward([y])
    _close(gx.asnumpy(), [6, 6])
    _close(gn.asnumpy(), [7, 7])
    _close(gw.asnumpy(), [1, 2])
    _close(gu.asnumpy(), [0, 0])


def test_retain_graph(pkg):
    nd = pkg.nd
    x = nd.array([2.0])
    g = nd.zeros((1,))
    pkg.autograd.mark_variables([x], [g])
    with pkg.autograd.record():
        y = x * x
        pkg.autograd.backward([y], retain_graph=True)
        first = g.asnumpy().copy()
        pkg.autograd.backward([y])
    _close(first, [4.0])
    _close(g.asnumpy(), [4.0])


def test_out_param_recording(pkg):
    nd = pkg.nd
    x = nd.array([1.0, -2.0, 3.0])
    g = nd.zeros((3,))
    y = nd.zeros((3,))
    pkg.autograd.mark_variables([x], [g])
    with pkg.autograd.record():
        nd.relu(x, out=y)
        z = y * 3
        pkg.autograd.backward([z])
    _close(g.asnumpy(), [3, 0, 3])


def test_argnum(pkg):
    nd = pkg.nd
    a, b = nd.array([1.0, 2.0]), nd.array([3.0, 4.0])
    grads, loss = pkg.autograd.grad_and_loss(
        lambda a, b: nd.sum(a * b), argnum=0)(a, b)
    _close(grads[0].asnumpy(), [3, 4])
    _close(loss.asnumpy(), 11.0)
    grads = pkg.autograd.grad(lambda a, b: nd.sum(a * b * b),
                              argnum=[0, 1])(a, b)
    _close(grads[0].asnumpy(), [9, 16])
    _close(grads[1].asnumpy(), [6, 16])


def test_inplace_writes_while_recording():
    """``+=`` and ``x[...] =`` on recorded arrays rebind them, so the
    graph runs through the write (the reference records them on the
    destination), and a marked leaf stays writable outside recording."""
    with mt.cpu():
        nd = mt.nd
        x = nd.array([1.0, 2.0, 3.0])
        g = nd.zeros((3,))
        mt.autograd.mark_variables([x], [g])
        with mt.autograd.record():
            y = x * 2
            y += x
            y[0] = 0.0
            mt.autograd.backward([y])
        _close(g.asnumpy(), [0, 3, 3])
        x[:] = 5.0
        x += 1.0
        _close(x.asnumpy(), [6, 6, 6])
        _clear(mt)


# ---------------------------------------------------------------------------
# grad_req="add": the Executor and Module
# ---------------------------------------------------------------------------

def _fc_net(pkg):
    s = pkg.sym
    return s.SoftmaxOutput(s.FullyConnected(s.Variable("data"),
                                            num_hidden=3, name="fc"),
                           name="softmax")


def _fc_values():
    rng = np.random.RandomState(3)
    return {"data": rng.randn(4, 5).astype(np.float32),
            "fc_weight": (0.3 * rng.randn(3, 5)).astype(np.float32),
            "fc_bias": (0.1 * rng.randn(3)).astype(np.float32),
            "softmax_label": np.array([0, 2, 1, 2], np.float32)}


def test_executor_grad_req_add(pkg):
    vals = _fc_values()
    net = _fc_net(pkg)
    args = {k: pkg.nd.array(v) for k, v in vals.items()}
    seed = {k: pkg.nd.ones(v.shape) for k, v in vals.items()
            if k.startswith("fc")}
    exe = net.bind(pkg.cpu(), args, args_grad=seed,
                   grad_req={"fc_weight": "add", "fc_bias": "write"})
    for _ in range(2):
        exe.forward(is_train=True)
        exe.backward()
    p = np.exp(vals["data"] @ vals["fc_weight"].T + vals["fc_bias"])
    p /= p.sum(1, keepdims=True)
    dz = p - np.eye(3)[vals["softmax_label"].astype(int)]
    _close(exe.grad_dict["fc_weight"].asnumpy(), 1 + 2 * dz.T @ vals["data"],
           1e-5)
    _close(exe.grad_dict["fc_bias"].asnumpy(), dz.sum(0), 1e-5)


def test_module_grad_req_add_matches_jax():
    """A Module bound with grad_req="add" accumulates every backward
    into its gradients (the compiled step refuses "add", so both
    packages take the eager path) and updates from the sum."""
    vals = _fc_values()
    params = {k: v for k, v in vals.items() if k.startswith("fc")}
    got = {}
    for name, pkg in PKGS.items():
        with pkg.cpu():
            mod = pkg.mod.Module(_fc_net(pkg), context=pkg.cpu())
            mod.bind(data_shapes=[("data", (4, 5))],
                     label_shapes=[("softmax_label", (4,))],
                     grad_req="add")
            mod.init_params(arg_params={k: pkg.nd.array(v)
                                        for k, v in params.items()},
                            aux_params={})
            mod.init_optimizer(optimizer="sgd",
                               optimizer_params={"learning_rate": 0.1})
            if pkg is mt:
                # refused loudly by the compiled step, trained eagerly
                assert mod._train_step is None
                with pytest.raises(mt.MXNetError, match="grad_req"):
                    mt.train_step.CompiledTrainStep(
                        mod._exec_group, mod._optimizer, mod._updater)
            batch = pkg.io.DataBatch([pkg.nd.array(vals["data"])],
                                     [pkg.nd.array(vals["softmax_label"])])
            for _ in range(2):
                mod.forward_backward(batch)
            grads = [g.asnumpy() for g in mod._exec_group.grad_arrays
                     if g is not None]
            mod.update()
            got[name] = (grads, {k: v.asnumpy() for k, v in
                                 mod.get_params()[0].items()})
    assert len(got["port"][0]) == 2
    for g, w in zip(got["port"][0], got["jax"][0]):
        _close(g, w, 1e-6)
    for k in params:
        _close(got["port"][1][k], got["jax"][1][k], 1e-6)


# ---------------------------------------------------------------------------
# The LM through nd + autograd
# ---------------------------------------------------------------------------

VOCAB, T, B, EMBED, HEADS, FFN, LAYERS = 64, 16, 2, 32, 4, 64, 2
LR = 0.05
TOL_LM = 1e-5


def _lm_inputs():
    sym = mt.models.attention_lm.get_symbol(
        vocab_size=VOCAB, seq_len=T, num_layers=LAYERS, embed=EMBED,
        heads=HEADS, ffn_hidden=FFN)
    shapes, _, _ = sym.infer_shape(data=(B, T), softmax_label=(B, T))
    rng = np.random.RandomState(1)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name.endswith(("_beta", "_bias")):
            v = 0.05 * rng.randn(*shape)
        else:
            v = 0.08 * rng.randn(*shape)
        params[name] = v.astype(np.float32)
    x = rng.randint(0, VOCAB, size=(B, T)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.full((B, 1), -1, np.float32)], axis=1)
    return sym, params, x, y


def _imperative_steps(pkg, params, x, y, steps):
    """The first step's (loss, gradients) and the parameters after
    ``steps`` SGD steps (``sgd_update(w, g, out=w)``)."""
    nd, ag = pkg.nd, pkg.autograd
    with pkg.cpu():
        p = {k: nd.array(v) for k, v in params.items()}
        g = {k: nd.zeros(v.shape) for k, v in params.items()}
        names = sorted(p)
        _clear(pkg)
        ag.mark_variables([p[k] for k in names], [g[k] for k in names])
        data, label = nd.array(x), nd.array(y)
        first = None
        for _ in range(steps):
            with ag.record():
                out = imperative_lm(nd, p, data, label, LAYERS, EMBED,
                                    HEADS, FFN, VOCAB)
            ag.backward([out])
            if first is None:
                probs = out.asnumpy()
                lbl = y.reshape(-1).astype(int)
                keep = lbl >= 0
                loss = -np.log(probs[keep, lbl[keep]]).mean()
                first = (loss, {k: g[k].asnumpy() for k in names})
            for k in names:
                nd.sgd_update(p[k], g[k], lr=LR, out=p[k])
        _clear(pkg)
        return first, {k: p[k].asnumpy() for k in names}


def _rel(got, want):
    out = {}
    for k, w in want.items():
        ref = k[:-len("_k_bias")] + "_q_bias" if k.endswith("_k_bias") \
            else k
        out[k] = float(np.linalg.norm(got[k] - w)
                       / max(np.linalg.norm(want[ref]), 1e-30))
    return out


def test_imperative_lm_matches_jax_and_module():
    sym, params, x, y = _lm_inputs()
    (jloss, jgrads), jparams = _imperative_steps(mx, params, x, y, 2)
    (tloss, tgrads), tparams = _imperative_steps(mt, params, x, y, 2)
    assert abs(tloss - jloss) <= TOL_LM * abs(jloss)
    errs = _rel(tgrads, jgrads)
    assert max(errs.values()) <= TOL_LM, errs
    errs = _rel(tparams, jparams)
    assert max(errs.values()) <= TOL_LM, errs
    # the port's own Module: the same first-step gradients
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(data_shapes=[mt.io.DataDesc("data", (B, T))],
             label_shapes=[mt.io.DataDesc("softmax_label", (B, T))])
    mod.init_params(arg_params=params, aux_params={})
    with mt.cpu():
        mod.forward(mt.io.DataBatch([mt.nd.array(x)], [mt.nd.array(y)]),
                    is_train=True)
    mod.backward()
    probs = mod.get_outputs()[0].asnumpy()
    lbl = y.reshape(-1).astype(int)
    mloss = -np.log(probs[lbl >= 0, lbl[lbl >= 0]]).mean()
    assert abs(tloss - mloss) <= TOL_LM * abs(mloss)
    group = mod._exec_group
    mgrads = {n: g.asnumpy() for n, g in zip(group.param_names,
                                              group.grad_arrays)}
    errs = _rel(tgrads, mgrads)
    assert max(errs.values()) <= TOL_LM, errs
