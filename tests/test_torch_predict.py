"""Inference through the port — ``Module.predict`` / ``iter_predict``,
``score`` / ``fit`` callbacks, ``Module.reshape``, ``backward(out_grads)``,
the ``Symbol`` / ``Executor`` additions, ``Predictor``, ``FeedForward``,
``Monitor`` and ``Embedding``'s out-of-range ids — held against the JAX
package on the CPU, on the same numpy weights and batches.

Three models: a small ``attention_lm`` (2 layers, embed 64, 2 heads,
FFN 128, T 16, vocab 64), an MLP (FC 16 -> tanh -> FC 5) and a conv net
(Convolution -> BatchNorm -> tanh -> global pooling -> FC 5).  The JAX
side runs its ops as its own CPU tests do by default (its Pallas
switches off: the plain jnp versions); the port runs on the CPU, where
every kernel wrapper takes its plain version.  Each inference forward of
the port goes through its captured-forward program
(``train_step.CompiledForward``; on the CPU the program runs its body
over the bound arrays).

Tolerances: outputs (probabilities, tanh activations) 1e-5 absolute and
gradients 1e-5 relative to their largest magnitude — both sides are f32
and differ only in summation order; parameters after training steps
1e-5 absolute (``tests/test_torch_compiled_step.py``'s SGD tolerance);
metric values and monitor statistics 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import attention_lm as jlm

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import programs
from mxnet_tpu_torch.models import attention_lm


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    """Arrays made without a context go to the host: the port's default
    context is the card."""
    with mt.cpu():
        yield


torch.set_num_threads(1)

TOL_OUT = 1e-5
TOL_GRAD = 1e-5
TOL_PARAM = 1e-5
TOL_METRIC = 1e-5
LM = dict(vocab_size=64, seq_len=16, num_layers=2, embed=64, heads=2,
          ffn_hidden=128)
N, BATCH = 20, 8          # two full batches and one padded by 4
MLP_IN, CLASSES = 6, 5
PKGS = (mx, mt)
MODELS = ("lm", "mlp", "conv")


def _sym(pkg, name):
    """The model's symbol, auto-names pinned (a fresh NameManager)."""
    with pkg.NameManager():
        return _build(pkg, name)


def _build(pkg, name):
    s = pkg.sym
    if name == "lm":
        return (jlm if pkg is mx else attention_lm).get_symbol(**LM)
    if name == "mlp":
        net = s.FullyConnected(s.Variable("data"), num_hidden=16, name="fc1")
        net = s.Activation(net, act_type="tanh", name="act")
    else:
        net = s.Convolution(s.Variable("data"), num_filter=4, kernel=(3, 3),
                            pad=(1, 1), name="conv")
        net = s.BatchNorm(net, fix_gamma=False, name="bn")
        net = s.Activation(net, act_type="tanh", name="act")
        net = s.Pooling(net, kernel=(4, 4), pool_type="avg",
                        global_pool=True, name="pool")
        net = s.Flatten(net)
    net = s.FullyConnected(net, num_hidden=CLASSES, name="fc")
    return s.SoftmaxOutput(net, name="softmax")


def _data(name, n=N, seed=0):
    rng = np.random.RandomState(seed)
    if name == "lm":
        x = rng.randint(0, LM["vocab_size"], (n, LM["seq_len"]))
        y = np.concatenate([x[:, 1:], np.full((n, 1), -1)], 1)
        return x.astype(np.float32), y.astype(np.float32)
    shape = (n, MLP_IN) if name == "mlp" else (n, 2, 4, 4)
    return (rng.randn(*shape).astype(np.float32),
            rng.randint(0, CLASSES, n).astype(np.float32))


def _params(name):
    """Seeded numpy (arg, aux) parameters, the same for both packages."""
    x, y = _data(name, BATCH)
    sym = _sym(mt, name)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=x.shape,
                                                softmax_label=y.shape)
    rng = np.random.RandomState(1)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        v = 1.0 + 0.1 * rng.randn(*s) if n.endswith("_gamma") \
            else 0.2 * rng.randn(*s)
        args[n] = v.astype(np.float32)
    aux = {n: (1.0 + 0.1 * rng.rand(*s) if n.endswith("_var")
               else 0.1 * rng.randn(*s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _nd(pkg, tree):
    return {k: pkg.nd.array(v) for k, v in tree.items()}


def _iter(pkg, name, n=N, batch=BATCH, **kw):
    x, y = _data(name, n)
    return pkg.io.NDArrayIter(x, y, batch_size=batch, **kw)


def _module(pkg, name, for_training=False, batch=BATCH, sym=None,
            label_names=("softmax_label",)):
    sym = sym if sym is not None else _sym(pkg, name)
    mod = pkg.mod.Module(sym, context=pkg.cpu(), label_names=label_names)
    x, y = _data(name, batch)
    label_shapes = [("softmax_label", y.shape)] if label_names else None
    mod.bind(data_shapes=[("data", x.shape)], label_shapes=label_shapes,
             for_training=for_training)
    args, aux = _params(name)
    mod.init_params(arg_params=_nd(pkg, args), aux_params=_nd(pkg, aux),
                    allow_missing=False)
    return mod


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _close(got, want, tol=TOL_OUT, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _rel_close(got, want, tol, what="", scale_of=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    ref = want if scale_of is None else _np(scale_of)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


# ---------------------------------------------------------------------------
# Module.predict / iter_predict / score / fit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MODELS)
def predicted(request):
    """Each package's ``predict`` (merged, unmerged, always a list) and
    ``iter_predict`` over the same padded iterator."""
    name = request.param
    runs = {}
    for pkg in PKGS:
        mod = _module(pkg, name)
        it = _iter(pkg, name)
        runs[pkg] = {
            "merged": mod.predict(it),
            "unmerged": mod.predict(it, merge_batches=False),
            "listed": mod.predict(it, always_output_list=True),
            "iter": [(outs, nb, b.pad) for outs, nb, b
                     in mod.iter_predict(it)],
            "limited": mod.predict(it, num_batch=2)}
    return name, runs[mx], runs[mt]


def test_predict_merged_strips_padding_and_matches_jax(predicted):
    """Merged outputs: the last batch's 4 pad rows stripped from each
    output by its own leading dimension (N rows; the LM's flattened
    (B * T, V) head loses 4 of its B * T rows, as in the JAX package),
    equal to the JAX package's."""
    name, want, got = predicted
    pad = 3 * BATCH - N
    rows = 3 * BATCH * LM["seq_len"] - pad if name == "lm" else N
    assert not isinstance(got["merged"], list)
    assert got["merged"].shape[0] == rows
    _close(got["merged"], want["merged"], what="merged")
    assert isinstance(got["listed"], list) and len(got["listed"]) == 1
    _close(got["listed"][0], want["merged"], what="always_output_list")
    _close(got["limited"], want["limited"], what="num_batch=2")


def test_predict_unmerged_matches_jax(predicted):
    """``merge_batches=False``: a list of each batch's outputs."""
    _, want, got = predicted
    assert len(got["unmerged"]) == len(want["unmerged"]) == 3
    for g, w in zip(got["unmerged"], want["unmerged"]):
        assert len(g) == len(w) == 1
        _close(g[0], w[0], what="batch")


def test_iter_predict_matches_jax(predicted):
    """``iter_predict``: (outputs, nbatch, batch) with the pad stripped."""
    _, want, got = predicted
    assert [(nb, pad) for _, nb, pad in got["iter"]] == \
        [(nb, pad) for _, nb, pad in want["iter"]] == [(0, 0), (1, 0),
                                                       (2, 4)]
    for (g, _, _), (w, _, _) in zip(got["iter"], want["iter"]):
        _close(g[0], w[0], what="iter_predict")


def _metric(pkg, name):
    return pkg.metric.Perplexity(ignore_label=-1) if name == "lm" \
        else pkg.metric.Accuracy()


@pytest.mark.parametrize("name", MODELS)
def test_score_callbacks_match_jax(name):
    """``score`` with ``batch_end_callback`` and ``score_end_callback``:
    the same batch numbers and metric values as the JAX package's."""
    seen = {}
    for pkg in PKGS:
        mod = _module(pkg, name)
        calls = []
        res = mod.score(
            _iter(pkg, name), _metric(pkg, name),
            batch_end_callback=lambda p: calls.append(
                ("batch", p.nbatch, p.eval_metric.get()[1])),
            score_end_callback=lambda p: calls.append(
                ("end", p.nbatch, p.eval_metric.get()[1])))
        seen[pkg] = (calls, res)
    (jcalls, jres), (tcalls, tres) = seen[mx], seen[mt]
    assert [c[:2] for c in tcalls] == [c[:2] for c in jcalls] == \
        [("batch", 0), ("batch", 1), ("batch", 2), ("end", 3)]
    for (_, _, g), (_, _, w) in zip(tcalls, jcalls):
        np.testing.assert_allclose(g, w, rtol=TOL_METRIC)
    np.testing.assert_allclose(tres[0][1], jres[0][1], rtol=TOL_METRIC)


def _collecting(mon):
    """Make ``mon.toc_print`` keep its records (in both packages)."""
    records = []
    mon.toc_print = lambda: records.extend(mon.toc())
    return records


@pytest.mark.parametrize("name", ("mlp", "conv"))
def test_fit_with_eval_end_callback_and_monitor_matches_jax(name):
    """``fit`` with ``eval_data``, ``eval_end_callback`` and a
    ``Monitor`` (the MLP and the conv net: the JAX side's monitored LM
    runs op by op, too slow for the suite): the monitored module trains
    eagerly in both packages;
    the parameters after the epoch, the validation callback's metric and
    every monitor record (names in order, statistics) equal the JAX
    package's."""
    out = {}
    for pkg in PKGS:
        mod = pkg.mod.Module(_sym(pkg, name), context=pkg.cpu())
        args, aux = _params(name)
        mon = pkg.monitor.Monitor(2, pattern=".*(output|weight)$")
        records = _collecting(mon)
        ends = []
        mod.fit(_iter(pkg, name, n=16), eval_data=_iter(pkg, name, n=8),
                eval_metric=_metric(pkg, name),
                eval_end_callback=lambda p: ends.append(
                    (p.nbatch, p.eval_metric.get()[1])),
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params=_nd(pkg, args), aux_params=_nd(pkg, aux),
                num_epoch=1, monitor=mon)
        arg_p, aux_p = mod.get_params()
        out[pkg] = ({k: _np(v) for k, v in {**arg_p, **aux_p}.items()},
                    ends, records,
                    getattr(mod, "_train_step", None))
    (jp, jends, jrec, _), (tp, tends, trec, tstep) = out[mx], out[mt]
    assert tstep is None
    assert set(tp) == set(jp)
    for k in jp:
        _close(tp[k], jp[k], TOL_PARAM, k)
    assert [e[0] for e in tends] == [e[0] for e in jends] == [1]
    np.testing.assert_allclose(tends[0][1], jends[0][1], rtol=TOL_METRIC)
    assert [r[:2] for r in trec] == [r[:2] for r in jrec]
    assert any(r[1].endswith("_output") for r in trec)
    assert any(r[1].endswith("_weight") for r in trec)
    for g, w in zip(trec, jrec):
        np.testing.assert_allclose(float(g[2]), float(w[2]),
                                   rtol=TOL_METRIC, err_msg=g[1])


@pytest.mark.parametrize("name", ("lm", "conv"))
def test_predict_after_compiled_steps_matches_jax(name):
    """A forward after compiled training steps sees the step's
    parameters: ``predict`` after one epoch of ``fit`` (the port's steps
    through ``CompiledTrainStep``) equals the JAX package's."""
    out = {}
    for pkg in PKGS:
        mod = pkg.mod.Module(_sym(pkg, name), context=pkg.cpu())
        args, aux = _params(name)
        mod.fit(_iter(pkg, name, n=16), eval_metric=_metric(pkg, name),
                optimizer="sgd", optimizer_params={"learning_rate": 0.1},
                arg_params=_nd(pkg, args), aux_params=_nd(pkg, aux),
                num_epoch=1)
        if pkg is mt:
            assert mod._train_step is not None
            assert mod._train_step.num_steps == 2
        out[pkg] = mod.predict(_iter(pkg, name))
    _close(out[mt], out[mx], what="predict after fit")


@pytest.mark.parametrize("name", MODELS)
def test_module_reshape_matches_jax(name):
    """``Module.reshape`` to batch 4: the parameters stay shared, the
    outputs of a batch of 4 equal the JAX package's and the rows of the
    same samples at batch 8."""
    out = {}
    x4, y4 = _data(name, 4)
    for pkg in PKGS:
        mod = _module(pkg, name)
        exe = mod._exec_group.exec_
        params = {n: exe.arg_dict[n] for n in mod._param_names}
        full = _np(mod.predict(_iter(pkg, name)))
        mod.reshape(data_shapes=[("data", x4.shape)],
                    label_shapes=[("softmax_label", y4.shape)])
        exe4 = mod._exec_group.exec_
        assert exe4 is not exe
        if pkg is mt:
            assert all(exe4.arg_dict[n] is a for n, a in params.items())
            assert [d.shape for d in mod.data_shapes] == [x4.shape]
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x4)],
                                     [pkg.nd.array(y4)]), is_train=False)
        out[pkg] = (_np(mod.get_outputs()[0]), full)
    (j4, jfull), (t4, tfull) = out[mx], out[mt]
    _close(t4, j4, what="batch 4")
    rows = t4.shape[0]
    _close(t4, tfull[:rows], what="batch 4 against batch 8")


def _head_sym(pkg, name):
    """The model without its loss head (so head gradients matter)."""
    sym = _sym(pkg, name)
    return sym.get_internals()["head_output" if name == "lm"
                               else "fc_output"]


@pytest.mark.parametrize("name", MODELS)
def test_backward_out_grads_matches_jax(name):
    """``forward(is_train=True)`` + ``backward(out_grads=g)`` on the
    model's logits (no loss head), g random: every gradient equals the
    JAX package's; ``get_outputs(merge_multi_context=False)`` equals the
    merged outputs."""
    grads = {}
    for pkg in PKGS:
        mod = _module(pkg, name, for_training=True,
                      sym=_head_sym(pkg, name), label_names=None)
        x, _ = _data(name, BATCH)
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x)], []), is_train=True)
        outs = mod.get_outputs()
        _close(mod.get_outputs(merge_multi_context=False)[0], outs[0])
        g = np.random.RandomState(3).randn(*outs[0].shape)
        mod.backward(out_grads=[pkg.nd.array(g.astype(np.float32))])
        grp = mod._exec_group
        grads[pkg] = {n: _np(grp.exec_.grad_dict[n])
                      for n in grp.param_names
                      if grp.exec_.grad_dict.get(n) is not None}
    assert set(grads[mt]) == set(grads[mx])
    # analytically zero gradients (rounding noise on both sides) are held
    # on the scale of a sibling's: a key bias cancels in the softmax (its
    # layer's query bias), a bias before BatchNorm in the normalization
    # (its convolution's weight)
    sibling = {n: n[:-len("_k_bias")] + "_q_bias" for n in grads[mx]
               if n.endswith("_k_bias")}
    sibling["conv_bias"] = "conv_weight"
    for n, w in grads[mx].items():
        _rel_close(grads[mt][n], w, TOL_GRAD, n,
                   scale_of=grads[mx].get(sibling.get(n)))


def test_backward_out_grads_reuses_the_forward_dropout_masks():
    """``backward(out_grads=ones)`` after a training forward through
    Dropout equals ``backward()`` (which seeds ones): the rerun draws the
    same masks from the generator state the forward started from; the
    next forward draws new ones."""
    s = mt.sym
    net = s.FullyConnected(s.Variable("data"), num_hidden=8, name="fc1")
    net = s.Dropout(net, p=0.5, name="drop")
    net = s.FullyConnected(net, num_hidden=3, name="fc2")
    exe = net.simple_bind(mt.cpu(), data=(4, 5))
    rng = np.random.RandomState(0)
    for a in exe.arg_arrays:
        a[:] = rng.randn(*a.shape).astype(np.float32)
    exe.generator = torch.Generator().manual_seed(7)

    def grads():
        return {n: g.asnumpy().copy() for n, g in exe.grad_dict.items()}

    exe.forward(is_train=True)
    exe.backward()
    seeded = grads()
    exe.backward(out_grads=mt.nd.array(np.ones((4, 3), np.float32)))
    rerun = grads()
    exe.forward(is_train=True)
    exe.backward()
    for n in seeded:
        np.testing.assert_array_equal(rerun[n], seeded[n], err_msg=n)
    assert not np.array_equal(grads()["fc1_weight"], seeded["fc1_weight"])


def test_install_monitor_carries_the_optimizer_state_like_jax():
    """Two compiled SGD-momentum steps, then ``install_monitor`` (the
    port drops its train step and hands its slots to the eager updater),
    then two eager steps: the parameters equal the JAX package's, which
    hands over the same way (momentum lost would show)."""
    out = {}
    x, y = _data("conv", BATCH)
    for pkg in PKGS:
        mod = _module(pkg, "conv", for_training=True)
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        batch = pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)])
        for i in range(4):
            if i == 2:
                mod.install_monitor(pkg.monitor.Monitor(1))
                if pkg is mt:
                    assert mod._train_step is None
            mod.forward_backward(batch)
            mod.update()
        arg_p, aux_p = mod.get_params()
        out[pkg] = {k: _np(v) for k, v in {**arg_p, **aux_p}.items()}
    for k, w in out[mx].items():
        _close(out[mt][k], w, TOL_PARAM, k)


# ---------------------------------------------------------------------------
# Symbol and Executor
# ---------------------------------------------------------------------------

def _expr(pkg):
    with pkg.NameManager():
        x = pkg.sym.Variable("x")
        return -x + x ** 2 - x ** x


@pytest.mark.parametrize("case", ["internals", "children", "attr", "iter",
                                  "json", "infer_type", "partial", "eval"])
def test_symbol_additions_match_jax(case):
    """``get_internals`` (names with ``_output``), ``get_children``,
    ``attr``, iteration, ``-s`` / ``s ** 2`` / ``s ** s`` (JSON byte for
    byte), ``infer_type``, ``infer_shape_partial``'s Nones and ``eval``
    against the JAX package."""
    def run(pkg):
        net = _sym(pkg, "conv")
        if case == "internals":
            return net.get_internals().list_outputs()
        if case == "children":
            return net.get_children().list_outputs()
        if case == "attr":
            v = pkg.sym.Variable("v", attr={"mood": "calm"})
            return (v.attr("mood"), v.attr("none"),
                    pkg.sym.Group([v, v]).attr("mood"))
        if case == "iter":
            g = pkg.sym.Group([net, net.get_internals()["act_output"]])
            return [s.list_outputs() for s in g]
        if case == "json":
            return _expr(pkg).tojson()
        if case == "infer_type":
            types = net.infer_type(data="float16")
            emb = pkg.sym.Embedding(pkg.sym.Variable("data"), input_dim=5,
                                    output_dim=3, name="emb")
            return [[str(t) for t in ts] for ts in
                    types + emb.infer_type(data="int32")]
        if case == "partial":
            s = pkg.sym
            fc = s.FullyConnected(s.Variable("data") + s.Variable("other"),
                                  num_hidden=3, name="a")
            return [_shapes(fc.infer_shape_partial()),
                    _shapes(fc.infer_shape_partial(data=(2, 7))),
                    _shapes(fc.infer_shape_partial(data=(2, 7),
                                                   other=(2, 7)))]
        x = np.linspace(0.1, 1.5, 6).astype(np.float32)
        return _np(_expr(pkg).eval(pkg.cpu(), x=pkg.nd.array(x))[0])

    want, got = run(mx), run(mt)
    if case == "eval":
        _close(got, want, what="eval")
    else:
        assert got == want
    if case == "partial":
        assert got[1][0] == [(2, 7), None, None, None]
        assert got[2][1] == [(2, 3)]


def _shapes(triple):
    return [[tuple(x) if x is not None else None for x in part]
            for part in triple]


@pytest.mark.parametrize("case", ["up_sizing", "partial", "ok", "allowed"])
def test_executor_reshape_contract_matches_jax(case):
    """``Executor.reshape``: growing an array needs ``allow_up_sizing``,
    changing an unnamed argument's shape needs ``partial_shaping`` (both
    raise otherwise), and an accepted reshape shares every unchanged
    array — as in the JAX package."""
    def run(pkg):
        exe = _sym(pkg, "mlp").simple_bind(pkg.cpu(), data=(4, MLP_IN),
                                           softmax_label=(4,))
        kw = {"up_sizing": dict(data=(8, MLP_IN), softmax_label=(8,)),
              "partial": dict(data=(2, MLP_IN)),
              "ok": dict(data=(2, MLP_IN), softmax_label=(2,)),
              "allowed": dict(data=(8, MLP_IN), partial_shaping=True,
                              allow_up_sizing=True)}[case]
        try:
            new = exe.reshape(**kw)
        except Exception as exc:  # noqa: BLE001 - compared across packages
            return type(exc).__name__
        shared = sorted(n for n in exe.arg_dict
                        if new.arg_dict[n] is exe.arg_dict[n])
        return shared, sorted((n, tuple(a.shape))
                              for n, a in new.arg_dict.items())

    want, got = run(mx), run(mt)
    assert got == want
    if case in ("up_sizing", "partial"):
        assert got == "MXNetError"


def test_copy_params_from_and_bind_match_jax():
    """``Symbol.bind`` over given arrays, ``copy_params_from`` (an extra
    name raises unless allowed), then one inference forward: equal to
    the JAX package's."""
    args, _ = _params("mlp")
    x, y = _data("mlp", 4)
    outs = {}
    for pkg in PKGS:
        sym = _sym(pkg, "mlp")
        arrays = {"data": pkg.nd.array(x), "softmax_label": pkg.nd.array(y)}
        arrays.update({n: pkg.nd.array(np.zeros_like(v))
                       for n, v in args.items()})
        exe = sym.bind(pkg.cpu(), arrays)
        extra = dict(_nd(pkg, args), bogus=pkg.nd.array(np.zeros(2)))
        with pytest.raises(Exception, match="bogus"):
            exe.copy_params_from(extra)
        exe.copy_params_from(extra, allow_extra_params=True)
        outs[pkg] = _np(exe.forward(is_train=False)[0])
    _close(outs[mt], outs[mx])


def test_inference_forward_is_one_program_per_executor():
    """An executor's inference forwards replay one program: one set-up
    for its arrays, a replay per later forward, the same outputs as the
    body under ``programs.eager()``; the returned outputs are fresh."""
    exe = _sym(mt, "conv").simple_bind(mt.cpu(), data=(4, 2, 4, 4),
                                       softmax_label=(4,))
    args, aux = _params("conv")
    exe.copy_params_from(_nd(mt, args), _nd(mt, aux))
    exe.arg_dict["data"][:] = _data("conv", 4)[0]
    stats = dict(programs.GRAPH_STATS)
    first = exe.forward()[0]
    second = exe.forward()[0]
    delta = {k: programs.GRAPH_STATS[k] - stats[k]
             for k in ("captures", "replays")}
    assert delta == {"captures": 1, "replays": 1}
    assert exe._compiled_forward.trace_count == 1
    assert first.data.data_ptr() != second.data.data_ptr()
    with programs.eager():
        eager = exe.forward()[0]
    assert torch.equal(first.data, eager.data)
    assert programs.GRAPH_STATS["captures"] - stats["captures"] == 1


# ---------------------------------------------------------------------------
# Predictor, FeedForward, Monitor, Embedding
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_checkpoint(tmp_path_factory):
    """The small LM saved by each package (the same numbers)."""
    args, _ = _params("lm")
    out = {}
    for pkg in PKGS:
        prefix = str(tmp_path_factory.mktemp(pkg.__name__) / "lm")
        pkg.model.save_checkpoint(prefix, 3, _sym(pkg, "lm"),
                                  _nd(pkg, args), {})
        out[pkg] = prefix
    return out


@pytest.mark.parametrize("source", ["checkpoint", "bytes", "path", "dict",
                                    "partial_out"])
def test_predictor_matches_jax(source, lm_checkpoint):
    """``Predictor`` built from a checkpoint, the ``.params`` bytes, its
    path, a dict, or for an internal node (``output_names``): outputs,
    ``output_names`` and ``output_shapes`` equal the JAX package's."""
    x, y = _data("lm", BATCH)
    shapes = {"data": x.shape}
    if source != "partial_out":
        shapes["softmax_label"] = y.shape
    res = {}
    for pkg in PKGS:
        prefix = lm_checkpoint[pkg]
        params_path = "%s-0003.params" % prefix
        if source == "checkpoint":
            pred = pkg.Predictor.from_checkpoint(prefix, 3, shapes,
                                                 ctx=pkg.cpu())
        else:
            params = {"bytes": lambda: open(params_path, "rb").read(),
                      "path": lambda: params_path,
                      "dict": lambda: {"arg:" + k: v for k, v in
                                       _params("lm")[0].items()},
                      "partial_out": lambda: params_path}[source]()
            pred = pkg.Predictor(
                "%s-symbol.json" % prefix, params, shapes, ctx=pkg.cpu(),
                output_names=["head"] if source == "partial_out" else None)
        outs = pred.forward(data=x)
        res[pkg] = (pred.output_names,
                    [tuple(s) for _, s in pred.output_shapes],
                    [_np(o) for o in outs], _np(pred.get_output(0)))
    assert res[mt][:2] == res[mx][:2]
    for g, w in zip(res[mt][2], res[mx][2]):
        _close(g, w, what=source)
    _close(res[mt][3], res[mt][2][0])


def test_predictor_reshape_reuses_the_bind_cache(lm_checkpoint):
    """``reshape`` to batch 2 and back to 8: the clone at 8 reuses the
    first executor and its program (no new set-up); outputs at batch 2
    equal the JAX Predictor's and the first rows at batch 8; a shape
    mismatch raises."""
    x, y = _data("lm", BATCH)
    res = {}
    for pkg in PKGS:
        pred = pkg.Predictor.from_checkpoint(
            lm_checkpoint[pkg], 3,
            {"data": x.shape, "softmax_label": y.shape}, ctx=pkg.cpu())
        full = _np(pred.forward(data=x)[0])
        small = pred.reshape({"data": (2, LM["seq_len"]),
                              "softmax_label": (2, LM["seq_len"])})
        two = _np(small.forward(data=x[:2])[0])
        with pytest.raises(Exception, match="reshape"):
            small.forward(data=x)
        if pkg is mt:
            captures = programs.GRAPH_STATS["captures"]
        back = small.reshape({"data": x.shape, "softmax_label": y.shape})
        assert back._exec is pred._exec
        again = _np(back.forward(data=x)[0])
        if pkg is mt:
            assert programs.GRAPH_STATS["captures"] == captures
            assert small._exec.arg_dict["head_weight"] is \
                pred._exec.arg_dict["head_weight"]
        np.testing.assert_array_equal(again, full)
        res[pkg] = (two, full)
    _close(res[mt][0], res[mx][0])
    _close(res[mt][0], res[mt][1][:2 * LM["seq_len"]])


def test_feedforward_matches_jax(tmp_path):
    """``FeedForward.create`` on numpy data (shuffled from the same numpy
    seed), then ``predict`` and ``score``, then ``save`` / ``load`` and
    ``predict`` again: equal to the JAX package's."""
    x, y = _data("mlp", 16)
    res = {}
    for pkg in PKGS:
        np.random.seed(5)
        args, _ = _params("mlp")
        model = pkg.model.FeedForward.create(
            _sym(pkg, "mlp"), x, y, ctx=pkg.cpu(), num_epoch=2,
            numpy_batch_size=4, learning_rate=0.1,
            initializer=pkg.initializer.Uniform(0.1),
            arg_params=_nd(pkg, args))
        pred = model.predict(x)
        score = model.score(x)
        prefix = str(tmp_path / pkg.__name__)
        model.save(prefix, 2)
        loaded = pkg.model.FeedForward.load(prefix, 2, ctx=pkg.cpu(),
                                            numpy_batch_size=4)
        res[pkg] = (pred, score, loaded.predict(x))
    _close(res[mt][0], res[mx][0], what="predict")
    np.testing.assert_allclose(res[mt][1], res[mx][1], rtol=TOL_METRIC)
    _close(res[mt][2], res[mt][0], what="loaded")


def test_monitor_on_an_inference_forward_matches_jax():
    """A Monitor installed on an executor: the names its tap collects in
    one inference forward (every node's visible outputs, then the
    matching arguments), sorted, and their statistics equal the JAX
    package's; between intervals it collects nothing."""
    res = {}
    for pkg in PKGS:
        exe = _sym(pkg, "conv").simple_bind(pkg.cpu(), data=(4, 2, 4, 4),
                                            softmax_label=(4,))
        args, aux = _params("conv")
        exe.copy_params_from(_nd(pkg, args), _nd(pkg, aux))
        exe.arg_dict["data"][:] = pkg.nd.array(_data("conv", 4)[0])
        mon = pkg.monitor.Monitor(2, sort=True)
        mon.install(exe)
        batches = []
        for _ in range(3):
            mon.tic()
            exe.forward(is_train=False)
            batches.append(mon.toc())
        res[pkg] = batches
    assert [[r[:2] for r in b] for b in res[mt]] == \
        [[r[:2] for r in b] for b in res[mx]]
    assert res[mt][1] == [] and len(res[mt][0]) > 10
    for g, w in zip(res[mt][0] + res[mt][2], res[mx][0] + res[mx][2]):
        np.testing.assert_allclose(float(g[2]), float(w[2]),
                                   rtol=TOL_METRIC, err_msg=g[1])


@pytest.mark.parametrize("ids", ["over", "negative", "fraction", "mixed"])
def test_embedding_out_of_range_ids_match_jax(ids):
    """Embedding with ids outside [0, input_dim): truncated toward zero,
    a negative id wrapped once, then clamped — the JAX package's gather —
    instead of an IndexError."""
    dim = 10
    data = {"over": [dim, dim + 2, dim - 1],
            "negative": [-1, -dim - 1, -dim],
            "fraction": [3.7, -0.5, 9.99],
            "mixed": [dim, dim + 2, -1, -dim - 1, 3.7]}[ids]
    data = np.array([data], np.float32)
    weight = np.arange(dim * 3, dtype=np.float32).reshape(dim, 3)
    outs = {}
    for pkg in PKGS:
        emb = pkg.sym.Embedding(pkg.sym.Variable("data"), input_dim=dim,
                                output_dim=3, name="emb")
        outs[pkg] = _np(emb.eval(pkg.cpu(), data=pkg.nd.array(data),
                                 emb_weight=pkg.nd.array(weight))[0])
    np.testing.assert_array_equal(outs[mt], outs[mx])


def test_lm_predict_with_out_of_range_tokens_matches_jax():
    """The LM over a batch holding ids ``vocab``, ``vocab + 2`` and
    ``-vocab - 1``: the same probabilities as the JAX package's, and as
    the same batch with the clamped ids."""
    x, y = _data("lm", BATCH)
    v = LM["vocab_size"]
    bad = x.copy()
    bad[0, :3] = [v, v + 2, -v - 1]
    clamped = x.copy()
    clamped[0, :3] = [v - 1, v - 1, 0]
    out = {}
    for pkg in PKGS:
        mod = _module(pkg, "lm")
        res = []
        for xs in (bad, clamped):
            mod.forward(pkg.io.DataBatch([pkg.nd.array(xs)],
                                         [pkg.nd.array(y)]), is_train=False)
            res.append(_np(mod.get_outputs()[0]))
        out[pkg] = res
    _close(out[mt][0], out[mx][0])
    np.testing.assert_array_equal(out[mt][0], out[mt][1])


def test_decode_predictor_takes_a_params_file_or_bytes(lm_checkpoint):
    """``DecodePredictor`` from the ``.params`` path and from its bytes
    generates the tokens the dict-built predictor does."""
    prefix = lm_checkpoint[mt]
    path = "%s-0003.params" % prefix
    sym = "%s-symbol.json" % prefix
    prompt = np.arange(5)[None, :].astype(np.float32)
    toks = []
    for params in (_params("lm")[0], path, open(path, "rb").read()):
        pred = mt.DecodePredictor(sym, params, cache_len=16, device="cpu")
        toks.append(np.asarray(pred.generate(prompt, max_new_tokens=4)))
    assert all(np.array_equal(t, toks[0]) for t in toks)


def test_out_of_range_prompt_serves_like_the_clamped_prompt():
    """A paged DecodeServer (the captured-program path, on the CPU) given
    a prompt holding ids ``vocab``, ``vocab + 2`` and ``-vocab - 1``
    serves it, with the tokens of the prompt holding the clamped ids."""
    v = LM["vocab_size"]
    prompt = np.random.RandomState(4).randint(0, v, 8)
    bad, clamped = prompt.copy(), prompt.copy()
    bad[[1, 4, 6]] = [v, v + 2, -v - 1]
    clamped[[1, 4, 6]] = [v - 1, v - 1, 0]
    pred = mt.DecodePredictor(_sym(mt, "lm"), _params("lm")[0],
                              cache_len=16, device="cpu", paged=True,
                              kv_dtype="int8", page_tokens=4,
                              prefill_chunk=4)
    srv = mt.DecodeServer(pred, 8, slots=2, max_new_tokens=4)
    rids = [srv.submit(bad), srv.submit(clamped)]
    out = srv.run()
    np.testing.assert_array_equal(out[rids[0]], out[rids[1]])
    assert len(out[rids[0]]) == 4
