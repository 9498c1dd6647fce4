"""The port's compiled training loop — ``CompiledTrainStep`` under
``fit`` (device-side metric accumulation included), ``score`` through
``CompiledEvalStep``, the trace counters and the eligibility rule — held
against the JAX package's on the CPU, where each ``GraphProgram`` runs
its body over the same bound buffers without a capture.

Three trainers from the same numpy weights and batches:

* ``lm``: a small ``attention_lm`` (one layer), SGD, Perplexity; the JAX
  side runs its fused LN->linear and flash-attention kernels in
  interpret mode;
* ``conv``: Convolution -> BatchNorm -> tanh -> pooling -> FC, SGD with
  momentum and wd, Accuracy (tanh: no ReLU mask to flip between the two
  packages' roundings);
* ``nag``: the same net under NAG with momentum and wd, which the slab
  plan declines: the step runs the optimizer's per-parameter ``apply``;
* ``lstm``: the tiny bucketed LSTM LM over buckets 4 and 8, Adam,
  Perplexity, through ``BucketingModule.fit``.

The JAX side keeps its per-parameter update (``MXNET_PALLAS_UPDATE=
False``); the port's slab plan takes kernel B1's plain version.
Tolerances are ``tests/test_torch_bucketing.py``'s: parameters,
optimizer slots and moving statistics 1e-5 absolute under SGD, 1e-4
under Adam (it divides by sqrt(v) + eps, magnifying f32 rounding where v
is small); the device-accumulated metric and the score 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import config as jconfig
from mxnet_tpu.models import attention_lm as jlm
from mxnet_tpu.models import lstm_lm as jlstm

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import programs
from mxnet_tpu_torch.models import attention_lm, lstm_lm
from mxnet_tpu_torch.ops import update_kernel


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    """Arrays made without a context go to the host: the port's default
    context is the card."""
    with mt.cpu():
        yield


torch.set_num_threads(1)

TOL = {"sgd": 1e-5, "nag": 1e-5, "adam": 1e-4}
TOL_METRIC = 1e-5
LM = dict(vocab_size=32, seq_len=128, num_layers=1, embed=128, heads=2,
          ffn_hidden=256)
CONV_B, CONV_CLASSES = 4, 5
LSTM = dict(num_hidden=8, num_layers=2, num_embed=8, vocab_size=20)
BUCKETS = [4, 8]


def _conv_sym(pkg):
    s = pkg.sym
    net = s.Convolution(s.Variable("data"), num_filter=4, kernel=(3, 3),
                        pad=(1, 1), name="conv")
    net = s.BatchNorm(net, fix_gamma=False, name="bn")
    net = s.Activation(net, act_type="tanh", name="act")
    net = s.Pooling(net, kernel=(8, 8), pool_type="avg", global_pool=True,
                    name="pool")
    net = s.FullyConnected(s.Flatten(net), num_hidden=CONV_CLASSES,
                           name="fc")
    return s.SoftmaxOutput(net, name="softmax")


def _lm_sym(pkg):
    return (jlm if pkg is mx else attention_lm).get_symbol(**LM)


def _lstm_sym_gen(pkg):
    if pkg is mt:
        return lstm_lm.sym_gen_factory(fused=False, ignore_label=-1,
                                       **LSTM)[0]
    sym_gen, _ = jlstm.sym_gen_factory(fused=False, **LSTM)

    def padded(seq_len):
        # the port's ignore_label=-1: the same head with use_ignore
        sym, data_names, label_names = sym_gen(seq_len)
        pred = sym.get_internals()["pred_output"]
        label = mx.sym.Reshape(mx.sym.Variable("softmax_label"),
                               shape=(-1,))
        return (mx.sym.SoftmaxOutput(pred, label, use_ignore=True,
                                     ignore_label=-1, name="softmax"),
                data_names, label_names)

    return padded


def _seeded(sym, shapes, seed, scale):
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        v = 1.0 + 0.1 * rng.randn(*s) if n.endswith("_gamma") \
            else scale * rng.randn(*s)
        args[n] = v.astype(np.float32)
    aux = {n: (np.ones(s) if n.endswith("_var") else np.zeros(s))
           .astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _sentences():
    rng = np.random.RandomState(0)
    return [rng.randint(1, LSTM["vocab_size"], size=rng.randint(2, 9))
            .tolist() for _ in range(24)]


def _case(name):
    """(optimizer, its params, a metric maker by package, data, initial
    arg / aux params)."""
    if name == "lm":
        rng = np.random.RandomState(0)
        x = rng.randint(0, LM["vocab_size"], (6, LM["seq_len"]))
        y = np.concatenate([x[:, 1:], np.full((6, 1), -1)], 1)
        args, aux = _seeded(attention_lm.get_symbol(**LM),
                            {"data": (2, LM["seq_len"]),
                             "softmax_label": (2, LM["seq_len"])}, 1, 0.05)
        return ("sgd", {"learning_rate": 0.002}, 2,
                lambda pkg: pkg.metric.Perplexity(ignore_label=-1),
                (x.astype(np.float32), y.astype(np.float32)), args, aux)
    if name in ("conv", "nag"):
        rng = np.random.RandomState(0)
        x = rng.randn(12, 3, 8, 8).astype(np.float32)
        y = rng.randint(0, CONV_CLASSES, 12).astype(np.float32)
        args, aux = _seeded(_conv_sym(mt), {"data": (CONV_B, 3, 8, 8),
                                            "softmax_label": (CONV_B,)}, 2,
                            0.2)
        return (name if name == "nag" else "sgd",
                {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
                CONV_B, lambda pkg: pkg.metric.Accuracy(), (x, y), args, aux)
    sym = _lstm_sym_gen(mt)(max(BUCKETS))[0]
    args, aux = _seeded(sym, {"data": (4, max(BUCKETS)),
                              "softmax_label": (4, max(BUCKETS))}, 3, 0.3)
    return ("adam", {"learning_rate": 0.01}, 4,
            lambda pkg: pkg.metric.Perplexity(ignore_label=-1), None,
            args, aux)


def _iter(pkg, name, data, batch):
    if name == "lstm":
        return pkg.rnn.BucketSentenceIter(_sentences(), batch,
                                          buckets=BUCKETS, seed=0)
    return pkg.io.NDArrayIter(data[0], data[1], batch_size=batch)


def _module(pkg, name):
    if name == "lstm":
        return pkg.mod.BucketingModule(_lstm_sym_gen(pkg),
                                       default_bucket_key=max(BUCKETS),
                                       context=pkg.cpu())
    sym = _lm_sym(pkg) if name == "lm" else _conv_sym(pkg)
    return pkg.mod.Module(sym, context=pkg.cpu())


def _nd(pkg, tree):
    return {k: pkg.nd.array(v) for k, v in tree.items()}


def _run(pkg, name):
    """fit one epoch, read the metric, score: everything the tests
    compare, as numpy."""
    opt, opt_params, batch, metric, data, args, aux = _case(name)
    it = _iter(pkg, name, data, batch)
    mod = _module(pkg, name)
    train_metric = metric(pkg)
    before = dict(programs.GRAPH_STATS)
    mod.fit(it, eval_metric=train_metric, optimizer=opt,
            optimizer_params=opt_params, arg_params=_nd(pkg, args),
            aux_params=_nd(pkg, aux), num_epoch=1)
    prim = mod._primary if name == "lstm" else mod
    step = prim._fused_step if pkg is mx else prim._train_step
    if pkg is mx:
        slots = {n: [np.asarray(t) for t in v]
                 for n, v in step.slots.items()}
    else:
        slots = {n: [t.numpy().copy() for t in v]
                 for n, v in step._slot_views().items()}
    acc = step._metric_acc
    armed = acc is not None and acc.metric is train_metric
    value = train_metric.get()[1]
    arg_p, aux_p = mod.get_params()
    score = mod.score(it, metric(pkg))[0][1]
    stats = {k: programs.GRAPH_STATS[k] - before[k]
             for k in ("captures", "replays")}
    host = lambda t: {k: v.asnumpy() for k, v in t.items()}  # noqa: E731
    return {"args": host(arg_p), "aux": host(aux_p), "slots": slots,
            "metric": value, "armed": armed, "score": score,
            "trace_count": step.trace_count,
            "programs_built": step.programs_built, "stats": stats,
            "executors": len(mod._buckets) if name == "lstm" else 1,
            "steps": step.num_steps, "opt": opt,
            "update_path": None if pkg is mx else
            update_kernel.UPDATE_PATH["last"]}


def _jax_run(name):
    with jconfig.overrides(MXNET_PALLAS_UPDATE=False,
                           MXNET_PALLAS_FUSED=name == "lm",
                           MXNET_PALLAS_ATTENTION=name == "lm",
                           MXNET_PALLAS_INTERPRET=name == "lm"):
        return _run(mx, name)


@pytest.fixture(scope="module", params=["lm", "conv", "nag", "lstm"])
def runs(request):
    name = request.param
    return name, _jax_run(name), _run(mt, name)


def _close(got, want, tol, what):
    assert set(got) == set(want), what
    for k in sorted(want):
        for a, b in zip(np.atleast_1d(got[k]) if not isinstance(
                got[k], list) else got[k], np.atleast_1d(want[k])
                if not isinstance(want[k], list) else want[k]):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                       err_msg="%s %s" % (what, k))


def test_compiled_fit_matches_jax(runs):
    """Parameters, moving statistics and optimizer slots after one epoch
    of ``fit``, and the metric the step accumulated on the device, equal
    the JAX package's compiled step's."""
    name, want, got = runs
    tol = TOL[want["opt"]]
    _close(got["args"], want["args"], tol, "param")
    _close(got["aux"], want["aux"], tol, "aux")
    _close(got["slots"], want["slots"], tol, "slot")
    assert got["armed"] and want["armed"]
    assert got["steps"] == want["steps"] > 2
    assert got["update_path"] == ("per_param" if name == "nag" else "plain")
    np.testing.assert_allclose(got["metric"], want["metric"],
                               rtol=TOL_METRIC)


def test_score_through_the_eval_step_matches_jax(runs):
    """``score`` after training: the port's ``CompiledEvalStep`` (a
    Module) or host path (buckets, as in the JAX package) against the
    JAX ``score``."""
    _, want, got = runs
    np.testing.assert_allclose(got["score"], want["score"],
                               rtol=TOL_METRIC)


def test_one_program_per_executor_then_replays(runs):
    """One set-up (capture on the card) per executor signature and
    replays after, with the JAX step's ``trace_count`` and
    ``programs_built`` (the program is rebuilt when fit binds the
    metric)."""
    name, want, got = runs
    assert (got["trace_count"], got["programs_built"]) == \
        (want["trace_count"], want["programs_built"])
    assert got["trace_count"] == got["executors"]
    # the train programs, plus score's eval program on a Module, or on
    # buckets (score's host path) each bucket's captured inference forward
    evals = got["executors"] if name == "lstm" else 1
    assert got["stats"]["captures"] == got["executors"] + evals
    assert got["stats"]["replays"] >= got["steps"] - got["executors"]


class _HostOnly:
    """A metric without a device mirror, in either package."""

    @staticmethod
    def make(pkg):
        class HostOnly(pkg.metric.EvalMetric):
            def __init__(self):
                super().__init__("host-only")

            def _batch(self, label, pred):
                return float(np.asarray(pred).sum()), 1

        return HostOnly()


@pytest.mark.parametrize("setting", ["nag", "inputs_need_grad",
                                     "switch_off", "host_metric"])
def test_eligibility_matches_jax(setting):
    """The compiled step's eligibility, decided before anything runs,
    equals the JAX package's: NAG trains compiled (no slab plan), input
    gradients and ``MXNET_FUSED_TRAIN_STEP=0`` take the eager path, and
    a metric without a device mirror stays on the host."""
    opt, opt_params, batch, _, data, args, aux = _case("conv")
    if setting == "nag":
        opt = "nag"

    def decide(pkg, overrides):
        mod = _module(pkg, "conv")
        it = _iter(pkg, "conv", data, batch)
        with overrides(MXNET_FUSED_TRAIN_STEP=setting != "switch_off"):
            mod.bind(it.provide_data, it.provide_label,
                     inputs_need_grad=setting == "inputs_need_grad")
            mod.init_params(arg_params=_nd(pkg, args),
                            aux_params=_nd(pkg, aux))
            mod.init_optimizer(optimizer=opt, optimizer_params=opt_params)
        step = mod._fused_step if pkg is mx else mod._train_step
        armed = None
        if step is not None:
            metric = _HostOnly.make(pkg) if setting == "host_metric" \
                else pkg.metric.Accuracy()
            armed = step.attach_metric(metric)
        return step is not None, armed

    with jconfig.overrides(MXNET_PALLAS_UPDATE=False):
        want = decide(mx, jconfig.overrides)
    got = decide(mt, tconfig.overrides)
    assert got == want
    assert want == {"nag": (True, True), "inputs_need_grad": (False, None),
                    "switch_off": (False, None),
                    "host_metric": (True, False)}[setting]


def test_slot_handoffs_round_trip():
    """The step's slots handed to an eager updater are copies of them
    (``export_updater_states``); ``reset_slots`` zeroes the step's in
    place; ``import_updater_states`` copies the handed-over ones back."""
    opt, opt_params, batch, _, data, args, aux = _case("conv")
    mod = _module(mt, "conv")
    it = _iter(mt, "conv", data, batch)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=_nd(mt, args), aux_params=_nd(mt, aux))
    mod.init_optimizer(optimizer=opt, optimizer_params=opt_params)
    for b in it:
        mod.forward_backward(b)
    step, names = mod._train_step, mod._exec_group.param_names
    trained = {n: [t.clone() for t in v]
               for n, v in step._slot_views().items()}
    other = mt.optimizer.get_updater(mod._optimizer)
    step.export_updater_states(other, names)
    step.reset_slots()
    assert all(not t.any() for v in step._slot_views().values() for t in v)
    for i, n in enumerate(names):
        assert torch.equal(other.states[i], trained[n][0])
    step.import_updater_states(other.states, names)
    for n, v in step._slot_views().items():
        assert all(torch.equal(a, b) for a, b in zip(v, trained[n]))


@pytest.mark.parametrize("period", [0, 3])
def test_metric_sync_period_drains_like_jax(period):
    """``MXNET_METRIC_SYNC_PERIOD``: with the metric accumulated inside
    the compiled step, ``update_metric`` folds the device sums into the
    host metric every ``period`` steps and not between (0: never until
    the metric is read), step for step as the JAX Module does; reading
    the metric drains the rest."""
    rng = np.random.RandomState(12)
    x = rng.randn(4, 5).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.float32)
    w = {"fc_weight": rng.randn(3, 5).astype(np.float32) * 0.3,
         "fc_bias": np.zeros(3, np.float32)}
    seen = {}
    for pkg, cfg in ((mx, jconfig), (mt, tconfig)):
        sym = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            pkg.sym.Variable("data"), num_hidden=3, name="fc"),
            name="softmax")
        mod = pkg.mod.Module(sym, context=pkg.cpu())
        mod.bind([pkg.io.DataDesc("data", (4, 5))],
                 [pkg.io.DataDesc("softmax_label", (4,))])
        mod.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in w.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        metric = pkg.metric.create("acc")
        mod._bind_metric(metric)
        batch = pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)])
        host = []
        with cfg.overrides(MXNET_METRIC_SYNC_PERIOD=period):
            for _ in range(7):
                mod.forward_backward(batch)
                mod.update()
                mod.update_metric(metric, batch.label)
                host.append(metric._counts[0])
            value = metric.get()[1]
        seen[pkg] = host, metric._counts[0], value
    assert seen[mt] == seen[mx]
    want = [4 * ((i + 1) // period * period if period else 0)
            for i in range(7)]
    assert seen[mt][0] == want and seen[mt][1] == 28
