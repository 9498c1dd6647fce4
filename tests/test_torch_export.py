"""Deployment export through the port, held against the JAX package on the
CPU: ``Predictor.export`` -> ``load_exported`` (``torch.export``) against
the JAX package's ``export`` -> ``load_exported`` (``jax.export``) on the
same numpy weights and inputs, the kernels' torch operators
(``mxnet_tpu_torch::fused_fwd``, ``::flash_fwd``, ``::paged_decode``)
under ``torch.library.opcheck``, their nodes in the predict and decode
artifacts (``analysis.kernel_ops``), and the names and metric views the
JAX package exports.

Models: the deploy walkthrough's MLP (FC 32 -> relu -> FC 2, 16
inputs), ``tests/test_predictor.py``'s conv net (Convolution ->
BatchNorm -> relu -> max pooling -> FC 3) and a 2-layer
``attention_lm`` at embed 64 with one head (head dim 64: the flash
kernel takes head dims 64 and 128, so at embed 32 the attention would
route to ``sdpa`` and its graph would hold no ``flash_fwd``; at this
width each layer holds 5 ``fused_fwd`` nodes — q, k, v, ffn1, ffn2 — and
one ``flash_fwd``).  The JAX side runs as its own CPU tests run it (its
Pallas switches off: the plain jnp versions); the port's loaded program
runs on the CPU, where each operator runs its plain version.

Tolerances: the loaded programs against each other rtol 1e-5 / atol
1e-6, the reference's own (``tests/test_predictor.py:116``); the port's
loaded program against its ``Predictor.forward`` bit for bit (the same
operations on the same device).
"""
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import attention_lm as jlm
from mxnet_tpu.predictor import Predictor as JaxPredictor
from mxnet_tpu.predictor import load_exported as jax_load_exported

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.analysis import kernel_ops
from mxnet_tpu_torch.decode import DecodePredictor
from mxnet_tpu_torch.models import attention_lm
from mxnet_tpu_torch.ops import attention as attn
from mxnet_tpu_torch.ops import decode_kernel as dk
from mxnet_tpu_torch.ops import flash_kernel as fl
from mxnet_tpu_torch.ops import fused_kernel as fk
from mxnet_tpu_torch.predictor import Predictor, load_exported
from mxnet_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
LM = dict(vocab_size=64, seq_len=16, num_layers=2, embed=64, heads=1,
          ffn_hidden=128)
B = 2


def _build(pkg, name):
    s = pkg.sym
    with pkg.NameManager():
        if name == "mlp":
            net = s.FullyConnected(s.Variable("data"), num_hidden=32,
                                   name="fc1")
            net = s.Activation(net, act_type="relu")
            net = s.FullyConnected(net, num_hidden=2, name="fc2")
            return s.SoftmaxOutput(net, name="softmax")
        if name == "conv":
            net = s.Convolution(s.Variable("data"), num_filter=8,
                                kernel=(3, 3), pad=(1, 1), name="c1")
            net = s.BatchNorm(net, name="bn1")
            net = s.Activation(net, act_type="relu")
            net = s.Pooling(net, kernel=(2, 2), stride=(2, 2),
                            pool_type="max")
            net = s.Flatten(net)
            net = s.FullyConnected(net, num_hidden=3, name="fc")
            return s.SoftmaxOutput(net, name="softmax")
        return (jlm if pkg is mx else attention_lm).get_symbol(**LM)


SHAPES = {"mlp": {"data": (8, 16)}, "conv": {"data": (8, 1, 8, 8)},
          "lm": {"data": (B, LM["seq_len"]),
                 "softmax_label": (B, LM["seq_len"])}}


def _inputs(name):
    rng = np.random.RandomState(5)
    if name == "lm":
        x = rng.randint(0, LM["vocab_size"], SHAPES["lm"]["data"])
        return [x.astype(np.float32),
                np.zeros(SHAPES["lm"]["data"], np.float32)]
    return [rng.randn(*SHAPES[name]["data"]).astype(np.float32)]


def _jax_params(name):
    """Seeded numpy weights as the JAX package's (arg, aux) NDArrays."""
    sym = _build(mx, name)
    arg_shapes, _, aux_shapes = sym.infer_shape(**SHAPES[name])
    rng = np.random.RandomState(1)
    arg = {n: mx.nd.array((0.3 * rng.randn(*s)).astype(np.float32))
           for n, s in zip(sym.list_arguments(), arg_shapes)
           if n not in ("data", "softmax_label")}
    aux = {n: mx.nd.array((1.0 + 0.2 * rng.rand(*s) if n.endswith("_var")
                           else 0.1 * rng.randn(*s)).astype(np.float32))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return sym, arg, aux


def _predictors(name, plain=False):
    """The JAX package's Predictor and the port's, on the same weights
    (carried by ``params_from_jax``)."""
    sym, arg, aux = _jax_params(name)
    jparams = {"arg:" + k: v for k, v in arg.items()}
    jparams.update({"aux:" + k: v for k, v in aux.items()})
    jpred = JaxPredictor(sym, jparams, SHAPES[name])
    # the Predictor tells aux states by their "aux:" prefix
    tparams = {"arg:" + k: v for k, v in params_from_jax(
        {k: v.asnumpy() for k, v in arg.items()}, device="cpu").items()}
    tparams.update({"aux:" + k: v for k, v in params_from_jax(
        {k: v.asnumpy() for k, v in aux.items()}, device="cpu").items()})
    tpred = Predictor(_build(mt, name), tparams, SHAPES[name], ctx=mt.cpu(),
                      plain=plain)
    return jpred, tpred


@pytest.mark.parametrize("name,form", [("mlp", "path"), ("mlp", "bytes"),
                                       ("conv", "path"), ("conv", "bytes"),
                                       ("lm", "bytes")])
def test_exported_predictor_matches_jax(name, form, tmp_path):
    """Predictor.export (to a path, or as bytes) -> load_exported on the
    CPU equals the port's Predictor.forward bit for bit and the JAX
    package's export -> load_exported within rtol 1e-5 / atol 1e-6."""
    jpred, tpred = _predictors(name)
    xs = _inputs(name)
    feeds = dict(zip(SHAPES[name], xs))
    want = tpred.forward(**feeds)[0].data.clone()
    if form == "path":
        path = str(tmp_path / ("%s.pt2" % name))
        blob = tpred.export(path)
        with open(path, "rb") as f:
            assert f.read() == blob
        run = load_exported(path, device=mt.cpu())
        jrun = jax_load_exported(jpred.export(str(tmp_path / "j.shlo")))
    else:
        blob = tpred.export()
        run = load_exported(blob, device="cpu")
        jrun = jax_load_exported(jpred.export())
    assert isinstance(blob, bytes) and len(blob) > 0
    got = run(*xs)
    assert isinstance(got, tuple) and len(got) == 1
    assert got[0].device.type == "cpu"
    torch.testing.assert_close(got[0], want, rtol=0, atol=0)
    ref = np.asarray(jrun(*xs)[0])
    np.testing.assert_allclose(got[0].numpy(), ref, **TOL)


def test_lm_artifact_counts_its_kernel_nodes():
    """The small LM's predict artifact holds 5 fused_fwd and one
    flash_fwd node a layer; a plain=True predictor's holds none, and its
    loaded program still equals the JAX package's."""
    jpred, tpred = _predictors("lm")
    art = tpred.artifact()
    layers = LM["num_layers"]
    assert kernel_ops(art) == {"fused_fwd": 5 * layers,
                               "flash_fwd": layers}
    assert art.name == "predict_forward" and art.compiled_text is None
    assert art.describe()["kernel_ops"] == kernel_ops(art)
    assert art.meta["input_names"] == ["data", "softmax_label"]
    assert "ExportedProgram" in tpred.export_stablehlo_text()
    _, ppred = _predictors("lm", plain=True)
    assert kernel_ops(ppred.artifact()) == {}
    xs = _inputs("lm")
    got = load_exported(ppred.export(), device=mt.cpu())(*xs)[0]
    ref = np.asarray(jax_load_exported(jpred.export())(*xs)[0])
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_load_exported_takes_ndarrays_and_checks_arity():
    _, tpred = _predictors("mlp")
    x = _inputs("mlp")[0]
    run = load_exported(tpred.export(), device=mt.cpu())
    a = run(mt.nd.array(x, ctx=mt.cpu()))[0]
    b = run(torch.from_numpy(x.astype(np.float64)))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(mt.MXNetError, match="takes 1 inputs"):
        run(x, x)


# ---------------------------------------------------------------------------
# the serving programs' artifacts
# ---------------------------------------------------------------------------

def _decode_predictor(paged=True, plain=False):
    sym = attention_lm.get_symbol(vocab_size=32, seq_len=32, num_layers=2,
                                  embed=16, heads=2, ffn_hidden=32)
    arg_shapes, _, _ = sym.infer_shape(data=(B, 32), softmax_label=(B, 32))
    rng = np.random.RandomState(0)
    params = {n: rng.normal(0, 0.5, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    return DecodePredictor(sym, params, 32, device="cpu", paged=paged,
                           kv_dtype="int8", page_tokens=4, prefill_chunk=4,
                           plain=plain)


@pytest.mark.parametrize("paged", [True, False])
def test_decode_artifacts_hold_one_paged_decode_a_layer(paged):
    """A paged (and a dense) int8 predictor's decode, verify and prefill
    artifacts: one paged_decode node a layer (the dense prefill builds
    its rings by full attention and holds none) and 5 fused_fwd; a
    plain=True predictor's hold none.  The trace writes nothing."""
    pred = _decode_predictor(paged)
    prompts = np.random.RandomState(2).randint(0, 32, (B, 6))
    state, _ = pred.prefill(prompts.astype(np.float32))
    pools = [t.clone() for pair in state.caches for c in pair
             for t in ((c.data, c.scale) if isinstance(c, attn.QuantKV)
                       else (c,))]
    one = {"fused_fwd": 10, "paged_decode": 2}
    dec = pred.decode_artifact(state)
    ver = pred.verify_artifact(state, 3)
    pre = pred.prefill_artifact(1, 4)
    assert kernel_ops(dec) == one and kernel_ops(ver) == one
    assert kernel_ops(pre) == (one if paged else {"fused_fwd": 10})
    assert dec.meta["cache_bytes"] == pred.cache_bytes(state) > 0
    assert dec.meta["decode_kernel"] is True
    assert dec.meta["cache_layout"] == ("paged" if paged else "dense")
    assert ver.meta["spec_k"] == 3 and dec.expected_traces == 1
    after = [t for pair in state.caches for c in pair
             for t in ((c.data, c.scale) if isinstance(c, attn.QuantKV)
                       else (c,))]
    assert all(torch.equal(a, b) for a, b in zip(pools, after))
    plain = _decode_predictor(paged, plain=True)
    pstate, _ = plain.prefill(prompts.astype(np.float32))
    assert kernel_ops(plain.decode_artifact(pstate)) == {}
    assert kernel_ops(plain.verify_artifact(pstate, 3)) == {}


def test_exported_decode_step_is_the_eager_step():
    """The paged decode artifact's program, run on copies of the state,
    writes the pools, lengths and tokens and returns the probabilities
    the eager body gives on other copies, bit for bit."""
    pred = _decode_predictor()
    state, _ = pred.prefill(np.random.RandomState(3).randint(
        0, 32, (B, 5)).astype(np.float32))
    tables, act = pred._paged_step_inputs(state)
    act = torch.ones_like(act)
    art = pred.decode_artifact(state)

    def copies():
        caches = tuple(tuple(
            attn.QuantKV(c.data.clone(), c.scale.clone())
            if isinstance(c, attn.QuantKV) else c.clone() for c in pair)
            for pair in state.caches)
        return caches, state.lens.clone(), state.tok.clone()

    c1, l1, t1 = copies()
    flat = [t for pair in c1 for c in pair for t in c] + [l1, t1, tables,
                                                          act]
    with torch.no_grad():
        got = art.program.module()(*flat)
    c2, l2, t2 = copies()
    with torch.no_grad():
        want = pred._decode_body(c2, l2, t2, tables, act, None)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(l1, l2) and torch.equal(t1, t2)
    assert torch.equal(l1, state.lens + 1)
    for a, b in zip(flat, [t for pair in c2 for c in pair for t in c]):
        assert torch.equal(a, b)


def test_program_spec_artifacts_match_the_predictor_artifacts():
    """ProgramSpec.artifact exports the registered programs' bodies over
    their abstract (meta) arguments: the model programs hold one
    paged_decode a layer, commit and fork none, and each carries its
    spec's fingerprint and trace count."""
    pred = _decode_predictor()
    report = pred.prepare_programs(2, 4, spec_k=3)
    got = {}
    for kind, spec in pred._program_specs.items():
        art = spec.artifact()
        assert art.fingerprint == report["programs"][kind]["key"]
        assert art.trace_count == spec.trace_count() == 1
        got[kind] = kernel_ops(art)
    one = {"fused_fwd": 10, "paged_decode": 2}
    assert got == {"chunk": one, "decode": one, "verify": one,
                   "commit": {}, "fork": {}}
    assert pred.pool_bytes() == pred.cache_bytes(
        pred.paged_batch_state(2)) > 0
    # a spec without an export hook exports its GraphProgram's body as
    # it is; one over anything else (a training step) has no artifact
    unit = mt.programs.ProgramSpec(
        "t_unit", mt.programs.GraphProgram("t_unit", lambda x: x + 1),
        abstract_args=(torch.empty(2, device="meta"),))
    art = unit.artifact()
    assert kernel_ops(art) == {} and "aten.add" in art.graph_text
    with pytest.raises(mt.MXNetError, match="no body to export"):
        mt.programs.ProgramSpec("t_step", object(),
                                abstract_args=(torch.empty(2),)).artifact()


# ---------------------------------------------------------------------------
# the operators against their fake implementations
# ---------------------------------------------------------------------------

def _fused_args(bias, residual):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 8, generator=g)
    w = torch.randn(5, 8, generator=g)
    return (x, torch.rand(8, generator=g), torch.randn(8, generator=g), w,
            torch.randn(5, generator=g) if bias else None,
            torch.randn(6, 5, generator=g) if residual else None, True)


@pytest.mark.parametrize("bias,residual", [(False, False), (True, True)])
def test_opcheck_fused_fwd(bias, residual):
    torch.library.opcheck(torch.ops.mxnet_tpu_torch.fused_fwd.default,
                          _fused_args(bias, residual))


@pytest.mark.parametrize("groups,causal", [(1, True), (2, False)])
def test_opcheck_flash_fwd(groups, causal):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(4, 12, 64, generator=g)
    kv = torch.randn(4 // groups, 12, 64, generator=g)
    torch.library.opcheck(torch.ops.mxnet_tpu_torch.flash_fwd.default,
                          (q, kv, kv.clone(), 0.125, causal, groups))


@pytest.mark.parametrize("quant", [True, False])
def test_opcheck_paged_decode(quant):
    g = torch.Generator().manual_seed(2)
    heads, kvh, hd, pt, pages = 4, 2, 16, 4, 9
    q = torch.randn(2, 3, heads * hd, generator=g)
    pool = torch.randn(pages, pt, kvh * hd, generator=g)
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    lens = torch.tensor([7, 13], dtype=torch.int32)
    if quant:
        qk = attn.quantize_kv(pool, torch.int8, kvh)
        qv = attn.quantize_kv(pool * 0.5, torch.int8, kvh)
        args = (q, qk.data, qv.data, qk.scale, qv.scale)
    else:
        args = (q, pool, pool * 0.5, None, None)
    torch.library.opcheck(torch.ops.mxnet_tpu_torch.paged_decode.default,
                          args + (table, lens, heads, None, kvh))


def test_operators_run_the_plain_versions_on_the_cpu():
    """The CPU implementations are the plain versions, bit for bit, and
    count no launch."""
    launches = (dict(fk.LAUNCHES), dict(fl.LAUNCHES), dict(dk.LAUNCHES))
    args = _fused_args(True, True)
    got = torch.ops.mxnet_tpu_torch.fused_fwd(*args)
    want = fk.fused_plain(*args[:4], residual=args[5], relu=True,
                          bias=args[4])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    q = torch.randn(2, 8, 64)
    o, lse = torch.ops.mxnet_tpu_torch.flash_fwd(q, q, q, 0.125, True, 1)
    po, plse = fl.flash_plain_fwd(q, q, q, 0.125, True)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert launches == (fk.LAUNCHES, fl.LAUNCHES, dk.LAUNCHES)


# ---------------------------------------------------------------------------
# the faults the re-anchor listed: metric views, exported names
# ---------------------------------------------------------------------------

def _metric_batch(pkg):
    return ([pkg.nd.array(np.array([0, 1, 1], np.float32))],
            [pkg.nd.array(np.array([[.9, .1], [.2, .8], [.7, .3]],
                                   np.float32))])


@pytest.mark.parametrize("metric", ["acc", "ce", "top_k_accuracy"])
def test_sum_metric_and_num_inst_match_jax(metric):
    """``sum_metric`` / ``num_inst`` read (after an update) and written
    as the JAX package's."""
    kw = {"top_k": 2} if metric == "top_k_accuracy" else {}
    got = []
    for pkg in (mx, mt):
        with mt.cpu():
            m = pkg.metric.create(metric, **kw)
            m.update(*_metric_batch(pkg))
            read = (m.sum_metric, m.num_inst)
            m.sum_metric, m.num_inst = 5.0, 10
            got.append((read, m.get()))
    (jr, jget), (tr, tget) = got
    np.testing.assert_allclose(tr[0], jr[0], rtol=1e-6)
    assert tr[1] == jr[1] and tget == jget


def test_composite_metric_views_match_jax():
    """A composite has the views too; like the JAX package's, it keeps no
    sums of its own, so reading them raises AttributeError in both."""
    for pkg in (mx, mt):
        with mt.cpu():
            m = pkg.metric.CompositeEvalMetric(["acc", "ce"])
            m.update(*_metric_batch(pkg))
        assert isinstance(type(m).__dict__.get("sum_metric")
                          or type(m).sum_metric, property)
        with pytest.raises(AttributeError):
            m.sum_metric


_NO_AOT = ("no serialized executables: a CUDA graph cannot be "
           "serialized; deployment goes through torch.export")

# Public names of the JAX package the port does not have, with why.
# ``later`` = a module or method the port has not reached yet (ROADMAP
# queue A); everything else is a stated difference.
NAME_EXCEPTIONS = {
    "top": {"tpu": "no TPU in the port"},
    "nd": {"deque": "a module import, not an API",
           "functools": "a module import, not an API",
           "numeric_types": "a module import, not an API"},
    "io": {"MXDataIter": "the JAX package's raises: no legacy C "
                         "iterators"},
    "context": {"tpu": "no TPU in the port"},
    "random": {"split_key": "jax keys; the port uses torch generators"},
    "programs": dict({n: _NO_AOT for n in ("AOT_STATS", "AotDispatch")},
                     probe_lowered_text="no HLO text: a program's static "
                                        "view is its traced graph "
                                        "(probe_artifact)"),
    "programs.aot": dict({n: _NO_AOT for n in (
        "AOT_STATS", "AotDispatch", "enabled", "save", "load",
        "load_or_compile", "reset_stats")},
        log="a module logger: the port's cache_dir has nothing to log"),
    "rtc": {"register_pallas_op": "the port's user kernels are CUDA C++ "
                                  "(register_cuda_op, build)"},
    "programs.spec": {"probe_lowered_text": "no HLO text: a program's "
                                            "static view is its traced "
                                            "graph (probe_artifact)"},
    "analysis": {"artifact_from_jit": "jax: the port's one tracing function is "
                                      "artifact_from_export (torch.export, "
                                      "make_fx for autograd)",
                 "hlo_parse": "HLO text: the port parses traced graphs "
                              "(analysis.graph_parse)"},
    "Executor": {"compiled_hlo": "no HLO text: a program's static "
                                 "view is its traced graph"},
    "DecodePredictor": {"decode_step_text": "no HLO text",
                        "prefill_text": "no HLO text"},
    "ProgramSpec": {"compiled": "no HLO text", "lowered": "no HLO text"},
    "Context": {"jax_device": "jax"},
    "CompiledTrainStep": {"compiled_hlo": "no HLO text: the step's "
                                          "static view is artifact()"},
}


def _name_pairs():
    import importlib

    import mxnet_tpu.decode as jd
    import mxnet_tpu.programs.spec as js
    import mxnet_tpu.train_step as jts

    import mxnet_tpu_torch.programs.spec as ts
    import mxnet_tpu_torch.train_step as tts

    pairs = [("top", mx, mt), ("sym", mx.sym, mt.sym), ("nd", mx.nd, mt.nd)]
    for mod in ("registry", "base", "executor", "predictor", "decode",
                "metric", "context", "io", "optimizer", "initializer",
                "module", "random", "autograd", "callback", "monitor",
                "lr_scheduler", "test_utils", "profiler", "recordio",
                "operator", "rnn", "models", "obs", "programs", "serve",
                "config", "attrs", "checkpoint", "elastic", "parallel",
                "parallel.health", "parallel.launch", "parallel.mesh",
                "parallel.collectives", "kvstore", "kvstore_server",
                "model", "programs.aot", "ops.tuning", "rtc",
                "visualization", "contrib", "contrib.tensorboard",
                "analysis", "analysis.framework", "analysis.passes",
                "analysis.cost", "analysis.retrace", "analysis.schedule",
                "analysis.programs", "programs.registry",
                "programs.spec", "programs.partition",
                "parallel.tp_rules", "parallel.pipeline", "parallel.ring",
                "parallel.compat"):
        pairs.append((mod, importlib.import_module("mxnet_tpu." + mod),
                      importlib.import_module("mxnet_tpu_torch." + mod)))
    pairs += [
        ("Executor", mx.executor.Executor, mt.executor.Executor),
        ("NDArray", mx.nd.NDArray, mt.nd.NDArray),
        ("Symbol", mx.sym.Symbol, mt.sym.Symbol),
        ("Predictor", mx.predictor.Predictor, mt.predictor.Predictor),
        ("DecodePredictor", jd.DecodePredictor, mt.decode.DecodePredictor),
        ("DecodeServer", jd.DecodeServer, mt.decode.DecodeServer),
        ("EvalMetric", mx.metric.EvalMetric, mt.metric.EvalMetric),
        ("CompositeEvalMetric", mx.metric.CompositeEvalMetric,
         mt.metric.CompositeEvalMetric),
        ("Module", mx.mod.Module, mt.mod.Module),
        ("BucketingModule", mx.mod.BucketingModule, mt.mod.BucketingModule),
        ("PipelineModule", mx.mod.PipelineModule, mt.mod.PipelineModule),
        ("ProgramSpec", js.ProgramSpec, ts.ProgramSpec),
        ("Context", mx.Context, mt.Context),
        ("KVStore", mx.kvstore.KVStore, mt.kvstore.KVStore),
        ("CompiledTrainStep", jts.CompiledTrainStep, tts.CompiledTrainStep),
        ("CompiledEvalStep", jts.CompiledEvalStep, tts.CompiledEvalStep),
        ("Optimizer", mx.optimizer.Optimizer, mt.optimizer.Optimizer),
        ("DataIter", mx.io.DataIter, mt.io.DataIter),
        ("NDArrayIter", mx.io.NDArrayIter, mt.io.NDArrayIter),
    ]
    return pairs


def _public(obj, own=False):
    """Public names of ``obj``; with ``own`` (a module, not a package or
    a namespace such as ``sym``) only those it defines: a module it
    imports, or a class or function it imports from another module, is
    not its API."""
    names = set()
    for n in dir(obj):
        if n.startswith("_"):
            continue
        v = getattr(obj, n)
        if own and (inspect.ismodule(v) or getattr(
                v, "__module__", obj.__name__) != obj.__name__
                and (inspect.isclass(v) or inspect.isfunction(v))):
            continue
        names.add(n)
    return names


def _name_gaps():
    """{what: the public names of the JAX package's object that the
    port's lacks}."""
    gaps = {}
    for what, jobj, tobj in _name_pairs():
        # a package's names are its submodules' re-exports
        own = inspect.ismodule(jobj) and not hasattr(jobj, "__path__") \
            and what not in ("sym", "nd")
        gap = _public(jobj, own) - _public(tobj)
        if gap:
            gaps[what] = sorted(gap)
    return gaps


def test_public_names_match_jax_but_the_stated_exceptions():
    """Every public name of the JAX package's modules and classes that
    the port has ported is in the port too, except the stated ones; and
    every stated exception is still missing (a name ported since must
    leave the list).  Read in a fresh interpreter: in this one other
    tests register ops (which become ``nd`` / ``sym`` functions) and
    import submodules (which become package attributes)."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([here, root,
                                         env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-c", "import json, test_torch_export as t; "
         "print(json.dumps(t._name_gaps()))"],
        capture_output=True, text=True, env=env, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr
    gaps = json.loads(out.stdout.strip().splitlines()[-1])
    missing, stale = {}, {}
    for what in set(gaps) | set(NAME_EXCEPTIONS):
        gap = set(gaps.get(what, ()))
        allowed = set(NAME_EXCEPTIONS.get(what, {}))
        if gap - allowed:
            missing[what] = sorted(gap - allowed)
        if allowed - gap:
            stale[what] = sorted(allowed - gap)
    assert missing == {} and stale == {}


def test_the_repaired_names_behave_as_in_jax():
    """The names the re-anchor found missing, driven on both packages."""
    for pkg in (mx, mt):
        assert pkg.Executor is pkg.executor.Executor
        assert pkg.Variable is pkg.sym.Variable is pkg.sym.var
        assert pkg.Optimizer is pkg.optimizer.Optimizer
        assert "xavier" in pkg.init_registry
        assert pkg.num_devices("cpu") >= 1
        assert pkg.registry.has_op("FullyConnected")
        assert not pkg.registry.has_op("no_such_op")
        with pkg.base.Prefix("net1_"):
            fc = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=3)
        assert fc.name == "net1_fullyconnected0"
        assert pkg.Group([fc, fc]).list_outputs() == [
            "net1_fullyconnected0_output"] * 2
        exe = pkg.Executor.simple_bind(fc, pkg.cpu(), grad_req="null",
                                       data=(2, 4))
        assert sorted(exe.arg_dict) == ["data", "net1_fullyconnected0_bias",
                                        "net1_fullyconnected0_weight"]
        assert repr(pkg.nd.cpu()) == "cpu(0)"
        with mt.cpu():
            a = pkg.nd.array(np.zeros(3, np.float32))
        assert a.handle is a
        a.writable = False
        with pytest.raises(pkg.MXNetError, match="immutable"):
            a[:] = 1.0

    # registry.register, with the op taken out again (other tests compare
    # the registry with the JAX package's)
    try:
        @mt.registry.register("_test_export_twice")
        def _twice(attrs, x):
            return x * 2

        op = mt.registry.get_op("_test_export_twice")
        (y,), _ = op.fcompute({}, [torch.ones(2)], [],
                              mt.registry.OpContext())
        assert torch.equal(y, torch.full((2,), 2.0))
    finally:
        mt.registry._OPS.pop("_test_export_twice", None)
