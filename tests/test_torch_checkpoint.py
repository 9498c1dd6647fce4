"""Checkpoints between the JAX package and the port, on the CPU: the
``.params`` format (f32 and bf16, files and bytes), ``-symbol.json``
and the fused ``.states`` payload written by either package load in the
other; a resumed run (``Module.load(..., load_optimizer_states=True)``
and one more step) lands where the uninterrupted run does; and the
checkpoint callbacks write the JAX callbacks' files.  The port's
step-directory checkpoints (``checkpoint.save_sharded`` / ``load_sharded``
on ``torch.distributed.checkpoint``) are held to the JAX package's
``tests/test_sharded_checkpoint.py`` cases: the round trip, restores in
place that the next compiled step reads, the commit rules, slot-less
and inference restores; bit for bit, within the port.

Tolerances: what a file carries is compared exactly (values, dtypes,
bytes); one step after loading, each package's parameters against the
other's to 1e-5 absolute (f32 rounding in another order); a resumed run
of the port against its uninterrupted run bit for bit.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import config as jconfig
from mxnet_tpu.io import DataBatch as JBatch
from mxnet_tpu.models import lstm_lm as jlstm

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import elastic
from mxnet_tpu_torch.io import DataBatch
from mxnet_tpu_torch.models import lstm_lm


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    """Arrays made without a context go to the host: the port's default
    context is the card."""
    with mt.cpu():
        yield


torch.set_num_threads(1)

B, CLASSES = 4, 5
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
TOL_STEP = 1e-5


def _sym(pkg):
    s = pkg.sym
    net = s.Convolution(s.Variable("data"), num_filter=4, kernel=(3, 3),
                        pad=(1, 1), name="conv")
    net = s.BatchNorm(net, fix_gamma=False, name="bn")
    net = s.Activation(net, act_type="tanh", name="act")
    net = s.Pooling(net, kernel=(8, 8), pool_type="avg", global_pool=True,
                    name="pool")
    net = s.FullyConnected(s.Flatten(net, name="flat"), num_hidden=CLASSES,
                           name="fc")
    return s.SoftmaxOutput(net, name="softmax")


def _values():
    rng = np.random.RandomState(5)
    sym = _sym(mt)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(B, 3, 8, 8),
                                                softmax_label=(B,))
    args = {n: (0.3 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if n.endswith("_var") else np.zeros(s))
           .astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    batches = [(rng.randn(B, 3, 8, 8).astype(np.float32),
                rng.randint(0, CLASSES, B).astype(np.float32))
               for _ in range(3)]
    return args, aux, batches


def _batch(pkg, x, y):
    cls = JBatch if pkg is mx else DataBatch
    return cls([pkg.nd.array(x)], [pkg.nd.array(y)])


def _bound(pkg, mod, args=None, aux=None):
    mod.bind(data_shapes=[("data", (B, 3, 8, 8))],
             label_shapes=[("softmax_label", (B,))])
    if args is not None:
        mod.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in args.items()},
                        aux_params={k: pkg.nd.array(v)
                                    for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    return mod


def _train(pkg, mod, batches):
    for x, y in batches:
        mod.forward_backward(_batch(pkg, x, y))
        mod.update()


def _params(mod):
    arg, aux = mod.get_params()
    out = {k: v.asnumpy().copy() for k, v in arg.items()}
    out.update({"aux:" + k: v.asnumpy().copy() for k, v in aux.items()})
    return out


def _slots(pkg, mod):
    step = mod._fused_step if pkg is mx else mod._train_step
    views = step.slots if pkg is mx else step._slot_views()
    return {n: [np.asarray(t) for t in v] for n, v in views.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_files_load_in_both_packages(tmp_path, dtype):
    """A ``.params`` file (named arrays, f32 or bf16) written by either
    package loads in the other with the same values and dtype; the port
    also reads the file's bytes."""
    rng = np.random.RandomState(0)
    values = {"arg:w": rng.randn(3, 4).astype(np.float32),
              "aux:s": rng.randn(5).astype(np.float32)}
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    port = {k: torch.from_numpy(v).to(tdt) for k, v in values.items()}
    want = {k: v.float().numpy() for k, v in port.items()}
    mt.nd.save(str(tmp_path / "port.params"), port)
    mx.nd.save(str(tmp_path / "jax.params"),
               {k: mx.nd.array(v, dtype=dtype) for k, v in want.items()})
    for fname in ("port.params", "jax.params"):
        path = str(tmp_path / fname)
        jax_side = mx.nd.load(path)
        assert {k: str(v.asnumpy().dtype) for k, v in jax_side.items()} \
            == {k: dtype for k in want}
        for source in (path, open(path, "rb").read()):
            port_side = mt.nd.load(source)
            assert set(port_side) == set(want)
            for k, v in port_side.items():
                assert v.data.dtype == tdt
                np.testing.assert_array_equal(v.asnumpy(), want[k])
                np.testing.assert_array_equal(
                    jax_side[k].asnumpy().astype(np.float32), want[k])
    assert open(tmp_path / "port.params", "rb").read() == \
        open(tmp_path / "jax.params", "rb").read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_module_checkpoint_loads_in_the_other_package(tmp_path, writer):
    """Two compiled steps, ``save_checkpoint(..., save_optimizer_states=
    True)``, then ``Module.load(..., load_optimizer_states=True)`` in the
    other package: the same symbol, parameters, moving statistics and
    momentum; one more step in each lands within f32 rounding."""
    args, aux, batches = _values()
    wpkg, rpkg = (mx, mt) if writer == "jax" else (mt, mx)
    prefix = str(tmp_path / "ck")
    with jconfig.overrides(MXNET_PALLAS_UPDATE=False):
        wmod = _bound(wpkg, wpkg.mod.Module(_sym(wpkg), context=wpkg.cpu()),
                      args, aux)
        _train(wpkg, wmod, batches[:2])
        wmod.save_checkpoint(prefix, 2, save_optimizer_states=True)
        rmod = _bound(rpkg, rpkg.mod.Module.load(
            prefix, 2, load_optimizer_states=True, context=rpkg.cpu()))
        assert rmod.symbol.tojson() == wmod.symbol.tojson()
        saved, got = _params(wmod), _params(rmod)
        assert set(saved) == set(got)
        for k in saved:
            np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
        wslots, rslots = _slots(wpkg, wmod), _slots(rpkg, rmod)
        assert set(wslots) == set(rslots)
        for k in wslots:
            np.testing.assert_array_equal(rslots[k][0], wslots[k][0],
                                          err_msg=k)
        _train(wpkg, wmod, batches[2:])
        _train(rpkg, rmod, batches[2:])
    want, got = _params(wmod), _params(rmod)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL_STEP,
                                   err_msg=k)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """The port trains three steps; a second run stops after two, saves
    with its optimizer states, loads into a new Module and takes the
    third: the same parameters, bit for bit."""
    args, aux, batches = _values()
    whole = _bound(mt, mt.mod.Module(_sym(mt), context=mt.cpu()), args, aux)
    _train(mt, whole, batches)
    first = _bound(mt, mt.mod.Module(_sym(mt), context=mt.cpu()), args, aux)
    _train(mt, first, batches[:2])
    prefix = str(tmp_path / "resume")
    first.save_checkpoint(prefix, 2, save_optimizer_states=True)
    resumed = _bound(mt, mt.mod.Module.load(
        prefix, 2, load_optimizer_states=True, context=mt.cpu()))
    _train(mt, resumed, batches[2:])
    want, got = _params(whole), _params(resumed)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _lstm_values():
    sym_gen, _ = lstm_lm.sym_gen_factory(8, 2, 8, 20, fused=False)
    sym = sym_gen(4)[0]
    shapes, _, _ = sym.infer_shape(data=(2, 4), softmax_label=(2, 4))
    rng = np.random.RandomState(3)
    args = {n: rng.randn(*s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    return args


@pytest.mark.parametrize("callback", ["do_checkpoint", "do_rnn_checkpoint"])
def test_checkpoint_callbacks_write_the_jax_files(tmp_path, callback):
    """``callback.do_checkpoint`` and ``rnn.do_rnn_checkpoint`` write the
    bytes the JAX callbacks write for the same epoch, symbol and
    parameters (the RNN case over the unfused LSTM LM's cells)."""
    if callback == "do_checkpoint":
        syms = {mx: _sym(mx), mt: _sym(mt)}
        args, aux, _ = _values()
        make = {pkg: (lambda prefix, pkg=pkg: pkg.callback.do_checkpoint(
            prefix)) for pkg in (mx, mt)}
    else:
        args, aux = _lstm_values(), {}
        syms = {}
        for pkg, lm in ((mx, jlstm), (mt, lstm_lm)):
            # pinned auto-names: the graphs' JSON is the same byte for byte
            with pkg.NameManager():
                syms[pkg] = lm.sym_gen_factory(8, 2, 8, 20,
                                               fused=False)[0](4)[0]
        cells = {pkg: [pkg.rnn.LSTMCell(8, prefix="lstm_l%d_" % i)
                       for i in range(2)] for pkg in (mx, mt)}
        make = {pkg: (lambda prefix, pkg=pkg: pkg.rnn.do_rnn_checkpoint(
            cells[pkg], prefix)) for pkg in (mx, mt)}
    files = {}
    for pkg, tag in ((mx, "jax"), (mt, "port")):
        prefix = str(tmp_path / tag)
        make[pkg](prefix)(0, syms[pkg],
                          {k: pkg.nd.array(v) for k, v in args.items()},
                          {k: pkg.nd.array(v) for k, v in aux.items()})
        files[tag] = sorted(os.listdir(tmp_path))
        files[tag] = {name[len(tag):]: open(tmp_path / name, "rb").read()
                      for name in files[tag] if name.startswith(tag)}
    assert sorted(files["port"]) == ["-0001.params", "-symbol.json"]
    assert files["port"] == files["jax"]


def test_fused_rnn_checkpoint_unpacks_in_jax(tmp_path):
    """``save_rnn_checkpoint`` with a ``FusedRNNCell`` packs the per-gate
    weights into the cell's blob; the JAX ``load_rnn_checkpoint`` with
    its fused cell unpacks the same per-gate arrays."""
    sym = lstm_lm.sym_gen_factory(8, 2, 8, 20)[0](4)[0]
    cell = mt.rnn.FusedRNNCell(8, num_layers=2, prefix="lstm_")
    rng = np.random.RandomState(4)
    shapes, _, _ = sym.infer_shape(data=(2, 4), softmax_label=(2, 4))
    args = {n: rng.randn(*s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    gates = cell.unpack_weights(args, input_size=8)
    prefix = str(tmp_path / "fused")
    mt.rnn.save_rnn_checkpoint(cell, prefix, 1, sym, gates, {})
    _, jargs, _ = mx.rnn.load_rnn_checkpoint(
        mx.rnn.FusedRNNCell(8, num_layers=2, prefix="lstm_"), prefix, 1)
    assert set(jargs) == set(gates)
    for k, v in gates.items():
        got = jargs[k]
        np.testing.assert_array_equal(
            got.asnumpy() if hasattr(got, "asnumpy") else got, v,
            err_msg=k)


# ---------------------------------------------------------------------------
# step-directory checkpoints (checkpoint.save_sharded / load_sharded): the
# JAX package's tests/test_sharded_checkpoint.py cases on the port's files
# ---------------------------------------------------------------------------
def _state(mod):
    """Parameters, aux states and the train step's slots, as numpy."""
    out = _params(mod)
    if mod._train_step is not None:
        for n, slots in _slots(mt, mod).items():
            for i, s in enumerate(slots):
                out["slot:%s:%d" % (n, i)] = s.copy()
    return out


def _other_values(seed):
    rng = np.random.RandomState(seed)
    args, aux, _ = _values()
    args = {k: (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
            for k, v in args.items()}
    batches = [(rng.randn(B, 3, 8, 8).astype(np.float32),
                rng.randint(0, CLASSES, B).astype(np.float32))
               for _ in range(2)]
    return args, aux, batches


def _eval_out(mod, x):
    mod.forward(_batch(mt, x, np.zeros(B, np.float32)), is_train=False)
    return mod.get_outputs()[0].asnumpy()


def test_sharded_round_trip_and_restore_feeds_the_step(tmp_path):
    """``save_sharded`` writes a committed DCP step directory; a module
    that has already stepped (its program bound to its arrays) restores
    it in place: parameters, aux states and slots bit for bit, and its
    next compiled step lands where the saving module's next step does."""
    args, aux, batches = _values()
    mod = _bound(mt, mt.mod.Module(_sym(mt), context=mt.cpu()), args, aux)
    _train(mt, mod, batches[:2])
    d = str(tmp_path / "ck")
    path = mt.checkpoint.save_sharded(d, 3, mod)
    assert path == os.path.join(d, "3")
    assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp",
                                        "commit_success.txt"]
    assert mt.checkpoint.latest_step(d) == 3
    want = _state(mod)
    assert any(k.startswith("slot:") for k in want)

    oargs, oaux, obatches = _other_values(9)
    other = _bound(mt, mt.mod.Module(_sym(mt), context=mt.cpu()), oargs,
                   oaux)
    _train(mt, other, obatches)
    bound = {n: a.data.data_ptr()
             for n, a in other._exec_group.exec_.arg_dict.items()}
    mt.checkpoint.load_sharded(d, 3, other)
    assert {n: a.data.data_ptr() for n, a in
            other._exec_group.exec_.arg_dict.items()} == bound
    got = _state(other)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _train(mt, mod, batches[2:])
    _train(mt, other, batches[2:])
    want, got = _state(mod), _state(other)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_latest_step_skips_torn_checkpoint(tmp_path):
    """Only the commit marker makes a step directory count: a torn one
    (or one carrying DCP's metadata without the marker) is skipped."""
    args, aux, batches = _values()
    mod = _bound(mt, mt.mod.Module(_sym(mt), context=mt.cpu()), args, aux)
    d = str(tmp_path / "ck")
    mt.checkpoint.save_sharded(d, 3, mod)
    torn = elastic.FaultInjector.torn_checkpoint(d, 9)
    assert not mt.checkpoint.is_committed(d, 9)
    assert mt.checkpoint.latest_step(d) == 3
    mt.checkpoint.commit_step(torn)
    assert mt.checkpoint.latest_step(d) == 9
    os.remove(os.path.join(torn, mt.checkpoint.COMMIT_MARKER))
    with open(os.path.join(torn, ".metadata"), "w") as f:
        f.write("")
    assert not mt.checkpoint.is_committed(d, 9)
    assert mt.checkpoint.latest_step(d) == 3
    # an interrupted write's temporary sibling is not a step either
    os.makedirs(os.path.join(d, "12" + mt.checkpoint.TMP_SUFFIX))
    assert mt.checkpoint.latest_step(d) == 3


def test_slotless_restore_gives_fresh_slots(tmp_path):
    """An inference module's checkpoint (no slots) loaded into a training
    module: the parameters restored, the slots zeroed (not the moments of
    the weights they replaced), training goes on."""
    args, aux, batches = _values()
    infer = mt.mod.Module(_sym(mt), context=mt.cpu())
    infer.bind(data_shapes=[("data", (B, 3, 8, 8))],
               label_shapes=[("softmax_label", (B,))], for_training=False)
    infer.init_params(arg_params={k: mt.nd.array(v) for k, v in
                                  args.items()},
                      aux_params={k: mt.nd.array(v) for k, v in aux.items()})
    want = _params(infer)
    d = str(tmp_path / "ck")
    mt.checkpoint.save_sharded(d, 0, infer)
    oargs, oaux, obatches = _other_values(2)
    trained = _bound(mt, mt.mod.Module(_sym(mt), context=mt.cpu()), oargs,
                     oaux)
    _train(mt, trained, obatches)
    assert any(np.abs(s).max() > 0 for v in _slots(mt, trained).values()
               for s in v)
    mt.checkpoint.load_sharded(d, 0, trained)
    got = _params(trained)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for n, v in _slots(mt, trained).items():
        for s in v:
            assert np.abs(s).max() == 0.0, n
    _train(mt, trained, batches)
    assert all(np.isfinite(v).all() for v in _params(trained).values())


def test_training_checkpoint_into_inference_module(tmp_path):
    """A checkpoint with slots restores into an inference module (its
    slots are not read); the inference forward equals the trained
    module's bit for bit."""
    args, aux, batches = _values()
    mod = _bound(mt, mt.mod.Module(_sym(mt), context=mt.cpu()), args, aux)
    _train(mt, mod, batches)
    d = str(tmp_path / "ck")
    mt.checkpoint.save_sharded(d, 1, mod)
    infer = mt.mod.Module(_sym(mt), context=mt.cpu())
    infer.bind(data_shapes=[("data", (B, 3, 8, 8))],
               label_shapes=[("softmax_label", (B,))], for_training=False)
    infer.init_params(arg_params={k: mt.nd.array(v) for k, v in
                                  args.items()},
                      aux_params={k: mt.nd.array(v) for k, v in aux.items()})
    x = batches[0][0]
    _eval_out(infer, x)                  # its forward program is bound
    mt.checkpoint.load_sharded(d, 1, infer)
    want, got = _params(mod), _params(infer)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(_eval_out(infer, x), _eval_out(mod, x))


def test_load_sharded_refuses_what_it_cannot_restore(tmp_path):
    """No directory, no step (the resume idiom over an empty directory),
    a parameter the checkpoint lacks or of another shape: MXNetError."""
    args, aux, _ = _values()
    mod = _bound(mt, mt.mod.Module(_sym(mt), context=mt.cpu()), args, aux)
    d = str(tmp_path / "nope")
    assert mt.checkpoint.latest_step(d) is None
    with pytest.raises(mt.MXNetError, match="no sharded checkpoint"):
        mt.checkpoint.load_sharded(d, 0, mod)
    with pytest.raises(mt.MXNetError, match="step"):
        mt.checkpoint.load_sharded(d, mt.checkpoint.latest_step(d), mod)
    mt.checkpoint.save_state_tree(d, 5, {"params": {
        "fc_weight": torch.zeros(CLASSES, 4)}})
    with pytest.raises(mt.MXNetError, match="has no params/conv_weight"):
        mt.checkpoint.load_sharded(d, 5, mod)
    mt.checkpoint.save_state_tree(d, 6, {"params": {
        n: torch.zeros(3) for n in mod._exec_group.param_names}})
    with pytest.raises(mt.MXNetError, match="shape"):
        mt.checkpoint.load_sharded(d, 6, mod)
