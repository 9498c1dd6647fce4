"""The PyTorch port's ``BucketingModule`` held against the JAX package's
on the CPU: shared binding across buckets, the bucketed LSTM language
model trained through one slab plan, and the reference's demotion of
buckets whose parameters are not all shared.

The JAX side runs its per-parameter update chain
(``MXNET_PALLAS_UPDATE=False``); the port's slab plan takes kernel B1's
plain version on the CPU.  Tolerances: per-step outputs (softmax
probabilities) 1e-5 absolute; the parameters after 6 steps 1e-5 under
SGD and 1e-4 under Adam, whose update divides by sqrt(v) + eps and so
magnifies an f32 rounding difference of the gradient where v is small.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import config
from mxnet_tpu.io import DataBatch as JBatch
from mxnet_tpu.io import DataDesc as JDesc
from mxnet_tpu.models import lstm_lm as jlm

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import train_step
from mxnet_tpu_torch.io import DataBatch, DataDesc
from mxnet_tpu_torch.models import lstm_lm
from mxnet_tpu_torch.ops import update_kernel as uk
from mxnet_tpu_torch.weights import params_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    """Arrays made without a context go to the host: the port's default
    context is the card."""
    with mt.cpu():
        yield


torch.set_num_threads(1)

VOCAB, EMBED, HIDDEN, LAYERS, BATCH = 20, 8, 8, 2, 4
BUCKETS = [4, 8]
STEPS = 6
TOL_OUT = 1e-5
TOL_PARAM = {"sgd": 1e-5, "adam": 1e-4}
OPTIMIZERS = {"sgd": {"learning_rate": 0.1},
              "adam": {"learning_rate": 0.01}}


def _sentences():
    rng = np.random.RandomState(0)
    return [rng.randint(1, VOCAB, size=rng.randint(2, 9)).tolist()
            for _ in range(40)]


def _init_params(fused):
    sym_gen, _ = lstm_lm.sym_gen_factory(HIDDEN, LAYERS, EMBED, VOCAB,
                                         fused=fused, ignore_label=-1)
    sym = sym_gen(max(BUCKETS))[0]
    shapes, _, _ = sym.infer_shape(data=(BATCH, max(BUCKETS)),
                                   softmax_label=(BATCH, max(BUCKETS)))
    rng = np.random.RandomState(1)
    return {n: (0.3 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _jax_sym_gen(fused):
    sym_gen, _ = jlm.sym_gen_factory(HIDDEN, LAYERS, EMBED, VOCAB,
                                     fused=fused)

    def padded(seq_len):
        # the port's ignore_label=-1: the same head with use_ignore
        sym, data_names, label_names = sym_gen(seq_len)
        internals = sym.get_internals()
        pred = internals["pred_output"]
        label = mx.sym.Reshape(mx.sym.Variable("softmax_label"),
                               shape=(-1,))
        return (mx.sym.SoftmaxOutput(pred, label, use_ignore=True,
                                     ignore_label=-1, name="softmax"),
                data_names, label_names)

    return padded


def _jax_fit(params, fused, optimizer):
    it = mx.rnn.BucketSentenceIter(_sentences(), BATCH, buckets=BUCKETS,
                                   seed=0)
    with config.overrides(MXNET_PALLAS_UPDATE=False):
        mod = mx.mod.BucketingModule(_jax_sym_gen(fused),
                                     default_bucket_key=max(BUCKETS),
                                     context=mx.cpu())
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in params.items()},
                        aux_params={})
        mod.init_optimizer(optimizer=optimizer,
                           optimizer_params=OPTIMIZERS[optimizer])
        keys, outs = [], []
        for _, batch in zip(range(STEPS), it):
            mod.forward_backward(batch)
            mod.update()
            keys.append(batch.bucket_key)
            outs.append(mod.get_outputs()[0].asnumpy())
        trained = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return keys, outs, trained


@pytest.fixture(scope="module")
def reference():
    runs = {}
    for fused in (False, True):
        params = _init_params(fused)
        for optimizer in OPTIMIZERS:
            runs[fused, optimizer] = (params,) + _jax_fit(params, fused,
                                                          optimizer)
    return runs


def _port_module(fused, optimizer, params):
    sym_gen, _ = lstm_lm.sym_gen_factory(HIDDEN, LAYERS, EMBED, VOCAB,
                                         fused=fused, ignore_label=-1)
    it = mt.rnn.BucketSentenceIter(_sentences(), BATCH, buckets=BUCKETS,
                                   seed=0)
    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=max(BUCKETS),
                                 context=mt.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=params, aux_params={})
    mod.init_optimizer(optimizer=optimizer,
                       optimizer_params=OPTIMIZERS[optimizer])
    return mod, it


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
@pytest.mark.parametrize("fused", [False, True])
def test_bucketed_lstm_lm_matches_jax(reference, fused, optimizer):
    """6 steps over buckets 4 and 8 of the tiny LSTM LM (unfused
    ``LSTMCell`` stack or ``FusedRNNCell``), from the same weights: the
    same bucket order, every step's outputs, the final parameters."""
    params, want_keys, want_outs, want = reference[fused, optimizer]
    mod, it = _port_module(fused, optimizer, params)
    keys = []
    for _, batch in zip(range(STEPS), it):
        mod.forward_backward(batch)
        mod.update()
        keys.append(batch.bucket_key)
        np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(),
                                   want_outs[len(keys) - 1], rtol=0,
                                   atol=TOL_OUT)
    assert keys == want_keys and set(keys) == set(BUCKETS)
    assert uk.UPDATE_PATH["last"] == "plain"
    got = params_to_numpy(mod.get_params()[0])
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=TOL_PARAM[optimizer], err_msg=name)


def test_one_slab_plan_serves_every_bucket(monkeypatch):
    """The slab plan is armed once, every bucket borrows the primary's
    train step and shares its slab views by storage, and each step runs
    exactly one update over the shared slabs."""
    arms, updates = [], []
    real_arm, real_plain = train_step.CompiledTrainStep._arm, uk.update_plain

    def arm(self, plan):
        arms.append(plan)
        return real_arm(self, plan)

    def plain(*args):
        updates.append(args[0])
        return real_plain(*args)

    monkeypatch.setattr(train_step.CompiledTrainStep, "_arm", arm)
    monkeypatch.setattr(uk, "update_plain", plain)
    mod, it = _port_module(False, "adam", _init_params(False))
    for _, batch in zip(range(STEPS), it):
        mod.forward_backward(batch)
        mod.update()
    step = mod._primary._train_step
    assert len(arms) == 1 and step.plan is not None
    assert updates == ["adam"] * STEPS
    assert mod._primary._optimizer.num_update == STEPS
    assert set(mod._buckets) == set(BUCKETS)
    views = step.plan.unpack_all(step._w)
    grads = step.plan.unpack_all(step._g)
    for module in mod._buckets.values():
        assert module._train_step is step
        exe = module._exec_group.exec_
        for name, view in views.items():
            assert exe.arg_dict[name].data.data_ptr() == view.data_ptr()
            assert exe.grad_dict[name].data.data_ptr() == \
                grads[name].data_ptr()


def _fc_sym_gen(pkg):
    def sym_gen(seq_len):
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4,
                                     name="fc")
        return (pkg.sym.SoftmaxOutput(net, name="softmax"), ("data",),
                ("softmax_label",))

    return sym_gen


def test_shape_varying_parameter_demotes_every_bucket():
    """``tests/test_module.py``'s bucketing case (buckets 10 / 6 / 10 of
    an FC whose weight width follows the bucket): ``fc_bias`` is shared
    by identity, bucket 6 gets its own ``fc_weight``, and — as in the
    reference — that sends every bucket to the per-parameter update.
    Outputs and the shared bias match the JAX package's."""
    rng = np.random.RandomState(2)
    params = {"fc_weight": rng.randn(4, 10).astype(np.float32) * 0.1,
              "fc_bias": rng.randn(4).astype(np.float32) * 0.1}
    batches = [(key, rng.randn(4, key).astype(np.float32),
                rng.randint(0, 4, 4).astype(np.float32))
               for key in (10, 6, 10)]

    jmod = mx.mod.BucketingModule(_fc_sym_gen(mx), default_bucket_key=10,
                                  context=mx.cpu())
    jmod.bind(data_shapes=[JDesc("data", (4, 10))],
              label_shapes=[JDesc("softmax_label", (4,))])
    jmod.init_params(arg_params={k: mx.nd.array(v)
                                 for k, v in params.items()})
    jmod.init_optimizer(optimizer="sgd")
    tmod = mt.mod.BucketingModule(_fc_sym_gen(mt), default_bucket_key=10,
                                  context=mt.cpu())
    tmod.bind(data_shapes=[DataDesc("data", (4, 10))],
              label_shapes=[DataDesc("softmax_label", (4,))])
    tmod.init_params(arg_params=params)
    tmod.init_optimizer(optimizer="sgd")
    assert tmod._primary._train_step.plan is not None
    for key, x, y in batches:
        jmod.forward_backward(JBatch(
            [mx.nd.array(x)], [mx.nd.array(y)], bucket_key=key,
            provide_data=[JDesc("data", (4, key))],
            provide_label=[JDesc("softmax_label", (4,))]))
        jmod.update()
        tmod.forward_backward(DataBatch(
            [mt.nd.array(x)], [mt.nd.array(y)], bucket_key=key,
            provide_data=[DataDesc("data", (4, key))],
            provide_label=[DataDesc("softmax_label", (4,))]))
        tmod.update()
        np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                                   jmod.get_outputs()[0].asnumpy(), rtol=0,
                                   atol=TOL_OUT)
    assert set(tmod._buckets) == {10, 6}
    b10 = tmod._buckets[10]._exec_group.exec_.arg_dict
    b6 = tmod._buckets[6]._exec_group.exec_.arg_dict
    assert b10["fc_bias"] is b6["fc_bias"]
    assert b10["fc_weight"] is not b6["fc_weight"]
    assert all(m._train_step is None for m in tmod._buckets.values())
    assert all(m._fused_step is None for m in jmod._buckets.values())
    np.testing.assert_allclose(b10["fc_bias"].asnumpy(),
                               jmod.get_params()[0]["fc_bias"].asnumpy(),
                               rtol=0, atol=TOL_OUT)
