"""The PyTorch port's training path — ``Module`` over ``attention_lm`` —
held against the JAX package's ``Module`` on the same numpy parameters
and batch.

The JAX side runs its fused LN->linear and flash-attention Pallas
kernels in interpret mode (``MXNET_PALLAS_FUSED/ATTENTION/INTERPRET``;
the multi-tensor update stays off, the per-parameter XLA path) and the
tripwires assert that it did.  The port runs on the CPU, so every op
takes its kernel's plain version (``FUSED_PATH`` / ``PATH_TAKEN`` read
"plain").  Sizes clear the JAX gates: B*T = 256 (``pallas_fused``'s
m % 256) and head dim 64 (``pallas_attention``'s hd % 64).

Tolerances: outputs (softmax probabilities, O(1/V)) to 1e-5 absolute —
both sides are f32 and differ only in summation order.  Parameters are
compared on the training delta (after - before), relative to the
largest |delta| of that parameter, within 1e-5: two momentum steps chain
the f32 rounding of every product through the whole backward (measured
up to 9e-7).  The attention ``*_k_bias`` gradient is analytically zero
(a bias added to every key cancels in the softmax), so its delta is
weight decay plus rounding noise on both sides; it is compared on the
scale of the same layer's ``*_q_bias`` delta instead
(tests/test_fused_lm.py explains the same).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import config
from mxnet_tpu import ndarray as jnd
from mxnet_tpu.io import DataBatch as JBatch
from mxnet_tpu.io import DataDesc as JDesc
from mxnet_tpu.models import attention_lm as jlm
from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops import fused_lm as jfused_lm

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.io import DataBatch, DataDesc, NDArrayIter
from mxnet_tpu_torch.models import attention_lm
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import fused_lm
from mxnet_tpu_torch.weights import params_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    """Arrays made without a context go to the host: the port's default
    context is the card."""
    with mt.cpu():
        yield


torch.set_num_threads(1)

B, T, VOCAB, EMBED, HEADS, FFN, LAYERS = 2, 128, 32, 128, 2, 256, 1
LR = 0.05
OPT = {"learning_rate": LR, "momentum": 0.9, "wd": 1e-4}
TOL_OUT = 1e-5
TOL_DELTA = 1e-5


def _data():
    rng = np.random.RandomState(0)
    x = rng.randint(0, VOCAB, size=(B, T)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.full((B, 1), -1, np.float32)], axis=1)
    return x, y


def _init_params():
    """Seeded numpy parameters of the LM (LN gamma near 1, small
    weights), the same for both packages."""
    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=T,
                                  num_layers=LAYERS, embed=EMBED,
                                  heads=HEADS, ffn_hidden=FFN)
    shapes, _, _ = sym.infer_shape(data=(B, T), softmax_label=(B, T))
    rng = np.random.RandomState(1)
    out = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name.endswith("_beta") or name.endswith("_bias"):
            v = 0.05 * rng.randn(*shape)
        else:
            v = 0.08 * rng.randn(*shape)
        out[name] = v.astype(np.float32)
    return out


def _jax_run(params, steps):
    """The JAX Module: outputs of the first forward_backward and the
    parameters after ``steps`` forward_backward + update."""
    x, y = _data()
    dd = JDesc("data", (B, T), layout="NT")
    ld = JDesc("softmax_label", (B, T), layout="NT")
    batch = JBatch([jnd.array(x)], [jnd.array(y)], provide_data=[dd],
                   provide_label=[ld])
    with config.overrides(MXNET_PALLAS_FUSED=True,
                          MXNET_PALLAS_ATTENTION=True,
                          MXNET_PALLAS_INTERPRET=True,
                          MXNET_PALLAS_UPDATE=False):
        net = jlm.get_symbol(vocab_size=VOCAB, seq_len=T,
                             num_layers=LAYERS, embed=EMBED, heads=HEADS,
                             ffn_hidden=FFN)
        mod = mx.mod.Module(net, context=mx.cpu(), compute_dtype="float32")
        mod.bind(data_shapes=[dd], label_shapes=[ld])
        mod.init_params(arg_params={k: jnd.array(v)
                                    for k, v in params.items()},
                        aux_params={})
        mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
        jfused_lm.FUSED_PATH["last"] = None
        jattn.PATH_TAKEN["last"] = None
        out = None
        for _ in range(steps):
            mod.forward_backward(batch)
            mod.update()
            if out is None:
                out = mod.get_outputs()[0].asnumpy()
        # the reference really ran its kernels
        assert jfused_lm.FUSED_PATH["last"] == "pallas"
        assert jattn.PATH_TAKEN["last"] == "flash"
        trained = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return out, trained


@pytest.fixture(scope="module")
def reference():
    params = _init_params()
    out, trained = _jax_run(params, 2)
    return params, out, trained


def _module(params, optimizer=True):
    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=T,
                                  num_layers=LAYERS, embed=EMBED,
                                  heads=HEADS, ffn_hidden=FFN)
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(data_shapes=[DataDesc("data", (B, T), layout="NT")],
             label_shapes=[DataDesc("softmax_label", (B, T), layout="NT")])
    mod.init_params(arg_params=params, aux_params={})
    if optimizer:
        mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    return mod


def _batch():
    x, y = _data()
    return DataBatch([mt.nd.array(x)], [mt.nd.array(y)])


def _assert_params(params, want, got):
    assert set(want) == set(got) == set(params)
    for key in sorted(want):
        d_want = want[key] - params[key]
        d_got = got[key] - params[key]
        ref = key[:-len("_k_bias")] + "_q_bias" \
            if key.endswith("_k_bias") else key
        scale = float(np.max(np.abs(want[ref] - params[ref])))
        err = float(np.max(np.abs(d_got - d_want))) / scale
        assert err < TOL_DELTA, (key, err, scale)


def test_train_step_matches_jax_module(reference):
    """forward_backward (the whole train step) + update, twice: the
    first step's outputs and every parameter after both steps."""
    params, want_out, want = reference
    mod = _module(params)
    batch = _batch()
    fused_lm.FUSED_PATH["last"] = None
    tattn.PATH_TAKEN["last"] = None
    mod.forward_backward(batch)
    mod.update()
    out = mod.get_outputs()[0].asnumpy()
    assert fused_lm.FUSED_PATH["last"] == "plain"
    assert tattn.PATH_TAKEN["last"] == "plain"
    assert out.shape == (B * T, VOCAB)
    np.testing.assert_allclose(out, want_out, rtol=0, atol=TOL_OUT)
    mod.forward_backward(batch)
    mod.update()
    _assert_params(params, want, params_to_numpy(mod.get_params()[0]))


def test_eager_path_matches_jax_module(reference):
    """forward / backward / update through the Updater: the same numbers
    as the train step."""
    params, want_out, want = reference
    mod = _module(params)
    batch = _batch()
    for step in range(2):
        mod.forward(batch, is_train=True)
        if step == 0:
            np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(),
                                       want_out, rtol=0, atol=TOL_OUT)
        mod.backward()
        mod.update()
    _assert_params(params, want, params_to_numpy(mod.get_params()[0]))


def test_fit_score_and_metrics():
    """fit over an NDArrayIter lowers the loss on repeated data; score
    returns the metric; the CPU module never needs a card."""
    params = _init_params()
    x, y = _data()
    it = NDArrayIter(np.concatenate([x, x]), np.concatenate([y, y]),
                     batch_size=B)
    mod = _module(params, optimizer=False)
    before = dict(mod.score(it, mt.metric.Perplexity(ignore_label=-1)))
    mod.fit(it, eval_metric=mt.metric.Perplexity(ignore_label=-1),
            optimizer="sgd", optimizer_params={"learning_rate": 0.002},
            num_epoch=2)
    after = dict(mod.score(it, mt.metric.Perplexity(ignore_label=-1)))
    assert after["Perplexity"] < before["Perplexity"]
    ce = dict(mod.score(it, "ce"))
    assert np.isfinite(ce["cross-entropy"]) and ce["cross-entropy"] > 0


def test_module_refuses_a_missing_card():
    """No context means the card: without one, Module raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default context is valid")
    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=T,
                                  num_layers=LAYERS, embed=EMBED,
                                  heads=HEADS, ffn_hidden=FFN)
    with pytest.raises(mt.MXNetError, match="device='cpu'"):
        mt.mod.Module(sym)


def test_bf16_compute_dtype_tracks_jax():
    """``compute_dtype="bfloat16"``: the cast rule of the JAX train step
    (floating params and data cast, labels kept, f32 masters updated).
    The vocabulary (32) keeps token ids exact in bf16.  Both sides round
    to bf16 at different places (XLA fuses elementwise chains in f32,
    PyTorch rounds every op's output), so the tolerances are bf16-sized:
    outputs 2^-6 absolute, one step's parameter delta 0.1 of its largest
    |delta| (measured up to 0.08), masters stay f32."""
    params = _init_params()
    x, y = _data()
    dd = JDesc("data", (B, T), layout="NT")
    ld = JDesc("softmax_label", (B, T), layout="NT")
    sgd = {"learning_rate": LR}
    with config.overrides(MXNET_PALLAS_FUSED=True,
                          MXNET_PALLAS_ATTENTION=True,
                          MXNET_PALLAS_INTERPRET=True,
                          MXNET_PALLAS_UPDATE=False):
        net = jlm.get_symbol(vocab_size=VOCAB, seq_len=T,
                             num_layers=LAYERS, embed=EMBED, heads=HEADS,
                             ffn_hidden=FFN)
        jmod = mx.mod.Module(net, context=mx.cpu(), compute_dtype="bfloat16")
        jmod.bind(data_shapes=[dd], label_shapes=[ld])
        jmod.init_params(arg_params={k: jnd.array(v)
                                     for k, v in params.items()},
                         aux_params={})
        jmod.init_optimizer(optimizer="sgd", optimizer_params=sgd)
        jmod.forward_backward(JBatch([jnd.array(x)], [jnd.array(y)],
                                     provide_data=[dd], provide_label=[ld]))
        jmod.update()
        want_out = np.asarray(jmod.get_outputs()[0].asnumpy(), np.float32)
        want = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=T,
                                  num_layers=LAYERS, embed=EMBED,
                                  heads=HEADS, ffn_hidden=FFN)
    mod = mt.mod.Module(sym, context=mt.cpu(), compute_dtype="bfloat16")
    mod.bind(data_shapes=[DataDesc("data", (B, T))],
             label_shapes=[DataDesc("softmax_label", (B, T))])
    mod.init_params(arg_params=params, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=sgd)
    mod.forward_backward(_batch())
    mod.update()
    out = mod.get_outputs()[0]
    assert out.data.dtype == torch.bfloat16
    np.testing.assert_allclose(out.asnumpy(), want_out, rtol=0,
                               atol=2 ** -6)
    got = mod.get_params()[0]
    assert all(v.data.dtype == torch.float32 for v in got.values())
    got = params_to_numpy(got)
    for key in sorted(want):
        ref = key[:-len("_k_bias")] + "_q_bias" \
            if key.endswith("_k_bias") else key
        scale = float(np.max(np.abs(want[ref] - params[ref])))
        err = float(np.max(np.abs(got[key] - want[key]))) / scale
        assert err < 0.1, (key, err)


def test_fixed_params_take_no_update():
    """``fixed_param_names`` bind with grad_req "null": the train step
    leaves them as they were and updates the rest."""
    params = _init_params()
    sym = attention_lm.get_symbol(vocab_size=VOCAB, seq_len=T,
                                  num_layers=LAYERS, embed=EMBED,
                                  heads=HEADS, ffn_hidden=FFN)
    mod = mt.mod.Module(sym, context=mt.cpu(),
                        fixed_param_names=["pos_embed_weight"])
    mod.bind(data_shapes=[DataDesc("data", (B, T))],
             label_shapes=[DataDesc("softmax_label", (B, T))])
    mod.init_params(arg_params=params, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    mod.forward_backward(_batch())
    mod.update()
    got = params_to_numpy(mod.get_params()[0])
    np.testing.assert_array_equal(got["pos_embed_weight"],
                                  params["pos_embed_weight"])
    assert not np.array_equal(got["embed_weight"], params["embed_weight"])
