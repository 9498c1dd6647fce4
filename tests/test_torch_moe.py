"""The port's mixture-of-experts slice on the CPU, against the JAX
package: ``ops/moe.py``'s routing tables, dense and sparse forwards and
the six gradients of ``y + coeff * aux``; the dispatch knob; the
``MoEFFN`` op through the registry (``nd`` under autograd, the knobs
overriding the attributes); the MoE ``attention_lm`` as symbol JSON,
trained through ``Module`` and served through the paged
``DecodeServer``; and the roofline FLOP counts of the op.

The JAX side runs on ``mx.cpu(0)`` as ``tests/test_moe.py`` runs it (the
op has no Pallas kernel).  Tolerances: forwards 1e-5 and gradients 1e-4
relative to each tensor's largest magnitude (f32 on both sides, the
same products summed in other orders); the routing tables (``choice``,
``pos``, ``keep``, ``slot``) exactly.  Module parameters are held on the
training delta, relative to its largest magnitude, within 1e-4 (an
attention ``*_k_bias`` on its layer's ``*_q_bias`` delta, as
``tests/test_torch_train.py`` holds it).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import config as jconfig
from mxnet_tpu import ndarray as jnd
from mxnet_tpu import symbol as jsym
from mxnet_tpu.decode import DecodePredictor as JaxPredictor
from mxnet_tpu.decode import DecodeServer as JaxServer
from mxnet_tpu.io import DataBatch as JBatch
from mxnet_tpu.io import DataDesc as JDesc
from mxnet_tpu.models import attention_lm as jlm
from mxnet_tpu.ops import moe as jmoe

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.decode import DecodePredictor, DecodeServer
from mxnet_tpu_torch.io import DataBatch, DataDesc
from mxnet_tpu_torch.models import attention_lm
from mxnet_tpu_torch.obs.roofline import graph_flops, symbol_shapes
from mxnet_tpu_torch.ops import moe
from mxnet_tpu_torch.weights import params_from_jax, params_to_numpy

torch.set_num_threads(1)

TOL_FWD, TOL_GRAD, TOL_DELTA = 1e-5, 1e-4, 1e-4
N, D, E, H = 48, 8, 4, 12
NAMES = ["data", "moe_gate_weight", "moe_expert1_weight",
         "moe_expert1_bias", "moe_expert2_weight", "moe_expert2_bias"]


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    """Arrays made without a context go to the host: the port's default
    context is the card."""
    with mt.cpu():
        yield


def _inputs(seed, n=N, d=D, e=E, h=H):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(0, 0.5, (d, e)).astype(np.float32),
            rng.normal(0, 0.5, (e, d, h)).astype(np.float32),
            rng.normal(0, 0.1, (e, h)).astype(np.float32),
            rng.normal(0, 0.5, (e, h, d)).astype(np.float32),
            rng.normal(0, 0.1, (e, d)).astype(np.float32)]


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= tol, (what, err)


# (path, k, num_groups, dropless): the dense oracle, the sparse path at
# cf 1.25 with one and four groups, and dropless
CASES = [("dense", 1, 1, False), ("dense", 2, 1, False),
         ("dense", 3, 1, False), ("sparse", 1, 1, False),
         ("sparse", 2, 1, False), ("sparse", 3, 1, False),
         ("sparse", 2, 4, False), ("sparse", 2, 1, True)]
CF = 1.25


def _forwards(path, k, groups, dropless):
    """(the JAX forward, the port's) as functions of the six inputs."""
    if path == "dense":
        return (lambda *a: jmoe._moe_forward(*a, E, num_experts_per_tok=k),
                lambda *a: moe._moe_forward(*a, E, num_experts_per_tok=k))
    return (lambda *a: jmoe._moe_forward_sparse(
                *a, E, CF, num_experts_per_tok=k, num_groups=groups,
                dropless=dropless),
            lambda *a: moe._moe_forward_sparse(
                *a, E, CF, num_experts_per_tok=k, num_groups=groups,
                dropless=dropless))


@pytest.mark.parametrize("path,k,groups,dropless", CASES)
def test_routing_and_forward_match_jax(path, k, groups, dropless):
    """The routing tables exactly, y and the balance loss within 1e-5."""
    import jax.numpy as jnp

    arrays = _inputs(k + 10 * groups)
    x, wg = arrays[0], arrays[1]
    probs = np.exp(x @ wg)
    probs /= probs.sum(-1, keepdims=True)
    jc, jg = jmoe._route(jnp.asarray(probs), k)
    tc, tg = moe._route(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _close(tg.numpy(), jg, TOL_FWD, "gate")
    cap = jmoe._capacity(CF, k, N // groups, E, dropless)
    assert moe._capacity(CF, k, N // groups, E, dropless) == cap
    for g in range(groups):
        rows = slice(g * N // groups, (g + 1) * N // groups)
        want = jmoe._slot_assign(jnp.asarray(jc)[rows], E, cap)
        got = moe._slot_assign(tc[rows], E, cap)
        for name, a, b in zip(("pos", "keep", "slot"), got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    jf, tf = _forwards(path, k, groups, dropless)
    jy, jaux = jf(*arrays)
    ty, taux = tf(*map(torch.from_numpy, arrays))
    _close(ty.numpy(), jy, TOL_FWD, "y")
    _close(taux.numpy(), jaux, TOL_FWD, "aux")
    assert taux.dtype == torch.float32 and ty.shape == (N, D)


@pytest.mark.parametrize("coeff", [0.0, 0.3])
@pytest.mark.parametrize("path,k,groups,dropless",
                         [c for c in CASES if c[1] != 3])
def test_gradients_match_jax(path, k, groups, dropless, coeff):
    """The six gradients of ``y + coeff * aux`` (the JAX op's custom_vjp:
    the vector-Jacobian product of (y, aux) with (dy, coeff)) against
    :class:`moe.MoEFn`'s backward."""
    import jax
    import jax.numpy as jnp

    arrays = _inputs(7 + k)
    dy = np.random.RandomState(99).normal(size=(N, D)).astype(np.float32)
    jf, tf = _forwards(path, k, groups, dropless)
    (_, jaux), vjp = jax.vjp(jf, *map(jnp.asarray, arrays))
    want = vjp((jnp.asarray(dy), jnp.asarray(coeff, jaux.dtype)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = moe.MoEFn.apply(tf, coeff, *ts)
    y.backward(torch.from_numpy(dy))
    for name, t, w in zip(NAMES, ts, want):
        _close(t.grad.numpy(), w, TOL_GRAD, name)


def _jax_dispatch(choice, e, cap):
    import jax.numpy as jnp

    out = {}
    for algo in ("sort", "onehot"):
        with jconfig.overrides(MXNET_MOE_DISPATCH=algo):
            out[algo] = [np.asarray(v) for v in
                         jmoe._slot_assign(jnp.asarray(choice), e, cap)]
    return out


@pytest.mark.parametrize("n,k,e,cap", [(64, 2, 4, 9), (33, 1, 8, 3),
                                       (128, 4, 2, 70), (16, 2, 4, 1),
                                       (24, 1, 4, 30)])
def test_dispatch_sort_equals_onehot(n, k, e, cap):
    """Both algorithms give the same (pos, keep, slot) bit for bit, and
    the JAX package's: overflow, rank priority, single-expert pile-ups
    (the last case routes every token to expert 0)."""
    rng = np.random.RandomState(n + k)
    choice = rng.randint(0, e, size=(n, k)).astype(np.int64)
    if cap == 30:
        choice[:] = 0
    want = _jax_dispatch(choice, e, cap)
    for algo in ("sort", "onehot"):
        with tconfig.overrides(MXNET_MOE_DISPATCH=algo):
            moe.MOE_DISPATCH["last"] = None
            got = moe._slot_assign(torch.from_numpy(choice), e, cap)
            assert moe.MOE_DISPATCH["last"] == algo
        for name, a, b in zip(("pos", "keep", "slot"), got, want[algo]):
            np.testing.assert_array_equal(a.numpy(), b, name)
            assert not a.is_floating_point()
    if cap == 30:
        np.testing.assert_array_equal(got[0][:, 0].numpy(), np.arange(n))


def test_dispatch_invalid_knob_raises():
    with tconfig.overrides(MXNET_MOE_DISPATCH="radix"):
        with pytest.raises(ValueError, match="MXNET_MOE_DISPATCH"):
            moe._slot_assign(torch.zeros((4, 1), dtype=torch.int64), 2, 2)


def test_sparse_module_identical_across_dispatch():
    """A Module's forward and backward of the sparse op (cf 0.2: tokens
    lose both experts) under each algorithm: outputs, input gradients
    and weight gradients bit for bit, as the JAX package asserts."""
    arrays = _inputs(23)
    n, d = arrays[0].shape

    def run(algo):
        with tconfig.overrides(MXNET_MOE_DISPATCH=algo):
            s = mt.sym.MoEFFN(mt.sym.Variable("data"), num_experts=E,
                              hidden_size=H, capacity_factor=0.2,
                              num_experts_per_tok=2, aux_loss_coeff=0.3,
                              name="moe")
            mod = mt.mod.Module(s, context=mt.cpu(), label_names=None)
            mod.bind(data_shapes=[DataDesc("data", (n, d))],
                     for_training=True, inputs_need_grad=True)
            mod.init_params(arg_params=dict(zip(NAMES[1:], arrays[1:])))
            mod.forward(DataBatch([mt.nd.array(arrays[0])], []),
                        is_train=True)
            y = mod.get_outputs()[0].asnumpy()
            mod.backward(out_grads=[mt.nd.ones((n, d))])
            grads = {nm: g.asnumpy() for nm, g in
                     zip(mod._exec_group.param_names,
                         mod._exec_group.grad_arrays)}
            return y, mod.get_input_grads()[0].asnumpy(), grads

    ys, dxs, gs = run("sort")
    yo, dxo, go = run("onehot")
    assert (ys == 0).all(-1).sum() > 0, "capacity never bound"
    np.testing.assert_array_equal(ys, yo)
    np.testing.assert_array_equal(dxs, dxo)
    assert sorted(gs) == sorted(NAMES[1:])
    for nm in gs:
        np.testing.assert_array_equal(gs[nm], go[nm], nm)


def _jax_op_grads(arrays, dy, attrs):
    """The JAX op through its executor: y and the six gradients for head
    gradient ``dy``."""
    s = jsym.MoEFFN(jsym.Variable("data"), name="moe", **attrs)
    ex = s.simple_bind(mx.cpu(), data=arrays[0].shape, grad_req="write")
    for name, val in zip(NAMES, arrays):
        ex.arg_dict[name]._set_data(val)
    ex.forward(is_train=True)
    y = ex.outputs[0].asnumpy()
    ex.backward(out_grads=jnd.array(dy))
    return y, [ex.grad_dict[n].asnumpy() for n in NAMES]


KNOBS = {"MXNET_MOE_TOPK": 2, "MXNET_MOE_CAPACITY": 1.25,
         "MXNET_MOE_DROPLESS": False}


@pytest.mark.parametrize("knobs,path", [
    ({}, "dense"), (KNOBS, "sparse"),
    (dict(KNOBS, MXNET_MOE_DROPLESS=True), "sparse")])
def test_nd_moeffn_under_autograd_matches_jax(knobs, path):
    """``mt.nd.MoEFFN`` (and its alias) recorded under autograd, with the
    knobs overriding the attributes (top-1, dense) as they do in the JAX
    package: y and the six gradients with the aux term at 0.3."""
    arrays = _inputs(31)
    dy = np.random.RandomState(5).normal(size=(N, D)).astype(np.float32)
    attrs = dict(num_experts=E, hidden_size=H, aux_loss_coeff=0.3)
    with jconfig.overrides(**knobs):
        jy, jgrads = _jax_op_grads(arrays, dy, attrs)
    for op in (mt.nd.MoEFFN, mt.nd._contrib_MoEFFN):
        xs = [mt.nd.array(a) for a in arrays]
        gs = [mt.nd.zeros(a.shape) for a in arrays]
        mt.autograd.mark_variables(xs, gs)
        with tconfig.overrides(**knobs):
            with mt.autograd.record():
                y = op(*xs, **attrs)
            assert moe.MOE_PATH["last"] == path
            mt.autograd.backward([y], [mt.nd.array(dy)])
        _close(y.asnumpy(), jy, TOL_FWD, "y")
        for name, g, w in zip(NAMES, gs, jgrads):
            _close(g.asnumpy(), w, TOL_GRAD, name)


LM = dict(vocab_size=32, seq_len=16, num_layers=2, embed=16, heads=2,
          ffn_hidden=32, moe_experts=4, moe_top_k=2)


@pytest.mark.parametrize("cf,top_k", [(0.0, 1), (1.25, 2)])
def test_moe_lm_symbol_json_byte_identical(cf, top_k):
    kw = dict(LM, moe_capacity_factor=cf, moe_top_k=top_k)
    with mx.base.NameManager():
        want = jlm.get_symbol(**kw)
    with mt.NameManager():
        got = attention_lm.get_symbol(**kw)
    assert got.tojson() == want.tojson()
    assert "MoEFFN" in got.tojson()
    t_shapes = got.infer_shape(data=(2, 16), softmax_label=(2, 16))
    j_shapes = want.infer_shape(data=(2, 16), softmax_label=(2, 16))
    assert [list(map(tuple, x)) for x in t_shapes] == \
        [list(map(tuple, x)) for x in j_shapes]


B, T = 2, 16
OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


def _lm_params(kw):
    with mt.NameManager():
        sym = attention_lm.get_symbol(**kw)
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
            v = 0.3 * rng.randn(*shape)
        out[name] = v.astype(np.float32)
    return out


def _lm_batch():
    rng = np.random.RandomState(0)
    x = rng.randint(0, LM["vocab_size"], size=(B, T)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.full((B, 1), -1, np.float32)], axis=1)
    return x, y


@pytest.mark.parametrize("cf", [0.0, 1.25])
def test_moe_lm_trains_through_module_like_jax(cf):
    """The 2-layer MoE LM (4 experts, top-2), 3 SGD-momentum steps
    through ``Module`` in both packages from the same parameters and
    batch: every parameter after each step, the routing path taken."""
    kw = dict(LM, moe_capacity_factor=cf)
    params = _lm_params(kw)
    x, y = _lm_batch()
    dd = JDesc("data", (B, T), layout="NT")
    ld = JDesc("softmax_label", (B, T), layout="NT")
    with jconfig.overrides(MXNET_PALLAS_UPDATE=False):
        with mx.base.NameManager():
            jnet = jlm.get_symbol(**kw)
        jmod = mx.mod.Module(jnet, context=mx.cpu(0),
                             compute_dtype="float32")
        jmod.bind(data_shapes=[dd], label_shapes=[ld])
        jmod.init_params(arg_params={k: jnd.array(v)
                                     for k, v in params.items()},
                         aux_params={})
        jmod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
        jbatch = JBatch([jnd.array(x)], [jnd.array(y)], provide_data=[dd],
                        provide_label=[ld])
        want = []
        for _ in range(3):
            jmod.forward_backward(jbatch)
            jmod.update()
            want.append({k: v.asnumpy()
                         for k, v in jmod.get_params()[0].items()})
    with mt.NameManager():
        tnet = attention_lm.get_symbol(**kw)
    tmod = mt.mod.Module(tnet, context=mt.cpu())
    tmod.bind(data_shapes=[DataDesc("data", (B, T), layout="NT")],
              label_shapes=[DataDesc("softmax_label", (B, T), layout="NT")])
    tmod.init_params(arg_params=params, aux_params={})
    tmod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    assert tmod._train_step is not None
    batch = DataBatch([mt.nd.array(x)], [mt.nd.array(y)])
    moe.MOE_PATH["last"] = None
    for step in range(3):
        tmod.forward_backward(batch)
        tmod.update()
        got = params_to_numpy(tmod.get_params()[0])
        assert set(got) == set(want[step]) == set(params)
        for key in sorted(params):
            d_want = want[step][key] - params[key]
            # the attention *_k_bias gradient is analytically zero (a
            # bias on every key cancels in the softmax): its delta is
            # weight decay plus rounding, held on its layer's *_q_bias
            ref = key[:-len("_k_bias")] + "_q_bias" \
                if key.endswith("_k_bias") else key
            scale = float(np.abs(want[step][ref] - params[ref]).max())
            err = float(np.abs(got[key] - params[key] - d_want).max())
            assert err / scale < TOL_DELTA, (step, key, err / scale)
    assert moe.MOE_PATH["last"] == ("sparse" if cf else "dense")


@pytest.mark.parametrize("cf", [0.0, 1.25])
def test_moe_lm_paged_server_tokens_match_jax(cf):
    """Greedy tokens of a tiny MoE LM (2 layers, 4 experts, top-2)
    through the paged DecodeServer (chunked prefill, a shared prefix,
    slot refills) equal the JAX package's request for request."""
    kw = dict(vocab_size=17, seq_len=T, num_layers=2, embed=16, heads=2,
              ffn_hidden=16, moe_experts=4, moe_top_k=2,
              moe_capacity_factor=cf)
    with mx.base.NameManager():
        jnet = jlm.get_symbol(**kw)
    with mt.NameManager():
        tnet = attention_lm.get_symbol(**kw)
    rng = np.random.RandomState(0)
    shapes, _, _ = jnet.infer_shape(data=(B, T), softmax_label=(B, T))
    params = {n: rng.normal(0, 0.5, s).astype(np.float32)
              for n, s in zip(jnet.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    prefix = rng.randint(0, 17, 7)
    prompts = [np.concatenate([prefix, rng.randint(0, 17, n)])
               for n in (2, 5, 3)] + [rng.randint(0, 17, 6)]
    pkw = dict(paged=True, page_tokens=4, prefill_chunk=4, kv_dtype="int8")
    jsrv = JaxServer(JaxPredictor(jnet, params, cache_len=T, **pkw), 12,
                     slots=2, max_new_tokens=6)
    tsrv = DecodeServer(DecodePredictor(
        tnet, params_from_jax(params, device="cpu"), cache_len=T,
        device="cpu", **pkw), 12, slots=2, max_new_tokens=6)
    for p in prompts:
        jsrv.submit(p)
        tsrv.submit(p)
    moe.MOE_PATH["last"] = None
    want, got = jsrv.run(), tsrv.run()
    assert moe.MOE_PATH["last"] == ("sparse" if cf else "dense")
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("cf,top_k,dropless", [(0.0, 2, False),
                                               (1.25, 2, False),
                                               (1.25, 1, True)])
def test_moe_flops(cf, top_k, dropless):
    """graph_flops and the serving programs' FLOPs count the router,
    2*N*d*E, and the expert products of the path taken: E * 4*N*d*h on
    the dense path, 4*(E*cap)*d*h on the sparse one."""
    n, d, e, h = 64, 16, 4, 24
    s = mt.sym.MoEFFN(mt.sym.Variable("data"), num_experts=e, hidden_size=h,
                      capacity_factor=cf, num_experts_per_tok=top_k,
                      overflow="dropless" if dropless else "drop",
                      name="moe")
    router = 2 * n * d * e
    if cf == 0:
        experts = e * 4 * n * d * h
    else:
        cap = n * top_k if dropless else int(np.ceil(cf * top_k * n / e))
        experts = 4 * e * cap * d * h
    assert graph_flops(s, symbol_shapes(s, data=(n, d))) \
        == router + experts
    node = s._outputs[0][0]
    assert moe.moe_flops(node.parsed_attrs(), n, d) == router + experts


def test_serving_flops_count_moe():
    """A MoE LM's decode step FLOPs: the non-MoE layers' products and
    attention plus each MoEFFN's router and experts over the slots."""
    kw = dict(vocab_size=17, seq_len=T, num_layers=2, embed=16, heads=2,
              ffn_hidden=16, moe_experts=4, moe_top_k=2,
              moe_capacity_factor=1.25)
    with mt.NameManager():
        sym = attention_lm.get_symbol(**kw)
    dense_kw = dict(kw, moe_experts=0)
    with mt.NameManager():
        dense = attention_lm.get_symbol(**dense_kw)
    rng = np.random.RandomState(0)

    def predictor(s):
        shapes, _, _ = s.infer_shape(data=(B, T), softmax_label=(B, T))
        params = {n: rng.normal(0, 0.5, sh).astype(np.float32)
                  for n, sh in zip(s.list_arguments(), shapes)
                  if n not in ("data", "softmax_label")}
        return DecodePredictor(s, params, cache_len=T, device="cpu",
                               paged=True, page_tokens=4)

    rows = 4
    got = predictor(sym)._serving_flops(rows)
    # the dense FFN's two products, 2 * 2*rows*16*16 a layer, give way
    # to the router and the sparse experts (cap = ceil(1.25*2*4/4) = 3)
    ffn = 2 * (2 * rows * 16 * 16)
    router, experts = 2 * rows * 16 * 4, 4 * (4 * 3) * 16 * 16
    want = predictor(dense)._serving_flops(rows) \
        + 2 * (router + experts - ffn)
    assert got == want
