"""Kernel B1's plan and plain version (``mxnet_tpu_torch.ops.
update_kernel``), the optimizers' host-side hyperparameters and the
train step's slab plan, held against the JAX package.

* The slab layout must equal ``mxnet_tpu.ops.pallas_update``'s
  (``_segments_for``, ``UpdatePlan.rows``, ``lr_wd_blocks``), which run
  on the CPU with this jax although ``_bucket_call`` does not
  (``pltpu.TPUCompilerParams`` is gone).
* ``update_plain`` against ``_update_math`` (run op by op, outside
  ``jit``): bitwise for SGD and SGD-momentum, whose chains are products
  and sums that both sides round once each.  Adam within one f32 ulp:
  XLA:CPU's square root is not correctly rounded (655 of 100,000 random
  f32 square roots differ from torch's and numpy's by one ulp), and one
  ulp of sqrt moves the quotient by at most about one ulp.
* The train step with the plan armed, mixed with eager ``update()``
  steps, against the JAX ``Module`` on its per-parameter path
  (its ``MXNET_PALLAS_UPDATE`` off): outputs 1e-5 absolute, every
  parameter's 3-step delta 1e-5 of its largest |delta| (f32 rounding in
  summation order; measured below 2e-6).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import config as jconfig
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import ndarray as jnd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.io import DataBatch as JBatch
from mxnet_tpu.io import DataDesc as JDesc
from mxnet_tpu.ops import pallas_update as pu

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.io import DataBatch, DataDesc
from mxnet_tpu_torch.ops import update_kernel as uk
from mxnet_tpu_torch.weights import params_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    """Arrays made without a context go to the host: the port's default
    context is the card."""
    with mt.cpu():
        yield


torch.set_num_threads(1)

SHAPES = {"a_weight": (3, 700), "a_bias": (7,), "b_weight": (64, 3, 3, 3),
          "b_gamma": (2049,), "c_weight": (1,), "d_weight": (4096,)}
DTYPES = {"a_weight": "float32", "a_bias": "float32", "b_weight": "bfloat16",
          "b_gamma": "float32", "c_weight": "bfloat16", "d_weight": "float32"}
TOL_OUT, TOL_DELTA = 1e-5, 1e-5


def test_plan_layout_matches_jax():
    """Segments, bucket rows and per-block lr / wd equal the JAX
    package's for a mixed f32 / bf16 parameter set."""
    tparams = {n: torch.zeros(s, dtype=getattr(torch, DTYPES[n]))
               for n, s in SHAPES.items()}
    jsds = {n: jax.ShapeDtypeStruct(s, jnp.dtype(DTYPES[n]))
            for n, s in SHAPES.items()}
    tsegs = uk._segments_for(tparams)
    jsegs = pu._segments_for(jsds)
    assert list(tsegs) == list(jsegs) == ["float32", "bfloat16"]
    for bk in jsegs:
        got = [(s.name, s.shape, s.size, s.row0, s.nblocks)
               for s in tsegs[bk]]
        want = [(s.name, s.shape, s.size, s.row0, s.nblocks)
                for s in jsegs[bk]]
        assert got == want
    tplan = uk.UpdatePlan("sgd", 1, tsegs, torch.bfloat16)
    jplan = pu.UpdatePlan("sgd", 1, jsegs, jnp.bfloat16, True)
    lrs = {n: 0.01 * (i + 1) for i, n in enumerate(SHAPES)}
    wds = {n: 1e-4 * i for i, n in enumerate(SHAPES)}
    tl, tw = tplan.lr_wd_blocks(lrs, wds)
    jl, jw = jplan.lr_wd_blocks(lrs, wds)
    for bk in jsegs:
        assert tplan.rows(bk) == jplan.rows(bk)
        assert tplan.has_wc(bk) == jplan.has_wc(bk)
        np.testing.assert_array_equal(tl[bk], jl[bk])
        np.testing.assert_array_equal(tw[bk], jw[bk])


def test_pack_unpack_round_trip_and_views():
    """pack pads with zeros, unpack returns views of the slab's storage,
    and pack_slots keeps the master dtype."""
    g = torch.Generator().manual_seed(0)
    params = {n: torch.randn(s, generator=g).to(getattr(torch, DTYPES[n]))
              for n, s in SHAPES.items()}
    plan = uk.UpdatePlan("adam", 2, uk._segments_for(params), None)
    slabs = plan.pack(params, torch.device("cpu"))
    views = plan.unpack_all(slabs)
    for n, v in params.items():
        assert torch.equal(views[n], v)
        bk = DTYPES[n]
        assert views[n].untyped_storage().data_ptr() == \
            slabs[bk].untyped_storage().data_ptr()
    for bk, slab in slabs.items():
        live = sum(s.size for s in plan.buckets[bk])
        assert int((slab != 0).sum()) <= live
        assert slab.shape == (plan.rows(bk), uk.LANES)
    slots = plan.pack_slots({n: (v, v * 2) for n, v in params.items()},
                            torch.device("cpu"))
    back = plan.unpack_slots(slots)
    for n, v in params.items():
        assert back[n][1].dtype == v.dtype
        assert torch.equal(back[n][1], v * 2)


def _math_case(kind, nslots, master, seed, rows=48):
    rng = np.random.RandomState(seed)
    tdt = getattr(torch, master)
    w = torch.from_numpy(rng.randn(rows, 128).astype(np.float32)).to(tdt)
    g = torch.from_numpy((0.05 * rng.randn(rows, 128)).astype(np.float32))
    slots = [torch.from_numpy((0.01 * rng.randn(rows, 128)).astype(
        np.float32)).to(tdt) for _ in range(nslots)]
    if kind == "adam":
        slots[1] = slots[1].abs()
    nb = rows // uk.BLOCK_ROWS
    lrb = torch.from_numpy((0.1 * rng.rand(nb)).astype(np.float32))
    wdb = torch.from_numpy((1e-3 * rng.rand(nb)).astype(np.float32))
    return w, g, slots, lrb, wdb


@pytest.mark.parametrize("kind,nslots", [("sgd", 0), ("sgd", 1),
                                         ("adam", 2)])
@pytest.mark.parametrize("master,wc", [("float32", None),
                                       ("float32", "bfloat16"),
                                       ("bfloat16", None)])
@pytest.mark.parametrize("clip", [-1.0, 0.02])
def test_update_plain_matches_update_math(kind, nslots, master, wc, clip):
    w, g, slots, lrb, wdb = _math_case(kind, nslots, master, nslots)
    hyp = [0.5, clip, 0.9] if kind == "sgd" else [0.5, clip, 0.9, 0.999,
                                                    1e-8]
    # the JAX chain on the same values, widened to f32 as its kernel does;
    # on copies, since jax may alias a numpy buffer that the in-place
    # update below writes, and it runs asynchronously
    per_elem = np.repeat(lrb.numpy(), uk.BLOCK).reshape(w.shape)
    wd_elem = np.repeat(wdb.numpy(), uk.BLOCK).reshape(w.shape)
    jw, js = jax.block_until_ready(pu._update_math(
        kind, nslots, jnp.array(w.float().numpy(), copy=True),
        jnp.asarray(g.numpy().copy()),
        tuple(jnp.array(s.float().numpy(), copy=True) for s in slots),
        jnp.asarray(per_elem), jnp.asarray(wd_elem),
        tuple(jnp.float32(h) for h in hyp)))
    wcs = None if wc is None else torch.empty(w.shape,
                                              dtype=getattr(torch, wc))
    path = uk.multi_tensor_update(kind, nslots, w, g, slots, wcs, lrb, wdb,
                                  hyp)
    assert path == "plain"

    def stored(x, dtype):
        return np.asarray(jnp.asarray(x).astype(jnp.dtype(dtype)).astype(
            jnp.float32))

    pairs = [(w, stored(jw, master))]
    pairs += [(s, stored(j, master)) for s, j in zip(slots, js)]
    if wc is not None:
        pairs.append((wcs, stored(jw, wc)))
    for got, want in pairs:
        got = got.float().numpy()
        if kind == "sgd":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)


def test_adam_folded_lr_matches_jax():
    """Adam's fused_hyper folds the bias correction into lr at each
    parameter's true update count, as the JAX package's does, with
    per-name lr / wd multipliers and uneven counts."""
    names = {0: "fc_weight", 1: "fc_bias", 2: "bn_gamma"}
    kw = dict(learning_rate=0.003, wd=1e-3, rescale_grad=0.25,
              clip_gradient=2.0, param_idx2name=names)
    mine, ref = topt.Adam(**kw), jopt.Adam(**kw)
    for o in (mine, ref):
        o.set_lr_mult({"fc_bias": 2.0})
        o.set_wd_mult({})
    for indices in ([0, 1, 2], [0, 2], [0, 1, 2], [1]):
        got = mine.fused_hyper(indices)
        want = ref.fused_hyper(indices)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.fused_extra(), ref.fused_extra())


def test_schedulers_match_jax():
    cases = [(tsched.FactorScheduler(step=3, factor=0.5),
              jsched.FactorScheduler(step=3, factor=0.5)),
             (tsched.MultiFactorScheduler(step=[2, 5], factor=0.1),
              jsched.MultiFactorScheduler(step=[2, 5], factor=0.1)),
             (tsched.WarmupScheduler(tsched.CosineScheduler(10), 3),
              jsched.WarmupScheduler(jsched.CosineScheduler(10), 3)),
             (tsched.PolyScheduler(8, power=2.0),
              jsched.PolyScheduler(8, power=2.0))]
    for mine, ref in cases:
        mine.base_lr = ref.base_lr = 0.4
        assert [mine(t) for t in range(12)] == [ref(t) for t in range(12)]


def _mlp():
    # fc1 has no bias: BatchNorm cancels a bias before it, so its gradient
    # would be rounding noise
    data = mt.sym.Variable("data")
    h = mt.sym.FullyConnected(data, num_hidden=32, no_bias=True,
                              name="fc1")
    h = mt.sym.BatchNorm(h, fix_gamma=False, name="bn1")
    h = mt.sym.Activation(h, act_type="relu", name="relu1")
    h = mt.sym.FullyConnected(h, num_hidden=10, name="fc2")
    return mt.sym.SoftmaxOutput(h, name="softmax")


def _jmlp():
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=32, no_bias=True,
                              name="fc1")
    h = mx.sym.BatchNorm(h, fix_gamma=False, name="bn1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    h = mx.sym.FullyConnected(h, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


B, D = 8, 20


def _mlp_values():
    rng = np.random.RandomState(3)
    sym = _mlp()
    shapes, _, aux_shapes = sym.infer_shape(data=(B, D),
                                            softmax_label=(B,))
    args = {}
    for n, s in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        base = 1.0 if n.endswith("_gamma") else 0.0
        args[n] = (base + 0.3 * rng.randn(*s)).astype(np.float32)
    aux = {n: (np.ones(s) if n.endswith("_var") else 0.1 * rng.randn(*s))
           .astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    x = rng.randn(B, D).astype(np.float32)
    y = rng.randint(0, 10, B).astype(np.float32)
    return args, aux, x, y


# train step (fused) and eager forward/backward/update, interleaved
SCHEDULE = ("step", "eager", "step")


def _run_jax(optimizer, opt_params, args, aux, x, y):
    dd, ld = JDesc("data", (B, D)), JDesc("softmax_label", (B,))
    batch = JBatch([jnd.array(x)], [jnd.array(y)], provide_data=[dd],
                   provide_label=[ld])
    with jconfig.overrides(MXNET_PALLAS_UPDATE=False):
        mod = mx.mod.Module(_jmlp(), context=mx.cpu(),
                            compute_dtype="float32")
        mod.bind(data_shapes=[dd], label_shapes=[ld])
        mod.init_params(arg_params={k: jnd.array(v) for k, v in
                                    args.items()},
                        aux_params={k: jnd.array(v) for k, v in aux.items()})
        mod.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
        outs = []
        for how in SCHEDULE:
            if how == "step":
                mod.forward_backward(batch)
            else:
                mod.forward(batch, is_train=True)
                mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        arg, aux_out = mod.get_params()
        return outs, {k: v.asnumpy() for k, v in arg.items()}, \
            {k: v.asnumpy() for k, v in aux_out.items()}


def _module(optimizer, opt_params, args, aux):
    mod = mt.mod.Module(_mlp(), context=mt.cpu())
    mod.bind(data_shapes=[DataDesc("data", (B, D))],
             label_shapes=[DataDesc("softmax_label", (B,))])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
    return mod


def _slab_of(mod, name):
    """The storage pointer of a trainable's executor array."""
    arr = mod._exec_group.exec_.arg_dict[name]
    return arr.data.untyped_storage().data_ptr()


@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("sgd", {"learning_rate": 0.1, "wd": 1e-3, "clip_gradient": 0.05}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3})])
def test_armed_step_and_eager_update_match_jax_module(optimizer,
                                                      opt_params):
    """Train steps through the slab plan (the plain version on the CPU)
    and an eager forward / backward / update() between them update one
    storage, and land where the JAX Module's per-parameter path does."""
    args, aux, x, y = _mlp_values()
    want_outs, want, want_aux = _run_jax(optimizer, opt_params, args, aux,
                                         x, y)
    mod = _module(optimizer, opt_params, args, aux)
    step = mod._train_step
    assert step.plan is not None
    slab = {n: _slab_of(mod, n) for n in args}
    batch = DataBatch([mt.nd.array(x)], [mt.nd.array(y)])
    outs = []
    for how in SCHEDULE:
        if how == "step":
            uk.UPDATE_PATH["last"] = None
            mod.forward_backward(batch)
            assert uk.UPDATE_PATH["last"] == "plain"
        else:
            mod.forward(batch, is_train=True)
            mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    # nothing rebound a trainable away from its slab
    assert {n: _slab_of(mod, n) for n in args} == slab
    for got, ref in zip(outs, want_outs):
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_OUT)
    arg_p, aux_p = mod.get_params()
    got = params_to_numpy(arg_p, aux_p)
    for k in want:
        delta = want[k] - args[k]
        err = float(np.max(np.abs(got[k] - args[k] - delta)))
        assert err <= TOL_DELTA * float(np.max(np.abs(delta))), (k, err)
    for k in want_aux:
        np.testing.assert_allclose(got["aux:" + k], want_aux[k], rtol=0,
                                   atol=TOL_OUT)


def test_set_params_after_arming_reaches_the_next_step():
    """set_params copies into the slab views: the next step starts from
    the new values, exactly as a module built from them does."""
    args, aux, x, y = _mlp_values()
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    batch = DataBatch([mt.nd.array(x)], [mt.nd.array(y)])
    mod = _module("sgd", opt, args, aux)
    slab = {n: _slab_of(mod, n) for n in args}
    mod.forward_backward(batch)
    mod.update()
    new_args = {k: v * 0.5 for k, v in args.items()}
    mod.set_params(new_args, aux)
    assert {n: _slab_of(mod, n) for n in args} == slab
    mod.forward_backward(batch)
    mod.update()
    fresh = _module("sgd", opt, new_args, aux)
    # the momentum carries over in `mod`, not in `fresh`: compare outputs
    # (the forward before the update) and the gradients
    fresh.forward_backward(batch)
    fresh.update()
    np.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(),
                                  fresh.get_outputs()[0].asnumpy())
    for a, b in zip(mod._exec_group.grad_arrays,
                    fresh._exec_group.grad_arrays):
        assert torch.equal(a.data, b.data)


def test_bf16_compute_slab_refreshes_after_eager_update():
    """Under bf16 compute the forward reads the compute slab; an eager
    update (or set_params) writes the masters, and the next step recasts
    the compute slab first."""
    args, aux, x, y = _mlp_values()
    mod = mt.mod.Module(_mlp(), context=mt.cpu(), compute_dtype="bfloat16")
    mod.bind(data_shapes=[DataDesc("data", (B, D))],
             label_shapes=[DataDesc("softmax_label", (B,))])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    step = mod._train_step
    assert step.plan.has_wc("float32")
    batch = DataBatch([mt.nd.array(x)], [mt.nd.array(y)])
    mod.forward_backward(batch)
    mod.update()
    (bk,) = step.plan.buckets
    assert torch.equal(step._wc[bk], step._w[bk].to(torch.bfloat16))
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    assert not torch.equal(step._wc[bk], step._w[bk].to(torch.bfloat16))
    mod.forward_backward(batch)
    # the step's forward read the recast masters of the eager update
    arrs = mod._exec_group.exec_.arg_dict
    assert all(v.data.dtype == torch.float32 for v in arrs.values())
    assert torch.equal(step._wc[bk], step._w[bk].to(torch.bfloat16))


def test_scheduler_lr_reaches_the_blocks():
    """A FactorScheduler's rate change reaches the per-block lr the
    update reads, one step after the boundary, times each lr_mult."""
    args, aux, x, y = _mlp_values()
    sched = tsched.FactorScheduler(step=1, factor=0.5)
    mod = _module("sgd", {"learning_rate": 0.2, "lr_scheduler": sched},
                  args, aux)
    mod._optimizer.set_lr_mult({"fc2_weight": 3.0})
    step = mod._train_step
    batch = DataBatch([mt.nd.array(x)], [mt.nd.array(y)])
    for k in range(3):
        mod.forward_backward(batch)
        mod.update()
        lrb = step._hyper_cache[2]["float32"].numpy()
        for seg in step.plan.buckets["float32"]:
            b0 = seg.row0 // uk.BLOCK_ROWS
            mult = 3.0 if seg.name == "fc2_weight" else 1.0
            np.testing.assert_array_equal(
                lrb[b0:b0 + seg.nblocks],
                np.float32(0.2 * 0.5 ** k * mult))


@pytest.mark.parametrize("optimizer", ["nag", "sgd"])
def test_per_param_path_where_the_plan_declines(optimizer):
    """The plan declines only for the JAX package's reasons: an optimizer
    the kernel does not implement (NAG; exact-type checks) or a master
    that is not f32 / bf16.  There the train step keeps the per-parameter
    update and rebinds nothing; SGD over f32 masters is armed."""
    args, aux, x, y = _mlp_values()
    mod = _module(optimizer, {"learning_rate": 0.1, "momentum": 0.9},
                  args, aux)
    slab = {n: _slab_of(mod, n) for n in args}
    mod.forward_backward(DataBatch([mt.nd.array(x)], [mt.nd.array(y)]))
    mod.update()
    assert {n: _slab_of(mod, n) for n in args} == slab
    if optimizer == "nag":
        assert mod._train_step.plan is None
        assert uk.UPDATE_PATH["last"] == "per_param"
    else:
        assert mod._train_step.plan is not None
        assert uk.UPDATE_PATH["last"] == "plain"
    assert uk.kind_of(mt.optimizer.NAG()) is None
    assert uk.kind_of(mt.optimizer.ccSGD(momentum=0.9)) == ("sgd", 1)
    sgd = mt.optimizer.SGD(momentum=0.9)
    for dtype, want in ((torch.float16, None), (torch.float64, None),
                        (torch.bfloat16, "bfloat16")):
        plan = uk.plan_for(sgd, {"w": torch.zeros(3, dtype=dtype)}, ["w"],
                           None)
        assert (None if plan is None else list(plan.buckets)) == (
            None if want is None else [want])
