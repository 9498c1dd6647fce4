"""Pipeline parallelism through the port: ``parallel.pipeline_apply`` and
``mod.PipelineModule`` over gloo ranks on the CPU, against the JAX
package's pipeline on its 8-virtual-device harness (the behaviours of
``tests/test_pipeline_parallel.py``).

This file is its own worker: ``python tests/test_torch_pipeline.py
<rank> <world> <host:port> <outdir>`` runs one rank (it imports only
PyTorch and the port) and writes what it computed to
``<outdir>/r<rank>.pkl``.  One spawn of 4 ranks serves every case: 4
stages over the whole group, and 2 stages x 2 data ranks (the (pipe,
data) layout; ``pipeline_apply`` over each column's pipe group).  The
reference's 8-stage case runs at 2 stages here (4 ranks a spawn keep
the file inside its time).  What is held:

* the schedule against the sequential net (4 x 4, 4 x 8, 2 x 4 stages x
  microbatches; 1e-5 / 1e-6) and against the JAX ``pipeline_apply``;
  its gradients against ``jax.grad`` of the sequential net (1e-4 /
  1e-5), through the explicit reverse pipeline; the data axis composed;
* a planted fault (each rank holding the next stage's parameters) fails
  the same parity check;
* dropout masks distinct per microbatch; ``remat`` the same gradients
  with fewer bytes saved for backward (autograd's saved tensors);
* ``PipelineModule``: the forward against the JAX unrolled Module and
  ``PipelineModule``, parameters after 2 Adam steps against the JAX
  ``PipelineModule``'s (1e-4 / 1e-6: B1's Adam against the reference's);
  each parameter's move in one plain SGD step against the JAX unrolled
  Module's, at 4 stages and at 2 stages x 2 data ranks (the gradients'
  scale, which Adam's first step hides), and two planted faults (the
  rescale doubled, the gradients not shared) failing that check;
  ``fit`` converging (plain, dropout, remat, heterogeneous widths, and at
  2 stages x 2 data ranks), ``score`` leaving the parameters unchanged,
  the zero padding surviving training;
* every bind guard: a stateful stage, mismatched structure or ops,
  padded stages with an op of f(0) != 0 (the whole elementwise family),
  padding that is not zero in ``init_params`` and ``set_params``, a
  layout that does not cover the group, and a ``pipe`` axis given to a
  plain ``Module`` (naming ``PipelineModule``).
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
PROC_TIMEOUT = 240
WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
SGD_LR = 0.5
SEQ_CASES = [(4, 4), (4, 8), (2, 4)]
WIDTHS = [4, 16, 8, 12]
FIT_WIDTHS = [16, 4, 8, 12]


# ---------------------------------------------------------------------------
# nets and data, the same for both packages
# ---------------------------------------------------------------------------

def _stage_params(rng, n_stages, d):
    return [(rng.normal(0, 0.5, (d, d)).astype(np.float32),
             rng.normal(0, 0.1, (d,)).astype(np.float32))
            for _ in range(n_stages)]


def _sequential(per_stage, x_flat):
    a = x_flat.astype(np.float64)
    for w, b in per_stage:
        a = np.tanh(a @ w + b)
    return a


def _seq_case(n_stages, micro):
    rng = np.random.RandomState(0)
    d, mb = 6, 3
    per_stage = _stage_params(rng, n_stages, d)
    x = rng.normal(size=(micro, mb, d)).astype(np.float32)
    return per_stage, x


def _grad_case():
    rng = np.random.RandomState(1)
    per_stage = _stage_params(rng, 4, 5)
    return per_stage, rng.normal(size=(4, 2, 5)).astype(np.float32)


def _data_case():
    rng = np.random.RandomState(2)
    per_stage = _stage_params(rng, 2, 6)
    return per_stage, rng.normal(size=(4, 4, 6)).astype(np.float32)


def _stage_sym(sym, d, dropout=0.0):
    s = sym.FullyConnected(sym.Variable("data"), num_hidden=d, name="fc")
    s = sym.Activation(s, act_type="tanh", name="act")
    if dropout:
        s = sym.Dropout(s, p=dropout, name="drop")
    return s


def _head_sym(sym, classes):
    h = sym.FullyConnected(sym.Variable("data"), num_hidden=classes,
                           name="out")
    return sym.SoftmaxOutput(h, name="softmax")


def _stage_sym_width(sym, h, d, act="tanh"):
    s = sym.FullyConnected(sym.Variable("data"), num_hidden=h,
                           name="fc_in")
    s = sym.Activation(s, act_type=act)
    return sym.FullyConnected(s, num_hidden=d, name="fc_out")


def _unrolled(sym, d, classes, n_stages, widths=None):
    net = sym.Variable("data")
    for s in range(n_stages):
        if widths is None:
            net = sym.FullyConnected(net, num_hidden=d, name="fc%d" % s)
            net = sym.Activation(net, act_type="tanh")
        else:
            net = sym.FullyConnected(net, num_hidden=widths[s],
                                     name="fc_in%d" % s)
            net = sym.Activation(net, act_type="tanh")
            net = sym.FullyConnected(net, num_hidden=d,
                                     name="fc_out%d" % s)
    net = sym.FullyConnected(net, num_hidden=classes, name="out")
    return sym.SoftmaxOutput(net, name="softmax")


def _unrolled_params(d, classes, n_stages, widths=None, seed=0):
    """Xavier-like numpy parameters of the unrolled net, by name."""
    rng = np.random.RandomState(seed)

    def w(o, i):
        return rng.uniform(-1, 1, (o, i)).astype(np.float32) \
            * np.float32(np.sqrt(6.0 / (o + i)))

    out = {}
    for s in range(n_stages):
        if widths is None:
            out["fc%d_weight" % s] = w(d, d)
            out["fc%d_bias" % s] = rng.normal(0, 0.1, d).astype(np.float32)
        else:
            h = widths[s]
            out["fc_in%d_weight" % s] = w(h, d)
            out["fc_in%d_bias" % s] = rng.normal(0, 0.1, h).astype(
                np.float32)
            out["fc_out%d_weight" % s] = w(d, h)
            out["fc_out%d_bias" % s] = rng.normal(0, 0.1, d).astype(
                np.float32)
    out["out_weight"] = w(classes, d)
    out["out_bias"] = rng.normal(0, 0.1, classes).astype(np.float32)
    return out


def _stacked(params, n_stages, widths=None, d=8):
    """The unrolled net's parameters as the pipeline's stacked ones."""
    if widths is None:
        return {"fc_weight": np.stack([params["fc%d_weight" % s]
                                       for s in range(n_stages)]),
                "fc_bias": np.stack([params["fc%d_bias" % s]
                                     for s in range(n_stages)]),
                "out_weight": params["out_weight"],
                "out_bias": params["out_bias"]}
    hmax, n = max(widths), len(widths)
    w_in = np.zeros((n, hmax, d), np.float32)
    b_in = np.zeros((n, hmax), np.float32)
    w_out = np.zeros((n, d, hmax), np.float32)
    b_out = np.zeros((n, d), np.float32)
    for s, h in enumerate(widths):
        w_in[s, :h] = params["fc_in%d_weight" % s]
        b_in[s, :h] = params["fc_in%d_bias" % s]
        w_out[s, :, :h] = params["fc_out%d_weight" % s]
        b_out[s] = params["fc_out%d_bias" % s]
    return {"fc_in_weight": w_in, "fc_in_bias": b_in,
            "fc_out_weight": w_out, "fc_out_bias": b_out,
            "out_weight": params["out_weight"],
            "out_bias": params["out_bias"]}


def _toy(seed, n=64, d=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    return x, (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)


# ---------------------------------------------------------------------------
# the worker (one rank)
# ---------------------------------------------------------------------------

def _tanh_stage(params, a, mb_id):
    import torch

    return torch.tanh(a @ params[0] + params[1])


def _pipe(per_stage, x, group, stage, micro, fault=False, remat=False,
          grads=False):
    import torch
    from mxnet_tpu_torch.parallel import pipeline_apply

    n = len(per_stage)
    mine = tuple(torch.tensor(p).requires_grad_(grads)
                 for p in per_stage[(stage + fault) % n])
    out = pipeline_apply(_tanh_stage, mine, torch.tensor(x), group, micro,
                         remat=remat)
    if not grads:
        return out.detach().numpy()
    (out ** 2).sum().backward()
    return out.detach().numpy(), [p.grad.numpy() for p in mine]


def _fit(mt, pipe, x, y, epochs, opt, opt_params, seed, metric="acc"):
    import torch

    np.random.seed(seed)
    torch.manual_seed(seed)
    it = mt.io.NDArrayIter({"data": x}, {"softmax_label": y}, batch_size=16)
    pipe.fit(it, optimizer=opt, optimizer_params=opt_params,
             initializer=mt.initializer.Xavier(), num_epoch=epochs,
             eval_metric=metric)
    it.reset()
    return dict(pipe.score(it, metric))


def _pipeline_cases(mt, rank, mesh22, res):
    import torch

    pipe2 = mesh22.get_group("pipe")
    stage2 = mesh22.get_local_rank("pipe")
    for n_stages, micro in SEQ_CASES:
        per_stage, x = _seq_case(n_stages, micro)
        group, stage = (None, rank) if n_stages == WORLD else (pipe2, stage2)
        res["seq_%dx%d" % (n_stages, micro)] = _pipe(per_stage, x, group,
                                                     stage, micro)
    per_stage, x = _seq_case(4, 4)
    res["fault"] = _pipe(per_stage, x, None, rank, 4, fault=True)
    per_stage, x = _grad_case()
    res["grads"] = _pipe(per_stage, x, None, rank, 4, grads=True)
    per_stage, x = _data_case()
    d = mesh22.get_local_rank("data")
    res["data"] = (d, _pipe(per_stage, x[:, 2 * d:2 * d + 2], pipe2, stage2,
                            4))

    # dropout: each (stage, microbatch) seeds its own generator
    from mxnet_tpu_torch.parallel import pipeline_apply

    gen = torch.Generator()

    def drop(params, a, mb_id):
        gen.manual_seed(1000 * rank + mb_id)
        keep = torch.rand(a.shape, generator=gen) < 0.5
        return torch.where(keep, a, torch.zeros_like(a))

    res["dropout"] = pipeline_apply(drop, (torch.zeros(1),),
                                    torch.ones(4, 8, 16), None,
                                    4).detach().numpy()

    # remat: the same gradients, fewer bytes kept for backward
    rng = np.random.RandomState(0)
    depth, d64 = 4, 32
    stacked = [torch.tensor(rng.normal(0, 0.1, (depth, d64, d64)),
                            dtype=torch.float32) for _ in range(WORLD)]
    xr = torch.tensor(rng.normal(size=(8, 4, d64)), dtype=torch.float32)

    def deep(params, a, mb_id):
        for i in range(depth):
            a = torch.tanh(a @ params[i])
        return a

    for remat in (False, True):
        w = stacked[rank].clone().requires_grad_()
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = pipeline_apply(deep, w, xr, None, 8, remat=remat)
        (out ** 2).sum().backward()
        res["remat_%s" % remat] = (w.grad.numpy(), saved[0])


def _module_cases(mt, rank, res):
    import torch
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import MeshConfig

    sym, nd = mt.sym, mt.nd
    ctx = mt.cpu()
    batch, d, classes = 8, 8, 3
    x = np.random.RandomState(0).randn(batch, d).astype(np.float32)
    y = np.random.RandomState(1).randint(0, classes, batch).astype(
        np.float32)

    def bound(stages, micro=4, widths=None, remat=False, dshape=(8, 8),
              label=True):
        stage = _stage_sym(sym, d) if widths is None else \
            [_stage_sym_width(sym, h, d) for h in widths]
        pipe = mt.mod.PipelineModule(stage, _head_sym(sym, classes),
                                     num_stages=stages,
                                     num_microbatches=micro, context=ctx,
                                     remat=remat)
        pipe.bind(data_shapes=[("data", dshape)],
                  label_shapes=[("softmax_label", (dshape[0],))]
                  if label else None)
        return pipe

    def stacked_nd(params):
        return {k: nd.array(v) for k, v in params.items()}

    # forward against the unrolled net; 2 Adam steps
    params = _unrolled_params(d, classes, 4)
    pipe = bound(4)
    pipe.init_params(arg_params=stacked_nd(_stacked(params, 4)))
    batch_data = mt.io.DataBatch([nd.array(x)], [nd.array(y)])
    pipe.forward(batch_data, is_train=False)
    res["module_forward"] = pipe.get_outputs()[0].asnumpy()
    pipe.init_optimizer(optimizer="adam",
                        optimizer_params={"learning_rate": 0.01})
    res["update_path"] = "kernel B1 slab" if pipe._slab is not None \
        else "per-parameter"
    for _ in range(2):
        pipe.forward_backward(batch_data)
    res["module_steps"] = {k: v.asnumpy()
                           for k, v in pipe.get_params()[0].items()}
    res["module_step_outputs"] = pipe.get_outputs()[0].asnumpy()

    # one plain SGD step (its move is lr x rescale_grad x the gradient,
    # which Adam's first step hides) at 4 stages and at 2 stages x 2
    # data ranks; at 2 x 2 also two planted faults: the rescale doubled,
    # and the gradients not shared (no data-group sum, no embed / head
    # broadcast)
    for key, stages, opt, share in (
            ("sgd_4", 4, {}, True), ("sgd_2x2", 2, {}, True),
            ("sgd_2x2_rescale_fault", 2, {"rescale_grad": 2.0 / batch},
             True),
            ("sgd_2x2_share_fault", 2, {}, False)):
        pipe = bound(stages)
        pipe.init_params(arg_params=stacked_nd(_stacked(
            _unrolled_params(d, classes, stages), stages)))
        pipe.init_optimizer(optimizer="sgd", optimizer_params=dict(
            opt, learning_rate=SGD_LR))
        if not share:
            pipe._share_grads = lambda: None
        pipe.forward_backward(batch_data)
        res[key] = {k: v.asnumpy() for k, v in pipe.get_params()[0].items()}
        res[key + "_path"] = "kernel B1 slab" if pipe._slab is not None \
            else "per-parameter"

    # heterogeneous widths against the unrolled net
    hparams = _unrolled_params(d, classes, 4, widths=WIDTHS)
    pipe = bound(4, widths=WIDTHS)
    pipe.init_params(arg_params=stacked_nd(_stacked(hparams, 4, WIDTHS)))
    pipe.forward(batch_data, is_train=False)
    res["hetero_forward"] = pipe.get_outputs()[0].asnumpy()

    # fit: plain, dropout, remat and heterogeneous at 4 stages; 2 stages
    # x 2 data ranks
    X, Y = _toy(3)
    stage = _stage_sym(sym, d)
    head = _head_sym(sym, 2)
    momentum = {"learning_rate": 0.3, "momentum": 0.9}
    res["fit"] = _fit(mt, mt.mod.PipelineModule(
        stage, head, 4, 4, context=ctx), X, Y, 30, "sgd", momentum, 7)
    res["fit_data2"] = _fit(mt, mt.mod.PipelineModule(
        stage, head, 2, 4, context=ctx), X, Y, 30, "sgd", momentum, 7)
    res["fit_remat"] = _fit(mt, mt.mod.PipelineModule(
        stage, head, 4, 4, context=ctx, remat=True), X, Y, 30, "sgd",
        momentum, 7)
    X5, Y5 = _toy(5)
    res["fit_dropout"] = _fit(mt, mt.mod.PipelineModule(
        _stage_sym(sym, d, 0.1), head, 4, 4, context=ctx), X5, Y5, 40,
        "sgd", momentum, 9)
    X11, Y11 = _toy(11)
    het = mt.mod.PipelineModule(
        [_stage_sym_width(sym, h, d) for h in FIT_WIDTHS], head, 4, 4,
        context=ctx)
    res["fit_hetero"] = _fit(mt, het, X11, Y11, 60, "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9}, 13)
    res["hetero_fc_in"] = het.get_params()[0]["fc_in_weight"].asnumpy()

    # a dropout stage trains; score leaves the parameters as they were
    rng = np.random.RandomState(0)
    xd = rng.randn(32, d).astype(np.float32)
    yd = rng.randint(0, 2, 32).astype(np.float32)
    drop = mt.mod.PipelineModule(_stage_sym(sym, d, 0.2), head, 4, 4,
                                 context=ctx)
    it = mt.io.NDArrayIter({"data": xd}, {"softmax_label": yd},
                           batch_size=16)
    drop.fit(it, optimizer="sgd", optimizer_params={"learning_rate": 0.1},
             initializer=mt.initializer.Xavier(), num_epoch=1)
    p0 = {n: v.asnumpy() for n, v in drop.get_params()[0].items()}
    it.reset()
    drop.score(it, "acc")
    p1 = {n: v.asnumpy() for n, v in drop.get_params()[0].items()}
    res["score_keeps_params"] = all(np.array_equal(p0[n], p1[n])
                                    for n in p0)

    # padding guards (2 stages x 2 data ranks)
    def stage_act(act, h):
        return _stage_sym_width(sym, h, 8, act)

    pipe = mt.mod.PipelineModule([stage_act("tanh", 4),
                                  stage_act("tanh", 6)], _head_sym(sym, 2),
                                 2, 2, context=ctx)
    pipe.bind(data_shapes=[("data", (8, 8))],
              label_shapes=[("softmax_label", (8,))])
    bad = nd.array(np.ones((2, 6, 8), np.float32))
    try:
        pipe.init_params(arg_params={"fc_in_weight": bad})
        res["init_dirty_padding"] = None
    except MXNetError as exc:
        res["init_dirty_padding"] = str(exc)
    pipe.init_params(mt.initializer.Xavier())
    try:
        pipe.set_params({"fc_in_weight": bad}, allow_missing=True)
        res["set_dirty_padding"] = None
    except MXNetError as exc:
        res["set_dirty_padding"] = str(exc)
    same = mt.mod.PipelineModule([stage_act("sigmoid", 6),
                                  stage_act("sigmoid", 6)],
                                 _head_sym(sym, 2), 2, 2, context=ctx)
    same.bind(data_shapes=[("data", (8, 8))],
              label_shapes=[("softmax_label", (8,))])
    same.init_params(mt.initializer.Xavier())
    res["same_width_sigmoid_binds"] = True

    # layout guards
    try:
        mt.mod.PipelineModule(stage, head, 3, 2, context=ctx).bind(
            data_shapes=[("data", (8, 8))])
        res["raise_cover"] = None
    except MXNetError as exc:
        res["raise_cover"] = str(exc)
    try:
        mt.mod.Module(head, context=ctx, mesh_config=MeshConfig(
            data=1, model=1, pipe=WORLD)).bind(
            data_shapes=[("data", (8, 8))],
            label_shapes=[("softmax_label", (8,))])
        res["raise_module_pipe"] = None
    except MXNetError as exc:
        res["raise_module_pipe"] = str(exc)
    torch.manual_seed(0)


def _worker_main(argv):
    rank, world, address, outdir = argv
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel import launch
    from torch.distributed.device_mesh import DeviceMesh

    launch.init(address, world, rank, backend="gloo", timeout=120)
    mesh22 = DeviceMesh("cpu", torch.arange(world).reshape(2, 2),
                        mesh_dim_names=("pipe", "data"))
    res = {}
    with mt.cpu():
        _pipeline_cases(mt, rank, mesh22, res)
        _module_cases(mt, rank, res)
    with open(os.path.join(outdir, "r%d.pkl" % rank), "wb") as f:
        pickle.dump(res, f)
    launch.shutdown()
    print("PIPE_RANK_%d_OK" % rank, flush=True)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("pipeline"))
    address = "127.0.0.1:%d" % _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, HERE, str(r), str(WORLD), address, outdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True, cwd=ROOT) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=PROC_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "PIPE_RANK_%d_OK" % r in out, \
            "rank %d:\n%s" % (r, out[-6000:])
    got = []
    for r in range(WORLD):
        with open(os.path.join(outdir, "r%d.pkl" % r), "rb") as f:
            got.append(pickle.load(f))
    return got


def _jax_pipeline(per_stage, x, micro):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from mxnet_tpu.parallel.compat import shard_map
    from mxnet_tpu.parallel.pipeline import (pipeline_apply,
                                             stack_stage_params)

    n = len(per_stage)
    if len(jax.devices()) < n:
        pytest.skip("needs the 8-virtual-device harness")

    def stage_fn(params, a, mb_id):
        w, b = params
        return jax.numpy.tanh(a @ w + b)

    mesh = Mesh(np.array(jax.devices()[:n]), ("pipe",))
    piped = shard_map(
        lambda p, xx: pipeline_apply(stage_fn, p, xx, "pipe", micro),
        mesh=mesh, in_specs=(P("pipe"), P()), out_specs=P())
    return np.asarray(jax.jit(piped)(stack_stage_params(
        [tuple(map(np.asarray, p)) for p in per_stage]), x))


@pytest.mark.parametrize("n_stages,micro", SEQ_CASES)
def test_pipeline_matches_sequential_and_jax(ranks, n_stages, micro):
    per_stage, x = _seq_case(n_stages, micro)
    d = x.shape[-1]
    ref = _sequential(per_stage, x.reshape(-1, d)).reshape(x.shape)
    jax_out = _jax_pipeline(per_stage, x, micro)
    np.testing.assert_allclose(jax_out, ref, **TOL)
    for rk in ranks:
        # the last stage's results on every rank
        np.testing.assert_allclose(rk["seq_%dx%d" % (n_stages, micro)],
                                   jax_out, **TOL)


def test_planted_fault_fails_the_parity_check(ranks):
    """Each rank holding the NEXT stage's parameters: the check that
    passes on the tree fails."""
    per_stage, x = _seq_case(4, 4)
    ref = _sequential(per_stage, x.reshape(-1, 6)).reshape(x.shape)
    for rk in ranks:
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(rk["fault"], ref, **TOL)


def test_pipeline_grads_match_sequential(ranks):
    import jax
    import jax.numpy as jnp

    per_stage, x = _grad_case()

    def loss(p_list):
        a = jnp.asarray(x.reshape(-1, 5))
        for w, b in p_list:
            a = jnp.tanh(a @ w + b)
        return (a ** 2).sum()

    g_seq = jax.grad(loss)([tuple(map(jnp.asarray, p)) for p in per_stage])
    for r, rk in enumerate(ranks):
        _, (gw, gb) = rk["grads"]
        np.testing.assert_allclose(gw, np.asarray(g_seq[r][0]), **GRAD_TOL)
        np.testing.assert_allclose(gb, np.asarray(g_seq[r][1]), **GRAD_TOL)


def test_pipeline_composes_with_data_axis(ranks):
    per_stage, x = _data_case()
    ref = _sequential(per_stage, x.reshape(-1, 6)).reshape(x.shape)
    for rk in ranks:
        d, out = rk["data"]
        np.testing.assert_allclose(out, ref[:, 2 * d:2 * d + 2], **TOL)


def test_pipeline_dropout_masks_differ_per_microbatch(ranks):
    out = ranks[0]["dropout"]
    masks = (out != 0).reshape(out.shape[0], -1)
    for i in range(len(masks)):
        for j in range(i + 1, len(masks)):
            assert (masks[i] != masks[j]).any(), \
                "microbatches %d and %d share a dropout mask" % (i, j)


def test_pipeline_remat_same_grads_fewer_saved_bytes(ranks):
    for rk in ranks:
        g0, saved0 = rk["remat_False"]
        g1, saved1 = rk["remat_True"]
        np.testing.assert_allclose(g1, g0, rtol=1e-6, atol=1e-7)
        assert saved1 < saved0, (saved1, saved0)


def _jax_pipe_module(widths=None, n_stages=4):
    import jax
    import mxnet_tpu as mx

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device harness")
    stage = _stage_sym(mx.sym, 8) if widths is None else \
        [_stage_sym_width(mx.sym, h, 8) for h in widths]
    pipe = mx.mod.PipelineModule(stage, _head_sym(mx.sym, 3),
                                 num_stages=n_stages, num_microbatches=4,
                                 context=[mx.cpu(i) for i in range(8)])
    pipe.bind(data_shapes=[("data", (8, 8))],
              label_shapes=[("softmax_label", (8,))])
    return pipe


def _jax_unrolled_forward(params, widths=None):
    import mxnet_tpu as mx

    net = _unrolled(mx.sym, 8, 3, 4, widths)
    mod = mx.mod.Module(net, context=mx.cpu(0))
    mod.bind(data_shapes=[("data", (8, 8))],
             label_shapes=[("softmax_label", (8,))], for_training=False)
    mod.init_params(arg_params={k: mx.nd.array(v)
                                for k, v in params.items()})
    x = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    mod.forward(mx.io.DataBatch([mx.nd.array(x)], []), is_train=False)
    return mod.get_outputs()[0].asnumpy()


def test_module_matches_unrolled_and_jax_pipeline(ranks):
    import mxnet_tpu as mx

    params = _unrolled_params(8, 3, 4)
    want = _jax_unrolled_forward(params)
    jp = _jax_pipe_module()
    jp.init_params(arg_params={k: mx.nd.array(v)
                               for k, v in _stacked(params, 4).items()})
    x = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    jp.forward(mx.io.DataBatch([mx.nd.array(x)], []), is_train=False)
    np.testing.assert_allclose(jp.get_outputs()[0].asnumpy(), want, **TOL)
    for rk in ranks:
        np.testing.assert_allclose(rk["module_forward"], want, **TOL)


def test_module_two_adam_steps_match_jax_pipeline(ranks):
    import mxnet_tpu as mx

    params = _unrolled_params(8, 3, 4)
    jp = _jax_pipe_module()
    jp.init_params(arg_params={k: mx.nd.array(v)
                               for k, v in _stacked(params, 4).items()})
    jp.init_optimizer(optimizer="adam",
                      optimizer_params={"learning_rate": 0.01})
    x = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 3, 8).astype(np.float32)
    batch = mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)])
    for _ in range(2):
        jp.forward_backward(batch)
    want = {k: v.asnumpy() for k, v in jp.get_params()[0].items()}
    start = _stacked(params, 4)
    for rk in ranks:
        assert rk["update_path"] == "kernel B1 slab"
        assert sorted(rk["module_steps"]) == sorted(want)
        for k, v in want.items():
            # the steps moved every parameter, and the port's moves match
            assert not np.allclose(v, start[k])
            np.testing.assert_allclose(rk["module_steps"][k], v,
                                       err_msg=k, **STEP_TOL)
        np.testing.assert_allclose(rk["module_step_outputs"],
                                   jp.get_outputs()[0].asnumpy(),
                                   **STEP_TOL)


def _jax_unrolled_sgd_step(n_stages):
    """The JAX unrolled Module's parameters after one SGD step, stacked
    as the pipeline's, and the start."""
    import mxnet_tpu as mx

    params = _unrolled_params(8, 3, n_stages)
    mod = mx.mod.Module(_unrolled(mx.sym, 8, 3, n_stages),
                        context=mx.cpu(0))
    mod.bind(data_shapes=[("data", (8, 8))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(arg_params={k: mx.nd.array(v)
                                for k, v in params.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": SGD_LR})
    x = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 3, 8).astype(np.float32)
    mod.forward_backward(mx.io.DataBatch([mx.nd.array(x)],
                                         [mx.nd.array(y)]))
    mod.update()
    after = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return _stacked(after, n_stages), _stacked(params, n_stages)


def _check_sgd_moves(got, want, start):
    """Each parameter's move in one SGD step against the reference's:
    lr x rescale_grad x the gradient, so a gradient scaled, counted
    twice or not summed over the data group fails."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k] - start[k], v - start[k],
                                   err_msg=k, **STEP_TOL)


@pytest.mark.parametrize("key,n_stages", [("sgd_4", 4), ("sgd_2x2", 2)])
def test_module_sgd_step_matches_jax_unrolled(ranks, key, n_stages):
    want, start = _jax_unrolled_sgd_step(n_stages)
    for k, v in want.items():
        assert np.abs(v - start[k]).max() > 1e-3, k   # the step moved it
    for rk in ranks:
        assert rk[key + "_path"] == "kernel B1 slab"
        _check_sgd_moves(rk[key], want, start)


@pytest.mark.parametrize("fault", ["rescale", "share"])
def test_planted_gradient_faults_fail_the_sgd_check(ranks, fault):
    """A doubled rescale, and gradients left unshared: the check that
    passes on the tree fails."""
    want, start = _jax_unrolled_sgd_step(2)
    for rk in ranks:
        with pytest.raises(AssertionError):
            _check_sgd_moves(rk["sgd_2x2_%s_fault" % fault], want, start)


def test_heterogeneous_matches_unrolled(ranks):
    params = _unrolled_params(8, 3, 4, widths=WIDTHS)
    want = _jax_unrolled_forward(params, WIDTHS)
    for rk in ranks:
        np.testing.assert_allclose(rk["hetero_forward"], want, **TOL)


@pytest.mark.parametrize("case", ["fit", "fit_data2", "fit_remat",
                                  "fit_dropout", "fit_hetero"])
def test_module_fit_converges(ranks, case):
    for rk in ranks:
        assert rk[case]["accuracy"] > 0.9, rk[case]


def test_heterogeneous_padding_survives_training(ranks):
    for rk in ranks:
        w = rk["hetero_fc_in"]
        for s, h in enumerate(FIT_WIDTHS):
            np.testing.assert_array_equal(w[s, h:], 0.0)


def test_dropout_stage_trains_and_score_keeps_params(ranks):
    assert all(rk["score_keeps_params"] for rk in ranks)


def test_padding_guards_on_bound_modules(ranks):
    for rk in ranks:
        assert "zero-padding" in rk["init_dirty_padding"]
        assert "zero-padding" in rk["set_dirty_padding"]
        assert rk["same_width_sigmoid_binds"]
        assert "does not cover" in rk["raise_cover"]
        assert "PipelineModule" in rk["raise_module_pipe"]


# ---------------------------------------------------------------------------
# guards that raise at bind, in this process
# ---------------------------------------------------------------------------

def _bind_one(stages, head=None, n=2, dshape=(8, 8)):
    import mxnet_tpu_torch as mt

    mt.mod.PipelineModule(stages, head or _head_sym(mt.sym, 2),
                          num_stages=n, num_microbatches=2,
                          context=mt.cpu()).bind(
        data_shapes=[("data", dshape)])


def test_rejects_stateful_stage():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.base import MXNetError

    s = mt.sym.BatchNorm(mt.sym.Variable("data"), name="bn")
    with pytest.raises(MXNetError, match="auxiliary state"):
        _bind_one(s, n=4, dshape=(8, 4))


def test_heterogeneous_rejects_mismatched_structure():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.base import MXNetError

    sym = mt.sym
    s0 = _stage_sym_width(sym, 4, 8)
    s1 = sym.Activation(sym.FullyConnected(
        sym.Variable("data"), num_hidden=8, name="other"), act_type="tanh")
    with pytest.raises(MXNetError, match="parameter"):
        _bind_one([s0, s1])


def test_heterogeneous_rejects_different_ops():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.base import MXNetError

    def stage(act):
        return _stage_sym_width(mt.sym, 4, 8, act)

    with pytest.raises(MXNetError, match="STRUCTURE"):
        _bind_one([stage("tanh"), stage("relu"), stage("tanh"),
                   stage("relu")], n=4)


def test_zero_preservation_guard_covers_all_elementwise():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.base import MXNetError

    sym = mt.sym

    def stage(mid, h):
        s = sym.FullyConnected(sym.Variable("data"), num_hidden=h,
                               name="fc_in")
        return sym.FullyConnected(mid(s), num_hidden=8, name="fc_out")

    def bind(mid):
        _bind_one([stage(mid, 4), stage(mid, 6)])

    for bad in (lambda s: sym.Activation(s, act_type="sigmoid"),
                sym.sigmoid, sym.exp, sym.cos,
                lambda s: sym.Activation(s, act_type="softrelu"),
                sym.SoftmaxActivation,
                lambda s: s + 1.0,
                lambda s: sym._maximum_scalar(s, scalar=0.5),
                lambda s: sym.clip(s, a_min=0.5, a_max=2.0),
                lambda s: s / s,
                lambda s: sym.broadcast_equal(s, s)):
        with pytest.raises(MXNetError, match="zero-preserving"):
            bind(bad)
    # the zero-preserving ones pass the scan (and stop at the layout: one
    # process does not cover 2 stages)
    for good in (sym.sin, sym.tanh, lambda s: s * 2.0,
                 lambda s: sym.clip(s, a_min=-1.0, a_max=1.0),
                 lambda s: sym.LeakyReLU(s, act_type="elu"),
                 lambda s: s + s, lambda s: s * s,
                 lambda s: sym.broadcast_maximum(s, s)):
        with pytest.raises(MXNetError, match="does not cover"):
            bind(good)


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
