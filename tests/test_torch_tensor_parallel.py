"""Tensor parallelism through the port: a Module with ``mesh_config``
over gloo ranks on the CPU, against the JAX package's mesh Module
(``tests/test_tensor_parallel.py``'s nets and tolerances), the plan and
pspec functions against the JAX package's key by key, and the partition
rules.

This file is its own worker: ``python tests/test_torch_tensor_parallel.py
<rank> <world> <host:port> <outdir> <data> <model>`` runs one rank of a
(data x model) mesh (it imports only PyTorch and the port) and writes
what it computed to ``<outdir>/r<rank>.pkl``.  Two spawns serve every
case: (data=2, model=2) over 4 ranks and (data=1, model=2) over 2.
What is held:

* the MLP's forward (1e-5 relative / 1e-6 absolute) and three ``fit``
  epochs of the convnet, BatchNorm's statistics over the data group
  (2e-4 / 2e-5), against the JAX package's Module over the same mesh
  shape and numpy parameters;
* two steps of a 1-layer ``attention_lm`` (embed 32, 4 heads; GQA at 2
  kv heads; 3 heads, which do not divide the model axis, attention then
  running replicated) against the JAX package's mesh Module (the fused
  LN prologue's gamma / beta gradients summed over the group, the
  row-parallel epilogue's bias and residual added once), the update
  kernel B1's over the rank's shards;
* SoftmaxOutput's and MakeLoss's 'batch' / 'valid' normalization at
  data=2 against the JAX package's mesh Module (the whole batch's rows
  and valid count, not a slice's);
* a ``mean`` over the batch at data=2 raises;
* Megatron issues fewer collectives, and fewer bytes, than ``naive`` on
  the three nets of the reference's test, with equal outputs;
* a parameter whose planned dim does not divide the axis (the vocab of
  17) replicates with its coverage record, and the sharding-coverage
  pass names it; a ``seq`` axis and an ``expert`` axis bind; a
  checkpoint of the gathered parameters loads in the JAX package;
  optimizer-state files under a model axis raise.
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
LM = dict(vocab_size=32, seq_len=8, num_layers=1, embed=32, heads=4,
          ffn_hidden=64)
LM_CASES = {"lm": {}, "lm_gqa": {"num_kv_heads": 2},
            "lm_heads3": {"embed": 24, "heads": 3}}
LOSS_CASES = ("sm_batch", "sm_valid", "ml_batch", "ml_valid")
LM_BATCH = 4
LM_STEPS = 2
LM_LR = 0.1


# ---------------------------------------------------------------------------
# nets and data, the same for both packages
# ---------------------------------------------------------------------------

def _mlp(sym):
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                             name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _convnet(sym):
    net = sym.Convolution(sym.Variable("data"), num_filter=8,
                          kernel=(3, 3), pad=(1, 1), name="conv1")
    net = sym.BatchNorm(net, name="bn1")
    net = sym.Activation(net, act_type="relu")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=4, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")


def _tp_mlp(sym):
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=64,
                             name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=64, name="fc2")
    rng = np.random.RandomState(0)
    return (sym.SoftmaxOutput(net, name="softmax"), (8, 32), (8,),
            rng.randn(8, 32).astype(np.float32),
            rng.randint(0, 4, 8).astype(np.float32))


def _tp_attention_lm(sym):
    vocab, e, t, b = 17, 64, 8, 4
    emb = sym.Embedding(sym.Variable("data"), input_dim=vocab,
                        output_dim=e, name="embed")
    q = sym.FullyConnected(emb, num_hidden=e, flatten=False, name="q")
    k = sym.FullyConnected(emb, num_hidden=e, flatten=False, name="k")
    v = sym.FullyConnected(emb, num_hidden=e, flatten=False, name="v")
    att = sym.dot_product_attention(q, k, v, num_heads=4, causal=True)
    out = sym.FullyConnected(att, num_hidden=e, flatten=False, name="proj")
    net = sym.FullyConnected(out, num_hidden=8, name="head")
    rng = np.random.RandomState(1)
    return (sym.SoftmaxOutput(net, name="softmax"), (b, t), (b,),
            rng.randint(0, vocab, (b, t)).astype(np.float32),
            rng.randint(0, 8, b).astype(np.float32))


def _tp_conv_pool_net(sym):
    net = sym.Convolution(sym.Variable("data"), num_filter=16,
                          kernel=(3, 3), pad=(1, 1), name="conv1")
    net = sym.Activation(net, act_type="relu")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = sym.Convolution(net, num_filter=16, kernel=(3, 3), pad=(1, 1),
                          name="conv2")
    net = sym.Activation(net, act_type="relu")
    net = sym.Pooling(net, global_pool=True, pool_type="avg",
                      kernel=(1, 1))
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=4, name="fc")
    rng = np.random.RandomState(2)
    return (sym.SoftmaxOutput(net, name="softmax"), (4, 3, 8, 8), (4,),
            rng.randn(4, 3, 8, 8).astype(np.float32),
            rng.randint(0, 4, 4).astype(np.float32))


COUNT_NETS = {"mlp": _tp_mlp, "attention_lm": _tp_attention_lm,
              "conv_pool": _tp_conv_pool_net}


def _models(pkg):
    import importlib

    return importlib.import_module(pkg.__name__ + ".models")


def _lm_sym(pkg, case):
    kw = dict(LM, **LM_CASES[case])
    return _models(pkg).attention_lm.get_symbol(**kw), kw


def _params(sym, seed, **shapes):
    """Numpy parameters for ``sym`` (normal, 0.3 / sqrt(fan-in); LN gammas
    near 1), and zero aux states."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        fan = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        vals = rng.normal(0, 0.3 / np.sqrt(max(fan, 1)), shape)
        if name.endswith("gamma"):
            vals = 1.0 + 0.1 * vals
        args[name] = vals.astype(np.float32)
    aux = {n: (np.ones(s, np.float32) if n.endswith("var")
               else np.zeros(s, np.float32))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _mlp_data():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 10).astype(np.float32),
            rng.randint(0, 4, 8).astype(np.float32))


def _conv_data():
    rng = np.random.RandomState(2)
    return (rng.randn(16, 3, 8, 8).astype(np.float32),
            rng.randint(0, 4, 16).astype(np.float32))


def _lm_data(vocab):
    rng = np.random.RandomState(4)
    x = rng.randint(0, vocab, (LM_BATCH, LM["seq_len"])).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((LM_BATCH, 1), np.float32)],
                       axis=1)
    return x, y


# ---------------------------------------------------------------------------
# the two sides' runs (``pkg`` is mxnet_tpu or mxnet_tpu_torch)
# ---------------------------------------------------------------------------

def _module(pkg, net, data_shape, label_shape, ctx, mesh_config, args, aux):
    kw = {} if mesh_config is None else {"mesh_config": mesh_config}
    mod = pkg.mod.Module(net, context=ctx, **kw)
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", label_shape)])
    mod.init_params(arg_params={k: pkg.nd.array(v) for k, v in args.items()},
                    aux_params={k: pkg.nd.array(v) for k, v in aux.items()})
    return mod


def _numpy(params):
    return {k: v.asnumpy() for k, v in params.items()}


def run_mlp_forward(pkg, ctx, mesh_config):
    net = _mlp(pkg.sym)
    x, y = _mlp_data()
    args, aux = _params(net, 11, data=x.shape)
    mod = _module(pkg, net, x.shape, y.shape, ctx, mesh_config, args, aux)
    batch = pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)])
    mod.forward(batch, is_train=False)
    return mod.get_outputs()[0].asnumpy()


def run_conv_fit(pkg, ctx, mesh_config):
    net = _convnet(pkg.sym)
    x, y = _conv_data()
    args, aux = _params(net, 12, data=(8,) + x.shape[1:])
    it = pkg.io.NDArrayIter({"data": x}, {"softmax_label": y}, batch_size=8)
    mod = _module(pkg, net, (8,) + x.shape[1:], (8,), ctx, mesh_config,
                  args, aux)
    mod.fit(it, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            num_epoch=3, initializer=None)
    a, x_aux = mod.get_params()
    return dict(_numpy(a), **_numpy(x_aux))


def run_lm(pkg, ctx, mesh_config, case):
    net, kw = _lm_sym(pkg, case)
    x, y = _lm_data(kw["vocab_size"])
    args, aux = _params(net, 13, data=x.shape, softmax_label=y.shape)
    mod = _module(pkg, net, x.shape, y.shape, ctx, mesh_config, args, aux)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": LM_LR})
    batch = pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)])
    for _ in range(LM_STEPS):
        mod.forward_backward(batch)
        mod.update()
    mod.forward(batch, is_train=False)
    out = mod.get_outputs()[0].asnumpy()
    return out, _numpy(mod.get_params()[0]), mod


def _loss_net(sym, case):
    """The MLP under a loss head with a normalization that reads the
    batch: ``sm_*`` SoftmaxOutput (``valid`` ignores labels -1), ``ml_*``
    MakeLoss on the logits."""
    head, norm = case.split("_")
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                             name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    if head == "ml":
        return sym.MakeLoss(net, normalization=norm, name="loss")
    return sym.SoftmaxOutput(net, normalization=norm, use_ignore=True,
                             name="softmax")


def _loss_data():
    """The MLP's batch, its labels ignored on three of the first half's
    rows and none of the second's, so the slices' valid counts differ."""
    x, y = _mlp_data()
    y = y.copy()
    y[[0, 1, 3]] = -1
    return x, y


def run_loss_head(pkg, ctx, mesh_config, case):
    """One SGD step under the loss head ``case``: the parameters' change
    over the learning rate (the gradient the update applied)."""
    net = _loss_net(pkg.sym, case)
    x, y = _loss_data()
    labels = not case.startswith("ml")
    shapes = {"softmax_label": y.shape} if labels else {}
    args, aux = _params(net, 15, data=x.shape, **shapes)
    kw = {} if mesh_config is None else {"mesh_config": mesh_config}
    mod = pkg.mod.Module(net, context=ctx,
                         label_names=("softmax_label",) if labels else (),
                         **kw)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)] if labels else None)
    mod.init_params(arg_params={k: pkg.nd.array(v) for k, v in args.items()},
                    aux_params={})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": LM_LR})
    batch = pkg.io.DataBatch([pkg.nd.array(x)],
                             [pkg.nd.array(y)] if labels else None)
    mod.forward_backward(batch)
    mod.update()
    got = _numpy(mod.get_params()[0])
    return {n: (args[n] - got[n]) / LM_LR for n in args}


def run_count_net(pkg, ctx, mesh_config, name):
    net, dshape, lshape, x, y = COUNT_NETS[name](pkg.sym)
    args, aux = _params(net, 14, data=dshape)
    mod = _module(pkg, net, dshape, lshape, ctx, mesh_config, args, aux)
    batch = pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)])
    mod.forward(batch, is_train=True)
    mod.backward()
    return mod.get_outputs()[0].asnumpy(), mod


# ---------------------------------------------------------------------------
# the worker (one rank)
# ---------------------------------------------------------------------------

def _worker_main(argv):
    rank, world, address, outdir, data, model = argv
    rank, world, data, model = int(rank), int(world), int(data), int(model)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import analysis, config
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import update_kernel
    from mxnet_tpu_torch.parallel import MeshConfig, collectives, launch

    launch.init(address, world, rank, backend="gloo", timeout=120)
    mc = MeshConfig(data=data, model=model)
    ctx = mt.cpu()
    res = {}
    with ctx:
        res["mlp_forward"] = run_mlp_forward(mt, ctx, mc)
        res["conv_fit"] = run_conv_fit(mt, ctx, mc)
        if data > 1:
            for case in LOSS_CASES:
                res["loss_" + case] = run_loss_head(mt, ctx, mc, case)
            net = mt.sym.MakeLoss(mt.sym.mean(mt.sym.FullyConnected(
                mt.sym.Variable("data"), num_hidden=4, name="fc")))
            x, _ = _mlp_data()
            mod = mt.mod.Module(net, context=ctx, label_names=(),
                                mesh_config=mc)
            mod.bind(data_shapes=[("data", x.shape)])
            mod.init_params(arg_params={
                k: mt.nd.array(v)
                for k, v in _params(net, 15, data=x.shape)[0].items()})
            try:
                mod.forward(mt.io.DataBatch([mt.nd.array(x)], None))
                res["raise_batch_mean"] = None
            except MXNetError as exc:
                res["raise_batch_mean"] = str(exc)
        for case in LM_CASES:
            if data > 1 and case != "lm":
                continue
            collectives.reset_counts()
            update_kernel.UPDATE_PATH["last"] = None
            out, params, mod = run_lm(mt, ctx, mc, case)
            res[case] = {"out": out, "params": params,
                         "counts": dict(collectives.COUNTS),
                         "sharded": dict(mod._exec_group.tp.sharded),
                         "slab_update": mod._slab_update is not None,
                         "update_path": update_kernel.UPDATE_PATH["last"]}
            if case == "lm" and data == 1:
                prefix = os.path.join(outdir, "lm")
                mod.save_checkpoint(prefix, 2)
                res["states_error"] = None
                try:
                    mod.save_optimizer_states(prefix + ".states")
                except MXNetError as exc:
                    res["states_error"] = str(exc)
        if data == 1:
            for mode in ("megatron", "naive"):
                for name in COUNT_NETS:
                    with config.overrides(MXNET_TP_MODE=mode):
                        collectives.reset_counts()
                        out, mod = run_count_net(mt, ctx, mc, name)
                        res["count_%s_%s" % (mode, name)] = {
                            "out": out, "counts": dict(collectives.COUNTS)}
                    if mode == "megatron" and name == "attention_lm":
                        art = mod.program_artifacts()["train_step"]
                        report = analysis.run_passes(
                            [art], passes=[
                                analysis.passes.ShardingCoveragePass()])
                        res["degrade"] = {
                            "coverage": art.meta["sharding_coverage"],
                            "errors": [f.detail.get("param") for f in
                                       report.findings
                                       if f.severity == "error"]}
            for axis in ("seq", "expert"):
                try:
                    seq_mod = mt.mod.Module(_mlp(mt.sym), context=ctx,
                                            mesh_config=MeshConfig(
                                                data=1, model=1,
                                                **{axis: world}))
                    seq_mod.bind(data_shapes=[("data", (8, 10))],
                                 label_shapes=[("softmax_label", (8,))])
                    res["raise_" + axis] = None
                    res["bound_" + axis] = getattr(
                        seq_mod._exec_group.mesh, axis)
                except MXNetError as exc:
                    res["raise_" + axis] = str(exc)
    with open(os.path.join(outdir, "r%d.pkl" % rank), "wb") as f:
        pickle.dump(res, f)
    launch.shutdown()
    print("TP_RANK_%d_OK" % rank, flush=True)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(outdir, data, model):
    world = data * model
    address = "127.0.0.1:%d" % _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, HERE, str(r), str(world), address, outdir,
         str(data), str(model)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env, text=True, cwd=ROOT)
        for r in range(world)]


def _finish(procs, outdir):
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
        assert p.returncode == 0 and "TP_RANK_%d_OK" % r in out, \
            "rank %d:\n%s" % (r, out[-6000:])
    ranks = []
    for r in range(len(procs)):
        with open(os.path.join(outdir, "r%d.pkl" % r), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


MESHES = {"data2_model2": (2, 2), "data1_model2": (1, 2)}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Both meshes' ranks, started together: ``{name: (data, model,
    outdir, [rank results])}``."""
    started = {}
    for name, (data, model) in MESHES.items():
        outdir = str(tmp_path_factory.mktemp("tp_" + name))
        started[name] = (data, model, outdir, _start(outdir, data, model))
    return {name: (d, m, o, _finish(procs, o))
            for name, (d, m, o, procs) in started.items()}


@pytest.fixture
def mesh12(meshes):
    return meshes["data1_model2"]


def _jax_ctx(data, model):
    import mxnet_tpu as mx

    return [mx.cpu(i) for i in range(data * model)]


def _jax_mesh(data, model):
    from mxnet_tpu.parallel import MeshConfig

    return MeshConfig(data=data, model=model)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mlp_forward_matches_jax_mesh_module(meshes, mesh):
    import mxnet_tpu as mx

    data, model, _, ranks = meshes[mesh]
    want = run_mlp_forward(mx, _jax_ctx(data, model),
                           _jax_mesh(data, model))
    for r, res in enumerate(ranks):
        _close(res["mlp_forward"], want, 1e-5, 1e-6, "rank %d" % r)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_convnet_fit_matches_jax_mesh_module(meshes, mesh):
    """Three fit epochs (SGD-momentum); BatchNorm's statistics over the
    data group, as the reference's mesh-wide batch statistics."""
    import mxnet_tpu as mx

    data, model, _, ranks = meshes[mesh]
    want = run_conv_fit(mx, _jax_ctx(data, model), _jax_mesh(data, model))
    for r, res in enumerate(ranks):
        for name, w in want.items():
            _close(res["conv_fit"][name], w, 2e-4, 2e-5,
                   "rank %d %s" % (r, name))


@pytest.mark.parametrize("mesh,case", [("data2_model2", "lm")] + [
    ("data1_model2", case) for case in LM_CASES])
def test_lm_two_steps_match_jax_mesh_module(meshes, mesh, case):
    """Two steps of the 1-layer LM: the fused LN prologue (q/k/v, ffn1)
    column-parallel, the epilogue's bias and residual (ffn2, attout)
    added once after the all-reduce, vocab-parallel embedding, the
    logits gathered for SoftmaxOutput."""
    import mxnet_tpu as mx

    data, model, _, ranks = meshes[mesh]
    out, params, _ = run_lm(mx, _jax_ctx(data, model),
                            _jax_mesh(data, model), case)
    sharded = ranks[0][case]["sharded"]
    assert sharded["layer0_q_weight"] == 0
    assert sharded["layer0_ffn2_weight"] == 1
    for r, res in enumerate(ranks):
        got = res[case]
        _close(got["out"], out, 1e-5, 1e-6, "rank %d outputs" % r)
        for name, w in params.items():
            _close(got["params"][name], w, 2e-4, 2e-5,
                   "rank %d %s" % (r, name))
    counts = ranks[0][case]["counts"]
    assert counts["all_reduce"]["calls"] > 0
    # the update is kernel B1's (its plain version on the CPU) over the
    # rank's shards, as the reference's mesh step runs its fused update
    assert ranks[0][case]["slab_update"]
    assert ranks[0][case]["update_path"] == "plain"


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_normalization_over_the_data_group(meshes, case):
    """SoftmaxOutput's and MakeLoss's 'batch' / 'valid' normalization at
    data=2 divide by the whole batch, as the reference's global batch
    does: each rank's slice alone would double 'batch''s gradient and
    give 'valid' its own count."""
    import mxnet_tpu as mx

    data, model, _, ranks = meshes["data2_model2"]
    want = run_loss_head(mx, _jax_ctx(data, model), _jax_mesh(data, model),
                         case)
    for r, res in enumerate(ranks):
        for name, g in want.items():
            _close(res["loss_" + case][name], g, 2e-4, 2e-6,
                   "rank %d %s" % (r, name))


def test_reduction_over_the_sliced_batch_raises(meshes):
    """A ``mean`` over the batch under a data axis of 2 would cover each
    rank's slice only: it raises, naming the node and the way out."""
    data, model, _, ranks = meshes["data2_model2"]
    for res in ranks:
        msg = res["raise_batch_mean"]
        assert msg is not None and "reduces over dim 0" in msg \
            and "data axis of 2" in msg, msg


def test_megatron_fewer_collectives_than_naive(mesh12):
    """The reference's claim on its three nets at model=2: fewer
    collectives and fewer bytes under the Megatron plan than under
    blanket dim-0 sharding, the outputs equal."""
    data, model, _, ranks = mesh12
    res = ranks[0]
    for name in COUNT_NETS:
        m = res["count_megatron_%s" % name]
        n = res["count_naive_%s" % name]
        _close(m["out"], n["out"], 1e-4, 1e-5, name)
        calls = [sum(c["calls"] for c in x["counts"].values())
                 for x in (m, n)]
        nbytes = [sum(c["bytes"] for c in x["counts"].values())
                  for x in (m, n)]
        assert calls[0] < calls[1], (name, m["counts"], n["counts"])
        assert nbytes[0] < nbytes[1], (name, m["counts"], n["counts"])


def test_count_nets_match_jax_mesh_module(mesh12):
    import mxnet_tpu as mx

    data, model, _, ranks = mesh12
    for name in COUNT_NETS:
        want, _ = run_count_net(mx, _jax_ctx(data, model),
                                _jax_mesh(data, model), name)
        _close(ranks[0]["count_megatron_%s" % name]["out"], want, 1e-5,
               1e-6, name)


def test_indivisible_parameter_degrades_with_its_record(mesh12):
    """The vocab of 17 does not divide the model axis: embed_weight
    replicates, its record says so, and the sharding-coverage pass
    errors naming it, as the reference's pass does."""
    data, model, _, ranks = mesh12
    deg = ranks[0]["degrade"]
    rec = deg["coverage"]["leaves"]["embed_weight"]
    assert rec == {"shape": [17, 64], "source": "plan",
                   "degrade": "indivisible"}
    assert deg["coverage"]["mesh"] == {"data": 1, "model": 2}
    assert deg["coverage"]["leaves"]["q_weight"]["spec"] == ["model", None]
    assert deg["errors"] == ["embed_weight"]


def test_seq_and_expert_axes_raise(mesh12):
    """Neither raises any more: a ``seq`` axis binds (sequence
    parallelism: its inputs split over the axis where their layout has N
    and T), and so does an ``expert`` axis (expert parallelism: the MoE
    stacks shard over it; this net has none, so every rank computes the
    same)."""
    data, model, _, ranks = mesh12
    for axis in ("seq", "expert"):
        assert ranks[0]["raise_" + axis] is None
        assert ranks[0]["bound_" + axis] == data * model


def test_checkpoint_is_the_reference_file(mesh12):
    """Rank 0 writes the gathered parameters; the JAX package loads them
    as they are.  Optimizer-state files under a model axis are written
    too (the whole slots, by rank 0): the reference's payload, a key a
    trainable parameter (plain SGD keeps no slot)."""
    import mxnet_tpu as mx
    from mxnet_tpu_torch.optimizer import load_states

    data, model, outdir, ranks = mesh12
    _, args, _ = mx.model.load_checkpoint(os.path.join(outdir, "lm"), 2)
    for name, w in ranks[0]["lm"]["params"].items():
        np.testing.assert_array_equal(args[name].asnumpy(), w)
    assert ranks[0]["states_error"] is None
    with open(os.path.join(outdir, "lm.states"), "rb") as f:
        states = load_states(f.read())
    assert sorted(states) == sorted(ranks[0]["lm"]["params"])
    assert all(v == () for v in states.values())


# ---------------------------------------------------------------------------
# the plan, the pspecs and the partition rules (single process)
# ---------------------------------------------------------------------------

def _plan_symbols(pkg):
    sym = pkg.sym
    out = {"mlp": _mlp(sym), "convnet": _convnet(sym),
           "tp_mlp": _tp_mlp(sym)[0],
           "tp_attention_lm": _tp_attention_lm(sym)[0],
           "tp_conv_pool": _tp_conv_pool_net(sym)[0]}
    models = _models(pkg)
    lm = models.attention_lm.get_symbol
    out["lm_mha"] = lm(vocab_size=32, seq_len=8, num_layers=2, embed=32,
                       heads=4, ffn_hidden=64)
    out["lm_gqa"] = lm(vocab_size=32, seq_len=8, num_layers=2, embed=32,
                       heads=4, ffn_hidden=64, num_kv_heads=2)
    out["lm_moe"] = lm(vocab_size=32, seq_len=8, num_layers=2, embed=32,
                       heads=4, ffn_hidden=64, moe_experts=4)
    out["resnet50"] = models.resnet.get_symbol(
        num_classes=10, num_layers=50, image_shape=(3, 32, 32))
    for name in ("alexnet", "vgg", "googlenet", "inception_bn",
                 "inception_v3", "resnext", "lenet", "mlp_zoo"):
        fn = {"mlp_zoo": "get_mlp"}.get(name, "get_" + name)
        out["zoo_" + name] = getattr(models, fn)(num_classes=10)
    return out


def test_plan_equals_the_reference_on_every_symbol():
    import mxnet_tpu as mx
    from mxnet_tpu.parallel.tp_rules import plan_tensor_parallel as jplan

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel.tp_rules import plan_tensor_parallel

    with mx.NameManager():
        jsyms = _plan_symbols(mx)
    with mt.NameManager():
        tsyms = _plan_symbols(mt)
    assert set(jsyms) == set(tsyms)
    for name in jsyms:
        want = {k: tuple(v) for k, v in jplan(jsyms[name]).items()}
        got = plan_tensor_parallel(tsyms[name])
        assert got == want, name
        assert want, name


@pytest.mark.parametrize("mesh_shape", [
    {"data": 1, "model": 1}, {"data": 2, "model": 1},
    {"data": 2, "model": 2}, {"data": 1, "model": 4},
    {"data": 2, "seq": 2, "model": 2}])
@pytest.mark.parametrize("kv", [None, 0, 1, 2, 4, 6])
def test_kv_pspecs_equal_the_reference(mesh_shape, kv):
    import warnings

    from mxnet_tpu.parallel import tp_rules as jr

    from mxnet_tpu_torch.parallel import tp_rules as tr

    for fn in ("kv_cache_pspec", "kv_pool_pspec"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jd, td = [], []
            want = getattr(jr, fn)(mesh_shape, num_kv_heads=kv,
                                   degrades=jd)
            got = getattr(tr, fn)(mesh_shape, num_kv_heads=kv, degrades=td)
        assert got == tuple(want) and type(got) is tuple, (fn, got, want)
        assert td == jd


def test_partition_rules_equal_the_reference():
    """match_partition_rules and rules_from_plan equal the reference's,
    coverage records included; build_shardings gives torch placements
    over the same guard (a rank mismatch and an indivisible dim
    replicate, with their degrade records)."""
    from torch.distributed.tensor import Replicate, Shard

    import mxnet_tpu as mx
    from mxnet_tpu.programs import partition as jp
    from mxnet_tpu.parallel.tp_rules import plan_tensor_parallel as jplan

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.programs import partition as tp_
    from mxnet_tpu_torch.parallel.tp_rules import plan_tensor_parallel

    with mx.NameManager():
        jsym = _models(mx).attention_lm.get_symbol(
            vocab_size=17, seq_len=8, num_layers=1, embed=32, heads=4,
            ffn_hidden=64)
    with mt.NameManager():
        tsym = mt.models.attention_lm.get_symbol(
            vocab_size=17, seq_len=8, num_layers=1, embed=32, heads=4,
            ffn_hidden=64)
    shapes = dict(zip(tsym.list_arguments(),
                      tsym.infer_shape(data=(2, 8),
                                       softmax_label=(2, 8))[0]))
    leaves = {n: np.zeros(s, np.float32) for n, s in shapes.items()
              if n not in ("data", "softmax_label")}
    leaves["scalar"] = np.zeros((), np.float32)
    leaves["odd"] = np.zeros((3, 5), np.float32)
    leaves["ranked"] = np.zeros((4,), np.float32)
    jrules = jp.rules_from_plan(jplan(jsym))
    trules = tp_.rules_from_plan(plan_tensor_parallel(tsym))
    assert [(p, tuple(s)) for p, s in jrules] == trules
    hand = [("layer0_ffn.*weight", ("model", None)), ("odd", ("model", None)),
            ("ranked", (None, "model")), (".*_bias$", ("model",))]
    import jax
    from jax.sharding import Mesh

    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                 ("data", "model"))
    for rules in (trules, hand):
        jcov, tcov = {}, {}
        want = jp.match_partition_rules(rules, leaves, coverage=jcov)
        got = tp_.match_partition_rules(rules, leaves, coverage=tcov)
        assert {k: tuple(v) for k, v in want.items()} == got
        assert jcov == tcov
        # the guard: the reference's degrade records, torch's placements
        jcov2, tcov2 = {}, {}
        jsh = jp.build_shardings(jmesh, rules, leaves, coverage=jcov2)
        tsh = tp_.build_shardings({"data": 2, "model": 2}, rules, leaves,
                                  coverage=tcov2)
        assert jcov2 == tcov2
        for name, placements in tsh.items():
            spec = tuple(jsh[name].spec)
            want_pl = tuple(
                next((Shard(d) for d, ax in enumerate(spec) if ax == axis),
                     Replicate()) for axis in ("data", "model"))
            assert placements == want_pl, (name, placements, spec)
    assert tcov2["odd"]["degrade"] == "indivisible"
    assert tcov2["ranked"]["degrade"] == "rank-mismatch"


def test_program_spec_partition_rules_enter_the_fingerprint():
    import torch

    from mxnet_tpu_torch.programs import ProgramSpec

    args = (torch.empty((2, 3), device="meta"),)

    def key(rules):
        return ProgramSpec("p", None, abstract_args=args,
                           partition_rules=rules).fingerprint()

    assert key(None) == key([])
    assert key([("^w$", ("model", None))]) != key(None)
    assert key([("^w$", ("model", None))]) \
        != key([("^w$", (None, "model"))])


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
