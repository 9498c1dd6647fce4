"""The port's KVStore, its policy and the data-parallel surface that
stands on it — ``kvstore.create`` / ``KVStore``, ``model._create_kvstore``,
``parallel.mesh`` / ``parallel.launch``, ``Module`` over several contexts
and its kvstore paths — held against the JAX package on the same numpy
inputs, in one process on the CPU (``tests/test_torch_dist.py`` runs
real process groups).

Tolerances: sums exactly (the same f32 additions); an SGD update 1e-6
relative (the same f32 operations in the same order); a Module's
outputs 1e-5 relative and its gradients 1e-4 relative / 1e-5 absolute
against the JAX package's 8-device mesh (``tests/test_multi_device.py``'s
own tolerances: the mesh sums the batch in another order); optimizer
states 1e-6 relative.
"""
import os
import pickle
import subprocess
import sys
from collections import namedtuple

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import model as jmodel
from mxnet_tpu.parallel import mesh as jmesh

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch.parallel import collectives as tcoll
from mxnet_tpu_torch.parallel import launch as tlaunch
from mxnet_tpu_torch.parallel import mesh as tmesh

SHAPE = (4, 4)
KEYS = [5, 7, 11]
LOCAL_TYPES = ["local", "device", "local_allreduce_cpu",
               "local_allreduce_device", "dist_sync"]


def _both():
    """(package, context) pairs: the JAX package, then the port."""
    return [(mx, mx.cpu()), (mt, mt.cpu())]


def _init_kv(pkg, ctx, kv_type):
    kv = pkg.kvstore.create(kv_type)
    kv.init(3, pkg.nd.zeros(SHAPE, ctx))
    kv.init(KEYS, [pkg.nd.zeros(SHAPE, ctx)] * len(KEYS))
    return kv


def _case_single(pkg, ctx, kv_type):
    kv = _init_kv(pkg, ctx, kv_type)
    kv.push(3, pkg.nd.ones(SHAPE, ctx) * 4)
    out = pkg.nd.zeros(SHAPE, ctx)
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _case_list(pkg, ctx, kv_type):
    kv = _init_kv(pkg, ctx, kv_type)
    vals = np.random.RandomState(0).randn(len(KEYS), *SHAPE).astype(
        np.float32)
    kv.push(KEYS, [pkg.nd.array(v, ctx) for v in vals])
    outs = [pkg.nd.zeros(SHAPE, ctx) for _ in KEYS]
    kv.pull(KEYS, out=outs)
    return [o.asnumpy() for o in outs]


def _case_aggregator(pkg, ctx, kv_type):
    kv = _init_kv(pkg, ctx, kv_type)
    vals = np.random.RandomState(1).randn(4, *SHAPE).astype(np.float32)
    devs = [pkg.cpu(i) for i in range(4)]
    kv.push(3, [pkg.nd.array(v, d) for v, d in zip(vals, devs)])
    outs = [pkg.nd.zeros(SHAPE, d) for d in devs]
    kv.pull(3, out=outs)
    assert np.array_equal(outs[0].asnumpy(), vals[0] + vals[1] + vals[2]
                          + vals[3])
    return [o.asnumpy() for o in outs]


def _case_updater(pkg, ctx, kv_type):
    kv = _init_kv(pkg, ctx, kv_type)

    def updater(key, recv, stored):
        stored += recv * 2

    kv.set_updater(updater)
    kv.push(3, pkg.nd.ones(SHAPE, ctx))
    out = pkg.nd.zeros(SHAPE, ctx)
    kv.pull(3, out=out)
    first = out.asnumpy()
    kv.push(3, [pkg.nd.ones(SHAPE, ctx) for _ in range(4)])
    kv.pull(3, out=out)
    assert np.all(first == 2) and np.all(out.asnumpy() == 2 + 8)
    return [first, out.asnumpy()]


def _case_type_rank(pkg, ctx, kv_type):
    kv = pkg.kvstore.create(kv_type)
    assert (kv.type, kv.rank, kv.num_workers) == (kv_type, 0, 1)
    return [np.array([kv.rank, kv.num_workers])]


def _case_set_optimizer(pkg, ctx, kv_type):
    kv = _init_kv(pkg, ctx, kv_type)
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.7, rescale_grad=0.5,
                                       wd=0.1))
    w0 = np.random.RandomState(2).randn(*SHAPE).astype(np.float32)
    kv2 = pkg.kvstore.create(kv_type)
    kv2.set_optimizer(pkg.optimizer.SGD(learning_rate=1.0, rescale_grad=1.0))
    kv2.init(0, pkg.nd.array(w0, ctx))
    g = np.random.RandomState(3).randn(*SHAPE).astype(np.float32)
    outs = []
    for store, key in ((kv, 3), (kv2, 0)):
        for _ in range(2):
            store.push(key, pkg.nd.array(g, ctx))
        out = pkg.nd.zeros(SHAPE, ctx)
        store.pull(key, out=out)
        outs.append(out.asnumpy())
    return outs


CASES = {"single_kv_pair": _case_single, "list_kv_pair": _case_list,
         "aggregator": _case_aggregator, "updater": _case_updater,
         "type_rank": _case_type_rank, "set_optimizer": _case_set_optimizer}


@pytest.mark.parametrize("kv_type", LOCAL_TYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kvstore_cases_match_jax(case, kv_type):
    """``tests/test_kvstore.py``'s cases through both packages: sums
    exactly, an SGD update within 1e-6 relative."""
    (jpkg, jctx), (tpkg, tctx) = _both()
    want = CASES[case](jpkg, jctx, kv_type)
    with tctx:
        got = CASES[case](tpkg, tctx, kv_type)
    for g, w in zip(got, want):
        if case == "set_optimizer":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        else:
            assert np.array_equal(g, w)


def test_create_refuses_unknown_types_and_keys_map_by_crc32():
    for pkg in (mx, mt):
        with pytest.raises(pkg.MXNetError):
            pkg.kvstore.create("parameter_server")
        with pytest.raises(TypeError):
            pkg.kvstore.create(3)
    for key in ("fc1_weight", "x", 17, ""):
        assert mt.kvstore.KVStore._str_to_int(key) \
            == mx.kvstore.KVStore._str_to_int(key)
    with mt.cpu():
        kv = mt.kvstore.create("local")
        kv.init("w", mt.nd.zeros(SHAPE))
        with pytest.raises(mt.MXNetError):
            kv.init("w", mt.nd.zeros(SHAPE))
        assert kv.num_dead_node() == 0
        kv.send_command_to_servers(0, "")
        with pytest.raises(mt.MXNetError):
            kv.save_optimizer_states("unused")


def test_push_leaves_the_pushed_value_and_stores_a_copy():
    """The store keeps its own copy (torch tensors are mutable, jax
    arrays are not): a pushed value and an initial value stay as they
    were, and writing them later does not reach the store."""
    with mt.cpu():
        kv = mt.kvstore.create("dist_sync")
        init = mt.nd.ones(SHAPE)
        kv.init(0, init)
        g = mt.nd.full(SHAPE, 3.0)
        kv.push(0, g)
        g[:] = 5.0
        init[:] = 7.0
        out = mt.nd.zeros(SHAPE)
        kv.pull(0, out=out)
        assert np.all(out.asnumpy() == 3.0)


_OPTIMIZERS = [("sgd", {"momentum": 0.9, "wd": 0.01}), ("nag",
               {"momentum": 0.9}), ("adam", {}), ("adagrad", {}),
               ("rmsprop", {}), ("adadelta", {}), ("ftrl", {}),
               ("dcasgd", {"momentum": 0.5}), ("test", {}), ("ccsgd", {}),
               ("sgld", {})]


@pytest.mark.parametrize("name,kw", _OPTIMIZERS,
                         ids=[n for n, _ in _OPTIMIZERS])
def test_dist_set_optimizer_round_trips_every_optimizer(name, kw):
    """``set_optimizer`` on a dist store pickles the optimizer (the bound
    symbol detached around the round trip); every optimizer of the port
    survives it, its symbol multipliers kept, and updates as the JAX
    package's dist store does (1e-6 relative; SGLD's noise is torch's:
    finite and repeatable from a seed)."""
    data = mx.sym.Variable("data")
    weight = mx.sym.Variable("fc_weight", attr={"__lr_mult__": "0.5"})
    jnet = mx.sym.FullyConnected(data, weight=weight, num_hidden=4,
                                 name="fc")
    tnet = mt.sym.load_json(jnet.tojson())
    w0 = np.random.RandomState(4).randn(4, 6).astype(np.float32)
    g = np.random.RandomState(5).randn(4, 6).astype(np.float32)
    outs = []
    for pkg, ctx, net in ((mx, mx.cpu(), jnet), (mt, mt.cpu(), tnet)):
        opt = pkg.optimizer.create(name, sym=net, learning_rate=0.1,
                                   rescale_grad=0.5,
                                   param_idx2name={0: "fc_weight"}, **kw)
        with ctx:
            kv = pkg.kvstore.create("dist_sync")
            kv.set_optimizer(opt)
            assert kv._optimizer is not opt and kv._optimizer.sym is net
            assert kv._optimizer.sym_lr_mult == {"fc_weight": 0.5}
            kv.init(0, pkg.nd.array(w0, ctx))
            if pkg is mt:
                import torch

                torch.manual_seed(0)
            for _ in range(3):
                kv.push(0, pkg.nd.array(g, ctx))
            out = pkg.nd.zeros(w0.shape, ctx)
            kv.pull(0, out=out)
            outs.append(out.asnumpy())
    want, got = outs
    assert np.all(np.isfinite(got))
    if name != "sgld":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


Param = namedtuple("Param", "shape")
_BIG = {"w": Param((4097, 4097))}        # 16,785,409 > 16 Mi values
_SMALL = {"w": Param((10, 10)), "b": Param((10,))}


@pytest.mark.parametrize("num_device", [1, 2])
@pytest.mark.parametrize("params", ["small", "big"])
@pytest.mark.parametrize("kv", [None, "local", "device", "dist_sync",
                                "dist_device_sync", "dist_async", "dist",
                                "instance"])
def test_create_kvstore_policy_matches_jax(kv, params, num_device):
    """``model._create_kvstore``'s decision (a store or none, its type,
    ``update_on_kvstore``) over a table of type x device count x largest
    parameter."""
    arg_params = _BIG if params == "big" else _SMALL
    got = []
    for mod, pkg in ((jmodel, mx), (tmodel, mt)):
        arg = pkg.kvstore.create("local") if kv == "instance" else kv
        store, on_kv = mod._create_kvstore(arg, num_device, arg_params)
        got.append((None if store is None else store.type, on_kv,
                    store is arg if kv == "instance" else None))
    assert got[0] == got[1]
    with pytest.raises(TypeError):
        tmodel._create_kvstore(3, 1, _SMALL)


# ---------------------------------------------------------------------------
# parallel.mesh / parallel.launch
# ---------------------------------------------------------------------------

_MESH_CASES = [(8, dict()), (8, dict(data=2, model=2, seq=2)),
               (8, dict(data=-1, model=4)), (6, dict(model=3)),
               (4, dict(data=1, pipe=4)), (12, dict(data=-1, expert=2,
                                                    model=-1))]


@pytest.mark.parametrize("n,cfg", _MESH_CASES)
def test_mesh_arithmetic_matches_jax(n, cfg):
    """``MeshConfig.resolve``, ``rank_devices`` and ``survivor_submesh``
    case by case over device lists (any list: contexts, ranks)."""
    devices = list(range(n))
    jcfg, tcfg = jmesh.MeshConfig(**cfg), tmesh.MeshConfig(**cfg)
    assert tcfg.resolve(n) == jcfg.resolve(n)
    data = jcfg.resolve(n)[0]
    for workers in (1, 2, 3, 4):
        if data % workers:
            with pytest.raises(ValueError):
                tmesh.rank_devices(devices, workers, tcfg)
            continue
        assert tmesh.rank_devices(devices, workers, tcfg) \
            == jmesh.rank_devices(devices, workers, jcfg)
        for survivors in ([0], list(range(workers)), [workers - 1]):
            jd, jc = jmesh.survivor_submesh(devices, workers, survivors,
                                            jcfg)
            td, tc = tmesh.survivor_submesh(devices, workers, survivors,
                                            tcfg)
            assert td == jd and tc.resolve(len(td)) == jc.resolve(len(jd))
            assert (tc.data, tc.model, tc.pipe, tc.seq, tc.expert) \
                == (jc.data, jc.model, jc.pipe, jc.seq, jc.expert)
    with pytest.raises(ValueError):
        tmesh.survivor_submesh(devices, 1, [], tcfg)
    for pkg_mesh in (jmesh, tmesh):
        with pytest.raises(AssertionError):
            pkg_mesh.MeshConfig(data=2, model=2).resolve(n + 2)


def test_build_mesh_needs_a_process_group():
    assert not tcoll.active()
    with pytest.raises(mt.MXNetError, match="launch.init"):
        tmesh.build_mesh()


@pytest.fixture
def fake_group(monkeypatch):
    """``init_process_group`` recorded instead of run."""
    import torch.distributed as dist

    calls = []

    def fake(backend=None, init_method=None, world_size=-1, rank=-1,
             timeout=None, **kw):
        calls.append(dict(backend=backend, init_method=init_method,
                          world_size=world_size, rank=rank,
                          timeout=timeout.total_seconds()))

    for var in ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
                "DMLC_WORKER_ID", "DMLC_RANK", "MASTER_ADDR", "MASTER_PORT",
                "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(dist, "init_process_group", fake)
    monkeypatch.setattr(tlaunch, "_initialized", False)
    yield calls
    tlaunch._initialized = False


@pytest.mark.parametrize("env,want", [
    ({"DMLC_PS_ROOT_URI": "10.0.0.1", "DMLC_PS_ROOT_PORT": "9999",
      "DMLC_NUM_WORKER": "4", "DMLC_WORKER_ID": "2"},
     ("tcp://10.0.0.1:9999", 4, 2)),
    ({"DMLC_PS_ROOT_URI": "10.0.0.1", "DMLC_NUM_WORKER": "3",
      "DMLC_RANK": "1"}, ("tcp://10.0.0.1:9091", 3, 1)),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "7", "WORLD_SIZE": "2",
      "RANK": "1"}, ("tcp://h:7", 2, 1)),
    ({}, None)])
def test_launcher_env_contract(fake_group, monkeypatch, env, want):
    """``launch.init()`` resolves the reference's DMLC_* variables (and
    torchrun's) into ``init_process_group``'s arguments, as the JAX
    package's resolves them into ``jax.distributed.initialize``'s; with
    none a process stays single.  The backend is gloo without a card,
    and a timeout is always given."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tlaunch.init()
    if want is None:
        assert fake_group == []
    else:
        assert fake_group == [dict(backend="gloo", init_method=want[0],
                                   world_size=want[1], rank=want[2],
                                   timeout=tlaunch.DEFAULT_TIMEOUT)]
    tlaunch.init()          # idempotent
    assert len(fake_group) == (0 if want is None else 1)


def test_launcher_jax_env_contract_is_the_same(monkeypatch):
    """The JAX package's launcher reads the same variables into the same
    address, world and rank."""
    import jax

    from mxnet_tpu.parallel import launch as jlaunch

    env = {"DMLC_PS_ROOT_URI": "10.0.0.1", "DMLC_PS_ROOT_PORT": "9999",
           "DMLC_NUM_WORKER": "4", "DMLC_WORKER_ID": "2"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    captured = {}

    def fake_initialize(coordinator_address=None, num_processes=None,
                        process_id=None, **kw):
        captured.update(address=coordinator_address, world=num_processes,
                        rank=process_id)

    monkeypatch.setattr(jax.distributed, "initialize", fake_initialize)
    monkeypatch.setattr(jlaunch, "_initialized", False)
    jlaunch.init()
    jlaunch._initialized = False
    assert tlaunch._env_contract() == (captured["address"], captured["world"],
                                       captured["rank"])


def test_launcher_single_process_then_explicit_group(fake_group):
    """``init()`` with no arguments and no environment leaves the process
    single without closing the door: a later call with arguments still
    forms its group."""
    tlaunch.init()
    assert fake_group == [] and not tlaunch._initialized
    tlaunch.init("127.0.0.1:1234", 2, 1, backend="gloo")
    assert [c["init_method"] for c in fake_group] == [
        "tcp://127.0.0.1:1234"]
    assert tlaunch._initialized


def test_launcher_explicit_arguments_and_no_silent_fallback(fake_group):
    """Explicit arguments win; NCCL without a card raises (no quiet
    gloo), and a failing group start raises MXNetError."""
    import torch
    import torch.distributed as dist

    tlaunch.init("127.0.0.1:1234", 2, 1, backend="gloo", timeout=5)
    assert fake_group == [dict(backend="gloo",
                               init_method="tcp://127.0.0.1:1234",
                               world_size=2, rank=1, timeout=5.0)]
    tlaunch._initialized = False
    if not torch.cuda.is_available():
        assert tlaunch.backend_for() == "gloo"
        with pytest.raises(mt.MXNetError, match="NCCL"):
            tlaunch.init("127.0.0.1:1234", 1, 0, backend="nccl")

    def broken(*a, **kw):
        raise RuntimeError("connection refused")

    dist.init_process_group = broken
    with pytest.raises(mt.MXNetError, match="connection refused"):
        tlaunch.init("127.0.0.1:1234", 1, 0, backend="gloo")
    assert not tlaunch._initialized


def test_collectives_are_the_identity_without_a_group():
    import torch

    x = torch.arange(4.0)
    assert tcoll.global_sum(x) is x
    tcoll.barrier()
    assert (tcoll.world_size(), tcoll.rank()) == (1, 0)
    tlaunch.shutdown()      # nothing to destroy


# ---------------------------------------------------------------------------
# Module over several contexts (tests/test_multi_device.py's cases)
# ---------------------------------------------------------------------------

def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _mlp_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(8, 10).astype(np.float32) * 0.5,
            "fc1_bias": rng.randn(8).astype(np.float32) * 0.1,
            "fc2_weight": rng.randn(4, 8).astype(np.float32) * 0.5,
            "fc2_bias": rng.randn(4).astype(np.float32) * 0.1}


def _bound(pkg, contexts, params, batch=16, kvstore=None, lr=0.1):
    mod = pkg.mod.Module(_mlp(pkg), context=contexts)
    mod.bind(data_shapes=[("data", (batch, 10))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in params.items()})
    if kvstore is not None:
        mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                           optimizer_params={"learning_rate": lr})
    return mod


def _jax_mesh_module(params, **kw):
    return _bound(mx, [mx.cpu(i) for i in range(8)], params, **kw)


@pytest.mark.parametrize("n", [8, 4, 2])
def test_multi_context_forward_and_grads_match_jax_mesh(n):
    """One executor over the whole batch for n CPU contexts: outputs
    within 1e-5 relative and gradients within 1e-4 / 1e-5 of the JAX
    package's 8-device mesh on the same parameters."""
    params = _mlp_params()
    rng = np.random.RandomState(1)
    X = rng.randn(16, 10).astype(np.float32)
    y = rng.randint(0, 4, 16).astype(np.float32)
    jmod = _jax_mesh_module(params)
    assert jmod._exec_group._mesh is not None
    jmod.forward_backward(mx.io.DataBatch([mx.nd.array(X)],
                                          [mx.nd.array(y)]))
    with mt.cpu():
        tmod = _bound(mt, [mt.cpu(i) for i in range(n)], params)
        tmod.forward_backward(mt.io.DataBatch([mt.nd.array(X)],
                                              [mt.nd.array(y)]))
    assert tmod._exec_group.batch_size == 16
    np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                               jmod.get_outputs()[0].asnumpy(), rtol=1e-5,
                               atol=1e-7)
    for name, jg, tg in zip(jmod._exec_group.param_names,
                            jmod._exec_group.grad_arrays,
                            tmod._exec_group.grad_arrays):
        np.testing.assert_allclose(tg.asnumpy(), jg.asnumpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_multi_context_training_learns_like_jax():
    """``fit(kvstore="device")`` over 4 contexts learns (accuracy > 0.9)
    as the JAX package's 4-device mesh does, from the same parameters;
    the device store holds the copies while the compiled step owns the
    update."""
    rng = np.random.RandomState(0)
    X = rng.randn(400, 10).astype(np.float32)
    W = np.random.RandomState(99).randn(10, 4).astype(np.float32)
    y = np.argmax(X @ W, axis=1).astype(np.float32)
    np.random.seed(7)  # Xavier draws from the global numpy generator
    init = mx.mod.Module(_mlp(mx), context=mx.cpu())
    init.bind(data_shapes=[("data", (40, 10))],
              label_shapes=[("softmax_label", (40,))])
    init.init_params(mx.initializer.Xavier())
    params = {k: v.asnumpy() for k, v in init.get_params()[0].items()}
    accs = []
    for pkg, ctxs in ((mx, [mx.cpu(i) for i in range(4)]),
                      (mt, [mt.cpu(i) for i in range(4)])):
        with mt.cpu():
            it = pkg.io.NDArrayIter(X, y, batch_size=40)
            mod = pkg.mod.Module(_mlp(pkg), context=ctxs)
            mod.fit(it, arg_params={k: pkg.nd.array(v, pkg.cpu())
                                    for k, v in params.items()},
                    optimizer="sgd",
                    optimizer_params={"learning_rate": 0.5}, num_epoch=5,
                    kvstore="device")
            accs.append(dict(mod.score(it, "acc"))["accuracy"])
            assert mod._kvstore.type == "device"
            assert mod._update_on_kvstore is False
    assert min(accs) > 0.9, accs
    assert mod._train_step is not None


def test_batch_not_divisible_raises():
    for pkg in (mx, mt):
        with mt.cpu():
            mod = pkg.mod.Module(_mlp(pkg),
                                 context=[pkg.cpu(i) for i in range(3)])
            with pytest.raises(Exception, match="divisible"):
                mod.bind(data_shapes=[("data", (16, 10))])


def test_fake_context_ids_fall_back():
    """Contexts that share hardware bind one unsharded executor, in both
    packages; the outputs agree."""
    params = _mlp_params(3)
    x = np.random.RandomState(2).randn(4, 10).astype(np.float32)
    outs = []
    for pkg in (mx, mt):
        with mt.cpu():
            mod = _bound(pkg, [pkg.cpu(0), pkg.cpu(8)], params, batch=4)
            mod.forward(pkg.io.DataBatch([pkg.nd.array(x)],
                                         [pkg.nd.zeros((4,))]),
                        is_train=False)
            outs.append(mod.get_outputs()[0].asnumpy())
    assert outs[1].shape == (4, 4)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-7)


def test_distinct_cards_are_refused_with_the_dist_path_named():
    """A context list over distinct cards (or the host and a card) is
    refused before anything is allocated, naming the port's data
    parallelism: one process a card under parallel.launch, dist_sync."""
    for ctxs in ([mt.gpu(0), mt.gpu(1)], [mt.cpu(), mt.gpu(0)]):
        with pytest.raises(mt.MXNetError,
                           match="parallel.launch.init.*dist_sync"):
            mt.mod.Module(_mlp(mt), context=ctxs)
    with pytest.raises(mt.MXNetError):
        mt.mod.Module(_mlp(mt), context=[])


# ---------------------------------------------------------------------------
# Module's kvstore paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_type", ["dist_sync", "dist_device_sync",
                                     "dist_async", "dist"])
def test_compiled_step_refused_for_dist(kv_type):
    """A dist store keeps the eager path (no collective inside a captured
    graph), with the update on the store, as in the JAX package."""
    params = _mlp_params()
    jmod = _bound(mx, mx.cpu(), params, kvstore=kv_type)
    with mt.cpu():
        tmod = _bound(mt, mt.cpu(), params, kvstore=kv_type)
    assert tmod._train_step is None and jmod._fused_step is None
    assert tmod._update_on_kvstore is True is jmod._update_on_kvstore
    assert tmod._updater is None and tmod._kvstore.type == kv_type
    with mt.cpu():
        local = _bound(mt, [mt.cpu(0), mt.cpu(1)], params, kvstore="device")
    assert local._train_step is not None
    assert local._update_on_kvstore is False and local._updater is not None


@pytest.mark.parametrize("kv_type,workers", [("dist_sync", 4),
                                             ("dist_device_sync", 3),
                                             ("dist_async", 2),
                                             ("dist", 4), ("device", 1)])
def test_rescale_grad_counts_the_workers(monkeypatch, kv_type, workers):
    """``rescale_grad`` = 1 / (batch x workers) for ``dist*_sync``, 1 /
    batch otherwise — the JAX package's rule, its worker count patched
    the same way."""
    monkeypatch.setattr(tcoll, "world_size", lambda: workers)
    monkeypatch.setattr(mx.kvstore.KVStore, "num_workers",
                        property(lambda self: workers
                                 if self._type.startswith("dist") else 1))
    params = _mlp_params()
    ctx = [mx.cpu(0), mx.cpu(1)]
    jmod = _bound(mx, ctx, params, kvstore=kv_type)
    with mt.cpu():
        tmod = _bound(mt, [mt.cpu(0), mt.cpu(1)], params, kvstore=kv_type)
    assert tmod._kvstore.num_workers == workers or kv_type == "device"
    assert tmod._optimizer.rescale_grad == jmod._optimizer.rescale_grad
    want = 1.0 / (16 * (workers if "_sync" in kv_type else 1))
    assert tmod._optimizer.rescale_grad == want


@pytest.mark.parametrize("mode", ["dist_sync", "device", "device_monitored"])
def test_module_update_through_the_store_matches_jax(mode):
    """Two steps through each update path of the port against the JAX
    package's eager update on one context (its ``dist_sync`` store, or no
    store: the JAX package's eager kvstore path over a two-device mesh
    mixes the mesh's and one device's arrays and raises), 1e-6 relative.
    ``dist_sync``: push (the store's updater) and pull into the weight;
    ``device`` over two contexts, compiled step off: the same through
    the device store; ``device_monitored``: the compiled step owns the
    update (``update_on_kvstore`` dropped) until a monitor drops the
    step, then push / pull into the gradient and ``update_multi``."""
    params = _mlp_params(5)
    rng = np.random.RandomState(6)
    batches = [(rng.randn(16, 10).astype(np.float32),
                rng.randint(0, 4, 16).astype(np.float32)) for _ in range(2)]
    dist = mode == "dist_sync"
    kv_type = "dist_sync" if dist else "device"
    runs = ((mx, mx.cpu(), kv_type if dist else "local"),
            (mt, mt.cpu() if dist else [mt.cpu(0), mt.cpu(1)], kv_type))
    outs = []
    fused = mode == "device_monitored"
    with mx.config.overrides(MXNET_FUSED_TRAIN_STEP=False), \
            mt.config.overrides(MXNET_FUSED_TRAIN_STEP=fused), mt.cpu():
        for pkg, ctx, kv in runs:
            mod = _bound(pkg, ctx, params, kvstore=kv, lr=0.3)
            if fused and pkg is mt:
                assert mod._train_step is not None
                mod.install_monitor(mt.monitor.Monitor(1000))
            for x, y in batches:
                mod.forward_backward(pkg.io.DataBatch([pkg.nd.array(x)],
                                                      [pkg.nd.array(y)]))
                mod.update()
            outs.append({k: v.asnumpy() for k, v in
                         mod.get_params()[0].items()})
    assert mod._kvstore.type == kv_type and mod._train_step is None
    assert mod._update_on_kvstore is not fused
    for name in params:
        assert not np.array_equal(outs[1][name], params[name])
        np.testing.assert_allclose(outs[1][name], outs[0][name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_optimizer_states_through_the_store(tmp_path):
    """Under ``update_on_kvstore`` the states are the store's: saved
    after two SGD-momentum steps they equal the JAX store's momenta
    (1e-6 relative), and a module that loads them continues bit for bit
    as the uninterrupted one."""
    params = _mlp_params(8)
    rng = np.random.RandomState(9)
    batches = [(rng.randn(16, 10).astype(np.float32),
                rng.randint(0, 4, 16).astype(np.float32)) for _ in range(3)]
    opt = {"learning_rate": 0.2, "momentum": 0.9}

    def module(pkg, ctx, start=params):
        # a resumed module takes its weights as fit(arg_params=) does
        mod = pkg.mod.Module(_mlp(pkg), context=ctx)
        mod.bind(data_shapes=[("data", (16, 10))],
                 label_shapes=[("softmax_label", (16,))])
        mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                    for k, v in start.items()})
        mod.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                           optimizer_params=opt)
        return mod

    def step(pkg, mod, i):
        x, y = batches[i]
        mod.forward_backward(pkg.io.DataBatch([pkg.nd.array(x)],
                                              [pkg.nd.array(y)]))
        mod.update()

    jmod = module(mx, mx.cpu())
    for i in range(2):
        step(mx, jmod, i)
    fname = str(tmp_path / "s.states")
    with mt.cpu():
        tmod = module(mt, mt.cpu())
        for i in range(2):
            step(mt, tmod, i)
        tmod.save_optimizer_states(fname)
        with open(fname, "rb") as f:
            saved = pickle.load(f)
        jstates = jmod._kvstore._updater.states
        for idx, name in enumerate(jmod._exec_group.param_names):
            np.testing.assert_allclose(saved[name][0],
                                       jstates[idx].asnumpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
        resumed = module(mt, mt.cpu(), {k: v.asnumpy() for k, v in
                                         tmod.get_params()[0].items()})
        resumed.load_optimizer_states(fname)
        step(mt, tmod, 2)
        step(mt, resumed, 2)
        a, b = tmod.get_params()[0], resumed.get_params()[0]
        for name in params:
            assert np.array_equal(a[name].asnumpy(), b[name].asnumpy())


def test_store_holds_the_executors_weights():
    """Under ``update_on_kvstore`` the store holds the executor's weight
    arrays themselves: weights set after ``init_optimizer`` reach the
    store, and the next step equals, bit for bit, that of a module that
    had them from the start; the module's optimizer is the store's."""
    params, later = _mlp_params(10), _mlp_params(11)
    rng = np.random.RandomState(12)
    x = rng.randn(16, 10).astype(np.float32)
    y = rng.randint(0, 4, 16).astype(np.float32)
    outs = []
    with mt.cpu():
        for start, reset in ((params, later), (later, None)):
            mod = _bound(mt, mt.cpu(), start, kvstore="dist_sync", lr=0.3)
            group = mod._exec_group
            assert all(mod._kvstore._store[i] is w
                       for i, w in enumerate(group.param_arrays))
            assert mod._optimizer is mod._kvstore._optimizer
            if reset is not None:
                mod.set_params({k: mt.nd.array(v) for k, v in
                                reset.items()}, {})
            mod.forward_backward(mt.io.DataBatch([mt.nd.array(x)],
                                                 [mt.nd.array(y)]))
            mod.update()
            outs.append({k: v.asnumpy() for k, v in
                         mod.get_params()[0].items()})
    for name in params:
        assert not np.array_equal(outs[0][name], later[name])
        assert np.array_equal(outs[0][name], outs[1][name]), name


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 5e-3})])
def test_dist_fit_killed_and_resumed_equals_the_uninterrupted(
        tmp_path, monkeypatch, opt, kw):
    """``fit(kvstore="dist_sync")`` (a world of one, no group) killed at
    step 7 and resumed through a Checkpointer from the step-6 fence ends
    bit for bit on the uninterrupted run's parameters: the restore
    writes the store's weights, and the fence carries the store
    updater's states and counts."""
    from mxnet_tpu_torch import elastic

    monkeypatch.delenv("MXNET_HEARTBEAT_DIR", raising=False)
    monkeypatch.delenv("MXNET_CKPT_DIR", raising=False)
    params = _mlp_params(13)
    rng = np.random.RandomState(14)
    X = rng.randn(64, 10).astype(np.float32)
    Y = rng.randint(0, 4, 64).astype(np.float32)

    def fit(ctl=None):
        mt.random.seed(3)
        mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=16), optimizer=opt,
                optimizer_params=kw, kvstore="dist_sync", num_epoch=3,
                arg_params={k: mt.nd.array(v) for k, v in params.items()},
                elastic=ctl)
        assert mod._update_on_kvstore and mod._train_step is None
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    d = str(tmp_path / "fences")
    with mt.cpu():
        whole = fit()
        with pytest.raises(elastic.WorkerKilled):
            fit(elastic.ElasticController(
                checkpointer=elastic.Checkpointer(d, period=3,
                                                  async_write=False),
                injector=elastic.FaultInjector().kill_at(7)))
        assert sorted(os.listdir(os.path.join(d, "6"))) == [
            ".metadata", "__0_0.distcp", "commit_success.txt",
            "elastic.json"]
        ctl = elastic.ElasticController(
            checkpointer=elastic.Checkpointer(d, period=3,
                                              async_write=False))
        resumed = fit(ctl)
    assert ctl.recoveries == 1
    for name in params:
        assert np.array_equal(resumed[name], whole[name]), name


def test_server_role_exits_at_import():
    """A process started with ``DMLC_ROLE=server`` exits 0 at ``import
    mxnet_tpu_torch`` and never runs the script's body."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DMLC_ROLE="server")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", "import mxnet_tpu_torch; "
                          "print('SCRIPT_BODY_RAN')"], capture_output=True,
                         text=True, env=env, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "SCRIPT_BODY_RAN" not in out.stdout


def test_context_type_ids_match_jax():
    for name, tid in mt.Context.devstr2type.items():
        assert mx.Context.devstr2type[name] == tid
        assert mt.Context.devtype2str[tid] == mx.Context.devtype2str[tid]
        ctx = mt.Context(name, 3)
        assert (ctx.device_type, ctx.device_typeid, ctx.device_id) \
            == (name, tid, 3)
        assert mt.Context(ctx) == ctx
    assert mt.Context("cpu_pinned").torch_device.type == "cpu"
    with pytest.raises(mt.MXNetError):
        mt.Context("tpu")


def test_bandwidth_tool_smoke():
    """``tools/bandwidth_torch.py --smoke``: a world of one on gloo, the
    all-reduce and broadcast timed at two sizes, one JSON line, the group
    destroyed."""
    import json

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "tools/bandwidth_torch.py",
                          "--smoke"], capture_output=True, text=True,
                         env=env, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert (report["backend"], report["world"], report["rank"],
            report["device"]) == ("gloo", 1, 0, "cpu")
    assert [r["bytes"] for r in report["rows"]] == [2 ** 18, 2 ** 20]
    for r in report["rows"]:
        assert r["all_reduce_s"] > 0 and r["broadcast_s"] > 0
        assert r["h2d_gbps"] is None


def test_feedforward_and_bucketing_pass_the_store_through():
    """``FeedForward``'s context list and kvstore reach its Module (a
    device store over two contexts), and a ``BucketingModule``'s buckets
    borrow the primary's dist store and its update-on-store policy."""
    rng = np.random.RandomState(11)
    X = rng.randn(32, 10).astype(np.float32)
    y = rng.randint(0, 4, 32).astype(np.float32)
    with mt.cpu():
        ff = mt.model.FeedForward(_mlp(mt), ctx=[mt.cpu(0), mt.cpu(1)],
                                  num_epoch=1, numpy_batch_size=16,
                                  learning_rate=0.1)
        ff.fit(X, y, kvstore="device")
        assert ff._module._kvstore.type == "device"
        assert ff._module._contexts == [mt.cpu(0), mt.cpu(1)]

        def sym_gen(key):
            return _mlp(mt), ("data",), ("softmax_label",)

        bmod = mt.mod.BucketingModule(sym_gen, default_bucket_key=16,
                                      context=mt.cpu())
        bmod.bind(data_shapes=[("data", (16, 10))],
                  label_shapes=[("softmax_label", (16,))])
        bmod.init_params(arg_params={k: mt.nd.array(v) for k, v in
                                     _mlp_params(12).items()})
        bmod.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                            optimizer_params={"learning_rate": 0.1})
        before = bmod.get_params()[0]["fc1_weight"].asnumpy()
        for key in (16, 8):
            batch = mt.io.DataBatch([mt.nd.array(X[:16])],
                                    [mt.nd.array(y[:16])],
                                    bucket_key=key,
                                    provide_data=[("data", (16, 10))],
                                    provide_label=[("softmax_label",
                                                    (16,))])
            bmod.forward_backward(batch)
            bmod.update()
        primary = bmod._primary
        assert len(bmod._buckets) == 2
        for m in bmod._buckets.values():
            assert m._kvstore is primary._kvstore
            assert m._update_on_kvstore is True and m._train_step is None
        assert not np.array_equal(
            bmod.get_params()[0]["fc1_weight"].asnumpy(), before)
