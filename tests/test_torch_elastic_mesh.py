"""The elastic mesh through the port: a mesh ``Module``'s fit shrinks
and regrows over a re-formed process group (``ElasticController``,
``Module.reconfigure``, ``parallel.launch.abandon`` / ``reform``), a real
death is survived, and sharded DCP fences cross mesh widths; over gloo
ranks on the CPU, against the JAX package's own elastic and sharded-
checkpoint tests (``tests/test_elastic.py``,
``tests/test_sharded_checkpoint.py``) on its virtual-device harness.

This file is its own worker: ``python tests/test_torch_elastic_mesh.py
<mode> <rank> 4 <host:port> <host:port2> <workdir>`` runs one rank (it
imports only PyTorch and the port) and writes ``<mode>_r<rank>.pkl``:

* ``shrink``: the reference's ``test_shrink_and_regrow_data_axis`` at 4
  ranks: two workers of two ranks each over ``MeshConfig(data=4)``
  (the reference's 8 devices held at 4 ranks), worker 1's stamp stale at
  step 6 and back at step 14 (``FaultInjector``), fences every 2 steps;
  held to the JAX Module's same run on 4 devices (parameters at ``|d| <=
  1e-5 + 1e-4 |x|``: f32 sums in another order);
* ``death``: the same fit where worker 1's two processes ``os._exit`` at
  step 5; the survivors finish at ``data=2``, re-formed within
  DEATH_BOUND_S of the death (a stamp of this host whose process is gone
  reads dead at once); ``replace``: the same death, then two processes
  started anew as ranks 2 and 3 (mode ``rejoin``: ``launch.rejoin``)
  take worker 1's place and the mesh regrows to ``data=4``;
* ``ckpt``: the reference's sharded-checkpoint cases at ``(data=2,
  model=2)``: the round trip, Adam slots resuming training, a torn step
  skipped, a slotless restore synthesizing fresh slots, a ``.states``
  round trip, and the cross-width restores: one process into the mesh,
  the mesh into ``(data=1, model=2)`` (ranks 0 and 1 re-form a group of
  2 at the second address) and into one process with no group (rank 0).
"""
import functools
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
PROC_TIMEOUT = 240
DEATH_TIMEOUT = 120      # the death case's own limit: a hang fails it
DEATH_BOUND_S = 20.0     # death -> first step after the re-form
WORLD = 4
TOL_ABS, TOL_REL = 1e-5, 1e-4
TIMELINE = ("fit_epoch", "heartbeat_shrink", "heartbeat_regrow",
            "elastic_shrink", "elastic_regrow", "ckpt_fence", "ckpt_commit")


def _net(sym, hidden=16, classes=4):
    s = sym.FullyConnected(sym.Variable("data"), num_hidden=hidden,
                           name="fc1")
    s = sym.Activation(s, act_type="relu")
    s = sym.FullyConnected(s, num_hidden=classes, name="fc2")
    return sym.SoftmaxOutput(s, name="softmax")


def _dataset(n, features=8, classes=4, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, features)).astype(np.float32)
    Y = rng.randint(0, classes, size=(n,)).astype(np.float32)
    return X, Y


def _params(seed=11, hidden=16, classes=4, features=8):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": 0.3 * rng.randn(hidden, features),
            "fc1_bias": 0.1 * rng.randn(hidden),
            "fc2_weight": 0.3 * rng.randn(classes, hidden),
            "fc2_bias": 0.1 * rng.randn(classes)}


def _numpy(params):
    return {k: v.asnumpy().copy() for k, v in params.items()}


def _elastic_fit(pkg, ctx, mesh_config, workdir, injector, seen):
    """The reference's shrink / regrow fit: 160 samples, batch 16 (10
    steps an epoch), Adam 5e-3, 2 epochs, fences every 2 steps, a monitor
    over 2 workers.  Returns (module, controller)."""
    from importlib import import_module

    el = import_module(pkg.__name__ + ".elastic")
    health = import_module(pkg.__name__ + ".parallel.health")
    hb, ck = os.path.join(workdir, "hb"), os.path.join(workdir, "ck")
    worker = 0 if pkg.__name__ == "mxnet_tpu" else seen["worker"]
    mon = health.FailureMonitor(hb, num_workers=2, my_rank=worker,
                                timeout=1e6, grace=0)
    ctl = el.ElasticController(
        checkpointer=el.Checkpointer(ck, period=2, async_write=False),
        monitor=mon, injector=injector)
    X, Y = _dataset(160)
    kw = {"compute_dtype": "float32"} if pkg.__name__ == "mxnet_tpu" else {}
    mod = pkg.mod.Module(_net(pkg.sym), context=ctx,
                         mesh_config=mesh_config, **kw)

    def cb(p):
        mesh = getattr(mod._exec_group, "_mesh", None) \
            if pkg.__name__ == "mxnet_tpu" else mod._mesh
        data = (dict(mesh.shape)["data"] if pkg.__name__ == "mxnet_tpu"
                else mesh.data) if mesh is not None else 1
        seen["steps"].append((p.epoch, p.nbatch, data, time.time()))
        if data == 2 and seen.get("slow"):
            time.sleep(seen["slow"])     # the replacement's start-up

    mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=16), optimizer="adam",
            optimizer_params={"learning_rate": 5e-3},
            arg_params={k: pkg.nd.array(v.astype(np.float32))
                        for k, v in _params().items()},
            num_epoch=2, eval_metric="acc", batch_end_callback=cb,
            elastic=ctl)
    return mod, ctl


# ---------------------------------------------------------------------------
# the worker (one rank)
# ---------------------------------------------------------------------------

def _shrink_rank(mt, rank, workdir, mode="shrink"):
    from mxnet_tpu_torch import elastic, obs
    from mxnet_tpu_torch.parallel import MeshConfig, collectives
    from mxnet_tpu_torch.parallel.health import Heartbeat

    hb = os.path.join(workdir, "hb")
    worker = rank // 2
    if mode != "rejoin":
        if rank % 2 == 0:
            Heartbeat(hb, worker).beat()      # once: no stamping thread
        collectives.barrier()
    inj = elastic.FaultInjector()
    seen = {"worker": worker, "steps": [],
            "slow": 1.0 if mode == "replace" else 0.0}
    if mode in ("death", "replace"):
        if worker == 1:
            def _die():
                with open(os.path.join(workdir, "death_%d" % rank),
                          "w") as f:
                    f.write(repr(time.time()))
                os._exit(0)
            inj.at_step(5, _die)
    elif mode == "shrink":
        inj.stale_heartbeat_at(6, hb, 1, age=1e9)
        inj.revive_heartbeat_at(14, hb, 1)
    mod, ctl = _elastic_fit(mt, mt.cpu(), MeshConfig(data=4), workdir, inj,
                            seen)
    params = _numpy(mod.get_params()[0]) if not ctl.left else None
    names = sorted({e.get("name") for e in obs.timeline.export()
                    ["traceEvents"]})
    return {"steps": seen["steps"], "recoveries": ctl.recoveries,
            "params": params, "timeline": names, "left": ctl.left,
            "reform": ctl.last_reform,
            "world": collectives.world_size()}


def _fit_some(mt, mod, seed=0, epochs=2):
    """The reference's ``_train_some``: 64 samples, batch 16, Adam 5e-3,
    from seeded parameters."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = rng.randint(0, 4, size=(64,)).astype(np.float32)
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=16), optimizer="adam",
            optimizer_params={"learning_rate": 5e-3},
            arg_params={k: mt.nd.array(v.astype(np.float32))
                        for k, v in _params(seed + 11).items()},
            num_epoch=epochs, force_init=True)
    return x


def _slots(mod):
    """``{name: [whole slot arrays]}``: a captured step's, or a mesh
    rank's updater's gathered over the model group (a collective)."""
    if mod._train_step is not None:
        return {n: [t.detach().numpy().copy() for t in s]
                for n, s in mod._train_step.slots.items()}
    tp = mod._exec_group.tp
    local = mod._exec_group.exec_.arg_dict
    out = {}
    for name, slots in sorted(mod._mesh_slots().items()):
        out[name] = [(tp.unshard(name, t) if tuple(t.shape)
                      == tuple(local[name].shape) else t).numpy().copy()
                     for t in slots]
    return out


def _predict(mt, mod, x):
    mod.forward(mt.io.DataBatch([mt.nd.array(x[:16])], []), is_train=False)
    return mod.get_outputs()[0].asnumpy()


def _mesh_module(mt, mc, for_training=True):
    mod = mt.mod.Module(_net(mt.sym), context=mt.cpu(), mesh_config=mc)
    if not for_training:
        mod.bind(data_shapes=[("data", (16, 8))], for_training=False)
        mod.init_params(arg_params={k: mt.nd.array(v.astype(np.float32))
                                    for k, v in _params(31).items()})
    return mod


def _ckpt_rank(mt, rank, address, address2, workdir):
    from mxnet_tpu_torch import checkpoint
    from mxnet_tpu_torch.elastic import FaultInjector
    from mxnet_tpu_torch.parallel import MeshConfig, collectives, launch

    res = {}
    single_dir = os.path.join(workdir, "single")
    mesh_dir = os.path.join(workdir, "mesh")
    if rank == 0:
        # one process, no group: the checkpoint the mesh restores
        one = mt.mod.Module(_net(mt.sym), context=mt.cpu())
        _fit_some(mt, one, seed=1)
        checkpoint.save_sharded(single_dir, 1, one)
        res["single"] = {"params": _numpy(one.get_params()[0]),
                         "slots": _slots(one),
                         "files": sorted(os.listdir(
                             os.path.join(single_dir, "1")))}
        with open(os.path.join(workdir, "single.pkl"), "wb") as f:
            pickle.dump(res["single"], f)
    launch.init(address, WORLD, rank, backend="gloo", timeout=120)
    mc = MeshConfig(data=2, model=2)
    # the round trip and the slots (the reference's
    # test_roundtrip_mesh_sharded, test_restore_resumes_fused_training)
    mod = _mesh_module(mt, mc)
    x = _fit_some(mt, mod)
    ref_out = _predict(mt, mod, x)
    ref_params = _numpy(mod.get_params()[0])
    ref_slots = _slots(mod)
    path = checkpoint.save_sharded(mesh_dir, 3, mod)
    mod.save_optimizer_states(os.path.join(workdir, "mesh.states"))
    from torch.distributed.checkpoint import FileSystemReader

    chunks = {}
    for index, info in FileSystemReader(path).read_metadata() \
            .storage_data.items():
        chunks.setdefault(index.fqn, []).append(info.relative_path)
    res["saved"] = {"params": ref_params, "slots": ref_slots,
                    "out": ref_out, "path": path, "chunks": chunks,
                    "files": sorted(os.listdir(path)),
                    "local": {n: list(mod._exec_group.exec_.arg_dict[n]
                                      .shape) for n in ref_params}}
    mod2 = _mesh_module(mt, mc)
    _fit_some(mt, mod2, seed=5, epochs=1)
    checkpoint.load_sharded(mesh_dir, 3, mod2)
    res["restored"] = {"params": _numpy(mod2.get_params()[0]),
                       "slots": _slots(mod2),
                       "out": _predict(mt, mod2, x)}
    _fit_some(mt, mod2, seed=4, epochs=1)       # training continues
    res["continued"] = _numpy(mod2.get_params()[0])
    # a torn step (test_latest_step_skips_torn_checkpoint)
    if rank == 0:
        torn = FaultInjector.torn_checkpoint(mesh_dir, 9)
    collectives.barrier()
    res["torn"] = [checkpoint.latest_step(mesh_dir),
                   checkpoint.is_committed(mesh_dir, 9)]
    collectives.barrier()
    if rank == 0:
        import shutil

        shutil.rmtree(torn)
    collectives.barrier()
    # a slotless restore (test_slotless_restore_synthesizes_fresh_slots)
    infer = _mesh_module(mt, mc, for_training=False)
    checkpoint.save_sharded(os.path.join(workdir, "infer"), 0, infer)
    trained = _mesh_module(mt, mc)
    _fit_some(mt, trained, seed=2, epochs=1)
    res["slotless_before"] = max(float(np.abs(a).max()) for s in
                                 _slots(trained).values() for a in s)
    checkpoint.load_sharded(os.path.join(workdir, "infer"), 0, trained)
    res["slotless"] = {"params": _numpy(trained.get_params()[0]),
                       "want": _numpy(infer.get_params()[0]),
                       "slots": _slots(trained)}
    _fit_some(mt, trained, seed=4, epochs=1)
    # the .states round trip under model = 2
    mod3 = _mesh_module(mt, mc)
    _fit_some(mt, mod3, seed=6, epochs=1)
    mod3.load_optimizer_states(os.path.join(workdir, "mesh.states"))
    res["states"] = _slots(mod3)
    # one process into the mesh
    mod4 = _mesh_module(mt, mc)
    _fit_some(mt, mod4, seed=7, epochs=1)
    checkpoint.load_sharded(single_dir, 1, mod4)
    res["from_single"] = {"params": _numpy(mod4.get_params()[0]),
                          "slots": _slots(mod4)}
    launch.shutdown()
    if rank < 2:
        # the mesh into (data=1, model=2)
        launch.init(address2, 2, rank, backend="gloo", timeout=120)
        mod5 = _mesh_module(mt, MeshConfig(data=1, model=2))
        _fit_some(mt, mod5, seed=8, epochs=1)
        checkpoint.load_sharded(mesh_dir, 3, mod5)
        res["to_d1m2"] = {"params": _numpy(mod5.get_params()[0]),
                          "slots": _slots(mod5),
                          "out": _predict(mt, mod5, x)}
        launch.shutdown()
    if rank == 0:
        # the mesh into one process with no group; its .states file too
        one = mt.mod.Module(_net(mt.sym), context=mt.cpu())
        _fit_some(mt, one, seed=9, epochs=1)
        checkpoint.load_sharded(mesh_dir, 3, one)
        res["to_single"] = {"params": _numpy(one.get_params()[0]),
                            "slots": _slots(one),
                            "out": _predict(mt, one, x)}
        one.load_optimizer_states(os.path.join(workdir, "mesh.states"))
        res["states_single"] = _slots(one)
    return res


def _worker_main(argv):
    mode, rank, world, address, address2, workdir = argv
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel import launch

    with mt.cpu():
        if mode == "ckpt":
            res = _ckpt_rank(mt, rank, address, address2, workdir)
        else:
            if mode == "rejoin":
                launch.rejoin(os.path.join(workdir, "hb"), rank, world,
                              num_workers=2, backend="gloo", timeout=120)
            else:
                launch.init(address, world, rank, backend="gloo",
                            timeout=120)
            res = _shrink_rank(mt, rank, workdir, mode)
            launch.abandon()
    with open(os.path.join(workdir, "%s_r%d.pkl" % (mode, rank)), "wb") as f:
        pickle.dump(res, f)
    print("ELASTIC_MESH_RANK_%d_OK" % rank, flush=True)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_shrink(workdir):
    """The JAX Module's shrink / regrow fit on 4 devices: its
    parameters."""
    import jax

    import mxnet_tpu as mx
    from mxnet_tpu import elastic as jel
    from mxnet_tpu.parallel import MeshConfig
    from mxnet_tpu.parallel.health import Heartbeat

    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual-device harness")
    hb = os.path.join(workdir, "hb")
    Heartbeat(hb, 0).beat()
    Heartbeat(hb, 1).beat()
    inj = (jel.FaultInjector().stale_heartbeat_at(6, hb, 1, age=1e9)
           .revive_heartbeat_at(14, hb, 1))
    seen = {"steps": []}
    mod, ctl = _elastic_fit(mx, [mx.cpu(i) for i in range(4)],
                            MeshConfig(data=4), workdir, inj, seen)
    assert ctl.recoveries == 2
    return _numpy(mod.get_params()[0]), [s[2] for s in seen["steps"]]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(mode, workdir, ranks=range(WORLD)):
    addresses = ["127.0.0.1:%d" % _free_port() for _ in range(2)]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    os.makedirs(workdir, exist_ok=True)
    return [subprocess.Popen(
        [sys.executable, HERE, mode, str(r), str(WORLD)] + addresses
        + [workdir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True, cwd=ROOT) for r in ranks]


def _collect(procs, mode, workdir, timeout=PROC_TIMEOUT, ranks=None,
             names=None):
    """The ranks' readings ({rank: reading}) and outputs; ``procs[i]``
    runs rank ``names[i]`` (default i); ``ranks`` those that must end
    OK."""
    names = list(range(len(procs))) if names is None else list(names)
    outs = []
    deadline = time.time() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = names if ranks is None else ranks
    got = {}
    for i, r in enumerate(names):
        if r not in ranks:
            continue
        assert procs[i].returncode == 0 \
            and "ELASTIC_MESH_RANK_%d_OK" % r in outs[i], \
            "rank %d:\n%s" % (r, outs[i][-6000:])
        with open(os.path.join(workdir, "%s_r%d.pkl" % (mode, r)),
                  "rb") as f:
            got[r] = pickle.load(f)
    return got, outs


@pytest.fixture(scope="module")
def shrink(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("elastic_shrink"))
    procs = _spawn("shrink", os.path.join(workdir, "port"))
    jax_params, jax_datas = _jax_shrink(os.path.join(workdir, "jax"))
    got, _ = _collect(procs, "shrink", os.path.join(workdir, "port"))
    return got, jax_params, jax_datas


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("elastic_ckpt"))
    got, _ = _collect(_spawn("ckpt", workdir), "ckpt", workdir)
    return got


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL_REL, atol=TOL_ABS, err_msg=what)


# ---------------------------------------------------------------------------
# shrink and regrow
# ---------------------------------------------------------------------------

def test_shrink_and_regrow_data_axis(shrink):
    """Worker 1 stale at step 6, back at step 14: the data axis reads 4,
    then 2, then 4 at the end; ``recoveries == 2`` on every rank; each
    epoch covers batches 0..9 (no step skipped); the parameters are
    finite and equal on every rank; the survivors trained through steps
    7-14 alone (the standing-by ranks ran no step there)."""
    got, _, _ = shrink
    datas = [s[2] for s in got[0]["steps"]]
    assert 4 in datas and 2 in datas and datas[-1] == 4, datas
    assert datas.index(2) > 0 and datas[:datas.index(2)] == \
        [4] * datas.index(2)
    for r, rk in got.items():
        assert rk["recoveries"] == 2, (r, rk["recoveries"])
        assert not rk["left"] and rk["world"] == 4
        for name, w in rk["params"].items():
            assert np.isfinite(w).all(), (r, name)
            np.testing.assert_array_equal(w, got[0]["params"][name])
    for ep in (0, 1):
        covered = sorted({n for (e, n, _, _) in got[0]["steps"] if e == ep})
        assert covered == list(range(10)), (ep, covered)
    standby = [(e, n) for (e, n, _, _) in got[2]["steps"]]
    assert (0, 6) not in standby and (1, 3) not in standby, standby


def test_shrink_and_regrow_matches_jax(shrink):
    """The final parameters against the JAX Module's same schedule on
    4 devices (8 -> 4 -> 8 there is 4 -> 2 -> 4 here), and the same
    data-axis trace."""
    got, jax_params, jax_datas = shrink
    assert [s[2] for s in got[0]["steps"]] == jax_datas
    for name, w in jax_params.items():
        _close(got[0]["params"][name], w, name)


def test_shrink_and_regrow_timeline(shrink):
    """The chrome-trace timeline names the elastic protocol: the
    heartbeat transitions, both re-forms, the fences and their commits;
    the re-form's parts are timed."""
    got, _, _ = shrink
    missing = set(TIMELINE) - set(got[0]["timeline"])
    assert not missing, missing
    reform = got[0]["reform"]
    assert reform["kind"] == "regrow"
    assert all(reform[k] >= 0 for k in ("abandon_s", "rendezvous_s",
                                        "rebind_s", "restore_s"))


def test_real_death_is_survived(tmp_path):
    """Worker 1's two processes ``os._exit`` at step 5: the survivors'
    collective fails, they abandon the group, the monitor reads the dead
    processes' stamp dead at once, and they re-form at ``data=2``, resume
    from the step-4 fence and finish both epochs inside DEATH_TIMEOUT;
    the first step after the death comes within DEATH_BOUND_S."""
    workdir = str(tmp_path)
    procs = _spawn("death", workdir)
    got, outs = _collect(procs, "death", workdir, timeout=DEATH_TIMEOUT,
                         ranks=(0, 1))
    for r in (2, 3):
        assert procs[r].returncode == 0
        assert "ELASTIC_MESH_RANK_%d_OK" % r not in outs[r]
    with open(os.path.join(workdir, "death_2")) as f:
        died = float(f.read())
    for r, rk in got.items():
        datas = [s[2] for s in rk["steps"]]
        assert datas[0] == 4 and datas[-1] == 2, datas
        assert rk["recoveries"] == 1 and rk["world"] == 2
        after = min(s[3] for s in rk["steps"] if s[2] == 2)
        assert after - died < DEATH_BOUND_S, after - died
        for ep in (0, 1):
            covered = sorted({n for (e, n, _, _) in rk["steps"] if e == ep})
            assert covered == list(range(10)), (ep, covered)
        for name, w in rk["params"].items():
            assert np.isfinite(w).all(), name
            np.testing.assert_array_equal(w, got[0]["params"][name])


def test_replacement_takes_the_dead_workers_place(tmp_path):
    """Worker 1's two processes ``os._exit`` at step 5; the survivors
    re-form at ``data=2``; two processes started anew as ranks 2 and 3
    (``launch.rejoin``: they stamp worker 1 and wait for the survivors'
    next generation) regrow the mesh to ``data=4``, every rank restoring
    the same fence: the survivors' data axis reads 4, 2, 4 with two
    recoveries, the replacements resume once, every epoch covers 0..9
    and the four ranks end with equal, finite parameters."""
    workdir = str(tmp_path)
    procs = _spawn("replace", workdir)
    deadline = time.time() + DEATH_TIMEOUT
    deaths = [os.path.join(workdir, "death_%d" % r) for r in (2, 3)]
    while not all(os.path.exists(d) for d in deaths):
        assert time.time() < deadline and procs[0].poll() is None, \
            "worker 1 did not die"
        time.sleep(0.05)
    new = _spawn("rejoin", workdir, ranks=(2, 3))
    got, _ = _collect(procs, "replace", workdir, timeout=DEATH_TIMEOUT,
                      ranks=(0, 1))
    back, _ = _collect(new, "rejoin", workdir, timeout=DEATH_TIMEOUT,
                       names=(2, 3))
    for r, rk in got.items():
        datas = [s[2] for s in rk["steps"]]
        assert datas[0] == 4 and 2 in datas and datas[-1] == 4, datas
        assert rk["recoveries"] == 2 and rk["world"] == 4
    for ep in (0, 1):
        covered = sorted({n for (e, n, _, _) in got[0]["steps"] if e == ep})
        assert covered == list(range(10)), (ep, covered)
    for r, rk in back.items():
        assert rk["recoveries"] == 1 and rk["world"] == 4
        assert rk["steps"] and all(s[2] == 4 for s in rk["steps"])
    for rk in list(got.values()) + list(back.values()):
        for name, w in rk["params"].items():
            assert np.isfinite(w).all(), name
            np.testing.assert_array_equal(w, got[0]["params"][name])


# ---------------------------------------------------------------------------
# sharded checkpoints
# ---------------------------------------------------------------------------

def _same(got, want, what):
    assert sorted(got) == sorted(want), what
    for name in want:
        for a, b in zip(np.atleast_1d(got[name]) if not isinstance(
                got[name], list) else got[name],
                np.atleast_1d(want[name]) if not isinstance(
                    want[name], list) else want[name]):
            np.testing.assert_array_equal(a, b, err_msg="%s %s"
                                          % (what, name))


def test_sharded_roundtrip_over_the_group(ckpt):
    """``save_sharded`` of a (data=2, model=2) mesh writes ONE committed
    step directory: one payload a rank that holds blocks, one
    ``.metadata``, one commit marker; a fresh mesh module restores the
    parameters and predictions bit for bit, and the tensor-parallel
    blocks stay blocks."""
    saved = ckpt[0]["saved"]
    assert saved["files"] == sorted(
        [".metadata", "commit_success.txt"]
        + ["__%d_0.distcp" % r for r in range(WORLD)]), saved["files"]
    assert saved["local"]["fc1_weight"] == [8, 8]
    # a block a model rank (its two data replicas written once); a
    # replicated tensor once; no payload file written twice
    assert len(saved["chunks"]["params/fc1_weight"]) == 2
    assert len(saved["chunks"]["slots/fc1_weight/0"]) == 2
    assert len(saved["chunks"]["params/fc2_bias"]) == 1
    assert all(len(set(files)) == len(files)
               for files in saved["chunks"].values())
    for r, rk in ckpt.items():
        assert rk["saved"]["path"] == saved["path"]
        _same(rk["restored"]["params"], saved["params"], "rank %d" % r)
        np.testing.assert_array_equal(rk["restored"]["out"], saved["out"])
        for w in rk["continued"].values():
            assert np.isfinite(w).all()


def test_adam_slots_ride_the_sharded_fence(ckpt):
    """The Adam moments (each rank's blocks) restore as saved, and
    training continues from them."""
    saved = ckpt[0]["saved"]["slots"]
    assert any(np.abs(a).max() > 0 for s in saved.values() for a in s)
    for r, rk in ckpt.items():
        _same(rk["restored"]["slots"], saved, "rank %d slots" % r)


def test_latest_step_skips_a_torn_mesh_step(ckpt):
    for rk in ckpt.values():
        assert rk["torn"] == [3, False]


def test_slotless_restore_synthesizes_fresh_slots(ckpt):
    """An inference mesh module's fence (no slots) into a trained mesh
    module: the parameters restored, the slots zeroed in place."""
    for r, rk in ckpt.items():
        assert rk["slotless_before"] > 0
        _same(rk["slotless"]["params"], rk["slotless"]["want"],
              "rank %d" % r)
        for name, slots in rk["slotless"]["slots"].items():
            for a in slots:
                assert np.abs(a).max() == 0.0, (r, name)


def test_states_file_round_trip_under_a_model_axis(ckpt):
    """``save_optimizer_states`` at model = 2 writes the whole slots
    (rank 0); a mesh module loads its blocks and one process loads them
    whole: the slots equal the saving mesh's on both."""
    saved = ckpt[0]["saved"]["slots"]
    for r, rk in ckpt.items():
        _same(rk["states"], saved, "rank %d states" % r)
    _same(ckpt[0]["states_single"], saved, "one process states")


@pytest.mark.parametrize("case", ["from_single", "to_d1m2", "to_single"])
def test_fence_crosses_mesh_widths(ckpt, case):
    """One process's fence into the (data=2, model=2) mesh; the mesh's
    into (data=1, model=2) and into one process with no group: the
    parameters and Adam slots bit for bit, the predictions too."""
    for r, rk in ckpt.items():
        if case not in rk:
            assert (case == "to_d1m2" and r >= 2) \
                or (case == "to_single" and r >= 1)
            continue
        src = ckpt[0]["single"] if case == "from_single" \
            else ckpt[0]["saved"]
        _same(rk[case]["params"], src["params"], "%s rank %d" % (case, r))
        _same(rk[case]["slots"], src["slots"], "%s rank %d slots"
              % (case, r))
        if "out" in rk[case]:
            np.testing.assert_allclose(rk[case]["out"], src["out"],
                                       rtol=1e-6, atol=1e-7)


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
