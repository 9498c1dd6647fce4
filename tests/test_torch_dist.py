"""The port's ``dist_sync`` KVStore across two real processes over gloo
on the CPU: the counterpart of ``tests/test_dist_kvstore.py`` with its
worker programs (``tests/dist_worker.py``, ``tests/recovery_worker.py``).

This file is its own worker: ``python tests/test_torch_dist.py <mode>
<rank> <nprocs> <host:port> <outdir> [phase]`` runs one rank (it imports
only PyTorch and the port).  Each rank forms the group through
``parallel.launch.init`` and writes what it saw to ``<outdir>``; the
tests read it.  What is held:

* exact push / pull sums at three keys and shapes over three steps, and
  the updater (SGD) on the global sum (1e-6 relative);
* the first 2 synchronized steps of a ``dist_sync`` Module on disjoint
  shards within 1e-5 relative of the JAX package's single-process Module
  over the concatenated global batch, from the same numpy parameters
  (the global gradient summed in another order);
* ``fit(kvstore="dist_sync")`` on those shards to accuracy 0.9, with the
  ranks' weights identical bit for bit (each applies the same all-reduced
  gradient);
* ``num_dead_node() == 0`` while both ranks stamp, and a rank beyond the
  group reported dead;
* the kill-a-worker recovery drill: rank 1 SIGKILLs itself at an epoch's
  end, rank 0 finds the death through the heartbeat in its epoch
  callback (before any further collective) and leaves with
  ``os._exit(0)``; the relaunched job (``MXNET_IS_RECOVERY=1``, startup
  barriers skipped) resumes from the last checkpoint to accuracy 0.9.

Each rank finishes in well under a minute; every spawned process has a
free port and a ``communicate`` timeout.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
NPROCS = 2
SHAPES = {"3": (4, 5), "big": (30, 10), "9": (2,)}
SHARD = 128
BATCH = 16
LR = 0.2
FIT_EPOCHS = 8
DRILL_EPOCHS = 10
CRASH_EPOCH = 3       # rank 1 dies at the end of this epoch (0-based)
PROC_TIMEOUT = 120


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _shard(rank, seed_base=100, truth_seed=7):
    rng = np.random.RandomState(seed_base + rank)
    w_true = np.random.RandomState(truth_seed).normal(size=(6,)).astype(
        np.float32)
    xs = rng.normal(size=(SHARD, 6)).astype(np.float32)
    ys = (xs @ w_true > 0).astype(np.float32)
    return xs, ys


def _net(sym):
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                             name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=2, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _start_params():
    rng = np.random.RandomState(3)
    return {"fc1_weight": rng.normal(0, 0.5, (16, 6)).astype(np.float32),
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rng.normal(0, 0.5, (2, 16)).astype(np.float32),
            "fc2_bias": np.zeros(2, np.float32)}


# ---------------------------------------------------------------------------
# the worker (one rank)
# ---------------------------------------------------------------------------

def _worker_main(argv):
    mode, rank, nprocs, address, outdir = argv[:5]
    rank, nprocs = int(rank), int(nprocs)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel import launch

    launch.init(address, nprocs, rank, backend="gloo", timeout=60)
    with mt.cpu():
        if mode == "main":
            _worker_cases(mt, rank, nprocs, outdir)
        else:
            _worker_drill(mt, rank, nprocs, outdir, argv[5])
    launch.shutdown()


def _worker_cases(mt, rank, nprocs, outdir):
    import torch

    from mxnet_tpu_torch.parallel import health

    nd = mt.nd
    out = {}
    kv = mt.kvstore.create("dist_sync")
    assert (kv.rank, kv.num_workers) == (rank, nprocs)
    # exact sums: rank r pushes (r + 1) * (step + 1)
    keys = {(int(k) if k.isdigit() else k): s for k, s in SHAPES.items()}
    for key, shape in keys.items():
        kv.init(key, nd.zeros(shape))
    sums = []
    for step in range(3):
        for key, shape in keys.items():
            kv.push(key, nd.full(shape, float(rank + 1) * (step + 1)))
            o = nd.zeros(shape)
            kv.pull(key, out=o)
            sums.append(o.asnumpy().tolist())
    out["sums"] = sums
    kv.barrier()
    # the updater on the global sum
    kv2 = mt.kvstore.create("dist_sync")
    kv2.set_optimizer(mt.optimizer.SGD(learning_rate=0.5, rescale_grad=1.0))
    kv2.init(0, nd.full((3, 3), 10.0))
    kv2.push(0, nd.full((3, 3), float(rank + 1)))
    o = nd.zeros((3, 3))
    kv2.pull(0, out=o)
    out["updated"] = o.asnumpy().tolist()
    kv2.barrier()

    xs, ys = _shard(rank)
    # the first two synchronized steps from the shared numpy parameters
    mod = mt.mod.Module(_net(mt.sym), context=mt.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 6))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(arg_params=_start_params())
    mod.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                       optimizer_params={"learning_rate": LR})
    assert mod._train_step is None and mod._update_on_kvstore
    out["rescale_grad"] = mod._optimizer.rescale_grad
    for i in range(2):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        mod.forward_backward(mt.io.DataBatch([nd.array(xs[sl])],
                                             [nd.array(ys[sl])]))
        mod.update()
    np.savez(os.path.join(outdir, "two_steps_r%d.npz" % rank),
             **{k: v.asnumpy() for k, v in mod.get_params()[0].items()})

    # fit to convergence on the shard, identical init on every rank
    mt.random.seed(5)
    it = mt.io.NDArrayIter(xs, ys, batch_size=BATCH)
    fmod = mt.mod.Module(_net(mt.sym), context=mt.cpu())
    fmod.fit(it, optimizer="sgd", optimizer_params={"learning_rate": LR},
             initializer=mt.initializer.Xavier(rnd_type="gaussian"),
             kvstore="dist_sync", num_epoch=FIT_EPOCHS)
    it.reset()
    out["accuracy"] = dict(fmod.score(it, "acc"))["accuracy"]
    np.savez(os.path.join(outdir, "fit_r%d.npz" % rank),
             **{k: v.asnumpy() for k, v in fmod.get_params()[0].items()})
    # the all-reduce over CUDA-free gloo: torch tensors round trip
    t = torch.full((5,), float(rank + 1))
    from mxnet_tpu_torch.parallel import collectives

    out["global_sum"] = collectives.global_sum(t).tolist()
    out["global_sum_input"] = t.tolist()

    # failure detection: both ranks stamp
    kv.barrier()
    time.sleep(0.1)
    out["num_dead_node"] = kv.num_dead_node()
    out["dead_beyond"] = health.dead_nodes(os.environ["MXNET_HEARTBEAT_DIR"],
                                           nprocs + 1)
    kv.barrier()
    kv.close()
    with open(os.path.join(outdir, "cases_r%d.json" % rank), "w") as f:
        json.dump(out, f)
    print("WORKER_%d_OK" % rank, flush=True)


class _PeerDied(Exception):
    pass


def _worker_drill(mt, rank, nprocs, workdir, phase):
    from mxnet_tpu_torch.parallel import health

    hb_dir = os.environ["MXNET_HEARTBEAT_DIR"]
    prefix = os.path.join(workdir, "drill")
    kv = mt.kvstore.create("dist_sync")
    assert kv.rank == rank
    xs, ys = _shard(rank, seed_base=200, truth_seed=11)
    it = mt.io.NDArrayIter(xs, ys, batch_size=BATCH)
    mod = mt.mod.Module(_net(mt.sym), context=mt.cpu())

    def epoch_cb(epoch, symbol, arg_params, aux_params):
        # every rank checkpoints (the weights are identical under
        # dist_sync; a survivor's file exists whichever rank died)
        mod.save_checkpoint(prefix + ".r%d" % rank, epoch)
        with open(os.path.join(workdir, "epoch.r%d" % rank), "w") as f:
            f.write(str(epoch))
        if phase != "crash":
            return
        if rank == 1 and epoch == CRASH_EPOCH:
            print("WORKER_1_SUICIDE", flush=True)
            os.kill(os.getpid(), 9)
        if rank == 0 and epoch >= CRASH_EPOCH:
            # before any further collective: poll until the peer's stamp
            # goes stale
            deadline = time.time() + 20
            while time.time() < deadline:
                time.sleep(0.5)
                if health.dead_nodes(hb_dir, nprocs, timeout=3.0):
                    raise _PeerDied()
            raise AssertionError("peer death never detected")

    begin, arg_params, aux_params = 0, None, None
    if phase == "resume":
        epochs = []
        for r in range(nprocs):
            try:
                with open(os.path.join(workdir, "epoch.r%d" % r)) as f:
                    epochs.append((int(f.read()), r))
            except OSError:
                pass
        last, src = max(epochs)
        _, arg_params, aux_params = mt.model.load_checkpoint(
            prefix + ".r%d" % src, last)
        begin = last + 1
        assert begin >= CRASH_EPOCH, begin
        assert health.is_recovery(), "the relaunched job sees recovery"
    mt.random.seed(5)
    try:
        mod.fit(it, optimizer="sgd", optimizer_params={"learning_rate": LR},
                initializer=mt.initializer.Xavier(rnd_type="gaussian"),
                arg_params=arg_params, aux_params=aux_params,
                allow_missing=arg_params is None, kvstore="dist_sync",
                begin_epoch=begin, num_epoch=DRILL_EPOCHS,
                epoch_end_callback=epoch_cb)
    except _PeerDied:
        print("WORKER_0_DETECTED_DEAD_PEER", flush=True)
        # destroy_process_group would wait on the dead rank: leave now
        os._exit(0)
    it.reset()
    acc = dict(mod.score(it, "acc"))["accuracy"]
    assert acc >= 0.9, "rank %d accuracy %.3f" % (rank, acc)
    print("WORKER_%d_RESUMED_OK acc=%.3f" % (rank, acc), flush=True)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _launch(mode, outdir, hb_dir, extra=(), env_extra=None):
    address = "127.0.0.1:%d" % _free_port()
    env = dict(os.environ)
    env["MXNET_HEARTBEAT_DIR"] = hb_dir
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    procs = [subprocess.Popen(
        [sys.executable, HERE, mode, str(r), str(NPROCS), address, outdir]
        + list(extra), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True, cwd=ROOT) for r in range(NPROCS)]
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
    return procs, outs


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("dist_cases"))
    procs, outs = _launch("main", outdir, os.path.join(outdir, "hb"))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d:\n%s" % (rank, out[-4000:])
        assert "WORKER_%d_OK" % rank in out
    res = []
    for rank in range(NPROCS):
        with open(os.path.join(outdir, "cases_r%d.json" % rank)) as f:
            res.append(json.load(f))
    return outdir, res


def test_push_pull_exact_sums(cases):
    _, res = cases
    want = []
    for step in range(3):
        for shape in SHAPES.values():
            want.append(np.full(shape, sum(r + 1 for r in range(NPROCS))
                                * (step + 1), np.float32))
    for r in res:
        for got, w in zip(r["sums"], want):
            assert np.array_equal(np.array(got, np.float32), w)


def test_updater_applies_the_global_sum(cases):
    _, res = cases
    want = 10.0 - 0.5 * sum(r + 1 for r in range(NPROCS))
    for r in res:
        np.testing.assert_allclose(r["updated"], want, rtol=1e-6)


def test_global_sum_leaves_its_input(cases):
    _, res = cases
    for rank, r in enumerate(res):
        assert r["global_sum"] == [3.0] * 5
        assert r["global_sum_input"] == [float(rank + 1)] * 5


def test_first_two_steps_match_jax_single_process(cases):
    """Both ranks' parameters after two dist_sync steps against the JAX
    package's single-process Module over the concatenated global batch
    (rescale 1 / 32 both ways): 1e-5 relative."""
    import mxnet_tpu as mx

    outdir, res = cases
    assert all(r["rescale_grad"] == 1.0 / (BATCH * NPROCS) for r in res)
    shards = [_shard(r) for r in range(NPROCS)]
    mod = mx.mod.Module(_net(mx.sym), context=mx.cpu())
    mod.bind(data_shapes=[("data", (BATCH * NPROCS, 6))],
             label_shapes=[("softmax_label", (BATCH * NPROCS,))])
    mod.init_params(arg_params={k: mx.nd.array(v)
                                for k, v in _start_params().items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": LR})
    for i in range(2):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        x = np.concatenate([s[0][sl] for s in shards])
        y = np.concatenate([s[1][sl] for s in shards])
        mod.forward_backward(mx.io.DataBatch([mx.nd.array(x)],
                                             [mx.nd.array(y)]))
        mod.update()
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    start = _start_params()
    for rank in range(NPROCS):
        got = np.load(os.path.join(outdir, "two_steps_r%d.npz" % rank))
        for name, w in want.items():
            assert not np.array_equal(w, start[name]) or name.endswith(
                "bias")
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_fit_converges_with_identical_weights(cases):
    outdir, res = cases
    assert all(r["accuracy"] >= 0.9 for r in res), \
        [r["accuracy"] for r in res]
    w = [np.load(os.path.join(outdir, "fit_r%d.npz" % r))
         for r in range(NPROCS)]
    assert sorted(w[0].files) == ["fc1_bias", "fc1_weight", "fc2_bias",
                                  "fc2_weight"]
    for name in w[0].files:
        assert w[0][name].tobytes() == w[1][name].tobytes(), name


def test_heartbeats_report_the_live_and_the_missing(cases):
    _, res = cases
    for r in res:
        assert r["num_dead_node"] == 0
        assert r["dead_beyond"] == [NPROCS]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("drill"))
    crash = _launch("drill", workdir, os.path.join(workdir, "hb_crash"),
                    extra=("crash",))
    resume = _launch("drill", workdir, os.path.join(workdir, "hb_resume"),
                     extra=("resume",),
                     env_extra={"MXNET_IS_RECOVERY": "1"})
    return workdir, crash, resume


def test_drill_survivor_detects_the_killed_worker(drill):
    workdir, (procs, outs), _ = drill
    assert procs[1].returncode == -9, outs[1][-2000:]
    assert "WORKER_1_SUICIDE" in outs[1]
    assert procs[0].returncode == 0, outs[0][-4000:]
    assert "WORKER_0_DETECTED_DEAD_PEER" in outs[0]
    assert any(f.startswith("epoch.") for f in os.listdir(workdir))


def test_drill_resumes_in_recovery_mode(drill):
    _, _, (procs, outs) = drill
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d:\n%s" % (r, out[-4000:])
        assert "WORKER_%d_RESUMED_OK" % r in out, out[-2000:]


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
