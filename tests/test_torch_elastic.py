"""Elastic training through the port, on the CPU, against the JAX
package: fenced checkpoints, kill-and-resume, the fault injector, the
heartbeat monitor and the iterators' resume surface.

The net and data are the JAX package's own elastic tests' (a two-layer
MLP, 96 samples of 8 features, batch 8, Adam at 5e-3); both packages
start from the same numpy parameters.

Tolerances: the port's resumed run against its uninterrupted run bit
for bit (parameters and the last epoch's metric line); the port's
resumed parameters against the JAX package's resumed run to
``|d| <= 1e-5 + 1e-4 |x|`` (f32 rounding in another order); the fence
sidecars' loop state (epoch, nbatch_done, global_step, iterator,
optimizer counts, metric sums) equal.  The sidecars' generator records
differ by design: the JAX package stores a jax key (``rng_key``), the
port torch and numpy generator states (``rng``).
"""
import json
import logging
import os
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import elastic as jelastic
from mxnet_tpu.parallel import health as jhealth

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import checkpoint, elastic, profiler
from mxnet_tpu_torch.parallel import health

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    """Arrays made without a context go to the host: the port's default
    context is the card."""
    with mt.cpu():
        yield


PERIOD, KILL, FENCE = 5, 17, 15
TOL_ABS, TOL_REL = 1e-5, 1e-4
LOOP_KEYS = ("epoch", "nbatch_done", "global_step", "iterator", "optimizer",
             "metric_host", "metric_device")


def _net(pkg, hidden=16, classes=4):
    s = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=hidden,
                               name="fc1")
    s = pkg.sym.Activation(s, act_type="relu")
    s = pkg.sym.FullyConnected(s, num_hidden=classes, name="fc2")
    return pkg.sym.SoftmaxOutput(s, name="softmax")


def _dataset(n, features=8, classes=4, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, features)).astype(np.float32)
    Y = rng.randint(0, classes, size=(n,)).astype(np.float32)
    return X, Y


def _params(hidden=16, classes=4, features=8, seed=11):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": 0.3 * rng.randn(hidden, features),
            "fc1_bias": 0.1 * rng.randn(hidden),
            "fc2_weight": 0.3 * rng.randn(classes, hidden),
            "fc2_bias": 0.1 * rng.randn(classes)}


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.rows = []

    def emit(self, record):
        self.rows.append(record.getMessage())


def _fit(pkg, tag, X, Y, ctl=None, last_batch_handle="pad", num_epoch=2,
         begin_epoch=0, hidden=16, classes=4, batch_size=8):
    """One fit of either package from the same numpy parameters; returns
    (module, the train-accuracy lines)."""
    pkg.random.seed(42)
    cap = _Capture()
    lg = logging.Logger("elastic-%s-%s" % (pkg.__name__, tag))
    lg.addHandler(cap)
    mod = pkg.mod.Module(_net(pkg, hidden, classes), context=pkg.cpu(),
                         logger=lg)
    args = {k: pkg.nd.array(v.astype(np.float32)) for k, v in
            _params(hidden, classes, X.shape[1]).items()}
    it = pkg.io.NDArrayIter(X, Y, batch_size=batch_size,
                            last_batch_handle=last_batch_handle)
    mod.fit(it, optimizer="adam", optimizer_params={"learning_rate": 5e-3},
            arg_params=args, num_epoch=num_epoch, begin_epoch=begin_epoch,
            eval_metric="acc", elastic=ctl)
    return mod, [r for r in cap.rows if "Train-accuracy" in r]


def _numpy_params(mod):
    return {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}


def _kill_and_resume(pkg, d, X, Y, lbh):
    """A run killed at KILL (sync fences every PERIOD) and its resumed
    run; returns (the resumed module, its lines, the fence's sidecar,
    the resumed controller)."""
    el = elastic if pkg is mt else jelastic
    ctl = el.ElasticController(
        checkpointer=el.Checkpointer(d, period=PERIOD, async_write=False),
        injector=el.FaultInjector().kill_at(KILL))
    with pytest.raises(el.WorkerKilled):
        _fit(pkg, "killed", X, Y, ctl, lbh)
    with open(os.path.join(d, str(FENCE), "elastic.json")) as f:
        sidecar = json.load(f)
    ctl2 = el.ElasticController(
        checkpointer=el.Checkpointer(d, period=PERIOD, async_write=False))
    mod, hist = _fit(pkg, "resumed", X, Y, ctl2, lbh)
    return mod, hist, sidecar, ctl2


@pytest.mark.parametrize("lbh,n", [("pad", 96), ("roll_over", 92)])
def test_kill_and_resume_bit_identical_and_matches_jax(tmp_path, lbh, n):
    """Killed at step 17 and resumed from the step-15 fence (epoch 1, 3
    batches in): the port's parameters and last metric line equal its
    uninterrupted run's bit for bit, the torn debris below the fence is
    pruned, and the JAX package's same kill-and-resume lands within the
    stated tolerance with the same sidecar loop state."""
    X, Y = _dataset(n)
    whole, hist_whole = _fit(mt, "whole", X, Y, last_batch_handle=lbh)

    d = str(tmp_path / "port")
    ctl = elastic.ElasticController(
        checkpointer=elastic.Checkpointer(d, period=PERIOD,
                                          async_write=False),
        injector=elastic.FaultInjector().kill_at(KILL))
    with pytest.raises(elastic.WorkerKilled):
        _fit(mt, "killed", X, Y, ctl, lbh)
    assert checkpoint.latest_step(d) == FENCE
    assert sorted(os.listdir(os.path.join(d, str(FENCE)))) == [
        ".metadata", "__0_0.distcp", "commit_success.txt", "elastic.json"]
    with open(os.path.join(d, str(FENCE), "elastic.json")) as f:
        port_meta = json.load(f)
    assert port_meta["epoch"] == 1 and port_meta["nbatch_done"] == 3
    assert set(port_meta["rng"]) == {"seed", "generators", "torch_cpu",
                                     "torch_cuda", "numpy"}
    # the debris of an earlier crash, below the newest commit
    elastic.FaultInjector.torn_checkpoint(d, 1)
    ctl2 = elastic.ElasticController(
        checkpointer=elastic.Checkpointer(d, period=PERIOD,
                                          async_write=False))
    profiler.reset_step_stats()
    resumed, hist = _fit(mt, "resumed", X, Y, ctl2, lbh)
    assert ctl2.recoveries == 1 == profiler.step_stats()["recoveries"]
    assert not os.path.isdir(os.path.join(d, "1"))
    want, got = _numpy_params(whole), _numpy_params(resumed)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert hist == hist_whole[-1:]

    jmod, jhist, jmeta, _ = _kill_and_resume(mx, str(tmp_path / "jax"), X,
                                             Y, lbh)
    jgot = _numpy_params(jmod)
    for k in jgot:
        np.testing.assert_allclose(got[k], jgot[k], rtol=TOL_REL,
                                   atol=TOL_ABS, err_msg=k)
    assert jhist == hist
    for key in LOOP_KEYS:
        assert port_meta[key] == jmeta[key], key
    assert "rng_key" in jmeta and "rng_key" not in port_meta


def test_resume_refusals(tmp_path):
    """``resume=False`` over a directory holding commits, and a
    begin_epoch ahead of the fence, are refused before any step."""
    X, Y = _dataset(96)
    d = str(tmp_path / "ck")
    ctl = elastic.ElasticController(
        checkpointer=elastic.Checkpointer(d, period=PERIOD,
                                          async_write=False),
        injector=elastic.FaultInjector().kill_at(KILL))
    with pytest.raises(elastic.WorkerKilled):
        _fit(mt, "killed", X, Y, ctl)
    ctl3 = elastic.ElasticController(checkpointer=elastic.Checkpointer(
        d, period=PERIOD, async_write=False, resume=False))
    with pytest.raises(mt.MXNetError, match="previous run"):
        _fit(mt, "refused", X, Y, ctl3)
    ctl4 = elastic.ElasticController(
        checkpointer=elastic.Checkpointer(d, period=PERIOD,
                                          async_write=False))
    with pytest.raises(mt.MXNetError, match="behind"):
        _fit(mt, "behind", X, Y, ctl4, num_epoch=12, begin_epoch=9)
    assert checkpoint.latest_step(d) == FENCE


def test_async_checkpoint_overlaps_and_stalls_less_than_sync(tmp_path):
    """Asynchronous, steps run while a write is in flight (counted) and
    the loop thread's checkpoint stall is below the synchronous run's on
    the same trace; synchronous, every fence commits inline."""
    rng = np.random.RandomState(0)
    X = rng.normal(size=(240, 128)).astype(np.float32)
    Y = rng.randint(0, 8, size=(240,)).astype(np.float32)

    def run(async_write, directory):
        ctl = elastic.ElasticController(checkpointer=elastic.Checkpointer(
            str(directory), period=2, async_write=async_write))
        profiler.reset_step_stats()
        _fit(mt, "a%d" % async_write, X, Y, ctl, num_epoch=1, hidden=512,
             classes=8, batch_size=12)      # 20 steps
        return ctl.checkpointer, profiler.step_stats()

    ck_async, stats_async = run(True, tmp_path / "async")
    ck_sync, stats_sync = run(False, tmp_path / "sync")
    assert ck_async.steps_during_write > 0
    assert ck_async.writes >= 1
    assert ck_async.writes + ck_async.skipped_busy >= 10
    assert ck_sync.writes == 11 and ck_sync.skipped_busy == 0
    assert ck_sync.steps_during_write == 0
    assert stats_async["ckpt_stall_s"] < stats_sync["ckpt_stall_s"]
    assert stats_async["checkpoint_stall_fraction"] < \
        stats_sync["checkpoint_stall_fraction"]
    assert stats_sync["last_ckpt_ms"] > 0 and stats_sync["ckpt_writes"] == 11
    assert stats_async["recoveries"] == 0
    # the accounting fields the JAX package's step_stats gives
    keys = ("ckpt_stall_s", "checkpoint_stall_fraction", "ckpt_writes",
            "last_ckpt_ms", "recoveries")
    jstats = mx.profiler.step_stats()
    assert all(k in jstats and k in stats_sync for k in keys)
    assert ck_sync.snapshot_bytes == 4 * 3 * (128 * 512 + 512 + 512 * 8 + 8)


def test_write_failure_raises_at_the_next_fence(tmp_path, monkeypatch):
    """A failed background write is not swallowed: fit raises at the next
    fence."""
    X, Y = _dataset(96)

    def broken(directory, step, state):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "save_state_tree", broken)
    ctl = elastic.ElasticController(checkpointer=elastic.Checkpointer(
        str(tmp_path / "ck"), period=2, async_write=True))
    with pytest.raises(mt.MXNetError, match="write failed: disk full"):
        _fit(mt, "broken", X, Y, ctl)
    assert checkpoint.latest_step(str(tmp_path / "ck")) is None


def test_write_failure_does_not_mask_the_unwinding_exception(
        tmp_path, monkeypatch, caplog):
    """fit unwinding on a kill while a background write has failed (the
    fence taken at fit's start; no fence before the kill to raise it):
    the kill propagates and the write failure is logged, not raised in
    its place."""
    X, Y = _dataset(96)

    def broken(directory, step, state):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "save_state_tree", broken)
    ctl = elastic.ElasticController(
        checkpointer=elastic.Checkpointer(str(tmp_path / "ck"),
                                          period=100, async_write=True),
        injector=elastic.FaultInjector().kill_at(3))
    with caplog.at_level(logging.ERROR, logger=elastic.controller.__name__):
        with pytest.raises(elastic.WorkerKilled):
            _fit(mt, "broken-killed", X, Y, ctl)
    assert any("write failed while fit() was unwinding" in r.getMessage()
               for r in caplog.records)
    assert ctl.checkpointer._error is None


def test_monitor_event_drains_and_raises(tmp_path):
    """A heartbeat going stale mid-fit: the fence of that step commits,
    the loop drains and fit raises the stated MXNetError (no mesh to
    re-form on one device)."""
    X, Y = _dataset(96)
    hb = str(tmp_path / "hb")
    health.Heartbeat(hb, 0).beat()
    health.Heartbeat(hb, 1).beat()
    mon = health.FailureMonitor(hb, num_workers=2, my_rank=0, timeout=1e6,
                                grace=0)
    d = str(tmp_path / "ck")
    ctl = elastic.ElasticController(
        checkpointer=elastic.Checkpointer(d, period=2, async_write=False),
        monitor=mon,
        injector=elastic.FaultInjector().stale_heartbeat_at(4, hb, 1,
                                                            age=1e9))
    with pytest.raises(mt.MXNetError, match="re-forming the device mesh"):
        _fit(mt, "shrink", X, Y, ctl)
    assert checkpoint.latest_step(d) == 4 and mon.current_dead == {1}


def test_from_env_arms_fit(tmp_path):
    """``MXNET_CKPT_DIR`` + ``MXNET_CKPT_PERIOD`` arm a controller (with
    the knobs' defaults); without both, none; a fit under the knobs
    commits its fences and a second fit resumes from the newest."""
    d = str(tmp_path / "env")
    with mt.config.overrides(MXNET_CKPT_DIR="", MXNET_CKPT_PERIOD=3):
        assert elastic.from_env() is None
    with mt.config.overrides(MXNET_CKPT_DIR=d, MXNET_CKPT_PERIOD=0):
        assert elastic.from_env() is None
    with mt.config.overrides(MXNET_CKPT_DIR=d, MXNET_CKPT_PERIOD=3,
                             MXNET_CKPT_ASYNC=False):
        ctl = elastic.from_env()
        ck = ctl.checkpointer
        assert (ck.directory, ck.period, ck.async_write, ck.keep,
                ck.resume, ctl.poll_every) == (d, 3, False, 2, True, 1)
        X, Y = _dataset(96)
        _fit(mt, "env", X, Y, num_epoch=1)
        assert checkpoint.latest_step(d) == 12
        assert sorted(os.listdir(d)) == ["12", "9"]
        _fit(mt, "env-resumed", X, Y, num_epoch=2)
        assert checkpoint.latest_step(d) == 24
    assert elastic.from_env() is None


@pytest.mark.parametrize("writer,reader", [
    (health, jhealth), (jhealth, health), (health, health)],
    ids=["port-jax", "jax-port", "port-port"])
def test_heartbeats_read_across_packages(tmp_path, writer, reader):
    """One stamp directory, either package writing or reading: dead
    ranks, grace for unstamped ones, stale stamps and the monitor's
    transitions agree."""
    d = str(tmp_path / "hb")
    writer.Heartbeat(d, 0).beat()
    writer.Heartbeat(d, 1).beat()
    assert reader.dead_nodes(d, 3, timeout=60) == [2]
    assert reader.dead_nodes(d, 3, timeout=60, grace=1e6) == []
    assert reader.num_dead_nodes(d, 2, timeout=60) == 0
    now = time.time()
    assert reader.dead_nodes(d, 2, timeout=5, now=now + 10) == [0, 1]
    mon = reader.FailureMonitor(d, num_workers=2, my_rank=0, timeout=1e6,
                                grace=0)
    assert mon.poll() is None
    inj = (elastic if writer is health else jelastic).FaultInjector()
    inj.stale_heartbeat_at(3, d, 1, age=1e9).revive_heartbeat_at(5, d, 1)
    inj.fire(3)
    event = mon.poll()
    assert (event.kind, event.dead, event.newly_dead, event.returned) == \
        ("shrink", [1], [1], [])
    inj.fire(5)
    event = mon.poll()
    assert (event.kind, event.dead, event.returned) == ("regrow", [], [1])
    assert inj.fired == [3, 5]


@pytest.mark.parametrize("pkg_health", [health, jhealth],
                         ids=["port", "jax"])
def test_heartbeat_thread_and_recovery_flag(tmp_path, monkeypatch,
                                            pkg_health):
    """``ensure_heartbeat`` starts one stamping thread a (dir, rank),
    ``stop_heartbeat`` ends it; ``is_recovery`` reads the environment.
    Both packages behave alike."""
    d = str(tmp_path / "hb")
    hb = pkg_health.ensure_heartbeat(d, 3, interval=60)
    assert pkg_health.ensure_heartbeat(d, 3) is hb
    assert hb._thread is not None and hb._thread.is_alive()
    assert os.path.exists(os.path.join(d, "worker-3.heartbeat"))
    pkg_health.stop_heartbeat(d, 3)
    assert hb._thread is None
    monkeypatch.setenv("MXNET_IS_RECOVERY", "1")
    assert pkg_health.is_recovery()
    monkeypatch.setenv("MXNET_IS_RECOVERY", "0")
    assert not pkg_health.is_recovery()


def _sentences():
    rng = np.random.RandomState(4)
    return [list(rng.randint(1, 20, size=rng.randint(2, 9)))
            for _ in range(40)]


def _iterator(pkg, kind, tmp_path):
    """The same iterator of either package (module 2's set)."""
    X, Y = _dataset(60, seed=3)       # 60 % 8 = 4: pad / roll_over live
    if kind in ("pad", "discard", "roll_over"):
        return pkg.io.NDArrayIter(X, Y, batch_size=8, last_batch_handle=kind)
    if kind == "mnist":
        return pkg.io.MNISTIter(batch_size=100, seed=0, flat=True,
                                silent=True)
    if kind == "csv":
        path = str(tmp_path / "x.csv")
        np.savetxt(path, X, delimiter=",")
        return pkg.io.CSVIter(data_csv=path, data_shape=(8,), batch_size=8)
    if kind.startswith("resize"):
        return pkg.io.ResizeIter(pkg.io.NDArrayIter(
            X, Y, batch_size=8, last_batch_handle="roll_over"), 5,
            reset_internal=kind == "resize_internal")
    if kind == "prefetching":
        return pkg.io.PrefetchingIter(pkg.io.NDArrayIter(X, Y, batch_size=8))
    if kind == "bucket_sentence":
        return pkg.rnn.BucketSentenceIter(_sentences(), 4, buckets=[4, 8],
                                          seed=0)
    raise ValueError(kind)


def _batch_arrays(batch):
    return [a.asnumpy() for a in batch.data + (batch.label or [])]


@pytest.mark.parametrize("kind", [
    "pad", "discard", "roll_over", "mnist", "csv", "resize_internal",
    "resize", "prefetching", "bucket_sentence"])
def test_iterator_resume_surface_matches_jax(tmp_path, kind):
    """``fast_forward(n)`` lands on the batch that draining ``n`` reaches;
    ``reset_carries_state``, the draining-or-seeking form and
    ``checkpoint_state`` answer as the JAX package's iterator does."""
    jit, tit, drained = (_iterator(mx, kind, tmp_path),
                         _iterator(mt, kind, tmp_path),
                         _iterator(mt, kind, tmp_path))
    try:
        assert tit.reset_carries_state == jit.reset_carries_state
        seeks = type(jit).fast_forward is not mx.io.DataIter.fast_forward
        assert (type(tit).fast_forward is not mt.io.DataIter.fast_forward) \
            == seeks
        for _ in range(2):
            drained.next()
        jit.fast_forward(2)
        tit.fast_forward(2)
        if hasattr(jit, "checkpoint_state"):
            assert tit.checkpoint_state() == jit.checkpoint_state()
            fresh = _iterator(mt, kind, tmp_path)
            fresh.restore_state(tit.checkpoint_state())
            for a, b in zip(_batch_arrays(fresh.next()),
                            _batch_arrays(drained.next())):
                np.testing.assert_array_equal(a, b)
            drained = _iterator(mt, kind, tmp_path)
            for _ in range(2):
                drained.next()
        want = _batch_arrays(drained.next())
        for got in (_batch_arrays(tit.next()), _batch_arrays(jit.next())):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    finally:
        for it in (jit, tit, drained):
            if hasattr(it, "close"):
                it.close()


def test_wrappers_and_image_iterators_keep_the_reference_forms():
    """DevicePrefetchIter asks its source (the port's needs a card to
    build, so its property is read on a bare instance); the image
    iterators keep the base class's draining form and a stateless reset,
    as in the JAX package."""
    src = mt.io.NDArrayIter(np.zeros((12, 2), np.float32), batch_size=4,
                            last_batch_handle="roll_over")
    dp = mt.io.DevicePrefetchIter.__new__(mt.io.DevicePrefetchIter)
    dp.data_iter = src
    assert dp.reset_carries_state is True
    jsrc = mx.io.NDArrayIter(np.zeros((12, 2), np.float32), batch_size=4,
                             last_batch_handle="roll_over")
    jdp = mx.io.DevicePrefetchIter(jsrc, placement=lambda k, n, a: a)
    try:
        assert jdp.reset_carries_state is True
    finally:
        jdp.close()
    for name in ("ImageIter", "ImageDetIter"):
        for pkg in (mt, mx):
            cls = getattr(pkg.image, name)
            assert cls.fast_forward is pkg.io.DataIter.fast_forward
            assert cls.reset_carries_state is False
