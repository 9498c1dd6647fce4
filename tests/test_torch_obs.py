"""The port's telemetry (``mxnet_tpu_torch.obs``) and profiler facade
against the JAX package: the passing cases of ``tests/test_obs.py`` and
the three of ``tests/test_profiler.py``.

The registry is a copy: the same operations give the same Prometheus
text and snapshot in both packages, and ``percentile`` the same
sample.  The trace timeline merges the Chrome JSON ``torch.profiler``
writes.  In place of the reference's HLO byte-identity tripwire: a
paged serve's tokens, ``trace_counts`` and ``GRAPH_STATS`` are the same
with ``MXNET_TELEMETRY`` on and off, and with it off nothing lands on
the timeline or in the roofline table.
"""
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from mxnet_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from mxnet_tpu.obs.metrics import percentile as jax_percentile

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config, obs, profiler, programs
from mxnet_tpu_torch.decode import DecodePredictor, DecodeServer
from mxnet_tpu_torch.io import DataBatch
from mxnet_tpu_torch.models import attention_lm
from mxnet_tpu_torch.obs.metrics import MetricsRegistry, percentile
from mxnet_tpu_torch.obs.trace import TraceTimeline
from mxnet_tpu_torch.test_utils import assert_chrome_trace, check_speed

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def _registry_drive(cls):
    """The same operations on a registry of either package."""
    reg = cls()
    c = reg.counter("t_c", "a counter")
    c.inc(5)
    reg.counter("t_c").inc(1)
    reg.gauge("t_g", "a gauge").set(2.5)
    lab = reg.counter("t_by", "by worker", labels=("who", "kind"))
    lab.labels(who="w\"1", kind="a").inc(3)
    lab.labels(who="w2", kind="b").inc(0.25)
    h = reg.histogram("t_h", "a histogram", labels=("k",))
    for v in (0.003, 0.03, 0.3, 3.0, 30.0):
        h.labels(k="x").observe(v)
    h2 = reg.histogram("t_rate", "rates", buckets=(1, 10, 100))
    for v in (0.5, 5, 50, 500):
        h2.observe(v)
    reg.gauge("t_g2", "labeled gauge", labels=("host",)).labels(
        host="h0").set(7)
    return reg


def test_registry_matches_jax_and_sums_concurrent_increments():
    """The same operations give identical Prometheus text and snapshots
    in both packages; concurrent increments on the port's registry sum
    exactly."""
    got, want = _registry_drive(MetricsRegistry), _registry_drive(JaxRegistry)
    assert got.prometheus_text() == want.prometheus_text()
    assert json.dumps(got.snapshot(), sort_keys=True) == \
        json.dumps(want.snapshot(), sort_keys=True)

    reg = MetricsRegistry()
    plain = reg.counter("t_ops", "ops")
    labeled = reg.counter("t_ops_by", "ops by worker", labels=("who",))
    hist = reg.histogram("t_lat", "latencies")
    nthreads, per = 8, 2000

    def worker(i):
        child = labeled.labels(who="w%d" % (i % 3))
        for j in range(per):
            plain.inc()
            child.inc()
            hist.observe(j * 1e-4)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert plain.get() == nthreads * per
    snap = reg.snapshot()
    assert sum(r["value"] for r in snap["t_ops_by"]["series"]) \
        == nthreads * per
    assert snap["t_lat"]["series"][0]["value"]["count"] == nthreads * per


def test_histogram_percentiles_match_numpy_and_jax():
    reg, jreg = MetricsRegistry(), JaxRegistry()
    h, jh = reg.histogram("t_h", "h"), jreg.histogram("t_h", "h")
    rng = np.random.RandomState(7)
    vals = rng.lognormal(-3, 1.5, size=997)
    for v in vals:
        h.observe(v)
        jh.observe(v)
    for q in (0.5, 0.9, 0.95, 0.99):
        assert h.percentile(q) == pytest.approx(
            float(np.percentile(vals, q * 100)), rel=1e-12)
        assert h.percentile(q) == jh.percentile(q)
    assert reg.histogram("t_empty", "e").percentile(0.5) is None
    ranked = sorted(vals.tolist())
    for q in (0.0, 0.5, 0.95, 1.0):
        assert percentile(ranked, q) == jax_percentile(ranked, q)
    assert percentile([], 0.5) is None


def test_exporters_roundtrip(tmp_path):
    reg = MetricsRegistry()
    reg.counter("t_c", "a counter").inc(5)
    reg.gauge("t_g", "a gauge").set(2.5)
    h = reg.histogram("t_h", "a histogram", labels=("k",))
    h.labels(k="x").observe(0.03)
    h.labels(k="x").observe(0.3)
    path = str(tmp_path / "metrics.jsonl")
    reg.export_jsonl(path)
    reg.counter("t_c").inc(1)
    reg.export_jsonl(path)
    lines = [json.loads(ln) for ln in open(path)]
    assert len(lines) == 2 and lines[1]["ts"] >= lines[0]["ts"]
    assert lines[0]["metrics"]["t_c"]["series"][0]["value"] == 5
    assert lines[1]["metrics"] == reg.snapshot()
    prom = reg.prometheus_text()
    assert "# TYPE t_c counter" in prom and "t_c 6" in prom
    assert "t_g 2.5" in prom
    assert 't_h_count{k="x"} 2' in prom
    assert 't_h_bucket{k="x",le="0.05"} 1' in prom
    assert 't_h_bucket{k="x",le="+Inf"} 2' in prom


def test_metrics_http_server():
    reg = MetricsRegistry()
    reg.counter("t_http", "served").inc(3)
    tl = TraceTimeline(capacity=16)
    tl.instant("ping")
    srv = obs.MetricsServer(registry=reg, timeline=tl, port=0).start()
    try:
        assert srv._httpd.server_address[0] == "127.0.0.1"
        base = "http://127.0.0.1:%d" % srv.port
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        assert "t_http 3" in text
        trace = json.loads(
            urllib.request.urlopen(base + "/trace").read().decode())
        assert trace["traceEvents"][0]["name"] == "ping"
        assert urllib.request.urlopen(base + "/healthz").read() == b"ok\n"
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# trace timeline
# ---------------------------------------------------------------------------
def test_ring_buffer_bound_under_sustained_spans():
    tl = TraceTimeline(capacity=128)
    for i in range(2000):
        tl.add_span("s%d" % i, i * 1e-3, 1e-4)
    assert len(tl) == 128
    assert tl.dropped == 2000 - 128
    names = [e["name"] for e in tl.events()]
    assert names[0] == "s%d" % (2000 - 128)   # oldest evicted first
    assert names[-1] == "s1999"
    tl.clear()
    assert len(tl) == 0 and tl.dropped == 0


def test_chrome_trace_schema_and_torch_profiler_merge(tmp_path):
    """Spans nest and are thread-aware; a real ``torch.profiler`` Chrome
    trace (a file, or a directory of them) merges into the export."""
    tl = TraceTimeline(capacity=1024)
    with tl.span("outer", cat="loop", args={"epoch": 0}):
        with tl.span("inner"):
            pass
        tl.instant("commit", cat="serve", args={"step": 3})
    t = threading.Thread(target=lambda: tl.add_span("other-thread", 0.0,
                                                    1e-3))
    t.start()
    t.join()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    tdir = tmp_path / "torch"
    tdir.mkdir()
    prof.export_chrome_trace(str(tdir / "host.json"))
    out = str(tmp_path / "trace.json")
    for where in (str(tdir), str(tdir / "host.json")):
        tl.export(out, trace_dir=where)
        payload = json.load(open(out))
        names = assert_chrome_trace(payload, ("outer", "inner", "commit",
                                              "other-thread", "aten::mm"))
    own = [e for e in payload["traceEvents"] if e["name"] in (
        "outer", "inner", "commit", "other-thread")]
    tids = {e["tid"] for e in own if e["name"] in ("outer", "other-thread")}
    assert len(tids) == 2          # thread-aware
    for e in own:
        assert isinstance(e["ts"], int) and e["ph"] in ("X", "i")
    by = {e["name"]: e for e in own}
    assert by["outer"]["ts"] <= by["inner"]["ts"]
    assert by["inner"]["ts"] + by["inner"]["dur"] \
        <= by["outer"]["ts"] + by["outer"]["dur"]
    assert "aten::mm" in names


# ---------------------------------------------------------------------------
# profiler facade
# ---------------------------------------------------------------------------
def test_request_stats_p95_and_percentile_guard():
    profiler.reset_step_stats()
    for i in range(20):
        profiler.record_request(0.001 * i, 0.01 * (i + 1), 10 + i, 0.1)
    stats = profiler.step_stats()["requests"]
    assert stats["count"] == 20
    for key in ("queue_wait_p50_s", "queue_wait_p95_s", "ttft_p50_s",
                "ttft_p95_s", "decode_tokens_per_sec_p50",
                "decode_tokens_per_sec_p95"):
        assert stats[key] is not None and stats[key] >= 0
    assert stats["decode_tokens_per_sec_p95"] >= \
        stats["decode_tokens_per_sec_p50"]
    assert profiler._percentile([], 0.5) is None
    profiler.reset_step_stats()
    assert "requests" not in profiler.step_stats()


def test_profiler_start_clears_stale_events(tmp_path):
    fname = str(tmp_path / "p.json")
    obs.timeline.add_span("stale-span", 0.0, 1e-3)
    profiler.profiler_set_config(filename=fname)
    profiler.profiler_set_state("run")
    with profiler.Scope("fresh-span"):
        pass
    profiler.profiler_set_state("stop")
    profiler.dump_profile()
    names = {e.get("name") for e in json.load(open(fname))["traceEvents"]}
    assert "fresh-span" in names
    assert "stale-span" not in names


def _profiled(fname, fn):
    profiler.profiler_set_config(filename=fname)
    profiler.profiler_set_state("run")
    try:
        fn()
    finally:
        profiler.profiler_set_state("stop")
    profiler.dump_profile()
    return json.load(open(fname))


def test_imperative_ops_record_spans(tmp_path):
    def drive():
        with mt.cpu():
            a = mt.nd.array(np.ones((4, 4), np.float32))
            b = mt.nd.array(np.ones((4, 4), np.float32))
            (a + b).asnumpy()
            mt.nd.dot(a, b).asnumpy()

    payload = _profiled(str(tmp_path / "prof.json"), drive)
    names = assert_chrome_trace(payload, ("dot",))
    # the torch.profiler capture rides in the same file
    assert any(str(n).startswith("aten::") for n in names)


def _fc_module():
    net = mt.sym.SoftmaxOutput(
        mt.sym.FullyConnected(mt.sym.Variable("data"), name="fc",
                              num_hidden=3), name="softmax")
    return mt.mod.Module(net, context=mt.cpu())


def test_monitored_executor_records_per_node_spans(tmp_path):
    mod = _fc_module()
    mod.bind(data_shapes=[("data", (4, 6))],
             label_shapes=[("softmax_label", (4,))])
    mt.random.seed(0)
    mod.init_params(mt.initializer.Uniform(0.1))
    mod.init_optimizer()
    mon = mt.monitor.Monitor(interval=1)
    mod.install_monitor(mon)
    rng = np.random.RandomState(0)
    with mt.cpu():
        batch = DataBatch(
            [mt.nd.array(rng.rand(4, 6).astype(np.float32))],
            [mt.nd.array(rng.randint(0, 3, (4,)).astype(np.float32))])

    def drive():
        mon.tic()
        mod.forward(batch, is_train=False)
        mon.toc()

    names = assert_chrome_trace(_profiled(str(tmp_path / "p2.json"), drive),
                                ("fc", "softmax"))
    assert "fc" in names


def test_fit_with_monitor_taps():
    """fit(monitor=...) observes per-op outputs (the monitor drops the
    compiled step); the fit loop's steps and input waits land in
    step_stats and its epoch on the timeline."""
    mod = _fc_module()

    class Iter:
        batch_size = 4
        provide_data = [("data", (4, 6))]
        provide_label = [("softmax_label", (4,))]

        def __iter__(self):
            rng = np.random.RandomState(0)
            for _ in range(2):
                with mt.cpu():
                    yield DataBatch(
                        [mt.nd.array(rng.rand(4, 6).astype(np.float32))],
                        [mt.nd.array(rng.randint(0, 3, (4,))
                                     .astype(np.float32))])

        def reset(self):
            pass

    seen = []
    mon = mt.monitor.Monitor(interval=1)
    orig = mon._observe

    def spy(name, arr):
        seen.append(name)
        return orig(name, arr)

    mon._observe = spy
    profiler.reset_step_stats()
    before = len(obs.timeline)
    mod.fit(Iter(), num_epoch=1, monitor=mon,
            optimizer_params={"learning_rate": 0.1})
    assert mod._train_step is None
    assert "fc_output" in seen
    assert profiler.step_stats()["steps"] == 2
    assert any(e["name"] == "fit_epoch"
               for e in obs.timeline.events()[before:])


# ---------------------------------------------------------------------------
# the zero-overhead contract
# ---------------------------------------------------------------------------
@pytest.fixture
def telemetry(request):
    """Set MXNET_TELEMETRY and refresh the config cache; restores on
    teardown."""
    orig = os.environ.get("MXNET_TELEMETRY")

    def set_(on):
        os.environ["MXNET_TELEMETRY"] = "1" if on else "0"
        config.refresh("MXNET_TELEMETRY")

    def fin():
        if orig is None:
            os.environ.pop("MXNET_TELEMETRY", None)
        else:
            os.environ["MXNET_TELEMETRY"] = orig
        config.refresh("MXNET_TELEMETRY")

    request.addfinalizer(fin)
    return set_


def _paged_serve():
    """A shared-prefix paged int8 serve on a fresh predictor: tokens,
    trace counts and the GRAPH_STATS deltas."""
    with mt.NameManager():
        sym = attention_lm.get_symbol(17, 16, num_layers=2, embed=8,
                                      heads=2, ffn_hidden=16)
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = sym.infer_shape(data=(2, 16), softmax_label=(2, 16))
    params = {n: rng.normal(0, 0.5, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    pred = DecodePredictor(sym, params, cache_len=16, device="cpu",
                           paged=True, kv_dtype="int8", page_tokens=4,
                           prefill_chunk=4)
    srv = DecodeServer(pred, 12, slots=2, max_new_tokens=6)
    prefix = rng.randint(0, 17, 7)
    for n in (2, 5, 3):
        srv.submit(np.concatenate([prefix, rng.randint(0, 17, n)]))
    stats = dict(programs.GRAPH_STATS)
    res = srv.run()
    graph = {k: programs.GRAPH_STATS[k] - stats[k]
             for k in ("captures", "replays")}
    return res, pred.trace_counts, graph


def test_telemetry_is_free_and_off_records_nothing(telemetry):
    """Telemetry on vs off: the same tokens, captures and replays (the
    programs are the same; the telemetry runs around them), the serving
    programs' roofline rows and spans only when on, and with it off
    nothing reaches the timeline or the roofline table."""
    telemetry(True)
    obs.programs.reset()
    before = len(obs.timeline)
    on = _paged_serve()
    rows = {r["program"]: r for r in obs.mfu_table()}
    spans = {e["name"] for e in obs.timeline.events()[before:]}
    telemetry(False)
    obs.programs.reset(clear_static=True)
    obs.timeline.clear()
    off = _paged_serve()
    for rid in on[0]:
        np.testing.assert_array_equal(on[0][rid], off[0][rid])
    assert on[1] == off[1] and on[2] == off[2]
    assert len(obs.timeline) == 0 and obs.mfu_table() == []
    with obs.span("should-not-record"):
        obs.instant("nor-this")
    with obs.program_span("nor-that"):
        pass
    assert len(obs.timeline) == 0
    # with telemetry on, every serving program of the serve has its row
    for name in ("paged_decode_step", "prefill_chunk", "slot_commit",
                 "page_fork"):
        assert rows[name]["calls"] > 0 and rows[name]["wall_s"] > 0
        assert rows[name]["bytes"] > 0
        assert name in spans
    assert rows["paged_decode_step"]["flops"] > 0
    assert rows["paged_decode_step"]["mfu"] is None      # no peak here
    assert {"admit", "retire", "prefill_chunk", "cow_fork"} <= spans
    telemetry(True)
    with obs.span("records"):
        pass
    assert len(obs.timeline) == 1


def test_roofline_counts_and_check_speed():
    """The static FLOPs rule (2·M·K·N a product, 4·rows·keys·E an
    attention) on the LM, the train step's row after a fit, the card's
    spec peaks (no TPU entry), and check_speed on the host."""
    from mxnet_tpu_torch.obs.roofline import (PEAK_FLOPS, graph_flops,
                                              symbol_shapes)

    assert all(k.startswith("NVIDIA") for k in PEAK_FLOPS)
    assert PEAK_FLOPS["NVIDIA H100"]["bfloat16"] == 989e12
    assert obs.peak_flops_for("cpu") == (None, "cpu")
    with mt.NameManager():
        sym = attention_lm.get_symbol(17, 16, num_layers=1, embed=8,
                                      heads=2, ffn_hidden=16)
    b, t, e, f, v = 2, 16, 8, 16, 17
    flops = graph_flops(sym, symbol_shapes(sym, data=(b, t),
                                           softmax_label=(b, t)))
    rows = b * t
    want = 2 * rows * (3 * e * e + e * e + e * f + f * e + e * v) \
        + 4 * rows * t * e
    assert flops == want
    x = np.random.RandomState(0).rand(4, 6).astype(np.float32)
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), name="fc",
                                num_hidden=3)
    secs = check_speed(net, location={"data": x}, ctx=mt.cpu(), N=3)
    assert 0 < secs < 10
