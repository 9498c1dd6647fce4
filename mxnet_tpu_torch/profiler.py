"""Profiler facade over the telemetry subsystem (the port of
``mxnet_tpu/profiler.py``; reference ``src/engine/profiler.{h,cc}`` and
``python/mxnet/profiler.py``).

The span store is ``obs.timeline`` (a bounded ring buffer) and the loop
counters live in ``obs.registry``; this module keeps the reference's
API.  ``profiler_set_state("run")`` also starts a ``torch.profiler``
capture (CPU activity, and the card's kernels where there is one), and
``dump_profile()`` writes the timeline's Chrome trace merged with the
capture's, so host spans and the card's kernels open as one Perfetto
view.

While the profiler runs, every imperative op (``ndarray.
imperative_invoke``) and every node of an eager graph walk
(``executor.run_graph`` outside a captured program) records a
:class:`Scope` span.
"""
from __future__ import annotations

import os
import threading
import time

from . import obs as _obs
from .obs.metrics import percentile as _nearest_rank

__all__ = ["profiler_set_config", "profiler_set_state", "dump_profile",
           "Scope", "start", "stop", "is_running", "record_host_wait",
           "record_input_wait", "record_step", "bump_metric_d2h",
           "bump_metric_sync", "record_request", "record_ckpt_stall",
           "record_ckpt_write", "bump_recovery", "step_stats",
           "reset_step_stats"]

_state = {"mode": "symbolic", "filename": "profile.json", "running": False,
          "torch_prof": None, "torch_trace": None}
_lock = threading.Lock()

# ---------------------------------------------------------------------------
# Training-loop step accounting (always on — counters only; op-granularity
# spans are recorded only while the profiler runs).  The fit loop reports
# where the host thread's time went: blocked on the card (host_wait),
# blocked on the input pipeline (input_wait), or free to run ahead.
# metric_d2h counts device->host copies on behalf of metrics.
# ---------------------------------------------------------------------------
_R = _obs.registry
_c_steps = _R.counter("mx_steps", "training steps dispatched")
_c_host_wait = _R.counter("mx_host_wait_seconds",
                          "host time blocked on device results")
_c_input_wait = _R.counter("mx_input_wait_seconds",
                           "host time blocked on the input pipeline")
_c_metric_d2h = _R.counter("mx_metric_d2h",
                           "device->host transfers on behalf of metrics")
_c_metric_syncs = _R.counter("mx_metric_syncs",
                             "device metric-accumulator drains")
_c_ckpt_stall = _R.counter("mx_ckpt_stall_seconds",
                           "loop-thread time spent on checkpoint work")
_c_ckpt_writes = _R.counter("mx_ckpt_writes",
                            "committed fence checkpoints")
_g_last_ckpt_ms = _R.gauge("mx_last_ckpt_ms",
                           "duration of the last committed checkpoint write")
_c_recoveries = _R.counter("mx_recoveries",
                           "elastic recovery events (resume/shrink/regrow)")
# per-request serving SLOs (decode.DecodeServer retirements); histograms
# keep a bounded sample reservoir
_c_requests = _R.counter("mx_requests", "served requests retired")
_c_req_tokens = _R.counter("mx_request_tokens",
                           "tokens delivered to retired requests")
_h_queue_wait = _R.histogram("mx_request_queue_wait_seconds",
                             "submit -> admission wait per request")
_h_ttft = _R.histogram("mx_request_ttft_seconds",
                       "submit -> first token per request")
_h_decode_rate = _R.histogram(
    "mx_request_decode_tokens_per_sec",
    "post-first-token decode rate per request",
    buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 5000, 10000))

_t0 = time.time()

# the families this facade owns (and may therefore zero)
_OWNED_METRICS = (_c_steps, _c_host_wait, _c_input_wait, _c_metric_d2h,
                  _c_metric_syncs, _c_ckpt_stall, _c_ckpt_writes,
                  _g_last_ckpt_ms, _c_recoveries, _c_requests,
                  _c_req_tokens, _h_queue_wait, _h_ttft, _h_decode_rate)


def _percentile(values, q):
    """Nearest-rank percentile of a sorted list — ``None`` on empty
    input."""
    return _nearest_rank(values, q)


def _loop_span(name, t0, dur):
    """Loop span (host_wait/input_wait/ckpt_*/request) into the bounded
    timeline; gated only by MXNET_TELEMETRY."""
    if _obs.enabled():
        _obs.timeline.add_span(name, t0, dur, cat="loop")


def record_host_wait(seconds):
    """Time the loop spent blocked on a device result (fence/metric sync)."""
    _c_host_wait.inc(seconds)
    _loop_span("host_wait", time.time() - seconds, seconds)


def record_input_wait(seconds):
    """Time the loop spent waiting for the input pipeline's next batch."""
    _c_input_wait.inc(seconds)
    _loop_span("input_wait", time.time() - seconds, seconds)


def record_step(n=1):
    """One (or n) training steps dispatched."""
    _c_steps.inc(n)


def bump_metric_d2h(n=1):
    """n device->host transfers performed on behalf of a metric."""
    _c_metric_d2h.inc(n)


def bump_metric_sync(n=1):
    """n device-accumulator drains (each moves the whole accumulator)."""
    _c_metric_syncs.inc(n)


def record_ckpt_stall(seconds):
    """Time the training loop's host thread spent on checkpointing."""
    _c_ckpt_stall.inc(seconds)
    _loop_span("ckpt_stall", time.time() - seconds, seconds)


def record_ckpt_write(ms):
    """One committed checkpoint written: duration in milliseconds."""
    _c_ckpt_writes.inc()
    _g_last_ckpt_ms.set(float(ms))
    _loop_span("ckpt_write", time.time() - ms / 1e3, ms / 1e3)


def bump_recovery(n=1):
    """n recovery events (resume from a checkpoint)."""
    _c_recoveries.inc(n)


def record_request(queue_wait_s, ttft_s, tokens, decode_s):
    """One served request retired (decode.DecodeServer): time queued
    before admission, time to first token (from submit), tokens
    delivered, and the wall time its post-first-token decode took."""
    tokens = int(tokens)
    _c_requests.inc()
    _c_req_tokens.inc(tokens)
    _h_queue_wait.observe(float(queue_wait_s))
    _h_ttft.observe(float(ttft_s))
    if tokens > 1:
        _h_decode_rate.observe((tokens - 1) / max(float(decode_s), 1e-9))
    _loop_span("request", time.time() - max(float(ttft_s), 0.0),
               max(float(ttft_s), 0.0))


def reset_step_stats():
    """Zero the loop counters, request histograms and the per-program
    roofline timings — a measurement window starts here.  Only the
    facade-owned series reset."""
    global _t0
    with _lock:
        for m in _OWNED_METRICS:
            m.reset()
        _obs.programs.reset()
        _t0 = time.time()


def step_stats():
    """Snapshot of loop accounting plus the derived ratios:
    ``input_stall_fraction`` (share of wall time blocked on input) and
    ``host_syncs_per_step`` (metric-driven d2h transfers per step)."""
    with _lock:
        t0 = _t0
    out = {
        "steps": int(_c_steps.get()),
        "host_wait_s": _c_host_wait.get(),
        "input_wait_s": _c_input_wait.get(),
        "metric_d2h": int(_c_metric_d2h.get()),
        "metric_syncs": int(_c_metric_syncs.get()),
        "ckpt_stall_s": _c_ckpt_stall.get(),
        "ckpt_writes": int(_c_ckpt_writes.get()),
        "last_ckpt_ms": _g_last_ckpt_ms.get(),
        "recoveries": int(_c_recoveries.get()),
    }
    wall = max(time.time() - t0, 1e-9)
    out["wall_s"] = wall
    nreq = int(_c_requests.get())
    if nreq:
        out["requests"] = {
            "count": nreq,
            "tokens": int(_c_req_tokens.get()),
            "queue_wait_p50_s": _h_queue_wait.percentile(0.50),
            "queue_wait_p95_s": _h_queue_wait.percentile(0.95),
            "ttft_p50_s": _h_ttft.percentile(0.50),
            "ttft_p95_s": _h_ttft.percentile(0.95),
        }
        if _h_decode_rate.count:
            out["requests"]["decode_tokens_per_sec_p50"] = \
                _h_decode_rate.percentile(0.50)
            out["requests"]["decode_tokens_per_sec_p95"] = \
                _h_decode_rate.percentile(0.95)
    out["input_stall_fraction"] = min(out["input_wait_s"] / wall, 1.0)
    out["host_wait_fraction"] = min(out["host_wait_s"] / wall, 1.0)
    out["checkpoint_stall_fraction"] = min(out["ckpt_stall_s"] / wall, 1.0)
    steps = max(out["steps"], 1)
    out["host_syncs_per_step"] = out["metric_d2h"] / steps
    return out


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """Set up the profiler (reference: python/mxnet/profiler.py:10)."""
    with _lock:
        _state["mode"] = mode
        _state["filename"] = filename


def _start_torch_profiler():
    """A running ``torch.profiler.profile`` (CPU activity, plus CUDA's
    when there is a card), or None when profiling is unavailable."""
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof
    except Exception:
        return None


def profiler_set_state(state="stop"):
    """'run' or 'stop' (reference: profiler.py:30), serialized under the
    module lock.  'run' clears the timeline (a fresh profile window) and
    starts a ``torch.profiler`` capture; 'stop' ends it and writes its
    Chrome trace beside the profile's file (``<name>_torch.json``)."""
    with _lock:
        if state == "run" and not _state["running"]:
            _obs.timeline.clear()
            _state["running"] = True
            _state["torch_trace"] = None
            _state["torch_prof"] = _start_torch_profiler()
        elif state == "stop" and _state["running"]:
            _state["running"] = False
            prof, _state["torch_prof"] = _state["torch_prof"], None
            if prof is not None:
                path = os.path.splitext(_state["filename"])[0] \
                    + "_torch.json"
                try:
                    prof.stop()
                    prof.export_chrome_trace(path)
                    _state["torch_trace"] = path
                except Exception:
                    _state["torch_trace"] = None


def start():
    profiler_set_state("run")


def stop():
    profiler_set_state("stop")


def is_running():
    return _state["running"]


class Scope:
    """Record one named span into the trace (engine OprExecStat analog).

    Op-granularity spans (imperative dispatch, eager per-node walks) are
    recorded only while the profiler runs; the loop-accounting spans
    above are always on."""

    def __init__(self, name, category="operator"):
        self.name = name
        self.category = category

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        if _state["running"] and _obs.enabled():
            _obs.timeline.add_span(self.name, self._t0,
                                   time.time() - self._t0,
                                   cat=self.category)
        return False


def dump_profile():
    """Write chrome-trace JSON (reference: profiler.py:46 dump_profile):
    the current timeline ring contents, merged with the events of the
    last ``torch.profiler`` capture."""
    with _lock:
        _obs.timeline.export(_state["filename"],
                             trace_dir=_state["torch_trace"])


# reference env_var.md:71-79 — start profiling at library load
from . import config as _config  # noqa: E402

if _config.get("MXNET_PROFILER_AUTOSTART"):
    start()
