"""mxnet_tpu_torch.obs — the telemetry subsystem (the port of
``mxnet_tpu/obs``).

Three layers, shared process-wide singletons:

* :data:`registry` — the typed/labeled metrics registry
  (:mod:`~mxnet_tpu_torch.obs.metrics`): counters, gauges, histograms
  behind one lock, with JSON-lines and Prometheus exporters;
* :data:`timeline` — the trace timeline (:mod:`~mxnet_tpu_torch.obs.
  trace`): a bounded ring buffer of thread-aware spans and instant
  events, exported as Chrome-trace JSON (Perfetto), merged with
  ``torch.profiler``'s Chrome traces;
* :data:`programs` — per-program roofline accounting
  (:mod:`~mxnet_tpu_torch.obs.roofline`): measured time per captured
  program joined against static FLOPs/bytes into the MFU table.

:mod:`~mxnet_tpu_torch.profiler` is the reference's facade over these.
Instrumentation is host-side only: spans, counters and clocks run
around a program's replay, never inside a captured body, so the same
graphs replay the same kernels with telemetry on or off
(``MXNET_TELEMETRY``).
"""
from __future__ import annotations

import threading as _threading
import time

from .. import config as _config
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      PeriodicExporter, percentile)
from .prom import MetricsServer
from .roofline import (PEAK_FLOPS, ProgramAccounting, auto_peak,
                       peak_flops_for, render_mfu_table)
from .trace import TraceTimeline

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsServer",
    "PEAK_FLOPS", "PeriodicExporter", "ProgramAccounting", "TraceTimeline",
    "auto_peak", "enabled", "instant", "mfu_table", "peak_flops_for",
    "percentile", "program_span", "programs", "registry",
    "render_mfu_table", "serve_metrics", "span", "timeline",
]

# ---------------------------------------------------------------------------
# process-wide singletons
# ---------------------------------------------------------------------------
registry = MetricsRegistry()
timeline = TraceTimeline(capacity=max(int(_config.get("MXNET_TRACE_BUFFER")),
                                      1))
programs = ProgramAccounting()


def enabled():
    """Whether telemetry recording is armed (``MXNET_TELEMETRY``).
    Counters predating the subsystem (``profiler.step_stats``'s loop
    accounting) stay on regardless; this gates the timeline spans /
    instant events and the per-program dispatch timing."""
    return bool(_config.get("MXNET_TELEMETRY"))


def mfu_table(peak_flops=None):
    """The per-program MFU/roofline table (see
    :meth:`~mxnet_tpu_torch.obs.roofline.ProgramAccounting.table`); the
    peak defaults to ``MXNET_PEAK_FLOPS`` or the card's bf16 spec
    figure."""
    return programs.table(auto_peak() if peak_flops is None else peak_flops)


# ---------------------------------------------------------------------------
# no-op-when-disabled recording helpers
# ---------------------------------------------------------------------------
class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class _ProgramSpan:
    """Times one program dispatch: feeds the roofline accounting (host
    wall and, on a CUDA device, a CUDA-event pair around the dispatch,
    both on the stream current at entry) and drops a span on the
    timeline (cat="program")."""

    __slots__ = ("_name", "_device", "_t0", "_w0", "_ev", "_stream")

    def __init__(self, name, device):
        self._name = name
        self._device = device

    def __enter__(self):
        self._ev = None
        if self._device is not None and self._device.type == "cuda":
            import torch

            self._stream = torch.cuda.current_stream(self._device)
            self._ev = programs.event_pair()
            self._ev[0].record(self._stream)
        self._t0 = time.perf_counter()
        self._w0 = time.time()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._ev is not None:
            self._ev[1].record(self._stream)
        programs.note(self._name, dt, self._ev)
        timeline.add_span(self._name, self._w0, dt, cat="program")
        return False


def program_span(name, device=None):
    """Context manager timing one dispatch of program ``name`` (no-op
    when telemetry is off); on a CUDA ``device`` the dispatch is also
    timed on the card."""
    return _ProgramSpan(name, device) if enabled() else _NULL


def span(name, cat="host", args=None):
    """Context manager recording one timeline span (no-op when off)."""
    return timeline.span(name, cat=cat, args=args) if enabled() else _NULL


def instant(name, cat="event", args=None):
    """Record one timeline instant event (no-op when off)."""
    if enabled():
        timeline.instant(name, cat=cat, args=args)


# ---------------------------------------------------------------------------
# process-wide HTTP exporters — one server per (host, port): a second
# DecodeServer configured for the same port reuses the first server
# ---------------------------------------------------------------------------
_servers = {}
_servers_lock = _threading.Lock()


def serve_metrics(port, host="127.0.0.1"):
    """Get-or-create the process-wide :class:`MetricsServer` bound to
    ``(host, port)``, serving the global registry and timeline."""
    key = (host, int(port))
    with _servers_lock:
        srv = _servers.get(key)
        if srv is None or srv._httpd is None:
            srv = MetricsServer(port=int(port), host=host).start()
            _servers[key] = srv
        return srv


# ---------------------------------------------------------------------------
# env-armed periodic JSON-lines export
# ---------------------------------------------------------------------------
_exporter = None


def _maybe_start_exporter():
    global _exporter
    path = _config.get("MXNET_METRICS_EXPORT")
    period = float(_config.get("MXNET_METRICS_EXPORT_PERIOD"))
    if _exporter is None and path and period > 0:
        _exporter = PeriodicExporter(registry, path, period).start()
    return _exporter


_maybe_start_exporter()
