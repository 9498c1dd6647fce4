"""Typed, labeled metrics behind one thread-safe registry — the port's
copy of ``mxnet_tpu/obs/metrics.py`` (pure Python and numpy; the same
operations give the same snapshots and the same Prometheus text).

Every counter the framework keeps (the profiler's loop accounting, the
serving loop's counters, the fleet's per-host families) is a declared
metric in a :class:`MetricsRegistry`: named, typed (counter / gauge /
histogram), optionally labeled, and mutated only under the registry
lock, so concurrent writers (the fit loop, prefetch workers, a serving
loop, the HTTP exporter) can never tear an update.

Export paths:

* :meth:`MetricsRegistry.snapshot` — a plain dict (the programmatic
  read ``profiler.step_stats`` is built on);
* :meth:`MetricsRegistry.export_jsonl` — append ONE JSON line per call
  (``{"ts": ..., "metrics": {...}}``), the periodic-flush format
  (:class:`PeriodicExporter`, ``MXNET_METRICS_EXPORT`` /
  ``MXNET_METRICS_EXPORT_PERIOD``);
* :meth:`MetricsRegistry.prometheus_text` — the Prometheus text
  exposition format, served over HTTP by
  :class:`~mxnet_tpu_torch.obs.prom.MetricsServer` (``MXNET_METRICS_PORT``
  on :class:`~mxnet_tpu_torch.decode.DecodeServer`).

Histograms keep (a) running count/sum, (b) cumulative bucket counts for
Prometheus, and (c) a bounded reservoir of recent samples from which
:meth:`Histogram.percentile` computes numpy-exact percentiles.
"""
from __future__ import annotations

import json
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "PeriodicExporter", "percentile", "DEFAULT_BUCKETS",
           "DEFAULT_SAMPLE_CAP"]

# prometheus-client's defaults: latencies from 1ms to 10s
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)
# retained samples per histogram series (the old profiler._requests cap)
DEFAULT_SAMPLE_CAP = 4096


def percentile(values, q):
    """Nearest-rank percentile of a sorted list; ``None`` when empty (the
    old ``profiler._percentile`` indexed into an empty list and raised)."""
    if not values:
        return None
    idx = min(len(values) - 1, max(0, int(round(q * (len(values) - 1)))))
    return values[idx]


def _escape_label(v):
    return str(v).replace("\\", r"\\").replace('"', r"\"") \
        .replace("\n", r"\n")


def _fmt_labels(label_names, label_values, extra=None):
    pairs = ["%s=\"%s\"" % (n, _escape_label(v))
             for n, v in zip(label_names, label_values)]
    if extra:
        pairs.extend("%s=\"%s\"" % (n, _escape_label(v))
                     for n, v in extra)
    return "{%s}" % ",".join(pairs) if pairs else ""


class _Metric:
    """One metric family: a name, a type, declared label names, and one
    child series per distinct label-value tuple.  With no labels the
    family IS its single series — ``inc``/``set``/``observe`` work
    directly on it."""

    kind = None

    def __init__(self, name, help, label_names, lock):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = lock
        self._series = {}
        if not self.label_names:
            self._series[()] = self._new_series()

    def _new_series(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        """A bound child for one label-value combination (created on
        first use) exposing the family's mutators.  Accepts positional
        values in declared order or keyword form."""
        if kv:
            if values:
                raise ValueError("pass labels positionally or by keyword, "
                                 "not both")
            values = tuple(kv[n] for n in self.label_names)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError("%s expects labels %s, got %r"
                             % (self.name, self.label_names, values))
        with self._lock:
            child = self._series.get(values)
            if child is None:
                child = self._series[values] = self._new_series()
            return self._bind(child)

    def _bind(self, series):
        raise NotImplementedError

    def _default(self):
        if self.label_names:
            raise ValueError("%s is labeled (%s); call .labels(...) first"
                             % (self.name, self.label_names))
        return self._series[()]

    def reset(self):
        with self._lock:
            if self.label_names:
                self._series.clear()
            else:
                self._series[()] = self._new_series()

    def series(self):
        with self._lock:
            return list(self._series.items())

    def reset_series(self, *values, **kv):
        """Zero ONE labeled child series (other labels untouched) — how
        a fleet router cold-starts its own hosts' TTFT samples between
        timed drains without clearing other hosts' history.  No-op when
        the series does not exist yet."""
        if kv:
            if values:
                raise ValueError("pass labels positionally or by keyword, "
                                 "not both")
            values = tuple(kv[n] for n in self.label_names)
        values = tuple(str(v) for v in values)
        with self._lock:
            old = self._series.get(values)
            if old is None:
                return
            # zero IN PLACE: bound children (DecodeServer holds one per
            # host label) must keep recording into the same series
            fresh = self._new_series()
            for slot in old.__slots__:
                setattr(old, slot, getattr(fresh, slot))


class _CounterSeries:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _BoundCounter:
    __slots__ = ("_family", "_series")

    def __init__(self, family, series):
        self._family = family
        self._series = series

    def inc(self, n=1.0):
        self._family._inc(self._series, n)

    def get(self):
        with self._family._lock:
            return self._series.value


class Counter(_Metric):
    """Monotonically increasing value (``inc`` rejects negatives)."""

    kind = "counter"

    def _new_series(self):
        return _CounterSeries()

    def _bind(self, series):
        return _BoundCounter(self, series)

    def inc(self, n=1.0):
        self._inc(self._default(), n)

    def _inc(self, series, n):
        if n < 0:
            raise ValueError("counter %s cannot decrease" % self.name)
        with self._lock:
            series.value += n

    def get(self):
        with self._lock:
            return self._default().value


class _GaugeSeries:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _BoundGauge:
    __slots__ = ("_family", "_series")

    def __init__(self, family, series):
        self._family = family
        self._series = series

    def set(self, v):
        with self._family._lock:
            self._series.value = float(v)

    def inc(self, n=1.0):
        with self._family._lock:
            self._series.value += n

    def get(self):
        with self._family._lock:
            return self._series.value


class Gauge(_Metric):
    """A value that can go anywhere (pool utilization, last-write ms)."""

    kind = "gauge"

    def _new_series(self):
        return _GaugeSeries()

    def _bind(self, series):
        return _BoundGauge(self, series)

    def set(self, v):
        with self._lock:
            self._default().value = float(v)

    def inc(self, n=1.0):
        with self._lock:
            self._default().value += n

    def get(self):
        with self._lock:
            return self._default().value


class _HistogramSeries:
    __slots__ = ("count", "sum", "buckets", "samples", "cap")

    def __init__(self, nbuckets, cap):
        self.count = 0
        self.sum = 0.0
        self.buckets = [0] * nbuckets     # cumulative at export time? no:
        self.samples = []                 # bounded reservoir (recent)
        self.cap = cap


class Histogram(_Metric):
    """Distribution: running count/sum, per-bucket counts (Prometheus
    cumulative form is assembled at export), and a bounded buffer of the
    most recent samples for numpy-exact percentiles."""

    kind = "histogram"

    def __init__(self, name, help, label_names, lock, buckets=None,
                 sample_cap=DEFAULT_SAMPLE_CAP):
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self.sample_cap = int(sample_cap)
        super().__init__(name, help, label_names, lock)

    def _new_series(self):
        return _HistogramSeries(len(self.buckets) + 1, self.sample_cap)

    def _bind(self, series):
        return _BoundHistogram(self, series)

    def observe(self, v):
        self._observe(self._default(), v)

    def _observe(self, series, v):
        v = float(v)
        with self._lock:
            series.count += 1
            series.sum += v
            i = 0
            for i, b in enumerate(self.buckets):
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            series.buckets[i] += 1
            series.samples.append(v)
            if len(series.samples) > series.cap:
                del series.samples[:len(series.samples) - series.cap]

    @property
    def count(self):
        with self._lock:
            return self._default().count

    @property
    def sum(self):
        with self._lock:
            return self._default().sum

    def percentile(self, q):
        """The q-quantile (q in [0, 1]) over the retained samples,
        computed by ``numpy.percentile`` (linear interpolation — exactly
        what a numpy cross-check of the same samples yields); ``None``
        when nothing has been observed."""
        import numpy as np

        with self._lock:
            samples = list(self._default().samples)
        if not samples:
            return None
        return float(np.percentile(samples, q * 100.0))

    def sorted_samples(self):
        with self._lock:
            return sorted(self._default().samples)


class _BoundHistogram:
    __slots__ = ("_family", "_series")

    def __init__(self, family, series):
        self._family = family
        self._series = series

    def observe(self, v):
        self._family._observe(self._series, v)

    @property
    def count(self):
        with self._family._lock:
            return self._series.count

    @property
    def sum(self):
        with self._family._lock:
            return self._series.sum

    def percentile(self, q):
        import numpy as np

        with self._family._lock:
            samples = list(self._series.samples)
        if not samples:
            return None
        return float(np.percentile(samples, q * 100.0))


class MetricsRegistry:
    """Get-or-create metric families by name; one lock guards every
    mutation and every read, so snapshots are internally consistent."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics = {}

    # ------------------------------------------------------------------
    def _declare(self, cls, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        "metric %r already registered as %s, not %s"
                        % (name, m.kind, cls.kind))
                return m
            m = cls(name, help, tuple(labels), self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labels=()):
        return self._declare(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self._declare(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(), buckets=None,
                  sample_cap=DEFAULT_SAMPLE_CAP):
        return self._declare(Histogram, name, help, labels,
                             buckets=buckets, sample_cap=sample_cap)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def reset(self):
        """Zero every series (the ``profiler.reset_step_stats`` path —
        declared families survive, values restart)."""
        with self._lock:
            for m in self._metrics.values():
                m.reset()

    # ------------------------------------------------------------------
    # exporters
    # ------------------------------------------------------------------
    def snapshot(self):
        """``{name: {type, help, label_names, series: [...]}}`` with each
        series ``{"labels": {...}, "value": v}`` (histograms: a dict of
        count/sum/min/max/p50/p95/p99)."""
        import numpy as np

        with self._lock:
            metrics = list(self._metrics.items())
        out = {}
        for name, m in metrics:
            rows = []
            for label_values, s in m.series():
                labels = dict(zip(m.label_names, label_values))
                if m.kind == "histogram":
                    with m._lock:
                        samples = list(s.samples)
                        count, total = s.count, s.sum
                    val = {"count": count, "sum": total}
                    if samples:
                        val.update({
                            "min": float(min(samples)),
                            "max": float(max(samples)),
                            "p50": float(np.percentile(samples, 50)),
                            "p95": float(np.percentile(samples, 95)),
                            "p99": float(np.percentile(samples, 99)),
                        })
                else:
                    with m._lock:
                        val = s.value
                rows.append({"labels": labels, "value": val})
            out[name] = {"type": m.kind, "help": m.help,
                         "label_names": list(m.label_names),
                         "series": rows}
        return out

    def export_jsonl(self, path):
        """Append one ``{"ts", "metrics"}`` JSON line to ``path``."""
        line = json.dumps({"ts": time.time(), "metrics": self.snapshot()})
        with open(path, "a") as f:
            f.write(line + "\n")
        return line

    def prometheus_text(self):
        """The Prometheus text exposition format (served by
        :class:`~mxnet_tpu_torch.obs.prom.MetricsServer`)."""
        lines = []
        with self._lock:
            metrics = list(self._metrics.items())
        for name, m in sorted(metrics):
            if m.help:
                lines.append("# HELP %s %s" % (name, m.help))
            lines.append("# TYPE %s %s" % (name, m.kind))
            for label_values, s in m.series():
                lab = _fmt_labels(m.label_names, label_values)
                if m.kind == "histogram":
                    with m._lock:
                        buckets = list(s.buckets)
                        count, total = s.count, s.sum
                    cum = 0
                    for bound, n in zip(m.buckets, buckets):
                        cum += n
                        lines.append("%s_bucket%s %d" % (
                            name, _fmt_labels(m.label_names, label_values,
                                              [("le", "%g" % bound)]),
                            cum))
                    lines.append("%s_bucket%s %d" % (
                        name, _fmt_labels(m.label_names, label_values,
                                          [("le", "+Inf")]), count))
                    lines.append("%s_sum%s %g" % (name, lab, total))
                    lines.append("%s_count%s %d" % (name, lab, count))
                else:
                    with m._lock:
                        v = s.value
                    lines.append("%s%s %g" % (name, lab, v))
        return "\n".join(lines) + "\n"


class PeriodicExporter:
    """Background JSON-lines flusher: one snapshot line every ``period``
    seconds (armed by ``MXNET_METRICS_EXPORT`` +
    ``MXNET_METRICS_EXPORT_PERIOD``).  Daemon thread; :meth:`stop`
    flushes once more on the way out."""

    def __init__(self, registry, path, period):
        self.registry = registry
        self.path = path
        self.period = float(period)
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="mxtpu-metrics-export")
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.period):
            try:
                self.registry.export_jsonl(self.path)
            except OSError:
                pass  # disk hiccup; next period retries

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.period + 1)
            self._thread = None
        try:
            self.registry.export_jsonl(self.path)
        except OSError:
            pass
