"""Always-on trace timeline — bounded ring buffer, Chrome-trace export
(the port of ``mxnet_tpu/obs/trace.py``).

A span / instant-event API whose storage is a fixed-capacity ring buffer
(``MXNET_TRACE_BUFFER`` events, oldest evicted first), so leaving it
armed costs one deque append per event and bounded memory.

Events are thread-aware (every record carries the writing thread's id)
and nest naturally: complete ("X") events with overlapping [ts, ts+dur)
on one thread render as a flame stack in any Chrome-trace viewer.
:meth:`TraceTimeline.export` writes the standard ``{"traceEvents":
[...]}`` JSON — open it at ``chrome://tracing`` or
https://ui.perfetto.dev — and merges the Chrome JSON that
``torch.profiler`` writes (``prof.export_chrome_trace(path)``: a file,
or a directory of such files) when one is given, so host spans and the
card's kernels open as one view.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import threading
import time
from collections import deque

__all__ = ["TraceTimeline", "DEFAULT_CAPACITY", "profiler_trace_events"]

DEFAULT_CAPACITY = 65536


class TraceTimeline:
    """Bounded, thread-safe event ring buffer in Chrome-trace form."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._buf = deque(maxlen=int(capacity))
        self._total = 0  # events ever added (dropped = total - len)

    @property
    def capacity(self):
        return self._buf.maxlen

    @property
    def dropped(self):
        """Events evicted by the ring bound since the last clear."""
        with self._lock:
            return max(0, self._total - len(self._buf))

    def __len__(self):
        with self._lock:
            return len(self._buf)

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def _push(self, ev):
        with self._lock:
            self._buf.append(ev)
            self._total += 1

    def add_span(self, name, t0, dur, cat="host", tid=None, args=None):
        """One complete ("X") event: ``t0`` epoch seconds, ``dur``
        seconds.  Used both live (the :meth:`span` context manager) and
        retroactively (``profiler.record_host_wait`` knows the duration
        only after the wait)."""
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": int(t0 * 1e6), "dur": max(int(dur * 1e6), 0),
              "pid": os.getpid(),
              "tid": tid if tid is not None else threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        self._push(ev)

    def instant(self, name, cat="event", args=None, scope="t"):
        """One instant ("i") event — admissions, retirements, COW forks,
        swaps, prefill-chunk windows.  ``scope`` "t"=thread,
        "p"=process, "g"=global."""
        ev = {"name": name, "cat": cat, "ph": "i", "s": scope,
              "ts": int(time.time() * 1e6), "pid": os.getpid(),
              "tid": threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        self._push(ev)

    def span(self, name, cat="host", args=None):
        """Context manager recording one complete event around the body
        (nests: inner spans on the same thread stack in the viewer)."""
        return _LiveSpan(self, name, cat, args)

    # ------------------------------------------------------------------
    def events(self):
        """A consistent copy of the current ring contents."""
        with self._lock:
            return list(self._buf)

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._total = 0

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def export(self, path=None, trace_dir=None, extra_events=None):
        """The Chrome-trace payload dict; written as JSON to ``path``
        when given.  ``trace_dir`` (a ``torch.profiler`` Chrome trace
        file, or a directory scanned for ``*.json[.gz]`` ones) has its
        ``traceEvents`` merged in — host spans and the card's kernels
        open as one Perfetto view."""
        events = self.events()
        if extra_events:
            events.extend(extra_events)
        if trace_dir:
            events.extend(profiler_trace_events(trace_dir))
        payload = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(payload, f)
        return payload


class _LiveSpan:
    __slots__ = ("_tl", "_name", "_cat", "_args", "_t0")

    def __init__(self, timeline, name, cat, args):
        self._tl = timeline
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self._tl.add_span(self._name, self._t0, time.time() - self._t0,
                          cat=self._cat, args=self._args)
        return False


def profiler_trace_events(where):
    """Best-effort: the Chrome-format events of ``torch.profiler``
    traces — ``where`` is one file or a directory searched for
    ``*.json`` / ``*.json.gz``.  Unreadable files are skipped (the merge
    must never break an export), and so are records without a phase or
    without a name (metadata "M" records excepted)."""
    if os.path.isdir(where):
        files = []
        for pattern in ("**/*.json", "**/*.json.gz"):
            files.extend(glob.glob(os.path.join(where, pattern),
                                   recursive=True))
    else:
        files = [where]
    events = []
    for fname in sorted(files):
        try:
            opener = gzip.open if fname.endswith(".gz") else open
            with opener(fname, "rt") as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        found = payload.get("traceEvents") \
            if isinstance(payload, dict) else None
        if found:
            events.extend(e for e in found
                          if isinstance(e, dict) and e.get("ph")
                          and ("name" in e or e["ph"] == "M"))
    return events
