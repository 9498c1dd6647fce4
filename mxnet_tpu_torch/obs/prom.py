"""Tiny HTTP exporter for the metrics registry + trace timeline (the
port of ``mxnet_tpu/obs/prom.py``, on the standard-library HTTP server).
:class:`~mxnet_tpu_torch.decode.DecodeServer` starts one when
``MXNET_METRICS_PORT`` (or its ``metrics_port`` argument) is set.

Endpoints:

* ``/metrics``       — Prometheus text exposition
  (:meth:`MetricsRegistry.prometheus_text`);
* ``/metrics.json``  — the registry snapshot as JSON, merged with any
  registered JSON providers (:meth:`MetricsServer.add_json`) — e.g. the
  serving loop's per-host ``mx_serve_summary:<host>`` routing views
  (prefix-cache chain digest + free-page/queue-depth signals) the
  fleet router polls;
* ``/trace``         — the current trace-timeline ring as Chrome-trace
  JSON (save it, open in Perfetto);
* ``/healthz``       — liveness probe (``ok``).

The server runs on a daemon thread and binds ``127.0.0.1`` by default —
expose it deliberately (a reverse proxy, ``host="0.0.0.0"``), not by
accident.  ``port=0`` binds an ephemeral port (tests); read it back from
:attr:`MetricsServer.port` after :meth:`start`.
"""
from __future__ import annotations

import json
import threading

__all__ = ["MetricsServer"]


class MetricsServer:
    """Serve one registry (+ optional timeline) over HTTP."""

    def __init__(self, registry=None, timeline=None, port=0,
                 host="127.0.0.1"):
        if registry is None or timeline is None:
            from . import registry as default_registry
            from . import timeline as default_timeline

            registry = registry or default_registry
            timeline = timeline if timeline is not None \
                else default_timeline
        self.registry = registry
        self.timeline = timeline
        self._host = host
        self._port = int(port)
        self._httpd = None
        self._thread = None
        self._json = {}     # extra /metrics.json sections: name -> fn

    def add_json(self, name, provider):
        """Merge ``provider()`` (a JSON-serializable dict) into the
        ``/metrics.json`` payload under ``name`` — how the serving loop
        exposes non-scalar state (the prefix-cache chain summary) next
        to the registry snapshot.  Re-registering a name replaces it;
        servers sharing one port therefore register DISTINCT names
        (``mx_serve_summary:<host>``)."""
        self._json[str(name)] = provider
        return self

    def remove_json(self, name):
        """Drop a registered ``/metrics.json`` section (a renamed host
        re-registers under its new label)."""
        self._json.pop(str(name), None)
        return self

    @property
    def port(self):
        """The bound port (resolves ``port=0`` after :meth:`start`)."""
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._port

    def start(self):
        if self._httpd is not None:
            return self
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registry, timeline = self.registry, self.timeline
        extra_json = self._json

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                path = self.path.split("?", 1)[0]
                if path in ("/metrics", "/"):
                    body = registry.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4"
                elif path == "/metrics.json":
                    payload = registry.snapshot()
                    for name, fn in list(extra_json.items()):
                        try:
                            payload[name] = fn()
                        except Exception as exc:  # a dead provider must
                            payload[name] = {"error": str(exc)}  # not 500
                    body = json.dumps(payload).encode()
                    ctype = "application/json"
                elif path == "/trace" and timeline is not None:
                    body = json.dumps(timeline.export()).encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="mxtpu-metrics-http")
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
