"""Prometheus exposition over HTTP — stdlib only.

PyTorch counterpart of ``mxnet_tpu/observability/exposition.py``.

The registry's text format (``MetricsRegistry.to_prometheus``) served from a
daemon ``ThreadingHTTPServer``:

- ``GET /metrics``  → text exposition (content-type 0.0.4), the scrape
  endpoint a Prometheus job points at;
- ``GET /snapshot`` → the JSON ``snapshot()`` dict (human/debug surface);
- anything else     → 404.

``start_http_server(port=0)`` binds an ephemeral port (returned via
``.port``) so tests and multi-service processes never collide.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

__all__ = ["MetricsHTTPServer", "start_http_server"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHTTPServer:
    """A running exposition endpoint; ``close()`` (or context exit) stops it."""

    def __init__(self, port: int, registry):
        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path in ("/metrics", "/"):
                    body = reg.to_prometheus().encode()
                    ctype = PROMETHEUS_CONTENT_TYPE
                elif path == "/snapshot":
                    body = json.dumps(reg.snapshot()).encode()
                    ctype = "application/json"
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

        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="tpumx-metrics-http",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_http_server(port: int = 0, registry=None) -> MetricsHTTPServer:
    """Serve the (default) registry's ``/metrics`` + ``/snapshot`` on
    ``port`` (0 = ephemeral; read ``.port``)."""
    if registry is None:
        from . import registry as _default

        registry = _default()
    return MetricsHTTPServer(port, registry)
