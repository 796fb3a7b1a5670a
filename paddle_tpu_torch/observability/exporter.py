"""Prometheus pull endpoint — the minimal ``/metrics`` HTTP server.

The registry renders text exposition on demand (:func:`render_prometheus`);
this module puts it behind the standard scrape interface so a Prometheus (or
curl) can pull it without the serving loop doing any push-side work.  Pure
stdlib, daemon-threaded, and zero-cost to the engine: each scrape renders the
registry on the handler thread.

Usage::

    from paddle_tpu_torch import observability as obs

    obs.enable()
    server = obs.start_metrics_server(port=9400)   # port=0 -> OS-assigned
    print(server.url)                              # http://127.0.0.1:9400/metrics
    ...
    server.close()
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class MetricsServer:
    """Handle on a running exporter: ``addr``/``port``/``url`` + ``close()``."""

    def __init__(self, httpd: ThreadingHTTPServer, thread: threading.Thread):
        self._httpd = httpd
        self._thread = thread
        self.addr, self.port = httpd.server_address[:2]
        self.url = f"http://{self.addr}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Handler(BaseHTTPRequestHandler):
    # text exposition format version per the Prometheus spec
    _CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def do_GET(self):  # noqa: N802 (stdlib handler API)
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        from . import render_prometheus
        body = render_prometheus().encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", self._CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):    # scrapes are not log events
        pass


def start_metrics_server(port: int = 0,
                         addr: str = "127.0.0.1") -> MetricsServer:
    """Serve the registry at ``http://addr:port/metrics`` from a daemon
    thread; ``port=0`` lets the OS pick (read it back from the returned
    handle).  The caller owns the handle: ``close()`` stops the server."""
    httpd = ThreadingHTTPServer((addr, port), _Handler)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              name="paddle-tpu-metrics", daemon=True)
    thread.start()
    return MetricsServer(httpd, thread)
