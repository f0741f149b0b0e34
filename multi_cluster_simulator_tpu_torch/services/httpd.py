"""Routed threading HTTP server + client helpers.

The reference builds every control-plane surface on Go's stdlib ``net/http``
(mux handlers registered per path, e.g. pkg/scheduler/server.go:22-153,
pkg/registry/server.go:180-217). This is the Python-stdlib equivalent: one
``ThreadingHTTPServer`` per service with a route table, plus tiny urllib
client helpers for the JSON POST / GET idioms the services use between each
other (http.Post with a JSON body, server.go:207; http.Get heartbeats,
registry/server.go:141).
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from multi_cluster_simulator_tpu_torch.services import telemetry

# A handler takes (body_bytes, headers_dict) and returns
# (status_code, body_bytes_or_None). Content type is JSON unless overridden.
Route = Callable[[bytes, dict], tuple[int, Optional[bytes]]]


class RoutedHTTPServer:
    """An HTTP server with a (method, path) route table.

    ``port=0`` binds an ephemeral port (the reference picks random ports in
    [1025, 49151), cmd/scheduler/main.go:62-63 — the OS-assigned ephemeral
    port is the same capability without the collision risk).

    When a ``tracer`` is supplied, every dispatched request runs inside a
    server span whose parent is read from the ``TRACE_HEADER`` request
    header — the otelhttp.NewHandler middleware the reference wraps every
    service mux with (internal/service/service.go:37-38).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, logger=None,
                 tracer: Optional[telemetry.Tracer] = None):
        self.routes: dict[tuple[str, str], Route] = {}
        self.logger = logger
        self.tracer = tracer
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _dispatch(self, method: str):
                path, _, query = self.path.partition("?")
                fn = outer.routes.get((method, path))
                if fn is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                headers = dict(self.headers)
                if query:
                    # query strings reach handlers through a synthetic
                    # header — the Route signature stays (body, headers)
                    # for every existing wire-parity handler (the serving
                    # tier's GET /quote?cluster=N reads it)
                    headers["X-MCS-Query"] = query
                try:
                    if outer.tracer is not None:
                        parent = headers.get(telemetry.TRACE_HEADER)
                        with outer.tracer.start_span(
                                f"{method} {path}", parent=parent,
                                kind="server"):
                            status, out = fn(body, headers)
                    else:
                        status, out = fn(body, headers)
                except Exception as e:  # route bug -> 500, keep serving
                    if outer.logger is not None:
                        outer.logger.error("handler %s %s failed: %r",
                                           method, path, e)
                    status, out = 500, repr(e).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out or b"")))
                self.end_headers()
                if out:
                    self.wfile.write(out)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_DELETE(self):
                self._dispatch("DELETE")

            def log_message(self, fmt, *args):  # quiet; services log themselves
                if outer.logger is not None:
                    outer.logger.debug("http: " + fmt, *args)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        self.host = host
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}"

    def route(self, method: str, path: str, fn: Route) -> None:
        self.routes[(method, path)] = fn

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=f"httpd:{self.port}", daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# client helpers
# ---------------------------------------------------------------------------

def _trace_headers(headers: dict) -> dict:
    """Inject the active span context, if any — otelhttp.NewTransport
    (pkg/scheduler/server.go:47, pkg/client/server.go:57)."""
    ctx = telemetry.current_context()
    if ctx is not None:
        headers = {**headers, telemetry.TRACE_HEADER: ctx}
    return headers


def post_json(url: str, obj, timeout: float = 5.0) -> tuple[int, bytes]:
    """http.Post(url, "application/json", body) — returns (status, body).
    Transport errors surface as status 0."""
    data = json.dumps(obj).encode()
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers=_trace_headers({"Content-Type": "application/json"}))
    return _do(req, timeout)


def post_bytes(url: str, data: bytes, content_type: str = "text/plain",
               timeout: float = 5.0) -> tuple[int, bytes]:
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers=_trace_headers({"Content-Type": content_type}))
    return _do(req, timeout)


def get(url: str, timeout: float = 5.0) -> tuple[int, bytes]:
    return _do(urllib.request.Request(url, method="GET",
                                      headers=_trace_headers({})), timeout)


def delete(url: str, data: bytes = b"", timeout: float = 5.0) -> tuple[int, bytes]:
    req = urllib.request.Request(
        url, data=data, method="DELETE",
        headers=_trace_headers({"Content-Type": "text/plain"}))
    return _do(req, timeout)


def _do(req, timeout: float) -> tuple[int, bytes]:
    import http.client

    try:
        with urllib.request.urlopen(req, timeout=timeout) as res:
            return res.status, res.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except (urllib.error.URLError, OSError, TimeoutError,
            http.client.HTTPException):
        # HTTPException covers a server dying MID-RESPONSE
        # (IncompleteRead after the status line — a kill -9 between write
        # and flush): same retryable transport failure as a refused
        # connection, and the caller must not assume the request was or
        # was not processed (tools/chaos.py leans on exactly that)
        return 0, b""
