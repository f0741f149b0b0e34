"""Centralized log service + client redirect.

Reference: log/ — a tiny HTTP sink whose ``POST /log`` handler appends each
body to a destination file (log/server.go:12-40; cmd/log writes
``./grading.log``), and a client shim that redirects a service's stdlib
logger output to HTTP POSTs with a ``[ServiceName] - `` prefix
(log/client.go:12-32).
"""

from __future__ import annotations

import logging
import threading

from multi_cluster_simulator_tpu_torch.services import httpd
from multi_cluster_simulator_tpu_torch.services.registry import (
    RegistryClient, SERVICE_LOG,
)


class LogSinkServer:
    """The log service process (log/server.go + cmd/log/main.go)."""

    def __init__(self, destination: str, host: str = "127.0.0.1",
                 port: int = 0, registry_url: str | None = None):
        self.destination = destination
        self._lock = threading.Lock()
        self.httpd = httpd.RoutedHTTPServer(host, port)
        self.httpd.route("POST", "/log", self._handle_log)
        self.url = self.httpd.url
        self.registry: RegistryClient | None = None
        if registry_url is not None:
            self.registry = RegistryClient(self.httpd, registry_url)

    def start(self) -> None:
        self.httpd.start()
        if self.registry is not None:  # cmd/log/main.go:23-33
            self.registry.register(SERVICE_LOG, self.url, [])

    def shutdown(self) -> None:
        if self.registry is not None:
            self.registry.shutdown()
        self.httpd.shutdown()

    def _handle_log(self, body: bytes, headers: dict):
        if not body:
            return 400, None  # server.go:27-30
        # open/close per write, like the reference's fileLog (server.go:12-21)
        with self._lock, open(self.destination, "a") as f:
            f.write(body.decode(errors="replace").rstrip("\n") + "\n")
        return 200, None


class RemoteLogHandler(logging.Handler):
    """SetClientLogger (log/client.go:12-32): route a service's log records
    to the sink as ``[ServiceName] - <message>`` lines."""

    def __init__(self, sink_url: str, service_name: str):
        super().__init__()
        self.sink_url = sink_url
        self.prefix = f"[{service_name}] - "

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = self.prefix + record.getMessage()
            httpd.post_bytes(f"{self.sink_url}/log", msg.encode())
        except Exception:  # logging must never take the service down
            pass


def set_client_logger(logger: logging.Logger, sink_url: str,
                      service_name: str) -> None:
    logger.addHandler(RemoteLogHandler(sink_url, service_name))
