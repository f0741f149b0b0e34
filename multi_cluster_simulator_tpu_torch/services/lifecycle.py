"""Service bootstrap + shutdown — the internal/service equivalent.

Reference: internal/service/service.go:13-63 — every ``cmd/`` main calls
``service.Start(ctx, host, port, registration, registerHandlers)`` which
(1) registers the HTTP handlers, (2) starts the server, (3) registers with
the registry; shutdown deregisters and stops the server. The telemetry
factories (telemetry.go:43-143) hang off the same bootstrap. ``Service``
bundles exactly that: httpd + logger + tracer + meter + registry client with
one ``start()`` / ``shutdown()`` pair. Subclasses add routes in
``register_handlers`` and extra threads via ``on_start``/``on_shutdown``.
"""

from __future__ import annotations

from typing import Optional

from multi_cluster_simulator_tpu_torch.services import httpd, telemetry
from multi_cluster_simulator_tpu_torch.services.registry import RegistryClient


class Service:
    """One microservice process: HTTP surface + telemetry + registration."""

    service_name: str = "Service"
    required_services: list = []

    def __init__(self, name: str, registry_url: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0, speed: float = 1.0,
                 log_mode: str = "development",
                 metrics_path: Optional[str] = None,
                 spans_path: Optional[str] = None):
        self.name = name
        self.speed = speed
        self.logger = telemetry.create_logger(name, mode=log_mode)
        self.tracer = telemetry.Tracer(name, path=spans_path)
        self.meter = telemetry.Meter(name, export_path=metrics_path,
                                     export_period_s=5.0 / speed)
        self.httpd = httpd.RoutedHTTPServer(host, port, logger=self.logger,
                                            tracer=self.tracer)
        self.url = self.httpd.url
        # What gets registered as ServiceURL. Defaults to the HTTP server;
        # the trader advertises its gRPC address instead (the reference
        # registers the trader's gRPC addr, cmd/trader/main.go:62-75).
        self.advertised_url = self.url
        self.registry: Optional[RegistryClient] = None
        if registry_url is not None:
            self.registry = RegistryClient(self.httpd, registry_url,
                                           logger=self.logger,
                                           on_update=self.on_providers_update)
        self._started = False

    # -- subclass hooks --
    def register_handlers(self) -> None:
        """Install routes on self.httpd (RegisterHandlers analogue)."""

    def health(self) -> tuple[bool, dict]:
        """Liveness verdict for ``/healthz``: (healthy, detail). Subclasses
        override to check their background loops (the serving tier's pacer
        and drive threads, the per-request host's tick loop) — a service
        whose loops have died must flip the surface to 503, not keep
        answering 200 off a wedged core."""
        return True, {}

    def wedged(self) -> bool:
        """True when a shutdown join timed out and a loop thread never
        exited (the thread may still own shared state). ``shutdown``
        checks this AFTER ``on_shutdown``: a wedged service keeps its
        HTTP diagnostic surface alive — /healthz answering 503 with the
        wedge named — instead of tearing the transport down and
        returning as if shutdown succeeded; the process owner decides
        what to kill."""
        return bool(getattr(self, "_wedged", None))

    def _handle_healthz(self, body: bytes, headers: dict):
        import json
        ok, detail = self.health()
        payload = {"status": "ok" if ok else "unhealthy",
                   "service": self.name, **detail}
        return (200 if ok else 503), json.dumps(payload).encode()

    def _handle_metrics(self, body: bytes, headers: dict):
        return 200, self.meter.render_prometheus().encode()

    def on_start(self) -> None:
        """Start background loops (tick threads, monitors)."""

    def on_shutdown(self) -> None:
        """Stop background loops (runs while the HTTP surface still serves)."""

    def on_stopped(self) -> None:
        """Runs after the HTTP server is down — for final state snapshots
        that must not race still-arriving mutations."""

    def on_providers_update(self, patch: dict) -> None:
        """Called when the registry pushes a provider patch."""

    # -- lifecycle (service.go:13-33) --
    def start(self) -> None:
        if self._started:
            return
        # default observability surface on EVERY service host: /healthz
        # (the health() hook) and a Prometheus-text /metrics off the
        # Meter. Registered before register_handlers so a subclass route
        # wins if it needs to specialize either path.
        self.httpd.route("GET", "/healthz", self._handle_healthz)
        self.httpd.route("GET", "/metrics", self._handle_metrics)
        self.register_handlers()
        self.httpd.start()
        self.meter.start_exporter()
        self.on_start()  # may set advertised_url (gRPC services)
        if self.registry is not None:
            self.registry.register(self.service_name, self.advertised_url,
                                   self.required_services)
        self._started = True
        self.logger.info("%s started at %s", self.service_name, self.url)

    def shutdown(self) -> None:
        if not self._started:
            return
        self._started = False
        self.on_shutdown()
        if self.registry is not None:
            self.registry.shutdown()
        if self.wedged():
            # wedged-shutdown honesty: a loop thread blew its join timeout
            # and may still own shared state. Leave the HTTP surface UP so
            # /healthz reports the 503 wedge verdict (health() checks the
            # flag unconditionally) — tearing the transport down here
            # would be returning as if shutdown succeeded.
            self.logger.error(
                "%s at %s: shutdown wedged — keeping the diagnostic HTTP "
                "surface alive (/healthz = 503)", self.service_name,
                self.url)
            return
        self.meter.stop_exporter()
        self.meter.export_otlp()  # final snapshot to the collector, if any
        self.tracer.shutdown()  # flush the last OTLP span batch
        self.httpd.shutdown()
        self.on_stopped()
        self.logger.info("%s at %s stopped", self.service_name, self.url)

    # -- context manager sugar for tests --
    def __enter__(self) -> "Service":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
