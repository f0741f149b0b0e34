"""Service discovery + health: the registry server and its client library.

Reference: pkg/registry. The wire surface is preserved exactly — the same
Registration JSON field names, the same ``/services`` endpoint (POST register,
DELETE deregister, pkg/registry/server.go:180-217), the same push model where
the registry POSTs ``{Added, Removed}`` patches to each registrant's
ServiceUpdateURL (server.go:41-76), and the same heartbeat discipline: probe
each registrant's HeartbeatURL, 3 attempts 1 s apart, remove (with a Removed
patch broadcast) on failure and re-add on recovery (server.go:132-173).

Differences from the Go implementation (documented, deliberate):
- the registry port is a constructor argument (the reference hardcodes :3000,
  server.go:15) — tests run many registries concurrently;
- heartbeat probing is concurrent across registrants per cycle (the Go loop
  serializes on ``wg.Wait()`` inside the range, server.go:135-171 — an
  apparent bug that makes the probe period scale with registrant count);
- all sleeps scale by ``speed`` so integration tests run in milliseconds.
"""

from __future__ import annotations

import json
import random
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from multi_cluster_simulator_tpu_torch.config import (
    HEARTBEAT_ATTEMPTS, HEARTBEAT_PERIOD_S, REGISTRY_PORT,
)
from multi_cluster_simulator_tpu_torch.services import httpd

SERVICE_LOG = "LogService"  # registration.go:13-17
SERVICE_SCHEDULER = "Scheduler"
SERVICE_TRADER = "Trader"


@dataclass
class ServiceRegistration:
    """Registration (pkg/registry/registration.go:3-9); JSON field names are
    the Go struct's — byte-compatible with the reference wire format."""

    service_name: str
    service_url: str
    required_services: list = field(default_factory=list)
    service_update_url: str = ""
    heartbeat_url: str = ""

    def to_json(self) -> dict:
        return {"ServiceName": self.service_name,
                "ServiceURL": self.service_url,
                "RequiredServices": list(self.required_services),
                "ServiceUpdateURL": self.service_update_url,
                "HeartbeatURL": self.heartbeat_url}

    @staticmethod
    def from_json(d: dict) -> "ServiceRegistration":
        return ServiceRegistration(
            service_name=d["ServiceName"], service_url=d["ServiceURL"],
            required_services=list(d.get("RequiredServices") or []),
            service_update_url=d.get("ServiceUpdateURL", ""),
            heartbeat_url=d.get("HeartbeatURL", ""))


def _patch(added=(), removed=()) -> dict:
    """The {Added, Removed} push shape (registration.go:19-27). Empty lists
    marshal as null exactly like Go's nil slices, so the encoded patch is
    byte-identical to the reference registry's pushes; every receiver
    (ours at _handle_patch, Go's serviceUpdateHandler) treats null and []
    the same."""
    return {"Added": [{"Name": n, "URL": u} for n, u in added] or None,
            "Removed": [{"Name": n, "URL": u} for n, u in removed] or None}


class RegistryServer:
    """The registry process (pkg/registry/server.go)."""

    def __init__(self, host: str = "127.0.0.1", port: int = REGISTRY_PORT,
                 heartbeat_period_s: float = HEARTBEAT_PERIOD_S,
                 speed: float = 1.0, logger=None):
        self._regs: list[ServiceRegistration] = []
        self._lock = threading.RLock()  # guards: _regs
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self.heartbeat_period_s = heartbeat_period_s / speed
        self.attempt_sleep_s = 1.0 / speed  # server.go:168
        self.logger = logger
        self.httpd = httpd.RoutedHTTPServer(host, port, logger=logger)
        self.httpd.route("POST", "/services", self._handle_register)
        self.httpd.route("DELETE", "/services", self._handle_deregister)
        self.url = self.httpd.url

    # -- lifecycle --
    def start(self, heartbeat: bool = True) -> None:
        self.httpd.start()
        if heartbeat and self._hb_thread is None:  # SetupRegistryService once
            self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                               daemon=True, name="registry-hb")
            self._hb_thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)

    # -- handlers --
    def _handle_register(self, body: bytes, headers: dict):
        try:
            reg = ServiceRegistration.from_json(json.loads(body))
        except (ValueError, KeyError):
            return 400, None
        self._add(reg)
        return 200, None

    def _handle_deregister(self, body: bytes, headers: dict):
        ok = self._remove(body.decode().strip())
        return (200, None) if ok else (500, None)

    # -- core (server.go:23-130) --
    def _add(self, reg: ServiceRegistration) -> None:
        with self._lock:
            self._regs.append(reg)
        if self.logger:
            self.logger.info("registry: added %s at %s",
                             reg.service_name, reg.service_url)
        self._send_required_services(reg)
        self._notify(_patch(added=[(reg.service_name, reg.service_url)]))

    def _remove(self, url: str) -> bool:
        with self._lock:
            for i, r in enumerate(self._regs):
                if r.service_url == url:
                    victim = self._regs.pop(i)
                    break
            else:
                return False
        if self.logger:
            self.logger.info("registry: removed %s at %s",
                             victim.service_name, victim.service_url)
        self._notify(_patch(removed=[(victim.service_name,
                                      victim.service_url)]))
        return True

    def _send_required_services(self, reg: ServiceRegistration) -> None:
        """Tell a newcomer about already-registered providers it requires
        (server.go:80-100)."""
        if not reg.service_update_url:
            return
        with self._lock:
            added = [(r.service_name, r.service_url) for r in self._regs
                     if r.service_name in reg.required_services]
        if added:
            httpd.post_json(reg.service_update_url, _patch(added=added))

    def _notify(self, patch: dict) -> None:
        """Push the filtered patch to every registrant that requires an
        affected service (server.go:41-76)."""
        with self._lock:
            regs = list(self._regs)
        for reg in regs:
            if not reg.service_update_url:
                continue
            flt = {"Added": [e for e in patch["Added"] or []
                             if e["Name"] in reg.required_services] or None,
                   "Removed": [e for e in patch["Removed"] or []
                               if e["Name"] in reg.required_services] or None}
            if flt["Added"] or flt["Removed"]:
                threading.Thread(target=httpd.post_json,
                                 args=(reg.service_update_url, flt),
                                 daemon=True).start()

    # -- heartbeat (server.go:132-173) --
    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_period_s):
            with self._lock:
                regs = list(self._regs)
            threads = [threading.Thread(target=self._probe, args=(r,),
                                        daemon=True) for r in regs
                       if r.heartbeat_url]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)

    def _probe(self, reg: ServiceRegistration) -> None:
        """3 attempts 1 s apart; remove on first failure, re-add on
        recovery within the attempt budget (server.go:140-170)."""
        healthy = True
        for attempt in range(HEARTBEAT_ATTEMPTS):
            status, _ = httpd.get(reg.heartbeat_url, timeout=2.0)
            if status == 200:
                if not healthy:
                    self._add(reg)  # recovered
                return
            if healthy:
                healthy = False
                self._remove(reg.service_url)
            if self._stop.wait(self.attempt_sleep_s):
                return


# ---------------------------------------------------------------------------
# client side (pkg/registry/client.go)
# ---------------------------------------------------------------------------

class RegistryClient:
    """Per-service registry client: installs /heartbeat and /services
    handlers on the service's own HTTP server, registers with the registry,
    and maintains the pushed provider cache (client.go:14-136)."""

    def __init__(self, server: httpd.RoutedHTTPServer, registry_url: str,
                 logger=None,
                 on_update: Optional[Callable[[dict], None]] = None):
        self._providers: dict[str, list[str]] = {}
        self._lock = threading.Lock()  # guards: _providers
        self.registry_url = registry_url
        self.server = server
        self.logger = logger
        self.on_update = on_update
        self.registration: Optional[ServiceRegistration] = None
        server.route("GET", "/heartbeat", lambda b, h: (200, None))
        server.route("POST", "/services", self._handle_patch)

    def register(self, service_name: str, service_url: str,
                 required_services: list) -> None:
        """RegisterService (client.go:14-45)."""
        reg = ServiceRegistration(
            service_name=service_name, service_url=service_url,
            required_services=list(required_services),
            service_update_url=f"{self.server.url}/services",
            heartbeat_url=f"{self.server.url}/heartbeat")
        self.registration = reg
        status, _ = httpd.post_json(f"{self.registry_url}/services",
                                    reg.to_json())
        if status != 200:
            raise RuntimeError(
                f"failed to register {service_name}: registry says {status}")

    def shutdown(self) -> None:
        """ShutdownService (client.go:47-58)."""
        if self.registration is not None:
            httpd.delete(f"{self.registry_url}/services",
                         self.registration.service_url.encode())

    def _handle_patch(self, body: bytes, headers: dict):
        try:
            patch = json.loads(body)
        except ValueError:
            return 400, None
        with self._lock:
            for e in patch.get("Added") or []:
                urls = self._providers.setdefault(e["Name"], [])
                if e["URL"] not in urls:
                    urls.append(e["URL"])
            for e in patch.get("Removed") or []:
                urls = self._providers.get(e["Name"])
                if urls and e["URL"] in urls:
                    urls.remove(e["URL"])
        if self.logger:
            self.logger.info("providers updated: %s", patch)
        if self.on_update is not None:
            self.on_update(patch)
        return 200, None

    def get_provider(self, name: str) -> str:
        """Random provider (client.go:105-111)."""
        with self._lock:
            urls = list(self._providers.get(name) or [])
        if not urls:
            raise LookupError(f"no providers available for service {name}")
        return random.choice(urls)

    def get_providers(self, name: str) -> list[str]:
        with self._lock:
            urls = list(self._providers.get(name) or [])
        if not urls:
            raise LookupError(f"no providers available for service {name}")
        return urls
