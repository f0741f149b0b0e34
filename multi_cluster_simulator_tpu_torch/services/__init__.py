"""The service shell — the reference's microservice constellation, rebuilt
(the port of ``multi_cluster_simulator_tpu/services/``).

The reference deploys as five independently-launched OS processes wired over
HTTP/JSON and gRPC (SURVEY.md §1): a registry (service discovery + heartbeat,
pkg/registry), N schedulers (pkg/scheduler), N traders (pkg/trader), workload
clients (pkg/client), and a log sink (log/). This package preserves that
topology and its wire surface — the same HTTP endpoints, the same proto
messages — while the *decisions* inside each scheduler/trader host run on
the card, the placement as the port's hand-written kernels (hosts keep the
service fabric, placement moves to the device). Every service that holds
device state takes a ``device``: the card by default, ``"cpu"`` for the
plain PyTorch path.

Modules:
  httpd      — routed threading HTTP server + client helpers (net/http analogue)
  telemetry  — structured logging, spans, metrics (internal/service/telemetry.go)
  registry   — discovery server + client cache + heartbeat (pkg/registry)
  logsink    — centralized log service (log/)
  lifecycle  — service bootstrap/shutdown (internal/service/service.go)
  host_ops   — device-boundary state ops the live hosts call between ticks
  scheduler_host — the scheduler service (pkg/scheduler servers)
  trader_host    — the trader service (pkg/trader)
  workload       — the workload-generator client service (pkg/client)
  rpc        — gRPC bindings over the proto messages (pkg/trader/gen)
  main       — entry points (cmd/*)
  serving    — the batched front door (scheduling-as-a-service): staged
               concurrent submits coalesced into one multi-tick device
               dispatch per window, snapshot-backed queries, explicit
               503 back-pressure (ARCHITECTURE.md §serving tier)
"""

from multi_cluster_simulator_tpu_torch.services.registry import (  # noqa: F401
    RegistryServer, ServiceRegistration, SERVICE_SCHEDULER, SERVICE_TRADER,
    SERVICE_LOG,
)
