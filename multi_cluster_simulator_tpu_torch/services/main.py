"""Entry points — the cmd/* equivalents, as one CLI with subcommands (the
port of ``multi_cluster_simulator_tpu/services/main.py``).

Reference: cmd/{registry,scheduler,trader,client,log}/main.go. Launch the
same five-process topology:

  python -m multi_cluster_simulator_tpu_torch.services.main registry
  python -m multi_cluster_simulator_tpu_torch.services.main scheduler assets/cluster_small.json
  python -m multi_cluster_simulator_tpu_torch.services.main trader 127.0.0.1:50051
  python -m multi_cluster_simulator_tpu_torch.services.main client http://127.0.0.1:8080
  python -m multi_cluster_simulator_tpu_torch.services.main log grading.log

Each subcommand blocks until EOF/newline on stdin (the reference's
"press any key to stop" lifecycle, internal/service/service.go:44-55) or
SIGINT, then deregisters and shuts down.

The scheduler and the trader hold their state on ``--device`` (a global
flag, accepted before or after the subcommand): the card by default, and
without one they refuse to start unless ``--device cpu`` names the CPU.
"""

from __future__ import annotations

import argparse
import sys

from multi_cluster_simulator_tpu_torch.config import (
    REGISTRY_PORT, PolicyKind, SimConfig, TraderConfig,
)


def _wait_for_key(name: str) -> None:
    print(f"{name} started. Press Enter to stop", flush=True)
    try:
        sys.stdin.readline()
    except KeyboardInterrupt:
        pass


def cmd_registry(args) -> None:
    from multi_cluster_simulator_tpu_torch.services.registry import RegistryServer
    from multi_cluster_simulator_tpu_torch.services.telemetry import create_logger
    reg = RegistryServer(port=args.port, speed=args.speed,
                         logger=create_logger("registry"))
    reg.start()
    _wait_for_key(f"registry at {reg.url}")
    reg.shutdown()


def cmd_scheduler(args) -> None:
    from multi_cluster_simulator_tpu_torch.core.spec import load_cluster_json
    from multi_cluster_simulator_tpu_torch.services.scheduler_host import (
        SchedulerService,
    )
    cfg = SimConfig(policy=PolicyKind[args.policy],
                    borrowing=args.policy == "FIFO",
                    trader=TraderConfig(enabled=False))
    svc = SchedulerService(args.name, load_cluster_json(args.cluster_json),
                           cfg, registry_url=args.registry, speed=args.speed,
                           port=args.port, checkpoint_path=args.checkpoint,
                           device=args.device)
    svc.start()
    print(f"scheduler HTTP {svc.url} gRPC {svc.grpc_addr}", flush=True)
    _wait_for_key(svc.name)
    svc.shutdown()


def cmd_trader(args) -> None:
    from multi_cluster_simulator_tpu_torch.services.trader_host import TraderService
    svc = TraderService(args.name, args.scheduler_rpc,
                        registry_url=args.registry, speed=args.speed,
                        device=args.device)
    svc.start()
    print(f"trader HTTP {svc.url} gRPC {svc.grpc_addr}", flush=True)
    _wait_for_key(svc.name)
    svc.shutdown()


def cmd_client(args) -> None:
    from multi_cluster_simulator_tpu_torch.services.workload import (
        WorkloadClientService,
    )
    svc = WorkloadClientService(args.name, args.scheduler_url,
                                speed=args.speed, max_jobs=args.max_jobs)
    svc.start()
    _wait_for_key(svc.name)
    svc.shutdown()


def cmd_log(args) -> None:
    from multi_cluster_simulator_tpu_torch.services.logsink import LogSinkServer
    svc = LogSinkServer(args.destination, port=args.port,
                        registry_url=args.registry)
    svc.start()
    _wait_for_key(f"log sink at {svc.url} -> {args.destination}")
    svc.shutdown()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="mcs-services")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="virtual-time speedup (1.0 = reference real-time)")
    ap.add_argument("--registry", default=f"http://127.0.0.1:{REGISTRY_PORT}")
    ap.add_argument("--device", default=None,
                    help="the device the scheduler and the trader hold their "
                         "state on (default: the CUDA card; 'cpu' runs the "
                         "plain PyTorch path)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_parser(name):
        # accept the global flags AFTER the subcommand too ("main scheduler
        # x.json --speed 200"); SUPPRESS keeps the top-level defaults in
        # force when the trailing flag is absent
        p = sub.add_parser(name)
        p.add_argument("--speed", type=float, default=argparse.SUPPRESS,
                       help="virtual-time speedup (1.0 = reference real-time)")
        p.add_argument("--registry", default=argparse.SUPPRESS)
        p.add_argument("--device", default=argparse.SUPPRESS)
        return p

    p = add_parser("registry")
    p.add_argument("--port", type=int, default=REGISTRY_PORT)
    p.set_defaults(fn=cmd_registry)

    p = add_parser("scheduler")
    p.add_argument("cluster_json")
    p.add_argument("--name", default="Scheduler")
    p.add_argument("--policy", default="DELAY", choices=["FIFO", "DELAY", "FFD"])
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="persist state here every 50 ticks and restore on "
                        "start (queued/running work survives restarts)")
    p.set_defaults(fn=cmd_scheduler)

    p = add_parser("trader")
    p.add_argument("scheduler_rpc", help="scheduler gRPC host:port")
    p.add_argument("--name", default="Trader")
    p.set_defaults(fn=cmd_trader)

    p = add_parser("client")
    p.add_argument("scheduler_url")
    p.add_argument("--name", default="Client")
    p.add_argument("--max-jobs", type=int, default=None)
    p.set_defaults(fn=cmd_client)

    p = add_parser("log")
    p.add_argument("destination", nargs="?", default="./grading.log")
    p.add_argument("--port", type=int, default=0)
    p.set_defaults(fn=cmd_log)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
