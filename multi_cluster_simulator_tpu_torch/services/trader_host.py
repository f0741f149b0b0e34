"""The trader service: one market agent per cluster, paired with a scheduler
(the port of ``multi_cluster_simulator_tpu/services/trader_host.py``).

Reference: pkg/trader. The trader consumes its scheduler's ClusterState
stream into a cached mirror (trader.go:71-108, scheduler_client.go:14-47),
runs a request-policy monitor that goes shopping when a policy breaks
(RequestPolicyMonitor, trader.go:280-325), negotiates with peer traders over
gRPC (Trade, trader.go:193-278), and serves the seller side of the same
protocol (trader/server.go:14-85). Contract sizing reuses the *same ops*
the batch engine's market uses (ops/sizing.py) on a padded job queue on
``device`` (the card unless the caller names another), so a live trader
and the in-batch market request identical contracts for identical
backlogs.

Reproduced as-built quirks (MARKET.md): a seller's ``currentContract`` is
set even for a *denied* request, blocking it until the 20 s TTL
(trader/server.go:44-45); every offer echoes the buyer's price, so the
"cheapest" heap degenerates to response order (trader/server.go:44).
"""

from __future__ import annotations

import random
import threading
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Optional

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import (
    TRADE_COLLECT_WINDOW_S, TraderConfig,
)
from multi_cluster_simulator_tpu_torch.core.state import resolve_device
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import sizing
from multi_cluster_simulator_tpu_torch.services import rpc, telemetry
from multi_cluster_simulator_tpu_torch.services.backoff import (
    CircuitBreaker, jittered_backoff_ms,
)
from multi_cluster_simulator_tpu_torch.services.lifecycle import Service
from multi_cluster_simulator_tpu_torch.services.proto import (
    resource_channel_pb2 as rc_pb,
    trader_pb2 as t_pb,
)
from multi_cluster_simulator_tpu_torch.services.registry import SERVICE_TRADER

_SIZING_CAP = 256  # padded Level1 capacity for the sizing kernels


def _job_queue(jobs: list[tuple[int, int, int]], device) -> Q.JobQueue:
    """Pad a streamed (cores, mem, dur_ms) job list into the fixed-shape
    [1, _SIZING_CAP] queue the sizing ops take, on ``device``."""
    data = np.zeros((_SIZING_CAP, Q.NF), np.int32)
    n = min(len(jobs), _SIZING_CAP)
    for i, (c, m, d) in enumerate(jobs[:n]):
        data[i, Q.FID] = i + 1
        data[i, Q.FCORES] = c
        data[i, Q.FMEM] = m
        data[i, Q.FDUR] = d
    return Q.JobQueue(data=torch.as_tensor(data, device=device)[None],
                      count=torch.tensor([n], dtype=torch.int32,
                                         device=device))


class TraderService(Service):
    service_name = SERVICE_TRADER
    required_services = [SERVICE_TRADER]  # discovers peer traders

    def __init__(self, name: str, scheduler_rpc_addr: str,
                 tcfg: TraderConfig = TraderConfig(),
                 registry_url: Optional[str] = None, speed: float = 1.0,
                 grpc_port: int = 0, device=None, **kw):
        super().__init__(name, registry_url=registry_url, speed=speed, **kw)
        # contract sizing runs on the card unless the caller names another
        # device; without a card and without device="cpu" this raises
        self.device = resolve_device(device)
        self.tcfg = tcfg
        self.scheduler_rpc_addr = scheduler_rpc_addr
        self.grpc_port = grpc_port
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._grpc_server = None
        self.grpc_addr: Optional[str] = None
        self.sched: Optional[rpc.ResourceChannelClient] = None
        # cached clusterState mirror (trader.go:71-108)
        self._cs_lock = threading.Lock()  # guards: _cs
        self._cs = {"cores_util": 0.0, "mem_util": 0.0,
                    "total_cpu": 0, "total_mem": 0, "avg_wait_ms": 0.0}
        # seller side (trader/server.go:14-29)
        self._sell_lock = threading.Lock()  # guards: _current, _serial
        self._current: Optional[t_pb.ContractResponse] = None
        self._serial = random.getrandbits(31) or 1  # s.id = rand.Uint32()
        # peer cache + trade counters are shared between the monitor thread,
        # gRPC handler threads, and shutdown
        self._peer_lock = threading.Lock()  # guards: _peer_clients, _breakers, trades_won, trades_sold
        self._peer_clients: dict[str, rpc.TraderClient] = {}
        # Peer RPC resilience: bounded per-call retries with jittered
        # exponential backoff, and one circuit breaker per peer — a dead
        # trader used to stall EVERY monitor round for the full
        # as_completed collect-window timeout and was re-dialed forever;
        # now it costs `breaker_fail_threshold` rounds, then opens and is
        # skipped until a half-open probe (on the monitor cadence — the
        # reset horizon) succeeds. Breaker state surfaces in /metrics
        # (peer_breakers_open gauge) and the /healthz detail.
        self._breakers: dict[str, CircuitBreaker] = {}
        self.rpc_attempts = 2  # bounded per-call retry budget
        self.rpc_backoff_base_ms = 50.0 / speed
        self.breaker_fail_threshold = 3
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix=f"{name}-rpc")
        self.trades_won = 0
        self.trades_sold = 0

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def on_start(self) -> None:
        self._grpc_server, self.grpc_addr = rpc.start_server(
            [rpc.trader_handler(self)], port=self.grpc_port)
        self.advertised_url = self.grpc_addr  # cmd/trader/main.go:62-75
        self.sched = rpc.ResourceChannelClient(self.scheduler_rpc_addr)
        for fn, tag in ((self._consume_state_stream, "state"),
                        (self._monitor_loop, "monitor")):
            th = threading.Thread(target=fn, daemon=True,
                                  name=f"{self.name}-{tag}")
            th.start()
            self._threads.append(th)

    def on_shutdown(self) -> None:
        self._stop.set()
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=1)
        if self.sched is not None:
            self.sched.close()
        with self._peer_lock:
            clients = list(self._peer_clients.values())
        for c in clients:
            c.close()
        for th in self._threads:
            th.join(timeout=5)
        self._pool.shutdown(wait=False)

    # ------------------------------------------------------------------
    # scheduler state stream consumer (scheduler_client.go:14-47)
    # ------------------------------------------------------------------
    def _consume_state_stream(self) -> None:
        while not self._stop.is_set():
            try:
                for msg in self.sched.start():
                    with self._cs_lock:
                        self._cs["cores_util"] = msg.cores_utilization
                        self._cs["mem_util"] = msg.memory_utilization
                        self._cs["avg_wait_ms"] = msg.average_wait_time
                        # full setState only when totals present
                        # (TotalCpu != 0 dispatch, scheduler_client.go:30-40)
                        if msg.HasField("total_cpu"):
                            self._cs["total_cpu"] = msg.total_cpu
                            self._cs["total_mem"] = msg.total_memory
                    if self._stop.is_set():
                        return
            except Exception:
                if self._stop.wait(0.2):
                    return

    # ------------------------------------------------------------------
    # buyer: policy monitor (RequestPolicyMonitor, trader.go:280-325)
    # ------------------------------------------------------------------
    def _monitor_loop(self) -> None:
        period = self.tcfg.monitor_period_ms / 1000.0 / self.speed
        while not self._stop.wait(period):
            try:
                with self._cs_lock:
                    cs = dict(self._cs)
                # policy order: WaitTime -> fastNode, else Utilization ->
                # smallNode (newTrader appends WaitTime then Utilization,
                # trader.go:55-62; monitor walks in order, trader.go:286-311)
                if cs["avg_wait_ms"] > self.tcfg.request_max_wait_ms:
                    contract = self._size_contract("fast")
                elif (cs["cores_util"] > self.tcfg.request_core_max
                      or cs["mem_util"] > self.tcfg.request_mem_max):
                    contract = self._size_contract("small")
                else:
                    continue
                if (self.tcfg.skip_zero_contracts
                        and contract.cores == 0 and contract.memory == 0):
                    # Level1 was empty when the policy broke; trading this
                    # would attach a zero-capacity virtual node at the buyer
                    # (config.py skip_zero_contracts; divergence from
                    # trader.go:288-311, documented in MARKET.md).
                    self.logger.info("skipping zero-size contract "
                                     "(empty Level1 backlog)")
                    continue
                # the buyer-side trade span (trader.go:195,289,305): root of
                # the cross-service trace; the gRPC fan-out below propagates
                # its context to every seller
                with self.tracer.start_span("Trade", cores=contract.cores,
                                            memory=contract.memory):
                    won = self._trade(contract)
                cooldown = (self.tcfg.cooldown_success_ms if won
                            else self.tcfg.cooldown_failure_ms)
                if self._stop.wait(cooldown / 1000.0 / self.speed):
                    return
            except Exception as e:
                self.logger.error("monitor iteration failed: %r", e)

    def _size_contract(self, kind: str) -> t_pb.ContractRequest:
        """calculateContractRequest (scheduler_client.go:75-123): pull the
        Level1 backlog over ProvideJobs, then run the sizing ops."""
        jobs = []
        for batch in self.sched.provide_jobs():
            for j in batch.jobs:
                jobs.append((j.cores_needed, j.memory_needed,
                             j.unix_time_seconds.ToMilliseconds()))
        q = _job_queue(jobs, self.device)
        budget = self.tcfg.budget
        cc = self.tcfg.max_core_cost
        mc = self.tcfg.max_mem_cost
        if kind == "fast":
            c = sizing.fast_node_contract(q, budget, cc, mc)
        elif self.tcfg.small_node_sizing == "asbuilt":
            c = sizing.small_node_contract_asbuilt(q, budget, cc, mc)
        else:
            c = sizing.small_node_contract_sane(q, budget, cc, mc)
        req = t_pb.ContractRequest(
            cores=int(c.cores[0]), memory=int(c.mem[0]),
            price=float(c.price[0]), trader=self.grpc_addr or "")
        req.time.FromMilliseconds(int(c.time_ms[0]))
        return req

    def _trade(self, contract: t_pb.ContractRequest) -> bool:
        """Trade (trader.go:193-278): fan RequestResource out to all peer
        traders, collect approvals in the window, walk offers cheapest-first
        calling ApproveContract until a seller carves, then hand the node to
        our scheduler.

        Resilience (no reference analogue — Go re-dials dead peers every
        round): peers whose circuit breaker is OPEN are skipped before any
        socket is touched, each RPC gets a bounded retry budget with
        jittered exponential backoff (``_rpc_call``), and every outcome
        feeds the peer's breaker."""
        if self.registry is None:
            return False
        try:
            peers = [u for u in self.registry.get_providers(SERVICE_TRADER)
                     if u != self.advertised_url]
        except LookupError:
            return False
        if not peers:
            return False
        allowed = [u for u in peers if self._breaker(u).allow()]
        skipped = len(peers) - len(allowed)
        if skipped:
            self.meter.add("peer_rpc_skipped_open", skipped)
        self._export_breaker_gauges()
        if not allowed:
            return False
        window = TRADE_COLLECT_WINDOW_S / self.speed
        # wrap_ctx carries the Trade span context onto the pool threads so
        # each RequestResource RPC propagates it to the seller
        futs = {self._pool.submit(
            telemetry.wrap_ctx(self._rpc_call), u,
            lambda u_=u: self._peer(u_).request_resource(
                contract, max(window, 0.5))): u for u in allowed}
        offers = []
        try:
            for fut in as_completed(futs, timeout=max(window, 0.5) + 1):
                try:
                    resp = fut.result()
                except Exception:
                    continue
                if resp.approve:
                    offers.append((resp, futs[fut]))
        except TimeoutError:
            pass
        # price min-heap; all sellers echo the buyer's price
        # (trader/server.go:44), so ties resolve by response order
        offers.sort(key=lambda o: o[0].price)
        for resp, url in offers:
            try:
                node = self._rpc_call(
                    url, lambda: self._peer(url).approve_contract(resp))
            except Exception:
                continue  # heap fall-through (trader.go:265-276)
            try:
                self.sched.receive_virtual_node(node)
            except Exception as e:
                self.logger.error("receive_virtual_node failed: %r", e)
                return False
            with self._peer_lock:
                self.trades_won += 1
            self.logger.info("trade won: %d cores / %d MB from %s",
                             node.cores, node.memory, url)
            return True
        return False

    def _rpc_call(self, url: str, fn):
        """One peer RPC under the retry + breaker discipline: up to
        ``rpc_attempts`` tries with jittered exponential backoff between
        them, every outcome recorded into the peer's breaker (a half-open
        probe that fails re-opens it immediately — no second attempt).
        Runs concurrently on the fan-out pool threads, so the jitter rng
        is per-call (numpy Generators are not thread-safe; OS-entropy
        seeding is exactly right for decorrelation)."""
        br = self._breaker(url)
        rng = np.random.default_rng()
        last: Exception = RuntimeError("no attempt ran")
        for attempt in range(self.rpc_attempts):
            try:
                out = fn()
                br.record_success()
                return out
            except Exception as e:
                last = e
                br.record_failure()
                self.meter.add("peer_rpc_failures", 1)
                if attempt + 1 >= self.rpc_attempts or not br.allow():
                    break
                delay = jittered_backoff_ms(
                    attempt, self.rpc_backoff_base_ms,
                    1000.0 / self.speed, rng) / 1000.0
                if self._stop.wait(delay):
                    break
        raise last

    def _breaker(self, url: str) -> CircuitBreaker:
        with self._peer_lock:
            if url not in self._breakers:
                # half-open probe horizon = the monitor cadence: the next
                # round after the reset window admits exactly one probe
                self._breakers[url] = CircuitBreaker(
                    fail_threshold=self.breaker_fail_threshold,
                    reset_after_s=self.tcfg.monitor_period_ms / 1000.0
                    / self.speed)
            return self._breakers[url]

    def _export_breaker_gauges(self) -> None:
        with self._peer_lock:
            states = {u: b.state for u, b in self._breakers.items()}
        self.meter.set_gauge(
            "peer_breakers_open",
            float(sum(1 for s in states.values()
                      if s != CircuitBreaker.CLOSED)))
        self.meter.set_gauge("peer_breakers_known", float(len(states)))

    def health(self) -> tuple[bool, dict]:
        """/healthz: the trader itself stays healthy when peers die (that
        is the point of the breakers) — but the per-peer breaker states
        ride the detail so an operator sees WHICH peers are being
        skipped."""
        with self._peer_lock:
            states = {u: b.state for u, b in self._breakers.items()}
        open_n = sum(1 for s in states.values()
                     if s != CircuitBreaker.CLOSED)
        return True, {"peer_breakers": states,
                      "peer_breakers_open": open_n}

    def _peer(self, url: str) -> rpc.TraderClient:
        """Lazily-built peer client cache (TraderClients, trader.go:33);
        raced by the monitor thread and shutdown."""
        with self._peer_lock:
            if url not in self._peer_clients:
                self._peer_clients[url] = rpc.TraderClient(url)
            return self._peer_clients[url]

    # ------------------------------------------------------------------
    # seller: gRPC Trader service (trader/server.go:31-85)
    # ------------------------------------------------------------------
    def request_resource(self, req: t_pb.ContractRequest) -> t_pb.ContractResponse:
        with self._sell_lock:
            if self._current is not None and self._current.id != 0:
                return t_pb.ContractResponse(approve=False)
            approve = self._approve_trade(req)
            resp = t_pb.ContractResponse(
                id=self._serial, approve=approve, cores=req.cores,
                memory=req.memory, price=req.price,
                trader=self.advertised_url)
            resp.time.CopyFrom(req.time)
            self._serial += 1
            # set even when denied — blocks this seller until the TTL
            # (trader/server.go:44-45, an as-built quirk)
            self._current = resp
            ttl = self.tcfg.contract_ttl_ms / 1000.0 / self.speed
            timer = threading.Timer(ttl, self._expire_contract, args=(resp.id,))
            timer.daemon = True
            timer.start()
            return resp

    def _expire_contract(self, contract_id: int) -> None:
        with self._sell_lock:
            if self._current is not None and self._current.id == contract_id:
                self._current = None

    def _approve_trade(self, c: t_pb.ContractRequest) -> bool:
        """ApproveTrade (trader.go:141-167): utilization below thresholds
        AND free capacity >= contract AND price >= incentive."""
        with self._cs_lock:
            cs = dict(self._cs)
        t_sec = c.time.ToMilliseconds() / 1000.0
        incentive = (self.tcfg.min_core_incentive * c.cores * t_sec
                     + self.tcfg.min_mem_incentive * c.memory * t_sec)
        avail_c = cs["total_cpu"] - cs["total_cpu"] * cs["cores_util"]
        avail_m = cs["total_mem"] - cs["total_mem"] * cs["mem_util"]
        return (cs["cores_util"] < self.tcfg.approve_core_threshold
                and cs["mem_util"] < self.tcfg.approve_mem_threshold
                and avail_c >= c.cores and avail_m >= c.memory
                and c.price >= incentive)

    def approve_contract(self, resp: t_pb.ContractResponse) -> Optional[t_pb.NodeObject]:
        """Seller-side finalize: id must still match (20 s TTL), then carve
        a virtual node out of our scheduler (trader/server.go:63-85).
        Returns None on TTL/id mismatch -> DEADLINE_EXCEEDED upstream."""
        with self._sell_lock:
            if self._current is None or self._current.id != resp.id:
                return None
            req = rc_pb.VirtualNodeRequest(cores=resp.cores,
                                           memory=resp.memory)
            req.time.CopyFrom(resp.time)
            try:
                node = self.sched.provide_virtual_node(req)
            finally:
                self._current = None  # reset for future activity
            with self._peer_lock:  # always inner to _sell_lock
                self.trades_sold += 1
            return node
