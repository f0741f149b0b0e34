"""Scheduling-as-a-service: the async batched front door (serving tier;
the port of ``multi_cluster_simulator_tpu/services/serving.py``, on the
port's ``Engine.run_io`` and ``tenancy.TenantBatch`` on ``device``, the card
unless the caller names another).

The per-request live path (services/scheduler_host.py, BENCH ``live``) pays
~5 ms of host cost per tick because every HTTP arrival walks the service
stack one job at a time and every tick is its own ``tick_io`` device round
trip — 113 jobs/s against the batch engine's 406k (ROADMAP item 4). This
module closes that gap the way Blox argues schedulers should be built
(arxiv 2312.12621: modular services over a shared batched core): the HTTP
handlers only STAGE — parse JSON, stamp the arrival with the current
virtual tick, append to a bounded per-tick bucket — and a single drive
thread coalesces everything staged across ticks and clusters into the same
ragged ``TickArrivals`` chunk format the streamed bench pipeline ingests
(``engine.pack_arrivals_chunks`` discipline: rows padded to the chunk's own
pow2-bucketed K), then advances the device-resident ``SimState`` IN PLACE
with ONE ``Engine.run_io`` dispatch per coalesce window — N requests cost
one dispatch, not N; on the card each of its ticks is one launch of the
policy's kernel (with the metrics tap as its epilogue when ``obs``).

Three contracts, each load-bearing:

- **Handlers never touch the device.** Submit handlers stage host tuples;
  read handlers (``/stats``, ``/quote``, ``/placed``) answer from the
  latest immutable ``Snapshot`` — host-side numpy copies the drive thread
  takes off the tick loop after a dispatch (the dispatch advances the
  state in place, so every read of it happens on the dispatching thread
  between dispatches). No handler ever synchronizes the hot path. Every query response carries
  ``snapshot_age_ms`` so clients know the consistency window.

- **Back-pressure is explicit.** Staging is bounded (``max_staged`` total,
  ``k_cap`` per (tick, cluster) — the latter also bounds a chunk's K);
  a full ring answers 503 with a machine-readable retry quote
  (``RetryAfterMs``, queue depth, snapshot age) and a
  ``submit_rejected`` telemetry count — never a silent drop. The engine's
  own drop counters stay asserted zero by the bench.

- **Coalescing is invisible to placement.** Dispatch is ``Engine.run_io``
  — a scan of the same tick body a window-1 driver would run — so a
  window-W front door is bit-identical to the per-request path over the
  same staged stream, and both are bit-identical to the batch engine over
  the equivalent bucketed Arrivals (tests/test_services.py pins all
  three; bench.py --serving asserts the A/B parity on every run).

Wire parity: ``POST /`` and ``POST /delay`` accept the reference's Go Job
JSON (an optional ``Cluster`` field routes among the hosted clusters;
endpoint routing follows the reference — a mismatched-endpoint job is
pushed into the queue the policy never drains, exactly as in Go).
``POST /submitBatch`` is the front door's native client API: a JSON array
of the same Job objects, one HTTP round trip for a client-side buffer.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import (MatchKind, PolicyKind,
                                                SimConfig)
from multi_cluster_simulator_tpu_torch.core import state as st
from multi_cluster_simulator_tpu_torch.core.engine import Engine, round_up_pow2
from multi_cluster_simulator_tpu_torch.core.state import (
    clone_state, init_state,
)
from multi_cluster_simulator_tpu_torch.obs import device as obs_device
from multi_cluster_simulator_tpu_torch.obs.profile import annotate_dispatch
from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import runset as R
from multi_cluster_simulator_tpu_torch.services import host_ops
from multi_cluster_simulator_tpu_torch.services.lifecycle import Service
from multi_cluster_simulator_tpu_torch.services.registry import SERVICE_SCHEDULER
from multi_cluster_simulator_tpu_torch.services.scheduler_host import job_from_json

from multi_cluster_simulator_tpu_torch.utils.tree import tree_map

_OWNER = int(Q.OWN)
_INVALID_ROW = np.asarray(F.QUEUE_INVALID, np.int32)


def make_row(jid: int, cores: int, mem: int, gpu: int, dur_ms: int,
             enq_t: int) -> tuple:
    """One staged job as a queue row in the canonical field order
    (ops/fields.QUEUE_FIELDS) — the same row ``pack_arrivals_chunks``
    builds, so staged buckets and stream buckets are interchangeable."""
    return (int(jid), int(cores), int(mem), int(gpu), int(dur_ms),
            int(enq_t), _OWNER, 0,
            int(F.job_class(int(cores), int(gpu))), 0)


def _np(x) -> np.ndarray:
    """A tensor's value as host numpy (a copy off the card)."""
    return x.detach().cpu().numpy()


class Snapshot:
    """One immutable host-readable view of the device state, refreshed by
    the drive thread after a dispatch — the query side-channel's source of
    truth. Handlers read the latest snapshot by reference (one atomic
    attribute load); the device hot path is never synchronized on a
    request's behalf."""

    __slots__ = ("wall", "sim_t", "stage_t", "placed_total", "placed",
                 "jobs_in_queue", "queue_depth", "running", "avg_wait_ms",
                 "drops", "queue_ids", "run_ids", "run_active",
                 "dispatches", "staged_jobs", "tenants", "depth_tc",
                 "placed_t", "running_tc", "jobs_in_queue_tc",
                 "avg_wait_tc")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    def age_ms(self) -> float:
        return (time.time() - self.wall) * 1000.0

    def job_status(self, cluster: int, jid: int, tenant: int = 0) -> str:
        """queued | running | unknown — a placement lookup over the
        snapshot's id columns (host numpy, no device access). ``unknown``
        covers both never-seen and already-completed ids; the submit log
        (when latency tracking is on) disambiguates bench-side. Tenant-
        stacked snapshots (hosting T > 1) index the id columns by the
        tenant's row first."""
        for ids in self.queue_ids:
            col = ids[tenant] if ids.ndim == 3 else ids
            if (col[cluster] == jid).any():
                return "queued"
        rid = self.run_ids[tenant] if self.run_ids.ndim == 3 else self.run_ids
        act = (self.run_active[tenant] if self.run_active.ndim == 3
               else self.run_active)
        hit = rid[cluster] == jid
        if (hit & act[cluster]).any():
            return "running"
        return "unknown"


class ServingScheduler(Service):
    """The batched front door: one service hosts the WHOLE constellation
    (a [C]-cluster ``SimState`` resident on device) behind concurrent
    HTTP submit endpoints and snapshot-backed query endpoints.

    ``window`` is the coalesce window in ticks: the drive thread seals one
    staging bucket per virtual tick (``speed`` virtual seconds per wall
    second, the live host's pacing contract) and dispatches every
    ``window`` sealed ticks as one ``Engine.run_io`` call that advances
    the state in place. ``pacer=False`` disables the drive thread for deterministic
    drivers (tests, the bench's parity A/B): the caller paces staging with
    ``seal_tick()`` and dispatches with ``dispatch_sealed()`` — a
    window-1 caller IS the per-request cost model, and both compose to
    bit-identical states.

    ``snapshot_every`` trades freshness for dispatch-pipeline depth: the
    drive thread refreshes the query snapshot (the only host
    synchronization in the loop) every N dispatches.
    """

    service_name = SERVICE_SCHEDULER
    required_services: list = []

    def __init__(self, name: str, specs, cfg: SimConfig,
                 registry_url: Optional[str] = None, speed: float = 1.0,
                 window: int = 16, k_cap: int = 128,
                 max_staged: Optional[int] = None, pacer: bool = True,
                 snapshot_every: int = 1, track_latency: bool = False,
                 warm_k=(1,), obs: bool = True,
                 snapshot_max_age_ms: Optional[float] = None,
                 wal_path: Optional[str] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 8, recover: bool = True,
                 wal_rotate_bytes: int = 64 << 20,
                 pricing_budget_ms: Optional[float] = None,
                 pricing_reprobe: int = 64, tenants: int = 1,
                 tenant_params=None, adaptive_window: bool = False,
                 adaptive_deadline_ms: Optional[float] = None, device=None,
                 **kw):
        """Crash recovery (services/wal.py, ARCHITECTURE.md §fault plane):
        ``wal_path`` arms the staged-arrival write-ahead log — every
        accepted submit is fsync'd to it BEFORE the 200-ack, so an acked
        job survives kill -9; ``checkpoint_path`` adds periodic atomic
        device-state checkpoints (core/checkpoint.py, every
        ``checkpoint_every`` dispatches + one at clean shutdown/quiesce).
        Checkpoints are also what BOUND the WAL (seek offsets + rotation
        past ``wal_rotate_bytes`` anchor on the checkpoint watermark); a
        WAL without checkpoints is full-history by design — recovery
        replays it in its entirety — so arm both for a long-lived
        service.
        With ``recover`` (default) a restarting service restores the
        checkpoint and replays the WAL suffix — acked-but-undispatched
        jobs re-stage onto their original ticks, torn final records are
        discarded + truncated, and replay is exactly-once against the
        checkpoint's dispatch watermark. tools/chaos.py is the standing
        proof harness."""
        super().__init__(name, registry_url=registry_url, speed=speed, **kw)
        self.specs = list(specs)
        self.cfg = cfg
        self.window = int(window)
        self.k_cap = int(k_cap)
        self.C = len(self.specs)
        # multi-tenant hosting (tenancy/, ROADMAP item 3): T independent
        # constellations resident as ONE tenant-stacked SimState, advanced
        # by the tenant-batched run_io — per-tenant routing, staging
        # buckets, quotas and stats ride a tenant index through the same
        # stage->seal->coalesce->dispatch pipeline. T == 1 is byte-for-byte
        # the classic single-tenant front door.
        self.T = int(tenants)
        if self.T < 1:
            raise ValueError(f"tenants must be >= 1, got {tenants}")
        if self.T > 1:
            if wal_path is not None or checkpoint_path is not None:
                raise ValueError(
                    "multi-tenant serving does not arm WAL/checkpoint "
                    "durability — run one tenant per durable service")
            if pricing_budget_ms is not None:
                raise ValueError(
                    "pricing_budget_ms is single-tenant: the budget clock "
                    "times one constellation's trade rounds")
        # adaptive coalesce windows (tail latency, ROADMAP item 3): seal
        # the open tick early when a bucket fills, and let the drive loop
        # dispatch a PARTIAL window once the oldest sealed tick has waited
        # past the deadline — light traffic pays the deadline, not the
        # full fixed window wall. Placement is untouched (dispatch is the
        # same run_io scan, PARITY.md §serving); only pacing changes.
        self.adaptive_window = bool(adaptive_window)
        self.adaptive_deadline_ms = (float(adaptive_deadline_ms)
                                     if adaptive_deadline_ms is not None
                                     else None)
        self.max_staged = (int(max_staged) if max_staged is not None
                           else 4 * self.window * self.C * self.T)
        self.pacer = pacer
        self.snapshot_every = max(int(snapshot_every), 1)
        self.track_latency = track_latency
        self.warm_k = tuple(warm_k)
        self._warm_sorted = tuple(sorted(set(int(k) for k in warm_k)))
        self.obs = bool(obs)
        # Snapshot freshness bound (the staleness bugfix): snapshot_age_ms
        # was always REPORTED but never BOUNDED — a wedged refresh thread
        # kept serving arbitrarily stale /stats with 200s. Under the pacer
        # the drive loop refreshes on the dispatch cadence even with zero
        # traffic (the pacer seals ticks off wall time alone), so a
        # snapshot older than many windows means the loop is wedged and
        # queries answer 503 + the age (counted as stale_503) instead of
        # silently stale data. Deterministic drivers (pacer=False) pace
        # refreshes themselves, so the bound defaults off there; pass an
        # explicit value to arm it anyway (the staleness test does).
        if snapshot_max_age_ms is not None:
            self.snapshot_max_age_ms = float(snapshot_max_age_ms)
        elif pacer:
            self.snapshot_max_age_ms = max(
                20.0 * self.window * cfg.tick_ms / speed, 2_000.0)
        else:
            self.snapshot_max_age_ms = None
        # the card unless the caller names another device; without a card
        # and without device="cpu" this raises (core/state.resolve_device)
        self.engine = Engine(cfg, device=device)
        self.device = self.engine.device
        # per-tick pricing (the convex market kernel, market/cvx.py): when
        # the hosted config arms the trader with MatchKind.CVX, every
        # trade round inside a coalesced dispatch solves the contract LP —
        # all of it on the drive thread's run_io dispatch, never a handler
        # (the serve-sync contract is untouched: pricing is just more tick
        # phases inside the one dispatch). ``pricing_budget_ms``
        # arms a HARD per-round wall budget: the dispatch is then timed
        # against budget * rounds-in-window, and a blown budget flips a
        # sticky fallback to a second engine with greedy matching, warmed
        # up with the first (same state shapes — mkt_price is always in
        # SimState — so the state moves between the two engines freely).
        # Every trip is counted in ``pricing_fallbacks`` and surfaced in
        # provenance()/metrics; the flag re-probes the solver every
        # ``pricing_reprobe`` dispatches so a transient stall does not
        # demote pricing forever. Arming a budget makes each dispatch
        # synchronous (a wall measurement needs the device to finish) —
        # the documented cost of the budget, not of the solver.
        self._pricing_armed = bool(cfg.trader.enabled
                                   and cfg.trader.matching is MatchKind.CVX)
        self.pricing_budget_ms = (float(pricing_budget_ms)
                                  if pricing_budget_ms is not None else None)
        self.pricing_reprobe = max(int(pricing_reprobe), 1)
        self.pricing_fallbacks = 0
        self._pricing_fallback = False
        self._pricing_since_probe = 0
        self._run_io_fallback = None
        if self._pricing_armed and self.pricing_budget_ms is not None:
            import dataclasses as _dc
            fb_cfg = _dc.replace(cfg, trader=_dc.replace(
                cfg.trader, matching=MatchKind.GREEDY))
            self._fallback_engine = Engine(fb_cfg, device=self.device)
            self._run_io_fallback = self._fallback_engine.run_io
        # the device state has ONE owner — the drive thread (or the
        # deterministic driver): handlers never read or write it, so no
        # state lock exists by construction. Leaves are cloned once so
        # every buffer is unique — the dispatch advances them in place
        if self.T > 1:
            from multi_cluster_simulator_tpu_torch import tenancy
            self._tenancy = tenancy
            self._batch = tenancy.TenantBatch(cfg, self.specs,
                                              device=self.device)
            tp = (tenant_params if tenant_params is not None
                  else self._batch.default_params(self.T))
            if tenancy.n_tenants(tp) != self.T:
                raise ValueError(
                    f"tenant_params holds {tenancy.n_tenants(tp)} tenants, "
                    f"service hosts {self.T}")
            self._tp = tp
            # per-tenant admission quota (the quota_jobs leaf): a bound on
            # the tenant's staged+queued backlog; -1 = unmetered
            self._quota = _np(tp.quota_jobs).astype(np.int64)
            self._state = self._batch.init_stacked(tp)
        else:
            self._tenancy = None
            self._tp = None
            self._quota = None
            self._state = clone_state(init_state(cfg, self.specs,
                                                 device=self.device))
        # the device metrics plane: one MetricsBuffer rides every run_io
        # dispatch (same single owner as the state — the drive thread) and
        # is harvested at the snapshot refresh, the sync point the loop
        # already pays; its gauges bridge into self.meter so /metrics and
        # the OTLP export report identical numbers. Multi-tenant hosting
        # stacks one buffer per tenant — the tenant row of the harvest.
        if not self.obs:
            self._mbuf = None
        elif self.T > 1:
            self._mbuf = self._batch.metrics_init(self._state)
        else:
            self._mbuf = obs_device.metrics_init(self._state)
        self._obs_harvest: dict = {}
        self._run_io = (self._batch.run_io_fn(donate=True, obs=self.obs)
                        if self.T > 1
                        else self.engine.run_io)
        self._delay_policy = cfg.policy is not PolicyKind.FIFO
        # staging: one open bucket per cluster for the current tick, a
        # FIFO of sealed per-tick buckets awaiting dispatch, and the
        # parked mismatched-endpoint jobs (applied at dispatch time)
        self._stage_lock = threading.Lock()  # guards: _open, _sealed, _stage_t, _staged_jobs, _parked, _rejected, _rejected_t, _submit_wall, _unseen, _sealed_walls
        # staging buckets are per (tenant, cluster): tenant routing is a
        # staging index, never a device concern (the dispatch stacks the
        # buckets into the tenant-batched chunk). T == 1 keeps one row.
        self._open: list[list[list[tuple]]] = [
            [[] for _ in range(self.C)] for _ in range(self.T)]
        self._sealed: list[list[list[list[tuple]]]] = []
        self._stage_t = 0  # ticks staged (== index of the open tick)
        self._staged_jobs = 0  # staged, not yet dispatched (back-pressure)
        # per-(tenant, cluster) jobs admitted but not yet visible in a
        # snapshot's queue depth (staged OR dispatched-since-last-refresh):
        # the admission bound snap.depth_tc[tn, c] + _unseen[tn, c] <=
        # queue_capacity makes a device queue-overflow drop impossible by
        # construction — saturation surfaces as a 503 quote, never a
        # silent drop
        self._unseen = np.zeros((self.T, self.C), np.int64)
        self._parked: list[tuple] = []  # (c, row, to_delay) — T == 1 only
        self._rejected = 0
        self._rejected_t = np.zeros(self.T, np.int64)
        self._submit_wall: dict[tuple, float] = {}
        self._inflight = np.zeros((self.T, self.C), np.int64)  # drive-thread-owned
        # seal/dispatch cadence bookkeeping: per-sealed-tick walls feed the
        # adaptive deadline (oldest sealed tick's age), inter-dispatch
        # walls feed the MEASURED staging-latency quote (/quote)
        import collections as _c
        self._sealed_walls: _c.deque = _c.deque()
        self._dispatch_walls: _c.deque = _c.deque(maxlen=33)
        # dispatch bookkeeping (drive/driver thread only — single owner,
        # like the state): ticks dispatched, per-dispatch batch sizes, and
        # the snapshot visibility log the latency accounting reads. A
        # long-running service must not grow host memory per dispatch, so
        # the per-dispatch series are BOUNDED: batch sizes keep running
        # aggregates plus a recent window (for the p50), K values are a
        # set (at most log2(k_cap) members), and the visibility log is a
        # deque whose window comfortably covers any bench run (latency
        # accounting is a bench/driver concern — _submit_wall only grows
        # under track_latency, never in plain serving)
        import collections
        self.ticks_dispatched = 0
        self.dispatches = 0
        self.batch_jobs: collections.deque = collections.deque(maxlen=4096)
        self._batch_n = 0
        self._batch_sum = 0
        self._batch_max = 0
        self.chunk_k: set[int] = set()
        self.visibility_log: collections.deque = collections.deque(
            maxlen=1 << 16)  # (ticks_dispatched, wall)
        self._snap: Optional[Snapshot] = None
        self._stop = threading.Event()
        self._drive_thread: Optional[threading.Thread] = None
        self._pacer_thread: Optional[threading.Thread] = None
        # wedged-shutdown honesty: join timeouts are attributes so tests
        # can shrink them; a blown timeout flips _wedged (and /healthz)
        # instead of returning as if shutdown succeeded
        self.stop_join_timeout_s = 30.0
        self.pacer_join_timeout_s = 10.0
        self._wedged: Optional[str] = None  # thread name that never exited
        # /admin/quiesce single-flight state: one maintenance thread ever
        # owns the drain; late/retried requests attach to it
        self._quiesce_start_lock = threading.Lock()  # guards: _quiesce_done, _quiesce_result
        self._quiesce_done: Optional[threading.Event] = None
        self._quiesce_result: dict = {}
        # crash recovery (WAL + checkpoints — services/wal.py)
        self.wal_path = wal_path
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self.wal_rotate_bytes = int(wal_rotate_bytes)
        self._wal = None
        self._replaying = False  # replayed records must not re-append
        self._parked_applied = 0  # parked rows pushed at dispatch edges
        self.recovered_jobs = 0
        self.wal_torn_tail = False
        # per-staging-tick WAL byte offsets (first record of each tick) —
        # what lets a checkpoint record a SEEKABLE replay start and the
        # rotation drop the dispatched prefix; bounded: pruned to the
        # watermark at every checkpoint. guarded by _stage_lock.
        import collections as _collections
        self._wal_tick_off: _collections.deque = _collections.deque()
        self._wal_rotations = 0  # lifetime WAL compactions: once > 0,
        # the log is NOT full history and WAL-alone recovery would
        # silently lose the compacted prefix (_open_wal refuses)
        self._wal_parked = False  # any parked record ever logged disables
        #                           the offset/rotation optimizations
        self._refresh_snapshot()
        if wal_path is not None:
            self._open_wal(recover=recover)

    # ------------------------------------------------------------------
    # HTTP surface
    # ------------------------------------------------------------------
    def register_handlers(self) -> None:
        self.httpd.route("POST", "/", self._handle_submit_fifo)
        self.httpd.route("POST", "/delay", self._handle_submit_delay)
        self.httpd.route("POST", "/submitBatch", self._handle_submit_batch)
        self.httpd.route("GET", "/stats", self._handle_stats)
        self.httpd.route("GET", "/quote", self._handle_quote)
        self.httpd.route("GET", "/placed", self._handle_placed)
        self.httpd.route("POST", "/admin/quiesce", self._handle_quiesce)
        # /metrics and /healthz ride the Service defaults (lifecycle.py):
        # the Prometheus render off the bridged Meter, and this service's
        # health() verdict below

    def _handle_submit_fifo(self, body: bytes, headers: dict):
        """POST / — the reference's ReadyQueue endpoint (server.go:23-51),
        stage-only: no device work, no lock shared with the dispatch."""
        return self._submit_one(body, delay=False)

    def _handle_submit_delay(self, body: bytes, headers: dict):
        """POST /delay — the reference's Level0 endpoint (server.go:53-78),
        stage-only."""
        return self._submit_one(body, delay=True)

    def _submit_one(self, body: bytes, delay: bool):
        try:
            d = json.loads(body)
            jid, cores, mem, dur_ms, _ = job_from_json(d)
            c = int(d.get("Cluster", 0))
            tn = int(d.get("Tenant", 0))
            gpu = int(d.get("GpusNeeded", 0))
        except (ValueError, TypeError):
            return 400, None
        if not (0 <= c < self.C):
            return 400, json.dumps({"Error": f"no cluster {c}"}).encode()
        if not (0 <= tn < self.T):
            return 400, json.dumps({"Error": f"no tenant {tn}"}).encode()
        if self.T > 1 and delay != self._delay_policy:
            # parked (mismatched-endpoint) jobs are single-tenant Go-wire
            # parity: under hosting, a job aimed at the queue the policy
            # never drains is a client bug answered up front
            return 400, json.dumps(
                {"Error": "endpoint does not match the hosted policy "
                          "(multi-tenant hosting has no parked queue)"}
            ).encode()
        rejected, reasons, accepted, depth = self._stage(
            [(tn, c, jid, cores, mem, gpu, dur_ms, delay)])
        if rejected:
            return 503, self._quote(rejected, reasons, accepted, depth)
        self.meter.add("jobs_submitted", 1)
        if delay:
            self.meter.add("jobs_in_queue", 1)
        return 200, None

    def _handle_submit_batch(self, body: bytes, headers: dict):
        """POST /submitBatch — the front door's native client API: a JSON
        array of Go Job objects (optional ``Cluster`` per job; optional
        ``Delay`` routes a job with the /delay endpoint's semantics
        instead of the policy-matching default), admitted per job. A
        partially back-pressured batch answers 503 naming the rejected
        indices: the accepted prefix IS staged, and the client resubmits
        only ``RejectedIdx`` after ``RetryAfterMs`` — no head-of-line
        blocking by one saturated cluster."""
        try:
            arr = json.loads(body)
            if isinstance(arr, dict):
                arr = arr["Jobs"]
            jobs = []
            for d in arr:
                jid, cores, mem, dur_ms, _ = job_from_json(d)
                jobs.append((int(d.get("Tenant", 0)),
                             int(d.get("Cluster", 0)), jid, cores, mem,
                             int(d.get("GpusNeeded", 0)), dur_ms,
                             bool(d.get("Delay", self._delay_policy))))
        except (ValueError, TypeError, KeyError):
            return 400, None
        if any(not (0 <= j[1] < self.C) for j in jobs):
            return 400, json.dumps({"Error": "bad Cluster"}).encode()
        if any(not (0 <= j[0] < self.T) for j in jobs):
            return 400, json.dumps({"Error": "bad Tenant"}).encode()
        if self.T > 1 and any(j[7] != self._delay_policy for j in jobs):
            return 400, json.dumps(
                {"Error": "Delay does not match the hosted policy "
                          "(multi-tenant hosting has no parked queue)"}
            ).encode()
        rejected, reasons, accepted, depth = self._stage(jobs)
        self.meter.add("jobs_submitted", accepted)
        # the handler-side jobs_in_queue counter moves for every accepted
        # delay-routed job, exactly as the equivalent POST /delay would
        # (server.go:75-76) — the two wire paths expose one meter
        rej = set(rejected)
        n_delay = sum(1 for i, j in enumerate(jobs)
                      if j[7] and i not in rej)
        if n_delay:
            self.meter.add("jobs_in_queue", n_delay)
        if rejected:
            return 503, self._quote(rejected, reasons, accepted, depth)
        return 200, json.dumps({"Accepted": accepted}).encode()

    def _stale_503(self, age_ms: float):
        """A query against a snapshot past the freshness bound: 503 with
        the age, never a 200 off arbitrarily stale data (the staleness
        bugfix — a wedged refresh loop used to serve forever)."""
        self.meter.add("stale_503", 1)
        return 503, json.dumps({
            "Error": "snapshot stale — refresh loop wedged?",
            "SnapshotAgeMs": round(age_ms, 3),
            "SnapshotMaxAgeMs": self.snapshot_max_age_ms,
            "RetryAfterMs": round(self._retry_quote_ms(), 3)}).encode()

    def _fresh_snap(self):
        """(snapshot, None) when within the freshness bound, else
        (None, age_ms). Handlers answer queries only off a fresh view."""
        s = self._snap
        age = s.age_ms()
        if (self.snapshot_max_age_ms is not None
                and age > self.snapshot_max_age_ms):
            return None, age
        return s, None

    def _handle_stats(self, body: bytes, headers: dict):
        """GET /stats[?tenant=i] — constellation totals from the latest
        snapshot (never the device); ``tenant`` narrows every figure to
        one hosted tenant's row."""
        tn = self._query_int(headers, "tenant", -1)
        s, stale_age = self._fresh_snap()
        if s is None:
            return self._stale_503(stale_age)
        if tn >= 0:
            if tn >= self.T:
                return 400, json.dumps(
                    {"Error": f"no tenant {tn}"}).encode()
            with self._stage_lock:
                rej = int(self._rejected_t[tn])
                unseen = int(self._unseen[tn].sum())
            return 200, json.dumps({
                "tenant": tn, "t_ms": s.sim_t,
                "stage_t_ticks": s.stage_t,
                "placed_total": int(s.placed_t[tn]),
                "running": int(s.running_tc[tn].sum()),
                "queue_depth": int(s.depth_tc[tn].sum()),
                "jobs_in_queue": int(s.jobs_in_queue_tc[tn].sum()),
                "staged_unseen": unseen, "dispatches": s.dispatches,
                "rejected_503": rej,
                "snapshot_age_ms": round(s.age_ms(), 3)}).encode()
        return 200, json.dumps({
            "t_ms": s.sim_t, "stage_t_ticks": s.stage_t,
            "tenants": self.T,
            "placed_total": s.placed, "running": int(s.running.sum()),
            "queue_depth": int(s.queue_depth.sum()),
            "jobs_in_queue": int(s.jobs_in_queue.sum()),
            "staged_jobs": s.staged_jobs, "dispatches": s.dispatches,
            "drops": s.drops, "rejected_503": self._rejected_count(),
            "snapshot_age_ms": round(s.age_ms(), 3)}).encode()

    def _handle_quote(self, body: bytes, headers: dict):
        """GET /quote?cluster=N[&tenant=i] — wait-time quote for a
        would-be submitter: the tenant row's average wait plus the
        MEASURED staging latency (recent seal-to-dispatch cadence, see
        ``_measured_window_ms``) — under adaptive windows the fixed
        window wall over-quotes, sometimes by the whole window. Pure
        snapshot + host-deque arithmetic."""
        c = self._query_int(headers, "cluster", 0)
        tn = self._query_int(headers, "tenant", 0)
        if not (0 <= c < self.C):
            return 400, None
        if not (0 <= tn < self.T):
            return 400, json.dumps({"Error": f"no tenant {tn}"}).encode()
        s, stale_age = self._fresh_snap()
        if s is None:
            return self._stale_503(stale_age)
        aw = float(s.avg_wait_tc[tn][c])
        return 200, json.dumps({
            "cluster": c, "tenant": tn,
            "wait_quote_ms": round(aw + self._measured_window_ms(), 3),
            "avg_wait_ms": round(aw, 3),
            "queue_depth": int(s.depth_tc[tn][c]),
            "snapshot_age_ms": round(s.age_ms(), 3)}).encode()

    def _handle_placed(self, body: bytes, headers: dict):
        """GET /placed?cluster=N&id=J[&tenant=i] — placement lookup over
        the snapshot id columns."""
        c = self._query_int(headers, "cluster", 0)
        jid = self._query_int(headers, "id", -1)
        tn = self._query_int(headers, "tenant", 0)
        if not (0 <= c < self.C):
            return 400, None
        if not (0 <= tn < self.T):
            return 400, json.dumps({"Error": f"no tenant {tn}"}).encode()
        s, stale_age = self._fresh_snap()
        if s is None:
            return self._stale_503(stale_age)
        return 200, json.dumps({
            "cluster": c, "id": jid,
            "status": s.job_status(c, jid, tenant=tn),
            "snapshot_age_ms": round(s.age_ms(), 3)}).encode()

    def _handle_quiesce(self, body: bytes, headers: dict):
        """POST /admin/quiesce — maintenance drain for operators and the
        chaos harness (tools/chaos.py): stop the loops, flush every sealed
        tick, refresh the snapshot, write the final checkpoint (when
        armed), and answer the drained truth. The HTTP surface keeps
        serving queries off the frozen core; /healthz flips not-live.

        The drain itself runs on a dedicated MAINTENANCE thread: the
        device state's single-owner discipline survives (ownership passes
        from the pacer/drive loops to that thread, never to an HTTP
        handler), and the serve-sync contract — no device coercion on a
        request thread — holds even for this endpoint; the handler only
        signals and waits on host events. Exactly ONE maintenance thread
        ever starts: concurrent/retried quiesce requests (including a
        retry after a 503 timeout answer) attach to the in-flight drain
        instead of spawning a second owner of the device state."""
        with self._quiesce_start_lock:
            if self._quiesce_done is None:
                self._quiesce_done = threading.Event()
                self._quiesce_result = {}
                threading.Thread(
                    target=self._quiesce_and_report,
                    args=(self._quiesce_result, self._quiesce_done),
                    daemon=True, name=f"{self.name}-quiesce").start()
            done, result = self._quiesce_done, self._quiesce_result
        if not done.wait(timeout=300):
            return 503, json.dumps(
                {"Error": "quiesce still draining after 300s — retry to "
                          "re-attach"}).encode()
        if "Error" in result:
            return 503, json.dumps(result).encode()
        return 200, json.dumps(result).encode()

    def _quiesce_and_report(self, result: dict, done) -> None:
        """Maintenance-thread body of /admin/quiesce (never a handler)."""
        try:
            self.quiesce()
            s = self._snap
            result.update(
                ticks_dispatched=self.ticks_dispatched,
                dispatches=self.dispatches,
                placed=s.placed, sim_t=s.sim_t,
                staged_jobs=s.staged_jobs,
                queue_depth=int(s.queue_depth.sum()),
                running=int(s.running.sum()),
                recovered_jobs=self.recovered_jobs,
                checkpoint=self.checkpoint_path)
        except Exception as e:  # wedged loop — surfaced, not raced
            result["Error"] = str(e)
        finally:
            done.set()

    @staticmethod
    def _query_int(headers: dict, key: str, default: int) -> int:
        from urllib.parse import parse_qs
        q = parse_qs(headers.get("X-MCS-Query", ""))
        try:
            return int(q.get(key, [default])[0])
        except (ValueError, TypeError):
            return default

    def _rejected_count(self) -> int:
        with self._stage_lock:
            return self._rejected

    def _window_wall_ms(self) -> float:
        return self.window * self.cfg.tick_ms / self.speed

    def _measured_window_ms(self) -> float:
        """The staging latency a quote should promise: the MEAN measured
        inter-dispatch wall interval over the recent dispatch history,
        falling back to the configured window wall before two dispatches
        exist. Under adaptive windows ticks seal when buckets fill or
        deadlines pass, so the fixed ``_window_wall_ms`` bound can
        over-quote by nearly a whole window — quoting the measured
        cadence is the fix tests/test_services.py pins."""
        walls = list(self._dispatch_walls)
        if len(walls) < 2:
            return self._window_wall_ms()
        span = walls[-1] - walls[0]
        if span <= 0.0:
            return self._window_wall_ms()
        return (span / (len(walls) - 1)) * 1000.0

    # ------------------------------------------------------------------
    # staging (the only submit-path work: host tuples under one lock)
    # ------------------------------------------------------------------
    def _retry_quote_ms(self) -> float:
        """How long a back-pressured client should wait: admission budgets
        refill at the snapshot-refresh cadence (one per dispatch, i.e. per
        sealed window under load), so a quarter window is the expected
        wait for fresh room without oversleeping past a refill."""
        return min(max(self._window_wall_ms() / 4, 2.0), 200.0)

    def _stage(self, jobs: list[tuple], ta: Optional[int] = None,
               live_bounds: bool = True):
        """Stage (tenant, cluster, id, cores, mem, gpu, dur_ms, delay)
        tuples onto the open tick, admitting per job: a saturated
        (tenant, cluster) cell rejects its own jobs without
        head-of-line-blocking the rest of the batch. Four admission
        bounds, each surfacing as a quoted 503 (never a silent drop):

        - ``max_staged`` — total staging-ring room;
        - ``quota`` — the tenant's ``quota_jobs`` budget (TenantParams)
          against its staged+queued backlog, when metered;
        - ``queue`` — ``snapshot depth_tc[tn, c] + unseen[tn, c]``
          admitted against ``cfg.queue_capacity``, which makes a device
          queue-overflow drop impossible by construction (every admitted
          job is counted until a snapshot proves it left the queues);
        - ``k_cap`` — the per-(tick, tenant, cluster) bucket bound (also
          the chunk's K ceiling).

        ``ta`` overrides the arrival stamp (deterministic drivers feeding
        a trace — it must bucket to the open tick, asserted);
        ``live_bounds=False`` drops the queue-budget and quota bounds for
        those drivers: they follow a fixed trace the caller has sized,
        assert zero drops afterwards, and must not have live back-pressure
        perturb trace-following (the HTTP handlers always keep it on).

        Returns ``(rejected_indices, reasons, accepted, depth)``."""
        now = time.time() if self.track_latency else 0.0
        rejected: list[int] = []
        reasons: set[str] = set()
        wal_recs: list[dict] = []
        filled = False
        with self._stage_lock:
            # the snapshot must be read under the SAME lock hold as the
            # unseen counters: _refresh_snapshot swaps the snapshot and
            # decrements _unseen in one atomic step, so reading the
            # snapshot before the lock could pair a STALE depth with the
            # NEW unseen — inflating the budget by a whole dispatch's
            # jobs and re-opening the silent-drop hole
            snap = self._snap
            room = self.max_staged - self._staged_jobs
            budget: dict[tuple, int] = {}
            qleft: dict[int, int] = {}
            tick = self.cfg.tick_ms
            stamp = (self._stage_t + 1) * tick if ta is None else int(ta)
            if ta is not None:
                dest = max((stamp + tick - 1) // tick, 1) - 1
                assert dest == self._stage_t, (
                    f"ta={stamp} buckets to tick {dest}, open tick is "
                    f"{self._stage_t} — pace seal_tick() to the stream")
            for idx, (tn, c, jid, cores, mem, gpu, dur, delay) in \
                    enumerate(jobs):
                if room <= 0:
                    rejected.append(idx)
                    reasons.add("max_staged")
                    self._rejected_t[tn] += 1
                    continue
                if live_bounds:
                    if (self._quota is not None
                            and self._quota[tn] >= 0):
                        if tn not in qleft:
                            qleft[tn] = (int(self._quota[tn])
                                         - int(snap.depth_tc[tn].sum())
                                         - int(self._unseen[tn].sum()))
                        if qleft[tn] <= 0:
                            rejected.append(idx)
                            reasons.add("quota")
                            self._rejected_t[tn] += 1
                            continue
                    if (tn, c) not in budget:
                        budget[(tn, c)] = (self.cfg.queue_capacity
                                           - int(snap.depth_tc[tn, c])
                                           - int(self._unseen[tn, c]))
                    if budget[(tn, c)] <= 0:
                        rejected.append(idx)
                        reasons.add("queue")
                        self._rejected_t[tn] += 1
                        continue
                parked = delay != self._delay_policy
                if parked and self.T > 1:
                    raise ValueError(
                        "mismatched-endpoint routing (parked jobs) is "
                        "single-tenant Go-wire parity — handlers answer "
                        "400 before staging under multi-tenant hosting")
                if not parked and len(self._open[tn][c]) >= self.k_cap:
                    rejected.append(idx)
                    reasons.add("k_cap")
                    self._rejected_t[tn] += 1
                    continue
                row = make_row(jid, cores, mem, gpu, dur, stamp)
                if parked:
                    # endpoint the policy never drains: pushed straight
                    # into the ignored queue at dispatch time
                    # (endpoint-faithful routing, server.go:22-78 — the
                    # job sits forever)
                    self._parked.append((c, row, delay))
                else:
                    self._open[tn][c].append(row)
                    if (self.adaptive_window
                            and len(self._open[tn][c]) >= self.k_cap):
                        filled = True  # seal early once the lock is off
                self._staged_jobs += 1
                self._unseen[tn, c] += 1
                if live_bounds:
                    budget[(tn, c)] -= 1
                    if tn in qleft:
                        qleft[tn] -= 1
                room -= 1
                if self.track_latency:
                    self._submit_wall[(tn, c, jid)] = now
                if self._wal is not None and not self._replaying:
                    rec = {"c": c, "i": int(jid), "co": int(cores),
                           "m": int(mem), "g": int(gpu), "du": int(dur),
                           "dl": bool(delay), "t": int(stamp)}
                    if parked:
                        rec["p"] = 1
                    wal_recs.append(rec)
            if rejected:
                self._rejected += len(rejected)
            depth = int(snap.queue_depth.sum())
            if wal_recs:
                # durability BEFORE the ack: the fsync'd append happens
                # under the same lock hold that staged the jobs, so WAL
                # order is exactly staging order (what replay reconstructs)
                # and a 200 can only reach the client for records already
                # on disk
                if (self.checkpoint_path is not None
                        and (not self._wal_tick_off
                             or self._wal_tick_off[-1][0] != self._stage_t)):
                    # seek/rotation bookkeeping only matters when a
                    # checkpoint can anchor it — without checkpoints the
                    # WHOLE log is the recovery source (full replay from
                    # a fresh state), growth is intrinsic to that config,
                    # and the deque would just leak an entry per tick
                    self._wal_tick_off.append(
                        (self._stage_t, self._wal.tell()))
                if any(r.get("p") for r in wal_recs):
                    self._wal_parked = True
                self._wal.append(wal_recs)
        if filled:
            # adaptive early seal: a bucket at k_cap means the open tick
            # already carries a full dispatch-K of work — sealing now (off
            # the lock; seal_tick re-acquires) hands it to the drive loop
            # instead of letting it ripen a full pacer period while new
            # arrivals bounce off k_cap
            self.seal_tick()
        if rejected:
            self.meter.add("submit_rejected", len(rejected))
        return rejected, reasons, len(jobs) - len(rejected), depth

    def _quote(self, rejected, reasons, accepted, depth) -> bytes:
        return json.dumps({
            "Error": f"staging ring full ({'+'.join(sorted(reasons))}) — "
                     "retry",
            "Accepted": accepted, "RejectedIdx": rejected,
            "RetryAfterMs": round(self._retry_quote_ms(), 3),
            "QueueDepth": depth,
            "SnapshotAgeMs": round(self._snap.age_ms(), 3)}).encode()

    def submit_direct(self, c: int, jid: int, cores: int, mem: int,
                      dur_ms: int, gpu: int = 0, delay: Optional[bool] = None,
                      ta: Optional[int] = None, tenant: int = 0) -> bool:
        """Driver-side staging without the HTTP hop (tests, fuzz drivers)
        — one job through the same ``_stage`` core the handlers use, with
        the queue-budget bound off (``live_bounds=False``): deterministic
        drivers follow a fixed trace the caller has sized and assert zero
        drops on the final state, so live back-pressure must not perturb
        trace-following. ``ta`` overrides the arrival stamp — it must
        bucket to the open tick exactly as ``pack_arrivals_chunks`` would
        (asserted), so staged buckets stay interchangeable with stream
        buckets."""
        delay = self._delay_policy if delay is None else delay
        rejected, _reasons, _acc, _depth = self._stage(
            [(int(tenant), c, jid, cores, mem, gpu, dur_ms, delay)], ta=ta,
            live_bounds=False)
        return not rejected

    def seal_tick(self) -> None:
        """Close the open staging tick and start the next — the virtual
        clock's staging edge. The drive thread calls this on the pacing
        cadence; deterministic drivers call it directly."""
        with self._stage_lock:
            self._sealed.append(self._open)
            self._open = [[[] for _ in range(self.C)]
                          for _ in range(self.T)]
            self._stage_t += 1
            self._sealed_walls.append(time.time())

    # ------------------------------------------------------------------
    # crash recovery: WAL + atomic checkpoints (services/wal.py)
    # ------------------------------------------------------------------
    def _open_wal(self, recover: bool) -> None:
        """Restore (checkpoint + WAL-suffix replay) if asked and possible,
        then open the log for appends — truncating any torn final record
        so fresh appends never land after corrupt bytes. When the
        checkpoint carries a matching-generation byte offset (and no
        parked records muddy the tick-monotone prefix rule), the read
        SEEKS to the live suffix instead of decoding the log's whole
        lifetime; any mismatch falls back to the full scan — offsets are
        an optimization, the replay watermark filter is the truth."""
        from multi_cluster_simulator_tpu_torch.core import checkpoint as ckio
        from multi_cluster_simulator_tpu_torch.services import wal as walmod
        extra: dict = {}
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            try:
                # full header validation BEFORE any of it is trusted: an
                # unreadable, old-format, or wrong-config checkpoint must
                # not seed the WAL offset seek below (replaying a seeked
                # SUFFIX onto a fresh state would lose the prefix) — a
                # rejection here degrades to the coherent WAL-alone
                # full-history path, loudly, never a crash loop
                header = ckio._read_header(self.checkpoint_path)
                ckio._check_header(header, self.checkpoint_path,
                                   cfg=self.cfg)
                extra = header.get("extra") or {}
            except Exception as e:
                # WAL-alone is only a legal fallback when the log is FULL
                # history. A rotation compacted the dispatched prefix
                # away, so replaying the remainder onto a fresh state
                # would silently lose acked work — refuse loudly instead.
                # Evidence (best-effort from the raw header, readable
                # even when validation failed): a recorded rotation
                # count, or the log's current generation differing from
                # the one the checkpoint saw (rotate stamps a fresh one).
                evidence: dict = {}
                try:
                    evidence = ckio._read_header(
                        self.checkpoint_path).get("extra") or {}
                except Exception:
                    pass
                rotated = int(evidence.get("wal_rotations", 0) or 0) > 0
                if (not rotated and evidence.get("wal_gen") is not None
                        and self.wal_path and os.path.exists(self.wal_path)):
                    cur_gen = walmod.read_header(self.wal_path)
                    rotated = (cur_gen is not None
                               and cur_gen != evidence.get("wal_gen"))
                if rotated:
                    raise RuntimeError(
                        f"checkpoint {self.checkpoint_path} is not "
                        f"restorable ({e!r}) and the WAL has been "
                        "compacted (rotation evidence in the header): "
                        "WAL-alone recovery would silently lose the "
                        "dispatched prefix — restore a compatible build, "
                        "or delete BOTH files to start fresh") from e
                self.logger.error(
                    "checkpoint %s not restorable (%r); recovering from "
                    "the WAL alone", self.checkpoint_path, e)
                extra = {"_ckpt_unreadable": True}
        start = gen = None
        if recover and not extra.get("wal_parked"):
            start = extra.get("wal_offset")
            gen = extra.get("wal_gen")
        records, offsets, good_off, torn = walmod.read_records(
            self.wal_path, start=start, generation=gen)
        self.wal_torn_tail = torn
        if torn:
            self.logger.warning(
                "WAL %s has a torn final record (crash mid-append); "
                "discarding the tail at byte %d", self.wal_path, good_off)
        if recover and (records or (
                self.checkpoint_path
                and os.path.exists(self.checkpoint_path))):
            self._recover(records, extra)
        self._wal = walmod.WriteAheadLog(self.wal_path, fsync=True,
                                         start_offset=good_off)
        self._wal_parked = bool(extra.get("wal_parked")) or any(
            r.get("p") for r in records)
        if self.checkpoint_path is not None:
            # reseed the per-tick offset table from the surviving suffix:
            # a recovered process must keep pointing its NEXT checkpoint
            # at the oldest not-yet-dispatched record, not the log's end
            tick = self.cfg.tick_ms
            seed: dict[int, int] = {}
            for rec, off in zip(records, offsets):
                dest = max((int(rec["t"]) + tick - 1) // tick, 1) - 1
                if dest >= self.ticks_dispatched and dest not in seed:
                    seed[dest] = off
            with self._stage_lock:
                self._wal_tick_off.extend(sorted(seed.items()))

    def _recover(self, records: list[dict], extra: Optional[dict] = None
                 ) -> None:
        """Restart = restore the latest checkpoint + replay the WAL
        suffix. Exactly-once against the checkpoint's dispatch watermark
        T0 (``ticks_dispatched`` in the checkpoint header): a non-parked
        record staged on tick k was dispatched iff k < T0 — WAL order is
        staging order and dispatch consumes sealed ticks FIFO, so the
        dispatched set is exactly the tick-< T0 prefix; parked records
        are applied at dispatch edges regardless of tick, so the header's
        ``parked_applied`` count skips the applied prefix instead.
        Calling this again over the same files reproduces the same state
        (pure function of checkpoint + WAL), and a second in-process call
        is a no-op because the replayed jobs' ticks are already staged
        (tests/test_faults.py pins both)."""
        from multi_cluster_simulator_tpu_torch.core.checkpoint import load_state
        extra = extra or {}
        t0_ticks = 0
        parked_skip = 0
        if (self.checkpoint_path and os.path.exists(self.checkpoint_path)
                and not extra.get("_ckpt_unreadable")):
            # cfg verifies the v2 header's config digest: a checkpoint
            # from a differently-configured (or older-format) server must
            # never replay the WAL onto the wrong-shaped world. _open_wal
            # pre-validated the header, so a failure HERE (payload-level:
            # torn msgpack, leaf mismatch) is a corner — it degrades to
            # the WAL-alone fresh-state path like scheduler_host's
            # start-fresh fallback, UNLESS the records were offset-seeked
            # to a suffix (replaying a suffix onto a fresh state would
            # silently lose the prefix — refuse loudly instead).
            try:
                loaded = load_state(self.checkpoint_path, self._state,
                                    cfg=self.cfg)
            except (OSError, ValueError) as e:
                seeked = (extra.get("wal_offset") is not None
                          and not extra.get("wal_parked"))
                rotated = int(extra.get("wal_rotations", 0) or 0) > 0
                if seeked or rotated:
                    why = ("the WAL was offset-seeked to the "
                           "post-watermark suffix" if seeked else
                           "the WAL has been compacted by rotation")
                    raise RuntimeError(
                        f"checkpoint {self.checkpoint_path} failed to "
                        f"load ({e!r}) after its header validated, and "
                        f"{why} — cannot fall back to WAL-alone recovery "
                        "without losing the prefix; restore a compatible "
                        "build or delete BOTH files to start fresh"
                    ) from e
                self.logger.error(
                    "checkpoint %s not restorable (%r); recovering from "
                    "the WAL alone", self.checkpoint_path, e)
            else:
                # loaded leaves are distinct tensors on the state's
                # device, so the in-place dispatch can take them as they are
                self._state = loaded
                t0_ticks = int(extra.get("ticks_dispatched", 0))
                parked_skip = int(extra.get("parked_applied", 0))
                self.ticks_dispatched = t0_ticks
                self.dispatches = int(extra.get("dispatches", 0))
                self._parked_applied = parked_skip
                self._wal_rotations = int(extra.get("wal_rotations", 0))
        with self._stage_lock:
            self._stage_t = t0_ticks
        self._refresh_snapshot()
        tick = self.cfg.tick_ms
        replayed = 0
        self._replaying = True
        try:
            for rec in records:
                stamp = int(rec["t"])
                if rec.get("p"):
                    if parked_skip > 0:
                        parked_skip -= 1
                        continue
                    # parked rows sit in a queue the policy never drains;
                    # their stamp is advisory — restage on the open tick
                    ta = None
                else:
                    dest = max((stamp + tick - 1) // tick, 1) - 1
                    if dest < t0_ticks:
                        continue  # already in the checkpointed state
                    while self._staged_ticks() < dest:
                        self.seal_tick()
                    ta = stamp
                rej, _r, _a, _d = self._stage(
                    [(0, int(rec["c"]), int(rec["i"]), int(rec["co"]),
                      int(rec["m"]), int(rec["g"]), int(rec["du"]),
                      bool(rec["dl"]))], ta=ta, live_bounds=False)
                if rej:
                    raise RuntimeError(
                        f"WAL replay: acked job {rec['i']} rejected at "
                        "restage — staging bounds shrank under recovery?")
                replayed += 1
        finally:
            self._replaying = False
        self.recovered_jobs = replayed
        if replayed or t0_ticks:
            self.logger.info(
                "recovered: checkpoint at %d dispatched ticks + %d WAL "
                "jobs replayed (%d parked applied pre-crash)",
                t0_ticks, replayed, self._parked_applied)

    def _save_checkpoint(self) -> None:
        """Atomic device-state checkpoint (core/checkpoint.py: tmp +
        rename) with the recovery watermarks in the header. Runs on the
        dispatch owner's thread between dispatches, so the state snapshot
        is consistent by construction.

        Also the WAL's growth bound: the header records the byte offset
        of the first record the watermark has not covered (recovery seeks
        there instead of decoding the log's lifetime), and once the
        dispatched prefix exceeds ``wal_rotate_bytes`` the log is
        compacted to the live suffix (WriteAheadLog.rotate — a fresh
        generation, so a checkpoint from before a crash mid-rotation
        falls back to the full scan). Both are disabled once a parked
        record enters the log: parked application order is by dispatch
        edge, not tick, so only the full-list skip count is correct."""
        from multi_cluster_simulator_tpu_torch.core.checkpoint import save_state
        from multi_cluster_simulator_tpu_torch.services.wal import HEADER_LEN
        extra = {"ticks_dispatched": self.ticks_dispatched,
                 "parked_applied": self._parked_applied,
                 "dispatches": self.dispatches}
        if self._wal is not None:
            with self._stage_lock:
                # replay starts at the first tick the watermark missed;
                # fully-covered entries are never needed again
                while (self._wal_tick_off
                       and self._wal_tick_off[0][0] < self.ticks_dispatched):
                    self._wal_tick_off.popleft()
                start = (self._wal_tick_off[0][1] if self._wal_tick_off
                         else self._wal.tell())
                if (not self._wal_parked
                        and start - HEADER_LEN > self.wal_rotate_bytes):
                    delta = self._wal.rotate(start)
                    self._wal_rotations += 1
                    self._wal_tick_off = type(self._wal_tick_off)(
                        (tk, off - delta) for tk, off in self._wal_tick_off)
                    start -= delta
                extra.update(wal_offset=start, wal_gen=self._wal.generation,
                             wal_parked=self._wal_parked,
                             wal_rotations=self._wal_rotations)
        save_state(self._state, self.checkpoint_path, extra=extra,
                   cfg=self.cfg)

    # ------------------------------------------------------------------
    # dispatch (single owner: the drive thread or the deterministic driver)
    # ------------------------------------------------------------------
    def _sealed_count(self) -> int:
        with self._stage_lock:
            return len(self._sealed)

    def _staged_ticks(self) -> int:
        with self._stage_lock:
            return self._stage_t

    def _pick_k(self, need: int) -> int:
        """K bucket for a chunk: the smallest warmed bucket that fits
        (padding wider than needed is semantically invisible — ingest
        masks rows beyond each tick's count), else pow2 of the need: the
        chunk shapes stay the few the warm-up dispatched."""
        for k in self._warm_sorted:
            if k >= need:
                return k
        return round_up_pow2(need)

    def _pop_chunk(self, W: int):
        with self._stage_lock:
            ticks = self._sealed[:W]
            del self._sealed[:W]
            for _ in range(min(W, len(self._sealed_walls))):
                self._sealed_walls.popleft()
            parked, self._parked = self._parked, []
            n = sum(len(lst) for tk in ticks for row in tk
                    for lst in row) + len(parked)
            self._staged_jobs -= n
        # dispatched jobs stay in _unseen (the admission bound's view of
        # the device queues) until a snapshot shows them; _inflight is
        # drive-thread-owned bookkeeping of that handoff
        for tk in ticks:
            for tn, row in enumerate(tk):
                for c, lst in enumerate(row):
                    self._inflight[tn, c] += len(lst)
        for c, _row, _d in parked:
            self._inflight[0, c] += 1
        return ticks, parked, n

    def _dispatch(self, W: int) -> int:
        """Consume W sealed ticks as ONE device dispatch (all hosted
        tenants advance together: the tenant axis rides the stacked
        rows, not extra dispatches). Returns the number of jobs
        dispatched."""
        ticks, parked, n_jobs = self._pop_chunk(W)
        # mismatched-endpoint jobs enter the queue their endpoint names
        # (which the policy ignores — inert rows, so applying them at the
        # chunk edge instead of mid-chunk is invisible to placement;
        # PARITY.md §serving). One small push per parked row, no host
        # sync, and parked jobs exist
        # only when a client posts to the endpoint the policy never
        # drains — a client bug, not a traffic class worth a batched
        # kernel; max_staged bounds the worst case
        for c, row, delay in parked:
            op = host_ops.push_l0_at if delay else host_ops.push_ready_at
            self._state = op(self._state, np.asarray(row, np.int32), c)
        kmax = max((len(lst) for tk in ticks for row in tk for lst in row),
                   default=0)
        K = self._pick_k(max(kmax, 1))
        run_io, timed = self._pricing_exec()
        t_in = time.perf_counter() if timed else 0.0
        if self.T > 1:
            # tenant-batched dispatch: rows [T, W, C, K, NF] feed the ONE
            # lane-stacked run_io with the TenantParams stack
            rows = np.broadcast_to(_INVALID_ROW,
                                   (self.T, W, self.C, K, Q.NF)).copy()
            counts = np.zeros((self.T, W, self.C), np.int32)
            for ti, tk in enumerate(ticks):
                for tn, trow in enumerate(tk):
                    for c, lst in enumerate(trow):
                        if lst:
                            counts[tn, ti, c] = len(lst)
                            rows[tn, ti, c, :len(lst)] = np.asarray(
                                lst, np.int32)
            with annotate_dispatch("serving", ticks=W, jobs=n_jobs):
                if self.obs:
                    self._state, io, self._mbuf = run_io(
                        self._state, rows, counts, self._tp, self._mbuf)
                else:
                    self._state, io = run_io(
                        self._state, rows, counts, self._tp)
        else:
            rows = np.broadcast_to(_INVALID_ROW,
                                   (W, self.C, K, Q.NF)).copy()
            counts = np.zeros((W, self.C), np.int32)
            for ti, tk in enumerate(ticks):
                for c, lst in enumerate(tk[0]):
                    if lst:
                        counts[ti, c] = len(lst)
                        rows[ti, c, :len(lst)] = np.asarray(lst, np.int32)
            with annotate_dispatch("serving", ticks=W, jobs=n_jobs):
                if self.obs:
                    self._state, io, self._mbuf = run_io(
                        self._state, rows, counts, None, self._mbuf)
                else:
                    self._state, io = run_io(self._state, rows, counts)
        if timed:
            # the budget needs the device finished — the one deliberate
            # sync a budgeted pricing dispatch pays (see ctor comment)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._pricing_account(W, (time.perf_counter() - t_in) * 1000.0)
        self._dispatch_walls.append(time.time())
        self.ticks_dispatched += W
        self.dispatches += 1
        self._parked_applied += len(parked)
        self.batch_jobs.append(n_jobs)
        self._batch_n += 1
        self._batch_sum += n_jobs
        self._batch_max = max(self._batch_max, n_jobs)
        self.chunk_k.add(K)
        # coalesce batch-size distribution on the wire-telemetry surface
        # (drive-thread-side: never a handler cost)
        self.meter.record("coalesce_batch_jobs", float(n_jobs))
        if self.cfg.borrowing:
            # host visibility of the cross-cluster events (the TickIO
            # side-channel): counted into telemetry; the in-batch borrow
            # phase already matched them on device
            self.meter.add("borrow_requests", int(io.borrow_want.sum()))
            self.meter.add("returns_emitted", int(io.ret_valid.sum()))
        if self.dispatches % self.snapshot_every == 0:
            self._refresh_snapshot()
        if (self.checkpoint_path is not None
                and self.dispatches % self.checkpoint_every == 0):
            self._save_checkpoint()
        return n_jobs

    def _pricing_exec(self):
        """(run_io, timed) for the next dispatch. Untimed fast path
        unless a pricing budget is armed; under a tripped budget the
        greedy-matching fallback engine serves, except on re-probe
        dispatches (every ``pricing_reprobe``) where the solver gets one
        timed audition to win its seat back. Drive-thread-only state."""
        if not (self._pricing_armed and self.pricing_budget_ms is not None):
            return self._run_io, False
        if self._pricing_fallback:
            self._pricing_since_probe += 1
            if self._pricing_since_probe >= self.pricing_reprobe:
                self._pricing_since_probe = 0
                return self._run_io, True  # re-probe audition
            return self._run_io_fallback, False
        return self._run_io, True

    def _pricing_account(self, T: int, wall_ms: float) -> None:
        """Judge one timed pricing dispatch against the per-round budget.
        Rounds in a T-tick window follow the trade cadence (one round per
        ``monitor_period_ms``, and at least one — the conservative
        denominator, so a window with zero rounds can never trip)."""
        rounds = max(T * self.cfg.tick_ms // self.cfg.trader.monitor_period_ms,
                     1)
        blown = wall_ms > self.pricing_budget_ms * rounds
        if blown:
            self.pricing_fallbacks += 1
            self.meter.add("pricing_fallbacks", 1)
            if not self._pricing_fallback:
                self.logger.warning(
                    "pricing budget blown: %.2fms for %d round(s) against "
                    "%.2fms/round — falling back to greedy matching "
                    "(re-probe every %d dispatches)", wall_ms, rounds,
                    self.pricing_budget_ms, self.pricing_reprobe)
            self._pricing_fallback = True
            self._pricing_since_probe = 0
        elif self._pricing_fallback:
            self.logger.info(
                "pricing re-probe within budget (%.2fms for %d round(s)) "
                "— solver restored", wall_ms, rounds)
            self._pricing_fallback = False
            self._pricing_since_probe = 0

    def dispatch_sealed(self) -> int:
        """Dispatch every sealed tick: full coalesce windows first, then
        the tail (deterministic drivers; the drive thread only ever
        dispatches full windows). Returns jobs dispatched."""
        n = 0
        while self._sealed_count() >= self.window:
            n += self._dispatch(self.window)
        tail = self._sealed_count()
        if tail:
            n += self._dispatch(tail)
        return n

    _DROP_KEYS = ("queue", "msgs", "run_full", "vslot", "carve", "ingest",
                  "failed")

    @staticmethod
    def _snap_probe(s):
        """The snapshot's reads — the clock, the [C] counters, the drop
        totals, the queues' and the running set's id columns — as host
        numpy in ONE copy off the device: every value is packed into one
        int32 tensor (the f32 average wait by its bits) and split on the
        host. Leading tenant axes ride along ([T, ...] for a stacked
        state). Returns ``(t, placed, jobs_in_queue, depth, running,
        avg_wait, drops, queue_ids, run_ids, run_active)``."""
        i32 = torch.int32
        drops = torch.stack([getattr(s.drops, k).to(i32).sum(-1) for k in
                             ServingScheduler._DROP_KEYS], -1)
        parts = [s.t.to(i32), s.placed_total.to(i32),
                 s.jobs_in_queue.to(i32),
                 obs_device.queue_depth(s).to(i32),
                 s.run.active.to(i32).sum(-1, dtype=i32),
                 st.avg_wait_ms(s).to(torch.float32).view(i32), drops]
        parts += [Q.field(q, "id") for q in (s.l0, s.l1, s.ready, s.wait)]
        parts += [R.field(s.run, "id"), s.run.active.to(i32)]
        flat = _np(torch.cat([p.reshape(-1) for p in parts]))
        out, at = [], 0
        for p in parts:
            out.append(flat[at:at + p.numel()].reshape(tuple(p.shape)))
            at += p.numel()
        out[5] = out[5].view(np.float32)
        out[-1] = out[-1].astype(bool)
        return out

    def _refresh_snapshot(self) -> None:
        """Build the next immutable query snapshot from the device state —
        the ONE host synchronization in the serving loop, paid by the
        drive thread off the request path. Also the latency visibility
        edge: everything dispatched so far is host-visible once the swap
        below lands, so the (ticks, wall) pair is appended after it."""
        s = self._state
        inflight, self._inflight = (self._inflight,
                                    np.zeros((self.T, self.C), np.int64))
        (t, placed, jq, depth, running, aw, dr, *qids, run_ids,
         run_active) = self._snap_probe(s)
        if self.T > 1:
            # tenant-stacked probe leaves ([T], [T, C]): the legacy
            # constellation-level slots become cross-tenant aggregates
            # (sums; avg_wait a plain mean — /quote answers per tenant),
            # the *_tc slots keep the per-tenant rows the admission
            # bound and the tenant queries read. All tenants advance in
            # lockstep, so any row's clock is THE clock.
            jq_tc, run_tc, aw_tc = jq, running, aw
            payload = dict(
                wall=time.time(), sim_t=int(t[0]),
                placed_total=placed.sum(axis=0), placed=int(placed.sum()),
                jobs_in_queue=jq_tc.sum(axis=0),
                queue_depth=depth.sum(axis=0),
                running=run_tc.sum(axis=0),
                avg_wait_ms=aw_tc.mean(axis=0),
                drops=dict(zip(self._DROP_KEYS, dr.sum(axis=0).tolist())),
                queue_ids=qids, run_ids=run_ids, run_active=run_active,
                dispatches=self.dispatches,
                tenants=self.T, depth_tc=depth,
                placed_t=placed.sum(axis=1), running_tc=run_tc,
                jobs_in_queue_tc=jq_tc, avg_wait_tc=aw_tc)
        else:
            payload = dict(
                wall=time.time(), sim_t=int(t),
                placed_total=placed, placed=int(placed.sum()),
                jobs_in_queue=jq,
                queue_depth=depth,
                running=running,
                avg_wait_ms=aw,
                drops=dict(zip(self._DROP_KEYS, dr.tolist())),
                queue_ids=qids, run_ids=run_ids, run_active=run_active,
                dispatches=self.dispatches,
                tenants=1, depth_tc=depth[None],
                placed_t=placed.sum(keepdims=True))
            # single-tenant rows are views of the owned aggregates (no
            # second coercion): the tenant axis is just [1, ...]
            payload["running_tc"] = payload["running"][None]
            payload["jobs_in_queue_tc"] = payload["jobs_in_queue"][None]
            payload["avg_wait_tc"] = payload["avg_wait_ms"][None]
        prev = self._snap
        with self._stage_lock:
            # the unseen decrement and the snapshot swap are ONE atomic
            # step: dispatched jobs leave the admission bound's unseen set
            # only when the snapshot that shows their queue residency is
            # the one _stage reads — decrementing before the swap would
            # let a concurrent submit pair the NEW unseen with the STALE
            # depth and over-admit into a full device queue (the silent-
            # drop class this bound exists to exclude)
            self._unseen -= inflight
            self._snap = Snapshot(stage_t=self._stage_t,
                                  staged_jobs=self._staged_jobs, **payload)
        self.visibility_log.append((self.ticks_dispatched,
                                    payload["wall"]))
        self._bridge_meter(prev)

    def _bridge_meter(self, prev: Optional[Snapshot]) -> None:
        """Bridge the refreshed snapshot + the harvested device metrics
        into the OTLP Meter (the one metrics store): the Prometheus
        /metrics route and the Go-wire OTLP export both render from it,
        so the two surfaces report identical numbers for the same window.
        Runs on the refresh thread, off the request path; the harvest is
        the plane's one chunk-boundary transfer (the refresh already
        synced the same dispatch)."""
        s = self._snap
        m = self.meter
        m.set_gauge("placed_total", float(s.placed))
        m.set_gauge("queue_depth", float(s.queue_depth.sum()))
        m.set_gauge("running", float(s.running.sum()))
        m.set_gauge("staged_jobs", float(s.staged_jobs))
        m.set_gauge("dispatches", float(s.dispatches))
        m.set_gauge("ticks_dispatched", float(self.ticks_dispatched))
        m.set_gauge("rejected_503", float(self._rejected_count()))
        m.set_gauge("sim_t_ms", float(s.sim_t))
        if self.T > 1:
            # per-tenant rows as labeled series off the SAME snapshot —
            # one harvest, T label values; /metrics renders them via
            # telemetry.prom_split_labels (never a per-tenant device sync)
            with self._stage_lock:
                rej_t = self._rejected_t.copy()
            for tn in range(self.T):
                lbl = f'{{tenant="{tn}"}}'
                m.set_gauge(f"tenant_placed_total{lbl}",
                            float(s.placed_t[tn]))
                m.set_gauge(f"tenant_queue_depth{lbl}",
                            float(s.depth_tc[tn].sum()))
                m.set_gauge(f"tenant_running{lbl}",
                            float(s.running_tc[tn].sum()))
                m.set_gauge(f"tenant_rejected_503{lbl}", float(rej_t[tn]))
        if prev is not None:
            # the retiring snapshot's final age — how stale queries could
            # have seen the surface this window (gauge + distribution)
            age = (s.wall - prev.wall) * 1000.0
            m.set_gauge("snapshot_age_ms", round(age, 3))
            m.record("snapshot_age_ms_hist", age)
        if self.obs and self._mbuf is not None:
            if self.T > 1:
                # one coercion for the whole stacked buffer, then cheap
                # per-tenant harvests over host views
                host_mb = tree_map(lambda x: x.detach().cpu(), self._mbuf)
                cells = [obs_device.harvest(
                    self._tenancy.tenant_cell(host_mb, tn))
                    for tn in range(self.T)]
                h = {
                    "ticks": cells[0]["ticks"],  # shared dispatch clock
                    "placed": sum(c["placed"] for c in cells),
                    "arrived": sum(c["arrived"] for c in cells),
                    "wait_accrued_ms": round(sum(
                        c["wait_accrued_ms"] for c in cells), 3),
                    "narrow_ovf": sum(c["narrow_ovf"] for c in cells),
                    "queue_depth_max": max(
                        c["queue_depth_max"] for c in cells),
                }
                for tn, c in enumerate(cells):
                    m.set_gauge(f'tenant_obs_placed{{tenant="{tn}"}}',
                                float(c["placed"]))
            else:
                h = obs_device.harvest(self._mbuf)
            self._obs_harvest = h
            m.set_gauge("obs_ticks", float(h["ticks"]))
            m.set_gauge("obs_placed", float(h["placed"]))
            m.set_gauge("obs_arrived", float(h["arrived"]))
            m.set_gauge("obs_queue_depth_max", float(h["queue_depth_max"]))
            m.set_gauge("obs_wait_accrued_ms", float(h["wait_accrued_ms"]))
            m.set_gauge("obs_narrow_ovf", float(h["narrow_ovf"]))

    @property
    def snapshot(self) -> Snapshot:
        return self._snap

    def health(self) -> tuple[bool, dict]:
        """/healthz verdict: the pacer and drive threads must be alive
        (pacer mode) and the snapshot within its freshness bound — a dead
        loop or a wedged refresh flips the surface to 503 while the HTTP
        server itself still answers (the whole point: the transport
        outliving the core must be VISIBLE)."""
        checks = {}
        if self._wedged:
            # unconditional (survives _started flipping off): a wedged
            # stop must read as unhealthy, never as a clean shutdown
            checks["shutdown_wedged"] = False
            checks["wedged_thread"] = self._wedged
        if self.pacer and self._started:
            checks["pacer_alive"] = (self._pacer_thread is not None
                                     and self._pacer_thread.is_alive())
            checks["drive_alive"] = (self._drive_thread is not None
                                     and self._drive_thread.is_alive())
        age = self._snap.age_ms() if self._snap is not None else None
        if self.snapshot_max_age_ms is not None and age is not None:
            checks["snapshot_fresh"] = age <= self.snapshot_max_age_ms
        ok = all(checks.values())
        detail = dict(checks)
        if age is not None:
            detail["snapshot_age_ms"] = round(age, 3)
        detail["dispatches"] = self.dispatches
        return ok, detail

    def warmup(self, ks=None) -> None:
        """Build and load every kernel the hosted config launches (a first
        use on the card runs nvcc, seconds) by one dispatch of each
        (window, K) shape on a throwaway clone of the state, so no live
        dispatch pays a build and the paced snapshot never goes stale on
        one. ``start`` runs it before the HTTP surface comes up."""
        ks = self.warm_k if ks is None else ks
        execs = [self._run_io]
        if self._run_io_fallback is not None:
            # the greedy fallback engine must be warm BEFORE a blown
            # pricing budget reaches for it — a mid-traffic first use on
            # the escape path would itself blow the window it rescues
            execs.append(self._run_io_fallback)
        windows = [self.window]
        if self.adaptive_window and self.window > 1:
            windows.append(1)  # the early-dispatch shape (_adaptive_due)
        for W, K in ((w, k) for w in windows for k in ks):
            if self.T > 1:
                rows = np.broadcast_to(
                    _INVALID_ROW, (self.T, W, self.C, int(K), Q.NF)).copy()
                counts = np.zeros((self.T, W, self.C), np.int32)
            else:
                rows = np.broadcast_to(
                    _INVALID_ROW, (W, self.C, int(K), Q.NF)).copy()
                counts = np.zeros((W, self.C), np.int32)
            for run_io in execs:
                clone = clone_state(self._state)
                if self.obs:  # warm the kernel form the live path launches
                    mb = tree_map(torch.clone, self._mbuf)
                    out, _io, _mb = run_io(
                        clone, rows, counts,
                        self._tp if self.T > 1 else None, mb)
                elif self.T > 1:
                    out, _io = run_io(clone, rows, counts, self._tp)
                else:
                    out, _io = run_io(clone, rows, counts)
                if self.device.type == "cuda":  # the clone is discarded
                    torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # drive loop (wall-clock pacing)
    # ------------------------------------------------------------------
    def start(self) -> None:
        """Warm up (``warmup``) BEFORE the HTTP surface comes up, then start
        the service."""
        if not self._started:
            self.warmup()
        super().start()

    def on_start(self) -> None:
        self._refresh_snapshot()
        if self.pacer:
            self._pacer_thread = threading.Thread(
                target=self._pacer_loop, daemon=True,
                name=f"{self.name}-pacer")
            self._drive_thread = threading.Thread(
                target=self._drive_loop, daemon=True,
                name=f"{self.name}-drive")
            self._pacer_thread.start()
            self._drive_thread.start()

    def quiesce(self) -> None:
        """Stop the pacer/drive loops while the HTTP surface keeps
        serving (maintenance drain): every sealed tick is dispatched,
        the snapshot refreshed once, and from then on queries/metrics
        answer off a frozen core. /healthz flips unhealthy — a quiesced
        service is deliberately not live.

        The final flush only runs once BOTH loops have provably exited:
        a drive thread wedged past the join timeout still owns the
        device state, and dispatching from this thread too would make two
        concurrent owners (two in-place dispatches on one state, acked
        jobs lost) — exactly the wedge /healthz exists to surface, so flip
        the surface to 503 and raise instead of racing it."""
        self._stop.set()
        for th in (self._pacer_thread, self._drive_thread):
            if th is not None:
                th.join(timeout=self.stop_join_timeout_s)
                if th.is_alive():
                    self._wedged = th.name  # /healthz answers 503 now
                    self.logger.error(
                        "quiesce: %s did not exit within %.1fs — wedged; "
                        "/healthz flipped to 503", th.name,
                        self.stop_join_timeout_s)
                    raise RuntimeError(
                        f"quiesce: {th.name} did not exit within "
                        f"{self.stop_join_timeout_s:.0f}s — the loop is "
                        "wedged (it still owns the device state, so no "
                        "drain flush can run); /healthz is reporting it")
        self._pacer_thread = None
        self._drive_thread = None
        self.dispatch_sealed()
        self._refresh_snapshot()
        if self.checkpoint_path is not None:
            self._save_checkpoint()  # the drained truth, durably
        # a deliberately frozen core is not a wedged refresh loop: the
        # final snapshot above is the drained truth and stays servable,
        # so disarm the staleness bound (health() still reports the
        # service not-live via the dead-loop checks)
        self.snapshot_max_age_ms = None

    def on_shutdown(self) -> None:
        self._stop.set()
        if self._pacer_thread is not None:
            self._pacer_thread.join(timeout=self.pacer_join_timeout_s)
            if self._pacer_thread.is_alive():
                self._wedged = self._pacer_thread.name
        if self._drive_thread is not None:
            self._drive_thread.join(timeout=self.stop_join_timeout_s)
            if self._drive_thread.is_alive():
                self._wedged = self._drive_thread.name
        if self._wedged:
            # wedged-thread honesty: a loop that never exited still owns
            # the device state — a flush here would make two
            # concurrent owners. Log it, flip /healthz to 503 (the
            # lifecycle keeps the diagnostic surface up — Service.shutdown
            # checks wedged()), and do NOT pretend shutdown succeeded.
            self.logger.error(
                "shutdown: %s did not exit within its join timeout — "
                "wedged; skipping the final flush (the wedged loop still "
                "owns the device state) and flipping /healthz to 503",
                self._wedged)
            return
        if self.pacer:
            # final flush AFTER both threads have exited: a flush inside
            # the drive loop could race the still-running pacer and
            # strand a tick sealed after the flush read the backlog —
            # 200-acknowledged jobs silently lost at process exit. Here
            # the caller thread owns the state (both owners joined), so
            # every sealed tick is dispatched exactly once. Anything
            # still OPEN was never sealed into virtual time and stays
            # staged (durable in the WAL when one is armed — recovery
            # restages it).
            self.dispatch_sealed()
            self._refresh_snapshot()
        if self.checkpoint_path is not None:
            self._save_checkpoint()
        if self._wal is not None:
            self._wal.close()

    def _pacer_loop(self) -> None:
        """Seal staging ticks on the virtual-time cadence (``speed``
        virtual seconds per wall second, catching up in bursts when the
        host lags). Sealing is lock-append work and runs in its own
        thread so an in-flight dispatch never stalls the staging clock —
        which would pool every concurrent arrival into one open tick and
        trip the k_cap back-pressure for the whole dispatch duration.

        Virtual time slews, never runs away: when dispatch falls behind
        the requested speed, sealing stops at the lead cap and the
        achieved virtual rate degrades to dispatch-bound — the live
        host's achieved_speed contract, with back-pressure (503 quotes)
        instead of an unbounded sealed backlog."""
        period = self.cfg.tick_ms / 1000.0 / self.speed
        # sealed-backlog cap: 2 windows keeps the staging pipeline short —
        # a staged job is dispatched (and leaves the admission bound's
        # unseen set) within ~2 window walls, so the queue-budget refill
        # rate, admission_rate ≈ C·queue_capacity / lead_wall, stays high;
        # an 8-window lead measured 4x lower sustained admission
        max_lead = 2 * self.window
        t0 = time.time()
        # rebase on the staging clock at loop start: a RECOVERED service
        # resumes with _stage_t already at the checkpoint watermark, and
        # an elapsed-from-zero target would stall sealing until wall time
        # caught up with the whole pre-crash history
        base = self._staged_ticks()
        while not self._stop.is_set():
            due = min(base + int((time.time() - t0) / period),
                      self.ticks_dispatched + max_lead)
            while self._staged_ticks() < due:
                self.seal_tick()
            time.sleep(min(max(period / 2, 0.0005), 0.02))

    def _adaptive_due(self) -> int:
        """Sealed ticks to dispatch NOW under adaptive windows: the full
        window when one is ready, else ONE tick once the oldest sealed
        tick has waited past the deadline (tail-latency escape hatch — a
        light-traffic tick stops idling out the whole window wall).
        Single-tick granularity on the early path keeps the dispatch
        shapes at the two the warm-up ran (W and 1). 0 = wait."""
        with self._stage_lock:
            n = len(self._sealed)
            oldest = self._sealed_walls[0] if self._sealed_walls else None
        if n >= self.window:
            return self.window
        if n == 0 or oldest is None:
            return 0
        deadline = self.adaptive_deadline_ms
        if deadline is None:
            deadline = max(self._window_wall_ms() / 4.0, 1.0)
        return 1 if (time.time() - oldest) * 1000.0 >= deadline else 0

    def _drive_loop(self) -> None:
        """Dispatch a coalesce window whenever one is sealed — back-to-
        back when the backlog is deep (throughput degrades to
        device-bound, never to drops), idle-waiting when traffic is
        light. With ``adaptive_window`` armed, partial windows whose
        oldest sealed tick has aged past the deadline dispatch early
        (p99 under light load stops paying the full window wall; the
        early-seal half lives in ``_stage``: a full k_cap bucket seals
        its tick without waiting for the pacer)."""
        period = self.cfg.tick_ms / 1000.0 / self.speed
        while not self._stop.is_set():
            if self.adaptive_window:
                due = self._adaptive_due()
                if due > 0:
                    self._dispatch(due)
                else:
                    time.sleep(min(max(period / 4, 0.0005), 0.005))
            elif self._sealed_count() >= self.window:
                self._dispatch(self.window)
            else:
                time.sleep(min(max(period, 0.001), 0.02))
        # the final flush happens in on_shutdown AFTER this thread and
        # the pacer are both joined — flushing here would race a pacer
        # still sealing and strand an acknowledged tick

    # ------------------------------------------------------------------
    # introspection (drivers/tests; syncs — never called from handlers)
    # ------------------------------------------------------------------
    def provenance(self) -> dict:
        """Serving provenance for bench detail dicts — joinable with
        tournament/env rows (the same provenance keys). Batch-size mean/max are
        whole-run aggregates; the p50 comes from the bounded recent
        window."""
        return {
            "policy": self.engine.policy_provenance(),
            "market": dict(
                self.engine.market_provenance(),
                pricing_budget_ms=self.pricing_budget_ms,
                pricing_fallbacks=self.pricing_fallbacks,
                pricing_fallback_active=self._pricing_fallback),
            "coalesce_window_ticks": self.window,
            "adaptive_window": self.adaptive_window,
            "adaptive_deadline_ms": self.adaptive_deadline_ms,
            "tenants": self.T,
            "tenant_params_digest": (
                self._tenancy.tenant_params_digest(self._tp)
                if self._tp is not None else None),
            "clusters": self.C, "k_cap": self.k_cap,
            "max_staged": self.max_staged,
            "snapshot_every": self.snapshot_every,
            "dispatches": self.dispatches,
            "ticks_dispatched": self.ticks_dispatched,
            "batch_jobs": {
                "mean": round(self._batch_sum / self._batch_n, 2)
                if self._batch_n else 0.0,
                "max": self._batch_max,
                "p50": int(np.percentile(list(self.batch_jobs), 50))
                if self.batch_jobs else 0},
            "ragged_k": sorted(self.chunk_k),
            "rejected_503": self._rejected_count(),
            "obs": ({k: v for k, v in self._obs_harvest.items()
                     if k not in ("per_cluster", "ring")}
                    if self._obs_harvest else None),
        }

    def state_host(self) -> dict:
        """The full device state as OWNED host numpy leaves keyed by the
        reference's pytree paths (``interop.to_numpy``; copies, never views
        of a buffer the next dispatch advances in place) — the parity
        comparisons' and drain probes' view. Drive thread must be idle."""
        from multi_cluster_simulator_tpu_torch import interop
        return {k: np.array(v) for k, v in interop.to_numpy(
            self._state).items()}

    def latencies_ms(self) -> list[float]:
        """Submit-to-placed-visible latency per tracked job: placement
        tick from the device trace (cfg.record_trace), visibility wall
        from the dispatch log (the snapshot that made the tick
        host-readable), submit wall from the staging log."""
        if not self.track_latency:
            return []
        from multi_cluster_simulator_tpu_torch.utils.trace import extract_trace
        log = self.visibility_log
        tick = self.cfg.tick_ms
        out = []
        with self._stage_lock:
            submit = dict(self._submit_wall)
        if self.T > 1:
            cells = [self._tenancy.tenant_cell(self._state, tn)
                     for tn in range(self.T)]
        else:
            cells = [self._state]
        for tn, cell in enumerate(cells):
            for c, events in enumerate(extract_trace(cell)):
                for (t, jid, node, src) in events:
                    t0 = submit.get((tn, c, jid))
                    if t0 is None:
                        continue
                    # first snapshot whose dispatched ticks cover clock t
                    wall = next((w for (n, w) in log if n * tick >= t),
                                None)
                    if wall is not None:
                        out.append((wall - t0) * 1000.0)
        return out
