"""The scheduler service: a live host process around the device engine
(the port of ``multi_cluster_simulator_tpu/services/scheduler_host.py``).

Reference: pkg/scheduler's HTTP surface + run loop (server.go:22-153,
scheduler.go:101-124) and cmd/scheduler/main.go wiring. One service hosts one
cluster. The Go scheduler's 1 s loop *is* its decision engine; here the loop
body is one ``Engine.tick_io`` call on a C=1 ``SimState`` on ``device`` (the
card unless the caller names another) — the placement kernel, queue
bookkeeping, and wait accounting all run on the device, and the host acts
on the returned ``TickIO`` over the network:
borrow fan-out (BorrowResources, server.go:160-248) and finished-foreign-job
returns (ReturnToBorrower, server.go:260-290).

Wire parity: the HTTP endpoints (``/``, ``/delay``, ``/borrow``, ``/lent``,
``/newClient``) accept and emit the reference's Go-struct JSON shapes —
``Job`` fields ``Id/CoresNeeded/MemoryNeeded/Duration`` (int64 nanoseconds,
Go ``time.Duration``) ``/Ownership``; ``/newClient`` returns the Go
``Cluster`` JSON (spec.to_json). A Go client of the reference could talk to
this service unchanged.

``speed`` scales virtual time against wall time: the reference's 1 s tick
becomes ``tick_ms / 1000 / speed`` wall seconds (speed=1000 → ~1 ms/tick,
used by the integration tests).
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Optional

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import (
    RETURN_ATTEMPTS, PolicyKind, SimConfig,
)
from multi_cluster_simulator_tpu_torch.core import state as st
from multi_cluster_simulator_tpu_torch.core.engine import Engine
from multi_cluster_simulator_tpu_torch.core.spec import ClusterSpec
from multi_cluster_simulator_tpu_torch.core.state import (
    Arrivals, clone_state, init_state,
)
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import runset as R
from multi_cluster_simulator_tpu_torch.utils.tree import tree_map
from multi_cluster_simulator_tpu_torch.services import host_ops, httpd, telemetry
from multi_cluster_simulator_tpu_torch.services.lifecycle import Service
from multi_cluster_simulator_tpu_torch.services.registry import SERVICE_SCHEDULER


# -- Go Job JSON wire format (scheduler.go:65-73): struct field order,
# Duration in int64 nanoseconds, State a StateType STRING (zero value ""),
# WaitTime a time.Time (zero marshals as 0001-01-01T00:00:00Z) — pinned
# byte-for-byte against Go's json.Marshal by tests/test_wire_fixtures.py --

GO_ZERO_TIME = "0001-01-01T00:00:00Z"


def _np(x) -> np.ndarray:
    """A tensor's value as host numpy (a copy off the card)."""
    return x.detach().cpu().numpy()


def job_to_json(id, cores, mem, dur_ms, ownership="", state="") -> dict:
    return {"Id": int(id), "MemoryNeeded": int(mem),
            "CoresNeeded": int(cores), "State": state,
            "Duration": int(dur_ms) * 1_000_000,
            "WaitTime": GO_ZERO_TIME, "Ownership": ownership}


def job_from_json(d: dict) -> tuple[int, int, int, int, str]:
    """(id, cores, mem, dur_ms, ownership); accepts Go field names."""
    dur_ns = int(d.get("Duration", 0))
    return (int(d.get("Id", 0)), int(d.get("CoresNeeded", 0)),
            int(d.get("MemoryNeeded", 0)), dur_ns // 1_000_000,
            str(d.get("Ownership", "") or ""))


class SchedulerService(Service):
    service_name = SERVICE_SCHEDULER
    # discovers *peer* schedulers for borrowing (cmd/scheduler/main.go:81-86)
    required_services = [SERVICE_SCHEDULER]

    def __init__(self, name: str, spec: ClusterSpec, cfg: SimConfig,
                 registry_url: Optional[str] = None, speed: float = 1.0,
                 grpc_port: Optional[int] = 0,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_period_ticks: int = 50, device=None, **kw):
        super().__init__(name, registry_url=registry_url, speed=speed, **kw)
        # Live checkpointing (a capability the reference lacks — a Go
        # scheduler restart loses every queue, SURVEY.md §5): persist the
        # device state every N ticks; on start, restore from the file if it
        # exists so queued/running work survives a process restart.
        self.checkpoint_path = checkpoint_path
        self.checkpoint_period_ticks = checkpoint_period_ticks
        # gRPC ResourceChannel for this cluster's trader; None disables it
        # (cmd/scheduler starts one alongside the HTTP server, main.go:62-79)
        self.grpc_port = grpc_port
        self.grpc_addr: Optional[str] = None
        self._grpc_server = None
        self.spec = spec
        self.cfg = cfg
        # the card unless the caller names another device; without a card
        # and without device="cpu" this raises (core/state.resolve_device)
        self.engine = Engine(cfg, device=device)
        self.device = self.engine.device
        # (state, arrivals) -> (state', TickIO): the tick advances the state
        # it is given IN PLACE, so _tick_once hands it a clone
        self._tick_fn = self.engine.tick_io
        self._slock = threading.RLock()  # guards: state, _arr, _arr_n, _journal, _owner_urls, _owner_idx
        self.state = init_state(cfg, [spec], device=self.device)
        # host-side arrival staging ring ([1, A] to match the engine shapes)
        A = cfg.max_arrivals
        self._arr = {k: np.zeros((1, A), np.int32)
                     for k in ("t", "id", "cores", "mem", "gpu", "dur")}
        self._arr_n = 0
        # submit handlers append here without touching the device lock;
        # the tick thread drains it (so an in-flight build or device step
        # never blocks the HTTP surface)
        self._pending: list[tuple] = []
        # staged-but-not-consumed jobs (pending + unconsumed ring rows):
        # the submit handlers' back-pressure bound. Kept <= max_arrivals,
        # which makes the drain-time ring-full drop structurally
        # unreachable — a full ring answers 503 at submit time (with the
        # client still holding the job) instead of 200-then-silent-drop.
        # Conservative between ticks (the device may have consumed more
        # than the last recount saw); _drain_pending recomputes it.
        self._staged_n = 0
        self._plock = threading.Lock()  # guards: _pending, _staged_n
        # mutation journal: a list while a tick's device call is in flight
        # (handlers' state ops are replayed onto the tick result at swap
        # time — see _mutate/_tick_once), None otherwise
        self._journal: Optional[list] = None
        # borrower table: Ownership URL <-> owner index (>=1; 0 is this
        # cluster's own index in batch-engine semantics)
        self._owner_urls: list[str] = ["<self>"]
        self._owner_idx: dict[str, int] = {}
        self._stop = threading.Event()
        self._tick_thread: Optional[threading.Thread] = None
        # wedged-shutdown honesty: the join timeout is an attribute so
        # tests can shrink it; a blown timeout flips _wedged (and the
        # /healthz verdict) instead of returning as if shutdown succeeded
        self.stop_join_timeout_s = 10.0
        self._wedged: Optional[str] = None
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix=f"{name}-io")
        self.ticks_run = 0
        self._last_tick_wall: Optional[float] = None  # tick-loop liveness
        # Restore here, in __init__ — before Service.start() brings the
        # HTTP surface up — so no acknowledged mutation can ever precede
        # (and be clobbered by) the state swap.
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            try:
                self._restore_checkpoint()
            except Exception as e:
                # an unreadable/incompatible checkpoint (older format,
                # different config) must not brick the service — start
                # fresh and say so loudly
                self.state = init_state(cfg, [spec], device=self.device)
                self.logger.error(
                    "checkpoint %s not restorable (%r); starting fresh",
                    checkpoint_path, e)

    def _restore_checkpoint(self) -> None:
        from multi_cluster_simulator_tpu_torch.core.checkpoint import (
            load_extra, load_state,
        )
        # cfg engages the v2 header digest: a checkpoint from a
        # differently-configured scheduler is refused with the field
        # named (and the caller's start-fresh fallback engages)
        self.state = load_state(self.checkpoint_path, self.state,
                                cfg=self.cfg)
        # the host arrival ring died with the old process; rebase the
        # device cursor to the now-empty ring
        consumed = int(self.state.arr_ptr[0])
        if consumed:
            self.state = host_ops.rebase_arrivals(self.state, consumed)
        extra = load_extra(self.checkpoint_path)
        if extra:
            # borrower table — without it, owner indices in the restored
            # lent queue could never be returned
            self._owner_urls = extra["owner_urls"]
            self._owner_idx = {u: i for i, u
                               in enumerate(self._owner_urls) if i}
            # acknowledged-but-not-ingested jobs re-stage for the first
            # tick (they re-arrive at the restored clock); the submit
            # bound counts them from the start
            self._pending.extend(tuple(p) for p in extra.get("pending", []))
            self._staged_n = len(self._pending)
        self.logger.info(
            "restored checkpoint %s (t=%d ms, %d running, %d queued)",
            self.checkpoint_path, int(self.state.t),
            int(self.state.run.active.sum()),
            int(self.state.jobs_in_queue[0]))

    # ------------------------------------------------------------------
    # HTTP surface (RegisterHandlers, server.go:22-153)
    # ------------------------------------------------------------------
    def register_handlers(self) -> None:
        self.httpd.route("POST", "/", self._handle_submit_fifo)
        self.httpd.route("POST", "/delay", self._handle_submit_delay)
        self.httpd.route("POST", "/borrow", self._handle_borrow)
        self.httpd.route("POST", "/lent", self._handle_lent)
        self.httpd.route("GET", "/newClient", self._handle_new_client)
        # /metrics + /healthz come from the Service defaults
        # (lifecycle.py); health() below watches the tick loop

    def _handle_submit_fifo(self, body: bytes, headers: dict):
        """POST / — submit to the ReadyQueue (server.go:23-51) *regardless
        of the configured algorithm*, exactly as the reference's handler
        does; echoes a GET <Referer>/jobAdded acknowledgement. A full
        staging ring answers a retryable 503 (the job was NOT accepted)
        instead of the old 200-then-silent-drop."""
        try:
            job = job_from_json(json.loads(body))
        except ValueError:
            return 400, None
        # manual job-receipt span nested under the middleware's server span
        # (the reference opens one at the top of the handler, server.go:24)
        with self.tracer.start_span("receive_job", job_id=job[0]):
            if not self._stage_arrival(job, delay=False):
                return 503, self._ring_full_quote()
        referer = headers.get("Referer")
        if referer:
            self._pool.submit(httpd.get, referer.rstrip("/") + "/jobAdded")
        return 200, None

    def _handle_submit_delay(self, body: bytes, headers: dict):
        """POST /delay — submit to Level0 + wait-timer start
        (server.go:53-78), again endpoint-routed, not policy-routed. The
        device ingest phase starts the wait timer and the on-state
        jobs_in_queue counter; the meter here mirrors the handler-side OTel
        counter (server.go:75-76). 503 + quote when the staging ring is
        full, like POST /."""
        try:
            job = job_from_json(json.loads(body))
        except ValueError:
            return 400, None
        with self.tracer.start_span("receive_job", job_id=job[0]):
            if not self._stage_arrival(job, delay=True):
                return 503, self._ring_full_quote()
        self.meter.add("jobs_in_queue", 1)
        return 200, None

    def _ring_full_quote(self) -> bytes:
        """Machine-readable retry quote for a back-pressured submit: the
        ring turns over as the tick loop drains it, so one tick period is
        the natural retry horizon."""
        return json.dumps({
            "Error": "arrival ring full — retry",
            "RetryAfterMs": round(self.cfg.tick_ms / self.speed, 3),
        }).encode()

    def _mutate(self, op, replay=None):
        """Apply a state op (state -> (state', aux)) under the lock and
        return aux. While a tick's device call is in flight (_tick_once
        computes outside the lock), the op is also journaled and re-applied
        onto the tick's output at swap time — the "handler ran just after
        the tick" interleaving, which the reference's handlers race against
        its scheduling goroutine the same way (server.go:80-137 vs
        scheduler.go:298-369).

        ``replay`` (state -> (state', aux)), when given, is what the
        journal re-applies instead of ``op``: a decision the handler has
        ALREADY acknowledged must not vanish silently if the tick consumed
        the capacity it was based on — replay variants surface that as a
        drop counter + error log instead (the Go analogue commits under
        the node lock and the scheduler sees it afterwards; the one
        remaining soft spot, commit_borrow's still-same-head gate, is the
        first-200-wins race the reference also has)."""
        with self._slock:
            self.state, aux = op(self.state)
            if self._journal is not None:
                self._journal.append(replay or op)
        return aux

    def _handle_borrow(self, body: bytes, headers: dict):
        """POST /borrow — a peer asks me to host a job: Lend() feasibility,
        then append to the LentQueue with the borrower's ownership
        (server.go:80-113). 406 when infeasible."""
        try:
            jid, cores, mem, dur_ms, ownership = job_from_json(json.loads(body))
        except ValueError:
            return 400, None
        with self._slock:
            if not bool(host_ops.lend_feasible(self.state, cores, mem)):
                return 406, None
            owner = self._intern_owner(ownership)
            vec = host_ops.job_vec(id=jid, cores=cores, mem=mem, dur=dur_ms,
                                   enq_t=int(self.state.t), owner=owner)

            def replay(s):
                s2 = host_ops.push_lent(s, vec)
                if int(s2.lent.count[0]) == int(s.lent.count[0]):
                    # acked 200 but the post-tick LentQueue is full — surface
                    self.logger.error(
                        "replay: lent queue full, acked /borrow job %d dropped", jid)
                    s2 = s2.replace(drops=s2.drops.replace(
                        queue=s2.drops.queue + 1))
                return s2, None

            self._mutate(lambda s: (host_ops.push_lent(s, vec), None),
                         replay=replay)
        self.logger.info("lent: accepted job %d from %s", jid, ownership)
        return 200, None

    def _handle_lent(self, body: bytes, headers: dict):
        """POST /lent — a lender returns my finished job: remove it from the
        BorrowedQueue by field equality (server.go:115-137)."""
        try:
            jid, cores, mem, dur_ms, _ = job_from_json(json.loads(body))
        except ValueError:
            return 400, None
        vec = host_ops.job_vec(id=jid, cores=cores, mem=mem, dur=dur_ms)
        self._mutate(lambda s: (host_ops.remove_borrowed(s, vec), None))
        return 200, None

    def _handle_new_client(self, body: bytes, headers: dict):
        """GET /newClient — serialize my cluster for a joining workload
        client (server.go:139-153)."""
        return 200, json.dumps(self.spec.to_json(url=self.url or "")).encode()

    # ------------------------------------------------------------------
    # arrival staging (the tensor form of the submit handlers)
    # ------------------------------------------------------------------
    def _stage_arrival(self, job, delay: bool) -> bool:
        """Stage a submitted job for the tick thread. Returns False —
        nothing staged — when the ring bound is reached: the handler
        answers 503 and the telemetry counts the rejection, so a full ring
        is the CLIENT's signal to retry, never a silent drop at drain
        time."""
        jid, cores, mem, dur_ms, _ = job
        with self._plock:
            if self._staged_n >= self.cfg.max_arrivals:
                rejected = True
            else:
                rejected = False
                self._staged_n += 1
                self._pending.append((jid, cores, mem, dur_ms, delay))
        if rejected:
            self.meter.add("submit_rejected", 1)
            self.logger.warning(
                "arrival ring full; rejecting job %d with 503", jid)
            return False
        return True

    def _drain_pending(self) -> None:  # holds: _slock
        """Move submitted jobs into the engine, timestamped at the current
        virtual time. Caller holds the state lock.

        Routing is by *endpoint*, as in the reference (server.go:22-78):
        jobs submitted on the endpoint matching the configured policy
        (``/delay`` for DELAY/FFD, ``/`` for FIFO) flow through the batched
        arrival ring into the queue the policy drains; mismatched-endpoint
        jobs are pushed straight into the queue the policy *ignores* —
        where, exactly as in Go, they sit forever."""
        with self._plock:
            pending, self._pending = self._pending, []
        if not pending:
            self._recount_staged()
            return
        now = int(self.state.t)
        delay_policy = self.cfg.policy is not PolicyKind.FIFO
        for jid, cores, mem, dur_ms, delay in pending:
            if delay != delay_policy:  # endpoint the policy never drains
                vec = host_ops.job_vec(id=jid, cores=cores, mem=mem,
                                       dur=dur_ms, enq_t=now)
                op = host_ops.push_l0 if delay else host_ops.push_ready
                self.state = op(self.state, vec)
                continue
            if self._arr_n == self.cfg.max_arrivals:
                self._compact_arrivals()
            if self._arr_n == self.cfg.max_arrivals:
                # structurally unreachable since the submit bound
                # (_stage_arrival keeps staged <= max_arrivals, and the
                # compaction above removes every consumed row) — but if a
                # future edit breaks that invariant, COUNT the loss so no
                # acknowledged job ever vanishes silently
                self.logger.error(
                    "arrival ring full at drain; dropping acked job %d "
                    "(staging bound violated?)", jid)
                self.state = self.state.replace(drops=self.state.drops.replace(
                    queue=self.state.drops.queue + 1))
                continue
            i = self._arr_n
            self._arr["t"][0, i] = now
            self._arr["id"][0, i] = jid
            self._arr["cores"][0, i] = cores
            self._arr["mem"][0, i] = mem
            self._arr["dur"][0, i] = dur_ms
            self._arr_n += 1
        self._recount_staged()

    def _recount_staged(self) -> None:  # holds: _slock
        """Re-anchor the submit-path back-pressure counter to ground
        truth: unconsumed ring rows (the device cursor advanced since the
        last drain) plus whatever landed in _pending meanwhile."""
        consumed = int(self.state.arr_ptr[0])
        with self._plock:
            self._staged_n = (self._arr_n - consumed) + len(self._pending)

    def _compact_arrivals(self) -> None:  # holds: _slock
        """Drop the consumed prefix of the ring and rebase the device
        cursor (host_ops.rebase_arrivals). Caller holds the state lock."""
        consumed = int(self.state.arr_ptr[0])
        if consumed <= 0:
            return
        for a in self._arr.values():
            a[0, :self._arr_n - consumed] = a[0, consumed:self._arr_n]
        self._arr_n -= consumed
        self.state = host_ops.rebase_arrivals(self.state, consumed)

    def _arrivals_device(self) -> Arrivals:  # holds: _slock
        """The ring's filled prefix as the tick's windowed stream: columns
        past ``_arr_n`` hold nothing the ingest can take, so the stream
        the tick packs and copies to the device stops there rather than
        at ``max_arrivals``."""
        w = max(self._arr_n, 1)
        return Arrivals(**{k: a[:, :w] for k, a in self._arr.items()},
                        n=np.array([self._arr_n], np.int32))

    # ------------------------------------------------------------------
    # tick loop (the Run goroutine, scheduler.go:101-124)
    # ------------------------------------------------------------------
    def on_start(self) -> None:
        if self.grpc_port is not None:
            from multi_cluster_simulator_tpu_torch.services import rpc
            cadence_s = self.cfg.trader.state_cadence_ms / 1000.0 / self.speed
            self._grpc_server, self.grpc_addr = rpc.start_server(
                [rpc.resource_channel_handler(self, cadence_s, self._stop)],
                port=self.grpc_port)
        # anchor the /healthz recency check at loop start: without this,
        # a tick thread wedged inside its very FIRST device call would
        # never set the timestamp and the None-guard would skip the
        # recency check forever — alive-but-stuck reporting 200
        self._last_tick_wall = time.time()
        self._tick_thread = threading.Thread(target=self._tick_loop,
                                             daemon=True,
                                             name=f"{self.name}-tick")
        self._tick_thread.start()

    def on_shutdown(self) -> None:
        self._stop.set()
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=1)
        if self._tick_thread is not None:
            self._tick_thread.join(timeout=self.stop_join_timeout_s)
            if self._tick_thread.is_alive():
                # the tick loop never exited — it may be mid-device-call
                # and still owns the state lock's cadence; say so loudly
                # and flip /healthz to 503 (lifecycle keeps the surface
                # up for a wedged service) instead of a silent "stopped"
                self._wedged = self._tick_thread.name
                self.logger.error(
                    "shutdown: %s did not exit within %.1fs — wedged; "
                    "/healthz flipped to 503", self._wedged,
                    self.stop_join_timeout_s)
        self._pool.shutdown(wait=False)

    def on_stopped(self) -> None:
        # final graceful snapshot — taken only after the HTTP surface is
        # down, so no acknowledged mutation (e.g. a 200'd /borrow) can land
        # after the state we persist
        if self.checkpoint_path is not None:
            self._save_checkpoint()

    def _save_checkpoint(self) -> None:
        """Persist the device state plus the host-side pieces the state's
        indices are meaningless without: the borrower table (owner indices
        in the lent queue) and every 200-acknowledged job that hasn't been
        device-ingested yet (the pending list and the unconsumed tail of
        the arrival ring). Everything lands in ONE atomic file (the extra
        header of core/checkpoint.py), so a kill can never leave a
        state/sidecar pair from different moments.

        Only the reference snapshot happens under the lock: the state
        swapped in by a tick or a handler op is never written again (the
        tick advances a clone, the host ops return new tensors), so
        serialization and disk I/O run outside it and never stall the HTTP
        handlers or the tick loop."""
        from multi_cluster_simulator_tpu_torch.core.checkpoint import save_state
        delay_policy = self.cfg.policy is not PolicyKind.FIFO
        with self._slock:
            state = self.state  # immutable snapshot by reference
            arr_n = self._arr_n
            ring = {k: a[0, :arr_n].copy() for k, a in self._arr.items()}
            with self._plock:
                pending = [list(p) for p in self._pending]
            owner_urls = list(self._owner_urls)
        consumed = int(state.arr_ptr[0])
        for i in range(consumed, arr_n):  # staged but not ingested
            pending.append([int(ring["id"][i]), int(ring["cores"][i]),
                            int(ring["mem"][i]), int(ring["dur"][i]),
                            delay_policy])
        save_state(state, self.checkpoint_path,
                   extra={"owner_urls": owner_urls, "pending": pending},
                   cfg=self.cfg)

    def start(self) -> None:
        """Warm up (``_warmup``) BEFORE the HTTP surface comes up, then start
        the service: no request can meet a first kernel build."""
        if not self._started:
            self._warmup()
        super().start()

    def _warmup(self) -> None:
        """Build and load the tick's kernel (its first use on the card runs
        nvcc, seconds) and run the handler-path host ops once, before
        serving traffic, so no HTTP request and no paced tick ever waits on
        a build. The tick runs on a clone and is discarded; the ops are
        pure, so running them on the live state changes nothing."""
        with self._slock:
            self._tick_fn(clone_state(self.state), self._arrivals_device())
            vec = host_ops.job_vec(id=0, cores=1, mem=1, dur=1)
            host_ops.lend_feasible(self.state, 1, 1)
            host_ops.push_lent(self.state, vec)
            host_ops.remove_borrowed(self.state, vec)
            host_ops.commit_borrow(self.state, vec)
            host_ops.push_ready(self.state, vec)
            host_ops.push_l0(self.state, vec)

    def _tick_loop(self) -> None:
        period = self.cfg.tick_ms / 1000.0 / self.speed
        while not self._stop.wait(period):
            try:
                self._tick_once()
            except Exception as e:  # keep the loop alive; report loudly
                self.logger.error("tick failed: %r", e)

    def _tick_once(self) -> None:
        # Double-buffered: snapshot under the lock, run the device call
        # OUTSIDE it (it is the long pole — /borrow, /lent and the gRPC
        # handlers must never stall a full tick on it), then swap,
        # replaying any handler mutations that landed mid-tick (_mutate).
        # The tick advances its state in place, so it gets a clone (C=1:
        # small) taken under the lock: handlers keep reading and replacing
        # self.state meanwhile, and nothing they hold is written.
        with self._slock:
            self._drain_pending()
            snap = clone_state(self.state)
            arr = self._arrivals_device()
            self._journal = []
        try:
            state, io = self._tick_fn(snap, arr)
            io = tree_map(_np, io)
        except Exception:
            # journaled ops already live in self.state (the interim copy we
            # keep by skipping the swap); disarm so the list can't grow
            # unboundedly while the loop logs and retries
            with self._slock:
                self._journal = None
            raise
        with self._slock:
            try:
                for op in self._journal:
                    state, _ = op(state)
                self.state = state
            finally:
                # a replay failure keeps the interim self.state (ops were
                # already applied to it) — the tick is lost, not the acks
                self._journal = None
            t = int(self.state.t)
        self.ticks_run += 1
        self._last_tick_wall = time.time()
        if (self.checkpoint_path is not None
                and self.ticks_run % self.checkpoint_period_ticks == 0):
            self._save_checkpoint()
        # waitTime histogram on the reference's 5 s metric cadence
        # (metrics.go:19-30), plus the state gauges the /metrics surface
        # serves (tick-thread-side under the lock the read needs anyway —
        # never a handler-path device sync)
        if t % 5_000 == 0:
            with self._slock:
                self.meter.record("waitTime",
                                  float(st.avg_wait_ms(self.state)[0]))
                self.meter.set_gauge(
                    "placed_total",
                    float(self.state.placed_total[0]))
                from multi_cluster_simulator_tpu_torch.obs.device import (
                    queue_depth,
                )
                self.meter.set_gauge(
                    "queue_depth",
                    float(queue_depth(self.state)[0]))
        self.meter.set_gauge("ticks_run", float(self.ticks_run))
        self._process_returns(io)
        self._process_borrow(io)

    # -- TickIO actions --
    def _process_returns(self, io) -> None:
        """POST each finished foreign job back to its borrower's /lent,
        up to 3 attempts (ReturnToBorrower, server.go:260-290)."""
        # the borrower table grows from handler threads (under _slock);
        # snapshot it once instead of indexing it race-ily per message
        with self._slock:
            owner_urls = list(self._owner_urls)
        for m in range(io.ret_valid.shape[1]):
            if not io.ret_valid[0, m]:
                continue
            row = io.ret_rows[0, m]
            owner = int(row[R.ROWNER])
            if not (1 <= owner < len(owner_urls)):
                continue
            url = owner_urls[owner]
            payload = job_to_json(row[R.RID], row[R.RCORES], row[R.RMEM],
                                  row[R.RDUR], ownership=url)
            self._pool.submit(telemetry.wrap_ctx(self._post_return),
                              url, payload)

    def _post_return(self, url: str, payload: dict) -> None:
        """POST the finished job to the borrower's /lent, under a
        ReturnToBorrower span (server.go:260-290)."""
        with self.tracer.start_span("ReturnToBorrower", job_id=payload["Id"]):
            for _ in range(RETURN_ATTEMPTS):
                status, _ = httpd.post_json(url.rstrip("/") + "/lent", payload)
                if status == 200:
                    return
        self.logger.error("return to %s failed after %d attempts", url,
                          RETURN_ATTEMPTS)

    def _process_borrow(self, io) -> None:
        """BorrowResources (server.go:160-248): broadcast the failing
        wait-head to every peer scheduler; first 200 OK wins and the job
        moves WaitQueue -> BorrowedQueue. Lenders that also said OK keep
        their LentQueue copies — the reference never aborts them."""
        if not (self.cfg.borrowing and bool(io.borrow_want[0])):
            return
        if self.registry is None:
            return
        try:
            peers = [u for u in self.registry.get_providers(SERVICE_SCHEDULER)
                     if u != self.url]
        except LookupError:
            return
        if not peers:
            return
        vec = io.borrow_job[0]
        job = Q.JobRec(vec=torch.from_numpy(vec))
        payload = job_to_json(int(job.id), int(job.cores), int(job.mem),
                              int(job.dur), ownership=self.url)
        # BorrowResources span: the /borrow POSTs inherit it via wrap_ctx,
        # so the lender's server span parents onto this one (the
        # borrower→lender causality the reference's otelhttp gives it)
        with self.tracer.start_span("BorrowResources", job_id=int(job.id)):
            futs = {self._pool.submit(
                telemetry.wrap_ctx(httpd.post_json),
                p.rstrip("/") + "/borrow", payload): p for p in peers}
            for fut in as_completed(futs, timeout=10):
                status, _ = fut.result()
                if status == 200:
                    self._mutate(lambda s: (host_ops.commit_borrow(s, vec), None))
                    self.logger.info("borrowed: job %d hosted by %s",
                                     int(job.id), futs[fut])
                    break

    def _intern_owner(self, url: str) -> int:  # holds: _slock
        if url not in self._owner_idx:
            self._owner_idx[url] = len(self._owner_urls)
            self._owner_urls.append(url)
        return self._owner_idx[url]

    # ------------------------------------------------------------------
    # ResourceChannel surface (trader_server.go) — called by the rpc layer
    # ------------------------------------------------------------------
    def cluster_state(self) -> dict:
        """One ClusterState sample (trader_server.go:24-47)."""
        with self._slock:
            cu, mu = st.snapshot_utilization(self.state)
            return {
                "cores_utilization": float(cu[0]),
                "memory_utilization": float(mu[0]),
                "total_cpu": int(self.state.trader.snap_total_cores[0]),
                "total_memory": int(self.state.trader.snap_total_mem[0]),
                "average_wait_time": float(st.avg_wait_ms(self.state)[0]),
            }

    def level1_jobs(self) -> list[dict]:
        """GetLevel1 for ProvideJobs (scheduler.go:204-214)."""
        with self._slock:
            l1 = self.state.l1
            n = int(l1.count[0])
            cols = {k: _np(Q.field(l1, k)[0, :n])
                    for k in ("cores", "mem", "dur")}
        return [{"cores": int(cols["cores"][i]),
                 "mem": int(cols["mem"][i]),
                 "dur_ms": int(cols["dur"][i])} for i in range(n)]

    def provide_virtual_node(self, cores: int, mem: int, dur_ms: int) -> bool:
        """Lender-side carve (ProvideVirtualNode -> cluster.go:87-125)."""
        def op(s):
            s2, ok = host_ops.carve_occupy(
                s, cores, mem, dur_ms, mode=self.cfg.trader.carve_mode)
            ok = bool(ok)
            return (s2 if ok else s), ok

        def replay(s):
            s2, ok = op(s)
            if not ok:
                # the carve was already acked to the buyer; the tick consumed
                # the capacity it was based on — count it, don't lose it
                self.logger.error(
                    "replay: acked carve (%d cores, %d MB) no longer fits", cores, mem)
                s2 = s2.replace(drops=s2.drops.replace(
                    carve=s2.drops.carve + 1))
            return s2, ok

        return self._mutate(op, replay=replay)

    def receive_virtual_node(self, cores: int, mem: int, dur_ms: int) -> bool:
        """Borrower-side attach (ReceiveVirtualNode -> cluster.go:65-85)."""
        def op(s):
            s2, ok = host_ops.add_virtual_node(
                s, cores, mem, dur_ms, vstart=self.cfg.max_nodes,
                expire=self.cfg.trader.expire_virtual_nodes)
            ok = bool(ok)
            return (s2 if ok else s), ok

        def replay(s):
            s2, ok = op(s)
            if not ok:
                self.logger.error(
                    "replay: acked virtual node (%d cores, %d MB) lost its slot",
                    cores, mem)
                s2 = s2.replace(drops=s2.drops.replace(vslot=s2.drops.vslot + 1))
            return s2, ok

        return self._mutate(op, replay=replay)

    def health(self) -> tuple[bool, dict]:
        """/healthz verdict for the per-request host: the tick loop (the
        Go scheduler's Run goroutine equivalent) must be alive AND
        actually ticking — a loop thread wedged on a device call stays
        is_alive() forever, so recency is the real check (10 tick periods
        of slack covers a slow dispatch; the loop's own exception guard
        already keeps transient tick failures from killing it)."""
        checks = {}
        if self._wedged:
            # unconditional (survives _started flipping off): a wedged
            # stop must read as unhealthy, never as a clean shutdown
            checks["shutdown_wedged"] = False
            checks["wedged_thread"] = self._wedged
        if self._started:
            checks["tick_thread_alive"] = (self._tick_thread is not None
                                           and self._tick_thread.is_alive())
            period = self.cfg.tick_ms / 1000.0 / self.speed
            if self._last_tick_wall is not None:
                lag = time.time() - self._last_tick_wall
                checks["tick_loop_ticking"] = lag < max(10 * period, 2.0)
                checks["last_tick_s_ago"] = round(lag, 3)
        ok = all(v for v in checks.values() if isinstance(v, bool))
        return ok, {**checks, "ticks_run": self.ticks_run}

    # -- introspection for tests/operators --
    def stats(self) -> dict:
        with self._slock:
            s = self.state
            return {"t_ms": int(s.t),
                    "placed_total": int(s.placed_total[0]),
                    "jobs_in_queue": int(s.jobs_in_queue[0]),
                    "ready": int(s.ready.count[0]),
                    "l0": int(s.l0.count[0]),
                    "lent": int(s.lent.count[0]),
                    "borrowed": int(s.borrowed.count[0]),
                    "running": int(s.run.active.sum()),
                    "avg_wait_ms": float(st.avg_wait_ms(s)[0])}

    def state_host(self) -> dict:
        """The state's leaves as host numpy, keyed by the reference's
        pytree paths (``interop.to_numpy``): the parity probes' view."""
        from multi_cluster_simulator_tpu_torch import interop
        with self._slock:
            return interop.to_numpy(self.state)
