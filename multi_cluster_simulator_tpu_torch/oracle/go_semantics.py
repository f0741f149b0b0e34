"""Deterministic pure-Python oracle of the reference's scheduler + trader
semantics.

This is the golden-trace generator for parity tests: a straight-line
re-implementation of the Go loops (Fifo/Delay, pkg/scheduler/scheduler.go:
216-369; borrow, server.go:160-248; the trader market, pkg/trader) under the
determinizations documented in PARITY.md and MARKET.md — same phase order,
same quirks (the Level1 remove-then-skip iteration, strict-vs-non-strict
feasibility, whole-struct-equality dequeues, the as-built contract sizing and
carving arithmetic), written with plain lists and dicts so it can be
independently reviewed against the Go source. The TPU engine must produce
bit-identical placement traces and state to this oracle.

Node layout mirrors the engine's padded axis: physical slots
[0, cfg.max_nodes), virtual slots [cfg.max_nodes, cfg.total_nodes), so node
indices in traces are directly comparable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from multi_cluster_simulator_tpu_torch.config import PolicyKind, SimConfig
from multi_cluster_simulator_tpu_torch.core.spec import ClusterSpec
from multi_cluster_simulator_tpu_torch.core.state import (
    SRC_L0, SRC_L1, SRC_LENT, SRC_READY, SRC_WAIT, Arrivals,
)

NEVER = 2**31 - 1


@dataclasses.dataclass
class OJob:
    id: int
    cores: int
    mem: int
    dur: int
    enq_t: int
    owner: int = -1  # borrower cluster index; -1 own; -2 Foreign placeholder
    rec_wait: int = 0  # WaitTime.JobsMap entry

    def key(self):
        return (self.id, self.cores, self.mem, self.dur)


@dataclasses.dataclass
class ORunning:
    end_t: int
    node: int
    job: OJob


@dataclasses.dataclass
class OContract:
    cores: int = 0
    mem: int = 0
    time_ms: int = 0
    price: float = 0.0


class OCluster:
    def __init__(self, spec: ClusterSpec, cfg: SimConfig):
        N = cfg.total_nodes
        self.cap = [[0, 0] for _ in range(N)]
        self.free = [[0, 0] for _ in range(N)]
        self.active = [False] * N
        self.expire = [NEVER] * N
        for i, n in enumerate(spec.nodes):
            self.cap[i] = [n.cores, n.memory]
            self.free[i] = [n.cores, n.memory]
            self.active[i] = True
        self.l0: list[OJob] = []
        self.l1: list[OJob] = []
        self.ready: list[OJob] = []
        self.wait: list[OJob] = []
        self.lent: list[OJob] = []
        self.borrowed: list[OJob] = []
        self.running: list[ORunning] = []
        self.wait_total = 0  # TotalTime, ms
        self.wait_jobs = 0  # JobsCount
        self.jobs_in_queue = 0
        self.arr_ptr = 0
        # trader agent state (MARKET.md)
        self.snap_core_util = 0.0
        self.snap_mem_util = 0.0
        self.snap_avg_wait = 0.0
        self.snap_total_cores = sum(n.cores for n in spec.nodes)
        self.snap_total_mem = sum(n.memory for n in spec.nodes)
        self.cooldown_until = 0
        self.seller_locked_until = 0
        self.spent = 0.0

    def first_fit(self, j: OJob) -> Optional[int]:
        """ScheduleJob's >= scan (scheduler.go:127-139), active slots only."""
        for i in range(len(self.free)):
            if self.active[i] and self.free[i][0] >= j.cores and self.free[i][1] >= j.mem:
                return i
        return None

    def can_lend(self, j: OJob) -> bool:
        """Lend's strict > scan (scheduler.go:194-202)."""
        return any(self.active[i] and self.free[i][0] > j.cores and self.free[i][1] > j.mem
                   for i in range(len(self.free)))


def _f32(x: float) -> float:
    return float(np.float32(x))


class Oracle:
    def __init__(self, cfg: SimConfig, specs: list[ClusterSpec], arrivals: Arrivals):
        self.cfg = cfg
        self.clusters = [OCluster(s, cfg) for s in specs]
        self.arr = arrivals
        self.t = 0
        # events: (t, cluster, job_id, node, src)
        self.trace: list[tuple[int, int, int, int, int]] = []

    # -- helpers --
    def _place(self, c: int, j: OJob, node: int, src: int):
        cl = self.clusters[c]
        cl.free[node][0] -= j.cores
        cl.free[node][1] -= j.mem
        cl.running.append(ORunning(end_t=self.t + j.dur, node=node, job=j))
        self.trace.append((self.t, c, j.id, node, src))

    # -- phases --
    def _releases(self):
        returns: list[tuple[int, OJob]] = []  # (borrower cluster, job)
        for c, cl in enumerate(self.clusters):
            done = [r for r in cl.running if r.end_t <= self.t]
            cl.running = [r for r in cl.running if r.end_t > self.t]
            for r in done:
                cl.free[r.node][0] += r.job.cores
                cl.free[r.node][1] += r.job.mem
                if r.job.owner >= 0:  # lent job -> ReturnToBorrower
                    returns.append((r.job.owner, r.job))
        for dst, j in returns:
            bq = self.clusters[dst].borrowed
            self.clusters[dst].borrowed = [b for b in bq if b.key() != j.key()]

    def _expire_vnodes(self):
        for cl in self.clusters:
            for i in range(len(cl.cap)):
                if cl.active[i] and cl.expire[i] <= self.t:
                    cl.active[i] = False
                    cl.cap[i] = [0, 0]
                    cl.free[i] = [0, 0]
                    cl.expire[i] = NEVER

    def _arrivals(self):
        to_delay = self.cfg.policy in (PolicyKind.DELAY, PolicyKind.FFD)
        a = self.arr
        for c, cl in enumerate(self.clusters):
            n = int(a.n[c])
            while cl.arr_ptr < n and int(a.t[c, cl.arr_ptr]) <= self.t:
                i = cl.arr_ptr
                j = OJob(id=int(a.id[c, i]), cores=int(a.cores[c, i]),
                         mem=int(a.mem[c, i]), dur=int(a.dur[c, i]),
                         enq_t=int(a.t[c, i]))
                if to_delay:
                    cl.l0.append(j)
                    cl.wait_jobs += 1
                    cl.jobs_in_queue += 1
                else:
                    cl.ready.append(j)
                cl.arr_ptr += 1

    def _record_wait(self, cl: OCluster, j: OJob):
        cur = self.t - j.enq_t
        cl.wait_total += cur - j.rec_wait
        j.rec_wait = cur

    def _delay_pass(self, c: int):
        cl = self.clusters[c]
        # Level1 sweep — the literal Go loop with in-place removal + i++
        i = 0
        while i < len(cl.l1):
            j = cl.l1[i]
            self._record_wait(cl, j)
            node = cl.first_fit(j)
            if node is not None:
                self._place(c, j, node, SRC_L1)
                del cl.l1[i]
                cl.jobs_in_queue -= 1
            i += 1  # skips the element that slid into position i on removal
        # Level0 head
        if cl.l0:
            j = cl.l0[0]
            self._record_wait(cl, j)
            node = cl.first_fit(j)
            if node is not None:
                self._place(c, j, node, SRC_L0)
                cl.l0.pop(0)
                cl.jobs_in_queue -= 1
            elif self.t - j.enq_t >= self.cfg.max_wait_ms:
                cl.l1.append(cl.l0.pop(0))

    def _ffd_pass(self, c: int):
        cl = self.clusters[c]
        order = sorted(range(len(cl.l0)),
                       key=lambda i: (-cl.l0[i].cores, -cl.l0[i].mem, i))
        placed = set()
        for i in order:
            j = cl.l0[i]
            self._record_wait(cl, j)
            node = cl.first_fit(j)
            if node is not None:
                self._place(c, j, node, SRC_L0)
                placed.add(i)
                cl.jobs_in_queue -= 1
        cl.l0 = [j for i, j in enumerate(cl.l0) if i not in placed]

    def _fifo_pass(self, c: int) -> Optional[OJob]:
        """Returns the borrow-request job, if any (see PARITY.md §FIFO)."""
        cl = self.clusters[c]
        wait_active = len(cl.wait) > 0
        any_fail = False
        if not wait_active:
            while cl.ready and not any_fail:
                j = cl.ready.pop(0)
                node = cl.first_fit(j)
                if node is not None:
                    self._place(c, j, node, SRC_READY)
                else:
                    cl.wait.append(j)
                    any_fail = True
        borrow_req = None
        if cl.wait:
            j = cl.wait[0]
            node = cl.first_fit(j)
            if node is not None:
                self._place(c, j, node, SRC_WAIT)
                cl.wait.pop(0)
            elif self.cfg.borrowing:
                borrow_req = j
        if (not wait_active) and (not any_fail) and not cl.ready and cl.lent:
            j = cl.lent[0]
            node = cl.first_fit(j)
            if node is not None:
                self._place(c, j, node, SRC_LENT)
                cl.lent.pop(0)
        return borrow_req

    def _borrow_match(self, requests: dict[int, OJob]):
        """Feasibility over all lenders, lowest cluster index wins; no
        reservation between matches (the Go /borrow handler only checks)."""
        for b in sorted(requests):
            j = requests[b]
            winner = None
            for l, cl in enumerate(self.clusters):
                if l != b and cl.can_lend(j):
                    winner = l
                    break
            if winner is None:
                continue
            sent = dataclasses.replace(j, owner=b)
            bcl = self.clusters[b]
            bcl.borrowed.append(dataclasses.replace(j, owner=b))
            assert bcl.wait and bcl.wait[0].key() == j.key()
            bcl.wait.pop(0)
            self.clusters[winner].lent.append(sent)

    # -- trader market (MARKET.md) --
    def _snapshot(self):
        if self.t % self.cfg.trader.state_cadence_ms != 0:
            return
        for cl in self.clusters:
            uc = sum(cl.cap[i][0] - cl.free[i][0] for i in range(len(cl.cap)))
            um = sum(cl.cap[i][1] - cl.free[i][1] for i in range(len(cl.cap)))
            cl.snap_core_util = _f32(uc / max(cl.snap_total_cores, 1))
            cl.snap_mem_util = _f32(um / max(cl.snap_total_mem, 1))
            cl.snap_avg_wait = _f32(cl.wait_total / cl.wait_jobs) if cl.wait_jobs else 0.0

    def _price(self, cores, mem, time_ms):
        """Stepwise float32, mirroring the engine kernel's op order
        (ops/sizing.py:_price) so strict budget comparisons are bit-equal."""
        m = self.cfg.trader
        f = np.float32
        t_s = f(f(time_ms) / f(1000.0))
        a = f(f(f(t_s * f(cores)) * f(m.max_core_cost)))
        b = f(f(f(t_s * f(mem)) * f(m.max_mem_cost)))
        return float(f(a + b))

    def _fast_contract(self, cl: OCluster) -> OContract:
        m = self.cfg.trader
        con = OContract()
        for j in cl.l1:
            nt = max(con.time_ms, j.dur)
            nc, nm = con.cores + j.cores, con.mem + j.mem
            np_ = self._price(nc, nm, nt)
            if m.budget < 0 or np_ < m.budget:
                con = OContract(nc, nm, nt, np_)
            else:
                break
        return con

    def _small_contract(self, cl: OCluster) -> OContract:
        m = self.cfg.trader
        con = OContract()
        if m.small_node_sizing == "asbuilt":
            for j in cl.l1:
                nc = con.cores + (j.cores if j.cores > 0 else 0)
                nm = con.mem + (j.mem if j.mem > 0 else 0)
                nt = j.dur if j.dur > con.time_ms else 0
                np_ = self._price(nc, nm, nt)
                if m.budget < 0 or np_ < m.budget:
                    con = OContract(nc, nm, nt, np_)
                else:
                    break
        else:  # sane: max cores/mem, summed durations
            for j in cl.l1:
                nc, nm = max(con.cores, j.cores), max(con.mem, j.mem)
                nt = con.time_ms + j.dur
                np_ = self._price(nc, nm, nt)
                if m.budget < 0 or np_ < m.budget:
                    con = OContract(nc, nm, nt, np_)
                else:
                    break
        return con

    def _carve_plan(self, cl: OCluster, con: OContract):
        """AllocateVirtualNodeResources (cluster.go:87-125); as-built request
        arithmetic, occupancy clamped to [0, avail] (MARKET.md §carving)."""
        m = self.cfg.trader
        rc, rm = con.cores, con.mem
        amounts = []
        for i in range(len(cl.free)):
            if not cl.active[i]:  # the Go node list has no padded slots
                amounts.append((0, 0))
                continue
            ac, am = max(cl.free[i][0], 0), max(cl.free[i][1], 0)
            if m.carve_mode == "asbuilt":
                dc = abs(rc - ac) if rc > 0 else 0
                dm = abs(rm - am) if rm > 0 else 0
                rc = 0 if dc > rc else rc - dc
                rm = 0 if dm > rm else rm - dm
                oc, om = min(max(dc, 0), ac), min(max(dm, 0), am)
            else:
                oc, om = min(rc, ac), min(rm, am)
                rc, rm = rc - oc, rm - om
            amounts.append((oc, om))
        return amounts, (rc <= 0 and rm <= 0)

    def _approve(self, cl: OCluster, con: OContract) -> bool:
        """Stepwise float32 mirroring market/trader.py's ApproveTrade ops."""
        m = self.cfg.trader
        f = np.float32
        if not (f(cl.snap_core_util) < f(m.approve_core_threshold)
                and f(cl.snap_mem_util) < f(m.approve_mem_threshold)):
            return False
        tot_c, tot_m = f(cl.snap_total_cores), f(cl.snap_total_mem)
        avail_c = f(tot_c - f(tot_c * f(cl.snap_core_util)))
        avail_m = f(tot_m - f(tot_m * f(cl.snap_mem_util)))
        if not (avail_c >= f(con.cores) and avail_m >= f(con.mem)):
            return False
        t_s = f(f(con.time_ms) / f(1000.0))
        a = f(f(f(f(m.min_core_incentive) * f(con.cores)) * t_s))
        b = f(f(f(f(m.min_mem_incentive) * f(con.mem)) * t_s))
        return f(con.price) >= f(a + b)

    def _trade_round(self):
        m = self.cfg.trader
        if self.t % m.monitor_period_ms != 0:
            return
        C = len(self.clusters)
        # buyers
        contracts: dict[int, tuple[OContract, bool]] = {}
        for b, cl in enumerate(self.clusters):
            if cl.cooldown_until > self.t:
                continue
            if cl.snap_avg_wait > m.request_max_wait_ms:
                contracts[b] = (self._fast_contract(cl), True)
            elif (cl.snap_core_util > m.request_core_max
                  or cl.snap_mem_util > m.request_mem_max):
                contracts[b] = (self._small_contract(cl), False)
        # sellers: process lowest-index buyer; lock; approve; carve plan
        approves: dict[int, int] = {}  # seller -> buyer
        plans: dict[int, tuple[list, bool]] = {}
        for s, cl in enumerate(self.clusters):
            reqs = [b for b in sorted(contracts) if b != s]
            if not reqs:
                continue
            if cl.seller_locked_until > self.t:
                continue  # refuses everyone, no lock change
            b = reqs[0]
            cl.seller_locked_until = self.t + m.contract_ttl_ms
            con = contracts[b][0]
            if self._approve(cl, con):
                approves[s] = b
                plans[s] = self._carve_plan(cl, con)
        # match + apply
        for b in sorted(contracts):
            con, _ = contracts[b]
            cands = sorted(s for s, bb in approves.items() if bb == b)
            winner = None
            for s in cands:
                self.clusters[s].seller_locked_until = 0  # attempted -> reset
                if plans[s][1]:
                    winner = s
                    break
            bcl = self.clusters[b]
            if winner is None:
                bcl.cooldown_until = self.t + m.cooldown_failure_ms
                continue
            # seller carve: occupy amounts as Foreign placeholder jobs
            scl = self.clusters[winner]
            for n, (oc, om) in enumerate(plans[winner][0]):
                if oc > 0 or om > 0:
                    scl.free[n][0] -= oc
                    scl.free[n][1] -= om
                    scl.running.append(ORunning(
                        end_t=self.t + con.time_ms, node=n,
                        job=OJob(id=-3, cores=oc, mem=om, dur=con.time_ms,
                                 enq_t=self.t, owner=-2)))
            # buyer: AddVirtualNode at the first free virtual slot
            vstart = self.cfg.max_nodes
            slot = next((i for i in range(vstart, len(bcl.cap))
                         if not bcl.active[i]), None)
            if slot is not None:
                bcl.cap[slot] = [con.cores, con.mem]
                bcl.free[slot] = [con.cores, con.mem]
                bcl.active[slot] = True
                bcl.expire[slot] = (self.t + con.time_ms
                                    if m.expire_virtual_nodes else NEVER)
            bcl.cooldown_until = self.t + m.cooldown_success_ms
            bcl.spent = _f32(bcl.spent + con.price)

    # -- driver --
    def tick(self):
        self.t += self.cfg.tick_ms
        self._releases()
        if self.cfg.trader.enabled and self.cfg.trader.expire_virtual_nodes:
            self._expire_vnodes()
        self._arrivals()
        requests: dict[int, OJob] = {}
        for c in range(len(self.clusters)):
            if self.cfg.policy == PolicyKind.DELAY:
                self._delay_pass(c)
            elif self.cfg.policy == PolicyKind.FFD:
                self._ffd_pass(c)
            else:
                req = self._fifo_pass(c)
                if req is not None:
                    requests[c] = req
        if self.cfg.borrowing and requests:
            self._borrow_match(requests)
        if self.cfg.trader.enabled:
            self._snapshot()
            self._trade_round()

    def run(self, n_ticks: int):
        for _ in range(n_ticks):
            self.tick()
        return self

    # -- stats accessors (for cross-checks beyond the trace) --
    def avg_wait(self, c: int) -> float:
        cl = self.clusters[c]
        return cl.wait_total / cl.wait_jobs if cl.wait_jobs else 0.0
