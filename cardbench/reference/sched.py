"""Plain reference of the FIFO and FFD worlds: one cluster at a time, in
Python and NumPy on the host.

It imports nothing of the program. From a cluster's arrival stream (the
benchmark's own ``gen/traces.py``), its node capacities and the
configuration's sizes, it buckets the arrivals by tick, keeps the
cluster's queues, running set, nodes and counters itself, and replays
every tick of the horizon:

1. release: every running job whose end time is at or before the tick's
   clock returns its cores and memory to its node and leaves its slot;
2. ingest: the tick's arrivals, in stream order, are appended to the
   policy's queue (FIFO: the ReadyQueue; FFD: Level0) as far as its
   capacity allows, the rest counted as queue drops;
3. the policy's pass:

   - FIFO (the Go scheduler's ``Fifo()``): when the WaitQueue is empty,
     place ReadyQueue jobs from the head, each on its first node with room,
     until one fails; that one moves to the WaitQueue. Then one attempt for
     the WaitQueue's head. No job waits in accounting (``wait_total``
     stays 0 under FIFO);
   - FFD (first-fit-decreasing over Level0, fast mode): take the first
     ``min(|Level0|, max_placements_per_tick)`` jobs in decreasing
     (cores, then memory) order, ties by queue position; add each one's
     wait since its last record to ``wait_total`` (one integer sum per
     tick, rounded to float32 once, as the configuration's ``ffd_sweep``
     "wave" states), then place each in that order on its first node with
     room while a running slot is free.

   A placement takes the lowest free running slot; a job that has a node
   but no free slot counts as ``run_full``.

Clusters do not interact in these worlds, so any sample of whole clusters
replays alone. ``replay_cluster`` returns the cluster's final state in the
layout the program exposes (queue rows and running rows of ten int32
fields, invalid rows past each queue's count and in free slots), so the
comparison can read both sides leaf by leaf.

``wait_bits`` and ``time_bits`` give the control: the same replay with
``wait_total`` held in bfloat16 (16) or its time columns (the clock,
enqueue, end and recorded-wait times) held in int16 (16), the precision
below the float32 and int32 the configuration states.
"""

from __future__ import annotations

import heapq

import numpy as np

QUEUE_FIELDS = ("id", "cores", "mem", "gpu", "dur", "enq_t", "owner",
                "rec_wait", "jclass", "retries")
QUEUE_INVALID = (-1, 0, 0, 0, 0, 0, -1, 0, 0, 0)
RUN_FIELDS = ("end_t", "node", "cores", "mem", "gpu", "id", "owner", "dur",
              "enq_t", "retries")
RUN_INVALID = (2**31 - 1, 0, 0, 0, 0, -1, -1, 0, 0, 0)
DROP_KINDS = ("queue", "msgs", "run_full", "vslot", "carve", "ingest",
              "failed")
QUEUES = ("l0", "l1", "ready", "wait", "lent", "borrowed")

_ID, _CORES, _MEM, _GPU, _DUR, _ENQ, _OWNER, _REC = range(8)


def _bf16(x: float) -> np.float32:
    """``x`` rounded to bfloat16 (nearest, ties to even), as a float32."""
    u = np.array([x], np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)[0]


def _wrap(bits: int):
    if bits >= 32:
        return lambda x: x
    half, full = 1 << (bits - 1), 1 << bits
    return lambda x: ((x + half) % full) - half


def bucket(t: np.ndarray, n_valid: int, n_ticks: int, tick_ms: int):
    """Each arrival's tick: the first tick ``k`` whose clock
    ``(k + 1) * tick_ms`` is at or after its time; arrivals past the
    horizon are never ingested. Returns the stream positions of each
    tick's arrivals, in stream order, as one list per tick."""
    t = np.asarray(t[:n_valid], np.int64)
    dest = np.maximum((t + tick_ms - 1) // tick_ms, 1) - 1
    per_tick = [[] for _ in range(n_ticks)]
    for a, d in enumerate(dest.tolist()):
        if d < n_ticks:
            per_tick[d].append(a)
    return per_tick


class _Cluster:
    """One cluster's state in the reference's own form."""

    def __init__(self, world: dict, wait_bits: int, time_bits: int):
        self.w = world
        self.free = [list(c) for c in world["node_cap"]]
        self.S = world["max_running"]
        self.slots = [None] * self.S
        self.free_slots = list(range(self.S))  # a heap
        self.ends = []  # a heap of (end_t, slot)
        self.n_active = 0
        self.queues = {q: [] for q in QUEUES}
        self.placed = 0
        self.drops = dict.fromkeys(DROP_KINDS, 0)
        self.arr_ptr = 0
        self.wait_jobs = 0
        self.jobs_in_queue = 0
        self.wait_bits = wait_bits
        self.wait_total = np.float32(0)
        self.time = _wrap(time_bits)

    # -- shared steps ---------------------------------------------------
    def first_fit(self, job) -> int:
        if job[_GPU] > 0:  # no gpu axis in these worlds: fails closed
            return -1
        for i, (c, m) in enumerate(self.free):
            if c >= job[_CORES] and m >= job[_MEM]:
                return i
        return -1

    def start(self, job, node: int, t: int) -> None:
        self.free[node][0] -= job[_CORES]
        self.free[node][1] -= job[_MEM]
        slot = heapq.heappop(self.free_slots)
        end = self.time(job[_DUR] + t)
        self.slots[slot] = (end, node, job[_CORES], job[_MEM], job[_GPU],
                            job[_ID], job[_OWNER], job[_DUR], job[_ENQ],
                            job[9])
        heapq.heappush(self.ends, (end, slot))
        self.n_active += 1
        self.placed += 1

    def release(self, t: int) -> None:
        while self.ends and self.ends[0][0] <= t:
            _, slot = heapq.heappop(self.ends)
            row = self.slots[slot]
            self.free[row[1]][0] += row[2]
            self.free[row[1]][1] += row[3]
            self.slots[slot] = None
            heapq.heappush(self.free_slots, slot)
            self.n_active -= 1

    def ingest(self, rows: list, to_l0: bool) -> None:
        q = self.queues["l0" if to_l0 else "ready"]
        room = self.w["queue_capacity"] - len(q)
        q.extend(rows[:max(room, 0)])
        self.drops["queue"] += max(len(rows) - room, 0)
        if to_l0:
            self.wait_jobs += len(rows)
            self.jobs_in_queue += len(rows)
        self.arr_ptr += len(rows)

    # -- the policies -----------------------------------------------------
    def fifo(self, t: int) -> None:
        ready, wait = self.queues["ready"], self.queues["wait"]
        if self.w["parity"]:
            qc = self.w["queue_capacity"]
        else:
            qc = min(self.w["queue_capacity"],
                     self.w["max_placements_per_tick"])
        if not wait:
            taken, failed = 0, None
            for job in ready[:qc]:
                taken += 1
                node = self.first_fit(job)
                if node >= 0 and self.n_active < self.S:
                    self.start(job, node, t)
                    continue
                if node >= 0:
                    self.drops["run_full"] += 1
                failed = job
                break
            del ready[:taken]
            if failed is not None:
                if len(wait) < self.w["queue_capacity"]:
                    wait.append(failed)
                else:
                    self.drops["queue"] += 1
        if wait:
            node = self.first_fit(wait[0])
            if node >= 0 and self.n_active < self.S:
                self.start(wait.pop(0), node, t)
            elif node >= 0:
                self.drops["run_full"] += 1

    def ffd(self, t: int) -> None:
        l0 = self.queues["l0"]
        if not l0:
            return
        n = min(len(l0), self.w["queue_capacity"],
                self.w["max_placements_per_tick"])
        cores = np.fromiter((j[_CORES] for j in l0), np.int64, len(l0))
        mem = np.fromiter((j[_MEM] for j in l0), np.int64, len(l0))
        order = np.lexsort((-mem, -cores))[:n].tolist()  # stable
        delta = 0
        for i in order:
            job = l0[i]
            cur = self.time(t - job[_ENQ])
            delta += cur - job[_REC]
            job[_REC] = cur
        if self.wait_bits >= 32:
            self.wait_total = np.float32(self.wait_total + np.float32(delta))
        else:
            self.wait_total = _bf16(self.wait_total + _bf16(delta))
        placed = set()
        for i in order:
            node = self.first_fit(l0[i])
            if node >= 0 and self.n_active < self.S:
                self.start(l0[i], node, t)
                placed.add(i)
            elif node >= 0:
                self.drops["run_full"] += 1
        if placed:
            l0[:] = [j for i, j in enumerate(l0) if i not in placed]
            self.jobs_in_queue -= len(placed)

    # -- the layout the program exposes ------------------------------------
    def leaves(self) -> dict:
        out = {}
        n_res = self.w["n_res"]
        out["node_free"] = np.array([f[:n_res] for f in self.free], np.int64)
        data = np.array([RUN_INVALID] * self.S, np.int64)
        active = np.zeros(self.S, bool)
        for s, row in enumerate(self.slots):
            if row is not None:
                data[s] = row
                active[s] = True
        out["run.data"], out["run.active"] = data, active
        cap = self.w["queue_capacity"]
        for name, q in self.queues.items():
            qd = np.array([QUEUE_INVALID] * cap, np.int64)
            if q:
                qd[:len(q)] = np.array(q, np.int64)
            out[f"{name}.data"] = qd
            out[f"{name}.count"] = np.int64(len(q))
        for k in DROP_KINDS:
            out[f"drops.{k}"] = np.int64(self.drops[k])
        out["placed_total"] = np.int64(self.placed)
        out["arr_ptr"] = np.int64(self.arr_ptr)
        out["wait_jobs"] = np.int64(self.wait_jobs)
        out["jobs_in_queue"] = np.int64(self.jobs_in_queue)
        out["wait_total"] = np.float64(self.wait_total)
        return out


def replay_cluster(world: dict, stream: dict, *, wait_bits: int = 32,
                   time_bits: int = 32) -> dict:
    """Replay one cluster over ``world["n_ticks"]`` ticks and return its
    final state as ``{leaf name: numpy array}`` in the program's layout.

    ``world``: ``policy`` ("FIFO" or "FFD"), ``parity``, ``queue_capacity``,
    ``max_running``, ``max_placements_per_tick``, ``tick_ms``, ``n_ticks``,
    ``n_res`` and ``node_cap``, a list of [cores, mem] per node slot.
    ``stream``: this cluster's ``t``, ``id``, ``cores``, ``mem``, ``gpu``,
    ``dur`` arrays and ``n``, its valid length."""
    c = _Cluster(world, wait_bits, time_bits)
    tick_ms, n_ticks = world["tick_ms"], world["n_ticks"]
    to_l0 = world["policy"] == "FFD"
    n = int(stream["n"])
    cols = [np.asarray(stream[k][:n], np.int64) for k in
            ("id", "cores", "mem", "gpu", "dur", "t")]
    ids, cores, mem, gpu, dur, t_arr = (x.tolist() for x in cols)
    per_tick = bucket(stream["t"], n, n_ticks, tick_ms)
    for k in range(n_ticks):
        t = c.time((k + 1) * tick_ms)
        c.release(t)
        rows = [[ids[a], cores[a], mem[a], gpu[a], dur[a], c.time(t_arr[a]),
                 -1, 0, (gpu[a] > 0) * 2 + (cores[a] > 8), 0]
                for a in per_tick[k]]
        c.ingest(rows, to_l0)
        if to_l0:
            c.ffd(t)
        else:
            c.fifo(t)
    out = c.leaves()
    out["t"] = np.int64(c.time(n_ticks * tick_ms))
    return out
