"""Borg-2019 public-trace ingestion, BASELINE config 5's replay half (the
port's copy of ``multi_cluster_simulator_tpu/workload/borg.py``, on the
port's ``Arrivals``; host numpy, pinned equal to the original by
tests/test_torch_borg.py).

Google's clusterdata-2019 release ships per-cell ``instance_events`` tables
(gzipped JSON lines; also re-exported as CSV) whose schema subset relevant
to this simulator is:

  time                       int64 microseconds since trace start
  type                       event enum — int or string: SUBMIT(0), QUEUE(1),
                             ENABLE(2), SCHEDULE(3), EVICT(4), FAIL(5),
                             FINISH(6), KILL(7), LOST(8)
  collection_id              int64 job/collection
  instance_index             int32 task index within the collection
  resource_request.cpus      float, normalized to [0, 1] of the largest machine
  resource_request.memory    float, normalized likewise

A job for the simulator is one instance's lifecycle: submit time = its first
SUBMIT/QUEUE event, duration = first terminal event (FINISH/EVICT/KILL/FAIL/
LOST) minus first SCHEDULE, sizes from the resource request. That matches the
reference's Job {CoresNeeded, MemoryNeeded, Duration} (pkg/scheduler/
scheduler.go:65-73) with the wall-clock submit becoming the virtual arrival.

Two on-disk layouts are accepted (gzip transparently):

1. raw ``instance_events`` JSONL or CSV — joined here (``load_instance_events``);
2. a pre-joined jobs CSV ``submit_time_us,cpus,memory,duration_us``
   (``load_jobs_csv``).

``tools/make_borg_sample.py`` generates ``assets/borg2019_sample.jsonl.gz``
in the exact raw schema with synthetic values, from a fixed seed, so the
whole parse-join-replay path runs without the real trace; nothing is
downloaded.
"""

from __future__ import annotations

import csv
import gzip
import io
import json
from dataclasses import dataclass

import numpy as np

from multi_cluster_simulator_tpu_torch.core.state import Arrivals
from multi_cluster_simulator_tpu_torch.workload.traces import from_arrays

# event-type enum of the 2019 schema; both numeric and name forms appear in
# public re-exports
_TYPES = {"SUBMIT": 0, "QUEUE": 1, "ENABLE": 2, "SCHEDULE": 3, "EVICT": 4,
          "FAIL": 5, "FINISH": 6, "KILL": 7, "LOST": 8,
          "UPDATE_PENDING": 9, "UPDATE_RUNNING": 10}
_SUBMIT_LIKE = {0, 1}
_SCHEDULE = 3
_TERMINAL = {4, 5, 6, 7, 8}


@dataclass
class BorgJobs:
    """Joined per-instance jobs, times in microseconds, sizes normalized."""

    t_us: np.ndarray  # submit time
    cpus: np.ndarray  # [0, 1] normalized
    mem: np.ndarray  # [0, 1] normalized
    dur_us: np.ndarray
    n_events: int  # raw rows consumed (0 for pre-joined input)

    def __len__(self) -> int:
        return len(self.t_us)


def _open(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def _etype(v) -> int:
    if isinstance(v, str) and not v.lstrip("-").isdigit():
        return _TYPES[v.strip().upper()]
    return int(v)


def load_instance_events(path: str) -> BorgJobs:
    """Join raw instance_events rows into jobs.

    JSONL rows may nest the request (``{"resource_request": {"cpus": ...}}``)
    or flatten it (``resource_request.cpus`` column in CSV exports). Instances
    without a complete SUBMIT->SCHEDULE->terminal lifecycle are skipped, as
    are non-positive durations (clock repair in the public data can reorder
    events)."""
    # key -> [submit_t, sched_t, end_t, cpus, mem]
    insts: dict[tuple[int, int], list] = {}
    n = 0
    with _open(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == "{":
            rows = (json.loads(line) for line in f if line.strip())
            for r in rows:
                n += 1
                req = r.get("resource_request") or {}
                _ingest_event(insts, r["time"], r["type"],
                              r["collection_id"], r.get("instance_index", 0),
                              req.get("cpus", r.get("resource_request.cpus")),
                              req.get("memory", r.get("resource_request.memory")))
        else:
            for r in csv.DictReader(f):
                n += 1
                _ingest_event(insts, r["time"], r["type"],
                              r["collection_id"], r.get("instance_index", 0),
                              r.get("resource_request.cpus") or r.get("cpus"),
                              r.get("resource_request.memory") or r.get("memory"))
    t, c, m, d = [], [], [], []
    for sub, sched, end, cpus, mem in insts.values():
        if sub is None or sched is None or end is None or cpus is None:
            continue
        if end <= sched:
            continue
        t.append(sub)
        c.append(cpus)
        m.append(mem if mem is not None else 0.0)
        d.append(end - sched)
    order = np.argsort(np.asarray(t, np.int64), kind="stable")
    return BorgJobs(t_us=np.asarray(t, np.int64)[order],
                    cpus=np.asarray(c, np.float64)[order],
                    mem=np.asarray(m, np.float64)[order],
                    dur_us=np.asarray(d, np.int64)[order], n_events=n)


def _ingest_event(insts, time, etype, coll, idx, cpus, mem):
    k = (int(coll), int(idx))
    rec = insts.setdefault(k, [None, None, None, None, None])
    ty = _etype(etype)
    time = int(time)
    if ty in _SUBMIT_LIKE:
        if rec[0] is None:
            rec[0] = time
        # CSV exports carry '' for absent resource fields — same as missing
        if cpus not in (None, "") and rec[3] is None:
            rec[3] = float(cpus)
            rec[4] = float(mem) if mem not in (None, "") else None
    elif ty == _SCHEDULE:
        if rec[1] is None:
            rec[1] = time
    elif ty in _TERMINAL:
        if rec[2] is None:
            rec[2] = time


def load_jobs_csv(path: str) -> BorgJobs:
    """Pre-joined subset: submit_time_us,cpus,memory,duration_us."""
    t, c, m, d = [], [], [], []
    with _open(path) as f:
        for r in csv.DictReader(f):
            t.append(int(r["submit_time_us"]))
            c.append(float(r["cpus"]))
            m.append(float(r["memory"]))
            d.append(int(r["duration_us"]))
    order = np.argsort(np.asarray(t, np.int64), kind="stable")
    return BorgJobs(t_us=np.asarray(t, np.int64)[order],
                    cpus=np.asarray(c, np.float64)[order],
                    mem=np.asarray(m, np.float64)[order],
                    dur_us=np.asarray(d, np.int64)[order], n_events=0)


def load_borg(path: str) -> BorgJobs:
    """Format sniff: pre-joined CSV if the header names submit_time_us,
    otherwise raw instance_events (JSONL or CSV)."""
    with _open(path) as f:
        head = f.readline()
    if "submit_time_us" in head:
        return load_jobs_csv(path)
    return load_instance_events(path)


def to_arrivals(jobs: BorgJobs, n_clusters: int, jobs_per_cluster: int,
                max_cores: int, max_mem: int,
                time_scale: float = 1.0) -> tuple[Arrivals, dict]:
    """Shard joined jobs over the cluster axis as an Arrivals batch.

    Jobs are dealt round-robin in submit order — deterministic, balanced,
    and time-ordered within each cluster (the [C, A] layout needs a fixed
    per-cluster count; imbalance would silently truncate hot clusters).
    Normalized sizes scale to the node dimensions (>=1 so every request is
    real); times rebase to 0 and convert us -> ms, divided by ``time_scale``
    (replaying a month-long cell trace at natural speed would need ~2.6M
    ticks — scale compresses arrivals and durations together, preserving
    relative load). Returns (arrivals, meta); meta reports how many rows
    were used vs available so truncation is never silent."""
    need = n_clusters * jobs_per_cluster
    use = min(len(jobs), need)
    t0 = int(jobs.t_us[0]) if use else 0
    t_ms = ((jobs.t_us[:use] - t0) / 1000.0 / time_scale).astype(np.int64)
    dur_ms = np.maximum(jobs.dur_us[:use] / 1000.0 / time_scale, 1.0).astype(np.int64)
    cores = np.clip(np.round(jobs.cpus[:use] * max_cores), 1, max_cores)
    mem = np.clip(np.round(jobs.mem[:use] * max_mem), 1, max_mem)

    C, A = n_clusters, jobs_per_cluster
    PAD_T = 2**31 - 1  # pad slots sort after every real arrival

    def deal(x, pad):
        out = np.full((C, A), pad, np.int64)
        k = np.arange(use)
        out[k % C, k // C] = x[:use]
        return out

    counts = np.bincount(np.arange(use) % C, minlength=C).astype(np.int32)
    arr = from_arrays(deal(t_ms, PAD_T), deal(cores, 0), deal(mem, 0),
                      deal(dur_ms, 1))
    arr = arr.replace(n=counts)  # valid prefix per cluster (pads sort last)
    meta = {"rows_available": len(jobs), "rows_used": use,
            "raw_events": jobs.n_events, "time_scale": time_scale,
            "span_ms": int(t_ms[-1]) if use else 0,
            "max_dur_ms": int(dur_ms.max()) if use else 0}
    return arr, meta
