"""Chaos harness for the crash and preemption contracts, serving and batch
(the port of ``tools/chaos.py``, which imports jax and ``bench``).

- default (serving): kill -9 a live ``ServingScheduler`` child under real
  HTTP traffic at randomized points, restart it (checkpoint restore plus
  the WAL suffix, services/serving.py ``_recover``), and after ``cycles``
  rounds assert the reference's durability story: every 200-acked job is
  in the fsync'd WAL and placed (``placed == WAL records``), the
  recovered checkpoint is bitwise an uninterrupted in-process reference
  fed the WAL tick by tick, and no drop counter moved.
- ``--batch`` (the preemption plane, core/preempt.py): kill -9 a resumable
  batch child (``--batch-child``: ``churn_bursts_setup(quick=True)``,
  compact state, event-compressed time and trace-mode churn, checkpointing
  through ``AsyncCheckpointer`` at every 100-tick chunk boundary) at
  randomized chunk boundaries, resume each time, and assert the final
  checkpoint bitwise the uninterrupted child's and the ``ticks_executed``
  cursor telescoping to the same total. One cycle uses SIGTERM: the child
  must save at the next boundary and exit 75 under ``PreemptionGuard``.
  The reference's 2- and 8-device cells run the child over a mesh of 2 or
  8 ranks (``--ranks N``: rank processes sharing the card,
  ``parallel.launch``), each holding a shard of the cluster axis; the
  child gathers the shards at every boundary into the one-process
  checkpoint file, and a resume re-shards it.

Every child gets ``--device``: the card by default, or what the caller
asks (the reference pins its children to the CPU; the port runs them
where the caller says).

Usage:
  python -m multi_cluster_simulator_tpu_torch.tools.chaos [--quick]
      [--cycles N] [--jobs N] [--out PATH] [--device D]
  python -m multi_cluster_simulator_tpu_torch.tools.chaos --batch
      [--quick] [--cycles N] [--out PATH] [--device D]
  ... --serve --dir D --url-file F --device D          (child mode)
  ... --batch-child --checkpoint PATH [--resume] --device D [--ranks N]
                                                              (child mode)
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SPEED = 100.0
WINDOW = 4
N_CLUSTERS = 4
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "multi_cluster_simulator_tpu_torch.tools.chaos"


def chaos_cfg():
    """The one config both the child server and the in-process reference
    build — the bit-identity gate depends on them agreeing."""
    from multi_cluster_simulator_tpu_torch.config import PolicyKind, SimConfig
    return SimConfig(policy=PolicyKind.FIFO, parity=True, n_res=2,
                     queue_capacity=256, max_running=512, max_arrivals=64,
                     max_ingest_per_tick=16, max_nodes=10,
                     max_virtual_nodes=0)


def chaos_specs():
    from multi_cluster_simulator_tpu_torch.core.spec import uniform_cluster
    return [uniform_cluster(c + 1, 10) for c in range(N_CLUSTERS)]


def serve_kwargs(dirpath: str, device) -> dict:
    """The child server's settings (the reference's), WAL and checkpoints
    armed in ``dirpath``."""
    return dict(speed=SPEED, window=WINDOW, pacer=True, warm_k=(16, 64),
                k_cap=64, max_staged=10 ** 6,
                wal_path=os.path.join(dirpath, "serve.wal"),
                checkpoint_path=os.path.join(dirpath, "serve.ckpt"),
                checkpoint_every=4, device=device)


def serve(dirpath: str, url_file: str, device=None) -> None:
    """Child mode: host the serving tier with WAL + checkpoints armed and
    publish the URL, then sleep until killed (the parent kills -9, never
    politely)."""
    from multi_cluster_simulator_tpu_torch.services.serving import (
        ServingScheduler,
    )

    s = ServingScheduler("chaos-serve", chaos_specs(), chaos_cfg(),
                         **serve_kwargs(dirpath, device))
    s.start()
    tmp = url_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(s.url)
    os.replace(tmp, url_file)
    while True:  # until SIGKILL
        time.sleep(0.5)


class _Client(threading.Thread):
    """One traffic generator: /submitBatch with retry discipline across
    503 back-pressure AND dead-server windows. Records every job id the
    server ACKED (a 200, or the accepted complement of a 503's
    RejectedIdx) — the zero-loss gate's ground truth. Paced and
    duration-driven: it submits until the parent's ``traffic_done`` event
    (set only after the last kill/restart cycle) or the job cap."""

    def __init__(self, ci, n_jobs, batch, url_file, stop_flag,
                 traffic_done):
        super().__init__(daemon=True, name=f"chaos-client-{ci}")
        self.ci = ci
        self.n_jobs = n_jobs
        self.batch = batch
        self.url_file = url_file
        self.stop_flag = stop_flag
        self.traffic_done = traffic_done
        self.rng = np.random.default_rng(4000 + ci)
        self.acked: list[tuple[int, int]] = []  # (cluster, id)
        self.conn_retries = 0
        self.retries_503 = 0
        self.error = None

    def _url(self):
        try:
            with open(self.url_file) as f:
                return f.read().strip()
        except OSError:
            return None

    def run(self):
        try:
            self._run()
        except Exception as e:  # surfaced by the parent's join
            self.error = e

    def _run(self):
        from multi_cluster_simulator_tpu_torch.services import httpd
        from multi_cluster_simulator_tpu_torch.services.backoff import (
            jittered_backoff_ms,
        )
        from multi_cluster_simulator_tpu_torch.services.scheduler_host import (
            job_to_json,
        )
        sent = 0
        jid = self.ci * 10_000_000
        while (sent < self.n_jobs and not self.stop_flag.is_set()
               and not self.traffic_done.is_set()):
            time.sleep(float(self.rng.uniform(0.02, 0.08)))  # pacing
            rows = []
            meta = []
            for _ in range(min(self.batch, self.n_jobs - sent)):
                jid += 1
                c = int(self.rng.integers(0, N_CLUSTERS))
                rows.append({**job_to_json(
                    jid, int(self.rng.integers(1, 4)),
                    int(self.rng.integers(100, 2000)),
                    int(self.rng.integers(500, 2001))), "Cluster": c})
                meta.append((c, jid))
            sent += len(rows)
            attempt = 0
            while rows:
                if self.stop_flag.is_set():
                    return
                url = self._url()
                code, body = (0, b"") if url is None else httpd.post_json(
                    url + "/submitBatch", rows, timeout=5.0)
                if code == 200:
                    self.acked.extend(meta)
                    break
                if code == 503:
                    e = json.loads(body)
                    rej = set(e["RejectedIdx"])
                    self.acked.extend(m for k, m in enumerate(meta)
                                      if k not in rej)
                    rows = [rows[k] for k in sorted(rej)]
                    meta = [meta[k] for k in sorted(rej)]
                    self.retries_503 += 1
                    base = max(float(e.get("RetryAfterMs", 20.0)), 5.0)
                else:
                    # dead / restarting server: nothing acked this round
                    # (a lost ack after a successful stage just means a
                    # duplicate WAL record on retry — legal)
                    self.conn_retries += 1
                    base = 50.0
                attempt += 1
                if attempt > 400:
                    raise AssertionError(
                        f"client {self.ci}: retry budget exhausted "
                        f"({len(rows)} jobs undelivered)")
                time.sleep(jittered_backoff_ms(
                    min(attempt, 6), base, 2_000.0, self.rng) / 1000.0)


def _device_arg(device) -> str:
    from multi_cluster_simulator_tpu_torch.core.state import resolve_device
    return str(resolve_device(device))


def diverged_leaves(want: dict, got: dict) -> list:
    """Key paths where two host leaf dicts differ (every leaf, bitwise)."""
    return [k for k in want
            if k not in got or not np.array_equal(want[k], got[k])]


def run_chaos(cycles: int, jobs: int, out: str | None, workdir: str | None,
              keep: bool = False, device=None, ref_devices=None) -> dict:
    """The serving chaos gate; returns the reference's report. The child
    serves on ``device`` (the card by default); the recovered state is
    held against an in-process reference on each of ``ref_devices`` (by
    default the child's device; on the CPU the reference is the plain
    version)."""
    from multi_cluster_simulator_tpu_torch import interop
    from multi_cluster_simulator_tpu_torch.core.checkpoint import load_state
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.services import httpd
    from multi_cluster_simulator_tpu_torch.services import wal as walmod
    from multi_cluster_simulator_tpu_torch.services.serving import (
        ServingScheduler,
    )
    from multi_cluster_simulator_tpu_torch.utils.trace import total_drops

    dev = _device_arg(device)
    dirpath = workdir or tempfile.mkdtemp(prefix="mcs-chaos-")
    url_file = os.path.join(dirpath, "serve.url")
    wal_path = os.path.join(dirpath, "serve.wal")
    ckpt_path = os.path.join(dirpath, "serve.ckpt")
    rng = np.random.default_rng(99)
    child = {"proc": None}

    def spawn():
        if os.path.exists(url_file):
            os.remove(url_file)
        child["proc"] = subprocess.Popen(
            [sys.executable, "-m", MODULE, "--serve", "--dir", dirpath,
             "--url-file", url_file, "--device", dev],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        deadline = time.time() + 120
        while time.time() < deadline:
            if child["proc"].poll() is not None:
                err = child["proc"].stderr.read().decode()[-4000:]
                raise RuntimeError(f"chaos child died at startup:\n{err}")
            if os.path.exists(url_file):
                with open(url_file) as f:
                    url = f.read().strip()
                code, _ = httpd.get(url + "/healthz", timeout=2.0)
                if code == 200:
                    return url
            time.sleep(0.05)
        raise RuntimeError("chaos child never became healthy")

    def stats(url):
        code, body = httpd.get(url + "/stats", timeout=5.0)
        return json.loads(body) if code == 200 else None

    t_start = time.time()
    stop_flag = threading.Event()
    traffic_done = threading.Event()
    clients = []
    kills = 0
    live_kills = 0
    try:
        url = spawn()
        clients = [_Client(ci, jobs // 2, 32, url_file, stop_flag,
                           traffic_done) for ci in range(2)]
        for c in clients:
            c.start()
        # the chaos loop: kill -9 mid-traffic, restart, repeat;
        # traffic_done is set only after the last cycle, so every kill
        # lands under live traffic (asserted below)
        for _cycle in range(cycles):
            time.sleep(float(rng.uniform(0.5, 1.5)))
            live_kills += int(any(c.is_alive() for c in clients))
            child["proc"].send_signal(signal.SIGKILL)
            child["proc"].wait()
            kills += 1
            time.sleep(float(rng.uniform(0.05, 0.3)))  # clients see it die
            url = spawn()
        time.sleep(0.5)  # a last live window against the final incarnation
        traffic_done.set()
        assert live_kills == kills, (
            f"only {live_kills}/{kills} kills landed under live traffic — "
            "the clients drained early; raise --jobs or the pacing")
        # traffic completes against the final incarnation
        deadline = time.time() + 600
        for c in clients:
            c.join(timeout=max(deadline - time.time(), 1))
            if c.is_alive():
                raise RuntimeError(f"client {c.ci} never finished")
            if c.error is not None:
                raise c.error
        # drain: the pacer keeps sealing empty ticks; wait until the
        # constellation is empty and placement has converged. /stats
        # answers off the snapshot of the last dispatch, so only a
        # snapshot taken after the last ack counts: an older one can show
        # nothing staged while the last batch sits in the open tick, which
        # quiesce does not dispatch (the reference's loop takes any)
        joined = time.time()
        while time.time() < deadline:
            asked = time.time()
            st = stats(url)
            if (st is not None
                    and st["snapshot_age_ms"] < (asked - joined) * 1e3
                    and st["staged_jobs"] == 0
                    and st["queue_depth"] == 0 and st["running"] == 0):
                break
            time.sleep(0.1)
        else:
            raise RuntimeError(f"drain never converged: {stats(url)}")
        code, body = httpd.post_json(url + "/admin/quiesce", {},
                                     timeout=120.0)
        assert code == 200, f"quiesce -> {code}: {body!r}"
        q = json.loads(body)
    finally:
        stop_flag.set()
        if child["proc"] is not None and child["proc"].poll() is None:
            child["proc"].send_signal(signal.SIGKILL)
            child["proc"].wait()
        if child["proc"] is not None and child["proc"].stderr:
            child["proc"].stderr.close()

    # ---- verification ----
    records, _offs, _off, torn = walmod.read_records(wal_path)
    acked = {m for c in clients for m in c.acked}
    wal_ids = {(r["c"], r["i"]) for r in records}
    missing = acked - wal_ids
    assert not missing, (
        f"ACKED JOBS LOST: {len(missing)} jobs were 200-acked but never "
        f"reached the WAL (first: {sorted(missing)[:5]}) — the fsync-"
        "before-ack contract is broken")
    assert q["placed"] == len(records), (
        f"placed_total {q['placed']} != WAL job count {len(records)} — "
        "acked work was lost or duplicated inside the engine")

    # uninterrupted reference over the same effective stream: replay the
    # WAL tick-faithfully into a fresh in-process server, seal to the
    # crashed run's tick count, dispatch everything
    cfg = chaos_cfg()
    rec_state = load_state(ckpt_path, init_state(cfg, chaos_specs(),
                                                 device=dev), cfg=cfg)
    rec_host = interop.to_numpy(rec_state)
    refs = [dev] if ref_devices is None else [_device_arg(d)
                                              for d in ref_devices]
    checked = [("recovered", rec_state)]
    for rdev in refs:
        ref = ServingScheduler("chaos-ref", chaos_specs(), cfg, pacer=False,
                               window=WINDOW, warm_k=(16, 64), k_cap=64,
                               max_staged=10 ** 6, device=rdev)
        ref_host = replay_wal(ref, records, q["ticks_dispatched"])
        diverged = diverged_leaves(ref_host, rec_host)
        assert not diverged, (
            f"RECOVERED STATE DIVERGED from the uninterrupted reference on "
            f"{rdev} on {len(diverged)} leaves: {diverged[:6]} — crash "
            "recovery is not replay-invisible")
        checked.append((f"reference on {rdev}", ref._state))
    for label, state in checked:
        drops = total_drops(state)
        assert all(v == 0 for v in drops.values()), (
            f"{label} state dropped work: {drops}")

    dup = len(records) - len(wal_ids)
    report = {
        "cycles": kills,
        "kills_under_live_traffic": live_kills,
        "jobs_acked": len(acked),
        "wal_records": len(records),
        "duplicate_resubmits": dup,
        "wal_torn_tail_seen": torn,
        "placed_total": q["placed"],
        "ticks_dispatched": q["ticks_dispatched"],
        "recovered_jobs_last_restart": q.get("recovered_jobs", 0),
        "client_conn_retries": sum(c.conn_retries for c in clients),
        "client_retries_503": sum(c.retries_503 for c in clients),
        "acked_jobs_lost": 0,
        "final_state_bit_identical": True,
        "device": dev,
        "reference_devices": refs,
        "wall_s": round(time.time() - t_start, 1),
        "workdir": dirpath if keep else None,
    }
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=2)
    if not keep and workdir is None:
        import shutil
        shutil.rmtree(dirpath, ignore_errors=True)
    return report


def replay_wal(ref, records: list, ticks: int) -> dict:
    """Feed WAL ``records`` tick-faithfully into the deterministic front
    door ``ref`` (pacer off), seal to ``ticks``, dispatch everything, and
    return its host state — the uninterrupted run over the same stream."""
    tick = ref.cfg.tick_ms
    for rec in records:
        dest = max((int(rec["t"]) + tick - 1) // tick, 1) - 1
        while ref._staged_ticks() < dest:
            ref.seal_tick()
        ok = ref.submit_direct(int(rec["c"]), int(rec["i"]), int(rec["co"]),
                               int(rec["m"]), int(rec["du"]),
                               gpu=int(rec["g"]), delay=bool(rec["dl"]),
                               ta=int(rec["t"]))
        assert ok, f"reference replay rejected job {rec['i']}"
    while ref._staged_ticks() < ticks:
        ref.seal_tick()
    ref.dispatch_sealed()
    return ref.state_host()


# --------------------------------------------------------------------------
# --batch: the preemption plane's chaos gate (core/preempt.py)
# --------------------------------------------------------------------------

EXIT_PREEMPTED = 75  # core/preempt.py EXIT_PREEMPTED (sysexits EX_TEMPFAIL)
BATCH_CHUNK = 100  # bench.py bench_sparse_bursts' chunk for churn_bursts


def churn_bursts_setup(quick=False):
    """``bench.py churn_bursts_setup`` as the port's (tests/
    test_torch_chaos.py pins it to its source): the sparse-burst trace with
    trace-mode node churn inside the burst windows — a node fails 5 s into
    each burst and repairs 15 s in. Returns ``(cfg, specs, arrivals,
    n_ticks, fault_events)``."""
    import dataclasses as _dc

    from multi_cluster_simulator_tpu_torch.config import (
        FaultConfig, PolicyKind, SimConfig,
    )
    from multi_cluster_simulator_tpu_torch.core.spec import uniform_cluster
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        bursty_stream,
    )

    C = 64 if quick else 256
    bursts, per_burst = (5, 10) if quick else (12, 24)
    interval_ms, window_ms = 300_000, 20_000
    horizon_ms = bursts * interval_ms
    cfg = SimConfig(policy=PolicyKind.FIFO, queue_capacity=32,
                    max_running=64, max_arrivals=bursts * per_burst,
                    max_ingest_per_tick=16, parity=True, n_res=2,
                    max_nodes=5, max_virtual_nodes=0)
    # retry budget deep enough that no job exhausts it
    cfg = _dc.replace(cfg, faults=FaultConfig(
        enabled=True, mode="trace", max_retries=16, max_events=bursts))
    fault_events = [(c, b % cfg.max_nodes,
                     b * interval_ms + 5_000, b * interval_ms + 15_000)
                    for c in range(0, C, max(C // 8, 1))
                    for b in range(bursts)]
    specs = [uniform_cluster(c + 1, 5) for c in range(C)]
    arrivals = bursty_stream(C, bursts, per_burst, interval_ms, window_ms,
                             max_cores=8, max_mem=6_000, max_dur_ms=60_000,
                             seed=11)
    n_ticks = horizon_ms // cfg.tick_ms + 70  # drain tail
    return cfg, specs, arrivals, n_ticks, fault_events


def batch_world(ticks=None):
    """The batch child's world: ``churn_bursts_setup(quick=True)`` on its
    derived compact plan, cut to ``ticks`` when given. Returns ``(cfg,
    specs, arrivals, n_ticks, fault_events, plan)``."""
    from multi_cluster_simulator_tpu_torch.core.compact import derive_plan

    cfg, specs, arrivals, n_ticks, events = churn_bursts_setup(quick=True)
    if ticks is not None:
        n_ticks = min(n_ticks, int(ticks))
    return cfg, specs, arrivals, n_ticks, events, derive_plan(
        cfg, specs, arrivals)


def _chunk_sizes(left: int) -> list:
    sizes = [BATCH_CHUNK] * (left // BATCH_CHUNK)
    if left % BATCH_CHUNK:
        sizes.append(left % BATCH_CHUNK)
    return sizes


# a mesh rank's run of the batch child: its ShardedEngine, shard and
# chunks, kept between the parent's tasks (one rank a process)
_RANK_RUN: dict = {}


def _batch_rank_start(mesh, path, resume, ticks):
    """A rank's start of the batch run: the world, its shard of the
    initial state (of the checkpoint's state on a resume: every rank reads
    the one file and keeps its shard) and the chunks after the resume
    point. Returns the resume tick."""
    from multi_cluster_simulator_tpu_torch.core import preempt
    from multi_cluster_simulator_tpu_torch.core.engine import (
        pack_arrivals_chunks,
    )
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.parallel import ShardedEngine

    cfg, specs, arrivals, n_ticks, events, plan = batch_world(ticks)
    sh = ShardedEngine(cfg, mesh)
    state = init_state(cfg, specs, plan=plan, fault_events=events,
                       device="cpu")
    off0 = 0
    if resume and os.path.exists(path):
        state = preempt.load_run(path, state, cfg=cfg, plan=plan,
                                 policy_digest=preempt.policy_digest_for(
                                     cfg)).state
        off0 = int(state.t) // cfg.tick_ms
    sizes = _chunk_sizes(max(n_ticks - off0, 0))
    _RANK_RUN.update(sh=sh, state=sh.shard_state(state), sizes=sizes,
                     chunks=pack_arrivals_chunks(arrivals, sizes,
                                                 cfg.tick_ms, start=off0))
    return off0


def _batch_rank_chunk(mesh, i):
    """A rank's chunk ``i``: its shard through ``run_compressed`` (the
    votes ride the mesh), then the shards gathered; rank 0 returns the
    global state's leaves and the chunk's ``LeapStats``."""
    from multi_cluster_simulator_tpu_torch import interop

    sh = _RANK_RUN["sh"]
    state, stats = sh.run_fn(_RANK_RUN["sizes"][i], tick_indexed=True,
                             time_compress=True, donate=True)(
        _RANK_RUN["state"], sh.shard_arrivals(_RANK_RUN["chunks"][i]))
    _RANK_RUN["state"] = state
    whole = interop.to_numpy(sh.gather_state(state))
    return (whole, interop.to_numpy(stats)) if mesh.rank == 0 else None


class _MeshBatch:
    """The batch child's run over ``ranks`` rank processes: ``start`` and
    ``chunk`` mirror the one-process loop, returning host states."""

    def __init__(self, ranks: int, device, workdir: str):
        from multi_cluster_simulator_tpu_torch.parallel.launch import (
            RankGroup,
        )
        self.n = ranks
        self.group = RankGroup(ranks, device=device, store_dir=workdir)

    def start(self, path, resume, ticks) -> int:
        return self.group.run(self.n, _batch_rank_start, path, resume,
                              ticks)[0]

    def chunk(self, i):
        import torch

        from multi_cluster_simulator_tpu_torch import interop
        from multi_cluster_simulator_tpu_torch.core.state import LeapStats

        whole, stats = self.group.run(self.n, _batch_rank_chunk, i)[0]
        return (interop.state_from_numpy(whole, "cpu"),
                LeapStats(**{k[1:]: torch.from_numpy(np.array(v, copy=True))
                             for k, v in stats.items()}))

    def close(self):
        self.group.close()


def batch_child(path: str, resume: bool, device=None, ticks=None,
                ranks: int = 1) -> int:
    """``--batch-child``: the resumable run ``bench.py --config
    churn_bursts --quick --compact on --time-compress always --checkpoint
    PATH [--resume]`` makes, as the port's: every 100-tick chunk through
    ``Engine.run_compressed``, an ``AsyncCheckpointer`` submit at every
    chunk boundary (the last one flushed), under ``PreemptionGuard``:
    SIGTERM saves at the next boundary and exits 75 with the ``#
    preempted:`` line; a resume announces ``# resumed from``. With
    ``ranks`` > 1 the run is sharded over that many rank processes (a
    ``ShardedEngine`` each, on ``device``, or the card by rank), and the
    gathered state is what each boundary saves: the one-process file."""
    from multi_cluster_simulator_tpu_torch.core import preempt
    from multi_cluster_simulator_tpu_torch.core.engine import (
        Engine, pack_arrivals_chunks,
    )
    from multi_cluster_simulator_tpu_torch.core.state import init_state

    cfg, specs, arrivals, n_ticks, events, plan = batch_world(ticks)
    pdigest = preempt.policy_digest_for(cfg)
    off0, prior = 0, {}
    mesh = None
    if ranks > 1:
        mesh = _MeshBatch(ranks, device, os.path.dirname(
            os.path.abspath(path)))
        state = None
        off0 = mesh.start(path, resume, ticks)
        if resume and os.path.exists(path):
            prior = preempt.load_run(
                path, init_state(cfg, specs, plan=plan, fault_events=events,
                                 device="cpu"),
                cfg=cfg, plan=plan, policy_digest=pdigest).meta
    else:
        engine = Engine(cfg, device=device)
        state = init_state(cfg, specs, plan=plan, fault_events=events,
                           device=engine.device)
        if resume and os.path.exists(path):
            rc = preempt.load_run(path, state, cfg=cfg, plan=plan,
                                  policy_digest=pdigest)
            state, prior = rc.state, rc.meta
            off0 = int(state.t) // cfg.tick_ms
    if resume and os.path.exists(path):
        print(f"# resumed from {path} at tick {off0}", file=sys.stderr)
    sizes = _chunk_sizes(max(n_ticks - off0, 0))
    chunks = pack_arrivals_chunks(arrivals, sizes, cfg.tick_ms, start=off0)
    ck = preempt.AsyncCheckpointer(path, cfg=cfg, plan=plan,
                                   policy_digest=pdigest, tick_ms=cfg.tick_ms)
    leap_stats = []
    covered = 0
    with preempt.PreemptionGuard() as guard:
        for i, (n, ch) in enumerate(zip(sizes, chunks)):
            if mesh is not None:
                state, stats = mesh.chunk(i)
            else:
                state, stats = engine.run_compressed(state, ch, n)
            leap_stats.append(stats)
            covered += n
            meta = {"chunk_idx": i + 1, "tick": off0 + covered,
                    "dense_ticks": 0, "leap_stats": list(leap_stats),
                    "prior": prior}
            if guard.triggered:
                guard.save_and_exit(ck, state, meta=meta)
            ck.submit(state, meta=meta)
        ck.flush()
    ck.close()
    if mesh is not None:
        mesh.close()
    return 0


def _batch_cmd(path: str, resume: bool, device: str, ticks=None,
               ranks: int = 1) -> list:
    cmd = [sys.executable, "-m", MODULE, "--batch-child", "--checkpoint",
           path, "--device", device]
    if ticks is not None:
        cmd += ["--ticks", str(int(ticks))]
    if ranks > 1:
        cmd += ["--ranks", str(int(ranks))]
    return cmd + (["--resume"] if resume else [])


def _wait_progress(ckpt_file: str, proc, n_updates: int, final_t: int,
                   timeout: float = 900.0):
    """Block until the child's checkpoint advanced ``n_updates`` chunk
    boundaries past its current point (or the run's final tick, or child
    exit). Returns ('progress'|'final'|'exited', last_t)."""
    from multi_cluster_simulator_tpu_torch.core.checkpoint import (
        peek_checkpoint_t,
    )

    def peek():
        try:
            return peek_checkpoint_t(ckpt_file)
        except (OSError, ValueError):
            return None  # absent (atomic rename: never torn)

    last = peek()
    seen = 0
    deadline = time.time() + timeout
    while time.time() < deadline:
        t = peek()
        if t is not None and (last is None or t > last):
            last = t
            seen += 1
            if t >= final_t:
                return "final", last
            if seen >= n_updates:
                return "progress", last
        if proc.poll() is not None:
            return "exited", last
        time.sleep(0.02)
    raise RuntimeError(
        f"batch chaos: no checkpoint progress within {timeout}s "
        f"(last t={last})")


def _run_to_completion(cmd, label, timeout=3600):
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"batch chaos: {label} child failed rc={proc.returncode}:\n"
            f"{proc.stderr[-4000:]}")
    return proc


def one_process_batch(ticks=None, device=None) -> dict:
    """The batch child's run, uninterrupted and in this process: every
    chunk through one ``Engine.run_compressed`` on ``device``, with no
    checkpoint; the final state's leaves as numpy."""
    from multi_cluster_simulator_tpu_torch import interop
    from multi_cluster_simulator_tpu_torch.core.engine import (
        Engine, pack_arrivals_chunks,
    )
    from multi_cluster_simulator_tpu_torch.core.state import init_state

    cfg, specs, arrivals, n_ticks, events, plan = batch_world(ticks)
    engine = Engine(cfg, device=device)
    state = init_state(cfg, specs, plan=plan, fault_events=events,
                       device=engine.device)
    sizes = _chunk_sizes(n_ticks)
    for n, ch in zip(sizes, pack_arrivals_chunks(arrivals, sizes,
                                                 cfg.tick_ms)):
        state, _ = engine.run_compressed(state, ch, n)
    return interop.to_numpy(state)


def _kill_cycles(n_dev, kills, sigterm_cycles, rng, dev, ticks, chaos_file,
                 final_t, tick_ms):
    """The resumable child started again and again on ``chaos_file``,
    killed with SIGKILL at ``kills`` randomized chunk boundaries and
    stopped with SIGTERM ``sigterm_cycles`` times. Returns the kills, the
    SIGTERM exits, the ticks killed at, the children that finished first
    and the restarts from scratch."""
    kills_done = 0
    term_exits = 0
    completed_early = 0
    restarts = 0
    boundaries_killed_at = []

    def _restart_from_scratch():
        # a child completed while signal cycles are still owed: drop the
        # chaos checkpoint and let the remaining signals land on a fresh
        # run (every kill/resume sequence must end at the reference state)
        nonlocal restarts
        if os.path.exists(chaos_file):
            os.remove(chaos_file)
            restarts += 1
    while kills_done < kills or term_exits < sigterm_cycles:
        resume = os.path.exists(chaos_file)
        proc = subprocess.Popen(_batch_cmd(chaos_file, resume, dev, ticks,
                                           n_dev),
                                cwd=ROOT, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        use_term = term_exits < sigterm_cycles and kills_done >= 1
        try:
            # randomized boundary: 1-2 fresh checkpoint writes past the
            # resume point, then the signal lands
            status, last_t = _wait_progress(
                chaos_file, proc, int(rng.integers(1, 3)), final_t)
        except BaseException:
            proc.kill()
            proc.wait()
            raise
        if status in ("exited", "final"):
            rc = proc.wait(timeout=900)
            err = proc.stderr.read() if proc.stderr else ""
            if proc.stderr:
                proc.stderr.close()
            if rc != 0:
                raise RuntimeError(
                    f"batch chaos: child failed rc={rc} before a signal "
                    f"landed:\n{err[-4000:]}")
            completed_early += 1
            if completed_early > kills + sigterm_cycles + 2:
                raise RuntimeError(
                    "batch chaos: children keep completing before a signal "
                    "can land — the run is too short for the cycle count")
            _restart_from_scratch()
            continue
        assert proc.poll() is None, "child exited between progress and kill"
        if use_term:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
            err = proc.stderr.read() if proc.stderr else ""
            if proc.stderr:
                proc.stderr.close()
            if rc == 0 or rc == -signal.SIGTERM:
                # the SIGTERM raced the guarded window (the child finished
                # its last boundary first, or the signal landed outside the
                # guard); owe the cycle and try again
                completed_early += 1
                _restart_from_scratch()
                continue
            assert rc == EXIT_PREEMPTED, (
                f"SIGTERM child exited rc={rc}, expected {EXIT_PREEMPTED} "
                f"(clean save-and-exit):\n{err[-2000:]}")
            assert "# preempted: checkpoint saved" in err, (
                "SIGTERM child never announced its preemption save:\n"
                + err[-2000:])
            term_exits += 1
        else:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            if proc.stderr:
                proc.stderr.close()
            kills_done += 1
            boundaries_killed_at.append(int(last_t) // tick_ms)
    return (kills_done, term_exits, boundaries_killed_at, completed_early,
            restarts)


def _batch_scenario(n_dev: int, kills: int, workdir: str, rng,
                    sigterm_cycles: int = 1, device=None,
                    ticks=None, ref_device=None) -> dict:
    """One device-count cell: the uninterrupted child (on ``ref_device``,
    by default ``device``; on the CPU it is the plain version), and beside
    it kill -9 the resumable child at ``kills`` randomized chunk
    boundaries (+ ``sigterm_cycles`` SIGTERM save-and-exit cycles),
    finish, and assert the final checkpoint bitwise the uninterrupted
    one's. With ``n_dev``
    > 1 every child (the uninterrupted one too) runs over a mesh of that
    many ranks (``batch_child(ranks=)``), on ``device``, or the card by
    rank, and the uninterrupted mesh child's final state is held bitwise
    against the one-process run (``one_process_batch``) on the
    reference's device."""
    from multi_cluster_simulator_tpu_torch.core import preempt
    from multi_cluster_simulator_tpu_torch.core.state import init_state

    dev = _device_arg(device)
    ref_dev = dev if ref_device is None else _device_arg(ref_device)
    d = os.path.join(workdir, f"dev{n_dev}")
    os.makedirs(d, exist_ok=True)
    ref_file = os.path.join(d, "ref.ckpt")
    chaos_file = os.path.join(d, "chaos.ckpt")
    cfg, specs, _arr, n_ticks, events, plan = batch_world(ticks)
    final_t = n_ticks * cfg.tick_ms

    t0 = time.time()
    print(f"# batch chaos [{n_dev} dev, {dev}]: uninterrupted reference on "
          f"{ref_dev}, beside the kill cycles...", file=sys.stderr)
    ref_log = open(os.path.join(d, "ref.err"), "w+")
    ref_proc = subprocess.Popen(
        _batch_cmd(ref_file, False, ref_dev, ticks, n_dev), cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=ref_log, text=True)
    try:
        kills_done, term_exits, boundaries_killed_at, completed_early, \
            restarts = _kill_cycles(n_dev, kills, sigterm_cycles, rng, dev,
                                    ticks, chaos_file, final_t, cfg.tick_ms)
        # the final incarnation runs to completion
        final = _run_to_completion(_batch_cmd(chaos_file, True, dev, ticks,
                                              n_dev),
                                   f"{n_dev}dev final resume")
        assert "resumed from" in final.stderr, (
            "final incarnation did not resume from the chaos checkpoint")
        rc = ref_proc.wait(timeout=3600)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
        ref_log.seek(0)
        ref_err = ref_log.read()
        ref_log.close()
    if rc != 0:
        raise RuntimeError(f"batch chaos: {n_dev}dev reference child failed "
                           f"rc={rc}:\n{ref_err[-4000:]}")

    # ---- verification: bit-identical final state, telescoped cursors ----
    pdigest = preempt.policy_digest_for(cfg)

    def load(path):
        template = init_state(cfg, specs, plan=plan, fault_events=events,
                              device="cpu")
        return preempt.load_run(path, template, cfg=cfg, plan=plan,
                                policy_digest=pdigest)

    from multi_cluster_simulator_tpu_torch import interop

    ref_rc, chaos_rc = load(ref_file), load(chaos_file)
    if n_dev > 1:
        diverged = diverged_leaves(one_process_batch(ticks, ref_dev),
                                   interop.to_numpy(ref_rc.state))
        assert not diverged, (
            f"batch chaos [{n_dev} dev]: the uninterrupted {n_dev}-rank "
            f"run DIVERGED from the one-process run on {ref_dev} on "
            f"{len(diverged)} leaves: {diverged[:6]}")
    diverged = diverged_leaves(interop.to_numpy(ref_rc.state),
                               interop.to_numpy(chaos_rc.state))
    assert not diverged, (
        f"batch chaos [{n_dev} dev]: recovered final state DIVERGED from "
        f"the uninterrupted reference on {len(diverged)} leaves: "
        f"{diverged[:6]} — preemption is not replay-invisible")
    assert chaos_rc.meta.get("ticks_executed") == \
        ref_rc.meta.get("ticks_executed"), (
        f"cumulative ticks_executed diverged: chaos "
        f"{chaos_rc.meta.get('ticks_executed')} vs reference "
        f"{ref_rc.meta.get('ticks_executed')}")
    return {
        "n_devices": n_dev,
        "device": dev,
        "reference_device": ref_dev,
        "one_process_device": ref_dev if n_dev > 1 else None,
        "kills": kills_done,
        "sigterm_preemptions": term_exits,
        "completed_before_signal": completed_early,
        "restarts_from_scratch": restarts,
        "boundaries_killed_at_tick": boundaries_killed_at,
        "ticks_total": n_ticks,
        "ticks_executed_compressed": int(ref_rc.meta["ticks_executed"]),
        "final_state_bit_identical": True,
        "cursors_telescope": True,
        "wall_s": round(time.time() - t0, 1),
    }


def run_batch_chaos(cycles: int, quick: bool, out, workdir,
                    keep: bool = False, device=None, ticks=None,
                    ref_device=None) -> dict:
    """The batch-tier chaos matrix: ``cycles`` kill -9 / resume rounds +
    one SIGTERM save-and-exit a scenario, the uninterrupted child on
    ``ref_device`` (by default ``device``). As the reference: quick runs
    one device and a 2-rank mesh (one kill), full one device and an
    8-rank mesh."""
    dirpath = workdir or tempfile.mkdtemp(prefix="mcs-chaos-batch-")
    rng = np.random.default_rng(101)
    report = {"mode": "batch",
              "flags": "--config churn_bursts --quick --compact on "
                       "--time-compress always",
              "scenarios": []}
    scenarios = ([(1, cycles), (2, 1)] if quick
                 else [(1, cycles), (8, cycles)])
    for n_dev, kills in scenarios:
        report["scenarios"].append(_batch_scenario(
            n_dev, kills, dirpath, rng, device=device, ticks=ticks,
            ref_device=ref_device))
        s = report["scenarios"][-1]
        print(f"# batch chaos [{n_dev} dev]: {s['kills']} kill -9 + "
              f"{s['sigterm_preemptions']} SIGTERM cycles, bit-identical, "
              f"{s['wall_s']}s", file=sys.stderr)
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=2)
    if not keep and workdir is None:
        import shutil
        shutil.rmtree(dirpath, ignore_errors=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke: 2 kill/restart cycles, less traffic")
    ap.add_argument("--cycles", type=int, default=None,
                    help="kill -9/restart cycles (default 5)")
    ap.add_argument("--jobs", type=int, default=None)
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--dir", default=None, help="workdir (kept if given)")
    ap.add_argument("--device", default=None,
                    help="torch device of the children (default: the card)")
    ap.add_argument("--serve", action="store_true", help="child mode")
    ap.add_argument("--url-file", default=None)
    ap.add_argument("--batch", action="store_true",
                    help="batch-tier preemption chaos: kill -9 a resumable "
                         "churn_bursts child (compact + compression + "
                         "faults) at randomized chunk boundaries, resume, "
                         "assert bit-identical")
    ap.add_argument("--batch-child", action="store_true", help="child mode")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ticks", type=int, default=None,
                    help="cut the batch run's horizon to this many ticks")
    ap.add_argument("--ranks", type=int, default=1,
                    help="batch child: shard the run over this many rank "
                         "processes")
    args = ap.parse_args(argv)

    if args.serve:
        serve(args.dir, args.url_file, args.device)
        return 0
    if args.batch_child:
        return batch_child(args.checkpoint, args.resume, args.device,
                           args.ticks, args.ranks)
    cycles = args.cycles or (2 if args.quick else 5)
    if args.batch:
        report = run_batch_chaos(cycles, args.quick, args.out, args.dir,
                                 keep=args.dir is not None,
                                 device=args.device, ticks=args.ticks)
        print(json.dumps(report, indent=2))
        return 0
    # a cap, not a target: clients are duration-driven and paced
    jobs = args.jobs or (20_000 if args.quick else 60_000)
    report = run_chaos(cycles, jobs, args.out, args.dir,
                       keep=args.dir is not None, device=args.device)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
