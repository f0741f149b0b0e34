"""Multi-process mesh cost curve (the port of ``tools/multihost_scaling.py``,
which imports jax): the scale16k shape at fixed total work over 1/2/4/8
independently started processes that meet at one rendezvous
(``parallel.multihost``: a ``FileStore`` every process reaches), recording
the wall a tick.

The processes share this machine: its CPU cores, or its one card, where
every rank takes ``cuda:(rank % device_count)``. No process count can then
show a speedup; what the curve measures is the cost of the multi-process
path itself, the collectives of the cross-cluster exchanges at fixed work
as the mesh splits 1 -> 8 ways. ``--check`` instead runs the reference's
two-process test world (``tests/_multihost_worker.py``: FIFO with
borrowing, 8 clusters, 90 ticks) in every worker and holds the gathered
result bitwise against a one-process run of the same config.

Run: ``python -m multi_cluster_simulator_tpu_torch.tools.multihost_scaling
[--device cpu] [--procs 1 2 4 8]`` (the spawner). Writes a markdown table
to stdout and JSON to ``build/multihost_scaling.json``. A worker alone:
``... --worker --rank R --world N --store PATH [--device D] [--check]``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

C = 2048  # scale16k shape at 1/8 cluster count
TICKS = 100
JOBS_PER = 16
MODULE = "multi_cluster_simulator_tpu_torch.tools.multihost_scaling"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _scale_world():
    """The _fifo_parity_scale config (bench.py) at C clusters."""
    from multi_cluster_simulator_tpu_torch.config import PolicyKind, SimConfig
    from multi_cluster_simulator_tpu_torch.core.spec import uniform_cluster
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    cfg = SimConfig(policy=PolicyKind.FIFO, queue_capacity=8, max_running=32,
                    max_arrivals=JOBS_PER, max_ingest_per_tick=8,
                    parity=True, n_res=2, max_nodes=5, max_virtual_nodes=0)
    specs = [uniform_cluster(c + 1, 5) for c in range(C)]
    arrivals = uniform_stream(C, JOBS_PER, TICKS * 1000, max_cores=8,
                              max_mem=6_000, max_dur_ms=60_000, seed=9)
    return cfg, specs, arrivals, TICKS


def check_world():
    """tests/_multihost_worker.py's world: FIFO with borrowing over 8
    clusters (every fourth a big lender), 90 ticks."""
    from multi_cluster_simulator_tpu_torch.config import (
        PolicyKind, SimConfig, WorkloadConfig,
    )
    from multi_cluster_simulator_tpu_torch.core.spec import uniform_cluster
    from multi_cluster_simulator_tpu_torch.workload.generator import (
        generate_arrivals,
    )

    cfg = SimConfig(policy=PolicyKind.FIFO, borrowing=True,
                    queue_capacity=64, max_running=128, max_arrivals=512,
                    max_nodes=12,
                    workload=WorkloadConfig(poisson_lambda_per_min=30.0))
    specs = [uniform_cluster(c + 1, 10 if c % 4 == 3 else 3,
                             cores=32 if c % 4 == 3 else 16,
                             memory=24_000 if c % 4 == 3 else 8_000)
             for c in range(8)]
    arrivals = generate_arrivals(cfg.workload, 8, cfg.max_arrivals, 90_000,
                                 16, 8_000, seed=23)
    return cfg, specs, arrivals, 90


def worker(rank: int, world: int, store: str, device=None,
           check: bool = False) -> dict:
    """One process of the mesh: join the group at ``store``, build the
    global inputs (every process alike), run its shard; rank 0 returns
    the row (``check``: after holding the gathered state bitwise against
    a one-process run)."""
    import torch.distributed as dist

    from multi_cluster_simulator_tpu_torch import interop
    from multi_cluster_simulator_tpu_torch.core.engine import Engine
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.parallel import (
        ShardedEngine, multihost,
    )
    from multi_cluster_simulator_tpu_torch.parallel.mesh import rank_device

    torch.set_num_threads(1)
    cfg, specs, arrivals, n_ticks = check_world() if check else \
        _scale_world()
    dev = rank_device(rank, device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if world > 1:
            dist.barrier()
        return time.time()

    if world > 1:
        multihost.init_group(rank, world, store)
        mesh = multihost.global_mesh(device=device)
        sh = ShardedEngine(cfg, mesh)
        state, arr = multihost.shard_inputs_global(
            sh, init_state(cfg, specs, device="cpu"), arrivals)
        fn = sh.run_fn(n_ticks)
        fn(state, arr)  # warm-up (kernel loads, allocator)
        t0 = sync()
        out = fn(state, arr)
        wall = sync() - t0
        placed = int(multihost.gather_to_host(out.placed_total, mesh).sum())
        whole = interop.to_numpy(sh.gather_state(out))
    else:
        eng = Engine(cfg, device=dev)
        eng.run(init_state(cfg, specs, device=dev), arrivals, n_ticks)
        state = init_state(cfg, specs, device=dev)
        t0 = sync()
        out = eng.run(state, arrivals, n_ticks)
        wall = sync() - t0
        placed = int(out.placed_total.to(torch.int64).sum())
        whole = interop.to_numpy(out)
    row = {"nprocs": world, "device": str(dev), "wall_s": round(wall, 4),
           "ms_per_tick": round(wall / n_ticks * 1e3, 4), "placed": placed}
    if check:
        ref = interop.to_numpy(Engine(cfg, device=dev).run(
            init_state(cfg, specs, device=dev), arrivals, n_ticks))
        bad = [k for k in ref if ref[k].dtype != whole[k].dtype
               or not np.array_equal(ref[k], whole[k])]
        if bad:
            raise AssertionError(f"rank {rank}: the {world}-process mesh "
                                 f"diverged from one process at {bad[:6]}")
        row["bit_identical"] = True
    if world > 1:
        dist.destroy_process_group()
    return row


def spawn(nprocs: int, device=None, check: bool = False,
          timeout: float = 1800) -> dict:
    """``nprocs`` independently started worker processes at one FileStore
    (in a fresh temporary directory); returns rank 0's row and raises if
    any worker failed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory(prefix="mcs-multihost-") as td:
        store = os.path.join(td, "store")
        logs = [os.path.join(td, f"w{i}.log") for i in range(nprocs)]
        handles = [open(path, "w") for path in logs]
        cmd = [sys.executable, "-m", MODULE, "--worker", "--world",
               str(nprocs), "--store", store]
        if device is not None:
            cmd += ["--device", str(device)]
        if check:
            cmd.append("--check")
        procs = [subprocess.Popen(cmd + ["--rank", str(i)],
                                  stdout=handles[i],
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env, cwd=ROOT)
                 for i in range(nprocs)]
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                p.kill()
                p.wait()
            for h in handles:
                h.close()
        texts = [open(path).read() for path in logs]
        for i, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"worker {i}/{nprocs} failed:\n"
                                   f"{texts[i][-3000:]}")
        for line in texts[0].splitlines():
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"no RESULT from the {nprocs}-process run:\n"
                       f"{texts[0][-2000:]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true", help="worker mode")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--store", default=None)
    ap.add_argument("--check", action="store_true",
                    help="run the two-process test world and hold it "
                         "bitwise against one process")
    ap.add_argument("--device", default=None,
                    help="every process's device (default: the card by "
                         "rank)")
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--out", default=os.path.join("build",
                                                  "multihost_scaling.json"))
    args = ap.parse_args(argv)
    from multi_cluster_simulator_tpu_torch.core.state import resolve_device

    resolve_device(args.device)  # no card and no --device: refuse here
    if args.worker:
        row = worker(args.rank, args.world, args.store, args.device,
                     args.check)
        if args.rank == 0:
            print("RESULT " + json.dumps(row), flush=True)
        if args.check:
            print("MULTIHOST OK", flush=True)
        return 0
    rows = []
    for n in args.procs:
        r = spawn(n, args.device, args.check)
        rows.append(r)
        print(f"# {n} processes: {r['ms_per_tick']} ms/tick "
              f"(placed {r['placed']})", file=sys.stderr)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"host_cores": os.cpu_count(), "clusters": C,
                   "ticks": TICKS, "device": rows[0]["device"],
                   "rows": rows}, f, indent=2)
    print("| processes | wall (s) | ms/tick | overhead vs the first |")
    print("|---|---|---|---|")
    base = rows[0]["wall_s"]
    for r in rows:
        print(f"| {r['nprocs']} | {r['wall_s']} | {r['ms_per_tick']} | "
              f"{r['wall_s'] / base:.2f}x |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
