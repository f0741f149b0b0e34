"""Weak-scaling constellation driver: the mesh as the bigger-problem lever
(the port of ``tools/weak_scaling.py``, which imports jax and ``bench``).

Holds a fixed per-rank cluster count (4,096 at full scale) and grows the
constellation with the mesh: 1/2/4/8 ranks = 4k..32k clusters, running the
headline FIFO-parity semantics with the single-device ladder composed:
compact state, the tick-indexed stream in chunks (each rank keeps only its
shard's slice), and event-compressed time per chunk where the stream is
sparse (bench.py's ``--time-compress auto`` rule, ``leapable``). A rank is
a process (``parallel.launch.RankGroup``); ranks join one gloo group and
take ``cuda:(rank % device_count)``, so on a machine with one card every
rank shares it, and no row there is a scaling figure: the efficiency
column then measures the sharded path's overhead at shape (the record's
``bottleneck`` says so). The bit-exactness of the parity cells is what
carries over to a machine with a card a rank.

Sections of the record (JSON at ``--out``, ``build/weak_scaling.json`` by
default; the port never writes the JAX package's ``MULTICHIP_r*.json``):

- ``rows``: the weak-scaling curve (jobs/s, efficiency against the
  smallest mesh, ticks executed/simulated, drops);
- ``market_row``: the federated market (DELAY + the greedy trader) at the
  full mesh's constellation, the exchange collectives at shape;
- ``parity_cells``: every mesh size's small constellation (compact and
  wide, compressed) bitwise the one-process run, and a non-divisible
  constellation padded with inert sentinel clusters (``pad_constellation``)
  bitwise the unpadded run on the real clusters.

Run: ``python -m multi_cluster_simulator_tpu_torch.tools.weak_scaling
[--quick] [--device cpu] [--ranks 1 2]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

DEFAULT_OUT = os.path.join("build", "weak_scaling.json")
DEVICE_COUNTS = (1, 2, 4, 8)
# bench.py's --time-compress auto rule (bench.py:99-113 _leapable)
COMPRESS_AUTO_GAP, COMPRESS_AUTO_EMPTY_FRAC = 8, 0.5


def leapable(counts) -> bool:
    """bench.py's per-chunk ``--time-compress auto`` choice: a chunk runs
    compressed when at least half its ticks have no arrivals and one run
    of empty ticks is at least 8 long."""
    empty = ~np.asarray(counts).any(axis=1)
    if not empty.any() or empty.mean() < COMPRESS_AUTO_EMPTY_FRAC:
        return False
    edges = np.flatnonzero(np.diff(np.concatenate(
        ([0], empty.astype(np.int8), [0]))))
    return int((edges[1::2] - edges[::2]).max()) >= COMPRESS_AUTO_GAP


def _fifo_constellation(C, jobs_per, horizon_ms, seed=9):
    """The headline FIFO-parity shape (bench._fifo_parity_scale's config)
    at an arbitrary cluster count, with the bounds the reference sizes for
    this driver's denser stream. Returns ``(cfg, specs, arrivals,
    n_ticks)``."""
    from multi_cluster_simulator_tpu_torch.config import PolicyKind, SimConfig
    from multi_cluster_simulator_tpu_torch.core.spec import uniform_cluster
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    cfg = SimConfig(policy=PolicyKind.FIFO, queue_capacity=16,
                    max_running=64, max_arrivals=jobs_per,
                    max_ingest_per_tick=8, parity=True, n_res=2,
                    max_nodes=5, max_virtual_nodes=0)
    specs = [uniform_cluster(c + 1, 5) for c in range(C)]
    arrivals = uniform_stream(C, jobs_per, horizon_ms, max_cores=8,
                              max_mem=6_000, max_dur_ms=60_000, seed=seed)
    n_ticks = horizon_ms // cfg.tick_ms + 70  # drain tail
    return cfg, specs, arrivals, n_ticks


def pad_constellation(cfg, specs, arrivals, n_shards):
    """Pad a constellation whose cluster count does not divide over
    ``n_shards`` ranks to the next valid count with inert sentinel
    clusters: one zero-capacity node (always full: nothing can ever place)
    and a zero-length arrival stream. Sentinels can never place, lend,
    borrow or promote, so the real clusters run bitwise as unpadded.
    Returns ``(specs, arrivals, n_pad)``.

    Refused under the trader market: a sentinel's utilization and wait
    snapshots enter the request and approve policies, so padding would
    change the real clusters' trades."""
    from multi_cluster_simulator_tpu_torch.core.spec import uniform_cluster
    from multi_cluster_simulator_tpu_torch.parallel.mesh import (
        nearest_divisible,
    )
    from multi_cluster_simulator_tpu_torch.utils.tree import tree_map

    C = len(specs)
    _, hi = nearest_divisible(C, n_shards)
    if hi == C:
        return specs, arrivals, 0
    if cfg.trader.enabled:
        raise ValueError(
            f"cannot auto-pad a trader-enabled constellation ({C} clusters "
            f"-> {hi}): sentinel utilization snapshots are visible to the "
            "market's request/approve policies; pick a divisible cluster "
            "count instead")
    n_pad = hi - C
    specs = list(specs) + [uniform_cluster(C + i + 1, 1, cores=0, memory=0)
                           for i in range(n_pad)]

    def pad_leaf(x):
        x = np.asarray(x)
        return np.concatenate(
            [x, np.zeros((n_pad,) + x.shape[1:], x.dtype)], axis=0)

    # every Arrivals leaf leads with the cluster axis ([C, A] rows, [C] n)
    return specs, tree_map(pad_leaf, arrivals), n_pad


def _world(kind: str, C: int, jobs_per: int, horizon_ms: int, seed: int,
           pad_to: int):
    if kind == "market":
        from multi_cluster_simulator_tpu_torch.tools.market_ab import (
            sinkhorn_market_setup,
        )
        cfg, specs, arrivals, n_ticks = sinkhorn_market_setup(
            C, jobs_per, horizon_ms, matching="greedy")
    else:
        cfg, specs, arrivals, n_ticks = _fifo_constellation(
            C, jobs_per, horizon_ms, seed=seed)
    if pad_to:
        specs, arrivals, _ = pad_constellation(cfg, specs, arrivals, pad_to)
    return cfg, specs, arrivals, n_ticks


def _shape_rank(mesh, kind, C, jobs_per, horizon_ms, seed=9, pad_to=0,
                repeats=2, chunk=200, compact=True, time_compress="auto",
                return_state=False):
    """One rank's part of a row: the world built alike on every rank, the
    rank's shard run ``repeats`` times from a fresh shard through its
    chunks (each compressed where ``time_compress`` says: ``auto`` by
    ``leapable``, ``always``, ``off``), the walls taken between barriers.
    One rank runs the plain ``Engine``. Rank 0 returns the gathered
    final state's leaves (with ``return_state``), the walls, the placed
    and dropped counts and the ticks executed."""
    import torch.distributed as dist

    from multi_cluster_simulator_tpu_torch import interop
    from multi_cluster_simulator_tpu_torch.core.compact import derive_plan
    from multi_cluster_simulator_tpu_torch.core.engine import (
        Engine, pack_arrivals_chunks,
    )
    from multi_cluster_simulator_tpu_torch.core.state import init_state
    from multi_cluster_simulator_tpu_torch.parallel import ShardedEngine
    from multi_cluster_simulator_tpu_torch.utils.trace import total_drops

    cfg, specs, arrivals, n_ticks = _world(kind, C, jobs_per, horizon_ms,
                                           seed, pad_to)
    plan = derive_plan(cfg, specs, arrivals) if compact else None
    sizes = [chunk] * (n_ticks // chunk) + ([n_ticks % chunk]
                                            if n_ticks % chunk else [])
    chunks = pack_arrivals_chunks(arrivals, sizes, cfg.tick_ms)
    leap = [time_compress == "always"
            or (time_compress == "auto" and leapable(ch.counts))
            for ch in chunks]
    dev = mesh.device
    sh = ShardedEngine(cfg, mesh) if mesh.size > 1 else None
    eng = sh.engine if sh is not None else Engine(cfg, device=dev)
    if sh is not None:
        chunks = [sh.shard_arrivals(ch) for ch in chunks]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if mesh.group is not None:
            dist.barrier(group=mesh.group)
        return time.time()

    walls = []
    for _ in range(repeats):
        if sh is not None:
            state = sh.shard_state(init_state(cfg, specs, plan=plan,
                                              device="cpu"))
        else:
            state = init_state(cfg, specs, plan=plan, device=dev)
        executed = 0
        t0 = sync()
        for n, ch, lp in zip(sizes, chunks, leap):
            if lp:
                state, stats = eng.run_compressed(state, ch, n)
                executed += int(stats.ticks_executed)
            else:
                state = eng.run_chunks(state, [ch])
                executed += n
        walls.append(sync() - t0)
    whole = sh.gather_state(state) if sh is not None else state
    if mesh.rank != 0:
        return None
    out = {"walls": walls, "placed": int(whole.placed_total[:C].to(
               torch.int64).sum()),
           "drops": total_drops(whole), "ticks_executed": executed,
           "ticks_simulated": n_ticks, "clusters": len(specs),
           "virtual_nodes": int(whole.node_active[:, cfg.max_nodes:].sum())}
    if return_state:
        out["state"] = interop.to_numpy(whole)
    return out


def _row(ranks, n, kind, C, jobs_per, horizon_ms, repeats, chunk,
         time_compress="auto"):
    r = ranks.run(n, _shape_rank, kind, C, jobs_per, horizon_ms,
                  repeats=repeats, chunk=chunk,
                  time_compress=time_compress)[0]
    if any(r["drops"].values()):
        raise AssertionError(f"weak_scaling[{n} ranks]: drops {r['drops']}")
    wall = min(r["walls"])
    return {"n_devices": n, "clusters": r["clusters"], "jobs": r["placed"],
            "jobs_per_sec": round(r["placed"] / max(wall, 1e-9), 1),
            "wall_s": round(wall, 4),
            "walls": [round(w, 4) for w in r["walls"]],
            "drops": r["drops"], "ticks_simulated": r["ticks_simulated"],
            "ticks_executed": r["ticks_executed"],
            "virtual_nodes": r["virtual_nodes"]}


def run_curve(ranks, per_device, jobs_per, horizon_ms, device_counts,
              repeats=2, chunk=200):
    """The weak-scaling curve: clusters = per_device x n for each rank
    count, fixed work a rank. Efficiency is (rate_n / n) / (rate_min /
    n_min), the smallest mesh the baseline."""
    rows = []
    for n in sorted(set(device_counts)):
        row = _row(ranks, n, "fifo", per_device * n, jobs_per, horizon_ms,
                   repeats, chunk)
        rows.append(row)
        print(f"# weak_scaling {n} ranks x {per_device} clusters: "
              f"{row['jobs_per_sec']} jobs/s", file=sys.stderr)
    base_per_dev = rows[0]["jobs_per_sec"] / rows[0]["n_devices"]
    for row in rows:
        row["efficiency_vs_linear"] = round(
            row["jobs_per_sec"] / (row["n_devices"] * base_per_dev), 3)
    return rows


def run_market_row(ranks, per_device, n_dev, jobs_per, horizon_ms,
                   repeats=1):
    """The federated market at the full mesh's constellation: the
    sinkhorn bench shape with greedy matching (DELAY + trader), dense, so
    the borrow/trade exchange collectives run at shape."""
    row = _row(ranks, n_dev, "market", per_device * n_dev, jobs_per,
               horizon_ms, repeats, 100, time_compress="off")
    if row["virtual_nodes"] < 1:
        raise AssertionError(
            "market composition row: the federated market never traded a "
            "virtual node at the full mesh's shape")
    row["virtual_nodes_traded"] = row.pop("virtual_nodes")
    row["kind"] = "federated_market_composition"
    print(f"# market row {n_dev} ranks x {per_device} clusters: "
          f"{row['jobs_per_sec']} jobs/s, {row['virtual_nodes_traded']} "
          "vnodes traded", file=sys.stderr)
    return row


def _diff(a: dict, b: dict, prefix=None) -> list:
    out = []
    for k in a:
        x, y = a[k], b[k]
        if prefix is not None and x.ndim and x.shape[0] == prefix[1]:
            x = x[:prefix[0]]
        if x.dtype != y.dtype or x.shape != y.shape or \
                not np.array_equal(x, y):
            out.append(k)
    return out


def verify_parity_cells(ranks, device_counts, quick=False):
    """Every mesh size's small constellation (16 clusters; compact and
    wide, or compact only with ``quick``), compressed, bitwise the
    one-process run of the same total shape; and 13 clusters padded with
    sentinels for the largest mesh, bitwise the unpadded run on the real
    clusters. Raises on a divergence; returns the cells."""
    cells = []
    C, jobs_per, horizon = 16, 12, 40_000
    kw = dict(repeats=1, chunk=10_000, return_state=True)
    for compact in (True,) if quick else (False, True):
        ref = ranks.run(1, _shape_rank, "fifo", C, jobs_per, horizon,
                        seed=23, compact=compact, time_compress="off",
                        **kw)[0]
        for n in device_counts:
            if n == 1 or C % n:
                continue
            got = ranks.run(n, _shape_rank, "fifo", C, jobs_per, horizon,
                            seed=23, compact=compact, time_compress="always",
                            **kw)[0]
            bad = _diff(got["state"], ref["state"])
            if bad:
                raise AssertionError(
                    f"weak-scaling parity cell diverged: {n}-rank mesh != "
                    f"one process (compact={compact}) at {bad[:4]}")
            cells.append({"n_devices": n, "clusters": C, "compact": compact,
                          "time_compress": True,
                          "ticks_executed": got["ticks_executed"],
                          "bit_identical": True})
    multi = [d for d in device_counts if d > 1]
    if multi:
        n = max(multi)
        ref = ranks.run(1, _shape_rank, "fifo", 13, jobs_per, horizon,
                        seed=29, compact=False, time_compress="off", **kw)[0]
        got = ranks.run(n, _shape_rank, "fifo", 13, jobs_per, horizon,
                        seed=29, pad_to=n, compact=False,
                        time_compress="off", **kw)[0]
        bad = _diff(got["state"], ref["state"],
                    prefix=(13, got["clusters"]))
        if bad:
            raise AssertionError(
                "sentinel-padded constellation diverged from the unpadded "
                f"run on the real-cluster prefix at {bad[:4]}")
        cells.append({"n_devices": n, "clusters": 13,
                      "padded_to": got["clusters"],
                      "prefix_bit_identical": True})
    print(f"# parity: {len(cells)} cells bit-identical", file=sys.stderr)
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke shape (small constellation)")
    ap.add_argument("--out", default=DEFAULT_OUT, help="the record's path")
    ap.add_argument("--ranks", "--devices", dest="ranks", type=int,
                    nargs="+", default=None,
                    help="rank counts of the curve (default 1 2 4 8; quick "
                         "1 2)")
    ap.add_argument("--per-device-clusters", type=int, default=None,
                    help="clusters a rank (default 4096; quick 64)")
    ap.add_argument("--jobs-per", type=int, default=None,
                    help="jobs a cluster for the curve rows")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--skip-market", action="store_true")
    ap.add_argument("--device", default=None,
                    help="every rank's device (default: the card by rank)")
    args = ap.parse_args(argv)

    from multi_cluster_simulator_tpu_torch.core.state import resolve_device
    from multi_cluster_simulator_tpu_torch.parallel.launch import RankGroup
    from multi_cluster_simulator_tpu_torch.parallel.mesh import rank_device

    resolve_device(args.device)  # no card and no --device: refuse here
    counts = tuple(args.ranks or ((1, 2) if args.quick else DEVICE_COUNTS))
    per_dev = args.per_device_clusters or (64 if args.quick else 4096)
    jobs_per = args.jobs_per or (20 if args.quick else 100)
    horizon = 60_000 if args.quick else 200_000
    t0 = time.time()
    with RankGroup(max(counts), device=args.device) as ranks:
        cells = verify_parity_cells(ranks, counts, quick=args.quick)
        rows = run_curve(ranks, per_dev, jobs_per, horizon, counts,
                         repeats=args.repeats,
                         chunk=100 if args.quick else 200)
        market = None
        if not args.skip_market and not args.quick:
            market = run_market_row(ranks, min(per_dev, 1024), max(counts),
                                    jobs_per=40, horizon_ms=60_000)
    cards = torch.cuda.device_count() if args.device in (None, "cuda") \
        and torch.cuda.is_available() else 0
    record = {
        "kind": "weak_scaling_record", "quick": bool(args.quick),
        "device": str(rank_device(0, args.device)), "cards": cards,
        "host_cores": os.cpu_count(), "per_device_clusters": per_dev,
        "bottleneck": (
            f"{max(counts)} ranks share {max(cards, 1)} "
            f"{'card' if cards else 'CPU'}(s): the efficiency column "
            "measures the sharded path's overhead at shape, not scaling"
            if max(counts) > max(cards, 1) else None),
        "rows": rows, "parity_cells": cells,
        **({"market_row": market} if market else {}),
        "total_wall_s": round(time.time() - t0, 1)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
    print(f"# record -> {args.out}", file=sys.stderr)
    print("| ranks | clusters | jobs/s | efficiency | ticks exec/sim |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['n_devices']} | {r['clusters']} | {r['jobs_per_sec']} "
              f"| {r['efficiency_vs_linear']} | "
              f"{r['ticks_executed']}/{r['ticks_simulated']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
