"""Greedy vs sinkhorn vs cvx matcher A/B on the sinkhorn bench shape (the
port of ``tools/market_ab.py``, which imports jax and ``bench``).

Same workload, same engine, same config except ``trader.matching``: half
the clusters are gpu-rich sellers, half gpu-poor buyers whose gpu jobs can
only run on traded virtual nodes, at ~1.1x capacity saturation
(``sinkhorn_market_setup``, the port's copy of ``bench.py:979``, pinned by
tests/test_torch_market_ab.py). Records, per matcher and cluster count:
jobs placed (fraction), virtual nodes traded, mean and p95 avg-wait over
clusters, the walls (min of the timed runs) and the engine's market
provenance. ``--require-cvx-wins`` exits 1 unless cvx matches or beats
sinkhorn on both placed jobs and mean wait at every cluster count.

Run: ``python -m multi_cluster_simulator_tpu_torch.tools.market_ab
[--clusters 1024 4096] [--device cpu]`` (the card by default). Writes a
markdown table to stdout and JSON to ``build/market_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HORIZON_MS = 600_000
JOBS_PER = 400
# sha256 (``interop.leaves_digest``) of the reference engine's final state
# of config 4's world at C clusters (``sinkhorn_market_setup(C, 400,
# 600_000)``, sinkhorn, 700 ticks over the windowed stream, jax 0.9.0 on
# an x86 CPU): tests/test_torch_market_ab.py recomputes each from the JAX
# package, and chip_smoke.py holds the card's runs to them.
CONFIG4_DIGESTS = {
    64: "eb565327345e80e4917f1712a32752009a7d0259891d7a861b0a7d07636fa752",
    256: "98525005483d5ea493e0f67d5754a4f6f2db0356478c02d49f3c5bf6aee075d3",
}


def sinkhorn_market_cfg(jobs_per, matching="sinkhorn", quick=False):
    """``sinkhorn_market_setup``'s config: DELAY wave, 8 placements a tick,
    5 nodes + 4 virtual slots, 3 resources, the trader on with
    ``matching`` and the sane carve."""
    from multi_cluster_simulator_tpu_torch.config import (
        MatchKind, PolicyKind, SimConfig, TraderConfig,
    )

    return SimConfig(policy=PolicyKind.DELAY, parity=False,
                     max_placements_per_tick=8,
                     queue_capacity=512 if quick else 256,
                     max_running=256 if quick else 128, max_arrivals=jobs_per,
                     max_ingest_per_tick=16, max_nodes=5, max_virtual_nodes=4,
                     delay_sweep="wave",
                     trader=TraderConfig(enabled=True,
                                         matching=MatchKind(matching),
                                         carve_mode="sane"))


def sinkhorn_market_specs(C):
    """Half the clusters gpu-rich (8 gpus a node), half gpu-poor."""
    from multi_cluster_simulator_tpu_torch.core.spec import uniform_cluster

    return [uniform_cluster(c + 1, 5, gpus=8 if c % 2 == 0 else 0)
            for c in range(C)]


def sinkhorn_market_stream(C, jobs_per, horizon_ms, quick=False, seed=7):
    """The market's stream: 10% gpu jobs of up to 2 gpus, durations up to
    40 s (300 s quick)."""
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    return uniform_stream(C, jobs_per, horizon_ms, max_cores=24,
                          max_mem=18_000,
                          max_dur_ms=300_000 if quick else 40_000, seed=seed,
                          max_gpus=2, gpu_frac=0.1)


def sinkhorn_market_setup(C, jobs_per, horizon_ms, matching="sinkhorn",
                          quick=False):
    """``bench.py sinkhorn_market_setup`` as the port's: ``(cfg, specs,
    arrivals, n_ticks)``."""
    cfg = sinkhorn_market_cfg(jobs_per, matching, quick)
    return (cfg, sinkhorn_market_specs(C),
            sinkhorn_market_stream(C, jobs_per, horizon_ms, quick),
            horizon_ms // cfg.tick_ms + 100)


def run_one(matching: str, C: int, device=None, runs: int = 3,
            warmups: int = 2):
    """One matcher at C clusters over the windowed stream: ``warmups``
    untimed runs (the reference's compile run and warm-up) and ``runs``
    timed ones (min of them, as the reference times), each from a fresh
    copy of the initial state; the reference's row keys, with ``device``
    and the final state (``final``)."""
    from multi_cluster_simulator_tpu_torch.core.engine import Engine
    from multi_cluster_simulator_tpu_torch.core.state import (
        avg_wait_ms, clone_state, init_state,
    )
    from multi_cluster_simulator_tpu_torch.utils.trace import total_drops

    cfg, specs, arrivals, n_ticks = sinkhorn_market_setup(
        C, JOBS_PER, HORIZON_MS, matching=matching)
    eng = Engine(cfg, device=device)
    dev = eng.device
    state0 = init_state(cfg, specs, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time()

    # the windowed stream, as the reference runs it
    for _ in range(warmups):
        eng.run(clone_state(state0), arrivals, n_ticks)
    walls = []
    for _ in range(runs):
        s = clone_state(state0)
        t0 = sync()
        out = eng.run(s, arrivals, n_ticks)
        walls.append(sync() - t0)
    wall = min(walls)
    walls_r = [round(w, 3) for w in walls]
    placed = int(out.placed_total.to(torch.int64).sum())
    vnodes = int(out.node_active[:, cfg.max_nodes:].sum())
    waits = avg_wait_ms(out).cpu().numpy()
    drops = total_drops(out)
    return {"matching": matching, "clusters": C,
            "placed": placed, "of": C * JOBS_PER,
            "placed_frac": round(placed / (C * JOBS_PER), 4),
            "virtual_nodes_traded": vnodes,
            "mean_avg_wait_ms": round(float(waits.mean()), 1),
            "p95_avg_wait_ms": round(float(np.percentile(waits, 95)), 1),
            "wall_s": round(wall, 3), "walls": walls_r,
            "timing": f"min-of-{len(walls_r)}", "drops": drops,
            "market": eng.market_provenance(), "device": str(dev),
            "final": out}


def cvx_wins(rows, clusters) -> list:
    """The ``--require-cvx-wins`` gate: the cluster counts where cvx does
    not match or beat sinkhorn on both placed jobs and mean wait."""
    by = {(r["clusters"], r["matching"]): r for r in rows}
    failed = []
    for C in clusters:
        cvx, sink = by.get((C, "cvx")), by.get((C, "sinkhorn"))
        if cvx is None or sink is None:
            failed.append(f"{C}: need both cvx and sinkhorn rows")
        elif (cvx["placed"] < sink["placed"]
              or cvx["mean_avg_wait_ms"] > sink["mean_avg_wait_ms"]):
            failed.append(
                f"{C}: cvx placed {cvx['placed']} wait "
                f"{cvx['mean_avg_wait_ms']}ms vs sinkhorn "
                f"{sink['placed']}/{sink['mean_avg_wait_ms']}ms")
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", type=int, nargs="+", default=[1024, 4096])
    ap.add_argument("--matchers", nargs="+",
                    default=["greedy", "sinkhorn", "cvx"],
                    choices=("greedy", "sinkhorn", "cvx"))
    ap.add_argument("--require-cvx-wins", action="store_true",
                    help="exit 1 unless, at every cluster count, cvx "
                         "matches-or-beats sinkhorn on BOTH placed jobs "
                         "and mean avg wait")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=os.path.join("build", "market_ab.json"))
    args = ap.parse_args(argv)
    rows = []
    for C in args.clusters:
        for m in args.matchers:
            r = run_one(m, C, device=args.device)
            r.pop("final")
            rows.append(r)
            print(f"# {m}@{C}: placed {r['placed_frac']:.4f}, "
                  f"vnodes {r['virtual_nodes_traded']}, "
                  f"wait {r['mean_avg_wait_ms']}ms, wall {r['wall_s']}s",
                  file=sys.stderr)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    print("| clusters | matcher | placed frac | vnodes traded | "
          "mean avg wait (ms) | p95 avg wait (ms) | wall (s, min-of-3) |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['clusters']} | {r['matching']} | {r['placed_frac']} | "
              f"{r['virtual_nodes_traded']} | {r['mean_avg_wait_ms']} | "
              f"{r['p95_avg_wait_ms']} | {r['wall_s']} |")
    if args.require_cvx_wins:
        failed = cvx_wins(rows, args.clusters)
        if failed:
            print("FAIL --require-cvx-wins: " + "; ".join(failed),
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
