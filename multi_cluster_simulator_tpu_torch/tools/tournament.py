"""Policy-tournament driver: the whole scheduler zoo's (policy, seed) grid
as ONE lane-stacked run (the port of ``tools/tournament.py``, which
imports jax).

Each lane of the run is one (variant, seed) cell: the lanes' states are
stacked (``tenancy.stack_tenant_states``), their bucketed arrivals padded
to the grid's K and stacked (``stack_tick_arrivals``), and their
parameters stacked on the lane axis (``stack_lanes`` of
``PolicySet.params_for``: a batched ``params.idx``, every DELAY
threshold, gavel matrix and tesserae weight a lane's own). One
``Engine.run`` then advances every cell: each kernel source launches at
most once a tick over all the lanes it carries (on the card; the CPU runs
the plain version), which is the port's counterpart of the reference's
one-compiled-program gate. Every cell must be bitwise its standalone
single-policy run, which the tool re-runs as both the correctness
oracle and the serial baseline the recorded speedup is measured against;
no cell may drop work.

``--resume PATH`` persists each variant's rows after its cells pass, with
the grid digest (lineup, seeds, shape, config, every variant's parameter
leaves), in the reference's JSON keys: a cache either package writes
resumes in the other; a rerun runs only the missing variants' lanes; a
digest mismatch fails fast. ``--shard always --shard-devices N`` splits
the seed (replication) axis over N ranks (``parallel.launch.RankGroup``:
processes of one gloo group, sharing the card where there is one): each
rank runs the lanes of its seeds as one lane-stacked run, and every cell
is still held against its standalone run; ``--device-ab`` re-runs the
whole grid in one process and holds the two grids bitwise equal.

Run: ``python -m multi_cluster_simulator_tpu_torch.tools.tournament
[--quick] [--device cpu]`` (the card by default). Writes a markdown table
to stdout and JSON to ``build/tournament.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

# the default lineup: the reference repertoire, its parameter variants and
# the heterogeneity/packing zoo members
DEFAULT_POLICIES = ("fifo", "delay", "delay-eager", "delay-patient",
                    "ffd", "ffd-memfirst", "gavel", "tesserae")


def sweep_policies():
    """Register and return the parameter-sweep lineup (48 variants, 16
    points each over the delay/gavel/tesserae kinds): a DELAY
    promotion-threshold grid, a Gavel grid whose core-heavy-class
    throughput on accelerator nodes crosses the preference-flipping point
    1.0, and a Tesserae mem-weight grid over four decades. Every variant
    is parameter data: in the lane grid each is a lane's own leaves."""
    from multi_cluster_simulator_tpu_torch.policies.base import (
        REGISTRY, variant,
    )

    names = []
    for w in (1_000, 2_000, 3_000, 4_000, 6_000, 8_000, 10_000, 12_000,
              14_000, 16_000, 20_000, 24_000, 28_000, 32_000, 36_000,
              40_000):
        n = f"delay-w{w}"
        if n not in REGISTRY:
            variant(n, "delay", max_wait_ms=w)
        names.append(n)
    for i, sc in enumerate((0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.25,
                            1.5, 2.0, 2.5, 3.0, 4.0, 6.0, 8.0)):
        n = f"gavel-accel{i}"
        if n not in REGISTRY:
            variant(n, "gavel", gavel_tput=(
                (1.0, 1.0, 1.0, 1.0), (1.0, sc, 1.0, 1.0),
                (0.5, sc, 1.0, 1.0), (0.5, sc, 1.0, 1.0)))
        names.append(n)
    for i, mw in enumerate((1e-4, 2e-4, 3e-4, 5e-4, 1e-3, 2e-3, 3e-3, 5e-3,
                            1e-2, 2e-2, 3e-2, 5e-2, 0.1, 0.3, 1.0, 3.0)):
        n = f"tess-mem{i}"
        if n not in REGISTRY:
            variant(n, "tesserae", tess_w=(1.0, mw, 1.0))
        names.append(n)
    return tuple(names)


def _specs(C):
    """Heterogeneous clusters for the device-type-aware members: five
    uniform nodes, the last two typed as accelerators (device_type 1)."""
    from multi_cluster_simulator_tpu_torch.core.spec import (
        ClusterSpec, NodeSpec,
    )

    def cluster(cid):
        return ClusterSpec(id=cid, nodes=tuple(
            NodeSpec(id=i + 1, cores=32, memory=24_000,
                     device_type=1 if i >= 3 else 0) for i in range(5)))

    return [cluster(c + 1) for c in range(C)]


def _cfg(queue_capacity=96, max_running=96, jobs_per=120):
    """One config every zoo member can run: parity semantics, no borrowing
    or trader, bounds sized so no cell drops."""
    from multi_cluster_simulator_tpu_torch.config import PolicyKind, SimConfig

    return SimConfig(policy=PolicyKind.FIFO, parity=True, n_res=2,
                     queue_capacity=queue_capacity, max_running=max_running,
                     max_arrivals=jobs_per, max_ingest_per_tick=32,
                     max_nodes=5, max_virtual_nodes=0)


def _pack_seeds(arrs, n_ticks, tick_ms):
    """Each seed's stream bucketed once (``pack_arrivals_by_tick``), padded
    to the grid-global K (invalid rows the ingest never reads). Returns
    (padded buckets, unpadded buckets for the standalone runs)."""
    from multi_cluster_simulator_tpu_torch.core.engine import (
        pack_arrivals_by_tick,
    )
    from multi_cluster_simulator_tpu_torch.tenancy import pad_tick_arrivals

    tas = [pack_arrivals_by_tick(a, n_ticks, tick_ms) for a in arrs]
    K = max(ta.rows.shape[2] for ta in tas)
    return [pad_tick_arrivals(ta, K) for ta in tas], tas


def _cell_stats(state, C, jobs_per):
    from multi_cluster_simulator_tpu_torch.core.state import avg_wait_ms
    from multi_cluster_simulator_tpu_torch.utils.trace import total_drops

    placed = int(state.placed_total.to(torch.int64).sum())
    waits = avg_wait_ms(state).cpu().numpy()
    return {"placed": placed, "of": C * jobs_per,
            "placed_frac": round(placed / max(C * jobs_per, 1), 4),
            "mean_avg_wait_ms": round(float(waits.mean()), 1),
            "drops": total_drops(state)}


def _grid_digest(policies, seeds, C, jobs_per, horizon_ms, drain_ticks,
                 cfg, variant_params):
    """Digest of everything that makes two sweeps THE SAME grid — the
    reference's, character for character, so the --resume cache is
    shared."""
    from multi_cluster_simulator_tpu_torch.core.checkpoint import (
        config_describe, digest_of,
    )
    from multi_cluster_simulator_tpu_torch.policies.base import params_digest

    desc = {"policies": list(policies), "seeds": list(seeds), "C": C,
            "jobs_per": jobs_per, "horizon_ms": horizon_ms,
            "drain_ticks": drain_ticks, "config": config_describe(cfg),
            "params": [params_digest(p) for p in variant_params]}
    return digest_of(desc)


def _devices(device: torch.device, shard_devices):
    """The ranks a replication axis could shard over: ``shard_devices``
    where given (ranks are processes, and several share one card or the
    CPU), else one a card of the engine's device type (one for the
    CPU)."""
    if shard_devices:
        return int(shard_devices)
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _grid_rank(mesh, policies, n_seeds, C, jobs_per, horizon_ms,
               drain_ticks, fresh):
    """One rank's share of a sharded grid (run by ``parallel.launch``):
    the lanes of the fresh variants over this rank's block of seeds, as
    one lane-stacked run on the rank's device. Returns ``{"cells": {(v,
    si): numpy leaves}, "launches": {source: n}, "wall_s": s}``, the wall
    taken between two barriers of the mesh."""
    import torch.distributed as dist

    from multi_cluster_simulator_tpu_torch import interop, tenancy
    from multi_cluster_simulator_tpu_torch.core.engine import Engine
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.policies.base import (
        REGISTRY, PolicySet,
    )

    if any(name not in REGISTRY for name in policies):
        sweep_policies()
    dev = mesh.device
    pset = PolicySet(tuple(policies))
    cfg, specs, n_ticks, _seeds, padded, _tas = grid_inputs(
        n_seeds, C, jobs_per, horizon_ms, drain_ticks)
    variant_params = [pset.params_for(cfg, name, device=dev)
                      for name in policies]
    per = n_seeds // mesh.size
    lanes = [(v, si) for v in fresh
             for si in range(mesh.rank * per, (mesh.rank + 1) * per)]
    params, sta, s0 = stack_grid(lanes, variant_params, padded, cfg, specs,
                                 dev)
    eng = Engine(cfg, device=dev, policies=pset)
    fused_tick.reset_launches()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier(group=mesh.group)
        return time.time()

    t0 = sync()
    grid = eng.run(s0, sta, n_ticks, params)
    wall = sync() - t0
    return {"cells": {lane: interop.to_numpy(tenancy.tenant_cell(grid, i))
                      for i, lane in enumerate(lanes)},
            "launches": {k: n for k, n in source_launches(
                fused_tick.launch_counts()).items() if n},
            "wall_s": wall}


def _diff_leaves(a, b) -> list:
    """Key paths where two states differ (every leaf, bitwise)."""
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    out = []
    for (k, x), (_, y) in zip(leaves_with_keys(a), leaves_with_keys(b)):
        if x.dtype == torch.uint32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.shape != y.shape or not torch.equal(x, y):
            out.append(k)
    return out


def source_launches(counts: dict) -> dict:
    """{kernel source: launches} from ``fused_tick.launch_counts()``: every
    form of one source (emit, expire, faults, tap) counts for it."""
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick

    out: dict = {}
    for name, n in counts.items():
        lib = fused_tick.KERNELS[name].lib
        out[lib] = out.get(lib, 0) + n
    return out


def grid_inputs(n_seeds, C, jobs_per, horizon_ms, drain_ticks):
    """The grid's world: ``(cfg, specs, n_ticks, seeds, padded buckets,
    unpadded buckets)`` — a stream a seed (17, 18, ...), demands up to 24
    cores on 32-core nodes, so both demand-shape classes exist and the
    grid runs loaded and every swept parameter steers."""
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    cfg = _cfg(jobs_per=jobs_per)
    n_ticks = horizon_ms // cfg.tick_ms + drain_ticks  # drain tail
    seeds = list(range(17, 17 + n_seeds))
    arrs = [uniform_stream(C, jobs_per, horizon_ms, max_cores=24,
                           max_mem=18_000, max_dur_ms=30_000, seed=s)
            for s in seeds]
    padded, tas = _pack_seeds(arrs, n_ticks, cfg.tick_ms)
    return cfg, _specs(C), n_ticks, seeds, padded, tas


def stack_grid(lanes, variant_params, padded, cfg, specs, dev):
    """The lane-stacked run of ``lanes`` [(variant, seed index), ...]:
    ``(params, arrivals, state)``, each lane a cell's own parameters, its
    seed's padded buckets and a fresh constellation on ``dev``."""
    from multi_cluster_simulator_tpu_torch import tenancy
    from multi_cluster_simulator_tpu_torch.core.state import init_state

    params = tenancy.stack_lanes([variant_params[v] for v, _ in lanes])
    sta = tenancy.stack_tick_arrivals([padded[si] for _, si in lanes])
    s0 = tenancy.stack_tenant_states(
        [init_state(cfg, specs, device=dev) for _ in lanes])
    return params, sta, s0


def run_tournament(policies=DEFAULT_POLICIES, n_seeds=4, C=64, jobs_per=120,
                   horizon_ms=240_000, drain_ticks=80, verify_cells=True,
                   shard_seeds="auto", device_ab=False, shard_devices=None,
                   resume_path=None, device=None):
    """Run the (policy, seed) grid as one lane-stacked run; returns the
    tournament detail dict, the reference's keys except two: ``device``
    (the torch device) where the reference reports its ``backend``, and
    ``kernel_launches`` ({source: launches} of the grid run) where it
    reports ``compiled_programs``.

    Gates (raise on violation): each kernel source launched at most once
    a tick over all lanes; every cell bitwise its standalone
    single-policy run (``verify_cells``); no cell drops work.
    ``resume_path``, ``shard_seeds``, ``device_ab`` and ``shard_devices``
    mean what they mean in the reference, the devices being ranks: a
    sharded grid runs its seed blocks on ``shard_devices`` rank processes
    (``_grid_rank``; the launch gate then holds a rank), ``device_ab``
    re-runs it in this process and holds the two grids bitwise equal
    (``replication_shard_ab``). ``device`` defaults to the card."""
    from multi_cluster_simulator_tpu_torch import tenancy
    from multi_cluster_simulator_tpu_torch.core.engine import Engine
    from multi_cluster_simulator_tpu_torch.core.state import (
        init_state, resolve_device,
    )
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.obs.profile import (
        annotate_dispatch,
    )
    from multi_cluster_simulator_tpu_torch.policies.base import (
        PolicySet, params_digest,
    )

    dev = resolve_device(device)
    policies = tuple(policies)
    pset = PolicySet(policies)
    t_pack0 = time.time()
    cfg, specs, n_ticks, seeds, padded, tas = grid_inputs(
        n_seeds, C, jobs_per, horizon_ms, drain_ticks)
    pack_s = time.time() - t_pack0

    n_dev = _devices(dev, shard_devices)
    sharded = (shard_seeds == "always"
               or (shard_seeds == "auto" and n_dev > 1
                   and dev.type != "cpu")) \
        and n_seeds % max(n_dev, 1) == 0 and n_dev > 1
    if shard_seeds == "always" and not sharded:
        raise AssertionError(
            f"--shard always cannot engage: {n_dev} device(s), {n_seeds} "
            "seeds — need >1 device and a seed count divisible by it")
    if device_ab and not sharded:
        if device_ab == "auto":
            device_ab = False
        else:
            raise AssertionError(
                "--device-ab requires a sharded replication axis "
                f"({n_dev} device(s), {n_seeds} seeds)")
    eng = Engine(cfg, device=dev, policies=pset)
    variant_params = [pset.params_for(cfg, name, device=dev)
                      for name in policies]

    # --resume: the verified-cell cache (grid-digest keyed)
    resume_cells: dict = {}
    grid_dig = None
    if resume_path is not None:
        if not verify_cells:
            raise ValueError(
                "--resume requires cell verification (verify_cells=True): "
                "only verified cells are ever persisted, so an unverified "
                "sweep has nothing legal to cache")
        grid_dig = _grid_digest(policies, seeds, C, jobs_per, horizon_ms,
                                drain_ticks, cfg, variant_params)
        if os.path.exists(resume_path):
            with open(resume_path) as f:
                cache = json.load(f)
            if cache.get("grid_digest") != grid_dig:
                raise ValueError(
                    f"{resume_path}: tournament resume cache was written "
                    f"for a different grid (digest "
                    f"{cache.get('grid_digest')!r} vs {grid_dig!r}) — the "
                    "lineup, seeds, shape, config, or param leaves "
                    "changed; delete the cache or point --resume elsewhere")
            resume_cells = dict(cache.get("completed", {}))

    def _persist(name, rows_for_variant):
        if resume_path is None:
            return
        resume_cells[name] = rows_for_variant
        tmp = resume_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"grid_digest": grid_dig,
                       "completed": resume_cells}, f, indent=1)
        os.replace(tmp, resume_path)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time()

    fresh = [v for v, name in enumerate(policies)
             if name not in resume_cells]
    # one lane a (fresh variant, seed) cell
    lanes = [(v, si) for v in fresh for si in range(n_seeds)]
    cell_of = {lane: i for i, lane in enumerate(lanes)}

    def one_process_grid():
        params, sta, s0 = stack_grid(lanes, variant_params, padded, cfg,
                                     specs, dev)
        fused_tick.reset_launches()
        t0 = sync()
        with annotate_dispatch("tournament", variants=len(fresh),
                               seeds=n_seeds):
            out = eng.run(s0, sta, n_ticks, params)
        wall = sync() - t0
        return out, {k: n for k, n in source_launches(
            fused_tick.launch_counts()).items() if n}, wall

    def check_launches(launches, what):
        over = {k: n for k, n in launches.items() if n > n_ticks}
        if over:
            raise AssertionError(
                f"tournament launched {over} over {n_ticks} ticks of "
                f"{what} — each kernel source must launch at most once a "
                "tick over all its lanes")

    grid = sharded_cells = None
    launches = {}
    tournament_wall = 0.0
    if lanes and sharded:
        from multi_cluster_simulator_tpu_torch import interop
        from multi_cluster_simulator_tpu_torch.parallel.launch import (
            RankGroup,
        )
        with RankGroup(n_dev, device=None if dev.type == "cuda"
                       else str(dev)) as ranks:
            parts = ranks.run(n_dev, _grid_rank, policies, n_seeds, C,
                              jobs_per, horizon_ms, drain_ticks, fresh)
        sharded_cells = {}
        for r, part in enumerate(parts):
            check_launches(part["launches"], f"rank {r}'s lanes")
            sharded_cells.update(part["cells"])
        launches = [part["launches"] for part in parts]
        tournament_wall = max(part["wall_s"] for part in parts)
        host_cells = {lane: interop.state_from_numpy(leaves, dev)
                      for lane, leaves in sharded_cells.items()}
    elif lanes:
        grid, launches, tournament_wall = one_process_grid()
        check_launches(launches, f"{len(lanes)} lanes")

    def cell(v, si):
        if sharded_cells is not None:
            return host_cells[(v, si)]
        return tenancy.tenant_cell(grid, cell_of[(v, si)])

    shard_ab = None
    if device_ab and sharded and lanes:
        # the same grid in this one process: the two grids bitwise equal
        # (sharding is invisible) and both walls, ranks sharing the card
        one, _, one_wall = one_process_grid()
        bad = sorted({(policies[v], seeds[si]) for (v, si) in lanes
                      if _diff_leaves(cell(v, si), tenancy.tenant_cell(
                          one, cell_of[(v, si)]))})
        if bad:
            raise AssertionError(
                "sharded replication grid diverges from the one-process "
                f"grid in cells {bad} — sharding must be invisible")
        shard_ab = {"devices": n_dev,
                    "sharded_wall_s": round(tournament_wall, 3),
                    "single_device_wall_s": round(one_wall, 3),
                    "device_speedup": round(
                        one_wall / max(tournament_wall, 1e-9), 2),
                    "grids_bit_identical": True}

    # the serial per-policy loop: the pre-zoo workflow (one Engine a
    # variant, one run a seed), both the recorded baseline wall and the
    # bit-equality oracle for every cell; skipped under verify_cells=False
    # and for resumed variants
    serial_wall = None
    mismatches = []
    variant_rows: dict = {}

    def _rows_for(v, name):
        digest = params_digest(variant_params[v])
        out = []
        for si, s in enumerate(seeds):
            stats = _cell_stats(cell(v, si), C, jobs_per)
            if any(stats["drops"].values()):
                raise AssertionError(
                    f"tournament cell ({name}, seed {s}) dropped work "
                    f"({stats['drops']}) — resize the tournament config")
            out.append({"policy": name, "params_digest": digest,
                        "seed": s, **stats})
        return out

    if verify_cells:
        serial_wall = 0.0
        for v, name in enumerate(policies):
            if v not in fresh:
                continue  # resumed variant
            t0 = sync()
            eng1 = Engine(cfg, device=dev, policies=PolicySet((name,)))
            refs = [eng1.run(init_state(cfg, specs, device=dev), tas[si],
                             n_ticks) for si in range(n_seeds)]
            serial_wall += sync() - t0
            bad = False
            for si, ref in enumerate(refs):
                if _diff_leaves(cell(v, si), ref):
                    mismatches.append((name, seeds[si]))
                    bad = True
            if not bad:
                variant_rows[name] = _rows_for(v, name)
                _persist(name, variant_rows[name])
    if mismatches:
        raise AssertionError(
            "tournament cells diverge from their standalone runs: "
            f"{sorted(set(mismatches))}")

    rows = []
    resumed_variants = []
    for v, name in enumerate(policies):
        if name in variant_rows:
            rows.extend(variant_rows[name])
        elif v not in fresh and name in resume_cells:
            resumed_variants.append(name)
            rows.extend([{**r, "resumed": True} for r in resume_cells[name]])
        else:  # verify_cells=False: stats straight off the grid
            rows.extend(_rows_for(v, name))

    # rank: most work placed, then lowest mean wait, aggregated over seeds
    agg = {}
    for r in rows:
        a = agg.setdefault(r["policy"], {"policy": r["policy"],
                                         "params_digest": r["params_digest"],
                                         "placed": 0, "waits": []})
        a["placed"] += r["placed"]
        a["waits"].append(r["mean_avg_wait_ms"])
    ranking = sorted(agg.values(),
                     key=lambda a: (-a["placed"], float(np.mean(a["waits"]))))
    for i, a in enumerate(ranking):
        a["rank"] = i + 1
        a["mean_avg_wait_ms"] = round(float(np.mean(a.pop("waits"))), 1)

    detail = {
        "policies": list(policies), "seeds": seeds, "clusters": C,
        "jobs_per_cluster": jobs_per, "cells": len(policies) * n_seeds,
        "ticks": n_ticks,
        "device": str(dev), "devices": n_dev,
        "replication_axis_sharded": bool(sharded),
        "lanes": len(lanes),
        "kernel_launches": launches,
        **({"replication_shard_ab": shard_ab} if shard_ab else {}),
        "pack_once_s": round(pack_s, 3),
        "tournament_wall_s": round(tournament_wall, 3),
        "cells_bit_identical_to_standalone": bool(verify_cells),
        **({"resumed_variants": resumed_variants,
            "grid_digest": grid_dig} if resume_path is not None else {}),
        "ranking": ranking,
        "rows": rows,
    }
    if serial_wall is not None:
        detail["serial_loop_wall_s"] = round(serial_wall, 3)
        detail["speedup_vs_serial"] = round(
            serial_wall / max(tournament_wall, 1e-9), 2)
    return detail


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policies", nargs="+", default=list(DEFAULT_POLICIES))
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--clusters", type=int, default=64)
    ap.add_argument("--jobs", type=int, default=120)
    ap.add_argument("--horizon-ms", type=int, default=240_000)
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke shape (4 policies x 2 seeds, small grid)")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the per-cell standalone equality check "
                         "(also skips the serial baseline wall)")
    ap.add_argument("--shard", choices=("auto", "always", "never"),
                    default="auto",
                    help="shard the replication (seed) axis over rank "
                         "processes (--shard-devices of them)")
    ap.add_argument("--shard-devices", type=int, default=None,
                    help="ranks of the sharded replication axis (they "
                         "share the card)")
    ap.add_argument("--device-ab", action="store_true",
                    help="the sharded/single-device A/B (needs a sharded "
                         "replication axis)")
    ap.add_argument("--resume", metavar="PATH", default=None,
                    help="verified-cell cache: completed (policy, seed) "
                         "results persist here with the grid digest")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=os.path.join("build", "tournament.json"))
    args = ap.parse_args(argv)
    policies = tuple(args.policies)
    kw = dict(policies=policies, n_seeds=args.seeds,
              C=args.clusters, jobs_per=args.jobs,
              horizon_ms=args.horizon_ms,
              verify_cells=not args.no_verify,
              shard_seeds=args.shard, device_ab=args.device_ab,
              shard_devices=args.shard_devices,
              resume_path=args.resume, device=args.device)
    if args.quick:
        kw.update(policies=policies[:4], n_seeds=2, C=16, jobs_per=60,
                  horizon_ms=120_000)
    detail = run_tournament(**kw)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(detail, f, indent=2)
    speed = detail.get("speedup_vs_serial", "n/a (--no-verify)")
    print(f"# {detail['cells']} cells as {detail['lanes']} lanes, launches "
          f"{detail['kernel_launches']} over {detail['ticks']} ticks, "
          f"{speed}x vs serial loop", file=sys.stderr)
    print("| rank | policy | params | placed | mean avg wait (ms) |")
    print("|---|---|---|---|---|")
    for a in detail["ranking"]:
        print(f"| {a['rank']} | {a['policy']} | {a['params_digest']} | "
              f"{a['placed']} | {a['mean_avg_wait_ms']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
