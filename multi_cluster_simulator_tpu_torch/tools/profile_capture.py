"""Profile capture: a per-phase cost table from the engine's phase-prefix
ablation, and a ``torch.profiler`` trace around a bench-shaped run (the
port of ``tools/profile_capture.py``, which imports jax).

The ablation runs the real tick truncated after its first k phases
(``Engine.run_prefix`` with ``phase_limit=k``, obs.profile.TICK_PHASES
order), so phase k's cost at a shape is wall(prefix k) - wall(prefix k-1)
on whatever config is profiled. Each row names its route: from phase 5
(schedule) up the prefix is the config's hand-written kernel on the card;
below it, and on the CPU, the plain PyTorch ops. Each row's
``prefix_bytes_delta`` is the port's own count: the bytes (each element at
its storage size) of the state leaves whose value after the run at prefix
k differs from the run at prefix k-1. The trace is orthogonal: the tick's
phases are ``tick.<phase>`` ranges and the dispatch sites
``mcs.dispatch.<name>`` ranges, so the Chrome trace attributes time per
phase, the card's kernels beside them.

Usage:
  python -m multi_cluster_simulator_tpu_torch.tools.profile_capture \\
      --config headline --quick --device cpu --out DIR
  python -m multi_cluster_simulator_tpu_torch.tools.profile_capture \\
      --config delay --ticks 200 --no-trace

Exit is nonzero if the table is empty or NaN, or (unless --no-trace) the
trace session wrote no artifact.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch


def _build(config: str, quick: bool):
    """(cfg, specs, arrivals) for a profile shape: the reference tool's,
    bench.py's configs at profile-friendly scale."""
    from multi_cluster_simulator_tpu_torch.config import (
        PolicyKind, SimConfig, TraderConfig,
    )
    from multi_cluster_simulator_tpu_torch.core.spec import uniform_cluster
    from multi_cluster_simulator_tpu_torch.workload.traces import (
        uniform_stream,
    )

    if config == "headline":
        C = 256 if quick else 4096
        cfg = SimConfig(policy=PolicyKind.FIFO, queue_capacity=8,
                        max_running=32, max_arrivals=250,
                        max_ingest_per_tick=8, parity=True, n_res=2,
                        max_nodes=5, max_virtual_nodes=0)
    elif config == "delay":
        C = 64 if quick else 512
        cfg = SimConfig(policy=PolicyKind.DELAY, queue_capacity=64,
                        max_running=128, max_arrivals=250, parity=True,
                        n_res=2, max_nodes=5, max_virtual_nodes=0)
    elif config == "trader":
        C = 16 if quick else 64
        cfg = SimConfig(policy=PolicyKind.DELAY, queue_capacity=64,
                        max_running=128, max_arrivals=250, parity=False,
                        n_res=3, max_nodes=5, max_virtual_nodes=4,
                        trader=TraderConfig(enabled=True))
    else:
        raise SystemExit(f"unknown --config {config}")
    specs = [uniform_cluster(c + 1, 5) for c in range(C)]
    arrivals = uniform_stream(C, 250, 1_500_000, max_cores=8, max_mem=6_000,
                              max_dur_ms=60_000, seed=9)
    return cfg, specs, arrivals


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def changed_bytes(a, b) -> int:
    """Bytes of the leaves of two states that differ, each element at its
    storage size."""
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    return sum(x.numel() * x.element_size() for (_, x), (_, y) in
               zip(leaves_with_keys(a), leaves_with_keys(b))
               if not torch.equal(x, y))


def phase_table(engine, state0, ta, n_ticks: int, repeats: int = 3,
                warmups: int = 1) -> dict:
    """Per-phase ms/tick by the cumulative phase-prefix ablation: for
    k = 0..len(TICK_PHASES), ``warmups`` then ``repeats`` runs of
    ``run_prefix(copy of state0, ta, n_ticks, k)``, each timed with the
    host read of its clock inside the timer; the min of the timed walls
    per tick. Returns ``{"rows", "full_ms", "last"}``: a row per phase
    (``phase``, ``cum_ms_per_tick``, ``ms_per_tick``, ``fraction``,
    ``route``, ``launches_per_tick``, ``prefix_bytes_delta``) then the
    carry/clock row (k = 0), and the state the last prefix (the whole
    tick) left."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.kernels import fused_tick
    from multi_cluster_simulator_tpu_torch.obs.profile import TICK_PHASES

    kernel = engine.fused_provenance()["kernel"]
    dev = state0.device
    cum, routes, per_tick, deltas = [], [], [], []
    prev = state0
    for k in range(len(TICK_PHASES) + 1):
        before = sum(fused_tick.launch_counts().values())
        walls = []
        for i in range(warmups + repeats):
            s = clone_state(state0)
            _sync(dev)
            t0 = time.perf_counter()
            out = engine.run_prefix(s, ta, n_ticks, k)
            int(out.t)  # a host read inside the timer
            if i >= warmups:
                walls.append(time.perf_counter() - t0)
        launched = sum(fused_tick.launch_counts().values()) - before
        cum.append(min(walls) / n_ticks * 1e3)
        routes.append(kernel if engine.fused_active() and k >= 5
                      else "plain")
        per_tick.append(launched / ((warmups + repeats) * n_ticks))
        deltas.append(changed_bytes(prev, out))
        prev = out
    full = cum[-1]

    def frac(x):
        return round(x / full, 4) if full > 0 else 0.0

    rows = [{"phase": name, "cum_ms_per_tick": round(cum[i + 1], 4),
             "ms_per_tick": round(cum[i + 1] - cum[i], 4),
             "fraction": frac(cum[i + 1] - cum[i]), "route": routes[i + 1],
             "launches_per_tick": per_tick[i + 1],
             "prefix_bytes_delta": deltas[i + 1]}
            for i, name in enumerate(TICK_PHASES)]
    rows.append({"phase": "(carry/clock)", "cum_ms_per_tick": round(cum[0], 4),
                 "ms_per_tick": round(cum[0], 4), "fraction": frac(cum[0]),
                 "route": routes[0], "launches_per_tick": per_tick[0],
                 "prefix_bytes_delta": deltas[0]})
    return {"rows": rows, "full_ms": full, "last": prev}


def capture_trace(engine, state0, ta, n_ticks: int, out_dir: str) -> list:
    """One ``start_trace``/``stop_trace`` session around ``run`` over
    ``n_ticks`` (after an untraced warm-up run); returns the artifacts it
    wrote under ``out_dir``."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state
    from multi_cluster_simulator_tpu_torch.obs import profile as prof

    engine.run(clone_state(state0), ta, n_ticks)
    state = clone_state(state0)
    _sync(state.device)
    prof.start_trace(out_dir)
    try:
        with prof.annotate_dispatch("profile_capture"):
            out = engine.run(state, ta, n_ticks)
            int(out.t)
    finally:
        prof.stop_trace()
    return prof.trace_artifacts(out_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m multi_cluster_simulator_tpu_torch.tools."
             "profile_capture")
    ap.add_argument("--config", default="headline",
                    choices=("headline", "delay", "trader"))
    ap.add_argument("--quick", action="store_true",
                    help="small shapes (the CI smoke)")
    ap.add_argument("--ticks", type=int, default=None,
                    help="ticks per timed run (default 50 quick / 400)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="trace and table directory (default "
                         "./profile_capture)")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the profiler capture; only the table")
    args = ap.parse_args(argv)

    from multi_cluster_simulator_tpu_torch.core.engine import (
        Engine, pack_arrivals_by_tick,
    )
    from multi_cluster_simulator_tpu_torch.core.state import init_state

    n_ticks = args.ticks or (50 if args.quick else 400)
    out_dir = args.out or "profile_capture"
    os.makedirs(out_dir, exist_ok=True)
    cfg, specs, arrivals = _build(args.config, args.quick)
    engine = Engine(cfg, device=args.device)
    state0 = init_state(cfg, specs, device=engine.device)
    ta = pack_arrivals_by_tick(arrivals, n_ticks, cfg.tick_ms)
    fused = engine.fused_provenance()
    print(f"# profile_capture: config={args.config} clusters={len(specs)} "
          f"ticks={n_ticks} device={engine.device} kernel={fused['kernel']}",
          file=sys.stderr)

    table = phase_table(engine, state0, ta, n_ticks, repeats=args.repeats)
    rows, full = table["rows"], table["full_ms"]
    if not rows or not math.isfinite(full) or full <= 0 or any(
            not math.isfinite(r["ms_per_tick"]) for r in rows):
        print("profile_capture: per-phase table empty or degenerate",
              file=sys.stderr)
        return 1
    width = max(len(r["phase"]) for r in rows)
    print(f"{'phase':{width}s}  ms/tick   cum      frac   bytes delta  "
          f"route")
    for r in rows:
        print(f"{r['phase']:{width}s}  {r['ms_per_tick']:7.4f}  "
              f"{r['cum_ms_per_tick']:7.4f}  {r['fraction']:6.1%}  "
              f"{r['prefix_bytes_delta']:11d}  {r['route']}")

    artifacts = []
    if not args.no_trace:
        artifacts = capture_trace(engine, state0, ta, n_ticks, out_dir)
        if not artifacts:
            print("profile_capture: trace session produced no artifact",
                  file=sys.stderr)
            return 1
        print(f"# trace: {len(artifacts)} file(s) under {out_dir}",
              file=sys.stderr)

    table_path = os.path.join(out_dir, f"phase_table_{args.config}.json")
    with open(table_path, "w") as f:
        json.dump({"config": args.config, "clusters": len(specs),
                   "ticks": n_ticks, "device": str(engine.device),
                   "quick": args.quick, "full_ms_per_tick": round(full, 4),
                   "fused": fused, "phases": rows,
                   "bytes_basis": "bytes of the state leaves whose value "
                                  "after prefix k differs from prefix k-1, "
                                  "each element at its storage size",
                   "trace_artifacts": artifacts}, f, indent=2)
    print(f"# table: {table_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
