"""The benchmark's harness: finds a cell's configuration, traffic mix and
metrics by name, builds the cell's world from the seed, runs whole
episodes through the program for the measured window, checks the
episodes' final states against the plain reference, and reads the
metrics.

Everything that belongs to one configuration, mix or metric is a file of
its own that this module finds by name:

- ``configs/<config>.json``: the program's ``SimConfig`` fields (``sim``),
  the cluster shape, the stream generator's parameters, the kernel that
  carries the tick, the plain reference's module and the limits of the
  comparison (``check``);
- ``traffic/<mix>.json``: how many seeded streams run as lanes of one
  lane-stacked run, and the chunk length;
- ``metrics/<metric>.py``: a reader with ``read(ctx)`` that returns the
  metric's value or None when the run has nothing to read;
- ``reference/<module>.py``: the plain reference the configuration names;
- ``cost/<module>.py``: the bytes and operations of the configuration's
  kernel, for its roofline share.

An episode is one whole simulation of the cell's world: a copy of the
reset state, ``Engine.run_chunks`` over the whole horizon, and a
synchronisation. Every episode replays the same world.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# the program's package and the packages it must never load
PROGRAM = "multi_cluster_simulator_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_cluster_simulator_tpu")
# ticks the traced segment covers at least (whole episodes)
TRACE_TICKS = 6000
# one sampled tick in this many feeds the roofline shares
COST_STRIDE = 4


# --------------------------------------------------------------------------
# discovery by name
# --------------------------------------------------------------------------

def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                                f"file {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    return _json("configs", name)


def load_traffic(name: str) -> dict:
    return _json("traffic", name)


def _module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"cardbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``."""
    return _module("metrics", name)


def load_reference(name: str):
    return _module("reference", name)


def load_cost(name: str):
    return _module("cost", name)


def metrics_for(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    the trace, the per-layer ones with it, each where its ``workloads``
    (when given) names the cell."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


# --------------------------------------------------------------------------
# the world
# --------------------------------------------------------------------------

def stream_seed(seed: int, lane: int) -> int:
    """Lane ``lane``'s stream seed, derived from the run's ``--seed`` (any
    integer)."""
    ss = np.random.SeedSequence([seed % 2**64, lane])
    return int(ss.generate_state(1, np.uint64)[0])


def n_ticks(config: dict) -> int:
    s = config["stream"]
    return s["horizon_ms"] // config["sim"].get("tick_ms", 1000) \
        + config["drain_ticks"]


def chunk_sizes(total: int, chunk: int) -> list[int]:
    return [chunk] * (total // chunk) + ([total % chunk] if total % chunk
                                         else [])


def make_streams(config: dict, traffic: dict, seed: int) -> list:
    """One stream a lane, from the benchmark's own generator."""
    from cardbench.gen.traces import GENERATORS

    s = dict(config["stream"])
    gen = GENERATORS[s.pop("generator")]
    C = config["clusters"]["count"]
    return [gen(C, s["jobs_per_cluster"], s["horizon_ms"],
                s["max_cores"], s["max_mem"], s["max_dur_ms"],
                seed=stream_seed(seed, lane))
            for lane in range(traffic["lanes"])]


def node_caps(config: dict) -> list[list[int]]:
    """One cluster's [cores, mem] per node slot (every cluster is alike)."""
    cl = config["clusters"]
    slots = config["sim"]["max_nodes"] + config["sim"].get(
        "max_virtual_nodes", 4)
    caps = [[cl["cores"], cl["memory"]]] * cl["nodes"]
    return caps + [[0, 0]] * (slots - cl["nodes"])


@dataclasses.dataclass
class World:
    """What set-up builds once: the engine, the reset state, the packed
    chunks, the streams and the sizes."""

    engine: object
    s0: object
    chunks: list
    streams: list
    lanes: int
    clusters: int
    n_ticks: int
    jobs: int  # jobs an episode offers, every lane


def sim_config(config: dict):
    from multi_cluster_simulator_tpu_torch.config import PolicyKind, SimConfig

    kw = dict(config["sim"])
    kw["policy"] = PolicyKind(kw["policy"])
    return SimConfig(**kw)


def build_world(config: dict, traffic: dict, seed: int, device) -> World:
    """The cell's world through the program's own entry points: its config,
    specs, ``pack_arrivals_chunks`` (ragged chunks), ``init_state`` (or a
    lane-stacked state of ``init_tenant_state``s) and an ``Engine``."""
    from multi_cluster_simulator_tpu_torch.core.engine import (
        Engine, pack_arrivals_chunks,
    )
    from multi_cluster_simulator_tpu_torch.core.spec import uniform_cluster
    from multi_cluster_simulator_tpu_torch.core.state import (
        Arrivals, init_state,
    )
    from multi_cluster_simulator_tpu_torch.tenancy.host import (
        init_tenant_state, pad_tick_arrivals, stack_lanes,
        stack_tick_arrivals,
    )

    cfg = sim_config(config)
    cl = config["clusters"]
    C, L, T = cl["count"], traffic["lanes"], n_ticks(config)
    specs = [uniform_cluster(c + 1, cl["nodes"], cores=cl["cores"],
                             memory=cl["memory"]) for c in range(C)]
    streams = make_streams(config, traffic, seed)
    sizes = chunk_sizes(T, traffic["chunk_ticks"])
    per_lane = [pack_arrivals_chunks(Arrivals(**s._asdict()), sizes,
                                     cfg.tick_ms) for s in streams]
    if L == 1:
        chunks = per_lane[0]
        s0 = init_state(cfg, specs, device=device)
    else:
        chunks = []
        for i in range(len(sizes)):
            k = max(p[i].rows.shape[2] for p in per_lane)
            chunks.append(stack_tick_arrivals(
                [pad_tick_arrivals(p[i], k) for p in per_lane]))
        s0 = stack_lanes([init_tenant_state(cfg, specs, device=device)
                          for _ in range(L)])
    return World(engine=Engine(cfg, device=device), s0=s0, chunks=chunks,
                 streams=streams, lanes=L, clusters=C, n_ticks=T,
                 jobs=sum(int(s.n.sum()) for s in streams))


# --------------------------------------------------------------------------
# episodes and the window
# --------------------------------------------------------------------------

def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def episode(world: World, device):
    """One whole simulation; returns (final state, wall seconds)."""
    from multi_cluster_simulator_tpu_torch.core.state import clone_state

    w0 = time.perf_counter()
    state = clone_state(world.s0)
    state = world.engine.run_chunks(state, world.chunks)
    _sync(device)
    return state, time.perf_counter() - w0


def placed(state) -> int:
    return int(state.placed_total.sum())


@dataclasses.dataclass
class Window:
    start: float
    end: float
    walls: list
    placed: list
    kept: dict  # episode index -> final state


def run_window(world: World, device, seconds: float, keep: int) -> Window:
    """Whole episodes back to back until ``seconds`` have passed. Keeps the
    final states of episode ``keep`` and of the last one for the check."""
    gc.collect()
    gc.freeze()  # set-up's objects: never traversed again by the collector
    walls, done, kept = [], [], {}
    start = time.perf_counter()
    i = 0
    while True:
        state, wall = episode(world, device)
        walls.append(wall)
        done.append(placed(state))
        if i == keep:
            kept[i] = state
        last = (i, state)
        i += 1
        if time.perf_counter() - start >= seconds:
            break
    end = time.perf_counter()
    kept[last[0]] = last[1]
    return Window(start=start, end=end, walls=walls, placed=done, kept=kept)


def p90(values: list) -> float:
    """The 90th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=10, method="inclusive")[-1])


# --------------------------------------------------------------------------
# the check against the plain reference
# --------------------------------------------------------------------------

def sample_clusters(total: int, n: int, seed: int) -> list[int]:
    """``n`` clusters of ``total`` (lanes end to end), one drawn from the
    seed in each of ``n`` equal strata, so the sample spans the batch."""
    n = min(n, total)
    rng = np.random.Generator(np.random.PCG64(stream_seed(seed, 1 << 20)))
    edges = np.linspace(0, total, n + 1).astype(int)
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges[:-1],
                                                        edges[1:])]


_INT_LEAVES = ("node_free", "run.data", "run.active", "placed_total",
               "arr_ptr", "wait_jobs", "jobs_in_queue")


def program_leaves(state, config: dict) -> dict:
    """The leaves of the program's final state that the check compares, on
    the host, in the reference's leaf names: one copy a leaf."""
    from cardbench.reference.sched import DROP_KINDS, QUEUES

    n_res = config["sim"]["n_res"]
    out = {"node_free": state.node_free[..., :n_res],
           "run.data": state.run.data, "run.active": state.run.active,
           "placed_total": state.placed_total, "arr_ptr": state.arr_ptr,
           "wait_jobs": state.wait_jobs,
           "jobs_in_queue": state.jobs_in_queue,
           "wait_total": state.wait_total, "t": state.t}
    for q in QUEUES:
        out[f"{q}.data"] = getattr(state, q).data
        out[f"{q}.count"] = getattr(state, q).count
    for k in DROP_KINDS:
        out[f"drops.{k}"] = getattr(state.drops, k)
    return {k: v.cpu().numpy() for k, v in out.items()}


def cluster_leaves(leaves: dict, lane, c: int) -> dict:
    """Cluster ``c`` (of lane ``lane``; None for one constellation) of
    ``program_leaves``."""
    def pick(x):
        x = x if lane is None else x[lane]
        return x if x.ndim == 0 else x[c]
    return {k: pick(v) for k, v in leaves.items()}


def reference_world(config: dict) -> dict:
    sim = config["sim"]
    return {"policy": sim["policy"], "parity": sim.get("parity", True),
            "queue_capacity": sim["queue_capacity"],
            "max_running": sim["max_running"],
            "max_placements_per_tick": sim.get("max_placements_per_tick", 16),
            "tick_ms": sim.get("tick_ms", 1000), "n_ticks": n_ticks(config),
            "n_res": sim["n_res"], "node_cap": node_caps(config)}


def cluster_stream(stream, c: int) -> dict:
    return {k: getattr(stream, k)[c] for k in ("t", "id", "cores", "mem",
                                               "gpu", "dur", "n")}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared for one cluster: integer elements that differ
    (every leaf but ``wait_total``), and ``wait_total``'s relative gap."""
    bad = 0
    for k, r in ref.items():
        if k == "wait_total":
            continue
        p = np.asarray(prog[k]).astype(np.int64)
        r = np.asarray(r).astype(np.int64)
        bad += int(p.size) if p.shape != r.shape else int((p != r).sum())
    gap = abs(float(prog["wait_total"]) - float(ref["wait_total"])) \
        / max(abs(float(ref["wait_total"])), 1.0)
    return {"int_mismatch": bad, "wait_rel_gap": gap}


def worst(readings: list[dict]) -> dict:
    return {"int_mismatch": sum(r["int_mismatch"] for r in readings),
            "wait_rel_gap": max(r["wait_rel_gap"] for r in readings)}


def reference_leaves(config: dict, streams, picks, **control) -> dict:
    """The reference's final state of each sampled (lane, cluster)."""
    ref = load_reference(config["reference"])
    world = reference_world(config)
    return {(lane, c): ref.replay_cluster(world,
                                          cluster_stream(streams[lane], c),
                                          **control)
            for lane, c in picks}


def lane_picks(world_lanes: int, clusters: int, config: dict,
               seed: int) -> list[tuple[int, int]]:
    flat = sample_clusters(world_lanes * clusters,
                           config["check"]["clusters"], seed)
    return [(i // clusters, i % clusters) for i in flat]


def check(config: dict, world: World, kept: dict, seed: int) -> dict:
    """Hold the kept episodes' final states against the plain reference on
    a sample of whole clusters drawn from the seed. The program's states
    are read to the host and freed before the reference runs. Returns the
    numbers compared, each with its limit, and the per-episode verdicts."""
    picks = lane_picks(world.lanes, world.clusters, config, seed)
    stacked = world.lanes > 1
    prog = {}
    for i in sorted(kept):
        leaves = program_leaves(kept.pop(i), config)
        prog[i] = {(lane, c): cluster_leaves(leaves, lane if stacked else
                                             None, c) for lane, c in picks}
    ref = reference_leaves(config, world.streams, picks)
    limits = config["check"]["limits"]
    per_ep = {i: worst([compare(p[k], ref[k]) for k in picks])
              for i, p in prog.items()}
    numbers = worst(list(per_ep.values()))
    failed = sum(any(r[k] > limits[k] for k in limits)
                 for r in per_ep.values())
    return {"numbers": {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits},
            "episodes_checked": len(per_ep), "clusters_checked": len(picks),
            "failed": failed, "correct": failed == 0}


# --------------------------------------------------------------------------
# the traced segment and the per-tick costs
# --------------------------------------------------------------------------

def traced_segment(world: World, device, ticks: int = TRACE_TICKS):
    """Whole episodes under ``torch.profiler`` (the card's activity too)
    until ``ticks`` ticks are covered, each in a
    ``cardbench.episode`` range; returns the summary ``trace.py`` reads
    from the profiler's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from cardbench import trace as tr

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n_ep = max(1, math.ceil(ticks / world.n_ticks))
    walls = []
    with profile(activities=acts) as prof:
        for _ in range(n_ep):
            with record_function("cardbench.episode"):
                _, wall = episode(world, device)
            walls.append(wall)
    return tr.summarize(prof.events(), walls)


def tick_costs(world: World, device, cost_fn, qc: int) -> list:
    """Replay one episode tick by tick through ``Engine.step_tick`` and
    return, for every ``COST_STRIDE``-th tick, its index and the least
    seconds the card needs for it (``peaks.json``: the larger of its bytes
    over the memory bandwidth and its operations over the peak rate), as
    ``cost_fn(before, after, rows, counts, t, trace, qc)`` counts them."""
    import torch

    from multi_cluster_simulator_tpu_torch.core.state import clone_state

    with open(BENCH / "peaks.json") as f:
        peak = json.load(f)["NVIDIA H100"]
    eng = world.engine
    tick_ms = eng.cfg.tick_ms
    state = clone_state(world.s0)
    t = 0
    g = 0
    out = []
    for chunk in world.chunks:
        rows = torch.from_numpy(np.ascontiguousarray(chunk.rows)).to(device)
        counts = torch.from_numpy(np.ascontiguousarray(chunk.counts)).to(
            device)
        lanes = counts.dim() == 3
        for k in range(counts.shape[1 if lanes else 0]):
            r = rows[:, k] if lanes else rows[k]
            n = counts[:, k] if lanes else counts[k]
            sampled = g % COST_STRIDE == 0
            before = clone_state(state) if sampled else None
            state = eng.step_tick(state, r, n, clock=t)
            t += tick_ms
            if sampled:
                read, written, ops = cost_fn(before, state, r, n, t, False,
                                             qc)
                least = torch.maximum(
                    (read + written).double() / peak["hbm_bytes_per_s"],
                    ops.double() / peak["ops_per_s"])
                out.append((g, least))
            g += 1
    return [(g, float(x)) for g, x in out]


# --------------------------------------------------------------------------
# a whole run
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Ctx:
    """What a metric's reader may read."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: object
    world: World
    setup_s: float
    window: Window
    trace: object = None  # trace.Summary of the traced segment
    _costs: dict = dataclasses.field(default_factory=dict)

    def costs(self, cost_module: str) -> list:
        """(tick, least seconds) of the sampled ticks, by the named cost
        module's ``tick_cost``; computed once a run."""
        if cost_module not in self._costs:
            mod = load_cost(cost_module)
            sim = self.config["sim"]
            qc = (sim["queue_capacity"] if sim.get("parity", True) else
                  min(sim["queue_capacity"],
                      sim.get("max_placements_per_tick", 16)))
            self._costs[cost_module] = tick_costs(self.world, self.device,
                                                  mod.tick_cost, qc)
        return self._costs[cost_module]


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is one the run
    must not load (compared whole: the program's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, manifest: dict | None = None,
             config: dict | None = None, traffic: dict | None = None,
             trace_ticks: int = TRACE_TICKS) -> dict:
    """One run of a cell: set-up, the window, (with ``trace``) the traced
    segment, the check, the metrics. ``config`` and ``traffic`` override
    the files the cell names, and ``trace_ticks`` the traced segment's
    length (the tests run a cell's world at a small size). Returns the result's fields and the check."""
    import torch

    manifest = load_manifest() if manifest is None else manifest
    cell = find_cell(manifest, cell_name)
    config = load_config(cell["config"]) if config is None else config
    traffic = load_traffic(cell["traffic"]) if traffic is None else traffic
    on_card = torch.device(device).type == "cuda"

    world = build_world(config, traffic, seed, device)
    episode(world, device)  # the warm episode: builds and loads the kernel
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    window = run_window(world, device, seconds, keep=seed % 4)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    ctx = Ctx(cell=cell, config=config, traffic=traffic, seed=seed,
              device=device, world=world, setup_s=setup_s, window=window)
    t0 = time.perf_counter()
    if trace:
        ctx.trace = traced_segment(world, device, trace_ticks)
    metrics = {}
    for m in metrics_for(manifest, cell_name, trace):
        value = load_metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t1 = time.perf_counter()
    verdict = check(config, world, window.kept, seed)
    verdict["seconds"] = {"trace_and_metrics": t1 - t0,
                          "check": time.perf_counter() - t1}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": verdict["correct"], "attempted": len(window.walls),
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if trace and ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = verdict["numbers"]
    return {"result": result, "verdict": verdict, "ctx": ctx}
