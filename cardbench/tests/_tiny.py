"""Small worlds of the benchmark's configurations, for the CPU tests: the
configuration files with their scale cut and their bounds made tight, so
that a few ticks reach every branch (head-of-line failures, the wait
queue, full running sets, queue drops, the FFD sweep's cap)."""

from __future__ import annotations

import copy

from cardbench import harness

TINY = {
    "fifo4k": {
        "sim": {"max_nodes": 2, "queue_capacity": 4, "max_running": 3,
                "max_arrivals": 40},
        "clusters": {"count": 6, "nodes": 2, "cores": 8, "memory": 6000},
        "stream": {"jobs_per_cluster": 40, "horizon_ms": 30_000,
                   "max_dur_ms": 20_000},
        "drain_ticks": 10,
        "check": {"clusters": 64},
    },
    "ffd64": {
        "sim": {"max_nodes": 3, "queue_capacity": 24, "max_running": 6,
                "max_arrivals": 120, "max_placements_per_tick": 4},
        "clusters": {"count": 4, "nodes": 3, "cores": 8, "memory": 6000},
        "stream": {"jobs_per_cluster": 120, "horizon_ms": 60_000,
                   "max_dur_ms": 20_000},
        "drain_ticks": 20,
        "check": {"clusters": 64},
    },
}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) else v
    return out


def tiny_config(name: str) -> dict:
    return _merge(harness.load_config(name), TINY[name])


def tiny_traffic(name: str, chunk_ticks: int = 16) -> dict:
    return dict(harness.load_traffic(name), chunk_ticks=chunk_ticks)


# The cells whose worlds the harness runs but BENCHMARK.json holds back
# (their runs spread wider than its bounds allow; PERF.md, Open
# questions), with the per-layer metrics each would report: the tests
# drive them through the same harness.
HELD_BACK = [
    ({"name": "fifo4k.chunked", "config": "fifo4k", "traffic": "single",
      "chips": 1},
     ("chunk_copy_ms", "tick_loop_us", "fused_prefix_fifo_roofline",
      "episode_s_p90.host", "device_idle_pct")),
    ({"name": "ffd64.seeds4", "config": "ffd64", "traffic": "lanes4",
      "chips": 1},
     ("chunk_copy_ms", "tick_loop_us", "fused_prefix_ffd_roofline",
      "device_idle_pct")),
]
HELD_BACK_METRICS = {
    "fused_prefix_fifo_roofline": {
        "name": "fused_prefix_fifo_roofline", "unit": "%",
        "better": "higher", "source": "device_trace", "layer": "kernels",
        "moves": "jobs_per_s", "workloads": []},
    "episode_s_p90.host": {
        "name": "episode_s_p90.host", "unit": "s", "better": "lower",
        "source": "host_clock", "layer": "engine: episode tail, host-paced",
        "moves": "jobs_per_s", "workloads": []},
}


def full_manifest() -> dict:
    """BENCHMARK.json with the held-back cells and their metrics."""
    m = copy.deepcopy(harness.load_manifest())
    per_layer = {x["name"]: x for x in m["per_layer"]}
    for name, metric in HELD_BACK_METRICS.items():
        per_layer.setdefault(name, copy.deepcopy(metric))
    for cell, metrics in HELD_BACK:
        m["workloads"].append(dict(cell, why="held back"))
        for name in metrics:
            per_layer[name]["workloads"].append(cell["name"])
    m["per_layer"] = list(per_layer.values())
    return m
