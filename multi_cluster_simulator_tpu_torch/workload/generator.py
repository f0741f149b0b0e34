"""Workload generation — the reference's ``pkg/client`` as data (the port's
copy of ``multi_cluster_simulator_tpu/workload/generator.py``; host numpy,
pinned equal to the original by tests/test_torch_copies.py).

The Go client draws job sizes from Beta(2,2) scaled to the biggest node,
durations from Uniform{0..599} s, and arrival times from either a
per-minute Poisson(λ=10) batch process or Weibull(λ=10, k=3)
inter-arrivals (pkg/client/client.go:85-147). Here the whole stream is
pre-generated into a time-sorted ``Arrivals`` with explicit seeding.

Reproduced quirks: Go's ``time_between_jobs = 60 / jobs`` is integer
division (client.go:116), so a minute's n jobs land on a floor(60/n)-second
grid, and a Poisson draw of 0 emits no jobs; the Weibull draw truncates to
whole seconds before scaling (client.go:143).
"""

from __future__ import annotations

import numpy as np

from multi_cluster_simulator_tpu_torch.config import WorkloadConfig
from multi_cluster_simulator_tpu_torch.core.state import Arrivals


def generate_arrivals(
    cfg: WorkloadConfig,
    n_clusters: int,
    max_arrivals: int,
    horizon_ms: int,
    max_cores: int,
    max_mem: int,
    seed: int | None = None,
) -> Arrivals:
    """Per-cluster arrival streams as numpy arrays. Each cluster gets an
    independent substream (seed + cluster index); job ids are per-cluster
    serials starting at 0 (client.go:91-100)."""
    seed = cfg.seed if seed is None else seed
    C, A = n_clusters, max_arrivals
    out_t = np.zeros((C, A), np.int32)
    out_id = np.full((C, A), -1, np.int32)
    out_cores = np.zeros((C, A), np.int32)
    out_mem = np.zeros((C, A), np.int32)
    out_dur = np.zeros((C, A), np.int32)
    out_n = np.zeros((C,), np.int32)

    for c in range(C):
        rng = np.random.Generator(np.random.PCG64([seed, c]))
        times_ms: list[int] = []
        if cfg.arrival == "poisson":
            minute = 0
            while minute * 60_000 < horizon_ms and len(times_ms) < A:
                n = int(rng.poisson(cfg.poisson_lambda_per_min))
                if n > 0:
                    spacing_s = 60 // n  # Go integer division, client.go:116
                    for i in range(n):
                        t = minute * 60_000 + i * spacing_s * 1_000
                        if t < horizon_ms and len(times_ms) < A:
                            times_ms.append(t)
                minute += 1
        elif cfg.arrival == "weibull":
            t = 0.0
            while t < horizon_ms and len(times_ms) < A:
                gap_s = int(rng.weibull(cfg.weibull_k) * cfg.weibull_lambda_s)
                t += gap_s * 1_000
                if t < horizon_ms:
                    times_ms.append(int(t))
        else:
            raise ValueError(f"unknown arrival process {cfg.arrival!r}")

        n = len(times_ms)
        out_n[c] = n
        out_t[c, :n] = np.sort(np.asarray(times_ms, np.int64)).astype(np.int32)
        out_id[c, :n] = np.arange(n, dtype=np.int32)
        # sizes ~ Beta(2,2) x max node, floored (client.go:97-99)
        out_cores[c, :n] = np.floor(
            rng.beta(cfg.beta_alpha, cfg.beta_beta, n) * max_cores).astype(np.int32)
        out_mem[c, :n] = np.floor(
            rng.beta(cfg.beta_alpha, cfg.beta_beta, n) * max_mem).astype(np.int32)
        out_dur[c, :n] = (rng.integers(0, cfg.max_duration_s, n) * 1_000).astype(np.int32)

    return Arrivals(t=out_t, id=out_id, cores=out_cores, mem=out_mem,
                    gpu=np.zeros((C, A), np.int32), dur=out_dur, n=out_n)


def silence_clusters(arrivals: Arrivals, idx) -> Arrivals:
    """Zero out the named clusters' arrival counts (numpy fancy index or
    slice) — the standard way tests and benches force a cross-cluster
    mechanism to fire: starve some clusters, idle the rest so they can
    only lend/sell."""
    n = np.asarray(arrivals.n).copy()
    n[idx] = 0
    return arrivals.replace(n=n)
