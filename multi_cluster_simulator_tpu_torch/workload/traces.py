"""Bulk workload synthesis for the scale harness (the port's copies of
``uniform_stream``, ``borg_like_stream``, ``bursty_stream`` and
``from_arrays`` from ``multi_cluster_simulator_tpu/workload/traces.py``;
host numpy, pinned equal to the originals by tests/test_torch_copies.py).

``uniform_stream`` — N jobs per cluster with sorted-uniform arrival times —
is the load shape of the headline benchmark; ``borg_like_stream`` — heavy
tails and a diurnal arrival intensity — is the Borg-like replay's;
``bursty_stream`` — bursts with quiet valleys between — is the shape the
event-compressed driver leaps over; ``from_arrays`` replays a loaded trace
(workload/borg.py). The on-device generative draw is a later slice
(ROADMAP A14).
"""

from __future__ import annotations

import numpy as np

from multi_cluster_simulator_tpu_torch.core.state import Arrivals


def _pack(t, cores, mem, dur, gpu=None):
    C, A = t.shape
    order = np.argsort(t, axis=1, kind="stable")
    g = lambda a: np.take_along_axis(a, order, axis=1).astype(np.int32)  # noqa: E731
    return Arrivals(
        t=g(t), id=np.broadcast_to(np.arange(A, dtype=np.int32), (C, A)).copy(),
        cores=g(cores), mem=g(mem),
        gpu=np.zeros((C, A), np.int32) if gpu is None else g(gpu),
        dur=g(dur), n=np.full((C,), A, np.int32))


def uniform_stream(n_clusters: int, jobs_per_cluster: int, horizon_ms: int,
                   max_cores: int, max_mem: int, max_dur_ms: int,
                   seed: int = 0, beta: float = 2.0,
                   max_gpus: int = 0, gpu_frac: float = 0.0) -> Arrivals:
    """Sorted-uniform arrivals; Beta(b,b) sizes (the reference's job-size
    family, client.go:87-99); uniform durations. With ``max_gpus > 0``, a
    ``gpu_frac`` fraction of jobs additionally request 1..max_gpus
    accelerators."""
    rng = np.random.Generator(np.random.PCG64(seed))
    C, A = n_clusters, jobs_per_cluster
    t = rng.integers(0, horizon_ms, (C, A))
    cores = np.floor(rng.beta(beta, beta, (C, A)) * max_cores)
    mem = np.floor(rng.beta(beta, beta, (C, A)) * max_mem)
    dur = rng.integers(0, max_dur_ms, (C, A))
    gpu = None
    if max_gpus > 0:
        gpu = np.where(rng.random((C, A)) < gpu_frac,
                       rng.integers(1, max_gpus + 1, (C, A)), 0)
    return _pack(t, cores, mem, dur, gpu)


def borg_like_stream(n_clusters: int, jobs_per_cluster: int, horizon_ms: int,
                     max_cores: int, max_mem: int, seed: int = 0) -> Arrivals:
    """Borg-2019-shaped synthetic trace (heavy tails + diurnal arrivals)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    C, A = n_clusters, jobs_per_cluster
    # diurnal arrival times by inverse-CDF of 1 + 0.6*sin(2*pi*t/day)
    u = rng.random((C, A))
    grid = np.linspace(0.0, 1.0, 1025)
    day_ms = 86_400_000.0
    intens = 1.0 + 0.6 * np.sin(2 * np.pi * grid * horizon_ms / day_ms)
    cdf = np.cumsum(intens)
    cdf = (cdf - cdf[0]) / (cdf[-1] - cdf[0])
    t = np.interp(u, cdf, grid) * horizon_ms
    # heavy-tailed sizes: lognormal cores clipped to node size
    cores = np.clip(np.round(np.exp(rng.normal(0.4, 1.0, (C, A)))), 1,
                    max_cores)
    mem_frac = np.clip(rng.normal(0.6, 0.35, (C, A)), 0.05, 2.0)
    mem = np.clip(np.round(cores / max_cores * max_mem * mem_frac), 1,
                  max_mem)
    # lognormal durations, median ~90 s, clipped to 1 h
    dur = np.clip(np.exp(rng.normal(np.log(90_000.0), 1.2, (C, A))), 1_000,
                  3_600_000)
    return _pack(t, cores, mem, dur)


def bursty_stream(n_clusters: int, bursts: int, jobs_per_burst: int,
                  interval_ms: int, window_ms: int, max_cores: int,
                  max_mem: int, max_dur_ms: int, seed: int = 0,
                  beta: float = 2.0) -> Arrivals:
    """Burst-sparse arrivals: ``bursts`` bursts per cluster of
    ``jobs_per_burst`` jobs each, burst ``b``'s jobs landing uniformly in
    ``[b*interval_ms, b*interval_ms + window_ms)``. With ``max_dur_ms +
    window_ms`` well under ``interval_ms`` the constellation drains and
    idles between bursts, so most ticks are provably no-ops."""
    rng = np.random.Generator(np.random.PCG64(seed))
    C, A = n_clusters, bursts * jobs_per_burst
    base = np.repeat(np.arange(bursts, dtype=np.int64) * interval_ms,
                     jobs_per_burst)  # [A]
    t = base[None, :] + rng.integers(0, window_ms, (C, A))
    cores = np.floor(rng.beta(beta, beta, (C, A)) * max_cores)
    mem = np.floor(rng.beta(beta, beta, (C, A)) * max_mem)
    dur = rng.integers(0, max_dur_ms, (C, A))
    return _pack(t, cores, mem, dur)


def from_arrays(t_ms, cores, mem, dur_ms, gpus=None) -> Arrivals:
    """Replay an externally loaded trace (a parsed Borg file, say): [C, A]
    arrays, times not necessarily sorted."""
    return _pack(np.asarray(t_ms), np.asarray(cores), np.asarray(mem),
                 np.asarray(dur_ms),
                 None if gpus is None else np.asarray(gpus))
