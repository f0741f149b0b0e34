"""Bulk workload synthesis for the scale harness (the port's copies of
``uniform_stream``, ``borg_like_stream``, ``bursty_stream`` and
``from_arrays`` from ``multi_cluster_simulator_tpu/workload/traces.py``;
host numpy, pinned equal to the originals by tests/test_torch_copies.py).

``uniform_stream`` — N jobs per cluster with sorted-uniform arrival times —
is the load shape of the headline benchmark; ``borg_like_stream`` — heavy
tails and a diurnal arrival intensity — is the Borg-like replay's;
``bursty_stream`` — bursts with quiet valleys between — is the shape the
event-compressed driver leaps over; ``from_arrays`` replays a loaded trace
(workload/borg.py). ``tick_arrivals_device`` is the environment mode's
generative draw: one tick's rows made on the device from a key, bitwise
the reference's draw of the same key (utils/prng.py).
"""

from __future__ import annotations

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.core.state import Arrivals
from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.utils import prng


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


def tick_arrivals_device(key, t, n_clusters: int, k_max: int, rate,
                         max_cores, max_mem, max_dur_ms, beta=2.0):
    """One tick's arrival rows drawn on the key's device, from ``key``
    ([2] uint32, or [B, 2] for a batch of envs, each its own stream): the
    environment mode's generative workload, bitwise the reference's
    ``workload/traces.tick_arrivals_device`` for the same key. The same
    family as ``uniform_stream`` (Beta(b, b) sizes, uniform durations):
    each of ``k_max`` candidates a cluster is admitted with probability
    ``rate / k_max`` and the admitted count takes the row prefix. The key
    splits in four (admission, cores, mem, durations); Beta(b, b) for an
    integer b is the b-th smallest of 2b - 1 uniforms; the durations are
    ``randint`` over [0, max(max_dur_ms, 1)); sizes are ``floor(x max)``
    in f32. ``t`` (an int or a tensor of the batch's shape) is the tick's
    clock, the rows' ``enq_t``; ids are tick-local (0..k_max-1).

    Returns ``(rows [..., C, K, NF] i32, counts [..., C] i32)``, the slice
    ``Engine.step_tick`` ingests. No host synchronisation."""
    b = int(beta)
    if b != beta or b < 1:
        raise ValueError(f"tick_arrivals_device draws Beta(b, b) for an "
                         f"integer b >= 1 only; got beta={beta}")
    C, K = int(n_clusters), int(k_max)
    ks = prng.split(key, 4)
    ka, kc, km, kd = (ks[..., i, :] for i in range(4))
    lead = tuple(key.shape[:-1])
    thresh = float(np.float32(rate) / np.float32(K))
    admit = prng.uniform(ka, (C, K)) < thresh
    counts = admit.sum(-1, dtype=torch.int32)

    def beta_bb(k):
        u = prng.uniform(k, (C, K, 2 * b - 1))
        return torch.sort(u, dim=-1).values[..., b - 1]

    cores = torch.floor(beta_bb(kc) * float(max_cores)).to(torch.int32)
    mem = torch.floor(beta_bb(km) * float(max_mem)).to(torch.int32)
    dur = prng.randint(kd, (C, K), 0, max(int(max_dur_ms), 1))
    shape = lead + (C, K)
    dev = key.device
    t = torch.as_tensor(t, dtype=torch.int32, device=dev)
    tt = t.reshape(t.shape + (1, 1)).expand(shape)
    zeros = torch.zeros(shape, dtype=torch.int32, device=dev)
    ids = torch.arange(K, dtype=torch.int32, device=dev).expand(shape)
    vals = {"id": ids, "cores": cores, "mem": mem, "gpu": zeros, "dur": dur,
            "enq_t": tt, "owner": torch.full_like(zeros, -1),
            "rec_wait": zeros, "jclass": F.job_class(cores, zeros)
            .to(torch.int32), "retries": zeros}
    rows = torch.stack([vals[n] for n in F.QUEUE_FIELDS], -1)
    return rows, counts
