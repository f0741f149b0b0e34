"""The benchmark's traffic generator: a frozen copy of ``uniform_stream``
from ``multi_cluster_simulator_tpu_torch/workload/traces.py`` (itself the
port's copy of the JAX package's generator), host numpy only.

It is kept here so that a later change to the program cannot move the
yardstick: every cell draws its stream from this file. It returns a
``Stream`` of plain numpy arrays; the harness hands the same arrays to the
program (as its ``Arrivals``) and to the plain reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Stream(NamedTuple):
    """A time-sorted arrival stream, ``[C, A]`` int32 arrays per field and
    the valid length ``n`` [C]."""

    t: np.ndarray
    id: np.ndarray
    cores: np.ndarray
    mem: np.ndarray
    gpu: np.ndarray
    dur: np.ndarray
    n: np.ndarray


def _pack(t, cores, mem, dur, gpu=None) -> Stream:
    C, A = t.shape
    order = np.argsort(t, axis=1, kind="stable")
    g = lambda a: np.take_along_axis(a, order, axis=1).astype(np.int32)  # noqa: E731
    return Stream(
        t=g(t), id=np.broadcast_to(np.arange(A, dtype=np.int32), (C, A)).copy(),
        cores=g(cores), mem=g(mem),
        gpu=np.zeros((C, A), np.int32) if gpu is None else g(gpu),
        dur=g(dur), n=np.full((C,), A, np.int32))


def uniform_stream(n_clusters: int, jobs_per_cluster: int, horizon_ms: int,
                   max_cores: int, max_mem: int, max_dur_ms: int,
                   seed: int = 0, beta: float = 2.0,
                   max_gpus: int = 0, gpu_frac: float = 0.0) -> Stream:
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


GENERATORS = {"uniform_stream": uniform_stream}
