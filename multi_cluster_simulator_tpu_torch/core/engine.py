"""The virtual-time simulation engine (the port of
``multi_cluster_simulator_tpu/core/engine.py``: the FIFO, FFD, DELAY and
scored-zoo slices).

One tick is the reference's tick on the paths the port carries: the
per-cluster prefix ``release -> ingest -> schedule`` and then the clock
advance. The schedule slot runs the member of the engine's ``PolicySet``
that ``params.idx`` selects (FIFO, whose arrivals go to the ReadyQueue;
or DELAY, FFD, gavel, tesserae or rl, whose arrivals go to Level0); the
index is read once at a run's entry. Every later phase (return delivery,
borrow matching, the trader snapshot and market) is off on these paths,
so the prefix is the whole tick. The prefix runs as one hand-written CUDA
kernel per span on the card and as the plain PyTorch ops on the CPU
(kernels/fused_tick.py).

The run loops replace the reference's ``lax.scan``: ``run`` loops over the
ticks of a ``TickArrivals`` bucket, and ``run_chunks`` does what
``bench._engine_run`` does for the headline and the Borg-like replay — a
list of ragged-K chunks, each chunk's rows copied to the device once, the
clock kept on the host, and no host synchronisation inside a chunk.

Configurations outside the slice raise ``NotImplementedError`` naming the
ROADMAP item that ports them; nothing falls back silently.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import SimConfig
from multi_cluster_simulator_tpu_torch.core import state as st
from multi_cluster_simulator_tpu_torch.core.state import (
    Arrivals, SimState, resolve_device,
)
from multi_cluster_simulator_tpu_torch.kernels import fused_tick
from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import runset as R
from multi_cluster_simulator_tpu_torch.policies.base import (
    PolicyParams, PolicySet,
)
from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

_QUEUE_INVALID = np.asarray(F.QUEUE_INVALID, np.int32)


# --------------------------------------------------------------------------
# phase 1: completions
# --------------------------------------------------------------------------

def _release_local(s: SimState, t: int):
    run, free, done = R.release(s.run, s.node_free, t)
    return s.replace(run=run, node_free=free), done


# --------------------------------------------------------------------------
# phase 3: arrivals (host-side bucketing, then the per-tick ingest)
# --------------------------------------------------------------------------

def _bucket_arrivals_host(arr: Arrivals, n_ticks: int, tick_ms: int):
    """The host-side bucketing core behind ``pack_arrivals_by_tick`` and
    ``pack_arrivals_chunks``: each arrival's destination tick and
    rank-in-tick. Returns ``(fields [C, A, NF], dest [C, A], ok [C, A],
    rank [C, A], counts [T, C])``; ``dest`` parks arrivals beyond the
    horizon on a virtual overflow tick ``n_ticks``."""
    t = np.asarray(arr.t)
    C, A = t.shape
    n = np.asarray(arr.n)
    valid = np.arange(A)[None, :] < n[:, None]
    if A > 1 and not np.all(np.diff(t, axis=1)[valid[:, 1:]] >= 0):
        raise ValueError("pack_arrivals_by_tick requires per-cluster "
                         "time-sorted arrivals")
    # tick k has clock (k+1)*tick_ms; int64 so arrivals near 2^31 park on
    # the overflow tick instead of wrapping into tick 0
    dest = np.maximum((t.astype(np.int64) + tick_ms - 1) // tick_ms, 1) - 1
    ok = valid & (dest < n_ticks)
    dest = np.where(ok, dest, n_ticks)
    counts2d = np.zeros((C, n_ticks + 1), np.int32)
    np.add.at(counts2d, (np.arange(C)[:, None], dest), 1)
    firsts = np.zeros((C, n_ticks + 1), np.int64)
    firsts[:, 1:] = np.cumsum(counts2d, axis=1)[:, :-1]
    rank = np.arange(A)[None, :] - firsts[np.arange(C)[:, None], dest]
    vals = {"id": np.asarray(arr.id), "cores": np.asarray(arr.cores),
            "mem": np.asarray(arr.mem), "gpu": np.asarray(arr.gpu),
            "dur": np.asarray(arr.dur), "enq_t": t,
            "owner": np.full_like(t, Q.OWN),
            "rec_wait": np.zeros_like(t),
            "jclass": F.job_class(np.asarray(arr.cores),
                                  np.asarray(arr.gpu)).astype(np.int32),
            "retries": np.zeros_like(t)}
    fields = np.stack([vals[n] for n in F.QUEUE_FIELDS], axis=-1)
    return fields, dest, ok, rank, counts2d.T[:n_ticks].copy()


def pack_arrivals_by_tick(arr: Arrivals, n_ticks: int,
                          tick_ms: int) -> st.TickArrivals:
    """Bucket the stream by destination tick: a job arriving at ``ta`` is
    ingested at the first tick whose clock ``(k+1)*tick_ms >= ta``. Rows
    pad to the stream-global max arrivals per tick; arrivals beyond the
    horizon are dropped."""
    fields, dest, ok, rank, counts = _bucket_arrivals_host(arr, n_ticks,
                                                           tick_ms)
    C = fields.shape[0]
    K = max(int(counts.max(initial=1)), 1)
    rows = np.broadcast_to(_QUEUE_INVALID, (n_ticks, C, K, Q.NF)).copy()
    cc, aa = np.nonzero(ok)
    rows[dest[cc, aa], cc, rank[cc, aa]] = fields[cc, aa]
    return st.TickArrivals(rows=rows, counts=counts)


def round_up_pow2(k: int) -> int:
    """Smallest power of two >= k (>= 1)."""
    return 1 << max(int(k) - 1, 0).bit_length()


def pack_arrivals_chunks(arr: Arrivals, chunk_sizes: Sequence[int],
                         tick_ms: int, start: int = 0,
                         k_bucket=round_up_pow2) -> list[st.TickArrivals]:
    """Ragged per-chunk bucketing: ``pack_arrivals_by_tick`` for a chunked
    run, each chunk's ``[ticks, C, K_chunk, NF]`` rows padded to that
    chunk's own max arrivals per tick, rounded up by ``k_bucket`` and
    clamped at the stream-global max. Chunk ``i`` covers ticks
    ``[start + sum(chunk_sizes[:i]), start + sum(chunk_sizes[:i+1]))``."""
    n_ticks = start + sum(chunk_sizes)
    fields, dest, ok, rank, counts = _bucket_arrivals_host(arr, n_ticks,
                                                           tick_ms)
    C = fields.shape[0]
    cc, aa = np.nonzero(ok)
    d, r = dest[cc, aa], rank[cc, aa]
    order = np.argsort(d, kind="stable")
    d, cc, aa, r = d[order], cc[order], aa[order], r[order]
    bounds = np.searchsorted(d, np.cumsum([start] + list(chunk_sizes)))
    k_global = max(int(counts.max(initial=1)), 1)
    out = []
    off = start
    for i, nt in enumerate(chunk_sizes):
        kc = int(counts[off:off + nt].max(initial=0))
        K = max(min(int(k_bucket(max(kc, 1))), k_global), kc, 1)
        rows = np.broadcast_to(_QUEUE_INVALID, (nt, C, K, Q.NF)).copy()
        sl = slice(bounds[i], bounds[i + 1])
        rows[d[sl] - off, cc[sl], r[sl]] = fields[cc[sl], aa[sl]]
        out.append(st.TickArrivals(rows=rows,
                                   counts=counts[off:off + nt].copy()))
        off += nt
    return out


def _ingest_packed_local(s: SimState, rows: torch.Tensor, cnt: torch.Tensor,
                         to_delay: bool):
    """Enqueue one tick's pre-bucketed arrivals (``rows`` [C, K, NF],
    ``cnt`` [C]): into Level0 for the queue-sweep policies (``to_delay``),
    else into the FIFO ReadyQueue. The drop count reads the target before
    the push, and ``arr_ptr`` advances by ``cnt`` even for dropped rows;
    the Level0 path adds ``cnt`` (not the pushed count) to ``wait_jobs``
    and ``jobs_in_queue``, as the reference does
    (core/engine.py:_ingest_packed_local there)."""
    K = rows.shape[1]
    valid = torch.arange(K, dtype=Q.I32, device=rows.device)[None, :] \
        < cnt[:, None]
    batch = Q.JobQueue(data=rows, count=cnt)
    tgt = s.l0 if to_delay else s.ready
    dropped = Q.push_many_dropped(tgt, valid)
    s = s.replace(drops=s.drops.replace(queue=s.drops.queue + dropped))
    if to_delay:
        s = s.replace(l0=Q.push_many(s.l0, batch, valid, prefix=True),
                      wait_jobs=s.wait_jobs + cnt,
                      jobs_in_queue=s.jobs_in_queue + cnt)
    else:
        s = s.replace(ready=Q.push_many(s.ready, batch, valid, prefix=True))
    return s.replace(arr_ptr=s.arr_ptr + cnt)


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

def _check_slice(cfg: SimConfig) -> None:
    """Refuse, by name, every configuration this slice does not carry."""
    if cfg.n_res not in (2, 3):
        raise ValueError(f"n_res must be 2 or 3, got {cfg.n_res}")
    for field in ("fifo_drain", "ffd_sweep", "delay_sweep"):
        v = getattr(cfg, field)
        if v not in ("wave", "serial"):
            raise ValueError(
                f"{field} must be 'wave' or 'serial', got {v!r}")
    gaps = [
        (cfg.borrowing, "cross-cluster borrowing", "A6"),
        (cfg.trader.enabled, "the trader market", "A7"),
        (cfg.faults.enabled, "the fault plane", "A8"),
        (cfg.record_metrics, "record_metrics (the metrics plane)", "A10"),
    ]
    for hit, what, item in gaps:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP {item}")


class Engine:
    """Runs ticks of ``cfg`` on ``device`` — the card unless the caller
    names another device (``device="cpu"`` runs the plain PyTorch path).
    ``policies`` is the ``PolicySet`` to run (the singleton set of
    ``cfg.policy`` by default). ``run`` and ``run_chunks`` advance the
    state IN PLACE and return it; clone a state first
    (``core.state.clone_state``) to keep the original."""

    def __init__(self, cfg: SimConfig, device=None, policies=None):
        self.pset = policies if policies is not None else \
            PolicySet.from_config(cfg)
        _check_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self._default_params = self.pset.params_for(cfg, device=self.device)

    def member(self, params=None):
        """The ``PolicySpec`` that ``params.idx`` selects (the default
        params' member when None): a host read of the index."""
        params = self._default_params if params is None else params
        return self.pset.member(params.idx)

    def _span_prefix(self, state: SimState, rows: torch.Tensor,
                     counts: torch.Tensor, t: int, params: PolicyParams,
                     member=None) -> SimState:
        """Phases 1-5 of the tick on this slice's paths, as plain PyTorch
        ops: completions, arrival ingest into the member's queue, the
        member's pass. ``member`` is the ``PolicySpec`` ``params.idx``
        selects (read from the index when None). The CUDA kernels are held
        against exactly this function."""
        member = self.member(params) if member is None else member
        state, _ = _release_local(state, t)
        state = _ingest_packed_local(state, rows, counts, member.to_delay)
        state, _, _ = self.pset.dispatch(state, t, params, self.cfg, member)
        return state

    def _tick(self, state: SimState, rows: torch.Tensor,
              counts: torch.Tensor, t: int, params: PolicyParams,
              host: dict) -> SimState:
        """One tick ending at clock ``t`` (a host int): the prefix — the
        whole tick on this path — then the clock."""
        state = fused_tick.fused_prefix(self, state, rows, counts, t, params,
                                        host)
        state.t.fill_(t)
        return state

    def _params(self, params) -> PolicyParams:
        params = self._default_params if params is None else params
        bad = sorted({str(v.device) for _, v in leaves_with_keys(params)}
                     - {str(self.device)})
        if bad:
            raise ValueError(f"params live on {bad}, the engine on "
                             f"{self.device}")
        return params

    def _check_state(self, state: SimState) -> None:
        if state.device != self.device:
            raise ValueError(f"state lives on {state.device}, the engine "
                             f"on {self.device}")

    def run(self, state: SimState, arrivals: st.TickArrivals,
            n_ticks: int, params=None) -> SimState:
        """Advance ``n_ticks`` over a pre-bucketed stream; the bucket's
        rows go to the device once. ``params`` (PolicyParams on the
        engine's device) defaults to the policy's own. The windowed
        ``Arrivals`` form of the reference's ``run`` is not ported."""
        if isinstance(arrivals, Arrivals):
            raise NotImplementedError(
                "the windowed Arrivals ingest is not ported yet: ROADMAP A3; "
                "bucket the stream with pack_arrivals_by_tick")
        if arrivals.rows.shape[0] < n_ticks:
            raise ValueError(
                f"TickArrivals covers {arrivals.rows.shape[0]} ticks, "
                f"run asked for {n_ticks}")
        part = st.TickArrivals(rows=arrivals.rows[:n_ticks],
                               counts=arrivals.counts[:n_ticks])
        return self.run_chunks(state, [part], params)

    def run_chunks(self, state: SimState, chunks: Sequence[st.TickArrivals],
                   params=None) -> SimState:
        """The chunked run of the headline: each chunk's rows and
        counts move to the device in one copy each, then its ticks run
        back to back with no host synchronisation. The clock, the member
        ``params.idx`` selects and every parameter the kernels take from
        the host are read once at entry; the clock is then tracked on the
        host and handed to each tick."""
        self._check_state(state)
        params = self._params(params)
        host = fused_tick.host_params(self, params)
        t = int(state.t)
        tick_ms = self.cfg.tick_ms
        for chunk in chunks:
            rows = torch.from_numpy(np.ascontiguousarray(chunk.rows)).to(
                self.device)
            counts = torch.from_numpy(np.ascontiguousarray(chunk.counts)).to(
                self.device)
            for k in range(rows.shape[0]):
                t += tick_ms
                state = self._tick(state, rows[k], counts[k], t, params,
                                   host)
        return state

    def run_compressed(self, *args, **kwargs):
        raise NotImplementedError(
            "event-compressed time (run_compressed) is not ported yet: "
            "ROADMAP A9")
