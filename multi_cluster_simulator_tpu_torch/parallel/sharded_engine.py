"""Multi-rank engine: the cluster axis sharded over a mesh of processes
(the port of ``multi_cluster_simulator_tpu/parallel/sharded_engine.py``).

The reference scales out by launching one scheduler+trader OS process per
cluster and wiring them over HTTP/gRPC (cmd/, SURVEY.md §1); the JAX
package shards every per-cluster array over a device mesh under
``shard_map``. Here every rank of a ``parallel.mesh.Mesh`` is a process
that holds one shard of every per-cluster tensor on its device and runs
the same ``Engine`` over it with a ``MeshExchange``: the per-cluster
phases (the prefix kernel among them, launched once a tick over the
rank's ``C_loc`` clusters) stay local, and the three cross-cluster
decisions (return delivery, borrow matching, the market round) and the
compressed driver's votes ride the group's collectives.

Placement follows the reference's specs: per-cluster leaves split on
their leading axis and the clock replicated (``_state_specs``); an
``Arrivals`` stream split on its cluster axis, a ``TickArrivals`` bucket
on axis 1; the metrics buffer's shard-local partials (``depth_hist``,
``ring_placed``, ``ring_depth``) widened to one row per shard, row 0 kept
(``shard_metrics``). Every rank passes the same global host-built inputs
and keeps its own slice, which is also the multi-process form
(``parallel.multihost``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import SimConfig
from multi_cluster_simulator_tpu_torch.core import state as st
from multi_cluster_simulator_tpu_torch.core.engine import Engine
from multi_cluster_simulator_tpu_torch.obs import device as obs_device
from multi_cluster_simulator_tpu_torch.parallel.exchange import MeshExchange
from multi_cluster_simulator_tpu_torch.parallel.mesh import nearest_divisible
from multi_cluster_simulator_tpu_torch.utils.tree import tree_map

# the MetricsBuffer's per-cluster leaves (the rest are the replicated
# clock rows and the shard-local partials)
_PER_CLUSTER = ("placed", "arrived", "borrows", "wait_accrued", "ovf",
                "depth_sum", "depth_max", "kills", "requeues", "fail_drops",
                "node_down_ms")
_PARTIALS = ("depth_hist", "ring_placed", "ring_depth")


def _per_cluster(fn, state: st.SimState) -> st.SimState:
    """``state`` with ``fn`` applied to every leaf but the clock."""
    return state.replace(**{f.name: tree_map(fn, getattr(state, f.name))
                            for f in dataclasses.fields(state)
                            if f.name != "t"})


def _to(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class ShardedEngine:
    """``Engine`` over this rank's shard of the cluster axis of ``mesh``.

    The number of clusters must divide by the mesh size. ``shard_inputs``
    (or ``shard_state`` / ``shard_arrivals``) takes the global host-built
    state and arrivals and returns this rank's shard on its device;
    ``run_fn`` advances it; ``gather_state`` / ``collect_metrics`` give
    every rank the global view back.
    """

    def __init__(self, cfg: SimConfig, mesh, axis: str = "clusters",
                 policies=None):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
        if not mesh.member:
            raise ValueError("this rank is outside the mesh")
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        self.ex = MeshExchange(mesh)
        self.engine = Engine(cfg, device=mesh.device, ex=self.ex,
                             policies=policies)

    @property
    def n(self) -> int:
        return self.mesh.shape[self.axis]

    def _span(self, C: int) -> slice:
        c_loc = C // self.n
        return slice(self.mesh.rank * c_loc, (self.mesh.rank + 1) * c_loc)

    def check_divisible(self, C: int) -> None:
        """The reference's divisibility error, naming the nearest valid
        cluster counts."""
        n = self.n
        if C % n != 0:
            lo, hi = nearest_divisible(C, n)
            valid = f"{hi}" if lo == 0 else f"{lo} or {hi}"
            raise ValueError(
                f"clusters ({C}) must divide by mesh size ({n}); nearest "
                f"valid cluster counts: {valid} (tools/weak_scaling.py "
                f"auto-pads to {hi} with inert always-full sentinel "
                "clusters)")

    def shard_inputs(self, state: st.SimState, arrivals):
        """This rank's shard of the global ``state`` and ``arrivals``
        (an ``Arrivals`` stream or a ``TickArrivals`` bucket)."""
        self.check_divisible(state.arr_ptr.shape[0])
        return self.shard_state(state), self.shard_arrivals(arrivals)

    def shard_state(self, state: st.SimState) -> st.SimState:
        """Every per-cluster leaf's rows of this rank, the clock whole, on
        the rank's device (copies: the global state stays as it was)."""
        C = state.arr_ptr.shape[0]
        self.check_divisible(C)
        cut = self._span(C)
        dev = self.mesh.device
        out = _per_cluster(lambda x: _to(x[cut], dev).clone(), state)
        return out.replace(t=_to(state.t, dev).clone())

    def shard_arrivals(self, arrivals):
        """This rank's part of an ``Arrivals`` stream (cluster axis 0) or a
        ``TickArrivals`` bucket (axis 1); host numpy, as the engine takes
        them."""
        if isinstance(arrivals, st.TickArrivals):
            C = arrivals.counts.shape[1]
            self.check_divisible(C)
            cut = self._span(C)
            return st.TickArrivals(
                rows=np.ascontiguousarray(arrivals.rows[:, cut]),
                counts=np.ascontiguousarray(arrivals.counts[:, cut]))
        C = np.asarray(arrivals.n).shape[0]
        self.check_divisible(C)
        cut = self._span(C)
        return tree_map(lambda x: np.ascontiguousarray(np.asarray(x)[cut]),
                        arrivals)

    def shard_metrics(self, mbuf):
        """This rank's carry of a global ``MetricsBuffer``
        (``obs.device.metrics_init`` of the global state): the per-cluster
        leaves' rows, the clock rows whole, and the shard-local partials
        widened to one row per shard, of which this rank holds its own:
        row 0 (rank 0) keeps the incoming partial, the others start at
        zero, so totals are kept whether the buffer is fresh or mid-run."""
        C = mbuf.placed.shape[0]
        self.check_divisible(C)
        cut, dev = self._span(C), self.mesh.device
        kw = {}
        for k in _PER_CLUSTER:
            kw[k] = _to(getattr(mbuf, k)[cut], dev).clone()
        for k in _PARTIALS:
            x = _to(getattr(mbuf, k), dev).clone()
            kw[k] = x if self.mesh.rank == 0 else torch.zeros_like(x)
        for k in ("ticks", "ring_t", "leap_hist"):
            kw[k] = _to(getattr(mbuf, k), dev).clone()
        return obs_device.MetricsBuffer(**kw)

    def collect_metrics(self, mbuf):
        """The global view of this rank's ``MetricsBuffer`` carry, the same
        on every rank: the shard-local partials reduce through
        ``obs.device.reduce_metrics`` (``ex.allsum``) and the per-cluster
        leaves gather."""
        mb = obs_device.reduce_metrics(mbuf, self.ex)
        return mb.replace(**{k: self.ex.gather(getattr(mb, k))
                             for k in _PER_CLUSTER})

    def gather_state(self, state: st.SimState) -> st.SimState:
        """The global state on every rank (on this rank's device): each
        per-cluster leaf gathered on its leading axis, the clock kept."""
        return _per_cluster(self.ex.gather, state).replace(t=state.t.clone())

    def gather_series(self, series: st.MetricSample) -> st.MetricSample:
        """A ``MetricSample`` series with its [T, C_loc] leaves gathered
        to [T, C_tot] (the clock row is the same on every rank)."""
        def cols(x):
            return self.ex.gather(x.transpose(0, 1).contiguous()).transpose(
                0, 1).contiguous()
        return st.MetricSample(t=series.t.clone(),
                               jobs_in_queue=cols(series.jobs_in_queue),
                               avg_wait_ms=cols(series.avg_wait_ms))

    def run_fn(self, n_ticks: int, tick_indexed: bool = False,
               donate: bool = False, time_compress: bool = False,
               with_params: bool = False, with_metrics: bool = False):
        """A callable ``(state, arrivals[, params][, mbuf])`` advancing this
        rank's shard ``n_ticks``: dense through ``Engine.run``, or with
        ``time_compress`` (which requires ``tick_indexed``) through
        ``Engine.run_compressed``, whose quiescence votes and leap targets
        ride the exchange (``alland``/``allmin``) so that every rank
        executes the same ticks. It returns what the engine returns (the
        state, the [T, C_loc] series with ``cfg.record_metrics``, the
        ``LeapStats`` when compressed, the buffer last with
        ``with_metrics``): a shard-local carry, read globally through
        ``gather_state``, ``gather_series`` and ``collect_metrics``.
        ``tick_indexed`` takes a ``TickArrivals`` bucket instead of a
        stream; ``with_params`` a ``PolicyParams`` argument (the same cell
        on every rank); ``with_metrics`` a buffer from ``shard_metrics``.
        Without ``donate`` the caller's shard is left as it was (the run
        advances a clone); with it the run advances the shard in place."""
        eng = self.engine
        if time_compress and not tick_indexed:
            raise ValueError("time_compress requires tick_indexed "
                             "(pre-bucketed TickArrivals)")

        def fn(state, arrivals, *rest):
            if isinstance(arrivals, st.TickArrivals) != tick_indexed:
                raise ValueError(
                    "run_fn(tick_indexed=%s) takes %s" % (
                        tick_indexed, "TickArrivals" if tick_indexed
                        else "an Arrivals stream"))
            if len(rest) != int(with_params) + int(with_metrics):
                raise ValueError("run_fn got %d extra arguments, expected "
                                 "params=%s, metrics=%s"
                                 % (len(rest), with_params, with_metrics))
            params = rest[0] if with_params else None
            mbuf = rest[-1] if with_metrics else None
            if not donate:
                state = st.clone_state(state)
            if time_compress:
                return eng.run_compressed(state, arrivals, n_ticks,
                                          params=params, mbuf=mbuf)
            return eng.run(state, arrivals, n_ticks, params=params,
                           mbuf=mbuf)
        return fn


def shard_batch(tree, mesh, noun: str, plural: str):
    """This rank's slice of the leading axis of every leaf of ``tree`` (a
    tenant or env batch, each lane independent of the others) on the
    rank's device, with the reference's divisibility error naming the
    nearest valid counts: ``{noun} ({B}) must divide by mesh size``."""
    from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

    n = mesh.size
    lead = next(iter(leaves_with_keys(tree)))[1]
    B = lead.shape[0] if lead.dim() else 1
    if B % n != 0:
        lo, hi = nearest_divisible(B, n)
        valid = f"{hi}" if lo == 0 else f"{lo} or {hi}"
        raise ValueError(
            f"{noun} ({B}) must divide by mesh size ({n}); nearest valid "
            f"{plural}: {valid}")
    b = B // n
    cut = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return tree_map(lambda x: _to(x[cut], mesh.device).clone(), tree)


def gather_batch(tree, mesh):
    """Every rank's slice of a batch (``shard_batch``) gathered back on
    its leading axis, on every rank."""
    return tree_map(MeshExchange(mesh).gather, tree)
