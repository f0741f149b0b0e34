"""Range-audited narrow storage for the bandwidth-bound state leaves (the
port of ``multi_cluster_simulator_tpu/core/compact.py``).

The compact layout splits the job queues and the running set into one leaf
per field (ops/queues.py ``SoAJobQueue``, ops/runset.py ``SoARunningSet``)
in the smallest signed dtype the config and the stream bound
(``derive_plan``), and stores the node columns in one dtype for the whole
resource axis. All arithmetic stays int32: leaves are widened on load
(``fields.widen``) and narrowed on store through ``fields.narrow_store``,
which clamps and counts an out-of-range value into the layout's ``ovf``
counter instead of wrapping. Parity and bench runs assert the counters
stay zero (utils/trace.total_drops reports them as ``narrow``), so the
storage width is invisible to the simulation.

The plan is static: a frozen, hashable dataclass of dtype names, fixed at
``init_state`` and baked into the leaves' dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import SimConfig
from multi_cluster_simulator_tpu_torch.core.spec import (
    ClusterSpec, capacities_array,
)
from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

narrow_store = F.narrow_store
widen = F.widen

_CANDIDATES = (np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.int32))
_QUEUES = ("l0", "l1", "ready", "wait", "lent", "borrowed")


def fit_dtype(lo: int, hi: int) -> str:
    """Smallest signed integer dtype whose range covers [lo, hi]."""
    for dt in _CANDIDATES:
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return dt.name
    raise ValueError(f"range [{lo}, {hi}] exceeds int32")


@dataclasses.dataclass(frozen=True)
class CompactPlan:
    """Per-field storage dtypes of the compact layouts — (field,
    dtype-name) pairs per row kind — and the node columns' dtype (one for
    the whole resource axis; under the trader it must also hold a buyer's
    contract totals, see ``derive_plan``). A ``None`` plan keeps the wide
    layout."""

    queue: tuple  # (("id", "int32"), ("cores", "int8"), ...)
    run: tuple
    node: str = "int32"

    def queue_dtypes(self) -> dict:
        return {name: np.dtype(dt) for name, dt in self.queue}

    def run_dtypes(self) -> dict:
        return {name: np.dtype(dt) for name, dt in self.run}

    def node_dtype(self) -> np.dtype:
        return np.dtype(self.node)

    def describe(self) -> dict:
        """Only the fields narrower than int32."""
        out = {
            "queue": {n: dt for n, dt in self.queue if dt != "int32"},
            "run": {n: dt for n, dt in self.run if dt != "int32"},
        }
        if self.node != "int32":
            out["node"] = self.node
        return out


def audit_arrivals(arrivals) -> dict:
    """Measured per-field maxima over the valid prefix of an ``Arrivals``
    stream (host numpy, once per run)."""
    n = np.asarray(arrivals.n)
    valid = np.arange(np.asarray(arrivals.t).shape[1])[None, :] < n[:, None]

    def mx(a):
        return int(np.asarray(a)[valid].max(initial=0))

    return {"cores": mx(arrivals.cores), "mem": mx(arrivals.mem),
            "gpu": mx(arrivals.gpu), "id": mx(arrivals.id)}


def derive_plan(cfg: SimConfig, specs: Sequence[ClusterSpec],
                arrivals=None) -> CompactPlan:
    """Storage widths from the config and, optionally, the stream.

    The bounds cover everything the engine can store in a row: demands up
    to the stream's maxima and the node capacities (a carve placeholder
    holds a node's amounts); owner in [-2, C-1]; node in [-1,
    total_nodes-1]; id in [-3, the stream's max] (int32 without an audit);
    jclass by the schema; retries by the retry budget. The node columns
    hold the largest physical capacity, and under the trader a buyer's
    contract total: up to ``queue_capacity`` jobs of the largest demand.
    The checked store stays the backstop: a value outside the plan is
    clamped and counted, never wrapped."""
    caps = capacities_array(specs, cfg.max_nodes)[..., : cfg.n_res]
    cap_max = [int(caps[..., r].max(initial=0)) for r in range(cfg.n_res)]
    while len(cap_max) < 3:
        cap_max.append(0)
    demand_hi = dict(zip(("cores", "mem", "gpu"), cap_max))
    id_hi = np.iinfo(F.WIDE_DTYPE).max
    if arrivals is not None:
        audited = audit_arrivals(arrivals)
        for k in ("cores", "mem", "gpu"):
            demand_hi[k] = max(demand_hi[k], audited[k])
        id_hi = audited["id"]
    bounds = {
        "id": (-3, id_hi),
        "cores": (0, demand_hi["cores"]),
        "mem": (0, demand_hi["mem"]),
        "gpu": (0, demand_hi["gpu"]),
        "owner": (-2, max(len(specs) - 1, 0)),
        "node": (-1, cfg.total_nodes - 1),
        "jclass": (0, F.N_JOB_CLASSES - 1),
        "retries": (0, max(int(cfg.faults.max_retries), 1)),
    }

    def row_plan(names):
        return tuple((n, fit_dtype(*bounds[n]) if n in F.NARROWABLE
                      else F.WIDE_DTYPE.name) for n in names)

    node_hi = max(cap_max) if cap_max else 0
    if cfg.trader.enabled:
        node_hi = max(node_hi, cfg.queue_capacity * max(demand_hi.values()))
    return CompactPlan(queue=row_plan(F.QUEUE_FIELDS),
                       run=row_plan(F.RUN_FIELDS),
                       node=fit_dtype(0, min(node_hi, 2**31 - 1)))


def wide_plan() -> CompactPlan:
    """An all-int32 plan: the SoA layout without any narrowing."""
    i32 = F.WIDE_DTYPE.name
    return CompactPlan(queue=tuple((n, i32) for n in F.QUEUE_FIELDS),
                       run=tuple((n, i32) for n in F.RUN_FIELDS))


def to_wide(state):
    """A compact state in the wide layout (new tensors; a wide state passes
    through): the form compact-against-wide equality checks compare in.
    The overflow counters are dropped; assert them separately."""
    from multi_cluster_simulator_tpu_torch.ops import queues as Q
    from multi_cluster_simulator_tpu_torch.ops import runset as R

    kw = {qn: Q.soa_to_wide(getattr(state, qn)) for qn in _QUEUES
          if isinstance(getattr(state, qn), Q.SoAJobQueue)}
    if isinstance(state.run, R.SoARunningSet):
        kw["run"] = R.soa_to_wide(state.run)
    if state.node_free.dtype != torch.int32:
        kw["node_free"] = widen(state.node_free)
        kw["node_cap"] = widen(state.node_cap)
    return state.replace(**kw) if kw else state


def _ovf_leaves(state):
    """The overflow counter of every compact table of ``state``."""
    for part in (*(getattr(state, qn) for qn in _QUEUES), state.run):
        ovf = getattr(part, "ovf", None)
        if ovf is not None:
            yield ovf


def ovf_per_cluster(state) -> torch.Tensor:
    """[C] sum of every queue's and the running set's overflow counter
    (zeros on the wide layout, which has none)."""
    total = torch.zeros_like(state.arr_ptr)
    for ovf in _ovf_leaves(state):
        total = total + ovf
    return total


def overflow_total(state) -> int:
    """Host-side sum of every narrow-store overflow counter (0 for wide
    states): the ``narrow`` entry of utils/trace.total_drops."""
    return sum(int(ovf.sum()) for ovf in _ovf_leaves(state))


def state_nbytes(state) -> int:
    """Total bytes of a state's leaves."""
    return int(sum(x.numel() * x.element_size()
                   for _, x in leaves_with_keys(state)))
