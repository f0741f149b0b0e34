"""The tenant axis: the engine's drivers over lane-stacked constellations
(the port of ``multi_cluster_simulator_tpu/tenancy/host.py``).

T independent tenants — each its own ``SimState`` cell, policy and market
knobs (``TenantParams.policy``), generative fault stream
(``TenantParams.fault_seed``) and arrival stream — run as the T lanes of
ONE lane-stacked run: every state leaf carries a leading [T] (``t`` [T]),
every params leaf too, and the engine's drivers take the stacked state
as it is (core/engine.py ``lanes_of``). On the card each tick is one
launch of each kernel source over all T C clusters, a row of blocks a
tenant, the tenant's own parameters read per lane from the device; the
cross-cluster phases and the market run per tenant on its [C] views, so
borrowing never crosses tenants. The reference vmaps its drivers for the
same effect, and the contract is the same: every tenant cell of a T > 1
run is bitwise its standalone run, composed with the compact layout
(``plan``), event-compressed time (``run_compressed_fn``, lane by lane)
and generative faults.

Data never crosses tenants outside the aggregate helpers below
(``aggregate_*``), as LINTING.md §13 requires of the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import SimConfig
from multi_cluster_simulator_tpu_torch.core import state as st
from multi_cluster_simulator_tpu_torch.core.engine import Engine
from multi_cluster_simulator_tpu_torch.core.state import (
    SimState, clone_state, init_state,
)
from multi_cluster_simulator_tpu_torch.kernels import fused_tick
from multi_cluster_simulator_tpu_torch.obs import device as obs_device
from multi_cluster_simulator_tpu_torch.ops.fields import QUEUE_INVALID
from multi_cluster_simulator_tpu_torch.tenancy.params import (
    TenantParams, default_tenant_params, stack_tenant_params,
)
from multi_cluster_simulator_tpu_torch.utils.tree import (
    leaves_with_keys, tree_map,
)


def _stack(xs):
    if xs[0].dtype == torch.uint32:  # stacked through int32 views
        return torch.stack([x.view(torch.int32) for x in xs]).view(
            torch.uint32)
    return torch.stack(xs)


def stack_lanes(cells: Sequence):
    """Stack trees of one structure (states, params, buffers) leaf-wise on
    a new leading lane axis, into fresh contiguous tensors."""
    leaves = [[x for _, x in leaves_with_keys(c)] for c in cells]
    it = iter(_stack(xs) for xs in zip(*leaves))
    return tree_map(lambda _: next(it), cells[0])


def n_tenants(tp: TenantParams) -> int:
    """Tenant count of a stacked params tree (a 0-d ``idx`` is one
    cell)."""
    idx = tp.policy.idx
    return int(idx.shape[0]) if idx.dim() else 1


def init_tenant_state(cfg: SimConfig, specs, tp: Optional[TenantParams] = None,
                      plan=None, device=None) -> SimState:
    """One tenant's reset constellation on ``device`` (the card by
    default) — the same init the standalone run uses, so stacked cells and
    standalone states start bitwise equal. With generative faults armed
    the churn streams reseed from the tenant's ``fault_seed``: the root
    key ``PRNGKey(fault_seed)``, ``(0, fault_seed)``, through
    ``faults.schedule.reseed``."""
    state = clone_state(init_state(cfg, specs, plan=plan, device=device))
    if tp is not None and cfg.faults.enabled and cfg.faults.mode != "trace":
        from multi_cluster_simulator_tpu_torch.faults import schedule as fsch
        seed = tp.fault_seed.to(torch.int64).reshape(1).to(state.device)
        key = fsch.to_u32(torch.cat([torch.zeros_like(seed), seed]))
        state = state.replace(faults=fsch.reseed(
            state.faults, key, cfg.faults, eligible=state.node_active))
    return state


def stack_tenant_states(cells: Sequence[SimState]) -> SimState:
    """Stack per-tenant states leaf-wise on a leading [T] axis."""
    if not cells:
        raise ValueError("stack_tenant_states needs at least one tenant")
    return stack_lanes(cells)


def tenant_cell(tree, i: int):
    """Tenant ``i``'s cell of any tenant-stacked tree: views of its
    leaves (host side: parity probes, snapshots)."""
    return fused_tick.lane(tree, i)


def shard_tenant_batch(tree, mesh, axis: str = "tenants"):
    """This rank's slice of a tenant-stacked tree over ``mesh``
    (``parallel.mesh.Mesh``, one rank a process): every leaf split on its
    leading (tenant) dimension, the slice on the rank's device. Tenants
    are independent, so each rank runs its tenants with no collective and
    the gathered result (``parallel.sharded_engine.gather_batch``) is
    bitwise the unsharded batch's. ``axis`` names the mesh axis, as in
    the reference; the mesh's one axis is the one split."""
    from multi_cluster_simulator_tpu_torch.parallel.sharded_engine import (
        shard_batch,
    )
    return shard_batch(tree, mesh, "tenant batch", "tenant counts")


class TenantBatch:
    """Batched multi-tenant drivers over one ``Engine``.

    The engine is shared (one config shape, one policy set — selection and
    parameters are per-tenant leaves); only the state, the arrivals and
    the params carry the tenant axis. The ``*_fn`` builders return plain
    callables over the engine's lane-stacked drivers: PyTorch runs
    eagerly, so there is no compiled program to count (the reference's
    ``._jit`` cache-count probe has no counterpart), and the card's
    kernels are the same for any tenant count. With ``donate`` (the
    default) a call updates the stacked state in place, as the
    reference's donated dispatch does; without it the caller's state is
    left as it was."""

    def __init__(self, cfg: SimConfig, specs, policies=None, plan=None,
                 device=None):
        self.cfg = cfg
        self.specs = list(specs)
        self.plan = plan
        self.engine = Engine(cfg, device=device, policies=policies)

    # -- construction ------------------------------------------------------
    def default_params(self, T: int, name: Optional[str] = None,
                       fault_seed0: int = 0) -> TenantParams:
        """T identical-default tenants with DISTINCT fault seeds, on the
        engine's device — the baseline a caller then perturbs leaf-wise
        per tenant. ``name`` picks a member of the engine's PolicySet."""
        cells = [default_tenant_params(self.cfg, pset=self.engine.pset,
                                       name=name, fault_seed=fault_seed0 + i,
                                       device=self.engine.device)
                 for i in range(T)]
        return stack_tenant_params(cells)

    def init_stacked(self, tp: TenantParams) -> SimState:
        """The stacked reset constellation for every tenant in ``tp``."""
        T = n_tenants(tp)
        stacked = tp.policy.idx.dim() > 0
        return stack_tenant_states([
            init_tenant_state(self.cfg, self.specs,
                              tenant_cell(tp, i) if stacked else tp,
                              plan=self.plan, device=self.engine.device)
            for i in range(T)])

    def metrics_init(self, state: SimState):
        """A zeroed metrics buffer a tenant (``obs.device.metrics_init``),
        stacked: each tenant's buffer is its own."""
        return stack_lanes([obs_device.metrics_init(tenant_cell(state, i))
                            for i in range(state.t.shape[0])])

    # -- batched drivers ---------------------------------------------------
    def run_io_fn(self, donate: bool = True, obs: bool = False):
        """The tenant-batched dispatch unit: ``Engine.run_io`` over
        ``(state, rows [T, Tt, C, K, NF], counts [T, Tt, C], tp[,
        mbuf])``, returning the state and the ``TickIO`` stack [T, Tt, C,
        ...] (and the buffer with ``obs``)."""
        eng = self.engine

        def call(state, rows, counts, tp, mbuf=None):
            if obs and mbuf is None:
                raise ValueError("run_io_fn(obs=True) takes a stacked "
                                 "metrics buffer")
            state = state if donate else clone_state(state)
            return eng.run_io(state, rows, counts, params=tp.policy,
                              mbuf=mbuf if obs else None)
        return call

    def run_fn(self, n_ticks: int, donate: bool = True):
        """Tick-indexed ``Engine.run`` over stacked TickArrivals (rows [T,
        Tt, C, K, NF]), ``n_ticks`` shared by every tenant."""
        eng = self.engine

        def call(state, ta, tp):
            state = state if donate else clone_state(state)
            return eng.run(state, ta, n_ticks, params=tp.policy)
        return call

    def run_compressed_fn(self, n_ticks: int, donate: bool = True):
        """The event-compressed driver: each tenant leaps its own quiescent
        gaps (``Engine.run_compressed`` lane by lane), bitwise per cell its
        standalone compressed run. Returns the state."""
        eng = self.engine

        def call(state, ta, tp):
            state = state if donate else clone_state(state)
            out = eng.run_compressed(state, ta, n_ticks, params=tp.policy)
            return out[0] if isinstance(out, tuple) else out
        return call


def stack_tick_arrivals(tas: Sequence[st.TickArrivals]) -> st.TickArrivals:
    """Stack per-tenant bucketed streams on a leading [T] axis. All
    tenants must share one (Tt, C, K) shape — pad K to the tenant-max
    bucket first."""
    shapes = {tuple(np.asarray(ta.rows).shape) for ta in tas}
    if len(shapes) != 1:
        raise ValueError(
            f"tenant streams must share one (Tt, C, K, NF) shape before "
            f"stacking; got {sorted(shapes)} — pad K to the tenant-max "
            "bucket (pad_tick_arrivals)")
    return st.TickArrivals(
        rows=np.stack([np.asarray(ta.rows) for ta in tas]),
        counts=np.stack([np.asarray(ta.counts) for ta in tas]))


def pad_tick_arrivals(ta: st.TickArrivals, k: int) -> st.TickArrivals:
    """Pad a bucketed stream's K axis to the shared tenant-max bucket
    with invalid rows (ingest reads only each tick's [0, count) prefix,
    so wider padding changes nothing)."""
    rows, counts = np.asarray(ta.rows), np.asarray(ta.counts)
    k0 = rows.shape[2]
    if k0 > k:
        raise ValueError(f"stream K {k0} exceeds the shared bucket {k}")
    if k0 == k:
        return st.TickArrivals(rows=rows, counts=counts)
    pad = np.broadcast_to(np.asarray(QUEUE_INVALID, np.int32),
                          rows.shape[:2] + (k - k0, rows.shape[3])).copy()
    return st.TickArrivals(rows=np.concatenate([rows, pad], axis=2),
                           counts=counts)


# ---------------------------------------------------------------------------
# the cross-tenant aggregates (LINTING.md §13): the ONLY places a reduction
# crosses the tenant axis — everything else here is per tenant
# ---------------------------------------------------------------------------

def aggregate_placed(stacked_state: SimState) -> int:
    """Total placed jobs across every tenant (host side, after a run)."""
    return int(stacked_state.placed_total.to(torch.int64).sum())


def aggregate_drops(stacked_state: SimState) -> dict:
    """Summed drop counters across tenants — the zero-drops gate's view
    (any nonzero names the tenant in the per-cell probe, not here)."""
    from multi_cluster_simulator_tpu_torch.utils.trace import total_drops
    return total_drops(stacked_state)
