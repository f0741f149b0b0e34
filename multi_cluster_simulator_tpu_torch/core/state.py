"""World-state tensors (the port of ``multi_cluster_simulator_tpu/core/state.py``).

One ``SimState`` holds the whole constellation: every per-cluster field has
a leading cluster axis ``C``. The leaves, their nesting, shapes and dtypes
are the reference's exactly — int32, bool, float32 and the uint32 fault key
— so a state converts leaf by leaf to and from the JAX pytree
(``interop.py``). torch defaults to int64 where JAX stays int32
(``torch.sum``/``torch.cumsum`` of ints, ``torch.tensor`` of Python ints),
so every constructor here names its dtype.

Host-side arrival streams (``Arrivals``, ``TickArrivals``) stay numpy, as
the reference keeps them until a chunk moves to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import SimConfig
from multi_cluster_simulator_tpu_torch.core.spec import (
    CORES, MEM, RES, ClusterSpec, capacities_array, node_types_array,
)
from multi_cluster_simulator_tpu_torch.faults.schedule import (
    FaultState, init_fault_state,
)
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import runset as R
from multi_cluster_simulator_tpu_torch.utils.tree import Tree, tree_map

# trace source-queue codes
SRC_L1, SRC_L0, SRC_READY, SRC_WAIT, SRC_LENT, SRC_VNODE_HOLD = 0, 1, 2, 3, 4, 5


@dataclasses.dataclass
class Arrivals(Tree):
    """Pre-generated, time-sorted arrival stream (host numpy arrays)."""

    t: np.ndarray  # [C, A] int32 ms, nondecreasing per cluster
    id: np.ndarray  # [C, A] int32
    cores: np.ndarray  # [C, A] int32
    mem: np.ndarray  # [C, A] int32
    gpu: np.ndarray  # [C, A] int32
    dur: np.ndarray  # [C, A] int32 ms
    n: np.ndarray  # [C] int32 valid prefix length


@dataclasses.dataclass
class TickArrivals(Tree):
    """The arrival stream bucketed by destination tick (host numpy):
    ``rows[k]`` / ``counts[k]`` are tick ``k``'s pre-packed queue rows and
    per-cluster counts. K pads to the bucket's maximum, and ingest masks
    rows beyond each tick's count, so K is invisible to the simulation."""

    rows: np.ndarray  # [T, C, K, Q.NF] int32
    counts: np.ndarray  # [T, C] int32

    def nbytes(self) -> int:
        return int(self.rows.nbytes) + int(self.counts.nbytes)


@dataclasses.dataclass
class TraderState(Tree):
    """Per-cluster trader agent state: the snapshot the market reads, the
    buyer cooldowns and seller locks, and the cvx price column
    (market/trader.py)."""

    snap_core_util: torch.Tensor  # [C] f32
    snap_mem_util: torch.Tensor  # [C] f32
    snap_avg_wait: torch.Tensor  # [C] f32 ms
    snap_total_cores: torch.Tensor  # [C] i32
    snap_total_mem: torch.Tensor  # [C] i32
    cooldown_until: torch.Tensor  # [C] i32
    seller_locked_until: torch.Tensor  # [C] i32
    next_contract_id: torch.Tensor  # [C] i32
    spent: torch.Tensor  # [C] f32
    mkt_price: torch.Tensor  # [C] f32


@dataclasses.dataclass
class Drops(Tree):
    """Per-cluster counters for every place a static bound can bind; parity
    and bench runs assert all of them stay zero (core/state.py of the
    reference documents each)."""

    queue: torch.Tensor  # [C] i32
    msgs: torch.Tensor  # [C] i32
    run_full: torch.Tensor  # [C] i32
    vslot: torch.Tensor  # [C] i32
    carve: torch.Tensor  # [C] i32
    ingest: torch.Tensor  # [C] i32
    failed: torch.Tensor  # [C] i32


@dataclasses.dataclass
class Trace(Tree):
    """Per-cluster placement event ring (capped append)."""

    t: torch.Tensor  # [C, E] i32
    job: torch.Tensor  # [C, E] i32
    node: torch.Tensor  # [C, E] i32
    src: torch.Tensor  # [C, E] i32
    n: torch.Tensor  # [C] i32


@dataclasses.dataclass
class SimState(Tree):
    t: torch.Tensor  # [] i32 — the virtual clock (shared; ticks are lockstep)
    node_cap: torch.Tensor  # [C, N, RES] i32
    node_free: torch.Tensor  # [C, N, RES] i32
    node_active: torch.Tensor  # [C, N] bool
    node_expire: torch.Tensor  # [C, N] i32
    node_type: torch.Tensor  # [C, N] i32
    l0: Q.JobQueue  # DELAY Level0
    l1: Q.JobQueue  # DELAY Level1
    ready: Q.JobQueue  # FIFO ReadyQueue
    wait: Q.JobQueue  # FIFO WaitQueue
    lent: Q.JobQueue  # foreign jobs I host
    borrowed: Q.JobQueue  # my jobs sent away
    run: R.RunningSet  # [C, S]
    arr_ptr: torch.Tensor  # [C] i32 — next unconsumed arrival
    wait_total: torch.Tensor  # [C] f32 ms
    wait_jobs: torch.Tensor  # [C] i32
    jobs_in_queue: torch.Tensor  # [C] i32
    placed_total: torch.Tensor  # [C] i32 — lifetime placements
    drops: Drops
    trader: TraderState
    trace: Trace
    faults: FaultState

    @property
    def device(self) -> torch.device:
        return self.node_free.device


@dataclasses.dataclass
class TickIO(Tree):
    """Per-tick host-visible events (the reference's ``core/engine.py``
    ``TickIO``): what a live service host must act on over the network.

    ``borrow_want``/``borrow_job`` are the failing wait-head before any
    in-batch borrow matching (the BorrowResources call site,
    scheduler.go:234); ``ret_rows``/``ret_valid`` are the finished
    foreign-job return messages (ReturnToBorrower, server.go:260-290) —
    ``ret_rows`` holds the pre-release rows of the first non-returning
    slots where ``ret_valid`` is False. ``Engine.run_io`` stacks them over
    a leading tick axis."""

    borrow_want: torch.Tensor  # [C] bool
    borrow_job: torch.Tensor  # [C, Q.NF] i32
    ret_rows: torch.Tensor  # [C, M, R.RF] i32
    ret_valid: torch.Tensor  # [C, M] bool


def empty_io(lead: tuple, n_msgs: int, device) -> TickIO:
    """Uninitialised TickIO buffers with leading shape ``lead`` (``(C,)``
    for one tick, ``(T, C)`` for ``run_io``'s stack), ``n_msgs`` message
    slots per cluster."""
    def e(shape, dtype=torch.int32):
        return torch.empty(tuple(lead) + shape, dtype=dtype, device=device)

    return TickIO(borrow_want=e((), torch.bool), borrow_job=e((Q.NF,)),
                  ret_rows=e((n_msgs, R.RF)),
                  ret_valid=e((n_msgs,), torch.bool))


def clone_state(state: SimState) -> SimState:
    """A deep copy: the engine updates states in place."""
    return tree_map(torch.clone, state)


def avg_wait_ms(s: SimState) -> torch.Tensor:
    """WaitTime.GetAverage() (scheduler.go:56-63): [C] f32."""
    return torch.where(s.wait_jobs > 0,
                       s.wait_total / s.wait_jobs.clamp(min=1), 0.0)


@dataclasses.dataclass
class MetricSample(Tree):
    """One tick's metric readout, the tensor form of RunMetrics' 5 s
    recorder (pkg/scheduler/metrics.go:11-31): the ``jobs_in_queue``
    up/down counter and the ``waitTime`` running average, per cluster.
    ``Engine.run`` stacks them into a [T] / [T, C] series when
    ``SimConfig.record_metrics`` is set."""

    t: torch.Tensor  # [] i32 virtual ms (the tick's clock)
    jobs_in_queue: torch.Tensor  # [C] i32
    avg_wait_ms: torch.Tensor  # [C] f32


def metric_sample(s: SimState) -> MetricSample:
    """The post-tick sample, as new tensors (the state changes in place)."""
    return MetricSample(t=s.t.clone(), jobs_in_queue=s.jobs_in_queue.clone(),
                        avg_wait_ms=avg_wait_ms(s))


def stack_samples(samples: Sequence[MetricSample],
                  state: SimState) -> MetricSample:
    """The per-tick samples of a run stacked into its [T] / [T, C]
    series (empty for a run of no ticks)."""
    if not samples:
        C, dev = state.arr_ptr.shape[0], state.device
        return MetricSample(
            t=torch.zeros((0,), dtype=torch.int32, device=dev),
            jobs_in_queue=torch.zeros((0, C), dtype=torch.int32, device=dev),
            avg_wait_ms=torch.zeros((0, C), dtype=torch.float32, device=dev))
    return MetricSample(**{
        f.name: torch.stack([getattr(x, f.name) for x in samples])
        for f in dataclasses.fields(MetricSample)})


# log2 histogram width for LeapStats.leaps (and the metrics buffer's
# ``leap_hist``): bucket b counts leaps that skipped [2^b, 2^(b+1)) ticks,
# as XLA's CPU f32 log2 rounds it; 32 buckets cover any int32 tick count
LEAP_BUCKETS = 32


@dataclasses.dataclass
class LeapStats(Tree):
    """Event-compression accounting of ``Engine.run_compressed``: the
    ticks the driver executed (the dense driver executes one per
    ``tick_ms`` of virtual time) and a log2 histogram of the leap
    lengths."""

    ticks_executed: torch.Tensor  # [] i32
    leaps: torch.Tensor  # [LEAP_BUCKETS] i32


def leap_stats_init(device="cpu") -> LeapStats:
    return LeapStats(
        ticks_executed=torch.zeros((), dtype=torch.int32, device=device),
        leaps=torch.zeros((LEAP_BUCKETS,), dtype=torch.int32, device=device))


def utilization(s: SimState) -> tuple[torch.Tensor, torch.Tensor]:
    """(core_util, mem_util) per cluster as GetResourceUtilization
    (cluster.go:46-63) computes them: used over total, both over active
    nodes; [..., C] f32 (any leading lane axes)."""
    act = s.node_active[..., None]
    used = Q.isum(torch.where(act, s.node_cap - s.node_free, 0), -2)
    total = Q.isum(torch.where(act, s.node_cap, 0), -2)
    util = used.to(torch.float32) / total.clamp(min=1).to(torch.float32)
    return util[..., 0], util[..., 1]


def snapshot_utilization(s: SimState) -> tuple[torch.Tensor, torch.Tensor]:
    """(core_util, mem_util) [C] f32 as the streamed ClusterState computes
    them (GetResourceUtilization, cluster.go:46-63): usage summed over
    *all* nodes, virtual ones included, divided by the cached *physical*
    totals (SetTotalResources runs only at init), so it can exceed 1.0
    once virtual nodes carry load. Inactive slots hold 0 - 0."""
    used = Q.isum(s.node_cap - s.node_free, 1)  # [C, R]
    tr = s.trader
    cu = used[:, CORES].to(torch.float32) \
        / tr.snap_total_cores.clamp(min=1).to(torch.float32)
    mu = used[:, MEM].to(torch.float32) \
        / tr.snap_total_mem.clamp(min=1).to(torch.float32)
    return cu, mu


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the card unless the caller names a
    device: ``None`` means ``cuda``, and raises when no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # name the card: cuda:N
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_state(cfg: SimConfig, specs: Sequence[ClusterSpec], plan=None,
               fault_events=None, device=None) -> SimState:
    """Build the initial batched state from cluster specs, on ``device``
    (the card by default; see ``resolve_device``). ``fault_events`` is the
    trace-mode fault schedule (``faults.schedule.pack_fault_trace``);
    generative churn draws first failures for the initially active slots
    only. ``plan``, a ``core.compact.CompactPlan``, builds the six queues
    and the running set in the compact SoA layout with the plan's storage
    dtypes, and the node columns in its node dtype; ``None`` keeps the
    wide int32 layout."""
    dev = resolve_device(device)
    C = len(specs)
    N = cfg.total_nodes
    cap_phys = capacities_array(specs, cfg.max_nodes)
    if cfg.n_res < RES and cap_phys[..., cfg.n_res:].any():
        raise ValueError(
            f"specs declare gpu capacity but n_res={cfg.n_res} drops the axis")
    node_dt = np.int32 if plan is None else plan.node_dtype()
    phys = cap_phys[..., : cfg.n_res]
    if phys.size and int(phys.max()) > np.iinfo(node_dt).max:
        raise ValueError(
            f"compact plan's node dtype {np.dtype(node_dt).name} cannot hold "
            f"capacity {int(phys.max())} — derive the plan from these specs")
    cap = np.zeros((C, N, cfg.n_res), dtype=node_dt)
    cap[:, : cfg.max_nodes] = phys
    active = cap.sum(-1) > 0
    ntype = np.zeros((C, N), dtype=np.int32)
    ntype[:, : cfg.max_nodes] = node_types_array(specs, cfg.max_nodes)

    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def zeros(dtype=torch.int32):
        return torch.zeros((C,), dtype=dtype, device=dev)

    def queue():
        if plan is None:
            return Q.empty(C, cfg.queue_capacity, dev)
        return Q.empty_soa(C, cfg.queue_capacity, plan.queue_dtypes(), dev)

    # trace buffers are only materialized when recording
    E = cfg.max_trace_events if cfg.record_trace else 1
    return SimState(
        t=torch.zeros((), dtype=torch.int32, device=dev),
        node_cap=t_(cap),
        node_free=t_(cap.copy()),
        node_active=t_(active),
        node_expire=torch.full((C, N), R.NEVER, dtype=torch.int32,
                               device=dev),
        node_type=t_(ntype),
        l0=queue(), l1=queue(), ready=queue(), wait=queue(), lent=queue(),
        borrowed=queue(),
        run=(R.empty(C, cfg.max_running, dev) if plan is None else
             R.empty_soa(C, cfg.max_running, plan.run_dtypes(), dev)),
        arr_ptr=zeros(),
        wait_total=zeros(torch.float32),
        wait_jobs=zeros(),
        jobs_in_queue=zeros(),
        placed_total=zeros(),
        drops=Drops(queue=zeros(), msgs=zeros(), run_full=zeros(),
                    vslot=zeros(), carve=zeros(), ingest=zeros(),
                    failed=zeros()),
        trader=TraderState(
            snap_core_util=zeros(torch.float32),
            snap_mem_util=zeros(torch.float32),
            snap_avg_wait=zeros(torch.float32),
            snap_total_cores=t_(cap[:, :, CORES].astype(np.int32).sum(1)
                                .astype(np.int32)),
            snap_total_mem=t_(cap[:, :, MEM].astype(np.int32).sum(1)
                              .astype(np.int32)),
            cooldown_until=zeros(),
            seller_locked_until=zeros(),
            next_contract_id=torch.ones((C,), dtype=torch.int32, device=dev),
            spent=zeros(torch.float32),
            mkt_price=zeros(torch.float32),
        ),
        trace=Trace(
            t=torch.zeros((C, E), dtype=torch.int32, device=dev),
            job=torch.full((C, E), -1, dtype=torch.int32, device=dev),
            node=torch.full((C, E), -1, dtype=torch.int32, device=dev),
            src=torch.full((C, E), -1, dtype=torch.int32, device=dev),
            n=zeros(),
        ),
        # generative churn is scoped to the machines that exist: phantom
        # padding and vacant virtual slots cannot fail
        faults=init_fault_state(cfg.faults, C, N, events=fault_events,
                                eligible=active, device=dev),
    )
