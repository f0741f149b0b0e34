"""Configuration layer (the PyTorch port's own copy).

A field-for-field copy of ``multi_cluster_simulator_tpu/config.py``: the
port never imports the JAX package, whose ``__init__`` pulls in jax, so it
keeps this pure-Python module itself. tests/test_torch_copies.py pins every
field and default equal to the original. The port runs only part of what
these fields select; ``core/engine.py`` raises ``NotImplementedError`` on
the rest, naming the ROADMAP item that ports it. ``fused``,
``fused_block`` and ``fused_interpret`` are copied for equality but choose
nothing in the port: on a CUDA device the tick prefix always runs as the
hand-written kernel (kernels/fused_tick.py).

The reference hardcodes every operational constant (catalogued in SURVEY.md §5);
this module lifts them all into dataclasses. Each field cites the reference
file:line its default value comes from. All times are virtual-time
milliseconds (int) — the reference's wall-clock durations map 1:1 onto the
virtual clock.
"""

from __future__ import annotations

import dataclasses
import enum


class PolicyKind(str, enum.Enum):
    """Scheduling policy. Reference: SchedulingType, pkg/scheduler/scheduler.go:40-45.

    FFD (first-fit-decreasing bin-pack) is a new TPU-side policy demanded by
    BASELINE.json config 3; the reference has only FIFO and DELAY.
    """

    FIFO = "FIFO"
    DELAY = "DELAY"
    FFD = "FFD"


class MatchKind(str, enum.Enum):
    """Trader market matching algorithm.

    GREEDY reproduces the reference's cheapest-approving-seller heap
    (pkg/trader/trader.go:169-191,236-276) deterministically; SINKHORN is the
    batched optimal-transport upgrade (BASELINE.json config 4); CVX solves the
    same assignment relaxation as an exact LP via fixed-iteration descending-
    price dual ascent (market/cvx.py) — the per-tick pricing backend the
    serving tier runs inside its coalesce window.
    """

    GREEDY = "greedy"
    SINKHORN = "sinkhorn"
    CVX = "cvx"


@dataclasses.dataclass(frozen=True)
class TraderConfig:
    """Per-cluster trader agent knobs. Reference: pkg/trader/trader.go:41-65."""

    enabled: bool = False
    # approvePolicy (seller side), trader.go:47-52
    approve_core_threshold: float = 0.8
    approve_mem_threshold: float = 0.8
    min_core_incentive: float = -1.0  # per core-second, trader.go:50
    min_mem_incentive: float = -1.0  # per MB-second, trader.go:51
    # requestPolicy (buyer side), trader.go:55-62
    request_max_wait_ms: float = 600_000.0  # requestPolicy_WaitTime, trader.go:57
    request_core_max: float = 0.8  # requestPolicy_Utilization, trader.go:60-61
    request_mem_max: float = 0.8
    # economics, trader.go:53 and (never-initialized, hence 0.0) trader.go:34-35
    budget: float = -1.0  # negative = unlimited
    max_core_cost: float = 0.0  # per core-second
    max_mem_cost: float = 0.0  # per MB-second
    # cadences
    monitor_period_ms: int = 10_000  # RequestPolicyMonitor loop, trader.go:323
    cooldown_success_ms: int = 240_000  # 4 min sleep after success, trader.go:298
    cooldown_failure_ms: int = 120_000  # 2 min sleep after failure, trader.go:302
    state_cadence_ms: int = 5_000  # scheduler state stream, trader_server.go:42
    contract_ttl_ms: int = 20_000  # seller contract validity, trader/server.go:49
    # Batch-market-only knob (market/trader.py). The live TraderService
    # always speaks the reference's pairwise gRPC protocol, which is greedy
    # by construction (fan-out + cheapest approver, trader.go:193-278) — a
    # live Sinkhorn would need a central matcher that protocol doesn't have.
    matching: MatchKind = MatchKind.GREEDY
    # Solver hyperparameters. The iteration counts are STATIC scan lengths
    # (the compiled loop trip count — fixed-iteration discipline, simlint
    # family 11); every value below also lands as a traced PolicyParams
    # ``mkt_*`` leaf (policies/base.py), so tournaments sweep the ACTIVE
    # iteration count / temperatures within the static bound in one
    # compiled program, and the values enter every params_digest.
    sinkhorn_iters: int = 16  # entropic-OT iterations (market/trader.py)
    sinkhorn_eps: float = 0.05  # entropic regularization temperature
    cvx_iters: int = 128  # dual-ascent iterations (market/cvx.py)
    cvx_step: float = 64.0  # primal sharpness 1/delta of the prox update
    # opening price step; decays harmonically (rho/(1+i) at iteration i),
    # so the total price sweep rho*H(n) ~ ln(n) diverges — an unmatched
    # buyer's price always reaches zero — while the step vanishes and the
    # equilibrium sharpens. The settle rule ties the three knobs: the
    # final dual step rho/(1+iters) must sit under the primal band width
    # 1/step, margin (1+iters)/(step*rho) >= 2 at the defaults, or the
    # price/plan limit cycle never lands (market/cvx.py, schedule note)
    cvx_rho: float = 1.0
    cvx_smooth: float = 0.0  # price carry-over across rounds (0 = cold start)
    # "asbuilt" reproduces the reference's observable arithmetic (quirks
    # included); "sane" is the documented intended behavior (MARKET.md).
    small_node_sizing: str = "asbuilt"  # scheduler_client.go:201-289
    carve_mode: str = "asbuilt"  # AllocateVirtualNodeResources, cluster.go:87-125
    # When True, borrowed virtual nodes expire after their contract duration
    # ("sane" mode). The reference keeps them forever (AddVirtualNode never
    # removes, pkg/scheduler/cluster.go:65-85), which the False default
    # reproduces.
    expire_virtual_nodes: bool = False
    # Live-host-only knob (services/trader_host.py). When a request policy
    # breaks while Level1 is empty, Go sizes a 0-core/0-MB contract and
    # trades it anyway — the buyer attaches a zero-capacity virtual node
    # that burns one of its finite virtual slots (trader.go:288-311 with an
    # empty ProvideJobs stream). The live TraderService skips such contracts
    # by default (with a log line); set False to reproduce Go's churn. The
    # batch market (market/trader.py) and the oracle are bit-parity surfaces
    # and always reproduce Go's zero-contract trades, ignoring this flag
    # (MARKET.md §divergences).
    skip_zero_contracts: bool = True


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """The fault plane (faults/): deterministic node churn as DATA.

    The reference simulates a fantasy datacenter — nodes never fail and a
    job, once placed, always completes. Real schedulers are shaped by churn
    (Gavel's rounds exist because placements must survive preemption,
    arxiv 2008.09213; Blox treats failure handling as a first-class
    toolkit axis, arxiv 2312.12621). With ``enabled`` the engine runs a
    fault phase at tick entry (core/engine.py): nodes fail on a per-node
    schedule, jobs running on a failed node are killed and requeued with
    their ``retries`` row field bumped (past ``max_retries`` they count
    into ``drops.failed``), the node's capacity is masked out while down,
    and repair restores an empty node. Failure schedules are either

    - ``mode="generative"`` — on-device inverse-CDF exponential sampling
      of per-node time-to-failure (``mttf_ms``) and time-to-repair
      (``mttr_ms``) from counter-based per-cluster PRNG streams (seeded by
      ``seed`` + global cluster index, so results are bit-identical under
      any sharding/chunking/compression of the run); or
    - ``mode="trace"`` — an explicit event list packed host-side into
      per-node interval tables (faults/schedule.pack_fault_trace), the
      ``pack_arrivals_by_tick`` move applied to failures.

    Sub-tick event times round up to the next tick boundary exactly like
    arrivals; within a tick, failures apply before repairs (a same-tick
    fail+repair is a zero-length outage that still kills)."""

    enabled: bool = False
    mode: str = "generative"  # "generative" | "trace"
    mttf_ms: int = 600_000  # mean time to failure per node (generative)
    mttr_ms: int = 60_000  # mean time to repair (generative)
    seed: int = 77
    max_retries: int = 3  # kills a job survives before drops.failed
    max_events: int = 8  # trace-mode fail/repair interval slots per node


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Workload generator. Reference: pkg/client/client.go:85-147."""

    arrival: str = "poisson"  # "poisson" | "weibull" | "trace"
    poisson_lambda_per_min: float = 10.0  # client.go:108
    weibull_lambda_s: float = 10.0  # client.go:133
    weibull_k: float = 3.0  # client.go:134
    beta_alpha: float = 2.0  # job-size distribution Beta(2,2), client.go:87-90
    beta_beta: float = 2.0
    max_duration_s: int = 600  # Duration ~ Uniform{0..599}s, client.go:98
    seed: int = 9  # the reference's fixed Poisson seed, client.go:109


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Engine-level configuration."""

    # --- capacities (static tensor shapes) ---
    # Width of the node resource axis: 2 = [cores, mem] (the reference's
    # Node, cluster.go:127-138), 3 = [cores, mem, gpu] (the BASELINE.json
    # config-4 extension). Narrowing to 2 shrinks every node tensor and
    # feasibility compare on gpu-free configs; the trader market requires 3.
    n_res: int = 3
    max_nodes: int = 8  # physical node slots per cluster
    max_virtual_nodes: int = 4  # reserved slots for borrowed virtual nodes
    queue_capacity: int = 128  # per-queue job slots
    max_running: int = 256  # concurrent running-job slots per cluster
    max_arrivals: int = 1024  # arrival-stream length per cluster
    max_msgs: int = 8  # cross-cluster messages per cluster per tick
    max_ingest_per_tick: int = 64  # arrivals consumed per cluster per tick

    # --- policy ---
    policy: PolicyKind = PolicyKind.DELAY  # hardcoded DELAY in Run, scheduler.go:116
    tick_ms: int = 1_000  # 1 s loop tick, scheduler.go:250,294,367
    max_wait_ms: int = 10_000  # Level0->Level1 promotion, scheduler.go:115
    borrowing: bool = False  # FIFO-path scheduler<->scheduler loans

    # --- parity vs fast mode ---
    # parity=True reproduces the Go loops' observable semantics exactly,
    # including the remove-then-skip iteration quirk in the Level1 sweep
    # (scheduler.go:305-327) and unbounded per-tick sweeps. parity=False caps
    # per-tick placement work at `max_placements_per_tick` for throughput.
    parity: bool = True
    max_placements_per_tick: int = 16
    # Fast-mode FFD sweep form: "wave" places speculative batches per
    # while_loop iteration (provably identical placements to "serial" —
    # engine._ffd_wave_local docstring; tests/test_kernel_equiv.py pins
    # it); "serial" keeps the one-job-per-iteration sweep. Parity mode
    # always runs the serial sweep (its float wait accumulation order is
    # part of bit-parity with the oracle).
    ffd_sweep: str = "wave"
    # FIFO ready-drain form: the wave version is exact in BOTH modes (the
    # drain body has no order-sensitive float accumulation — see
    # engine._fifo_drain_wave), so it is the default everywhere; "serial"
    # keeps the one-job-per-iteration loop. The oracle parity suite and
    # the TPU parity gate run the wave path and must stay bit-exact.
    fifo_drain: str = "wave"
    # Fast-mode DELAY Level1 sweep form (parity mode always serial: the
    # remove-then-skip quirk + ordered float wait accumulation are part
    # of bit-parity). Same wave technique as ffd_sweep.
    delay_sweep: str = "wave"

    # --- fused tick kernel (kernels/fused_tick.py) ---
    # Execution STRATEGY, not semantics: the fused path is bit-identical to
    # the unfused tick (the interpret-mode oracle + tests/test_kernels.py
    # pin it), so these fields are excluded from the checkpoint config
    # digest (core/checkpoint.config_describe) — a run may be checkpointed
    # unfused and resumed fused, or vice versa.
    #   "off"  — the unfused XLA tick (default; every pre-kernel path)
    #   "on"   — always run the per-cluster prefix (the engaged span of
    #            faults->release->expire->ingest->schedule) as ONE
    #            pallas_call that keeps the block's queue/runset/node
    #            columns in VMEM across the phase boundaries
    #            (interpret-mode on non-TPU backends unless
    #            fused_interpret pins it)
    #   "auto" — fuse only where it pays: a real TPU backend (interpret
    #            mode is an oracle, not a fast path — CPU stays unfused)
    fused: str = "off"
    # Cluster-block hint for the kernel grid: the actual block is the
    # largest divisor of the (shard-local) cluster count <= this, so C
    # never needs padding and blocking stays bitwise invisible.
    fused_block: int = 256
    # pallas_call(interpret=...) source of truth (simlint rule family 10
    # forbids hardcoding it at call sites). None = interpret everywhere
    # except a real TPU backend — the CPU/CI oracle contract.
    fused_interpret: bool | None = None

    # --- instrumentation ---
    record_trace: bool = False  # record per-placement events
    max_trace_events: int = 1 << 16
    # When True, Engine.run returns (state, MetricSample series): per-tick
    # jobs_in_queue + avg-wait stacked from the scan (metrics.go:11-31).
    record_metrics: bool = False

    trader: TraderConfig = dataclasses.field(default_factory=TraderConfig)
    workload: WorkloadConfig = dataclasses.field(default_factory=WorkloadConfig)
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)

    @property
    def total_nodes(self) -> int:
        return self.max_nodes + self.max_virtual_nodes


# Service-shell constants (reference values; see services/).
REGISTRY_PORT = 3000  # pkg/registry/server.go:15
HEARTBEAT_PERIOD_S = 3.0  # cmd/registry/main.go -> SetupRegistryService
HEARTBEAT_ATTEMPTS = 3  # pkg/registry/server.go:140
PROVIDE_JOBS_BATCH = 20  # pkg/scheduler/trader_server.go:75
TRADE_COLLECT_WINDOW_S = 3.0  # pkg/trader/trader.go:249
RETURN_ATTEMPTS = 3  # pkg/scheduler/server.go:275
