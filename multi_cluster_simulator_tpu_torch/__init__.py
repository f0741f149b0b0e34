"""multi_cluster_simulator_tpu_torch — the simulator ported to PyTorch and CUDA.

A second package beside the JAX one (``multi_cluster_simulator_tpu``), with
the same subpackage layout so each module maps to one reference file. The
JAX package is the reference: the port never imports it (nor jax), and its
tests hold every ported piece bitwise against it on the CPU.

So far the port carries every kind of the policy zoo over the wide state
layout, cross-cluster borrowing, the trader market (greedy, sinkhorn
and cvx matching, with or without virtual-node expiry) and the fault
plane (generative or trace node churn), ticks driven in ragged-K chunks,
and checkpoints any run at a chunk boundary to resume it bit-exactly
(``save_state``/``load_state``; ``core/preempt.py`` for run bundles), in
the reference's file format. A lane-stacked batch of constellations runs
as one (``tenancy/`` for tenants, ``envs/`` for a batched gym), each
kernel launched once a tick over every lane.
On an NVIDIA H100 each tick's per-cluster prefix (``faults -> release ->
vnode expiry -> ingest -> schedule``) runs as a hand-written CUDA kernel
(``kernels/csrc/``); the cross-cluster phases and the market
run as PyTorch ops. Entry points run on the card unless the caller passes
``device="cpu"``, which runs the plain PyTorch version of the same
function. ROADMAP.md lists what is still to port; those configurations
raise ``NotImplementedError``.
"""

from multi_cluster_simulator_tpu_torch.config import (
    FaultConfig, MatchKind, PolicyKind, SimConfig, TraderConfig,
    WorkloadConfig,
)
from multi_cluster_simulator_tpu_torch.core.checkpoint import (
    load_state, save_state,
)
from multi_cluster_simulator_tpu_torch.core.engine import Engine
from multi_cluster_simulator_tpu_torch.core.spec import (
    ClusterSpec, NodeSpec, load_cluster_json, uniform_cluster,
)
from multi_cluster_simulator_tpu_torch.core.state import (
    SimState, clone_state, init_state,
)

__all__ = [
    "FaultConfig", "MatchKind", "PolicyKind", "SimConfig", "TraderConfig",
    "WorkloadConfig", "Engine", "ClusterSpec", "NodeSpec",
    "load_cluster_json", "uniform_cluster", "SimState", "clone_state",
    "init_state", "save_state", "load_state",
]
