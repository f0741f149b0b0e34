"""multi_cluster_simulator_tpu_torch — the simulator ported to PyTorch and CUDA.

A second package beside the JAX one (``multi_cluster_simulator_tpu``), with
the same subpackage layout so each module maps to one reference file. The
JAX package is the reference: the port never imports it (nor jax), and its
tests hold every ported piece bitwise against it on the CPU.

So far the port carries the headline path: FIFO parity semantics over the
wide state layout, ticks of ``release -> ingest -> schedule`` driven in
ragged-K chunks. On an NVIDIA H100 that tick prefix runs as one
hand-written CUDA kernel (``kernels/csrc/fused_prefix_fifo.cu``). Entry
points run on the card unless the caller passes ``device="cpu"``, which
runs the plain PyTorch version of the same function. ROADMAP.md lists what
is still to port; those configurations raise ``NotImplementedError``.
"""

from multi_cluster_simulator_tpu_torch.config import (
    FaultConfig, MatchKind, PolicyKind, SimConfig, TraderConfig,
    WorkloadConfig,
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
    "init_state",
]
