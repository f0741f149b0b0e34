"""Cluster topology specs and loaders (the PyTorch port's own copy of
``multi_cluster_simulator_tpu/core/spec.py``, which is plain numpy; kept
here so the port never imports the JAX package — tests/test_torch_copies.py
pins the two equal).

The reference's whole topology config surface is a JSON file decoded straight
into its Go ``Cluster`` struct (cmd/scheduler/main.go:52-59,
assets/cluster_small.json). We accept the same JSON schema (capitalized Go
field names) plus a snake_case variant, and convert to padded arrays.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

# Resource axis: [cores, memory, gpus]. The reference tracks only
# cores/memory (Node, cluster.go:127-138); the gpu axis is the 3-dim
# extension demanded by BASELINE.json config 4 ("Sinkhorn trader matching,
# ... 3-dim resources (cpu/mem/gpu)"). Reference-parity configs leave every
# gpu count at 0, which makes the axis inert (0 >= 0 feasibility).
RES = 3
CORES, MEM, GPU = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One machine. Reference: Node, pkg/scheduler/cluster.go:127-138."""

    id: int
    cores: int
    memory: int
    gpus: int = 0  # 3-dim extension; 0 in every reference asset
    type: str = "physical"
    # Device type for the heterogeneity-aware policies (ops/fields.py
    # N_DEVICE_TYPES; Gavel, arxiv 2008.09213). -1 = derive: accelerator
    # (1) when the node has gpu capacity, standard (0) otherwise. The
    # reference has no analogue — parity policies never read it.
    device_type: int = -1


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """One cluster of nodes. Reference: Cluster, pkg/scheduler/cluster.go:14-24."""

    id: int
    nodes: tuple[NodeSpec, ...]

    @property
    def total_cores(self) -> int:
        return sum(n.cores for n in self.nodes)

    @property
    def total_memory(self) -> int:
        return sum(n.memory for n in self.nodes)

    def to_json(self, url: str = "") -> dict:
        """Serialize in the reference's Go-struct JSON shape (for
        /newClient): the full exported field set of Cluster/Node
        (cluster.go:14-24,127-138) in struct order, so ``json.dumps(...,
        separators=(",", ":"))`` is byte-identical to Go's json.Marshal of
        a fresh cluster (nil RunningJobs map -> null, zero Durations -> 0).
        ``Gpus`` (a 3-dim-resource extension with no Go analogue) is
        appended only when nonzero — Go decoders ignore unknown fields, and
        gpu-less specs stay byte-exact."""
        nodes = []
        for n in self.nodes:
            d = {
                "Id": n.id,
                "Type": n.type,
                "URL": "",
                "Memory": n.memory,
                "Cores": n.cores,
                "MemoryAvailable": n.memory,
                "CoresAvailable": n.cores,
                "RunningJobs": None,
                "Time": 0,
            }
            if n.gpus:
                d["Gpus"] = n.gpus
            nodes.append(d)
        return {
            "Id": self.id,
            "Nodes": nodes,
            "URL": url,
            "TotalMemory": self.total_memory,
            "TotalCore": self.total_cores,
            "MemoryUtilization": 0,
            "CoreUtilization": 0,
        }


def _node_from_json(d: dict) -> NodeSpec:
    def g(*names, default=None):
        for n in names:
            if n in d:
                return d[n]
        if default is not None:
            return default
        raise KeyError(f"missing any of {names} in node spec {d}")

    return NodeSpec(
        id=int(g("Id", "id")),
        cores=int(g("Cores", "cores")),
        memory=int(g("Memory", "memory")),
        gpus=int(g("Gpus", "gpus", default=0)),
        type=str(g("Type", "type", default="physical")),
        device_type=int(g("DeviceType", "device_type", default=-1)),
    )


def cluster_from_json(d: dict) -> ClusterSpec:
    nodes = tuple(_node_from_json(n) for n in d.get("Nodes", d.get("nodes", [])))
    return ClusterSpec(id=int(d.get("Id", d.get("id", 0))), nodes=nodes)


def load_cluster_json(path: str) -> ClusterSpec:
    """Load a cluster spec from the reference's assets JSON schema."""
    with open(path) as f:
        return cluster_from_json(json.load(f))


def uniform_cluster(cluster_id: int, n_nodes: int, cores: int = 32,
                    memory: int = 24_000, gpus: int = 0,
                    device_type: int = -1) -> ClusterSpec:
    """Synthesize a cluster of identical nodes (the shape of both reference
    assets: 5 or 10 nodes x 32 cores x 24000 MB)."""
    return ClusterSpec(
        id=cluster_id,
        nodes=tuple(NodeSpec(id=i + 1, cores=cores, memory=memory, gpus=gpus,
                             device_type=device_type)
                    for i in range(n_nodes)),
    )


def node_types_array(specs: Sequence[ClusterSpec], max_nodes: int) -> np.ndarray:
    """Stack per-node device types into a padded [C, max_nodes] int32 tensor
    (the node half of the heterogeneity schema — ops/fields.py). A spec's
    explicit ``device_type`` wins; -1 derives accelerator (1) from gpu
    capacity; padded slots are standard (0, and never feasible anyway)."""
    C = len(specs)
    types = np.zeros((C, max_nodes), dtype=np.int32)
    for c, spec in enumerate(specs):
        for i, n in enumerate(spec.nodes[:max_nodes]):
            types[c, i] = n.device_type if n.device_type >= 0 else (
                1 if n.gpus > 0 else 0)
    return types


def capacities_array(specs: Sequence[ClusterSpec], max_nodes: int) -> np.ndarray:
    """Stack cluster specs into a padded [C, max_nodes, RES] int32 capacity
    tensor. Padded node slots have zero capacity (never feasible)."""
    C = len(specs)
    cap = np.zeros((C, max_nodes, RES), dtype=np.int32)
    for c, spec in enumerate(specs):
        if len(spec.nodes) > max_nodes:
            raise ValueError(
                f"cluster {spec.id} has {len(spec.nodes)} nodes > max_nodes={max_nodes}"
            )
        for i, n in enumerate(spec.nodes):
            cap[c, i, CORES] = n.cores
            cap[c, i, MEM] = n.memory
            cap[c, i, GPU] = n.gpus
    return cap
