"""The cross-cluster communication boundary and the mesh (the port of
``multi_cluster_simulator_tpu/parallel/``)."""

from multi_cluster_simulator_tpu_torch.parallel.exchange import (
    Exchange, LocalExchange, MeshExchange,
)
from multi_cluster_simulator_tpu_torch.parallel.mesh import Mesh, make_mesh

def __getattr__(name):
    # core/engine.py imports parallel.exchange, and sharded_engine imports
    # core/engine.py: load it on first use
    if name == "ShardedEngine":
        from multi_cluster_simulator_tpu_torch.parallel.sharded_engine import (
            ShardedEngine,
        )
        return ShardedEngine
    raise AttributeError(name)


__all__ = ["Exchange", "LocalExchange", "MeshExchange", "Mesh", "make_mesh",
           "ShardedEngine"]
