"""The cross-cluster communication boundary (the port of
``multi_cluster_simulator_tpu/parallel/exchange.py``).

The reference's cross-cluster fabric is goroutine fan-out over HTTP with
first-response-wins races (BorrowResources, pkg/scheduler/server.go:183-243).
In the engine every cross-cluster decision is a batched op over the cluster
axis, and this module names the collectives those ops need, so that the
same engine code runs with the whole cluster axis on one device or sharded
over several:

- ``gather``  — see every cluster's request row
- ``allmin``  — global minimum across shards
- ``allmax``  — global maximum across shards (the market's rounding)
- ``allsum``  — global sum across shards (the market's column sums)
- ``alland``  — global AND across shards (the compressed driver's
  quiescence vote, ``Engine.run_compressed``)
- ``offset``  — my shard's global cluster offset

On one H100 the whole cluster axis is local: ``LocalExchange``, whose
collectives are identities. The sharded form (``MeshExchange``, over
``torch.distributed``) is ROADMAP A16.
"""

from __future__ import annotations

import torch


class Exchange:
    """Interface; see LocalExchange."""

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def allmin(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def allmax(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def allsum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def alland(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-shard logical AND of a bool: ``allmin`` over its 0/1
        form, as the reference's. The event-compressed driver's quiescence
        vote: every shard must see a fixed point before any shard leaps."""
        return self.allmin(x.to(torch.int32)) > 0

    def offset(self, c_local: int) -> int:
        raise NotImplementedError

    def global_index(self, c_local: int, device="cpu") -> torch.Tensor:
        """[c_local] int32 global indices of this shard's clusters."""
        return self.offset(c_local) + torch.arange(
            c_local, dtype=torch.int32, device=device)


class LocalExchange(Exchange):
    """One device: the cluster axis is whole; collectives are identities."""

    def gather(self, x):
        return x

    def allmin(self, x):
        return x

    def allmax(self, x):
        return x

    def allsum(self, x):
        return x

    def offset(self, c_local: int) -> int:
        return 0
