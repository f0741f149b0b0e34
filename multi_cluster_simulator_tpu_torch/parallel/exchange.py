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

With the whole cluster axis on one device the exchange is
``LocalExchange``, whose collectives are identities. Sharded over a mesh
(``parallel/mesh.py``: ranks of a ``torch.distributed`` gloo group) it is
``MeshExchange``: each rank holds ``C_loc = C_tot / n`` clusters.

Every ``MeshExchange`` collective is staged through host tensors: the
operand is copied to the CPU, the gloo collective runs there, and the
result is copied back to the operand's device. gloo takes CUDA tensors
for all-reduce and broadcast only, not for all-gather, and ranks that
share one card cannot use NCCL; staging all of them keeps one code path
and costs a host sync per collective, which the mesh's correctness runs
accept. ``allsum`` gathers every shard's partial and sums the stacked
shard axis in one fixed order (the reference's ``jnp.sum(parts, axis=0)``
as XLA's CPU code runs it: from +0.0, shard 0 first), so the result does
not depend on gloo's reduction tree.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Exchange:
    """Interface; see LocalExchange / MeshExchange. ``size`` is the shard
    count."""

    size = 1

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

    def total(self, c_local: int) -> int:
        """The global cluster count of shards of ``c_local`` clusters."""
        return c_local * self.size

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


class MeshExchange(Exchange):
    """Over a ``parallel.mesh.Mesh``: per-rank tensors carry ``C_local =
    C_total / n_shards`` clusters; decisions that need every cluster's row
    ride the group's collectives, staged through the host (the module's
    docstring). ``calls`` counts the collectives this exchange ran."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axis_name = mesh.axis
        self.size = mesh.size
        self.calls = 0

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` copied to the host in a dtype gloo carries: gloo has no
        16-bit integers (int16 crosses as int32) and no unsigned 32-bit
        ones (uint32, the fault plane's keys, crosses as its int32 bits:
        gathered only, never reduced)."""
        h = x.detach().to("cpu", copy=True).contiguous()
        if h.dtype == torch.int16:
            return h.to(torch.int32)
        if h.dtype == torch.uint32:
            return h.view(torch.int32)
        return h

    @staticmethod
    def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if like.dtype == torch.uint32:
            h = h.view(torch.uint32)
        return h.to(device=like.device, dtype=like.dtype)

    def _parts(self, x: torch.Tensor) -> list:
        """Every shard's ``x``, in rank order, on the host."""
        h = self._host(x)
        parts = [torch.empty_like(h) for _ in range(self.size)]
        if h.numel():
            self.calls += 1
            dist.all_gather(parts, h, group=self.mesh.group)
        return parts

    def gather(self, x):
        return self._back(torch.cat(self._parts(x), 0), x)

    def _reduce(self, x, op):
        h = self._host(x)
        if h.numel():
            self.calls += 1
            dist.all_reduce(h, op=op, group=self.mesh.group)
        return self._back(h, x)

    def allmin(self, x):
        return self._reduce(x, dist.ReduceOp.MIN)

    def allmax(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def allsum(self, x):
        """Cross-shard sum in one fixed order: every shard's partial
        gathered, then summed over the shard axis from +0.0 in rank order,
        as XLA's CPU code reduces the reference's stacked [n_shards, ...]
        axis."""
        parts = self._parts(x)
        acc = torch.zeros_like(parts[0])
        for p in parts:
            acc = acc + p
        return self._back(acc, x)

    def offset(self, c_local: int) -> int:
        return self.mesh.rank * c_local
