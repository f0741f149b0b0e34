"""Lender-side virtual-node carving — AllocateVirtualNodeResources
(pkg/scheduler/cluster.go:87-125) as a loop over the node axis, batched
over clusters (the port of ``multi_cluster_simulator_tpu/ops/carve.py``).

The Go walk computes, per node, ``diff = |req - avail|`` per resource,
decrements the request by ``diff`` (zeroing it when ``diff > req``) and
occupies ``diff`` on the node as a placeholder "Foreign" job for the
contract duration. ``mode="asbuilt"`` keeps that request arithmetic, so
whether a carve succeeds matches the Go outcome, and clamps the occupancy
to ``[0, avail]`` (the Go code can occupy more than a node has free, which
wraps its unsigned counters: MARKET.md §carving). ``mode="sane"`` takes
``min(req, avail)`` per node.
"""

from __future__ import annotations

import torch

from multi_cluster_simulator_tpu_torch.ops.queues import I32


def carve_plan(free: torch.Tensor, active: torch.Tensor,
               req_cores: torch.Tensor, req_mem: torch.Tensor,
               req_gpu: torch.Tensor, mode: str = "asbuilt"):
    """Plan each cluster's carve across its node axis.

    ``free`` [C, N, R] and ``active`` [C, N]: the walk visits every real
    node in order, virtual ones included, and skips inactive padded slots
    (an avail-0 slot would otherwise zero the remaining request under the
    as-built abs-diff arithmetic and fake a successful carve). The
    requests are [C] int32. Returns (amounts [C, N, R] int32, ok [C] bool),
    ``ok`` when the request was fully consumed (cluster.go:119-122)."""
    if mode not in ("asbuilt", "sane"):
        raise ValueError(f"unknown carve mode {mode!r}")
    req = torch.stack([req_cores, req_mem, req_gpu], dim=-1).to(I32)
    avail = free.clamp(min=0)  # [C, N, R]
    skip = ~active[..., None]  # [C, N, 1]
    amounts = []
    for n in range(free.shape[1]):
        a = avail[:, n]
        if mode == "asbuilt":
            # d >= 0, so the reference's clip(d, 0, avail) is min(d, avail)
            d = torch.where(req > 0, (req - a).abs(), 0)
            new_req = torch.where(d > req, 0, req - d)
            occ = torch.minimum(d, a)
        else:
            occ = torch.minimum(req, a)
            new_req = req - occ
        req = torch.where(skip[:, n], req, new_req)
        amounts.append(torch.where(skip[:, n], 0, occ))
    return torch.stack(amounts, dim=1).to(I32), (req <= 0).all(dim=-1)
