"""Per-tenant knobs as data: the ``TenantParams`` tree (the port of
``multi_cluster_simulator_tpu/tenancy/params.py``).

A tenant batch runs T independent constellations as the lanes of one
lane-stacked run, so everything that varies per tenant is a tensor leaf
with a leading [T], never a config field:

- the policy selector and every policy and market parameter live in
  ``PolicyParams`` (policies/base.py: ``idx``, ``max_wait_ms``, the gavel
  and tesserae leaves, the ``mkt_*`` solver knobs), which
  ``TenantParams`` embeds whole;
- ``fault_seed`` roots the tenant's generative churn stream (per-tenant
  failure patterns from one shared ``FaultConfig`` shape), and
  ``quota_jobs`` is the serving tier's admission budget, which the engine
  never reads.

Shapes stay shared, padded to the tenant maximum: ``queue_capacity``,
``max_nodes``, ``max_running`` are array shapes of the one stacked state.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Sequence

import torch

from multi_cluster_simulator_tpu_torch.config import SimConfig
from multi_cluster_simulator_tpu_torch.policies.base import (
    PolicyParams, PolicySet, params_digest,
)
from multi_cluster_simulator_tpu_torch.utils.tree import Tree


@dataclasses.dataclass
class TenantParams(Tree):
    """One tenant's knobs (stack cells leaf-wise for a batch)."""

    policy: PolicyParams  # selector, policy and market parameters
    fault_seed: torch.Tensor  # [] u32 — the generative churn stream's root
    quota_jobs: torch.Tensor  # [] i32 — admission budget (-1 = unmetered)


def default_tenant_params(cfg: SimConfig, pset: Optional[PolicySet] = None,
                          name: Optional[str] = None,
                          policy: Optional[PolicyParams] = None,
                          fault_seed: int = 0, quota_jobs: int = -1,
                          device="cpu") -> TenantParams:
    """A single tenant cell on ``device``: the config's defaults for member
    ``name`` of ``pset`` (the config's singleton set when omitted), or an
    explicit ``policy``, plus the hoisted per-tenant leaves."""
    if policy is None:
        pset = PolicySet.from_config(cfg) if pset is None else pset
        policy = pset.params_for(cfg, name, device=device)
    return TenantParams(
        policy=policy,
        fault_seed=torch.tensor(int(fault_seed) & 0xFFFFFFFF,
                                dtype=torch.int64).to(torch.uint32)
        .to(device),
        quota_jobs=torch.tensor(int(quota_jobs), dtype=torch.int32,
                                device=device))


def stack_tenant_params(cells: Sequence[TenantParams]) -> TenantParams:
    """Stack per-tenant cells on a leading [T] axis."""
    if not cells:
        raise ValueError("stack_tenant_params needs at least one tenant")
    from multi_cluster_simulator_tpu_torch.tenancy.host import stack_lanes
    return stack_lanes(cells)


def tenant_params_digest(tp: TenantParams) -> str:
    """12-hex provenance digest over every tenant leaf, the reference's
    character for character: sha1 over the policy's ``params_digest`` and
    the JSON of the hoisted leaves."""
    h = hashlib.sha1()
    h.update(params_digest(tp.policy).encode())
    extra = {
        "fault_seed": tp.fault_seed.detach().cpu().numpy().tolist(),
        "quota_jobs": tp.quota_jobs.detach().cpu().numpy().tolist(),
    }
    h.update(json.dumps(extra, sort_keys=True).encode())
    return h.hexdigest()[:12]
