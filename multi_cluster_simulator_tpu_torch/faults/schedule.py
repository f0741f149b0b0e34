"""The fault plane's state leaves (the port of the ``FaultState`` half of
``multi_cluster_simulator_tpu/faults/schedule.py``).

Only the inert, all-healthy state of a faults-off run is ported: it rides
``SimState`` so the state keeps the reference's leaves, dtypes and shapes
(``fail_t``/``repair_t`` [C, N, max_events] NEVER-filled, ``key`` [C, 2]
uint32 zeros). Fault schedules, the counter-based generative samplers and
the fault phase itself are ROADMAP A8.
"""

from __future__ import annotations

import dataclasses

import torch

from multi_cluster_simulator_tpu_torch.config import FaultConfig
from multi_cluster_simulator_tpu_torch.ops.fields import NEVER_I
from multi_cluster_simulator_tpu_torch.utils.tree import Tree


@dataclasses.dataclass
class FaultState(Tree):
    health: torch.Tensor  # [C, N] bool — True = up
    was_active: torch.Tensor  # [C, N] bool — node_active at fail time
    next_fail: torch.Tensor  # [C, N] i32 — clock of the next failure
    down_until: torch.Tensor  # [C, N] i32 — repair clock while down
    down_since: torch.Tensor  # [C, N] i32 — fail clock of the outage
    n_fails: torch.Tensor  # [C, N] i32 — completed outages
    kills: torch.Tensor  # [C] i32
    requeues: torch.Tensor  # [C] i32
    down_ms: torch.Tensor  # [C] i32
    fail_t: torch.Tensor  # [C, N, E] i32 — trace-mode interval starts
    repair_t: torch.Tensor  # [C, N, E] i32 — trace-mode interval ends
    key: torch.Tensor  # [C, 2] u32 — per-cluster generative stream root


def init_fault_state(fc: FaultConfig, C: int, N: int,
                     device) -> FaultState:
    """The pristine all-healthy fault state of a faults-off run, leaf for
    leaf what the reference's ``init_fault_state`` builds then."""
    if fc.enabled:
        raise NotImplementedError(
            "the fault plane (faults.enabled) is not ported yet: ROADMAP A8")
    E = max(int(fc.max_events), 1)

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=device)

    zc = full((C,), 0)
    return FaultState(
        health=full((C, N), True, torch.bool),
        was_active=full((C, N), False, torch.bool),
        next_fail=full((C, N), NEVER_I),
        down_until=full((C, N), NEVER_I),
        down_since=full((C, N), 0),
        n_fails=full((C, N), 0),
        kills=zc, requeues=zc.clone(), down_ms=zc.clone(),
        fail_t=full((C, N, E), NEVER_I),
        repair_t=full((C, N, E), NEVER_I),
        key=full((C, 2), 0, torch.uint32))
