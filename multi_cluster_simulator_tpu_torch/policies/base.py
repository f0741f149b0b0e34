"""Policy dispatch, FIFO only (the port's counterpart of
``multi_cluster_simulator_tpu/policies/base.py:_run_kind``).

The reference's policy zoo — ``PolicyParams`` leaves, the registry,
``PolicySet`` and its traced ``lax.switch`` — is ROADMAP A5. This slice
runs the one kernel kind the headline uses and refuses the others.
"""

from __future__ import annotations

from multi_cluster_simulator_tpu_torch.config import SimConfig
from multi_cluster_simulator_tpu_torch.core.state import SimState
from multi_cluster_simulator_tpu_torch.policies import kernels as K


def _run_kind(kind: str, state: SimState, t: int, cfg: SimConfig):
    """One policy's whole scheduling pass over every cluster. Returns
    ``(state, borrow_want [C], borrow_job rows [C, NF])`` like the
    reference."""
    if kind != "fifo":
        raise NotImplementedError(
            f"policy kind {kind!r} is not ported yet: ROADMAP A5")
    state, want, bjob = K._fifo_local(state, t, cfg)
    return state, want, bjob.vec
