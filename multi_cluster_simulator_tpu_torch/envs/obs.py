"""Observation featurization: SimState -> a fixed-shape [C, N_OBS] f32
tensor a policy head can consume (the port of
``multi_cluster_simulator_tpu/envs/obs.py``).

The features read only what both state layouts share — queue ``count``
columns, the running set's ``active`` mask, ``avg_wait_ms`` and the node
columns widened through ``ops/fields.widen`` — so one function serves the
wide and the compact layout bit for bit. Counts and occupancies are
normalised by their static bounds; free capacity is bucketed by node
device type, the axis the rl action matrix scores.
"""

from __future__ import annotations

import torch

from multi_cluster_simulator_tpu_torch.config import SimConfig
from multi_cluster_simulator_tpu_torch.core import state as st
from multi_cluster_simulator_tpu_torch.core.state import SimState
from multi_cluster_simulator_tpu_torch.ops import fields as F

# scalar features per cluster, before the per-device-type blocks: 4 queue
# depths (l0, l1, ready, wait), running occupancy, jobs_in_queue, and the
# average wait in seconds
_N_SCALAR = 7


def n_obs_features(cfg: SimConfig) -> int:
    """Observation width per cluster: the scalar block plus, per device
    type, an active-node fraction and one free fraction per resource."""
    return _N_SCALAR + F.N_DEVICE_TYPES * (1 + cfg.n_res)


def observe(s: SimState, cfg: SimConfig) -> torch.Tensor:
    """[..., C, n_obs_features(cfg)] f32 for a constellation, or a batch of
    them (any leading lane axes), bitwise the reference's: the one-hot
    contractions sum integer-valued f32 below 2^24, exact in any order."""
    f32 = torch.float32
    qc = float(max(cfg.queue_capacity, 1))
    run_frac = (s.run.active.sum(-1, dtype=torch.int32).to(f32)
                / float(max(cfg.max_running, 1)))
    scalars = [
        s.l0.count.to(f32) / qc,
        s.l1.count.to(f32) / qc,
        s.ready.count.to(f32) / qc,
        s.wait.count.to(f32) / qc,
        run_frac,
        s.jobs_in_queue.to(f32) / qc,
        st.avg_wait_ms(s) * 1e-3,  # seconds, the reward's scale
    ]
    free = F.widen(s.node_free).to(f32)  # [..., C, N, R]
    cap = F.widen(s.node_cap).to(f32)
    active = s.node_active.to(f32)  # [..., C, N]
    nt = s.node_type.clamp(0, F.N_DEVICE_TYPES - 1)
    types = torch.arange(F.N_DEVICE_TYPES, dtype=torch.int32,
                         device=nt.device)
    type_hot = (nt[..., None] == types).to(f32) * active[..., None]
    n_nodes = float(max(cfg.total_nodes, 1))
    active_frac = type_hot.sum(-2) / n_nodes  # [..., C, DT]
    # the contractions over nodes as products and sums, not a matrix
    # product a TF32 setting could round
    free_dt = (type_hot[..., None] * free[..., None, :]).sum(-3)
    cap_dt = (type_hot[..., None] * cap[..., None, :]).sum(-3)
    free_frac = free_dt / cap_dt.clamp(min=1.0)  # [..., C, DT, R]
    return torch.cat(
        [torch.stack(scalars, -1), active_frac,
         free_frac.reshape(*free_frac.shape[:-2],
                           F.N_DEVICE_TYPES * cfg.n_res)], -1)
