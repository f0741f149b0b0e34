"""Carry a ``SimState``, a ``PolicyParams``, a ``TickIO``, a
``MetricsBuffer`` or a ``MetricSample`` series between the port and the
JAX package as numpy.

There are no weights in this system: the state, the policy parameter
leaves and the arrival stream take their place. A state crosses as a dict
of numpy arrays keyed by leaf path — ``.node_free``, ``.l0.data``,
``.drops.queue`` (``.ffd_mem_first`` for params) — which is how
``jax.tree_util.keystr`` spells the paths of
``jax.tree_util.tree_flatten_with_path`` on the JAX pytree. A compact state
(core/compact.py) crosses the same way, its queues and running set as
their SoA leaves (``.l0.f_cores``, ``.l0.ovf``, ``.run.f_node``) in their
storage dtypes. A lane-stacked batch (a tenant batch, an env batch)
crosses the same way, every leaf with its leading [L]: a stacked
``SimState`` through ``state_from_numpy``, stacked ``TenantParams``
through ``tenant_params_from_numpy`` (``.policy.idx``, ``.fault_seed``),
an ``EnvState`` through ``env_state_from_numpy`` (``.sim.l0.data``,
``.key``, ``.t_ep``). A mesh rank's shard crosses the same way:
``shard_to_numpy`` cuts rank r's rows out of a global dict, and
``gathered_to_numpy`` gives a shard's global dict back. The port never
imports jax; the caller (a test) builds the JAX side of the dict.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.core.state import SimState, resolve_device
from multi_cluster_simulator_tpu_torch.envs.cluster_env import EnvInfo, EnvState
from multi_cluster_simulator_tpu_torch.obs.device import MetricsBuffer
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import runset as R
from multi_cluster_simulator_tpu_torch.policies.base import PolicyParams
from multi_cluster_simulator_tpu_torch.tenancy.params import TenantParams
from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys


# a field typed with a wide class holds its compact class where the leaves
# are the compact layout's (keyed by the class's first SoA leaf)
_COMPACT = {Q.JobQueue: (Q.SoAJobQueue, ".f_id"),
            R.RunningSet: (R.SoARunningSet, ".f_end_t")}


def _build(cls, leaves: dict, prefix: str, device, used: set):
    if cls in _COMPACT and prefix + _COMPACT[cls][1] in leaves:
        cls = _COMPACT[cls][0]
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}.{f.name}"
        tp = hints[f.name]
        if dataclasses.is_dataclass(tp):
            kw[f.name] = _build(tp, leaves, key, device, used)
        else:
            if key not in leaves:
                raise KeyError(f"state leaf {key} missing")
            used.add(key)
            arr = np.array(leaves[key], copy=True)
            kw[f.name] = torch.from_numpy(arr).to(device)
    return cls(**kw)


def _from_numpy(cls, leaves: dict, device):
    dev = resolve_device(device)
    used: set = set()
    tree = _build(cls, leaves, "", dev, used)
    extra = set(leaves) - used
    if extra:
        raise KeyError(f"leaves the port's {cls.__name__} does not have: "
                       f"{sorted(extra)}")
    return tree


def to_numpy(tree) -> dict:
    """A state's or params' leaves as host numpy arrays, keyed like
    ``state_from_numpy`` and ``params_from_numpy`` take them."""
    return {k: v.detach().cpu().numpy() for k, v in leaves_with_keys(tree)}


def leaves_digest(leaves: dict) -> str:
    """sha256 over numpy leaves keyed by path (``to_numpy``, or a JAX
    state's ``jax.tree_util.keystr`` paths): each leaf's key, dtype,
    shape and bytes, in key order. Two states share a digest only if
    every leaf is bitwise equal."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(leaves):
        a = np.ascontiguousarray(leaves[k])
        h.update(f"{k}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def state_from_numpy(leaves: dict, device=None) -> SimState:
    """A port ``SimState`` from numpy leaves keyed by path, on ``device``
    (the card by default). Values and dtypes are taken as given; every
    leaf of the port's state must be present, and no other."""
    return _from_numpy(SimState, leaves, device)


def params_from_numpy(leaves: dict, device=None) -> PolicyParams:
    """A port ``PolicyParams`` from numpy leaves keyed by path, on
    ``device``, under the same rules as ``state_from_numpy``."""
    return _from_numpy(PolicyParams, leaves, device)


state_to_numpy = params_to_numpy = to_numpy
# a TickIO (one tick's or run_io's stack) crosses the same way: keyed
# .borrow_want, .borrow_job, .ret_rows, .ret_valid, as the reference's
io_to_numpy = to_numpy


def metrics_from_numpy(leaves: dict, device=None) -> MetricsBuffer:
    """A port ``MetricsBuffer`` from numpy leaves keyed by path
    (``.ticks``, ``.placed``, ``.depth_hist``, ...), on ``device``, under
    the same rules as ``state_from_numpy``."""
    return _from_numpy(MetricsBuffer, leaves, device)


# a MetricsBuffer and a MetricSample series cross the same way, keyed like
# the reference's (.placed, .ring_t; .t, .jobs_in_queue, .avg_wait_ms)
metrics_to_numpy = series_to_numpy = to_numpy


def tenant_params_from_numpy(leaves: dict, device=None) -> TenantParams:
    """Port ``TenantParams`` (one cell or a stacked batch) from numpy
    leaves keyed by path (``.policy.max_wait_ms``, ``.fault_seed``)."""
    return _from_numpy(TenantParams, leaves, device)


def env_state_from_numpy(leaves: dict, device=None) -> EnvState:
    """A port ``EnvState`` (one env or a batch) from numpy leaves keyed by
    path (``.sim.node_free``, ``.key``, ``.episodes``)."""
    return _from_numpy(EnvState, leaves, device)


def env_info_from_numpy(leaves: dict, device=None) -> EnvInfo:
    """A port ``EnvInfo`` from numpy leaves keyed by path."""
    return _from_numpy(EnvInfo, leaves, device)


# stacked TenantParams, an EnvState and an EnvInfo cross back the same way
tenant_params_to_numpy = env_state_to_numpy = env_info_to_numpy = to_numpy


def shard_to_numpy(leaves: dict, rank: int, n: int) -> dict:
    """Rank ``rank``'s shard of a global state's numpy leaves over ``n``
    ranks, as ``parallel.ShardedEngine.shard_state`` places it: every
    leaf but the clock ``.t`` split on its leading (cluster) axis."""
    out = {}
    for k, v in leaves.items():
        if k == ".t":
            out[k] = np.array(v, copy=True)
            continue
        b = v.shape[0] // n
        out[k] = np.array(v[rank * b:(rank + 1) * b], copy=True)
    return out


def gathered_to_numpy(sharded_engine, state) -> dict:
    """The global numpy leaves of a mesh rank's shard ``state``, gathered
    from every rank (a collective: every rank calls it)."""
    return to_numpy(sharded_engine.gather_state(state))
