"""Carry a ``SimState`` or a ``PolicyParams`` between the port and the JAX
package as numpy.

There are no weights in this system: the state, the policy parameter
leaves and the arrival stream take their place. A state crosses as a dict
of numpy arrays keyed by leaf path — ``.node_free``, ``.l0.data``,
``.drops.queue`` (``.ffd_mem_first`` for params) — which is how
``jax.tree_util.keystr`` spells the paths of
``jax.tree_util.tree_flatten_with_path`` on the JAX pytree. The port never
imports jax; the caller (a test) builds the JAX side of the dict.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.core.state import SimState, resolve_device
from multi_cluster_simulator_tpu_torch.policies.base import PolicyParams
from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys


def _build(cls, leaves: dict, prefix: str, device, used: set):
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
