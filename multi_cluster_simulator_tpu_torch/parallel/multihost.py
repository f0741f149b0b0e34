"""Multi-process (multi-host) scale-out: the cluster axis sharded across
independently started processes (the port of
``multi_cluster_simulator_tpu/parallel/multihost.py``).

The reference spans hosts by launching scheduler/trader OS processes
anywhere and wiring them over HTTP/gRPC through the registry (SURVEY.md
§2.9). The JAX package forms one global device set with
``jax.distributed.initialize``; the port forms one ``torch.distributed``
process group from a rendezvous, the well-known place every process meets
at, as the registry is for the live constellation: the environment
variables ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), or a file store on a path every process can reach. The
ONE ``ShardedEngine`` code path then runs with its mesh spanning the
processes: per-cluster phases stay local, the cross-cluster exchanges ride
the group's collectives.

Every process builds the same global inputs deterministically (seeded
workloads make this free) and keeps its own shard (``shard_inputs_global``);
``gather_to_host`` brings a sharded tensor back whole to every process.

Start two processes of one group by hand::

    python -m multi_cluster_simulator_tpu_torch.tools.multihost_scaling \\
        --worker --rank 0 --world 2 --store /tmp/mcs.store --device cpu &
    python -m multi_cluster_simulator_tpu_torch.tools.multihost_scaling \\
        --worker --rank 1 --world 2 --store /tmp/mcs.store --device cpu
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from multi_cluster_simulator_tpu_torch.parallel.mesh import Mesh, make_mesh


def init_group(rank=None, world_size=None, store_path=None,
               timeout_s: float = 600) -> None:
    """Join the process group (gloo) once per process: through a
    ``FileStore`` at ``store_path`` where one is given, else from the
    ``torchrun`` environment (``init_method="env://"``). ``rank`` and
    ``world_size`` default to ``RANK`` and ``WORLD_SIZE``."""
    if dist.is_initialized():
        return
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else int(world_size))
    timeout = datetime.timedelta(seconds=timeout_s)
    if store_path is not None:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size, timeout=timeout)
    else:
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=world_size, timeout=timeout)


def global_mesh(axis: str = "clusters", device=None) -> Mesh:
    """A mesh over every rank of the process group (``init_group`` first)."""
    return make_mesh(axis=axis, device=device)


def shard_inputs_global(sh, state, arrivals):
    """The multi-process form of ``ShardedEngine.shard_inputs``: every
    process passes the same deterministically built global state and
    arrivals and keeps the shard its rank owns. One placement walk exists,
    ``shard_inputs``'; in the port every rank already takes only its own
    slice, so this is that walk."""
    return sh.shard_inputs(state, arrivals)


def gather_to_host(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """A tensor sharded on its leading axis, gathered whole to every
    process as host numpy: the readback half of the multi-host story."""
    from multi_cluster_simulator_tpu_torch.parallel.exchange import (
        MeshExchange,
    )
    return MeshExchange(mesh).gather(x).cpu().numpy()
