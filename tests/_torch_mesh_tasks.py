"""Rank-side tasks of the port's mesh tests (``tests/test_torch_mesh*.py``).

Each function runs on every rank of a mesh that
``multi_cluster_simulator_tpu_torch.parallel.launch.RankGroup`` started,
as ``fn(mesh, ...)``. This module imports only the port (and numpy), so
the rank processes load no JAX. Results cross back as numpy: rank 0
returns the gathered global view, the other ranks None.
"""

from __future__ import annotations

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.obs import device as obs_device
from multi_cluster_simulator_tpu_torch.parallel import (
    MeshExchange, ShardedEngine,
)


def _np(tree) -> dict:
    return interop.to_numpy(tree)


def run_sharded(mesh, cfg, specs, arrivals, n_ticks, tick_indexed=False,
                time_compress=False, plan=None, policies=None,
                params=None, metrics=False, chunks=None, fault_events=None):
    """The global ``init_state(cfg, specs, plan, fault_events)`` sharded
    over ``mesh`` and run ``n_ticks`` (over ``chunks`` successive
    ``TickArrivals`` when given, each a run of its own length), with the
    ``PolicySet`` of the names ``policies`` and ``params`` (numpy leaves,
    or a member's name); returns on rank 0 a dict of the gathered state,
    series, stats, metrics buffer (the ``collect_metrics`` view) and the
    collectives a tick ran."""
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet

    sh = ShardedEngine(cfg, mesh, policies=policies and PolicySet(policies))
    state = tstate.init_state(cfg, specs, plan=plan,
                              fault_events=fault_events, device="cpu")
    s = sh.shard_state(state)
    rest = ()
    if isinstance(params, str):  # a member of ``policies`` by name
        rest += (sh.engine.pset.params_for(cfg, params, device=mesh.device),)
    elif params is not None:
        rest += (interop.params_from_numpy(params, mesh.device),)
    mb = None
    if metrics:
        mb = sh.shard_metrics(obs_device.metrics_init(state))
    parts = chunks if chunks is not None else [arrivals]
    out = {}
    series = []
    for part in parts:
        n = part.counts.shape[0] if chunks is not None else n_ticks
        fn = sh.run_fn(n, tick_indexed=tick_indexed or chunks is not None,
                       time_compress=time_compress,
                       with_params=params is not None, with_metrics=metrics)
        res = fn(s, sh.shard_arrivals(part), *rest,
                 *((mb,) if metrics else ()))
        res = res if isinstance(res, tuple) else (res,)
        s = res[0]
        k = 1
        if cfg.record_metrics:
            series.append(sh.gather_series(res[k]))
            k += 1
        if time_compress:
            out["stats"] = _np(res[k])
            k += 1
        if metrics:
            mb = res[k]
    out["state"] = interop.gathered_to_numpy(sh, s)
    if series:
        out["series"] = {k: np.concatenate([_np(x)[k] for x in series])
                         for k in _np(series[0])}
    if metrics:
        out["mbuf"] = _np(sh.collect_metrics(mb))
    out["calls_per_tick"] = sh.ex.calls / max(n_ticks, 1)
    return out if mesh.rank == 0 else None


def exchange_ops(mesh, parts: np.ndarray, ints: np.ndarray):
    """Each collective of ``MeshExchange`` on this rank's row of
    ``parts`` [n, ...] f32 and ``ints`` [n, ...] i32."""
    ex = MeshExchange(mesh)
    r = mesh.rank
    x = torch.from_numpy(parts[r].copy())
    i = torch.from_numpy(ints[r].copy())
    out = {"allsum": ex.allsum(x).numpy(), "gather": ex.gather(i).numpy(),
           "allmin": ex.allmin(i).numpy(), "allmax": ex.allmax(i).numpy(),
           "fmax": ex.allmax(x).numpy(),
           "alland": bool(ex.alland(torch.tensor(r != 1 or
                                                 mesh.size == 1))),
           "offset": ex.offset(5), "total": ex.total(5),
           "gidx": ex.global_index(3).numpy(),
           "bool_gather": ex.gather(i > 0).numpy()}
    return out


def jitter_table(mesh, cfg, c_loc):
    """The sharded engine's jitter table on every rank (rank order)."""
    sh = ShardedEngine(cfg, mesh)
    return (mesh.rank, sh.engine.jitter(c_loc).numpy())


def mesh_cut(mesh, cfg, specs, first, second, plan=None, fault_events=None,
             path=None, resume=False):
    """The mesh cut (tests/test_preempt.py:173): ``first`` on the shard,
    ``save_run_sharded`` to ``path`` (one file), ``load_run_sharded`` back
    and ``second`` to the end; with ``resume`` only the load of ``path``
    (a one-process file) and ``second``. Rank 0 returns the gathered final
    state."""
    from multi_cluster_simulator_tpu_torch.core import preempt

    sh = ShardedEngine(cfg, mesh)

    def template():
        return tstate.init_state(cfg, specs, plan=plan,
                                 fault_events=fault_events, device="cpu")

    kw = dict(cfg=cfg, plan=plan)
    if not resume:
        s = sh.run_fn(first.counts.shape[0], tick_indexed=True, donate=True)(
            sh.shard_state(template()), sh.shard_arrivals(first))
        preempt.save_run_sharded(path, sh, s, tick_ms=cfg.tick_ms, **kw)
    s = preempt.load_run_sharded(path, sh, template(), **kw).state
    s = sh.run_fn(second.counts.shape[0], tick_indexed=True, donate=True)(
        s, sh.shard_arrivals(second))
    g = interop.gathered_to_numpy(sh, s)
    return g if mesh.rank == 0 else None


def env_sharded(mesh, cfg, specs, ta, n_envs, seed, steps, plan=None):
    """tests/test_env.py:98's batch: ``n_envs`` replay envs reset from
    ``prng_key(seed)``, sharded over the mesh (``shard_env_batch``),
    stepped ``steps`` times; rank 0 returns the gathered batch's sim
    leaves."""
    from multi_cluster_simulator_tpu_torch.envs import (
        ClusterEnv, shard_env_batch,
    )
    from multi_cluster_simulator_tpu_torch.parallel.sharded_engine import (
        gather_batch,
    )
    from multi_cluster_simulator_tpu_torch.utils import prng

    env = ClusterEnv(cfg, specs, episode_ticks=steps + 5, arrivals=ta,
                     plan=plan, device=mesh.device)
    _, es = env.reset_batch(prng.prng_key(seed), n_envs)
    es = shard_env_batch(es, mesh)
    step = env.batch_step_fn()
    for _ in range(steps):
        _, _, _, _, es = step(es, None)
    g = _np(gather_batch(es.sim, mesh))
    return g if mesh.rank == 0 else None


def tenants_sharded(mesh, cfg, specs, policies, params, rows, counts):
    """A tenant batch's ``run_io_fn`` over the mesh: the stacked states,
    params and streams split on the tenant axis (``shard_tenant_batch``),
    each rank running its tenants; rank 0 returns the gathered state and
    TickIO leaves."""
    from multi_cluster_simulator_tpu_torch import tenancy
    from multi_cluster_simulator_tpu_torch.parallel.sharded_engine import (
        gather_batch,
    )
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet

    tb = tenancy.TenantBatch(cfg, specs, policies=policies and
                             PolicySet(policies), device=mesh.device)
    tp = interop.tenant_params_from_numpy(params, device="cpu")
    state = tenancy.shard_tenant_batch(tb.init_stacked(tp), mesh)
    tp = tenancy.shard_tenant_batch(tp, mesh)
    b = rows.shape[0] // mesh.size
    cut = slice(mesh.rank * b, (mesh.rank + 1) * b)
    out, io = tb.run_io_fn()(state, rows[cut], counts[cut], tp)
    g = (_np(gather_batch(out, mesh)), _np(gather_batch(io, mesh)))
    return g if mesh.rank == 0 else None
