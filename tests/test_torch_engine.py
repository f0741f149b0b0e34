"""The PyTorch port's whole slice against the JAX package, on the CPU.

A quick headline shape — FIFO parity, 5-node ``uniform_cluster``s, queue 8,
running set 32 — runs through the port's ``Engine.run_chunks`` in two
chunks whose K differs, and through the JAX ``Engine.run_jit`` over one
``pack_arrivals_by_tick`` bucket, both unfused and with the Pallas prefix
kernel (``fused="on"``, interpret mode on the CPU). Every ``SimState`` leaf
must be equal, value and dtype, with no tolerance; so must the placement
traces. The helpers here are shared by the other ``test_torch_*`` files.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import PolicyKind, SimConfig
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.utils.trace import extract_trace as jextract
from multi_cluster_simulator_tpu.workload.traces import uniform_stream
from multi_cluster_simulator_tpu_torch import config as tconfig
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.kernels import fused_tick as tfused
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from multi_cluster_simulator_tpu_torch.workload import traces as ttraces

C = 16
JOBS = 40
CHUNKS = [40, 30]  # 70 ticks; the two chunks bucket to different K


def headline_cfg(**kw):
    """The headline's FIFO-parity config at test scale (the JAX class)."""
    base = dict(policy=PolicyKind.FIFO, queue_capacity=8, max_running=32,
                max_arrivals=JOBS, max_ingest_per_tick=8, parity=True,
                n_res=2, max_nodes=5, max_virtual_nodes=0,
                record_trace=True, max_trace_events=512)
    base.update(kw)
    return SimConfig(**base)


def port_cfg(cfg: SimConfig) -> tconfig.SimConfig:
    """The same config as the port's class, field by field."""
    def conv(obj, cls):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                v = conv(v, getattr(tconfig, type(v).__name__))
            elif hasattr(v, "value") and type(v).__name__ in (
                    "PolicyKind", "MatchKind"):
                v = getattr(tconfig, type(v).__name__)(v.value)
            kw[f.name] = v
        return cls(**kw)
    return conv(cfg, tconfig.SimConfig)


def jax_leaves(state) -> dict:
    """A JAX state's leaves as numpy, keyed like the port's interop."""
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def assert_leaves_equal(want: dict, got: dict):
    """Every leaf equal in key set, dtype, shape and value (no tolerance)."""
    assert set(want) == set(got)
    for k in want:
        a, b = want[k], got[k]
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


def stream(n_clusters=C, jobs=JOBS, horizon_ms=60_000, seed=9, **kw):
    """The headline's stream shape at test scale, from the JAX package and
    from the port's copy (tests/test_torch_copies.py pins them equal)."""
    args = dict(max_cores=8, max_mem=6_000, max_dur_ms=20_000, seed=seed)
    args.update(kw)
    return (uniform_stream(n_clusters, jobs, horizon_ms, **args),
            ttraces.uniform_stream(n_clusters, jobs, horizon_ms, **args))


def specs(n_clusters=C):
    return ([uniform_cluster(c + 1, 5) for c in range(n_clusters)],
            [tspec.uniform_cluster(c + 1, 5) for c in range(n_clusters)])


def load_lent(jstate, seed, max_rows=3):
    """The JAX state with 1..``max_rows`` foreign jobs in each cluster's
    lent queue, so that the FIFO pass's lent-head attempt runs (borrowing
    fills that queue; the headline path leaves it empty). The jobs are
    small, owned by the next cluster, and have ids from 10,000 up."""
    data = np.asarray(jstate.lent.data).copy()
    assert not np.asarray(jstate.lent.count).any()
    n_c, cap, _ = data.shape
    rng = np.random.default_rng(seed)
    count = np.minimum(rng.integers(1, max_rows + 1, n_c), cap)
    for c in range(n_c):
        for i in range(count[c]):
            data[c, i] = (10_000 + 100 * c + i, rng.integers(1, 9),
                          rng.integers(100, 6_000), 0,
                          rng.integers(1_000, 20_000), 0, (c + 1) % n_c,
                          0, 0, 0)
    lent = jstate.lent.replace(data=jax.numpy.asarray(data),
                               count=jax.numpy.asarray(count, np.int32))
    return jstate.replace(lent=lent)


def n_traced(state, src) -> int:
    """Placements from source ``src`` in a port state's trace."""
    tr = state.trace
    live = torch.arange(tr.src.shape[1])[None, :] < tr.n[:, None]
    return int(((tr.src == src) & live).sum())


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX reference runs, unfused and fused, over the same stream."""
    cfg = headline_cfg()
    arr, _ = stream()
    jspecs, _ = specs()
    n = sum(CHUNKS)
    ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
    out = {}
    for name, c in (("unfused", cfg),
                    ("fused", dataclasses.replace(cfg, fused="on",
                                                  fused_block=8))):
        out[name] = jengine.Engine(c).run_jit()(jinit_state(c, jspecs), ta, n)
    return out


@pytest.fixture(scope="module")
def port_run():
    cfg = port_cfg(headline_cfg())
    _, arr = stream()
    _, tspecs = specs()
    parts = tengine.pack_arrivals_chunks(arr, CHUNKS, cfg.tick_ms)
    assert parts[0].rows.shape[2] != parts[1].rows.shape[2]
    tfused.reset_launches()
    state = tengine.Engine(cfg, device="cpu").run_chunks(
        tstate.init_state(cfg, tspecs, device="cpu"), parts)
    return state


@pytest.mark.parametrize("ref", ["unfused", "fused"])
def test_port_run_chunks_bitwise_equals_jax(jax_runs, port_run, ref):
    want = jax_runs[ref]
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(port_run))
    assert ttrace.extract_trace(port_run) == jextract(want)


def test_port_headline_shape_is_sound(port_run):
    """Zero drops, real work and conservation on the port's own output;
    on the CPU the plain path ran and the kernel launched no time."""
    assert all(v == 0 for v in ttrace.total_drops(port_run).values())
    placed = int(port_run.placed_total.sum())
    assert placed >= 0.9 * C * JOBS
    assert int(port_run.trace.n.sum()) == placed
    ttrace.check_conservation(port_run)
    assert not any(tfused.launch_counts().values())


def test_port_run_equals_run_chunks():
    """``run`` over one global-K bucket equals ``run_chunks`` over ragged
    chunks (K is invisible to the simulation)."""
    cfg = port_cfg(headline_cfg(record_trace=False))
    _, arr = stream(n_clusters=4, horizon_ms=30_000, seed=5)
    _, tspecs = specs(4)
    eng = tengine.Engine(cfg, device="cpu")
    a = eng.run(tstate.init_state(cfg, tspecs, device="cpu"),
                tengine.pack_arrivals_by_tick(arr, 35, cfg.tick_ms), 35)
    b = eng.run_chunks(tstate.init_state(cfg, tspecs, device="cpu"),
                       tengine.pack_arrivals_chunks(arr, [20, 15],
                                                    cfg.tick_ms))
    assert_leaves_equal(interop.state_to_numpy(a), interop.state_to_numpy(b))
    assert int(a.t) == 35 * cfg.tick_ms


@pytest.mark.parametrize("change,policies,item", [
    (dict(policy=tconfig.PolicyKind.DELAY), None, "A5"),
    (dict(), ("fifo", "ffd"), "A5"),
    (dict(), ("gavel",), "A5"),
    (dict(borrowing=True), None, "A6"),
    (dict(trader=tconfig.TraderConfig(enabled=True), n_res=3), None, "A7"),
    (dict(faults=tconfig.FaultConfig(enabled=True)), None, "A8"),
    (dict(record_metrics=True), None, "A10"),
])
def test_configs_outside_the_slice_raise(change, policies, item):
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet

    cfg = dataclasses.replace(port_cfg(headline_cfg()), **change)
    pset = None if policies is None else PolicySet(policies)
    with pytest.raises(NotImplementedError, match=item):
        tengine.Engine(cfg, device="cpu", policies=pset)


def test_unported_run_paths_raise():
    cfg = port_cfg(headline_cfg())
    eng = tengine.Engine(cfg, device="cpu")
    _, arr = stream(n_clusters=2)
    _, tspecs = specs(2)
    state = tstate.init_state(cfg, tspecs, device="cpu")
    with pytest.raises(NotImplementedError, match="A3"):
        eng.run(state, arr, 5)
    with pytest.raises(NotImplementedError, match="A9"):
        eng.run_compressed(state, None, 5)
    with pytest.raises(NotImplementedError, match="A11"):
        tstate.init_state(cfg, tspecs, plan=object(), device="cpu")
