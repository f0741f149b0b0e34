"""The port's scored Level0 sweeps (gavel, tesserae, rl) and the
multi-member ``PolicySet`` dispatch against the JAX package, on the CPU.

Bitwise throughout, ``wait_total`` (f32) and the f32 scores included:
``best_scored_fit`` (ties, nodes that all fail, ``-inf`` masking),
``_class_device_scores`` and ``_tesserae_scores`` under ``jax.vmap``; the
exact fused multiply-add the tesserae score is taken with; whole
``run_chunks`` runs against JAX ``run_jit``, unfused and with the Pallas
prefix in interpret mode, at the reference's scored-sweep gate shape
(tests/test_kernels.py:98: C=4, 30 ticks, 3 resources, gpu-rich and
gpu-poor clusters), with seeded non-zero ``rl_scores`` and tesserae
weights whose products pass 2^24 besides the defaults; and
tools/tournament.py's lineup as one multi-member set, at every
``params.idx``, against JAX's multi-member engine and the port's own
singleton runs. Inputs come from numpy seeds.
"""

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import PolicyKind, SimConfig
from multi_cluster_simulator_tpu.core import engine as jengine
from multi_cluster_simulator_tpu.core import spec as jspec
from multi_cluster_simulator_tpu.core.spec import uniform_cluster
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.ops import placement as jP
from multi_cluster_simulator_tpu.ops import queues as jQ
from multi_cluster_simulator_tpu.policies import base as jbase
from multi_cluster_simulator_tpu.policies import kernels as jK
from multi_cluster_simulator_tpu.utils.trace import extract_trace as jextract
from multi_cluster_simulator_tpu.workload.traces import uniform_stream
from multi_cluster_simulator_tpu_torch import config as tconfig
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.kernels import fused_tick as tfused
from multi_cluster_simulator_tpu_torch.ops import placement as tP
from multi_cluster_simulator_tpu_torch.ops import queues as tQ
from multi_cluster_simulator_tpu_torch.policies import base as tbase
from multi_cluster_simulator_tpu_torch.policies import kernels as tK
from multi_cluster_simulator_tpu_torch.utils import trace as ttrace
from multi_cluster_simulator_tpu_torch.workload import traces as ttraces
from tests.test_torch_engine import (
    assert_leaves_equal, jax_leaves, port_cfg,
)
from tests.test_torch_ops import eq, rand_rows, t_

SEEDS = [0, 1, 2]
C, N = 24, 9


# --------------------------------------------------------------------------
# the ops, under jax.vmap
# --------------------------------------------------------------------------

def rand_nodes(rng, n_res, big=False):
    """Free vectors on [C, N] nodes, some inactive; ``big`` memory makes
    the tesserae products pass 2^24."""
    free = np.zeros((C, N, n_res), np.int32)
    free[..., 0] = rng.integers(0, 33, (C, N))
    free[..., 1] = rng.integers(0, 200_000 if big else 24_001, (C, N))
    if n_res == 3:
        free[..., 2] = rng.integers(0, 9, (C, N))
    active = rng.random((C, N)) < 0.85
    active[0] = False  # a cluster where nothing fits
    return free, active


def rand_jobs(rng, big=False):
    rows = rand_rows(rng, (C,), gpu_frac=0.3)
    rows[:, tQ.FCORES] = rng.integers(0, 25, C)
    rows[:, tQ.FMEM] = rng.integers(0, 100_000 if big else 18_001, C)
    rows[:, tQ.FGPU] *= rng.integers(1, 3, C)
    rows[1, tQ.FCORES] = 1_000  # a job no node fits
    return rows


def jrec(rows):
    return jQ.JobRec(vec=jnp.asarray(rows))


@pytest.mark.parametrize("n_res", [2, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_best_scored_fit_equals_jax(seed, n_res):
    rng = np.random.default_rng(60 + seed)
    free, active = rand_nodes(rng, n_res)
    rows = rand_jobs(rng)
    scores = rng.choice(np.float32([0.0, 1.0, 2.5, -3.0]), (C, N))
    scores[2] = 1.0  # all tie: first fit
    scores[3, :4] = -np.inf  # -inf on nodes that may be feasible
    want = jax.vmap(lambda f, a, j, s: jP.best_scored_fit(
        f, a, jQ.JobRec(vec=j), s))(jnp.asarray(free), jnp.asarray(active),
                                   jnp.asarray(rows), jnp.asarray(scores))
    got = tP.best_scored_fit(t_(free), t_(active), tQ.JobRec(vec=t_(rows)),
                             t_(scores))
    eq(want, got)
    got = got.numpy()
    assert got[0] == got[1] == tP.NO_NODE
    assert (got >= 0).sum() > 4
    ff = tP.first_fit(t_(free), t_(active), tQ.JobRec(vec=t_(rows)))
    assert got[2] == int(ff[2])  # constant scores are first fit


@pytest.mark.parametrize("seed", SEEDS)
def test_class_device_scores_equal_jax(seed):
    rng = np.random.default_rng(70 + seed)
    node_type = rng.integers(-1, 6, (C, N)).astype(np.int32)  # clipped
    jclass = rng.integers(-2, 6, C).astype(np.int32)
    matrix = rng.normal(size=(4, 4)).astype(np.float32)
    want = jax.vmap(lambda nt, jc: jK._class_device_scores(
        nt, jc, jnp.asarray(matrix)))(jnp.asarray(node_type),
                                      jnp.asarray(jclass))
    got = tK._class_device_scores(t_(node_type), t_(jclass), t_(matrix))
    eq(want, got)


TESS_W = {"default": (1.0, 1e-3, 1.0), "ones": (1.0, 1.0, 1.0),
          "odd": (0.37, 1.3e-3, 2.9)}


@pytest.mark.parametrize("w", sorted(TESS_W))
@pytest.mark.parametrize("n_res", [2, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_tesserae_scores_equal_jax(seed, n_res, w):
    rng = np.random.default_rng(80 + seed)
    free, _ = rand_nodes(rng, n_res, big=True)
    rows = rand_jobs(rng, big=True)
    cfg = scored_cfg()
    jp = jbase.default_params(cfg, jbase.REGISTRY["tesserae"]).replace(
        tess_w=jnp.asarray(TESS_W[w], jnp.float32))
    tp = port_params(cfg, "tesserae").replace(
        tess_w=torch.tensor(TESS_W[w], dtype=torch.float32))
    want = jax.jit(jax.vmap(lambda f, j: jK._tesserae_scores(
        f, jQ.JobRec(vec=j), jp)))(jnp.asarray(free), jnp.asarray(rows))
    got = tK._tesserae_scores(t_(free), tQ.JobRec(vec=t_(rows)), tp)
    eq(want, got)
    prods = free.astype(np.float64) * rows[:, None, 1:1 + n_res] \
        * np.asarray(TESS_W[w][:n_res])
    if w == "ones":
        assert prods.max() > 2**24


def round_f32(x: Fraction) -> np.float32:
    """The f32 nearest the exact ``x``, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(v.view(np.int32)) & 1))


@pytest.mark.parametrize("seed", SEEDS)
def test_fma_f32_is_the_correctly_rounded_fused_multiply_add(seed):
    rng = np.random.default_rng(90 + seed)
    a = (rng.integers(0, 2**26, 4_000) * rng.choice([1, -1], 4_000)).astype(
        np.float32)
    b = (rng.random(4_000) * 10.0 ** rng.integers(-4, 4, 4_000)).astype(
        np.float32)
    c = (rng.normal(size=4_000) * 10.0 ** rng.integers(0, 9, 4_000)).astype(
        np.float32)
    got = tK.fma_f32(t_(a), t_(b), t_(c)).numpy()
    want = np.asarray([round_f32(Fraction(float(x)) * Fraction(float(y))
                                 + Fraction(float(z)))
                       for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # a product and a sum rounded apart differ somewhere: the test bites
    assert not np.array_equal((a * b + c).view(np.int32), want.view(np.int32))


# --------------------------------------------------------------------------
# whole runs at the reference's scored-sweep gate shape
# --------------------------------------------------------------------------

SC, STICKS, SHORIZON = 4, 30, 24_000
SCHUNKS = [24, 6]  # 30 ticks; the second drains (K = 1)


def scored_cfg(**kw):
    """tests/test_kernels.py:98's config (the JAX class), trace on."""
    base = dict(policy=PolicyKind.DELAY, parity=False, queue_capacity=32,
                max_running=64, max_arrivals=64, max_placements_per_tick=8,
                n_res=3, max_nodes=5, max_virtual_nodes=0, record_trace=True,
                max_trace_events=512)
    base.update(kw)
    return SimConfig(**base)


def port_params(cfg, name):
    return tbase.default_params(port_cfg(cfg), tbase.REGISTRY[name])


def gate_specs(n_clusters=SC, mixed=False):
    """The gate's gpu-rich and gpu-poor clusters; ``mixed`` gives every
    cluster nodes of all four device types instead, so that the class
    tables of gavel and rl choose between nodes (on uniform clusters
    every node scores the same and the pick is first fit)."""
    if not mixed:
        gpus = [8 if c % 2 == 0 else 0 for c in range(n_clusters)]
        return ([uniform_cluster(c + 1, 5, gpus=g)
                 for c, g in enumerate(gpus)],
                [tspec.uniform_cluster(c + 1, 5, gpus=g)
                 for c, g in enumerate(gpus)])
    nodes = ((32, 24_000, 0, 0), (16, 12_000, 0, 2), (64, 48_000, 4, 3),
             (32, 24_000, 8, 1), (32, 24_000, 0, 0))

    def mk(mod):
        return [mod.ClusterSpec(id=c + 1, nodes=tuple(
            mod.NodeSpec(id=i + 1, cores=k, memory=m, gpus=g, device_type=d)
            for i, (k, m, g, d) in enumerate(nodes)))
            for c in range(n_clusters)]
    return mk(jspec), mk(tspec)


def gate_stream(n_clusters=SC, jobs=24, seed=3, **kw):
    args = dict(max_cores=8, max_mem=6_000, max_dur_ms=20_000, seed=seed,
                max_gpus=2, gpu_frac=0.2)
    args.update(kw)
    return (uniform_stream(n_clusters, jobs, SHORIZON, **args),
            ttraces.uniform_stream(n_clusters, jobs, SHORIZON, **args))


RL_SCORES = np.random.default_rng(17).normal(size=(4, 4)).astype(np.float32)
# name: (policy, config changes, stream changes, leaf overrides)
RUNS = {
    "gavel": ("gavel", {}, {}, {}),
    "tesserae": ("tesserae", {}, {}, {}),
    "rl": ("rl", {}, {}, {}),
    "rl_seeded": ("rl", {}, {}, {"rl_scores": RL_SCORES}),
    # every cluster with nodes of all four device types
    "gavel_mixed": ("gavel", {}, {}, {}),
    "rl_mixed": ("rl", {}, {}, {}),
    "rl_seeded_mixed": ("rl", {}, {}, {"rl_scores": RL_SCORES}),
    # weights of 1 make the mem products pass 2^24 (24,000 x 6,000)
    "tesserae_big": ("tesserae", {}, {}, {
        "tess_w": np.float32([1.0, 1.0, 1.0])}),
    # tight bounds: drops.queue, run_full and the per-tick cap fire
    "gavel_tight": ("gavel", dict(queue_capacity=6, max_running=5,
                                  max_placements_per_tick=3),
                    dict(jobs=60, max_cores=24, max_mem=18_000, seed=5), {}),
    "tesserae_tight": ("tesserae", dict(queue_capacity=6, max_running=5,
                                        max_placements_per_tick=3),
                       dict(jobs=60, max_cores=24, max_mem=18_000, seed=5),
                       {}),
}
FUSED_RUNS = ("gavel_mixed", "tesserae", "rl_seeded_mixed")


def run_params(cfg, case, jax_side):
    policy, _, _, leaves = RUNS[case]
    if jax_side:
        p = jbase.PolicySet((policy,)).params_for(cfg)
        return p.replace(**{k: jnp.asarray(v) for k, v in leaves.items()})
    p = port_params(cfg, policy)
    return p.replace(**{k: torch.from_numpy(np.array(v))
                        for k, v in leaves.items()})


@pytest.fixture(scope="module")
def jax_scored_runs():
    n = sum(SCHUNKS)
    out = {}
    for case, (policy, ckw, skw, _) in RUNS.items():
        jspecs, _ = gate_specs(mixed=case.endswith("mixed"))
        cfg = scored_cfg(**ckw)
        arr, _ = gate_stream(**skw)
        ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
        pset = jbase.PolicySet((policy,))
        refs = [("unfused", cfg)]
        if case in FUSED_RUNS:
            refs.append(("fused", dataclasses.replace(cfg, fused="on",
                                                      fused_block=2)))
        for ref, c in refs:
            out[case, ref] = jengine.Engine(c, policies=pset).run_jit()(
                jinit_state(c, jspecs), ta, n,
                params=run_params(c, case, True))
    return out


@pytest.fixture(scope="module")
def port_scored_runs():
    out = {}
    for case, (policy, ckw, skw, _) in RUNS.items():
        _, tspecs = gate_specs(mixed=case.endswith("mixed"))
        cfg = scored_cfg(**ckw)
        _, arr = gate_stream(**skw)
        tcfg = port_cfg(cfg)
        parts = tengine.pack_arrivals_chunks(arr, SCHUNKS, tcfg.tick_ms)
        assert parts[0].rows.shape[2] != parts[1].rows.shape[2]
        eng = tengine.Engine(tcfg, device="cpu",
                             policies=tbase.PolicySet((policy,)))
        out[case] = eng.run_chunks(
            tstate.init_state(tcfg, tspecs, device="cpu"), parts,
            params=run_params(cfg, case, False))
    return out


@pytest.mark.parametrize("case,ref", [(c, "unfused") for c in sorted(RUNS)]
                         + [(c, "fused") for c in FUSED_RUNS])
def test_port_scored_run_chunks_bitwise_equals_jax(jax_scored_runs,
                                                   port_scored_runs, case,
                                                   ref):
    want, got = jax_scored_runs[case, ref], port_scored_runs[case]
    assert_leaves_equal(jax_leaves(want), interop.state_to_numpy(got))
    assert ttrace.extract_trace(got) == jextract(want)


def test_port_scored_runs_are_sound(port_scored_runs):
    """Real work, conservation, the bounds firing on the tight runs, and
    the scores steering the placements."""
    runs = port_scored_runs
    for case, s in runs.items():
        assert int(s.placed_total.sum()) > 0, case
        assert int(s.trace.n.sum()) == int(s.placed_total.sum())
        ttrace.check_conservation(s)
    for case in ("gavel_tight", "tesserae_tight"):
        drops = ttrace.total_drops(runs[case])
        assert drops["queue"] > 0 and drops["run_full"] > 0, (case, drops)
    # rl's zero default is first fit in queue order; on mixed nodes the
    # seeded scores and gavel's table move jobs onto other nodes
    for case in ("rl_seeded_mixed", "gavel_mixed"):
        assert not torch.equal(runs["rl_mixed"].trace.node,
                               runs[case].trace.node), case


# --------------------------------------------------------------------------
# multi-member dispatch: tools/tournament.py's lineup as one PolicySet
# --------------------------------------------------------------------------

LINEUP = ("fifo", "delay", "delay-eager", "delay-patient", "ffd",
          "ffd-memfirst", "gavel", "tesserae")
LINEUP_KERNEL = {"fifo": "fused_prefix_fifo", "delay": "fused_prefix_delay",
                 "ffd": "fused_prefix_ffd", "gavel": "fused_prefix_scored",
                 "tesserae": "fused_prefix_scored"}


def lineup_cfg():
    return scored_cfg(max_placements_per_tick=4, queue_capacity=16,
                      max_running=24)


def test_lineup_is_the_tournaments():
    from tools.tournament import DEFAULT_POLICIES

    assert DEFAULT_POLICIES == LINEUP


@pytest.fixture(scope="module")
def jax_lineup_runs():
    cfg = lineup_cfg()
    jspecs, _ = gate_specs()
    arr, _ = gate_stream(jobs=40, max_cores=24, max_mem=18_000, seed=9)
    n = sum(SCHUNKS)
    ta = jengine.pack_arrivals_by_tick(arr, n, cfg.tick_ms)
    pset = jbase.PolicySet(LINEUP)
    run = jengine.Engine(cfg, policies=pset).run_jit()
    return {name: run(jinit_state(cfg, jspecs), ta, n,
                      params=pset.params_for(cfg, name)) for name in LINEUP}


@pytest.mark.parametrize("idx", range(len(LINEUP)))
def test_lineup_dispatch_equals_jax_and_the_singleton(jax_lineup_runs, idx):
    name = LINEUP[idx]
    tcfg = port_cfg(lineup_cfg())
    _, tspecs = gate_specs()
    _, arr = gate_stream(jobs=40, max_cores=24, max_mem=18_000, seed=9)
    parts = tengine.pack_arrivals_chunks(arr, SCHUNKS, tcfg.tick_ms)
    pset = tbase.PolicySet(LINEUP)
    eng = tengine.Engine(tcfg, device="cpu", policies=pset)
    params = pset.params_for(tcfg, name)
    assert int(params.idx) == idx
    prov = tfused.provenance(eng, params)
    assert prov["policy"] == name
    assert prov["kernel"] == LINEUP_KERNEL[tbase.REGISTRY[name].kind]
    got = eng.run_chunks(tstate.init_state(tcfg, tspecs, device="cpu"),
                         parts, params=params)
    assert_leaves_equal(jax_leaves(jax_lineup_runs[name]),
                        interop.state_to_numpy(got))
    alone = tengine.Engine(tcfg, device="cpu",
                           policies=tbase.PolicySet((name,)))
    single = alone.run_chunks(tstate.init_state(tcfg, tspecs, device="cpu"),
                              parts)
    assert_leaves_equal(interop.state_to_numpy(single),
                        interop.state_to_numpy(got))
    assert int(got.placed_total.sum()) > 0


def test_dispatch_reads_the_index_and_refuses_a_batched_one():
    tcfg = port_cfg(lineup_cfg())
    pset = tbase.PolicySet(LINEUP)
    eng = tengine.Engine(tcfg, device="cpu", policies=pset)
    assert eng.member().name == "fifo"  # the default params: member 0
    for i, name in enumerate(LINEUP):
        assert pset.member(torch.tensor(i, dtype=torch.int32)).name == name
    assert pset.to_delay_table().tolist() == [False] + [True] * 7
    assert pset.kind_flag_table("delay").tolist() == [
        False, True, True, True, False, False, False, False]
    params = pset.params_for(tcfg).replace(
        idx=torch.tensor([3, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="selects a member per lane"):
        pset.member(params.idx)
    assert [m.name for m in pset.members(params.idx)] == [LINEUP[3], "fifo"]
    with pytest.raises(IndexError):
        pset.member(len(LINEUP))


def test_the_whole_zoo_constructs_on_the_cpu():
    """Every kind, and a set mixing them, builds an engine: nothing of the
    schedule slot is refused any more."""
    tcfg = port_cfg(lineup_cfg())
    for kind in tbase.KINDS:
        tengine.Engine(tcfg, device="cpu", policies=tbase.PolicySet((kind,)))
    for kind in (tconfig.PolicyKind.DELAY, tconfig.PolicyKind.FFD):
        eng = tengine.Engine(dataclasses.replace(tcfg, policy=kind),
                             device="cpu")
        assert eng.member().kind == kind.value.lower()
