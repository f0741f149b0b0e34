"""The port's chaos harness (multi_cluster_simulator_tpu_torch/tools/
chaos.py), serving and batch, on the CPU.

Serving: one kill -9 cycle of a serving child under live HTTP traffic —
every acked job in the fsync'd WAL and placed once, the recovered
checkpoint bitwise the port's uninterrupted in-process reference fed the
WAL, and bitwise the JAX package's ``ServingScheduler`` fed the same WAL.
Batch: the resumable ``--batch-child`` (churn_bursts quick, compact,
compressed, trace churn) at a cut horizon, killed with SIGKILL and then
with SIGTERM (exit 75) at chunk boundaries, its final checkpoint bitwise
the uninterrupted child's. The copies of ``chaos_cfg``, ``chaos_specs``
and bench.py's ``churn_bursts_setup`` are pinned to their sources, and
the reference's 2- and 8-device cells raise naming A16. Every child gets
a timeout; the children run one thread each.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import bench
from multi_cluster_simulator_tpu.services.serving import (
    ServingScheduler as JServing,
)
from multi_cluster_simulator_tpu_torch import interop
from multi_cluster_simulator_tpu_torch.core.checkpoint import load_state
from multi_cluster_simulator_tpu_torch.core.state import init_state
from multi_cluster_simulator_tpu_torch.services import wal as walmod
from multi_cluster_simulator_tpu_torch.tools import chaos
from tests.test_torch_engine import jax_leaves, port_cfg
from tools import chaos as jchaos


@pytest.fixture(autouse=True)
def one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_copies_equal_their_sources():
    assert port_cfg(jchaos.chaos_cfg()) == chaos.chaos_cfg()
    assert [dataclasses.astuple(s) for s in jchaos.chaos_specs()] == \
        [dataclasses.astuple(s) for s in chaos.chaos_specs()]
    assert (chaos.SPEED, chaos.WINDOW, chaos.N_CLUSTERS,
            chaos.EXIT_PREEMPTED) == (jchaos.SPEED, jchaos.WINDOW,
                                      jchaos.N_CLUSTERS,
                                      jchaos.EXIT_PREEMPTED)
    for quick in (True, False):
        jc, js, ja, jn, je = bench.churn_bursts_setup(quick=quick)
        tc, ts, ta, tn, te = chaos.churn_bursts_setup(quick=quick)
        assert port_cfg(jc) == tc and (jn, je) == (tn, te)
        assert [dataclasses.astuple(s) for s in js] == \
            [dataclasses.astuple(s) for s in ts]
        for f in dataclasses.fields(ta):
            np.testing.assert_array_equal(np.asarray(getattr(ja, f.name)),
                                          getattr(ta, f.name))


def test_serving_kill_and_recover(tmp_path):
    d = str(tmp_path / "serve")
    os.makedirs(d)
    rep = chaos.run_chaos(1, 2_000, None, d, keep=True, device="cpu")
    assert rep["reference_devices"] == ["cpu"]
    assert rep["cycles"] == rep["kills_under_live_traffic"] == 1
    assert rep["acked_jobs_lost"] == 0 and rep["final_state_bit_identical"]
    assert rep["placed_total"] == rep["wal_records"] >= rep["jobs_acked"]
    # the recovered checkpoint == the JAX front door fed the same WAL
    records, *_ = walmod.read_records(os.path.join(d, "serve.wal"))
    jref = JServing("chaos-ref-jax", jchaos.chaos_specs(), jchaos.chaos_cfg(),
                    pacer=False, window=chaos.WINDOW, warm_k=(16, 64),
                    k_cap=64, max_staged=10 ** 6)
    want = jax_leaves(chaos.replay_wal(jref, records,
                                       rep["ticks_dispatched"]))
    cfg = chaos.chaos_cfg()
    got = interop.to_numpy(load_state(
        os.path.join(d, "serve.ckpt"),
        init_state(cfg, chaos.chaos_specs(), device="cpu"), cfg=cfg))
    assert chaos.diverged_leaves(want, got) == []


def test_batch_kill_and_sigterm_cycle(tmp_path):
    rep = chaos._batch_scenario(1, 1, str(tmp_path), np.random.default_rng(7),
                                device="cpu", ticks=400, ref_device="cpu")
    assert rep["reference_device"] == "cpu"
    assert rep["kills"] == 1 and rep["sigterm_preemptions"] == 1
    assert rep["final_state_bit_identical"] and rep["cursors_telescope"]
    assert rep["ticks_executed_compressed"] < rep["ticks_total"] == 400


def test_mesh_cells_name_a16(tmp_path):
    rng = np.random.default_rng(0)
    for n_dev in (2, 8):
        with pytest.raises(NotImplementedError, match="A16"):
            chaos._batch_scenario(n_dev, 1, str(tmp_path), rng,
                                  device="cpu")


def test_children_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.run_chaos(1, 10, None, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.batch_child(str(tmp_path / "x.ckpt"), False)
