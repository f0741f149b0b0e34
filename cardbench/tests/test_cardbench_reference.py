"""The plain reference against the port's CPU path (the plain PyTorch
version the kernels are held against) on small worlds of both
configurations, one constellation and the lane form."""

import numpy as np
import pytest
import torch

from cardbench import harness
from cardbench.reference import sched
from cardbench.tests._tiny import tiny_config, tiny_traffic

torch.set_num_threads(1)


def _final(config, traffic, seed):
    world = harness.build_world(config, traffic, seed, "cpu")
    state, _ = harness.episode(world, "cpu")
    return world, state


@pytest.mark.parametrize("config_name,traffic_name,seed", [
    ("fifo4k", "single", 3), ("fifo4k", "single", 2**31 + 7),
    ("fifo4k", "lanes4", 11), ("ffd64", "single", 5),
    ("ffd64", "single", -4), ("ffd64", "lanes4", 2**33 + 1)])
def test_reference_equals_port(config_name, traffic_name, seed):
    config = tiny_config(config_name)
    world, state = _final(config, tiny_traffic(traffic_name), seed)
    stacked = world.lanes > 1
    picks = [(lane, c) for lane in range(world.lanes)
             for c in range(world.clusters)]
    ref = harness.reference_leaves(config, world.streams, picks)
    leaves = harness.program_leaves(state, config)
    for lane, c in picks:
        prog = harness.cluster_leaves(leaves, lane if stacked else None, c)
        got = harness.compare(prog, ref[(lane, c)])
        assert got == {"int_mismatch": 0, "wait_rel_gap": 0.0}, (lane, c)


@pytest.mark.parametrize("config_name", ["fifo4k", "ffd64"])
def test_worlds_reach_every_branch(config_name):
    """The small worlds place, fail at the head, fill the running set and
    drop from full queues: the comparison above covers those branches."""
    config = tiny_config(config_name)
    world = harness.build_world(config, tiny_traffic("single"), 9, "cpu")
    ref = harness.reference_leaves(config, world.streams,
                                   [(0, c) for c in range(world.clusters)])
    tot = {k: sum(int(r[k]) for r in ref.values())
           for k in ("placed_total", "drops.queue", "drops.run_full")}
    assert all(v > 0 for v in tot.values()), tot
    if config_name == "ffd64":
        assert max(float(r["wait_total"]) for r in ref.values()) > 0


def test_bucket_matches_program_packing():
    from multi_cluster_simulator_tpu_torch.core.engine import (
        pack_arrivals_by_tick,
    )
    from multi_cluster_simulator_tpu_torch.core.state import Arrivals

    from cardbench.gen.traces import uniform_stream

    s = uniform_stream(3, 50, 20_500, 8, 6000, 9000, seed=4)
    ta = pack_arrivals_by_tick(Arrivals(**s._asdict()), 18, 1000)
    for c in range(3):
        per_tick = sched.bucket(s.t[c], int(s.n[c]), 18, 1000)
        assert [len(x) for x in per_tick] == ta.counts[:, c].tolist()
        for k, idx in enumerate(per_tick):
            assert ta.rows[k, c, :len(idx), 0].tolist() == \
                s.id[c, idx].tolist()


def test_control_departs_from_reference():
    """The control (the reference below the stated precision) reads over
    each configuration's limits at the small size."""
    for name in ("fifo4k", "ffd64"):
        config = tiny_config(name)
        world = harness.build_world(config, tiny_traffic("single"), 21,
                                    "cpu")
        picks = [(0, c) for c in range(world.clusters)]
        ref = harness.reference_leaves(config, world.streams, picks)
        ctl = harness.reference_leaves(config, world.streams, picks,
                                       **config["check"]["control"])
        got = harness.worst([harness.compare(ctl[k], ref[k])
                             for k in picks])
        limits = config["check"]["limits"]
        assert any(got[k] > limits[k] for k in limits), (name, got)


def test_bf16_rounding():
    assert sched._bf16(1.0) == np.float32(1.0)
    assert sched._bf16(1.0 + 2**-9) == np.float32(1.0)  # ties to even
    assert sched._bf16(1.0 + 3 * 2**-9) == np.float32(1.0 + 2**-7)
    assert sched._bf16(257.0) == np.float32(256.0)
