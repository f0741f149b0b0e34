"""The frozen byte and operation counts (``cost/fifo.py``, ``cost/ffd.py``)
against bytes counted by hand on one tick of two clusters: two nodes of
8 cores and 1,000 MB each, three running slots, queues four deep; cluster
0 receives the tick's arrivals, cluster 1 none."""

import numpy as np
import torch

from cardbench import harness
from multi_cluster_simulator_tpu_torch.config import PolicyKind, SimConfig
from multi_cluster_simulator_tpu_torch.core.engine import (
    Engine, pack_arrivals_by_tick,
)
from multi_cluster_simulator_tpu_torch.core.spec import uniform_cluster
from multi_cluster_simulator_tpu_torch.core.state import (
    Arrivals, clone_state, init_state,
)


def _tick(policy, jobs):
    """One tick at clock 1,000 of ``jobs`` [(t, cores, mem, dur)] arriving
    at cluster 0; returns (before, after, rows, counts)."""
    cfg = SimConfig(policy=policy, parity=policy == PolicyKind.FIFO,
                    n_res=2, max_nodes=2, max_virtual_nodes=0,
                    queue_capacity=4, max_running=3, max_arrivals=2,
                    max_placements_per_tick=2)
    specs = [uniform_cluster(c + 1, 2, cores=8, memory=1000)
             for c in range(2)]
    A = 2
    col = lambda i, pad: np.array(  # noqa: E731
        [[j[i] for j in jobs] + [pad] * (A - len(jobs)), [pad] * A],
        np.int32)
    arr = Arrivals(t=col(0, 0), id=np.array([[0, 1], [0, 1]], np.int32),
                   cores=col(1, 0), mem=col(2, 0),
                   gpu=np.zeros((2, A), np.int32), dur=col(3, 0),
                   n=np.array([len(jobs), 0], np.int32))
    ta = pack_arrivals_by_tick(arr, 1, 1000)
    state = init_state(cfg, specs, device="cpu")
    before = clone_state(state)
    rows, counts = torch.from_numpy(ta.rows[0]), torch.from_numpy(
        ta.counts[0])
    after = Engine(cfg, device="cpu").step_tick(state, rows, counts, clock=0)
    return before, after, rows, counts


def test_fifo_tick_bytes_by_hand():
    before, after, rows, counts = _tick(PolicyKind.FIFO,
                                        [(500, 2, 100, 5000)])
    fifo = harness.load_cost("fifo")
    read, written, ops = fifo.tick_cost(before, after, rows, counts, 1000,
                                        False, 4)
    # written: the clock 4; node 0's cores and mem 8; the running row's
    # end_t, cores, mem, id, dur and enq_t 24 (node 0, gpu 0, owner -1 and
    # retries 0 equal the invalid row's); its active flag 1; placed_total
    # and arr_ptr 8. The ReadyQueue takes the job and gives it back in the
    # tick: unchanged.
    assert int(written) == 4 + 8 + 24 + 1 + 8
    # read: per cluster the count and 7 counters (32), two nodes' free
    # (16), their active flags (2), three slots' flags (3): 2 x 53; no
    # running job, no live queue row; one valid arrival row of 40
    assert int(read) == 2 * 53 + 40
    assert int(ops) == 0


def test_ffd_tick_cost_by_hand():
    before, after, rows, counts = _tick(
        PolicyKind.FFD, [(500, 2, 100, 5000), (700, 3, 50, 4000)])
    assert float(after.wait_total[0]) == 500 + 300
    ffd = harness.load_cost("ffd")
    read, written, ops = ffd.tick_cost(before, after, rows, counts, 1000,
                                       False, 2)
    # written: the clock 4; node 0's cores and mem 8; two running rows of
    # 6 changed fields 48; two active flags 2; placed_total, arr_ptr,
    # wait_jobs and wait_total of cluster 0: 16. Level0 takes both jobs
    # and gives both back: unchanged, so no Level0 element is rewritten.
    assert int(written) == 4 + 8 + 48 + 2 + 16
    # read: per cluster the count and 8 counters (36), free (16), node
    # flags (2), slot flags (3): 2 x 57; the two sort keys of 2 live rows
    # 16; the rest of 2 swept rows 2 x 32; 2 arrival rows of 40
    assert int(read) == 2 * 57 + 16 + 64 + 80
    # ops: cluster 0: |L0| 2 + 2 x log2(2) + 2 x 2 nodes x 3; cluster 1: 0
    assert int(ops) == 2 + 2 + 12
