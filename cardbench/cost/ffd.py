"""The least bytes and operations an FFD tick needs: a frozen copy of
``tick_cost_ffd`` from ``chip_smoke.py``, adapted as ``cost/common.py``
says."""

from __future__ import annotations

import torch

from cardbench.cost import common


def tick_cost(before, after, rows, counts, t: int, trace: bool, qc: int):
    """The least bytes and operations an FFD tick ``t`` needs on this
    tick's data, as (read, written, ops) 0-d int64 tensors on the state's
    device.

    Written: every state element the tick changed. Read, per cluster: the
    arrival count and the eight counters the tick updates (the trace count
    too), the node vectors, the running set's active flags, the end_t of
    each active slot and the node and resources of each released slot, the
    two sort keys of every live Level0 row (after the ingest), the rest of
    the row of each of the first min(|L0|, qc) jobs the sweep processes,
    each Level0 element the tick rewrote (read from its source slot; this
    counts the processed rows' rec_wait twice, at most 4 B a job), and the
    valid arrival rows. Operations: per cluster, |L0| + n log2(|L0|)
    compares to select the sweep's n jobs in order, and N*(R+1) compares
    of first fit per processed job."""
    s = before
    n_res = s.node_free.shape[-1]
    N = s.node_free.shape[-2]
    Qc = s.l0.capacity
    row_b = rows.shape[-1] * rows.element_size()
    q_row = common.row_bytes(s.l0)
    keys = common.value_bytes(s.l0, "cores") + common.value_bytes(s.l0, "mem")
    written, l0_written = common.written_bytes(before, after)
    n_take = counts.clamp(0, rows.shape[-2])
    live = (s.l0.count + n_take).clamp(0, Qc)  # Level0 after ingest
    n_sweep = live.clamp(max=qc)
    read = (common.fixed_reads(s, 8 + int(trace)) + common.run_reads(s, t)
            + keys * live.sum() + (q_row - keys) * n_sweep.sum()
            + l0_written + row_b * n_take.sum())
    log2 = torch.log2(live.clamp(min=1).double()).ceil().long()
    ops = (live + n_sweep * log2 + n_sweep * N * (n_res + 1)).sum()
    return read, written, ops
