"""The least bytes a FIFO tick moves: a frozen copy of ``tick_bytes`` from
``chip_smoke.py``, adapted as ``cost/common.py`` says. The FIFO pass is
bound by bytes: it counts no operations."""

from __future__ import annotations

from cardbench.cost import common


def tick_cost(before, after, rows, counts, t: int, trace: bool, qc: int):
    """The least bytes a FIFO tick ``t`` must move on this tick's data, as
    (read, written, ops) 0-d int64 tensors on the state's device (no host
    sync; ops is 0).

    Written: every state element the tick changed. Read, per cluster: the
    arrival count and the seven counters the tick updates (the trace count
    too when the trace is on), the node free and active vectors, the
    running set's active flags, the end_t of each active slot and the node
    and resources of each slot it releases, every live queue row, and the
    valid arrival rows. Rows that did not change, and queue slots past a
    queue's count, need not move at all. Every state element counts at its
    storage size (the compact layout's narrow leaves)."""
    s = before
    row_b = rows.shape[-1] * rows.element_size()
    written, _ = common.written_bytes(before, after)
    live = sum(q.count.clamp(0, q.capacity).sum()
               for q in (s.ready, s.wait, s.lent))
    valid = counts.clamp(0, rows.shape[-2]).sum()
    read = (common.fixed_reads(s, 7 + int(trace)) + common.run_reads(s, t)
            + common.row_bytes(s.ready) * live + row_b * valid)
    return read, written, written * 0
