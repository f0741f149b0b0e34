"""Byte counting shared by the kernels' cost functions: a frozen copy of
``row_bytes``, ``value_bytes``, ``rows_changed_bytes``, ``written_bytes``,
``fixed_reads`` and ``run_reads`` from ``chip_smoke.py``, adapted to import
nothing of the program (it walks the program's state dataclasses by their
fields) and to take a lane-stacked state (every leaf with a leading [L])
as its lanes' clusters end to end."""

from __future__ import annotations

import dataclasses
import math


def leaves(obj):
    """Every tensor of a state dataclass, in field order, depth first."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name))
    else:
        yield obj


def row_bytes(x) -> int:
    """Bytes of one row of a queue or the running set in its layout: the
    wide row's 40, or the sum of the compact leaves' value sizes."""
    if hasattr(x, "data"):
        return x.data.shape[-1] * x.data.element_size()
    return sum(leaf.element_size() for k, leaf in vars(x).items()
               if k.startswith("f_"))


def value_bytes(x, name: str) -> int:
    """Bytes of one value of field ``name`` of a queue or the running set."""
    if hasattr(x, "data"):
        return x.data.element_size()
    return x.leaf(name).element_size()


def rows_changed_bytes(a, b):
    """Bytes of the row elements of a table (queue or running set) that
    differ between ``a`` and ``b`` (0-d int64 tensor), in its layout."""
    return sum((x != y).sum() * x.element_size()
               for x, y in zip(leaves(a), leaves(b)) if x.dim() >= 2)


def written_bytes(before, after):
    """Bytes of every state element the tick changed (0-d int64 tensor),
    and the same for the rows of Level0 and Level1 together."""
    written = sum((x != y).sum() * x.element_size()
                  for x, y in zip(leaves(before), leaves(after)))
    queues = (rows_changed_bytes(before.l0, after.l0)
              + rows_changed_bytes(before.l1, after.l1))
    return written, queues


def fixed_reads(s, n_counters: int):
    """Per-tick reads every cluster needs whatever its data: the arrival
    count and the counters the tick updates, the node free and active
    vectors, the running set's active flags."""
    *lead, N, n_res = s.node_free.shape
    C = math.prod(lead)
    S = s.run.active.shape[-1]
    return C * (4 * (1 + n_counters) + N * n_res * s.node_free.element_size()
                + N + S)


def run_reads(s, t: int):
    """Running-set reads: the end_t of each active slot, and the node and
    resources of each slot the tick releases."""
    n_res = s.node_free.shape[-1]
    due = s.run.active & (s.run.end_t <= t)
    per_due = value_bytes(s.run, "node") + sum(
        value_bytes(s.run, f) for f in ("cores", "mem", "gpu")[:n_res])
    return value_bytes(s.run, "end_t") * s.run.active.sum() \
        + per_due * due.sum()
