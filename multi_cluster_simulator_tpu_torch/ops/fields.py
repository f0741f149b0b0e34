"""Canonical packed-row field schemas and the narrow-storage store
primitives (the port's copy of ``multi_cluster_simulator_tpu/ops/fields.py``).

One table per row kind — the queue row (ops/queues.py) and the running-set
row (ops/runset.py) — defining field NAMES, ORDER and INVALID sentinels in
one place; the wide layouts (``data[C, Q, NF]``), the compact SoA layouts
(one leaf per field) and the storage planner (core/compact.py) derive
their indices from them. tests/test_torch_copies.py pins these tables
equal to the JAX package's.

``narrow_store`` is the only way an int32 compute value enters a narrower
storage leaf: an out-of-range value is clamped to the dtype minimum and
counted (never a two's-complement wrap), and the caller adds the count to
the layout's ``ovf`` counter. ``pin`` (an XLA fusion hint of the
reference) has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

QUEUE_FIELDS = ("id", "cores", "mem", "gpu", "dur", "enq_t", "owner",
                "rec_wait", "jclass", "retries")
QUEUE_INDEX = {name: i for i, name in enumerate(QUEUE_FIELDS)}
# invalid-slot sentinel per field: id=-1, owner=OWN(-1), zeros elsewhere
QUEUE_INVALID = (-1, 0, 0, 0, 0, 0, -1, 0, 0, 0)

# heterogeneity schema: job demand-shape classes x node device types
N_JOB_CLASSES = 4
N_DEVICE_TYPES = 4


def job_class(cores, gpu):
    """Canonical demand-shape class in [0, N_JOB_CLASSES): bit 1 = needs
    gpu, bit 0 = core-heavy. Elementwise integer arithmetic on numpy arrays
    or tensors; callers cast to their storage dtype."""
    return (gpu > 0) * 2 + (cores > 8) * 1


NEVER_I = 2**31 - 1  # end_t sentinel for "no completion scheduled"

# (cores, mem, gpu) contiguous, ordered like spec.RES (release's slice)
RUN_FIELDS = ("end_t", "node", "cores", "mem", "gpu", "id", "owner", "dur",
              "enq_t", "retries")
RUN_INDEX = {name: i for i, name in enumerate(RUN_FIELDS)}
RUN_INVALID = (NEVER_I, 0, 0, 0, 0, -1, -1, 0, 0, 0)

# Fields eligible for sub-int32 storage in the compact layouts; timestamps,
# durations and waits stay int32 by design (end_t holds the NEVER
# sentinel). ids narrow only where a stream audit bounds them.
NARROWABLE = frozenset({"id", "cores", "mem", "gpu", "owner", "node",
                        "jclass", "retries"})

WIDE_DTYPE = np.dtype(np.int32)

_TORCH_INT = {"int8": torch.int8, "int16": torch.int16, "int32": torch.int32}


def torch_dtype(dtype) -> torch.dtype:
    """The torch integer dtype of a storage dtype given as a torch dtype, a
    numpy dtype or its name (a ``CompactPlan`` holds names)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_INT[np.dtype(dtype).name]


def widen(leaf: torch.Tensor) -> torch.Tensor:
    """Load a storage leaf for compute: all arithmetic is int32, so results
    are bit-identical to the wide layout's."""
    return leaf.to(torch.int32)


def narrow_store(values: torch.Tensor, dtype, do=None, checked: bool = True,
                 dim=None):
    """Checked narrow of int32 compute values into storage dtype ``dtype``.

    Returns ``(stored, n_overflow)``: values outside the dtype's range are
    clamped to its minimum and counted — only where ``do`` holds (the
    store-happens mask, broadcast against ``values``; None counts every
    lane); ``do`` masks the count, not the clamp. ``n_overflow`` is int32,
    summed over ``dim`` (None: every axis, a 0-d count). ``checked=False``
    is a plain cast with a zero count, legal only where the values are
    provably in range (permutations of stored values); an int32 ``dtype``
    is a free passthrough."""
    dt = torch_dtype(dtype)
    if not checked or dt.itemsize >= WIDE_DTYPE.itemsize:
        zero = torch.zeros_like(values, dtype=torch.int32)
        return values.to(dt), zero.sum(dim=dim, dtype=torch.int32)
    info = torch.iinfo(dt)
    fits = (values >= info.min) & (values <= info.max)
    bad = ~fits if do is None else ~fits & do
    stored = torch.where(fits, values, info.min).to(dt)
    return stored, bad.sum(dim=dim, dtype=torch.int32)
