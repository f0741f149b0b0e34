"""Canonical packed-row field schemas (the port's copy of the schema half of
``multi_cluster_simulator_tpu/ops/fields.py``).

One table per row kind — the queue row (ops/queues.py) and the running-set
row (ops/runset.py) — defining field NAMES, ORDER and INVALID sentinels in
one place. The narrow-storage primitives (``widen``, ``narrow_store``) wait
for the compact-layout slice (ROADMAP A11). tests/test_torch_copies.py pins
these tables equal to the JAX package's.
"""

from __future__ import annotations

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
