"""Multi-tenant constellation hosting: the tenant axis (the port of
``multi_cluster_simulator_tpu/tenancy``).

``TenantParams`` (params.py) holds everything that varies per tenant as
tensor leaves; ``TenantBatch`` (host.py) runs the engine's drivers over a
lane-stacked batch — T independent constellations as the lanes of one
run, each kernel launched once a tick over all of them, per-tenant fault
streams and parameters.
"""

from multi_cluster_simulator_tpu_torch.tenancy.host import (  # noqa: F401
    TenantBatch, aggregate_drops, aggregate_placed, init_tenant_state,
    n_tenants, pad_tick_arrivals, shard_tenant_batch, stack_lanes,
    stack_tenant_states, stack_tick_arrivals, tenant_cell,
)
from multi_cluster_simulator_tpu_torch.tenancy.params import (  # noqa: F401
    TenantParams, default_tenant_params, stack_tenant_params,
    tenant_params_digest,
)
