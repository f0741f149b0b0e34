"""obs/ — the observability subsystem (the port of
``multi_cluster_simulator_tpu/obs/``): the device metrics plane
(``obs/device.py``, with ``tap_leap`` for the event-compressed driver)
the profile plane (``obs/profile.py``) and the serving surface's
Prometheus-text parser (``obs/promtext.py``)."""

from multi_cluster_simulator_tpu_torch.obs.device import (  # noqa: F401
    OBS_DEPTH_BUCKETS, OBS_RING, PC_LEAVES, MetricsBuffer, TapCursor,
    cursor_of, harvest, metrics_init, queue_depth, reduce_metrics, tap_leap,
    tap_pc, tap_tick, tap_tick_global, tap_tick_local,
)
from multi_cluster_simulator_tpu_torch.obs.profile import (  # noqa: F401
    TICK_PHASES, annotate_dispatch, phase_scope,
)
