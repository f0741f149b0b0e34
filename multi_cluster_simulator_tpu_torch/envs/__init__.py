"""envs/ — the simulator as a batched gym on the device (the port of
``multi_cluster_simulator_tpu/envs``): env instances as the lanes of one
lane-stacked run, per-env PRNG streams, auto-reset without a host round
trip, the rl policy kind as the action port, and reward weights as data."""

from multi_cluster_simulator_tpu_torch.envs.cluster_env import (
    REWARD_VARIANTS, ClusterEnv, EnvInfo, EnvState, StreamGen,
    shard_env_batch,
)
from multi_cluster_simulator_tpu_torch.envs.obs import n_obs_features, observe

__all__ = [
    "REWARD_VARIANTS", "ClusterEnv", "EnvInfo", "EnvState", "StreamGen",
    "shard_env_batch", "n_obs_features", "observe",
]
