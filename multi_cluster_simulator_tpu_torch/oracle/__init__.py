from multi_cluster_simulator_tpu_torch.oracle.go_semantics import Oracle

__all__ = ["Oracle"]
