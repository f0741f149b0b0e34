"""The cross-cluster communication boundary (the port of
``multi_cluster_simulator_tpu/parallel/``: ``LocalExchange`` so far)."""
