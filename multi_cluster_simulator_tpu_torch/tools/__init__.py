"""tools/ — command-line drivers of the port (``python -m
multi_cluster_simulator_tpu_torch.tools.<name>``)."""
