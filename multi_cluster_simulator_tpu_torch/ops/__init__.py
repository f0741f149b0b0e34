"""Queue, running-set and placement ops, batched over the cluster axis."""
