"""Host-side workload synthesis (numpy)."""
