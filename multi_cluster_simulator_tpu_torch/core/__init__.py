"""World state, cluster specs and the tick engine."""
