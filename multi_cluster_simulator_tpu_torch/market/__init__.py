"""The trader resource market (greedy, sinkhorn, cvx matching)."""
