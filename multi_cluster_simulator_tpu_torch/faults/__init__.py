"""The fault plane's state leaves (the fault phase itself is ROADMAP A8)."""
