"""Tree helpers and host-side trace readers."""
