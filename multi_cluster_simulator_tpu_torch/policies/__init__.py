"""Scheduling passes: the FIFO kernel and its dispatch."""
