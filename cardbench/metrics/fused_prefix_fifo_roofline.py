"""The FIFO kernel's share of its roofline (``fused_prefix_fifo``), bytes
by ``cost/fifo.py``."""

from cardbench.metrics._roofline import share


def read(ctx):
    return share(ctx, "fused_prefix_fifo", "fifo")
