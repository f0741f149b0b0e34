"""The FFD kernel's share of its roofline (``fused_prefix_ffd``, the lane
form included), bytes and operations by ``cost/ffd.py``."""

from cardbench.metrics._roofline import share


def read(ctx):
    return share(ctx, "fused_prefix_ffd", "ffd")
