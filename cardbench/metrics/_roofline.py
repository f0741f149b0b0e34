"""The shared arithmetic of the ``<kernel>_roofline`` readers."""


def share(ctx, kernel: str, cost: str):
    """Percent of the kernel's device time (the first traced episode's
    launches, one a tick, by name in the profiler's trace) that the least
    time of the same ticks would take: the larger of their bytes at the
    memory bandwidth and their operations at the peak rate
    (``peaks.json``), as ``cost/<cost>.py`` counts them, over every
    ``COST_STRIDE``-th tick. None when the trace holds no such launches."""
    if ctx.trace is None:
        return None
    durs = ctx.trace.kernel(kernel)
    n = ctx.world.n_ticks
    if not durs or len(durs) % n:
        return None
    costs = ctx.costs(cost)
    spent = sum(durs[g] for g, _ in costs)
    if spent <= 0:
        return None
    return 100.0 * sum(least for _, least in costs) / spent
