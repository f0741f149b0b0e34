"""Host microseconds a tick: a traced episode's wall less its
``mcs.dispatch.chunk`` ranges, over its ticks, mean over the traced
episodes."""


def read(ctx):
    eps = ctx.trace.episodes if ctx.trace is not None else []
    if not eps:
        return None
    n = ctx.world.n_ticks
    return 1e6 * sum((e["wall_s"] - e["chunk_s"]) / n for e in eps) / len(eps)
