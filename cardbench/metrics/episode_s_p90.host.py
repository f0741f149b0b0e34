"""``episode_s_p90`` where the host paces the episodes: the 90th
percentile of the window's episode walls, read in the traced run (its
window runs untraced; the traced segment follows it)."""

from cardbench.harness import p90


def read(ctx):
    if ctx.trace is None:
        return None
    return p90(ctx.window.walls)
