"""The 90th percentile of the window's episode walls (host clock, each
ending in a synchronisation): the wall of one whole simulation."""

from cardbench.harness import p90


def read(ctx):
    return p90(ctx.window.walls)
