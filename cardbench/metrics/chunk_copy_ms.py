"""Milliseconds an episode spends in the program's ``mcs.dispatch.chunk``
ranges (``obs/profile.py annotate_dispatch``, round each chunk's
host-to-device copies of its rows and counts), mean over the traced
episodes. A copy from pageable memory waits for the card to finish the
work queued before it, so the range holds that wait too."""


def read(ctx):
    eps = ctx.trace.episodes if ctx.trace is not None else []
    if not eps:
        return None
    return 1e3 * sum(e["chunk_s"] for e in eps) / len(eps)
