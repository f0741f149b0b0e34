"""Simulated jobs a second: the jobs placed by every episode completed in
the window, over the wall from the window's start to the last episode's
end (host clock). Lanes count every lane's jobs."""


def read(ctx):
    w = ctx.window
    return sum(w.placed) / (w.end - w.start)
