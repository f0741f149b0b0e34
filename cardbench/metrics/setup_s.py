"""Process start to the window's start (host clock): imports, the kernels'
build and load, the world's generation and packing, the reset state and
the warm episode."""


def read(ctx):
    return ctx.setup_s
