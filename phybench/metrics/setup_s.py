"""Seconds from the process's start to the first timed call: imports, the
CUDA context, the program's entry, the pool made on the device and one
warm-up call a pool item."""


def read(ctx):
    return ctx.window.setup_s
