"""IQ samples a plane received per second over the whole window, in
millions: channels x block samples x calls / window seconds."""

from ..traffic.generator import call_size


def read(ctx):
    w = ctx.window
    return call_size(ctx.config, ctx.traffic)[0] * w.calls / w.seconds / 1e6
