"""The device's idle share over the traced window of the gateway cells:
one minus the union of the device events' intervals over the window's
host wall time (the profiler's own cost included, so an upper bound)."""

from .profile_arith import idle_share


def read(ctx):
    return idle_share(ctx.trace)
