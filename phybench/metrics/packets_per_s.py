"""Packets through the whole call (to bytes, ``crc_ok`` and
``fec_errors`` on the host) per second over the whole window."""

from ..traffic.generator import call_size


def read(ctx):
    w = ctx.window
    return call_size(ctx.config, ctx.traffic)[1] * w.calls / w.seconds
