"""Host ms per call of the harness's readout span: the copies of the
frames' fields and symbols to the host and ``modem.decode`` there, timed
after the device has finished the receiver (traced runs synchronise
first)."""


def read(ctx):
    if "readout" not in ctx.trace.spans:
        return None
    return ctx.trace.spans["readout"] / ctx.trace.calls * 1e3
