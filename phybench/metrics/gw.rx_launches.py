"""Device events per call of the receiver (kernels, copies and sets
launched by ``receive_block_planar``), a count from the trace: every
device event of the window but those of the harness's readout."""


def read(ctx):
    t = ctx.trace
    if t.events == 0:
        return None
    return (t.events - t.ranges.get("readout", (0.0, 0.0, 0))[2]) / t.calls
