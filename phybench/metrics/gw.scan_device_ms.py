"""Device ms per call of the block receiver's scan: the device events
linked to the ``front`` range of ``lora_phy_tpu_torch/models/sync.py``
(the two-sided dechirp scan and the candidate selection)."""

# the program's record_function ranges this reader reads
RANGES = ("front",)


def read(ctx):
    device_s, _, events = ctx.trace.ranges.get("front", (0.0, 0.0, 0))
    if events == 0:
        return None
    return device_s / ctx.trace.calls * 1e3
