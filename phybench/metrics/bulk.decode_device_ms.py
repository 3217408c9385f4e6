"""Device ms per call of the bulk call's coded decode: the device events
linked to the program's ``coded.decode`` range (the body of
``lora_phy_tpu_torch/models/coded.py`` ``decode_payload``)."""

from .range_reads import device_ms

RANGES = ("coded.decode",)


def read(ctx):
    return device_ms(ctx.trace, RANGES)
