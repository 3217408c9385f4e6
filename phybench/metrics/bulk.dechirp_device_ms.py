"""Device ms per call of the bulk call's dechirp: the device events
linked to the program's ``planar.dechirp`` range (the body of
``lora_phy_tpu_torch/ops/planar.py`` ``dechirp_planar``)."""

from .range_reads import device_ms

RANGES = ("planar.dechirp",)


def read(ctx):
    return device_ms(ctx.trace, RANGES)
