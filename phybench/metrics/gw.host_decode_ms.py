"""Host ms per call of the found frames' decode on the host in the
gateway readout: the host time of the program's ``modem.decode`` range
(``lora_phy_tpu_torch/models/modem.py`` ``decode``), which runs inside
the harness's ``readout`` span."""

from .range_reads import host_ms

RANGES = ("modem.decode",)


def read(ctx):
    return host_ms(ctx.trace, RANGES[0])
