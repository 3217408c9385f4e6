"""Device ms per call of the block receiver's per-lane stages at SF12:
the device events linked to the seven ranges of
``lora_phy_tpu_torch/models/sync.py`` ``_receive_block_circular``
(``gather`` ... ``sro``), summed. The four-step DFTs of the probes, the
estimator, the demod and the clock-drift estimate count in their
stages."""

from .range_reads import device_ms

RANGES = ("gather", "probes", "sections", "dechirp", "estimator", "demod", "sro")


def read(ctx):
    return device_ms(ctx.trace, RANGES)
