"""Device ms per call of the demodulator's per-symbol stage in the bulk
call: the device events linked to the program's ``planar.decide`` range
in ``lora_phy_tpu_torch/ops/planar.py`` ``demodulate_planar``, whatever
implements the stage (in this cell the hand kernel
``csrc/fused_demod.cu``)."""

from .range_reads import device_ms

RANGES = ("planar.decide",)


def read(ctx):
    return device_ms(ctx.trace, RANGES)
