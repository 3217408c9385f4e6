"""Device ms per call of the demodulator's front in the bulk call
(``lora_phy_tpu_torch/ops/planar.py`` ``_demod_stage_planar``): the
device events linked to the program's ranges ``planar.scale`` (the
[-1, 1] scale scan), ``planar.estimate`` (the two-symbol estimate) and
``planar.windows`` (the rounded timing offset and the shifted-window
gather of both planes). The run's trace line logs each range apart."""

from .range_reads import device_ms

RANGES = ("planar.scale", "planar.estimate", "planar.windows")


def read(ctx):
    return device_ms(ctx.trace, RANGES)
